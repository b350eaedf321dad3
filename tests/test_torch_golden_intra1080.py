"""`tests/data/torch_golden.json` holds, under "intra1080_cavlc_batched",
the JAX reference encoder's stream for `bench.py:86-99`'s all-intra frame
(1920x1088, CAVLC, deblock on, QP 28, every other field at its default)
over six `synth_frame` frames through its batched entry (`TPU264_BATCH`
4: a chunk of 4 frames, then one of 2 that it pads to 4), which gives the
per-frame stream by design.  `chip_smoke.py` holds the port's batched
entry (chunks of 4 and 2) and its per-frame path on the card to it.  The
test recomputes it from the reference on the CPU."""

import pytest

from torch_util import check_golden_reference

NAME = "intra1080_cavlc_batched"


# The reference's batched program at 1080p is compiled by no other test
# (minutes on the CPU); it checks the data file, not the port.  Run it with
# -m slow.
@pytest.mark.slow
def test_golden_matches_reference_batched_entry(monkeypatch):
    monkeypatch.setenv("TPU264_BATCH", "4")
    cfg = check_golden_reference(NAME)
    assert (cfg.width, cfg.height, cfg.qp) == (1920, 1088, 28)
    assert (cfg.symbol_mode, cfg.intra_period, cfg.deblock) == \
        ("CAVLC", 1, True)

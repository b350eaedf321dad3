"""`tests/data/torch_golden.json` holds, under "bgop_1080p_cabac_rc", the
JAX reference encoder's stream for config 4 as `bench.py` builds it
(1920x1088, hierarchical B with `num_b_frames=2`, CABAC, deblock, JVT-G012
rate control at 8 Mb/s, QP 28 to start), 7 frames (I, Bref, B, P, Bref,
B, P in display order), with every frame's QP; `chip_smoke.py` holds the
port's stream on the card to it.  This test recomputes it from the
reference on the CPU."""

import pytest

from torch_util import check_golden_reference as check_reference

NAME = "bgop_1080p_cabac_rc"


# The reference re-encode at 1080p compiles programs used by no other test
# and takes minutes on the CPU; it checks the data file, not the port.  Run
# it with -m slow.
@pytest.mark.slow
def test_golden_matches_reference_encoder():
    cfg = check_reference(NAME)
    assert (cfg.width, cfg.height, cfg.num_b_frames) == (1920, 1088, 2)
    assert cfg.rate_control and cfg.bitrate == 8_000_000
    assert cfg.symbol_mode == "CABAC" and cfg.deblock

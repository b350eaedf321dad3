"""`tests/data/torch_golden.json` holds, under "ippp_720p", the JAX
reference encoder's stream for IPPP CAVLC at 1280x720 (1 IDR + 2 P,
deblock on, QP 28, no partitions, 4x4 transform); `chip_smoke.py` holds
the port's stream on the card to it.  This test recomputes it from the
reference on the CPU."""

from torch_util import check_golden_reference as check_reference

NAME = "ippp_720p"


def test_golden_matches_reference_encoder():
    cfg = check_reference(NAME)
    assert (cfg.width, cfg.height, cfg.intra_period) == (1280, 720, 0)

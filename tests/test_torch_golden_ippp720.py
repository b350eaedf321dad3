"""`tests/data/torch_golden.json` holds, under "ippp_720p", the JAX
reference encoder's stream for IPPP CAVLC at 1280x720 (1 IDR + 2 P,
deblock on, QP 28, no partitions, 4x4 transform), and under
"ippp_720p_tools" the same with the reference's default P tools
(16x8/8x16 and P_8x8 partitions, the 8x8 transform), and under
"ippp_720p_cabac" that with CABAC; `chip_smoke.py` holds the port's
streams on the card to them.  These tests recompute them
from the reference on the CPU."""

import pytest

from torch_util import check_golden_reference as check_reference

NAME = "ippp_720p"


# The reference re-encode compiles programs used by no other test (minutes
# on the CPU); it checks the data file, not the port.  Run it with -m slow.
@pytest.mark.slow
def test_golden_matches_reference_encoder():
    cfg = check_reference(NAME)
    assert (cfg.width, cfg.height, cfg.intra_period) == (1280, 720, 0)


@pytest.mark.slow
def test_tools_golden_matches_reference_encoder():
    cfg = check_reference("ippp_720p_tools")
    assert (cfg.width, cfg.height, cfg.intra_period) == (1280, 720, 0)
    assert cfg.inter_partitions is None and cfg.transform_8x8 is None


@pytest.mark.slow
def test_cabac_golden_matches_reference_encoder():
    cfg = check_reference("ippp_720p_cabac")
    assert (cfg.width, cfg.height, cfg.intra_period) == (1280, 720, 0)
    assert cfg.symbol_mode == "CABAC" and cfg.transform_8x8 is None

"""`tests/data/torch_golden.json` holds, under "tiled_bgop_1080p_cabac_rc"
and "tiled4_bgop_1080p_cabac_rc", the JAX reference's `TiledEncoder`
streams of config 4 as `bench.py` builds it (1920x1088, hierarchical B
with `num_b_frames=2`, CABAC, deblock, JVT-G012 rate control at 8 Mb/s,
QP 28 to start), 7 frames, over `make_mesh(1, gop=1)` (`bench.py`'s mesh:
one band, which still writes `disable_deblocking_filter_idc` 2, so the
stream is not "bgop_1080p_cabac_rc") and over `make_mesh(4, gop=1)` (four
bands of 17 MB rows), with every frame's size and QP; `chip_smoke.py`
holds the port's `TiledEncoder` on the card to them.  These tests
recompute them from the reference on the CPU."""

import pytest

from torch_util import check_golden_tiled_reference as check_reference


# The reference's tiled re-encodes at 1080p compile programs used by no
# other test and take minutes on the CPU; they check the data file, not
# the port.  Run them with -m slow.
@pytest.mark.slow
@pytest.mark.parametrize("name,bands", [("tiled_bgop_1080p_cabac_rc", 1),
                                        ("tiled4_bgop_1080p_cabac_rc", 4)])
def test_golden_matches_reference_tiled_encoder(name, bands):
    cfg, n_bands = check_reference(name)
    assert n_bands == bands
    assert (cfg.width, cfg.height, cfg.num_b_frames) == (1920, 1088, 2)
    assert cfg.rate_control and cfg.bitrate == 8_000_000
    assert cfg.symbol_mode == "CABAC" and cfg.deblock

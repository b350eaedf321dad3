"""The band-tiled encoder's own pieces on the CPU, no reference encode: the
reference halo a band's motion search reads, the mesh, and the
refusals, and that it ignores weighted prediction and SEI as the
reference's does.  The streams are held to the reference in
`test_torch_ippp_slices.py` (IPPP, two lanes, the CLI) and
`test_torch_bgop_slices.py` (B GOPs, CABAC with rate control, the record
cap overflow)."""

import numpy as np
import pytest
import torch

from tpu264_torch.cli.encode import main as cli_main
from tpu264_torch.coding.inter_frame import PAD
from tpu264_torch.config import EncoderConfig
from tpu264_torch.kernels.interp import pad_plane
from tpu264_torch.runtime.tiled import (TiledEncoder, band_halo, band_refs,
                                        make_mesh)

from torch_util import assert_equal


@pytest.mark.parametrize("band_hm,n_bands", [(2, 2), (3, 3), (2, 4)])
def test_band_halo_is_the_padded_frame(band_hm, n_bands):
    """Each band's PAD-extended reference is the rows of the whole frame,
    edge-padded by the port's `pad_plane`, that the band covers plus PAD
    (luma) or PAD // 2 (chroma) rows on each side: real rows of the
    neighbour bands inside the frame, the frame's edge rows replicated at
    its top and bottom.  A band of 2 MB rows takes its whole halo from
    one neighbour."""
    rng = np.random.default_rng(band_hm * 10 + n_bands)
    rows = 16 * band_hm
    full = [torch.as_tensor(rng.integers(0, 256, (n_bands * r, w),
                                         dtype=np.uint8))
            for r, w in ((rows, 48), (rows // 2, 24), (rows // 2, 24))]
    bands = [tuple(p[t * r:(t + 1) * r] for p, r in
                   zip(full, (rows, rows // 2, rows // 2)))
             for t in range(n_bands)]
    for t in range(n_bands):
        got = band_refs(bands, t, torch.device("cpu"))
        for c, (plane, pad) in enumerate(zip(full, (PAD, PAD // 2,
                                                    PAD // 2))):
            r = rows >> (c > 0)
            want = pad_plane(plane, pad)[t * r:(t + 1) * r + 2 * pad]
            assert_equal(got[c], want, f"band {t} plane {c}")
        assert_equal(band_halo([b[0] for b in bands], t, PAD, "cpu"),
                     got[0])


def test_make_mesh_grid():
    mesh = make_mesh(6, gop=2, devices=["cpu"] * 6)
    assert mesh.shape == {"gop": 2, "tile": 3}
    assert mesh.axis_names == ("gop", "tile")
    assert all(d == torch.device("cpu") for row in mesh.devices for d in row)
    # the reference's default: two lanes where the count is even
    assert make_mesh(devices=["cpu"] * 4).shape == {"gop": 2, "tile": 2}
    assert make_mesh(3, devices=["cpu"] * 3).shape == {"gop": 1, "tile": 3}
    with pytest.raises(ValueError):
        make_mesh(4, devices=["cpu"] * 3)


@pytest.mark.parametrize("height,n_bands,what", [
    (144, 2, "whole MB rows"),          # 9 MB rows in 2 bands
    (48, 3, ">= 2 MB rows"),            # bands of 1 MB row
])
def test_refusals(height, n_bands, what):
    cfg = EncoderConfig(width=48, height=height, intra_period=0)
    with pytest.raises(ValueError, match=what):
        TiledEncoder(cfg, make_mesh(n_bands, gop=1,
                                    devices=["cpu"] * n_bands))


def test_cuda_without_a_card_raises(tmp_path):
    """Without a card, a mesh of the visible cards, a mesh that names
    `cuda`, and the CLI without `--device cpu` (tiled or not) raise."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        make_mesh(1, gop=1)
    with pytest.raises(RuntimeError, match="cuda"):
        TiledEncoder(EncoderConfig(width=48, height=48),
                     make_mesh(1, gop=1, devices=["cuda"]))
    argv = ["--synthetic", "-p", "SourceWidth=48", "-p", "SourceHeight=48",
            "-p", f"OutputFile={tmp_path / 'out.264'}"]
    for extra in ([], ["--tiles", "1"]):
        with pytest.raises(RuntimeError, match="cuda"):
            cli_main(argv + extra)
    assert not (tmp_path / "out.264").exists()


def test_weighted_pred_and_sei_are_ignored():
    """As the reference's tiled path (which reads neither option), the
    tiled encoder writes the same bytes with weighted prediction and SEI
    messages asked for as without them: IPPP CAVLC at QCIF, 3 bands."""
    from tpu264_torch.media.synth import synth_frame
    frames = [synth_frame(176, 144, t) for t in range(3)]
    streams = []
    for on in (False, True):
        cfg = EncoderConfig(width=176, height=144, qp=28, intra_period=0,
                            weighted_pred=on, sei_messages=on)
        te = TiledEncoder(cfg, make_mesh(3, gop=1, devices=["cpu"] * 3))
        streams.append(te.encode_sequence([frames])[0])
    assert streams[0] == streams[1]

"""The batched all-intra entry's stages on the CPU against the per-frame
ones: a chunk of F pictures through the plain wave loop
(`make_intra_encoder` on planes [F, H, W]), the serializer and packer
(`coding.encoder.serialize` with `frames`), the deblocker
(`recon_planes` with `frames`) and the SSE equals the F pictures coded one
at a time, picture for picture: recons, every per-wave output, the packed
words and bit counts, the filtered planes and the SSEs.  Tolerance 0.

The per-frame stages are held to the JAX reference elsewhere
(`test_torch_intra.py`, `test_torch_cavlc*.py`, `test_torch_deblock.py`),
so this file runs no reference program; the streams of the batched entry
against the reference's are in `test_torch_cavlc_stream.py` and
`test_torch_cavlc_slices.py`.
"""

import numpy as np
import pytest
import torch

from tpu264_torch.coding import encoder as tenc
from tpu264_torch.coding import intra_frame as tif
from tpu264_torch.coding.wavefront import build_schedule
from tpu264_torch.kernels import deblock as kd
from tpu264_torch.kernels import deblock_wave as k4w
from tpu264_torch.kernels import i16_chroma_wave as k3w
from tpu264_torch.kernels import i4x4_wave as k2w
from tpu264_torch.media.synth import synth_frame
from tpu264_torch.tools.synth_inputs import random_wave_chunk

from torch_util import assert_equal, t32

QP = 28
SIZES = {"qcif": (176, 144), "cif": (352, 288)}
_ONE: dict = {}         # (size, slices, t) -> a picture coded on its own


def _planes(w, h, ts):
    """synth frames t in `ts` as int32 planes [F, ...] (y, u, v)."""
    frames = [synth_frame(w, h, t) for t in ts]
    return tuple(torch.stack([t32(f[k]) for f in frames]) for k in range(3))


def _coded(size, slices, frames, deblock, chunk=True):
    """Pictures `frames` through the stages of the batched entry as a
    chunk (planes [F, H, W]), or one picture through those of the
    per-frame path (`chunk` False) -> (recon, ys, mbd, words, nbits,
    filtered planes, sse)."""
    w, h = SIZES[size]
    sched = build_schedule(w // 16, h // 16, slices)
    pic = tenc.Picture(w // 16, h // 16, tuple(sched.slice_starts.tolist()),
                       False, torch.device("cpu"))
    filt = (kd.make_deblocker_skewed(sched, filter_across_slices=slices == 1)
            if deblock else None)
    orig = _planes(w, h, frames)
    if not chunk:
        orig = tuple(p[0] for p in orig)
    dev_out, ys = tif.make_intra_encoder(sched)(*orig, QP)
    mbd = tif.reorder_wave_outputs(sched, ys, frames=chunk)
    nf = len(frames) if chunk else None
    cap = pic.n_mbs // slices * tenc.WORDS_PER_MB
    words, nbits, _ = tenc.serialize(pic, mbd, "i", cap, frames=nf)
    recon = tenc.recon_planes(filt, pic, dev_out, mbd, QP, frames=nf)
    return dev_out, ys, mbd, words, nbits, recon, tenc.sse3(orig, recon)


def _one(size, slices, t, deblock):
    key = (size, slices, t, deblock)
    if key not in _ONE:
        _ONE[key] = _coded(size, slices, [t], deblock, chunk=False)
    return _ONE[key]


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("slices", [1, 3])
@pytest.mark.parametrize("deblock", [True, False])
@pytest.mark.parametrize("frames", [1, 2, 3, 4])
def test_chunk_equals_pictures_one_at_a_time(frames, deblock, slices, size):
    """F pictures coded as one chunk equal each picture coded alone, in
    every stage; the CPU launches no kernel."""
    before = {**k2w.launches, **k3w.launches, **k4w.launches}
    got = _coded(size, slices, range(3, 3 + frames), deblock)
    assert {**k2w.launches, **k3w.launches, **k4w.launches} == before
    dev_out, ys, mbd, words, nbits, recon, sse = got
    w, h = SIZES[size]
    assert sse.shape == (frames, 4) and nbits.shape == (frames, slices)
    for f in range(frames):
        o_out, o_ys, o_mbd, o_words, o_nbits, o_recon, o_sse = _one(
            size, slices, 3 + f, deblock)
        for k in o_out:
            assert dev_out[k].shape[1:] == o_out[k].shape
            assert_equal(dev_out[k][f], o_out[k], f"{k}, picture {f}")
        assert set(ys) == set(o_ys) and set(mbd) == set(o_mbd)
        for k in o_ys:
            assert_equal(ys[k][f], o_ys[k], f"ys {k}, picture {f}")
            assert_equal(mbd[k][f], o_mbd[k], f"mbd {k}, picture {f}")
        assert_equal(nbits[f], o_nbits, f"bit counts, picture {f}")
        assert_equal(words[f], o_words, f"words, picture {f}")
        for c, p, o in zip("yuv", recon, o_recon):
            assert p.dtype == torch.uint8 and p.shape[1:] == o.shape
            assert_equal(p[f], o, f"recon {c}, picture {f}")
        assert_equal(sse[f], o_sse, f"sse, picture {f}")
    assert recon[0].shape == (frames, h, w)


def test_batched_wave_plain_equals_stacked():
    """`wave_body_plain` (the plain version that K2 + K3 are held to) on a
    seeded wave of F = 1, 3 and 4 pictures equals the per-picture calls
    stacked: every result and every border buffer;
    `i16_chroma_wave_plain` likewise on the batched I4x4 results."""
    for frames in (1, 3, 4):
        _check_wave_chunk(frames)


def _check_wave_chunk(frames):
    bd, coords, avail, gy, gu, gv = random_wave_chunk(5 + frames, 22, 18,
                                                      frames, n_pad=3)
    coords, avail = t32(coords), torch.as_tensor(avail)
    lam4, lam24, _ = tif.LAMBDA_TABLE[QP]
    bd_b = {k: t32(v) for k, v in bd.items()}
    got = tif.wave_body_plain(QP, QP, lam4, lam24, bd_b, coords, avail,
                              t32(gy), t32(gu), t32(gv))
    assert set(got) == set(k3w.OUTPUTS)
    for f in range(frames):
        bd_f = {k: t32(v[f]) for k, v in bd.items()}
        want = tif.wave_body_plain(QP, QP, lam4, lam24, bd_f, coords, avail,
                                   t32(gy[f]), t32(gu[f]), t32(gv[f]))
        for k in want:
            assert_equal(got[k][f], want[k], f"{k}, picture {f}")
        for k in bd_f:
            assert_equal(bd_b[k][f], bd_f[k], f"border {k}, picture {f}")
    # K3's plain version alone, on the batched I4x4 results
    bd_b = {k: t32(v) for k, v in bd.items()}
    f_idx, r, c, av = tif._frame_lanes(coords, avail, frames)
    ltop, lleft, _, _, _, _, mtop, mleft = tif.gather_border_ctx(
        bd_b, r, c, f_idx)
    i4 = tif.eval_i4x4_plain(t32(gy).flatten(0, 1), ltop, lleft, mtop, mleft,
                             *av.unbind(1), QP, lam4, lam24)
    mb4, modebuf, _, coeffs4, j4 = (t.unflatten(0, (frames, -1)) for t in i4)
    res = tif.i16_chroma_wave_plain(bd_b, coords, avail, t32(gy), t32(gu),
                                    t32(gv), mb4, modebuf, coeffs4, j4, QP,
                                    QP)
    for k in res:
        assert_equal(res[k], got[k], k)


def test_batched_deblocker_equals_stacked():
    """The plain deblocker on F = 3 seeded pictures with mixed intra and
    inter MBs (bS 0 to 4) equals the pictures filtered one at a time, 1
    and 3 slices, filtering across slices and not; so do the bS maps."""
    from tpu264_torch.ref.transform import chroma_qp
    from tpu264_torch.tools.synth_inputs import random_deblock_picture
    wm, hm = 11, 9
    pics = [random_deblock_picture(40 + f, wm, hm) for f in range(3)]
    stacked = [torch.as_tensor(np.stack(a)) for a in zip(*pics)]
    for slices, across in ((1, True), (3, True), (3, False)):
        sched = build_schedule(wm, hm, slices)
        fn = kd.make_deblocker_skewed(sched, across)
        got = fn(*stacked, 28, chroma_qp(28))
        bs = kd.bs_maps(*stacked[3:7])
        for f, arrs in enumerate(pics):
            one = [torch.as_tensor(a) for a in arrs]
            want = fn(*one, 28, chroma_qp(28))
            for g, wnt in zip(got, want):
                assert_equal(g[f], wnt, f"picture {f}, {slices} slices")
            for g, wnt in zip(bs, kd.bs_maps(*one[3:7])):
                assert_equal(g[f], wnt, f"bS, picture {f}")

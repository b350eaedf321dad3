"""The port's wavefront intra encoder (`make_intra_encoder`) against the
JAX reference: every per-MB output and the recon planes, exact; and one
wave of `wave_body` (on the CPU: the plain version the two wave kernels
are held to) against the reference's wave body composed from its parts."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu264.coding import intra_frame as rif
from tpu264.coding.wavefront import build_schedule as ref_schedule
from tpu264.media.synth import synth_frame

from tpu264_torch.coding import intra_frame as tif
from tpu264_torch.coding.wavefront import build_schedule
from tpu264_torch.kernels import i16_chroma_wave as k3w
from tpu264_torch.kernels import i4x4_wave as k2w
from tpu264_torch.ref.transform import chroma_qp
from tpu264_torch.tools.synth_inputs import random_wave

from torch_util import assert_equal, random_i4x4_lanes, t32, to_np

W, H = 176, 144
_REF = {}


@pytest.fixture(scope="module")
def ref_encoder():
    """One jitted reference encoder per slice layout (QP is traced)."""
    def get(slices):
        if slices not in _REF:
            sched = ref_schedule(W // 16, H // 16, slices)
            _REF[slices] = (sched, rif.make_intra_encoder(sched))
        return _REF[slices]
    return get


def _frame(seed):
    return synth_frame(W, H, t=seed, seed=7 + seed)


def _both(ref_encoder, planes, qp, slices):
    sched, enc = ref_encoder(slices)
    r_out, r_ys = enc(*(jnp.asarray(p) for p in planes), np.int32(qp))
    r_mb = rif.reorder_wave_outputs(sched, r_ys)
    tsched = build_schedule(W // 16, H // 16, slices)
    t_out, t_ys = tif.make_intra_encoder(tsched)(
        *(torch.as_tensor(p) for p in planes), qp)
    t_mb = tif.reorder_wave_outputs(tsched, t_ys)
    return r_out, r_mb, t_out, t_mb


@pytest.mark.parametrize("slices", [1, 3])
@pytest.mark.parametrize("qp", [12, 28, 40])
def test_intra_encoder_matches_reference(ref_encoder, qp, slices):
    r_out, r_mb, t_out, t_mb = _both(ref_encoder, _frame(qp), qp, slices)
    assert set(t_mb) == set(r_mb)
    for k in r_mb:
        assert_equal(t_mb[k], r_mb[k], k)
    for k in ("recon_y", "recon_u", "recon_v"):
        assert_equal(t_out[k], r_out[k], k)
    # both mode families are exercised
    sel = to_np(t_mb["sel16"]).astype(bool)
    assert sel.any() or qp < 20
    assert (~sel).any()


def test_flat_frame_ties(ref_encoder):
    """A flat picture makes every I16x16 and chroma mode cost the same:
    the first minimum must win on both sides."""
    y = np.full((H, W), 128, np.uint8)
    u = np.full((H // 2, W // 2), 128, np.uint8)
    r_out, r_mb, t_out, t_mb = _both(ref_encoder, (y, u, u.copy()), 28, 1)
    for k in r_mb:
        assert_equal(t_mb[k], r_mb[k], k)


def test_wave_outputs_stacked_like_reference(ref_encoder):
    planes = _frame(5)
    sched, enc = ref_encoder(1)
    _, r_ys = enc(*(jnp.asarray(p) for p in planes), np.int32(30))
    _, t_ys = tif.make_intra_encoder(build_schedule(W // 16, H // 16, 1))(
        *(torch.as_tensor(p) for p in planes), 30)
    valid = sched.valid
    for k, v in r_ys.items():
        assert tuple(t_ys[k].shape) == tuple(v.shape), k
        assert_equal(to_np(t_ys[k])[valid], np.asarray(v)[valid], k)


@pytest.mark.parametrize("qp", [0, 17, 36, 51])
def test_eval_i16_and_chroma_random_lanes(qp):
    """eval_i16 / eval_chroma on random lanes with random availability."""
    rng = np.random.default_rng(qp)
    b = 12
    orig = rng.integers(0, 256, size=(b, 16, 16))
    ltop = rng.integers(0, 256, size=(b, 25))
    lleft = rng.integers(0, 256, size=(b, 16))
    av = rng.integers(0, 2, size=(3, b)).astype(bool)
    want = rif.eval_i16(jnp.asarray(orig, jnp.int32),
                        jnp.asarray(ltop, jnp.int32),
                        jnp.asarray(lleft, jnp.int32),
                        *(jnp.asarray(a) for a in av), qp)
    got = tif.eval_i16(t32(orig), t32(ltop), t32(lleft),
                       *(torch.as_tensor(a) for a in av), qp)
    for g, w in zip(got, want):
        assert_equal(g, w)
    ou = rng.integers(0, 256, size=(b, 8, 8))
    ov = rng.integers(0, 256, size=(b, 8, 8))
    tu = rng.integers(0, 256, size=(b, 9))
    lu = rng.integers(0, 256, size=(b, 8))
    tv = rng.integers(0, 256, size=(b, 9))
    lv = rng.integers(0, 256, size=(b, 8))
    cqp = min(qp, 39)
    wm, wouts = rif.eval_chroma(*(jnp.asarray(a, jnp.int32)
                                  for a in (ou, ov, tu, lu, tv, lv)),
                                *(jnp.asarray(a) for a in av), cqp)
    gm, gouts = tif.eval_chroma(*(t32(a) for a in (ou, ov, tu, lu, tv, lv)),
                                *(torch.as_tensor(a) for a in av), cqp)
    assert_equal(gm, wm)
    for go, wo in zip(gouts, wouts):
        for g, w in zip(go, wo):
            assert_equal(g, w)


@pytest.mark.parametrize("qp", [0, 17, 36, 51])
def test_eval_i4x4_random_lanes(qp):
    """eval_i4x4 (on the CPU: the plain version the wave kernel is held
    to) against the reference on lanes over all availability combinations,
    -1/-2 neighbour modes and flat content: all five outputs equal."""
    ints, flags = random_i4x4_lanes(qp)[:5], random_i4x4_lanes(qp)[5:]
    lam4, lam24, _ = tif.LAMBDA_TABLE[qp]
    want = rif.eval_i4x4(*(jnp.asarray(a, jnp.int32) for a in ints),
                         *(jnp.asarray(a) for a in flags), qp, lam4, lam24)
    got = tif.eval_i4x4(*(t32(a) for a in ints),
                        *(torch.as_tensor(a) for a in flags), qp, lam4, lam24)
    assert len(got) == len(want) == 5
    for name, g, w in zip(("recon", "mode grid", "modes", "levels", "cost"),
                          got, want):
        assert_equal(g, w, name)
    modes = to_np(got[2])
    assert len(np.unique(modes)) >= 5          # the search is exercised


def _ref_wave_body(qp, cqp, lam4, lam24, bd, coords, avail, gy, gu, gv):
    """The reference's `wave_body` closure, composed from its module-level
    parts -> (border buffers after the wave, the wave's results)."""
    from tpu264.kernels import transform as rkt
    r, c = coords[:, 0], coords[:, 1]
    at, al, atl, atr = (avail[:, i] for i in range(4))
    (ltop, lleft, tctx_u, lctx_u, tctx_v, lctx_v,
     modes_top, modes_left) = rif.gather_border_ctx(bd, r, c)
    mb4, modebuf, modes_zz, coeffs4, j4 = rif.eval_i4x4(
        gy, ltop, lleft, modes_top, modes_left, at, al, atl, atr,
        qp, lam4, lam24)
    m16, j16, rec16, dc_lev, ac_lev = rif.eval_i16(
        gy, ltop, lleft, at, al, atl, qp)
    sel16 = j16 < j4
    recon_mb = jnp.where(sel16[:, None, None], rec16, mb4)
    ac16_zz = rkt.zigzag_scan(ac_lev[:, rif.ZZ_ROWS, rif.ZZ_COLS])
    luma_ac = jnp.where(sel16[:, None, None], ac16_zz, coeffs4)
    luma_dc = jnp.where(sel16[:, None], rkt.zigzag_scan(dc_lev), 0)
    cmode, ((rec_u, dc_u, ac_u), (rec_v, dc_v, ac_v)) = rif.eval_chroma(
        gu, gv, tctx_u, lctx_u, tctx_v, lctx_v, at, al, atl, cqp)
    mode_tiles = jnp.where(sel16[:, None, None], -1, modebuf)
    bd = rif.update_border_ctx(bd, r, c, recon_mb, rec_u, rec_v, mode_tiles)
    return bd, dict(sel16=sel16, i16mode=m16, modes=modes_zz, cmode=cmode,
                    luma_ac=luma_ac, luma_dc=luma_dc,
                    chroma_dc=jnp.stack([dc_u, dc_v], axis=1),
                    chroma_ac=jnp.stack([ac_u, ac_v], axis=1),
                    recon_mb=recon_mb, rec_u=rec_u, rec_v=rec_v)


@pytest.mark.parametrize("qp", [0, 24, 36, 51])
def test_wave_body_matches_reference(qp):
    """One wave of seeded lanes with padding lanes: every result and the
    border buffers after the scatter."""
    wm, hm = 11, 9
    bd, coords, avail, gy, gu, gv = random_wave(qp, wm, hm)
    cqp = chroma_qp(qp)
    lam4, lam24, _ = tif.LAMBDA_TABLE[qp]
    j32 = lambda a: jnp.asarray(a, jnp.int32)
    want_bd, want = _ref_wave_body(
        qp, cqp, lam4, lam24, {k: j32(v) for k, v in bd.items()},
        j32(coords), jnp.asarray(avail), j32(gy), j32(gu), j32(gv))
    got_bd = {k: t32(v) for k, v in bd.items()}
    got = tif.wave_body(qp, cqp, lam4, lam24, got_bd, t32(coords),
                        torch.as_tensor(avail), t32(gy), t32(gu), t32(gv))
    assert list(got) == list(want) == list(k3w.OUTPUTS)
    for k, (shape, dtype) in k3w.OUTPUTS.items():
        assert got[k].dtype == dtype and got[k].shape[1:] == shape, k
        assert_equal(got[k], want[k], k)
    assert set(got_bd) == set(want_bd) == set(k3w.BORDERS)
    for k in want_bd:
        assert_equal(got_bd[k], want_bd[k], k)
        assert (to_np(got_bd[k]) != bd[k]).any(), k     # the scatter ran
    sel = to_np(got["sel16"])
    # both luma families occur (at QP 51 the I4x4 mode bits cost too much)
    assert sel.any() and ((~sel).any() or qp == 51)


def test_wave_body_plain_parts_compose():
    """`i16_chroma_wave_plain` (the plain version of K3) on the I4x4
    results is the rest of `wave_body_plain`."""
    qp, (wm, hm) = 30, (11, 9)
    bd, coords, avail, gy, gu, gv = random_wave(5, wm, hm)
    lam4, lam24, _ = tif.LAMBDA_TABLE[qp]
    args = (t32(coords), torch.as_tensor(avail), t32(gy), t32(gu), t32(gv))
    bd_a = {k: t32(v) for k, v in bd.items()}
    want = tif.wave_body_plain(qp, qp, lam4, lam24, bd_a, *args)
    bd_b = {k: t32(v) for k, v in bd.items()}
    r, c = args[0][:, 0].long(), args[0][:, 1].long()
    ltop, lleft, _, _, _, _, mtop, mleft = tif.gather_border_ctx(bd_b, r, c)
    mb4, modebuf, modes, coeffs4, j4 = tif.eval_i4x4(
        args[2], ltop, lleft, mtop, mleft, *args[1].unbind(1), qp, lam4,
        lam24)
    got = tif.i16_chroma_wave_plain(bd_b, *args, mb4, modebuf, coeffs4, j4,
                                    qp, qp)
    assert "modes" not in got
    assert_equal(modes, want["modes"])
    for k in got:
        assert_equal(got[k], want[k], k)
    for k in bd_a:
        assert_equal(bd_a[k], bd_b[k], k)


@pytest.mark.parametrize("qp,cqp", [(0, 0), (28, 28), (51, 39)])
def test_i16_chroma_wave_params(qp, cqp):
    """The K3 wrapper's by-value tables against the reference's: two
    quantiser sets, the scan and the block order."""
    from tpu264.coding.wavefront import BLK_ORDER as REF_BLK_ORDER
    from tpu264.kernels import transform as rkt
    vals = list(k3w.pack_params(qp, cqp, tuple(tif.BLK_ORDER)))
    assert len(vals) == 2 * 55 + 32
    for base, q, lim_dc in ((0, qp, rkt.LIMIT_DC), (55, cqp, rkt.LIMIT_CDC)):
        for i, table in enumerate((rkt.MF_TABLE[q % 6], rkt.LIMIT_AC[q],
                                   rkt.V_TABLE[q % 6])):
            assert vals[base + 16 * i:base + 16 * i + 16] == \
                np.asarray(table).reshape(16).tolist()
        qbits = 15 + q // 6
        assert vals[base + 48:base + 55] == [
            (1 << qbits) // 3, qbits, q // 6, int(rkt.MF00[q % 6]),
            int(rkt.V00[q % 6]), int(lim_dc[q]), q]
    assert vals[110:126] == np.asarray(rkt.ZIGZAG_4x4).tolist()
    assert [divmod(v, 4) for v in vals[126:]] == list(REF_BLK_ORDER)


@pytest.mark.parametrize("wm,hm", [(11, 9), (80, 45)])
def test_border_layout_matches_kernel_table(wm, hm):
    """The wave kernels compute the border buffers' row lengths from the
    picture width: the wrappers' table agrees with what the loop makes."""
    bd = tif.init_border_buffers(hm, wm, "cpu")
    assert list(bd) == list(k3w.BORDERS)
    for name, (extra, a, b) in k3w.BORDERS.items():
        assert tuple(bd[name].shape) == (hm + extra, a * wm + b), name


def test_alloc_outputs_shapes():
    out = k3w.alloc_outputs((3, 7), "cpu")
    assert list(out) == list(k3w.OUTPUTS)
    assert out["chroma_ac"].shape == (3, 7, 2, 4, 16)
    assert out["sel16"].dtype == torch.bool and out["sel16"].shape == (3, 7)


def test_wave_kernels_refuse_cpu_tensors():
    bd, coords, avail, gy, gu, gv = random_wave(1, 5, 3)
    bd = {k: t32(v) for k, v in bd.items()}
    with pytest.raises(ValueError, match="CUDA"):
        k2w.i4x4_wave_bd(t32(gy), bd, t32(coords), torch.as_tensor(avail),
                         28, 23, 140, tif._K2_RULES)
    b = len(coords)
    with pytest.raises(ValueError, match="CUDA"):
        k3w.i16_chroma_wave(
            bd, t32(coords), torch.as_tensor(avail), t32(gy), t32(gu),
            t32(gv), t32(gy), t32(np.zeros((b, 4, 4))), t32(gy),
            t32(np.zeros(b)), 28, 28, tuple(tif.BLK_ORDER),
            k3w.alloc_outputs((b,), "cpu"))

"""One P wave of the port's wave body (on the CPU: `wave_body_plain`, the
gather, `eval_i4x4_plain` and `p_wave_plain`, which the P wave kernel KP is
held to on the card) against the reference's P wave body composed eagerly
from its module-level parts, on seeded waves: every result, the border
buffers and both motion-vector maps after the wave, tolerance 0.  No
reference encoder is built (nothing here compiles `make_inter_encoder`).

The waves (`random_p_wave`) cover all 16 availability combinations, padding
lanes at row hm, neighbours that agree on the search vector (skip vector
equal to it) and ones that do not, and search vectors whose blocks start
before the padded plane's first row or past its last, at QP 0, 28 and 51
with a chroma QP offset of 0 and of -2.  With the reference's default P
tools (16x8/8x16, P_8x8, the 8x8 transform) the waves of
`random_p_wave_tools` add the partitions' vectors and source tiles that
one of each partition type predicts, so that every partition type and
both transforms are chosen."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu264.coding import intra_frame as rif
from tpu264.coding import inter_frame as rinter
from tpu264.coding import mvpred as rmv
from tpu264.kernels import interp as rki
from tpu264.kernels import transform as rkt
from tpu264.kernels import transform8 as rk8

from tpu264_torch.coding import inter_frame as tinter
from tpu264_torch.coding import intra_frame as tif
from tpu264_torch.kernels import i16_chroma_wave as k3w
from tpu264_torch.kernels import i4x4_wave as k2w
from tpu264_torch.kernels import interp as tki
from tpu264_torch.kernels import p_wave as kp
from tpu264_torch.ref.transform import chroma_qp
from tpu264_torch.tools.synth_inputs import random_p_wave, random_p_wave_tools

from torch_util import assert_equal, t32, to_np

WM, HM = 40, 20             # the fullest wave has 20 lanes, + 2 padding
PAD = tinter.PAD
CSRC = Path(tinter.__file__).resolve().parents[1] / "csrc"


@jax.jit
def _t8_better(ssd8, rb8, ssd4, rb4, qp):
    """The reference's transform choice, compiled as its encoder compiles
    it (XLA fuses each product and sum into one multiply-add)."""
    lam_ssd = 0.85 * jnp.exp2((qp.astype(jnp.float32) - 12.0) / 3)
    return ssd8 + lam_ssd * rb8 < ssd4 + lam_ssd * rb4


def _ref_p_wave_body(planes, cu_pad, cv_pad, qp, cqp, lam4, lam24, lam_me,
                     bd, mv_map, ref_map, coords, avail, mv_me, gy, gu, gv,
                     mv_parts=None, tools=kp.NO_TOOLS, wy=None, oy=None):
    """The reference's `wave_body` closure (`tpu264/coding/inter_frame.py`;
    `tools` as its `partitions`, `p8x8`, `t8`; with (wy, oy) as it is built
    with `weighted`, without them as it is built without), composed from
    its module-level parts -> (border buffers, mv map, ref map after the
    wave, the results)."""

    def wl(pred):
        if wy is None:
            return pred
        return jnp.clip(((pred * wy + 32) >> 6) + oy, 0, 255)

    r, c = coords[:, 0], coords[:, 1]
    at, al, atl, atr = (avail[:, i] for i in range(4))
    b = r.shape[0]
    (ltop, lleft, tctx_u, lctx_u, tctx_v, lctx_v,
     modes_top, modes_left) = rif.gather_border_ctx(bd, r, c)

    def nbr(ch, dr, dc):
        def one(rr, cc):
            mv = jax.lax.dynamic_slice(mv_map, (ch, rr, cc, 0),
                                       (1, 1, 1, 2))[0, 0, 0]
            ref = jax.lax.dynamic_slice(ref_map, (ch, rr, cc),
                                        (1, 1, 1))[0, 0, 0]
            return mv, ref
        return jax.vmap(one)(r + dr, c + dc)

    mv_a, ref_a = nbr(rinter.CH_TR, 1, 0)
    mv_b, ref_b = nbr(rinter.CH_BL, 0, 1)
    mv_c, ref_c = nbr(rinter.CH_BL, 0, 2)
    mv_d, ref_d = nbr(rinter.CH_BR, 0, 0)
    ref_a = jnp.where(al, ref_a, rmv.UNAVAIL)
    ref_b = jnp.where(at, ref_b, rmv.UNAVAIL)
    ref_c = jnp.where(atr, ref_c, rmv.UNAVAIL)
    ref_d = jnp.where(atl, ref_d, rmv.UNAVAIL)
    mv_a = jnp.where((ref_a >= 0)[:, None], mv_a, 0)
    mv_b = jnp.where((ref_b >= 0)[:, None], mv_b, 0)
    mv_c = jnp.where((ref_c >= 0)[:, None], mv_c, 0)
    mv_d = jnp.where((ref_d >= 0)[:, None], mv_d, 0)
    use_d = ref_c == rmv.UNAVAIL
    mv_c = jnp.where(use_d[:, None], mv_d, mv_c)
    ref_c = jnp.where(use_d, ref_d, ref_c)
    mv_pred = rmv.predict_mv_jnp(mv_a, ref_a, mv_b, ref_b, mv_c, ref_c)
    mv_skip = rmv.skip_mv_jnp(mv_pred, mv_a, ref_a, mv_b, ref_b)

    y0, x0 = r * 16 + PAD, c * 16 + PAD

    def inter_cost(mv):
        pred = wl(rki.mc_luma(planes, y0, x0, mv))
        blk = (gy - pred).reshape(b, 4, 4, 4, 4).transpose(0, 1, 3, 2, 4)
        satd = rkt.satd4x4(blk).sum(axis=(1, 2))
        return pred, satd + lam_me * rinter.mvd_bits(mv - mv_pred)

    def satd_full(pred):
        blk = (gy - pred).reshape(b, 4, 4, 4, 4).transpose(0, 1, 3, 2, 4)
        return rkt.satd4x4(blk).sum(axis=(1, 2))

    pred_me, j_me = inter_cost(mv_me)
    pred_skip, j_skip_raw = inter_cost(mv_skip)
    j_skip = j_skip_raw - lam4
    use_skip_mv = j_skip < j_me
    mv_sel = jnp.where(use_skip_mv[:, None], mv_skip, mv_me)
    pred_inter = jnp.where(use_skip_mv[:, None, None], pred_skip, pred_me)
    j_inter = jnp.minimum(j_skip, j_me)
    ptype = jnp.zeros(b, jnp.int32)
    mv2_sel = mv_sel
    mvd_bits = rinter.mvd_bits
    if tools.partitions:
        mvT, mvB, mvL, mvR = (mv_parts[:, i] for i in range(4))
        p16x8 = wl(jnp.concatenate(
            [rki.mc_luma(planes, y0, x0, mvT, bh=8, bw=16),
             rki.mc_luma(planes, y0 + 8, x0, mvB, bh=8, bw=16)], axis=1))
        p8x16 = wl(jnp.concatenate(
            [rki.mc_luma(planes, y0, x0, mvL, bh=16, bw=8),
             rki.mc_luma(planes, y0, x0 + 8, mvR, bh=16, bw=8)], axis=2))
        j_16x8 = satd_full(p16x8) + lam_me * (
            mvd_bits(mvT - mv_pred) + mvd_bits(mvB - mvT) + 3)
        j_8x16 = satd_full(p8x16) + lam_me * (
            mvd_bits(mvL - mv_pred) + mvd_bits(mvR - mvL) + 3)
        use_16x8 = (j_16x8 < j_inter) & (j_16x8 <= j_8x16)
        use_8x16 = (j_8x16 < j_inter) & (j_8x16 < j_16x8)
        ptype = jnp.where(use_16x8, 1, jnp.where(use_8x16, 2, 0))
        pred_inter = jnp.where(
            use_16x8[:, None, None], p16x8,
            jnp.where(use_8x16[:, None, None], p8x16, pred_inter))
        j_inter = jnp.minimum(j_inter, jnp.minimum(j_16x8, j_8x16))
        mv_sel = jnp.where(use_16x8[:, None], mvT,
                           jnp.where(use_8x16[:, None], mvL, mv_sel))
        mv2_sel = jnp.where(use_16x8[:, None], mvB,
                            jnp.where(use_8x16[:, None], mvR, mv2_sel))
    if tools.p8x8:
        mvQ = [mv_parts[:, 4 + i] for i in range(4)]
        p8 = jnp.concatenate([jnp.concatenate(
            [wl(rki.mc_luma(planes, y0 + 8 * qy, x0 + 8 * qx,
                            mvQ[2 * qy + qx], bh=8, bw=8))
             for qx in (0, 1)], axis=2)
            for qy in (0, 1)], axis=1)
        j_p8 = satd_full(p8) + lam_me * (
            mvd_bits(mvQ[0] - mv_pred) + mvd_bits(mvQ[1] - mvQ[0])
            + mvd_bits(mvQ[2] - mvQ[0]) + mvd_bits(mvQ[3] - mvQ[1]) + 9)
        use_p8 = j_p8 < j_inter
        ptype = jnp.where(use_p8, 3, ptype)
        pred_inter = jnp.where(use_p8[:, None, None], p8, pred_inter)
        j_inter = jnp.minimum(j_inter, j_p8)
        mv_sel = jnp.where(use_p8[:, None], mvQ[0], mv_sel)
        mv2_sel = jnp.where(use_p8[:, None], mvQ[1], mv2_sel)

    mb4, modebuf, modes_zz, coeffs4, j4 = rif.eval_i4x4(
        gy, ltop, lleft, modes_top, modes_left, at, al, atl, atr,
        qp, lam4, lam24)
    m16, j16, rec16, dc_lev, ac_lev = rif.eval_i16(
        gy, ltop, lleft, at, al, atl, qp)
    sel16 = j16 < j4
    is_inter = j_inter < jnp.minimum(j16, j4) + lam24
    is_i16 = (~is_inter) & sel16

    blk = (gy - pred_inter).reshape(b, 4, 4, 4, 4).transpose(0, 1, 3, 2, 4)
    lev_inter = rkt.fdct_quant4x4(blk, qp, intra=False)
    rec_inter = rkt.clip1(pred_inter + rkt.block_recon(lev_inter, qp)
                          .transpose(0, 1, 3, 2, 4).reshape(b, 16, 16))
    inter_zz = rkt.zigzag_scan(lev_inter[:, rif.ZZ_ROWS, rif.ZZ_COLS])
    t8_sel = jnp.zeros(b, dtype=bool)
    if tools.t8:
        resid = gy - pred_inter
        blk8 = resid.reshape(b, 2, 8, 2, 8).transpose(0, 1, 3, 2, 4)
        lev8 = rk8.quant8x8(rk8.fdct8x8(blk8), qp, intra=False)
        rec8 = rkt.clip1(pred_inter + rk8.idct8x8(rk8.dequant8x8(lev8, qp))
                         .transpose(0, 1, 3, 2, 4).reshape(b, 16, 16))

        def rbits(lev):
            a = jnp.abs(lev).astype(jnp.float32)
            bits = jnp.where(
                a > 0, 2.0 * jnp.ceil(jnp.log2(a + 1.0)) + 1.0, 0.0)
            return bits.reshape(b, -1).sum(axis=1)

        def ssd(rec):
            return ((gy - rec) ** 2).reshape(b, -1).sum(axis=1).astype(
                jnp.float32)

        j8_better = _t8_better(ssd(rec8), rbits(lev8), ssd(rec_inter),
                               rbits(lev_inter), jnp.int32(qp))
        t8_sel = (is_inter & (ptype == 0) & j8_better
                  & (lev8 != 0).any(axis=(1, 2, 3, 4)))
        scan64 = rk8.zigzag_scan8(lev8).reshape(b, 4, 64)
        pseudo = scan64.reshape(b, 4, 16, 4).transpose(0, 1, 3, 2)
        inter_zz = jnp.where(t8_sel[:, None, None],
                             pseudo.reshape(b, 16, 16), inter_zz)
        rec_inter = jnp.where(t8_sel[:, None, None], rec8, rec_inter)
    recon_mb = jnp.where(is_inter[:, None, None], rec_inter,
                         jnp.where(sel16[:, None, None], rec16, mb4))
    ac16_zz = rkt.zigzag_scan(ac_lev[:, rif.ZZ_ROWS, rif.ZZ_COLS])
    luma_ac = jnp.where(is_inter[:, None, None], inter_zz,
                        jnp.where(sel16[:, None, None], ac16_zz, coeffs4))
    luma_dc = jnp.where(is_i16[:, None], rkt.zigzag_scan(dc_lev), 0)

    cmode, intra_outs = rif.eval_chroma(
        gu, gv, tctx_u, lctx_u, tctx_v, lctx_v, at, al, atl, cqp)
    cy0, cx0 = r * 8 + PAD // 2, c * 8 + PAD // 2

    def cpred(cp):
        pred = rki.mc_chroma(cp, cy0, cx0, mv_sel)
        if tools.partitions:
            c16x8 = jnp.concatenate(
                [rki.mc_chroma(cp, cy0, cx0, mvT, bh=4, bw=8),
                 rki.mc_chroma(cp, cy0 + 4, cx0, mvB, bh=4, bw=8)], axis=1)
            c8x16 = jnp.concatenate(
                [rki.mc_chroma(cp, cy0, cx0, mvL, bh=8, bw=4),
                 rki.mc_chroma(cp, cy0, cx0 + 4, mvR, bh=8, bw=4)], axis=2)
            pred = jnp.where(use_16x8[:, None, None], c16x8,
                             jnp.where(use_8x16[:, None, None], c8x16, pred))
        if tools.p8x8:
            cq = jnp.concatenate([jnp.concatenate(
                [rki.mc_chroma(cp, cy0 + 4 * qy, cx0 + 4 * qx,
                               mvQ[2 * qy + qx], bh=4, bw=4)
                 for qx in (0, 1)], axis=2) for qy in (0, 1)], axis=1)
            pred = jnp.where((ptype == 3)[:, None, None], cq, pred)
        return pred

    inter_outs = [rif.chroma_residual_recon(g, cpred(cp), cqp, intra=False)
                  for g, cp in ((gu, cu_pad), (gv, cv_pad))]
    chroma = [tuple(jnp.where(is_inter.reshape((b,) + (1,) * (p.ndim - 1)),
                              p, i) for i, p in zip(io, po))
              for io, po in zip(intra_outs, inter_outs)]

    mode_tiles = jnp.where((is_inter | sel16)[:, None, None], -1, modebuf)
    bd = rif.update_border_ctx(bd, r, c, recon_mb, chroma[0][0],
                               chroma[1][0], mode_tiles)
    mv_tr = jnp.where((ptype == 2)[:, None], mv2_sel, mv_sel)
    mv_bl = jnp.where((ptype == 1)[:, None], mv2_sel, mv_sel)
    mv_br = jnp.where((ptype > 0)[:, None], mv2_sel, mv_sel)
    if tools.p8x8:
        on8 = (ptype == 3)[:, None]
        mv_tr = jnp.where(on8, mvQ[1], mv_tr)
        mv_bl = jnp.where(on8, mvQ[2], mv_bl)
        mv_br = jnp.where(on8, mvQ[3], mv_br)
    for ch, mvv in ((rinter.CH_TR, mv_tr), (rinter.CH_BL, mv_bl),
                    (rinter.CH_BR, mv_br)):
        mv_map = mv_map.at[ch, r + 1, c + 1].set(
            jnp.where(is_inter[:, None], mvv, 0), mode="drop")
        ref_map = ref_map.at[ch, r + 1, c + 1].set(
            jnp.where(is_inter, 0, rmv.INTRA), mode="drop")
    ys = dict(is_inter=is_inter, mv=mv_sel, mv_pred=mv_pred,
              mv_skip=mv_skip, sel16=is_i16, i16mode=m16, modes=modes_zz,
              cmode=cmode, luma_ac=luma_ac, luma_dc=luma_dc,
              chroma_dc=jnp.stack([chroma[0][1], chroma[1][1]], axis=1),
              chroma_ac=jnp.stack([chroma[0][2], chroma[1][2]], axis=1),
              recon_mb=recon_mb, rec_u=chroma[0][0], rec_v=chroma[1][0])
    if tools.partitions:
        ys["ptype"] = jnp.where(is_inter, ptype, 0)
        ys["mv2"] = mv2_sel
    if tools.p8x8:
        ys["mvq"] = jnp.stack(mvQ, axis=1)
    if tools.t8:
        ys["t8"] = t8_sel
    return bd, mv_map, ref_map, ys


def _wave(seed):
    """A seeded P wave as the port's CPU inputs: (planes, cu_pad, cv_pad,
    bd, mv_map, ref_map, coords, avail, mv_me, gy, gu, gv)."""
    (bd, mv_map, ref_map, ry, ru, rv, coords, avail, mv_me, gy, gu,
     gv) = random_p_wave(seed, WM, HM)
    planes = tki.luma_planes(tki.pad_plane(t32(ry), PAD))
    cu, cv = (tki.pad_plane(t32(p), PAD // 2) for p in (ru, rv))
    return (planes, cu, cv, {k: t32(v) for k, v in bd.items()}, t32(mv_map),
            t32(ref_map), t32(coords), torch.as_tensor(avail), t32(mv_me),
            t32(gy), t32(gu), t32(gv))


@pytest.mark.parametrize("offset", [0, -2])
@pytest.mark.parametrize("qp", [0, 28, 51])
def test_p_wave_body_matches_reference(qp, offset):
    cqp = chroma_qp(qp, offset)
    lam4, lam24, lam_me = tif.LAMBDA_TABLE[qp]
    (planes, cu, cv, bd, mv_map, ref_map, coords, avail, mv_me, gy, gu,
     gv) = _wave(100 + qp + offset)
    j32 = lambda t: jnp.asarray(to_np(t), jnp.int32)
    want_bd, want_mv, want_ref, want = _ref_p_wave_body(
        j32(planes), j32(cu), j32(cv), qp, cqp, lam4, lam24, lam_me,
        {k: j32(v) for k, v in bd.items()},
        j32(mv_map[:, :HM + 1]), j32(ref_map[:, :HM + 1]), j32(coords),
        jnp.asarray(to_np(avail)), j32(mv_me), j32(gy), j32(gu), j32(gv))
    bd0 = {k: v.clone() for k, v in bd.items()}
    got = tinter.wave_body(planes, cu, cv, qp, cqp, lam4, lam24, lam_me, bd,
                           mv_map, ref_map, coords, avail, mv_me, gy, gu, gv)
    assert list(got) == list(want) == list(kp.OUTPUTS)
    for k, (shape, dtype) in kp.OUTPUTS.items():
        assert got[k].dtype == dtype and got[k].shape[1:] == shape, k
        assert_equal(got[k], want[k], k)
    for k in want_bd:
        assert_equal(bd[k], want_bd[k], k)
        assert not torch.equal(bd[k], bd0[k]), k       # the scatter ran
    # the reference's maps have no trash row hm + 1 (it drops those writes)
    assert_equal(mv_map[:, :HM + 1], want_mv, "mv_map")
    assert_equal(ref_map[:, :HM + 1], want_ref, "ref_map")
    # what the wave exercised
    n = int((coords[:, 0] < HM).sum())
    combos = {tuple(a) for a in avail[:n].tolist()}
    assert len(combos) == 16
    inter = to_np(got["is_inter"])[:n].astype(bool)
    same = (to_np(got["mv"]) == to_np(got["mv_skip"])).all(1)[:n]
    me_is_skip = (to_np(mv_me) == to_np(got["mv_skip"])).all(1)[:n]
    assert inter.any() and (~inter).any()
    assert (inter & same & me_is_skip).any() and (inter & ~same).any()


def _wave_tools(seed):
    """A seeded P wave with the partitions' vectors (CPU inputs and
    mv_parts)."""
    *arrs, mvp = random_p_wave_tools(seed, WM, HM)
    (bd, mv_map, ref_map, ry, ru, rv, coords, avail, mv_me, gy, gu,
     gv) = arrs
    planes = tki.luma_planes(tki.pad_plane(t32(ry), PAD))
    cu, cv = (tki.pad_plane(t32(p), PAD // 2) for p in (ru, rv))
    return (planes, cu, cv, {k: t32(v) for k, v in bd.items()}, t32(mv_map),
            t32(ref_map), t32(coords), torch.as_tensor(avail), t32(mv_me),
            t32(gy), t32(gu), t32(gv), t32(mvp))


@pytest.mark.parametrize("qp,tools", [
    (0, kp.Tools(True, True, True)), (28, kp.Tools(True, True, True)),
    (51, kp.Tools(True, True, True)), (28, kp.Tools(True, False, False)),
    (28, kp.Tools(False, False, True))])
def test_p_wave_tools_match_reference(qp, tools):
    """With the default P tools (and with partitions alone, and the 8x8
    transform alone): every result, the borders and both maps; at QP 0
    and 28 every partition type and both transforms are chosen."""
    cqp = chroma_qp(qp)
    lam4, lam24, lam_me = tif.LAMBDA_TABLE[qp]
    (planes, cu, cv, bd, mv_map, ref_map, coords, avail, mv_me, gy, gu, gv,
     mvp) = _wave_tools(300 + qp)
    j32 = lambda t: jnp.asarray(to_np(t), jnp.int32)
    want_bd, want_mv, want_ref, want = _ref_p_wave_body(
        j32(planes), j32(cu), j32(cv), qp, cqp, lam4, lam24, lam_me,
        {k: j32(v) for k, v in bd.items()},
        j32(mv_map[:, :HM + 1]), j32(ref_map[:, :HM + 1]), j32(coords),
        jnp.asarray(to_np(avail)), j32(mv_me), j32(gy), j32(gu), j32(gv),
        j32(mvp), tools)
    got = tinter.wave_body(planes, cu, cv, qp, cqp, lam4, lam24, lam_me, bd,
                           mv_map, ref_map, coords, avail, mv_me, gy, gu, gv,
                           mvp if tools.partitions else None, tools)
    assert list(got) == list(kp.outputs(tools))
    assert sorted(got) == sorted(want)
    for k, (shape, dtype) in kp.outputs(tools).items():
        assert got[k].dtype == dtype and got[k].shape[1:] == shape, k
        assert_equal(got[k], want[k], k)
    for k in want_bd:
        assert_equal(bd[k], want_bd[k], k)
    assert_equal(mv_map[:, :HM + 1], want_mv, "mv_map")
    assert_equal(ref_map[:, :HM + 1], want_ref, "ref_map")
    n = int((coords[:, 0] < HM).sum())
    inter = to_np(got["is_inter"])[:n].astype(bool)
    assert inter.any() and (~inter).any()
    if qp < 51 and tools.p8x8:
        assert set(to_np(got["ptype"])[:n][inter]) == {0, 1, 2, 3}
    if qp < 51 and tools.t8:
        t8 = to_np(got["t8"])[:n].astype(bool)
        assert t8.any() and (inter & ~t8).any()


def test_p_wave_plain_composes_the_wave_body():
    """`p_wave_plain` (the plain version of KP) on the I4x4 results is the
    rest of `wave_body_plain`, and the CPU path launches no kernel."""
    qp, cqp = 30, 28
    lam4, lam24, lam_me = tif.LAMBDA_TABLE[qp]
    consts = (qp, cqp, lam4, lam24, lam_me)
    planes, cu, cv, bd, mv_map, ref_map, *xs = _wave(11)
    coords, avail, mv_me, gy, gu, gv = xs
    maps_a = (mv_map.clone(), ref_map.clone())
    bd_a = {k: v.clone() for k, v in bd.items()}
    before = (dict(k2w.launches), dict(k3w.launches), dict(kp.launches))
    want = tinter.wave_body_plain(planes, cu, cv, *consts, bd_a, *maps_a,
                                  *xs)
    assert before == (k2w.launches, k3w.launches, kp.launches)
    r, c = coords[:, 0].long(), coords[:, 1].long()
    ltop, lleft, _, _, _, _, mtop, mleft = tif.gather_border_ctx(bd, r, c)
    mb4, modebuf, modes, coeffs4, j4 = tif.eval_i4x4_plain(
        gy, ltop, lleft, mtop, mleft, *avail.unbind(1), qp, lam4, lam24)
    got = tinter.p_wave_plain(bd, mv_map, ref_map, planes, cu, cv, coords,
                              avail, mv_me, gy, gu, gv, mb4, modebuf,
                              coeffs4, j4, *consts)
    assert "modes" not in got
    assert_equal(modes, want["modes"])
    for k in got:
        assert_equal(got[k], want[k], k)
    for k in bd:
        assert_equal(bd[k], bd_a[k], k)
    assert_equal(mv_map, maps_a[0])
    assert_equal(ref_map, maps_a[1])


def tif_lam(qp):
    """The reference's float32 lambda of the transform choice."""
    return np.float32(jax.jit(lambda q: 0.85 * jnp.exp2(
        (q.astype(jnp.float32) - 12.0) / 3))(jnp.int32(qp)))


@pytest.mark.parametrize("qp,cqp", [(0, 0), (28, 26), (51, 39)])
def test_p_wave_params(qp, cqp):
    """The KP wrapper's by-value tables: K3's wave-form table, the inter
    rounding offsets of both sets, the lambdas, the reference's
    quarter-pel table, the tools and the 8x8 transform's tables."""
    from tpu264.ref.interp import QPEL_TABLE as REF_QPEL
    lam4, lam24, lam_me = tif.LAMBDA_TABLE[qp]
    vals = list(kp.pack_params(qp, cqp, lam4, lam24, lam_me,
                               tuple(tif.BLK_ORDER)))
    k3 = list(k3w.pack_params(qp, cqp, tuple(tif.BLK_ORDER)))
    assert vals[:len(k3)] == k3
    rest = vals[len(k3):]
    for i, q in enumerate((qp, cqp)):
        assert rest[i] == (1 << (15 + q // 6)) // 6
    assert rest[2:5] == [lam4, lam24, lam_me]
    qpel = np.asarray(rest[5:117]).reshape(16, 7)
    for (fx, fy), (p1, dx1, dy1, p2, dx2, dy2, avg) in REF_QPEL.items():
        assert qpel[fy * 4 + fx].tolist() == [p1, dy1, dx1, p2, dy2, dx2,
                                              avg]
    # no tools; the 8x8 transform's tables of this qp and its lambda
    from tpu264.ref import transform8 as r8
    t8 = rest[117:]
    assert t8[0] == 0
    assert t8[1:65] == r8.MF8_TABLE[qp % 6].reshape(-1).tolist()
    assert t8[65:129] == r8.V8_TABLE[qp % 6].reshape(-1).tolist()
    assert t8[129:193] == r8.ZIGZAG_8x8.tolist()
    qbits8 = 16 + qp // 6
    assert t8[193:196] == [(1 << qbits8) // 6, qbits8, qp // 6]
    lam = np.array([t8[196]], np.int32).view(np.float32)[0]
    assert lam == tif_lam(qp)
    assert t8[197:] == [64, 0]           # no weighting
    tools = kp.pack_params(qp, cqp, lam4, lam24, lam_me,
                           tuple(tif.BLK_ORDER), kp.Tools(True, True, True))
    assert list(tools)[len(k3) + 117] == 7


def test_p_wave_layout_matches_kernel_source():
    """The wrapper's pointer list and table length against what
    `csrc/p_wave.cu` reads (the kernel cannot run here)."""
    src = (CSRC / "p_wave.cu").read_text()
    n_ptrs = int(re.search(r"constexpr int kPtrs = (\d+);", src).group(1))
    n_out = sum(1 for k in kp.OUTPUTS if k != "modes")
    n_tools = len(kp.TOOL_OUTPUTS)
    assert n_ptrs == len(k3w.BORDERS) + 16 + n_tools + n_out
    order = re.search(r"struct WaveIo \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"\*\s*(\w+)[,;]", order)
    assert names[-n_out:] == [k for k in kp.OUTPUTS if k != "modes"]
    assert names[-n_out - n_tools:-n_out] == list(kp.TOOL_OUTPUTS)
    assert "mv_parts" in names
    assert len(kp.pack_params(28, 28, 23, 140, 6, tuple(tif.BLK_ORDER))) \
        == kp.PARAMS_LEN == 2 * 55 + 32 + 5 + 16 * 7 + 1 + 3 * 64 + 4 + 2


def test_alloc_outputs_cover_the_reference_results():
    out = kp.alloc_outputs((3, 7), "cpu")
    assert list(out) == list(kp.OUTPUTS)
    assert out["mv"].shape == (3, 7, 2) and out["mv"].dtype == torch.int32
    assert out["is_inter"].dtype == torch.bool
    assert out["chroma_ac"].shape == (3, 7, 2, 4, 16)


def test_p_wave_refuses_cpu_tensors():
    qp = 28
    lam4, lam24, lam_me = tif.LAMBDA_TABLE[qp]
    planes, cu, cv, bd, mv_map, ref_map, *xs = _wave(2)
    b = xs[0].shape[0]
    with pytest.raises(ValueError, match="CUDA"):
        kp.p_wave(bd, mv_map, ref_map, planes, cu, cv, *xs, xs[3],
                  t32(np.zeros((b, 4, 4))), xs[3], t32(np.zeros(b)), qp, qp,
                  lam4, lam24, lam_me, tuple(tif.BLK_ORDER),
                  kp.alloc_outputs((b,), "cpu"))

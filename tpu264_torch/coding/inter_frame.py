"""Wavefront P-frame encoder (torch): IPPP with full-search ME +
quarter-pel refinement, counterpart of `tpu264.coding.inter_frame`.

Motion estimation runs outside the serial MB order: every MB full-searches
and sub-pel-refines in parallel against the reference frame
(`motion_vectors`: on the card one launch of KF, `kernels/me_search.py`,
and one of KS, `kernels/me_subpel.py`; their plain versions are
`kernels/me.py`'s), and only the decision pass (mv prediction, skip
inference, inter-vs-intra choice, reconstruction) runs in the
anti-diagonal wavefront loop, batched per wave.  Candidates per MB: P_Skip
(skip-mv MC), P_L0_16x16 (ME mv), Intra_16x16 and Intra_4x4 (the
`intra_frame.eval_*` machinery).

The kernel on this path is one launch a P picture (`frame_body`): the P
wave kernel KP in its frame form (`kernels.p_wave.p_frame`: every wave of
the picture in order, a grid barrier between waves; in a wave the Intra4x4
search beside the vector prediction, the P_Skip and P_L0_16x16
candidates, the I16x16 and chroma searches, then the decision, every
transform of the chosen path, the merge, the border scatter and the map
writes).  The plain version, which the CPU takes, is `p_frame_plain`: a
loop over the waves of `wave_body_plain` (`gather_border_ctx`,
`eval_i4x4_plain`, then `p_wave_plain`).

With the reference's default IPPP tools (`partitions`, `p8x8`, `t8`) a
wave also weighs P_L0_16x8, P_L0_8x16 and P_8x8 (each partition with its
own full-search and sub-pel vector) and picks the transform of a 16x16
inter MB, in the same launch.

With explicit weighted prediction (`weighted`: a frame's luma weight and
offset, denominator 6) the motion search runs against the pre-weighted
reference and its own half-pel planes, while the wave weighs every luma
prediction after interpolation from the unweighted planes (`weight_luma`),
as a decoder forms it; chroma keeps the default weights.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu264_torch.kernels import dct_quant as dq
from tpu264_torch.kernels import interp as kint
from tpu264_torch.kernels import me as kme
from tpu264_torch.kernels import me_search as kfs
from tpu264_torch.kernels import me_subpel as ksp
from tpu264_torch.kernels import p_wave as kp
from tpu264_torch.kernels import transform as kt
from tpu264_torch.kernels import transform8 as kt8
from tpu264_torch.ref.transform import chroma_qp
from . import mvpred
from .intra_frame import (_BLK_ORDER, _K2_RULES, I32, LAMBDA_TABLE, ZZ_COLS,
                          ZZ_ROWS, assemble_plane, chroma_residual_recon,
                          eval_chroma, eval_i16, eval_i4x4_plain,
                          gather_border_ctx, init_border_buffers,
                          tile_origin_xs, update_border_ctx)
from .wavefront import WaveSchedule

PAD = 24  # ref padding: search range + subpel taps margin

# channel indices of the per-MB neighbor cell maps: the three 4x4 cells
# of an MB that later MVP derivations can read (spec 8.4.1.3 neighbors
# always hit one of these): top-right cell (A of the right MB), bottom-
# left (B/C of MBs below), bottom-right (D below; also A rows 2-3).
# Without partitions the three channels hold the same vector.
CH_TR, CH_BL, CH_BR = 0, 1, 2


def mvd_bits(mvd):
    """ue(se(v)) bit length per component, summed over (y, x)."""
    return kme.mv_cost(mvd)


def _to_blocks(mb):
    """[B, 16, 16] -> [B, 4(br), 4(bc), 4, 4] 4x4 blocks, contiguous."""
    b = mb.shape[0]
    return mb.reshape(b, 4, 4, 4, 4).permute(0, 1, 3, 2, 4).contiguous()


def _from_blocks(blk):
    b = blk.shape[0]
    return blk.permute(0, 1, 3, 2, 4).reshape(b, 16, 16)


def weight_luma(pred, wy: int, oy: int):
    """Explicit luma weighting (spec 8.4.2.3.2, denominator 6, int32):
    clip(((pred * wy + 32) >> 6) + oy, 0, 255); the default (64, 0)
    leaves samples of 0-255 as they are."""
    if (wy, oy) == (64, 0):
        return pred
    return torch.clamp(((pred * wy + 32) >> 6) + oy, 0, 255)


def _satd16(gy, pred):
    """SATD (DC included) of a 16x16 prediction's residual, per lane."""
    return kt.satd4x4(_to_blocks(gy - pred)).sum(dim=(1, 2), dtype=I32)


def p_wave_plain(bd, mv_map, ref_map, planes, cu_pad, cv_pad, coords, avail,
                 mv_me, gy, gu, gv, mb4, modebuf, coeffs4, j4, qp: int,
                 cqp: int, lam4: int, lam24: int, lam_me: int,
                 mv_parts=None, tools: kp.Tools = kp.NO_TOOLS, wy: int = 64,
                 oy: int = 0) -> dict:
    """The P wave body after the Intra4x4 search, in plain torch (what
    KP's inter group computes; `p_frame_plain` is KP's plain version): for
    B lanes at coords [B,2] (int32 (r, c);
    padding lanes at (hm, 0)) with avail [B,4] = (top, left, top-left,
    top-right), the neighbour vectors from the maps, the median and skip
    predictions, the inter candidates (MC from the half-pel `planes` of the
    reference, weighted by (wy, oy) after interpolation, SATD + lam_me *
    vector bits): P_Skip and P_L0_16x16, and with `tools` on the 16x8 /
    8x16 partitions and P_8x8 from the partitions' own vectors mv_parts
    [B, 8, 2] (`kernels.p_wave.PARTS`); the I16x16 and chroma searches,
    the decision against the I4x4 results
    (recon, mode grid, scanned levels, cost), the chosen residuals (for a
    16x16 inter MB with `tools.t8`, the 8x8 transform where it is cheaper
    by SSD + lambda x coefficient bits), the border scatter into `bd` and
    the map writes, in place.  Returns every result of
    `kernels.p_wave.outputs(tools)` but "modes"."""
    r, c = coords[:, 0].long(), coords[:, 1].long()
    b = gy.shape[0]
    at, al, atl, atr = avail.unbind(1)
    ltop, lleft, tctx_u, lctx_u, tctx_v, lctx_v, _, _ = gather_border_ctx(
        bd, r, c)

    # ---- neighbor MVs from the maps (padded: +1 row/col, +1 right, and a
    # trash row below for the padding lanes at r = hm, so every index
    # r + dr <= hm + 1, c + dc <= wm + 1 is in range) ----
    def nbr(ch, dr, dc):
        return mv_map[ch, r + dr, c + dc], ref_map[ch, r + dr, c + dc]

    mv_a, ref_a = nbr(CH_TR, 1, 0)            # left MB, rows 0-1
    mv_b, ref_b = nbr(CH_BL, 0, 1)            # top MB, bottom-left
    mv_c, ref_c = nbr(CH_BL, 0, 2)            # top-right MB
    mv_d, ref_d = nbr(CH_BR, 0, 0)            # top-left MB
    # slice-boundary masking (maps may hold other slices' data)
    ref_a = torch.where(al, ref_a, mvpred.UNAVAIL)
    ref_b = torch.where(at, ref_b, mvpred.UNAVAIL)
    ref_c = torch.where(atr, ref_c, mvpred.UNAVAIL)
    ref_d = torch.where(atl, ref_d, mvpred.UNAVAIL)
    mv_a = torch.where((ref_a >= 0)[:, None], mv_a, 0)
    mv_b = torch.where((ref_b >= 0)[:, None], mv_b, 0)
    mv_c = torch.where((ref_c >= 0)[:, None], mv_c, 0)
    mv_d = torch.where((ref_d >= 0)[:, None], mv_d, 0)
    # C -> D substitution when top-right unavailable
    use_d = ref_c == mvpred.UNAVAIL
    mv_c = torch.where(use_d[:, None], mv_d, mv_c)
    ref_c = torch.where(use_d, ref_d, ref_c)

    mv_pred = mvpred.predict_mv(mv_a, ref_a, mv_b, ref_b, mv_c, ref_c)
    mv_skip = mvpred.skip_mv(mv_pred, mv_a, ref_a, mv_b, ref_b)

    # ---- inter candidates: MC + SATD + rate ----
    y0 = r * 16 + PAD
    x0 = c * 16 + PAD

    def mc(dy, dx, mv, bh=16, bw=16):
        return weight_luma(kint.mc_luma(planes, y0 + dy, x0 + dx, mv, bh=bh,
                                        bw=bw), wy, oy)

    def inter_cost(mv):
        pred = mc(0, 0, mv)
        return pred, _satd16(gy, pred) + lam_me * mvd_bits(mv - mv_pred)

    pred_me, j_me = inter_cost(mv_me)
    pred_skip, j_skip_raw = inter_cost(mv_skip)
    # bias skip slightly (its true rate is ~0 when residual is empty)
    j_skip = j_skip_raw - lam4
    use_skip_mv = j_skip < j_me
    mv_sel = torch.where(use_skip_mv[:, None], mv_skip, mv_me)
    pred_inter = torch.where(use_skip_mv[:, None, None], pred_skip, pred_me)
    j_inter = torch.minimum(j_skip, j_me)

    ptype = torch.zeros(b, dtype=I32, device=gy.device)
    mv2_sel = mv_sel
    if tools.partitions:
        # ---- 16x8 / 8x16 candidates (per-half refined MVs) ----
        mv_t, mv_bt, mv_l, mv_r = mv_parts[:, :4].unbind(1)
        p16x8 = torch.cat([mc(0, 0, mv_t, bh=8), mc(8, 0, mv_bt, bh=8)],
                          dim=1)
        p8x16 = torch.cat([mc(0, 0, mv_l, bw=8), mc(0, 8, mv_r, bw=8)],
                          dim=2)
        # rate estimate: part0 vs the MB predictor, part1 vs part0 (the
        # exact per-partition predictors are recomputed by the serializer
        # from the final maps) + ue(mb_type)
        j_16x8 = _satd16(gy, p16x8) + lam_me * (
            mvd_bits(mv_t - mv_pred) + mvd_bits(mv_bt - mv_t) + 3)
        j_8x16 = _satd16(gy, p8x16) + lam_me * (
            mvd_bits(mv_l - mv_pred) + mvd_bits(mv_r - mv_l) + 3)
        use_16x8 = (j_16x8 < j_inter) & (j_16x8 <= j_8x16)
        use_8x16 = (j_8x16 < j_inter) & (j_8x16 < j_16x8)
        ptype = torch.where(use_16x8, 1, torch.where(use_8x16, 2, 0)).to(I32)
        pred_inter = torch.where(
            use_16x8[:, None, None], p16x8,
            torch.where(use_8x16[:, None, None], p8x16, pred_inter))
        j_inter = torch.minimum(j_inter, torch.minimum(j_16x8, j_8x16))
        mv_sel = torch.where(use_16x8[:, None], mv_t,
                             torch.where(use_8x16[:, None], mv_l, mv_sel))
        mv2_sel = torch.where(use_16x8[:, None], mv_bt,
                              torch.where(use_8x16[:, None], mv_r, mv2_sel))

    if tools.p8x8:
        # ---- P_8x8 candidate: one MV per 8x8 quadrant ----
        mv_q = mv_parts[:, 4:].unbind(1)
        p8 = torch.cat([torch.cat(
            [mc(8 * qy, 8 * qx, mv_q[2 * qy + qx], bh=8, bw=8)
             for qx in (0, 1)], dim=2) for qy in (0, 1)], dim=1)
        # rate estimate: q0 vs the MB predictor, later quadrants vs their
        # raster-order sibling (the exact spec-8.4.1.3 predictors are
        # recomputed by the serializer); + ue(mb_type=3) + 4x
        # ue(sub_mb_type=0) = 9 header bits
        j_p8 = _satd16(gy, p8) + lam_me * (
            mvd_bits(mv_q[0] - mv_pred) + mvd_bits(mv_q[1] - mv_q[0])
            + mvd_bits(mv_q[2] - mv_q[0]) + mvd_bits(mv_q[3] - mv_q[1])
            + 9)
        use_p8 = j_p8 < j_inter
        ptype = torch.where(use_p8, 3, ptype).to(I32)
        pred_inter = torch.where(use_p8[:, None, None], p8, pred_inter)
        j_inter = torch.minimum(j_inter, j_p8)
        mv_sel = torch.where(use_p8[:, None], mv_q[0], mv_sel)
        mv2_sel = torch.where(use_p8[:, None], mv_q[1], mv2_sel)

    # ---- intra candidates (shared machinery) ----
    m16, j16, rec16, dc_lev, ac_lev = eval_i16(
        gy, ltop, lleft, at, al, atl, qp)
    j_intra = torch.minimum(j16, j4)
    sel16 = j16 < j4

    # inter-vs-intra: intra pays the larger mb_type cost in P slices
    is_inter = j_inter < j_intra + lam24
    is_i16 = (~is_inter) & sel16

    # ---- luma residual for the inter path ----
    lev_inter = dq.fdct_quant4x4_plain(_to_blocks(gy - pred_inter), qp,
                                       intra=False)
    rec_inter = kt.clip1(
        pred_inter + _from_blocks(kt.block_recon(lev_inter, qp)))
    inter_zz = kt.zigzag_scan(lev_inter[:, ZZ_ROWS, ZZ_COLS])  # [B,16,16]

    t8_sel = torch.zeros(b, dtype=torch.bool, device=gy.device)
    if tools.t8:
        # ---- 8x8-transform candidate (High profile, 16x16 MBs) ----
        blk8 = (gy - pred_inter).reshape(b, 2, 8, 2, 8).permute(0, 1, 3, 2, 4)
        lev8 = kt8.quant8x8(kt8.fdct8x8(blk8), qp, intra=False)
        rec8 = kt.clip1(pred_inter + kt8.idct8x8(kt8.dequant8x8(lev8, qp))
                        .permute(0, 1, 3, 2, 4).reshape(b, 16, 16))
        # SSD + lambda x coefficient bits over the exact reconstructions
        def cost(rec, lev):
            ssd = ((gy - rec) ** 2).sum(dim=(1, 2), dtype=I32)
            bits = kt8.coeff_bits(lev).reshape(b, -1).sum(dim=1, dtype=I32)
            return kt8.choice_cost(ssd, bits, qp)

        t8_sel = (is_inter & (ptype == 0)
                  & (cost(rec8, lev8) < cost(rec_inter, lev_inter))
                  & (lev8 != 0).flatten(1).any(dim=1))
        # CAVLC interleave: coefficient 4k+i of the 8x8 scan becomes
        # coefficient k of pseudo-4x4 block i (spec 7.4.5.3.3); the pseudo
        # blocks land at BLK_ORDER rows 4n..4n+3 of luma_ac
        pseudo = kt8.zigzag_scan8(lev8).reshape(b, 4, 16, 4).transpose(2, 3)
        inter_zz = torch.where(t8_sel[:, None, None], pseudo.reshape(b, 16, 16),
                               inter_zz)
        rec_inter = torch.where(t8_sel[:, None, None], rec8, rec_inter)

    # ---- select luma outputs ----
    recon_mb = torch.where(
        is_inter[:, None, None], rec_inter,
        torch.where(sel16[:, None, None], rec16, mb4))
    ac16_zz = kt.zigzag_scan(ac_lev[:, ZZ_ROWS, ZZ_COLS])
    luma_ac = torch.where(
        is_inter[:, None, None], inter_zz,
        torch.where(sel16[:, None, None], ac16_zz, coeffs4))
    luma_dc = torch.where(is_i16[:, None], kt.zigzag_scan(dc_lev), 0)

    # ---- chroma: intra modes or MC prediction ----
    cmode, intra_outs = eval_chroma(
        gu, gv, tctx_u, lctx_u, tctx_v, lctx_v, at, al, atl, cqp)
    cy0 = r * 8 + PAD // 2
    cx0 = c * 8 + PAD // 2

    def cpred_of(cpad):
        pred = kint.mc_chroma(cpad, cy0, cx0, mv_sel)
        if tools.partitions:
            c16x8 = torch.cat(
                [kint.mc_chroma(cpad, cy0, cx0, mv_t, bh=4, bw=8),
                 kint.mc_chroma(cpad, cy0 + 4, cx0, mv_bt, bh=4, bw=8)], dim=1)
            c8x16 = torch.cat(
                [kint.mc_chroma(cpad, cy0, cx0, mv_l, bh=8, bw=4),
                 kint.mc_chroma(cpad, cy0, cx0 + 4, mv_r, bh=8, bw=4)], dim=2)
            pred = torch.where(
                use_16x8[:, None, None], c16x8,
                torch.where(use_8x16[:, None, None], c8x16, pred))
        if tools.p8x8:
            # per-quadrant 4x4 chroma MC overrides the two-partition chain
            # (ptype == 3 is decided after 16x8/8x16)
            cquad = torch.cat([torch.cat(
                [kint.mc_chroma(cpad, cy0 + 4 * qy, cx0 + 4 * qx,
                                mv_q[2 * qy + qx], bh=4, bw=4)
                 for qx in (0, 1)], dim=2) for qy in (0, 1)], dim=1)
            pred = torch.where((ptype == 3)[:, None, None], cquad, pred)
        return pred

    inter_u = chroma_residual_recon(gu, cpred_of(cu_pad), cqp, intra=False)
    inter_v = chroma_residual_recon(gv, cpred_of(cv_pad), cqp, intra=False)
    chroma = []
    for (i_rec, i_dc, i_ac), (p_rec, p_dc, p_ac) in (
            (intra_outs[0], inter_u), (intra_outs[1], inter_v)):
        rec = torch.where(is_inter[:, None, None], p_rec, i_rec)
        dc = torch.where(is_inter[:, None], p_dc, i_dc)
        ac = torch.where(is_inter[:, None, None], p_ac, i_ac)
        chroma.append((rec, dc, ac))

    # ---- write back border state ----
    mode_tiles = torch.where((is_inter | sel16)[:, None, None], -1, modebuf)
    update_border_ctx(bd, r, c, recon_mb, chroma[0][0], chroma[1][0],
                      mode_tiles)
    # channel cell values (which partition covers each boundary cell):
    #   tr (rows 0-1, right col): 16x8 -> part0, 8x16 -> part1
    #   bl (bottom row, col 0-1): 16x8 -> part1, 8x16 -> part0
    #   br (bottom row, right col): part1 for both shapes
    # and for P_8x8 tr <- q1, bl <- q2, br <- q3; row hm + 1 of the maps
    # takes the padding lanes' writes
    for ch, second, quad in ((CH_TR, ptype == 2, 1), (CH_BL, ptype == 1, 2),
                             (CH_BR, ptype > 0, 3)):
        mvv = torch.where(second[:, None], mv2_sel, mv_sel)
        if tools.p8x8:
            mvv = torch.where((ptype == 3)[:, None], mv_q[quad], mvv)
        mv_map[ch, r + 1, c + 1] = torch.where(is_inter[:, None], mvv, 0)
    ref_map[:, r + 1, c + 1] = torch.where(is_inter, 0, mvpred.INTRA) \
        .to(I32)

    out = dict(is_inter=is_inter, mv=mv_sel, mv_pred=mv_pred,
               mv_skip=mv_skip, sel16=is_i16, i16mode=m16, cmode=cmode,
               luma_ac=luma_ac, luma_dc=luma_dc,
               chroma_dc=torch.stack([chroma[0][1], chroma[1][1]], dim=1),
               chroma_ac=torch.stack([chroma[0][2], chroma[1][2]], dim=1),
               recon_mb=recon_mb, rec_u=chroma[0][0], rec_v=chroma[1][0])
    if tools.partitions:
        out["ptype"] = torch.where(is_inter, ptype, 0).to(I32)
        out["mv2"] = mv2_sel
    if tools.p8x8:
        out["mvq"] = mv_parts[:, 4:].contiguous()
    if tools.t8:
        out["t8"] = t8_sel
    return out


def wave_body_plain(planes, cu_pad, cv_pad, qp: int, cqp: int, lam4: int,
                    lam24: int, lam_me: int, bd, mv_map, ref_map, coords,
                    avail, mv_me, gy, gu, gv, mv_parts=None,
                    tools: kp.Tools = kp.NO_TOOLS, wy: int = 64,
                    oy: int = 0) -> dict:
    """One P wave in plain torch: gather, the I4x4 search, then
    `p_wave_plain`."""
    r, c = coords[:, 0].long(), coords[:, 1].long()
    at, al, atl, atr = avail.unbind(1)
    ltop, lleft, _, _, _, _, modes_top, modes_left = gather_border_ctx(
        bd, r, c)
    mb4, modebuf, modes_zz, coeffs4, j4 = eval_i4x4_plain(
        gy, ltop, lleft, modes_top, modes_left, at, al, atl, atr,
        qp, lam4, lam24)
    res = p_wave_plain(bd, mv_map, ref_map, planes, cu_pad, cv_pad, coords,
                       avail, mv_me, gy, gu, gv, mb4, modebuf, coeffs4, j4,
                       qp, cqp, lam4, lam24, lam_me, mv_parts, tools, wy, oy)
    return {k: modes_zz if k == "modes" else res[k]
            for k in kp.outputs(tools)}


def p_frame_plain(planes, cu_pad, cv_pad, qp: int, cqp: int, lam4: int,
                  lam24: int, lam_me: int, bd, mv_map, ref_map, coords,
                  avail, mv_me, gy, gu, gv, mv_parts=None,
                  tools: kp.Tools = kp.NO_TOOLS, wy: int = 64, oy: int = 0,
                  out=None, waves=None) -> dict:
    """Plain torch version of KP's frame form (`frame_body`, same inputs,
    what the kernel is held to): the waves [w0, w1) of the per-wave
    arrays (`waves`; None: all) one after another through
    `wave_body_plain`, each wave's results into its row of `out`."""
    n = coords.shape[0]
    w0, w1 = (0, n) if waves is None else waves
    if out is None:
        out = kp.alloc_outputs(coords.shape[:2], gy.device, tools)
    for w in range(w0, w1):
        res = wave_body_plain(planes, cu_pad, cv_pad, qp, cqp, lam4, lam24,
                              lam_me, bd, mv_map, ref_map, coords[w],
                              avail[w], mv_me[w], gy[w], gu[w], gv[w],
                              None if mv_parts is None else mv_parts[w],
                              tools, wy, oy)
        for k, v in res.items():
            out[k][w] = v
    return out


def frame_body(planes, cu_pad, cv_pad, qp: int, cqp: int, lam4: int,
               lam24: int, lam_me: int, bd, mv_map, ref_map, coords, avail,
               mv_me, gy, gu, gv, mv_parts=None,
               tools: kp.Tools = kp.NO_TOOLS, wy: int = 64, oy: int = 0,
               out=None, waves=None) -> dict:
    """The P wave body of the waves [w0, w1) of a picture (`waves`; None:
    all), in order: for each wave the decision among P_Skip, P_L0_16x16
    (with `tools`: P_L0_16x8, P_L0_8x16, P_8x8 and the 8x8 transform),
    I16x16 and I4x4, transform, quantisation and reconstruction of the
    MBs of the wave table coords [n_waves, bmax, 2] (int32; padding lanes
    at (hm, 0)) with avail [n_waves, bmax, 4], full-search vectors mv_me
    [n_waves, bmax, 2] (and the partitions' mv_parts [n_waves, bmax, 8,
    2]) and source tiles gy [n_waves, bmax, 16, 16], gu, gv [.., 8, 8],
    against the reference's half-pel `planes` and padded chroma, every
    luma prediction weighted by (wy, oy) after interpolation; the border
    buffers `bd` and the maps give the neighbour context and take the
    finished MBs' borders and vectors, in place.  Returns `out` (given, or
    allocated: `kernels.p_wave.alloc_outputs`), whose rows [w0, w1) hold
    the waves' results.

    CUDA tensors go through one launch of KP (or it raises), CPU tensors
    through `p_frame_plain`.
    """
    if gy.device.type == "cpu":
        return p_frame_plain(planes, cu_pad, cv_pad, qp, cqp, lam4, lam24,
                             lam_me, bd, mv_map, ref_map, coords, avail,
                             mv_me, gy, gu, gv, mv_parts, tools, wy, oy, out,
                             waves)
    if out is None:
        out = kp.alloc_outputs(coords.shape[:2], gy.device, tools)
    kp.p_frame(bd, mv_map, ref_map, planes, cu_pad, cv_pad, coords, avail,
               mv_me, gy, gu, gv, qp, cqp, lam4, lam24, lam_me, _BLK_ORDER,
               _K2_RULES, out, mv_parts, tools, wy, oy, waves)
    return out


def wave_body(planes, cu_pad, cv_pad, qp: int, cqp: int, lam4: int,
              lam24: int, lam_me: int, bd, mv_map, ref_map, coords, avail,
              mv_me, gy, gu, gv, mv_parts=None,
              tools: kp.Tools = kp.NO_TOOLS, out=None, wy: int = 64,
              oy: int = 0) -> dict:
    """One P wave of B lanes: `frame_body` of a picture of one wave, with
    the wave's arrays coords [B,2], avail [B,4], mv_me [B,2], (mv_parts
    [B,8,2]), gy [B,16,16], gu, gv [B,8,8].  Returns the wave's results,
    a dict of [B, ...] tensors (`kernels.p_wave.outputs(tools)`), written
    into `out` when it is given.  CUDA tensors: one launch of KP; CPU
    tensors: `wave_body_plain`."""
    if gy.device.type == "cpu":
        return wave_body_plain(planes, cu_pad, cv_pad, qp, cqp, lam4, lam24,
                               lam_me, bd, mv_map, ref_map, coords, avail,
                               mv_me, gy, gu, gv, mv_parts, tools, wy, oy)
    if out is None:
        out = kp.alloc_outputs((gy.shape[0],), gy.device, tools)
    one = [None if t is None else t.unsqueeze(0)
           for t in (coords, avail, mv_me, gy, gu, gv, mv_parts)]
    frame_body(planes, cu_pad, cv_pad, qp, cqp, lam4, lam24, lam_me, bd,
               mv_map, ref_map, *one, tools, wy, oy,
               out={k: v.unsqueeze(0) for k, v in out.items()})
    return out


def motion_vectors(y, ref_pad, planes, lam_me: int, wm: int, hm: int,
                   rng: int, shapes) -> dict:
    """Motion search of one list, parallel over all MBs, against the
    reference `ref_pad` and its half-pel `planes`: the integer full search
    of every block of `shapes` (`me_subpel.shapes`), then their sub-pel
    refinement, one launch each on the card (KF, KS) -> {block name:
    quarter-pel vectors [n_mbs, 2]}."""
    names = ksp.names_of(shapes)
    mv_int = kfs.full_search(y, ref_pad, PAD, rng, lam_me, wm, hm, names)
    return dict(zip(names, ksp.subpel(y, planes, PAD, mv_int, lam_me, wm, hm,
                                      shapes)))


def make_inter_encoder(sched: WaveSchedule,
                       chroma_qp_offset: int = 0, search_range: int = 16,
                       ref_prepadded: bool = False,
                       partitions: bool = False, t8: bool = False,
                       weighted: bool = False, p8x8: bool = False):
    """P-frame encoder for a fixed geometry:
    fn(y, u, v, ref_y, ref_u, ref_v, qp[, wy, oy]) -> (recon dict, per-wave
    outputs stacked [n_waves, max_wave, ...]); planes are tensors on the
    device that runs the encode, qp (and the weights) Python ints.

    `ref_prepadded`: ref planes arrive already PAD-extended (a tiled
    caller supplies real rows of the neighbour tiles instead of edge
    replication).  `partitions`: the 16x8 / 8x16 candidates (per-half ME;
    the outputs gain "ptype" and "mv2").  `p8x8`: the P_8x8 candidate
    (per-quadrant ME; "mvq" and ptype 3), which needs `partitions`.
    `t8`: the High-profile 8x8 transform of 16x16 inter MBs, where it is
    cheaper by SSD + lambda x coefficient bits ("t8"; luma_ac carries the
    CAVLC-interleaved pseudo-4x4 blocks).  `weighted`: explicit luma
    weighted prediction (spec 8.4.2.3.2, denominator 6): fn takes the
    frame's weight and offset (wy, oy); motion search runs against the
    pre-weighted reference clip(((ref * wy + 32) >> 6) + oy) and that
    picture's own half-pel planes, while the wave weighs each luma
    prediction after interpolation from the unweighted planes.  Chroma
    keeps the default weights.
    """
    if p8x8 and not partitions:
        raise ValueError("p8x8 requires partitions")
    tools = kp.Tools(partitions, p8x8, t8)
    wm, hm = sched.width_mbs, sched.height_mbs
    # clamp search so windows stay inside the padded plane
    rng = min(search_range, PAD - 8)
    shapes = ksp.shapes(partitions, p8x8)

    def motion_search(y, ref_pad, planes, lam_me):
        """Phase 1 (`motion_vectors`) -> quarter-pel vectors of the MB
        [n_mbs, 2] and of the partitions [n_mbs, 8, 2] (zeros where a tool
        is off; None without partitions)."""
        mv_q = motion_vectors(y, ref_pad, planes, lam_me, wm, hm, rng, shapes)
        if not partitions:
            return mv_q["16x16"], None
        zero = torch.zeros_like(mv_q["16x16"])
        return mv_q["16x16"], torch.stack(
            [mv_q.get(n, zero) for n in kp.PARTS], dim=1)

    def encode(y, u, v, ref_y, ref_u, ref_v, qp: int, wy: int = 64,
               oy: int = 0):
        dev = y.device
        if not weighted:
            wy, oy = 64, 0
        wy, oy = int(wy), int(oy)
        y, u, v = y.to(I32), u.to(I32), v.to(I32)
        qp = int(qp)
        cqp = chroma_qp(qp, chroma_qp_offset)
        lam4, lam24, lam_me = LAMBDA_TABLE[qp]
        if ref_prepadded:
            ref_pad, cu_pad, cv_pad = (p.to(I32).contiguous()
                                       for p in (ref_y, ref_u, ref_v))
        else:
            ref_pad = kint.pad_plane(ref_y, PAD)
            cu_pad = kint.pad_plane(ref_u, PAD // 2)
            cv_pad = kint.pad_plane(ref_v, PAD // 2)
        planes = kint.luma_planes(ref_pad)
        me_ref = weight_luma(ref_pad, wy, oy)
        me_planes = planes if me_ref is ref_pad else kint.luma_planes(me_ref)

        mv_q, mv_parts = motion_search(y, me_ref, me_planes, lam_me)
        # the wave table: [n_waves, Bmax, ...]
        idx = torch.as_tensor(np.minimum(sched.mb_index, sched.n_mbs - 1),
                              dtype=torch.int64, device=dev)
        bd = init_border_buffers(hm, wm, dev)
        mv_map = torch.zeros((3, hm + 2, wm + 2, 2), dtype=I32, device=dev)
        ref_map = torch.full((3, hm + 2, wm + 2), mvpred.UNAVAIL, dtype=I32,
                             device=dev)
        gy_all, gu_all, gv_all = tile_origin_xs(sched, y, u, v)
        coords = torch.as_tensor(sched.coords, dtype=I32, device=dev)
        avail = torch.as_tensor(sched.avail, device=dev)
        # every wave of the picture: one launch on the card
        ys = frame_body(planes, cu_pad, cv_pad, qp, cqp, lam4, lam24, lam_me,
                        bd, mv_map, ref_map, coords, avail, mv_q[idx],
                        gy_all, gu_all, gv_all,
                        None if mv_parts is None else mv_parts[idx], tools,
                        wy, oy)
        out = dict(
            recon_y=assemble_plane(sched, ys.pop("recon_mb"), 16),
            recon_u=assemble_plane(sched, ys.pop("rec_u"), 8),
            recon_v=assemble_plane(sched, ys.pop("rec_v"), 8),
        )
        return out, ys

    return encode

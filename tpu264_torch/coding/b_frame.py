"""Wavefront B-frame encoder (torch), counterpart of
`tpu264.coding.b_frame`: bi-predictive 16x16, 16x8/8x16 partitions,
spatial direct/skip, and intra modes.

As in the P engine (`inter_frame.py`), both references are full-searched
and sub-pel-refined for every MB in parallel (`inter_frame.motion_vectors`:
KF and KS, one launch each a list on the card), then the
wavefront decision pass picks per MB among B_L0_16x16 / B_L1_16x16 /
B_Bi_16x16 (average bi-prediction), B_Direct_16x16 (spatial direct, spec
8.4.1.2.2: the in-scan median predictors double as the direct vectors,
zeroed where the colocated MB of the list-1 reference is still,
`colzero`), with `partitions` the two-partition 16x8 / 8x16 shapes with
an L0 / L1 / Bi choice per partition (Table 7-14 mb_type 4..21) on the
frames that allow them, and the intra modes.  Per-list vector prediction
is carried through the scan on 3-channel boundary-cell maps as the P
engine does.

btype codes in the results: 0 = L0, 1 = L1, 2 = Bi, 3 = Direct, 4 =
intra, 5 = two-partition (see bptype / c0 / c1); `use0` / `use1` are the
MB's final per-list use flags (partition 0's for btype 5) and mv0 / mv1
its final per-list vectors (partition 0's; mv0b / mv1b carry partition
1's).  Direct MBs whose cbp is 0 go out as B_Skip.  Partitioned MBs are
for non-reference B frames (`allow_parts`): the per-MB colZeroFlag input
is exact only while colocated pictures keep MB-constant motion.

The kernel on this path is one launch a B picture (`frame_body`): the B
wave kernel KB in its frame form (`kernels.b_wave.b_frame`: every wave of
the picture in order, a grid barrier between waves; in a wave the
Intra4x4 search beside both lists' vector prediction, every candidate and
the I16x16 and chroma searches, then the decision, the chosen residual's
transforms, the merge, the border scatter and the map writes).  The plain
version, which the CPU takes, is `b_frame_plain`: a loop over the waves
of `wave_body_plain` (`gather_border_ctx`, `eval_i4x4_plain`, then
`b_wave_plain`).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu264_torch.kernels import dct_quant as dq
from tpu264_torch.kernels import b_wave as kb
from tpu264_torch.kernels import interp as kint
from tpu264_torch.kernels import me_subpel as ksp
from tpu264_torch.kernels import transform as kt
from tpu264_torch.ref.transform import chroma_qp
from . import mvpred
from .b_mbtypes import (COMBO_IDX, TB_PART, TYPE_BITS,  # noqa: F401
                        part_mb_type)
from .inter_frame import (CH_BL, CH_BR, CH_TR, PAD, _from_blocks, _satd16,
                          _to_blocks, motion_vectors, mvd_bits)
from .intra_frame import (_BLK_ORDER, _K2_RULES, I32, LAMBDA_TABLE, ZZ_COLS,
                          ZZ_ROWS, assemble_plane, chroma_residual_recon,
                          eval_chroma, eval_i16, eval_i4x4_plain,
                          gather_border_ctx, init_border_buffers,
                          tile_origin_xs, update_border_ctx)
from .wavefront import WaveSchedule

# (offset y, offset x, height, width) of each half, luma and chroma
GEO = dict(top=(0, 0, 8, 16), bot=(8, 0, 8, 16), left=(0, 0, 16, 8),
           right=(0, 8, 16, 8))
CGEO = dict(top=(0, 0, 4, 8), bot=(4, 0, 4, 8), left=(0, 0, 8, 4),
            right=(0, 4, 8, 4))


def neighbor_mvs(mv_map, ref_map, r, c, al, at, atl, atr):
    """One list's median vector predictor (ref 0) and the spatial-direct
    flag "a neighbour A, B or C uses this list", from the 3-channel
    boundary-cell maps (A = left MB's tr cell, B = top MB's bl cell, C =
    top-right MB's bl cell, D = top-left MB's br cell) -> (pred [B, 2],
    any_used [B])."""
    def nbr(ch, dr, dc):
        return mv_map[ch, r + dr, c + dc], ref_map[ch, r + dr, c + dc]

    mv_a, ref_a = nbr(CH_TR, 1, 0)
    mv_b, ref_b = nbr(CH_BL, 0, 1)
    mv_c, ref_c = nbr(CH_BL, 0, 2)
    mv_d, ref_d = nbr(CH_BR, 0, 0)
    ref_a = torch.where(al, ref_a, mvpred.UNAVAIL)
    ref_b = torch.where(at, ref_b, mvpred.UNAVAIL)
    ref_c = torch.where(atr, ref_c, mvpred.UNAVAIL)
    ref_d = torch.where(atl, ref_d, mvpred.UNAVAIL)
    mv_a = torch.where((ref_a >= 0)[:, None], mv_a, 0)
    mv_b = torch.where((ref_b >= 0)[:, None], mv_b, 0)
    mv_c = torch.where((ref_c >= 0)[:, None], mv_c, 0)
    mv_d = torch.where((ref_d >= 0)[:, None], mv_d, 0)
    use_d = ref_c == mvpred.UNAVAIL
    mv_c = torch.where(use_d[:, None], mv_d, mv_c)
    ref_c = torch.where(use_d, ref_d, ref_c)
    pred = mvpred.predict_mv(mv_a, ref_a, mv_b, ref_b, mv_c, ref_c)
    return pred, (ref_a == 0) | (ref_b == 0) | (ref_c == 0)


def spatial_direct(maps, coords, avail, colzero):
    """Both lists' median predictors and the spatial-direct candidate
    (spec 8.4.1.2.2) of the lanes at coords, from the maps before their
    wave: the predictors double as the direct vectors, zeroed where no
    neighbour uses either list (both lists used then) or the colocated MB
    is still (`colzero`) -> (mv_pred0, mv_pred1, dmv0, dmv1, duse0,
    duse1)."""
    mv0_map, ref0_map, mv1_map, ref1_map = maps
    r, c = coords[:, 0].long(), coords[:, 1].long()
    at, al, atl, atr = avail.unbind(1)
    mv_pred0, nb_use0 = neighbor_mvs(mv0_map, ref0_map, r, c, al, at, atl,
                                     atr)
    mv_pred1, nb_use1 = neighbor_mvs(mv1_map, ref1_map, r, c, al, at, atl,
                                     atr)
    zero_pred = ~nb_use0 & ~nb_use1
    dzero = (zero_pred | colzero)[:, None]
    return (mv_pred0, mv_pred1, torch.where(dzero, 0, mv_pred0),
            torch.where(dzero, 0, mv_pred1), zero_pred | nb_use0,
            zero_pred | nb_use1)


def _satd_blocks(diff, bh: int, bw: int):
    """SATD (DC included) of a [B, bh, bw] residual, summed per lane."""
    b = diff.shape[0]
    blk = diff.reshape(b, bh // 4, 4, bw // 4, 4).permute(0, 1, 3, 2, 4)
    return kt.satd4x4(blk).sum(dim=(1, 2), dtype=I32)


def _pick3(cc, a, b, c):
    """Per lane: a where cc == 0, b where 1, c where 2."""
    sel = cc.reshape((-1,) + (1,) * (a.dim() - 1))
    return torch.where(sel == 0, a, torch.where(sel == 1, b, c))


def b_wave_plain(bd, maps, planes, cpads, coords, avail, mv_me, mv_parts,
                 colzero, colmixed, gy, gu, gv, mb4, modebuf, coeffs4, j4,
                 qp: int, cqp: int, lam4: int, lam24: int, lam_me: int,
                 partitions: bool = False, allow_parts: bool = False) -> dict:
    """The B wave body after the Intra4x4 search, in plain torch (what
    KB's inter group computes; `b_frame_plain` is KB's plain version): for
    B lanes at coords [B,2] (int32 (r, c);
    padding lanes at (hm, 0)) with avail [B,4], each list's neighbour
    vectors from maps = (mv0_map, ref0_map, mv1_map, ref1_map), the median
    predictions and the direct vectors, the inter candidates (MC from the
    half-pel `planes` of each reference, SATD + lam_me x (vector bits +
    mb_type bits)): L0, L1, Bi and direct (never where `colmixed`), with
    `partitions` and `allow_parts` the 16x8 / 8x16 shapes from the halves'
    vectors mv_parts (list 0, list 1) [B,4,2] (`kernels.b_wave.HALVES`);
    the I16x16 and chroma searches, the decision against the I4x4 results
    (recon, mode grid, scanned levels, cost), the chosen residuals, the
    border scatter into `bd` and the map writes, in place.  Returns every
    result of `kernels.b_wave.outputs(partitions)` but "modes"."""
    mv0_map, ref0_map, mv1_map, ref1_map = maps
    planes0, planes1 = planes
    c0u, c0v, c1u, c1v = cpads
    mv_me0, mv_me1 = mv_me
    r, c = coords[:, 0].long(), coords[:, 1].long()
    b = gy.shape[0]
    dev = gy.device
    at, al, atl, atr = avail.unbind(1)
    ltop, lleft, tctx_u, lctx_u, tctx_v, lctx_v, _, _ = gather_border_ctx(
        bd, r, c)

    mv_pred0, mv_pred1, dmv0, dmv1, duse0, duse1 = spatial_direct(
        maps, coords, avail, colzero)
    y0 = r * 16 + PAD
    x0 = c * 16 + PAD
    pred0 = kint.mc_luma(planes0, y0, x0, mv_me0)
    pred1 = kint.mc_luma(planes1, y0, x0, mv_me1)
    pred_bi = (pred0 + pred1 + 1) >> 1

    # ---- spatial direct candidate (spec 8.4.1.2.2) ----
    pred_d0 = kint.mc_luma(planes0, y0, x0, dmv0)
    pred_d1 = kint.mc_luma(planes1, y0, x0, dmv1)
    pred_dir = torch.where(
        (duse0 & duse1)[:, None, None], (pred_d0 + pred_d1 + 1) >> 1,
        torch.where(duse0[:, None, None], pred_d0, pred_d1))

    rb0 = mvd_bits(mv_me0 - mv_pred0)
    rb1 = mvd_bits(mv_me1 - mv_pred1)
    j0 = _satd16(gy, pred0) + lam_me * (rb0 + TYPE_BITS[0])
    j1 = _satd16(gy, pred1) + lam_me * (rb1 + TYPE_BITS[1])
    jbi = _satd16(gy, pred_bi) + lam_me * (rb0 + rb1 + TYPE_BITS[2])
    jd = _satd16(gy, pred_dir) + lam_me * 1          # ue(0): 1 bit, no mvd
    # colocated cells disagree on colZeroFlag (partitioned anchor): the
    # decoder derives direct per 4x4 -- never choose direct there
    jd = torch.where(colmixed, 2 ** 30, jd).to(I32)

    # ---- intra candidates ----
    m16, j16, rec16, dc_lev, ac_lev = eval_i16(
        gy, ltop, lleft, at, al, atl, qp)
    j_intra = torch.minimum(j16, j4)
    sel16 = j16 < j4

    js = torch.stack([j0, j1, jbi, jd, j_intra + lam24], dim=1)
    j_16, btype = js.min(dim=1)
    btype = btype.to(I32)
    is_direct16 = (btype == 3)[:, None]
    mv0_fin = torch.where(is_direct16, dmv0, mv_me0)
    mv1_fin = torch.where(is_direct16, dmv1, mv_me1)
    sel = btype[:, None, None]
    pred_inter = torch.where(
        sel == 0, pred0, torch.where(sel == 1, pred1,
                                     torch.where(sel == 2, pred_bi,
                                                 pred_dir)))

    zeros = torch.zeros(b, dtype=I32, device=dev)
    bptype, c0, c1 = zeros, zeros, zeros
    mv0b, mv1b = mv0_fin, mv1_fin
    use_p1 = use_p2 = torch.zeros(b, dtype=torch.bool, device=dev)
    if partitions:
        # ---- 16x8 / 8x16 two-partition candidates ----
        half = {}
        for i, (key, (py_, px_, bh, bw)) in enumerate(GEO.items()):
            mvh0, mvh1 = mv_parts[0][:, i], mv_parts[1][:, i]
            p0h = kint.mc_luma(planes0, y0 + py_, x0 + px_, mvh0, bh=bh,
                               bw=bw)
            p1h = kint.mc_luma(planes1, y0 + py_, x0 + px_, mvh1, bh=bh,
                               bw=bw)
            pbih = (p0h + p1h + 1) >> 1
            gh = gy[:, py_:py_ + bh, px_:px_ + bw]
            r0h = mvd_bits(mvh0 - mv_pred0)
            r1h = mvd_bits(mvh1 - mv_pred1)
            jh = torch.stack(
                [_satd_blocks(gh - p0h, bh, bw) + lam_me * r0h,
                 _satd_blocks(gh - p1h, bh, bw) + lam_me * r1h,
                 _satd_blocks(gh - pbih, bh, bw) + lam_me * (r0h + r1h)],
                dim=1)
            jmin, ch = jh.min(dim=1)
            half[key] = dict(mv0=mvh0, mv1=mvh1, c=ch.to(I32), jmin=jmin,
                             preds=(p0h, p1h, pbih))

        tb_part = torch.as_tensor(TB_PART, device=dev)

        def shape_cost(k0, k1, shape):
            tb = tb_part[shape][(half[k0]["c"] * 3 + half[k1]["c"]).long()]
            return half[k0]["jmin"] + half[k1]["jmin"] + lam_me * tb

        big = 2 ** 30
        j_p1 = shape_cost("top", "bot", 0) if allow_parts else \
            torch.full((b,), big, dtype=I32, device=dev)
        j_p2 = shape_cost("left", "right", 1) if allow_parts else \
            torch.full((b,), big, dtype=I32, device=dev)
        use_p1 = (j_p1 < j_16) & (j_p1 <= j_p2)
        use_p2 = (j_p2 < j_16) & (j_p2 < j_p1)
        bptype = torch.where(use_p1, 1, torch.where(use_p2, 2, 0)).to(I32)
        btype = torch.where(use_p1 | use_p2, 5, btype).to(I32)
        c0 = torch.where(use_p1, half["top"]["c"],
                         torch.where(use_p2, half["left"]["c"], 0)).to(I32)
        c1 = torch.where(use_p1, half["bot"]["c"],
                         torch.where(use_p2, half["right"]["c"], 0)).to(I32)
        u1, u2 = use_p1[:, None], use_p2[:, None]
        mv0_fin = torch.where(u1, half["top"]["mv0"],
                              torch.where(u2, half["left"]["mv0"], mv0_fin))
        mv1_fin = torch.where(u1, half["top"]["mv1"],
                              torch.where(u2, half["left"]["mv1"], mv1_fin))
        mv0b = torch.where(u1, half["bot"]["mv0"],
                           torch.where(u2, half["right"]["mv0"], mv0b))
        mv1b = torch.where(u1, half["bot"]["mv1"],
                           torch.where(u2, half["right"]["mv1"], mv1b))

        def part_pred(k, cc):
            return _pick3(cc, *half[k]["preds"])

        p16x8 = torch.cat([part_pred("top", c0), part_pred("bot", c1)],
                          dim=1)
        p8x16 = torch.cat([part_pred("left", c0), part_pred("right", c1)],
                          dim=2)
        pred_inter = torch.where(
            use_p1[:, None, None], p16x8,
            torch.where(use_p2[:, None, None], p8x16, pred_inter))

    is_inter = btype != 4
    is_direct = btype == 3
    partd = btype == 5
    combo_use0 = torch.as_tensor([True, False, True], device=dev)
    combo_use1 = torch.as_tensor([False, True, True], device=dev)
    # final per-list use flags; for btype 5 these are partition 0's
    use0 = torch.where(partd, combo_use0[c0.long()],
                       (btype == 0) | (btype == 2) | (is_direct & duse0))
    use1 = torch.where(partd, combo_use1[c0.long()],
                       (btype == 1) | (btype == 2) | (is_direct & duse1))
    use0b = torch.where(partd, combo_use0[c1.long()], use0)
    use1b = torch.where(partd, combo_use1[c1.long()], use1)
    is_i16 = (~is_inter) & sel16

    # ---- luma residual for the inter path ----
    lev_inter = dq.fdct_quant4x4_plain(_to_blocks(gy - pred_inter), qp,
                                       intra=False)
    rec_inter = kt.clip1(
        pred_inter + _from_blocks(kt.block_recon(lev_inter, qp)))
    inter_zz = kt.zigzag_scan(lev_inter[:, ZZ_ROWS, ZZ_COLS])

    recon_mb = torch.where(
        is_inter[:, None, None], rec_inter,
        torch.where(sel16[:, None, None], rec16, mb4))
    ac16_zz = kt.zigzag_scan(ac_lev[:, ZZ_ROWS, ZZ_COLS])
    luma_ac = torch.where(
        is_inter[:, None, None], inter_zz,
        torch.where(sel16[:, None, None], ac16_zz, coeffs4))
    luma_dc = torch.where(is_i16[:, None], kt.zigzag_scan(dc_lev), 0)

    # ---- chroma ----
    cmode, intra_outs = eval_chroma(
        gu, gv, tctx_u, lctx_u, tctx_v, lctx_v, at, al, atl, cqp)
    cy0 = r * 8 + PAD // 2
    cx0 = c * 8 + PAD // 2
    cpred = []
    for cpad0, cpad1 in ((c0u, c1u), (c0v, c1v)):
        p0 = kint.mc_chroma(cpad0, cy0, cx0, mv_me0)
        p1 = kint.mc_chroma(cpad1, cy0, cx0, mv_me1)
        d0 = kint.mc_chroma(cpad0, cy0, cx0, dmv0)
        d1 = kint.mc_chroma(cpad1, cy0, cx0, dmv1)
        pdir = torch.where((duse0 & duse1)[:, None, None], (d0 + d1 + 1) >> 1,
                           torch.where(duse0[:, None, None], d0, d1))
        cp = torch.where(
            sel == 0, p0, torch.where(sel == 1, p1,
                                      torch.where(sel == 2,
                                                  (p0 + p1 + 1) >> 1, pdir)))
        if partitions:
            def cpart(k, cc):
                py_, px_, bh, bw = CGEO[k]
                i = kb.HALVES.index(k)
                q0 = kint.mc_chroma(cpad0, cy0 + py_, cx0 + px_,
                                    mv_parts[0][:, i], bh=bh, bw=bw)
                q1 = kint.mc_chroma(cpad1, cy0 + py_, cx0 + px_,
                                    mv_parts[1][:, i], bh=bh, bw=bw)
                return _pick3(cc, q0, q1, (q0 + q1 + 1) >> 1)

            c16x8 = torch.cat([cpart("top", c0), cpart("bot", c1)], dim=1)
            c8x16 = torch.cat([cpart("left", c0), cpart("right", c1)], dim=2)
            cp = torch.where(
                (bptype == 1)[:, None, None], c16x8,
                torch.where((bptype == 2)[:, None, None], c8x16, cp))
        cpred.append(cp)
    inter_u = chroma_residual_recon(gu, cpred[0], cqp, intra=False)
    inter_v = chroma_residual_recon(gv, cpred[1], cqp, intra=False)
    chroma = []
    for (i_rec, i_dc, i_ac), (p_rec, p_dc, p_ac) in (
            (intra_outs[0], inter_u), (intra_outs[1], inter_v)):
        rec = torch.where(is_inter[:, None, None], p_rec, i_rec)
        dc = torch.where(is_inter[:, None], p_dc, i_dc)
        ac = torch.where(is_inter[:, None, None], p_ac, i_ac)
        chroma.append((rec, dc, ac))

    # ---- state write-back (3-channel cells per list) ----
    mode_tiles = torch.where((is_inter | sel16)[:, None, None], -1, modebuf)
    update_border_ctx(bd, r, c, recon_mb, chroma[0][0], chroma[1][0],
                      mode_tiles)
    # cell channel -> covering partition: tr = part 1 iff 8x16, bl = part 1
    # iff 16x8, br = part 1 iff partitioned; row hm + 1 of the maps takes
    # the padding lanes' writes
    for mv_p0, mv_p1, u_p0, u_p1, mvm, refm in (
            (mv0_fin, mv0b, use0, use0b, mv0_map, ref0_map),
            (mv1_fin, mv1b, use1, use1b, mv1_map, ref1_map)):
        for ch, sel1 in ((CH_TR, bptype == 2), (CH_BL, bptype == 1),
                         (CH_BR, bptype > 0)):
            mvv = torch.where(sel1[:, None], mv_p1, mv_p0)
            uu = torch.where(sel1, u_p1, u_p0) & is_inter
            mvm[ch, r + 1, c + 1] = torch.where(uu[:, None], mvv, 0)
            refm[ch, r + 1, c + 1] = torch.where(uu, 0, mvpred.INTRA) \
                .to(I32)

    out = dict(btype=btype, mv0=mv0_fin, mv1=mv1_fin, use0=use0, use1=use1,
               sel16=is_i16, i16mode=m16, cmode=cmode, luma_ac=luma_ac,
               luma_dc=luma_dc,
               chroma_dc=torch.stack([chroma[0][1], chroma[1][1]], dim=1),
               chroma_ac=torch.stack([chroma[0][2], chroma[1][2]], dim=1),
               recon_mb=recon_mb, rec_u=chroma[0][0], rec_v=chroma[1][0])
    if partitions:
        out.update(bptype=bptype, c0=c0, c1=c1, mv0b=mv0b, mv1b=mv1b)
    return out


def wave_body_plain(maps, planes, cpads, qp: int, cqp: int, lam4: int,
                    lam24: int, lam_me: int, bd, coords, avail, mv_me,
                    mv_parts, colzero, colmixed, gy, gu, gv,
                    partitions: bool = False,
                    allow_parts: bool = False) -> dict:
    """One B wave in plain torch: gather, the I4x4 search, then
    `b_wave_plain`."""
    r, c = coords[:, 0].long(), coords[:, 1].long()
    at, al, atl, atr = avail.unbind(1)
    ltop, lleft, _, _, _, _, modes_top, modes_left = gather_border_ctx(
        bd, r, c)
    mb4, modebuf, modes_zz, coeffs4, j4 = eval_i4x4_plain(
        gy, ltop, lleft, modes_top, modes_left, at, al, atl, atr,
        qp, lam4, lam24)
    res = b_wave_plain(bd, maps, planes, cpads, coords, avail, mv_me,
                       mv_parts, colzero, colmixed, gy, gu, gv, mb4, modebuf,
                       coeffs4, j4, qp, cqp, lam4, lam24, lam_me, partitions,
                       allow_parts)
    return {k: modes_zz if k == "modes" else res[k]
            for k in kb.outputs(partitions)}


def _row(pair, w):
    """Row w of a (list 0, list 1) pair of per-wave arrays (None: None)."""
    return None if pair is None else (pair[0][w], pair[1][w])


def b_frame_plain(maps, planes, cpads, qp: int, cqp: int, lam4: int,
                  lam24: int, lam_me: int, bd, coords, avail, mv_me,
                  mv_parts, colzero, colmixed, gy, gu, gv,
                  partitions: bool = False, allow_parts: bool = False,
                  out=None, waves=None) -> dict:
    """Plain torch version of KB's frame form (`frame_body`, same inputs,
    what the kernel is held to): the waves [w0, w1) of the per-wave
    arrays (`waves`; None: all) one after another through
    `wave_body_plain`, each wave's results into its row of `out`."""
    n = coords.shape[0]
    w0, w1 = (0, n) if waves is None else waves
    if out is None:
        out = kb.alloc_outputs(coords.shape[:2], gy.device, partitions)
    for w in range(w0, w1):
        res = wave_body_plain(maps, planes, cpads, qp, cqp, lam4, lam24,
                              lam_me, bd, coords[w], avail[w],
                              _row(mv_me, w), _row(mv_parts, w), colzero[w],
                              colmixed[w], gy[w], gu[w], gv[w], partitions,
                              allow_parts)
        for k, v in res.items():
            out[k][w] = v
    return out


def frame_body(maps, planes, cpads, qp: int, cqp: int, lam4: int,
               lam24: int, lam_me: int, bd, coords, avail, mv_me, mv_parts,
               colzero, colmixed, gy, gu, gv, partitions: bool = False,
               allow_parts: bool = False, out=None, waves=None) -> dict:
    """The B wave body of the waves [w0, w1) of a picture (`waves`; None:
    all), in order: for each wave the decision among B_L0 / B_L1 /
    B_Bi_16x16, B_Direct_16x16, (with `partitions` and `allow_parts`) the
    16x8 / 8x16 two-partition types, I16x16 and I4x4, transform,
    quantisation and reconstruction of the MBs of the wave table coords
    [n_waves, bmax, 2] (int32; padding lanes at (hm, 0)) with avail
    [n_waves, bmax, 4], search vectors mv_me = (list 0, list 1) [n_waves,
    bmax, 2] (and the halves' mv_parts, [n_waves, bmax, 4, 2] a list),
    colzero / colmixed [n_waves, bmax] and source tiles gy [n_waves, bmax,
    16, 16], gu, gv [.., 8, 8], against the references' half-pel `planes`
    and padded chroma `cpads` (u0, v0, u1, v1); the border buffers `bd`
    and both lists' `maps` give the neighbour context and take the
    finished MBs' borders and vectors, in place.  Returns `out` (given, or
    allocated: `kernels.b_wave.alloc_outputs`), whose rows [w0, w1) hold
    the waves' results.

    CUDA tensors go through one launch of KB (or it raises), CPU tensors
    through `b_frame_plain`.
    """
    if gy.device.type == "cpu":
        return b_frame_plain(maps, planes, cpads, qp, cqp, lam4, lam24,
                             lam_me, bd, coords, avail, mv_me, mv_parts,
                             colzero, colmixed, gy, gu, gv, partitions,
                             allow_parts, out, waves)
    if out is None:
        out = kb.alloc_outputs(coords.shape[:2], gy.device, partitions)
    kb.b_frame(bd, maps, planes, cpads, coords, avail, mv_me, mv_parts,
               colzero, colmixed, gy, gu, gv, qp, cqp, lam4, lam24, lam_me,
               _BLK_ORDER, _K2_RULES, out, partitions, allow_parts, waves)
    return out


def wave_body(maps, planes, cpads, qp: int, cqp: int, lam4: int, lam24: int,
              lam_me: int, bd, coords, avail, mv_me, mv_parts, colzero,
              colmixed, gy, gu, gv, partitions: bool = False,
              allow_parts: bool = False, out=None) -> dict:
    """One B wave of B lanes: `frame_body` of a picture of one wave, with
    the wave's arrays coords [B,2], avail [B,4], mv_me (two [B,2]),
    mv_parts (two [B,4,2], or None), colzero, colmixed [B], gy
    [B,16,16], gu, gv [B,8,8].  Returns the wave's results, a dict of
    [B, ...] tensors (`kernels.b_wave.outputs(partitions)`), written into
    `out` when it is given.  CUDA tensors: one launch of KB; CPU tensors:
    `wave_body_plain`."""
    if gy.device.type == "cpu":
        return wave_body_plain(maps, planes, cpads, qp, cqp, lam4, lam24,
                               lam_me, bd, coords, avail, mv_me, mv_parts,
                               colzero, colmixed, gy, gu, gv, partitions,
                               allow_parts)
    if out is None:
        out = kb.alloc_outputs((gy.shape[0],), gy.device, partitions)
    pair = lambda p: None if p is None else tuple(t.unsqueeze(0) for t in p)
    frame_body(maps, planes, cpads, qp, cqp, lam4, lam24, lam_me, bd,
               coords.unsqueeze(0), avail.unsqueeze(0), pair(mv_me),
               pair(mv_parts), colzero.unsqueeze(0), colmixed.unsqueeze(0),
               gy.unsqueeze(0), gu.unsqueeze(0), gv.unsqueeze(0), partitions,
               allow_parts, out={k: v.unsqueeze(0) for k, v in out.items()})
    return out


def make_b_encoder(sched: WaveSchedule, chroma_qp_offset: int = 0,
                   search_range: int = 16, ref_prepadded: bool = False,
                   partitions: bool = False):
    """B-frame encoder for a fixed geometry: fn(y, u, v, r0y, r0u, r0v,
    r1y, r1u, r1v, colzero, colmixed, qp, allow_parts=True) -> (recon
    dict, per-wave outputs stacked [n_waves, max_wave, ...]); planes are
    tensors on the device that runs the encode, colzero / colmixed [n_mbs]
    bool, qp a Python int.

    `colmixed`: colocated MBs whose 4x4 cells disagree on colZeroFlag
    (partitioned anchors); the direct candidate is never chosen there.
    `ref_prepadded`: both references arrive already PAD-extended (the
    tiled encoder hands in real rows of the neighbour bands instead of
    edge replication).  `partitions`: the 16x8 / 8x16 two-partition
    candidates (per-half ME for each list; the outputs gain "bptype",
    "c0", "c1", "mv0b", "mv1b"), on the frames whose `allow_parts` is
    true (the encoder turns it off on reference Bs)."""
    wm, hm = sched.width_mbs, sched.height_mbs
    rng = min(search_range, PAD - 8)
    shapes = ksp.shapes(partitions)

    def motion_search(y, ref_pad, planes, lam_me):
        """Phase 1 for one list (`inter_frame.motion_vectors`) ->
        quarter-pel vectors of the MB [n_mbs, 2] and of the halves
        [n_mbs, 4, 2] (None without partitions)."""
        mv_q = motion_vectors(y, ref_pad, planes, lam_me, wm, hm, rng, shapes)
        if not partitions:
            return mv_q["16x16"], None
        return mv_q["16x16"], torch.stack([mv_q[n] for n in kb.HALVES],
                                          dim=1)

    def encode(y, u, v, r0y, r0u, r0v, r1y, r1u, r1v, colzero, colmixed,
               qp: int, allow_parts: bool = True):
        dev = y.device
        y, u, v = y.to(I32), u.to(I32), v.to(I32)
        qp = int(qp)
        allow_parts = bool(allow_parts)
        cqp = chroma_qp(qp, chroma_qp_offset)
        lam4, lam24, lam_me = LAMBDA_TABLE[qp]
        if ref_prepadded:
            refs = [tuple(p.to(I32).contiguous() for p in r)
                    for r in ((r0y, r0u, r0v), (r1y, r1u, r1v))]
        else:
            refs = [(kint.pad_plane(ry, PAD), kint.pad_plane(ru, PAD // 2),
                     kint.pad_plane(rv, PAD // 2))
                    for ry, ru, rv in ((r0y, r0u, r0v), (r1y, r1u, r1v))]
        planes = tuple(kint.luma_planes(rp[0]) for rp in refs)
        cpads = (refs[0][1], refs[0][2], refs[1][1], refs[1][2])
        idx = torch.as_tensor(np.minimum(sched.mb_index, sched.n_mbs - 1),
                              dtype=torch.int64, device=dev)
        mvs, halves = [], []
        for (ry_pad, _, _), pl in zip(refs, planes):
            mv_q, mv_h = motion_search(y, ry_pad, pl, lam_me)
            mvs.append(mv_q[idx])
            halves.append(None if mv_h is None else mv_h[idx])

        bd = init_border_buffers(hm, wm, dev)
        maps = []
        for _ in range(2):
            maps += [torch.zeros((3, hm + 2, wm + 2, 2), dtype=I32,
                                 device=dev),
                     torch.full((3, hm + 2, wm + 2), mvpred.UNAVAIL,
                                dtype=I32, device=dev)]
        maps = tuple(maps)
        gy_all, gu_all, gv_all = tile_origin_xs(sched, y, u, v)
        coords = torch.as_tensor(sched.coords, dtype=I32, device=dev)
        avail = torch.as_tensor(sched.avail, device=dev)
        cz = colzero.to(torch.bool)[idx]
        cm = colmixed.to(torch.bool)[idx]
        # every wave of the picture: one launch on the card
        ys = frame_body(maps, planes, cpads, qp, cqp, lam4, lam24, lam_me, bd,
                        coords, avail, tuple(mvs),
                        tuple(halves) if partitions else None, cz, cm,
                        gy_all, gu_all, gv_all, partitions, allow_parts)
        out = dict(
            recon_y=assemble_plane(sched, ys.pop("recon_mb"), 16),
            recon_u=assemble_plane(sched, ys.pop("rec_u"), 8),
            recon_v=assemble_plane(sched, ys.pop("rec_v"), 8),
        )
        return out, ys

    return encode

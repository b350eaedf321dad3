"""Wavefront P-frame encoder (torch): IPPP with full-search 16x16 ME +
quarter-pel refinement, counterpart of `tpu264.coding.inter_frame`.

Motion estimation runs outside the serial MB order: every MB full-searches
and sub-pel-refines in parallel against the reference frame
(`kernels/me.py`), and only the decision pass (mv prediction, skip
inference, inter-vs-intra choice, reconstruction) runs in the
anti-diagonal wavefront loop, batched per wave.  Candidates per MB: P_Skip
(skip-mv MC), P_L0_16x16 (ME mv), Intra_16x16 and Intra_4x4 (the
`intra_frame.eval_*` machinery).

Kernels of a P wave on the card: K2 in its wave form (`eval_i4x4`), K2 on
the slab of inter residual blocks (`dct_quant.fdct_quant4x4`) and K3 on
the slabs of the I16x16 and the four chroma residuals
(`dct_quant.fdct4x4`).  The rest of the wave body is plain torch, as it is
plain `jnp` outside any kernel in the reference.

Not ported yet (each raises): 16x8/8x16 partitions, P_8x8, the 8x8
transform, weighted prediction.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu264_torch.kernels import dct_quant as dq
from tpu264_torch.kernels import interp as kint
from tpu264_torch.kernels import me as kme
from tpu264_torch.kernels import transform as kt
from tpu264_torch.ref.transform import chroma_qp
from . import mvpred
from .intra_frame import (I32, LAMBDA_TABLE, ZZ_COLS, ZZ_ROWS, assemble_plane,
                          chroma_residual_recon, eval_chroma, eval_i16,
                          eval_i4x4, gather_border_ctx, init_border_buffers,
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


def make_inter_encoder(sched: WaveSchedule,
                       chroma_qp_offset: int = 0, search_range: int = 16,
                       ref_prepadded: bool = False,
                       partitions: bool = False, t8: bool = False,
                       weighted: bool = False, p8x8: bool = False):
    """P-frame encoder for a fixed geometry:
    fn(y, u, v, ref_y, ref_u, ref_v, qp) -> (recon dict, per-wave outputs
    stacked [n_waves, max_wave, ...]); planes are tensors on the device
    that runs the encode, qp a Python int.

    `ref_prepadded`: ref planes arrive already PAD-extended (a tiled
    caller supplies real rows of the neighbour tiles instead of edge
    replication).  `partitions`, `p8x8`, `t8`, `weighted`: the tools of
    the reference that are not ported yet; asking for one raises.
    """
    for flag, item in ((partitions, "16x8/8x16 partitions"),
                       (p8x8, "P_8x8"), (t8, "the 8x8 transform"),
                       (weighted, "weighted prediction")):
        if flag:
            raise NotImplementedError(
                f"make_inter_encoder: {item} is not ported yet (ROADMAP "
                "Queue 1: default IPPP tools)")
    wm, hm = sched.width_mbs, sched.height_mbs
    # clamp search so windows stay inside the padded plane
    rng = min(search_range, PAD - 8)

    def wave_body(planes, cu_pad, cv_pad, qp, cqp, lam4, lam24, lam_me,
                  bd, mv_map, ref_map, coords, avail, mv_me, gy, gu, gv):
        """One wave of B lanes; `bd`, `mv_map` and `ref_map` are read and
        then updated in place.  Returns the wave's results."""
        r, c = coords[:, 0].long(), coords[:, 1].long()
        at, al, atl, atr = avail.unbind(1)
        (ltop, lleft, tctx_u, lctx_u, tctx_v, lctx_v,
         modes_top, modes_left) = gather_border_ctx(bd, r, c)

        # ---- neighbor MVs from the maps (padded: +1 row/col, +1 right,
        # and a trash row below for the padding lanes at r = hm, so every
        # index r + dr <= hm + 1, c + dc <= wm + 1 is in range) ----
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

        def inter_cost(mv):
            pred = kint.mc_luma(planes, y0, x0, mv)
            satd = kt.satd4x4(_to_blocks(gy - pred)).sum(dim=(1, 2),
                                                         dtype=I32)
            return pred, satd + lam_me * mvd_bits(mv - mv_pred)

        pred_me, j_me = inter_cost(mv_me)
        pred_skip, j_skip_raw = inter_cost(mv_skip)
        # bias skip slightly (its true rate is ~0 when residual is empty)
        j_skip = j_skip_raw - lam4
        use_skip_mv = j_skip < j_me
        mv_sel = torch.where(use_skip_mv[:, None], mv_skip, mv_me)
        pred_inter = torch.where(use_skip_mv[:, None, None], pred_skip,
                                 pred_me)
        j_inter = torch.minimum(j_skip, j_me)

        # ---- intra candidates (shared machinery) ----
        mb4, modebuf, modes_zz, coeffs4, j4 = eval_i4x4(
            gy, ltop, lleft, modes_top, modes_left, at, al, atl, atr,
            qp, lam4, lam24)
        m16, j16, rec16, dc_lev, ac_lev = eval_i16(
            gy, ltop, lleft, at, al, atl, qp)
        j_intra = torch.minimum(j16, j4)
        sel16 = j16 < j4

        # inter-vs-intra: intra pays the larger mb_type cost in P slices
        is_inter = j_inter < j_intra + lam24
        is_i16 = (~is_inter) & sel16

        # ---- luma residual for the inter path ----
        lev_inter = dq.fdct_quant4x4(_to_blocks(gy - pred_inter), qp,
                                     intra=False)
        rec_inter = kt.clip1(
            pred_inter + _from_blocks(kt.block_recon(lev_inter, qp)))
        inter_zz = kt.zigzag_scan(lev_inter[:, ZZ_ROWS, ZZ_COLS])  # [B,16,16]

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
        cpred_u = kint.mc_chroma(cu_pad, cy0, cx0, mv_sel)
        cpred_v = kint.mc_chroma(cv_pad, cy0, cx0, mv_sel)
        inter_u = chroma_residual_recon(gu, cpred_u, cqp, intra=False)
        inter_v = chroma_residual_recon(gv, cpred_v, cqp, intra=False)
        chroma = []
        for (i_rec, i_dc, i_ac), (p_rec, p_dc, p_ac) in (
                (intra_outs[0], inter_u), (intra_outs[1], inter_v)):
            rec = torch.where(is_inter[:, None, None], p_rec, i_rec)
            dc = torch.where(is_inter[:, None], p_dc, i_dc)
            ac = torch.where(is_inter[:, None, None], p_ac, i_ac)
            chroma.append((rec, dc, ac))

        # ---- write back border state ----
        mode_tiles = torch.where((is_inter | sel16)[:, None, None], -1,
                                 modebuf)
        update_border_ctx(bd, r, c, recon_mb, chroma[0][0], chroma[1][0],
                          mode_tiles)
        # row hm + 1 of the maps takes the padding lanes' writes
        mv_map[:, r + 1, c + 1] = torch.where(is_inter[:, None], mv_sel, 0)
        ref_map[:, r + 1, c + 1] = torch.where(is_inter, 0, mvpred.INTRA) \
            .to(I32)

        return dict(is_inter=is_inter, mv=mv_sel, mv_pred=mv_pred,
                    mv_skip=mv_skip,
                    sel16=is_i16, i16mode=m16, modes=modes_zz, cmode=cmode,
                    luma_ac=luma_ac, luma_dc=luma_dc,
                    chroma_dc=torch.stack([chroma[0][1], chroma[1][1]],
                                          dim=1),
                    chroma_ac=torch.stack([chroma[0][2], chroma[1][2]],
                                          dim=1),
                    recon_mb=recon_mb, rec_u=chroma[0][0],
                    rec_v=chroma[1][0])

    def motion_search(y, ref_pad, planes, lam_me):
        """Phase 1, parallel over all MBs: full search + sub-pel
        refinement -> quarter-pel mv [n_mbs, 2]."""
        mv_int, _ = kme.full_search_16x16(y, ref_pad, PAD, rng, lam_me,
                                          wm, hm)
        return kme.subpel_refine(y, planes, PAD, mv_int, lam_me, wm, hm)

    def encode(y, u, v, ref_y, ref_u, ref_v, qp: int):
        dev = y.device
        y, u, v = y.to(I32), u.to(I32), v.to(I32)
        qp = int(qp)
        cqp = chroma_qp(qp, chroma_qp_offset)
        lam4, lam24, lam_me = LAMBDA_TABLE[qp]
        if ref_prepadded:
            ref_pad, cu_pad, cv_pad = (p.to(I32)
                                       for p in (ref_y, ref_u, ref_v))
        else:
            ref_pad = kint.pad_plane(ref_y, PAD)
            cu_pad = kint.pad_plane(ref_u, PAD // 2)
            cv_pad = kint.pad_plane(ref_v, PAD // 2)
        planes = kint.luma_planes(ref_pad)

        mv_q = motion_search(y, ref_pad, planes, lam_me)
        # rearrange per wave: [n_waves, Bmax, 2]
        idx = torch.as_tensor(np.minimum(sched.mb_index, sched.n_mbs - 1),
                              dtype=torch.int64, device=dev)
        mv_wave = mv_q[idx]

        bd = init_border_buffers(hm, wm, dev)
        mv_map = torch.zeros((3, hm + 2, wm + 2, 2), dtype=I32, device=dev)
        ref_map = torch.full((3, hm + 2, wm + 2), mvpred.UNAVAIL, dtype=I32,
                             device=dev)
        gy_all, gu_all, gv_all = tile_origin_xs(sched, y, u, v)
        coords = torch.as_tensor(sched.coords, dtype=I32, device=dev)
        avail = torch.as_tensor(sched.avail, device=dev)
        per_wave = [
            wave_body(planes, cu_pad, cv_pad, qp, cqp, lam4, lam24, lam_me,
                      bd, mv_map, ref_map, *x)
            for x in zip(*(t.unbind(0) for t in (
                coords, avail, mv_wave, gy_all, gu_all, gv_all)))]
        ys = {k: torch.stack([w[k] for w in per_wave]) for k in per_wave[0]}
        out = dict(
            recon_y=assemble_plane(sched, ys.pop("recon_mb"), 16),
            recon_u=assemble_plane(sched, ys.pop("rec_u"), 8),
            recon_v=assemble_plane(sched, ys.pop("rec_v"), 8),
        )
        return out, ys

    return encode

"""Slice-data serialization: per-MB element grids → RBSP bytes (CAVLC).

The write path of JM's `encode_one_slice`/`writeMBLayer` (SURVEY.md §3.1)
re-shaped for batch hardware: all syntax elements of every MB in the frame
are computed as dense (value, length) numpy grids — header elements via
vectorized Exp-Golomb, residual blocks via `cavlc.encode_blocks` — and
each slice's bits are packed in one `pack_bits` pass.  Fixed layout per
MB: 20 header slots + 27 residual blocks x 36 slots; absent elements have
length 0.
"""

from __future__ import annotations

import numpy as np

from tpu264_torch.bits.bitwriter import pack_bits
from tpu264_torch.bits.expgolomb import se_to_ue, ue_code
from tpu264_torch.coding.wavefront import BLK_ORDER
from . import cavlc, mb_syntax

HDR_SLOTS = 20
RES_BLOCKS = 1 + 16 + 2 + 8     # I16DC, 16 luma, 2 chroma DC, 8 chroma AC
MB_SLOTS = HDR_SLOTS + RES_BLOCKS * cavlc.SLOTS_PER_BLOCK

# P-slice layout: skip_run + mb_type + 16 intra modes + cmode + mvd x/y +
# cbp + qp_delta (+1 spare)
HDR_SLOTS_P = 24
MB_SLOTS_P = HDR_SLOTS_P + RES_BLOCKS * cavlc.SLOTS_PER_BLOCK


def serialize_frame_mbs(mb, width_mbs: int, height_mbs: int,
                        slice_start_rows) -> tuple[np.ndarray, np.ndarray]:
    """Build the [n_mbs, MB_SLOTS] (value, length) grids for an I frame.

    `mb` is the dict from `reorder_wave_outputs`: sel16, i16mode, modes,
    cmode, luma_ac [n,16,16], luma_dc [n,16], chroma_dc [n,2,4],
    chroma_ac [n,2,4,16].
    """
    n = width_mbs * height_mbs
    sel16 = mb["sel16"].astype(bool)
    values = np.zeros((n, MB_SLOTS), dtype=np.uint64)
    lengths = np.zeros((n, MB_SLOTS), dtype=np.int64)

    luma_ac = mb["luma_ac"].astype(np.int64)
    cbp_luma, cbp_chroma, cbp = mb_syntax.compute_cbp(
        sel16, luma_ac, mb["chroma_dc"], mb["chroma_ac"])

    # --- header elements ---
    mbt = mb_syntax.mb_type_i(sel16, mb["i16mode"], cbp_chroma, cbp_luma)
    values[:, 0], lengths[:, 0] = ue_code(mbt)

    # intra 4x4 pred modes: flag / flag+rem, against MPM from the final maps
    modes_grid = np.full((height_mbs * 4, width_mbs * 4), -1, dtype=np.int64)
    mb_r = np.arange(n) // width_mbs
    mb_c = np.arange(n) % width_mbs
    modes = mb["modes"].astype(np.int64)          # [n,16] zig-zag order
    for idx, (by, bx) in enumerate(BLK_ORDER):
        modes_grid[mb_r * 4 + by, mb_c * 4 + bx] = np.where(
            sel16, -1, modes[:, idx])
    mpm = mb_syntax.mpm_grid(modes_grid, [r * 4 for r in slice_start_rows])
    for idx, (by, bx) in enumerate(BLK_ORDER):
        m = modes[:, idx]
        p = mpm[mb_r * 4 + by, mb_c * 4 + bx]
        is_mpm = m == p
        rem = m - (m > p)
        values[:, 1 + idx] = np.where(is_mpm, 1, rem).astype(np.uint64)
        lengths[:, 1 + idx] = np.where(~sel16, np.where(is_mpm, 1, 4), 0)

    values[:, 17], lengths[:, 17] = ue_code(mb["cmode"].astype(np.int64))

    cbp_code, cbp_len = ue_code(mb_syntax.CBP_TO_CODENUM_INTRA[cbp])
    values[:, 18] = np.where(~sel16, cbp_code, 0)
    lengths[:, 18] = np.where(~sel16, cbp_len, 0)

    # mb_qp_delta (always 0: fixed QP) when residual or I16x16 present
    has_delta = sel16 | (cbp > 0)
    dq_code, dq_len = ue_code(se_to_ue(np.zeros(n, dtype=np.int64)))
    values[:, 19] = np.where(has_delta, dq_code, 0)
    lengths[:, 19] = np.where(has_delta, dq_len, 0)

    _write_residuals(values, lengths, HDR_SLOTS, mb, sel16, cbp_luma,
                     cbp_chroma, width_mbs, height_mbs, slice_start_rows)
    return values, lengths


def _write_residuals(values, lengths, hdr_slots, mb, sel16, cbp_luma,
                     cbp_chroma, width_mbs, height_mbs, slice_start_rows):
    """Residual blocks shared by I and P layouts.

    `sel16` marks I16x16 MBs (15-coeff AC blocks + DC block); all other
    coded MBs use 16-coeff luma blocks.
    """
    n = width_mbs * height_mbs
    mb_r = np.arange(n) // width_mbs
    mb_c = np.arange(n) % width_mbs
    luma_ac = mb["luma_ac"].astype(np.int64)
    ltc = mb_syntax.luma_tc_grid(sel16, cbp_luma, luma_ac,
                                 width_mbs, height_mbs)
    lnc = mb_syntax.nc_from_grid(ltc, 4, [r * 4 for r in slice_start_rows])
    ctc = [mb_syntax.chroma_tc_grid(cbp_chroma, mb["chroma_ac"], comp,
                                    width_mbs, height_mbs)
           for comp in range(2)]
    cnc = [mb_syntax.nc_from_grid(g, 2, [r * 2 for r in slice_start_rows])
           for g in ctc]

    def put_block(slot: int, coeffs, nc, max_coeff, coded):
        v, l, _ = cavlc.encode_blocks(coeffs, nc, max_coeff)
        s0 = hdr_slots + slot * cavlc.SLOTS_PER_BLOCK
        s1 = s0 + cavlc.SLOTS_PER_BLOCK
        values[:, s0:s1] = np.where(coded[:, None], v, 0)
        lengths[:, s0:s1] = np.where(coded[:, None], l, 0)

    # I16x16 DC block: nC of luma block idx 0
    nc_dc = lnc[mb_r * 4, mb_c * 4]
    put_block(0, mb["luma_dc"].astype(np.int64), nc_dc, 16, sel16)

    # luma blocks (zig-zag idx order)
    for idx, (by, bx) in enumerate(BLK_ORDER):
        nc = lnc[mb_r * 4 + by, mb_c * 4 + bx]
        blk16 = luma_ac[:, idx]
        coded8 = ((cbp_luma >> (idx // 4)) & 1) > 0
        # 16-coeff block (I4x4 / inter); I_16x16: 15-coeff AC block
        vi, li, _ = cavlc.encode_blocks(blk16, nc, 16)
        va, la, _ = cavlc.encode_blocks(blk16[:, 1:], nc, 15)
        s0 = hdr_slots + (1 + idx) * cavlc.SLOTS_PER_BLOCK
        s1 = s0 + cavlc.SLOTS_PER_BLOCK
        use = coded8[:, None]
        values[:, s0:s1] = np.where(use, np.where(sel16[:, None], va, vi), 0)
        lengths[:, s0:s1] = np.where(use, np.where(sel16[:, None], la, li), 0)

    # chroma DC (nC = -1), coded when cbp_chroma >= 1
    for comp in range(2):
        put_block(17 + comp, mb["chroma_dc"][:, comp].astype(np.int64),
                  np.full(n, -1), 4, cbp_chroma >= 1)

    # chroma AC (15-coeff), coded when cbp_chroma == 2
    for comp in range(2):
        for idx in range(4):
            by, bx = idx // 2, idx % 2
            nc = cnc[comp][mb_r * 2 + by, mb_c * 2 + bx]
            put_block(19 + comp * 4 + idx,
                      mb["chroma_ac"][:, comp, idx, 1:].astype(np.int64),
                      nc, 15, cbp_chroma == 2)


def serialize_frame_mbs_p(mb, width_mbs: int, height_mbs: int,
                          slice_start_rows):
    """[n_mbs, MB_SLOTS_P] element grids for a P frame, plus the skip mask.

    `mb` adds to the intra dict: is_inter [n], mv [n,2] (qpel), mv_skip
    [n,2].  Returns (values, lengths, skipped [n] bool) — the caller must
    append the trailing mb_skip_run of each slice (see
    `trailing_skip_run`).
    """
    n = width_mbs * height_mbs
    is_inter = mb["is_inter"].astype(bool)
    sel16 = mb["sel16"].astype(bool) & ~is_inter
    values = np.zeros((n, MB_SLOTS_P), dtype=np.uint64)
    lengths = np.zeros((n, MB_SLOTS_P), dtype=np.int64)

    luma_ac = mb["luma_ac"].astype(np.int64)
    cbp_luma, cbp_chroma, cbp = mb_syntax.compute_cbp(
        sel16, luma_ac, mb["chroma_dc"], mb["chroma_ac"])

    # final MV maps → predictors (host recomputation over decided maps)
    from tpu264_torch.coding import mvpred
    mv = mb["mv"].astype(np.int64)
    mv_map = np.where(is_inter[:, None], mv, 0).reshape(height_mbs, width_mbs, 2)
    ref_map = np.where(is_inter, 0, mvpred.INTRA).reshape(height_mbs, width_mbs)
    nb = mvpred.neighbor_mvs_np(mv_map, ref_map, width_mbs, height_mbs,
                                slice_start_rows)
    mv_pred = mvpred.predict_mv_np(nb["mv_a"], nb["ref_a"], nb["mv_b"],
                                   nb["ref_b"], nb["mv_c"], nb["ref_c"])
    mvd = mv - mv_pred

    # skip: inter, mv == skip mv, no residual
    mv_skip = mb["mv_skip"].astype(np.int64)
    skipped = is_inter & (mv == mv_skip).all(axis=1) & (cbp == 0)

    # mb_skip_run per coded MB (reset at slice starts)
    skip_run = np.zeros(n, dtype=np.int64)
    run = 0
    slice_firsts = {int(r) * width_mbs for r in slice_start_rows}
    for i in range(n):
        if i in slice_firsts:
            run = 0
        if skipped[i]:
            run += 1
        else:
            skip_run[i] = run
            run = 0
    coded = ~skipped
    sr_code, sr_len = ue_code(skip_run)
    values[:, 0] = np.where(coded, sr_code, 0)
    lengths[:, 0] = np.where(coded, sr_len, 0)

    # mb_type: P_L0_16x16=0; intra offset by 5 (spec Table 7-13)
    mbt_intra = 5 + mb_syntax.mb_type_i(sel16, mb["i16mode"], cbp_chroma,
                                        cbp_luma)
    mbt = np.where(is_inter, 0, mbt_intra)
    t_code, t_len = ue_code(mbt)
    values[:, 1] = np.where(coded, t_code, 0)
    lengths[:, 1] = np.where(coded, t_len, 0)

    # intra 4x4 pred modes (slots 2..17) + chroma mode (18) for intra MBs
    is_i4 = coded & ~is_inter & ~sel16
    modes_grid = np.full((height_mbs * 4, width_mbs * 4), -1, dtype=np.int64)
    mb_r = np.arange(n) // width_mbs
    mb_c = np.arange(n) % width_mbs
    modes = mb["modes"].astype(np.int64)
    for idx, (by, bx) in enumerate(BLK_ORDER):
        modes_grid[mb_r * 4 + by, mb_c * 4 + bx] = np.where(
            is_i4, modes[:, idx], -1)
    mpm = mb_syntax.mpm_grid(modes_grid, [r * 4 for r in slice_start_rows])
    for idx, (by, bx) in enumerate(BLK_ORDER):
        m = modes[:, idx]
        p = mpm[mb_r * 4 + by, mb_c * 4 + bx]
        is_mpm = m == p
        rem = m - (m > p)
        values[:, 2 + idx] = np.where(is_mpm, 1, rem).astype(np.uint64)
        lengths[:, 2 + idx] = np.where(is_i4, np.where(is_mpm, 1, 4), 0)
    cm_code, cm_len = ue_code(mb["cmode"].astype(np.int64))
    intra_coded = coded & ~is_inter
    values[:, 18] = np.where(intra_coded, cm_code, 0)
    lengths[:, 18] = np.where(intra_coded, cm_len, 0)

    # mvd (x then y — spec compIdx order) for coded inter MBs
    inter_coded = coded & is_inter
    for k, comp in ((19, 1), (20, 0)):       # slot 19 = x (comp 1), 20 = y
        code, ln = ue_code(se_to_ue(mvd[:, comp]))
        values[:, k] = np.where(inter_coded, code, 0)
        lengths[:, k] = np.where(inter_coded, ln, 0)

    # cbp: inter table for inter MBs, intra table for I4 (none for I16)
    cbp_code_i, cbp_len_i = ue_code(mb_syntax.CBP_TO_CODENUM_INTRA[cbp])
    cbp_code_p, cbp_len_p = ue_code(mb_syntax.CBP_TO_CODENUM_INTER[cbp])
    has_cbp = is_i4 | inter_coded
    values[:, 21] = np.where(inter_coded, cbp_code_p,
                             np.where(is_i4, cbp_code_i, 0))
    lengths[:, 21] = np.where(inter_coded, cbp_len_p,
                              np.where(is_i4, cbp_len_i, 0))

    # mb_qp_delta when residual present or I16
    has_delta = coded & (sel16 | (cbp > 0))
    dq_code, dq_len = ue_code(se_to_ue(np.zeros(n, dtype=np.int64)))
    values[:, 22] = np.where(has_delta, dq_code, 0)
    lengths[:, 22] = np.where(has_delta, dq_len, 0)

    _write_residuals(values, lengths, HDR_SLOTS_P, mb, sel16, cbp_luma,
                     cbp_chroma, width_mbs, height_mbs, slice_start_rows)
    return values, lengths, skipped


def trailing_skip_run(skipped: np.ndarray, first_mb: int, last_mb: int):
    """Count of trailing skipped MBs in [first_mb, last_mb) — must be
    emitted as a final mb_skip_run before rbsp_trailing_bits."""
    run = 0
    for i in range(last_mb - 1, first_mb - 1, -1):
        if skipped[i]:
            run += 1
        else:
            break
    return run


def pack_slice(values: np.ndarray, lengths: np.ndarray, header_sink,
               final_skip_run: int | None = None):
    """Concatenate slice-header bits + MB element grid → RBSP bytes."""
    header_sink.put_array(values.reshape(-1), lengths.reshape(-1))
    if final_skip_run is not None and final_skip_run > 0:
        from tpu264_torch.bits.expgolomb import write_ue
        write_ue(header_sink, final_skip_run)
    header_sink.rbsp_trailing_bits()
    return header_sink.to_bytes()

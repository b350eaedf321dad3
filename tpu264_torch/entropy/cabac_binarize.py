"""CABAC binarization of I slices on device (torch).

Counterpart of the I-slice path of `tpu264.entropy.cabac_binarize_j`
(`binarize_frame_j`, `RecordRows`, `_residual_group_j`, `pack_records`,
`unpack_records_np`, `compact_slices_j`) and of the record kinds of
`tpu264.entropy.cabac_binarize`.  It builds the (kind, a, b) record
grids for a whole frame from the final syntax maps and compacts them per
slice into the packed streams kernel K1 replays.  The P/B and 8x8
transform branches are not ported yet.

The per-coefficient loops are emitted as blocked rows ([15, n]
significance maps, [16, 6, n] level groups, ...); the row order inside
each block is the coding order, as in the reference.

Record kinds:
  K_CTX  (0): `a` = ctxIdx, `b` = bin | (run_count << 1)
  K_BYP  (1): `a` = value (MSB-first), `b` = nbits (<= 16)
  K_TERM (2): `a` = bin (0 = continue, 1 = end of slice)
"""

from __future__ import annotations

import numpy as np
import torch

from tpu264_torch.coding.wavefront import BLK_ORDER
from .cabac_ctx import CBF_CAT_OFF, LVL_CAT_OFF, SIG_CAT_OFF, K_I4, K_I16, \
    K_SKIP
from .device_cavlc import (bit_length_minus1, blk_grid_index, compute_cbp,
                           mpm_grid)

K_CTX, K_BYP, K_TERM = 0, 1, 2
I32 = torch.int32


def _full(n: int, x, dtype, device) -> torch.Tensor:
    """x as an [n] tensor: a Python scalar is filled on device (no host
    copy); a tensor is broadcast."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype).expand(n)
    return torch.full((n,), x, dtype=dtype, device=device)


class RecordRows:
    """Accumulates [rows, n] record blocks; stacked to [S, n] grids."""

    def __init__(self, n: int, device):
        self.n = n
        self.device = device
        self.ks: list = []
        self.as_: list = []
        self.bs: list = []
        self.vs: list = []

    def _row(self, x, dtype=I32):
        return _full(self.n, x, dtype, self.device)[None, :]

    def put_block(self, kind, a, b, valid):
        """a/b/valid: [m, n] blocks (row-major record order)."""
        self.ks.append(torch.full(a.shape, kind, dtype=I32,
                                  device=self.device))
        self.as_.append(a.to(I32))
        self.bs.append(b.to(I32))
        self.vs.append(valid.to(torch.bool))

    def ctx_bin(self, ctx, binv, valid):
        b = (binv.to(I32) & 1) | 2 if isinstance(binv, torch.Tensor) \
            else (int(binv) & 1) | 2
        self.put_block(K_CTX, self._row(ctx), self._row(b),
                       self._row(valid, torch.bool))

    def terminate(self, binv, valid):
        self.put_block(K_TERM, self._row(binv), self._row(0),
                       self._row(valid, torch.bool))

    def stacked(self):
        return (torch.cat(self.ks, 0), torch.cat(self.as_, 0),
                torch.cat(self.bs, 0), torch.cat(self.vs, 0))


def eg_parts(v: torch.Tensor, k0: int):
    """Exp-Golomb order-k0 escape, vectorized over any shape: returns
    (pre_val, pre_bits, suffix_val, suffix_bits) int32 tensors."""
    v = v.to(I32)
    m = bit_length_minus1((v >> k0) + 1)
    p = torch.bitwise_left_shift(torch.ones_like(m), torch.clamp(m, max=30))
    vv = v - ((p - 1) << k0)
    return (p - 1) << 1, m + 1, vv, k0 + m


def _left2(g, fill=0):
    out = torch.full_like(g, fill)
    out[:, 1:] = g[:, :-1]
    return out


def _top2(g, mask, fill=0):
    out = torch.full_like(g, fill)
    out[1:, :] = g[:-1, :]
    return torch.where(mask, fill, out)


def _residual_group(grid: RecordRows, scanned, mc, sig_base, last_base,
                    lvl_base, cbf_ctx, coded, cdc_inc: bool):
    """Blocked residual block (127 rows): coded_block_flag, significance
    and last maps, levels and signs (spec 7.3.5.3.3, 9.3.2.3)."""
    scanned = scanned.to(I32)
    n = scanned.shape[0]
    dev = scanned.device
    nz = scanned != 0
    cbf = nz.any(dim=1)
    grid.ctx_bin(cbf_ctx, cbf.to(I32), coded)
    pos = torch.arange(16, dtype=I32, device=dev)
    last = torch.where(cbf, (nz * (pos + 1)[None, :]).amax(dim=1) - 1, -1)
    on_res = coded & cbf
    mc = _full(n, mc, I32, dev)

    # ---- significance / last maps: [15, 2, n] interleaved rows ----
    i_arr = torch.arange(15, dtype=I32, device=dev)
    inc = torch.clamp(i_arr, max=2) if cdc_inc else i_arr      # [15]
    on_i = (on_res[None, :] & (i_arr[:, None] <= last[None, :])
            & (i_arr[:, None] <= (mc - 2)[None, :]))          # [15, n]
    sig = nz.T[:15]                                           # [15, n]
    sig_a = _full(n, sig_base, I32, dev)[None, :] + inc[:, None]
    last_a = _full(n, last_base, I32, dev)[None, :] + inc[:, None]
    is_last = i_arr[:, None] == last[None, :]
    a_blk = torch.stack([sig_a, last_a], 1).reshape(30, n)
    b_blk = torch.stack([sig.to(I32) | 2, is_last.to(I32) | 2],
                        1).reshape(30, n)
    v_blk = torch.stack([on_i, on_i & sig], 1).reshape(30, n)
    grid.put_block(K_CTX, a_blk, b_blk, v_blk)

    # ---- levels + signs, i = 15..0 (6 rows per coefficient) ----
    absv = scanned.abs()
    gt1 = (absv > 1) & nz
    eq1 = (absv == 1) & nz

    def sfx(msk):
        m = msk.to(I32)
        return torch.cumsum(m.flip(1), dim=1, dtype=I32).flip(1) - m

    num_gt1 = sfx(gt1)
    num_eq1 = sfx(eq1)
    lvl_b = _full(n, lvl_base, I32, dev)
    ctx0 = lvl_b[:, None] + torch.where(num_gt1 > 0, 0,
                                        torch.clamp(1 + num_eq1, max=4))
    ctxn = lvl_b[:, None] + 5 + torch.clamp(num_gt1, max=4)
    onT = on_res[None, :] & nz.T.flip(0)                     # [16, n]
    a_abs = torch.where(onT, absv.T.flip(0) - 1, 0)          # [16, n]
    ctx0T = ctx0.T.flip(0)
    ctxnT = ctxn.T.flip(0)
    egp, egpb, egs, egsb = eg_parts(torch.clamp(a_abs - 14, min=0), 0)
    sgn = (scanned.T.flip(0) < 0).to(I32)
    run_cnt = torch.clamp(a_abs, max=14) - 1
    rows_a = torch.stack([ctx0T, ctxnT, ctxnT, egp, egs, sgn], 1)
    rows_b = torch.stack([(a_abs > 0).to(I32) | 2,
                          1 | (run_cnt << 1),
                          torch.full_like(a_abs, 2),
                          egpb, egsb, torch.ones_like(a_abs)], 1)
    rows_v = torch.stack([onT,
                          onT & (a_abs >= 2) & (run_cnt > 0),
                          onT & (a_abs >= 1) & (a_abs < 14),
                          onT & (a_abs >= 14) & (egpb > 0),
                          onT & (a_abs >= 14) & (egsb > 0),
                          onT], 1)
    kinds = torch.tensor([K_CTX] * 3 + [K_BYP] * 3, dtype=I32)
    grid.ks.append(kinds.to(dev)[None, :, None].expand(16, 6, n)
                   .reshape(96, n))
    grid.as_.append(rows_a.reshape(96, n))
    grid.bs.append(rows_b.reshape(96, n))
    grid.vs.append(rows_v.reshape(96, n))


def binarize_frame(mb, wm: int, hm: int, slice_rows):
    """I-slice records of a frame from its raster MB dict.

    Returns (kind [S, n] int32, a, b, valid [S, n] bool): slot-major,
    the same record semantics and order as `binarize_frame_j`."""
    n = wm * hm
    dev = mb["luma_ac"].device
    sel16 = mb["sel16"].to(torch.bool)
    luma_ac = mb["luma_ac"].to(I32)
    luma_dc = mb["luma_dc"].to(I32)
    chroma_dc = mb["chroma_dc"].to(I32)
    chroma_ac = mb["chroma_ac"].to(I32)
    modes = mb["modes"].to(I32)
    cmode = mb["cmode"].to(I32)
    i16mode = mb["i16mode"].to(I32)
    cbp_luma, cbp_chroma, cbp = compute_cbp(sel16, luma_ac, chroma_dc,
                                            chroma_ac)

    mb_r = np.arange(n) // wm
    mb_c = np.arange(n) % wm
    is_i4 = ~sel16
    g_rows, g_cols = blk_grid_index(wm, hm, dev)
    modes_grid = torch.full((hm * 4, wm * 4), -1, dtype=I32, device=dev)
    modes_grid[g_rows, g_cols] = torch.where(is_i4[:, None], modes, -1)
    mpm = mpm_grid(modes_grid, [int(r) * 4 for r in slice_rows])
    mpm_mb = mpm[g_rows, g_cols]                              # [n, 16]

    # ---- final-state neighbor grids (2D [hm, wm]); every MB is coded
    # and intra in an I slice ----
    kind_g = torch.where(sel16, K_I16, K_I4).to(I32).reshape(hm, wm)
    cbp_l_g = cbp_luma.reshape(hm, wm)
    cbp_c_g = cbp_chroma.reshape(hm, wm)
    cpm_g = cmode.reshape(hm, wm)

    av_l = np.zeros((hm, wm), dtype=bool)
    av_l[:, 1:] = True
    av_t = np.zeros((hm, wm), dtype=bool)
    av_t[1:, :] = True
    top_mask = np.zeros((hm, 1), dtype=bool)
    top_mask[0] = True
    for r in slice_rows:
        av_t[int(r), :] = False
        top_mask[int(r)] = True
    top_mask = torch.as_tensor(top_mask, device=dev)
    av_l = torch.as_tensor(av_l, device=dev)
    av_t = torch.as_tensor(av_t, device=dev)

    def left(g, fill=0):
        return _left2(g, fill)

    def top(g, fill=0):
        return _top2(g, top_mask, fill)

    grid = RecordRows(n, dev)
    ones = torch.ones(n, dtype=torch.bool, device=dev)

    # ---- mb_type (I slice) ----
    i16_l = (av_l & (left(kind_g, -1) == K_I16)).to(I32)
    i16_t = (av_t & (top(kind_g, -1) == K_I16)).to(I32)
    first_ctx = (3 + i16_l + i16_t).reshape(n)
    grid.ctx_bin(first_ctx, sel16.to(I32), ones)
    on16 = sel16
    grid.terminate(0, on16)
    grid.ctx_bin(6, (cbp_luma > 0).to(I32), on16)
    grid.ctx_bin(7, (cbp_chroma != 0).to(I32), on16)
    grid.ctx_bin(8, torch.clamp(cbp_chroma - 1, min=0), on16 & (cbp_chroma != 0))
    grid.ctx_bin(9, i16mode >> 1, on16)
    grid.ctx_bin(10, i16mode & 1, on16)

    # ---- intra 4x4 pred modes (16 x 4 rows) ----
    on_i4 = is_i4
    for idx in range(16):
        m = modes[:, idx]
        p = mpm_mb[:, idx]
        is_mpm = m == p
        grid.ctx_bin(68, is_mpm.to(I32), on_i4)
        rem = m - (m > p).to(I32)
        onr = on_i4 & ~is_mpm
        grid.ctx_bin(69, rem & 1, onr)
        grid.ctx_bin(69, (rem >> 1) & 1, onr)
        grid.ctx_bin(69, (rem >> 2) & 1, onr)

    # ---- intra_chroma_pred_mode ----
    cpm_l = left(kind_g, K_SKIP)
    cpm_t = top(kind_g, K_SKIP)
    nb_l = (av_l & ((cpm_l == K_I4) | (cpm_l == K_I16))
            & (left(cpm_g) != 0)).to(I32)
    nb_t = (av_t & ((cpm_t == K_I4) | (cpm_t == K_I16))
            & (top(cpm_g) != 0)).to(I32)
    cpm_ctx = (64 + nb_l + nb_t).reshape(n)
    grid.ctx_bin(cpm_ctx, (cmode != 0).to(I32), ones)
    grid.ctx_bin(67, (cmode > 1).to(I32), cmode != 0)
    grid.ctx_bin(67, (cmode == 3).to(I32), cmode > 1)

    # ---- coded_block_pattern ----
    on_cbp = ~sel16

    def cbp_cond_l(bit):
        v = ((left(cbp_l_g) >> bit) & 1) == 0
        return torch.where(av_l, v.to(I32), 0).reshape(n)

    def cbp_cond_t(bit):
        v = ((top(cbp_l_g) >> bit) & 1) == 0
        return torch.where(av_t, v.to(I32), 0).reshape(n)

    def own(bit):
        return (((cbp >> bit) & 1) == 0).to(I32)

    grid.ctx_bin(73 + cbp_cond_l(1) + 2 * cbp_cond_t(2), cbp & 1, on_cbp)
    grid.ctx_bin(73 + own(0) + 2 * cbp_cond_t(3), (cbp >> 1) & 1, on_cbp)
    grid.ctx_bin(73 + cbp_cond_l(3) + 2 * own(0), (cbp >> 2) & 1, on_cbp)
    grid.ctx_bin(73 + own(2) + 2 * own(1), (cbp >> 3) & 1, on_cbp)
    cc = cbp >> 4
    ccl = torch.where(av_l, (left(cbp_c_g) != 0).to(I32), 0).reshape(n)
    cct = torch.where(av_t, (top(cbp_c_g) != 0).to(I32), 0).reshape(n)
    grid.ctx_bin(77 + ccl + 2 * cct, (cc != 0).to(I32), on_cbp)
    ccl2 = torch.where(av_l, (left(cbp_c_g) == 2).to(I32), 0).reshape(n)
    cct2 = torch.where(av_t, (top(cbp_c_g) == 2).to(I32), 0).reshape(n)
    grid.ctx_bin(81 + ccl2 + 2 * cct2, torch.clamp(cc - 1, min=0),
                 on_cbp & (cc != 0))

    # ---- mb_qp_delta (always 0 in this encoder) ----
    grid.ctx_bin(60, 0, sel16 | (cbp > 0))

    # ---- residual blocks ----
    cbf_ldc = (sel16 & (luma_dc != 0).any(dim=1)).reshape(hm, wm)
    l4_i16 = (luma_ac[:, :, 1:] != 0).any(dim=2) & (cbp_luma > 0)[:, None]
    bit_of_idx = torch.arange(16, dtype=I32, device=dev) // 4
    l4_reg = (luma_ac != 0).any(dim=2) \
        & (((cbp_luma[:, None] >> bit_of_idx[None, :]) & 1) > 0)
    l4 = torch.where(sel16[:, None], l4_i16, l4_reg)
    cbf_l4_g = torch.zeros((hm * 4, wm * 4), dtype=I32, device=dev)
    cbf_l4_g[g_rows, g_cols] = l4.to(I32)
    cbf_cdc_g = torch.zeros((2, hm, wm), dtype=I32, device=dev)
    cbf_cac_g = torch.zeros((2, hm * 2, wm * 2), dtype=I32, device=dev)
    for comp in range(2):
        cbf_cdc_g[comp] = ((chroma_dc[:, comp] != 0).any(dim=1)
                           & (cbp_chroma >= 1)).reshape(hm, wm).to(I32)
        cac_nz = (chroma_ac[:, comp, :, 1:] != 0).any(dim=2) \
            & (cbp_chroma == 2)[:, None]
        for idx in range(4):
            cbf_cac_g[comp, mb_r * 2 + idx // 2, mb_c * 2 + idx % 2] = \
                cac_nz[:, idx].to(I32)

    # I16 luma DC (cat 0)
    v_l = torch.where(left(kind_g, -1) == K_I16,
                      left(cbf_ldc.to(I32)), 0)
    v_t = torch.where(top(kind_g, -1) == K_I16,
                      top(cbf_ldc.to(I32)), 0)
    ca = torch.where(av_l, v_l, 1).reshape(n)
    cb = torch.where(av_t, v_t, 1).reshape(n)
    _residual_group(grid, luma_dc, 16,
                    105 + SIG_CAT_OFF[0], 166 + SIG_CAT_OFF[0],
                    227 + LVL_CAT_OFF[0],
                    85 + CBF_CAT_OFF[0] + ca + 2 * cb, sel16, cdc_inc=False)

    # 16 luma blocks
    sig_b = torch.where(sel16, 105 + SIG_CAT_OFF[1], 105 + SIG_CAT_OFF[2])
    last_b = torch.where(sel16, 166 + SIG_CAT_OFF[1], 166 + SIG_CAT_OFF[2])
    lvl_b = torch.where(sel16, 227 + LVL_CAT_OFF[1], 227 + LVL_CAT_OFF[2])
    cbf_off = torch.where(sel16, CBF_CAT_OFF[1], CBF_CAT_OFF[2])
    mc_l = torch.where(sel16, 15, 16)
    lac16 = torch.where(
        sel16[:, None, None],
        torch.cat([luma_ac[:, :, 1:],
                   torch.zeros((n, 16, 1), dtype=I32, device=dev)], 2),
        luma_ac)
    av_l_flat = av_l.reshape(-1)
    av_t_flat = av_t.reshape(-1)
    for idx, (by, bx) in enumerate(BLK_ORDER):
        g4r, g4c = mb_r * 4 + by, mb_c * 4 + bx
        ca = cbf_l4_g[g4r, np.maximum(g4c - 1, 0)]
        cb = cbf_l4_g[np.maximum(g4r - 1, 0), g4c]
        if bx == 0:
            ca = torch.where(av_l_flat, ca, 1)
        if by == 0:
            cb = torch.where(av_t_flat, cb, 1)
        coded_blk = (sel16 & (cbp_luma > 0)) \
            | (~sel16 & (((cbp_luma >> (idx // 4)) & 1) > 0))
        _residual_group(grid, lac16[:, idx], mc_l, sig_b, last_b, lvl_b,
                        85 + cbf_off + ca + 2 * cb, coded_blk,
                        cdc_inc=False)

    # chroma DC (cat 3)
    for comp in range(2):
        v_l = torch.where(left(cbp_c_g) != 0, left(cbf_cdc_g[comp]), 0)
        v_t = torch.where(top(cbp_c_g) != 0, top(cbf_cdc_g[comp]), 0)
        ca = torch.where(av_l, v_l, 1).reshape(n)
        cb = torch.where(av_t, v_t, 1).reshape(n)
        cdc16 = torch.cat([chroma_dc[:, comp],
                           torch.zeros((n, 12), dtype=I32, device=dev)], 1)
        _residual_group(grid, cdc16, 4,
                        105 + SIG_CAT_OFF[3], 166 + SIG_CAT_OFF[3],
                        227 + LVL_CAT_OFF[3],
                        85 + CBF_CAT_OFF[3] + ca + 2 * cb,
                        cbp_chroma >= 1, cdc_inc=True)

    # chroma AC (cat 4)
    zero1 = torch.zeros((n, 1), dtype=I32, device=dev)
    for comp in range(2):
        for idx in range(4):
            by, bx = idx // 2, idx % 2
            g2r, g2c = mb_r * 2 + by, mb_c * 2 + bx
            ca = cbf_cac_g[comp, g2r, np.maximum(g2c - 1, 0)]
            cb = cbf_cac_g[comp, np.maximum(g2r - 1, 0), g2c]
            if bx == 0:
                ca = torch.where(av_l_flat, ca, 1)
            if by == 0:
                cb = torch.where(av_t_flat, cb, 1)
            cac16 = torch.cat([chroma_ac[:, comp, idx, 1:], zero1], 1)
            _residual_group(grid, cac16, 15,
                            105 + SIG_CAT_OFF[4], 166 + SIG_CAT_OFF[4],
                            227 + LVL_CAT_OFF[4],
                            85 + CBF_CAT_OFF[4] + ca + 2 * cb,
                            cbp_chroma == 2, cdc_inc=False)

    # ---- end_of_slice_flag ----
    rows = [int(r) for r in slice_rows] + [hm]
    is_last = np.zeros(n, np.int32)
    for s in range(len(rows) - 1):
        is_last[rows[s + 1] * wm - 1] = 1
    grid.terminate(torch.as_tensor(is_last, device=dev), ones)
    return grid.stacked()


def pack_records(k, a, b) -> torch.Tensor:
    """(kind, a, b) -> one int32 per record: kind<<30 | a<<14 | b.

    Built in int64 and wrapped to int32 explicitly: kind 2 sets the sign
    bit.  Ranges (by construction of the binarizer): kind <= 2, a < 2^16,
    b < 2^14."""
    p = (k.to(torch.int64) << 30) | (a.to(torch.int64) << 14) \
        | b.to(torch.int64)
    return torch.where(p >= 1 << 31, p - (1 << 32), p).to(I32)


def unpack_records(p: np.ndarray):
    """Host inverse of `pack_records`: packed int32 -> (kind, a, b)."""
    p = np.asarray(p, np.int32)
    return (p >> 30) & 3, (p >> 14) & 0xFFFF, p & 0x3FFF


def compact_slices(k, a, b, v, wm: int, slice_rows, hm: int, cap: int):
    """Per-slice mb-major compaction of the slot-major record grids into
    dense packed [n_slices, cap] int32 streams (zero past the count) and
    per-slice counts [n_slices] int32.  A slice with more than `cap`
    records keeps its true count and its first `cap` records; the caller
    must check counts <= cap."""
    packed = pack_records(k, a, b)
    rows = [int(r) for r in slice_rows] + [hm]
    n_slices = len(rows) - 1
    recs = torch.zeros((n_slices, cap), dtype=I32, device=packed.device)
    counts = torch.zeros(n_slices, dtype=I32, device=packed.device)
    for s in range(n_slices):
        lo, hi = rows[s] * wm, rows[s + 1] * wm
        vt = v[:, lo:hi].T.reshape(-1)
        data = packed[:, lo:hi].T.reshape(-1)
        # boolean selection keeps record order (one host sync per slice)
        sel = data[vt]
        counts[s] = sel.numel()
        m = min(sel.numel(), cap)
        recs[s, :m] = sel[:m]
    return recs, counts

"""CABAC binarization of I, P and B slices on device (torch).

Counterpart of `tpu264.entropy.cabac_binarize_j`
(`binarize_frame_j`, `RecordRows`, `_residual_group_j`,
`_residual_group8_j`, `pack_records`, `unpack_records_np`,
`compact_slices_j`) and of the record kinds of
`tpu264.entropy.cabac_binarize`.  It builds the (kind, a, b) record grids
for a whole frame from the final syntax maps and compacts them per slice
into the packed streams kernel K1 replays.  P slices carry the reference's
default P tools: 16x8/8x16 and P_8x8 partitions ("ptype", "mv2", "mvq")
and the 8x8 transform ("t8", whose flag also goes on the I_NxN MBs of an
I slice in the same PPS).  B slices carry L0 / L1 / Bi 16x16, direct (a
direct MB with cbp 0 is a B_Skip) and the 16x8 / 8x16 two-partition
types ("bptype", "c0", "c1", "mv0b", "mv1b"), with per-list mvds.

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

from tpu264_torch.coding.b_mbtypes import COMBO_IDX
from tpu264_torch.coding.wavefront import BLK_ORDER
from .cabac_ctx import CBF_CAT_OFF, LAST8_MAP, LVL_CAT_OFF, SIG8_MAP, \
    SIG_CAT_OFF, K_DIRECT, K_I4, K_I16, K_INTER, K_SKIP
from .device_cavlc import (_partition_mvds, b_list_flags, b_list_mvds,
                           bit_length_minus1, blk_grid_index,
                           compute_cbp, mpm_grid, mvd_16x16)

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

    def ctx_run(self, ctx, binv: int, count, valid):
        """`count` bins of value `binv` on context `ctx` (one record)."""
        self.put_block(K_CTX, self._row(ctx),
                       self._row((binv & 1) | (count << 1)),
                       self._row(valid & (count > 0), torch.bool))

    def bypass(self, value, nbits, valid):
        self.put_block(K_BYP, self._row(value), self._row(nbits),
                       self._row(valid & (nbits > 0), torch.bool))

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


def _level_rows(grid: RecordRows, scanned, on_res, lvl_base):
    """Levels and signs of a block group, last coefficient first: six rows
    a coefficient (the first bin, the run of ones, the closing zero, the
    EG0 escape's prefix and suffix, the sign).  scanned [n, m]; lvl_base
    [n] or an int."""
    n, m = scanned.shape
    dev = scanned.device
    nz = scanned != 0
    absv = scanned.abs()
    gt1 = (absv > 1) & nz
    eq1 = (absv == 1) & nz

    def sfx(msk):
        c = msk.to(I32)
        return torch.cumsum(c.flip(1), dim=1, dtype=I32).flip(1) - c

    num_gt1 = sfx(gt1)
    num_eq1 = sfx(eq1)
    lvl_b = _full(n, lvl_base, I32, dev)
    ctx0 = lvl_b[:, None] + torch.where(num_gt1 > 0, 0,
                                        torch.clamp(1 + num_eq1, max=4))
    ctxn = lvl_b[:, None] + 5 + torch.clamp(num_gt1, max=4)
    onT = on_res[None, :] & nz.T.flip(0)                      # [m, n]
    a_abs = torch.where(onT, absv.T.flip(0) - 1, 0)           # [m, n]
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
    grid.ks.append(kinds.to(dev)[None, :, None].expand(m, 6, n)
                   .reshape(6 * m, n))
    grid.as_.append(rows_a.reshape(6 * m, n))
    grid.bs.append(rows_b.reshape(6 * m, n))
    grid.vs.append(rows_v.reshape(6 * m, n))


def _sig_last_rows(grid: RecordRows, nz, last, sig_a, last_a, on_i):
    """The interleaved significance / last rows [2 m, n] of a block group:
    sig_a, last_a, on_i [m, n]; nz [n, > m]."""
    m, n = on_i.shape
    sig = nz.T[:m]
    is_last = torch.arange(m, dtype=I32, device=nz.device)[:, None] \
        == last[None, :]
    grid.put_block(K_CTX, torch.stack([sig_a, last_a], 1).reshape(2 * m, n),
                   torch.stack([sig.to(I32) | 2, is_last.to(I32) | 2],
                               1).reshape(2 * m, n),
                   torch.stack([on_i, on_i & sig], 1).reshape(2 * m, n))


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
    _sig_last_rows(grid, nz, last,
                   _full(n, sig_base, I32, dev)[None, :] + inc[:, None],
                   _full(n, last_base, I32, dev)[None, :] + inc[:, None],
                   on_i)
    # ---- levels + signs, i = 15..0 (6 rows per coefficient) ----
    _level_rows(grid, scanned, on_res, lvl_base)


_SIG8 = torch.as_tensor(402 + np.asarray(SIG8_MAP), dtype=I32)
_LAST8 = torch.as_tensor(417 + np.asarray(LAST8_MAP[:63]), dtype=I32)


def _residual_group8(grid: RecordRows, scan64, on_res):
    """Blocked cat-5 luma 8x8 residual (spec Table 9-43 context maps): 63
    significance / last row pairs and 64 x 6 level rows, no
    coded_block_flag (its presence is the cbp bit, `on_res`)."""
    scan64 = scan64.to(I32)
    n = scan64.shape[0]
    dev = scan64.device
    nz = scan64 != 0
    pos = torch.arange(64, dtype=I32, device=dev)
    last = (nz * (pos + 1)[None, :]).amax(dim=1) - 1
    i_arr = torch.arange(63, dtype=I32, device=dev)
    on_i = on_res[None, :] & (i_arr[:, None] <= last[None, :])
    _sig_last_rows(grid, nz, last,
                   _SIG8.to(dev)[:, None].expand(63, n),
                   _LAST8.to(dev)[:, None].expand(63, n), on_i)
    _level_rows(grid, scan64, on_res, 426)


def binarize_frame(mb, wm: int, hm: int, slice_rows, p_slice: bool = False,
                   b_slice: bool = False):
    """I-, P- or B-slice records of a frame from its raster MB dict.

    A P dict carries "is_inter", "mv" and "mv_skip"; with "ptype" and
    "mv2" the 16x8/8x16 partitions, with "mvq" also P_8x8; a B dict
    "btype", "mv0", "mv1", "use0", "use1", with "bptype", "c0", "c1",
    "mv0b", "mv1b" the two-partition types; with "t8" (a PPS with
    transform_8x8_mode_flag, in I and B slices a zero map) the 8x8
    transform.  Returns (kind [S, n] int32, a, b, valid [S, n] bool):
    slot-major, the same record semantics and order as
    `binarize_frame_j`."""
    n = wm * hm
    dev = mb["luma_ac"].device
    t8_mode = "t8" in mb
    if b_slice:
        btype, is_inter, partd, bptype, _, exp, exp_b = b_list_flags(mb)
        is_direct = btype == 3
    else:
        is_inter = (mb["is_inter"].to(torch.bool) if p_slice
                    else torch.zeros(n, dtype=torch.bool, device=dev))
        is_direct = torch.zeros(n, dtype=torch.bool, device=dev)
    sel16 = mb["sel16"].to(torch.bool) & ~is_inter
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
    is_i4 = ~sel16 & ~is_inter
    g_rows, g_cols = blk_grid_index(wm, hm, dev)
    modes_grid = torch.full((hm * 4, wm * 4), -1, dtype=I32, device=dev)
    modes_grid[g_rows, g_cols] = torch.where(is_i4[:, None], modes, -1)
    mpm = mpm_grid(modes_grid, [int(r) * 4 for r in slice_rows])
    mpm_mb = mpm[g_rows, g_cols]                              # [n, 16]

    # ---- the mvds (part0 / q0, part1 / q1, P_8x8 q2 and q3) and skips
    parts_mode = p_slice and "ptype" in mb
    p8x8_mode = parts_mode and "mvq" in mb
    ptype = torch.zeros(n, dtype=I32, device=dev)
    if p_slice:
        mv = mb["mv"].to(I32)
        if parts_mode:
            ptype = mb["ptype"].to(I32)
            mvds = _partition_mvds(mb, wm, hm, slice_rows)
            mvd0, mvd1 = mvds[:2]
            mvdq = mvds[2] if p8x8_mode else None
        else:
            mvd0 = mvd_16x16(mv, is_inter, wm, hm, slice_rows)
        skipped = (is_inter & (ptype == 0)
                   & (mv == mb["mv_skip"].to(I32)).all(dim=1) & (cbp == 0))
    elif b_slice:
        # per list: partition 0's (and 1's) mvds where the list is coded
        # explicitly
        bmvd = []
        for lx, (d0, d1) in enumerate(b_list_mvds(mb, wm, hm, slice_rows)):
            bmvd.append((torch.where(exp[lx][:, None], d0, 0),
                         None if d1 is None else
                         torch.where(exp_b[lx][:, None], d1, 0)))
        skipped = is_direct & (cbp == 0)
    else:
        skipped = torch.zeros(n, dtype=torch.bool, device=dev)
    coded = ~skipped
    intra_cur = ~is_inter

    # ---- final-state neighbor grids (2D [hm, wm]) ----
    kind_g = torch.where(
        skipped, K_SKIP,
        torch.where(is_direct, K_DIRECT,
                    torch.where(is_inter, K_INTER,
                                torch.where(sel16, K_I16, K_I4)))) \
        .to(I32).reshape(hm, wm)
    cbp_l_g = torch.where(coded, cbp_luma, 0).reshape(hm, wm)
    cbp_c_g = torch.where(coded, cbp_chroma, 0).reshape(hm, wm)
    cpm_g = torch.where(is_i4 | sel16, cmode, 0).reshape(hm, wm)

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

    def nb_sum(g_l, g_t):
        """Left neighbour's value in `g_l` plus top's in `g_t`, 0 where
        unavailable -> [n]."""
        return (torch.where(av_l, left(g_l), 0)
                + torch.where(av_t, top(g_t), 0)).reshape(n)

    grid = RecordRows(n, dev)
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    t8v = torch.zeros(n, dtype=torch.bool, device=dev)
    if t8_mode:
        # the flag's context counts the left and top MBs' coded t8
        t8v = mb["t8"].to(torch.bool) & is_inter & coded & (cbp_luma > 0)
        t8_g = t8v.to(I32).reshape(hm, wm)
        t8_inc = nb_sum(t8_g, t8_g)

    # ---- mb_skip_flag ----
    if p_slice or b_slice:
        nskip = (kind_g != K_SKIP).to(I32)
        grid.ctx_bin((24 if b_slice else 11) + nb_sum(nskip, nskip),
                     skipped.to(I32), ones)

    # ---- mb_type ----
    intra_coded = coded & intra_cur
    if b_slice:
        # Table 9-37 (B): bin 0 (ctx 27 + the left and top MBs that are
        # neither skipped nor direct) 0 = direct; '100' / '101' = L0 / L1
        # 16x16; '11' + 4 bits (+ 1) for Bi, the partitioned types and
        # the intra prefix
        nd = ((kind_g != K_SKIP) & (kind_g != K_DIRECT)).to(I32)
        explicit = coded & ~is_direct
        grid.ctx_bin(27 + nb_sum(nd, nd), (~is_direct).to(I32), coded)
        one_list = explicit & is_inter & ((btype == 0) | (btype == 1))
        on11 = (btype == 2) | partd | ~is_inter
        grid.ctx_bin(30, on11.to(I32), explicit)
        grid.ctx_bin(32, (btype == 1).to(I32), one_list)
        tail = explicit & on11
        # the '11' suffix: Bi 0000; intra 1101; types 4..10 value - 3;
        # 11 1110; 12..21 (value + 4) // 2 and one bit more
        bits13 = torch.where(is_inter, 0, 13)
        if "bptype" in mb:
            combo = torch.as_tensor(COMBO_IDX, device=dev)
            mbt_part = (4 + 2 * combo[(mb["c0"].to(I32) * 3
                                       + mb["c1"].to(I32)).long()]
                        + (bptype == 2).to(I32))
            bits13 = torch.where(
                partd, torch.where(mbt_part <= 10, mbt_part - 3,
                                   torch.where(mbt_part == 11, 14,
                                               (mbt_part + 4) // 2)),
                bits13)
        grid.ctx_bin(31, (bits13 >> 3) & 1, tail)
        for sh in (2, 1, 0):
            grid.ctx_bin(32, (bits13 >> sh) & 1, tail)
        if "bptype" in mb:
            grid.ctx_bin(32, mbt_part & 1, tail & partd & (mbt_part >= 12))
        first_ctx = 32
        rest = (33, 34, 34, 35, 35)
    elif p_slice:
        grid.ctx_bin(14, intra_cur.to(I32), coded)
        inter_coded = coded & is_inter
        # Table 9-37 P prefix: '000' 16x16, '011' 16x8, '010' 8x16, '001'
        # P_8x8 (the third bin's ctx is 16 after a second bin 0, else 17)
        pb1 = (ptype == 1) | (ptype == 2)
        grid.ctx_bin(15, pb1.to(I32), inter_coded)
        grid.ctx_bin(torch.where(pb1, 17, 16),
                     ((ptype == 1) | (ptype == 3)).to(I32), inter_coded)
        if p8x8_mode:
            # sub_mb_type x4: P_L0_8x8 = '1' (ctx 21, Table 9-38)
            on_sub = inter_coded & (ptype == 3)
            for _ in range(4):
                grid.ctx_bin(21, 1, on_sub)
        first_ctx = 17
        rest = (18, 19, 19, 20, 20)
    else:
        is_i16 = (kind_g == K_I16).to(I32)
        first_ctx = 3 + nb_sum(is_i16, is_i16)
        rest = (6, 7, 8, 9, 10)
    grid.ctx_bin(first_ctx, sel16.to(I32), intra_coded)
    on16 = intra_coded & sel16
    grid.terminate(0, on16)
    grid.ctx_bin(rest[0], (cbp_luma > 0).to(I32), on16)
    grid.ctx_bin(rest[1], (cbp_chroma != 0).to(I32), on16)
    grid.ctx_bin(rest[2], torch.clamp(cbp_chroma - 1, min=0),
                 on16 & (cbp_chroma != 0))
    grid.ctx_bin(rest[3], i16mode >> 1, on16)
    grid.ctx_bin(rest[4], i16mode & 1, on16)

    # ---- intra 4x4 pred modes (16 x 4 rows) ----
    on_i4 = coded & is_i4
    if t8_mode:
        grid.ctx_bin(399 + t8_inc, 0, on_i4)     # I_NxN: the 4x4 transform
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
    cpm_nb = (((kind_g == K_I4) | (kind_g == K_I16)) & (cpm_g != 0)).to(I32)
    grid.ctx_bin(64 + nb_sum(cpm_nb, cpm_nb), (cmode != 0).to(I32),
                 intra_coded)
    grid.ctx_bin(67, (cmode > 1).to(I32), intra_coded & (cmode != 0))
    grid.ctx_bin(67, (cmode == 3).to(I32), intra_coded & (cmode > 1))

    # ---- mvd: x (comp 1, base 40) then y (comp 0, base 47); with
    # partitions part0 then part1 (7.3.5.1 order), then P_8x8's q2 and q3;
    # the contexts sum |mvd| of the left and top 4x4 cells (spec
    # 9.3.3.1.1.7), a skipped or intra neighbour adding 0 ----
    if p_slice or b_slice:
        def emit_mvd(vals, s_of_comp, on_mv):
            for comp, base in ((1, 40), (0, 47)):
                s = s_of_comp(comp)
                inc = torch.where(s < 3, 0, torch.where(s <= 32, 1, 2))
                a = vals[:, comp].abs()
                grid.ctx_bin(base + inc, (a > 0).to(I32), on_mv)
                for k in (1, 2, 3):
                    grid.ctx_bin(base + k + 2, (a > k).to(I32),
                                 on_mv & (a >= k))
                grid.ctx_run(base + 6, 1, torch.clamp(a, max=9) - 4,
                             on_mv & (a >= 5))
                grid.ctx_bin(base + 6, 0, on_mv & (a >= 4) & (a < 9))
                egp, egpb, egs, egsb = eg_parts(torch.clamp(a - 9, min=0), 3)
                on_eg = on_mv & (a >= 9)
                grid.bypass(egp, egpb, on_eg)
                grid.bypass(egs, egsb, on_eg & (egsb > 0))
                grid.bypass((vals[:, comp] < 0).to(I32), 1, on_mv & (a > 0))

    if b_slice:
        # per list (list 0's mvds, then list 1's): partition 0 then 1, the
        # contexts from the |mvd| cells of that list
        for lx in range(2):
            on0 = coded & exp[lx]
            d0, d1 = bmvd[lx]
            a0 = torch.where(on0[:, None], d0.abs(), 0)
            if d1 is None:
                a0_g = a0.reshape(hm, wm, 2)
                emit_mvd(d0, lambda comp: nb_sum(a0_g[:, :, comp],
                                                 a0_g[:, :, comp]), on0)
                continue
            on1 = coded & exp_b[lx] & partd
            a1 = torch.where(on1[:, None], d1.abs(), 0)
            tr_g = torch.where((bptype == 2)[:, None], a1, a0) \
                .reshape(hm, wm, 2)
            bl_g = torch.where((bptype == 1)[:, None], a1, a0) \
                .reshape(hm, wm, 2)
            br_g = torch.where((bptype > 0)[:, None], a1, a0) \
                .reshape(hm, wm, 2)

            def s_p1(comp, br_g=br_g, a0=a0):
                # 16x8 bottom: A = left MB's br cell, B = own part 0;
                # 8x16 right: A = own part 0, B = top MB's br cell
                lbr = torch.where(av_l, left(br_g[:, :, comp]), 0) \
                    .reshape(n)
                tbr = torch.where(av_t, top(br_g[:, :, comp]), 0) \
                    .reshape(n)
                own = a0[:, comp]
                return torch.where(bptype == 1, lbr + own, own + tbr)

            emit_mvd(d0, lambda comp, tr_g=tr_g, bl_g=bl_g: nb_sum(
                tr_g[:, :, comp], bl_g[:, :, comp]), on0)
            emit_mvd(d1, s_p1, on1)
    elif p_slice:
        on0 = coded & is_inter
        a0 = torch.where(on0[:, None], mvd0.abs(), 0)
        if parts_mode:
            on1 = on0 & (ptype > 0)
            a1 = torch.where(on1[:, None], mvd1.abs(), 0)
            # |mvd| at the boundary 4x4 cells a later partition or MB
            # reads: tr (row 0, right column), bl (bottom row, column 0),
            # br (bottom row, right column); P_8x8: tr <- q1, bl <- q2,
            # br <- q3
            tr_g = torch.where(((ptype == 2) | (ptype == 3))[:, None],
                               a1, a0).reshape(hm, wm, 2)
            bl_cell = torch.where((ptype == 1)[:, None], a1, a0)
            br_cell = torch.where((ptype > 0)[:, None], a1, a0)
            if p8x8_mode:
                onq = on0 & (ptype == 3)
                a2 = torch.where(onq[:, None], mvdq[:, 2].abs(), 0)
                a3 = torch.where(onq[:, None], mvdq[:, 3].abs(), 0)
                bl_cell = torch.where((ptype == 3)[:, None], a2, bl_cell)
                br_cell = torch.where((ptype == 3)[:, None], a3, br_cell)
            bl_g = bl_cell.reshape(hm, wm, 2)
            br_g = br_cell.reshape(hm, wm, 2)

            def lbr(comp):
                # the left MB's bottom-right cell (its rows 2-3)
                g = br_g[:, :, comp]
                return torch.where(av_l, left(g), 0).reshape(n)

            def s_p0(comp):
                # part0 / q0: A = left MB's tr cell, B = top MB's bl cell
                return nb_sum(tr_g[:, :, comp], bl_g[:, :, comp])

            def s_p1(comp):
                # 16x8 bottom: A = left MB's br cell, B = own part0;
                # 8x16 right and q1: A = own part0 / q0, B = top MB's br
                tbr = torch.where(av_t, top(br_g[:, :, comp]), 0).reshape(n)
                own = a0[:, comp]
                return torch.where(ptype == 1, lbr(comp) + own, own + tbr)

            emit_mvd(mvd0, s_p0, on0)
            emit_mvd(mvd1, s_p1, on1)
            if p8x8_mode:
                # q2: A = left MB's br cell, B = own q0; q3: A = q2, B = q1
                emit_mvd(mvdq[:, 2], lambda comp: lbr(comp) + a0[:, comp],
                         onq)
                emit_mvd(mvdq[:, 3], lambda comp: a2[:, comp] + a1[:, comp],
                         onq)
        else:
            a0_g = a0.reshape(hm, wm, 2)
            emit_mvd(mvd0, lambda comp: nb_sum(a0_g[:, :, comp],
                                               a0_g[:, :, comp]), on0)

    # ---- coded_block_pattern ----
    on_cbp = coded & ~sel16

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
    cc_nz = (cbp_c_g != 0).to(I32)
    cc_2 = (cbp_c_g == 2).to(I32)
    grid.ctx_bin(77 + torch.where(av_l, left(cc_nz), 0).reshape(n)
                 + 2 * torch.where(av_t, top(cc_nz), 0).reshape(n),
                 (cc != 0).to(I32), on_cbp)
    grid.ctx_bin(81 + torch.where(av_l, left(cc_2), 0).reshape(n)
                 + 2 * torch.where(av_t, top(cc_2), 0).reshape(n),
                 torch.clamp(cc - 1, min=0), on_cbp & (cc != 0))

    if t8_mode:
        # transform_size_8x8_flag: inter MBs with a luma residual
        grid.ctx_bin(399 + t8_inc, t8v.to(I32),
                     coded & is_inter & (cbp_luma > 0))

    # ---- mb_qp_delta (always 0 in this encoder) ----
    grid.ctx_bin(60, 0, coded & (sel16 | (cbp > 0)))

    # ---- residual blocks; an unavailable neighbour counts as coded for
    # an intra MB and as not coded for an inter one ----
    ic = intra_cur.to(I32)
    cbf_ldc = (sel16 & coded & (luma_dc != 0).any(dim=1)).reshape(hm, wm)
    l4_i16 = (luma_ac[:, :, 1:] != 0).any(dim=2) & (cbp_luma > 0)[:, None]
    bit_of_idx = torch.arange(16, dtype=I32, device=dev) // 4
    bit8 = ((cbp_luma[:, None] >> bit_of_idx[None, :]) & 1) > 0
    l4_reg = (luma_ac != 0).any(dim=2) & bit8
    l4 = torch.where(sel16[:, None], l4_i16, l4_reg) & coded[:, None]
    # a t8 MB's 4x4 coded_block_flag neighbours take its cbp bits
    l4 = torch.where(t8v[:, None], bit8, l4)
    cbf_l4_g = torch.zeros((hm * 4, wm * 4), dtype=I32, device=dev)
    cbf_l4_g[g_rows, g_cols] = l4.to(I32)
    cbf_cdc_g = torch.zeros((2, hm, wm), dtype=I32, device=dev)
    cbf_cac_g = torch.zeros((2, hm * 2, wm * 2), dtype=I32, device=dev)
    for comp in range(2):
        cbf_cdc_g[comp] = ((chroma_dc[:, comp] != 0).any(dim=1)
                           & (cbp_chroma >= 1) & coded).reshape(hm, wm) \
            .to(I32)
        cac_nz = (chroma_ac[:, comp, :, 1:] != 0).any(dim=2) \
            & ((cbp_chroma == 2) & coded)[:, None]
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
                    85 + CBF_CAT_OFF[0] + ca + 2 * cb, coded & sel16,
                    cdc_inc=False)

    # 16 luma blocks (a t8 MB's come in its 8x8 groups below)
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
            ca = torch.where(av_l_flat, ca, ic)
        if by == 0:
            cb = torch.where(av_t_flat, cb, ic)
        coded_blk = coded & ~t8v & (
            (sel16 & (cbp_luma > 0))
            | (~sel16 & (((cbp_luma >> (idx // 4)) & 1) > 0)))
        _residual_group(grid, lac16[:, idx], mc_l, sig_b, last_b, lvl_b,
                        85 + cbf_off + ca + 2 * cb, coded_blk,
                        cdc_inc=False)

    if t8_mode:
        # cat-5 8x8 residual of t8 MBs: the pseudo 4x4 blocks of the CAVLC
        # interleave back into the 8x8 scan (block i, coefficient k ->
        # position 4k + i)
        scan64 = luma_ac.reshape(n, 4, 4, 16).transpose(2, 3) \
            .reshape(n, 4, 64)
        for b8 in range(4):
            _residual_group8(grid, scan64[:, b8],
                             t8v & (((cbp_luma >> b8) & 1) > 0))

    # chroma DC (cat 3)
    ic2 = ic.reshape(hm, wm)
    for comp in range(2):
        v_l = torch.where(left(cbp_c_g) != 0, left(cbf_cdc_g[comp]), 0)
        v_t = torch.where(top(cbp_c_g) != 0, top(cbf_cdc_g[comp]), 0)
        ca = torch.where(av_l, v_l, ic2).reshape(n)
        cb = torch.where(av_t, v_t, ic2).reshape(n)
        cdc16 = torch.cat([chroma_dc[:, comp],
                           torch.zeros((n, 12), dtype=I32, device=dev)], 1)
        _residual_group(grid, cdc16, 4,
                        105 + SIG_CAT_OFF[3], 166 + SIG_CAT_OFF[3],
                        227 + LVL_CAT_OFF[3],
                        85 + CBF_CAT_OFF[3] + ca + 2 * cb,
                        coded & (cbp_chroma >= 1), cdc_inc=True)

    # chroma AC (cat 4)
    zero1 = torch.zeros((n, 1), dtype=I32, device=dev)
    for comp in range(2):
        for idx in range(4):
            by, bx = idx // 2, idx % 2
            g2r, g2c = mb_r * 2 + by, mb_c * 2 + bx
            ca = cbf_cac_g[comp, g2r, np.maximum(g2c - 1, 0)]
            cb = cbf_cac_g[comp, np.maximum(g2r - 1, 0), g2c]
            if bx == 0:
                ca = torch.where(av_l_flat, ca, ic)
            if by == 0:
                cb = torch.where(av_t_flat, cb, ic)
            cac16 = torch.cat([chroma_ac[:, comp, idx, 1:], zero1], 1)
            _residual_group(grid, cac16, 15,
                            105 + SIG_CAT_OFF[4], 166 + SIG_CAT_OFF[4],
                            227 + LVL_CAT_OFF[4],
                            85 + CBF_CAT_OFF[4] + ca + 2 * cb,
                            coded & (cbp_chroma == 2), cdc_inc=False)

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

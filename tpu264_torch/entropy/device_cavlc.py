"""On-device CAVLC serialization + bit packing (torch), and the per-MB
syntax helpers shared by the CABAC binarizer and the deblocker.

Counterpart of `tpu264.entropy.device_cavlc` for I slices and for P slices
without partitions, P_8x8 or the 8x8 transform: per-block token/length
computation is parallel over blocks, packing is a prefix sum plus a
scatter-add, so only the packed slice payloads cross to the host.  Every
function mirrors its reference twin bit for bit; the tests hold them to
each other on random blocks and on whole frames.

Codes are kept in int32 (every code is below 2^31) and packed in int64
masked to 32 bits, where the reference uses uint32.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu264_torch.bits.expgolomb import write_ue
from tpu264_torch.coding import mvpred
from tpu264_torch.coding.wavefront import BLK_ORDER
from tpu264_torch.kernels.transform import on
from . import cavlc_tables as tbl
from . import mb_syntax
from .cavlc import SLOTS_PER_BLOCK
from .slice_writer import (HDR_SLOTS, HDR_SLOTS_P,  # noqa: F401
                           MB_SLOTS, MB_SLOTS_P, RES_BLOCKS)

I32 = torch.int32
_BY = torch.as_tensor([by for by, _ in BLK_ORDER])
_BX = torch.as_tensor([bx for _, bx in BLK_ORDER])


def blk_grid_index(wm: int, hm: int, device):
    """(rows, cols) [n, 16] of each MB's 4x4 blocks (zig-zag index) in the
    [4hm, 4wm] block grid."""
    n = wm * hm
    mb = torch.arange(n, device=device)
    rows = (mb // wm)[:, None] * 4 + _BY.to(device)[None, :]
    cols = (mb % wm)[:, None] * 4 + _BX.to(device)[None, :]
    return rows, cols


def luma_tc_grid(mb, cbp_luma, wm: int, hm: int):
    """[h4, w4] per-4x4 TotalCoeff grid (mirror of mb_syntax.luma_tc_grid);
    also feeds deblock bS derivation on device."""
    luma_ac = mb["luma_ac"]
    dev = luma_ac.device
    tc = (luma_ac != 0).sum(2, dtype=I32)
    coded8 = ((cbp_luma[:, None] >> torch.arange(4, dtype=I32, device=dev)
               [None, :]) & 1) > 0
    coded = coded8.repeat_interleave(4, dim=1)
    tc = torch.where(coded, tc, 0)
    lgrid = torch.zeros((hm * 4, wm * 4), dtype=I32, device=dev)
    rows, cols = blk_grid_index(wm, hm, dev)
    lgrid[rows, cols] = tc
    return lgrid


def mpm_grid(modes_grid, slice_start_rows4):
    """Most probable I4x4 mode per 4x4 block (spec 8.3.1.1) from the
    [4hm, 4wm] mode grid (-1 = not I4x4); slice tops are unavailable."""
    gh, gw = modes_grid.shape
    dev = modes_grid.device
    unavail = -2
    left = torch.full((gh, gw), unavail, dtype=I32, device=dev)
    left[:, 1:] = modes_grid[:, :-1]
    top = torch.full((gh, gw), unavail, dtype=I32, device=dev)
    top[1:, :] = modes_grid[:-1, :]
    mask = np.zeros((gh, 1), dtype=bool)
    for r in slice_start_rows4:
        mask[r] = True
    top = torch.where(torch.as_tensor(mask, device=dev), unavail, top)
    a = torch.where(left == -1, 2, left)
    b = torch.where(top == -1, 2, top)
    return torch.where((a < 0) | (b < 0), 2, torch.minimum(a, b))


def compute_cbp(sel16, luma_ac, chroma_dc, chroma_ac):
    """(cbp_luma, cbp_chroma, cbp) [n] int32 per MB."""
    n = luma_ac.shape[0]
    dev = luma_ac.device
    nz_blk = (luma_ac != 0).any(dim=2)
    nz8 = nz_blk.reshape(n, 4, 4).any(dim=2)
    cbp_luma = (nz8.to(I32) << torch.arange(4, dtype=I32, device=dev)
                [None, :]).sum(1, dtype=I32)
    cbp_luma = torch.where(sel16 & (cbp_luma > 0), 15, cbp_luma)
    any_dc = (chroma_dc != 0).reshape(n, -1).any(dim=1)
    any_ac = (chroma_ac != 0).reshape(n, -1).any(dim=1)
    cbp_chroma = torch.where(any_ac, 2, torch.where(any_dc, 1, 0)).to(I32)
    return cbp_luma, cbp_chroma, cbp_luma | (cbp_chroma << 4)


# ---------------------------------------------------------------- tables
_T = {
    name: torch.as_tensor(np.asarray(arr, dtype=np.int32))
    for name, arr in {
        "ctb": tbl.COEFF_TOKEN_BITS, "ctl": tbl.COEFF_TOKEN_LEN,
        "cctb": tbl.CDC_COEFF_TOKEN_BITS, "cctl": tbl.CDC_COEFF_TOKEN_LEN,
        "ctzb": tbl.CDC_TOTAL_ZEROS_BITS, "ctzl": tbl.CDC_TOTAL_ZEROS_LEN,
        "tzb": tbl.TOTAL_ZEROS_BITS, "tzl": tbl.TOTAL_ZEROS_LEN,
        "rbb": tbl.RUN_BEFORE_BITS, "rbl": tbl.RUN_BEFORE_LEN,
        "cbpi": mb_syntax.CBP_TO_CODENUM_INTRA,
        "cbpp": mb_syntax.CBP_TO_CODENUM_INTER,
    }.items()
}


def _tab(name, device):
    return on(_T[name], device)


def bit_length_minus1(t: torch.Tensor) -> torch.Tensor:
    """floor(log2(t)) for integer t >= 1, exact: a 5-step binary search on
    shifts.  Where the reference takes floor(log2(float32(t))), the XLA
    CPU backend is one low at t = 2^13 and 2^15; the values an 8-bit
    encode produces (CABAC escapes, mv differences) stay below 6600,
    where the two agree."""
    m = torch.zeros_like(t)
    for s in (16, 8, 4, 2, 1):
        m = m + s * ((t >> (m + s)) > 0).to(t.dtype)
    return m


def ue_code(v):
    """ue(v) -> (code, nbits), int32; v < 2^31 - 1."""
    vp1 = (v + 1).to(I32)
    return vp1, 2 * bit_length_minus1(vp1) + 1


def se_to_ue(v):
    return torch.where(v > 0, 2 * v - 1, -2 * v)


def _encode_level(lc, sl):
    """Fused level prefix+suffix (mirror of cavlc._encode_level)."""
    c0_short = lc < 14
    code0 = torch.where(c0_short, 1, 0)
    len0 = torch.where(c0_short, lc + 1, 0)
    c0_esc14 = (lc >= 14) & (lc < 30)
    code0 = torch.where(c0_esc14, (1 << 4) | (lc - 14), code0)
    len0 = torch.where(c0_esc14, 15 + 4, len0)
    c0_esc15 = lc >= 30
    code0 = torch.where(c0_esc15, (1 << 12) | (lc - 30), code0)
    len0 = torch.where(c0_esc15, 16 + 12, len0)

    sl1 = torch.clamp(sl, min=1)
    prefix = lc >> sl1
    suffix = lc & ((1 << sl1) - 1)
    cs_short = prefix < 15
    code1 = torch.where(cs_short, (1 << sl1) | suffix, 0)
    len1 = torch.where(cs_short, prefix + 1 + sl1, 0)
    cs_esc = prefix >= 15
    esc_val = lc - (15 << sl1)
    code1 = torch.where(cs_esc, (1 << 12) | esc_val, code1)
    len1 = torch.where(cs_esc, 16 + 12, len1)

    code = torch.where(sl == 0, code0, code1)
    ln = torch.where(sl == 0, len0, len1)
    return code, ln


def encode_blocks(scanned, nc, max_coeff: int):
    """Mirror of `encode_blocks_j` (and of cavlc.encode_blocks).

    scanned [N, mc] int32 scan-order levels; nc [N] int32 (-1 = chroma DC).
    Returns (values [N,36] int32, lengths [N,36] int32).
    """
    scanned = scanned.to(I32)
    n, mc = scanned.shape
    assert mc == max_coeff
    dev = scanned.device
    nc = nc.to(I32).expand(n)

    nz = scanned != 0
    total_coeff = nz.sum(1, dtype=I32)
    # k-th nonzero from the end: rev_rank[i] = #nonzeros at positions >= i,
    # so the nonzero at i is the (rev_rank[i] - 1)-th in reverse order.  It
    # is scattered to that column (the reference picks it with a one-hot
    # [N, mc, mc] product); zeros go to a trash column.
    rev_rank = nz.to(I32).flip(1).cumsum(1).flip(1)            # [N, mc]
    dest = torch.where(nz, rev_rank - 1, mc).long()
    lev = torch.zeros((n, mc + 1), dtype=I32, device=dev)
    lev.scatter_(1, dest, scanned)
    lev = lev[:, :mc]
    lev_idx = torch.full((n, mc + 1), -1, dtype=I32, device=dev)
    lev_idx.scatter_(1, dest, torch.arange(mc, dtype=I32, device=dev)
                     .expand(n, mc))
    lev_idx = lev_idx[:, :mc]
    karange = torch.arange(mc, dtype=I32, device=dev)[None, :]
    valid = karange < total_coeff[:, None]

    is_one = (lev.abs() == 1) & valid
    run1 = torch.cumprod(is_one[:, :3].to(I32), dim=1)
    t1 = run1.sum(1, dtype=I32)

    vals = [None] * SLOTS_PER_BLOCK
    lens = [None] * SLOTS_PER_BLOCK
    zero = torch.zeros(n, dtype=I32, device=dev)

    # coeff_token
    ct_idx = (4 * total_coeff + t1).long()
    tsel = torch.where(nc < 2, 0, torch.where(nc < 4, 1,
                                              torch.where(nc < 8, 2, 3)))
    is_cdc = nc == -1
    tsel0 = torch.where(is_cdc, 0, tsel).long()
    reg_bits = _tab("ctb", dev)[tsel0, ct_idx]
    reg_len = _tab("ctl", dev)[tsel0, ct_idx]
    cdc_idx = torch.clamp(ct_idx, max=19)
    cdc_bits = _tab("cctb", dev)[cdc_idx]
    cdc_len = _tab("cctl", dev)[cdc_idx]
    vals[0] = torch.where(is_cdc, cdc_bits, reg_bits)
    lens[0] = torch.where(is_cdc, cdc_len, reg_len)

    # trailing one signs
    for k in range(3):
        on_k = k < t1
        vals[1 + k] = torch.where(on_k, (lev[:, k] < 0).to(I32), 0)
        lens[1 + k] = on_k.to(I32)

    # levels
    sl = ((total_coeff > 10) & (t1 < 3)).to(I32)
    first_coded = t1
    for k in range(16):
        if k >= mc:
            vals[4 + k] = zero
            lens[4 + k] = zero
            continue
        on_k = (k >= t1) & (k < total_coeff)
        v = lev[:, k]
        absv = v.abs()
        level_code = torch.where(v > 0, 2 * absv - 2, 2 * absv - 1)
        level_code = torch.where(on_k & (k == first_coded) & (t1 < 3),
                                 level_code - 2, level_code)
        code, ln = _encode_level(level_code, sl)
        vals[4 + k] = torch.where(on_k, code, 0)
        lens[4 + k] = torch.where(on_k, ln, 0)
        sl_new = torch.where(sl == 0, 1, sl)
        sl_new = torch.where(
            (absv > (3 << torch.clamp(sl_new - 1, min=0))) & (sl_new < 6),
            sl_new + 1, sl_new)
        sl = torch.where(on_k, sl_new, sl)

    # total_zeros
    highest = lev_idx[:, 0]
    total_zeros = torch.where(total_coeff > 0, highest + 1 - total_coeff, 0)
    tz_on = (total_coeff > 0) & (total_coeff < max_coeff)
    tz_row = torch.clamp(total_coeff - 1, 0, 15).long()
    tz_col = torch.clamp(total_zeros, 0, 15).long()
    if max_coeff == 4:
        r3 = torch.clamp(tz_row, 0, 2)
        c3 = torch.clamp(tz_col, 0, 3)
        tzb = _tab("ctzb", dev)[r3, c3]
        tzl = _tab("ctzl", dev)[r3, c3]
    else:
        tzb = _tab("tzb", dev)[tz_row, tz_col]
        tzl = _tab("tzl", dev)[tz_row, tz_col]
    vals[20] = torch.where(tz_on, tzb, 0)
    lens[20] = torch.where(tz_on, tzl, 0)

    # run_before
    zeros_left = total_zeros
    for k in range(15):
        if k + 1 >= mc:
            vals[21 + k] = zero
            lens[21 + k] = zero
            continue
        on_k = (k < total_coeff - 1) & (zeros_left > 0)
        run = torch.where(on_k, lev_idx[:, k] - lev_idx[:, k + 1] - 1, 0)
        row = torch.clamp(torch.clamp(zeros_left, max=7) - 1, 0, 6).long()
        col = torch.clamp(run, 0, 15).long()
        vals[21 + k] = torch.where(on_k, _tab("rbb", dev)[row, col], 0)
        lens[21 + k] = torch.where(on_k, _tab("rbl", dev)[row, col], 0)
        zeros_left = zeros_left - run
    return (torch.stack([v.to(I32) for v in vals], dim=1),
            torch.stack([v.to(I32) for v in lens], dim=1))


# ----------------------------------------------------------- nC grids

def _nc_from_grid(tc_grid, slice_start_rows):
    gh, gw = tc_grid.shape
    na = torch.zeros_like(tc_grid)
    na[:, 1:] = tc_grid[:, :-1]
    nb = torch.zeros_like(tc_grid)
    nb[1:, :] = tc_grid[:-1, :]
    avail_a = np.zeros((gh, gw), dtype=bool)
    avail_a[:, 1:] = True
    avail_b = np.zeros((gh, gw), dtype=bool)
    avail_b[1:, :] = True
    for r in slice_start_rows:
        avail_b[r, :] = False
    avail_a = torch.as_tensor(avail_a, device=tc_grid.device)
    avail_b = torch.as_tensor(avail_b, device=tc_grid.device)
    return torch.where(avail_a & avail_b, (na + nb + 1) >> 1,
                       torch.where(avail_a, na, torch.where(avail_b, nb, 0)))


def _tc_grids(mb, cbp_luma, cbp_chroma, wm: int, hm: int, slice_rows):
    """luma/chroma nC grids (mirror of mb_syntax.luma_tc_grid /
    chroma_tc_grid / nc_from_grid)."""
    n = wm * hm
    dev = cbp_luma.device
    idx = torch.arange(n, device=dev)
    mb_r, mb_c = idx // wm, idx % wm
    lgrid = luma_tc_grid(mb, cbp_luma, wm, hm)
    lnc = _nc_from_grid(lgrid, [r * 4 for r in slice_rows])

    cnc = []
    for comp in range(2):
        ctc = (mb["chroma_ac"][:, comp] != 0).sum(2, dtype=I32)
        ctc = torch.where((cbp_chroma == 2)[:, None], ctc, 0)
        cgrid = torch.zeros((hm * 2, wm * 2), dtype=I32, device=dev)
        for k in range(4):
            cgrid[mb_r * 2 + k // 2, mb_c * 2 + k % 2] = ctc[:, k]
        cnc.append(_nc_from_grid(cgrid, [r * 2 for r in slice_rows]))
    return lnc, cnc


# ------------------------------------------------------------ frame grids

def _residual_slots(mb, sel16, cbp_luma, cbp_chroma, wm, hm, slice_rows):
    """The 27 residual blocks of every MB (I16 DC, 16 luma, 2 chroma DC,
    8 chroma AC) -> (values, lengths) [n, 27 * SLOTS_PER_BLOCK]; an
    uncoded block's slots are 0 (mirror of `_residual_slots_j`)."""
    n = wm * hm
    dev = cbp_luma.device
    idx = torch.arange(n, device=dev)
    mb_r, mb_c = idx // wm, idx % wm
    luma_ac = mb["luma_ac"].to(I32)
    lnc, cnc = _tc_grids(mb, cbp_luma, cbp_chroma, wm, hm, slice_rows)
    rows, cols = blk_grid_index(wm, hm, dev)
    luma_nc = lnc[rows, cols].T                                  # [16, n]

    # all blocks of one length go through one encode_blocks call
    # 16-coeff group: I16 DC + the 16 luma blocks (non-I16 variant)
    g16_in = torch.cat([mb["luma_dc"].to(I32)[None],
                        luma_ac.permute(1, 0, 2)], dim=0)        # [17, n, 16]
    g16_nc = torch.cat([lnc[mb_r * 4, mb_c * 4][None], luma_nc], dim=0)
    v16, l16 = encode_blocks(g16_in.reshape(17 * n, 16),
                             g16_nc.reshape(17 * n), 16)
    v16 = v16.reshape(17, n, SLOTS_PER_BLOCK)
    l16 = l16.reshape(17, n, SLOTS_PER_BLOCK)

    # 15-coeff group: 16 luma AC (I16 variant) + 8 chroma AC blocks
    cac = mb["chroma_ac"].to(I32)
    g15_in = torch.cat([luma_ac[:, :, 1:].permute(1, 0, 2),
                        cac[..., 1:].reshape(n, 8, 15).permute(1, 0, 2)],
                       dim=0)
    c_nc = torch.stack(
        [cnc[comp][mb_r * 2 + k // 2, mb_c * 2 + k % 2]
         for comp in range(2) for k in range(4)], dim=0)
    g15_nc = torch.cat([luma_nc, c_nc], dim=0)
    v15, l15 = encode_blocks(g15_in.reshape(24 * n, 15),
                             g15_nc.reshape(24 * n), 15)
    v15 = v15.reshape(24, n, SLOTS_PER_BLOCK)
    l15 = l15.reshape(24, n, SLOTS_PER_BLOCK)

    # chroma DC group
    vcd, lcd = encode_blocks(
        mb["chroma_dc"].to(I32).permute(1, 0, 2).reshape(2 * n, 4),
        torch.full((2 * n,), -1, dtype=I32, device=dev), 4)
    vcd = vcd.reshape(2, n, SLOTS_PER_BLOCK)
    lcd = lcd.reshape(2, n, SLOTS_PER_BLOCK)

    s16 = sel16[None, :, None]
    coded8 = ((cbp_luma[None, :] >> (torch.arange(16, device=dev) // 4)
               [:, None]) & 1) > 0                               # [16, n]
    coded = torch.cat([sel16[None], coded8,
                       (cbp_chroma >= 1)[None].expand(2, n),
                       (cbp_chroma == 2)[None].expand(8, n)], dim=0)
    out = []
    for a16, a15, acd in ((v16, v15, vcd), (l16, l15, lcd)):
        blocks = torch.cat([a16[:1], torch.where(s16, a15[:16], a16[1:]),
                            acd, a15[16:]], dim=0)               # [27, n, 36]
        blocks = torch.where(coded[..., None], blocks, 0)
        out.append(blocks.permute(1, 0, 2).reshape(
            n, RES_BLOCKS * SLOTS_PER_BLOCK))
    return out[0], out[1]


def _i4_mode_slots(vals, lens, slot0, mb, is_i4, wm, hm, slice_rows):
    dev = is_i4.device
    modes = mb["modes"].to(I32)
    rows, cols = blk_grid_index(wm, hm, dev)
    modes_grid = torch.full((hm * 4, wm * 4), -1, dtype=I32, device=dev)
    modes_grid[rows, cols] = torch.where(is_i4[:, None], modes, -1)
    mpm = mpm_grid(modes_grid, [r * 4 for r in slice_rows])[rows, cols]
    is_mpm = modes == mpm
    rem = modes - (modes > mpm).to(I32)
    v = torch.where(is_mpm, 1, rem)
    ln = torch.where(is_i4[:, None], torch.where(is_mpm, 1, 4), 0)
    for k in range(16):
        vals[slot0 + k] = v[:, k]
        lens[slot0 + k] = ln[:, k]


def _reject_unported(mb):
    for key, item in (("ptype", "16x8/8x16 partitions"), ("mvq", "P_8x8"),
                      ("t8", "the 8x8 transform")):
        if key in mb:
            raise NotImplementedError(
                f"CAVLC serializer: MB dict carries {key!r}; {item} is not "
                "ported yet (ROADMAP Queue 1: default IPPP tools)")


def serialize_frame(mb, wm: int, hm: int, slice_rows):
    """I-frame grids (mirror of `serialize_frame_j` without the 8x8
    transform's flag slot, and of slice_writer.serialize_frame_mbs).
    Returns (values [n, MB_SLOTS] int32, lengths [n, MB_SLOTS] int32)."""
    _reject_unported(mb)
    n = wm * hm
    sel16 = mb["sel16"].to(torch.bool)
    dev = sel16.device
    zero = torch.zeros(n, dtype=I32, device=dev)
    vals = [zero] * HDR_SLOTS
    lens = [zero] * HDR_SLOTS
    cbp_luma, cbp_chroma, cbp = compute_cbp(
        sel16, mb["luma_ac"], mb["chroma_dc"], mb["chroma_ac"])

    mbt = torch.where(sel16, 1 + mb["i16mode"].to(I32) + 4 * cbp_chroma
                      + 12 * (cbp_luma > 0), 0)
    vals[0], lens[0] = ue_code(mbt)

    _i4_mode_slots(vals, lens, 1, mb, ~sel16, wm, hm, slice_rows)

    vals[17], lens[17] = ue_code(mb["cmode"].to(I32))

    cbp_code, cbp_len = ue_code(_tab("cbpi", dev)[cbp.long()])
    vals[18] = torch.where(~sel16, cbp_code, 0)
    lens[18] = torch.where(~sel16, cbp_len, 0)

    has_delta = (sel16 | (cbp > 0)).to(I32)       # ue(se_to_ue(0)) = '1'
    vals[19] = has_delta
    lens[19] = has_delta

    rv, rl = _residual_slots(mb, sel16, cbp_luma, cbp_chroma, wm, hm,
                             slice_rows)
    return (torch.cat([torch.stack(vals, dim=1), rv], dim=1),
            torch.cat([torch.stack(lens, dim=1), rl], dim=1))


def _neighbor_mvs(mv_map, ref_map, wm, hm, slice_rows):
    """Shifted-array port of mvpred.neighbor_mvs_np."""
    UN = mvpred.UNAVAIL
    dev = mv_map.device

    def z2():
        return torch.zeros((hm, wm, 2), dtype=I32, device=dev)

    def un():
        return torch.full((hm, wm), UN, dtype=I32, device=dev)

    mv_a, ref_a, mv_b, ref_b, mv_c, ref_c = z2(), un(), z2(), un(), z2(), un()
    mv_a[:, 1:] = mv_map[:, :-1]
    ref_a[:, 1:] = ref_map[:, :-1]
    mv_b[1:, :] = mv_map[:-1, :]
    ref_b[1:, :] = ref_map[:-1, :]
    # C = top-right with D (top-left) substitution at the last column
    mv_c[1:, :-1] = mv_map[:-1, 1:]
    ref_c[1:, :-1] = ref_map[:-1, 1:]
    if wm > 1:
        mv_c[1:, wm - 1] = mv_map[:-1, wm - 2]
        ref_c[1:, wm - 1] = ref_map[:-1, wm - 2]
    # slice starts: top row neighbors unavailable
    mask = np.zeros((hm, 1), dtype=bool)
    for r in slice_rows:
        mask[int(r)] = True
    mask = torch.as_tensor(mask, device=dev)
    ref_b = torch.where(mask, UN, ref_b)
    ref_c = torch.where(mask, UN, ref_c)
    mv_b = torch.where(mask[..., None], 0, mv_b)
    mv_c = torch.where(mask[..., None], 0, mv_c)
    n = wm * hm
    return {k: v.reshape((n,) + tuple(v.shape[2:])) for k, v in
            dict(mv_a=mv_a, ref_a=ref_a, mv_b=mv_b, ref_b=ref_b,
                 mv_c=mv_c, ref_c=ref_c).items()}


def serialize_frame_p(mb, wm: int, hm: int, slice_rows):
    """P-frame grids for MBs without partitions (mirror of
    `serialize_frame_p_j` in that case, and of
    slice_writer.serialize_frame_mbs_p).  An MB dict that carries "ptype",
    "mvq" or "t8" raises.  Returns (values [n, MB_SLOTS_P], lengths,
    skipped [n] bool)."""
    _reject_unported(mb)
    n = wm * hm
    is_inter = mb["is_inter"].to(torch.bool)
    dev = is_inter.device
    sel16 = mb["sel16"].to(torch.bool) & ~is_inter
    zero = torch.zeros(n, dtype=I32, device=dev)
    vals = [zero] * HDR_SLOTS_P
    lens = [zero] * HDR_SLOTS_P
    cbp_luma, cbp_chroma, cbp = compute_cbp(
        sel16, mb["luma_ac"], mb["chroma_dc"], mb["chroma_ac"])

    mv = mb["mv"].to(I32)
    mv_map = torch.where(is_inter[:, None], mv, 0).reshape(hm, wm, 2)
    ref_map = torch.where(is_inter, 0, mvpred.INTRA).to(I32).reshape(hm, wm)
    nb = _neighbor_mvs(mv_map, ref_map, wm, hm, slice_rows)
    mv_pred = mvpred.predict_mv(nb["mv_a"], nb["ref_a"], nb["mv_b"],
                                nb["ref_b"], nb["mv_c"], nb["ref_c"])
    mvd = mv - mv_pred

    mv_skip = mb["mv_skip"].to(I32)
    skipped = is_inter & (mv == mv_skip).all(dim=1) & (cbp == 0)

    # mb_skip_run per coded MB: distance to previous coded MB in the slice
    pos = torch.arange(n, dtype=I32, device=dev)
    slice_first = np.zeros(n, dtype=np.int32)
    rows = [int(r) for r in slice_rows] + [hm]
    for s in range(len(rows) - 1):
        slice_first[rows[s] * wm: rows[s + 1] * wm] = rows[s] * wm
    slice_first = torch.as_tensor(slice_first, device=dev)
    coded = ~skipped
    coded_pos = torch.where(coded, pos, -1)
    prev_coded = torch.cummax(coded_pos, dim=0).values
    prev_excl = torch.cat([torch.full((1,), -1, dtype=I32, device=dev),
                           prev_coded[:-1]])
    prev_excl = torch.maximum(prev_excl, slice_first - 1)
    src, srl = ue_code(pos - prev_excl - 1)
    vals[0] = torch.where(coded, src, 0)
    lens[0] = torch.where(coded, srl, 0)

    mbt_intra = 5 + torch.where(sel16, 1 + mb["i16mode"].to(I32)
                                + 4 * cbp_chroma + 12 * (cbp_luma > 0), 0)
    tc_, tl_ = ue_code(torch.where(is_inter, 0, mbt_intra))
    vals[1] = torch.where(coded, tc_, 0)
    lens[1] = torch.where(coded, tl_, 0)

    is_i4 = coded & ~is_inter & ~sel16
    inter_coded = coded & is_inter
    _i4_mode_slots(vals, lens, 2, mb, is_i4, wm, hm, slice_rows)

    cmc, cml = ue_code(mb["cmode"].to(I32))
    intra_coded = coded & ~is_inter
    vals[18] = torch.where(intra_coded, cmc, 0)
    lens[18] = torch.where(intra_coded, cml, 0)

    for k, comp in ((19, 1), (20, 0)):
        code, ln = ue_code(se_to_ue(mvd[:, comp]))
        vals[k] = torch.where(inter_coded, code, 0)
        lens[k] = torch.where(inter_coded, ln, 0)

    ci, li_ = ue_code(_tab("cbpi", dev)[cbp.long()])
    cp, lp_ = ue_code(_tab("cbpp", dev)[cbp.long()])
    vals[21] = torch.where(inter_coded, cp, torch.where(is_i4, ci, 0))
    lens[21] = torch.where(inter_coded, lp_, torch.where(is_i4, li_, 0))

    has_delta = (coded & (sel16 | (cbp > 0))).to(I32)
    vals[22] = has_delta
    lens[22] = has_delta

    rv, rl = _residual_slots(mb, sel16, cbp_luma, cbp_chroma, wm, hm,
                             slice_rows)
    return (torch.cat([torch.stack(vals, dim=1), rv], dim=1),
            torch.cat([torch.stack(lens, dim=1), rl], dim=1), skipped)


# ---------------------------------------------------------------- packing

def pack_slices(values, lengths, n_slices: int, cap_words: int):
    """Pack per-slice element grids into 32-bit word streams on device.

    values/lengths: [n_mbs, slots] int32 (codes < 2^31, lengths <= 31).
    The n_mbs axis is split into `n_slices` equal segments; each packs
    from bit 0 of its own word buffer.  Bits past `cap_words` are dropped.

    Returns (words [n_slices, cap_words] int64 holding 32-bit words,
    big-endian bit order; nbits [n_slices] int64).
    """
    n, slots = values.shape
    per = n // n_slices
    v = values.reshape(n_slices, per * slots).to(torch.int64)
    ln = lengths.reshape(n_slices, per * slots).to(torch.int64)
    starts = ln.cumsum(1) - ln
    nbits = starts[:, -1] + ln[:, -1]
    off = starts & 31
    w = starts >> 5
    # MSB-first split across two words: word w takes the code's top
    # `take = min(len, 32-off)` bits, word w+1 the remaining `len-take`
    take = torch.minimum(ln, 32 - off)
    rem = ln - take                                      # bits in word w+1
    hi = ((v >> rem) << (32 - off - take)) & 0xFFFFFFFF
    lo = ((v & ((1 << rem) - 1)) << (32 - rem)) & 0xFFFFFFFF
    hi = torch.where(ln > 0, hi, 0)
    lo = torch.where(rem > 0, lo, 0)
    # disjoint bit ranges -> add == or; column cap_words takes what the
    # reference's scatter drops
    words = torch.zeros((n_slices, cap_words + 1), dtype=torch.int64,
                        device=values.device)
    words.scatter_add_(1, torch.clamp(w, max=cap_words), hi)
    words.scatter_add_(1, torch.clamp(w + 1, max=cap_words), lo)
    return words[:, :cap_words], nbits


def words_to_rbsp(words: np.ndarray, nbits: int, header_sink,
                  final_skip_run: int | None = None) -> bytes:
    """Merge host-written slice-header bits with a device-packed body.

    `header_sink` is the BitSink holding the slice header; the body
    (words/nbits) is appended at the current bit position, an optional
    trailing mb_skip_run is emitted, then rbsp_trailing_bits closes the
    RBSP (mirror of slice_writer.pack_slice).
    """
    words = np.asarray(words).astype(np.uint32)
    # feed the body as 64-bit codes (one per pair of device words)
    nbits = int(nbits)
    n64 = nbits // 64
    if words.size % 2:
        words = np.concatenate([words, np.zeros(1, np.uint32)])
    w64 = (words[0::2].astype(np.uint64) << np.uint64(32)) \
        | words[1::2].astype(np.uint64)
    header_sink.put_array(w64[:n64], np.full(n64, 64, dtype=np.int64))
    rem = nbits - n64 * 64
    if rem:
        header_sink.put(int(w64[n64] >> np.uint64(64 - rem)), rem)
    if final_skip_run is not None and final_skip_run > 0:
        write_ue(header_sink, final_skip_run)
    header_sink.rbsp_trailing_bits()
    return header_sink.to_bytes()

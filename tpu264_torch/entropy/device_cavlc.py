"""CAVLC serialization + bit packing in eager torch, and the per-MB
syntax helpers shared by the CABAC binarizer and the deblocker.  The
serializers and the packer are the plain version of kernel KV
(`kernels/cavlc_slices.py`), which codes a CAVLC picture on the card.

Counterpart of `tpu264.entropy.device_cavlc` for I, P and B slices (with
the default P tools: partitions, P_8x8, the 8x8 transform; B 16x8 / 8x16
partitions): per-block token/length
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
from tpu264_torch.coding.b_mbtypes import COMBO_IDX
from tpu264_torch.coding.wavefront import BLK_ORDER
from tpu264_torch.kernels import mb_preds
from tpu264_torch.kernels.transform import constant, on
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
    rows = (mb // wm)[:, None] * 4 + on(_BY, device)[None, :]
    cols = (mb % wm)[:, None] * 4 + on(_BX, device)[None, :]
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
    rows = tuple(int(r) for r in slice_start_rows4)

    def mask():
        m = np.zeros((gh, 1), dtype=bool)
        m[list(rows)] = True
        return m

    top = torch.where(constant(("mpm", gh) + rows, dev, mask), unavail,
                      top)
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
    rows = tuple(int(r) for r in slice_start_rows)

    def avail(side):
        m = np.zeros((gh, gw), dtype=bool)
        if side == "a":
            m[:, 1:] = True
        else:
            m[1:, :] = True
            m[list(rows), :] = False
        return m

    avail_a, avail_b = (
        constant(("nc", side, gh, gw) + rows, tc_grid.device,
                   lambda side=side: avail(side)) for side in "ab")
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


def _i4_mode_slots(vals, lens, slot0, mb, is_i4, mpm):
    """The 16 prev_intra4x4_pred_mode / rem_intra4x4_pred_mode slots of
    the Intra4x4 MBs `is_i4`, from slot `slot0` on, against the most
    probable modes `mpm` [n, 16] (`mb_preds.preds`)."""
    modes = mb["modes"].to(I32)
    is_mpm = modes == mpm
    rem = modes - (modes > mpm).to(I32)
    v = torch.where(is_mpm, 1, rem)
    ln = torch.where(is_i4[:, None], torch.where(is_mpm, 1, 4), 0)
    for k in range(16):
        vals[slot0 + k] = v[:, k]
        lens[slot0 + k] = ln[:, k]


def serialize_frame(mb, wm: int, hm: int, slice_rows,
                    t8_mode: bool = False, frames: int = 1):
    """I-frame grids (mirror of `serialize_frame_j`, and of
    slice_writer.serialize_frame_mbs).  `t8_mode`: the PPS has
    transform_8x8_mode_flag set, so an Intra_4x4 MB carries a
    transform_size_8x8_flag bit (0) right after mb_type (spec 7.3.5).
    Returns (values [n, MB_SLOTS (+1)] int32, lengths).

    `frames` = F serializes a chunk of F pictures of one geometry at once
    (the reference vmaps `serialize_frame_j` over them): `mb` holds their
    MBs picture after picture, [F n, ...], and so do the results, whose
    F S slices `pack_slices` packs in one pass.  The pictures are coded as
    the MB rows of one picture F hm rows high whose slices start at every
    picture's slice rows: each picture's first row starts a slice, so no
    neighbour of the nC grids or of the most probable mode reaches across
    two pictures (a slice's top row has no top neighbour, and a left
    neighbour lies in the same row)."""
    # the most probable modes: kernel KD on the card (one launch for the
    # chunk), the plain helpers on the CPU
    _, mpm = mb_preds.preds(mb, wm, hm, slice_rows, "i", frames)
    slice_rows = [f * hm + int(r) for f in range(frames) for r in slice_rows]
    hm = frames * hm
    n = wm * hm
    ioff = int(t8_mode)
    sel16 = mb["sel16"].to(torch.bool)
    dev = sel16.device
    zero = torch.zeros(n, dtype=I32, device=dev)
    vals = [zero] * (HDR_SLOTS + ioff)
    lens = [zero] * (HDR_SLOTS + ioff)
    cbp_luma, cbp_chroma, cbp = compute_cbp(
        sel16, mb["luma_ac"], mb["chroma_dc"], mb["chroma_ac"])

    mbt = torch.where(sel16, 1 + mb["i16mode"].to(I32) + 4 * cbp_chroma
                      + 12 * (cbp_luma > 0), 0)
    vals[0], lens[0] = ue_code(mbt)
    if t8_mode:
        lens[1] = (~sel16).to(I32)              # the flag, 0 for I_NxN

    _i4_mode_slots(vals, lens, 1 + ioff, mb, ~sel16, mpm)

    vals[17 + ioff], lens[17 + ioff] = ue_code(mb["cmode"].to(I32))

    cbp_code, cbp_len = ue_code(_tab("cbpi", dev)[cbp.long()])
    vals[18 + ioff] = torch.where(~sel16, cbp_code, 0)
    lens[18 + ioff] = torch.where(~sel16, cbp_len, 0)

    has_delta = (sel16 | (cbp > 0)).to(I32)       # ue(se_to_ue(0)) = '1'
    vals[19 + ioff] = has_delta
    lens[19 + ioff] = has_delta

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
    mask = _slice_top_mask(hm, slice_rows, dev)
    ref_b = torch.where(mask, UN, ref_b)
    ref_c = torch.where(mask, UN, ref_c)
    mv_b = torch.where(mask[..., None], 0, mv_b)
    mv_c = torch.where(mask[..., None], 0, mv_c)
    n = wm * hm
    return {k: v.reshape((n,) + tuple(v.shape[2:])) for k, v in
            dict(mv_a=mv_a, ref_a=ref_a, mv_b=mv_b, ref_b=ref_b,
                 mv_c=mv_c, ref_c=ref_c).items()}


def mvd_16x16(mv, is_inter, wm: int, hm: int, slice_rows):
    """mv - its median prediction (spec 8.4.1.3) for MBs of one 16x16
    partition each; an intra MB is an INTRA neighbour -> [n, 2]."""
    mv_map = torch.where(is_inter[:, None], mv, 0).reshape(hm, wm, 2)
    ref_map = torch.where(is_inter, 0, mvpred.INTRA).to(I32).reshape(hm, wm)
    nb = _neighbor_mvs(mv_map, ref_map, wm, hm, slice_rows)
    return mv - mvpred.predict_mv(nb["mv_a"], nb["ref_a"], nb["mv_b"],
                                  nb["ref_b"], nb["mv_c"], nb["ref_c"])


def _slice_top_mask(hm: int, slice_rows, device):
    """[hm, 1] bool: the MB rows that start a slice (made once a device
    and slice layout)."""
    rows = tuple(int(r) for r in slice_rows)

    def make():
        mask = np.zeros((hm, 1), dtype=bool)
        mask[list(rows)] = True
        return mask
    return constant(("slice_top", hm) + rows, device, make)


def _cell_grids2(ptype, mv_p0, mv_p1, use_p0, use_p1, is_inter, wm: int,
                 hm: int, mvq=None):
    """Per-list boundary-cell grids with per-channel refs (mirror of
    `_cell_grids2_j`): (tr, ref_tr, bl, ref_bl, br, ref_br), mv grids
    [hm, wm, 2] and ref grids [hm, wm].  A cell covered by a partition that
    uses the list carries (mv, ref 0); by one that does not, or by an intra
    MB, (0, INTRA).  `mvq` [n, 4, 2]: P_8x8 quadrant mvs; on ptype 3 the
    cells are tr <- q1, bl <- q2, br <- q3."""
    out = []
    for sel2, qi in ((ptype == 2, 1), (ptype == 1, 2), (ptype > 0, 3)):
        m = torch.where(sel2[:, None], mv_p1, mv_p0)
        if mvq is not None:
            m = torch.where((ptype == 3)[:, None], mvq[:, qi], m)
        use = torch.where(sel2, use_p1, use_p0) & is_inter
        out.append(torch.where(use[:, None], m, 0).reshape(hm, wm, 2))
        out.append(torch.where(use, 0, mvpred.INTRA).to(I32).reshape(hm, wm))
    return tuple(out)


def _partition_mvds_core(ptype, mv_p0, mv_p1, p0_ref, tr, ref_tr, bl, ref_bl,
                         br, ref_br, wm: int, hm: int, slice_rows, mvq=None):
    """Per-partition mvds from per-list channel grids: the decoder's
    spec-8.4.1.3 derivation with the 16x8/8x16 directional shortcuts
    (mirror of `_partition_mvds_core_j`).  `p0_ref` [n]: the MB's part0
    ref for this list (0 when it uses the list, INTRA otherwise), which
    part1's within-MB neighbours read.  Returns (mvd0 [n, 2], mvd1 [n, 2],
    pred16); with `mvq` [n, 4, 2] (P_8x8) the quadrant predictors take the
    general median rule with raster-order sibling neighbours, ptype 3
    rows of mvd0/mvd1 become q0/q1's mvds, and mvdq [n, 4, 2] comes
    before pred16."""
    UN = mvpred.UNAVAIL
    n = wm * hm
    dev = ptype.device
    top = _slice_top_mask(hm, slice_rows, dev)

    def shifted(g, rg, dr: int, dc: int):
        """The grids' values of the MB at offset (dr, dc) of each MB, as
        [n, 2] / [n]: (0, UNAVAIL) outside the picture and, for the rows
        above, across a slice start."""
        mv = torch.zeros_like(g)
        ref = torch.full_like(rg, UN)
        dst_r = slice(1, None) if dr else slice(None)
        src_r = slice(None, -1) if dr else slice(None)
        dst_c, src_c = {0: (slice(None), slice(None)),
                        -1: (slice(1, None), slice(None, -1)),
                        1: (slice(None, -1), slice(1, None))}[dc]
        mv[dst_r, dst_c] = g[src_r, src_c]
        ref[dst_r, dst_c] = rg[src_r, src_c]
        if dr:
            ref = torch.where(top, UN, ref)
            mv = torch.where(top[..., None], 0, mv)
        return mv.reshape(n, 2), ref.reshape(n)

    pm = mvpred.predict_mv
    # 16x16 neighbours: A = left MB tr cell, B = top MB bl cell,
    # C = top-right MB bl cell (D-subst -> top-left MB br cell)
    mv_a, ref_a = shifted(tr, ref_tr, 0, -1)
    mv_b, ref_b = shifted(bl, ref_bl, -1, 0)
    mv_c, ref_c = shifted(bl, ref_bl, -1, 1)
    mv_d, ref_d = shifted(br, ref_br, -1, -1)
    use_d = ref_c == UN
    mv_c16 = torch.where(use_d[:, None], mv_d, mv_c)
    ref_c16 = torch.where(use_d, ref_d, ref_c)
    pred16 = pm(mv_a, ref_a, mv_b, ref_b, mv_c16, ref_c16)
    # 8x16 left half: its C is the top MB's col-2 cell (br channel), with
    # D-substitution to the top-left MB's br cell
    mv_tbr, ref_tbr = shifted(br, ref_br, -1, 0)
    use_d0 = ref_tbr == UN
    mv_c0 = torch.where(use_d0[:, None], mv_d, mv_tbr)
    ref_c0 = torch.where(use_d0, ref_d, ref_tbr)
    pred_8x16_0 = pm(mv_a, ref_a, mv_b, ref_b, mv_c0, ref_c0)
    pred_8x16_0 = torch.where((ref_a == 0)[:, None], mv_a, pred_8x16_0)
    # part0: 16x8 top prefers B (ref 0), else the 16-wide median
    pred0 = torch.where((ptype == 2)[:, None], pred_8x16_0,
                        torch.where(((ptype == 1) & (ref_b == 0))[:, None],
                                    mv_b, pred16))
    # ---- part1 ----
    # own part0 as a neighbour: predict_mv expects mv already zeroed for
    # neighbours whose refIdx != 0 (a part0 not using this list)
    mv_p0n = torch.where((p0_ref == 0)[:, None], mv_p0, 0)
    # 16x8 bottom: A = left MB rows 2-3 (br channel); shortcut on A; B =
    # own part0; C unavailable -> D = left MB rows 0-1 (tr channel)
    mv_lbr, ref_lbr = shifted(br, ref_br, 0, -1)
    p1_16x8 = pm(mv_lbr, ref_lbr, mv_p0n, p0_ref, mv_a, ref_a)
    p1_16x8 = torch.where((ref_lbr == 0)[:, None], mv_lbr, p1_16x8)
    # 8x16 right: A = own part0; B = top MB col-2 cell (br channel); C =
    # top-right MB bottom-left (bl), D-subst -> top MB bl; shortcut on C
    use_d1 = ref_c == UN
    mv_c1 = torch.where(use_d1[:, None], mv_b, mv_c)
    ref_c1 = torch.where(use_d1, ref_b, ref_c)
    p1_8x16 = pm(mv_p0n, p0_ref, mv_tbr, ref_tbr, mv_c1, ref_c1)
    p1_8x16 = torch.where((ref_c1 == 0)[:, None], mv_c1, p1_8x16)
    pred1 = torch.where((ptype == 1)[:, None], p1_16x8, p1_8x16)
    mvd0 = mv_p0 - pred0
    mvd1 = mv_p1 - pred1
    if mvq is None:
        return mvd0, mvd1, pred16
    # ---- P_8x8 quadrant predictors (general rule, 8x8 shapes) ----
    zref = torch.zeros(n, dtype=I32, device=dev)   # siblings: ref 0
    q0, q1, q2, q3 = mvq.unbind(1)
    # q0: A = left tr, B = top bl, C = top br (D-subst -> top-left br)
    pred_q0 = pm(mv_a, ref_a, mv_b, ref_b, mv_c0, ref_c0)
    # q1: A = q0, B = top br, C = top-right bl (D-subst -> top MB col 1,
    # the bl channel)
    pred_q1 = pm(q0, zref, mv_tbr, ref_tbr, mv_c1, ref_c1)
    # q2: A = left br, B = q0, C = q1
    pred_q2 = pm(mv_lbr, ref_lbr, q0, zref, q1, zref)
    # q3: A = q2, B = q1, C always unavailable -> D = q0
    pred_q3 = pm(q2, zref, q1, zref, q0, zref)
    on8 = (ptype == 3)[:, None]
    mvdq = torch.stack([q0 - pred_q0, q1 - pred_q1, q2 - pred_q2,
                        q3 - pred_q3], dim=1)
    mvd0 = torch.where(on8, mvdq[:, 0], mvd0)
    mvd1 = torch.where(on8, mvdq[:, 1], mvd1)
    return mvd0, mvd1, mvdq, pred16


def _partition_mvds(mb, wm: int, hm: int, slice_rows):
    """Per-partition mvds of a P frame's MBs with ptype / mv2 (every inter
    partition uses list 0, ref 0; mirror of `_partition_mvds_j`): (mvd0
    [n, 2], mvd1 [n, 2], pred16), with mvdq [n, 4, 2] before pred16 when
    `mb` carries "mvq" (P_8x8)."""
    ptype = mb["ptype"].to(I32)
    mv = mb["mv"].to(I32)
    mv2 = mb["mv2"].to(I32)
    mvq = mb["mvq"].to(I32) if "mvq" in mb else None
    is_inter = mb["is_inter"].to(torch.bool)
    ones = torch.ones_like(is_inter)
    grids = _cell_grids2(ptype, mv, mv2, ones, ones, is_inter, wm, hm,
                         mvq=mvq)
    p0_ref = torch.where(is_inter, 0, mvpred.INTRA).to(I32)
    return _partition_mvds_core(ptype, mv, mv2, p0_ref, *grids, wm, hm,
                                slice_rows, mvq=mvq)


def _ue_slots(vals, lens, slot: int, v, on):
    """ue(v) at `slot` of the MBs where `on`, nothing elsewhere."""
    code, ln = ue_code(v)
    vals[slot] = torch.where(on, code, 0)
    lens[slot] = torch.where(on, ln, 0)


def _skip_run_slots(vals, lens, coded, wm: int, hm: int, slice_rows):
    """mb_skip_run at slot 0 of each coded MB: the skipped MBs since the
    previous coded MB of its slice (a prefix scan)."""
    n = wm * hm
    dev = coded.device
    pos = torch.arange(n, dtype=I32, device=dev)
    slice_first = np.zeros(n, dtype=np.int32)
    rows = [int(r) for r in slice_rows] + [hm]
    for s in range(len(rows) - 1):
        slice_first[rows[s] * wm: rows[s + 1] * wm] = rows[s] * wm
    slice_first = torch.as_tensor(slice_first, device=dev)
    prev_coded = torch.cummax(torch.where(coded, pos, -1), dim=0).values
    prev_excl = torch.cat([torch.full((1,), -1, dtype=I32, device=dev),
                           prev_coded[:-1]])
    prev_excl = torch.maximum(prev_excl, slice_first - 1)
    _ue_slots(vals, lens, 0, pos - prev_excl - 1, coded)


def _cbp_delta_slots(vals, lens, slot: int, cbp, cbp_luma, inter_coded,
                     is_i4, coded, sel16, t8=None) -> None:
    """From `slot` on: coded_block_pattern me(v) of inter and I_NxN MBs;
    with `t8` (a PPS with transform_8x8_mode_flag: the MBs' flags)
    transform_size_8x8_flag after the cbp of inter MBs with a luma
    residual (spec 7.3.5; every inter shape qualifies, B direct included
    under direct_8x8_inference_flag 1); then mb_qp_delta, se(0) = '1',
    where one is sent."""
    dev = cbp.device
    ci, li_ = ue_code(_tab("cbpi", dev)[cbp.long()])
    cp, lp_ = ue_code(_tab("cbpp", dev)[cbp.long()])
    vals[slot] = torch.where(inter_coded, cp, torch.where(is_i4, ci, 0))
    lens[slot] = torch.where(inter_coded, lp_, torch.where(is_i4, li_, 0))
    slot += 1
    if t8 is not None:
        flag_on = inter_coded & (cbp_luma > 0)
        vals[slot] = (flag_on & t8).to(I32)
        lens[slot] = flag_on.to(I32)
        slot += 1
    has_delta = (coded & (sel16 | (cbp > 0))).to(I32)
    vals[slot] = has_delta
    lens[slot] = has_delta


def serialize_frame_p(mb, wm: int, hm: int, slice_rows):
    """P-frame grids (mirror of `serialize_frame_p_j`, and of
    slice_writer.serialize_frame_mbs_p).

    With "ptype"/"mv2" in `mb` (16x8 / 8x16 partitions) the header gains
    the second partition's mvd slots and mb_type follows Table 7-13; with
    "mvq" (P_8x8, sub_mb_type P_L0_8x8 on every quadrant) also the
    sub_mb_type slot (four ue(0) bits) and the quadrants' mvd slots; with
    "t8" (a PPS with transform_8x8_mode_flag) the flag bit of I_NxN MBs
    after mb_type and of inter MBs with a luma residual after the cbp.
    Returns (values [n, slots], lengths, skipped [n] bool)."""
    n = wm * hm
    parts_mode = "ptype" in mb
    p8x8_mode = parts_mode and "mvq" in mb
    t8_mode = "t8" in mb
    ioff, poff = int(t8_mode), int(p8x8_mode)
    is_inter = mb["is_inter"].to(torch.bool)
    dev = is_inter.device
    sel16 = mb["sel16"].to(torch.bool) & ~is_inter
    zero = torch.zeros(n, dtype=I32, device=dev)
    n_hdr = HDR_SLOTS_P + 2 * int(parts_mode) + 2 * ioff + 5 * poff
    vals = [zero] * n_hdr
    lens = [zero] * n_hdr
    cbp_luma, cbp_chroma, cbp = compute_cbp(
        sel16, mb["luma_ac"], mb["chroma_dc"], mb["chroma_ac"])

    mv = mb["mv"].to(I32)
    # list 0's mvds (part 0 / q0, part 1 / q1, q2, q3) and the most
    # probable modes: kernel KD on the card, the plain helpers on the CPU
    mvds, mpm = mb_preds.preds(mb, wm, hm, slice_rows, "p")
    mvds = mvds[:, 0].unbind(1)
    ptype = (mb["ptype"].to(I32) if parts_mode
             else torch.zeros(n, dtype=I32, device=dev))

    mv_skip = mb["mv_skip"].to(I32)
    skipped = (is_inter & (ptype == 0) & (mv == mv_skip).all(dim=1)
               & (cbp == 0))

    coded = ~skipped
    _skip_run_slots(vals, lens, coded, wm, hm, slice_rows)

    mbt_intra = 5 + torch.where(sel16, 1 + mb["i16mode"].to(I32)
                                + 4 * cbp_chroma + 12 * (cbp_luma > 0), 0)
    _ue_slots(vals, lens, 1, torch.where(is_inter, ptype, mbt_intra), coded)

    is_i4 = coded & ~is_inter & ~sel16
    inter_coded = coded & is_inter
    if p8x8_mode:
        # sub_mb_type x4, each ue(0) = '1' (P_L0_8x8), directly after
        # mb_type (spec 7.3.5.2)
        on8 = inter_coded & (ptype == 3)
        vals[2] = torch.where(on8, 15, 0).to(I32)          # 0b1111
        lens[2] = torch.where(on8, 4, 0).to(I32)
    if t8_mode:
        lens[2 + poff] = is_i4.to(I32)          # the flag, 0 for I_NxN
    h = ioff + poff                  # slots added before the mode slots
    _i4_mode_slots(vals, lens, 2 + h, mb, is_i4, mpm)

    _ue_slots(vals, lens, 18 + h, mb["cmode"].to(I32), coded & ~is_inter)
    # mvds (x then y): part0's, then with partitions part1's (q1 on
    # P_8x8), then with P_8x8 q2's and q3's
    mvd_slots = [(mvds[0], inter_coded)]
    if parts_mode:
        mvd_slots.append((mvds[1], inter_coded & (ptype > 0)))
    if p8x8_mode:
        mvd_slots += [(mvds[2], on8), (mvds[3], on8)]
    slot = 19 + h
    for d, on in mvd_slots:
        for comp in (1, 0):
            _ue_slots(vals, lens, slot, se_to_ue(d[:, comp]), on)
            slot += 1

    _cbp_delta_slots(vals, lens, slot, cbp, cbp_luma, inter_coded, is_i4,
                     coded, sel16,
                     mb["t8"].to(torch.bool) if t8_mode else None)

    rv, rl = _residual_slots(mb, sel16, cbp_luma, cbp_chroma, wm, hm,
                             slice_rows)
    return (torch.cat([torch.stack(vals, dim=1), rv], dim=1),
            torch.cat([torch.stack(lens, dim=1), rl], dim=1), skipped)


HDR_SLOTS_B = 25       # B header slots without partitions or the 8x8 PPS


def b_list_flags(mb):
    """The per-list flags of a B frame's raster results -> (btype,
    is_inter, partd, bptype, (use0b, use1b), (exp0, exp1), (exp0b,
    exp1b)): each partition's use of a list (partition 1's equal
    partition 0's on an MB with one partition) and the lists with an
    explicit mvd (not direct) of partition 0 and 1."""
    btype = mb["btype"].to(I32)
    is_inter = btype != 4
    partd = btype == 5
    use0 = mb["use0"].to(torch.bool)
    use1 = mb["use1"].to(torch.bool)
    if "bptype" in mb:
        bptype = mb["bptype"].to(I32)
        c0, c1 = mb["c0"].to(I32), mb["c1"].to(I32)
        # choice c: 0 = L0, 1 = L1, 2 = Bi
        use_b = (torch.where(partd, c1 != 1, use0),
                 torch.where(partd, c1 != 0, use1))
        exp = (torch.where(partd, c0 != 1, (btype == 0) | (btype == 2)),
               torch.where(partd, c0 != 0, (btype == 1) | (btype == 2)))
        exp_b = (partd & (c1 != 1), partd & (c1 != 0))
    else:
        bptype = torch.zeros_like(btype)
        use_b = (use0, use1)
        exp = ((btype == 0) | (btype == 2), (btype == 1) | (btype == 2))
        exp_b = None
    return btype, is_inter, partd, bptype, use_b, exp, exp_b


def b_list_mvds(mb, wm: int, hm: int, slice_rows):
    """Per list, the mvds of a B frame's MBs -> ((mvd0, mvd1) of list 0,
    of list 1), [n, 2] each: partition 0's and partition 1's against the
    spec-8.4.1.3 predictors of the final per-list maps (direct motion
    takes part as a neighbour); with one partition, mvd1 is None."""
    btype, is_inter, _, bptype, use_b, _, _ = b_list_flags(mb)
    out = []
    for lx in range(2):
        use = mb[f"use{lx}"].to(torch.bool)
        mv = mb[f"mv{lx}"].to(I32)
        if "bptype" in mb:
            grids = _cell_grids2(bptype, mv, mb[f"mv{lx}b"].to(I32), use,
                                 use_b[lx], is_inter, wm, hm)
            p0_ref = torch.where(is_inter & use, 0, mvpred.INTRA).to(I32)
            d0, d1, _ = _partition_mvds_core(bptype, mv,
                                             mb[f"mv{lx}b"].to(I32), p0_ref,
                                             *grids, wm, hm, slice_rows)
            out.append((d0, d1))
        else:
            out.append((mvd_16x16(mv, use, wm, hm, slice_rows), None))
    return out


def serialize_frame_b(mb, wm: int, hm: int, slice_rows):
    """B-frame grids (mirror of `serialize_frame_b_j`): 16x16 L0 / L1 /
    Bi, spatial direct (a direct MB with cbp 0 is a B_Skip, counted in the
    skip runs), with "bptype" / "c0" / "c1" / "mv0b" / "mv1b" the 16x8 /
    8x16 two-partition types (Table 7-14 mb_type 4..21), and intra; with
    "t8" (a PPS with transform_8x8_mode_flag) the flag bit, always 0, of
    I_NxN MBs and of inter MBs with a luma residual.  mvds go out per
    list and partition (list 0's partition 0 and 1, then list 1's), for
    the explicit lists of non-direct inter MBs.  Returns (values [n,
    slots], lengths, skipped [n] bool)."""
    n = wm * hm
    parts_mode = "bptype" in mb
    t8_mode = "t8" in mb
    ioff, poff = int(t8_mode), 4 * int(parts_mode)
    btype, is_inter, partd, bptype, _, exp, exp_b = b_list_flags(mb)
    dev = btype.device
    is_direct = btype == 3
    sel16 = mb["sel16"].to(torch.bool) & ~is_inter
    zero = torch.zeros(n, dtype=I32, device=dev)
    n_hdr = HDR_SLOTS_B + poff + 2 * ioff
    vals = [zero] * n_hdr
    lens = [zero] * n_hdr
    cbp_luma, cbp_chroma, cbp = compute_cbp(
        sel16, mb["luma_ac"], mb["chroma_dc"], mb["chroma_ac"])
    skipped = is_direct & (cbp == 0)
    coded = ~skipped

    _skip_run_slots(vals, lens, coded, wm, hm, slice_rows)

    mbt_intra = 23 + torch.where(sel16, 1 + mb["i16mode"].to(I32)
                                 + 4 * cbp_chroma + 12 * (cbp_luma > 0), 0)
    mbt = torch.where(is_direct, 0, torch.where(is_inter, btype + 1,
                                                mbt_intra))
    if parts_mode:
        # Table 7-14 mb_type 4..21: 4 + 2 * combination + (8x16)
        combo = torch.as_tensor(COMBO_IDX, device=dev)
        mbt_part = (4 + 2 * combo[(mb["c0"].to(I32) * 3
                                   + mb["c1"].to(I32)).long()]
                    + (bptype == 2).to(I32))
        mbt = torch.where(partd, mbt_part, mbt)
    _ue_slots(vals, lens, 1, mbt, coded)

    is_i4 = coded & ~is_inter & ~sel16
    if t8_mode:
        lens[2] = is_i4.to(I32)                # the flag, 0 for I_NxN
    # each list's mvds (part 0, part 1) and the most probable modes: kernel
    # KD on the card, the plain helpers on the CPU
    mvds, mpm = mb_preds.preds(mb, wm, hm, slice_rows, "b")
    _i4_mode_slots(vals, lens, 2 + ioff, mb, is_i4, mpm)
    _ue_slots(vals, lens, 18 + ioff, mb["cmode"].to(I32), coded & ~is_inter)

    # mvds (x then y): list 0's partition 0 (and 1), then list 1's
    slot = 19 + ioff
    for lx in range(2):
        for part, on in ((0, coded & exp[lx]),
                         (1, coded & exp_b[lx] if parts_mode else None)):
            if on is None:
                continue
            d = mvds[:, lx, part]
            for comp in (1, 0):
                _ue_slots(vals, lens, slot, se_to_ue(d[:, comp]), on)
                slot += 1

    # the 8x8 flag of inter MBs is 0: B MBs code the 4x4 transform
    _cbp_delta_slots(vals, lens, slot, cbp, cbp_luma, coded & is_inter,
                     is_i4, coded, sel16,
                     torch.zeros_like(coded) if t8_mode else None)

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

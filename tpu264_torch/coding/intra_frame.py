"""Wavefront intra-macroblock evaluation + all-intra frame encoder (torch).

Counterpart of `tpu264.coding.intra_frame`: a loop over anti-diagonal
MB waves; within a wave every MB of the diagonal is a batch lane, and
all candidate modes are evaluated in parallel.  Only the 16 in-MB 4x4
blocks stay sequential (the standard's reconstruction dependency).
Mode decision is SATD + lambda * mode bits, with transform/quant/recon
applied once per selected mode.

Kernels on this path, two launches a wave (`wave_body`): K2 as the I4x4
wave kernel (`kernels.i4x4_wave`: the whole 16-block I4x4 body of a wave,
DCT + quant included) and K3 as the I16x16 + chroma wave kernel
(`kernels.i16_chroma_wave`: both mode searches with their transforms, the
merge with the I4x4 result and the border scatter).  Both read the
neighbour context straight from the border buffers.  The plain version,
which the CPU takes, is `wave_body_plain`: `gather_border_ctx`,
`eval_i4x4_plain`, then `i16_chroma_wave_plain` (`eval_i16`,
`eval_chroma`, the merge, `update_border_ctx`).

The batched all-intra entry codes a chunk of F pictures of one geometry
at once: the encoder (`make_intra_encoder`) then takes planes [F, H, W],
and every stage of its wave loop carries a leading picture axis (border
buffers [F, ...], a wave's tiles and results [F, B, ...]), so that one
launch of each wave kernel covers the wave in all F pictures.  The
pictures share the wave schedule; nothing crosses from one to another.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu264_torch.kernels import dct_quant as dq
from tpu264_torch.kernels import i16_chroma_wave as k3w
from tpu264_torch.kernels import i4x4_wave as k2w
from tpu264_torch.kernels import intra as ki
from tpu264_torch.kernels import transform as kt
from tpu264_torch.ref.transform import chroma_qp
from .wavefront import BLK_ORDER, WaveSchedule, block_availability

I32 = torch.int32
BIG = 1 << 28
BLK_RULES = [block_availability(i) for i in range(16)]
_K2_RULES = k2w.rule_codes(BLK_RULES)
_BLK_ORDER = tuple(BLK_ORDER)
# block spatial position (brow, bcol) per zig-zag idx
ZZ_ROWS = np.array([r for r, _ in BLK_ORDER])
ZZ_COLS = np.array([c for _, c in BLK_ORDER])

# (lam4, lam24, lam_me) per QP 0..51: the values `tpu264.coding.
# intra_frame.lambda_terms_j` computes in float32 (round(k * sqrt(0.85) *
# 2^((qp-12)/6)) for k = 4, 24, 1, at least 1).  Held as integers so a
# last-ulp difference between float libraries cannot flip a mode
# decision; the tests compare every entry with the reference.
LAMBDA_TABLE = (
    (1, 6, 1), (1, 6, 1), (1, 7, 1), (1, 8, 1), (1, 9, 1), (2, 10, 1),
    (2, 11, 1), (2, 12, 1), (2, 14, 1), (3, 16, 1), (3, 18, 1), (3, 20, 1),
    (4, 22, 1), (4, 25, 1), (5, 28, 1), (5, 31, 1), (6, 35, 1), (7, 39, 2),
    (7, 44, 2), (8, 50, 2), (9, 56, 2), (10, 63, 3), (12, 70, 3), (13, 79, 3),
    (15, 89, 4), (17, 99, 4), (19, 112, 5), (21, 125, 5), (23, 140, 6),
    (26, 158, 7), (30, 177, 7), (33, 199, 8), (37, 223, 9), (42, 250, 10),
    (47, 281, 12), (53, 315, 13), (59, 354, 15), (66, 397, 17), (74, 446, 19),
    (83, 501, 21), (94, 562, 23), (105, 631, 26), (118, 708, 30),
    (132, 795, 33), (149, 892, 37), (167, 1001, 42), (187, 1124, 47),
    (210, 1262, 53), (236, 1416, 59), (265, 1590, 66), (297, 1784, 74),
    (334, 2003, 83))


def _blk_avail(rule_key, rule, at, al, atl, atr):
    v = rule[rule_key]
    if v is True:
        return torch.ones_like(at)
    if v is False:
        return torch.zeros_like(at)
    return {"mb_top": at, "mb_left": al, "mb_tl": atl, "mb_tr": atr}[v]


def _take_mode(preds, best):
    """preds [B, M, ...] -> preds[b, best[b]]."""
    return preds[torch.arange(preds.shape[0], device=preds.device), best]


def eval_i4x4(orig, ltop, lleft, modes_top, modes_left, at, al, atl, atr,
              qp: int, lam4: int, lam24: int):
    """Sequential 16-block I4x4 search + recon for a wave of B MBs.

    Returns (recon mb [B,16,16], mode grid [B,4,4], modes in zig-zag order
    [B,16], scanned levels [B,16,16], total cost [B]).

    CUDA tensors go through the wave kernel (K2, one launch for the whole
    body, or it raises); CPU tensors through `eval_i4x4_plain`.
    """
    if orig.device.type == "cpu":
        return eval_i4x4_plain(orig, ltop, lleft, modes_top, modes_left,
                               at, al, atl, atr, qp, lam4, lam24)
    return k2w.i4x4_wave(orig, ltop, lleft, modes_top, modes_left,
                         at, al, atl, atr, qp, lam4, lam24, _K2_RULES)


def eval_i4x4_plain(orig, ltop, lleft, modes_top, modes_left, at, al, atl,
                    atr, qp: int, lam4: int, lam24: int):
    """Plain torch version of `eval_i4x4` (what the wave kernel is held
    to): a Python loop over the 16 blocks in coding order."""
    b = orig.shape[0]
    dev = orig.device
    # MB buffers, filled in place block by block
    mbbuf = torch.zeros((b, 16, 16), dtype=I32, device=dev)
    modebuf = torch.full((b, 4, 4), -1, dtype=I32, device=dev)
    coeffs = []
    modes_out = []
    cost = torch.zeros(b, dtype=I32, device=dev)
    mode_ids = torch.arange(9, dtype=I32, device=dev)[None, :]
    for idx in range(16):
        rule = BLK_RULES[idx]
        by, bx = rule["by"], rule["bx"]
        y0, x0 = by * 4, bx * 4
        # --- neighbor samples ---
        if by == 0:
            top8 = ltop[:, 1 + x0:9 + x0]
        elif bx < 3:
            top8 = mbbuf[:, y0 - 1, x0:x0 + 8]
        else:
            t4 = mbbuf[:, y0 - 1, x0:x0 + 4]
            top8 = torch.cat([t4, t4[:, 3:4].expand(b, 4)], dim=1)
        if bx == 0:
            left4 = lleft[:, y0:y0 + 4]
        else:
            left4 = mbbuf[:, y0:y0 + 4, x0 - 1]
        if by == 0 and bx == 0:
            tl = ltop[:, 0]
        elif by == 0:
            tl = ltop[:, x0]
        elif bx == 0:
            tl = lleft[:, y0 - 1]
        else:
            tl = mbbuf[:, y0 - 1, x0 - 1]
        # --- availability + top-right substitution ---
        b_at = _blk_avail("top", rule, at, al, atl, atr)
        b_al = _blk_avail("left", rule, at, al, atl, atr)
        b_atl = _blk_avail("tl", rule, at, al, atl, atr)
        b_atr = _blk_avail("tr", rule, at, al, atl, atr)
        top8 = torch.where(b_atr[:, None], top8,
                           torch.cat([top8[:, :4],
                                      top8[:, 3:4].expand(b, 4)], dim=1))
        # --- all 9 modes ---
        preds = ki.predict4x4_all(top8, left4, tl)
        preds[:, 2] = ki.predict4x4_dc(top8, left4, b_at,
                                       b_al)[:, None, None]
        valid9 = ki.mode_valid4(b_at, b_al, b_atl)
        oblk = orig[:, y0:y0 + 4, x0:x0 + 4]
        satd = kt.satd4x4(oblk[:, None] - preds)
        # --- most probable mode (spec 8.3.1.1): -2 = neighbor unavailable
        # → MPM is DC outright; -1 = available non-I4x4 MB → that side
        # counts as DC.  Slice-boundary masking: the maps may hold another
        # slice's modes. ---
        ma = (torch.where(al, modes_left[:, by], -2) if bx == 0
              else modebuf[:, by, bx - 1])
        mb_ = (torch.where(at, modes_top[:, bx], -2) if by == 0
               else modebuf[:, by - 1, bx])
        a = torch.where(ma == -1, 2, ma)
        b_side = torch.where(mb_ == -1, 2, mb_)
        mpm = torch.where((a < 0) | (b_side < 0), 2,
                          torch.minimum(a, b_side))
        j = satd + torch.where(mode_ids == mpm[:, None], 0, lam4)
        j = torch.where(valid9, j, BIG)
        # ties go to the lowest mode number, as in the reference
        best = torch.argmin(j, dim=1)
        cost = cost + j.amin(dim=1)
        modebuf[:, by, bx] = best.to(I32)
        modes_out.append(best.to(I32))
        # --- transform / quant / recon ---
        pred = _take_mode(preds, best)
        lev = dq.fdct_quant4x4_plain(oblk - pred, qp, intra=True)
        coeffs.append(kt.zigzag_scan(lev))
        rec = kt.clip1(pred + kt.block_recon(lev, qp))
        mbbuf[:, y0:y0 + 4, x0:x0 + 4] = rec
    return (mbbuf, modebuf, torch.stack(modes_out, dim=1),
            torch.stack(coeffs, dim=1), (cost + lam24).to(I32))


def eval_i16(orig, ltop, lleft, at, al, atl, qp: int):
    """I16x16 mode search + recon. Returns (mode, cost, recon, dc levels
    [B,4,4], ac levels [B,4,4,4,4] with position 0 zeroed).

    Plain torch on any device: part of the plain versions of the wave
    kernels K3 (`i16_chroma_wave_plain`) and KP (`inter_frame.
    p_frame_plain`), whose forward DCT is K3's plain version."""
    b = orig.shape[0]
    top16 = ltop[:, 1:17]
    tl = ltop[:, 0]
    preds = ki.predict16x16_all(top16, lleft, tl, at, al)
    valid = ki.mode_valid16(at, al, atl)
    diff = orig[:, None] - preds                        # [B,4,16,16]
    dblk = diff.reshape(b, 4, 4, 4, 4, 4).permute(0, 1, 2, 4, 3, 5)
    m = kt.hadamard4x4(dblk)
    sat = m.abs().sum(dim=(-3, -2, -1), dtype=I32).sum(dim=-1, dtype=I32)
    satdc = m[..., 0, 0].abs().sum(dim=(-2, -1), dtype=I32)
    j = (sat - satdc + 1) >> 1                          # JM find_sad_16x16
    j = torch.where(valid, j, BIG)
    best = torch.argmin(j, dim=1)
    cost = j.amin(dim=1)
    pred = _take_mode(preds, best)
    resid = orig - pred
    blk = resid.reshape(b, 4, 4, 4, 4).permute(0, 1, 3, 2, 4)  # [B,br,bc,4,4]
    wcoef = dq.fdct4x4_plain(blk)
    dc_lev = kt.hadamard4x4_fwd_quant_dc(wcoef[..., 0, 0], qp)
    dc_deq = kt.hadamard4x4_inv_dequant_dc(dc_lev, qp)
    ac_lev = kt.quant4x4(wcoef, qp, intra=True)
    ac_lev[..., 0, 0] = 0
    res_rec = kt.block_recon(ac_lev, qp, dc=dc_deq)
    rec = kt.clip1(pred + res_rec.permute(0, 1, 3, 2, 4).reshape(b, 16, 16))
    return best.to(I32), cost, rec, dc_lev, ac_lev


def eval_chroma(orig_u, orig_v, tctx_u, lctx_u, tctx_v, lctx_v, at, al, atl,
                cqp: int):
    """Chroma mode decision + recon for both components; plain torch, as
    `eval_i16`.

    Returns (mode [B], [(rec, dc [B,4], ac [B,4,16]) for U, V]).
    """
    b = orig_u.shape[0]
    preds_u = ki.predict_chroma_all(tctx_u[:, 1:9], lctx_u, tctx_u[:, 0],
                                    at, al)
    preds_v = ki.predict_chroma_all(tctx_v[:, 1:9], lctx_v, tctx_v[:, 0],
                                    at, al)
    valid = ki.mode_valid_chroma(at, al, atl)
    satd = torch.zeros((b, 4), dtype=I32, device=orig_u.device)
    for orig, preds in ((orig_u, preds_u), (orig_v, preds_v)):
        diff = orig[:, None] - preds
        dblk = diff.reshape(b, 4, 2, 4, 2, 4).permute(0, 1, 2, 4, 3, 5)
        satd = satd + kt.satd4x4(dblk).sum(dim=(-2, -1), dtype=I32)
    jcost = torch.where(valid, satd, BIG)
    best = torch.argmin(jcost, dim=1)
    outs = [chroma_residual_recon(orig, _take_mode(preds, best), cqp)
            for orig, preds in ((orig_u, preds_u), (orig_v, preds_v))]
    return best.to(I32), outs


def chroma_residual_recon(orig, pred, cqp: int, intra: bool = True):
    """Chroma residual transform path for a given prediction; plain torch,
    as `eval_i16`.

    Returns (recon [B,8,8], dc levels [B,4] raster, ac scanned [B,4,16]
    with position 0 zeroed)."""
    b = orig.shape[0]
    resid = orig - pred
    blk = resid.reshape(b, 2, 4, 2, 4).permute(0, 1, 3, 2, 4)
    wcoef = dq.fdct4x4_plain(blk)
    dc_lev = kt.hadamard2x2_fwd_quant_dc(wcoef[..., 0, 0], cqp, intra)
    dc_deq = kt.hadamard2x2_inv_dequant_dc(dc_lev, cqp)
    ac_lev = kt.quant4x4(wcoef, cqp, intra=intra)
    ac_lev[..., 0, 0] = 0
    res_rec = kt.block_recon(ac_lev, cqp, dc=dc_deq)
    rec = kt.clip1(pred + res_rec.permute(0, 1, 3, 2, 4).reshape(b, 8, 8))
    return (rec, dc_lev.reshape(b, 4),
            kt.zigzag_scan(ac_lev).reshape(b, 4, 16))


def init_border_buffers(hm: int, wm: int, device, frames=None):
    """Compact wavefront carry: 1-px-deep borders instead of full planes
    (with `frames` = F: one set for each of F pictures, [F, ...]).

    Intra prediction of MB (r, c) only reads (a) the bottom pixel row of
    MB row r-1 (incl. the top-left corner and top-right run) and (b) the
    right pixel column of MB (r, c-1), which on the 2r+c schedule is the
    MB finished one wave earlier in the same row.  Layouts (the same as
    the reference's):
      row_y  [hm+2, 1+W+8]   row r = pixel row r*16 of the padded plane
      col_y  [hm+1, 16]      right column of the last finished MB in row r
      row_u/v [hm+2, 1+W/2+8], col_u/v [hm+1, 8]
      modes_row [hm+2, 1+wm*4+4], modes_col [hm+1, 4] (fill -2)
    Row hm+1 of the row buffers and row hm of the column buffers take the
    writes of the padding lanes.
    """
    w = wm * 16
    lead = () if frames is None else (int(frames),)

    def z(*shape, fill=0):
        return torch.full(lead + shape, fill, dtype=I32, device=device)

    return dict(row_y=z(hm + 2, 1 + w + 8), col_y=z(hm + 1, 16),
                row_u=z(hm + 2, 1 + w // 2 + 8), col_u=z(hm + 1, 8),
                row_v=z(hm + 2, 1 + w // 2 + 8), col_v=z(hm + 1, 8),
                modes_row=z(hm + 2, 1 + wm * 4 + 4, fill=-2),
                modes_col=z(hm + 1, 4, fill=-2))


def _at(f, *idx):
    """Index a border buffer at lanes `idx`, in picture f of each lane
    where the buffers carry a picture axis (f not None)."""
    return idx if f is None else (f.reshape((-1,) + (1,) * (
        idx[-1].dim() - 1)),) + idx


def gather_border_ctx(bd, r, c, f=None):
    """Per-MB neighbor context for one wave from the border carry; lane i
    is MB (r[i], c[i]) of picture f[i] where the buffers are [F, ...]."""
    dev = r.device

    def run(name, start, width):
        cols = start[:, None] + torch.arange(width, device=dev)[None, :]
        return bd[name][_at(f, r[:, None], cols)]

    def col(name):
        return bd[name][_at(f, r)]

    return (run("row_y", c * 16, 25), col("col_y"),
            run("row_u", c * 8, 9), col("col_u"),
            run("row_v", c * 8, 9), col("col_v"),
            run("modes_row", c * 4 + 1, 4), col("modes_col"))


def update_border_ctx(bd, r, c, recon_mb, rec_u, rec_v, mode_tiles, f=None):
    """Write the finished wave's MB borders back into the carry, in place
    (the buffers are only ever read through `gather_border_ctx`); lane i
    is MB (r[i], c[i]) of picture f[i] where the buffers are [F, ...]."""
    dev = r.device
    rr = (r + 1)[:, None]

    def cols(px):
        return 1 + c[:, None] * px + torch.arange(px, device=dev)[None, :]

    bd["row_y"][_at(f, rr, cols(16))] = recon_mb[:, 15, :]
    bd["col_y"][_at(f, r)] = recon_mb[:, :, 15]
    bd["row_u"][_at(f, rr, cols(8))] = rec_u[:, 7, :]
    bd["col_u"][_at(f, r)] = rec_u[:, :, 7]
    bd["row_v"][_at(f, rr, cols(8))] = rec_v[:, 7, :]
    bd["col_v"][_at(f, r)] = rec_v[:, :, 7]
    bd["modes_row"][_at(f, rr, cols(4))] = mode_tiles[:, 3, :]
    bd["modes_col"][_at(f, r)] = mode_tiles[:, :, 3]


def _frame_lanes(coords, avail, frames):
    """A wave's lanes (coords [B,2], avail [B,4]) in each of `frames`
    pictures (None: one picture), picture-major -> (f or None, r, c,
    avail) per lane."""
    r, c = coords[:, 0].long(), coords[:, 1].long()
    if frames is None:
        return None, r, c, avail
    f = torch.arange(frames, device=r.device).repeat_interleave(r.shape[0])
    return f, r.repeat(frames), c.repeat(frames), avail.repeat(frames, 1)


def i16_chroma_wave_plain(bd, coords, avail, gy, gu, gv, mb4, modebuf,
                          coeffs4, j4, qp: int, cqp: int) -> dict:
    """Plain torch version of the I16x16 + chroma wave kernel (K3,
    `kernels.i16_chroma_wave.i16_chroma_wave`, same inputs): the I16x16 and
    chroma searches with their transforms, the merge with the I4x4 results
    (recon, mode grid, scanned levels, cost) and the border scatter into
    `bd`.  Returns every result of the wave but "modes".  A chunk of F
    pictures (gy [F,B,16,16], the other per-lane inputs likewise, border
    buffers [F, ...]) gives results [F, B, ...]."""
    nf = gy.shape[0] if gy.dim() == 4 else None
    lanes = _frame_lanes(coords, avail, nf)
    flat = [t if nf is None else t.flatten(0, 1)
            for t in (gy, gu, gv, mb4, modebuf, coeffs4, j4)]
    res = _i16_chroma_lanes(bd, *lanes, *flat, qp, cqp)
    return res if nf is None else {k: v.unflatten(0, (nf, -1))
                                   for k, v in res.items()}


def _i16_chroma_lanes(bd, f, r, c, avail, gy, gu, gv, mb4, modebuf, coeffs4,
                      j4, qp: int, cqp: int) -> dict:
    """`i16_chroma_wave_plain` of lanes (r, c) of pictures f."""
    at, al, atl, _ = avail.unbind(1)
    ltop, lleft, tctx_u, lctx_u, tctx_v, lctx_v, _, _ = gather_border_ctx(
        bd, r, c, f)
    m16, j16, rec16, dc_lev, ac_lev = eval_i16(
        gy, ltop, lleft, at, al, atl, qp)
    sel16 = j16 < j4

    recon_mb = torch.where(sel16[:, None, None], rec16, mb4)
    ac16_zz = kt.zigzag_scan(ac_lev[:, ZZ_ROWS, ZZ_COLS])     # [B,16,16]
    luma_ac = torch.where(sel16[:, None, None], ac16_zz, coeffs4)
    luma_dc = torch.where(sel16[:, None], kt.zigzag_scan(dc_lev), 0)

    cmode, ((rec_u, dc_u, ac_u), (rec_v, dc_v, ac_v)) = eval_chroma(
        gu, gv, tctx_u, lctx_u, tctx_v, lctx_v, at, al, atl, cqp)

    mode_tiles = torch.where(sel16[:, None, None], -1, modebuf)
    update_border_ctx(bd, r, c, recon_mb, rec_u, rec_v, mode_tiles, f)

    return dict(sel16=sel16, i16mode=m16, cmode=cmode,
                luma_ac=luma_ac, luma_dc=luma_dc,
                chroma_dc=torch.stack([dc_u, dc_v], dim=1),
                chroma_ac=torch.stack([ac_u, ac_v], dim=1),
                recon_mb=recon_mb, rec_u=rec_u, rec_v=rec_v)


def wave_body_plain(qp, cqp, lam4, lam24, bd, coords, avail, gy, gu, gv):
    """Plain torch version of `wave_body` (what the two wave kernels are
    held to): gather, the I4x4 search, then `i16_chroma_wave_plain`; for a
    chunk of F pictures as `wave_body` takes it, all F pictures' lanes at
    once."""
    nf = gy.shape[0] if gy.dim() == 4 else None
    f, r, c, avail = _frame_lanes(coords, avail, nf)
    if nf is not None:
        gy, gu, gv = (t.flatten(0, 1) for t in (gy, gu, gv))
    at, al, atl, atr = avail.unbind(1)
    ltop, lleft, _, _, _, _, modes_top, modes_left = gather_border_ctx(
        bd, r, c, f)
    mb4, modebuf, modes_zz, coeffs4, j4 = eval_i4x4_plain(
        gy, ltop, lleft, modes_top, modes_left, at, al, atl, atr,
        qp, lam4, lam24)
    res = _i16_chroma_lanes(bd, f, r, c, avail, gy, gu, gv, mb4, modebuf,
                            coeffs4, j4, qp, cqp)
    res = {k: modes_zz if k == "modes" else res[k] for k in k3w.OUTPUTS}
    return res if nf is None else {k: v.unflatten(0, (nf, -1))
                                   for k, v in res.items()}


def wave_body(qp, cqp, lam4, lam24, bd, coords, avail, gy, gu, gv, out=None):
    """One wave of B lanes: mode decision, transform, quantisation and
    reconstruction of the MBs at coords [B,2] = (r, c) (int32; padding
    lanes at (hm, 0)) with avail [B,4] = (top, left, top-left, top-right)
    and source tiles gy [B,16,16], gu, gv [B,8,8]; the border buffers `bd`
    give the neighbour context and take the finished MBs' borders, in
    place.  Returns the wave's results, a dict of [B, ...] tensors.  A
    chunk of F pictures: tiles [F, B, ...] and border buffers [F, ...]
    (coords and avail shared), results [F, B, ...].

    CUDA tensors go through the two wave kernels (K2, then K3 on the same
    stream, or it raises), which write into `out` when it is given (rows
    of the frame's arrays, `kernels.i16_chroma_wave.alloc_outputs`); CPU
    tensors through `wave_body_plain`.
    """
    if gy.device.type == "cpu":
        return wave_body_plain(qp, cqp, lam4, lam24, bd, coords, avail,
                               gy, gu, gv)
    if out is None:
        out = k3w.alloc_outputs(tuple(gy.shape[:-2]), gy.device)
    mb4, modebuf, _, coeffs4, j4 = k2w.i4x4_wave_bd(
        gy, bd, coords, avail, qp, lam4, lam24, _K2_RULES,
        modes_zz=out["modes"])
    k3w.i16_chroma_wave(bd, coords, avail, gy, gu, gv, mb4, modebuf, coeffs4,
                        j4, qp, cqp, _BLK_ORDER, out)
    return out


def tile_origin_xs(sched: WaveSchedule, y, u, v):
    """Original MB tiles per (wave, lane) [n_waves, max_wave, px, px],
    gathered once with the static schedule indices; planes [F, H, W] of a
    chunk give [F, n_waves, max_wave, px, px]."""
    hm, wm = sched.height_mbs, sched.width_mbs
    rs, cs = _on_device(sched, "tile_rc", y.device)

    def tiles(p, px):
        t = p.reshape(*p.shape[:-2], hm, px, wm, px).transpose(-3, -2)
        return t[..., rs, cs, :, :]

    return tiles(y, 16), tiles(u, 8), tiles(v, 8)


def assemble_plane(sched: WaveSchedule, tiles, px: int):
    """[n_waves, max_wave, px, px] wave-major MB tiles → [H, W] plane via
    a static-permutation gather ([F, ...] -> [F, H, W] for a chunk)."""
    hm, wm = sched.height_mbs, sched.width_mbs
    lead = tuple(tiles.shape[:-4])
    perm = _on_device(sched, "perm", tiles.device)
    t = tiles.reshape(lead + (-1, px, px))[..., perm, :, :]
    return t.reshape(lead + (hm, wm, px, px)).transpose(-3, -2).reshape(
        lead + (hm * px, wm * px))


def make_intra_encoder(sched: WaveSchedule, chroma_qp_offset: int = 0):
    """All-intra frame encoder for a fixed geometry.

    fn(y, u, v, qp) -> (recon dict, per-wave outputs stacked
    [n_waves, max_wave, ...]); y/u/v are uint8 or int32 tensors on the
    device that runs the encode, qp a Python int.  A chunk of F pictures,
    y [F, H, W] and u, v [F, H/2, W/2], goes through one wave loop (one
    launch of each wave kernel a wave for all F) and gives the recon
    planes and the outputs with the leading F.
    """
    wm, hm = sched.width_mbs, sched.height_mbs

    def encode(y, u, v, qp: int):
        """y: [H,W] ([F,H,W]) uint8/int32, u/v: [H/2, W/2] ([F, ...]).
        Returns (recon, per-wave ys)."""
        dev = y.device
        y, u, v = y.to(I32), u.to(I32), v.to(I32)
        nf = y.shape[0] if y.dim() == 3 else None
        lead = () if nf is None else (nf,)
        qp = int(qp)
        cqp = chroma_qp(qp, chroma_qp_offset)
        lam4, lam24, _ = LAMBDA_TABLE[qp]
        coords, avail = _on_device(sched, "waves", dev)
        tiles = tile_origin_xs(sched, y, u, v)
        bd = init_border_buffers(hm, wm, dev, nf)
        # per wave: (coords, avail, gy, gu, gv), each picture's if a chunk
        xs = list(zip(coords.unbind(0), avail.unbind(0),
                      *(t.unbind(len(lead)) for t in tiles)))
        if dev.type == "cpu":
            per_wave = [wave_body(qp, cqp, lam4, lam24, bd, *x) for x in xs]
            ys = {k: torch.stack([w[k] for w in per_wave], dim=len(lead))
                  for k in per_wave[0]}
        else:
            # the kernels write each wave's results into its row
            ys = k3w.alloc_outputs(lead + (sched.n_waves, sched.max_wave),
                                   dev)
            rows = {k: v.unbind(len(lead)) for k, v in ys.items()}
            for wi, x in enumerate(xs):
                wave_body(qp, cqp, lam4, lam24, bd, *x,
                          out={k: v[wi] for k, v in rows.items()})
        out = dict(
            recon_y=assemble_plane(sched, ys.pop("recon_mb"), 16),
            recon_u=assemble_plane(sched, ys.pop("rec_u"), 8),
            recon_v=assemble_plane(sched, ys.pop("rec_v"), 8),
        )
        return out, ys

    return encode


def _on_device(sched: WaveSchedule, what: str, device):
    """The schedule's static index tensors on `device` (`kt.constant`):
    "waves" (coords int32, avail), "tile_rc" (the tiles' MB rows and
    columns), "perm" (`_raster_perm`)."""
    def make():
        if what == "waves":
            return sched.coords.astype(np.int32), sched.avail
        if what == "tile_rc":
            return (np.minimum(sched.coords[:, :, 0], sched.height_mbs - 1),
                    sched.coords[:, :, 1])
        return _raster_perm(sched)

    return kt.constant((sched.width_mbs, sched.height_mbs,
                        tuple(sched.slice_starts.tolist()), what), device,
                       make)


def _raster_perm(sched: WaveSchedule) -> np.ndarray:
    """perm[mb_raster_idx] = flat wave-major lane index (static)."""
    flat_idx = sched.mb_index.reshape(-1)
    valid = sched.valid.reshape(-1)
    perm = np.zeros(sched.n_mbs, np.int64)
    perm[flat_idx[valid]] = np.flatnonzero(valid)
    return perm


def reorder_wave_outputs(sched: WaveSchedule, ys, frames: bool = False
                         ) -> dict:
    """Per-wave stacked outputs → [n_mbs, ...] raster order (a static
    permutation gather; every raster MB has exactly one valid lane).
    `frames`: the outputs of a chunk, [F, n_waves, max_wave, ...] ->
    [F, n_mbs, ...]."""
    out = {}
    lead = 1 if frames else 0
    for k, arr in ys.items():
        perm = _on_device(sched, "perm", arr.device)
        flat = arr.flatten(lead, lead + 1)
        out[k] = flat[:, perm] if frames else flat[perm]
    return out

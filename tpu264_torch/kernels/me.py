"""Full-search + sub-pel motion estimation (torch), counterpart of
`tpu264.kernels.me`.

All macroblocks search in parallel.  The reference writes the candidate
sweep as SSD(dy,dx) = sum(W^2) - 2*corr(W, O) + sum(O^2) with float32
convolutions, one sweep for each block it searches (the MB, its four
halves, its four quadrants), exact because every intermediate sum is an
integer below 2^24; here the SSD is summed directly in int32, one row of
offsets at a time, so no float precision mode of the card can change a
decision, and in one sweep: the four quadrants' maps, whose sums are the
halves' and the MB's maps.

Sub-pel refinement: the 8 half-pel neighbours of the best integer
position, then the 8 quarter-pel neighbours of the best half position,
with SATD + lambda * mv-rate cost.

`full_search_blocks` and `subpel_refine` are what the plain versions of
the kernels KF (`me_search.py`) and KS (`me_subpel.py`) run; the encoders
reach them through those wrappers.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu264_torch.entropy.device_cavlc import bit_length_minus1
from . import interp as ki
from . import transform as kt
from .transform import I32


def mv_bits_table(max_abs: int):
    """ue(se(v)) code lengths for mvd components -max_abs..max_abs."""
    v = np.arange(-max_abs, max_abs + 1)
    k = np.where(v > 0, 2 * v - 1, -2 * v)
    return np.array([int(x + 1).bit_length() - 1 for x in k],
                    dtype=np.int64) * 2 + 1


def mv_cost(mv):
    """ue(se(v)) bit length per component of mv [..., 2], summed."""
    k = torch.where(mv > 0, 2 * mv - 1, -2 * mv)
    return (2 * bit_length_minus1(k + 1) + 1).sum(dim=-1, dtype=I32)


def _mb_origins(width_mbs: int, height_mbs: int, device):
    idx = torch.arange(width_mbs * height_mbs, device=device)
    return idx // width_mbs, idx % width_mbs


def _quad_ssd(orig_y, ref_pad, pad: int, r: int, width_mbs: int,
              height_mbs: int):
    """SSD maps [n, 4, span, span] int32 (span = 2r + 1, dy-major) of the
    four 8x8 quadrants of every MB (raster quadrant order) against its
    search window: quadrant (qy, qx) at candidate (dy, dx) reads the window
    at row dy + 8 qy, column dx + 8 qx, as the 16x16 block does at (dy, dx).
    A half's or the whole MB's map is the sum of its quadrants' maps."""
    n = width_mbs * height_mbs
    dev = orig_y.device
    mb_r, mb_c = _mb_origins(width_mbs, height_mbs, dev)
    win = 16 + 2 * r
    span = 2 * r + 1
    windows = ki.gather_blocks(ref_pad.to(I32), mb_r * 16 + pad - r,
                               mb_c * 16 + pad - r, win, win)
    origs = ki.gather_blocks(orig_y.to(I32), mb_r * 16, mb_c * 16, 16, 16)
    # [n, win, span, 16]: every 16-wide run of every window row (a view)
    runs = windows.unfold(2, 16, 1)
    o = origs[:, :, None, :]
    # one row of offsets dy at a time: [n, 16, span(dx), 16] squared
    # differences, summed over each quadrant's 8 rows and 8 columns
    ssd = torch.stack(
        [((runs[:, dy:dy + 16] - o) ** 2).reshape(n, 2, 8, span, 2, 8)
         .sum(dim=(2, 5), dtype=I32) for dy in range(span)],
        dim=2)                              # [n, 2(qy), span(dy), span(dx), 2(qx)]
    return ssd.permute(0, 1, 4, 2, 3).reshape(n, 4, span, span)


def _best(ssd, lam: int, r: int):
    """Cheapest candidate of SSD maps [..., span, span]: SSD + lam * bits of
    the mv against (0, 0) (the wavefront pass re-rates against the true
    predictor); of equal costs the first in (dy, dx) raster order wins, as
    the reference's argmin takes it.  -> (mv_int [..., 2], cost [...])."""
    span = 2 * r + 1
    bits = torch.as_tensor(mv_bits_table(r), dtype=I32, device=ssd.device)
    cost = ssd + int(lam) * (bits[:, None] + bits[None, :])
    flat = cost.flatten(-2)
    best = torch.argmin(flat, dim=-1)
    mv = torch.stack([best // span - r, best % span - r], dim=-1).to(I32)
    return mv, flat.amin(dim=-1)


def full_search_16x16(orig_y, ref_pad, pad: int, search_range: int,
                      lam: int, width_mbs: int, height_mbs: int):
    """Integer full search for every MB of a frame at once.

    orig_y: [H, W]; ref_pad: [H+2p, W+2p] edge-padded reference.
    Returns mv_int [nMB, 2] (full-pel, y/x) and its cost [nMB] (SSD +
    lam * bits of the mv against (0, 0)), int32.  Of equal costs the first
    in (dy, dx) raster order wins.
    """
    q = _quad_ssd(orig_y, ref_pad, pad, search_range, width_mbs, height_mbs)
    return _best(q.sum(dim=1, dtype=I32), lam, search_range)


# the blocks of an MB that have a search of their own: name -> the
# quadrants (raster) whose SSD maps add up to its map
SEARCH_BLOCKS = {"16x16": (0, 1, 2, 3), "top": (0, 1), "bot": (2, 3),
                 "left": (0, 2), "right": (1, 3),
                 "q0": (0,), "q1": (1,), "q2": (2,), "q3": (3,)}


def full_search_blocks(orig_y, ref_pad, pad: int, search_range: int,
                       lam: int, width_mbs: int, height_mbs: int,
                       names=tuple(SEARCH_BLOCKS)):
    """Integer full search of the blocks `names` of `SEARCH_BLOCKS` for
    every MB, from one SSD sweep: {name: mv_int [nMB, 2]}.  The whole MB's
    search equals `full_search_16x16`, the halves' the reference's
    `full_search_parts` (top, bot, left, right) and the quadrants' its
    `full_search_quads` (q0..q3): each block stays anchored to the MB
    origin, so a candidate reads the same window at the same
    displacement, and the SSD of a half is the sum of two quadrants'."""
    q = _quad_ssd(orig_y, ref_pad, pad, search_range, width_mbs, height_mbs)
    out = {}
    for name in names:
        parts = SEARCH_BLOCKS[name]
        ssd = q[:, parts[0]]
        for i in parts[1:]:
            ssd = ssd + q[:, i]
        out[name] = _best(ssd, lam, search_range)[0]
    return out


def subpel_refine(orig_y, planes, pad: int, mv_int, lam: int,
                  width_mbs: int, height_mbs: int,
                  oy=0, ox=0, bh: int = 16, bw: int = 16):
    """Half- then quarter-pel refinement with SATD cost.

    mv_int: [nMB, 2] full-pel. Returns mv_q [nMB, 2] quarter-pel.
    (oy, ox, bh, bw) select a partition of each MB (default: whole MB).
    `oy` and `ox` may also be sequences of P offsets, P partitions of one
    shape refined in one pass: mv_int and the result are then [P * nMB, 2],
    partition after partition.  A candidate replaces the best so far only
    where it is strictly cheaper, in the fixed order dy, dx over
    (-step, 0, step).
    """
    dev = orig_y.device
    oys = [oy] if isinstance(oy, int) else list(oy)
    oxs = [ox] if isinstance(ox, int) else list(ox)
    mb_r, mb_c = _mb_origins(width_mbs, height_mbs, dev)
    by = torch.cat([mb_r * 16 + o for o in oys])
    bx = torch.cat([mb_c * 16 + o for o in oxs])
    n = by.shape[0]
    origs = ki.gather_blocks(orig_y.to(I32), by, bx, bh, bw)
    lam = int(lam)

    def cost_at(mv_q):
        pred = ki.mc_luma(planes, by + pad, bx + pad, mv_q, bh=bh, bw=bw)
        diff = origs - pred
        blk = diff.reshape(n, bh // 4, 4, bw // 4, 4).permute(0, 1, 3, 2, 4)
        return kt.satd4x4(blk).sum(dim=(1, 2), dtype=I32) + lam * mv_cost(mv_q)

    def refine(mv_q, step: int):
        best_cost = cost_at(mv_q)
        best_mv = mv_q
        for dy in (-step, 0, step):
            for dx in (-step, 0, step):
                if dy == 0 and dx == 0:
                    continue
                cand = torch.stack([mv_q[:, 0] + dy, mv_q[:, 1] + dx], dim=1)
                cost = cost_at(cand)
                better = cost < best_cost
                best_mv = torch.where(better[:, None], cand, best_mv)
                best_cost = torch.minimum(cost, best_cost)
        return best_mv

    mv_q = mv_int.to(I32) * 4
    mv_q = refine(mv_q, 2)
    mv_q = refine(mv_q, 1)
    return mv_q

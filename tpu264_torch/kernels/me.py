"""Full-search + sub-pel motion estimation (torch), counterpart of
`tpu264.kernels.me` for the 16x16 partition.

All macroblocks search in parallel.  The reference writes the candidate
sweep as SSD(dy,dx) = sum(W^2) - 2*corr(W, O) + sum(O^2) with float32
convolutions, exact because every intermediate sum is an integer below
2^24; here the same SSD is summed directly in int32, one row of offsets
at a time, so no float precision mode of the card can change a decision.

Sub-pel refinement: the 8 half-pel neighbours of the best integer
position, then the 8 quarter-pel neighbours of the best half position,
with SATD + lambda * mv-rate cost.
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


def full_search_16x16(orig_y, ref_pad, pad: int, search_range: int,
                      lam: int, width_mbs: int, height_mbs: int):
    """Integer full search for every MB of a frame at once.

    orig_y: [H, W]; ref_pad: [H+2p, W+2p] edge-padded reference.
    Returns mv_int [nMB, 2] (full-pel, y/x) and its cost [nMB] (SSD +
    lam * bits of the mv against (0, 0)), int32.  Of equal costs the first
    in (dy, dx) raster order wins.
    """
    r = search_range
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
    ssd = torch.stack(
        [((runs[:, dy:dy + 16] - o) ** 2).sum(dim=(1, 3), dtype=I32)
         for dy in range(span)], dim=1)              # [n, span(dy), span(dx)]

    # mv-rate prior centered on (0,0) (the wavefront pass re-rates
    # against the true predictor)
    bits = torch.as_tensor(mv_bits_table(r), dtype=I32, device=dev)
    cost = ssd + int(lam) * (bits[None, :, None] + bits[None, None, :])
    flat = cost.reshape(n, -1)
    best = torch.argmin(flat, dim=1)
    mv = torch.stack([best // span - r, best % span - r], dim=1).to(I32)
    return mv, flat.amin(dim=1)


def subpel_refine(orig_y, planes, pad: int, mv_int, lam: int,
                  width_mbs: int, height_mbs: int,
                  oy: int = 0, ox: int = 0, bh: int = 16, bw: int = 16):
    """Half- then quarter-pel refinement with SATD cost.

    mv_int: [nMB, 2] full-pel. Returns mv_q [nMB, 2] quarter-pel.
    (oy, ox, bh, bw) select a partition of each MB (default: whole MB).
    A candidate replaces the best so far only where it is strictly
    cheaper, in the fixed order dy, dx over (-step, 0, step).
    """
    n = width_mbs * height_mbs
    dev = orig_y.device
    mb_r, mb_c = _mb_origins(width_mbs, height_mbs, dev)
    y0 = mb_r * 16 + oy + pad
    x0 = mb_c * 16 + ox + pad
    origs = ki.gather_blocks(orig_y.to(I32), mb_r * 16 + oy, mb_c * 16 + ox,
                             bh, bw)
    lam = int(lam)

    def cost_at(mv_q):
        pred = ki.mc_luma(planes, y0, x0, mv_q, bh=bh, bw=bw)
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

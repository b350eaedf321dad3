"""Macroblock-layer syntax tables and vectorized helpers (spec 7.3.5/7.4.5).

JM parity: `macroblock.c` writeMBLayer / `vlc.c` (SURVEY.md §2a #5, #14).
Everything here is host-side numpy operating on whole-frame per-MB arrays.
"""

from __future__ import annotations

import numpy as np

# coded_block_pattern me(v) mapping, spec Table 9-4 (codeNum → cbp)
CODENUM_TO_CBP_INTRA = np.array(
    [47, 31, 15, 0, 23, 27, 29, 30, 7, 11, 13, 14, 39, 43, 45, 46, 16, 3,
     5, 10, 12, 19, 21, 26, 28, 35, 37, 42, 44, 1, 2, 4, 8, 17, 18, 20,
     24, 6, 9, 22, 25, 32, 33, 34, 36, 40, 38, 41], dtype=np.int64)
CODENUM_TO_CBP_INTER = np.array(
    [0, 16, 1, 2, 4, 8, 32, 3, 5, 10, 12, 15, 47, 7, 11, 13, 14, 6, 9, 31,
     35, 37, 42, 44, 33, 34, 36, 40, 39, 43, 45, 46, 17, 18, 20, 24, 19,
     21, 26, 28, 23, 27, 29, 30, 22, 25, 38, 41], dtype=np.int64)

CBP_TO_CODENUM_INTRA = np.zeros(48, dtype=np.int64)
CBP_TO_CODENUM_INTRA[CODENUM_TO_CBP_INTRA] = np.arange(48)
CBP_TO_CODENUM_INTER = np.zeros(48, dtype=np.int64)
CBP_TO_CODENUM_INTER[CODENUM_TO_CBP_INTER] = np.arange(48)


def mb_type_i(sel16: np.ndarray, i16mode: np.ndarray, cbp_chroma: np.ndarray,
              cbp_luma_ac: np.ndarray) -> np.ndarray:
    """I-slice mb_type (spec Table 7-11): 0 = I_4x4, 1..24 = I_16x16."""
    t16 = 1 + i16mode + 4 * cbp_chroma + 12 * (cbp_luma_ac > 0)
    return np.where(sel16, t16, 0)


def compute_cbp(sel16, luma_ac, chroma_dc, chroma_ac):
    """Derive coded_block_pattern parts from levels.

    luma_ac: [n,16,16] scanned levels (zig-zag block order; for I16x16 MBs
      position 0 of each block is already zero).
    Returns (cbp_luma [n] 4-bit, cbp_chroma [n] 0..2, full cbp [n]).
    """
    nz_blk = (luma_ac != 0).any(axis=2)          # [n,16]
    nz8 = nz_blk.reshape(-1, 4, 4).any(axis=2)   # [n,4] per 8x8 (zz groups)
    cbp_luma = (nz8 << np.arange(4)).sum(axis=1)
    # I16x16: luma AC is all-or-nothing
    cbp_luma = np.where(sel16 & (cbp_luma > 0), 15, cbp_luma)
    any_dc = (chroma_dc != 0).any(axis=(1, 2))
    any_ac = (chroma_ac != 0).any(axis=(1, 2, 3))
    cbp_chroma = np.where(any_ac, 2, np.where(any_dc, 1, 0))
    return cbp_luma, cbp_chroma, cbp_luma | (cbp_chroma << 4)


def luma_tc_grid(sel16, cbp_luma, luma_ac, width_mbs, height_mbs):
    """[h4, w4] per-4x4-block TotalCoeff map for nC derivation (spec 9.2.1).

    Blocks whose 8x8 (or I16x16 AC flag) is uncoded count as 0.
    """
    n = sel16.shape[0]
    tc = (luma_ac != 0).sum(axis=2)              # [n,16]
    coded8 = ((cbp_luma[:, None] >> np.arange(4)[None, :]) & 1) > 0  # [n,4]
    coded = np.repeat(coded8, 4, axis=1)          # zz idx grouping
    tc = np.where(coded, tc, 0)
    from tpu264_torch.coding.wavefront import BLK_ORDER
    grid = np.zeros((height_mbs * 4, width_mbs * 4), dtype=np.int64)
    mb_r = np.arange(n) // width_mbs
    mb_c = np.arange(n) % width_mbs
    for idx, (by, bx) in enumerate(BLK_ORDER):
        grid[mb_r * 4 + by, mb_c * 4 + bx] = tc[:, idx]
    return grid


def chroma_tc_grid(cbp_chroma, chroma_ac, comp, width_mbs, height_mbs):
    """[h2, w2] chroma 4x4 TotalCoeff map for one component."""
    n = cbp_chroma.shape[0]
    tc = (chroma_ac[:, comp] != 0).sum(axis=2)   # [n,4] raster blocks
    tc = np.where((cbp_chroma == 2)[:, None], tc, 0)
    grid = np.zeros((height_mbs * 2, width_mbs * 2), dtype=np.int64)
    mb_r = np.arange(n) // width_mbs
    mb_c = np.arange(n) % width_mbs
    for idx in range(4):
        by, bx = idx // 2, idx % 2
        grid[mb_r * 2 + by, mb_c * 2 + bx] = tc[:, idx]
    return grid


def nc_from_grid(tc_grid, blocks_per_mb_side, slice_start_rows, avail_override=None):
    """nC per block position from a TotalCoeff grid (spec 9.2.1).

    slice_start_rows: block-row indices where a new slice starts (neighbors
    above are unavailable there).
    Returns [gh, gw] nC values.
    """
    gh, gw = tc_grid.shape
    na = np.zeros_like(tc_grid)
    nb = np.zeros_like(tc_grid)
    na[:, 1:] = tc_grid[:, :-1]
    nb[1:, :] = tc_grid[:-1, :]
    avail_a = np.zeros((gh, gw), dtype=bool)
    avail_a[:, 1:] = True
    avail_b = np.zeros((gh, gw), dtype=bool)
    avail_b[1:, :] = True
    for r in slice_start_rows:
        avail_b[r, :] = False
    both = avail_a & avail_b
    nc = np.where(both, (na + nb + 1) >> 1,
                  np.where(avail_a, na, np.where(avail_b, nb, 0)))
    return nc


def mpm_grid(modes_grid, slice_start_rows4):
    """Most-probable-mode per 4x4 block (spec 8.3.1.1).

    modes_grid: [h4, w4] intra modes, -1 where the MB is not Intra_4x4
    (but IS available).  Rule (matches ffmpeg pred_intra_mode): if either
    neighbor block is UNAVAILABLE the MPM is DC; an available neighbor not
    coded Intra_4x4 counts as DC on its side only.
    Returns [h4, w4] MPM values.
    """
    gh, gw = modes_grid.shape
    unavail = -2
    left = np.full((gh, gw), unavail, dtype=np.int64)
    top = np.full((gh, gw), unavail, dtype=np.int64)
    left[:, 1:] = modes_grid[:, :-1]
    top[1:, :] = modes_grid[:-1, :]
    for r in slice_start_rows4:
        top[r, :] = unavail
    a = np.where(left == -1, 2, left)
    b = np.where(top == -1, 2, top)
    return np.where((a < 0) | (b < 0), 2, np.minimum(a, b))

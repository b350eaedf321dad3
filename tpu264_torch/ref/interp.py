"""Luma quarter-pel / chroma eighth-pel interpolation — scalar reference.

Spec 8.4.2.2.1/8.4.2.2.2; JM parity: `img_luma.c`/`img_chroma.c` plane
precomputation + `mc_prediction.c` get_block (SURVEY.md §2a #11).  The JM
strategy — precompute half-pel planes per reference frame, then quarter
positions are single averages — maps perfectly onto TPU bulk compute, so
the reference implements the same plane decomposition the kernels use:

planes G (integer), b (horizontal half), h (vertical half), j (center),
all sampled on the integer grid; a quarter position (fx, fy) in {0..3}^2
is either one plane sample or the (+1)>>1 average of two (possibly
shifted) plane samples.
"""

from __future__ import annotations

import numpy as np

# 6-tap half-pel filter (1,-5,20,20,-5,1)/32
TAPS = np.array([1, -5, 20, 20, -5, 1], dtype=np.int64)

# (fx, fy) → (plane1, dx1, dy1, plane2, dx2, dy2, is_avg); planes 0=G 1=b 2=h 3=j
QPEL_TABLE = {
    (0, 0): (0, 0, 0, 0, 0, 0, 0),
    (1, 0): (0, 0, 0, 1, 0, 0, 1),
    (2, 0): (1, 0, 0, 0, 0, 0, 0),
    (3, 0): (1, 0, 0, 0, 1, 0, 1),
    (0, 1): (0, 0, 0, 2, 0, 0, 1),
    (1, 1): (1, 0, 0, 2, 0, 0, 1),
    (2, 1): (1, 0, 0, 3, 0, 0, 1),
    (3, 1): (1, 0, 0, 2, 1, 0, 1),
    (0, 2): (2, 0, 0, 0, 0, 0, 0),
    (1, 2): (2, 0, 0, 3, 0, 0, 1),
    (2, 2): (3, 0, 0, 0, 0, 0, 0),
    (3, 2): (3, 0, 0, 2, 1, 0, 1),
    (0, 3): (2, 0, 0, 0, 0, 1, 1),
    (1, 3): (2, 0, 0, 1, 0, 1, 1),
    (2, 3): (3, 0, 0, 1, 0, 1, 1),
    (3, 3): (1, 0, 1, 2, 1, 0, 1),
}


def pad_plane(plane: np.ndarray, pad: int) -> np.ndarray:
    """Edge-replicate padding (spec clips reference coordinates — identical
    effect for motion vectors within +-pad)."""
    return np.pad(np.asarray(plane, dtype=np.int64), pad, mode="edge")


def half_pel_planes(g: np.ndarray):
    """Compute (b, h, j) half-pel planes from (padded) integer plane g.

    Returns int64 arrays of the same shape as g; border samples (within 2
    of the edge) use whatever the padding provides — callers must pad
    enough that real accesses never need them.
    """
    g = np.asarray(g, dtype=np.int64)
    hh, ww = g.shape
    # horizontal intermediate b1[y][x] = sum taps * g[y][x-2 .. x+3]
    b1 = np.zeros_like(g)
    for k in range(6):
        sh = k - 2
        b1 += TAPS[k] * np.roll(g, -sh, axis=1)
    # vertical intermediate h1
    h1 = np.zeros_like(g)
    for k in range(6):
        sh = k - 2
        h1 += TAPS[k] * np.roll(g, -sh, axis=0)
    # center: vertical 6-tap over the horizontal intermediates
    j1 = np.zeros_like(g)
    for k in range(6):
        sh = k - 2
        j1 += TAPS[k] * np.roll(b1, -sh, axis=0)
    b = np.clip((b1 + 16) >> 5, 0, 255)
    h = np.clip((h1 + 16) >> 5, 0, 255)
    j = np.clip((j1 + 512) >> 10, 0, 255)
    return b, h, j


def mc_luma_block(planes, y0: int, x0: int, mv_y: int, mv_x: int,
                  bh: int = 16, bw: int = 16) -> np.ndarray:
    """Motion-compensated luma block from precomputed padded planes.

    planes: (G, b, h, j) all padded by `pad`; y0/x0 are PADDED-grid
    coordinates of the block origin; mv in quarter-pel units.
    """
    iy, ix = mv_y >> 2, mv_x >> 2
    fy, fx = mv_y & 3, mv_x & 3
    p1, dx1, dy1, p2, dx2, dy2, avg = QPEL_TABLE[(fx, fy)]
    base_y, base_x = y0 + iy, x0 + ix
    a = planes[p1][base_y + dy1: base_y + dy1 + bh,
                   base_x + dx1: base_x + dx1 + bw]
    if not avg:
        return a.copy()
    b = planes[p2][base_y + dy2: base_y + dy2 + bh,
                   base_x + dx2: base_x + dx2 + bw]
    return (a + b + 1) >> 1


def mc_luma_oracle(g_pad: np.ndarray, y0: int, x0: int, mv_y: int, mv_x: int,
                   bh: int = 16, bw: int = 16) -> np.ndarray:
    """Direct (plane-free) spec 8.4.2.2.1 computation for testing."""
    planes = (g_pad,) + half_pel_planes(g_pad)
    return mc_luma_block(planes, y0, x0, mv_y, mv_x, bh, bw)


def mc_chroma_block(c_pad: np.ndarray, y0: int, x0: int, mv_y: int,
                    mv_x: int, bh: int = 8, bw: int = 8) -> np.ndarray:
    """Chroma eighth-pel bilinear MC (spec 8.4.2.2.2); mv in luma
    quarter-pel units (= chroma eighth-pel)."""
    iy, ix = mv_y >> 3, mv_x >> 3
    fy, fx = mv_y & 7, mv_x & 7
    by, bx = y0 + iy, x0 + ix
    a = c_pad[by:by + bh, bx:bx + bw]
    b = c_pad[by:by + bh, bx + 1:bx + 1 + bw]
    c = c_pad[by + 1:by + 1 + bh, bx:bx + bw]
    d = c_pad[by + 1:by + 1 + bh, bx + 1:bx + 1 + bw]
    return ((8 - fx) * (8 - fy) * a + fx * (8 - fy) * b
            + (8 - fx) * fy * c + fx * fy * d + 32) >> 6

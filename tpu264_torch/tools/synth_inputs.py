"""Seeded numpy inputs for the port's kernels, shared by the tests and by
`chip_smoke.py`: random and hand-steered CABAC record sequences for K1,
macroblock lanes for the I4x4 wave kernel (K2), whole waves with their
border buffers for the wave body (K2 + K3), P waves with their motion
vector maps and reference picture for the P wave body (KP), with the
partitions' vectors for its default tools, B waves with both lists' maps,
references and colocated flags for the B wave body (KB), pictures
with mixed intra and inter macroblocks for the deblocker (K4), and the
decoder's form of them (per-MB QPs, filter offsets, slice edges in the
middle of a row, the 8x8 transform, two-list motion),
raster MB dicts of I and P frames for the entropy coders' front ends
(the CAVLC serializer, the CABAC binarizer), and the fading frames that
weighted prediction is for.  numpy only."""

from __future__ import annotations

import numpy as np


# the recipe of `fade_frames`, as the golden file records it
FADE = ("natural_frame(w, h, t) with its luma scaled by (1 - 0.06 t) in "
        "float64, clipped to 0-255, astype(uint8), for t = 0 .. n - 1")


def fade_frames(width: int, height: int, n: int) -> list:
    """n frames of a fade to black (`FADE`): the input of the reference's
    weighted-prediction test (`tests/test_ippp.py`), (y, u, v) uint8."""
    from tpu264_torch.media.synth import natural_frame
    out = []
    for t in range(n):
        y, u, v = natural_frame(width, height, t)
        out.append((np.clip(y.astype(np.float64) * (1 - 0.06 * t), 0,
                            255).astype(np.uint8), u, v))
    return out


def random_i4x4_lanes(seed, reps=2):
    """numpy inputs of `eval_i4x4` (orig, ltop, lleft, modes_top,
    modes_left, at, al, atl, atr) for 16 * reps lanes: every combination of
    the four MB availability flags `reps` times, neighbour modes over
    -2..8, and noise, smooth and flat content in turn (flat lanes make
    every valid mode cost the same, so ties decide)."""
    r = np.random.default_rng(seed)
    b = 16 * reps
    combos = np.array([[(i >> k) & 1 for k in range(4)] for i in range(16)],
                      bool)
    at, al, atl, atr = np.tile(combos, (reps, 1)).T.copy()
    orig = r.integers(0, 256, size=(b, 16, 16))
    ltop = r.integers(0, 256, size=(b, 25))
    lleft = r.integers(0, 256, size=(b, 16))
    for i in range(b):
        if i % 3 == 1:          # smooth: a ramp plus a little noise
            base = int(r.integers(20, 200))
            gx, gy = r.integers(-3, 4, size=2)
            ramp = base + gx * np.arange(-1, 24) + 0 * gy
            ltop[i] = np.clip(ramp + r.integers(-2, 3, size=25), 0, 255)
            lleft[i] = np.clip(base - gx + gy * np.arange(1, 17)
                               + r.integers(-2, 3, size=16), 0, 255)
            orig[i] = np.clip(base + gx * np.arange(16)[None, :]
                              + gy * np.arange(1, 17)[:, None]
                              + r.integers(-2, 3, size=(16, 16)), 0, 255)
        elif i % 3 == 2:        # flat
            v = int(r.integers(0, 256))
            orig[i], ltop[i], lleft[i] = v, v, v
    modes_top = r.integers(-2, 9, size=(b, 4))
    modes_left = r.integers(-2, 9, size=(b, 4))
    return orig, ltop, lleft, modes_top, modes_left, at, al, atl, atr


def random_wave(seed, wm, hm, n_pad=2):
    """One wave of the intra wave body on a wm x hm picture, as numpy:
    (bd, coords, avail, gy, gu, gv).  `bd` holds the eight border buffers
    of `init_border_buffers` filled with random samples and neighbour modes
    over -2..8; the lanes are the MBs (r, c = d - 2r) of the fullest
    anti-diagonal d = 2 (hm - 1), smooth, flat and striped content in turn,
    their four availability flags running through all 16 combinations
    (from a start that the seed picks), followed by `n_pad` padding lanes
    at (hm, 0) with no neighbour available and, as in the wave loop, all
    with the same source tile (they write the same border rows)."""
    r = np.random.default_rng(seed)
    w = wm * 16
    bd = dict(row_y=r.integers(0, 256, size=(hm + 2, 1 + w + 8)),
              col_y=r.integers(0, 256, size=(hm + 1, 16)),
              row_u=r.integers(0, 256, size=(hm + 2, 1 + w // 2 + 8)),
              col_u=r.integers(0, 256, size=(hm + 1, 8)),
              row_v=r.integers(0, 256, size=(hm + 2, 1 + w // 2 + 8)),
              col_v=r.integers(0, 256, size=(hm + 1, 8)),
              modes_row=r.integers(-2, 9, size=(hm + 2, 1 + wm * 4 + 4)),
              modes_col=r.integers(-2, 9, size=(hm + 1, 4)))
    d = 2 * (hm - 1)
    lanes = [(rr, d - 2 * rr) for rr in range(hm) if 0 <= d - 2 * rr < wm]
    coords = np.array(lanes + [(hm, 0)] * n_pad, np.int32)
    b = len(coords)
    combos = (np.arange(int(r.integers(0, 16)), 16 + b)[:b, None]
              >> np.arange(4)) & 1
    avail = combos.astype(bool)
    avail[len(lanes):] = False
    gy = r.integers(0, 256, size=(b, 16, 16))
    gu = r.integers(0, 256, size=(b, 8, 8))
    gv = r.integers(0, 256, size=(b, 8, 8))
    for g in (gy, gu, gv):      # the padding lanes hold one and the same tile
        g[len(lanes):] = g[len(lanes)]
    for i, (rr, cc) in enumerate(lanes):
        if i % 3 == 2:
            # Intra4x4 territory: columns of one value above, rows of one
            # value below, which no single 16x16 mode predicts
            gy[i, :8] = r.integers(0, 256, size=(1, 16))
            gy[i, 8:] = r.integers(0, 256, size=(8, 1))
            continue
        base = int(r.integers(30, 200))
        gx, gyy = (0, 0) if i % 3 == 1 else r.integers(-2, 3, size=2)
        ramp = lambda n, x0: (base + gx * (np.arange(n)[None, :] + x0)
                              + gyy * np.arange(n)[:, None])
        noise = 0 if i % 3 == 1 else r.integers(-1, 2, size=(16, 16))
        gy[i] = np.clip(ramp(16, 0) + noise, 0, 255)
        gu[i] = np.clip(ramp(8, 0) // 2 + 60, 0, 255)
        gv[i] = np.clip(200 - ramp(8, 0) // 2, 0, 255)
        # the neighbours' borders continue the ramp, so that the smooth
        # lanes choose among the I16x16 and chroma modes in earnest
        bd["row_y"][rr, 16 * cc:16 * cc + 25] = np.clip(
            base + gx * np.arange(-1, 24) - gyy, 0, 255)
        bd["col_y"][rr] = np.clip(base - gx + gyy * np.arange(16), 0, 255)
        bd["row_u"][rr, 8 * cc:8 * cc + 9] = np.clip(
            (base + gx * np.arange(-1, 8) - gyy) // 2 + 60, 0, 255)
        bd["col_u"][rr] = np.clip(
            (base - gx + gyy * np.arange(8)) // 2 + 60, 0, 255)
    return bd, coords, avail, gy, gu, gv


def random_p_wave(seed, wm, hm, n_pad=2, pad=24):
    """One wave of the P wave body on a wm x hm picture, as numpy: (bd,
    mv_map, ref_map, ref_y, ref_u, ref_v, coords, avail, mv_me, gy, gu, gv).
    The lanes, border buffers and padding lanes are `random_wave`'s; the
    maps [3, hm+2, wm+2, (2)] hold the neighbours' vectors and codes (-2
    outside the slice, -1 intra, 0 inter), and the reference picture is
    smooth content with noise (the caller pads it by `pad` and builds the
    half-pel planes).  The lanes take four kinds in turn: neighbours A, B, C
    that agree on a whole-sample vector which also is the lane's search
    vector, with the source tile copied from the reference there (skip or
    inter wins, and the skip vector equals the search vector where the
    neighbours are available); random neighbours and vectors; neighbours at
    (0, 0), so that the skip vector is zero, with the source copied from
    the reference in place; and whole-sample search vectors that reach past
    the padded plane's edges, where the reads are clamped, with the source
    copied from the clamped blocks."""
    bd, coords, avail, gy, gu, gv = random_wave(seed, wm, hm, n_pad)
    r = np.random.default_rng(seed + 1000)
    h, w = hm * 16, wm * 16
    yy, xx = np.mgrid[0:h, 0:w]
    ref_y = np.clip(120 + 60 * np.sin(xx / 13.0 + seed) * np.cos(yy / 11.0)
                    + r.integers(-4, 5, size=(h, w)), 0, 255)
    ref_u = np.clip(128 + 40 * np.sin(xx[::2, ::2] / 9.0)
                    + r.integers(-3, 4, size=(h // 2, w // 2)), 0, 255)
    ref_v = np.clip(128 + 40 * np.cos(yy[::2, ::2] / 7.0)
                    + r.integers(-3, 4, size=(h // 2, w // 2)), 0, 255)
    mv_map = r.integers(-48, 49, size=(3, hm + 2, wm + 2, 2))
    ref_map = r.integers(-2, 1, size=(3, hm + 2, wm + 2))
    b = len(coords)
    n_lanes = b - n_pad
    mv_me = r.integers(-40, 41, size=(b, 2))
    padded = [np.pad(p, q, mode="edge")
              for p, q in ((ref_y, pad), (ref_u, pad // 2), (ref_v, pad // 2))]

    def copy_block(i, rr, cc, v):
        """Source tiles of lane i := the reference's blocks at the
        whole-sample vector v (quarter-pel units, a multiple of 8), each
        start clamped into the padded plane as the block reads are."""
        for g, pl, n, unit in ((gy, padded[0], 16, 4), (gu, padded[1], 8, 8),
                               (gv, padded[2], 8, 8)):
            s0 = [(rr, cc)[k] * n + pad * n // 16 + v[k] // unit
                  for k in range(2)]
            s0 = [min(max(x + (pl.shape[k] if x < 0 else 0), 0),
                      pl.shape[k] - n - (unit == 8)) for k, x in enumerate(s0)]
            g[i] = np.clip(pl[s0[0]:s0[0] + n, s0[1]:s0[1] + n]
                           + r.integers(-1, 2, size=(n, n)), 0, 255)

    for i in range(n_lanes):
        rr, cc = (int(v) for v in coords[i])
        cells = [(0, rr + 1, cc), (1, rr, cc + 1), (1, rr, cc + 2),
                 (2, rr, cc)]                       # A, B, C, D
        kind = (i + i // 4) % 4     # kinds and availability out of step
        if kind == 0:
            v = 8 * r.integers(-3, 4, size=2)       # whole chroma samples
            for cell in cells[:3]:
                mv_map[cell] = v
                ref_map[cell] = 0
            mv_me[i] = v
            copy_block(i, rr, cc, v)
        elif kind == 2:
            for cell in cells:
                mv_map[cell] = 0
                ref_map[cell] = 0
            copy_block(i, rr, cc, (0, 0))
        elif kind == 3:
            # starts before the plane's first row or column, or past its
            # last: a whole-sample vector, whose block is the source
            y0, x0 = rr * 16 + pad, cc * 16 + pad
            hp, wp = h + 2 * pad, w + 2 * pad
            up = i % 2 == 0
            v = (-8 * (y0 // 2 + 3) if up else 8 * ((hp - y0) // 2 + 1),
                 8 * ((wp - x0) // 2 + 2) if up else -8 * (x0 // 2 + 5))
            mv_me[i] = v
            copy_block(i, rr, cc, v)
    mv_me[n_lanes:] = mv_me[n_lanes]
    return (bd, mv_map, ref_map, ref_y, ref_u, ref_v, coords, avail, mv_me,
            gy, gu, gv)


def random_p_wave_tools(seed, wm, hm, n_pad=2, pad=24):
    """`random_p_wave`'s wave with the partitions' own vectors: (bd,
    mv_map, ref_map, ref_y, ref_u, ref_v, coords, avail, mv_me, gy, gu, gv,
    mv_parts [B, 8, 2]), mv_parts in `kernels.p_wave.PARTS` order (top,
    bot, left, right, q0..q3), quarter-pel.  The partitions' vectors are
    random, but every third lane takes a source tile built from the
    reference by halves or quadrants, in turn: the top and bottom halves
    at two whole-sample vectors (a 16x8 prediction matches), the left and
    right halves (8x16), the four quadrants at four vectors (P_8x8), each
    vector given to its partition and each block start clamped as the
    reads are; and every third lane of the rest whose source is a copy of
    the reference at its search vector gains a smooth ramp, a residual
    that the 8x8 transform codes in fewer bits."""
    (bd, mv_map, ref_map, ref_y, ref_u, ref_v, coords, avail, mv_me, gy, gu,
     gv) = random_p_wave(seed, wm, hm, n_pad, pad)
    r = np.random.default_rng(seed + 2000)
    b = len(coords)
    mv_parts = r.integers(-40, 41, size=(b, 8, 2))
    plane = np.pad(ref_y, pad, mode="edge")
    shapes = {1: ((0, 0, 8, 16), (8, 0, 8, 16)),          # top, bot
              2: ((0, 0, 16, 8), (0, 8, 16, 8)),          # left, right
              3: tuple((8 * (q // 2), 8 * (q % 2), 8, 8) for q in range(4))}
    slot0 = {1: 0, 2: 2, 3: 4}
    yy, xx = np.mgrid[0:16, 0:16]
    for i in range(b - n_pad):
        rr, cc = (int(v) for v in coords[i])
        if i % 3 == 1:
            ptype = 1 + (i // 3) % 3
            for k, (oy, ox, bh, bw) in enumerate(shapes[ptype]):
                v = 4 * r.integers(-12, 13, size=2)      # whole samples
                mv_parts[i, slot0[ptype] + k] = v
                s0 = [rr * 16 + pad + oy + v[0] // 4,
                      cc * 16 + pad + ox + v[1] // 4]
                s0 = [min(max(x + (plane.shape[d] if x < 0 else 0), 0),
                          plane.shape[d] - n)
                      for d, (x, n) in enumerate(zip(s0, (bh, bw)))]
                gy[i, oy:oy + bh, ox:ox + bw] = np.clip(
                    plane[s0[0]:s0[0] + bh, s0[1]:s0[1] + bw]
                    + r.integers(-1, 2, size=(bh, bw)), 0, 255)
        elif i % 3 == 2 and (i + i // 4) % 4 in (0, 2):
            # a source copied at the search vector: add a smooth ramp
            ramp = np.round(6 * np.sin((xx + 2 * yy) / 9.0 + i)).astype(int)
            gy[i] = np.clip(gy[i] + ramp, 0, 255)
    return (bd, mv_map, ref_map, ref_y, ref_u, ref_v, coords, avail, mv_me,
            gy, gu, gv, mv_parts)


def _clamped_block(plane, y, x, bh, bw):
    """The bh x bw block of `plane` at (y, x), the start clamped as
    `jax.lax.dynamic_slice` clamps it."""
    y = min(max(y + (plane.shape[0] if y < 0 else 0), 0), plane.shape[0] - bh)
    x = min(max(x + (plane.shape[1] if x < 0 else 0), 0), plane.shape[1] - bw)
    return plane[y:y + bh, x:x + bw]


def random_b_wave(seed, wm, hm, n_pad=2, pad=24):
    """One wave of the B wave body on a wm x hm picture, as numpy: (bd,
    maps, ref0, ref1, coords, avail, mv_me0, mv_me1, mv_parts0, mv_parts1,
    colzero, colmixed, gy, gu, gv): maps = (mv0_map, ref0_map, mv1_map,
    ref1_map) [3, hm+2, wm+2, (2)] (-2 outside the slice, -1 intra or list
    unused, 0 used); ref0, ref1 = (y, u, v) pictures of smooth content with
    noise, which the caller pads by `pad`; the halves' vectors mv_parts
    [B, 4, 2] (top, bot, left, right), quarter-pel; colzero, colmixed [B].

    The lanes, border buffers and padding lanes are `random_wave`'s.  The
    lanes' kinds run in turn (from a start the seed picks) through: a source
    copied from reference 0 at its search vector (L0 wins), from reference 1
    (L1), the rounded mean of both (Bi), the direct prediction of
    neighbours that agree on each list's vector (direct), the same over a
    still colocated MB (colzero: the direct vectors are zero), random
    content, and the 18 two-partition sources: each shape (16x8, 8x16)
    with each (c0, c1) of L0, L1, Bi, every half built from its own
    vectors.  Every fifth lane is colmixed.  Search vectors are whole
    samples, some reaching past the padded planes' edges."""
    bd, coords, avail, gy, gu, gv = random_wave(seed, wm, hm, n_pad)
    r = np.random.default_rng(seed + 3000)
    h, w = hm * 16, wm * 16
    yy, xx = np.mgrid[0:h, 0:w]
    refs = []
    for k in range(2):
        refs.append(tuple(
            np.clip(base + r.integers(-3, 4, size=base.shape), 0, 255)
            for base in (120 + 60 * np.sin(xx / (13.0 + 4 * k) + seed)
                         * np.cos(yy / (11.0 - 3 * k)),
                         128 + 40 * np.sin(xx[::2, ::2] / (9.0 + k)),
                         128 + 40 * np.cos(yy[::2, ::2] / (7.0 + k)))))
    padded = [[np.pad(p, q, mode="edge")
               for p, q in zip(ref, (pad, pad // 2, pad // 2))]
              for ref in refs]
    b = len(coords)
    n_lanes = b - n_pad
    maps = []
    for _ in range(2):
        maps += [r.integers(-48, 49, size=(3, hm + 2, wm + 2, 2)),
                 r.integers(-2, 1, size=(3, hm + 2, wm + 2))]
    mv_me = [8 * r.integers(-3, 4, size=(b, 2)) for _ in range(2)]
    mv_parts = [4 * r.integers(-10, 11, size=(b, 4, 2)) for _ in range(2)]
    colzero = r.random(b) < 0.2
    colmixed = (np.arange(b) % 5) == 4

    def pred(lx, rr, cc, v, oy=0, ox=0, bh=16, bw=16):
        """Reference lx's luma and chroma blocks of the (whole-sample,
        multiple of 8) vector v for the block at (oy, ox) of MB (rr, cc)."""
        y, u, vv = padded[lx]
        ly = rr * 16 + pad + oy + v[0] // 4
        lx_ = cc * 16 + pad + ox + v[1] // 4
        cy, cx = (rr * 8 + pad // 2 + oy // 2 + v[0] // 8,
                  cc * 8 + pad // 2 + ox // 2 + v[1] // 8)
        return (_clamped_block(y, ly, lx_, bh, bw).astype(np.int64),
                _clamped_block(u, cy, cx, bh // 2, bw // 2).astype(np.int64),
                _clamped_block(vv, cy, cx, bh // 2, bw // 2).astype(np.int64))

    def put(i, blocks, oy=0, ox=0):
        for g, blk, s in ((gy, blocks[0], 1), (gu, blocks[1], 2),
                          (gv, blocks[2], 2)):
            bh, bw = blk.shape
            g[i, oy // s:oy // s + bh, ox // s:ox // s + bw] = np.clip(
                blk + r.integers(-1, 2, size=blk.shape), 0, 255)

    def choose(c, lx_blocks):
        a, bb = lx_blocks
        if c < 2:
            return (a, bb)[c]
        return tuple((x + y + 1) >> 1 for x, y in zip(a, bb))

    kinds = ["l0", "l1", "bi", "direct", "colzero", "random"] + [
        (s, c0, c1) for s in (1, 2) for c0 in range(3) for c1 in range(3)]
    start = int(r.integers(0, len(kinds)))
    for i in range(n_lanes):
        rr, cc = (int(v) for v in coords[i])
        kind = kinds[(start + i) % len(kinds)]
        if kind in ("l0", "l1", "bi"):
            if i % 4 == 3:
                # a list-0 start past the plane's edges, clamped
                mv_me[0][i] = (-8 * (rr * 8 + pad // 2 + 3),
                               8 * ((w + pad - cc * 16) // 2 + 2))
            blocks = [pred(lx, rr, cc, mv_me[lx][i]) for lx in range(2)]
            put(i, choose(("l0", "l1", "bi").index(kind), blocks))
        elif kind in ("direct", "colzero"):
            v = [8 * r.integers(-3, 4, size=2) for _ in range(2)]
            cells = [(0, rr + 1, cc), (1, rr, cc + 1), (1, rr, cc + 2),
                     (2, rr, cc)]                   # A, B, C, D
            for lx in range(2):
                for cell in cells:
                    maps[2 * lx][cell] = v[lx]
                    maps[2 * lx + 1][cell] = 0
            colzero[i] = kind == "colzero"
            colmixed[i] = False
            if colzero[i] or not avail[i, :2].any():
                v = [np.zeros(2, np.int64)] * 2
            put(i, choose(2, [pred(lx, rr, cc, v[lx]) for lx in range(2)]))
        elif isinstance(kind, tuple):
            shape, c0, c1 = kind
            halves = ((0, 1), (2, 3))[shape - 1]
            for c, k in zip((c0, c1), halves):
                oy, ox, bh, bw = ((0, 0, 8, 16), (8, 0, 8, 16),
                                  (0, 0, 16, 8), (0, 8, 16, 8))[k]
                blocks = [pred(lx, rr, cc, mv_parts[lx][i, k], oy, ox, bh, bw)
                          for lx in range(2)]
                put(i, choose(c, blocks), oy, ox)
    for a in mv_me + mv_parts:
        a[n_lanes:] = a[n_lanes]
    return (bd, tuple(maps), refs[0], refs[1], coords, avail, mv_me[0],
            mv_me[1], mv_parts[0], mv_parts[1], colzero, colmixed, gy, gu, gv)


def _levels(r, shape, density):
    """Sparse levels: mostly small, a few large."""
    lev = r.integers(-3, 4, size=shape) * (r.random(shape) < density)
    big = r.random(shape) < density / 20
    return np.where(big, r.integers(-300, 301, size=shape), lev)


def random_mbs(seed, wm, hm, p_slice=True, tools=("ptype", "mvq", "t8")):
    """A seeded raster MB dict of a wm x hm frame, numpy: intra (I16x16 and
    I4x4) and, in a P frame, inter MBs of every partition type the `tools`
    allow ("ptype": 16x8/8x16 with "mv2", "mvq": P_8x8, "t8": the 8x8
    transform on some 16x16 inter MBs), skippable MBs (vector = skip
    vector, no residual), coded and uncoded blocks.  An I frame (p_slice
    False) has no inter MB; "t8" then adds the all-zero map an I slice of
    a PPS with the 8x8 transform carries."""
    n = wm * hm
    r = np.random.default_rng(seed)
    is_inter = (r.random(n) < 0.7) if p_slice else np.zeros(n, bool)
    sel16 = r.random(n) < 0.4
    ptype = np.where(is_inter, r.integers(0, 4, n), 0)
    if "mvq" not in tools:
        ptype = np.where(ptype == 3, 1, ptype)
    mv = r.integers(-64, 65, size=(n, 2))
    mv_skip = np.where((r.random(n) < 0.5)[:, None], mv,
                       r.integers(-64, 65, size=(n, 2)))
    density = np.where(r.random(n) < 0.3, 0.0, r.choice([0.05, 0.3], n))
    luma_ac = _levels(r, (n, 16, 16), density[:, None, None])
    luma_ac[sel16 & ~is_inter, :, 0] = 0
    chroma_ac = _levels(r, (n, 2, 4, 16), density[:, None, None, None] / 2)
    chroma_ac[..., 0] = 0
    mb = dict(
        is_inter=is_inter, sel16=sel16, mv=mv, mv_skip=mv_skip,
        mv_pred=r.integers(-64, 65, size=(n, 2)),
        i16mode=r.integers(0, 4, n), modes=r.integers(0, 9, size=(n, 16)),
        cmode=r.integers(0, 4, n), luma_ac=luma_ac,
        luma_dc=_levels(r, (n, 16), 0.3) * (sel16 & ~is_inter)[:, None],
        chroma_dc=_levels(r, (n, 2, 4), density[:, None, None]),
        chroma_ac=chroma_ac)
    if "ptype" in tools:
        mb["mv2"] = r.integers(-64, 65, size=(n, 2))
    if "mvq" in tools:
        mb["mvq"] = r.integers(-64, 65, size=(n, 4, 2))
    # every fifth MB a P_Skip: 16x16 at the skip vector, nothing coded
    skip = np.arange(n) % 5 == 0
    if p_slice:
        is_inter[skip], ptype[skip], mv_skip[skip] = True, 0, mv[skip]
        for k in ("luma_ac", "chroma_dc", "chroma_ac"):
            mb[k][skip] = 0
    if "ptype" in tools:
        mb["ptype"] = ptype
    if "t8" in tools:
        mb["t8"] = is_inter & (ptype == 0) & (r.random(n) < 0.5)
    return {k: np.asarray(v, np.int32) if v.dtype != bool else v
            for k, v in mb.items()}


def random_b_mbs(seed, wm, hm, parts=True, t8=False):
    """A seeded raster MB dict of a wm x hm B frame, numpy: L0, L1, Bi and
    direct 16x16 MBs, intra (I16x16 and I4x4) MBs and, with `parts`, 16x8
    and 8x16 MBs with every (c0, c1) of L0, L1, Bi ("bptype", "c0", "c1",
    "mv0b", "mv1b"); each MB's list flags follow its type, a direct MB's
    lists are random; every fifth MB is a B_Skip (direct, nothing coded);
    coded and uncoded blocks.  `t8` adds the all-zero map a B slice of a
    PPS with the 8x8 transform carries."""
    mb = random_mbs(seed, wm, hm, p_slice=False, tools=())
    n = wm * hm
    r = np.random.default_rng(seed + 500)
    btype = r.integers(0, 5, n)
    c0, c1 = r.integers(0, 3, n), r.integers(0, 3, n)
    bptype = np.zeros(n, np.int64)
    if parts:
        # every fourth MB but the skips partitioned, its (shape, c0, c1)
        # in turn
        on = (np.arange(n) % 4 == 1) & (np.arange(n) % 5 != 0)
        k = np.arange(int(on.sum())) % 18
        btype[on] = 5
        bptype[on], c0[on], c1[on] = 1 + k // 9, k // 3 % 3, k % 3
    skip = np.arange(n) % 5 == 0
    btype[skip] = 3
    bptype[skip] = 0
    duse = r.integers(1, 4, n)              # a direct MB's lists: 1, 2, 3
    kinds = [btype == 3, btype == 5, btype == 4]
    use0 = np.select(kinds, [duse & 1 > 0, c0 != 1, False],
                     (btype == 0) | (btype == 2))
    use1 = np.select(kinds, [duse & 2 > 0, c0 != 0, False],
                     (btype == 1) | (btype == 2))
    for k in ("luma_ac", "chroma_dc", "chroma_ac"):
        mb[k][skip] = 0
    inter = btype != 4
    mb["luma_dc"][inter] = 0
    mb.update(btype=btype, use0=use0, use1=use1,
              mv0=r.integers(-64, 65, size=(n, 2)),
              mv1=r.integers(-64, 65, size=(n, 2)))
    if parts:
        mb.update(bptype=bptype, c0=np.where(btype == 5, c0, 0),
                  c1=np.where(btype == 5, c1, 0),
                  mv0b=r.integers(-64, 65, size=(n, 2)),
                  mv1b=r.integers(-64, 65, size=(n, 2)))
        mb["mv0b"][btype != 5] = mb["mv0"][btype != 5]
        mb["mv1b"][btype != 5] = mb["mv1"][btype != 5]
    for k in ("is_inter", "mv", "mv_skip", "mv_pred"):
        del mb[k]
    if t8:
        mb["t8"] = np.zeros(n, bool)
    return {k: np.asarray(v, np.int32) if v.dtype != bool else v
            for k, v in mb.items()}


def random_deblock_picture(seed, wm, hm):
    """A wm x hm MB picture for the deblocker, as numpy: (y, u, v,
    intra_mb [hm, wm] bool, tc_luma [4hm, 4wm], mv [hm, wm, 2],
    ref [hm, wm]).  The planes are smooth with an offset per 4x4 block, so
    that edges pass the filters' gates; about a third of the MBs are intra
    (bS 3 and 4), coded blocks are sparse (bS 2), and the inter MBs' motion
    comes from a few vectors and two references, so that neighbours differ
    (bS 1) or agree (bS 0)."""
    r = np.random.default_rng(seed)
    h, w = hm * 16, wm * 16
    yy, xx = np.mgrid[0:h, 0:w]

    def blocky(base, blk, amp):
        o = r.integers(-amp, amp + 1, size=(base.shape[0] // blk,
                                            base.shape[1] // blk))
        o = np.repeat(np.repeat(o, blk, 0), blk, 1)
        return np.clip(base + o + r.integers(-1, 2, size=base.shape), 0,
                       255).astype(np.uint8)

    y = blocky(110 + 50 * np.sin(xx / 23.0) + 40 * np.cos(yy / 17.0), 4, 7)
    u = blocky(128 + 30 * np.sin(xx[::2, ::2] / 31.0), 4, 5)
    v = blocky(128 + 30 * np.cos(yy[::2, ::2] / 27.0), 4, 5)
    intra_mb = r.integers(0, 3, size=(hm, wm)) == 0
    tc_luma = (r.integers(0, 4, size=(hm * 4, wm * 4))
               * (r.integers(0, 4, size=(hm * 4, wm * 4)) == 0))
    vecs = np.array([(0, 0), (0, 0), (3, -2), (4, 0), (-9, 5)])
    mv = vecs[r.integers(0, len(vecs), size=(hm, wm))]
    mv = np.where(intra_mb[..., None], 0, mv).astype(np.int32)
    ref = np.where(intra_mb, -1, r.integers(0, 5, size=(hm, wm)) == 0)
    return y, u, v, intra_mb, tc_luma.astype(np.int32), mv, \
        ref.astype(np.int32)


def random_decode_deblock(seed, wm, hm, two_list=True, idc=2):
    """A wm x hm MB picture for the deblocker as a decoder calls it, as
    numpy: a dict of the planes y, u, v and intra_mb, tc_luma [4hm, 4wm],
    the motion (two-list per 4x4 block: mv [4hm, 4wm, 2, 2] and the
    picture ids pid [4hm, 4wm, 2], -1 where a list is unused; else
    one-list per MB as `random_deblock_picture` has it), per-MB luma and
    chroma QP grids qp, cqp [hm, wm] over 0-51 (the chroma grid through a
    chroma QP offset), t8 [hm, wm], the MB-edge masks left_ok, top_ok
    [hm, wm] (picture edges; at `idc` 2 also the edges of slices that
    start in the middle of a row) and FilterOffsetA/B off_a, off_b in
    -12 .. 12 (even, as slice headers code them)."""
    from tpu264_torch.ref.transform import chroma_qp
    y, u, v, intra_mb, tc_luma, mv, ref = random_deblock_picture(seed, wm,
                                                                 hm)
    r = np.random.default_rng(10_000 + seed)
    out = dict(y=y, u=u, v=v, intra_mb=intra_mb, tc_luma=tc_luma, mv=mv,
               ref=ref)
    if two_list:
        # per 8x8 block: list 0, list 1 or both, from three pictures
        h8, w8 = 2 * hm, 2 * wm
        vecs = np.array([(0, 0), (1, -1), (4, 0), (-3, 6), (0, -5)])
        mv8 = vecs[r.integers(0, len(vecs), size=(h8, w8, 2))]
        use = r.integers(1, 4, size=(h8, w8))          # 1: L0, 2: L1, 3: bi
        pid8 = np.stack([np.where(use & 1, r.integers(0, 3, (h8, w8)), -1),
                         np.where(use & 2, r.integers(0, 3, (h8, w8)), -1)],
                        axis=-1)
        intra8 = np.repeat(np.repeat(intra_mb, 2, 0), 2, 1)
        mv8 = np.where(intra8[..., None, None], 0, mv8)
        pid8 = np.where(intra8[..., None], -1, pid8)
        out["mv"] = np.repeat(np.repeat(mv8, 2, 0), 2, 1).astype(np.int32)
        out["ref"] = np.repeat(np.repeat(pid8, 2, 0), 2, 1).astype(np.int32)
    qp = r.integers(0, 52, size=(hm, wm))
    c_off = int(r.integers(-12, 13))
    out["qp"] = qp.astype(np.int32)
    out["cqp"] = np.array([[chroma_qp(int(q), c_off) for q in row]
                           for row in qp], np.int32)
    out["t8"] = (r.integers(0, 2, size=(hm, wm)) == 1) & ~intra_mb
    left_ok = np.zeros((hm, wm), bool)
    top_ok = np.zeros((hm, wm), bool)
    left_ok[:, 1:] = True
    top_ok[1:, :] = True
    if idc == 2:
        # slices of 3 .. 3 wm - 1 MBs in raster order: most start mid-row
        starts = np.zeros(hm * wm, bool)
        at = 0
        while at < hm * wm:
            starts[at] = True
            at += int(r.integers(3, 3 * wm))
        sid = np.cumsum(starts).reshape(hm, wm)
        left_ok[:, 1:] &= sid[:, 1:] == sid[:, :-1]
        top_ok[1:, :] &= sid[1:, :] == sid[:-1, :]
    out["left_ok"], out["top_ok"] = left_ok, top_ok
    out["off_a"] = 2 * int(r.integers(-6, 7))
    out["off_b"] = 2 * int(r.integers(-6, 7))
    return out


def random_records(seed, n):
    """n random packed-record triples (kind, a, b) ending in a terminate."""
    r = np.random.default_rng(seed)
    kinds, aa, bb = [], [], []
    for _ in range(n):
        kk = int(r.integers(0, 3))
        if kk == 0:
            kinds.append(0)
            aa.append(int(r.integers(0, 460)))
            bb.append(int(r.integers(0, 2)) | (int(r.integers(1, 14)) << 1))
        elif kk == 1:
            nb = int(r.integers(1, 17))
            kinds.append(1)
            aa.append(int(r.integers(0, 1 << nb)))
            bb.append(nb)
        else:
            kinds.append(2)
            aa.append(0)
            bb.append(0)
    kinds.append(2)
    aa.append(1)
    bb.append(0)
    return (np.array(kinds, np.int32), np.array(aa, np.int32),
            np.array(bb, np.int32))


def carry_records(seed, runs=(3, 9, 40, 130, 700), tail=200):
    """A hand-made record sequence (kind, a, b) that drives the coder's
    carry path: from the start of a slice (low 0, range 510, bypass bins
    leave the range alone) bypass bins are steered so that `low` stays in
    the middle band, which piles up `n` outstanding bits, i.e. n / 8
    pending 0xFF bytes, for each n of `runs`; the pile is then resolved in
    turn by a carry (the bytes become 0x00 and the byte before them gains
    one) and without one.  The bins are packed into bypass records of 1..16
    bits; `tail` random records and the terminating record follow."""
    r = np.random.default_rng(seed)
    low, rng_, bins = 0, 510, []

    def step(b):
        nonlocal low
        low = 2 * low + (rng_ if b else 0)
        if low >= 1024:
            low -= 1024
            return "one"
        if low < 512:
            return "zero"
        low -= 512
        return "outstanding"

    def push(b):
        bins.append(b)
        return step(b)

    for i, n in enumerate(runs):
        # into the band: a bit that leaves low in [256, 512), then a 0
        while not 256 <= low < 512:
            push(int(r.integers(0, 2)))
        assert push(0) == "outstanding"
        for _ in range(n - 1):
            # x = low after the last subtraction; 2x + b*510 must land in
            # [512, 1024) again: b = 1 takes x in [1, 256], b = 0 x above
            if low < 2:
                break
            assert push(1 if low <= 256 else 0) == "outstanding"
        if i % 2 == 0:          # resolve with a carry
            while push(1) == "outstanding":
                pass
        else:                   # resolve without
            while push(0) == "outstanding":
                pass
    kinds, aa, bb = [], [], []
    i = 0
    while i < len(bins):
        nb = min(int(r.integers(1, 17)), len(bins) - i)
        val = 0
        for b in bins[i:i + nb]:
            val = (val << 1) | b
        kinds.append(1)
        aa.append(val)
        bb.append(nb)
        i += nb
    k, a, b = random_records(seed + 1, tail)
    return (np.concatenate([np.array(kinds, np.int32), k]),
            np.concatenate([np.array(aa, np.int32), a]),
            np.concatenate([np.array(bb, np.int32), b]))


def long_run_records(seed, n=24, tail=50):
    """n context records (kind, a, b) whose runs are 5 to 8191 bins long,
    in a handful of contexts and with the bin value changing from record to
    record, so that a context's state is pushed to both ends of its table;
    `tail` random records and the terminating record follow."""
    r = np.random.default_rng(seed)
    counts = r.integers(5, 8192, size=n)
    counts[:3] = (5, 8191, 64)
    bins = r.integers(0, 2, size=n)
    ctxs = r.integers(0, 460, size=4)[r.integers(0, 4, size=n)]
    k, a, b = random_records(seed + 1, tail)
    return (np.concatenate([np.zeros(n, np.int32), k]),
            np.concatenate([ctxs.astype(np.int32), a]),
            np.concatenate([(bins | (counts << 1)).astype(np.int32), b]))


def pack_record_slices(slices, pad: int = 5):
    """[(kind, a, b)] per slice -> (records [S, cap] int32 packed as
    kind << 30 | a << 14 | b and zero past each count, counts [S] int32)."""
    cap = max(len(k) for k, _, _ in slices) + pad
    recs = np.zeros((len(slices), cap), np.int32)
    for s, (k, a, b) in enumerate(slices):
        p = (k.astype(np.int64) << 30) | (a.astype(np.int64) << 14) | b
        recs[s, :len(k)] = p.astype(np.uint32).view(np.int32)
    return recs, np.array([len(k) for k, _, _ in slices], np.int32)

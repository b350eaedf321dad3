"""Seeded numpy inputs for the port's kernels, shared by the tests and by
`chip_smoke.py`: random and hand-steered CABAC record sequences for K1,
macroblock lanes for the I4x4 wave kernel (K2), whole waves with their
border buffers for the wave body (K2 + K3), and pictures with mixed intra
and inter macroblocks for the deblocker (K4).  numpy only."""

from __future__ import annotations

import numpy as np


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

"""Seeded numpy inputs for the port's kernels, shared by the tests and by
`chip_smoke.py`: random and hand-steered CABAC record sequences for K1 and
macroblock lanes for the I4x4 wave kernel (K2).  numpy only."""

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

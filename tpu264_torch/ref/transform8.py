"""8x8 integer transform and quantization — scalar reference (spec
8.5.12.3 inverse; JM `transform8x8.c`/`quant8x8.c` forward convention —
SURVEY.md §2a #13, High profile).

Flat (default) scaling matrices.  Forward transform is the standard
JM/x264 8x8 butterfly; quant uses the High-profile MF8 multiplier table
with the dead-zone f = (1<<qbits)/3 intra, /6 inter; dequant + inverse
are normative (bit-exact requirement is on the decode side).
"""

from __future__ import annotations

import numpy as np

# the six position classes of normAdjust8x8 / the MF8 multipliers
# (spec 8.5.9; layout verified against libavcodec's
# dequant8_coeff_init_scan in tests/test_transform8.py):
#   0: i%4==0 and j%4==0      1: i%2==1 and j%2==1
#   2: i%4==2 and j%4==2      3: (i%4==0, j odd) or (i odd, j%4==0)
#   4: (i%4==0, j%4==2) or (i%4==2, j%4==0)      5: otherwise
_V8_SIX = np.array([
    [20, 18, 32, 19, 25, 24],
    [22, 19, 35, 21, 28, 26],
    [26, 23, 42, 24, 33, 31],
    [28, 25, 45, 26, 35, 33],
    [32, 28, 51, 30, 40, 38],
    [36, 32, 58, 34, 46, 43],
], dtype=np.int64)
_MF8_SIX = np.array([
    [13107, 11428, 20972, 12222, 16777, 15481],
    [11916, 10826, 19174, 11058, 14980, 14290],
    [10082, 8943, 15978, 9675, 12710, 11985],
    [9362, 8228, 14913, 8931, 11984, 11259],
    [8192, 7346, 13159, 7740, 10486, 9777],
    [7282, 6428, 11570, 6830, 9118, 8640],
], dtype=np.int64)


def _pos_class8(i, j):
    if i % 4 == 0 and j % 4 == 0:
        return 0
    if i % 2 == 1 and j % 2 == 1:
        return 1
    if i % 4 == 2 and j % 4 == 2:
        return 2
    if (i % 4 == 0 and j % 2 == 1) or (i % 2 == 1 and j % 4 == 0):
        return 3
    if (i % 4 == 0 and j % 4 == 2) or (i % 4 == 2 and j % 4 == 0):
        return 4
    return 5


_V8_FULL = np.zeros((6, 8, 8), dtype=np.int64)
_MF8_FULL = np.zeros((6, 8, 8), dtype=np.int64)

for _m in range(6):
    for _ii in range(8):
        for _jj in range(8):
            c = _pos_class8(_ii, _jj)
            _V8_FULL[_m, _ii, _jj] = _V8_SIX[_m, c]
            _MF8_FULL[_m, _ii, _jj] = _MF8_SIX[_m, c]

MF8_TABLE = _MF8_FULL                                  # [6, 8, 8]
V8_TABLE = _V8_FULL                                    # [6, 8, 8]

# 8x8 zig-zag scan (spec Table 8-8 frame scan)
ZIGZAG_8x8 = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    dtype=np.int64)


def _fwd1d(b):
    """JM forward 8x8 butterfly over the last axis."""
    b = np.asarray(b, dtype=np.int64)
    a0 = b[..., 0] + b[..., 7]
    a1 = b[..., 1] + b[..., 6]
    a2 = b[..., 2] + b[..., 5]
    a3 = b[..., 3] + b[..., 4]
    a4 = b[..., 0] - b[..., 7]
    a5 = b[..., 1] - b[..., 6]
    a6 = b[..., 2] - b[..., 5]
    a7 = b[..., 3] - b[..., 4]
    b0 = a0 + a3
    b1 = a1 + a2
    b2 = a0 - a3
    b3 = a1 - a2
    b4 = a5 + a6 + ((a4 >> 1) + a4)
    b5 = a4 - a7 - ((a6 >> 1) + a6)
    b6 = a4 + a7 - ((a5 >> 1) + a5)
    b7 = a5 - a6 + ((a7 >> 1) + a7)
    return np.stack([
        b0 + b1,
        b4 + (b7 >> 2),
        b2 + (b3 >> 1),
        b5 + (b6 >> 2),
        b0 - b1,
        b6 - (b5 >> 2),
        (b2 >> 1) - b3,
        (b4 >> 2) - b7,
    ], axis=-1)


def fdct8x8(x):
    """Forward 8x8 transform (JM dct8x8): rows then columns."""
    t = _fwd1d(x)                                  # horizontal
    return _fwd1d(np.swapaxes(t, -1, -2)).swapaxes(-1, -2)


def _inv1d(d):
    """Normative inverse 8x8 butterfly (spec 8.5.12.3) over last axis."""
    d = np.asarray(d, dtype=np.int64)
    e0 = d[..., 0] + d[..., 4]
    e1 = -d[..., 3] + d[..., 5] - d[..., 7] - (d[..., 7] >> 1)
    e2 = d[..., 0] - d[..., 4]
    e3 = d[..., 1] + d[..., 7] - d[..., 3] - (d[..., 3] >> 1)
    e4 = (d[..., 2] >> 1) - d[..., 6]
    e5 = -d[..., 1] + d[..., 7] + d[..., 5] + (d[..., 5] >> 1)
    e6 = d[..., 2] + (d[..., 6] >> 1)
    e7 = d[..., 3] + d[..., 5] + d[..., 1] + (d[..., 1] >> 1)
    f0 = e0 + e6
    f1 = e1 + (e7 >> 2)
    f2 = e2 + e4
    f3 = e3 + (e5 >> 2)
    f4 = e2 - e4
    f5 = (e3 >> 2) - e5
    f6 = e0 - e6
    f7 = e7 - (e1 >> 2)
    return np.stack([
        f0 + f7, f2 + f5, f4 + f3, f6 + f1,
        f6 - f1, f4 - f3, f2 - f5, f0 - f7,
    ], axis=-1)


def quant8x8(w, qp: int, intra: bool):
    """JM 8x8 quantization: lev = (|w| * MF8 + f) >> (16 + qp/6)."""
    qbits = 16 + qp // 6
    mf = MF8_TABLE[qp % 6]
    f = (1 << qbits) // (3 if intra else 6)
    lev = (np.abs(w) * mf + f) >> qbits
    return np.sign(w) * lev


def dequant8x8(c, qp: int, ws=None):
    """Normative 8x8 scaling (spec 8.5.13.1): flat weights reduce to
    d = (c * V8) << (qp/6 - 2) for qp >= 12 (rounded >> below) — the
    pairing that makes quant->dequant->idct8 unity gain at every
    frequency (verified numerically in tests/test_transform8.py).
    `ws` = [8,8] weightScale8x8 (scaling lists; flat = 16)."""
    from .transform import wrap16
    c = np.asarray(c, dtype=np.int64)
    k = qp // 6
    if ws is not None:
        ls = np.asarray(ws, dtype=np.int64) * V8_TABLE[qp % 6]
        if qp >= 36:
            return wrap16((c * ls) << (k - 6))
        return wrap16((c * ls + (1 << (5 - k))) >> (6 - k))
    v = V8_TABLE[qp % 6]
    if k >= 2:
        return wrap16((c * v) << (k - 2))
    return wrap16((c * v + (1 << (1 - k))) >> (2 - k))


def idct8x8(d):
    """Normative inverse: horizontal then vertical, then (x+32)>>6."""
    t = _inv1d(d)
    r = _inv1d(np.swapaxes(t, -1, -2)).swapaxes(-1, -2)
    return (r + 32) >> 6


def roundtrip_recon(x, qp: int, intra: bool = True):
    """fdct -> quant -> dequant -> idct (encoder closed-loop residual)."""
    lev = quant8x8(fdct8x8(x), qp, intra)
    return idct8x8(dequant8x8(lev, qp)), lev

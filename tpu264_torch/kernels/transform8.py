"""Batched 8x8 transform / quant (torch), counterpart of
`tpu264.kernels.transform8` (High profile, flat scaling matrices).

int32 twins of the scalar reference `ref.transform8` over arbitrary
leading batch dimensions of [..., 8, 8]: the JM forward butterfly, the
dead-zone quantiser, the normative dequantiser and inverse.  Together with
`coeff_bits` and `LAM_SSD` they are the plain version of the 8x8 path of
the P wave kernel KP (`kernels/p_wave.py`), which picks the transform of a
16x16 inter macroblock.  `qp` is a Python int throughout.
"""

from __future__ import annotations

import torch

from tpu264_torch.entropy.device_cavlc import bit_length_minus1
from tpu264_torch.ref import transform8 as ref8
from .transform import I32, on

MF8_TABLE = torch.as_tensor(ref8.MF8_TABLE, dtype=I32)      # [6, 8, 8]
V8_TABLE = torch.as_tensor(ref8.V8_TABLE, dtype=I32)        # [6, 8, 8]
ZIGZAG_8x8 = torch.as_tensor(ref8.ZIGZAG_8x8, dtype=torch.int64)

# The transform choice's SSD-domain lambda, 0.85 * 2^((qp - 12) / 3), as
# the reference's float32 expression gives it (XLA folds it to
# 0.85 * exp((qp - 12) * 0.231049061)); a table, so that no float library
# of the port can differ from it in the last place.
LAM_SSD = torch.tensor([float.fromhex(h) for h in (
    "0x1.b333340000000p-5", "0x1.1228aa0000000p-4", "0x1.596b220000000p-4",
    "0x1.b333340000000p-4", "0x1.1228aa0000000p-3", "0x1.596b220000000p-3",
    "0x1.b333340000000p-3", "0x1.1228aa0000000p-2", "0x1.596b220000000p-2",
    "0x1.b333340000000p-2", "0x1.1228aa0000000p-1", "0x1.596b220000000p-1",
    "0x1.b333340000000p-1", "0x1.1228aa0000000p+0", "0x1.596b220000000p+0",
    "0x1.b333340000000p+0", "0x1.1228aa0000000p+1", "0x1.596b220000000p+1",
    "0x1.b333340000000p+1", "0x1.1228aa0000000p+2", "0x1.596b220000000p+2",
    "0x1.b333340000000p+2", "0x1.1228aa0000000p+3", "0x1.596b220000000p+3",
    "0x1.b333340000000p+3", "0x1.1228aa0000000p+4", "0x1.596b220000000p+4",
    "0x1.b333340000000p+4", "0x1.1228aa0000000p+5", "0x1.596b220000000p+5",
    "0x1.b333340000000p+5", "0x1.1228aa0000000p+6", "0x1.596b220000000p+6",
    "0x1.b333340000000p+6", "0x1.1228aa0000000p+7", "0x1.596b220000000p+7",
    "0x1.b333340000000p+7", "0x1.1228aa0000000p+8", "0x1.596b220000000p+8",
    "0x1.b333340000000p+8", "0x1.1228aa0000000p+9", "0x1.596b220000000p+9",
    "0x1.b333340000000p+9", "0x1.1228aa0000000p+10", "0x1.596b220000000p+10",
    "0x1.b333340000000p+10", "0x1.1228aa0000000p+11",
    "0x1.596b2e0000000p+11", "0x1.b333340000000p+11",
    "0x1.1228a00000000p+12", "0x1.596b220000000p+12",
    "0x1.b333420000000p+12")], dtype=torch.float32)


def _fwd1d(b):
    """JM forward 8x8 butterfly over the last axis."""
    a = [b[..., i] + b[..., 7 - i] for i in range(4)]
    d = [b[..., i] - b[..., 7 - i] for i in range(4)]
    b0 = a[0] + a[3]
    b1 = a[1] + a[2]
    b2 = a[0] - a[3]
    b3 = a[1] - a[2]
    b4 = d[1] + d[2] + ((d[0] >> 1) + d[0])
    b5 = d[0] - d[3] - ((d[2] >> 1) + d[2])
    b6 = d[0] + d[3] - ((d[1] >> 1) + d[1])
    b7 = d[1] - d[2] + ((d[3] >> 1) + d[3])
    return torch.stack([
        b0 + b1, b4 + (b7 >> 2), b2 + (b3 >> 1), b5 + (b6 >> 2),
        b0 - b1, b6 - (b5 >> 2), (b2 >> 1) - b3, (b4 >> 2) - b7,
    ], dim=-1)


def fdct8x8(x):
    """Forward 8x8 transform: rows, then columns."""
    t = _fwd1d(x.to(I32))
    return _fwd1d(t.transpose(-1, -2)).transpose(-1, -2)


def _inv1d(d):
    """Normative inverse 8x8 butterfly (spec 8.5.12.3) over the last axis."""
    d0, d1, d2, d3, d4, d5, d6, d7 = d.unbind(-1)
    e0 = d0 + d4
    e1 = -d3 + d5 - d7 - (d7 >> 1)
    e2 = d0 - d4
    e3 = d1 + d7 - d3 - (d3 >> 1)
    e4 = (d2 >> 1) - d6
    e5 = -d1 + d7 + d5 + (d5 >> 1)
    e6 = d2 + (d6 >> 1)
    e7 = d3 + d5 + d1 + (d1 >> 1)
    f0 = e0 + e6
    f1 = e1 + (e7 >> 2)
    f2 = e2 + e4
    f3 = e3 + (e5 >> 2)
    f4 = e2 - e4
    f5 = (e3 >> 2) - e5
    f6 = e0 - e6
    f7 = e7 - (e1 >> 2)
    return torch.stack([f0 + f7, f2 + f5, f4 + f3, f6 + f1,
                        f6 - f1, f4 - f3, f2 - f5, f0 - f7], dim=-1)


def idct8x8(d):
    """Normative inverse: rows, then columns, then (x + 32) >> 6."""
    t = _inv1d(d.to(I32))
    r = _inv1d(t.transpose(-1, -2)).transpose(-1, -2)
    return (r + 32) >> 6


def quant8x8(w, qp: int, intra: bool):
    """lev = sign(w) * ((|w| * MF8 + f) >> (16 + qp / 6))."""
    qbits = 16 + qp // 6
    mf = on(MF8_TABLE, w.device)[qp % 6]
    f = (1 << qbits) // (3 if intra else 6)
    return torch.sign(w) * ((w.abs() * mf + f) >> qbits)


def dequant8x8(c, qp: int):
    """Flat-matrix dequantiser: (c * V8) << (qp/6 - 2), rounded for
    qp < 12."""
    c = c.to(I32)
    v = on(V8_TABLE, c.device)[qp % 6]
    k = qp // 6
    if k >= 2:
        return (c * v) << (k - 2)
    return (c * v + (1 << (1 - k))) >> (2 - k)


def zigzag_scan8(blocks):
    """[..., 8, 8] -> [..., 64] in 8x8 frame zig-zag order."""
    flat = blocks.reshape(tuple(blocks.shape[:-2]) + (64,))
    return flat[..., on(ZIGZAG_8x8, blocks.device)]


def coeff_bits(lev):
    """The transform choice's rate estimate of each level, int32: 0 for 0,
    else 2 * ceil(log2(|l| + 1)) + 1 = 2 * bit_length(|l|) + 1 (the
    reference's float32 expression gives exactly this over every level
    the quantisers can produce; the tests check it)."""
    a = lev.abs().to(I32)
    return torch.where(a > 0, 2 * bit_length_minus1(torch.clamp(a, min=1))
                       + 3, 0)


def choice_cost(ssd, bits, qp: int):
    """The transform choice's cost of each lane, SSD + LAM_SSD[qp] x bits
    in float32, from int32 ssd (< 2^24) and coefficient bits (< 2^14):
    rounded once, as the reference's program computes it (XLA fuses the
    product and the sum into one multiply-add).  float64 holds both terms
    and their sum exactly, so its one rounding to float32 is that
    multiply-add."""
    return (ssd.double() + float(LAM_SSD[qp]) * bits.double()).float()

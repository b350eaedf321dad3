"""Batched 4x4 transform / quant / SATD (torch), counterpart of
`tpu264.kernels.transform`.

All functions map over arbitrary leading batch dimensions of [..., 4, 4]
int32 tensors.  The reference writes its 4x4 products as int32 einsums;
torch has no int32 matmul on CUDA, so every product with CF, H4 or H2
here is an explicit butterfly of adds and shifts.  That is exact in
int32 and gives the same integers on the CPU and the card.

`fdct4x4` here is the plain version of kernel K3; `quant4x4(fdct4x4(x))`
is the plain version of K2 (both in `dct_quant.py`).  `qp` is a Python
int throughout: the port encodes each frame at one fixed QP.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu264_torch.ref import transform as ref

I32 = torch.int32

MF_TABLE = torch.as_tensor(ref.MF_TABLE, dtype=I32)            # [6,4,4]
V_TABLE = torch.as_tensor(ref.V_TABLE, dtype=I32)              # [6,4,4]
MF00 = [int(v) for v in ref._MF_CLASS[:, 0]]                   # [6]
V00 = [int(v) for v in ref._V_CLASS[:, 0]]                     # [6]
ZIGZAG_4x4 = torch.as_tensor(ref.ZIGZAG_4x4, dtype=torch.int64)

# per-QP level limits (spec 8.5.12 int16 range of dequantized values)
LIMIT_AC = torch.as_tensor(
    np.stack([ref.level_limit_ac(q) for q in range(52)]), dtype=I32)
LIMIT_DC = [int(ref.level_limit_dc(q)) for q in range(52)]
LIMIT_CDC = [int(ref.level_limit_cdc(q)) for q in range(52)]

_ON_DEVICE: dict = {}


def on(t: torch.Tensor, device) -> torch.Tensor:
    """Module-level constant table `t` on `device`, copied there once and
    cached (keyed by identity: pass whole tables, never temporaries)."""
    device = torch.device(device)
    if device.type == "cpu":
        return t
    key = (id(t), device)
    if key not in _ON_DEVICE:
        _ON_DEVICE[key] = t.to(device)
    return _ON_DEVICE[key]


def constant(key: tuple, device, make):
    """The constant that `make()` builds from host data (a tensor or a
    tuple of them, numpy or torch), on `device`, built and copied there
    once for each `key` and device: a copy from host memory waits for the
    card's queue to drain, so the hot paths take their index tables and
    masks from here."""
    device = torch.device(device)
    k = ("constant",) + tuple(key) + (device,)
    if k not in _ON_DEVICE:
        val = make()
        _ON_DEVICE[k] = (tuple(torch.as_tensor(v, device=device) for v in val)
                         if isinstance(val, tuple)
                         else torch.as_tensor(val, device=device))
    return _ON_DEVICE[k]


def _rows_cols(x, f):
    """Apply the 1-D 4-point transform `f` along axis -2, then -1:
    M @ x @ M^T for the matrix M that `f` encodes."""
    c = f(*x.unbind(-2))
    x = torch.stack(c, dim=-2)
    return torch.stack(f(*x.unbind(-1)), dim=-1)


def _cf1d(x0, x1, x2, x3):
    # rows of CF: [1,1,1,1], [2,1,-1,-2], [1,-1,-1,1], [1,-2,2,-1]
    s03, d03 = x0 + x3, x0 - x3
    s12, d12 = x1 + x2, x1 - x2
    return (s03 + s12, (d03 << 1) + d12, s03 - s12, d03 - (d12 << 1))


def _h4_1d(x0, x1, x2, x3):
    # rows of H4: [1,1,1,1], [1,1,-1,-1], [1,-1,-1,1], [1,-1,1,-1]
    s01, d01 = x0 + x1, x0 - x1
    s23, d23 = x2 + x3, x2 - x3
    return (s01 + s23, s01 - s23, d01 - d23, d01 + d23)


def fdct4x4(x):
    """W = Cf X Cf^T, batched (plain version of kernel K3)."""
    return _rows_cols(x.to(I32), _cf1d)


def hadamard4x4(x):
    """H4 X H4 (H4 is symmetric), batched."""
    return _rows_cols(x.to(I32), _h4_1d)


def hadamard2x2(x):
    """H2 X H2 over [..., 2, 2]."""
    a, b, c, d = x[..., 0, 0], x[..., 0, 1], x[..., 1, 0], x[..., 1, 1]
    return torch.stack([torch.stack([a + b + c + d, a - b + c - d], -1),
                        torch.stack([a + b - c - d, a - b - c + d], -1)],
                       -2)


def quant4x4(w, qp: int, intra: bool):
    qbits = 15 + qp // 6
    mf = on(MF_TABLE, w.device)[qp % 6]
    f = (1 << qbits) // (3 if intra else 6)
    lev = (w.abs() * mf + f) >> qbits
    # spec 8.5.12 int16 range constraint on dequantized coefficients
    lev = torch.minimum(lev, on(LIMIT_AC, w.device)[qp])
    return torch.sign(w) * lev


def dequant4x4(c, qp: int):
    return (c * on(V_TABLE, c.device)[qp % 6]) << (qp // 6)


def idct4x4(d):
    """Normative inverse transform incl. (x+32)>>6, batched (spec 8.5.12.2)."""
    d = d.to(I32)
    # horizontal
    e0 = d[..., :, 0] + d[..., :, 2]
    e1 = d[..., :, 0] - d[..., :, 2]
    e2 = (d[..., :, 1] >> 1) - d[..., :, 3]
    e3 = d[..., :, 1] + (d[..., :, 3] >> 1)
    f = torch.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], dim=-1)
    # vertical
    g0 = f[..., 0, :] + f[..., 2, :]
    g1 = f[..., 0, :] - f[..., 2, :]
    g2 = (f[..., 1, :] >> 1) - f[..., 3, :]
    g3 = f[..., 1, :] + (f[..., 3, :] >> 1)
    h = torch.stack([g0 + g3, g1 + g2, g1 - g2, g0 - g3], dim=-2)
    return (h + 32) >> 6


def block_recon(coeff, qp: int, dc=None):
    """Dequant + IDCT; optional external DC override at position (0,0)."""
    d = dequant4x4(coeff, qp)
    if dc is not None:
        d[..., 0, 0] = dc          # d is a fresh tensor: set in place
    return idct4x4(d)


def hadamard4x4_fwd_quant_dc(wdc, qp: int, intra: bool = True):
    m = hadamard4x4(wdc)
    qbits = 15 + qp // 6
    f = (1 << qbits) // (3 if intra else 6)
    lev = ((m.abs() >> 1) * MF00[qp % 6] + 2 * f) >> (qbits + 1)
    lev = torch.clamp(lev, max=LIMIT_DC[qp])
    return torch.sign(m) * lev


def hadamard4x4_inv_dequant_dc(c, qp: int):
    f = hadamard4x4(c)
    q6 = qp // 6
    ls = 16 * V00[qp % 6]
    if qp >= 36:
        return (f * ls) << (q6 - 6)
    return (f * ls + (1 << (5 - q6))) >> (6 - q6)


def hadamard2x2_fwd_quant_dc(wdc, qp: int, intra: bool):
    m = hadamard2x2(wdc.to(I32))
    qbits = 15 + qp // 6
    f = (1 << qbits) // (3 if intra else 6)
    lev = (m.abs() * MF00[qp % 6] + 2 * f) >> (qbits + 1)
    lev = torch.clamp(lev, max=LIMIT_CDC[qp])
    return torch.sign(m) * lev


def hadamard2x2_inv_dequant_dc(c, qp: int):
    f = hadamard2x2(c.to(I32))
    ls = 16 * V00[qp % 6]
    return ((f * ls) << (qp // 6)) >> 5


def satd4x4(diff):
    """(sum |H diff H| + 1) >> 1 per block, batched over [..., 4, 4]."""
    m = hadamard4x4(diff)
    return (m.abs().sum(dim=(-2, -1), dtype=I32) + 1) >> 1


def clip1(x):
    return torch.clamp(x, 0, 255)


def zigzag_scan(blocks):
    """[..., 4, 4] → [..., 16] in zig-zag scan order."""
    flat = blocks.reshape(blocks.shape[:-2] + (16,))
    return flat[..., on(ZIGZAG_4x4, blocks.device)]

"""Batched sub-pel interpolation + motion compensation (torch).

Counterpart of `tpu264.kernels.interp`: the half-pel planes of a
reference picture are three separable 6-tap filters over the padded
plane, and per-block quarter-pel MC is two gathers + one average, driven
by the 16-entry position table (`ref.interp.QPEL_TABLE`).  Bit-exact
against the scalar reference `ref.interp`.

The reference reads its blocks with `jax.lax.dynamic_slice`, which moves
a start that would run the block over the plane's edge back inside (and
counts a negative start from the end); the gathers here treat their
starts the same way (`clamp_start`), since the padding lanes of a wave
address a block below the picture.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu264_torch.ref import interp as ri
from .transform import I32, on

TAPS = [int(t) for t in ri.TAPS]

# dense [16, 7] table: fy*4+fx -> p1, dy1, dx1, p2, dy2, dx2, avg
_QT = np.zeros((16, 7), dtype=np.int32)
for (fx, fy), (p1, dx1, dy1, p2, dx2, dy2, avg) in ri.QPEL_TABLE.items():
    _QT[fy * 4 + fx] = (p1, dy1, dx1, p2, dy2, dx2, avg)
QPEL_TABLE = torch.as_tensor(_QT)


def pad_plane(plane, pad: int):
    """Edge-replicated padding of a [H, W] plane by `pad` on every side."""
    p = plane.to(I32)
    p = torch.cat([p[:1].expand(pad, -1), p, p[-1:].expand(pad, -1)], dim=0)
    return torch.cat([p[:, :1].expand(-1, pad), p, p[:, -1:].expand(-1, pad)],
                     dim=1)


def _conv6(g, axis: int):
    """6-tap filter along an axis via shifted adds (intermediate, no
    rounding).  The shifts wrap around the plane's edge as the
    reference's do, so the planes agree over the whole margin."""
    out = torch.zeros_like(g)
    for k in range(6):
        out = out + TAPS[k] * torch.roll(g, -(k - 2), dims=axis)
    return out


def luma_planes(g_pad):
    """Stack [4, Hp, Wp]: G, b, h, j (spec 8.4.2.2.1 half-pel planes)."""
    g = g_pad.to(I32)
    b1 = _conv6(g, 1)
    h1 = _conv6(g, 0)
    j1 = _conv6(b1, 0)
    b = torch.clamp((b1 + 16) >> 5, 0, 255)
    h = torch.clamp((h1 + 16) >> 5, 0, 255)
    j = torch.clamp((j1 + 512) >> 10, 0, 255)
    return torch.stack([g, b, h, j])


def clamp_start(start, size: int, dim: int):
    """A block's start as `jax.lax.dynamic_slice` reads it: a negative
    start counts from the end, then the start is moved so that
    [start, start + size) lies inside [0, dim)."""
    start = torch.where(start < 0, start + dim, start)
    return torch.clamp(start, 0, dim - size)


def _block_index(yy, xx, bh: int, bw: int, hp: int, wp: int):
    """(rows [B, bh, 1], cols [B, 1, bw]) of the blocks at starts yy, xx
    [B], each start clamped into a [hp, wp] plane."""
    dev = yy.device
    yy = clamp_start(yy.long(), bh, hp)
    xx = clamp_start(xx.long(), bw, wp)
    rows = yy[:, None, None] + torch.arange(bh, device=dev)[None, :, None]
    cols = xx[:, None, None] + torch.arange(bw, device=dev)[None, None, :]
    return rows, cols


def gather_blocks(plane, yy, xx, bh: int, bw: int):
    """plane [Hp, Wp] -> [B, bh, bw] blocks at starts yy, xx [B], each
    clamped into the plane."""
    return plane[_block_index(yy, xx, bh, bw, *plane.shape)]


def mc_luma(planes, y0, x0, mv, bh: int = 16, bw: int = 16):
    """Batched quarter-pel MC: planes [4,Hp,Wp]; y0/x0 [B] padded-grid
    block origins; mv [B,2] (y, x) quarter-pel. -> [B,bh,bw] int32."""
    dev = planes.device
    iy, ix = mv[:, 0] >> 2, mv[:, 1] >> 2
    sub = ((mv[:, 0] & 3) * 4 + (mv[:, 1] & 3)).long()
    t = on(QPEL_TABLE, dev)[sub]                 # [B,7]
    by, bx = y0 + iy, x0 + ix
    hp, wp = planes.shape[1:]

    def gather(pidx, yy, xx):
        rows, cols = _block_index(yy, xx, bh, bw, hp, wp)
        return planes[pidx.long()[:, None, None], rows, cols]

    a = gather(t[:, 0], by + t[:, 1], bx + t[:, 2])
    b = gather(t[:, 3], by + t[:, 4], bx + t[:, 5])
    return torch.where(t[:, 6, None, None] == 1, (a + b + 1) >> 1, a)


def mc_chroma(c_pad, y0, x0, mv, bh: int = 8, bw: int = 8):
    """Batched chroma eighth-pel bilinear MC (spec 8.4.2.2.2)."""
    iy, ix = mv[:, 0] >> 3, mv[:, 1] >> 3
    fy = (mv[:, 0] & 7).to(I32)[:, None, None]
    fx = (mv[:, 1] & 7).to(I32)[:, None, None]
    w = gather_blocks(c_pad, y0 + iy, x0 + ix, bh + 1, bw + 1)
    a = w[:, :bh, :bw]
    b = w[:, :bh, 1:]
    c = w[:, 1:, :bw]
    d = w[:, 1:, 1:]
    return ((8 - fx) * (8 - fy) * a + fx * (8 - fy) * b
            + (8 - fx) * fy * c + fx * fy * d + 32) >> 6

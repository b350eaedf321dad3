"""Kernel K4 in its wave form: the deblocking of one macroblock wave of a
picture, luma and chroma, as one CUDA launch (`csrc/deblock_wave.cu`).

`deblock_wave` is what `kernels.deblock.make_deblocker` runs per wave for
CUDA planes; its plain version is that module's skewed torch deblocker
(`plain=True`).  The kernel works on the raster planes in place and takes
the picture's luma and chroma QP grids [hm, wm] and FilterOffsetA/B: it
derives each edge's alpha, beta and tc0 from them as spec 8.7.2 does (the
tables are in the kernel's constant memory).  Which macroblocks a wave
holds is computed here (`wave_lanes`).  There is no fallback to the plain
version: a kernel that does not build or launch raises.

`launches["K4"]` counts kernel launches.
"""

from __future__ import annotations

import torch

from . import _build

I32 = torch.int32

launches = {"K4": 0}


def wave_lanes(cp: int, wm: int, hm: int) -> tuple[int, int]:
    """(first MB row, number of MB rows) of wave `cp` of a wm x hm picture:
    the rows r with 0 <= cp - 2r < wm; the wave's MBs are (r, cp - 2r)."""
    r0 = max(0, (cp - wm + 2) // 2)
    r1 = min(hm - 1, cp // 2)
    return r0, max(0, r1 - r0 + 1)


def deblock_wave(y, u, v, bs_v, bs_h, cp: int, qp_y, qp_c, off_a: int = 0,
                 off_b: int = 0) -> None:
    """Filter the MBs of wave `cp` of the int32 raster planes y [16hm, 16wm],
    u, v [8hm, 8wm] on the card, in place, one launch; bs_v, bs_h
    [4hm, 4wm] are the boundary strengths of the vertical and horizontal
    4x4 edges (0 on every edge left unfiltered), qp_y, qp_c [hm, wm] the
    int32 luma and chroma QP of each MB, off_a, off_b FilterOffsetA/B.
    Waves must be run in order, 0 .. wm + 2 (hm - 1) - 1."""
    dev = y.device
    if dev.type != "cuda":
        raise ValueError(f"deblock_wave: CUDA tensors expected, got {dev}")
    h, w = y.shape if y.dim() == 2 else (0, 0)
    if h <= 0 or w <= 0 or h % 16 or w % 16:
        raise ValueError(f"deblock_wave: y must be [16 hm, 16 wm], got "
                         f"{tuple(y.shape)}")
    hm, wm = h // 16, w // 16
    for name, t, shape in (("y", y, (h, w)), ("u", u, (h // 2, w // 2)),
                           ("v", v, (h // 2, w // 2)),
                           ("bs_v", bs_v, (hm * 4, wm * 4)),
                           ("bs_h", bs_h, (hm * 4, wm * 4)),
                           ("qp_y", qp_y, (hm, wm)), ("qp_c", qp_c, (hm, wm))):
        _build.check_tensor("deblock_wave", name, t, shape, I32, dev)
    if not 0 <= cp < wm + 2 * (hm - 1):
        raise ValueError(f"deblock_wave: no wave {cp} in a {wm} x {hm} picture")
    r0, n = wave_lanes(cp, wm, hm)
    if n == 0:
        return
    launches["K4"] += 1
    err = _build.lib().tpu264_deblock_wave(
        _build.ptr(y), _build.ptr(u), _build.ptr(v), _build.ptr(bs_v),
        _build.ptr(bs_h), _build.ptr(qp_y), _build.ptr(qp_c), wm, cp, r0, n,
        int(off_a), int(off_b), _build.stream_of(y))
    _build.check(err, "tpu264_deblock_wave")

"""Kernel KF: the integer full search of motion estimation, every
macroblock of a picture and every requested block of it in one CUDA launch
(`csrc/me_search.cu`).

`full_search` is what the P and B encoders' motion search runs, once a
list; it returns the full-pel vectors of the blocks `names` of
`me.SEARCH_BLOCKS` stacked [len(names), n_mbs, 2].  For CPU tensors it
runs the plain version `full_search_plain`, the port's
`me.full_search_blocks` (held to the reference's `full_search_16x16`,
`full_search_parts` and `full_search_quads`) with its vectors stacked in
that order; for CUDA tensors it launches KF or raises, with no fallback.

No single PyTorch call computes the quadrant SSD maps with the
first-minimum argmin, so the kernel has no library yardstick.

`launches["KF"]` counts kernel launches.
"""

from __future__ import annotations

import torch

from . import _build
from . import me as kme

I32 = torch.int32
MAX_RANGE = 16          # the kernel's window is at most 48 x 48
MAX_NAMES = len(kme.SEARCH_BLOCKS)

launches = {"KF": 0}
_PARAMS: dict = {}          # packed host tables, by all of their inputs


def quad_mask(name: str) -> int:
    """The quadrants (raster bits) whose SSD maps add up to block
    `name`'s."""
    return sum(1 << q for q in kme.SEARCH_BLOCKS[name])


def pack_params(wm: int, hm: int, orig_shape, ref_shape, pad: int, r: int,
                lam: int, names) -> list:
    """The kernel's host table: `Params` in the CUDA source, then each
    requested block's index in `me.SEARCH_BLOCKS`, in the order of
    `names`."""
    order = list(kme.SEARCH_BLOCKS)
    index = [order.index(n) for n in names]
    return ([wm, hm, *orig_shape, *ref_shape, pad, r, lam, len(names)]
            + index + [0] * (MAX_NAMES - len(index)))


def full_search_plain(orig_y, ref_pad, pad: int, search_range: int, lam: int,
                      width_mbs: int, height_mbs: int, names):
    """KF's plain version: `me.full_search_blocks`, stacked in the order of
    `names` -> [len(names), n_mbs, 2] int32."""
    mv = kme.full_search_blocks(orig_y, ref_pad, pad, search_range, lam,
                                width_mbs, height_mbs, tuple(names))
    return torch.stack([mv[n] for n in names])


def full_search(orig_y, ref_pad, pad: int, search_range: int, lam: int,
                width_mbs: int, height_mbs: int, names):
    """Integer full search of the blocks `names` (of `me.SEARCH_BLOCKS`)
    of every MB: orig_y [H, W] and the edge-padded reference ref_pad
    [Hp, Wp], int32 samples of 0..255 (a picture's luma and a
    reconstruction, or its weighted copy, as the encoders pass them; KF
    holds them as bytes) -> full-pel vectors [len(names), n_mbs, 2] int32,
    each the first in (dy, dx) raster order of the cheapest by SSD + lam *
    bits of the vector.  CPU tensors: the plain version; CUDA tensors: one
    launch of KF."""
    if orig_y.device.type == "cpu":
        return full_search_plain(orig_y, ref_pad, pad, search_range, lam,
                                 width_mbs, height_mbs, names)
    who = "me_search"
    dev = orig_y.device
    names = tuple(names)
    if dev.type != "cuda":
        raise ValueError(f"{who}: CUDA or CPU tensors expected, got {dev}")
    if not 1 <= len(names) <= MAX_NAMES or len(set(names)) != len(names) \
            or not set(names) <= set(kme.SEARCH_BLOCKS):
        raise ValueError(f"{who}: names {names} are not distinct blocks of "
                         f"{tuple(kme.SEARCH_BLOCKS)}")
    if not 0 <= search_range <= MAX_RANGE:
        raise ValueError(f"{who}: search range {search_range} is outside "
                         f"0..{MAX_RANGE}")
    win = 16 + 2 * search_range
    if orig_y.dim() != 2 or ref_pad.dim() != 2:
        raise ValueError(f"{who}: orig_y and ref_pad must be 2-D, got "
                         f"{tuple(orig_y.shape)}, {tuple(ref_pad.shape)}")
    if min(orig_y.shape) < 16 or min(ref_pad.shape) < win:
        raise ValueError(f"{who}: planes {tuple(orig_y.shape)}, "
                         f"{tuple(ref_pad.shape)} are smaller than a block or "
                         f"a {win} x {win} window")
    _build.check_tensor(who, "orig_y", orig_y, orig_y.shape, I32, dev)
    _build.check_tensor(who, "ref_pad", ref_pad, ref_pad.shape, I32, dev)
    n = width_mbs * height_mbs
    out = torch.empty((len(names), n, 2), dtype=I32, device=dev)
    if n == 0:
        return out
    key = (width_mbs, height_mbs, tuple(orig_y.shape), tuple(ref_pad.shape),
           pad, search_range, int(lam), names)
    if key not in _PARAMS:
        _PARAMS[key] = _build.host_i32(pack_params(*key))
    launches["KF"] += 1
    err = _build.lib().tpu264_me_search(
        _build.ptr(orig_y), _build.ptr(ref_pad), _build.ptr(out),
        _PARAMS[key], _build.stream_of(orig_y))
    _build.check(err, who)
    return out

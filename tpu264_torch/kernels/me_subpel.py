"""Kernel KS: the sub-pel refinement of motion estimation, every
macroblock of a picture and every block shape that has a search of its
own in one CUDA launch (`csrc/me_subpel.cu`).

`subpel` is what the P and B encoders' motion search runs after KF, once
a list.  It refines the full-pel vectors [len(names), n_mbs, 2] of the
blocks that `shapes` lists (each shape: its blocks of
`me.SEARCH_BLOCKS`, their offsets in the MB, height and width, as
`shapes()` builds them) to quarter-pel vectors in the same order.  For
CPU tensors it runs the plain version `subpel_plain`: one
`me.subpel_refine` call a shape (held to the reference's
`subpel_refine`), the shape's vectors concatenated and the result
chunked back, as the encoders did before; for CUDA tensors it launches KS
or raises, with no fallback.

No single PyTorch call computes a SATD sub-pel search, so the kernel has
no library yardstick.

`launches["KS"]` counts kernel launches.
"""

from __future__ import annotations

import torch

from . import _build
from . import me as kme
from .interp import QPEL_TABLE

I32 = torch.int32
MAX_NAMES = len(kme.SEARCH_BLOCKS)

launches = {"KS": 0}
_PARAMS: dict = {}          # packed host tables, by all of their inputs


def shapes(partitions: bool = False, p8x8: bool = False) -> list:
    """The block shapes the motion search refines, in order: (blocks of
    `me.SEARCH_BLOCKS`, their row offsets in the MB, column offsets,
    height, width): the MB, with `partitions` the 16x8 and 8x16 halves,
    with `p8x8` the 8x8 quadrants."""
    out = [(("16x16",), (0,), (0,), 16, 16)]
    if partitions:
        out += [(("top", "bot"), (0, 8), (0, 0), 8, 16),
                (("left", "right"), (0, 0), (0, 8), 16, 8)]
    if p8x8:
        out.append((("q0", "q1", "q2", "q3"), (0, 0, 8, 8), (0, 8, 0, 8),
                    8, 8))
    return out


def names_of(shape_list) -> list:
    """The blocks of `shape_list`, in the order of the vectors."""
    return [n for sh in shape_list for n in sh[0]]


def shape_table(shape_list) -> list:
    """(oy, ox, bh, bw) of every block of `shape_list`, in order."""
    return [(oy, ox, bh, bw) for blocks, oys, oxs, bh, bw in shape_list
            for _, oy, ox in zip(blocks, oys, oxs)]


def pack_params(wm: int, hm: int, orig_shape, plane_shape, pad: int,
                lam: int, table) -> list:
    """The kernel's by-value table (layout: `Params` in the CUDA
    source)."""
    flat = [v for row in table for v in row]
    return ([wm, hm, *orig_shape, *plane_shape, pad, lam, len(table)]
            + flat + [0] * (4 * (MAX_NAMES - len(table)))
            + QPEL_TABLE.reshape(-1).tolist())


def subpel_plain(orig_y, planes, pad: int, mv_int, lam: int, width_mbs: int,
                 height_mbs: int, shape_list):
    """KS's plain version: `me.subpel_refine` once a shape of
    `shape_list` on its blocks' vectors of mv_int [len(names), n_mbs, 2]
    -> [len(names), n_mbs, 2] quarter-pel."""
    out, i = [], 0
    n = width_mbs * height_mbs
    for blocks, oys, oxs, bh, bw in shape_list:
        k = len(blocks)
        # the shape's blocks one after another, as one pass refines them
        ref = kme.subpel_refine(orig_y, planes, pad,
                                mv_int[i:i + k].reshape(-1, 2), lam,
                                width_mbs, height_mbs, oy=oys, ox=oxs, bh=bh,
                                bw=bw)
        out.append(ref.reshape(k, n, 2))
        i += k
    return torch.cat(out)


def subpel(orig_y, planes, pad: int, mv_int, lam: int, width_mbs: int,
           height_mbs: int, shape_list):
    """Half- then quarter-pel refinement with SATD + lam * vector rate cost
    of every block of `shape_list` of every MB: orig_y [H, W], the
    half-pel planes [4, Hp, Wp] (`interp.luma_planes` of a reference of
    0..255, so every plane sample is 0..255, as is every source sample;
    KS holds them as bytes), the full-pel vectors mv_int [len(names),
    n_mbs, 2] (KF's), int32 -> quarter-pel vectors [len(names), n_mbs, 2]
    int32.  CPU tensors: the plain version; CUDA tensors: one launch of
    KS."""
    if orig_y.device.type == "cpu":
        return subpel_plain(orig_y, planes, pad, mv_int, lam, width_mbs,
                            height_mbs, shape_list)
    who = "me_subpel"
    dev = orig_y.device
    if dev.type != "cuda":
        raise ValueError(f"{who}: CUDA or CPU tensors expected, got {dev}")
    table = shape_table(shape_list)
    if not 1 <= len(table) <= MAX_NAMES:
        raise ValueError(f"{who}: {len(table)} blocks, not 1..{MAX_NAMES}")
    for oy, ox, bh, bw in table:
        if bh not in (8, 16) or bw not in (8, 16) \
                or not (0 <= oy <= 16 - bh and 0 <= ox <= 16 - bw):
            raise ValueError(f"{who}: block ({oy}, {ox}, {bh}, {bw}) is not "
                             f"an 8- or 16-sample partition of an MB")
    if orig_y.dim() != 2 or planes.dim() != 3 or planes.shape[0] != 4:
        raise ValueError(f"{who}: orig_y [H, W] and planes [4, Hp, Wp] "
                         f"expected, got {tuple(orig_y.shape)}, "
                         f"{tuple(planes.shape)}")
    if min(orig_y.shape) < 16 or min(planes.shape[1:]) < 16:
        raise ValueError(f"{who}: planes {tuple(orig_y.shape)}, "
                         f"{tuple(planes.shape)} are smaller than a block")
    n = width_mbs * height_mbs
    _build.check_tensor(who, "orig_y", orig_y, orig_y.shape, I32, dev)
    _build.check_tensor(who, "planes", planes, planes.shape, I32, dev)
    _build.check_tensor(who, "mv_int", mv_int, (len(table), n, 2), I32, dev)
    out = torch.empty((len(table), n, 2), dtype=I32, device=dev)
    if n == 0:
        return out
    key = (width_mbs, height_mbs, tuple(orig_y.shape),
           tuple(planes.shape[1:]), pad, int(lam), tuple(table))
    if key not in _PARAMS:
        _PARAMS[key] = _build.host_i32(pack_params(*key))
    launches["KS"] += 1
    err = _build.launch(
        "tpu264_me_subpel", orig_y, _build.ptr(orig_y), _build.ptr(planes),
        _build.ptr(mv_int), _build.ptr(out), _PARAMS[key])
    _build.check(err, who)
    return out

"""The derived inputs of a picture's entropy coding: each partition's mvd
against its spec 8.4.1.3 predictor and each 4x4 block's most probable
Intra4x4 mode, both stencils over the picture's finished MB dict.

On the card the state passes of kernels KR (`csrc/cabac_records.cu`, a
CABAC picture, `kernels/cabac_records.py`) and KV (`csrc/cavlc_slices.cu`,
a CAVLC picture, band or chunk of pictures, `kernels/cavlc_slices.py`)
derive them, both from the device code of `csrc/mb_preds.cuh` (kernel
KD's function; `launches["KD"]` of `cavlc_slices` counts it on the CAVLC
paths).  Their plain version is `preds_plain`, the eager torch helpers
of `device_cavlc` (`mpm_grid`, `mvd_16x16`, `_partition_mvds`,
`b_list_mvds`), which the CPU paths and the plain serializers and
binarizer run.  On the card a picture has at most `MAX_SLICES` slices; a
chunk of pictures may have any number in all.

No single PyTorch call computes an H.264 mv predictor or most probable
mode, so KD has no library yardstick.

This module packs and checks the pointer and parameter layout (`Io`'s
inputs and `Params`) that both CUDA sources parse.  The derivation's
tables are `tables()`; KR's wrapper appends its CABAC context tables to
them.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpu264_torch.coding.b_mbtypes import COMBO_IDX
from tpu264_torch.coding.wavefront import BLK_ORDER
from . import _build
from .transform import constant

I32 = torch.int32
KINDS = {"i": 0, "p": 1, "b": 2}
MAX_SLICES = 256
# `Io`'s input pointers in the CUDA sources, in their order; then the
# tables, the mvds, the most probable modes and each kernel's scratch
INPUTS = ("sel16", "is_inter", "t8", "luma_ac", "luma_dc", "chroma_dc",
          "chroma_ac", "modes", "cmode", "i16mode", "mv", "mv_skip", "ptype",
          "btype", "c0", "c1", "bptype", "mv2", "mvq", "use0", "use1", "mv0",
          "mv1", "mv0b", "mv1b")
BOOL_INPUTS = ("sel16", "is_inter", "t8", "use0", "use1")
SHAPES = {"luma_ac": (16, 16), "luma_dc": (16,), "chroma_dc": (2, 4),
          "chroma_ac": (2, 4, 16), "modes": (16,), "mv": (2,),
          "mv_skip": (2,), "mv2": (2,), "mvq": (4, 2), "mv0": (2,),
          "mv1": (2,), "mv0b": (2,), "mv1b": (2,)}
# what the derivation reads of each slice kind's dict, and with
# partitions ("ptype" in P, with "mvq" for P_8x8; "bptype" in B)
MOTION = {"i": (), "p": ("is_inter", "mv"),
          "b": ("btype", "use0", "use1", "mv0", "mv1")}
PART_MOTION = {"p": ("ptype", "mv2"), "b": ("bptype", "c1", "mv0b", "mv1b")}

_PARAMS: dict = {}
_SPECS: dict = {}


def pack_params(wm: int, hm: int, rows, kind: str, t8_mode: bool,
                parts: bool, p8x8: bool) -> list:
    """The kernel's host table: `Params` in the CUDA source."""
    return [wm, hm, KINDS[kind], int(t8_mode), int(parts), int(p8x8),
            len(rows), *rows, hm]


def modes_of(mbd, kind: str):
    """(partitions, P_8x8) of a picture of slice kind `kind` with MB dict
    `mbd`."""
    parts = {"p": "ptype", "b": "bptype"}.get(kind) in mbd
    return parts, kind == "p" and parts and "mvq" in mbd


def derive_keys(mbd, kind: str) -> tuple:
    """The keys of `mbd` that the derivation reads."""
    parts, p8x8 = modes_of(mbd, kind)
    return (("sel16", "modes") + MOTION[kind]
            + (PART_MOTION[kind] if parts else ())
            + (("mvq",) if p8x8 else ()))


def check_layout(who: str, hm: int, rows, kind: str) -> list:
    """`rows` as ints; raise unless `kind` is a slice kind and `rows`
    split `hm` MB rows into 1..MAX_SLICES slices starting at row 0."""
    if kind not in KINDS:
        raise ValueError(f"{who}: slice kind {kind!r} is not one of "
                         f"{tuple(KINDS)}")
    rows = [int(r) for r in rows]
    if not 1 <= len(rows) <= MAX_SLICES or rows[0] != 0 \
            or any(b <= a for a, b in zip(rows, rows[1:] + [hm])):
        raise ValueError(f"{who}: slice rows {rows} do not split {hm} MB "
                         f"rows into 1..{MAX_SLICES} slices")
    return rows


def _spec(keys, n: int) -> tuple:
    """(key, shape, dtype) of each of `Io`'s inputs for `n` MBs, None for
    those not in `keys`; made once for each set of keys and size."""
    k = (tuple(keys), n)
    if k not in _SPECS:
        _SPECS[k] = tuple(
            (key, torch.Size((n, *SHAPES.get(key, ()))),
             torch.bool if key in BOOL_INPUTS else I32) if key in keys
            else None for key in INPUTS)
    return _SPECS[k]


def input_pointers(who: str, mbd, keys, kind: str, n: int, dev) -> list:
    """The device pointers of `Io`'s inputs: those of `keys` from `mbd`
    (checked for dtype, shape, device and contiguity), null for the
    others."""
    ptrs = []
    for spec in _spec(keys, n):
        if spec is None:
            ptrs.append(0)
            continue
        key, shape, dtype = spec
        t = mbd.get(key)
        if t is None:
            raise KeyError(f"{who}: a {kind.upper()} picture's MB dict "
                           f"lacks {key!r}")
        if (t.dtype != dtype or t.shape != shape or t.device != dev
                or not t.is_contiguous()):
            _build.check_tensor(who, key, t, shape, dtype, dev)
        ptrs.append(t.data_ptr())
    return ptrs


def params(wm: int, hm: int, rows, kind: str, t8_mode: bool, parts: bool,
           p8x8: bool) -> ctypes.Array:
    """`pack_params` as a host array, made once for each layout."""
    key = (wm, hm, tuple(rows), kind, t8_mode, parts, p8x8)
    if key not in _PARAMS:
        _PARAMS[key] = _build.host_i32(pack_params(wm, hm, rows, kind,
                                                   t8_mode, parts, p8x8))
    return _PARAMS[key]


def tables() -> np.ndarray:
    """The derivation's tables, in the layout of the first `T_*` offsets
    of the CUDA source: COMBO_IDX, and BLK_ORDER as by * 4 + bx."""
    return np.concatenate([COMBO_IDX, [by * 4 + bx for by, bx in BLK_ORDER]
                           ]).astype(np.int32)


def preds_plain(mbd, wm: int, hm: int, rows, kind: str, pics: int = 1):
    """The derived inputs of `pics` pictures of slice kind `kind` ("i",
    "p" or "b"), each `hm` MB rows high with slices starting at the MB
    rows `rows`, whose MBs `mbd` holds picture after picture -> (mvds
    [pics n, 2, 4, 2] int32: list, partition, component, P's part 0 /
    q0, part 1 / q1, q2, q3 on list 0, B's part 0 and 1 on both lists,
    zeros elsewhere; None in an I picture; mpm [pics n, 16] int32, the
    most probable mode of each 4x4 block in zig-zag order), every MB
    whether it codes them or not.  The plain version of the derivation of
    KR's and KV's state passes, eager torch on any device: the helpers of
    `device_cavlc` that the CAVLC serializers and the CABAC binarizer's
    plain version call, on the pictures stacked as one picture `pics` hm
    rows high whose slices start at every picture's slice rows, so that
    no neighbour reaches across two pictures."""
    # imported here: device_cavlc takes `preds_plain` from this module
    from tpu264_torch.entropy.device_cavlc import (_partition_mvds,
                                                   b_list_mvds,
                                                   blk_grid_index, mpm_grid,
                                                   mvd_16x16)
    rows = [f * hm + int(r) for f in range(pics) for r in rows]
    hm = pics * hm
    n = wm * hm
    dev = mbd["modes"].device
    if kind == "b":
        is_inter = mbd["btype"] != 4
    elif kind == "p":
        is_inter = mbd["is_inter"].to(torch.bool)
    else:
        is_inter = None
    is_i4 = ~mbd["sel16"].to(torch.bool)
    if is_inter is not None:
        is_i4 = is_i4 & ~is_inter

    def flat_index():
        r, c = blk_grid_index(wm, hm, "cpu")
        return r * (4 * wm) + c
    blk = constant(("kr_blk", wm, hm), dev, flat_index)
    grid = torch.full((hm * 4 * wm * 4,), -1, dtype=I32, device=dev)
    grid[blk] = torch.where(is_i4[:, None], mbd["modes"].to(I32), -1)
    mpm = mpm_grid(grid.view(hm * 4, wm * 4), [r * 4 for r in rows]) \
        .reshape(-1)[blk].contiguous()
    if kind == "i":
        return None, mpm
    zero = torch.zeros((n, 2), dtype=I32, device=dev)
    if kind == "p":
        if "ptype" in mbd:
            got = _partition_mvds(mbd, wm, hm, rows)
            parts = [got[0], got[1]]
            if "mvq" in mbd:
                parts += [got[2][:, 2], got[2][:, 3]]
        else:
            parts = [mvd_16x16(mbd["mv"].to(I32), is_inter, wm, hm, rows)]
        lists = [parts + [zero] * (4 - len(parts)), [zero] * 4]
    else:
        lists = [[d0, zero if d1 is None else d1, zero, zero]
                 for d0, d1 in b_list_mvds(mbd, wm, hm, rows)]
    mvds = torch.stack([torch.stack(p, 1) for p in lists], 1).to(I32)
    return mvds.contiguous(), mpm

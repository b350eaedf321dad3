"""Kernel KR: CABAC binarize + compact of a picture in one call of four
launches (`csrc/cabac_records.cu`).

`records` is what the encoders' `cabac_records` runs on the card: a
picture's raster MB dict (I, P or B slices) -> packed records [n_slices,
width] int32, zero past each count, and the counts [n_slices] int32, as
K1 takes them.  A slice with more records than `cap` keeps every record:
the rows are then as wide as the largest slice, so the stream is the one
an unbounded buffer gives.  KR launches its state, count and scan passes,
the host reads the largest count once, and the emit pass writes into
rows of that width.  For CPU tensors it runs the plain version
`records_plain`, the port's `cabac_binarize.binarize_frame` +
`compact_slices` (held to the reference's binarizer); for CUDA tensors
it launches KR or raises, with no fallback.

The kernel's inputs beyond the MB dict stay eager torch (`inputs`): the
mvds of every partition (`device_cavlc` `mvd_16x16`, `_partition_mvds`,
`b_list_mvds`, which the CAVLC serializer shares) and the most probable
Intra4x4 modes (`mpm_grid`).  `records` derives them itself where it is
not given them.

No single PyTorch call binarizes CABAC syntax, so the kernel has no
library yardstick.

`launches["KR"]` counts KR's runs, one a picture (four launches).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpu264_torch.coding.b_mbtypes import COMBO_IDX
from tpu264_torch.coding.wavefront import BLK_ORDER
from tpu264_torch.entropy import cabac_binarize as cbz
from tpu264_torch.entropy.cabac_ctx import (CBF_CAT_OFF, LAST8_MAP,
                                            LVL_CAT_OFF, SIG8_MAP,
                                            SIG_CAT_OFF)
from tpu264_torch.entropy.device_cavlc import (_partition_mvds, b_list_mvds,
                                               blk_grid_index, mpm_grid,
                                               mvd_16x16)
from . import _build
from .transform import constant

I32 = torch.int32
KINDS = {"i": 0, "p": 1, "b": 2}
MAX_SLICES = 256
STATE_WORDS = 16
# `Io`'s pointers in the CUDA source, in its order
INPUTS = ("sel16", "is_inter", "t8", "luma_ac", "luma_dc", "chroma_dc",
          "chroma_ac", "modes", "cmode", "i16mode", "mv", "mv_skip", "ptype",
          "btype", "c0", "c1", "bptype")
BOOL_INPUTS = ("sel16", "is_inter", "t8")
SHAPES = {"luma_ac": (16, 16), "luma_dc": (16,), "chroma_dc": (2, 4),
          "chroma_ac": (2, 4, 16), "modes": (16,), "mv": (2,),
          "mv_skip": (2,)}
# what each slice kind reads of the dict (with partitions also "ptype",
# or "bptype", "c0" and "c1")
NEEDS = {"i": (), "p": ("is_inter", "mv", "mv_skip"), "b": ("btype",)}
COMMON = ("sel16", "luma_ac", "luma_dc", "chroma_dc", "chroma_ac", "modes",
          "cmode", "i16mode")

launches = {"KR": 0}
_PARAMS: dict = {}


def tables() -> np.ndarray:
    """The kernel's context tables, in the layout of the `T_*` offsets of
    the CUDA source: CBF_CAT_OFF, SIG_CAT_OFF, LVL_CAT_OFF, SIG8_MAP,
    LAST8_MAP[:63], COMBO_IDX, and BLK_ORDER as by * 4 + bx."""
    return np.concatenate([
        CBF_CAT_OFF, SIG_CAT_OFF, LVL_CAT_OFF, SIG8_MAP, LAST8_MAP[:63],
        COMBO_IDX, [by * 4 + bx for by, bx in BLK_ORDER]]).astype(np.int32)


def pack_params(wm: int, hm: int, rows, kind: str, t8_mode: bool,
                parts: bool, p8x8: bool) -> list:
    """The kernel's host table: `Params` in the CUDA source."""
    return [wm, hm, KINDS[kind], int(t8_mode), int(parts), int(p8x8),
            len(rows), *rows, hm]


def _blk_index(wm: int, hm: int, dev):
    """Each MB's 4x4 blocks (zig-zag index) in the flat [4hm * 4wm] block
    grid -> [n, 16] int64, made once a device."""
    def make():
        r, c = blk_grid_index(wm, hm, "cpu")
        return r * (4 * wm) + c
    return constant(("kr_blk", wm, hm), dev, make)


def inputs(mbd, wm: int, hm: int, rows, kind: str):
    """The eager inputs of KR for a picture of slice kind `kind` -> (mvds
    [n, 2, 4, 2] int32 (list, partition, component: P's part 0 / q0,
    part 1 / q1, q2, q3 on list 0; B's part 0 and 1 on both lists; None
    in an I picture), mpm [n, 16] int32, the most probable mode of each
    4x4 block in zig-zag order)."""
    n = wm * hm
    dev = mbd["luma_ac"].device
    rows = [int(r) for r in rows]
    if kind == "b":
        is_inter = mbd["btype"] != 4
    elif kind == "p":
        is_inter = mbd["is_inter"].to(torch.bool)
    else:
        is_inter = None
    is_i4 = ~mbd["sel16"].to(torch.bool)
    if is_inter is not None:
        is_i4 = is_i4 & ~is_inter
    blk = _blk_index(wm, hm, dev)
    grid = torch.full((hm * 4 * wm * 4,), -1, dtype=I32, device=dev)
    grid[blk] = torch.where(is_i4[:, None], mbd["modes"].to(I32), -1)
    mpm = mpm_grid(grid.view(hm * 4, wm * 4), [r * 4 for r in rows]) \
        .reshape(-1)[blk].contiguous()
    if kind == "i":
        return None, mpm
    if kind == "p":
        if "ptype" in mbd:
            got = _partition_mvds(mbd, wm, hm, rows)
            parts = [got[0], got[1]]
            if "mvq" in mbd:
                parts += [got[2][:, 2], got[2][:, 3]]
        else:
            parts = [mvd_16x16(mbd["mv"].to(I32), is_inter, wm, hm, rows)]
        zero = torch.zeros((n, 2), dtype=I32, device=dev)
        lists = [parts + [zero] * (4 - len(parts)), [zero] * 4]
    else:
        zero = torch.zeros((n, 2), dtype=I32, device=dev)
        lists = [[d0, zero if d1 is None else d1, zero, zero]
                 for d0, d1 in b_list_mvds(mbd, wm, hm, rows)]
    mvds = torch.stack([torch.stack(p, 1) for p in lists], 1).to(I32)
    return mvds.contiguous(), mpm


def read_keys(mbd, kind: str) -> tuple:
    """The keys of MB dict `mbd` that KR reads in a picture of slice kind
    `kind`: with partitions ("ptype" in P, "bptype" in B) their types,
    and "t8" where the dict has it."""
    parts = {"p": ("ptype",), "b": ("bptype", "c0", "c1")}.get(kind, ())
    return (COMMON + NEEDS[kind] + (parts if parts and parts[0] in mbd
                                    else ())
            + (("t8",) if "t8" in mbd else ()))


def records_plain(mbd, wm: int, hm: int, rows, kind: str, cap: int,
                  t8_mode: bool = False):
    """KR's plain version: `binarize_frame` + `compact_slices`, compacted
    again with room for the largest slice where one is over `cap` ->
    (records [n_slices, max(cap, largest)], counts [n_slices]).
    `t8_mode`: the PPS has the 8x8 transform (a dict without "t8" then
    codes a zero map)."""
    rows = [int(r) for r in rows]
    if t8_mode and "t8" not in mbd:
        mbd = dict(mbd, t8=torch.zeros(wm * hm, dtype=torch.bool,
                                       device=mbd["luma_ac"].device))
    k, a, b, v = cbz.binarize_frame(mbd, wm, hm, rows, p_slice=kind == "p",
                                    b_slice=kind == "b")
    recs, counts = cbz.compact_slices(k, a, b, v, wm, rows, hm, cap)
    need = int(counts.max())
    if need > cap:
        recs, counts = cbz.compact_slices(k, a, b, v, wm, rows, hm, need)
    return recs, counts


def records(mbd, mvds, mpm, wm: int, hm: int, rows, kind: str, cap: int,
            t8_mode: bool = False):
    """Binarize + compact a picture of slice kind `kind` ("i", "p" or "b")
    whose slices start at the MB rows `rows`, from its raster MB dict and
    the eager inputs `inputs` gives (`mvds`, `mpm`; `mpm` None: derived
    here) -> (records [n_slices, max(cap, largest)] int32, zero past each
    count; counts [n_slices] int32).  CPU tensors: the plain version
    (which derives `mvds` and `mpm` itself); CUDA tensors: KR's four
    launches with one host read of the largest count between them."""
    dev = mbd["luma_ac"].device
    if dev.type == "cpu":
        return records_plain(mbd, wm, hm, rows, kind, cap, t8_mode)
    who = "cabac_records"
    if dev.type != "cuda":
        raise ValueError(f"{who}: CUDA or CPU tensors expected, got {dev}")
    if kind not in KINDS:
        raise ValueError(f"{who}: slice kind {kind!r} is not one of "
                         f"{tuple(KINDS)}")
    rows = [int(r) for r in rows]
    if not 1 <= len(rows) <= MAX_SLICES or rows[0] != 0 \
            or any(b <= a for a, b in zip(rows, rows[1:] + [hm])):
        raise ValueError(f"{who}: slice rows {rows} do not split {hm} MB "
                         f"rows into 1..{MAX_SLICES} slices")
    if cap < 0:
        raise ValueError(f"{who}: negative cap {cap}")
    if mpm is None:
        mvds, mpm = inputs(mbd, wm, hm, rows, kind)
    n = wm * hm
    parts = {"p": "ptype", "b": "bptype"}.get(kind) in mbd
    p8x8 = kind == "p" and parts and "mvq" in mbd
    t8_mode = bool(t8_mode or "t8" in mbd)
    keys = read_keys(mbd, kind)
    ptrs = []
    for key in INPUTS:
        if key not in keys:
            ptrs.append(0)
            continue
        if key not in mbd:
            raise KeyError(f"{who}: a {kind.upper()} picture's MB dict "
                           f"lacks {key!r}")
        t = mbd[key]
        dtype = torch.bool if key in BOOL_INPUTS else I32
        _build.check_tensor(who, key, t, (n, *SHAPES.get(key, ())), dtype,
                            dev)
        ptrs.append(t.data_ptr())
    if kind == "i":
        if mvds is not None:
            raise ValueError(f"{who}: an I picture has no mvds")
        ptrs.append(0)
    else:
        _build.check_tensor(who, "mvds", mvds, (n, 2, 4, 2), I32, dev)
        ptrs.append(mvds.data_ptr())
    _build.check_tensor(who, "mpm", mpm, (n, 16), I32, dev)
    tab = constant(("kr_tables",), dev, tables)
    state = torch.empty((n, STATE_WORDS), dtype=I32, device=dev)
    mb_count = torch.empty(n, dtype=I32, device=dev)
    mb_off = torch.empty(n, dtype=I32, device=dev)
    counts = torch.empty(len(rows) + 1, dtype=I32, device=dev)
    ptrs += [mpm.data_ptr(), tab.data_ptr(), state.data_ptr(),
             mb_count.data_ptr(), mb_off.data_ptr(), counts.data_ptr()]
    key = (wm, hm, tuple(rows), kind, t8_mode, parts, p8x8)
    if key not in _PARAMS:
        _PARAMS[key] = _build.host_i32(pack_params(wm, hm, rows, kind,
                                                   t8_mode, parts, p8x8))
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    stream = _build.stream_of(counts)
    launches["KR"] += 1
    _build.check(_build.lib().tpu264_cabac_records(
        c_ptrs, _PARAMS[key], None, 0, 0, stream), who)
    recs = torch.empty((len(rows), max(cap, int(counts[-1]))), dtype=I32,
                       device=dev)
    _build.check(_build.lib().tpu264_cabac_records(
        c_ptrs, _PARAMS[key], _build.ptr(recs), recs.shape[1], 1, stream),
        who)
    return recs, counts[:-1]

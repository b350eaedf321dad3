"""Kernel KR: CABAC binarize + compact of a picture in one run of four
launches (`csrc/cabac_records.cu`).

`queue` is what the encoders' `cabac_records` runs on the card: a
picture's raster MB dict (I, P or B slices) -> its packed records
[n_slices, width] int32, zero past each count, and the counts [n_slices]
int32, as K1 takes them.  A slice with more records than `cap` keeps
every record: the rows are then as wide as the largest slice, so the
stream is the one an unbounded buffer gives.

KR derives its own inputs beyond the MB dict on the card (the mvds of
every partition and the most probable Intra4x4 modes, in its state
pass) and reads nothing back while it is queued: it launches its state,
count, scan and emit passes with rows `cap` wide, copies the largest
count into pinned host memory and records an event (`Queued`).  The
host half (`Queued.result`, or unpacking it) waits on that event, not on
the stream, and only where a slice is over the cap launches the emit pass
again into rows as wide as the largest slice.  `records` is both halves
at once.  The pinned words and their events are kept for reuse, a few a
device, as many as runs are queued at once; KR's scratch is one
allocation a run.

For CPU tensors `queue` and `records` run the plain version
`records_plain`, the port's `cabac_binarize.binarize_frame` +
`compact_slices` (held to the reference's binarizer); for CUDA tensors
they launch KR or raise, with no fallback.  The plain version of KR's
derived inputs is `mb_preds.preds_plain`.

No single PyTorch call binarizes CABAC syntax, so the kernel has no
library yardstick.

`launches["KR"]` counts KR's runs, one a picture (four launches; five
where a slice is over the cap).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpu264_torch.entropy import cabac_binarize as cbz
from tpu264_torch.entropy.cabac_ctx import (CBF_CAT_OFF, LAST8_MAP,
                                            LVL_CAT_OFF, SIG8_MAP,
                                            SIG_CAT_OFF)
from . import _build
from . import mb_preds as mp
from .transform import constant

I32 = torch.int32
STATE_WORDS = 16
# what each slice kind's records read of the dict besides the derivation's
# keys (`mb_preds.derive_keys`)
CODED = ("luma_ac", "luma_dc", "chroma_dc", "chroma_ac", "cmode", "i16mode")
NEEDS = {"i": (), "p": ("mv_skip",), "b": ()}

# KR's scratch, one int32 allocation a run: (name, words a MB), each part
# starting on a 128-byte boundary; the counts follow
SCRATCH = (("state", STATE_WORDS), ("mb_count", 1), ("mb_off", 1),
           ("lane_off", 32), ("mvds", 16), ("mpm", 16))
ALIGN = 32

launches = {"KR": 0}
# pinned int32 words and CUDA events free for reuse, by device
_HOST: dict = {}


def tables() -> np.ndarray:
    """KR's tables, in the layout of the CUDA source's `T_*` offsets: the
    derivation's (`mb_preds.tables()`), then CBF_CAT_OFF, SIG_CAT_OFF,
    LVL_CAT_OFF, SIG8_MAP and LAST8_MAP[:63]."""
    return np.concatenate([
        mp.tables(), CBF_CAT_OFF, SIG_CAT_OFF, LVL_CAT_OFF, SIG8_MAP,
        LAST8_MAP[:63]]).astype(np.int32)


def scratch(n: int, n_slices: int, kind: str, dev) -> tuple:
    """KR's scratch for `n` MBs and `n_slices` slices in one allocation ->
    (the allocation, the device pointers of `Io`'s mvds (null in an I
    picture), mpm, state, mb_count, mb_off, lane_off and counts, the mvds
    [n, 2, 4, 2] (None in an I picture), the mpm [n, 16], the counts
    [n_slices + 1])."""
    offs, at = {}, 0
    for name, words in SCRATCH:
        offs[name] = at
        at += -(-n * words // ALIGN) * ALIGN
    work = torch.empty(at + n_slices + 1, dtype=I32, device=dev)
    base = work.data_ptr()
    ptrs = [base + 4 * offs[k] for k, _ in SCRATCH[4:] + SCRATCH[:4]]
    ptrs.append(base + 4 * at)
    mvds = None
    if kind == "i":
        ptrs[0] = 0
    else:
        mvds = work[offs["mvds"]:offs["mvds"] + 16 * n].view(n, 2, 4, 2)
    mpm = work[offs["mpm"]:offs["mpm"] + 16 * n].view(n, 16)
    return work, ptrs, mvds, mpm, work[at:]


def _host_slot(dev) -> tuple:
    """A pinned int32 word and a CUDA event of `dev` that no queued run
    holds."""
    try:
        return _HOST.setdefault(dev, []).pop()
    except IndexError:
        return (torch.empty(1, dtype=I32, pin_memory=True),
                torch.cuda.Event())


def read_keys(mbd, kind: str) -> tuple:
    """The keys of MB dict `mbd` that KR reads in a picture of slice kind
    `kind`: the derivation's (`mb_preds.derive_keys`), the coefficients,
    the modes, "mv_skip" in P, "c0" in B with partitions, and "t8" where
    the dict has it."""
    parts, _ = mp.modes_of(mbd, kind)
    return (mp.derive_keys(mbd, kind) + CODED + NEEDS[kind]
            + (("c0",) if kind == "b" and parts else ())
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


class Queued:
    """A KR run on the card whose records the host has not read: its
    derived inputs (`mvds`, `mpm`), the counts on the card and the rows
    of the first emit.  `result()` (or unpacking it) -> (records [n_slices,
    max(cap, largest)], counts [n_slices]): it waits on the event after the
    copy of the largest count, not on the stream, and launches the emit
    pass again into wider rows where a slice is over the cap.

    That emit is queued behind whatever the caller queued since (the
    encoders: the deblocking stage and the next frame), and reads the
    tensors that `_keep` holds: the MB dict, which the encoders make anew
    for each picture and then only read, and KR's own tables and scratch.
    No later work writes them, so it reads what the first emit read."""

    def __init__(self, keep, ptrs, params, recs, counts, mvds, mpm):
        self._keep = keep               # the tensors that `ptrs` point at
        self._ptrs, self._params = ptrs, params
        self._recs, self._counts = recs, counts
        self.mvds, self.mpm = mvds, mpm
        self._dev = counts.device
        self._largest, self._event = _host_slot(self._dev)
        self._largest.copy_(counts[-1:], non_blocking=True)
        self._event.record(torch.cuda.current_stream(self._dev))
        self._done = None

    def result(self):
        if self._done is None:
            self._event.synchronize()
            need = int(self._largest[0])
            _HOST[self._dev].append((self._largest, self._event))
            self._largest = self._event = None
            recs = self._recs
            if need > recs.shape[1]:
                recs = torch.empty((recs.shape[0], need), dtype=I32,
                                   device=recs.device)
                _build.check(_build.launch(
                    "tpu264_cabac_records", recs, self._ptrs, self._params,
                    _build.ptr(recs), need, 1), "cabac_records")
            self._done = (recs, self._counts[:-1])
            self._keep = self._ptrs = None
        return self._done

    def __iter__(self):
        return iter(self.result())


def queue(mbd, wm: int, hm: int, rows, kind: str, cap: int,
          t8_mode: bool = False):
    """Binarize + compact a picture of slice kind `kind` ("i", "p" or "b")
    whose slices start at the MB rows `rows`, from its raster MB dict.
    CPU tensors: the plain version's (records [n_slices, max(cap,
    largest)] int32, zero past each count; counts [n_slices] int32); CUDA
    tensors: KR's four launches and nothing read back -> a `Queued`, which
    unpacks to the same pair."""
    dev = mbd["luma_ac"].device
    if dev.type == "cpu":
        return records_plain(mbd, wm, hm, rows, kind, cap, t8_mode)
    who = "cabac_records"
    if dev.type != "cuda":
        raise ValueError(f"{who}: CUDA or CPU tensors expected, got {dev}")
    rows = mp.check_layout(who, hm, rows, kind)
    if cap < 0:
        raise ValueError(f"{who}: negative cap {cap}")
    n = wm * hm
    parts, p8x8 = mp.modes_of(mbd, kind)
    t8_mode = bool(t8_mode or "t8" in mbd)
    keys = read_keys(mbd, kind)
    ptrs = mp.input_pointers(who, mbd, keys, kind, n, dev)
    tab = constant(("kr_tables",), dev, tables)
    work, wptrs, mvds, mpm, counts = scratch(n, len(rows), kind, dev)
    ptrs += [tab.data_ptr()] + wptrs
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    params = mp.params(wm, hm, rows, kind, t8_mode, parts, p8x8)
    recs = torch.empty((len(rows), cap), dtype=I32, device=dev)
    launches["KR"] += 1
    _build.check(_build.launch("tpu264_cabac_records", recs, c_ptrs,
                               params, _build.ptr(recs), cap, 0), who)
    return Queued([mbd[k] for k in keys] + [tab, work], c_ptrs, params,
                  recs, counts, mvds, mpm)


def records(mbd, wm: int, hm: int, rows, kind: str, cap: int,
            t8_mode: bool = False):
    """`queue` and, on the card, its host half at once -> (records
    [n_slices, max(cap, largest)] int32, counts [n_slices] int32)."""
    return tuple(queue(mbd, wm, hm, rows, kind, cap, t8_mode))

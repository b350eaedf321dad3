"""Kernel KB: the B wave body after the Intra4x4 search as one CUDA launch
a wave (`csrc/b_wave.cu`).

`b_wave` is what `coding.b_frame.wave_body` runs for CUDA tensors, after
the I4x4 wave kernel (`i4x4_wave.i4x4_wave_bd`) on the same stream; the
plain version is `coding.b_frame.b_wave_plain` (same inputs), part of
`wave_body_plain`.  The kernel reads the lanes' neighbour context from the
border buffers and their neighbour vectors from both lists' maps at the
wave's coordinates, writes the wave's results into `out` (rows of the
frame's output arrays, see `alloc_outputs`), the finished macroblocks'
borders back into the buffers and their vectors into the maps, in place.
With `partitions` it also weighs the 16x8 and 8x16 two-partition
candidates, on the frames that allow them.  Its tables (the two quantiser
sets of K3's wave form, the inter rounding, the lambdas, the quarter-pel
table, the flags, the mb_type bits) go in by value, packed here
from the Python tables the plain version uses (`pack_params`).  There is
no fallback to the plain version: a kernel that does not build or launch
raises.

`launches["KB"]` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from tpu264_torch.coding.b_mbtypes import TB_PART, TYPE_BITS
from . import _build
from . import i16_chroma_wave as k3w
from .interp import QPEL_TABLE

I32 = torch.int32
_PARAMS: dict = {}

launches = {"KB": 0}

# the B wave body's results: name -> (shape after the lane axis, type);
# "modes" is written by the I4x4 wave kernel
OUTPUTS = {"btype": ((), I32), "mv0": ((2,), I32), "mv1": ((2,), I32),
           "use0": ((), torch.bool), "use1": ((), torch.bool),
           **k3w.OUTPUTS}
# and those of the partitions, present with `partitions`
PART_OUTPUTS = {"bptype": ((), I32), "c0": ((), I32), "c1": ((), I32),
                "mv0b": ((2,), I32), "mv1b": ((2,), I32)}
# the halves' own vectors, mv_parts [B, 4, 2] per list
HALVES = ("top", "bot", "left", "right")


def outputs(partitions: bool = False) -> dict:
    """The results of a B wave, in the reference's keys."""
    return {**OUTPUTS, **(PART_OUTPUTS if partitions else {})}


def alloc_outputs(lead: tuple, device, partitions: bool = False) -> dict:
    """Uninitialised result arrays of shape lead + the per-lane shape:
    lead = (B,) for one wave, (n_waves, max_wave) for a frame."""
    return {k: torch.empty(tuple(lead) + shape, dtype=dtype, device=device)
            for k, (shape, dtype) in outputs(partitions).items()}


def pack_params(qp: int, cqp: int, lam4: int, lam24: int, lam_me: int,
                blk_order: tuple, partitions: bool = False,
                allow_parts: bool = False):
    """The kernel's by-value tables as a host int32 array (layout: see
    `tpu264_b_wave` in the CUDA source), cached."""
    key = (qp, cqp, lam4, lam24, lam_me, blk_order, partitions, allow_parts)
    if key not in _PARAMS:
        vals = (list(k3w.pack_params(qp, cqp, blk_order))
                + [(1 << (15 + qp // 6)) // 6, (1 << (15 + cqp // 6)) // 6,
                   lam4, lam24, lam_me]
                + QPEL_TABLE.reshape(-1).tolist()
                + [int(partitions) | int(partitions and allow_parts) << 1]
                + TB_PART.reshape(-1).tolist() + list(TYPE_BITS))
        assert len(vals) == PARAMS_LEN
        _PARAMS[key] = _build.host_i32(vals)
    return _PARAMS[key]


# K3's two quantiser sets and scans, the inter rounding, the lambdas, the
# quarter-pel table, the flags, the mb_type bits of the partitions and of
# B_L0 / B_L1 / B_Bi_16x16
PARAMS_LEN = 2 * 55 + 32 + 5 + 16 * 7 + 1 + 18 + 3


def b_wave(bd: dict, maps: tuple, planes: tuple, cpads: tuple, coords,
           avail, mv_me: tuple, mv_parts: tuple, colzero, colmixed, gy, gu,
           gv, mb4, modebuf, coeffs4, j4, qp: int, cqp: int, lam4: int,
           lam24: int, lam_me: int, blk_order: tuple, out: dict,
           partitions: bool = False, allow_parts: bool = False) -> None:
    """The B wave body after the I4x4 search, for B lanes on the card, one
    launch: reads the lanes' context from the border buffers `bd` and their
    neighbour vectors from maps = (mv0_map, ref0_map, mv1_map, ref1_map)
    ([3,hm+2,wm+2,2] / [3,hm+2,wm+2] a list) at coords [B,2] (int32
    (r, c)) with avail [B,4] (bool); planes = the two references' half-pel
    planes [4,Hp,Wp], cpads = their padded chroma (u0, v0, u1, v1); the
    lanes' search vectors mv_me = (list 0, list 1) [B,2], with
    `partitions` the halves' mv_parts = (list 0, list 1) [B,4,2]
    (`HALVES`); colzero, colmixed [B] bool; source tiles gy [B,16,16], gu,
    gv [B,8,8] and the I4x4 results (recon, mode grid, scanned levels,
    cost).  Writes every result of `outputs(partitions)` but "modes" into
    `out`, the lanes' last rows and columns into `bd` and their vectors
    into the maps."""
    who = "b_wave"
    dev = gy.device
    b, wm, hm = k3w.check_wave_inputs(who, bd, coords, avail, dev)
    hp, wp = planes[0].shape[1:]
    hc, wc = cpads[0].shape
    checks = [("gy", gy, (b, 16, 16)), ("gu", gu, (b, 8, 8)),
              ("gv", gv, (b, 8, 8)), ("mb4", mb4, (b, 16, 16)),
              ("modebuf", modebuf, (b, 4, 4)),
              ("coeffs4", coeffs4, (b, 16, 16)), ("j4", j4, (b,))]
    for lx in range(2):
        checks += [(f"mv{lx}_map", maps[2 * lx], (3, hm + 2, wm + 2, 2)),
                   (f"ref{lx}_map", maps[2 * lx + 1], (3, hm + 2, wm + 2)),
                   (f"planes{lx}", planes[lx], (4, hp, wp)),
                   (f"mv_me{lx}", mv_me[lx], (b, 2))]
        if partitions:
            checks.append((f"mv_parts{lx}", mv_parts[lx], (b, 4, 2)))
    checks += [(f"cpads[{i}]", t, (hc, wc)) for i, t in enumerate(cpads)]
    for name, t, shape in checks:
        _build.check_tensor(who, name, t, shape, I32, dev)
    for name, t in (("colzero", colzero), ("colmixed", colmixed)):
        _build.check_tensor(who, name, t, (b,), torch.bool, dev)
    if not partitions:
        mv_parts = mv_me            # not read
    if hp < 16 or wp < 16 or hc < 9 or wc < 9:
        raise ValueError(f"{who}: reference planes {(hp, wp)}, {(hc, wc)} "
                         "are smaller than a block")
    want = outputs(partitions)
    for k, (shape, dtype) in want.items():
        if k != "modes":
            _build.check_tensor(who, f"out[{k!r}]", out[k], (b,) + shape,
                                dtype, dev)
    # the partitions' outputs without partitions: no pointer (none written)
    ptrs = ([bd[k].data_ptr() for k in k3w.BORDERS]
            + [t.data_ptr() for t in (*maps, *planes, *cpads, coords, avail,
                                       *mv_me, *mv_parts, colzero, colmixed,
                                       gy, gu, gv, mb4, modebuf, coeffs4,
                                       j4)]
            + [out[k].data_ptr() if k in want else 0 for k in PART_OUTPUTS]
            + [out[k].data_ptr() for k in OUTPUTS if k != "modes"])
    ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    launches["KB"] += 1
    err = _build.lib().tpu264_b_wave(
        ptrs, pack_params(int(qp), int(cqp), int(lam4), int(lam24),
                          int(lam_me), blk_order, bool(partitions),
                          bool(allow_parts)),
        _build.host_i32([wm, hm, hp, wp, hc, wc]), b, _build.stream_of(gy))
    _build.check(err, "tpu264_b_wave")

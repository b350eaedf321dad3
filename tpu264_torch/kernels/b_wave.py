"""Kernel KB: the B wave body, the Intra4x4 search included, as one CUDA
launch a B picture (`csrc/b_wave.cu`).

`b_frame` is what `coding.b_frame.frame_body` runs for CUDA tensors; the
plain version is `coding.b_frame.b_frame_plain` (same inputs), a loop of
`wave_body_plain` over the waves.  One cooperative launch runs the waves
[w0, w1) of a picture's wave table (the per-wave arrays [n_waves, bmax,
...] that the encoder builds) in order, with a grid-wide barrier between
waves, in the frame form KP shares (`p_wave.py`, `csrc/frame_wave.cuh`):
the lanes read their neighbour context from the border buffers and their
neighbour vectors from both lists' maps, write each wave's results into
its row of `out` (`alloc_outputs`), the finished macroblocks' borders back
into the buffers and their vectors into the maps, in place.  With
`partitions` it also weighs the 16x8 and 8x16 two-partition candidates,
on the frames that allow them.  Its tables (K2's for the Intra4x4 search,
the two quantiser sets of K3's wave form, the inter rounding, the
lambdas, the quarter-pel table, the flags, the mb_type bits) go in by
value, packed here from the Python tables the plain version uses
(`pack_params`, `i4x4_wave.pack_params`), once a call, which is once a
picture.  There is no fallback to the plain version: a kernel that does
not build, or a cooperative launch that the card refuses, raises.

`launches["KB"]` counts kernel launches.
"""

from __future__ import annotations

import torch

from tpu264_torch.coding.b_mbtypes import TB_PART, TYPE_BITS
from . import _build
from . import i16_chroma_wave as k3w
from . import i4x4_wave as k2w
from .interp import QPEL_TABLE

I32 = torch.int32
_PARAMS: dict = {}

launches = {"KB": 0}

# the B wave body's results: name -> (shape after the lane axis, type)
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
    `tpu264_b_frame` in the CUDA source), cached."""
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


def frame_args(bd: dict, maps: tuple, planes: tuple, cpads: tuple, coords,
               avail, mv_me: tuple, mv_parts: tuple, colzero, colmixed, gy,
               gu, gv, qp: int, cqp: int, lam4: int, lam24: int, lam_me: int,
               blk_order: tuple, rules: tuple, out: dict,
               partitions: bool = False, allow_parts: bool = False,
               waves=None) -> _build.FrameArgs:
    """Check a B picture's inputs (on whatever device they lie) and lay
    them out for `tpu264_b_frame` (see `b_frame`)."""
    who = "b_frame"
    dev = gy.device
    n, bmax, wm, hm, w0, w1 = k3w.check_frame_inputs(who, bd, coords, avail,
                                                     dev, waves)
    hp, wp = planes[0].shape[1:]
    hc, wc = cpads[0].shape
    lead = (n, bmax)
    checks = [("gy", gy, lead + (16, 16)), ("gu", gu, lead + (8, 8)),
              ("gv", gv, lead + (8, 8))]
    for lx in range(2):
        checks += [(f"mv{lx}_map", maps[2 * lx], (3, hm + 2, wm + 2, 2)),
                   (f"ref{lx}_map", maps[2 * lx + 1], (3, hm + 2, wm + 2)),
                   (f"planes{lx}", planes[lx], (4, hp, wp)),
                   (f"mv_me{lx}", mv_me[lx], lead + (2,))]
        if partitions:
            checks.append((f"mv_parts{lx}", mv_parts[lx], lead + (4, 2)))
    checks += [(f"cpads[{i}]", t, (hc, wc)) for i, t in enumerate(cpads)]
    for name, t, shape in checks:
        _build.check_tensor(who, name, t, shape, I32, dev)
    for name, t in (("colzero", colzero), ("colmixed", colmixed)):
        _build.check_tensor(who, name, t, lead, torch.bool, dev)
    if gy.data_ptr() % 16:
        raise ValueError(f"{who}: gy must be 16-byte aligned")
    if not partitions:
        mv_parts = mv_me            # not read
    if hp < 16 or wp < 16 or hc < 9 or wc < 9:
        raise ValueError(f"{who}: reference planes {(hp, wp)}, {(hc, wc)} "
                         "are smaller than a block")
    want = outputs(partitions)
    for k, (shape, dtype) in want.items():
        _build.check_tensor(who, f"out[{k!r}]", out[k], lead + shape, dtype,
                            dev)
    # the partitions' outputs without partitions: no pointer (none written)
    tensors = ([bd[k] for k in k3w.BORDERS]
               + [*maps, *planes, *cpads, coords, avail, *mv_me, *mv_parts,
                  colzero, colmixed, gy, gu, gv]
               + [out[k] if k in want else None for k in PART_OUTPUTS]
               + [out[k] for k in OUTPUTS])
    return _build.FrameArgs(
        tensors,
        pack_params(int(qp), int(cqp), int(lam4), int(lam24), int(lam_me),
                    blk_order, bool(partitions), bool(allow_parts)),
        k2w.pack_params(int(qp), int(lam4), int(lam24), rules),
        [wm, hm, hp, wp, hc, wc], bmax, (w0, w1))


def b_frame(bd: dict, maps: tuple, planes: tuple, cpads: tuple, coords,
            avail, mv_me: tuple, mv_parts: tuple, colzero, colmixed, gy, gu,
            gv, qp: int, cqp: int, lam4: int, lam24: int, lam_me: int,
            blk_order: tuple, rules: tuple, out: dict,
            partitions: bool = False, allow_parts: bool = False,
            waves=None) -> None:
    """The B wave body of waves [w0, w1) of a picture (`waves`; None: all)
    on the card, one cooperative launch: the wave table coords
    [n_waves, bmax, 2] (int32 (r, c)) with avail [n_waves, bmax, 4]
    (bool); the lanes' context from the border buffers `bd` and their
    neighbour vectors from maps = (mv0_map, ref0_map, mv1_map, ref1_map)
    ([3,hm+2,wm+2,2] / [3,hm+2,wm+2] a list); planes = the two references'
    half-pel planes [4,Hp,Wp], cpads = their padded chroma (u0, v0, u1,
    v1); the lanes' search vectors mv_me = (list 0, list 1) [n_waves,
    bmax, 2], with `partitions` the halves' mv_parts = (list 0, list 1)
    [n_waves, bmax, 4, 2] (`HALVES`); colzero, colmixed [n_waves, bmax]
    bool; source tiles gy [n_waves, bmax, 16, 16], gu, gv [.., 8, 8];
    `blk_order` and `rules` as `p_wave.p_frame` takes them.  Writes every
    result of `outputs(partitions)` into the waves' rows of `out`, the
    lanes' last rows and columns into `bd` and their vectors into the
    maps."""
    dev = gy.device
    if dev.type != "cuda":
        raise ValueError(f"b_frame: CUDA tensors expected, got {dev}")
    a = frame_args(bd, maps, planes, cpads, coords, avail, mv_me, mv_parts,
                   colzero, colmixed, gy, gu, gv, qp, cqp, lam4, lam24,
                   lam_me, blk_order, rules, out, partitions, allow_parts,
                   waves)
    launches["KB"] += 1
    _build.launch_frame("tpu264_b_frame", a, gy)

"""Kernel KP: the P wave body, the Intra4x4 search included, as one CUDA
launch a P picture (`csrc/p_wave.cu`).

`p_frame` is what `coding.inter_frame.frame_body` runs for CUDA tensors;
the plain version is `coding.inter_frame.p_frame_plain` (same inputs), a
loop of `wave_body_plain` over the waves.  One cooperative launch runs
the waves [w0, w1) of a picture's wave table (the per-wave arrays
[n_waves, bmax, ...] that the encoder builds) in order, with a grid-wide
barrier between waves: the lanes read their neighbour context from the
border buffers and their neighbour vectors from the maps, write each
wave's results into its row of `out` (`alloc_outputs`), the finished
macroblocks' borders back into the buffers and their vectors into the
maps, in place.  With the reference's default P tools (`Tools`) it also
weighs the 16x8, 8x16 and P_8x8 candidates from the partitions' own
vectors and picks the transform of a 16x16 inter macroblock, and it
weighs every luma prediction by the frame's explicit weight and offset
(weighted prediction; (64, 0) leaves it as it is).  Its tables (K2's for
the Intra4x4 search, the two quantiser sets of K3's wave form, the inter
rounding, the lambdas, the quarter-pel table, the tools, the 8x8
transform's tables, the weights) go in by value, packed here from the
Python tables the plain version uses (`pack_params`,
`i4x4_wave.pack_params`); the tensors are checked, the pointer table
built and the tables packed once a call, which is once a picture.  There
is no fallback to the plain version: a kernel that does not build, or a
cooperative launch that the card refuses, raises.

`launches["KP"]` counts kernel launches.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import torch

from . import _build
from . import i16_chroma_wave as k3w
from . import i4x4_wave as k2w
from . import transform8 as kt8
from .interp import QPEL_TABLE

I32 = torch.int32
_PARAMS: dict = {}

launches = {"KP": 0}


class Tools(NamedTuple):
    """The reference's optional P tools (`make_inter_encoder`'s flags)."""
    partitions: bool = False      # P_L0_16x8 / P_L0_8x16
    p8x8: bool = False            # P_8x8, sub_mb_type P_L0_8x8 (needs
    #                               partitions)
    t8: bool = False              # the 8x8 transform of 16x16 inter MBs


NO_TOOLS = Tools()

# the partitions' own vectors, mv_parts [B, 8, 2] (quarter-pel (y, x)):
# the halves of the 16x8 and 8x16 candidates, then the four quadrants
PARTS = ("top", "bot", "left", "right", "q0", "q1", "q2", "q3")

# the P wave body's results: name -> (shape after the lane axis, type)
OUTPUTS = {"is_inter": ((), torch.bool), "mv": ((2,), I32),
           "mv_pred": ((2,), I32), "mv_skip": ((2,), I32),
           **k3w.OUTPUTS}
# and those of the tools, each present when its tool is on
TOOL_OUTPUTS = {"ptype": ((), I32), "mv2": ((2,), I32),
                "mvq": ((4, 2), I32), "t8": ((), torch.bool)}


def outputs(tools: Tools = NO_TOOLS) -> dict:
    """The results of a P wave with `tools`, in the reference's keys:
    "ptype" and "mv2" with partitions, "mvq" with P_8x8, "t8" with the
    8x8 transform."""
    on = {"ptype": tools.partitions, "mv2": tools.partitions,
          "mvq": tools.p8x8, "t8": tools.t8}
    return {**OUTPUTS, **{k: v for k, v in TOOL_OUTPUTS.items() if on[k]}}


def alloc_outputs(lead: tuple, device, tools: Tools = NO_TOOLS) -> dict:
    """Uninitialised result arrays of shape lead + the per-lane shape:
    lead = (B,) for one wave, (n_waves, max_wave) for a frame."""
    return {k: torch.empty(tuple(lead) + shape, dtype=dtype, device=device)
            for k, (shape, dtype) in outputs(tools).items()}


def _f32_bits(x: float) -> int:
    return struct.unpack("<i", struct.pack("<f", x))[0]


def pack_params(qp: int, cqp: int, lam4: int, lam24: int, lam_me: int,
                blk_order: tuple, tools: Tools = NO_TOOLS, wy: int = 64,
                oy: int = 0):
    """The kernel's by-value tables as a host int32 array (layout: see
    `tpu264_p_frame` in the CUDA source), cached by all of its inputs, the
    luma weight and offset included."""
    key = (qp, cqp, lam4, lam24, lam_me, blk_order, tools, wy, oy)
    if key not in _PARAMS:
        qbits8 = 16 + qp // 6
        vals = (list(k3w.pack_params(qp, cqp, blk_order))
                + [(1 << (15 + qp // 6)) // 6, (1 << (15 + cqp // 6)) // 6,
                   lam4, lam24, lam_me]
                + QPEL_TABLE.reshape(-1).tolist()
                + [int(tools.partitions) | int(tools.p8x8) << 1
                   | int(tools.t8) << 2]
                + kt8.MF8_TABLE[qp % 6].reshape(-1).tolist()
                + kt8.V8_TABLE[qp % 6].reshape(-1).tolist()
                + kt8.ZIGZAG_8x8.tolist()
                + [(1 << qbits8) // 6, qbits8, qp // 6,
                   _f32_bits(float(kt8.LAM_SSD[qp])), wy, oy])
        assert len(vals) == PARAMS_LEN
        _PARAMS[key] = _build.host_i32(vals)
    return _PARAMS[key]


# K3's two quantiser sets and scans, the inter rounding, the lambdas, the
# quarter-pel table, the tools, the 8x8 tables, the luma weight and offset
PARAMS_LEN = 2 * 55 + 32 + 5 + 16 * 7 + 1 + 3 * 64 + 4 + 2


def frame_args(bd: dict, mv_map, ref_map, planes, cu_pad, cv_pad, coords,
               avail, mv_me, gy, gu, gv, qp: int, cqp: int, lam4: int,
               lam24: int, lam_me: int, blk_order: tuple, rules: tuple,
               out: dict, mv_parts=None, tools: Tools = NO_TOOLS,
               wy: int = 64, oy: int = 0, waves=None) -> _build.FrameArgs:
    """Check a P picture's inputs (on whatever device they lie) and lay
    them out for `tpu264_p_frame` (see `p_frame`)."""
    who = "p_frame"
    dev = gy.device
    n, bmax, wm, hm, w0, w1 = k3w.check_frame_inputs(who, bd, coords, avail,
                                                     dev, waves)
    hp, wp = planes.shape[1:]
    hc, wc = cu_pad.shape
    lead = (n, bmax)
    for name, t, shape in (
            ("mv_map", mv_map, (3, hm + 2, wm + 2, 2)),
            ("ref_map", ref_map, (3, hm + 2, wm + 2)),
            ("planes", planes, (4, hp, wp)), ("cu_pad", cu_pad, (hc, wc)),
            ("cv_pad", cv_pad, (hc, wc)), ("mv_me", mv_me, lead + (2,)),
            ("gy", gy, lead + (16, 16)), ("gu", gu, lead + (8, 8)),
            ("gv", gv, lead + (8, 8))):
        _build.check_tensor(who, name, t, shape, I32, dev)
    if gy.data_ptr() % 16:
        raise ValueError(f"{who}: gy must be 16-byte aligned")
    if tools.p8x8 and not tools.partitions:
        raise ValueError(f"{who}: P_8x8 needs the partitions")
    if tools.partitions:
        _build.check_tensor(who, "mv_parts", mv_parts, lead + (8, 2), I32,
                            dev)
    else:
        mv_parts = mv_me            # not read
    if hp < 16 or wp < 16 or hc < 9 or wc < 9:
        raise ValueError(f"{who}: reference planes {tuple(planes.shape)}, "
                         f"{(hc, wc)} are smaller than a block")
    want = outputs(tools)
    for k, (shape, dtype) in want.items():
        _build.check_tensor(who, f"out[{k!r}]", out[k], lead + shape, dtype,
                            dev)
    # a tool's outputs that are off: no pointer (the kernel writes none)
    tensors = ([bd[k] for k in k3w.BORDERS]
               + [mv_map, ref_map, planes, cu_pad, cv_pad, coords, avail,
                  mv_me, mv_parts, gy, gu, gv]
               + [out[k] if k in want else None for k in TOOL_OUTPUTS]
               + [out[k] for k in OUTPUTS])
    return _build.FrameArgs(
        tensors,
        pack_params(int(qp), int(cqp), int(lam4), int(lam24), int(lam_me),
                    blk_order, tools, int(wy), int(oy)),
        k2w.pack_params(int(qp), int(lam4), int(lam24), rules),
        [wm, hm, hp, wp, hc, wc], bmax, (w0, w1))


def p_frame(bd: dict, mv_map, ref_map, planes, cu_pad, cv_pad, coords,
            avail, mv_me, gy, gu, gv, qp: int, cqp: int, lam4: int,
            lam24: int, lam_me: int, blk_order: tuple, rules: tuple,
            out: dict, mv_parts=None, tools: Tools = NO_TOOLS, wy: int = 64,
            oy: int = 0, waves=None) -> None:
    """The P wave body of waves [w0, w1) of a picture (`waves`; None: all)
    on the card, one cooperative launch: the wave table coords
    [n_waves, bmax, 2] (int32 (r, c); padding lanes at (hm, 0)) with avail
    [n_waves, bmax, 4] (bool); the lanes' context from the border buffers
    `bd` and their neighbour vectors from mv_map [3,hm+2,wm+2,2] / ref_map
    [3,hm+2,wm+2]; the half-pel planes [4,Hp,Wp] and the padded chroma
    planes of the reference; the lanes' full-search vectors mv_me
    [n_waves, bmax, 2] and source tiles gy [n_waves, bmax, 16, 16], gu, gv
    [.., 8, 8]; with `tools.partitions` (and `p8x8`) the partitions'
    vectors mv_parts [n_waves, bmax, 8, 2] (`PARTS`); the luma weight and
    offset (wy, oy), which every luma prediction takes after
    interpolation; `blk_order` the 4x4 blocks' (by, bx) in coding order,
    `rules` their availability rules (`i4x4_wave.rule_codes`).  Writes
    every result of `outputs(tools)` into the waves' rows of `out`
    ([n_waves, bmax, ...]), the lanes' last rows and columns into `bd`
    and their vectors into the maps."""
    dev = gy.device
    if dev.type != "cuda":
        raise ValueError(f"p_frame: CUDA tensors expected, got {dev}")
    a = frame_args(bd, mv_map, ref_map, planes, cu_pad, cv_pad, coords,
                   avail, mv_me, gy, gu, gv, qp, cqp, lam4, lam24, lam_me,
                   blk_order, rules, out, mv_parts, tools, wy, oy, waves)
    launches["KP"] += 1
    _build.launch_frame("tpu264_p_frame", a, gy)

"""Kernel K3 in its wave form: the Intra16x16 and chroma part of the intra
wave body, the merge with the Intra4x4 result and the border scatter, as
one CUDA launch a wave (`csrc/i16_chroma_wave.cu`).

`i16_chroma_wave` is what `coding.intra_frame.wave_body` runs for CUDA
tensors, after the I4x4 wave kernel (`i4x4_wave.i4x4_wave_bd`) on the same
stream; the plain version is `coding.intra_frame.i16_chroma_wave_plain`
(same inputs), part of `wave_body_plain`.  The
kernel reads its neighbour context from the border buffers at the wave's
coordinates, writes the wave's results into `out` (rows of the frame's
output arrays, see `alloc_outputs`) and the finished macroblocks' borders
back into the buffers, in place.  The quantiser tables of luma and chroma
go in by value, packed here from the Python tables the plain version uses
(`pack_params`).  There is no fallback to the plain version: a kernel that
does not build or launch raises.

`launches["K3"]` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import transform as kt

I32 = torch.int32
_PARAMS: dict = {}

launches = {"K3": 0}

# the wave body's results: name -> (shape after the lane axis, type)
OUTPUTS = {
    "sel16": ((), torch.bool), "i16mode": ((), I32), "modes": ((16,), I32),
    "cmode": ((), I32), "luma_ac": ((16, 16), I32), "luma_dc": ((16,), I32),
    "chroma_dc": ((2, 4), I32), "chroma_ac": ((2, 4, 16), I32),
    "recon_mb": ((16, 16), I32), "rec_u": ((8, 8), I32),
    "rec_v": ((8, 8), I32)}
# the border buffers (`coding.intra_frame.init_border_buffers`):
# name -> (rows beyond hm, a, b) for a row length of a * wm + b
BORDERS = {
    "row_y": (2, 16, 9), "col_y": (1, 0, 16), "row_u": (2, 8, 9),
    "col_u": (1, 0, 8), "row_v": (2, 8, 9), "col_v": (1, 0, 8),
    "modes_row": (2, 4, 5), "modes_col": (1, 0, 4)}


def alloc_outputs(lead: tuple, device) -> dict:
    """Uninitialised result arrays of shape lead + the per-lane shape:
    lead = (B,) for one wave, (n_waves, max_wave) for a frame."""
    return {k: torch.empty(tuple(lead) + shape, dtype=dtype, device=device)
            for k, (shape, dtype) in OUTPUTS.items()}


def _quant_set(qp: int, lim_dc: int) -> list:
    qbits = 15 + qp // 6
    return (kt.MF_TABLE[qp % 6].reshape(16).tolist()
            + kt.LIMIT_AC[qp].reshape(16).tolist()
            + kt.V_TABLE[qp % 6].reshape(16).tolist()
            + [(1 << qbits) // 3, qbits, qp // 6, kt.MF00[qp % 6],
               kt.V00[qp % 6], lim_dc, qp])


def pack_params(qp: int, cqp: int, blk_order: tuple):
    """The kernel's by-value tables for one luma and chroma QP as a host
    int32 array (layout: see `tpu264_i16_chroma_wave` in the CUDA source),
    cached; `blk_order` is the (by, bx) of the 4x4 luma blocks in coding
    order."""
    key = (qp, cqp, blk_order)
    if key not in _PARAMS:
        vals = (_quant_set(qp, kt.LIMIT_DC[qp])
                + _quant_set(cqp, kt.LIMIT_CDC[cqp])
                + kt.ZIGZAG_4x4.tolist()
                + [by * 4 + bx for by, bx in blk_order])
        assert len(vals) == 2 * (16 * 3 + 7) + 16 + 16
        _PARAMS[key] = _build.host_i32(vals)
    return _PARAMS[key]


def check_borders(who: str, bd: dict, dev) -> tuple:
    """Check the border buffers -> (wm, hm)."""
    hm = bd["col_y"].shape[0] - 1
    wm = (bd["modes_row"].shape[1] - 5) // 4
    for name, (extra, a, b_) in BORDERS.items():
        _build.check_tensor(who, name, bd[name], (hm + extra, a * wm + b_),
                            I32, dev)
    return wm, hm


def check_wave_inputs(who: str, bd: dict, coords, avail, dev) -> tuple:
    """Check the border buffers and the wave's coords [B,2] int32 and avail
    [B,4] bool -> (B, wm, hm)."""
    if dev.type != "cuda":
        raise ValueError(f"{who}: CUDA tensors expected, got {dev}")
    b = coords.shape[0]
    _build.check_tensor(who, "coords", coords, (b, 2), I32, dev)
    _build.check_tensor(who, "avail", avail, (b, 4), torch.bool, dev)
    return (b, *check_borders(who, bd, dev))


def check_frame_inputs(who: str, bd: dict, coords, avail, dev,
                       waves=None) -> tuple:
    """Check the border buffers, a picture's wave table coords
    [n_waves, bmax, 2] int32 and avail [n_waves, bmax, 4] bool, and the
    wave range `waves` = (w0, w1) (None: every wave) -> (n_waves, bmax, wm,
    hm, w0, w1).  Any device: the frame wrappers check theirs first."""
    if coords.dim() != 3:
        raise ValueError(f"{who}: coords must be [n_waves, bmax, 2], got "
                         f"{tuple(coords.shape)}")
    n, bmax = coords.shape[:2]
    _build.check_tensor(who, "coords", coords, (n, bmax, 2), I32, dev)
    _build.check_tensor(who, "avail", avail, (n, bmax, 4), torch.bool, dev)
    w0, w1 = (0, n) if waves is None else (int(waves[0]), int(waves[1]))
    if not 0 <= w0 <= w1 <= n:
        raise ValueError(f"{who}: waves {(w0, w1)} outside [0, {n}]")
    return (n, bmax, *check_borders(who, bd, dev), w0, w1)


def i16_chroma_wave(bd: dict, coords, avail, gy, gu, gv, mb4, modebuf,
                    coeffs4, j4, qp: int, cqp: int, blk_order: tuple,
                    out: dict) -> None:
    """The wave body after the I4x4 search, for B lanes on the card, one
    launch: reads the lanes' context from the border buffers `bd` at
    coords [B,2] (int32 (r, c)) with avail [B,4] (bool), the source tiles
    gy [B,16,16], gu, gv [B,8,8] and the I4x4 results (recon, mode grid,
    scanned levels, cost); writes every result but "modes" into `out` and
    the lanes' last rows and columns into `bd`."""
    who = "i16_chroma_wave"
    dev = gy.device
    b, wm, _ = check_wave_inputs(who, bd, coords, avail, dev)
    for name, t, shape in (("gy", gy, (b, 16, 16)), ("gu", gu, (b, 8, 8)),
                           ("gv", gv, (b, 8, 8)), ("mb4", mb4, (b, 16, 16)),
                           ("modebuf", modebuf, (b, 4, 4)),
                           ("coeffs4", coeffs4, (b, 16, 16)),
                           ("j4", j4, (b,))):
        _build.check_tensor(who, name, t, shape, I32, dev)
    outs = [k for k in OUTPUTS if k != "modes"]
    for k in outs:
        shape, dtype = OUTPUTS[k]
        _build.check_tensor(who, f"out[{k!r}]", out[k], (b,) + shape, dtype,
                            dev)
    tensors = ([bd[k] for k in BORDERS]
               + [coords, avail, gy, gu, gv, mb4, modebuf, coeffs4, j4]
               + [out[k] for k in outs])
    ptrs = (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))
    launches["K3"] += 1
    err = _build.lib().tpu264_i16_chroma_wave(
        ptrs, pack_params(int(qp), int(cqp), blk_order), b, wm,
        _build.stream_of(gy))
    _build.check(err, "tpu264_i16_chroma_wave")

"""Kernel K2 in its wave form: the Intra4x4 body of a macroblock wave as
one CUDA launch (`csrc/i4x4_wave.cu`).

`i4x4_wave` is what `coding.intra_frame.eval_i4x4` runs for CUDA tensors;
the plain version is `coding.intra_frame.eval_i4x4_plain`.  The wave loop
calls the same kernel through `i4x4_wave_bd`, which reads the lanes'
neighbour context straight from the loop's border buffers instead of
gathered per-lane arrays.  The kernel
takes its constant tables (quantiser rows for the QP, the zig-zag scan,
the three-tap form of the eight directional predictors, the modes'
neighbour needs) by value, packed here from the same Python tables the
plain version uses; the per-block availability rules come from the caller
(`rule_codes`).  There is no fallback to the plain version: a kernel that
does not build or launch raises.

`launches["K2"]` counts kernel launches (of either entry).
"""

from __future__ import annotations

import torch

from . import _build
from . import intra as ki
from . import transform as kt
from .i16_chroma_wave import check_wave_inputs

I32 = torch.int32
_RULE_CODE = {False: 0, True: 1, "mb_top": 2, "mb_left": 3, "mb_tl": 4,
              "mb_tr": 5}
_PARAMS: dict = {}
_NO_STEPS = _build.host_i64([0] * 10)       # one picture: no frame strides

launches = {"K2": 0}


def rule_codes(blk_rules) -> tuple:
    """The 16 per-block availability rules (`block_availability` of each
    block in coding order) as the kernel's rules[16][6]: by, bx, and a
    code each for top, left, top-left and top-right."""
    codes = []
    for r in blk_rules:
        codes += [r["by"], r["bx"]] + [_RULE_CODE[r[k]] for k in
                                       ("top", "left", "tl", "tr")]
    return tuple(codes)


def pack_params(qp: int, lam4: int, lam24: int, rules: tuple):
    """The kernel's by-value tables for one QP as a host int32 array
    (layout: see `tpu264_i4x4_wave` in the CUDA source), cached."""
    key = (qp, lam4, lam24, rules)
    if key not in _PARAMS:
        qbits = 15 + qp // 6
        needs = [int(t) | int(l) << 1 | int(tl) << 2
                 for t, l, tl in ki.NEEDS4.tolist()]
        vals = (kt.MF_TABLE[qp % 6].reshape(16).tolist()
                + kt.LIMIT_AC[qp].reshape(16).tolist()
                + kt.V_TABLE[qp % 6].reshape(16).tolist()
                + [(1 << qbits) // 3, qbits, qp // 6, lam4, lam24]
                + kt.ZIGZAG_4x4.tolist() + ki.TAP_IDX.reshape(-1).tolist()
                + ki.TAP_W.reshape(-1).tolist() + list(rules) + needs)
        assert len(vals) == 16 * 3 + 5 + 16 + 384 * 2 + 96 + 9
        _PARAMS[key] = _build.host_i32(vals)
    return _PARAMS[key]


def _check(name: str, t: torch.Tensor, shape, dtype, dev) -> None:
    if t.dtype != dtype:
        raise TypeError(f"i4x4_wave: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"i4x4_wave: {name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.device != dev:
        raise ValueError(f"i4x4_wave: {name} is on {t.device}, not {dev}")


def i4x4_wave(orig, ltop, lleft, modes_top, modes_left, at, al, atl, atr,
              qp: int, lam4: int, lam24: int, rules: tuple):
    """`eval_i4x4` of a wave of B macroblocks on the card, one launch;
    `rules` is `rule_codes` of the blocks' availability rules.

    Returns (recon [B,16,16], mode grid [B,4,4], modes in zig-zag order
    [B,16], scanned levels [B,16,16], cost [B]), all int32."""
    dev = orig.device
    if dev.type != "cuda":
        raise ValueError(f"i4x4_wave: CUDA tensors expected, got {dev}")
    b = orig.shape[0]
    for name, t, shape in (("orig", orig, (b, 16, 16)),
                           ("ltop", ltop, (b, 25)),
                           ("lleft", lleft, (b, 16)),
                           ("modes_top", modes_top, (b, 4)),
                           ("modes_left", modes_left, (b, 4))):
        _check(name, t, shape, I32, dev)
        if not t.is_contiguous():
            raise ValueError(f"i4x4_wave: {name} must be contiguous")
    if orig.data_ptr() % 16:
        raise ValueError("i4x4_wave: orig must be 16-byte aligned")
    flags = []
    for name, t in (("at", at), ("al", al), ("atl", atl), ("atr", atr)):
        _check(name, t, (b,), torch.bool, dev)     # any stride: passed on
        flags += [_build.ptr(t), t.stride(0)]
    recon = torch.empty((b, 16, 16), dtype=I32, device=dev)
    mode_grid = torch.empty((b, 4, 4), dtype=I32, device=dev)
    modes_zz = torch.empty((b, 16), dtype=I32, device=dev)
    coeffs = torch.empty((b, 16, 16), dtype=I32, device=dev)
    cost = torch.empty((b,), dtype=I32, device=dev)
    launches["K2"] += 1
    err = _build.launch(
        "tpu264_i4x4_wave", orig, _build.ptr(orig), _build.ptr(ltop),
        _build.ptr(lleft), _build.ptr(modes_top), _build.ptr(modes_left),
        *flags, pack_params(int(qp), int(lam4), int(lam24), rules),
        _build.ptr(recon), _build.ptr(mode_grid), _build.ptr(modes_zz),
        _build.ptr(coeffs), _build.ptr(cost), b)
    _build.check(err, "tpu264_i4x4_wave")
    return recon, mode_grid, modes_zz, coeffs, cost


def i4x4_wave_bd(orig, bd: dict, coords, avail, qp: int, lam4: int,
                 lam24: int, rules: tuple, modes_zz=None):
    """`i4x4_wave` for one wave of the wave loop: the lanes' context is read
    from the border buffers `bd` (`init_border_buffers`) at coords [B,2]
    (int32 (r, c)), as `gather_border_ctx` would gather it, and the four
    availability flags are the columns of avail [B,4] (bool).  `modes_zz`
    [B,16], when given, takes the modes in zig-zag order.  Same returns.

    A chunk of F pictures of the batched entry goes in the same launch:
    orig [F,B,16,16] (each picture's part contiguous, the pictures any
    fixed stride apart), border buffers [F, ...], `modes_zz` [F,B,16], and
    every return with the leading F; coords and avail are the pictures'
    shared schedule."""
    who = "i4x4_wave_bd"
    dev = orig.device
    nf = orig.shape[0] if orig.dim() == 4 else None
    b, wm, _, steps = check_wave_inputs(who, bd, coords, avail, dev, nf)
    lead = (b,) if nf is None else (nf, b)
    o_step = _build.check_frames(who, "orig", orig, nf, (b, 16, 16), I32,
                                 dev)
    if orig.data_ptr() % 16 or o_step % 4:
        raise ValueError("i4x4_wave_bd: orig must be 16-byte aligned")
    if modes_zz is None:
        modes_zz = torch.empty(lead + (16,), dtype=I32, device=dev)
    z_step = _build.check_frames(who, "modes_zz", modes_zz, nf, (b, 16), I32,
                                 dev)
    recon = torch.empty(lead + (16, 16), dtype=I32, device=dev)
    mode_grid = torch.empty(lead + (4, 4), dtype=I32, device=dev)
    coeffs = torch.empty(lead + (16, 16), dtype=I32, device=dev)
    cost = torch.empty(lead, dtype=I32, device=dev)
    if nf is None:
        fstride = _NO_STEPS
    else:
        row_y, col_y, _, _, _, _, modes_row, modes_col = steps
        fstride = _build.host_i64(
            [o_step, row_y, col_y, modes_row, modes_col, recon.stride(0),
             mode_grid.stride(0), z_step, coeffs.stride(0), cost.stride(0)])
    launches["K2"] += 1
    err = _build.launch(
        "tpu264_i4x4_wave_bd", orig,
        _build.ptr(orig), _build.ptr(bd["row_y"]), _build.ptr(bd["col_y"]),
        _build.ptr(bd["modes_row"]), _build.ptr(bd["modes_col"]),
        _build.ptr(coords), _build.ptr(avail), wm,
        pack_params(int(qp), int(lam4), int(lam24), rules),
        _build.ptr(recon), _build.ptr(mode_grid), _build.ptr(modes_zz),
        _build.ptr(coeffs), _build.ptr(cost), b, 1 if nf is None else nf,
        fstride)
    _build.check(err, "tpu264_i4x4_wave_bd")
    return recon, mode_grid, modes_zz, coeffs, cost

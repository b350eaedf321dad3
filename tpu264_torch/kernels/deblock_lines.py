"""Kernel K4: the spec 8.7.2 luma deblocking filter over 8-sample lines.

Counterpart of `tpu264.kernels.pallas_kernels.filter_luma_lines`.  For
CUDA tensors it runs the kernel in `csrc/deblock_luma.cu`; for CPU
tensors the plain torch version `filter_luma_lines_plain` (the torch
translation of `tpu264.kernels.deblock.filter_luma_lines`).  There is no
fallback from the card to the plain version.

This is the entry on slabs of lines, for callers that hold per-line bS.
The all-intra deblocker runs K4 in its wave form (`deblock_wave.py`: a
whole MB wave, luma and chroma, in one launch), whose plain version uses
`filter_luma_lines_plain`.

`launches["K4_lines"]` counts kernel launches; the wave kernel keeps its
own count, `deblock_wave.launches["K4"]`.
"""

from __future__ import annotations

import torch

from . import _build

launches = {"K4_lines": 0}


def _clip3(lo, hi, x):
    return torch.minimum(torch.maximum(x, lo), hi)


def tc0_lines(tc0_row, bs):
    """TC0_TABLE[indexA][bS - 1] of each line: `tc0_row` is one row of
    three for every line, or a row per line [..., 3] (bS's shape)."""
    k = torch.clamp(bs, 1, 3).long() - 1
    t = torch.as_tensor(tc0_row, dtype=torch.int32, device=bs.device)
    if t.dim() == 1:
        return t[k]
    return torch.gather(t.expand(*k.shape, 3), -1, k[..., None])[..., 0]


def filter_luma_lines_plain(win, bs, alpha, beta, tc0_row):
    """win [..., 8] = p3..q3 per line; bs broadcastable to win[..., 0];
    alpha, beta ints or int32 tensors broadcastable to it, tc0_row as
    `tc0_lines` takes it."""
    p3, p2, p1, p0 = win[..., 0], win[..., 1], win[..., 2], win[..., 3]
    q0, q1, q2, q3 = win[..., 4], win[..., 5], win[..., 6], win[..., 7]
    fflag = (((p0 - q0).abs() < alpha) & ((p1 - p0).abs() < beta)
             & ((q1 - q0).abs() < beta) & (bs > 0))
    ap = (p2 - p0).abs() < beta
    aq = (q2 - q0).abs() < beta

    tc0 = tc0_lines(tc0_row, bs)
    tc = tc0 + ap.to(torch.int32) + aq.to(torch.int32)
    delta = _clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3)
    np0 = torch.clamp(p0 + delta, 0, 255)
    nq0 = torch.clamp(q0 - delta, 0, 255)
    np1 = p1 + _clip3(-tc0, tc0, (p2 + ((p0 + q0 + 1) >> 1) - 2 * p1) >> 1)
    nq1 = q1 + _clip3(-tc0, tc0, (q2 + ((p0 + q0 + 1) >> 1) - 2 * q1) >> 1)
    use_n = fflag & (bs < 4)

    strong = (p0 - q0).abs() < ((alpha >> 2) + 2)
    sp = fflag & (bs == 4) & strong & ap
    sq = fflag & (bs == 4) & strong & aq
    weak4 = fflag & (bs == 4)
    w = torch.where
    o_p0 = w(use_n, np0,
             w(sp, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
               w(weak4, (2 * p1 + p0 + q1 + 2) >> 2, p0)))
    o_p1 = w(use_n & ap, np1, w(sp, (p2 + p1 + p0 + q0 + 2) >> 2, p1))
    o_p2 = w(sp, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    o_q0 = w(use_n, nq0,
             w(sq, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
               w(weak4, (2 * q1 + q0 + p1 + 2) >> 2, q0)))
    o_q1 = w(use_n & aq, nq1, w(sq, (q2 + q1 + q0 + p0 + 2) >> 2, q1))
    o_q2 = w(sq, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)
    return torch.stack([p3, o_p2, o_p1, o_p0, o_q0, o_q1, o_q2, q3], dim=-1)


def filter_luma_lines(win, bs, alpha: int, beta: int, tc0_row):
    """Filter every line of win [..., 8] int32 (contiguous) with bS `bs`
    (int32, broadcastable to win[..., 0]); tc0_row = TC0_TABLE[indexA],
    best given as host ints (a device tensor costs a sync per call)."""
    if win.dtype != torch.int32 or bs.dtype != torch.int32:
        raise TypeError("filter_luma_lines: int32 win and bs expected")
    if win.dim() < 1 or win.shape[-1] != 8:
        raise ValueError(f"filter_luma_lines: [..., 8] expected, got "
                         f"{tuple(win.shape)}")
    if not win.is_contiguous():
        raise ValueError("filter_luma_lines: win must be contiguous")
    if bs.device != win.device:
        raise ValueError("filter_luma_lines: win and bs on different devices")
    if win.device.type == "cpu":
        return filter_luma_lines_plain(win, bs, alpha, beta, tc0_row)
    if win.device.type != "cuda":
        raise ValueError(f"filter_luma_lines: unsupported device {win.device}")
    if win.data_ptr() % 16:
        raise ValueError("filter_luma_lines: win must be 16-byte aligned")
    bs_lines = torch.broadcast_to(bs, win.shape[:-1]).contiguous()
    out = torch.empty_like(win)
    tc0 = [int(v) for v in tc0_row]
    launches["K4_lines"] += 1
    err = _build.lib().tpu264_deblock_luma(
        _build.ptr(win), _build.ptr(bs_lines), _build.ptr(out),
        win.numel() // 8, int(alpha), int(beta), _build.host_i32(tc0),
        _build.stream_of(win))
    _build.check(err, "tpu264_deblock_luma")
    return out

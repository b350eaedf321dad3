"""Smoke run of the PyTorch/CUDA port (`tpu264_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, before the result line):
 1. print the card (`nvidia-smi` name, power limit) and the torch / CUDA
    versions; refuse to run without CUDA;
 2. build the CUDA kernel library from `tpu264_torch/csrc` (timed);
 3. hold each kernel (K1 CABAC engine, K2 I4x4 wave body, K3 I16x16 +
    chroma wave body, K4 deblock wave, and the entries on slabs: DCT +
    quant, DCT, luma deblock lines) to its plain torch version on the
    card, at the shapes of the 720p main path and on seeded corner cases,
    with exact equality, and time both;
 4. config 3: encode two 1280x720 frames (all-intra, CABAC, deblock, QP
    28) through `Encoder(cfg).encode_sequence` (the default device is the
    card), check that every kernel of the path was launched (K2 once a
    wave, K3 and K4 at most once a wave, the slab entries never), and
    hold the stream's SHA-256 to `tests/data/torch_golden.json` (made by
    the JAX reference encoder);
 5. config 1: five QCIF frames, all-intra CAVLC, through the batched
    entry; the SHA-256 equals the per-frame path's on the card and the
    golden;
 6. config 2: CIF IPPP CAVLC (1 IDR + 2 P, deblock, full-search and
    quarter-pel ME, no partitions) against its golden;
 7. IPPP at 720p: the same at 1280x720 against its golden, with the
    launches of every frame asserted: a P frame runs K2 once a wave, the
    slab entries `K2_blocks` once and `K3_blocks` five times a wave (the
    inter residual; I16x16, intra U and V, inter U and V), K4 at most
    once a wave, and K1 and K3's wave form never;
 8. one CIF P frame's `make_inter_encoder` output on the card against
    the same call on the CPU, every key, tolerance 0: this holds the slab
    entries in their callers to the plain versions.

The line before the last is a JSON object with one entry per kernel
(`launches`: the sum over the two 720p paths, phases 4 and 7, each driven
with the counts set to 0 just before and read just after;
`launches_by_path` splits it); the last line is
{"ok": true, "device": {...}}.

`bound_ms` of a kernel is the larger of its bytes (each input read once,
each output written once) over 3.35 TB/s and its integer operations over
the card's int32 issue rate (132 SMs x 64 int32 lanes x 1.98 GHz, about
16.7 TOP/s; the data sheet's 67 TFLOP/s counts a float32 multiply-add
on 128 lanes as two), both counted from this run's inputs.  K1 to K4
are bound by neither but by a chain of dependent steps, which `PERF.md`
models; K1's row also carries `bins`, counted from this run's records.
`library_ms` is null throughout: no single PyTorch call computes a CABAC
coder, an H.264 intra search, the H.264 integer transform with its
quantiser, or the deblocking filter.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
W, H, QP = 1280, 720, 28

# count key -> (name, source, TPU kernel it replaces, on the all-intra
# CABAC path (config 3); the IPPP path's launches are asserted frame by
# frame in `phase_ippp_720p`)
KERNELS = {
    "K1": ("cabac_engine", "tpu264_torch/csrc/cabac_engine.cu",
           "tpu264/entropy/cabac_pallas.py:44", True),
    "K2": ("i4x4_wave", "tpu264_torch/csrc/i4x4_wave.cu",
           "tpu264/kernels/pallas_kernels.py:55", True),
    "K2_blocks": ("dct_quant", "tpu264_torch/csrc/dct_quant.cu",
                  "tpu264/kernels/pallas_kernels.py:55", False),
    "K3": ("i16_chroma_wave", "tpu264_torch/csrc/i16_chroma_wave.cu",
           "tpu264/kernels/pallas_kernels.py:66", True),
    "K3_blocks": ("dct", "tpu264_torch/csrc/dct_quant.cu",
                  "tpu264/kernels/pallas_kernels.py:66", False),
    "K4": ("deblock_wave", "tpu264_torch/csrc/deblock_wave.cu",
           "tpu264/kernels/pallas_kernels.py:142", True),
    "K4_lines": ("deblock_luma_lines", "tpu264_torch/csrc/deblock_luma.cu",
                 "tpu264/kernels/pallas_kernels.py:142", False),
}
# `K3_blocks` launches of one P wave: I16x16, intra U, intra V, inter U,
# inter V (`eval_i16`, `eval_chroma`, two `chroma_residual_recon`)
K3_BLOCKS_PER_P_WAVE = 5
IPPP = dict(symbol_mode="CAVLC", intra_period=0, deblock=True,
            inter_partitions=False, transform_8x8=False)
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
INT_OPS_PER_S = 132 * 64 * 1.98e9   # SMs x int32 lanes x boost clock


def bound(n_bytes: float, n_ops: float) -> dict:
    """Least time for the work: bytes over the memory rate or operations
    over the peak rate, whichever is larger."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / INT_OPS_PER_S
    return {"bound_ms": 1e3 * max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations"}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` runs (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA card (there is no CPU fallback)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    return torch.cuda.get_device_name(0)


def phase_build() -> None:
    from tpu264_torch.kernels import _build
    t0 = time.monotonic()
    _build.lib()
    print(f"build: {time.monotonic() - t0:.2f} s wall "
          f"(nvcc {_build.build_seconds} s) -> {_build.library_path().name}")


def check_dct(dev, rng) -> dict:
    from tpu264_torch.kernels import dct_quant as dq
    err = {"K2_blocks": 0, "K3_blocks": 0}
    times = {}
    # slabs of a 720p P wave (40 lanes): 640 luma blocks (the inter and
    # the I16x16 residual), 160 blocks of one chroma plane; and a frame
    for n in (160, 640, 57600):
        x = torch.as_tensor(rng.integers(-255, 256, size=(n, 4, 4)),
                            dtype=torch.int32, device=dev)
        got = dq.fdct4x4(x)
        want = dq.fdct4x4_plain(x)
        err["K3_blocks"] = max(err["K3_blocks"], max_abs_err(got, want))
        times[("K3_blocks", n)] = (time_ms(lambda: dq.fdct4x4(x), 200),
                            time_ms(lambda: dq.fdct4x4_plain(x), 200))
        for qp in (0, 28, 51):
            for intra in (True, False):
                got = dq.fdct_quant4x4(x, qp, intra)
                want = dq.fdct_quant4x4_plain(x, qp, intra)
                err["K2_blocks"] = max(err["K2_blocks"],
                                       max_abs_err(got, want))
        times[("K2_blocks", n)] = (
            time_ms(lambda: dq.fdct_quant4x4(x, QP, False), 200),
            time_ms(lambda: dq.fdct_quant4x4_plain(x, QP, False), 200))
    for (k, n), (ms, pms) in sorted(times.items()):
        print(f"{k} {n:6d} blocks: kernel {ms:.4f} ms, plain {pms:.4f} ms")
    # a block: 64 B in, 64 B out; 64 adds/shifts for the two butterfly
    # passes, and 5 operations a coefficient for the quantiser
    return {"K2_blocks": dict(err=err["K2_blocks"],
                              ms=times[("K2_blocks", 640)][0],
                              plain_ms=times[("K2_blocks", 640)][1],
                              **bound(640 * 128, 640 * (64 + 80))),
            "K3_blocks": dict(err=err["K3_blocks"],
                              ms=times[("K3_blocks", 640)][0],
                              plain_ms=times[("K3_blocks", 640)][1],
                              **bound(640 * 128, 640 * 64))}


def random_lanes(seed: int, dev):
    """Seeded `eval_i4x4` inputs on the card: all 16 availability
    combinations, neighbour modes over -2..8, noise, smooth and flat
    content (`tpu264_torch.tools.synth_inputs`)."""
    from tpu264_torch.tools.synth_inputs import random_i4x4_lanes
    arrs = random_i4x4_lanes(seed, reps=3)
    ints = [torch.as_tensor(a, dtype=torch.int32, device=dev)
            for a in arrs[:5]]
    flags = torch.as_tensor(np.stack(arrs[5:], 1), device=dev).unbind(1)
    return (*ints, *flags)


def check_i4x4_wave(dev, wave) -> dict:
    """K2: the wave kernel against `eval_i4x4_plain` on the card, all five
    outputs: the widest wave of the 720p frame (`wave`: the arguments of
    its `wave_body` call), and seeded lanes at QP 0, 28 and 51."""
    from tpu264_torch.coding import intra_frame as tif
    qp, _, lam4, lam24, bd, coords, avail, gy = wave[:8]
    ltop, lleft, _, _, _, _, modes_top, modes_left = tif.gather_border_ctx(
        bd, coords[:, 0].long(), coords[:, 1].long())
    wave_args = (gy, ltop, lleft, modes_top, modes_left, *avail.unbind(1),
                 qp, lam4, lam24)
    err = 0
    cases = [(wave_args[:9], QP)] + [(random_lanes(7 + qp, dev), qp)
                                     for qp in (0, 28, 51)]
    for args, qp in cases:
        lam4, lam24, _ = tif.LAMBDA_TABLE[qp]
        got = tif.eval_i4x4(*args, qp, lam4, lam24)
        torch.cuda.synchronize()
        want = tif.eval_i4x4_plain(*args, qp, lam4, lam24)
        for g, w in zip(got, want):
            if g.shape != w.shape or g.dtype != w.dtype:
                fail("K2 output shape or type differs from the plain one")
            err = max(err, max_abs_err(g, w))
    n_mbs = wave_args[0].shape[0]
    ms = time_ms(lambda: tif.eval_i4x4(*wave_args), 200)
    pms = time_ms(lambda: tif.eval_i4x4_plain(*wave_args), 3)
    print(f"K2 wave of {n_mbs} MBs: kernel {ms:.4f} ms, plain {pms:.3f} ms")
    # a macroblock: 305 int32 + 4 flags in, 545 int32 out; a block step:
    # 144 samples x (6 predict + 8 Hadamard + 9 reduce) and about 400 for
    # choose, transform, quantise and reconstruct
    n_bytes = n_mbs * (305 * 4 + 4 + 545 * 4)
    n_ops = n_mbs * 16 * (144 * 23 + 400)
    return {"K2": dict(err=err, ms=ms, plain_ms=pms,
                       **bound(n_bytes, n_ops))}


def check_deblock_lines(dev, rng) -> dict:
    from tpu264_torch.kernels import deblock_lines as dl
    from tpu264_torch.ref import deblock as rd
    err = 0
    hm = H // 16
    win = torch.as_tensor(rng.integers(0, 256, size=(hm, 16, 8)),
                          dtype=torch.int32, device=dev)
    # smooth content so that every filter branch runs
    smooth = torch.as_tensor(
        120 + rng.integers(0, 6, size=(hm, 16, 8))
        + np.where(np.arange(8) >= 4, rng.integers(0, 12, size=(hm, 16, 1)),
                   0), dtype=torch.int32, device=dev)
    for qp in (10, 28, 51):
        alpha, beta = int(rd.ALPHA_TABLE[qp]), int(rd.BETA_TABLE[qp])
        tc0 = [int(v) for v in rd.TC0_TABLE[qp]]
        for bs_val in range(5):
            for w in (win, smooth):
                bs = torch.full((hm, 16), bs_val, dtype=torch.int32,
                                device=dev)
                got = dl.filter_luma_lines(w, bs, alpha, beta, tc0)
                want = dl.filter_luma_lines_plain(w, bs, alpha, beta, tc0)
                err = max(err, max_abs_err(got, want))
    bs = torch.as_tensor(rng.integers(0, 5, size=(hm, 16)),
                         dtype=torch.int32, device=dev)
    a, b = int(rd.ALPHA_TABLE[QP]), int(rd.BETA_TABLE[QP])
    tc0 = [int(v) for v in rd.TC0_TABLE[QP]]
    ms = time_ms(lambda: dl.filter_luma_lines(smooth, bs, a, b, tc0), 200)
    pms = time_ms(lambda: dl.filter_luma_lines_plain(smooth, bs, a, b, tc0),
                  200)
    print(f"K4_lines {hm * 16} lines: kernel {ms:.4f} ms, plain {pms:.4f} ms")
    # a line: 8 samples + bS in, 8 samples out; about 60 operations
    return {"K4_lines": dict(err=err, ms=ms, plain_ms=pms,
                             **bound(hm * 16 * 68, hm * 16 * 60))}


def clone_bd(bd: dict) -> dict:
    return {k: v.clone() for k, v in bd.items()}


def check_wave_body(dev, wave) -> dict:
    """K3: the I16x16 + chroma wave kernel against `i16_chroma_wave_plain`
    on the card, on the same I4x4 results: every output and the border
    buffers after the scatter.  Cases: the widest wave of the 720p frame
    (`wave`: the arguments of its `wave_body` call) and seeded waves over
    every availability combination, with padding lanes, at QP 0, 28 and
    51.  The whole `wave_body` (K2 reading its context from the border
    buffers, then K3) is held to `wave_body_plain` on the same cases."""
    from tpu264_torch.coding import intra_frame as tif
    from tpu264_torch.kernels import i16_chroma_wave as k3w
    from tpu264_torch.kernels import i4x4_wave as k2w
    from tpu264_torch.ref.transform import chroma_qp
    from tpu264_torch.tools.synth_inputs import random_wave

    def seeded(qp):
        bd, coords, avail, gy, gu, gv = random_wave(40 + qp, W // 16, H // 16)
        i32 = lambda a: torch.as_tensor(a, dtype=torch.int32, device=dev)
        return (qp, chroma_qp(qp), *tif.LAMBDA_TABLE[qp][:2],
                {k: i32(v) for k, v in bd.items()}, i32(coords),
                torch.as_tensor(avail, device=dev), i32(gy), i32(gu), i32(gv))

    def differ(got: dict, want: dict, what: str) -> int:
        if set(got) != set(want):
            fail(f"K3 {what}: keys {sorted(got)} != plain {sorted(want)}")
        worst = 0
        for k, w in want.items():
            if got[k].shape != w.shape or got[k].dtype != w.dtype:
                fail(f"K3 {what} {k}: shape or type differs from the plain "
                     f"one")
            e = max_abs_err(got[k], w)
            if e:
                rows = (got[k] != w).reshape(w.shape[0], -1).any(1)
                print(f"K3 {what} {k}: max abs err {e}, rows "
                      f"{rows.nonzero().flatten().tolist()[:12]}")
            worst = max(worst, e)
        return worst

    err = 0
    combos = set()
    chose = []                      # (I16x16 lanes, lanes) per case
    for case in [wave] + [seeded(qp) for qp in (0, 28, 51)]:
        qp, cqp, lam4, lam24, bd, coords, avail, gy, gu, gv = case
        combos |= {tuple(f) for f in avail[:, :3].tolist()}
        # the whole body: two launches against the plain body
        bd_k, bd_p = clone_bd(bd), clone_bd(bd)
        got = tif.wave_body(qp, cqp, lam4, lam24, bd_k, coords, avail, gy,
                            gu, gv)
        torch.cuda.synchronize()
        want = tif.wave_body_plain(qp, cqp, lam4, lam24, bd_p, coords, avail,
                                   gy, gu, gv)
        err = max(err, differ(got, want, "wave body"),
                  differ(bd_k, bd_p, "wave body borders"))
        # K3 alone, on the plain I4x4 results
        at, al, atl, atr = avail.unbind(1)
        ltop, lleft, _, _, _, _, mtop, mleft = tif.gather_border_ctx(
            bd, coords[:, 0].long(), coords[:, 1].long())
        mb4, modebuf, _, coeffs4, j4 = tif.eval_i4x4_plain(
            gy, ltop, lleft, mtop, mleft, at, al, atl, atr, qp, lam4, lam24)
        k3_args = (coords, avail, gy, gu, gv, mb4, modebuf, coeffs4, j4, qp,
                   cqp)
        bd_k, bd_p = clone_bd(bd), clone_bd(bd)
        out = k3w.alloc_outputs((gy.shape[0],), dev)
        k3w.i16_chroma_wave(bd_k, *k3_args, tif._BLK_ORDER, out)
        torch.cuda.synchronize()
        del out["modes"]
        want = tif.i16_chroma_wave_plain(bd_p, *k3_args)
        err = max(err, differ(out, want, "K3"),
                  differ(bd_k, bd_p, "K3 borders"))
        chose.append((int(want["sel16"].sum()), want["sel16"].numel()))
    if len(combos) != 8:
        fail(f"K3: only {len(combos)} of the 8 combinations of top, left "
             f"and top-left availability occurred")
    print("K3 lanes that chose I16x16, per case: "
          + ", ".join(f"{a} of {n}" for a, n in chose))
    if not any(a for a, _ in chose) or not any(a < n for a, n in chose):
        fail("K3: the cases do not exercise both I16x16 and I4x4 lanes")
    # time the frame's wave: K3 alone, and K2 + K3 as the loop runs them
    qp, cqp, lam4, lam24, bd, coords, avail, gy, gu, gv = wave
    n_mbs = gy.shape[0]
    bd_t = clone_bd(bd)
    mb4, modebuf, _, coeffs4, j4 = k2w.i4x4_wave_bd(
        gy, bd_t, coords, avail, qp, lam4, lam24, tif._K2_RULES)
    k3_args = (coords, avail, gy, gu, gv, mb4, modebuf, coeffs4, j4, qp, cqp)
    out = k3w.alloc_outputs((n_mbs,), dev)
    before = dict(k3w.launches)
    ms = time_ms(lambda: k3w.i16_chroma_wave(bd_t, *k3_args, tif._BLK_ORDER,
                                             out), 200)
    if k3w.launches["K3"] != before["K3"] + 201:
        fail("K3's launch count is not one a call")
    pms = time_ms(lambda: tif.i16_chroma_wave_plain(bd_t, *k3_args), 5)
    body_ms = time_ms(lambda: tif.wave_body(qp, cqp, lam4, lam24, bd_t,
                                            coords, avail, gy, gu, gv,
                                            out=out), 200)
    print(f"K3 wave of {n_mbs} MBs: kernel {ms:.4f} ms, plain {pms:.3f} ms; "
          f"the wave body (K2 + K3) {body_ms:.4f} ms")
    # a macroblock: 58 context samples, 384 source samples, 529 int32 of
    # I4x4 results and 3 flags in; 1 flag, 2 modes, 256 + 16 + 8 + 128
    # levels, 384 samples and 58 border values out.  Operations: 256
    # samples x 4 modes x (4 predict + 8 Hadamard + 10 reduce), the same
    # over 128 chroma samples, and about 300 a 4x4 block for transform,
    # quantiser and reconstruction over 24 blocks
    n_bytes = n_mbs * (4 * (58 + 384 + 529) + 3 + 1 + 4 * (2 + 408 + 384 + 58))
    n_ops = n_mbs * (384 * 4 * 22 + 24 * 300)
    return {"K3": dict(err=err, ms=ms, plain_ms=pms,
                       **bound(n_bytes, n_ops))}


def check_deblock_wave(dev, frame_case) -> dict:
    """K4: the deblock wave kernel (one launch a wave over the raster
    planes) against the plain skewed deblocker on the card, whole planes:
    the 720p frame's reconstruction with its all-intra inputs
    (`frame_case`), and seeded pictures with mixed intra and inter MBs (bS
    0 to 4 all occur) at QP 10, 28 and 51, with 1 slice and with 3 slices
    with and without filtering across them, at 720p and at 5 x 3 MBs."""
    from tpu264_torch.coding.wavefront import build_schedule
    from tpu264_torch.kernels import deblock as kd
    from tpu264_torch.kernels import deblock_wave as k4w
    from tpu264_torch.ref.transform import chroma_qp
    from tpu264_torch.tools.synth_inputs import random_deblock_picture

    def run(sched, across, args, what):
        got = kd.make_deblocker_skewed(sched, across)(*args)
        torch.cuda.synchronize()
        want = kd.make_deblocker_skewed(sched, across, plain=True)(*args)
        worst = 0
        for g, w, o in zip(got, want, args[:3]):
            if g.shape != w.shape or g.dtype != w.dtype:
                fail(f"K4 {what}: plane shape or type differs from the "
                     f"plain one")
            worst = max(worst, max_abs_err(g, w))
            if args[7] >= 16 and not (w != o.to(w.dtype)).any():
                fail(f"K4 {what}: the deblocker changed nothing")
        return worst

    sched_720 = build_schedule(W // 16, H // 16, 1)
    before = k4w.launches["K4"]
    err = run(sched_720, True, frame_case, "720p frame")
    if k4w.launches["K4"] != before + sched_720.n_waves:
        fail("K4's launch count is not one a wave")
    for wm, hm in ((W // 16, H // 16), (5, 3)):
        for qp in (10, 28, 51):
            arrs = random_deblock_picture(qp + wm, wm, hm)
            y, u, v, intra_mb, tc, mv, ref = (
                torch.as_tensor(a, device=dev) for a in arrs)
            bs = torch.cat(kd.compute_bs_maps(intra_mb, tc, mv, ref))
            if sorted(set(bs.unique().tolist())) != [0, 1, 2, 3, 4]:
                fail(f"K4: the seeded {wm}x{hm} picture lacks a bS value")
            args = (y, u, v, intra_mb, tc, mv, ref, qp, chroma_qp(qp))
            for slices, across in ((1, True), (3, True), (3, False)):
                err = max(err, run(build_schedule(wm, hm, slices), across,
                                   args, f"{wm}x{hm} QP {qp} {slices} "
                                         f"slices across={across}"))
    # time: the kernel's launches of a frame against the whole plain
    # deblocker (which also derives bS and skews the planes), per wave
    y, u, v, intra_mb, tc, mv, ref, qp, cqp = frame_case
    bs_v, bs_h = kd.compute_bs_maps(intra_mb, tc, mv, ref)
    planes = [p.to(torch.int32, copy=True).contiguous() for p in (y, u, v)]
    n_waves = sched_720.n_waves

    def kernel_frame():
        for cp in range(n_waves):
            k4w.deblock_wave(*planes, bs_v, bs_h, cp, qp, cqp)

    ms = time_ms(kernel_frame, 10) / n_waves
    plain = kd.make_deblocker_skewed(sched_720, True, plain=True)
    pms = time_ms(lambda: plain(*frame_case), 2) / n_waves
    print(f"K4 720p frame, a wave of {n_waves}: kernel {ms:.4f} ms, plain "
          f"{pms:.3f} ms")
    # a frame: every sample and every bS read once, every sample written
    # once; 16 lines x 8 luma edges x 60 operations and 8 lines x 8 chroma
    # edges x 30 a macroblock; a wave is 1 / n_waves of it
    n_bytes = (2 * 4 * (W * H * 3 // 2) + 2 * 4 * (W // 4) * (H // 4))
    n_ops = (W // 16) * (H // 16) * (16 * 8 * 60 + 8 * 8 * 30)
    return {"K4": dict(err=err, ms=ms, plain_ms=pms,
                       **bound(n_bytes / n_waves, n_ops / n_waves))}


def frame_records(dev, frame, slices: int, spy=None, deblock_case=None):
    """CABAC records of one 720p frame through the port's own stages ->
    (records, counts, init, word cap).  `spy(args)` sees the arguments of
    every `wave_body` call of the wave loop, the border buffers as they
    are before the call; `deblock_case`, a list, takes the deblocker's
    arguments for the frame."""
    from tpu264_torch.coding import intra_frame as tif
    from tpu264_torch.coding.encoder import Encoder
    from tpu264_torch.config import EncoderConfig
    from tpu264_torch.entropy import cabac_engine_cuda as k1
    enc = Encoder(EncoderConfig(width=W, height=H, qp=QP, symbol_mode="CABAC",
                                slices_per_frame=slices), device=dev)
    y, u, v = (torch.as_tensor(p, device=dev) for p in frame)
    inner = tif.wave_body

    def seen(*args, **kw):
        spy((*args[:4], clone_bd(args[4]), *args[5:]))
        return inner(*args, **kw)

    if spy is not None:
        tif.wave_body = seen
    try:
        dev_out, ys = enc._encode_frame(y, u, v, QP)
    finally:
        tif.wave_body = inner
    mbd = tif.reorder_wave_outputs(enc.sched, ys)
    if deblock_case is not None:
        from tpu264_torch.ref.transform import chroma_qp
        deblock_case += [dev_out["recon_y"], dev_out["recon_u"],
                         dev_out["recon_v"], *enc._deblock_inputs(mbd), QP,
                         chroma_qp(QP)]
    recs, counts = enc._cabac_records(mbd)
    init = torch.as_tensor(k1.init_packed_states(0, QP), device=dev)
    return recs, counts, init, enc._cap_words


def engine_err(recs, counts, init, cap_words, what: str):
    """K1 against its plain version on one input -> (max abs err of the
    words, the plain version's host milliseconds)."""
    from tpu264_torch.entropy import cabac_engine_cuda as k1
    words, nbytes = k1.encode_slices(recs, counts, init, cap_words)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    pw, pnb = k1.encode_slices_plain(recs, counts, init, cap_words)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.monotonic() - t0)
    if not torch.equal(nbytes, pnb):
        fail(f"K1 {what}: nbytes {nbytes.tolist()} != plain {pnb.tolist()}")
    if int(nbytes.min()) <= 0:
        fail(f"K1 {what}: empty or overflowed payload {nbytes.tolist()}")
    return max_abs_err(words, pw), plain_ms


def check_cabac(dev, frame) -> tuple[dict, tuple, list]:
    """K1 against `encode_slices_plain`: the 720p frame as one slice (the
    main path's shape, timed) and as three, and seeded records with long
    bypass runs, runs of up to 8191 bins in one context, and piles of
    outstanding bits resolved with and without a carry.  Also returns the
    `wave_body` arguments of the frame's widest wave (for the K2 and K3
    checks) and the deblocker's arguments for the frame (for K4's)."""
    from tpu264_torch.entropy import cabac_binarize as cbz
    from tpu264_torch.entropy import cabac_engine_cuda as k1
    from tpu264_torch.tools import synth_inputs as si
    waves, deblock_case = [], []
    recs, counts, init, cap_words = frame_records(dev, frame, 1, waves.append,
                                                  deblock_case)
    err, plain_ms = engine_err(recs, counts, init, cap_words, "720p, 1 slice")
    ms = time_ms(lambda: k1.encode_slices(recs, counts, init, cap_words), 10)
    n = int(counts[0])
    kind, _, b = cbz.unpack_records(recs[0, :n].cpu().numpy())
    bins = int(np.where(kind == 0, b >> 1, np.where(kind == 1, b, 1)).sum())
    nbytes = int(k1.encode_slices(recs, counts, init, cap_words)[1].sum())
    print(f"K1 {n} records, {bins} bins -> {nbytes} bytes: kernel "
          f"{ms:.3f} ms, plain (host loop) {plain_ms:.1f} ms")
    err = max(err, engine_err(*frame_records(dev, frame, 3),
                              "720p, 3 slices")[0])
    rng = np.random.default_rng(5)
    long_bypass = (np.ones(4000, np.int32),
                   rng.integers(0, 1 << 16, size=4000).astype(np.int32),
                   np.full(4000, 16, np.int32))
    slices = [si.carry_records(s, runs=(3, 9, 40, 130, 700, 5000),
                               tail=300 + 2500 * s) for s in range(3)]
    slices.append(tuple(np.concatenate(p) for p in
                        zip(long_bypass, si.random_records(6, 3000))))
    slices.append(si.long_run_records(9, n=40, tail=500))
    srecs, scounts = si.pack_record_slices(slices)
    serr, _ = engine_err(torch.as_tensor(srecs, device=dev),
                         torch.as_tensor(scounts, device=dev), init, 8192,
                         "seeded carry and bypass records")
    err = max(err, serr)
    # records after a terminate bin 1: the kernel reports them (-2)
    stray = [tuple(np.concatenate(p) for p in
                   zip(si.random_records(8, 40), si.random_records(9, 30)))]
    strecs, stcounts = si.pack_record_slices(stray)
    refused = k1.encode_slices(torch.as_tensor(strecs, device=dev),
                               torch.as_tensor(stcounts, device=dev), init,
                               512)[1].tolist()
    if refused != [-2]:
        fail(f"K1: records after the final terminate gave nbytes {refused}, "
             f"not [-2]")
    # bytes: records and contexts in, payload and its size out;
    # operations: about 43 a bin (the coding loop's instruction count)
    bound_ = bound(4 * n + 4 * 460 + nbytes + 4, 43 * bins)
    # the middle wave of the frame has the most valid lanes
    return ({"K1": dict(err=err, ms=ms, plain_ms=plain_ms, bins=bins,
                        **bound_)}, waves[len(waves) // 2], deblock_case)


def launch_counts() -> list:
    """The wrappers' launch counters (one dict a module)."""
    from tpu264_torch.entropy import cabac_engine_cuda as k1
    from tpu264_torch.kernels import dct_quant as dq, deblock_lines as dl, \
        deblock_wave as k4w, i16_chroma_wave as k3w, i4x4_wave as k2w
    return [k1.launches, k2w.launches, k3w.launches, k4w.launches,
            dq.launches, dl.launches]


def reset_counts() -> None:
    for c in launch_counts():
        for k in c:
            c[k] = 0


def read_counts() -> dict:
    return {k: v for c in launch_counts() for k, v in c.items()}


def phase_encode(frames) -> dict:
    """Config 3 at 720p: all-intra CABAC + deblock -> launch counts."""
    from tpu264_torch.coding.encoder import Encoder
    from tpu264_torch.config import EncoderConfig
    golden = json.loads((ROOT / "tests" / "data" / "torch_golden.json")
                        .read_text())   # top level: config 3
    cfg = EncoderConfig(width=W, height=H, qp=QP, symbol_mode="CABAC",
                        deblock=True)
    enc = Encoder(cfg)              # no device named: the card
    if enc.device.type != "cuda":
        fail(f"Encoder(cfg) chose {enc.device}, not the card")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    stream = enc.encode_sequence(frames)
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    counts = read_counts()
    print(f"config 3 at 720p, launches on the path: {counts}")
    n_waves = enc.sched.n_waves
    for k, (name, _, _, on_path) in KERNELS.items():
        if on_path and counts[k] <= 0:
            fail(f"kernel {k} ({name}) was not launched on the main path")
        if not on_path and counts[k] != 0:
            fail(f"{k} ({name}) ran {counts[k]} times on the main path, "
                 f"which holds its wave form")
    if counts["K1"] != len(frames):
        fail(f"K1 ran {counts['K1']} times for {len(frames)} frames")
    if counts["K2"] != n_waves * len(frames):
        fail(f"K2 ran {counts['K2']} times, not once for each of the "
             f"{n_waves} waves of {len(frames)} frames")
    for k in ("K3", "K4"):
        if not len(frames) <= counts[k] <= n_waves * len(frames):
            fail(f"{k} ran {counts[k]} times for {len(frames)} frames of "
                 f"{n_waves} waves: more than once a wave")
    print(f"launches a frame: " + ", ".join(
        f"{k} {counts[k] / len(frames):g}" for k in KERNELS))
    for i, st in enumerate(enc.stats):
        print(f"frame {i}: {st.bits} bits, PSNR-Y {st.psnr_y:.3f} dB, "
              f"PSNR-U {st.psnr_u:.3f}, PSNR-V {st.psnr_v:.3f}, "
              f"{st.seconds:.3f} s")
    print(f"encode: {len(frames)} frames in {secs:.3f} s = "
          f"{len(frames) / secs:.4f} frames/s (eager, first run)")
    for ry, ru, rv in enc.recons:
        if tuple(ry.shape) != (H, W) or tuple(ru.shape) != (H // 2, W // 2) \
                or ry.dtype != torch.uint8:
            fail("recon planes have the wrong shape or type")
    sha = hashlib.sha256(stream).hexdigest()
    print(f"stream: {len(stream)} bytes, sha256 {sha}")
    if [st.bits for st in enc.stats] != golden["frame_bits"]:
        fail(f"frame bits {[st.bits for st in enc.stats]} != golden "
             f"{golden['frame_bits']}")
    if sha != golden["sha256"] or len(stream) != golden["bytes"]:
        fail("stream differs from the reference golden")
    return counts


def golden(name: str) -> dict:
    return json.loads((ROOT / "tests" / "data" / "torch_golden.json")
                      .read_text())[name]


def encode_golden(name: str, what: str, **enc_kw):
    """Encode the frames of golden `name` through `Encoder(cfg)` (no
    device named: the card) and hold stream and frame sizes to it ->
    (encoder, stream, seconds)."""
    from tpu264_torch.coding.encoder import Encoder
    from tpu264_torch.config import EncoderConfig
    from tpu264_torch.media.synth import synth_frame
    g = golden(name)
    cfg = EncoderConfig(**g["config"])
    frames = [synth_frame(cfg.width, cfg.height, t)
              for t in range(g["frames"])]
    enc = Encoder(cfg, **enc_kw)
    if enc.device.type != "cuda":
        fail(f"{what}: Encoder(cfg) chose {enc.device}, not the card")
    torch.cuda.synchronize()
    t0 = time.monotonic()
    stream = enc.encode_sequence(frames)
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    sha = hashlib.sha256(stream).hexdigest()
    print(f"{what}: {len(frames)} frames in {secs:.3f} s = "
          f"{len(frames) / secs:.4f} frames/s (eager, first run); "
          f"{len(stream)} bytes, sha256 {sha}")
    for i, st in enumerate(enc.stats):
        print(f"  frame {i} {st.slice_type}: {st.bits} bits, PSNR-Y "
              f"{st.psnr_y:.3f} dB, {st.seconds:.3f} s")
    if [st.bits for st in enc.stats] != g["frame_bits"]:
        fail(f"{what}: frame bits {[st.bits for st in enc.stats]} != golden "
             f"{g['frame_bits']}")
    if sha != g["sha256"] or len(stream) != g["bytes"]:
        fail(f"{what}: stream differs from the reference golden")
    return enc, stream, secs


def phase_config1() -> None:
    """Config 1: QCIF all-intra CAVLC, 5 frames through the batched entry;
    the per-frame path on the card gives the same stream."""
    enc, batched, _ = encode_golden("config1_qcif", "config 1 (batched)")
    if enc.cabac or enc.intra_batch < 2:
        fail("config 1 did not take the batched CAVLC entry")
    _, per_frame, _ = encode_golden("config1_qcif", "config 1 (per frame)",
                                    intra_batch=1)
    if per_frame != batched:
        fail("config 1: the batched entry and the per-frame path differ")


def phase_config2() -> None:
    """Config 2: CIF IPPP CAVLC, 1 IDR + 2 P, deblock on."""
    enc, _, _ = encode_golden("config2_cif", "config 2 (CIF IPPP)")
    if [st.slice_type for st in enc.stats] != ["IDR", "P", "P"]:
        fail("config 2: not an IDR and two P frames")


def phase_ippp_720p() -> dict:
    """IPPP CAVLC at 1280x720 against its golden, the launches of each
    frame asserted -> launch counts of the whole path."""
    from tpu264_torch.coding.encoder import Encoder
    per_frame = []
    queued = []     # seconds of each frame's device work, synchronised
    real = {}

    def counted(kind, fn):
        def run(*a, **kw):
            before = read_counts()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            queued.append(time.monotonic() - t0)
            after = read_counts()
            per_frame.append((kind, {k: after[k] - before[k]
                                     for k in after}))
            return out
        return run

    for kind, attr in (("IDR", "encode_intra_frame"), ("P", "encode_p_frame")):
        real[attr] = getattr(Encoder, attr)
        setattr(Encoder, attr, counted(kind, real[attr]))
    reset_counts()
    try:
        enc, _, secs = encode_golden("ippp_720p", "IPPP at 720p")
    finally:
        for attr, fn in real.items():
            setattr(Encoder, attr, fn)
    counts = read_counts()
    n_waves = enc.sched.n_waves
    print(f"IPPP at 720p, launches on the path: {counts}")
    if [k for k, _ in per_frame] != ["IDR", "P", "P"]:
        fail(f"IPPP at 720p: frames {[k for k, _ in per_frame]}")
    for i, (kind, c) in enumerate(per_frame):
        print(f"  frame {i} {kind} launches: {c}")
        want = ({"K1": 0, "K2": n_waves, "K2_blocks": 0, "K3_blocks": 0}
                if kind == "IDR" else
                {"K1": 0, "K2": n_waves, "K3": 0, "K2_blocks": n_waves,
                 "K3_blocks": K3_BLOCKS_PER_P_WAVE * n_waves})
        for k, n in want.items():
            if c[k] != n:
                fail(f"IPPP at 720p frame {i} ({kind}): {k} ran {c[k]} "
                     f"times, not {n} ({n_waves} waves)")
        at_most_a_wave = ("K3", "K4") if kind == "IDR" else ("K4",)
        for k in at_most_a_wave:
            if not 1 <= c[k] <= n_waves:
                fail(f"IPPP at 720p frame {i} ({kind}): {k} ran {c[k]} "
                     f"times for {n_waves} waves")
    if sum(sum(c.values()) for _, c in per_frame) != sum(counts.values()):
        fail("IPPP at 720p: launches outside the frames' encode calls")
    # `FrameStats.seconds` of a pipelined frame runs until the next frame
    # is queued, so the frames' own times are taken around their calls
    print(f"IPPP at 720p (eager, first run), device work of a frame: IDR "
          f"{queued[0]:.3f} s, P frames "
          f"{', '.join(f'{t:.3f}' for t in queued[1:])} s; "
          f"{len(enc.stats) / secs:.4f} frames/s with pull and NAL assembly")
    return counts


def phase_p_wave_body_vs_cpu(dev) -> None:
    """One CIF P frame through `make_inter_encoder` on the card and on the
    CPU: every per-wave output and the recon planes are equal.  On the
    card the body runs K2 (wave form) and the slab entries K2_blocks and
    K3_blocks; on the CPU their plain versions."""
    from tpu264_torch.coding.inter_frame import make_inter_encoder
    from tpu264_torch.coding.wavefront import build_schedule
    from tpu264_torch.media.synth import synth_frame
    w, h = 352, 288
    sched = build_schedule(w // 16, h // 16, 3)
    cur = [p.copy() for p in synth_frame(w, h, 3)]
    ref = synth_frame(w, h, 2)
    # a patch no motion vector explains: intra MBs among the inter ones
    cur[0][96:160, 128:224] = np.random.default_rng(1).integers(
        0, 256, (64, 96), dtype=np.uint8)
    planes = [torch.as_tensor(p) for p in cur + list(ref)]
    encode = make_inter_encoder(sched)
    before = read_counts()
    out_d, ys_d = encode(*(p.to(dev) for p in planes), QP)
    torch.cuda.synchronize()
    after = read_counts()
    ran = {k: after[k] - before[k] for k in ("K2", "K2_blocks", "K3_blocks")}
    want = {"K2": sched.n_waves, "K2_blocks": sched.n_waves,
            "K3_blocks": K3_BLOCKS_PER_P_WAVE * sched.n_waves}
    if ran != want:
        fail(f"P wave body on the card launched {ran}, not {want}")
    out_c, ys_c = encode(*planes, QP)
    if read_counts() != after:
        fail("P wave body on the CPU launched a kernel")
    worst = {}
    for k, c in {**ys_c, **out_c}.items():
        d = {**ys_d, **out_d}[k]
        if d.shape != c.shape or d.dtype != c.dtype:
            fail(f"P wave body {k}: shape or type differs between card and "
                 f"CPU")
        worst[k] = max_abs_err(d.cpu(), c)
    if any(worst.values()):
        fail(f"P wave body on the card differs from the CPU (max abs err): "
             f"{ {k: e for k, e in worst.items() if e} }")
    inter = ys_c["is_inter"][torch.as_tensor(sched.valid)]
    print(f"P wave body, CIF frame of {sched.n_waves} waves: card equals CPU "
          f"on {len(worst)} outputs (tolerance 0); {int(inter.sum())} inter "
          f"and {int((~inter).sum())} intra MBs")
    if not inter.any() or inter.all():
        fail("P wave body check: the frame does not mix inter and intra MBs")


def main() -> int:
    kind = phase_device()
    dev = torch.device("cuda")
    sys.path.insert(0, str(ROOT))
    phase_build()
    from tpu264_torch.media.synth import synth_frame
    frames = [synth_frame(W, H, t) for t in range(2)]
    rng = np.random.default_rng(0)
    results = {}
    results.update(check_dct(dev, rng))
    results.update(check_deblock_lines(dev, rng))
    k1_result, wave, deblock_case = check_cabac(dev, frames[0])
    results.update(k1_result)
    results.update(check_i4x4_wave(dev, wave))
    results.update(check_wave_body(dev, wave))
    results.update(check_deblock_wave(dev, deblock_case))
    wrong = {k: r["err"] for k, r in sorted(results.items()) if r["err"]}
    if wrong:
        fail(f"kernels differ from their plain versions (max abs err): "
             f"{wrong}")
    print("kernels equal their plain versions (tolerance 0)")
    counts = phase_encode(frames)
    phase_config1()
    phase_config2()
    counts_p = phase_ippp_720p()
    phase_p_wave_body_vs_cpu(dev)
    rows = []
    for k in sorted(KERNELS):
        name, source, replaces, _ = KERNELS[k]
        r = results[k]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": counts[k] + counts_p[k],
               "launches_by_path": {"config3_720p": counts[k],
                                    "ippp_720p": counts_p[k]},
               "max_abs_err": r["err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": None}
        if "bins" in r:
            row["bins"] = r["bins"]
        rows.append(row)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

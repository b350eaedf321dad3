"""Smoke run of the PyTorch/CUDA port (`tpu264_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, before the result line):
 1. print the card (`nvidia-smi` name, power limit) and the torch / CUDA
    versions; refuse to run without CUDA;
 2. build the CUDA kernel library from `tpu264_torch/csrc` (timed);
 3. hold each kernel (K1 CABAC engine, K2 I4x4 wave body, the standalone
    DCT + quant entry, K3 DCT, K4 luma deblock lines) to its plain torch
    version on the card, at the shapes of the 720p main path and on
    seeded corner cases, with exact equality, and time both;
 4. encode two 1280x720 frames (all-intra, CABAC, deblock, QP 28)
    through `Encoder(cfg).encode_sequence` (the default device is the
    card), check that every kernel of the path was launched (K2 once a
    wave), and hold the stream's SHA-256 to
    `tests/data/torch_golden.json` (made by the JAX reference encoder).

The line before the last is a JSON object with one entry per kernel;
the last line is {"ok": true, "device": {...}}.

`bound_ms` of a kernel is the larger of its bytes (each input read once,
each output written once) over 3.35 TB/s and its integer operations over
the card's int32 issue rate (132 SMs x 64 int32 lanes x 1.98 GHz, about
16.7 TOP/s; the data sheet's 67 TFLOP/s counts a float32 multiply-add
on 128 lanes as two), both counted from this run's inputs.  K1 and K2
are bound by neither but by a chain of dependent steps, which `PERF.md`
models; K1's row also carries `bins`, counted from this run's records.
`library_ms` is null throughout: no single PyTorch call computes a CABAC
coder, an H.264 intra search, the H.264 integer transform with its
quantiser, or the deblocking line filter.
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

# count key -> (name, source, TPU kernel it replaces, on the main path)
KERNELS = {
    "K1": ("cabac_engine", "tpu264_torch/csrc/cabac_engine.cu",
           "tpu264/entropy/cabac_pallas.py:44", True),
    "K2": ("i4x4_wave", "tpu264_torch/csrc/i4x4_wave.cu",
           "tpu264/kernels/pallas_kernels.py:55", True),
    "K2_blocks": ("dct_quant", "tpu264_torch/csrc/dct_quant.cu",
                  "tpu264/kernels/pallas_kernels.py:55", False),
    "K3": ("dct", "tpu264_torch/csrc/dct_quant.cu",
           "tpu264/kernels/pallas_kernels.py:66", True),
    "K4": ("deblock_luma_lines", "tpu264_torch/csrc/deblock_luma.cu",
           "tpu264/kernels/pallas_kernels.py:142", True),
}
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
    err = {"K2_blocks": 0, "K3": 0}
    times = {}
    for n in (40, 640, 57600):
        x = torch.as_tensor(rng.integers(-255, 256, size=(n, 4, 4)),
                            dtype=torch.int32, device=dev)
        got = dq.fdct4x4(x)
        want = dq.fdct4x4_plain(x)
        err["K3"] = max(err["K3"], max_abs_err(got, want))
        times[("K3", n)] = (time_ms(lambda: dq.fdct4x4(x), 200),
                            time_ms(lambda: dq.fdct4x4_plain(x), 200))
        for qp in (0, 28, 51):
            for intra in (True, False):
                got = dq.fdct_quant4x4(x, qp, intra)
                want = dq.fdct_quant4x4_plain(x, qp, intra)
                err["K2_blocks"] = max(err["K2_blocks"],
                                       max_abs_err(got, want))
        times[("K2_blocks", n)] = (
            time_ms(lambda: dq.fdct_quant4x4(x, QP, True), 200),
            time_ms(lambda: dq.fdct_quant4x4_plain(x, QP, True), 200))
    for (k, n), (ms, pms) in sorted(times.items()):
        print(f"{k} {n:6d} blocks: kernel {ms:.4f} ms, plain {pms:.4f} ms")
    # a block: 64 B in, 64 B out; 64 adds/shifts for the two butterfly
    # passes, and 5 operations a coefficient for the quantiser
    return {"K2_blocks": dict(err=err["K2_blocks"],
                              ms=times[("K2_blocks", 40)][0],
                              plain_ms=times[("K2_blocks", 40)][1],
                              **bound(40 * 128, 40 * (64 + 80))),
            "K3": dict(err=err["K3"], ms=times[("K3", 640)][0],
                       plain_ms=times[("K3", 640)][1],
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


def check_i4x4_wave(dev, wave_args) -> dict:
    """K2: the wave kernel against `eval_i4x4_plain` on the card, all five
    outputs: the widest wave of the 720p frame, and seeded lanes at QP 0,
    28 and 51."""
    from tpu264_torch.coding import intra_frame as tif
    err = 0
    cases = [(wave_args[:9], QP)] + [(random_lanes(7 + qp, dev), qp)
                                     for qp in (0, 28, 51)]
    for args, qp in cases:
        lam4, lam24 = tif.LAMBDA_TABLE[qp]
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


def check_deblock(dev, rng) -> dict:
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
    print(f"K4 {hm * 16} lines: kernel {ms:.4f} ms, plain {pms:.4f} ms")
    # a line: 8 samples + bS in, 8 samples out; about 60 operations
    return {"K4": dict(err=err, ms=ms, plain_ms=pms,
                       **bound(hm * 16 * 68, hm * 16 * 60))}


def frame_records(dev, frame, slices: int, spy=None):
    """CABAC records of one 720p frame through the port's own stages ->
    (records, counts, init, word cap).  `spy(args)` sees every
    `eval_i4x4` call of the wave loop."""
    from tpu264_torch.coding import intra_frame as tif
    from tpu264_torch.coding.encoder import Encoder
    from tpu264_torch.config import EncoderConfig
    from tpu264_torch.entropy import cabac_engine_cuda as k1
    enc = Encoder(EncoderConfig(width=W, height=H, qp=QP, symbol_mode="CABAC",
                                slices_per_frame=slices), device=dev)
    y, u, v = (torch.as_tensor(p, device=dev) for p in frame)
    inner = tif.eval_i4x4

    def seen(*args):
        spy(args)
        return inner(*args)

    if spy is not None:
        tif.eval_i4x4 = seen
    try:
        _, ys = enc._encode_frame(y, u, v, QP)
    finally:
        tif.eval_i4x4 = inner
    recs, counts = enc._cabac_records(tif.reorder_wave_outputs(enc.sched, ys))
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


def check_cabac(dev, frame) -> tuple[dict, tuple]:
    """K1 against `encode_slices_plain`: the 720p frame as one slice (the
    main path's shape, timed) and as three, and seeded records with long
    bypass runs, runs of up to 8191 bins in one context, and piles of
    outstanding bits resolved with and without a carry.  Also returns the
    `eval_i4x4` arguments of the frame's widest wave for the K2 check."""
    from tpu264_torch.entropy import cabac_binarize as cbz
    from tpu264_torch.entropy import cabac_engine_cuda as k1
    from tpu264_torch.tools import synth_inputs as si
    waves = []
    recs, counts, init, cap_words = frame_records(dev, frame, 1, waves.append)
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
                        **bound_)}, waves[len(waves) // 2])


def launch_counts() -> list:
    """The wrappers' launch counters (one dict a module)."""
    from tpu264_torch.entropy import cabac_engine_cuda as k1
    from tpu264_torch.kernels import dct_quant as dq, deblock_lines as dl, \
        i4x4_wave as k2w
    return [k1.launches, k2w.launches, dq.launches, dl.launches]


def reset_counts() -> None:
    for c in launch_counts():
        for k in c:
            c[k] = 0


def read_counts() -> dict:
    return {k: v for c in launch_counts() for k, v in c.items()}


def phase_encode(frames) -> dict:
    from tpu264_torch.coding.encoder import Encoder
    from tpu264_torch.config import EncoderConfig
    golden = json.loads((ROOT / "tests" / "data" / "torch_golden.json")
                        .read_text())
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
    print(f"launches on the main path: {counts}")
    for k, (name, _, _, on_path) in KERNELS.items():
        if on_path and counts[k] <= 0:
            fail(f"kernel {k} ({name}) was not launched on the main path")
    n_waves = enc.sched.n_waves
    if counts["K2"] != n_waves * len(frames):
        fail(f"K2 ran {counts['K2']} times, not once for each of the "
             f"{n_waves} waves of {len(frames)} frames")
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
    results.update(check_deblock(dev, rng))
    k1_result, wave_args = check_cabac(dev, frames[0])
    results.update(k1_result)
    results.update(check_i4x4_wave(dev, wave_args))
    for k, r in sorted(results.items()):
        if r["err"] != 0:
            fail(f"kernel {k} differs from its plain version "
                 f"(max abs err {r['err']})")
    print("kernels equal their plain versions (tolerance 0)")
    counts = phase_encode(frames)
    rows = []
    for k in sorted(KERNELS):
        name, source, replaces, _ = KERNELS[k]
        r = results[k]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": counts[k],
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

"""Stage profile of one warm 720p all-intra CABAC + deblock frame on the card.

    python -m tpu264_torch.tools.profile_frame [--out FILE.json]

Encodes `synth_frame(1280, 720, t)` frames (QP 28, one slice) and prints
one JSON object with, for warm frames:

- `frame_seconds`: `Encoder.encode_sequence` of one frame, host clock,
  synchronised on both sides;
- `stages`: host clock around each stage of a frame with a
  `torch.cuda.synchronize()` on both sides (wave loop, reorder,
  binarize + compact, deblock, K1 + payload pull);
- `eval_i4x4`: seconds inside `eval_i4x4` over the frame's waves
  (synchronised on both sides of every call) beside that frame's wave
  loop seconds, and the calls;
- `profile`: `torch.profiler` over one more frame: kernel launches in
  all and inside `eval_i4x4`, device busy seconds, the frame's seconds
  under the profiler;
- `cabac`: records, bins (a kind-0 record counts its run, a bypass
  record its bits, a terminate 1) and payload bytes of the frame.

With `--k1-stages` the kernel library is built with `-DK1_PROFILE`, and
every launch of the CABAC coder prints, per slice and stage (warp 0 the
coder, 1 the resolver, 2 the loader), the cycles the stage worked beside the
cycles of the whole launch.

It needs a CUDA card and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import bisect
import json
import subprocess
import sys
import time

import numpy as np
import torch

from tpu264_torch.coding import intra_frame
from tpu264_torch.coding.encoder import Encoder
from tpu264_torch.config import EncoderConfig
from tpu264_torch.entropy import cabac_binarize as cbz
from tpu264_torch.media.synth import synth_frame

W, H, QP = 1280, 720, 28


class Clock:
    """Host seconds of a block, synchronised on both sides."""

    def __init__(self, sink: dict, key: str):
        self.sink, self.key = sink, key

    def __enter__(self):
        torch.cuda.synchronize()
        self.t0 = time.monotonic()

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.sink[self.key] = (self.sink.get(self.key, 0.0)
                               + time.monotonic() - self.t0)


def stage_times(enc: Encoder, frame) -> tuple[dict, dict]:
    """One frame stage by stage -> (stage seconds, cabac counts)."""
    st: dict = {}
    dev = enc.device
    with Clock(st, "upload"):
        y, u, v = (torch.as_tensor(np.asarray(p), device=dev) for p in frame)
    with Clock(st, "wave_loop"):
        dev_out, ys = enc._encode_frame(y, u, v, QP)
    with Clock(st, "reorder"):
        mbd = intra_frame.reorder_wave_outputs(enc.sched, ys)
    with Clock(st, "binarize_compact"):
        recs, counts = enc._cabac_records(mbd)
    with Clock(st, "deblock"):
        enc._apply_deblock(dev_out, mbd, QP)
    with Clock(st, "k1_and_pull"):
        payloads = enc._cabac_payloads(recs, counts, QP)
    n = int(counts[0])
    kind, _, b = cbz.unpack_records(recs[0, :n].cpu().numpy())
    bins = int(np.where(kind == 0, b >> 1, np.where(kind == 1, b, 1)).sum())
    cabac = {"records": n, "bins": bins,
             "ctx_bins": int((b >> 1)[kind == 0].sum()),
             "bypass_bins": int(b[kind == 1].sum()),
             "payload_bytes": sum(len(p) for p in payloads)}
    return st, cabac


def i4x4_share(enc: Encoder, frame) -> dict:
    """Seconds inside `eval_i4x4` beside the same frame's wave loop."""
    inner = intra_frame.eval_i4x4
    acc: dict = {}
    calls = 0

    def timed(*args, **kw):
        nonlocal calls
        calls += 1
        with Clock(acc, "eval_i4x4"):
            return inner(*args, **kw)

    y, u, v = (torch.as_tensor(np.asarray(p), device=enc.device)
               for p in frame)
    intra_frame.eval_i4x4 = timed
    try:
        with Clock(acc, "wave_loop"):
            enc._encode_frame(y, u, v, QP)
    finally:
        intra_frame.eval_i4x4 = inner
    return {"seconds": acc["eval_i4x4"], "calls": calls,
            "wave_loop_seconds": acc["wave_loop"],
            "share_of_wave_loop": acc["eval_i4x4"] / acc["wave_loop"]}


def profiled_frame(enc: Encoder, frame) -> dict:
    """Launch counts of one frame from `torch.profiler`."""
    from torch.profiler import ProfilerActivity, profile, record_function
    inner = intra_frame.eval_i4x4

    def tagged(*args, **kw):
        with record_function("eval_i4x4"):
            return inner(*args, **kw)

    intra_frame.eval_i4x4 = tagged
    try:
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        with profile(activities=acts) as prof:
            enc.encode_sequence([frame])
            torch.cuda.synchronize()
        secs = time.monotonic() - t0
    finally:
        intra_frame.eval_i4x4 = inner
    spans, launch_at = [], []
    device_us = 0.0
    n_kernels = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n_kernels += 1
            device_us += e.time_range.end - e.time_range.start
        elif e.name == "eval_i4x4":
            spans.append((e.time_range.start, e.time_range.end))
        elif e.name.startswith("cudaLaunchKernel"):
            launch_at.append(e.time_range.start)
    launch_at.sort()
    inside = sum(bisect.bisect_right(launch_at, hi)
                 - bisect.bisect_left(launch_at, lo) for lo, hi in spans)
    return {"frame_seconds_profiled": secs, "device_events": n_kernels,
            "device_busy_seconds": device_us * 1e-6,
            "launches": len(launch_at), "launches_in_eval_i4x4": inside,
            "eval_i4x4_calls": len(spans)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the JSON object to this file")
    ap.add_argument("--k1-stages", action="store_true",
                    help="build with -DK1_PROFILE: the CABAC coder prints "
                         "the busy cycles of its stages at every launch")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_frame needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    if args.k1_stages:
        from tpu264_torch.kernels import _build
        _build.NVCC_FLAGS.append("-DK1_PROFILE")
    cfg = EncoderConfig(width=W, height=H, qp=QP, symbol_mode="CABAC",
                        deblock=True)
    enc = Encoder(cfg)
    frames = [synth_frame(W, H, t) for t in range(2)]
    enc.encode_sequence(frames[:1])                 # cold: build + warm-up
    res: dict = {"card": card, "device": str(enc.device),
                 "torch": torch.__version__,
                 "config": f"{W}x{H} all-intra CABAC deblock QP {QP}"}
    warm = {}
    with Clock(warm, "frame"):
        enc.encode_sequence(frames[1:])
    res["frame_seconds"] = warm["frame"]
    res["stages"], res["cabac"] = stage_times(enc, frames[1])
    res["eval_i4x4"] = i4x4_share(enc, frames[1])
    res["profile"] = profiled_frame(enc, frames[1])
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

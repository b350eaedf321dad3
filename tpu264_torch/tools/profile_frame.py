"""Stage profile of one warm 720p all-intra CABAC + deblock frame on the card.

    python -m tpu264_torch.tools.profile_frame [--out FILE.json]

Encodes `synth_frame(1280, 720, t)` frames (QP 28, one slice) and prints
one JSON object with, for warm frames:

- `frame_seconds`: `Encoder.encode_sequence` of one frame, host clock,
  synchronised on both sides;
- `stages`: host clock around each stage of a frame with a
  `torch.cuda.synchronize()` on both sides (wave loop, reorder,
  binarize + compact, deblock, K1 + payload pull);
- `profile`: `torch.profiler` over one more frame: kernel launches in
  all and by stage (`launches_by_stage`: wave loop, reorder, binarize +
  compact, deblock, K1 + payload pull; the rest is the frame's upload,
  PSNR and bookkeeping), device busy seconds (the union of the device
  events' intervals), the ten kernels with the most device time
  (`top_kernels`: name, launches, seconds), the frame's seconds under the
  profiler;
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
import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

from tpu264_torch.coding import encoder as encoder_mod
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


@contextlib.contextmanager
def tagged_stages(enc: Encoder):
    """Within the block every stage of `enc`'s frame encode runs inside a
    `record_function` span named after the stage."""
    from torch.profiler import record_function

    def tag(name, fn):
        def tagged(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return tagged

    reorder = encoder_mod.reorder_wave_outputs
    encoder_mod.reorder_wave_outputs = tag("reorder", reorder)
    names = {"_encode_frame": "wave_loop",
             "_cabac_records": "binarize_compact",
             "_apply_deblock": "deblock", "_cabac_payloads": "k1_and_pull"}
    own = {a: vars(enc).get(a) for a in names}    # None: a method of the class
    for attr, name in names.items():
        setattr(enc, attr, tag(name, getattr(enc, attr)))
    try:
        yield sorted(names.values()) + ["reorder"]
    finally:
        encoder_mod.reorder_wave_outputs = reorder
        for attr, fn in own.items():
            if fn is None:
                delattr(enc, attr)
            else:
                setattr(enc, attr, fn)


def profiled_frame(enc: Encoder, frame) -> dict:
    """Launch counts of one frame, in all and by stage, and the card's
    busy time, from `torch.profiler`."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with tagged_stages(enc) as stages:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        with profile(activities=acts) as prof:
            enc.encode_sequence([frame])
            torch.cuda.synchronize()
        secs = time.monotonic() - t0
    spans: dict = {name: [] for name in stages}
    launch_at = []
    on_device = []              # (start, end) of every device event
    by_kernel: dict = {}        # name -> [events, microseconds]
    for e in prof.events():
        on_card = e.device_type == torch.autograd.DeviceType.CUDA
        if e.name in spans:
            # the profiler mirrors a `record_function` span onto the device
            # timeline, from its first kernel to its last: no device work
            if not on_card:
                spans[e.name].append((e.time_range.start, e.time_range.end))
        elif on_card:
            on_device.append((e.time_range.start, e.time_range.end))
            acc = by_kernel.setdefault(e.name, [0, 0.0])
            acc[0] += 1
            acc[1] += e.time_range.end - e.time_range.start
        elif e.name.startswith("cudaLaunchKernel"):
            launch_at.append(e.time_range.start)
    launch_at.sort()
    by_stage = {name: sum(bisect.bisect_right(launch_at, hi)
                          - bisect.bisect_left(launch_at, lo)
                          for lo, hi in ranges)
                for name, ranges in spans.items()}
    by_stage["other"] = len(launch_at) - sum(by_stage.values())
    busy_us, busy_until = 0.0, float("-inf")
    for lo, hi in sorted(on_device):
        busy_us += max(0.0, hi - max(lo, busy_until))
        busy_until = max(busy_until, hi)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:10]
    return {"frame_seconds_profiled": secs, "device_events": len(on_device),
            "device_busy_seconds": busy_us * 1e-6,
            "launches": len(launch_at), "launches_by_stage": by_stage,
            "top_kernels": [[name[:80], n, us * 1e-6]
                            for name, (n, us) in top]}


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
    res["profile"] = profiled_frame(enc, frames[1])
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

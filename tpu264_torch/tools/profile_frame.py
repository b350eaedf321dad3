"""Stage profile of one warm 720p frame on the card: an all-intra CABAC +
deblock frame (the default), or a P frame of an IPPP CAVLC + deblock
sequence (`--config ippp720`).

    python -m tpu264_torch.tools.profile_frame [--config intra720|ippp720]
                                               [--out FILE.json]

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
  (`top_kernels`: name, launches, seconds), the hand-written kernels
  among all (`own_kernels`), the frame's seconds under the profiler;
- `cabac`: records, bins (a kind-0 record counts its run, a bypass
  record its bits, a terminate 1) and payload bytes of the frame.

With `--config ippp720` the frame is the third of an IDR + P + P
sequence (full-search 16x16 ME with quarter-pel refinement, no
partitions, 4x4 transform), encoded against the second's reconstruction
by `Encoder.encode_p_frame`; the stages are upload, the half-pel planes,
the full search, the sub-pel refinement, the wave loop (the rest of the P
encoder), reorder, serialize + pack, deblock, and pull + NAL assembly;
`kernel_launches` gives the hand-written kernels' launches of the frame,
`stream` its bits and `idr_frame_seconds` a warm IDR frame of the same
encoder (CAVLC, pull and NAL assembly included).  There is no `cabac`
entry.

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
from tpu264_torch.kernels import interp as kint
from tpu264_torch.kernels import me as kme
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


def intra_patches(enc: Encoder) -> list:
    """(owner, attribute, stage) of every stage of an all-intra CABAC
    frame."""
    return [(encoder_mod, "reorder_wave_outputs", "reorder"),
            (enc, "_encode_frame", "wave_loop"),
            (enc, "_cabac_records", "binarize_compact"),
            (enc, "_apply_deblock", "deblock"),
            (enc, "_cabac_payloads", "k1_and_pull")]


# stages of a P frame that run inside `enc._encode_p` ("p_encode"): the
# wave loop is what is left of it
P_INNER = ("half_pel_planes", "me_full_search", "me_subpel")


def ippp_patches(enc: Encoder) -> list:
    """(owner, attribute, stage) of every stage of a P frame; the pull and
    NAL assembly run in the `finish` that `encode_p_frame` returns."""
    return [(encoder_mod, "reorder_wave_outputs", "reorder"),
            (enc, "_encode_p", "p_encode"),
            (kint, "luma_planes", "half_pel_planes"),
            (kme, "full_search_16x16", "me_full_search"),
            (kme, "subpel_refine", "me_subpel"),
            (enc, "_serialize", "serialize_pack"),
            (enc, "_recon", "deblock"),
            (encoder_mod, "_pull_words", "pull_nal"),
            (enc, "_cavlc_nalus", "pull_nal")]


@contextlib.contextmanager
def patched(patches: list, wrap):
    """Within the block each `owner.attribute` of `patches` is
    `wrap(stage, original)`."""
    saved = [(o, a, vars(o).get(a)) for o, a, _ in patches]
    for owner, attr, stage in patches:
        setattr(owner, attr, wrap(stage, getattr(owner, attr)))
    try:
        yield sorted({stage for _, _, stage in patches})
    finally:
        for owner, attr, fn in saved:
            if fn is None:              # a method of the instance's class
                delattr(owner, attr)
            else:
                setattr(owner, attr, fn)


def tagged_stages(patches: list):
    """Within the block every stage runs inside a `record_function` span
    named after it."""
    from torch.profiler import record_function

    def tag(name, fn):
        def tagged(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return tagged

    return patched(patches, tag)


def split_p_encode(by_stage: dict) -> dict:
    """{"p_encode": whole, inner stages...} -> the same with "wave_loop" =
    the P encoder less its inner stages, in place of "p_encode"."""
    out = dict(by_stage)
    out["wave_loop"] = out.pop("p_encode") - sum(out[k] for k in P_INNER)
    return out


def p_frame_job(enc: Encoder, frame, ref, frame_num: int = 2):
    """A callable that encodes `frame` as a P frame against `ref`, pull
    and NAL assembly included -> its NAL units."""
    def run():
        fin, _ = enc.encode_p_frame(*frame, ref, frame_num=frame_num)
        return fin()
    return run


def p_stage_times(enc: Encoder, job) -> dict:
    """One P frame with a synchronised host clock around every stage."""
    st: dict = {}

    def clocked(name, fn):
        def run(*args, **kw):
            with Clock(st, name):
                return fn(*args, **kw)
        return run

    with patched(ippp_patches(enc), clocked):
        with Clock(st, "frame"):
            job()
    st = split_p_encode(st)
    st["other"] = st.pop("frame") - sum(st.values())
    return st


def profiled_frame(patches: list, job) -> dict:
    """Launch counts of one frame (`job()` encodes it), in all and by
    stage, and the card's busy time, from `torch.profiler`."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with tagged_stages(patches) as stages:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        with profile(activities=acts) as prof:
            job()
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
    if "p_encode" in by_stage:
        by_stage = split_p_encode(by_stage)
    by_stage["other"] = len(launch_at) - sum(by_stage.values())
    busy_us, busy_until = 0.0, float("-inf")
    for lo, hi in sorted(on_device):
        busy_us += max(0.0, hi - max(lo, busy_until))
        busy_until = max(busy_until, hi)
    ranked = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])
    top = ranked[:10]
    # the hand-written kernels live in an anonymous namespace of their own
    own = [kv for kv in ranked if kv[0].startswith("(anonymous namespace)::")]
    return {"frame_seconds_profiled": secs, "device_events": len(on_device),
            "device_busy_seconds": busy_us * 1e-6,
            "launches": len(launch_at), "launches_by_stage": by_stage,
            "top_kernels": [[name[:80], n, us * 1e-6]
                            for name, (n, us) in top],
            "own_kernels": [[name[:80], n, us * 1e-6]
                            for name, (n, us) in own]}


def profile_intra(res: dict) -> None:
    cfg = EncoderConfig(width=W, height=H, qp=QP, symbol_mode="CABAC",
                        deblock=True)
    enc = Encoder(cfg)
    frames = [synth_frame(W, H, t) for t in range(2)]
    enc.encode_sequence(frames[:1])                 # cold: build + warm-up
    res.update(device=str(enc.device),
               config=f"{W}x{H} all-intra CABAC deblock QP {QP}")
    warm = {}
    with Clock(warm, "frame"):
        enc.encode_sequence(frames[1:])
    res["frame_seconds"] = warm["frame"]
    res["stages"], res["cabac"] = stage_times(enc, frames[1])
    res["profile"] = profiled_frame(
        intra_patches(enc), lambda: enc.encode_sequence([frames[1]]))


def profile_ippp(res: dict) -> None:
    from tpu264_torch.entropy import cabac_engine_cuda as k1
    from tpu264_torch.kernels import dct_quant as dq, deblock_wave as k4w, \
        i16_chroma_wave as k3w, i4x4_wave as k2w
    cfg = EncoderConfig(width=W, height=H, qp=QP, symbol_mode="CAVLC",
                        intra_period=0, deblock=True, inter_partitions=False,
                        transform_8x8=False)
    enc = Encoder(cfg)
    frames = [synth_frame(W, H, t) for t in range(3)]
    stream = enc.encode_sequence(frames)            # cold: build + warm-up
    res.update(device=str(enc.device),
               config=f"{W}x{H} IPPP CAVLC deblock QP {QP}, 16x16 partition, "
                      f"P frame 2 of IDR + P + P",
               cold_frame_seconds=[s.seconds for s in enc.stats],
               stream={"bytes": len(stream),
                       "frame_bits": [s.bits for s in enc.stats]})
    job = p_frame_job(enc, frames[2], enc.recons[1])
    counters = [k1.launches, k2w.launches, k3w.launches, k4w.launches,
                dq.launches]
    before = {k: v for c in counters for k, v in c.items()}
    warm = {}
    with Clock(warm, "frame"):
        nalus = job()
    res["frame_seconds"] = warm["frame"]
    res["kernel_launches"] = {k: v - before[k] for c in counters
                              for k, v in c.items()}
    if sum(8 * len(n) for n in nalus) != enc.stats[2].bits:
        raise SystemExit("the warm P frame differs from the sequence's")
    idr = {}
    with Clock(idr, "frame"):
        fin, _ = enc.encode_intra_frame(*frames[0])
        fin()
    res["idr_frame_seconds"] = idr["frame"]
    res["stages"] = p_stage_times(enc, job)
    res["profile"] = profiled_frame(ippp_patches(enc), job)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", choices=("intra720", "ippp720"),
                    default="intra720",
                    help="the frame to profile: all-intra CABAC (default) "
                         "or a P frame of IPPP CAVLC")
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
    res: dict = {"card": card, "torch": torch.__version__}
    if args.config == "ippp720":
        profile_ippp(res)
    else:
        profile_intra(res)
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

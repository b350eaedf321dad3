"""Stage profile of one warm frame on the card: a 720p all-intra CABAC +
deblock frame (the default), or a P frame of a 720p IPPP + deblock
sequence: CAVLC with the reference's default P tools (`--config ippp720`)
or without them (`--config ippp720_notools`), or CABAC with the default P
tools (`--config ippp720_cabac`), and with weighted prediction and SEI over
a fade (`--config ippp720_wp`); or a P frame of config 5 at 3840x2160
(`--config gop4k`); or a B frame of config 4 at 1920x1088
and its P anchor (`--config bgop1080`), or the same two frames through
the band-tiled encoder (`--config tiled1080 --tiles N`); or the decode of
config 3's two 720p frames by the port's decoder (`--config decode720`:
its deblocking stage on the card against host parse and reconstruction);
or a 1920x1088 all-intra CAVLC frame (`--config intra1080`, below).

    python -m tpu264_torch.tools.profile_frame
        [--config intra720|intra1080|ippp720|ippp720_notools|ippp720_cabac
                  |ippp720_wp|gop4k|bgop1080|tiled1080 [--tiles N]|decode720]
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
  compact or serialize + pack, deblock, K1 + payload pull; the rest is
  the frame's upload, PSNR and bookkeeping), the CAVLC serializer kernel
  KV's device seconds and launches (`kv_device_seconds`, `kv_launches`),
  device busy seconds (the union of
  the device events' intervals), the ten kernels with the most device time
  (`top_kernels`: name, launches, seconds), the hand-written kernels
  among all (`own_kernels`), the frame's seconds under the profiler;
- `cabac`: records, bins (a kind-0 record counts its run, a bypass
  record its bits, a terminate 1) and payload bytes of the frame.

With `--config ippp720` the frame is the third of an IDR + P + P
sequence (full-search ME with quarter-pel refinement of the MB, its
16x8/8x16 halves and its quadrants; P_L0_16x8, P_L0_8x16, P_8x8 and the
8x8 transform weighed in every MB), encoded against the second's
reconstruction by `Encoder.encode_p_frame`; `ippp720_notools` is the same
with the 16x16 partition and the 4x4 transform alone, `ippp720_cabac`
the default tools' frame with CABAC, `ippp720_wp` that frame with
explicit weighted prediction and SEI (the golden `ippp_720p_wp_sei`'s
encoder) over `fade_frames`, and `gop4k` the P frame of config 5's first
GOP at 3840x2160 (IDR + P, CABAC, the default tools) against the IDR
frame's reconstruction.  The stages are upload, the weights' estimate
("estimate_wp", with weighted prediction: the pull of the reference's
luma and the host's least squares), the pre-weighted reference
("weight_ref"), the half-pel planes (of the reference, and with weights
of the pre-weighted one), the full search, the sub-pel refinement, the
wave loop (the rest of the P encoder), reorder, serialize + pack
(CAVLC) or binarize + compact and K1 + payload pull (CABAC), deblock, and
pull + NAL assembly (CAVLC) or NAL assembly (CABAC); `kernel_launches`
gives the hand-written kernels' launches of the frame, `stream` its bits
(and each frame's weights) and `idr_frame_seconds` a warm IDR frame of
the same encoder (pull and NAL assembly included); with CABAC `cabac`
counts the P frame's records, bins and bytes as above.

With `--config bgop1080` the encoder is config 4 as `bench.py` builds it
(1920x1088, `num_b_frames=2`, CABAC, deblock, JVT-G012 rate control at
8 Mb/s) and the sequence is the 7 frames I, P, Bref, B, P, Bref, B in
coding order (display 0, 3, 1, 2, 6, 4, 5).  After the cold sequence the
last P anchor (display 6) and the last B frame (display 5, a
non-reference B that weighs partitions, against display 4 and 6) are
encoded again warm with the arguments the sequence gave them; each gets
the keys above under "p_anchor" and "b_frame" (the B frame's stages:
the half-pel planes of both references, the full search and the sub-pel
refinement of both lists, the wave loop (one KB launch), reorder, binarize +
compact, deblock, K1 + payload pull, NAL assembly).

With `--config tiled1080 --tiles N` the same sequence goes through
`TiledEncoder(cfg, mesh)` with N bands of 68 / N MB rows (`make_mesh(1,
gop=1)`, `bench.py`'s mesh, for one band; for more, N cards where there
are, else all N bands on the one card), and the warm P anchor and B frame
are the band steps of every band of those frames (`TiledEncoder._frame`
with the arguments the sequence gave it); the stages add "halo", the
reference rows each band takes from its neighbours.

With `--config intra1080` the encoder is the all-intra CAVLC path of
`bench.py:86-99` (`EncoderConfig(width=1920, height=1088, qp=28)`:
CAVLC, deblocking, one slice; `Encoder(cfg, intra_batch=B)`, B from
`TPU264_BATCH`, default 4), the counterpart of the reference's
`tools/profile_stages.py` and `tools/profile_ser.py`, under their names:
`stages` holds the warm seconds (mean of 3 synchronised calls) of the wave
loop ("wavefront_s"), "reorder_s", the CAVLC serializer and packer
("serialize_pack_s": kernel KV), "deblock_s",
the pull of the words ("pull_s") and the host NAL assembly
("host_nal_s"); `profile` the launches by stage and the device time of a
frame through the per-frame path, and `batched` the batched entry's
seconds a frame over one chunk of B frames (one launch each of K2, K3 and
K4 a wave for the chunk), its launches a frame, the card's idle share
and its own profile.

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
import os
import sys
import time

import numpy as np
import torch

from tpu264_torch.bits import nal
from tpu264_torch.bits.slicehdr import SLICE_I
from tpu264_torch.coding import encoder as encoder_mod
from tpu264_torch.coding import inter_frame, intra_frame
from tpu264_torch.coding.encoder import Encoder
from tpu264_torch.config import EncoderConfig
from tpu264_torch.entropy import cabac_binarize as cbz
from tpu264_torch.kernels import interp as kint
from tpu264_torch.kernels import me_search as kfs
from tpu264_torch.kernels import me_subpel as ksp
from tpu264_torch.media.synth import synth_frame
from tpu264_torch.tools.card import card_info

W, H, QP = 1280, 720, 28
BGOP_W, BGOP_H = 1920, 1088     # config 4 (`bench.py:56-58`)


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


def cabac_counts(recs, counts, payloads) -> dict:
    """Records, bins and payload bytes of a frame's first slice."""
    n = int(counts[0])
    kind, _, b = cbz.unpack_records(recs[0, :n].cpu().numpy())
    bins = int(np.where(kind == 0, b >> 1, np.where(kind == 1, b, 1)).sum())
    return {"records": n, "bins": bins,
            "ctx_bins": int((b >> 1)[kind == 0].sum()),
            "bypass_bins": int(b[kind == 1].sum()),
            "payload_bytes": sum(len(p) for p in payloads)}


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
        recs, counts = encoder_mod.cabac_records(enc.pic, mbd, "i",
                                                 enc._cabac_cap)
    with Clock(st, "deblock"):
        encoder_mod.recon_planes(enc._deblock, enc.pic, dev_out, mbd, QP)
    with Clock(st, "k1_and_pull"):
        payloads = encoder_mod.cabac_payloads(recs, counts, QP, "i",
                                              enc._cap_words)
    return st, cabac_counts(recs, counts, payloads)


def intra_patches(enc: Encoder) -> list:
    """(owner, attribute, stage) of every stage of an all-intra CABAC
    frame."""
    return [(encoder_mod, "reorder_wave_outputs", "reorder"),
            (enc, "_encode_frame", "wave_loop"),
            (encoder_mod, "cabac_records", "binarize_compact"),
            (encoder_mod, "recon_planes", "deblock"),
            (encoder_mod, "cabac_payloads", "k1_and_pull")]


# stages of a P or B frame that run inside `enc._encode_p` or
# `enc._encode_b` ("inter_encode"): the wave loop is what is left of it
P_INNER = ("weight_ref", "half_pel_planes", "me_full_search", "me_subpel")


def entropy_patches(cabac: bool) -> list:
    """(owner, attribute, stage) of the entropy stages and the in-loop
    filter of a picture (`coding/encoder.py`'s picture stages); the pull
    (K1 with CABAC) and NAL assembly run in a frame's `finish`."""
    if cabac:
        entropy = [(encoder_mod, "cabac_records", "binarize_compact"),
                   (encoder_mod, "cabac_payloads", "k1_and_pull"),
                   (encoder_mod, "cabac_nalus", "pull_nal")]
    else:
        entropy = [(encoder_mod, "serialize", "serialize_pack"),
                   (encoder_mod, "_pull_words", "pull_nal"),
                   (encoder_mod, "cavlc_nalus", "pull_nal")]
    return [(encoder_mod, "recon_planes", "deblock")] + entropy


def inter_patches(owner, inner: str) -> list:
    """(owner, attribute, stage) of the motion search stages inside the P
    or B encoder `owner.inner` ("inter_encode")."""
    return [(owner, inner, "inter_encode"),
            (inter_frame, "weight_luma", "weight_ref"),
            (kint, "luma_planes", "half_pel_planes"),
            (kfs, "full_search", "me_full_search"),
            (ksp, "subpel", "me_subpel")]


def ippp_patches(enc: Encoder, inner: str = "_encode_p") -> list:
    """(owner, attribute, stage) of every stage of a P frame (of a B frame
    with `inner="_encode_b"`)."""
    wp = [(enc, "_estimate_wp", "estimate_wp")] if enc.wp_mode else []
    return ([(encoder_mod, "reorder_wave_outputs", "reorder")] + wp
            + inter_patches(enc, inner) + entropy_patches(enc.cabac))


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
    """{"inter_encode": whole, inner stages...} -> the same with
    "wave_loop" = the P or B encoder less its inner stages, in place of
    "inter_encode"."""
    out = dict(by_stage)
    out["wave_loop"] = out.pop("inter_encode") - sum(out.get(k, 0)
                                                     for k in P_INNER)
    return out


def p_frame_job(enc: Encoder, frame, ref, frame_num: int = 2):
    """A callable that encodes `frame` as a P frame against `ref`, pull
    and NAL assembly included -> its NAL units."""
    def run():
        fin, _ = enc.encode_p_frame(*frame, ref, frame_num=frame_num)
        return fin()
    return run


def p_stage_times(patches: list, job) -> dict:
    """One P (or B) frame with a synchronised host clock around every
    stage of `patches`."""
    st: dict = {}

    def clocked(name, fn):
        def run(*args, **kw):
            with Clock(st, name):
                return fn(*args, **kw)
        return run

    with patched(patches, clocked):
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
    if "inter_encode" in by_stage:
        by_stage = split_p_encode(by_stage)
    by_stage["other"] = len(launch_at) - sum(by_stage.values())
    busy_us, busy_until = 0.0, float("-inf")
    for lo, hi in sorted(on_device):
        busy_us += max(0.0, hi - max(lo, busy_until))
        busy_until = max(busy_until, hi)
    ranked = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])
    top = ranked[:10]
    # the hand-written kernels live in an anonymous namespace of their own
    # (a template's name starts with its return type)
    own = [kv for kv in ranked
           if kv[0].startswith(("(anonymous namespace)::",
                                "void (anonymous namespace)::"))]
    return {"frame_seconds_profiled": secs, "device_events": len(on_device),
            # the CAVLC serializer kernel KV's passes (`kv_*`)
            "kv_device_seconds": sum(us for name, (_, us) in own
                                     if "::kv_" in name) * 1e-6,
            "kv_launches": sum(n for name, (n, _) in own
                               if "::kv_" in name),
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


def timed(fn, n: int = 3) -> tuple:
    """Mean host seconds of `n` warm calls of `fn()`, synchronised on both
    sides (one untimed call first) -> (seconds, the last result)."""
    out = fn()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(n):
        out = fn()
    torch.cuda.synchronize()
    return (time.monotonic() - t0) / n, out


def cavlc_intra_patches(enc: Encoder) -> list:
    """(owner, attribute, stage) of every stage of an all-intra CAVLC
    frame, under the reference's `tools/profile_stages.py` names."""
    return [(enc, "_encode_frame", "wavefront"),
            (encoder_mod, "reorder_wave_outputs", "reorder"),
            (encoder_mod, "serialize", "serialize_pack"),
            (encoder_mod, "recon_planes", "deblock"),
            (encoder_mod, "_pull_words", "host_nal"),
            (encoder_mod, "cavlc_nalus", "host_nal")]


def profile_intra1080(res: dict, batch: int) -> None:
    """The 1920x1088 all-intra CAVLC path of `bench.py:86-99`
    (`EncoderConfig(width=1920, height=1088, qp=28)`: CAVLC, deblocking,
    one slice; `Encoder(cfg, intra_batch=batch)`), the counterpart of the
    reference's `tools/profile_stages.py` and `profile_ser.py`: warm
    seconds of each stage of a frame, launches by stage and device time
    of a frame through the per-frame path, and the batched entry's
    seconds a frame, launches a frame and the card's idle share over one
    chunk of `batch` frames (one frame, the per-frame path, at 1)."""
    from tpu264_torch.kernels import deblock_wave as k4w, \
        i16_chroma_wave as k3w, i4x4_wave as k2w
    w, h = BGOP_W, BGOP_H
    cfg = EncoderConfig(width=w, height=h, qp=QP)
    enc = Encoder(cfg, intra_batch=batch)
    frames = [synth_frame(w, h, t) for t in range(batch)]
    cold = {}
    with Clock(cold, "frame"):                      # cold: build + warm-up
        enc.encode_sequence(frames[:1])
    res.update(device=str(enc.device),
               config=f"{w}x{h} all-intra CAVLC deblock QP {QP} "
                      f"(bench.py:86-99), intra_batch {batch}",
               cold_frame_seconds=cold["frame"])
    res["frame_seconds"], _ = timed(lambda: enc.encode_sequence(frames[:1]))
    counters = [k2w.launches, k3w.launches, k4w.launches]
    before = {k: v for c in counters for k, v in c.items()}
    stream = enc.encode_sequence(frames[:1])
    res["kernel_launches"] = {k: v - before[k] for c in counters
                              for k, v in c.items()}
    res["stream"] = {"bytes": len(stream), "frame_bits": enc.stats[-1].bits}
    pic = enc.pic
    y, u, v = (torch.as_tensor(np.asarray(p), device=enc.device)
               for p in frames[0])
    st: dict = {}
    st["wavefront_s"], (dev_out, ys) = timed(
        lambda: enc._encode_frame(y, u, v, QP))
    st["reorder_s"], mbd = timed(
        lambda: intra_frame.reorder_wave_outputs(enc.sched, ys))
    st["serialize_pack_s"], (words, nbits, _) = timed(
        lambda: encoder_mod.serialize(pic, mbd, "i", enc._cap_words))
    st["deblock_s"], _ = timed(
        lambda: encoder_mod.recon_planes(enc._deblock, pic, dev_out, mbd,
                                         QP))

    def pull():
        nbits_np = nbits.cpu().numpy()
        return encoder_mod._pull_words(words, nbits_np), nbits_np

    st["pull_s"], (words_np, nbits_np) = timed(pull)

    def host_nal():
        return encoder_mod.cavlc_nalus(
            pic, words_np, nbits_np, None,
            lambda s: enc._slice_header(s, SLICE_I, QP, frame_num=0,
                                        idr_pic_id=0, is_idr=True),
            3, nal.NAL_IDR)

    st["host_nal_s"], _ = timed(host_nal)
    res["stages"] = st
    res["nbits"] = nbits_np.tolist()
    res["profile"] = profiled_frame(
        cavlc_intra_patches(enc), lambda: enc.encode_sequence(frames[:1]))
    secs, _ = timed(lambda: enc.encode_sequence(frames), n=2)
    prof = profiled_frame(cavlc_intra_patches(enc),
                          lambda: enc.encode_sequence(frames))
    res["batched"] = {
        "batch": batch, "seconds_per_frame": secs / batch,
        "frames_per_second": batch / secs,
        "launches_per_frame": prof["launches"] / batch,
        # the card's idle share of the warm (unprofiled) chunk
        "idle_share": 1 - prof["device_busy_seconds"] / secs,
        "profile": prof}


def profile_decode(res: dict) -> None:
    """Config 3's two 720p frames (encoded here) decoded by `Decoder()` on
    the card, warm: the deblocking stage (`_deblock_picture`: uploads, bS
    maps, K4 a wave, the pull) against the rest (host parse and
    reconstruction)."""
    from tpu264_torch.decode import Decoder
    cfg = EncoderConfig(width=W, height=H, qp=QP, symbol_mode="CABAC",
                        deblock=True)
    stream = Encoder(cfg).encode_sequence(
        [synth_frame(W, H, t) for t in range(2)])
    Decoder().decode(stream)                   # cold: warm-up
    res.update(device="cuda", config=f"decode of {W}x{H} all-intra CABAC "
                                     f"deblock QP {QP}, 2 frames")
    st: dict = {}
    real = Decoder._deblock_picture

    def clocked(self, pic):
        with Clock(st, "deblock"):
            real(self, pic)

    with patched([(Decoder, "_deblock_picture", "deblock")],
                 lambda stage, fn: clocked):
        with Clock(st, "decode"):
            Decoder().decode(stream)
    st["parse_recon"] = st.pop("decode") - st["deblock"]
    res["stages"] = st
    res["frame_seconds"] = (st["parse_recon"] + st["deblock"]) / 2
    res["profile"] = profiled_frame(
        [(Decoder, "_deblock_picture", "deblock")],
        lambda: Decoder().decode(stream))


def profile_ippp(res: dict, tools: bool, symbol_mode: str, w: int = W,
                 h: int = H, weighted: bool = False,
                 intra_period: int = 0) -> None:
    """A warm P frame: the last of IDR + P + P (`intra_period=2`: of IDR +
    P), against the reconstruction before it."""
    from tpu264_torch.entropy import cabac_engine_cuda as k1
    from tpu264_torch.kernels import dct_quant as dq, deblock_wave as k4w, \
        i16_chroma_wave as k3w, i4x4_wave as k2w, p_wave as kp
    from tpu264_torch.tools.synth_inputs import fade_frames
    off = {} if tools else dict(inter_partitions=False, transform_8x8=False)
    cfg = EncoderConfig(width=w, height=h, qp=QP, symbol_mode=symbol_mode,
                        intra_period=intra_period, deblock=True,
                        weighted_pred=weighted, sei_messages=weighted, **off)
    enc = Encoder(cfg)
    n = 2 if intra_period == 2 else 3
    frames = (fade_frames(w, h, n) if weighted
              else [synth_frame(w, h, t) for t in range(n)])
    stream = enc.encode_sequence(frames)            # cold: build + warm-up
    what = ("16x8/8x16, P_8x8, 8x8 transform" if tools
            else "16x16 partition, 4x4 transform")
    if weighted:
        what += ", weighted prediction and SEI over a fade"
    res.update(device=str(enc.device),
               config=f"{w}x{h} IPPP {symbol_mode} deblock QP {QP}, {what}, "
                      f"P frame {n - 1} of IDR" + " + P" * (n - 1),
               cold_frame_seconds=[s.seconds for s in enc.stats],
               stream={"bytes": len(stream),
                       "frame_bits": [s.bits for s in enc.stats],
                       "frame_wp": [s.wp for s in enc.stats]})
    job = p_frame_job(enc, frames[n - 1], enc.recons[n - 2], n - 1)
    counters = [k1.launches, k2w.launches, k3w.launches, kp.launches,
                k4w.launches, dq.launches, kfs.launches, ksp.launches]
    kept = {}                   # the warm frame's CABAC records

    def keep(stage, fn):
        def run(*a, **kw):
            kept[stage] = fn(*a, **kw)
            return kept[stage]
        return run

    before = {k: v for c in counters for k, v in c.items()}
    warm = {}
    with patched([(encoder_mod, "cabac_records", "records")], keep):
        with Clock(warm, "frame"):
            nalus = job()
    res["frame_seconds"] = warm["frame"]
    res["kernel_launches"] = {k: v - before[k] for c in counters
                              for k, v in c.items()}
    if sum(8 * len(b) for b in nalus) != enc.stats[n - 1].bits:
        raise SystemExit("the warm P frame differs from the sequence's")
    idr = {}
    with Clock(idr, "frame"):
        fin, _ = enc.encode_intra_frame(*frames[0])
        fin()
    res["idr_frame_seconds"] = idr["frame"]
    res["stages"] = p_stage_times(ippp_patches(enc), job)
    res["profile"] = profiled_frame(ippp_patches(enc), job)
    if enc.cabac:
        recs, counts = kept["records"]
        res["cabac"] = cabac_counts(
            recs, counts, encoder_mod.cabac_payloads(recs, counts, QP, "p",
                                                     enc._cap_words))


def profile_bgop(res: dict) -> None:
    """Config 4 at 1920x1088: the cold 7-frame sequence, then its last P
    anchor and its last B frame warm."""
    from tpu264_torch.entropy import cabac_engine_cuda as k1
    from tpu264_torch.kernels import b_wave as kb, deblock_wave as k4w, \
        i16_chroma_wave as k3w, i4x4_wave as k2w, p_wave as kp
    w, h = BGOP_W, BGOP_H
    cfg = EncoderConfig(width=w, height=h, qp=QP, intra_period=0,
                        num_b_frames=2, symbol_mode="CABAC", deblock=True,
                        rate_control=True, bitrate=8_000_000)
    enc = Encoder(cfg)
    frames = [synth_frame(w, h, t) for t in range(7)]
    calls = {}                  # the sequence's arguments of each frame
    for attr in ("encode_p_frame", "encode_b_frame"):
        def spy(*a, _fn=getattr(enc, attr), _attr=attr, **kw):
            calls.setdefault(_attr, []).append((a, kw))
            return _fn(*a, **kw)
        setattr(enc, attr, spy)
    t0 = time.monotonic()
    stream = enc.encode_sequence(frames)            # cold: build + warm-up
    torch.cuda.synchronize()
    res.update(device=str(enc.device),
               config=f"{w}x{h} hierarchical B (num_b_frames=2) CABAC "
                      f"deblock, rate control 8 Mb/s (config 4)",
               cold_sequence_seconds=time.monotonic() - t0,
               cold_frames=[[s.frame, s.slice_type, s.qp, s.bits, s.seconds]
                            for s in enc.stats],
               stream={"bytes": len(stream),
                        "frame_bits": [s.bits for s in enc.stats]})
    for attr in ("encode_p_frame", "encode_b_frame"):
        delattr(enc, attr)
    counters = [k1.launches, k2w.launches, k3w.launches, kp.launches,
                kb.launches, k4w.launches, kfs.launches, ksp.launches]
    kept = {}

    def keep(stage, fn):
        def run(*a, **kw):
            kept[stage] = fn(*a, **kw)
            return kept[stage]
        return run

    for key, attr, inner, disp in (("p_anchor", "encode_p_frame",
                                    "_encode_p", 6),
                                   ("b_frame", "encode_b_frame",
                                    "_encode_b", 5)):
        a, kw = calls[attr][-1]

        def job(a=a, kw=kw, attr=attr):
            fin, _ = getattr(enc, attr)(*a, **kw)
            return fin()

        out = {"display": disp, "qp": kw["qp"]}
        before = {k: v for c in counters for k, v in c.items()}
        warm = {}
        with patched([(encoder_mod, "cabac_records", "records")], keep):
            with Clock(warm, "frame"):
                nalus = job()
        out["frame_seconds"] = warm["frame"]
        out["kernel_launches"] = {k: v - before[k] for c in counters
                                  for k, v in c.items()}
        if sum(8 * len(n) for n in nalus) != enc.stats[disp].bits:
            raise SystemExit(f"the warm {key} differs from the sequence's")
        out["stages"] = p_stage_times(ippp_patches(enc, inner), job)
        out["profile"] = profiled_frame(ippp_patches(enc, inner), job)
        recs, counts = kept["records"]
        out["cabac"] = cabac_counts(
            recs, counts, encoder_mod.cabac_payloads(
                recs, counts, kw["qp"], key[0], enc._cap_words))
        res[key] = out


def tiled_patches(te, inner: str) -> list:
    """(owner, attribute, stage) of every stage of a P (`inner="_enc_p"`)
    or B (`"_enc_b"`) frame of the tiled encoder, all bands together: the
    band halos ("halo"), the motion search and wave loop, reorder, the
    entropy stages and the in-loop filter."""
    from tpu264_torch.runtime import tiled
    return ([(tiled, "reorder_wave_outputs", "reorder"),
             (tiled, "band_refs", "halo")]
            + inter_patches(te, inner) + entropy_patches(te.cabac))


def profile_tiled(res: dict, n_tiles: int) -> None:
    """Config 4 at 1920x1088 through `TiledEncoder` with `n_tiles` bands
    (over that many cards where there are, else all on the one card): the
    cold 7-frame sequence, then its last P anchor and its last B frame
    warm, every band of the frame."""
    from tpu264_torch.entropy import cabac_engine_cuda as k1
    from tpu264_torch.kernels import b_wave as kb, deblock_wave as k4w, \
        i16_chroma_wave as k3w, i4x4_wave as k2w, p_wave as kp
    from tpu264_torch.runtime.tiled import TiledEncoder, make_mesh
    w, h = BGOP_W, BGOP_H
    cfg = EncoderConfig(width=w, height=h, qp=QP, intra_period=0,
                        num_b_frames=2, symbol_mode="CABAC", deblock=True,
                        rate_control=True, bitrate=8_000_000)
    if n_tiles == 1 or torch.cuda.device_count() >= n_tiles:
        mesh = make_mesh(n_tiles, gop=1)
    else:
        mesh = make_mesh(n_tiles, gop=1,
                         devices=[torch.device("cuda", 0)] * n_tiles)
    te = TiledEncoder(cfg, mesh)
    frames = [synth_frame(w, h, t) for t in range(7)]
    calls = []                  # the sequence's arguments of each frame
    frame = te._frame

    def spy(*a, **kw):
        calls.append((a, dict(kw)))
        return frame(*a, **kw)

    te._frame = spy
    t0 = time.monotonic()
    (stream,) = te.encode_sequence([frames])        # cold: build + warm-up
    torch.cuda.synchronize()
    del te._frame
    res.update(device=[str(d) for d in te.mesh.devices[0]],
               config=f"{w}x{h} hierarchical B (num_b_frames=2) CABAC "
                      f"deblock, rate control 8 Mb/s (config 4), "
                      f"TiledEncoder with {n_tiles} band(s) of "
                      f"{te.band_hm} MB rows",
               cold_sequence_seconds=time.monotonic() - t0,
               cold_frames=[[s.frame, s.slice_type, s.qp, s.bits, s.seconds]
                            for s in te.stats[0]],
               stream={"bytes": len(stream),
                       "frame_bits": [s.bits for s in te.stats[0]]})
    counters = [k1.launches, k2w.launches, k3w.launches, kp.launches,
                kb.launches, k4w.launches, kfs.launches, ksp.launches]
    # coding order I 0, P 3, Bref 1, B 2, P 6, Bref 4, B 5
    for key, pos, inner, disp in (("p_anchor", 4, "_enc_p", 6),
                                  ("b_frame", 6, "_enc_b", 5)):
        a, kw = calls[pos]

        def job(a=a, kw=kw):
            return te._frame(*a, **dict(kw))

        out = {"display": disp, "qp": int(a[2][0])}
        before = {k: v for c in counters for k, v in c.items()}
        warm = {}
        with Clock(warm, "frame"):
            coded = job()
        out["frame_seconds"] = warm["frame"]
        out["kernel_launches"] = {k: v - before[k] for c in counters
                                  for k, v in c.items()}
        if sum(8 * len(n) for n in coded[0][0]) != te.stats[0][disp].bits:
            raise SystemExit(f"the warm {key} differs from the sequence's")
        patches = tiled_patches(te, inner)
        out["stages"] = p_stage_times(patches, job)
        out["profile"] = profiled_frame(patches, job)
        res[key] = out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config",
                    choices=("intra720", "intra1080", "ippp720",
                             "ippp720_notools", "ippp720_cabac",
                             "ippp720_wp", "gop4k", "bgop1080", "tiled1080",
                             "decode720"),
                    default="intra720",
                    help="the frame to profile: all-intra CABAC (default) "
                         "or a P frame of IPPP CAVLC, with the default P "
                         "tools or without them, or of IPPP CABAC with "
                         "them, and with weighted prediction over a fade; "
                         "or config 5's P frame at 3840x2160; or config "
                         "4's B frame and P anchor at "
                         "1920x1088, through Encoder or (tiled1080) "
                         "TiledEncoder; or (decode720) the decode of "
                         "config 3's two 720p frames; or (intra1080) the "
                         "1920x1088 all-intra CAVLC path of bench.py, "
                         "stage by stage and through the batched entry "
                         "(TPU264_BATCH frames, default 4)")
    ap.add_argument("--tiles", type=int, default=1,
                    help="bands of --config tiled1080 (default 1)")
    ap.add_argument("--out", help="also write the JSON object to this file")
    ap.add_argument("--k1-stages", action="store_true",
                    help="build with -DK1_PROFILE: the CABAC coder prints "
                         "the busy cycles of its stages at every launch")
    return ap


def main() -> int:
    args = build_parser().parse_args()
    if not torch.cuda.is_available():
        print("profile_frame needs a CUDA card", file=sys.stderr)
        return 1
    info = card_info()
    if args.k1_stages:
        from tpu264_torch.kernels import _build
        _build.NVCC_FLAGS.append("-DK1_PROFILE")
    res: dict = {"card": info["card"], "torch": info["torch"]}
    if args.config == "bgop1080":
        profile_bgop(res)
    elif args.config == "tiled1080":
        profile_tiled(res, args.tiles)
    elif args.config == "decode720":
        profile_decode(res)
    elif args.config == "intra1080":
        profile_intra1080(res, int(os.environ.get("TPU264_BATCH", "4")))
    elif args.config == "ippp720_wp":
        profile_ippp(res, tools=True, symbol_mode="CABAC", weighted=True)
    elif args.config == "gop4k":
        profile_ippp(res, tools=True, symbol_mode="CABAC", w=3840, h=2160,
                     intra_period=2)
    elif args.config.startswith("ippp720"):
        profile_ippp(res, tools=args.config != "ippp720_notools",
                     symbol_mode=("CABAC" if args.config == "ippp720_cabac"
                                  else "CAVLC"))
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

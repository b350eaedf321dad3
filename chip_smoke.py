"""Smoke run of the PyTorch/CUDA port (`tpu264_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, before the result line):
 1. print the card (`nvidia-smi` name, power limit) and the torch / CUDA
    versions; refuse to run without CUDA;
 2. build the CUDA kernel library from `tpu264_torch/csrc` (timed);
 3. hold each kernel (KR CABAC binarize + compact, K1 CABAC engine, K2
    I4x4 wave body of I pictures, K3 I16x16 + chroma wave body, KP P
    wave body and KB B wave body (one launch a picture each, the
    Intra4x4 search inside), K4 deblock wave, and the entries on slabs:
    DCT + quant, DCT, luma deblock lines) to its
    plain torch version on the card, at the shapes of the main paths and
    on seeded corner cases, with exact equality, and time both; K1 on the
    records of a 720p I frame and of a 720p P frame with the default P
    tools (init table 1), 1 and 3 slices, and of a 1920x1088 B frame; KP
    on whole 720p P pictures and on their widest waves (a picture of one
    wave) with and without the reference's default P tools (16x8/8x16,
    P_8x8, the 8x8 transform), and on seeded waves where every partition
    type and both transforms are chosen; KB on whole 1920x1088 B pictures
    of config 4 with and without partitions and on their widest waves (60
    lanes), on seeded waves of that width (every btype, every partition
    shape with every (c0, c1)) at QP 0, 28 and 51, `allow_parts` on and
    off, and on a B picture of a 17-row band; K4 also on that B frame
    (two-list bS); KP with explicit weights (64, 0), (58, -7) and (71, 12)
    on seeded waves whose source is faded by them, the P tools off and on,
    and on the first P picture of `ippp_720p_wp_sei` and its widest wave
    as its encode runs them; K4 as the decoder runs it,
    on seeded 1280x720 and 1920x1088 pictures with per-MB QP grids over
    0-51, filter offsets, idc 2 slice edges in the middle of MB rows, t8
    MBs and two-list motion; KF and KS (motion estimation's integer full
    search and sub-pel refinement, one launch each a list) on every list
    that those P and B pictures search (the 720p P pictures without and
    with the tools: one and nine blocks; the weighted golden's pre-weighted
    reference; both lists of the 1080p B pictures, with the partitions'
    five blocks and with the MB alone; both lists of the band's B
    picture) and on seeded 720p pictures at the ME lambdas of QP 0, 28 and
    51, flat ones (every cost tied) and 0/255 checkerboards (the extremes
    of the SSD and the SATD), KS also from full-pel vectors forced to +-16
    on the border macroblocks of a 720p picture and of the band (the
    edges of its staged windows); K2, K3 and K4 as the batched all-intra
    entry runs them, one launch a wave for a chunk of 4 and of 3 pictures
    at 1920x1088 (`check_batched_intra`); KR (four launches a picture, its
    mvd and most-probable-mode inputs derived in its state pass, with
    KD's device code `mb_preds.cuh`, and held to their plain version too)
    on every CABAC picture those cases make (the
    720p I and P frames, 1 and 3 slices; the weighted golden's I and P
    pictures; the 1080p B pictures with and without partitions), each
    also cut into 3 slices, and on dense QP-0-like I, P and B pictures
    whose slices are over the encoders' record cap; then the queue half
    of a CABAC P and a B picture (`queue_entropy`) under sync debug mode
    "error", and a CIF IPPP CABAC encode and one band of `TiledEncoder`
    at a cap of one record a MB, whose emits into wider rows run after
    the next frame's work is queued, against the streams at the default
    cap (`check_kr`); KV (CAVLC serialize + pack, two launches a picture:
    the state pass, which derives the mvds and most probable modes with
    KD's device code, held to `preds_plain`, and the slices pass) on the
    same MB dicts, each also cut into 3 slices, and on dense QP-0-like I,
    P and B pictures at the encoders' word cap, which every slice is over
    (`check_kv`); with `TPU264_KV_PARENT` naming another tree (a `git
    archive` of the parent under `build/`), KV of both trees timed on the
    same MB dicts, parent, this, this, parent (`kv_parent_times`);
 4. config 3: encode two 1280x720 frames (all-intra, CABAC, deblock, QP
    28) through `Encoder(cfg).encode_sequence` (the default device is the
    card), check that every kernel of the path was launched (K2 once a
    wave, K3 and K4 at most once a wave, KP, KF, KS and the slab entries
    never),
    and hold the stream's SHA-256 to `tests/data/torch_golden.json` (made
    by the JAX reference encoder);
 5. config 1: five QCIF frames, all-intra CAVLC, through the batched
    entry (a chunk launches K2, K3 and K4 once a wave, as a frame of the
    per-frame path does); the SHA-256 equals the per-frame path's on the
    card and the golden; then `bench.py:86-99`'s all-intra frame at
    1920x1088, six frames through the batched entry (chunks of 4 and 2,
    254 launches each of K2, K3 and K4 a chunk) and the per-frame path,
    both against the golden `intra1080_cavlc_batched`, and both warm in
    one call (seconds a frame); the same frames with a slice a MB row (68
    slices, 272 in a chunk of 4) through both, the streams equal, KV once
    a chunk and its derived modes equal their plain version's; KV (with
    its KD derivation) once a chunk or frame throughout, and KV held to
    its plain version (`check_kv`)
    on every CAVLC picture, band and chunk of phases 5-8 and 8b (config 1,
    `intra1080` with 1 and 68 slices, config 2, IPPP at 720p without and
    with the tools, config 2 at `bench.py`'s settings), each one-slice
    picture also cut into 3 (1088 rows: 4) slices, and timed on the
    batched chunk of four 1080p pictures, a 1080p picture, the 720p P
    pictures and (phase 3) the 1080p B picture;
 6. config 2: CIF IPPP CAVLC (1 IDR + 2 P, deblock, full-search and
    quarter-pel ME, no partitions) against its golden;
 7. IPPP at 720p: the same at 1280x720 against its golden, with the
    launches of every frame asserted: a P frame runs KP, KF and KS once,
    K4 at most once a wave, and K1, K2's and K3's wave forms and the slab
    entries never (an IDR frame K2 once a wave, KF and KS never);
 8. config 2 at `bench.py`'s settings (CIF, QP 28, the default P tools,
    1 IDR + 3 P) and IPPP at 720p with the default P tools (1 IDR + 2 P),
    each against its golden with the launches of every frame asserted as
    in 7;
 8b. QCIF IPPP CAVLC through `TiledEncoder` with three bands on the card,
    equal to the same run on the CPU, KV (with KD's derivation) once a
    band picture;
 9. IPPP with CABAC at 720p (the default P tools, 1 IDR + 2 P) against its
    golden, the launches of every frame asserted as in 7 but with K1 once
    a frame; and at CIF with JVT-G012 rate control at 1 Mb/s (1 IDR + 5
    P) against its golden and the reference's per-frame QPs;
    config 4 (`bench.py:56-58, 69-72`): 7 frames at 1920x1088, hierarchical
    B (`num_b_frames=2`), CABAC, deblock, rate control at 8 Mb/s, through
    `Encoder(cfg)`, against its golden (`bgop_1080p_cabac_rc`) and its
    per-frame QPs, every frame's launches asserted: a B frame runs KB
    once, KF and KS twice (two lists), K4 at most once a wave and K1
    once, never KP or K2's or K3's wave forms;
10. config 4 through `TiledEncoder` (the band-tiled encoder, `bench.py`'s
    headline path): one band over `make_mesh(1, gop=1)` as `bench.py:75`
    builds it, and four bands of 17 MB rows on the one card (over four
    cards where there are), each against its golden from the reference's
    `TiledEncoder` on the same mesh shape (`tiled_bgop_1080p_cabac_rc`,
    `tiled4_bgop_1080p_cabac_rc`: SHA-256, frame sizes and QPs), every
    frame's launches asserted per band (KP or KB once a band, KF and KS
    once a list of a band, K4 at most once a wave, K1 once a band
    picture, K2 and K3 on the I frame only),
    and the warm frames/s of `Encoder` and of `TiledEncoder` on the
    same frames printed side by side;
11. IPPP CABAC at 720p with weighted prediction and SEI over five frames
    of a fade (`ippp_720p_wp_sei`) against its golden, with every P
    frame's (weight, offset) and the launches of every frame asserted as in
    9, and the weights engaged (not all (64, 0));
12. config 5 (`config5_4k_gop`): IPPP CABAC at 3840x2160, `intra_period=2`,
    4 frames (two closed GOPs) through the port's `runtime.gop_scheduler`,
    one simulated host (every frame's launches asserted) and two, both
    gathered streams equal to each other and the golden; then
    `scaling_harness` at 1 and 2 simulated hosts on the one card prints
    each host's seconds and the efficiency beside the card;
13. one CIF P frame's `make_inter_encoder` output on the card against
    the same call on the CPU, every key, tolerance 0, without and with the
    default P tools;
14. the port's decoder on the card (`Decoder()`: host parse and
    reconstruction, the in-loop deblocking through K4): config 2,
    `ippp_cif_cabac_rc`, config 3's two 720p frames and a CIF
    hierarchical-B GOP with config 4's settings (encoded in this phase)
    decode to their encoder's recons frame for frame, K4 at most once a
    wave in every picture and no other kernel; decode seconds a frame, ms
    a MB and the deblocking stage's time on the card (and of its plain
    version on the CPU) printed; an x264 stream with per-MB QPs and
    filter offsets decodes on the card to the CPU decoder's frames;
15. `tpu264_torch.runtime.dryrun.entry("cuda")`: one QCIF all-intra
    CAVLC frame equal to `entry("cpu")`'s, stream and recon;
16. the dry run, `dryrun_multichip(4, devices=["cuda"] * 4)`: config
    4's tools (hierarchical B, CABAC, rate control at 2 Mb/s, deblock,
    halos) at 1280 x 128 over 2 lanes x 2 bands on the one card, 5 frames
    a lane, each lane's stream decoded on the card to the encoder's
    recons, each lane held to the golden `dryrun_multichip_4` (SHA-256,
    frame sizes and QPs); encode and decode seconds printed.

The line before the last is a JSON object with one entry per kernel
(`launches`: the sum over the four 720p main paths, config 4 and its two
tiled paths, the weighted 720p path, config 5, the decode, `entry`, the
dry run, the batched 1080p all-intra path and the tiled QCIF CAVLC path,
phases 4, 5, 7, 8, 8b, 9, 10, 11, 12, 14, 15 and 16, each driven
with the counts set to 0 just before and read just after;
`launches_by_path` splits it; KP's `ms`, `plain_ms` and `bound_ms` are
a 720p P picture of the default P tools (one launch; `waves` of them,
`ms_wave` a wave), `ms_one_wave` a picture of its widest wave alone (the
wrapper's host time included), `ms_tools_off` a picture without the
tools, `ms_weighted` (with `ms_wave_weighted`, `plain_ms_weighted` and
`bound_ms_weighted`) the weighted golden's first P picture, and
`weighted` lists the weighted cases with their max abs err; KB's the
1080p B picture that allows partitions (`lanes` its widest wave's), and
`ms_band`, `plain_ms_band` a 17-row band's B picture; K1's `ms`, `bins` and
bound are the 720p P frame's, `ms_i_frame` and `bins_i_frame` the I
frame's, `ms_b_1080p` and `bins_b_1080p` the 1080p B frame's; K4's
`ms_1080p` a wave of the 1080p B frame, `ms_grids_720p` and
`ms_grids_1080p` (with their `plain_ms_grids_*` and `bound_ms_grids_*`)
a wave of the seeded decoder pictures; KF's and KS's the 1080p B
picture's list 0 with the partitions, `ms_720p_p` (with `plain_ms_720p_p`,
`bound_ms_720p_p`) the 720p P picture with the tools and `ms_band` (with
`plain_ms_band`, `bound_ms_band`) the band's list 0; K2's, K3's and K4's
`ms_chunk4` (with `plain_ms_chunk4`, `bound_ms_chunk4`) a wave of a
chunk of four 1920x1088 pictures in one launch, and K2's and K3's
`ms_one_picture` that wave of one of them); KR's `ms`, `plain_ms`,
`bound_ms` are the 1080p B picture that allows partitions, one call of
`records` (the host's wait for the largest count included; `ms_queue`
the queue half alone, back to back; `host_ms_queue` the host's time in
the queue half alone, its host half outside the clock, as the encoders
run it), with `device_ms` its four kernels
under `torch.profiler`, `kernel_launches` their launches, `ms_inputs`
the plain version of its derived inputs, `records` its count, and
`ms_720p_i`, `ms_720p_p`, `ms_weighted` (with their `plain_ms_*`,
`bound_ms_*`, `device_ms_*`) the other pictures; KV's `ms`, `plain_ms`,
`bound_ms` and `device_ms` (its two kernels under the profiler,
`device_ms_by_kernel` each alone) are the batched chunk of four
1920x1088 pictures (one slice each), with `bits` its bit count and
`*_1080p_i` one such picture, `*_720p_p` and `*_720p_p_tools_off` the
720p P pictures of IPPP with and without the default P tools,
`*_b_1080p` the 1080p B picture (and, with `TPU264_KV_PARENT`,
`parent_and_this`: both trees' `tools/time_kv.py` results); KD's `ms` is
the device ms of KV's state pass, which holds its derivation, at the
1080p B picture (`*_chunk4`, `*_1080p_i`, `*_720p_p*` the others),
`plain_ms` the plain version `preds_plain`; the last line is
{"ok": true, "device": {...}}.

`bound_ms` of a kernel is the larger of its bytes (each input read once,
each output written once) over 3.35 TB/s and its integer operations over
the card's int32 issue rate (132 SMs x 64 int32 lanes x 1.98 GHz, about
16.7 TOP/s; the data sheet's 67 TFLOP/s counts a float32 multiply-add
on 128 lanes as two), both counted from this run's inputs; KP and KB
read of their references the distinct samples that the run's vectors
and decisions need (`distinct_reference_samples`).  Every row keeps
both halves too (`bytes_ms`, `operations_ms`).  K1 to K4,
KP and KB are bound by neither but by a chain of dependent steps, which
`PERF.md` models; K1's row also carries `bins`, counted from this run's
records.  KR is bound by its bytes (`kr_bound`: the MB dict's tensors
that it reads, the motion keys and modes of its derived inputs included,
and the records that it produces; K1 reads none of the rows' zeros), KD
(the derivation inside KV's state pass) by its bytes (`kd_bound`), KV by
its bytes (`kv_bound`: the MB dict's tensors that it reads, the motion
keys of the derivation included, and the words that hold the slices'
bits, the bit counts and the skip map written).
`library_ms` is null throughout: no single PyTorch call computes a CABAC
binarizer, CAVLC, an H.264 mv predictor or most probable mode, a CABAC coder,
an H.264 intra search, the H.264 integer transform with its
quantiser, the deblocking filter, the quadrant SSD maps of a full search
with the first-minimum argmin, or a SATD sub-pel search.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
W, H, QP = 1280, 720, 28

# count key -> (name, source, TPU kernel it replaces, on the all-intra
# CABAC path (config 3); the IPPP paths' launches are asserted frame by
# frame in `phase_ippp`)
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
    # K2's and K3's functions in the P wave body (the Intra4x4 search and
    # the inter residual; the I16x16, intra and inter chroma residuals),
    # one launch a P picture
    "KP": ("p_frame", "tpu264_torch/csrc/p_wave.cu",
           "tpu264/kernels/pallas_kernels.py:55,66", False),
    # and in the B wave body, one launch a B picture
    "KB": ("b_frame", "tpu264_torch/csrc/b_wave.cu",
           "tpu264/kernels/pallas_kernels.py:55,66", False),
    # motion estimation, jnp in the reference: the integer full search and
    # the sub-pel refinement, one launch each a list of a P or B picture
    "KF": ("me_search", "tpu264_torch/csrc/me_search.cu",
           "none: jnp tpu264/kernels/me.py:34,88,156", False),
    "KS": ("me_subpel", "tpu264_torch/csrc/me_subpel.cu",
           "none: jnp tpu264/kernels/me.py:214", False),
    # CABAC binarize + compact, jnp in the reference: one call (four
    # launches) a CABAC picture, its mvd and most-probable-mode inputs
    # derived inside
    "KR": ("cabac_records", "tpu264_torch/csrc/cabac_records.cu",
           "none: jnp tpu264/entropy/cabac_binarize_j.py:241,839", True),
    # the mvds and most probable modes of a CAVLC picture, jnp in the
    # reference: device code shared with KR's state pass, run inside KV's
    # state pass (its first launch), once a CAVLC picture, band or chunk
    "KD": ("mb_preds", "tpu264_torch/csrc/mb_preds.cuh",
           "none: jnp tpu264/entropy/device_cavlc.py:258,527,650", False),
    # CAVLC serialize + pack, jnp in the reference: one run (two
    # launches, the state pass with KD's derivation and the slices pass)
    # a CAVLC picture, band or batched chunk
    "KV": ("cavlc_slices", "tpu264_torch/csrc/cavlc_slices.cu",
           "none: jnp tpu264/entropy/device_cavlc.py:88,373,669,819,985",
           False),
}
BW, BH = 1920, 1088             # config 4 (`bench.py:56-58`)
# streams the decode phase decodes: golden name -> (stream, the encoder's
# recons in display order), kept as the encode phases make them
DECODED_GOLDENS = ("config2_cif", "ippp_cif_cabac_rc")
ENCODED: dict = {}
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
INT_OPS_PER_S = 132 * 64 * 1.98e9   # SMs x int32 lanes x boost clock
INT8_MMA_OPS_PER_S = 1.979e15   # H100 SXM data sheet, int8 tensor cores, dense


def bound(n_bytes: float, n_ops: float, mma_ops: float = 0.0) -> dict:
    """Least time for the work: bytes over the memory rate, int32
    operations over the int32 lanes' peak or u8 products (a multiply and
    an add each) over the int8 tensor cores' peak, whichever is largest
    (each kept in the row; the pipes run side by side)."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / INT_OPS_PER_S
    t_m = mma_ops / INT8_MMA_OPS_PER_S
    row = {"bound_ms": 1e3 * max(t_b, t_o, t_m),
           "bound_by": "bytes" if t_b >= max(t_o, t_m) else "operations",
           "bytes_ms": 1e3 * t_b, "operations_ms": 1e3 * t_o}
    if mma_ops:
        row["mma_ms"] = 1e3 * t_m
    return row


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


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA card (there is no CPU fallback)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    return torch.cuda.get_device_name(0), card


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


def differ(got: dict, want: dict, what: str) -> int:
    """Max abs err over the arrays of two dicts with the same keys, shapes
    and types (else fail); prints the lanes of each array that differs."""
    if set(got) != set(want):
        fail(f"{what}: keys {sorted(got)} != plain {sorted(want)}")
    worst = 0
    for k, w in want.items():
        if got[k].shape != w.shape or got[k].dtype != w.dtype:
            fail(f"{what} {k}: shape or type differs from the plain one")
        e = max_abs_err(got[k], w)
        if e:
            rows = (got[k] != w).reshape(w.shape[0], -1).any(1)
            print(f"{what} {k}: max abs err {e}, rows "
                  f"{rows.nonzero().flatten().tolist()[:12]}")
        worst = max(worst, e)
    return worst


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
        err = max(err, differ(got, want, "K3 wave body"),
                  differ(bd_k, bd_p, "K3 wave body borders"))
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


def check_batched_intra(dev) -> dict:
    """K2, K3 and K4 as the batched all-intra entry runs them, one launch a
    wave for a chunk of F pictures at 1920x1088 (`bench.py:86-99`'s
    frame), F = 4 and a short chunk F = 3, against their plain versions on
    the card, tolerance 0: seeded waves of the chunk (`random_wave_chunk`,
    the fullest wave's 60 lanes and 3 padding lanes) at QP 0, 28 and 51
    through `wave_body` (K2 reading the border buffers, then K3) against
    `wave_body_plain`, K2 alone against `eval_i4x4_plain` and K3 alone
    against `i16_chroma_wave_plain` on the plain I4x4 results, each with
    the border buffers after the scatter; the batched plain versions
    against the per-picture ones stacked; and the picture deblocker on F
    seeded pictures (intra and inter MBs, bS 0 to 4; 1 slice, and 4
    slices of 17 MB rows unfiltered across) against the plain one, one K4
    launch a wave (the stacked check on the short chunk, 4 slices).
    Times a wave of the chunk of 4, and K2's and K3's wave of one of its
    pictures -> extra keys of the K2, K3 and K4 rows."""
    from tpu264_torch.coding import intra_frame as tif
    from tpu264_torch.coding.wavefront import build_schedule
    from tpu264_torch.kernels import deblock as kd
    from tpu264_torch.kernels import deblock_wave as k4w
    from tpu264_torch.kernels import i16_chroma_wave as k3w
    from tpu264_torch.kernels import i4x4_wave as k2w
    from tpu264_torch.ref.transform import chroma_qp
    from tpu264_torch.tools.synth_inputs import (random_deblock_picture,
                                                 random_wave_chunk)
    wm, hm = BW // 16, BH // 16
    i32 = lambda a: torch.as_tensor(a, dtype=torch.int32, device=dev)
    err = {"K2": 0, "K3": 0, "K4": 0}

    def chunk(seed, nf):
        bd, coords, avail, gy, gu, gv = random_wave_chunk(seed, wm, hm, nf,
                                                          n_pad=3)
        return ({k: i32(v) for k, v in bd.items()}, i32(coords),
                torch.as_tensor(avail, device=dev), i32(gy), i32(gu),
                i32(gv))

    def i4x4_plain(bd, coords, avail, gy, qp, lam4, lam24):
        nf = gy.shape[0]
        f, r, c, av = tif._frame_lanes(coords, avail, nf)
        ltop, lleft, _, _, _, _, mtop, mleft = tif.gather_border_ctx(
            bd, r, c, f)
        outs = tif.eval_i4x4_plain(gy.flatten(0, 1), ltop, lleft, mtop,
                                   mleft, *av.unbind(1), qp, lam4, lam24)
        return [t.unflatten(0, (nf, -1)) for t in outs]

    for nf in (4, 3):
        for qp in (0, 28, 51):
            cqp = chroma_qp(qp)
            lam4, lam24, _ = tif.LAMBDA_TABLE[qp]
            bd, coords, avail, gy, gu, gv = chunk(60 + qp + nf, nf)
            what = f"chunk of {nf} at QP {qp}"
            # the whole body: one K2 and one K3 launch for the chunk
            bd_k, bd_p = clone_bd(bd), clone_bd(bd)
            before = read_counts()
            got = tif.wave_body(qp, cqp, lam4, lam24, bd_k, coords, avail,
                                gy, gu, gv)
            torch.cuda.synchronize()
            after = read_counts()
            if (after["K2"] - before["K2"], after["K3"] - before["K3"]) != \
                    (1, 1):
                fail(f"batched wave body, {what}: not one K2 and one K3 "
                     f"launch")
            want = tif.wave_body_plain(qp, cqp, lam4, lam24, bd_p, coords,
                                       avail, gy, gu, gv)
            e = max(differ(got, want, f"batched wave body, {what}"),
                    differ(bd_k, bd_p, f"batched wave body borders, {what}"))
            err["K2"], err["K3"] = max(err["K2"], e), max(err["K3"], e)
            # the batched plain version is the per-picture one stacked
            for f in range(nf):
                bd_f = {k: v[f].clone() for k, v in bd.items()}
                one = tif.wave_body_plain(qp, cqp, lam4, lam24, bd_f, coords,
                                          avail, gy[f], gu[f], gv[f])
                if differ({k: want[k][f] for k in one}, one,
                          f"batched plain, {what}, picture {f}") or differ(
                        {k: bd_p[k][f] for k in bd_f}, bd_f,
                        f"batched plain borders, {what}, picture {f}"):
                    fail(f"batched plain wave body, {what}: picture {f} "
                         f"differs from its own call")
            # K2 alone and K3 alone
            bd_k = clone_bd(bd)
            k2 = k2w.i4x4_wave_bd(gy, bd_k, coords, avail, qp, lam4, lam24,
                                  tif._K2_RULES)
            torch.cuda.synchronize()
            p2 = i4x4_plain(bd, coords, avail, gy, qp, lam4, lam24)
            err["K2"] = max(err["K2"], differ(
                dict(enumerate(k2)), dict(enumerate(p2)), f"K2, {what}"))
            mb4, modebuf, _, coeffs4, j4 = p2
            k3_args = (coords, avail, gy, gu, gv, mb4, modebuf, coeffs4, j4,
                       qp, cqp)
            bd_k, bd_p = clone_bd(bd), clone_bd(bd)
            out = k3w.alloc_outputs((nf, gy.shape[1]), dev)
            k3w.i16_chroma_wave(bd_k, *k3_args, tif._BLK_ORDER, out)
            torch.cuda.synchronize()
            del out["modes"]
            want = tif.i16_chroma_wave_plain(bd_p, *k3_args)
            err["K3"] = max(err["K3"], differ(out, want, f"K3, {what}"),
                            differ(bd_k, bd_p, f"K3 borders, {what}"))
    # K4: the picture deblocker on a chunk of seeded pictures
    for nf in (4, 3):
        pics = [random_deblock_picture(70 + f, wm, hm) for f in range(nf)]
        args = [torch.as_tensor(np.stack(a), device=dev) for a in zip(*pics)]
        for slices, across in ((1, True), (4, False)):
            sched = build_schedule(wm, hm, slices)
            before = k4w.launches["K4"]
            got = kd.make_deblocker_skewed(sched, across)(*args, 28,
                                                          chroma_qp(28))
            torch.cuda.synchronize()
            if k4w.launches["K4"] != before + sched.n_waves:
                fail(f"batched K4, chunk of {nf}: not one launch a wave")
            want = kd.make_deblocker_skewed(sched, across, plain=True)(
                *args, 28, chroma_qp(28))
            for f in range(nf if (nf, slices) == (3, 4) else 0):
                one = kd.make_deblocker_skewed(sched, across, plain=True)(
                    *(a[f] for a in args), 28, chroma_qp(28))
                if any(max_abs_err(w[f], o) for w, o in zip(want, one)):
                    fail(f"batched plain deblocker, chunk of {nf}: picture "
                         f"{f} differs from its own call")
            for g, w, o in zip(got, want, args[:3]):
                if g.shape != w.shape or g.dtype != w.dtype:
                    fail("batched K4: plane shape or type differs from the "
                         "plain one")
                err["K4"] = max(err["K4"], max_abs_err(g, w))
                if not (w != o.to(w.dtype)).any():
                    fail("batched K4: the deblocker changed nothing")
    # times: a wave of the chunk of 4 (the fullest wave, 60 lanes each)
    qp, cqp = QP, chroma_qp(QP)
    lam4, lam24, _ = tif.LAMBDA_TABLE[qp]
    bd, coords, avail, gy, gu, gv = chunk(9, 4)
    nf, n_lanes = gy.shape[:2]
    k2_args = (gy, clone_bd(bd), coords, avail, qp, lam4, lam24,
               tif._K2_RULES)
    ms2 = time_ms(lambda: k2w.i4x4_wave_bd(*k2_args), 200)
    pms2 = time_ms(lambda: i4x4_plain(bd, coords, avail, gy, qp, lam4,
                                      lam24), 3)
    mb4, modebuf, _, coeffs4, j4 = i4x4_plain(bd, coords, avail, gy, qp,
                                              lam4, lam24)
    k3_args = (coords, avail, gy, gu, gv, mb4, modebuf, coeffs4, j4, qp, cqp)
    bd_t = clone_bd(bd)
    out = k3w.alloc_outputs((nf, n_lanes), dev)
    ms3 = time_ms(lambda: k3w.i16_chroma_wave(bd_t, *k3_args,
                                              tif._BLK_ORDER, out), 200)
    pms3 = time_ms(lambda: tif.i16_chroma_wave_plain(bd_t, *k3_args), 3)
    one3 = (coords, avail, gy[0], gu[0], gv[0], mb4[0], modebuf[0],
            coeffs4[0], j4[0], qp, cqp)
    bd_1 = {k: v[0].clone() for k, v in bd.items()}
    out_1 = k3w.alloc_outputs((n_lanes,), dev)
    ms3_one = time_ms(lambda: k3w.i16_chroma_wave(bd_1, *one3,
                                                  tif._BLK_ORDER, out_1), 200)
    ms2_one = time_ms(lambda: k2w.i4x4_wave_bd(
        gy[0], bd_1, coords, avail, qp, lam4, lam24, tif._K2_RULES), 200)
    sched = build_schedule(wm, hm, 1)
    pics = [random_deblock_picture(80 + f, wm, hm) for f in range(nf)]
    y, u, v, intra_mb, tc, mv, ref = (
        torch.as_tensor(np.stack(a), device=dev) for a in zip(*pics))
    bs_v, bs_h = kd.bs_maps(intra_mb, tc, mv, ref)
    planes = [p.to(torch.int32, copy=True).contiguous() for p in (y, u, v)]
    grids = uniform_grids(qp, cqp, (nf, hm, wm), dev)

    def k4_chunk():
        for cp in range(sched.n_waves):
            k4w.deblock_wave(*planes, bs_v, bs_h, cp, *grids)

    ms4 = time_ms(k4_chunk, 10) / sched.n_waves
    plain4 = kd.make_deblocker_skewed(sched, True, plain=True)
    pms4 = time_ms(lambda: plain4(y, u, v, intra_mb, tc, mv, ref, qp, cqp),
                   2) / sched.n_waves
    print(f"batched 1080p, a wave of a chunk of {nf} pictures x {n_lanes} "
          f"lanes: K2 {ms2:.4f} ms (one picture {ms2_one:.4f}), plain "
          f"{pms2:.3f}; K3 {ms3:.4f} ms (one picture {ms3_one:.4f}), plain "
          f"{pms3:.3f}; K4 {ms4:.4f} ms, plain {pms4:.3f}")
    # bounds as in `check_i4x4_wave`, `check_wave_body`, `k4_wave_bound`,
    # over the chunk's lanes (padding lanes included, as the kernels run
    # them)
    lanes = nf * n_lanes
    b2 = bound(lanes * (305 * 4 + 4 + 545 * 4), lanes * 16 * (144 * 23 + 400))
    b3 = bound(lanes * (4 * (58 + 384 + 529) + 3 + 1
                        + 4 * (2 + 408 + 384 + 58)),
               lanes * (384 * 4 * 22 + 24 * 300))
    b4 = k4_wave_bound(BW, BH)
    b4 = {k: nf * b4[k] if k.endswith("_ms") else b4[k] for k in b4}
    rows = {k: {"err": err[k], "ms_chunk4": ms, "plain_ms_chunk4": pms,
                "bound_ms_chunk4": b["bound_ms"]}
            for k, ms, pms, b in (("K2", ms2, pms2, b2), ("K3", ms3, pms3, b3),
                                  ("K4", ms4, pms4, b4))}
    rows["K2"]["ms_one_picture"] = ms2_one
    rows["K3"]["ms_one_picture"] = ms3_one
    return rows


def clone_state(x):
    """A copy of a wave body argument that the kernels write (the border
    buffers, the maps) or of any other tensor argument."""
    if isinstance(x, dict):
        return clone_bd(x)
    if isinstance(x, tuple) and x and all(isinstance(t, torch.Tensor)
                                          for t in x):
        return tuple(t.clone() for t in x)
    return x.clone() if isinstance(x, torch.Tensor) else x


def capture_picture(mod, run) -> tuple:
    """The positional arguments of the one `mod.frame_body` call that
    `run()` makes (a P or B picture's wave table, tables and state), every
    tensor copied as the picture starts."""
    inner, seen = mod.frame_body, []

    def spy(*args, **kw):
        seen.append(tuple(clone_state(a) for a in args))
        return inner(*args, **kw)

    mod.frame_body = spy
    try:
        run()
    finally:
        mod.frame_body = inner
    if len(seen) != 1:
        fail(f"{mod.__name__}: {len(seen)} frame_body calls in a picture")
    return seen[0]


# a P picture case: `inter_frame.frame_body`'s 21 positional arguments
# (planes, cu_pad, cv_pad, qp, cqp, lam4, lam24, lam_me, bd, mv_map,
# ref_map, coords, avail, mv_me, gy, gu, gv, mv_parts, tools, wy, oy), the
# per-wave arrays [n_waves, bmax, ...]; a P wave case: `wave_body`'s 19
# (the same, a wave's rows, without wy and oy)


def p_state(pic):
    """Copies of a P picture or wave case's border buffers and maps."""
    return clone_bd(pic[8]), pic[9].clone(), pic[10].clone()



def p_wave_of(pic, w: int) -> tuple:
    """Wave w of P picture case `pic` as a wave case, the border buffers
    and maps as KP leaves them after waves [0, w)."""
    from tpu264_torch.coding import inter_frame as tinter
    st = p_state(pic)
    tinter.frame_body(*pic[:8], *st, *pic[11:], waves=(0, w))
    torch.cuda.synchronize()
    return (*pic[:8], *st,
            *(None if t is None else t[w] for t in pic[11:18]), pic[18])


def p_frame_case(dev, tools) -> tuple:
    """A 720p P frame (synth frames 1 over 0, QP 28, one slice, the P
    `tools`) through `make_inter_encoder` on the card, which launches KP
    once and K2 never -> (its picture case as the picture starts, its
    widest wave's case)."""
    from tpu264_torch.coding import inter_frame as tinter
    from tpu264_torch.coding.wavefront import build_schedule
    from tpu264_torch.media.synth import synth_frame
    sched = build_schedule(W // 16, H // 16, 1)
    planes = [torch.as_tensor(p, device=dev)
              for p in synth_frame(W, H, 1) + synth_frame(W, H, 0)]
    before = read_counts()
    pic = capture_picture(tinter, lambda: tinter.make_inter_encoder(
        sched, partitions=tools.partitions, p8x8=tools.p8x8,
        t8=tools.t8)(*planes, QP))
    torch.cuda.synchronize()
    after = read_counts()
    ran = {k: after[k] - before[k] for k in ("K2", "KP", "KB")}
    if ran != {"K2": 0, "KP": 1, "KB": 0} or len(pic) != 21:
        fail(f"720p P frame {tools}: launched {ran}")
    return pic, p_wave_of(pic, sched.n_waves // 2)


def seeded_p_wave(dev, qp: int, offset: int, tools, seed: int,
                  wp=(64, 0)) -> tuple:
    """A seeded 720p P wave case: `random_p_wave`, or with the partitions
    or the 8x8 transform `random_p_wave_tools`; with weights `wp` the
    source tiles are faded by them (the lanes that the reference predicts,
    its weighted samples predict)."""
    from tpu264_torch.coding import inter_frame as tinter
    from tpu264_torch.coding import intra_frame as tif
    from tpu264_torch.kernels import interp as kint
    from tpu264_torch.ref.transform import chroma_qp
    from tpu264_torch.tools.synth_inputs import (random_p_wave,
                                                 random_p_wave_tools)
    if tools.partitions or tools.t8:
        *arrs, mvp = random_p_wave_tools(seed, W // 16, H // 16)
    else:
        arrs, mvp = random_p_wave(seed, W // 16, H // 16), None
    (bd, mv_map, ref_map, ry, ru, rv, coords, avail, mv_me, gy, gu,
     gv) = arrs
    i32 = lambda a: torch.as_tensor(a, dtype=torch.int32, device=dev)
    pad = tinter.PAD
    return (kint.luma_planes(kint.pad_plane(i32(ry), pad)),
            kint.pad_plane(i32(ru), pad // 2),
            kint.pad_plane(i32(rv), pad // 2), qp, chroma_qp(qp, offset),
            *tif.LAMBDA_TABLE[qp], {k: i32(v) for k, v in bd.items()},
            i32(mv_map), i32(ref_map), i32(coords),
            torch.as_tensor(avail, device=dev), i32(mv_me),
            tinter.weight_luma(i32(gy), *wp), i32(gu), i32(gv),
            i32(mvp) if tools.partitions else None, tools)


def hold_p_wave(dev, case, wp, what: str) -> tuple:
    """A P wave case with weights `wp` = (wy, oy): KP on a picture of that
    one wave (`wave_body`) against `wave_body_plain`, every output, the
    border buffers and the three map channels -> (max abs err, the plain
    results)."""
    from tpu264_torch.coding import inter_frame as tinter
    wy, oy = wp
    st_k, st_p = p_state(case), p_state(case)
    got = tinter.wave_body(*case[:8], *st_k, *case[11:], wy=wy, oy=oy)
    torch.cuda.synchronize()
    want = tinter.wave_body_plain(*case[:8], *st_p, *case[11:], wy=wy, oy=oy)
    err = max(differ(got, want, f"KP {what}"),
              differ(st_k[0], st_p[0], f"KP {what} borders"),
              differ({"mv_map": st_k[1], "ref_map": st_k[2]},
                     {"mv_map": st_p[1], "ref_map": st_p[2]},
                     f"KP {what} maps"))
    return err, want


def hold_p_picture(pic, what: str) -> tuple:
    """KP on a whole P picture case (one launch) against `p_frame_plain`
    on the card: every output row, the border buffers and the maps after
    the picture -> (max abs err, the plain results, the plain version's
    milliseconds)."""
    from tpu264_torch.coding import inter_frame as tinter
    st_k, st_p = p_state(pic), p_state(pic)
    got = tinter.frame_body(*pic[:8], *st_k, *pic[11:])
    torch.cuda.synchronize()
    t0 = time.monotonic()
    want = tinter.p_frame_plain(*pic[:8], *st_p, *pic[11:])
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.monotonic() - t0)
    err = max(differ(got, want, f"KP {what}"),
              differ(st_k[0], st_p[0], f"KP {what} borders"),
              differ({"mv_map": st_k[1], "ref_map": st_k[2]},
                     {"mv_map": st_p[1], "ref_map": st_p[2]},
                     f"KP {what} maps"))
    return err, want, plain_ms


def real_lanes(pic, want, at: int, n: int, valid) -> tuple:
    """A picture case and its plain results as one wave of the picture's
    real macroblocks (the per-wave arrays at pic[at:at + n], pairs of them
    too, flattened and the padding lanes left out), for the bounds."""
    m = torch.as_tensor(valid, device=want[next(iter(want))].device)

    def sel(t):
        if t is None:
            return None
        if isinstance(t, tuple):
            return tuple(sel(x) for x in t)
        return t[m]

    return ((*pic[:at], *(sel(t) for t in pic[at:at + n]), *pic[at + n:]),
            {k: v[m] for k, v in want.items()})


def time_frame(mod, pic, state, out, counter: str, reps: int = 20) -> float:
    """Device ms of one frame kernel launch on picture case `pic` (CUDA
    events over `reps` launches, each of the whole picture again on the
    state it left; every launch counted once)."""
    from tpu264_torch.kernels import b_wave as kb, p_wave as kp
    counts = kp.launches if counter == "KP" else kb.launches
    before = counts[counter]
    if counter == "KP":
        ms = time_ms(lambda: mod.frame_body(*pic[:8], *state, *pic[11:],
                                            out=out), reps)
    else:
        ms = time_ms(lambda: mod.frame_body(state[0], *pic[1:8], state[1],
                                            *pic[9:], out=out), reps)
    if counts[counter] != before + reps + 1:
        fail(f"{counter}'s launch count is not one a picture")
    return ms


def check_p_wave(dev, frames) -> dict:
    """KP: the P frame kernel against its plain version on the card,
    every output, the border buffers and the three map channels.  Single
    waves (pictures of one wave, `wave_body` against `wave_body_plain`):
    the widest wave of a 720p P frame without the P tools and with the
    reference's default ones (`frames`: (picture case, widest wave case)
    of each), seeded 720p waves over every availability combination, with
    padding lanes, neighbours that agree with the search vector and ones
    that do not, and search vectors past the padded plane's edges, at QP
    0, 28 and 51 with chroma QP offsets 0 and -2; and seeded waves with
    the default tools at QP 0, 28 and 51 (and with 16x8/8x16 alone, and
    the 8x8 transform alone, at 28), whose source tiles steer lanes to
    every partition type and both transforms.  Whole pictures: both 720p
    P frames in one launch each against `p_frame_plain`, timed a picture
    and a wave."""
    from tpu264_torch.coding import inter_frame as tinter
    from tpu264_torch.kernels import p_wave as kp

    full = kp.Tools(True, True, True)
    waves = [w for _, w in frames]
    err, seen = 0, []
    cases = (list(waves)
             + [seeded_p_wave(dev, qp, off, kp.NO_TOOLS, 50 + qp - off)
                for qp, off in ((0, 0), (28, 0), (28, -2), (51, -2))]
             + [seeded_p_wave(dev, qp, 0, t, 70 + qp) for qp, t in
                ((0, full), (28, full), (51, full),
                 (28, kp.Tools(True, False, False)),
                 (28, kp.Tools(False, False, True)))])
    for i, case in enumerate(cases):
        e, want = hold_p_wave(dev, case, (64, 0), f"P wave {i}")
        err = max(err, e)
        tools = case[18]
        n = int((case[11][:, 0] < H // 16).sum())
        inter = want["is_inter"][:n]
        ptypes = (sorted(set(want["ptype"][:n][inter].tolist()))
                  if "ptype" in want else [])
        n_t8 = int(want["t8"][:n].sum()) if "t8" in want else -1
        seen.append((tools, int(inter.sum()), int(want["sel16"][:n].sum()),
                     n, ptypes, n_t8))
    print("KP lanes inter / I16x16 / all, partition types, 8x8 transform, "
          "per single-wave case (the frames' waves first): " + "; ".join(
              f"{a} / {b} / {n} {pt} t8 {t}" for _, a, b, n, pt, t in seen))
    if not all(0 < a < n for _, a, _, n, _, _ in seen[len(waves):]):
        fail("KP: a seeded case does not mix inter and intra lanes")
    full_seen = [x for x in seen[len(waves):] if x[0] == full]
    if set().union(*(set(x[4]) for x in full_seen)) != {0, 1, 2, 3}:
        fail("KP: the seeded waves with the default tools do not choose "
             "every partition type")
    # t8 chosen on some lanes, and inter lanes that keep the 4x4 transform
    if not any(x[5] > 0 for x in full_seen) or \
            not any(0 <= x[5] < x[1] for x in full_seen):
        fail("KP: the seeded waves do not choose both transforms")
    # the frames' whole pictures: held, and timed a picture and a wave
    timed = {}
    for pic, wave in frames:
        tools = pic[18]
        e, want, pms = hold_p_picture(pic, f"720p P picture {tools}")
        err = max(err, e)
        n_waves = pic[11].shape[0]
        out = kp.alloc_outputs(pic[11].shape[:2], dev, tools)
        ms = time_frame(tinter, pic, p_state(pic), out, "KP")
        st = p_state(wave)
        one_ms = time_ms(lambda: tinter.wave_body(*wave[:8], *st,
                                                  *wave[11:]), 200)
        print(f"KP 720p P picture of {n_waves} waves, {tools}: one launch "
              f"{ms:.4f} ms = {1e3 * ms / n_waves:.2f} us a wave; plain "
              f"{pms:.1f} ms; a picture of its widest wave alone "
              f"{one_ms:.4f} ms")
        timed[tools] = (ms, pms, one_ms, pic, want)
    # the row: the picture of the default tools, the main path of the slice
    ms, pms, one_ms, pic, want = timed[full]
    n_waves = pic[11].shape[0]
    flat = real_lanes(pic, want, 11, 7, frame_valid(pic[11]))
    bnd = kp_bound(*flat, (64, 0))
    print(f"KP bound over the picture's {flat[0][14].shape[0]} MBs: "
          f"{bnd['bound_ms']:.6f} ms ({bnd['bound_by']})")
    return {"KP": dict(err=err, ms=ms, plain_ms=pms, waves=n_waves,
                       ms_wave=ms / n_waves, ms_one_wave=one_ms,
                       ms_tools_off=timed[kp.NO_TOOLS][0],
                       ms_wave_tools_off=timed[kp.NO_TOOLS][0] / n_waves,
                       **bnd)}


def frame_valid(coords) -> np.ndarray:
    """The real lanes of a wave table (padding lanes sit at row hm)."""
    c = coords.cpu().numpy()
    return c[..., 0] < c[..., 0].max()


def kp_bound(wave, want, wp) -> dict:
    """KP's bound on a wave case with the default tools (a picture's real
    macroblocks as one wave, `real_lanes`), its plain results `want`,
    weights `wp`: what it reads and does, from its own vectors and
    decisions."""
    n_mbs = wave[14].shape[0]
    luma, chroma = kp_windows(wave, want)
    n_ref = distinct_reference_samples(wave[0].shape[1:], wave[1].shape, 1,
                                       luma, chroma)
    n_inter = int(want["is_inter"].sum())
    n_t8 = int(((want["ptype"] == 0) & want["is_inter"]).sum())
    # a macroblock: 58 context samples and 8 context modes, 384 source
    # samples, coords, 9 vectors, 4 map cells and 4 flags in; 831 int32 of
    # results (the 16 Intra4x4 modes included), 3 flags, 66 border values
    # and 3 map cells out; and the distinct reference samples.
    # Operations: the Intra4x4 search (16 block steps of 144 samples x 23
    # and about 400), K3's intra costs (384 samples x 4 modes x 22), 256
    # samples x 5 candidates x 20 (two reads and an average, Hadamard,
    # sum), about 300 a 4x4 block for transform, quantiser and
    # reconstruction over 24 blocks, 12 a chroma sample of an inter lane's
    # interpolation, and on a 16x16 inter lane the 8x8 transform's 64
    # samples x (2 x 16 butterfly + 6 quantiser) + 256 x 8 for the costs;
    # with weights, 256 samples x 5 candidates x 6 (multiply, round,
    # shift, offset, two clamps)
    n_bytes = (n_mbs * (4 * (58 + 8 + 384 + 2 + 18 + 12) + 4
                        + 4 * (831 + 66 + 9) + 3)
               + 4 * n_ref)
    n_ops = (n_mbs * (16 * (144 * 23 + 400) + 384 * 4 * 22 + 256 * 5 * 20
                      + 24 * 300)
             + n_inter * 128 * 12 + n_t8 * (256 * 38 + 256 * 8))
    if tuple(wp) != (64, 0):
        n_ops += n_mbs * 256 * 5 * 6
    return bound(n_bytes, n_ops)


WEIGHTS = ((64, 0), (58, -7), (71, 12))


def check_p_wave_weighted(dev, golden) -> dict:
    """KP with explicit weights: seeded 720p P waves whose source tiles are
    faded by the weights (64, 0), (58, -7) and (71, 12) (`WEIGHTS`), the P
    tools off and on, and the widest wave of the first P frame of golden
    `ippp_720p_wp_sei` as its encode runs it, each held to
    `wave_body_plain` (`hold_p_wave`), tolerance 0; then that whole
    weighted picture (`golden`: its picture case and its widest wave's
    case) held to `p_frame_plain` and timed -> the KP row's weighted
    entries."""
    from tpu264_torch.coding import inter_frame as tinter
    from tpu264_torch.kernels import p_wave as kp
    full = kp.Tools(True, True, True)
    pic, wave = golden
    wp = tuple(pic[19:21])
    cases = [(seeded_p_wave(dev, 28, 0, t, 130 + 7 * wy + oy, (wy, oy)),
              (wy, oy), f"seeded {t_name}") for t, t_name in
             ((kp.NO_TOOLS, "tools off"), (full, "tools on"))
             for wy, oy in WEIGHTS]
    cases.append((wave, wp, "ippp_720p_wp_sei widest wave"))
    err, rows = 0, []
    for case, w, what in cases:
        e, want = hold_p_wave(dev, case, w, f"{what} {w}")
        err = max(err, e)
        n = int((case[11][:, 0] < H // 16).sum())
        inter = int(want["is_inter"][:n].sum())
        rows.append({"case": what, "wy": w[0], "oy": w[1],
                     "lanes": n, "inter": inter, "max_abs_err": e})
        print(f"KP weighted {what}, (wy, oy) = {w}: {inter} inter of {n} "
              f"lanes, max abs err {e}")
        if what.startswith("seeded") and not 0 < inter < n:
            fail(f"KP weighted {what} {w}: the wave does not mix inter "
                 f"and intra lanes")
    if wp == (64, 0):
        fail("the golden's P frame has no weights")
    e, want, pms = hold_p_picture(pic, f"ippp_720p_wp_sei P picture {wp}")
    err = max(err, e)
    rows.append({"case": "ippp_720p_wp_sei P picture", "wy": wp[0],
                 "oy": wp[1], "lanes": int(frame_valid(pic[11]).sum()),
                 "inter": int(want["is_inter"][frame_valid(pic[11])].sum()),
                 "max_abs_err": e})
    n_waves = pic[11].shape[0]
    out = kp.alloc_outputs(pic[11].shape[:2], dev, pic[18])
    ms = time_frame(tinter, pic, p_state(pic), out, "KP")
    unweighted = (*pic[:19], 64, 0)
    ms_unweighted = time_frame(tinter, unweighted, p_state(pic), out, "KP")
    bnd = kp_bound(*real_lanes(pic, want, 11, 7, frame_valid(pic[11])), wp)
    print(f"KP weighted 720p P picture (golden, {wp}) of {n_waves} waves: "
          f"one launch {ms:.4f} ms = {1e3 * ms / n_waves:.2f} us a wave "
          f"({ms_unweighted:.4f} ms with (64, 0) on the same inputs), plain "
          f"{pms:.1f} ms; bound {bnd['bound_ms']:.6f} ms "
          f"({bnd['bound_by']})")
    return {"KP": dict(err=err, weighted=rows, ms_weighted=ms,
                       ms_wave_weighted=ms / n_waves,
                       plain_ms_weighted=pms,
                       bound_ms_weighted=bnd["bound_ms"],
                       bound_by_weighted=bnd["bound_by"])}


def wp_frame_case(dev) -> tuple:
    """The first P frame of golden `ippp_720p_wp_sei` as `Encoder(cfg)` on
    the card runs it (frames 0 and 1 of the fade): (its picture case, its
    widest wave's case); the weights are the golden's."""
    from tpu264_torch.coding import inter_frame as tinter
    from tpu264_torch.coding.encoder import Encoder
    from tpu264_torch.config import EncoderConfig
    g = golden("ippp_720p_wp_sei")
    cfg = EncoderConfig(**g["config"])
    enc = Encoder(cfg)
    pic = capture_picture(tinter, lambda: enc.encode_sequence(
        golden_frames(g)[:2]))
    if len(pic) != 21 or list(pic[19:21]) != g["frame_wp"][0]:
        fail(f"ippp_720p_wp_sei: the P frame's weights {pic[19:21]} are "
             f"not the golden's {g['frame_wp'][0]}")
    return pic, p_wave_of(pic, enc.sched.n_waves // 2)


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
    grids = uniform_grids(qp, cqp, intra_mb.shape, dev)

    def kernel_frame():
        for cp in range(n_waves):
            k4w.deblock_wave(*planes, bs_v, bs_h, cp, *grids)

    ms = time_ms(kernel_frame, 10) / n_waves
    plain = kd.make_deblocker_skewed(sched_720, True, plain=True)
    pms = time_ms(lambda: plain(*frame_case), 2) / n_waves
    print(f"K4 720p frame, a wave of {n_waves}: kernel {ms:.4f} ms, plain "
          f"{pms:.3f} ms")
    return {"K4": dict(err=err, ms=ms, plain_ms=pms,
                       **k4_wave_bound(W, H))}


def uniform_grids(qp: int, cqp: int, shape, dev) -> tuple:
    """The luma and chroma QP grids of a picture at one QP, as the
    encoder's deblocker passes them to K4."""
    return (torch.full(tuple(shape), qp, dtype=torch.int32, device=dev),
            torch.full(tuple(shape), cqp, dtype=torch.int32, device=dev))


def k4_wave_bound(w: int, h: int) -> dict:
    """K4's bound a wave of a w x h picture: every sample and every bS
    read once, every sample written once, the two QP grids read once;
    16 lines x 8 luma edges x 60 operations and 8 lines x 8 chroma edges
    x 30 a macroblock, with six parameter sets of about 12 operations;
    a wave is 1 / n_waves of the frame."""
    n_mbs = (w // 16) * (h // 16)
    n_waves = w // 16 + 2 * (h // 16 - 1)
    n_bytes = (2 * 4 * (w * h * 3 // 2) + 2 * 4 * (w // 4) * (h // 4)
               + 2 * 4 * n_mbs)
    n_ops = n_mbs * (16 * 8 * 60 + 8 * 8 * 30 + 6 * 12)
    return bound(n_bytes / n_waves, n_ops / n_waves)


def check_deblock_wave_grids(dev) -> dict:
    """K4 as the decoder runs it, against its plain version on the card:
    seeded pictures at 1280x720 and 1920x1088 with per-MB luma and chroma
    QP grids over 0-51, FilterOffsetA/B in -12 .. 12, deblocking idc 2 with
    slice edges in the middle of MB rows, t8 MBs and two-list motion per
    4x4 block; both versions timed -> extra keys for the K4 row."""
    from tpu264_torch.kernels import deblock as kd
    from tpu264_torch.kernels import deblock_wave as k4w
    from tpu264_torch.tools.synth_inputs import random_decode_deblock
    out, err = {}, 0
    for tag, (w, h) in (("720p", (W, H)), ("1080p", (BW, BH))):
        wm, hm = w // 16, h // 16
        d = random_decode_deblock(11, wm, hm, two_list=True, idc=2)
        mid_row = (~d["left_ok"][:, 1:]).sum()
        if not (mid_row and d["t8"].any() and d["off_a"] and d["off_b"]
                and ((d["ref"] >= 0).sum(-1) == 2).any()
                and len(np.unique(d["qp"])) == 52):
            fail(f"K4 grids {tag}: the seeded picture lacks a case")
        t = {k: torch.as_tensor(v, device=dev) for k, v in d.items()
             if not k.startswith("off")}
        args = (t["y"], t["u"], t["v"], t["intra_mb"], t["tc_luma"],
                t["mv"], t["ref"], t["qp"], t["cqp"])
        kw = dict(t8_mb=t["t8"], left_ok=t["left_ok"], top_ok=t["top_ok"],
                  off_a=d["off_a"], off_b=d["off_b"])
        n_waves = wm + 2 * (hm - 1)
        before = k4w.launches["K4"]
        got = kd.make_deblocker(wm, hm)(*args, **kw)
        torch.cuda.synchronize()
        if k4w.launches["K4"] != before + n_waves:
            fail(f"K4 grids {tag}: not one launch a wave")
        plain = kd.make_deblocker(wm, hm, plain=True)
        want = plain(*args, **kw)
        for g, wp, o in zip(got, want, args[:3]):
            err = max(err, max_abs_err(g, wp))
            if not (wp != o.to(wp.dtype)).any():
                fail(f"K4 grids {tag}: the deblocker changed nothing")
        # time: the kernel's launches of the frame against the whole plain
        # deblocker (bS, parameters, skew), per wave
        bs_v, bs_h = kd.bs_maps(*args[3:7], t["t8"], t["left_ok"],
                                t["top_ok"])
        planes = [p.to(torch.int32, copy=True).contiguous()
                  for p in args[:3]]

        def kernel_frame():
            for cp in range(n_waves):
                k4w.deblock_wave(*planes, bs_v, bs_h, cp, t["qp"], t["cqp"],
                                 d["off_a"], d["off_b"])

        ms = time_ms(kernel_frame, 10) / n_waves
        pms = time_ms(lambda: plain(*args, **kw), 2) / n_waves
        b = k4_wave_bound(w, h)
        print(f"K4 with per-MB QP grids, offsets ({d['off_a']}, "
              f"{d['off_b']}), idc 2 slices, t8, two lists, {w}x{h}, a wave "
              f"of {n_waves}: kernel {ms:.4f} ms, plain {pms:.3f} ms, bound "
              f"{b['bound_ms']:.6f} ms ({b['bound_by']})")
        out.update({f"ms_grids_{tag}": ms, f"plain_ms_grids_{tag}": pms,
                    f"bound_ms_grids_{tag}": b["bound_ms"]})
    return {"K4": dict(err=err, **out)}


def frame_records(dev, frame, slices: int, spy=None, deblock_case=None):
    """CABAC records of one 720p I frame through the port's own stages ->
    (records, counts, init, word cap).  `spy(args)` sees the arguments of
    every `wave_body` call of the wave loop, the border buffers as they
    are before the call; `deblock_case`, a list, takes the deblocker's
    arguments for the frame."""
    from tpu264_torch.coding import intra_frame as tif
    from tpu264_torch.coding.encoder import (Encoder, cabac_records,
                                             deblock_inputs)
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
                         dev_out["recon_v"],
                         *deblock_inputs(enc.pic, mbd, "i")[:4], QP,
                         chroma_qp(QP)]
    recs, counts = cabac_records(enc.pic, mbd, "i", enc._cabac_cap)
    init = torch.as_tensor(k1.init_packed_states(0, QP), device=dev)
    return recs, counts, init, enc._cap_words


def p_frame_records(dev, cur, ref, slices: int):
    """CABAC records of one 720p P frame (`cur` against the reference
    planes `ref`, QP 28, the default P tools) through the port's own
    stages -> (records, counts, init of table 1, word cap)."""
    from tpu264_torch.coding import intra_frame as tif
    from tpu264_torch.coding.encoder import Encoder, cabac_records
    from tpu264_torch.config import EncoderConfig
    from tpu264_torch.entropy import cabac_engine_cuda as k1
    enc = Encoder(EncoderConfig(width=W, height=H, qp=QP, symbol_mode="CABAC",
                                intra_period=0, slices_per_frame=slices),
                  device=dev)
    if not (enc.partitions and enc.p8x8 and enc.t8_mode):
        fail("720p CABAC P frame: the default P tools are off")
    planes = [torch.as_tensor(p, device=dev) for p in (*cur, *ref)]
    _, ys = enc._encode_p(*planes, QP)
    recs, counts = cabac_records(
        enc.pic, tif.reorder_wave_outputs(enc.sched, ys), "p",
        enc._cabac_cap)
    init = torch.as_tensor(k1.init_packed_states(1, QP), device=dev)
    return recs, counts, init, enc._cap_words


def record_bins(recs, counts) -> tuple[int, int]:
    """(records, bins) of slice 0: a context record codes its run count of
    bins, a bypass record its bit count, a terminate record one."""
    from tpu264_torch.entropy import cabac_binarize as cbz
    n = int(counts[0])
    kind, _, b = cbz.unpack_records(recs[0, :n].cpu().numpy())
    return n, int(np.where(kind == 0, b >> 1, np.where(kind == 1, b, 1)).sum())


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


def check_cabac(dev, frames) -> tuple[dict, tuple, list]:
    """K1 against `encode_slices_plain`: the records of the 720p I frame
    (`frames[0]`) and of a 720p P frame with the default P tools
    (`frames[1]` against `frames[0]`, init table 1), each as one slice
    (the main paths' shape, timed) and as three, and seeded records with
    long bypass runs, runs of up to 8191 bins in one context, and piles of
    outstanding bits resolved with and without a carry.  Also returns the
    `wave_body` arguments of the I frame's widest wave (for the K2 and K3
    checks) and the deblocker's arguments for the frame (for K4's)."""
    from tpu264_torch.entropy import cabac_binarize as cbz
    from tpu264_torch.entropy import cabac_engine_cuda as k1
    from tpu264_torch.tools import synth_inputs as si
    waves, deblock_case = [], []
    cases = {"I": (frame_records(dev, frames[0], 1, waves.append,
                                 deblock_case),
                   frame_records(dev, frames[0], 3)),
             "P": (p_frame_records(dev, frames[1], frames[0], 1),
                   p_frame_records(dev, frames[1], frames[0], 3))}
    timed = {}
    for what, (case, case3) in cases.items():
        recs, counts, init, cap_words = case
        e1, plain_ms = engine_err(*case, f"720p {what} frame, 1 slice")
        e3, _ = engine_err(*case3, f"720p {what} frame, 3 slices")
        ms = time_ms(lambda: k1.encode_slices(recs, counts, init, cap_words),
                     10)
        n, bins = record_bins(recs, counts)
        if what == "P":
            # the records new to K1: the mvds' contexts 40-53 and the
            # cat-5 8x8 residual's 402-435
            kind, a, _ = cbz.unpack_records(recs[0, :n].cpu().numpy())
            ctx = a[kind == 0]
            if not (((ctx >= 40) & (ctx <= 53)).any()
                    and ((ctx >= 402) & (ctx <= 435)).any()):
                fail("K1: the 720p P frame's records hold no mvd or no "
                     "8x8 residual contexts")
        nbytes = int(k1.encode_slices(recs, counts, init, cap_words)[1].sum())
        print(f"K1 720p {what} frame: {n} records, {bins} bins -> {nbytes} "
              f"bytes: kernel {ms:.3f} ms, plain (host loop) "
              f"{plain_ms:.1f} ms; 3 slices: {case3[1].tolist()} records")
        timed[what] = (max(e1, e3), ms, plain_ms, n, bins, nbytes)
    err = max(timed["I"][0], timed["P"][0])
    # seeded records, with the I slices' contexts
    init = torch.as_tensor(k1.init_packed_states(0, QP), device=dev)
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
    # the row: the P frame's records, the main path of this slice; bytes:
    # records and contexts in, payload and its size out; operations: about
    # 43 a bin (the coding loop's instruction count)
    _, ms, plain_ms, n, bins, nbytes = timed["P"]
    bound_ = bound(4 * n + 4 * 460 + nbytes + 4, 43 * bins)
    # the middle wave of the frame has the most valid lanes
    return ({"K1": dict(err=err, ms=ms, plain_ms=plain_ms, bins=bins,
                        ms_i_frame=timed["I"][1],
                        bins_i_frame=timed["I"][4], **bound_)},
            waves[len(waves) // 2], deblock_case)


class RecordsCalls:
    """While entered, every call of the encoders' `cabac_records` (binarize
    + compact of a picture, KR on the card) is recorded under the label
    `at` with its picture, a copy of its MB dict, its slice kind and its
    cap, then run: `calls` lists them."""

    def __init__(self):
        self.calls, self.at, self.real = [], "", None

    def __enter__(self):
        from tpu264_torch.coding import encoder as encoder_mod
        self.real = encoder_mod.cabac_records

        def spy(pic, mbd, kind, cap):
            self.calls.append((self.at, pic, {k: v.clone()
                                              for k, v in mbd.items()},
                               kind, cap))
            return self.real(pic, mbd, kind, cap)
        encoder_mod.cabac_records = spy
        return self

    def __exit__(self, *exc):
        from tpu264_torch.coding import encoder as encoder_mod
        encoder_mod.cabac_records = self.real


def dense_mbs(dev, kind: str, seed: int, wm: int, hm: int) -> dict:
    """A seeded MB dict (`synth_inputs.random_mbs` / `random_b_mbs` with
    every tool) whose residual blocks are all full of levels of 1 to 3999
    in magnitude, as a QP near 0 gives them, on every position the encoder
    codes (no I16x16 AC DC position, no chroma AC DC position, no luma DC
    outside I16x16 MBs, nothing in a skipped MB): every level takes the
    Exp-Golomb escape, and a slice holds some 2,500 records a MB, over the
    encoders' cap of 768."""
    from tpu264_torch.tools import synth_inputs as si
    if kind == "b":
        mb = si.random_b_mbs(seed, wm, hm, True, True)
        inter = mb["btype"] != 4
    else:
        mb = si.random_mbs(seed, wm, hm, p_slice=kind == "p")
        inter = mb["is_inter"] if kind == "p" else np.zeros(wm * hm, bool)
    rng = np.random.default_rng(seed + 1)
    skip = (np.arange(wm * hm) % 5 == 0) if kind != "i" else \
        np.zeros(wm * hm, bool)
    i16 = mb["sel16"] & ~inter
    for key in ("luma_ac", "luma_dc", "chroma_dc", "chroma_ac"):
        shape = mb[key].shape
        lv = rng.integers(1, 4000, size=shape) * rng.choice([-1, 1], shape)
        lv[skip] = 0
        if key == "luma_ac":
            lv[i16, :, 0] = 0
        elif key == "chroma_ac":
            lv[..., 0] = 0
        elif key == "luma_dc":
            lv[~i16] = 0
        mb[key] = lv.astype(np.int32)
    return {k: torch.as_tensor(v, device=dev) for k, v in mb.items()}


def kr_bound(mbd, kind, counts, n_records: int) -> dict:
    """KR's least time: the bytes of the MB dict's tensors that it reads
    (`read_keys`: with the motion keys and modes from which its state pass
    derives the mvds and the most probable modes) and the 167-word table
    read once and the records that it produces (`n_records`; K1 reads no
    word past a slice's count, so the rows' zeros are not counted) and
    the counts written once, against one int32 operation a coefficient
    (its test for zero) and eight a record (its fields and its
    packing)."""
    from tpu264_torch.kernels import cabac_records as kcr
    n_in = sum(mbd[k].numel() * mbd[k].element_size()
               for k in kcr.read_keys(mbd, kind)) + 4 * 167
    n_coef = sum(mbd[k].numel() for k in ("luma_ac", "luma_dc",
                                          "chroma_dc", "chroma_ac"))
    return bound(n_in + 4 * n_records + 4 * counts.numel(),
                 n_coef + 8 * n_records)


def kd_bound(mbd, kind, mvds, mpm) -> dict:
    """KD's least time: the dict's tensors that the derivation reads
    (`mb_preds.derive_keys`) and the mvds and most probable modes written
    once, against one int32 operation a word written."""
    from tpu264_torch.kernels import mb_preds
    n_in = sum(mbd[k].numel() * mbd[k].element_size()
               for k in mb_preds.derive_keys(mbd, kind))
    n_out = mpm.numel() + (0 if mvds is None else mvds.numel())
    return bound(n_in + 4 * n_out, n_out)


def kr_device_ms(fn, names=("state_kernel", "count_kernel", "scan_kernel",
                            "emit_kernel"), every: bool = False,
                 by_kernel: dict | None = None) -> tuple:
    """One call of `fn` (a KR or KV call) under `torch.profiler` ->
    (device ms of the kernels `names`, {kernel: launches}); `by_kernel`,
    a dict, receives each kernel's device ms.  A trace with no device
    event at all (the profiler now and then records none, or with
    `every` lacks one of `names`: it now and then drops some) is taken
    again, up to three times (with `every`, five)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5 if every else 3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        us, launches, each = 0.0, {}, {}
        for e in events:
            for n in names:
                if f"::{n}(" in e.name:
                    t = e.time_range.end - e.time_range.start
                    us += t
                    each[n] = each.get(n, 0.0) + 1e-3 * t
                    launches[n] = launches.get(n, 0) + 1
        if events and (not every or len(launches) == len(names)):
            break
    if by_kernel is not None:
        by_kernel.update(each)
    return (1e-3 * us if launches else None), launches


def derived_err(got, want) -> int:
    """Max abs err of derived (mvds, mpm) against the plain version's."""
    if (got[0] is None) != (want[0] is None):
        fail("KR/KD: the derived mvds are missing or extra")
    return max(max_abs_err(g, w) for g, w in zip(got, want)
               if w is not None)


def check_queue_reads_nothing(calls) -> None:
    """The queue half of a CABAC P and of a B picture as the encoders run
    it (`encoder.queue_entropy`: KR, its inputs derived inside), after one
    warm call, under `torch.cuda.set_sync_debug_mode("error")`: it reads
    nothing back from the card; the host half's records then equal the
    plain version's."""
    from tpu264_torch.coding import encoder as encoder_mod
    from tpu264_torch.kernels import cabac_records as kcr
    picked = {}
    for at, pic, mbd, kind, cap in calls:
        if kind in ("p", "b") and len(pic.rows) == 1:
            picked.setdefault(kind, (at, pic, mbd, cap))
    for kind in ("p", "b"):
        if kind not in picked:
            fail(f"KR: no CABAC {kind.upper()} picture to queue")
        at, pic, mbd, cap = picked[kind]
        encoder_mod.queue_entropy(pic, mbd, kind, True, cap, 1 << 20)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            queued = encoder_mod.queue_entropy(pic, mbd, kind, True, cap,
                                               1 << 20)
        except RuntimeError as e:
            fail(f"KR {at} {kind.upper()}: the queue half read from the "
                 f"card: {e}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        recs, counts = queued
        want = kcr.records_plain(mbd, pic.wm, pic.hm, list(pic.rows), kind,
                                 cap, pic.t8_mode)
        e = max(max_abs_err(recs, want[0]), max_abs_err(counts, want[1]))
        if recs.shape != want[0].shape or e:
            fail(f"KR {at} {kind.upper()}: the queued records differ from "
                 f"the plain version's (max abs err {e})")
        print(f"KR {at} {kind.upper()} picture: queue_entropy under sync "
              f"debug mode 'error' read nothing back; records equal the "
              f"plain version's")


def host_ms_queue(queue, reps: int) -> float:
    """Mean host time of the queue half `queue()` (a `Queued`), the card
    idle before each call and its host half (`result()`) outside the
    clock, as the encoders run it."""
    queue().result()
    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q = queue()
        total += time.perf_counter() - t0
        q.result()
    return 1e3 * total / reps


def check_over_cap_pipeline(dev) -> None:
    """CIF IPPP CABAC (an IDR and two P frames) through `encode_sequence`,
    which pulls frame k after frame k+1's device work is queued, and
    through one band of `TiledEncoder`, which pulls every band after all
    are queued, at a cap of one record a MB: every slice is over it, so
    each picture's emit into rows as wide as the largest slice runs
    behind the later work; the streams equal those at the default
    cap."""
    from tpu264_torch.coding import encoder as encoder_mod
    from tpu264_torch.coding.encoder import Encoder
    from tpu264_torch.config import EncoderConfig
    from tpu264_torch.media.synth import synth_frame
    from tpu264_torch.runtime.tiled import TiledEncoder, make_mesh
    frames = [synth_frame(352, 288, t) for t in range(3)]

    def cfg():
        return EncoderConfig(width=352, height=288, qp=28,
                             symbol_mode="CABAC", intra_period=0)

    def tiled():
        return TiledEncoder(cfg(), make_mesh(1, gop=1, devices=[dev])) \
            .encode_sequence([frames])[0]

    want = (Encoder(cfg(), device=dev).encode_sequence(frames), tiled())
    widths = []
    real = encoder_mod.cabac_payloads

    def spy(recs, counts, *a):
        widths.append((recs.shape[1], int(counts.max())))
        return real(recs, counts, *a)

    default_cap = encoder_mod.RECORDS_PER_MB
    encoder_mod.cabac_payloads = spy
    try:
        got = (Encoder(cfg(), device=dev, records_per_mb=1)
               .encode_sequence(frames),)
        encoder_mod.RECORDS_PER_MB = 1
        got += (tiled(),)
    finally:
        encoder_mod.cabac_payloads = real
        encoder_mod.RECORDS_PER_MB = default_cap
    if len(widths) != 6 or any(w != most or most <= 396
                               for w, most in widths):
        fail(f"KR over the cap in the pipeline: rows and largest counts "
             f"{widths}, cap 396")
    for what, g, w in zip(("encode_sequence", "TiledEncoder"), got, want):
        if g != w:
            fail(f"KR over the cap in the pipeline: the {what} stream "
                 f"differs from the one at the default cap")
    print(f"KR over the cap in the pipeline (CIF IPPP CABAC, cap 396): "
          f"rows as wide as the largest slice {[w for w, _ in widths]}; "
          f"encode_sequence and TiledEncoder streams equal those at the "
          f"default cap")


def check_kr(dev, calls) -> dict:
    """KR (`kernels/cabac_records.py` `queue` / `records`) against its
    plain version `records_plain` on the card, packed records (zeros past
    each count and the rows' width included) and counts, tolerance 0, and
    the mvds and most probable modes that its state pass derives
    (`csrc/mb_preds.cuh`) against their plain version `preds_plain`:
    every CABAC picture that
    `RecordsCalls` caught (the 720p I frame and the 720p P frame with the
    default P tools, 1 and 3 slices; the I and the weighted P picture of
    `ippp_720p_wp_sei`; the 1920x1088 B pictures of config 4 with and
    without partitions), each of them also cut into 3 slices, and dense
    QP-0-like MB dicts (`dense_mbs`, I at 720p, P and B at 1920x1088, 1
    and 3 slices) whose slices are over the encoders' cap, so that the
    rows are as wide as the largest slice.  Then the queue half reads
    nothing back (`check_queue_reads_nothing`).  Times KR (a call of
    `records`, the host's wait for the largest count included; `ms_queue`
    the queue half back to back) and the plain version with CUDA events,
    and KR's four kernels under the profiler -> the KR row: the 1080p B
    picture with partitions, `ms_720p_i`, `ms_720p_p`, `ms_weighted` (each
    with its `plain_ms_*`), `ms_inputs` (the plain version of the derived
    inputs of the B picture), `device_ms` and `kernel_launches` (one
    call's kernels)."""
    from tpu264_torch.kernels import cabac_records as kcr
    from tpu264_torch.kernels import mb_preds
    cases = {}
    for at, pic, mbd, kind, cap in calls:
        key = (at, kind, tuple(pic.rows))
        cases.setdefault(key, (mbd, pic.wm, pic.hm, cap, pic.t8_mode))
        rows3 = (0, pic.hm // 3, 2 * pic.hm // 3)
        if len(pic.rows) == 1:
            cases.setdefault((at, kind, rows3), (mbd, pic.wm, pic.hm,
                                                 cap // 3, pic.t8_mode))
    for kind, wm, hm, seed in (("i", W // 16, H // 16, 71),
                               ("p", BW // 16, BH // 16, 72),
                               ("b", BW // 16, BH // 16, 73)):
        mbd = dense_mbs(dev, kind, seed, wm, hm)
        for rows in ((0,), (0, hm // 3, 2 * hm // 3)):
            cases[("dense QP-0-like", kind, rows)] = (
                mbd, wm, hm, wm * hm // len(rows) * 768, kind != "i")
    err, timed, over = 0, {}, 0
    for (at, kind, rows), (mbd, wm, hm, cap, t8) in cases.items():
        rows = list(rows)
        ins = mb_preds.preds_plain(mbd, wm, hm, rows, kind)
        queued = kcr.queue(mbd, wm, hm, rows, kind, cap, t8)
        e_in = derived_err((queued.mvds, queued.mpm), ins)
        got = tuple(queued)
        want = kcr.records_plain(mbd, wm, hm, rows, kind, cap, t8)
        torch.cuda.synchronize()
        if got[0].shape != want[0].shape:
            fail(f"KR {at} {kind.upper()} {len(rows)} slices: records "
                 f"{tuple(got[0].shape)}, plain {tuple(want[0].shape)}")
        e = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]),
                e_in)
        err = max(err, e)
        counts = got[1].tolist()
        over += max(counts) > cap
        print(f"KR {at} {kind.upper()} picture {wm}x{hm} MBs, "
              f"{len(rows)} slices: records {counts} (cap {cap}), max abs "
              f"err {e} (derived mvds and modes {e_in})")
        if len(rows) == 1 and at != "dense QP-0-like":
            args = (mbd, wm, hm, rows, kind, cap, t8)
            ms = time_ms(lambda: kcr.records(*args), 10)
            qms = time_ms(lambda: kcr.queue(*args), 10)
            pms = time_ms(lambda: kcr.records_plain(*args), 3)
            hqms = host_ms_queue(lambda: kcr.queue(*args), 20)
            ims = time_ms(lambda: mb_preds.preds_plain(mbd, wm, hm, rows,
                                                       kind), 10)
            dms, kl = kr_device_ms(lambda: kcr.records(*args))
            b = kr_bound(mbd, kind, got[1], sum(counts))
            timed[(at, kind)] = dict(
                ms=ms, ms_queue=qms, host_ms_queue=hqms, plain_ms=pms,
                ms_inputs=ims,
                device_ms=dms, kernel_launches=kl, records=sum(counts), **b)
            print(f"KR {at} {kind.upper()} picture: {ms:.4f} ms a call, "
                  f"queue half {qms:.4f} ms (host {hqms:.4f} ms; kernels "
                  f"{dms} ms on the card, "
                  f"launches {kl}), plain {pms:.2f} ms; bound "
                  f"{b['bound_ms']:.6f} ms ({b['bound_by']}); the derived "
                  f"inputs' plain version (`preds_plain`) {ims:.3f} ms")
    if over < 6:
        fail(f"KR: only {over} cases went over the cap")
    if any(not 1 <= sum(t["kernel_launches"].values()) <= 4
           for t in timed.values()):
        fail("KR: not one to four launches a picture")
    check_queue_reads_nothing(calls)
    check_over_cap_pipeline(dev)
    row = dict(timed[("1080p B picture", "b")], err=err)
    for name, key in (("720p_i", ("720p", "i")), ("720p_p", ("720p", "p")),
                      ("weighted", ("ippp_720p_wp_sei", "p"))):
        for f in ("ms", "plain_ms", "bound_ms", "device_ms"):
            row[f"{f}_{name}"] = timed[key][f]
    return {"KR": row}


class SerializeCalls:
    """While entered, the encoders' `serialize` calls (CAVLC serialize +
    pack of a picture, a band or a batched chunk: KV on the card)
    are recorded under the label `at` with the picture, the MB dict (the
    encoders make it anew for each picture and then only read it; a
    chunk's flattened to F n MBs), the slice kind, the word cap and the
    chunk's pictures, at most two of each label, kind, chunk and layout,
    then run: `calls` lists them."""

    def __init__(self):
        self.calls, self.at, self.real, self._seen = [], "", None, {}

    def __enter__(self):
        from tpu264_torch.coding import encoder as encoder_mod
        self.real = encoder_mod.serialize

        def spy(pic, mbd, kind, cap_words, frames=None):
            key = (self.at, kind, frames, pic.wm, pic.hm, pic.rows)
            if self._seen.get(key, 0) < 2:
                self._seen[key] = self._seen.get(key, 0) + 1
                flat = mbd if frames is None else {
                    k: v.flatten(0, 1) for k, v in mbd.items()}
                self.calls.append((self.at, pic, flat, kind, cap_words,
                                   frames or 1))
            return self.real(pic, mbd, kind, cap_words, frames)
        encoder_mod.serialize = spy
        return self

    def __exit__(self, *exc):
        from tpu264_torch.coding import encoder as encoder_mod
        encoder_mod.serialize = self.real


KV_KERNELS = ("kv_state_kernel", "kv_slices_kernel")
M32 = 0xFFFFFFFF


def kv_bound(mbd, kind: str, t8_mode: bool, nbits, cap: int) -> dict:
    """KV's least time: the bytes of the MB dict's tensors that it reads
    (`cavlc_slices.read_keys`: the coefficients, modes and flags, and the
    motion keys its state pass derives the mvds from) and the 793-word
    table read once, and the words that hold the slices' bits (the pull
    reads no word past a slice's bits, so the rows' zeros are not
    counted), the bit counts and the skip map written once, against one
    int32 operation a coefficient (its test for zero) and one a word
    written."""
    from tpu264_torch.kernels import cavlc_slices as kcv
    n = mbd["luma_ac"].shape[0]
    n_in = sum(mbd[k].numel() * mbd[k].element_size()
               for k in kcv.read_keys(mbd, kind, t8_mode)) + 4 * 793
    words = int(torch.clamp((nbits + 31) // 32, max=cap).sum())
    n_coef = sum(mbd[k].numel() for k in ("luma_ac", "luma_dc",
                                          "chroma_dc", "chroma_ac"))
    return bound(n_in + 4 * words + 8 * nbits.numel()
                 + (n if kind != "i" else 0), n_coef + words)


def kv_err(got, want) -> int:
    """Max abs err of KV's (words, nbits, skipped) against the plain
    version's, 32 bits of each word."""
    e = max(max_abs_err(got[0].to(torch.int64) & M32, want[0] & M32),
            max_abs_err(got[1], want[1]))
    if (got[2] is None) != (want[2] is None):
        fail("KV: the skip map is missing or extra")
    return e if got[2] is None else max(e, max_abs_err(got[2], want[2]))


def kv_parent_times(cases) -> dict:
    """With `TPU264_KV_PARENT` naming another tree (e.g. `git archive` of
    the parent under the gitignored `build/`), KV's wrapper of that tree
    and of this one timed on the same saved MB dicts
    (`tools/time_kv.py`, one process each, in the order parent, this,
    this, parent) -> {tree: [its runs' cases]}; {} without it."""
    parent = os.environ.get("TPU264_KV_PARENT")
    if not parent:
        return {}
    from tpu264_torch.tools.time_kv import save
    path = ROOT / "build" / "kv_timed_cases.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    save(str(path), cases)
    tool = ROOT / "tpu264_torch" / "tools" / "time_kv.py"
    out = {"parent": [], "this": []}
    for tree, where in (("parent", parent), ("this", str(ROOT)),
                        ("this", str(ROOT)), ("parent", parent)):
        env = dict(os.environ, PYTHONPATH=where)
        res = subprocess.run([sys.executable, str(tool), "--load",
                              str(path)], env=env, capture_output=True,
                             text=True, timeout=900, cwd=where)
        if res.returncode != 0:
            fail(f"KV timing of {tree} ({where}) failed:\n"
                 f"{res.stdout[-2000:]}\n{res.stderr[-2000:]}")
        got = json.loads(res.stdout.strip().splitlines()[-1])
        out[tree].append(got["cases"])
        print(f"KV timed, {tree} tree ({where}): {json.dumps(got)}")
    return out


def check_kv(dev, calls, timed_at=(), dense=False) -> dict:
    """KV (`kernels/cavlc_slices.py` `serialize`) against its plain
    version `serialize_plain` on the card, tolerance 0 (32 bits of every
    word, zeros past each slice's bits and the words past the cap
    included; the bit counts; the skip maps), and the mvds and most
    probable modes that its state pass derives (KD's function) against
    `preds_plain`: every picture of `calls` ((label, picture, MB dict,
    kind, word cap, pictures of a chunk)), each one-slice picture also
    cut into 3 (1088 rows: 4) slices, and with `dense` QP-0-like MB dicts
    (`dense_mbs`: I at 720p, P and B at 1920x1088, 1 and 3 (4) slices) at
    the encoders' cap of 100 words a MB, which every slice is over (the
    words past it dropped, the bits counted).  A call counts one KV run
    and one KD derivation.  The cases of `timed_at` ((label, kind,
    pictures) -> name) are timed: the wrapper with CUDA events (`ms`),
    KV's two kernels under the profiler (`device_ms`, each kernel's in
    `device_ms_by_kernel`, `kernel_launches`: one each), the plain
    version (`plain_ms`), `kv_bound`, and KD's row: the state pass's
    device ms, `preds_plain`'s, `kd_bound` -> {"err", "kd_err", "over",
    "timed": {name: row}, "kd": {name: row}, "cases": the timed cases}."""
    from tpu264_torch.kernels import cavlc_slices as kcv
    from tpu264_torch.kernels import mb_preds
    cases = {}
    for at, pic, mbd, kind, cap, pics in calls:
        cases.setdefault((at, kind, pics, tuple(pic.rows)),
                         (mbd, pic.wm, pic.hm, cap, pic.t8_mode))
        if len(pic.rows) == 1 and pics == 1:
            k = 3 if pic.hm % 3 == 0 else 4
            cases.setdefault(
                (at, kind, 1, tuple(range(0, pic.hm, pic.hm // k))),
                (mbd, pic.wm, pic.hm, cap // k, pic.t8_mode))
    if dense:
        for kind, wm, hm, seed in (("i", W // 16, H // 16, 81),
                                   ("p", BW // 16, BH // 16, 82),
                                   ("b", BW // 16, BH // 16, 83)):
            mbd = dense_mbs(dev, kind, seed, wm, hm)
            for k in (1, 3 if hm % 3 == 0 else 4):
                cases[("dense QP-0-like", kind, 1,
                       tuple(range(0, hm, hm // k)))] = (
                    mbd, wm, hm, wm * hm // k * 100, kind == "i")
    err, kd_err, over, timed, kd, saved = 0, 0, 0, {}, {}, []
    for (at, kind, pics, rows), (mbd, wm, hm, cap, t8) in cases.items():
        rows = list(rows)
        args = (mbd, wm, hm, rows, kind, cap, t8, pics)
        before = dict(kcv.launches)
        derived = {}
        got = kcv.serialize(*args, derived=derived)
        if kcv.launches != {k: v + 1 for k, v in before.items()}:
            fail(f"KV {at}: not one run of KV and one derivation of KD")
        want = kcv.serialize_plain(*args)
        ins = mb_preds.preds_plain(mbd, wm, hm, rows, kind, pics)
        torch.cuda.synchronize()
        if got[0].shape != want[0].shape or got[0].dtype != torch.int32:
            fail(f"KV {at} {kind.upper()}: words {tuple(got[0].shape)} "
                 f"{got[0].dtype}, plain {tuple(want[0].shape)}")
        e = kv_err(got, want)
        e_kd = derived_err((derived["mvds"], derived["mpm"]), ins)
        err, kd_err = max(err, e), max(kd_err, e_kd)
        most = int(got[1].max())
        over += most > 32 * cap
        print(f"KV {at} {kind.upper()} {pics} picture(s) of {wm}x{hm} MBs, "
              f"{len(rows)} slices: {int(got[1].sum())} bits (largest slice "
              f"{most}, cap {32 * cap}), max abs err {e}, derived mvds and "
              f"modes (KD) {e_kd}")
        name = dict(timed_at).get((at, kind, pics))
        if name and len(rows) == 1:
            ms = time_ms(lambda: kcv.serialize(*args), 10)
            pms = time_ms(lambda: kcv.serialize_plain(*args), 3)
            ims = time_ms(lambda: mb_preds.preds_plain(mbd, wm, hm, rows,
                                                       kind, pics), 3)
            by_kernel = {}
            dms, kl = kr_device_ms(lambda: kcv.serialize(*args), KV_KERNELS,
                                   every=True, by_kernel=by_kernel)
            if len(kl) != len(KV_KERNELS):
                # the profiler's trace lacked some of KV's kernels on
                # every try: no device time for this case
                print(f"KV {at}: the profiler caught {kl} of KV's kernels; "
                      f"device ms not measured")
                dms, kl, by_kernel = None, None, {}
            b = kv_bound(mbd, kind, t8, got[1], cap)
            timed[name] = dict(ms=ms, plain_ms=pms, device_ms=dms,
                               device_ms_by_kernel=by_kernel,
                               kernel_launches=kl, bits=int(got[1].sum()),
                               **b)
            kd[name] = dict(ms=by_kernel.get("kv_state_kernel"),
                            plain_ms=ims, **kd_bound(mbd, kind, *ins))
            saved.append((name, mbd, wm, hm, rows, kind, cap, t8, pics))
            print(f"KV {at} {kind.upper()} timed: {ms:.4f} ms a call "
                  f"(kernels {dms} ms on the card, by kernel {by_kernel}, "
                  f"launches {kl}), plain {pms:.2f} ms; bound "
                  f"{b['bound_ms']:.6f} ms ({b['bound_by']}); KD inside "
                  f"the state pass, `preds_plain` {ims:.3f} ms, bound "
                  f"{kd[name]['bound_ms']:.6f} ms")
    if err or kd_err:
        fail(f"KV differs from its plain version: max abs err {err}, "
             f"derived mvds and modes {kd_err}")
    traced = [t["kernel_launches"] for t in timed.values()
              if t["kernel_launches"] is not None]
    if (timed and not traced) or any(
            kl != {k: 1 for k in KV_KERNELS} for kl in traced):
        fail(f"KV: not one launch of each of its two kernels a call: "
             f"{traced}")
    return {"err": err, "kd_err": kd_err, "over": over, "timed": timed,
            "kd": kd, "cases": saved}


def phase_tiled_cavlc() -> dict:
    """QCIF IPPP CAVLC (5 frames, deblock, the default P tools) through
    `TiledEncoder` with three bands of 3 MB rows on the one card: its
    stream equals the same run's on the CPU, and KD and KV run once a
    band picture -> the launch counts."""
    from tpu264_torch.config import EncoderConfig
    from tpu264_torch.media.synth import synth_frame
    from tpu264_torch.runtime.tiled import TiledEncoder, make_mesh
    frames = [synth_frame(176, 144, t) for t in range(5)]
    cfg = EncoderConfig(width=176, height=144, qp=28, intra_period=0)
    reset_counts()
    te = TiledEncoder(cfg, make_mesh(
        3, gop=1, devices=[torch.device("cuda", 0)] * 3))
    (stream,) = te.encode_sequence([frames])
    counts = read_counts()
    n = 3 * len(frames)
    print(f"QCIF IPPP CAVLC through TiledEncoder, 3 bands: {len(stream)} "
          f"bytes, launches {counts}")
    cpu = TiledEncoder(cfg, make_mesh(3, gop=1, devices=["cpu"] * 3))
    if stream != cpu.encode_sequence([frames])[0]:
        fail("QCIF IPPP CAVLC, 3 bands: the card's stream differs from "
             "the CPU's")
    if counts["KV"] != n or counts["KD"] != n or counts["KR"] or \
            counts["K1"]:
        fail(f"QCIF IPPP CAVLC, 3 bands: KV {counts['KV']}, KD "
             f"{counts['KD']}, not {n} (a band picture), or CABAC kernels "
             f"ran")
    return counts


def launch_counts() -> list:
    """The wrappers' launch counters (one dict a module)."""
    from tpu264_torch.entropy import cabac_engine_cuda as k1
    from tpu264_torch.kernels import b_wave as kb, cabac_records as kcr, \
        dct_quant as dq, deblock_lines as dl, deblock_wave as k4w, \
        i16_chroma_wave as k3w, i4x4_wave as k2w, \
        me_search as kfs, me_subpel as ksp, p_wave as kp, cavlc_slices as kcv
    # KV's counts its runs ("KV") and the derivations of its state pass
    # ("KD")
    return [k1.launches, k2w.launches, k3w.launches, kp.launches,
            kb.launches, k4w.launches, dq.launches, dl.launches,
            kfs.launches, ksp.launches, kcr.launches, kcv.launches]


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
            fail(f"{k} ({name}) ran {counts[k]} times on the all-intra "
                 f"path, which does not run it")
    for k in ("K1", "KR"):
        if counts[k] != len(frames):
            fail(f"{k} ran {counts[k]} times for {len(frames)} frames")
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
    ENCODED["config3_720p"] = (stream, enc.recons)
    return counts


def golden(name: str) -> dict:
    return json.loads((ROOT / "tests" / "data" / "torch_golden.json")
                      .read_text())[name]


def golden_frames(g: dict) -> list:
    """The input frames of golden `g`: `synth_frame` frames, or (a
    "recipe" under "frames") the fade of `fade_frames`."""
    from tpu264_torch.media.synth import synth_frame
    from tpu264_torch.tools.synth_inputs import FADE, fade_frames
    w, h = g["config"]["width"], g["config"]["height"]
    if isinstance(g["frames"], dict):
        if g["frames"]["recipe"] != FADE:
            fail(f"golden frames {g['frames']} are not `fade_frames`'s")
        return fade_frames(w, h, g["frames"]["n"])
    return [synth_frame(w, h, t) for t in range(g["frames"])]


def encode_golden(name: str, what: str, **enc_kw):
    """Encode the frames of golden `name` through `Encoder(cfg)` (no
    device named: the card) and hold stream and frame sizes to it ->
    (encoder, stream, seconds)."""
    from tpu264_torch.coding.encoder import Encoder
    from tpu264_torch.config import EncoderConfig
    g = golden(name)
    cfg = EncoderConfig(**g["config"])
    frames = golden_frames(g)
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
        print(f"  frame {i} {st.slice_type}: QP {st.qp}, {st.bits} bits, "
              f"PSNR-Y {st.psnr_y:.3f} dB, {st.seconds:.3f} s"
              + (f", (wy, oy) {st.wp}" if st.wp else ""))
    if [st.bits for st in enc.stats] != g["frame_bits"]:
        fail(f"{what}: frame bits {[st.bits for st in enc.stats]} != golden "
             f"{g['frame_bits']}")
    if sha != g["sha256"] or len(stream) != g["bytes"]:
        fail(f"{what}: stream differs from the reference golden")
    if name in DECODED_GOLDENS:
        ENCODED[name] = (stream, enc.recons)
    return enc, stream, secs


def check_intra_launches(what: str, counts: dict, n: int, n_waves: int,
                         deblock: bool) -> None:
    """An all-intra CAVLC run of `n` chunks (the batched entry) or `n`
    frames (the per-frame path): K2 and K3 once a wave of each, K4 once a
    wave with deblocking and never without, KV (the serializer and packer)
    and its KD derivation (the most probable modes) once each, and no
    other kernel."""
    want = {k: 0 for k in counts}
    want.update(K2=n * n_waves, K3=n * n_waves,
                K4=n * n_waves if deblock else 0, KD=n, KV=n)
    wrong = {k: (counts[k], want[k]) for k in counts if counts[k] != want[k]}
    if wrong:
        fail(f"{what}: launches (ran, expected) {wrong} for {n} chunks or "
             f"frames of {n_waves} waves")


def phase_config1() -> None:
    """Config 1: QCIF all-intra CAVLC, 5 frames through the batched entry
    (chunks of 4 and 1): a chunk launches K2, K3 and K4 once a wave, as one
    frame does on the per-frame path, which gives the same stream."""
    reset_counts()
    enc, batched, _ = encode_golden("config1_qcif", "config 1 (batched)")
    if enc.cabac or enc.intra_batch < 2:
        fail("config 1 did not take the batched CAVLC entry")
    n_waves = enc.sched.n_waves
    check_intra_launches("config 1 (batched)", read_counts(), 2, n_waves,
                         enc.cfg.deblock)
    reset_counts()
    _, per_frame, _ = encode_golden("config1_qcif", "config 1 (per frame)",
                                    intra_batch=1)
    check_intra_launches("config 1 (per frame)", read_counts(), 5, n_waves,
                         enc.cfg.deblock)
    if per_frame != batched:
        fail("config 1: the batched entry and the per-frame path differ")
    print(f"config 1: K2, K3 and K4 {n_waves} launches each a chunk of the "
          f"batched entry and a frame of the per-frame path")


def phase_intra1080(card: str) -> dict:
    """`bench.py:86-99`'s all-intra frame (1920x1088, CAVLC, deblock, QP
    28), golden `intra1080_cavlc_batched`: six frames through the batched
    entry (a chunk of 4 and one of 2; a chunk launches K2, K3 and K4 once
    a wave, 254 each, as one frame does) and through the per-frame path,
    both against the golden; then both warm on the same frames in one
    call (batched, per frame, per frame, batched): seconds a frame, with
    the card -> the batched run's launch counts."""
    name = "intra1080_cavlc_batched"
    reset_counts()
    enc, stream, _ = encode_golden(name, "intra1080 (batched, chunks of 4)")
    counts = read_counts()
    n_frames, n_waves = len(enc.stats), enc.sched.n_waves
    n_chunks = -(-n_frames // enc.intra_batch)
    if enc.intra_batch != 4 or n_chunks != 2:
        fail(f"intra1080: {n_frames} frames in chunks of {enc.intra_batch}")
    check_intra_launches("intra1080 (batched)", counts, n_chunks, n_waves,
                         enc.cfg.deblock)
    reset_counts()
    one, _, _ = encode_golden(name, "intra1080 (per frame)", intra_batch=1)
    counts_1 = read_counts()
    check_intra_launches("intra1080 (per frame)", counts_1, n_frames,
                         n_waves, enc.cfg.deblock)
    frames = golden_frames(golden(name))
    secs = {"batched": [], "per frame": []}
    for label, e in (("batched", enc), ("per frame", one),
                     ("per frame", one), ("batched", enc)):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = e.encode_sequence(frames)
        torch.cuda.synchronize()
        secs[label].append((time.monotonic() - t0) / n_frames)
        if out != stream:
            fail(f"intra1080 ({label}, warm): the stream differs")
    print(f"intra1080 warm, same frames, same call ({card}): seconds a "
          f"frame batched (chunks of 4) {secs['batched']}, per frame "
          f"{secs['per frame']}; launches a frame batched "
          f"{sum(counts.values()) / n_frames:g}, per frame "
          f"{sum(counts_1.values()) / n_frames:g} (K2 + K3 + K4)")
    check_many_slices(name, frames)
    return counts


def check_many_slices(name: str, frames) -> None:
    """Golden `name`'s all-intra CAVLC frames with a slice a MB row (68
    slices a 1920x1088 picture, 272 in a chunk of 4, more than a picture
    may have on the card) through the batched entry and the per-frame
    path: the streams equal; KV runs once a chunk, and the modes its state
    pass derives over the chunk equal their plain version's."""
    from tpu264_torch.coding.encoder import Encoder
    from tpu264_torch.config import EncoderConfig
    from tpu264_torch.kernels import cavlc_slices as kcv
    from tpu264_torch.kernels import mb_preds
    cfg = dict(golden(name)["config"], slices_per_frame=68)
    real = kcv.serialize
    chunks = []

    def spy(mbd, wm, hm, rows, kind, cap, t8=False, pics=1):
        derived = {}
        got = real(mbd, wm, hm, rows, kind, cap, t8, pics, derived=derived)
        want = mb_preds.preds_plain(mbd, wm, hm, rows, kind, pics)
        chunks.append((len(rows) * pics, derived_err(
            (derived["mvds"], derived["mpm"]), want)))
        return got

    streams = []
    for batch in (4, 1):
        reset_counts()
        kcv.serialize = spy
        try:
            streams.append(Encoder(EncoderConfig(**cfg), intra_batch=batch)
                           .encode_sequence(frames))
        finally:
            kcv.serialize = real
        counts = read_counts()
        want = -(-len(frames) // batch)
        if counts["KD"] != want or counts["KV"] != want:
            fail(f"{name}, 68 slices, chunks of {batch}: KD ran "
                 f"{counts['KD']} times and KV {counts['KV']}, not {want}")
    if streams[0] != streams[1]:
        fail(f"{name}, 68 slices: the batched and the per-frame streams "
             f"differ")
    if max(c for c, _ in chunks) <= mb_preds.MAX_SLICES \
            or any(e for _, e in chunks):
        fail(f"{name}, 68 slices: KV's (slices, derived max abs err) "
             f"{chunks}")
    print(f"{name}, 68 slices a picture: batched (KV's slices a run "
          f"{[c for c, _ in chunks]}) and per-frame streams equal, "
          f"{len(streams[0])} bytes; KV's derived modes equal their plain "
          f"version's")


def phase_config2() -> None:
    """Config 2: CIF IPPP CAVLC, 1 IDR + 2 P, deblock on."""
    enc, _, _ = encode_golden("config2_cif", "config 2 (CIF IPPP)")
    if [st.slice_type for st in enc.stats] != ["IDR", "P", "P"]:
        fail("config 2: not an IDR and two P frames")


class FrameLaunches:
    """While entered, `Encoder`'s frame methods record each frame's kind,
    its launches (those of its deferred entropy finish included) in
    `per_frame`, and the seconds of its device work, synchronised, in
    `queued`; `check` asserts them."""

    def __init__(self):
        self.per_frame, self.queued, self.real = [], [], {}

    def _counted(self, kind, fn):
        def run(*a, **kw):
            before = read_counts()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            fin, recon = fn(*a, **kw)
            torch.cuda.synchronize()
            self.queued.append(time.monotonic() - t0)
            after = read_counts()
            ran = {k: after[k] - before[k] for k in after}
            self.per_frame.append((kind, ran))

            def finish():
                b = read_counts()
                nalus = fin()
                a2 = read_counts()
                ran.update({k: v + a2[k] - b[k] for k, v in ran.items()})
                return nalus
            return finish, recon
        return run

    def __enter__(self):
        from tpu264_torch.coding.encoder import Encoder
        for kind, attr in (("IDR", "encode_intra_frame"),
                           ("P", "encode_p_frame"), ("B", "encode_b_frame")):
            self.real[attr] = getattr(Encoder, attr)
            setattr(Encoder, attr, self._counted(kind, self.real[attr]))
        return self

    def __exit__(self, *exc):
        from tpu264_torch.coding.encoder import Encoder
        for attr, fn in self.real.items():
            setattr(Encoder, attr, fn)

    def check(self, what: str, kinds, n_waves: int, cabac: bool,
              counts: dict) -> None:
        """An IDR frame runs K2 once a wave and K3, K4 at most once a
        wave; a P frame KP once (the whole picture) and K4 at most once a
        wave; a B frame KB once and K4 at most once a wave; KF and KS once
        a list (a P frame once, a B frame twice, an IDR frame never); K1
        and KR once a frame with CABAC and never with CAVLC, KD and KV
        once a frame with CAVLC and never with CABAC; the slab
        entries, K2
        and K3's wave forms outside an IDR frame, KP outside a P frame and
        KB outside a B frame never; and nothing runs outside the frames
        (`counts`: the whole run's launches)."""
        if [k for k, _ in self.per_frame] != kinds:
            fail(f"{what}: frames {[k for k, _ in self.per_frame]}")
        for i, (kind, c) in enumerate(self.per_frame):
            print(f"  frame {i} {kind} launches: {c}")
            want = {"K1": int(cabac), "KR": int(cabac), "KD": int(not cabac),
                    "KV": int(not cabac),
                    "K2": n_waves if kind == "IDR" else 0, "K2_blocks": 0,
                    "K3_blocks": 0, "K4_lines": 0,
                    "KP": int(kind == "P"), "KB": int(kind == "B")}
            want["KF"] = want["KS"] = {"IDR": 0, "P": 1, "B": 2}[kind]
            if kind != "IDR":
                want["K3"] = 0
            for k, n in want.items():
                if c[k] != n:
                    fail(f"{what} frame {i} ({kind}): {k} ran {c[k]} "
                         f"times, not {n} ({n_waves} waves)")
            at_most_a_wave = ("K3", "K4") if kind == "IDR" else ("K4",)
            for k in at_most_a_wave:
                if not 1 <= c[k] <= n_waves:
                    fail(f"{what} frame {i} ({kind}): {k} ran {c[k]} "
                         f"times for {n_waves} waves")
        if sum(sum(c.values()) for _, c in self.per_frame) != \
                sum(counts.values()):
            fail(f"{what}: launches outside the frames' encode and finish "
                 f"calls")


def phase_ippp(name: str, what: str, kinds=None) -> tuple[dict, object]:
    """An IPPP golden (a B-GOP golden with `kinds`, its frames' kinds in
    coding order) through `Encoder(cfg)`, the launches of each frame
    asserted (`FrameLaunches.check`) -> (launch counts of the whole run,
    the encoder)."""
    reset_counts()
    with FrameLaunches() as fl:
        enc, _, secs = encode_golden(name, what)
    counts = read_counts()
    print(f"{what}, launches on the path: {counts}")
    fl.check(what, kinds or ["IDR"] + ["P"] * (len(enc.stats) - 1),
             enc.sched.n_waves, enc.cabac, counts)
    # `FrameStats.seconds` of a pipelined frame runs until the next frame
    # is queued, so the frames' own times are taken around their calls
    print(f"{what} (eager, first run), device work of each frame in coding "
          f"order: " + ", ".join(f"{k} {t:.3f} s" for (k, _), t in
                                  zip(fl.per_frame, fl.queued))
          + f"; {len(enc.stats) / secs:.4f} frames/s with pull and NAL "
          f"assembly")
    return counts, enc


def phase_weighted(name: str, what: str) -> dict:
    """An IPPP golden with weighted prediction and SEI (`phase_ippp`):
    every P frame's (weight, offset) is the golden's, and at least one is
    not (64, 0) -> the launch counts."""
    counts, enc = phase_ippp(name, what)
    got = [list(st.wp) for st in enc.stats if st.slice_type == "P"]
    want = golden(name)["frame_wp"]
    print(f"{what}: P frames' (wy, oy) {got} (reference {want})")
    if not enc.wp_mode or got != want:
        fail(f"{what}: weights {got}, not the reference's {want}")
    if all(w == [64, 0] for w in got):
        fail(f"{what}: weighted prediction did not engage")
    return counts


def phase_gop(name: str, what: str, card: str) -> dict:
    """BASELINE config 5 (golden `name`, its "scheduler"): closed GOPs
    through the port's `runtime.gop_scheduler`, hosts simulated in turn on
    the one card.  One host's gathered stream (every frame's launches
    asserted, `FrameLaunches.check`) and two hosts' equal each other and
    the golden; then `scaling_harness` at 1 and 2 hosts prints each
    simulated host's seconds and the efficiency beside the card (`card`:
    its name and power limit) -> the one-host run's launches."""
    from tpu264_torch.coding.encoder import Encoder
    from tpu264_torch.config import EncoderConfig
    from tpu264_torch.runtime import (GopScheduler, encode_host_share,
                                      gather_streams, scaling_harness)
    g = golden(name)
    cfg = EncoderConfig(**g["config"])
    frames = golden_frames(g)
    sc = g["scheduler"]
    made = []

    def mk():
        made.append(Encoder(cfg))           # no device named: the card
        if made[-1].device.type != "cuda":
            fail(f"{what}: Encoder(cfg) chose {made[-1].device}")
        return made[-1]

    def gathered(hosts):
        sched = GopScheduler(sc["n_frames"], sc["intra_period"], hosts)
        return gather_streams([encode_host_share(mk, frames, sched, h)
                               for h in range(hosts)])

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with FrameLaunches() as fl:
        one = gathered(sc["hosts"])
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    counts = read_counts()
    enc = made[0]
    sha = hashlib.sha256(one).hexdigest()
    print(f"{what}: {len(frames)} frames at {cfg.width}x{cfg.height} in "
          f"{secs:.3f} s = {len(frames) / secs:.4f} frames/s (one host, "
          f"eager, first run); {len(one)} bytes, sha256 {sha}")
    print(f"{what}, launches on the path: {counts}")
    fl.check(what, ["IDR", "P"] * (len(frames) // 2), enc.sched.n_waves,
             enc.cabac, counts)
    for st, t in zip(enc.stats, fl.queued):
        print(f"  GOP frame {st.frame} {st.slice_type}: {st.bits} bits, "
              f"PSNR-Y {st.psnr_y:.3f} dB, device work {t:.3f} s")
    if [st.bits for st in enc.stats] != g["frame_bits"]:
        fail(f"{what}: frame bits {[st.bits for st in enc.stats]} != golden "
             f"{g['frame_bits']}")
    if sha != g["sha256"] or len(one) != g["bytes"]:
        fail(f"{what}: the one-host stream differs from the reference "
             f"golden")
    two = gathered(2)
    if two != one:
        fail(f"{what}: the two-host gathered stream differs from the "
             f"one-host stream")
    print(f"{what}: the two-host gathered stream equals the one-host stream "
          f"and the golden")
    res = scaling_harness(mk, frames, sc["intra_period"], host_counts=(1, 2),
                          reps=1)
    for hosts, r in res.items():
        print(f"{what}, {card}: {hosts} simulated host(s): per-host "
              f"seconds {r['per_host_s']}, parallel wall "
              f"{r['parallel_wall_s']} s, efficiency {r['efficiency']} (raw "
              f"{r['raw_efficiency']}), {r['stream_bytes']} bytes")
        if r["stream_bytes"] != g["bytes"]:
            fail(f"{what}: the harness's {hosts}-host stream has "
                 f"{r['stream_bytes']} bytes, not {g['bytes']}")
    return counts


def phase_rate_control(name: str, what: str, kinds=None) -> dict:
    """A golden encoded with rate control (`phase_ippp`): the QP of every
    frame is the reference's, and they move -> the launch counts."""
    counts, enc = phase_ippp(name, what, kinds)
    qps = [st.qp for st in enc.stats]
    want = golden(name)["frame_qps"]
    print(f"{what}: QPs {qps} (reference {want})")
    if enc.rc is None or qps != want or len(set(qps)) < 2:
        fail(f"{what}: QPs {qps}, not the reference's {want}, or constant")
    return counts


# a B picture case: `b_frame.frame_body`'s 20 positional arguments (maps,
# planes, cpads, qp, cqp, lam4, lam24, lam_me, bd, coords, avail, mv_me,
# mv_parts, colzero, colmixed, gy, gu, gv, partitions, allow_parts), the
# per-wave arrays [n_waves, bmax, ...], mv_me and mv_parts a pair of
# lists; a B wave case: `b_frame.wave_body`'s 20 (a wave's rows)


def b_state(case):
    """Copies of a B picture or wave case's maps and border buffers."""
    return tuple(m.clone() for m in case[0]), clone_bd(case[8])


def b_row(t, w):
    """Row w of a per-wave array, or of each of a pair of them."""
    if t is None:
        return None
    return tuple(x[w] for x in t) if isinstance(t, tuple) else t[w]


def b_wave_of(pic, w: int) -> tuple:
    """Wave w of B picture case `pic` as a wave case, the maps and border
    buffers as KB leaves them after waves [0, w)."""
    from tpu264_torch.coding import b_frame as tb
    maps, bd = b_state(pic)
    tb.frame_body(maps, *pic[1:8], bd, *pic[9:], waves=(0, w))
    torch.cuda.synchronize()
    return (maps, *pic[1:8], bd, *(b_row(t, w) for t in pic[9:18]),
            *pic[18:])


def b_frame_case(dev, is_ref: bool) -> dict:
    """One 1920x1088 B frame of config 4's encoder on the card (synth frame
    1 between frames 0 and 2 as its references, QP 30, the partitions
    allowed unless `is_ref`), queued and finished: "picture", its picture
    case as the picture starts; "wave", its widest wave's case; "records"
    its CABAC records (records, counts, init of table 1, word cap),
    "deblock" its deblocker's arguments (two-list bS inputs).  It runs KB
    once, K2 and KP never."""
    from tpu264_torch.coding import b_frame as tb
    from tpu264_torch.coding import encoder as encoder_mod
    from tpu264_torch.coding.encoder import Encoder
    from tpu264_torch.config import EncoderConfig
    from tpu264_torch.entropy import cabac_engine_cuda as k1
    from tpu264_torch.media.synth import synth_frame
    enc = Encoder(EncoderConfig(width=BW, height=BH, qp=QP, intra_period=0,
                                num_b_frames=2, symbol_mode="CABAC",
                                deblock=True))
    if not enc.b_partitions:
        fail("config 4's encoder weighs no B partitions")
    widest = int(np.argmax(enc.sched.valid.sum(axis=1)))
    case = {}
    real_records, real_deblock = encoder_mod.cabac_records, enc._deblock

    def records(*a, **kw):
        case["records"] = real_records(*a, **kw)
        return case["records"]

    def deblock(*a, **kw):
        case["deblock"] = (a, kw)
        return real_deblock(*a, **kw)

    def run():
        frames = [synth_frame(BW, BH, t) for t in range(3)]
        fin, _ = enc.encode_b_frame(*frames[1], frames[0], frames[2],
                                    frame_num=1, poc_lsb=2, qp=QP + 2,
                                    is_ref=is_ref)
        fin()
        torch.cuda.synchronize()

    encoder_mod.cabac_records, enc._deblock = records, deblock
    before = read_counts()
    try:
        case["picture"] = capture_picture(tb, run)
    finally:
        encoder_mod.cabac_records = real_records
    after = read_counts()
    ran = {k: after[k] - before[k] for k in ("K2", "KB", "KP")}
    if ran != {"K2": 0, "KB": 1, "KP": 0}:
        fail(f"1080p B frame launched {ran}")
    case["wave"] = b_wave_of(case["picture"], widest)
    recs, counts = case["records"]
    case["records"] = (recs, counts, torch.as_tensor(
        k1.init_packed_states(1, QP + 2), device=dev), enc._cap_words)
    return case


def distinct_reference_samples(shape, cshape, n_refs: int, luma,
                               chroma) -> int:
    """The reference samples a wave kernel must read, each counted once
    in its own plane: the union of the luma windows `luma` and of the
    chroma windows `chroma`, each an iterable of (reference, y, x, mv, bh,
    bw) with (y, x) the block's origin in the padded planes of shape
    `shape` (half-pel planes G, b, h, j) and `cshape` (u and v alike).
    A luma window reads one or two half-pel planes (`interp.QPEL_TABLE`),
    a chroma window (bh + 1) x (bw + 1) samples less the row and column
    that a zero eighth-pel fraction does not weigh; starts clamp as
    `interp.clamp_start` clamps them."""
    from tpu264_torch.kernels.interp import QPEL_TABLE
    qt = QPEL_TABLE.tolist()
    hp, wp = shape
    chp, cwp = cshape
    lmask = np.zeros((n_refs, 4, hp, wp), bool)
    cmask = np.zeros((n_refs, chp, cwp), bool)

    def clamp(s, size, dim):
        return min(max(s + dim if s < 0 else s, 0), dim - size)

    for ref, y, x, (my, mx), bh, bw in luma:
        p1, dy1, dx1, p2, dy2, dx2, avg = qt[(my & 3) * 4 + (mx & 3)]
        for p, dy, dx in ((p1, dy1, dx1),) + (((p2, dy2, dx2),) if avg
                                              else ()):
            yy = clamp(y + (my >> 2) + dy, bh, hp)
            xx = clamp(x + (mx >> 2) + dx, bw, wp)
            lmask[ref, p, yy:yy + bh, xx:xx + bw] = True
    for ref, y, x, (my, mx), bh, bw in chroma:
        yy = clamp(y + (my >> 3), bh + 1, chp)
        xx = clamp(x + (mx >> 3), bw + 1, cwp)
        cmask[ref, yy:yy + bh + (my & 7 != 0),
              xx:xx + bw + (mx & 7 != 0)] = True
    return int(lmask.sum()) + 2 * int(cmask.sum())


def kp_windows(wave, want) -> tuple:
    """What KP's function reads of the reference on one wave with the
    default tools (`check_p_wave`'s case `wave`, its plain results
    `want`): the luma windows of every candidate (the MB's two, each
    half's, each quadrant's) and the chroma windows of the prediction
    chosen -> (luma windows, chroma windows)."""
    from tpu264_torch.coding import inter_frame as tinter
    cpu = lambda t: t.cpu().tolist()
    me, skip, mv, mv2 = (cpu(v) for v in (wave[13], want["mv_skip"],
                                          want["mv"], want["mv2"]))
    parts = cpu(wave[17].reshape(-1, 8, 2))
    inter, ptype = cpu(want["is_inter"]), cpu(want["ptype"])
    halves = ((0, 0, 8, 16), (8, 0, 8, 16), (0, 0, 16, 8), (0, 8, 16, 8))
    luma, chroma = [], []
    for i, (r, c) in enumerate(cpu(wave[11])):
        y0, x0 = r * 16 + tinter.PAD, c * 16 + tinter.PAD
        cy0, cx0 = r * 8 + tinter.PAD // 2, c * 8 + tinter.PAD // 2
        luma += [(0, y0, x0, v, 16, 16) for v in (me[i], skip[i])]
        luma += [(0, y0 + py, x0 + px, parts[i][h], bh, bw)
                 for h, (py, px, bh, bw) in enumerate(halves)]
        luma += [(0, y0 + 8 * (q // 2), x0 + 8 * (q % 2), parts[i][4 + q],
                  8, 8) for q in range(4)]
        if not inter[i]:
            continue
        if ptype[i] == 0:
            chroma.append((0, cy0, cx0, mv[i], 8, 8))
        elif ptype[i] == 3:
            chroma += [(0, cy0 + 4 * (q // 2), cx0 + 4 * (q % 2),
                        parts[i][4 + q], 4, 4) for q in range(4)]
        else:
            (py, px, bh, bw), (qy, qx, _, _) = (
                ((0, 0, 4, 8), (4, 0, 4, 8)) if ptype[i] == 1
                else ((0, 0, 8, 4), (0, 4, 8, 4)))
            chroma += [(0, cy0 + py, cx0 + px, mv[i], bh, bw),
                       (0, cy0 + qy, cx0 + qx, mv2[i], bh, bw)]
    return luma, chroma


def kb_windows(wave, want, direct) -> tuple:
    """What KB's function reads of the two references on one wave
    (`check_b_wave`'s case `wave`, its plain results `want`, the lanes'
    direct vectors and lists `direct` = (dmv0, dmv1, duse0, duse1)):
    the luma windows of L0 and L1 at the search vectors, of direct at the
    direct vectors for the lists it uses and never where `colmixed`, of
    each half for both lists where partitions are allowed; the chroma
    windows of the prediction chosen -> (luma windows, chroma windows,
    luma candidates costed in 16x16 units)."""
    from tpu264_torch.coding import b_frame as tb
    from tpu264_torch.kernels import b_wave as kb
    (_, _, _, *_, coords, _, mv_me, mv_parts, _, colmixed, _, _, _, parts,
     allow) = wave
    cpu = lambda t: t.cpu().tolist()
    me, mp = [cpu(v) for v in mv_me], [cpu(v) for v in mv_parts]
    dmv, duse = [cpu(v) for v in direct[:2]], [cpu(v) for v in direct[2:]]
    bt, cm = cpu(want["btype"]), cpu(colmixed)
    bp, c0, c1 = (cpu(want[k]) if parts else None
                  for k in ("bptype", "c0", "c1"))
    lists = {0: (0,), 1: (1,), 2: (0, 1)}
    luma, chroma, n_cand = [], [], 0
    for i, (r, c) in enumerate(cpu(coords)):
        y0, x0, cy0, cx0 = (r * 16 + tb.PAD, c * 16 + tb.PAD,
                            r * 8 + tb.PAD // 2, c * 8 + tb.PAD // 2)
        for lst in (0, 1):
            luma.append((lst, y0, x0, me[lst][i], 16, 16))
            if duse[lst][i] and not cm[i]:
                luma.append((lst, y0, x0, dmv[lst][i], 16, 16))
        n_cand += 3 + (not cm[i])
        if parts and allow:
            n_cand += 6
            for h, k in enumerate(kb.HALVES):
                py, px, bh, bw = tb.GEO[k]
                luma += [(lst, y0 + py, x0 + px, mp[lst][i][h], bh, bw)
                         for lst in (0, 1)]
        if bt[i] == 5:
            halves = ("top", "bot") if bp[i] == 1 else ("left", "right")
            for k, cc in zip(halves, (c0[i], c1[i])):
                py, px, bh, bw = tb.CGEO[k]
                chroma += [(lst, cy0 + py, cx0 + px,
                            mp[lst][i][kb.HALVES.index(k)], bh, bw)
                           for lst in lists[cc]]
        elif bt[i] == 3:
            chroma += [(lst, cy0, cx0, dmv[lst][i], 8, 8)
                       for lst in (0, 1) if duse[lst][i]]
        elif bt[i] != 4:
            chroma += [(lst, cy0, cx0, me[lst][i], 8, 8)
                       for lst in lists[bt[i]]]
    return luma, chroma, n_cand


def maps_of(maps):
    return dict(zip(("mv0_map", "ref0_map", "mv1_map", "ref1_map"), maps))


def hold_b_picture(pic, what: str) -> tuple:
    """KB on a whole B picture case (one launch) against `b_frame_plain`
    on the card: every output row, the border buffers and both lists'
    maps after the picture -> (max abs err, the plain results, the plain
    version's milliseconds, the direct vectors and lists of each wave as
    the plain version saw them)."""
    from tpu264_torch.coding import b_frame as tb
    (mk, bk), (mp, bp) = b_state(pic), b_state(pic)
    got = tb.frame_body(mk, *pic[1:8], bk, *pic[9:])
    torch.cuda.synchronize()
    inner, direct = tb.spatial_direct, []

    def spy(*a, **kw):
        res = inner(*a, **kw)
        direct.append(res[2:])
        return res

    tb.spatial_direct = spy
    try:
        t0 = time.monotonic()
        want = tb.b_frame_plain(mp, *pic[1:8], bp, *pic[9:])
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.monotonic() - t0)
    finally:
        tb.spatial_direct = inner
    err = max(differ(got, want, f"KB {what}"),
              differ(bk, bp, f"KB {what} borders"),
              differ(maps_of(mk), maps_of(mp), f"KB {what} maps"))
    return err, want, plain_ms, [torch.stack(t) for t in zip(*direct)]


def kb_bound(pic, want, direct) -> dict:
    """KB's bound on a B picture case's real macroblocks (`real_lanes`),
    its plain results `want` and the direct vectors and lists of its
    waves `direct` (`hold_b_picture`): what it reads and does, from its
    own vectors and decisions."""
    valid = frame_valid(pic[9])
    wave, want = real_lanes(pic, want, 9, 9, valid)
    m = torch.as_tensor(valid, device=direct[0].device)
    direct = [d[m] for d in direct]
    n_mbs = wave[15].shape[0]
    luma, chroma, n_cand = kb_windows(wave, want, direct)
    n_ref = distinct_reference_samples(wave[1][0].shape[1:],
                                       wave[2][0].shape, 2, luma, chroma)
    n_cpred = sum(2 * w[4] * w[5] for w in chroma)
    allow = wave[18] and wave[19]
    # a macroblock: 58 context samples and 8 context modes, 384 source
    # samples, coords, 2 + 2 vector components (+ 16 with partitions
    # allowed), 8 map cells and 6 flags in; 831 int32 of results (the 16
    # Intra4x4 modes included), 4 flags, 66 border values and 6 map cells
    # out; and the distinct reference samples.  Operations: the Intra4x4
    # search (16 block steps of 144 samples x 23 and about 400), K3's
    # intra costs (384 samples x 4 modes x 22), 20 a sample of each luma
    # candidate (reads, average, Hadamard, sum), about 300 a 4x4 block for
    # transform, quantiser and reconstruction over 24 blocks, 12 a chroma
    # sample predicted
    n_bytes = (n_mbs * (4 * (58 + 8 + 384 + 2 + 4 + 16 * allow + 24) + 6
                        + 4 * (831 + 66 + 18) + 4)
               + 4 * n_ref)
    n_ops = (n_mbs * (16 * (144 * 23 + 400) + 384 * 4 * 22 + 24 * 300)
             + 256 * 20 * n_cand + 12 * n_cpred)
    return bound(n_bytes, n_ops)


def check_b_wave(dev, b_cases) -> dict:
    """KB: the B frame kernel against its plain version on the card, every
    output, the border buffers and both lists' maps.  Single waves
    (pictures of one wave, `wave_body` against `wave_body_plain`): the
    widest wave (60 lanes) of a 1920x1088 B frame that allows partitions
    and of one that does not (`b_cases`: `b_frame_case`), and seeded
    waves of that width (`synth_inputs.random_b_wave`: every btype, every
    partition shape with every (c0, c1), colzero and colmixed lanes,
    padding lanes, vectors past the planes' edges) at QP 0, 28 and 51,
    each with `allow_parts` on and off.  Whole pictures: both 1080p B
    frames in one launch each against `b_frame_plain`, the one that
    allows partitions timed a picture and a wave, with its bound."""
    from tpu264_torch.coding import b_frame as tb
    from tpu264_torch.coding import intra_frame as tif
    from tpu264_torch.kernels import b_wave as kb
    from tpu264_torch.kernels import interp as kint
    from tpu264_torch.ref.transform import chroma_qp
    from tpu264_torch.tools.synth_inputs import random_b_wave

    def seeded(qp, allow):
        (bd, maps, ref0, ref1, coords, avail, me0, me1, mp0, mp1, cz, cm, gy,
         gu, gv) = random_b_wave(80 + qp, BW // 16, BH // 16)
        i32 = lambda a: torch.as_tensor(a, dtype=torch.int32, device=dev)
        b1 = lambda a: torch.as_tensor(a, device=dev)
        pad = tb.PAD
        planes = tuple(kint.luma_planes(kint.pad_plane(i32(r[0]), pad))
                       for r in (ref0, ref1))
        cpads = tuple(kint.pad_plane(i32(pl), pad // 2)
                      for r in (ref0, ref1) for pl in r[1:])
        return (tuple(i32(m) for m in maps), planes, cpads, qp,
                chroma_qp(qp), *tif.LAMBDA_TABLE[qp],
                {k: i32(v) for k, v in bd.items()}, i32(coords), b1(avail),
                (i32(me0), i32(me1)), (i32(mp0), i32(mp1)), b1(cz), b1(cm),
                i32(gy), i32(gu), i32(gv), True, allow)

    waves = [c["wave"] for c in b_cases]
    err, seen = 0, []
    cases = waves + [seeded(qp, allow) for qp in (0, 28, 51)
                     for allow in (True, False)]
    for i, case in enumerate(cases):
        (mk, bk), (mp, bp) = b_state(case), b_state(case)
        got = tb.wave_body(mk, *case[1:8], bk, *case[9:])
        torch.cuda.synchronize()
        want = tb.wave_body_plain(mp, *case[1:8], bp, *case[9:])
        err = max(err, differ(got, want, f"KB wave {i}"),
                  differ(bk, bp, f"KB wave {i} borders"),
                  differ(maps_of(mk), maps_of(mp), f"KB wave {i} maps"))
        n = int((case[9][:, 0] < BH // 16).sum())
        bt = want["btype"][:n]
        part = bt == 5
        combos = set(zip(*(want[k][:n][part].tolist()
                           for k in ("bptype", "c0", "c1"))))
        seen.append((case[-1], sorted(set(bt.tolist())), len(combos), n))
    print("KB btypes chosen, partition combinations, lanes, per single-wave "
          "case (the frames' waves first; allow_parts): " + "; ".join(
              f"{a} {b} {c} {n}" for a, b, c, n in seen))
    seeded_seen = seen[len(waves):]
    if set().union(*(set(b) for _, b, _, _ in seeded_seen)) != \
            {0, 1, 2, 3, 4, 5}:
        fail("KB: the seeded waves do not choose every btype")
    if max(c for _, _, c, _ in seeded_seen) != 18:
        fail("KB: no seeded wave chooses every partition combination")
    if any(5 in b for a, b, _, _ in seen if not a):
        fail("KB: a wave that allows no partitions chose one")
    # the frames' whole pictures: held; the one that allows partitions
    # timed a picture and a wave
    held = []
    for c in b_cases:
        pic = c["picture"]
        e, want, pms, direct = hold_b_picture(
            pic, f"1080p B picture allow_parts={pic[19]}")
        err = max(err, e)
        held.append((pic, want, pms, direct))
    pic, want, pms, direct = held[0]
    n_waves, n_mbs = pic[9].shape[:2]
    out = kb.alloc_outputs(pic[9].shape[:2], dev, True)
    ms = time_frame(tb, pic, b_state(pic), out, "KB")
    wave = waves[0]
    maps, bd = b_state(wave)
    one_ms = time_ms(lambda: tb.wave_body(maps, *wave[1:8], bd, *wave[9:]),
                     200)
    bnd = kb_bound(pic, want, direct)
    print(f"KB 1920x1088 B picture of {n_waves} waves: one launch "
          f"{ms:.4f} ms = {1e3 * ms / n_waves:.2f} us a wave; plain "
          f"{pms:.1f} ms; a picture of its widest wave ({n_mbs} lanes) "
          f"alone {one_ms:.4f} ms; bound {bnd['bound_ms']:.6f} ms "
          f"({bnd['bound_by']})")
    return {"KB": dict(err=err, ms=ms, plain_ms=pms, waves=n_waves,
                       ms_wave=ms / n_waves, ms_one_wave=one_ms,
                       lanes=n_mbs, **bnd)}


def band_case(dev) -> tuple:
    """A B picture of one 17-row band of config 4 at 1920 wide (the band
    `TiledEncoder` codes with four bands), through `make_b_encoder` on
    the card with the partitions (synth frames cut to the band's 272
    rows, frame 1 between 0 and 2, QP 30, colocated flags seeded): its
    picture case as the picture starts."""
    from tpu264_torch.coding import b_frame as tb
    from tpu264_torch.coding.wavefront import build_schedule
    from tpu264_torch.media.synth import synth_frame
    sched = build_schedule(BW // 16, 17, 1)
    rows = 16 * 17
    f = [[torch.as_tensor(np.ascontiguousarray(p[:rows // (1 + (i > 0))]),
                          device=dev)
          for i, p in enumerate(synth_frame(BW, BH, t))] for t in range(3)]
    rng = np.random.default_rng(17)
    col = [torch.as_tensor(rng.random(sched.n_mbs) < q, device=dev)
           for q in (0.3, 0.1)]
    enc = tb.make_b_encoder(sched, partitions=True)
    return capture_picture(tb, lambda: enc(*f[1], *f[0], *f[2], *col,
                                           QP + 2))


def check_band(dev) -> dict:
    """KB on a 17-row band's B picture (`band_case`), one launch, against
    `b_frame_plain`, timed a picture and a wave -> the KB row's band
    entries."""
    from tpu264_torch.coding import b_frame as tb
    from tpu264_torch.kernels import b_wave as kb
    pic = band_case(dev)
    err, want, pms, _ = hold_b_picture(pic, "17-row band B picture")
    n_waves = pic[9].shape[0]
    out = kb.alloc_outputs(pic[9].shape[:2], dev, True)
    ms = time_frame(tb, pic, b_state(pic), out, "KB")
    print(f"KB 17-row band B picture (1920 x 272) of {n_waves} waves: one "
          f"launch {ms:.4f} ms = {1e3 * ms / n_waves:.2f} us a wave; plain "
          f"{pms:.1f} ms; max abs err {err}")
    return {"KB": dict(err=err, ms_band=ms, ms_wave_band=ms / n_waves,
                       plain_ms_band=pms, waves_band=n_waves)}


def check_1080p_b_kernels(dev, case) -> dict:
    """K1 on the CABAC records of the 1920x1088 B frame (init table 1, one
    slice) and K4 on its reconstruction with the two-list bS inputs,
    each against its plain version, timed -> extra keys for the K1 and
    K4 rows."""
    from tpu264_torch.coding.wavefront import build_schedule
    from tpu264_torch.entropy import cabac_engine_cuda as k1
    from tpu264_torch.kernels import deblock as kd
    from tpu264_torch.kernels import deblock_wave as k4w
    recs, counts, init, cap_words = case["records"]
    e1, plain_ms = engine_err(recs, counts, init, cap_words,
                              "1080p B frame")
    ms1 = time_ms(lambda: k1.encode_slices(recs, counts, init, cap_words),
                  10)
    n, bins = record_bins(recs, counts)
    print(f"K1 1920x1088 B frame: {n} records, {bins} bins: kernel "
          f"{ms1:.3f} ms, plain (host loop) {plain_ms:.1f} ms")
    a, kw = case["deblock"]
    sched = build_schedule(BW // 16, BH // 16, 1)
    got = kd.make_deblocker_skewed(sched, True)(*a, **kw)
    torch.cuda.synchronize()
    want = kd.make_deblocker_skewed(sched, True, plain=True)(*a, **kw)
    e4 = max(max_abs_err(g, w) for g, w in zip(got, want))
    y, u, v, intra_mb, tc, mv, ref, qp, cqp = a
    bs_v, bs_h = kd.compute_bs_maps(intra_mb.to(torch.bool), tc, mv, ref)
    planes = [p.to(torch.int32, copy=True).contiguous() for p in (y, u, v)]
    n_waves = sched.n_waves
    grids = uniform_grids(qp, cqp, intra_mb.shape, dev)

    def kernel_frame():
        for cp in range(n_waves):
            k4w.deblock_wave(*planes, bs_v, bs_h, cp, *grids)

    ms4 = time_ms(kernel_frame, 10) / n_waves
    print(f"K4 1920x1088 B frame, a wave of {n_waves}: kernel {ms4:.4f} ms")
    return {"K1": dict(err=e1, ms_b_1080p=ms1, bins_b_1080p=bins),
            "K4": dict(err=e4, ms_1080p=ms4)}


class MeCalls:
    """While entered, every call of the motion search's kernel wrappers
    (`me_search.full_search`, KF; `me_subpel.subpel`, KS) is recorded
    with copies of its tensor arguments under the label `at`, then run:
    `calls` lists (label, "KF" or "KS", arguments)."""

    def __init__(self):
        self.calls, self.at, self.real = [], "", []

    def __enter__(self):
        from tpu264_torch.kernels import me_search as kfs
        from tpu264_torch.kernels import me_subpel as ksp
        self.real = []
        for mod, attr, k in ((kfs, "full_search", "KF"),
                             (ksp, "subpel", "KS")):
            fn = getattr(mod, attr)
            self.real.append((mod, attr, fn))

            def spy(*a, _fn=fn, _k=k):
                self.calls.append((self.at, _k,
                                   tuple(clone_state(x) for x in a)))
                return _fn(*a)
            setattr(mod, attr, spy)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self.real:
            setattr(mod, attr, fn)

    def pairs(self) -> list:
        """(label, KF's arguments, KS's arguments) of each list searched,
        in order (a KS call follows its list's KF call); the label gains
        ", list i" where a label searched two lists."""
        kf = [(at, a) for at, k, a in self.calls if k == "KF"]
        ks = [(at, a) for at, k, a in self.calls if k == "KS"]
        if len(kf) != len(ks) or any(x[0] != y[0] for x, y in zip(kf, ks)):
            fail(f"motion search: {len(kf)} KF and {len(ks)} KS calls")
        labels = [at for at, _ in kf]
        out = []
        for (at, a), (_, b) in zip(kf, ks):
            if labels.count(at) > 1:
                at = f"{at}, list {sum(x[0].startswith(at + ',') for x in out)}"
            out.append((at, a, b))
        return out


def seeded_me_cases(dev) -> list:
    """KF's and KS's arguments on seeded 1280x720 pictures, every block of
    `me.SEARCH_BLOCKS`: a noisy reference and a source shifted from it by
    (3, -5) plus noise, at the ME lambdas of QP 0, 28 and 51; flat
    pictures, where every candidate ties, at QP 28's; a 0/255
    checkerboard against its complement (every sample 255 apart at
    (0, 0) and at the even offsets, equal at the odd ones: the largest
    SSDs and SATDs), at QP 0's and 51's; the noisy pictures again with KS
    given full-pel vectors of the search range, +-16 on the border
    macroblocks; and the noisy pictures padded by 3 samples, not 24, so
    that KF's windows at the border are clamped and KS's reads there leave
    the planes (its unstaged branch), with KF's vectors and with the
    border vectors (the last item of a case: KS's vectors, or None for
    KF's plain version's)."""
    from tpu264_torch.coding.intra_frame import LAMBDA_TABLE
    from tpu264_torch.kernels import interp as kint
    from tpu264_torch.kernels import me_subpel as ksp
    rng = np.random.default_rng(41)
    ref = rng.integers(0, 256, (H, W))
    cur = np.clip(np.roll(ref, (3, -5), (0, 1))
                  + rng.integers(-6, 7, (H, W)), 0, 255)
    flat = np.full((H, W), 128)
    yy, xx = np.mgrid[:H, :W]
    chk = 255 * ((yy + xx) & 1)
    shapes = ksp.shapes(True, True)
    names = ksp.names_of(shapes)
    out = []
    for what, c, r, qps in (("noise", cur, ref, (0, 28, 51)),
                            ("flat", flat, flat, (28,)),
                            ("checkerboard", 255 - chk, chk, (0, 51))):
        y = torch.as_tensor(c, dtype=torch.int32, device=dev)
        rp = kint.pad_plane(torch.as_tensor(r, device=dev), 24).contiguous()
        planes = kint.luma_planes(rp).contiguous()
        for qp in qps:
            lam = LAMBDA_TABLE[qp][2]
            kf = (y, rp, 24, 16, lam, W // 16, H // 16, names)
            out.append((f"seeded 720p {what}, QP {qp}", kf,
                        (y, planes, 24, None, lam, W // 16, H // 16, shapes),
                        None))
        if what == "noise":
            mv = border_vectors(rng, len(names), W // 16, H // 16, dev)
            out.append((f"seeded 720p {what}, KS from +-16 at the border", kf,
                        (y, planes, 24, None, lam, W // 16, H // 16, shapes),
                        mv))
            rp = kint.pad_plane(torch.as_tensor(r, device=dev), 3)
            planes = kint.luma_planes(rp.contiguous()).contiguous()
            kf = (y, rp.contiguous(), 3, 16, lam, W // 16, H // 16, names)
            ks = (y, planes, 3, None, lam, W // 16, H // 16, shapes)
            out.append((f"seeded 720p {what}, padding 3, QP 51", kf, ks,
                        None))
            out.append((f"seeded 720p {what}, padding 3, KS from +-16 at "
                        f"the border", kf, ks, mv))
    return out


def border_vectors(rng, n_names: int, wm: int, hm: int, dev):
    """Full-pel vectors [n_names, wm * hm, 2] of the search range, -16 on
    the top row and left column of macroblocks and +16 on the bottom row
    and right column, seeded elsewhere."""
    mv = rng.integers(-16, 17, (n_names, wm * hm, 2))
    mr, mc = np.divmod(np.arange(wm * hm), wm)
    mv[:, mr == 0, 0], mv[:, mr == hm - 1, 0] = -16, 16
    mv[:, mc == 0, 1], mv[:, mc == wm - 1, 1] = -16, 16
    return torch.as_tensor(mv, dtype=torch.int32, device=dev)


def kf_bound(a) -> dict:
    """KF's bound on its arguments `a`: the source and the union of the
    windows read once, the vectors written once.  A quadrant's SSD is
    sum(s^2) + sum(w^2) - 2 sum(s w), and sum(s^2) is the same at every
    candidate, so it leaves the choice unchanged.  The cross terms: 256
    u8 products a candidate on the int8 tensor cores.  On the int32
    lanes: for each sample of the windows' union its square and two
    prefix sums (3), for each position of an 8x8 box in the union its sum
    of w^2 from them (3), shared by the macroblocks whose windows hold
    it; at each candidate a quadrant's sum(w^2) - 2 sum(s w) (1 each), 1
    for the rate's two code lengths, and for each requested block its
    quadrants' sums less one, the rate's add and the compare."""
    from tpu264_torch.kernels import me_search as kfs
    y, _, _, r, _, wm, hm, names = a
    n, span = wm * hm, 2 * r + 1
    uh, uw = 16 * hm + 2 * r, 16 * wm + 2 * r
    n_bytes = 4 * (y.numel() + uh * uw) + 8 * len(names) * n
    per_block = sum(bin(kfs.quad_mask(nm)).count("1") - 1 + 2
                    for nm in names)
    n_ops = 3 * uh * uw + 3 * (uh - 7) * (uw - 7) \
        + n * span * span * (4 + 1 + per_block)
    return bound(n_bytes, n_ops, n * span * span * 256 * 2)


def ks_bound(a) -> dict:
    """KS's bound on its arguments `a`: the source, the four half-pel
    planes and the full-pel vectors read once (the planes in full: an
    upper count of what the vectors reach, far below the operations'
    time), the vectors written once.  Operations on the integer pipe only
    (the plane reads are the bytes' term), over the 17 evaluations a
    block needs: the centre and the 8 step-2 candidates, whose positions
    are full or half pel (one plane sample, no average), and the 8 step-1
    candidates around the step-2 winner, each at a quarter position (the
    average).  A sample: the difference, 4 Hadamard adds or subtracts,
    the absolute value and the sum (7; 8 with the average), each on two
    samples an instruction as 16-bit lane pairs (3.5; 4); a 4x4 block:
    the SATD's rounding (2); a block: the rate (4 a component for its
    code length, 1 multiply-add) and the compare (10)."""
    from tpu264_torch.kernels import me_subpel as ksp
    y, planes, _, _, _, wm, hm, shapes = a
    table = ksp.shape_table(shapes)
    n = wm * hm
    n_bytes = 4 * (y.numel() + planes.numel()) + 16 * len(table) * n
    samples = sum(bh * bw for _, _, bh, bw in table)
    ops = (9 * 7 + 8 * 8) * samples / 2 + 17 * 2 * samples // 16 \
        + 17 * 10 * len(table)
    return bound(n_bytes, n * ops)


def check_me(dev, recorded: MeCalls) -> dict:
    """KF and KS against their plain versions on the card, tolerance 0:
    every list searched while `recorded` was entered (the 720p P pictures
    without and with the default P tools, the weighted golden's first P
    picture with its pre-weighted reference and planes, both lists of the
    1920x1088 B pictures of config 4 and of a 17-row band's B picture),
    the 1080p B picture's lists again without partitions (the MB alone),
    the band's list 0 with KS from vectors of +-16 on its border
    macroblocks, and the seeded pictures of `seeded_me_cases`; KS takes
    its list's vectors from KF's plain version unless a case gives its
    own.  Both timed on the 1080p B picture's list 0 (the row), the 720p
    P picture with the tools and the band -> the KF and KS rows.  Prints
    what `ptxas -v` said of their kernels if this process built them."""
    from tpu264_torch.kernels import _build
    from tpu264_torch.kernels import me_search as kfs
    from tpu264_torch.kernels import me_subpel as ksp
    for stem in ("me_search", "me_subpel"):
        for line in _build.ptxas_log.get(stem, "").splitlines():
            if "entry function" in line or "spill" in line \
                    or "Used" in line:
                print(f"ptxas {stem}: {line.strip()}")
    cases = [(*c, None) for c in recorded.pairs()]
    b_lists = [c for c in cases if c[0].startswith("1080p B picture")]
    if len(b_lists) != 2:
        fail(f"motion search: {len(b_lists)} lists in the 1080p B picture")
    for at, kf, ks, _ in b_lists:
        shapes = ksp.shapes()
        cases.append((f"{at}, no partitions", (*kf[:7], ksp.names_of(shapes)),
                      (*ks[:7], shapes), None))
    at, kf, ks, _ = next(c for c in cases
                         if c[0] == "17-row band B picture, list 0")
    cases.append((f"{at}, KS from +-16 at the border", kf, ks, border_vectors(
        np.random.default_rng(43), len(kf[7]), kf[5], kf[6], dev)))
    cases += seeded_me_cases(dev)
    err = {"KF": 0, "KS": 0}
    for at, kf, ks, mv in cases:
        got = kfs.full_search(*kf)
        want = kfs.full_search_plain(*kf)
        e1 = max_abs_err(got, want)
        ks = (*ks[:3], want if mv is None else mv, *ks[4:])
        got = ksp.subpel(*ks)
        want_q = ksp.subpel_plain(*ks)
        e2 = max_abs_err(got, want_q)
        err["KF"], err["KS"] = max(err["KF"], e1), max(err["KS"], e2)
        moved = int((want != 0).any(dim=2).sum())
        print(f"KF / KS {at}: {len(kf[7])} blocks of {kf[5] * kf[6]} MBs, "
              f"{moved} non-zero full-pel vectors; max abs err {e1} / {e2}")
        if at.startswith("seeded 720p flat") and moved:
            fail("KF: a flat picture's search left (0, 0)")
    timed = {}
    for key, at in (("", "1080p B picture, list 0"),
                    ("_720p_p", "720p P picture, default tools"),
                    ("_band", "17-row band B picture, list 0")):
        kf, ks = next((a, b) for lab, a, b, _ in cases if lab == at)
        ms = {"KF": time_ms(lambda: kfs.full_search(*kf), 20),
              "KS": time_ms(lambda: ksp.subpel(*ks), 20)}
        plain = {"KF": time_ms(lambda: kfs.full_search_plain(*kf), 2),
                 "KS": time_ms(lambda: ksp.subpel_plain(*ks), 2)}
        bnd = {"KF": kf_bound(kf), "KS": ks_bound(ks)}
        for k in ms:
            print(f"{k} {at} ({len(kf[7])} blocks of {kf[5] * kf[6]} MBs): "
                  f"kernel {ms[k]:.4f} ms, plain {plain[k]:.2f} ms, bound "
                  f"{bnd[k]['bound_ms']:.5f} ms ({bnd[k]['bound_by']})")
            t = timed.setdefault(k, {})
            if key:
                t.update({f"ms{key}": ms[k], f"plain_ms{key}": plain[k],
                          f"bound_ms{key}": bnd[k]["bound_ms"]})
            else:
                t.update(ms=ms[k], plain_ms=plain[k], **bnd[k])
    return {k: dict(err=err[k], **timed[k]) for k in ("KF", "KS")}


def phase_p_wave_body_vs_cpu(dev, tools) -> None:
    """One CIF P frame through `make_inter_encoder` with the P `tools` on
    the card and on the CPU: every per-wave output and the recon planes are
    equal.  On the card KP runs once, the whole picture, and K2 never; on
    the CPU the plain version."""
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
    encode = make_inter_encoder(sched, partitions=tools.partitions,
                                p8x8=tools.p8x8, t8=tools.t8)
    before = read_counts()
    out_d, ys_d = encode(*(p.to(dev) for p in planes), QP)
    torch.cuda.synchronize()
    after = read_counts()
    ran = {k: after[k] - before[k]
           for k in ("K2", "K3", "KP", "KF", "KS", "K2_blocks", "K3_blocks")}
    want = {"K2": 0, "K3": 0, "KP": 1, "KF": 1, "KS": 1, "K2_blocks": 0,
            "K3_blocks": 0}
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
    print(f"P wave body, CIF frame of {sched.n_waves} waves, {tools}: card "
          f"equals CPU on {len(worst)} outputs (tolerance 0); "
          f"{int(inter.sum())} inter and {int((~inter).sum())} intra MBs")
    if not inter.any() or inter.all():
        fail("P wave body check: the frame does not mix inter and intra MBs")


class DeblockSpy:
    """While entered, a `Decoder`'s deblocking stage records for each
    picture its K4 launches and its seconds on the card (synchronised);
    the first picture's stage is run again on a copy by a decoder on the
    CPU (the plain version), timed, and must give the same planes."""

    def __init__(self, dec):
        from tpu264_torch.decode import Decoder
        from tpu264_torch.kernels import deblock_wave as k4w
        self.dec, self.k4w, self.pics = dec, k4w, []
        self.cpu = Decoder(device="cpu")
        self.plain_s = None

    def __enter__(self):
        import copy
        real = self.dec._deblock_picture

        def spy(pic):
            twin = copy.copy(pic) if not self.pics else None
            torch.cuda.synchronize()
            before = self.k4w.launches["K4"]
            t0 = time.monotonic()
            real(pic)                    # the planes come back to the host
            secs = time.monotonic() - t0
            n, n_waves = self.k4w.launches["K4"] - before, \
                pic.wm + 2 * (pic.hm - 1)
            if not 1 <= n <= n_waves:
                fail(f"decode: K4 ran {n} times in a picture of {n_waves} "
                     f"waves")
            self.pics.append((n, secs, pic.wm * pic.hm))
            if twin is not None:
                self.cpu.pps = self.dec.pps
                t0 = time.monotonic()
                self.cpu._deblock_picture(twin)
                self.plain_s = time.monotonic() - t0
                for c, a, b in zip("YUV", (pic.y, pic.u, pic.v),
                                   (twin.y, twin.u, twin.v)):
                    if not np.array_equal(a, b):
                        fail(f"decode: the deblocking on the card differs "
                             f"from the CPU's in {c}")

        self.dec._deblock_picture = spy
        return self

    def __exit__(self, *exc):
        del self.dec._deblock_picture


def phase_decode(card: str) -> dict:
    """The port's decoder on the card, closed loop: config 2 (CIF IPPP
    CAVLC), IPPP CABAC at CIF with rate control, config 3's two 720p
    frames and a CIF hierarchical-B GOP with config 4's settings (encoded
    here), each decoded through `Decoder()` (no device named: the card;
    host parse and reconstruction, the deblocking on the card) to the
    encoder's recons, frame for frame.  K4 runs at most once a wave in
    every deblocked picture and nothing else launches; decode seconds a
    frame and ms a MB and the deblocking stage's time on the card (and of
    its plain version on the CPU, first picture) are printed beside the
    card (`card`).  Then an x264 stream with per-MB QPs and filter offsets
    (`tests/data/x264_qcif_aq_deblock.264`) decodes on the card to what
    the decoder on the CPU gives -> the four streams' launch counts."""
    from tpu264_torch.coding.encoder import Encoder
    from tpu264_torch.config import EncoderConfig
    from tpu264_torch.decode import Decoder
    from tpu264_torch.media.synth import synth_frame
    g = golden("bgop_1080p_cabac_rc")
    cfg = EncoderConfig(**{**g["config"], "width": 352, "height": 288})
    enc = Encoder(cfg)
    stream = enc.encode_sequence([synth_frame(352, 288, t)
                                  for t in range(7)])
    ENCODED["bgop_cif"] = (stream, enc.recons)
    kinds = sorted(st.slice_type[0] for st in enc.stats)
    if kinds != ["B"] * 4 + ["I"] + ["P"] * 2:
        fail(f"decode: the CIF B GOP's frames are {kinds}")
    del enc
    cases = (("config2_cif", "config 2, CIF IPPP CAVLC"),
             ("ippp_cif_cabac_rc", "IPPP CABAC at CIF with rate control"),
             ("config3_720p", "config 3, 720p all-intra CABAC"),
             ("bgop_cif", "CIF hierarchical-B GOP, config 4's settings"))
    reset_counts()
    for name, what in cases:
        stream, recons = ENCODED[name]
        dec = Decoder()
        if dec.device.type != "cuda":
            fail(f"decode: Decoder() chose {dec.device}, not the card")
        with DeblockSpy(dec) as spy:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            frames = dec.decode(stream)
            secs = time.monotonic() - t0
        if len(frames) != len(recons) or len(spy.pics) != len(frames):
            fail(f"decode {what}: {len(frames)} frames, {len(spy.pics)} "
                 f"deblocked, {len(recons)} encoded")
        for i, (f, r) in enumerate(zip(frames, recons)):
            for c, a, b in zip("YUV", f, r):
                if a.dtype != np.uint8 or not np.array_equal(
                        a, b.cpu().numpy()):
                    fail(f"decode {what}: frame {i} {c} differs from the "
                         f"encoder's recon")
        n_mbs = sum(m for _, _, m in spy.pics)
        stage = [s for _, s, _ in spy.pics]
        print(f"decode {what} on {card}: {len(frames)} frames equal the "
              f"encoder's recons; {secs:.3f} s, {secs / len(frames):.4f} s a "
              f"frame, {1e3 * secs / n_mbs:.4f} ms a MB; deblocking on the "
              f"card {1e3 * sum(stage) / len(stage):.3f} ms a picture "
              f"({1e3 * min(stage):.3f}-{1e3 * max(stage):.3f}), K4 "
              f"{[n for n, _, _ in spy.pics]} launches; plain version on "
              f"the CPU {1e3 * spy.plain_s:.3f} ms (first picture)")
    counts = read_counts()
    print(f"decode, launches on the path: {counts}")
    if counts["K4"] <= 0 or any(v for k, v in counts.items() if k != "K4"):
        fail(f"decode: launches {counts}, not K4 alone")
    data = (ROOT / "tests" / "data" / "x264_qcif_aq_deblock.264").read_bytes()
    dec = Decoder()
    with DeblockSpy(dec) as spy:
        on_card = dec.decode(data)
    on_cpu = Decoder(device="cpu").decode(data)
    if len(on_card) != len(on_cpu) or not all(
            np.array_equal(a, b) for f, h in zip(on_card, on_cpu)
            for a, b in zip(f, h)):
        fail("decode: the x264 stream with per-MB QPs differs between the "
             "card and the CPU")
    print(f"decode x264 QCIF stream (aq-mode under CRF, deblock=-2,1, B, 2 "
          f"slices): {len(on_card)} frames on the card equal the CPU's; K4 "
          f"{[n for n, _, _ in spy.pics]} launches")
    return counts


def phase_entry() -> dict:
    """`tpu264_torch.runtime.dryrun.entry`: one all-intra QCIF frame on the
    card (K2 + K3 a wave, K4 a wave, CAVLC) equals the same call on the
    CPU, stream and recon -> the card's launch counts."""
    from tpu264_torch.runtime.dryrun import entry
    fn, args = entry("cuda")
    reset_counts()
    stream, recon = fn(*args)
    torch.cuda.synchronize()
    counts = read_counts()
    fn_cpu, args_cpu = entry("cpu")
    want, want_recon = fn_cpu(*args_cpu)
    if stream != want:
        fail("entry: the card's stream differs from the CPU's")
    for c, a, b in zip("YUV", recon, want_recon):
        if a.device.type != "cuda" or not torch.equal(a.cpu(), b):
            fail(f"entry: the card's recon {c} differs from the CPU's")
    print(f"entry (QCIF all-intra CAVLC, QP 28): {len(stream)} bytes, equal "
          f"to the CPU's; launches {counts}")
    for k in ("K2", "K3", "K4"):
        if counts[k] <= 0:
            fail(f"entry: {k} was not launched")
    if counts["KD"] != 1 or counts["KV"] != 1:
        fail(f"entry: KD ran {counts['KD']} times and KV {counts['KV']} "
             f"for one CAVLC frame")
    if any(counts[k] for k in ("K1", "KR", "KP", "KB", "KF", "KS",
                               "K2_blocks", "K3_blocks", "K4_lines")):
        fail(f"entry: launches {counts} outside K2, K3, K4, KD and KV")
    return counts


def phase_dryrun(card: str) -> dict:
    """`dryrun_multichip(4, devices=["cuda"] * 4)`: the band-tiled
    config-4 pipeline (hierarchical B, CABAC, rate control at 2 Mb/s,
    deblocking, halos) at 1280 x 128 over a [2 lanes, 2 bands] mesh laid
    on the one card, every lane's stream decoded on the card to the
    encoder's recons (the function raises otherwise); each lane's SHA-256,
    bytes, frame sizes and QPs held to the golden `dryrun_multichip_4`
    from the reference's dry run -> the launch counts of encode and
    decode (K1, KR, K2, K3, KP, KB, K4, KF and KS each at least once; KF
    and KS once a list of every P and B band picture, KR once a band
    picture)."""
    from tpu264_torch.runtime.dryrun import dryrun_multichip
    g = golden("dryrun_multichip_4")
    reset_counts()
    try:
        res = dryrun_multichip(4, devices=["cuda"] * 4,
                               width=g["config"]["width"])
    except RuntimeError as e:           # a decode that differs, or lost
        fail(str(e))
    counts = read_counts()
    if res["mesh"] != g["mesh"] or res["height"] != g["config"]["height"] \
            or len(res["lanes"]) != len(g["lanes"]):
        fail(f"dryrun: mesh {res['mesh']}, height {res['height']}, "
             f"{len(res['lanes'])} lanes")
    for i, (got, want) in enumerate(zip(res["lanes"], g["lanes"])):
        print(f"dryrun lane {i}: {got['bytes']} bytes, sha256 "
              f"{got['sha256']}, frame bits {got['frame_bits']}, QPs "
              f"{got['frame_qps']}")
        for k in ("sha256", "bytes", "frame_bits", "frame_qps"):
            if got[k] != want[k]:
                fail(f"dryrun lane {i}: {k} {got[k]} != golden {want[k]}")
    n_mbs = (len(res["lanes"]) * res["frames"] * res["width"]
             * res["height"] // 256)
    print(f"dryrun on {card}: {res['width']}x{res['height']}, mesh "
          f"{res['mesh']} on one card; encode {res['encode_seconds']:.3f} s "
          f"(first run), decode on the card {res['decode_seconds']:.3f} s = "
          f"{1e3 * res['decode_seconds'] / n_mbs:.4f} ms a MB, every frame "
          f"equal to the recon; launches {counts}")
    for k in ("K1", "KR", "K2", "K3", "KP", "KB", "K4", "KF", "KS"):
        if counts[k] <= 0:
            fail(f"dryrun: {k} was not launched")
    if counts["KR"] != counts["K1"] or counts["KD"] or counts["KV"]:
        fail(f"dryrun: KR ran {counts['KR']} times for {counts['K1']} CABAC "
             f"band pictures, KD {counts['KD']}, KV {counts['KV']}")
    lists = counts["KP"] + 2 * counts["KB"]
    if counts["KF"] != lists or counts["KS"] != lists:
        fail(f"dryrun: KF ran {counts['KF']} and KS {counts['KS']} times "
             f"for {lists} lists of P and B band pictures")
    if any(counts[k] for k in ("K2_blocks", "K3_blocks", "K4_lines")):
        fail(f"dryrun: slab entries launched: {counts}")
    return counts


def phase_tiled(name: str, what: str) -> dict:
    """Golden `name` through `TiledEncoder` (its "mesh" is [1, bands]):
    one band over `make_mesh(1, gop=1)` (no device named: the card, as
    `bench.py` builds it), or several bands, over that many cards where
    there are, else all on the one card.  Every frame's launches are
    asserted per band: K2 once a wave of each band of the I frame, KP (P)
    or KB (B) once a band, KF and KS once a list of each band (a P frame
    once, a B frame twice), K4 at most once a wave of each band, K1 once a
    band picture, K3 on the I frame only, the slab entries never.  The
    stream, the frame sizes and QPs are held to the golden; then the
    frames/s of the single-device `Encoder` and of the tiled encoder on
    the same frames, both warm, are printed -> the cold run's launches."""
    from tpu264_torch.config import EncoderConfig
    from tpu264_torch.coding.encoder import Encoder
    from tpu264_torch.media.synth import synth_frame
    from tpu264_torch.runtime.tiled import TiledEncoder, make_mesh
    g = golden(name)
    cfg = EncoderConfig(**g["config"])
    frames = [synth_frame(cfg.width, cfg.height, t)
              for t in range(g["frames"])]
    n_bands = g["mesh"][1]
    if n_bands == 1 or torch.cuda.device_count() >= n_bands:
        mesh = make_mesh(n_bands, gop=1)
    else:
        mesh = make_mesh(n_bands, gop=1,
                         devices=[torch.device("cuda", 0)] * n_bands)
    te = TiledEncoder(cfg, mesh)
    if any(d.type != "cuda" for row in te.mesh.devices for d in row):
        fail(f"{what}: the mesh is not on the card")
    per_frame = []
    real = TiledEncoder._frame

    def counted(self, frames_, kind, *a, **kw):
        before = read_counts()
        out = real(self, frames_, kind, *a, **kw)
        after = read_counts()
        per_frame.append((kind, {k: after[k] - before[k] for k in after}))
        return out

    TiledEncoder._frame = counted
    reset_counts()
    try:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        (stream,) = te.encode_sequence([frames])
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
    finally:
        TiledEncoder._frame = real
    counts = read_counts()
    sha = hashlib.sha256(stream).hexdigest()
    print(f"{what}: {n_bands} band(s) of {te.band_hm} MB rows on "
          f"{[str(d) for d in te.mesh.devices[0]]}; {len(frames)} frames "
          f"in {secs:.3f} s = {len(frames) / secs:.4f} frames/s (eager, "
          f"first run); {len(stream)} bytes, sha256 {sha}")
    print(f"{what}, launches on the path: {counts}")
    n_waves = te.band_sched.n_waves
    for i, (kind, c) in enumerate(per_frame):
        print(f"  frame {i} {kind} launches: {c}")
        want = {"K1": n_bands * int(te.cabac),
                "KR": n_bands * int(te.cabac),
                "KD": n_bands * int(not te.cabac),
                "KV": n_bands * int(not te.cabac),
                "K2": n_bands * n_waves if kind == "i" else 0,
                "KP": n_bands * int(kind == "p"),
                "KB": n_bands * int(kind == "b"),
                "KF": n_bands * {"i": 0, "p": 1, "b": 2}[kind],
                "KS": n_bands * {"i": 0, "p": 1, "b": 2}[kind],
                "K2_blocks": 0, "K3_blocks": 0, "K4_lines": 0}
        if kind != "i":
            want["K3"] = 0
        for k, n in want.items():
            if c[k] != n:
                fail(f"{what} frame {i} ({kind}): {k} ran {c[k]} times, not "
                     f"{n} ({n_bands} bands of {n_waves} waves)")
        for k in ("K3", "K4") if kind == "i" else ("K4",):
            if not n_bands <= c[k] <= n_bands * n_waves:
                fail(f"{what} frame {i} ({kind}): {k} ran {c[k]} times for "
                     f"{n_bands} bands of {n_waves} waves")
    if sum(sum(c.values()) for _, c in per_frame) != sum(counts.values()):
        fail(f"{what}: launches outside the frames' band steps")
    stats = te.stats[0]
    for st in stats:
        print(f"  display {st.frame} {st.slice_type}: QP {st.qp}, {st.bits} "
              f"bits, PSNR-Y {st.psnr_y:.3f} dB")
    if [k for k, _ in per_frame] != ["i", "p", "b", "b", "p", "b", "b"]:
        fail(f"{what}: frames {[k for k, _ in per_frame]}")
    if [st.bits for st in stats] != g["frame_bits"]:
        fail(f"{what}: frame bits {[st.bits for st in stats]} != golden "
             f"{g['frame_bits']}")
    if [st.qp for st in stats] != g["frame_qps"]:
        fail(f"{what}: QPs {[st.qp for st in stats]} != golden "
             f"{g['frame_qps']}")
    if sha != g["sha256"] or len(stream) != g["bytes"]:
        fail(f"{what}: stream differs from the reference golden")
    for ry, ru, rv in te.recons[0]:
        if tuple(ry.shape) != (cfg.height, cfg.width) or ry.dtype != \
                torch.uint8 or tuple(ru.shape) != (cfg.height // 2,
                                                   cfg.width // 2):
            fail(f"{what}: recon planes have the wrong shape or type")
    fps = {}
    for label, run in (("Encoder", lambda: Encoder(cfg).encode_sequence(
                           frames)),
                       ("TiledEncoder", lambda: TiledEncoder(
                           cfg, mesh).encode_sequence([frames])[0])):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = run()
        torch.cuda.synchronize()
        fps[label] = len(frames) / (time.monotonic() - t0)
        if label == "TiledEncoder" and out != stream:
            fail(f"{what}: the warm tiled run differs from the first")
    print(f"{what}, warm, same frames, same call: Encoder "
          f"{fps['Encoder']:.4f} frames/s, TiledEncoder ({n_bands} band(s)) "
          f"{fps['TiledEncoder']:.4f} frames/s")
    return counts


def main() -> int:
    t_start = time.monotonic()
    kind, card = phase_device()
    dev = torch.device("cuda")
    sys.path.insert(0, str(ROOT))
    phase_build()
    from tpu264_torch.media.synth import synth_frame
    frames = [synth_frame(W, H, t) for t in range(2)]
    rng = np.random.default_rng(0)
    results = {}
    results.update(check_dct(dev, rng))
    results.update(check_deblock_lines(dev, rng))
    # the CABAC pictures that the K1, KP and KB cases below make: KR's
    records_calls = RecordsCalls()
    with records_calls:
        records_calls.at = "720p"
        k1_result, wave, deblock_case = check_cabac(dev, frames)
    results.update(k1_result)
    results.update(check_i4x4_wave(dev, wave))
    results.update(check_wave_body(dev, wave))
    from tpu264_torch.kernels.p_wave import NO_TOOLS, Tools
    # the lists that the P and B cases below search: KF's and KS's inputs
    me = MeCalls()
    with me:
        me.at = "720p P picture, tools off"
        p_cases = [p_frame_case(dev, NO_TOOLS)]
        me.at = "720p P picture, default tools"
        p_cases.append(p_frame_case(dev, Tools(True, True, True)))
        me.at = "ippp_720p_wp_sei first P picture (weighted reference)"
        with records_calls:
            records_calls.at = "ippp_720p_wp_sei"
            wp_case = wp_frame_case(dev)
    results.update(check_p_wave(dev, p_cases))
    del p_cases
    weighted = check_p_wave_weighted(dev, wp_case)["KP"]
    del wp_case
    results["KP"].update(weighted, err=max(results["KP"]["err"],
                                           weighted["err"]))
    results.update(check_deblock_wave(dev, deblock_case))
    grids = check_deblock_wave_grids(dev)["K4"]
    results["K4"].update(grids, err=max(results["K4"]["err"], grids["err"]))
    # the B wave: a 1920x1088 B frame of config 4 that allows partitions
    # and one that does not
    with me:
        b_cases = []
        for is_ref, label in ((False, "1080p B picture"),
                              (True, "1080p Bref picture")):
            me.at = records_calls.at = label
            with records_calls:
                b_cases.append(b_frame_case(dev, is_ref))
    results.update(check_b_wave(dev, b_cases))
    with me:
        me.at = "17-row band B picture"
        band = check_band(dev)["KB"]
    results["KB"].update(band, err=max(results["KB"]["err"], band["err"]))
    for k, extra in check_1080p_b_kernels(dev, b_cases[0]).items():
        results[k].update(extra, err=max(results[k]["err"], extra["err"]))
    del b_cases
    results.update(check_me(dev, me))
    del me
    results.update(check_kr(dev, records_calls.calls))
    # KV on the CABAC pictures' MB dicts too (an MB dict does not depend
    # on the entropy coder), at the encoders' word cap of 100 a MB
    kv_first = check_kv(
        dev, [(at, pic, mbd, kind, pic.n_mbs // len(pic.rows) * 100, 1)
              for at, pic, mbd, kind, _ in records_calls.calls],
        {("1080p B picture", "b", 1): "b_1080p"}, dense=True)
    del records_calls
    for k, extra in check_batched_intra(dev).items():
        results[k].update(extra, err=max(results[k]["err"], extra["err"]))
    wrong = {k: r["err"] for k, r in sorted(results.items()) if r["err"]}
    if wrong:
        fail(f"kernels differ from their plain versions (max abs err): "
             f"{wrong}")
    print("kernels equal their plain versions (tolerance 0)")
    counts = phase_encode(frames)
    # the CAVLC pictures, bands and chunks of the phases below: KV's
    kv_calls = SerializeCalls()
    with kv_calls:
        kv_calls.at = "config 1"
        phase_config1()
        kv_calls.at = "intra1080"
        counts_i = phase_intra1080(card)
        kv_calls.at = "config 2"
        phase_config2()
        kv_calls.at = "ippp_720p"
        counts_p, _ = phase_ippp("ippp_720p", "IPPP at 720p")
        kv_calls.at = "config2_bench_cif"
        phase_ippp("config2_bench_cif", "config 2 at bench.py's settings "
                   "(CIF, default P tools)")
        kv_calls.at = "ippp_720p_tools"
        counts_t, _ = phase_ippp("ippp_720p_tools", "IPPP at 720p with the "
                                 "default P tools")
        kv_calls.at = "QCIF IPPP, 3 bands"
        counts_tc = phase_tiled_cavlc()
    kv = check_kv(dev, kv_calls.calls,
                  {("intra1080", "i", 4): "chunk4",
                   ("intra1080", "i", 1): "1080p_i",
                   ("ippp_720p_tools", "p", 1): "720p_p",
                   ("ippp_720p", "p", 1): "720p_p_tools_off"})
    del kv_calls
    if kv_first["over"] < 4 or len(kv["timed"]) != 4:
        fail(f"KV: {kv_first['over']} cases over the cap, timed "
             f"{sorted(kv['timed'])}")
    results["KV"] = dict(kv["timed"]["chunk4"],
                         err=max(kv["err"], kv_first["err"]))
    results["KD"] = dict(kv_first["kd"]["b_1080p"],
                         err=max(kv["kd_err"], kv_first["kd_err"]))
    for name, row in list(kv["timed"].items()) + list(
            kv_first["timed"].items()):
        if name != "chunk4":
            for f in ("ms", "plain_ms", "bound_ms", "device_ms",
                      "device_ms_by_kernel"):
                results["KV"][f"{f}_{name}"] = row[f]
    for name, row in list(kv["kd"].items()):
        for f in ("ms", "plain_ms", "bound_ms"):
            results["KD"][f"{f}_{name}"] = row[f]
    parent = kv_parent_times(kv["cases"] + kv_first["cases"])
    if parent:
        results["KV"]["parent_and_this"] = parent
    counts_c, _ = phase_ippp("ippp_720p_cabac", "IPPP CABAC at 720p with "
                             "the default P tools")
    phase_rate_control("ippp_cif_cabac_rc", "IPPP CABAC at CIF with rate "
                       "control at 1 Mb/s")
    counts_b = phase_rate_control(
        "bgop_1080p_cabac_rc", "config 4 at 1920x1088 (hierarchical B, "
        "CABAC, deblock, rate control at 8 Mb/s)",
        kinds=["IDR", "P", "B", "B", "P", "B", "B"])
    counts_t1 = phase_tiled("tiled_bgop_1080p_cabac_rc", "config 4 "
                            "through TiledEncoder, bench.py's mesh")
    counts_t4 = phase_tiled("tiled4_bgop_1080p_cabac_rc", "config 4 "
                            "through TiledEncoder, four bands")
    counts_w = phase_weighted("ippp_720p_wp_sei", "IPPP CABAC at 720p with "
                              "weighted prediction and SEI (fade)")
    counts_g = phase_gop("config5_4k_gop", "config 5 at 3840x2160 "
                         "(GOP-parallel, IPPP CABAC, intra_period 2)", card)
    phase_p_wave_body_vs_cpu(dev, NO_TOOLS)
    phase_p_wave_body_vs_cpu(dev, Tools(True, True, True))
    counts_d = phase_decode(card)
    counts_e = phase_entry()
    counts_r = phase_dryrun(card)
    paths = {"config3_720p": counts, "ippp_720p": counts_p,
             "ippp_720p_tools": counts_t, "ippp_720p_cabac": counts_c,
             "bgop_1080p": counts_b, "tiled_bgop_1080p": counts_t1,
             "tiled4_bgop_1080p": counts_t4, "ippp_720p_wp_sei": counts_w,
             "config5_4k_gop": counts_g, "decode": counts_d,
             "entry": counts_e, "dryrun_multichip_4": counts_r,
             "intra1080_batched": counts_i, "tiled_qcif_cavlc": counts_tc}
    rows = []
    for k in sorted(KERNELS):
        name, source, replaces, _ = KERNELS[k]
        r = results[k]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces,
               "launches": sum(c[k] for c in paths.values()),
               "launches_by_path": {p: c[k] for p, c in paths.items()},
               "max_abs_err": r["err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": None}
        for extra in ("bins", "ms_i_frame", "bins_i_frame", "ms_tools_off",
                      "ms_b_1080p", "bins_b_1080p", "ms_1080p", "body_ms",
                      "lanes", "bytes_ms", "operations_ms", "weighted",
                      "waves", "ms_wave", "ms_one_wave", "ms_wave_tools_off",
                      "ms_weighted", "ms_wave_weighted", "plain_ms_weighted",
                      "bound_ms_weighted", "bound_by_weighted",
                      "ms_band", "ms_wave_band", "plain_ms_band",
                      "waves_band",
                      "ms_720p_p", "plain_ms_720p_p", "bound_ms_720p_p",
                      "mma_ms",
                      "bound_ms_band",
                      "ms_grids_720p", "plain_ms_grids_720p",
                      "bound_ms_grids_720p", "ms_grids_1080p",
                      "plain_ms_grids_1080p", "bound_ms_grids_1080p",
                      "ms_chunk4", "plain_ms_chunk4", "bound_ms_chunk4",
                      "ms_one_picture", "ms_720p_i", "plain_ms_720p_i",
                      "bound_ms_720p_i", "ms_inputs", "device_ms",
                      "kernel_launches", "records", "ms_queue",
                      "host_ms_queue",
                      "device_ms_720p_i", "device_ms_720p_p",
                      "device_ms_weighted", "bits", "plain_ms_b_1080p",
                      "bound_ms_b_1080p", "device_ms_b_1080p",
                      "ms_1080p_i", "plain_ms_1080p_i", "bound_ms_1080p_i",
                      "device_ms_1080p_i", "ms_720p_p_tools_off",
                      "plain_ms_720p_p_tools_off",
                      "bound_ms_720p_p_tools_off",
                      "device_ms_720p_p_tools_off", "device_ms_by_kernel",
                      "device_ms_by_kernel_1080p_i",
                      "device_ms_by_kernel_720p_p",
                      "device_ms_by_kernel_720p_p_tools_off",
                      "device_ms_by_kernel_b_1080p", "ms_chunk4",
                      "plain_ms_chunk4", "bound_ms_chunk4", "ms_1080p_i",
                      "parent_and_this"):
            if extra in r:
                row[extra] = r[extra]
        rows.append(row)
    print(f"chip_smoke.py total: {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

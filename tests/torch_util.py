"""Helpers shared by the `tpu264_torch` equivalence tests.

The tests run the JAX reference (`tpu264`, on the CPU backend) and the
PyTorch port on the same inputs, made from a seed with numpy, and hand
data between them as numpy arrays.  Equality is exact: every stage is
integer math with deterministic decisions.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu264_torch.entropy import cabac_binarize as tcb
from tpu264_torch.entropy import cabac_engine_cuda as k1
from tpu264_torch.tools.synth_inputs import (  # noqa: F401  (re-exported)
    carry_records, long_run_records, random_i4x4_lanes, random_records)

# The port's CPU runs here are thousands of small tensor operations a
# frame, and the suite runs several workers side by side: torch's
# intra-op thread pool only adds synchronisation (a CIF IPPP encode took
# 24.7 s with 8 threads and 11.4 s with one on an 8-core host).
torch.set_num_threads(1)


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def t32(x, device="cpu") -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.int32, device=device)


def assert_equal(got, want, what: str = "") -> None:
    np.testing.assert_array_equal(to_np(got).astype(np.int64),
                                  to_np(want).astype(np.int64), err_msg=what)


def cuda_device() -> torch.device:
    """The card for a `cuda`-marked test; skips the test without one.
    Decided inside the test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda")


def run_engine(slices, table, qp, pad=5, out_cap=8192, device="cpu"):
    """Pack (k, a, b) per slice into [S, cap] and run K1's wrapper on
    `device` -> (words, nbytes, payload bytes per slice)."""
    cap = max(len(k) for k, _, _ in slices) + pad
    recs = np.zeros((len(slices), cap), np.int32)
    for s, (k, a, b) in enumerate(slices):
        recs[s, :len(k)] = to_np(tcb.pack_records(t32(k), t32(a), t32(b)))
    counts = np.array([len(k) for k, _, _ in slices], np.int32)
    init = k1.init_packed_states(table, qp)
    words, nbytes = k1.encode_slices(t32(recs, device), t32(counts, device),
                                     t32(init, device), out_cap)
    return words, nbytes, k1.payloads_from_words(words, nbytes)


# ---- reference encoders.  Building `tpu264`'s Encoder traces, lowers and
# compiles its jitted programs anew (30-45 s a QCIF IPPP encoder on the CPU
# even when the compiled code comes back from the persistent cache, minutes
# when it does not).  `reference_encoder` lets an encoder reuse the programs
# of an earlier one in the same process where both would build the same
# program: each program is keyed by exactly the settings that the code
# building it in `tpu264/coding/encoder.py` reads (the intra, P and B
# encoders, the CAVLC serializers and the CABAC record programs `_crec`,
# whose "b" entry is the B slices', do not read `deblock`; the deblocker
# reads the slice layout and `deblock_idc`).  The reference is imported
# inside the functions: `test_torch_cuda.py` imports this module where jax
# may not be installed.

_REF_PROGRAMS: dict = {}


def reference_encoder(cfg):
    """`tpu264.coding.encoder.Encoder(cfg)` with the programs it shares
    with an earlier reference encoder of this process taken from that
    one."""
    from tpu264.coding.encoder import Encoder
    enc = Encoder(cfg)
    sched = (cfg.width, cfg.height, cfg.slices_per_frame)
    keys = {"_encode_frame": sched,
            "_encode_p": sched + (cfg.search_range, enc.partitions,
                                  enc.t8_mode, enc.wp_mode, enc.p8x8),
            "_encode_b": sched + (cfg.search_range, enc.b_partitions),
            "_deblock": sched + (enc.deblock_idc,),
            "_ser_i": sched + (enc.t8_mode,), "_ser_p": sched,
            "_ser_b": sched, "_crec": sched + (enc.t8_mode,), "_sse3": ()}
    for attr, key in keys.items():
        prog = getattr(enc, attr, None)
        if prog is not None:
            setattr(enc, attr, _REF_PROGRAMS.setdefault((attr, key), prog))
    return enc


# ---- IPPP stream cases (`test_torch_ippp*.py`): one case = one reference
# encoder, the port's encoder on the CPU on the same frames, and the
# comparisons both make.  Cases of one slice layout share the reference's
# programs (`reference_encoder`), so they go in one module.

QCIF_W, QCIF_H = 176, 144


def moving_frames(n: int = 5):
    from tpu264.media.synth import synth_frame
    return [synth_frame(QCIF_W, QCIF_H, t) for t in range(n)]


def encode_both(frames, **kw):
    """QCIF IPPP CAVLC (QP 28, partitions and 8x8 transform off, `kw` on
    top) -> (reference encoder, its stream, port encoder, its stream)."""
    from tpu264.config import EncoderConfig as RefConfig
    from tpu264_torch.coding.encoder import Encoder
    from tpu264_torch.config import EncoderConfig
    base = dict(width=QCIF_W, height=QCIF_H, qp=28, symbol_mode="CAVLC",
                intra_period=0, inter_partitions=False, transform_8x8=False)
    base.update(kw)
    cfg = RefConfig(**base)
    ref = reference_encoder(cfg)
    want = ref.encode_sequence(frames)
    port = Encoder(EncoderConfig.from_reference(dataclasses.asdict(cfg)),
                   device="cpu")
    got = port.encode_sequence(frames)
    return ref, want, port, got


def assert_same_encode(ref, want, port, got):
    """Bytes, per-frame types and sizes, PSNRs and recon planes."""
    assert got == want
    assert [(s.frame, s.slice_type, s.bits) for s in port.stats] == \
        [(s.frame, s.slice_type, s.bits) for s in ref.stats]
    for s, r in zip(port.stats, ref.stats):
        assert (s.psnr_y, s.psnr_u, s.psnr_v) == pytest.approx(
            (r.psnr_y, r.psnr_u, r.psnr_v), abs=1e-9)
    for got_r, want_r in zip(port.recons, ref.recons):
        for g, w in zip(got_r, want_r):
            assert_equal(g, np.asarray(w))


def record_qps(enc) -> list:
    """The list that the QPs `enc`'s rate controller chooses from now on
    are appended to, frame by frame (either package's encoder)."""
    qps = []
    choose = enc.rc.frame_qp

    def spy(*a, **kw):
        qps.append(choose(*a, **kw))
        return qps[-1]

    enc.rc.frame_qp = spy
    return qps


def frame_qp_spy(enc, n_frames: int):
    """Record the slice QP of every frame that `enc` (either package's
    encoder) codes from now on -> a function that gives them in display
    order (a B GOP codes its frames in another order)."""
    from tpu264_torch.coding.encoder import build_bgop_plan
    calls = []
    for attr in ("encode_intra_frame", "encode_p_frame", "encode_b_frame"):
        fn = getattr(enc, attr)

        def spy(*a, _fn=fn, **kw):
            calls.append(kw["qp"])
            return _fn(*a, **kw)

        setattr(enc, attr, spy)

    def in_display_order():
        if enc.gop_mode != "bgop":
            return [int(qp) for qp in calls]
        qps = [None] * n_frames
        plan = build_bgop_plan(n_frames, enc.cfg.num_b_frames,
                               enc.cfg.intra_period)
        for (disp, *_), qp in zip(plan, calls):
            qps[disp] = int(qp)
        return qps
    return in_display_order


def encode_both_rc(ref_cfg, frames, **port_kw):
    """The reference's and the port's (on the CPU) encodes of `frames` with
    `ref_cfg`, which asks for rate control -> (reference encoder, its
    stream, the QPs its rate controller chose, port encoder, its
    stream)."""
    from tpu264_torch.coding.encoder import Encoder
    from tpu264_torch.config import EncoderConfig
    ref = reference_encoder(ref_cfg)
    qps = record_qps(ref)
    want = ref.encode_sequence(frames)
    port = Encoder(EncoderConfig.from_reference(dataclasses.asdict(ref_cfg)),
                   device="cpu", **port_kw)
    return ref, want, qps, port, port.encode_sequence(frames)


def assert_same_rc_encode(ref, want, qps, port, got):
    """`assert_same_encode`, and the port's per-frame QPs are the
    reference's, which move."""
    assert_same_encode(ref, want, port, got)
    assert [s.qp for s in port.stats] == qps
    assert len(set(qps)) >= 2, qps


def assert_decodes_to_recon(port, stream, n_frames: int):
    """Closed loop: the reference decoder reconstructs the port's recon."""
    from tpu264.decode import Decoder
    decoded = Decoder().decode(stream)
    assert len(decoded) == n_frames
    for rec, dec in zip(port.recons, decoded):
        for g, d in zip(rec, dec):
            assert_equal(to_np(g), d)


def decode_both(stream: bytes):
    """The port's decoder on the CPU and the reference decoder on one
    stream: their frames equal array for array and their parsed SEI
    messages field for field.  -> (frames, the port's decoder, and for
    each picture it deblocked: (the number of distinct MB QPs, the filter
    offsets, the deblocking idc))."""
    import dataclasses
    from tpu264.decode import Decoder as RefDecoder
    from tpu264_torch.decode import Decoder
    ref, port = RefDecoder(), Decoder(device="cpu")
    pics = []
    deblock = port._deblock_picture

    def spy(pic):
        pics.append((len(np.unique(pic.qp_mb)), pic.db_off or (0, 0),
                     pic.deblock_idc))
        return deblock(pic)

    port._deblock_picture = spy
    want, got = ref.decode(stream), port.decode(stream)
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        for c, gp, wp in zip("YUV", g, w):
            assert gp.dtype == wp.dtype and gp.shape == wp.shape
            assert_equal(gp, wp, f"frame {i} {c}")
    assert ([dataclasses.asdict(m) for m in port.sei]
            == [dataclasses.asdict(m) for m in ref.sei])
    return got, port, pics


# ---- config 1 stream cases (`test_torch_cavlc_stream.py` for one slice a
# picture, `test_torch_cavlc_slices.py` for three): five QCIF frames,
# all-intra CAVLC at QP 28, through the reference and the port on the
# CPU, each encoded once a process.  The reference encodes them through
# its per-frame path (`TPU264_BATCH=1`), whose programs the other
# reference encoders of the geometry share; its batched entry, which
# compiles a program of its own for each deblock setting and slice
# layout, gives the same stream (the golden "config1_qcif" is its
# output, and `test_golden_config1_matches_reference_encoder` holds the
# per-frame stream to it).

_CAVLC: dict = {}


def cavlc_frames():
    from tpu264.media.synth import synth_frame
    return [synth_frame(QCIF_W, QCIF_H, t) for t in range(5)]


def cavlc_ref_cfg(deblock: bool, slices: int):
    from tpu264.config import EncoderConfig as RefConfig
    return RefConfig(width=QCIF_W, height=QCIF_H, qp=28, symbol_mode="CAVLC",
                     intra_period=1, deblock=deblock, slices_per_frame=slices)


def cavlc_reference(deblock: bool, slices: int):
    """The reference's (encoder, 5-frame stream, stats, recons)."""
    key = ("ref", deblock, slices)
    if key not in _CAVLC:
        enc = reference_encoder(cavlc_ref_cfg(deblock, slices))
        batch = os.environ.get("TPU264_BATCH")
        os.environ["TPU264_BATCH"] = "1"
        try:
            stream = enc.encode_sequence(cavlc_frames())
        finally:
            if batch is None:
                del os.environ["TPU264_BATCH"]
            else:
                os.environ["TPU264_BATCH"] = batch
        _CAVLC[key] = (enc, stream, list(enc.stats),
                       [tuple(np.asarray(p) for p in r) for r in enc.recons])
    return _CAVLC[key]


def cavlc_port(deblock: bool, slices: int, **kw):
    """The port's (5-frame stream, encoder) on the CPU; `kw` goes to its
    Encoder (e.g. `intra_batch`)."""
    from tpu264_torch.coding.encoder import Encoder
    from tpu264_torch.config import EncoderConfig
    key = ("port", deblock, slices, tuple(sorted(kw.items())))
    if key not in _CAVLC:
        cfg = EncoderConfig.from_reference(
            dataclasses.asdict(cavlc_ref_cfg(deblock, slices)))
        enc = Encoder(cfg, device="cpu", **kw)
        _CAVLC[key] = (enc.encode_sequence(cavlc_frames()), enc)
    return _CAVLC[key]


def assert_batched_stream_equals_reference(deblock: bool, slices: int):
    """Bytes, frame types and sizes, PSNRs and recons of the port's batched
    entry against the reference's; a chunk's frames share one time."""
    _, want, ref_stats, ref_recons = cavlc_reference(deblock, slices)
    got, enc = cavlc_port(deblock, slices)
    assert got == want
    assert [(s.frame, s.slice_type, s.bits) for s in enc.stats] == \
        [(s.frame, s.slice_type, s.bits) for s in ref_stats]
    for s, r in zip(enc.stats, ref_stats):
        assert (s.psnr_y, s.psnr_u, s.psnr_v) == pytest.approx(
            (r.psnr_y, r.psnr_u, r.psnr_v), abs=1e-9)
    for got_r, want_r in zip(enc.recons, ref_recons):
        for g, w in zip(got_r, want_r):
            assert_equal(g, w)
    # 4 + 1 frames in chunks of 4 -> two distinct times
    secs = [s.seconds for s in enc.stats]
    assert len(set(secs[:4])) == 1 and all(t > 0 for t in secs)


def assert_port_decodes_to_recon(deblock: bool, slices: int):
    from tpu264.decode import Decoder
    stream, enc = cavlc_port(deblock, slices)
    decoded = Decoder().decode(stream)
    assert len(decoded) == 5
    for rec, dec in zip(enc.recons, decoded):
        for g, d in zip(rec, dec):
            assert_equal(to_np(g), d)


# ---- goldens: a named entry of `tests/data/torch_golden.json` = a config,
# a number of `synth_frame` frames, and the stream's SHA-256, size and
# frame sizes (display order) as the JAX reference encoder gives them; with
# rate control also every frame's QP ("frame_qps", display order).

GOLDEN = Path(__file__).resolve().parent / "data" / "torch_golden.json"


def _check_golden(name: str, encoder_cls, config_cls, **enc_kw):
    from tpu264_torch.media.synth import synth_frame
    golden = json.loads(GOLDEN.read_text())[name]
    cfg = config_cls(**golden["config"])
    frames = [synth_frame(cfg.width, cfg.height, t)
              for t in range(golden["frames"])]
    enc = encoder_cls(cfg, **enc_kw)
    qps = (frame_qp_spy(enc, len(frames)) if "frame_qps" in golden
           else None)
    stream = enc.encode_sequence(frames)
    assert hashlib.sha256(stream).hexdigest() == golden["sha256"]
    assert len(stream) == golden["bytes"]
    assert [s.bits for s in enc.stats] == golden["frame_bits"]
    if "frame_qps" in golden:
        assert qps() == golden["frame_qps"]
    return cfg, enc


def check_golden_reference(name: str):
    """Recompute golden `name` with the reference encoder -> its config."""
    from tpu264.coding.encoder import Encoder
    from tpu264.config import EncoderConfig
    return _check_golden(name, Encoder, EncoderConfig)[0]


def tiled_reference_encode(cfg, n_tiles: int, frames):
    """The reference's `TiledEncoder(cfg, make_mesh(n_tiles, gop=1))` on
    one sequence -> (stream, frame sizes in bits, slice QPs), both in
    display order."""
    from tpu264.coding.encoder import build_bgop_plan
    from tpu264.runtime.tiled import TiledEncoder, make_mesh
    te = TiledEncoder(cfg, make_mesh(n_tiles, gop=1))
    coded = []
    emit = te._emit_frame

    def spy(outs, fins, slice_type, frame_num, qp, **kw):
        n0 = len(outs[0])
        emit(outs, fins, slice_type, frame_num, qp, **kw)
        coded.append((8 * sum(len(b) for b in outs[0][n0:]), int(qp[0])))

    te._emit_frame = spy
    stream = te.encode_sequence([frames])[0]
    order = (range(len(frames)) if te.gop_mode != "bgop" else
             [p[0] for p in build_bgop_plan(len(frames), cfg.num_b_frames,
                                            cfg.intra_period)])
    bits, qps = [None] * len(frames), [None] * len(frames)
    for disp, (b, qp) in zip(order, coded):
        bits[disp], qps[disp] = b, qp
    return stream, bits, qps


def check_golden_tiled_reference(name: str):
    """Recompute tiled golden `name` (its "mesh" is [gop, tile]) with the
    reference's `TiledEncoder` -> (its config, its number of bands)."""
    from tpu264.config import EncoderConfig
    from tpu264.media.synth import synth_frame
    golden = json.loads(GOLDEN.read_text())[name]
    cfg = EncoderConfig(**golden["config"])
    gop, tiles = golden["mesh"]
    assert gop == 1
    frames = [synth_frame(cfg.width, cfg.height, t)
              for t in range(golden["frames"])]
    stream, bits, qps = tiled_reference_encode(cfg, tiles, frames)
    assert hashlib.sha256(stream).hexdigest() == golden["sha256"]
    assert len(stream) == golden["bytes"]
    assert bits == golden["frame_bits"]
    assert qps == golden["frame_qps"]
    return cfg, tiles


def reference_rd_tool():
    """The reference's `tools/rd_harness.py` as a module, imported without
    its side effects on this process (it edits `sys.path` and
    `os.environ`)."""
    import importlib.util
    import sys
    saved_path, saved_env = list(sys.path), dict(os.environ)
    try:
        spec = importlib.util.spec_from_file_location(
            "reference_rd_harness",
            Path(__file__).resolve().parents[1] / "tools" / "rd_harness.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved_path
        os.environ.clear()
        os.environ.update(saved_env)
    return mod


def dryrun_golden(width: int) -> dict:
    """The reference's dry run (`__graft_entry__.dryrun_multichip(4)`'s
    setup) at `width`: its `TiledEncoder` over `make_mesh(4)` (2 lanes x 2
    bands of the virtual CPU devices), lane g coding `synth_frame(w, h, t
    + 7 g)`, t < 5 -> the golden entry: config, mesh, frames and each
    lane's SHA-256, bytes, frame sizes and slice QPs in display order."""
    from tpu264.coding.encoder import build_bgop_plan
    from tpu264.config import EncoderConfig
    from tpu264.media.synth import synth_frame
    from tpu264.runtime.tiled import TiledEncoder, make_mesh
    mesh = make_mesh(4)
    gop, tile = mesh.shape["gop"], mesh.shape["tile"]
    config = dict(width=width, height=64 * tile, qp=30, intra_period=0,
                  num_b_frames=2, symbol_mode="CABAC", deblock=True,
                  rate_control=True, bitrate=2_000_000)
    cfg = EncoderConfig(**config)
    te = TiledEncoder(cfg, mesh)
    coded = []                  # per coded frame: (bits, qp) of each lane
    emit = te._emit_frame

    def spy(outs, fins, slice_type, frame_num, qp, **kw):
        n0 = [len(o) for o in outs]
        emit(outs, fins, slice_type, frame_num, qp, **kw)
        coded.append([(8 * sum(len(b) for b in o[n:]), int(q))
                      for o, n, q in zip(outs, n0, qp)])

    te._emit_frame = spy
    nfr = 5
    streams = te.encode_sequence([[synth_frame(width, cfg.height, t + 7 * g)
                                   for t in range(nfr)] for g in range(gop)])
    order = [p[0] for p in build_bgop_plan(nfr, 2, 0)]
    lanes = []
    for g, s in enumerate(streams):
        bits, qps = [None] * nfr, [None] * nfr
        for disp, lane in zip(order, coded):
            bits[disp], qps[disp] = lane[g]
        lanes.append({"sha256": hashlib.sha256(s).hexdigest(),
                      "bytes": len(s), "frame_bits": bits,
                      "frame_qps": qps})
    return {"config": config, "mesh": [gop, tile], "frames": nfr,
            "lane_stride": 7, "lanes": lanes}


def check_golden_port_on_cpu(name: str):
    """Hold the port's encoder on the CPU to golden `name` -> its config;
    with rate control, its per-frame QPs too."""
    from tpu264_torch.coding.encoder import Encoder
    from tpu264_torch.config import EncoderConfig
    cfg, enc = _check_golden(name, Encoder, EncoderConfig, device="cpu")
    qps = json.loads(GOLDEN.read_text())[name].get("frame_qps")
    if qps is not None:
        assert [s.qp for s in enc.stats] == qps
    return cfg

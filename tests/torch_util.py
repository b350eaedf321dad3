"""Helpers shared by the `tpu264_torch` equivalence tests.

The tests run the JAX reference (`tpu264`, on the CPU backend) and the
PyTorch port on the same inputs, made from a seed with numpy, and hand
data between them as numpy arrays.  Equality is exact: every stage is
integer math with deterministic decisions.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import types
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


@contextlib.contextmanager
def eager_cached():
    """While entered, the reference's eager operations (hundreds of small
    XLA programs a call of its jnp serializers, each compiled in tens of
    ms) are kept in its persistent compilation cache
    (`tpu264/__init__.py`), which by default keeps only programs that took
    2 s or more to compile: with a warm cache they are loaded, not
    compiled again."""
    import jax
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, 0)
    try:
        yield
    finally:
        jax.config.update(key, old)


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


# ---- pinned reference encodes.  `tpu264/` is not edited, so what the
# reference computes for a whole encode of fixed, seeded frames with a
# fixed config is a constant.  `tests/data/torch_reference_pins.json`
# holds it for each case of `REFERENCE_CASES` but `LIVE_CASES`: exactly
# what the port's stream cases compare (the stream's SHA-256 and length,
# each frame's number, type and size, the PSNRs as `repr` of the floats,
# the SHA-256 of every recon plane, the QPs and weights that spies on the
# reference recorded, the encoder's flags and parameter-set fields that
# cases assert), beside the SHA-256 of the `tpu264/` tree it came from
# and the versions of the packages it ran on (`REFERENCE_PACKAGES`).
# Only `tests/test_torch_reference_pins.py` writes the file, from the live
# reference (`python tests/test_torch_reference_pins.py --write`), and its
# `slow` tests derive every pin again and compare.  A case's config and
# frames are defined once, in `REFERENCE_CASES` (`reference_inputs`); it
# takes its reference side from `reference_run`, which checks the tree's
# digest, the package versions, the case's config and its input frames
# against the pin and hands back stand-ins that the assertions read as
# they read the live encoder and stream.

PINS = Path(__file__).resolve().parent / "data" / "torch_reference_pins.json"
REFERENCE_TREE = Path(__file__).resolve().parents[1] / "tpu264"
QCIF = dict(width=176, height=144, qp=28)
# what the reference's output depends on besides its own tree: its float
# arithmetic (PSNRs, the rate controller) runs on these
REFERENCE_PACKAGES = ("jax", "jaxlib", "numpy")


@dataclasses.dataclass(frozen=True)
class RefCase:
    """How a case drives the reference: its `tpu264` EncoderConfig
    arguments; its frames (("synth", n, t0): `synth_frame` at t0 .. t0 +
    n - 1; ("static", n): n copies of the frame at 0; ("fade", n):
    `synth_inputs.fade_frames`); and what the run does besides
    `encode_sequence`: the per-frame path (`TPU264_BATCH=1`), a spy on
    every frame's slice QP (`frame_qp_spy`), the CABAC record cap set to
    `cabac_cap`, or GOP-parallel over `hosts` simulated hosts (the
    gathered stream).  A rate controller's QPs and weighted prediction's
    weights are always recorded."""
    cfg: dict
    frames: tuple
    per_frame: bool = False
    spy_qps: bool = False
    cabac_cap: int | None = None
    hosts: int = 0


def _reference_cases() -> dict:
    ippp = dict(QCIF, symbol_mode="CAVLC", intra_period=0,
                inter_partitions=False, transform_8x8=False, deblock=True,
                slices_per_frame=1)
    tools = dict(width=112, height=80, qp=30, intra_period=0, deblock=True)
    config1 = dict(QCIF, symbol_mode="CAVLC", intra_period=1, deblock=True,
                   slices_per_frame=1)
    bgop = dict(QCIF, intra_period=0, deblock=True, num_b_frames=2,
                symbol_mode="CAVLC")
    cabac = dict(QCIF, symbol_mode="CABAC")
    sei = dict(QCIF, symbol_mode="CAVLC", deblock=True, sei_messages=True)
    s5, s7 = ("synth", 5, 0), ("synth", 7, 0)
    C = RefCase
    cases = {
        # test_torch_ippp.py
        "ippp/deblock": C(ippp, s5),
        "ippp/no_deblock": C(dict(ippp, deblock=False), s5),
        "ippp/period": C(dict(ippp, intra_period=3), s7),
        "ippp/rc_no_bitrate": C(dict(ippp, rate_control=True, bitrate=0),
                                ("synth", 3, 0)),
        # test_torch_ippp_slices.py
        "ippp3/deblock": C(dict(ippp, slices_per_frame=3), s5),
        "ippp3/no_deblock": C(dict(ippp, slices_per_frame=3,
                                   deblock=False), s5),
        "ippp3/static": C(dict(ippp, slices_per_frame=3), ("static", 4)),
        "ippp3/other": C(dict(ippp, slices_per_frame=3), ("synth", 5, 10)),
        # test_torch_ippp_tools.py, test_torch_ippp_cabac.py
        "tools/cavlc": C(dict(tools, symbol_mode="CAVLC"), s5),
        "tools/cavlc_rc": C(dict(tools, symbol_mode="CAVLC",
                                 rate_control=True, bitrate=100_000), s5),
        "tools/cabac": C(dict(tools, symbol_mode="CABAC"), s5),
        "tools/cabac_rc": C(dict(tools, symbol_mode="CABAC",
                                 rate_control=True, bitrate=100_000), s5),
        # test_torch_cavlc_stream.py, _cavlc_slices.py, _cavlc_single.py
        "config1/deblock": C(config1, s5, per_frame=True),
        "config1/no_deblock": C(dict(config1, deblock=False), s5,
                                per_frame=True),
        "config1/rc": C(dict(config1, rate_control=True, bitrate=200_000),
                        s5),
        "config1_3/deblock": C(dict(config1, slices_per_frame=3), s5,
                               per_frame=True),
        "config1_3/no_deblock": C(dict(config1, slices_per_frame=3,
                                       deblock=False), s5, per_frame=True),
        "config1/single_deblock_1": C(config1, ("synth", 1, 0)),
        "config1/single_no_deblock_3": C(dict(config1, deblock=False,
                                              slices_per_frame=3),
                                         ("synth", 1, 0)),
        # test_torch_bgop.py, test_torch_bgop_slices.py
        "bgop/nb2_cavlc": C(bgop, s7, spy_qps=True),
        "bgop/nb2_cabac": C(dict(bgop, symbol_mode="CABAC"), s7,
                            spy_qps=True),
        "bgop/nb2_cabac_rc": C(dict(bgop, symbol_mode="CABAC",
                                    rate_control=True, bitrate=256_000), s7,
                               spy_qps=True),
        "bgop/nb1_cavlc": C(dict(bgop, num_b_frames=1), s5, spy_qps=True),
        "bgop/nb2_cavlc_wp": C(dict(bgop, weighted_pred=True), s7),
        "bgop3/cavlc": C(dict(bgop, slices_per_frame=3), s7, spy_qps=True),
        "bgop3/cabac_rc": C(dict(bgop, slices_per_frame=3,
                                 symbol_mode="CABAC", rate_control=True,
                                 bitrate=256_000), s7, spy_qps=True),
        # test_torch_wp.py
        "wp/cavlc": C(dict(tools, symbol_mode="CAVLC", weighted_pred=True),
                      ("fade", 5)),
        "wp/cabac": C(dict(tools, symbol_mode="CABAC", weighted_pred=True),
                      ("fade", 5)),
        # test_torch_sei.py
        "sei/intra": C(dict(sei, intra_period=1), ("synth", 3, 0),
                       per_frame=True),
        "sei/ippp": C(dict(sei, intra_period=0), ("synth", 3, 0),
                      per_frame=True),
        "sei/bgop": C(dict(sei, intra_period=0, num_b_frames=2),
                      ("synth", 4, 0), per_frame=True),
        # test_torch_gop_parallel.py
        "gop_parallel/two_hosts": C(dict(QCIF, qp=30, intra_period=3),
                                    ("synth", 9, 0), hosts=2),
    }
    # test_torch_encoder.py: all-intra CABAC, 2 frames; the record cap of
    # one record a MB, as the port's `records_per_mb=1` sets it
    for deblock in (True, False):
        for slices in (1, 3):
            name = f"intra_cabac/{'deblock' if deblock else 'no_deblock'}"
            cfg = dict(cabac, deblock=deblock, slices_per_frame=slices)
            cases[f"{name}_{slices}"] = C(cfg, ("synth", 2, 0))
            if deblock == (slices == 1):
                cases[f"{name}_{slices}_cap"] = C(
                    cfg, ("synth", 2, 0), cabac_cap=11 * 9 // slices)
    return cases


REFERENCE_CASES = _reference_cases()
# run live in every Tier-1 run: the QCIF config-1 CAVLC stream
LIVE_CASES = frozenset({"config1/deblock"})
ENCODER_FLAGS = ("gop_mode", "cabac", "partitions", "p8x8", "t8_mode",
                 "wp_mode", "b_partitions", "deblock_idc", "_cabac_cap")
SPS_FIELDS = ("profile_idc", "pic_order_cnt_type", "max_num_ref_frames",
              "num_reorder_frames")
PPS_FIELDS = ("weighted_pred_flag", "transform_8x8_mode_flag")


def plane_sha256(plane) -> str:
    """SHA-256 of a sample plane's shape and values (as int64, so that
    the dtype does not count, as in `assert_equal`)."""
    a = to_np(plane)
    return hashlib.sha256(repr(a.shape).encode() + np.ascontiguousarray(
        a, dtype=np.int64).tobytes()).hexdigest()


def frames_sha256(frames) -> str:
    """SHA-256 of a sequence's planes, frame by frame."""
    return hashlib.sha256("".join(plane_sha256(p) for f in frames
                                  for p in f).encode()).hexdigest()


class PinnedStream:
    """A pinned stream: equal to the bytes whose SHA-256 and length it
    holds (and to a pinned stream of those), and as long."""

    def __init__(self, sha256: str, n: int):
        self.sha256, self.n = sha256, n

    def __eq__(self, other):
        if isinstance(other, PinnedStream):
            return (other.sha256, other.n) == (self.sha256, self.n)
        if not isinstance(other, (bytes, bytearray)):
            return NotImplemented
        return (len(other) == self.n
                and hashlib.sha256(other).hexdigest() == self.sha256)

    def __len__(self):
        return self.n

    def __repr__(self):
        return f"<pinned stream of {self.n} bytes, sha256 {self.sha256}>"


class PinnedPlane:
    """A pinned recon plane: its `plane_sha256`."""

    def __init__(self, sha256: str):
        self.sha256 = sha256

    def __repr__(self):
        return f"<pinned plane, sha256 {self.sha256}>"


def assert_same_plane(got, want, what: str = "") -> None:
    """`assert_equal` against a plane, or against a pinned plane's
    digest."""
    if isinstance(want, PinnedPlane):
        assert plane_sha256(got) == want.sha256, what or want
    else:
        assert_equal(got, np.asarray(want), what)


_TREE: dict = {}


def reference_tree_sha256() -> str:
    """SHA-256 of the reference package: the sorted paths of its `.py`
    and `.c` files and their contents (once a process)."""
    if "sha256" not in _TREE:
        h = hashlib.sha256()
        for path in sorted(REFERENCE_TREE.rglob("*")):
            if path.suffix in (".py", ".c") and path.is_file():
                body = path.read_bytes()
                h.update(f"{path.relative_to(REFERENCE_TREE.parent)}\0"
                         f"{len(body)}\0".encode() + body)
        _TREE["sha256"] = h.hexdigest()
    return _TREE["sha256"]


def reference_packages() -> dict:
    """The installed version of each of `REFERENCE_PACKAGES` (read from
    the package metadata; nothing is imported)."""
    from importlib.metadata import version
    return {name: version(name) for name in REFERENCE_PACKAGES}


_PIN_FILE: dict = {}


def reference_pins() -> dict:
    """Case name -> pin, from `PINS`; raises unless the pins were derived
    from this `tpu264/` tree on these package versions."""
    if not _PIN_FILE:
        _PIN_FILE.update(json.loads(PINS.read_text()))
    again = ("derive the pins again (python "
             "tests/test_torch_reference_pins.py --write)")
    have = reference_tree_sha256()
    assert _PIN_FILE["tpu264_sha256"] == have, (
        f"{PINS.name} was derived from the tpu264 tree "
        f"{_PIN_FILE['tpu264_sha256']}, this tree is {have}: {again}")
    have = reference_packages()
    assert _PIN_FILE["packages"] == have, (
        f"{PINS.name} was derived on {_PIN_FILE['packages']}, this process "
        f"runs {have}: {again}")
    return _PIN_FILE["cases"]


def case_frames(case: RefCase) -> list:
    """The input frames of `case`."""
    from tpu264.media.synth import synth_frame
    w, h = case.cfg["width"], case.cfg["height"]
    kind, n, *t0 = case.frames
    if kind == "synth":
        return [synth_frame(w, h, t + t0[0]) for t in range(n)]
    if kind == "static":
        f = synth_frame(w, h, 0)
        return [tuple(p.copy() for p in f) for _ in range(n)]
    from tpu264_torch.tools.synth_inputs import fade_frames
    assert kind == "fade", kind
    return fade_frames(w, h, n)


def weight_spy(enc) -> list:
    """The (weight, offset) that `enc`'s `_estimate_wp` gives, frame by
    frame (either package's encoder)."""
    seen = []
    estimate = enc._estimate_wp

    def spy(*a):
        seen.append(tuple(int(v) for v in estimate(*a)))
        return seen[-1]

    enc._estimate_wp = spy
    return seen


@contextlib.contextmanager
def per_frame_path(on: bool = True):
    """While entered, the reference encodes all-intra sequences frame by
    frame (`TPU264_BATCH=1`)."""
    batch = os.environ.get("TPU264_BATCH")
    if on:
        os.environ["TPU264_BATCH"] = "1"
    try:
        yield
    finally:
        if batch is None:
            os.environ.pop("TPU264_BATCH", None)
        else:
            os.environ["TPU264_BATCH"] = batch


def _run_live(case: RefCase, cfg, frames):
    """The live reference's run of `case` on `frames` -> (enc, stream,
    qps, rc_qps, wp)."""
    enc = reference_encoder(cfg)
    if case.hosts:
        from tpu264.runtime import gop_scheduler as rgs
        sched = rgs.GopScheduler(len(frames), cfg.intra_period, case.hosts)
        stream = rgs.gather_streams(
            [rgs.encode_host_share(lambda: enc, frames, sched, h)
             for h in range(case.hosts)])
        return types.SimpleNamespace(enc=enc, stream=stream, qps=None,
                                     rc_qps=None, wp=None)
    if case.cabac_cap is not None:
        enc._cabac_cap = case.cabac_cap
    qps = frame_qp_spy(enc, len(frames)) if case.spy_qps else None
    rc_qps = record_qps(enc) if enc.rc is not None else None
    wp = weight_spy(enc) if enc.wp_mode else None
    with per_frame_path(case.per_frame):
        stream = enc.encode_sequence(frames)
    return types.SimpleNamespace(enc=enc, stream=stream,
                                 qps=None if qps is None else qps(),
                                 rc_qps=rc_qps, wp=wp)


def _plain(v):
    return v.item() if isinstance(v, np.generic) else v


def pin_of(run, cfg, frames, hosts: int = 0) -> dict:
    """The pin of a live run (`_run_live`), in JSON's types."""
    enc = run.enc
    pin = {"config": dataclasses.asdict(cfg),
           "input_sha256": frames_sha256(frames),
           "stream_sha256": hashlib.sha256(run.stream).hexdigest(),
           "stream_bytes": len(run.stream)}
    if not hosts:
        pin["frames"] = [[int(s.frame), s.slice_type, int(s.bits)]
                         for s in enc.stats]
        pin["psnr"] = [[repr(float(s.psnr_y)), repr(float(s.psnr_u)),
                        repr(float(s.psnr_v))] for s in enc.stats]
        pin["recons"] = [[plane_sha256(np.asarray(p)) for p in r]
                         for r in enc.recons]
    pin["qps"] = run.qps
    pin["rc_qps"] = (None if run.rc_qps is None
                     else [int(q) for q in run.rc_qps])
    pin["wp"] = None if run.wp is None else [list(w) for w in run.wp]
    pin["encoder"] = {k: _plain(getattr(enc, k, None))
                      for k in ENCODER_FLAGS}
    pin["encoder"]["rc"] = enc.rc is not None
    pin["sps"] = {k: _plain(getattr(enc.sps, k)) for k in SPS_FIELDS}
    pin["pps"] = {k: _plain(getattr(enc.pps, k)) for k in PPS_FIELDS}
    return json.loads(json.dumps(pin))


def reference_inputs(name: str) -> tuple:
    """Case `name` of `REFERENCE_CASES` -> (its `tpu264` EncoderConfig,
    its input frames)."""
    from tpu264.config import EncoderConfig as RefConfig
    case = REFERENCE_CASES[name]
    return RefConfig(**case.cfg), case_frames(case)


def derive_pin(name: str) -> dict:
    """Pin `name` derived from the live reference, on the case's own
    config and frames."""
    case = REFERENCE_CASES[name]
    cfg, frames = reference_inputs(name)
    return pin_of(_run_live(case, cfg, frames), cfg, frames, case.hosts)


def _pinned_run(pin: dict, cfg):
    stats = [types.SimpleNamespace(frame=f, slice_type=t, bits=b,
                                   psnr_y=float(y), psnr_u=float(u),
                                   psnr_v=float(v))
             for (f, t, b), (y, u, v) in zip(pin.get("frames", []),
                                             pin.get("psnr", []))]
    flags = dict(pin["encoder"])
    flags["rc"] = "a rate controller" if flags["rc"] else None
    enc = types.SimpleNamespace(
        cfg=cfg, stats=stats,
        recons=[tuple(PinnedPlane(h) for h in r)
                for r in pin.get("recons", [])],
        sps=types.SimpleNamespace(**pin["sps"]),
        pps=types.SimpleNamespace(**pin["pps"]), **flags)
    return types.SimpleNamespace(
        enc=enc, stream=PinnedStream(pin["stream_sha256"],
                                     pin["stream_bytes"]),
        qps=pin["qps"], rc_qps=pin["rc_qps"],
        wp=None if pin["wp"] is None else [tuple(w) for w in pin["wp"]])


def reference_run(name: str, live: bool = False):
    """The reference's encode of case `name` of `REFERENCE_CASES` -> (cfg
    and frames: its `reference_inputs`; enc, stream, qps: the spied slice
    QPs in display order, rc_qps: the rate controller's QPs, wp: the
    weights, each None where not recorded).  Pinned unless `live`: then
    `enc` stands for the encoder (its stats, recons as `PinnedPlane`s,
    config, flags and parameter-set fields) and `stream` for its bytes
    (`PinnedStream`), after checking the pin's tree, packages, config and
    input frames."""
    case = REFERENCE_CASES[name]
    cfg, frames = reference_inputs(name)
    if live:
        run = _run_live(case, cfg, frames)
    else:
        pin = reference_pins()[name]
        want = json.loads(json.dumps(dataclasses.asdict(cfg)))
        assert pin["config"] == want, \
            f"pin {name}: derived with another config"
        assert pin["input_sha256"] == frames_sha256(frames), \
            f"pin {name}: derived from other frames"
        run = _pinned_run(pin, cfg)
    run.cfg, run.frames = cfg, frames
    return run


# ---- IPPP stream cases (`test_torch_ippp*.py`): one case = the
# reference's pinned encode (`reference_run`), the port's encoder on the
# CPU on the same frames, and the comparisons both make.

QCIF_W, QCIF_H = 176, 144


def port_encoder(ref_cfg, **kw):
    """The port's Encoder on the CPU with the settings of `ref_cfg` (a
    `tpu264` EncoderConfig); `kw` goes to the Encoder."""
    from tpu264_torch.coding.encoder import Encoder
    from tpu264_torch.config import EncoderConfig
    return Encoder(EncoderConfig.from_reference(dataclasses.asdict(ref_cfg)),
                   device="cpu", **kw)


def encode_both(pin: str):
    """The reference's (pinned case `pin`) and the port's (on the CPU)
    encodes of the case's frames with its config -> (reference encoder,
    its stream, port encoder, its stream)."""
    ref = reference_run(pin)
    port = port_encoder(ref.cfg)
    return ref.enc, ref.stream, port, port.encode_sequence(ref.frames)


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
            assert_same_plane(g, w)


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


def encode_both_rc(pin: str):
    """`encode_both` of a case that asks for rate control -> (reference
    encoder, its stream, the QPs its rate controller chose, port encoder,
    its stream)."""
    ref = reference_run(pin)
    port = port_encoder(ref.cfg)
    return (ref.enc, ref.stream, ref.rc_qps, port,
            port.encode_sequence(ref.frames))


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
# per-frame stream to it).  One slice with deblocking is the live
# whole-encode comparison of every Tier-1 run; the other layouts are
# pinned.

_CAVLC: dict = {}


def cavlc_case(deblock: bool, slices: int) -> str:
    """The name of the config-1 case of `REFERENCE_CASES`."""
    return (f"config1{'_3' if slices == 3 else ''}/"
            f"{'deblock' if deblock else 'no_deblock'}")


def cavlc_reference(deblock: bool, slices: int):
    """The reference's (encoder, 5-frame stream, stats, recons): live for
    one slice with deblocking, else pinned."""
    key = ("ref", deblock, slices)
    if key not in _CAVLC:
        name = cavlc_case(deblock, slices)
        run = reference_run(name, live=name in LIVE_CASES)
        _CAVLC[key] = (run.enc, run.stream, list(run.enc.stats),
                       list(run.enc.recons))
    return _CAVLC[key]


def cavlc_port(deblock: bool, slices: int, **kw):
    """The port's (5-frame stream, encoder) on the CPU; `kw` goes to its
    Encoder (e.g. `intra_batch`)."""
    key = ("port", deblock, slices, tuple(sorted(kw.items())))
    if key not in _CAVLC:
        cfg, frames = reference_inputs(cavlc_case(deblock, slices))
        enc = port_encoder(cfg, **kw)
        _CAVLC[key] = (enc.encode_sequence(frames), enc)
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
            assert_same_plane(g, w)
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

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
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu264_torch.entropy import cabac_binarize as tcb
from tpu264_torch.entropy import cabac_engine_cuda as k1
from tpu264_torch.tools.synth_inputs import (  # noqa: F401  (re-exported)
    carry_records, long_run_records, random_i4x4_lanes, random_records)


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


# ---- IPPP stream cases (`test_torch_ippp*.py`): one case = one reference
# encoder (one compile of its P-frame program), the port's encoder on the
# CPU on the same frames, and the comparisons both make.  The reference is
# imported inside the functions: `test_torch_cuda.py` imports this module
# where jax may not be installed.

QCIF_W, QCIF_H = 176, 144


def moving_frames(n: int = 5):
    from tpu264.media.synth import synth_frame
    return [synth_frame(QCIF_W, QCIF_H, t) for t in range(n)]


def encode_both(frames, **kw):
    """QCIF IPPP CAVLC (QP 28, partitions and 8x8 transform off, `kw` on
    top) -> (reference encoder, its stream, port encoder, its stream)."""
    from tpu264.coding.encoder import Encoder as RefEncoder
    from tpu264.config import EncoderConfig as RefConfig
    from tpu264_torch.coding.encoder import Encoder
    from tpu264_torch.config import EncoderConfig
    base = dict(width=QCIF_W, height=QCIF_H, qp=28, symbol_mode="CAVLC",
                intra_period=0, inter_partitions=False, transform_8x8=False)
    base.update(kw)
    cfg = RefConfig(**base)
    ref = RefEncoder(cfg)
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


def assert_decodes_to_recon(port, stream, n_frames: int):
    """Closed loop: the reference decoder reconstructs the port's recon."""
    from tpu264.decode import Decoder
    decoded = Decoder().decode(stream)
    assert len(decoded) == n_frames
    for rec, dec in zip(port.recons, decoded):
        for g, d in zip(rec, dec):
            assert_equal(to_np(g), d)


# ---- goldens: a named entry of `tests/data/torch_golden.json` = a config,
# a number of `synth_frame` frames, and the stream's SHA-256, size and
# frame sizes as the JAX reference encoder gives them.

GOLDEN = Path(__file__).resolve().parent / "data" / "torch_golden.json"


def _check_golden(name: str, encoder_cls, config_cls, **enc_kw):
    from tpu264_torch.media.synth import synth_frame
    golden = json.loads(GOLDEN.read_text())[name]
    cfg = config_cls(**golden["config"])
    frames = [synth_frame(cfg.width, cfg.height, t)
              for t in range(golden["frames"])]
    enc = encoder_cls(cfg, **enc_kw)
    stream = enc.encode_sequence(frames)
    assert hashlib.sha256(stream).hexdigest() == golden["sha256"]
    assert len(stream) == golden["bytes"]
    assert [s.bits for s in enc.stats] == golden["frame_bits"]
    return cfg


def check_golden_reference(name: str):
    """Recompute golden `name` with the reference encoder -> its config."""
    from tpu264.coding.encoder import Encoder
    from tpu264.config import EncoderConfig
    return _check_golden(name, Encoder, EncoderConfig)


def check_golden_port_on_cpu(name: str):
    """Hold the port's encoder on the CPU to golden `name`."""
    from tpu264_torch.coding.encoder import Encoder
    from tpu264_torch.config import EncoderConfig
    return _check_golden(name, Encoder, EncoderConfig, device="cpu")

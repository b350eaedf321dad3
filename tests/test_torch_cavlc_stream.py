"""Config 1 end to end on the CPU: the port's all-intra CAVLC stream
equals the JAX reference encoder's byte for byte at QCIF, QP 28, with
deblocking on and off and 1 and 3 slices, through the batched entry (5
frames in chunks of 4, so the last chunk is short) and with the batched
entry turned off, and the recon equals what the reference decoder
reconstructs from the port's stream.  (A single frame, which both
encoders send down the per-frame path, is in test_torch_cavlc_single.)"""

import dataclasses

import numpy as np
import pytest

from tpu264.coding.encoder import Encoder as RefEncoder
from tpu264.config import EncoderConfig as RefConfig
from tpu264.decode import Decoder
from tpu264.media.synth import synth_frame

from tpu264_torch.coding.encoder import Encoder
from tpu264_torch.config import EncoderConfig

from torch_util import assert_equal, to_np

W, H = 176, 144
FRAMES = [synth_frame(W, H, t) for t in range(5)]
CASES = [(True, 1), (True, 3), (False, 1), (False, 3)]
_REF = {}
_PORT = {}


def _ref_cfg(deblock, slices):
    return RefConfig(width=W, height=H, qp=28, symbol_mode="CAVLC",
                     intra_period=1, deblock=deblock,
                     slices_per_frame=slices)


def _port_cfg(deblock, slices):
    return EncoderConfig.from_reference(
        dataclasses.asdict(_ref_cfg(deblock, slices)))


@pytest.fixture(scope="module")
def reference():
    """Reference (encoder, 5-frame stream, its stats and recons) per case,
    each encoder built (and its programs compiled) once for the module."""
    def get(deblock, slices):
        key = (deblock, slices)
        if key not in _REF:
            enc = RefEncoder(_ref_cfg(deblock, slices))
            stream = enc.encode_sequence(FRAMES)
            _REF[key] = (enc, stream, list(enc.stats),
                         [tuple(np.asarray(p) for p in r)
                          for r in enc.recons])
        return _REF[key]
    return get


def _port(deblock, slices, **kw):
    key = (deblock, slices, tuple(sorted(kw.items())))
    if key not in _PORT:
        enc = Encoder(_port_cfg(deblock, slices), device="cpu", **kw)
        _PORT[key] = (enc.encode_sequence(FRAMES), enc)
    return _PORT[key]


@pytest.mark.parametrize("deblock,slices", CASES)
def test_batched_stream_equals_reference(reference, deblock, slices):
    _, want, ref_stats, ref_recons = reference(deblock, slices)
    got, enc = _port(deblock, slices)
    assert got == want
    assert [(s.frame, s.slice_type, s.bits) for s in enc.stats] == \
        [(s.frame, s.slice_type, s.bits) for s in ref_stats]
    for s, r in zip(enc.stats, ref_stats):
        assert (s.psnr_y, s.psnr_u, s.psnr_v) == pytest.approx(
            (r.psnr_y, r.psnr_u, r.psnr_v), abs=1e-9)
    for got_r, want_r in zip(enc.recons, ref_recons):
        for g, w in zip(got_r, want_r):
            assert_equal(g, w)
    # a chunk's frames share one time: 4 + 1 frames -> two distinct values
    secs = [s.seconds for s in enc.stats]
    assert len(set(secs[:4])) == 1 and all(t > 0 for t in secs)


def test_golden_config1_matches_reference_encoder(reference):
    """`tests/data/torch_golden.json` "config1_qcif" (what `chip_smoke.py`
    holds the card's batched and per-frame streams to) is the reference's
    stream of these five frames with deblocking on and 1 slice."""
    import hashlib
    import json
    from pathlib import Path
    golden = json.loads((Path(__file__).resolve().parent / "data"
                         / "torch_golden.json").read_text())["config1_qcif"]
    ref_enc, want, ref_stats, _ = reference(True, 1)
    assert dataclasses.asdict(ref_enc.cfg) == dataclasses.asdict(
        RefConfig(**golden["config"]))
    assert golden["frames"] == len(FRAMES)
    assert hashlib.sha256(want).hexdigest() == golden["sha256"]
    assert len(want) == golden["bytes"]
    assert [s.bits for s in ref_stats] == golden["frame_bits"]


@pytest.mark.parametrize("deblock,slices", CASES)
def test_per_frame_path_equals_batched(deblock, slices):
    """`intra_batch=1` turns the batched entry off: the same stream."""
    batched, _ = _port(deblock, slices)
    per_frame, enc = _port(deblock, slices, intra_batch=1)
    assert per_frame == batched
    assert len(enc.stats) == len(FRAMES)


@pytest.mark.parametrize("batch", [2, 5, 8])
def test_chunk_size_does_not_change_the_stream(batch):
    want, _ = _port(True, 3)
    got, _ = _port(True, 3, intra_batch=batch)
    assert got == want


@pytest.mark.parametrize("deblock,slices", [(True, 3), (False, 1)])
def test_recon_equals_reference_decoder(deblock, slices):
    stream, enc = _port(deblock, slices)
    decoded = Decoder().decode(stream)
    assert len(decoded) == len(FRAMES)
    for rec, dec in zip(enc.recons, decoded):
        for g, d in zip(rec, dec):
            assert_equal(to_np(g), d)

"""The port's encoder end to end on the CPU: its Annex-B stream equals the
JAX reference encoder's byte for byte (QCIF, 2 frames, all-intra CABAC,
deblock on and off, 1 and 3 slices, and with a slice over the CABAC
record cap), and its recon equals what the reference decoder
reconstructs from the port's stream.  Every port encoder here is built
with `device="cpu"`: without it the port asks for the CUDA card."""

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
FRAMES = [synth_frame(W, H, t) for t in range(2)]
CASES = [(True, 1), (True, 3), (False, 1), (False, 3)]
_REF = {}
_PORT = {}


def _ref_cfg(deblock, slices, **kw):
    return RefConfig(width=W, height=H, qp=28, symbol_mode="CABAC",
                     deblock=deblock, slices_per_frame=slices, **kw)


@pytest.fixture(scope="module")
def reference():
    """Reference (stream, stats, recons, encoder) per case, each encoder
    built (and its programs compiled) once for the module."""
    def get(deblock, slices):
        key = (deblock, slices)
        if key not in _REF:
            enc = RefEncoder(_ref_cfg(deblock, slices))
            stream = enc.encode_sequence(FRAMES)
            _REF[key] = (stream, list(enc.stats),
                         [tuple(np.asarray(p) for p in r)
                          for r in enc.recons], enc)
        return _REF[key]
    return get


def _port_cfg(deblock, slices):
    return EncoderConfig.from_reference(
        dataclasses.asdict(_ref_cfg(deblock, slices)))


def _port(deblock, slices):
    """The port's (stream, encoder) per case, encoded once for the module."""
    key = (deblock, slices)
    if key not in _PORT:
        enc = Encoder(_port_cfg(deblock, slices), device="cpu")
        _PORT[key] = (enc.encode_sequence(FRAMES), enc)
    return _PORT[key]


@pytest.mark.parametrize("deblock,slices", CASES)
def test_stream_bytes_equal_reference(reference, deblock, slices):
    want, ref_stats, ref_recons, _ = reference(deblock, slices)
    got, enc = _port(deblock, slices)
    assert got == want
    assert [s.bits for s in enc.stats] == [s.bits for s in ref_stats]
    for s, r in zip(enc.stats, ref_stats):
        assert (s.psnr_y, s.psnr_u, s.psnr_v) == pytest.approx(
            (r.psnr_y, r.psnr_u, r.psnr_v), abs=1e-9)
    for got_r, want_r in zip(enc.recons, ref_recons):
        for g, w in zip(got_r, want_r):
            assert_equal(g, w)


@pytest.mark.parametrize("deblock,slices", [(True, 1), (False, 3)])
def test_recon_equals_reference_decoder(deblock, slices):
    stream, enc = _port(deblock, slices)
    decoded = Decoder().decode(stream)
    assert len(decoded) == len(FRAMES)
    for rec, dec in zip(enc.recons, decoded):
        for g, d in zip(rec, dec):
            assert_equal(to_np(g), d)


_IPPP_OK = dict(intra_period=0, symbol_mode="CAVLC", inter_partitions=False,
                transform_8x8=False)


@pytest.mark.parametrize("kwargs,what", [
    (dict(intra_period=0), "CABAC P path"),
    (dict(_IPPP_OK, symbol_mode="CABAC"), "CABAC P path"),
    (dict(intra_period=0, symbol_mode="CAVLC"),
     "inter_partitions, transform_8x8 on.*default IPPP tools"),
    (dict(_IPPP_OK, inter_partitions=None), "inter_partitions on"),
    (dict(_IPPP_OK, inter_partitions=True), "inter_partitions on"),
    (dict(_IPPP_OK, transform_8x8=None), "transform_8x8 on"),
    (dict(_IPPP_OK, transform_8x8=True), "transform_8x8 on"),
    (dict(_IPPP_OK, weighted_pred=True), "weighted_pred on"),
    (dict(_IPPP_OK, num_b_frames=1), "hierarchical-B"),
    (dict(rate_control=True, bitrate=100000), "rate control"),
    (dict(symbol_mode="CAVLC", rate_control=True, bitrate=100000),
     "rate control"),
    (dict(sei_messages=True), "SEI"),
])
def test_unported_options_raise(kwargs, what):
    base = dict(width=W, height=H, qp=28, symbol_mode="CABAC")
    base.update(kwargs)
    with pytest.raises(NotImplementedError, match="ROADMAP") as exc:
        Encoder(EncoderConfig(**base), device="cpu")
    import re
    assert re.search(what, str(exc.value)), str(exc.value)


def test_ippp_refusal_says_how_to_ask():
    """The reference turns partitions and the 8x8 transform on by default
    for IPPP; the message names the two fields to pass as False."""
    cfg = EncoderConfig(width=W, height=H, intra_period=0,
                        symbol_mode="CAVLC")
    with pytest.raises(NotImplementedError,
                       match="inter_partitions=False, transform_8x8=False"):
        Encoder(cfg, device="cpu")


@pytest.mark.parametrize("kwargs,mode", [
    (dict(symbol_mode="CAVLC"), "intra"),
    (dict(symbol_mode="CABAC"), "intra"),
    (_IPPP_OK, "ippp"),
    (dict(_IPPP_OK, intra_period=3), "ippp"),
])
def test_ported_options_construct(kwargs, mode):
    enc = Encoder(EncoderConfig(width=W, height=H, **kwargs), device="cpu")
    assert enc.gop_mode == mode
    assert enc.cabac == (kwargs["symbol_mode"] == "CABAC")


def test_default_device_is_cuda():
    """`Encoder(cfg)` asks for the card: where there is none it raises and
    names the device, and does not carry on on the CPU."""
    import torch
    cfg = EncoderConfig(width=W, height=H, qp=28, symbol_mode="CABAC")
    if torch.cuda.is_available():
        assert Encoder(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            Encoder(cfg)


def test_record_cap_overflow_recompacts():
    """A slice over the record cap raises nothing: the encoder compacts
    the slice again at its true size and the stream is the one the full
    buffer gives."""
    enc = Encoder(_port_cfg(True, 1), device="cpu", records_per_mb=1)
    assert enc._cabac_cap == (W // 16) * (H // 16)
    assert enc.encode_sequence(FRAMES[:1]) == \
        Encoder(_port_cfg(True, 1), device="cpu").encode_sequence(FRAMES[:1])


@pytest.mark.parametrize("deblock,slices", [(True, 1), (False, 3)])
def test_record_cap_overflow_equals_reference(reference, deblock, slices):
    """Every slice needs more records than the cap (1 a MB): the port's
    stream equals the reference's, both from its device record path and
    from the host path the reference takes past its own cap."""
    want, _, _, ref_enc = reference(deblock, slices)
    enc = Encoder(_port_cfg(deblock, slices), device="cpu", records_per_mb=1)
    got = enc.encode_sequence(FRAMES)
    assert got == want
    cap = ref_enc._cabac_cap
    ref_enc._cabac_cap = enc._cabac_cap
    try:
        assert RefEncoder.encode_sequence(ref_enc, FRAMES) == got
    finally:
        ref_enc._cabac_cap = cap

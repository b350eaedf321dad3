"""Hierarchical-B GOPs with three slices a picture on the CPU: the port's
stream equals the JAX reference encoder's byte for byte (QCIF,
`num_b_frames=2`, 7 frames, CAVLC, deblocking inside each slice, idc 2),
with the same recon planes and frame types and sizes in display order.
Its own module: the reference's programs of a three-slice picture are
not those of `test_torch_bgop.py`'s one-slice cases.

The port's band-tiled encoder (`TiledEncoder`, three bands of three MB
rows on the CPU) writes the same stream; with CABAC and JVT-G012 rate
control its frames' QPs are the reference's too, and so are its bytes
when every band overflows its CABAC record cap.  The reference's tiled
encoder writes its three-slice stream in these cases (with CAVLC and
CABAC, `tests/test_sharded.py`; with rate control as well: the lane's
controller counts the same NAL units and the same luma MAD), so the
tiled cases are held to the same pinned encodes
(`torch_util.reference_run`)."""

import dataclasses
import types


from tpu264_torch.coding.encoder import Encoder
from tpu264_torch.config import EncoderConfig
from tpu264_torch.runtime.tiled import TiledEncoder, make_mesh

from torch_util import (assert_same_encode, frames_sha256, reference_inputs,
                        reference_run)

KINDS = ["IDR", "Bref", "B", "P", "Bref", "B", "P"]
FRAMES = reference_inputs("bgop3/cavlc")[1]
_REF: dict = {}


def _reference(symbol_mode: str, rc: bool):
    """The reference's three-slice (encoder, config, stream, per-frame
    QPs in display order) of `FRAMES`, once a process."""
    key = (symbol_mode, rc)
    if key not in _REF:
        run = reference_run(f"bgop3/{symbol_mode.lower()}"
                            f"{'_rc' if rc else ''}")
        assert frames_sha256(run.frames) == frames_sha256(FRAMES)
        _REF[key] = (run.enc, run.cfg, run.stream, run.qps)
    return _REF[key]


def _tiled(cfg, **attrs):
    """The port's `TiledEncoder` with three bands on the CPU and `cfg`'s
    settings (one slice: the bands are the slices) -> (stream, encoder);
    `attrs` are set on the encoder first."""
    te = TiledEncoder(EncoderConfig.from_reference(
        dict(dataclasses.asdict(cfg), slices_per_frame=1)),
        make_mesh(3, gop=1, devices=["cpu"] * 3))
    assert te.gop_mode == "bgop" and te.deblock_idc == 2
    for k, v in attrs.items():
        setattr(te, k, v)
    return te.encode_sequence([FRAMES])[0], te


def _port_view(te):
    """The tiled encoder's lane, in the shape `assert_same_encode` reads."""
    return types.SimpleNamespace(stats=te.stats[0], recons=te.recons[0])


def test_three_slice_bgop_stream_equals_reference():
    ref, cfg, want, _ = _reference("CAVLC", False)
    port = Encoder(EncoderConfig.from_reference(dataclasses.asdict(cfg)),
                   device="cpu")
    assert port.deblock_idc == ref.deblock_idc == 2
    got = port.encode_sequence(FRAMES)
    assert_same_encode(ref, want, port, got)
    assert [s.slice_type for s in port.stats] == KINDS


def test_three_band_tiled_bgop_equals_reference():
    ref, cfg, want, qps = _reference("CAVLC", False)
    got, te = _tiled(cfg)
    assert_same_encode(ref, want, _port_view(te), got)
    assert [s.slice_type for s in te.stats[0]] == KINDS
    assert [s.qp for s in te.stats[0]] == qps


def test_three_band_tiled_bgop_cabac_rc_equals_reference():
    ref, cfg, want, qps = _reference("CABAC", True)
    got, te = _tiled(cfg)
    assert te.cabac and len(te.rcs) == 1
    assert_same_encode(ref, want, _port_view(te), got)
    # every frame's QP, and the controller's move
    assert [s.qp for s in te.stats[0]] == qps and len(set(qps)) >= 3


def test_tiled_cabac_record_cap_overflow_equals_reference():
    """Every band over its CABAC record cap (1): the bands' records are
    compacted again at their true size, and the stream is the uncapped
    one (the reference re-encodes such a band on the host)."""
    _, cfg, want, _ = _reference("CABAC", True)
    got, te = _tiled(cfg, _cabac_cap=1)
    assert got == want

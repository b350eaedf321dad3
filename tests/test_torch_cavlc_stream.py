"""Config 1 end to end on the CPU, one slice a picture: the port's
all-intra CAVLC stream equals the JAX reference encoder's byte for byte at
QCIF, QP 28, with deblocking on and off, through the batched entry (5
frames in chunks of 4, so the last chunk is short) and with the batched
entry turned off, and the recon equals what the reference decoder
reconstructs from the port's stream.  (Three slices a picture are in
test_torch_cavlc_slices; a single frame, which both encoders send down the
per-frame path, is in test_torch_cavlc_single.)  With rate control and a
bitrate both encoders leave the batched entry and encode frame by frame,
with the same stream and QPs.  The reference's stream with deblocking is
encoded live in every run; the others are pinned
(`torch_util.reference_run`)."""

import dataclasses
import hashlib
import json
from pathlib import Path

import pytest

from tpu264.config import EncoderConfig as RefConfig

from torch_util import (assert_batched_stream_equals_reference,
                        assert_port_decodes_to_recon, assert_same_encode,
                        cavlc_port, cavlc_reference, encode_both_rc,
                        reference_inputs)

CASES = [(True, 1), (False, 1)]


@pytest.mark.parametrize("deblock,slices", CASES)
def test_batched_stream_equals_reference(deblock, slices):
    assert_batched_stream_equals_reference(deblock, slices)


def test_golden_config1_matches_reference_encoder():
    """`tests/data/torch_golden.json` "config1_qcif" (what `chip_smoke.py`
    holds the card's batched and per-frame streams to) is the reference's
    stream of these five frames with deblocking on and 1 slice: the
    golden came from the reference's batched entry, the stream here from
    its per-frame path."""
    golden = json.loads((Path(__file__).resolve().parent / "data"
                         / "torch_golden.json").read_text())["config1_qcif"]
    ref_enc, want, ref_stats, _ = cavlc_reference(True, 1)
    assert dataclasses.asdict(ref_enc.cfg) == dataclasses.asdict(
        RefConfig(**golden["config"]))
    assert golden["frames"] == len(reference_inputs("config1/deblock")[1])
    assert hashlib.sha256(want).hexdigest() == golden["sha256"]
    assert len(want) == golden["bytes"]
    assert [s.bits for s in ref_stats] == golden["frame_bits"]


@pytest.mark.parametrize("deblock,slices", CASES)
def test_per_frame_path_equals_batched(deblock, slices):
    """`intra_batch=1` turns the batched entry off: the same stream."""
    batched, _ = cavlc_port(deblock, slices)
    per_frame, enc = cavlc_port(deblock, slices, intra_batch=1)
    assert per_frame == batched
    assert len(enc.stats) == 5


@pytest.mark.parametrize("deblock,slices", [(False, 1)])
def test_recon_equals_reference_decoder(deblock, slices):
    assert_port_decodes_to_recon(deblock, slices)


def test_rate_control_stream_equals_reference():
    """All-intra with rate control: the controller keeps every I frame at
    its initial QP (the reference's `frame_qp("I")`), and the port, like
    the reference, takes the per-frame path."""
    ref, want, qps, port, got = encode_both_rc("config1/rc")
    assert_same_encode(ref, want, port, got)
    assert qps == [s.qp for s in port.stats] == [28] * 5
    # a frame at a time: each frame has a time of its own
    assert len({s.seconds for s in port.stats}) == 5

"""Config 1, a sequence of one frame: both encoders send it down the
per-frame path (the batched entry needs two frames), and the port's
all-intra CAVLC stream equals the JAX reference's (pinned,
`torch_util.reference_run`) byte for byte (QCIF, QP 28)."""

import dataclasses

import pytest


from tpu264_torch.coding.encoder import Encoder
from tpu264_torch.config import EncoderConfig

from torch_util import reference_run

@pytest.mark.parametrize("deblock,slices", [(True, 1), (False, 3)])
def test_single_frame_takes_the_per_frame_path(deblock, slices):
    run = reference_run(
        f"config1/single_{'deblock' if deblock else 'no_deblock'}_{slices}")
    want, frames = run.stream, run.frames
    assert len(frames) == 1
    enc = Encoder(EncoderConfig.from_reference(dataclasses.asdict(run.cfg)),
                  device="cpu")
    called = []
    batched = enc._encode_sequence_intra_batched
    enc._encode_sequence_intra_batched = \
        lambda *a: called.append(a) or batched(*a)
    assert enc.encode_sequence(iter(frames)) == want
    assert not called and len(enc.stats) == 1

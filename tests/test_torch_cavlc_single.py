"""Config 1, a sequence of one frame: both encoders send it down the
per-frame path (the batched entry needs two frames), and the port's
all-intra CAVLC stream equals the JAX reference's byte for byte (QCIF,
QP 28)."""

import dataclasses

import pytest

from tpu264.config import EncoderConfig as RefConfig
from tpu264.media.synth import synth_frame

from tpu264_torch.coding.encoder import Encoder
from tpu264_torch.config import EncoderConfig

from torch_util import reference_encoder

W, H = 176, 144
FRAMES = [synth_frame(W, H, 0)]


@pytest.mark.parametrize("deblock,slices", [(True, 1), (False, 3)])
def test_single_frame_takes_the_per_frame_path(deblock, slices):
    ref_cfg = RefConfig(width=W, height=H, qp=28, symbol_mode="CAVLC",
                        intra_period=1, deblock=deblock,
                        slices_per_frame=slices)
    want = reference_encoder(ref_cfg).encode_sequence(FRAMES)
    enc = Encoder(EncoderConfig.from_reference(dataclasses.asdict(ref_cfg)),
                  device="cpu")
    called = []
    batched = enc._encode_sequence_intra_batched
    enc._encode_sequence_intra_batched = \
        lambda *a: called.append(a) or batched(*a)
    assert enc.encode_sequence(iter(FRAMES)) == want
    assert not called and len(enc.stats) == 1

"""Hierarchical-B GOPs with three slices a picture on the CPU: the port's
stream equals the JAX reference encoder's byte for byte (QCIF,
`num_b_frames=2`, 7 frames, CAVLC, deblocking inside each slice, idc 2),
with the same recon planes and frame types and sizes in display order.
Its own module: the reference's programs of a three-slice picture are
not those of `test_torch_bgop.py`'s one-slice cases."""

import dataclasses

from tpu264.config import EncoderConfig as RefConfig

from tpu264_torch.coding.encoder import Encoder
from tpu264_torch.config import EncoderConfig

from torch_util import (QCIF_H, QCIF_W, assert_same_encode, moving_frames,
                        reference_encoder)


def test_three_slice_bgop_stream_equals_reference():
    frames = moving_frames(7)
    cfg = RefConfig(width=QCIF_W, height=QCIF_H, qp=28, intra_period=0,
                    num_b_frames=2, symbol_mode="CAVLC", deblock=True,
                    slices_per_frame=3)
    ref = reference_encoder(cfg)
    want = ref.encode_sequence(frames)
    port = Encoder(EncoderConfig.from_reference(dataclasses.asdict(cfg)),
                   device="cpu")
    assert port.deblock_idc == ref.deblock_idc == 2
    got = port.encode_sequence(frames)
    assert_same_encode(ref, want, port, got)
    assert [s.slice_type for s in port.stats] == \
        ["IDR", "Bref", "B", "P", "Bref", "B", "P"]

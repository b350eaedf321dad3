"""IPPP with CABAC on the CPU: the port's stream with the reference's
default P tools (16x8/8x16, P_8x8, the 8x8 transform) equals the JAX
reference encoder's byte for byte and decodes to the port's recon; with
JVT-G012 rate control at a bitrate where the reference's QPs move, the
stream and every frame's QP are the reference's too.  The geometry and settings are
those of `tests/test_ippp.py::test_p8x8_sub_mb_tree_roundtrip[CABAC]`
(112x80, QP 30, deblock on, 5 frames); the reference's encodes are
pinned (`torch_util.reference_run`)."""

import dataclasses

import numpy as np


from tpu264_torch.coding.encoder import Encoder
from tpu264_torch.coding.intra_frame import reorder_wave_outputs
from tpu264_torch.config import EncoderConfig

from torch_util import (assert_decodes_to_recon, assert_same_encode,
                        assert_same_rc_encode, encode_both_rc,
                        reference_run, to_np)

def test_cabac_stream_equals_reference():
    run = reference_run("tools/cabac")
    ref, want, frames = run.enc, run.stream, run.frames
    assert ref.cabac and ref.partitions and ref.p8x8 and ref.t8_mode
    port = Encoder(EncoderConfig.from_reference(dataclasses.asdict(run.cfg)),
                   device="cpu")
    assert port.cabac and port.partitions and port.p8x8 and port.t8_mode
    chosen = []
    inner = port._encode_p

    def spy(*args):
        out, ys = inner(*args)
        mb = reorder_wave_outputs(port.sched, ys)
        inter = to_np(mb["is_inter"]).astype(bool)
        chosen.append((to_np(mb["ptype"])[inter], to_np(mb["t8"])[inter]))
        return out, ys

    port._encode_p = spy
    got = port.encode_sequence(frames)
    assert_same_encode(ref, want, port, got)
    assert [s.slice_type for s in port.stats] == ["IDR"] + ["P"] * 4
    assert_decodes_to_recon(port, got, len(frames))
    ptypes = np.concatenate([p for p, _ in chosen])
    t8 = np.concatenate([t for _, t in chosen])
    assert set(ptypes) == {0, 1, 2, 3}
    assert t8.any() and (~t8 & (ptypes == 0)).any()


def test_rate_control_stream_equals_reference():
    assert_same_rc_encode(*encode_both_rc("tools/cabac_rc"))

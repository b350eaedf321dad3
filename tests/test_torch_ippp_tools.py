"""Config 2 with the reference's default P tools on the CPU: the port's
IPPP CAVLC stream with 16x8/8x16 partitions, P_8x8 and the 8x8 transform
(the config leaves `inter_partitions` and `transform_8x8` at their
defaults, which turn them on for IPPP) equals the JAX reference encoder's
byte for byte, with deblocking on, and each partition type and the 8x8
transform are chosen in it.  The geometry and settings are those of
`tests/test_ippp.py::test_p8x8_sub_mb_tree_roundtrip` (112x80, QP 30,
5 frames); the reference's encodes are pinned
(`torch_util.reference_run`).  With JVT-G012 rate control at a bitrate
where the reference's QPs move, the stream and every frame's QP are the
reference's too."""

import dataclasses

import numpy as np


from tpu264_torch.coding.encoder import Encoder
from tpu264_torch.coding.intra_frame import reorder_wave_outputs
from tpu264_torch.config import EncoderConfig

from torch_util import assert_decodes_to_recon, assert_same_encode, \
    assert_same_rc_encode, encode_both_rc, reference_run, to_np


def test_default_tools_stream_equals_reference():
    run = reference_run("tools/cavlc")
    cfg, frames, ref, want = run.cfg, run.frames, run.enc, run.stream
    assert ref.partitions and ref.p8x8 and ref.t8_mode
    port = Encoder(EncoderConfig.from_reference(dataclasses.asdict(cfg)),
                   device="cpu")
    assert port.partitions and port.p8x8 and port.t8_mode
    assert port.sps.profile_idc == 100 and port.pps.transform_8x8_mode_flag
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
    assert_decodes_to_recon(port, got, len(frames))
    ptypes = np.concatenate([p for p, _ in chosen])
    t8 = np.concatenate([t for _, t in chosen])
    assert set(ptypes) == {0, 1, 2, 3}
    assert t8.any() and (~t8 & (ptypes == 0)).any()


def test_rate_control_stream_equals_reference():
    assert_same_rc_encode(*encode_both_rc("tools/cavlc_rc"))

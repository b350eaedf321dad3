"""IPPP CAVLC with a periodic IDR (`intra_period=3`) and on static
content, port against the JAX reference, byte for byte at QCIF: the
IDR/P schedule, `frame_num` restarting after each IDR, `idr_pic_id`
alternating by IDR count, and slices that are one skip run from end to
end (whose run the host appends)."""

import pytest

from tpu264.bits.nal import split_annexb
from tpu264.media.synth import synth_frame

from torch_util import QCIF_H as H, QCIF_W as W
from torch_util import (assert_decodes_to_recon, assert_same_encode,
                        encode_both, moving_frames)

_CASE = {}


def _static_frames(n=4):
    f = synth_frame(W, H, 0)
    return [tuple(p.copy() for p in f) for _ in range(n)]


@pytest.fixture(scope="module")
def case():
    def get(name):
        if name not in _CASE:
            if name == "period":
                _CASE[name] = encode_both(moving_frames(7), deblock=True,
                                          slices_per_frame=1, intra_period=3)
            else:
                _CASE[name] = encode_both(_static_frames(), deblock=True,
                                          slices_per_frame=3)
        return _CASE[name]
    return get


def test_periodic_idr_stream_equals_reference(case):
    ref, want, port, got = case("period")
    assert_same_encode(ref, want, port, got)
    assert [s.slice_type for s in port.stats] == \
        ["IDR", "P", "P", "IDR", "P", "P", "IDR"]
    assert_decodes_to_recon(port, got, 7)


def test_static_content_skips(case):
    """P frames of a static sequence are almost all P_Skip: a fraction of
    the IDR frame's bits, and slices that are one skip run from end to
    end, with no MB data from the device and the run written by the host
    after the header."""
    ref, want, port, got = case("static")
    assert_same_encode(ref, want, port, got)
    assert all(s.bits < port.stats[0].bits // 4 for s in port.stats[1:])
    p_slices = [rbsp for _, typ, rbsp in split_annexb(got) if typ == 1]
    assert len(p_slices) == 3 * 3
    # header + mb_skip_run = ue(33) and the trailing bits: 5 bytes
    assert min(len(r) for r in p_slices) == 5
    assert_decodes_to_recon(port, got, 4)


def test_static_stream_has_three_slices_a_frame(case):
    _, _, _, got = case("static")
    assert [typ for _, typ, _ in split_annexb(got)] == \
        [7, 8] + [5] * 3 + [1] * 9


def test_frame_num_wraps():
    """`frame_num` restarts at 1 after the IDR and wraps at
    1 << log2_max_frame_num (port only: the schedule's arithmetic, with
    the P-frame encode stubbed out)."""
    from tpu264_torch.coding.encoder import Encoder
    from tpu264_torch.config import EncoderConfig
    enc = Encoder(EncoderConfig(width=W, height=H, symbol_mode="CAVLC",
                                intra_period=0, inter_partitions=False,
                                transform_8x8=False), device="cpu")
    seen = []

    def stub(y, u, v, ref, frame_num):
        seen.append(frame_num)
        return (lambda: []), ref

    enc.encode_p_frame = stub
    enc.sps.log2_max_frame_num = 4          # wrap after 16 frames
    enc.encode_sequence(_static_frames(19))
    assert seen == list(range(1, 16)) + [0, 1, 2]

"""Config 2 end to end on the CPU, one slice a picture: the port's IPPP
CAVLC stream (full-search 16x16 ME, quarter-pel refinement, P_Skip /
16x16 / I16x16 / I4x4) equals the JAX reference encoder's byte for byte at
QCIF with deblocking on and off (5 frames) and with a periodic IDR
(`intra_period=3`, 7 frames: the IDR/P schedule, `frame_num` restarting
after each IDR, `idr_pic_id` alternating by IDR count), and decodes to the
port's recon; rate control asked for without a bitrate encodes at fixed
QP, as the reference does.  The reference's encodes are pinned
(`torch_util.reference_run`; three slices: `test_torch_ippp_slices.py`)."""

import pytest

from torch_util import QCIF_H as H, QCIF_W as W
from torch_util import (assert_decodes_to_recon, assert_same_encode,
                        encode_both)

_CASE = {}


@pytest.fixture(scope="module")
def case():
    def get(name):
        if name not in _CASE:
            if name == "period":
                _CASE[name] = encode_both("ippp/period")
            else:
                _CASE[name] = encode_both(
                    "ippp/deblock" if name else "ippp/no_deblock")
        return _CASE[name]
    return get


@pytest.mark.parametrize("deblock", [True, False])
def test_stream_bytes_equal_reference(case, deblock):
    ref, want, port, got = case(deblock)
    assert_same_encode(ref, want, port, got)
    assert [s.slice_type for s in port.stats] == ["IDR"] + ["P"] * 4


@pytest.mark.parametrize("deblock", [True, False])
def test_recon_equals_reference_decoder(case, deblock):
    _, _, port, got = case(deblock)
    assert_decodes_to_recon(port, got, 5)


def test_periodic_idr_stream_equals_reference(case):
    ref, want, port, got = case("period")
    assert_same_encode(ref, want, port, got)
    assert [s.slice_type for s in port.stats] == \
        ["IDR", "P", "P", "IDR", "P", "P", "IDR"]
    assert_decodes_to_recon(port, got, 7)


def test_rate_control_without_bitrate_is_fixed_qp():
    """`rate_control=True` with `bitrate=0` (what a JM file with
    RateControlEnable = 1 and no Bitrate parses to): the reference runs no
    rate controller, and neither does the port."""
    ref, want, port, got = encode_both("ippp/rc_no_bitrate")
    assert ref.cfg.rate_control and ref.cfg.bitrate == 0
    assert ref.rc is None
    assert_same_encode(ref, want, port, got)


def test_frame_num_wraps():
    """`frame_num` restarts at 1 after the IDR and wraps at
    1 << log2_max_frame_num (port only: the schedule's arithmetic, with
    the P-frame encode stubbed out)."""
    from tpu264.media.synth import synth_frame
    from tpu264_torch.coding.encoder import Encoder
    from tpu264_torch.config import EncoderConfig
    enc = Encoder(EncoderConfig(width=W, height=H, symbol_mode="CAVLC",
                                intra_period=0, inter_partitions=False,
                                transform_8x8=False), device="cpu")
    seen = []

    def stub(y, u, v, ref, frame_num, qp):
        seen.append(frame_num)
        return (lambda: []), ref

    enc.encode_p_frame = stub
    enc.sps.log2_max_frame_num = 4          # wrap after 16 frames
    f = synth_frame(W, H, 0)
    enc.encode_sequence([tuple(p.copy() for p in f) for _ in range(19)])
    assert seen == list(range(1, 16)) + [0, 1, 2]

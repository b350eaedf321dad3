"""SEI messages (`cfg.sei_messages`) on the CPU: the port's streams equal
the JAX reference encoder's byte for byte in all three GOP modes, with the
SEI NAL unit (the encoder tag and a recovery point) after SPS and PPS; and
the port's copy of `bits/sei.py` writes and parses what the reference's
does.  QCIF, CAVLC, deblocking, QP 28, the reference's default tools; the
reference's encodes are pinned (`torch_util.reference_run`)."""

import dataclasses

import pytest

from tpu264.bits import sei as rsei

from tpu264_torch.bits import nal, sei
from tpu264_torch.coding.encoder import Encoder
from tpu264_torch.config import EncoderConfig

from torch_util import reference_inputs, reference_run

MODES = ("intra", "ippp", "bgop")
_REF: dict = {}


def _cfg(mode: str):
    return reference_inputs(f"sei/{mode}")[0]


def _reference(mode: str) -> bytes:
    """The reference's stream of `mode` (pinned), once a process.
    All-intra went through its per-frame path (`TPU264_BATCH=1`); its
    batched entry writes the same stream."""
    if mode not in _REF:
        run = reference_run(f"sei/{mode}")
        assert run.enc.gop_mode == mode
        _REF[mode] = run.stream
    return _REF[mode]


def _port(mode: str, **kw) -> Encoder:
    return Encoder(EncoderConfig.from_reference(dataclasses.asdict(
        _cfg(mode))), device="cpu", **kw)


@pytest.mark.parametrize("mode,port_kw", [
    ("intra", {}), ("intra", {"intra_batch": 1}), ("ippp", {}), ("bgop", {})])
def test_sei_stream_equals_reference(mode, port_kw):
    """All-intra through the batched entry and the per-frame path, IPPP
    and a B GOP."""
    want = _reference(mode)
    port = _port(mode, **port_kw)
    frames = reference_inputs(f"sei/{mode}")[1]
    got = port.encode_sequence(frames)
    assert got == want
    types = [t for _, t, _ in nal.split_annexb(got)]
    assert types[:3] == [nal.NAL_SPS, nal.NAL_PPS, nal.NAL_SEI]
    assert types.count(nal.NAL_SEI) == 1
    assert len(port.stats) == len(frames)


@pytest.mark.parametrize("mode", list(MODES))
def test_sei_parse_equals_reference(mode):
    """The port's SEI NAL unit parses to the encoder tag and recovery
    point 0, with the port's and the reference's parser alike; and the
    port's writers give the reference's bytes, also where the payload type
    and size need 0xFF escapes."""
    heads = _port(mode)._header_nalus()
    assert len(heads) == 3
    ((ref_idc, ntype, rbsp),) = nal.split_annexb(heads[2])
    assert (ref_idc, ntype) == (0, nal.NAL_SEI)
    got = sei.parse_sei_rbsp(rbsp)
    want = rsei.parse_sei_rbsp(rbsp)
    assert [dataclasses.astuple(m) for m in got] == \
        [dataclasses.astuple(m) for m in want]
    assert [m.payload_type for m in got] == [sei.USER_DATA_UNREGISTERED,
                                             sei.RECOVERY_POINT]
    assert got[0].text == f"tpu264 - {mode} CAVLC"
    assert got[1].recovery_frame_cnt == 0
    for text in ("", "x" * 300, "tpu264 - ippp CABAC"):
        assert sei.write_user_data(text) == rsei.write_user_data(text)
    for cnt in (0, 1, 7, 300):
        assert sei.write_recovery_point(cnt) == \
            rsei.write_recovery_point(cnt)
    long = sei.make_sei_rbsp(sei.write_user_data("y" * 600),
                             sei.write_recovery_point(5))
    assert long == rsei.make_sei_rbsp(rsei.write_user_data("y" * 600),
                                      rsei.write_recovery_point(5))
    assert [dataclasses.astuple(m) for m in sei.parse_sei_rbsp(long)] == \
        [dataclasses.astuple(m) for m in rsei.parse_sei_rbsp(long)]

"""GOP-parallel encoding across hosts (BASELINE config 5) on the CPU: the
port's `runtime.gop_scheduler` against the reference's (the scheduler
and `init_distributed` alone: `test_torch_gop_scheduler.py`).

- Streams: QCIF IPPP, `intra_period=3`, 9 frames (three closed GOPs, the
  geometry of `tests/test_gop_parallel.py`), through the port's encoder on
  the CPU: the 2-host gathered stream equals the 1-host stream and the
  reference's gathered stream (pinned, `torch_util.reference_run`), byte
  for byte.
- `scaling_harness`: the reference's keys, the same stream bytes, and on a
  stand-in encoder the same results as the reference's harness but for the
  times."""

import dataclasses

from tpu264.runtime import gop_scheduler as rgs

from tpu264_torch.bits import nal
from tpu264_torch.coding.encoder import Encoder
from tpu264_torch.config import EncoderConfig
from tpu264_torch.runtime import gop_scheduler as gs

from torch_util import reference_inputs, reference_run

CASE = "gop_parallel/two_hosts"
_REF: dict = {}


def _cfg():
    return reference_inputs(CASE)[0]


def _frames():
    return reference_inputs(CASE)[1]


def _mk_port():
    return Encoder(EncoderConfig.from_reference(dataclasses.asdict(_cfg())),
                   gop_mode="ippp", device="cpu")


def _reference_stream() -> bytes:
    """The reference's 2-host gathered stream of the 9 frames
    (`rgs.GopScheduler(9, 3, 2)`, one reference encoder for both hosts),
    pinned, once."""
    if "stream" not in _REF:
        _REF["stream"] = reference_run(CASE).stream
    return _REF["stream"]


def test_gathered_streams_equal_single_host_and_reference():
    frames = _frames()
    two = gs.GopScheduler(9, 3, 2)
    assert two.gops_for(0) == [0, 2] and two.gops_for(1) == [1]
    chunks = [gs.encode_host_share(_mk_port, frames, two, h)
              for h in range(2)]
    stream = gs.gather_streams(chunks)
    one = gs.gather_streams([gs.encode_host_share(
        _mk_port, frames, gs.GopScheduler(9, 3, 1), 0)])
    assert stream == one == _reference_stream()
    # one SPS and one PPS, three IDR frames
    types = [t for _, t, _ in nal.split_annexb(stream)]
    assert types.count(nal.NAL_SPS) == types.count(nal.NAL_PPS) == 1
    assert types.count(nal.NAL_IDR) == 3


class _StandIn:
    """An encoder that writes a fixed stream of SPS, PPS and one slice a
    frame (for the harness's bookkeeping, without encoding)."""

    def encode_sequence(self, frames):
        return (nal.make_nalu(3, nal.NAL_SPS, b"\x42\x80")
                + nal.make_nalu(3, nal.NAL_PPS, b"\xc8\x80")
                + b"".join(nal.make_nalu(2, nal.NAL_SLICE, bytes([i, 0x80]))
                           for i in range(len(frames))))


def test_scaling_harness_equals_reference():
    """On the stand-in: the results but for the times equal the
    reference's; on the port's encoder: the reference's stream bytes."""
    frames = list(range(9))
    got = gs.scaling_harness(_StandIn, frames, 3, host_counts=(1, 2, 3),
                             reps=2)
    want = rgs.scaling_harness(_StandIn, frames, 3, host_counts=(1, 2, 3),
                               reps=2)
    timed = ("parallel_wall_s", "per_host_s", "per_host_reps_s",
             "efficiency", "raw_efficiency")
    assert list(got) == list(want) == [1, 2, 3]
    for h in got:
        assert list(got[h]) == list(want[h])
        assert got[h]["stream_bytes"] == want[h]["stream_bytes"]
        assert len(got[h]["per_host_s"]) == h
        assert [len(r) for r in got[h]["per_host_reps_s"]] == [2] * h
        assert set(got[h]) - set(timed) == {"stream_bytes"}
    assert got[1]["efficiency"] == 1.0
    res = gs.scaling_harness(_mk_port, _frames(), 3, host_counts=(1, 2),
                             reps=1)
    assert list(res) == [1, 2] and list(res[2]) == list(want[2])
    assert res[1]["stream_bytes"] == res[2]["stream_bytes"] == len(
        _reference_stream())
    assert res[1]["efficiency"] == 1.0

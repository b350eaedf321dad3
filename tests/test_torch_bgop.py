"""Hierarchical-B GOPs on the CPU: the port's streams equal the JAX
reference encoder's byte for byte, with the same recon planes, frame types
and sizes in display order, at QCIF with one slice and deblocking:
`num_b_frames=2` over 7 frames (I, P, Bref, B, P with a list-0 reordering,
Bref, B) with CAVLC, with CABAC, and with CABAC under JVT-G012 rate control
(every frame's QP the reference's); and `num_b_frames=1` over 5 frames
(IbPbP).  The reference's encodes are pinned
(`torch_util.reference_run`)."""

import dataclasses

import pytest


from tpu264_torch.coding import encoder as encoder_mod
from tpu264_torch.coding.encoder import Encoder
from tpu264_torch.config import EncoderConfig

from torch_util import assert_same_encode, reference_run

KINDS = {2: ["IDR", "Bref", "B", "P", "Bref", "B", "P"],
         1: ["IDR", "B", "P", "B", "P"]}
_REF: dict = {}


def _reference(nb: int, symbol_mode: str, rc: bool):
    """The reference's (encoder, config, frames, stream, per-frame QPs in
    display order, the rate controller's QPs), once a process."""
    key = (nb, symbol_mode, rc)
    if key not in _REF:
        run = reference_run(f"bgop/nb{nb}_{symbol_mode.lower()}"
                            f"{'_rc' if rc else ''}")
        _REF[key] = (run.enc, run.cfg, run.frames, run.stream, run.qps,
                     run.rc_qps)
    return _REF[key]


@pytest.mark.parametrize("nb,symbol_mode,rc", [
    (2, "CAVLC", False), (2, "CABAC", False), (2, "CABAC", True),
    (1, "CAVLC", False)])
def test_bgop_stream_equals_reference(nb, symbol_mode, rc):
    ref, cfg, frames, want, ref_qps, rc_qps = _reference(nb, symbol_mode,
                                                          rc)
    n = len(frames)
    assert ref.gop_mode == "bgop" and ref.b_partitions and ref.t8_mode
    port = Encoder(EncoderConfig.from_reference(dataclasses.asdict(cfg)),
                   device="cpu")
    assert port.gop_mode == "bgop" and port.b_partitions and port.t8_mode
    assert (port.sps.pic_order_cnt_type, port.sps.max_num_ref_frames,
            port.sps.num_reorder_frames, port.sps.profile_idc) == \
        (ref.sps.pic_order_cnt_type, ref.sps.max_num_ref_frames,
         ref.sps.num_reorder_frames, ref.sps.profile_idc)
    got = port.encode_sequence(frames)
    assert_same_encode(ref, want, port, got)
    # display order, the plan's kinds, and every frame's QP
    assert [s.frame for s in port.stats] == list(range(n))
    assert [s.slice_type for s in port.stats] == KINDS[nb]
    assert [s.qp for s in port.stats] == ref_qps
    if rc:
        # the anchors' QPs come from the controller, and they move
        anchors = [s.qp for s in port.stats if s.slice_type in ("IDR", "P")]
        assert anchors == rc_qps and len(set(ref_qps)) >= 3


def test_bgop_record_cap_overflow_equals_reference(monkeypatch):
    """CABAC B slices over the record cap (1 a MB): the encoder compacts
    them again at their true size, and the stream is the reference's."""
    _, cfg, frames, want, _, _ = _reference(2, "CABAC", False)
    port = Encoder(EncoderConfig.from_reference(dataclasses.asdict(cfg)),
                   device="cpu", records_per_mb=1)
    seen = []
    real = encoder_mod.cabac_records

    def records(pic, mbd, kind, cap):
        recs, counts = real(pic, mbd, kind, cap)
        seen.append((kind == "b", int(counts.max())))
        return recs, counts

    monkeypatch.setattr(encoder_mod, "cabac_records", records)
    assert port.encode_sequence(frames) == want
    assert any(b and c > port._cabac_cap for b, c in seen)


def test_bgop_weighted_pred_writes_reference_bytes():
    """A B GOP with `weighted_pred` asked for encodes without it, in the
    port as in the reference (explicit weights are an IPPP tool there): the
    stream is the reference's, which is its stream without the option."""
    ref, cfg, frames, want, _, _ = _reference(2, "CAVLC", False)
    run = reference_run("bgop/nb2_cavlc_wp")
    wp_cfg, ref_wp = run.cfg, run.enc
    assert wp_cfg == dataclasses.replace(cfg, weighted_pred=True)
    assert not ref_wp.wp_mode and ref_wp.pps.weighted_pred_flag == 0
    assert run.stream == want
    port = Encoder(EncoderConfig.from_reference(dataclasses.asdict(wp_cfg)),
                   device="cpu")
    assert not port.wp_mode and port.pps.weighted_pred_flag == 0
    assert port.encode_sequence(frames) == want

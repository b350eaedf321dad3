"""The port's encoder end to end on the CPU: its Annex-B stream equals the
JAX reference encoder's byte for byte (QCIF, 2 frames, all-intra CABAC,
deblock on and off, 1 and 3 slices, and with a slice over the CABAC
record cap), and its recon equals what the reference decoder
reconstructs from the port's stream.  The reference's encodes are pinned
(`torch_util.reference_run`).  Every port encoder here is built with
`device="cpu"`: without it the port asks for the CUDA card."""

import dataclasses

import pytest

from tpu264.config import EncoderConfig as RefConfig
from tpu264.decode import Decoder

from tpu264_torch.coding.encoder import Encoder
from tpu264_torch.config import EncoderConfig

from torch_util import (assert_equal, assert_same_plane, frames_sha256,
                        reference_inputs, reference_run, to_np)

W, H = 176, 144
CASES = [(True, 1), (True, 3), (False, 1), (False, 3)]
_REF = {}
_PORT = {}


def _case(deblock, slices, cap=False):
    """The name of the all-intra CABAC case of `REFERENCE_CASES`."""
    return (f"intra_cabac/{'deblock' if deblock else 'no_deblock'}"
            f"_{slices}{'_cap' if cap else ''}")


FRAMES = reference_inputs(_case(True, 1))[1]


@pytest.fixture(scope="module")
def reference():
    """Reference (stream, stats, recons, encoder) per case (`cap`: its
    record cap set to one record a MB), pinned, once for the module."""
    def get(deblock, slices, cap=False):
        key = (deblock, slices, cap)
        if key not in _REF:
            run = reference_run(_case(deblock, slices, cap))
            assert frames_sha256(run.frames) == frames_sha256(FRAMES)
            _REF[key] = (run.stream, run.enc.stats, run.enc.recons, run.enc)
        return _REF[key]
    return get


def _port_cfg(deblock, slices):
    return EncoderConfig.from_reference(
        dataclasses.asdict(reference_inputs(_case(deblock, slices))[0]))


def _port(deblock, slices):
    """The port's (stream, encoder) per case, encoded once for the module."""
    key = (deblock, slices)
    if key not in _PORT:
        enc = Encoder(_port_cfg(deblock, slices), device="cpu")
        _PORT[key] = (enc.encode_sequence(FRAMES), enc)
    return _PORT[key]


@pytest.mark.parametrize("deblock,slices", CASES)
def test_stream_bytes_equal_reference(reference, deblock, slices):
    want, ref_stats, ref_recons, _ = reference(deblock, slices)
    got, enc = _port(deblock, slices)
    assert got == want
    assert [s.bits for s in enc.stats] == [s.bits for s in ref_stats]
    for s, r in zip(enc.stats, ref_stats):
        assert (s.psnr_y, s.psnr_u, s.psnr_v) == pytest.approx(
            (r.psnr_y, r.psnr_u, r.psnr_v), abs=1e-9)
    for got_r, want_r in zip(enc.recons, ref_recons):
        for g, w in zip(got_r, want_r):
            assert_same_plane(g, w)


@pytest.mark.parametrize("deblock,slices", [(True, 1), (False, 3)])
def test_recon_equals_reference_decoder(deblock, slices):
    stream, enc = _port(deblock, slices)
    decoded = Decoder().decode(stream)
    assert len(decoded) == len(FRAMES)
    for rec, dec in zip(enc.recons, decoded):
        for g, d in zip(rec, dec):
            assert_equal(to_np(g), d)


_IPPP_OK = dict(intra_period=0, symbol_mode="CAVLC", inter_partitions=False,
                transform_8x8=False)
_IPPP = dict(intra_period=0, symbol_mode="CAVLC")


@pytest.mark.parametrize("kwargs,what", [
    (dict(_IPPP, weighted_pred=True), "weighted_pred on.*weighted pred"),
    (dict(_IPPP_OK, weighted_pred=True), "weighted_pred on"),
    (dict(_IPPP_OK, weighted_pred=True, rate_control=True, bitrate=100000),
     "weighted_pred on"),
    (dict(_IPPP, num_b_frames=2, rate_control=True, bitrate=100000,
          sei_messages=True), "SEI"),
    (dict(sei_messages=True), "SEI"),
])
def test_unported_options_raise(kwargs, what):
    """The options named by `what` construct: weighted prediction in IPPP
    (the PPS flag set; a B GOP encodes without it) and SEI messages (a SEI
    NAL unit after SPS and PPS)."""
    from tpu264_torch.bits import nal
    base = dict(width=W, height=H, qp=28, symbol_mode="CABAC")
    base.update(kwargs)
    enc = Encoder(EncoderConfig(**base), device="cpu")
    heads = [t for _, t, _ in nal.split_annexb(b"".join(
        enc._header_nalus()))]
    if what.startswith("weighted_pred"):
        assert enc.gop_mode == "ippp" and enc.wp_mode
        assert enc.pps.weighted_pred_flag == 1
        assert heads == [nal.NAL_SPS, nal.NAL_PPS]
    else:
        assert not enc.wp_mode and enc.pps.weighted_pred_flag == 0
        assert heads == [nal.NAL_SPS, nal.NAL_PPS, nal.NAL_SEI]


@pytest.mark.parametrize("kwargs,mode", [
    (dict(symbol_mode="CAVLC"), "intra"),
    (dict(symbol_mode="CABAC"), "intra"),
    (_IPPP_OK, "ippp"),
    (dict(_IPPP_OK, intra_period=3), "ippp"),
    (_IPPP, "ippp"),
    (dict(_IPPP, inter_partitions=True), "ippp"),
    (dict(_IPPP, transform_8x8=True), "ippp"),
    (dict(_IPPP, rate_control=True), "ippp"),
    (dict(symbol_mode="CABAC", rate_control=True, bitrate=0), "intra"),
    (dict(_IPPP, symbol_mode="CABAC"), "ippp"),
    (dict(_IPPP_OK, symbol_mode="CABAC"), "ippp"),
    (dict(symbol_mode="CABAC", rate_control=True, bitrate=100000), "intra"),
    (dict(symbol_mode="CAVLC", rate_control=True, bitrate=100000), "intra"),
    (dict(_IPPP, rate_control=True, bitrate=1), "ippp"),
    (dict(_IPPP, num_b_frames=2), "bgop"),
    (dict(_IPPP, num_b_frames=1, symbol_mode="CABAC"), "bgop"),
    (dict(_IPPP, num_b_frames=2, rate_control=True, bitrate=100000),
     "bgop"),
    (dict(_IPPP_OK, num_b_frames=2, symbol_mode="CABAC", rate_control=True,
          bitrate=100000), "bgop"),
    # the reference weighs weighted prediction in IPPP only
    (dict(_IPPP, num_b_frames=2, weighted_pred=True), "bgop"),
])
def test_ported_options_construct(kwargs, mode):
    enc = Encoder(EncoderConfig(width=W, height=H, **kwargs), device="cpu")
    assert enc.gop_mode == mode
    assert enc.cabac == (kwargs["symbol_mode"] == "CABAC")
    # rate control runs only with a target bitrate, as in the reference
    assert (enc.rc is not None) == (kwargs.get("rate_control", False)
                                    and kwargs.get("bitrate", 0) > 0)


@pytest.mark.parametrize("kwargs,tools", [
    (_IPPP, (True, True, True)),
    (dict(_IPPP, inter_partitions=False), (False, False, True)),
    (dict(_IPPP, transform_8x8=False), (True, True, False)),
    (_IPPP_OK, (False, False, False)),
    (dict(symbol_mode="CAVLC"), (False, False, False)),
    (dict(_IPPP, num_b_frames=2), (True, True, True)),
    (dict(_IPPP, num_b_frames=1, inter_partitions=False),
     (False, False, True)),
    (dict(_IPPP_OK, num_b_frames=2, symbol_mode="CABAC"),
     (False, False, False)),
])
def test_p_tools_follow_the_reference(kwargs, tools):
    """The P tools as the reference sets them (on for IPPP and the P
    anchors of B GOPs unless the config says False, never for all-intra),
    the B partitions likewise, and the parameter sets: High profile and
    transform_8x8_mode_flag with the 8x8 transform; a B GOP's POC type 0,
    reference and reorder frame counts."""
    from tpu264.coding.encoder import build_params as ref_build_params
    from tpu264.config import EncoderConfig as RefConfig
    cfg = EncoderConfig(width=W, height=H, **kwargs)
    enc = Encoder(cfg, device="cpu")
    assert (enc.partitions, enc.p8x8, enc.t8_mode) == tools
    assert enc.b_partitions == (enc.gop_mode == "bgop" and tools[0])
    ref_cfg = RefConfig(width=W, height=H, **kwargs)
    sps, pps, _ = ref_build_params(ref_cfg, enc.gop_mode, t8=enc.t8_mode)
    assert enc.sps.write_rbsp() == sps.write_rbsp()
    assert enc.pps.write_rbsp() == pps.write_rbsp()


def test_tools_asked_for_all_intra_warn():
    """As in the reference: asked for in an all-intra GOP, the tools are
    left off with a warning."""
    with pytest.warns(UserWarning, match="inter_partitions"):
        enc = Encoder(EncoderConfig(width=W, height=H, symbol_mode="CAVLC",
                                    inter_partitions=True), device="cpu")
    assert not enc.partitions


def test_default_device_is_cuda():
    """`Encoder(cfg)` asks for the card: where there is none it raises and
    names the device, and does not carry on on the CPU."""
    import torch
    cfg = EncoderConfig(width=W, height=H, qp=28, symbol_mode="CABAC")
    if torch.cuda.is_available():
        assert Encoder(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            Encoder(cfg)


def test_record_cap_overflow_recompacts():
    """A slice over the record cap raises nothing: the encoder compacts
    the slice again at its true size and the stream is the one the full
    buffer gives."""
    enc = Encoder(_port_cfg(True, 1), device="cpu", records_per_mb=1)
    assert enc._cabac_cap == (W // 16) * (H // 16)
    assert enc.encode_sequence(FRAMES[:1]) == \
        Encoder(_port_cfg(True, 1), device="cpu").encode_sequence(FRAMES[:1])


@pytest.mark.parametrize("deblock,slices", [(True, 1), (False, 3)])
def test_record_cap_overflow_equals_reference(reference, deblock, slices):
    """Every slice needs more records than the cap (1 a MB): the port's
    stream equals the reference's, both from its device record path and
    from the host path the reference takes past its own cap."""
    want = reference(deblock, slices)[0]
    enc = Encoder(_port_cfg(deblock, slices), device="cpu", records_per_mb=1)
    got = enc.encode_sequence(FRAMES)
    assert got == want
    capped, _, _, ref_enc = reference(deblock, slices, cap=True)
    assert ref_enc._cabac_cap == enc._cabac_cap
    assert capped == got

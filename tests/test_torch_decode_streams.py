"""Closed loop on the port's own streams, all on the CPU: the port's
encoder writes a stream, and the port's decoder, the reference decoder and
the encoder's reconstructions agree frame for frame.  CAVLC IPPP, CABAC
with the default P tools, a hierarchical-B GOP, `TiledEncoder` with two
bands (deblocking idc 2: no filtering across the band edge) and
weighted prediction with SEI.  QCIF (the tiled stream 176x128: whole MB
rows a band); no JAX program."""

import numpy as np
import pytest

from tpu264_torch.bits import nal
from tpu264_torch.bits.bitreader import BitReader
from tpu264_torch.bits.params import PPS, SPS
from tpu264_torch.bits.slicehdr import SliceHeader
from tpu264_torch.coding.encoder import Encoder
from tpu264_torch.config import EncoderConfig
from tpu264_torch.media.synth import synth_frame
from tpu264_torch.runtime.tiled import TiledEncoder, make_mesh
from tpu264_torch.tools.synth_inputs import fade_frames

from torch_util import QCIF_H, QCIF_W, assert_equal, decode_both, to_np

ENCODES = {
    "cavlc_ippp": dict(symbol_mode="CAVLC"),
    "cabac_tools": dict(symbol_mode="CABAC"),
    "bgop_cabac": dict(symbol_mode="CABAC", num_b_frames=2),
    "wp_sei_cabac": dict(symbol_mode="CABAC", weighted_pred=True,
                         sei_messages=True),
}


def _frames(w, h, n):
    return [synth_frame(w, h, t) for t in range(n)]


def _slice_headers(stream):
    """(first_mb_in_slice, disable_deblocking_filter_idc) of each slice."""
    out, sps, pps = [], None, None
    for ref_idc, t, rbsp in nal.split_annexb(stream):
        if t == nal.NAL_SPS:
            sps = SPS.parse_rbsp(rbsp)
        elif t == nal.NAL_PPS:
            pps = PPS.parse_rbsp(rbsp, sps)
        elif t in (nal.NAL_SLICE, nal.NAL_IDR):
            h = SliceHeader.parse(BitReader(rbsp), sps, pps, t, ref_idc)
            out.append((h.first_mb_in_slice, h.disable_deblocking_filter_idc))
    return out


def _assert_closed_loop(stream, recons, n):
    got, port, _ = decode_both(stream)
    assert len(got) == len(recons) == n
    for i, (dec, rec) in enumerate(zip(got, recons)):
        for c, d, r in zip("YUV", dec, rec):
            assert_equal(d, to_np(r), f"frame {i} {c}")
    return port


@pytest.mark.parametrize("name", sorted(ENCODES))
def test_port_stream_decodes_to_recon(name):
    n = 4 if "bgop" in name else 2
    cfg = EncoderConfig(width=QCIF_W, height=QCIF_H, qp=28, intra_period=0,
                        deblock=True, **ENCODES[name])
    frames = (fade_frames(QCIF_W, QCIF_H, n) if cfg.weighted_pred
              else _frames(QCIF_W, QCIF_H, n))
    enc = Encoder(cfg, device="cpu")
    stream = enc.encode_sequence(frames)
    port = _assert_closed_loop(stream, enc.recons, n)
    if cfg.weighted_pred:
        assert any(s.wp not in (None, (64, 0)) for s in enc.stats)
        assert port.sei


def test_tiled_two_bands_decode_to_recon():
    """Two bands, one slice each, deblocked with idc 2: the band edge is
    a slice edge that neither decoder filters across."""
    w, h, n = QCIF_W, 128, 2
    cfg = EncoderConfig(width=w, height=h, qp=28, intra_period=0,
                        symbol_mode="CABAC", deblock=True)
    te = TiledEncoder(cfg, make_mesh(2, gop=1, devices=["cpu"] * 2))
    stream = te.encode_sequence([_frames(w, h, n)])[0]
    assert _slice_headers(stream) == [(0, 2), (4 * 11, 2)] * n
    _assert_closed_loop(stream, te.recons[0], n)
    assert np.asarray(te.recons[0][0][0]).shape == (h, w)

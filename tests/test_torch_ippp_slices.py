"""Config 2 end to end on the CPU, three slices a picture: the port's
IPPP CAVLC stream equals the JAX reference encoder's byte for byte at
QCIF with deblocking on and off (5 frames) and on static content, and
decodes to the port's recon.  Static P frames are almost all P_Skip:
slices that are one skip run from end to end, with no MB data from the
device and the run written by the host after the header.  The reference's
encodes are pinned (`torch_util.reference_run`; one slice:
`test_torch_ippp.py`).

The same streams hold the port's band-tiled encoder (`TiledEncoder`, three
bands of three MB rows on the CPU, as slices filtered inside themselves)
and its CLI (`python -m tpu264_torch.cli.encode`, tiled and not, with
metrics and checkpoints): the reference's tiled encoder writes the
reference's three-slice stream (`tests/test_sharded.py`), so these cases
are held to the same pins.  A second sequence lane (`gop` axis) is held
to the reference's encode of its own sequence."""

import dataclasses
import json
import types

import pytest

from tpu264.bits.nal import split_annexb

from tpu264_torch.cli.encode import main as cli_main
from tpu264_torch.config import EncoderConfig
from tpu264_torch.media.yuv_io import write_yuv420
from tpu264_torch.runtime.tiled import TiledEncoder, make_mesh

from torch_util import QCIF_H as H, QCIF_W as W
from torch_util import (assert_decodes_to_recon, assert_same_encode,
                        encode_both, reference_inputs, reference_run)

FRAMES = reference_inputs("ippp3/deblock")[1]
_CASE = {}


@pytest.fixture(scope="module")
def case():
    def get(name):
        if name not in _CASE:
            if name == "static":
                _CASE[name] = encode_both("ippp3/static")
            else:
                _CASE[name] = encode_both(
                    "ippp3/deblock" if name else "ippp3/no_deblock")
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
    assert_decodes_to_recon(port, got, len(FRAMES))


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


def _tiled(ref_cfg, seqs):
    """The port's `TiledEncoder` on the CPU with three bands a lane and
    `ref_cfg`'s settings, one slice (the bands are the slices) -> (its
    streams, the encoder)."""
    cfg = EncoderConfig.from_reference(dict(dataclasses.asdict(ref_cfg),
                                            slices_per_frame=1))
    te = TiledEncoder(cfg, make_mesh(3 * len(seqs), gop=len(seqs),
                                     devices=["cpu"] * 3 * len(seqs)))
    assert (te.n_tiles, te.band_hm, te.deblock_idc) == \
        (3, 3, 2 if cfg.deblock else 1)
    return te.encode_sequence(seqs), te


def _lane(te, g):
    """Lane g's stats and recons, in the shape `assert_same_encode`
    reads."""
    return types.SimpleNamespace(stats=te.stats[g], recons=te.recons[g])


@pytest.mark.parametrize("deblock", [True, False])
def test_three_band_tiled_stream_equals_reference(case, deblock):
    ref, want, _, _ = case(deblock)
    (got,), te = _tiled(ref.cfg, [FRAMES])
    assert_same_encode(ref, want, _lane(te, 0), got)
    assert [s.qp for s in te.stats[0]] == [28] * len(FRAMES)


def test_two_lane_tiled_streams_equal_reference(case):
    """gop = 2: two different sequences, each lane the reference's
    three-slice stream of its own sequence."""
    ref, want, _, _ = case(True)
    run2 = reference_run("ippp3/other")
    assert run2.cfg == ref.cfg
    ref2, want2, other = run2.enc, run2.stream, run2.frames
    got, te = _tiled(ref.cfg, [FRAMES, other])
    assert got[1] != got[0]
    assert_same_encode(ref, want, _lane(te, 0), got[0])
    assert_same_encode(ref2, want2, _lane(te, 1), got[1])


CLI_CASES = {"tiles": ["--tiles", "3"], "slices": [],
             "metrics": ["--metrics"], "checkpoint": ["--checkpoint"]}


@pytest.mark.parametrize("name", list(CLI_CASES))
def test_cli_stream_equals_reference(case, tmp_path, name):
    """The CLI on the CPU, reading the frames from a YUV file: three bands
    (`--tiles 3`) or three slices, also with per-frame metrics and with
    checkpoints, writes the reference's three-slice stream."""
    ref, want, _, _ = case(True)
    yuv, out = tmp_path / "in.yuv", tmp_path / "out.264"
    write_yuv420(str(yuv), FRAMES)
    params = {"InputFile": yuv, "OutputFile": out, "SourceWidth": W,
              "SourceHeight": H, "FramesToBeEncoded": len(FRAMES),
              "QPISlice": 28, "SymbolMode": 0, "IntraPeriod": 0,
              "InterPartitions": 0, "Transform8x8Mode": 0,
              "LoopFilterDisable": 0,
              "SlicesPerFrame": 1 if name == "tiles" else 3}
    argv = [a for k, v in params.items() for a in ("-p", f"{k}={v}")]
    argv += ["--device", "cpu"] + CLI_CASES[name]
    if name == "metrics":
        argv.append(str(tmp_path / "m.jsonl"))
    assert cli_main(argv) == 0
    assert out.read_bytes() == want
    if name == "metrics":
        lines = [json.loads(x) for x in open(tmp_path / "m.jsonl")]
        assert [(r["frame"], r["bits"], r["qp"]) for r in lines[:-1]] == \
            [(s.frame, s.bits, 28) for s in ref.stats]
        assert lines[-1]["run_summary"] and lines[-1]["frames"] == 5
    if name == "checkpoint":
        ck = json.loads((tmp_path / "out.264.ckpt").read_text())
        assert (ck["done_gops"], ck["byte_offset"]) == (1, len(want))

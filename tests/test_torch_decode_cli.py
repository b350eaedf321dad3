"""The port's decoder CLI and the decoder's faults, on the CPU: `python
-m tpu264_torch.cli.decode --device cpu --md5` prints the reference CLI's
MD5, its `--trace` file equals the reference's, the fault injection of
`test_aux.py` passes against the port's decoder, the decoder's entry
points default to the card and raise without one, and the counterpart of
`test_aux.py::test_error_concealment_synthesis` fails as the reference
does.  Streams from the port's encoder on the CPU; no JAX program."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu264.cli import decode as ref_cli
from tpu264.decode.decoder import Decoder as RefDecoder

from tpu264_torch.bits import nal
from tpu264_torch.cli import decode as port_cli
from tpu264_torch.coding.encoder import Encoder
from tpu264_torch.config import EncoderConfig
from tpu264_torch.decode import Decoder, decode_annexb
from tpu264_torch.media.synth import synth_frame

ROOT = Path(__file__).resolve().parents[1]
W, H = 96, 80
_STREAMS: dict = {}


def _stream(n: int, qp: int, **kw) -> bytes:
    """A 96x80 IPPP CAVLC stream of n frames from the port on the CPU,
    once a process."""
    key = (n, qp, tuple(sorted(kw.items())))
    if key not in _STREAMS:
        cfg = EncoderConfig(width=W, height=H, qp=qp, intra_period=0, **kw)
        _STREAMS[key] = Encoder(cfg, device="cpu").encode_sequence(
            [synth_frame(W, H, t) for t in range(n)])
    return _STREAMS[key]


def psnr(orig, recon) -> float:
    mse = np.mean((orig.astype(np.float64) - recon.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def test_cli_md5_equals_reference(tmp_path, capsys):
    path = tmp_path / "in.264"
    path.write_bytes(_stream(3, 30, deblock=True))
    assert ref_cli.main([str(path), "--md5"]) == 0
    want = capsys.readouterr().out.split()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-m", "tpu264_torch.cli.decode", str(path),
         str(tmp_path / "out.yuv"), "--md5", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == want and len(want) == 1
    assert "decoded 3 frames" in res.stderr
    assert (tmp_path / "out.yuv").stat().st_size == 3 * W * H * 3 // 2


def test_cli_trace_equals_reference(tmp_path):
    path = tmp_path / "in.264"
    path.write_bytes(_stream(3, 30, deblock=True))
    ref_trace, port_trace = tmp_path / "ref.txt", tmp_path / "port.txt"
    assert ref_cli.main([str(path), "--trace", str(ref_trace)]) == 0
    assert port_cli.main([str(path), "--trace", str(port_trace),
                          "--device", "cpu"]) == 0
    lines = port_trace.read_text().splitlines()
    assert port_trace.read_text() == ref_trace.read_text()
    assert sum(ln.startswith("SLICE") for ln in lines) == 3
    assert sum(ln.startswith("MB ") for ln in lines) == 3 * (W // 16) * (
        H // 16)


def test_fault_injection_decoder_robustness():
    """Corrupted streams fail with controlled exceptions (or decode fewer
    frames), and the port's decoder does what the reference's does on
    each."""
    arr = np.frombuffer(_stream(3, 30), np.uint8).copy()
    rng = np.random.default_rng(0)
    for trial in range(6):
        bad = arr.copy()
        if trial % 2 == 0:
            bad = bad[: rng.integers(64, len(bad))]       # truncation
        else:
            for _ in range(4):                            # bit flips
                pos = int(rng.integers(48, len(bad)))
                bad[pos] ^= 1 << int(rng.integers(8))
        outcome = []
        for dec in (RefDecoder(), Decoder(device="cpu")):
            try:
                out = dec.decode(bad.tobytes())
                assert len(out) <= 3
                outcome.append([f[0].tobytes() for f in out])
            except Exception as e:    # a controlled failure is acceptable
                outcome.append(type(e).__name__)
        assert outcome[1] == outcome[0], trial


def test_entry_points_default_to_the_card():
    """Without a device named the decoder deblocks on the card, and it
    raises where there is none; the CLI's default is the card too."""
    if torch.cuda.is_available():
        assert Decoder().device.type == "cuda"
        return
    for make in (Decoder, lambda: decode_annexb(_stream(3, 30))):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
    with pytest.raises(RuntimeError, match="cuda"):
        port_cli.main([os.devnull])


@pytest.mark.xfail(strict=True, reason="reference fault kept by the port: a "
                   "corrupted slice parses silently and `errors` stays "
                   "empty (tpu264/decode/decoder.py:175-179)")
def test_error_concealment_synthesis():
    """Concealment: drop one P slice and bit-flip another; the concealing
    decoder still outputs every frame, synthesized from the reference, and
    records the corruption."""
    frames = [synth_frame(W, H, t) for t in range(5)]
    stream = _stream(5, 28)
    nalus = list(nal.split_annexb(stream))
    victims = [i for i, (_, t, _) in enumerate(nalus) if t == nal.NAL_SLICE]
    drop, flip = victims[1], victims[2]
    rebuilt = []
    for i, (ref_idc, ntype, rbsp) in enumerate(nalus):
        if i == drop:
            continue
        if i == flip:
            rb = bytearray(rbsp)
            rb[len(rb) // 2] ^= 0xFF
            rbsp = bytes(rb)
        rebuilt.append(nal.make_nalu(ref_idc, ntype, rbsp))
    dec = Decoder(conceal=True, device="cpu")
    out = dec.decode(b"".join(rebuilt))
    assert len(out) >= 4                 # dropped slice may cost a pic
    assert dec.errors                    # the corruption was seen
    for i, f in enumerate(out):
        assert psnr(frames[i][0], f[0]) > 18, i

"""The port's top-level entry points (`tpu264_torch.runtime.dryrun`, the
counterpart of the reference's `__graft_entry__.py`) on the CPU:

- `dryrun_multichip(4, devices=["cpu"] * 4, width=128)`: the band-tiled
  config-4 pipeline over a [2, 2] mesh, equal lane for lane to the
  reference's golden `dryrun_multichip_4_narrow` (SHA-256, bytes, frame
  sizes and QPs), every decoded frame equal to the encoder's recon (the
  function raises otherwise);
- `entry("cpu")`: one QCIF all-intra frame, equal to `Encoder` on it;
- both refuse to run where there is no card unless asked for the CPU."""

import json

import numpy as np
import pytest
import torch

from tpu264_torch.coding.encoder import Encoder
from tpu264_torch.config import EncoderConfig
from tpu264_torch.media.synth import synth_frame
from tpu264_torch.runtime import dryrun

from torch_util import GOLDEN


def test_dryrun_narrow_equals_reference_golden():
    golden = json.loads(GOLDEN.read_text())["dryrun_multichip_4_narrow"]
    got = dryrun.dryrun_multichip(4, devices=["cpu"] * 4,
                                  width=golden["config"]["width"])
    assert got["mesh"] == golden["mesh"] == [2, 2]
    assert (got["width"], got["height"], got["frames"]) == (
        golden["config"]["width"], golden["config"]["height"],
        golden["frames"])
    assert dryrun.dryrun_config(128, 2) == EncoderConfig(**golden["config"])
    assert [{k: lane[k] for k in ("sha256", "bytes", "frame_bits",
                                  "frame_qps")}
            for lane in got["lanes"]] == golden["lanes"]
    assert got["encode_seconds"] > 0 and got["decode_seconds"] > 0


def test_entry_equals_encoder():
    fn, args = dryrun.entry("cpu")
    y, u, v, qp = args
    assert (y.shape, int(qp)) == ((144, 176), 28)
    stream, recon = fn(*args)
    enc = Encoder(EncoderConfig(width=176, height=144, qp=28), device="cpu")
    assert stream == enc.encode_sequence([synth_frame(176, 144, 0)])
    for a, b in zip(recon, enc.recons[0]):
        assert a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("call", [lambda: dryrun.dryrun_multichip(4),
                                  lambda: dryrun.entry()],
                         ids=["dryrun_multichip", "entry"])
def test_entry_points_refuse_without_a_card(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        call()

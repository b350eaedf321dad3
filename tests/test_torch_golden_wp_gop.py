"""`tests/data/torch_golden.json` holds, under "ippp_720p_wp_sei", the JAX
reference encoder's stream of IPPP CABAC at 1280x720 with weighted
prediction and SEI messages (5 frames of the fade that `frames` records,
deblock on, QP 28, the default P tools), with every P frame's luma
(weight, offset) under "frame_wp"; and under "config5_4k_gop" BASELINE
config 5: the reference's GOP-parallel stream of IPPP CABAC at 3840x2160
(`intra_period=2`, 4 `synth_frame` frames: I P | I P, QP 28, deblock, the
default P tools) gathered from one host's share.  `chip_smoke.py` holds
the port's streams on the card to them.  These tests recompute them from
the reference on the CPU (minutes each; the 4K one over 12 GiB)."""

import hashlib
import json

import pytest

from torch_util import GOLDEN


def _golden(name):
    return json.loads(GOLDEN.read_text())[name]


# The reference re-encodes compile programs used by no other test and run
# full-size frames on the CPU; they check the data file, not the port.
# Run them with -m slow.
@pytest.mark.slow
def test_wp_sei_golden_matches_reference_encoder():
    from tpu264.coding.encoder import Encoder
    from tpu264.config import EncoderConfig
    from tpu264_torch.tools.synth_inputs import FADE, fade_frames
    g = _golden("ippp_720p_wp_sei")
    cfg = EncoderConfig(**g["config"])
    assert cfg.weighted_pred and cfg.sei_messages and cfg.intra_period == 0
    assert g["frames"]["recipe"] == FADE
    enc = Encoder(cfg)
    seen = []
    estimate = enc._estimate_wp

    def spy(*a):
        seen.append([int(v) for v in estimate(*a)])
        return tuple(seen[-1])

    enc._estimate_wp = spy
    stream = enc.encode_sequence(fade_frames(cfg.width, cfg.height,
                                             g["frames"]["n"]))
    assert hashlib.sha256(stream).hexdigest() == g["sha256"]
    assert len(stream) == g["bytes"]
    assert [s.bits for s in enc.stats] == g["frame_bits"]
    assert seen == g["frame_wp"]
    assert any(w != [64, 0] for w in seen)


@pytest.mark.slow
def test_config5_golden_matches_reference_gop_scheduler():
    from tpu264.coding.encoder import Encoder
    from tpu264.config import EncoderConfig
    from tpu264.media.synth import synth_frame
    from tpu264.runtime.gop_scheduler import (GopScheduler,
                                              encode_host_share,
                                              gather_streams)
    g = _golden("config5_4k_gop")
    cfg = EncoderConfig(**g["config"])
    sc = g["scheduler"]
    assert (cfg.width, cfg.height, cfg.intra_period) == (3840, 2160, 2)
    assert (sc["n_frames"], sc["intra_period"]) == (g["frames"], 2)
    frames = [synth_frame(cfg.width, cfg.height, t)
              for t in range(g["frames"])]
    made = []

    def mk():
        made.append(Encoder(cfg))
        return made[-1]

    stream = gather_streams([encode_host_share(
        mk, frames, GopScheduler(g["frames"], sc["intra_period"],
                                 sc["hosts"]), 0)])
    assert hashlib.sha256(stream).hexdigest() == g["sha256"]
    assert len(stream) == g["bytes"]
    assert [s.bits for s in made[0].stats] == g["frame_bits"]

"""The port's tools (`tpu264_torch/tools/`), without a card:

- `rd_harness`: `bd_rate` against the reference tool's formula on the
  points stored in `rd_results.json`, `run_clip`'s output, the check of
  "ours" points against the reference's, the refusal without a card;
- `x264_lavc`: the same x264 stream and decoded frames as the tests'
  ctypes helpers, and the missing library named;
- `profile_frame`'s parser takes `--config intra1080`;
- `scaling_results_torch.json`, the card's run of `scaling_artifact`:
  its keys, its card, its efficiencies recomputed from the hosts' times,
  equal stream bytes at every host count, and BASELINE's >= 0.80 at 4
  hosts (as `tests/test_gop_parallel.py` holds the reference's file)."""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu264_torch.media.synth import synth_frame
from tpu264_torch.tools import profile_frame, rd_harness, scaling_artifact
from tpu264_torch.tools import x264_lavc

import torch_util

ROOT = Path(__file__).resolve().parents[1]
RD = json.loads((ROOT / "rd_results.json").read_text())


@pytest.fixture(scope="module")
def reference_rd_tool():
    return torch_util.reference_rd_tool()


def bd_cases():
    """(clip, anchor, test) of every BD-rate the stored clips allow."""
    for clip, c in RD["clips"].items():
        for anchor, test in (("x264_ultrafast", "ours"),
                             ("x264_veryslow", "ours"),
                             ("ours_t8_off", "ours"), ("ours", "ours_b3")):
            if anchor in c and test in c:
                yield clip, anchor, test


@pytest.mark.parametrize("clip,anchor,test", list(bd_cases()))
def test_bd_rate_equals_reference_formula(clip, anchor, test,
                                          reference_rd_tool):
    c = RD["clips"][clip]
    got = rd_harness.bd_rate(c[anchor], c[test])
    assert abs(got - reference_rd_tool.bd_rate(c[anchor], c[test])) <= 1e-12


def test_psnr_equals_reference(reference_rd_tool):
    a, b = synth_frame(176, 144, 0)[0], synth_frame(176, 144, 1)[0]
    assert rd_harness._psnr(a, b) == reference_rd_tool._psnr(a, b)
    assert rd_harness._psnr(a, a) == reference_rd_tool._psnr(a, a) == 99.99


def test_run_clip_output():
    frames = [synth_frame(32, 32, t) for t in range(2)]
    seen = []

    def fake(f, w, h, qp):
        seen.append((len(f), w, h, qp))
        return {"bits": 1000 - qp, "psnr_y": 60.0 - qp}

    out = rd_harness.run_clip("tiny", frames, 32, 32,
                              [("ours", fake), ("x264_veryslow", fake)])
    assert set(out) == {"resolution", "frames", "qps", "ours",
                        "x264_veryslow"}
    assert (out["resolution"], out["frames"]) == ("32x32", 2)
    assert out["qps"] == list(rd_harness.QPS) == [22, 27, 32, 37]
    assert out["ours"] == [{"bits": 1000 - q, "psnr_y": 60.0 - q}
                           for q in rd_harness.QPS]
    assert seen == [(2, 32, 32, q) for q in rd_harness.QPS] * 2


def test_clips_are_the_reference_tools():
    assert rd_harness.NFR == 32
    for clip, (_, w, h, ours, bds) in rd_harness.CLIPS.items():
        c = RD["clips"][clip]
        assert c["resolution"] == f"{w}x{h}" and c["frames"] == 32
        assert {v for v, _, _ in ours} == {k for k in c
                                           if k.startswith("ours")}
        assert {k for k, _, _ in bds} == {k for k in c
                                          if k.startswith("bd_")}
    assert rd_harness.FAST_CLIPS == ("qcif_stress", "cif_natural")
    assert rd_harness.X264_MATCHED == RD["x264_matched_params"]


def test_mismatches_names_each_point():
    want = RD["clips"]["qcif_stress"]
    got = {k: [dict(p) for p in want[k]] for k in ("ours", "ours_b3")}
    assert rd_harness.mismatches("qcif_stress", got, want) == []
    got["ours_b3"][2]["bits"] += 8
    got["ours"][0]["psnr_y"] += 2e-9
    got["ours"][1]["psnr_y"] += 5e-10          # inside 1e-9 dB
    bad = rd_harness.mismatches("qcif_stress", got, want)
    assert [(m["variant"], m["qp"]) for m in bad] == [("ours", 22),
                                                      ("ours_b3", 32)]


@pytest.mark.parametrize("tool", [rd_harness, scaling_artifact],
                         ids=["rd_harness", "scaling_artifact"])
def test_tools_refuse_without_a_card(tool, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", [tool.__name__, "--out", os.devnull])
    assert tool.main() == 1
    assert "needs a CUDA card" in capsys.readouterr().err


def test_x264_lavc_equals_test_helpers():
    import lavc_util
    import x264_util
    frames = [synth_frame(176, 144, t) for t in range(3)]
    args = dict(qp=27, preset="ultrafast", params=rd_harness.X264_MATCHED)
    stream = x264_lavc.x264_encode(frames, **args)
    assert stream == x264_util.x264_encode(frames, **args)
    got = x264_lavc.lavc_decode(stream)
    want, errors = lavc_util.lavc_decode(stream)
    assert not errors and len(got) == len(want) == 3
    for f, g in zip(got, want):
        for a, b in zip(f, g):
            np.testing.assert_array_equal(a, b)


def test_x264_lavc_names_the_missing_library(monkeypatch):
    monkeypatch.setattr(x264_lavc, "LIBAVCODEC", "libavcodec.so.0-missing")
    x264_lavc.libs.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="libavcodec.so.0-missing"):
            x264_lavc.libs()
    finally:
        x264_lavc.libs.cache_clear()


def test_profile_frame_parser_takes_intra1080():
    args = profile_frame.build_parser().parse_args(["--config", "intra1080"])
    assert args.config == "intra1080"
    with pytest.raises(SystemExit):
        profile_frame.build_parser().parse_args(["--config", "intra4k"])


def scaling_artifact_file() -> dict:
    path = ROOT / "scaling_results_torch.json"
    if not path.exists():
        pytest.fail("scaling_results_torch.json missing: run python -m "
                    "tpu264_torch.tools.scaling_artifact on the card")
    return json.loads(path.read_text())


def test_scaling_artifact_is_a_card_run():
    art = scaling_artifact_file()
    assert set(art) == {"workload", "backend", "machine", "card", "device",
                        "torch", "cuda", "host_counts",
                        "efficiency_4_hosts"}
    assert art["backend"] == "cuda"
    assert art["workload"] == ("352x288 IPPP, IntraPeriod 4, 48 frames "
                               "(12 closed GOPs)")
    name, power = art["card"].split(", ")
    assert name == art["device"] and "NVIDIA" in name
    assert power.endswith(" W") and float(power[:-2]) > 0
    hosts = art["host_counts"]
    assert set(hosts) == {"1", "2", "4"}
    t1 = hosts["1"]["parallel_wall_s"]
    for h, r in hosts.items():
        assert len(r["per_host_s"]) == len(r["per_host_reps_s"]) == int(h)
        assert all(len(reps) == scaling_artifact.REPS
                   for reps in r["per_host_reps_s"])
        assert r["parallel_wall_s"] == max(r["per_host_s"])
        # the file keeps times to 1 ms and efficiencies to 0.001
        raw = t1 / (int(h) * max(r["per_host_s"]))
        assert abs(r["raw_efficiency"] - raw) <= 2e-3
        assert r["efficiency"] == min(r["raw_efficiency"], 1.0)
        assert r["stream_bytes"] == hosts["1"]["stream_bytes"] > 0
    assert art["efficiency_4_hosts"] == hosts["4"]["efficiency"]


def test_scaling_artifact_meets_baseline():
    """BASELINE's >= 0.80 GOP-parallel efficiency at 4 hosts, on the card."""
    art = scaling_artifact_file()
    assert art["efficiency_4_hosts"] >= 0.8, art["host_counts"]["4"]

"""`rd_results_torch.json` and `scaling_results_torch.json` hold the
port's RD points and its scaling workload's stream size from the card
(`python -m tpu264_torch.tools.rd_harness`, `.scaling_artifact`).  The
port's streams are byte-identical to the reference's, so each must be
what the reference computes now: each "ours" point what its RD harness
(`tools/rd_harness.py` `_ours`) gives, the stream size what its encoder
gives on the scaling workload (`tools/scaling_artifact.py`).  These
tests re-encode them with the reference on the CPU, one clip and variant
a case (4 QPs x 32 frames: 4-7 min at QCIF, 7-9 at CIF, 19 at 720p on
one of 4 workers; the stream size 1.5 min): where the port's files
differ from the older `rd_results.json` and `scaling_results.json`,
they show which side moved."""

import json
from pathlib import Path

import pytest

from torch_util import reference_rd_tool

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "rd_results_torch.json"
VARIANTS = [("qcif_stress", "ours"), ("qcif_stress", "ours_b3"),
            ("cif_natural", "ours"), ("cif_natural", "ours_t8_off"),
            ("cif_natural", "ours_b3"), ("p720_natural", "ours"),
            ("p720_natural", "ours_t8_off")]


# Minutes a case of reference encodes on the CPU; run them with -m slow.
@pytest.mark.slow
@pytest.mark.parametrize("clip,variant", VARIANTS)
def test_port_rd_points_equal_reference_now(clip, variant):
    from tpu264.media import synth
    port = json.loads(PORT.read_text())["clips"]
    if clip not in port:
        pytest.fail(f"{clip} is not in {PORT.name} (a TPU264_RD_FAST run)")
    rd = reference_rd_tool()
    w, h = map(int, port[clip]["resolution"].split("x"))
    source = synth.synth_frame if clip == "qcif_stress" else \
        synth.natural_frame
    frames = [source(w, h, t) for t in range(rd.NFR)]
    num_b = 3 if variant == "ours_b3" else 0
    t8 = False if variant == "ours_t8_off" else None
    for qp, got in zip(rd.QPS, port[clip][variant]):
        want = rd._ours(frames, w, h, qp, num_b=num_b, t8=t8)
        assert got["bits"] == want["bits"], (qp, got, want)
        assert abs(got["psnr_y"] - want["psnr_y"]) <= 1e-9, (qp, got, want)


@pytest.mark.slow
def test_port_scaling_stream_equals_reference_now():
    from tpu264.coding.encoder import Encoder
    from tpu264.config import EncoderConfig
    from tpu264.media.synth import synth_frame
    art = json.loads((ROOT / "scaling_results_torch.json").read_text())
    frames = [synth_frame(352, 288, t) for t in range(48)]
    enc = Encoder(EncoderConfig(width=352, height=288, qp=30,
                                intra_period=4), gop_mode="ippp")
    n = len(enc.encode_sequence(frames))
    assert {r["stream_bytes"] for r in art["host_counts"].values()} == {n}

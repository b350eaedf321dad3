"""RD harness of the port on the card, counterpart of the reference's
`tools/rd_harness.py`: bits and PSNR-Y at QPs 22, 27, 32 and 37 over 32
frames of three clips (`qcif_stress`: `synth_frame` at 176x144;
`cif_natural` and `p720_natural`: `natural_frame` at 352x288 and
1280x720), for the reference's variants of the encoder (`ours`: IPPP with
the default tools, CAVLC; `ours_b3`: hierarchical B with three B frames;
`ours_t8_off`: IPPP without the 8x8 transform), each through the port's
`Encoder` on the card, and the BD-rates against x264's anchors.

The port's streams are byte-identical to the reference's, so every
"ours" point must equal the reference's in the committed
`rd_results.json`: bits equal and PSNR-Y equal to 1e-9 dB.  Each point
that differs is printed and listed under "mismatches" of the output, and
the run exits 1.

x264's anchors (`x264_ultrafast`, `x264_veryslow`, CAVLC with the
toolset matched to the encoder's) are by default the points stored in
`rd_results.json`, which do not depend on the card; with `--x264` they are
encoded here by x264 and decoded by libavcodec through ctypes
(`tools/x264_lavc.py`), and the run stops naming the library that does
not load.  The output records which source it used ("anchors").

    python -m tpu264_torch.tools.rd_harness [--x264] [--out FILE]
    TPU264_RD_FAST=1 python -m tpu264_torch.tools.rd_harness  # QCIF, CIF

Writes `rd_results_torch.json` at the repository root (the reference's
`rd_results.json` stays) with the card's name and power limit.  It needs a
CUDA card and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
REFERENCE = ROOT / "rd_results.json"
OUT = ROOT / "rd_results_torch.json"
QPS = (22, 27, 32, 37)
NFR = 32
PSNR_TOL_DB = 1e-9
X264_MATCHED = ("8x8dct=1:cabac=0:bframes=0:ref=1:weightp=0"
                ":aq-mode=0:trellis=0:keyint=999")
X264_PRESETS = ("ultrafast", "veryslow")
# clip -> (frame source, width, height, the encoder's variants as
# (name, num_b_frames, transform_8x8), its BD-rates as (key, anchor,
# test)); the 720p clip is left out under TPU264_RD_FAST
CLIPS = {
    "qcif_stress": ("synth_frame", 176, 144,
                    (("ours", 0, None), ("ours_b3", 3, None)),
                    (("bd_rate_vs_ultrafast_pct", "x264_ultrafast", "ours"),
                     ("bd_rate_vs_veryslow_pct", "x264_veryslow", "ours"),
                     ("bd_rate_b3_vs_ours_ippp_pct", "ours", "ours_b3"))),
    "cif_natural": ("natural_frame", 352, 288,
                    (("ours", 0, None), ("ours_t8_off", 0, False),
                     ("ours_b3", 3, None)),
                    (("bd_rate_vs_ultrafast_pct", "x264_ultrafast", "ours"),
                     ("bd_rate_vs_veryslow_pct", "x264_veryslow", "ours"),
                     ("bd_rate_t8_vs_4x4_pct", "ours_t8_off", "ours"),
                     ("bd_rate_b3_vs_ours_ippp_pct", "ours", "ours_b3"))),
    "p720_natural": ("natural_frame", 1280, 720,
                     (("ours", 0, None), ("ours_t8_off", 0, False)),
                     (("bd_rate_vs_ultrafast_pct", "x264_ultrafast", "ours"),
                      ("bd_rate_vs_veryslow_pct", "x264_veryslow", "ours"),
                      ("bd_rate_t8_vs_4x4_pct", "ours_t8_off", "ours"))),
}
FAST_CLIPS = ("qcif_stress", "cif_natural")


def _psnr(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.99 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _ours(frames, w, h, qp, num_b=0, t8=None, device="cuda") -> dict:
    """One point of the encoder: IPPP (B GOP with `num_b`) at `qp` through
    the port's `Encoder` on `device` -> {bits, psnr_y}."""
    from tpu264_torch.coding.encoder import Encoder
    from tpu264_torch.config import EncoderConfig
    cfg = EncoderConfig(width=w, height=h, qp=qp, intra_period=0,
                        num_b_frames=num_b, transform_8x8=t8)
    enc = Encoder(cfg, gop_mode="bgop" if num_b else "ippp", device=device)
    stream = enc.encode_sequence(frames)
    psnr = float(np.mean([_psnr(frames[i][0], enc.recons[i][0].cpu().numpy())
                          for i in range(len(frames))]))
    return dict(bits=8 * len(stream), psnr_y=psnr)


def _x264(frames, w, h, qp, preset) -> dict:
    """One point of x264 at `preset`, decoded by libavcodec."""
    from tpu264_torch.tools.x264_lavc import lavc_decode, x264_encode
    s = x264_encode(frames, qp=qp, preset=preset, params=X264_MATCHED)
    dec = lavc_decode(s)
    psnr = float(np.mean([_psnr(frames[i][0], dec[i][0])
                          for i in range(len(dec))]))
    return dict(bits=8 * len(s), psnr_y=psnr)


def bd_rate(anchor, test) -> float:
    """Bjontegaard rate delta (%) of `test` vs `anchor`
    ([{bits, psnr_y}] over the QP sweep); negative = test better."""
    ra = np.log10([p["bits"] for p in anchor])
    pa = [p["psnr_y"] for p in anchor]
    rt = np.log10([p["bits"] for p in test])
    pt = [p["psnr_y"] for p in test]
    ca = np.polyfit(pa, ra, 3)
    ct = np.polyfit(pt, rt, 3)
    lo = max(min(pa), min(pt))
    hi = min(max(pa), max(pt))
    xs = np.linspace(lo, hi, 64)
    avg = np.mean(np.polyval(ct, xs) - np.polyval(ca, xs))
    return float((10 ** avg - 1) * 100)


def run_clip(name, frames, w, h, variants) -> dict:
    """Every variant (name, fn(frames, w, h, qp) -> {bits, psnr_y}) at
    every QP -> {"resolution", "frames", "qps", variant: [points]}."""
    print(f"=== {name} ({w}x{h}, {len(frames)} frames) ===", flush=True)
    out = {"resolution": f"{w}x{h}", "frames": len(frames),
           "qps": list(QPS)}
    for vname, fn in variants:
        out[vname] = [fn(frames, w, h, qp) for qp in QPS]
        pts = " ".join(f"{p['bits']}b/{p['psnr_y']:.2f}dB"
                       for p in out[vname])
        print(f"  {vname}: {pts}", flush=True)
    return out


def mismatches(clip: str, got: dict, want: dict) -> list:
    """The "ours" points of `got` that differ from the reference's
    (`want`, that clip of `rd_results.json`): bits, or PSNR-Y by more than
    1e-9 dB."""
    out = []
    for v in (k for k in got if k.startswith("ours")):
        for qp, g, r in zip(QPS, got[v], want[v]):
            if g["bits"] != r["bits"] or \
                    abs(g["psnr_y"] - r["psnr_y"]) > PSNR_TOL_DB:
                out.append({"clip": clip, "variant": v, "qp": qp,
                            "bits": g["bits"], "reference_bits": r["bits"],
                            "psnr_y": g["psnr_y"],
                            "reference_psnr_y": r["psnr_y"]})
    return out


def frames_of(source: str, w: int, h: int) -> list:
    from tpu264_torch.media import synth
    return [getattr(synth, source)(w, h, t) for t in range(NFR)]


def measure(clips, stored: dict | None) -> dict:
    """Every clip of `clips` on the card; the x264 anchors from `stored`
    (the clips of `rd_results.json`) or, when None, encoded here."""
    res = {"x264_matched_params": X264_MATCHED, "clips": {}}
    for clip in clips:
        source, w, h, ours, bds = CLIPS[clip]
        variants = [(v, lambda f, w, h, q, b=b, t=t: _ours(f, w, h, q, b, t))
                    for v, b, t in ours]
        for preset in X264_PRESETS:
            key = f"x264_{preset}"
            if stored is None:
                fn = (lambda f, w, h, q, p=preset: _x264(f, w, h, q, p))
            else:
                fn = (lambda f, w, h, q, k=key, c=clip:
                      stored[c][k][QPS.index(q)])
            variants.append((key, fn))
        t0 = time.monotonic()
        c = run_clip(clip, frames_of(source, w, h), w, h, variants)
        c["seconds"] = time.monotonic() - t0
        for key, anchor, test in bds:
            c[key] = bd_rate(c[anchor], c[test])
        res["clips"][clip] = c
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--x264", action="store_true",
                    help="encode x264's anchors here (x264 and libavcodec "
                         "through ctypes) instead of taking the points "
                         "stored in rd_results.json")
    ap.add_argument("--out", default=str(OUT),
                    help="where to write the JSON (default: the "
                         "repository's rd_results_torch.json)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("rd_harness needs a CUDA card", file=sys.stderr)
        return 1
    if args.x264:
        from tpu264_torch.tools.x264_lavc import libs
        try:
            libs()
        except RuntimeError as e:
            print(f"rd_harness --x264: {e}", file=sys.stderr)
            return 1
    from tpu264_torch.tools.card import card_info
    reference = json.loads(REFERENCE.read_text())["clips"]
    fast = bool(os.environ.get("TPU264_RD_FAST"))
    clips = FAST_CLIPS if fast else tuple(CLIPS)
    res = {**card_info(), "fast": fast,
           "anchors": "x264 (encoded here)" if args.x264
           else "rd_results.json (stored x264 points)"}
    res.update(measure(clips, None if args.x264 else reference))
    res["mismatches"] = [m for clip in clips for m in mismatches(
        clip, res["clips"][clip], reference[clip])]
    Path(args.out).write_text(json.dumps(res, indent=1) + "\n")
    for m in res["mismatches"]:
        print("MISMATCH", json.dumps(m))
    for name, c in res["clips"].items():
        print(name, json.dumps({k: round(v, 2) for k, v in c.items()
                                if k.startswith("bd_")}))
    print(f"{len(res['mismatches'])} of the \"ours\" points differ from "
          f"{REFERENCE.name}; wrote {args.out}")
    return 1 if res["mismatches"] else 0


if __name__ == "__main__":
    sys.exit(main())

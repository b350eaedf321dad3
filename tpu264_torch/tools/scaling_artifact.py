"""GOP-parallel scaling artifact of the port on the card, counterpart of
the reference's `tools/scaling_artifact.py` (BASELINE: >= 0.80
efficiency from 1 to 4 hosts).

The same workload: CIF IPPP with full-search ME, `intra_period=4`, 48
frames = 12 closed GOPs, through `scaling_harness` at 1, 2 and 4
simulated hosts, 5 timed repetitions of each host's share, with the
port's `Encoder` on the card.  Writes `scaling_results_torch.json` at the
repository root (the reference's `scaling_results.json` stays): the
reference's keys plus `"backend": "cuda"`, the card's name and power
limit, and the torch and CUDA versions.  Run it alone on the machine:

    python -m tpu264_torch.tools.scaling_artifact [--out FILE]

It needs a CUDA card and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import platform
import sys
from pathlib import Path

W, H = 352, 288
INTRA_PERIOD = 4
N_FRAMES = 48                      # 12 closed GOPs -> 3 per host at H=4
HOST_COUNTS = (1, 2, 4)
REPS = 5
OUT = Path(__file__).resolve().parents[2] / "scaling_results_torch.json"


def measure() -> dict:
    from tpu264_torch.coding.encoder import Encoder
    from tpu264_torch.config import EncoderConfig
    from tpu264_torch.media.synth import synth_frame
    from tpu264_torch.runtime.gop_scheduler import scaling_harness
    from tpu264_torch.tools.card import card_info

    info = card_info()

    def mk():
        cfg = EncoderConfig(width=W, height=H, qp=30,
                            intra_period=INTRA_PERIOD)
        return Encoder(cfg, gop_mode="ippp")        # the card

    frames = [synth_frame(W, H, t) for t in range(N_FRAMES)]
    res = scaling_harness(mk, frames, INTRA_PERIOD, host_counts=HOST_COUNTS,
                          reps=REPS)
    return {
        "workload": f"{W}x{H} IPPP, IntraPeriod {INTRA_PERIOD}, "
                    f"{N_FRAMES} frames (12 closed GOPs)",
        "backend": "cuda",
        "machine": platform.node(),
        "card": info["card"],
        "device": info["kind"],
        "torch": info["torch"],
        "cuda": info["cuda"],
        "host_counts": res,
        "efficiency_4_hosts": res[4]["efficiency"],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(OUT),
                    help="where to write the JSON (default: the "
                         "repository's scaling_results_torch.json)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("scaling_artifact needs a CUDA card", file=sys.stderr)
        return 1
    out = measure()
    text = json.dumps(out, indent=1)
    Path(args.out).write_text(text + "\n")
    print(text)
    print("wrote", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

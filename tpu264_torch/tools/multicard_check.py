"""Holds the port on several cards to its goldens, through `chip_smoke.py`'s
phases: config 4 through `TiledEncoder` with four bands
(`tiled4_bgop_1080p_cabac_rc`, a band a card), then the dry run
(`dryrun_multichip_4`) with its four devices on one card, over two cards
and over every card.  Prints the card lines, each phase's time and
launches, and "MULTICARD OK" at the end; raises where a stream differs
from its golden.  Needs a checkout of the repo (it imports
`chip_smoke.py` from the root) and two cards or more:

    python -m tpu264_torch.tools.multicard_check
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs

    cs.phase_device()
    cs.phase_build()
    n = torch.cuda.device_count()
    print(f"cards visible: {n}")
    if n < 2:
        raise RuntimeError("the multi-card check needs two cards or more")
    t0 = time.monotonic()
    cs.phase_tiled("tiled4_bgop_1080p_cabac_rc",
                   "config 4 through TiledEncoder, four bands")
    print(f"tiled4 phase {time.monotonic() - t0:.1f} s")
    g = cs.golden("dryrun_multichip_4")
    for devices in (["cuda:0"] * 4, ["cuda:0", "cuda:1"] * 2,
                    [f"cuda:{i % n}" for i in range(4)]):
        cs.reset_counts()
        t0 = time.monotonic()
        cs.run_dryrun(g, devices, f"dryrun {devices}")
        print(f"dryrun {devices}: equal to the golden, "
              f"{time.monotonic() - t0:.1f} s, launches {cs.read_counts()}")
    print("MULTICARD OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Times kernel KR's wrapper (`kernels/cabac_records.py`) on the card, on
a seeded 1920x1088 B picture with partitions and the 8x8 PPS
(`synth_inputs.random_b_mbs`, one slice, a cap that no slice reaches):

- `host_ms_queue`: the host's time in the part of a call that the
  encoders queue before the next frame (`queue`), the card idle before
  each call;
- `ms`: `records` back to back, CUDA events around them, as
  `chip_smoke.py` times KR.

It times the `tpu264_torch` that comes first on the module path, so one
call can hold two trees against each other:

    python -m tpu264_torch.tools.time_kr
    PYTHONPATH=<other tree> python <this file>

Prints the card's name and power limit, then one JSON object.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from tpu264_torch.kernels import cabac_records as kcr
from tpu264_torch.tools.card import card_info
from tpu264_torch.tools.synth_inputs import random_b_mbs

WM, HM = 120, 68


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_kr: no card")
    dev = torch.device("cuda")
    mbd = {k: torch.as_tensor(v, device=dev)
           for k, v in random_b_mbs(args.seed, WM, HM, True, True).items()}
    rows, cap = [0], WM * HM * 768

    def call():
        return kcr.records(mbd, WM, HM, rows, "b", cap, True)

    def queue():
        return kcr.queue(mbd, WM, HM, rows, "b", cap, True)
    for _ in range(10):
        tuple(queue())
    host = 0.0
    for _ in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q = queue()
        host += time.perf_counter() - t0
        tuple(q)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.reps):
        call()
    end.record()
    torch.cuda.synchronize()
    print(card_info())
    print(json.dumps({
        "tree": kcr.__file__.rsplit("/tpu264_torch/", 1)[0],
        "host_ms_queue": 1e3 * host / args.reps,
        "ms": start.elapsed_time(end) / args.reps,
        "records": int(call()[1].sum()), "reps": args.reps}))


if __name__ == "__main__":
    main()

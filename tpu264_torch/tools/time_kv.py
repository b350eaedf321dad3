"""Times kernel KV's wrapper (`kernels/cavlc_slices.py` `serialize`) on the
card, on MB dicts saved by `chip_smoke.py` (`TPU264_KV_PARENT`) or by
`--save`, each with its layout:

- `ms`: `serialize` back to back, CUDA events around them, as
  `chip_smoke.py` times KV;
- `device_ms`: one call's kernels under `torch.profiler`, each kernel's
  device ms by name (`kernels`) and their sum, of five traces the best
  of those that caught the most kernels.

It times the `tpu264_torch` that comes first on the module path, so one
call can hold two trees against each other on the same inputs:

    python -m tpu264_torch.tools.time_kv --load cases.pt
    PYTHONPATH=<other tree> python <this file> --load cases.pt

`--save cases.pt` first writes seeded cases (`synth_inputs`): a chunk of
four 1920x1088 I pictures, a 1280x720 P picture with every P tool, a
1920x1088 B picture with partitions, one slice each at the encoders' cap
of 100 words a MB.  Prints the card's name and power limit, then one
JSON object.
"""

from __future__ import annotations

import argparse
import json
import re

import numpy as np
import torch

from tpu264_torch.kernels import cavlc_slices as kcv
from tpu264_torch.tools.card import card_info


def seeded_cases(seed: int = 11) -> list:
    """The `--save` cases: (name, MB dict on the host, wm, hm, rows,
    kind, cap, t8_mode, pics)."""
    from tpu264_torch.tools.synth_inputs import random_b_mbs, random_mbs
    chunk = [random_mbs(seed + f, 120, 68, p_slice=False, tools=())
             for f in range(4)]
    return [
        ("chunk4", {k: np.concatenate([p[k] for p in chunk])
                    for k in chunk[0]}, 120, 68, [0], "i", 816000, False, 4),
        ("720p_p", random_mbs(seed, 80, 45), 80, 45, [0], "p", 360000,
         False, 1),
        ("b_1080p", random_b_mbs(seed, 120, 68, True, True), 120, 68, [0],
         "b", 816000, False, 1)]


def save(path: str, cases) -> None:
    """Cases of (name, MB dict, wm, hm, rows, kind, cap, t8_mode, pics)
    to `path`, their tensors on the host."""
    torch.save([(name, {k: torch.as_tensor(np.asarray(v)).cpu()
                        if not isinstance(v, torch.Tensor) else v.cpu()
                        for k, v in mbd.items()}, *rest)
                for name, mbd, *rest in cases], path)


def device_ms(fn) -> dict:
    """{kernel: device ms} of one call of `fn`: of five traces, those that
    caught the most kernels (the profiler now and then drops one), the
    one with the least total."""
    from torch.profiler import ProfilerActivity, profile
    best = None
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        got: dict = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA and \
                    "kernel" in e.name:
                name = re.findall(r"(\w+)\(", e.name)[0]
                got[name] = got.get(name, 0.0) + 1e-3 * (
                    e.time_range.end - e.time_range.start)
        if got and (best is None or (len(got), -sum(got.values()))
                    > (len(best), -sum(best.values()))):
            best = got
    return best or {}


def time_case(case, reps: int) -> dict:
    name, mbd, wm, hm, rows, kind, cap, t8, pics = case
    dev = torch.device("cuda")
    mbd = {k: v.to(dev) for k, v in mbd.items()}

    def call():
        return kcv.serialize(mbd, wm, hm, rows, kind, cap, t8, pics)
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        call()
    end.record()
    torch.cuda.synchronize()
    kernels = device_ms(call)
    words, nbits, _ = call()
    return {"ms": start.elapsed_time(end) / reps, "kernels": kernels,
            "device_ms": sum(kernels.values()),
            "bits": int(nbits.sum()), "words_sum": int(
                (words.to(torch.int64) & 0xFFFFFFFF).sum())}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--load", help="cases saved by --save or chip_smoke.py")
    ap.add_argument("--save", help="write the seeded cases here first")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if args.save:
        save(args.save, seeded_cases())
    if not args.load and not args.save:
        raise SystemExit("time_kv: --load or --save")
    if not torch.cuda.is_available():
        raise SystemExit("time_kv: no card")
    cases = torch.load(args.load or args.save)
    out = {c[0]: time_case(c, args.reps) for c in cases}
    print(card_info())
    print(json.dumps({"tree": kcv.__file__.rsplit("/tpu264_torch/", 1)[0],
                      "cases": out}))


if __name__ == "__main__":
    main()

"""Where the Tier-1 run ends: pytest-xdist's `--dist load` replayed with
measured test durations.

The Tier-1 command (ROADMAP.md) runs the suite on 6 workers under
`--dist load` (pytest-xdist 3.8, `xdist/scheduler/load.py`).  That
scheduler hands each worker an initial chunk of N // 24 consecutive tests
of the collection (N: the tests collected), and later tops a worker's
queue up with runs of consecutive pending tests as it drains.  The
collection is in file order, so the reference's slow files, which lie
next to each other (`test_aux.py`, `test_bframes.py`; `test_gop_parallel.py`,
`test_ippp.py`; `test_pallas.py`, `test_ratectl.py`, `test_sharded.py`),
can land in one worker's chunk, and where the chunk boundaries fall
depends on N.  This script replays that scheduler on the collection with
each test's duration from a run's `--durations=0` report and prints when
each worker would finish, and (`--scan`) the end for other collection
sizes, the port's tests added or removed.  The durations are taken as
they are: contention between the workers is not modelled.

    python -m pytest tests/ -m 'not slow' --collect-only -q > collection.txt
    python tests/tier1_schedule.py collection.txt tier1.log [--scan]

`tier1.log` is the output of the Tier-1 command with `--durations=0`
added (each line may carry a leading number, as a timestamped log does).
"""

from __future__ import annotations

import argparse
import heapq
import re

WORKERS = 6


def durations(log: str) -> dict:
    """Test id -> seconds (setup, call and teardown summed) from pytest's
    `--durations=0` report in `log`."""
    out: dict = {}
    pat = re.compile(r"(?:\d+ )?([\d.]+)s (?:call|setup|teardown)\s+(\S+)")
    with open(log, errors="replace") as f:
        for line in f:
            m = pat.match(line.strip())
            if m:
                out[m[2]] = out.get(m[2], 0.0) + float(m[1])
    return out


def replay(coll: list, dur: dict, workers: int = WORKERS,
           default: float = 0.005) -> list:
    """pytest-xdist's LoadScheduling on `coll` with test seconds `dur` ->
    per worker the list of (end time, test index) it ran."""
    n = len(coll)
    pending = list(range(n))
    queue: list = [[] for _ in range(workers)]
    chunk = max(min((n // workers) // 4, n), 2)
    for w in range(workers):
        queue[w] += pending[:chunk]
        del pending[:chunk]
    ran: list = [[] for _ in range(workers)]
    events = [(dur.get(coll[queue[w][0]], default), w)
              for w in range(workers) if queue[w]]
    heapq.heapify(events)
    while events:
        now, w = heapq.heappop(events)
        i = queue[w].pop(0)
        ran[w].append((now, i))
        if pending:
            lo = max(2, len(pending) // workers // 4)
            hi = max(2, len(pending) // workers // 2)
            last = dur.get(coll[i], default)
            if len(queue[w]) < lo and not (last >= 0.1 and len(queue[w]) >= 2):
                k = hi - len(queue[w])
                queue[w] += pending[:k]
                del pending[:k]
        if queue[w]:
            heapq.heappush(events, (now + dur.get(coll[queue[w][0]], default),
                                    w))
    return ran


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("collection", help="`pytest --collect-only -q` output")
    ap.add_argument("log", help="a Tier-1 log with --durations=0")
    ap.add_argument("--scan", action="store_true",
                    help="also the end with port tests added or removed")
    args = ap.parse_args()
    with open(args.collection) as f:
        coll = [line.strip() for line in f if "::" in line]
    dur = durations(args.log)
    missing = [c for c in coll if c not in dur]
    ran = replay(coll, dur)
    print(f"{len(coll)} tests, initial chunk {len(coll) // WORKERS // 4}, "
          f"{len(missing)} without a measured duration; summed "
          f"{sum(dur.get(c, 0.0) for c in coll):.0f} s")
    for w, r in enumerate(ran):
        files: list = []
        for t, i in r:
            name = coll[i].split("::")[0].rsplit("/", 1)[-1]
            if not files or files[-1][0] != name:
                files.append((name, t))
        print(f"worker {w}: ends {r[-1][0]:.0f} s; files (first end): "
              + ", ".join(f"{n} {t:.0f}" for n, t in files[:8])
              + (" ..." if len(files) > 8 else ""))
    print(f"end: {max(r[-1][0] for r in ran if r):.0f} s")
    if args.scan:
        port = [i for i, c in enumerate(coll) if "test_torch_" in c]
        at = port[len(port) // 2]
        for k in range(-48, 97, 8):
            if k < 0:
                c2 = coll[:at] + coll[at - k:]
            else:
                c2 = coll[:at] + [f"added{j}" for j in range(k)] + coll[at:]
            end = max(r[-1][0] for r in replay(c2, dur) if r)
            print(f"N {len(c2)} (chunk {len(c2) // WORKERS // 4}): "
                  f"end {end:.0f} s")


if __name__ == "__main__":
    main()

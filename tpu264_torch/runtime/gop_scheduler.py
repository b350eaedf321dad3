"""GOP-parallel encoding across hosts (BASELINE config 5: "GOP-parallel
across N>=2 hosts"), counterpart of `tpu264.runtime.gop_scheduler`.

Closed GOPs (IDR-delimited) carry no prediction state from one to the
next, so the host axis is pure data parallelism: each host encodes its
share of the GOPs on its own card and host 0 concatenates the streams in
GOP order.  The only traffic between hosts is the work assignment (static
round-robin, which every host computes alike) and the final gather of
host bytes; no tensor crosses hosts.

`init_distributed` joins a `torch.distributed` process group (`gloo`)
from torchrun's standard variables when they are set; in a single process
everything runs locally, and `scaling_harness` simulates N hosts on one
machine by timing each host's share in turn (the parallel wall clock is
the slowest host's), which is exact for data parallelism without
communication.
"""

from __future__ import annotations

import os
import statistics
import time

from tpu264_torch.bits import nal
from .checkpoint import gop_starts


def init_distributed() -> tuple[int, int]:
    """Join the process group that torchrun's variables describe
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) with the `gloo` backend
    -> (world size, rank).  Without them (a single process) -> (1, 0) and
    nothing is initialised."""
    env = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
    if not all(os.environ.get(k) for k in env):
        return 1, 0
    import torch.distributed as dist
    world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    if not dist.is_initialized():
        dist.init_process_group(
            "gloo", init_method=(f"tcp://{os.environ['MASTER_ADDR']}:"
                                 f"{os.environ['MASTER_PORT']}"),
            world_size=world, rank=rank)
    return world, rank


class GopScheduler:
    """Static round-robin assignment of closed GOPs to hosts."""

    def __init__(self, n_frames: int, intra_period: int, num_hosts: int):
        starts = gop_starts(n_frames, intra_period)
        self.bounds = starts + [n_frames]
        self.n_gops = len(starts)
        self.num_hosts = num_hosts

    def gops_for(self, host_id: int) -> list[int]:
        return [g for g in range(self.n_gops)
                if g % self.num_hosts == host_id]

    def frame_range(self, g: int) -> tuple[int, int]:
        return self.bounds[g], self.bounds[g + 1]


def encode_host_share(make_encoder, frames, sched: GopScheduler,
                      host_id: int) -> dict[int, bytes]:
    """Encode this host's GOPs -> {gop index: Annex-B chunk}.

    One encoder serves all of the host's GOPs: `encode_sequence` starts
    every call afresh (reconstructions, frame_num, IDR count), and closed
    GOPs need nothing of each other.  The first GOP's chunk keeps SPS and
    PPS; later chunks drop them, so the chunks concatenated in GOP order
    are one conforming stream."""
    out = {}
    enc = None
    for g in sched.gops_for(host_id):
        lo, hi = sched.frame_range(g)
        if enc is None:
            enc = make_encoder()
        chunk = enc.encode_sequence(frames[lo:hi])
        if g > 0:
            chunk = _strip_parameter_sets(chunk)
        out[g] = chunk
    return out


def _strip_parameter_sets(stream: bytes) -> bytes:
    parts = []
    for ref_idc, ntype, rbsp in nal.split_annexb(stream):
        if ntype in (nal.NAL_SPS, nal.NAL_PPS):
            continue
        parts.append(nal.make_nalu(ref_idc, ntype, rbsp))
    return b"".join(parts)


def gather_streams(chunks_per_host: list[dict[int, bytes]]) -> bytes:
    """Host 0's gather: every host's GOP chunks concatenated in GOP
    order."""
    merged = {}
    for d in chunks_per_host:
        merged.update(d)
    return b"".join(merged[g] for g in sorted(merged))


def scaling_harness(make_encoder, frames, intra_period: int,
                    host_counts=(1, 2, 4), reps: int = 3) -> dict:
    """GOP-parallel scaling efficiency, simulated on one machine ->
    {hosts: {"parallel_wall_s", "per_host_s", "per_host_reps_s",
    "efficiency", "raw_efficiency", "stream_bytes"}}.

    Without communication during the encode, the parallel wall clock of H
    hosts is the slowest host's share, timed here one share after another.
    Each simulated host has its own encoder, warmed on its first GOP
    untimed (a real host pays that once a run); each share is timed `reps`
    times and the median taken.  Efficiency = T(1) / (H * max_h median
    T_h), clamped to 1.0 (`raw_efficiency` keeps the value above 1 that
    timing noise can give)."""
    results = {}
    t1 = None
    for hc in host_counts:
        sched = GopScheduler(len(frames), intra_period, hc)
        per_host = []
        per_host_reps = []
        chunks = []
        for h in range(hc):
            holder = {}

            def mk_cached(holder=holder):
                if "e" not in holder:
                    holder["e"] = make_encoder()
                return holder["e"]

            lo, hi = sched.frame_range(sched.gops_for(h)[0])
            mk_cached().encode_sequence(frames[lo:hi])
            times = []
            for _ in range(reps):
                t0 = time.monotonic()
                chunk = encode_host_share(mk_cached, frames, sched, h)
                times.append(time.monotonic() - t0)
            chunks.append(chunk)
            per_host_reps.append([round(t, 3) for t in times])
            per_host.append(statistics.median(times))
        stream = gather_streams(chunks)
        wall = max(per_host)
        if t1 is None:
            t1 = wall
        raw = t1 / (hc * wall)
        results[hc] = {
            "parallel_wall_s": round(wall, 3),
            "per_host_s": [round(t, 3) for t in per_host],
            "per_host_reps_s": per_host_reps,
            "efficiency": round(min(raw, 1.0), 3),
            "raw_efficiency": round(raw, 3),
            "stream_bytes": len(stream),
        }
    return results

"""GOP-parallel hosts (BASELINE config 5) on the CPU, the parts that
encode nothing: the port's `GopScheduler` against the reference's (GOP
bounds and round-robin assignment), and `init_distributed`: (1, 0) and no
process group without torchrun's variables; with WORLD_SIZE=1, RANK=0 and
a free local port, a `gloo` group of one, in a subprocess.  The streams
and the harness: `test_torch_gop_parallel.py`."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from tpu264.runtime import gop_scheduler as rgs

from tpu264_torch.runtime import gop_scheduler as gs

ROOT = Path(__file__).resolve().parents[1]


def test_init_distributed_single_process(monkeypatch):
    import torch.distributed as dist
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert gs.init_distributed() == (1, 0)
    assert not dist.is_initialized()


def test_init_distributed_from_torchrun_variables():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    code = ("import torch.distributed as dist\n"
            "from tpu264_torch.runtime import init_distributed\n"
            "print(init_distributed(), dist.is_initialized(),\n"
            "      dist.get_backend(), dist.get_world_size())\n"
            "dist.destroy_process_group()\n")
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
               WORLD_SIZE="1", RANK="0")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[0] == "(1, 0) True gloo 1"


@pytest.mark.parametrize("n_frames,intra_period,hosts", [
    (9, 3, 2), (48, 4, 4), (10, 4, 3), (7, 0, 2), (5, 1, 2), (12, 5, 1)])
def test_scheduler_equals_reference(n_frames, intra_period, hosts):
    got = gs.GopScheduler(n_frames, intra_period, hosts)
    want = rgs.GopScheduler(n_frames, intra_period, hosts)
    assert (got.bounds, got.n_gops) == (want.bounds, want.n_gops)
    for h in range(hosts):
        assert got.gops_for(h) == want.gops_for(h)
    for g in range(got.n_gops):
        assert got.frame_range(g) == want.frame_range(g)

"""`tests/data/torch_golden.json` holds, under "config2_cif", the JAX
reference encoder's stream for config 2 at CIF (IPPP CAVLC, 1 IDR + 2 P,
deblock on, QP 28, no partitions, 4x4 transform), and under
"config2_bench_cif" its stream at `bench.py`'s config 2 settings (CIF, QP
28, `intra_period=0` and every other field at its default: CAVLC, deblock
on, 16x8/8x16 and P_8x8 partitions and the 8x8 transform; 1 IDR + 3 P);
`chip_smoke.py` holds the port's streams on the card to them.  These
tests recompute them from the reference on the CPU, and hold the port on
the CPU to them as well.  "ippp_cif_cabac_rc" is IPPP with CABAC, the
default P tools and JVT-G012 rate control at 1 Mb/s (1 IDR + 5 P), with
the QP the reference's rate controller chose for each frame."""

import pytest

from torch_util import check_golden_port_on_cpu as check_port_on_cpu
from torch_util import check_golden_reference as check_reference

NAME = "config2_cif"


# The reference re-encode compiles programs used by no other test (minutes
# on the CPU); it checks the data file, not the port.  Run it with -m slow.
@pytest.mark.slow
def test_golden_matches_reference_encoder():
    cfg = check_reference(NAME)
    assert (cfg.width, cfg.height, cfg.intra_period) == (352, 288, 0)


def test_port_on_cpu_matches_golden():
    check_port_on_cpu(NAME)


@pytest.mark.slow
def test_bench_golden_matches_reference_encoder():
    cfg = check_reference("config2_bench_cif")
    assert (cfg.width, cfg.height, cfg.intra_period) == (352, 288, 0)
    assert cfg.inter_partitions is None and cfg.transform_8x8 is None


def test_port_on_cpu_matches_bench_golden():
    check_port_on_cpu("config2_bench_cif")


@pytest.mark.slow
def test_cabac_rc_golden_matches_reference_encoder():
    cfg = check_reference("ippp_cif_cabac_rc")
    assert (cfg.width, cfg.height, cfg.symbol_mode) == (352, 288, "CABAC")
    assert cfg.rate_control and cfg.bitrate == 1_000_000


def test_port_on_cpu_matches_cabac_rc_golden():
    check_port_on_cpu("ippp_cif_cabac_rc")

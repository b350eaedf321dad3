"""`tests/data/torch_golden.json` holds, under "config2_cif", the JAX
reference encoder's stream for config 2 at CIF (IPPP CAVLC, 1 IDR + 2 P,
deblock on, QP 28, no partitions, 4x4 transform); `chip_smoke.py` holds
the port's stream on the card to it.  This test recomputes it from the
reference on the CPU, and holds the port on the CPU to it as well."""

from torch_util import check_golden_port_on_cpu as check_port_on_cpu
from torch_util import check_golden_reference as check_reference

NAME = "config2_cif"


def test_golden_matches_reference_encoder():
    cfg = check_reference(NAME)
    assert (cfg.width, cfg.height, cfg.intra_period) == (352, 288, 0)


def test_port_on_cpu_matches_golden():
    check_port_on_cpu(NAME)

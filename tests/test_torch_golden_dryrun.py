"""`tests/data/torch_golden.json` holds, under "dryrun_multichip_4" and
"dryrun_multichip_4_narrow", the JAX reference's dry run
(`__graft_entry__.dryrun_multichip(4)`'s setup: its `TiledEncoder` over
`make_mesh(4)`, 2 lanes x 2 bands of 4 MB rows, 5 frames a lane,
hierarchical B, CABAC, deblock, rate control at 2 Mb/s) at the
reference's width of 1280 and at 128: each lane's SHA-256, bytes, frame
sizes and QPs.  `chip_smoke.py` holds the port's `dryrun_multichip` on
the card to the first, `test_torch_dryrun.py` the port on the CPU to the
second.  These tests recompute both from the reference on the CPU (its 8
virtual devices, `tests/conftest.py`)."""

import json

import pytest

from torch_util import GOLDEN, dryrun_golden


# The reference's tiled re-encodes compile programs used by no other test
# and take minutes on the CPU; they check the data file, not the port.
# Run them with -m slow.
@pytest.mark.slow
@pytest.mark.parametrize("name,width", [("dryrun_multichip_4", 1280),
                                        ("dryrun_multichip_4_narrow", 128)])
def test_golden_matches_reference_dryrun(name, width):
    golden = json.loads(GOLDEN.read_text())[name]
    assert golden["config"]["width"] == width
    assert dryrun_golden(width) == golden

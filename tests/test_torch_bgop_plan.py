"""The B-GOP coding-order plan (`build_bgop_plan`: anchors, the dyadic
pyramid of reference and non-reference Bs, chained-P tails before a
periodic IDR) equals the reference's.  Pure functions, no encoder.

A module of its own: pytest-xdist (`--dist loadfile`) hands out the test
files with the most tests first, and with these six cases the B-GOP
stream module, whose reference encoders take minutes, went out ahead of
`test_sharded.py`, the longest file of the suite, which then started
later and set the length of the whole run."""

import pytest

from tpu264.coding.encoder import build_bgop_plan as ref_plan

from tpu264_torch.coding.encoder import build_bgop_plan


@pytest.mark.parametrize("nfr,nb,period", [
    (7, 2, 0), (9, 3, 0), (5, 1, 0), (10, 2, 2), (12, 2, 5), (4, 2, 0)])
def test_bgop_plan_matches_reference(nfr, nb, period):
    assert build_bgop_plan(nfr, nb, period) == ref_plan(nfr, nb, period)

"""The pinned reference encodes (`tests/data/torch_reference_pins.json`,
`torch_util.reference_run`) derived again from the live JAX reference:
each case of `torch_util.REFERENCE_CASES` but the live ones is encoded
through `reference_encoder` on its own seeded frames, with its spies, and
its pin must equal the file's; the file must name exactly those cases,
the `tpu264/` tree it came from and the versions of jax, jaxlib and numpy
it ran on.  `slow`: a reference encoder traces for 30-45 s on the CPU,
and compiles for minutes with a cold cache.

    JAX_PLATFORMS=cpu python -m pytest -m slow tests/test_torch_reference_pins.py -n 4 -p no:cacheprovider

Write mode, the only way the file is made (after an edit of `tpu264/` or
of a case, or on other versions of jax, jaxlib or numpy):

    JAX_PLATFORMS=cpu python tests/test_torch_reference_pins.py --write [--jobs 4]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent
sys.path[:0] = [str(TESTS.parent), str(TESTS)]      # as a script too

from torch_util import (LIVE_CASES, PINS, REFERENCE_CASES,  # noqa: E402
                        derive_pin, reference_packages, reference_pins,
                        reference_tree_sha256)

PINNED = sorted(set(REFERENCE_CASES) - LIVE_CASES)


@pytest.mark.slow
def test_pin_file_names_every_pinned_case():
    """Exactly the pinned cases, from this `tpu264/` tree and these
    package versions (the load checks both)."""
    assert sorted(reference_pins()) == PINNED


@pytest.mark.slow
@pytest.mark.parametrize("name", PINNED)
def test_pin_equals_live_reference(name):
    assert derive_pin(name) == reference_pins()[name]


def _derive_group(names: list) -> dict:
    """Pins of `names`, derived in this process (the cases of one geometry
    share the reference's programs)."""
    import conftest  # noqa: F401  (the CPU backend, as the tests run it)
    return {name: derive_pin(name) for name in names}


def write(jobs: int) -> None:
    """Derive every pin from the live reference and write `PINS`."""
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context
    groups: dict = {}
    for name in PINNED:
        c = REFERENCE_CASES[name].cfg
        key = (c["width"], c["height"], c.get("slices_per_frame", 1))
        groups.setdefault(key, []).append(name)
    pins: dict = {}
    with ProcessPoolExecutor(jobs, mp_context=get_context("spawn")) as ex:
        for part in ex.map(_derive_group, sorted(groups.values(), key=len,
                                                 reverse=True)):
            pins.update(part)
    PINS.write_text(json.dumps({
        "about": "What the tpu264 reference computes for the port's pinned "
                 "whole-encode test cases (tests/torch_util.py "
                 "REFERENCE_CASES); written only by python "
                 "tests/test_torch_reference_pins.py --write",
        "tpu264_sha256": reference_tree_sha256(),
        "packages": reference_packages(),
        "cases": {k: pins[k] for k in sorted(pins)}}, indent=1) + "\n")
    print(f"wrote {len(pins)} pins to {PINS}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true", required=True)
    ap.add_argument("--jobs", type=int, default=4)
    write(ap.parse_args().jobs)

"""Config 2 end to end on the CPU, deblocking on: the port's IPPP CAVLC
stream (full-search 16x16 ME, quarter-pel refinement, P_Skip / 16x16 /
I16x16 / I4x4) equals the JAX reference encoder's byte for byte at QCIF,
5 frames, with 1 and 3 slices, and decodes to the port's recon."""

import pytest

from torch_util import (assert_decodes_to_recon, assert_same_encode,
                        encode_both, moving_frames)

FRAMES = moving_frames(5)
_CASE = {}


@pytest.fixture(scope="module")
def case():
    def get(slices):
        if slices not in _CASE:
            _CASE[slices] = encode_both(FRAMES, deblock=True,
                                        slices_per_frame=slices)
        return _CASE[slices]
    return get


@pytest.mark.parametrize("slices", [1, 3])
def test_stream_bytes_equal_reference(case, slices):
    ref, want, port, got = case(slices)
    assert_same_encode(ref, want, port, got)
    assert [s.slice_type for s in port.stats] == ["IDR"] + ["P"] * 4


@pytest.mark.parametrize("slices", [1, 3])
def test_recon_equals_reference_decoder(case, slices):
    _, _, port, got = case(slices)
    assert_decodes_to_recon(port, got, len(FRAMES))

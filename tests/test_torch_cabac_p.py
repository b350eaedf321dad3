"""The port's CABAC binarizer on P slices (and on I slices of a PPS with the
8x8 transform) against the reference's numpy binarizer
(`tpu264.entropy.cabac_binarize.binarize_frame`, whose records equal
`binarize_frame_j`'s), slice by slice, and the range coder's plain
version with the P slices' init table against the reference's native C
replay; exact.  The MB dicts are seeded (`synth_inputs.random_mbs`): skips,
intra MBs in P slices, 16x16, 16x8, 8x16 and P_8x8 MBs, the 8x8 transform
on and off.  No JAX program is compiled here."""

import numpy as np
import pytest
import torch

from tpu264.entropy import cabac_binarize as ocb
from tpu264.entropy import cabac_native

from tpu264_torch.coding.wavefront import build_schedule
from tpu264_torch.entropy import cabac_binarize as tcb
from tpu264_torch.entropy import cabac_engine_cuda as k1
from tpu264_torch.tools.synth_inputs import random_mbs

from torch_util import assert_equal, t32, to_np

WM, HM = 11, 9
TOOLS = [(), ("ptype",), ("ptype", "mvq"), ("ptype", "mvq", "t8"), ("t8",)]


def _records(mb, slices, p_slice):
    """The port's compacted records per slice and the oracle's, as
    (kind, a, b) numpy triples, and the oracle's skip map."""
    rows = build_schedule(WM, HM, slices).slice_starts.tolist()
    k, a, b, v, skipped = ocb.binarize_frame(mb, WM, HM, rows, 28,
                                             p_slice=p_slice)
    bounds = rows + [HM]
    want = [ocb.slice_records(k, a, b, v, WM, bounds[s], bounds[s + 1])
            for s in range(slices)]
    tk, ta, tb, tv = tcb.binarize_frame(
        {key: torch.as_tensor(val) for key, val in mb.items()}, WM, HM, rows,
        p_slice=p_slice)
    recs, counts = tcb.compact_slices(tk, ta, tb, tv, WM, rows, HM,
                                      WM * HM * 768)
    got = [tcb.unpack_records(to_np(recs)[s, :c])
           for s, c in enumerate(to_np(counts))]
    return got, want, skipped, (recs, counts)


@pytest.mark.parametrize("slices", [1, 3])
@pytest.mark.parametrize("tools", TOOLS)
def test_p_records_match_oracle(tools, slices):
    mb = random_mbs(3 * slices + len(tools), WM, HM, tools=tools)
    got, want, skipped, _ = _records(mb, slices, p_slice=True)
    for s, (g, w) in enumerate(zip(got, want)):
        for name, gv, wv in zip(("kind", "a", "b"), g, w):
            assert_equal(gv, wv, f"slice {s} {name}")
    # what the case covers: skips, intra MBs, every partition type the
    # tools allow, and t8 MBs beside 4x4 ones
    coded = ~skipped
    inter = mb["is_inter"] & coded
    assert skipped.any() and (coded & ~mb["is_inter"]).any()
    if "ptype" in tools:
        assert set(mb["ptype"][inter]) == ({0, 1, 2, 3} if "mvq" in tools
                                           else {0, 1, 2})
    if "t8" in tools:
        assert (mb["t8"] & inter).any() and (~mb["t8"] & inter).any()


@pytest.mark.parametrize("slices", [1, 3])
def test_i_records_in_t8_pps_match_oracle(slices):
    """An I slice of a PPS with the 8x8 transform: every I_NxN MB carries
    transform_size_8x8_flag = 0."""
    mb = random_mbs(40 + slices, WM, HM, p_slice=False, tools=("t8",))
    assert not mb["t8"].any()
    got, want, _, _ = _records(mb, slices, p_slice=False)
    plain, _, _, _ = _records({k: v for k, v in mb.items() if k != "t8"},
                              slices, p_slice=False)
    for g, w, p in zip(got, want, plain):
        for gv, wv in zip(g, w):
            assert_equal(gv, wv)
        # one flag bin a coded I_NxN MB of the slice
        assert len(g[0]) - len(p[0]) == int(
            ((g[0] == 0) & (g[1] == 399)).sum()) > 0


@pytest.mark.parametrize("qp", [12, 28, 40])
def test_p_payloads_match_native(qp):
    """K1's plain version with the contexts of init table 1 (cabac_init_idc
    0) gives the native C replay's payloads of the oracle's records."""
    mb = random_mbs(qp, WM, HM)
    _, want, _, (recs, counts) = _records(mb, 3, p_slice=True)
    init = t32(k1.init_packed_states(1, qp))
    words, nbytes = k1.encode_slices(recs, counts, init, 8192)
    got = k1.payloads_from_words(words, nbytes)
    for s, (kk, aa, bb) in enumerate(want):
        assert got[s] == cabac_native.encode_records(
            kk, aa.astype(np.int32), bb.astype(np.int32), 1, qp), s

"""The port's I-slice CABAC binarizer and record compaction against the
JAX reference (`binarize_frame_j`, `compact_slices_j`), and the payloads
of the range coder's plain version against the reference's native C
replay, exact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu264.entropy import cabac_binarize_j as rcbj
from tpu264.entropy import cabac_native
from tpu264.media.synth import synth_frame

from tpu264_torch.coding.intra_frame import make_intra_encoder, \
    reorder_wave_outputs
from tpu264_torch.coding.wavefront import build_schedule
from tpu264_torch.entropy import cabac_binarize as tcb
from tpu264_torch.entropy import cabac_engine_cuda as k1

from torch_util import assert_equal, t32, to_np

W, H = 176, 144
WM, HM = W // 16, H // 16


def _mb(qp, slices):
    sched = build_schedule(WM, HM, slices)
    planes = synth_frame(W, H, t=qp % 5, seed=qp)
    _, ys = make_intra_encoder(sched)(*(torch.as_tensor(p) for p in planes),
                                      qp)
    return reorder_wave_outputs(sched, ys), sched.slice_starts.tolist()


@pytest.mark.parametrize("slices", [1, 3])
@pytest.mark.parametrize("qp", [12, 28, 40])
def test_records_match_reference(qp, slices):
    mb, rows = _mb(qp, slices)
    cap = WM * HM // slices * 768
    k, a, b, v = tcb.binarize_frame(mb, WM, HM, rows)
    recs, counts = tcb.compact_slices(k, a, b, v, WM, rows, HM, cap)
    mbj = {key: jnp.asarray(to_np(val)) for key, val in mb.items()}
    rk, ra, rb, rv, rskip = rcbj.binarize_frame_j(mbj, WM, HM, rows, qp)
    assert not np.asarray(rskip).any()
    rrecs, rcounts = rcbj.compact_slices_j(rk, ra, rb, rv, WM, rows, HM, cap)
    assert_equal(v, rv, "valid")
    valid = to_np(v)
    for name, got, want in (("kind", k, rk), ("a", a, ra), ("b", b, rb)):
        assert_equal(to_np(got)[valid], np.asarray(want)[valid], name)
    assert_equal(counts, rcounts, "counts")
    assert_equal(recs, rrecs, "records")

    # payloads: the range coder's plain version vs the native C replay
    init = t32(k1.init_packed_states(0, qp))
    words, nbytes = k1.encode_slices(recs, counts, init, 4096)
    got = k1.payloads_from_words(words, nbytes)
    for s, c in enumerate(to_np(counts)):
        kk, aa, bb = rcbj.unpack_records_np(np.asarray(rrecs)[s, :c])
        want = cabac_native.encode_records(kk, aa.astype(np.int32),
                                           bb.astype(np.int32), 0, qp)
        assert got[s] == want


def test_final_terminate_is_each_slices_last_record():
    """A slice's records hold one terminate bin 1, at their end: what the
    CUDA range coder relies on (it refuses records after one)."""
    mb, rows = _mb(28, 3)
    k, a, b, v = tcb.binarize_frame(mb, WM, HM, rows)
    recs, counts = tcb.compact_slices(k, a, b, v, WM, rows, HM,
                                      WM * HM // 3 * 768)
    for s, c in enumerate(to_np(counts)):
        kk, aa, _ = tcb.unpack_records(to_np(recs)[s, :c])
        final = np.flatnonzero((kk == 2) & (aa != 0))
        assert final.tolist() == [c - 1], s


def test_compaction_keeps_true_count_past_cap():
    mb, rows = _mb(28, 1)
    k, a, b, v = tcb.binarize_frame(mb, WM, HM, rows)
    full, n = tcb.compact_slices(k, a, b, v, WM, rows, HM, 1 << 16)
    cut, n_cut = tcb.compact_slices(k, a, b, v, WM, rows, HM, 1000)
    assert int(n_cut[0]) == int(n[0]) > 1000
    assert_equal(cut[0], full[0, :1000])


@pytest.mark.parametrize("k0", [0, 3])
def test_eg_parts_match_reference_on_reachable_range(k0):
    """Every escape value an 8-bit encode can produce: |level| of an I16
    DC stays below 6600 at QP 0, so v = |level| - 15 < 8191."""
    v = np.arange(0, 8191, dtype=np.int64)
    got = tcb.eg_parts(t32(v), k0)
    want = rcbj._eg_parts(jnp.asarray(v, jnp.int32), k0)
    for g, w in zip(got, want):
        assert_equal(g, w)


@pytest.mark.parametrize("k0", [0, 3])
def test_eg_parts_exact_at_powers_of_two(k0):
    """At every power of two t = (v >> k0) + 1 and one below and above it,
    up to 2^17, the parts equal exact integer Exp-Golomb.  (The
    reference's float32 log2 is off by one at t = 2^13 and 2^15 on the
    XLA CPU backend; no level of an 8-bit encode reaches those.)"""
    ts = sorted({t for j in range(18) for t in ((1 << j) - 1, 1 << j,
                                                (1 << j) + 1) if t >= 1})
    v = np.array([(t - 1) << k0 for t in ts], np.int64)
    got = [to_np(x) for x in tcb.eg_parts(t32(v), k0)]
    for i, t in enumerate(ts):
        m = t.bit_length() - 1
        want = (((1 << m) - 1) << 1, m + 1,
                int(v[i]) - (((1 << m) - 1) << k0), k0 + m)
        assert tuple(int(g[i]) for g in got) == want, t


def test_bit_length_is_exact():
    t = np.unique(np.concatenate([
        np.arange(1, 5000), 1 << np.arange(31), (1 << np.arange(1, 31)) - 1,
        (1 << np.arange(31)) + 1, np.array([2 ** 31 - 1])]))
    got = to_np(tcb.bit_length_minus1(t32(t)))
    want = np.array([int(x).bit_length() - 1 for x in t])
    assert_equal(got, want)

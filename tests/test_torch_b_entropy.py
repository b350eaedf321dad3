"""The B slices' entropy coding and deblocking inputs on the CPU, against
the reference, exact, on seeded raster B MB dicts
(`synth_inputs.random_b_mbs`: L0, L1, Bi, direct and intra MBs, B_Skips,
with and without the 16x8 / 8x16 partitions and every (c0, c1), in a PPS
with and without the 8x8 transform), 1 and 3 slices:
  * the CABAC binarizer's compacted records against the reference's numpy
    binarizer (`tpu264.entropy.cabac_binarize.binarize_frame`, b_slice),
    slice by slice, and K1's plain version with init table 1 against the
    native C replay;
  * `serialize_frame_b` against `serialize_frame_b_j`;
  * the two-list `compute_bs_maps` against the reference's bS derivation
    (`tpu264.ref.deblock.compute_bs_maps`) on the motion grids the
    encoder's `b_motion` builds, per MB and per 4x4 block."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu264.entropy import cabac_binarize as ocb
from tpu264.entropy import cabac_native
from tpu264.entropy import device_cavlc as rdc
from tpu264.ref import deblock as rdb

from tpu264_torch.coding.encoder import Encoder, b_motion
from tpu264_torch.coding.wavefront import build_schedule
from tpu264_torch.config import EncoderConfig
from tpu264_torch.entropy import cabac_binarize as tcb
from tpu264_torch.entropy import cabac_engine_cuda as k1
from tpu264_torch.entropy import device_cavlc as tdc
from tpu264_torch.kernels import deblock as tdb
from tpu264_torch.tools.synth_inputs import random_b_mbs

from torch_util import assert_equal, t32, to_np

WM, HM = 11, 9
CASES = [(True, False), (True, True), (False, False), (False, True)]


def _torch_mb(mb):
    return {k: torch.as_tensor(v) for k, v in mb.items()}


def _coverage(mb, skipped, parts):
    bt = mb["btype"]
    coded = ~skipped
    assert skipped.any() and (coded & (bt == 3)).any()
    assert set(bt[coded]) == ({0, 1, 2, 3, 4, 5} if parts
                              else {0, 1, 2, 3, 4})
    if parts:
        p = bt == 5
        assert len(set(zip(mb["bptype"][p], mb["c0"][p], mb["c1"][p]))) \
            == 18


@pytest.mark.parametrize("slices", [1, 3])
@pytest.mark.parametrize("parts,t8", CASES)
def test_b_records_match_oracle(parts, t8, slices):
    mb = random_b_mbs(7 * slices + 2 * parts + t8, WM, HM, parts, t8)
    rows = build_schedule(WM, HM, slices).slice_starts.tolist()
    k, a, b, v, skipped = ocb.binarize_frame(mb, WM, HM, rows, 28,
                                             b_slice=True)
    bounds = rows + [HM]
    tk, ta, tb, tv = tcb.binarize_frame(_torch_mb(mb), WM, HM, rows,
                                        b_slice=True)
    recs, counts = tcb.compact_slices(tk, ta, tb, tv, WM, rows, HM,
                                      WM * HM * 768)
    for s, c in enumerate(to_np(counts)):
        want = ocb.slice_records(k, a, b, v, WM, bounds[s], bounds[s + 1])
        got = tcb.unpack_records(to_np(recs)[s, :c])
        for name, gv, wv in zip(("kind", "a", "b"), got, want):
            assert_equal(gv, wv, f"slice {s} {name}")
    _coverage(mb, skipped, parts)
    if slices == 3 and parts:
        # K1's plain version, init table 1, on these records
        init = t32(k1.init_packed_states(1, 28))
        words, nbytes = k1.encode_slices(recs, counts, init, 8192)
        for s, pay in enumerate(k1.payloads_from_words(words, nbytes)):
            kk, aa, bb = ocb.slice_records(k, a, b, v, WM, bounds[s],
                                           bounds[s + 1])
            assert pay == cabac_native.encode_records(
                kk, aa.astype(np.int32), bb.astype(np.int32), 1, 28), s


@pytest.mark.parametrize("slices", [1, 3])
@pytest.mark.parametrize("parts,t8", CASES)
def test_serialize_frame_b_matches_reference(parts, t8, slices):
    mb = random_b_mbs(11 * slices + 2 * parts + t8, WM, HM, parts, t8)
    rows = build_schedule(WM, HM, slices).slice_starts.tolist()
    want_v, want_l, want_s = rdc.serialize_frame_b_j(
        {k: jnp.asarray(v) for k, v in mb.items()}, WM, HM, rows)
    got_v, got_l, got_s = tdc.serialize_frame_b(_torch_mb(mb), WM, HM, rows)
    assert tuple(got_v.shape) == tuple(want_v.shape)
    assert_equal(got_s, want_s, "skipped")
    assert_equal(got_l, want_l, "lengths")
    assert_equal(got_v, want_v, "values")
    _coverage(mb, to_np(got_s).astype(bool), parts)


@pytest.mark.parametrize("parts", [False, True])
def test_two_list_bs_maps_match_reference(parts):
    """bS of a B picture: the encoder's two-list motion grids (per MB, or
    per 4x4 block with partitions) through the port's `compute_bs_maps`
    and the reference's scalar derivation; every bS value occurs."""
    mb = random_b_mbs(60 + parts, WM, HM, parts)
    # small vectors, so that neighbours often agree (bS 0) and differ by
    # under and over 4 quarter-samples
    for k in ("mv0", "mv1", "mv0b", "mv1b"):
        if k in mb:
            mb[k] = mb[k] % 9 - 4
    enc = Encoder(EncoderConfig(width=16 * WM, height=16 * HM,
                                num_b_frames=2, intra_period=0),
                  device="cpu")
    tmb = _torch_mb(mb)
    is_inter = tmb["btype"] != 4
    mv, pid = b_motion(enc.pic, tmb, is_inter)
    assert tuple(mv.shape) == ((4 * HM, 4 * WM, 2, 2) if parts
                               else (HM, WM, 2, 2))
    intra = (~is_inter).reshape(HM, WM)
    tc = np.random.default_rng(3).integers(0, 3, (4 * HM, 4 * WM)) \
        * (np.random.default_rng(4).random((4 * HM, 4 * WM)) < 0.2)
    got = tdb.compute_bs_maps(intra, t32(tc), mv, pid)
    want = rdb.compute_bs_maps(to_np(intra), tc, to_np(mv), to_np(pid), WM,
                               HM)
    for g, w, name in zip(got, want, ("bs_v", "bs_h")):
        assert_equal(g, w, name)
    assert set(np.unique(np.concatenate([to_np(g).ravel()
                                         for g in got]))) == {0, 1, 2, 3, 4}

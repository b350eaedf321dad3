"""The port's interpolation, motion compensation, motion search and MV
prediction (`kernels.interp`, `kernels.me`, `coding.mvpred`) against the
JAX reference's and the scalar oracles.  Tolerance 0."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu264.coding import mvpred as rmv
from tpu264.kernels import interp as rki
from tpu264.kernels import me as rme
from tpu264.media.synth import synth_frame

from tpu264_torch.coding import mvpred as tmv
from tpu264_torch.kernels import interp as tki
from tpu264_torch.kernels import me as tme
from tpu264_torch.ref import interp as tri

from torch_util import assert_equal, t32

W, H = 176, 144
WM, HM = W // 16, H // 16
PAD = 24


def _plane(seed, h=H, w=W):
    return np.random.default_rng(seed).integers(0, 256, (h, w)).astype(
        np.int32)


def test_pad_plane_matches_reference():
    p = _plane(0, 20, 28)
    assert_equal(tki.pad_plane(t32(p), 5), rki.pad_plane(jnp.asarray(p), 5))
    assert_equal(tki.pad_plane(t32(p), 5), tri.pad_plane(p, 5))


def test_luma_planes_match_reference_whole_plane():
    """The whole padded planes agree, the rows and columns that the
    6-tap filter wraps around the edge included."""
    g = np.asarray(rki.pad_plane(jnp.asarray(_plane(1, 48, 64)), PAD))
    assert_equal(tki.luma_planes(t32(g)), rki.luma_planes(jnp.asarray(g)))


def test_luma_planes_match_scalar_oracle_inside():
    g = tri.pad_plane(_plane(2, 32, 48), 8)
    b, h, j = tri.half_pel_planes(g)
    got = tki.luma_planes(t32(g))
    for k, want in enumerate((g, b, h, j)):
        assert_equal(got[k][4:-4, 4:-4], want[4:-4, 4:-4], f"plane {k}")


@pytest.mark.parametrize("bh,bw", [(16, 16), (8, 8)])
def test_mc_luma_all_subpositions(bh, bw):
    """All 16 quarter-pel positions, against the reference and against the
    scalar oracle's sample-by-sample interpolation."""
    plane = _plane(3, 48, 64)
    g = np.asarray(rki.pad_plane(jnp.asarray(plane), PAD))
    planes_r = rki.luma_planes(jnp.asarray(g))
    planes_t = tki.luma_planes(t32(g))
    mv = np.array([[fy + 4 * iy, fx + 4 * ix]
                   for fy in range(4) for fx in range(4)
                   for iy, ix in ((0, 0), (-3, 2))], np.int32)
    n = len(mv)
    y0 = np.full(n, PAD + 16, np.int32)
    x0 = np.full(n, PAD + 32, np.int32)
    want = rki.mc_luma(planes_r, jnp.asarray(y0), jnp.asarray(x0),
                       jnp.asarray(mv), bh=bh, bw=bw)
    got = tki.mc_luma(planes_t, t32(y0), t32(x0), t32(mv), bh=bh, bw=bw)
    assert_equal(got, want)
    for k in range(n):
        oracle = tri.mc_luma_oracle(g.astype(np.int64), PAD + 16, PAD + 32,
                                    int(mv[k, 0]), int(mv[k, 1]), bh, bw)
        assert_equal(got[k], oracle, f"mv {mv[k]}")


def test_mc_luma_clamps_starts_like_dynamic_slice():
    """Block starts beyond the padded plane (the padding lanes of a wave)
    are moved inside, and negative ones count from the end, as
    `jax.lax.dynamic_slice` reads them."""
    g = np.asarray(rki.pad_plane(jnp.asarray(_plane(4, 32, 32)), PAD))
    planes_r = rki.luma_planes(jnp.asarray(g))
    planes_t = tki.luma_planes(t32(g))
    y0 = np.array([32 + PAD, 32 + PAD, 0, -7, 70], np.int32)
    x0 = np.array([PAD, 80, -3, 5, 70], np.int32)
    mv = np.array([[64, 0], [5, 66], [-9, -9], [-30, 2], [3, 3]], np.int32)
    for bh, bw in ((16, 16), (8, 8)):
        want = rki.mc_luma(planes_r, jnp.asarray(y0), jnp.asarray(x0),
                           jnp.asarray(mv), bh=bh, bw=bw)
        got = tki.mc_luma(planes_t, t32(y0), t32(x0), t32(mv), bh=bh, bw=bw)
        assert_equal(got, want, f"{bh}x{bw}")


def test_mc_chroma_matches_reference_and_oracle():
    plane = _plane(5, 24, 32)
    cp = np.asarray(rki.pad_plane(jnp.asarray(plane), PAD // 2))
    rng = np.random.default_rng(6)
    mv = rng.integers(-40, 41, (40, 2)).astype(np.int32)
    mv[:8] = [[fy, fx] for fy in (0, 3, 7, 4) for fx in (0, 5)]
    y0 = np.full(40, PAD // 2 + 8, np.int32)
    x0 = np.full(40, PAD // 2 + 16, np.int32)
    # the last lanes start outside the plane
    y0[-3:] = [40, -4, 24 + PAD]
    x0[-3:] = [50, 60, -2]
    want = rki.mc_chroma(jnp.asarray(cp), jnp.asarray(y0), jnp.asarray(x0),
                         jnp.asarray(mv))
    got = tki.mc_chroma(t32(cp), t32(y0), t32(x0), t32(mv))
    assert_equal(got, want)
    for k in range(8):
        oracle = tri.mc_chroma_block(cp.astype(np.int64), PAD // 2 + 8,
                                     PAD // 2 + 16, int(mv[k, 0]),
                                     int(mv[k, 1]))
        assert_equal(got[k], oracle, f"mv {mv[k]}")


def _me_frames(kind: str):
    if kind == "flat":
        cur = np.full((H, W), 128, np.uint8)
        ref = np.full((H, W), 128, np.uint8)
    elif kind == "motion":
        cur = synth_frame(W, H, t=3)[0]
        ref = synth_frame(W, H, t=2)[0]
    else:                       # noise: the reference shifted by (3, -5)
        ref = _plane(7).astype(np.uint8)
        cur = np.roll(ref, (3, -5), (0, 1))
    return cur, ref


@pytest.mark.parametrize("lam", [1, 5, 30])
@pytest.mark.parametrize("kind", ["motion", "flat", "noise"])
def test_full_search_and_subpel_match_reference(kind, lam):
    cur, ref = _me_frames(kind)
    ref_pad = rki.pad_plane(jnp.asarray(ref), PAD)
    want_mv, want_cost = rme.full_search_16x16(
        jnp.asarray(cur), ref_pad, PAD, 16, lam, WM, HM)
    tpad = tki.pad_plane(torch.as_tensor(ref), PAD)
    got_mv, got_cost = tme.full_search_16x16(
        torch.as_tensor(cur), tpad, PAD, 16, lam, WM, HM)
    assert_equal(got_mv, want_mv, "integer mv")
    assert_equal(got_cost, np.asarray(want_cost).astype(np.int64), "cost")
    if kind == "flat":
        # every offset ties on distortion: the cheapest vector, (0, 0), wins
        assert not got_mv.any()
    if kind == "noise":
        assert_equal(got_mv[WM + 1], [-3, 5])

    planes_r = rki.luma_planes(ref_pad)
    want_q = rme.subpel_refine(jnp.asarray(cur), planes_r, PAD, want_mv, lam,
                               WM, HM)
    got_q = tme.subpel_refine(torch.as_tensor(cur), tki.luma_planes(tpad),
                              PAD, got_mv, lam, WM, HM)
    assert_equal(got_q, want_q, "quarter-pel mv")


def test_subpel_refine_on_an_8x8_partition():
    cur, ref = _me_frames("motion")
    ref_pad = rki.pad_plane(jnp.asarray(ref), PAD)
    mv_int = np.random.default_rng(8).integers(-6, 7, (WM * HM, 2)).astype(
        np.int32)
    want = rme.subpel_refine(jnp.asarray(cur), rki.luma_planes(ref_pad), PAD,
                             jnp.asarray(mv_int), 4, WM, HM, oy=8, ox=8,
                             bh=8, bw=8)
    got = tme.subpel_refine(
        torch.as_tensor(cur),
        tki.luma_planes(tki.pad_plane(torch.as_tensor(ref), PAD)), PAD,
        t32(mv_int), 4, WM, HM, oy=8, ox=8, bh=8, bw=8)
    assert_equal(got, want)


@pytest.mark.parametrize("lam", [1, 30])
@pytest.mark.parametrize("kind", ["motion", "flat", "noise"])
def test_full_search_blocks_match_parts_and_quads(kind, lam):
    """The halves' and quadrants' searches from the one quadrant sweep
    against the reference's `full_search_parts` and `full_search_quads`
    (flat content: every offset ties, the first in dy-major order wins);
    the whole MB's against `full_search_16x16`."""
    cur, ref = _me_frames(kind)
    ref_pad = rki.pad_plane(jnp.asarray(ref), PAD)
    args = (PAD, 16, lam, WM, HM)
    want = {"16x16": rme.full_search_16x16(jnp.asarray(cur), ref_pad,
                                           *args)[0],
            **rme.full_search_parts(jnp.asarray(cur), ref_pad, *args),
            **rme.full_search_quads(jnp.asarray(cur), ref_pad, *args)}
    got = tme.full_search_blocks(torch.as_tensor(cur),
                                 tki.pad_plane(torch.as_tensor(ref), PAD),
                                 *args)
    assert sorted(got) == sorted(want) == sorted(tme.SEARCH_BLOCKS)
    for k in want:
        assert_equal(got[k], want[k], k)
    if kind == "flat":
        assert not any(v.any() for v in got.values())


def test_subpel_refine_of_a_shape_in_one_pass():
    """The four quadrants refined in one call equal four calls of the
    reference, one a quadrant."""
    cur, ref = _me_frames("motion")
    ref_pad = rki.pad_plane(jnp.asarray(ref), PAD)
    mv_int = np.random.default_rng(9).integers(-6, 7, (4, WM * HM, 2)).astype(
        np.int32)
    got = tme.subpel_refine(
        torch.as_tensor(cur),
        tki.luma_planes(tki.pad_plane(torch.as_tensor(ref), PAD)), PAD,
        t32(mv_int.reshape(-1, 2)), 4, WM, HM, oy=(0, 0, 8, 8),
        ox=(0, 8, 0, 8), bh=8, bw=8)
    for q in range(4):
        want = rme.subpel_refine(jnp.asarray(cur), rki.luma_planes(ref_pad),
                                 PAD, jnp.asarray(mv_int[q]), 4, WM, HM,
                                 oy=8 * (q // 2), ox=8 * (q % 2), bh=8, bw=8)
        assert_equal(got[q * WM * HM:(q + 1) * WM * HM], want, f"q{q}")


def _mv_neighbours(seed, n=500):
    rng = np.random.default_rng(seed)
    refs = [rng.choice([tmv.UNAVAIL, tmv.INTRA, 0], n) for _ in range(3)]
    mvs = [rng.integers(-20, 21, (n, 2)) * (r == 0)[:, None]
           for r in refs]
    mvs[0][:50] = 0            # zero left vectors: the skip rule's case
    return mvs, refs


def test_predict_mv_and_skip_mv_match_np_and_jnp():
    (mv_a, mv_b, mv_c), (ref_a, ref_b, ref_c) = _mv_neighbours(9)
    args = (mv_a, ref_a, mv_b, ref_b, mv_c, ref_c)
    want_np = rmv.predict_mv_np(*args)
    want_j = rmv.predict_mv_jnp(*(jnp.asarray(a, jnp.int32) for a in args))
    got = tmv.predict_mv(*(t32(a) for a in args))
    assert_equal(got, want_np)
    assert_equal(got, want_j)
    assert_equal(tmv.predict_mv_np(*args), want_np)
    sargs = (want_np, mv_a, ref_a, mv_b, ref_b)
    want_s = rmv.skip_mv_np(*sargs)
    assert_equal(tmv.skip_mv(*(t32(a) for a in sargs)), want_s)
    assert_equal(tmv.skip_mv(*(t32(a) for a in sargs)),
                 rmv.skip_mv_jnp(*(jnp.asarray(a, jnp.int32) for a in sargs)))
    assert_equal(tmv.skip_mv_np(*sargs), want_s)


@pytest.mark.parametrize("slice_rows", [[0], [0, 3, 6]])
def test_neighbor_mvs_np_matches_reference(slice_rows):
    rng = np.random.default_rng(10)
    ref_map = rng.choice([tmv.INTRA, 0], (HM, WM))
    mv_map = rng.integers(-30, 31, (HM, WM, 2)) * (ref_map == 0)[..., None]
    want = rmv.neighbor_mvs_np(mv_map, ref_map, WM, HM, slice_rows)
    got = tmv.neighbor_mvs_np(mv_map, ref_map, WM, HM, slice_rows)
    assert set(got) == set(want)
    for k in want:
        assert_equal(got[k], want[k], k)

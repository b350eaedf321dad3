"""The port's wavefront deblocker on the CPU (the plain version that kernel
K4's wave form is held to on the card) against the JAX reference deblocker
and the scalar `ref/deblock` oracle, exact; and what the wave kernel's
wrapper computes in Python: the lanes of a wave and the filter parameters."""

import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu264.coding.mvpred import INTRA
from tpu264.coding.wavefront import build_schedule as ref_schedule
from tpu264.kernels import deblock as rkd
from tpu264.media.synth import synth_frame
from tpu264.ref import deblock as rd
from tpu264.ref.transform import chroma_qp

from tpu264_torch.coding.wavefront import build_schedule
from tpu264_torch.kernels import deblock as tkd
from tpu264_torch.kernels import deblock_wave as k4w
from tpu264_torch.tools.synth_inputs import random_deblock_picture

from torch_util import assert_equal, t32

W, H = 176, 144
WM, HM = W // 16, H // 16
_REF = {}


def _ref_deblocker(slices, across):
    key = (slices, across)
    if key not in _REF:
        _REF[key] = rkd.make_deblocker_skewed(
            ref_schedule(WM, HM, slices), filter_across_slices=across)
    return _REF[key]


def _blocky(seed):
    """Smooth content with per-4x4 offsets, so edges get filtered."""
    rng = np.random.default_rng(seed)
    y, u, v = synth_frame(W, H, t=seed)

    def off(p, blk):
        h, w = p.shape
        o = rng.integers(-7, 8, size=(h // blk, w // blk))
        o = np.repeat(np.repeat(o, blk, 0), blk, 1)
        return np.clip(p.astype(np.int64) + o, 0, 255).astype(np.uint8)

    return off(y, 4), off(u, 4), off(v, 4)


def _inputs(seed):
    rng = np.random.default_rng(100 + seed)
    tc = rng.integers(0, 3, size=(HM * 4, WM * 4)) * \
        rng.integers(0, 2, size=(HM * 4, WM * 4))
    return tc


@pytest.mark.parametrize("slices,across", [(1, True), (3, False), (3, True)])
@pytest.mark.parametrize("qp", [18, 30, 45])
def test_intra_deblock_matches_reference(qp, slices, across):
    y, u, v = _blocky(qp)
    tc = _inputs(qp)
    intra = np.ones((HM, WM), bool)
    mv = np.zeros((HM, WM, 2), np.int32)
    ref = np.full((HM, WM), INTRA, np.int32)
    cqp = chroma_qp(qp)
    want = _ref_deblocker(slices, across)(
        jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), jnp.asarray(intra),
        jnp.asarray(tc, jnp.int32), jnp.asarray(mv), jnp.asarray(ref),
        np.int32(qp), np.int32(cqp))
    got = tkd.make_deblocker_skewed(build_schedule(WM, HM, slices),
                                    filter_across_slices=across)(
        torch.as_tensor(y), torch.as_tensor(u), torch.as_tensor(v),
        torch.as_tensor(intra), t32(tc), t32(mv), t32(ref), qp, cqp)
    for g, w in zip(got, want):
        assert_equal(g, w)
    assert (got[0].numpy() != y).any() and (got[1].numpy() != u).any()
    # and the scalar oracle: left edges at the picture border and (when
    # not filtering across slices) top edges at slice starts stay as is
    left = np.ones((HM, WM), bool)
    left[:, 0] = False
    top = np.ones((HM, WM), bool)
    top[0] = False
    if not across:
        top[::HM // slices] = False
    oracle = rd.deblock_frame(y, u, v, qp, cqp, intra, tc, mv, ref,
                              left, top)
    for g, o in zip(got, oracle):
        assert_equal(g, o)


@pytest.mark.parametrize("seed", [0, 1])
def test_bs_maps_single_list_motion(seed):
    """compute_bs_maps with intra/inter MBs and P motion matches the
    reference (the encoder's intra path uses only its intra branch)."""
    rng = np.random.default_rng(seed)
    intra = rng.integers(0, 2, size=(HM, WM)).astype(bool)
    tc = rng.integers(0, 2, size=(HM * 4, WM * 4)) * \
        rng.integers(0, 4, size=(HM * 4, WM * 4))
    mv = rng.integers(-6, 7, size=(HM, WM, 2))
    ref = np.where(intra, INTRA, 0)
    want = rkd.compute_bs_maps(jnp.asarray(intra), jnp.asarray(tc, jnp.int32),
                               jnp.asarray(np.where(intra[..., None], 0, mv),
                                           jnp.int32),
                               jnp.asarray(ref, jnp.int32))
    got = tkd.compute_bs_maps(torch.as_tensor(intra), t32(tc),
                              t32(np.where(intra[..., None], 0, mv)),
                              t32(ref))
    for g, w in zip(got, want):
        assert_equal(g, w)


def _partitioned_motion(seed):
    """Per-4x4 single-list motion of a P picture with partitioned MBs:
    (intra [HM, WM], mv [4HM, 4WM, 2], ref [4HM, 4WM], t8 [HM, WM]); each
    inter MB is 16x16, 16x8, 8x16 or P_8x8 with its own vectors, a few of
    them a quarter-pel step apart (bS 0) and the rest far apart (bS 1),
    and the 16x16 inter MBs use the 8x8 transform at random."""
    rng = np.random.default_rng(seed)
    intra = rng.random((HM, WM)) < 0.2
    ptype = rng.integers(0, 4, size=(HM, WM))
    vec = rng.integers(-8, 9, size=(HM, WM, 4, 2)) * rng.integers(
        1, 3, size=(HM, WM, 4, 1))
    quad = ((np.arange(4 * HM)[:, None] % 4 >= 2) * 2
            + (np.arange(4 * WM)[None, :] % 4 >= 2))  # a cell's quadrant
    pt4 = np.repeat(np.repeat(ptype, 4, 0), 4, 1)
    r4, c4 = np.mgrid[0:4 * HM, 0:4 * WM] // 4
    # the vector of a cell: the MB's, its half's or its quadrant's
    idx = np.select([pt4 == 1, pt4 == 2, pt4 == 3],
                    [quad // 2, quad % 2, quad], 0)
    mv = vec[r4, c4, idx]
    intra4 = np.repeat(np.repeat(intra, 4, 0), 4, 1)
    mv = np.where(intra4[..., None], 0, mv)
    ref = np.where(intra4, INTRA, 0)
    t8 = ~intra & (ptype == 0) & (rng.random((HM, WM)) < 0.6)
    return intra, mv, ref, t8


@pytest.mark.parametrize("seed", [0, 1])
def test_bs_maps_per_4x4_motion(seed):
    """compute_bs_maps on per-4x4 grids (partitioned MBs) matches the
    reference."""
    intra, mv, ref, _ = _partitioned_motion(seed)
    tc = _inputs(seed)
    want = rkd.compute_bs_maps(jnp.asarray(intra), jnp.asarray(tc, jnp.int32),
                               jnp.asarray(mv, jnp.int32),
                               jnp.asarray(ref, jnp.int32))
    got = tkd.compute_bs_maps(torch.as_tensor(intra), t32(tc), t32(mv),
                              t32(ref))
    for g, w in zip(got, want):
        assert_equal(g, w)
    assert sorted(torch.cat(got).unique().tolist()) == [0, 1, 2, 3, 4]


@pytest.mark.parametrize("qp", [24, 36])
def test_t8_mask_deblock_matches_reference(qp):
    """The whole deblocker with partitioned motion and MBs coded with the
    8x8 transform (whose inner 4x4 luma edges are left alone)."""
    intra, mv, ref, t8 = _partitioned_motion(qp)
    tc = _inputs(qp)
    y, u, v = _blocky(qp)
    cqp = chroma_qp(qp)
    want = _ref_deblocker(1, True)(
        jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), jnp.asarray(intra),
        jnp.asarray(tc, jnp.int32), jnp.asarray(mv, jnp.int32),
        jnp.asarray(ref, jnp.int32), np.int32(qp), np.int32(cqp),
        t8_mb=jnp.asarray(t8))
    args = (torch.as_tensor(y), torch.as_tensor(u), torch.as_tensor(v),
            torch.as_tensor(intra), t32(tc), t32(mv), t32(ref), qp, cqp)
    deblock = tkd.make_deblocker_skewed(build_schedule(WM, HM, 1))
    got = deblock(*args, t8_mb=torch.as_tensor(t8))
    for g, w in zip(got, want):
        assert_equal(g, w)
    # the mask changed the picture
    assert t8.any()
    assert any((g != w).any() for g, w in zip(got, deblock(*args)))


@pytest.mark.parametrize("qp", [20, 40])
def test_chroma_lines_match_reference(qp):
    rng = np.random.default_rng(qp)
    win = 100 + rng.integers(0, 12, size=(7, 8, 4))
    bs = rng.integers(0, 5, size=(7, 8))
    a, b = int(rd.ALPHA_TABLE[qp]), int(rd.BETA_TABLE[qp])
    tc0 = rd.TC0_TABLE[qp]
    got = tkd.filter_chroma_lines(t32(win), t32(bs), a, b, tc0.tolist())
    want = rkd.filter_chroma_lines(jnp.asarray(win, jnp.int32),
                                   jnp.asarray(bs, jnp.int32), a, b,
                                   jnp.asarray(tc0, jnp.int32))
    assert_equal(got, want)


@pytest.mark.parametrize("wm,hm", [(11, 9), (5, 3), (80, 45)])
def test_wave_lanes_cover_picture_in_dependency_order(wm, hm):
    """The wave kernel's lanes: every MB in exactly one wave, after its
    left, top and top-right neighbours."""
    wave_of = np.full((hm, wm), -1)
    for cp in range(wm + 2 * (hm - 1)):
        r0, n = k4w.wave_lanes(cp, wm, hm)
        assert n >= 1 and 0 <= r0 and r0 + n <= hm
        for r in range(r0, r0 + n):
            c = cp - 2 * r
            assert 0 <= c < wm and wave_of[r, c] == -1
            wave_of[r, c] = cp
        # no row outside the lanes has an MB on this wave
        for r in list(range(r0)) + list(range(r0 + n, hm)):
            assert not 0 <= cp - 2 * r < wm
    assert (wave_of >= 0).all()
    for r in range(hm):
        for c in range(wm):
            for nr, nc in ((r, c - 1), (r - 1, c), (r - 1, c + 1)):
                if 0 <= nr and 0 <= nc < wm:
                    assert wave_of[nr, nc] < wave_of[r, c]


@pytest.mark.parametrize("slices,across", [(1, True), (3, False), (3, True)])
@pytest.mark.parametrize("qp", [22, 36, 51])
def test_mixed_deblock_matches_reference(qp, slices, across):
    """Intra and inter MBs with motion and coded blocks, so that bS 0 to 4
    all occur: the port's deblocker against the JAX one and the oracle."""
    y, u, v, intra, tc, mv, ref = random_deblock_picture(qp, WM, HM)
    cqp = chroma_qp(qp)
    bs = torch.cat(tkd.compute_bs_maps(torch.as_tensor(intra), t32(tc),
                                       t32(mv), t32(ref)))
    assert sorted(bs.unique().tolist()) == [0, 1, 2, 3, 4]
    want = _ref_deblocker(slices, across)(
        jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), jnp.asarray(intra),
        jnp.asarray(tc, jnp.int32), jnp.asarray(mv), jnp.asarray(ref),
        np.int32(qp), np.int32(cqp))
    got = tkd.make_deblocker_skewed(build_schedule(WM, HM, slices),
                                    filter_across_slices=across)(
        torch.as_tensor(y), torch.as_tensor(u), torch.as_tensor(v),
        torch.as_tensor(intra), t32(tc), t32(mv), t32(ref), qp, cqp)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert_equal(g, w)
    assert (got[0].numpy() != y).any() and (got[1].numpy() != u).any()
    left = np.ones((HM, WM), bool)
    left[:, 0] = False
    top = np.ones((HM, WM), bool)
    top[0] = False
    if not across:
        top[::HM // slices] = False
    oracle = rd.deblock_frame(y, u, v, qp, cqp, intra, tc, mv, ref, left, top)
    for g, o in zip(got, oracle):
        assert_equal(g, o)


def test_plain_flag_is_the_cpu_path():
    """`plain=True` (what the wave kernel is held to on the card) is the
    version a CPU tensor gets, and the input planes stay as they were."""
    y, u, v, intra, tc, mv, ref = random_deblock_picture(3, 5, 3)
    args = (torch.as_tensor(y), torch.as_tensor(u), torch.as_tensor(v),
            torch.as_tensor(intra), t32(tc), t32(mv), t32(ref), 30,
            chroma_qp(30))
    sched = build_schedule(5, 3, 1)
    before = dict(k4w.launches)
    got = tkd.make_deblocker_skewed(sched)(*args)
    want = tkd.make_deblocker_skewed(sched, plain=True)(*args)
    for g, w in zip(got, want):
        assert_equal(g, w)
    assert_equal(args[0], y)
    assert k4w.launches == before           # no kernel ran on the CPU


@pytest.mark.parametrize("qp,cqp", [(0, 0), (28, 28), (51, 39), (60, -3)])
def test_deblock_wave_params(qp, cqp):
    """alpha, beta, tc0[1..3] at a luma and a chroma QP, clipped to 0..51
    (offsets 0), as the plain deblocker derives them; and the tables in
    the wave kernel's constant memory are the reference's."""
    alpha, beta, tc0 = tkd.edge_params(t32([qp, cqp]))
    for i, q in enumerate((qp, cqp)):
        qi = min(max(q, 0), 51)
        assert [int(alpha[i]), int(beta[i]), *tc0[i].tolist()] == [
            int(rd.ALPHA_TABLE[qi]), int(rd.BETA_TABLE[qi]),
            *(int(t) for t in rd.TC0_TABLE[qi])]
    src = (Path(tkd.__file__).parents[1] / "csrc" / "deblock_wave.cu"
           ).read_text()

    def table(name):
        body = re.search(name + r"[^=]*=\s*\{(.*?)\};", src, re.S).group(1)
        return [int(x) for x in re.findall(r"-?\d+", body)]

    assert table("kAlpha") == [int(x) for x in rd.ALPHA_TABLE]
    assert table("kBeta") == [int(x) for x in rd.BETA_TABLE]
    assert table("kTc0") == [int(x) for x in rd.TC0_TABLE.ravel()]


def test_deblock_wave_refuses_cpu_tensors():
    z = torch.zeros((48, 80), dtype=torch.int32)
    c = torch.zeros((24, 40), dtype=torch.int32)
    b = torch.zeros((12, 20), dtype=torch.int32)
    q = torch.full((3, 5), 28, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        k4w.deblock_wave(z, c, c.clone(), b, b.clone(), 0, q, q.clone())

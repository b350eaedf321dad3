"""The motion search as the P and B encoders call it: the wrappers of KF
(`kernels/me_search.py`) and KS (`kernels/me_subpel.py`), their argument
packing and their plain versions, against the reference's
`full_search_16x16` / `full_search_parts` / `full_search_quads` /
`subpel_refine` block by block and against the per-shape calls the
encoders made before.  Tolerance 0.  No reference encoder is built."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu264.kernels import interp as rki
from tpu264.kernels import me as rme

from tpu264_torch.coding import inter_frame as tinter
from tpu264_torch.coding.intra_frame import LAMBDA_TABLE
from tpu264_torch.kernels import interp as tki
from tpu264_torch.kernels import me as tme
from tpu264_torch.kernels import me_search as kfs
from tpu264_torch.kernels import me_subpel as ksp
from tpu264_torch.media.synth import synth_frame

from torch_util import assert_equal

W, H = 96, 64
WM, HM = W // 16, H // 16
PAD, R = 24, 16

# the encoders' three sets of searches: P without and with the default
# tools, B with partitions
TOOLS = {"p_notools": (False, False), "p_tools": (True, True),
         "b_parts": (True, False)}


def _frames(kind: str):
    if kind == "flat":                  # every candidate ties
        return (np.full((H, W), 128, np.uint8),) * 2
    if kind == "motion":
        return synth_frame(W, H, t=3)[0], synth_frame(W, H, t=2)[0]
    ref = np.random.default_rng(7).integers(0, 256, (H, W), dtype=np.uint8)
    return np.roll(ref, (3, -5), (0, 1)), ref


# the reference's searches and refinement, each compiled once (a
# refinement once a block size; the lambda and the offsets are traced),
# without the backend's optimisations: the inputs are tiny, the compile is
# what costs
FAST = {"xla_backend_optimization_level": 0}


@functools.partial(jax.jit, compiler_options=FAST)
def _searches_ref(cur, ref, lam):
    """The reference's half-pel planes and full-pel vectors."""
    ref_pad = rki.pad_plane(ref, PAD)
    args = (PAD, R, lam, WM, HM)
    return rki.luma_planes(ref_pad), {
        "16x16": rme.full_search_16x16(cur, ref_pad, *args)[0],
        **rme.full_search_parts(cur, ref_pad, *args),
        **rme.full_search_quads(cur, ref_pad, *args)}


_subpel_ref = jax.jit(rme.subpel_refine, static_argnums=(2, 5, 6),
                      static_argnames=("bh", "bw"), compiler_options=FAST)


@functools.lru_cache(maxsize=None)
def _reference(kind: str, lam: int) -> dict:
    """The reference's full-pel and quarter-pel vectors of every block of
    `me.SEARCH_BLOCKS`, one reference call a block (numpy)."""
    cur, ref = (jnp.asarray(p) for p in _frames(kind))
    planes, full = _searches_ref(cur, ref, lam)
    geo = {n: g for n, g in zip(ksp.names_of(ksp.shapes(True, True)),
                                ksp.shape_table(ksp.shapes(True, True)))}
    quarter = {}
    for name, mv in full.items():
        oy, ox, bh, bw = geo[name]
        quarter[name] = np.asarray(_subpel_ref(
            cur, planes, PAD, mv, lam, WM, HM, oy=oy, ox=ox, bh=bh, bw=bw))
    return {"full": {k: np.asarray(v) for k, v in full.items()},
            "quarter": quarter}


def _torch_inputs(kind: str):
    cur, ref = (torch.as_tensor(p).to(torch.int32) for p in _frames(kind))
    ref_pad = tki.pad_plane(ref, PAD)
    return cur, ref_pad, tki.luma_planes(ref_pad)


def test_shape_table_and_packing():
    """The shapes in the order the encoders refine them, the names in the
    order of the vectors (`me.SEARCH_BLOCKS`'s), each block's quadrants
    (KF's `ssd[]` order), the blocks' indices KF is sent, and the by-value
    tables' lengths (the CUDA sources' `Params`)."""
    shapes = ksp.shapes(True, True)
    assert ksp.names_of(shapes) == list(tme.SEARCH_BLOCKS)
    assert ksp.shape_table(shapes) == [
        (0, 0, 16, 16), (0, 0, 8, 16), (8, 0, 8, 16), (0, 0, 16, 8),
        (0, 8, 16, 8), (0, 0, 8, 8), (0, 8, 8, 8), (8, 0, 8, 8),
        (8, 8, 8, 8)]
    assert ksp.names_of(ksp.shapes()) == ["16x16"]
    assert ksp.names_of(ksp.shapes(True)) == ["16x16", "top", "bot", "left",
                                              "right"]
    assert [kfs.quad_mask(n) for n in tme.SEARCH_BLOCKS] == [
        15, 3, 12, 5, 10, 1, 2, 4, 8]
    for names in (["16x16"], list(tme.SEARCH_BLOCKS)):
        p = kfs.pack_params(WM, HM, (H, W), (H + 48, W + 48), PAD, R, 7, names)
        assert len(p) == 10 + 9 and p[9] == len(names)
        assert p[10:10 + len(names)] == [
            list(tme.SEARCH_BLOCKS).index(n) for n in names]
        t = ksp.shape_table(ksp.shapes(len(names) > 1, len(names) > 1))
        q = ksp.pack_params(WM, HM, (H, W), (H + 48, W + 48), PAD, 7, t)
        assert len(q) == 9 + 4 * 9 + 16 * 7 and q[8] == len(names)
        assert q[9:9 + 4 * len(t)] == [v for row in t for v in row]


@pytest.mark.parametrize("lam", [1, 30])
@pytest.mark.parametrize("kind", ["motion", "flat", "noise"])
@pytest.mark.parametrize("tools", sorted(TOOLS))
def test_wrappers_match_reference_block_by_block(tools, kind, lam):
    """`full_search` and `subpel` on CPU tensors (their plain versions),
    with the names and shapes an encoder passes, give the reference's
    vectors block by block; `motion_vectors`, the encoders' motion search
    of one list, gives the same (checked once a set of searches, on the
    moving frame at lambda 30, since it repeats both searches); no kernel
    launch is counted."""
    shapes = ksp.shapes(*TOOLS[tools])
    names = ksp.names_of(shapes)
    cur, ref_pad, planes = _torch_inputs(kind)
    want = _reference(kind, lam)
    before = {**kfs.launches, **ksp.launches}
    mv_int = kfs.full_search(cur, ref_pad, PAD, R, lam, WM, HM, names)
    assert mv_int.shape == (len(names), WM * HM, 2)
    assert mv_int.dtype == torch.int32
    for name, got in zip(names, mv_int):
        assert_equal(got, want["full"][name], f"full-pel {name}")
    mv_q = ksp.subpel(cur, planes, PAD, mv_int, lam, WM, HM, shapes)
    assert mv_q.shape == mv_int.shape and mv_q.dtype == torch.int32
    for name, got in zip(names, mv_q):
        assert_equal(got, want["quarter"][name], f"quarter-pel {name}")
    if kind == "motion" and lam == 30:
        mv = tinter.motion_vectors(cur, ref_pad, planes, lam, WM, HM, R,
                                   shapes)
        assert list(mv) == names
        for name, got in zip(names, mv_q):
            assert_equal(mv[name], got, f"{name}")
    assert {**kfs.launches, **ksp.launches} == before
    if kind == "flat":
        assert not mv_int.any()


def test_subpel_plain_equals_per_block_calls():
    """KS's plain version (one `subpel_refine` pass a shape, the shape's
    vectors concatenated and chunked back) equals one call a block, on
    seeded full-pel vectors over the whole search range, at the ME lambdas
    of QP 0 and QP 51."""
    shapes = ksp.shapes(True, True)
    cur, _, planes = _torch_inputs("noise")
    rng = np.random.default_rng(3)
    mv_int = torch.as_tensor(rng.integers(-R, R + 1, (9, WM * HM, 2)),
                             dtype=torch.int32)
    mv_int[:, :4] = torch.tensor([[-R, -R], [-R, R], [R, -R], [R, R]],
                                 dtype=torch.int32)
    for lam in (LAMBDA_TABLE[0][2], LAMBDA_TABLE[51][2]):
        got = ksp.subpel_plain(cur, planes, PAD, mv_int, lam, WM, HM, shapes)
        for i, (oy, ox, bh, bw) in enumerate(ksp.shape_table(shapes)):
            want = tme.subpel_refine(cur, planes, PAD, mv_int[i], lam, WM,
                                     HM, oy=oy, ox=ox, bh=bh, bw=bw)
            assert_equal(got[i], want, f"block {i} lam {lam}")


@pytest.mark.parametrize("rows_mbs,cols_mbs", [(45, 80), (17, 120)],
                         ids=["720p_frame", "band_of_17_rows"])
def test_block_starts_stay_inside_the_planes(rows_mbs, cols_mbs):
    """With PAD 24 and r 16 no start that KF or KS reads needs a clamp:
    KF's window of every MB, and every quarter-pel block that KS forms
    (every partition, every vector KS can reach from a full-pel vector of
    the search range: 4 * [-16, 16] + [-3, 3], with the table's taps), lie
    inside the padded planes of a whole frame and of a 17-row band whose
    reference comes PAD-extended (`ref_prepadded`)."""
    hp, wp = 16 * rows_mbs + 2 * PAD, 16 * cols_mbs + 2 * PAD
    win = 16 + 2 * R
    for n_mbs, dim in ((rows_mbs, hp), (cols_mbs, wp)):
        starts = torch.arange(n_mbs) * 16 + PAD - R
        assert_equal(tki.clamp_start(starts, win, dim), starts, "window")
    v = torch.arange(-4 * R - 3, 4 * R + 4)
    taps = sorted({int(t) for t in tki.QPEL_TABLE[:, [1, 2, 4, 5]].flatten()})
    assert taps == [0, 1]
    for oy, ox, bh, bw in ksp.shape_table(ksp.shapes(True, True)):
        for n_mbs, dim, o, size in ((rows_mbs, hp, oy, bh),
                                    (cols_mbs, wp, ox, bw)):
            origin = torch.arange(n_mbs) * 16 + o + PAD
            starts = (origin[:, None, None] + (v >> 2)[None, :, None]
                      + torch.tensor(taps)[None, None, :]).flatten()
            assert int(starts.min()) == o + PAD - R - 1 >= 0
            assert_equal(tki.clamp_start(starts, size, dim), starts,
                         f"({oy}, {ox}, {bh}, {bw})")

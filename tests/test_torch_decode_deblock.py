"""The decoder's deblocking on the CPU: the port's wavefront deblocker
(`kernels.deblock.make_deblocker`, the plain version that kernel K4 is
held to on the card) with per-MB QP grids, FilterOffsetA/B, MB-edge masks
with slice edges in the middle of a row (idc 2), the 8x8 transform and
one- and two-list motion, against the scalar oracle
`tpu264.ref.deblock.deblock_frame` that the reference decoder runs;
exact.  Seeded inputs (`tools.synth_inputs.random_decode_deblock`), no
JAX program."""

import numpy as np
import pytest
import torch

from tpu264.ref import deblock as rd

from tpu264_torch.coding.wavefront import build_schedule
from tpu264_torch.kernels import deblock as tkd
from tpu264_torch.kernels import deblock_wave as k4w
from tpu264_torch.ref.transform import chroma_qp
from tpu264_torch.tools.synth_inputs import (random_deblock_picture,
                                             random_decode_deblock)

from torch_util import assert_equal, t32

WM, HM = 7, 5


def _port(d, qp=None, cqp=None, **kw):
    """The port's deblocker on the CPU with the inputs of `d`."""
    fn = tkd.make_deblocker(WM, HM)
    return fn(torch.as_tensor(d["y"]), torch.as_tensor(d["u"]),
              torch.as_tensor(d["v"]), torch.as_tensor(d["intra_mb"]),
              t32(d["tc_luma"]), t32(d["mv"]), t32(d["ref"]),
              t32(d["qp"]) if qp is None else qp,
              t32(d["cqp"]) if cqp is None else cqp, **kw)


def _oracle(d, qp=None, cqp=None, masks=True, t8=True, offsets=True):
    return rd.deblock_frame(
        d["y"], d["u"], d["v"], d["qp"] if qp is None else qp,
        d["cqp"] if cqp is None else cqp, d["intra_mb"], d["tc_luma"],
        d["mv"], d["ref"], d["left_ok"] if masks else _edges()[0],
        d["top_ok"] if masks else _edges()[1],
        t8=d["t8"] if t8 else None, off_a=d["off_a"] if offsets else 0,
        off_b=d["off_b"] if offsets else 0)


def _edges():
    """left_ok, top_ok of one slice: every MB edge but the picture's."""
    left = np.ones((HM, WM), bool)
    top = np.ones((HM, WM), bool)
    left[:, 0] = False
    top[0] = False
    return left, top


@pytest.mark.parametrize("idc", [0, 2])
@pytest.mark.parametrize("two_list", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_per_mb_qp_offsets_masks_t8_match_oracle(seed, two_list, idc):
    """Everything a decoded picture brings at once: per-MB QPs over 0-51
    (MB edges at the average of two MBs' QPs, luma and chroma grids),
    offsets, slice edges anywhere in a row, t8 MBs, motion per MB (one
    list) or per 4x4 block (two lists)."""
    d = random_decode_deblock(seed, WM, HM, two_list=two_list, idc=idc)
    got = _port(d, t8_mb=torch.as_tensor(d["t8"]),
                left_ok=torch.as_tensor(d["left_ok"]),
                top_ok=torch.as_tensor(d["top_ok"]), off_a=d["off_a"],
                off_b=d["off_b"])
    want = _oracle(d)
    for g, w, p in zip(got, want, (d["y"], d["u"], d["v"])):
        assert_equal(g, w)
        assert (np.asarray(w) != p).any()        # the filter did work


@pytest.mark.parametrize("off_a,off_b", [(-12, -12), (-2, 2), (12, 12),
                                         (12, -12)])
def test_offsets_match_oracle(off_a, off_b):
    """FilterOffsetA selects alpha and tc0, FilterOffsetB beta, each
    clipped to 0..51, at the edges of the extremes."""
    d = random_decode_deblock(7, WM, HM, idc=0)
    d["qp"] = np.clip(d["qp"], 20, 51).astype(np.int32)
    d["cqp"] = np.array([[chroma_qp(int(q)) for q in row]
                         for row in d["qp"]], np.int32)
    d["off_a"], d["off_b"] = off_a, off_b
    got = _port(d, off_a=off_a, off_b=off_b)
    want = _oracle(d, masks=False, t8=False)
    for g, w in zip(got, want):
        assert_equal(g, w)


@pytest.mark.parametrize("qp", [20, 33])
def test_uniform_qp_is_the_old_behaviour(qp):
    """One QP a picture, as the encoder deblocks: the grid form equals the
    int form the encoder passes (`make_deblocker_skewed`, idc 0 and idc 2
    on row slices) and the oracle at that scalar QP."""
    y, u, v, intra, tc, mv, ref = random_deblock_picture(qp, WM, HM)
    cqp = chroma_qp(qp)
    args = (torch.as_tensor(y), torch.as_tensor(u), torch.as_tensor(v),
            torch.as_tensor(intra), t32(tc), t32(mv), t32(ref))
    for slices, across in ((1, True), (5, False)):
        sched = build_schedule(WM, HM, slices)
        old = tkd.make_deblocker_skewed(sched, across)(*args, qp, cqp)
        left, top = _edges()
        if not across:
            top[sched.slice_starts.tolist()] = False
        grid = tkd.make_deblocker(WM, HM)(
            *args, t32(np.full((HM, WM), qp)), t32(np.full((HM, WM), cqp)),
            top_ok=torch.as_tensor(top))
        want = rd.deblock_frame(y, u, v, qp, cqp, intra, tc, mv, ref, left,
                                top)
        for o, g, w in zip(old, grid, want):
            assert_equal(o, w)
            assert_equal(g, w)


def test_masked_mb_edges_get_bs_zero():
    """An MB edge that must not be filtered has bS 0 before the launch
    (what the kernel and the plain version then skip); every other edge
    keeps the bS it had."""
    d = random_decode_deblock(3, WM, HM, idc=2)
    args = (torch.as_tensor(d["intra_mb"]), t32(d["tc_luma"]), t32(d["mv"]),
            t32(d["ref"]))
    bs_v, bs_h = tkd.bs_maps(*args)
    mv_, mh_ = tkd.bs_maps(*args, left_ok=torch.as_tensor(d["left_ok"]),
                           top_ok=torch.as_tensor(d["top_ok"]))
    left4 = np.repeat(d["left_ok"], 4, 0)
    top4 = np.repeat(d["top_ok"], 4, 1)
    assert not d["left_ok"].all() and not d["top_ok"][1:].all()
    assert (mv_.numpy()[:, ::4][~left4] == 0).all()
    assert (mh_.numpy()[::4][~top4] == 0).all()
    assert_equal(mv_[:, ::4][torch.as_tensor(left4)],
                 bs_v[:, ::4][torch.as_tensor(left4)])
    assert_equal(mh_[::4][torch.as_tensor(top4)],
                 bs_h[::4][torch.as_tensor(top4)])
    keep = np.ones(4 * WM, bool)
    keep[::4] = False
    assert_equal(mv_[:, torch.as_tensor(keep)], bs_v[:, torch.as_tensor(keep)])
    # the masked MB edges are among those that would have been filtered
    assert (bs_v.numpy()[:, ::4][~left4] > 0).any()


def test_per_line_thresholds_equal_scalar_ones():
    """The line filters with alpha, beta and tc0 per line equal the same
    filters run line by line with scalars."""
    rng = np.random.default_rng(4)
    lines = t32(rng.integers(60, 100, size=(6, 8)))
    bs = t32(rng.integers(0, 5, size=6))
    q = t32(rng.integers(15, 52, size=6))
    alpha, beta, tc0 = tkd.edge_params(q, 2, -4)
    got_l = tkd.filter_luma_lines_plain(lines, bs, alpha, beta, tc0)
    got_c = tkd.filter_chroma_lines(lines[:, 2:6].contiguous(), bs, alpha,
                                    beta, tc0)
    for i in range(6):
        ia = min(max(int(q[i]) + 2, 0), 51)
        ib = min(max(int(q[i]) - 4, 0), 51)
        a, b, t = tkd.ALPHA[ia], tkd.BETA[ib], tkd.TC0[ia]
        assert_equal(got_l[i], tkd.filter_luma_lines_plain(
            lines[i:i + 1], bs[i:i + 1], a, b, t)[0])
        assert_equal(got_c[i], tkd.filter_chroma_lines(
            lines[i:i + 1, 2:6], bs[i:i + 1], a, b, t)[0])


def test_deblocker_cached_per_geometry_and_cpu_runs_no_kernel():
    assert tkd.make_deblocker(WM, HM) is tkd.make_deblocker(WM, HM)
    assert tkd.make_deblocker(WM, HM) is not tkd.make_deblocker(WM, HM + 1)
    before = dict(k4w.launches)
    d = random_decode_deblock(5, WM, HM)
    _port(d)
    assert k4w.launches == before

"""The B frame engine on the CPU: the port's `make_b_encoder` (the plain
versions of K2's wave form and of the B wave kernel KB, `wave_body_plain`)
against the reference's `make_b_encoder` at QCIF, with the 16x8 / 8x16
partitions, on seeded frames whose bands move apart (so that L0, L1,
bi-predicted, direct, intra and partitioned MBs are chosen) and seeded
colzero and
colmixed masks, at QP 12, 28 and 40, with `allow_parts` on and off: every
recon plane and every per-wave result, tolerance 0.  Also: `b_wave_plain`
is the rest of `wave_body_plain`; KB's wrapper tables and pointer layout
against `csrc/b_wave.cu`; the seeded B waves of `synth_inputs` choose every
btype and every partition combination at the 1080p width; references
handed in already padded (`ref_prepadded`, the tiled encoder's) give
what edge padding inside the encoder gives."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu264.coding import b_frame as rb
from tpu264.coding.wavefront import build_schedule as ref_schedule

from tpu264_torch.coding import b_frame as tb
from tpu264_torch.coding import intra_frame as tif
from tpu264_torch.coding.wavefront import build_schedule
from tpu264_torch.kernels import b_wave as kb
from tpu264_torch.kernels import i16_chroma_wave as k3w
from tpu264_torch.kernels import i4x4_wave as k2w
from tpu264_torch.kernels import interp as tki
from tpu264_torch.ref.transform import chroma_qp
from tpu264_torch.tools.synth_inputs import random_b_wave

from torch_util import QCIF_H, QCIF_W, assert_equal, t32, to_np

CSRC = Path(tb.__file__).resolve().parents[1] / "csrc"
PAD = tb.PAD


def _frames():
    """Reference 0, the current frame and reference 1 (t = 0, 1, 2) of a
    seeded texture: the top three MB rows pan 4 samples a frame to the
    right, the next three move in 8-row bands to the right and to the left
    in turn, and the bottom three stand still on the left and move in
    8-column bands up and down on the right; a patch of the current frame
    is fresh noise, one matches only reference 0 and one only reference 1.
    Chroma is a smooth ramp."""
    r = np.random.default_rng(21)
    base = r.integers(0, 256, size=(QCIF_H + 64, QCIF_W + 64))
    base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)
            + np.roll(base, (1, 1), (0, 1))) // 4
    out = []
    for t in range(3):
        y = base[32:32 + QCIF_H, 32:32 + QCIF_W].copy()
        y[:48] = base[32:80, 32 + 4 * t:32 + 4 * t + QCIF_W]
        for row in range(48, 96):
            s = 4 * t if (row // 8) % 2 == 0 else -4 * t
            y[row] = base[row + 32, 32 + s:32 + s + QCIF_W]
        for col in range(112, QCIF_W):
            s = 4 * t if (col // 8) % 2 == 0 else -4 * t
            y[96:, col] = base[128 + s:128 + s + 48, col + 32]
        if t == 1:
            y[100:132, 16:48] = r.integers(0, 256, size=(32, 32))
        if t != 2:      # [112:128, 64:96] matches reference 0 only
            y[112:128, 64:96] = base[0:16, 0:32]
        if t != 0:      # [112:128, 96:112] matches reference 1 only
            y[112:128, 96:112] = base[0:16, 40:56]
        yy, xx = np.mgrid[0:QCIF_H // 2, 0:QCIF_W // 2]
        u = 100 + (xx + 2 * t) // 2 + yy // 3
        v = 160 - (yy + t) // 2 + xx // 5
        out.append(tuple(np.clip(p, 0, 255).astype(np.uint8)
                         for p in (y, u, v)))
    return out


FRAMES = _frames()
N_MBS = (QCIF_W // 16) * (QCIF_H // 16)
_R = np.random.default_rng(5)
COLZERO = _R.random(N_MBS) < 0.3
COLMIXED = _R.random(N_MBS) < 0.1
_REF = {}


def _reference(qp: int, allow: bool):
    """The reference's (recon dict, per-wave results) as numpy."""
    if "encode" not in _REF:
        _REF["encode"] = rb.make_b_encoder(
            ref_schedule(QCIF_W // 16, QCIF_H // 16, 1), search_range=16,
            partitions=True)
    (r0y, r0u, r0v), (y, u, v), (r1y, r1u, r1v) = FRAMES
    out, ys = _REF["encode"](y, u, v, r0y, r0u, r0v, r1y, r1u, r1v, COLZERO,
                             COLMIXED, np.int32(qp), np.bool_(allow))
    return ({k: np.asarray(a) for k, a in out.items()},
            {k: np.asarray(a) for k, a in ys.items()})


def _port(qp: int, allow: bool, partitions: bool = True):
    encode = tb.make_b_encoder(build_schedule(QCIF_W // 16, QCIF_H // 16, 1),
                               search_range=16, partitions=partitions)
    (r0y, r0u, r0v), (y, u, v), (r1y, r1u, r1v) = FRAMES
    planes = [torch.as_tensor(p) for p in (y, u, v, r0y, r0u, r0v, r1y, r1u,
                                           r1v)]
    return encode(*planes[:3], *planes[3:], torch.as_tensor(COLZERO),
                  torch.as_tensor(COLMIXED), qp, allow)


@pytest.mark.parametrize("allow", [True, False])
@pytest.mark.parametrize("qp", [12, 28, 40])
def test_b_encoder_matches_reference(qp, allow):
    want_out, want = _reference(qp, allow)
    got_out, got = _port(qp, allow)
    assert sorted(got) == sorted(want) == sorted(
        k for k in kb.outputs(True) if k not in ("recon_mb", "rec_u",
                                                 "rec_v"))
    for k in want_out:
        assert_equal(got_out[k], want_out[k], k)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert_equal(got[k], want[k], k)
    # what the frame exercised
    sched = build_schedule(QCIF_W // 16, QCIF_H // 16, 1)
    bt = to_np(got["btype"])[sched.valid]
    # L0, L1, direct and intra; Bi where the partitions (which take the
    # bands Bi would predict) are not allowed
    want_types = {0, 1, 3, 4, 5} if allow else {0, 1, 2, 3, 4}
    assert set(bt.tolist()) == want_types, np.bincount(bt)
    assert not (bt[COLMIXED[sched.mb_index[sched.valid]]] == 3).any()


def test_prepadded_references_equal_edge_padding():
    """`ref_prepadded`: references handed in already PAD-extended (the
    tiled encoder's band halos) give what the encoder's own edge padding
    gives when they are the edge-padded planes."""
    encode = tb.make_b_encoder(build_schedule(QCIF_W // 16, QCIF_H // 16, 1),
                               search_range=16, ref_prepadded=True,
                               partitions=True)
    (r0y, r0u, r0v), (y, u, v), (r1y, r1u, r1v) = FRAMES
    pads = [tki.pad_plane(torch.as_tensor(p), pad)
            for p, pad in zip((r0y, r0u, r0v, r1y, r1u, r1v),
                              (PAD, PAD // 2, PAD // 2) * 2)]
    got_out, got = encode(*(torch.as_tensor(p) for p in (y, u, v)), *pads,
                          torch.as_tensor(COLZERO),
                          torch.as_tensor(COLMIXED), 28, True)
    want_out, want = _port(28, True)
    assert sorted(got) == sorted(want)
    for k in {**want, **want_out}:
        assert_equal({**got, **got_out}[k], {**want, **want_out}[k], k)


def test_partitions_off_is_allow_parts_off():
    """Without the partitions the results are those of a frame that does
    not allow them."""
    out_a, ys_a = _port(28, False)
    out_b, ys_b = _port(28, True, partitions=False)
    assert sorted(ys_b) == sorted(k for k in kb.outputs(False)
                                  if k not in ("recon_mb", "rec_u", "rec_v"))
    for k in out_b:
        assert_equal(out_b[k], out_a[k], k)
    for k in ys_b:
        assert_equal(ys_b[k], ys_a[k], k)


def test_b_tables_match_reference():
    assert tb.TYPE_BITS == rb.TYPE_BITS
    assert tb.COMBO_IDX.tolist() == rb.COMBO_IDX.tolist()
    assert tb.TB_PART.tolist() == rb.TB_PART.tolist()
    for c0 in range(3):
        for c1 in range(3):
            for s in range(2):
                assert int(tb.part_mb_type(c0, c1, s)) == \
                    int(rb.part_mb_type(c0, c1, s))


def _wave(seed, wm=40, hm=20, qp=28):
    """A seeded B wave as the port's CPU arguments of `wave_body` (with the
    partitions), its maps and border buffers fresh."""
    (bd, maps, ref0, ref1, coords, avail, me0, me1, mp0, mp1, cz, cm, gy, gu,
     gv) = random_b_wave(seed, wm, hm)
    planes = tuple(tki.luma_planes(tki.pad_plane(t32(r[0]), PAD))
                   for r in (ref0, ref1))
    cpads = tuple(tki.pad_plane(t32(p), PAD // 2) for r in (ref0, ref1)
                  for p in r[1:])
    return ((tuple(t32(m) for m in maps), planes, cpads, qp, chroma_qp(qp),
             *tif.LAMBDA_TABLE[qp], {k: t32(v) for k, v in bd.items()}),
            (t32(coords), torch.as_tensor(avail), (t32(me0), t32(me1)),
             (t32(mp0), t32(mp1)), torch.as_tensor(cz), torch.as_tensor(cm),
             t32(gy), t32(gu), t32(gv)))


def test_b_wave_plain_composes_the_wave_body():
    """`b_wave_plain` (the plain version of KB) on the I4x4 results is the
    rest of `wave_body_plain`, and the CPU path launches no kernel."""
    consts, xs = _wave(11)
    maps, planes, cpads, qp, cqp, lam4, lam24, lam_me, bd = consts
    maps_a = tuple(m.clone() for m in maps)
    bd_a = {k: v.clone() for k, v in bd.items()}
    before = (dict(k2w.launches), dict(k3w.launches), dict(kb.launches))
    want = tb.wave_body_plain(maps_a, planes, cpads, qp, cqp, lam4, lam24,
                              lam_me, bd_a, *xs, True, True)
    assert before == (k2w.launches, k3w.launches, kb.launches)
    coords, avail, mv_me, mv_parts, cz, cm, gy, gu, gv = xs
    r, c = coords[:, 0].long(), coords[:, 1].long()
    ltop, lleft, _, _, _, _, mtop, mleft = tif.gather_border_ctx(bd, r, c)
    mb4, modebuf, modes, coeffs4, j4 = tif.eval_i4x4_plain(
        gy, ltop, lleft, mtop, mleft, *avail.unbind(1), qp, lam4, lam24)
    got = tb.b_wave_plain(bd, maps, planes, cpads, coords, avail, mv_me,
                          mv_parts, cz, cm, gy, gu, gv, mb4, modebuf,
                          coeffs4, j4, qp, cqp, lam4, lam24, lam_me, True,
                          True)
    assert "modes" not in got and list(want) == list(kb.outputs(True))
    assert_equal(modes, want["modes"])
    for k in got:
        assert_equal(got[k], want[k], k)
    for k in bd:
        assert_equal(bd[k], bd_a[k], k)
    for m, m_a in zip(maps, maps_a):
        assert_equal(m, m_a)


def test_random_b_waves_choose_every_btype():
    """At the 1080p width (60 lanes a wave), the seeded waves choose L0,
    L1, Bi, direct, intra and partitioned MBs, and every shape with every
    (c0, c1) of L0, L1, Bi; never direct on a colmixed lane."""
    btypes, combos = set(), set()
    for qp in (0, 28, 51):
        consts, xs = _wave(40 + qp, 120, 68, qp)
        out = tb.wave_body_plain(*consts, *xs, True, True)
        n = int((xs[0][:, 0] < 68).sum())
        bt = to_np(out["btype"])[:n]
        assert not (bt[to_np(xs[5])[:n]] == 3).any()
        btypes |= set(bt.tolist())
        part = bt == 5
        combos |= set(zip(*(to_np(out[k])[:n][part].tolist()
                            for k in ("bptype", "c0", "c1"))))
    assert btypes == {0, 1, 2, 3, 4, 5}
    assert len(combos) == 18


@pytest.mark.parametrize("qp,cqp", [(0, 0), (28, 26), (51, 39)])
def test_b_wave_params(qp, cqp):
    """KB's by-value tables: K3's wave-form table, the inter rounding
    offsets of both sets, the lambdas, the quarter-pel table, the flags
    and the mb_type bits of the partitions and of B_L0 / B_L1 / B_Bi."""
    lam4, lam24, lam_me = tif.LAMBDA_TABLE[qp]
    vals = list(kb.pack_params(qp, cqp, lam4, lam24, lam_me,
                               tuple(tif.BLK_ORDER), True, True))
    k3 = list(k3w.pack_params(qp, cqp, tuple(tif.BLK_ORDER)))
    assert vals[:len(k3)] == k3
    rest = vals[len(k3):]
    assert rest[:2] == [(1 << (15 + q // 6)) // 6 for q in (qp, cqp)]
    assert rest[2:5] == [lam4, lam24, lam_me]
    assert rest[5:117] == tki.QPEL_TABLE.reshape(-1).tolist()
    assert rest[117] == 3
    assert rest[118:136] == rb.TB_PART.reshape(-1).tolist()
    assert rest[136:] == list(rb.TYPE_BITS)
    for parts, allow, flags in ((False, True, 0), (True, False, 1)):
        assert list(kb.pack_params(qp, cqp, lam4, lam24, lam_me,
                                   tuple(tif.BLK_ORDER), parts, allow)
                    )[len(k3) + 117] == flags


def test_b_wave_layout_matches_kernel_source():
    """The frame wrapper's pointer list and table length against what
    `csrc/b_wave.cu` reads (the kernel cannot run here)."""
    src = (CSRC / "b_wave.cu").read_text()
    n_ptrs = int(re.search(r"constexpr int kPtrs = (\d+);", src).group(1))
    n_out = len(kb.OUTPUTS)
    n_part = len(kb.PART_OUTPUTS)
    # borders, 4 maps, 2 planes, 4 chroma, coords, avail, 2 + 2 vectors,
    # colzero, colmixed, 3 sources
    assert n_ptrs == len(k3w.BORDERS) + 21 + n_part + n_out
    order = re.search(r"struct FrameIo \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"\*\s*(\w+)[,;]", order)
    assert names[-n_out:] == list(kb.OUTPUTS)
    assert names[-n_out - n_part:-n_out] == list(kb.PART_OUTPUTS)
    assert len(kb.pack_params(28, 28, 23, 140, 6, tuple(tif.BLK_ORDER))) \
        == kb.PARAMS_LEN == 2 * 55 + 32 + 5 + 16 * 7 + 1 + 18 + 3
    # the wrapper hands over as many pointers, on a picture of one wave
    consts, xs = _wave(2)
    maps, planes, cpads, qp, cqp, lam4, lam24, lam_me, bd = consts
    a = kb.frame_args(bd, maps, planes, cpads, *_one_wave_picture(xs), qp,
                      cqp, lam4, lam24, lam_me, tuple(tif.BLK_ORDER),
                      tif._K2_RULES,
                      kb.alloc_outputs((1, xs[0].shape[0]), "cpu", True),
                      True, True)
    assert len(a.tensors) == n_ptrs and a.waves == (0, 1)


def _one_wave_picture(xs):
    """A wave's arrays (coords, avail, mv_me, mv_parts, cz, cm, gy, gu, gv)
    as the wave table of a picture of one wave."""
    pair = lambda p: tuple(t.unsqueeze(0) for t in p)
    coords, avail, mv_me, mv_parts, cz, cm, gy, gu, gv = xs
    return (coords.unsqueeze(0), avail.unsqueeze(0), pair(mv_me),
            pair(mv_parts), cz.unsqueeze(0), cm.unsqueeze(0),
            gy.unsqueeze(0), gu.unsqueeze(0), gv.unsqueeze(0))


def test_b_wave_refuses_cpu_tensors():
    consts, xs = _wave(2)
    maps, planes, cpads, qp, cqp, lam4, lam24, lam_me, bd = consts
    with pytest.raises(ValueError, match="CUDA"):
        kb.b_frame(bd, maps, planes, cpads, *_one_wave_picture(xs), qp, cqp,
                   lam4, lam24, lam_me, tuple(tif.BLK_ORDER), tif._K2_RULES,
                   kb.alloc_outputs((1, xs[0].shape[0]), "cpu", True), True,
                   True)

"""The frame form of the inter wave kernels KP and KB on the CPU: what
their wrappers lay out for one launch a picture against what the per-wave
loop handed the kernels a wave, and their plain versions (`p_frame_plain`,
`b_frame_plain`) against that loop of `wave_body_plain`.  No JAX, no
reference encoder: the kernels cannot run here, and the wave bodies are
held to the reference elsewhere (`test_torch_p_wave.py`,
`test_torch_b_wave.py`, the stream tests)."""

import numpy as np
import pytest
import torch

from tpu264_torch.coding import b_frame as tb
from tpu264_torch.coding import inter_frame as tinter
from tpu264_torch.coding import intra_frame as tif
from tpu264_torch.coding.wavefront import build_schedule
from tpu264_torch.kernels import _build
from tpu264_torch.kernels import b_wave as kb
from tpu264_torch.kernels import i4x4_wave as k2w
from tpu264_torch.kernels import interp as kint
from tpu264_torch.kernels import p_wave as kp
from tpu264_torch.ref.transform import chroma_qp

from torch_util import assert_equal

I32 = torch.int32
PAD = tinter.PAD
H100_BLOCKS = 132           # one block of 416 threads an SM
FULL = kp.Tools(True, True, True)


def _picture(sched, seed: int):
    """Seeded planes of the schedule's picture and the wave table the
    encoders build from them: (coords, avail, mv_me, mv_parts [8 a lane],
    mv_halves (two [4 a lane]), colzero, colmixed, gy, gu, gv)."""
    rng = np.random.default_rng(seed)
    h, w = 16 * sched.height_mbs, 16 * sched.width_mbs
    y, u, v = (torch.as_tensor(rng.integers(0, 256, s), dtype=I32)
               for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
    n = sched.n_mbs
    idx = torch.as_tensor(np.minimum(sched.mb_index, n - 1))
    vec = lambda *s: torch.as_tensor(rng.integers(-40, 40, (n,) + s),
                                     dtype=I32)[idx]
    flag = lambda: torch.as_tensor(rng.random(n) < 0.3)[idx]
    gy, gu, gv = tif.tile_origin_xs(sched, y, u, v)
    return (torch.as_tensor(sched.coords, dtype=I32),
            torch.as_tensor(sched.avail), vec(2), vec(8, 2),
            (vec(4, 2), vec(4, 2)), flag(), flag(), gy, gu, gv)


def _refs(sched, seed: int):
    """A reference picture as the encoders hand it to the kernels: its
    half-pel planes and padded chroma."""
    rng = np.random.default_rng(seed)
    h, w = 16 * sched.height_mbs, 16 * sched.width_mbs
    ry = torch.as_tensor(rng.integers(0, 256, (h, w)), dtype=I32)
    ru, rv = (torch.as_tensor(rng.integers(0, 256, (h // 2, w // 2)),
                              dtype=I32) for _ in range(2))
    return (kint.luma_planes(kint.pad_plane(ry, PAD)),
            kint.pad_plane(ru, PAD // 2), kint.pad_plane(rv, PAD // 2))


def _state(sched):
    hm, wm = sched.height_mbs, sched.width_mbs
    return (tif.init_border_buffers(hm, wm, "cpu"),
            torch.zeros((3, hm + 2, wm + 2, 2), dtype=I32),
            torch.full((3, hm + 2, wm + 2), -2, dtype=I32))


def _rows(t, w):
    return None if t is None else t[w]


# the 720p, 1080p and 4K pictures and a 17-row band of the tiled 1080p
# encoder: (width, height in MBs)
SCHEDULES = {"720p": (80, 45), "1080p": (120, 68), "4k": (240, 135),
             "band17": (120, 17)}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_p_frame_layout_equals_the_wave_loop(name):
    """KP's frame wrapper hands the kernel, once a picture, the per-wave
    tables the wave loop handed it a wave: row w of each per-wave array
    is that wave's array, the wave range is the whole picture, the packed
    tables are those of the frame's QP, tools and (wy, oy) (KP's and K2's,
    which the loop packed for its two launches), the geometry is the
    loop's, and a block takes one lane a wave on an H100."""
    wm, hm = SCHEDULES[name]
    sched = build_schedule(wm, hm, 1)
    coords, avail, mv_me, mv_parts, _, _, _, gy, gu, gv = _picture(sched, 1)
    planes, cu, cv = _refs(sched, 2)
    bd, mv_map, ref_map = _state(sched)
    qp, wp = {"720p": (28, (58, -7)), "1080p": (30, (64, 0)),
              "4k": (34, (71, 12)), "band17": (26, (64, 0))}[name]
    cqp = chroma_qp(qp, 0)
    lam = tif.LAMBDA_TABLE[qp]
    out = kp.alloc_outputs((sched.n_waves, sched.max_wave), "cpu", FULL)
    a = kp.frame_args(bd, mv_map, ref_map, planes, cu, cv, coords, avail,
                      mv_me, gy, gu, gv, qp, cqp, *lam,
                      tuple(tif._BLK_ORDER), tif._K2_RULES, out, mv_parts,
                      FULL, *wp)
    assert a.waves == (0, sched.n_waves) and a.bmax == sched.max_wave
    assert a.geom == [wm, hm, *planes.shape[1:], *cu.shape]
    assert list(a.params) == list(kp.pack_params(
        qp, cqp, *lam, tuple(tif._BLK_ORDER), FULL, *wp))
    assert list(a.i4params) == list(k2w.pack_params(qp, lam[0], lam[1],
                                                    tif._K2_RULES))
    assert list(a.params)[-2:] == list(wp)
    table = dict(zip(("coords", "avail", "mv_me", "mv_parts", "gy", "gu",
                      "gv"), a.tensors[13:20]))
    outs = a.tensors[-len(kp.OUTPUTS):]
    for w in range(sched.n_waves):
        # what the loop passed for wave w
        loop = dict(coords=torch.as_tensor(sched.coords[w], dtype=I32),
                    avail=torch.as_tensor(sched.avail[w]), mv_me=mv_me[w],
                    mv_parts=mv_parts[w], gy=gy[w], gu=gu[w], gv=gv[w])
        for k, t in loop.items():
            assert_equal(table[k][w], t, k)
        for k, t in zip(kp.OUTPUTS, outs):
            assert t[w].data_ptr() == out[k][w].data_ptr()
    assert [t is None for t in a.tensors].count(True) == 0
    assert _build.frame_grid(a.bmax, H100_BLOCKS) == (sched.max_wave, 1)
    assert _build.frame_grid(a.bmax, 16) == (16, -(-sched.max_wave // 16))


@pytest.mark.parametrize("name", ["1080p", "band17"])
def test_b_frame_layout_equals_the_wave_loop(name):
    """KB's frame wrapper, as KP's: the per-wave tables of both lists and
    the colocated flags, the range, KB's and K2's tables, the geometry;
    without partitions their outputs get no pointer."""
    wm, hm = SCHEDULES[name]
    sched = build_schedule(wm, hm, 1)
    (coords, avail, mv_me0, _, halves, cz, cm, gy, gu,
     gv) = _picture(sched, 3)
    mv_me = (mv_me0, mv_me0.flip(-1).contiguous())
    (p0, u0, v0), (p1, u1, v1) = _refs(sched, 4), _refs(sched, 5)
    bd, m0, r0 = _state(sched)
    maps = (m0, r0, m0.clone(), r0.clone())
    qp, cqp = 32, chroma_qp(32, 0)
    lam = tif.LAMBDA_TABLE[qp]
    for parts in (True, False):
        out = kb.alloc_outputs((sched.n_waves, sched.max_wave), "cpu", parts)
        a = kb.frame_args(bd, maps, (p0, p1), (u0, v0, u1, v1), coords,
                          avail, mv_me, halves if parts else None, cz, cm,
                          gy, gu, gv, qp, cqp, *lam, tuple(tif._BLK_ORDER),
                          tif._K2_RULES, out, parts, True)
        assert a.waves == (0, sched.n_waves) and a.bmax == sched.max_wave
        assert list(a.params) == list(kb.pack_params(
            qp, cqp, *lam, tuple(tif._BLK_ORDER), parts, True))
        assert list(a.i4params) == list(k2w.pack_params(
            qp, lam[0], lam[1], tif._K2_RULES))
        assert a.geom == [wm, hm, *p0.shape[1:], *u0.shape]
        table = a.tensors[8 + 10:8 + 10 + 11]
        parts_at = [t for t in a.tensors[-len(kb.OUTPUTS)
                                         - len(kb.PART_OUTPUTS):
                                         -len(kb.OUTPUTS)]]
        assert all((t is None) != parts for t in parts_at)
        halves_or_me = halves if parts else mv_me
        for w in range(0, sched.n_waves, 7):
            loop = (torch.as_tensor(sched.coords[w], dtype=I32),
                    torch.as_tensor(sched.avail[w]), mv_me[0][w],
                    mv_me[1][w], halves_or_me[0][w], halves_or_me[1][w],
                    cz[w], cm[w], gy[w], gu[w], gv[w])
            for t, want in zip(table, loop):
                assert_equal(t[w], want)
        assert _build.frame_grid(a.bmax, H100_BLOCKS)[1] == 1
    with pytest.raises(ValueError, match="waves"):
        kb.frame_args(bd, maps, (p0, p1), (u0, v0, u1, v1), coords, avail,
                      mv_me, None, cz, cm, gy, gu, gv, qp, cqp, *lam,
                      tuple(tif._BLK_ORDER), tif._K2_RULES, out, False,
                      False, waves=(3, sched.n_waves + 1))


def _p_loop(planes, cu, cv, consts, state, table, tools, wy, oy):
    """The per-wave CPU loop as the encoder ran it: `wave_body_plain` a
    wave, the results stacked."""
    coords, avail, mv_me, mv_parts, _, _, _, gy, gu, gv = table
    waves = [tinter.wave_body_plain(
        planes, cu, cv, *consts, *state, coords[w], avail[w], mv_me[w],
        gy[w], gu[w], gv[w], _rows(mv_parts, w), tools, wy, oy)
        for w in range(coords.shape[0])]
    return {k: torch.stack([r[k] for r in waves]) for k in waves[0]}


def test_frame_plain_equals_the_wave_loop():
    """`p_frame_plain` and `b_frame_plain` (what KP and KB are held to)
    equal the per-wave loop of `wave_body_plain` on one small picture,
    every result, the border buffers and the maps; and a picture run as
    two wave ranges equals it run whole."""
    sched = build_schedule(6, 4, 2)         # two slices: a slice edge too
    table = _picture(sched, 7)
    planes, cu, cv = _refs(sched, 8)
    qp = 28
    consts = (qp, chroma_qp(qp, 0), *tif.LAMBDA_TABLE[qp])
    coords, avail, mv_me, mv_parts, halves, cz, cm, gy, gu, gv = table
    for tools, wp in ((kp.NO_TOOLS, (64, 0)), (FULL, (58, -7))):
        parts = mv_parts if tools.partitions else None
        s_loop, s_frame, s_split = _state(sched), _state(sched), \
            _state(sched)
        want = _p_loop(planes, cu, cv, consts, s_loop,
                       table[:3] + (parts,) + table[4:], tools, *wp)
        got = tinter.p_frame_plain(planes, cu, cv, *consts, *s_frame,
                                   coords, avail, mv_me, gy, gu, gv, parts,
                                   tools, *wp)
        out = kp.alloc_outputs(coords.shape[:2], "cpu", tools)
        for rng in ((0, 5), (5, sched.n_waves)):
            tinter.p_frame_plain(planes, cu, cv, *consts, *s_split, coords,
                                 avail, mv_me, gy, gu, gv, parts, tools,
                                 *wp, out=out, waves=rng)
        assert list(got) == list(want) == list(out)
        for k in want:
            assert_equal(got[k], want[k], k)
            assert_equal(out[k], want[k], k)
        for s in (s_frame, s_split):
            for k in s_loop[0]:
                assert_equal(s[0][k], s_loop[0][k], k)
            assert_equal(s[1], s_loop[1])
            assert_equal(s[2], s_loop[2])
    # B: both lists, partitions allowed
    (r0, c0u, c0v), (r1, c1u, c1v) = _refs(sched, 9), _refs(sched, 10)
    mv_me_b = (mv_me, mv_me.flip(-1).contiguous())
    bstate = lambda: (lambda s: (s[0], (s[1], s[2], s[1].clone(),
                                        s[2].clone())))(_state(sched))
    (bd_l, maps_l), (bd_f, maps_f) = bstate(), bstate()
    args = ((r0, r1), (c0u, c0v, c1u, c1v), *consts)
    rows = [tb.wave_body_plain(maps_l, *args, bd_l, coords[w], avail[w],
                               (mv_me_b[0][w], mv_me_b[1][w]),
                               (halves[0][w], halves[1][w]), cz[w], cm[w],
                               gy[w], gu[w], gv[w], True, True)
            for w in range(sched.n_waves)]
    want = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
    got = tb.b_frame_plain(maps_f, *args, bd_f, coords, avail, mv_me_b,
                           halves, cz, cm, gy, gu, gv, True, True)
    assert list(got) == list(want)
    for k in want:
        assert_equal(got[k], want[k], k)
    for k in bd_l:
        assert_equal(bd_f[k], bd_l[k], k)
    for m_f, m_l in zip(maps_f, maps_l):
        assert_equal(m_f, m_l)

"""The port's wavefront intra encoder (`make_intra_encoder`) against the
JAX reference: every per-MB output and the recon planes, exact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu264.coding import intra_frame as rif
from tpu264.coding.wavefront import build_schedule as ref_schedule
from tpu264.media.synth import synth_frame

from tpu264_torch.coding import intra_frame as tif
from tpu264_torch.coding.wavefront import build_schedule

from torch_util import assert_equal, random_i4x4_lanes, t32, to_np

W, H = 176, 144
_REF = {}


@pytest.fixture(scope="module")
def ref_encoder():
    """One jitted reference encoder per slice layout (QP is traced)."""
    def get(slices):
        if slices not in _REF:
            sched = ref_schedule(W // 16, H // 16, slices)
            _REF[slices] = (sched, rif.make_intra_encoder(sched))
        return _REF[slices]
    return get


def _frame(seed):
    return synth_frame(W, H, t=seed, seed=7 + seed)


def _both(ref_encoder, planes, qp, slices):
    sched, enc = ref_encoder(slices)
    r_out, r_ys = enc(*(jnp.asarray(p) for p in planes), np.int32(qp))
    r_mb = rif.reorder_wave_outputs(sched, r_ys)
    tsched = build_schedule(W // 16, H // 16, slices)
    t_out, t_ys = tif.make_intra_encoder(tsched)(
        *(torch.as_tensor(p) for p in planes), qp)
    t_mb = tif.reorder_wave_outputs(tsched, t_ys)
    return r_out, r_mb, t_out, t_mb


@pytest.mark.parametrize("slices", [1, 3])
@pytest.mark.parametrize("qp", [12, 28, 40])
def test_intra_encoder_matches_reference(ref_encoder, qp, slices):
    r_out, r_mb, t_out, t_mb = _both(ref_encoder, _frame(qp), qp, slices)
    assert set(t_mb) == set(r_mb)
    for k in r_mb:
        assert_equal(t_mb[k], r_mb[k], k)
    for k in ("recon_y", "recon_u", "recon_v"):
        assert_equal(t_out[k], r_out[k], k)
    # both mode families are exercised
    sel = to_np(t_mb["sel16"]).astype(bool)
    assert sel.any() or qp < 20
    assert (~sel).any()


def test_flat_frame_ties(ref_encoder):
    """A flat picture makes every I16x16 and chroma mode cost the same:
    the first minimum must win on both sides."""
    y = np.full((H, W), 128, np.uint8)
    u = np.full((H // 2, W // 2), 128, np.uint8)
    r_out, r_mb, t_out, t_mb = _both(ref_encoder, (y, u, u.copy()), 28, 1)
    for k in r_mb:
        assert_equal(t_mb[k], r_mb[k], k)


def test_wave_outputs_stacked_like_reference(ref_encoder):
    planes = _frame(5)
    sched, enc = ref_encoder(1)
    _, r_ys = enc(*(jnp.asarray(p) for p in planes), np.int32(30))
    _, t_ys = tif.make_intra_encoder(build_schedule(W // 16, H // 16, 1))(
        *(torch.as_tensor(p) for p in planes), 30)
    valid = sched.valid
    for k, v in r_ys.items():
        assert tuple(t_ys[k].shape) == tuple(v.shape), k
        assert_equal(to_np(t_ys[k])[valid], np.asarray(v)[valid], k)


@pytest.mark.parametrize("qp", [0, 17, 36, 51])
def test_eval_i16_and_chroma_random_lanes(qp):
    """eval_i16 / eval_chroma on random lanes with random availability."""
    rng = np.random.default_rng(qp)
    b = 12
    orig = rng.integers(0, 256, size=(b, 16, 16))
    ltop = rng.integers(0, 256, size=(b, 25))
    lleft = rng.integers(0, 256, size=(b, 16))
    av = rng.integers(0, 2, size=(3, b)).astype(bool)
    want = rif.eval_i16(jnp.asarray(orig, jnp.int32),
                        jnp.asarray(ltop, jnp.int32),
                        jnp.asarray(lleft, jnp.int32),
                        *(jnp.asarray(a) for a in av), qp)
    got = tif.eval_i16(t32(orig), t32(ltop), t32(lleft),
                       *(torch.as_tensor(a) for a in av), qp)
    for g, w in zip(got, want):
        assert_equal(g, w)
    ou = rng.integers(0, 256, size=(b, 8, 8))
    ov = rng.integers(0, 256, size=(b, 8, 8))
    tu = rng.integers(0, 256, size=(b, 9))
    lu = rng.integers(0, 256, size=(b, 8))
    tv = rng.integers(0, 256, size=(b, 9))
    lv = rng.integers(0, 256, size=(b, 8))
    cqp = min(qp, 39)
    wm, wouts = rif.eval_chroma(*(jnp.asarray(a, jnp.int32)
                                  for a in (ou, ov, tu, lu, tv, lv)),
                                *(jnp.asarray(a) for a in av), cqp)
    gm, gouts = tif.eval_chroma(*(t32(a) for a in (ou, ov, tu, lu, tv, lv)),
                                *(torch.as_tensor(a) for a in av), cqp)
    assert_equal(gm, wm)
    for go, wo in zip(gouts, wouts):
        for g, w in zip(go, wo):
            assert_equal(g, w)


@pytest.mark.parametrize("qp", [0, 17, 36, 51])
def test_eval_i4x4_random_lanes(qp):
    """eval_i4x4 (on the CPU: the plain version the wave kernel is held
    to) against the reference on lanes over all availability combinations,
    -1/-2 neighbour modes and flat content: all five outputs equal."""
    ints, flags = random_i4x4_lanes(qp)[:5], random_i4x4_lanes(qp)[5:]
    lam4, lam24 = tif.LAMBDA_TABLE[qp]
    want = rif.eval_i4x4(*(jnp.asarray(a, jnp.int32) for a in ints),
                         *(jnp.asarray(a) for a in flags), qp, lam4, lam24)
    got = tif.eval_i4x4(*(t32(a) for a in ints),
                        *(torch.as_tensor(a) for a in flags), qp, lam4, lam24)
    assert len(got) == len(want) == 5
    for name, g, w in zip(("recon", "mode grid", "modes", "levels", "cost"),
                          got, want):
        assert_equal(g, w, name)
    modes = to_np(got[2])
    assert len(np.unique(modes)) >= 5          # the search is exercised

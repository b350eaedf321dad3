"""The port's wavefront P-frame encoder (`make_inter_encoder`) against
the JAX reference's: every per-MB output and the three recon planes at
QCIF for QP 20/28/40 with 1 and 3 slices, and the P-slice CAVLC
serializer on the resulting MB dict.  Tolerance 0."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu264.coding import inter_frame as rinter
from tpu264.coding import intra_frame as rif
from tpu264.coding.wavefront import build_schedule as ref_schedule
from tpu264.entropy import device_cavlc as rdc
from tpu264.media.synth import synth_frame

from tpu264_torch.coding import inter_frame as tinter
from tpu264_torch.coding import intra_frame as tif
from tpu264_torch.coding.wavefront import build_schedule
from tpu264_torch.entropy import device_cavlc as tdc

from torch_util import assert_equal, to_np

W, H = 176, 144
WM, HM = W // 16, H // 16
_REF = {}
_BOTH = {}


@pytest.fixture(scope="module")
def ref_encoder():
    """One jitted reference P encoder per slice layout (QP is traced)."""
    def get(slices):
        if slices not in _REF:
            sched = ref_schedule(WM, HM, slices)
            _REF[slices] = (sched, rinter.make_inter_encoder(sched))
        return _REF[slices]
    return get


def _frames(qp):
    """(current, reference) planes: a moving synthetic frame; a patch of
    the current frame is noise that no motion vector explains, so the
    picture mixes skipped, inter and intra MBs."""
    cur = [p.copy() for p in synth_frame(W, H, t=qp % 7 + 1)]
    ref = synth_frame(W, H, t=qp % 7)
    rng = np.random.default_rng(qp)
    cur[0][48:96, 64:128] = rng.integers(0, 256, (48, 64), dtype=np.uint8)
    cur[0][:16, :48] = ref[0][:16, :48]          # a static corner
    return cur, ref


def _both(ref_encoder, qp, slices):
    key = (qp, slices)
    if key not in _BOTH:
        cur, ref = _frames(qp)
        sched, enc = ref_encoder(slices)
        r_out, r_ys = enc(*(jnp.asarray(p) for p in cur + list(ref)),
                          np.int32(qp))
        r_mb = rif.reorder_wave_outputs(sched, r_ys)
        tsched = build_schedule(WM, HM, slices)
        t_out, t_ys = tinter.make_inter_encoder(tsched)(
            *(torch.as_tensor(p) for p in cur + list(ref)), qp)
        t_mb = tif.reorder_wave_outputs(tsched, t_ys)
        _BOTH[key] = (r_out, r_mb, t_out, t_mb, tsched)
    return _BOTH[key]


@pytest.mark.parametrize("slices", [1, 3])
@pytest.mark.parametrize("qp", [20, 28, 40])
def test_inter_encoder_matches_reference(ref_encoder, qp, slices):
    r_out, r_mb, t_out, t_mb, _ = _both(ref_encoder, qp, slices)
    assert set(t_mb) == set(r_mb)
    for k in r_mb:
        assert_equal(t_mb[k], r_mb[k], k)
    for k in ("recon_y", "recon_u", "recon_v"):
        assert_equal(t_out[k], r_out[k], k)
    is_inter = to_np(t_mb["is_inter"]).astype(bool)
    assert is_inter.any() and (~is_inter).any()
    assert np.any(to_np(t_mb["mv"])[is_inter] != 0)


@pytest.mark.parametrize("slices", [1, 3])
@pytest.mark.parametrize("qp", [28, 40])
def test_serialize_frame_p_matches_reference(ref_encoder, qp, slices):
    _, r_mb, _, t_mb, tsched = _both(ref_encoder, qp, slices)
    rows = tsched.slice_starts.tolist()
    want_v, want_l, want_s = rdc.serialize_frame_p_j(r_mb, WM, HM, rows)
    got_v, got_l, got_s = tdc.serialize_frame_p(t_mb, WM, HM, rows)
    assert tuple(got_v.shape) == (WM * HM, tdc.MB_SLOTS_P)
    assert_equal(got_s, want_s, "skipped")
    assert_equal(got_l, want_l, "lengths")
    assert_equal(got_v, want_v, "values")
    if qp == 40:
        assert to_np(got_s).any()


@pytest.mark.parametrize("slices", [1, 3])
def test_neighbor_mvs_match_np_oracle(slices):
    """`_neighbor_mvs` (shifted arrays) against the port's copy of the
    scalar `neighbor_mvs_np`."""
    from tpu264_torch.coding import mvpred
    rng = np.random.default_rng(slices)
    ref_map = rng.choice([mvpred.INTRA, 0], (HM, WM))
    mv_map = rng.integers(-30, 31, (HM, WM, 2)) * (ref_map == 0)[..., None]
    rows = build_schedule(WM, HM, slices).slice_starts.tolist()
    want = mvpred.neighbor_mvs_np(mv_map, ref_map, WM, HM, rows)
    got = tdc._neighbor_mvs(torch.as_tensor(mv_map, dtype=torch.int32),
                            torch.as_tensor(ref_map, dtype=torch.int32),
                            WM, HM, rows)
    for k in want:
        assert_equal(got[k], want[k], k)


@pytest.mark.parametrize("kwargs", [
    dict(partitions=True), dict(partitions=True, p8x8=True), dict(t8=True),
    dict(weighted=True)])
def test_unported_tools_raise(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tinter.make_inter_encoder(build_schedule(WM, HM, 1), **kwargs)


def test_ref_prepadded_equals_edge_padding():
    """A caller that pads the reference itself gets the same frame."""
    from tpu264_torch.kernels import interp as tki
    cur, ref = _frames(28)
    sched = build_schedule(WM, HM, 1)
    t = [torch.as_tensor(p) for p in cur + list(ref)]
    out_a, ys_a = tinter.make_inter_encoder(sched)(*t, 28)
    padded = [tki.pad_plane(t[3], tinter.PAD),
              tki.pad_plane(t[4], tinter.PAD // 2),
              tki.pad_plane(t[5], tinter.PAD // 2)]
    out_b, ys_b = tinter.make_inter_encoder(sched, ref_prepadded=True)(
        *t[:3], *padded, 28)
    for k in ys_a:
        assert_equal(ys_b[k], ys_a[k], k)
    for k in out_a:
        assert_equal(out_b[k], out_a[k], k)

"""The port's CUDA kernels and its encoder on the card, held to the plain
torch versions on the CPU with tolerance 0.

Every test here is marked `cuda` and skips without a card.  The file
imports neither jax nor `tpu264`, so it also runs where only torch is
installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

from pathlib import Path

import numpy as np
import pytest

import torch

from tpu264_torch.coding import b_frame as tb
from tpu264_torch.coding import inter_frame as tinter
from tpu264_torch.coding import intra_frame as tif
from tpu264_torch.coding.encoder import Encoder
from tpu264_torch.coding.wavefront import build_schedule
from tpu264_torch.decode import Decoder
from tpu264_torch.config import EncoderConfig
from tpu264_torch.kernels import dct_quant as dq
from tpu264_torch.kernels import deblock as kd
from tpu264_torch.kernels import deblock_lines as dl
from tpu264_torch.kernels import deblock_wave as k4w
from tpu264_torch.kernels import i16_chroma_wave as k3w
from tpu264_torch.kernels import i4x4_wave as k2w
from tpu264_torch.kernels import b_wave as kb
from tpu264_torch.kernels import cabac_records as kcr
from tpu264_torch.kernels import cavlc_slices as kcv
from tpu264_torch.kernels import mb_preds
from tpu264_torch.kernels import interp as kint
from tpu264_torch.kernels import me_search as kme_search
from tpu264_torch.kernels import me_subpel as kme_subpel
from tpu264_torch.kernels import p_wave as kp
from tpu264_torch.media.synth import synth_frame
from tpu264_torch.ref import deblock as rd
from tpu264_torch.ref.transform import chroma_qp
from tpu264_torch.entropy import cabac_binarize as tcb
from tpu264_torch.entropy import cabac_engine_cuda as k1
from tpu264_torch.tools.synth_inputs import random_b_mbs, random_b_wave, \
    random_deblock_picture, random_decode_deblock, random_mbs, random_p_wave, \
    random_p_wave_tools, random_wave, random_wave_chunk

from torch_util import assert_equal, carry_records, cuda_device, \
    long_run_records, random_i4x4_lanes, random_records, run_engine, t32, \
    to_np

rng = np.random.default_rng(11)


@pytest.mark.cuda
@pytest.mark.parametrize("qp", [0, 28, 51])
def test_cuda_dct_quant_matches_plain(qp):
    dev = cuda_device()
    before = {**dq.launches, **k2w.launches}
    for n in (40, 640, 57600):
        x = t32(rng.integers(-255, 256, size=(n, 4, 4)), dev)
        for intra in (True, False):
            assert_equal(dq.fdct_quant4x4(x, qp, intra),
                         dq.fdct_quant4x4_plain(x, qp, intra))
        assert_equal(dq.fdct4x4(x), dq.fdct4x4_plain(x))
    assert dq.launches["K2_blocks"] == before["K2_blocks"] + 6
    assert k2w.launches["K2"] == before["K2"]
    assert dq.launches["K3_blocks"] == before["K3_blocks"] + 3


@pytest.mark.cuda
@pytest.mark.parametrize("qp", [0, 17, 28, 51])
def test_cuda_i4x4_wave_matches_plain(qp):
    """The I4x4 wave kernel against `eval_i4x4_plain` on the CPU and on
    the card: all five outputs, every availability combination, -1/-2
    neighbour modes, flat lanes; one launch, counted as K2."""
    dev = cuda_device()
    arrs = random_i4x4_lanes(100 + qp, reps=3)
    lam4, lam24, _ = tif.LAMBDA_TABLE[qp]
    ints = [t32(a, dev) for a in arrs[:5]]
    # the flags as the wave loop passes them: strided views of one tensor
    flags = torch.as_tensor(np.stack(arrs[5:], 1), device=dev).unbind(1)
    before = {**dq.launches, **k2w.launches}
    got = tif.eval_i4x4(*ints, *flags, qp, lam4, lam24)
    torch.cuda.synchronize()
    assert k2w.launches["K2"] == before["K2"] + 1
    assert dq.launches["K2_blocks"] == before["K2_blocks"]
    on_card = tif.eval_i4x4_plain(*ints, *flags, qp, lam4, lam24)
    on_cpu = tif.eval_i4x4(*(t32(a) for a in arrs[:5]),
                           *(torch.as_tensor(a) for a in arrs[5:]),
                           qp, lam4, lam24)
    for name, g, w, c in zip(("recon", "mode grid", "modes", "levels",
                              "cost"), got, on_card, on_cpu):
        assert g.dtype == torch.int32 and g.shape == w.shape, name
        assert_equal(g, w, name)
        assert_equal(g, c, name)


@pytest.mark.cuda
def test_cuda_i4x4_wave_rejects_bad_input():
    dev = cuda_device()
    arrs = random_i4x4_lanes(5, reps=1)
    ints = [t32(a, dev) for a in arrs[:5]]
    flags = [torch.as_tensor(a, device=dev) for a in arrs[5:]]
    with pytest.raises(TypeError):
        tif.eval_i4x4(ints[0].to(torch.int64), *ints[1:], *flags, 28, 23, 140)
    with pytest.raises(ValueError):
        tif.eval_i4x4(ints[0].transpose(1, 2), *ints[1:], *flags, 28, 23, 140)
    with pytest.raises(ValueError):
        tif.eval_i4x4(*ints, *flags[:3], flags[3].cpu(), 28, 23, 140)


@pytest.mark.cuda
@pytest.mark.parametrize("qp", [10, 28, 51])
def test_cuda_deblock_lines_matches_plain(qp):
    dev = cuda_device()
    alpha, beta = int(rd.ALPHA_TABLE[qp]), int(rd.BETA_TABLE[qp])
    tc0 = [int(v) for v in rd.TC0_TABLE[qp]]
    smooth = 120 + rng.integers(0, 6, size=(45, 16, 8))
    smooth[..., 4:] += rng.integers(0, 12, size=(45, 16, 1))
    for win in (rng.integers(0, 256, size=(45, 16, 8)), smooth):
        w = t32(win, dev)
        for bs in [np.full((45, 16), v) for v in range(5)] + [
                rng.integers(0, 5, size=(45, 16))]:
            b = t32(bs, dev)
            got = dl.filter_luma_lines(w, b, alpha, beta, tc0)
            assert_equal(got, dl.filter_luma_lines_plain(w, b, alpha, beta,
                                                         tc0))
            # the CPU plain version on the same inputs
            assert_equal(got, dl.filter_luma_lines(t32(win), t32(bs), alpha,
                                                   beta, tc0))


def _deblock_args(seed, wm, hm, qp, dev):
    arrs = random_deblock_picture(seed, wm, hm)
    return (*(torch.as_tensor(a, device=dev) for a in arrs), qp,
            chroma_qp(qp))


@pytest.mark.cuda
@pytest.mark.parametrize("slices,across", [(1, True), (3, True), (3, False)])
@pytest.mark.parametrize("qp", [10, 28, 51])
def test_cuda_deblock_wave_matches_plain(qp, slices, across):
    """The deblock wave kernel against the plain skewed deblocker on the
    card and on the CPU: mixed intra and inter MBs (bS 0 to 4), QCIF and
    5 x 3 MBs; one launch a wave, counted as K4."""
    dev = cuda_device()
    for wm, hm in ((11, 9), (5, 3)):
        sched = build_schedule(wm, hm, slices)
        args = _deblock_args(qp + wm, wm, hm, qp, dev)
        before = {**k4w.launches, **dl.launches}
        got = kd.make_deblocker_skewed(sched, across)(*args)
        torch.cuda.synchronize()
        assert k4w.launches["K4"] == before["K4"] + sched.n_waves
        assert dl.launches["K4_lines"] == before["K4_lines"]
        on_card = kd.make_deblocker_skewed(sched, across, plain=True)(*args)
        on_cpu = kd.make_deblocker_skewed(sched, across)(
            *(a.cpu() for a in args[:7]), *args[7:])
        assert k4w.launches["K4"] == before["K4"] + sched.n_waves
        for g, w, c, o in zip(got, on_card, on_cpu, args[:3]):
            assert g.dtype == torch.int32 and g.shape == o.shape
            assert_equal(g, w)
            assert_equal(g, c)
        assert_equal(args[0], random_deblock_picture(qp + wm, wm, hm)[0])


@pytest.mark.cuda
def test_cuda_deblock_wave_rejects_bad_input():
    dev = cuda_device()
    y = torch.zeros((48, 80), dtype=torch.int32, device=dev)
    c = torch.zeros((24, 40), dtype=torch.int32, device=dev)
    b = torch.zeros((12, 20), dtype=torch.int32, device=dev)
    q = torch.full((3, 5), 28, dtype=torch.int32, device=dev)
    k4w.deblock_wave(y, c, c.clone(), b, b.clone(), 0, q, q.clone())
    with pytest.raises(TypeError):
        k4w.deblock_wave(y.to(torch.uint8), c, c, b, b, 0, q, q)
    with pytest.raises(ValueError):             # a chroma plane's shape
        k4w.deblock_wave(y, c[:, :32], c, b, b, 0, q, q)
    with pytest.raises(ValueError):             # not contiguous
        k4w.deblock_wave(y, c, c, b.t().contiguous().t(), b, 0, q, q)
    with pytest.raises(ValueError):             # another device
        k4w.deblock_wave(y, c, c, b.cpu(), b, 0, q, q)
    with pytest.raises(ValueError):             # no such wave
        k4w.deblock_wave(y, c, c, b, b, 9, q, q)
    with pytest.raises(ValueError):             # not whole macroblocks
        k4w.deblock_wave(y[:40], c, c, b, b, 0, q, q)
    with pytest.raises(ValueError):             # a QP grid's shape
        k4w.deblock_wave(y, c, c, b, b, 0, q[:2], q)
    with pytest.raises(TypeError):              # a QP grid's type
        k4w.deblock_wave(y, c, c, b, b, 0, q, q.long())


@pytest.mark.cuda
@pytest.mark.parametrize("idc", [0, 2])
@pytest.mark.parametrize("two_list", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_cuda_deblock_wave_grids_match_plain(seed, two_list, idc):
    """K4 with per-MB QP grids over 0-51, offsets, MB-edge masks with
    slice edges in the middle of a row, t8 and one- or two-list motion,
    against the plain version on the card and on the CPU; one launch a
    wave."""
    dev = cuda_device()
    for wm, hm in ((11, 9), (5, 3)):
        d = random_decode_deblock(seed + wm, wm, hm, two_list=two_list,
                                  idc=idc)
        fn = kd.make_deblocker(wm, hm)

        def run(device, plain=False):
            t = {k: torch.as_tensor(v, device=device) for k, v in d.items()
                 if not k.startswith("off")}
            f = kd.make_deblocker(wm, hm, plain=True) if plain else fn
            return f(t["y"], t["u"], t["v"], t["intra_mb"], t["tc_luma"],
                     t["mv"], t["ref"], t["qp"], t["cqp"], t8_mb=t["t8"],
                     left_ok=t["left_ok"], top_ok=t["top_ok"],
                     off_a=d["off_a"], off_b=d["off_b"])

        before = k4w.launches["K4"]
        got = run(dev)
        torch.cuda.synchronize()
        assert k4w.launches["K4"] == before + wm + 2 * (hm - 1)
        for g, w, c in zip(got, run(dev, plain=True), run("cpu")):
            assert_equal(g, w)
            assert_equal(g, c)


@pytest.mark.cuda
def test_cuda_decoder_equals_cpu():
    """The decoder with its deblocking on the card equals the decoder on
    the CPU: an x264 stream with per-MB QPs (aq-mode under CRF), offsets
    (deblock=-2,1), B pictures and two slices a picture, and a CIF IPPP
    CABAC stream of the port's own, decoded to the encoder's recons."""
    dev = cuda_device()
    stream = (Path(__file__).parent / "data" / "x264_qcif_aq_deblock.264"
              ).read_bytes()
    cfg = EncoderConfig(width=352, height=288, qp=28, intra_period=0,
                        symbol_mode="CABAC", deblock=True)
    enc = Encoder(cfg, device=dev)
    own = enc.encode_sequence([synth_frame(352, 288, t) for t in range(3)])
    for s, recons in ((stream, None), (own, enc.recons)):
        before = k4w.launches["K4"]
        on_card = Decoder(device=dev).decode(s)
        assert k4w.launches["K4"] > before
        on_cpu = Decoder(device="cpu").decode(s)
        assert len(on_card) == len(on_cpu) > 0
        for g, w in zip(on_card, on_cpu):
            for gp, wp in zip(g, w):
                assert gp.dtype == wp.dtype
                assert_equal(gp, wp)
        for g, r in zip(on_card, recons or ()):
            for gp, rp in zip(g, r):
                assert_equal(gp, rp)


def _wave_on(dev, seed, wm, hm):
    bd, coords, avail, gy, gu, gv = random_wave(seed, wm, hm, n_pad=3)
    return ({k: t32(v, dev) for k, v in bd.items()}, t32(coords, dev),
            torch.as_tensor(avail, device=dev), t32(gy, dev), t32(gu, dev),
            t32(gv, dev))


@pytest.mark.cuda
@pytest.mark.parametrize("qp", [0, 17, 28, 51])
def test_cuda_wave_body_matches_plain(qp):
    """`wave_body` on the card (the I4x4 wave kernel reading the border
    buffers, then the I16x16 + chroma wave kernel) against
    `wave_body_plain` on the card and on the CPU: every result, the border
    buffers after the scatter, padding lanes included; one launch each."""
    dev = cuda_device()
    cqp = chroma_qp(qp)
    lam4, lam24, _ = tif.LAMBDA_TABLE[qp]
    before = {**k2w.launches, **k3w.launches, **dq.launches}
    bd_k, *args = _wave_on(dev, 60 + qp, 22, 18)
    got = tif.wave_body(qp, cqp, lam4, lam24, bd_k, *args)
    torch.cuda.synchronize()
    assert k2w.launches["K2"] == before["K2"] + 1
    assert k3w.launches["K3"] == before["K3"] + 1
    assert dq.launches["K3_blocks"] == before["K3_blocks"]
    bd_p, *args = _wave_on(dev, 60 + qp, 22, 18)
    on_card = tif.wave_body_plain(qp, cqp, lam4, lam24, bd_p, *args)
    bd_c, *args_c = _wave_on("cpu", 60 + qp, 22, 18)
    on_cpu = tif.wave_body(qp, cqp, lam4, lam24, bd_c, *args_c)
    assert list(got) == list(on_card) == list(k3w.OUTPUTS)
    for k, (shape, dtype) in k3w.OUTPUTS.items():
        assert got[k].dtype == dtype and got[k].shape[1:] == shape, k
        assert_equal(got[k], on_card[k], k)
        assert_equal(got[k], on_cpu[k], k)
    for k in bd_k:
        assert_equal(bd_k[k], bd_p[k], k)
        assert_equal(bd_k[k], bd_c[k], k)
    # written into rows of a frame's arrays when `out` is given
    ys = k3w.alloc_outputs((2, args[2].shape[0]), dev)
    bd_o, *args = _wave_on(dev, 60 + qp, 22, 18)
    ret = tif.wave_body(qp, cqp, lam4, lam24, bd_o, *args,
                        out={k: v[1] for k, v in ys.items()})
    for k in got:
        assert ret[k].data_ptr() == ys[k][1].data_ptr()
        assert_equal(ys[k][1], got[k], k)


def _chunk_on(dev, seed, wm, hm, frames):
    bd, coords, avail, gy, gu, gv = random_wave_chunk(seed, wm, hm, frames,
                                                      n_pad=3)
    return ({k: t32(v, dev) for k, v in bd.items()}, t32(coords, dev),
            torch.as_tensor(avail, device=dev), t32(gy, dev), t32(gu, dev),
            t32(gv, dev))


@pytest.mark.cuda
def test_cuda_batched_wave_body_matches_plain():
    """A wave of a chunk of F = 1, 3, 4 pictures (the batched all-intra
    entry) on the card at QP 0, 28, 51, one K2 and one K3 launch for all
    F, against `wave_body_plain` on the card and on the CPU: every result
    and the border buffers after the scatter, padding lanes included; and
    into columns of a chunk's per-wave arrays, as the wave loop writes
    them.  The wrappers refuse a chunk's inputs of mismatched shapes.
    (Each collected test moves the Tier-1 scheduler's chunk boundaries,
    ROADMAP "Tier-1 and its clock": the cases loop here.)"""
    dev = cuda_device()
    for frames in (1, 3, 4):
        for qp in (0, 28, 51):
            _check_batched_wave_body(dev, qp, frames)
    _check_batched_wave_kernels_reject_bad_input(dev)


def _check_batched_wave_body(dev, qp, frames):
    cqp = chroma_qp(qp)
    lam4, lam24, _ = tif.LAMBDA_TABLE[qp]
    seed = 90 + qp + frames
    before = {**k2w.launches, **k3w.launches}
    bd_k, *args = _chunk_on(dev, seed, 22, 18, frames)
    got = tif.wave_body(qp, cqp, lam4, lam24, bd_k, *args)
    torch.cuda.synchronize()
    assert k2w.launches["K2"] == before["K2"] + 1
    assert k3w.launches["K3"] == before["K3"] + 1
    bd_p, *args_p = _chunk_on(dev, seed, 22, 18, frames)
    on_card = tif.wave_body_plain(qp, cqp, lam4, lam24, bd_p, *args_p)
    bd_c, *args_c = _chunk_on("cpu", seed, 22, 18, frames)
    on_cpu = tif.wave_body(qp, cqp, lam4, lam24, bd_c, *args_c)
    for k, (shape, dtype) in k3w.OUTPUTS.items():
        assert got[k].dtype == dtype and got[k].shape[2:] == shape, k
        assert got[k].shape[0] == frames
        assert_equal(got[k], on_card[k], k)
        assert_equal(got[k], on_cpu[k], k)
    for k in bd_k:
        assert_equal(bd_k[k], bd_p[k], k)
        assert_equal(bd_k[k], bd_c[k], k)
    # the wave loop's layout: [F, n_waves, lanes, ...], the wave a column
    b = args[2].shape[1]
    ys = k3w.alloc_outputs((frames, 3, b), dev)
    bd_o, *args = _chunk_on(dev, seed, 22, 18, frames)
    tif.wave_body(qp, cqp, lam4, lam24, bd_o, *args,
                  out={k: v[:, 1] for k, v in ys.items()})
    for k in got:
        assert_equal(ys[k][:, 1], got[k], k)


def _check_batched_wave_kernels_reject_bad_input(dev):
    bd, coords, avail, gy, gu, gv = _chunk_on(dev, 4, 11, 9, 3)
    lam = (28, 23, 140, tif._K2_RULES)
    k2w.i4x4_wave_bd(gy, bd, coords, avail, *lam)
    with pytest.raises(ValueError):          # border buffers of 2 pictures
        k2w.i4x4_wave_bd(gy, {k: v[:2] for k, v in bd.items()}, coords,
                         avail, *lam)
    with pytest.raises(ValueError):          # one picture's buffers
        k2w.i4x4_wave_bd(gy, {k: v[0] for k, v in bd.items()}, coords,
                         avail, *lam)
    with pytest.raises(ValueError):          # a picture not contiguous
        k2w.i4x4_wave_bd(gy.transpose(2, 3), bd, coords, avail, *lam)
    mb4, modebuf, _, coeffs4, j4 = k2w.i4x4_wave_bd(gy, bd, coords, avail,
                                                    *lam)
    assert mb4.shape == (3, gy.shape[1], 16, 16) and j4.shape == gy.shape[:2]
    out = k3w.alloc_outputs(tuple(gy.shape[:2]), dev)
    k3w.i16_chroma_wave(bd, coords, avail, gy, gu, gv, mb4, modebuf, coeffs4,
                        j4, 28, 28, tuple(tif.BLK_ORDER), out)
    with pytest.raises(ValueError):          # results of 2 pictures
        k3w.i16_chroma_wave(bd, coords, avail, gy, gu, gv, mb4[:2], modebuf,
                            coeffs4, j4, 28, 28, tuple(tif.BLK_ORDER), out)
    with pytest.raises(ValueError):          # outputs of one picture
        k3w.i16_chroma_wave(bd, coords, avail, gy, gu, gv, mb4, modebuf,
                            coeffs4, j4, 28, 28, tuple(tif.BLK_ORDER),
                            {k: v[0] for k, v in out.items()})
    y = torch.zeros((2, 48, 80), dtype=torch.int32, device=dev)
    c = torch.zeros((2, 24, 40), dtype=torch.int32, device=dev)
    b = torch.zeros((2, 12, 20), dtype=torch.int32, device=dev)
    q = torch.full((2, 3, 5), 28, dtype=torch.int32, device=dev)
    k4w.deblock_wave(y, c, c.clone(), b, b.clone(), 0, q, q.clone())
    with pytest.raises(ValueError):          # one picture's bS map
        k4w.deblock_wave(y, c, c, b[0], b, 0, q, q)
    with pytest.raises(ValueError):          # a QP grid of 1 picture
        k4w.deblock_wave(y, c, c, b, b, 0, q[:1], q)


@pytest.mark.cuda
def test_cuda_batched_deblocker_matches_plain():
    """The picture deblocker on a chunk of 3 seeded pictures (intra and
    inter MBs, bS 0 to 4) on the card, one K4 launch a wave for all of
    them, 1 slice and 3 slices unfiltered across, against the plain
    version on the card and on the CPU, and against each picture filtered
    on its own on the card."""
    dev = cuda_device()
    for slices, across in ((1, True), (3, False)):
        _check_batched_deblocker(dev, slices, across)


def _check_batched_deblocker(dev, slices, across):
    wm, hm = 11, 9
    sched = build_schedule(wm, hm, slices)
    pics = [random_deblock_picture(50 + f, wm, hm) for f in range(3)]
    args = [torch.as_tensor(np.stack(a), device=dev) for a in zip(*pics)]
    fn = kd.make_deblocker_skewed(sched, across)
    before = k4w.launches["K4"]
    got = fn(*args, 28, chroma_qp(28))
    torch.cuda.synchronize()
    assert k4w.launches["K4"] == before + sched.n_waves
    on_card = kd.make_deblocker_skewed(sched, across, plain=True)(
        *args, 28, chroma_qp(28))
    on_cpu = fn(*(a.cpu() for a in args), 28, chroma_qp(28))
    for g, w, c in zip(got, on_card, on_cpu):
        assert_equal(g, w)
        assert_equal(g, c)
    for f in range(3):
        one = fn(*(a[f] for a in args), 28, chroma_qp(28))
        for g, o in zip(got, one):
            assert_equal(g[f], o)


@pytest.mark.cuda
def test_cuda_batched_entry_equals_cpu():
    """Config 1 (five QCIF all-intra CAVLC frames, 1 and 3 slices) through
    the batched entry on the card equals the same on the CPU: stream,
    frame sizes and recons; a chunk of 4 (and the short one of 1)
    launches K2, K3 and K4 once a wave, as one frame does, and KV (its
    state pass deriving the mvds and modes, KD's function) once.
    So does a 32x1088 picture with a slice a MB row (68 slices), whose
    chunk of 4 has 272 slices, more than a picture may have on the card."""
    dev = cuda_device()
    for slices in (1, 3):
        _check_batched_entry(dev, slices)
    _check_batched_entry(dev, 68, 32, 1088)


def _check_batched_entry(dev, slices, w=176, h=144):
    cfg = EncoderConfig(width=w, height=h, qp=28, symbol_mode="CAVLC",
                        intra_period=1, deblock=True,
                        slices_per_frame=slices)
    frames = [synth_frame(w, h, t) for t in range(5)]
    before = {**k2w.launches, **k3w.launches, **k4w.launches,
              **kcv.launches}
    enc = Encoder(cfg, device=dev)
    got = enc.encode_sequence(frames)
    n_waves = enc.sched.n_waves
    ran = {k: v - before[k] for k, v in {
        **k2w.launches, **k3w.launches, **k4w.launches,
        **kcv.launches}.items()}
    for k in ("K2", "K3", "K4"):
        assert ran[k] == 2 * n_waves, k
    assert ran["KD"] == ran["KV"] == 2
    cpu = Encoder(cfg, device="cpu")
    assert got == cpu.encode_sequence(frames)
    assert [s.bits for s in enc.stats] == [s.bits for s in cpu.stats]
    for g, w in zip(enc.recons, cpu.recons):
        for gp, wp in zip(g, w):
            assert gp.device.type == "cuda"
            assert_equal(gp, wp)


@pytest.mark.cuda
def test_cuda_wave_kernels_reject_bad_input():
    dev = cuda_device()
    bd, coords, avail, gy, gu, gv = _wave_on(dev, 4, 11, 9)
    b = gy.shape[0]
    k2_out = k2w.i4x4_wave_bd(gy, bd, coords, avail, 28, 23, 140,
                              tif._K2_RULES)
    mb4, modebuf, _, coeffs4, j4 = k2_out
    order = tuple(tif.BLK_ORDER)

    def k3(bd=bd, coords=coords, avail=avail, gy=gy, gu=gu, mb4=mb4, j4=j4,
           out=None):
        out = k3w.alloc_outputs((b,), dev) if out is None else out
        k3w.i16_chroma_wave(bd, coords, avail, gy, gu, gv, mb4, modebuf,
                            coeffs4, j4, 28, 28, order, out)

    k3()
    with pytest.raises(TypeError):
        k3(coords=coords.long())
    with pytest.raises(TypeError):
        k3(avail=avail.to(torch.uint8))
    with pytest.raises(TypeError):
        k3(gy=gy.to(torch.int64))
    with pytest.raises(ValueError):
        k3(gu=gu[:, :, :4])
    with pytest.raises(ValueError):
        k3(mb4=mb4.transpose(1, 2))
    with pytest.raises(ValueError):
        k3(j4=j4.cpu())
    with pytest.raises(ValueError):
        k3(bd={**bd, "row_y": bd["row_y"][:, :-1]})
    with pytest.raises(ValueError):
        k3(out=k3w.alloc_outputs((b + 1,), dev))
    with pytest.raises(TypeError):
        k2w.i4x4_wave_bd(gy, bd, coords.long(), avail, 28, 23, 140,
                         tif._K2_RULES)
    with pytest.raises(ValueError):
        k2w.i4x4_wave_bd(gy.transpose(1, 2), bd, coords, avail, 28, 23, 140,
                         tif._K2_RULES)
    with pytest.raises(ValueError):
        k2w.i4x4_wave_bd(gy, {**bd, "modes_col": bd["modes_col"].cpu()},
                         coords, avail, 28, 23, 140, tif._K2_RULES)
    with pytest.raises(ValueError):
        k2w.i4x4_wave_bd(gy, bd, coords, avail, 28, 23, 140, tif._K2_RULES,
                         modes_zz=torch.empty((b, 8), dtype=torch.int32,
                                              device=dev))


def _p_wave_on(dev, seed, wm, hm):
    """A seeded P wave on `dev`: (planes, cu_pad, cv_pad, bd, mv_map,
    ref_map, coords, avail, mv_me, gy, gu, gv)."""
    (bd, mv_map, ref_map, ry, ru, rv, coords, avail, mv_me, gy, gu,
     gv) = random_p_wave(seed, wm, hm, n_pad=3)
    pad = tinter.PAD
    planes = kint.luma_planes(kint.pad_plane(t32(ry, dev), pad))
    cu, cv = (kint.pad_plane(t32(p, dev), pad // 2) for p in (ru, rv))
    return (planes, cu, cv, {k: t32(v, dev) for k, v in bd.items()},
            t32(mv_map, dev), t32(ref_map, dev), t32(coords, dev),
            torch.as_tensor(avail, device=dev), t32(mv_me, dev),
            t32(gy, dev), t32(gu, dev), t32(gv, dev))


@pytest.mark.cuda
@pytest.mark.parametrize("qp,offset", [(0, 0), (28, 0), (28, -2), (51, -2)])
def test_cuda_p_wave_body_matches_plain(qp, offset):
    """The P wave body on the card (KP's frame form on a picture of one
    wave, the Intra4x4 search inside) against `wave_body_plain` on the
    card and on the CPU: every result, the border buffers and both maps
    after the wave, padding lanes included; one launch of KP, none of K2,
    K3 or the slab entries."""
    dev = cuda_device()
    cqp = chroma_qp(qp, offset)
    lam = tif.LAMBDA_TABLE[qp]
    consts = (qp, cqp, *lam)
    counts = (k2w.launches, k3w.launches, kp.launches, dq.launches)
    before = [dict(c) for c in counts]
    planes, cu, cv, bd_k, mv_k, ref_k, *xs = _p_wave_on(dev, 70 + qp, 40, 20)
    got = tinter.wave_body(planes, cu, cv, *consts, bd_k, mv_k, ref_k, *xs)
    torch.cuda.synchronize()
    ran = {k: c[k] - b[k] for c, b in zip(counts, before) for k in c}
    assert ran == {"K2": 0, "K3": 0, "KP": 1, "K2_blocks": 0, "K3_blocks": 0}
    _, _, _, bd_p, mv_p, ref_p, *xs = _p_wave_on(dev, 70 + qp, 40, 20)
    on_card = tinter.wave_body_plain(planes, cu, cv, *consts, bd_p, mv_p,
                                     ref_p, *xs)
    planes_c, cu_c, cv_c, bd_c, mv_c, ref_c, *xs_c = _p_wave_on(
        "cpu", 70 + qp, 40, 20)
    on_cpu = tinter.wave_body(planes_c, cu_c, cv_c, *consts, bd_c, mv_c,
                              ref_c, *xs_c)
    assert list(got) == list(on_card) == list(kp.OUTPUTS)
    for k, (shape, dtype) in kp.OUTPUTS.items():
        assert got[k].dtype == dtype and got[k].shape[1:] == shape, k
        assert_equal(got[k], on_card[k], k)
        assert_equal(got[k], on_cpu[k], k)
    for k in bd_k:
        assert_equal(bd_k[k], bd_p[k], k)
        assert_equal(bd_k[k], bd_c[k], k)
    for g, w, c in ((mv_k, mv_p, mv_c), (ref_k, ref_p, ref_c)):
        assert_equal(g, w)
        assert_equal(g, c)
    inter = to_np(got["is_inter"]).astype(bool)
    assert inter.any() and (~inter).any()


@pytest.mark.cuda
def test_cuda_p_frame_matches_cpu():
    """One CIF P frame (3 slices) through `make_inter_encoder` on the card
    and on the CPU: every per-wave output and the recon planes equal; the
    card ran KP once (the whole picture), and K2, K3 and the slab entries
    never."""
    dev = cuda_device()
    w, h = 352, 288
    sched = build_schedule(w // 16, h // 16, 3)
    cur = [p.copy() for p in synth_frame(w, h, 3)]
    cur[0][96:160, 128:224] = np.random.default_rng(1).integers(
        0, 256, (64, 96), dtype=np.uint8)
    planes = [torch.as_tensor(p) for p in cur + list(synth_frame(w, h, 2))]
    encode = tinter.make_inter_encoder(sched)
    counts = (k2w.launches, k3w.launches, kp.launches, dq.launches)
    before = [dict(c) for c in counts]
    out_d, ys_d = encode(*(p.to(dev) for p in planes), 28)
    torch.cuda.synchronize()
    ran = {k: c[k] - b[k] for c, b in zip(counts, before) for k in c}
    assert ran == {"K2": 0, "K3": 0, "KP": 1, "K2_blocks": 0, "K3_blocks": 0}
    out_c, ys_c = encode(*planes, 28)
    assert set(ys_d) == set(ys_c) == set(kp.OUTPUTS) - {"recon_mb", "rec_u",
                                                         "rec_v"}
    for k, c in {**ys_c, **out_c}.items():
        d = {**ys_d, **out_d}[k]
        assert d.dtype == c.dtype and d.shape == c.shape, k
        assert_equal(d, c, k)


@pytest.mark.cuda
@pytest.mark.parametrize("qp,tools", [
    (0, kp.Tools(True, True, True)), (28, kp.Tools(True, True, True)),
    (51, kp.Tools(True, True, True)), (28, kp.Tools(True, False, False)),
    (28, kp.Tools(False, False, True))])
def test_cuda_p_wave_tools_match_plain(qp, tools):
    """The P wave body with the default P tools on the card against
    `wave_body_plain` on the CPU: every result, the borders and the three
    map channels; every partition type and both transforms chosen."""
    dev = cuda_device()
    consts = (qp, chroma_qp(qp), *tif.LAMBDA_TABLE[qp])
    *arrs, mvp = random_p_wave_tools(90 + qp, 40, 20)
    (bd, mv_map, ref_map, ry, ru, rv, coords, avail, mv_me, gy, gu,
     gv) = arrs

    def on(d):
        planes = kint.luma_planes(kint.pad_plane(t32(ry, d), tinter.PAD))
        cu, cv = (kint.pad_plane(t32(p, d), tinter.PAD // 2)
                  for p in (ru, rv))
        return ((planes, cu, cv, *consts),
                ({k: t32(v, d) for k, v in bd.items()}, t32(mv_map, d),
                 t32(ref_map, d)),
                (t32(coords, d), torch.as_tensor(avail, device=d),
                 t32(mv_me, d), t32(gy, d), t32(gu, d), t32(gv, d),
                 t32(mvp, d) if tools.partitions else None, tools))

    head, st_k, xs = on(dev)
    got = tinter.wave_body(*head, *st_k, *xs)
    torch.cuda.synchronize()
    head, st_c, xs = on("cpu")
    want = tinter.wave_body(*head, *st_c, *xs)
    assert list(got) == list(want) == list(kp.outputs(tools))
    for k in want:
        assert_equal(got[k], want[k], k)
    for k in st_c[0]:
        assert_equal(st_k[0][k], st_c[0][k], k)
    assert_equal(st_k[1], st_c[1])
    assert_equal(st_k[2], st_c[2])
    if qp < 51 and tools.p8x8:
        inter = to_np(want["is_inter"]).astype(bool)
        assert set(to_np(want["ptype"])[inter]) == {0, 1, 2, 3}
    if qp < 51 and tools.t8:
        assert to_np(want["t8"]).any()


@pytest.mark.cuda
def test_cuda_default_tools_stream_matches_cpu():
    """112x80 IPPP CAVLC with the default P tools, 5 frames: the stream
    and recon on the card equal the CPU run's; KP once a P frame, K2 once
    a wave of the I frame only."""
    dev = cuda_device()
    frames = [synth_frame(112, 80, t) for t in range(5)]
    cfg = EncoderConfig(width=112, height=80, qp=30, intra_period=0)
    before = (dict(k2w.launches), dict(kp.launches))
    gpu = Encoder(cfg, device=dev)
    got = gpu.encode_sequence(frames)
    assert kp.launches["KP"] - before[1]["KP"] == 4
    assert k2w.launches["K2"] - before[0]["K2"] == gpu.sched.n_waves
    cpu = Encoder(cfg, device="cpu")
    assert got == cpu.encode_sequence(frames)
    for g_rec, c_rec in zip(gpu.recons, cpu.recons):
        for g, c in zip(g_rec, c_rec):
            assert_equal(to_np(g), to_np(c))


@pytest.mark.cuda
@pytest.mark.parametrize("wy,oy", [(64, 0), (58, -7), (71, 12)])
@pytest.mark.parametrize("tools", [kp.NO_TOOLS, kp.Tools(True, True, True)])
def test_cuda_weighted_p_wave_matches_plain(wy, oy, tools):
    """KP with explicit weights (the source faded by them) on the card
    against `wave_body_plain` on the CPU: every result, the borders and
    the maps; one launch of KP, none of K2."""
    dev = cuda_device()
    qp = 28
    consts = (qp, chroma_qp(qp), *tif.LAMBDA_TABLE[qp])
    *arrs, mvp = random_p_wave_tools(110 + wy + oy, 40, 20)
    (bd, mv_map, ref_map, ry, ru, rv, coords, avail, mv_me, gy, gu,
     gv) = arrs
    gy = np.clip(((gy * wy + 32) >> 6) + oy, 0, 255)

    def on(d):
        planes = kint.luma_planes(kint.pad_plane(t32(ry, d), tinter.PAD))
        cu, cv = (kint.pad_plane(t32(p, d), tinter.PAD // 2)
                  for p in (ru, rv))
        return ((planes, cu, cv, *consts),
                ({k: t32(v, d) for k, v in bd.items()}, t32(mv_map, d),
                 t32(ref_map, d)),
                (t32(coords, d), torch.as_tensor(avail, device=d),
                 t32(mv_me, d), t32(gy, d), t32(gu, d), t32(gv, d),
                 t32(mvp, d) if tools.partitions else None, tools))

    before = (kp.launches["KP"], k2w.launches["K2"])
    head, st_k, xs = on(dev)
    got = tinter.wave_body(*head, *st_k, *xs, wy=wy, oy=oy)
    torch.cuda.synchronize()
    assert (kp.launches["KP"], k2w.launches["K2"]) == (before[0] + 1,
                                                       before[1])
    head, st_c, xs = on("cpu")
    want = tinter.wave_body(*head, *st_c, *xs, wy=wy, oy=oy)
    for k in want:
        assert_equal(got[k], want[k], k)
    for k in st_c[0]:
        assert_equal(st_k[0][k], st_c[0][k], k)
    assert_equal(st_k[1], st_c[1])
    assert_equal(st_k[2], st_c[2])
    inter = to_np(want["is_inter"]).astype(bool)
    assert inter.any() and (~inter).any()


@pytest.mark.cuda
def test_cuda_weighted_stream_matches_cpu():
    """112x80 IPPP CABAC with weighted prediction and SEI over a fade, 5
    frames: the stream, the recon and every P frame's weights on the card
    equal the CPU run's, and the weights engage."""
    from tpu264_torch.tools.synth_inputs import fade_frames
    dev = cuda_device()
    frames = fade_frames(112, 80, 5)
    cfg = EncoderConfig(width=112, height=80, qp=30, intra_period=0,
                        symbol_mode="CABAC", weighted_pred=True,
                        sei_messages=True)
    gpu = Encoder(cfg, device=dev)
    got = gpu.encode_sequence(frames)
    cpu = Encoder(cfg, device="cpu")
    assert got == cpu.encode_sequence(frames)
    assert [s.wp for s in gpu.stats] == [s.wp for s in cpu.stats]
    assert any(s.wp not in (None, (64, 0)) for s in gpu.stats)
    for g_rec, c_rec in zip(gpu.recons, cpu.recons):
        for g, c in zip(g_rec, c_rec):
            assert_equal(to_np(g), to_np(c))


@pytest.mark.cuda
def test_cuda_p_wave_rejects_bad_input():
    dev = cuda_device()
    planes, cu, cv, bd, mv_map, ref_map, *xs = _p_wave_on(dev, 4, 11, 9)
    coords, avail, mv_me, gy, gu, gv = (t.unsqueeze(0) for t in xs)
    b = gy.shape[1]

    def run(mv_map=mv_map, planes=planes, cu=cu, mv_me=mv_me, gv=gv,
            out=None, waves=None):
        out = kp.alloc_outputs((1, b), dev) if out is None else out
        kp.p_frame(bd, mv_map, ref_map, planes, cu, cv, coords, avail, mv_me,
                   gy, gu, gv, 28, 28, 23, 140, 6, tuple(tif.BLK_ORDER),
                   tif._K2_RULES, out, waves=waves)
        torch.cuda.synchronize()

    run()
    with pytest.raises(TypeError):
        run(mv_me=mv_me.long())
    with pytest.raises(ValueError):
        run(mv_map=mv_map[:, :-1])
    with pytest.raises(ValueError):
        run(planes=planes[:3])
    with pytest.raises(ValueError):
        run(cu=cu[:, :-1])
    with pytest.raises(ValueError):
        run(gv=gv.cpu())
    with pytest.raises(ValueError):
        run(out=kp.alloc_outputs((1, b + 1), dev))
    with pytest.raises(ValueError):
        run(waves=(0, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("split", [None, (1, 5, 17)])
def test_cuda_p_frame_wave_ranges_match_plain(split):
    """KP's frame form on a CIF P picture with the default tools and
    weights (58, -7), whole or run as wave ranges (one launch a range),
    against `p_frame_plain` on the CPU: every result, the border buffers
    and the maps; a launch a range, none of K2."""
    dev = cuda_device()
    w, h = 352, 288
    sched = build_schedule(w // 16, h // 16, 1)
    captured = {}
    inner = tinter.frame_body

    def spy(*a, **kw):
        # the state as the picture starts
        captured["args"] = (tuple(
            {k: v.clone() for k, v in x.items()} if isinstance(x, dict)
            else x.clone() if isinstance(x, torch.Tensor) else x
            for x in a), kw)
        return inner(*a, **kw)

    tinter.frame_body = spy
    try:
        tinter.make_inter_encoder(sched, partitions=True, p8x8=True, t8=True,
                                  weighted=True)(
            *(torch.as_tensor(p) for p in synth_frame(w, h, 3)
              + synth_frame(w, h, 2)), 28, 58, -7)
    finally:
        tinter.frame_body = inner
    a, kw = captured["args"]
    to = lambda t, d: ({k: v.to(d) for k, v in t.items()} if isinstance(t, dict)
                       else t.to(d) if isinstance(t, torch.Tensor) else t)
    edges = [0, *(split or ()), sched.n_waves]
    before = (kp.launches["KP"], k2w.launches["K2"])
    got = kp.alloc_outputs((sched.n_waves, sched.max_wave), dev,
                           kp.Tools(True, True, True))
    on_card = [to(t, dev) for t in a]
    for w0, w1 in zip(edges, edges[1:]):
        inner(*on_card, **kw, out=got, waves=(w0, w1))
    torch.cuda.synchronize()
    assert (kp.launches["KP"] - before[0], k2w.launches["K2"] - before[1]) \
        == (len(edges) - 1, 0)
    want = inner(*a, **kw)
    for k in want:
        assert_equal(got[k], want[k], k)
    for k in a[8]:
        assert_equal(on_card[8][k], a[8][k], k)
    assert_equal(on_card[9], a[9])
    assert_equal(on_card[10], a[10])


@pytest.mark.cuda
def test_cuda_engine_matches_plain():
    dev = cuda_device()
    slices = [random_records(20 + s, 2000) for s in range(3)]
    w_gpu, nb_gpu, p_gpu = run_engine(slices, 0, 28, device=dev)
    w_cpu, nb_cpu, p_cpu = run_engine(slices, 0, 28)
    assert_equal(nb_gpu, nb_cpu)
    assert_equal(w_gpu, w_cpu)
    assert p_gpu == p_cpu


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 127, 128, 129, 9000])
def test_cuda_engine_chunk_edges(n):
    """Record counts around the kernel's chunk of 128 records."""
    dev = cuda_device()
    slices = [random_records(30 + n, n - 1)]      # + the terminating record
    w_gpu, nb_gpu, p_gpu = run_engine(slices, 1, 35, device=dev)
    w_cpu, nb_cpu, p_cpu = run_engine(slices, 1, 35)
    assert_equal(nb_gpu, nb_cpu)
    assert_equal(w_gpu, w_cpu)
    assert p_gpu == p_cpu


@pytest.mark.cuda
def test_cuda_engine_carry_and_outstanding_runs():
    """Long runs of pending 0xFF bytes resolved with and without a carry,
    three slices in one launch: the byte-wise kernel equals the bit-wise
    plain version."""
    dev = cuda_device()
    slices = [carry_records(s, tail=200 + 900 * s) for s in range(3)]
    w_gpu, nb_gpu, p_gpu = run_engine(slices, 0, 28, device=dev)
    w_cpu, nb_cpu, p_cpu = run_engine(slices, 0, 28)
    assert_equal(nb_gpu, nb_cpu)
    assert_equal(w_gpu, w_cpu)
    assert p_gpu == p_cpu
    assert b"\x00" * 80 in p_gpu[0] and b"\xff" * 15 in p_gpu[0]


@pytest.mark.cuda
def test_cuda_engine_long_runs():
    """Runs of up to 8191 bins (the kernel codes a run of more than four
    bins as one operation) beside short ones, two slices."""
    dev = cuda_device()
    slices = [long_run_records(s, n=24, tail=400) for s in range(2)]
    w_gpu, nb_gpu, p_gpu = run_engine(slices, 2, 40, device=dev)
    w_cpu, nb_cpu, p_cpu = run_engine(slices, 2, 40)
    assert_equal(nb_gpu, nb_cpu)
    assert_equal(w_gpu, w_cpu)
    assert p_gpu == p_cpu


@pytest.mark.cuda
def test_cuda_engine_reports_overflow():
    dev = cuda_device()
    with pytest.raises(RuntimeError, match="overflowed"):
        run_engine([random_records(4, 2000)], 0, 28, out_cap=8, device=dev)


@pytest.mark.cuda
def test_cuda_engine_refuses_records_after_final_terminate():
    """The kernel pads to a byte at a terminate bin 1; records after one
    (the second slice here) are reported, not coded differently from the
    plain version."""
    dev = cuda_device()
    good = random_records(8, 300)
    stray = tuple(np.concatenate(p) for p in zip(random_records(8, 40),
                                                 random_records(9, 30)))
    _, nbytes, _ = run_engine([good], 0, 28, device=dev)
    assert int(nbytes[0]) > 0
    with pytest.raises(ValueError, match="final terminate"):
        run_engine([good, stray], 0, 28, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("slices", [1, 3])
@pytest.mark.parametrize("tools", [(), ("ptype", "mvq", "t8")])
def test_cuda_engine_p_records_match_plain(tools, slices):
    """P-slice records of a seeded CIF MB dict (skips, intra MBs, every
    partition type and the 8x8 transform with the tools; the mvd's UEG3
    bypass suffixes, the cat-5 contexts 402-435): the binarizer on the
    card gives the CPU's records, and K1 with init table 1, in one launch
    for all slices, the plain version's payloads."""
    dev = cuda_device()
    wm, hm = 22, 18
    mb = random_mbs(60 + slices + len(tools), wm, hm, tools=tools)
    rows = build_schedule(wm, hm, slices).slice_starts.tolist()
    cap = wm * hm // slices * 768
    out = []
    for d in (dev, torch.device("cpu")):
        k, a, b, v = tcb.binarize_frame(
            {key: torch.as_tensor(val, device=d) for key, val in mb.items()},
            wm, hm, rows, p_slice=True)
        out.append(tcb.compact_slices(k, a, b, v, wm, rows, hm, cap))
    (recs, counts), (c_recs, c_counts) = out
    assert_equal(counts, c_counts)
    assert_equal(recs, c_recs)
    assert int(c_counts.max()) <= cap
    init = t32(k1.init_packed_states(1, 28), dev)
    before = k1.launches["K1"]
    words, nbytes = k1.encode_slices(recs, counts, init, cap // 4)
    assert k1.launches["K1"] == before + 1
    p_words, p_nbytes = k1.encode_slices(c_recs, c_counts, init.cpu(),
                                         cap // 4)
    assert_equal(nbytes, p_nbytes)
    assert_equal(words, p_words)
    assert k1.payloads_from_words(words, nbytes) == \
        k1.payloads_from_words(p_words, p_nbytes)


@pytest.mark.cuda
def test_cuda_ippp_cabac_rc_stream_matches_cpu():
    """112x80 IPPP with CABAC, the default P tools and rate control, 5
    frames: stream, recon and every frame's QP on the card equal the CPU
    run's; K1 once a frame, KP once a P frame, K2 once a wave of the I
    frame only."""
    dev = cuda_device()
    frames = [synth_frame(112, 80, t) for t in range(5)]
    cfg = EncoderConfig(width=112, height=80, qp=30, intra_period=0,
                        symbol_mode="CABAC", rate_control=True,
                        bitrate=100_000)
    before = (dict(k1.launches), dict(k2w.launches), dict(kp.launches))
    gpu = Encoder(cfg, device=dev)
    got = gpu.encode_sequence(frames)
    assert k1.launches["K1"] - before[0]["K1"] == 5
    assert k2w.launches["K2"] - before[1]["K2"] == gpu.sched.n_waves
    assert kp.launches["KP"] - before[2]["KP"] == 4
    cpu = Encoder(cfg, device="cpu")
    assert got == cpu.encode_sequence(frames)
    assert [s.qp for s in gpu.stats] == [s.qp for s in cpu.stats]
    assert len({s.qp for s in gpu.stats}) >= 2
    for g_rec, c_rec in zip(gpu.recons, cpu.recons):
        for g, c in zip(g_rec, c_rec):
            assert_equal(to_np(g), to_np(c))


@pytest.mark.cuda
@pytest.mark.parametrize("deblock,slices",
                         [(True, 1), (True, 3), (False, 1), (False, 3)])
def test_cuda_encoder_matches_cpu(deblock, slices):
    """QCIF, 2 frames, all-intra CABAC: the stream and recon on the card
    equal the CPU run's, and every kernel of the path was launched."""
    dev = cuda_device()
    frames = [synth_frame(176, 144, t) for t in range(2)]
    cfg = EncoderConfig(width=176, height=144, qp=28, symbol_mode="CABAC",
                        deblock=deblock, slices_per_frame=slices)
    counts = (k1.launches, dq.launches, k2w.launches, k3w.launches,
              k4w.launches, dl.launches)
    before = [dict(c) for c in counts]
    gpu = Encoder(cfg, device=dev)
    got = gpu.encode_sequence(frames)
    launched = {k: c[k] - b[k] for c, b in zip(counts, before) for k in c}
    cpu = Encoder(cfg, device="cpu")
    assert got == cpu.encode_sequence(frames)
    for g_rec, c_rec in zip(gpu.recons, cpu.recons):
        for g, c in zip(g_rec, c_rec):
            assert_equal(to_np(g), to_np(c))
    n_waves = gpu.sched.n_waves
    assert launched["K1"] == 2
    assert launched["K2"] == launched["K3"] == 2 * n_waves
    assert launched["K4"] == (2 * n_waves if deblock else 0)
    assert launched["K2_blocks"] == launched["K3_blocks"] == 0
    assert launched["K4_lines"] == 0


def _b_wave_on(dev, seed, wm, hm, qp, allow):
    """A seeded B wave as `b_frame.wave_body`'s arguments on `dev`, with
    the partitions."""
    (bd, maps, ref0, ref1, coords, avail, me0, me1, mp0, mp1, cz, cm, gy, gu,
     gv) = random_b_wave(seed, wm, hm, n_pad=3)
    pad = tb.PAD
    planes = tuple(kint.luma_planes(kint.pad_plane(t32(r[0], dev), pad))
                   for r in (ref0, ref1))
    cpads = tuple(kint.pad_plane(t32(p, dev), pad // 2) for r in (ref0, ref1)
                  for p in r[1:])
    b = lambda a: torch.as_tensor(a, device=dev)
    return (tuple(t32(m, dev) for m in maps), planes, cpads, qp,
            chroma_qp(qp), *tif.LAMBDA_TABLE[qp],
            {k: t32(v, dev) for k, v in bd.items()}, t32(coords, dev),
            b(avail), (t32(me0, dev), t32(me1, dev)),
            (t32(mp0, dev), t32(mp1, dev)), b(cz), b(cm), t32(gy, dev),
            t32(gu, dev), t32(gv, dev), True, allow)


@pytest.mark.cuda
@pytest.mark.parametrize("allow", [True, False])
@pytest.mark.parametrize("qp", [0, 28, 51])
def test_cuda_b_wave_body_matches_plain(qp, allow):
    """The B wave body on the card (KB's frame form on a picture of one
    wave, the Intra4x4 search inside) against `wave_body_plain` on the
    CPU, at the 1080p width (60 lanes and 3 padding lanes): every result,
    the border buffers and both lists' maps after the wave; one launch of
    KB, none of K2 or KP."""
    dev = cuda_device()
    counts = (k2w.launches, kp.launches, kb.launches)
    before = [dict(c) for c in counts]
    args = _b_wave_on(dev, 120 + qp, 120, 68, qp, allow)
    got = tb.wave_body(*args)
    torch.cuda.synchronize()
    ran = {k: c[k] - b[k] for c, b in zip(counts, before) for k in c}
    assert ran == {"K2": 0, "KP": 0, "KB": 1}
    args_c = _b_wave_on("cpu", 120 + qp, 120, 68, qp, allow)
    want = tb.wave_body(*args_c)
    assert list(got) == list(want) == list(kb.outputs(True))
    for k, (shape, dtype) in kb.outputs(True).items():
        assert got[k].dtype == dtype and got[k].shape[1:] == shape, k
        assert_equal(got[k], want[k], k)
    for k in args[8]:
        assert_equal(args[8][k], args_c[8][k], k)
    for g, w in zip(args[0], args_c[0]):
        assert_equal(g, w)
    # a wave that allows no partitions chooses none
    assert allow or 5 not in set(to_np(want["btype"]).tolist())


@pytest.mark.cuda
@pytest.mark.parametrize("is_ref", [False, True])
def test_cuda_b_frame_matches_cpu(is_ref):
    """One QCIF B frame through `make_b_encoder` (partitions, allowed
    unless `is_ref`) on the card and on the CPU: every per-wave output
    and the recon planes equal; KB once (the whole picture), K2 never."""
    dev = cuda_device()
    w, h = 176, 144
    sched = build_schedule(w // 16, h // 16, 1)
    frames = [synth_frame(w, h, t) for t in range(3)]
    planes = [torch.as_tensor(p) for p in (*frames[1], *frames[0],
                                           *frames[2])]
    rng = np.random.default_rng(4)
    col = [torch.as_tensor(rng.random(sched.n_mbs) < f) for f in (0.3, 0.1)]
    encode = tb.make_b_encoder(sched, partitions=True)
    before = (dict(k2w.launches), dict(kb.launches))
    out_d, ys_d = encode(*(p.to(dev) for p in planes),
                         *(c.to(dev) for c in col), 30, not is_ref)
    torch.cuda.synchronize()
    assert k2w.launches["K2"] - before[0]["K2"] == 0
    assert kb.launches["KB"] - before[1]["KB"] == 1
    out_c, ys_c = encode(*planes, *col, 30, not is_ref)
    for k, c in {**ys_c, **out_c}.items():
        d = {**ys_d, **out_d}[k]
        assert d.dtype == c.dtype and d.shape == c.shape, k
        assert_equal(d, c, k)


@pytest.mark.cuda
@pytest.mark.parametrize("symbol_mode", ["CAVLC", "CABAC"])
def test_cuda_bgop_stream_matches_cpu(symbol_mode):
    """QCIF hierarchical B (`num_b_frames=2`, 7 frames, deblock; CABAC
    with rate control at 256 kb/s): the stream, QPs and recon on the card
    equal the CPU run's; KB once a B frame."""
    dev = cuda_device()
    frames = [synth_frame(176, 144, t) for t in range(7)]
    rc = dict(rate_control=True, bitrate=256_000) \
        if symbol_mode == "CABAC" else {}
    cfg = EncoderConfig(width=176, height=144, qp=28, intra_period=0,
                        num_b_frames=2, symbol_mode=symbol_mode, **rc)
    before = dict(kb.launches)
    gpu = Encoder(cfg, device=dev)
    got = gpu.encode_sequence(frames)
    assert kb.launches["KB"] - before["KB"] == 4
    cpu = Encoder(cfg, device="cpu")
    assert got == cpu.encode_sequence(frames)
    assert [s.qp for s in gpu.stats] == [s.qp for s in cpu.stats]
    for g_rec, c_rec in zip(gpu.recons, cpu.recons):
        for g, c in zip(g_rec, c_rec):
            assert_equal(to_np(g), to_np(c))


@pytest.mark.cuda
@pytest.mark.parametrize("n_bands", [1, 3])
def test_cuda_tiled_bgop_matches_cpu(n_bands):
    """QCIF hierarchical B (`num_b_frames=2`, 7 frames, deblock, CABAC,
    rate control at 256 kb/s) through `TiledEncoder` with 1 and 3 bands
    (all on the card): the stream, QPs and recon equal the same bands on
    the CPU; KB once a band of each B frame, K1 once a band picture."""
    from tpu264_torch.runtime.tiled import TiledEncoder, make_mesh
    dev = cuda_device()
    frames = [synth_frame(176, 144, t) for t in range(7)]
    cfg = EncoderConfig(width=176, height=144, qp=28, intra_period=0,
                        num_b_frames=2, symbol_mode="CABAC",
                        rate_control=True, bitrate=256_000)
    before = (dict(kb.launches), dict(k1.launches))
    gpu = TiledEncoder(cfg, make_mesh(n_bands, gop=1,
                                      devices=[dev] * n_bands))
    (got,) = gpu.encode_sequence([frames])
    assert kb.launches["KB"] - before[0]["KB"] == 4 * n_bands
    assert k1.launches["K1"] - before[1]["K1"] == 7 * n_bands
    cpu = TiledEncoder(cfg, make_mesh(n_bands, gop=1,
                                      devices=["cpu"] * n_bands))
    assert [got] == cpu.encode_sequence([frames])
    assert [s.qp for s in gpu.stats[0]] == [s.qp for s in cpu.stats[0]]
    for g_rec, c_rec in zip(gpu.recons[0], cpu.recons[0]):
        for g, c in zip(g_rec, c_rec):
            assert g.device.type == "cuda"
            assert_equal(to_np(g), to_np(c))


@pytest.mark.cuda
def test_cuda_tiled_ippp_cavlc_matches_cpu():
    """QCIF IPPP CAVLC (5 frames, deblock, the default P tools) through
    `TiledEncoder` with 3 bands on the card: the stream equals the CPU
    run's; KP once a band of each P frame."""
    from tpu264_torch.runtime.tiled import TiledEncoder, make_mesh
    dev = cuda_device()
    frames = [synth_frame(176, 144, t) for t in range(5)]
    cfg = EncoderConfig(width=176, height=144, qp=28, intra_period=0)
    before = dict(kp.launches)
    gpu = TiledEncoder(cfg, make_mesh(3, gop=1, devices=[dev] * 3))
    got = gpu.encode_sequence([frames])
    assert kp.launches["KP"] - before["KP"] == 4 * 3
    cpu = TiledEncoder(cfg, make_mesh(3, gop=1, devices=["cpu"] * 3))
    assert got == cpu.encode_sequence([frames])


def _me_inputs(dev, kind: str, w: int = 1280, h: int = 720, wp=(64, 0),
               pad: int = 24):
    """A source and a reference of w x h on the card, the reference padded
    by `pad` samples: synth frames 1 over
    0 ("synth"; with `wp` the reference pre-weighted as weighted
    prediction searches it), a seeded noise picture shifted by (3, -5)
    plus noise ("noise"), a 0/255 checkerboard against its complement
    ("checker": the largest SSDs and SATDs), or flat
    pictures ("flat") -> (y, ref_pad, half-pel planes)."""
    if kind == "synth":
        cur, ref = synth_frame(w, h, 1)[0], synth_frame(w, h, 0)[0]
    elif kind == "noise":
        r = np.random.default_rng(23)
        ref = r.integers(0, 256, (h, w))
        cur = np.clip(np.roll(ref, (3, -5), (0, 1))
                      + r.integers(-6, 7, (h, w)), 0, 255)
    elif kind == "checker":
        yy, xx = np.mgrid[:h, :w]
        ref = 255 * ((yy + xx) & 1)
        cur = 255 - ref
    else:
        cur = ref = np.full((h, w), 128)
    y = t32(cur, dev)
    ref_pad = tinter.weight_luma(kint.pad_plane(t32(ref, dev), pad), *wp)
    return y, ref_pad.contiguous(), kint.luma_planes(ref_pad).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("qp", [0, 28, 51])
@pytest.mark.parametrize("kind,wp", [("synth", (64, 0)), ("noise", (64, 0)),
                                     ("flat", (64, 0)), ("checker", (64, 0)),
                                     ("synth", (58, -7))])
@pytest.mark.parametrize("tools", [(False, False), (True, False),
                                   (True, True)])
def test_cuda_me_kernels_match_plain(tools, kind, wp, qp):
    """KF and KS on a 720p picture (every MB, the edge MBs included)
    against their plain versions on the card, tolerance 0, with the blocks
    a P picture without and with the tools and a B list with partitions
    search, at the ME lambdas of QP 0, 28 and 51, on synth, noise, flat
    (tied) and 0/255 checkerboard pictures and a weighted reference; one
    launch each."""
    dev = cuda_device()
    y, ref_pad, planes = _me_inputs(dev, kind, wp=wp)
    shapes = kme_subpel.shapes(*tools)
    names = kme_subpel.names_of(shapes)
    lam = tif.LAMBDA_TABLE[qp][2]
    args = (24, 16, lam, 80, 45, names)
    before = {**kme_search.launches, **kme_subpel.launches}
    mv_int = kme_search.full_search(y, ref_pad, *args)
    assert_equal(mv_int, kme_search.full_search_plain(y, ref_pad, *args))
    sub = (24, mv_int, lam, 80, 45, shapes)
    got = kme_subpel.subpel(y, planes, *sub)
    torch.cuda.synchronize()
    assert {**kme_search.launches, **kme_subpel.launches} == {
        "KF": before["KF"] + 1, "KS": before["KS"] + 1}
    assert_equal(got, kme_subpel.subpel_plain(y, planes, *sub))
    if kind == "flat":
        assert not mv_int.any() and not got.any()


def _border_vectors(n_names: int, wm: int, hm: int, dev):
    """Full-pel vectors of the search range, -16 on the top row and left
    column of macroblocks and +16 on the bottom row and right column."""
    r = np.random.default_rng(29)
    mv = r.integers(-16, 17, (n_names, wm * hm, 2))
    mr, mc = np.divmod(np.arange(wm * hm), wm)
    mv[:, mr == 0, 0], mv[:, mr == hm - 1, 0] = -16, 16
    mv[:, mc == 0, 1], mv[:, mc == wm - 1, 1] = -16, 16
    return t32(mv, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("qp", [0, 51])
@pytest.mark.parametrize("kind", ["noise", "checker"])
def test_cuda_me_kernels_match_plain_with_clamped_windows(kind, qp):
    """KF and KS on a 720p picture whose reference is padded by 3 samples,
    not 24: KF's search windows at the border are clamped as
    `interp.clamp_start` clamps them, and KS's reads there leave the
    planes (its unstaged branch), from KF's vectors and from +-16 border
    vectors; every block shape, equal to the plain versions, tolerance
    0."""
    dev = cuda_device()
    y, ref_pad, planes = _me_inputs(dev, kind, pad=3)
    shapes = kme_subpel.shapes(True, True)
    names = kme_subpel.names_of(shapes)
    lam = tif.LAMBDA_TABLE[qp][2]
    args = (3, 16, lam, 80, 45, names)
    mv_int = kme_search.full_search(y, ref_pad, *args)
    assert_equal(mv_int, kme_search.full_search_plain(y, ref_pad, *args))
    for mv in (mv_int, _border_vectors(len(names), 80, 45, dev)):
        sub = (3, mv, lam, 80, 45, shapes)
        assert_equal(kme_subpel.subpel(y, planes, *sub),
                     kme_subpel.subpel_plain(y, planes, *sub))


@pytest.mark.cuda
@pytest.mark.parametrize("w,h", [(1280, 720), (1920, 272)],
                         ids=["720p", "band_of_17_rows"])
def test_cuda_me_subpel_border_vectors_match_plain(w, h):
    """KS from full-pel vectors of the search range, -16 on the top row and
    left column of macroblocks and +16 on the bottom row and right column
    (the edges of the windows it stages), on a 720p picture and a 17-row
    band of 1920 samples, every block shape, at the ME lambdas of QP 0 and
    51: equal to its plain version, tolerance 0."""
    dev = cuda_device()
    y, _, planes = _me_inputs(dev, "noise", w, h)
    wm, hm = w // 16, h // 16
    shapes = kme_subpel.shapes(True, True)
    mv = _border_vectors(9, wm, hm, dev)
    for qp in (0, 51):
        sub = (24, mv, tif.LAMBDA_TABLE[qp][2], wm, hm, shapes)
        assert_equal(kme_subpel.subpel(y, planes, *sub),
                     kme_subpel.subpel_plain(y, planes, *sub))


@pytest.mark.cuda
def test_cuda_me_both_b_lists_match_plain():
    """KF and KS on both lists of a 1920x1088 B picture (synth frame 1
    between 0 and 2) with the partitions, against their plain versions,
    tolerance 0."""
    dev = cuda_device()
    w, h = 1920, 1088
    y = t32(synth_frame(w, h, 1)[0], dev)
    shapes = kme_subpel.shapes(True)
    names = kme_subpel.names_of(shapes)
    for t in (0, 2):
        ref_pad = kint.pad_plane(t32(synth_frame(w, h, t)[0], dev), 24)
        planes = kint.luma_planes(ref_pad)
        args = (24, 16, 7, w // 16, h // 16, names)
        mv_int = kme_search.full_search(y, ref_pad, *args)
        assert_equal(mv_int, kme_search.full_search_plain(y, ref_pad, *args))
        sub = (24, mv_int, 7, w // 16, h // 16, shapes)
        assert_equal(kme_subpel.subpel(y, planes, *sub),
                     kme_subpel.subpel_plain(y, planes, *sub))


@pytest.mark.cuda
def test_cuda_me_frames_match_cpu():
    """A CIF P frame with the default P tools and a QCIF B frame with the
    partitions through `make_inter_encoder` / `make_b_encoder` on the card
    and on the CPU: every output key equal; the card ran KF and KS once
    for the P frame and twice (two lists) for the B frame."""
    dev = cuda_device()
    w, h = 352, 288
    planes = [torch.as_tensor(p) for p in (*synth_frame(w, h, 3),
                                           *synth_frame(w, h, 2))]
    encode = tinter.make_inter_encoder(build_schedule(w // 16, h // 16, 1),
                                       partitions=True, p8x8=True, t8=True)
    runs = [(encode, planes, (28,), 1)]
    w, h = 176, 144
    frames = [synth_frame(w, h, t) for t in range(3)]
    planes = [torch.as_tensor(p) for p in (*frames[1], *frames[0],
                                           *frames[2])]
    col = [torch.zeros(99, dtype=torch.bool)] * 2
    encode = tb.make_b_encoder(build_schedule(w // 16, h // 16, 1),
                               partitions=True)
    runs.append((encode, planes + col, (30,), 2))
    for encode, ins, rest, lists in runs:
        before = {**kme_search.launches, **kme_subpel.launches}
        out_d, ys_d = encode(*(p.to(dev) for p in ins), *rest)
        torch.cuda.synchronize()
        assert {**kme_search.launches, **kme_subpel.launches} == {
            "KF": before["KF"] + lists, "KS": before["KS"] + lists}
        out_c, ys_c = encode(*ins, *rest)
        assert set(ys_d) == set(ys_c)
        for k, c in {**ys_c, **out_c}.items():
            d = {**ys_d, **out_d}[k]
            assert d.dtype == c.dtype and d.shape == c.shape, k
            assert_equal(d, c, k)


@pytest.mark.cuda
def test_cuda_me_wrappers_reject_bad_input():
    """KF and KS refuse a wrong type, shape or device, blocks they do not
    take and a search range past their window."""
    dev = cuda_device()
    y, ref_pad, planes = _me_inputs(dev, "synth", 96, 64)
    shapes = kme_subpel.shapes(True)[:2]
    names = kme_subpel.names_of(shapes)
    mv = kme_search.full_search(y, ref_pad, 24, 16, 4, 6, 4, names)
    kme_subpel.subpel(y, planes, 24, mv, 4, 6, 4, shapes)
    torch.cuda.synchronize()
    with pytest.raises(TypeError):
        kme_search.full_search(y.to(torch.uint8), ref_pad, 24, 16, 4, 6, 4,
                               names)
    with pytest.raises(ValueError):
        kme_search.full_search(y, ref_pad.cpu(), 24, 16, 4, 6, 4, names)
    with pytest.raises(ValueError):
        kme_search.full_search(y, ref_pad[:40], 24, 16, 4, 6, 4, names)
    with pytest.raises(ValueError):
        kme_search.full_search(y, ref_pad, 24, 17, 4, 6, 4, names)
    with pytest.raises(ValueError):
        kme_search.full_search(y, ref_pad, 24, 16, 4, 6, 4, ["16x16", "x"])
    with pytest.raises(TypeError):
        kme_subpel.subpel(y, planes.long(), 24, mv, 4, 6, 4, shapes)
    with pytest.raises(ValueError):
        kme_subpel.subpel(y, planes, 24, mv[:1], 4, 6, 4, shapes)
    with pytest.raises(ValueError):
        kme_subpel.subpel(y, planes[:3], 24, mv, 4, 6, 4, shapes)
    with pytest.raises(ValueError):
        kme_subpel.subpel(y, planes, 24, mv.cpu(), 4, 6, 4, shapes)
    with pytest.raises(ValueError):
        kme_subpel.subpel(y, planes, 24, mv, 4, 6, 4,
                          [(("16x16", "top", "bot"), (0, 0, 0), (0, 0, 0),
                            16, 4)])


def _records_both(mb, wm, hm, rows, kind, cap, t8_mode=False):
    """KR on the card and its plain version on the same card tensors ->
    ((records, counts), (records, counts)) on the host; the mvds and most
    probable modes that KR's state pass derives, and KV's from the same
    device code (`csrc/mb_preds.cuh`, KD's function), equal their plain
    version's."""
    want_in = mb_preds.preds_plain(mb, wm, hm, rows, kind)
    kv_in = {}
    before = kcv.launches["KD"]
    queued = kcr.queue(mb, wm, hm, rows, kind, cap, t8_mode)
    if hm % len(rows) == 0:
        kcv.serialize(mb, wm, hm, rows, kind, 100 * wm * hm, t8_mode,
                      derived=kv_in)
        assert kcv.launches["KD"] - before == 1
    for got_in in ((queued.mvds, queued.mpm),
                   (kv_in.get("mvds"), kv_in.get("mpm"))):
        if got_in[1] is None:
            continue
        for g, w in zip(got_in, want_in):
            assert (g is None) == (w is None)
            if w is not None:
                assert_equal(g.cpu(), w.cpu())
    got = kcr.records(mb, wm, hm, rows, kind, cap, t8_mode)
    want = kcr.records_plain(mb, wm, hm, rows, kind, cap, t8_mode)
    return [tuple(t.cpu() for t in x) for x in (got, want)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["i", "p", "b"])
def test_cuda_records_match_plain(kind):
    """KR (CABAC binarize + compact, `kernels/cabac_records.py`) equals
    `records_plain` on seeded 1280x720 MB dicts: every tool set of the
    slice kind, 1 and 3 slices, and levels scaled by 37 (QP-0-like: the
    Exp-Golomb escapes) with a cap of 4 records a MB, so that every slice
    is over it and the rows are as wide as the largest slice; KR's
    derived mvds and most probable modes equal `preds_plain`; one KR run a
    picture."""
    dev = cuda_device()
    wm, hm = 80, 45
    tool_sets = {"i": [(), ("t8",)],
                 "p": [(), ("ptype",), ("ptype", "mvq"),
                       ("ptype", "mvq", "t8")],
                 "b": [(), ("parts",), ("parts", "t8")]}[kind]
    before = kcr.launches["KR"]
    calls = 0
    for t, tools in enumerate(tool_sets):
        for slices in (1, 3):
            for scale, per_mb in ((1, 768), (37, 4)):
                seed = 100 * t + 10 * slices + scale
                if kind == "b":
                    mb = random_b_mbs(seed, wm, hm, "parts" in tools,
                                      "t8" in tools)
                else:
                    mb = random_mbs(seed, wm, hm, p_slice=kind == "p",
                                    tools=tools)
                for key in ("luma_ac", "luma_dc", "chroma_dc", "chroma_ac"):
                    mb[key] = (mb[key] * scale).astype(np.int32)
                mb = {k: torch.as_tensor(v, device=dev) for k, v in mb.items()}
                rows = list(range(0, hm, hm // slices))
                cap = wm * hm // slices * per_mb
                (recs, counts), (precs, pcounts) = _records_both(
                    mb, wm, hm, rows, kind, cap)
                assert recs.shape == precs.shape
                assert_equal(counts, pcounts)
                assert_equal(recs, precs)
                over = int(counts.max()) > cap
                assert over == (scale > 1)
                calls += 2
    assert kcr.launches["KR"] - before == calls


@pytest.mark.cuda
def test_cuda_encoder_records_match_plain():
    """The MB dicts of a CIF IPPP CABAC encode with the default P tools
    (I and P pictures) as the encoder hands them to `cabac_records` on the
    card: KR equals `records_plain` on each, 1 and 3 slices, its derived
    inputs `preds_plain`.  After a warm call, the queue half of a CABAC P
    and of a B picture (`queue_entropy`: KR, with the derivation inside)
    reads nothing back from the card (sync debug mode "error"), and the
    host half's records are the plain version's.  With a cap of one
    record a MB, every slice is over it, and the emit into wider rows
    runs only after the next frame's device work is queued (the pipelined
    IPPP path, and one band of `TiledEncoder`, whose host halves run
    after every band is queued): the streams equal those at the default
    cap."""
    from tpu264_torch.coding import encoder as encoder_mod
    dev = cuda_device()
    enc = Encoder(EncoderConfig(width=352, height=288, qp=28,
                                symbol_mode="CABAC", intra_period=0),
                  device=dev)
    seen = []
    real = encoder_mod.cabac_records

    def spy(pic, mbd, kind, cap):
        seen.append((pic, {k: v.clone() for k, v in mbd.items()}, kind, cap))
        return real(pic, mbd, kind, cap)

    frames = [synth_frame(352, 288, t) for t in range(3)]
    encoder_mod.cabac_records = spy
    try:
        stream = enc.encode_sequence(frames)
    finally:
        encoder_mod.cabac_records = real
    assert [k for _, _, k, _ in seen] == ["i", "p", "p"]
    for pic, mbd, kind, cap in seen:
        for rows in (list(pic.rows), [0, 6, 12]):
            got, want = _records_both(mbd, pic.wm, pic.hm, rows, kind, cap,
                                      pic.t8_mode)
            assert_equal(got[1], want[1])
            assert_equal(got[0], want[0])
    b_mbd = {k: torch.as_tensor(v, device=dev)
             for k, v in random_b_mbs(5, 22, 18, True, True).items()}
    b_pic = encoder_mod.Picture(22, 18, (0,), True, dev)
    for pic, mbd, kind, cap in (seen[-1], (b_pic, b_mbd, "b", 22 * 18 * 768)):
        encoder_mod.queue_entropy(pic, mbd, kind, True, cap, 1 << 16)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            queued = encoder_mod.queue_entropy(pic, mbd, kind, True, cap,
                                               1 << 16)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        recs, counts = queued
        want = kcr.records_plain(mbd, pic.wm, pic.hm, list(pic.rows), kind,
                                 cap, pic.t8_mode)
        assert_equal(counts.cpu(), want[1].cpu())
        assert_equal(recs.cpu(), want[0].cpu())
    _check_over_cap_streams(dev, frames, stream)


def _check_over_cap_streams(dev, frames, stream):
    from tpu264_torch.coding import encoder as encoder_mod
    from tpu264_torch.runtime.tiled import TiledEncoder, make_mesh
    widths = []
    real = encoder_mod.cabac_payloads

    def spy(recs, counts, *a):
        widths.append((recs.shape[1], int(counts.max())))
        return real(recs, counts, *a)

    def cfg():
        return EncoderConfig(width=352, height=288, qp=28,
                             symbol_mode="CABAC", intra_period=0)

    def tiled():
        enc = TiledEncoder(cfg(), make_mesh(1, gop=1, devices=[dev]))
        return enc.encode_sequence([frames])[0]

    want_tiled = tiled()
    encoder_mod.cabac_payloads = spy
    default_cap = encoder_mod.RECORDS_PER_MB
    try:
        assert Encoder(cfg(), device=dev, records_per_mb=1) \
            .encode_sequence(frames) == stream
        encoder_mod.RECORDS_PER_MB = 1
        assert tiled() == want_tiled
    finally:
        encoder_mod.cabac_payloads = real
        encoder_mod.RECORDS_PER_MB = default_cap
    assert len(widths) == 6
    assert all(w == most > 396 for w, most in widths)


@pytest.mark.cuda
def test_cuda_records_rejects_bad_input():
    dev = cuda_device()
    wm, hm = 11, 9
    mb = {k: torch.as_tensor(v, device=dev)
          for k, v in random_mbs(3, wm, hm).items()}
    kcr.records(mb, wm, hm, [0], "p", 1000)
    kcv.serialize(mb, wm, hm, [0], "p", 1000)
    torch.cuda.synchronize()
    for fn in (kcr.records, kcv.serialize):
        with pytest.raises(TypeError):
            fn(dict(mb, sel16=mb["sel16"].to(torch.int32)), wm, hm, [0], "p",
               1000)
        with pytest.raises(ValueError):
            fn(dict(mb, mvq=mb["mvq"][:, :3].contiguous()), wm, hm, [0],
               "p", 1000)
        with pytest.raises(ValueError):
            fn(dict(mb, mv2=mb["mv2"].cpu()), wm, hm, [0], "p", 1000)
        with pytest.raises(ValueError):
            fn(mb, wm, hm, [0, 9], "p", 1000)
        with pytest.raises(ValueError):
            fn(mb, wm, hm, [0], "x", 1000)
        with pytest.raises(KeyError):
            fn({k: v for k, v in mb.items() if k != "mv"}, wm, hm, [0], "p",
               1000)
    with pytest.raises(KeyError):
        kcr.records({k: v for k, v in mb.items() if k != "mv_skip"}, wm, hm,
                    [0], "p", 1000)


def _kv_both(mb, wm, hm, rows, kind, cap, t8_mode=False, pics=1):
    """KV and its plain version on the same CUDA tensors -> ((words,
    nbits, skipped) of KV, of the plain version); one KV run (two
    launches, its state pass deriving the mvds and modes); those equal
    `preds_plain`'s."""
    before = dict(kcv.launches)
    derived = {}
    got = kcv.serialize(mb, wm, hm, rows, kind, cap, t8_mode, pics,
                        derived=derived)
    assert kcv.launches == {k: v + 1 for k, v in before.items()}
    want = kcv.serialize_plain(mb, wm, hm, rows, kind, cap, t8_mode, pics)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.int64
    want_in = mb_preds.preds_plain(mb, wm, hm, rows, kind, pics)
    for name, w in zip(("mvds", "mpm"), want_in):
        assert (derived[name] is None) == (w is None), name
        if w is not None:
            assert_equal(derived[name].cpu(), w.cpu())
    return got, want


def _kv_check(got, want, kind):
    m32 = 0xFFFFFFFF
    assert_equal(got[1], want[1])
    assert_equal(got[0].to(torch.int64) & m32, want[0] & m32)
    if kind == "i":
        assert got[2] is None and want[2] is None
    else:
        assert_equal(got[2], want[2])


@pytest.mark.cuda
def test_cuda_kv_matches_plain():
    """KV (CAVLC serialize + pack, `kernels/cavlc_slices.py`) equals its
    plain version `serialize_plain` on the card, tolerance 0 (32 bits of
    every word, the bit counts, the skip maps, the derived mvds and
    modes): seeded 1280x720 and 1920x1088 MB dicts of every slice kind
    and tool set, 1, 3 (4 at 1088), 45 and 68 slices (a MB row each: its
    tiles of 32 MBs straddle the slices), the 8x8 PPS of an I slice,
    levels scaled by 37 (QP-0-like: the level escapes) and 160 (codes
    wider than their length), a cap of a few words a slice (every slice
    over it; the bit counts keep every bit), a 128x4096 picture of 256
    slices, P and B pictures whose skipped MBs fill whole tiles and
    whole slices, and a chunk of four 68-slice 1920x1088 I pictures in
    one run (272 slices)."""
    dev = cuda_device()
    tool_sets = {"i": [(), ("t8",)],
                 "p": [(), ("ptype",), ("ptype", "mvq"),
                       ("ptype", "mvq", "t8"), ("t8",)],
                 "b": [(), ("parts",), ("parts", "t8"), ("t8",)]}
    cases = 0
    for wm, hm, slice_sets in ((80, 45, (1, 3, 45)), (120, 68, (1, 4, 68))):
        for kind, sets in tool_sets.items():
            for t, tools in enumerate(sets):
                for slices in slice_sets:
                    for scale, per_mb in ((1, 400), (37, 400), (37, 1),
                                          (160, 400)):
                        if (wm == 120 and t and (slices == 68 or scale > 1)
                                or slices == 45 and scale > 1):
                            continue
                        seed = 1000 * t + 10 * slices + scale + wm
                        if kind == "b":
                            mb = random_b_mbs(seed, wm, hm, "parts" in tools,
                                              "t8" in tools)
                        else:
                            mb = random_mbs(seed, wm, hm,
                                            p_slice=kind == "p", tools=tools)
                        for key in ("luma_ac", "luma_dc", "chroma_dc",
                                    "chroma_ac"):
                            mb[key] = (mb[key] * scale).astype(np.int32)
                        mb = {k: torch.as_tensor(v, device=dev)
                              for k, v in mb.items()}
                        rows = list(range(0, hm, hm // slices))
                        cap = wm * hm // slices * per_mb
                        got, want = _kv_both(mb, wm, hm, rows, kind, cap,
                                             "t8" in tools)
                        _kv_check(got, want, kind)
                        assert (int(got[1].max()) > 32 * cap) == \
                            (per_mb == 1)
                        cases += 1
    assert cases > 80
    # 256 slices of one MB row; skipped MBs over whole tiles and slices
    wm, hm = 8, 256
    for kind in ("i", "p", "b"):
        mb = (random_b_mbs(7, wm, hm, True, True) if kind == "b"
              else random_mbs(7, wm, hm, p_slice=kind == "p"))
        mb = {k: torch.as_tensor(v, device=dev) for k, v in mb.items()}
        got, want = _kv_both(mb, wm, hm, list(range(hm)), kind, wm * 100)
        _kv_check(got, want, kind)
    wm, hm = 80, 45
    for kind, tools in (("p", ("ptype", "mvq", "t8")), ("b", ("parts",))):
        for slices, lo, hi in ((1, 100, 1000), (3, 1200, 2400),
                               (45, 0, 3600)):
            mb = (random_b_mbs(11, wm, hm, True, False) if kind == "b"
                  else random_mbs(11, wm, hm, tools=tools))
            for key in ("luma_ac", "luma_dc", "chroma_dc", "chroma_ac"):
                mb[key][lo:hi] = 0
            if kind == "p":
                mb["is_inter"][lo:hi] = 1
                mb["ptype"][lo:hi] = 0
                mb["mv"][lo:hi] = mb["mv_skip"][lo:hi]
            else:
                mb["btype"][lo:hi] = 3
                mb["bptype"][lo:hi] = 0
            mb = {k: torch.as_tensor(v, device=dev) for k, v in mb.items()}
            rows = list(range(0, hm, hm // slices))
            got, want = _kv_both(mb, wm, hm, rows, kind,
                                 wm * hm // slices * 100)
            _kv_check(got, want, kind)
            assert bool(got[2][lo:hi].all())
            if slices == 3:
                assert int(got[1][1]) == 0
    # a chunk of four 68-slice 1920x1088 pictures in one run
    wm, hm = 120, 68
    pics = [random_mbs(300 + f, wm, hm, p_slice=False, tools=())
            for f in range(4)]
    chunk = {k: torch.as_tensor(np.concatenate([p[k] for p in pics]),
                                device=dev) for k in pics[0]}
    rows = list(range(hm))
    got, want = _kv_both(chunk, wm, hm, rows, "i", wm * 100, pics=4)
    assert got[0].shape == (4 * 68, wm * 100)
    _kv_check(got, want, "i")
    for f in range(4):
        one = {k: v[f * wm * hm:(f + 1) * wm * hm] for k, v in chunk.items()}
        alone = kcv.serialize(one, wm, hm, rows, "i", wm * 100)
        assert_equal(alone[1], got[1][68 * f:68 * (f + 1)])
        assert_equal(alone[0], got[0][68 * f:68 * (f + 1)])


@pytest.mark.cuda
def test_cuda_kv_rejects_bad_input():
    dev = cuda_device()
    wm, hm = 11, 9
    mb = {k: torch.as_tensor(v, device=dev)
          for k, v in random_mbs(3, wm, hm).items()}
    kcv.serialize(mb, wm, hm, [0], "p", 1000)
    torch.cuda.synchronize()
    before = kcv.launches["KV"]
    for bad, args, err in (
            (dict(mb, sel16=mb["sel16"].to(torch.int32)), ([0], "p", 1000),
             TypeError),
            (dict(mb, luma_ac=mb["luma_ac"][:, :15].contiguous()),
             ([0], "p", 1000), ValueError),
            (dict(mb, mv_skip=mb["mv_skip"].cpu()), ([0], "p", 1000),
             ValueError),
            (dict(mb, mv=mb["mv"].t().contiguous().t()), ([0], "p", 1000),
             ValueError),
            (mb, ([0, 4], "p", 1000), ValueError),
            (mb, ([0, 9], "p", 1000), ValueError),
            (mb, ([0], "x", 1000), ValueError),
            (mb, ([0], "p", -1), ValueError),
            ({k: v for k, v in mb.items() if k != "mv_skip"},
             ([0], "p", 1000), KeyError),
            ({k: v for k, v in mb.items() if k != "modes"},
             ([0], "i", 1000), KeyError)):
        with pytest.raises(err):
            kcv.serialize(bad, wm, hm, *args)
    with pytest.raises(ValueError):
        kcv.serialize(mb, wm, hm, [0], "p", 1000, pics=2)
    assert kcv.launches["KV"] == before

"""The port's CUDA kernels and its encoder on the card, held to the plain
torch versions on the CPU with tolerance 0.

Every test here is marked `cuda` and skips without a card.  The file
imports neither jax nor `tpu264`, so it also runs where only torch is
installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

import torch

from tpu264_torch.coding import intra_frame as tif
from tpu264_torch.coding.encoder import Encoder
from tpu264_torch.coding.wavefront import build_schedule
from tpu264_torch.config import EncoderConfig
from tpu264_torch.kernels import dct_quant as dq
from tpu264_torch.kernels import deblock as kd
from tpu264_torch.kernels import deblock_lines as dl
from tpu264_torch.kernels import deblock_wave as k4w
from tpu264_torch.kernels import i16_chroma_wave as k3w
from tpu264_torch.kernels import i4x4_wave as k2w
from tpu264_torch.media.synth import synth_frame
from tpu264_torch.ref import deblock as rd
from tpu264_torch.ref.transform import chroma_qp
from tpu264_torch.tools.synth_inputs import random_deblock_picture, \
    random_wave

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
    k4w.deblock_wave(y, c, c.clone(), b, b.clone(), 0, 28, 28)
    with pytest.raises(TypeError):
        k4w.deblock_wave(y.to(torch.uint8), c, c, b, b, 0, 28, 28)
    with pytest.raises(ValueError):             # a chroma plane's shape
        k4w.deblock_wave(y, c[:, :32], c, b, b, 0, 28, 28)
    with pytest.raises(ValueError):             # not contiguous
        k4w.deblock_wave(y, c, c, b.t().contiguous().t(), b, 0, 28, 28)
    with pytest.raises(ValueError):             # another device
        k4w.deblock_wave(y, c, c, b.cpu(), b, 0, 28, 28)
    with pytest.raises(ValueError):             # no such wave
        k4w.deblock_wave(y, c, c, b, b, 9, 28, 28)
    with pytest.raises(ValueError):             # not whole macroblocks
        k4w.deblock_wave(y[:40], c, c, b, b, 0, 28, 28)


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
@pytest.mark.parametrize("deblock,slices",
                         [(True, 1), (True, 3), (False, 1), (False, 3)])
def test_cuda_encoder_matches_cpu(deblock, slices):
    """QCIF, 2 frames, all-intra CABAC: the stream and recon on the card
    equal the CPU run's, and every kernel of the path was launched."""
    dev = cuda_device()
    from tpu264_torch.entropy import cabac_engine_cuda as k1
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

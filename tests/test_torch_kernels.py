"""Kernels K1-K4 of the PyTorch port: their plain torch versions (what a
wrapper runs for a CPU tensor) against the JAX reference's Pallas
kernels in interpret mode and the scalar oracles, with tolerance 0.
The CUDA kernels are held to these plain versions in test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu264.entropy import cabac_binarize as rcb
from tpu264.entropy import cabac_pallas
from tpu264.entropy.cabac_binarize_j import pack_records as ref_pack
from tpu264.entropy.cabac_engine import CabacEncoder
from tpu264.kernels import pallas_kernels as pk
from tpu264.ref import deblock as rd

from tpu264_torch.entropy import cabac_binarize as tcb
from tpu264_torch.entropy import cabac_engine_cuda as k1
from tpu264_torch.kernels import dct_quant as dq
from tpu264_torch.kernels import deblock_lines as dl

from torch_util import assert_equal, carry_records, long_run_records, \
    random_records, run_engine, t32, to_np

rng = np.random.default_rng(7)


# ------------------------------------------------------------ K2 / K3

@pytest.mark.parametrize("qp", [0, 12, 28, 39, 51])
@pytest.mark.parametrize("intra", [True, False])
def test_fdct_quant_plain_matches_pallas(qp, intra):
    x = rng.integers(-255, 256, size=(37, 16, 4, 4), dtype=np.int64)
    want = pk.fdct_quant4x4(jnp.asarray(x, jnp.int32), qp, intra=intra)
    got = dq.fdct_quant4x4(t32(x), qp, intra)
    assert_equal(got, want)


def test_fdct_plain_matches_pallas():
    x = rng.integers(-255, 256, size=(201, 4, 4))
    assert_equal(dq.fdct4x4(t32(x)), pk.fdct4x4(jnp.asarray(x, jnp.int32)))


def test_dct_wrapper_rejects_bad_input():
    x = t32(rng.integers(-255, 256, size=(8, 4, 4)))
    with pytest.raises(TypeError):
        dq.fdct4x4(x.to(torch.int64))
    with pytest.raises(ValueError):
        dq.fdct4x4(x.transpose(1, 2))
    with pytest.raises(ValueError):
        dq.fdct_quant4x4(x.reshape(8, 16), 28, True)


def test_dct_plain_calls_are_not_counted():
    before = dict(dq.launches)
    dq.fdct4x4(t32(np.zeros((3, 4, 4))))
    dq.fdct_quant4x4(t32(np.zeros((3, 4, 4))), 28, True)
    assert dq.launches == before


# ------------------------------------------------------------------ K4

def _lines_case(qp):
    win = rng.integers(0, 256, size=(9, 16, 8))
    bs = rng.integers(0, 5, size=(9, 16))
    alpha, beta = int(rd.ALPHA_TABLE[qp]), int(rd.BETA_TABLE[qp])
    return win, bs, alpha, beta, rd.TC0_TABLE[qp]


@pytest.mark.parametrize("qp", [10, 26, 38, 51])
def test_deblock_lines_plain_matches_pallas_and_oracle(qp):
    win, bs, alpha, beta, tc0 = _lines_case(qp)
    got = dl.filter_luma_lines(t32(win), t32(bs), alpha, beta, tc0.tolist())
    want = pk.filter_luma_lines(jnp.asarray(win, jnp.int32),
                                jnp.asarray(bs, jnp.int32), alpha, beta,
                                jnp.asarray(tc0, jnp.int32))
    assert_equal(got, want)
    oracle = rd.filter_luma_lines(win.reshape(-1, 8), bs.reshape(-1), alpha,
                                  beta, tc0)
    assert_equal(to_np(got).reshape(-1, 8), oracle)


def test_deblock_lines_near_boundary_values():
    # crafted flat/edge content exercises strong + normal filter paths
    base = np.full((4, 16, 8), 120, dtype=np.int64)
    base[..., 4:] = 124            # small step across the edge
    base[1, :, 4:] = 250           # large step: filtering suppressed
    bs = np.array([4, 4, 2, 0])[:, None].repeat(16, 1)
    qp = 32
    alpha, beta = int(rd.ALPHA_TABLE[qp]), int(rd.BETA_TABLE[qp])
    tc0 = rd.TC0_TABLE[qp]
    got = dl.filter_luma_lines(t32(base), t32(bs), alpha, beta, tc0.tolist())
    want = pk.filter_luma_lines(jnp.asarray(base, jnp.int32),
                                jnp.asarray(bs, jnp.int32), alpha, beta,
                                jnp.asarray(tc0, jnp.int32))
    assert_equal(got, want)


def test_deblock_lines_rejects_bad_input():
    win = t32(rng.integers(0, 256, size=(4, 8)))
    bs = t32(np.ones(4))
    with pytest.raises(ValueError):
        dl.filter_luma_lines(t32(np.zeros((4, 6))), bs, 10, 4, [1, 1, 1])
    with pytest.raises(TypeError):
        dl.filter_luma_lines(win, bs.to(torch.int64), 10, 4, [1, 1, 1])
    with pytest.raises(ValueError):
        dl.filter_luma_lines(t32(np.zeros((8, 4))).T, bs, 10, 4, [1, 1, 1])


# ------------------------------------------------------------------ K1

def _replay_python(kinds, aa, bb, table, qp):
    eng = CabacEncoder(table, qp)
    for kind, a, b in zip(kinds.tolist(), aa.tolist(), bb.tolist()):
        if kind == rcb.K_CTX:
            for _ in range(b >> 1):
                eng.encode(a, b & 1)
        elif kind == rcb.K_BYP:
            for i in range(b - 1, -1, -1):
                eng.encode_bypass((a >> i) & 1)
        else:
            eng.encode_terminate(a)
    return eng.get_bytes()


@pytest.mark.parametrize("seed,n", [(0, 100), (1, 1500), (2, 5000)])
def test_engine_plain_matches_python_engine(seed, n):
    k, a, b = random_records(seed, n)
    _, _, got = run_engine([(k, a, b)], 0, 28)
    assert got[0] == _replay_python(k, a, b, 0, 28)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_engine_plain_carry_and_outstanding_runs(seed):
    """Hand-made records that pile up 3 to 700 outstanding bits and
    resolve them with and without a carry (runs of 0x00 and of 0xFF
    payload bytes): the plain version against the reference's Python
    coder."""
    k, a, b = carry_records(seed)
    _, nbytes, got = run_engine([(k, a, b)], 0, 28)
    assert got[0] == _replay_python(k, a, b, 0, 28)
    assert int(nbytes[0]) == len(got[0])
    assert b"\x00" * 80 in got[0] and b"\xff" * 15 in got[0]


def test_engine_plain_long_runs():
    """Runs of up to 8191 bins in one context, the bin value changing from
    record to record: the plain version against the reference's Python
    coder."""
    k, a, b = long_run_records(4, n=8, tail=30)
    assert int((b[:8] >> 1).max()) == 8191
    _, nbytes, got = run_engine([(k, a, b)], 1, 30)
    assert got[0] == _replay_python(k, a, b, 1, 30)
    assert int(nbytes[0]) == len(got[0])


def test_engine_plain_matches_pallas_kernel():
    k, a, b = random_records(3, 120)
    cap = len(k) + 4
    rec = np.zeros((1, cap), np.int32)
    rec[0, :len(k)] = np.asarray(ref_pack(jnp.asarray(k), jnp.asarray(a),
                                          jnp.asarray(b)))
    run = cabac_pallas.make_slice_encoder(cap, 512, interpret=True)
    w_ref, nb_ref = run(jnp.asarray(rec), jnp.asarray([len(k)], jnp.int32),
                        jnp.asarray(cabac_pallas.init_packed_states(1, 33)))
    words, nbytes, _ = run_engine([(k, a, b)], 1, 33, pad=4, out_cap=512)
    assert_equal(nbytes, nb_ref)
    # the Pallas kernel rounds its word buffer up; the rest is zero
    assert_equal(words, np.asarray(w_ref)[:, :512])
    assert not np.asarray(w_ref)[:, 512:].any()


def test_engine_plain_codes_on_after_final_terminate():
    """Records after a terminate bin 1 (no slice has any): the plain
    version goes on coding after the stop bit, as the reference's Pallas
    kernel does."""
    k, a, b = (np.concatenate(p) for p in zip(random_records(8, 40),
                                              random_records(9, 30)))
    assert k[40] == 2 and a[40] == 1 and len(k) == 72
    cap = len(k) + 4
    rec = np.zeros((1, cap), np.int32)
    rec[0, :len(k)] = np.asarray(ref_pack(jnp.asarray(k), jnp.asarray(a),
                                          jnp.asarray(b)))
    run = cabac_pallas.make_slice_encoder(cap, 512, interpret=True)
    w_ref, nb_ref = run(jnp.asarray(rec), jnp.asarray([len(k)], jnp.int32),
                        jnp.asarray(cabac_pallas.init_packed_states(0, 28)))
    words, nbytes, _ = run_engine([(k, a, b)], 0, 28, pad=4, out_cap=512)
    assert_equal(nbytes, nb_ref)
    assert_equal(words, np.asarray(w_ref)[:, :512])
    head = run_engine([(k[:41], a[:41], b[:41])], 0, 28)[2][0]
    assert len(head) < int(nbytes[0])


def test_payloads_refuse_stray_record_report():
    """nbytes = -2 is how the CUDA kernel reports records after a final
    terminate bin; -1 an overflowed word buffer."""
    words = t32(np.zeros((2, 4)))
    with pytest.raises(ValueError, match="final terminate"):
        k1.payloads_from_words(words, t32([3, -2]))
    with pytest.raises(RuntimeError, match="overflowed"):
        k1.payloads_from_words(words, t32([-1, 3]))


def test_engine_plain_several_slices():
    slices = [random_records(10 + s, 300 + 200 * s) for s in range(3)]
    _, nbytes, got = run_engine(slices, 2, 40)
    for s, (k, a, b) in enumerate(slices):
        assert got[s] == _replay_python(k, a, b, 2, 40)
        assert int(nbytes[s]) == len(got[s])


def test_engine_reports_overflow():
    k, a, b = random_records(4, 2000)
    with pytest.raises(RuntimeError):
        run_engine([(k, a, b)], 0, 28, out_cap=8)


def test_pack_records_wraps_kind2_and_unpacks():
    k = np.array([0, 1, 2, 2], np.int32)
    a = np.array([459, 65535, 0, 1], np.int32)
    b = np.array([2 | (13 << 1), 16, 0, 0], np.int32)
    packed = tcb.pack_records(t32(k), t32(a), t32(b))
    assert packed.dtype == torch.int32
    assert_equal(packed, ref_pack(jnp.asarray(k), jnp.asarray(a),
                                  jnp.asarray(b)))
    kk, aa, bb = tcb.unpack_records(to_np(packed))
    assert_equal(kk, k)
    assert_equal(aa, a)
    assert_equal(bb, b)

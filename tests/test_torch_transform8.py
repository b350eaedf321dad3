"""The port's 8x8 transform module (`kernels/transform8.py`, the plain
version of the 8x8 path of the P wave kernel KP) against the JAX
reference: the transforms, quantisers and scan on random blocks at every
QP, and the float32 pieces of the transform choice (the lambda table, the
coefficient bits, the rounding of SSD + lambda x bits) against the
reference's own expressions compiled as its encoder compiles them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu264.kernels import transform8 as rk8
from tpu264.ref import transform8 as r8

from tpu264_torch.kernels import transform8 as tk8
from tpu264_torch.ref import transform8 as t8ref

from torch_util import assert_equal, t32


def _blocks(seed, n=300, lo=-255, hi=256):
    return np.random.default_rng(seed).integers(lo, hi, size=(n, 2, 8, 8))


def test_numpy_copy_equals_reference():
    for name in ("MF8_TABLE", "V8_TABLE", "ZIGZAG_8x8"):
        np.testing.assert_array_equal(getattr(t8ref, name), getattr(r8, name))
    x = _blocks(0)
    np.testing.assert_array_equal(t8ref.fdct8x8(x), r8.fdct8x8(x))
    d = _blocks(1, lo=-4000, hi=4000)
    np.testing.assert_array_equal(t8ref.idct8x8(d), r8.idct8x8(d))


def test_transforms_and_scan():
    x = _blocks(2)
    assert_equal(tk8.fdct8x8(t32(x)), rk8.fdct8x8(jnp.asarray(x, jnp.int32)))
    d = _blocks(3, lo=-30000, hi=30000)
    assert_equal(tk8.idct8x8(t32(d)), rk8.idct8x8(jnp.asarray(d, jnp.int32)))
    assert_equal(tk8.zigzag_scan8(t32(d)),
                 rk8.zigzag_scan8(jnp.asarray(d, jnp.int32)))


@pytest.mark.parametrize("intra", [True, False])
def test_quant_dequant_every_qp(intra):
    w = rk8.fdct8x8(jnp.asarray(_blocks(4), jnp.int32))
    for qp in range(52):
        lev = tk8.quant8x8(t32(np.asarray(w)), qp, intra)
        want = rk8.quant8x8(w, jnp.int32(qp), intra)       # traced qp
        assert_equal(lev, want, f"quant qp {qp}")
        assert_equal(lev, rk8.quant8x8(w, qp, intra), f"quant qp {qp} int")
        assert_equal(tk8.dequant8x8(lev, qp),
                     rk8.dequant8x8(jnp.asarray(want), jnp.int32(qp)),
                     f"dequant qp {qp}")


def test_lambda_table_is_the_reference_expression():
    """The encoder computes 0.85 * 2^((qp - 12) / 3) in float32 under jit
    with a traced qp (`tpu264/coding/inter_frame.py`); the table holds
    exactly those 52 values."""
    lam = jax.jit(lambda qp: 0.85 * jnp.exp2(
        (qp.astype(jnp.float32) - 12.0) / 3))
    want = np.array([np.float32(lam(jnp.int32(q))) for q in range(52)])
    assert tk8.LAM_SSD.dtype == torch.float32
    np.testing.assert_array_equal(tk8.LAM_SSD.numpy(), want)


def test_coeff_bits_is_the_reference_expression():
    """2 * ceil(log2(|l| + 1)) + 1 in float32 through XLA's log2, over
    every level the quantisers can produce and far past them."""
    @jax.jit
    def rbits(lev):
        a = jnp.abs(lev).astype(jnp.float32)
        return jnp.where(a > 0, 2.0 * jnp.ceil(jnp.log2(a + 1.0)) + 1.0, 0.0)

    lev = np.arange(-(1 << 17), 1 << 17, dtype=np.int32)
    assert_equal(tk8.coeff_bits(t32(lev)), np.asarray(rbits(lev)))


def test_choice_cost_rounds_as_the_reference_program():
    """SSD + lambda x bits and the comparison of the two transforms'
    costs, as the reference's compiled program evaluates them (one
    rounding: XLA fuses the product and the sum), on random costs and on
    pairs one float32 step apart, at every QP."""
    rng = np.random.default_rng(5)
    n = 4000
    ssd = rng.integers(0, 256 * 255 * 255, size=n).astype(np.int32)
    bits = rng.integers(0, 256 * 35, size=n).astype(np.int32)

    @jax.jit
    def better(ssd8, rb8, ssd4, rb4, qp):
        lam = 0.85 * jnp.exp2((qp.astype(jnp.float32) - 12.0) / 3)
        return (ssd8.astype(jnp.float32) + lam * rb8.astype(jnp.float32)
                < ssd4.astype(jnp.float32) + lam * rb4.astype(jnp.float32))

    for qp in range(52):
        # the other transform: the same cost moved by a step or two
        ssd2 = ssd + rng.integers(-2, 3, size=n).astype(np.int32)
        bits2 = bits + rng.integers(-1, 2, size=n).astype(np.int32)
        got = (tk8.choice_cost(t32(ssd), t32(bits), qp)
               < tk8.choice_cost(t32(ssd2), t32(bits2), qp))
        want = better(ssd, bits, ssd2, bits2, jnp.int32(qp))
        assert_equal(got, np.asarray(want), f"qp {qp}")

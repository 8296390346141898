"""ops/fp: f32 products and quotients that round like IEEE f32 on the host."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dmmt_jpeg_encoder.ops.fp import div, mul


@pytest.fixture
def operands():
    rng = np.random.default_rng(7)
    a = rng.uniform(-300.0, 300.0, 4096).astype(np.float32)
    b = rng.uniform(0.5, 120.0, 4096).astype(np.float32)
    c = rng.uniform(-300.0, 300.0, 4096).astype(np.float32)
    return a, b, c


def test_div_is_the_correctly_rounded_f32_quotient(operands):
    a, b, _ = operands
    got = np.asarray(jax.jit(div)(a, b))
    want = (a.astype(np.float64) / b.astype(np.float64)).astype(np.float32)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, a / b)


def test_div_by_a_python_scalar(operands):
    a, _, _ = operands
    got = np.asarray(jax.jit(lambda x: div(x, 255.0))(a))
    np.testing.assert_array_equal(got, a / np.float32(255.0))


def test_mul_then_add_rounds_the_product_first(operands):
    a, b, c = operands
    got = np.asarray(jax.jit(lambda x, y, z: mul(x, y) + z)(a, b, c))
    np.testing.assert_array_equal(got, (a * b) + c)


def test_mul_keeps_shape_and_dtype(operands):
    a, b, _ = operands
    out = mul(jnp.asarray(a).reshape(64, 64), jnp.float32(0.5))
    assert out.shape == (64, 64) and out.dtype == jnp.float32
    np.testing.assert_array_equal(np.asarray(out).ravel(), a * np.float32(0.5))

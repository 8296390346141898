"""f32 arithmetic that rounds the same on every backend.

Multiplies: compilers may contract a multiply whose result feeds an add into one fused
multiply-add (FMA), which rounds once where the source rounds twice. XLA's
CPU and GPU code generators both do it, in different places, so the same
program would quantize a few coefficients differently per backend. The
reference encoder rounds every product (IEEE f32, no contraction), and the
byte goldens pin that.

``mul`` passes the product through a select on ``is_finite`` — the
identity for every finite value this encoder computes — which no backend
folds away, so the following add sees a rounded f32 operand and cannot be
contracted with the multiply.

Divisions: the GPU backend lowers an f32 divide to an approximate
instruction (up to 2 ulp off), while the CPU divides exactly. ``div``
divides in f64 and rounds once to f32; for f32 operands that equals the
correctly rounded f32 quotient (53 >= 2 * 24 + 2 bits makes the double
rounding innocuous), on every backend.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def mul(a, b):
    """a * b, rounded to f32 before any consumer sees it."""
    p = jnp.multiply(a, b)
    return jnp.where(lax.is_finite(p), p, jnp.zeros_like(p))


def div(a, b):
    """a / b as the correctly rounded f32 quotient."""
    with jax.enable_x64(True):
        q = jnp.asarray(a, jnp.float32).astype(jnp.float64) / jnp.asarray(
            b, jnp.float32
        ).astype(jnp.float64)
        return q.astype(jnp.float32)

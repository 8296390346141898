"""Quantization + zigzag reorder (device).

Matches the reference quantizer's math (reference:
src/image/writer/jpeg/transformer/quantizer.rs:53-63): divide each raster-
order coefficient by its table entry, round HALF AWAY FROM ZERO (Rust
f32::round, not the f32 default round-half-even), cast to i16.

The zigzag reorder (frequency_block.rs:1-6) is a static column gather.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..tables import ZIGZAG
from .fp import div


def round_half_away_from_zero(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.sign(x) * jnp.floor(jnp.abs(x) + 0.5)


def quantize_zigzag(coeffs: jnp.ndarray, qtable_raster: jnp.ndarray) -> jnp.ndarray:
    """[N, 8, 8] f32 DCT coefficients + uint8[64] raster table ->
    int16 [N, 64] quantized coefficients in zigzag order."""
    n = coeffs.shape[0]
    flat = coeffs.reshape(n, 64)
    scaled = div(flat, qtable_raster.astype(jnp.float32))
    zz = scaled[:, np.asarray(ZIGZAG)]
    return round_half_away_from_zero(zz).astype(jnp.int16)

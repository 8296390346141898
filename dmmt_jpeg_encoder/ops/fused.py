"""Fused DCT + quantize + zigzag as one matmul (the DCTVariant.FUSED path).

The reference runs Arai butterflies per 8x8 block on a thread pool, then a
separate quantize pass, then a zigzag reorder (reference:
src/cosine_transform/arai.rs, src/...transformer/quantizer.rs,
frequency_block.rs). Here all three collapse into ONE constant matrix:

    vec(C X C^T) = (C (x) C) vec(X)        -- Kronecker identity

so for flattened blocks X [N, 64],

    out_zz[n, j] = round( X[n, :] @ M[:, j] ),
    M[i, j] = (C (x) C)[i, ZZ[j]] / q[ZZ[j]]

i.e. the 2-D DCT *is* a 64x64 matmul whose columns are pre-permuted into
zigzag order and pre-scaled by the quantization table: one [N,64]x[64,64]
matmul at HIGHEST precision (never TF32), then half-away-from-zero
rounding. XLA's summation order differs from the Arai butterflies, so a
coefficient that sits on a .5 rounding boundary can land one step away
from the ARAI variant's.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..tables import ZIGZAG
from .dct import dct_matrix
from .quantize import round_half_away_from_zero as _round_half_away


def _kron_dct64() -> np.ndarray:
    """K[i, r]: contribution of flat input sample i to flat DCT coeff r."""
    c = dct_matrix().astype(np.float64)  # [k, n]
    k = np.zeros((64, 64))
    for u in range(8):
        for v in range(8):
            r = u * 8 + v
            for aa in range(8):
                for bb in range(8):
                    k[aa * 8 + bb, r] = c[u, aa] * c[v, bb]
    return k


_K64 = _kron_dct64()


def fused_matrix(qtable_raster: jnp.ndarray) -> jnp.ndarray:
    """M [64, 64] f32: DCT x zigzag x (1/q) folded into one matrix."""
    k = jnp.asarray(_K64[:, ZIGZAG].astype(np.float32))  # [64 in, 64 zz]
    q = qtable_raster.astype(jnp.float32)[ZIGZAG]
    return k / q[None, :]


def fused_dct_quantize_zigzag(
    blocks: jnp.ndarray, qtable_raster: jnp.ndarray
) -> jnp.ndarray:
    """[N, 8, 8] f32 blocks + uint8[64] raster table -> int16 [N, 64] zigzag.

    Drop-in replacement for dct2d(...) + quantize_zigzag(...)."""
    n = blocks.shape[0]
    m = fused_matrix(qtable_raster)
    y = jnp.dot(
        blocks.reshape(n, 64), m, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return _round_half_away(y).astype(jnp.int16)

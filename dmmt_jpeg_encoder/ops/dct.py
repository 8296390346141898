"""Batched 8x8 DCT-II variants (device).

The reference ships three interchangeable scalar implementations
(src/cosine_transform/{simple,separated,arai}.rs) and runs Arai-Agui-
Nakajima in production via a thread pool over 700-block chunks. Here the
batch of blocks IS the vector axis: every variant below operates on
[N, 8, 8] at once with no thread pool, no chunking, no unsafe aliasing.

- SIMPLE:    textbook O(n^4) contraction against the 4-D cosine tensor
             (cross-check only; src/cosine_transform/simple.rs:19-99).
- SEPARATED: C @ X @ C^T as two batched matmuls
             (src/cosine_transform/separated.rs:3-94).
- ARAI:      the AAN butterfly graph, vectorized across the block batch:
             ~54 adds + 13 muls per 8-point pass instead of 128
             multiply-adds, and faithful to the reference's f32 operation
             order (src/cosine_transform/arai.rs:29-104) so post-quantization
             integers match the Rust encoder. Every product is rounded
             before it is added (ops/fp.mul), so no backend fuses a
             multiply-add and the integers are the same on CPU and GPU.

All math stays in float32; matmuls request HIGHEST precision so no
backend drops to reduced-precision (bf16/TF32) passes.
"""

from __future__ import annotations

import math

import numpy as np
import jax
import jax.numpy as jnp

from ..config import DCTVariant
from .fp import mul

# --- Arai constants (src/cosine_transform/arai.rs:7-26) -----------------------

_A1 = np.float32(1.0 / math.sqrt(2.0))
_A2 = np.float32(0.5411961)
_A3 = _A1
_A4 = np.float32(1.3065629)
_A5 = np.float32(0.3826834)

_S = tuple(
    np.float32(s)
    for s in (
        0.3535533,
        0.2548978,
        0.27059805,
        0.30067244,
        0.35355338,
        0.4499881,
        0.6532815,
        1.2814577,
    )
)


def dct_matrix() -> np.ndarray:
    """8-point DCT-II matrix C (f32): row k is s_k * cos((2n+1) k pi / 16)
    with s_0 = 1/(2 sqrt 2), s_k = 1/2 — the normalization the Arai scale
    factors realize (src/cosine_transform/arai.rs:17-26)."""
    c = np.zeros((8, 8), dtype=np.float64)
    for k in range(8):
        s = math.sqrt(1.0 / 8.0) if k == 0 else 0.5
        for n in range(8):
            c[k, n] = s * math.cos((2 * n + 1) * k * math.pi / 16.0)
    return c.astype(np.float32)


def _dct2d_separated(blocks: jnp.ndarray) -> jnp.ndarray:
    """C @ X @ C^T over the batch (src/cosine_transform/separated.rs)."""
    c = jnp.asarray(dct_matrix())
    tmp = jnp.einsum("kn,bnm->bkm", c, blocks, precision=jax.lax.Precision.HIGHEST)
    return jnp.einsum("bkm,lm->bkl", tmp, c, precision=jax.lax.Precision.HIGHEST)


def _dct2d_simple(blocks: jnp.ndarray) -> jnp.ndarray:
    """Direct 4-D contraction (src/cosine_transform/simple.rs:19-99)."""
    n = np.arange(8)
    k = np.arange(8)
    cos = np.cos((2 * n[None, :] + 1) * k[:, None] * np.pi / 16.0)
    s = np.where(k == 0, math.sqrt(1.0 / 8.0), 0.5)
    basis = (s[:, None] * cos).astype(np.float32)  # [k, n]
    t = jnp.einsum(
        "un,vm,bnm->buv",
        jnp.asarray(basis),
        jnp.asarray(basis),
        blocks,
        precision=jax.lax.Precision.HIGHEST,
    )
    return t


def idct2d(coeffs: jnp.ndarray) -> jnp.ndarray:
    """Inverse 2-D DCT (tests only; the reference's InverseSimple...,
    src/cosine_transform/simple.rs:101-141)."""
    c = jnp.asarray(dct_matrix())
    tmp = jnp.einsum("nk,bkm->bnm", c.T, coeffs, precision=jax.lax.Precision.HIGHEST)
    return jnp.einsum("bnm,mk->bnk", tmp, c, precision=jax.lax.Precision.HIGHEST)


def _arai_butterfly(v):
    """The raw 8-point AAN dataflow on EIGHT same-shaped arrays (bit-exact
    op order of src/cosine_transform/arai.rs:29-95); returns 8 outputs.
    Lets callers choose the layout of the eight operands."""
    v00, v01, v02, v03, v04, v05, v06, v07 = v

    v10 = v00 + v07
    v11 = v01 + v06
    v12 = v02 + v05
    v13 = v03 + v04
    v14 = v03 - v04
    v15 = v02 - v05
    v16 = v01 - v06
    v17 = v00 - v07

    v20 = v10 + v13
    v21 = v11 + v12
    v22 = v11 - v12
    v23 = v10 - v13
    v24 = -v14 - v15
    v25 = v15 + v16
    v26 = v16 + v17

    v30 = v20 + v21
    v31 = v20 - v21
    v32 = v22 + v23

    v42 = mul(v32, _A1)
    v44 = mul(-v24, _A2) - mul(v24 + v26, _A5)
    v45 = mul(v25, _A3)
    v46 = mul(v26, _A4) - mul(v26 + v24, _A5)

    v52 = v42 + v23
    v53 = v23 - v42
    v55 = v45 + v17
    v57 = v17 - v45

    v64 = v44 + v57
    v65 = v55 + v46
    v66 = v55 - v46
    v67 = v57 - v44

    return (
        mul(v30, _S[0]),
        mul(v65, _S[1]),
        mul(v52, _S[2]),
        mul(v67, _S[3]),
        mul(v31, _S[4]),
        mul(v64, _S[5]),
        mul(v53, _S[6]),
        mul(v66, _S[7]),
    )


def _arai_pass(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """One 8-point AAN pass along `axis` (size 8), vectorized over all other
    axes — a thin layout wrapper over _arai_butterfly."""
    import jax.lax as lax

    v = tuple(
        lax.index_in_dim(x, i, axis=axis, keepdims=False) for i in range(8)
    )
    y = _arai_butterfly(v)
    return jnp.stack(y, axis=axis if axis >= 0 else x.ndim + axis)


def _dct2d_arai(blocks: jnp.ndarray) -> jnp.ndarray:
    """Row passes then column passes (src/cosine_transform/arai.rs:96-103)."""
    rows_done = _arai_pass(blocks)
    cols_done = _arai_pass(rows_done.swapaxes(-1, -2)).swapaxes(-1, -2)
    return cols_done


def dct2d(blocks: jnp.ndarray, variant: DCTVariant = DCTVariant.ARAI) -> jnp.ndarray:
    """Forward 2-D DCT on [N, 8, 8] blocks."""
    if variant is DCTVariant.SIMPLE:
        return _dct2d_simple(blocks)
    if variant is DCTVariant.SEPARATED:
        return _dct2d_separated(blocks)
    return _dct2d_arai(blocks)

"""Entropy-stage analysis on device.

The reference's per-block state machines become data-parallel tensor ops:

- DC DPCM (reference: src/...transformer/categorize.rs:153-168): the
  per-channel `last_dc` chain is a shifted subtract over the block axis —
  blocks must already be in MCU-entangled order for luma
  (transformer.rs:188-221 entangles BEFORE categorizing).
- Magnitude category (categorize.rs:21-43): bit length of |v|, computed
  exactly with 15 integer threshold compares (no float log).
- AC run lengths (categorize.rs:132-151): for each nonzero at zigzag
  position p, the count of zeros since the previous nonzero is
  p - prev_nonzero(p) - 1, where prev_nonzero is an exclusive running max
  over p*[v!=0] — a `lax.associative_scan`. Runs > 15 split into
  floor(run/16) ZRL symbols plus (run mod 16); trailing zeros contribute a
  single EOB (no ZRL), exactly the reference's while-loop semantics.
- Histograms: 16-bin (DC) and 256-bin (AC) counters
  (symbol_counting.rs:8-44) as one-hot contractions, jnp.psum-able
  across shards.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def magnitude_category(v: jnp.ndarray) -> jnp.ndarray:
    """JPEG magnitude category = bit length of |v| (0 for v == 0).
    Exact for |v| <= 32767 (category <= 15; the reference panics above —
    categorize.rs:28-33 — which cannot occur for int16 coefficients).

    Computed from the f32 exponent: int->f32 conversion is exact below
    2^24, so the biased exponent of f32(|v|) is exactly
    127 + floor(log2|v|) and the bit length is (bits >> 23) - 126 —
    a handful of elementwise ops instead of a [..., 15] threshold
    broadcast + reduce."""
    a = jnp.abs(v.astype(jnp.int32))
    bits = jax.lax.bitcast_convert_type(a.astype(jnp.float32), jnp.int32)
    return jnp.where(a > 0, (bits >> 23) - 126, 0)


def dc_dpcm(dc: jnp.ndarray, first_predictor: jnp.ndarray | None = None) -> jnp.ndarray:
    """Per-channel DC delta chain along axis 0; predictor starts at 0
    (categorize.rs:156-161). `first_predictor` overrides the predecessor of
    block 0 — the cross-shard DC hand-off hook used by parallel/sharding."""
    prev = jnp.concatenate([jnp.zeros((1,), dc.dtype), dc[:-1]])
    if first_predictor is not None:
        prev = prev.at[0].set(first_predictor.astype(dc.dtype))
    return dc - prev


def ac_symbols_and_structure(
    coeffs_zz: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """AC run/size structure for int16/int32 [N, 64] zigzag blocks.

    Returns (symbols, nonzero_mask, zrl_counts, eob_mask):
      symbols  int32 [N, 63]: (run % 16) << 4 | category, valid where nonzero
      nonzero  bool  [N, 63]
      zrl      int32 [N, 63]: floor(run/16) ZRL emissions before each nonzero
      eob      bool  [N]: block emits an EOB (trailing zeros exist)
    """
    ac = coeffs_zz[:, 1:].astype(jnp.int32)
    n = ac.shape[0]
    pos = jnp.arange(1, 64, dtype=jnp.int32)[None, :]
    nz = ac != 0
    nzpos = jnp.where(nz, pos, 0)
    shifted = jnp.concatenate(
        [jnp.zeros((n, 1), jnp.int32), nzpos[:, :-1]], axis=1
    )
    prev_nz = jax.lax.associative_scan(jnp.maximum, shifted, axis=1)
    run = pos - prev_nz - 1
    zrl = jnp.where(nz, run >> 4, 0)
    cat = magnitude_category(ac)
    symbols = ((run & 15) << 4) | cat
    last_nz = jnp.max(nzpos, axis=1)
    eob = last_nz < 63
    return symbols, nz, zrl, eob


HIST_CHUNK = 1 << 16  # symbols per exact f32 partial sum (< 2^24)


def matmul_histogram(
    symbols: jnp.ndarray, weights: jnp.ndarray, n_bins: int
) -> jnp.ndarray:
    """Weighted histogram as a contraction of nibble one-hots.

    counts[hi, lo] = sum_i w_i * (sym_i>>4 == hi) * (sym_i&15 == lo)
                   = (W*Hhi)^T @ Hlo

    Symbols are split into chunks of HIST_CHUNK; each chunk's counts are
    an f32 sum of at most 2^16 products of 0/1 operands, so they are exact
    (f32 holds every integer below 2^24), and the chunks are summed in
    int32 — exact for any image size. The operands are 0/1, which every
    matmul precision (including TF32 on a GPU) represents exactly, and the
    accumulation is f32, so the default precision cannot round."""
    flat_s = symbols.reshape(-1).astype(jnp.int32)
    flat_w = weights.reshape(-1).astype(jnp.float32)
    m = flat_s.shape[0]
    m_pad = -(-m // HIST_CHUNK) * HIST_CHUNK
    if m_pad != m:
        flat_s = jnp.pad(flat_s, (0, m_pad - m))
        flat_w = jnp.pad(flat_w, (0, m_pad - m))  # zero weight: no count
    flat_s = flat_s.reshape(-1, HIST_CHUNK)
    flat_w = flat_w.reshape(-1, HIST_CHUNK)
    if n_bins <= 16:
        oh = (
            flat_s[..., None] == jnp.arange(n_bins, dtype=jnp.int32)
        ).astype(jnp.float32)
        counts = jnp.einsum(
            "ci,cib->cb", flat_w, oh, preferred_element_type=jnp.float32
        )
        return counts.astype(jnp.int32).sum(axis=0)
    assert n_bins == 256
    bins16 = jnp.arange(16, dtype=jnp.int32)
    h_hi = ((flat_s >> 4)[..., None] == bins16).astype(jnp.float32)
    h_hi = h_hi * flat_w[..., None]
    h_lo = ((flat_s & 15)[..., None] == bins16).astype(jnp.float32)
    counts = jnp.einsum(
        "cih,cil->chl", h_hi, h_lo, preferred_element_type=jnp.float32
    )
    return counts.astype(jnp.int32).sum(axis=0).reshape(256)


# The histogram form the encoder uses. An int32 scatter-add measured
# slower inside the 4K one-dispatch program (7.138 vs 3.853 ms/frame on an
# H100 80GB HBM3 at its 700 W power limit); chip_smoke.py re-times both.
bin_counts = matmul_histogram


def symbol_histograms(
    coeffs_zz: jnp.ndarray,
    block_mask: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(dc_hist[16], ac_hist[256]) int32 for [N, 64] zigzag blocks whose DC
    entries are already DPCM deltas (symbol_counting.rs:55-74 semantics).

    `block_mask` (bool [N]) excludes blocks from the counts — the sharded
    pipeline uses it to ignore alignment-padding blocks that exist only to
    make the MCU-row count divisible by the shard count."""
    weight = (
        jnp.ones((coeffs_zz.shape[0],), jnp.int32)
        if block_mask is None
        else block_mask.astype(jnp.int32)
    )
    dc_cat = magnitude_category(coeffs_zz[:, 0])
    dc_hist = bin_counts(dc_cat, weight.astype(jnp.float32), 16)

    symbols, nz, zrl, eob = ac_symbols_and_structure(coeffs_zz)
    ac_hist = bin_counts(
        symbols,
        (nz & (weight[:, None] > 0)).astype(jnp.float32),
        256,
    )
    ac_hist = ac_hist.at[0xF0].add(jnp.sum(zrl * weight[:, None], dtype=jnp.int32))
    ac_hist = ac_hist.at[0x00].add(
        jnp.sum(eob.astype(jnp.int32) * weight, dtype=jnp.int32)
    )
    return dc_hist, ac_hist


def batched_symbol_histograms(
    coeffs_zz: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per-image histograms for [B, N, 64] blocks -> ([B,16], [B,256])."""
    return jax.vmap(symbol_histograms)(coeffs_zz)

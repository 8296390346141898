"""Huffman table construction ON DEVICE: histogram -> code tables in-jit.

The two-dispatch encode synchronizes mid-image: fetch histograms, build
tables on host (spec.py/package_merge.py/canonical.py), upload code
tables, dispatch the scan packer. This module re-expresses that host tail
as static-shape jnp ops (sorts, 15 unrolled package-merge levels, prefix
sums) so the WHOLE encode — pipeline, tables, scan pack — runs as one jit
program with no host round trip.

Bit-exactness contract: identical tables to the host path —
- stable ascending-frequency sort with ties in symbol order
  (reference: src/...transformer/symbol_counting.rs:92-94),
- package-merge levels with Leaf < Package on equal frequency and
  chunks-of-2 merging (src/huffman/length_limited.rs:63-115),
- the `lengths[0] += 1` all-ones bump (symbol_counting.rs:85-90),
- canonical codeword assignment shortest-first
  (src/huffman/encoder.rs:97-119).
Asserted equal to the host implementation in tests over random and
fixture-derived histograms.

Scale limit: package values are clamped at INF = 2**28, so per-table
symbol totals must stay below ~268M (images up to ~16 gigapixels) for the
tie-breaking to be exact — far beyond any supported frame size.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

LIMIT = 15
NSYM = 256          # histogram width (DC histograms are padded to 256)
LEVEL = 2 * NSYM    # a package-merge level holds <= 2n entries
INF = 1 << 28       # > any real frequency sum; INF+INF clamps back to INF


def device_code_tables_batched(hists: jnp.ndarray):
    """[G, 256] int32 histograms -> per-table code data, all on device.

    All G tables go through ONE stream of batched sorts (lax.sort along
    dimension 1) — the encode needs 4 tables, and 15 package-merge levels
    x 4 separate tiny sorts would be bound by launch overhead.

    Returns dict of:
      sym_by_leaf  i32 [G, 256]: symbols sorted ascending by (freq, symbol)
      len_by_leaf  i32 [G, 256]: code lengths per leaf (0 beyond n_present);
                   leaf 0 = least frequent = longest code (+1 bump applied)
      n_present    i32 [G]  : number of symbols with freq > 0
      codes_flat   i32 [G, 256]: right-aligned codeword per SYMBOL (0 absent)
      lens_flat    i32 [G, 256]: code length per SYMBOL (0 absent)
    """
    g = hists.shape[0]
    syms = jnp.broadcast_to(jnp.arange(NSYM, dtype=jnp.int32), (g, NSYM))
    freq = hists.astype(jnp.int32)
    present = freq > 0
    n = jnp.sum(present.astype(jnp.int32), axis=1)  # [G]

    # stable ascending sort by frequency; absent symbols pushed to the end
    key = jnp.where(present, freq, INF)
    sorted_freq, sorted_sym = jax.lax.sort(
        (key, syms), dimension=1, is_stable=True, num_keys=1
    )
    leaf_rank = jnp.broadcast_to(jnp.arange(NSYM, dtype=jnp.int32), (g, NSYM))
    leaf_valid = leaf_rank < n[:, None]

    # --- package-merge levels (length_limited.rs:63-115) ----------------
    # Entries are (value, kind) with kind 0=Leaf, 1=Package; sort key is
    # value*2 + kind, so Leaf < Package on equal value. INF-padded slots
    # stay at the tail (clamped adds keep INF absorbing).
    leaves_v = jnp.concatenate(
        [jnp.where(leaf_valid, sorted_freq, INF),
         jnp.full((g, LEVEL - NSYM), INF, jnp.int32)], axis=1
    )

    level_v = leaves_v
    level_k = jnp.zeros((g, LEVEL), jnp.int32)
    kinds = [level_k]
    for _ in range(1, LIMIT):
        pair_v = jnp.minimum(
            level_v[:, 0::2] + level_v[:, 1::2], INF
        )  # [G, LEVEL//2] pairwise packages; odd trailing entry pairs INF
        merged_v = jnp.concatenate([pair_v, leaves_v[:, :NSYM]], axis=1)
        merged_k = jnp.concatenate(
            [jnp.ones((g, LEVEL // 2), jnp.int32),
             jnp.zeros((g, NSYM), jnp.int32)], axis=1
        )
        # stable sort on value*2+kind preserves relative order within equal
        # groups, matching python sorted(merged+leaves)
        skey = merged_v * 2 + merged_k
        _, level_v, level_k = jax.lax.sort(
            (skey, merged_v, merged_k), dimension=1, is_stable=True, num_keys=1
        )
        kinds.append(level_k)

    # --- solution walk (length_limited.rs:75-89) ------------------------
    idx = jnp.broadcast_to(jnp.arange(LEVEL, dtype=jnp.int32), (g, LEVEL))
    p = n - 1  # [G] num_packages; n==1 -> 0 -> all lengths stay 0
    len_by_leaf = jnp.zeros((g, NSYM), jnp.int32)
    for level_kind in reversed(kinds):
        taken = idx < 2 * p[:, None]
        leaves_taken = jnp.sum(
            (taken & (level_kind == 0)).astype(jnp.int32), axis=1
        )
        p = jnp.sum(taken.astype(jnp.int32), axis=1) - leaves_taken
        len_by_leaf = len_by_leaf + (
            leaf_rank < leaves_taken[:, None]
        ).astype(jnp.int32)

    # the all-ones bump: longest code (leaf 0) gets +1 when any symbol exists
    len_by_leaf = len_by_leaf.at[:, 0].add(jnp.where(n > 0, 1, 0))
    len_by_leaf = jnp.where(leaf_valid, len_by_leaf, 0)

    # --- canonical codes (encoder.rs:97-119) ----------------------------
    # Walk shortest (leaf n-1) to longest (leaf 0): each step adds
    # 1 << (16 - prev_len) in MSB-aligned space. In leaf order that is a
    # reversed exclusive suffix sum of the per-leaf increments.
    contrib = jnp.where(leaf_valid, 1 << (16 - len_by_leaf), 0)
    cum = jnp.cumsum(contrib, axis=1)
    total = cum[:, NSYM - 1 :]
    pattern = total - cum  # sum over leaves AFTER this one
    bits = jnp.where(
        leaf_valid, pattern >> (16 - len_by_leaf), 0
    )

    rows = jnp.broadcast_to(
        jnp.arange(g, dtype=jnp.int32)[:, None], (g, NSYM)
    )
    codes_flat = jnp.zeros((g, NSYM), jnp.int32).at[rows, sorted_sym].set(
        jnp.where(leaf_valid, bits, 0), mode="drop"
    )
    lens_flat = jnp.zeros((g, NSYM), jnp.int32).at[rows, sorted_sym].set(
        len_by_leaf, mode="drop"
    )
    return {
        "sym_by_leaf": sorted_sym,
        "len_by_leaf": len_by_leaf,
        "n_present": n,
        "codes_flat": codes_flat,
        "lens_flat": lens_flat,
    }


def device_code_tables(hist: jnp.ndarray):
    """[256] int32 histogram -> per-table code data (single-table wrapper
    over the batched build; see device_code_tables_batched)."""
    out = device_code_tables_batched(hist[None])
    return {k: v[0] for k, v in out.items()}


def pad_dc_histogram(dc_hist: jnp.ndarray) -> jnp.ndarray:
    """16-bin DC histogram -> 256-bin (one shared table-build path)."""
    return jnp.concatenate(
        [dc_hist.astype(jnp.int32),
         jnp.zeros((NSYM - dc_hist.shape[0],), jnp.int32)]
    )

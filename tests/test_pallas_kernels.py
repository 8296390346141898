"""Plain-XLA histogram and table-lookup building blocks vs numpy."""

import numpy as np
import jax.numpy as jnp

from dmmt_jpeg_encoder.entropy import categorize


def test_lookup_values_above_f32_int_range_rejected_by_contract():
    """Combined (code<<8|len) words max out at 2^24-1: the packer's single
    u32 gather returns both code and length with room to spare."""
    from dmmt_jpeg_encoder.bitstream.device_pack import combine_tables

    codes = np.full(256, 0xFFFF, np.uint32)
    lens = np.full(256, 16, np.uint32)
    comb = combine_tables(codes, lens)
    assert int(comb.max()) < (1 << 24)


def test_matmul_histogram_matches_scatter(rng):
    syms = rng.integers(0, 256, 40_000).astype(np.int32)
    w = (rng.random(40_000) < 0.8).astype(np.float32)
    got = np.asarray(
        categorize.bin_counts(jnp.asarray(syms), jnp.asarray(w), 256)
    )
    want = np.zeros(256, np.int64)
    np.add.at(want, syms, w.astype(np.int64))
    np.testing.assert_array_equal(got, want)
    # 16-bin path
    syms16 = rng.integers(0, 16, 9_000).astype(np.int32)
    got16 = np.asarray(
        categorize.bin_counts(
            jnp.asarray(syms16), jnp.ones(9_000, np.float32), 16
        )
    )
    want16 = np.bincount(syms16, minlength=16)
    np.testing.assert_array_equal(got16, want16)


def test_histogram_chunks_sum_exactly(rng, monkeypatch):
    """matmul_histogram sums per-chunk f32 counts in int32: with a tiny
    chunk the split (and the zero-weight padding of the last chunk) must
    not change a count."""
    monkeypatch.setattr(categorize, "HIST_CHUNK", 64)
    syms = rng.integers(0, 256, 1_001).astype(np.int32)
    w = (rng.random(1_001) < 0.6).astype(np.float32)
    got = np.asarray(
        categorize.matmul_histogram(jnp.asarray(syms), jnp.asarray(w), 256)
    )
    want = np.zeros(256, np.int64)
    np.add.at(want, syms, w.astype(np.int64))
    np.testing.assert_array_equal(got, want)

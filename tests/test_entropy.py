"""Entropy-stage tests: magnitude category, DC DPCM, AC structure,
histograms (reference behavior: categorize.rs, symbol_counting.rs)."""

import numpy as np
import jax.numpy as jnp

from dmmt_jpeg_encoder.entropy.categorize import (
    ac_symbols_and_structure,
    dc_dpcm,
    magnitude_category,
    symbol_histograms,
)


def test_magnitude_category_goldens():
    # (value, category) per the JPEG magnitude table (categorize.rs:21-43)
    cases = [
        (0, 0), (1, 1), (-1, 1), (2, 2), (3, 2), (-3, 2), (4, 3), (7, 3),
        (8, 4), (15, 4), (16, 5), (255, 8), (-255, 8), (256, 9),
        (1023, 10), (2047, 11), (4095, 12), (16383, 14), (32767, 15),
    ]
    vals = jnp.asarray([v for v, _ in cases], dtype=jnp.int32)
    out = np.asarray(magnitude_category(vals))
    np.testing.assert_array_equal(out, [c for _, c in cases])


def test_dc_dpcm_chain():
    dc = jnp.asarray([5, 7, 7, 3, -2], dtype=jnp.int16)
    out = np.asarray(dc_dpcm(dc))
    np.testing.assert_array_equal(out, [5, 2, 0, -4, -5])


def test_dc_dpcm_with_predictor():
    dc = jnp.asarray([5, 7], dtype=jnp.int16)
    out = np.asarray(dc_dpcm(dc, first_predictor=jnp.int16(10)))
    np.testing.assert_array_equal(out, [-5, 2])


def _brute_force_ac_symbols(block):
    """Reference AC RLE semantics (categorize.rs:132-151) in plain Python."""
    syms = []
    run = 0
    for k in range(1, 64):
        a = int(block[k])
        if a == 0:
            run += 1
            continue
        while run > 15:
            syms.append(0xF0)
            run -= 16
        cat = abs(a).bit_length()
        syms.append((run << 4) | cat)
        run = 0
    if run:
        syms.append(0x00)
    return syms


def test_ac_structure_matches_brute_force(rng):
    blocks = np.zeros((64, 64), dtype=np.int16)
    # sparse-ish blocks with long runs to exercise ZRL and EOB
    mask = rng.random((64, 64)) < 0.08
    blocks[mask] = rng.integers(-300, 300, mask.sum())
    blocks[:, 0] = rng.integers(-100, 100, 64)  # DC ignored by AC pass
    blocks[5] = 0  # all-zero AC -> single EOB
    blocks[6, 63] = 4  # nonzero at the last position -> no EOB

    symbols, nz, zrl, eob = (
        np.asarray(a) for a in ac_symbols_and_structure(jnp.asarray(blocks))
    )
    for i in range(64):
        got = []
        for k in range(63):
            if nz[i, k]:
                got.extend([0xF0] * int(zrl[i, k]))
                got.append(int(symbols[i, k]))
        if eob[i]:
            got.append(0x00)
        assert got == _brute_force_ac_symbols(blocks[i]), f"block {i}"


def test_histograms_match_brute_force(rng):
    blocks = np.zeros((32, 64), dtype=np.int16)
    mask = rng.random((32, 64)) < 0.1
    blocks[mask] = rng.integers(-2000, 2000, mask.sum())
    dc_hist, ac_hist = (
        np.asarray(a) for a in symbol_histograms(jnp.asarray(blocks))
    )

    exp_dc = np.zeros(16, np.int64)
    exp_ac = np.zeros(256, np.int64)
    for b in blocks:
        exp_dc[abs(int(b[0])).bit_length()] += 1
        for s in _brute_force_ac_symbols(b):
            exp_ac[s] += 1
    np.testing.assert_array_equal(dc_hist, exp_dc)
    np.testing.assert_array_equal(ac_hist, exp_ac)
    assert dc_hist.sum() == 32  # one DC symbol per block

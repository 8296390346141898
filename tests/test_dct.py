"""DCT variant cross-checks (reference test strategy: simple.rs:143-155,
separated.rs:140-152, arai.rs:117-218 — round trips and cross-variant
agreement)."""

import numpy as np
import jax.numpy as jnp
import pytest

from dmmt_jpeg_encoder.config import DCTVariant
from dmmt_jpeg_encoder.ops.dct import dct2d, dct_matrix, idct2d


def _blocks(rng, n=16, scale=128.0):
    return jnp.asarray(
        rng.uniform(-scale, scale, (n, 8, 8)).astype(np.float32)
    )


def test_dct_matrix_orthonormal():
    c = dct_matrix().astype(np.float64)
    np.testing.assert_allclose(c @ c.T, np.eye(8), atol=1e-6)


def test_constant_block_is_pure_dc():
    blocks = jnp.full((1, 8, 8), 64.0, dtype=jnp.float32)
    for variant in DCTVariant.SIMPLE, DCTVariant.SEPARATED, DCTVariant.ARAI:
        out = np.asarray(dct2d(blocks, variant))
        # DC = 8 * mean = 64 * 8 = 512 (orthonormal scaling)
        np.testing.assert_allclose(out[0, 0, 0], 512.0, atol=1e-2)
        ac = out.reshape(-1)[1:]
        np.testing.assert_allclose(ac, 0.0, atol=1e-2)


@pytest.mark.parametrize("variant", [DCTVariant.SEPARATED, DCTVariant.ARAI])
def test_variants_match_simple(rng, variant):
    blocks = _blocks(rng)
    ref = np.asarray(dct2d(blocks, DCTVariant.SIMPLE))
    out = np.asarray(dct2d(blocks, variant))
    np.testing.assert_allclose(out, ref, atol=2e-3)


@pytest.mark.parametrize(
    "variant", [DCTVariant.SIMPLE, DCTVariant.SEPARATED, DCTVariant.ARAI]
)
def test_idct_round_trip(rng, variant):
    blocks = _blocks(rng)
    coeffs = dct2d(blocks, variant)
    back = np.asarray(idct2d(coeffs))
    np.testing.assert_allclose(back, np.asarray(blocks), atol=2e-3)


def test_arai_single_nonzero_impulse():
    # Impulse response cross-checked against the orthonormal basis directly.
    x = np.zeros((1, 8, 8), dtype=np.float32)
    x[0, 3, 5] = 100.0
    out = np.asarray(dct2d(jnp.asarray(x), DCTVariant.ARAI))
    c = dct_matrix().astype(np.float64)
    expected = np.einsum("un,vm,nm->uv", c, c, x[0].astype(np.float64))
    np.testing.assert_allclose(out[0], expected, atol=2e-3)


def test_parseval_energy_preserved(rng):
    blocks = _blocks(rng, n=4)
    out = np.asarray(dct2d(blocks, DCTVariant.ARAI))
    for i in range(4):
        np.testing.assert_allclose(
            (out[i] ** 2).sum(),
            (np.asarray(blocks)[i] ** 2).sum(),
            rtol=1e-4,
        )


def test_plane_modes_bit_identical(monkeypatch):
    """All DMMT_P1 layout strategies must produce identical zigzag blocks."""
    import numpy as np
    from dmmt_jpeg_encoder.config import ChromaSubsamplingPreset, DCTVariant
    from dmmt_jpeg_encoder import pipeline as pl
    from dmmt_jpeg_encoder.ops.geometry import entangle_permutation
    from dmmt_jpeg_encoder.tables import quantization_table_pair
    from dmmt_jpeg_encoder.config import QuantizationTablePreset

    rng = np.random.default_rng(3)
    h, w = 64, 96
    y = jnp.asarray(rng.normal(0, 60, (h, w)).astype(np.float32))
    cb = jnp.asarray(rng.normal(0, 30, (h, w)).astype(np.float32))
    cr = jnp.asarray(rng.normal(0, 30, (h, w)).astype(np.float32))
    lq, cq = quantization_table_pair(QuantizationTablePreset.SPECIFICATION)
    outs = {}
    for preset in ChromaSubsamplingPreset:
        ent = entangle_permutation(w // 8, h // 8, preset)
        for mode in ("block", "plane", "plane_mm", "plane2"):
            monkeypatch.setenv("DMMT_P1", mode)
            outs[mode] = [
                np.asarray(x)
                for x in pl.encode_blocks_from_planes(
                    y, cb, cr, jnp.asarray(lq), jnp.asarray(cq),
                    preset, DCTVariant.ARAI, ent,
                )
            ]
        for mode in ("plane", "plane_mm", "plane2"):
            for got, want in zip(outs[mode], outs["block"]):
                np.testing.assert_array_equal(got, want)

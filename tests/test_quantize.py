"""Quantization + zigzag tests (reference behavior: quantizer.rs:53-63,
frequency_block.rs:1-61, quantization_tables.rs)."""

import numpy as np
import jax.numpy as jnp

from dmmt_jpeg_encoder.config import QuantizationTablePreset
from dmmt_jpeg_encoder.ops.quantize import (
    quantize_zigzag,
    round_half_away_from_zero,
)
from dmmt_jpeg_encoder.tables import (
    INVERSE_ZIGZAG,
    ZIGZAG,
    quantization_table_pair,
)


def test_round_half_away_from_zero():
    x = jnp.asarray([-2.5, -1.5, -0.5, -0.4, 0.0, 0.4, 0.5, 1.5, 2.5])
    out = np.asarray(round_half_away_from_zero(x))
    # Rust f32::round semantics, NOT banker's rounding
    np.testing.assert_array_equal(out, [-3, -2, -1, 0, 0, 0, 1, 2, 3])


def test_zigzag_is_permutation():
    assert sorted(ZIGZAG.tolist()) == list(range(64))
    np.testing.assert_array_equal(ZIGZAG[INVERSE_ZIGZAG], np.arange(64))


def test_zigzag_golden_prefix():
    # First 10 entries of the standard JPEG zigzag scan
    assert ZIGZAG[:10].tolist() == [0, 1, 8, 16, 9, 2, 3, 10, 17, 24]
    assert ZIGZAG[-3:].tolist() == [55, 62, 63]


def test_quantize_divides_and_rounds():
    coeffs = jnp.zeros((1, 8, 8), dtype=jnp.float32)
    coeffs = coeffs.at[0, 0, 0].set(100.0)   # raster 0, table entry 16
    coeffs = coeffs.at[0, 0, 1].set(-17.0)   # raster 1, table entry 11
    luma, _ = quantization_table_pair(QuantizationTablePreset.SPECIFICATION)
    out = np.asarray(quantize_zigzag(coeffs, jnp.asarray(luma)))
    assert out.dtype == np.int16
    assert out[0, 0] == round(100 / 16)  # 6
    # raster 1 lands at zigzag position 1; -17/11 = -1.545 -> -2
    assert out[0, 1] == -2


def test_quantize_output_in_zigzag_order():
    # A coefficient at raster (1, 0) = index 8 must land at zigzag pos 2.
    coeffs = jnp.zeros((1, 8, 8), dtype=jnp.float32).at[0, 1, 0].set(120.0)
    flat_table = jnp.ones((64,), dtype=jnp.uint8)
    out = np.asarray(quantize_zigzag(coeffs, flat_table))
    assert out[0, 2] == 120
    assert np.count_nonzero(out) == 1


def test_all_presets_have_valid_pairs():
    for preset in QuantizationTablePreset:
        luma, chroma = quantization_table_pair(preset)
        for t in (luma, chroma):
            assert t.shape == (64,)
            assert t.dtype == np.uint8
            assert int(t.min()) >= 1


def test_specification_preset_annex_k_values():
    luma, chroma = quantization_table_pair(QuantizationTablePreset.SPECIFICATION)
    assert luma[0] == 16 and luma[1] == 11 and luma[63] == 99
    assert chroma[0] == 17 and chroma[63] == 99


def test_flat_preset():
    luma, chroma = quantization_table_pair(QuantizationTablePreset.FLAT)
    assert set(luma.tolist()) == {16}
    assert set(chroma.tolist()) == {16}

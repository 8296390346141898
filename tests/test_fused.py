"""Fused DCT+quantize+zigzag (Kronecker matmul form) tests."""

import numpy as np
import jax.numpy as jnp
import pytest

from dmmt_jpeg_encoder import (
    ChromaSubsamplingPreset,
    DCTVariant,
    EncoderConfig,
    encode_array,
)
from dmmt_jpeg_encoder.config import QuantizationTablePreset
from dmmt_jpeg_encoder.ops.dct import dct2d
from dmmt_jpeg_encoder.ops.fused import fused_dct_quantize_zigzag, fused_matrix
from dmmt_jpeg_encoder.ops.quantize import quantize_zigzag
from dmmt_jpeg_encoder.tables import quantization_table_pair


def _blocks(rng, n=64):
    return jnp.asarray(rng.uniform(-128, 128, (n, 8, 8)).astype(np.float32))


def test_fused_matrix_is_dct_times_invq():
    luma_q, _ = quantization_table_pair(QuantizationTablePreset.SPECIFICATION)
    m = np.asarray(fused_matrix(jnp.asarray(luma_q)))
    assert m.shape == (64, 64)
    # Column 0 is the DC basis / q[0]: constant 1/8 / 16
    np.testing.assert_allclose(m[:, 0], (1.0 / 8.0) / 16.0, rtol=1e-5)


@pytest.mark.parametrize("preset", [QuantizationTablePreset.SPECIFICATION,
                                    QuantizationTablePreset.FLAT])
def test_fused_matches_separated_quantize(rng, preset):
    """The fused matmul must agree with dct2d + quantize_zigzag everywhere
    except at exact rounding boundaries (different f32 summation order)."""
    blocks = _blocks(rng, 128)
    luma_q, _ = quantization_table_pair(preset)
    q = jnp.asarray(luma_q)
    a = np.asarray(fused_dct_quantize_zigzag(blocks, q))
    b = np.asarray(quantize_zigzag(dct2d(blocks, DCTVariant.SEPARATED), q))
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    # tolerate off-by-one on <0.5% of coefficients (rounding-boundary ties)
    assert diff.max() <= 1
    assert (diff != 0).mean() < 0.005


def test_e2e_fused_variant_decodes(rng):
    from io import BytesIO

    from PIL import Image

    pixels = rng.integers(0, 256, (48, 64, 3), dtype=np.uint16)
    jpg = encode_array(
        pixels, 255,
        EncoderConfig(
            dct_variant=DCTVariant.FUSED,
            chroma_subsampling=ChromaSubsamplingPreset.P420,
        ),
    )
    im = Image.open(BytesIO(jpg))
    assert im.size == (64, 48)
    base = encode_array(pixels, 255, EncoderConfig())
    dec_f = np.asarray(im.convert("RGB")).astype(np.float64)
    dec_b = np.asarray(
        Image.open(BytesIO(base)).convert("RGB")
    ).astype(np.float64)
    # Same pipeline up to DCT numerics: decoded outputs nearly identical
    assert np.abs(dec_f - dec_b).mean() < 1.0

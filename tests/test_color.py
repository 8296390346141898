"""RGB->YCbCr conversion goldens (reference behavior: src/color.rs:75-100).

The conversion folds the JPEG -128 level shift into luma and keeps chroma
signed (no +128), so: white -> (127, 0, 0)-ish, black -> (-128, 0, 0).
"""

import numpy as np
import jax.numpy as jnp

from dmmt_jpeg_encoder.ops.color import rgb_to_ycbcr


def _convert_one(r, g, b):
    y, cb, cr = rgb_to_ycbcr(jnp.asarray([[[r, g, b]]], dtype=jnp.float32))
    return float(y[0, 0]), float(cb[0, 0]), float(cr[0, 0])


def test_black():
    y, cb, cr = _convert_one(0.0, 0.0, 0.0)
    assert y == -128.0
    assert cb == 0.0
    assert cr == 0.0


def test_white():
    y, cb, cr = _convert_one(1.0, 1.0, 1.0)
    # (0.299 + 0.587 + 0.114 - 128/255) * 255 = 127.0 up to f32 rounding.
    # The reference's chroma weights (src/color.rs:85-99) sum to +1e-4, not
    # 0 (-0.1687 - 0.3312 + 0.5), leaving a ~0.0255 bias we reproduce.
    np.testing.assert_allclose(y, 127.0, atol=1e-3)
    np.testing.assert_allclose(cb, 0.0255, atol=1e-3)
    np.testing.assert_allclose(cr, 0.0255, atol=1e-3)


def test_pure_red():
    y, cb, cr = _convert_one(1.0, 0.0, 0.0)
    np.testing.assert_allclose(y, (0.299 - 128 / 255) * 255, atol=1e-3)
    np.testing.assert_allclose(cb, -0.1687 * 255, atol=1e-3)
    np.testing.assert_allclose(cr, 0.5 * 255, atol=1e-3)


def test_pure_blue():
    y, cb, cr = _convert_one(0.0, 0.0, 1.0)
    np.testing.assert_allclose(y, (0.114 - 128 / 255) * 255, atol=1e-3)
    np.testing.assert_allclose(cb, 0.5 * 255, atol=1e-3)
    np.testing.assert_allclose(cr, -0.0813 * 255, atol=1e-3)


def test_mid_gray():
    y, cb, cr = _convert_one(128 / 255, 128 / 255, 128 / 255)
    np.testing.assert_allclose(y, 0.0, atol=1e-3)
    # half the white bias (see test_white)
    np.testing.assert_allclose(cb, 0.0128, atol=1e-3)
    np.testing.assert_allclose(cr, 0.0128, atol=1e-3)


def test_luma_range_bounds(rng):
    rgb = rng.random((32, 32, 3), dtype=np.float32)
    y, cb, cr = rgb_to_ycbcr(jnp.asarray(rgb))
    assert float(jnp.min(y)) >= -128.0 - 1e-3
    assert float(jnp.max(y)) <= 127.0 + 1e-3
    assert float(jnp.max(jnp.abs(cb))) <= 127.5 + 1e-3
    assert float(jnp.max(jnp.abs(cr))) <= 127.5 + 1e-3

"""RGB -> YCbCr color conversion (device).

Numerical contract matches the reference conversion exactly, including the
fold of the JPEG -128 level shift into the luma weights and the signed
convention for chroma (no +128 offset; carried signed through the DCT),
reference: src/color.rs:75-100.

    luma = (0.299 r + 0.587 g + 0.114 b - 128/255) * 255   in [-128, 127]
    cb   = (-0.1687 r - 0.3312 g + 0.5 b) * 255
    cr   = (0.5 r - 0.4186 g - 0.0813 b) * 255

The adds are kept in the reference's left-to-right order so f32 results are
reproducible against it (parity matters only at quantization rounding
boundaries; see SURVEY.md hard part 4).
"""

from __future__ import annotations

import jax.numpy as jnp

from .fp import mul

_LEVEL_SHIFT = 128.0 / 255.0


def rgb_to_ycbcr(rgb: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """rgb: f32 [..., 3] normalized to 0..1 -> (y, cb, cr) each f32 [...]."""
    return rgb_to_ycbcr_planes(rgb[..., 0], rgb[..., 1], rgb[..., 2])


def rgb_to_ycbcr_planes(
    r: jnp.ndarray, g: jnp.ndarray, b: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Channel-planar form (same f32 op order)."""
    y = mul(mul(r, 0.299) + mul(g, 0.587) + mul(b, 0.114) - _LEVEL_SHIFT, 255.0)
    cb = mul(mul(r, -0.1687) + mul(g, -0.3312) + mul(b, 0.5), 255.0)
    cr = mul(mul(r, 0.5) + mul(g, -0.4186) + mul(b, -0.0813), 255.0)
    return y, cb, cr

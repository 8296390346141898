"""Device compute ops: color conversion, geometry, DCT, quantization.

All functions here are pure jax.numpy transforms with static shapes so the
whole encode pipeline traces into a single XLA program (and shard_maps over
a device mesh unchanged).
"""

from .color import rgb_to_ycbcr
from .geometry import (
    blockize,
    entangle_permutation,
    pad_to_mcu_multiple,
    padded_size,
    subsample,
)
from .dct import dct2d, dct_matrix, idct2d
from .quantize import quantize_zigzag

__all__ = [
    "rgb_to_ycbcr",
    "blockize",
    "entangle_permutation",
    "pad_to_mcu_multiple",
    "padded_size",
    "subsample",
    "dct2d",
    "dct_matrix",
    "idct2d",
    "quantize_zigzag",
]

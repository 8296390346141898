"""dmmt_jpeg_encoder — a baseline JPEG encoder framework on JAX.

A from-scratch JAX/XLA re-design (not a port) of the capabilities of
the Rust reference encoder `SilverlightningY/dmmt-jpeg-encoder`:
P3 PPM -> baseline sequential JFIF/JPEG with 4:4:4/4:2:2/4:2:0 chroma
subsampling, per-image optimal length-limited Huffman tables, and seven
quantization-table presets.

Architecture: one jit-compiled device program (color convert, subsample,
MCU-ordered blockize, batched 8x8 DCT, quantize+zigzag, DC DPCM, symbol
histograms) + a native-C host tail for the serial bitstream emission, and a
shard_map/psum/ppermute multi-chip path (parallel.sharding).
"""

from .config import (
    ChromaSubsamplingPreset,
    DCTVariant,
    EncoderConfig,
    QuantizationTablePreset,
    SubsamplingMethod,
)
from .encoder import (
    HuffmanTables,
    convert_ppm_to_jpeg,
    encode_array,
    encode_batch,
    encode_ppm_bytes,
    encode_ppm_image,
)
from .io.ppm import PPMImage, read_ppm, read_ppm_bytes, write_ppm

__version__ = "0.1.0"

__all__ = [
    "ChromaSubsamplingPreset",
    "DCTVariant",
    "EncoderConfig",
    "QuantizationTablePreset",
    "SubsamplingMethod",
    "HuffmanTables",
    "convert_ppm_to_jpeg",
    "encode_array",
    "encode_batch",
    "encode_ppm_bytes",
    "encode_ppm_image",
    "PPMImage",
    "read_ppm",
    "read_ppm_bytes",
    "write_ppm",
    "__version__",
]

"""The in-house debug decoder as an independent round-trip oracle."""

import numpy as np
import pytest

from dmmt_jpeg_encoder import (
    ChromaSubsamplingPreset,
    EncoderConfig,
    QuantizationTablePreset,
    encode_array,
)
from dmmt_jpeg_encoder.debug.jpeg_decoder import decode_jpeg, parse_jpeg


def _psnr(a, b):
    mse = ((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean()
    return float("inf") if mse == 0 else 10 * np.log10(255**2 / mse)


def _gradient(h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack(
        [
            xx * 255 // max(w - 1, 1),
            yy * 255 // max(h - 1, 1),
            (xx + yy) * 255 // (w + h - 2),
        ],
        axis=-1,
    ).astype(np.uint16)


def test_parse_segment_structure(rng):
    jpg = encode_array(_gradient(32, 48))
    p = parse_jpeg(jpg)
    names = [s[0] for s in p.segments]
    # exactly the reference's segment order (encoder.rs:125-135)
    assert names == [
        "SOI", "APP0", "DQT", "DQT", "SOF0",
        "DHT", "DHT", "DHT", "DHT", "SOS", "EOI",
    ]
    assert (p.width, p.height) == (48, 32)
    assert sorted(p.quant.keys()) == [0, 1]
    # the reference's table ids: luma DC=0/AC=1, chroma DC=2/AC=3
    # (encoder.rs:78-89)
    assert sorted(p.huffman.keys()) == [(0, 0), (0, 2), (1, 1), (1, 3)]
    assert p.quant[0][0] == 16  # Annex K luma DC step


@pytest.mark.parametrize("preset", list(ChromaSubsamplingPreset))
def test_roundtrip_all_presets(preset):
    px = _gradient(40, 56)
    jpg = encode_array(px, 255, EncoderConfig(chroma_subsampling=preset))
    dec = decode_jpeg(jpg)
    assert dec.shape == (40, 56, 3)
    val = _psnr(dec, px)
    assert val > 28, f"{preset}: {val:.1f} dB"


def test_matches_pil():
    PIL = pytest.importorskip("PIL.Image")
    from io import BytesIO

    px = _gradient(24, 40)
    jpg = encode_array(px, 255, EncoderConfig())
    ours = decode_jpeg(jpg).astype(np.float64)
    pil = np.asarray(
        PIL.open(BytesIO(jpg)).convert("RGB")
    ).astype(np.float64)
    # PIL/libjpeg applies fancy (triangular) chroma upsampling vs our
    # nearest; smooth content must still agree closely
    assert np.abs(ours - pil).mean() < 3.0


def test_flat_tables_near_lossless():
    px = _gradient(16, 16)
    jpg = encode_array(
        px, 255,
        EncoderConfig(
            chroma_subsampling=ChromaSubsamplingPreset.P444,
            quantization_preset=QuantizationTablePreset.FLAT,
        ),
    )
    assert _psnr(decode_jpeg(jpg), px) > 35

"""Parity odds and ends: logging, precision field, deep PPM range,
error paths, config combinations."""

import logging

import numpy as np
import pytest

from dmmt_jpeg_encoder import (
    ChromaSubsamplingPreset,
    DCTVariant,
    EncoderConfig,
    QuantizationTablePreset,
    encode_array,
    read_ppm_bytes,
)
from dmmt_jpeg_encoder.bitstream.packer import encode_scan
from dmmt_jpeg_encoder.container import segment
from dmmt_jpeg_encoder.debug.jpeg_decoder import parse_jpeg
from dmmt_jpeg_encoder.errors import HuffmanSymbolMissing, SegmentTooLong


def _gradient(h, w, maxval=255):
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack(
        [
            xx * maxval // max(w - 1, 1),
            yy * maxval // max(h - 1, 1),
            (xx + yy) * maxval // (w + h - 2),
        ],
        axis=-1,
    ).astype(np.uint16)


def test_segment_hexdump_logging(caplog):
    """The reference hexdumps every segment (src/logger.rs:7-17); ours logs
    through the stdlib logger when enabled."""
    logger = logging.getLogger("dmmt_jpeg_encoder")
    with caplog.at_level(logging.INFO, logger="dmmt_jpeg_encoder"):
        logger.setLevel(logging.INFO)
        encode_array(_gradient(8, 8))
    records = [r.message for r in caplog.records]
    assert any("FF, E0" in m for m in records), "APP0 hexdump missing"
    assert any("FF, DA" in m for m in records), "SOS hexdump missing"


@pytest.mark.parametrize("bits", [8, 16, 32])
def test_bits_per_channel_in_sof(bits):
    jpg = encode_array(_gradient(8, 8), 255, EncoderConfig(bits_per_channel=bits))
    p = parse_jpeg(jpg)
    assert p.precision == bits


def test_invalid_bits_per_channel_rejected():
    with pytest.raises(ValueError):
        EncoderConfig(bits_per_channel=12)


def test_16bit_maxval_ppm_end_to_end():
    """PPM maxval up to 65535 (u16) is legal; samples normalize by maxval."""
    body = " ".join(
        str(v)
        for px in [(0, 0, 0), (65535, 65535, 65535), (32768, 0, 65535), (100, 200, 300)]
        for v in px
    )
    img = read_ppm_bytes(f"P3\n2 2\n65535\n{body}\n".encode())
    assert img.maxval == 65535
    jpg = encode_array(img.pixels, img.maxval)
    assert jpg[:2] == b"\xff\xd8"


def test_segment_too_long_rejected():
    with pytest.raises(SegmentTooLong):
        segment(b"\xff\xdb", bytes(70000))


def test_missing_codeword_raises_in_host_packer():
    blocks = np.zeros((1, 64), dtype=np.int16)
    blocks[0, 0] = 100  # DC category 7
    empty_dc = ([0] * 256, [0] * 256)
    some_ac = ([0] * 256, [1] * 256)
    with pytest.raises(HuffmanSymbolMissing):
        encode_scan(blocks, None, None, 1, empty_dc, some_ac, None, None,
                    use_native=False)


@pytest.mark.parametrize("variant", list(DCTVariant))
@pytest.mark.parametrize("preset", [ChromaSubsamplingPreset.P420,
                                    ChromaSubsamplingPreset.P444])
def test_all_dct_variants_produce_decodable_output(variant, preset):
    from io import BytesIO

    PIL = pytest.importorskip("PIL.Image")
    px = _gradient(24, 32)
    jpg = encode_array(
        px, 255,
        EncoderConfig(dct_variant=variant, chroma_subsampling=preset),
    )
    im = PIL.open(BytesIO(jpg))
    dec = np.asarray(im.convert("RGB")).astype(np.float64)
    mse = ((dec - px) ** 2).mean()
    assert 10 * np.log10(255**2 / mse) > 28, variant


def test_quant_preset_with_fused_variant_interacts():
    """The fused kernel folds 1/q into the matrix; every preset must work."""
    px = _gradient(16, 16)
    for qt in (QuantizationTablePreset.FLAT, QuantizationTablePreset.MSSIM_KODAK_TUNED):
        jpg = encode_array(
            px, 255,
            EncoderConfig(dct_variant=DCTVariant.FUSED, quantization_preset=qt),
        )
        assert jpg[:2] == b"\xff\xd8" and jpg[-2:] == b"\xff\xd9"


def test_shards_plus_fused_variant(rng):
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    px = rng.integers(0, 256, (64, 32, 3), dtype=np.uint16)
    a = encode_array(px, 255, EncoderConfig(dct_variant=DCTVariant.FUSED))
    b = encode_array(
        px, 255, EncoderConfig(dct_variant=DCTVariant.FUSED, num_shards=4)
    )
    assert a == b

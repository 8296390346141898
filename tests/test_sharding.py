"""Multi-chip encode tests on the virtual 8-device CPU mesh.

Verifies the shard_map path (psum'd histograms + ppermute DC hand-off +
alignment-padding masking) produces BYTE-IDENTICAL JPEGs to the single-chip
pipeline for divisible and non-divisible MCU-row counts."""

import numpy as np
import jax
import pytest

from dmmt_jpeg_encoder import (
    ChromaSubsamplingPreset,
    EncoderConfig,
    encode_array,
)
from dmmt_jpeg_encoder.parallel.sharding import (
    _shard_geometry,
    run_sharded_pipeline,
)
from dmmt_jpeg_encoder.pipeline import run_device_pipeline
from dmmt_jpeg_encoder.tables import quantization_table_pair
from dmmt_jpeg_encoder.config import QuantizationTablePreset


needs_8 = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)


def _random_pixels(rng, h, w):
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint16)


def test_shard_geometry():
    P420 = ChromaSubsamplingPreset.P420
    # 128 rows = 8 MCU rows: divisible by 8
    assert _shard_geometry(128, 32, P420, 8) == (128, 32, 1, 8)
    # 500 rows -> padded 512 = 32 MCU rows / 8 shards = 4 each
    assert _shard_geometry(500, 500, P420, 8) == (512, 512, 4, 32)
    # 48 rows = 3 MCU rows over 8 shards -> 1 row/shard, 5 shards padding
    assert _shard_geometry(48, 32, P420, 8) == (128, 32, 1, 3)


@needs_8
@pytest.mark.parametrize("preset", list(ChromaSubsamplingPreset))
def test_sharded_matches_single_chip_divisible(rng, preset):
    # 8 MCU rows exactly: every shard gets one full MCU row
    h = 8 * preset.mcu_height
    pixels = _random_pixels(rng, h, 40)
    cfg1 = EncoderConfig(chroma_subsampling=preset)
    cfg8 = EncoderConfig(chroma_subsampling=preset, num_shards=8)
    assert encode_array(pixels, 255, cfg8) == encode_array(pixels, 255, cfg1)


@needs_8
@pytest.mark.parametrize("preset", list(ChromaSubsamplingPreset))
def test_sharded_matches_single_chip_non_divisible(rng, preset):
    # 3 MCU rows over 8 shards: alignment padding + fully-padded shards
    h = 3 * preset.mcu_height
    pixels = _random_pixels(rng, h, 24)
    cfg1 = EncoderConfig(chroma_subsampling=preset)
    cfg8 = EncoderConfig(chroma_subsampling=preset, num_shards=8)
    assert encode_array(pixels, 255, cfg8) == encode_array(pixels, 255, cfg1)


@needs_8
def test_sharded_matches_odd_image_size(rng):
    pixels = _random_pixels(rng, 100, 30)  # pads to 112x32 under P420
    cfg1 = EncoderConfig()
    cfg8 = EncoderConfig(num_shards=8)
    assert encode_array(pixels, 255, cfg8) == encode_array(pixels, 255, cfg1)


@needs_8
def test_sharded_device_result_fields(rng):
    pixels = _random_pixels(rng, 64, 32)
    cfg = EncoderConfig(num_shards=8)
    luma_q, chroma_q = quantization_table_pair(QuantizationTablePreset.SPECIFICATION)
    sharded = run_sharded_pipeline(pixels, 255, cfg)
    single = run_device_pipeline(
        pixels, 255, EncoderConfig(), luma_q, chroma_q
    )
    np.testing.assert_array_equal(sharded.luma, single.luma)
    np.testing.assert_array_equal(sharded.cb, single.cb)
    np.testing.assert_array_equal(sharded.cr, single.cr)
    np.testing.assert_array_equal(sharded.luma_dc_hist, single.luma_dc_hist)
    np.testing.assert_array_equal(sharded.luma_ac_hist, single.luma_ac_hist)
    np.testing.assert_array_equal(sharded.chroma_dc_hist, single.chroma_dc_hist)
    np.testing.assert_array_equal(sharded.chroma_ac_hist, single.chroma_ac_hist)


@needs_8
def test_two_and_four_shards(rng):
    pixels = _random_pixels(rng, 64, 16)
    base = encode_array(pixels, 255, EncoderConfig())
    for n in (2, 4):
        assert encode_array(pixels, 255, EncoderConfig(num_shards=n)) == base

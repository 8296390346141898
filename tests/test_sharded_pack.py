"""Per-shard device packing + host bit-merge vs the single-device bytes.

The two-dispatch per-shard pack (host tables, one_dispatch="off") and the
one-dispatch sharded program (device tables + pack in one jit) are both
covered."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from dmmt_jpeg_encoder import ChromaSubsamplingPreset, EncoderConfig, encode_array
from dmmt_jpeg_encoder.parallel.sharding import merge_bit_streams

needs_8 = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)


def test_merge_bit_streams_aligned():
    a = (np.array([0xAB, 0xCD], np.uint8), 16)
    b = (np.array([0x12], np.uint8), 8)
    out, bits = merge_bit_streams([a, b])
    assert bits == 24
    assert out.tolist() == [0xAB, 0xCD, 0x12]


def test_merge_bit_streams_unaligned():
    # 4 bits of 0b1010 then 8 bits 0xFF then 3 bits 0b011
    a = (np.array([0b10100000], np.uint8), 4)
    b = (np.array([0xFF], np.uint8), 8)
    c = (np.array([0b01100000], np.uint8), 3)
    out, bits = merge_bit_streams([a, b, c])
    assert bits == 15
    # 1010 11111111 011 0 -> bytes 10101111 1111011 0
    assert out.tolist() == [0b10101111, 0b11110110]


def test_merge_bit_streams_empty_chunks():
    a = (np.array([], np.uint8), 0)
    b = (np.array([0x80], np.uint8), 1)
    out, bits = merge_bit_streams([a, b, a])
    assert bits == 1
    assert out.tolist() == [0x80]


def _px(rng, h, w):
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint16)


@needs_8
@pytest.mark.parametrize("preset", list(ChromaSubsamplingPreset))
def test_sharded_device_pack_matches_single_chip(rng, preset):
    """scan_backend='device' on an 8-shard mesh (two-dispatch: packing per
    shard, merging segments on host) must produce the single-chip bytes
    exactly."""
    h = 8 * preset.mcu_height
    pixels = _px(rng, h, 48)
    single = encode_array(pixels, 255, EncoderConfig(chroma_subsampling=preset))
    sharded = encode_array(
        pixels, 255,
        EncoderConfig(
            chroma_subsampling=preset, num_shards=8, scan_backend="device",
            one_dispatch="off",
        ),
    )
    assert sharded == single


@needs_8
def test_sharded_device_pack_non_divisible(rng):
    # 3 MCU rows over 8 shards: padding shards emit zero-length segments
    pixels = _px(rng, 44, 28)
    single = encode_array(pixels, 255, EncoderConfig())
    sharded = encode_array(
        pixels, 255,
        EncoderConfig(num_shards=8, scan_backend="device", one_dispatch="off"),
    )
    assert sharded == single


@needs_8
def test_sharded_device_pack_larger_image(rng):
    pixels = _px(rng, 128, 96)
    single = encode_array(pixels, 255, EncoderConfig())
    for n in (2, 4, 8):
        for od in ("off", "auto"):
            sharded = encode_array(
                pixels, 255,
                EncoderConfig(
                    num_shards=n, scan_backend="device", one_dispatch=od
                ),
            )
            assert sharded == single, (n, od)


@needs_8
@pytest.mark.parametrize("preset", list(ChromaSubsamplingPreset))
def test_sharded_onedispatch_bit_exact(monkeypatch, rng, preset):
    """The ONE-program sharded encode (phase-1 + psum'd histograms +
    device table build + per-shard pack in a single jit) must produce the
    single-chip bytes for every preset."""
    from dmmt_jpeg_encoder.parallel import sharding

    h = 8 * preset.mcu_height
    pixels = _px(rng, h, 48)
    single = encode_array(pixels, 255, EncoderConfig(chroma_subsampling=preset))
    cfg = EncoderConfig(
        chroma_subsampling=preset, num_shards=8, scan_backend="device"
    )
    state = sharding.start_sharded_encode(pixels, 255, cfg)
    assert state[0] == "onedispatch"  # the one-program path must engage
    scan, tables = sharding.finish_sharded_encode(state, cfg)
    sharded = encode_array(pixels, 255, cfg)
    assert sharded == single


@needs_8
def test_sharded_onedispatch_non_divisible_and_speculative_fetch(
    monkeypatch, rng
):
    """Non-divisible MCU rows (alignment-padding shards emit nothing) and
    the second encode at the same geometry (speculative word-slice fetch
    from the _LAST_SHARD_BITS cache) both stay byte-exact."""
    from dmmt_jpeg_encoder.parallel import sharding

    cfg = EncoderConfig(num_shards=8, scan_backend="device")
    pixels = _px(rng, 44, 28)  # 3 MCU rows over 8 shards
    single = encode_array(pixels, 255, EncoderConfig())
    first = encode_array(pixels, 255, cfg)
    key_hits = [k for k in sharding._LAST_SHARD_BITS if k[0] == 44]
    assert key_hits, "speculation cache not populated"
    second = encode_array(pixels, 255, cfg)  # speculative-slice path
    assert first == second == single


def test_sharded_fused_pack_bit_exact(monkeypatch, rng):
    """Per-shard packing on a 2-shard mesh through the one-dispatch
    program (the default device path) must produce the single-chip
    bytes."""
    from dmmt_jpeg_encoder import encode_array
    from dmmt_jpeg_encoder.config import ChromaSubsamplingPreset, EncoderConfig

    px = rng.integers(0, 256, (40, 32, 3), dtype=np.uint16)
    sharded = encode_array(
        px, 255,
        EncoderConfig(
            chroma_subsampling=ChromaSubsamplingPreset.P420,
            num_shards=2,
            scan_backend="device",
        ),
    )
    single = encode_array(
        px, 255, EncoderConfig(chroma_subsampling=ChromaSubsamplingPreset.P420)
    )
    assert sharded == single

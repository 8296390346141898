"""Batch encode: fused multi-image dispatch must equal per-image encodes."""

import numpy as np
import pytest

from dmmt_jpeg_encoder import ChromaSubsamplingPreset, EncoderConfig, encode_array
from dmmt_jpeg_encoder.encoder import _encode_batch_fused, encode_batch


def _images(rng, n, h=40, w=56):
    return [
        np.ascontiguousarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint16))
        for _ in range(n)
    ]


@pytest.mark.parametrize("preset", list(ChromaSubsamplingPreset))
def test_fused_batch_matches_single(rng, preset):
    imgs = _images(rng, 3)
    cfg = EncoderConfig(chroma_subsampling=preset, scan_backend="device")
    fused = _encode_batch_fused(imgs, 255, cfg)
    singles = [encode_array(px, 255, cfg) for px in imgs]
    assert fused == singles


def test_encode_batch_pipelined_matches_single(rng):
    imgs = _images(rng, 3)
    cfg = EncoderConfig(scan_backend="host")
    batched = encode_batch(imgs, 255, cfg)
    singles = [encode_array(px, 255, cfg) for px in imgs]
    assert batched == singles


def test_encode_batch_device_entry_point(rng):
    imgs = _images(rng, 5)
    cfg = EncoderConfig(scan_backend="device")
    batched = encode_batch(imgs, 255, cfg, fused_batch=2)  # 2+2+1 chunks
    singles = [encode_array(px, 255, cfg) for px in imgs]
    assert batched == singles


def test_encode_batch_mixed_shapes_falls_back(rng):
    imgs = [_images(rng, 1, 24, 24)[0], _images(rng, 1, 40, 16)[0]]
    cfg = EncoderConfig(scan_backend="device")
    batched = encode_batch(imgs, 255, cfg)
    singles = [encode_array(px, 255, cfg) for px in imgs]
    assert batched == singles


def test_sharded_batch_pipelined_bit_exact():
    """encode_batch with num_shards>1 pipelines sharded dispatches and
    must produce exactly the per-image encode_array bytes."""
    from dmmt_jpeg_encoder.config import ChromaSubsamplingPreset, EncoderConfig
    from dmmt_jpeg_encoder.encoder import encode_array, encode_batch

    rng = np.random.default_rng(11)
    images = [
        rng.integers(0, 256, (40, 36, 3), dtype=np.uint16) for _ in range(3)
    ]
    cfg = EncoderConfig(
        chroma_subsampling=ChromaSubsamplingPreset.P420,
        num_shards=4,
        scan_backend="device",
    )
    batched = encode_batch(images, 255, cfg)
    singles = [encode_array(px, 255, cfg) for px in images]
    assert batched == singles
    # and identical to the single-chip bytes
    plain = [
        encode_array(
            px, 255, EncoderConfig(chroma_subsampling=ChromaSubsamplingPreset.P420)
        )
        for px in images
    ]
    assert batched == plain

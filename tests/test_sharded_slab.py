"""Sharded SLAB one-dispatch program (parallel/sharding.py,
start_sharded_encode_slab): B same-geometry images, each row-sharded over
the mesh AND row-stacked per shard into ONE program, so the per-program
fixed work is paid once per group. Bytes must equal per-image single-chip
encodes exactly."""

import numpy as np
import jax
import pytest

from dmmt_jpeg_encoder import (
    ChromaSubsamplingPreset,
    EncoderConfig,
    encode_array,
    encode_batch,
)

needs_8 = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)


def _photo(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    base = 96 + 60 * np.sin(xx / 9.0) + 40 * np.cos(yy / 7.0)
    return np.clip(
        np.stack([base, base * 0.9 + 10, base * 1.1 - 8], axis=-1)
        + rng.normal(0, 3, (h, w, 3)),
        0, 255,
    ).astype(np.uint8)


@needs_8
@pytest.mark.parametrize("preset", ["P420", "P444"])
def test_sharded_slab_matches_single_chip(rng, monkeypatch, preset):
    from dmmt_jpeg_encoder.parallel.sharding import (
        finish_sharded_encode_slab,
        start_sharded_encode_slab,
    )

    cfg = EncoderConfig(
        chroma_subsampling=ChromaSubsamplingPreset(preset),
        num_shards=4,
        scan_backend="device",
    )
    # Non-divisible: 3 MCU rows over 4 shards exercises the alignment
    # mask; odd pixel sizes exercise the per-image MCU padding.
    h, w = 3 * cfg.chroma_subsampling.mcu_height - 5, 44
    imgs = [_photo(rng, h, w) for _ in range(3)]
    state = start_sharded_encode_slab(np.stack(imgs), 255, cfg)
    got = finish_sharded_encode_slab(state, cfg)
    single_cfg = EncoderConfig(
        chroma_subsampling=ChromaSubsamplingPreset(preset)
    )
    for px, (scan, _tables) in zip(imgs, got):
        single = encode_array(px, 255, single_cfg)
        # the JPEG file is container + scan: substring == scan equality
        assert scan in single


@needs_8
def test_encode_batch_sharded_routes_slab_and_matches(rng, monkeypatch):
    """encode_batch with num_shards>1 on a same-geometry batch must take
    the sharded-slab path (dispatch-reached) and return bytes equal to
    per-image single-chip encodes."""
    from dmmt_jpeg_encoder.parallel import sharding as sh

    calls = []
    orig = sh.start_sharded_encode_slab
    monkeypatch.setattr(
        sh,
        "start_sharded_encode_slab",
        lambda *a, **k: (calls.append(1), orig(*a, **k))[1],
    )
    cfg = EncoderConfig(
        chroma_subsampling=ChromaSubsamplingPreset.P420,
        num_shards=2,
        scan_backend="device",
    )
    imgs = [_photo(rng, 32, 48) for _ in range(5)]  # 2+2+1 groups
    monkeypatch.setenv("DMMT_SLAB_B", "2")
    got = encode_batch(imgs, 255, cfg)
    assert calls, "sharded batch did not route through the slab program"
    singles = [
        encode_array(px, 255, EncoderConfig(chroma_subsampling=ChromaSubsamplingPreset.P420))
        for px in imgs
    ]
    assert got == singles


@needs_8
def test_sharded_slab_respects_block_limit(rng, monkeypatch):
    monkeypatch.setenv("DMMT_SLAB_MAX_BLOCKS", "10")
    from dmmt_jpeg_encoder.parallel.sharding import (
        start_sharded_encode_slab,
    )

    cfg = EncoderConfig(
        chroma_subsampling=ChromaSubsamplingPreset.P420,
        num_shards=2,
        scan_backend="device",
    )
    imgs = np.stack([_photo(rng, 32, 48) for _ in range(2)])
    with pytest.raises(ValueError, match="compile limit"):
        start_sharded_encode_slab(imgs, 255, cfg)


@needs_8
def test_sharded_auto_pair_rides_slab(rng, monkeypatch):
    """Two same-geometry images on a 2-shard mesh form one auto B=2
    sharded slab group, byte-equal to single-device encodes."""
    from dmmt_jpeg_encoder.encoder import encode_batch, encode_array
    import dmmt_jpeg_encoder.parallel.sharding as sh

    calls = []
    orig = sh.start_sharded_encode_slab
    monkeypatch.setattr(
        sh,
        "start_sharded_encode_slab",
        lambda stack, *a, **k: (calls.append(len(stack)), orig(stack, *a, **k))[1],
    )
    cfg = EncoderConfig(
        chroma_subsampling=ChromaSubsamplingPreset.P420,
        num_shards=2,
        scan_backend="device",
    )
    imgs = [_photo(rng, 32, 48) for _ in range(2)]
    got = encode_batch(imgs, 255, cfg)
    assert calls == [2]
    singles = [
        encode_array(
            px, 255,
            EncoderConfig(chroma_subsampling=ChromaSubsamplingPreset.P420),
        )
        for px in imgs
    ]
    assert got == singles

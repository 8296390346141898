"""Row-stacked SLAB one-dispatch program (B same-geometry encodes in ONE
jit): bytes must equal per-image encodes exactly — per-image DPCM resets,
per-image histograms/tables/streams. (Reference hot path analog:
encoder.rs:264-404, one image at a time; the slab is this framework's
throughput form.)"""

import jax
import numpy as np
import pytest

from dmmt_jpeg_encoder.config import (
    ChromaSubsamplingPreset,
    EncoderConfig,
    QuantizationTablePreset,
)
from dmmt_jpeg_encoder.encoder import encode_array, encode_batch
from dmmt_jpeg_encoder.onedispatch import (
    finish_one_dispatch,
    start_one_dispatch,
    start_one_dispatch_slab,
)
from dmmt_jpeg_encoder.tables import quantization_table_pair


@pytest.fixture(autouse=True)
def _check_bits_and_bounded_compiles(monkeypatch):
    monkeypatch.setenv("DMMT_CHECK_BITS", "1")
    yield
    jax.clear_caches()  # heavy module: bound live executables per test


def _images(rng, b, h, w):
    return np.stack(
        [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(b)]
    )


LQ, CQ = quantization_table_pair(QuantizationTablePreset.SPECIFICATION)


@pytest.mark.parametrize("preset", list(ChromaSubsamplingPreset))
def test_slab_bytes_match_per_image(rng, preset):
    cfg = EncoderConfig(chroma_subsampling=preset)
    imgs = _images(rng, 3, 48, 64)
    slab = [
        finish_one_dispatch(s, cfg)
        for s in start_one_dispatch_slab(imgs, 255, cfg, LQ, CQ)
    ]
    for i in range(3):
        scan, tables = finish_one_dispatch(
            start_one_dispatch(imgs[i], 255, cfg, LQ, CQ), cfg
        )
        assert slab[i][0] == scan, i
        assert slab[i][1] == tables, i


def test_slab_pads_odd_geometry(rng):
    """Odd geometry: each image pre-padded to its own MCU multiple, so
    slab MCU rows never straddle images."""
    cfg = EncoderConfig(chroma_subsampling=ChromaSubsamplingPreset.P420)
    imgs = _images(rng, 2, 37, 53)
    slab = [
        finish_one_dispatch(s, cfg)
        for s in start_one_dispatch_slab(imgs, 255, cfg, LQ, CQ)
    ]
    for i in range(2):
        scan, tables = finish_one_dispatch(
            start_one_dispatch(imgs[i], 255, cfg, LQ, CQ), cfg
        )
        assert (slab[i][0], slab[i][1]) == (scan, tables), i


def test_slab_planar_input(rng):
    cfg = EncoderConfig(chroma_subsampling=ChromaSubsamplingPreset.P420)
    imgs = _images(rng, 2, 48, 64)
    planar = np.ascontiguousarray(imgs.transpose(0, 3, 1, 2))
    a = [
        finish_one_dispatch(s, cfg)
        for s in start_one_dispatch_slab(imgs, 255, cfg, LQ, CQ)
    ]
    b = [
        finish_one_dispatch(s, cfg)
        for s in start_one_dispatch_slab(planar, 255, cfg, LQ, CQ)
    ]
    for i in range(2):
        assert a[i][0] == b[i][0], i


def test_slab_block_cap(rng, monkeypatch):
    monkeypatch.setenv("DMMT_SLAB_MAX_BLOCKS", "10")
    imgs = _images(rng, 2, 16, 16)
    with pytest.raises(ValueError, match="single-program compile limit"):
        start_one_dispatch_slab(
            imgs, 255, EncoderConfig(), LQ, CQ
        )


def test_encode_batch_routes_through_slab(rng, monkeypatch):
    """DISPATCH-REACHED check: encode_batch with device backend + same
    shapes must actually call the slab dispatcher, not silently fall back
    to per-image programs."""
    import dmmt_jpeg_encoder.encoder as enc_mod

    calls = {"n": 0}
    real = start_one_dispatch_slab

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(
        "dmmt_jpeg_encoder.onedispatch.start_one_dispatch_slab",
        counting,
    )
    monkeypatch.setenv("DMMT_SLAB_B", "2")
    imgs = [rng.integers(0, 256, (32, 48, 3), dtype=np.uint8) for _ in range(4)]
    cfg = EncoderConfig(scan_backend="device")
    batched = encode_batch(imgs, 255, cfg)
    assert calls["n"] == 2  # two groups of 2
    singles = [encode_array(px, 255, cfg) for px in imgs]
    assert batched == singles


def test_encode_batch_slab_off_flag(rng, monkeypatch):
    monkeypatch.setenv("DMMT_SLAB", "0")
    import dmmt_jpeg_encoder.onedispatch as od

    def boom(*a, **k):  # pragma: no cover - must not be called
        raise AssertionError("slab dispatched with DMMT_SLAB=0")

    monkeypatch.setattr(od, "start_one_dispatch_slab", boom)
    imgs = [rng.integers(0, 256, (32, 48, 3), dtype=np.uint8) for _ in range(2)]
    cfg = EncoderConfig(scan_backend="device")
    batched = encode_batch(imgs, 255, cfg)
    singles = [encode_array(px, 255, cfg) for px in imgs]
    assert batched == singles


def test_encode_batch_rows_cap_skips_slab(rng, monkeypatch):
    """DMMT_SLAB_MAX_ROWS bounds rows per IMAGE — images taller than the
    cap must ride the pipelined per-image path even when the block cap
    allows stacking."""
    import dmmt_jpeg_encoder.onedispatch as od

    def boom(*a, **k):  # pragma: no cover - must not be called
        raise AssertionError("slab dispatched past the rows cap")

    monkeypatch.setattr(od, "start_one_dispatch_slab", boom)
    # padded per-image height 64 > rows cap of 32 -> slab must be skipped
    monkeypatch.setenv("DMMT_SLAB_MAX_ROWS", "32")
    imgs = [rng.integers(0, 256, (64, 48, 3), dtype=np.uint8) for _ in range(2)]
    cfg = EncoderConfig(scan_backend="device")
    batched = encode_batch(imgs, 255, cfg)
    singles = [encode_array(px, 255, cfg) for px in imgs]
    assert batched == singles


def test_encode_batch_blocks_cap_bounds_group_size(rng, monkeypatch):
    """The compile cap bounds B: 4 x 32-row images (36 blocks each) with a
    144-block cap must run as one B=4 slab group."""
    calls = {"n": 0, "b": set()}
    real = start_one_dispatch_slab

    def counting(stack, *a, **k):
        calls["n"] += 1
        calls["b"].add(int(stack.shape[0]))
        return real(stack, *a, **k)

    monkeypatch.setattr(
        "dmmt_jpeg_encoder.onedispatch.start_one_dispatch_slab",
        counting,
    )
    monkeypatch.setenv("DMMT_SLAB_MAX_BLOCKS", "144")
    imgs = [rng.integers(0, 256, (32, 48, 3), dtype=np.uint8) for _ in range(4)]
    cfg = EncoderConfig(scan_backend="device")
    batched = encode_batch(imgs, 255, cfg)
    assert calls["n"] == 1 and calls["b"] == {4}
    singles = [encode_array(px, 255, cfg) for px in imgs]
    assert batched == singles


def test_encode_batch_auto_pair_rides_slab(rng, monkeypatch):
    """Two small same-geometry images form one auto B=2 slab group."""
    calls = {"b": []}
    real = start_one_dispatch_slab

    def counting(stack, *a, **k):
        calls["b"].append(int(stack.shape[0]))
        return real(stack, *a, **k)

    monkeypatch.setattr(
        "dmmt_jpeg_encoder.onedispatch.start_one_dispatch_slab",
        counting,
    )
    imgs = [rng.integers(0, 256, (32, 48, 3), dtype=np.uint8) for _ in range(2)]
    cfg = EncoderConfig(scan_backend="device")
    batched = encode_batch(imgs, 255, cfg)
    assert calls["b"] == [2]
    singles = [encode_array(px, 255, cfg) for px in imgs]
    assert batched == singles


def test_encode_batch_auto_depth_clamps_at_64(rng, monkeypatch):
    """Auto slab depth clamps at SLAB_MAX_DEPTH (64): 70 tiny
    same-geometry images must be handed to the slab path with B=64, not
    B=70 (program size grows linearly with depth). The slab path itself
    is spied out — group-splitting and byte equality are covered by the
    dispatch-level tests above at smaller depths."""
    import dmmt_jpeg_encoder.encoder as enc_mod

    picks = []

    def fake_slab(images, maxval, config, slab_b):
        picks.append(slab_b)
        return [encode_array(px, maxval, config) for px in images]

    monkeypatch.setattr(enc_mod, "_encode_batch_slab", fake_slab)
    imgs = [
        rng.integers(0, 256, (16, 16, 3), dtype=np.uint8) for _ in range(70)
    ]
    cfg = EncoderConfig(scan_backend="device")
    batched = encode_batch(imgs, 255, cfg)
    assert picks == [64]
    singles = [encode_array(px, 255, cfg) for px in imgs]
    assert batched == singles


def test_encode_batch_upload_depth_paths(rng, monkeypatch):
    """The pipelined per-image path is byte-stable across upload
    look-ahead depths (DMMT_UPLOAD_DEPTH edge values)."""
    monkeypatch.setenv("DMMT_SLAB", "0")
    imgs = [rng.integers(0, 256, (32, 48, 3), dtype=np.uint8) for _ in range(5)]
    cfg = EncoderConfig(scan_backend="device")
    singles = [encode_array(px, 255, cfg) for px in imgs]
    for depth in ("1", "4", "16"):
        monkeypatch.setenv("DMMT_UPLOAD_DEPTH", depth)
        assert encode_batch(imgs, 255, cfg) == singles, depth


def test_encode_batch_trailing_pair_rides_slab(rng, monkeypatch):
    """6 x 32-row images with a 144-block cap -> a B=4 slab group and a
    trailing B=2 slab group; bytes equal per-image encodes."""
    calls = {"b": []}
    real = start_one_dispatch_slab

    def counting(stack, *a, **k):
        calls["b"].append(int(stack.shape[0]))
        return real(stack, *a, **k)

    monkeypatch.setattr(
        "dmmt_jpeg_encoder.onedispatch.start_one_dispatch_slab",
        counting,
    )
    monkeypatch.setenv("DMMT_SLAB_MAX_BLOCKS", "144")
    imgs = [rng.integers(0, 256, (32, 48, 3), dtype=np.uint8) for _ in range(6)]
    cfg = EncoderConfig(scan_backend="device")
    batched = encode_batch(imgs, 255, cfg)
    assert calls["b"] == [4, 2]
    singles = [encode_array(px, 255, cfg) for px in imgs]
    assert batched == singles

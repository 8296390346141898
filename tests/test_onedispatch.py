"""One-dispatch encode (device tables + fused pack in one program) must be
byte-identical to the two-dispatch host-table path."""

import jax
import numpy as np
import pytest

from dmmt_jpeg_encoder.config import ChromaSubsamplingPreset, EncoderConfig
from dmmt_jpeg_encoder.encoder import encode_array, encode_batch


@pytest.fixture(autouse=True)
def _bound_compile_count_per_test():
    """This module compiles more distinct XLA:CPU programs than any other
    (every geometry x preset x backend is a fresh executable). Past ~a few
    hundred live LLVM-JIT executables in one process the CPU backend
    abort()s inside backend_compile (reproducible; see conftest). Clearing
    per TEST (not just per module) keeps the live-executable count bounded
    by a single test's compiles."""
    yield
    jax.clear_caches()


@pytest.fixture
def check_bits(monkeypatch):
    monkeypatch.setenv("DMMT_CHECK_BITS", "1")


def _image(rng, h, w):
    base = rng.normal(120, 45, (h, w)).clip(0, 255)
    return (
        np.stack([base, base * 0.9 + 8, base * 1.07 - 4], axis=-1)
        .clip(0, 255)
        .astype(np.uint8)
    )


@pytest.mark.parametrize("preset", list(ChromaSubsamplingPreset))
def test_one_dispatch_bytes_match_host(rng, check_bits, preset):
    px = _image(rng, 48, 64)
    od = encode_array(
        px, 255, EncoderConfig(chroma_subsampling=preset, scan_backend="device")
    )
    host = encode_array(
        px, 255, EncoderConfig(chroma_subsampling=preset, scan_backend="host")
    )
    assert od == host


def test_one_dispatch_odd_size_and_quality(rng, check_bits):
    px = _image(rng, 37, 53)  # padding exercised
    cfg = EncoderConfig(
        chroma_subsampling=ChromaSubsamplingPreset.P420,
        scan_backend="device",
        quality=85,
    )
    host = EncoderConfig(
        chroma_subsampling=ChromaSubsamplingPreset.P420,
        scan_backend="host",
        quality=85,
    )
    assert encode_array(px, 255, cfg) == encode_array(px, 255, host)


def test_one_dispatch_off_flag(rng, check_bits):
    px = _image(rng, 32, 32)
    on = encode_array(
        px, 255, EncoderConfig(scan_backend="device")
    )
    off = encode_array(
        px, 255, EncoderConfig(scan_backend="device", one_dispatch="off")
    )
    assert on == off


def test_one_dispatch_batch_pipeline(rng, check_bits):
    images = [_image(rng, 32, 48) for _ in range(3)]
    cfg = EncoderConfig(scan_backend="device")
    batched = encode_batch(images, 255, cfg)
    singles = [encode_array(px, 255, cfg) for px in images]
    assert batched == singles


@pytest.mark.parametrize("quality", [1, 50, 100])
def test_one_dispatch_quality_extremes(rng, check_bits, quality):
    """q=1 floods the stream with ZRL/EOB symbols (giant quant steps);
    q=100 produces dense long streams — both must match the host packer."""
    px = _image(rng, 40, 48)
    cfg_d = EncoderConfig(scan_backend="device", quality=quality)
    cfg_h = EncoderConfig(scan_backend="host", quality=quality)
    assert encode_array(px, 255, cfg_d) == encode_array(px, 255, cfg_h)


def test_one_dispatch_16bit_source(rng, check_bits):
    """maxval > 255 sources stay uint16 end to end."""
    px = rng.integers(0, 1024, (24, 40, 3)).astype(np.uint16)
    d = encode_array(px, 1023, EncoderConfig(scan_backend="device"))
    h = encode_array(px, 1023, EncoderConfig(scan_backend="host"))
    assert d == h


def test_one_dispatch_geometry_fuzz(rng, check_bits):
    """Odd geometries: single-MCU, single-row, padding in both axes."""
    for h, w in [(8, 8), (16, 8), (8, 24), (17, 9), (33, 15), (16, 50)]:
        jax.clear_caches()  # each geometry compiles ~8 fresh programs
        px = _image(rng, h, w)
        for preset in ChromaSubsamplingPreset:
            d = encode_array(
                px, 255,
                EncoderConfig(chroma_subsampling=preset, scan_backend="device"),
            )
            hsot = encode_array(
                px, 255,
                EncoderConfig(chroma_subsampling=preset, scan_backend="host"),
            )
            assert d == hsot, (h, w, preset)


def test_one_dispatch_planar_input_bytes_match(rng, check_bits):
    """[3, H, W] channel-planar input produces the same bytes as [H, W, 3]
    (the planar path pads u8 planes first and converts per plane)."""
    from dmmt_jpeg_encoder import onedispatch as od
    from dmmt_jpeg_encoder.config import QuantizationTablePreset
    from dmmt_jpeg_encoder.tables import quantization_table_pair

    lq, cq = quantization_table_pair(QuantizationTablePreset.SPECIFICATION)
    for h, w in ((48, 64), (37, 53)):
        px = _image(rng, h, w)
        planar = np.ascontiguousarray(px.transpose(2, 0, 1))
        for preset in (ChromaSubsamplingPreset.P420, ChromaSubsamplingPreset.P444):
            cfg = EncoderConfig(chroma_subsampling=preset)
            a = od.finish_one_dispatch(
                od.start_one_dispatch(px, 255, cfg, lq, cq), cfg
            )
            b = od.finish_one_dispatch(
                od.start_one_dispatch(planar, 255, cfg, lq, cq), cfg
            )
            assert a[0] == b[0]


def test_multi_image_onedispatch_matches_per_image(monkeypatch, rng):
    """B same-geometry encodes in ONE program must yield the per-image
    scan bytes and tables."""
    from dmmt_jpeg_encoder import ChromaSubsamplingPreset, EncoderConfig
    from dmmt_jpeg_encoder.config import QuantizationTablePreset
    from dmmt_jpeg_encoder.onedispatch import (
        finish_one_dispatch,
        start_one_dispatch,
        start_one_dispatch_multi,
    )
    from dmmt_jpeg_encoder.tables import quantization_table_pair

    cfg = EncoderConfig(chroma_subsampling=ChromaSubsamplingPreset.P420)
    lq, cq = quantization_table_pair(QuantizationTablePreset.SPECIFICATION)
    imgs = np.stack(
        [rng.integers(0, 256, (48, 64, 3), dtype=np.uint8) for _ in range(2)]
    )
    multi = [
        finish_one_dispatch(s, cfg)
        for s in start_one_dispatch_multi(imgs, 255, cfg, lq, cq)
    ]
    for i in range(2):
        scan, tables = finish_one_dispatch(
            start_one_dispatch(imgs[i], 255, cfg, lq, cq), cfg
        )
        assert multi[i][0] == scan
        assert multi[i][1] == tables

"""End-to-end encode tests: every reference fixture, every preset, decoded
by an independent decoder (PIL) and compared against the source pixels.

This goes beyond the reference's integration test (which only asserts the
output file exists, tests/convert_ppm_to_jpeg.rs:31-43): we require actual
decodability and quality parity with the reference's committed .jpg outputs.
"""

from io import BytesIO

import numpy as np
import pytest

from dmmt_jpeg_encoder import (
    ChromaSubsamplingPreset,
    EncoderConfig,
    QuantizationTablePreset,
    convert_ppm_to_jpeg,
    encode_ppm_image,
)
from dmmt_jpeg_encoder.io.ppm import read_ppm

PIL = pytest.importorskip("PIL.Image")


def decode(jpeg_bytes: bytes) -> np.ndarray:
    im = PIL.open(BytesIO(jpeg_bytes))
    return np.asarray(im.convert("RGB")).astype(np.float64)


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = ((a - b) ** 2).mean()
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(255.0**2 / mse)


def to_8bit(img) -> np.ndarray:
    return np.round(
        img.pixels.astype(np.float64) * 255.0 / img.maxval
    ).astype(np.float64)


@pytest.mark.parametrize(
    "name", ["small.ppm", "8x8.ppm", "16x16.ppm", "7x17.ppm", "500x500.ppm"]
)
@pytest.mark.parametrize("preset", list(ChromaSubsamplingPreset))
def test_fixture_encodes_and_decodes(fixtures_dir, name, preset):
    img = read_ppm(fixtures_dir / name)
    cfg = EncoderConfig(chroma_subsampling=preset)
    jpg = encode_ppm_image(img, cfg)
    assert jpg[:2] == b"\xff\xd8" and jpg[-2:] == b"\xff\xd9"
    dec = decode(jpg)
    assert dec.shape == (img.height, img.width, 3)


@pytest.mark.parametrize("qt", list(QuantizationTablePreset))
def test_quant_presets_all_work(fixtures_dir, qt):
    img = read_ppm(fixtures_dir / "16x16.ppm")
    jpg = encode_ppm_image(img, EncoderConfig(quantization_preset=qt))
    dec = decode(jpg)
    assert dec.shape == (img.height, img.width, 3)


@pytest.mark.parametrize(
    "ppm_name,min_db",
    [("8x8.ppm", 45.0), ("16x16.ppm", 25.0), ("500x500.ppm", 43.0)],
)
def test_default_encode_quality_floor(fixtures_dir, ppm_name, min_db):
    """Default-settings (P420 + Annex K) PSNR floors per fixture.

    The reference's committed .jpg fixtures are NOT same-settings encodes of
    the .ppm fixtures (8x8.jpg decodes to 1.8 dB vs 8x8.ppm; 500x500.ppm was
    generated FROM 500x500.jpg, which therefore decodes losslessly), so
    absolute floors — measured with margin below our current quality — stand
    in for byte parity, plus the beat-the-committed-output check below."""
    img = read_ppm(fixtures_dir / ppm_name)
    src = to_8bit(img)
    ours = decode(encode_ppm_image(img, EncoderConfig()))
    val = psnr(ours, src)
    assert val >= min_db, f"{ppm_name}: {val:.2f} dB < floor {min_db}"


def test_beats_committed_8x8_output(fixtures_dir):
    """The one fixture where the committed output is an encode of the same
    source: our default encode must reconstruct it far more faithfully."""
    img = read_ppm(fixtures_dir / "8x8.ppm")
    src = to_8bit(img)
    ours = psnr(decode(encode_ppm_image(img, EncoderConfig())), src)
    theirs = psnr(decode((fixtures_dir / "8x8.jpg").read_bytes()), src)
    assert ours > theirs


def test_p444_high_quality(fixtures_dir):
    """P444 + flat tables should reconstruct very faithfully."""
    img = read_ppm(fixtures_dir / "500x500.ppm")
    jpg = encode_ppm_image(
        img,
        EncoderConfig(
            chroma_subsampling=ChromaSubsamplingPreset.P444,
            quantization_preset=QuantizationTablePreset.FLAT,
        ),
    )
    assert psnr(decode(jpg), to_8bit(img)) > 30.0


def test_native_and_python_scan_paths_identical(fixtures_dir):
    img = read_ppm(fixtures_dir / "7x17.ppm")
    a = encode_ppm_image(img, EncoderConfig(), use_native=True)
    b = encode_ppm_image(img, EncoderConfig(), use_native=False)
    assert a == b


def test_gradient_roundtrip_all_presets():
    h, w = 40, 56
    yy, xx = np.mgrid[0:h, 0:w]
    pixels = np.stack(
        [
            (xx * 255 // max(w - 1, 1)),
            (yy * 255 // max(h - 1, 1)),
            ((xx + yy) * 255 // (w + h - 2)),
        ],
        axis=-1,
    ).astype(np.uint16)
    from dmmt_jpeg_encoder import encode_array

    src = pixels.astype(np.float64)
    for preset in ChromaSubsamplingPreset:
        jpg = encode_array(pixels, 255, EncoderConfig(chroma_subsampling=preset))
        val = psnr(decode(jpg), src)
        assert val > 28.0, f"{preset}: {val:.2f} dB"


def test_convert_file_to_file(fixtures_dir, tmp_path):
    out = tmp_path / "out.jpg"
    convert_ppm_to_jpeg(fixtures_dir / "8x8.ppm", out)
    assert out.exists()
    dec = decode(out.read_bytes())
    assert dec.shape == (8, 8, 3)


def test_maxval_scaling():
    """A maxval-31 image must encode like its 8-bit-scaled equivalent."""
    from dmmt_jpeg_encoder import encode_array

    xx = np.arange(32)
    grad = (xx[None, :] + xx[:, None]) * 31 // 62  # smooth 0..31 ramp
    px31 = np.stack([grad, 31 - grad, grad], axis=-1).astype(np.uint16)
    jpg = encode_array(px31, 31, EncoderConfig())
    dec = decode(jpg)
    src = px31.astype(np.float64) * 255.0 / 31.0
    assert psnr(dec, src) > 25.0

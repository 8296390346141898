"""IJG quality scaling (extension over the reference's fixed presets)."""

from io import BytesIO

import numpy as np
import pytest

from dmmt_jpeg_encoder import EncoderConfig, QuantizationTablePreset, encode_array
from dmmt_jpeg_encoder.cli import parse_args
from dmmt_jpeg_encoder.tables import quantization_table_pair


def test_q50_is_identity():
    base = quantization_table_pair(QuantizationTablePreset.SPECIFICATION)
    q50 = quantization_table_pair(QuantizationTablePreset.SPECIFICATION, 50)
    np.testing.assert_array_equal(base[0], q50[0])
    np.testing.assert_array_equal(base[1], q50[1])


def test_scaling_monotone():
    q25 = quantization_table_pair(QuantizationTablePreset.SPECIFICATION, 25)
    q75 = quantization_table_pair(QuantizationTablePreset.SPECIFICATION, 75)
    q95 = quantization_table_pair(QuantizationTablePreset.SPECIFICATION, 95)
    assert (q25[0] >= q75[0]).all() and (q75[0] >= q95[0]).all()
    assert q95[0].min() >= 1


def test_quality_bounds():
    with pytest.raises(ValueError):
        quantization_table_pair(QuantizationTablePreset.SPECIFICATION, 0)
    with pytest.raises(ValueError):
        EncoderConfig(quality=101)


def test_quality_sweep_sizes_and_psnr():
    PIL = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:48, 0:64]
    px = np.clip(
        np.stack([xx * 4, yy * 5, xx + yy], -1) % 256
        + rng.normal(0, 4, (48, 64, 3)),
        0, 255,
    ).astype(np.uint16)
    sizes, psnrs = [], []
    for q in (50, 75, 90, 95):
        jpg = encode_array(px, 255, EncoderConfig(quality=q))
        dec = np.asarray(PIL.open(BytesIO(jpg)).convert("RGB")).astype(np.float64)
        mse = ((dec - px) ** 2).mean()
        sizes.append(len(jpg))
        psnrs.append(10 * np.log10(255**2 / mse))
    assert sizes == sorted(sizes), "higher quality must not shrink the file"
    assert psnrs == sorted(psnrs), "higher quality must not lower PSNR"
    assert psnrs[-1] > psnrs[0]
    assert sizes[-1] > 1.5 * sizes[0]


def test_cli_quality_flag():
    _, cfg = parse_args(["a", "b", "--quality", "85"])
    assert cfg.quality == 85
    with pytest.raises(SystemExit):
        parse_args(["a", "b", "--quality", "0"])

"""Device-side Huffman table build vs the host implementation."""

import numpy as np
import jax.numpy as jnp
import pytest

from dmmt_jpeg_encoder.huffman.canonical import flat_code_arrays
from dmmt_jpeg_encoder.huffman.device_tables import (
    device_code_tables,
    pad_dc_histogram,
)
from dmmt_jpeg_encoder.huffman.spec import code_lengths_from_histogram


def _host_tables(hist):
    lst = code_lengths_from_histogram(np.asarray(hist))
    codes, lens = flat_code_arrays(lst)
    return lst, np.asarray(codes), np.asarray(lens)


def _assert_match(hist):
    lst, codes, lens = _host_tables(hist)
    dev = device_code_tables(jnp.asarray(hist, jnp.int32))
    n = int(dev["n_present"])
    assert n == len(lst)
    np.testing.assert_array_equal(
        np.asarray(dev["sym_by_leaf"])[:n], [e.symbol for e in lst]
    )
    np.testing.assert_array_equal(
        np.asarray(dev["len_by_leaf"])[:n], [e.length for e in lst]
    )
    np.testing.assert_array_equal(np.asarray(dev["lens_flat"]), lens[:256])
    np.testing.assert_array_equal(np.asarray(dev["codes_flat"]), codes[:256])


@pytest.mark.parametrize("seed", range(8))
def test_random_histograms(seed):
    rng = np.random.default_rng(seed)
    hist = np.zeros(256, np.int64)
    n_syms = rng.integers(1, 200)
    picks = rng.choice(256, n_syms, replace=False)
    hist[picks] = rng.integers(1, 100_000, n_syms)
    _assert_match(hist)


def test_tie_heavy_histogram():
    # many equal frequencies: exercises the stable-sort + Leaf<Package
    # tie-breaking that decides exact code assignment
    hist = np.zeros(256, np.int64)
    hist[: 64] = 7
    hist[64:80] = 3
    hist[200:230] = 7
    _assert_match(hist)


def test_single_symbol():
    hist = np.zeros(256, np.int64)
    hist[42] = 1000
    _assert_match(hist)  # lone symbol gets length 1 (0 + the bump)


def test_two_symbols():
    hist = np.zeros(256, np.int64)
    hist[3] = 5
    hist[250] = 5
    _assert_match(hist)


def test_dc_histogram_padding():
    dc = np.zeros(16, np.int64)
    dc[2] = 100
    dc[3] = 40
    dc[7] = 1
    padded = pad_dc_histogram(jnp.asarray(dc, jnp.int32))
    assert padded.shape == (256,)
    _assert_match(np.asarray(padded))


def test_skewed_large_counts():
    # power-law-ish counts with the TOTAL near (but under) the documented
    # 2^28 per-table limit — beyond it the INF clamp may reorder ties and
    # the encoder must route such images through the host table build
    hist = np.zeros(256, np.int64)
    hist[:24] = (2.0 ** np.arange(24)).astype(np.int64)  # sums to 2^24-1
    hist[0] = 240_000_000  # total ~256M < 2^28
    assert hist.sum() < 1 << 28
    _assert_match(hist)


def test_real_image_histograms(fixtures_dir):
    from dmmt_jpeg_encoder.config import EncoderConfig
    from dmmt_jpeg_encoder.io.ppm import read_ppm
    from dmmt_jpeg_encoder.pipeline import run_device_pipeline
    from dmmt_jpeg_encoder.tables import quantization_table_pair
    from dmmt_jpeg_encoder.config import QuantizationTablePreset

    img = read_ppm(fixtures_dir / "500x500.ppm")
    lq, cq = quantization_table_pair(QuantizationTablePreset.SPECIFICATION)
    res = run_device_pipeline(img.pixels, img.maxval, EncoderConfig(), lq, cq)
    for hist in (
        pad_dc_histogram(jnp.asarray(np.asarray(res.luma_dc_hist))),
        jnp.asarray(np.asarray(res.luma_ac_hist)),
        pad_dc_histogram(jnp.asarray(np.asarray(res.chroma_dc_hist))),
        jnp.asarray(np.asarray(res.chroma_ac_hist)),
    ):
        _assert_match(np.asarray(hist))


def test_comb_tables_match_host():
    """device_comb_tables (device-built tables -> the packer's combined
    code<<8|len lookups) equals combine_tables over the host tables."""
    from dmmt_jpeg_encoder.bitstream.device_pack import (
        combine_tables,
        device_comb_tables,
    )

    rng = np.random.default_rng(5)
    hists = []
    for n_bins, n_present in ((16, 7), (256, 40), (16, 11), (256, 55)):
        h = np.zeros(256, np.int64)
        h[rng.choice(n_bins, n_present, replace=False)] = rng.integers(
            1, 1000, n_present
        )
        hists.append(h)
    host = [_host_tables(h) for h in hists]
    dev = [device_code_tables(jnp.asarray(h, jnp.int32)) for h in hists]
    dc, ac = device_comb_tables(*dev)
    want_dc = np.concatenate(
        [combine_tables(host[i][1][:16], host[i][2][:16]) for i in (0, 2)]
    )
    want_ac = np.concatenate(
        [combine_tables(host[i][1], host[i][2]) for i in (1, 3)]
    )
    np.testing.assert_array_equal(np.asarray(dc), want_dc)
    np.testing.assert_array_equal(np.asarray(ac), want_ac)

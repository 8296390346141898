"""Device-side scan packing must be BYTE-IDENTICAL to the host C/Python
packers (which in turn mirror the reference's serial BitWriter emission)."""

import numpy as np
import jax.numpy as jnp
import pytest

from dmmt_jpeg_encoder import (
    ChromaSubsamplingPreset,
    EncoderConfig,
    encode_array,
)
from dmmt_jpeg_encoder.bitstream.device_pack import (
    device_pack_scan,
    finalize_scan_bytes,
    _interleave_scan,
    scan_table_index,
)
from dmmt_jpeg_encoder.bitstream.packer import encode_scan
from dmmt_jpeg_encoder.entropy.categorize import symbol_histograms
from dmmt_jpeg_encoder.huffman.canonical import flat_code_arrays
from dmmt_jpeg_encoder.huffman.spec import code_lengths_from_histogram


def _tables_for(blocks_list):
    dc = np.zeros(16, np.int64)
    ac = np.zeros(256, np.int64)
    for blocks in blocks_list:
        d, a = symbol_histograms(jnp.asarray(blocks))
        dc += np.asarray(d)
        ac += np.asarray(a)
    return (
        flat_code_arrays(code_lengths_from_histogram(dc)),
        flat_code_arrays(code_lengths_from_histogram(ac)),
    )


def _random_blocks(rng, n, density=0.12):
    blocks = np.zeros((n, 64), dtype=np.int16)
    mask = rng.random((n, 64)) < density
    blocks[mask] = rng.integers(-800, 800, mask.sum())
    return blocks


def _interleave_order(n_luma, n_chroma, lpm):
    """Scan order of the concatenated [luma; cb; cr] block indices, as
    _interleave_scan lays the blocks out, plus the code-table set of each
    scan position (0 luma, 1 chroma)."""
    ids = np.arange(n_luma + 2 * n_chroma, dtype=np.int32)
    blocks = np.repeat(ids[:, None], 64, axis=1)
    scan = _interleave_scan(
        jnp.asarray(blocks[:n_luma]),
        jnp.asarray(blocks[n_luma : n_luma + n_chroma]),
        jnp.asarray(blocks[n_luma + n_chroma :]),
        n_chroma, lpm,
    )
    order = np.asarray(scan)[:, 0].tolist()
    return order, scan_table_index(len(order), lpm + 2, lpm).tolist()


def test_scan_order_permutation_p420():
    order, table = _interleave_order(8, 2, 4)
    # MCU: 4 luma, cb, cr
    assert order == [0, 1, 2, 3, 8, 10, 4, 5, 6, 7, 9, 11]
    assert table == [0, 0, 0, 0, 1, 1, 0, 0, 0, 0, 1, 1]


def test_scan_order_permutation_p444():
    order, table = _interleave_order(3, 3, 1)
    assert order == [0, 3, 6, 1, 4, 7, 2, 5, 8]
    assert table == [0, 1, 1, 0, 1, 1, 0, 1, 1]


def test_finalize_pads_with_ones():
    # finalize consumes byte-order words (the device byteswaps); 12 bits:
    # one full byte + 4 bits -> final byte low 4 bits = 1111
    words = np.array([0xABC00000], dtype=np.uint32).byteswap()
    out = finalize_scan_bytes(words, 12)
    assert out == bytes([0xAB, 0xCF])


def test_finalize_stuffs_ff():
    words = np.array([0xFF12FF00], dtype=np.uint32).byteswap()
    out = finalize_scan_bytes(words, 32)
    assert out == bytes([0xFF, 0x00, 0x12, 0xFF, 0x00, 0x00])


def test_byteswap_words_roundtrip():
    from dmmt_jpeg_encoder.bitstream.device_pack import byteswap_words
    import jax.numpy as jnp

    w = np.array([0x01020304, 0xFFB0C0D0, 0], dtype=np.uint32)
    s = np.asarray(byteswap_words(jnp.asarray(w)))
    np.testing.assert_array_equal(s, w.byteswap())


@pytest.mark.parametrize("luma_per_mcu", [1, 2, 4])
def test_device_matches_host_packer(rng, luma_per_mcu):
    n_mcu = 17
    luma = _random_blocks(rng, n_mcu * luma_per_mcu)
    cb = _random_blocks(rng, n_mcu)
    cr = _random_blocks(rng, n_mcu)
    ldc, lac = _tables_for([luma])
    cdc, cac = _tables_for([cb, cr])
    host = encode_scan(
        luma, cb, cr, luma_per_mcu, ldc, lac, cdc, cac, use_native=False
    )
    dev = device_pack_scan(
        jnp.asarray(luma), jnp.asarray(cb), jnp.asarray(cr),
        luma_per_mcu, ldc, lac, cdc, cac,
    )
    assert dev == host


def test_device_pack_long_zero_runs(rng):
    """Blocks engineered to hit multiple ZRLs and EOB edge cases."""
    luma = np.zeros((6, 64), dtype=np.int16)
    luma[0, 0] = 5            # DC only -> EOB
    luma[1, 63] = -3          # single nonzero at the end -> no EOB, 3 ZRLs
    luma[2, 0] = -9
    luma[2, 17] = 1           # run of 16 -> one ZRL
    luma[2, 34] = -1          # another run of 16
    luma[3, 1] = 2            # immediate AC
    luma[4, 32] = 7           # run 31 -> ZRL + (15, cat)
    luma[5, 62] = 1           # run 61 -> 3 ZRL + (13, cat), then EOB
    ldc, lac = _tables_for([luma])
    host = encode_scan(luma, None, None, 1, ldc, lac, None, None, use_native=False)
    dev = device_pack_scan(jnp.asarray(luma), None, None, 1, ldc, lac, None, None)
    assert dev == host


def test_exact_scan_bits_matches_device_count(rng):
    """Host-computed stream length (histograms x code lengths) must equal
    the device's actual packed bit count."""
    from dmmt_jpeg_encoder.bitstream.device_pack import exact_scan_bits

    n_mcu = 9
    luma = _random_blocks(rng, n_mcu * 2)
    cb = _random_blocks(rng, n_mcu)
    cr = _random_blocks(rng, n_mcu)
    ldc, lac = _tables_for([luma])
    cdc, cac = _tables_for([cb, cr])
    ldc_h, lac_h = (np.asarray(h) for h in symbol_histograms(jnp.asarray(luma)))
    cb_dc, cb_ac = (np.asarray(h) for h in symbol_histograms(jnp.asarray(cb)))
    cr_dc, cr_ac = (np.asarray(h) for h in symbol_histograms(jnp.asarray(cr)))
    bits = exact_scan_bits(
        (ldc_h, lac_h, cb_dc + cr_dc, cb_ac + cr_ac), ldc, lac, cdc, cac
    )
    with_known = device_pack_scan(
        jnp.asarray(luma), jnp.asarray(cb), jnp.asarray(cr),
        2, ldc, lac, cdc, cac, known_bits=bits,
    )
    without = device_pack_scan(
        jnp.asarray(luma), jnp.asarray(cb), jnp.asarray(cr),
        2, ldc, lac, cdc, cac,
    )
    assert with_known == without


@pytest.mark.parametrize("preset", list(ChromaSubsamplingPreset))
def test_e2e_device_backend_matches_host(rng, preset):
    pixels = rng.integers(0, 256, (40, 56, 3), dtype=np.uint16)
    host = encode_array(
        pixels, 255, EncoderConfig(chroma_subsampling=preset, scan_backend="host")
    )
    dev = encode_array(
        pixels, 255, EncoderConfig(chroma_subsampling=preset, scan_backend="device")
    )
    assert dev == host

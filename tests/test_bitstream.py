"""BitWriter / byte stuffing / scan packer tests (reference behavior:
binary_stream.rs:99-159, segment_marker_injector.rs, encoder.rs:264-404)."""

import numpy as np
import pytest

from dmmt_jpeg_encoder.bitstream.bitwriter import BitWriter, byte_stuff
from dmmt_jpeg_encoder.bitstream.packer import encode_scan
from dmmt_jpeg_encoder.huffman.canonical import flat_code_arrays
from dmmt_jpeg_encoder.huffman.spec import code_lengths_from_histogram
from dmmt_jpeg_encoder.utils.native import load_native


def test_bitwriter_msb_first():
    w = BitWriter()
    w.write_bits(0b1, 1)
    w.write_bits(0b01, 2)
    w.write_bits(0b10110, 5)
    assert w.getvalue() == bytes([0b10110110])


def test_bitwriter_flush_zero_padding():
    w = BitWriter(flush_with_ones=False)
    w.write_bits(0b101, 3)
    w.flush()
    assert w.getvalue() == bytes([0b10100000])


def test_bitwriter_flush_one_padding():
    w = BitWriter(flush_with_ones=True)
    w.write_bits(0b101, 3)
    w.flush()
    assert w.getvalue() == bytes([0b10111111])


def test_bitwriter_cross_byte_pattern():
    # The reference's bit_writer_example: a 10-bit pattern repeated is
    # periodic every 5 bytes (lcm(10, 8) = 40 bits).
    w = BitWriter()
    for _ in range(8):
        w.write_bits(0b1010110011, 10)
    out = w.getvalue()
    assert len(out) == 10
    assert out[:5] == out[5:]


def test_bitwriter_aligned_bytes():
    w = BitWriter()
    w.write_bytes(b"\xab\xcd")
    assert w.getvalue() == b"\xab\xcd"
    assert w.bit_length == 16


def test_byte_stuffing():
    assert byte_stuff(b"\x12\xff\x34") == b"\x12\xff\x00\x34"
    assert byte_stuff(b"\xff\xff") == b"\xff\x00\xff\x00"
    assert byte_stuff(b"") == b""


def _tables_for(blocks_list):
    """Build valid per-image tables covering every symbol in the blocks."""
    from dmmt_jpeg_encoder.entropy.categorize import symbol_histograms
    import jax.numpy as jnp

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


def _random_blocks(rng, n, density=0.1):
    blocks = np.zeros((n, 64), dtype=np.int16)
    mask = rng.random((n, 64)) < density
    blocks[mask] = rng.integers(-500, 500, mask.sum())
    return blocks


@pytest.mark.parametrize("luma_per_mcu", [1, 2, 4])
def test_native_matches_python_packer(rng, luma_per_mcu):
    if load_native() is None:
        pytest.skip("no C toolchain")
    n_mcu = 13
    luma = _random_blocks(rng, n_mcu * luma_per_mcu)
    cb = _random_blocks(rng, n_mcu)
    cr = _random_blocks(rng, n_mcu)
    ldc, lac = _tables_for([luma])
    cdc, cac = _tables_for([cb, cr])
    a = encode_scan(luma, cb, cr, luma_per_mcu, ldc, lac, cdc, cac, use_native=True)
    b = encode_scan(luma, cb, cr, luma_per_mcu, ldc, lac, cdc, cac, use_native=False)
    assert a == b
    assert len(a) > 0


def test_packer_stuffs_and_pads(rng):
    luma = _random_blocks(rng, 4, density=0.5)
    ldc, lac = _tables_for([luma])
    out = encode_scan(luma, None, None, 1, ldc, lac, None, None, use_native=False)
    # no bare 0xFF without a following 0x00
    i = 0
    while i < len(out):
        if out[i] == 0xFF:
            assert i + 1 < len(out) and out[i + 1] == 0x00
            i += 2
        else:
            i += 1


def test_packer_decodes_back(rng):
    """Scan bytes decode back to the original symbol stream."""
    from dmmt_jpeg_encoder.huffman.decoder import BitReader, HuffmanDecoder
    from dmmt_jpeg_encoder.entropy.categorize import symbol_histograms
    import jax.numpy as jnp

    luma = _random_blocks(rng, 8)
    dc_hist, ac_hist = (np.asarray(x) for x in symbol_histograms(jnp.asarray(luma)))
    dc_table = code_lengths_from_histogram(dc_hist)
    ac_table = code_lengths_from_histogram(ac_hist)
    out = encode_scan(
        luma, None, None, 1,
        flat_code_arrays(dc_table), flat_code_arrays(ac_table),
        None, None, use_native=False,
    )
    # un-stuff
    raw = out.replace(b"\xff\x00", b"\xff")
    dc_dec = HuffmanDecoder(dc_table)
    ac_dec = HuffmanDecoder(ac_table)
    r = BitReader(raw)
    for blk in luma:
        cat = dc_dec.decode_symbol(r)
        got = r.read_bits(cat)
        v = int(blk[0])
        exp = v if v >= 0 else (1 << cat) - 1 - abs(v)
        assert got == exp
        k = 1
        while k < 64:
            sym = ac_dec.decode_symbol(r)
            if sym == 0x00:  # EOB
                assert all(int(x) == 0 for x in blk[k:])
                break
            run, acat = sym >> 4, sym & 15
            if acat == 0:
                assert sym == 0xF0  # ZRL = 16 zeros
                assert all(int(x) == 0 for x in blk[k : k + 16])
                k += 16
                continue
            k += run
            bits = r.read_bits(acat)
            v = int(blk[k])
            exp = v if v >= 0 else (1 << acat) - 1 - abs(v)
            assert bits == exp
            k += 1

"""Literal expected-output vectors harvested from the reference's unit
tests (VERDICT r3 #10): with no Rust toolchain in this environment, these
constants are the closest available ground truth for the BASELINE
bit-exactness clause. Each test cites the reference test it mirrors.

REFERENCE-TEST AUDIT (VERDICT r4 #6) — every inline #[cfg(test)] block in
/root/reference/src mapped to the repo test that covers it:

| reference test block | repo coverage |
|---|---|
| color.rs:109-132 convert_rgb_to_ycbcr | here: test_color_mixed_vector |
| color.rs:134-157 convert_rgb_white_to_ycbcr | test_color.py::test_white + here: test_color_white_bounds |
| color.rs:159-171 convert_rgb_black_to_ycbcr | test_color.py::test_black (exact -128/0/0) |
| color.rs:173-189 convert_range_color_to_rgb | here: test_range_color_normalization |
| color.rs:191-199 convert_range_color_white_to_rgb | here: test_range_color_normalization |
| color.rs:201-213 convert_range_color_4bit_to_rgb | here: test_range_color_normalization |
| color.rs:215-219 create_range_color_out_of_range (panic) | test_ppm.py::test_value_above_maxval_rejected (ColorOutOfRange) |
| color.rs:221+ create_range_color | test_ppm.py (valid 16-bit maxval reads) |
| image/reader/ppm.rs:253-307 (5 tests) | test_ppm.py (tokenizer, header, comments, size/triple validation) |
| image/subsampling.rs:332-354 no_subsampling_test | here: test_subsampling_vectors |
| image/subsampling.rs:356-377 skip_subsampling_test | here: test_subsampling_vectors |
| image/subsampling.rs:379-400 average_subsampling_test | here: test_subsampling_vectors |
| image/subsampling.rs:402-419 out_of_bounds_high | here: test_subsampling_vectors (output width = ceil(4/2) = 2) |
| image/subsampling.rs:421-442 repeat_border_test | here: test_subsampling_vectors (ceil rows + border clamp) |
| image/subsampling.rs:444-462 test_block_iter_with_single_fit_image | here: test_square_structure_vectors + test_geometry.py::test_blockize_raster_block_order |
| image/subsampling.rs:464-493 square_resorter 1x1 | here: test_square_structure_vectors (literal 64-vector) |
| image/subsampling.rs:495-521 square_resorter 2x2 | here: test_square_structure_vectors (literal 16-vector) |
| image/subsampling.rs:523-551 square_resorter 1x2 | here: test_square_structure_vectors (literal 32-vector) |
| cli.rs:182-296 (7 tests) | test_cli.py (defaults, aliases, threads, enum parsing) |
| binary_stream.rs:104-117 byte_mode_test | here: test_bitwriter_byte_mode |
| binary_stream.rs:119-132 bit_mode_test | here: test_bitwriter_bit_mode |
| binary_stream.rs:134-148 mixed_mode_test | here: test_bitwriter_mixed_mode |
| binary_stream.rs:150-158 one_padding_test | here: test_bitwriter_one_padding + test_bitstream.py::test_bitwriter_flush_one_padding |
| huffman/length_limited.rs:209-264 (4 vector/panic tests) | here: test_generate_one/two/three/too_long_input_array |
| huffman/length_limited.rs:136-207,266-330 (property tests) | test_huffman.py (package-merge classic/limit/uniform/unsorted/overflow/Kraft) |
| huffman/encoder.rs:198-211 (2 panic tests) | here: test_translator_rejects_unsorted / _rejects_length_over_16 |
| huffman/encoder.rs:213-269 test_coder_encode (byte golden) | here: test_coder_encode_byte_sequence |
| huffman/tree.rs:286-556 (12 tests) | test_huffman_tree.py (one test per reference test, same order: depths even/odd/onestar, first-occurrence index x2, max-depth, higher-freq-not-deeper x2, node-index x2, encode->decode round trip, right-subtree depth) |
| .../transformer/categorize.rs:171-290 (6 tests) | test_entropy.py (magnitude categories, DPCM chain, AC RLE vs brute force) |
| .../transformer/block_entangler.rs:93-166 (4 tests) | test_geometry.py::test_entangle_* (quad order, pass-through, odd rejection) |
| .../transformer/frequency_block.rs:67-101 (2 tests) | test_quantize.py zigzag goldens + test_container.py::test_dqt_zigzag_order |
| .../transformer/symbol_counting.rs:~180 (1 test) | test_huffman.py::test_code_lengths_from_histogram_plus_one_bump |
| .../transformer/quantizer.rs (inline) | test_quantize.py (half-away rounding, cycle zip, partial-block drop) |
| .../jpeg/padder.rs (3 tests) | test_geometry.py::test_padded_size / test_pad_fills_black |
| .../jpeg/encoder.rs:407-578 (8 segment goldens) | test_container.py (APP0/SOF0/SOS goldens) + here: test_write_quantization_table_id2 |
| .../jpeg/segment_marker_injector.rs (1 test) | test_bitstream.py::test_byte_stuffing |
| .../encoder/block_fold_iterator.rs (inline) | test_device_pack.py scan-interleave tests (P444/P422/P420 patterns) |
| cosine_transform/{simple,separated,arai}.rs (4 tests) | test_dct.py (variants vs simple, IDCT round trips, Arai closed forms) |
| tests/convert_ppm_to_jpeg.rs:31-43 (integration) | test_e2e.py (encode fixtures + independent PIL decode — stronger than the reference's exists-check) |
"""

import numpy as np
import pytest

from dmmt_jpeg_encoder.bitstream.bitwriter import BitWriter
from dmmt_jpeg_encoder.container import dqt
from dmmt_jpeg_encoder.errors import (
    HuffmanCodeTooLong,
    HuffmanDepthOverflow,
    HuffmanUnsortedInput,
)
from dmmt_jpeg_encoder.huffman.canonical import canonical_codes
from dmmt_jpeg_encoder.huffman.package_merge import package_merge_lengths
from dmmt_jpeg_encoder.huffman.spec import SymbolCodeLength
from dmmt_jpeg_encoder.tables import quantization_table_pair
from dmmt_jpeg_encoder.config import QuantizationTablePreset


# --- length_limited.rs generate() vectors ---------------------------------


def test_generate_one():
    """reference: src/huffman/length_limited.rs:209-223 (test_generate_one)."""
    freqs = [1, 2, 5, 8, 10, 11, 14, 14, 15, 18, 20]
    assert package_merge_lengths(freqs, 4) == [4, 4, 4, 4, 4, 4, 3, 3, 3, 3, 3]


def test_generate_two():
    """reference: src/huffman/length_limited.rs:225-239 (test_generate_two)."""
    freqs = [1, 1, 1, 2, 2, 2, 3, 6, 17, 20]
    assert package_merge_lengths(freqs, 5) == [5, 5, 4, 4, 4, 4, 4, 3, 2, 2]


def test_generate_three():
    """reference: src/huffman/length_limited.rs:241-255 (test_generate_three)."""
    freqs = [1, 1, 1, 2, 2, 2, 3, 6, 17, 20]
    assert package_merge_lengths(freqs, 4) == [4, 4, 4, 4, 4, 4, 4, 4, 2, 2]


def test_generate_too_long_input_array():
    """reference: src/huffman/length_limited.rs:257-264 (should_panic)."""
    freqs = [1, 1, 1, 2, 2, 2, 3, 6, 17, 20]
    with pytest.raises(HuffmanDepthOverflow):
        package_merge_lengths(freqs, 3)


# --- huffman/encoder.rs translator vectors --------------------------------


def test_translator_rejects_unsorted():
    """reference: src/huffman/encoder.rs:198-204 (test_unsorted_symbols)."""
    scl = [SymbolCodeLength(s, l) for s, l in [(0, 1), (1, 5), (2, 4), (3, 3)]]
    with pytest.raises(HuffmanUnsortedInput):
        canonical_codes(scl)


def test_translator_rejects_length_over_16():
    """reference: src/huffman/encoder.rs:206-211 (test_max_code_length_too_long)."""
    scl = [SymbolCodeLength(s, l) for s, l in [(0, 17), (1, 5), (2, 4), (3, 3)]]
    with pytest.raises(HuffmanCodeTooLong):
        canonical_codes(scl)


# reference: src/huffman/encoder.rs:213-230 (TEST_SYMBOL_SEQUENCE /
# TEST_BYTE_SEQUENCE / SYMBOLS_AND_FREQUENCIES_ODD_LEN)
TEST_SYMBOL_SEQUENCE = [
    27, 17, 7, 31, 22, 12, 2, 29, 21, 19, 11, 9, 1, 30, 25, 15, 5, 24, 14,
    4, 20, 10, 26, 23, 16, 13, 6, 3, 32, 28, 18, 8,
]
TEST_BYTE_SEQUENCE = bytes([
    0b00000100, 0b01101000, 0b10101100, 0b11110000, 0b10001100, 0b10100111,
    0b01001010, 0b11011010, 0b11101011, 0b11110000, 0b11000111, 0b00101100,
    0b11110100, 0b11010111, 0b01101101, 0b11111000, 0b11100111, 0b10101110,
    0b11111100, 0b11110111, 0b11101111, 0b11000000,
])
SYMBOLS_AND_FREQUENCIES_ODD_LEN = [
    (1, 14), (2, 30), (3, 4), (4, 7), (5, 9), (6, 4), (7, 42), (8, 1),
    (9, 14), (10, 5), (11, 14), (12, 30), (13, 4), (14, 7), (15, 9),
    (16, 4), (17, 42), (18, 1), (19, 14), (20, 5), (21, 14), (22, 30),
    (23, 4), (24, 7), (25, 9), (26, 4), (27, 42), (28, 1), (29, 14),
    (30, 12), (31, 32), (32, 1),
]


def test_coder_encode_byte_sequence():
    """reference: src/huffman/encoder.rs:244-269 (test_coder_encode): the
    full chain — stable sort by frequency, package-merge at limit 6,
    lengths[0] += 1 bump, canonical translation, MSB-first bit packing
    with ZERO flush padding — must reproduce the committed 22-byte
    stream exactly."""
    sorted_syms = sorted(SYMBOLS_AND_FREQUENCIES_ODD_LEN, key=lambda x: x[1])
    lengths = package_merge_lengths([f for _, f in sorted_syms], 6)
    scl = [
        SymbolCodeLength(sym, ln)
        for (sym, _), ln in zip(sorted_syms, lengths)
    ]
    scl[0] = SymbolCodeLength(scl[0].symbol, scl[0].length + 1)
    codes = canonical_codes(scl)
    bw = BitWriter(flush_with_ones=False)
    for s in TEST_SYMBOL_SEQUENCE:
        cw = codes[s]
        bw.write_bits(cw.bits, cw.length)
    bw.flush()
    assert bw.getvalue() == TEST_BYTE_SEQUENCE


# --- encoder.rs segment vectors -------------------------------------------


def test_write_quantization_table_id2():
    """reference: src/image/writer/jpeg/encoder.rs:520-538
    (test_write_quantization): DQT with table id 2 and the Specification
    luma table, entries in zigzag order."""
    luma, _ = quantization_table_pair(QuantizationTablePreset.SPECIFICATION)
    expected = bytes([
        0xFF, 0xDB, 0x00, 0x43, 0x02, 16, 11, 12, 14, 12, 10, 16, 14, 13,
        14, 18, 17, 16, 19, 24, 40, 26, 24, 22, 22, 24, 49, 35, 37, 29, 40,
        58, 51, 61, 60, 57, 51, 56, 55, 64, 72, 92, 78, 64, 68, 87, 69, 55,
        56, 80, 109, 81, 87, 95, 98, 103, 104, 103, 62, 77, 113, 121, 112,
        100, 120, 92, 101, 103, 99,
    ])
    assert dqt(2, np.asarray(luma)) == expected


# --- color.rs conversion vectors (VERDICT r4 #6 harvest) ------------------


def _ycbcr_one(r, g, b):
    import jax.numpy as jnp

    from dmmt_jpeg_encoder.ops.color import rgb_to_ycbcr

    y, cb, cr = rgb_to_ycbcr(jnp.asarray([[[r, g, b]]], dtype=jnp.float32))
    return float(y[0, 0]), float(cb[0, 0]), float(cr[0, 0])


def test_color_mixed_vector():
    """reference: src/color.rs:109-132 (convert_rgb_to_ycbcr): rgb
    (0.25, 0.75, 0.333) -> luma in [12.95, 13.05), cb in [-31.68, -31.58),
    cr in [-55.13, -55.03)."""
    y, cb, cr = _ycbcr_one(0.25, 0.75, 0.333)
    assert 12.95 <= y < 13.05, y
    assert -31.68 <= cb < -31.58, cb
    assert -55.13 <= cr < -55.03, cr


def test_color_white_bounds():
    """reference: src/color.rs:134-157 (convert_rgb_white_to_ycbcr):
    white -> luma 127 within 1e-5, |chroma| <= 0.5."""
    y, cb, cr = _ycbcr_one(1.0, 1.0, 1.0)
    assert 126.99999 <= y <= 127.00001, y
    assert -0.5 <= cb <= 0.5, cb
    assert -0.5 <= cr <= 0.5, cr


def test_range_color_normalization():
    """reference: src/color.rs:173-213 (convert_range_color_to_rgb /
    _white_ / _4bit_): RangeColorFormat(max, r, g, b) normalizes each
    component to value/max in f32. The framework analog is
    PPMImage.normalized() (and the identical pixels/maxval division baked
    into every device program)."""
    from dmmt_jpeg_encoder.io.ppm import PPMImage

    def norm(maxval, r, g, b):
        img = PPMImage(
            width=1, height=1, maxval=maxval,
            pixels=np.array([[[r, g, b]]], np.uint16),
        )
        return img.normalized()[0, 0]

    r, g, b = norm(17734, 128, 14355, 9)
    assert 7.209e-3 <= r <= 7.219e-3, r
    assert 0.809459 <= g <= 0.809469, g
    assert 4.99e-4 <= b <= 5.09e-4, b

    r, g, b = norm(65535, 65535, 65535, 65535)
    assert (r, g, b) == (1.0, 1.0, 1.0)

    r, g, b = norm(0b1111, 0b0010, 0b0101, 0b1111)
    assert 0.133333 <= r <= 0.133334, r
    assert 0.333333 <= g <= 0.333334, g
    assert b == 1.0


# --- subsampling.rs vectors (VERDICT r4 #6 harvest) -----------------------

_CHAN4 = np.arange(1.0, 17.0, dtype=np.float32).reshape(4, 4)
_CHAN8 = np.arange(1.0, 65.0, dtype=np.float32).reshape(8, 8)


def _subsample(chan, hr, vr, method):
    import jax.numpy as jnp

    from dmmt_jpeg_encoder.config import SubsamplingMethod
    from dmmt_jpeg_encoder.ops.geometry import subsample_generalized

    m = SubsamplingMethod.SKIP if method == "skip" else SubsamplingMethod.AVERAGE
    return np.asarray(subsample_generalized(jnp.asarray(chan), hr, vr, m))


def test_subsampling_vectors():
    """reference: src/image/subsampling.rs:332-442 — the five iterator
    vector tests on the 4x4 ramp channel."""
    # no_subsampling_test (332): 1x1 Skip, out[1][2] == 7.0
    assert _subsample(_CHAN4, 1, 1, "skip")[1, 2] == 7.0
    # skip_subsampling_test (356): 2x1 Skip, out[1][1] == 7.0
    assert _subsample(_CHAN4, 2, 1, "skip")[1, 1] == 7.0
    # average_subsampling_test (379): 1x2 Average, out[1][1] == 12.0
    assert _subsample(_CHAN4, 1, 2, "avg")[1, 1] == 12.0
    # out_of_bounds_high (402): 2x1 on width 4 -> exactly 2 columns
    assert _subsample(_CHAN4, 2, 1, "avg").shape[1] == 2
    # repeat_border_test (421): 2x3 Average with border clamp; the rate-3
    # row view yields ceil(4/3) = 2 rows, out[1][1] == 15.5
    got = _subsample(_CHAN4, 2, 3, "avg")
    assert got.shape == (2, 2)
    assert got[1, 1] == 15.5


def test_square_structure_vectors():
    """reference: src/image/subsampling.rs:444-551 — the block-major
    re-sort ("square structure") literal vectors, block size 4.
    subsample_to_square_structure == subsample then blockize; the repo
    blockize is 8x8-only (the JPEG path), so the 4x4-square re-sort is
    expressed with the same reshape/transpose scheme."""

    def square4(chan):
        h, w = chan.shape
        return (
            chan.reshape(h // 4, 4, w // 4, 4)
            .transpose(0, 2, 1, 3)
            .reshape(-1)
        )

    # test_block_iter_with_single_fit_image (444): 4x4 channel is itself
    np.testing.assert_array_equal(
        square4(_subsample(_CHAN4, 1, 1, "skip")), _CHAN4.reshape(-1)
    )
    # square_resorter 1x1 (464)
    exp_1x1 = np.array(
        [1, 2, 3, 4, 9, 10, 11, 12, 17, 18, 19, 20, 25, 26, 27, 28,
         5, 6, 7, 8, 13, 14, 15, 16, 21, 22, 23, 24, 29, 30, 31, 32,
         33, 34, 35, 36, 41, 42, 43, 44, 49, 50, 51, 52, 57, 58, 59, 60,
         37, 38, 39, 40, 45, 46, 47, 48, 53, 54, 55, 56, 61, 62, 63, 64],
        np.float32,
    )
    np.testing.assert_array_equal(
        square4(_subsample(_CHAN8, 1, 1, "skip")), exp_1x1
    )
    # square_resorter 2x2 Skip (495)
    exp_2x2 = np.array(
        [1, 3, 5, 7, 17, 19, 21, 23, 33, 35, 37, 39, 49, 51, 53, 55],
        np.float32,
    )
    np.testing.assert_array_equal(
        square4(_subsample(_CHAN8, 2, 2, "skip")), exp_2x2
    )
    # square_resorter 1x2 Skip (523)
    exp_1x2 = np.array(
        [1, 2, 3, 4, 17, 18, 19, 20, 33, 34, 35, 36, 49, 50, 51, 52,
         5, 6, 7, 8, 21, 22, 23, 24, 37, 38, 39, 40, 53, 54, 55, 56],
        np.float32,
    )
    np.testing.assert_array_equal(
        square4(_subsample(_CHAN8, 1, 2, "skip")), exp_1x2
    )


# --- binary_stream.rs vectors (VERDICT r4 #6 harvest) ---------------------


def test_bitwriter_byte_mode():
    """reference: src/binary_stream.rs:104-117 (byte_mode_test)."""
    bw = BitWriter(flush_with_ones=False)
    bw.write_bytes(bytes([72, 65, 76, 76, 79]))
    bw.flush()
    assert bw.getvalue() == bytes([72, 65, 76, 76, 79])


def test_bitwriter_bit_mode():
    """reference: src/binary_stream.rs:119-132 (bit_mode_test): the
    reference writes the TOP `count` bits of each byte operand; the repo
    BitWriter takes the value right-aligned — same emitted stream."""
    bw = BitWriter(flush_with_ones=False)
    bw.write_bits(0b11, 2)     # top 2 of 0xFF
    bw.write_bits(0b0000, 4)   # top 4 of 0x00
    bw.write_bits(0b11, 2)
    bw.write_bits(0b1111, 4)
    bw.flush()
    assert bw.getvalue() == bytes([195, 15 << 4])


def test_bitwriter_mixed_mode():
    """reference: src/binary_stream.rs:134-148 (mixed_mode_test): 3 bits
    then whole bytes, crossing byte boundaries."""
    bw = BitWriter(flush_with_ones=False)
    bw.write_bits(0b111, 3)
    bw.write_bytes(bytes([1, 2, 4 | 128]))
    bw.flush()
    assert bw.getvalue() == bytes([224, 32, 80, 128])


def test_bitwriter_one_padding():
    """reference: src/binary_stream.rs:150-158 (one_padding_test): 3 zero
    bits + ones flush -> 0b00011111."""
    bw = BitWriter(flush_with_ones=True)
    bw.write_bits(0b000, 3)
    bw.flush()
    assert bw.getvalue() == bytes([31])

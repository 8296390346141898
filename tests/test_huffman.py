"""Huffman table construction tests (reference test strategy:
length_limited.rs:136-330, huffman/encoder.rs:188-269, tree.rs round trips)."""

import numpy as np
import pytest

from dmmt_jpeg_encoder.errors import (
    HuffmanDepthOverflow,
    HuffmanUnsortedInput,
)
from dmmt_jpeg_encoder.huffman.canonical import (
    canonical_codes,
    dht_payload,
    flat_code_arrays,
)
from dmmt_jpeg_encoder.huffman.decoder import BitReader, HuffmanDecoder
from dmmt_jpeg_encoder.huffman.package_merge import package_merge_lengths
from dmmt_jpeg_encoder.huffman.spec import (
    SymbolCodeLength,
    code_lengths_from_histogram,
)
from dmmt_jpeg_encoder.bitstream.bitwriter import BitWriter


def kraft(lengths):
    return sum(2.0 ** -l for l in lengths if l > 0)


def test_package_merge_two_symbols():
    assert package_merge_lengths([1, 1], 15) == [1, 1]


def test_package_merge_classic():
    # freqs 1,1,2,3,5 -> optimal Huffman lengths 4,4,3,2,1 (ascending freq)
    lengths = package_merge_lengths([1, 1, 2, 3, 5], 15)
    assert lengths == [4, 4, 3, 2, 1]
    assert kraft(lengths) <= 1.0 + 1e-12


def test_package_merge_limit_forces_shallower():
    # Fibonacci-ish freqs would give depth 5 unlimited; limit 3 flattens.
    lengths = package_merge_lengths([1, 1, 2, 3, 5, 8], 3)
    assert max(lengths) <= 3
    assert kraft(lengths) <= 1.0 + 1e-12
    # still a prefix-complete optimal assignment: lengths non-increasing
    assert lengths == sorted(lengths, reverse=True)


def test_package_merge_uniform():
    lengths = package_merge_lengths([7] * 8, 15)
    assert lengths == [3] * 8


def test_package_merge_rejects_unsorted():
    with pytest.raises(HuffmanUnsortedInput):
        package_merge_lengths([3, 1, 2], 15)


def test_package_merge_rejects_overflow():
    with pytest.raises(HuffmanDepthOverflow):
        package_merge_lengths([1] * 9, 3)  # 2^3 = 8 < 9


def test_package_merge_kraft_random(rng):
    for _ in range(20):
        n = int(rng.integers(2, 200))
        freqs = sorted(int(x) for x in rng.integers(1, 10_000, n))
        lengths = package_merge_lengths(freqs, 15)
        assert max(lengths) <= 15
        assert kraft(lengths) <= 1.0 + 1e-12
        # longest codes go to the least frequent symbols
        assert lengths == sorted(lengths, reverse=True)


def test_code_lengths_from_histogram_plus_one_bump():
    hist = np.zeros(16, np.int64)
    hist[0] = 1
    hist[1] = 1
    hist[2] = 2
    out = code_lengths_from_histogram(hist)
    # ascending freq: symbols 0,1 (freq 1 each, stable order), then 2
    assert [s.symbol for s in out] == [0, 1, 2]
    # raw lengths 2,2,1 -> +1 bump on the first (longest) entry
    assert [s.length for s in out] == [3, 2, 1]


def test_single_symbol_table():
    hist = np.zeros(16, np.int64)
    hist[5] = 100
    out = code_lengths_from_histogram(hist)
    assert len(out) == 1
    # single symbol: raw length 0 -> bumped to 1 so a codeword exists
    assert out[0].symbol == 5
    assert out[0].length == 1


def test_canonical_assignment_golden():
    # descending lengths: shortest (last) gets pattern 0
    lens = [
        SymbolCodeLength(7, 3),
        SymbolCodeLength(8, 3),
        SymbolCodeLength(9, 2),
        SymbolCodeLength(1, 1),
    ]
    codes = canonical_codes(lens)
    assert (codes[1].bits, codes[1].length) == (0b0, 1)
    assert (codes[9].bits, codes[9].length) == (0b10, 2)
    assert (codes[8].bits, codes[8].length) == (0b110, 3)
    assert (codes[7].bits, codes[7].length) == (0b111, 3)


def test_canonical_rejects_ascending():
    from dmmt_jpeg_encoder.errors import HuffmanUnsortedInput as HU

    with pytest.raises(HU):
        canonical_codes([SymbolCodeLength(0, 1), SymbolCodeLength(1, 2)])


def test_all_ones_codeword_never_assigned(rng):
    """The +1 bump must keep the all-ones pattern free (JPEG 1-padding)."""
    for _ in range(10):
        hist = np.zeros(256, np.int64)
        n = int(rng.integers(2, 200))
        idx = rng.choice(256, n, replace=False)
        hist[idx] = rng.integers(1, 100_000, n)
        table = code_lengths_from_histogram(hist)
        for sym, cw in canonical_codes(table).items():
            assert cw.bits != (1 << cw.length) - 1, (
                f"symbol {sym} got all-ones codeword of length {cw.length}"
            )


def test_dht_payload_layout():
    lens = [
        SymbolCodeLength(7, 3),
        SymbolCodeLength(8, 3),
        SymbolCodeLength(9, 2),
        SymbolCodeLength(1, 1),
    ]
    payload = dht_payload(0x11, lens)
    assert payload[0] == 0x11
    counts = list(payload[1:17])
    assert counts == [1, 1, 2] + [0] * 13
    # symbols in ascending-length (reversed-list) order
    assert list(payload[17:]) == [1, 9, 8, 7]
    assert len(payload) == 1 + 16 + 4


def test_encode_decode_round_trip(rng):
    """Full loop: histogram -> lengths -> canonical codes -> bitstream ->
    debug decoder (the reference verifies via tree.decode_sequence)."""
    hist = np.zeros(256, np.int64)
    idx = rng.choice(256, 40, replace=False)
    hist[idx] = rng.integers(1, 1000, 40)
    table = code_lengths_from_histogram(hist)
    codes, lens = flat_code_arrays(table)

    symbols = rng.choice(idx, 500).tolist()
    w = BitWriter(flush_with_ones=True)
    for s in symbols:
        assert lens[s] > 0
        w.write_bits(codes[s], lens[s])
    w.flush()

    dec = HuffmanDecoder(table)
    assert dec.decode_sequence(w.getvalue(), len(symbols)) == symbols


def test_decoder_rejects_garbage():
    table = [SymbolCodeLength(3, 2), SymbolCodeLength(4, 2), SymbolCodeLength(5, 1)]
    dec = HuffmanDecoder(table)
    # all-ones byte cannot start a valid codeword here (codes 0,10,11 used;
    # wait 11 IS used) — craft a stream that exhausts instead
    r = BitReader(b"")
    with pytest.raises(Exception):
        dec.decode_symbol(r)

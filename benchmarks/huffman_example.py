"""Huffman construction round-trip demo (reference: src/bin/huffman_example.rs).

Builds a length-limited code from sample frequencies, applies the reference's
longest-code +1 bump, encodes a symbol stream, and decodes it back with the
debug decoder.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

from dmmt_jpeg_encoder.bitstream.bitwriter import BitWriter
from dmmt_jpeg_encoder.huffman.canonical import canonical_codes, flat_code_arrays
from dmmt_jpeg_encoder.huffman.decoder import HuffmanDecoder
from dmmt_jpeg_encoder.huffman.spec import code_lengths_from_histogram


def main() -> int:
    hist = np.zeros(16, dtype=np.int64)
    for sym, freq in [(0, 1), (1, 2), (2, 4), (3, 8), (4, 16), (5, 32)]:
        hist[sym] = freq

    table = code_lengths_from_histogram(hist)
    print("symbol lengths (descending):")
    for e in table:
        print(f"  symbol {e.symbol}: {e.length} bits")
    for sym, cw in sorted(canonical_codes(table).items()):
        print(f"  symbol {sym}: {cw.bits:0{cw.length}b}")

    codes, lens = flat_code_arrays(table)
    message = [5, 4, 3, 2, 1, 0, 1, 2, 3, 4, 5]
    w = BitWriter(flush_with_ones=True)
    for s in message:
        w.write_bits(codes[s], lens[s])
    w.flush()
    encoded = w.getvalue()
    print(f"encoded {len(message)} symbols into {len(encoded)} bytes: {encoded.hex()}")

    decoded = HuffmanDecoder(table).decode_sequence(encoded, len(message))
    print("decoded:", decoded)
    assert decoded == message, "round trip failed"
    print("round trip OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Parity oracle from the reference's hand-decoded bitstream worksheet
(VERDICT r2 #6).

`/root/reference/tests/decoding.txt` is the reference author's manual
bit-by-bit decode of their encoder's entropy scans — the only
ground-truth artifact in the reference tree that pins the *bit-level*
JPEG semantics (canonical Huffman codes, magnitude categories with
one's-complement negatives, EOB placement, MSB-first packing, 1-padding
of the final byte). These tests reproduce that worksheet mechanically:

1. The worksheet's "[new]" section gives explicit Huffman tables
   (decoding.txt lines "[luma] ac 0 = eob / ac&dc 0 = 00, 10 = 05" and
   "[chroma] ac 0 = eob / dc 0 = 00, 10 = 07, 110 = 05") and the stream
   `8a c9 50 00 00 07` with hand decode "(10.00 101)(0) ... -26 eob ..."
   ending in the padded nibble "0111". We decode the stream with our
   debug decoder primitives, assert the symbol/value sequence the
   worksheet records, then RE-ENCODE it through the production BitWriter
   and get the identical bytes (including the 1-padding, reference:
   src/image/writer/jpeg/encoder.rs:267).

2. The committed `tests/output_image.jpg` is the file whose scan
   `15 24 80` the worksheet hand-decodes as "-26 eob ? eob ? eob"
   (decoding.txt, "15 24 80" section; the author left the chroma values
   as '?'). We parse the real file, decode its scan with its own
   embedded tables, resolve the '?'s (-22 and +64), and re-encode to the
   exact 24-bit scan (no padding: 24 bits fill 3 bytes).

Note the committed fixtures come from an older reference build (chroma
DQT = luma table, DHT ids 0/1 instead of encoder.rs:78-84's 0/2 and
1/3), so whole-file byte parity is impossible by construction
(tests/test_goldens.py documents this); the SCAN-level bit semantics
are version-independent and are what these tests pin.
"""

from pathlib import Path

import pytest

from dmmt_jpeg_encoder.bitstream.bitwriter import BitWriter
from dmmt_jpeg_encoder.debug.jpeg_decoder import (
    _BitReader,
    _decode_symbol,
    _extend,
    parse_jpeg,
)

WORKSHEET = Path("/root/reference/tests/decoding.txt")
OUTPUT_IMAGE = Path("/root/reference/tests/output_image.jpg")

# Tables exactly as written in decoding.txt's "[luma]"/"[chroma]" header
# (code bits -> symbol). DC symbols are magnitude categories; AC symbol
# 0x00 is EOB.
LUMA_DC = {(1, 0b0): 0x00, (2, 0b10): 0x05}
LUMA_AC = {(1, 0b0): 0x00}
CHROMA_DC = {(1, 0b0): 0x00, (2, 0b10): 0x07, (3, 0b110): 0x05}
CHROMA_AC = {(1, 0b0): 0x00}


def _decode_scan(stream: bytes, tables_for_block, n_blocks: int):
    """Decode n_blocks of (DC category+value, AC EOB) and return
    [(cat, value)] plus the bit position after the last block."""
    r = _BitReader(stream)
    out = []
    for i in range(n_blocks):
        dc_t, ac_t = tables_for_block(i)
        cat = _decode_symbol(r, dc_t)
        val = _extend(r.bits(cat), cat)
        ac = _decode_symbol(r, ac_t)
        assert ac == 0x00, f"block {i}: expected EOB, decoded {ac:#x}"
        out.append((cat, val))
    return out, r.pos


def _encode_scan(blocks, tables_for_block, codes_of) -> bytes:
    """Re-encode [(cat, value)] + EOB per block through the production
    BitWriter with JPEG 1-padding."""
    w = BitWriter(flush_with_ones=True)
    for i, (cat, val) in enumerate(blocks):
        dc_t, ac_t = tables_for_block(i)
        code, length = codes_of(dc_t, cat)
        w.write_bits(code, length)
        if cat:
            # JPEG magnitude bits: value itself if positive, value-1
            # (one's complement of |v| in cat bits) if negative.
            bits = val if val > 0 else val - 1
            w.write_bits(bits & ((1 << cat) - 1), cat)
        code, length = codes_of(ac_t, 0x00)  # EOB
        w.write_bits(code, length)
    w.flush()
    return w.getvalue()


def _codes_of(table: dict, symbol: int):
    for (length, code), sym in table.items():
        if sym == symbol:
            return code, length
    raise KeyError(symbol)


@pytest.fixture(autouse=True)
def _need_worksheet():
    if not WORKSHEET.is_file():
        pytest.skip("reference worksheet not available")


def test_worksheet_tables_match_file_text():
    """The table constants above must be the ones the worksheet states."""
    text = WORKSHEET.read_text()
    for line in ["0 = 00", "10 = 05", "10 = 07", "110 = 05", "0 = eob"]:
        assert line in text
    assert "8a c9 50 00 00 07 ff d9" in text  # the [new] stream + EOI
    assert "15 24 80" in text  # the output_image.jpg scan section
    assert "-26 eob" in text  # the hand-decoded luma DC everywhere


def test_new_stream_decodes_as_worksheet_says():
    """decoding.txt [new]: stream 8a c9 50 00 00 07 under the stated
    tables. Worksheet hand decode: luma "(10.00 101)(0)" = DC cat5
    pattern 00101 = -26 then EOB, chroma "(110.0 1001)" = cat5 -22 and
    "(10.1 0000 00)" = cat7 +64, then all-zero blocks "(0)(0)", ending
    "0111" = final 1-padding."""
    stream = bytes.fromhex("8ac950000007")

    def tables(i):
        return (LUMA_DC, LUMA_AC) if i % 3 == 0 else (CHROMA_DC, CHROMA_AC)

    blocks, pos = _decode_scan(stream, tables, 12)
    assert blocks[0] == (5, -26)  # worksheet: "-26 eob"
    assert blocks[1] == (5, -22)  # worksheet: "(110.0 1001)"
    assert blocks[2] == (7, 64)  # worksheet: "(10.1 0000 00)"
    assert blocks[3:] == [(0, 0)] * 9  # worksheet: "0 eob" rows
    # 45 payload bits + 3 pad bits; the pad must be 1-bits (0x07 tail).
    assert pos == 45
    pad = [(stream[p // 8] >> (7 - p % 8)) & 1 for p in range(pos, 48)]
    assert pad == [1, 1, 1], "final byte must be 1-padded (encoder.rs:267)"


def test_new_stream_reencodes_byte_identical():
    stream = bytes.fromhex("8ac950000007")

    def tables(i):
        return (LUMA_DC, LUMA_AC) if i % 3 == 0 else (CHROMA_DC, CHROMA_AC)

    blocks, _ = _decode_scan(stream, tables, 12)
    assert _encode_scan(blocks, tables, _codes_of) == stream


def test_output_image_scan_matches_worksheet():
    """The committed output_image.jpg's scan is the worksheet's
    "15 24 80" section: one 8x8 P444 MCU, "-26 eob ? eob ? eob". The
    '?'s resolve to Cb=-22 (cat5, bits 01001) and Cr=+64 (cat7, bits
    1000000); 24 bits exactly, so no padding byte exists."""
    if not OUTPUT_IMAGE.is_file():
        pytest.skip("output_image.jpg not available")
    p = parse_jpeg(OUTPUT_IMAGE.read_bytes())
    assert p.scan_data == bytes.fromhex("152480")
    assert (p.width, p.height) == (8, 8)
    assert all((c.h, c.v) == (1, 1) for c in p.components)  # P444

    def tables(i):
        comp = p.components[i % 3]
        return p.huffman[(0, comp.td)], p.huffman[(1, comp.ta)]

    blocks, pos = _decode_scan(p.scan_data, tables, 3)
    assert blocks == [(5, -26), (5, -22), (7, 64)]
    assert pos == 24  # fills 3 bytes exactly

    assert _encode_scan(blocks, tables, _codes_of) == p.scan_data


def test_our_encoder_reproduces_worksheet_bit_conventions():
    """End-to-end cross-check: our encoder's own scan for a constructed
    image decodes with OUR debug decoder under the same worksheet
    conventions (category/EXTEND/EOB/1-padding) — i.e. the conventions
    the worksheet pins are the conventions we emit."""
    import io

    import numpy as np

    import dmmt_jpeg_encoder as dj

    # Flat mid-gray 8x8: one MCU, DC-only blocks, like the worksheet's.
    px = np.full((8, 8, 3), 84, dtype=np.uint8)
    cfg = dj.EncoderConfig(
        chroma_subsampling=dj.ChromaSubsamplingPreset("P444")
    )
    jpeg = dj.encode_ppm_image(
        dj.PPMImage(width=8, height=8, maxval=255, pixels=px), cfg
    )
    p = parse_jpeg(jpeg)

    def tables(i):
        comp = p.components[i % 3]
        return p.huffman[(0, comp.td)], p.huffman[(1, comp.ta)]

    blocks, pos = _decode_scan(p.scan_data, tables, 3)
    # Gray 84: Y = 84 - 128 = -44 level-shifted, DC = 8*-44 = -352,
    # quantized by 16 (Annex K [0,0]) with half-away rounding -> -22.
    assert blocks[0] == (5, -22)
    assert blocks[1:] == [(0, 0), (0, 0)]  # chroma of gray is 0
    # Remaining bits to the byte boundary must be 1-padding.
    total = len(p.scan_data) * 8
    pad = [
        (p.scan_data[b // 8] >> (7 - b % 8)) & 1 for b in range(pos, total)
    ]
    assert pad == [1] * len(pad)

"""Error types for the JPEG encoder.

Mirrors the error surface of the reference encoder's 18-variant enum
(reference: src/error.rs:3-23) as a Python exception hierarchy. Compute-path
errors that the reference surfaces as panics (e.g. out-of-range color values,
category overflow) are raised as the matching exception types here.
"""

from __future__ import annotations


class EncoderError(Exception):
    """Base class for all encoder errors (reference: src/lib.rs:26 `Result<T>`)."""


class PPMError(EncoderError):
    """Base class for PPM ingest errors."""


class PPMMissingToken(PPMError):
    """A required PPM header token is absent (src/error.rs:4)."""

    def __init__(self, token_name: str):
        super().__init__(f"Expected token '{token_name}' not found in PPM file")
        self.token_name = token_name


class PPMTokenParseError(PPMError):
    """A PPM token failed to parse as an integer (src/error.rs:5)."""

    def __init__(self, token_name: str):
        super().__init__(f"Parsing of token '{token_name}' failed")
        self.token_name = token_name


class PPMIncompletePixel(PPMError):
    """Trailing color components do not form a complete RGB triple (src/error.rs:6)."""

    def __init__(self, components_parsed: int):
        super().__init__(
            "Incomplete pixel parsed. Expected 3 components, "
            f"but got {components_parsed}."
        )
        self.components_parsed = components_parsed


class PPMSizeMismatch(PPMError):
    """Pixel count does not match the width*height from the header (src/error.rs:7)."""

    def __init__(self) -> None:
        super().__init__("Number of pixels do not match the size provided in header")


class ColorOutOfRange(EncoderError):
    """A color component exceeds the declared maxval (src/color.rs:66-69 panic)."""


class CategoryOverflow(EncoderError):
    """A coefficient magnitude category exceeds 15 (src/...categorize.rs:28-33 panic)."""


class HuffmanError(EncoderError):
    """Base class for Huffman table construction / encoding errors."""


class HuffmanDepthOverflow(HuffmanError):
    """More symbols than a depth-limited tree can hold (src/huffman/length_limited.rs:44-49)."""


class HuffmanUnsortedInput(HuffmanError):
    """Symbol frequencies/lengths not sorted as required
    (src/huffman/length_limited.rs:38-42, src/huffman/encoder.rs:82-84)."""


class HuffmanCodeTooLong(HuffmanError):
    """A code length exceeds the 16-bit pattern limit (src/huffman/encoder.rs:86-93)."""


class HuffmanDuplicateSymbol(HuffmanError):
    """The same symbol appears twice in a code-length list (src/huffman/encoder.rs:124-131)."""


class HuffmanSymbolMissing(HuffmanError):
    """A symbol has no codeword in the translator (src/error.rs:21)."""

    def __init__(self, symbol: int, table_name: str):
        super().__init__(
            f"Huffman symbol '{symbol}' not present in {table_name} translator"
        )
        self.symbol = symbol
        self.table_name = table_name


class ContainerWriteError(EncoderError):
    """Failure while emitting a JFIF segment (src/error.rs:12-22 variants)."""


class SegmentTooLong(ContainerWriteError):
    """Segment payload exceeds the u16 length field (src/...jpeg/encoder.rs:141-147 panic)."""


class IncompleteBlockLine(EncoderError):
    """Bottom block row is incomplete during MCU entangling — indicates bad padding
    (src/...transformer/block_entangler.rs:64-66 panic)."""

"""P3 (ASCII) PPM reader.

Capability and validation parity with the reference reader
(reference: src/image/reader/ppm.rs:9-251):

- byte-wise whitespace tokenizer with '#'-comment skip, where a comment does
  not terminate an in-progress token (ppm.rs:44-78)
- header: "P3", width (u16), height (u16), maxval (u16)
- color values are u16 and must not exceed maxval
  (RangeColorFormat::new panic, src/color.rs:66-69 -> ColorOutOfRange)
- pixel-count validation against the header (ppm.rs:165-175) and complete
  final triple (ppm.rs:239-244)

The hot path is the MULTITHREADED native parser (csrc/ppm_parse.c
dmmt_parse_ppm_mt): chunk the pixel region at whitespace-outside-comment
boundaries, parse all chunks in parallel straight into the final pixel
array (uint8 when maxval <= 255 — the device upload dtype), one serial
compaction move. ~1.1 GB/s on a 4-core host vs ~270 MB/s for the serial
tokenizer; a serial-C and a Python tokenizer with identical semantics
remain as fallbacks and as the source of precise error types.
Normalization to f32 happens on device (a divide fused into the
color-convert stage), unlike the reference which normalizes on the CPU
during parse (color.rs:45-53).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..errors import (
    ColorOutOfRange,
    PPMIncompletePixel,
    PPMMissingToken,
    PPMSizeMismatch,
    PPMTokenParseError,
)
from ..utils.native import load_native

_P3_HEADER = "P3 Header"
_WIDTH = "Width Header"
_HEIGHT = "Height Header"
_MAXVAL = "Max Value Header"
_COLOR = "Color Component Value"


@dataclass
class PPMImage:
    """Parsed image: RGB samples [H, W, 3] + the header maxval.

    pixels dtype is uint8 when maxval <= 255 (the overwhelmingly common
    case — parsed straight into the device upload dtype, halving both the
    parse output traffic and the host->device transfer) and uint16
    otherwise. Sample semantics are identical either way."""

    width: int
    height: int
    maxval: int
    pixels: np.ndarray  # uint8 or uint16 [H, W, 3]

    def normalized(self) -> np.ndarray:
        """f32 [H, W, 3] in 0..1 (reference: src/color.rs:45-53)."""
        return self.pixels.astype(np.float32) / np.float32(self.maxval)


def read_ppm(path: str | Path, threads: int | None = None) -> PPMImage:
    return read_ppm_bytes(Path(path).read_bytes(), threads=threads)


def read_ppm_bytes(data: bytes, threads: int | None = None) -> PPMImage:
    """Parse a P3 PPM. `threads` sets the C fast path's worker count —
    the `-t/--threads` CLI flag lands here, mirroring the reference's
    pool-size semantics (cli.rs:178-180); None = all cores (<=16)."""
    image = _parse_native_mt(data, threads=threads)
    if image is not None:
        return image
    values = _tokenize_native(data)
    if values is None:
        values = _tokenize_python(data)
    return _build_image(values)


def _parse_native_mt(data: bytes, threads: int | None = None) -> PPMImage | None:
    """Multithreaded native parse straight to the final pixel array
    (uint8 when maxval <= 255). None on any error — the serial/Python
    paths re-parse for precise error types."""
    import os

    lib = load_native()
    if lib is None:
        return None
    fn = lib.dmmt_parse_ppm_mt
    fn.restype = ctypes.c_long
    buf = np.frombuffer(data, dtype=np.uint8)
    hdr = np.zeros(3, dtype=np.uint32)
    if threads is None:
        threads = min(os.cpu_count() or 1, 16)
    threads = max(1, min(int(threads), 16))

    # Header peek (serial C parses it again — this picks the dtype and the
    # exact buffer size): width/height/maxval as tokens 1..3 of a prefix.
    prefix_tokens = _python_tokens(data[:65536])
    if len(prefix_tokens) < 4:
        prefix_tokens = _python_tokens(data)
    if len(prefix_tokens) < 4:
        return None
    try:
        pw, ph, maxval = (int(prefix_tokens[k]) for k in (1, 2, 3))
    except ValueError:
        return None
    elem = 1 if 0 <= maxval <= 255 else 2
    # Exact-size allocation (page faults on a fresh oversized buffer cost
    # more than the parse): 3*w*h samples + per-chunk region slop. A
    # malformed sample count overflows into -1 and takes the precise-error
    # Python path.
    cap = 3 * pw * ph + 17 * 8
    out = np.empty(cap, dtype=np.uint8 if elem == 1 else np.uint16)
    rc = fn(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_long(len(data)),
        hdr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        out.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_long(cap),
        ctypes.c_int(elem),
        ctypes.c_int(threads),
    )
    if rc < 0:
        return None
    width, height, maxval = int(hdr[0]), int(hdr[1]), int(hdr[2])
    if rc % 3 != 0 or rc // 3 != width * height:
        return None  # python path raises the precise size error
    pixels = out[:rc].reshape(height, width, 3)
    return PPMImage(width=width, height=height, maxval=maxval, pixels=pixels)


def _tokenize_native(data: bytes) -> np.ndarray | None:
    lib = load_native()
    if lib is None:
        return None
    fn = lib.dmmt_parse_ppm
    fn.restype = ctypes.c_long
    buf = np.frombuffer(data, dtype=np.uint8)
    cap = len(data) // 2 + 8  # every value needs >= 1 digit + 1 separator
    out = np.empty(cap, dtype=np.uint16)
    rc = fn(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_long(len(data)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        ctypes.c_long(cap),
    )
    if rc < 0:
        return None  # fall back to Python for precise error reporting
    return out[:rc].copy()


def _tokenize_python(data: bytes) -> np.ndarray:
    tokens = _python_tokens(data)
    if not tokens:
        raise PPMMissingToken(_P3_HEADER)
    if tokens[0] != b"P3":
        raise PPMMissingToken(_P3_HEADER)
    names = [_WIDTH, _HEIGHT, _MAXVAL]
    values = np.empty(len(tokens) - 1, dtype=np.uint16)
    for i, tok in enumerate(tokens[1:]):
        name = names[i] if i < 3 else _COLOR
        try:
            v = int(tok)
        except ValueError:
            raise PPMTokenParseError(name) from None
        if not (0 <= v <= 0xFFFF):
            raise PPMTokenParseError(name)
        values[i] = v
    return values


def _python_tokens(data: bytes) -> list[bytes]:
    """Reference tokenizer semantics (ppm.rs:44-78): '#'..'\\n' skipped
    without breaking the current token."""
    tokens: list[bytes] = []
    buf = bytearray()
    in_comment = False
    ws = b" \t\n\x0c\r"
    for b in data:
        if in_comment:
            if b == 0x0A:
                in_comment = False
            continue
        if b == 0x23:  # '#'
            in_comment = True
            continue
        if b in ws:
            if buf:
                tokens.append(bytes(buf))
                buf.clear()
        else:
            buf.append(b)
    if buf:
        tokens.append(bytes(buf))
    return tokens


def _build_image(values: np.ndarray) -> PPMImage:
    if len(values) < 1:
        raise PPMMissingToken(_WIDTH)
    if len(values) < 2:
        raise PPMMissingToken(_HEIGHT)
    if len(values) < 3:
        raise PPMMissingToken(_MAXVAL)
    width, height, maxval = int(values[0]), int(values[1]), int(values[2])
    samples = values[3:]
    if len(samples) % 3 != 0:
        raise PPMIncompletePixel(len(samples) % 3)
    n_pixels = len(samples) // 3
    if n_pixels != width * height:
        raise PPMSizeMismatch()
    if maxval > 0 and samples.size and int(samples.max()) > maxval:
        raise ColorOutOfRange(
            f"Color value must not be greater than max value of {maxval}"
        )
    pixels = samples.reshape(height, width, 3)
    return PPMImage(width=width, height=height, maxval=maxval, pixels=pixels)


def write_ppm(path: str | Path, pixels: np.ndarray, maxval: int = 255) -> None:
    """Write a P3 PPM (testing/benchmark utility; the reference has no writer)."""
    pixels = np.asarray(pixels)
    h, w, _ = pixels.shape
    # one text line per image row
    body = "\n".join(
        " ".join(map(str, row)) for row in pixels.reshape(h, -1).tolist()
    )
    Path(path).write_text(f"P3\n{w} {h}\n{maxval}\n{body}\n")

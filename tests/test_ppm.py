"""PPM reader tests (reference behavior: src/image/reader/ppm.rs:253-307)."""

import numpy as np
import pytest

from dmmt_jpeg_encoder.errors import (
    ColorOutOfRange,
    PPMIncompletePixel,
    PPMMissingToken,
    PPMSizeMismatch,
    PPMTokenParseError,
)
from dmmt_jpeg_encoder.io.ppm import (
    _python_tokens,
    read_ppm,
    read_ppm_bytes,
    write_ppm,
)


def test_basic_parse():
    img = read_ppm_bytes(b"P3\n2 2\n255\n1 2 3 4 5 6 7 8 9 10 11 12\n")
    assert (img.width, img.height, img.maxval) == (2, 2, 255)
    assert img.pixels.shape == (2, 2, 3)
    assert img.pixels.dtype == np.uint8  # maxval <= 255 parses to the upload dtype
    assert img.pixels[0, 0].tolist() == [1, 2, 3]
    assert img.pixels[1, 1].tolist() == [10, 11, 12]


def test_comment_skipped_mid_header():
    img = read_ppm_bytes(b"P3\n# a comment\n1 1 # trailing\n7\n1 2 3\n")
    assert (img.width, img.height, img.maxval) == (1, 1, 7)


def test_comment_does_not_break_token():
    # '#' starts a comment that runs to newline; the token resumes after,
    # so "2#comment\n55" parses as the single token "255" in the reference
    # tokenizer (ppm.rs:44-78).
    toks = _python_tokens(b"P3 1 1 2#comment\n55 9 9 9")
    assert toks == [b"P3", b"1", b"1", b"255", b"9", b"9", b"9"]


def test_arbitrary_maxval_normalization():
    img = read_ppm_bytes(b"P3\n1 1\n31\n31 0 15\n")
    norm = img.normalized()
    assert norm.shape == (1, 1, 3)
    np.testing.assert_allclose(norm[0, 0], [1.0, 0.0, 15 / 31], rtol=1e-6)


def test_value_above_maxval_rejected():
    with pytest.raises(ColorOutOfRange):
        read_ppm_bytes(b"P3\n1 1\n255\n256 0 0\n")


def test_pixel_count_mismatch():
    with pytest.raises(PPMSizeMismatch):
        read_ppm_bytes(b"P3\n2 2\n255\n1 2 3\n")


def test_incomplete_triple():
    with pytest.raises((PPMIncompletePixel, PPMSizeMismatch)):
        read_ppm_bytes(b"P3\n1 1\n255\n1 2\n")


def test_missing_magic():
    with pytest.raises(PPMMissingToken):
        read_ppm_bytes(b"P6\n1 1\n255\n1 2 3\n")


def test_empty_input():
    with pytest.raises(PPMMissingToken):
        read_ppm_bytes(b"")


def test_non_numeric_token():
    with pytest.raises(PPMTokenParseError):
        read_ppm_bytes(b"P3\nx 1\n255\n1 2 3\n")


def test_native_matches_python(rng):
    pixels = rng.integers(0, 256, (13, 7, 3), dtype=np.uint16)
    body = " ".join(str(v) for v in pixels.reshape(-1))
    data = f"P3\n# c1\n7 13 # c2\n255\n{body}\n".encode()
    img = read_ppm_bytes(data)  # native path if toolchain present
    np.testing.assert_array_equal(img.pixels, pixels)


def test_write_read_roundtrip(tmp_path, rng):
    pixels = rng.integers(0, 100, (5, 9, 3), dtype=np.uint16)
    p = tmp_path / "x.ppm"
    write_ppm(p, pixels, maxval=99)
    img = read_ppm(p)
    assert img.maxval == 99
    np.testing.assert_array_equal(img.pixels, pixels)


def test_reference_fixture_small(fixtures_dir):
    img = read_ppm(fixtures_dir / "small.ppm")
    assert (img.width, img.height) == (2, 2)


def test_reference_fixture_16x16_header_is_8x8(fixtures_dir):
    # The fixture named 16x16.ppm actually declares 8x8 (SURVEY.md §4).
    img = read_ppm(fixtures_dir / "16x16.ppm")
    assert (img.width, img.height) == (8, 8)


# --- multithreaded native parser ------------------------------------------


def _mt_available():
    from dmmt_jpeg_encoder.utils.native import load_native

    lib = load_native()
    return lib is not None and hasattr(lib, "dmmt_parse_ppm_mt")


@pytest.mark.skipif(not _mt_available(), reason="native lib unavailable")
def test_mt_parser_matches_python_on_fixtures(fixtures_dir):
    from dmmt_jpeg_encoder.io.ppm import (
        _build_image,
        _parse_native_mt,
        _tokenize_python,
    )

    for name in ["small.ppm", "8x8.ppm", "16x16.ppm", "7x17.ppm", "500x500.ppm"]:
        data = (fixtures_dir / name).read_bytes()
        got = _parse_native_mt(data)
        want = _build_image(_tokenize_python(data))
        assert got is not None, name
        assert (got.width, got.height, got.maxval) == (
            want.width, want.height, want.maxval), name
        np.testing.assert_array_equal(
            got.pixels.astype(np.uint16), want.pixels.astype(np.uint16)
        )


@pytest.mark.skipif(not _mt_available(), reason="native lib unavailable")
def test_mt_parser_comment_and_boundary_edge_cases():
    from dmmt_jpeg_encoder.io.ppm import _build_image, _parse_native_mt, _tokenize_python

    cases = [
        # token spanning a comment (the reference's comment-mid-token rule)
        b"P3\n2 1\n2#comment\n55\n1 2 0 1 2 0\n",
        # comment splitting a VALUE: "1#c\n2" is the token 12
        b"P3 1 1 255 1#zz\n2 13 255\n",
        # comments everywhere, \r\f\t separators
        b"P3#c\n \t2\r2\f255#c\n 1 2 3 4 5 6 7 8 9 10 11 12 ",
        # 16-bit samples
        b"P3 1 1 65535 65535 0 1000 ",
        # trailing token at EOF without separator
        b"P3 1 1 255 7 8 9",
    ]
    for data in cases:
        got = _parse_native_mt(data)
        want = _build_image(_tokenize_python(data))
        assert got is not None, data
        assert (got.width, got.height, got.maxval) == (
            want.width, want.height, want.maxval), data
        np.testing.assert_array_equal(
            got.pixels.astype(np.uint16), want.pixels.astype(np.uint16)
        )


@pytest.mark.skipif(not _mt_available(), reason="native lib unavailable")
def test_mt_parser_errors_fall_back():
    # bad magic / bad token / out-of-range color all return None (the
    # python path then raises the precise error, covered above)
    from dmmt_jpeg_encoder.io.ppm import _parse_native_mt

    assert _parse_native_mt(b"P6\n1 1\n255\n1 2 3\n") is None
    assert _parse_native_mt(b"P3\n1 1\n255\n1 x 3\n") is None
    assert _parse_native_mt(b"P3\n1 1\n255\n1 2 999\n") is None
    assert _parse_native_mt(b"P3\n2 1\n255\n1 2 3\n") is None  # size mismatch


@pytest.mark.skipif(not _mt_available(), reason="native lib unavailable")
def test_mt_parser_large_multichunk(rng):
    """Large enough to split across all threads, with comments sprinkled
    at positions that land near chunk boundaries."""
    vals = rng.integers(0, 256, 3 * 600 * 700)
    parts = []
    for i in range(0, len(vals), 1000):
        parts.append(" ".join(str(v) for v in vals[i : i + 1000]))
        parts.append("#boundary comment 123 456\n")
    data = ("P3\n600 700\n255\n" + " \n".join(parts)).encode()
    # force multithreading even at this size by padding with comments
    data += b"#" + b"x" * (1 << 20) + b"\n"
    from dmmt_jpeg_encoder.io.ppm import _build_image, _parse_native_mt, _tokenize_python

    got = _parse_native_mt(data)
    want = _build_image(_tokenize_python(data))
    assert got is not None
    np.testing.assert_array_equal(
        got.pixels.astype(np.uint16), want.pixels.astype(np.uint16)
    )

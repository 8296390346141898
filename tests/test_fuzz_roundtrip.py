"""Randomized round-trip fuzzing: arbitrary sizes x content classes, every
stream verified with the in-house decoder (structure + pixels) and the
native/python packer equality."""

import numpy as np
import pytest

from dmmt_jpeg_encoder import ChromaSubsamplingPreset, EncoderConfig, encode_array
from dmmt_jpeg_encoder.debug.jpeg_decoder import decode_jpeg, parse_jpeg


def _content(rng, kind, h, w):
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint16)
    if kind == "flat":
        return np.full((h, w, 3), rng.integers(0, 256), dtype=np.uint16)
    if kind == "saturated":
        px = rng.choice([0, 255], size=(h, w, 3)).astype(np.uint16)
        return px
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack(
        [
            (xx * 7 + yy * 3) % 256,
            (xx + yy * 11) % 256,
            (xx * 2 + yy * 2) % 256,
        ],
        axis=-1,
    ).astype(np.uint16)


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_roundtrip(seed):
    rng = np.random.default_rng(1000 + seed)
    h = int(rng.integers(1, 70))
    w = int(rng.integers(1, 70))
    kind = ["noise", "flat", "saturated", "pattern"][seed % 4]
    preset = list(ChromaSubsamplingPreset)[seed % 3]
    px = _content(rng, kind, h, w)

    jpg = encode_array(px, 255, EncoderConfig(chroma_subsampling=preset))
    p = parse_jpeg(jpg)
    assert (p.width, p.height) == (w, h)
    assert [s[0] for s in p.segments][:5] == ["SOI", "APP0", "DQT", "DQT", "SOF0"]
    assert p.segments[-1][0] == "EOI"

    dec = decode_jpeg(jpg)
    assert dec.shape == (h, w, 3)
    if kind == "flat" and h % 16 == 0 and w % 16 == 0:
        # flat aligned content must reconstruct near-exactly
        assert np.abs(dec.astype(int) - px.astype(int)).max() <= 2

    # host packers agree with whatever produced this stream
    a = encode_array(px, 255, EncoderConfig(chroma_subsampling=preset),
                     use_native=True)
    b = encode_array(px, 255, EncoderConfig(chroma_subsampling=preset),
                     use_native=False)
    assert a == b == jpg

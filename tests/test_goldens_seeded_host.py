"""Seeded byte-parity corpus through the host scan backend.

Every key of tests/goldens_seeded.json (5 sizes x 3 subsampling presets x
2 quantization tables x 2 DCT variants; images from
dmmt_jpeg_encoder.debug.seeded_corpus) must reproduce its pinned SHA-256.
The hashes were produced with the host packer on the CPU; regenerate with
`python -m dmmt_jpeg_encoder.debug.seeded_corpus tests/goldens_seeded.json`.
"""

import json
from pathlib import Path

import jax
import pytest

from dmmt_jpeg_encoder.debug.seeded_corpus import corpus_keys, encode_key, sha256

GOLDENS = json.loads(
    (Path(__file__).parent / "goldens_seeded.json").read_text()
)


def test_corpus_keys_are_pinned():
    assert sorted(GOLDENS) == sorted(corpus_keys())


@pytest.mark.parametrize("key", corpus_keys())
def test_seeded_corpus_host(key):
    assert sha256(encode_key(key, scan_backend="host")) == GOLDENS[key]
    jax.clear_caches()

"""GPU-only checks: marker ``gpu``, skipped where JAX finds no GPU (see
tests/conftest.py for the command that runs them)."""

import json
from pathlib import Path

import jax
import pytest

from dmmt_jpeg_encoder.debug.seeded_corpus import encode_key, sha256

GOLDENS = json.loads(
    (Path(__file__).parent / "goldens_seeded.json").read_text()
)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "key", ["37x61|P420|Specification|arai", "500x500|P444|Flat|arai"]
)
def test_arai_corpus_bytes_on_gpu(gpu_device, key):
    """The device path on the GPU reproduces the pinned host-oracle hash."""
    with jax.default_device(gpu_device):
        assert sha256(encode_key(key, scan_backend="device")) == GOLDENS[key]

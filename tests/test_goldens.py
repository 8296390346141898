"""Golden-bitstream regression corpus.

The reference's committed .jpg fixtures are unusable as byte oracles (they
are stale artifacts of an older buggy build whose chroma DQT contains the
luma table — see tests/test_e2e.py), so this corpus pins the bytes of OUR
encoder instead: SHA-256 of the full JPEG output for every reference .ppm
fixture x {P444,P422,P420} x {Specification,Flat} x {ARAI,FUSED}.

Any kernel rewrite that changes output bytes fails here and must be
explicitly re-goldened:

    python tests/test_goldens.py   # regenerates goldens.json
    git diff tests/goldens.json    # review, then commit

The hashes are produced on the CPU backend with the host scan packer; the
device packer is asserted byte-equal to this path by
tests/test_device_pack.py, and the GPU by chip_smoke.py (on the seeded
corpus of tests/goldens_seeded.json).
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

if __name__ == "__main__":  # script mode: repo root on path, CPU backend
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import jax

    jax.config.update("jax_platforms", "cpu")

import pytest

from dmmt_jpeg_encoder.config import (
    ChromaSubsamplingPreset,
    DCTVariant,
    EncoderConfig,
    QuantizationTablePreset,
)
from dmmt_jpeg_encoder.encoder import encode_ppm_image
from dmmt_jpeg_encoder.io.ppm import read_ppm

GOLDENS_PATH = Path(__file__).parent / "goldens.json"

FIXTURES = ["small.ppm", "8x8.ppm", "16x16.ppm", "7x17.ppm", "500x500.ppm"]
PRESETS = [
    ChromaSubsamplingPreset.P444,
    ChromaSubsamplingPreset.P422,
    ChromaSubsamplingPreset.P420,
]
TABLES = [QuantizationTablePreset.SPECIFICATION, QuantizationTablePreset.FLAT]
VARIANTS = [DCTVariant.ARAI, DCTVariant.FUSED]


def _key(fixture: str, preset, table, variant) -> str:
    return f"{fixture}|{preset.value}|{table.value}|{variant.value}"


def _encode(fixtures_dir: Path, fixture: str, preset, table, variant) -> bytes:
    image = read_ppm(fixtures_dir / fixture)
    config = EncoderConfig(
        chroma_subsampling=preset,
        quantization_preset=table,
        dct_variant=variant,
        scan_backend="host",
    )
    return encode_ppm_image(image, config)


def _cases():
    for fixture in FIXTURES:
        for preset in PRESETS:
            for table in TABLES:
                for variant in VARIANTS:
                    yield fixture, preset, table, variant


@pytest.fixture(scope="module")
def goldens():
    if not GOLDENS_PATH.exists():
        pytest.skip("goldens.json not generated yet (DMMT_REGOLDEN=1 to create)")
    return json.loads(GOLDENS_PATH.read_text())


@pytest.mark.parametrize(
    "fixture,preset,table,variant",
    list(_cases()),
    ids=[_key(*c) for c in _cases()],
)
def test_golden_bytes(fixtures_dir, goldens, fixture, preset, table, variant):
    key = _key(fixture, preset, table, variant)
    assert key in goldens, (
        f"missing golden for {key} — run 'python tests/test_goldens.py'"
    )
    jpeg = _encode(fixtures_dir, fixture, preset, table, variant)
    digest = hashlib.sha256(jpeg).hexdigest()
    assert digest == goldens[key]["sha256"], (
        f"output bytes changed for {key} "
        f"({len(jpeg)} bytes vs golden {goldens[key]['size']}); "
        "if intentional, re-golden with DMMT_REGOLDEN=1 and commit the diff"
    )
    assert len(jpeg) == goldens[key]["size"]


def regolden(fixtures_dir: Path) -> None:
    """Regenerate goldens.json (run as: python tests/test_goldens.py).

    Deliberately NOT a test: a regeneration mode inside the suite showed
    up as a perpetual skip (VERDICT r2 #9)."""
    out = {}
    for fixture, preset, table, variant in _cases():
        jpeg = _encode(fixtures_dir, fixture, preset, table, variant)
        out[_key(fixture, preset, table, variant)] = {
            "sha256": hashlib.sha256(jpeg).hexdigest(),
            "size": len(jpeg),
        }
    GOLDENS_PATH.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")


if __name__ == "__main__":
    regolden(Path("/root/reference/tests"))
    print(f"wrote {GOLDENS_PATH}")

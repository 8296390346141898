"""Seeded, self-contained byte-parity corpus.

Every image is generated from a seed, so the corpus needs no fixture files.
Each 8x8 block (per channel) is one of a few patterns chosen to reach the
entropy coder's corner cases:

- uniform noise: dense AC spectra, high magnitude categories, and many
  0xFF bytes in the scan (byte stuffing);
- flat blocks at random levels, including 0 and 255: large DC deltas;
- a single high-frequency cosine: one late zigzag coefficient behind a
  long zero run (ZRL codes);
- a one-pixel checkerboard: the largest AC magnitudes;
- a gradient: smooth low-frequency content.

Keys are ``"{H}x{W}|{preset}|{table}|{variant}"``. The pinned SHA-256 of
every key's JPEG lives in ``tests/goldens_seeded.json``; regenerate it with

    JAX_PLATFORMS=cpu python -m dmmt_jpeg_encoder.debug.seeded_corpus \
        tests/goldens_seeded.json

which encodes with the host packer (``scan_backend="host"``) on the CPU.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import sys

import numpy as np

from ..config import (
    ChromaSubsamplingPreset,
    DCTVariant,
    EncoderConfig,
    QuantizationTablePreset,
)

SIZES: tuple[tuple[int, int], ...] = (
    (8, 8), (7, 17), (16, 16), (37, 61), (500, 500),
)
PRESETS = (
    ChromaSubsamplingPreset.P444,
    ChromaSubsamplingPreset.P422,
    ChromaSubsamplingPreset.P420,
)
TABLES = (
    QuantizationTablePreset.SPECIFICATION,
    QuantizationTablePreset.FLAT,
)
VARIANTS = (DCTVariant.ARAI, DCTVariant.FUSED)


def seeded_image(height: int, width: int, seed: int = 0) -> np.ndarray:
    """uint8 RGB [height, width, 3] built block by block from ``seed``."""
    rng = np.random.default_rng(seed)
    by, bx = -(-height // 8), -(-width // 8)
    hh, ww = by * 8, bx * 8
    y = np.arange(8)[:, None].astype(np.float64)
    x = np.arange(8)[None, :].astype(np.float64)
    out = np.empty((3, hh, ww), dtype=np.float64)
    kinds = rng.integers(0, 5, size=(3, by, bx))
    for c, i, j in itertools.product(range(3), range(by), range(bx)):
        kind = kinds[c, i, j]
        if kind == 0:
            blk = rng.integers(0, 256, size=(8, 8)).astype(np.float64)
        elif kind == 1:
            level = rng.choice([0.0, 255.0, float(rng.integers(0, 256))])
            blk = np.full((8, 8), level)
        elif kind == 2:
            u, v = int(rng.integers(5, 8)), int(rng.integers(0, 8))
            blk = 128.0 + 127.0 * (
                np.cos(np.pi * (2 * x + 1) * u / 16)
                * np.cos(np.pi * (2 * y + 1) * v / 16)
            )
        elif kind == 3:
            blk = 255.0 * ((x + y) % 2)
            blk = np.broadcast_to(blk, (8, 8))
        else:
            a, b = rng.uniform(-16, 16, size=2)
            blk = 128.0 + a * (x - 3.5) + b * (y - 3.5)
        out[c, i * 8 : i * 8 + 8, j * 8 : j * 8 + 8] = blk
    img = np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return np.ascontiguousarray(img.transpose(1, 2, 0)[:height, :width])


def seeded_frame(height: int, width: int, seed: int = 0) -> np.ndarray:
    """uint8 RGB [height, width, 3] photographic-like frame: smooth
    gradients, a few hard edges and mild noise (compressible like a real
    photo, unlike the corner-case blocks of seeded_image)."""
    rng = np.random.default_rng(seed)
    yy = np.arange(height, dtype=np.float32)[:, None]
    xx = np.arange(width, dtype=np.float32)[None, :]
    f = rng.uniform(40.0, 120.0, size=4).astype(np.float32)
    base = (
        96.0
        + 80.0 * np.sin(xx / f[0] + yy / f[1])
        + 60.0 * np.cos(yy / f[2] - xx / f[3])
    )
    edges = ((xx // 257 + yy // 193) % 2) * 40.0
    noise = rng.normal(0.0, 6.0, size=(height, width)).astype(np.float32)
    base = base + edges + noise
    rgb = np.stack([base, base * 0.9 + 10.0, base * 1.1 - 8.0], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def image_seed(height: int, width: int) -> int:
    return 1000 * height + width


def corpus_keys() -> list[str]:
    return [
        f"{h}x{w}|{p.value}|{t.value}|{v.value}"
        for (h, w), p, t, v in itertools.product(
            SIZES, PRESETS, TABLES, VARIANTS
        )
    ]


def parse_key(key: str):
    """key -> (pixels, EncoderConfig kwargs without scan_backend)."""
    size, preset, table, variant = key.split("|")
    h, w = (int(s) for s in size.split("x"))
    kwargs = dict(
        chroma_subsampling=ChromaSubsamplingPreset(preset),
        quantization_preset=QuantizationTablePreset(table),
        dct_variant=DCTVariant(variant),
    )
    return seeded_image(h, w, image_seed(h, w)), kwargs


def encode_key(key: str, **config_overrides) -> bytes:
    from ..encoder import encode_array

    pixels, kwargs = parse_key(key)
    kwargs.update(config_overrides)
    return encode_array(pixels, 255, EncoderConfig(**kwargs))


def sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def main(argv: list[str]) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    hashes = {
        key: sha256(encode_key(key, scan_backend="host"))
        for key in corpus_keys()
    }
    with open(argv[0], "w") as f:
        json.dump(hashes, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {len(hashes)} hashes to {argv[0]}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""DCT timing harness — the reference's `dct_timing` binary re-designed for
the default JAX device (reference: src/bin/dct_timing.rs:18-299).

Same experiment: one synthetic 3840x2160 f32 channel in 8x8-block-major
form, transformed N times, reporting min/max/avg/stddev microseconds per
round. Instead of a thread pool over 700-block chunks, each round is one
jitted batched-DCT dispatch over all 129,600 blocks.

Usage:
    python benchmarks/dct_timing.py [-n ROUNDS] [-a arai|separated|simple|fused]
                                    [--width W] [--height H]
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import argparse
import statistics
import sys
import time

import numpy as np


def make_test_channel(height: int, width: int) -> np.ndarray:
    """Synthetic ramp channel like the reference's
    create_test_color_channel (dct_timing.rs:150-160)."""
    yy, xx = np.mgrid[0:height, 0:width]
    return (((xx + yy) % 256) - 128).astype(np.float32)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-n", "--rounds", type=int, default=100)
    ap.add_argument(
        "-a",
        "--algorithm",
        default="arai",
        choices=["arai", "separated", "simple", "fused"],
    )
    ap.add_argument("--width", type=int, default=3840)
    ap.add_argument("--height", type=int, default=2160)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from dmmt_jpeg_encoder.config import DCTVariant
    from dmmt_jpeg_encoder.ops.dct import dct2d
    from dmmt_jpeg_encoder.ops.geometry import blockize

    variant = DCTVariant(args.algorithm)
    h = args.height - args.height % 8
    w = args.width - args.width % 8
    chan = make_test_channel(h, w)
    blocks = jax.device_put(jnp.asarray(blockize(jnp.asarray(chan))))
    n_blocks = blocks.shape[0]

    if variant is DCTVariant.FUSED:
        from dmmt_jpeg_encoder.config import QuantizationTablePreset
        from dmmt_jpeg_encoder.ops.fused import fused_dct_quantize_zigzag
        from dmmt_jpeg_encoder.tables import quantization_table_pair

        luma_q = jnp.asarray(
            quantization_table_pair(QuantizationTablePreset.SPECIFICATION)[0]
        )
        fn = jax.jit(lambda b: fused_dct_quantize_zigzag(b, luma_q))
    else:
        fn = jax.jit(lambda b: dct2d(b, variant))

    def run_once():
        jax.block_until_ready(fn(blocks))

    run_once()  # compile

    times_us = []
    for _ in range(args.rounds):
        t0 = time.perf_counter()
        run_once()
        times_us.append((time.perf_counter() - t0) * 1e6)

    mean = statistics.fmean(times_us)
    std = statistics.pstdev(times_us)
    mpix_s = (h * w) / (mean / 1e6) / 1e6
    print(
        f"algorithm={variant.value} blocks={n_blocks} rounds={args.rounds} "
        f"device={jax.devices()[0].platform}"
    )
    print(
        f"min={min(times_us):.1f}us max={max(times_us):.1f}us "
        f"avg={mean:.1f}us stddev={std:.1f}us  ({mpix_s:.0f} Mpix/s)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

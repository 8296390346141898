"""Command-line interface.

Flag-for-flag mirror of the reference CLI (reference: src/cli.rs:75-115):

    dmmt-jpeg-encoder INPUT_FILE OUTPUT_FILE
        [-b/--bits_per_channel {8,16,32}]        default 8
        [-p/--chroma_subsampling_preset {P444,P422,P420}]  default P420
        [-t/--threads N]                         default os.cpu_count()
        [-q/--quantization_table PRESET]         default Specification

plus extensions:

    [--dct {arai,separated,simple,fused}]        device DCT variant
    [--shards N]                                 multi-device mesh shards
    [--no-native]                                disable the C scan packer

`--threads` sets the C PPM parser's worker count (the reference uses the
flag as its pool size, src/cli.rs:178-180); device-side parallelism comes
from the XLA program, not OS threads (the reference's DCT thread pool,
src/lib.rs:62, has no device analog).
"""

from __future__ import annotations

import argparse
import os
import sys

from .config import (
    ChromaSubsamplingPreset,
    DCTVariant,
    EncoderConfig,
    QuantizationTablePreset,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dmmt-jpeg-encoder",
        description=(
            "Baseline JPEG encoder: P3 PPM -> JFIF/JPEG "
            "(JAX/XLA device pipeline + native host bitstream tail)."
        ),
    )
    p.add_argument("input_file", help="path to the P3 (ASCII) PPM input image")
    p.add_argument("output_file", help="path for the JPEG output")
    p.add_argument(
        "-b",
        "--bits_per_channel",
        type=int,
        choices=(8, 16, 32),
        default=8,
        help="SOF0 sample precision field (default: 8)",
    )
    p.add_argument(
        "-p",
        "--chroma_subsampling_preset",
        choices=[e.value for e in ChromaSubsamplingPreset],
        default=ChromaSubsamplingPreset.P420.value,
        help="chroma subsampling (default: P420)",
    )
    p.add_argument(
        "-t",
        "--threads",
        type=int,
        default=os.cpu_count() or 1,
        help="host worker threads for the PPM parser (reference pool-size "
        "semantics, cli.rs:178-180; device work is XLA-parallel)",
    )
    p.add_argument(
        "-q",
        "--quantization_table",
        default=QuantizationTablePreset.SPECIFICATION.value,
        help=(
            "quantization table preset: "
            + ", ".join(e.value for e in QuantizationTablePreset)
            + " (aliases: Spec, Default, 0-8; default: Specification)"
        ),
    )
    p.add_argument(
        "--quality",
        type=int,
        default=None,
        help="IJG quality 1..100 scaling the quantization preset "
        "(extension; default: use the preset's raw tables)",
    )
    p.add_argument(
        "--dct",
        choices=[e.value for e in DCTVariant],
        default=DCTVariant.ARAI.value,
        help="device DCT implementation (default: arai)",
    )
    p.add_argument(
        "--shards",
        type=int,
        default=1,
        help="number of mesh shards for multi-chip encode (default: 1)",
    )
    p.add_argument(
        "--no-native",
        action="store_true",
        help="use the pure-Python scan packer instead of the C fast path",
    )
    p.add_argument(
        "--scan-backend",
        choices=("auto", "device", "host"),
        default="auto",
        help="entropy-scan assembly: on-accelerator packing, host packing, "
        "or auto (default: auto)",
    )
    p.add_argument(
        "--one-dispatch",
        choices=("auto", "off"),
        default="auto",
        help="build Huffman tables on device and pack in the same program "
        "(default: auto)",
    )
    return p


def parse_args(argv: list[str] | None = None) -> tuple[argparse.Namespace, EncoderConfig]:
    args = build_parser().parse_args(argv)
    try:
        qt = QuantizationTablePreset.parse(args.quantization_table)
    except ValueError as e:
        build_parser().error(str(e))
    try:
        config = EncoderConfig(
            chroma_subsampling=ChromaSubsamplingPreset(args.chroma_subsampling_preset),
            quantization_preset=qt,
            bits_per_channel=args.bits_per_channel,
            dct_variant=DCTVariant(args.dct),
            num_shards=args.shards,
            quality=args.quality,
            scan_backend=args.scan_backend,
            one_dispatch=args.one_dispatch,
        )
    except ValueError as e:
        build_parser().error(str(e))
    return args, config


def main(argv: list[str] | None = None) -> int:
    args, config = parse_args(argv)
    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from .encoder import encode_ppm_image
    from .io.ppm import read_ppm
    from pathlib import Path

    try:
        image = read_ppm(args.input_file, threads=args.threads)
    except OSError as e:
        print(f"error: cannot read '{args.input_file}': {e}", file=sys.stderr)
        return 1
    except Exception as e:
        print(f"error: invalid PPM input: {e}", file=sys.stderr)
        return 1
    try:
        jpeg = encode_ppm_image(image, config, use_native=not args.no_native)
        Path(args.output_file).write_bytes(jpeg)
    except OSError as e:
        print(f"error: cannot write '{args.output_file}': {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

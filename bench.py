"""Benchmark: 4K (3840x2160) RGB -> baseline JPEG throughput on one GPU.

Prints JSON lines of the form
    {"metric": ..., "value": N, "unit": "Mpix/s", "card": "<name>, <W>"}
where "card" is nvidia-smi's name and power limit for the card measured,
with the device-program metric LAST.

This file is a SUPERVISOR that never imports JAX: the measurements run in
one child process (``--child``) under a timeout. The supervisor passes
metric lines through as they appear and re-emits every metric in
canonical order at the end. Any failing stage fails the child, and the
supervisor then exits nonzero.

Stages (child):
- e2e:     encode_array, pixels in -> JPEG bytes out (best of --rounds);
- batch:   encode_batch over --batch frames, per-frame rate;
- device-only: pre-uploaded pixels, 8 one-dispatch programs in flight,
           each finished (fetch + host tail);
- device-program: 8 pipelined one-dispatch programs, blocking only on the
           last program's bit count (no stream fetch).
The host tail of the two-dispatch path is printed to stderr.

Usage: python bench.py [--rounds N] [--batch B] [--width W] [--height H]
                       [--preset P] [--timeout S]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

# Canonical emission order for the final summary; the device-program
# metric goes last.
METRIC_ORDER = [
    "4k_rgb_to_jpeg_throughput",
    "4k_rgb_to_jpeg_batch_throughput",
    "4k_device_only_throughput",
    "4k_device_program_throughput",
]


# ---------------------------------------------------------------- child


def child_main(args) -> int:
    import jax

    from dmmt_jpeg_encoder import ChromaSubsamplingPreset, EncoderConfig
    from dmmt_jpeg_encoder.debug.seeded_corpus import seeded_frame
    from dmmt_jpeg_encoder.encoder import (
        HuffmanTables,
        encode_array,
        encode_batch,
        pack_scan,
    )
    from dmmt_jpeg_encoder.onedispatch import (
        finish_one_dispatch,
        prefetch_one_dispatch,
        start_one_dispatch,
    )
    from dmmt_jpeg_encoder.pipeline import run_device_pipeline
    from dmmt_jpeg_encoder.tables import quantization_table_pair
    from dmmt_jpeg_encoder.utils.compile_cache import enable_compile_cache
    from dmmt_jpeg_encoder.utils.gpu_info import card_label

    enable_compile_cache()
    card = card_label()
    h, w = args.height, args.width
    mpix = h * w / 1e6
    config = EncoderConfig(
        chroma_subsampling=ChromaSubsamplingPreset(args.preset)
    )
    print(f"devices: {jax.devices()}; card: {card}", file=sys.stderr)

    def emit(metric: str, mpix_per_s: float, **extra) -> None:
        print(
            json.dumps(
                {
                    "metric": metric,
                    "value": mpix_per_s,
                    "unit": "Mpix/s",
                    "card": card,
                    **extra,
                }
            ),
            flush=True,
        )

    pixels = seeded_frame(h, w, seed=0)
    luma_q, chroma_q = quantization_table_pair(
        config.quantization_preset, config.quality
    )

    t0 = time.perf_counter()
    jpg = encode_array(pixels, 255, config)
    print(
        f"warmup (compile + encode): {time.perf_counter() - t0:.2f}s, "
        f"output {len(jpg)} bytes",
        file=sys.stderr,
    )

    # host tail of the two-dispatch path (second pass; the first warms)
    for _ in range(2):
        result = run_device_pipeline(pixels, 255, config, luma_q, chroma_q)
        jax.device_get(result.luma_dc_hist)
        t0 = time.perf_counter()
        tables = HuffmanTables.from_histograms(result)
        t_tables = time.perf_counter() - t0
        t0 = time.perf_counter()
        pack_scan(result, tables, config)
        t_pack = time.perf_counter() - t0
    print(
        f"[{card}] two-dispatch host tail: huffman {t_tables * 1e3:.3f} ms "
        f"| scan-pack {t_pack * 1e3:.3f} ms",
        file=sys.stderr,
    )

    times = []
    for _ in range(args.rounds):
        t0 = time.perf_counter()
        encode_array(pixels, 255, config)
        times.append(time.perf_counter() - t0)
    emit("4k_rgb_to_jpeg_throughput", mpix / min(times),
         best_ms=min(times) * 1e3)

    batch = [
        np.ascontiguousarray(np.roll(pixels, i * 17, axis=0))
        for i in range(args.batch)
    ]
    encode_batch(batch, 255, config)  # warm
    t_batch = float("inf")
    for _ in range(args.rounds):
        t0 = time.perf_counter()
        encode_batch(batch, 255, config)
        t_batch = min(t_batch, time.perf_counter() - t0)
    emit("4k_rgb_to_jpeg_batch_throughput", len(batch) * mpix / t_batch,
         batch=len(batch), best_ms_per_image=t_batch / len(batch) * 1e3)

    dev_px = jax.device_put(pixels)
    jax.block_until_ready(dev_px)
    inflight = 8
    finish_one_dispatch(
        start_one_dispatch(dev_px, 255, config, luma_q, chroma_q), config
    )  # warm the speculative-fetch size cache
    best = float("inf")
    for _ in range(args.rounds):
        t0 = time.perf_counter()
        states = []
        for _ in range(inflight):
            st = start_one_dispatch(dev_px, 255, config, luma_q, chroma_q)
            prefetch_one_dispatch(st, config)
            states.append(st)
        for st in states:
            finish_one_dispatch(st, config)
        best = min(best, (time.perf_counter() - t0) / inflight)
    emit("4k_device_only_throughput", mpix / best, best_ms=best * 1e3)

    best = float("inf")
    for _ in range(args.rounds):
        t0 = time.perf_counter()
        states = [
            start_one_dispatch(dev_px, 255, config, luma_q, chroma_q)
            for _ in range(inflight)
        ]
        jax.device_get(states[-1].total_bits)
        best = min(best, (time.perf_counter() - t0) / inflight)
    emit("4k_device_program_throughput", mpix / best, best_ms=best * 1e3)
    return 0


# ----------------------------------------------------------- supervisor


def _run_attempt(cmd, timeout_s: float, metrics: dict) -> int | None:
    """Run the child; harvest JSON metric lines from its stdout.

    Returns the child's exit code, or None on timeout (child killed by
    exact PID)."""
    proc = subprocess.Popen(
        cmd,
        stdout=subprocess.PIPE,
        stderr=None,  # child diagnostics flow straight to our stderr
        text=True,
        bufsize=1,
    )

    def reader():
        for line in proc.stdout:
            line = line.rstrip("\n")
            try:
                obj = json.loads(line)
                metric = obj.get("metric")
            except (ValueError, AttributeError):
                metric = None
            if metric:
                metrics[metric] = obj
                print(line, flush=True)  # stream through as it happens
            elif line:
                print(line, file=sys.stderr)

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    deadline = time.monotonic() + timeout_s
    while proc.poll() is None:
        if time.monotonic() >= deadline:
            print(
                f"bench child timed out after {timeout_s:.0f}s; killing "
                f"pid {proc.pid}",
                file=sys.stderr,
            )
            proc.kill()
            proc.wait()
            t.join(timeout=10)
            return None
        time.sleep(1.0)
    t.join(timeout=10)
    return proc.returncode


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--width", type=int, default=3840)
    ap.add_argument("--height", type=int, default=2160)
    ap.add_argument("--preset", default="P420")
    ap.add_argument(
        "--timeout", type=float, default=1800.0,
        help="seconds for the measuring child, compilation included",
    )
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()

    if args.child:
        return child_main(args)

    cmd = [
        sys.executable, os.path.abspath(__file__), "--child",
        "--rounds", str(args.rounds), "--batch", str(args.batch),
        "--width", str(args.width), "--height", str(args.height),
        "--preset", args.preset,
    ]
    metrics: dict = {}
    rc = _run_attempt(cmd, args.timeout, metrics)
    # Canonical summary, device-program metric last. Summary lines carry
    # "final": true; earlier pass-through lines are crash-safety copies.
    for metric in METRIC_ORDER:
        if metric in metrics:
            print(json.dumps({**metrics[metric], "final": True}), flush=True)
    if rc != 0 or METRIC_ORDER[-1] not in metrics:
        print(
            f"bench: child {'timed out' if rc is None else f'exited rc={rc}'}"
            f"; metrics measured: {sorted(metrics)}",
            file=sys.stderr,
        )
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

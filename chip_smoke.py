#!/usr/bin/env python3
"""GPU smoke test: the encoder's main path on one card at real sizes.

    python chip_smoke.py            # phases 1-5 on one GPU
    python chip_smoke.py --multi    # phase 6 only: 4-GPU sharded paths

Phases (each prints a "== phase N: ... ==" label):

1. device  - the card's name and power limit (nvidia-smi), jax.devices(),
             the JAX version, whether the native C helpers loaded; compile
             the one-dispatch program at 4K and 8K (P420) and print the
             compile seconds and memory analysis.
2. parity  - the seeded corpus's ARAI keys (tests/goldens_seeded.json)
             through encode_array on the GPU: hashes must equal the pinned
             ones. Seeded 4K and 8K frames: GPU bytes must equal the host
             oracle (CPU backend, C packer) in this process, with zero
             differing coefficients. FUSED and SEPARATED: flipped
             coefficients are counted and must be single steps at .5
             rounding boundaries; decoded PSNR within 0.05 dB of the CPU
             encode.
3. cli     - a seeded 4K P3 PPM through the CLI; bytes equal encode_array.
4. batch   - encode_batch of 8 x 4K frames and of 64 x 512x512 tiles equal
             per-image encodes; the tiles must run as slab programs.
5. numbers - timings, each line tagged with the card's name and power
             limit.
6. multi   - (--multi) sharded encode_array over 4 GPUs and the sharded
             slab encode_batch of 8 x 4K frames, byte-identical to
             single-GPU encodes; per-device memory in use.

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}};
any failure exits nonzero without it. With no GPU the script exits nonzero
before any phase runs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
GOLDENS = REPO / "tests" / "goldens_seeded.json"

SIZE_4K = (2160, 3840)
SIZE_8K = (4320, 7680)
PSNR_SIZE = (576, 1024)
PSNR_TOLERANCE_DB = 0.05
HALF_STEP_EPS = 1e-3  # |frac(v) - 0.5| bound for a legitimate rounding flip


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str = "") -> None:
    print(msg, flush=True)


def phase(n: int, name: str) -> None:
    log(f"== phase {n}: {name} ==")


# --------------------------------------------------------------- helpers


def _qtables(cfg):
    from dmmt_jpeg_encoder.tables import quantization_table_pair

    return quantization_table_pair(cfg.quantization_preset, cfg.quality)


def _cpu_device():
    import jax

    return jax.devices("cpu")[0]


def host_oracle(px: np.ndarray, cfg) -> bytes:
    """The host oracle: CPU backend, host Huffman tables, C packer."""
    import dataclasses

    import jax

    from dmmt_jpeg_encoder import encode_array

    with jax.default_device(_cpu_device()):
        return encode_array(
            px, 255, dataclasses.replace(cfg, scan_backend="host")
        )


def coefficients(px: np.ndarray, cfg, device=None) -> list[np.ndarray]:
    """Phase-1 int16 coefficient blocks (luma, cb, cr) on `device`."""
    import jax

    from dmmt_jpeg_encoder.pipeline import run_device_pipeline

    lq, cq = _qtables(cfg)
    device = device or jax.devices()[0]
    with jax.default_device(device):
        r = run_device_pipeline(px, 255, cfg, lq, cq)
        return [np.asarray(a) for a in (r.luma, r.cb, r.cr)]


def undo_dpcm(blocks: np.ndarray) -> np.ndarray:
    """Raw DC values from a channel's DPCM-coded blocks (one chain)."""
    out = blocks.astype(np.int64)
    out[:, 0] = np.cumsum(out[:, 0])
    return out


def unrounded_p444(px: np.ndarray, cfg) -> list[np.ndarray]:
    """float64 DCT/q values before rounding, zigzag order, for a P444
    encode (raster block order, as the pipeline emits for P444)."""
    from dmmt_jpeg_encoder.ops.dct import dct_matrix
    from dmmt_jpeg_encoder.ops.geometry import padded_size
    from dmmt_jpeg_encoder.tables import ZIGZAG

    lq, cq = _qtables(cfg)
    h, w = px.shape[:2]
    ph, pw = padded_size(h, w, cfg.chroma_subsampling)
    rgb = np.zeros((ph, pw, 3), np.float32)
    rgb[:h, :w] = px.astype(np.float32) / np.float32(255.0)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = (r * 0.299 + g * 0.587 + b * 0.114 - 128.0 / 255.0) * 255.0
    cb = (r * -0.1687 + g * -0.3312 + b * 0.5) * 255.0
    cr = (r * 0.5 + g * -0.4186 + b * -0.0813) * 255.0
    c = dct_matrix().astype(np.float64)
    out = []
    for plane, q in ((y, lq), (cb, cq), (cr, cq)):
        blocks = (
            plane.reshape(ph // 8, 8, pw // 8, 8)
            .transpose(0, 2, 1, 3)
            .reshape(-1, 8, 8)
            .astype(np.float64)
        )
        coeff = (c @ blocks @ c.T).reshape(-1, 64)
        out.append((coeff / q.astype(np.float64))[:, ZIGZAG])
    return out


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0**2 / mse)


def decoded_psnr(jpeg: bytes, px: np.ndarray) -> float:
    from dmmt_jpeg_encoder.debug.jpeg_decoder import decode_jpeg

    return psnr(decode_jpeg(jpeg), px)


def _time_best(fn, rounds: int = 3) -> float:
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


# ---------------------------------------------------------------- phases


def phase_device(sizes=(SIZE_4K, SIZE_8K)) -> dict:
    """Compile the one-dispatch program per size; returns compile seconds."""
    import jax

    from dmmt_jpeg_encoder.config import (
        ChromaSubsamplingPreset,
        DCTVariant,
        EncoderConfig,
    )
    from dmmt_jpeg_encoder.onedispatch import _compiled_onedispatch
    from dmmt_jpeg_encoder.utils.native import load_native

    log(f"jax {jax.__version__}; devices: {jax.devices()}")
    log(f"native C helpers loaded: {load_native() is not None}")
    cfg = EncoderConfig()
    lq, cq = _qtables(cfg)
    out = {}
    for h, w in sizes:
        fn = _compiled_onedispatch(
            h, w, ChromaSubsamplingPreset.P420, DCTVariant.ARAI
        )
        specs = (
            jax.ShapeDtypeStruct((h, w, 3), np.uint8),
            jax.ShapeDtypeStruct((), np.float32),
            jax.ShapeDtypeStruct(lq.shape, lq.dtype),
            jax.ShapeDtypeStruct(cq.shape, cq.dtype),
        )
        t0 = time.perf_counter()
        compiled = fn.lower(*specs).compile()
        secs = time.perf_counter() - t0
        out[(h, w)] = secs
        log(f"one-dispatch program {w}x{h} P420: compile {secs:.2f} s")
        log(f"  memory_analysis: {compiled.memory_analysis()}")
    return out


def phase_parity(
    frames=(SIZE_4K, SIZE_8K),
    keys=None,
    variant_size=SIZE_4K,
    psnr_size=PSNR_SIZE,
) -> dict:
    """keys: seeded-corpus keys to check (None = every ARAI key; FUSED
    output may legitimately differ per backend and is checked below
    against its tolerance)."""
    import jax

    from dmmt_jpeg_encoder import encode_array
    from dmmt_jpeg_encoder.config import (
        ChromaSubsamplingPreset,
        DCTVariant,
        EncoderConfig,
    )
    from dmmt_jpeg_encoder.debug.seeded_corpus import (
        corpus_keys,
        encode_key,
        seeded_frame,
        sha256,
    )

    report: dict = {}
    if keys is None:
        keys = [k for k in corpus_keys() if k.endswith("|arai")]
    if keys:
        pinned = json.loads(GOLDENS.read_text())
        same = {"arai": 0, "fused": 0}
        total = {"arai": 0, "fused": 0}
        for key in keys:
            variant = key.rsplit("|", 1)[1]
            got = sha256(encode_key(key)) == pinned[key]
            total[variant] += 1
            same[variant] += got
            if variant == "arai":
                check(got, f"seeded corpus {key}: hash differs from pinned")
        log(
            f"seeded corpus: ARAI {same['arai']}/{total['arai']} and FUSED "
            f"{same['fused']}/{total['fused']} byte-identical to the "
            "pinned host-oracle hashes"
        )
        report["corpus"] = same

    gpu = jax.devices()[0]
    cpu = _cpu_device()
    for i, (h, w) in enumerate(frames):
        px = seeded_frame(h, w, seed=10 + i)
        cfg = EncoderConfig()
        got = encode_array(px, 255, cfg)
        want = host_oracle(px, cfg)
        diff = sum(
            int(np.count_nonzero(a != b))
            for a, b in zip(coefficients(px, cfg, gpu), coefficients(px, cfg, cpu))
        )
        log(
            f"ARAI {w}x{h} P420: GPU {len(got)} bytes, host oracle "
            f"{len(want)} bytes, identical={got == want}, differing "
            f"coefficients GPU vs CPU: {diff}"
        )
        check(diff == 0, f"ARAI {w}x{h}: {diff} coefficients differ")
        check(got == want, f"ARAI {w}x{h}: bytes differ from host oracle")

    # Matmul variants: XLA picks the summation order, so a coefficient on
    # a .5 rounding boundary may round one step differently per backend.
    h, w = variant_size
    px = seeded_frame(h, w, seed=30)
    p444 = ChromaSubsamplingPreset.P444
    for variant in (DCTVariant.FUSED, DCTVariant.SEPARATED):
        cfg = EncoderConfig(chroma_subsampling=p444, dct_variant=variant)
        g = [undo_dpcm(a) for a in coefficients(px, cfg, gpu)]
        c = [undo_dpcm(a) for a in coefficients(px, cfg, cpu)]
        ref = unrounded_p444(px, cfg)
        flips, worst, off_boundary = 0, 0, 0
        for ga, ca, ra in zip(g, c, ref):
            d = ga - ca
            idx = np.nonzero(d)
            flips += len(idx[0])
            if len(idx[0]):
                worst = max(worst, int(np.abs(d).max()))
                v = np.abs(ra[idx])
                off_boundary += int(
                    np.count_nonzero(np.abs(v - np.floor(v) - 0.5) > HALF_STEP_EPS)
                )
        n_coef = sum(a.size for a in g)
        log(
            f"{variant.value} {w}x{h} P444: {flips} of {n_coef} coefficients "
            f"differ GPU vs CPU (max |diff| {worst}, {off_boundary} away "
            f"from a .5 boundary)"
        )
        check(worst <= 1, f"{variant.value}: a coefficient moved {worst} steps")
        check(off_boundary == 0, f"{variant.value}: flip off a .5 boundary")
        report[variant.value] = flips

    h, w = psnr_size
    px = seeded_frame(h, w, seed=40)
    for variant in (DCTVariant.FUSED, DCTVariant.SEPARATED):
        cfg = EncoderConfig(dct_variant=variant)
        p_gpu = decoded_psnr(encode_array(px, 255, cfg), px)
        p_cpu = decoded_psnr(host_oracle(px, cfg), px)
        log(
            f"{variant.value} {w}x{h} P420 decoded PSNR: GPU {p_gpu:.4f} dB, "
            f"CPU {p_cpu:.4f} dB, delta {p_gpu - p_cpu:+.4f} dB"
        )
        check(
            abs(p_gpu - p_cpu) <= PSNR_TOLERANCE_DB,
            f"{variant.value}: PSNR delta beyond {PSNR_TOLERANCE_DB} dB",
        )
    return report


def phase_cli(size=SIZE_4K, workdir: str | None = None) -> None:
    from dmmt_jpeg_encoder import cli, encode_array
    from dmmt_jpeg_encoder.config import EncoderConfig
    from dmmt_jpeg_encoder.debug.seeded_corpus import seeded_frame
    from dmmt_jpeg_encoder.io.ppm import write_ppm

    h, w = size
    px = seeded_frame(h, w, seed=50)
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        src, dst = Path(tmp) / "in.ppm", Path(tmp) / "out.jpg"
        write_ppm(src, px)
        t0 = time.perf_counter()
        rc = cli.main([str(src), str(dst)])
        secs = time.perf_counter() - t0
        check(rc == 0, f"CLI exited {rc}")
        got = dst.read_bytes()
    want = encode_array(px, 255, EncoderConfig())
    log(
        f"CLI {w}x{h}: {len(got)} bytes in {secs:.2f} s (incl. compile), "
        f"equal to encode_array: {got == want}"
    )
    check(got == want, "CLI bytes differ from encode_array")


class _SlabSpy:
    """Counts slab-program dispatches (depth per call) while active."""

    def __enter__(self):
        from dmmt_jpeg_encoder import onedispatch

        self.mod = onedispatch
        self.real = onedispatch.start_one_dispatch_slab
        self.depths: list[int] = []

        def spy(stack, *a, **k):
            self.depths.append(int(stack.shape[0]))
            return self.real(stack, *a, **k)

        onedispatch.start_one_dispatch_slab = spy
        return self

    def __exit__(self, *exc):
        self.mod.start_one_dispatch_slab = self.real


def phase_batch(frame_size=SIZE_4K, n_frames=8, tile=512, n_tiles=64) -> dict:
    from dmmt_jpeg_encoder import encode_array, encode_batch
    from dmmt_jpeg_encoder.config import EncoderConfig
    from dmmt_jpeg_encoder.debug.seeded_corpus import seeded_frame

    cfg = EncoderConfig()
    h, w = frame_size
    frames = [seeded_frame(h, w, seed=60 + i) for i in range(n_frames)]
    got = encode_batch(frames, 255, cfg)
    want = [encode_array(px, 255, cfg) for px in frames]
    log(f"encode_batch {n_frames} x {w}x{h}: equal per-image: {got == want}")
    check(got == want, "frame batch differs from per-image encodes")

    tiles = [seeded_frame(tile, tile, seed=100 + i) for i in range(n_tiles)]
    with _SlabSpy() as spy:
        t0 = time.perf_counter()
        got = encode_batch(tiles, 255, cfg)
        first = time.perf_counter() - t0
    want = [encode_array(px, 255, cfg) for px in tiles]
    log(
        f"encode_batch {n_tiles} x {tile}x{tile}: slab programs of depth "
        f"{spy.depths}, first call {first:.2f} s (incl. compile), equal "
        f"per-image: {got == want}"
    )
    check(spy.depths and sum(spy.depths) == n_tiles, "tiles bypassed the slab")
    check(got == want, "tile batch differs from per-image encodes")
    return {"frames": frames, "tiles": tiles, "slab_depths": spy.depths,
            "slab_first_call_s": first}


def _program_floor(dev_px, cfg, n: int = 8) -> float:
    """Seconds per image over n pipelined one-dispatch programs."""
    import jax

    from dmmt_jpeg_encoder.onedispatch import start_one_dispatch

    lq, cq = _qtables(cfg)
    jax.block_until_ready(
        start_one_dispatch(dev_px, 255, cfg, lq, cq).words
    )

    def run():
        states = [
            start_one_dispatch(dev_px, 255, cfg, lq, cq) for _ in range(n)
        ]
        jax.block_until_ready(
            [(s.words, s.total_bits, s.spec_syms) for s in states]
        )

    return _time_best(run) / n


def histogram_ab(dev_px, cfg, forms: dict) -> dict:
    """Program floor with each histogram form swapped into the
    one-dispatch program; forms: name -> bin_counts function. The form in
    use is timed first, from the already compiled program."""
    import jax

    from dmmt_jpeg_encoder.entropy import categorize
    from dmmt_jpeg_encoder.onedispatch import (
        _compiled_onedispatch,
        start_one_dispatch,
    )

    lq, cq = _qtables(cfg)
    kept = categorize.bin_counts
    times, streams = {}, {}
    order = sorted(forms, key=lambda n: forms[n] is not kept)
    try:
        for name in order:
            fn = forms[name]
            if fn is not categorize.bin_counts:
                categorize.bin_counts = fn
                _compiled_onedispatch.cache_clear()
            times[name] = _program_floor(dev_px, cfg)
            st = start_one_dispatch(dev_px, 255, cfg, lq, cq)
            streams[name] = (int(st.total_bits), np.asarray(st.words))
    finally:
        categorize.bin_counts = kept
        _compiled_onedispatch.cache_clear()
    ref = next(iter(streams.values()))
    for name, (bits, words) in streams.items():
        check(
            bits == ref[0] and np.array_equal(words, ref[1]),
            f"histogram form {name} changed the stream",
        )
    jax.clear_caches()
    return times


def _scatter_histogram(symbols, weights, n_bins):
    """The int32 scatter-add histogram form, kept here for the A/B against
    the matmul form the encoder uses (entropy/categorize.py)."""
    import jax.numpy as jnp

    flat_s = symbols.reshape(-1).astype(jnp.int32)
    flat_w = weights.reshape(-1).astype(jnp.int32)
    return jnp.zeros((n_bins,), jnp.int32).at[flat_s].add(flat_w, mode="drop")


def phase_numbers(card: str, batch: dict, size=SIZE_4K) -> None:
    import jax

    from dmmt_jpeg_encoder import encode_array, encode_batch
    from dmmt_jpeg_encoder.config import EncoderConfig
    from dmmt_jpeg_encoder.debug.seeded_corpus import seeded_frame
    from dmmt_jpeg_encoder.entropy import categorize

    tag = f"[{card}]"
    cfg = EncoderConfig()
    h, w = size
    px = seeded_frame(h, w, seed=70)
    encode_array(px, 255, cfg)
    t = _time_best(lambda: encode_array(px, 255, cfg), rounds=5)
    log(f"{tag} encode_array {w}x{h} warm: {t * 1e3:.3f} ms/frame")

    dev_px = jax.device_put(px)
    t = _program_floor(dev_px, cfg)
    log(
        f"{tag} one-dispatch program {w}x{h}, 8 pipelined: "
        f"{t * 1e3:.3f} ms/frame"
    )

    frames = batch["frames"]
    t = _time_best(lambda: encode_batch(frames, 255, cfg), rounds=2)
    log(
        f"{tag} encode_batch {len(frames)} x {w}x{h}: "
        f"{t / len(frames) * 1e3:.3f} ms/frame"
    )
    tiles = batch["tiles"]
    t = _time_best(lambda: encode_batch(tiles, 255, cfg), rounds=2)
    log(
        f"{tag} slab depth {batch['slab_depths']} for {len(tiles)} tiles: "
        f"first call {batch['slab_first_call_s']:.2f} s (incl. compile), "
        f"warm {t / len(tiles) * 1e3:.3f} ms/tile"
    )

    forms = {"matmul": categorize.matmul_histogram,
             "scatter": _scatter_histogram}
    times = histogram_ab(dev_px, cfg, forms)
    for name, secs in times.items():
        kept = " (kept)" if forms[name] is categorize.bin_counts else ""
        log(
            f"{tag} histogram {name}{kept} inside the one-dispatch program "
            f"{w}x{h}: {secs * 1e3:.3f} ms/frame"
        )
    stats = jax.devices()[0].memory_stats() or {}
    log(f"{tag} peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")


def phase_multi(n_shards: int = 4, size=SIZE_4K, n_frames: int = 8) -> None:
    import jax

    from dmmt_jpeg_encoder import encode_array, encode_batch
    from dmmt_jpeg_encoder.config import EncoderConfig
    from dmmt_jpeg_encoder.debug.seeded_corpus import seeded_frame
    from dmmt_jpeg_encoder.parallel import sharding

    check(
        len(jax.devices()) >= n_shards,
        f"--multi needs {n_shards} devices, found {len(jax.devices())}",
    )
    single = EncoderConfig()
    sharded = EncoderConfig(num_shards=n_shards)
    h, w = size
    px = seeded_frame(h, w, seed=80)
    got = encode_array(px, 255, sharded)
    want = encode_array(px, 255, single)
    log(f"sharded encode_array {w}x{h} over {n_shards}: identical={got == want}")
    check(got == want, "sharded encode_array differs from single-device")

    frames = [seeded_frame(h, w, seed=90 + i) for i in range(n_frames)]
    calls: list[int] = []
    real = sharding.start_sharded_encode_slab

    def spy(stack, *a, **k):
        calls.append(int(stack.shape[0]))
        return real(stack, *a, **k)

    sharding.start_sharded_encode_slab = spy
    try:
        got = encode_batch(frames, 255, sharded)
    finally:
        sharding.start_sharded_encode_slab = real
    want = [encode_array(f, 255, single) for f in frames]
    log(
        f"sharded-slab encode_batch {n_frames} x {w}x{h} over {n_shards}: "
        f"slab depths {calls}, identical={got == want}"
    )
    check(calls, "sharded batch bypassed the sharded slab program")
    check(got == want, "sharded slab batch differs from single-device")
    for d in jax.devices()[:n_shards]:
        stats = d.memory_stats() or {}
        log(
            f"{d}: bytes_in_use {stats.get('bytes_in_use')}, "
            f"peak_bytes_in_use {stats.get('peak_bytes_in_use')}"
        )


# ------------------------------------------------------------------ main


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--multi", action="store_true",
        help="run only the 4-GPU sharded phase",
    )
    args = ap.parse_args(argv)
    try:
        import jax

        devices = jax.devices()
        if devices[0].platform != "gpu":
            print(
                f"chip_smoke: no GPU found (JAX devices: {devices})",
                file=sys.stderr,
            )
            return 2
        from dmmt_jpeg_encoder.utils.compile_cache import enable_compile_cache
        from dmmt_jpeg_encoder.utils.gpu_info import card_label, card_lines

        log(f"compile cache: {enable_compile_cache()}")
        for line in card_lines():
            log(line)
        card = card_label()
        # correctness phases cross-check every packed bit count against
        # the histograms x tables prediction; the timed phase does not
        os.environ["DMMT_CHECK_BITS"] = "1"
        if args.multi:
            phase(6, "multi")
            phase_multi()
        else:
            phase(1, "device")
            phase_device()
            phase(2, "parity")
            phase_parity()
            phase(3, "cli")
            phase_cli()
            phase(4, "batch")
            batch = phase_batch()
            os.environ.pop("DMMT_CHECK_BITS")
            phase(5, "numbers")
            phase_numbers(card, batch)
        log(card)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Host orchestration: full PPM -> JPEG encode.

The counterpart of the reference's `convert_ppm_to_jpeg`
(reference: src/lib.rs:59-77) and JpegImageWriter
(src/image/writer/jpeg.rs:41-75): device pipeline -> per-image optimal
Huffman tables (from device histograms) -> native scan packing -> JFIF
container assembly.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .bitstream.packer import encode_scan
from .config import EncoderConfig
from .container import assemble_jpeg
from .huffman.canonical import flat_code_arrays
from .huffman.spec import SymbolCodeLength, code_lengths_from_histogram
from .io.ppm import PPMImage, read_ppm, read_ppm_bytes
from .onedispatch import slab_max_blocks, use_one_dispatch
from .pipeline import DeviceEncodeResult, run_device_pipeline
from .tables import quantization_table_pair
from .utils.capability import resolve_scan_backend

# Row-stacked slab batching (onedispatch.start_one_dispatch_slab) is used
# for same-geometry images of at most SLAB_MAX_ROWS padded rows each
# (DMMT_SLAB_MAX_ROWS overrides): small images are where one program per
# image leaves the device least used. Whether stacking also pays for
# taller images has not been measured on the GPU. SLAB_MAX_DEPTH bounds
# the images per program: program size and compile time grow linearly
# with depth. Both are bounds, not measured optima.
SLAB_MAX_ROWS = 1088
SLAB_MAX_DEPTH = 64


@dataclass
class HuffmanTables:
    """The four per-image code-length lists (descending length order),
    the OutputImage fields of the reference (src/image/writer/jpeg.rs:77-88)."""

    luma_dc: list[SymbolCodeLength]
    luma_ac: list[SymbolCodeLength]
    chroma_dc: list[SymbolCodeLength]
    chroma_ac: list[SymbolCodeLength]

    @classmethod
    def from_histograms(cls, result: DeviceEncodeResult) -> "HuffmanTables":
        _materialize_histograms(result)
        return cls(
            luma_dc=code_lengths_from_histogram(result.luma_dc_hist),
            luma_ac=code_lengths_from_histogram(result.luma_ac_hist),
            chroma_dc=code_lengths_from_histogram(result.chroma_dc_hist),
            chroma_ac=code_lengths_from_histogram(result.chroma_ac_hist),
        )


def _materialize_histograms(result: DeviceEncodeResult) -> None:
    """Fetch all four histograms in ONE device_get (four separate
    np.asarray calls would each pay a device round trip) and cache them
    as numpy on the result."""
    if isinstance(result.luma_dc_hist, np.ndarray):
        return
    import jax

    (
        result.luma_dc_hist,
        result.luma_ac_hist,
        result.chroma_dc_hist,
        result.chroma_ac_hist,
    ) = jax.device_get(
        (
            result.luma_dc_hist,
            result.luma_ac_hist,
            result.chroma_dc_hist,
            result.chroma_ac_hist,
        )
    )


def pack_scan(
    result: DeviceEncodeResult,
    tables: HuffmanTables,
    config: EncoderConfig,
    use_native: bool = True,
) -> bytes:
    if resolve_scan_backend(config.scan_backend) == "device":
        from .bitstream.device_pack import device_pack_scan, exact_scan_bits

        ldc = flat_code_arrays(tables.luma_dc)
        lac = flat_code_arrays(tables.luma_ac)
        cdc = flat_code_arrays(tables.chroma_dc)
        cac = flat_code_arrays(tables.chroma_ac)
        known_bits = exact_scan_bits(
            (
                np.asarray(result.luma_dc_hist),
                np.asarray(result.luma_ac_hist),
                np.asarray(result.chroma_dc_hist),
                np.asarray(result.chroma_ac_hist),
            ),
            ldc,
            lac,
            cdc,
            cac,
        )
        return device_pack_scan(
            result.luma,
            result.cb,
            result.cr,
            config.chroma_subsampling.luma_blocks_per_mcu,
            ldc,
            lac,
            cdc,
            cac,
            known_bits=known_bits,
        )
    return encode_scan(
        np.asarray(result.luma),
        np.asarray(result.cb) if result.cb is not None else None,
        np.asarray(result.cr) if result.cr is not None else None,
        config.chroma_subsampling.luma_blocks_per_mcu,
        flat_code_arrays(tables.luma_dc),
        flat_code_arrays(tables.luma_ac),
        flat_code_arrays(tables.chroma_dc),
        flat_code_arrays(tables.chroma_ac),
        use_native=use_native,
    )


def _narrow_pixels(pixels: np.ndarray, maxval: int) -> np.ndarray:
    """uint8 upload when the sample range allows — halves host->device
    traffic; the device pipeline normalizes by maxval either way."""
    if maxval <= 255 and pixels.dtype != np.uint8:
        return pixels.astype(np.uint8)
    return pixels


def _slab_depth(
    n_images: int, blocks: int, rows: int, num_shards: int = 1
) -> int:
    """Images per row-stacked slab program for a same-geometry batch of
    n_images (1 = the per-image pipeline). blocks: 8x8 blocks of one
    image; rows: padded rows of one image per shard. DMMT_SLAB_B forces a
    depth (still within the block and row bounds)."""
    rows_cap = int(os.environ.get("DMMT_SLAB_MAX_ROWS", SLAB_MAX_ROWS))
    if rows > rows_cap:
        return 1
    b_max = slab_max_blocks() * num_shards // max(blocks, 1)
    b_env = os.environ.get("DMMT_SLAB_B", "auto")
    if b_env == "auto":
        return min(n_images, b_max, SLAB_MAX_DEPTH)
    return min(n_images, int(b_env), b_max)


def encode_array(
    pixels: np.ndarray,
    maxval: int = 255,
    config: EncoderConfig | None = None,
    use_native: bool = True,
) -> bytes:
    """uint8/uint16 RGB [H, W, 3] samples -> complete JPEG bytes."""
    config = config or EncoderConfig()
    luma_q, chroma_q = quantization_table_pair(config.quantization_preset, config.quality)
    backend = resolve_scan_backend(config.scan_backend)
    if config.num_shards > 1:
        if backend == "device":
            # Per-shard device packing + host bit-merge of shard segments.
            from .parallel.sharding import encode_sharded_scan

            scan, tables = encode_sharded_scan(
                _narrow_pixels(pixels, maxval), maxval, config
            )
            return assemble_jpeg(
                width=int(pixels.shape[1]),
                height=int(pixels.shape[0]),
                bits_per_channel=config.bits_per_channel,
                preset=config.chroma_subsampling,
                luma_quant=luma_q,
                chroma_quant=chroma_q,
                luma_dc=tables.luma_dc,
                luma_ac=tables.luma_ac,
                chroma_dc=tables.chroma_dc,
                chroma_ac=tables.chroma_ac,
                scan_bytes=scan,
            )
        from .parallel.sharding import run_sharded_pipeline

        result = run_sharded_pipeline(pixels, maxval, config, luma_q, chroma_q)
        tables = HuffmanTables.from_histograms(result)
        scan = pack_scan(result, tables, config, use_native=use_native)
    elif backend == "device" and use_one_dispatch(
        config, int(pixels.shape[0]), int(pixels.shape[1])
    ):
        from .onedispatch import finish_one_dispatch, start_one_dispatch

        state = start_one_dispatch(
            _narrow_pixels(pixels, maxval), maxval, config, luma_q, chroma_q
        )
        scan, tables = finish_one_dispatch(state, config)
    else:
        result = run_device_pipeline(
            _narrow_pixels(pixels, maxval), maxval, config, luma_q, chroma_q
        )
        tables = HuffmanTables.from_histograms(result)
        scan = pack_scan(result, tables, config, use_native=use_native)
    return assemble_jpeg(
        width=int(pixels.shape[1]),
        height=int(pixels.shape[0]),
        bits_per_channel=config.bits_per_channel,
        preset=config.chroma_subsampling,
        luma_quant=luma_q,
        chroma_quant=chroma_q,
        luma_dc=tables.luma_dc,
        luma_ac=tables.luma_ac,
        chroma_dc=tables.chroma_dc,
        chroma_ac=tables.chroma_ac,
        scan_bytes=scan,
    )


def encode_batch(
    images: list[np.ndarray],
    maxval: int = 255,
    config: EncoderConfig | None = None,
    fused_batch: int = 0,
) -> list[bytes]:
    """Encode many images at batch throughput.

    Same-geometry batches of small images run as row-stacked slab
    programs (_encode_batch_slab). Otherwise: a software pipeline over the
    SINGLE-image executables — JAX dispatch is async, so image i+1's
    device work overlaps image i's host tail and fetches, with no extra
    compilation.

    fused_batch > 1 opts into the LEGACY fused path for same-shape images
    (one vmapped pipeline dispatch + one batched scan-pack dispatch per
    chunk); it remains for API compatibility and as a cross-check path.
    (The reference encodes one image per process; batch encode is this
    framework's throughput scenario, BASELINE.md.)"""
    config = config or EncoderConfig()
    if config.num_shards > 1:
        return _encode_batch_sharded(images, maxval, config)

    import jax

    backend = resolve_scan_backend(config.scan_backend)
    same_shape = len({px.shape for px in images}) == 1
    h0, w0 = int(images[0].shape[0]), int(images[0].shape[1])
    if (
        backend == "device"
        and same_shape
        and len(images) > 1
        and fused_batch <= 1
        and os.environ.get("DMMT_SLAB", "1") != "0"
        and use_one_dispatch(config, h0, w0)
    ):
        from .onedispatch import _total_blocks
        from .ops.geometry import padded_size

        blocks = _total_blocks(h0, w0, config.chroma_subsampling)
        ph0, _ = padded_size(h0, w0, config.chroma_subsampling)
        slab_b = _slab_depth(len(images), blocks, ph0)
        if slab_b >= 2:
            return _encode_batch_slab(images, maxval, config, slab_b)
    if backend == "device" and same_shape and len(images) > 1 and fused_batch > 1:
        from .onedispatch import _total_blocks

        # the slab path's compile-size bound caps the vmapped chunk too
        blocks_per_image = _total_blocks(h0, w0, config.chroma_subsampling)
        chunk = min(fused_batch, slab_max_blocks() // max(blocks_per_image, 1))
        if chunk >= 2:
            out: list[bytes] = []
            for i in range(0, len(images), chunk):
                part = images[i : i + chunk]
                if len(part) == 1:
                    out.append(encode_array(part[0], maxval, config))
                else:
                    out.extend(_encode_batch_fused(part, maxval, config))
            return out
        # Images too large to fuse even two per dispatch: fall through to
        # the pipelined per-image path.
    luma_q, chroma_q = quantization_table_pair(config.quantization_preset, config.quality)

    results: list[tuple | None] = [None] * len(images)
    out: list[bytes | None] = [None] * len(images)

    def finish(i: int) -> None:
        kind, payload = results[i]
        if kind == "od":
            from .onedispatch import finish_one_dispatch

            scan, tables = finish_one_dispatch(payload, config)
        else:
            tables = HuffmanTables.from_histograms(payload)
            scan = pack_scan(payload, tables, config)
        out[i] = assemble_jpeg(
            width=int(images[i].shape[1]),
            height=int(images[i].shape[0]),
            bits_per_channel=config.bits_per_channel,
            preset=config.chroma_subsampling,
            luma_quant=luma_q,
            chroma_quant=chroma_q,
            luma_dc=tables.luma_dc,
            luma_ac=tables.luma_ac,
            chroma_dc=tables.chroma_dc,
            chroma_ac=tables.chroma_ac,
            scan_bytes=scan,
        )
        results[i] = None  # release device blocks

    # Pipelined uploads: the next DMMT_UPLOAD_DEPTH images' host->device
    # transfers are issued (asynchronously) before image i's host tail
    # runs, so the transfers and the host work overlap.
    depth = max(1, int(os.environ.get("DMMT_UPLOAD_DEPTH", "2")))
    n = len(images)
    dev: list[object | None] = [None] * n

    def upload(idx: int) -> None:
        dev[idx] = jax.device_put(_narrow_pixels(images[idx], maxval))

    for j in range(min(depth, n)):
        upload(j)
    for i in range(n):
        h, w = int(images[i].shape[0]), int(images[i].shape[1])
        if backend == "device" and use_one_dispatch(config, h, w):
            from .onedispatch import prefetch_one_dispatch, start_one_dispatch

            results[i] = (
                "od",
                start_one_dispatch(dev[i], maxval, config, luma_q, chroma_q),
            )
            # Queue image i's device->host copies behind its program now,
            # so finish(i) after the NEXT dispatch finds them done instead
            # of paying a blocking round trip.
            prefetch_one_dispatch(results[i][1], config)
        else:
            results[i] = (
                "std",
                run_device_pipeline(dev[i], maxval, config, luma_q, chroma_q),
            )
        dev[i] = None  # release the upload buffer
        if i + depth < n:
            upload(i + depth)
        if i > 0:
            finish(i - 1)
    finish(n - 1)
    return out


# Reused host stack buffers for the slab path: fresh multi-MB allocations
# page-fault on first touch, so group stacks are assembled into
# long-lived buffers per (shape, dtype). TWO buffers rotate per key:
# jax.device_put may still be reading group g's buffer asynchronously
# when group g+1 is assembled (the two-deep pipeline keeps exactly one
# prior group in flight), so rewriting a single buffer would race the
# transfer on backends with truly async host reads.
_SLAB_STACK_BUF: dict[tuple, list] = {}


def _encode_batch_slab(
    images: list[np.ndarray],
    maxval: int,
    config: EncoderConfig,
    slab_b: int,
) -> list[bytes]:
    """Batch encode via ROW-STACKED SLAB programs: groups of slab_b
    same-geometry images run as ONE device program each
    (onedispatch.start_one_dispatch_slab), amortizing the per-program
    fixed work (table-build sorts, dispatch) across the group.
    Two-deep pipelined like the per-image path: group g+1's upload and
    dispatch are issued before group g's host tails run. Bytes equal
    per-image encode_array output (tested)."""
    import jax

    from .onedispatch import (
        finish_one_dispatch,
        prefetch_one_dispatch,
        start_one_dispatch,
        start_one_dispatch_slab,
    )
    from .ops.geometry import padded_size

    luma_q, chroma_q = quantization_table_pair(
        config.quantization_preset, config.quality
    )
    h, w = int(images[0].shape[0]), int(images[0].shape[1])
    ph, pw = padded_size(h, w, config.chroma_subsampling)

    def stack_group(part: list[np.ndarray]):
        """Assemble the group into a reused pre-padded stack buffer
        (alternating between two per key — see _SLAB_STACK_BUF).

        The key includes the TRUE image size, not just the padded one:
        the fill only writes [:h, :w], so a buffer shared between
        different true sizes with the same padded size would leak the
        previous batch's pixels into the black pad region (caught by
        tests/test_slab_onepack.py run after test_slab.py)."""
        first = _narrow_pixels(part[0], maxval)
        key = (len(part), h, w, ph, pw, first.dtype)
        slot = _SLAB_STACK_BUF.get(key)
        if slot is None:
            slot = [0, None, None]
            _SLAB_STACK_BUF[key] = slot
        idx = 1 + (slot[0] & 1)
        slot[0] += 1
        buf = slot[idx]
        if buf is None:
            buf = np.zeros((len(part), ph, pw, 3), dtype=first.dtype)
            slot[idx] = buf
        buf[0, :h, :w] = first
        for j, px in enumerate(part[1:], start=1):
            buf[j, :h, :w] = _narrow_pixels(px, maxval)
        return buf

    groups = [
        images[i : i + slab_b] for i in range(0, len(images), slab_b)
    ]
    out: list[bytes] = []
    pending: list[tuple[list, list]] = []  # (states, group)

    def drain() -> None:
        states, part = pending.pop(0)
        for px, st in zip(part, states):
            scan, tables = finish_one_dispatch(st, config)
            out.append(
                assemble_jpeg(
                    width=int(px.shape[1]),
                    height=int(px.shape[0]),
                    bits_per_channel=config.bits_per_channel,
                    preset=config.chroma_subsampling,
                    luma_quant=luma_q,
                    chroma_quant=chroma_q,
                    luma_dc=tables.luma_dc,
                    luma_ac=tables.luma_ac,
                    chroma_dc=tables.chroma_dc,
                    chroma_ac=tables.chroma_ac,
                    scan_bytes=scan,
                )
            )

    for part in groups:
        if len(part) == 1:
            # a trailing single through the single-image one-dispatch —
            # bytes identical either way
            states = []
            for px in part:
                dev = jax.device_put(_narrow_pixels(px, maxval))
                st = start_one_dispatch(
                    dev, maxval, config, luma_q, chroma_q
                )
                prefetch_one_dispatch(st, config)
                states.append(st)
        else:
            stacked = stack_group(part)
            dev = jax.device_put(stacked)
            states = start_one_dispatch_slab(
                dev, maxval, config, luma_q, chroma_q
            )
            for st in states:
                prefetch_one_dispatch(st, config)
        pending.append((states, part))
        if len(pending) > 1:
            drain()
    while pending:
        drain()
    return out


def _encode_batch_sharded(
    images: list[np.ndarray], maxval: int, config: EncoderConfig
) -> list[bytes]:
    """Sharding x batching: a two-deep software pipeline over the sharded
    per-image executables — image i+1's multi-chip phase-1 dispatch
    overlaps image i's host table-build, per-shard packing sync, and
    container assembly. Bit-exact vs per-image encode_array (tested)."""
    if resolve_scan_backend(config.scan_backend) != "device":
        # Host packing needs the coefficient download anyway; run the
        # images through the non-pipelined path sequentially.
        return [encode_array(px, maxval, config) for px in images]

    from .parallel.sharding import (
        _use_sharded_onedispatch,
        finish_sharded_encode,
        start_sharded_encode,
    )

    luma_q, chroma_q = quantization_table_pair(
        config.quantization_preset, config.quality
    )

    # Same-geometry batches ride the SHARDED SLAB program (images
    # row-stacked per shard — the per-shard fixed work is paid once per
    # group), under the same bounds as the single-device slab gate
    # applied to each image's per-shard slice.
    same_shape = len({px.shape for px in images}) == 1
    if (
        same_shape
        and len(images) > 1
        and os.environ.get("DMMT_SLAB", "1") != "0"
        and _use_sharded_onedispatch(
            config, int(images[0].shape[0]), int(images[0].shape[1])
        )
    ):
        from .onedispatch import _total_blocks
        from .parallel.sharding import _shard_geometry

        h0, w0 = int(images[0].shape[0]), int(images[0].shape[1])
        blocks = _total_blocks(h0, w0, config.chroma_subsampling)
        _, _, rows_per_shard, _ = _shard_geometry(
            h0, w0, config.chroma_subsampling, config.num_shards
        )
        shard_rows = rows_per_shard * config.chroma_subsampling.mcu_height
        slab_b = _slab_depth(
            len(images), blocks, shard_rows, config.num_shards
        )
        if slab_b >= 2:
            return _encode_batch_sharded_slab(
                images, maxval, config, slab_b, luma_q, chroma_q
            )

    states: list[tuple | None] = [None] * len(images)
    out: list[bytes | None] = [None] * len(images)

    def finish(i: int) -> None:
        scan, tables = finish_sharded_encode(states[i], config)
        out[i] = assemble_jpeg(
            width=int(images[i].shape[1]),
            height=int(images[i].shape[0]),
            bits_per_channel=config.bits_per_channel,
            preset=config.chroma_subsampling,
            luma_quant=luma_q,
            chroma_quant=chroma_q,
            luma_dc=tables.luma_dc,
            luma_ac=tables.luma_ac,
            chroma_dc=tables.chroma_dc,
            chroma_ac=tables.chroma_ac,
            scan_bytes=scan,
        )
        states[i] = None  # release device blocks

    for i, px in enumerate(images):
        states[i] = start_sharded_encode(
            _narrow_pixels(px, maxval), maxval, config
        )
        if i > 0:
            finish(i - 1)
    finish(len(images) - 1)
    return out


def _encode_batch_sharded_slab(
    images: list[np.ndarray],
    maxval: int,
    config: EncoderConfig,
    slab_b: int,
    luma_q: np.ndarray,
    chroma_q: np.ndarray,
) -> list[bytes]:
    """Sharding x slab batching: groups of slab_b same-geometry images run
    as ONE sharded slab program each (parallel/sharding.py
    start_sharded_encode_slab), two-deep pipelined. Bytes equal per-image
    encodes (tested)."""
    from .parallel.sharding import (
        finish_sharded_encode,
        finish_sharded_encode_slab,
        start_sharded_encode,
        start_sharded_encode_slab,
    )

    h, w = int(images[0].shape[0]), int(images[0].shape[1])
    groups = [images[i : i + slab_b] for i in range(0, len(images), slab_b)]
    out: list[bytes] = []
    pending: list[tuple] = []

    def assemble(px, scan, tables) -> bytes:
        return assemble_jpeg(
            width=int(px.shape[1]),
            height=int(px.shape[0]),
            bits_per_channel=config.bits_per_channel,
            preset=config.chroma_subsampling,
            luma_quant=luma_q,
            chroma_quant=chroma_q,
            luma_dc=tables.luma_dc,
            luma_ac=tables.luma_ac,
            chroma_dc=tables.chroma_dc,
            chroma_ac=tables.chroma_ac,
            scan_bytes=scan,
        )

    def drain() -> None:
        kind, state, part = pending.pop(0)
        if kind == "slab":
            for px, (scan, tables) in zip(
                part, finish_sharded_encode_slab(state, config)
            ):
                out.append(assemble(px, scan, tables))
        else:
            scan, tables = finish_sharded_encode(state, config)
            out.append(assemble(part[0], scan, tables))

    for part in groups:
        if len(part) == 1:
            st = start_sharded_encode(
                _narrow_pixels(part[0], maxval), maxval, config
            )
            pending.append(("single", st, part))
        else:
            stacked = np.stack(
                [_narrow_pixels(px, maxval) for px in part]
            )
            st = start_sharded_encode_slab(stacked, maxval, config)
            pending.append(("slab", st, part))
        if len(pending) > 1:
            drain()
    while pending:
        drain()
    return out


def _encode_batch_fused(
    images: list[np.ndarray], maxval: int, config: EncoderConfig
) -> list[bytes]:
    """One batched pipeline dispatch + one batched scan-pack dispatch."""
    import jax

    from .bitstream.device_pack import (
        device_pack_scan_batch,
        exact_scan_bits,
    )
    from .pipeline import run_device_pipeline_batch

    luma_q, chroma_q = quantization_table_pair(config.quantization_preset, config.quality)
    stacked = np.stack([_narrow_pixels(px, maxval) for px in images])
    b = len(images)

    outputs = run_device_pipeline_batch(stacked, maxval, config, luma_q, chroma_q)
    luma, cb, cr = outputs[0], outputs[1], outputs[2]
    hists = jax.device_get(outputs[3:])  # sync #1: [B,16]/[B,256] x4

    tables_list, flats, bits_list = [], [], []
    for i in range(b):
        result = DeviceEncodeResult(
            luma=None, cb=None, cr=None,
            luma_dc_hist=hists[0][i],
            luma_ac_hist=hists[1][i],
            chroma_dc_hist=hists[2][i],
            chroma_ac_hist=hists[3][i],
        )
        tables = HuffmanTables.from_histograms(result)
        flat = (
            flat_code_arrays(tables.luma_dc),
            flat_code_arrays(tables.luma_ac),
            flat_code_arrays(tables.chroma_dc),
            flat_code_arrays(tables.chroma_ac),
        )
        tables_list.append(tables)
        flats.append(flat)
        bits_list.append(
            exact_scan_bits(
                (hists[0][i], hists[1][i], hists[2][i], hists[3][i]), *flat
            )
        )

    total_words = sum((bits + 31) // 32 for bits in bits_list)
    # Bucket the static output capacity (power of two) so jit re-use is high.
    words_cap = 1 << max(12, (total_words + len(images)).bit_length())
    scans = device_pack_scan_batch(
        luma, cb, cr,
        config.chroma_subsampling.luma_blocks_per_mcu,
        flats, bits_list, words_cap,
    )  # sync #2

    out = []
    for i in range(b):
        tables = tables_list[i]
        out.append(
            assemble_jpeg(
                width=int(images[i].shape[1]),
                height=int(images[i].shape[0]),
                bits_per_channel=config.bits_per_channel,
                preset=config.chroma_subsampling,
                luma_quant=luma_q,
                chroma_quant=chroma_q,
                luma_dc=tables.luma_dc,
                luma_ac=tables.luma_ac,
                chroma_dc=tables.chroma_dc,
                chroma_ac=tables.chroma_ac,
                scan_bytes=scans[i],
            )
        )
    return out


def encode_ppm_image(
    image: PPMImage, config: EncoderConfig | None = None, use_native: bool = True
) -> bytes:
    return encode_array(image.pixels, image.maxval, config, use_native=use_native)


def encode_ppm_bytes(data: bytes, config: EncoderConfig | None = None) -> bytes:
    return encode_ppm_image(read_ppm_bytes(data), config)


def convert_ppm_to_jpeg(
    input_file: str | Path,
    output_file: str | Path,
    config: EncoderConfig | None = None,
) -> None:
    """File-to-file encode (reference: src/lib.rs:59-77)."""
    image = read_ppm(input_file)
    jpeg = encode_ppm_image(image, config)
    Path(output_file).write_bytes(jpeg)

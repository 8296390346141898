"""Multi-chip encode: shard_map over MCU-row shards of the image.

The reference's only parallelism is an OS thread pool over 8x8-block chunks
with a shared mutable buffer (reference: src/cosine_transform.rs:55-73,
src/image/writer/jpeg/transformer.rs:126-138). The scale-out design
instead shards the image by MCU rows across a 1-D device mesh:

- every shard runs the identical static-shape pipeline on its slab
  (color convert -> subsample -> entangled blockize -> DCT -> quantize);
- the two whole-image sequential dependencies become collectives:
  * DC DPCM hand-off: the last pre-delta DC of shard i seeds shard i+1's
    chain via `lax.ppermute` (the reference's chain: categorize.rs:156-161);
  * Huffman statistics: per-shard symbol histograms are `psum`'d so every
    shard agrees on the global per-image tables (the reference counts over
    whole channels: transformer.rs:201-207);
- images whose MCU-row count is not divisible by the shard count are padded
  with extra black MCU rows; those alignment blocks are masked out of the
  histograms on device and dropped on host, so the output bitstream is
  BIT-EXACTLY the single-chip (and reference) bitstream for any image size.

On one host this runs over the local mesh; the same shard_map program laid
over a multi-host mesh sends only the psum (64+1024 ints) and one scalar
ppermute per channel across the network — nothing else crosses devices.
"""

from __future__ import annotations


import numpy as np
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..config import ChromaSubsamplingPreset, DCTVariant, EncoderConfig
from ..ops.fp import div
from ..entropy.categorize import dc_dpcm, symbol_histograms
from ..ops.color import rgb_to_ycbcr
from ..ops.dct import dct2d
from ..ops.geometry import (
    blockize,
    entangle_permutation,
    entangled_blockize_p420,
    padded_size,
    subsample,
)
from ..ops.quantize import quantize_zigzag
from ..pipeline import DeviceEncodeResult
from ..tables import quantization_table_pair
from ..utils.capability import mode_keyed_cache

AXIS = "mcu_rows"


def build_mesh(num_shards: int) -> Mesh:
    devices = jax.devices()
    if len(devices) < num_shards:
        raise ValueError(
            f"num_shards={num_shards} exceeds available devices ({len(devices)})"
        )
    return Mesh(np.asarray(devices[:num_shards]), (AXIS,))


def _shard_geometry(
    height: int, width: int, preset: ChromaSubsamplingPreset, num_shards: int
) -> tuple[int, int, int, int]:
    """(global padded H, padded W, MCU rows per shard, valid MCU rows)."""
    ph, pw = padded_size(height, width, preset)
    valid_mcu_rows = ph // preset.mcu_height
    rows_per_shard = -(-valid_mcu_rows // num_shards)
    ph_aligned = rows_per_shard * num_shards * preset.mcu_height
    return ph_aligned, pw, rows_per_shard, valid_mcu_rows


def _dc_handoff(zz: jnp.ndarray, num_shards: int) -> jnp.ndarray:
    """Replace each shard's DC column with the globally-chained DPCM deltas:
    shard i's first predictor is shard i-1's last raw DC (0 for shard 0)."""
    last_dc = zz[-1:, 0]  # [1] raw DC of this shard's final block
    prev = jax.lax.ppermute(
        last_dc, AXIS, [(i, i + 1) for i in range(num_shards - 1)]
    )  # shard 0 receives zeros
    return zz.at[:, 0].set(dc_dpcm(zz[:, 0], first_predictor=prev[0]))


def _dc_handoff_slab(
    zz: jnp.ndarray, num_shards: int, n_images: int
) -> jnp.ndarray:
    """Per-image cross-shard DPCM for a SLAB shard: the shard's block axis
    is n_images contiguous per-image segments (each the image's MCU-row
    slice on this shard). Every image's chain is seeded by the SAME
    image's last raw DC on the previous shard (0 on shard 0) — one
    ppermute of an [n_images] vector replaces n_images scalar hops."""
    if n_images == 1:
        return _dc_handoff(zz, num_shards)
    per = zz.shape[0] // n_images
    dc = zz[:, 0].reshape(n_images, per)
    prev = jax.lax.ppermute(
        dc[:, -1], AXIS, [(i, i + 1) for i in range(num_shards - 1)]
    )  # [n_images]; shard 0 receives zeros
    deltas = jax.vmap(lambda col, p: dc_dpcm(col, first_predictor=p))(
        dc, prev
    )
    return zz.at[:, 0].set(deltas.reshape(-1))


def _make_phase1_slab(
    n_images: int,
    height: int,
    width: int,
    preset: ChromaSubsamplingPreset,
    variant: DCTVariant,
    num_shards: int,
):
    """Per-shard phase-1 body for the SHARDED SLAB program: the shard
    holds [n_images, shard_h, pw, 3] (each image's MCU-row slice),
    row-stacks them into one tall slab, and runs one phase 1 — so the
    per-program fixed slice is paid once per n_images images per shard
    (the fixed-cost amortization the PERF.md scaling model calls for).

    Per-image independence: DC chains are per-image (cross-shard hand-off
    per image via one vector ppermute), histograms per image (psum'd per
    image over shards). Image boundaries never straddle MCU quads: shard_h
    is a multiple of the MCU height."""
    ph, pw, rows_per_shard, valid_mcu_rows = _shard_geometry(
        height, width, preset, num_shards
    )
    shard_h = rows_per_shard * preset.mcu_height
    tall_sh = n_images * shard_h
    entangle = entangle_permutation(pw // 8, tall_sh // 8, preset)
    luma_blocks_per_mcu_row = (pw // 8) * preset.vertical_rate
    chroma_w = pw // preset.horizontal_rate
    chroma_blocks_per_mcu_row = chroma_w // 8
    nl_si = (shard_h // 8) * (pw // 8)
    nc_si = (shard_h // preset.vertical_rate // 8) * (chroma_w // 8)

    def phase1(rgb_stack, maxval, luma_q, chroma_q):
        s = jax.lax.axis_index(AXIS)
        valid_rows = jnp.clip(
            valid_mcu_rows - s * rows_per_shard, 0, rows_per_shard
        )

        tall = rgb_stack.reshape(tall_sh, pw, 3)
        rgb = div(tall.astype(jnp.float32), maxval)
        y, cb, cr = rgb_to_ycbcr(rgb)
        if entangle is not None:
            luma_blocks = entangled_blockize_p420(y)
        else:
            luma_blocks = blockize(y)
        cb_blocks = blockize(subsample(cb, preset))
        cr_blocks = blockize(subsample(cr, preset))

        luma_zz = quantize_zigzag(dct2d(luma_blocks, variant), luma_q)
        cb_zz = quantize_zigzag(dct2d(cb_blocks, variant), chroma_q)
        cr_zz = quantize_zigzag(dct2d(cr_blocks, variant), chroma_q)

        luma_zz = _dc_handoff_slab(luma_zz, num_shards, n_images)
        cb_zz = _dc_handoff_slab(cb_zz, num_shards, n_images)
        cr_zz = _dc_handoff_slab(cr_zz, num_shards, n_images)

        n_luma_valid = valid_rows * luma_blocks_per_mcu_row
        n_chroma_valid = valid_rows * chroma_blocks_per_mcu_row
        luma_mask = jnp.arange(nl_si) < n_luma_valid
        chroma_mask = jnp.arange(nc_si) < n_chroma_valid
        hists = []
        for i in range(n_images):
            lz = luma_zz[i * nl_si : (i + 1) * nl_si]
            cbz = cb_zz[i * nc_si : (i + 1) * nc_si]
            crz = cr_zz[i * nc_si : (i + 1) * nc_si]
            l_dc, l_ac = symbol_histograms(lz, luma_mask)
            c_dc, c_ac = symbol_histograms(
                jnp.concatenate([cbz, crz], axis=0),
                jnp.concatenate([chroma_mask, chroma_mask], axis=0),
            )
            hists.append((l_dc, l_ac, c_dc, c_ac))
        # ONE psum for all images' histograms (4 * n_images small arrays)
        hists = jax.lax.psum(tuple(hists), AXIS)
        return (luma_zz, cb_zz, cr_zz), hists, valid_rows

    geom = (ph, pw, rows_per_shard, valid_mcu_rows)
    return phase1, geom


def _make_phase1(
    height: int,
    width: int,
    preset: ChromaSubsamplingPreset,
    variant: DCTVariant,
    num_shards: int,
):
    """Shared per-shard phase-1 body: slab pixels -> globally-DPCM'd zigzag
    blocks + psum'd global histograms + this shard's valid-row count.

    Used by both the two-dispatch program (_compiled_sharded) and the
    fused one-dispatch program (_compiled_sharded_onedispatch)."""
    ph, pw, rows_per_shard, valid_mcu_rows = _shard_geometry(
        height, width, preset, num_shards
    )
    shard_h = rows_per_shard * preset.mcu_height
    entangle = entangle_permutation(pw // 8, shard_h // 8, preset)
    # Per-shard block geometry (all static).
    luma_blocks_per_mcu_row = (pw // 8) * preset.vertical_rate
    chroma_w = pw // preset.horizontal_rate
    chroma_blocks_per_mcu_row = chroma_w // 8

    def phase1(rgb_u16, maxval, luma_q, chroma_q):
        s = jax.lax.axis_index(AXIS)
        valid_rows = jnp.clip(
            valid_mcu_rows - s * rows_per_shard, 0, rows_per_shard
        )

        rgb = div(rgb_u16.astype(jnp.float32), maxval)
        y, cb, cr = rgb_to_ycbcr(rgb)
        if entangle is not None:
            luma_blocks = entangled_blockize_p420(y)
        else:
            luma_blocks = blockize(y)
        cb_blocks = blockize(subsample(cb, preset))
        cr_blocks = blockize(subsample(cr, preset))

        luma_zz = quantize_zigzag(dct2d(luma_blocks, variant), luma_q)
        cb_zz = quantize_zigzag(dct2d(cb_blocks, variant), chroma_q)
        cr_zz = quantize_zigzag(dct2d(cr_blocks, variant), chroma_q)

        luma_zz = _dc_handoff(luma_zz, num_shards)
        cb_zz = _dc_handoff(cb_zz, num_shards)
        cr_zz = _dc_handoff(cr_zz, num_shards)

        # Alignment-padding MCU rows (beyond the true padded image) are
        # masked out of the histograms and dropped on host.
        n_luma_valid = valid_rows * luma_blocks_per_mcu_row
        n_chroma_valid = valid_rows * chroma_blocks_per_mcu_row
        luma_mask = jnp.arange(luma_zz.shape[0]) < n_luma_valid
        chroma_mask = jnp.arange(cb_zz.shape[0]) < n_chroma_valid
        l_dc, l_ac = symbol_histograms(luma_zz, luma_mask)
        # chroma histograms are consumed summed: one pass on concat
        c_dc, c_ac = symbol_histograms(
            jnp.concatenate([cb_zz, cr_zz], axis=0),
            jnp.concatenate([chroma_mask, chroma_mask], axis=0),
        )
        hists = jax.lax.psum((l_dc, l_ac, c_dc, c_ac), AXIS)
        locals_ = (l_dc, l_ac, c_dc, c_ac)
        return (luma_zz, cb_zz, cr_zz), hists, locals_, valid_rows

    geom = (ph, pw, rows_per_shard, valid_mcu_rows)
    return phase1, geom


@mode_keyed_cache(maxsize=16)
def _compiled_sharded(
    height: int,
    width: int,
    preset: ChromaSubsamplingPreset,
    variant: DCTVariant,
    num_shards: int,
):
    phase1, geom = _make_phase1(height, width, preset, variant, num_shards)
    mesh = build_mesh(num_shards)

    def per_shard(rgb_u16, maxval, luma_q, chroma_q):
        (luma_zz, cb_zz, cr_zz), hists, locals_, _ = phase1(
            rgb_u16, maxval, luma_q, chroma_q
        )
        l_dc, l_ac, c_dc, c_ac = locals_
        # Per-shard histograms too ([1, ...] per shard, stacked by the out
        # spec): the host derives each shard's exact scan-bit count from
        # them for the segment merge.
        per_shard = (l_dc[None], l_ac[None], c_dc[None], c_ac[None])
        return (luma_zz, cb_zz, cr_zz) + hists + per_shard

    sharded = shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(P(AXIS, None, None), P(), P(None), P(None)),
        out_specs=(
            P(AXIS, None),
            P(AXIS, None),
            P(AXIS, None),
            P(),
            P(),
            P(),
            P(),
            P(AXIS, None),
            P(AXIS, None),
            P(AXIS, None),
            P(AXIS, None),
        ),
    )
    return jax.jit(sharded), mesh, geom


@mode_keyed_cache(maxsize=16)
def _compiled_sharded_onedispatch(
    height: int,
    width: int,
    preset: ChromaSubsamplingPreset,
    variant: DCTVariant,
    num_shards: int,
    gather: bool = False,
):
    """The WHOLE sharded encode as ONE jit program.

    Every shard: phase-1 on its slab -> psum'd global histograms ->
    device package-merge + canonical codes (identical in every shard, the
    reference's whole-image tables: transformer.rs:201-207) -> scan pack
    of its own segment. Outputs per-shard word streams + bit counts plus
    the replicated table spec; the host only bit-merges. The two-dispatch
    path's mid-image sync (fetch histograms, build tables on host,
    dispatch the packer) disappears."""
    from ..bitstream.device_pack import scan_words_capacity
    from ..huffman.device_tables import (
        device_code_tables_batched,
        pad_dc_histogram,
    )
    from ..onedispatch import _tables_to_pack

    phase1, geom = _make_phase1(height, width, preset, variant, num_shards)
    ph, pw, rows_per_shard, valid_mcu_rows = geom
    mesh = build_mesh(num_shards)

    shard_h = rows_per_shard * preset.mcu_height
    nl_s = (shard_h // 8) * (pw // 8)
    nc_s = (shard_h // preset.vertical_rate // 8) * (
        pw // preset.horizontal_rate // 8
    )
    lpm = preset.luma_blocks_per_mcu
    stride = lpm + 2
    ns = nl_s + 2 * nc_s
    mcus_per_row = pw // preset.mcu_width
    words_cap = scan_words_capacity(ns)  # worst case: static

    def per_shard(rgb_u16, maxval, luma_q, chroma_q):
        (luma_zz, cb_zz, cr_zz), hists, _, valid_rows = phase1(
            rgb_u16, maxval, luma_q, chroma_q
        )
        l_dc, l_ac, c_dc, c_ac = hists  # psum'd: identical in every shard

        t_all = device_code_tables_batched(
            jnp.stack(
                [
                    pad_dc_histogram(l_dc),
                    l_ac.astype(jnp.int32),
                    pad_dc_histogram(c_dc),
                    c_ac.astype(jnp.int32),
                ]
            )
        )
        t4 = tuple({k: v[i] for k, v in t_all.items()} for i in range(4))
        # Alignment-padding MCUs (a suffix in scan order) emit nothing.
        valid_blocks = valid_rows * mcus_per_row * stride
        bmask = jnp.arange(ns, dtype=jnp.int32) < valid_blocks
        words, shard_bits, spec_syms, spec_lens, spec_ns = _tables_to_pack(
            t4, luma_zz, cb_zz, cr_zz, nc_s, lpm, stride, words_cap,
            valid=bmask,
        )
        if gather:
            # Multi-process: replicate the per-shard streams so process 0
            # can assemble the JPEG without touching other processes'
            # device memory. The gathered bytes are the COMPRESSED
            # segments, not coefficients, so the network cost is small.
            words_out = jax.lax.all_gather(words, AXIS)
            bits_out = jax.lax.all_gather(shard_bits, AXIS)
        else:
            words_out = words[None]
            bits_out = shard_bits[None]
        return (
            words_out, bits_out,
            spec_syms, spec_lens, spec_ns,
        ) + hists

    sharded = shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(P(AXIS, None, None), P(), P(None), P(None)),
        out_specs=(
            P() if gather else P(AXIS, None),  # packed words
            P() if gather else P(AXIS),        # bit counts
            P(), P(), P(),  # replicated table spec
            P(), P(), P(), P(),  # global histograms (debug cross-check)
        ),
        # all_gather's result is the same on every shard, but shard_map
        # cannot infer that replication for the P() out_specs
        check_vma=not gather,
    )
    return jax.jit(sharded), mesh, geom


@mode_keyed_cache(maxsize=8)
def _compiled_sharded_onedispatch_slab(
    n_images: int,
    height: int,
    width: int,
    preset: ChromaSubsamplingPreset,
    variant: DCTVariant,
    num_shards: int,
):
    """SHARDED SLAB: n_images same-geometry encodes, each image's MCU rows
    split over the mesh AND the images row-stacked per shard into ONE
    program — the per-shard fixed work (table-build sorts, dispatch) is
    paid once per n_images images. Per-shard: one tall phase 1, ONE
    batched sort stream for all 4*n_images Huffman tables, n_images scan
    packs. Output bytes equal per-image single-device encodes, bit for
    bit (alignment rows masked; DC chains seeded per image across
    shards)."""
    from ..bitstream.device_pack import scan_words_capacity
    from ..huffman.device_tables import (
        device_code_tables_batched,
        pad_dc_histogram,
    )
    from ..onedispatch import _tables_to_pack

    phase1, geom = _make_phase1_slab(
        n_images, height, width, preset, variant, num_shards
    )
    ph, pw, rows_per_shard, valid_mcu_rows = geom
    mesh = build_mesh(num_shards)

    shard_h = rows_per_shard * preset.mcu_height
    nl_s = (shard_h // 8) * (pw // 8)
    nc_s = (shard_h // preset.vertical_rate // 8) * (
        pw // preset.horizontal_rate // 8
    )
    lpm = preset.luma_blocks_per_mcu
    stride = lpm + 2
    ns = nl_s + 2 * nc_s
    mcus_per_row = pw // preset.mcu_width
    words_cap = scan_words_capacity(ns)  # per image, worst case

    def per_shard(rgb_stack, maxval, luma_q, chroma_q):
        (luma_zz, cb_zz, cr_zz), hists, valid_rows = phase1(
            rgb_stack, maxval, luma_q, chroma_q
        )
        stack = []
        for l_dc, l_ac, c_dc, c_ac in hists:
            stack += [
                pad_dc_histogram(l_dc),
                l_ac.astype(jnp.int32),
                pad_dc_histogram(c_dc),
                c_ac.astype(jnp.int32),
            ]
        t_all = device_code_tables_batched(jnp.stack(stack))
        t4 = tuple(
            {
                k: v.reshape((n_images, 4) + v.shape[1:])[:, j]
                for k, v in t_all.items()
            }
            for j in range(4)
        )
        valid_blocks = valid_rows * mcus_per_row * stride
        bmask = jnp.arange(ns, dtype=jnp.int32) < valid_blocks
        # per-image scan packs, vmapped over the image axis
        words, bits, syms, lens, ns_ = jax.vmap(
            lambda t, l, c, r: _tables_to_pack(
                t, l, c, r, nc_s, lpm, stride, words_cap, valid=bmask
            )
        )(
            t4,
            luma_zz.reshape(n_images, nl_s, 64),
            cb_zz.reshape(n_images, nc_s, 64),
            cr_zz.reshape(n_images, nc_s, 64),
        )
        flat_hists = tuple(h for quad in hists for h in quad)
        return (
            words[None],   # [1, B, cap] -> [n, B, cap]
            bits[None],    # [1, B]      -> [n, B]
            syms,          # [B, 4, 256] replicated
            lens,
            ns_,           # [B, 4]
        ) + flat_hists

    sharded = shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(P(None, AXIS, None, None), P(), P(None), P(None)),
        out_specs=(
            P(AXIS, None, None),   # per-shard per-image packed words
            P(AXIS, None),         # per-shard per-image bit counts
            P(), P(), P(),         # replicated per-image table specs
        ) + (P(),) * (4 * n_images),  # psum'd per-image histograms
    )
    return jax.jit(sharded), mesh, geom


def start_sharded_encode_slab(
    pixels_stack,
    maxval: int,
    config: EncoderConfig,
) -> tuple:
    """Dispatch n_images same-geometry images as ONE sharded slab program
    (asynchronous). pixels_stack: [B, H, W, 3], host or device. Finish
    with finish_sharded_encode_slab -> list of (scan bytes, tables),
    byte-identical to per-image single-chip encodes."""
    from ..onedispatch import _total_blocks as _total_blocks_of
    from ..onedispatch import slab_max_blocks
    from ..tables import quantization_table_pair as qtp

    b = int(pixels_stack.shape[0])
    height, width = int(pixels_stack.shape[1]), int(pixels_stack.shape[2])
    preset = config.chroma_subsampling
    n = config.num_shards
    # The compile-size cap applies to the PER-SHARD program (the jit body
    # sees 1/n of each image's blocks, times b images).
    per_shard_blocks = b * _total_blocks_of(height, width, preset) // n
    limit = slab_max_blocks()
    if per_shard_blocks > limit:
        raise ValueError(
            f"start_sharded_encode_slab: {per_shard_blocks} blocks/shard "
            f"exceeds the {limit}-block single-program compile limit; "
            f"split the group (or raise DMMT_SLAB_MAX_BLOCKS)"
        )
    luma_q, chroma_q = qtp(config.quantization_preset, config.quality)
    fn, mesh, geom = _compiled_sharded_onedispatch_slab(
        b, height, width, preset, config.dct_variant, n
    )
    ph, pw = geom[0], geom[1]
    if (ph, pw) == (height, width):
        # already MCU-aligned: pass through (host OR device array) —
        # forcing np.asarray on a device stack would pay a device->host
        # fetch plus a re-upload for nothing
        arr = pixels_stack
    elif isinstance(pixels_stack, np.ndarray):
        padded = np.zeros((b, ph, pw, 3), dtype=pixels_stack.dtype)
        padded[:, :height, :width] = pixels_stack
        arr = padded
    else:
        # device-resident stack needing padding: pad on device (black)
        arr = jnp.pad(
            pixels_stack,
            ((0, 0), (0, ph - height), (0, pw - width), (0, 0)),
        )
    outputs = fn(
        jnp.asarray(arr),
        jnp.float32(maxval),
        jnp.asarray(luma_q),
        jnp.asarray(chroma_q),
    )
    return ("slab", outputs, geom, (height, width), b)


def finish_sharded_encode_slab(
    state: tuple, config: EncoderConfig
) -> list[tuple[bytes, "object"]]:
    """Synchronize a start_sharded_encode_slab dispatch: fetch per-shard
    per-image bit counts + table specs + word streams, then bit-merge each
    image's shard segments. Returns [(stuffed scan bytes, HuffmanTables)]
    per image."""
    from ..bitstream.device_pack import _check_bits_enabled, exact_scan_bits
    from ..huffman.canonical import flat_code_arrays
    from ..onedispatch import tables_from_spec

    _, outputs, geom, (height, width), b = state
    n = config.num_shards
    words_d, bits_d, syms_d, lens_d, ns_d = outputs[:5]
    bits, syms, lens, ns_arr = jax.device_get(
        (bits_d, syms_d, lens_d, ns_d)
    )  # bits [n, B]
    needed = (bits.astype(np.int64) + 31) // 32  # [n, B]
    max_needed = int(needed.max()) if needed.size else 0
    host_words = jax.device_get(words_d[:, :, :max_needed])  # [n, B, w]
    results = []
    for i in range(b):
        tables = tables_from_spec(syms[i], lens[i], ns_arr[i])
        if _check_bits_enabled():
            ghists = jax.device_get(outputs[5 + 4 * i : 5 + 4 * (i + 1)])
            predicted = exact_scan_bits(
                ghists,
                flat_code_arrays(tables.luma_dc),
                flat_code_arrays(tables.luma_ac),
                flat_code_arrays(tables.chroma_dc),
                flat_code_arrays(tables.chroma_ac),
            )
            if predicted != int(bits[:, i].sum()):
                raise AssertionError(
                    f"sharded slab image {i} packed {int(bits[:, i].sum())} "
                    f"bits but histograms x device tables predict {predicted}"
                )
        chunks = [
            (
                host_words[s, i, : needed[s, i]].view(np.uint8),
                int(bits[s, i]),
            )
            for s in range(n)
        ]
        results.append((_merge_and_stuff(chunks), tables))
    return results


def _use_sharded_onedispatch(config: EncoderConfig, height: int, width: int) -> bool:
    from ..onedispatch import use_one_dispatch

    return use_one_dispatch(config, height, width)


def _run_sharded_raw(
    pixels: np.ndarray,
    maxval: int,
    config: EncoderConfig,
    luma_q: np.ndarray,
    chroma_q: np.ndarray,
):
    """Dispatch the sharded phase-1 program; returns the raw device outputs
    plus the shard geometry (blocks stay device-resident)."""
    preset = config.chroma_subsampling
    n = config.num_shards
    height, width = int(pixels.shape[0]), int(pixels.shape[1])

    fn, mesh, geom = _compiled_sharded(
        height, width, preset, config.dct_variant, n
    )
    ph, pw, rows_per_shard, valid_mcu_rows = geom

    padded = np.zeros((ph, pw, 3), dtype=pixels.dtype)
    padded[:height, :width] = pixels
    outputs = fn(
        jnp.asarray(padded),
        jnp.float32(maxval),
        jnp.asarray(luma_q),
        jnp.asarray(chroma_q),
    )
    return outputs, geom


def run_sharded_pipeline(
    pixels: np.ndarray,
    maxval: int,
    config: EncoderConfig,
    luma_q: np.ndarray | None = None,
    chroma_q: np.ndarray | None = None,
) -> DeviceEncodeResult:
    """Execute the multi-chip pipeline; returns host arrays with alignment
    padding removed, byte-for-byte equivalent to the single-chip result."""
    if luma_q is None or chroma_q is None:
        luma_q, chroma_q = quantization_table_pair(config.quantization_preset, config.quality)
    preset = config.chroma_subsampling
    n = config.num_shards
    outputs, (ph, pw, rows_per_shard, valid_mcu_rows) = _run_sharded_raw(
        pixels, maxval, config, luma_q, chroma_q
    )
    luma, cb, cr, ldc, lac, cdc, cac = jax.device_get(outputs[:7])

    luma = _drop_alignment_blocks(
        luma, n, rows_per_shard, valid_mcu_rows,
        (pw // 8) * preset.vertical_rate,
    )
    chroma_per_row = (pw // preset.horizontal_rate) // 8
    cb = _drop_alignment_blocks(cb, n, rows_per_shard, valid_mcu_rows, chroma_per_row)
    cr = _drop_alignment_blocks(cr, n, rows_per_shard, valid_mcu_rows, chroma_per_row)

    return DeviceEncodeResult(
        luma=luma,
        cb=cb,
        cr=cr,
        luma_dc_hist=ldc,
        luma_ac_hist=lac,
        chroma_dc_hist=cdc,
        chroma_ac_hist=cac,
    )


def _drop_alignment_blocks(
    blocks: np.ndarray,
    num_shards: int,
    rows_per_shard: int,
    valid_mcu_rows: int,
    blocks_per_mcu_row: int,
) -> np.ndarray:
    """Keep each shard's valid prefix (alignment padding is whole trailing
    MCU rows, so validity is a prefix in entangled order)."""
    per_shard = blocks.shape[0] // num_shards
    keep = []
    for s in range(num_shards):
        valid_rows = min(max(valid_mcu_rows - s * rows_per_shard, 0), rows_per_shard)
        keep.append(
            blocks[s * per_shard : s * per_shard + valid_rows * blocks_per_mcu_row]
        )
    return np.concatenate(keep, axis=0)


# --- Per-shard on-device scan packing ----------------------------------------
#
# Instead of gathering 25 MB of coefficients to host 0, each shard packs its
# own (already globally-DPCM'd) blocks into a finished bit segment with the
# GLOBAL Huffman tables; the host receives ~per-shard-scan-size bytes and
# performs only a bit-aligned concatenation (SURVEY.md §7.7: "concatenate
# per-shard entropy segments"). Segment boundaries are whole MCUs, so the
# concatenation IS the single-chip scan, bit for bit.


def merge_bit_streams(chunks: list) -> tuple[np.ndarray, int]:
    """Bit-aligned concatenation of (uint8 stream, bit_length) chunks.

    Streams are MSB-first; bits beyond bit_length must be zero (the device
    packers guarantee it). Vectorized per chunk: each byte contributes its
    top bits to out[i] and its low bits to out[i+1]."""
    total_bits = int(sum(b for _, b in chunks))
    out = np.zeros((total_bits + 7) // 8 + 1, np.uint8)
    pos = 0
    for data, bits in chunks:
        bits = int(bits)
        if bits == 0:
            continue
        nb = (bits + 7) // 8
        data = np.asarray(data, dtype=np.uint8)[:nb]
        k = pos & 7
        byte0 = pos >> 3
        if k == 0:
            out[byte0 : byte0 + nb] |= data
        else:
            out[byte0 : byte0 + nb] |= data >> k
            out[byte0 + 1 : byte0 + 1 + nb] |= (
                (data.astype(np.uint16) << (8 - k)) & 0xFF
            ).astype(np.uint8)
        pos += bits
    return out[: (total_bits + 7) // 8], total_bits


@mode_keyed_cache(maxsize=16)
def _compiled_shard_pack(
    num_shards: int,
    nl_s: int,
    nc_s: int,
    luma_per_mcu: int,
    words_cap: int,
    rows_per_shard: int,
    valid_mcu_rows: int,
    mcus_per_row: int,
):
    from ..bitstream.device_pack import _interleave_scan, pack_scan_words

    mesh = build_mesh(num_shards)
    ns = nl_s + 2 * nc_s
    blocks_per_mcu = luma_per_mcu + 2

    def per_shard(luma, cb, cr, dc_comb, ac_comb):
        s = jax.lax.axis_index(AXIS)
        valid_rows = jnp.clip(
            valid_mcu_rows - s * rows_per_shard, 0, rows_per_shard
        )
        valid_blocks = valid_rows * mcus_per_row * blocks_per_mcu

        scan = _interleave_scan(luma, cb, cr, nc_s, luma_per_mcu)
        # Alignment-padding MCUs (a suffix in scan order) emit nothing.
        bmask = jnp.arange(ns, dtype=jnp.int32) < valid_blocks
        words, _ = pack_scan_words(
            scan, blocks_per_mcu, luma_per_mcu, dc_comb, ac_comb, words_cap,
            valid=bmask,
        )
        return words[None]

    sharded = shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(P(AXIS, None), P(AXIS, None), P(AXIS, None), P(None), P(None)),
        out_specs=P(AXIS, None),
    )
    return jax.jit(sharded)


def start_sharded_encode(
    pixels: np.ndarray,
    maxval: int,
    config: EncoderConfig,
) -> tuple:
    """Dispatch the sharded encode WITHOUT synchronizing.

    Within the device table build's exactness bound this dispatches the
    ONE-program variant (_compiled_sharded_onedispatch): phase-1, psum'd
    histograms, device table build, and per-shard packing in a single
    jit — no mid-image sync. Otherwise (or with one_dispatch="off") the
    two-dispatch path runs (phase-1 now; table build + packer dispatch in
    finish).

    JAX dispatch is asynchronous, so the caller can start image i+1's
    device work (or finish image i's host tail) before this image's
    results are fetched — the batch pipeline composes sharding with
    batching this way. Returns an opaque state for finish_sharded_encode."""
    luma_q, chroma_q = quantization_table_pair(
        config.quantization_preset, config.quality
    )
    height, width = int(pixels.shape[0]), int(pixels.shape[1])
    if _use_sharded_onedispatch(config, height, width):
        fn, mesh, geom = _compiled_sharded_onedispatch(
            height, width, config.chroma_subsampling, config.dct_variant,
            config.num_shards,
        )
        ph, pw = geom[0], geom[1]
        padded = np.zeros((ph, pw, 3), dtype=pixels.dtype)
        padded[:height, :width] = pixels
        outputs = fn(
            jnp.asarray(padded),
            jnp.float32(maxval),
            jnp.asarray(luma_q),
            jnp.asarray(chroma_q),
        )
        return ("onedispatch", outputs, geom, (height, width))
    outputs, geom = _run_sharded_raw(pixels, maxval, config, luma_q, chroma_q)
    return ("twodispatch", outputs, geom)


# Previous max per-shard stream size by geometry: lets the one-dispatch
# finish fetch the word slices TOGETHER with bits + table spec in one
# device round trip (sized ~20% above the last encode), instead of a
# second round trip after learning the bit counts.
_LAST_SHARD_BITS: dict[tuple, int] = {}


def _merge_and_stuff(chunks: list) -> bytes:
    """Shared scan tail: bit-merge the per-shard streams, 1-pad the final
    byte (reference: encoder.rs:267), byte-stuff 0xFFs
    (segment_marker_injector.rs:14-30)."""
    merged, total_bits = merge_bit_streams(chunks)
    pad = len(merged) * 8 - total_bits
    if pad:
        merged[-1] |= (1 << pad) - 1
    ff = np.flatnonzero(merged == 0xFF)
    if len(ff):
        merged = np.insert(merged, ff + 1, 0)
    return merged.tobytes()


def _finish_sharded_onedispatch(
    state: tuple, config: EncoderConfig
) -> tuple[bytes, "object"]:
    from ..bitstream.device_pack import _check_bits_enabled, exact_scan_bits
    from ..huffman.canonical import flat_code_arrays
    from ..onedispatch import tables_from_spec

    _, outputs, geom, (height, width) = state
    n = config.num_shards
    words_d, bits_d, syms_d, lens_d, ns_d = outputs[:5]
    key = (height, width, config.chroma_subsampling, config.quality,
           config.quantization_preset, n)
    guess = _LAST_SHARD_BITS.get(key)
    wslice = None
    if guess is not None:
        gw = min(int(words_d.shape[1]), ((guess + guess // 5) + 31) // 32 + 8)
        bits, syms, lens, ns_arr, wslice = jax.device_get(
            (bits_d, syms_d, lens_d, ns_d, words_d[:, :gw])
        )
    else:
        bits, syms, lens, ns_arr = jax.device_get(
            (bits_d, syms_d, lens_d, ns_d)
        )
    tables = tables_from_spec(syms, lens, ns_arr)
    if _check_bits_enabled():
        ghists = jax.device_get(outputs[5:9])
        predicted = exact_scan_bits(
            ghists,
            flat_code_arrays(tables.luma_dc),
            flat_code_arrays(tables.luma_ac),
            flat_code_arrays(tables.chroma_dc),
            flat_code_arrays(tables.chroma_ac),
        )
        if predicted != int(bits.sum()):
            raise AssertionError(
                f"sharded one-dispatch packed {int(bits.sum())} bits but "
                f"histograms x device tables predict {predicted}"
            )
    _LAST_SHARD_BITS[key] = int(bits.max())
    needed = [(int(b) + 31) // 32 for b in bits]
    max_needed = max(needed) if needed else 0
    if wslice is None:
        host_words = jax.device_get(words_d[:, :max_needed])
    elif max_needed > wslice.shape[1]:
        # Speculation came up short: fetch only the missing tail, never
        # refetch from offset 0.
        tail = jax.device_get(words_d[:, wslice.shape[1] : max_needed])
        host_words = np.concatenate([wslice, tail], axis=1)
    else:
        host_words = wslice
    chunks = [
        (host_words[i, : needed[i]].view(np.uint8), int(bits[i]))
        for i in range(n)
    ]
    return _merge_and_stuff(chunks), tables


def finish_sharded_encode(
    state: tuple,
    config: EncoderConfig,
) -> tuple[bytes, "object"]:
    """Synchronize a start_sharded_encode dispatch.

    One-dispatch states need only the fetch + host bit-merge; two-dispatch
    states build global tables from the psum'd histograms on host, then
    dispatch the per-shard packer. Returns (stuffed scan bytes,
    HuffmanTables)."""
    if state[0] == "onedispatch":
        return _finish_sharded_onedispatch(state, config)
    state = state[1:]
    from ..bitstream.device_pack import combine_tables, exact_scan_bits
    from ..encoder import HuffmanTables
    from ..huffman.canonical import flat_code_arrays
    from ..pipeline import DeviceEncodeResult

    preset = config.chroma_subsampling
    n = config.num_shards
    outputs, (ph, pw, rows_per_shard, valid_mcu_rows) = state

    # Global tables from the psum'd histograms + per-shard exact bit counts.
    g_ldc, g_lac, g_cdc, g_cac, s_ldc, s_lac, s_cdc, s_cac = jax.device_get(
        outputs[3:11]
    )
    result = DeviceEncodeResult(
        luma=None, cb=None, cr=None,
        luma_dc_hist=g_ldc, luma_ac_hist=g_lac,
        chroma_dc_hist=g_cdc, chroma_ac_hist=g_cac,
    )
    tables = HuffmanTables.from_histograms(result)
    ldc = flat_code_arrays(tables.luma_dc)
    lac = flat_code_arrays(tables.luma_ac)
    cdc = flat_code_arrays(tables.chroma_dc)
    cac = flat_code_arrays(tables.chroma_ac)
    bits = [
        exact_scan_bits(
            (s_ldc[i], s_lac[i], s_cdc[i], s_cac[i]), ldc, lac, cdc, cac
        )
        for i in range(n)
    ]

    needed = max((b + 31) // 32 + 2 for b in bits)
    words_cap = 1 << max(12, int(needed).bit_length())

    nl_s = int(outputs[0].shape[0]) // n
    nc_s = int(outputs[1].shape[0]) // n
    mcus_per_row = pw // preset.mcu_width
    fn = _compiled_shard_pack(
        n, nl_s, nc_s, preset.luma_blocks_per_mcu, words_cap,
        rows_per_shard, valid_mcu_rows, mcus_per_row,
    )
    dc_comb = np.concatenate(
        [
            combine_tables(np.asarray(ldc[0])[:16], np.asarray(ldc[1])[:16]),
            combine_tables(np.asarray(cdc[0])[:16], np.asarray(cdc[1])[:16]),
        ]
    )
    ac_comb = np.concatenate(
        [
            combine_tables(np.asarray(lac[0]), np.asarray(lac[1])),
            combine_tables(np.asarray(cac[0]), np.asarray(cac[1])),
        ]
    )
    words = fn(
        outputs[0], outputs[1], outputs[2],
        jnp.asarray(dc_comb), jnp.asarray(ac_comb),
    )
    max_words = max((b + 31) // 32 for b in bits) if bits else 0
    host_words = jax.device_get(words[:, :max_words])

    chunks = [(host_words[i].view(np.uint8), bits[i]) for i in range(n)]
    return _merge_and_stuff(chunks), tables


def encode_sharded_scan(
    pixels: np.ndarray,
    maxval: int,
    config: EncoderConfig,
) -> tuple[bytes, "object"]:
    """Full sharded encode of the entropy scan: phase-1 shard_map, global
    tables from psum'd histograms, per-shard device packing, host bit-merge.

    Returns (stuffed scan bytes, HuffmanTables)."""
    return finish_sharded_encode(
        start_sharded_encode(pixels, maxval, config), config
    )

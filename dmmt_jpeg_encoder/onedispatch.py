"""One-dispatch encode: pixels -> packed scan words in a SINGLE jit program.

The two-dispatch path synchronizes mid-image (fetch histograms, build
Huffman tables on host, upload them, dispatch the packer — two device
round trips on the critical path, plus a content-dependent recompile
whenever the stream-size bucket changes). Here the whole encode chain

    normalize -> color -> blockize -> DCT x quant x zigzag -> DPCM ->
    histograms -> PACKAGE-MERGE + CANONICAL CODES (huffman/device_tables)
    -> scan pack (bitstream/device_pack.pack_scan_words)

is ONE compiled program. The host afterwards makes exactly two fetches:
a small one (total_bits + the DHT table spec, ~2 KB) and the finished
word stream slice. The output buffer is sized for the worst case
(64 words/block), so the executable depends only on image geometry —
no more per-quality/content bucket recompiles.

Replaces the reference's transform->encode sequencing
(reference: src/image/writer/jpeg/transformer.rs:188-221 +
src/image/writer/jpeg/encoder.rs:110-135) with a fully fused device form.

Scale guard: the device table build is exact for per-table symbol totals
below 2^28 (huffman/device_tables.py); callers route larger images
through the two-dispatch host-table path.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from .config import ChromaSubsamplingPreset, DCTVariant, EncoderConfig
from .ops.fp import div
from .huffman.spec import SymbolCodeLength
from .utils.capability import mode_keyed_cache

# Worst-case symbol-total bound for exact device table tie-breaking.
MAX_DEVICE_TABLE_SYMBOLS = 1 << 28

# Compile-size bound for one slab program (luma + chroma blocks over all
# stacked images). It bounds program size and device memory for the
# worst-case scan buffers; it is not a measured speed optimum.
SLAB_MAX_BLOCKS = 1_700_000


def slab_max_blocks() -> int:
    return int(os.environ.get("DMMT_SLAB_MAX_BLOCKS", SLAB_MAX_BLOCKS))


@dataclass
class OneDispatchState:
    """Async dispatch handle: everything still device-resident."""

    words: jnp.ndarray        # u32 [n_words], byteswapped (memory order)
    total_bits: jnp.ndarray   # i32 scalar
    spec_syms: jnp.ndarray    # i32 [4, 256] leaf-order symbols per table
    spec_lens: jnp.ndarray    # i32 [4, 256] leaf-order code lengths
    spec_ns: jnp.ndarray      # i32 [4] present counts
    hists: tuple              # 4 histograms (debug cross-check only)
    height: int
    width: int
    spec_slice: jnp.ndarray | None = None  # prefetched speculative word slice


def one_dispatch_supported(height: int, width: int,
                           preset: ChromaSubsamplingPreset) -> bool:
    """True when the device table build's exactness bound holds."""
    from .ops.geometry import padded_size

    ph, pw = padded_size(height, width, preset)
    luma_blocks = (ph // 8) * (pw // 8)
    # every luma coefficient could emit a symbol; the AC luma table sees
    # at most 64 * blocks symbols
    return luma_blocks * 64 < MAX_DEVICE_TABLE_SYMBOLS


def use_one_dispatch(config: EncoderConfig, height: int, width: int) -> bool:
    """One-dispatch encode (device-built Huffman tables + scan pack in a
    single jit program) unless config.one_dispatch == "off" or the image
    exceeds the device table build's exactness bound; otherwise callers
    take the two-dispatch host-table path."""
    return config.one_dispatch != "off" and one_dispatch_supported(
        height, width, config.chroma_subsampling
    )


def _total_blocks(
    height: int, width: int, preset: ChromaSubsamplingPreset
) -> int:
    """Luma + chroma 8x8 block count of one padded image."""
    from .ops.geometry import padded_size

    ph, pw = padded_size(height, width, preset)
    n_luma = (ph // 8) * (pw // 8)
    n_chroma = (ph // preset.vertical_rate // 8) * (
        pw // preset.horizontal_rate // 8
    )
    return n_luma + 2 * n_chroma


def _build_onedispatch_program(
    height: int,
    width: int,
    preset: ChromaSubsamplingPreset,
    variant: DCTVariant,
    planar: bool = False,
):
    from .bitstream.device_pack import scan_words_capacity
    from .entropy.categorize import symbol_histograms
    from .huffman.device_tables import (
        device_code_tables_batched,
        pad_dc_histogram,
    )
    from .ops.color import rgb_to_ycbcr, rgb_to_ycbcr_planes
    from .ops.geometry import (
        entangle_permutation,
        pad_to_mcu_multiple,
        padded_size,
    )
    from .pipeline import encode_blocks_from_planes

    ph, pw = padded_size(height, width, preset)
    entangle = entangle_permutation(pw // 8, ph // 8, preset)
    n_luma = (ph // 8) * (pw // 8)
    n_chroma = (ph // preset.vertical_rate // 8) * (
        pw // preset.horizontal_rate // 8
    )
    lpm = preset.luma_blocks_per_mcu
    stride = lpm + 2
    n_words = scan_words_capacity(n_luma + 2 * n_chroma)  # worst case: static

    def program(rgb_u16, maxval, luma_q, chroma_q):
        if planar:
            # [3, H, W] channel-planar input. Pad the integer planes first
            # (black = 0 matches the reference's padder, and 0/maxval ==
            # 0.0 so padding before normalization is exact).
            if (ph, pw) != (height, width):
                rgb_u16 = jnp.pad(
                    rgb_u16,
                    ((0, 0), (0, ph - height), (0, pw - width)),
                )
            r = div(rgb_u16[0].astype(jnp.float32), maxval)
            g = div(rgb_u16[1].astype(jnp.float32), maxval)
            b = div(rgb_u16[2].astype(jnp.float32), maxval)
            y, cb, cr = rgb_to_ycbcr_planes(r, g, b)
        else:
            rgb = div(rgb_u16.astype(jnp.float32), maxval)
            rgb = pad_to_mcu_multiple(rgb, preset)
            y, cb, cr = rgb_to_ycbcr(rgb)
        luma_zz, cb_zz, cr_zz = encode_blocks_from_planes(
            y, cb, cr, luma_q, chroma_q, preset, variant, entangle
        )
        if os.environ.get("DMMT_TABLE_ABLATE"):
            # TIMING-ONLY ablation (bytes WRONG): constant histograms
            # make the whole histogram+table slice constant-fold at
            # compile time, isolating phase1+interleave+pack. The
            # constants mimic photographic symbol counts.
            l_dc, l_ac, c_dc, c_ac = _ablate_hists()
        else:
            l_dc, l_ac = symbol_histograms(luma_zz)
            # the chroma histograms are summed anyway, so ONE pass over
            # the concatenated Cb/Cr blocks is exact and halves the work
            c_dc, c_ac = symbol_histograms(
                jnp.concatenate([cb_zz, cr_zz], axis=0)
            )

        # all four tables through ONE batched sort stream (4x fewer tiny
        # sort ops than building them separately)
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
        t4 = tuple(
            {k: v[i] for k, v in t_all.items()} for i in range(4)
        )
        return _tables_to_pack(
            t4, luma_zz, cb_zz, cr_zz, n_chroma, lpm, stride, n_words,
        ) + (l_dc, l_ac, c_dc, c_ac)

    return program


def _ablate_hists():
    """Constant photographic-shaped histograms for DMMT_TABLE_ABLATE
    (timing attribution only — output bytes are WRONG)."""
    dc = np.array(
        [40, 400, 900, 700, 350, 150, 60, 20, 6, 2, 1, 0, 0, 0, 0, 0],
        np.int32,
    )
    ac = np.zeros(256, np.int32)
    for run in range(4):
        for cat in range(1, 9):
            ac[(run << 4) | cat] = max(1, 40000 >> (2 * run + cat))
    ac[0x00] = 30000  # EOB
    ac[0xF0] = 200    # ZRL
    return (
        jnp.asarray(dc), jnp.asarray(ac),
        jnp.asarray(dc), jnp.asarray(ac // 2),
    )


def _tables_to_pack(
    t4, luma_zz, cb_zz, cr_zz, n_chroma, lpm, stride, n_words, valid=None
):
    """Shared one-dispatch tail: four built code tables -> interleaved
    scan -> scan pack. Returns (words, total_bits, spec_syms, spec_lens,
    spec_ns). Used once per program by the single-image builder, once per
    IMAGE by the slab builder, and (with a validity mask over
    alignment-padding MCUs) per shard by the sharded programs."""
    from .bitstream.device_pack import (
        _interleave_scan,
        device_comb_tables,
        pack_scan_words,
    )

    dc_comb, ac_comb = device_comb_tables(*t4)
    scan = _interleave_scan(luma_zz, cb_zz, cr_zz, n_chroma, lpm)
    words, total_bits = pack_scan_words(
        scan, stride, lpm, dc_comb, ac_comb, n_words, valid=valid
    )
    spec_syms = jnp.stack([t["sym_by_leaf"] for t in t4])
    spec_lens = jnp.stack([t["len_by_leaf"] for t in t4])
    spec_ns = jnp.stack([t["n_present"] for t in t4])
    # pack_scan_words output is already in memory byte order
    return words, total_bits, spec_syms, spec_lens, spec_ns


def _build_onedispatch_slab_program(
    n_images: int,
    height: int,
    width: int,
    preset: ChromaSubsamplingPreset,
    variant: DCTVariant,
    planar: bool = False,
):
    """B same-geometry encodes as ONE program over a ROW-STACKED slab.

    The multi-image form (_compiled_onedispatch_multi) loops the whole
    single-image program B times inside one jit, which saves only the
    dispatches. The slab instead runs phase 1 ONCE on the [B*ph, pw]
    stacked image and builds all 4B Huffman tables in ONE batched sort
    stream, so the per-PROGRAM fixed work (the table build's fixed-size
    sorts, launch overheads) is paid once per GROUP, not once per image.

    Per-image independence is preserved exactly:
    - each image is pre-padded to its own MCU multiple (so the stacked
      slab's MCU rows never straddle images, and in-image padding content
      matches the standalone padder: black);
    - DC DPCM chains reset at image starts (pipeline.dc_dpcm_per_image);
    - every image gets its OWN histograms, code tables, and packed stream,
      so the output bytes equal B standalone encodes, bit for bit.
    """
    from .ops.geometry import padded_size

    ph, pw = padded_size(height, width, preset)
    n_luma = (ph // 8) * (pw // 8)
    n_chroma = (ph // preset.vertical_rate // 8) * (
        pw // preset.horizontal_rate // 8
    )
    lpm = preset.luma_blocks_per_mcu
    stride = lpm + 2
    from .bitstream.device_pack import scan_words_capacity

    n_words = scan_words_capacity(n_luma + 2 * n_chroma)  # per image
    tall_h = n_images * ph

    from .entropy.categorize import symbol_histograms
    from .huffman.device_tables import (
        device_code_tables_batched,
        pad_dc_histogram,
    )
    from .ops.color import rgb_to_ycbcr, rgb_to_ycbcr_planes
    from .ops.geometry import entangle_permutation

    entangle = entangle_permutation(pw // 8, tall_h // 8, preset)

    def program(rgb_stack, maxval, luma_q, chroma_q):
        from .pipeline import encode_blocks_from_planes

        if planar:
            # [B, 3, ph, pw] -> [3, B*ph, pw] (one u8/u16 transpose)
            tall = jnp.transpose(rgb_stack, (1, 0, 2, 3)).reshape(
                3, tall_h, pw
            )
        else:
            # [B, ph, pw, 3] -> [B*ph, pw, 3]: free (contiguous)
            tall = rgb_stack.reshape(tall_h, pw, 3)

        if planar:
            r = div(tall[0].astype(jnp.float32), maxval)
            g = div(tall[1].astype(jnp.float32), maxval)
            b = div(tall[2].astype(jnp.float32), maxval)
            y, cb, cr = rgb_to_ycbcr_planes(r, g, b)
        else:
            y, cb, cr = rgb_to_ycbcr(div(tall.astype(jnp.float32), maxval))
        luma_zz, cb_zz, cr_zz = encode_blocks_from_planes(
            y, cb, cr, luma_q, chroma_q, preset, variant, entangle,
            n_images=n_images,
        )

        # Per-image histograms (independent tables per image), ONE
        # batched build for all 4B tables, and the per-image scan packs —
        # each vmapped over the image axis, so the program's size does
        # not grow with the stack depth.
        lz = luma_zz.reshape(n_images, n_luma, 64)
        cbz = cb_zz.reshape(n_images, n_chroma, 64)
        crz = cr_zz.reshape(n_images, n_chroma, 64)
        if os.environ.get("DMMT_TABLE_ABLATE"):
            # TIMING-ONLY (bytes WRONG): constant per-image histograms
            # fold the whole per-image hist+table slice out at compile
            # time.
            l_dc, l_ac, c_dc, c_ac = (
                jnp.broadcast_to(h, (n_images,) + h.shape)
                for h in _ablate_hists()
            )
        else:
            l_dc, l_ac = jax.vmap(symbol_histograms)(lz)
            c_dc, c_ac = jax.vmap(symbol_histograms)(
                jnp.concatenate([cbz, crz], axis=1)
            )
        stack = jnp.stack(
            [
                jax.vmap(pad_dc_histogram)(l_dc),
                l_ac.astype(jnp.int32),
                jax.vmap(pad_dc_histogram)(c_dc),
                c_ac.astype(jnp.int32),
            ],
            axis=1,
        ).reshape(4 * n_images, -1)
        t_all = device_code_tables_batched(stack)
        t4 = tuple(
            {
                k: v.reshape((n_images, 4) + v.shape[1:])[:, j]
                for k, v in t_all.items()
            }
            for j in range(4)
        )
        packs = jax.vmap(
            lambda t, l, c, r: _tables_to_pack(
                t, l, c, r, n_chroma, lpm, stride, n_words
            )
        )(t4, lz, cbz, crz)
        per_image = packs + (l_dc, l_ac, c_dc, c_ac)
        # one flat output tuple per image (sliced inside the program)
        return tuple(x[i] for i in range(n_images) for x in per_image)

    return program


@mode_keyed_cache(maxsize=8)
def _compiled_onedispatch_slab(
    n_images: int,
    height: int,
    width: int,
    preset: ChromaSubsamplingPreset,
    variant: DCTVariant,
    planar: bool = False,
):
    return jax.jit(
        _build_onedispatch_slab_program(
            n_images, height, width, preset, variant, planar
        )
    )


def start_one_dispatch_slab(
    pixels_stack,
    maxval: int,
    config: EncoderConfig,
    luma_q: np.ndarray,
    chroma_q: np.ndarray,
) -> list[OneDispatchState]:
    """Dispatch B same-geometry images as ONE row-stacked slab program.

    pixels_stack: [B, H, W, 3] (or [B, 3, H, W] planar), host or device.
    Images are pre-padded to the preset's MCU multiple on host (black)
    when needed. Returns one OneDispatchState per image; finish each with
    finish_one_dispatch as usual — bytes equal B standalone encodes."""
    b = int(pixels_stack.shape[0])
    planar = (
        int(pixels_stack.shape[1]) == 3 and int(pixels_stack.shape[3]) != 3
    )
    if planar:
        height, width = int(pixels_stack.shape[2]), int(pixels_stack.shape[3])
    else:
        height, width = int(pixels_stack.shape[1]), int(pixels_stack.shape[2])
    from .ops.geometry import padded_size

    preset = config.chroma_subsampling
    ph, pw = padded_size(height, width, preset)
    if (ph, pw) != (height, width):
        # pre-pad each image so slab MCU rows never straddle images
        arr = np.asarray(pixels_stack)
        if planar:
            padded = np.zeros((b, 3, ph, pw), dtype=arr.dtype)
            padded[:, :, :height, :width] = arr
        else:
            padded = np.zeros((b, ph, pw, 3), dtype=arr.dtype)
            padded[:, :height, :width] = arr
        pixels_stack = padded
    blocks_per_image = _total_blocks(height, width, preset)
    limit = slab_max_blocks()
    if b * blocks_per_image > limit:
        raise ValueError(
            f"start_one_dispatch_slab: {b} x {blocks_per_image} blocks "
            f"exceeds the {limit}-block single-program compile limit; "
            f"split the group (or raise DMMT_SLAB_MAX_BLOCKS)"
        )
    fn = _compiled_onedispatch_slab(
        b, height, width, preset, config.dct_variant, planar=planar
    )
    out = fn(
        jnp.asarray(pixels_stack),
        jnp.float32(maxval),
        jnp.asarray(luma_q),
        jnp.asarray(chroma_q),
    )
    k = N_ONEDISPATCH_OUTPUTS
    states = []
    for i in range(b):
        o = out[i * k : (i + 1) * k]
        states.append(
            OneDispatchState(
                words=o[0], total_bits=o[1], spec_syms=o[2], spec_lens=o[3],
                spec_ns=o[4], hists=o[5:9], height=height, width=width,
            )
        )
    return states


@mode_keyed_cache(maxsize=32)
def _compiled_onedispatch(
    height: int,
    width: int,
    preset: ChromaSubsamplingPreset,
    variant: DCTVariant,
    planar: bool = False,
):
    return jax.jit(
        _build_onedispatch_program(height, width, preset, variant, planar)
    )


N_ONEDISPATCH_OUTPUTS = 9


@mode_keyed_cache(maxsize=8)
def _compiled_onedispatch_multi(
    n_images: int,
    height: int,
    width: int,
    preset: ChromaSubsamplingPreset,
    variant: DCTVariant,
    planar: bool = False,
):
    """n_images full encodes in ONE jit program: one dispatch per group
    instead of one per image. Outputs are the concatenated per-image
    tuples (no stacked arrays, so finishing needs no device-side
    slicing)."""
    program = _build_onedispatch_program(height, width, preset, variant, planar)

    def multi(rgb_stack, maxval, luma_q, chroma_q):
        outs = ()
        for i in range(n_images):
            outs = outs + program(rgb_stack[i], maxval, luma_q, chroma_q)
        return outs

    return jax.jit(multi)


def start_one_dispatch_multi(
    pixels_stack,
    maxval: int,
    config: EncoderConfig,
    luma_q: np.ndarray,
    chroma_q: np.ndarray,
) -> list[OneDispatchState]:
    """Dispatch a group of same-geometry images as ONE program.

    pixels_stack: [B, H, W, 3] (or [B, 3, H, W] planar), device-resident
    or host. Returns one OneDispatchState per image; finish each with
    finish_one_dispatch as usual."""
    b = int(pixels_stack.shape[0])
    planar = int(pixels_stack.shape[1]) == 3 and int(pixels_stack.shape[3]) != 3
    if planar:
        height, width = int(pixels_stack.shape[2]), int(pixels_stack.shape[3])
    else:
        height, width = int(pixels_stack.shape[1]), int(pixels_stack.shape[2])
    blocks_per_image = _total_blocks(height, width, config.chroma_subsampling)
    limit = slab_max_blocks()
    if b * blocks_per_image > limit:
        raise ValueError(
            f"start_one_dispatch_multi: {b} x {blocks_per_image} blocks "
            f"exceeds the {limit}-block single-program compile limit; "
            f"split the group (or raise DMMT_SLAB_MAX_BLOCKS)"
        )
    fn = _compiled_onedispatch_multi(
        b, height, width, config.chroma_subsampling, config.dct_variant,
        planar=planar,
    )
    out = fn(
        jnp.asarray(pixels_stack),
        jnp.float32(maxval),
        jnp.asarray(luma_q),
        jnp.asarray(chroma_q),
    )
    k = N_ONEDISPATCH_OUTPUTS
    states = []
    for i in range(b):
        o = out[i * k : (i + 1) * k]
        states.append(
            OneDispatchState(
                words=o[0], total_bits=o[1], spec_syms=o[2], spec_lens=o[3],
                spec_ns=o[4], hists=o[5:9], height=height, width=width,
            )
        )
    return states


def start_one_dispatch(
    pixels: np.ndarray,
    maxval: int,
    config: EncoderConfig,
    luma_q: np.ndarray,
    chroma_q: np.ndarray,
) -> OneDispatchState:
    """Dispatch the full encode program (asynchronous).

    pixels: [H, W, 3] interleaved or [3, H, W] channel-planar."""
    planar = int(pixels.shape[0]) == 3 and int(pixels.shape[2]) != 3
    if planar:
        height, width = int(pixels.shape[1]), int(pixels.shape[2])
    else:
        height, width = int(pixels.shape[0]), int(pixels.shape[1])
    fn = _compiled_onedispatch(
        height, width, config.chroma_subsampling, config.dct_variant,
        planar=planar,
    )
    out = fn(
        jnp.asarray(pixels),
        jnp.float32(maxval),
        jnp.asarray(luma_q),
        jnp.asarray(chroma_q),
    )
    return OneDispatchState(
        words=out[0], total_bits=out[1], spec_syms=out[2], spec_lens=out[3],
        spec_ns=out[4], hists=out[5:9], height=height, width=width,
    )


# Previous stream sizes by image geometry: lets finish_one_dispatch fetch
# the word slice TOGETHER with the table spec in one device round trip
# (speculatively sized ~20% above the last stream for the same geometry)
# instead of paying a second round trip after learning total_bits.
_LAST_BITS: dict[tuple, int] = {}


def _speculative_slice(state: OneDispatchState, config: EncoderConfig):
    """Device-side slice of the word stream sized ~20% above the previous
    encode at the same geometry/quality, or None on the first encode."""
    geom_key = (state.height, state.width, config.chroma_subsampling,
                config.quality, config.quantization_preset)
    last_bits = _LAST_BITS.get(geom_key)
    if last_bits is None:
        return None
    guess = min(
        int(state.words.shape[0]),
        ((last_bits + last_bits // 5) + 31) // 32 + 8,
    )
    return state.words[:guess]


def prefetch_one_dispatch(state: OneDispatchState,
                          config: EncoderConfig) -> None:
    """Start asynchronous device->host copies of everything
    finish_one_dispatch will read.

    With several dispatches in flight, calling this on each state before
    finishing any lets the copies queue behind the device programs, so the
    blocking round trip is paid once per drain, not once per image. finish_one_dispatch stays correct whether
    or not this ran (device_get of an already-copied array is free)."""
    if state.spec_slice is None:
        state.spec_slice = _speculative_slice(state, config)
    arrays = [state.total_bits, state.spec_syms, state.spec_lens,
              state.spec_ns]
    if state.spec_slice is not None:
        arrays.append(state.spec_slice)
    for a in arrays:
        try:
            a.copy_to_host_async()
        except (AttributeError, NotImplementedError):
            return  # backend has no async copies: finish fetches as usual


def tables_from_spec(spec_syms, spec_lens, spec_ns):
    """Decode the device table spec (leaf-order symbols/lengths + present
    counts, [4, 256]/[4]) into host HuffmanTables. Shared by the
    single-chip and sharded one-dispatch finishes."""
    from .encoder import HuffmanTables

    lists = []
    for t in range(4):
        n = int(spec_ns[t])
        lists.append(
            [
                SymbolCodeLength(int(spec_syms[t, i]), int(spec_lens[t, i]))
                for i in range(n)
            ]
        )
    return HuffmanTables(
        luma_dc=lists[0], luma_ac=lists[1], chroma_dc=lists[2],
        chroma_ac=lists[3],
    )


def finish_one_dispatch(state: OneDispatchState, config: EncoderConfig):
    """Synchronize: one speculative fetch (table spec + bits + a word
    slice sized from the previous encode); a second fetch only when the
    stream grew past the speculation.

    Returns (scan_bytes, HuffmanTables)."""
    from .bitstream.device_pack import (
        _check_bits_enabled,
        exact_scan_bits,
        finalize_scan_bytes,
    )
    from .huffman.canonical import flat_code_arrays

    geom_key = (state.height, state.width, config.chroma_subsampling,
                config.quality, config.quantization_preset)
    if state.spec_slice is None:
        state.spec_slice = _speculative_slice(state, config)
    spec_words = None
    if state.spec_slice is not None:
        total_bits, spec_syms, spec_lens, spec_ns, spec_words = jax.device_get(
            (state.total_bits, state.spec_syms, state.spec_lens,
             state.spec_ns, state.spec_slice)
        )
    else:
        total_bits, spec_syms, spec_lens, spec_ns = jax.device_get(
            (state.total_bits, state.spec_syms, state.spec_lens,
             state.spec_ns)
        )
    tables = tables_from_spec(spec_syms, spec_lens, spec_ns)
    nbits = int(total_bits)
    if _check_bits_enabled():
        hists = jax.device_get(state.hists)
        predicted = exact_scan_bits(
            hists,
            flat_code_arrays(tables.luma_dc),
            flat_code_arrays(tables.luma_ac),
            flat_code_arrays(tables.chroma_dc),
            flat_code_arrays(tables.chroma_ac),
        )
        if predicted != nbits:
            raise AssertionError(
                f"one-dispatch packed {nbits} bits but histograms x device "
                f"tables predict {predicted}"
            )
    _LAST_BITS[geom_key] = nbits
    needed = (nbits + 31) // 32
    if spec_words is not None and len(spec_words) >= needed:
        host_words = spec_words[:needed]
    elif spec_words is not None:
        tail = jax.device_get(state.words[len(spec_words) : needed])
        host_words = np.concatenate([spec_words, tail])
    else:
        host_words = jax.device_get(state.words[:needed])
    return finalize_scan_bytes(host_words, nbits), tables

"""The single-chip encode pipeline.

Device core: ONE jit-compiled, static-shape XLA program from raw RGB
samples to (quantized zigzag coefficient blocks, symbol histograms):

    normalize -> pad -> RGB->YCbCr -> subsample -> blockize (luma directly
    into MCU-entangled order via a constant gather) -> batched 8x8 DCT ->
    quantize + zigzag -> DC DPCM -> histograms

This replaces the reference's lazy iterator chain + thread pool
(reference: src/image/writer/jpeg/transformer.rs:188-221) with batched
dataflow XLA fuses end to end. Everything after — Huffman table
construction, scan packing, container — is the thin host tail
(host_finalize / encoder.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from .config import ChromaSubsamplingPreset, DCTVariant, EncoderConfig
from .ops.fp import div
from .ops.color import rgb_to_ycbcr
from .ops.dct import dct2d
from .ops.geometry import (
    blockize,
    entangle_permutation,
    entangled_blockize_p420,
    pad_to_mcu_multiple,
    padded_size,
    subsample,
)
from .ops.quantize import quantize_zigzag
from .entropy.categorize import dc_dpcm, symbol_histograms
from .utils.capability import mode_keyed_cache


@dataclass
class DeviceEncodeResult:
    """Pipeline outputs. Histograms are always host numpy (they gate the
    host-side Huffman build); the coefficient blocks may still be
    DEVICE-RESIDENT jax arrays so the device scan packer can consume them
    without a 25 MB round trip — np.asarray() them for host paths."""

    luma: np.ndarray      # int16 [NL, 64] zigzag, DC = DPCM delta, MCU order
    cb: np.ndarray        # int16 [NC, 64]
    cr: np.ndarray        # int16 [NC, 64]
    luma_dc_hist: np.ndarray    # int32 [16]
    luma_ac_hist: np.ndarray    # int32 [256]
    chroma_dc_hist: np.ndarray  # int32 [16]
    chroma_ac_hist: np.ndarray  # int32 [256]


def _plane_mode() -> str:
    """Phase-1 layout strategy for the ARAI path (DMMT_P1 env):

    - "plane" (default): run the Arai passes directly on PLANE layout —
      the 8-point axes come from FREE reshapes ([H,W] -> [H,B,8] and
      [A,8,B,8]), so the f32 [N,8,8] blockize transpose never happens;
      only quantized int16 coefficients get shuffled, once.
    - "plane_mm": same, but the (v,u) interleave + zigzag are folded into
      exact one-hot matmuls (at HIGHEST precision) before rounding,
      removing the int16 transpose too.
    - "plane2": keeps all 64 coefficient planes as separate [A, B] arrays
      through both butterfly passes and stacks once in zigzag order.
    - "block": the blockize-first path.
    All modes produce bit-identical blocks (f32 elementwise ops don't
    depend on vectorization layout; the matmuls are exact one-hots).
    """
    import os

    return os.environ.get("DMMT_P1", "plane")


# P_UV[u*8+v, j] = 1 iff zigzag position j reads raster (v, u) — the
# zigzag permutation re-based onto u-major flattening (what the plane_mm
# transpose-by-matmul produces).
def _zz_perm_uv() -> np.ndarray:
    from .tables import ZIGZAG

    p = np.zeros((64, 64), dtype=np.float32)
    for j in range(64):
        rast = int(ZIGZAG[j])
        v, u = rast // 8, rast % 8
        p[u * 8 + v, j] = 1.0
    return p


_P_UV = None


def _plane_dct_zigzag_blocks_fullwidth(
    plane: jnp.ndarray,
    qtable: jnp.ndarray,
    entangle_quads: bool,
) -> jnp.ndarray:
    """[H, W] f32 plane -> int16 [N, 64] zigzag blocks, Arai bit-exact,
    with the 64 (v, u) coefficient planes kept as separate [A, B]-shaped
    arrays through both butterfly passes and quantization. One strided
    read (the eight x-phase slices) and one strided write (the
    zigzag-ordered stack) bracket ~800 elementwise ops."""
    from .ops.dct import _arai_butterfly
    from .ops.quantize import round_half_away_from_zero
    from .tables import ZIGZAG

    hh, ww = plane.shape
    a, b = hh // 8, ww // 8
    p4 = plane.reshape(a, 8, b, 8)                    # [A, 8y, B, 8x] free
    xs = tuple(p4[:, :, :, x] for x in range(8))      # 8 x [A, 8y, B]
    us = _arai_butterfly(xs)                          # row pass (over x)
    q = qtable.astype(jnp.float32).reshape(8, 8)      # may be traced
    vals: dict[tuple[int, int], jnp.ndarray] = {}
    for u in range(8):
        ys = tuple(us[u][:, y, :] for y in range(8))  # 8 x [A, B]
        vs = _arai_butterfly(ys)                      # col pass (over y)
        for v in range(8):
            vals[(v, u)] = round_half_away_from_zero(
                div(vs[v], q[v, u])
            ).astype(jnp.int16)
    zz_order = [divmod(int(ZIGZAG[j]), 8) for j in range(64)]
    blk = jnp.stack([vals[vu] for vu in zz_order], axis=-1)  # [A, B, 64]
    if entangle_quads:
        blk = blk.reshape(a // 2, 2, b // 2, 2, 64).transpose(0, 2, 1, 3, 4)
    return blk.reshape(-1, 64)


def _plane_dct_zigzag_blocks(
    plane: jnp.ndarray,
    qtable: jnp.ndarray,
    entangle_quads: bool,
    mode: str,
) -> jnp.ndarray:
    """[H, W] f32 plane -> int16 [N, 64] zigzag blocks, Arai bit-exact in
    every mode."""
    global _P_UV
    from .ops.dct import _arai_pass
    from .ops.quantize import round_half_away_from_zero
    from .tables import ZIGZAG

    if mode == "plane2":
        return _plane_dct_zigzag_blocks_fullwidth(
            plane, qtable, entangle_quads
        )

    hh, ww = plane.shape
    a, b = hh // 8, ww // 8

    r = _arai_pass(plane.reshape(hh, b, 8), axis=-1)   # rows: along x
    r = r.reshape(a, 8, b, 8)                          # [A, 8y, B, 8u] free
    c = _arai_pass(r, axis=1)                          # cols: [A, 8v, B, 8u]
    qv = qtable.astype(jnp.float32).reshape(8, 8)
    scaled = div(c, qv[None, :, None, :])

    if mode == "plane_mm":
        if _P_UV is None:
            _P_UV = _zz_perm_uv()
        eye = jnp.eye(8, dtype=jnp.float32)
        t = jnp.einsum(
            "avbu,vw->abuw", scaled, eye,
            precision=jax.lax.Precision.HIGHEST,
        )                                              # [A, B, 8u, 8v]
        zz = jnp.dot(
            t.reshape(-1, 64), jnp.asarray(_P_UV),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )
        out = round_half_away_from_zero(zz).astype(jnp.int16).reshape(a, b, 64)
    else:
        rounded = round_half_away_from_zero(scaled).astype(jnp.int16)
        blk = rounded.transpose(0, 2, 1, 3).reshape(-1, 64)  # raster 64
        out = blk[:, ZIGZAG].reshape(a, b, 64)

    if entangle_quads:
        out = out.reshape(a // 2, 2, b // 2, 2, 64).transpose(0, 2, 1, 3, 4)
    return out.reshape(-1, 64)


def dc_dpcm_per_image(dc: jnp.ndarray, n_images: int) -> jnp.ndarray:
    """DC delta chains that RESET at image boundaries: a slab program
    (onedispatch.start_one_dispatch_slab) stacks n_images same-geometry
    images' rows into one tall image, so its block axis is the
    concatenation of per-image block sequences. Each image's chain starts
    from predictor 0 exactly as a standalone encode would
    (categorize.rs:156-161 semantics, per image)."""
    if n_images == 1:
        return dc_dpcm(dc)
    per = dc.shape[0] // n_images
    return jax.vmap(dc_dpcm)(dc.reshape(n_images, per)).reshape(-1)


def encode_blocks_from_planes(
    y: jnp.ndarray,
    cb: jnp.ndarray,
    cr: jnp.ndarray,
    luma_q: jnp.ndarray,
    chroma_q: jnp.ndarray,
    preset: ChromaSubsamplingPreset,
    variant: DCTVariant,
    entangle: np.ndarray | None,
    n_images: int = 1,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Shared tail from YCbCr planes to DPCM'd zigzag blocks.

    Factored out so the sharded (shard_map) pipeline can reuse it per
    shard. n_images > 1: the planes are a row-stacked slab of
    same-geometry images; DC chains reset per image.
    """
    mode = _plane_mode()
    if variant is DCTVariant.ARAI and mode in ("plane", "plane_mm", "plane2"):
        luma_zz = _plane_dct_zigzag_blocks(
            y, luma_q, entangle is not None, mode
        )
        # ONE chroma chain: Cb/Cr stacked vertically run the identical
        # per-8x8-block math (rows stay block-aligned), halving the
        # chroma chain's kernel launches; split back after (raster
        # block order = all Cb rows then all Cr rows)
        cbcr = jnp.concatenate(
            [subsample(cb, preset), subsample(cr, preset)], axis=0
        )
        cbcr_zz = _plane_dct_zigzag_blocks(cbcr, chroma_q, False, mode)
        nc = cbcr_zz.shape[0] // 2
        cb_zz = cbcr_zz[:nc]
        cr_zz = cbcr_zz[nc:]
    else:
        if entangle is not None:
            # P420: straight to MCU-quad order via reshape/transpose
            luma_blocks = entangled_blockize_p420(y)
        else:
            luma_blocks = blockize(y)
        cb_blocks = blockize(subsample(cb, preset))
        cr_blocks = blockize(subsample(cr, preset))

        if variant is DCTVariant.FUSED:
            from .ops.fused import fused_dct_quantize_zigzag

            luma_zz = fused_dct_quantize_zigzag(luma_blocks, luma_q)
            cb_zz = fused_dct_quantize_zigzag(cb_blocks, chroma_q)
            cr_zz = fused_dct_quantize_zigzag(cr_blocks, chroma_q)
        else:
            luma_zz = quantize_zigzag(dct2d(luma_blocks, variant), luma_q)
            cb_zz = quantize_zigzag(dct2d(cb_blocks, variant), chroma_q)
            cr_zz = quantize_zigzag(dct2d(cr_blocks, variant), chroma_q)

    luma_zz = luma_zz.at[:, 0].set(dc_dpcm_per_image(luma_zz[:, 0], n_images))
    cb_zz = cb_zz.at[:, 0].set(dc_dpcm_per_image(cb_zz[:, 0], n_images))
    cr_zz = cr_zz.at[:, 0].set(dc_dpcm_per_image(cr_zz[:, 0], n_images))
    return luma_zz, cb_zz, cr_zz


def build_pipeline_fn(
    height: int,
    width: int,
    preset: ChromaSubsamplingPreset,
    variant: DCTVariant,
):
    """The raw (unjitted) device program for a HxW image: uint16 RGB ->
    (zigzag blocks x3, histograms x4). Static-shape, jit/shard-ready."""
    ph, pw = padded_size(height, width, preset)
    entangle = entangle_permutation(pw // 8, ph // 8, preset)

    def pipeline(rgb_u16, maxval, luma_q, chroma_q):
        rgb = div(rgb_u16.astype(jnp.float32), maxval)
        rgb = pad_to_mcu_multiple(rgb, preset)
        y, cb, cr = rgb_to_ycbcr(rgb)
        luma_zz, cb_zz, cr_zz = encode_blocks_from_planes(
            y, cb, cr, luma_q, chroma_q, preset, variant, entangle
        )
        l_dc, l_ac = symbol_histograms(luma_zz)
        # chroma histograms are consumed summed: one exact pass over the
        # concatenated Cb/Cr blocks instead of two
        c_dc, c_ac = symbol_histograms(
            jnp.concatenate([cb_zz, cr_zz], axis=0)
        )
        return (
            luma_zz,
            cb_zz,
            cr_zz,
            l_dc,
            l_ac,
            c_dc,
            c_ac,
        )

    return pipeline


@mode_keyed_cache(maxsize=32)
def _compiled_pipeline(
    height: int,
    width: int,
    preset: ChromaSubsamplingPreset,
    variant: DCTVariant,
):
    return jax.jit(build_pipeline_fn(height, width, preset, variant))


@mode_keyed_cache(maxsize=16)
def _compiled_pipeline_batch(
    height: int,
    width: int,
    preset: ChromaSubsamplingPreset,
    variant: DCTVariant,
):
    """One dispatch for B images: the per-image block pipeline and the
    per-image histograms are vmapped."""
    from .entropy.categorize import batched_symbol_histograms

    ph, pw = padded_size(height, width, preset)
    entangle = entangle_permutation(pw // 8, ph // 8, preset)

    def core(rgb_u16, maxval, luma_q, chroma_q):
        rgb = div(rgb_u16.astype(jnp.float32), maxval)
        rgb = pad_to_mcu_multiple(rgb, preset)
        y, cb, cr = rgb_to_ycbcr(rgb)
        return encode_blocks_from_planes(
            y, cb, cr, luma_q, chroma_q, preset, variant, entangle
        )

    def batched(rgb_u16, maxval, luma_q, chroma_q):
        luma_zz, cb_zz, cr_zz = jax.vmap(
            core, in_axes=(0, None, None, None)
        )(rgb_u16, maxval, luma_q, chroma_q)
        l_dc, l_ac = batched_symbol_histograms(luma_zz)
        # chroma histograms are consumed summed: one pass on concat Cb/Cr
        c_dc, c_ac = batched_symbol_histograms(
            jnp.concatenate([cb_zz, cr_zz], axis=1)
        )
        return (
            luma_zz,
            cb_zz,
            cr_zz,
            l_dc,
            l_ac,
            c_dc,
            c_ac,
        )

    return jax.jit(batched)


def run_device_pipeline_batch(
    pixels: np.ndarray,
    maxval: int,
    config: EncoderConfig,
    luma_q: np.ndarray,
    chroma_q: np.ndarray,
):
    """[B, H, W, 3] -> batched DeviceEncodeResult-like tuple of jax arrays:
    (luma [B,NL,64], cb, cr, dc/ac histograms [B,...])."""
    height, width = int(pixels.shape[1]), int(pixels.shape[2])
    fn = _compiled_pipeline_batch(
        height, width, config.chroma_subsampling, config.dct_variant
    )
    return fn(
        jnp.asarray(pixels),
        jnp.float32(maxval),
        jnp.asarray(luma_q),
        jnp.asarray(chroma_q),
    )


def run_device_pipeline(
    pixels: np.ndarray,
    maxval: int,
    config: EncoderConfig,
    luma_q: np.ndarray,
    chroma_q: np.ndarray,
) -> DeviceEncodeResult:
    """Execute the jitted pipeline and materialize outputs on host."""
    height, width = int(pixels.shape[0]), int(pixels.shape[1])
    fn = _compiled_pipeline(
        height, width, config.chroma_subsampling, config.dct_variant
    )
    outputs = fn(
        jnp.asarray(pixels),
        jnp.float32(maxval),
        jnp.asarray(luma_q),
        jnp.asarray(chroma_q),
    )
    # Everything stays device-resident; dispatch is asynchronous, so the
    # caller can issue further work before the first histogram fetch
    # (HuffmanTables.from_histograms) synchronizes.
    return DeviceEncodeResult(
        luma=outputs[0],
        cb=outputs[1],
        cr=outputs[2],
        luma_dc_hist=outputs[3],
        luma_ac_hist=outputs[4],
        chroma_dc_hist=outputs[5],
        chroma_ac_hist=outputs[6],
    )

"""Image geometry ops: MCU padding, chroma subsampling, blockization,
MCU-entangled block order.

Design notes:
- Padding and subsampling are static-shape reshape/slice ops XLA fuses
  into the surrounding elementwise work.
- The reference's block-major "square structure" resort
  (src/image/subsampling.rs:238-310) becomes a reshape/transpose; its P420
  QuadFoldingIterator (src/...transformer/block_entangler.rs:24-91) becomes
  a CONSTANT gather permutation computed at trace time, so the luma DC-DPCM
  chain runs in MCU order with zero data-dependent control flow.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..config import ChromaSubsamplingPreset, SubsamplingMethod


def padded_size(height: int, width: int, preset: ChromaSubsamplingPreset) -> tuple[int, int]:
    """Pad-to multiples of (v_rate*8, h_rate*8)
    (reference: src/...jpeg/transformer.rs:48-51, padder.rs:12-20)."""
    mh, mw = preset.mcu_height, preset.mcu_width
    return (-(-height // mh) * mh, -(-width // mw) * mw)


def pad_to_mcu_multiple(
    rgb: jnp.ndarray, preset: ChromaSubsamplingPreset
) -> jnp.ndarray:
    """Pad [H, W, 3] with black (0.0 in normalized RGB) on the right/bottom
    (reference: src/image/writer/jpeg/padder.rs:12-42)."""
    h, w = rgb.shape[0], rgb.shape[1]
    ph, pw = padded_size(h, w, preset)
    if (ph, pw) == (h, w):
        return rgb
    return jnp.pad(rgb, ((0, ph - h), (0, pw - w), (0, 0)))


def subsample(chan: jnp.ndarray, preset: ChromaSubsamplingPreset) -> jnp.ndarray:
    """Chroma subsampling on an MCU-padded channel [H, W].

    Skip takes the top-left sample of each h x v cell; Average takes the
    cell mean with the reference's summation order — the rect is pushed
    column-major (x outer, y inner; src/image/subsampling.rs:108-122), so a
    2x2 cell sums as ((tl + bl) + tr) + br. The channel is already padded to
    rate multiples so the reference's border clamping never triggers.
    """
    hr, vr = preset.horizontal_rate, preset.vertical_rate
    if hr == 1 and vr == 1:
        return chan
    h, w = chan.shape
    if preset.method is SubsamplingMethod.SKIP:
        return chan.reshape(h // vr, vr, w // hr, hr)[:, 0, :, 0]
    cells = chan.reshape(h // vr, vr, w // hr, hr)
    if vr == 1:  # P422: left + right
        return (cells[:, 0, :, 0] + cells[:, 0, :, 1]) / 2.0
    # P420: ((tl + bl) + tr) + br, then / 4
    tl, tr = cells[:, 0, :, 0], cells[:, 0, :, 1]
    bl, br = cells[:, 1, :, 0], cells[:, 1, :, 1]
    return (((tl + bl) + tr) + br) / 4.0


def subsample_generalized(
    chan: jnp.ndarray,
    horizontal_rate: int,
    vertical_rate: int,
    method: SubsamplingMethod,
) -> jnp.ndarray:
    """Arbitrary-rate subsampling with the reference's border semantics
    (reference: src/image/subsampling.rs:81-135): the row/column views
    yield a sample for every start index below the channel bound, so
    output dims are CEIL(dim / rate) — a partial trailing cell still
    produces one output (subsampling.rs:175-177, 208-210; exercised by
    its repeat_border_test, rate 3 on 4 rows -> 2 output rows); Average
    pushes the h x v rect column-major (x outer, y inner) with
    coordinates CLAMPED to the last row/column (subsampling.rs:108-122),
    and divides by the full rect size (clamped duplicates included).

    The CLI presets take the reshape fast path in subsample(); this is the
    library-level generalization (any rates, any — even non-multiple —
    channel shape). Rates are static, so the cell loop unrolls at trace
    time into shifted adds; only non-divisible shapes pay a clamped slice.
    """
    hr, vr = int(horizontal_rate), int(vertical_rate)
    if hr < 1 or vr < 1:
        raise ValueError("subsampling rates must be >= 1")
    h, w = chan.shape
    sh, sw = -(-h // vr), -(-w // hr)
    if method is SubsamplingMethod.SKIP:
        return chan[::vr, ::hr]

    def shifted(y: int, x: int) -> jnp.ndarray:
        # sample grid (r*vr + y, c*hr + x), edge-clamped
        if (sh - 1) * vr + y < h and (sw - 1) * hr + x < w:
            return chan[y : y + sh * vr : vr, x : x + sw * hr : hr]
        rows = np.minimum(np.arange(sh) * vr + y, h - 1)
        cols = np.minimum(np.arange(sw) * hr + x, w - 1)
        return chan[rows][:, cols]

    total = None
    for x in range(hr):          # reference sum order: x outer, y inner
        for y in range(vr):
            s = shifted(y, x)
            total = s if total is None else total + s
    return total / float(hr * vr)


def blockize(chan: jnp.ndarray) -> jnp.ndarray:
    """[H, W] -> [n_blocks, 8, 8] in raster block order (row of blocks at a
    time), the reshape form of subsample_to_square_structure
    (reference: src/image/subsampling.rs:137-142, 286-309)."""
    h, w = chan.shape
    return (
        chan.reshape(h // 8, 8, w // 8, 8)
        .transpose(0, 2, 1, 3)
        .reshape(-1, 8, 8)
    )


def entangled_blockize_p420(chan: jnp.ndarray) -> jnp.ndarray:
    """[H, W] -> [n_blocks, 8, 8] directly in P420 MCU (quad) order.

    Equivalent to blockize()[entangle_permutation(...)] but as a pure
    reshape/transpose, which XLA lowers to one copy instead of a row
    gather. Quad order: TL, TR, BL, BR
    (reference: block_entangler.rs:69-91)."""
    h, w = chan.shape
    return (
        chan.reshape(h // 16, 2, 8, w // 16, 2, 8)
        .transpose(0, 3, 1, 4, 2, 5)
        .reshape(-1, 8, 8)
    )


def entangle_permutation(
    blocks_per_row: int, blocks_per_col: int, preset: ChromaSubsamplingPreset
) -> np.ndarray | None:
    """Constant permutation: entangled (MCU-order) position -> raster block
    index, or None when the order is unchanged.

    P420 only: each pair of luma block rows is refolded into 2x2 quads
    (top-left, top-right, bottom-left, bottom-right), matching the
    QuadFoldingIterator (reference: block_entangler.rs:69-91; P444/P422 pass
    through, block_entangler.rs:10-21).
    """
    if preset is not ChromaSubsamplingPreset.P420:
        return None
    if blocks_per_col % 2 or blocks_per_row % 2:
        # Cannot happen for MCU-padded images (IncompleteBlockLine analog).
        raise ValueError("P420 entangling requires even block dimensions")
    rows = np.arange(blocks_per_col // 2) * 2
    cols = np.arange(blocks_per_row // 2) * 2
    quads = np.empty((len(rows), len(cols), 4), dtype=np.int64)
    quads[:, :, 0] = rows[:, None] * blocks_per_row + cols[None, :]
    quads[:, :, 1] = rows[:, None] * blocks_per_row + cols[None, :] + 1
    quads[:, :, 2] = (rows[:, None] + 1) * blocks_per_row + cols[None, :]
    quads[:, :, 3] = (rows[:, None] + 1) * blocks_per_row + cols[None, :] + 1
    return quads.reshape(-1)

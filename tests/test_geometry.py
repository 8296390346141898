"""Padding / subsampling / blockize / MCU entangling tests
(reference behavior: padder.rs, subsampling.rs, block_entangler.rs)."""

import numpy as np
import jax.numpy as jnp
import pytest

from dmmt_jpeg_encoder.config import ChromaSubsamplingPreset
from dmmt_jpeg_encoder.ops.geometry import (
    blockize,
    entangle_permutation,
    pad_to_mcu_multiple,
    padded_size,
    subsample,
)

P444 = ChromaSubsamplingPreset.P444
P422 = ChromaSubsamplingPreset.P422
P420 = ChromaSubsamplingPreset.P420


@pytest.mark.parametrize(
    "h,w,preset,expected",
    [
        (8, 8, P444, (8, 8)),
        (8, 8, P420, (16, 16)),
        (17, 7, P444, (24, 8)),
        (17, 7, P420, (32, 16)),
        (17, 7, P422, (24, 16)),
        (500, 500, P420, (512, 512)),
        (16, 16, P420, (16, 16)),
    ],
)
def test_padded_size(h, w, preset, expected):
    assert padded_size(h, w, preset) == expected


def test_pad_fills_black():
    rgb = jnp.ones((7, 17, 3), dtype=jnp.float32)
    out = np.asarray(pad_to_mcu_multiple(rgb, P420))
    assert out.shape == (16, 32, 3)
    np.testing.assert_array_equal(out[:7, :17], 1.0)
    assert out[7:, :].sum() == 0.0
    assert out[:, 17:].sum() == 0.0


def test_subsample_p444_identity():
    x = jnp.arange(64, dtype=jnp.float32).reshape(8, 8)
    np.testing.assert_array_equal(np.asarray(subsample(x, P444)), np.asarray(x))


def test_subsample_p422_average():
    x = jnp.asarray([[1.0, 3.0, 5.0, 7.0]] * 2)
    out = np.asarray(subsample(x, P422))
    np.testing.assert_array_equal(out, [[2.0, 6.0], [2.0, 6.0]])


def test_subsample_p420_average():
    x = jnp.asarray(
        [
            [1.0, 2.0, 10.0, 20.0],
            [3.0, 4.0, 30.0, 40.0],
            [5.0, 6.0, 50.0, 60.0],
            [7.0, 8.0, 70.0, 80.0],
        ]
    )
    out = np.asarray(subsample(x, P420))
    np.testing.assert_array_equal(out, [[2.5, 25.0], [6.5, 65.0]])


def test_blockize_raster_block_order():
    # 16x16 -> 4 blocks in raster block order, each 8x8 contiguous
    x = jnp.arange(256, dtype=jnp.float32).reshape(16, 16)
    blocks = np.asarray(blockize(x))
    assert blocks.shape == (4, 8, 8)
    np.testing.assert_array_equal(blocks[0], np.asarray(x)[:8, :8])
    np.testing.assert_array_equal(blocks[1], np.asarray(x)[:8, 8:])
    np.testing.assert_array_equal(blocks[2], np.asarray(x)[8:, :8])
    np.testing.assert_array_equal(blocks[3], np.asarray(x)[8:, 8:])


def test_entangle_none_for_p444_p422():
    assert entangle_permutation(4, 4, P444) is None
    assert entangle_permutation(4, 4, P422) is None


def test_entangle_p420_quad_order():
    # 4 blocks/row x 2 block rows -> MCU order: TL TR BL BR per 2x2 quad
    # (reference: block_entangler.rs:69-91)
    perm = entangle_permutation(4, 2, P420)
    assert perm.tolist() == [0, 1, 4, 5, 2, 3, 6, 7]


def test_entangle_p420_larger():
    perm = entangle_permutation(4, 4, P420)
    assert perm.tolist() == [0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15]


def test_entangle_odd_rejected():
    with pytest.raises(ValueError):
        entangle_permutation(3, 2, P420)


def test_entangled_blockize_matches_permutation(rng):
    from dmmt_jpeg_encoder.ops.geometry import entangled_blockize_p420

    chan = jnp.asarray(rng.random((48, 64)).astype(np.float32))
    perm = entangle_permutation(64 // 8, 48 // 8, P420)
    expected = np.asarray(blockize(chan))[perm]
    np.testing.assert_array_equal(
        np.asarray(entangled_blockize_p420(chan)), expected
    )


# --- generalized subsampler (reference: src/image/subsampling.rs:81-135) ---


def _reference_subsample(chan, hr, vr, average):
    """Direct numpy port of the reference's rect/clamp/ordered-sum logic."""
    h, w = chan.shape
    # ceil semantics: the reference's lazy row/column views yield a
    # sample for every start index < bound (subsampling.rs:175-177,
    # 208-210), border-clamped — a partial trailing cell still counts
    sh, sw = -(-h // vr), -(-w // hr)
    out = np.empty((sh, sw), np.float32)
    for r in range(sh):
        for c in range(sw):
            if not average:
                out[r, c] = chan[r * vr, c * hr]
                continue
            acc = np.float32(0)
            for x in range(hr):
                for y in range(vr):
                    rr = min(h - 1, r * vr + y)
                    cc = min(w - 1, c * hr + x)
                    acc = acc + chan[rr, cc]
            out[r, c] = acc / np.float32(hr * vr)
    return out


@pytest.mark.parametrize(
    "shape,hr,vr",
    [((12, 16), 2, 2), ((13, 17), 2, 2), ((15, 14), 3, 2), ((9, 10), 1, 3),
     ((7, 7), 4, 4), ((8, 8), 1, 1)],
)
def test_subsample_generalized_average(shape, hr, vr):
    from dmmt_jpeg_encoder.config import SubsamplingMethod
    from dmmt_jpeg_encoder.ops.geometry import subsample_generalized

    rng = np.random.default_rng(5)
    chan = rng.random(shape, dtype=np.float32)
    got = np.asarray(
        subsample_generalized(jnp.asarray(chan), hr, vr, SubsamplingMethod.AVERAGE)
    )
    want = _reference_subsample(chan, hr, vr, average=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape,hr,vr", [((13, 17), 2, 3), ((8, 8), 2, 2)])
def test_subsample_generalized_skip(shape, hr, vr):
    from dmmt_jpeg_encoder.config import SubsamplingMethod
    from dmmt_jpeg_encoder.ops.geometry import subsample_generalized

    rng = np.random.default_rng(6)
    chan = rng.random(shape, dtype=np.float32)
    got = np.asarray(
        subsample_generalized(jnp.asarray(chan), hr, vr, SubsamplingMethod.SKIP)
    )
    want = _reference_subsample(chan, hr, vr, average=False)
    np.testing.assert_array_equal(got, want)


def test_subsample_generalized_matches_preset_path():
    """On MCU-padded shapes the generalized path must equal the preset
    reshape fast path bit-for-bit (same summation order)."""
    from dmmt_jpeg_encoder.config import ChromaSubsamplingPreset
    from dmmt_jpeg_encoder.ops.geometry import subsample, subsample_generalized

    rng = np.random.default_rng(7)
    chan = jnp.asarray(rng.random((32, 48), dtype=np.float32))
    for preset in ChromaSubsamplingPreset:
        got = np.asarray(
            subsample_generalized(
                chan, preset.horizontal_rate, preset.vertical_rate, preset.method
            )
        )
        want = np.asarray(subsample(chan, preset))
        np.testing.assert_array_equal(got, want)

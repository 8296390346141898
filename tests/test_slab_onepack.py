"""Slab batching details: the slab program's per-image pack tail and the
reused host stack buffers. Bytes always equal per-image encodes."""

import numpy as np

from dmmt_jpeg_encoder.config import EncoderConfig
from dmmt_jpeg_encoder.encoder import encode_array, encode_batch


def _tiny_images(b, h=24, w=38, seed=7):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    return [np.roll(base, 5 * i, axis=0) for i in range(b)]


def test_encode_batch_slab_legacy_loop_bytes(monkeypatch):
    """The slab program packs every image's stream with the shared
    one-dispatch tail (vmapped over the images): encode_batch slab bytes
    equal per-image encode_array, and the shared tail is what the slab
    program traces."""
    monkeypatch.setenv("DMMT_SLAB_B", "2")
    monkeypatch.setenv("DMMT_SLAB_MAX_ROWS", "100000")
    import dmmt_jpeg_encoder.onedispatch as od

    calls = {"per_image": 0}
    real_single = od._tables_to_pack

    def count_single(*a, **k):
        calls["per_image"] += 1
        return real_single(*a, **k)

    monkeypatch.setattr(od, "_tables_to_pack", count_single)
    od._compiled_onedispatch_slab.cache_clear()
    images = _tiny_images(2)
    config = EncoderConfig(scan_backend="device")
    got = encode_batch(images, 255, config)
    want = [encode_array(px, 255, config) for px in images]
    assert got == want
    assert calls["per_image"] >= 1, "slab program must trace the shared tail"
    od._compiled_onedispatch_slab.cache_clear()


def test_slab_stack_buffer_not_contaminated_across_sizes(monkeypatch):
    """Regression: the reused slab stack buffer is only written in
    [:h, :w], so two batches whose DIFFERENT true sizes share a padded
    size must not leak the first batch's pixels into the second's black
    pad region (the buffer key must include the true size)."""
    monkeypatch.setenv("DMMT_SLAB_B", "2")
    monkeypatch.setenv("DMMT_SLAB_MAX_ROWS", "100000")
    rng = np.random.default_rng(21)
    config = EncoderConfig(scan_backend="device")
    # both pad to 32 x 48 (P420 MCU = 16): 28x44 first, 24x38 second
    big = [rng.integers(0, 256, (28, 44, 3)).astype(np.uint8)
           for _ in range(2)]
    small = [rng.integers(0, 256, (24, 38, 3)).astype(np.uint8)
             for _ in range(2)]
    encode_batch(big, 255, config)  # fills the 32x48-padded buffer
    got = encode_batch(small, 255, config)
    want = [encode_array(px, 255, config) for px in small]
    assert got == want

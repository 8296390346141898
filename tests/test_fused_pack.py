"""The device scan packer (device_pack.pack_scan_words: emissions ->
exclusive scan of block bits -> disjoint scatter-add) vs the independent
pure-Python BitWriter packer, plus its validity mask and its vmapped
(slab) form."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from dmmt_jpeg_encoder.bitstream.device_pack import (
    combine_tables,
    finalize_scan_bytes,
    pack_scan_words,
    scan_words_capacity,
)
from dmmt_jpeg_encoder.bitstream.packer import encode_scan
from dmmt_jpeg_encoder.entropy.categorize import symbol_histograms
from dmmt_jpeg_encoder.huffman.canonical import flat_code_arrays
from dmmt_jpeg_encoder.huffman.spec import code_lengths_from_histogram


def _scan_case(rng, n_mcu, luma_per_mcu, density=0.15):
    """Random interleaved scan blocks + per-channel optimal tables."""
    stride = luma_per_mcu + 2
    n = n_mcu * stride
    blocks = np.zeros((n, 64), dtype=np.int16)
    mask = rng.random(blocks.shape) < density
    blocks[mask] = rng.integers(-900, 900, mask.sum())
    if n > 3:
        blocks[1] = 0
        blocks[2, 63] = 5  # trailing nonzero: ZRLs, no EOB
    is_chroma = (np.arange(n) % stride) >= luma_per_mcu

    def tables_for(sel):
        dc_h, ac_h = (
            np.asarray(h) for h in symbol_histograms(jnp.asarray(blocks[sel]))
        )
        dc = flat_code_arrays(code_lengths_from_histogram(dc_h))
        ac = flat_code_arrays(code_lengths_from_histogram(ac_h))
        return dc, ac

    ldc, lac = tables_for(~is_chroma)
    cdc, cac = tables_for(is_chroma)
    return blocks, is_chroma, ldc, lac, cdc, cac


def _comb(ldc, lac, cdc, cac):
    dc = np.concatenate(
        [
            combine_tables(np.asarray(ldc[0])[:16], np.asarray(ldc[1])[:16]),
            combine_tables(np.asarray(cdc[0])[:16], np.asarray(cdc[1])[:16]),
        ]
    )
    ac = np.concatenate(
        [
            combine_tables(np.asarray(lac[0]), np.asarray(lac[1])),
            combine_tables(np.asarray(cac[0]), np.asarray(cac[1])),
        ]
    )
    return jnp.asarray(dc), jnp.asarray(ac)


def _device_scan(blocks, lpm, tables, valid=None):
    dc, ac = _comb(*tables)
    words, bits = pack_scan_words(
        jnp.asarray(blocks), lpm + 2, lpm, dc, ac,
        scan_words_capacity(blocks.shape[0]),
        valid=None if valid is None else jnp.asarray(valid),
    )
    return finalize_scan_bytes(np.asarray(words), int(bits)), int(bits)


def _python_scan(blocks, is_chroma, lpm, tables):
    """Independent reference: the pure-Python BitWriter packer over the
    de-interleaved channels."""
    chroma = blocks[is_chroma]
    return encode_scan(
        blocks[~is_chroma], chroma[0::2], chroma[1::2], lpm, *tables,
        use_native=False,
    )


@pytest.mark.parametrize("luma_per_mcu,n_mcu", [(1, 40), (2, 30), (4, 25)])
def test_fused_pack_matches_reference(rng, luma_per_mcu, n_mcu):
    blocks, is_chroma, *tables = _scan_case(rng, n_mcu, luma_per_mcu)
    got, _ = _device_scan(blocks, luma_per_mcu, tables)
    assert got == _python_scan(blocks, is_chroma, luma_per_mcu, tables)


def test_fused_pack_dense_worst_case(rng):
    """Near-dense blocks: long codes, emissions spilling across words."""
    blocks, is_chroma, *tables = _scan_case(rng, 12, 4, density=0.95)
    got, _ = _device_scan(blocks, 4, tables)
    assert got == _python_scan(blocks, is_chroma, 4, tables)


def test_fused_pack_27bit_emission_value():
    """A 16-bit codeword paired with a category-11 coefficient makes a
    27-bit emission VALUE; all 27 bits must land in the stream (an i32
    pack that overflows the sign bit would corrupt it)."""
    lpm = 1
    stride = lpm + 2
    n_mcu = 4
    blocks = np.zeros((n_mcu * stride, 64), np.int16)
    # luma block 0: (run 0, cat 11) -> 16-bit code + 11 magnitude bits
    blocks[0, 1] = 1500
    blocks[0, 2] = -1200
    blocks[0, 10] = 3          # (run 7, cat 2)
    blocks[3, 5] = -1          # (run 4, cat 1)
    is_chroma = (np.arange(n_mcu * stride) % stride) >= lpm

    def flat(n, entries):
        codes = np.zeros(n, np.int64)
        lens = np.zeros(n, np.int64)
        for sym, code, ln in entries:
            codes[sym] = code
            lens[sym] = ln
        return codes, lens

    # handcrafted tables: both packers only look codes up
    tables = (
        flat(16, [(0, 0b101, 3)]),
        flat(256, [
            (0x0B, 0xFFFE, 16),   # run 0, cat 11 -> the 27-bit emission
            (0x72, 0x6, 3),       # run 7, cat 2
            (0x41, 0x2, 3),       # run 4, cat 1
            (0x00, 0x0, 2),       # EOB
        ]),
        flat(16, [(0, 0b1, 2)]),
        flat(256, [(0x00, 0x3, 2)]),
    )
    got, _ = _device_scan(blocks, lpm, tables)
    assert got == _python_scan(blocks, is_chroma, lpm, tables)


def test_pack_valid_mask_drops_masked_blocks(rng):
    """Masked blocks emit nothing: masking the last two MCUs packs the
    same stream as packing only the valid prefix."""
    lpm, stride = 2, 4
    blocks, is_chroma, *tables = _scan_case(rng, 20, lpm)
    n_valid = (20 - 2) * stride
    valid = np.arange(blocks.shape[0]) < n_valid
    got, bits = _device_scan(blocks, lpm, tables, valid=valid)
    want, want_bits = _device_scan(blocks[:n_valid], lpm, tables)
    assert (got, bits) == (want, want_bits)
    assert got == _python_scan(
        blocks[:n_valid], is_chroma[:n_valid], lpm, tables
    )


def test_pack_slab_vmapped_matches_per_image(rng):
    """The slab program vmaps the packer over stacked images; each image's
    stream equals its standalone pack."""
    lpm, n_mcu, b = 4, 9, 3
    cases = [_scan_case(rng, n_mcu, lpm) for _ in range(b)]
    n = cases[0][0].shape[0]
    cap = scan_words_capacity(n)
    dcs, acs = zip(*(_comb(*c[2:]) for c in cases))
    words, bits = jax.vmap(
        lambda blk, dc, ac: pack_scan_words(blk, lpm + 2, lpm, dc, ac, cap)
    )(
        jnp.stack([jnp.asarray(c[0]) for c in cases]),
        jnp.stack(dcs),
        jnp.stack(acs),
    )
    for i, c in enumerate(cases):
        got = finalize_scan_bytes(np.asarray(words[i]), int(bits[i]))
        assert got == _python_scan(c[0], c[1], lpm, c[2:])

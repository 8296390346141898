"""Device-side entropy-scan bit packing.

The reference emits the scan through a serial BitWriter on one CPU thread
(reference: src/image/writer/jpeg/encoder.rs:264-404, binary_stream.rs).
Here the whole variable-length bitstream is assembled ON DEVICE as three
data-parallel stages over the interleaved scan-order block array:

1. EMISSIONS — every (block, slot) pair becomes an independent
   (value, bit-length, block-relative offset) triple. Slots per block:
   1 DC (codeword and magnitude bits fused into one <=31-bit emission),
   63 AC (fused the same way; length 0 where the coefficient is zero),
   3 ZRL (a block has at most floor(63/16)=3 zero-runs >=16), 1 EOB.
   Offsets come from an exclusive prefix sum of per-position bit costs.
2. OFFSETS — per-block bit lengths -> exclusive scan -> global bit offsets
   (the associative-scan form of the BitWriter's running bit position).
3. SCATTER — each emission contributes to at most two 32-bit words of the
   output stream (big-endian bit order). Bit ranges are disjoint by
   construction, so scatter-ADD is scatter-OR with no carries, and XLA is
   free to parallelize it.

The host tail then only byte-stuffs ~0.4 MB of finished stream instead of
re-encoding 25 MB of coefficients: phase-2 output is ~64x smaller than the
coefficient download the C packer needs.

Table lookups assume every symbol present in the data has a codeword —
guaranteed when the tables were built from this image's own histograms
(encoder.py always does). The C/Python packers remain as validating
fallbacks that raise on missing symbols.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..entropy.categorize import magnitude_category
from ..utils.capability import mode_keyed_cache

# Static per-block worst case: DC 31 bits, 63 AC emissions of <=31 bits,
# 3 ZRL of <=16 bits, EOB <=16 bits -> round up to 64 words.
MAX_BLOCK_BITS = 2048
_U32 = jnp.uint32


def _pattern(v: jnp.ndarray, cat: jnp.ndarray) -> jnp.ndarray:
    """JPEG magnitude bits: v for positives, one's complement for negatives
    (reference: src/...transformer/categorize.rs:45-74)."""
    return jnp.where(v >= 0, v, v + (1 << cat) - 1).astype(_U32)


def _exclusive_cumsum(x: jnp.ndarray, axis: int) -> jnp.ndarray:
    inc = jnp.cumsum(x, axis=axis)
    return inc - x


def combine_tables(codes: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """(codeword << 8 | length) combined lookup entries (uint32)."""
    return (np.asarray(codes, np.uint32) << 8) | np.asarray(lens, np.uint32)


def block_emissions(
    zz: jnp.ndarray,
    table_idx: jnp.ndarray,
    dc_comb: jnp.ndarray,
    ac_comb: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Per-block emission triples for scan-order blocks.

    zz: int [N, 64] zigzag coefficients (DC already DPCM).
    table_idx: int32 [N] selects the code-table set per block (0=luma,
        1=chroma for a single image; image*2 + chroma for batched packing).
    dc_comb / ac_comb: stacked combined tables, uint32 [T*16] / [T*256] of
        (code << 8 | len) entries (see combine_tables) — ONE gather per
        coefficient for code and length together.

    Returns (values u32 [N, 68], lens i32 [N, 68], rel_offs i32 [N, 68],
    block_bits i32 [N]).
    """
    v = zz.astype(jnp.int32)
    n = v.shape[0]
    cat = magnitude_category(v)  # [N, 64]
    chroma_off = table_idx

    # --- DC ------------------------------------------------------------
    dccat = cat[:, 0]
    dc_cl = dc_comb[table_idx * 16 + dccat]
    dccode = dc_cl >> 8
    dclen = (dc_cl & 0xFF).astype(jnp.int32)
    e_dc_val = (dccode << dccat) | _pattern(v[:, 0], dccat)
    e_dc_len = dclen + dccat

    # --- AC structure (categorize.rs:132-151 as scans) ------------------
    ac = v[:, 1:]
    accat = cat[:, 1:]
    pos = jnp.arange(1, 64, dtype=jnp.int32)[None, :]
    nz = ac != 0
    nzpos = jnp.where(nz, pos, 0)
    shifted = jnp.concatenate([jnp.zeros((n, 1), jnp.int32), nzpos[:, :-1]], axis=1)
    prev_nz = jax.lax.associative_scan(jnp.maximum, shifted, axis=1)
    run = pos - prev_nz - 1
    zrl = jnp.where(nz, run >> 4, 0)  # ZRLs immediately before this nonzero
    sym = ((run & 15) << 4) | accat

    ac_cl = ac_comb[(table_idx[:, None] * 256) + sym]
    accode = ac_cl >> 8
    aclen = (ac_cl & 0xFF).astype(jnp.int32)
    e_ac_val = jnp.where(nz, (accode << accat) | _pattern(ac, accat), 0)
    e_ac_len = jnp.where(nz, aclen + accat, 0)

    # --- ZRL / EOB per-block constants ----------------------------------
    zrl_cl = ac_comb[(chroma_off * 256) + 0xF0]
    zrl_code = zrl_cl >> 8
    zrl_len = (zrl_cl & 0xFF).astype(jnp.int32)
    eob_cl = ac_comb[chroma_off * 256]
    eob_code = eob_cl >> 8
    eob_len_t = (eob_cl & 0xFF).astype(jnp.int32)
    has_eob = jnp.max(nzpos, axis=1) < 63
    e_eob_len = jnp.where(has_eob, eob_len_t, 0)

    # --- offsets within the block ---------------------------------------
    pre = zrl * zrl_len[:, None]  # ZRL bits before each position
    seg = pre + e_ac_len
    start = e_dc_len[:, None] + _exclusive_cumsum(seg, axis=1)
    e_ac_off = start + pre
    ac_total = jnp.sum(seg, axis=1)
    e_eob_off = e_dc_len + ac_total
    block_bits = e_dc_len + ac_total + e_eob_len

    # --- the <=3 ZRL slots ----------------------------------------------
    cz = jnp.cumsum(zrl, axis=1)  # inclusive count of ZRLs up to position
    cz_excl = cz - zrl
    total_z = cz[:, -1]
    zrl_vals, zrl_lens, zrl_offs = [], [], []
    for i in range(3):
        active = total_z > i
        ki = jnp.argmax(cz > i, axis=1)  # first position whose count exceeds i
        start_ki = jnp.take_along_axis(start, ki[:, None], axis=1)[:, 0]
        excl_ki = jnp.take_along_axis(cz_excl, ki[:, None], axis=1)[:, 0]
        zrl_offs.append(start_ki + (i - excl_ki) * zrl_len)
        zrl_lens.append(jnp.where(active, zrl_len, 0))
        zrl_vals.append(zrl_code)

    values = jnp.concatenate(
        [e_dc_val[:, None], e_ac_val]
        + [val[:, None] for val in zrl_vals]
        + [eob_code[:, None]],
        axis=1,
    )
    lens = jnp.concatenate(
        [e_dc_len[:, None], e_ac_len]
        + [ln[:, None] for ln in zrl_lens]
        + [e_eob_len[:, None]],
        axis=1,
    )
    offs = jnp.concatenate(
        [jnp.zeros((n, 1), jnp.int32), e_ac_off]
        + [off[:, None] for off in zrl_offs]
        + [e_eob_off[:, None]],
        axis=1,
    )
    return values, lens, offs, block_bits


def byteswap_words(words: jnp.ndarray) -> jnp.ndarray:
    """Logical big-endian words -> memory-order bytes (done on device so the
    host reads the stream through a zero-copy uint8 view)."""
    w = words.astype(jnp.uint32)
    return (
        ((w & 0xFF) << 24)
        | ((w & 0xFF00) << 8)
        | ((w >> 8) & 0xFF00)
        | (w >> 24)
    ).astype(jnp.uint32)


def scatter_words(
    goff: jnp.ndarray, val: jnp.ndarray, ln: jnp.ndarray, n_words: int
) -> jnp.ndarray:
    """Scatter emissions at global bit offsets into a big-endian u32 word
    stream. Each emission occupies bits [goff, goff + ln) and touches at
    most two words; bit ranges are disjoint, so scatter-ADD is scatter-OR
    with no carries. Zero-length emissions contribute nothing."""
    w0 = goff >> 5
    b0 = goff & 31
    end = b0 + ln
    # Emission occupies bits [b0, end) of (w0, w0+1) in MSB-first order.
    spill = jnp.maximum(end - 32, 0)
    c0 = jnp.where(ln > 0, (val >> spill) << jnp.maximum(32 - end, 0), 0).astype(_U32)
    c1 = jnp.where(spill > 0, val << (32 - spill), 0).astype(_U32)

    words = jnp.zeros((n_words,), _U32)
    words = words.at[w0].add(c0, mode="drop")
    words = words.at[w0 + 1].add(c1, mode="drop")
    return words


def pack_to_words(
    values: jnp.ndarray,
    lens: jnp.ndarray,
    offs: jnp.ndarray,
    block_bits: jnp.ndarray,
    n_words: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Scatter emissions into a big-endian u32 word stream.

    Returns (words u32 [n_words], total_bits i32 scalar)."""
    block_off = _exclusive_cumsum(block_bits, axis=0)
    total_bits = block_off[-1] + block_bits[-1]
    goff = (block_off[:, None] + offs).reshape(-1)
    words = scatter_words(goff, values.reshape(-1), lens.reshape(-1), n_words)
    return words, total_bits


def scan_words_capacity(n_blocks: int) -> int:
    """Worst-case output words for n_blocks scan blocks (static shape)."""
    return n_blocks * (MAX_BLOCK_BITS // 32) + 2


def scan_table_index(n_blocks: int, stride: int, luma_per_mcu: int) -> np.ndarray:
    """int32 [n_blocks] code-table set per interleaved scan block: 0 for
    the luma_per_mcu luma blocks of each stride-block MCU, 1 for Cb/Cr."""
    return ((np.arange(n_blocks) % stride) >= luma_per_mcu).astype(np.int32)


def device_comb_tables(t_ldc: dict, t_lac: dict, t_cdc: dict, t_cac: dict):
    """Device-built code tables (huffman.device_tables) -> the combined
    (code << 8 | len) lookups block_emissions takes: (dc u32 [32],
    ac u32 [512]), luma first."""

    def comb(t, n):
        return ((t["codes_flat"][:n] << 8) | t["lens_flat"][:n]).astype(_U32)

    return (
        jnp.concatenate([comb(t_ldc, 16), comb(t_cdc, 16)]),
        jnp.concatenate([comb(t_lac, 256), comb(t_cac, 256)]),
    )


def pack_scan_words(
    scan_blocks: jnp.ndarray,
    stride: int,
    luma_per_mcu: int,
    dc_comb: jnp.ndarray,
    ac_comb: jnp.ndarray,
    n_words: int,
    valid: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """The device scan packer: interleaved scan-order blocks [N, 64] (DC
    already DPCM) -> (u32 words [n_words] in memory byte order, total bits
    i32). Per-block emissions, an exclusive scan of block bit counts, and
    a disjoint scatter-add into words (module docstring).

    valid: optional bool/int [N] mask — masked blocks emit no bits (the
    sharded path's alignment-padding MCUs)."""
    n = int(scan_blocks.shape[0])
    table_idx = jnp.asarray(scan_table_index(n, stride, luma_per_mcu))
    values, lens, offs, block_bits = block_emissions(
        scan_blocks, table_idx, dc_comb, ac_comb
    )
    if valid is not None:
        keep = valid.astype(bool)
        lens = jnp.where(keep[:, None], lens, 0)
        block_bits = jnp.where(keep, block_bits, 0)
    words, total_bits = pack_to_words(values, lens, offs, block_bits, n_words)
    return byteswap_words(words), total_bits


def finalize_scan_bytes(words: np.ndarray, total_bits: int) -> bytes:
    """Host tail: trim, 1-pad the final byte, byte-stuff 0xFF -> 0xFF 0x00.

    `words` must already be in memory byte order (byteswap_words ran on
    device), so this is a zero-copy uint8 view plus the stuffing pass."""
    n_bytes = (int(total_bits) + 7) // 8
    raw = np.ascontiguousarray(words).view(np.uint8)[:n_bytes].copy()
    pad = n_bytes * 8 - int(total_bits)
    if pad:
        raw[-1] |= (1 << pad) - 1  # JPEG 1-padding (encoder.rs:267)
    ff = np.flatnonzero(raw == 0xFF)
    if len(ff):
        raw = np.insert(raw, ff + 1, 0)
    return raw.tobytes()


def exact_scan_bits(
    hists: tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray],
    ldc: tuple,
    lac: tuple,
    cdc: tuple | None,
    cac: tuple | None,
) -> int:
    """EXACT total scan bit count from symbol histograms + code lengths —
    no device sync needed. Every emitted DC/AC symbol contributes its
    codeword length plus its magnitude-category extra bits (the category is
    the symbol's low nibble for AC, the symbol itself for DC)."""
    ldc_h, lac_h, cdc_h, cac_h = (np.asarray(h, dtype=np.int64) for h in hists)
    cats16 = np.arange(16, dtype=np.int64)
    extra256 = np.arange(256, dtype=np.int64) & 15
    total = int((ldc_h * (np.asarray(ldc[1], np.int64)[:16] + cats16)).sum())
    total += int((lac_h * (np.asarray(lac[1], np.int64) + extra256)).sum())
    if cdc is not None:
        total += int((cdc_h * (np.asarray(cdc[1], np.int64)[:16] + cats16)).sum())
    if cac is not None:
        total += int((cac_h * (np.asarray(cac[1], np.int64) + extra256)).sum())
    return total


def device_pack_scan(
    luma: jnp.ndarray,
    cb: jnp.ndarray | None,
    cr: jnp.ndarray | None,
    luma_per_mcu: int,
    ldc: tuple[np.ndarray, np.ndarray],
    lac: tuple[np.ndarray, np.ndarray],
    cdc: tuple[np.ndarray, np.ndarray] | None,
    cac: tuple[np.ndarray, np.ndarray] | None,
    known_bits: int | None = None,
) -> bytes:
    """Two-dispatch device packing with host-built tables; blocks may be
    device-resident arrays.

    When `known_bits` (from exact_scan_bits) is given, the stream length is
    trusted and only ONE device->host fetch happens (the word slice)."""
    n_luma = int(luma.shape[0])
    n_chroma = int(cb.shape[0]) if cb is not None else 0
    if known_bits is not None:
        # Exact size known up front: use a power-of-two bucketed capacity so
        # the output buffer is right-sized (the worst-case bound is 64x the
        # typical stream) while jit executables still get reused.
        needed_words = (known_bits + 31) // 32 + 2
    else:
        needed_words = scan_words_capacity(n_luma + 2 * n_chroma)
    n_words = 1 << max(12, int(needed_words).bit_length())

    fn = _compiled_pack(n_luma, n_chroma, luma_per_mcu, n_words)
    zeros16 = np.zeros(16, np.uint32)
    zeros256 = np.zeros(256, np.uint32)
    # Reference DHT tables use 16-entry DC arrays; flat_code_arrays gives
    # 256 — slice down so the combined DC table is [2*16].
    dc_comb = np.concatenate(
        [
            combine_tables(np.asarray(ldc[0])[:16], np.asarray(ldc[1])[:16]),
            combine_tables(np.asarray(cdc[0])[:16], np.asarray(cdc[1])[:16])
            if cdc is not None
            else zeros16,
        ]
    )
    ac_comb = np.concatenate(
        [
            combine_tables(np.asarray(lac[0]), np.asarray(lac[1])),
            combine_tables(np.asarray(cac[0]), np.asarray(cac[1]))
            if cac is not None
            else zeros256,
        ]
    )
    args = [luma]
    if n_chroma:
        args += [cb, cr]
    words, total_bits = fn(*args, jnp.asarray(dc_comb), jnp.asarray(ac_comb))
    if known_bits is not None and _check_bits_enabled():
        # Debug cross-check (DMMT_CHECK_BITS=1, on in tests): the
        # host-predicted stream length (exact_scan_bits from histograms x
        # code lengths) must equal what the device actually packed —
        # otherwise trusting known_bits would silently truncate/pad the
        # scan. Zero cost in production mode (no extra fetch).
        device_bits = int(jax.device_get(total_bits))
        if device_bits != int(known_bits):
            raise AssertionError(
                f"device packed {device_bits} scan bits but host predicted "
                f"{known_bits}; histogram/emission mismatch"
            )
    nbits = int(known_bits) if known_bits is not None else int(jax.device_get(total_bits))
    needed = (nbits + 31) // 32
    host_words = jax.device_get(words[:needed])
    return finalize_scan_bytes(host_words, nbits)


def _check_bits_enabled() -> bool:
    import os

    return bool(os.environ.get("DMMT_CHECK_BITS"))


def _interleave_scan(luma, cb, cr, n_mcu: int, luma_per_mcu: int):
    """Scan-order interleave (Y..Y Cb Cr per MCU) as concat+reshape — one
    copy, no gather."""
    return jnp.concatenate(
        [
            luma.reshape(n_mcu, luma_per_mcu, 64),
            cb[:, None, :],
            cr[:, None, :],
        ],
        axis=1,
    ).reshape(-1, 64)


@mode_keyed_cache(maxsize=32)
def _compiled_pack(n_luma: int, n_chroma: int, luma_per_mcu: int, n_words: int):
    def fn(*args):
        if n_chroma:
            dc_comb, ac_comb = args[3], args[4]
            scan_blocks = _interleave_scan(
                args[0], args[1], args[2], n_chroma, luma_per_mcu
            )
            return pack_scan_words(
                scan_blocks, luma_per_mcu + 2, luma_per_mcu,
                dc_comb, ac_comb, n_words,
            )
        # luma-only scan: every block uses table set 0
        return pack_scan_words(args[0], 1, 1, args[1], args[2], n_words)

    return jax.jit(fn)


# --- Batched multi-image packing ---------------------------------------------


def device_pack_scan_batch(
    luma: jnp.ndarray,
    cb: jnp.ndarray,
    cr: jnp.ndarray,
    luma_per_mcu: int,
    tables: list[tuple],
    bits_per_image: list[int],
    words_cap: int,
) -> list[bytes]:
    """Pack B images' scans in ONE device dispatch.

    luma/cb/cr: [B, N, 64] device arrays (phase-1 batched outputs).
    tables: per image (ldc, lac, cdc, cac) flat code arrays.
    bits_per_image: EXACT per-image stream bits (exact_scan_bits) — places
    each image's stream at a word-aligned offset so one contiguous slice
    fetch returns all streams.
    """
    b = int(luma.shape[0])
    n_luma = int(luma.shape[1])
    n_chroma = int(cb.shape[1])

    dc_parts, ac_parts = [], []
    for ldc, lac, cdc, cac in tables:
        dc_parts.append(combine_tables(np.asarray(ldc[0])[:16], np.asarray(ldc[1])[:16]))
        dc_parts.append(combine_tables(np.asarray(cdc[0])[:16], np.asarray(cdc[1])[:16]))
        ac_parts.append(combine_tables(np.asarray(lac[0]), np.asarray(lac[1])))
        ac_parts.append(combine_tables(np.asarray(cac[0]), np.asarray(cac[1])))
    dc_comb = np.concatenate(dc_parts)  # [B*2*16]
    ac_comb = np.concatenate(ac_parts)  # [B*2*256]

    word_off = np.zeros(b, dtype=np.int32)
    acc = 0
    for i, bits in enumerate(bits_per_image):
        word_off[i] = acc
        acc += (bits + 31) // 32
    total_words = acc

    fn = _compiled_pack_batch(b, n_luma, n_chroma, luma_per_mcu, words_cap)
    words = fn(
        luma, cb, cr,
        jnp.asarray(dc_comb), jnp.asarray(ac_comb), jnp.asarray(word_off),
    )
    host_words = jax.device_get(words[:total_words])
    out = []
    for i, bits in enumerate(bits_per_image):
        seg = host_words[word_off[i] : word_off[i] + (bits + 31) // 32]
        out.append(finalize_scan_bytes(seg, bits))
    return out


@mode_keyed_cache(maxsize=16)
def _compiled_pack_batch(
    b: int, n_luma: int, n_chroma: int, luma_per_mcu: int, words_cap: int
):
    ns = n_luma + 2 * n_chroma
    chroma_idx = scan_table_index(ns, luma_per_mcu + 2, luma_per_mcu)

    def fn(luma, cb, cr, dc_comb, ac_comb, word_off):
        scan = jnp.concatenate(
            [
                luma.reshape(b, n_chroma, luma_per_mcu, 64),
                cb[:, :, None, :],
                cr[:, :, None, :],
            ],
            axis=2,
        ).reshape(b * ns, 64)
        tbl = (
            jnp.arange(b, dtype=jnp.int32)[:, None] * 2 + jnp.asarray(chroma_idx)[None, :]
        ).reshape(-1)
        values, lens, offs, block_bits = block_emissions(
            scan, tbl, dc_comb, ac_comb
        )
        bb = block_bits.reshape(b, ns)
        in_img = jnp.cumsum(bb, axis=1) - bb  # exclusive, per image
        goff_blocks = word_off[:, None] * 32 + in_img  # [B, NS] global bits
        goff = (goff_blocks.reshape(-1)[:, None] + offs).reshape(-1)
        words = scatter_words(
            goff, values.reshape(-1), lens.reshape(-1), words_cap
        )
        return byteswap_words(words)

    return jax.jit(fn)

/* Native scan encoder: entropy-coded JPEG scan emission with byte stuffing.
 *
 * The device pipeline delivers per-block int16 coefficients in zigzag
 * order with the DC coefficient already DPCM-delta-coded in MCU (entangled)
 * order. This module performs the only inherently serial stage — Huffman
 * codeword emission into a single bitstream — as a tight C loop, the
 * host-native counterpart of the reference's BitWriter/HuffmanWriter path
 * (reference behavior: src/image/writer/jpeg/encoder.rs:264-404,
 * src/binary_stream.rs:38-66, src/image/writer/jpeg/segment_marker_injector.rs).
 *
 * MCU interleave (reference: src/image/writer/jpeg/encoder/block_fold_iterator.rs):
 *   P444: Y Cb Cr | P422: Y Y Cb Cr | P420: Y Y Y Y Cb Cr
 * is realized by consuming luma_per_mcu luma blocks then one Cb and one Cr
 * block per MCU.
 */

#include <stdint.h>
#include <stddef.h>

typedef struct {
    uint8_t *out;
    size_t cap;
    size_t len;
    uint64_t acc;   /* bit accumulator, bits enter at the low end */
    int nbits;      /* bits currently held in acc */
    int overflow;
} BitSink;

static inline void sink_put_byte(BitSink *s, uint8_t b) {
    if (s->len >= s->cap) { s->overflow = 1; return; }
    s->out[s->len++] = b;
    if (b == 0xFF) { /* byte stuffing: 0x00 after every 0xFF */
        if (s->len >= s->cap) { s->overflow = 1; return; }
        s->out[s->len++] = 0x00;
    }
}

static inline void sink_write(BitSink *s, uint32_t value, int count) {
    s->acc = (s->acc << count) | (uint64_t)(value & ((1u << count) - 1u));
    s->nbits += count;
    while (s->nbits >= 8) {
        s->nbits -= 8;
        sink_put_byte(s, (uint8_t)((s->acc >> s->nbits) & 0xFFu));
    }
}

static inline void sink_flush_ones(BitSink *s) {
    if (s->nbits > 0) {
        int pad = 8 - s->nbits;
        uint32_t fill = (1u << pad) - 1u;
        sink_write(s, fill, pad); /* completes the byte exactly */
    }
}

/* One's-complement magnitude pattern for negatives (right-aligned). */
static inline uint32_t pattern_of(int32_t v, int cat) {
    if (v >= 0) return (uint32_t)v;
    return ((1u << cat) - 1u) - (uint32_t)(-v);
}

static inline int encode_block(BitSink *s,
                               const int16_t *block,
                               const uint16_t *dc_codes, const uint8_t *dc_lens,
                               const uint16_t *ac_codes, const uint8_t *ac_lens) {
    /* DC: block[0] is already the DPCM delta */
    int32_t dc = block[0];
    int cat = dc == 0 ? 0 : (32 - __builtin_clz((uint32_t)(dc < 0 ? -dc : dc)));
    if (cat > 15) return -2;
    if (dc_lens[cat] == 0) return -3;
    sink_write(s, dc_codes[cat], dc_lens[cat]);
    if (cat) sink_write(s, pattern_of(dc, cat), cat);

    /* AC run-length loop (semantics of src/...transformer/categorize.rs:132-151) */
    int run = 0;
    for (int k = 1; k < 64; ++k) {
        int32_t a = block[k];
        if (a == 0) { run++; continue; }
        while (run > 15) {
            if (ac_lens[0xF0] == 0) return -3;
            sink_write(s, ac_codes[0xF0], ac_lens[0xF0]); /* ZRL */
            run -= 16;
        }
        int acat = 32 - __builtin_clz((uint32_t)(a < 0 ? -a : a));
        if (acat > 15) return -2;
        int sym = (run << 4) | acat;
        if (ac_lens[sym] == 0) return -3;
        sink_write(s, ac_codes[sym], ac_lens[sym]);
        sink_write(s, pattern_of(a, acat), acat);
        run = 0;
    }
    if (run != 0) { /* trailing zeros -> EOB */
        if (ac_lens[0x00] == 0) return -3;
        sink_write(s, ac_codes[0x00], ac_lens[0x00]);
    }
    return 0;
}

/* Returns the number of output bytes, or a negative error:
 *   -1 output buffer too small, -2 category overflow, -3 missing codeword. */
long dmmt_encode_scan(const int16_t *luma, long n_luma,
                      const int16_t *cb, const int16_t *cr, long n_chroma,
                      int luma_per_mcu,
                      const uint16_t *ldc_codes, const uint8_t *ldc_lens,
                      const uint16_t *lac_codes, const uint8_t *lac_lens,
                      const uint16_t *cdc_codes, const uint8_t *cdc_lens,
                      const uint16_t *cac_codes, const uint8_t *cac_lens,
                      uint8_t *out, long out_cap) {
    BitSink s = { out, (size_t)out_cap, 0, 0, 0, 0 };
    long n_mcu = n_chroma > 0 ? n_chroma : (n_luma / (luma_per_mcu ? luma_per_mcu : 1));
    long li = 0;
    for (long m = 0; m < n_mcu; ++m) {
        for (int j = 0; j < luma_per_mcu; ++j, ++li) {
            if (li >= n_luma) return -4;
            int rc = encode_block(&s, luma + 64 * li,
                                  ldc_codes, ldc_lens, lac_codes, lac_lens);
            if (rc) return rc;
        }
        if (n_chroma > 0) {
            int rc = encode_block(&s, cb + 64 * m,
                                  cdc_codes, cdc_lens, cac_codes, cac_lens);
            if (rc) return rc;
            rc = encode_block(&s, cr + 64 * m,
                              cdc_codes, cdc_lens, cac_codes, cac_lens);
            if (rc) return rc;
        }
        if (s.overflow) return -1;
    }
    sink_flush_ones(&s);
    if (s.overflow) return -1;
    return (long)s.len;
}

/* Per-shard variant without final flush is not needed: multi-shard encode
 * packs each shard's segment separately at byte granularity only when the
 * shard boundary is byte-aligned; the general bit-offset merge is done on
 * host in numpy (parallel/sharding.py). Kept single-stream here. */

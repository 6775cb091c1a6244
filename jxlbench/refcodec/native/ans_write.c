/* Native hot loop: reverse-order rANS token emission.
 *
 * Mirrors WriteTokens (lib/jxl/enc_ans.cc:1728-1813): iterate tokens in
 * reverse, maintain the 32-bit rANS state, record (nbits, bits) items on a
 * stack (16-bit renormalization flushes + hybrid-uint extra bits), then
 * emit the stack in reverse as an LSB-first bit stream.
 *
 * The Python side pre-splits every token into (histogram index, alphabet
 * token, extra-bit count, extra bits) — LZ77 length tokens included — so
 * this loop is branch-light and identical for all stream types.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define ANS_LOG 12

/* Hybrid-uint split of one token stream + histogram accumulation.
 *
 * Covers the vectorized encode_array + bincount pair on the Python side
 * (hybrid_uint.py encode_array, enc_ans.h TokenizeWithConfig role) in a
 * single pass: every value is split into (alphabet token, extra-bit
 * count, extra bits) per the (split_exponent, msb, lsb) config, and the
 * per-(context, token) counts accumulate into `counts` (num_ctx rows of
 * `max_tok` columns). Returns 0, or -1 when a token does not fit the
 * `max_tok` alphabet / a value needs more than 32 extra bits (caller
 * falls back to the Python path). */
int hybrid_tokenize(const int32_t* ctx, const void* val, size_t n,
                    int split_exponent, int msb, int lsb,
                    uint16_t* tok_out, uint8_t* nbits_out,
                    uint32_t* bits_out, uint32_t* counts, int max_tok,
                    int val_is_u32, int n_ctx) {
  uint64_t split_token = (uint64_t)1 << split_exponent;
  const int64_t* v64 = (const int64_t*)val;
  const uint32_t* v32 = (const uint32_t*)val;
  for (size_t i = 0; i < n; i++) {
    uint64_t v = val_is_u32 ? (uint64_t)v32[i] : (uint64_t)v64[i];
    uint32_t t;
    unsigned nb;
    uint32_t b;
    if (v < split_token) {
      t = (uint32_t)v;
      nb = 0;
      b = 0;
    } else {
      unsigned lg = 63 - (unsigned)__builtin_clzll(v);
      uint64_t m = v - ((uint64_t)1 << lg);
      nb = lg - msb - lsb;
      /* > 31 extra bits cannot ride the 32-bit bits lane and the
       * decoders' vbr_read; fall back so the caller errors loudly */
      if (nb > 31) return -1;
      t = (uint32_t)(split_token +
                     (((uint64_t)(lg - split_exponent)) << (msb + lsb)) +
                     ((m >> (lg - msb)) << lsb) +
                     (m & (((uint64_t)1 << lsb) - 1)));
      b = (uint32_t)((v >> lsb) & ((((uint64_t)1 << nb) - 1)));
    }
    if (t >= (uint32_t)max_tok) return -1;
    if ((uint32_t)ctx[i] >= (uint32_t)n_ctx) return -1;
    tok_out[i] = (uint16_t)t;
    nbits_out[i] = (uint8_t)nb;
    bits_out[i] = b;
  }
  /* second pass so a mid-stream alphabet overflow above leaves `counts`
   * untouched (the caller then reruns the whole stream in Python) */
  for (size_t i = 0; i < n; i++) {
    counts[(size_t)ctx[i] * max_tok + tok_out[i]]++;
  }
  return 0;
}

int ans_write_tokens(const uint16_t* histo, const uint16_t* tok,
                     const uint8_t* nbits, const uint32_t* bits, size_t n,
                     const uint16_t* freqs,  /* nhisto * alpha_max */
                     const uint32_t* offs,   /* nhisto * alpha_max */
                     const uint16_t* rev,    /* nhisto * 4096 */
                     int alpha_max, uint32_t init_state,
                     uint8_t* out_buf, size_t out_cap,
                     uint64_t* out_bits_total, uint32_t* out_state) {
  size_t cap = 2 * n + 2;
  uint8_t* s_nbits = (uint8_t*)malloc(cap);
  uint64_t* s_bits = (uint64_t*)malloc(cap * sizeof(uint64_t));
  if (!s_nbits || !s_bits) {
    free(s_nbits);
    free(s_bits);
    return -2;
  }
  size_t sp = 0;
  uint32_t state = init_state;
  for (size_t ii = n; ii-- > 0;) {
    uint32_t h = histo[ii];
    uint32_t t = tok[ii];
    uint32_t f = freqs[h * (size_t)alpha_max + t];
    if (f == 0) {
      free(s_nbits);
      free(s_bits);
      return -1; /* token with zero frequency */
    }
    if (nbits[ii]) {
      s_nbits[sp] = nbits[ii];
      s_bits[sp++] = bits[ii];
    }
    if ((state >> (32 - ANS_LOG)) >= f) {
      s_nbits[sp] = 16;
      s_bits[sp++] = state & 0xFFFF;
      state >>= 16;
    }
    uint32_t residue =
        rev[h * 4096u + offs[h * (size_t)alpha_max + t] + state % f];
    state = (state / f) << ANS_LOG | residue;
  }
  /* emit stack in reverse, LSB-first */
  uint64_t acc = 0;
  unsigned accn = 0;
  size_t op = 0;
  uint64_t total = 0;
  for (size_t ii = sp; ii-- > 0;) {
    acc |= s_bits[ii] << accn;
    accn += s_nbits[ii];
    total += s_nbits[ii];
    while (accn >= 8) {
      if (op >= out_cap) {
        free(s_nbits);
        free(s_bits);
        return -3;
      }
      out_buf[op++] = (uint8_t)(acc & 0xFF);
      acc >>= 8;
      accn -= 8;
    }
  }
  if (accn) {
    if (op >= out_cap) {
      free(s_nbits);
      free(s_bits);
      return -3;
    }
    out_buf[op++] = (uint8_t)(acc & 0xFF);
  }
  *out_bits_total = total;
  *out_state = state;
  free(s_nbits);
  free(s_bits);
  return 0;
}

/* hybrid_tokenize over a mixed literal/LZ77-length stream: positions
 * flagged in `lz` split with the LENGTH config (l*) and get min_symbol
 * added to the token (enc_ans.cc TokenCost lz77 lane). Two-pass like
 * hybrid_tokenize so a failure leaves `counts` untouched. */
int hybrid_tokenize_mixed(const int32_t* ctx, const int64_t* val,
                          const uint8_t* lz, size_t n, int split_exponent,
                          int msb, int lsb, int lsplit, int lmsb, int llsb,
                          int min_symbol, uint16_t* tok_out,
                          uint8_t* nbits_out, uint32_t* bits_out,
                          uint32_t* counts, int max_tok, int n_ctx) {
  for (size_t i = 0; i < n; i++) {
    uint64_t v = (uint64_t)val[i];
    int is_lz = lz[i] != 0;
    int se = is_lz ? lsplit : split_exponent;
    int mb = is_lz ? lmsb : msb;
    int lb = is_lz ? llsb : lsb;
    uint64_t split_token = (uint64_t)1 << se;
    uint32_t t;
    unsigned nb;
    uint32_t b;
    if (v < split_token) {
      t = (uint32_t)v;
      nb = 0;
      b = 0;
    } else {
      unsigned lg = 63 - (unsigned)__builtin_clzll(v);
      uint64_t m = v - ((uint64_t)1 << lg);
      nb = lg - mb - lb;
      if (nb > 31) return -1;
      t = (uint32_t)(split_token + (((uint64_t)(lg - se)) << (mb + lb)) +
                     ((m >> (lg - mb)) << lb) +
                     (m & (((uint64_t)1 << lb) - 1)));
      b = (uint32_t)((v >> lb) & ((((uint64_t)1 << nb) - 1)));
    }
    if (is_lz) t += (uint32_t)min_symbol;
    if (t >= (uint32_t)max_tok) return -1;
    if ((uint32_t)ctx[i] >= (uint32_t)n_ctx) return -1;
    tok_out[i] = (uint16_t)t;
    nbits_out[i] = (uint8_t)nb;
    bits_out[i] = b;
  }
  for (size_t i = 0; i < n; i++) {
    counts[(size_t)ctx[i] * max_tok + tok_out[i]]++;
  }
  return 0;
}

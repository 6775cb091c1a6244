/* Baseline JPEG entropy-coded scan decoder.
 *
 * The hot loop of jpeg/data.py's _decode_scan for sequential scans:
 * MSB-first bit reading with 0xFF00 unstuffing, canonical Huffman
 * decode, DC prediction, run-length AC placement into zigzag-order
 * int16 blocks.  Captures restart/final padding bits and trailing
 * zero-run counts verbatim so the bit-exact JPEG rewrite keeps
 * working.  Byte-level semantics match the Python reader exactly
 * (reads past an interrupting marker yield zero bits).
 *
 * Plain C interface for ctypes; built into _jxl_native.so.
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

typedef struct {
  const uint8_t *data;
  int64_t size, pos;
  uint32_t bitbuf;
  int nbits;
  int at_marker;
} JDBitReader;

static int jdr_next_byte(JDBitReader *br) {
  if (br->pos >= br->size) { br->at_marker = 1; return -1; }
  uint8_t b = br->data[br->pos];
  if (b == 0xFF) {
    if (br->pos + 1 >= br->size) { br->at_marker = 1; return -1; }
    uint8_t nxt = br->data[br->pos + 1];
    if (nxt == 0x00) { br->pos += 2; return 0xFF; }
    br->at_marker = 1;
    return -1;
  }
  br->pos += 1;
  return b;
}

static inline int jdr_read_bit(JDBitReader *br) {
  if (br->nbits == 0) {
    int b = jdr_next_byte(br);
    if (b < 0) return 0; /* past-marker padding: zero bits */
    br->bitbuf = (uint32_t)b;
    br->nbits = 8;
  }
  br->nbits--;
  return (br->bitbuf >> br->nbits) & 1;
}

static inline uint32_t jdr_read_bits(JDBitReader *br, int n) {
  uint32_t v = 0;
  for (int i = 0; i < n; ++i) v = (v << 1) | (uint32_t)jdr_read_bit(br);
  return v;
}

/* Canonical decode tables built from DHT counts/values. */
typedef struct {
  int32_t maxcode[18]; /* per length; -1 = none */
  int32_t delta[17];   /* valptr - mincode */
  uint8_t values[256];
  int valid;
} JDHuff;

static void jdh_build(JDHuff *h, const uint8_t *counts,
                      const uint8_t *values, int nvals) {
  memset(h, 0, sizeof(*h));
  memcpy(h->values, values, (size_t)nvals);
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    int n = counts[len - 1];
    if (n == 0) {
      h->maxcode[len] = -1;
    } else {
      h->delta[len] = k - code;
      code += n;
      k += n;
      h->maxcode[len] = code - 1;
    }
    code <<= 1;
  }
  h->maxcode[17] = 0x7FFFFFFF;
  h->valid = 1;
}

static int jdh_decode(JDBitReader *br, const JDHuff *h) {
  int code = 0;
  for (int len = 1; len <= 16; ++len) {
    code = (code << 1) | jdr_read_bit(br);
    if (h->maxcode[len] >= 0 && code <= h->maxcode[len])
      return h->values[code + h->delta[len]];
  }
  return -1;
}

static inline int32_t jext(uint32_t v, int n) {
  if (n == 0) return 0;
  return (int32_t)v >= (1 << (n - 1)) ? (int32_t)v
                                      : (int32_t)v - (1 << n) + 1;
}

/* Returns the byte position after the scan body (positioned at the
 * next marker), or:
 *   -1 malformed stream (bad code / overflow / AC overrun)
 *   -3 bookkeeping capacity exceeded (caller falls back to Python)
 *
 * Outputs:
 *   rst_pad_len/bits: per restart, count and value of discarded bits
 *   n_rst: restarts encountered
 *   final_pad_len/bits: padding of the last partial byte
 *   ezr_idx/ezr_n/n_ezr: extra zero-run records (block index, count)
 */
int64_t jpeg_decode_baseline_scan(
    const uint8_t *data, int64_t size, int64_t start,
    int16_t *coeffs, const int64_t *comp_off, const int32_t *nbxs,
    const int32_t *grp_v, const int32_t *grp_h,
    const int32_t *dc_sel, const int32_t *ac_sel,
    int ncomp, int mcux, int mcuy, int restart_interval,
    const uint8_t *tab_counts, const uint8_t *tab_values,
    const int32_t *tab_nvals, int ntab,
    uint8_t *rst_pad_len, uint8_t *rst_pad_bits, int64_t rst_cap,
    int64_t *n_rst, int32_t *final_pad_len, int32_t *final_pad_bits,
    int64_t *ezr_idx, int32_t *ezr_n, int64_t ezr_cap, int64_t *n_ezr) {
  JDHuff tabs[16];
  if (ntab > 16 || ncomp > 8) return -3;
  for (int i = 0; i < ntab; ++i)
    jdh_build(&tabs[i], tab_counts + i * 16, tab_values + i * 256,
              tab_nvals[i]);
  JDBitReader br = {data, size, start, 0, 0, 0};
  int32_t preds[8];
  memset(preds, 0, sizeof(preds));
  *n_rst = 0;
  *n_ezr = 0;
  int64_t mcu_count = 0;
  int64_t block_scan_index = 0;
  for (int my = 0; my < mcuy; ++my) {
    for (int mx = 0; mx < mcux; ++mx) {
      if (restart_interval && mcu_count &&
          mcu_count % restart_interval == 0) {
        if (*n_rst >= rst_cap) return -3;
        rst_pad_len[*n_rst] = (uint8_t)br.nbits;
        rst_pad_bits[*n_rst] =
            (uint8_t)(br.bitbuf & ((1u << br.nbits) - 1u));
        (*n_rst)++;
        br.nbits = 0;
        br.at_marker = 0;
        if (br.pos + 1 < size && data[br.pos] == 0xFF &&
            data[br.pos + 1] >= 0xD0 && data[br.pos + 1] <= 0xD7)
          br.pos += 2;
        memset(preds, 0, sizeof(preds));
      }
      for (int c = 0; c < ncomp; ++c) {
        if (dc_sel[c] < 0 || dc_sel[c] >= ntab || ac_sel[c] < 0 ||
            ac_sel[c] >= ntab)
          return -1;
        const JDHuff *dc = &tabs[dc_sel[c]];
        const JDHuff *ac = &tabs[ac_sel[c]];
        int vs = grp_v[c], hs = grp_h[c];
        int nbx = nbxs[c];
        for (int iy = 0; iy < vs; ++iy) {
          for (int ix = 0; ix < hs; ++ix) {
            int64_t by = (int64_t)my * vs + iy;
            int64_t bx = (int64_t)mx * hs + ix;
            int16_t *block = coeffs + (comp_off[c] + by * nbx + bx) * 64;
            int s = jdh_decode(&br, dc);
            if (s < 0 || s > 15) return -1;
            int32_t diff = jext(jdr_read_bits(&br, s), s);
            preds[c] += diff;
            if (preds[c] < -32768 || preds[c] > 32767) return -1;
            block[0] = (int16_t)preds[c];
            int k = 1;
            int zrl_run = 0;
            while (k <= 63) {
              int rs = jdh_decode(&br, ac);
              if (rs < 0) return -1;
              int r = rs >> 4, sz = rs & 15;
              if (sz > 0) {
                k += r;
                if (k > 63) return -1;
                block[k] = (int16_t)jext(jdr_read_bits(&br, sz), sz);
                zrl_run = 0;
                k++;
              } else if (r == 15) {
                k += 16;
                zrl_run++;
              } else {
                break; /* EOB */
              }
            }
            if (zrl_run > 0) {
              if (*n_ezr >= ezr_cap) return -3;
              ezr_idx[*n_ezr] = block_scan_index;
              ezr_n[*n_ezr] = zrl_run;
              (*n_ezr)++;
            }
            block_scan_index++;
          }
        }
      }
      mcu_count++;
    }
  }
  *final_pad_len = br.nbits;
  *final_pad_bits = (int32_t)(br.bitbuf & ((1u << br.nbits) - 1u));
  br.nbits = 0;
  /* skip to the next marker */
  int64_t p = br.pos;
  while (p + 1 < size &&
         !(data[p] == 0xFF && data[p + 1] != 0x00 &&
           !(data[p + 1] >= 0xD0 && data[p + 1] <= 0xD7)))
    p++;
  return p;
}

/* Baseline JPEG interleaved-scan entropy encoder.
 *
 * The hot loop of jpeg/writer.py's scan emission (and jpegli encode):
 * per MCU, per component block: DC-diff Huffman symbol + magnitude
 * bits, then run-length AC symbols with ZRL/EOB, with 0xFF byte
 * stuffing and restart markers.  Same byte output as the Python loop
 * (conventional 1-padding before RST), roughly 100x faster.
 *
 * Plain C interface for ctypes; built into _jxl_native.so.
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

typedef struct {
  uint8_t *out;
  int64_t pos, cap;
  uint64_t buf;
  int nbits;
} JBitWriter;

static int jbw_put(JBitWriter *bw, uint32_t code, int len) {
  if (len == 0) return 1;
  bw->buf = (bw->buf << len) | (uint64_t)code;
  bw->nbits += len;
  while (bw->nbits >= 8) {
    uint8_t b = (uint8_t)(bw->buf >> (bw->nbits - 8));
    bw->nbits -= 8;
    if (bw->pos + 2 > bw->cap) return 0;
    bw->out[bw->pos++] = b;
    if (b == 0xFF) bw->out[bw->pos++] = 0x00;
  }
  return 1;
}

static int jbw_flush_ones(JBitWriter *bw) {
  if (bw->nbits == 0) return 1;
  int pad = 8 - bw->nbits;
  return jbw_put(bw, (1u << pad) - 1u, pad);
}

static inline int jcsize(int32_t v) {
  uint32_t a = (uint32_t)(v < 0 ? -v : v);
  return a == 0 ? 0 : 32 - __builtin_clz(a);
}

/* Returns bytes written, -1 on buffer overflow, -2 on a symbol with no
 * Huffman code (table/histogram mismatch). */
int64_t jpegli_encode_scan(
    const int32_t *coeffs, const int64_t *comp_off,
    const int32_t *nbxs, const int32_t *v_samp, const int32_t *h_samp,
    const int32_t *dc_sel, const int32_t *ac_sel,
    int ncomp, int mcux, int mcuy, int restart_interval,
    const uint8_t *depths, const uint16_t *codes,
    uint8_t *out, int64_t cap) {
  JBitWriter bw = {out, 0, cap, 0, 0};
  int32_t preds[8];
  if (ncomp > 8) return -2;
  memset(preds, 0, sizeof(preds));
  int64_t mcu_count = 0;
  int next_rst = 0;
  for (int my = 0; my < mcuy; ++my) {
    for (int mx = 0; mx < mcux; ++mx) {
      if (restart_interval && mcu_count &&
          mcu_count % restart_interval == 0) {
        if (!jbw_flush_ones(&bw)) return -1;
        if (bw.pos + 2 > bw.cap) return -1;
        bw.out[bw.pos++] = 0xFF;
        bw.out[bw.pos++] = (uint8_t)(0xD0 + (next_rst & 7));
        next_rst++;
        memset(preds, 0, sizeof(preds));
      }
      for (int c = 0; c < ncomp; ++c) {
        const uint8_t *dc_d = depths + (size_t)dc_sel[c] * 256;
        const uint16_t *dc_c = codes + (size_t)dc_sel[c] * 256;
        const uint8_t *ac_d = depths + (size_t)ac_sel[c] * 256;
        const uint16_t *ac_c = codes + (size_t)ac_sel[c] * 256;
        int vs = v_samp[c], hs = h_samp[c];
        int nbx = nbxs[c];
        for (int iy = 0; iy < vs; ++iy) {
          for (int ix = 0; ix < hs; ++ix) {
            int64_t by = (int64_t)my * vs + iy;
            int64_t bx = (int64_t)mx * hs + ix;
            const int32_t *block =
                coeffs + (comp_off[c] + by * nbx + bx) * 64;
            int32_t diff = block[0] - preds[c];
            preds[c] = block[0];
            int s = jcsize(diff);
            if (!dc_d[s]) return -2;
            if (!jbw_put(&bw, dc_c[s], dc_d[s])) return -1;
            if (s) {
              int32_t v = diff < 0 ? diff + (1 << s) - 1 : diff;
              if (!jbw_put(&bw, (uint32_t)v & ((1u << s) - 1), s))
                return -1;
            }
            int last_nz = 0;
            for (int k = 63; k >= 1; --k)
              if (block[k]) { last_nz = k; break; }
            int run = 0;
            for (int k = 1; k <= last_nz; ++k) {
              int32_t v = block[k];
              if (v == 0) { run++; continue; }
              while (run > 15) {
                if (!ac_d[0xF0]) return -2;
                if (!jbw_put(&bw, ac_c[0xF0], ac_d[0xF0])) return -1;
                run -= 16;
              }
              int sz = jcsize(v);
              int sym = (run << 4) | sz;
              if (!ac_d[sym]) return -2;
              if (!jbw_put(&bw, ac_c[sym], ac_d[sym])) return -1;
              int32_t vv = v < 0 ? v + (1 << sz) - 1 : v;
              if (!jbw_put(&bw, (uint32_t)vv & ((1u << sz) - 1), sz))
                return -1;
              run = 0;
            }
            if (last_nz != 63) {
              if (!ac_d[0x00]) return -2;
              if (!jbw_put(&bw, ac_c[0x00], ac_d[0x00])) return -1;
            }
          }
        }
      }
      mcu_count++;
    }
  }
  if (!jbw_flush_ones(&bw)) return -1;
  return bw.pos;
}

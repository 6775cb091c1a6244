/* Native hot loop: rANS symbol reading + modular channel decode.
 *
 * The TPU framework keeps entropy decoding on the host (it is bit-serial
 * by construction); this C implementation replaces the Python inner loop
 * for WP-free trees, mirroring DecodeModularChannelMAANS
 * (lib/jxl/modular/encoding/encoding.cc:143-484) and
 * ANSSymbolReader::ReadSymbolANSWithoutRefill (lib/jxl/dec_ans.h:168-190).
 *
 * Built with: cc -O2 -shared -fPIC (see libjxl_tpu/native_ext.py).
 * Interface is plain C for ctypes.
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>
#include <stdlib.h>

#define ANS_LOG_TAB_SIZE 12
#define ANS_TAB_SIZE (1 << ANS_LOG_TAB_SIZE)

typedef struct {
  const uint8_t* data;
  size_t size;
  size_t pos;        /* next byte */
  uint64_t buf;
  int bits;
} BitReaderC;

static inline void br_refill(BitReaderC* br) {
  if (br->pos + 8 <= br->size) {
    /* bulk refill: one unaligned 8-byte load instead of a byte loop */
    uint64_t chunk;
    memcpy(&chunk, br->data + br->pos, 8);
    int nbytes = (63 - br->bits) >> 3;
    br->buf |= chunk << br->bits;
    br->pos += (size_t)nbytes;
    br->bits += nbytes * 8;
    return;
  }
  while (br->bits <= 56) {
    uint64_t byte = br->pos < br->size ? br->data[br->pos] : 0;
    br->buf |= byte << br->bits;
    br->pos++;
    br->bits += 8;
  }
}

static inline uint32_t br_read(BitReaderC* br, int n) {
  if (n == 0) return 0;
  if (br->bits < n) br_refill(br);
  uint32_t v = (uint32_t)(br->buf & ((1ull << n) - 1));
  br->buf >>= n;
  br->bits -= n;
  return v;
}

typedef struct {
  const uint16_t* cutoff;     /* [nclusters * table_size] */
  const uint16_t* right;
  const uint16_t* freq0;
  const uint16_t* offsets1;
  const uint16_t* freq1;
  int log_alpha_size;
  const uint8_t* context_map; /* ctx -> cluster */
  const uint32_t* cfg_split_exp;  /* per cluster */
  const uint32_t* cfg_msb;
  const uint32_t* cfg_lsb;
} AnsTablesC;

typedef struct {
  uint32_t state;
} AnsStateC;

static inline uint32_t ans_read_symbol(const AnsTablesC* t, int cluster,
                                       AnsStateC* s, BitReaderC* br) {
  uint32_t res = s->state & (ANS_TAB_SIZE - 1);
  int las = t->log_alpha_size;
  int les = ANS_LOG_TAB_SIZE - las;
  uint32_t i = res >> les;
  uint32_t pos = res & ((1u << les) - 1);
  size_t base = (size_t)cluster << las;
  uint32_t cutoff = t->cutoff[base + i];
  uint32_t sym, off, freq;
  if (pos >= cutoff) {
    sym = t->right[base + i];
    off = t->offsets1[base + i] + pos;
    freq = t->freq1[base + i];
  } else {
    sym = i;
    off = pos;
    freq = t->freq0[base + i];
  }
  s->state = freq * (s->state >> ANS_LOG_TAB_SIZE) + off;
  if (s->state < (1u << 16)) {
    s->state = (s->state << 16) | br_read(br, 16);
  }
  return sym;
}

static inline uint32_t read_hybrid_uint(const AnsTablesC* t, int ctx,
                                        AnsStateC* s, BitReaderC* br) {
  int cluster = t->context_map[ctx];
  uint32_t token = ans_read_symbol(t, cluster, s, br);
  uint32_t split_exp = t->cfg_split_exp[cluster];
  uint32_t split_token = 1u << split_exp;
  if (token < split_token) return token;
  uint32_t msb = t->cfg_msb[cluster];
  uint32_t lsb = t->cfg_lsb[cluster];
  uint32_t nbits = split_exp - (msb + lsb) +
                   ((token - split_token) >> (msb + lsb));
  if (nbits > 31) return UINT32_MAX; /* saturate: stores bound-check */
  uint32_t low = token & ((1u << lsb) - 1);
  token >>= lsb;
  uint64_t bits = br_read(br, (int)nbits);
  uint64_t ret = ((((uint64_t)(1u << msb) | (token & ((1u << msb) - 1)))
                   << nbits) |
                  bits)
                     << lsb |
                 low;
  /* saturate past uint32 so the int32-range store checks fire instead
   * of silently wrapping (the Python fallback raises) */
  return ret > UINT32_MAX ? UINT32_MAX : (uint32_t)ret;
}

static inline int64_t unpack_signed(uint32_t u) {
  return (u & 1) ? -(int64_t)((u + 1) >> 1) : (int64_t)(u >> 1);
}

/* flat decoder tree: arrays of equal length */
typedef struct {
  const int32_t* property;  /* -1 = leaf */
  const int32_t* splitval;
  const int32_t* lchild;    /* leaf: clustered ctx unused; raw ctx id */
  const int32_t* rchild;
  const int32_t* predictor;
  const int64_t* offset;
  const int32_t* multiplier;
} TreeC;

enum {
  P_ZERO = 0, P_LEFT, P_TOP, P_AVG0, P_SELECT, P_GRADIENT, P_WEIGHTED,
  P_TOPRIGHT, P_TOPLEFT, P_LEFTLEFT, P_AVG1, P_AVG2, P_AVG3, P_AVG4
};

static inline int64_t cdiv2(int64_t v) { return v / 2; } /* trunc toward 0 */

static inline int64_t clamped_gradient(int64_t n, int64_t w, int64_t l) {
  int64_t m = n < w ? n : w;
  int64_t M = n > w ? n : w;
  int64_t grad = n + w - l;
  if (l < m) return M;
  if (l > M) return m;
  return grad;
}

static inline int64_t predict_one(int p, int64_t left, int64_t top,
                                  int64_t toptop, int64_t topleft,
                                  int64_t topright, int64_t leftleft,
                                  int64_t trr) {
  switch (p) {
    case P_ZERO: return 0;
    case P_LEFT: return left;
    case P_TOP: return top;
    case P_SELECT: {
      int64_t pp = left + top - topleft;
      int64_t pa = pp - left; if (pa < 0) pa = -pa;
      int64_t pb = pp - top; if (pb < 0) pb = -pb;
      return pa < pb ? left : top;
    }
    case P_GRADIENT: return clamped_gradient(left, top, topleft);
    case P_TOPLEFT: return topleft;
    case P_TOPRIGHT: return topright;
    case P_LEFTLEFT: return leftleft;
    case P_AVG0: return cdiv2(left + top);
    case P_AVG1: return cdiv2(left + topleft);
    case P_AVG2: return cdiv2(topleft + top);
    case P_AVG3: return cdiv2(top + topright);
    case P_AVG4:
      return (6 * top - 2 * toptop + 7 * left + leftleft + trr +
              3 * topright + 8) / 16;
    default: return 0;
  }
}

/* Decode one channel with a WP-free tree. Returns 0 on success.
 * state/bitpos updated in place. out: int32[h*w]. */
int decode_channel_nowp(
    const uint8_t* data, size_t data_size, uint64_t* bitpos_io,
    uint32_t* state_io,
    const uint16_t* cutoff, const uint16_t* right, const uint16_t* freq0,
    const uint16_t* offsets1, const uint16_t* freq1, int log_alpha_size,
    const uint8_t* context_map,
    const uint32_t* cfg_split, const uint32_t* cfg_msb,
    const uint32_t* cfg_lsb,
    const int32_t* t_property, const int32_t* t_splitval,
    const int32_t* t_lchild, const int32_t* t_rchild,
    const int32_t* t_predictor, const int64_t* t_offset,
    const int32_t* t_multiplier,
    int chan, int group_id, int w, int h, int32_t* out) {
  BitReaderC br;
  br.data = data; br.size = data_size;
  uint64_t bitpos = *bitpos_io;
  br.pos = bitpos >> 3;
  br.buf = 0; br.bits = 0;
  {
    int rem = (int)(bitpos & 7);
    if (rem) br_read(&br, rem); /* discard partial byte bits */
  }
  AnsTablesC t = {cutoff, right, freq0, offsets1, freq1, log_alpha_size,
                  context_map, cfg_split, cfg_msb, cfg_lsb};
  AnsStateC s = {*state_io};

  int64_t props[16];
  props[0] = chan; props[1] = group_id;
  for (int y = 0; y < h; y++) {
    props[2] = y;
    int64_t prev9 = 0;
    for (int x = 0; x < w; x++) {
      const int32_t* row = out + (size_t)y * w;
      /* y==0 guard: forming out + (y-1)*w at y==0 is UB pointer
       * arithmetic even unread; alias the current row instead (every
       * prow read below is already gated on y > 0) */
      const int32_t* prow = y ? out + (size_t)(y - 1) * w : row;
      int64_t left = x ? row[x - 1] : (y ? prow[x] : 0);
      int64_t top = y ? prow[x] : left;
      int64_t topleft = (x && y) ? prow[x - 1] : left;
      int64_t topright = (x + 1 < w && y) ? prow[x + 1] : top;
      int64_t leftleft = x > 1 ? row[x - 2] : left;
      int64_t toptop = y > 1 ? out[(size_t)(y - 2) * w + x] : top;
      int64_t trr = (x + 2 < w && y) ? prow[x + 2] : topright;
      props[3] = x;
      props[4] = top > 0 ? top : -top;
      props[5] = left > 0 ? left : -left;
      props[6] = top;
      props[7] = left;
      props[8] = left - prev9;
      prev9 = left + top - topleft;
      props[9] = prev9;
      props[10] = left - topleft;
      props[11] = topleft - top;
      props[12] = top - topright;
      props[13] = top - toptop;
      props[14] = left - leftleft;
      props[15] = 0; /* WP property unused in this path */
      /* walk tree */
      int pos = 0;
      while (t_property[pos] >= 0) {
        pos = (props[t_property[pos]] > t_splitval[pos]) ? t_lchild[pos]
                                                         : t_rchild[pos];
      }
      uint32_t v = read_hybrid_uint(&t, t_lchild[pos], &s, &br);
      int64_t guess = t_offset[pos] +
          predict_one(t_predictor[pos], left, top, toptop, topleft,
                      topright, leftleft, trr);
      int64_t val = unpack_signed(v) * (int64_t)t_multiplier[pos] + guess;
      if (val > INT32_MAX || val < INT32_MIN) return 3; /* sample range */
      out[(size_t)y * w + x] = (int32_t)val;
    }
  }
  *state_io = s.state;
  *bitpos_io = ((uint64_t)br.pos << 3) - (uint64_t)br.bits;
  return 0;
}

/* ------------------------------------------------------------------ WP --
 * Weighted-predictor channel decode (context_predict.h:33-210): the
 * self-correcting predictor keeps two rows of per-subpredictor error
 * history, forcing strictly sequential raster order — the classic
 * vectorization obstacle (SURVEY.md section 3.4). One C call per channel
 * replaces the per-pixel Python loop. */

static const int64_t kDivLookup[64] = {
  16777216, 8388608, 5592405, 4194304, 3355443, 2796202, 2396745, 2097152,
  1864135, 1677721, 1525201, 1398101, 1290555, 1198372, 1118481, 1048576,
  986895, 932067, 883011, 838860, 798915, 762600, 729444, 699050,
  671088, 645277, 621378, 599186, 578524, 559240, 541200, 524288,
  508400, 493447, 479349, 466033, 453438, 441505, 430185, 419430,
  409200, 399457, 390167, 381300, 372827, 364722, 356962, 349525,
  342392, 335544, 328965, 322638, 316551, 310689, 305040, 299593,
  294337, 289262, 284359, 279620, 275036, 270600, 266305, 262144,
};

typedef struct {
  int32_t p1c, p2c, p3ca, p3cb, p3cc, p3cd, p3ce;
  int32_t w[4];
} WpHeaderC;

static inline int64_t wp_error_weight(int64_t x, int32_t maxweight) {
  int shift = 0;
  {
    uint64_t v = (uint64_t)(x + 1);
    int bl = 0;
    while (v >> bl) bl++;  /* bit_length */
    shift = bl - 1 - 5;
    if (shift < 0) shift = 0;
  }
  return 4 + ((maxweight * kDivLookup[x >> shift]) >> shift);
}

int decode_channel_wp(
    const uint8_t* data, size_t data_size, uint64_t* bitpos_io,
    uint32_t* state_io,
    const uint16_t* cutoff, const uint16_t* right, const uint16_t* freq0,
    const uint16_t* offsets1, const uint16_t* freq1, int log_alpha_size,
    const uint8_t* context_map,
    const uint32_t* cfg_split, const uint32_t* cfg_msb,
    const uint32_t* cfg_lsb,
    const int32_t* t_property, const int32_t* t_splitval,
    const int32_t* t_lchild, const int32_t* t_rchild,
    const int32_t* t_predictor, const int64_t* t_offset,
    const int32_t* t_multiplier,
    const int32_t* wp_params, /* p1c p2c p3ca p3cb p3cc p3cd p3ce w0..w3 */
    int chan, int group_id, int w, int h, int32_t* out) {
  BitReaderC br;
  br.data = data; br.size = data_size;
  uint64_t bitpos = *bitpos_io;
  br.pos = bitpos >> 3;
  br.buf = 0; br.bits = 0;
  {
    int rem = (int)(bitpos & 7);
    if (rem) br_read(&br, rem);
  }
  AnsTablesC t = {cutoff, right, freq0, offsets1, freq1, log_alpha_size,
                  context_map, cfg_split, cfg_msb, cfg_lsb};
  AnsStateC s = {*state_io};
  WpHeaderC hp;
  hp.p1c = wp_params[0]; hp.p2c = wp_params[1];
  hp.p3ca = wp_params[2]; hp.p3cb = wp_params[3]; hp.p3cc = wp_params[4];
  hp.p3cd = wp_params[5]; hp.p3ce = wp_params[6];
  for (int i = 0; i < 4; i++) hp.w[i] = wp_params[7 + i];

  size_t stride = (size_t)w + 2;
  int64_t* pe = (int64_t*)calloc(4 * 2 * stride, sizeof(int64_t));
  int64_t* er = (int64_t*)calloc(2 * stride, sizeof(int64_t));
  if (!pe || !er) { free(pe); free(er); return 2; }

  int64_t props[16];
  props[0] = chan; props[1] = group_id;
  for (int y = 0; y < h; y++) {
    props[2] = y;
    int64_t prev9 = 0;
    size_t cur_row = (y & 1) ? 0 : stride;
    size_t prev_row = (y & 1) ? stride : 0;
    for (int x = 0; x < w; x++) {
      const int32_t* row = out + (size_t)y * w;
      /* y==0 guard: forming out + (y-1)*w at y==0 is UB pointer
       * arithmetic even unread; alias the current row instead (every
       * prow read below is already gated on y > 0) */
      const int32_t* prow = y ? out + (size_t)(y - 1) * w : row;
      int64_t left = x ? row[x - 1] : (y ? prow[x] : 0);
      int64_t top = y ? prow[x] : left;
      int64_t topleft = (x && y) ? prow[x - 1] : left;
      int64_t topright = (x + 1 < w && y) ? prow[x + 1] : top;
      int64_t leftleft = x > 1 ? row[x - 2] : left;
      int64_t toptop = y > 1 ? out[(size_t)(y - 2) * w + x] : top;
      int64_t trr = (x + 2 < w && y) ? prow[x + 2] : topright;

      /* weighted::State::Predict (context_predict.h:137-208) */
      size_t pos_n = prev_row + x;
      size_t pos_ne = (x < w - 1) ? pos_n + 1 : pos_n;
      size_t pos_nw = (x > 0) ? pos_n - 1 : pos_n;
      int64_t weights[4];
      for (int i = 0; i < 4; i++) {
        int64_t werr = pe[(size_t)i * 2 * stride + pos_n] +
                       pe[(size_t)i * 2 * stride + pos_ne] +
                       pe[(size_t)i * 2 * stride + pos_nw];
        weights[i] = wp_error_weight(werr, hp.w[i]);
      }
      int64_t n8 = top << 3, w8 = left << 3, ne8 = topright << 3;
      int64_t nw8 = topleft << 3, nn8 = toptop << 3;
      int64_t te_w = x ? er[cur_row + x - 1] : 0;
      int64_t te_n = er[pos_n];
      int64_t te_nw = er[pos_nw];
      int64_t te_ne = er[pos_ne];
      int64_t sum_wn = te_n + te_w;
      int64_t prediction[4];
      prediction[0] = w8 + ne8 - n8;
      prediction[1] = n8 - (((sum_wn + te_ne) * hp.p1c) >> 5);
      prediction[2] = w8 - (((sum_wn + te_nw) * hp.p2c) >> 5);
      prediction[3] = n8 - ((te_nw * hp.p3ca + te_n * hp.p3cb +
                             te_ne * hp.p3cc + (nn8 - n8) * hp.p3cd +
                             (nw8 - w8) * hp.p3ce) >> 5);
      int64_t weight_sum = weights[0] + weights[1] + weights[2] + weights[3];
      int log_weight = 0;
      { uint64_t v = (uint64_t)weight_sum; while (v >> log_weight) log_weight++; }
      log_weight -= 1;
      for (int i = 0; i < 4; i++) weights[i] >>= (log_weight - 4);
      weight_sum = weights[0] + weights[1] + weights[2] + weights[3];
      int64_t sum = (weight_sum >> 1) - 1;
      for (int i = 0; i < 4; i++) sum += prediction[i] * weights[i];
      int64_t wp_pred = (sum * kDivLookup[weight_sum - 1]) >> 24;
      if (((te_n ^ te_w) | (te_n ^ te_nw)) <= 0) {
        int64_t mx = w8 > ne8 ? w8 : ne8; if (n8 > mx) mx = n8;
        int64_t mn = w8 < ne8 ? w8 : ne8; if (n8 < mn) mn = n8;
        if (wp_pred < mn) wp_pred = mn;
        if (wp_pred > mx) wp_pred = mx;
      }
      int64_t wp_final = (wp_pred + 3) >> 3;
      /* property 15: the teammate error with the largest magnitude */
      int64_t p15 = te_w;
      if ((te_n < 0 ? -te_n : te_n) > (p15 < 0 ? -p15 : p15)) p15 = te_n;
      if ((te_nw < 0 ? -te_nw : te_nw) > (p15 < 0 ? -p15 : p15)) p15 = te_nw;
      if ((te_ne < 0 ? -te_ne : te_ne) > (p15 < 0 ? -p15 : p15)) p15 = te_ne;

      props[3] = x;
      props[4] = top > 0 ? top : -top;
      props[5] = left > 0 ? left : -left;
      props[6] = top;
      props[7] = left;
      props[8] = left - prev9;
      prev9 = left + top - topleft;
      props[9] = prev9;
      props[10] = left - topleft;
      props[11] = topleft - top;
      props[12] = top - topright;
      props[13] = top - toptop;
      props[14] = left - leftleft;
      props[15] = p15;
      int pos = 0;
      while (t_property[pos] >= 0) {
        pos = (props[t_property[pos]] > t_splitval[pos]) ? t_lchild[pos]
                                                         : t_rchild[pos];
      }
      uint32_t v = read_hybrid_uint(&t, t_lchild[pos], &s, &br);
      int64_t guess;
      if (t_predictor[pos] == P_WEIGHTED) {
        guess = t_offset[pos] + wp_final;
      } else {
        guess = t_offset[pos] +
            predict_one(t_predictor[pos], left, top, toptop, topleft,
                        topright, leftleft, trr);
      }
      int64_t val = unpack_signed(v) * (int64_t)t_multiplier[pos] + guess;
      if (val > INT32_MAX || val < INT32_MIN) return 3; /* sample range */
      out[(size_t)y * w + x] = (int32_t)val;
      /* UpdateErrors (context_predict.h:190-208) */
      int64_t val8 = val << 3;
      er[cur_row + x] = wp_pred - val8;
      for (int i = 0; i < 4; i++) {
        int64_t d = prediction[i] - val8;
        if (d < 0) d = -d;
        int64_t err = (d + 3) >> 3;
        pe[(size_t)i * 2 * stride + cur_row + x] = err;
        pe[(size_t)i * 2 * stride + prev_row + x + 1] += err;
      }
    }
  }
  free(pe); free(er);
  *state_io = s.state;
  *bitpos_io = ((uint64_t)br.pos << 3) - (uint64_t)br.bits;
  return 0;
}

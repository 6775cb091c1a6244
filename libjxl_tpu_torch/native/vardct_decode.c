/* Native hot loop: VarDCT AC-group coefficient decode.
 *
 * Mirrors DecodeACVarBlock (lib/jxl/dec_group.cc:453-530) and the context
 * model of lib/jxl/ac_context.h: per block, read the nonzero count in a
 * context predicted from the top/left blocks, then the zero-density-context
 * coefficient chain, scattering through the coefficient order LUT.
 *
 * Entropy decode on the host is bit-serial by construction; this replaces
 * the Python token loop (vardct/frame.py decode_ac_group) so a whole 256px
 * group decodes in one C call. Parallel work (dequant/IDCT/filters) runs
 * on the TPU.
 *
 * Built together with modular_decode.c into _jxl_native.so (see
 * libjxl_tpu/native_ext.py). Plain C interface for ctypes.
 */

#include <math.h>
#include <stdint.h>
#include <stddef.h>
#include <stdlib.h>
#include <string.h>
#include <pthread.h>

#define ANS_LOG_TAB_SIZE 12
#define ANS_TAB_SIZE (1 << ANS_LOG_TAB_SIZE)
#define NONZERO_BUCKETS 37
#define ZERO_DENSITY_CONTEXT_COUNT 458

typedef struct {
  const uint8_t* data;
  size_t size;
  size_t pos;
  uint64_t buf;
  int bits;
} BitReaderV;

static inline void vbr_refill(BitReaderV* br) {
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

static inline uint32_t vbr_read(BitReaderV* br, int n) {
  if (n == 0) return 0;
  if (br->bits < n) vbr_refill(br);
  uint32_t v = (uint32_t)(br->buf & ((1ull << n) - 1));
  br->buf >>= n;
  br->bits -= n;
  return v;
}

typedef struct {
  const uint16_t* cutoff;
  const uint16_t* right;
  const uint16_t* freq0;
  const uint16_t* offsets1;
  const uint16_t* freq1;
  int log_alpha_size;
  const uint8_t* context_map;
  const uint32_t* cfg_split_exp;
  const uint32_t* cfg_msb;
  const uint32_t* cfg_lsb;
} AnsTablesV;

static inline uint32_t v_ans_read_symbol(const AnsTablesV* t, int cluster,
                                         uint32_t* state, BitReaderV* br) {
  uint32_t res = *state & (ANS_TAB_SIZE - 1);
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
  *state = freq * (*state >> ANS_LOG_TAB_SIZE) + off;
  if (*state < (1u << 16)) {
    *state = (*state << 16) | vbr_read(br, 16);
  }
  return sym;
}

/* Packed alias entry: one 8-byte load per symbol instead of five
 * scattered uint16 loads (dec_ans.h AliasTable::Entry analog).
 * Layout: [cutoff, right | (freq1 << ...)]... kept simple:
 * e[0]=cutoff, e[1]=right, e[2]=freq0, e[3]=offsets1 packed as 4x u16;
 * freq1 lives in a parallel array (still same cache line rate). */
typedef struct {
  uint16_t cutoff;
  uint16_t right;
  uint16_t freq0;
  uint16_t offsets1;
  uint16_t freq1;
  uint16_t pad[3];
} AliasEntryV;

static inline uint32_t v_ans_read_symbol_packed(
    const AliasEntryV* entries, int les, int cluster_shift_base,
    uint32_t* state, BitReaderV* br) {
  uint32_t res = *state & (ANS_TAB_SIZE - 1);
  uint32_t i = res >> les;
  uint32_t pos = res & ((1u << les) - 1);
  const AliasEntryV* e = entries + cluster_shift_base + i;
  int ge = pos >= e->cutoff;
  uint32_t sym = ge ? e->right : i;
  uint32_t off = ge ? (uint32_t)e->offsets1 + pos : pos;
  uint32_t freq = ge ? e->freq1 : e->freq0;
  *state = freq * (*state >> ANS_LOG_TAB_SIZE) + off;
  if (*state < (1u << 16)) {
    *state = (*state << 16) | vbr_read(br, 16);
  }
  return sym;
}

typedef struct {
  const AliasEntryV* entries;
  int log_alpha_size;
  const uint8_t* context_map;
  const uint32_t* cfg_split_exp;
  const uint32_t* cfg_msb;
  const uint32_t* cfg_lsb;
} AnsPackedV;

static inline uint32_t v_read_hybrid_uint_packed(const AnsPackedV* t,
                                                 int ctx, uint32_t* state,
                                                 BitReaderV* br) {
  int cluster = t->context_map[ctx];
  int les = ANS_LOG_TAB_SIZE - t->log_alpha_size;
  uint32_t token = v_ans_read_symbol_packed(
      t->entries, les, cluster << t->log_alpha_size, state, br);
  uint32_t split_exp = t->cfg_split_exp[cluster];
  uint32_t split_token = 1u << split_exp;
  if (token < split_token) return token;
  uint32_t msb = t->cfg_msb[cluster];
  uint32_t lsb = t->cfg_lsb[cluster];
  uint32_t nbits = split_exp - (msb + lsb) +
                   ((token - split_token) >> (msb + lsb));
  if (nbits > 31) return UINT32_MAX; /* saturate: callers bound-check */
  uint32_t low = token & ((1u << lsb) - 1);
  token >>= lsb;
  uint64_t bits = vbr_read(br, (int)nbits);
  uint64_t v = ((((uint64_t)(1u << msb) | (token & ((1u << msb) - 1)))
                 << nbits) |
                bits)
                   << lsb |
               low;
  /* values past uint32 wrapped before (diverging from the exact-int
   * Python fallback); saturate so the callers' range checks fire */
  return v > UINT32_MAX ? UINT32_MAX : (uint32_t)v;
}

static inline uint32_t v_read_hybrid_uint(const AnsTablesV* t, int ctx,
                                          uint32_t* state, BitReaderV* br) {
  int cluster = t->context_map[ctx];
  uint32_t token = v_ans_read_symbol(t, cluster, state, br);
  uint32_t split_exp = t->cfg_split_exp[cluster];
  uint32_t split_token = 1u << split_exp;
  if (token < split_token) return token;
  uint32_t msb = t->cfg_msb[cluster];
  uint32_t lsb = t->cfg_lsb[cluster];
  uint32_t nbits = split_exp - (msb + lsb) +
                   ((token - split_token) >> (msb + lsb));
  if (nbits > 31) return UINT32_MAX; /* saturate: callers bound-check */
  uint32_t low = token & ((1u << lsb) - 1);
  token >>= lsb;
  uint64_t bits = vbr_read(br, (int)nbits);
  uint64_t v = ((((uint64_t)(1u << msb) | (token & ((1u << msb) - 1)))
                 << nbits) |
                bits)
                   << lsb |
               low;
  /* values past uint32 wrapped before (diverging from the exact-int
   * Python fallback); saturate so the callers' range checks fire */
  return v > UINT32_MAX ? UINT32_MAX : (uint32_t)v;
}

/* ac_context.h:24-45 */
static const int32_t kCoeffFreqContext[64] = {
    0xBAD, 0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14,
    15,    15, 16, 16, 17, 17, 18, 18, 19, 19, 20, 20, 21, 21, 22, 22,
    23,    23, 23, 23, 24, 24, 24, 24, 25, 25, 25, 25, 26, 26, 26, 26,
    27,    27, 27, 27, 28, 28, 28, 28, 29, 29, 29, 29, 30, 30, 30, 30};

static const int32_t kCoeffNumNonzeroContext[64] = {
    0xBAD, 0,   31,  62,  62,  93,  93,  93,  93,  123, 123, 123, 123,
    152,   152, 152, 152, 152, 152, 152, 152, 180, 180, 180, 180, 180,
    180,   180, 180, 180, 180, 180, 180, 206, 206, 206, 206, 206, 206,
    206,   206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206,
    206,   206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206};

/* Fill the strategy/origin/qf/sharpness maps from a decoded AC-metadata
 * stream (the per-pixel placement loop of dec_modular.cc:437-532).
 * acs_row/qf_row: int32[count]; sharp: int32[rh*rw];
 * strategy: int8 full-image map (nbx stride), initialized to -1;
 * origin: uint8; qf: int32; sharp_out: int8.
 * Geometry luts: cov_x/cov_y int32[27].
 * group_dim_blocks: AC-group size in blocks; a transform may not cross
 * an AC-group boundary (dec_modular.cc:515 "Invalid AC strategy"), and
 * enforcing it here also bounds every nzmap write in decode_ac_image.
 * Returns number of blocks consumed, or -1 on corruption. */
int place_ac_metadata(const int32_t* acs_row, const int32_t* qf_row,
                      int32_t count, const int32_t* sharp,
                      int x0, int y0, int rw, int rh,
                      int nbx_total, int nby_total, int group_dim_blocks,
                      const int32_t* cov_x, const int32_t* cov_y,
                      int quant_max,
                      int32_t* strategy, uint8_t* origin, int32_t* qf,
                      int32_t* sharp_out) {
  int num = 0;
  int gdim = group_dim_blocks;
  for (int iy = 0; iy < rh; iy++) {
    for (int ix = 0; ix < rw; ix++) {
      int x = x0 + ix, y = y0 + iy;
      int s = sharp[(size_t)iy * rw + ix];
      if (s < 0 || s >= 8) return -1;
      sharp_out[(size_t)y * nbx_total + x] = s;
      if (strategy[(size_t)y * nbx_total + x] >= 0) continue;
      if (num >= count) return -1;
      int raw = acs_row[num];
      if (raw < 0 || raw >= 27) return -1;
      int cx = cov_x[raw], cy = cov_y[raw];
      if (x + cx > nbx_total || y + cy > nby_total) return -1;
      if (x % gdim + cx > gdim || y % gdim + cy > gdim) return -1;
      int q = qf_row[num] + 1;
      if (q < 1) q = 1;
      if (q > quant_max) q = quant_max;
      for (int yy = 0; yy < cy; yy++)
        for (int xx = 0; xx < cx; xx++) {
          strategy[(size_t)(y + yy) * nbx_total + x + xx] = raw;
          qf[(size_t)(y + yy) * nbx_total + x + xx] = q;
        }
      origin[(size_t)y * nbx_total + x] = 1;
      num++;
    }
  }
  return num;
}

/* Whole-image AC decode for one pass: every group's section in one call,
 * coefficients written straight into the dense image-layout planes
 * (qimg[c][py * W + px]). Replaces the per-group Python dispatch.
 *
 * group_off/group_size: byte ranges of each group's section within data.
 * strategy/origin/qf: full-image block maps (see place_ac_metadata).
 * bctx_lut: int32[3 * 13 * (nqf + 1)]  ((c_idx * 13 + ord) * (nqf+1) + qfi)
 * qf_thr: int64[nqf] block-context qf thresholds.
 * ord_img_off: int64[27 * 3] offset into ord_img_flat per (strategy, c);
 * ord_img_flat: int32 image-relative offsets (dy * W + dx) per coeff k.
 * cov_x/cov_y/log2cb/ord_lut: int32[27] strategy geometry.
 * Returns 0, or (1000 + group) on a bad group. */
/* Shared read-only decode context for one pass over the group grid. */
typedef struct AcImageCtx {
  const uint8_t* data;
  const uint64_t* group_off;
  const uint64_t* group_size;
  int n_groups, xsize_groups, group_dim_blocks;
  const AliasEntryV* entries;
  int log_alpha_size;
  const uint8_t* context_map;
  const uint32_t* cfg_split;
  const uint32_t* cfg_msb;
  const uint32_t* cfg_lsb;
  const int32_t* strategy;
  const uint8_t* origin;
  const int32_t* qf;
  int nby, nbx;
  const int32_t* bctx_lut;
  const int64_t* qf_thr;
  int nqf;
  /* each luma block's DC context (compressed_dc.cc DequantDC), NULL
   * where the block context map has one (ndc == 1) */
  const uint8_t* dc_idx;
  int ndc;
  const int64_t* ord_img_off;
  const int32_t* ord_img_flat;
  const int32_t* cov_x;
  const int32_t* cov_y;
  const int32_t* log2cb;
  const int32_t* ord_lut;
  int histo_bits, num_histograms, num_ac_ctx, num_ctxs, shift, W;
  int32_t* planes[3];
  /* chroma-subsampled frames: each channel's shifts and plane width */
  int hs[3], vs[3], Wc[3];
  int (*decode_group)(const struct AcImageCtx*, int, int32_t*);
} AcImageCtx;

/* Decode one group's section into the dense planes. Returns 0 ok.
 * nzmap: caller scratch, int32[3 * gdim * gdim]. Groups touch disjoint
 * pixel ranges (transforms cannot cross group boundaries — enforced in
 * place_ac_metadata), so concurrent calls on different groups are safe. */
static int decode_one_ac_group_img(const AcImageCtx* cc, int g,
                                   int32_t* nzmap) {
  static const int kChanOrder[3] = {1, 0, 2};
  int gdim = cc->group_dim_blocks;
  int gx = g % cc->xsize_groups;
  int gy = g / cc->xsize_groups;
  int bx0 = gx * gdim;
  int by0 = gy * gdim;
  int bw = cc->nbx - bx0;
  if (bw > gdim) bw = gdim;
  int bh = cc->nby - by0;
  if (bh > gdim) bh = gdim;

  BitReaderV br;
  br.data = cc->data + cc->group_off[g];
  br.size = cc->group_size[g];
  br.pos = 0;
  br.buf = 0;
  br.bits = 0;
  int ctx_offset = 0;
  if (cc->histo_bits) {
    uint32_t sel = vbr_read(&br, cc->histo_bits);
    /* TOC-controlled selector must name an existing histogram set
     * (dec_frame.cc rejects selector >= num_histograms) */
    if (sel >= (uint32_t)cc->num_histograms) return 1;
    ctx_offset = (int)sel * cc->num_ac_ctx;
  }
  uint32_t state = vbr_read(&br, 32);
  memset(nzmap, 0, sizeof(int32_t) * 3 * bh * bw);
  AnsPackedV t = {cc->entries, cc->log_alpha_size, cc->context_map,
                  cc->cfg_split, cc->cfg_msb, cc->cfg_lsb};
  int nqf = cc->nqf, num_ctxs = cc->num_ctxs, shift = cc->shift;
  int W = cc->W, nbx = cc->nbx;

  for (int by = 0; by < bh; by++) {
    for (int bx = 0; bx < bw; bx++) {
      int aby = by0 + by, abx = bx0 + bx;
      if (!cc->origin[(size_t)aby * nbx + abx]) continue;
      int s = cc->strategy[(size_t)aby * nbx + abx];
      int bcx = cc->cov_x[s], bcy = cc->cov_y[s];
      int l2 = cc->log2cb[s];
      int cb = bcx * bcy;
      int size = cb * 64;
      int ord = cc->ord_lut[s];
      int quant = cc->qf[(size_t)aby * nbx + abx];
      int qfi = 0;
      while (qfi < nqf && quant > cc->qf_thr[qfi]) qfi++;
      int64_t base_px = (int64_t)aby * 8 * W + (int64_t)abx * 8;
      for (int ci = 0; ci < 3; ci++) {
        int c = kChanOrder[ci];
        int cidx = c < 2 ? (c ^ 1) : 2;
        int bc = cc->bctx_lut[((size_t)cidx * 13 + ord) * (nqf + 1) + qfi];
        const int32_t* oimg =
            cc->ord_img_flat + cc->ord_img_off[(size_t)s * 3 + c];
        int32_t* acc = cc->planes[c] + base_px;
        int32_t* nzm = nzmap + (size_t)c * bh * bw;
        int pred;
        if (bx == 0) {
          pred = by > 0 ? nzm[(size_t)(by - 1) * bw + bx] : 32;
        } else if (by == 0) {
          pred = nzm[(size_t)by * bw + bx - 1];
        } else {
          pred = (nzm[(size_t)(by - 1) * bw + bx] +
                  nzm[(size_t)by * bw + bx - 1] + 1) / 2;
        }
        if (pred > 64) pred = 64;
        int nz_bucket = pred < 8 ? pred : 4 + pred / 2;
        int nz_ctx = ctx_offset + nz_bucket * num_ctxs + bc;
        uint32_t nzeros =
            v_read_hybrid_uint_packed(&t, nz_ctx, &state, &br);
        if (nzeros > (uint32_t)(size - cb)) return 1;
        int nz_per_block = (int)((nzeros + cb - 1) >> l2);
        for (int yy = 0; yy < bcy; yy++)
          for (int xx = 0; xx < bcx; xx++)
            nzm[(size_t)(by + yy) * bw + bx + xx] = nz_per_block;
        int histo_offset = ctx_offset + num_ctxs * NONZERO_BUCKETS +
                           ZERO_DENSITY_CONTEXT_COUNT * bc;
        int prev = nzeros > (uint32_t)(size / 16) ? 0 : 1;
        int k = cb;
        int32_t remaining = (int32_t)nzeros;
        while (k < size && remaining != 0) {
          int nzl = (remaining + cb - 1) >> l2;
          int zctx = (kCoeffNumNonzeroContext[nzl] +
                      kCoeffFreqContext[k >> l2]) * 2 + prev;
          /* a lying nzeros (more remaining than positions left) pushes
           * the pair outside the 458-entry zero-density block; reject
           * instead of indexing past the context map */
          if (zctx >= ZERO_DENSITY_CONTEXT_COUNT) return 1;
          int ctx = histo_offset + zctx;
          uint32_t u = v_read_hybrid_uint_packed(&t, ctx, &state, &br);
          /* matches the Python path's bound; also keeps coeff << shift
           * inside int32 */
          if (u >= (1u << 27)) return 1;
          int32_t coeff =
              (u & 1) ? -(int32_t)((u + 1) >> 1) : (int32_t)(u >> 1);
          if (coeff >= 0) {
            acc[oimg[k]] += coeff << shift;
          } else {
            acc[oimg[k]] -= (-coeff) << shift;
          }
          prev = u ? 1 : 0;
          remaining -= prev;
          k++;
        }
        if (remaining != 0) return 1;
      }
    }
  }
  if (state != (0x13u << 16)) return 1;
  return 0;
}

/* One group's section of a chroma-subsampled frame (dec_group.cc
 * LoadBlock with shifts, dec_group.cc:247-432, 530-600), into dense
 * per-channel planes at each channel's block grid. Every block is a DCT8
 * (place_ac_metadata's caller rejects other strategies for such frames).
 * The loop runs over the luma block grid in raster order; a channel's
 * block is read where the luma position aligns with its top-left
 * ((sbx << hs) == bx), in the channel order 1, 0, 2. The nonzero
 * prediction reads the channel's own in-group grid; the quant comes from
 * the luma grid (dec_group.cc:569). Groups span an even number of blocks,
 * so their chroma blocks are disjoint too. Every block of every plane is
 * read once, and zeroed here first: the planes need no initialisation. */
static int decode_one_ac_group_sub(const AcImageCtx* cc, int g,
                                   int32_t* nzmap) {
  static const int kChanOrder[3] = {1, 0, 2};
  int gdim = cc->group_dim_blocks;
  int gx = g % cc->xsize_groups;
  int gy = g / cc->xsize_groups;
  int bx0 = gx * gdim;
  int by0 = gy * gdim;
  int bw = cc->nbx - bx0;
  if (bw > gdim) bw = gdim;
  int bh = cc->nby - by0;
  if (bh > gdim) bh = gdim;

  BitReaderV br;
  br.data = cc->data + cc->group_off[g];
  br.size = cc->group_size[g];
  br.pos = 0;
  br.buf = 0;
  br.bits = 0;
  uint32_t state = vbr_read(&br, 32);
  int cw[3];
  const int32_t* oimg[3];
  for (int c = 0; c < 3; c++) {
    cw[c] = (bw + (1 << cc->hs[c]) - 1) >> cc->hs[c];
    oimg[c] = cc->ord_img_flat + cc->ord_img_off[c];
  }
  memset(nzmap, 0, sizeof(int32_t) * 3 * (size_t)gdim * gdim);
  AnsPackedV t = {cc->entries, cc->log_alpha_size, cc->context_map,
                  cc->cfg_split, cc->cfg_msb, cc->cfg_lsb};
  int nqf = cc->nqf, num_ctxs = cc->num_ctxs;
  int nbx = cc->nbx;
  int ord = cc->ord_lut[0]; /* DCT8's order class */

  for (int by = 0; by < bh; by++) {
    for (int bx = 0; bx < bw; bx++) {
      int aby = by0 + by, abx = bx0 + bx;
      int quant = cc->qf[(size_t)aby * nbx + abx];
      int qfi = 0;
      while (qfi < nqf && quant > cc->qf_thr[qfi]) qfi++;
      int dci = cc->dc_idx ? cc->dc_idx[(size_t)aby * nbx + abx] : 0;
      for (int ci = 0; ci < 3; ci++) {
        int c = kChanOrder[ci];
        int hs = cc->hs[c], vs = cc->vs[c];
        int sbx = bx >> hs, sby = by >> vs;
        if ((sbx << hs) != bx || (sby << vs) != by) continue;
        int cidx = c < 2 ? (c ^ 1) : 2;
        int bc = cc->bctx_lut[(((size_t)cidx * 13 + ord) * (nqf + 1) + qfi) *
                                  cc->ndc + dci];
        int32_t* nzm = nzmap + (size_t)c * gdim * gdim;
        int stride = cw[c];
        int pred;
        if (sbx == 0) {
          pred = sby > 0 ? nzm[(size_t)(sby - 1) * stride] : 32;
        } else if (sby == 0) {
          pred = nzm[sbx - 1];
        } else {
          pred = (nzm[(size_t)(sby - 1) * stride + sbx] +
                  nzm[(size_t)sby * stride + sbx - 1] + 1) / 2;
        }
        if (pred > 64) pred = 64;
        int nz_bucket = pred < 8 ? pred : 4 + pred / 2;
        uint32_t nzeros = v_read_hybrid_uint_packed(
            &t, nz_bucket * num_ctxs + bc, &state, &br);
        if (nzeros > 63) return 1;
        nzm[(size_t)sby * stride + sbx] = (int32_t)nzeros;
        int histo_offset =
            num_ctxs * NONZERO_BUCKETS + ZERO_DENSITY_CONTEXT_COUNT * bc;
        int prev = nzeros > 4 ? 0 : 1;
        int32_t* acc = cc->planes[c] +
                       (int64_t)(aby >> vs) * 8 * cc->Wc[c] +
                       (int64_t)(abx >> hs) * 8;
        /* the planes come uninitialised: each block is read once */
        for (int r = 0; r < 8; r++)
          memset(acc + (int64_t)r * cc->Wc[c], 0, 8 * sizeof(int32_t));
        const int32_t* oc = oimg[c];
        int k = 1;
        int32_t remaining = (int32_t)nzeros;
        while (k < 64 && remaining != 0) {
          int zctx = (kCoeffNumNonzeroContext[remaining] +
                      kCoeffFreqContext[k]) * 2 + prev;
          if (zctx >= ZERO_DENSITY_CONTEXT_COUNT) return 1;
          uint32_t u = v_read_hybrid_uint_packed(&t, histo_offset + zctx,
                                                 &state, &br);
          if (u >= (1u << 27)) return 1;
          acc[oc[k]] +=
              (u & 1) ? -(int32_t)((u + 1) >> 1) : (int32_t)(u >> 1);
          prev = u ? 1 : 0;
          remaining -= prev;
          k++;
        }
        if (remaining != 0) return 1;
      }
    }
  }
  if (state != (0x13u << 16)) return 1;
  return 0;
}

static AliasEntryV* pack_alias_tables(
    const uint16_t* cutoff, const uint16_t* right, const uint16_t* freq0,
    const uint16_t* offsets1, const uint16_t* freq1, int log_alpha_size,
    int n_tables) {
  /* one cache line per (cluster, bucket); n_tables is the caller's true
   * table count — deriving it from a prefix of the context map missed
   * clusters referenced only by later histogram selectors */
  size_t tsize = (size_t)n_tables << log_alpha_size;
  AliasEntryV* entries = (AliasEntryV*)malloc(tsize * sizeof(AliasEntryV));
  if (!entries) return NULL;
  for (size_t j = 0; j < tsize; j++) {
    entries[j].cutoff = cutoff[j];
    entries[j].right = right[j];
    entries[j].freq0 = freq0[j];
    entries[j].offsets1 = offsets1[j];
    entries[j].freq1 = freq1[j];
  }
  return entries;
}

typedef struct {
  const AcImageCtx* cc;
  int tid, nthreads;
  int err;  /* 0 or 1000 + first bad group */
} AcWorker;

static void* ac_worker_run(void* arg) {
  AcWorker* w = (AcWorker*)arg;
  const AcImageCtx* cc = w->cc;
  int gdim = cc->group_dim_blocks;
  int32_t* nzmap =
      (int32_t*)malloc(sizeof(int32_t) * 3 * (size_t)gdim * gdim);
  if (!nzmap) {
    w->err = 9999;
    return NULL;
  }
  w->err = 0;
  for (int g = w->tid; g < cc->n_groups; g += w->nthreads) {
    if (cc->decode_group(cc, g, nzmap)) {
      w->err = 1000 + g;
      break;
    }
  }
  free(nzmap);
  return NULL;
}

/* Runs cc->decode_group over every group: on n_threads threads (the
 * calling thread is one), serially when n_threads <= 1 or a thread
 * fails to spawn. Returns 0, or (1000 + group) for the first bad group. */
static int run_ac_image(const AcImageCtx* cc, int n_threads) {
  int n_groups = cc->n_groups;
  size_t nz_size = sizeof(int32_t) * 3 * (size_t)cc->group_dim_blocks *
                   cc->group_dim_blocks;
  int rc = 0;
  if (n_threads > n_groups) n_threads = n_groups;
  if (n_threads > 1) {
    /* per-AC-group data parallelism (dec_frame.cc:716 RunOnPool): the
     * groups' entropy streams and pixel ranges are independent */
    enum { kMaxThreads = 64 };
    if (n_threads > kMaxThreads) n_threads = kMaxThreads;
    pthread_t tids[kMaxThreads];
    AcWorker workers[kMaxThreads];
    int spawned = 0;
    for (int i = 0; i < n_threads; i++) {
      workers[i].cc = cc;
      workers[i].tid = i;
      workers[i].nthreads = n_threads;
      workers[i].err = 0;
      if (i == 0) continue; /* thread 0 = calling thread */
      if (pthread_create(&tids[i], NULL, ac_worker_run, &workers[i])) {
        workers[i].err = -1; /* not spawned: rerun serially below */
        break;
      }
      spawned = i;
    }
    ac_worker_run(&workers[0]);
    for (int i = 1; i <= spawned; i++) pthread_join(tids[i], NULL);
    for (int i = 0; i <= spawned; i++) {
      if (workers[i].err > 0 && (rc == 0 || workers[i].err < rc))
        rc = workers[i].err;
    }
    if (spawned + 1 < n_threads && rc == 0) {
      /* threads that failed to spawn: decode their groups here */
      int32_t* nzmap = (int32_t*)malloc(nz_size);
      if (!nzmap) rc = 9999;
      for (int i = spawned + 1; nzmap && i < n_threads; i++) {
        for (int g = i; g < n_groups && rc == 0; g += n_threads) {
          if (cc->decode_group(cc, g, nzmap)) rc = 1000 + g;
        }
      }
      free(nzmap);
    }
  } else {
    int32_t* nzmap = (int32_t*)malloc(nz_size);
    if (!nzmap) return 9999;
    for (int g = 0; g < n_groups; g++) {
      if (cc->decode_group(cc, g, nzmap)) {
        rc = 1000 + g;
        break;
      }
    }
    free(nzmap);
  }
  return rc;
}

/* TOC offsets/sizes are attacker-controlled: every group's section must
 * lie inside the input buffer (the Python fallback slices
 * data[start:start+size]; mirror that bound here). Returns 0 or
 * (1000 + group). */
static int check_sections(size_t data_size, const uint64_t* group_off,
                          const uint64_t* group_size, int n_groups) {
  for (int g = 0; g < n_groups; g++) {
    if (group_off[g] > data_size ||
        group_size[g] > data_size - group_off[g]) {
      return 1000 + g;
    }
  }
  return 0;
}

int decode_ac_image(
    const uint8_t* data, size_t data_size,
    const uint64_t* group_off, const uint64_t* group_size, int n_groups,
    int xsize_groups, int group_dim_blocks,
    const uint16_t* cutoff, const uint16_t* right, const uint16_t* freq0,
    const uint16_t* offsets1, const uint16_t* freq1, int log_alpha_size,
    const uint8_t* context_map,
    const uint32_t* cfg_split, const uint32_t* cfg_msb,
    const uint32_t* cfg_lsb,
    const int32_t* strategy, const uint8_t* origin, const int32_t* qf,
    int nby, int nbx,
    const int32_t* bctx_lut, const int64_t* qf_thr, int nqf,
    const int64_t* ord_img_off, const int32_t* ord_img_flat,
    const int32_t* cov_x, const int32_t* cov_y, const int32_t* log2cb,
    const int32_t* ord_lut,
    int histo_bits, int num_histograms, int n_tables,
    int num_ac_ctx, int num_ctxs, int shift,
    int W, int32_t* q0, int32_t* q1, int32_t* q2, int n_threads) {
  int rc = check_sections(data_size, group_off, group_size, n_groups);
  if (rc) return rc;
  AliasEntryV* entries =
      pack_alias_tables(cutoff, right, freq0, offsets1, freq1,
                        log_alpha_size, n_tables);
  if (!entries) return 9999;
  AcImageCtx cc = {data, group_off, group_size, n_groups, xsize_groups,
                   group_dim_blocks, entries, log_alpha_size, context_map,
                   cfg_split, cfg_msb, cfg_lsb, strategy, origin, qf,
                   nby, nbx, bctx_lut, qf_thr, nqf, NULL, 1, ord_img_off,
                   ord_img_flat, cov_x, cov_y, log2cb, ord_lut,
                   histo_bits, num_histograms, num_ac_ctx, num_ctxs,
                   shift, W, {q0, q1, q2}, {0, 0, 0}, {0, 0, 0},
                   {W, W, W}, decode_one_ac_group_img};
  rc = run_ac_image(&cc, n_threads);
  free(entries);
  return rc;
}

/* Whole-image AC decode of a chroma-subsampled frame (all DCT8, one
 * pass, one histogram set, so no selector): decode_ac_image's arguments
 * without the strategy geometry and the selector, and per channel c its
 * shifts chan[c] (hshift) and chan[3 + c] (vshift) and its plane's width
 * chan[6 + c] (qc: the channel's block grid x 8). ord_img_off[c] is
 * channel c's order LUT in ord_img_flat, mapped to that width. With ndc
 * DC contexts, bctx_lut has ndc entries a (c_idx, ord, qfi) and dc_idx
 * (u8, the luma block grid, each < ndc) picks one; NULL when ndc is 1. */
int decode_ac_image_sub(
    const uint8_t* data, size_t data_size,
    const uint64_t* group_off, const uint64_t* group_size, int n_groups,
    int xsize_groups, int group_dim_blocks,
    const uint16_t* cutoff, const uint16_t* right, const uint16_t* freq0,
    const uint16_t* offsets1, const uint16_t* freq1, int log_alpha_size,
    const uint8_t* context_map,
    const uint32_t* cfg_split, const uint32_t* cfg_msb,
    const uint32_t* cfg_lsb, const int32_t* qf, int nby, int nbx,
    const int32_t* bctx_lut, const int64_t* qf_thr, int nqf,
    const uint8_t* dc_idx, int ndc,
    const int64_t* ord_img_off, const int32_t* ord_img_flat,
    const int32_t* ord_lut, int n_tables, int num_ctxs,
    const int32_t* chan,
    int32_t* q0, int32_t* q1, int32_t* q2, int n_threads) {
  int rc = check_sections(data_size, group_off, group_size, n_groups);
  if (rc) return rc;
  for (int c = 0; c < 6; c++) {
    if (chan[c] < 0 || chan[c] > 1) return 9998;
  }
  if (group_dim_blocks % 2) return 9998;
  if (ndc < 1 || (ndc > 1 && !dc_idx)) return 9998;
  AliasEntryV* entries =
      pack_alias_tables(cutoff, right, freq0, offsets1, freq1,
                        log_alpha_size, n_tables);
  if (!entries) return 9999;
  AcImageCtx cc = {data, group_off, group_size, n_groups, xsize_groups,
                   group_dim_blocks, entries, log_alpha_size, context_map,
                   cfg_split, cfg_msb, cfg_lsb, NULL, NULL, qf,
                   nby, nbx, bctx_lut, qf_thr, nqf, dc_idx, ndc,
                   ord_img_off, ord_img_flat, NULL, NULL, NULL, ord_lut,
                   0, 1, 0, num_ctxs, 0, chan[7], {q0, q1, q2},
                   {chan[0], chan[1], chan[2]}, {chan[3], chan[4], chan[5]},
                   {chan[6], chan[7], chan[8]}, decode_one_ac_group_sub};
  rc = run_ac_image(&cc, n_threads);
  free(entries);
  return rc;
}

/* Decode all blocks of one AC group x pass.
 *
 * Per-block arrays (length n_blocks, raster order of origins):
 *   bx, by        block position inside the group
 *   cx, cy        covered blocks
 *   log2cb        log2(cx*cy)
 *   bsize         cx*cy*64
 *   bctx          int32[n_blocks*3], block context per channel (c-major:
 *                 bctx[i*3+c])
 *   order_off     int64[n_blocks*3], offset into orders_flat per channel
 *   out_off       int64[n_blocks], offset of channel 0 into out_flat;
 *                 channel c adds c*bsize[i]
 * nzeros_scratch: int32[3*bh*bw], zero-initialized by the caller.
 * out_flat: int32 coefficient storage (accumulated; caller zeroes on the
 * first pass).
 * Returns 0 ok, 1 invalid nzeros, 2 leftover nzeros.
 */
int decode_ac_group(
    const uint8_t* data, size_t data_size, uint64_t* bitpos_io,
    uint32_t* state_io,
    const uint16_t* cutoff, const uint16_t* right, const uint16_t* freq0,
    const uint16_t* offsets1, const uint16_t* freq1, int log_alpha_size,
    const uint8_t* context_map,
    const uint32_t* cfg_split, const uint32_t* cfg_msb,
    const uint32_t* cfg_lsb,
    int n_blocks, const int32_t* bx, const int32_t* by, const int32_t* cx,
    const int32_t* cy, const int32_t* log2cb, const int32_t* bsize,
    const int32_t* bctx, const int64_t* order_off,
    const int32_t* orders_flat, const int64_t* out_off,
    int bw, int bh, int ctx_offset, int shift, int num_ctxs,
    int32_t* nzeros_scratch, int32_t* out_flat) {
  BitReaderV br;
  br.data = data;
  br.size = data_size;
  uint64_t bitpos = *bitpos_io;
  br.pos = bitpos >> 3;
  br.buf = 0;
  br.bits = 0;
  {
    int rem = (int)(bitpos & 7);
    if (rem) vbr_read(&br, rem);
  }
  AnsTablesV t = {cutoff, right,   freq0,    offsets1, freq1,
                  log_alpha_size, context_map, cfg_split, cfg_msb, cfg_lsb};
  uint32_t state = *state_io;
  static const int kChanOrder[3] = {1, 0, 2};

  for (int i = 0; i < n_blocks; i++) {
    int bcx = cx[i], bcy = cy[i];
    int l2 = log2cb[i];
    int cb = bcx * bcy;
    int size = bsize[i];
    for (int ci = 0; ci < 3; ci++) {
      int c = kChanOrder[ci];
      const int32_t* order = orders_flat + order_off[(size_t)i * 3 + c];
      int32_t* acc = out_flat + out_off[i] + (int64_t)c * size;
      int32_t* nzmap = nzeros_scratch + (size_t)c * bh * bw;
      /* PredictFromTopAndLeft (entropy_coder.h:25-35) */
      int x = bx[i], y = by[i];
      int pred;
      if (x == 0) {
        pred = y > 0 ? nzmap[(size_t)(y - 1) * bw + x] : 32;
      } else if (y == 0) {
        pred = nzmap[(size_t)y * bw + x - 1];
      } else {
        pred = (nzmap[(size_t)(y - 1) * bw + x] +
                nzmap[(size_t)y * bw + x - 1] + 1) / 2;
      }
      int bc = bctx[(size_t)i * 3 + c];
      if (pred > 64) pred = 64;
      int nz_bucket = pred < 8 ? pred : 4 + pred / 2;
      int nz_ctx = ctx_offset + nz_bucket * num_ctxs + bc;
      uint32_t nzeros = v_read_hybrid_uint(&t, nz_ctx, &state, &br);
      if (nzeros > (uint32_t)(size - cb)) return 1;
      int nz_per_block = (int)((nzeros + cb - 1) >> l2);
      for (int yy = 0; yy < bcy; yy++)
        for (int xx = 0; xx < bcx; xx++)
          nzmap[(size_t)(y + yy) * bw + x + xx] = nz_per_block;
      int histo_offset =
          ctx_offset + num_ctxs * NONZERO_BUCKETS +
          ZERO_DENSITY_CONTEXT_COUNT * bc;
      int prev = nzeros > (uint32_t)(size / 16) ? 0 : 1;
      int k = cb;
      int32_t remaining = (int32_t)nzeros;
      while (k < size && remaining != 0) {
        int nzl = (remaining + cb - 1) >> l2;
        int zctx =
            (kCoeffNumNonzeroContext[nzl] + kCoeffFreqContext[k >> l2]) *
                2 +
            prev;
        if (zctx >= ZERO_DENSITY_CONTEXT_COUNT) return 1;
        int ctx = histo_offset + zctx;
        uint32_t u = v_read_hybrid_uint(&t, ctx, &state, &br);
        if (u >= (1u << 27)) return 1;
        int32_t coeff = (u & 1) ? -(int32_t)((u + 1) >> 1) : (int32_t)(u >> 1);
        if (coeff >= 0) {
          acc[order[k]] += coeff << shift;
        } else {
          acc[order[k]] -= (-coeff) << shift;
        }
        prev = u ? 1 : 0;
        remaining -= prev;
        k++;
      }
      if (remaining != 0) return 2;
    }
  }
  *state_io = state;
  *bitpos_io = ((uint64_t)br.pos << 3) - (uint64_t)br.bits;
  return 0;
}

/* ---- bulk auxiliary-stream readers (context maps, permutations) ----
 * These cover the host-side hot loops outside the AC image itself:
 * DecodeContextMap's per-entry reads and ReadPermutation's Lehmer
 * stream (coeff_order.cc:34-60, lehmer_code.h:61-99). Plain rANS only;
 * the Python caller falls back when LZ77/prefix is in play. */

static void vbr_init_at(BitReaderV* br, const uint8_t* data, size_t size,
                        uint64_t bitpos) {
  br->data = data;
  br->size = size;
  br->pos = bitpos >> 3;
  br->buf = 0;
  br->bits = 0;
  int rem = (int)(bitpos & 7);
  if (rem) (void)vbr_read(br, rem);
}

int ans_read_uints(const uint8_t* data, size_t size_bytes,
                   uint64_t* bitpos_io, uint32_t* state_io,
                   const uint16_t* cutoff, const uint16_t* right,
                   const uint16_t* freq0, const uint16_t* offsets1,
                   const uint16_t* freq1, int log_alpha_size,
                   const uint8_t* context_map, const uint32_t* cfg_split,
                   const uint32_t* cfg_msb, const uint32_t* cfg_lsb,
                   int n, int ctx, uint32_t* out) {
  BitReaderV br;
  vbr_init_at(&br, data, size_bytes, *bitpos_io);
  uint32_t state = *state_io;
  AnsTablesV t = {cutoff, right, freq0, offsets1, freq1, log_alpha_size,
                  context_map, cfg_split, cfg_msb, cfg_lsb};
  for (int i = 0; i < n; i++) {
    out[i] = v_read_hybrid_uint(&t, ctx, &state, &br);
  }
  *bitpos_io = ((uint64_t)br.pos << 3) - (uint64_t)br.bits;
  *state_io = state;
  return 0;
}

static int lehmer_decode_c(const uint32_t* code, uint32_t n, int32_t* out) {
  if (n == 0) return 0;
  int log2n = 0;
  if (n > 1) {
    log2n = 32 - __builtin_clz(n - 1);
    if (log2n < 1) log2n = 1;
  }
  uint32_t padded = 1u << log2n;
  uint32_t* temp = (uint32_t*)malloc((padded + 1) * sizeof(uint32_t));
  if (!temp) return -1;
  for (uint32_t i = 0; i < padded; i++) {
    uint32_t i1 = i + 1;
    temp[i] = i1 & (uint32_t)(-(int32_t)i1);
  }
  for (uint32_t i = 0; i < n; i++) {
    if (code[i] + i >= n) { free(temp); return 1; }
    uint32_t rank = code[i] + 1;
    uint32_t bit = padded, nxt = 0;
    for (int j = 0; j <= log2n; j++) {
      uint32_t cand = nxt + bit;
      bit >>= 1;
      if (temp[cand - 1] < rank) {
        nxt = cand;
        rank -= temp[cand - 1];
      }
    }
    out[i] = (int32_t)nxt;
    nxt += 1;
    while (nxt <= padded) {
      temp[nxt - 1] -= 1;
      nxt += nxt & (uint32_t)(-(int32_t)nxt);
    }
  }
  free(temp);
  return 0;
}

/* ReadPermutation (coeff_order.cc:34-60) of one permutation of `size`
 * with its first `skip` entries fixed, into out_perm. */
static int read_permutation_c(BitReaderV* br, uint32_t* state,
                              const AnsTablesV* t, uint32_t skip,
                              uint32_t size, int32_t* out_perm) {
  int size_ctx = size ? 32 - __builtin_clz(size) : 0;
  if (size_ctx > 7) size_ctx = 7;
  uint32_t end = v_read_hybrid_uint(t, size_ctx, state, br) + skip;
  if (end > size) return 2;
  uint32_t* lehmer = (uint32_t*)calloc(size, sizeof(uint32_t));
  if (!lehmer) return -1;
  uint32_t last = 0;
  for (uint32_t i = skip; i < end; i++) {
    int ctx = last ? 32 - __builtin_clz(last) : 0;
    if (ctx > 7) ctx = 7;
    lehmer[i] = v_read_hybrid_uint(t, ctx, state, br);
    last = lehmer[i];
    if (lehmer[i] >= size - i) { free(lehmer); return 3; }
  }
  int rc = lehmer_decode_c(lehmer, size, out_perm);
  free(lehmer);
  if (rc) return rc < 0 ? -1 : 4;
  return 0;
}

/* n permutations in a row from one ANS stream (the coefficient orders of
 * DecodeCoeffOrders, or one), the k-th of sizes[k] with skips[k] fixed,
 * written one after another into out_perm. */
int ans_read_permutations(const uint8_t* data, size_t size_bytes,
                          uint64_t* bitpos_io, uint32_t* state_io,
                          const uint16_t* cutoff, const uint16_t* right,
                          const uint16_t* freq0, const uint16_t* offsets1,
                          const uint16_t* freq1, int log_alpha_size,
                          const uint8_t* context_map,
                          const uint32_t* cfg_split, const uint32_t* cfg_msb,
                          const uint32_t* cfg_lsb, int n,
                          const uint32_t* skips, const uint32_t* sizes,
                          int32_t* out_perm) {
  BitReaderV br;
  vbr_init_at(&br, data, size_bytes, *bitpos_io);
  uint32_t state = *state_io;
  AnsTablesV t = {cutoff, right, freq0, offsets1, freq1, log_alpha_size,
                  context_map, cfg_split, cfg_msb, cfg_lsb};
  for (int k = 0; k < n; k++) {
    int rc = read_permutation_c(&br, &state, &t, skips[k], sizes[k],
                                out_perm);
    if (rc) return rc;
    out_perm += sizes[k];
  }
  *bitpos_io = ((uint64_t)br.pos << 3) - (uint64_t)br.bits;
  *state_io = state;
  return 0;
}

/* InverseMoveToFrontTransform (dec_context_map.cc:22-34). values are
 * indices < 256; transformed in place. */
int inverse_mtf(uint32_t* values, int n) {
  uint8_t mtf[256];
  for (int i = 0; i < 256; i++) mtf[i] = (uint8_t)i;
  for (int i = 0; i < n; i++) {
    uint32_t idx = values[i];
    if (idx >= 256) return 1;
    uint8_t val = mtf[idx];
    values[i] = val;
    memmove(mtf + 1, mtf, idx);
    mtf[0] = val;
  }
  return 0;
}

/* ---- the AC-global section (dec_frame.cc ProcessACGlobal) ----
 * Adaptive DC smoothing and the ANS histogram set of DecodeHistograms,
 * each one C call (vardct/frame.py adaptive_dc_smoothing,
 * entropy/decode.py decode_histograms). */

/* np.maximum: NaN in either argument propagates */
static inline double np_maximum(double a, double b) {
  return (a >= b || a != a) ? a : b;
}

/* one channel's row of the 3x3 weighted average into sm, and its
 * |dc - sm| / f folded into the row's largest over the channels so far
 * (the first channel's starts it) */
static inline void smooth_row(const double* restrict up,
                              const double* restrict mid,
                              const double* restrict dn, double f, int w,
                              int first, double* restrict sm,
                              double* restrict gap) {
  const double w1 = 0.20345139757231578;
  const double w2 = 0.0334829185968739;
  const double w0 = 1.0 - 4.0 * (w1 + w2);
  for (int x = 1; x + 1 < w; x++) {
    double corner = up[x - 1] + up[x + 1];
    corner = corner + dn[x - 1];
    corner = corner + dn[x + 1];
    double side = mid[x - 1] + mid[x + 1];
    side = side + up[x];
    side = side + dn[x];
    sm[x] = corner * w2 + side * w1 + mid[x] * w0;
    const double a = fabs((mid[x] - sm[x]) / f);
    gap[x] = first ? a : np_maximum(gap[x], a);
  }
}

/* AdaptiveDCSmoothing (compressed_dc.cc:46-196) over a (3, h, w) float64
 * DC, h, w > 2, into out: the NumPy body's operations in its order (no
 * FMA contraction), a row at a time, the borders copied. Returns 0, or
 * -1 without memory. */
int adaptive_dc_smoothing(const double* dc, int h, int w, const double* fac,
                          double* out) {
  const size_t plane = (size_t)h * (size_t)w;
  double* scratch = (double*)malloc(4 * (size_t)w * sizeof(double));
  if (!scratch) return -1;
  double* gap = scratch + 3 * (size_t)w;
  for (int c = 0; c < 3; c++) {
    const size_t last = c * plane + (size_t)(h - 1) * w;
    memcpy(out + c * plane, dc + c * plane, (size_t)w * sizeof(double));
    memcpy(out + last, dc + last, (size_t)w * sizeof(double));
  }
  for (int y = 1; y + 1 < h; y++) {
    for (int c = 0; c < 3; c++) {
      const double* up = dc + c * plane + (size_t)(y - 1) * w;
      if (c == 0)
        smooth_row(up, up + w, up + 2 * w, fac[c], w, 1, scratch, gap);
      else
        smooth_row(up, up + w, up + 2 * w, fac[c], w, 0,
                   scratch + (size_t)c * w, gap);
    }
    for (int x = 1; x + 1 < w; x++)
      gap[x] = np_maximum(0.0, -4.0 * np_maximum(0.5, gap[x]) + 3.0);
    for (int c = 0; c < 3; c++) {
      const double* restrict mid = dc + c * plane + (size_t)y * w;
      const double* restrict sm = scratch + (size_t)c * w;
      double* restrict o = out + c * plane + (size_t)y * w;
      o[0] = mid[0];
      for (int x = 1; x + 1 < w; x++)
        o[x] = mid[x] + (sm[x] - mid[x]) * gap[x];
      o[w - 1] = mid[w - 1];
    }
  }
  free(scratch);
  return 0;
}

#define ANS_MAX_ALPHABET_SIZE 256
#define HISTO_MAX_LENGTH 258 /* a general histogram's 255 + 3 entries */

/* the errors of the set's decode; entropy/decode.py names them */
enum {
  HISTO_OK = 0,
  HISTO_SIMPLE_CORRUPT,
  HISTO_BAD_SHIFT,
  HISTO_INVALID,
  HISTO_BAD_COUNT,
  HISTO_ALPHABET_TOO_LARGE,
  HISTO_TOO_LONG,
  HISTO_SUM_MISMATCH,
  HISTO_ALIAS_INVARIANT,
  HISTO_TABLE_TOO_LARGE,
};

static inline uint32_t vbr_peek(BitReaderV* br, int n) {
  if (br->bits < n) vbr_refill(br);
  return (uint32_t)(br->buf & ((1ull << n) - 1));
}

static inline int read_varlen_u8(BitReaderV* br) {
  if (!vbr_read(br, 1)) return 0;
  int nbits = (int)vbr_read(br, 3);
  if (nbits == 0) return 1;
  return (int)vbr_read(br, nbits) + (1 << nbits);
}

/* ans_common.h:27-33 */
static inline int population_count_precision(int logcount, int shift) {
  int r = shift - ((ANS_LOG_TAB_SIZE - logcount) >> 1);
  if (logcount < r) r = logcount;
  return r > 0 ? r : 0;
}

/* the static Huffman code of the log counts, indexed by 7 peeked bits:
 * (bits << 4) | value (dec_ans.cc:103-119) */
static const uint8_t kLogCountHuff[128] = {
    0x3a, 0x7c, 0x37, 0x43, 0x36, 0x38, 0x39, 0x45, 0x3a, 0x44, 0x37, 0x41,
    0x36, 0x38, 0x39, 0x42, 0x3a, 0x50, 0x37, 0x43, 0x36, 0x38, 0x39, 0x45,
    0x3a, 0x44, 0x37, 0x41, 0x36, 0x38, 0x39, 0x42, 0x3a, 0x6b, 0x37, 0x43,
    0x36, 0x38, 0x39, 0x45, 0x3a, 0x44, 0x37, 0x41, 0x36, 0x38, 0x39, 0x42,
    0x3a, 0x50, 0x37, 0x43, 0x36, 0x38, 0x39, 0x45, 0x3a, 0x44, 0x37, 0x41,
    0x36, 0x38, 0x39, 0x42, 0x3a, 0x7d, 0x37, 0x43, 0x36, 0x38, 0x39, 0x45,
    0x3a, 0x44, 0x37, 0x41, 0x36, 0x38, 0x39, 0x42, 0x3a, 0x50, 0x37, 0x43,
    0x36, 0x38, 0x39, 0x45, 0x3a, 0x44, 0x37, 0x41, 0x36, 0x38, 0x39, 0x42,
    0x3a, 0x6b, 0x37, 0x43, 0x36, 0x38, 0x39, 0x45, 0x3a, 0x44, 0x37, 0x41,
    0x36, 0x38, 0x39, 0x42, 0x3a, 0x50, 0x37, 0x43, 0x36, 0x38, 0x39, 0x45,
    0x3a, 0x44, 0x37, 0x41, 0x36, 0x38, 0x39, 0x42};

/* ReadHistogram (dec_ans.cc:51-185), entropy/histogram.py read_histogram
 * step for step: counts[0..*len) */
static int read_histogram_c(BitReaderV* br, int32_t* counts, int* len) {
  const int rng = ANS_TAB_SIZE;
  if (vbr_read(br, 1)) { /* simple code */
    int num_symbols = (int)vbr_read(br, 1) + 1;
    int sym[2] = {0, 0};
    for (int k = 0; k < num_symbols; k++) sym[k] = read_varlen_u8(br);
    int maxsym = num_symbols == 2 && sym[1] > sym[0] ? sym[1] : sym[0];
    *len = maxsym + 1;
    memset(counts, 0, (size_t)*len * sizeof(int32_t));
    if (num_symbols == 1) {
      counts[sym[0]] = rng;
    } else {
      if (sym[0] == sym[1]) return HISTO_SIMPLE_CORRUPT;
      counts[sym[0]] = (int32_t)vbr_read(br, ANS_LOG_TAB_SIZE);
      counts[sym[1]] = rng - counts[sym[0]];
    }
    return HISTO_OK;
  }
  if (vbr_read(br, 1)) { /* flat: create_flat_histogram */
    int n = read_varlen_u8(br) + 1;
    *len = n;
    for (int k = 0; k < n; k++) counts[k] = rng / n + (k < rng % n);
    return HISTO_OK;
  }
  /* general: an Elias-gamma-like shift, then the log counts */
  const int upper_bound_log = 3; /* floor(log2(ANS_LOG_TAB_SIZE + 1)) */
  int log = 0;
  while (log < upper_bound_log && vbr_read(br, 1)) log++;
  int shift = (int)(vbr_read(br, log) | (1u << log)) - 1;
  if (shift > ANS_LOG_TAB_SIZE + 1) return HISTO_BAD_SHIFT;
  int length = read_varlen_u8(br) + 3;
  uint8_t logcounts[HISTO_MAX_LENGTH];
  int same[HISTO_MAX_LENGTH];
  memset(logcounts, 0, sizeof(logcounts));
  memset(same, 0, sizeof(same));
  memset(counts, 0, (size_t)length * sizeof(int32_t));
  int omit_log = -1, omit_pos = -1;
  for (int i = 0; i < length;) {
    uint8_t e = kLogCountHuff[vbr_peek(br, 7)];
    (void)vbr_read(br, e >> 4);
    int val = e & 15;
    logcounts[i] = (uint8_t)val;
    if (val == ANS_LOG_TAB_SIZE + 1) { /* RLE */
      int rle_length = read_varlen_u8(br);
      same[i] = rle_length + 5;
      i += rle_length + 4;
      continue;
    }
    if (val > omit_log) {
      omit_log = val;
      omit_pos = i;
    }
    i++;
  }
  if (omit_pos < 0) return HISTO_INVALID;
  /* (read_histogram's check of logcounts[omit_pos + 1] against
   * ANS_TAB_SIZE + 1 never holds: a log count is at most 13) */
  int total = 0, prev = 0, numsame = 0;
  for (int i = 0; i < length; i++) {
    if (same[i]) {
      numsame = same[i] - 1;
      prev = i > 0 ? counts[i - 1] : 0;
    }
    if (numsame > 0) {
      counts[i] = prev;
      numsame--;
    } else {
      int code = logcounts[i];
      if (i == omit_pos || code == 0) {
        total += counts[i];
        continue;
      }
      if (code == 1) {
        counts[i] = 1;
      } else {
        int bitcount = population_count_precision(code - 1, shift);
        counts[i] = (1 << (code - 1)) +
                    (int32_t)(vbr_read(br, bitcount) << (code - 1 - bitcount));
      }
    }
    total += counts[i];
  }
  counts[omit_pos] = rng - total;
  if (counts[omit_pos] <= 0) return HISTO_BAD_COUNT;
  *len = length;
  return HISTO_OK;
}

/* InitAliasTable (ans_common.cc:55-158), entropy/alias.py
 * init_alias_table step for step: dist[0..len) (trailing zeros allowed)
 * into five rows of 1 << log_alpha_size entries, each `stride` apart:
 * cutoff, right_value, freq0, offsets1, freq1. */
static int init_alias_table_c(const int32_t* dist, int len,
                              int log_alpha_size, uint16_t* out,
                              size_t stride) {
  const int rng = ANS_TAB_SIZE;
  const int table_size = 1 << log_alpha_size;
  if (table_size > rng) return HISTO_TABLE_TOO_LARGE;
  while (len > 0 && dist[len - 1] == 0) len--;
  const int32_t full[1] = {rng};
  if (len == 0) {
    dist = full;
    len = 1;
  }
  if (len > table_size) return HISTO_TOO_LONG;
  const int entry_size = rng >> log_alpha_size;
  uint16_t* cutoff = out;
  uint16_t* right = out + stride;
  uint16_t* freq0 = out + 2 * stride;
  uint16_t* offsets1 = out + 3 * stride;
  uint16_t* freq1 = out + 4 * stride;
  memset(cutoff, 0, (size_t)table_size * sizeof(uint16_t));
  memset(right, 0, (size_t)table_size * sizeof(uint16_t));
  memset(freq0, 0, (size_t)table_size * sizeof(uint16_t));
  memset(offsets1, 0, (size_t)table_size * sizeof(uint16_t));
  memset(freq1, 0, (size_t)table_size * sizeof(uint16_t));
  int64_t sum = 0;
  int single_symbol = -1;
  for (int s = 0; s < len; s++) sum += dist[s];
  if (sum != rng) return HISTO_SUM_MISMATCH;
  for (int s = 0; s < len; s++)
    if (dist[s] == ANS_TAB_SIZE) single_symbol = s;
  if (single_symbol != -1) {
    for (int i = 0; i < table_size; i++) {
      right[i] = (uint16_t)single_symbol;
      offsets1[i] = (uint16_t)(entry_size * i);
      freq1[i] = ANS_TAB_SIZE;
    }
    return HISTO_OK;
  }
  int cutoffs[ANS_TAB_SIZE], underfull[ANS_TAB_SIZE], overfull[ANS_TAB_SIZE];
  int n_under = 0, n_over = 0;
  for (int i = 0; i < len; i++) {
    cutoffs[i] = dist[i];
    if (dist[i] > entry_size)
      overfull[n_over++] = i;
    else if (dist[i] < entry_size)
      underfull[n_under++] = i;
  }
  for (int i = len; i < table_size; i++) {
    cutoffs[i] = 0;
    underfull[n_under++] = i;
  }
  while (n_over > 0) {
    int over_i = overfull[--n_over];
    if (n_under == 0) return HISTO_ALIAS_INVARIANT;
    int under_i = underfull[--n_under];
    int underfull_by = entry_size - cutoffs[under_i];
    cutoffs[over_i] -= underfull_by;
    right[under_i] = (uint16_t)over_i;
    offsets1[under_i] = (uint16_t)cutoffs[over_i];
    if (cutoffs[over_i] < entry_size)
      underfull[n_under++] = over_i;
    else if (cutoffs[over_i] > entry_size)
      overfull[n_over++] = over_i;
  }
  for (int i = 0; i < table_size; i++) {
    if (cutoffs[i] == entry_size) {
      right[i] = (uint16_t)i;
      offsets1[i] = 0;
      cutoff[i] = 0;
    } else {
      offsets1[i] = (uint16_t)(offsets1[i] - cutoffs[i]);
      cutoff[i] = (uint16_t)cutoffs[i];
    }
    freq0[i] = (uint16_t)(i < len ? dist[i] : 0);
    int i1 = right[i];
    freq1[i] = (uint16_t)(i1 < len ? dist[i1] : 0);
  }
  return HISTO_OK;
}

/* n alias tables in one call: dist row k holds lens[k] entries, rows
 * dist_stride apart; out is (5, n, 1 << log_alpha_size). Returns 0, or
 * 1 + k with *err set for the first table k that fails. */
int init_alias_tables(const int32_t* dist, const int32_t* lens,
                      int dist_stride, int n, int log_alpha_size,
                      uint16_t* out, int* err) {
  const size_t size = (size_t)1 << log_alpha_size;
  for (int k = 0; k < n; k++) {
    int rc = init_alias_table_c(dist + (size_t)k * dist_stride, lens[k],
                                log_alpha_size, out + k * size, n * size);
    if (rc) {
      *err = rc;
      return 1 + k;
    }
  }
  return 0;
}

/* The ANS branch of DecodeHistograms (dec_ans.cc:336-370): n histograms
 * read from *bitpos_io on, each checked and turned into its alias table
 * before the next is read, as entropy/decode.py does. out is
 * (5, n, 1 << log_alpha_size); degenerate[k] is the histogram's one
 * symbol, or -1. Returns 0 (and the new bit position), or an error. */
int decode_ans_histograms(const uint8_t* data, size_t size_bytes,
                          uint64_t* bitpos_io, int n, int log_alpha_size,
                          uint16_t* out, int32_t* degenerate) {
  BitReaderV br;
  vbr_init_at(&br, data, size_bytes, *bitpos_io);
  const size_t size = (size_t)1 << log_alpha_size;
  int32_t counts[HISTO_MAX_LENGTH];
  for (int k = 0; k < n; k++) {
    int len = 0;
    int rc = read_histogram_c(&br, counts, &len);
    if (rc) return rc;
    if (len > ANS_MAX_ALPHABET_SIZE) return HISTO_ALPHABET_TOO_LARGE;
    while (len > 0 && counts[len - 1] == 0) len--;
    int deg = len > 0 ? len - 1 : 0;
    for (int s = 0; s < deg; s++) {
      if (counts[s] != 0) {
        deg = -1;
        break;
      }
    }
    degenerate[k] = deg;
    rc = init_alias_table_c(counts, len, log_alpha_size, out + k * size,
                            n * size);
    if (rc) return rc;
  }
  *bitpos_io = ((uint64_t)br.pos << 3) - (uint64_t)br.bits;
  return HISTO_OK;
}

/* Native hot loop: VarDCT AC-coefficient tokenization (encoder).
 *
 * Mirrors TokenizeCoefficients (lib/jxl/enc_entropy_coder.cc:148) with
 * the same context model the decoder in vardct_decode.c walks: per
 * block, the nonzero count in a context predicted from top/left, then
 * the zero-density chain through the last nonzero coefficient, reading
 * values through the per-strategy coefficient-order LUT.
 *
 * Emits flat (context, value) token streams per AC group; the Python
 * side builds histograms with one bincount and writes the rANS bytes
 * with native/ans_write.c. Groups are independent, so tokenization
 * stripes over a pthread pool exactly like decode_ac_image.
 */

#include <stdint.h>
#include <stddef.h>
#include <stdlib.h>
#include <string.h>
#include <pthread.h>

/* ac_context.h:24-45 (shared with vardct_decode.c's copies) */
static const int32_t kEncCoeffFreqContext[64] = {
    0xBAD, 0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14,
    15,    15, 16, 16, 17, 17, 18, 18, 19, 19, 20, 20, 21, 21, 22, 22,
    23,    23, 23, 23, 24, 24, 24, 24, 25, 25, 25, 25, 26, 26, 26, 26,
    27,    27, 27, 27, 28, 28, 28, 28, 29, 29, 29, 29, 30, 30, 30, 30};

static const int32_t kEncCoeffNumNonzeroContext[64] = {
    0xBAD, 0,   31,  62,  62,  93,  93,  93,  93,  123, 123, 123, 123,
    152,   152, 152, 152, 152, 152, 152, 152, 180, 180, 180, 180, 180,
    180,   180, 180, 180, 180, 180, 180, 206, 206, 206, 206, 206, 206,
    206,   206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206,
    206,   206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206};

#define ENC_NONZERO_BUCKETS 37
#define ENC_ZERO_DENSITY_CTX 458

typedef struct {
  int xsize_groups, ysize_groups, group_dim_blocks;
  const int32_t* strategy;
  const uint8_t* origin;
  const int32_t* qf;
  int nby, nbx;
  const int32_t* bctx_lut;
  const int64_t* qf_thr;
  int nqf;
  const int64_t* ord_img_off;
  const int32_t* ord_img_flat;
  const int32_t* cov_x;
  const int32_t* cov_y;
  const int32_t* log2cb;
  const int32_t* ord_lut;
  int num_ctxs, W;
  const int32_t* planes[3];
  int32_t* out_ctx;
  uint32_t* out_u;
  int64_t group_cap;
  int64_t* group_len; /* [n_groups] token count written per group */
} TokCtx;

/* Tokenize one group into its out slot. Returns token count, or -1 on
 * capacity overflow (caller sized the buffer too small). */
static int64_t tokenize_one_group(const TokCtx* tc, int g,
                                  int32_t* nzmap) {
  static const int kChanOrder[3] = {1, 0, 2};
  int gdim = tc->group_dim_blocks;
  int gx = g % tc->xsize_groups;
  int gy = g / tc->xsize_groups;
  int bx0 = gx * gdim, by0 = gy * gdim;
  int bw = tc->nbx - bx0;
  if (bw > gdim) bw = gdim;
  int bh = tc->nby - by0;
  if (bh > gdim) bh = gdim;
  memset(nzmap, 0, sizeof(int32_t) * 3 * bh * bw);
  int32_t* ctx_out = tc->out_ctx + (int64_t)g * tc->group_cap;
  uint32_t* u_out = tc->out_u + (int64_t)g * tc->group_cap;
  int64_t n = 0;
  int nqf = tc->nqf, num_ctxs = tc->num_ctxs, W = tc->W, nbx = tc->nbx;

  for (int by = 0; by < bh; by++) {
    for (int bx = 0; bx < bw; bx++) {
      int aby = by0 + by, abx = bx0 + bx;
      if (!tc->origin[(size_t)aby * nbx + abx]) continue;
      int s = tc->strategy[(size_t)aby * nbx + abx];
      int bcx = tc->cov_x[s], bcy = tc->cov_y[s];
      int l2 = tc->log2cb[s];
      int cb = bcx * bcy;
      int size = cb * 64;
      int ord = tc->ord_lut[s];
      int quant = tc->qf[(size_t)aby * nbx + abx];
      int qfi = 0;
      while (qfi < nqf && quant > tc->qf_thr[qfi]) qfi++;
      int64_t base_px = (int64_t)aby * 8 * W + (int64_t)abx * 8;
      if (n + 3 * (int64_t)(size - cb + 1) > tc->group_cap) return -1;
      for (int ci = 0; ci < 3; ci++) {
        int c = kChanOrder[ci];
        int cidx = c < 2 ? (c ^ 1) : 2;
        int bc =
            tc->bctx_lut[((size_t)cidx * 13 + ord) * (nqf + 1) + qfi];
        const int32_t* oimg =
            tc->ord_img_flat + tc->ord_img_off[(size_t)s * 3 + c];
        const int32_t* acc = tc->planes[c] + base_px;
        int32_t* nzm = nzmap + (size_t)c * bh * bw;
        /* count nonzeros past the LLF slots and find the last one */
        int nzeros = 0, last = cb - 1;
        for (int k = cb; k < size; k++) {
          if (acc[oimg[k]] != 0) {
            nzeros++;
            last = k;
          }
        }
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
        ctx_out[n] = nz_bucket * num_ctxs + bc;
        u_out[n] = (uint32_t)nzeros;
        n++;
        int nz_per_block = (nzeros + cb - 1) >> l2;
        for (int yy = 0; yy < bcy; yy++)
          for (int xx = 0; xx < bcx; xx++)
            nzm[(size_t)(by + yy) * bw + bx + xx] = nz_per_block;
        if (nzeros == 0) continue;
        int histo_offset = num_ctxs * ENC_NONZERO_BUCKETS +
                           ENC_ZERO_DENSITY_CTX * bc;
        int prev = nzeros > size / 16 ? 0 : 1;
        int32_t remaining = nzeros;
        for (int k = cb; k <= last; k++) {
          int32_t v = acc[oimg[k]];
          uint32_t u =
              v >= 0 ? ((uint32_t)v << 1) : (((uint32_t)(-v)) << 1) - 1;
          int nzl = (remaining + cb - 1) >> l2;
          ctx_out[n] = histo_offset +
                       (kEncCoeffNumNonzeroContext[nzl] +
                        kEncCoeffFreqContext[k >> l2]) * 2 + prev;
          u_out[n] = u;
          n++;
          prev = v != 0;
          remaining -= prev;
        }
      }
    }
  }
  return n;
}

typedef struct {
  const TokCtx* tc;
  int tid, nthreads, n_groups;
  int err;
} TokWorker;

static void* tok_worker_run(void* arg) {
  TokWorker* w = (TokWorker*)arg;
  const TokCtx* tc = w->tc;
  int gdim = tc->group_dim_blocks;
  int32_t* nzmap =
      (int32_t*)malloc(sizeof(int32_t) * 3 * (size_t)gdim * gdim);
  if (!nzmap) {
    w->err = 9999;
    return NULL;
  }
  w->err = 0;
  for (int g = w->tid; g < w->n_groups; g += w->nthreads) {
    int64_t n = tokenize_one_group(tc, g, nzmap);
    if (n < 0) {
      w->err = 1000 + g;
      break;
    }
    tc->group_len[g] = n;
  }
  free(nzmap);
  return NULL;
}

int tokenize_ac_image(
    int xsize_groups, int ysize_groups, int group_dim_blocks,
    const int32_t* strategy, const uint8_t* origin, const int32_t* qf,
    int nby, int nbx,
    const int32_t* bctx_lut, const int64_t* qf_thr, int nqf,
    const int64_t* ord_img_off, const int32_t* ord_img_flat,
    const int32_t* cov_x, const int32_t* cov_y, const int32_t* log2cb,
    const int32_t* ord_lut, int num_ctxs, int W,
    const int32_t* q0, const int32_t* q1, const int32_t* q2,
    int32_t* out_ctx, uint32_t* out_u, int64_t group_cap,
    int64_t* group_len, int n_threads) {
  int n_groups = xsize_groups * ysize_groups;
  TokCtx tc = {xsize_groups, ysize_groups, group_dim_blocks,
               strategy, origin, qf, nby, nbx, bctx_lut, qf_thr, nqf,
               ord_img_off, ord_img_flat, cov_x, cov_y, log2cb, ord_lut,
               num_ctxs, W, {q0, q1, q2}, out_ctx, out_u, group_cap,
               group_len};
  int rc = 0;
  if (n_threads > n_groups) n_threads = n_groups;
  if (n_threads > 1) {
    enum { kMaxThreads = 64 };
    if (n_threads > kMaxThreads) n_threads = kMaxThreads;
    pthread_t tids[kMaxThreads];
    TokWorker workers[kMaxThreads];
    int spawned = 0;
    for (int i = 0; i < n_threads; i++) {
      workers[i].tc = &tc;
      workers[i].tid = i;
      workers[i].nthreads = n_threads;
      workers[i].n_groups = n_groups;
      workers[i].err = 0;
      if (i == 0) continue;
      if (pthread_create(&tids[i], NULL, tok_worker_run, &workers[i])) {
        workers[i].err = -1;
        break;
      }
      spawned = i;
    }
    tok_worker_run(&workers[0]);
    for (int i = 1; i <= spawned; i++) pthread_join(tids[i], NULL);
    for (int i = 0; i <= spawned; i++) {
      if (workers[i].err > 0 && (rc == 0 || workers[i].err < rc))
        rc = workers[i].err;
    }
    if (spawned + 1 < n_threads && rc == 0) {
      int32_t* nzmap = (int32_t*)malloc(
          sizeof(int32_t) * 3 * (size_t)group_dim_blocks *
          group_dim_blocks);
      if (!nzmap) rc = 9999;
      for (int i = spawned + 1; nzmap && i < n_threads; i++) {
        for (int g = i; g < n_groups && rc == 0; g += n_threads) {
          int64_t n = tokenize_one_group(&tc, g, nzmap);
          if (n < 0) rc = 1000 + g;
          else tc.group_len[g] = n;
        }
      }
      free(nzmap);
    }
  } else {
    int32_t* nzmap = (int32_t*)malloc(
        sizeof(int32_t) * 3 * (size_t)group_dim_blocks *
        group_dim_blocks);
    if (!nzmap) return 9999;
    for (int g = 0; g < n_groups; g++) {
      int64_t n = tokenize_one_group(&tc, g, nzmap);
      if (n < 0) {
        rc = 1000 + g;
        break;
      }
      tc.group_len[g] = n;
    }
    free(nzmap);
  }
  return rc;
}

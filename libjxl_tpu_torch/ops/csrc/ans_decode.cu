// rANS decode of the DCT8 AC token streams of a frame batch into a step
// tape: one thread per AC group ("lane"), one symbol per lane per step.
//
// Replaces the TPU kernel K3, libjxl_tpu/ops/ans_kernel.py _make_kernel
// (driven by _driver_fn's pallas_call). It computes what that kernel
// computes, step for step, so the tape is the same word for word: tape[t,
// lane] is the token of the lane's step t, with bit 30 set on a chain
// start (the nzeros token), and 0 once the lane has stopped. Plain twin:
// libjxl_tpu_torch/ops/ans_kernel.py ans_decode_plain.
//
// Bound on the H100: latency. A lane's steps are one serial chain (the
// rANS state, the bit position and the context of step t come out of step
// t-1), and a batch of 16 2048^2 frames gives only 1024 lanes. The bytes
// are small: 4 B of tape a lane-step, ~2-3 B of stream.
// Design: take device memory out of the chain and shorten the chain.
// - A CTA is one warp that decodes up to kLanes lanes of ONE image (the
//   host's CTA table cta_first; kLanes is ops/build.CTA_LANES = 2): 1024
//   lanes give 512 warps, about one a scheduler of the card's 528, and a
//   warp whose lanes diverge runs both sides of a branch, so few lanes a
//   warp run fewer instructions a step (the sweep of 32, 8, 4, 2 and 1
//   lanes a CTA in PERF.md). All 32 threads stage the tables; the lanes'
//   own shared memory (ring and row file) is sized by kLanes.
// - The CTA stages its image's tables in shared memory: the alias words
//   a1/a2 interleaved as one 64-bit entry, the nzeros and zero-density
//   cluster bytes, kz, and first_s (the cluster of a chain's first
//   coefficient). The nzeros row file is a 96-byte slot a lane. ans_tpu's
//   cap of 2048 alias words keeps the whole under 20 KB.
// - The stream reaches a lane through a ring of 16 16-byte chunks in
//   shared memory that cp.async tops up every kTopUp steps, at the same
//   step in all lanes (ans_ring.cuh), so the bit buffer refills from
//   shared memory, branch-free, and the copies' bookkeeping runs once in
//   16 steps.
// - Of the next step's four possible clusters, the three that do not
//   depend on this step's token (a zero coefficient, a nonzero one, the
//   next block's nzeros context) are looked up while this step decodes,
//   and their alias entries as soon as the next rANS state is known, so
//   the chain of a step holds one select where a step that looks its
//   tables up in order holds four dependent loads. The hybrid-uint decode
//   and the token's bookkeeping are selects.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ans_ring.cuh"

namespace {

using namespace jxl_ans;

constexpr int kAnsLog = 12;
constexpr uint32_t kAnsSignature = 0x13u << 16;
constexpr int kMarker = 1 << 30;
constexpr int kTapeVal = kMarker - 1;
constexpr int kNonzeroBuckets = 37;
constexpr int kZdCount = 458;
constexpr int kNzWidth = 3 * kNonzeroBuckets;  // nzclu bytes an image
constexpr int kZdWidth = 3 * kZdCount;         // zdclu bytes an image
constexpr int kCols = 32;                      // block columns of a group
constexpr int kThreads = 32;  // a CTA: one warp, at most 32 lanes

// Shared memory past the alias words (8 B an entry): a stream ring and 96
// row-file bytes a lane, then kz, the cluster bytes and first_s. Every
// part is a multiple of 16 bytes, so the rings are aligned for cp.async.
constexpr int kRowLaneBytes = 3 * kCols;                         // 96
constexpr int kKzBytes = 128 * 4;                                // 512
constexpr int kCluBytes = (kNzWidth + kZdWidth + 15) / 16 * 16;  // 1488
constexpr int kFirstBytes = 3 * 64 * 2;                          // 384

__host__ __device__ constexpr size_t alias_bytes(int alias_words) {
  return (8 * (size_t)alias_words + 15) / 16 * 16;
}

__host__ __device__ constexpr size_t smem_bytes(int alias_words) {
  return alias_bytes(alias_words) +
         (size_t)kLanes * (kRingLaneBytes + kRowLaneBytes) + kKzBytes +
         kCluBytes + kFirstBytes;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(kThreads)
ans_decode_kernel(const uint16_t* __restrict__ flat, long long total,
                  const long long* __restrict__ lane_off,
                  const int* __restrict__ n_chains,
                  const int* __restrict__ bw_lane,
                  const int* __restrict__ lane_img,
                  const uint32_t* __restrict__ a1,
                  const uint32_t* __restrict__ a2,
                  const uint8_t* __restrict__ nzclu,
                  const uint8_t* __restrict__ zdclu,
                  const int* __restrict__ kz, int alias_words, int las,
                  int L, int t_alloc, const int* __restrict__ cta_first,
                  int* __restrict__ tape, bool* __restrict__ ok_out,
                  int* __restrict__ steps_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint2* alias_s = reinterpret_cast<uint2*>(smem);  // (a1, a2) an entry
  uint16_t* ring_s =
      reinterpret_cast<uint16_t*>(smem + alias_bytes(alias_words));
  int* kz_s = reinterpret_cast<int*>(ring_s + kLanes * kRingStride);
  uint8_t* rows_s = reinterpret_cast<uint8_t*>(kz_s + 128);
  // nzclu bytes, then zdclu bytes
  uint8_t* clu_s = rows_s + kLanes * kRowLaneBytes;
  // first_s[j * 64 + u]: the cluster of a chain's first coefficient after
  // an nzeros token u in channel j, with bit 8 set if its context is out
  // of range
  uint16_t* first_s = reinterpret_cast<uint16_t*>(clu_s + kCluBytes);

  const int tid = threadIdx.x;
  const int lane0 = cta_first[blockIdx.x];
  const int n_here = cta_first[blockIdx.x + 1] - lane0;
  const int img = lane_img[lane0];  // every lane of the CTA is this image's

  // stage the image's tables; every thread takes part, lanes or not
  {
    const uint32_t* A1 = a1 + (size_t)img * alias_words;
    const uint32_t* A2 = a2 + (size_t)img * alias_words;
    for (int i = tid; i < alias_words; i += kThreads)
      alias_s[i] = make_uint2(__ldg(A1 + i), __ldg(A2 + i));
    for (int i = tid; i < 128; i += kThreads) kz_s[i] = __ldg(kz + i);
    const uint8_t* NZ = nzclu + (size_t)img * kNzWidth;
    const uint8_t* ZD = zdclu + (size_t)img * kZdWidth;
    for (int i = tid; i < kNzWidth; i += kThreads) clu_s[i] = __ldg(NZ + i);
    for (int i = tid; i < kZdWidth; i += kThreads)
      clu_s[kNzWidth + i] = __ldg(ZD + i);
  }
  __syncthreads();
  // the cluster of the zero-density context (rem, k, prev) of channel jj;
  // bad: the context is out of range (a corrupt stream)
  auto zd_cluster = [&](int jj, int rem_, int k_, int prev_, bool& bad) {
    const int zctx =
        (kz_s[clampi(rem_, 0, 63)] + kz_s[64 + clampi(k_, 0, 63)]) * 2 +
        prev_;
    bad = zctx >= kZdCount;
    return (int)clu_s[kNzWidth + clampi(jj * kZdCount + zctx, 0,
                                        kZdWidth - 1)];
  };
  for (int e = tid; e < 3 * 64; e += kThreads) {
    bool bad;
    const int u = e & 63;
    const int c = zd_cluster(e >> 6, u, 1, u > 4 ? 0 : 1, bad);
    first_s[e] = (uint16_t)(c | (bad << 8));
  }
  __syncthreads();
  if (tid >= n_here) return;

  const int lane = lane0 + tid;
  const int nch = n_chains[lane];
  const int bw = bw_lane[lane];
  const int les = kAnsLog - las;
  uint8_t* rows = rows_s + tid * kRowLaneBytes;  // the lane's row file
#pragma unroll
  for (int i = 0; i < 3 * kCols; ++i) rows[i] = 0;

  StreamRing ring(ring_s + tid * kRingStride, flat, total, lane_off[lane]);
  uint32_t st = ring.peek2();
  ring.skip(2);
  uint64_t buf = 0;  // LSB-first bit buffer, cnt valid bits
  int cnt = 0;

  // the cluster of the nzeros context of block (jj, bxx, byy): its
  // predictor from the row file
  auto nz_cluster = [&](int jj, int bxx, int byy) {
    const int ridx = jj * kCols + bxx;
    const int top = rows[ridx];
    const int left = rows[ridx - (bxx > 0)];
    int pred = bxx == 0 ? (byy == 0 ? 32 : top)
                        : (byy == 0 ? left : (top + left + 1) >> 1);
    pred = pred < 64 ? pred : 64;
    return (int)clu_s[jj * kNonzeroBuckets +
                      (pred < 8 ? pred : 4 + (pred >> 1))];
  };

  // the alias entry of cluster `clu` for the rANS state `s`
  auto entry = [&](int clu, uint32_t s) {
    const int i_b = (int)((s & 0xFFFu) >> les);
    return alias_s[clampi((clu << las) | i_b, 0, alias_words - 1)];
  };

  int mode = 0, k = 0, rem = 0, prev = 0, j = 0, bx = 0, by = 0, chain = 0;
  bool done = nch == 0, corrupt = false;
  // this step's alias entry, found during the step before, and whether
  // its zero-density context is out of range
  uint2 w = entry(nz_cluster(0, 0, 0), st);
  bool zbad = false;

  int t = 0;
  for (; t < t_alloc && !done && !corrupt; ++t) {
    ring.before_step(t);
    // a step consumes at most 32 bits (build_lane_plan's gate): refill to
    // 32 or more, a halfword at a time, as selects
    {
      const uint32_t two = ring.peek2();
      const int n = cnt < 16 ? 2 : (cnt < 32 ? 1 : 0);  // halfwords taken
      const uint32_t take = n == 2 ? two : (n == 1 ? two & 0xFFFF : 0);
      buf |= (uint64_t)take << (cnt & 63);
      ring.skip(n);
      cnt += 16 * n;
    }
    const bool is_nz = mode == 0;
    if (!is_nz && zbad) {
      corrupt = true;  // the step decodes nothing and is not counted
      break;
    }

    // The next step's cluster is one of four, and three of them do not
    // depend on this step's token: look them up now, beside this step's
    // chain, and their alias entries as soon as the next state is known.
    // A zero coefficient keeps (rem, k + 1, prev 0), a nonzero one gives
    // (rem - 1, k + 1, prev 1) (DCT8: nonzeros left = rem, k as it is),
    // and an ended chain opens the next block's nzeros context (the row
    // file bytes it reads are not the one this step may write). The
    // fourth, a chain's first coefficient, is first_s's after the token.
    const bool lastj = j == 2;
    const bool lastx = lastj && bx + 1 == bw;
    const int jn = lastj ? 0 : j + 1;
    const int bxn = lastj ? (lastx ? 0 : bx + 1) : bx;
    const int byn = by + lastx;
    bool bad0, bad1;
    const int clu0 = zd_cluster(j, rem, k + 1, 0, bad0);
    const int clu1 = zd_cluster(j, rem - 1, k + 1, 1, bad1);
    const int clun = nz_cluster(jn, bxn, byn);

    // rANS symbol through the alias table
    const uint32_t res = st & 0xFFFu;
    const int i_b = (int)(res >> les);
    const int p = (int)(res & ((1u << les) - 1));
    const uint32_t w1 = w.x, w2 = w.y;
    const int cutoff = w1 & 255;
    const int right = (w1 >> 8) & 63;
    const uint32_t freq0 = (w1 >> 14) & 0x1FFF;
    const int se = (w1 >> 27) & 7;
    const int msb = (w1 >> 30) & 3;
    const uint32_t freq1 = w2 & 0x1FFF;
    const uint32_t off1 = (w2 >> 13) & 0xFFF;
    const int lsb = (w2 >> 25) & 3;
    const bool ge = p >= cutoff;
    const int sym = ge ? right : i_b;
    st = (ge ? freq1 : freq0) * (st >> kAnsLog) + (ge ? off1 + p : p);
    const bool renorm = (st >> 16) == 0;
    st = renorm ? (st << 16) | (uint32_t)(buf & 0xFFFF) : st;
    const int used = renorm ? 16 : 0;
    buf >>= used;
    cnt -= used;
    const uint2 e0 = entry(clu0, st), e1 = entry(clu1, st),
                en = entry(clun, st);

    // hybrid uint, as selects: nbits is 0 for a token below the split
    const int split = 1 << se;
    const bool small = sym < split;
    const int ml = msb + lsb;
    int nbits = se - ml + ((sym - split) >> ml);
    nbits = small ? 0 : (nbits > 0 ? nbits : 0);
    const int raw = (int)(buf & ((1ull << nbits) - 1));
    buf >>= nbits;
    cnt -= nbits;
    const int tok2 = sym >> lsb;
    const int big =
        ((((1 << msb) | (tok2 & ((1 << msb) - 1))) << nbits) | raw) << lsb |
        (sym & ((1 << lsb) - 1));
    const int u = small ? sym : big;
    const int uv = u < kTapeVal ? u : kTapeVal;
    tape[(size_t)t * L + lane] = is_nz ? (kMarker | uv) : uv;

    // the token's bookkeeping: an nzeros token opens a chain (or ends an
    // empty one), a coefficient token counts down its nonzeros
    const bool nz_ok = is_nz && u <= 63;
    const bool co_ok = !is_nz && u < (1 << 27);
    const int nzf = co_ok && u != 0;
    if (nz_ok) rows[j * kCols + bx] = (uint8_t)u;
    prev = nz_ok ? (u > 4 ? 0 : 1) : (co_ok ? nzf : prev);
    rem = nz_ok ? u : rem - nzf;
    k = nz_ok ? 1 : k + co_ok;
    mode = nz_ok && u != 0 ? 1 : mode;
    const bool adv = nz_ok ? u == 0 : co_ok && rem == 0;
    corrupt = !(nz_ok || co_ok) || (co_ok && rem != 0 && k >= 64);

    // the next step's alias entry
    if (adv) {
      w = en;
    } else if (is_nz) {
      const int f = first_s[j * 64 + (u < 63 ? u : 63)];
      w = entry(f & 255, st);
      zbad = f >> 8;
    } else {
      w = nzf ? e1 : e0;
      zbad = nzf ? bad1 : bad0;
    }

    // chain advance over (j, bx, by): the DCT8 raster of the group
    chain += adv;
    mode = adv ? 0 : mode;
    j = adv ? jn : j;
    bx = adv ? bxn : bx;
    by = adv ? byn : by;
    done = adv && chain >= nch;
  }
  ok_out[lane] = done && !corrupt && (st == kAnsSignature || nch == 0);
  steps_out[lane] = t;  // steps that decoded a symbol
  ring.drain();
}

}  // namespace

// flat: u16 halfwords of every lane's stream [total], 16-byte aligned;
// lane_off i64 [L]; n_chains, bw, lane_img int32 [L]; a1/a2 u32 [B,
// alias_words]; nzclu u8 [B, 3*37]; zdclu u8 [B, 3*458]; kz int32 [128];
// cta_first int32 [n_cta + 1]: CTA b decodes lanes cta_first[b] ..
// cta_first[b+1] - 1, at most kLanes, all of one image; tape int32
// [t_alloc, L], zero-filled by the caller; ok bool [L]; steps int32 [L].
// Launches on `stream` and returns cudaGetLastError() (or the error of
// raising the kernel's shared-memory limit).
extern "C" int jxl_ans_decode(const void* flat, long long total,
                              const long long* lane_off, const int* n_chains,
                              const int* bw, const int* lane_img,
                              const void* a1, const void* a2,
                              const void* nzclu, const void* zdclu,
                              const int* kz, int alias_words, int las, int L,
                              int t_alloc, const int* cta_first, int n_cta,
                              int* tape, void* ok, int* steps, void* stream,
                              int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(alias_words);
  err = cudaFuncSetAttribute(ans_decode_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  ans_decode_kernel<<<n_cta, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint16_t*)flat, total, lane_off, n_chains, bw, lane_img,
      (const uint32_t*)a1, (const uint32_t*)a2, (const uint8_t*)nzclu,
      (const uint8_t*)zdclu, kz, alias_words, las, L, t_alloc, cta_first,
      tape, (bool*)ok, steps);
  return (int)cudaGetLastError();
}

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
// Bound on the H100: latency. Each step is a serial chain of dependent
// loads (predictor row -> cluster table -> alias table -> state -> bit
// reads) of a few hundred cycles, and a batch of 16 2048^2 frames gives
// only 1024 lanes: 32 one-warp CTAs on 32 of the 132 SMs. The bytes are
// small: ~4 B of tape a lane-step, ~2-3 B of stream.
// Design: what held the TPU back does not exist here. The TPU re-gathered
// a 256-halfword window per lane between calls and pulled halfwords
// through a 15-select ladder, because a TPU lane cannot index private
// memory; here each thread reads its own halfwords from device memory
// into a 64-bit bit buffer, and indexes its 3x32-byte nzeros row file in
// local memory. Small CTAs of 32 threads spread the lanes over as many
// SMs as possible. The entropy tables (~16 KB of alias words an image)
// are read through lane_img from device memory, where L1 and L2 hold
// them. Lanes of a warp write neighbouring tape words at the same step.
// Shared-memory tables, several lanes per thread and a fused placement
// are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAnsLog = 12;
constexpr uint32_t kAnsSignature = 0x13u << 16;
constexpr int kMarker = 1 << 30;
constexpr int kTapeVal = kMarker - 1;
constexpr int kNonzeroBuckets = 37;
constexpr int kZdCount = 458;
constexpr int kNzWidth = 3 * kNonzeroBuckets;  // nzclu bytes an image
constexpr int kZdWidth = 3 * kZdCount;         // zdclu bytes an image
constexpr int kCols = 32;                      // block columns of a group
constexpr int kThreads = 32;

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
                  int L, int t_alloc, int* __restrict__ tape,
                  bool* __restrict__ ok_out, int* __restrict__ steps_out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const int img = lane_img[lane];
  const int nch = n_chains[lane];
  const int bw = bw_lane[lane];
  const uint32_t* A1 = a1 + (size_t)img * alias_words;
  const uint32_t* A2 = a2 + (size_t)img * alias_words;
  const uint8_t* NZ = nzclu + (size_t)img * kNzWidth;
  const uint8_t* ZD = zdclu + (size_t)img * kZdWidth;
  const int les = kAnsLog - las;
  const long long last = total - 1;

  // reads past the end clamp to the last halfword, as the JAX driver's
  // window gather does
  long long pos = lane_off[lane];
  auto hw = [&](long long p) -> uint64_t {
    return (uint64_t)flat[p < last ? p : last];
  };
  uint32_t st = (uint32_t)(hw(pos) | (hw(pos + 1) << 16));
  pos += 2;
  uint64_t buf = 0;  // LSB-first bit buffer, cnt valid bits
  int cnt = 0;

  uint8_t rows[3 * kCols];  // latest nzeros per (channel j, block column)
#pragma unroll
  for (int i = 0; i < 3 * kCols; ++i) rows[i] = 0;
  int mode = 0, k = 0, rem = 0, prev = 0, j = 0, bx = 0, by = 0, chain = 0;
  bool done = nch == 0, corrupt = false;

  int t = 0;
  for (; t < t_alloc && !done && !corrupt; ++t) {
    // a step consumes at most 32 bits (build_lane_plan's gate)
    while (cnt < 32) {
      buf |= hw(pos++) << cnt;
      cnt += 16;
    }
    const bool is_nz = mode == 0;

    // nzeros predictor and its cluster
    const int top = rows[j * kCols + bx];
    const int left = rows[j * kCols + (bx > 0 ? bx - 1 : 0)];
    int pred = bx == 0 ? (by == 0 ? 32 : top)
                       : (by == 0 ? left : (top + left + 1) >> 1);
    pred = pred < 64 ? pred : 64;
    const int nzb = pred < 8 ? pred : 4 + (pred >> 1);

    // zero-density context (DCT8: nonzeros left = rem, k as it is)
    const int zctx = (kz[clampi(rem, 0, 63)] + kz[64 + clampi(k, 0, 63)]) * 2 +
                     prev;
    if (!is_nz && zctx >= kZdCount) {
      corrupt = true;  // the step decodes nothing and is not counted
      break;
    }
    const int cluster =
        is_nz ? NZ[j * kNonzeroBuckets + nzb]
              : ZD[clampi(j * kZdCount + zctx, 0, kZdWidth - 1)];

    // rANS symbol through the alias table
    const uint32_t res = st & 0xFFFu;
    const int i_b = (int)(res >> les);
    const int p = (int)(res & ((1u << les) - 1));
    const int ai = clampi((cluster << las) | i_b, 0, alias_words - 1);
    const uint32_t w1 = A1[ai];
    const uint32_t w2 = A2[ai];
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
    if ((st >> 16) == 0) {
      st = (st << 16) | (uint32_t)(buf & 0xFFFF);
      buf >>= 16;
      cnt -= 16;
    }

    // hybrid uint
    const int split = 1 << se;
    int u = sym;
    if (sym >= split) {
      const int ml = msb + lsb;
      int nbits = se - ml + ((sym - split) >> ml);
      nbits = nbits > 0 ? nbits : 0;
      const int raw = (int)(buf & ((1ull << nbits) - 1));
      buf >>= nbits;
      cnt -= nbits;
      const int tok2 = sym >> lsb;
      u = ((((1 << msb) | (tok2 & ((1 << msb) - 1))) << nbits) | raw) << lsb |
          (sym & ((1 << lsb) - 1));
    }
    const int uv = u < kTapeVal ? u : kTapeVal;
    tape[(size_t)t * L + lane] = is_nz ? (kMarker | uv) : uv;

    bool adv = false;
    if (is_nz) {
      if (u > 63) {
        corrupt = true;
      } else {
        rows[j * kCols + bx] = (uint8_t)u;
        prev = u > 4 ? 0 : 1;
        rem = u;
        k = 1;
        if (u == 0) adv = true; else mode = 1;
      }
    } else if (u >= (1 << 27)) {
      corrupt = true;
    } else {
      const int nzf = u != 0;
      prev = nzf;
      rem -= nzf;
      k += 1;
      if (rem == 0) adv = true;
      else if (k >= 64) corrupt = true;
    }

    // chain advance over (j, bx, by): the DCT8 raster of the group
    if (adv) {
      ++chain;
      mode = 0;
      if (++j == 3) {
        j = 0;
        if (++bx == bw) {
          bx = 0;
          ++by;
        }
      }
      done = chain >= nch;
    }
  }
  ok_out[lane] = done && !corrupt && (st == kAnsSignature || nch == 0);
  steps_out[lane] = t;  // steps that decoded a symbol
}

}  // namespace

// flat: u16 halfwords of every lane's stream [total]; lane_off i64 [L];
// n_chains, bw, lane_img int32 [L]; a1/a2 u32 [B, alias_words]; nzclu u8
// [B, 3*37]; zdclu u8 [B, 3*458]; kz int32 [128]; tape int32 [t_alloc, L],
// zero-filled by the caller; ok bool [L]; steps int32 [L]. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int jxl_ans_decode(const void* flat, long long total,
                              const long long* lane_off, const int* n_chains,
                              const int* bw, const int* lane_img,
                              const void* a1, const void* a2,
                              const void* nzclu, const void* zdclu,
                              const int* kz, int alias_words, int las, int L,
                              int t_alloc, int* tape, void* ok, int* steps,
                              void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int grid = (L + kThreads - 1) / kThreads;
  ans_decode_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)flat, total, lane_off, n_chains, bw, lane_img,
      (const uint32_t*)a1, (const uint32_t*)a2, (const uint8_t*)nzclu,
      (const uint8_t*)zdclu, kz, alias_words, las, L, t_alloc, tape,
      (bool*)ok, steps);
  return (int)cudaGetLastError();
}

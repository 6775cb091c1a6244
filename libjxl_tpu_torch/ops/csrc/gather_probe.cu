// The per-lane dependent-lookup probes that chose the TPU rANS design
// (TPU kernels S1-S6), on Hopper. Each kernel computes what its TPU probe
// computes, iteration for iteration, so its output equals the probe's and
// its plain twin's (libjxl_tpu_torch/probes/gather.py) word for word. The
// lookups are a serial chain: every index depends on the previous
// lookup's value, as a rANS step's table loads depend on its state.
//
//   chain_kernel       S1 scratch/gather_bench.py bench_pallas_gather and
//                      S2 bench_pallas_2d_gather: s += tbl[(s >> 4) % T]
//                      g times, then s = s * 5 + 7; the table in device
//                      memory (read through the read-only cache) or in
//                      shared memory.
//   window_kernel      S3 bench_pallas_onehot_window and the column windows
//                      of S4 (scratch/gather_bench2.py kA, kA2, kE): each
//                      lane indexes its own window, held in registers and
//                      picked by an unrolled select (the TPU's one-hot
//                      form), in a local array indexed directly (K3's row
//                      file, ans_decode.cu rows[]), or in a shared-memory
//                      slot laid out [word][thread].
//   table_kernel       S4 kB, kC, kD, kF: a 1024-word table every lane
//                      shares (kD: no table, ~64 ALU ops), in shared or in
//                      device memory.
//   take_along_kernel  S5 scratch/gather_bench3.py probe: take_along_axis
//                      along rows or columns, one thread per element; the
//                      CTA's rows or columns in shared memory, or read from
//                      device memory.
//   noop_kernel        S6 scratch/gather_forms.py wl_pallas: o[0] = a[0],
//                      the cost of one more launch.
//
// Geometry: S1-S4 run 1024 lanes as 32 CTAs of 32 threads, so a
// lane-step compares with a step of ans_decode. Bound: latency. One warp an SM on 32 SMs leaves
// every load's latency exposed; the probes time exactly that. The TPU
// workarounds (8 x broadcast+gather+select for a 1024-word table, the
// one-hot window) do not exist here: a table is indexed directly, and the
// select survives only as the register form of a private window.
//
// Integer arithmetic: the TPU probes wrap on overflow, so every multiply,
// add and left shift runs in uint32_t; >> is arithmetic on the i32 state
// of S4 (kD, kF) and S5, logical on the u32 state of S1-S3; S5's % is a
// floor-mod, as jnp's is.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_scope.cuh"

namespace {

constexpr int kThreads = 32;  // K3's CTA: one warp
constexpr int kCols = 128;    // lanes of a TPU (8, 128) row
constexpr int kTable = 1024;  // S4's shared table, (8, 128) words

// word i of a table in shared memory (sm) or in device memory (g)
template <bool kShared>
__device__ __forceinline__ uint32_t word(const uint32_t* __restrict__ g,
                                         const uint32_t* sm, uint32_t i) {
  if constexpr (kShared) return sm[i];
  else return __ldg(g + i);
}

template <int kT, int kGathers, bool kShared, bool kRowCol>
__global__ void __launch_bounds__(kThreads)
chain_kernel(const uint32_t* __restrict__ table,
             const uint32_t* __restrict__ state, int iters,
             uint32_t* __restrict__ out) {
  __shared__ uint32_t stbl[kShared ? kT : 1];
  if constexpr (kShared) {
    for (int i = threadIdx.x; i < kT; i += kThreads) stbl[i] = table[i];
    __syncthreads();
  }
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  uint32_t s = state[lane];
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int g = 0; g < kGathers; ++g) {
      const uint32_t idx = (s >> 4) % kT;
      // S2 splits the index into (row, column) of a (T / 128, 128) table
      const uint32_t at = kRowCol ? (idx / kCols) * kCols + idx % kCols : idx;
      s += word<kShared>(table, stbl, at);
    }
    s = s * 5u + 7u;
  }
  out[lane] = s;
}

// kRule 0 (S3): idx = (s >> 4) % depth, s = (s + sel) * 5 + 7.
// kRule 1 (kA, kA2, kE): idx = (s + it) & (depth - 1), s = s + sel.
// kMode 0: registers, unrolled select; 1: local array; 2: shared slot.
template <int kDepth, int kRule, int kMode>
__global__ void __launch_bounds__(kThreads)
window_kernel(const uint32_t* __restrict__ win, int row_stride, int col_mask,
              const uint32_t* __restrict__ state, int iters,
              uint32_t* __restrict__ out) {
  __shared__ uint32_t swin[kMode == 2 ? kDepth * kThreads : 1];
  uint32_t w[kMode == 2 ? 1 : kDepth];
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  const int col = lane & col_mask;
#pragma unroll
  for (int k = 0; k < kDepth; ++k) {
    const uint32_t v = win[k * row_stride + col];
    if constexpr (kMode == 2) swin[k * kThreads + threadIdx.x] = v;
    else w[k] = v;
  }
  uint32_t s = state[lane];
  for (int it = 0; it < iters; ++it) {
    const uint32_t idx = kRule == 0 ? (s >> 4) % kDepth
                                    : (s + (uint32_t)it) & (kDepth - 1);
    uint32_t sel;
    if constexpr (kMode == 0) {
      sel = 0;
#pragma unroll
      for (int k = 0; k < kDepth; ++k) sel = idx == (uint32_t)k ? w[k] : sel;
    } else if constexpr (kMode == 1) {
      sel = w[idx];
    } else {
      sel = swin[idx * kThreads + threadIdx.x];
    }
    s = kRule == 0 ? (s + sel) * 5u + 7u : s + sel;
  }
  out[lane] = s;
}

__device__ __forceinline__ uint32_t asr(uint32_t x, int n) {
  return (uint32_t)((int32_t)x >> n);  // arithmetic, as on the i32 state
}

// kBody 0 kB, 1 kC, 2 kD, 3 kF (scratch/gather_bench2.py:91-180)
template <int kBody, bool kShared>
__global__ void __launch_bounds__(kThreads)
table_kernel(const uint32_t* __restrict__ tbl,
             const uint32_t* __restrict__ win,
             const uint32_t* __restrict__ state, int iters,
             uint32_t* __restrict__ out) {
  constexpr bool kTbl = kShared && kBody != 2;
  constexpr bool kWin = kShared && kBody == 3;
  __shared__ uint32_t stbl[kTbl ? kTable : 1];
  __shared__ uint32_t swin[kWin ? kTable : 1];
  if constexpr (kTbl) {
    for (int i = threadIdx.x; i < kTable; i += kThreads) {
      stbl[i] = tbl[i];
      if constexpr (kWin) swin[i] = win[i];
    }
    __syncthreads();
  }
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  const uint32_t row = lane / kCols, col = lane % kCols;
  uint32_t s = state[lane];
  for (int it = 0; it < iters; ++it) {
    const uint32_t i = (uint32_t)it;
    if constexpr (kBody == 0) {  // kB: gather within the lane's row
      s += word<kShared>(tbl, stbl, row * kCols + ((s + i) & 127u));
    } else if constexpr (kBody == 1) {  // kC: the whole 1024-word table
      s += word<kShared>(tbl, stbl, (s + i) & 1023u);
    } else if constexpr (kBody == 2) {  // kD: ~64 ALU ops
      uint32_t x = s;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        x = (x * 5u + 7u) ^ asr(x, 3);
        x = x + (x << 2);
      }
      s = x;
    } else {  // kF: the symbol-step mix
      uint32_t x = s;
      x += word<kShared>(tbl, stbl, (x + i) & 1023u);
      x ^= word<kShared>(tbl, stbl, (x * 3u + 1u) & 1023u);
      x += word<kShared>(win, swin, (x & 7u) * kCols + col);
#pragma unroll
      for (int r = 0; r < 20; ++r) x = (x * 5u + 7u) ^ asr(x, 3);
      s = x;
    }
  }
  out[lane] = s;
}

// One thread per element of the (H, W) state. axis 1: a CTA holds `group`
// whole rows, element (r, c) reads tbl[r, idx]; axis 0: a CTA holds
// `group` whole columns, element (r, c) reads tbl[idx, c]. The CTA's rows
// or columns are exactly the table words its threads own; H (axis 1) or
// W (axis 0) is a multiple of group, so every thread holds an element.
template <bool kShared>
__global__ void take_along_kernel(const int32_t* __restrict__ tbl,
                                  const int32_t* __restrict__ state, int H,
                                  int W, int axis, int mod, int group,
                                  int iters, int32_t* __restrict__ out) {
  extern __shared__ int32_t slab[];
  const int t = threadIdx.x;
  int r, c, home;  // element, and its word in the slab
  if (axis == 1) {
    r = blockIdx.x * group + t / W;
    c = t % W;
    home = t;
  } else {
    r = t / group;
    c = blockIdx.x * group + t % group;
    home = r * group + t % group;
  }
  const int e = r * W + c;
  if constexpr (kShared) {
    slab[home] = tbl[e];
    __syncthreads();
  }
  uint32_t s = (uint32_t)state[e];
  for (int it = 0; it < iters; ++it) {
    int idx = (int32_t)(s + (uint32_t)it) % mod;
    idx += idx < 0 ? mod : 0;
    int32_t g;
    if (axis == 1) {
      g = kShared ? slab[(t / W) * W + idx] : __ldg(tbl + r * W + idx);
    } else {
      g = kShared ? slab[idx * group + t % group] : __ldg(tbl + idx * W + c);
    }
    s += (uint32_t)g;
  }
  out[e] = (int32_t)s;
}

__global__ void noop_kernel(const int32_t* __restrict__ a,
                            int32_t* __restrict__ o, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = a[i];
}

}  // namespace

// Each entry point launches one kernel on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a form it was not
// compiled for. States and outputs are [1024] words (S5: [H, W]).

// table u32 [T]; (T, gathers, rowcol) one of (512, 1, 0), (8192, 3, 0),
// (8192, 1, 1)
extern "C" int jxl_probe_chain(int T, int gathers, int shared, int rowcol,
                               const void* table, const void* state,
                               int iters, void* out, void* stream,
                               int device) {
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return (int)scope.error();
  const uint32_t* tb = (const uint32_t*)table;
  const uint32_t* st = (const uint32_t*)state;
  uint32_t* o = (uint32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = 1024 / kThreads;
#define CHAIN(KT, KG, KS, KR)                                          \
  if (T == KT && gathers == KG && shared == KS && rowcol == KR) {     \
    chain_kernel<KT, KG, KS, KR><<<grid, kThreads, 0, s>>>(tb, st, iters, o); \
    return (int)cudaGetLastError();                                   \
  }
  CHAIN(512, 1, false, false)
  CHAIN(512, 1, true, false)
  CHAIN(8192, 3, false, false)
  CHAIN(8192, 3, true, false)
  CHAIN(8192, 1, false, true)
  CHAIN(8192, 1, true, true)
#undef CHAIN
  return (int)cudaErrorInvalidValue;
}

// win u32 [depth, row_stride]: lane l's window is column l & col_mask;
// (depth, rule) one of (64, 0), (64, 1), (8, 1); mode 0, 1 or 2
extern "C" int jxl_probe_window(int depth, int rule, int mode,
                                const void* win, int row_stride,
                                int col_mask, const void* state, int iters,
                                void* out, void* stream, int device) {
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return (int)scope.error();
  const uint32_t* w = (const uint32_t*)win;
  const uint32_t* st = (const uint32_t*)state;
  uint32_t* o = (uint32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = 1024 / kThreads;
#define WINDOW(KD, KR, KM)                                                   \
  if (depth == KD && rule == KR && mode == KM) {                            \
    window_kernel<KD, KR, KM><<<grid, kThreads, 0, s>>>(w, row_stride,      \
                                                        col_mask, st,       \
                                                        iters, o);          \
    return (int)cudaGetLastError();                                         \
  }
#define WINDOW_MODES(KD, KR) WINDOW(KD, KR, 0) WINDOW(KD, KR, 1) WINDOW(KD, KR, 2)
  WINDOW_MODES(64, 0)
  WINDOW_MODES(64, 1)
  WINDOW_MODES(8, 1)
#undef WINDOW_MODES
#undef WINDOW
  return (int)cudaErrorInvalidValue;
}

// tbl, win u32 [1024] (kD reads neither; only kF reads win); body 0-3
extern "C" int jxl_probe_table(int body, int shared, const void* tbl,
                               const void* win, const void* state,
                               int iters, void* out, void* stream,
                               int device) {
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return (int)scope.error();
  const uint32_t* tb = (const uint32_t*)tbl;
  const uint32_t* wn = (const uint32_t*)win;
  const uint32_t* st = (const uint32_t*)state;
  uint32_t* o = (uint32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = 1024 / kThreads;
#define TABLE(KB, KS)                                                         \
  if (body == KB && shared == KS) {                                          \
    table_kernel<KB, KS><<<grid, kThreads, 0, s>>>(tb, wn, st, iters, o);    \
    return (int)cudaGetLastError();                                          \
  }
  TABLE(0, true)
  TABLE(1, false)
  TABLE(1, true)
  TABLE(2, false)
  TABLE(3, false)
  TABLE(3, true)
#undef TABLE
  return (int)cudaErrorInvalidValue;
}

// tbl, state, out i32 [H, W]; a CTA of `group` rows (axis 1) or columns
// (axis 0), group * W (or H * group) <= 1024 threads
extern "C" int jxl_probe_take_along(int shared, const void* tbl,
                                    const void* state, int H, int W,
                                    int axis, int mod, int group, int iters,
                                    void* out, void* stream, int device) {
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return (int)scope.error();
  const int threads = axis == 1 ? group * W : H * group;
  const int grid = axis == 1 ? H / group : W / group;
  if (group <= 0 || threads > 1024 || mod <= 0 || (axis != 0 && axis != 1) ||
      (axis == 1 ? H : W) % group != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* tb = (const int32_t*)tbl;
  const int32_t* st = (const int32_t*)state;
  int32_t* o = (int32_t*)out;
  if (shared) {
    take_along_kernel<true><<<grid, threads, threads * sizeof(int32_t), s>>>(
        tb, st, H, W, axis, mod, group, iters, o);
  } else {
    take_along_kernel<false><<<grid, threads, 0, s>>>(tb, st, H, W, axis,
                                                      mod, group, iters, o);
  }
  return (int)cudaGetLastError();
}

// o[:n] = a[:n] (i32)
extern "C" int jxl_probe_noop(const void* a, void* o, int n, void* stream,
                              int device) {
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return (int)scope.error();
  noop_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (int32_t*)o, n);
  return (int)cudaGetLastError();
}

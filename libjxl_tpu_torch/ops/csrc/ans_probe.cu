// The stream-copy floor of the rANS decode: ans_decode's data movement
// with the decode taken out (TPU kernel S7, scratch/prof_kernel.py glue,
// which ran K3's driver loop around a no-op kernel). For each lane and
// each step t < min(steps[lane], t_alloc) it writes tape[t, lane] = the
// 32-bit word at halfword lane_off[lane] + 2t of the lanes' streams (low
// halfword first), reading past the end clamped to the last halfword as
// ans_decode.cu does. Plain twin: libjxl_tpu_torch/probes/prof_kernel.py
// glue_plain.
//
// It takes ans_decode's arguments and launch geometry (one thread per
// lane, CTAs of 32), so ans_decode's time minus this kernel's is the
// decode itself. Bound: the same as ans_decode's, latency; each thread
// reads its own stream two halfwords a step, and the lanes of a warp write
// neighbouring tape words at the same step. The tables are taken and not
// read; `steps` is read (the step counts of an ans_decode run), and every
// `ok` is set.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;  // ans_decode.cu's CTA

__global__ void __launch_bounds__(kThreads)
ans_stream_floor_kernel(const uint16_t* __restrict__ flat, long long total,
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
                        bool* __restrict__ ok_out,
                        const int* __restrict__ steps) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const long long last = total - 1;
  long long pos = lane_off[lane];
  const int n = steps[lane] < t_alloc ? steps[lane] : t_alloc;
  for (int t = 0; t < n; ++t, pos += 2) {
    const uint32_t lo = flat[pos < last ? pos : last];
    const uint32_t hi = flat[pos + 1 < last ? pos + 1 : last];
    tape[(size_t)t * L + lane] = (int)(lo | (hi << 16));
  }
  ok_out[lane] = true;
}

}  // namespace

// The arguments of jxl_ans_decode (ans_decode.cu), with `steps` an input
// int32 [L]; tape int32 [t_alloc, L], zero-filled by the caller; ok bool
// [L]. Launches on `stream` and returns cudaGetLastError().
extern "C" int jxl_ans_stream_floor(
    const void* flat, long long total, const long long* lane_off,
    const int* n_chains, const int* bw, const int* lane_img, const void* a1,
    const void* a2, const void* nzclu, const void* zdclu, const int* kz,
    int alias_words, int las, int L, int t_alloc, int* tape, void* ok,
    const int* steps, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int grid = (L + kThreads - 1) / kThreads;
  ans_stream_floor_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)flat, total, lane_off, n_chains, bw, lane_img,
      (const uint32_t*)a1, (const uint32_t*)a2, (const uint8_t*)nzclu,
      (const uint8_t*)zdclu, kz, alias_words, las, L, t_alloc, tape,
      (bool*)ok, steps);
  return (int)cudaGetLastError();
}

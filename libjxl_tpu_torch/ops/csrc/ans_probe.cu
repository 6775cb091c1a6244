// The stream-copy floor of the rANS decode: ans_decode's data movement
// with the decode taken out (TPU kernel S7, scratch/prof_kernel.py glue,
// which ran K3's driver loop around a no-op kernel). For each lane and
// each step t < min(steps[lane], t_alloc) it writes tape[t, lane] = the
// 32-bit word at halfword lane_off[lane] + 2t of the lanes' streams (low
// halfword first), reading past the end clamped to the last halfword as
// ans_decode.cu does. Plain twin: libjxl_tpu_torch/probes/prof_kernel.py
// glue_plain.
//
// It takes ans_decode's arguments and moves the stream as ans_decode
// does: the same one-warp CTAs of the CTA table, each lane's stream
// through the same cp.async ring in shared memory (ans_ring.cuh), topped
// up at the same steps, two halfwords a step, the most a decode step
// takes. It is the floor beside which ans_decode's time a step is
// read. Bound: latency; the lanes of a CTA write neighbouring tape words at
// the same step. The tables are taken and not read; `steps` is read (the
// step counts of an ans_decode run), and every `ok` is set.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ans_ring.cuh"
#include "device_scope.cuh"

namespace {

using namespace jxl_ans;

constexpr int kThreads = 32;  // a CTA, as ans_decode.cu's

__global__ void __launch_bounds__(kThreads)
ans_stream_floor_kernel(const uint16_t* __restrict__ flat, long long total,
                        const long long* __restrict__ lane_off,
                        const int* __restrict__ cta_first, int t_alloc,
                        int L, int* __restrict__ tape,
                        bool* __restrict__ ok_out,
                        const int* __restrict__ steps) {
  __shared__ __align__(16) uint16_t ring_s[kLanes * kRingStride];
  const int tid = threadIdx.x;
  const int lane0 = cta_first[blockIdx.x];
  if (tid >= cta_first[blockIdx.x + 1] - lane0) return;
  const int lane = lane0 + tid;
  StreamRing ring(ring_s + tid * kRingStride, flat, total, lane_off[lane]);
  const int n = steps[lane] < t_alloc ? steps[lane] : t_alloc;
  for (int t = 0; t < n; ++t) {
    ring.before_step(t);
    tape[(size_t)t * L + lane] = (int)ring.peek2();
    ring.skip(2);
  }
  ok_out[lane] = true;
  ring.drain();
}

}  // namespace

// The arguments of jxl_ans_decode (ans_decode.cu): tape int32 [t_alloc,
// L], zero-filled by the caller; ok bool [L]; `steps` an input int32 [L].
// Launches on `stream` and returns cudaGetLastError().
extern "C" int jxl_ans_stream_floor(
    const void* flat, long long total, const long long* lane_off,
    const int* n_chains, const int* bw, const int* lane_img, const void* a1,
    const void* a2, const void* nzclu, const void* zdclu, const int* kz,
    int alias_words, int las, int L, int t_alloc, const int* cta_first,
    int n_cta, int* tape, void* ok, const int* steps, void* stream,
    int device) {
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return (int)scope.error();
  ans_stream_floor_kernel<<<n_cta, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)flat, total, lane_off, cta_first, t_alloc, L, tape,
      (bool*)ok, steps);
  return (int)cudaGetLastError();
}

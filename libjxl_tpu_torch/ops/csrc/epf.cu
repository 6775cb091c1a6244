// One edge-preserving-filter pass (stage_epf.cc Weight math) over a batch
// of XYB images f32 [B,3,H,W].
//
// Replaces the TPU kernel K2, libjxl_tpu/ops/pallas_kernels.py
// epf_pass_pallas (body _epf_kernel_body). Plain twin:
// libjxl_tpu_torch/ops/pipeline.py _epf_pass (the port of
// libjxl_tpu/ops/pipeline.py _epf_pass_jax).
//
// Pass geometry, a template parameter:
//   0: 12 neighbours, SAD over the 5-tap plus pattern (epf_iters == 3)
//   1:  4 neighbours, SAD over the plus pattern
//   2:  4 neighbours, SAD over the centre pixel only
// For each neighbour n: sad = sum over taps t of
//   sum_c cs[c] * |x_c(p + t) - x_c(p + t + n)|,
// weight = max(0, 1 + sad * inv_sigma * (sad_mul * sigma_scale * 1.65)),
// out = (x + sum w * x(p + n)) / (1 + sum w); pixels whose per-block
// inv_sigma is below kMinSigma pass through. The sums run in
// _epf_pass_jax's order (taps in pattern order, channels 0, 1, 2); nvcc
// contracts some of them into FMAs, so the result matches the plain twin
// within rtol 2e-4 / atol 2e-5 and not bit for bit.
//
// Bound on the H100: arithmetic, not memory. Per pixel it reads 12 bytes
// and writes 12, but pass 0 takes 12 x 5 x 3 = 180 abs-diff-FMAs for the
// SADs. Design: a 32x16 output tile per CTA with a 3-px halo of all three
// channels in shared memory (10 KB), loaded once with mirrored indexing,
// so the 3x-5x-reused neighbourhood is read from device memory ~1.6
// times per pixel and every SAD tap is a shared-memory read. Edges
// reproduce jnp.pad(mode="symmetric"): i < 0 -> -1 - i, i >= n -> 2n-1-i
// (not torch's "reflect"). Threads outside a ragged edge load the halo
// and then stop.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 16;
constexpr int kHalo = 3;  // neighbour (2) + SAD tap (1)
constexpr int kSharedW = kTileW + 2 * kHalo;
constexpr int kSharedH = kTileH + 2 * kHalo;
constexpr float kMinSigma = -3.90524291751269967465540850526868f;

__device__ __forceinline__ int mirror(int i, int n) {
  return i < 0 ? -1 - i : (i >= n ? 2 * n - 1 - i : i);
}

template <int PASS>
struct Geometry;

template <>
struct Geometry<0> {
  static constexpr int kNeighbors = 12;
  static constexpr bool kPlus = true;
  __device__ static void offset(int k, int& dy, int& dx) {
    const int t[12][2] = {{-2, 0}, {-1, -1}, {-1, 0}, {-1, 1},
                          {0, -2}, {0, -1},  {0, 1},  {0, 2},
                          {1, -1}, {1, 0},   {1, 1},  {2, 0}};
    dy = t[k][0];
    dx = t[k][1];
  }
};

struct Plus4 {
  static constexpr int kNeighbors = 4;
  __device__ static void offset(int k, int& dy, int& dx) {
    const int t[4][2] = {{-1, 0}, {0, -1}, {0, 1}, {1, 0}};
    dy = t[k][0];
    dx = t[k][1];
  }
};

template <>
struct Geometry<1> : Plus4 {
  static constexpr bool kPlus = true;
};

template <>
struct Geometry<2> : Plus4 {
  static constexpr bool kPlus = false;
};

// the 5-tap SAD pattern, in _EPF_PLUS's order
__device__ __forceinline__ void plus_tap(int t, int& py, int& px) {
  const int p[5][2] = {{0, 0}, {-1, 0}, {1, 0}, {0, -1}, {0, 1}};
  py = p[t][0];
  px = p[t][1];
}

__device__ __forceinline__ float channel_diff(
    const float (&s)[3][kSharedH][kSharedW], int y, int x, int dy, int dx,
    float cs0, float cs1, float cs2) {
  return fabsf(s[0][y][x] - s[0][y + dy][x + dx]) * cs0 +
         fabsf(s[1][y][x] - s[1][y + dy][x + dx]) * cs1 +
         fabsf(s[2][y][x] - s[2][y + dy][x + dx]) * cs2;
}

template <int PASS>
__global__ void __launch_bounds__(kTileW * kTileH)
epf_kernel(const float* __restrict__ in, float* __restrict__ out,
           const float* __restrict__ inv_sigma,
           const float* __restrict__ sad_mul, float cs0, float cs1,
           float cs2, float sigma_scale, int H, int W) {
  using G = Geometry<PASS>;
  __shared__ float s[3][kSharedH][kSharedW];
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const size_t plane = (size_t)H * W;
  const float* src = in + (size_t)b * 3 * plane;
  for (int i = threadIdx.y * kTileW + threadIdx.x; i < kSharedH * kSharedW;
       i += kTileW * kTileH) {
    const int ly = i / kSharedW;
    const int lx = i - ly * kSharedW;
    const size_t o = (size_t)mirror(y0 + ly - kHalo, H) * W +
                     mirror(x0 + lx - kHalo, W);
    s[0][ly][lx] = src[o];
    s[1][ly][lx] = src[o + plane];
    s[2][ly][lx] = src[o + 2 * plane];
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const int cy = threadIdx.y + kHalo;
  const int cx = threadIdx.x + kHalo;
  const int nbx = (W + 7) >> 3;
  const int nby = (H + 7) >> 3;
  float* dst = out + (size_t)b * 3 * plane + (size_t)y * W + x;
  const float isig = inv_sigma[((size_t)b * nby + (y >> 3)) * nbx + (x >> 3)];
  const float c0 = s[0][cy][cx];
  const float c1 = s[1][cy][cx];
  const float c2 = s[2][cy][cx];
  if (isig < kMinSigma) {
    dst[0] = c0;
    dst[plane] = c1;
    dst[2 * plane] = c2;
    return;
  }
  const float inv = isig * (sad_mul[(size_t)y * W + x] * sigma_scale * 1.65f);
  float n0 = c0, n1 = c1, n2 = c2, den = 1.0f;
#pragma unroll
  for (int k = 0; k < G::kNeighbors; ++k) {
    int dy, dx;
    G::offset(k, dy, dx);
    float sad;
    if constexpr (G::kPlus) {
      int py, px;
      plus_tap(0, py, px);
      sad = channel_diff(s, cy + py, cx + px, dy, dx, cs0, cs1, cs2);
#pragma unroll
      for (int t = 1; t < 5; ++t) {
        plus_tap(t, py, px);
        sad += channel_diff(s, cy + py, cx + px, dy, dx, cs0, cs1, cs2);
      }
    } else {
      sad = channel_diff(s, cy, cx, dy, dx, cs0, cs1, cs2);
    }
    const float w = fmaxf(0.0f, 1.0f + sad * inv);
    n0 += w * s[0][cy + dy][cx + dx];
    n1 += w * s[1][cy + dy][cx + dx];
    n2 += w * s[2][cy + dy][cx + dx];
    den += w;
  }
  dst[0] = n0 / den;
  dst[plane] = n1 / den;
  dst[2 * plane] = n2 / den;
}

template <int PASS>
void launch(const float* in, float* out, const float* inv_sigma,
            const float* sad_mul, float cs0, float cs1, float cs2,
            float sigma_scale, int B, int H, int W, cudaStream_t stream) {
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  const dim3 block(kTileW, kTileH);
  epf_kernel<PASS><<<grid, block, 0, stream>>>(
      in, out, inv_sigma, sad_mul, cs0, cs1, cs2, sigma_scale, H, W);
}

}  // namespace

// in/out f32 [B,3,H,W] (distinct buffers); inv_sigma f32 [B,ceil(H/8),
// ceil(W/8)] per block; sad_mul f32 [H,W], shared by the batch. H and W
// are at least kHalo. Launches on `stream` and returns cudaGetLastError().
extern "C" int jxl_epf_pass(const float* in, float* out,
                            const float* inv_sigma, const float* sad_mul,
                            int pass, float cs0, float cs1, float cs2,
                            float sigma_scale, int B, int H, int W,
                            void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (pass) {
    case 0:
      launch<0>(in, out, inv_sigma, sad_mul, cs0, cs1, cs2, sigma_scale, B,
                H, W, s);
      break;
    case 1:
      launch<1>(in, out, inv_sigma, sad_mul, cs0, cs1, cs2, sigma_scale, B,
                H, W, s);
      break;
    case 2:
      launch<2>(in, out, inv_sigma, sad_mul, cs0, cs1, cs2, sigma_scale, B,
                H, W, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

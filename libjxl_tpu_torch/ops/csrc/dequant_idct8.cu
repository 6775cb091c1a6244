// Fused dequant + AdjustQuantBias + chroma-from-luma + DC insert + 8x8 IDCT
// for an all-DCT8 VarDCT frame batch, in coefficient-image layout.
//
// Replaces the TPU kernel K1, libjxl_tpu/ops/pallas_kernels.py
// dequant_cfl_pallas (body _dequant_kernel), and also takes in the DC
// insert and the IDCT8 that the JAX package left to XLA in
// ops/pipeline.py decode_xyb_image. Plain twin:
// libjxl_tpu_torch/ops/pipeline.py decode_xyb_image.
//
// Bound on the H100: device memory. Per pixel it reads 6 bytes of int16
// coefficients (12 with int32) and writes 12 bytes of f32 XYB; the
// per-block tables (qf, dc, CfL tiles) add ~1/64 of that. The arithmetic
// is ~20 flops a pixel, far below the 67 TFLOP/s fp32 line.
// Design: one CTA covers one 8-row block row of 64 px (8 blocks) for all
// three channels, because CfL needs Y beside X and B. Loads and stores
// are coalesced along x; the dequantized coefficients never leave shared
// memory, so the coefficient image is neither written nor read back, and
// no pre-broadcast scale/dm/CfL image is materialised. The separable
// IDCT runs as two 8-point passes against inv8 in __constant__ memory,
// which the constant cache broadcasts: every thread of a warp reads the
// same row of it.
//
// Layout trap: the bitstream stores each block transposed, so with
// blk[v][u] = coef at storage row v, column u,
//   out[r][c] = sum_u sum_v inv8[r][u] * blk[v][u] * inv8[c][v]
// (the einsum "ru,...vu,cv->...rc" of ops/pipeline.py idct8_blocks).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kBlocksPerCta = 8;
constexpr int kTileW = 8 * kBlocksPerCta;  // 64 px
constexpr int kStageStride = kTileW + 1;   // pad: pass B reads columns
constexpr int kColorTileBlocks = 8;       // CfL tiles are 64 px
constexpr float kColorFactor = 84.0f;
constexpr float kBaseX = 0.0f;
constexpr float kBaseB = 1.0f;

__constant__ float c_inv8[64];

struct QuantBias {
  float b[4];
};

__device__ __forceinline__ float adjust_quant_bias(float q, int c,
                                                   const QuantBias& qb) {
  if (q == 0.0f) return 0.0f;
  if (q == 1.0f) return qb.b[c];
  if (q == -1.0f) return -qb.b[c];
  return q - qb.b[3] / q;
}

template <typename QT>
__global__ void __launch_bounds__(kTileW * 8)
dequant_idct8_kernel(const QT* __restrict__ qimg, const int* __restrict__ qf,
                     const float* __restrict__ dc,
                     const int* __restrict__ ytox,
                     const int* __restrict__ ytob,
                     const float* __restrict__ dm,
                     const float* __restrict__ igs,
                     const QuantBias qb, float x_dm_mult, float b_dm_mult,
                     int H, int W, int nty, int ntx,
                     float* __restrict__ out) {
  __shared__ float coef[3][8][kTileW];
  __shared__ float stage[3][8][kStageStride];
  const int tx = threadIdx.x;  // column in the CTA's 64-px strip
  const int ty = threadIdx.y;  // row in the block row
  const int b = blockIdx.z;
  const int by = blockIdx.y;
  const int x = blockIdx.x * kTileW + tx;
  const int y = by * 8 + ty;
  const int nby = H >> 3;
  const int nbx = W >> 3;
  const size_t plane = (size_t)H * W;
  const size_t px = (size_t)b * 3 * plane + (size_t)y * W + x;
  // W is a multiple of 8: a block is wholly inside or wholly outside
  const bool inside = x < W;

  if (inside) {
    const int bx = x >> 3;
    const int u = tx & 7;  // storage column
    const int v = ty;      // storage row
    const size_t blk = ((size_t)b * nby + by) * nbx + bx;
    const float scaled = igs[b] / (float)qf[blk];
    const size_t tile = ((size_t)b * nty + by / kColorTileBlocks) * ntx +
                        bx / kColorTileBlocks;
    const float x_cc = kBaseX + (float)ytox[tile] / kColorFactor;
    const float b_cc = kBaseB + (float)ytob[tile] / kColorFactor;
    const int m = v * 8 + u;
    const float dq_y =
        adjust_quant_bias((float)qimg[px + plane], 1, qb) * (dm[64 + m] * scaled);
    float cx = adjust_quant_bias((float)qimg[px], 0, qb) * (dm[m] * scaled) *
                   x_dm_mult + x_cc * dq_y;
    float cy = dq_y;
    float cb = adjust_quant_bias((float)qimg[px + 2 * plane], 2, qb) *
                   (dm[128 + m] * scaled) * b_dm_mult + b_cc * dq_y;
    if (u == 0 && v == 0) {
      const size_t dplane = (size_t)nby * nbx;
      const size_t d = (size_t)b * 3 * dplane + (size_t)by * nbx + bx;
      cx = dc[d];
      cy = dc[d + dplane];
      cb = dc[d + 2 * dplane];
    }
    coef[0][ty][tx] = cx;
    coef[1][ty][tx] = cy;
    coef[2][ty][tx] = cb;
  }
  __syncthreads();

  // pass A, over storage rows: stage[c'][u] = sum_v inv8[c'][v] * blk[v][u]
  if (inside) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float acc = 0.0f;
#pragma unroll
      for (int v = 0; v < 8; ++v) acc += c_inv8[ty * 8 + v] * coef[ch][v][tx];
      stage[ch][ty][tx] = acc;
    }
  }
  __syncthreads();

  // pass B, over storage columns: out[r][c'] = sum_u inv8[r][u] * stage[c'][u]
  if (inside) {
    const int col = tx & 7;
    const int base = tx & ~7;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float acc = 0.0f;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        acc += c_inv8[ty * 8 + u] * stage[ch][col][base + u];
      out[px + ch * plane] = acc;
    }
  }
}

}  // namespace

// qimg: int16 (q16 != 0) or int32 [B,3,H,W]; qf int32 [B,H/8,W/8];
// dc f32 [B,3,H/8,W/8]; ytox/ytob int32 [B,nty,ntx]; dm f32 [3,8,8];
// igs f32 [B]; inv8_host f32[64] and qbias_host f32[4] in host memory;
// out f32 [B,3,H,W]. H and W are multiples of 8. Launches on `stream`
// and returns cudaGetLastError().
extern "C" int jxl_dequant_idct8(const void* qimg, int q16, const int* qf,
                                 const float* dc, const int* ytox,
                                 const int* ytob, const float* dm,
                                 const float* igs, const float* inv8_host,
                                 const float* qbias_host, float x_dm_mult,
                                 float b_dm_mult, int B, int H, int W,
                                 int nty, int ntx, float* out, void* stream,
                                 int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // the same 256 bytes every launch, ordered on the launch's stream: no
  // per-device state to track, and ~us against the kernel's ~ms
  err = cudaMemcpyToSymbolAsync(c_inv8, inv8_host, sizeof(c_inv8), 0,
                                cudaMemcpyHostToDevice, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  QuantBias qb;
  memcpy(qb.b, qbias_host, sizeof(qb.b));
  const dim3 grid((W + kTileW - 1) / kTileW, H / 8, B);
  const dim3 block(kTileW, 8);
  cudaStream_t s = (cudaStream_t)stream;
  if (q16) {
    dequant_idct8_kernel<int16_t><<<grid, block, 0, s>>>(
        (const int16_t*)qimg, qf, dc, ytox, ytob, dm, igs, qb,
        x_dm_mult, b_dm_mult, H, W, nty, ntx, out);
  } else {
    dequant_idct8_kernel<int32_t><<<grid, block, 0, s>>>(
        (const int32_t*)qimg, qf, dc, ytox, ytob, dm, igs, qb,
        x_dm_mult, b_dm_mult, H, W, nty, ntx, out);
  }
  return (int)cudaGetLastError();
}

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
// is ~38 operations a pixel, far below the 67 TFLOP/s fp32 line.
//
// Design: a thread owns one 8-coefficient row of one block, all three
// channels (CfL needs Y beside X and B), and an 8-lane group owns a block.
// A row is one 16-byte load of int16 a channel (two for int32); a warp's
// four blocks read 64 contiguous bytes of each of 8 image rows. The
// block's factors (inv_global_scale / qf, the CfL tile, the DC) are
// loaded and computed once a row, not once a coefficient. The first
// 8-point pass runs on the row in registers, the 8x8 transpose is three
// butterfly rounds of shuffles inside the 8-lane group (no CTA barrier,
// no shared memory), and the second pass leaves each lane one whole output
// row, stored as two float4 a channel. 256-thread CTAs of 32 blocks of one
// block row: 32,768 CTAs on 16 x 2048^2.
//
// Layout trap: the bitstream stores each block transposed, so with
// blk[v][u] = coef at storage row v, column u,
//   out[r][c] = sum_u sum_v inv8[r][u] * blk[v][u] * inv8[c][v]
// (the einsum "ru,...vu,cv->...rc" of ops/pipeline.py idct8_blocks): lane
// v first forms a[r] = sum_u inv8[r][u] * blk[v][u], and after the
// transpose lane r forms out[r][c] = sum_v inv8[c][v] * a_v[r].

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerCta = kThreads / 8;  // one 8-lane group a block
constexpr int kColorTileBlocks = 8;          // CfL tiles are 64 px
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

// 8 coefficients of one storage row, widened to float
__device__ __forceinline__ void load_row(const int16_t* src, float (&q)[8]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    q[2 * k] = (float)(int16_t)(w[k] & 0xffffu);
    q[2 * k + 1] = (float)(int16_t)(w[k] >> 16);
  }
}

__device__ __forceinline__ void load_row(const int32_t* src, float (&q)[8]) {
  const int4 a = __ldg(reinterpret_cast<const int4*>(src));
  const int4 b = __ldg(reinterpret_cast<const int4*>(src) + 1);
  q[0] = (float)a.x;
  q[1] = (float)a.y;
  q[2] = (float)a.z;
  q[3] = (float)a.w;
  q[4] = (float)b.x;
  q[5] = (float)b.y;
  q[6] = (float)b.z;
  q[7] = (float)b.w;
}

__device__ __forceinline__ void load_dm_row(const float* src,
                                            float (&d)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(src));
  const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
  d[0] = a.x;
  d[1] = a.y;
  d[2] = a.z;
  d[3] = a.w;
  d[4] = b.x;
  d[5] = b.y;
  d[6] = b.z;
  d[7] = b.w;
}

// a[r] = sum_u inv8[r][u] * v[u]: one 8-point pass in registers
__device__ __forceinline__ void idct8_pass(const float (&v)[8],
                                           float (&a)[8]) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    float acc = c_inv8[r * 8] * v[0];
#pragma unroll
    for (int u = 1; u < 8; ++u) acc += c_inv8[r * 8 + u] * v[u];
    a[r] = acc;
  }
}

// Lane l of an 8-lane group holds row l of an 8x8 matrix; afterwards it
// holds column l. Each round swaps the off-diagonal half-blocks of the
// quadrants of size j between lanes l and l ^ j.
__device__ __forceinline__ void transpose8(float (&a)[8], int lane8) {
#pragma unroll
  for (int j = 4; j >= 1; j >>= 1) {
    const bool upper = (lane8 & j) != 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i & j) continue;
      const float send = upper ? a[i] : a[i | j];
      const float recv = __shfl_xor_sync(0xffffffffu, send, j);
      if (upper) {
        a[i] = recv;
      } else {
        a[i | j] = recv;
      }
    }
  }
}

// The block's rows `coef` (lane v holds storage row v) through both
// passes; lane r stores output row r at dst (its image row, the block's
// first column) unless the group is past the edge.
__device__ __forceinline__ void idct8_store(const float (&coef)[8],
                                            int lane8, bool inside,
                                            float* dst) {
  float a[8], o[8];
  idct8_pass(coef, a);
  transpose8(a, lane8);
  idct8_pass(a, o);
  if (inside) {
    float4* d4 = reinterpret_cast<float4*>(dst);
    d4[0] = make_float4(o[0], o[1], o[2], o[3]);
    d4[1] = make_float4(o[4], o[5], o[6], o[7]);
  }
}

template <typename QT>
__global__ void __launch_bounds__(kThreads, 2)
dequant_idct8_kernel(const QT* __restrict__ qimg, const int* __restrict__ qf,
                     const float* __restrict__ dc,
                     const int* __restrict__ ytox,
                     const int* __restrict__ ytob,
                     const float* __restrict__ dm,
                     const float* __restrict__ igs,
                     const QuantBias qb, float x_dm_mult, float b_dm_mult,
                     int H, int W, int nty, int ntx,
                     float* __restrict__ out) {
  const int lane8 = threadIdx.x & 7;  // storage row v, then output row r
  const int bx = blockIdx.x * kBlocksPerCta + (threadIdx.x >> 3);
  const int by = blockIdx.y;
  const int b = blockIdx.z;
  const int nby = H >> 3;
  const int nbx = W >> 3;
  // a group past the right edge works on the last block and stores
  // nothing, so every lane of the warp joins the shuffles
  const bool inside = bx < nbx;
  const int cbx = inside ? bx : nbx - 1;
  const size_t plane = (size_t)H * W;
  const size_t row =
      (size_t)b * 3 * plane + (size_t)(by * 8 + lane8) * W + cbx * 8;

  const size_t blk = ((size_t)b * nby + by) * nbx + cbx;
  const float scaled = igs[b] / (float)qf[blk];
  const size_t tile = ((size_t)b * nty + by / kColorTileBlocks) * ntx +
                      cbx / kColorTileBlocks;
  const float x_cc = kBaseX + (float)ytox[tile] / kColorFactor;
  const float b_cc = kBaseB + (float)ytob[tile] / kColorFactor;

  float cx[8], cy[8], cb[8];
  {
    float qx[8], qy[8], qz[8], d[8];
    load_row(qimg + row, qx);
    load_row(qimg + row + plane, qy);
    load_row(qimg + row + 2 * plane, qz);
    load_dm_row(dm + 64 + lane8 * 8, d);
#pragma unroll
    for (int u = 0; u < 8; ++u)
      cy[u] = adjust_quant_bias(qy[u], 1, qb) * (d[u] * scaled);
    load_dm_row(dm + lane8 * 8, d);
#pragma unroll
    for (int u = 0; u < 8; ++u)
      cx[u] = adjust_quant_bias(qx[u], 0, qb) * (d[u] * scaled) * x_dm_mult +
              x_cc * cy[u];
    load_dm_row(dm + 128 + lane8 * 8, d);
#pragma unroll
    for (int u = 0; u < 8; ++u)
      cb[u] = adjust_quant_bias(qz[u], 2, qb) * (d[u] * scaled) * b_dm_mult +
              b_cc * cy[u];
  }
  if (lane8 == 0) {
    const size_t dplane = (size_t)nby * nbx;
    const size_t d = (size_t)b * 3 * dplane + (size_t)by * nbx + cbx;
    cx[0] = dc[d];
    cy[0] = dc[d + dplane];
    cb[0] = dc[d + 2 * dplane];
  }

  idct8_store(cx, lane8, inside, out + row);
  idct8_store(cy, lane8, inside, out + row + plane);
  idct8_store(cb, lane8, inside, out + row + 2 * plane);
}

}  // namespace

// inv8_host f32[64], the IDCT8 matrix, in host memory: copies it into the
// kernel's constant table on `device`. Synchronous; call it once a device
// before the first jxl_dequant_idct8 there (never while a stream of the
// device captures a graph: the copy reads pageable host memory). Returns
// the CUDA error code.
extern "C" int jxl_dequant_idct8_tables(const float* inv8_host, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbol(c_inv8, inv8_host, sizeof(c_inv8));
}

// qimg: int16 (q16 != 0) or int32 [B,3,H,W], 16-byte aligned; qf int32
// [B,H/8,W/8]; dc f32 [B,3,H/8,W/8]; ytox/ytob int32 [B,nty,ntx]; dm f32
// [3,8,8], 16-byte aligned; igs f32 [B]; qb0..qb3 the quant bias
// (DEFAULT_QUANT_BIAS), by value; out f32 [B,3,H,W], 16-byte aligned. H
// and W are multiples of 8; jxl_dequant_idct8_tables has run on `device`.
// Reads no host memory, so a graph capture can record it. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int jxl_dequant_idct8(const void* qimg, int q16, const int* qf,
                                 const float* dc, const int* ytox,
                                 const int* ytob, const float* dm,
                                 const float* igs, float qb0, float qb1,
                                 float qb2, float qb3, float x_dm_mult,
                                 float b_dm_mult, int B, int H, int W,
                                 int nty, int ntx, float* out, void* stream,
                                 int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const QuantBias qb = {{qb0, qb1, qb2, qb3}};
  const dim3 grid((W / 8 + kBlocksPerCta - 1) / kBlocksPerCta, H / 8, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (q16) {
    dequant_idct8_kernel<int16_t><<<grid, kThreads, 0, s>>>(
        (const int16_t*)qimg, qf, dc, ytox, ytob, dm, igs, qb,
        x_dm_mult, b_dm_mult, H, W, nty, ntx, out);
  } else {
    dequant_idct8_kernel<int32_t><<<grid, kThreads, 0, s>>>(
        (const int32_t*)qimg, qf, dc, ytox, ytob, dm, igs, qb,
        x_dm_mult, b_dm_mult, H, W, nty, ntx, out);
  }
  return (int)cudaGetLastError();
}

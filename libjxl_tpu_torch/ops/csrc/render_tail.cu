// The tail of the batched VarDCT render in one launch: Gaborish, the
// chained edge-preserving-filter passes and the XYB -> sRGB u8 write, over
// a batch of XYB images f32 [B,3,H,W].
//
// Replaces the TPU kernel K2, libjxl_tpu/ops/pallas_kernels.py
// epf_pass_pallas (body _epf_kernel_body), and takes in what the JAX
// package left to XLA around it in ops/pipeline.py: gaborish_jax, the
// chain of _epf_pass_jax passes (epf_jax), xyb_to_rgb_jax and the u8 write
// of decode_render_image. Plain twin: libjxl_tpu_torch/ops/pipeline.py
// render_tail_plain; render_tail_tiled there runs this kernel's tiles,
// halos and edge refills in plain torch.
//
// The chain is a compile-time configuration: Gaborish or not, the EPF
// passes kFirst..kLast (1..1 for epf_iters 1, 1..2 for 2, 0..2 for 3, none
// for 0; one pass alone for kernels.epf_pass) and the output, f32 XYB
// planes or sRGB u8 [B,H,W,3].
//
// Bound on the H100: bytes and operations about equally. The render reads
// 12 bytes of XYB a pixel once and writes 3 bytes of u8 (805 MB and 201 MB
// on 16 x 2048^2, ~0.31 ms at 3.35 TB/s); the chain's arithmetic is ~290
// operations a pixel (Gaborish 54, pass 1 ~108, pass 2 ~92, colour ~40),
// ~0.29 ms at 67 TFLOP/s fp32. Before this kernel each stage was a pass
// over device memory, and Gaborish and the colour write were plain torch.
//
// Design: one CTA an output tile of kTileH x kTileW pixels (ops/build.py
// passes both: 16 x 64, so that the default chain's 54 KB of buffers let
// four 256-thread CTAs share an SM; the stages' barriers leave a CTA idle
// often, and two CTAs an SM were a third slower). It stages the tile with
// a halo of kHalo pixels a side (the
// sum of the stages' radii: Gaborish 1, pass 0 3, pass 1 2, pass 2 1; 4 for
// the default chain, 7 at epf=3), all three channels, in dynamic shared
// memory, and runs every stage between two ping-pong buffers; a stage's
// output band is its input band less its radius. Passes 0 and 1 first
// write the channel-scaled cross-difference planes their SADs share
// (_epf_pass_jax's d_plane), one for each pair of opposite neighbours:
// D_-n(q) = D_n(q - n), as |a - b| = |b - a| exactly. The sums run in
// _epf_pass_jax's order (neighbours, then pattern taps, then channels);
// nvcc contracts some into FMAs and the kernel multiplies by 1 / den where
// the twin divides, so a pass matches the twin within rtol 2e-4 / atol
// 2e-5, not bit for bit. A thread computes a strip of rows of a column
// (kGabStrip, kEpfStrip), its loads before its stores. The epilogue
// stages the u8 tile in shared memory and stores whole rows in 16-byte
// vectors.
//
// Edge trap: every stage of the reference pads its own input symmetrically
// at the frame edge (jnp.pad mode="symmetric": i < 0 -> -1 - i, i >= n ->
// 2n - 1 - i). So after each stage a tile whose buffer reaches outside the
// image refills its out-of-image cells from the mirror of that stage's
// output; a halo loaded once through a mirrored index would be another
// function at the edge. Frames need H, W >= kHalo (one reflection).
// Out-of-image cells further than the next stages reach are left as they
// are: nothing reads them into an in-image result.
//
// Loops stride by blockDim.x and the stages talk only across
// __syncthreads, so the kernel is the same function at any block size.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef JXL_RENDER_TILE_H
#error "JXL_RENDER_TILE_H: the output tile's rows (ops/build.py)"
#endif
#ifndef JXL_RENDER_TILE_W
#error "JXL_RENDER_TILE_W: the output tile's columns (ops/build.py)"
#endif

namespace {

constexpr int kTileH = JXL_RENDER_TILE_H;
constexpr int kTileW = JXL_RENDER_TILE_W;
constexpr int kThreads = 256;
constexpr float kMinSigma = -3.90524291751269967465540850526868f;
// rows a thread computes of a stage (a strip): Gaborish, an EPF pass
constexpr int kGabStrip = 4;
constexpr int kEpfStrip = 2;
static_assert(kTileW % 16 == 0, "u8 rows are stored in 16-byte vectors");

struct TailParams {
  const float* in;
  void* out;
  const float* inv_sigma;  // [B, ceil(H/8), ceil(W/8)]
  const float* sad_mul;    // [H, W]
  const float* gab;        // [c][dy][dx], device memory
  float cs[3];
  float sigma_scale[3];    // passes 0, 1, 2
  float opsin[9];          // [i][j]
  float cbrt_bias;
  float bias;
  int H, W;
};

constexpr bool chain_has(int first, int last, int pass) {
  return first <= pass && pass <= last;
}

template <bool kGab, int kFirst, int kLast>
struct Chain {
  static constexpr bool kHas0 = chain_has(kFirst, kLast, 0);
  static constexpr bool kHas1 = chain_has(kFirst, kLast, 1);
  static constexpr bool kHas2 = chain_has(kFirst, kLast, 2);
  // margins: the cells a side that a stage's output band lacks
  static constexpr int kAfterGab = kGab ? 1 : 0;
  static constexpr int kAfter0 = kAfterGab + (kHas0 ? 3 : 0);
  static constexpr int kAfter1 = kAfter0 + (kHas1 ? 2 : 0);
  static constexpr int kHalo = kAfter1 + (kHas2 ? 1 : 0);
  static constexpr int kH = kTileH + 2 * kHalo;
  static constexpr int kW = kTileW + 2 * kHalo;
  static constexpr int kPlane = kH * kW;
  static constexpr int kDiffPlanes = kHas0 ? 6 : (kHas1 ? 2 : 0);
  static constexpr int kFloats = (6 + kDiffPlanes) * kPlane;
};

struct Tile {
  int b;
  int oy, ox;  // image coordinates of buffer cell (0, 0)
  bool edge;   // the buffer reaches outside the image
};

__device__ __forceinline__ int mirror(int i, int n) {
  return i < 0 ? -1 - i : (i >= n ? 2 * n - 1 - i : i);
}

template <class C>
__device__ void load_tile(const TailParams& p, const Tile& t, float* buf) {
  const size_t plane = (size_t)p.H * p.W;
  const float* src = p.in + (size_t)t.b * 3 * plane;
  for (int i = threadIdx.x; i < C::kPlane; i += blockDim.x) {
    const int y = i / C::kW;
    const int x = i - y * C::kW;
    // clamped: cells past one reflection are never read into a result
    const int iy = min(max(mirror(t.oy + y, p.H), 0), p.H - 1);
    const int ix = min(max(mirror(t.ox + x, p.W), 0), p.W - 1);
    const size_t o = (size_t)iy * p.W + ix;
    buf[i] = __ldg(src + o);
    buf[i + C::kPlane] = __ldg(src + o + plane);
    buf[i + 2 * C::kPlane] = __ldg(src + o + 2 * plane);
  }
}

// After a stage whose output band has margin M: the band's out-of-image
// cells within the later stages' reach take the mirror of the stage's
// output (an in-image cell of the same band).
template <class C, int M>
__device__ void refill_edge(const TailParams& p, const Tile& t, float* buf) {
  constexpr int kBH = C::kH - 2 * M;
  constexpr int kBW = C::kW - 2 * M;
  constexpr int kDepth = C::kHalo - M;
  if (!t.edge) return;
  for (int i = threadIdx.x; i < kBH * kBW; i += blockDim.x) {
    const int y = M + i / kBW;
    const int x = M + i % kBW;
    const int iy = t.oy + y;
    const int ix = t.ox + x;
    if (iy >= 0 && iy < p.H && ix >= 0 && ix < p.W) continue;
    if (iy < -kDepth || iy >= p.H + kDepth || ix < -kDepth ||
        ix >= p.W + kDepth)
      continue;
    const int s = (mirror(iy, p.H) - t.oy) * C::kW + mirror(ix, p.W) - t.ox;
    const int d = y * C::kW + x;
    buf[d] = buf[s];
    buf[d + C::kPlane] = buf[s + C::kPlane];
    buf[d + 2 * C::kPlane] = buf[s + 2 * C::kPlane];
  }
  __syncthreads();
}

// fn(y0, x) for every strip of S rows of the band of margin M: a thread's
// S cells of one column, neighbouring threads on neighbouring columns.
// The last strip of a band whose height S does not divide is moved up
// onto its neighbour, whose rows it computes again to the same values.
template <class C, int M, int S, class F>
__device__ __forceinline__ void for_strips(F&& fn) {
  constexpr int kBH = C::kH - 2 * M;
  constexpr int kBW = C::kW - 2 * M;
  constexpr int kStrips = (kBH + S - 1) / S;
  static_assert(kBH >= S, "a band is at least one strip high");
  for (int i = threadIdx.x; i < kStrips * kBW; i += blockDim.x) {
    const int g = i / kBW;
    fn(M + min(g * S, kBH - S), M + i % kBW);
  }
}

// Gaborish's 3x3 per-channel blur onto the band of margin M, summed in
// gaborish_jax's order (dy, then dx). A strip loads its (S + 2) x 3
// window a channel once: its loads come before its stores, so the
// compiler merges the loads the strip's rows share.
template <class C, int M>
__device__ void gaborish(const TailParams& p, const float* in, float* out) {
  float kern[27];
#pragma unroll
  for (int i = 0; i < 27; ++i) kern[i] = __ldg(p.gab + i);
  for_strips<C, M, kGabStrip>([&](int y0, int x) {
    const int o0 = y0 * C::kW + x;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float* k = kern + 9 * c;
      float res[kGabStrip];
#pragma unroll
      for (int r = 0; r < kGabStrip; ++r) {
        const float* s = in + c * C::kPlane + o0 + r * C::kW;
        float acc = k[0] * s[-C::kW - 1];
        acc += k[1] * s[-C::kW];
        acc += k[2] * s[-C::kW + 1];
        acc += k[3] * s[-1];
        acc += k[4] * s[0];
        acc += k[5] * s[1];
        acc += k[6] * s[C::kW - 1];
        acc += k[7] * s[C::kW];
        acc += k[8] * s[C::kW + 1];
        res[r] = acc;
      }
#pragma unroll
      for (int r = 0; r < kGabStrip; ++r)
        out[c * C::kPlane + o0 + r * C::kW] = res[r];
    }
  });
}

// A pass's neighbours in _EPF*_NEIGHBORS order. Passes 0 and 1 read their
// SADs from cross-difference planes: neighbour (dy, dx) reads plane
// `plane` (direction dir(plane)) at the tap plus (qy, qx), which is (0, 0)
// when the plane's direction is the neighbour's and (dy, dx) when it is
// the opposite one.
template <int PASS>
struct Epf;

template <>
struct Epf<0> {
  static constexpr int kNeighbors = 12;
  static constexpr int kPlanes = 6;
  __device__ static void dir(int j, int& dy, int& dx) {
    const int t[6][2] = {{1, 0}, {2, 0}, {0, 1}, {0, 2}, {1, 1}, {1, -1}};
    dy = t[j][0];
    dx = t[j][1];
  }
  __device__ static void neighbor(int k, int& dy, int& dx, int& plane,
                                  int& qy, int& qx) {
    const int t[12][5] = {{-2, 0, 1, -2, 0}, {-1, -1, 4, -1, -1},
                          {-1, 0, 0, -1, 0}, {-1, 1, 5, -1, 1},
                          {0, -2, 3, 0, -2}, {0, -1, 2, 0, -1},
                          {0, 1, 2, 0, 0},   {0, 2, 3, 0, 0},
                          {1, -1, 5, 0, 0},  {1, 0, 0, 0, 0},
                          {1, 1, 4, 0, 0},   {2, 0, 1, 0, 0}};
    dy = t[k][0];
    dx = t[k][1];
    plane = t[k][2];
    qy = t[k][3];
    qx = t[k][4];
  }
};

template <>
struct Epf<1> {
  static constexpr int kNeighbors = 4;
  static constexpr int kPlanes = 2;
  __device__ static void dir(int j, int& dy, int& dx) {
    dy = j == 0 ? 1 : 0;
    dx = j == 0 ? 0 : 1;
  }
  __device__ static void neighbor(int k, int& dy, int& dx, int& plane,
                                  int& qy, int& qx) {
    const int t[4][5] = {{-1, 0, 0, -1, 0}, {0, -1, 1, 0, -1},
                         {0, 1, 1, 0, 0},   {1, 0, 0, 0, 0}};
    dy = t[k][0];
    dx = t[k][1];
    plane = t[k][2];
    qy = t[k][3];
    qx = t[k][4];
  }
};

template <>
struct Epf<2> {
  static constexpr int kNeighbors = 4;
  static constexpr int kPlanes = 0;
  __device__ static void neighbor(int k, int& dy, int& dx, int& plane,
                                  int& qy, int& qx) {
    const int t[4][2] = {{-1, 0}, {0, -1}, {0, 1}, {1, 0}};
    dy = t[k][0];
    dx = t[k][1];
    plane = qy = qx = 0;
  }
};

__device__ __forceinline__ float channel_diff(const float* in, int plane,
                                              int a, int b,
                                              const float (&cs)[3]) {
  return fabsf(in[a] - in[b]) * cs[0] +
         fabsf(in[a + plane] - in[b + plane]) * cs[1] +
         fabsf(in[a + 2 * plane] - in[b + 2 * plane]) * cs[2];
}

// The cross-difference planes of pass PASS on its input band (margin MI),
// where both cells of a difference lie in the band.
template <class C, int PASS, int MI>
__device__ void diff_planes(const TailParams& p, const float* in,
                            float* diff) {
  using G = Epf<PASS>;
  constexpr int kBH = C::kH - 2 * MI;
  constexpr int kBW = C::kW - 2 * MI;
  for (int i = threadIdx.x; i < kBH * kBW; i += blockDim.x) {
    const int y = MI + i / kBW;
    const int x = MI + i % kBW;
    const int o = y * C::kW + x;
#pragma unroll
    for (int j = 0; j < G::kPlanes; ++j) {
      int dy, dx;
      G::dir(j, dy, dx);  // dy >= 0
      if (y + dy >= C::kH - MI || x + dx < MI || x + dx >= C::kW - MI)
        continue;
      diff[j * C::kPlane + o] =
          channel_diff(in, C::kPlane, o, o + dy * C::kW + dx, p.cs);
    }
  }
}

// One EPF pass onto the band of margin MO, a strip of S rows a thread, its
// loads merged as in gaborish. Out-of-image cells are computed too (with
// sigma and the SAD map read at the nearest in-image pixel) and then
// refilled or never read.
template <class C, int PASS, int MO>
__device__ void epf_out(const TailParams& p, const Tile& t, const float* in,
                        const float* diff, float* out) {
  using G = Epf<PASS>;
  constexpr int S = kEpfStrip;
  const int nbx = (p.W + 7) >> 3;
  const int nby = (p.H + 7) >> 3;
  const float* isig_b = p.inv_sigma + (size_t)t.b * nby * nbx;
  for_strips<C, MO, S>([&](int y0, int x) {
    const int o0 = y0 * C::kW + x;
    const int ix = min(max(t.ox + x, 0), p.W - 1);
    float res[3][S];
#pragma unroll
    for (int r = 0; r < S; ++r) {
      const int o = o0 + r * C::kW;
      const int iy = min(max(t.oy + y0 + r, 0), p.H - 1);
      const float c0 = in[o];
      const float c1 = in[o + C::kPlane];
      const float c2 = in[o + 2 * C::kPlane];
      const float isig = __ldg(isig_b + (iy >> 3) * nbx + (ix >> 3));
      // _epf_pass: inv_sigma * (sad_mul * sigma_scale * 1.65)
      const float inv =
          isig * (__ldg(p.sad_mul + (size_t)iy * p.W + ix) *
                  p.sigma_scale[PASS] * 1.65f);
      float n0 = c0, n1 = c1, n2 = c2, den = 1.0f;
#pragma unroll
      for (int k = 0; k < G::kNeighbors; ++k) {
        int dy, dx, j, qy, qx;
        G::neighbor(k, dy, dx, j, qy, qx);
        const int s = o + dy * C::kW + dx;
        float sad;
        if constexpr (G::kPlanes == 0) {
          sad = channel_diff(in, C::kPlane, o, s, p.cs);
        } else {
          // the plus pattern's taps in _EPF_PLUS order
          const float* d = diff + j * C::kPlane + o + qy * C::kW + qx;
          sad = d[0];
          sad += d[-C::kW];
          sad += d[C::kW];
          sad += d[-1];
          sad += d[1];
        }
        const float w = fmaxf(0.0f, 1.0f + sad * inv);
        n0 += w * in[s];
        n1 += w * in[s + C::kPlane];
        n2 += w * in[s + 2 * C::kPlane];
        den += w;
      }
      const bool skip = isig < kMinSigma;  // the pass-through
      const float rden = 1.0f / den;
      res[0][r] = skip ? c0 : n0 * rden;
      res[1][r] = skip ? c1 : n1 * rden;
      res[2][r] = skip ? c2 : n2 * rden;
    }
#pragma unroll
    for (int r = 0; r < S; ++r) {
      out[o0 + r * C::kW] = res[0][r];
      out[o0 + r * C::kW + C::kPlane] = res[1][r];
      out[o0 + r * C::kW + 2 * C::kPlane] = res[2][r];
    }
  });
}

// Pass PASS from the band of margin MI to the band of margin MO; the
// result ends in `out`.
template <class C, int PASS, int MI, int MO>
__device__ void epf_stage(const TailParams& p, const Tile& t,
                          const float* in, float* out, float* diff) {
  if constexpr (Epf<PASS>::kPlanes > 0) {
    diff_planes<C, PASS, MI>(p, in, diff);
    __syncthreads();
  }
  epf_out<C, PASS, MO>(p, t, in, diff, out);
  __syncthreads();
  if constexpr (MO < C::kHalo) refill_edge<C, MO>(p, t, out);
}

// xyb_to_rgb then srgb_u8, as ops/pipeline.py writes them; x^(1/2.4) as
// exp2(log2(x) / 2.4), a few ulp from powf at a sixth of its cost.
__device__ __forceinline__ uint8_t srgb_u8(float v) {
  const float s =
      v <= 0.0031308f
          ? v * 12.92f
          : 1.055f * exp2f(log2f(fmaxf(v, 1e-12f)) * (1.0f / 2.4f)) - 0.055f;
  // torch.round rounds half to even, as rintf does (roundf does not)
  return (uint8_t)fminf(fmaxf(rintf(s * 255.0f), 0.0f), 255.0f);
}

template <class C>
__device__ void write_srgb(const TailParams& p, const Tile& t,
                           const float* in, uint8_t* stage) {
  constexpr int kRow = kTileW * 3;  // bytes of a staged tile row
  for (int i = threadIdx.x; i < kTileH * kTileW; i += blockDim.x) {
    const int ty = i / kTileW;
    const int tx = i % kTileW;
    const int o = (C::kHalo + ty) * C::kW + C::kHalo + tx;
    const float gr = in[o + C::kPlane] + in[o] + p.cbrt_bias;
    const float gg = in[o + C::kPlane] - in[o] + p.cbrt_bias;
    const float gb = in[o + 2 * C::kPlane] + p.cbrt_bias;
    const float m0 = gr * gr * gr - p.bias;
    const float m1 = gg * gg * gg - p.bias;
    const float m2 = gb * gb * gb - p.bias;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float* row = p.opsin + 3 * c;
      stage[ty * kRow + tx * 3 + c] =
          srgb_u8(row[0] * m0 + row[1] * m1 + row[2] * m2);
    }
  }
  __syncthreads();
  const int y0 = t.oy + C::kHalo;
  const int x0 = t.ox + C::kHalo;
  const int rows = min(kTileH, p.H - y0);
  const int cols = min(kTileW, p.W - x0);
  uint8_t* dst = static_cast<uint8_t*>(p.out) + (size_t)t.b * p.H * p.W * 3;
  if (cols == kTileW && (p.W & 15) == 0) {
    // whole rows, 16-byte aligned: x0 * 3 and W * 3 are multiples of 16
    constexpr int kVec = kRow / 16;
    for (int i = threadIdx.x; i < rows * kVec; i += blockDim.x) {
      const int r = i / kVec;
      const int v = i - r * kVec;
      reinterpret_cast<uint4*>(dst + ((size_t)(y0 + r) * p.W + x0) * 3)[v] =
          reinterpret_cast<const uint4*>(stage + r * kRow)[v];
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols * 3; i += blockDim.x) {
      const int r = i / (cols * 3);
      const int k = i - r * cols * 3;
      dst[((size_t)(y0 + r) * p.W + x0) * 3 + k] = stage[r * kRow + k];
    }
  }
}

template <class C>
__device__ void write_xyb(const TailParams& p, const Tile& t,
                          const float* in) {
  const size_t plane = (size_t)p.H * p.W;
  float* dst = static_cast<float*>(p.out) + (size_t)t.b * 3 * plane;
  const int y0 = t.oy + C::kHalo;
  const int x0 = t.ox + C::kHalo;
  for (int i = threadIdx.x; i < kTileH * kTileW; i += blockDim.x) {
    const int ty = i / kTileW;
    const int tx = i % kTileW;
    if (y0 + ty >= p.H || x0 + tx >= p.W) continue;
    const int o = (C::kHalo + ty) * C::kW + C::kHalo + tx;
    const size_t g = (size_t)(y0 + ty) * p.W + x0 + tx;
    dst[g] = in[o];
    dst[g + plane] = in[o + C::kPlane];
    dst[g + 2 * plane] = in[o + 2 * C::kPlane];
  }
}

template <bool kGab, int kFirst, int kLast, bool kU8>
__global__ void __launch_bounds__(kThreads)
render_tail_kernel(const TailParams p) {
  using C = Chain<kGab, kFirst, kLast>;
  extern __shared__ __align__(16) float smem[];
  float* cur = smem;
  float* nxt = smem + 3 * C::kPlane;
  float* diff = smem + 6 * C::kPlane;
  Tile t;
  t.b = blockIdx.z;
  t.oy = (int)blockIdx.y * kTileH - C::kHalo;
  t.ox = (int)blockIdx.x * kTileW - C::kHalo;
  t.edge = t.oy < 0 || t.ox < 0 || t.oy + C::kH > p.H || t.ox + C::kW > p.W;
  load_tile<C>(p, t, cur);
  __syncthreads();
  if constexpr (kGab) {
    gaborish<C, C::kAfterGab>(p, cur, nxt);
    __syncthreads();
    if constexpr (C::kAfterGab < C::kHalo)
      refill_edge<C, C::kAfterGab>(p, t, nxt);
    float* s = cur;
    cur = nxt;
    nxt = s;
  }
  if constexpr (C::kHas0) {
    epf_stage<C, 0, C::kAfterGab, C::kAfter0>(p, t, cur, nxt, diff);
    float* s = cur;
    cur = nxt;
    nxt = s;
  }
  if constexpr (C::kHas1) {
    epf_stage<C, 1, C::kAfter0, C::kAfter1>(p, t, cur, nxt, diff);
    float* s = cur;
    cur = nxt;
    nxt = s;
  }
  if constexpr (C::kHas2) {
    epf_stage<C, 2, C::kAfter1, C::kHalo>(p, t, cur, nxt, diff);
    float* s = cur;
    cur = nxt;
    nxt = s;
  }
  if constexpr (kU8) {
    write_srgb<C>(p, t, cur, reinterpret_cast<uint8_t*>(nxt));
  } else {
    write_xyb<C>(p, t, cur);
  }
}

template <bool kGab, int kFirst, int kLast, bool kU8>
cudaError_t launch(const TailParams& p, int B, cudaStream_t stream) {
  using C = Chain<kGab, kFirst, kLast>;
  constexpr int kSmem = C::kFloats * (int)sizeof(float);
  auto kernel = render_tail_kernel<kGab, kFirst, kLast, kU8>;
  // above 48 KB a launch is refused unless the kernel is allowed more
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.W + kTileW - 1) / kTileW, (p.H + kTileH - 1) / kTileH,
                  B);
  kernel<<<grid, kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <bool kGab, bool kU8>
cudaError_t launch_chain(int first, int last, const TailParams& p, int B,
                         cudaStream_t s) {
  if (first == -1 && last == -1) return launch<kGab, -1, -1, kU8>(p, B, s);
  if (first == 1 && last == 1) return launch<kGab, 1, 1, kU8>(p, B, s);
  if (first == 1 && last == 2) return launch<kGab, 1, 2, kU8>(p, B, s);
  if (first == 0 && last == 2) return launch<kGab, 0, 2, kU8>(p, B, s);
  if constexpr (!kGab && !kU8) {
    // the single passes of kernels.epf_pass
    if (first == 0 && last == 0) return launch<false, 0, 0, false>(p, B, s);
    if (first == 2 && last == 2) return launch<false, 2, 2, false>(p, B, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// in f32 [B,3,H,W]; out f32 [B,3,H,W] (u8 == 0) or u8 [B,H,W,3] (u8 != 0),
// not overlapping `in`; inv_sigma f32 [B,ceil(H/8),ceil(W/8)] per block;
// sad_mul f32 [H,W], shared by the batch; gab f32 [3,3,3] or null (no
// Gaborish), all in device memory. Host arrays: cs f32[3], sigma_scale
// f32[3] (passes 0, 1, 2), opsin f32 [3,3]. EPF passes first..last, both -1 for none; the chains
// of epf_iters 0-3 take any gab/u8, a single pass 0 or 2 neither. H and W
// are at least the chain's halo. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int jxl_render_tail(const float* in, void* out,
                               const float* inv_sigma, const float* sad_mul,
                               const float* gab, int first, int last, int u8,
                               const float* cs, const float* sigma_scale,
                               const float* opsin, float cbrt_bias,
                               float bias, int B, int H, int W, void* stream,
                               int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  TailParams p;
  p.in = in;
  p.out = out;
  p.inv_sigma = inv_sigma;
  p.sad_mul = sad_mul;
  p.gab = gab;
  for (int i = 0; i < 3; ++i) {
    p.cs[i] = cs[i];
    p.sigma_scale[i] = sigma_scale[i];
  }
  for (int i = 0; i < 9; ++i) p.opsin[i] = opsin[i];
  p.cbrt_bias = cbrt_bias;
  p.bias = bias;
  p.H = H;
  p.W = W;
  cudaStream_t s = (cudaStream_t)stream;
  if (gab) {
    err = u8 ? launch_chain<true, true>(first, last, p, B, s)
             : launch_chain<true, false>(first, last, p, B, s);
  } else {
    err = u8 ? launch_chain<false, true>(first, last, p, B, s)
             : launch_chain<false, false>(first, last, p, B, s);
  }
  return (int)err;
}

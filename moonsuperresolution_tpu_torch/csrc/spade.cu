// SPADE's normalisation chain on the bf16 serving path, on Hopper (sm_90a):
// the moments' sums, then normalisation, modulation and LeakyReLU in one
// pass, and the residual block's closing bias adds and sum, in NCHW or in
// NHWC (channels_last) memory.
//
// Replaces no Pallas kernel: the JAX package leaves this chain to XLA's
// fusions (moonsuperresolution_tpu/models/layers.py::SPADE.__call__,
// spade_moments and SpadeResidualBlock.__call__).  In the port it was a
// dozen torch passes over full activation tensors (float32 copies, squares,
// subtract, multiply, casts, gamma * n, + beta, leaky_relu, the convs' bias
// adds, the residual sum); ops/spade.py keeps that chain as the kernels'
// plain versions.
//
// What it computes.  Every tensor is bf16 [B, C, H, W] by shape, stored
// either NCHW or NHWC (the "nhwc" flag; all tensors of one call share it).
// A bias is a bf16 vector over the channels, added as the separate bias
// pass of a conv adds it: v = bf16(v + bias[c]).
//   spade_sums:     s1 = sum x, s2 = sum x^2 in float32, per channel over
//                   (B, H, W) ("batch" statistics) or per (b, c) over (H, W)
//                   ("instance"); x read as bf16(x + xbias) when given.
//   spade_modulate: out = leaky_relu(gamma * bf16((x - mean) * r) + beta)
//                   in bf16, with gamma, beta the two channel halves of the
//                   gamma/beta conv's output gb [B, 2C, H, W] (read in
//                   place, each as bf16(g + gbbias[c]) and bf16(b +
//                   gbbias[C + c]) when gbbias is given), mean and r float32
//                   per channel [C] or per (b, c) [B * C], and x (with its
//                   xbias) either [B, C, H, W] or, with "up", the
//                   pre-upsample [B, C, H/2, W/2] read at (h >> 1, w >> 1):
//                   F.interpolate(scale_factor=2, mode="nearest") without
//                   writing it.
//   spade_residual: out = bf16(res' + bf16(h + hbias)), res' = bf16(res +
//                   rbias) when rbias is given (the learned skip's conv
//                   output) or res itself (the block input, read 2x
//                   nearest-upsampled with "up").
// Each step rounds as the torch chain does: float32 add, subtract, multiply
// (no FMA contraction: __fadd_rn, __fsub_rn, __fmul_rn), each result rounded
// to bf16 where torch's bf16 op rounds it; LeakyReLU as v > 0 ? v : v *
// alpha, rounded to bf16.  Given the same mean and r the outputs equal the
// plain versions' bit for bit.  The sums are taken in another order than
// torch's, so they agree to rounding.
//
// Bound on the card.  Every kernel here is bound by the bytes it moves: one
// to three float operations per byte, against the ~20 the H100's float32
// units can do per byte of its 3.35 TB/s.
//
// Design.
//   NCHW sums (spade_sums_partial, spade_sums_finish): one block per
//   (output, slice of its elements): 16-byte loads (8 bf16) where H*W % 8
//   == 0, float32 sums in registers, a warp-shuffle tree, then the warps'
//   partials summed in warp order; one thread per output then sums its
//   slices' partials in slice order.
//   NHWC sums (spade_sums_nhwc_partial, spade_sums_nhwc_finish): a block of
//   (TX channel groups) x (TY pixel lanes); each thread takes 8 channels
//   (one 16-byte load, C % 8 == 0; else one channel) and a block a range of
//   pixel rows, accumulating in float32 registers; the TY lanes are summed
//   in lane order through shared memory, the partials [ranges, C] in range
//   order by a second pass.  An "instance" range never crosses a sample.
//   Both: no float atomics, so the same input gives the same bits.  The
//   grids suit both ends of the plan (C = 1024 at 8 x 8, C = 128 at
//   256 x 256 x 16).
//   spade_modulate_kernel, spade_residual_kernel (NCHW): one thread per 8
//   consecutive pixels of a row of one channel (W % 8 == 0): 16-byte loads
//   and one 16-byte store, the "up" read 8 bytes of the pre-upsample row
//   (each value used twice); the channel's mean, r and biases are one
//   value, which the warp's threads share.
//   spade_modulate_nhwc, spade_residual_nhwc (NHWC): one thread per 8
//   channels (C % 8 == 0) of 4 consecutive pixels: 16-byte loads of each
//   pixel's values (the "up" read at the pre-upsample pixel) and one
//   16-byte store per pixel; the 8 channels' means, r and biases are read
//   once, with 16-byte loads, and stay in registers (read per output, they
//   would cost more cache traffic than the tensors themselves).
//   Other shapes take a scalar path, one thread per output.
//
// The C entry points launch on the caller's stream, allocate nothing (the
// caller passes the scratch for the partials) and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlice = 8192;          // elements one NCHW partial block reads
constexpr int kMaxSlices = 65535;     // gridDim.y
constexpr int kNhwcBlocks = 528;      // NHWC partial blocks aimed at (4/SM)
constexpr int kNhwcMinRows = 4;       // pixels a lane reads at least
constexpr int kPix = 4;               // pixels an NHWC 16-byte thread takes

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// v, or v + b rounded to bf16 (a conv's separate bias pass).
__device__ __forceinline__ float biased(float v, float b, bool has) {
  return has ? round_bf16(__fadd_rn(v, b)) : v;
}

__device__ __forceinline__ void unpack8(const uint4& v, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const bf16* o) {
  uint4 v;
  bf16* p = reinterpret_cast<bf16*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) p[i] = o[i];
  return v;
}

// 8 consecutive values of a bf16 vector (16-byte aligned) as floats.
__device__ __forceinline__ void load8(const bf16* p, float* f) {
  unpack8(__ldg(reinterpret_cast<const uint4*>(p)), f);
}

// ------------------------------------------------------------- NCHW sums

__device__ __forceinline__ float2 block_sum(float a, float b) {
  __shared__ float2 warp_part[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = make_float2(a, b);
  __syncthreads();
  float2 s = warp_part[0];
  for (int w = 1; w < kThreads / 32; ++w) {
    s.x += warp_part[w].x;
    s.y += warp_part[w].y;
  }
  return s;
}

// grid (n_out, n_slices).  Output o's element j (0 <= j < n) lies in plane
// (j / hw) * C + o ("batch") or o ("instance"), at offset j % hw.
template <bool VEC>
__global__ void spade_sums_partial(const bf16* __restrict__ x,
                                   const bf16* __restrict__ xbias, int C,
                                   int hw, int n, int batch, int slice,
                                   float2* __restrict__ part) {
  const int o = blockIdx.x;
  const int j0 = blockIdx.y * slice;
  const int j1 = min(j0 + slice, n);
  const bool has = xbias != nullptr;
  const float bv = has ? __bfloat162float(xbias[o % C]) : 0.f;
  float s1 = 0.f, s2 = 0.f;
  if (VEC) {
#pragma unroll 4
    for (int j = j0 + 8 * threadIdx.x; j < j1; j += 8 * kThreads) {
      const int q = j / hw;
      const int64_t plane = batch ? (int64_t)q * C + o : o;
      float f[8];
      unpack8(__ldg(reinterpret_cast<const uint4*>(x + plane * hw +
                                                   (j - q * hw))), f);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float v = biased(f[i], bv, has);
        s1 += v;
        s2 += v * v;
      }
    }
  } else {
    for (int j = j0 + threadIdx.x; j < j1; j += kThreads) {
      const int q = j / hw;
      const int64_t plane = batch ? (int64_t)q * C + o : o;
      const float v =
          biased(__bfloat162float(x[plane * hw + (j - q * hw)]), bv, has);
      s1 += v;
      s2 += v * v;
    }
  }
  const float2 s = block_sum(s1, s2);
  if (threadIdx.x == 0) part[(int64_t)o * gridDim.y + blockIdx.y] = s;
}

__global__ void spade_sums_finish(const float2* __restrict__ part, int n_out,
                                  int n_slices, float* __restrict__ s1,
                                  float* __restrict__ s2) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n_out) return;
  const float2* p = part + (int64_t)o * n_slices;
  float a = 0.f, b = 0.f;
  for (int s = 0; s < n_slices; ++s) {
    a += p[s].x;
    b += p[s].y;
  }
  s1[o] = a;
  s2[o] = b;
}

// ------------------------------------------------------------- NHWC sums

// grid (channel tiles, ranges, samples ("instance") or 1), block (TX, TY).
// x: [samples, n, C] with n pixels a sample ("instance") or all B*H*W
// pixels in one sample ("batch").  Thread (tx, ty) sums channels [c0, c0 +
// V) over pixels ty, ty + TY, ... of its block's range; part[(z * ranges +
// range) * C + c] gets the range's (s1, s2) of channel c.
template <int V>
__global__ void spade_sums_nhwc_partial(const bf16* __restrict__ x,
                                        const bf16* __restrict__ xbias,
                                        int C, int n, int rows,
                                        float2* __restrict__ part) {
  __shared__ float2 lanes[kThreads * V];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int TX = blockDim.x, TY = blockDim.y;
  const int c0 = (blockIdx.x * TX + tx) * V;
  const bool live = c0 < C;
  const bool has = xbias != nullptr;
  float s1[V], s2[V], bv[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s1[i] = s2[i] = bv[i] = 0.f;
  if (live) {
    if (has) {
      if (V == 8) {
        load8(xbias + c0, bv);
      } else {
        bv[0] = __bfloat162float(xbias[c0]);
      }
    }
    const int p0 = blockIdx.y * rows;
    const int p1 = min(p0 + rows, n);
    const bf16* xs = x + (int64_t)blockIdx.z * n * C + c0;
    for (int p = p0 + ty; p < p1; p += TY) {
      float f[V];
      if (V == 8) {
        unpack8(__ldg(reinterpret_cast<const uint4*>(xs + (int64_t)p * C)),
                f);
      } else {
        f[0] = __bfloat162float(xs[(int64_t)p * C]);
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float v = biased(f[i], bv[i], has);
        s1[i] += v;
        s2[i] += v * v;
      }
    }
  }
  const int t = ty * TX + tx;
#pragma unroll
  for (int i = 0; i < V; ++i) lanes[t * V + i] = make_float2(s1[i], s2[i]);
  __syncthreads();
  if (ty != 0 || !live) return;
  float2* out = part + ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * C + c0;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float2 a = lanes[tx * V + i];
    for (int k = 1; k < TY; ++k) {
      const float2 b = lanes[(k * TX + tx) * V + i];
      a.x += b.x;
      a.y += b.y;
    }
    out[i] = a;
  }
}

// One thread per output o = z * C + c: its ranges' partials in range order.
__global__ void spade_sums_nhwc_finish(const float2* __restrict__ part, int C,
                                       int n_out, int ranges,
                                       float* __restrict__ s1,
                                       float* __restrict__ s2) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n_out) return;
  const int z = o / C;
  const float2* p = part + (int64_t)z * ranges * C + (o - z * C);
  float a = 0.f, b = 0.f;
  for (int r = 0; r < ranges; ++r) {
    a += p[(int64_t)r * C].x;
    b += p[(int64_t)r * C].y;
  }
  s1[o] = a;
  s2[o] = b;
}

struct NhwcSumsGrid {
  dim3 grid, block;
  int vec, rows;
};

// vec: 8 channels a thread (C % 8 == 0) or 1.
NhwcSumsGrid nhwc_sums_grid(int B, int C, int hw, int instance, int vec) {
  NhwcSumsGrid g;
  g.vec = vec;
  const int groups = C / g.vec;
  int tx = 1;
  while (tx < groups && tx < kThreads) tx *= 2;
  const int ty = kThreads / tx;
  const int tiles = (groups + tx - 1) / tx;
  const int z = instance ? B : 1;
  const int n = instance ? hw : B * hw;
  const int most = (n + ty * kNhwcMinRows - 1) / (ty * kNhwcMinRows);
  int ranges = (kNhwcBlocks + tiles * z - 1) / (tiles * z);
  ranges = ranges < most ? ranges : most;
  ranges = ranges < 1 ? 1 : ranges;
  int rows = (n + ranges - 1) / ranges;
  rows = (rows + ty - 1) / ty * ty;
  g.rows = rows;
  g.grid = dim3(tiles, (n + rows - 1) / rows, z);
  g.block = dim3(tx, ty);
  return g;
}

// ------------------------------------------------------- modulate, residual

__device__ __forceinline__ float normalize(float xv, float mean, float r) {
  return round_bf16(__fmul_rn(__fsub_rn(xv, mean), r));
}

__device__ __forceinline__ bf16 modulate(float n, float g, float b,
                                         float alpha) {
  const float v = round_bf16(__fadd_rn(round_bf16(__fmul_rn(g, n)), b));
  return __float2bfloat16_rn(v > 0.f ? v : __fmul_rn(v, alpha));
}

struct Geom {
  int C, H, W;
  int instance;
  float alpha;
  int total;  // B * C * H * W outputs
};

// Where output e (its linear index in the layout) lies: its sample, its
// channel, its pixel b * H * W + h * W + w, and the offset of the same
// (b, c) at the pre-upsample pixel (h >> 1, w >> 1) of a [B, C, H/2, W/2]
// tensor.  Every offset is below 2^31 (the wrappers check the sizes), so
// the index math is 32-bit.
struct At {
  int b, c, pix, half;
};

template <bool NHWC>
__device__ __forceinline__ At locate(int e, const Geom& g) {
  At a;
  const int hw = g.H * g.W;
  int p;
  if (NHWC) {
    a.pix = e / g.C;
    a.c = e - a.pix * g.C;
    a.b = a.pix / hw;
    p = a.pix - a.b * hw;
  } else {
    const int plane = e / hw;
    p = e - plane * hw;
    a.b = plane / g.C;
    a.c = plane - a.b * g.C;
    a.pix = a.b * hw + p;
  }
  const int h = p / g.W;
  const int w = p - h * g.W;
  const int hp = (a.b * (g.H >> 1) + (h >> 1)) * (g.W >> 1) + (w >> 1);
  a.half = NHWC ? hp * g.C + a.c
                : (a.b * g.C + a.c) * (hw / 4) + (h >> 1) * (g.W >> 1) +
                      (w >> 1);
  return a;
}

// Offset of gamma of output (b, c, pixel) in gb [B, 2C, H, W]; beta lies
// beta_step() further.
template <bool NHWC>
__device__ __forceinline__ int gamma_at(const At& a, const Geom& g) {
  const int hw = g.H * g.W;
  return NHWC ? a.pix * 2 * g.C + a.c
              : (a.b * 2 * g.C + a.c) * hw + (a.pix - a.b * hw);
}

template <bool NHWC>
__device__ __forceinline__ int beta_step(const Geom& g) {
  return NHWC ? g.C : g.C * g.H * g.W;
}

// NCHW reads 8 pixels of a row at (h >> 1, w >> 1): 4 values, each twice.
__device__ __forceinline__ void load_up8(const bf16* p, float* f) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2 t = __bfloat1622float2(q[i]);
    f[4 * i] = f[4 * i + 1] = t.x;
    f[4 * i + 2] = f[4 * i + 3] = t.y;
  }
}

// VEC (NCHW only, W % 8 == 0, 16-byte aligned): thread t writes outputs
// [8t, 8t + 8), 8 pixels of a row of one channel; otherwise (either
// layout) thread t writes output t.  NHWC's 16-byte path is
// spade_modulate_nhwc.
template <bool VEC, bool UP, bool NHWC>
__global__ void spade_modulate_kernel(const bf16* __restrict__ x,
                                      const bf16* __restrict__ xbias,
                                      const bf16* __restrict__ gb,
                                      const bf16* __restrict__ gbbias,
                                      const float* __restrict__ mean,
                                      const float* __restrict__ rstd,
                                      bf16* __restrict__ out, Geom g) {
  static_assert(!(VEC && NHWC), "NHWC's 16-byte path is its own kernel");
  constexpr int V = VEC ? 8 : 1;
  const int64_t e64 = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * V;
  if (e64 >= g.total) return;
  const int e = (int)e64;
  const At a = locate<NHWC>(e, g);
  const int gi = gamma_at<NHWC>(a, g);
  const int bi = gi + beta_step<NHWC>(g);
  const int xi = UP ? a.half : e;
  const int stat = g.instance ? a.b * g.C + a.c : a.c;
  const bool hx = xbias != nullptr, hg = gbbias != nullptr;
  const float m = __ldg(mean + stat), r = __ldg(rstd + stat);
  const float bx = hx ? __bfloat162float(xbias[a.c]) : 0.f;
  const float bg = hg ? __bfloat162float(gbbias[a.c]) : 0.f;
  const float bb = hg ? __bfloat162float(gbbias[g.C + a.c]) : 0.f;
  if (VEC) {
    float xv[8], gv[8], bv[8];
    if (UP) {
      load_up8(x + xi, xv);
    } else {
      load8(x + xi, xv);
    }
    load8(gb + gi, gv);
    load8(gb + bi, bv);
    bf16 o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float n = normalize(biased(xv[i], bx, hx), m, r);
      o[i] = modulate(n, biased(gv[i], bg, hg), biased(bv[i], bb, hg),
                      g.alpha);
    }
    *reinterpret_cast<uint4*>(out + e) = pack8(o);
  } else {
    const float n = normalize(biased(__bfloat162float(x[xi]), bx, hx), m, r);
    out[e] = modulate(n, biased(__bfloat162float(gb[gi]), bg, hg),
                      biased(__bfloat162float(gb[bi]), bb, hg), g.alpha);
  }
}

// As spade_modulate_kernel: VEC is NCHW's 16-byte path; NHWC's is
// spade_residual_nhwc.
template <bool VEC, bool UP, bool NHWC>
__global__ void spade_residual_kernel(const bf16* __restrict__ h,
                                      const bf16* __restrict__ hbias,
                                      const bf16* __restrict__ res,
                                      const bf16* __restrict__ rbias,
                                      bf16* __restrict__ out, Geom g) {
  static_assert(!(VEC && NHWC), "NHWC's 16-byte path is its own kernel");
  constexpr int V = VEC ? 8 : 1;
  const int64_t e64 = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * V;
  if (e64 >= g.total) return;
  const int e = (int)e64;
  const At a = locate<NHWC>(e, g);
  const int ri = UP ? a.half : e;
  const bool hr = rbias != nullptr;
  const float bh = __bfloat162float(hbias[a.c]);
  const float br = hr ? __bfloat162float(rbias[a.c]) : 0.f;
  if (VEC) {
    float hv[8], rv[8];
    load8(h + e, hv);
    if (UP) {
      load_up8(res + ri, rv);
    } else {
      load8(res + ri, rv);
    }
    bf16 o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      o[i] = __float2bfloat16_rn(__fadd_rn(biased(rv[i], br, hr),
                                           biased(hv[i], bh, true)));
    }
    *reinterpret_cast<uint4*>(out + e) = pack8(o);
  } else {
    out[e] = __float2bfloat16_rn(
        __fadd_rn(biased(__bfloat162float(res[ri]), br, hr),
                  biased(__bfloat162float(h[e]), bh, true)));
  }
}

// NHWC, 16-byte path: thread t takes channels [c, c + 8) (c = 8 * (t % (C /
// 8))) of PIX consecutive pixels; the per-channel values (mean, r, the
// biases) are read once, with 16-byte loads, and kept in registers.  PIX
// divides H * W, so the pixels share a sample.
template <int PIX>
struct NhwcTile {
  int c, p0, b;
  bool live;
};

template <int PIX>
__device__ __forceinline__ NhwcTile<PIX> nhwc_tile(const Geom& g) {
  NhwcTile<PIX> t;
  const int groups = g.C / 8;
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t pb = i / groups;
  t.c = (int)(i - pb * groups) * 8;
  const int64_t p0 = pb * PIX;
  t.live = p0 < g.total / g.C;
  t.p0 = t.live ? (int)p0 : 0;
  t.b = t.p0 / (g.H * g.W);
  return t;
}

// The pre-upsample offset of channel c of pixel p (its sample b) in a
// [B, H/2, W/2, C] tensor.
__device__ __forceinline__ int nhwc_half(int p, int b, int c, const Geom& g) {
  const int q = p - b * g.H * g.W;
  const int h = q / g.W, w = q - (q / g.W) * g.W;
  return ((b * (g.H >> 1) + (h >> 1)) * (g.W >> 1) + (w >> 1)) * g.C + c;
}

__device__ __forceinline__ void load8f(const float* p, float* f) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

template <bool UP, int PIX>
__global__ void spade_modulate_nhwc(const bf16* __restrict__ x,
                                    const bf16* __restrict__ xbias,
                                    const bf16* __restrict__ gb,
                                    const bf16* __restrict__ gbbias,
                                    const float* __restrict__ mean,
                                    const float* __restrict__ rstd,
                                    bf16* __restrict__ out, Geom g) {
  const NhwcTile<PIX> t = nhwc_tile<PIX>(g);
  if (!t.live) return;
  const bool hx = xbias != nullptr, hg = gbbias != nullptr;
  const int stat = (g.instance ? t.b * g.C : 0) + t.c;
  float m[8], r[8], bx[8], bg[8], bb[8];
  load8f(mean + stat, m);
  load8f(rstd + stat, r);
#pragma unroll
  for (int i = 0; i < 8; ++i) bx[i] = bg[i] = bb[i] = 0.f;
  if (hx) load8(xbias + t.c, bx);
  if (hg) {
    load8(gbbias + t.c, bg);
    load8(gbbias + g.C + t.c, bb);
  }
#pragma unroll
  for (int q = 0; q < PIX; ++q) {
    const int p = t.p0 + q;
    const int e = p * g.C + t.c;
    const int gi = p * 2 * g.C + t.c;
    float xv[8], gv[8], bv[8];
    load8(x + (UP ? nhwc_half(p, t.b, t.c, g) : e), xv);
    load8(gb + gi, gv);
    load8(gb + gi + g.C, bv);
    bf16 o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float n = normalize(biased(xv[i], bx[i], hx), m[i], r[i]);
      o[i] = modulate(n, biased(gv[i], bg[i], hg), biased(bv[i], bb[i], hg),
                      g.alpha);
    }
    *reinterpret_cast<uint4*>(out + e) = pack8(o);
  }
}

template <bool UP, int PIX>
__global__ void spade_residual_nhwc(const bf16* __restrict__ h,
                                    const bf16* __restrict__ hbias,
                                    const bf16* __restrict__ res,
                                    const bf16* __restrict__ rbias,
                                    bf16* __restrict__ out, Geom g) {
  const NhwcTile<PIX> t = nhwc_tile<PIX>(g);
  if (!t.live) return;
  const bool hr = rbias != nullptr;
  float bh[8], br[8];
  load8(hbias + t.c, bh);
#pragma unroll
  for (int i = 0; i < 8; ++i) br[i] = 0.f;
  if (hr) load8(rbias + t.c, br);
#pragma unroll
  for (int q = 0; q < PIX; ++q) {
    const int p = t.p0 + q;
    const int e = p * g.C + t.c;
    float hv[8], rv[8];
    load8(h + e, hv);
    load8(res + (UP ? nhwc_half(p, t.b, t.c, g) : e), rv);
    bf16 o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      o[i] = __float2bfloat16_rn(__fadd_rn(biased(rv[i], br[i], hr),
                                           biased(hv[i], bh[i], true)));
    }
    *reinterpret_cast<uint4*>(out + e) = pack8(o);
  }
}

void nchw_sums_grid(int B, int hw, int instance, int* n, int* slice,
                    int* n_slices) {
  *n = instance ? hw : B * hw;
  int s = kSlice;
  while ((*n + s - 1) / s > kMaxSlices) s *= 2;
  *slice = s;
  *n_slices = (*n + s - 1) / s;
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The 16-byte path: 8 outputs a thread.  NCHW: a row holds whole groups of
// 8 (W % 8 == 0); NHWC: a pixel does (C % 8 == 0).  The per-channel values
// (means, biases) are read one by one, from the cache.
bool vec_ok(int nhwc, int C, int W, const void* const* ptrs, int n_ptrs,
            const void* up_src, int up) {
  if (nhwc ? C % 8 != 0 : W % 8 != 0) return false;
  for (int i = 0; i < n_ptrs; ++i) {
    if (ptrs[i] != nullptr && !aligned(ptrs[i], 16)) return false;
  }
  return aligned(up_src, up && !nhwc ? 8 : 16);
}

}  // namespace

extern "C" {

// Floats of scratch that spade_sums needs.
int64_t spade_sums_scratch(int B, int C, int hw, int instance, int nhwc) {
  if (nhwc) {
    // Room for the 16-byte grid and the scalar one (a misaligned x).
    const NhwcSumsGrid g = nhwc_sums_grid(B, C, hw, instance, 1);
    int64_t ranges = g.grid.y;
    if (C % 8 == 0) {
      const NhwcSumsGrid g8 = nhwc_sums_grid(B, C, hw, instance, 8);
      ranges = g8.grid.y > ranges ? g8.grid.y : ranges;
    }
    return 2 * (int64_t)g.grid.z * ranges * C;
  }
  int n, slice, n_slices;
  nchw_sums_grid(B, hw, instance, &n, &slice, &n_slices);
  const int64_t n_out = instance ? (int64_t)B * C : C;
  return 2 * n_out * n_slices;
}

// x: [B, C, hw] (NCHW) or [B, hw, C] (nhwc) bf16; xbias: [C] bf16 or null.
// s1, s2: [C] ("batch") or [B * C] ("instance") float32.  scratch:
// spade_sums_scratch() floats.  Requires B * C * hw < 2^31.
int spade_sums(const bf16* x, const bf16* xbias, int B, int C, int hw,
               int instance, int nhwc, float* scratch, float* s1, float* s2,
               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float2* part = reinterpret_cast<float2*>(scratch);
  const int n_out = instance ? B * C : C;
  if (nhwc) {
    const bool vec = C % 8 == 0 && aligned(x, 16) &&
                     (xbias == nullptr || aligned(xbias, 16));
    const NhwcSumsGrid g = nhwc_sums_grid(B, C, hw, instance, vec ? 8 : 1);
    const int n = instance ? hw : B * hw;
    if (vec) {
      spade_sums_nhwc_partial<8><<<g.grid, g.block, 0, st>>>(
          x, xbias, C, n, g.rows, part);
    } else {
      spade_sums_nhwc_partial<1><<<g.grid, g.block, 0, st>>>(
          x, xbias, C, n, g.rows, part);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    spade_sums_nhwc_finish<<<(n_out + kThreads - 1) / kThreads, kThreads, 0,
                             st>>>(part, C, n_out, g.grid.y, s1, s2);
    return cudaGetLastError();
  }
  int n, slice, n_slices;
  nchw_sums_grid(B, hw, instance, &n, &slice, &n_slices);
  const dim3 grid(n_out, n_slices);
  if (hw % 8 == 0 && aligned(x, 16)) {
    spade_sums_partial<true><<<grid, kThreads, 0, st>>>(
        x, xbias, C, hw, n, !instance, slice, part);
  } else {
    spade_sums_partial<false><<<grid, kThreads, 0, st>>>(
        x, xbias, C, hw, n, !instance, slice, part);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  spade_sums_finish<<<(n_out + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      part, n_out, n_slices, s1, s2);
  return cudaGetLastError();
}

// x: [B, C, H, W] bf16, or [B, C, H/2, W/2] with up; xbias: [C] or null.
// gb: [B, 2C, H, W] bf16; gbbias: [2C] or null.  mean, rstd: [C] or
// (instance) [B * C] float32.  out: [B, C, H, W] bf16.  All NCHW, or all
// NHWC with nhwc.  Requires B * 2C * H * W < 2^31 and, with up, H and W
// even.
int spade_modulate(const bf16* x, const bf16* xbias, const bf16* gb,
                   const bf16* gbbias, const float* mean, const float* rstd,
                   bf16* out, int B, int C, int H, int W, int up, int instance,
                   int nhwc, float alpha, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geom g{C, H, W, instance, alpha, B * C * H * W};
  const void* ptrs[] = {gb, out};
  bool vec = vec_ok(nhwc, C, W, ptrs, 2, x, up);
  if (vec && nhwc) {
    // The 8 channels' means, r and biases in 16-byte loads.
    const void* per_channel[] = {mean, rstd, xbias, gbbias};
    vec = vec_ok(nhwc, C, W, per_channel, 4, x, up);
  }
  if (g.total == 0) return cudaSuccess;
  if (vec && nhwc) {
    const int pix = (H * W) % kPix == 0 ? kPix : 1;
    const int64_t threads = (int64_t)g.total / 8 / pix;
    const int blocks = (int)((threads + kThreads - 1) / kThreads);
#define SPADE_MOD_NHWC(U, P)                                           \
  spade_modulate_nhwc<U, P><<<blocks, kThreads, 0, st>>>(              \
      x, xbias, gb, gbbias, mean, rstd, out, g)
    if (up && pix == kPix) SPADE_MOD_NHWC(true, kPix);
    else if (up) SPADE_MOD_NHWC(true, 1);
    else if (pix == kPix) SPADE_MOD_NHWC(false, kPix);
    else SPADE_MOD_NHWC(false, 1);
#undef SPADE_MOD_NHWC
    return cudaGetLastError();
  }
  const int threads = vec ? g.total / 8 : g.total;
  const int blocks = (threads + kThreads - 1) / kThreads;
#define SPADE_MOD(V, U, N)                                             \
  spade_modulate_kernel<V, U, N><<<blocks, kThreads, 0, st>>>(         \
      x, xbias, gb, gbbias, mean, rstd, out, g)
  if (nhwc) {
    // The scalar path (the 16-byte one is spade_modulate_nhwc).
    if (up) SPADE_MOD(false, true, true);
    else SPADE_MOD(false, false, true);
  } else {
    if (vec && up) SPADE_MOD(true, true, false);
    else if (vec) SPADE_MOD(true, false, false);
    else if (up) SPADE_MOD(false, true, false);
    else SPADE_MOD(false, false, false);
  }
#undef SPADE_MOD
  return cudaGetLastError();
}

// h: [B, C, H, W] bf16, hbias: [C] bf16.  res: [B, C, H, W], or [B, C, H/2,
// W/2] with up; rbias: [C] or null.  out: [B, C, H, W].  All NCHW, or all
// NHWC with nhwc.  Requires B * C * H * W < 2^31 and, with up, H and W
// even.
int spade_residual(const bf16* h, const bf16* hbias, const bf16* res,
                   const bf16* rbias, bf16* out, int B, int C, int H, int W,
                   int up, int nhwc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geom g{C, H, W, 0, 0.f, B * C * H * W};
  const void* ptrs[] = {h, out, hbias, rbias};
  const bool vec = vec_ok(nhwc, C, W, ptrs, nhwc ? 4 : 2, res, up);
  if (g.total == 0) return cudaSuccess;
  if (vec && nhwc) {
    const int pix = (H * W) % kPix == 0 ? kPix : 1;
    const int64_t threads = (int64_t)g.total / 8 / pix;
    const int blocks = (int)((threads + kThreads - 1) / kThreads);
#define SPADE_RES_NHWC(U, P)                                           \
  spade_residual_nhwc<U, P><<<blocks, kThreads, 0, st>>>(              \
      h, hbias, res, rbias, out, g)
    if (up && pix == kPix) SPADE_RES_NHWC(true, kPix);
    else if (up) SPADE_RES_NHWC(true, 1);
    else if (pix == kPix) SPADE_RES_NHWC(false, kPix);
    else SPADE_RES_NHWC(false, 1);
#undef SPADE_RES_NHWC
    return cudaGetLastError();
  }
  const int threads = vec ? g.total / 8 : g.total;
  const int blocks = (threads + kThreads - 1) / kThreads;
#define SPADE_RES(V, U, N)                                             \
  spade_residual_kernel<V, U, N><<<blocks, kThreads, 0, st>>>(         \
      h, hbias, res, rbias, out, g)
  if (nhwc) {
    if (up) SPADE_RES(false, true, true);
    else SPADE_RES(false, false, true);
  } else {
    if (vec && up) SPADE_RES(true, true, false);
    else if (vec) SPADE_RES(true, false, false);
    else if (up) SPADE_RES(false, true, false);
    else SPADE_RES(false, false, false);
  }
#undef SPADE_RES
  return cudaGetLastError();
}

}  // extern "C"

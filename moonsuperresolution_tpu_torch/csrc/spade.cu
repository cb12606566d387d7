// SPADE's normalisation chain on the bf16 serving path, on Hopper (sm_90a):
// the moments' sums, then normalisation, modulation and LeakyReLU in one
// pass.
//
// Replaces no Pallas kernel: the JAX package leaves this chain to XLA's
// fusions (moonsuperresolution_tpu/models/layers.py::SPADE.__call__ and
// spade_moments).  In the port it was a dozen torch passes over full
// activation tensors (float32 copies, squares, subtract, multiply, casts,
// gamma * n, + beta, leaky_relu); ops/spade.py keeps that chain as the
// kernels' plain versions.
//
// What it computes.  x is a contiguous bf16 NCHW tensor [B, C, H, W].
//   spade_sums:     s1 = sum x, s2 = sum x^2 in float32, per channel over
//                   (B, H, W) ("batch" statistics) or per (b, c) over (H, W)
//                   ("instance").
//   spade_modulate: out = leaky_relu(gamma * bf16((x - mean) * r) + beta)
//                   in bf16, with gamma, beta the two channel halves of the
//                   gamma/beta conv's output gb [B, 2C, H, W] (read in
//                   place), mean and r float32 per channel [C] or per
//                   (b, c) [B * C], and x either [B, C, H, W] or, with
//                   "up", the pre-upsample [B, C, H/2, W/2] read at
//                   (h >> 1, w >> 1): F.interpolate(scale_factor=2,
//                   mode="nearest") without writing it.
// Each step rounds as the torch chain does: float32 subtract, then float32
// multiply (no FMA contraction: __fsub_rn, __fmul_rn); round to bf16; the
// product with gamma and the sum with beta each in float32 and rounded to
// bf16; LeakyReLU as v > 0 ? v : v * alpha, rounded to bf16.  Given the same
// mean and r the output equals the plain version's bit for bit.  The sums
// are taken in another order than torch's, so they agree to rounding.
//
// Bound on the card.  Both kernels are bound by the bytes they move: one or
// two float operations per byte, against the ~20 the H100's float32 units
// can do per byte of its 3.35 TB/s.  At the main path's shapes (batch 16,
// the six blocks of plan 1024-1024-1024-512-256-128) the 27 calls of a
// chunk must read each input once and write each output once: ~9.07 GB, a
// bound of ~2.71 ms.
//
// Design.
//   spade_sums_partial: one block per (output, slice of its elements): 16-byte
//   loads (8 bf16) where H*W % 8 == 0, float32 sums in registers, a
//   warp-shuffle tree, then the warps' partials summed in warp order.  Each
//   output's elements are a virtual array of n = B*H*W ("batch") or H*W
//   ("instance") values; a slice is up to kSlice of them, so the grid suits
//   both ends of the plan (C = 1024 at 8 x 8: one slice per channel;
//   C = 128 at 256 x 256 x 16: 128 slices per channel).
//   spade_sums_finish: one thread per output sums its slices' partials in
//   slice order.  No float atomics: the same input gives the same bits.
//   spade_modulate_kernel: one thread per 8 consecutive outputs of a row:
//   16-byte loads of gamma, beta (and x, or 8 bytes of the pre-upsample x,
//   each value used twice) and one 16-byte store.  Ragged widths take a
//   scalar path, one thread per output.
//
// The C entry points launch on the caller's stream, allocate nothing (the
// caller passes the scratch for the partials) and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlice = 8192;          // elements one partial-sum block reads
constexpr int kMaxSlices = 65535;     // gridDim.y

typedef __nv_bfloat16 bf16;

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

__device__ __forceinline__ void add8(uint4 v, float& s1, float& s2) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    s1 += f.x + f.y;
    s2 += f.x * f.x + f.y * f.y;
  }
}

// grid (n_out, n_slices).  Output o's element j (0 <= j < n) lies in plane
// (j / hw) * C + o ("batch") or o ("instance"), at offset j % hw.
template <bool VEC>
__global__ void spade_sums_partial(const bf16* __restrict__ x, int C, int hw,
                                   int n, int batch, int slice,
                                   float2* __restrict__ part) {
  const int o = blockIdx.x;
  const int j0 = blockIdx.y * slice;
  const int j1 = min(j0 + slice, n);
  float s1 = 0.f, s2 = 0.f;
  if (VEC) {
#pragma unroll 4
    for (int j = j0 + 8 * threadIdx.x; j < j1; j += 8 * kThreads) {
      const int q = j / hw;
      const int64_t plane = batch ? (int64_t)q * C + o : o;
      add8(__ldg(reinterpret_cast<const uint4*>(x + plane * hw + (j - q * hw))),
           s1, s2);
    }
  } else {
    for (int j = j0 + threadIdx.x; j < j1; j += kThreads) {
      const int q = j / hw;
      const int64_t plane = batch ? (int64_t)q * C + o : o;
      const float f = __bfloat162float(x[plane * hw + (j - q * hw)]);
      s1 += f;
      s2 += f * f;
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

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The normalised value of one x, rounded to bf16 as the torch chain rounds
// it: (x - mean) * r in float32, then to bf16.
__device__ __forceinline__ float normalize(float xv, float mean, float r) {
  return round_bf16(__fmul_rn(__fsub_rn(xv, mean), r));
}

__device__ __forceinline__ bf16 modulate(float n, float g, float b,
                                         float alpha) {
  const float v = round_bf16(__fadd_rn(round_bf16(__fmul_rn(g, n)), b));
  return __float2bfloat16_rn(v > 0.f ? v : __fmul_rn(v, alpha));
}

struct ModGeom {
  int C, H, W;
  int instance;
  float alpha;
  int total;  // B * C * H * W outputs
};

// VEC: thread t writes outputs [8t, 8t + 8) (W % 8 == 0, 16-byte aligned);
// otherwise thread t writes output t.
template <bool VEC, bool UP>
__global__ void spade_modulate_kernel(const bf16* __restrict__ x,
                                      const bf16* __restrict__ gb,
                                      const float* __restrict__ mean,
                                      const float* __restrict__ rstd,
                                      bf16* __restrict__ out, ModGeom g) {
  const int64_t e64 = ((int64_t)blockIdx.x * kThreads + threadIdx.x) *
                      (VEC ? 8 : 1);
  if (e64 >= g.total) return;
  const int e = (int)e64;
  const int hw = g.H * g.W;
  const int plane = e / hw;           // b * C + c
  const int p = e - plane * hw;
  const int b = plane / g.C;
  const int c = plane - b * g.C;
  const int stat = g.instance ? plane : c;
  const float m = __ldg(mean + stat);
  const float r = __ldg(rstd + stat);
  const int64_t gi = ((int64_t)plane + (int64_t)b * g.C) * hw + p;
  const int64_t bi = gi + (int64_t)g.C * hw;
  int64_t xi = e;
  if (UP) {
    const int h = p / g.W;
    const int w = p - h * g.W;
    xi = (int64_t)plane * (hw / 4) + (h >> 1) * (g.W >> 1) + (w >> 1);
  }
  if (VEC) {
    float n[8];
    if (UP) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(x + xi));
      const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 f = __bfloat1622float2(xv[i]);
        n[4 * i] = n[4 * i + 1] = normalize(f.x, m, r);
        n[4 * i + 2] = n[4 * i + 3] = normalize(f.y, m, r);
      }
    } else {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(x + xi));
      const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(xv[i]);
        n[2 * i] = normalize(f.x, m, r);
        n[2 * i + 1] = normalize(f.y, m, r);
      }
    }
    const uint4 gv = __ldg(reinterpret_cast<const uint4*>(gb + gi));
    const uint4 bv = __ldg(reinterpret_cast<const uint4*>(gb + bi));
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&bv);
    uint4 ov;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&ov);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 gf = __bfloat1622float2(g2[i]);
      const float2 bf = __bfloat1622float2(b2[i]);
      o2[i].x = modulate(n[2 * i], gf.x, bf.x, g.alpha);
      o2[i].y = modulate(n[2 * i + 1], gf.y, bf.y, g.alpha);
    }
    *reinterpret_cast<uint4*>(out + e) = ov;
  } else {
    const float n = normalize(__bfloat162float(x[xi]), m, r);
    out[e] = modulate(n, __bfloat162float(gb[gi]), __bfloat162float(gb[bi]),
                      g.alpha);
  }
}

void sums_grid(int B, int hw, int instance, int* n, int* slice,
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

}  // namespace

extern "C" {

// Floats of scratch that spade_sums needs.
int64_t spade_sums_scratch(int B, int C, int hw, int instance) {
  int n, slice, n_slices;
  sums_grid(B, hw, instance, &n, &slice, &n_slices);
  const int64_t n_out = instance ? (int64_t)B * C : C;
  return 2 * n_out * n_slices;
}

// x: [B, C, hw] bf16.  s1, s2: [C] ("batch") or [B * C] ("instance")
// float32.  scratch: spade_sums_scratch() floats.  Requires B * C * hw <
// 2^31.
int spade_sums(const bf16* x, int B, int C, int hw, int instance,
               float* scratch, float* s1, float* s2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int n, slice, n_slices;
  sums_grid(B, hw, instance, &n, &slice, &n_slices);
  const int n_out = instance ? B * C : C;
  float2* part = reinterpret_cast<float2*>(scratch);
  const dim3 grid(n_out, n_slices);
  if (hw % 8 == 0 && aligned(x, 16)) {
    spade_sums_partial<true><<<grid, kThreads, 0, st>>>(x, C, hw, n,
                                                        !instance, slice, part);
  } else {
    spade_sums_partial<false><<<grid, kThreads, 0, st>>>(
        x, C, hw, n, !instance, slice, part);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  spade_sums_finish<<<(n_out + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      part, n_out, n_slices, s1, s2);
  return cudaGetLastError();
}

// x: [B, C, H, W] bf16, or [B, C, H/2, W/2] with up.  gb: [B, 2C, H, W]
// bf16.  mean, rstd: [C] or (instance) [B * C] float32.  out: [B, C, H, W]
// bf16.  Requires B * 2C * H * W < 2^31 and, with up, H and W even.
int spade_modulate(const bf16* x, const bf16* gb, const float* mean,
                   const float* rstd, bf16* out, int B, int C, int H, int W,
                   int up, int instance, float alpha, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ModGeom g{C, H, W, instance, alpha, B * C * H * W};
  const bool vec = W % 8 == 0 && aligned(gb, 16) && aligned(out, 16) &&
                   aligned(x, up ? 8 : 16);
  const int threads = vec ? g.total / 8 : g.total;
  const int blocks = (threads + kThreads - 1) / kThreads;
  if (blocks == 0) return cudaSuccess;
  if (vec && up) {
    spade_modulate_kernel<true, true><<<blocks, kThreads, 0, st>>>(
        x, gb, mean, rstd, out, g);
  } else if (vec) {
    spade_modulate_kernel<true, false><<<blocks, kThreads, 0, st>>>(
        x, gb, mean, rstd, out, g);
  } else if (up) {
    spade_modulate_kernel<false, true><<<blocks, kThreads, 0, st>>>(
        x, gb, mean, rstd, out, g);
  } else {
    spade_modulate_kernel<false, false><<<blocks, kThreads, 0, st>>>(
        x, gb, mean, rstd, out, g);
  }
  return cudaGetLastError();
}

}  // extern "C"

// Fused patch preparation for the tile program: grid extraction, per-patch
// min/max, validity and min-max normalisation, on Hopper (sm_90a).
//
// Replaces moonsuperresolution_tpu/ops/pallas/patches.py::
// extract_normalize_patches (the only Pallas kernel of the JAX package).
//
// What it computes.  Two L x L float32 slabs (ortho, DEM) are cut into a
// Gy x Gx grid of P x P patches at stride s.  For patch n and channel c:
//   mn, mx = min, max of the patch channel
//   out[n, c] = (x - mn) / max(mx - mn, 1e-12) - 0.5          (IEEE divide)
//   valid[n]  = (min ortho > no_value && min DEM > no_value) ? 1 : 0
//   dmin[n], dmax[n] = min, max of the DEM channel
// out is written channel-first, [N, 2, P, P], as the Pallas kernel writes
// it; the generator consumes NCHW directly.
//
// Bound on the card.  At the main-path shape (L = 1920, G = 23, N = 529,
// P = 512, s = 64) it must write N * 2 * P^2 * 4 B = 1.11 GB and read
// 2 * L^2 * 4 B = 29.5 MB: about 0.34 ms at 3.35 TB/s.  The arithmetic is
// three float operations per output element, far below the f32 peak, so the
// kernel is bound by the bytes it writes.
//
// Design.  The Pallas kernel keeps a whole 512-row patch window in VMEM;
// one 512^2 f32 patch channel is 1 MB here, against 227 KB of shared memory
// a block can use, so the per-patch reductions are decomposed instead:
//   1. patches_block_minmax: min and max of every b x b block of each
//      slab, with b = gcd(s, P), so every patch is an exact union of (P/b)^2 blocks
//      (8 x 8 at the main-path shape; 2 x 30 x 30 blocks, one read of the
//      slabs).  Min and max do not depend on order, so the patch statistics
//      are bit-identical to a direct reduction.
//   2. patches_normalize: one thread block per (patch, channel, band of
//      rows).  It combines its patch's block statistics (both channels: 2 * 64 values at
//      the main-path shape), then streams its rows from the slabs (L2
//      resident: 29.5 MB against a 50 MB L2) to the output with 16-byte
//      loads and stores where the geometry is 16-byte aligned.  Every output
//      byte is written once.
// Min and max propagate NaN, as torch.amin/amax and jnp.min/max do.
//
// The C entry point launches both kernels on the caller's stream, allocates
// nothing (the caller passes the scratch for the block statistics) and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 16;

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// Block-wide reduction of (mn, mx) pairs; every thread gets the result.
template <int NV>
__device__ void block_reduce(float (&mn)[NV], float (&mx)[NV]) {
  __shared__ float smn[NV][kThreads / 32];
  __shared__ float smx[NV][kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mn[v] = nan_min(mn[v], __shfl_xor_sync(0xffffffffu, mn[v], o));
      mx[v] = nan_max(mx[v], __shfl_xor_sync(0xffffffffu, mx[v], o));
    }
    if (lane == 0) {
      smn[v][warp] = mn[v];
      smx[v][warp] = mx[v];
    }
  }
  __syncthreads();
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    mn[v] = smn[v][0];
    mx[v] = smx[v][0];
    for (int w = 1; w < kThreads / 32; ++w) {
      mn[v] = nan_min(mn[v], smn[v][w]);
      mx[v] = nan_max(mx[v], smx[v][w]);
    }
  }
  __syncthreads();
}

// grid (nb, nb, 2): min/max of the b x b block (bx, by) of slab z.
// blk layout: [2 (min, max)][2 (channel)][nb][nb].
__global__ void patches_block_minmax(const float* __restrict__ img,
                                     const float* __restrict__ dem, int L,
                                     int b, int nb, float* __restrict__ blk) {
  const float* src = blockIdx.z == 0 ? img : dem;
  const int r0 = blockIdx.y * b;
  const int c0 = blockIdx.x * b;
  float mn[1] = {INFINITY};
  float mx[1] = {-INFINITY};
  for (int i = threadIdx.x; i < b * b; i += kThreads) {
    const float v = src[(int64_t)(r0 + i / b) * L + c0 + i % b];
    mn[0] = nan_min(mn[0], v);
    mx[0] = nan_max(mx[0], v);
  }
  block_reduce<1>(mn, mx);
  if (threadIdx.x == 0) {
    const int64_t plane = (int64_t)nb * nb;
    const int64_t at = (int64_t)blockIdx.y * nb + blockIdx.x;
    blk[blockIdx.z * plane + at] = mn[0];
    blk[(2 + blockIdx.z) * plane + at] = mx[0];
  }
}

// grid (N * 2, ceil(P / kRowsPerBlock)): rows [y*R, y*R+R) of patch n,
// channel c, with n = blockIdx.x / 2 and c = blockIdx.x % 2.
template <bool VEC>
__global__ void patches_normalize(const float* __restrict__ img,
                                  const float* __restrict__ dem, int L,
                                  int gx, int stride, int P, float no_value,
                                  int b, int nb,
                                  const float* __restrict__ blk,
                                  float* __restrict__ out,
                                  float* __restrict__ valid,
                                  float* __restrict__ dmin,
                                  float* __restrict__ dmax) {
  const int n = blockIdx.x >> 1;
  const int c = blockIdx.x & 1;
  const int row0 = (n / gx) * stride;
  const int col0 = (n % gx) * stride;

  // Patch statistics of both channels from its (P/b)^2 blocks.
  const int np = P / b;
  const int64_t plane = (int64_t)nb * nb;
  const int by0 = row0 / b;
  const int bx0 = col0 / b;
  float mn[2] = {INFINITY, INFINITY};
  float mx[2] = {-INFINITY, -INFINITY};
  for (int i = threadIdx.x; i < np * np; i += kThreads) {
    const int64_t at = (int64_t)(by0 + i / np) * nb + bx0 + i % np;
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
      mn[ch] = nan_min(mn[ch], blk[ch * plane + at]);
      mx[ch] = nan_max(mx[ch], blk[(2 + ch) * plane + at]);
    }
  }
  block_reduce<2>(mn, mx);

  if (c == 1 && blockIdx.y == 0 && threadIdx.x == 0) {
    valid[n] = (mn[0] > no_value && mn[1] > no_value) ? 1.0f : 0.0f;
    dmin[n] = mn[1];
    dmax[n] = mx[1];
  }

  const float lo = mn[c];
  const float range = fmaxf(mx[c] - lo, 1e-12f);
  const float* src = (c == 0 ? img : dem) + (int64_t)row0 * L + col0;
  float* dst = out + ((int64_t)n * 2 + c) * P * P;
  const int r_begin = blockIdx.y * kRowsPerBlock;
  const int rows = min(kRowsPerBlock, P - r_begin);

  if (VEC) {
    const int w4 = P / 4;
    for (int i = threadIdx.x; i < rows * w4; i += kThreads) {
      const int r = r_begin + i / w4;
      const int q = i % w4;
      const float4 v =
          *reinterpret_cast<const float4*>(src + (int64_t)r * L + 4 * q);
      float4 o;
      o.x = (v.x - lo) / range - 0.5f;
      o.y = (v.y - lo) / range - 0.5f;
      o.z = (v.z - lo) / range - 0.5f;
      o.w = (v.w - lo) / range - 0.5f;
      *reinterpret_cast<float4*>(dst + (int64_t)r * P + 4 * q) = o;
    }
  } else {
    for (int i = threadIdx.x; i < rows * P; i += kThreads) {
      const int r = r_begin + i / P;
      const int q = i % P;
      dst[(int64_t)r * P + q] = (src[(int64_t)r * L + q] - lo) / range - 0.5f;
    }
  }
}

int gcd(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

}  // namespace

extern "C" {

// Number of floats of scratch that extract_normalize_patches needs.
int64_t extract_normalize_patches_scratch(int gy, int gx, int stride, int P) {
  const int b = gcd(stride, P);
  const int span = (gy > gx ? gy - 1 : gx - 1) * stride + P;
  const int64_t nb = (span + b - 1) / b;
  return 4 * nb * nb;
}

// img, dem: [L, L] float32.  out: [gy * gx, 2, P, P] float32.  valid, dmin,
// dmax: [gy * gx] float32.  scratch: extract_normalize_patches_scratch()
// floats.  Requires (max(gy, gx) - 1) * stride + P <= L.
int extract_normalize_patches(const float* img, const float* dem, int L,
                              int gy, int gx, int stride, int P,
                              float no_value, float* scratch, float* out,
                              float* valid, float* dmin, float* dmax,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int b = gcd(stride, P);
  const int span = (gy > gx ? gy - 1 : gx - 1) * stride + P;
  const int nb = (span + b - 1) / b;
  patches_block_minmax<<<dim3(nb, nb, 2), kThreads, 0, st>>>(img, dem, L, b,
                                                              nb, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(gy * gx * 2, (P + kRowsPerBlock - 1) / kRowsPerBlock);
  const bool vec = (L % 4 == 0) && (stride % 4 == 0) && (P % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(img) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(dem) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (vec) {
    patches_normalize<true><<<grid, kThreads, 0, st>>>(
        img, dem, L, gx, stride, P, no_value, b, nb, scratch, out, valid, dmin,
        dmax);
  } else {
    patches_normalize<false><<<grid, kThreads, 0, st>>>(
        img, dem, L, gx, stride, P, no_value, b, nb, scratch, out, valid, dmin,
        dmax);
  }
  return cudaGetLastError();
}

}  // extern "C"

// int8 3x3 convolution of the quantized SPADE generator, on Hopper (sm_90a):
// an implicit GEMM on the s8 tensor cores with the dequantize / requantize
// epilogue fused.
//
// Replaces moonsuperresolution_tpu/models/quant.py::_qconv (:55-109), whose
// conv is XLA's s8 x s8 conv_general_dilated with an s32 or bf16
// preferred_element_type; no Pallas kernel stands behind it on the TPU.
//
// What it computes.  x: s8 NHWC [B, H, W, C]; w: s8 [N, 3, 3, C].  A 3x3,
// stride-1 SAME convolution with exact int32 accumulation (the zero padding
// is code 0, which is exactly 0.0), then per output channel n:
//   scale[n] = s_x * w_scale[n]               (s_x: a 0-d device tensor)
//   a        = float(acc)                      (round to nearest)
//   a        = float(bf16(a))                  (acc_bf16 only: the TPU rounds
//                                               its wide sum once on the way
//                                               to HBM)
//   y        = a * scale[n] + bias[n]          (two roundings, no FMA)
//   out      = y as f32 or bf16, or, with inv, s8 clip(rint(y * inv[n]),
//              -127, 127)
// out is NHWC [B, H, W, N].  Every operation is an IEEE round-to-nearest
// intrinsic (__fmul_rn, __fadd_rn, rintf) and the build has no
// --use_fast_math, so the result equals the plain PyTorch version
// (ops/qconv.py::qconv_plain) bit for bit.
//
// As a GEMM: M = B*H*W rows (output pixels), N = Cout columns, K = 9*C, with
// k = (r*3 + s)*C + c.  A[m, k] is x at the pixel shifted by tap (r, s), or 0
// outside the image; B[n, k] is row n of w as stored.  Both are K-contiguous,
// as mma.sync's row.col operands want.
//
// Bound on the card.  On the main path (image 512, batch 16, full width) the
// 30 launches of one generator call do 11.06 TOP against 1,979 TOP/s of
// dense int8, 5.6 ms; the bytes (s8 in, weights, bf16 or s8 out) take
// under a tenth of that at 3.35 TB/s.  Almost every launch is bound by
// operations.
//
// Design, simple first.  Each block of 256 threads (8 warps, 2 x 4) owns a
// 128 x 128 output tile and walks K in steps of 64 bytes:
//   - A tile gathered from NHWC: a 16-byte run of channels of one tap is
//     contiguous (C % 16 == 0), so each thread issues two 16-byte cp.async
//     for A and two for B per step; halo pixels, rows past M, columns past N
//     and a ragged K tail (K % 64 != 0) are zero-filled by cp.async's
//     src-size 0;
//   - a 3-stage cp.async ring in dynamic shared memory (61,440 bytes), rows
//     padded to 80 bytes so that ldmatrix reads are free of bank conflicts;
//   - ldmatrix.x4 feeds mma.sync.m16n8k32.row.col.s32.s8.s8.s32; each warp
//     holds a 64 x 32 accumulator tile (64 int32 registers a thread);
//   - the epilogue runs from registers and writes two adjacent channels per
//     store.
// wgmma, TMA, warp specialisation, a persistent grid and a fused activation
// quantize are later work.
//
// The C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;                 // bytes = s8 elements of K per step
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kRow = kBK + 16;          // padded shared-memory row, bytes
constexpr int kTileA = kBM * kRow;
constexpr int kTileB = kBN * kRow;
constexpr int kStage = kTileA + kTileB;
constexpr int kSmem = kStages * kStage;  // 61,440 bytes

enum OutKind { kOutF32 = 0, kOutBF16 = 1, kOutS8 = 2 };

struct Args {
  const int8_t* x;        // [B, H, W, C]
  const int8_t* w;        // [N, 3, 3, C]
  const float* s_x;       // 0-d
  const float* w_scale;   // [N]
  const float* bias;      // [N]
  const float* inv;       // [N], kOutS8 only
  void* out;              // [B, H, W, N]
  int B, H, W, C, N;
  int acc_bf16;
  int out_kind;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;  // src-size 0: write 16 zero bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float dequant(int acc, float scale, float bias,
                                         bool acc_bf16) {
  float a = __int2float_rn(acc);
  if (acc_bf16) a = __bfloat162float(__float2bfloat16_rn(a));
  return __fadd_rn(__fmul_rn(a, scale), bias);
}

__device__ __forceinline__ int8_t requant(float y, float inv) {
  const float q = fminf(fmaxf(rintf(__fmul_rn(y, inv)), -127.0f), 127.0f);
  return static_cast<int8_t>(q);
}

__global__ void __launch_bounds__(kThreads)
    qconv3x3_s8_kernel(const Args p) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int HW = p.H * p.W;
  const int M = p.B * HW;
  const int K = 9 * p.C;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;  // 2 warps along M, 64 rows each
  const int wn = warp & 3;   // 4 warps along N, 32 columns each

  // Loader: chunk i = tid + 256 j (j = 0, 1) of a stage's 512 16-byte
  // chunks per operand is row i / 4, bytes 16 * (i % 4) of the K step.
  const int chunk = (tid & 3) * 16;
  int a_row[2], a_b[2], a_h[2], a_w[2];
  bool a_ok[2], b_ok[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = (tid + j * kThreads) >> 2;
    const int m = m0 + row;
    a_row[j] = row;
    a_ok[j] = m < M;
    const int mm = a_ok[j] ? m : 0;
    a_b[j] = mm / HW;
    const int rem = mm - a_b[j] * HW;
    a_h[j] = rem / p.W;
    a_w[j] = rem - a_h[j] * p.W;
    b_ok[j] = n0 + row < p.N;
  }
  const uint32_t smem0 = smem_addr(smem);

  auto load_stage = [&](int stage, int k0) {
    const int k = k0 + chunk;
    const bool k_ok = k < K;
    const int tap = k_ok ? k / p.C : 0;
    const int c = k - tap * p.C;
    const int r = tap / 3;
    const int s = tap - 3 * r;
    const uint32_t sa = smem0 + stage * kStage;
    const uint32_t sb = sa + kTileA;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int hh = a_h[j] + r - 1;
      const int ww = a_w[j] + s - 1;
      const bool ok = a_ok[j] && k_ok && hh >= 0 && hh < p.H && ww >= 0 &&
                      ww < p.W;
      const int8_t* src =
          ok ? p.x + ((int64_t)(a_b[j] * p.H + hh) * p.W + ww) * p.C + c
             : p.x;
      cp_async16(sa + a_row[j] * kRow + chunk, src, ok);
      const bool okb = b_ok[j] && k_ok;
      const int8_t* srcb =
          okb ? p.w + (int64_t)(n0 + a_row[j]) * K + k : p.w;
      cp_async16(sb + a_row[j] * kRow + chunk, srcb, okb);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0;

  const int KT = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_stage(s, s * kBK);
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();  // step kt has landed
    __syncthreads();               // ... for every thread; and step kt - 1's
                                   // stage is free to overwrite
    const int nk = kt + kStages - 1;
    if (nk < KT) load_stage(nk % kStages, nk * kBK);
    cp_async_commit();

    const uint32_t sa = smem0 + (kt % kStages) * kStage;
    const uint32_t sb = sa + kTileA;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[4][4];
      uint32_t bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        // Matrices (rows 0-7 | 8-15) x (bytes 0-15 | 16-31) of the 16 x 32
        // A tile: a0..a3 of the m16n8k32 fragment.
        const int row = wm * 64 + mi * 16 + (lane & 15);
        const int col = kk + (lane >> 4) * 16;
        ldmatrix_x4(af[mi], sa + row * kRow + col);
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        // Two n8 tiles: (n 0-7, bytes 0-15), (n 0-7, 16-31), (n 8-15,
        // 0-15), (n 8-15, 16-31) -> b0, b1 of each.
        const int row = wn * 32 + nj * 16 + ((lane >> 4) << 3) + (lane & 7);
        const int col = kk + ((lane >> 3) & 1) * 16;
        uint32_t t[4];
        ldmatrix_x4(t, sb + row * kRow + col);
        bf[2 * nj][0] = t[0];
        bf[2 * nj][1] = t[1];
        bf[2 * nj + 1][0] = t[2];
        bf[2 * nj + 1][1] = t[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_s8(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
  }
  cp_async_wait<0>();

  // Epilogue.  Accumulator v of tile (mi, ni) is row g + 8 * (v / 2), column
  // 2 t + v % 2 of the 16 x 8 tile, with g = lane / 4 and t = lane % 4.
  const float sx = *p.s_x;
  const bool acc_bf16 = p.acc_bf16 != 0;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int n = n0 + wn * 32 + ni * 8 + 2 * t;
    if (n >= p.N) continue;  // N % 8 == 0: n + 1 < N as well
    const float sc0 = __fmul_rn(sx, p.w_scale[n]);
    const float sc1 = __fmul_rn(sx, p.w_scale[n + 1]);
    const float b0 = p.bias[n];
    const float b1 = p.bias[n + 1];
    const float i0 = p.out_kind == kOutS8 ? p.inv[n] : 0.0f;
    const float i1 = p.out_kind == kOutS8 ? p.inv[n + 1] : 0.0f;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm * 64 + mi * 16 + g + 8 * half;
        if (m >= M) continue;
        const float y0 = dequant(acc[mi][ni][2 * half], sc0, b0, acc_bf16);
        const float y1 = dequant(acc[mi][ni][2 * half + 1], sc1, b1, acc_bf16);
        const int64_t at = (int64_t)m * p.N + n;
        if (p.out_kind == kOutF32) {
          *reinterpret_cast<float2*>(static_cast<float*>(p.out) + at) =
              make_float2(y0, y1);
        } else if (p.out_kind == kOutBF16) {
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(p.out) + at) =
              __floats2bfloat162_rn(y0, y1);
        } else {
          char2 q;
          q.x = requant(y0, i0);
          q.y = requant(y1, i1);
          *reinterpret_cast<char2*>(static_cast<int8_t*>(p.out) + at) = q;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// x: s8 [B, H, W, C]; w: s8 [N, 3, 3, C]; s_x: float32 0-d; w_scale, bias:
// float32 [N]; inv: float32 [N] for out_kind 2 (s8), else unused; out:
// [B, H, W, N] of float32 (out_kind 0), bf16 (1) or s8 (2).  Requires
// C % 16 == 0, N % 8 == 0, x and w 16-byte aligned, B*H*W < 2^31.
int qconv3x3_s8(const void* x, const void* w, const float* s_x,
                const float* w_scale, const float* bias, const float* inv,
                void* out, int B, int H, int W, int C, int N, int acc_bf16,
                int out_kind, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      qconv3x3_s8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  Args p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.s_x = s_x;
  p.w_scale = w_scale;
  p.bias = bias;
  p.inv = inv;
  p.out = out;
  p.B = B;
  p.H = H;
  p.W = W;
  p.C = C;
  p.N = N;
  p.acc_bf16 = acc_bf16;
  p.out_kind = out_kind;
  const int64_t M = (int64_t)B * H * W;
  const dim3 grid((unsigned)((M + kBM - 1) / kBM), (N + kBN - 1) / kBN);
  qconv3x3_s8_kernel<<<grid, kThreads, kSmem,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

}  // extern "C"

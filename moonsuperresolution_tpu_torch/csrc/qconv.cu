// int8 3x3 convolution of the quantized SPADE generator, on Hopper (sm_90a):
// an implicit GEMM on the s8 tensor cores (wgmma), its operands gathered by
// the Tensor Memory Accelerator, with the dequantize / requantize epilogue
// fused.
//
// Replaces moonsuperresolution_tpu/models/quant.py::_qconv (:94-99), whose
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
// out is NHWC [B, H, W, N].  Every rounding is IEEE round-to-nearest-even,
// in this order (__int2float_rn, the bf16 rounding, __fmul_rn, __fadd_rn,
// __fmul_rn, rint, clip); the build has no --use_fast_math and nothing is
// contracted to an FMA, so the result equals the plain PyTorch version
// (ops/qconv.py::qconv_plain) bit for bit.  Two roundings are written as
// exact identities that keep the SM's conversion pipe free (see dequant and
// requant below); tests/test_torch_kernels.py checks both identities on the
// CPU.
//
// As a GEMM: M = B*H*W rows (output pixels), N = Cout columns, K = 9*C,
// walked as 9 taps (r, s) times ceil(C / 128) slices of 128 channels.  Both
// operands are K-major, which is the only order 8-bit wgmma takes.
//
// Bound on the card.  On the main path (image 512, batch 16, full width) the
// 30 launches of one generator call do 11.06 TOP against 1,979 TOP/s of
// dense int8: 5.59 ms.  The bytes (s8 in, weights, bf16 or s8 out) take
// under a tenth of that at 3.35 TB/s, so every large launch is bound by
// operations.
//
// Design.  A persistent grid of one 384-thread block per SM (fewer when there
// are fewer tiles) walks output tiles of 128 pixels x 128 channels.  What it
// does about the limits of the first design (Ampere's warp-level MMA fed by
// per-thread cp.async, PERF.md):
//   1. Instruction: wgmma.mma_async m64n128k32 .s32.s8.s8, both operands read
//      from shared memory through 128-byte-swizzled descriptors.  A consumer
//      warpgroup owns a whole tile (two m64 halves, 128 s32 registers a
//      thread) and keeps one wgmma group in flight (wgmma.wait_group 1).
//   2. Addresses: the Tensor Memory Accelerator gathers.  A tile's M rows are
//      a box of pixels (bB, bH, bW) with bB bH bW = 128, e.g. 1x1x128 for
//      W >= 128, 1x2x64, ..., 2x8x8 for the 8 x 8 maps of block 0
//      (ops/qconv.py::pixel_box).  A, for tap (r, s) and channels
//      c0..c0+127, is the tiled box of a 4-D tensor map over x at (c0,
//      w0 + s - 1, h0 + r - 1, b0); B is the box (c0, tap, n0) of a 3-D map
//      over w viewed as [N, 9, C].  Tiled mode fills coordinates outside the
//      tensor with zeros, which is exactly the SAME padding, the channels
//      past a narrow C (the K tail) and the columns past N.  Pixels of a box
//      that lie outside the image (a ragged edge) are computed on whatever
//      the box holds and masked in the epilogue.  Tiled mode, not im2col
//      mode: one box per tap keeps the 128-byte swizzle that wgmma wants and
//      needs no halo arithmetic.
//   3. Producer / consumer split: one producer thread (its warpgroup gives
//      its registers to the consumers with setmaxnreg) keeps TMA loads in
//      flight through a ring of six 32 KB stages, each with a full mbarrier
//      (TMA transaction bytes) and an empty one (the consuming warpgroup).
//      No __syncthreads in the main loop.
//   4. Persistent grid, ping-pong: block i takes tiles i, i + grid, ...,
//      alternately to its two consumer warpgroups, whose main loops take
//      turns (named barriers 3 and 4), so that one warpgroup's epilogue runs
//      under the other's products, and the producer runs ahead across tile
//      boundaries.  This is what the short-K (K = 1152) gamma/beta convs
//      need: with both warpgroups on one 128 x 256 tile, the tensor cores
//      idled through every epilogue (PERF.md).  N tiles vary fastest,
//      so the blocks in flight share a few M tiles, and the whole weight
//      tensor (at most 9.4 MB on the main path) stays in L2.
//   5. Epilogue: the tile's per-channel scale, bias and inverse scale and its
//      pixel offsets are staged in shared memory once per tile; each warp
//      dequantizes 16 rows at a time in registers, stages them in the
//      output type, 128 bytes a row, in a swizzled buffer, and writes each
//      row's line with 16-byte stores of eight lanes (8-byte stores for an
//      s8 output whose row of N bytes is not a multiple of 16).  Only
//      int -> float stays on the conversion pipe (16 results a clock an
//      SM), which bound the first epilogue.
//   6. Small launches (block 0, M = 1,024: 64-128 tiles) keep one tile per
//      block and leave SMs idle; their bound is 2 % of the chunk's, so there
//      is no split-K.
//
// The C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError(), or an error of its own (see below) when the
// tile plan or a tensor map is refused.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the
                   // runtime's driver entry point, so no -lcuda is needed
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;          // output pixels per tile
constexpr int kBN = 128;          // output channels per tile
constexpr int kBK = 128;          // channels (bytes) of one tap per K step
constexpr int kWG = 128;          // threads of a warpgroup
constexpr int kThreads = 3 * kWG; // two consumer warpgroups, one producer
constexpr int kPitch = 128;       // bytes per staged epilogue row
constexpr int kStageWarp = 16 * kPitch;

// Shared memory: the TMA ring, each consumer warp's staging buffer, each
// consumer warpgroup's per-channel vectors and pixel offsets, the barriers.
constexpr int kA = kBM * kBK;                          // 16 KB
constexpr int kStage = kA + kBN * kBK;                 // 32 KB
constexpr int kStages = 6;                             // 192 KB
constexpr int kOffStaging = kStages * kStage;          // 8 warps x 2 KB
constexpr int kOffVec = kOffStaging + 8 * kStageWarp;  // 2 x 3 x 128 floats
constexpr int kOffPix = kOffVec + 2 * 3 * kBN * 4;     // 2 x 128 ints
constexpr int kOffBar = kOffPix + 2 * kBM * 4;         // full, empty
constexpr int kSmem = kOffBar + 2 * 8 * kStages + 1024;  // + alignment

enum OutKind { kOutF32 = 0, kOutBF16 = 1, kOutS8 = 2 };

struct Args {
  const float* s_x;       // 0-d
  const float* w_scale;   // [N]
  const float* bias;      // [N]
  const float* inv;       // [N], kOutS8 only
  void* out;              // [B, H, W, N]
  int B, H, W, C, N;
  int acc_bf16;
  int box_b, box_h, box_w;     // the pixel box of one M tile
  int grid_h, grid_w;          // boxes along H and W
  int n_tiles, tiles;          // N tiles, all tiles
};

struct Tile {
  int b0, h0, w0, n0;
};

__device__ __forceinline__ Tile tile_at(const Args& p, int t) {
  const int m = t / p.n_tiles;  // N tiles vary fastest
  Tile tl;
  tl.n0 = (t - m * p.n_tiles) * kBN;
  tl.w0 = (m % p.grid_w) * p.box_w;
  tl.h0 = (m / p.grid_w % p.grid_h) * p.box_h;
  tl.b0 = m / (p.grid_w * p.grid_h) * p.box_b;
  return tl;
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// --------------------------------------------------------------------- TMA

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::
          "r"(dst),
      "l"(map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          dst),
      "l"(map), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ------------------------------------------------------------------- wgmma

// Shared-memory matrix descriptor of a K-major tile in the 128-byte swizzle
// that TMA wrote: rows of 128 bytes, 8-row groups 1,024 bytes apart (SBO);
// LBO is unused by a swizzled K-major operand.  The tile starts 1,024-byte
// aligned; a K step of 32 bytes inside the row adds 32 to the start address.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define QC_R4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define QC_R16(i) QC_R4(i), QC_R4(i + 4), QC_R4(i + 8), QC_R4(i + 12)
#define QC_R64(i) QC_R16(i), QC_R16(i + 16), QC_R16(i + 32), QC_R16(i + 48)

// d += A[64 x 32] B[128 x 32]^T for one warpgroup; scale_d 0 overwrites d.
__device__ __forceinline__ void mma_m64n128k32(int (&d)[64], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
    : QC_R64(0)
    : "l"(da), "l"(db), "r"(scale_d));
}

#undef QC_R64
#undef QC_R16
#undef QC_R4

// Keeps the compiler from reading the accumulators before wgmma.wait_group.
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The 128 threads of consumer warpgroup wg only (named barrier 1 + wg).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  if (wg == 0)
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

// The order of the two consumer warpgroups' main loops: warpgroup wg waits
// (named barrier 3 + wg) until the other has finished the products of the
// tile before, which signals by arriving there.  Besides keeping one
// warpgroup's epilogue under the other's products, this is what makes the
// ring's parity waits sound: a warpgroup skips the other's K steps, and a
// parity wait cannot tell a stage's phase from the one two phases later.
__device__ __forceinline__ void order_wait(int wg) {
  if (wg == 0)
    asm volatile("bar.sync 3, 256;\n" ::: "memory");
  else
    asm volatile("bar.sync 4, 256;\n" ::: "memory");
}

__device__ __forceinline__ void order_signal(int wg) {
  if (wg == 0)
    asm volatile("bar.arrive 4, 256;\n" ::: "memory");
  else
    asm volatile("bar.arrive 3, 256;\n" ::: "memory");
}

// ---------------------------------------------------------------- epilogue
//
// The SM's conversion pipe gives 16 results a clock: int -> float,
// float -> bf16, rint and float -> int would each take a slot per value.
// Only the first stays there; the others are exact identities on the
// integer and float pipes.

// float(bf16(a)), round to nearest even, for finite a: the same bits as
// __bfloat162float(__float2bfloat16_rn(a)), on the integer pipe.
__device__ __forceinline__ float round_bf16(float a) {
  const uint32_t u = __float_as_uint(a);
  return __uint_as_float((u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u);
}

__device__ __forceinline__ float dequant(int acc, float scale, float bias,
                                         bool acc_bf16) {
  float a = __int2float_rn(acc);
  if (acc_bf16) a = round_bf16(a);
  return __fadd_rn(__fmul_rn(a, scale), bias);
}

// clip(rint(y * inv), -127, 127) as s8: the clip comes first (rint is
// monotonic and +-127 are integers, so the order does not matter), then
// adding 1.5 * 2^23, whose ulp is 1, rounds to nearest even; the low byte of
// the sum's bits is the result's two's complement byte.
__device__ __forceinline__ uint32_t requant(float y, float inv) {
  const float v = fminf(fmaxf(__fmul_rn(y, inv), -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(v, 12582912.0f));
}

// Two adjacent output channels y0, y1 (inverse scales i0, i1), converted to
// the output type and written to shared memory at o.
template <int KIND>
struct Out;

template <>
struct Out<kOutF32> {
  static constexpr int kBytes = 4;
  __device__ __forceinline__ static void put(uint8_t* o, float y0, float y1,
                                             float, float) {
    *reinterpret_cast<float2*>(o) = make_float2(y0, y1);
  }
};

template <>
struct Out<kOutBF16> {
  static constexpr int kBytes = 2;
  __device__ __forceinline__ static void put(uint8_t* o, float y0, float y1,
                                             float, float) {
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(y0, y1);
  }
};

template <>
struct Out<kOutS8> {
  static constexpr int kBytes = 1;
  __device__ __forceinline__ static void put(uint8_t* o, float y0, float y1,
                                             float i0, float i1) {
    *reinterpret_cast<uint16_t*>(o) = static_cast<uint16_t>(
        __byte_perm(requant(y0, i0), requant(y1, i1), 0x40));
  }
};

// Byte offset of (row, byte) in a warp's staging buffer: 16-byte units
// XOR-swizzled by row, so that the fragment writes and the row reads spread
// over the banks.
__device__ __forceinline__ int staged(int row, int byte) {
  return row * kPitch + ((((byte >> 4) ^ (row & 7)) << 4) | (byte & 15));
}

// Ring position pos (the pos-th K step the producer loads) lives in stage
// pos % kStages, and its barriers' phase parity is (pos / kStages) & 1.
struct Ring {
  int stage;
  uint32_t phase;
  __device__ __forceinline__ void advance(int steps) {
    stage += steps;
    phase ^= (stage / kStages) & 1;
    stage %= kStages;
  }
};

template <int KIND>
__global__ void __launch_bounds__(kThreads, 1)
    qconv3x3_s8_kernel(const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_w,
                       const Args p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzle's alignment
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t full0 = base + kOffBar;        // full[s]: full0 + 8 s
  const uint32_t empty0 = full0 + 8 * kStages;
  const int tid = threadIdx.x;
  const int k_slices = (p.C + kBK - 1) / kBK;
  const int k_steps = 9 * k_slices;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kWG);  // the warpgroup that owns the tile
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 2 * kWG) {
    // ---- producer warpgroup: one thread loads every K step of every tile
    // of this block, in order, into the ring.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 2 * kWG) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tm_x) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tm_w) : "memory");
      Ring ring = {0, 0};
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        const Tile tl = tile_at(p, t);
        for (int tap = 0; tap < 9; ++tap) {
          const int r = tap / 3;
          const int s = tap - 3 * r;
          for (int kc = 0; kc < k_slices; ++kc) {
            mbar_wait(empty0 + 8 * ring.stage, ring.phase ^ 1);
            const uint32_t full = full0 + 8 * ring.stage;
            const uint32_t sa = base + ring.stage * kStage;
            mbar_expect_tx(full, kStage);
            tma_load_4d(sa, &tm_x, full, kc * kBK, tl.w0 + s - 1,
                        tl.h0 + r - 1, tl.b0);
            tma_load_3d(sa + kA, &tm_w, full, kc * kBK, tap, tl.n0);
            ring.advance(1);
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroup wg: this block's tiles 2 j + wg, all 128 x 128
    // of each.  The two warpgroups share the ring and nothing else: while
    // one runs its epilogue, the other's products keep the tensor cores.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = tid / kWG;
    const int wtid = tid % kWG;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int tq = lane & 3;
    float* vsc = reinterpret_cast<float*>(smem + kOffVec) + wg * 3 * kBN;
    float* vbi = vsc + kBN;
    float* viv = vbi + kBN;
    int* vpix = reinterpret_cast<int*>(smem + kOffPix) + wg * kBM;
    uint8_t* stg = smem + kOffStaging + (tid >> 5) * kStageWarp;
    const int wrow = (wtid >> 5) * 16;  // the warp's 16 rows of each half
    const float sx = *p.s_x;
    const bool acc_bf16 = p.acc_bf16 != 0;
    const bool store8 = KIND == kOutS8 && (p.N & 15) != 0;
    constexpr int kE = Out<KIND>::kBytes;
    constexpr int kChunk = kPitch / kE;  // channels per pass: a 128-byte row

    int acc[2][64];  // rows 0-63 and 64-127 of the tile
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0;
    Ring ring = {0, 0};
    ring.advance(wg * k_steps);

    for (int t = blockIdx.x + wg * gridDim.x; t < p.tiles;
         t += 2 * gridDim.x) {
      const Tile tl = tile_at(p, t);
      warpgroup_sync(wg);  // the last epilogue is done with the vectors
      {
        const int n = tl.n0 + wtid;
        const bool ok = n < p.N;
        vsc[wtid] = ok ? __fmul_rn(sx, p.w_scale[n]) : 0.0f;
        vbi[wtid] = ok ? p.bias[n] : 0.0f;
        viv[wtid] = ok && KIND == kOutS8 ? p.inv[n] : 0.0f;
        const int bw = p.box_w, bhw = p.box_h * p.box_w;
        const int b = tl.b0 + wtid / bhw;
        const int h = tl.h0 + wtid % bhw / bw;
        const int w = tl.w0 + wtid % bw;
        vpix[wtid] = b < p.B && h < p.H && w < p.W ? (b * p.H + h) * p.W + w
                                                   : -1;
      }

      if (t >= (int)gridDim.x) order_wait(wg);  // not the block's first tile
      int prev = 0;
      for (int kt = 0; kt < k_steps; ++kt) {
        mbar_wait(full0 + 8 * ring.stage, ring.phase);
        const uint32_t sa = base + ring.stage * kStage;
        const uint64_t da = desc_sw128(sa);
        const uint64_t db = desc_sw128(sa + kA);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk) {
          const int scale_d = (kt | kk) != 0;
          // Rows 64-127 start 64 rows of 128 bytes (8 KB) further on.
          mma_m64n128k32(acc[0], da + 2 * kk, db + 2 * kk, scale_d);
          mma_m64n128k32(acc[1], da + (8192 >> 4) + 2 * kk, db + 2 * kk,
                         scale_d);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's group is done with its stage
        if (kt > 0) mbar_arrive(empty0 + 8 * prev);
        prev = ring.stage;
        ring.advance(1);
      }
      wgmma_wait<0>();
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      mbar_arrive(empty0 + 8 * prev);
      if (t + (int)gridDim.x < p.tiles) order_signal(wg);
      ring.advance(k_steps);  // the other warpgroup's tile

      warpgroup_sync(wg);  // the tile's vectors and pixel offsets are in place

      // Accumulator 4 j + v of half mh is tile row 64 mh + wrow + g + 8 (v /
      // 2), column 8 j + 2 tq + v % 2.  Pass (mh, ch) dequantizes the kChunk
      // columns from kChunk ch of the warp's 16 rows in registers, stages
      // them in the output type (128 bytes a row), then writes each row
      // with eight 16-byte stores of neighbouring lanes.  (No break: the
      // loops must unroll, so that every accumulator index is a constant.)
#pragma unroll
      for (int mh = 0; mh < 2; ++mh) {
#pragma unroll
        for (int ch = 0; ch < kBN / kChunk; ++ch) {
          const int n_base = tl.n0 + ch * kChunk;
          if (n_base >= p.N) continue;
#pragma unroll
          for (int jb = 0; jb < kChunk / 8; ++jb) {
            const int j = ch * (kChunk / 8) + jb;
            const int col = 8 * jb + 2 * tq;  // within the chunk
            const int ct = ch * kChunk + col;  // within the tile
            const float2 sc = *reinterpret_cast<const float2*>(vsc + ct);
            const float2 bi = *reinterpret_cast<const float2*>(vbi + ct);
            const float2 iv = KIND == kOutS8
                                  ? *reinterpret_cast<const float2*>(viv + ct)
                                  : make_float2(0.0f, 0.0f);
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int v = 4 * j + 2 * half;
              Out<KIND>::put(stg + staged(g + 8 * half, col * kE),
                             dequant(acc[mh][v], sc.x, bi.x, acc_bf16),
                             dequant(acc[mh][v + 1], sc.y, bi.y, acc_bf16),
                             iv.x, iv.y);
            }
          }
          __syncwarp();
#pragma unroll
          for (int it = 0; it < 4; ++it) {  // 16 rows of 8 units, 32 a step
            const int row = 4 * it + lane / 8;
            const int u = lane % 8;
            const int pix = vpix[64 * mh + wrow + row];
            const int n = n_base + u * 16 / kE;
            if (pix < 0 || n >= p.N) continue;
            const uint4 q = *reinterpret_cast<const uint4*>(
                stg + row * kPitch + ((u ^ (row & 7)) << 4));
            uint8_t* o = static_cast<uint8_t*>(p.out) +
                         (static_cast<int64_t>(pix) * p.N + n) * kE;
            if (!store8) {
              *reinterpret_cast<uint4*>(o) = q;
            } else {  // s8 rows of N % 16 == 8 bytes: 8-byte aligned only
              *reinterpret_cast<uint2*>(o) = make_uint2(q.x, q.y);
              if (n + 8 < p.N)
                *reinterpret_cast<uint2*>(o + 8) = make_uint2(q.z, q.w);
            }
          }
          __syncwarp();
        }
      }
    }
  }
}

// ---------------------------------------------------------------- host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 128-byte-swizzled, zero-filled s8 tensor map; dims and box innermost
// first, strides in bytes of every dimension but the first.
CUresult encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int rank,
                const cuuint64_t* dims, const cuuint64_t* strides,
                const cuuint32_t* box) {
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(ptr),
            dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int KIND>
int launch(const CUtensorMap& tx, const CUtensorMap& tw, const Args& p,
           int ctas, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      qconv3x3_s8_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return err;
  qconv3x3_s8_kernel<KIND><<<ctas, kThreads, kSmem, stream>>>(tx, tw, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: s8 [B, H, W, C]; w: s8 [N, 3, 3, C]; s_x: float32 0-d; w_scale, bias:
// float32 [N]; inv: float32 [N] for out_kind 2 (s8), else unused; out:
// [B, H, W, N] of float32 (out_kind 0), bf16 (1) or s8 (2).  Requires
// C % 16 == 0, N % 8 == 0, x and w 16-byte aligned, B*H*W < 2^31.
// (box_b, box_h, box_w): the pixel box of one M tile, 128 pixels
// (ops/qconv.py::pixel_box); the grid is min(max_ctas, tiles) blocks.
// Returns a cudaError_t, or 90001 for a box it does not take, 90002 when
// the driver has no cuTensorMapEncodeTiled, and 91000 + the CUresult when a
// tensor map is refused.
int qconv3x3_s8(const void* x, const void* w, const float* s_x,
                const float* w_scale, const float* bias, const float* inv,
                void* out, int B, int H, int W, int C, int N, int acc_bf16,
                int out_kind, int box_b, int box_h, int box_w, int max_ctas,
                void* stream) {
  if (box_b * box_h * box_w != kBM || box_b < 1 || box_h < 1 || box_w < 1 ||
      max_ctas < 1 || out_kind < 0 || out_kind > 2)
    return 90001;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return 90002;

  CUtensorMap tx, tw;
  const cuuint64_t x_dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                                (cuuint64_t)B};
  const cuuint64_t x_strides[3] = {(cuuint64_t)C, (cuuint64_t)W * C,
                                   (cuuint64_t)H * W * C};
  const cuuint32_t x_box[4] = {kBK, (cuuint32_t)box_w, (cuuint32_t)box_h,
                               (cuuint32_t)box_b};
  CUresult res = encode(fn, &tx, x, 4, x_dims, x_strides, x_box);
  if (res != CUDA_SUCCESS) return 91000 + res;
  const cuuint64_t w_dims[3] = {(cuuint64_t)C, 9, (cuuint64_t)N};
  const cuuint64_t w_strides[2] = {(cuuint64_t)C, (cuuint64_t)9 * C};
  const cuuint32_t w_box[3] = {kBK, 1, kBN};
  res = encode(fn, &tw, w, 3, w_dims, w_strides, w_box);
  if (res != CUDA_SUCCESS) return 91000 + res;

  Args p;
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
  p.box_b = box_b;
  p.box_h = box_h;
  p.box_w = box_w;
  p.grid_h = (H + box_h - 1) / box_h;
  p.grid_w = (W + box_w - 1) / box_w;
  p.n_tiles = (N + kBN - 1) / kBN;
  p.tiles = (B + box_b - 1) / box_b * p.grid_h * p.grid_w * p.n_tiles;
  const int ctas = max_ctas < p.tiles ? max_ctas : p.tiles;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (out_kind) {
    case kOutF32:
      return launch<kOutF32>(tx, tw, p, ctas, st);
    case kOutBF16:
      return launch<kOutBF16>(tx, tw, p, ctas, st);
    default:
      return launch<kOutS8>(tx, tw, p, ctas, st);
  }
}

// Dynamic shared memory of the kernel, bytes.
int qconv3x3_s8_smem_bytes() {
  return kSmem;
}

}  // extern "C"

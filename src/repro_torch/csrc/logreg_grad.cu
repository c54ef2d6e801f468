// The sparse logistic-regression gradient of the paper's workload (eq. 22,
// smooth part),  g = X^T ( -y * sigmoid(-y * (X w)) ) / m,  as two kernels
// of the TPU code:
//
//   the matmul (B5) — C = A B, or A^T B without building A^T, with an fp32
//       sum, C in the operands' type, rounded once. Replaces
//       src/repro/kernels/logreg_grad.py::matmul (Pallas body
//       _matmul_kernel). Five designs behind one entry point,
//       logreg_matmul, which picks the design by shape, type and
//       alignment (logreg_matmul_plan);
//   margin_kernel (B6) — v = -y * sigmoid(-y * s) elementwise. Replaces
//       src/repro/kernels/logreg_grad.py::margin (Pallas body
//       _margin_kernel).
//
// The matmul. A is stored (M, K) row-major, or (K, M) when kTransA; B is
// (K, N) and C is (M, N), both row-major; one element type for all three
// (float, __nv_bfloat16 or __half). Any (M, K, N) works: ragged edges
// read as zeros (TMA's or cp.async's zero fill, or bounds-checked loads)
// and every store is bounds-checked, so nothing is padded in device
// memory. The TPU kernel's 128x128x128 MXU blocks and its 128-lane w / v
// panels are the MXU's formulation; here the tiles are the card's.
//
// Design by case (the route codes of logreg_matmul_plan):
//
// gemv16 (N = 1, bf16/f16, A's rows a multiple of 8 elements, operands
//   16-byte aligned): the gradient's two passes in 16 bits. Bound by
//   bytes: A is read once, 2MK bytes (X of (2^18, 2^14): 2.564 ms at
//   3.35 TB/s; 2MK flops are nothing beside it). Every lane loads 16
//   bytes (8 elements) at a time, evict-first:
//   gemv16_rows_kernel (X w, A (M, K)): one warp per row, lane l sums
//     the 8-element vectors l, l + 32, ... in order, four loads in
//     flight, then a butterfly of shuffles adds the 32 lane sums;
//   gemv16_cols_kernel (X^T v, A (K, M)): a block owns 256 columns (8 a
//     lane, a warp's load is 512 contiguous bytes of a row) and one of
//     `splits` contiguous K segments; its 8 warps each sum a contiguous
//     eighth of the segment in k order (eight loads in flight), and the
//     block adds the 8 in warp order into a float32 scratch row (splits
//     x M, allocated by the caller). 256 columns a block leave 64 column
//     blocks at d = 2^14, so K is split across blocks (about 4,096
//     blocks in all, a split at least 256 rows); then
//     gemv16_sum_kernel adds the splits' rows in split order and rounds.
//     Two launches, no atomics; the split depends on (M, K) only.
// gemv (N = 1, float32, or 16 bits with rows not a multiple of 8):
//   one element a lane per load. gemv_rows_kernel (X w): one warp per
//   output row, lane l sums k = l, l + 32, ... with 8 coalesced loads in
//   flight, then the butterfly. gemv_cols_kernel (X^T v): a block owns 32
//   columns, one per lane, and its 16 warps each sum one contiguous
//   sixteenth of K in order; the 16 partial sums are added in warp order.
//   In float32 a warp's load covers 128 bytes and the pair runs at ~89 %
//   of the memory rate (4MK bytes: 20.5 ms at m = 2^20, d = 2^14).
// wgmma (N > 1, bf16/f16, A's rows and N a multiple of 8, 16-byte aligned
//   operands: TMA's strides): bound by the tensor cores, 2MNK flops at
//   989 TFLOP/s (0.139 ms at 4096^3). matmul_wgmma_kernel: a block owns a
//   128 x 256 tile of C; 384 threads, two consumer warpgroups of 64 rows
//   each and a producer warpgroup that gives its registers away
//   (setmaxnreg 40 / 232). One producer thread keeps a ring of 4 stages
//   of 64-deep A (128 x 64) and B (64 x 256) tiles in flight by TMA
//   (128-byte swizzle, 64-element boxes, zeros past every edge), with a
//   full and an empty mbarrier a stage. Each consumer issues 4 wgmma
//   m64n256k16 a stage with the f32 sum in registers (128 a thread), both
//   operands from shared memory: B is N-major, through the transpose
//   bit; A is K-major (stored (M, K)) or M-major (stored (K, M), the
//   transpose bit again), so A^T is never built. A stage is released
//   once the next stage's products are issued and its own have landed
//   (wgmma.wait_group 1). The epilogue rounds each pair of outputs once
//   and stores it bounds-checked.
// tf32x3 (N > 1, float32, A's rows and N a multiple of 4, 16-byte
//   aligned): float32 accuracy on the tensor cores. Bound: 2MNK flops
//   at a third of 495 TFLOP/s TF32 (three products each; 0.833 ms at
//   4096^3, against FFMA's 2.05). matmul_tf32x3_kernel: a block owns a
//   128 x 128 tile of C, 4 warps of 64 x 64, two blocks an SM; 32-deep
//   A and B tiles come by cp.async (16 bytes a copy, zeros past the
//   edges) into a ring of 3 stages with padded rows, so every fragment
//   load is free of bank conflicts; the copies' addresses are set up
//   once and step by a tile. Each warp splits the fragments it loads in
//   registers, x = hi + lo with hi the TF32 rounding of x (to nearest,
//   ties away, as cvt.rna.tf32 in two integer operations) and lo that of
//   x - hi: a 64 x 64 warp tile uses each split A element on 8 column
//   tiles and each B element on 4 row tiles (B7's f32 kernel split
//   every element for one 16-row tile and was issue-bound). A product
//   is lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b) on mma.sync.m16n8k8,
//   small terms first, into a fresh accumulator each k8 step that is
//   then added to the float32 sum (the tensor core's accumulation
//   truncates: carried over all of K its error would pass the float64
//   gate). Inf and NaN: x - hi is NaN at an Inf, and 0 * Inf in a cross
//   term (a TF32-exact partner has lo = 0) would turn the plain
//   version's Inf into NaN. So nonfinite_scan_kernel first reads A and
//   B once (a flag in the caller's scratch); where it found an Inf or a
//   NaN, each thread tests the copies it made of a tile, the block votes
//   (__syncthreads_or, the barrier the pipeline takes anyway), and a
//   tile that holds one first adds every product that involves one in
//   float32, as the plain version forms it, then zeroes those entries
//   for the tensor cores. Finite operands, all of them in practice,
//   split with no guard and no test (a guarded split costs three
//   instructions an element and a third register for each A fragment,
//   and the test a load of every copy before the barrier, where the
//   kernel is short of issue slots and registers). mma.sync
//   rather than wgmma: TF32 wgmma takes shared-memory operands K-major
//   only, and
//   neither B nor a transposed A is, so it would need a transposing
//   split through shared memory (B7's such variant held one consumer
//   warpgroup in 224 KB and was no faster). One pass of TF32 (1xTF32)
//   would fail the float64 gate, which refuses TF32-rounded inputs.
// tiled (N > 1 where TMA's or cp.async's alignment fails, e.g.
//   (100, 50, 30); and K = 0): matmul_kernel<kTransA, 64, 64, 16, 4, 4>,
//   FFMA in float32 from shared-memory tiles: a block computes a 64 x 64
//   tile of C, walking K in steps of 16; the A tile is stored k-major in
//   shared memory (so both layouts read the same way), each load is
//   coalesced along the stored rows, and each of 256 threads
//   accumulates 4 x 4 outputs 16 rows and 16 columns apart.
//
// Every output's sum runs in an order fixed by the code and the shape (in
// k order within a thread or a tensor-core step, then the fixed
// combinations above): no atomics and no split of K whose order depends
// on the grid, so a run repeats bit for bit. Indices are 64-bit (X at full
// width has 2^34 elements); TMA's coordinates are 32-bit, so the wgmma
// design takes M, N, K below 2^31.
//
// margin_kernel reads s and y and writes v: 12 bytes an element, memory-
// bound. Grid-stride loop, 64-bit indices. sigmoid(t) = 1 / (1 + expf(-t))
// with expf (not __expf) and IEEE division, as torch.sigmoid computes it
// on the card, and every product rounded on its own, so the result is the
// plain version's bit for bit. For -y*s << 0, expf overflows to inf and
// v = -y * 0; a NaN in s or y stays NaN.
//
// Element types. Values are widened to float on load, every sum and
// product is taken in float (or as the tensor cores' f32 accumulation),
// and each output is rounded to T once (round to nearest even), as the
// plain versions widen and round.

#include <cmath>
#include <cstdint>
#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

__device__ __forceinline__ float ldf(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ float ldf(const __half* p) {
  return __half2float(__ldg(p));
}
__device__ __forceinline__ void stf(float* p, float v) { *p = v; }
__device__ __forceinline__ void stf(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void stf(__half* p, float v) {
  *p = __float2half(v);
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// ===========================================================================
// tiled: FFMA from shared-memory tiles (any strides)
// ===========================================================================

template <typename T, bool kTransA, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    matmul_kernel(const T* __restrict__ A, const T* __restrict__ B,
                  T* __restrict__ C, int64_t M, int64_t N, int64_t K) {
  constexpr int TY = BM / TM, TX = BN / TN, THREADS = TY * TX;
  // tile elements each thread loads per K step
  constexpr int A_LOADS = BM * BK / THREADS, B_LOADS = BK * BN / THREADS;
  static_assert(A_LOADS * THREADS == BM * BK && B_LOADS * THREADS == BK * BN,
                "the block loads whole tiles");
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int64_t k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int r = 0; r < A_LOADS; ++r) {
      const int e = tid + r * THREADS;
      int mm, kk;
      if (kTransA) {            // stored (K, M): contiguous along m
        kk = e / BM;
        mm = e % BM;
      } else {                  // stored (M, K): contiguous along k
        mm = e / BK;
        kk = e % BK;
      }
      const int64_t m = m0 + mm, k = k0 + kk;
      float a = 0.f;
      if (m < M && k < K) a = ldf(kTransA ? A + k * M + m : A + m * K + k);
      As[kk][mm] = a;
    }
#pragma unroll
    for (int r = 0; r < B_LOADS; ++r) {
      const int e = tid + r * THREADS;
      const int kk = e / BN, nn = e % BN;
      const int64_t k = k0 + kk, n = n0 + nn;
      Bs[kk][nn] = (k < K && n < N) ? ldf(B + k * N + n) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t m = m0 + ty + i * TY;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t n = n0 + tx + j * TX;
      if (m < M && n < N) stf(C + m * N + n, acc[i][j]);
    }
  }
}

// ===========================================================================
// gemv: N = 1, one element a lane per load
// ===========================================================================

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kUnroll = 8;             // loads in flight per lane
constexpr int kColWarps = 16;          // gemv_cols_kernel: warps per block

template <typename T>
__global__ void gemv_rows_kernel(const T* __restrict__ A,
                                 const T* __restrict__ b,
                                 T* __restrict__ c, int64_t M,
                                 int64_t K) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t m = warp; m < M; m += warps) {
    const T* a = A + m * K;
    float acc = 0.f;
    int64_t k = lane;
    for (; k + 32 * (kUnroll - 1) < K; k += 32 * kUnroll) {
      float av[kUnroll], bv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        av[u] = ldf(a + k + 32 * u);
        bv[u] = ldf(b + k + 32 * u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc = fmaf(av[u], bv[u], acc);
    }
    for (; k < K; k += 32) acc = fmaf(ldf(a + k), ldf(b + k), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(kFullMask, acc, off);
    if (lane == 0) stf(c + m, acc);
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * kColWarps)
    gemv_cols_kernel(const T* __restrict__ A,
                     const T* __restrict__ b, T* __restrict__ c,
                     int64_t M, int64_t K) {
  __shared__ float part[kColWarps][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int64_t j = static_cast<int64_t>(blockIdx.x) * 32 + lane;
  const int64_t seg = (K + kColWarps - 1) / kColWarps;
  const int64_t k_begin = w * seg;
  const int64_t k_end = (k_begin + seg < K) ? k_begin + seg : K;
  float acc = 0.f;
  if (j < M) {
    const T* a = A + j;
    int64_t k = k_begin;
    for (; k + kUnroll <= k_end; k += kUnroll) {
      float av[kUnroll], bv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        av[u] = ldf(a + (k + u) * M);
        bv[u] = ldf(b + k + u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc = fmaf(av[u], bv[u], acc);
    }
    for (; k < k_end; ++k) acc = fmaf(ldf(a + k * M), ldf(b + k), acc);
  }
  part[w][lane] = acc;
  __syncthreads();
  if (w == 0 && j < M) {
    float sum = part[0][lane];
#pragma unroll
    for (int i = 1; i < kColWarps; ++i) sum += part[i][lane];
    stf(c + j, sum);
  }
}

// ===========================================================================
// gemv16: N = 1 in 16 bits, 16-byte loads
// ===========================================================================

constexpr int kVec = 8;                 // 16-bit elements in 16 bytes
constexpr int kRowUnroll = 4;           // 16-byte loads in flight a lane,
constexpr int kColUnroll = 8;           // ... in the rows and cols kernels
constexpr int kCol16Warps = 8;          // gemv16_cols_kernel: warps a block
constexpr int kCol16Width = 32 * kVec;  // ... and columns a block
constexpr int64_t kCol16Blocks = 4096;  // blocks the K split aims at
constexpr int64_t kCol16MinRows = 256;  // rows a K split holds at least

// the 8 values of a 16-byte vector, widened to float
__device__ __forceinline__ void widen8(const uint4& v, float (&x)[8],
                                       const __nv_bfloat16*) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void widen8(const uint4& v, float (&x)[8],
                                       const __half*) {
  const __half2* p = reinterpret_cast<const __half2*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(p[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// acc + sum_e a_e b_e over one vector, in element order
template <typename T>
__device__ __forceinline__ float dot8(const uint4& a, const uint4& b,
                                      float acc) {
  float x[8], y[8];
  widen8(a, x, static_cast<const T*>(nullptr));
  widen8(b, y, static_cast<const T*>(nullptr));
#pragma unroll
  for (int e = 0; e < 8; ++e) acc = fmaf(x[e], y[e], acc);
  return acc;
}

template <typename T>
__global__ void gemv16_rows_kernel(const T* __restrict__ A,
                                   const T* __restrict__ b,
                                   T* __restrict__ c, int64_t M,
                                   int64_t K) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const int64_t KV = K / kVec;                 // vectors a row
  const uint4* bv = reinterpret_cast<const uint4*>(b);
  for (int64_t m = warp; m < M; m += warps) {
    const uint4* av = reinterpret_cast<const uint4*>(A + m * K);
    float acc = 0.f;
    int64_t v = lane;
    for (; v + 32 * (kRowUnroll - 1) < KV; v += 32 * kRowUnroll) {
      uint4 a[kRowUnroll], w[kRowUnroll];
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        a[u] = __ldcs(av + v + 32 * u);        // A streams: evict first
        w[u] = __ldg(bv + v + 32 * u);
      }
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) acc = dot8<T>(a[u], w[u], acc);
    }
    for (; v < KV; v += 32) acc = dot8<T>(__ldcs(av + v), __ldg(bv + v), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(kFullMask, acc, off);
    if (lane == 0) stf(c + m, acc);
  }
}

// the float32 partial sums of K segment blockIdx.y (rows [y seg, (y + 1)
// seg)) for columns [256 blockIdx.x, + 256) into part[y][.]
template <typename T>
__global__ void __launch_bounds__(32 * kCol16Warps)
    gemv16_cols_kernel(const T* __restrict__ A, const T* __restrict__ b,
                       float* __restrict__ part, int64_t M, int64_t K,
                       int64_t seg) {
  __shared__ float4 red[kCol16Warps][kCol16Width / 4];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int64_t j0 =
      static_cast<int64_t>(blockIdx.x) * kCol16Width + kVec * lane;
  const int64_t k_lo = static_cast<int64_t>(blockIdx.y) * seg;
  const int64_t k_hi = min64(k_lo + seg, K);
  const int64_t sub = (k_hi - k_lo + kCol16Warps - 1) / kCol16Warps;
  const int64_t k_begin = min64(k_lo + w * sub, k_hi);
  const int64_t k_end = min64(k_begin + sub, k_hi);
  float acc[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
  if (j0 < M) {             // M is a multiple of 8: all 8 columns exist
    const T* a = A + j0;
    int64_t k = k_begin;
    for (; k + kColUnroll <= k_end; k += kColUnroll) {
      uint4 av[kColUnroll];
      float bk[kColUnroll];
#pragma unroll
      for (int u = 0; u < kColUnroll; ++u) {
        av[u] = __ldcs(reinterpret_cast<const uint4*>(a + (k + u) * M));
        bk[u] = ldf(b + k + u);
      }
#pragma unroll
      for (int u = 0; u < kColUnroll; ++u) {
        float x[kVec];
        widen8(av[u], x, static_cast<const T*>(nullptr));
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[e] = fmaf(x[e], bk[u], acc[e]);
      }
    }
    for (; k < k_end; ++k) {
      float x[kVec];
      widen8(__ldcs(reinterpret_cast<const uint4*>(a + k * M)), x,
             static_cast<const T*>(nullptr));
      const float bk = ldf(b + k);
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] = fmaf(x[e], bk, acc[e]);
    }
  }
  red[w][2 * lane] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  red[w][2 * lane + 1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  __syncthreads();
  const int64_t j =
      static_cast<int64_t>(blockIdx.x) * kCol16Width + threadIdx.x;
  if (j < M) {
    const float* r = reinterpret_cast<const float*>(red);
    float s = r[threadIdx.x];
#pragma unroll
    for (int i = 1; i < kCol16Warps; ++i) s += r[i * kCol16Width + threadIdx.x];
    part[static_cast<int64_t>(blockIdx.y) * M + j] = s;
  }
}

// c[j] = sum over the splits of part[.][j], in split order, rounded once
template <typename T>
__global__ void gemv16_sum_kernel(const float* __restrict__ part,
                                  T* __restrict__ c, int64_t M, int splits) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < M; j += stride) {
    float s = part[j];
    for (int i = 1; i < splits; ++i) s += part[i * M + j];
    stf(c + j, s);
  }
}

// ===========================================================================
// margin (B6)
// ===========================================================================

template <typename T>
__global__ void margin_kernel(const T* __restrict__ s,
                              const T* __restrict__ y,
                              T* __restrict__ v, int64_t total) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const float ny = -ldf(y + i);
    const float t = __fmul_rn(ny, ldf(s + i));
    const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-t)));
    stf(v + i, __fmul_rn(ny, sig));
  }
}

// ===========================================================================
// wgmma: N > 1 in bf16 / f16, TMA and the tensor cores
// ===========================================================================

struct Bf16 {};
struct F16 {};
template <typename T> struct TagOf;
template <> struct TagOf<__nv_bfloat16> { using type = Bf16; };
template <> struct TagOf<__half> { using type = F16; };

// two floats rounded (to nearest even) into one register, the first in
// the low half
__device__ __forceinline__ uint32_t pack2(float lo, float hi, Bf16) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi, F16) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
// arrive, and expect `bytes` of TMA transactions in the current phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n"
      :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// one box of a 2-D tensor map into shared memory, completing on `bar`;
// c0 is the inner (contiguous) coordinate
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma's shared-memory matrix descriptor for a tile as TMA's 128-byte
// swizzle lays it out: rows of 64 elements (128 bytes), 8-row groups 1024
// bytes apart (SBO); `lbo` bytes between 64-element column blocks, read
// only for an MN-major operand. Tiles start on 1024-byte boundaries.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N of this warpgroup's committed wgmma groups run
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across its issue or its wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// D (64 x 256, f32) += A (64 x 16) B (16 x 256), both from shared memory;
// B MN-major (the transpose bit), A K-major (kTA = 0) or MN-major (1)
template <int kTA>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], Bf16, uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %131, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %130, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "n"(kTA), "r"(1));
}

// D (64 x 256, f32) += A (64 x 16) B (16 x 256), both from shared memory;
// B MN-major (the transpose bit), A K-major (kTA = 0) or MN-major (1)
template <int kTA>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], F16, uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %131, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %130, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "n"(kTA), "r"(1));
}

constexpr int kWgBM = 128, kWgBN = 256, kWgBK = 64;  // C tile, K step
constexpr int kWgStages = 4;
constexpr int kWgThreads = 384;         // 2 consumer + 1 producer warpgroup
constexpr int kWgABytes = kWgBM * kWgBK * 2;          // 16 KB
constexpr int kWgBBytes = kWgBK * kWgBN * 2;          // 32 KB
constexpr int kWgStageBytes = kWgABytes + kWgBBytes;
// the stages, 2 mbarriers a stage, room to align to 1024
constexpr int kWgSmem = kWgStages * kWgStageBytes + 16 * kWgStages + 1024;

template <typename T, bool kTransA>
__global__ void __launch_bounds__(kWgThreads, 1)
    matmul_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                        const __grid_constant__ CUtensorMap tb,
                        T* __restrict__ c, int M, int N, int K) {
  using Tag = typename TagOf<T>::type;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // A stage: (M, K) stored: 128 rows of 64 k; (K, M) stored: two blocks
  // of 64 k-rows x 64 m, one a consumer warpgroup. B stage: four blocks
  // of 64 k-rows x 64 n.
  T* As = reinterpret_cast<T*>(base);
  T* Bs = As + kWgStages * kWgBM * kWgBK;
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + kWgStages * kWgBK * kWgBN);
  uint64_t* empty = full + kWgStages;
  const int m0 = blockIdx.x * kWgBM, n0 = blockIdx.y * kWgBN;
  const int n_k = (K + kWgBK - 1) / kWgBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);            // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= 8) {
    // producer warpgroup: gives its registers to the consumers; one
    // thread loads each stage when it is free
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 8 && lane == 0) {
      for (int t = 0; t < n_k; ++t) {
        const int s = t % kWgStages;
        if (t >= kWgStages)                 // tile t - kWgStages released
          mbar_wait(&empty[s], ((t / kWgStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], kWgStageBytes);
        T* a = As + s * kWgBM * kWgBK;
        if (kTransA) {
          tma_load(a, &ta, &full[s], m0, t * kWgBK);
          tma_load(a + 64 * 64, &ta, &full[s], m0 + 64, t * kWgBK);
        } else {
          tma_load(a, &ta, &full[s], t * kWgBK, m0);
        }
        T* b = Bs + s * kWgBK * kWgBN;
#pragma unroll
        for (int q = 0; q < kWgBN / 64; ++q)
          tma_load(b + q * 64 * 64, &tb, &full[s], n0 + 64 * q, t * kWgBK);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    // consumer warpgroup wg: rows [m0 + 64 wg, + 64), all 256 columns
    const int wg = warp / 4;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    for (int t = 0; t < n_k; ++t) {
      const int s = t % kWgStages;
      mbar_wait(&full[s], (t / kWgStages) & 1);
      const T* a = As + s * kWgBM * kWgBK + wg * 64 * 64;
      const T* b = Bs + s * kWgBK * kWgBN;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk) {
        // k16 step kk: 32 bytes into a K-major row, or 16 rows down an
        // MN-major block
        const uint64_t da = kTransA ? sw128_desc(a + kk * 16 * 64, kWgBK * 128)
                                    : sw128_desc(a + kk * 16, 0);
        const uint64_t db = sw128_desc(b + kk * 16 * 64, kWgBK * 128);
        wgmma_n256<kTransA ? 1 : 0>(acc, Tag{}, da, db);
      }
      wgmma_commit();
      wgmma_wait<1>();                      // tile t - 1's products landed
      if (t > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(t - 1) % kWgStages]);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    // acc[4 j + 2 r + e] is row 16 (warp % 4) + lane / 4 + 8 r, column
    // 8 j + 2 (lane % 4) + e of the warpgroup's 64 x 256 tile
    const int cq = 2 * (lane % 4);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + 64 * wg + 16 * (warp % 4) + lane / 4 + 8 * r;
      if (row >= M) continue;
      T* crow = c + static_cast<int64_t>(row) * N;
#pragma unroll
      for (int j = 0; j < kWgBN / 8; ++j) {
        const int col = n0 + 8 * j + cq;  // N is even: col + 1 < N too
        if (col < N)
          *reinterpret_cast<uint32_t*>(crow + col) =
              pack2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1], Tag{});
      }
    }
  }
}

// ===========================================================================
// tf32x3: N > 1 in float32, 3xTF32 on mma.sync
// ===========================================================================

struct Split {
  uint32_t hi, lo;
};

// x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero),
// as integer operations: cvt.rna.tf32.f32 compiles to these two and a
// select that keeps a non-finite x as it is. Here an Inf stays Inf and a
// quiet NaN NaN; the tensor core reads only a TF32 operand's 19 high
// bits, so a NaN whose payload lies in the 13 low bits is an Inf to it
// either way.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo in TF32, for a finite x (the tiles are cleared of Inf
// and NaN first)
__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = to_tf32(x);
  return {hi, to_tf32(__fsub_rn(x, __uint_as_float(hi)))};
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += a b for one k8 step in 3xTF32: the three products, small terms
// first, summed by the tensor core into a fresh accumulator, which is
// then added to d in float32 (rounded to nearest)
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const Split (&a)[4],
                                           const Split& b0, const Split& b1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b0.hi, b1.hi);
  mma_tf32(t, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b0.lo, b1.lo);
  mma_tf32(t, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b0.hi, b1.hi);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

// 16 bytes from global to shared memory, or zeros when !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ bool finite4(const float4& v) {
  return fabsf(v.x) < INFINITY && fabsf(v.y) < INFINITY &&
         fabsf(v.z) < INFINITY && fabsf(v.w) < INFINITY;
}
__device__ __forceinline__ float4 finite_or_zero(const float4& v) {
  auto f = [](float x) { return fabsf(x) < INFINITY ? x : 0.f; };
  return make_float4(f(v.x), f(v.y), f(v.z), f(v.w));
}

// *flag = 1 where A (na4 x 4 floats) or B (nb4 x 4) holds an Inf or a
// NaN (the caller zeroes it first); many blocks may store the same 1
__global__ void nonfinite_scan_kernel(const float4* __restrict__ a,
                                      int64_t na4,
                                      const float4* __restrict__ b,
                                      int64_t nb4, int* __restrict__ flag) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  bool odd = false;
  for (int64_t i = first; i < na4; i += stride) odd |= !finite4(__ldg(a + i));
  for (int64_t i = first; i < nb4; i += stride) odd |= !finite4(__ldg(b + i));
  if (__syncthreads_or(odd) && threadIdx.x == 0) *flag = 1;
}

constexpr int kTfBM = 128, kTfBN = 128, kTfBK = 32;   // C tile, K step
constexpr int kTfStages = 3, kTfThreads = 128;         // 4 warps of 64 x 64
// padded row strides (floats): the (M, K) A tile [BM][BK + 4], the
// (K, M) A tile and the B tile [BK][BM + 8]; both make the fragment
// loads conflict-free (lanes g, t4 hit banks 4 g + t4, or 8 t4 + g)
constexpr int kTfLdA = kTfBK + 4, kTfLdT = kTfBM + 8;
constexpr int kTfAFloats =
    kTfBM * kTfLdA > kTfBK * kTfLdT ? kTfBM * kTfLdA : kTfBK * kTfLdT;
constexpr int kTfStageFloats = kTfAFloats + kTfBK * kTfLdT;
constexpr int kTfSmem = kTfStages * kTfStageFloats * 4;    // 105 KB
static_assert(kTfBM == kTfBN, "the (K, M) A tile and B share a stride");

// the stage's A element (r, k) of the block tile
template <bool kTransA>
__device__ __forceinline__ float tf_a(const float* as, int r, int k) {
  return kTransA ? as[k * kTfLdT + r] : as[r * kTfLdA + k];
}

// acc += the products of a k tile in stage (as, bs) that involve an Inf
// or a NaN, each in float32 as the plain version forms it, for the
// warp's 64 x 64 tile at (wm, wn) (acc[i][j][2 r + e] is row wm + 16 i +
// g + 8 r, column wn + 8 j + 2 t4 + e). Only a tile that holds one
// comes here; the tensor cores then see its non-finite entries as 0.
template <bool kTransA>
__device__ __forceinline__ void tf32x3_nonfinite(float (&acc)[4][8][4],
                                                 const float* as,
                                                 const float* bs, int wm,
                                                 int wn, int g, int t4) {
#pragma unroll 1
  for (int k = 0; k < kTfBK; ++k) {
    float a[4][2], b[8][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        a[i][r] = tf_a<kTransA>(as, wm + 16 * i + g + 8 * r, k);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        b[j][e] = bs[k * kTfLdT + wn + 8 * j + 2 * t4 + e];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (!(fabsf(a[i][r]) < INFINITY && fabsf(b[j][e]) < INFINITY))
              acc[i][j][2 * r + e] += a[i][r] * b[j][e];
  }
}

// acc += A B over one k tile in stage (as, bs) for the warp's 64 x 64
// tile at (wm, wn): 4 k8 steps
template <bool kTransA>
__device__ __forceinline__ void tf32x3_tile(float (&acc)[4][8][4],
                                            const float* as, const float* bs,
                                            int wm, int wn, int g, int t4) {
#pragma unroll
  for (int ks = 0; ks < kTfBK / 8; ++ks) {
    const int k = 8 * ks + t4;
    // A fragments of the warp's 4 row tiles: (r, k), (r + 8, k),
    // (r, k + 4), (r + 8, k + 4), split once for 8 column tiles
    Split a[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = wm + 16 * i + g;
      a[i][0] = split(tf_a<kTransA>(as, r, k));
      a[i][1] = split(tf_a<kTransA>(as, r + 8, k));
      a[i][2] = split(tf_a<kTransA>(as, r, k + 4));
      a[i][3] = split(tf_a<kTransA>(as, r + 8, k + 4));
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = wn + 8 * j + g;
      const Split b0 = split(bs[k * kTfLdT + n]);
      const Split b1 = split(bs[(k + 4) * kTfLdT + n]);
#pragma unroll
      for (int i = 0; i < 4; ++i) mma_3xtf32(acc[i][j], a[i], b0, b1);
    }
  }
}

template <bool kTransA>
__global__ void __launch_bounds__(kTfThreads, 2)
    matmul_tf32x3_kernel(const float* __restrict__ A,
                         const float* __restrict__ B, float* __restrict__ C,
                         int64_t M, int64_t N, int64_t K,
                         const int* __restrict__ nonfinite) {
  extern __shared__ float4 tf_smem4[];
  float* smem = reinterpret_cast<float*>(tf_smem4);
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kTfBM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * kTfBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wm = 64 * (warp % 2), wn = 64 * (warp / 2);
  const int64_t n_k = (K + kTfBK - 1) / kTfBK;

  // k tile kt into stage s, 16 bytes a copy, zeros past the edges (the
  // rows are multiples of 4 floats, so a copy is wholly in or out).
  // Thread t's copies of a tile sit in one column (4 floats wide), kRows
  // stored rows apart, starting at row r: A stored (M, K) as 128 rows of
  // 32, A stored (K, M) and B as 32 rows of 128. The pointers are set up
  // once and step by a whole tile.
  constexpr int kCopies = kTfBK * kTfBN / 4 / kTfThreads;
  constexpr int kRowsA = kTfThreads / ((kTransA ? kTfBM : kTfBK) / 4);
  constexpr int kRowsB = kTfThreads / (kTfBN / 4);
  const int tid = threadIdx.x;
  const int ra = tid / ((kTransA ? kTfBM : kTfBK) / 4);
  const int ca = 4 * (tid % ((kTransA ? kTfBM : kTfBK) / 4));
  const int rb = tid / (kTfBN / 4), cb = 4 * (tid % (kTfBN / 4));
  const int64_t lda = kTransA ? M : K;
  const float* a_src = kTransA ? A + ra * M + m0 + ca : A + (m0 + ra) * K + ca;
  const float* b_src = B + rb * N + n0 + cb;
  const int64_t a_step = kTransA ? kTfBK * M : kTfBK;     // a tile further
  const int64_t b_step = kTfBK * N;
  const bool a_col_ok = !kTransA || m0 + ca < M;
  const bool b_col_ok = n0 + cb < N;
  uint32_t a_rows_ok = 0;            // (M, K): copy u's row is in M
#pragma unroll
  for (int u = 0; u < kCopies; ++u)
    if (m0 + ra + u * kRowsA < M) a_rows_ok |= 1u << u;
  auto load = [&](int64_t kt, int s) {
    const int64_t k0 = kt * kTfBK;
    float* as = smem + s * kTfStageFloats;
    float* bs = as + kTfAFloats;
    const float* ap = a_src + kt * a_step;
    const float* bp = b_src + kt * b_step;
#pragma unroll
    for (int u = 0; u < kCopies; ++u) {
      const bool a_ok = kTransA
          ? a_col_ok && k0 + ra + u * kRowsA < K
          : ((a_rows_ok >> u) & 1u) && k0 + ca < K;
      cp_async16(as + (ra + u * kRowsA) * (kTransA ? kTfLdT : kTfLdA) + ca,
                 a_ok ? ap + u * kRowsA * lda : A, a_ok);
      const bool b_ok = b_col_ok && k0 + rb + u * kRowsB < K;
      cp_async16(bs + (rb + u * kRowsB) * kTfLdT + cb,
                 b_ok ? bp + u * kRowsB * N : B, b_ok);
    }
  };

  float acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  if (n_k > 0) load(0, 0);
  cp_async_commit();
  if (n_k > 1) load(1, 1);
  cp_async_commit();
  // whether A or B holds an Inf or a NaN anywhere (nonfinite_scan_kernel
  // ran first): only then are the tiles tested
  const bool any_nonfinite = *nonfinite != 0;
  for (int64_t kt = 0; kt < n_k; ++kt) {
    cp_async_wait<1>();            // tile kt landed (this thread's copies)
    float* as = smem + (kt % kTfStages) * kTfStageFloats;
    float* bs = as + kTfAFloats;
    // this thread's copies of tile kt, and whether one holds an Inf or
    // a NaN
    auto copy_a = [&](int u) {
      return reinterpret_cast<float4*>(
          as + (ra + u * kRowsA) * (kTransA ? kTfLdT : kTfLdA) + ca);
    };
    auto copy_b = [&](int u) {
      return reinterpret_cast<float4*>(bs + (rb + u * kRowsB) * kTfLdT + cb);
    };
    bool odd_tile = false;
    if (any_nonfinite) {
      bool odd = false;
#pragma unroll 2
      for (int u = 0; u < kCopies; ++u)
        odd |= !finite4(*copy_a(u)) | !finite4(*copy_b(u));
      // everyone's copies landed; tile kt - 1 is done
      odd_tile = __syncthreads_or(odd);
    } else {
      __syncthreads();               // the same, with no test
    }
    if (kt + 2 < n_k) load(kt + 2, static_cast<int>((kt + 2) % kTfStages));
    cp_async_commit();
    if (odd_tile) {        // rare: add the non-finite products, then clear
      tf32x3_nonfinite<kTransA>(acc, as, bs, wm, wn, g, t4);
      __syncthreads();
#pragma unroll 1
      for (int u = 0; u < kCopies; ++u) {
        *copy_a(u) = finite_or_zero(*copy_a(u));
        *copy_b(u) = finite_or_zero(*copy_b(u));
      }
      __syncthreads();
    }
    tf32x3_tile<kTransA>(acc, as, bs, wm, wn, g, t4);
  }
  cp_async_wait<0>();

  // acc[i][j][2 r + e] is row wm + 16 i + g + 8 r, column wn + 8 j +
  // 2 t4 + e; N is a multiple of 4, so col < N puts col + 1 in too
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int64_t row = m0 + wm + 16 * i + g + 8 * r;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int64_t col = n0 + wn + 8 * j + 2 * t4;
        if (col < N)
          *reinterpret_cast<float2*>(C + row * N + col) =
              make_float2(acc[i][j][2 * r], acc[i][j][2 * r + 1]);
      }
    }
}

// ===========================================================================
// host side
// ===========================================================================

int sm_count(int device) {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return sms > 0 ? sms : 1;
}

// Enough blocks of `threads` to fill every SM at full occupancy, or fewer
// when `need` is smaller; grid-stride loops cover the rest.
int fill_blocks(int device, int64_t need, int threads) {
  const int64_t full = static_cast<int64_t>(sm_count(device)) * (2048 / threads);
  return static_cast<int>(need < full ? need : full);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, reached through the runtime so the
// library needs no -lcuda
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a 2-D map over a row-major (outer, inner) matrix of 16-bit elements:
// boxes of 64 x box_outer, 128-byte swizzle, zeros past the edges
bool make_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
              int64_t inner, int64_t outer, int box_outer) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  return encoder()(map, type, 2, const_cast<void*>(ptr), dims, strides, box,
                   elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T> constexpr CUtensorMapDataType map_type();
template <> constexpr CUtensorMapDataType map_type<__nv_bfloat16>() {
  return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}
template <> constexpr CUtensorMapDataType map_type<__half>() {
  return CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
}

// Element type codes of the entry points' `dtype` argument.
enum : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

// The matmul's designs (logreg_matmul_plan's return value).
enum : int { kTiled = 0, kGemv = 1, kGemv16 = 2, kWgmma = 3, kTf32x3 = 4 };

struct Plan {
  int route;
  int64_t splits, seg;    // gemv16 X^T v: K segments, rows in each
  // the scratch it needs: gemv16's X^T v its partial sums, tf32x3 the
  // flag of nonfinite_scan_kernel
  int64_t scratch_bytes(int64_t M) const {
    if (route == kTf32x3) return 16;
    return splits * M * static_cast<int64_t>(sizeof(float));
  }
};

// The design for (M, N, K) in `dtype` with A at `a` and B at `b`: by
// shape, type and alignment only, so a shape always takes one design.
Plan plan_matmul(const void* a, const void* b, int64_t M, int64_t N,
                 int64_t K, bool trans_a, int dtype) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
       15) == 0;
  const int64_t lead = trans_a ? M : K;     // A's stored row, elements
  Plan p{kTiled, 0, 0};
  if (M == 0 || N == 0) return p;           // nothing is launched
  if (N == 1) {
    p.route = kGemv;
    if (dtype != kF32 && aligned && K > 0 && lead % kVec == 0) {
      p.route = kGemv16;
      if (trans_a) {       // about kCol16Blocks blocks, whole-row segments
        const int64_t groups = (M + kCol16Width - 1) / kCol16Width;
        int64_t want = (kCol16Blocks + groups - 1) / groups;
        const int64_t most = (K + kCol16MinRows - 1) / kCol16MinRows;
        if (want > most) want = most;
        if (want < 1) want = 1;
        p.seg = (K + want - 1) / want;
        p.splits = (K + p.seg - 1) / p.seg;
      }
    }
    return p;
  }
  if (K == 0) return p;                     // the tiled kernel writes zeros
  if (dtype == kF32) {
    if (aligned && lead % 4 == 0 && N % 4 == 0) p.route = kTf32x3;
  } else {
    const int64_t most = 2147483647LL - kWgBN;
    if (aligned && lead % 8 == 0 && N % 8 == 0 && M < most && N < most &&
        K < most)
      p.route = kWgmma;
  }
  return p;
}

template <typename T, bool kTransA, int BM, int BN, int BK, int TM, int TN>
int launch_tiled(const T* a, const T* b, T* c, int64_t M, int64_t N,
                 int64_t K, cudaStream_t stream) {
  const int64_t gx = (M + BM - 1) / BM, gy = (N + BN - 1) / BN;
  if (gx > 2147483647LL || gy > 65535) return -2;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  matmul_kernel<T, kTransA, BM, BN, BK, TM, TN>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(a, b, c, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_gemv(bool trans_a, const T* a, const T* b, T* c, int64_t M,
                int64_t K, int device, cudaStream_t stream) {
  if (trans_a) {
    const int64_t blocks = (M + 31) / 32;
    if (blocks > 2147483647LL) return -2;
    gemv_cols_kernel<T><<<static_cast<unsigned>(blocks), 32 * kColWarps, 0,
                       stream>>>(a, b, c, M, K);
  } else {
    const int threads = 256;
    gemv_rows_kernel<T><<<fill_blocks(device, (M + 7) / 8, threads), threads, 0,
                       stream>>>(a, b, c, M, K);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_gemv16(bool trans_a, const T* a, const T* b, T* c, float* part,
                  const Plan& p, int64_t M, int64_t K, int device,
                  cudaStream_t stream) {
  const int threads = 256;
  if (!trans_a) {
    gemv16_rows_kernel<T><<<fill_blocks(device, (M + 7) / 8, threads),
                            threads, 0, stream>>>(a, b, c, M, K);
    return static_cast<int>(cudaGetLastError());
  }
  if (part == nullptr) return -7;
  const int64_t groups = (M + kCol16Width - 1) / kCol16Width;
  if (groups > 2147483647LL || p.splits > 65535) return -2;
  const dim3 grid(static_cast<unsigned>(groups),
                  static_cast<unsigned>(p.splits));
  gemv16_cols_kernel<T><<<grid, 32 * kCol16Warps, 0, stream>>>(a, b, part, M,
                                                               K, p.seg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gemv16_sum_kernel<T><<<fill_blocks(device, (M + threads - 1) / threads,
                                     threads),
                         threads, 0, stream>>>(part, c, M,
                                               static_cast<int>(p.splits));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kTransA>
int launch_wgmma(const T* a, const T* b, T* c, int64_t M, int64_t N,
                 int64_t K, cudaStream_t stream) {
  if (encoder() == nullptr) return -5;
  CUtensorMap ta, tb;
  const bool ok_a = kTransA ? make_map(&ta, map_type<T>(), a, M, K, kWgBK)
                            : make_map(&ta, map_type<T>(), a, K, M, kWgBM);
  if (!ok_a || !make_map(&tb, map_type<T>(), b, N, K, kWgBK)) return -6;
  const int64_t gy = (N + kWgBN - 1) / kWgBN;
  if (gy > 65535) return -2;
  cudaError_t err = cudaFuncSetAttribute(
      matmul_wgmma_kernel<T, kTransA>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((M + kWgBM - 1) / kWgBM),
                  static_cast<unsigned>(gy));
  matmul_wgmma_kernel<T, kTransA><<<grid, kWgThreads, kWgSmem, stream>>>(
      ta, tb, c, static_cast<int>(M), static_cast<int>(N),
      static_cast<int>(K));
  return static_cast<int>(cudaGetLastError());
}

template <bool kTransA>
int launch_tf32x3(const float* a, const float* b, float* c, int* flag,
                  int64_t M, int64_t N, int64_t K, int device,
                  cudaStream_t stream) {
  if (flag == nullptr) return -7;
  const int64_t gx = (M + kTfBM - 1) / kTfBM, gy = (N + kTfBN - 1) / kTfBN;
  if (gx > 2147483647LL || gy > 65535) return -2;
  cudaError_t err = cudaFuncSetAttribute(
      matmul_tf32x3_kernel<kTransA>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kTfSmem);
  if (err == cudaSuccess) err = cudaMemsetAsync(flag, 0, sizeof(int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  const int64_t na4 = M * K / 4, nb4 = K * N / 4;   // whole float4s
  nonfinite_scan_kernel<<<fill_blocks(device,
                                      ((na4 > nb4 ? na4 : nb4) + threads - 1)
                                          / threads,
                                      threads),
                          threads, 0, stream>>>(
      reinterpret_cast<const float4*>(a), na4,
      reinterpret_cast<const float4*>(b), nb4, flag);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  matmul_tf32x3_kernel<kTransA><<<grid, kTfThreads, kTfSmem, stream>>>(
      a, b, c, M, N, K, flag);
  return static_cast<int>(cudaGetLastError());
}

void use_device(int device) {
  int current = -1;
  cudaGetDevice(&current);
  if (current != device) cudaSetDevice(device);
}

template <typename T>
int matmul_typed(const Plan& p, const void* a, const void* b, void* c,
                 void* scratch, int64_t M, int64_t N, int64_t K, bool trans_a,
                 int device, cudaStream_t s) {
  const T* ap = static_cast<const T*>(a);
  const T* bp = static_cast<const T*>(b);
  T* cp = static_cast<T*>(c);
  switch (p.route) {
    case kGemv: return launch_gemv<T>(trans_a, ap, bp, cp, M, K, device, s);
    case kTiled:
      return trans_a
          ? launch_tiled<T, true, 64, 64, 16, 4, 4>(ap, bp, cp, M, N, K, s)
          : launch_tiled<T, false, 64, 64, 16, 4, 4>(ap, bp, cp, M, N, K, s);
    default: break;
  }
  if constexpr (std::is_same<T, float>::value) {
    if (p.route != kTf32x3) return -8;
    int* flag = static_cast<int*>(scratch);
    return trans_a ? launch_tf32x3<true>(ap, bp, cp, flag, M, N, K, device, s)
                   : launch_tf32x3<false>(ap, bp, cp, flag, M, N, K, device,
                                          s);
  } else {
    if (p.route == kGemv16)
      return launch_gemv16<T>(trans_a, ap, bp, cp,
                              static_cast<float*>(scratch), p, M, K, device,
                              s);
    if (p.route != kWgmma) return -8;
    return trans_a ? launch_wgmma<T, true>(ap, bp, cp, M, N, K, s)
                   : launch_wgmma<T, false>(ap, bp, cp, M, N, K, s);
  }
}

template <typename T>
int margin_typed(const void* s, const void* y, void* v, int64_t n, int device,
                 cudaStream_t stream) {
  const int threads = 256;
  margin_kernel<T><<<fill_blocks(device, (n + threads - 1) / threads,
                                 threads),
                     threads, 0, stream>>>(static_cast<const T*>(s),
                                           static_cast<const T*>(y),
                                           static_cast<T*>(v), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The design logreg_matmul takes for these operands (0 tiled, 1 gemv,
// 2 gemv16, 3 wgmma, 4 tf32x3), and in *scratch_bytes the scratch it
// needs (gemv16's X^T v: its float32 partial sums; tf32x3: a flag; else
// 0). -3 for an unknown dtype.
extern "C" int logreg_matmul_plan(const void* a, const void* b, int64_t M,
                                  int64_t N, int64_t K, int transpose_a,
                                  int dtype, int64_t* scratch_bytes) {
  if (dtype < kF32 || dtype > kF16) return -3;
  const Plan p = plan_matmul(a, b, M, N, K, transpose_a != 0, dtype);
  *scratch_bytes = p.scratch_bytes(M);
  return p.route;
}

// C (M, N) = A (M, K) B (K, N), or A^T B with A stored (K, M) when
// transpose_a != 0. All of one element type (`dtype`: 0 float32,
// 1 bfloat16, 2 float16), contiguous row-major; `scratch` holds
// logreg_matmul_plan's scratch bytes (or is null where it asks for none).
// Returns cudaGetLastError() after the launches (0: launched), -2 when
// the grid would need more blocks than CUDA allows, -3 for an unknown
// dtype, -5 when the driver has no cuTensorMapEncodeTiled, -6 when it
// refuses a tensor map, -7 when the scratch is missing.
extern "C" int logreg_matmul(const void* a, const void* b, void* c,
                             void* scratch, int64_t M, int64_t N, int64_t K,
                             int transpose_a, int dtype, int device,
                             void* stream) {
  if (M == 0 || N == 0) return 0;
  if (dtype < kF32 || dtype > kF16) return -3;
  use_device(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool t = transpose_a != 0;
  const Plan p = plan_matmul(a, b, M, N, K, t, dtype);
  switch (dtype) {
    case kF32:
      return matmul_typed<float>(p, a, b, c, scratch, M, N, K, t, device, s);
    case kBF16:
      return matmul_typed<__nv_bfloat16>(p, a, b, c, scratch, M, N, K, t,
                                         device, s);
    default:
      return matmul_typed<__half>(p, a, b, c, scratch, M, N, K, t, device, s);
  }
}

// v = -y * sigmoid(-y * s) over n elements of one element type (`dtype`
// as for logreg_matmul). Returns cudaGetLastError() after the launch (0:
// launched), -3 for an unknown dtype.
extern "C" int logreg_margin(const void* s, const void* y, void* v,
                             int64_t n, int dtype, int device, void* stream) {
  if (n == 0) return 0;
  use_device(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return margin_typed<float>(s, y, v, n, device, st);
    case kBF16: return margin_typed<__nv_bfloat16>(s, y, v, n, device, st);
    case kF16: return margin_typed<__half>(s, y, v, n, device, st);
    default: return -3;
  }
}

// The sparse logistic-regression gradient of the paper's workload (eq. 22,
// smooth part),  g = X^T ( -y * sigmoid(-y * (X w)) ) / m,  as two kernels
// of the TPU code, here four CUDA kernels:
//
//   the matmul — C = A B, or A^T B without building A^T, with an fp32
//       accumulator: gemv_rows_kernel, gemv_cols_kernel (N = 1) and
//       matmul_kernel (N > 1), behind one entry point, logreg_matmul.
//       Replaces src/repro/kernels/logreg_grad.py::matmul (Pallas body
//       _matmul_kernel);
//   margin_kernel — v = -y * sigmoid(-y * s) elementwise. Replaces
//       src/repro/kernels/logreg_grad.py::margin (Pallas body
//       _margin_kernel).
//
// The matmul. A is stored (M, K) row-major, or (K, M) when kTransA; B is
// (K, N) and C is (M, N), both row-major. Any (M, K, N) works: the ragged
// edges are bounds-checked in the tile loads (zeros past the edge) and
// the stores, so nothing is padded in device memory. The TPU kernel's
// 128x128x128 blocks and its 128-lane w / v panels are the MXU's
// formulation; here the tiles are the card's.
//
// Bound. For the gradient's two products (N = 1, X of m x d) the bound is
// memory: X is read once per pass, 4md bytes (68.72 GB at m = 2^20,
// d = 2^14: 20.5 ms at 3.35 TB/s), against 2md flops. A square product is
// bound by fp32 FFMA: 2MNK flops (2.05 ms at 4096^3 and 67 TFLOP/s).
//
// Design. The gradient's passes have N = 1 and go to two matrix-vector
// kernels; any N > 1 goes to a tiled kernel.
//   gemv_rows_kernel (X w: A stored (M, K), N = 1): one warp per output
//     row, grid-stride over rows. Lane l sums k = l, l + 32, ... in order,
//     8 coalesced 128-byte loads in flight per warp, then the 32 lane sums
//     are added by a butterfly of shuffles in a fixed order.
//   gemv_cols_kernel (X^T v: A stored (K, M), N = 1): a block owns 32
//     columns, one per lane, and its 16 warps each sum one contiguous
//     sixteenth of K in order (8 loads in flight per warp); the 16
//     partial sums are then added in warp order. The columns alone give
//     only d / 32 = 512 blocks at d = 2^14; splitting K inside the block
//     keeps ~62 warps on every SM reading without a second pass.
//   matmul_kernel<kTransA, 64, 64, 16, 4, 4> (N > 1): a block computes a
//     64 x 64 tile of C, walking K in steps of 16. It loads a 16 x 64 tile
//     of A (stored k-major in shared memory, so the transposed and the
//     plain layout are read the same way) and a 16 x 64 tile of B, each
//     load coalesced along the stored rows, then each of 256 threads
//     accumulates 4 x 4 outputs with FFMA. A thread's outputs sit 16 rows
//     and 16 columns apart, so a warp reads consecutive shared-memory
//     words (no bank conflicts; the tile rows are padded by one word for
//     the transposing stores).
// No tensor cores: the products are held against float64 with TF32 off.
//
// Every output's sum runs in an order fixed by the code (in k order
// within a thread, then the fixed combination above): no atomics and no
// split of K across blocks, so a run repeats bit for bit and the result
// does not depend on the grid. Indices are 64-bit (X at full width has
// 2^34 elements).
//
// margin_kernel reads s and y and writes v: 12 bytes an element, memory-
// bound. Grid-stride loop, 64-bit indices. sigmoid(t) = 1 / (1 + expf(-t))
// with expf (not __expf) and IEEE division, as torch.sigmoid computes it
// on the card, and every product rounded on its own, so the result is the
// plain version's bit for bit. For -y*s << 0, expf overflows to inf and
// v = -y * 0; a NaN in s or y stays NaN.
//
// Element types. Every kernel is a template on the element type T: float,
// __nv_bfloat16 or __half, one type for all operands, as the TPU kernels
// take their input's dtype. Values are widened to float on load, every sum
// and product is taken in float, and each output is rounded to T once
// (round to nearest even), as the plain versions widen and round.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

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

template <typename T, bool kTransA, int BM, int BN, int BK, int TM, int TN>
int launch_matmul(const T* a, const T* b, T* c, int64_t M, int64_t N,
                  int64_t K, cudaStream_t stream) {
  const int64_t gx = (M + BM - 1) / BM, gy = (N + BN - 1) / BN;
  if (gx > 2147483647LL || gy > 65535) return -2;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  matmul_kernel<T, kTransA, BM, BN, BK, TM, TN>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(a, b, c, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

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

void use_device(int device) {
  int current = -1;
  cudaGetDevice(&current);
  if (current != device) cudaSetDevice(device);
}

template <typename T>
int matmul_typed(const void* a, const void* b, void* c, int64_t M, int64_t N,
                 int64_t K, bool trans_a, int device, cudaStream_t s) {
  const T* ap = static_cast<const T*>(a);
  const T* bp = static_cast<const T*>(b);
  T* cp = static_cast<T*>(c);
  if (N == 1) return launch_gemv<T>(trans_a, ap, bp, cp, M, K, device, s);
  return trans_a
             ? launch_matmul<T, true, 64, 64, 16, 4, 4>(ap, bp, cp, M, N, K, s)
             : launch_matmul<T, false, 64, 64, 16, 4, 4>(ap, bp, cp, M, N, K, s);
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

// Element type codes of the entry points' `dtype` argument.
enum : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

// C (M, N) = A (M, K) B (K, N), or A^T B with A stored (K, M) when
// transpose_a != 0. All of one element type (`dtype`: 0 float32,
// 1 bfloat16, 2 float16), contiguous row-major. Returns
// cudaGetLastError() after the launch (0: launched), -2 when the grid
// would need more blocks than CUDA allows (65,535 column tiles), -3 for
// an unknown dtype.
extern "C" int logreg_matmul(const void* a, const void* b, void* c, int64_t M,
                             int64_t N, int64_t K, int transpose_a,
                             int dtype, int device, void* stream) {
  if (M == 0 || N == 0) return 0;
  use_device(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool t = transpose_a != 0;
  switch (dtype) {
    case kF32: return matmul_typed<float>(a, b, c, M, N, K, t, device, s);
    case kBF16:
      return matmul_typed<__nv_bfloat16>(a, b, c, M, N, K, t, device, s);
    case kF16: return matmul_typed<__half>(a, b, c, M, N, K, t, device, s);
    default: return -3;
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

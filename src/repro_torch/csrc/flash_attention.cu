// Flash attention (B7): out = softmax(q k^T * scale [causal mask]) v on
// (BH, S, hd), with the (S, T) scores never in device memory. Replaces
// src/repro/kernels/flash_attention.py::flash_attention_bhsd (Pallas body
// _kernel), reached from models/attention.py::_sdpa_flash once per layer of
// a full-sequence forward (Model.prefill) with attn_impl="flash".
//
// What it computes is the TPU kernel's function, not its grid:
//   s = (q . k) * scale, in float32; under causal, s = -1e30 where the key
//   index exceeds the query index (absolute positions, both from 0);
//   an online softmax over key tiles with a running max m (starting at
//   -1e30), a running denominator l and an output accumulator, all float32:
//     m' = max(m, max_j s_j); p_j = exp(s_j - m'); corr = exp(m - m');
//     l = l * corr + sum_j p_j;  acc = acc * corr + sum_j p_j v_j;
//   out = acc / max(l, 1e-30), rounded once to the input type.
// Keys past T do not exist for it (p = 0): S and T need not be multiples
// of a tile. expf, not __expf, and no fast math, as everywhere here.
//
// Work split. The TPU kernel carries m, l and acc in VMEM across the
// sequential ki axis of its (BH, S/128, T/128) grid. Hopper's blocks run in
// no order, so the loop over key tiles moves inside the block: one block
// of 256 threads owns one (bh, 64-row q tile) and walks the K/V tiles of
// 64 keys, with m, l and acc in registers. Thread (ty, tx), ty and tx in
// 0..15, owns query rows ty + 16 i (i < 4); in the score tile it computes
// keys tx + 16 j (j < 4), and in the output the columns 4 tx + 64 c + e
// (c < hd / 64, e < 4). The 16 threads that share a row sit in one half
// of a warp, so the row max and the row sum are butterflies of shuffles
// (each lane ends with the same bits: every stage adds the same two
// operands in either order).
//
// Shared memory (float, whatever the input type: loads widen once):
// Q tile (64, hd + 4) and K tile (64, hd + 4) row-major, padded by 4 words
// so that eight lanes reading 16 bytes each at rows tx + 16 j hit 32
// distinct banks; V tile (64, hd). The probabilities P (64, 64 + 4) reuse
// the K tile's space once the scores are taken. 100,352 bytes at hd = 128
// (two blocks an SM), 198,656 at hd = 256 (one): dynamic shared memory,
// above the 48 KB default, after cudaFuncSetAttribute.
//
// Causal tile skip. Under causal, key tiles wholly above the diagonal of
// the q tile are not visited. With finite inputs this changes nothing:
// the first key tile holds a valid key for every row, so m is finite from
// there on, and a wholly masked tile would add exp(-1e30 - m) = 0 with a
// correction of exactly 1. It halves the work at S = T. The heaviest q
// tiles (the last ones) are scheduled first.
//
// Bound. At the prefill's (BH, S, hd) = (64, 4096, 128) float32, causal,
// the function moves q, k, v and out once, 0.54 GB (0.16 ms at 3.35 TB/s),
// and does 2 * 2 * hd * BH * S (S + 1) / 2 = 0.275 TFLOP of multiply-adds
// in the two products (4.1 ms at 67 TFLOP/s of float32 FFMA): it is bound
// by operations. This first version does every product with FFMA in float32
// from shared memory (each thread reads 16-byte vectors: 8 loads for 64
// FMAs in q k^T, 12 for 128 in p v); the tensor cores (mma.sync / wgmma on
// bf16, TMA staging of the tiles, a pipeline of K/V tiles) are the next
// step.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kPad = 4;          // words of padding per Q / K / P row
constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

// four consecutive elements, widened to float (16-byte aligned for float,
// 8-byte for the 16-bit types: hd is a multiple of 128 and the column a
// multiple of 4)
__device__ __forceinline__ void load4(const float* p, float (&out)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&out)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}
__device__ __forceinline__ void load4(const __half* p, float (&out)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&raw.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&raw.y));
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}

// four consecutive elements, each rounded once (to nearest even)
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<unsigned*>(&a);
  raw.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}
__device__ __forceinline__ void store4(__half* p, const float (&v)[4]) {
  __half2 a = __floats2half2_rn(v[0], v[1]);
  __half2 b = __floats2half2_rn(v[2], v[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<unsigned*>(&a);
  raw.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

// rows [row0, row0 + 64) of a (rows, HD) matrix into a float tile of row
// stride `stride`; rows at or past `rows` are zeros
template <typename T, int HD>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          int64_t row0, int64_t rows,
                                          float* __restrict__ dst,
                                          int stride) {
  constexpr int kChunks = 64 * HD / 4;     // 4-element chunks in the tile
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    const int r = c / (HD / 4), col = (c % (HD / 4)) * 4;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < rows) load4(src + (row0 + r) * HD + col, v);
    *reinterpret_cast<float4*>(dst + r * stride + col) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, HD <= 128 ? 2 : 1)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int64_t S,
                 int64_t Tk, float scale, int causal) {
  constexpr int kQS = HD + kPad;           // Q / K tile row stride
  constexpr int kPS = kBK + kPad;          // P tile row stride
  constexpr int kC = HD / 64;              // 4-column groups per thread
  static_assert(kBQ * kPS <= kBK * kQS, "P fits in the K tile's space");
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * kQS;
  float* Vs = Ks + kBK * kQS;
  float* Ps = Ks;                          // P reuses K's space

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t bh = blockIdx.y;
  // the heaviest q tiles (most key tiles under causal) first
  const int64_t q0 = (static_cast<int64_t>(gridDim.x) - 1 - blockIdx.x) * kBQ;
  const T* qb = q + bh * S * HD;
  const T* kb = k + bh * Tk * HD;
  const T* vb = v + bh * Tk * HD;

  const int64_t q_last = (q0 + kBQ < S ? q0 + kBQ : S) - 1;
  int64_t n_tiles = (Tk + kBK - 1) / kBK;
  if (causal) {
    const int64_t visible = q_last / kBK + 1;   // tiles holding key <= q_last
    if (visible < n_tiles) n_tiles = visible;
  }

  float m[4], l[4], acc[4][kC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  load_tile<T, HD>(qb, q0, S, Qs, kQS);

  for (int64_t t = 0; t < n_tiles; ++t) {
    const int64_t k0 = t * kBK;
    __syncthreads();     // the last tile's P and V are read
    load_tile<T, HD>(kb, k0, Tk, Ks, kQS);
    load_tile<T, HD>(vb, k0, Tk, Vs, HD);
    __syncthreads();

    // scores: s[i][j] = q[row i] . k[key j], summed in d order
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * kQS + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * kQS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // scale, mask, and the online softmax's statistics for each row
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t key = k0 + tx + 16 * j;
        float x = __fmul_rn(s[i][j], scale);
        if (causal && key > row) x = kNegInf;
        if (key >= Tk) x = -INFINITY;            // no such key
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t key = k0 + tx + 16 * j;
        const float p = key < Tk ? expf(__fsub_rn(s[i][j], m_new)) : 0.f;
        s[i][j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(kFullMask, sum, off);
      corr[i] = expf(__fsub_rn(m[i], m_new));
      l[i] = l[i] * corr[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= corr[i];
    }

    __syncthreads();     // every thread has read the K tile
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty + 16 * i) * kPS + tx + 16 * j] = s[i][j];
    __syncthreads();

    // acc[row][col] += sum over the tile's keys of p[row][key] v[key][col]
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * kPS + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float4 vv[kC];
#pragma unroll
        for (int c = 0; c < kC; ++c)
          vv[c] = *reinterpret_cast<const float4*>(
              Vs + (kk + u) * HD + 4 * tx + 64 * c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y
                        : u == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            acc[i][c][0] = fmaf(p, vv[c].x, acc[i][c][0]);
            acc[i][c][1] = fmaf(p, vv[c].y, acc[i][c][1]);
            acc[i][c][2] = fmaf(p, vv[c].z, acc[i][c][2]);
            acc[i][c][3] = fmaf(p, vv[c].w, acc[i][c][3]);
          }
        }
      }
    }
  }

  // out = acc / max(l, 1e-30), rounded once
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + (bh * S + row) * HD;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      float out[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) out[e] = __fdiv_rn(acc[i][c][e], denom);
      store4(orow + 4 * tx + 64 * c, out);
    }
  }
}

template <int HD>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(float)) *
         (kBQ * (HD + kPad) + kBK * (HD + kPad) + kBK * HD);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int64_t BH,
           int64_t S, int64_t Tk, float scale, int causal,
           cudaStream_t stream) {
  const int64_t q_tiles = (S + kBQ - 1) / kBQ;
  if (BH > 65535 || q_tiles > 2147483647LL) return -2;
  constexpr int bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(q_tiles), static_cast<unsigned>(BH));
  flash_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Tk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, void* o,
                 int64_t BH, int64_t S, int64_t Tk, int64_t hd, float scale,
                 int causal, cudaStream_t stream) {
  switch (hd) {
    case 128: return launch<T, 128>(q, k, v, o, BH, S, Tk, scale, causal, stream);
    case 256: return launch<T, 256>(q, k, v, o, BH, S, Tk, scale, causal, stream);
    default: return -4;
  }
}

void use_device(int device) {
  int current = -1;
  cudaGetDevice(&current);
  if (current != device) cudaSetDevice(device);
}

}  // namespace

// out (BH, S, hd) = attention of q (BH, S, hd) over k, v (BH, T, hd), all
// contiguous and of one element type (`dtype`: 0 float32, 1 bfloat16,
// 2 float16); `causal` != 0 masks keys past the query's index. hd is 128
// or 256. Returns cudaGetLastError() after the launch (0: launched), -2
// when the grid would need more blocks than CUDA allows (BH > 65,535), -3
// for an unknown dtype, -4 for another hd.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int64_t BH, int64_t S, int64_t T,
                               int64_t hd, float scale, int causal, int dtype,
                               int device, void* stream) {
  if (BH == 0 || S == 0) return 0;
  use_device(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_typed<float>(q, k, v, o, BH, S, T, hd, scale, causal, s);
    case 1:
      return launch_typed<__nv_bfloat16>(q, k, v, o, BH, S, T, hd, scale,
                                         causal, s);
    case 2: return launch_typed<__half>(q, k, v, o, BH, S, T, hd, scale, causal, s);
    default: return -3;
  }
}

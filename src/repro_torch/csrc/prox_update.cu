// AsyBADMM server update, eq. (13), in two kernels that share one prox
// tail (so the two server routes round the same way):
//
//   server_prox_kernel     — the edge-masked reduction of the stale-w cache
//                            over workers and the prox, fused. Replaces
//                            src/repro/kernels/prox_update.py::
//                            server_prox_fused_2d (Pallas body _fused_kernel);
//   prox_consensus_kernel  — the prox from a w_sum that is already reduced
//                            (the SPMD server step: partial worker sum plus
//                            an all-reduce over the data ranks). Replaces
//                            src/repro/kernels/prox_update.py::
//                            prox_consensus_2d (Pallas body _kernel).
//
// For every element (m, c) of the (M, d) output:
//   s   = sum over n = 0..N-1 in order of w_cache[n, m, c] where edge[n, m]
//         (server_prox_kernel), or w_sum[m, c] (prox_consensus_kernel)
//   mu  = gamma + rho_sum[m]
//   v   = (gamma * z[m, c] + s) / mu
//   v   = sign(v) * max(|v| - l1 / mu, 0)      if l1 > 0
//   v   = min(max(v, -clip), clip)             if clip > 0
//
// Bound: memory bytes, for both. server_prox_kernel reads w_cache (N
// bundles of M*d) and z and writes z': (N + 2) * M * d * 4 bytes, 0.81 GB
// at N=8, M=64, d=315,904 (the epoch), 12.6 MB on one column (N=8, M=1:
// the PS runtime's block commit, 3.77 us at 3.35 TB/s). prox_consensus_
// kernel reads z and w_sum and writes z': 3 * M * d * 4 bytes, 0.24 GB at
// M=64, d=315,904. Both do a handful of flops per element.
//
// Design for that bound: one thread per float4 of the output (grid-stride,
// 64-bit indices) and 16-byte accesses. In server_prox_kernel the sum over
// workers is kept in registers, so the (M, d) w_sum never reaches device
// memory — the point of the TPU kernel's in-grid accumulation. On one
// column (78,976 float4s: fewer threads than the card holds, one float4
// each) the time is a launch plus the chain of memory latencies a thread
// waits through, so the kernel shortens the chain: a thread first sends
// its z and rho_sum loads and reads its block's edge column once, as a
// bit mask (64 workers at a time); then the predicated 16-byte loads of
// kGroup workers' rows ahead of their adds, where the loop it replaces
// loaded z after the sum and branched on each worker's edge before that
// worker's load. The adds run in the order n = 0..N-1, each behind its
// own edge bit, so the sum and every rounding are the same for any N,
// any grid and any M: no atomics, no split over N. Rows off the edge set
// are never read. The grid is what the card holds at once (the occupancy
// API at kServerThreads a block, launch-bounded to 8 such blocks an SM),
// or fewer blocks when the output needs fewer threads.
//
// Numerics: no fast math; IEEE divisions, gamma*z rounded before the add
// (no FMA contraction), and the soft threshold and clip written with
// explicit comparisons so that a NaN passes through as it does through
// jnp.maximum / jnp.clip (fmaxf / fminf would drop it and hide a diverged
// block from the finite-check watchdog).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// workers whose rows a thread loads before it adds them
constexpr int kGroup = 8;
constexpr int kServerThreads = 128;

__device__ __forceinline__ float prox_tail(float z, float s, float gamma,
                                           float mu, float l1, float clip) {
  float v = __fdiv_rn(__fadd_rn(__fmul_rn(gamma, z), s), mu);
  if (l1 > 0.f) {
    float shrunk = fabsf(v) - __fdiv_rn(l1, mu);
    shrunk = (shrunk < 0.f) ? 0.f : shrunk;               // NaN stays NaN
    const float sign = (v > 0.f) ? 1.f : ((v < 0.f) ? -1.f : v);
    v = sign * shrunk;
  }
  if (clip > 0.f) {
    v = (v < -clip) ? -clip : v;                          // NaN stays NaN
    v = (v > clip) ? clip : v;
  }
  return v;
}

// bit k set where edge[k * M] (k < count <= 64)
__device__ __forceinline__ uint64_t edge_bits(const uint8_t* __restrict__ e,
                                              int64_t M, int count) {
  uint64_t bits = 0;
  for (int k = 0; k < count; ++k)
    bits |= static_cast<uint64_t>(__ldg(e + k * M) != 0) << k;
  return bits;
}

__global__ void __launch_bounds__(kServerThreads, 8)
server_prox_kernel(const float4* __restrict__ z,
                   const float4* __restrict__ w_cache,
                   const uint8_t* __restrict__ edge,
                   const float* __restrict__ rho_sum,
                   float4* __restrict__ z_out, int64_t N, int64_t M,
                   int64_t d4, float gamma, float l1, float clip) {
  const int64_t total = M * d4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int64_t m = i / d4;
    const float mu = gamma + __ldg(rho_sum + m);
    const float4 zv = __ldg(z + i);
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int64_t n0 = 0; n0 < N; n0 += 64) {
      const int count = static_cast<int>(N - n0 < 64 ? N - n0 : 64);
      const uint64_t mask = edge_bits(edge + n0 * M + m, M, count);
      const float4* w = w_cache + n0 * total + i;
      for (int g = 0; g < count; g += kGroup) {
        const unsigned bits = static_cast<unsigned>(mask >> g) & 0xffu;
        float4 v[kGroup];
#pragma unroll
        for (int k = 0; k < kGroup; ++k)              // all loads first
          v[k] = (bits >> k & 1u) ? __ldg(w + (g + k) * total)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {            // then n in order
          if (bits >> k & 1u) {
            s.x += v[k].x;
            s.y += v[k].y;
            s.z += v[k].z;
            s.w += v[k].w;
          }
        }
      }
    }
    float4 out;
    out.x = prox_tail(zv.x, s.x, gamma, mu, l1, clip);
    out.y = prox_tail(zv.y, s.y, gamma, mu, l1, clip);
    out.z = prox_tail(zv.z, s.z, gamma, mu, l1, clip);
    out.w = prox_tail(zv.w, s.w, gamma, mu, l1, clip);
    z_out[i] = out;
  }
}

__global__ void prox_consensus_kernel(const float4* __restrict__ z,
                                      const float4* __restrict__ w_sum,
                                      const float* __restrict__ rho_sum,
                                      float4* __restrict__ z_out, int64_t M,
                                      int64_t d4, float gamma, float l1,
                                      float clip) {
  const int64_t total = M * d4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const float mu = gamma + rho_sum[i / d4];
    const float4 zv = z[i];
    const float4 s = w_sum[i];
    float4 out;
    out.x = prox_tail(zv.x, s.x, gamma, mu, l1, clip);
    out.y = prox_tail(zv.y, s.y, gamma, mu, l1, clip);
    out.z = prox_tail(zv.z, s.z, gamma, mu, l1, clip);
    out.w = prox_tail(zv.w, s.w, gamma, mu, l1, clip);
    z_out[i] = out;
  }
}

int sm_count(int device) {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return sms > 0 ? sms : 1;
}

// `per_sm` blocks on every SM, or fewer when `total` needs fewer; the
// grid-stride loop covers the rest.
int grid_blocks(int device, int64_t total, int threads, int per_sm) {
  const int64_t need = (total + threads - 1) / threads;
  const int64_t full = static_cast<int64_t>(sm_count(device)) * per_sm;
  return static_cast<int>(need < full ? need : full);
}

}  // namespace

// Returns cudaGetLastError() after the launch; 0 means launched.
extern "C" int server_prox_update(const void* z, const void* w_cache,
                                  const void* edge, const void* rho_sum,
                                  void* z_out, int64_t N, int64_t M,
                                  int64_t d, float gamma, float l1,
                                  float clip, int device, void* stream) {
  const int64_t d4 = d / 4;
  const int64_t total = M * d4;
  if (total == 0) return 0;
  int current = -1;
  cudaGetDevice(&current);
  if (current != device) cudaSetDevice(device);
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, server_prox_kernel,
                                                kServerThreads, 0);
  server_prox_kernel<<<grid_blocks(device, total, kServerThreads,
                                   per_sm > 0 ? per_sm : 1),
                       kServerThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(z), static_cast<const float4*>(w_cache),
      static_cast<const uint8_t*>(edge), static_cast<const float*>(rho_sum),
      static_cast<float4*>(z_out), N, M, d4, gamma, l1, clip);
  return static_cast<int>(cudaGetLastError());
}

// Returns cudaGetLastError() after the launch; 0 means launched.
extern "C" int prox_consensus(const void* z, const void* w_sum,
                              const void* rho_sum, void* z_out, int64_t M,
                              int64_t d, float gamma, float l1, float clip,
                              int device, void* stream) {
  const int64_t d4 = d / 4;
  const int64_t total = M * d4;
  if (total == 0) return 0;
  int current = -1;
  cudaGetDevice(&current);
  if (current != device) cudaSetDevice(device);
  const int threads = 256;
  prox_consensus_kernel<<<grid_blocks(device, total, threads,
                                      2048 / threads),
                          threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(z), static_cast<const float4*>(w_sum),
      static_cast<const float*>(rho_sum), static_cast<float4*>(z_out), M, d4,
      gamma, l1, clip);
  return static_cast<int>(cudaGetLastError());
}

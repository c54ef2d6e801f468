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
// at N=8, M=64, d=315,904. prox_consensus_kernel reads z and w_sum and
// writes z': 3 * M * d * 4 bytes, 0.24 GB at M=64, d=315,904. Both do a
// handful of flops per element.
//
// Design for that bound: one thread per float4 of the output (grid-stride,
// 64-bit indices) and 16-byte accesses. In server_prox_kernel the sum over
// workers is kept in registers, so the (M, d) w_sum never reaches device
// memory — the point of the TPU kernel's in-grid accumulation. The worker
// loop runs in a fixed order with no atomics and no split over N, so the
// result does not depend on the launch shape. Rows off the edge set are
// never read.
//
// Numerics: no fast math; IEEE divisions, gamma*z rounded before the add
// (no FMA contraction), and the soft threshold and clip written with
// explicit comparisons so that a NaN passes through as it does through
// jnp.maximum / jnp.clip (fmaxf / fminf would drop it and hide a diverged
// block from the finite-check watchdog).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

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

__global__ void server_prox_kernel(const float4* __restrict__ z,
                                   const float4* __restrict__ w_cache,
                                   const uint8_t* __restrict__ edge,
                                   const float* __restrict__ rho_sum,
                                   float4* __restrict__ z_out, int64_t N,
                                   int64_t M, int64_t d4, float gamma,
                                   float l1, float clip) {
  const int64_t total = M * d4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int64_t m = i / d4;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int64_t n = 0; n < N; ++n) {
      if (edge[n * M + m]) {
        const float4 w = w_cache[n * total + i];
        s.x += w.x;
        s.y += w.y;
        s.z += w.z;
        s.w += w.w;
      }
    }
    const float mu = gamma + rho_sum[m];
    const float4 zv = z[i];
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

// Enough blocks to fill every SM at full occupancy; the grid-stride loop
// covers the rest.
int grid_blocks(int device, int64_t total, int threads) {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (sms <= 0) sms = 1;
  const int64_t need = (total + threads - 1) / threads;
  const int64_t full = static_cast<int64_t>(sms) * (2048 / threads);
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
  const int threads = 256;
  server_prox_kernel<<<grid_blocks(device, total, threads), threads, 0,
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
  prox_consensus_kernel<<<grid_blocks(device, total, threads), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(z), static_cast<const float4*>(w_sum),
      static_cast<const float*>(rho_sum), static_cast<float4*>(z_out), M, d4,
      gamma, l1, clip);
  return static_cast<int>(cudaGetLastError());
}

// AsyBADMM worker update, eqs. (11)+(12)+(9), in two kernels that share
// one update() helper (so both round as the plain torch versions do):
//
//   worker_select_update_kernel — with Algorithm 1's sel-masked merges of
//       y / w_cache / x, one pass over the (N, M, d) worker bundles.
//       Replaces src/repro/kernels/admm_update.py::
//       admm_worker_select_update_3d (Pallas body _kernel_3d);
//   worker_update_kernel — the unmasked update over a flat buffer with a
//       scalar rho, returning (x, y', w), in f32 or bf16. Replaces
//       src/repro/kernels/admm_update.py::admm_worker_update_2d (Pallas
//       body _kernel_2d).
//
// worker_select_update_kernel, for every row r = (n, m) of the bundles:
//   selected:   x = z~ - (g + y) / rho[n],  y' = -g,  w = rho[n] * x + y'
//   unselected: y' = y, w = w_old, x = x_old  (a copy)
//
// Bound: memory bytes. About 5 flops per element against 32 bytes moved
// (with x), far below the card's flops-per-byte balance. A call must read
// y everywhere, w_old and x_old on unselected rows only, g and z~ on
// selected rows only, and write the three outputs: 6 fp32 bundles, 3.88
// GB at N=8, M=64, d=315,904 (the paper's KDDa width), whatever the
// share of selected rows (without x: 4 bundles and the selected rows).
//
// Design for that bound: a grid-stride loop over the N*M*d/4 float4s with
// 64-bit indices (N*M*d passes 2^31 for more workers), 16-byte loads and
// stores only, and a row branch that skips the g and z~ reads where the
// row is not selected. d % 128 == 0 keeps every warp inside one row, so
// the branch never diverges within a warp. The kernel allocates nothing
// and launches on the caller's stream. The launch (threads a block,
// blocks an SM) is 256 and 8 by default, or what the autotuner
// (kernels/autotune.py) picked for the shape on this card: each element
// is one thread's, computed in one order, so every launch gives the same
// bits.
//
// worker_update_kernel reads g, y, z~ and writes x, y', w: 6 buffers of
// n elements, 24n bytes in f32 (3.88 GB for the (8, 64, 315,904) worker
// bundle), 12n in bf16 — memory-bound the same way. One thread per
// 16-byte vector (4 floats or 8 bf16) in a grid-stride loop with 64-bit
// indices; the buffer's element count is a multiple of 8*128 (the
// reference's vreg contract), so there is no ragged tail. rho is read
// from device memory, so a new rho is a new value, not a new launch
// configuration, and the host never waits for the card to learn it.
//
// Numerics: no fast math. The division is IEEE (__fdiv_rn) and rho*x and
// the add are rounded separately (__fmul_rn/__fadd_rn), so the compiler
// contracts nothing into an FMA and the result equals the plain torch
// version (two separately rounded operations) bit for bit. bf16 inputs
// are widened to f32, computed as f32, and each output is rounded to
// bf16 once (round to nearest even), as the plain version does.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void update(float g, float y, float zt, float rho,
                                       float& x, float& y_new, float& w) {
  x = zt - __fdiv_rn(g + y, rho);
  y_new = -g;
  w = __fadd_rn(__fmul_rn(rho, x), y_new);
}

template <bool kWithX>
__global__ void worker_select_update_kernel(
    const float4* __restrict__ g, const float4* __restrict__ y,
    const float4* __restrict__ zt, const float4* __restrict__ w_old,
    const float4* __restrict__ x_old, const uint8_t* __restrict__ sel,
    const float* __restrict__ rho, float4* __restrict__ y_out,
    float4* __restrict__ w_out, float4* __restrict__ x_out, int64_t M,
    int64_t d4, int64_t total) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int64_t row = i / d4;
    const float4 yv = y[i];
    if (sel[row]) {
      const float r = rho[row / M];
      const float4 gv = g[i];
      const float4 zv = zt[i];
      float4 xn, yn, wn;
      update(gv.x, yv.x, zv.x, r, xn.x, yn.x, wn.x);
      update(gv.y, yv.y, zv.y, r, xn.y, yn.y, wn.y);
      update(gv.z, yv.z, zv.z, r, xn.z, yn.z, wn.z);
      update(gv.w, yv.w, zv.w, r, xn.w, yn.w, wn.w);
      y_out[i] = yn;
      w_out[i] = wn;
      if (kWithX) x_out[i] = xn;
    } else {
      y_out[i] = yv;
      w_out[i] = w_old[i];
      if (kWithX) x_out[i] = x_old[i];
    }
  }
}

// 16 bytes of T as f32 lanes, and back (bf16 rounded to nearest even).
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  using Vec = float4;
  static constexpr int kLanes = 4;
  static __device__ __forceinline__ void load(const Vec& v, float* f) {
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  static __device__ __forceinline__ Vec store(const float* f) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Pack<__nv_bfloat16> {
  using Vec = uint4;
  static constexpr int kLanes = 8;
  static __device__ __forceinline__ void load(const Vec& v, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 p = __bfloat1622float2(h[j]);
      f[2 * j] = p.x;
      f[2 * j + 1] = p.y;
    }
  }
  static __device__ __forceinline__ Vec store(const float* f) {
    Vec v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
    return v;
  }
};

template <typename T>
__global__ void worker_update_kernel(
    const typename Pack<T>::Vec* __restrict__ g,
    const typename Pack<T>::Vec* __restrict__ y,
    const typename Pack<T>::Vec* __restrict__ zt,
    const float* __restrict__ rho, typename Pack<T>::Vec* __restrict__ x_out,
    typename Pack<T>::Vec* __restrict__ y_out,
    typename Pack<T>::Vec* __restrict__ w_out, int64_t total) {
  constexpr int L = Pack<T>::kLanes;
  const float r = *rho;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    float gf[L], yf[L], zf[L], xo[L], yo[L], wo[L];
    Pack<T>::load(g[i], gf);
    Pack<T>::load(y[i], yf);
    Pack<T>::load(zt[i], zf);
#pragma unroll
    for (int j = 0; j < L; ++j) update(gf[j], yf[j], zf[j], r, xo[j], yo[j], wo[j]);
    x_out[i] = Pack<T>::store(xo);
    y_out[i] = Pack<T>::store(yo);
    w_out[i] = Pack<T>::store(wo);
  }
}

// `per_sm` blocks on every SM (by default enough to fill every SM at full
// occupancy), or fewer when `total` needs fewer; the grid-stride loop
// covers the rest.
int grid_blocks(int device, int64_t total, int threads, int per_sm = 0) {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (sms <= 0) sms = 1;
  if (per_sm <= 0) per_sm = 2048 / threads;
  const int64_t need = (total + threads - 1) / threads;
  const int64_t full = static_cast<int64_t>(sms) * per_sm;
  return static_cast<int>(need < full ? need : full);
}

// The launches the autotuner may pick: threads a block in {128, 256, 512,
// 1024}, at least one block an SM.
bool valid_launch(int threads, int blocks_per_sm) {
  return (threads == 128 || threads == 256 || threads == 512 ||
          threads == 1024) && blocks_per_sm >= 1;
}

template <typename T>
int launch_worker_update(const void* g, const void* y, const void* z_tilde,
                         const void* rho, void* x_out, void* y_out,
                         void* w_out, int64_t n, int device, void* stream) {
  using Vec = typename Pack<T>::Vec;
  const int64_t total = n / Pack<T>::kLanes;
  if (total == 0) return 0;
  int current = -1;
  cudaGetDevice(&current);
  if (current != device) cudaSetDevice(device);
  const int threads = 256;
  const int blocks = grid_blocks(device, total, threads);
  worker_update_kernel<T><<<blocks, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Vec*>(g), static_cast<const Vec*>(y),
      static_cast<const Vec*>(z_tilde), static_cast<const float*>(rho),
      static_cast<Vec*>(x_out), static_cast<Vec*>(y_out),
      static_cast<Vec*>(w_out), total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_old and x_out are both null (no x tracked) or both non-null. The
// launch is `threads` a block and `blocks_per_sm` blocks an SM (the
// autotuner's choice), or with threads == 0 the default: 256 threads and
// 2048 / 256 blocks an SM. Every launch computes each element in one
// thread, in one order, so the outputs are the same bits for all of them.
// Returns cudaGetLastError() after the launch; 0 means launched.
extern "C" int admm_worker_select_update(
    const void* g, const void* y, const void* z_tilde, const void* w_old,
    const void* x_old, const void* sel, const void* rho, void* y_out,
    void* w_out, void* x_out, int64_t N, int64_t M, int64_t d,
    int threads, int blocks_per_sm, int device, void* stream) {
  if (threads != 0 && !valid_launch(threads, blocks_per_sm))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t d4 = d / 4;
  const int64_t total = N * M * d4;
  if (total == 0) return 0;
  int current = -1;
  cudaGetDevice(&current);
  if (current != device) cudaSetDevice(device);
  if (threads == 0) {
    threads = 256;
    blocks_per_sm = 0;
  }
  const int blocks = grid_blocks(device, total, threads, blocks_per_sm);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* gp = static_cast<const float4*>(g);
  const float4* yp = static_cast<const float4*>(y);
  const float4* zp = static_cast<const float4*>(z_tilde);
  const float4* wp = static_cast<const float4*>(w_old);
  const uint8_t* sp = static_cast<const uint8_t*>(sel);
  const float* rp = static_cast<const float*>(rho);
  float4* yo = static_cast<float4*>(y_out);
  float4* wo = static_cast<float4*>(w_out);
  if (x_old != nullptr) {
    worker_select_update_kernel<true><<<blocks, threads, 0, s>>>(
        gp, yp, zp, wp, static_cast<const float4*>(x_old), sp, rp, yo, wo,
        static_cast<float4*>(x_out), M, d4, total);
  } else {
    worker_select_update_kernel<false><<<blocks, threads, 0, s>>>(
        gp, yp, zp, wp, nullptr, sp, rp, yo, wo, nullptr, M, d4, total);
  }
  return static_cast<int>(cudaGetLastError());
}

// The unmasked update over n elements (n % 8 == 0; every pointer 16-byte
// aligned). dtype 0 is f32, 1 is bf16; rho is one f32 on the device.
// Returns cudaGetLastError() after the launch; 0 means launched, -1 an
// unknown dtype.
extern "C" int admm_worker_update(const void* g, const void* y,
                                  const void* z_tilde, const void* rho,
                                  void* x_out, void* y_out, void* w_out,
                                  int64_t n, int dtype, int device,
                                  void* stream) {
  if (dtype == 0)
    return launch_worker_update<float>(g, y, z_tilde, rho, x_out, y_out,
                                       w_out, n, device, stream);
  if (dtype == 1)
    return launch_worker_update<__nv_bfloat16>(g, y, z_tilde, rho, x_out,
                                               y_out, w_out, n, device,
                                               stream);
  return -1;
}

// The most blocks of `threads` an SM holds at once of the select update
// (with or without x): the autotuner's largest candidate. 0 on an error.
extern "C" int admm_worker_select_update_occupancy(int threads, int with_x,
                                                   int device) {
  int current = -1;
  cudaGetDevice(&current);
  if (current != device) cudaSetDevice(device);
  int per_sm = 0;
  const cudaError_t err =
      with_x ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &per_sm, worker_select_update_kernel<true>, threads, 0)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &per_sm, worker_select_update_kernel<false>, threads, 0);
  return err == cudaSuccess ? per_sm : 0;
}

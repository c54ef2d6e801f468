// Flash attention (B7): out = softmax(q k^T * scale [causal mask]) v on
// (BH, S, hd), with the (S, T) scores never in device memory. Replaces
// src/repro/kernels/flash_attention.py::flash_attention_bhsd (Pallas body
// _kernel), reached from models/attention.py::_sdpa_flash once per layer of
// a full-sequence forward (Model.prefill) with attn_impl="flash".
//
// What it computes is the TPU kernel's function, not its grid:
//   s = (q . k) * scale; under causal, s = -1e30 where the key index
//   exceeds the query index (absolute positions, both from 0); an online
//   softmax over key tiles with a running max m (starting at -1e30), a
//   running denominator l and an output accumulator, all float32:
//     m' = max(m, max_j s_j); p_j = exp(s_j - m'); corr = exp(m - m');
//     l = l * corr + sum_j p_j;  acc = acc * corr + sum_j p_j v_j;
//   out = acc / max(l, 1e-30), rounded once to the input type.
// Keys past T do not exist for it (p = 0): S and T need not be multiples
// of a tile. The exponentials are MUFU.EX2 (ex2.approx.ftz, 2 ulp) of the
// scores times scale * log2(e), folded into one float constant; no fast
// math, as everywhere here. That moves bits against the plain version
// (expf of s * scale), so the kernel is held to float64 attention by B5's
// rule, not to the plain version's bits.
//
// Work split. The TPU kernel carries m, l and acc in VMEM across the
// sequential ki axis of its (BH, S/128, T/128) grid. Hopper's blocks run in
// no order, so the loop over key tiles moves inside the block: one block
// owns one (bh, q tile) and walks the K/V tiles, with m, l and acc in
// registers. Under causal, key tiles wholly above the diagonal of the q
// tile are not visited, and only the tiles that cross the diagonal (or
// hold the end of T) compare indices; the heaviest q tiles (the last
// ones) are scheduled first. With finite inputs the skip changes nothing:
// the first key tile holds a valid key for every row, so m is finite from
// there on, and a wholly masked tile would add exp(-1e30 - m) = 0 with a
// correction of exactly 1. No atomics: a repeated call is bitwise equal.
//
// Two designs, by element type (the dtype picks the instantiation):
//
// bf16 / f16: wgmma + TMA (flash_wgmma_kernel). 384 threads: two consumer
// warpgroups of 64 q rows each (a 128-row q tile) and a producer
// warpgroup, which gives its registers to the consumers (setmaxnreg: 40
// and 232). One producer thread loads the Q tile once and the K and V
// tiles into rings of three stages (two at hd 256) by TMA (3-D tensor maps
// over (hd, rows, BH), so rows past S or T of a head read as zeros;
// 128-byte swizzle, 64-column boxes); K and V have full and empty
// mbarriers of their own, so a K stage is free as soon as its scores are
// taken. S = Q K^T is wgmma m64n{BK}k16 with Q and K (K-major) from shared
// memory; P is rounded to the 16-bit type in registers and O += P V is
// wgmma m64n{hd}k16 with P from registers and V from shared memory
// (MN-major: the transpose bit). A warpgroup issues the scores of tile t
// together with P V of tile t - 1 and runs the softmax of t while that
// product is on the tensor cores; O is rescaled once it has landed. The
// two warpgroups take turns at issuing (named barriers), so one's softmax
// runs under the other's products. m, l and O stay float32 in registers;
// the online softmax runs on the accumulator's fragment layout (a row's
// four lanes reduce by shuffles). Rounding P before P V is what the
// model's naive path does (probs .to(v.dtype)); l sums the unrounded p.
// hd 128: 128-key tiles, 224 KB of shared memory; hd 256: 64-key tiles,
// 192 KB; one block an SM.
//
// float32: 3xTF32 on mma.sync.m16n8k8 (flash_tf32_kernel). Each operand
// x splits in registers into hi = cvt.rna.tf32(x) and lo =
// cvt.rna.tf32(x - hi), and a product is lo*hi + hi*lo + hi*hi with
// float32 accumulation: float32 accuracy on the tensor cores (one pass of
// TF32 would fail the float64 gate, which refuses TF32-rounded inputs).
// Each k8 step's three products go to a fresh tensor-core accumulator
// that is added in float32: the tensor core's accumulation truncates, and
// carried over all steps its error would pass the gate. A non-finite x
// of K or V has lo = 0, and the cross term lo(a) hi(b) reads that hi as
// 0: x - hi is NaN for x = Inf, and 0 * Inf in a cross term (a p whose
// lo is 0 against an Inf in v) would turn the plain version's Inf into
// NaN. Q and P need no guard: a non-finite q or p makes its row NaN or
// infinite in the plain version as well. 128 threads: four warps of 16 q rows (a
// 64-row q tile), K/V tiles of 32 keys by cp.async into a two-stage ring,
// row stride hd + 4 words (conflict-free fragment loads). P stays in the
// score accumulator's registers: its columns are permuted within each
// 8-key step (key 2t -> k t, 2t + 1 -> t + 4), and V's rows the same way,
// so no shuffle is needed. 101 KB of shared memory at hd 128 (two blocks
// an SM), 195 KB at hd 256. It is bound by instruction issue, not by the
// tensor cores: each warp splits every K and V element it reads (about
// ten instructions each), with one or two warps a scheduler to hide the
// latencies (the numbers are in PERF.md).
//
// Bound. At the prefill's (BH, S, hd) = (64, 4096, 128), causal, the two
// products are 2 * 2 * hd * BH * S (S + 1) / 2 = 0.275 TFLOP:
//   bf16 / f16: 0.28 ms on the tensor cores at 989 TFLOP/s; the 5.4e8
//     exponentials (0.15 ms at MUFU's rate) and the 0.27 GB moved
//     (0.08 ms at 3.35 TB/s) lie under it;
//   float32: 1.67 ms: 3xTF32 runs three TF32 products, a third of 495
//     TFLOP/s (FFMA's 67 TFLOP/s would take 4.10 ms).

#include <cmath>
#include <cstdint>
#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;           // the causal mask's value
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 2^x as MUFU.EX2 (2 ulp). Results below 2^-126 flush to zero: a
// probability that small is invisible next to its row's largest term, 1
// (2^-126 against float32's 2^-24 resolution of the sums it enters).
// exp2f without fast math wraps the same instruction in a rescaling for
// those results, four instructions where one does.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// max and sum over the four lanes that share a fragment row (lanes 4g ..
// 4g + 3); every lane ends with the same bits
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFullMask, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFullMask, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFullMask, x, 1);
  return x + __shfl_xor_sync(kFullMask, x, 2);
}

// the score of (row, key) scaled to base 2 and masked: -1e30 above the
// diagonal under causal, -inf past T
__device__ __forceinline__ float masked_score(float s, float c2, int64_t row,
                                              int64_t key, int64_t Tk,
                                              int causal) {
  float x = __fmul_rn(s, c2);
  if (causal && key > row) x = kNegInf;
  if (key >= Tk) x = -INFINITY;
  return x;
}

// the online softmax of a finished score tile on an accumulator fragment
// (wgmma's layout; the f32 design's mma.sync tiles keep the same one): s[i] is row r0 + 8 ((i >> 1) & 1), key k0 + 8 (i >> 2)
// + cq + (i & 1). Leaves P (float32) in s, updates the running max m
// (base 2) and this lane's part of the denominator l, and returns each
// row's correction for O in corr. `edge`: the tile crosses the diagonal
// or holds the end of T, so its indices are compared; on the other tiles
// the scale folds into the exponential's argument (exp2(s c2 - m) as one
// fma; max(s) c2 = max(s c2), c2 > 0).
template <int N>
__device__ __forceinline__ void online_softmax(float (&s)[N], float (&m)[2],
                                               float (&l)[2], int64_t r0,
                                               int cq, int64_t k0, bool edge,
                                               int64_t Tk, int causal,
                                               float c2, float (&corr)[2]) {
  float mx[2] = {kNegInf, kNegInf};
  if (edge) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = masked_score(s[i], c2, r0 + 8 * r,
                          k0 + 8 * (i >> 2) + cq + (i & 1), Tk, causal);
      mx[r] = fmaxf(mx[r], s[i]);
    }
  } else {
    mx[0] = mx[1] = -INFINITY;
#pragma unroll
    for (int i = 0; i < N; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    mx[0] = __fmul_rn(mx[0], c2);
    mx[1] = __fmul_rn(mx[1], c2);
  }
  float m_new[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m_new[r] = fmaxf(m[r], quad_max(mx[r]));
    corr[r] = ex2(__fsub_rn(m[r], m_new[r]));
    m[r] = m_new[r];
  }
  float sum[2] = {0.f, 0.f};
  if (edge) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = ex2(__fsub_rn(s[i], m_new[r]));
      sum[r] += s[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = ex2(fmaf(s[i], c2, -m_new[r]));
      sum[r] += s[i];
    }
  }
  l[0] = l[0] * corr[0] + sum[0];
  l[1] = l[1] * corr[1] + sum[1];
}


// ===========================================================================
// bf16 / f16: wgmma + TMA
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

// one box of a 3-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma's shared-memory matrix descriptor for a tile as TMA's 128-byte
// swizzle lays it out: rows of 64 elements (128 bytes), 8-row groups 1024
// bytes apart (SBO); `lbo` bytes between 64-element column blocks, read
// only for an MN-major operand (V). Tiles start on 1024-byte boundaries.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// named barriers 1 and 2 order the two consumer warpgroups' tensor-core
// work: a warpgroup waits on its own before issuing, then lets the other
// one go (256 threads: its 128 waiting, the other's 128 arriving)
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(2 - wg) : "memory");
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
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// wgmma wrappers: the tag picks bf16 or f16; `acc` = 0 overwrites D
// D (64 x 64, f32) {=, +=} A (64 x 16) B (16 x 64), A and B from shared memory, K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], Bf16, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// D (64 x 128, f32) {=, +=} A (64 x 16) B (16 x 128), A and B from shared memory, K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], Bf16, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// D (64 x 128, f32) += A (64 x 16, registers) B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], Bf16, const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// D (64 x 256, f32) += A (64 x 16, registers) B (16 x 256, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], Bf16, const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
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
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// D (64 x 64, f32) {=, +=} A (64 x 16) B (16 x 64), A and B from shared memory, K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], F16, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// D (64 x 128, f32) {=, +=} A (64 x 16) B (16 x 128), A and B from shared memory, K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], F16, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// D (64 x 128, f32) += A (64 x 16, registers) B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], F16, const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// D (64 x 256, f32) += A (64 x 16, registers) B (16 x 256, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], F16, const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
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
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <typename T, int HD>
struct WgCfg {
  static constexpr int kBQ = 128;                   // q rows: 64 a warpgroup
  static constexpr int kBK = HD == 128 ? 128 : 64;  // keys a tile
  static constexpr int kChunks = HD / 64;           // 128-byte column blocks
  static constexpr int kQBytes = kBQ * HD * 2;
  static constexpr int kKVBytes = kBK * HD * 2;     // one K or V tile
  static constexpr int kStages = HD == 128 ? 3 : 2; // of K and of V
  static constexpr int kThreads = 384;              // 2 consumer + 1 producer
  // Q, the stages of K and of V, 13 mbarriers, room to align to 1024
  static constexpr int kSmem =
      kQBytes + 2 * kStages * kKVBytes + 128 + 1024;
};

// one consumer warpgroup's state and its steps on a key tile: issuing
// S = Q K^T and O += P V, rounding P, rescaling O
template <typename T, int HD>
struct Consumer {
  using C = WgCfg<T, HD>;
  using Tag = typename TagOf<T>::type;
  static constexpr int BQ = C::kBQ, BK = C::kBK;

  float sc[BK / 2];           // S, then P in float32
  uint32_t p16[BK / 16][4];   // P of the tile whose P V is in flight
  float acc[HD / 2];          // O
  float m[2], l[2];           // per fragment row: running max (base 2),
                              // this lane's part of the denominator
  int r0, cq;                 // fragment rows r0, r0 + 8; columns cq, +1

  // S = Q K^T: hd / 16 steps of k16, Q's and K's column block kk / 4
  __device__ __forceinline__ void issue_scores(const T* Qw, const T* Kt) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint64_t da =
          sw128_desc(Qw + (kk / 4) * BQ * 64 + (kk % 4) * 16, 0);
      const uint64_t db =
          sw128_desc(Kt + (kk / 4) * BK * 64 + (kk % 4) * 16, 0);
      if constexpr (BK == 128)
        wgmma_ss_n128(sc, Tag{}, da, db, kk > 0);
      else
        wgmma_ss_n64(sc, Tag{}, da, db, kk > 0);
    }
    wgmma_commit();
  }

  // O += P V: BK / 16 steps of k16, V MN-major across its column blocks
  __device__ __forceinline__ void issue_pv(const T* Vt) {
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t db = sw128_desc(Vt + kk * 16 * 64, BK * 128);
      if constexpr (HD == 128)
        wgmma_rs_n128(acc, Tag{}, p16[kk], db, 1);
      else
        wgmma_rs_n256(acc, Tag{}, p16[kk], db, 1);
    }
    wgmma_commit();
  }

  // P rounded to the 16-bit type, as wgmma's A fragments (one per 16 keys)
  __device__ __forceinline__ void round_p() {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        p16[kk][j] = pack2(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1], Tag{});
  }

  __device__ __forceinline__ void rescale(const float (&corr)[2]) {
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(384, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       T* __restrict__ o, int S, int Tk, float c2,
                       int causal) {
  using C = WgCfg<T, HD>;
  using Tag = typename TagOf<T>::type;
  constexpr int BQ = C::kBQ, BK = C::kBK, NC = C::kChunks;
  constexpr int NS = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  T* Qs = reinterpret_cast<T*>(base);          // [NC][BQ][64]
  T* Ks = Qs + BQ * HD;                         // [NS][NC][BK][64]
  T* Vs = Ks + NS * BK * HD;                    // [NS][NC][BK][64]
  // K and V have barriers of their own: a K tile is free once its scores
  // are taken, a V tile only once P V has run a tile later
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + NS * BK * HD);
  uint64_t* q_full = bars;
  uint64_t* full_k = bars + 1;                  // [NS] each
  uint64_t* full_v = full_k + NS;
  uint64_t* empty_k = full_v + NS;
  uint64_t* empty_v = empty_k + NS;

  const int bh = blockIdx.y;
  // the heaviest q tiles (most key tiles under causal) first
  const int q0 = (static_cast<int>(gridDim.x) - 1 - blockIdx.x) * BQ;
  const int q_last = min(q0 + BQ, S) - 1;
  int n_tiles = (Tk + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, q_last / BK + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], 8);               // one arrival a consumer warp
      mbar_init(&empty_v[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= 8) {
    // producer warpgroup: gives its registers to the consumers; one
    // thread loads Q once, then each K/V tile when its stage is free
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 8 && lane == 0) {
      mbar_expect_tx(q_full, C::kQBytes);
      for (int c = 0; c < NC; ++c)
        tma_load(Qs + c * BQ * 64, &tq, q_full, 64 * c, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % NS;
        const unsigned freed = ((t / NS) & 1) ^ 1;   // tile t - NS's release
        if (t >= NS) mbar_wait(&empty_k[s], freed);
        mbar_expect_tx(&full_k[s], C::kKVBytes);
        for (int c = 0; c < NC; ++c)
          tma_load(Ks + s * BK * HD + c * BK * 64, &tk, &full_k[s], 64 * c,
                   t * BK, bh);
        if (t >= NS) mbar_wait(&empty_v[s], freed);
        mbar_expect_tx(&full_v[s], C::kKVBytes);
        for (int c = 0; c < NC; ++c)
          tma_load(Vs + s * BK * HD + c * BK * 64, &tv, &full_v[s], 64 * c,
                   t * BK, bh);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    // consumers: warpgroup wg owns q rows [q0 + 64 wg, q0 + 64 wg + 64)
    const int wg = warp / 4;
    const int wg_first = q0 + 64 * wg, wg_last = wg_first + 63;
    // the tiles this warpgroup computes: under causal, not those wholly
    // above its rows (at hd 256 the second half of the diagonal for wg 0)
    const int n_wg = causal ? min(n_tiles, wg_last / BK + 1) : n_tiles;
    const T* Qw = Qs + wg * 64 * 64;
    Consumer<T, HD> cs;
    cs.r0 = wg_first + 16 * (warp % 4) + lane / 4;
    cs.cq = 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) cs.acc[i] = 0.f;
    cs.m[0] = cs.m[1] = kNegInf;
    cs.l[0] = cs.l[1] = 0.f;
    auto edge = [&](int k0) {
      return (causal && k0 + BK - 1 > wg_first) || k0 + BK > Tk;
    };
    // tile t's K or V stage: wait for it to land, or release it (this
    // warp is done with it)
    auto wait_k = [&](int t) { mbar_wait(&full_k[t % NS], (t / NS) & 1); };
    auto wait_v = [&](int t) { mbar_wait(&full_v[t % NS], (t / NS) & 1); };
    auto release = [&](uint64_t* empty, int t) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[t % NS]);
    };
    auto k_tile = [&](int t) { return Ks + (t % NS) * BK * HD; };
    auto v_tile = [&](int t) { return Vs + (t % NS) * BK * HD; };

    // software pipeline: the scores of tile t and P V of tile t - 1 are
    // issued together; the softmax of t runs while P V of t - 1 is on the
    // tensor cores, and O is rescaled once that product has landed
    // the two warpgroups take turns at issuing (n_tiles + 1 turns each,
    // warpgroup 0 first), so one's softmax runs under the other's products
    int turns = n_tiles + 1;
    auto take_turn = [&] { turn_wait(wg); };
    auto end_turn = [&] {
      if (--turns > 0 || wg == 0) turn_pass(wg);
    };
    if (wg == 1) turn_pass(wg);

    mbar_wait(q_full, 0);
    float corr[2];
    wait_k(0);
    take_turn();
    cs.issue_scores(Qw, Ks);
    end_turn();
    wgmma_wait<0>();
    fence_regs(cs.sc);
    release(empty_k, 0);
    online_softmax(cs.sc, cs.m, cs.l, cs.r0, cs.cq, 0, edge(0), Tk, causal,
                   c2, corr);
    cs.round_p();
    for (int t = 1; t < n_wg; ++t) {
      wait_k(t);
      wait_v(t - 1);
      take_turn();
      cs.issue_scores(Qw, k_tile(t));
      cs.issue_pv(v_tile(t - 1));
      end_turn();
      wgmma_wait<1>();                  // the scores; P V may still run
      fence_regs(cs.sc);
      release(empty_k, t);
      online_softmax(cs.sc, cs.m, cs.l, cs.r0, cs.cq, t * BK, edge(t * BK),
                     Tk, causal, c2, corr);
      wgmma_wait<0>();                  // P V of tile t - 1
      fence_regs(cs.acc);
      fence_regs(cs.p16);
      release(empty_v, t - 1);
      cs.rescale(corr);
      cs.round_p();
    }
    wait_v(n_wg - 1);
    take_turn();
    cs.issue_pv(v_tile(n_wg - 1));
    end_turn();
    wgmma_wait<0>();
    fence_regs(cs.acc);
    fence_regs(cs.p16);
    release(empty_v, n_wg - 1);
    for (int t = n_wg; t < n_tiles; ++t) {   // tiles this warpgroup skips
      take_turn();
      end_turn();
      wait_k(t);
      release(empty_k, t);
      wait_v(t);
      release(empty_v, t);
    }

    // out = acc / max(l, 1e-30), rounded once; rows past S are not stored
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float denom = fmaxf(quad_sum(cs.l[r]), 1e-30f);
      const int row = cs.r0 + 8 * r;
      if (row >= S) continue;
      T* orow = o + (static_cast<int64_t>(bh) * S + row) * HD;
#pragma unroll
      for (int b = 0; b < HD / 8; ++b) {
        const int i = 4 * b + 2 * r;
        *reinterpret_cast<uint32_t*>(orow + 8 * b + cs.cq) =
            pack2(__fdiv_rn(cs.acc[i], denom),
                  __fdiv_rn(cs.acc[i + 1], denom), Tag{});
      }
    }
  }
}

// ===========================================================================
// float32: 3xTF32 on mma.sync
// ===========================================================================

struct Split {
  uint32_t hi, lo, hic;     // hic: hi where x is finite, else 0
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// cvt.rna.tf32 of a finite x, as integer operations (cvt itself also
// tests for NaN and Inf): round the 13 low bits of the magnitude away
__device__ __forceinline__ uint32_t to_tf32_finite(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// the split of a B operand (K, V); x - hi is finite for a finite x
__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = to_tf32(x);
  const bool finite = fabsf(x) < INFINITY;      // false for NaN too
  const uint32_t lo = to_tf32_finite(__fsub_rn(x, __uint_as_float(hi)));
  return {hi, finite ? lo : 0u, finite ? hi : 0u};
}

// the split of an A operand (Q, P), unguarded: a non-finite q or p makes
// its row NaN or infinite in the plain version too, whatever the terms
struct SplitA {
  uint32_t hi, lo;
};
__device__ __forceinline__ SplitA split_a(float x) {
  const uint32_t hi = to_tf32(x);
  return {hi, to_tf32_finite(__fsub_rn(x, __uint_as_float(hi)))};
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
// then added to d in float32 (rounded to nearest). The tensor core's own
// accumulation truncates; carried across every k step (and across key
// tiles, for O) its error grows in one direction, past the float64 gate.
__device__ __forceinline__ void mma_3xtf32(float* d, const SplitA (&a)[4],
                                           const Split (&b)[2]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hic, b[1].hic);
  mma_tf32(t, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
  mma_tf32(t, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

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

constexpr int kTfBQ = 64, kTfBK = 32, kTfThreads = 128;

// rows [row0, row0 + ROWS) of a (rows, HD) matrix into a tile of row
// stride HD + 4, asynchronously; rows at or past `rows` are zeros
template <int HD, int ROWS>
__device__ __forceinline__ void load_rows(const float* __restrict__ src,
                                          int64_t row0, int64_t rows,
                                          float* dst) {
  constexpr int kChunks = ROWS * HD / 4;       // 16-byte chunks
  for (int c = threadIdx.x; c < kChunks; c += kTfThreads) {
    const int r = c / (HD / 4), col = (c % (HD / 4)) * 4;
    const bool valid = row0 + r < rows;
    cp_async16(dst + r * (HD + 4) + col,
               valid ? src + (row0 + r) * HD + col : src, valid);
  }
}

template <int HD>
__global__ void __launch_bounds__(kTfThreads, HD <= 128 ? 2 : 1)
    flash_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      int64_t S, int64_t Tk, float c2, int causal) {
  constexpr int BQ = kTfBQ, BK = kTfBK, LD = HD + 4, NT = HD / 8;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][LD]
  float* Ks = Qs + BQ * LD;                      // [2][BK][LD]
  float* Vs = Ks + 2 * BK * LD;                  // [2][BK][LD]

  const int64_t bh = blockIdx.y;
  const int64_t q0 = (static_cast<int64_t>(gridDim.x) - 1 - blockIdx.x) * BQ;
  const float* qb = q + bh * S * HD;
  const float* kb = k + bh * Tk * HD;
  const float* vb = v + bh * Tk * HD;
  const int64_t q_last = (q0 + BQ < S ? q0 + BQ : S) - 1;
  int64_t n_tiles = (Tk + BK - 1) / BK;
  if (causal && q_last / BK + 1 < n_tiles) n_tiles = q_last / BK + 1;

  // warp w owns rows [q0 + 16 w, q0 + 16 w + 16); a thread holds fragment
  // rows r0 and r0 + 8 and, in each 8-column block, columns 2 t4, 2 t4 + 1
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int64_t w_first = q0 + 16 * warp;
  const int64_t r0 = w_first + g;

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  load_rows<HD, BQ>(qb, q0, S, Qs);
  load_rows<HD, BK>(kb, 0, Tk, Ks);
  load_rows<HD, BK>(vb, 0, Tk, Vs);
  cp_async_commit();

  for (int64_t t = 0; t < n_tiles; ++t) {
    const int s = static_cast<int>(t & 1);
    const int64_t k0 = t * BK;
    if (t + 1 < n_tiles) {        // the next tile into the other stage
      load_rows<HD, BK>(kb, k0 + BK, Tk, Ks + (s ^ 1) * BK * LD);
      load_rows<HD, BK>(vb, k0 + BK, Tk, Vs + (s ^ 1) * BK * LD);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const float* Kt = Ks + s * BK * LD;
    const float* Vt = Vs + s * BK * LD;

    // S = Q K^T: hd / 8 steps of k8 over BK / 8 key blocks; sc[4 n + e]
    // is the accumulator of key block n, in wgmma's layout
    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
#pragma unroll 4
    for (int ks = 0; ks < HD / 8; ++ks) {
      const float* qa = Qs + (16 * warp + g) * LD + 8 * ks + t4;
      const SplitA a[4] = {split_a(qa[0]), split_a(qa[8 * LD]),
                           split_a(qa[4]), split_a(qa[8 * LD + 4])};
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const float* kp = Kt + (8 * n + g) * LD + 8 * ks + t4;
        const Split b[2] = {split(kp[0]), split(kp[4])};
        mma_3xtf32(sc + 4 * n, a, b);
      }
    }

    float corr[2];
    const bool edge = (causal && k0 + BK - 1 > w_first) || k0 + BK > Tk;
    online_softmax(sc, m, l, r0, 2 * t4, k0, edge, Tk, causal, c2, corr);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];

    // O += P V over the tile's 8-key steps j: P's A fragment straight
    // from the accumulator with k index t4 <-> key 8 j + 2 t4 and t4 + 4
    // <-> key 8 j + 2 t4 + 1, V's rows read in the same order
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const SplitA a[4] = {split_a(sc[4 * j]), split_a(sc[4 * j + 2]),
                           split_a(sc[4 * j + 1]), split_a(sc[4 * j + 3])};
      const float* vp = Vt + (8 * j + 2 * t4) * LD + g;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const Split b[2] = {split(vp[8 * n]), split(vp[LD + 8 * n])};
        mma_3xtf32(acc[n], a, b);
      }
    }
    __syncthreads();     // every warp is done with stage s
  }

  // out = acc / max(l, 1e-30); rows past S are not stored
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float denom = fmaxf(quad_sum(l[r]), 1e-30f);
    const int64_t row = r0 + 8 * r;
    if (row >= S) continue;
    float* orow = o + (bh * S + row) * HD;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n + 2 * t4) =
          make_float2(__fdiv_rn(acc[n][2 * r], denom),
                      __fdiv_rn(acc[n][2 * r + 1], denom));
  }
}

// ===========================================================================
// host side
// ===========================================================================

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

// a 3-D map over a (BH, rows, HD) tensor of 16-bit elements: boxes of 64
// columns x box_rows rows of one head, 128-byte swizzle, zeros past `rows`
bool make_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
              int64_t BH, int64_t rows, int HD, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(HD),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(HD) * 2,
                                 static_cast<cuuint64_t>(rows) * HD * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encoder()(map, type, 3, const_cast<void*>(ptr), dims, strides, box,
                   elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T> constexpr CUtensorMapDataType map_type();
template <> constexpr CUtensorMapDataType map_type<__nv_bfloat16>() {
  return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}
template <> constexpr CUtensorMapDataType map_type<__half>() {
  return CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
}

template <typename T, int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 int64_t BH, int64_t S, int64_t Tk, float c2, int causal,
                 cudaStream_t stream) {
  using C = WgCfg<T, HD>;
  if (BH > 65535 || S > 2147483647LL - C::kBQ || Tk > 2147483647LL - C::kBK)
    return -2;
  if (encoder() == nullptr) return -5;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, map_type<T>(), q, BH, S, HD, C::kBQ) ||
      !make_map(&tk, map_type<T>(), k, BH, Tk, HD, C::kBK) ||
      !make_map(&tv, map_type<T>(), v, BH, Tk, HD, C::kBK))
    return -6;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((S + C::kBQ - 1) / C::kBQ),
                  static_cast<unsigned>(BH));
  flash_wgmma_kernel<T, HD><<<grid, C::kThreads, C::kSmem, stream>>>(
      tq, tk, tv, static_cast<T*>(o), static_cast<int>(S),
      static_cast<int>(Tk), c2, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_tf32(const void* q, const void* k, const void* v, void* o,
                int64_t BH, int64_t S, int64_t Tk, float c2, int causal,
                cudaStream_t stream) {
  const int64_t q_tiles = (S + kTfBQ - 1) / kTfBQ;
  if (BH > 65535 || q_tiles > 2147483647LL) return -2;
  constexpr int bytes =
      static_cast<int>(sizeof(float)) * (kTfBQ + 4 * kTfBK) * (HD + 4);
  cudaError_t err = cudaFuncSetAttribute(
      flash_tf32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(q_tiles), static_cast<unsigned>(BH));
  flash_tf32_kernel<HD><<<grid, kTfThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, Tk, c2, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, void* o,
                 int64_t BH, int64_t S, int64_t Tk, int64_t hd, float c2,
                 int causal, cudaStream_t stream) {
  switch (hd) {
    case 128:
      return launch_wgmma<T, 128>(q, k, v, o, BH, S, Tk, c2, causal, stream);
    case 256:
      return launch_wgmma<T, 256>(q, k, v, o, BH, S, Tk, c2, causal, stream);
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
// contiguous, 16-byte aligned and of one element type (`dtype`: 0
// float32, 1 bfloat16, 2 float16); `causal` != 0 masks keys past the
// query's index. hd is 128 or 256. Returns cudaGetLastError() after the
// launch (0: launched), -2 when the grid would need more blocks than CUDA
// allows (BH > 65,535) or S or T past 2^31, -3 for an unknown dtype, -4
// for another hd, -5 when the driver has no cuTensorMapEncodeTiled, -6
// when it refuses a tensor map. T = 0 launches nothing (every row attends
// to nothing: the caller's output is zeros).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int64_t BH, int64_t S, int64_t T,
                               int64_t hd, float scale, int causal, int dtype,
                               int device, void* stream) {
  if (BH == 0 || S == 0 || T == 0) return 0;
  if (dtype < 0 || dtype > 2) return -3;
  if (hd != 128 && hd != 256) return -4;
  use_device(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // scores to base 2: exp(x * scale) = exp2(x * scale * log2(e))
  const float c2 = static_cast<float>(static_cast<double>(scale) *
                                      1.4426950408889634074);
  switch (dtype) {
    case 0:
      return hd == 128 ? launch_tf32<128>(q, k, v, o, BH, S, T, c2, causal, s)
                       : launch_tf32<256>(q, k, v, o, BH, S, T, c2, causal, s);
    case 1:
      return launch_typed<__nv_bfloat16>(q, k, v, o, BH, S, T, hd, c2, causal,
                                         s);
    default:
      return launch_typed<__half>(q, k, v, o, BH, S, T, hd, c2, causal, s);
  }
}

// Flash-attention backward for one head, no mask (FlashAttention-2): given q, k,
// v, the forward's output o, its per-row logsumexp lse and the output gradient
// do, computes dq, dk and dv without materialising the [Tq, Tk] scores.
//
// Replaces the Pallas TPU kernels control_gic_tpu/ops/attention.py:200
// _flash_bwd_dkdv_kernel and :244 _flash_bwd_dq_kernel (launched by
// _flash_backward). The same function:
//   s     = q k^T * scale                      (f32 accumulation)
//   p     = exp(s - lse)                       (f32)
//   delta = rowsum(do * o)                     (f32)
//   ds    = p * (do v^T - delta)               (f32)
//   dv   += p^T do
//   dk   += ds^T q * scale
//   dq   += ds k * scale
// JAX's two-kernel split is kept: the dk/dv kernel owns a block of keys and
// walks every query block; the dq kernel owns a block of queries and walks
// every key block. Neither uses atomics, so two runs give equal bits. delta
// is computed once by a small pre-pass into [B, Tq] f32 (JAX recomputes it
// inside both kernels); the dk/dv launcher runs it before the dk/dv kernel
// and the dq kernel reads it.
//
// Shapes: q, o, do [B, Tq, C]; k, v [B, Tk, C]; lse [B, Tq] f32; all
// contiguous; C a multiple of 16, at most 512. Tq and Tk are arbitrary: rows
// past Tq and keys past Tk are zero-filled on load and their p is set to 0.
//
// What bounds it on an H100: operations. At the training shape (B = 2,
// Tq = Tk = 4096, C = 512) the two kernels do 7 matrix products of
// 2*Tq*Tk*C flops each over some 40 MB of operands.
//
// bf16 path (flash_bwd_dkdv_kernel, flash_bwd_dq_kernel), the first simple
// design: bf16 products on the tensor cores through nvcuda::wmma (16x16x16,
// f32 accumulation) from shared memory, with the f32 accumulators of dk and
// dv (or dq) in shared memory; p and ds are rounded to bf16 before their
// products, and each block product of dk and dq is scaled once, as in JAX.
// Tiles: 16 keys a CTA and 32 query rows a step (dk/dv), 32 query rows a CTA
// and 32 keys a step (dq).
//
// f32 path (flash_bwd_dkdv_f32_kernel<NG>, flash_bwd_dq_f32_kernel<NG>), the
// training recipe's dtype: FFMA on the FP32 pipes, never TF32. Both kernels
// share one body (bwd_f32): a CTA of 256 threads owns 32 rows (keys for
// dk/dv, query rows for dq) and walks the other side in steps of 64 rows.
//  - The owned pair stays in shared memory for the whole launch (K and V, or
//    Q and dO: 2 x 32 x (CP + 4) floats, CP = C rounded up to 64 NG with NG
//    a power of two). The streamed pair (Q and dO, or K and V) cannot stay
//    too: at C = 512 four 32-row tiles are 264 KB of the 227 KB a block has.
//    So it arrives twice a step through a 4-slot cp.async ring of 18 KB
//    slots: first in 32-channel chunks of its 64 rows, which build S and dP
//    (4x4 register outer products over float4 loads, 64 FFMA per 8 loads;
//    one half of the CTA builds S = Q K^T, the other dP = dO V^T), then in
//    chunks of whole rows (dk/dv: 2048 / CP rows of dO and of Q; dq:
//    4096 / CP rows of K) for the accumulating products. Loads run three
//    slots ahead of the math. Channel chunks past C are skipped.
//  - p is written to shared memory as [streamed row][owned row] by the S
//    half; the dP half turns it into ds * scale (the scale is folded into
//    ds here, where JAX scales each block product: the order of the f32 sums
//    changes, and ops/attention.py's replay follows it).
//  - The accumulators stay in registers for the whole launch: a thread owns
//    PT consecutive owned rows (8 from C = 256 on) and NC4 float4 columns
//    spread CT threads apart, so that the 32 lanes of a warp read 32
//    consecutive float4 of a row and one broadcast float4 pair of p or ds.
//    At C = 512 dK and dV are 2 x 8 x 8 = 128 registers a thread (dq: 64).
//  - Shared memory at C = 512: owned 132,096 + ring 73,728 + p and ds
//    18,432 = 224,256 bytes (static_assert against 232,448), one CTA an SM;
//    at C = 256 158,720 bytes.
//  - Filling the card: 32 owned rows give B * Tk / 32 = 256 CTAs at the
//    training shape, 1.94 waves over 132 SMs (256 of 264 CTA slots busy).
//    64 owned rows would give 0.97 waves but need 256 accumulator registers
//    a thread at C = 512 for dk/dv.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (control_gic_tpu_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxC = 512;

// ---------------------------------------------------------------- bf16 path

struct Bf16Cfg {
  static constexpr int KV_BK = 16;   // dk/dv kernel: keys per CTA
  static constexpr int KV_BQ = 32;   //               query rows per step
  static constexpr int Q_BQ = 32;    // dq kernel: query rows per CTA
  static constexpr int Q_BK = 32;    //            keys per step
  static constexpr int PAD = 8;      // row padding (elements) of the operand tiles
};

__host__ __device__ inline size_t align_up(size_t x, size_t a) {
  return (x + a - 1) / a * a;
}

// Dynamic shared memory of one CTA, in bytes from the base; row strides in
// elements. Every region starts on 128 bytes (wmma wants 32).
//   own:   the block this CTA keeps for the whole launch (K and V of the dk/dv
//          kernel, q and do of the dq kernel), 2 x [rows_own, ld] bf16
//   step:  the block loaded at each step, 2 x [rows_step, ld] bf16
//   s, dp: the [BQ, BK] scores and do v^T, f32
//   p, ds: p and ds rounded to bf16
//   acc:   the f32 accumulators, n_acc x [rows_own, ldo]
//   lse, delta: per query row of the block that holds queries, f32
struct Layout {
  size_t own, step, s, dp, p, ds, acc, lse, delta, total;
  int ld, lds, ldp, ldo;
};

__host__ __device__ inline Layout make_layout(int C, int rows_own, int rows_step, int BQ, int BK,
                                              int n_acc) {
  Layout L;
  L.ld = C + Bf16Cfg::PAD;
  L.lds = BK + 4;
  L.ldp = BK + 8;
  L.ldo = C + 4;
  size_t off = 0;
  L.own = off;
  off = align_up(off + sizeof(bf16) * 2 * rows_own * L.ld, 128);
  L.step = off;
  off = align_up(off + sizeof(bf16) * 2 * rows_step * L.ld, 128);
  L.s = off;
  off = align_up(off + sizeof(float) * BQ * L.lds, 128);
  L.dp = off;
  off = align_up(off + sizeof(float) * BQ * L.lds, 128);
  L.p = off;
  off = align_up(off + sizeof(bf16) * BQ * L.ldp, 128);
  L.ds = off;
  off = align_up(off + sizeof(bf16) * BQ * L.ldp, 128);
  L.acc = off;
  off = align_up(off + sizeof(float) * n_acc * rows_own * L.ldo, 128);
  L.lse = off;
  off += sizeof(float) * BQ;
  L.delta = off;
  off += sizeof(float) * BQ;
  L.total = align_up(off, 128);
  return L;
}

__host__ __device__ inline Layout dkdv_layout(int C) {
  return make_layout(C, Bf16Cfg::KV_BK, Bf16Cfg::KV_BQ, Bf16Cfg::KV_BQ, Bf16Cfg::KV_BK, 2);
}

__host__ __device__ inline Layout dq_layout(int C) {
  return make_layout(C, Bf16Cfg::Q_BQ, Bf16Cfg::Q_BK, Bf16Cfg::Q_BQ, Bf16Cfg::Q_BK, 1);
}

__device__ inline float to_float(bf16 x) { return __bfloat162float(x); }
__device__ inline float to_float(float x) { return x; }

// Copy `rows` rows of C elements from global (row stride C) into shared memory
// (row stride ld); rows at or past `valid` are zero-filled.
__device__ void load_rows(bf16* __restrict__ dst, int ld, const bf16* __restrict__ src, int rows,
                          int valid, int C) {
  const int chunks = C / 8;   // 16 bytes each
  for (int idx = threadIdx.x; idx < rows * chunks; idx += blockDim.x) {
    const int r = idx / chunks;
    const int c = (idx - r * chunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + (size_t)r * C + c);
    *reinterpret_cast<uint4*>(dst + (size_t)r * ld + c) = val;
  }
}

// S[BQ, BK] = A[BQ, C] B[BK, C]^T and DP[BQ, BK] = A2[BQ, C] B2[BK, C]^T (f32),
// both row-major with row stride ld: q k^T and do v^T.
template <int BQ, int BK>
__device__ void scores(const bf16* A, const bf16* B, const bf16* A2, const bf16* B2, int ld,
                       float* S, float* DP, int lds, int C) {
  constexpr int tn = BK / 16;
  constexpr int tiles = (BQ / 16) * tn;
  const int warp = threadIdx.x / 32;
  for (int t = warp; t < 2 * tiles; t += kWarps) {
    const bool second = t >= tiles;
    const int u = second ? t - tiles : t;
    const int i = u / tn, j = u % tn;
    const bf16* a_ptr = (second ? A2 : A) + i * 16 * ld;
    const bf16* b_ptr = (second ? B2 : B) + j * 16 * ld;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < C; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(a, a_ptr + kk, ld);
      wmma::load_matrix_sync(b, b_ptr + kk, ld);   // B^T
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync((second ? DP : S) + i * 16 * lds + j * 16, acc, lds,
                            wmma::mem_row_major);
  }
}

// Acc[M, C] += scale * (op(A)[M, K] B[K, C]) for the output tiles t0, t0 + step, ...
// of the M x C grid of 16x16 tiles. op(A) = A, stored [M, K] row-major, or
// (kTransA) A^T with A stored [K, M] row-major; row stride lda. B is [K, C]
// row-major with row stride ldb; Acc f32 with row stride ldo. The block
// product is summed in a fragment of its own and then scaled and added, as
// JAX adds dot(...) * scale to its accumulator.
template <bool kTransA>
__device__ void mma_acc(const bf16* A, int lda, const bf16* B, int ldb, float* Acc, int ldo,
                        int M, int K, int C, float scale, int t0, int step) {
  using LayoutA = typename std::conditional<kTransA, wmma::col_major, wmma::row_major>::type;
  const int tn = C / 16;
  const int tiles = (M / 16) * tn;
  for (int t = t0; t < tiles; t += step) {
    const int i = t / tn, j = t % tn;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> prod, acc;
    wmma::fill_fragment(prod, 0.0f);
    for (int kk = 0; kk < K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LayoutA> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      const bf16* pa = kTransA ? A + (size_t)kk * lda + i * 16 : A + (size_t)i * 16 * lda + kk;
      wmma::load_matrix_sync(a, pa, lda);
      wmma::load_matrix_sync(b, B + (size_t)kk * ldb + j * 16, ldb);
      wmma::mma_sync(prod, a, b, prod);
    }
    float* po = Acc + (size_t)i * 16 * ldo + j * 16;
    wmma::load_matrix_sync(acc, po, ldo, wmma::mem_row_major);
    for (int e = 0; e < acc.num_elements; ++e) acc.x[e] += prod.x[e] * scale;
    wmma::store_matrix_sync(po, acc, ldo, wmma::mem_row_major);
  }
}

// p = exp(s * scale - lse) and ds = p * (dp - delta) over the [BQ, BK] block,
// rounded into sP / sDS, with p = 0 on keys past kvalid (and on query rows
// past the end, whose lse is +inf).
template <int BQ, int BK>
__device__ void probs(const float* S, const float* DP, bf16* sP, bf16* sDS, const Layout& L,
                      const float* sLse, const float* sDelta, int kvalid, float scale) {
  for (int idx = threadIdx.x; idx < BQ * BK; idx += blockDim.x) {
    const int r = idx / BK;
    const int c = idx - r * BK;
    const float p = (c < kvalid) ? expf(S[r * L.lds + c] * scale - sLse[r]) : 0.0f;
    const float ds = p * (DP[r * L.lds + c] - sDelta[r]);
    sP[r * L.ldp + c] = __float2bfloat16(p);
    sDS[r * L.ldp + c] = __float2bfloat16(ds);
  }
}

// Per query row of the block at q0: lse (+inf past Tq, so that p = 0) and delta.
__device__ void load_row_stats(float* sLse, float* sDelta, const float* lse, const float* delta,
                               int BQ, int qvalid) {
  for (int r = threadIdx.x; r < BQ; r += blockDim.x) {
    sLse[r] = (r < qvalid) ? lse[r] : INFINITY;
    sDelta[r] = (r < qvalid) ? delta[r] : 0.0f;
  }
}

// delta[row] = sum_c do[row, c] * o[row, c] in f32, a warp per row, lanes
// strided over C and reduced by a fixed butterfly.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, long long rows, int C) {
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* orow = o + row * C;
  const T* drow = dout + row * C;
  float s = 0.0f;
  for (int c = lane; c < C; c += 32) s = fmaf(to_float(drow[c]), to_float(orow[c]), s);
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int Tq, int Tk, int C,
                      float scale) {
  constexpr int BK = Bf16Cfg::KV_BK, BQ = Bf16Cfg::KV_BQ;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = dkdv_layout(C);
  bf16* sK = reinterpret_cast<bf16*>(smem + L.own);
  bf16* sV = sK + BK * L.ld;
  bf16* sQ = reinterpret_cast<bf16*>(smem + L.step);
  bf16* sDO = sQ + BQ * L.ld;
  float* sS = reinterpret_cast<float*>(smem + L.s);
  float* sDP = reinterpret_cast<float*>(smem + L.dp);
  bf16* sP = reinterpret_cast<bf16*>(smem + L.p);
  bf16* sDS = reinterpret_cast<bf16*>(smem + L.ds);
  float* sdK = reinterpret_cast<float*>(smem + L.acc);
  float* sdV = sdK + BK * L.ldo;
  float* sLse = reinterpret_cast<float*>(smem + L.lse);
  float* sDelta = reinterpret_cast<float*>(smem + L.delta);

  const int b = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int kvalid = min(BK, Tk - k0);
  load_rows(sK, L.ld, k + ((size_t)b * Tk + k0) * C, BK, kvalid, C);
  load_rows(sV, L.ld, v + ((size_t)b * Tk + k0) * C, BK, kvalid, C);
  for (int idx = threadIdx.x; idx < 2 * BK * L.ldo; idx += blockDim.x) sdK[idx] = 0.0f;

  const bf16* qb = q + (size_t)b * Tq * C;
  const bf16* db = dout + (size_t)b * Tq * C;
  for (int q0 = 0; q0 < Tq; q0 += BQ) {
    const int qvalid = min(BQ, Tq - q0);
    load_rows(sQ, L.ld, qb + (size_t)q0 * C, BQ, qvalid, C);
    load_rows(sDO, L.ld, db + (size_t)q0 * C, BQ, qvalid, C);
    load_row_stats(sLse, sDelta, lse + (size_t)b * Tq + q0, delta + (size_t)b * Tq + q0, BQ,
                   qvalid);
    __syncthreads();
    scores<BQ, BK>(sQ, sK, sDO, sV, L.ld, sS, sDP, L.lds, C);
    __syncthreads();
    probs<BQ, BK>(sS, sDP, sP, sDS, L, sLse, sDelta, kvalid, scale);
    __syncthreads();
    // dv += p^T do and dk += (ds^T q) * scale; the warps split between the two
    const int warp = threadIdx.x / 32;
    if (warp < kWarps / 2) {
      mma_acc<true>(sP, L.ldp, sDO, L.ld, sdV, L.ldo, BK, BQ, C, 1.0f, warp, kWarps / 2);
    } else {
      mma_acc<true>(sDS, L.ldp, sQ, L.ld, sdK, L.ldo, BK, BQ, C, scale, warp - kWarps / 2,
                    kWarps / 2);
    }
    __syncthreads();
  }

  bf16* dkb = dk + ((size_t)b * Tk + k0) * C;
  bf16* dvb = dv + ((size_t)b * Tk + k0) * C;
  for (int idx = threadIdx.x; idx < kvalid * C; idx += blockDim.x) {
    const int r = idx / C;
    const int c = idx - r * C;
    dkb[(size_t)r * C + c] = __float2bfloat16(sdK[r * L.ldo + c]);
    dvb[(size_t)r * C + c] = __float2bfloat16(sdV[r * L.ldo + c]);
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int Tq, int Tk, int C, float scale) {
  constexpr int BQ = Bf16Cfg::Q_BQ, BK = Bf16Cfg::Q_BK;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = dq_layout(C);
  bf16* sQ = reinterpret_cast<bf16*>(smem + L.own);
  bf16* sDO = sQ + BQ * L.ld;
  bf16* sK = reinterpret_cast<bf16*>(smem + L.step);
  bf16* sV = sK + BK * L.ld;
  float* sS = reinterpret_cast<float*>(smem + L.s);
  float* sDP = reinterpret_cast<float*>(smem + L.dp);
  bf16* sP = reinterpret_cast<bf16*>(smem + L.p);
  bf16* sDS = reinterpret_cast<bf16*>(smem + L.ds);
  float* sdQ = reinterpret_cast<float*>(smem + L.acc);
  float* sLse = reinterpret_cast<float*>(smem + L.lse);
  float* sDelta = reinterpret_cast<float*>(smem + L.delta);

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int qvalid = min(BQ, Tq - q0);
  load_rows(sQ, L.ld, q + ((size_t)b * Tq + q0) * C, BQ, qvalid, C);
  load_rows(sDO, L.ld, dout + ((size_t)b * Tq + q0) * C, BQ, qvalid, C);
  load_row_stats(sLse, sDelta, lse + (size_t)b * Tq + q0, delta + (size_t)b * Tq + q0, BQ,
                 qvalid);
  for (int idx = threadIdx.x; idx < BQ * L.ldo; idx += blockDim.x) sdQ[idx] = 0.0f;

  const bf16* kb = k + (size_t)b * Tk * C;
  const bf16* vb = v + (size_t)b * Tk * C;
  for (int k0 = 0; k0 < Tk; k0 += BK) {
    const int kvalid = min(BK, Tk - k0);
    load_rows(sK, L.ld, kb + (size_t)k0 * C, BK, kvalid, C);
    load_rows(sV, L.ld, vb + (size_t)k0 * C, BK, kvalid, C);
    __syncthreads();
    scores<BQ, BK>(sQ, sK, sDO, sV, L.ld, sS, sDP, L.lds, C);
    __syncthreads();
    probs<BQ, BK>(sS, sDP, sP, sDS, L, sLse, sDelta, kvalid, scale);
    __syncthreads();
    // dq += (ds k) * scale
    mma_acc<false>(sDS, L.ldp, sK, L.ld, sdQ, L.ldo, BQ, BK, C, scale, threadIdx.x / 32, kWarps);
    __syncthreads();
  }

  bf16* dqb = dq + ((size_t)b * Tq + q0) * C;
  for (int idx = threadIdx.x; idx < qvalid * C; idx += blockDim.x) {
    const int r = idx / C;
    const int c = idx - r * C;
    dqb[(size_t)r * C + c] = __float2bfloat16(sdQ[r * L.ldo + c]);
  }
}

// ---------------------------------------------------------------- f32 path

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <int NG>
struct F32Cfg {
  static constexpr int CP = NG * 64;     // C rounded up (NG a power of two)
  static constexpr int OWN = 32;         // rows a CTA owns (keys: dk/dv; queries: dq)
  static constexpr int STR = 64;         // rows of the other side a step
  static constexpr int LDO = CP + 4;     // row strides (floats); 4 mod 32 spreads banks
  static constexpr int LDC = 32 + 4;
  static constexpr int LDW = OWN + 4;
  static constexpr int RR = 2048 / CP;   // rows of each matrix in a dk/dv row chunk
  static constexpr int PT = NG >= 4 ? 8 : 2 * NG;   // owned rows of a thread's accumulator
  static constexpr int CT = kThreads / (OWN / PT);  // threads along the columns
  static constexpr int NC4 = CP / (4 * CT);         // float4 columns of a thread
  static constexpr int STAGES = 4;
  static constexpr int CHUNK = 2 * STR * LDC;       // floats of a ring slot
  static constexpr size_t OFF_RING = (size_t)2 * OWN * LDO * 4;
  static constexpr size_t OFF_W = OFF_RING + (size_t)STAGES * CHUNK * 4;
  static constexpr size_t SMEM = OFF_W + (size_t)2 * STR * LDW * 4;
  static_assert(2 * RR * LDO <= CHUNK, "a row chunk fits a ring slot");
  static_assert(NC4 >= 1 && NC4 * 4 * CT == CP, "accumulator columns cover CP");
  static_assert(SMEM <= 232448, "shared memory of one CTA");
};

// Ring chunk g of the walk over the streamed side (sa, sb: its two matrices
// at this batch element, t_str rows). Each step of 64 rows has ncc channel
// chunks, then NRC row chunks:
//  - part < ncc: channels [32 part, +32) of the 64 rows of sa, then of sb,
//    [2][64][LDC];
//  - otherwise whole rows, [2 RR][LDO]: dk/dv: RR rows of sb (do), then the
//    same RR rows of sa (q); dq: 2 RR consecutive rows of sa (k).
// Rows past t_str and channels past C are zero-filled.
template <int NG, bool kDQ>
__device__ __forceinline__ void load_chunk(float* buf, const float* sa, const float* sb, int g,
                                           int per, int ncc, int t_str, int C) {
  using K = F32Cfg<NG>;
  const int step = g / per, part = g - step * per;
  const int row0 = step * K::STR;
  if (part < ncc) {
    const int c0 = part * 32;
    for (int idx = threadIdx.x; idx < 2 * K::STR * 8; idx += blockDim.x) {
      const int m = idx / (K::STR * 8), rem = idx - m * (K::STR * 8);
      const int r = rem / 8, c = c0 + (rem % 8) * 4, row = row0 + r;
      const float* src = m ? sb : sa;
      const bool ok = row < t_str && c < C;
      cp_async16(buf + (m * K::STR + r) * K::LDC + (rem % 8) * 4,
                 ok ? src + (size_t)row * C + c : src, ok);
    }
  } else {
    const int rc = part - ncc;
    for (int idx = threadIdx.x; idx < 2 * K::RR * (K::CP / 4); idx += blockDim.x) {
      const int r = idx / (K::CP / 4), c = (idx % (K::CP / 4)) * 4;
      const float* src = (kDQ || r >= K::RR) ? sa : sb;
      const int row = kDQ ? row0 + rc * 2 * K::RR + r : row0 + rc * K::RR + r % K::RR;
      const bool ok = row < t_str && c < C;
      cp_async16(buf + r * K::LDO + c, ok ? src + (size_t)row * C + c : src, ok);
    }
  }
}

template <int PT>
__device__ __forceinline__ void load_w(float (&w)[PT], const float* p) {
  if constexpr (PT % 4 == 0) {
#pragma unroll
    for (int u = 0; u < PT / 4; ++u) {
      const float4 t = reinterpret_cast<const float4*>(p)[u];
      w[4 * u] = t.x;
      w[4 * u + 1] = t.y;
      w[4 * u + 2] = t.z;
      w[4 * u + 3] = t.w;
    }
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    w[0] = t.x;
    w[1] = t.y;
  }
}

__device__ __forceinline__ void fma4(float4& a, float p, const float4& v) {
  a.x = fmaf(p, v.x, a.x);
  a.y = fmaf(p, v.y, a.y);
  a.z = fmaf(p, v.z, a.z);
  a.w = fmaf(p, v.w, a.w);
}

// The body of both f32 kernels, for one CTA: owned rows [32 blockIdx.x, +32)
// of own_a / own_b (t_own rows), the streamed side str_a / str_b (t_str
// rows) walked in steps of 64 rows; lse and delta [Tq] of this batch element.
//   dk/dv (kDQ false): own = (k, v), str = (q, do); out_a = dk, out_b = dv.
//   dq (kDQ true):     own = (q, do), str = (k, v); out_a = dq.
// S-phase threads: half 0 builds x = str_a . own_a (q k^T), half 1
// x = str_b . own_b (do v^T), each thread 4 streamed rows sr + 16 i by 4
// owned rows orow + 8 j.
template <int NG, bool kDQ>
__device__ __forceinline__ void bwd_f32(const float* __restrict__ own_a,
                                        const float* __restrict__ own_b,
                                        const float* __restrict__ str_a,
                                        const float* __restrict__ str_b,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ delta,
                                        float* __restrict__ out_a, float* __restrict__ out_b,
                                        int t_own, int t_str, int C, float scale) {
  using K = F32Cfg<NG>;
  constexpr int NRC = kDQ ? K::STR / (2 * K::RR) : K::STR / K::RR;
  constexpr int NACC = kDQ ? 1 : 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sOwnA = reinterpret_cast<float*>(smem_raw);
  float* sOwnB = sOwnA + K::OWN * K::LDO;
  float* ring = reinterpret_cast<float*>(smem_raw + K::OFF_RING);
  float* sP = reinterpret_cast<float*>(smem_raw + K::OFF_W);   // [STR][LDW]: p
  float* sDS = sP + K::STR * K::LDW;                           // ds * scale

  const int tid = threadIdx.x;
  const int o0 = blockIdx.x * K::OWN;
  const int ncc = (C + 31) / 32;
  const int per = ncc + NRC;
  const int total = (t_str + K::STR - 1) / K::STR * per;

  for (int idx = tid; idx < 2 * K::OWN * (K::CP / 4); idx += blockDim.x) {
    const int m = idx / (K::OWN * (K::CP / 4)), rem = idx - m * (K::OWN * (K::CP / 4));
    const int r = rem / (K::CP / 4), c = (rem % (K::CP / 4)) * 4;
    const float* src = m ? own_b : own_a;
    const bool ok = o0 + r < t_own && c < C;
    cp_async16((m ? sOwnB : sOwnA) + r * K::LDO + c, ok ? src + (size_t)(o0 + r) * C + c : src,
               ok);
  }
#pragma unroll
  for (int g = 0; g < K::STAGES - 1; ++g) {   // the owned rows ride in the first group
    if (g < total) load_chunk<NG, kDQ>(ring + g * K::CHUNK, str_a, str_b, g, per, ncc, t_str, C);
    cp_async_commit();
  }

  const int half = tid / 128, u = tid % 128, sr = u / 8, orow = u % 8;
  const int og = tid / K::CT, cg = tid % K::CT;
  const float* stat = half ? delta : lse;
  const float stat_pad = half ? 0.0f : INFINITY;   // rows past Tq: p = 0, ds = 0
  float st[4];   // lse (half 0) or delta (half 1): dk/dv by streamed row i, dq by owned row j
  if constexpr (kDQ) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = o0 + orow + 8 * j;
      st[j] = row < t_own ? stat[row] : stat_pad;
    }
  }
  float x[4][4];
  float4 acc[NACC][K::PT][K::NC4];
#pragma unroll
  for (int a = 0; a < NACC; ++a)
#pragma unroll
    for (int i = 0; i < K::PT; ++i)
#pragma unroll
      for (int m = 0; m < K::NC4; ++m) acc[a][i][m] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int g = 0; g < total; ++g) {
    cp_async_wait<K::STAGES - 2>();
    __syncthreads();   // chunk g is in; every thread is done with chunk g - 1
    if (g + K::STAGES - 1 < total)
      load_chunk<NG, kDQ>(ring + ((g + K::STAGES - 1) % K::STAGES) * K::CHUNK, str_a, str_b,
                          g + K::STAGES - 1, per, ncc, t_str, C);
    cp_async_commit();
    const float* buf = ring + (g % K::STAGES) * K::CHUNK;
    const int step = g / per, part = g - step * per;
    if (part < ncc) {   // x += str[:, 32 channels] own[:, 32 channels]^T
      if (part == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) x[i][j] = 0.0f;
        if constexpr (!kDQ) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = step * K::STR + sr + 16 * i;
            st[i] = row < t_str ? stat[row] : stat_pad;
          }
        }
      }
      const float* sa = buf + half * K::STR * K::LDC;
      const float* ob = (half ? sOwnB : sOwnA) + part * 32;
#pragma unroll
      for (int c4 = 0; c4 < 8; ++c4) {
        float4 av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          av[i] = *reinterpret_cast<const float4*>(sa + (sr + 16 * i) * K::LDC + c4 * 4);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bv[j] = *reinterpret_cast<const float4*>(ob + (orow + 8 * j) * K::LDO + c4 * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            x[i][j] = fmaf(av[i].x, bv[j].x, x[i][j]);
            x[i][j] = fmaf(av[i].y, bv[j].y, x[i][j]);
            x[i][j] = fmaf(av[i].z, bv[j].z, x[i][j]);
            x[i][j] = fmaf(av[i].w, bv[j].w, x[i][j]);
          }
      }
      if (part == ncc - 1 && half == 0) {   // p = exp(s * scale - lse), 0 past Tk
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int key = kDQ ? step * K::STR + sr + 16 * i : o0 + orow + 8 * j;
            const int t_key = kDQ ? t_str : t_own;
            const float s_lse = kDQ ? st[j] : st[i];
            sP[(sr + 16 * i) * K::LDW + orow + 8 * j] =
                key < t_key ? expf(x[i][j] * scale - s_lse) : 0.0f;
          }
      }
    } else {
      if (part == ncc) {   // ds * scale = p * (dp - delta) * scale, by the dP half
        if (half == 1) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int idx = (sr + 16 * i) * K::LDW + orow + 8 * j;
              sDS[idx] = sP[idx] * (x[i][j] - (kDQ ? st[j] : st[i])) * scale;
            }
        }
        __syncthreads();
      }
      const int rc = part - ncc;
      if constexpr (kDQ) {   // dq[own] += ds[key, own] k[key, :]
#pragma unroll 4
        for (int r = 0; r < 2 * K::RR; ++r) {
          float w[K::PT];
          load_w<K::PT>(w, sDS + (rc * 2 * K::RR + r) * K::LDW + og * K::PT);
          float4 xv[K::NC4];
#pragma unroll
          for (int m = 0; m < K::NC4; ++m)
            xv[m] = *reinterpret_cast<const float4*>(buf + r * K::LDO + 4 * (cg + K::CT * m));
#pragma unroll
          for (int i = 0; i < K::PT; ++i)
#pragma unroll
            for (int m = 0; m < K::NC4; ++m) fma4(acc[0][i][m], w[i], xv[m]);
        }
      } else {   // dv[own] += p[q, own] do[q, :], dk[own] += ds[q, own] q[q, :]
#pragma unroll 4
        for (int r = 0; r < K::RR; ++r) {
          float wp[K::PT], ws[K::PT];
          load_w<K::PT>(wp, sP + (rc * K::RR + r) * K::LDW + og * K::PT);
          load_w<K::PT>(ws, sDS + (rc * K::RR + r) * K::LDW + og * K::PT);
          float4 xo[K::NC4], xq[K::NC4];
#pragma unroll
          for (int m = 0; m < K::NC4; ++m) {
            xo[m] = *reinterpret_cast<const float4*>(buf + r * K::LDO + 4 * (cg + K::CT * m));
            xq[m] = *reinterpret_cast<const float4*>(buf + (K::RR + r) * K::LDO +
                                                     4 * (cg + K::CT * m));
          }
#pragma unroll
          for (int i = 0; i < K::PT; ++i)
#pragma unroll
            for (int m = 0; m < K::NC4; ++m) {
              fma4(acc[NACC - 1][i][m], wp[i], xo[m]);
              fma4(acc[0][i][m], ws[i], xq[m]);
            }
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int a = 0; a < NACC; ++a) {
    float* out = a ? out_b : out_a;
#pragma unroll
    for (int i = 0; i < K::PT; ++i) {
      const int row = o0 + og * K::PT + i;
      if (row < t_own) {
#pragma unroll
        for (int m = 0; m < K::NC4; ++m) {
          const int col = 4 * (cg + K::CT * m);
          if (col < C) *reinterpret_cast<float4*>(out + (size_t)row * C + col) = acc[a][i][m];
        }
      }
    }
  }
}

template <int NG>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int Tq, int Tk, int C,
                          float scale) {
  const size_t b = blockIdx.y, qo = b * Tq * C, ko = b * Tk * C;
  bwd_f32<NG, false>(k + ko, v + ko, q + qo, dout + qo, lse + b * Tq, delta + b * Tq, dk + ko,
                     dv + ko, Tk, Tq, C, scale);
}

template <int NG>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, int Tq, int Tk, int C, float scale) {
  const size_t b = blockIdx.y, qo = b * Tq * C, ko = b * Tk * C;
  bwd_f32<NG, true>(q + qo, dout + qo, k + ko, v + ko, lse + b * Tq, delta + b * Tq, dq + qo,
                    nullptr, Tq, Tk, C, scale);
}

// ---------------------------------------------------------------- launchers

template <typename T>
int launch_delta(const void* o, const void* dout, void* delta, int B, int Tq, int C,
                 cudaStream_t stream) {
  const long long rows = (long long)B * Tq;
  flash_bwd_delta_kernel<T><<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), static_cast<float*>(delta), rows,
      C);
  return (int)cudaGetLastError();
}

int launch_dkdv_bf16(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dk, void* dv, int B, int Tq,
                     int Tk, int C, float scale, cudaStream_t stream) {
  const Layout L = dkdv_layout(C);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tk + Bf16Cfg::KV_BK - 1) / Bf16Cfg::KV_BK, B);
  flash_bwd_dkdv_kernel<<<grid, kThreads, L.total, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), Tq, Tk, C,
      scale);
  return (int)cudaGetLastError();
}

int launch_dq_bf16(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                   const void* delta, void* dq, int B, int Tq, int Tk, int C, float scale,
                   cudaStream_t stream) {
  const Layout L = dq_layout(C);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + Bf16Cfg::Q_BQ - 1) / Bf16Cfg::Q_BQ, B);
  flash_bwd_dq_kernel<<<grid, kThreads, L.total, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), Tq, Tk, C, scale);
  return (int)cudaGetLastError();
}

template <int NG>
int launch_dkdv_f32(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dk, void* dv, int B, int Tq, int Tk,
                    int C, float scale, cudaStream_t stream) {
  using K = F32Cfg<NG>;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_f32_kernel<NG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)K::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tk + K::OWN - 1) / K::OWN, B);
  flash_bwd_dkdv_f32_kernel<NG><<<grid, kThreads, K::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), Tq, Tk,
      C, scale);
  return (int)cudaGetLastError();
}

template <int NG>
int launch_dq_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                  const void* delta, void* dq, int B, int Tq, int Tk, int C, float scale,
                  cudaStream_t stream) {
  using K = F32Cfg<NG>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_f32_kernel<NG>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + K::OWN - 1) / K::OWN, B);
  flash_bwd_dq_f32_kernel<NG><<<grid, kThreads, K::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), Tq, Tk, C, scale);
  return (int)cudaGetLastError();
}

// NG of the f32 kernels: C rounded up to a power-of-two multiple of 64.
int f32_groups(int C) {
  int ng = 1;
  while (ng * 64 < C) ng *= 2;
  return ng;
}

bool args_ok(int B, int Tq, int Tk, int C) {
  return B > 0 && B <= 65535 && Tq > 0 && Tk > 0 && C > 0 && C % 16 == 0 && C <= kMaxC;
}

}  // namespace

extern "C" {

// The delta pre-pass, then dk and dv. delta [B, Tq] f32 is written here and
// read by cgic_flash_attn_bwd_dq. dtype: 0 = float32, 1 = bfloat16. Returns 0
// or a cudaError_t code; -1 for arguments the kernels do not take.
int cgic_flash_attn_bwd_dkdv(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, const void* lse, void* delta, void* dk, void* dv,
                             int B, int Tq, int Tk, int C, int dtype, float scale,
                             void* stream) {
  if (!args_ok(B, Tq, Tk, C) || (dtype != 0 && dtype != 1)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = dtype == 1 ? launch_delta<bf16>(o, dout, delta, B, Tq, C, s)
                       : launch_delta<float>(o, dout, delta, B, Tq, C, s);
  if (err != 0) return err;
  if (dtype == 1)
    return launch_dkdv_bf16(q, k, v, dout, lse, delta, dk, dv, B, Tq, Tk, C, scale, s);
  switch (f32_groups(C)) {
    case 1: return launch_dkdv_f32<1>(q, k, v, dout, lse, delta, dk, dv, B, Tq, Tk, C, scale, s);
    case 2: return launch_dkdv_f32<2>(q, k, v, dout, lse, delta, dk, dv, B, Tq, Tk, C, scale, s);
    case 4: return launch_dkdv_f32<4>(q, k, v, dout, lse, delta, dk, dv, B, Tq, Tk, C, scale, s);
    case 8: return launch_dkdv_f32<8>(q, k, v, dout, lse, delta, dk, dv, B, Tq, Tk, C, scale, s);
  }
  return -1;
}

int cgic_flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dq, int B, int Tq, int Tk,
                           int C, int dtype, float scale, void* stream) {
  if (!args_ok(B, Tq, Tk, C)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_dq_bf16(q, k, v, dout, lse, delta, dq, B, Tq, Tk, C, scale, s);
  if (dtype != 0) return -1;
  switch (f32_groups(C)) {
    case 1: return launch_dq_f32<1>(q, k, v, dout, lse, delta, dq, B, Tq, Tk, C, scale, s);
    case 2: return launch_dq_f32<2>(q, k, v, dout, lse, delta, dq, B, Tq, Tk, C, scale, s);
    case 4: return launch_dq_f32<4>(q, k, v, dout, lse, delta, dq, B, Tq, Tk, C, scale, s);
    case 8: return launch_dq_f32<8>(q, k, v, dout, lse, delta, dq, B, Tq, Tk, C, scale, s);
  }
  return -1;
}

const char* cgic_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

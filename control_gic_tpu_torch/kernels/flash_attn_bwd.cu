// Flash-attention backward for one head, no mask (FlashAttention-2): given q, k,
// v, the forward's output o, its per-row logsumexp lse and the output gradient
// do, computes dq, dk and dv without materialising the [Tq, Tk] scores.
//
// Replaces the Pallas TPU kernels control_gic_tpu/ops/attention.py::
// _flash_bwd_dkdv_kernel and ::_flash_bwd_dq_kernel (launched by
// _flash_backward). Same arithmetic, block by block:
//   s     = q k^T * scale                      (f32 accumulation)
//   p     = exp(s - lse)                       (f32)
//   delta = rowsum(do * o)                     (f32)
//   ds    = p * (do v^T - delta)               (f32)
//   dv   += p^T do                             (p rounded to the operand dtype)
//   dk   += (ds^T q) * scale                   (ds rounded; scaled once per block product)
//   dq   += (ds k) * scale
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
// 2*Tq*Tk*C flops each over some 40 MB of operands. This first version is the
// simple one, as the forward: bf16 products on the tensor cores through
// nvcuda::wmma (16x16x16, f32 accumulation) from shared memory, with the f32
// accumulators of dk and dv (or dq) in shared memory. What is scarce is
// shared memory at C = 512: the two [BK, C] f32 accumulators of the dk/dv
// kernel take 64 KB at BK = 16, the K and V tiles 33 KB, the q and do tiles
// of 32 rows 66 KB, so the tiles are sized per dtype, at one CTA per SM, and
// the opt-in limit is raised with cudaFuncSetAttribute. The f32
// instantiation (the training recipe's dtype) uses plain fp32 FMAs, never
// TF32, with 16-row tiles. wgmma, TMA and register accumulators are left for
// later.
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

template <typename T>
struct Cfg;
template <>
struct Cfg<bf16> {
  static constexpr int KV_BK = 16;   // dk/dv kernel: keys per CTA
  static constexpr int KV_BQ = 32;   //               query rows per step
  static constexpr int Q_BQ = 32;    // dq kernel: query rows per CTA
  static constexpr int Q_BK = 32;    //            keys per step
  static constexpr int PAD = 8;      // row padding (elements) of the operand tiles
};
template <>
struct Cfg<float> {
  static constexpr int KV_BK = 16;
  static constexpr int KV_BQ = 16;
  static constexpr int Q_BQ = 16;
  static constexpr int Q_BK = 16;
  static constexpr int PAD = 1;      // odd stride: conflict-free column reads
};

__host__ __device__ inline size_t align_up(size_t x, size_t a) {
  return (x + a - 1) / a * a;
}

// Dynamic shared memory of one CTA, in bytes from the base; row strides in
// elements. Every region starts on 128 bytes (wmma wants 32).
//   own:   the block this CTA keeps for the whole launch (K and V of the dk/dv
//          kernel, q and do of the dq kernel), 2 x [rows_own, ld] T
//   step:  the block loaded at each step, 2 x [rows_step, ld] T
//   s, dp: the [BQ, BK] scores and do v^T, f32 (p and ds overwrite them)
//   p, ds: p and ds rounded to T (bf16 only)
//   acc:   the f32 accumulators, n_acc x [rows_own, ldo]
//   lse, delta: per query row of the block that holds queries, f32
struct Layout {
  size_t own, step, s, dp, p, ds, acc, lse, delta, total;
  int ld, lds, ldp, ldo;
};

template <typename T>
__host__ __device__ inline Layout make_layout(int C, int rows_own, int rows_step, int BQ,
                                              int BK, int n_acc) {
  Layout L;
  L.ld = C + Cfg<T>::PAD;
  L.lds = BK + 4;
  L.ldp = BK + 8;
  L.ldo = C + 4;
  size_t off = 0;
  L.own = off;
  off = align_up(off + sizeof(T) * 2 * rows_own * L.ld, 128);
  L.step = off;
  off = align_up(off + sizeof(T) * 2 * rows_step * L.ld, 128);
  L.s = off;
  off = align_up(off + sizeof(float) * BQ * L.lds, 128);
  L.dp = off;
  off = align_up(off + sizeof(float) * BQ * L.lds, 128);
  L.p = off;
  L.ds = off;
  if (sizeof(T) == 2) {
    off = align_up(off + sizeof(T) * BQ * L.ldp, 128);
    L.ds = off;
    off = align_up(off + sizeof(T) * BQ * L.ldp, 128);
  }
  L.acc = off;
  off = align_up(off + sizeof(float) * n_acc * rows_own * L.ldo, 128);
  L.lse = off;
  off += sizeof(float) * BQ;
  L.delta = off;
  off += sizeof(float) * BQ;
  L.total = align_up(off, 128);
  return L;
}

template <typename T>
__host__ __device__ inline Layout dkdv_layout(int C) {
  using K = Cfg<T>;
  return make_layout<T>(C, K::KV_BK, K::KV_BQ, K::KV_BQ, K::KV_BK, 2);
}

template <typename T>
__host__ __device__ inline Layout dq_layout(int C) {
  using K = Cfg<T>;
  return make_layout<T>(C, K::Q_BQ, K::Q_BK, K::Q_BQ, K::Q_BK, 1);
}

__device__ inline float to_float(bf16 x) { return __bfloat162float(x); }
__device__ inline float to_float(float x) { return x; }
__device__ inline bf16 from_float(float x, bf16*) { return __float2bfloat16(x); }
__device__ inline float from_float(float x, float*) { return x; }

// Copy `rows` rows of C elements from global (row stride C) into shared memory
// (row stride ld); rows at or past `valid` are zero-filled.
template <typename T>
__device__ void load_rows(T* __restrict__ dst, int ld, const T* __restrict__ src, int rows,
                          int valid, int C) {
  if constexpr (sizeof(T) == 2) {
    const int chunks = C / 8;   // 16 bytes each
    for (int idx = threadIdx.x; idx < rows * chunks; idx += blockDim.x) {
      const int r = idx / chunks;
      const int c = (idx - r * chunks) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < valid) val = *reinterpret_cast<const uint4*>(src + (size_t)r * C + c);
      *reinterpret_cast<uint4*>(dst + (size_t)r * ld + c) = val;
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * C; idx += blockDim.x) {
      const int r = idx / C;
      const int c = idx - r * C;
      dst[(size_t)r * ld + c] = (r < valid) ? src[(size_t)r * C + c] : T(0);
    }
  }
}

// ---------------------------------------------------------------- products
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

template <int BQ, int BK>
__device__ void scores(const float* A, const float* B, const float* A2, const float* B2, int ld,
                       float* S, float* DP, int lds, int C) {
  for (int idx = threadIdx.x; idx < 2 * BQ * BK; idx += blockDim.x) {
    const bool second = idx >= BQ * BK;
    const int u = second ? idx - BQ * BK : idx;
    const int r = u / BK;
    const int c = u - r * BK;
    const float* ar = (second ? A2 : A) + r * ld;
    const float* br = (second ? B2 : B) + c * ld;
    float acc = 0.0f;
    for (int kk = 0; kk < C; ++kk) acc = fmaf(ar[kk], br[kk], acc);
    (second ? DP : S)[r * lds + c] = acc;
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

// The same product in plain fp32 FMAs, a thread per output element; t0 and
// step split the output elements between two calls that run side by side.
template <bool kTransA>
__device__ void mma_acc(const float* A, int lda, const float* B, int ldb, float* Acc, int ldo,
                        int M, int K, int C, float scale, int t0, int step) {
  for (int idx = t0 * blockDim.x + threadIdx.x; idx < M * C; idx += step * blockDim.x) {
    const int r = idx / C;
    const int c = idx - r * C;
    float s = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float a = kTransA ? A[k * lda + r] : A[r * lda + k];
      s = fmaf(a, B[k * ldb + c], s);
    }
    Acc[r * ldo + c] += s * scale;
  }
}

// p = exp(s * scale - lse) and ds = p * (dp - delta) over the [BQ, BK] block,
// with p = 0 on keys past kvalid (and on query rows past the end, whose lse is
// +inf). bf16: p and ds rounded into sP / sDS; f32: over S and DP.
template <typename T, int BQ, int BK>
__device__ void probs(float* S, float* DP, T* sP, T* sDS, const Layout& L, const float* sLse,
                      const float* sDelta, int kvalid, float scale) {
  for (int idx = threadIdx.x; idx < BQ * BK; idx += blockDim.x) {
    const int r = idx / BK;
    const int c = idx - r * BK;
    const float p = (c < kvalid) ? expf(S[r * L.lds + c] * scale - sLse[r]) : 0.0f;
    const float ds = p * (DP[r * L.lds + c] - sDelta[r]);
    if constexpr (sizeof(T) == 2) {
      sP[r * L.ldp + c] = __float2bfloat16(p);
      sDS[r * L.ldp + c] = __float2bfloat16(ds);
    } else {
      S[r * L.lds + c] = p;
      DP[r * L.lds + c] = ds;
    }
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

// ---------------------------------------------------------------- kernels

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      int Tq, int Tk, int C, float scale) {
  constexpr int BK = Cfg<T>::KV_BK, BQ = Cfg<T>::KV_BQ;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = dkdv_layout<T>(C);
  T* sK = reinterpret_cast<T*>(smem + L.own);
  T* sV = sK + BK * L.ld;
  T* sQ = reinterpret_cast<T*>(smem + L.step);
  T* sDO = sQ + BQ * L.ld;
  float* sS = reinterpret_cast<float*>(smem + L.s);
  float* sDP = reinterpret_cast<float*>(smem + L.dp);
  T* sP = reinterpret_cast<T*>(smem + L.p);
  T* sDS = reinterpret_cast<T*>(smem + L.ds);
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

  const T* qb = q + (size_t)b * Tq * C;
  const T* db = dout + (size_t)b * Tq * C;
  for (int q0 = 0; q0 < Tq; q0 += BQ) {
    const int qvalid = min(BQ, Tq - q0);
    load_rows(sQ, L.ld, qb + (size_t)q0 * C, BQ, qvalid, C);
    load_rows(sDO, L.ld, db + (size_t)q0 * C, BQ, qvalid, C);
    load_row_stats(sLse, sDelta, lse + (size_t)b * Tq + q0, delta + (size_t)b * Tq + q0, BQ,
                   qvalid);
    __syncthreads();
    scores<BQ, BK>(sQ, sK, sDO, sV, L.ld, sS, sDP, L.lds, C);
    __syncthreads();
    probs<T, BQ, BK>(sS, sDP, sP, sDS, L, sLse, sDelta, kvalid, scale);
    __syncthreads();
    // dv += p^T do and dk += (ds^T q) * scale; the warps (f32: the threads)
    // split between the two
    if constexpr (sizeof(T) == 2) {
      const int warp = threadIdx.x / 32;
      if (warp < kWarps / 2) {
        mma_acc<true>(sP, L.ldp, sDO, L.ld, sdV, L.ldo, BK, BQ, C, 1.0f, warp, kWarps / 2);
      } else {
        mma_acc<true>(sDS, L.ldp, sQ, L.ld, sdK, L.ldo, BK, BQ, C, scale, warp - kWarps / 2,
                      kWarps / 2);
      }
    } else {
      mma_acc<true>(sS, L.lds, sDO, L.ld, sdV, L.ldo, BK, BQ, C, 1.0f, 0, 1);
      mma_acc<true>(sDP, L.lds, sQ, L.ld, sdK, L.ldo, BK, BQ, C, scale, 0, 1);
    }
    __syncthreads();
  }

  T* dkb = dk + ((size_t)b * Tk + k0) * C;
  T* dvb = dv + ((size_t)b * Tk + k0) * C;
  for (int idx = threadIdx.x; idx < kvalid * C; idx += blockDim.x) {
    const int r = idx / C;
    const int c = idx - r * C;
    dkb[(size_t)r * C + c] = from_float(sdK[r * L.ldo + c], (T*)nullptr);
    dvb[(size_t)r * C + c] = from_float(sdV[r * L.ldo + c], (T*)nullptr);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int Tq, int Tk, int C,
                    float scale) {
  constexpr int BQ = Cfg<T>::Q_BQ, BK = Cfg<T>::Q_BK;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = dq_layout<T>(C);
  T* sQ = reinterpret_cast<T*>(smem + L.own);
  T* sDO = sQ + BQ * L.ld;
  T* sK = reinterpret_cast<T*>(smem + L.step);
  T* sV = sK + BK * L.ld;
  float* sS = reinterpret_cast<float*>(smem + L.s);
  float* sDP = reinterpret_cast<float*>(smem + L.dp);
  T* sP = reinterpret_cast<T*>(smem + L.p);
  T* sDS = reinterpret_cast<T*>(smem + L.ds);
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

  const T* kb = k + (size_t)b * Tk * C;
  const T* vb = v + (size_t)b * Tk * C;
  for (int k0 = 0; k0 < Tk; k0 += BK) {
    const int kvalid = min(BK, Tk - k0);
    load_rows(sK, L.ld, kb + (size_t)k0 * C, BK, kvalid, C);
    load_rows(sV, L.ld, vb + (size_t)k0 * C, BK, kvalid, C);
    __syncthreads();
    scores<BQ, BK>(sQ, sK, sDO, sV, L.ld, sS, sDP, L.lds, C);
    __syncthreads();
    probs<T, BQ, BK>(sS, sDP, sP, sDS, L, sLse, sDelta, kvalid, scale);
    __syncthreads();
    // dq += (ds k) * scale
    if constexpr (sizeof(T) == 2) {
      mma_acc<false>(sDS, L.ldp, sK, L.ld, sdQ, L.ldo, BQ, BK, C, scale, threadIdx.x / 32,
                     kWarps);
    } else {
      mma_acc<false>(sDP, L.lds, sK, L.ld, sdQ, L.ldo, BQ, BK, C, scale, 0, 1);
    }
    __syncthreads();
  }

  T* dqb = dq + ((size_t)b * Tq + q0) * C;
  for (int idx = threadIdx.x; idx < qvalid * C; idx += blockDim.x) {
    const int r = idx / C;
    const int c = idx - r * C;
    dqb[(size_t)r * C + c] = from_float(sdQ[r * L.ldo + c], (T*)nullptr);
  }
}

// ---------------------------------------------------------------- launchers

template <typename T>
int launch_dkdv(const void* q, const void* k, const void* v, const void* o, const void* dout,
                const void* lse, void* delta, void* dk, void* dv, int B, int Tq, int Tk, int C,
                float scale, cudaStream_t stream) {
  const long long rows = (long long)B * Tq;
  flash_bwd_delta_kernel<T><<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), static_cast<float*>(delta), rows,
      C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Layout L = dkdv_layout<T>(C);
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tk + Cfg<T>::KV_BK - 1) / Cfg<T>::KV_BK, B);
  flash_bwd_dkdv_kernel<T><<<grid, kThreads, L.total, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), Tq, Tk, C,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int B, int Tq, int Tk, int C, float scale,
              cudaStream_t stream) {
  const Layout L = dq_layout<T>(C);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + Cfg<T>::Q_BQ - 1) / Cfg<T>::Q_BQ, B);
  flash_bwd_dq_kernel<T><<<grid, kThreads, L.total, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), Tq, Tk, C, scale);
  return (int)cudaGetLastError();
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
  if (!args_ok(B, Tq, Tk, C)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_dkdv<bf16>(q, k, v, o, dout, lse, delta, dk, dv, B, Tq, Tk, C, scale, s);
  if (dtype == 0)
    return launch_dkdv<float>(q, k, v, o, dout, lse, delta, dk, dv, B, Tq, Tk, C, scale, s);
  return -1;
}

int cgic_flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dq, int B, int Tq, int Tk,
                           int C, int dtype, float scale, void* stream) {
  if (!args_ok(B, Tq, Tk, C)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_dq<bf16>(q, k, v, dout, lse, delta, dq, B, Tq, Tk, C, scale, s);
  if (dtype == 0) return launch_dq<float>(q, k, v, dout, lse, delta, dq, B, Tq, Tk, C, scale, s);
  return -1;
}

const char* cgic_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

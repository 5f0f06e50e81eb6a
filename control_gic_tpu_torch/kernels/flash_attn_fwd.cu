// Flash-attention forward for one head, no mask: o = softmax(q k^T * scale) v.
//
// Replaces the Pallas TPU kernel control_gic_tpu/ops/attention.py::_flash_kernel
// (launched by attention_flash). Same online softmax: per query row a running
// max m, a denominator l and an f32 accumulator, rescaled by exp(m_prev - m_new)
// at each key tile; p is cast to v's dtype before the PV product; the output is
// acc / l in q's dtype.
//
// With an lse pointer it also replaces ::_flash_lse_kernel (launched by
// attention_flash_with_lse, the training forward): the epilogue then also
// stores the per-row logsumexp of the scaled logits, m + log(l), as [B, Tq]
// f32, the residual that the backward (flash_attn_bwd.cu) reads. Without it
// (the inference launch) nothing else changes.
//
// Shapes: q [B, Tq, C], k and v [B, Tk, C], contiguous; C a multiple of 16, at
// most 512. Tq and Tk are arbitrary: query rows past Tq are computed on zeros
// and not stored, key columns past Tk are masked to -inf and their v rows are
// zero-filled.
//
// What bounds it on an H100: operations. At the codec's shapes (Tq = Tk = 4096,
// C = 256 or 512) the two products are 4*Tq*Tk*C flops against 4*T*C*2 bytes of
// q, k, v and o, some 1000 flops per byte. This first version is the simple
// one: each CTA owns a block of query rows and walks every key tile; the bf16
// products run on the tensor cores through nvcuda::wmma (16x16x16 bf16, f32
// accumulation) from shared memory. The f32 accumulator for BQ x C lives in
// shared memory (at C = 512 the 64-row accumulator alone would be 128 KB), so
// BQ = 32 for bf16. The f32 instantiation is the parity path: plain fp32 FMAs,
// never TF32, with BQ = 16 so that its doubled tiles still fit. wgmma, TMA and
// warp specialisation are left for later.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (control_gic_tpu_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stddef.h>
#include <stdint.h>

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
  static constexpr int BQ = 32;   // query rows per CTA
  static constexpr int BK = 64;   // keys per tile
  static constexpr int PAD = 8;   // row padding (elements) of the q/kv tiles
};
template <>
struct Cfg<float> {
  static constexpr int BQ = 16;
  static constexpr int BK = 32;
  static constexpr int PAD = 1;   // odd stride: conflict-free column reads
};

__host__ __device__ inline size_t align_up(size_t x, size_t a) {
  return (x + a - 1) / a * a;
}

// Dynamic shared memory layout, in bytes from the base, and row strides in
// elements. Every region starts on 128 bytes (wmma wants 32).
struct Layout {
  size_t q, kv, s, p, o, m, l, corr, total;
  int ld;    // q and kv tiles (T)
  int lds;   // scores (float)
  int ldp;   // probabilities (T)
  int ldo;   // accumulator (float)
};

template <typename T>
__host__ __device__ inline Layout make_layout(int C) {
  using K = Cfg<T>;
  Layout L;
  L.ld = C + K::PAD;
  L.lds = K::BK + 4;
  L.ldp = K::BK + 8;
  L.ldo = C + 4;
  size_t off = 0;
  L.q = off;
  off = align_up(off + sizeof(T) * K::BQ * L.ld, 128);
  L.kv = off;
  off = align_up(off + sizeof(T) * K::BK * L.ld, 128);
  L.s = off;
  off = align_up(off + sizeof(float) * K::BQ * L.lds, 128);
  L.p = off;
  off = align_up(off + sizeof(T) * K::BQ * L.ldp, 128);
  L.o = off;
  off = align_up(off + sizeof(float) * K::BQ * L.ldo, 128);
  L.m = off;
  off += sizeof(float) * K::BQ;
  L.l = off;
  off += sizeof(float) * K::BQ;
  L.corr = off;
  off += sizeof(float) * K::BQ;
  L.total = align_up(off, 128);
  return L;
}

// Copy `rows` rows of C elements from global (row stride C) into shared memory
// (row stride ld); rows at or past `valid` are zero-filled.
template <typename T>
__device__ void load_rows(T* __restrict__ dst, int ld, const T* __restrict__ src,
                          int rows, int valid, int C) {
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

// S[BQ, BK] = Q K^T (unscaled), f32.
__device__ void qk_tile(const bf16* sQ, const bf16* sK, float* sS, const Layout& L, int C) {
  constexpr int BK = Cfg<bf16>::BK;
  constexpr int tiles = (Cfg<bf16>::BQ / 16) * (BK / 16);
  const int warp = threadIdx.x / 32;
  for (int t = warp; t < tiles; t += kWarps) {
    const int i = t / (BK / 16);
    const int j = t % (BK / 16);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < C; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(a, sQ + i * 16 * L.ld + kk, L.ld);
      wmma::load_matrix_sync(b, sK + j * 16 * L.ld + kk, L.ld);   // K^T
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(sS + i * 16 * L.lds + j * 16, acc, L.lds, wmma::mem_row_major);
  }
}

__device__ void qk_tile(const float* sQ, const float* sK, float* sS, const Layout& L, int C) {
  constexpr int BQ = Cfg<float>::BQ, BK = Cfg<float>::BK;
  for (int idx = threadIdx.x; idx < BQ * BK; idx += blockDim.x) {
    const int r = idx / BK;
    const int c = idx - r * BK;
    const float* qr = sQ + r * L.ld;
    const float* kr = sK + c * L.ld;
    float acc = 0.0f;
    for (int kk = 0; kk < C; ++kk) acc = fmaf(qr[kk], kr[kk], acc);
    sS[r * L.lds + c] = acc;
  }
}

// O[BQ, C] += P[BQ, BK] V[BK, C].
__device__ void pv_tile(const bf16* sP, const float* /*sS*/, const bf16* sV, float* sO,
                        const Layout& L, int C) {
  constexpr int BK = Cfg<bf16>::BK;
  const int ntile_c = C / 16;
  const int tiles = (Cfg<bf16>::BQ / 16) * ntile_c;
  const int warp = threadIdx.x / 32;
  for (int t = warp; t < tiles; t += kWarps) {
    const int i = t / ntile_c;
    const int j = t % ntile_c;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    float* o_ptr = sO + i * 16 * L.ldo + j * 16;
    wmma::load_matrix_sync(acc, o_ptr, L.ldo, wmma::mem_row_major);
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, sP + i * 16 * L.ldp + kk, L.ldp);
      wmma::load_matrix_sync(b, sV + kk * L.ld + j * 16, L.ld);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(o_ptr, acc, L.ldo, wmma::mem_row_major);
  }
}

__device__ void pv_tile(const float* /*sP*/, const float* sS, const float* sV, float* sO,
                        const Layout& L, int C) {
  constexpr int BQ = Cfg<float>::BQ, BK = Cfg<float>::BK;
  for (int idx = threadIdx.x; idx < BQ * C; idx += blockDim.x) {
    const int r = idx / C;
    const int c = idx - r * C;
    const float* p = sS + r * L.lds;
    float acc = 0.0f;
    for (int j = 0; j < BK; ++j) acc = fmaf(p[j], sV[j * L.ld + c], acc);
    sO[r * L.ldo + c] += acc;
  }
}

// One key tile of the online softmax, a warp per row. Scales S in place, writes
// p (bf16: into sP; f32: over S), and updates m, l and the rescale factor.
template <typename T>
__device__ void online_softmax(float* sS, T* sP, float* sM, float* sL, float* sCorr,
                               const Layout& L, int kvalid, float scale) {
  constexpr int BQ = Cfg<T>::BQ, BK = Cfg<T>::BK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < BQ; r += kWarps) {
    float* row = sS + r * L.lds;
    float mx = -INFINITY;
    for (int c = lane; c < BK; c += 32) {
      const float s = (c < kvalid) ? row[c] * scale : -INFINITY;
      row[c] = s;
      mx = fmaxf(mx, s);
    }
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_prev = sM[r];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.0f;
    for (int c = lane; c < BK; c += 32) {
      const float p = expf(row[c] - m_new);
      sum += p;
      if constexpr (sizeof(T) == 2) {
        sP[r * L.ldp + c] = __float2bfloat16(p);
      } else {
        row[c] = p;
      }
    }
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      const float corr = expf(m_prev - m_new);
      sCorr[r] = corr;
      sL[r] = sL[r] * corr + sum;
      sM[r] = m_new;
    }
  }
}

__device__ inline bf16 from_float(float x, bf16*) { return __float2bfloat16(x); }
__device__ inline float from_float(float x, float*) { return x; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int Tq, int Tk, int C,
                 float scale) {
  constexpr int BQ = Cfg<T>::BQ, BK = Cfg<T>::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout<T>(C);
  T* sQ = reinterpret_cast<T*>(smem + L.q);
  T* sKV = reinterpret_cast<T*>(smem + L.kv);
  float* sS = reinterpret_cast<float*>(smem + L.s);
  T* sP = reinterpret_cast<T*>(smem + L.p);
  float* sO = reinterpret_cast<float*>(smem + L.o);
  float* sM = reinterpret_cast<float*>(smem + L.m);
  float* sL = reinterpret_cast<float*>(smem + L.l);
  float* sCorr = reinterpret_cast<float*>(smem + L.corr);

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int qvalid = min(BQ, Tq - q0);
  const T* qb = q + ((size_t)b * Tq + q0) * C;
  const T* kb = k + (size_t)b * Tk * C;
  const T* vb = v + (size_t)b * Tk * C;

  load_rows(sQ, L.ld, qb, BQ, qvalid, C);
  for (int idx = threadIdx.x; idx < BQ * L.ldo; idx += blockDim.x) sO[idx] = 0.0f;
  for (int r = threadIdx.x; r < BQ; r += blockDim.x) {
    sM[r] = -INFINITY;
    sL[r] = 0.0f;
  }
  __syncthreads();

  for (int k0 = 0; k0 < Tk; k0 += BK) {
    const int kvalid = min(BK, Tk - k0);
    load_rows(sKV, L.ld, kb + (size_t)k0 * C, BK, kvalid, C);
    __syncthreads();
    qk_tile(sQ, sKV, sS, L, C);
    __syncthreads();
    online_softmax<T>(sS, sP, sM, sL, sCorr, L, kvalid, scale);
    __syncthreads();
    for (int idx = threadIdx.x; idx < BQ * C; idx += blockDim.x) {
      const int r = idx / C;
      sO[r * L.ldo + (idx - r * C)] *= sCorr[r];
    }
    load_rows(sKV, L.ld, vb + (size_t)k0 * C, BK, kvalid, C);
    __syncthreads();
    pv_tile(sP, sS, sKV, sO, L, C);
    __syncthreads();
  }

  T* ob = o + ((size_t)b * Tq + q0) * C;
  for (int idx = threadIdx.x; idx < qvalid * C; idx += blockDim.x) {
    const int r = idx / C;
    const int c = idx - r * C;
    ob[(size_t)r * C + c] = from_float(sO[r * L.ldo + c] / sL[r], (T*)nullptr);
  }
  if (lse != nullptr) {
    float* lb = lse + (size_t)b * Tq + q0;
    for (int r = threadIdx.x; r < qvalid; r += blockDim.x) lb[r] = sM[r] + logf(sL[r]);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int Tq,
           int Tk, int C, float scale, cudaStream_t stream) {
  const Layout L = make_layout<T>(C);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + Cfg<T>::BQ - 1) / Cfg<T>::BQ, B);
  flash_fwd_kernel<T><<<grid, kThreads, L.total, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), Tq, Tk, C, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. lse: null, or [B, Tq] f32 for the
// logsumexp. Returns 0 or a cudaError_t code; -1 for arguments the kernel does
// not take.
int cgic_flash_attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                        int B, int Tq, int Tk, int C, int dtype, float scale, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || C <= 0 || C % 16 != 0 || C > kMaxC) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<bf16>(q, k, v, o, lse, B, Tq, Tk, C, scale, s);
  if (dtype == 0) return launch<float>(q, k, v, o, lse, B, Tq, Tk, C, scale, s);
  return -1;
}

// Dynamic shared memory one CTA takes at head dim C.
long long cgic_flash_attn_smem_bytes(int C, int dtype) {
  return dtype == 1 ? (long long)make_layout<bf16>(C).total
                    : (long long)make_layout<float>(C).total;
}

const char* cgic_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

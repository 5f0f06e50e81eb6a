// Chained GroupNorm/SpatialNorm + swish + 3x3 conv [+ residual] [+ moments].
//
// Replaces the Pallas TPU kernel control_gic_tpu/ops/norm_conv.py::_kernel_chain
// (launched by _chain_forward_impl), both of its forms. For x NCHW [B, Cin, H, W]
// one launch computes, per output pixel and channel:
//   a   = (x.f32 - mean_c) * (rstd_c * gamma) + beta             (GroupNorm)
//   a   = a * (zq.wy + by) + (zq.wb + bb)   f32, Z = 4          (SpatialNorm form)
//   a   = a * 1 / (1 + exp(-a))                                  (swish)
//   out = conv3x3_SAME(a cast to x's dtype) + bias [+ res]       (f32 accumulation)
// rounds out to x's dtype and stores it, and optionally writes the per-channel
// (sum, sumsq) of the stored, rounded output as per-CTA partials
// [B, n_tiles, 2, Cout] f32, which the wrapper sums over the tile axis in a fixed
// order. The padding of the conv is zero AFTER the activation (act(0) != 0).
//
// What bounds it on an H100: operations. At the codec's shapes (Cin, Cout of
// 128 or 256 at 512x768 and 256x384) the conv is 2*9*Cin*Cout flops per pixel
// against 2*(Cin + 2*Cout) bytes, 500 to 1000 flops per byte in bf16; only the
// conv_out shape (Cout = 3) is bound by the bytes of x. So the design is an
// implicit GEMM on the tensor cores: M = output pixels, N = Cout, K = 9*Cin.
//   - A CTA owns an output tile of TH x 16 pixels (one 16-row MMA block per
//     image row) and BN output channels. For each chunk of KC input channels
//     it loads the (TH+2) x 18 halo tile of x, applies normalize, modulate and
//     swish ONCE per element while storing it to shared memory in the compute
//     dtype, pixel-major with channels contiguous, and loads the 9 taps x KC x
//     BN weights. The 3x3 conv is then 9 shifted products that read the same
//     activated tile: a shift by (dy, dx) is only an offset of the rows that
//     ldmatrix gathers, so no halo copies and no im2col buffer exist.
//   - bf16: mma.sync m16n8k16 (bf16 in, f32 accumulate), operands loaded with
//     ldmatrix (x4 for A, x4.trans for B stored k-major), 8 warps as 4 (M) x 2
//     (N), a warp tile of 32 pixels x 64 channels. f32 is the parity path:
//     plain FMAs, never TF32, with the same tiles and loader.
//   - Cout <= 8 (the decoder's conv_out, Cout = 3) takes a narrow instantiation
//     (BN = 8, 16 x 16 pixel tiles); the wrapper pads the weights and bias with
//     zeros up to BN and only the real channels are stored.
//   - The epilogue stages the f32 accumulators through shared memory as
//     [channel][pixel], so the bias, the residual read and the store are
//     coalesced along W, and the moments are a fixed-order warp reduction of
//     the rounded values: no float atomics, bit-stable from run to run.
// The Pallas kernel's row blocks and its XLA-gathered halo rows (_halo_rows)
// were shaped for TPU VMEM and do not carry over. wgmma, TMA and a pipelined
// loader are later work.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (control_gic_tpu_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int TW = 16;     // output columns per tile: one m16 block per image row
constexpr int HWD = TW + 2;
constexpr int Z = 4;       // zq channels of the SpatialNorm form
constexpr int kMaxCin = 512;

// Output tile per CTA: TH rows x TW cols of pixels, BN output channels, 8 warps
// as WARPS_M x WARPS_N.
template <int BN>
struct Tile;
template <>
struct Tile<128> {
  static constexpr int TH = 8, WARPS_M = 4, WARPS_N = 2;
};
template <>
struct Tile<8> {
  static constexpr int TH = 16, WARPS_M = 8, WARPS_N = 1;
};

// Input channels per chunk and shared-memory row strides (elements), chosen so
// that ldmatrix (bf16) and the FMA loop (f32) read without bank conflicts.
template <typename T, int BN>
struct Strides;
template <int BN>
struct Strides<bf16, BN> {
  static constexpr int KC = 32;
  static constexpr int LDA = KC + 8;                // 80 B per halo pixel
  static constexpr int LDB = BN == 8 ? 24 : BN + 8;  // 48 or 272 B per k row
};
template <int BN>
struct Strides<float, BN> {
  static constexpr int KC = 16;
  static constexpr int LDA = KC + 1;
  static constexpr int LDB = BN + 4;
};

__host__ __device__ inline size_t align_up(size_t x, size_t a) { return (x + a - 1) / a * a; }

// Dynamic shared memory, byte offsets: per-channel parameters and the zq tile
// live for the whole CTA; the activated tile + weights of the main loop share
// their space with the f32 epilogue tile.
struct Layout {
  size_t p, z, a, b, c, total;
};

template <typename T, int BN>
__host__ __device__ inline Layout make_layout(int Cin, int modulate) {
  constexpr int TH = Tile<BN>::TH, M = TH * TW, HP = (TH + 2) * HWD;
  using S = Strides<T, BN>;
  Layout L;
  size_t off = 0;
  L.p = off;
  off = align_up(off + sizeof(float) * (modulate ? 13 : 3) * Cin, 128);
  L.z = off;
  if (modulate) off = align_up(off + sizeof(float) * HP * Z, 128);
  L.a = off;
  L.b = align_up(off + sizeof(T) * HP * S::LDA, 128);
  const size_t main_end = L.b + sizeof(T) * 9 * S::KC * S::LDB;
  L.c = off;
  const size_t epi_end = off + sizeof(float) * BN * (M + 4);
  L.total = align_up(main_end > epi_end ? main_end : epi_end, 128);
  return L;
}

__device__ inline float to_f(float v) { return v; }
__device__ inline float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ inline T from_f(float v);
template <>
__device__ inline float from_f<float>(float v) { return v; }
template <>
__device__ inline bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ inline void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ inline void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ inline void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The products of one input-channel chunk, accumulated into the f32 tile that
// each instantiation keeps in registers, then written to sC[n][m] (row stride
// LDC) once the chunk loop is over.
template <typename T, int BN>
struct Accum;

template <int BN>
struct Accum<bf16, BN> {
  static constexpr int TH = Tile<BN>::TH, WARPS_M = Tile<BN>::WARPS_M,
                       WARPS_N = Tile<BN>::WARPS_N;
  static constexpr int MT = TH / WARPS_M;        // m16 blocks (image rows) per warp
  static constexpr int NT = BN / (WARPS_N * 8);  // n8 blocks per warp
  using S = Strides<bf16, BN>;
  float acc[MT][NT][4];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;
  }

  __device__ void chunk(const bf16* sA, const bf16* sB) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = warp % WARPS_M, wn = warp / WARPS_M;
#pragma unroll 1
    for (int t = 0; t < 9; ++t) {
      const int dy = t / 3, dx = t - 3 * (t / 3);
#pragma unroll
      for (int ks = 0; ks < S::KC / 16; ++ks) {
        uint32_t af[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int pix = (wm * MT + i + dy) * HWD + dx + (lane & 15);
          ldmatrix_x4(af[i], sA + pix * S::LDA + ks * 16 + (lane >> 4) * 8);
        }
        uint32_t bfr[NT][2];
        const bf16* brow = sB + (t * S::KC + ks * 16 + (lane & 15)) * S::LDB + wn * NT * 8;
        if constexpr (NT % 2 == 0) {
#pragma unroll
          for (int j = 0; j < NT / 2; ++j) {
            uint32_t r[4];
            ldmatrix_x4_trans(r, brow + j * 16 + (lane >> 4) * 8);
            bfr[2 * j][0] = r[0];
            bfr[2 * j][1] = r[1];
            bfr[2 * j + 1][0] = r[2];
            bfr[2 * j + 1][1] = r[3];
          }
        } else {
#pragma unroll
          for (int j = 0; j < NT; ++j) ldmatrix_x2_trans(bfr[j], brow + j * 8);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], af[i], bfr[j]);
      }
    }
  }

  // C fragment: c0, c1 at (row g, cols 2q, 2q+1), c2, c3 at row g + 8; rows are
  // pixels of one image row, cols are output channels.
  __device__ void store(float* sC, int LDC) const {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = warp % WARPS_M, wn = warp / WARPS_M;
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int m = (wm * MT + i) * TW + g;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = wn * NT * 8 + j * 8 + 2 * q;
        sC[n * LDC + m] = acc[i][j][0];
        sC[(n + 1) * LDC + m] = acc[i][j][1];
        sC[n * LDC + m + 8] = acc[i][j][2];
        sC[(n + 1) * LDC + m + 8] = acc[i][j][3];
      }
    }
  }
};

template <int BN>
struct Accum<float, BN> {
  static constexpr int TH = Tile<BN>::TH, M = TH * TW;
  static constexpr int NG = BN / 4;            // threads along N, 4 channels each
  static constexpr int MG = kThreads / NG;     // threads along M
  static constexpr int TM = M / MG;            // consecutive pixels per thread
  static_assert(TW % TM == 0, "a thread's pixels lie in one image row");
  using S = Strides<float, BN>;
  float acc[TM][4];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;
  }

  __device__ void chunk(const float* sA, const float* sB) {
    const int ng = threadIdx.x % NG, mg = threadIdx.x / NG;
    const int m0 = mg * TM, row = m0 / TW, col = m0 % TW;
#pragma unroll 1
    for (int t = 0; t < 9; ++t) {
      const int dy = t / 3, dx = t - 3 * (t / 3);
      const float* arow = sA + ((row + dy) * HWD + col + dx) * S::LDA;
#pragma unroll 4
      for (int k = 0; k < S::KC; ++k) {
        const float4 bv = *reinterpret_cast<const float4*>(sB + (t * S::KC + k) * S::LDB + ng * 4);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float a = arow[i * S::LDA + k];
          acc[i][0] = fmaf(a, bv.x, acc[i][0]);
          acc[i][1] = fmaf(a, bv.y, acc[i][1]);
          acc[i][2] = fmaf(a, bv.z, acc[i][2]);
          acc[i][3] = fmaf(a, bv.w, acc[i][3]);
        }
      }
    }
  }

  __device__ void store(float* sC, int LDC) const {
    const int ng = threadIdx.x % NG, mg = threadIdx.x / NG;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) sC[(ng * 4 + q) * LDC + mg * TM + i] = acc[i][q];
  }
};

struct Args {
  const void* x;       // [B, Cin, H, W] T
  const void* zq;      // [B, Z, H, W] T (SpatialNorm form) or null
  const float* mean;   // [B, Cin]
  const float* rstd;   // [B, Cin]
  const float* gamma;  // [Cin]
  const float* beta;   // [Cin]
  const float* wy;     // [Z, Cin] (SpatialNorm form)
  const float* by;     // [Cin]
  const float* wb;     // [Z, Cin]
  const float* bb;     // [Cin]
  const void* w;       // [9, Cin, CoutP] T, tap-major (dy, dx)
  const float* bias;   // [CoutP]
  const void* res;     // [B, Cout, H, W] T or null
  void* out;           // [B, Cout, H, W] T
  float* mom;          // [B, n_tiles, 2, Cout] or null
  int Cin, Cout, CoutP, H, W, tiles_x, n_tiles, modulate, swish;
};

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads, 2) chain_kernel(const Args args) {
  constexpr int TH = Tile<BN>::TH, M = TH * TW, HP = (TH + 2) * HWD, LDC = M + 4;
  using S = Strides<T, BN>;
  constexpr int KC = S::KC, LDA = S::LDA, LDB = S::LDB;
  constexpr int VEC = 16 / sizeof(T);

  const int Cin = args.Cin, H = args.H, W = args.W, Cout = args.Cout;
  const int b = blockIdx.z, n0 = blockIdx.y * BN, tile = blockIdx.x;
  const int ty = tile / args.tiles_x, tx = tile - ty * args.tiles_x;
  const int y0 = ty * TH, x0 = tx * TW;
  const bool modulate = args.modulate != 0, swish = args.swish != 0;
  const T* __restrict__ x = static_cast<const T*>(args.x) + (size_t)b * Cin * H * W;
  const T* __restrict__ w = static_cast<const T*>(args.w);

  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout<T, BN>(Cin, args.modulate);
  float* sMean = reinterpret_cast<float*>(smem + L.p);
  float* sScale = sMean + Cin;
  float* sBeta = sMean + 2 * Cin;
  float* sWy = sMean + 3 * Cin;    // [Z][Cin]
  float* sBy = sMean + 7 * Cin;
  float* sWb = sMean + 8 * Cin;    // [Z][Cin]
  float* sBb = sMean + 12 * Cin;
  float* sZ = reinterpret_cast<float*>(smem + L.z);   // [HP][Z]
  T* sA = reinterpret_cast<T*>(smem + L.a);           // [HP][LDA]
  T* sB = reinterpret_cast<T*>(smem + L.b);           // [9 * KC][LDB]
  float* sC = reinterpret_cast<float*>(smem + L.c);   // [BN][LDC]

  for (int c = threadIdx.x; c < Cin; c += kThreads) {
    sMean[c] = args.mean[(size_t)b * Cin + c];
    sScale[c] = args.rstd[(size_t)b * Cin + c] * args.gamma[c];
    sBeta[c] = args.beta[c];
    if (modulate) {
#pragma unroll
      for (int z = 0; z < Z; ++z) {
        sWy[z * Cin + c] = args.wy[z * Cin + c];
        sWb[z * Cin + c] = args.wb[z * Cin + c];
      }
      sBy[c] = args.by[c];
      sBb[c] = args.bb[c];
    }
  }
  if (modulate) {
    const T* zq = static_cast<const T*>(args.zq) + (size_t)b * Z * H * W;
    for (int p = threadIdx.x; p < HP; p += kThreads) {
      const int r = p / HWD, col = p - r * HWD;
      const int y = y0 - 1 + r, xx = x0 - 1 + col;
      const bool in = y >= 0 && y < H && xx >= 0 && xx < W;
#pragma unroll
      for (int z = 0; z < Z; ++z)
        sZ[p * Z + z] = in ? to_f(zq[((size_t)z * H + y) * W + xx]) : 0.0f;
    }
  }
  __syncthreads();

  Accum<T, BN> acc;
  acc.zero();
  for (int c0 = 0; c0 < Cin; c0 += KC) {
    // the activated halo tile of this channel chunk, zero outside the image
    for (int idx = threadIdx.x; idx < KC * HP; idx += kThreads) {
      const int c = idx / HP, p = idx - c * HP;
      const int r = p / HWD, col = p - r * HWD;
      const int y = y0 - 1 + r, xx = x0 - 1 + col;
      float a = 0.0f;
      if (y >= 0 && y < H && xx >= 0 && xx < W) {
        const int ch = c0 + c;
        a = (to_f(x[((size_t)ch * H + y) * W + xx]) - sMean[ch]) * sScale[ch] + sBeta[ch];
        if (modulate) {
          const float* zp = sZ + p * Z;
          float ym = zp[0] * sWy[ch];
          float bm = zp[0] * sWb[ch];
#pragma unroll
          for (int z = 1; z < Z; ++z) {
            ym = fmaf(zp[z], sWy[z * Cin + ch], ym);
            bm = fmaf(zp[z], sWb[z * Cin + ch], bm);
          }
          a = a * (ym + sBy[ch]) + (bm + sBb[ch]);
        }
        if (swish) a = a * (1.0f / (1.0f + expf(-a)));
      }
      sA[p * LDA + c] = from_f<T>(a);
    }
    // the 9 x KC x BN weights of this chunk, 16-byte vectors along N
    for (int idx = threadIdx.x; idx < 9 * KC * (BN / VEC); idx += kThreads) {
      const int row = idx / (BN / VEC), v = idx - row * (BN / VEC);
      const int t = row / KC, k = row - t * KC;
      const uint4 u = *reinterpret_cast<const uint4*>(
          w + ((size_t)t * Cin + c0 + k) * args.CoutP + n0 + v * VEC);
      *reinterpret_cast<uint4*>(sB + row * LDB + v * VEC) = u;
    }
    __syncthreads();
    acc.chunk(sA, sB);
    __syncthreads();
  }

  // epilogue: + bias [+ res], round to T, store; keep the rounded values
  acc.store(sC, LDC);
  __syncthreads();
  T* out = static_cast<T*>(args.out);
  const T* res = static_cast<const T*>(args.res);
  for (int idx = threadIdx.x; idx < BN * M; idx += kThreads) {
    const int n = idx / M, m = idx - n * M;
    const int y = y0 + m / TW, xx = x0 + m % TW, co = n0 + n;
    float v = 0.0f;
    if (y < H && xx < W && co < Cout) {
      const size_t o = (((size_t)b * Cout + co) * H + y) * W + xx;
      v = sC[n * LDC + m] + args.bias[co];
      if (res) v += to_f(res[o]);
      const T vt = from_f<T>(v);
      out[o] = vt;
      v = to_f(vt);
    }
    sC[n * LDC + m] = v;
  }
  if (args.mom) {
    __syncthreads();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int n = warp; n < BN; n += kWarps) {
      float s1 = 0.0f, s2 = 0.0f;
      for (int m = lane; m < M; m += 32) {
        const float v = sC[n * LDC + m];
        s1 += v;
        s2 += v * v;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        s2 += __shfl_xor_sync(0xffffffffu, s2, off);
      }
      const int co = n0 + n;
      if (lane == 0 && co < Cout) {
        float* mp = args.mom + ((size_t)b * args.n_tiles + tile) * 2 * Cout;
        mp[co] = s1;
        mp[Cout + co] = s2;
      }
    }
  }
}

inline int block_n(int Cout) { return Cout <= 8 ? 8 : 128; }

template <int BN>
inline int n_tiles(int H, int W) {
  return ((H + Tile<BN>::TH - 1) / Tile<BN>::TH) * ((W + TW - 1) / TW);
}

template <typename T, int BN>
int launch(Args a, int B, cudaStream_t stream) {
  const Layout L = make_layout<T, BN>(a.Cin, a.modulate);
  cudaError_t err = cudaFuncSetAttribute(chain_kernel<T, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.total);
  if (err != cudaSuccess) return (int)err;
  a.tiles_x = (a.W + TW - 1) / TW;
  a.n_tiles = n_tiles<BN>(a.H, a.W);
  const dim3 grid(a.n_tiles, a.CoutP / BN, B);
  chain_kernel<T, BN><<<grid, kThreads, L.total, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Output channels per CTA for a given Cout: the wrapper pads the packed
// weights and the bias to a multiple of it.
int cgic_norm_conv_chain_block_n(int Cout) { return block_n(Cout); }

// Spatial tiles per image: the second dim of the moment partials.
int cgic_norm_conv_chain_tiles(int H, int W, int Cout) {
  return block_n(Cout) == 8 ? n_tiles<8>(H, W) : n_tiles<128>(H, W);
}

// dtype: 0 = float32, 1 = bfloat16. zq, wy, by, wb, bb may be null when
// modulate = 0; res and mom may be null. Returns 0 or a cudaError_t code; -1
// for arguments the kernel does not take.
int cgic_norm_conv_chain(const void* x, const void* zq, const float* mean, const float* rstd,
                         const float* gamma, const float* beta, const float* wy,
                         const float* by, const float* wb, const float* bb, const void* w,
                         const float* bias, const void* res, void* out, float* mom, int B,
                         int Cin, int Cout, int CoutP, int H, int W, int dtype, int modulate,
                         int swish, void* stream) {
  const int BN = block_n(Cout);
  if (B <= 0 || B > 65535 || Cin <= 0 || Cin % 32 || Cin > kMaxCin || Cout <= 0 || H <= 0 ||
      W <= 0 || CoutP % BN || CoutP < Cout || CoutP / BN > 65535)
    return -1;
  if (modulate && !(zq && wy && by && wb && bb)) return -1;
  Args a{x, zq, mean, rstd, gamma, beta, wy, by, wb, bb, w, bias, res, out, mom,
         Cin, Cout, CoutP, H, W, 0, 0, modulate, swish};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return BN == 8 ? launch<bf16, 8>(a, B, s) : launch<bf16, 128>(a, B, s);
  if (dtype == 0) return BN == 8 ? launch<float, 8>(a, B, s) : launch<float, 128>(a, B, s);
  return -1;
}

const char* cgic_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

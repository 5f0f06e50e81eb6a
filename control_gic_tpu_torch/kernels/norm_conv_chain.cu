// Chained GroupNorm/SpatialNorm + swish + 3x3 conv [+ residual] [+ moments],
// written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels control_gic_tpu/ops/norm_conv.py:136
// _kernel_chain (the chain, both norm forms) and :79 _kernel (the per-call op:
// the same pass with no residual and no moments). For x NCHW [B, Cin, H, W] one
// launch computes, per output pixel and channel:
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
// 128 to 512) the conv is 2*9*Cin*Cout flops per pixel against 2*(Cin + 2*Cout)
// bytes, 500 to 1000 flops per byte in bf16, above the card's ~295. Only the
// conv_out shapes (Cout = 3 or 4) are bound by the bytes of x.
//
// bf16 path (chain_kernel_wgmma<BN>): an implicit GEMM, M = output pixels,
// N = Cout, K = 9*Cin, on wgmma. A CTA owns TH rows x TW = 64 columns of output
// pixels and BN output channels, and runs 256 threads: two warpgroups, whose
// thread 0 also issues the weight copies.
//  - Loads: for each chunk of KC = 32 input channels the raw halo box of x,
//    KC x (TH+2) rows x 80 columns from the 16-byte aligned x0 - 8 (the 66
//    halo columns inside), by 16-byte cp.async vectors of every thread into
//    a 2-stage ring, two chunks ahead of its transform (plain loads where W
//    is not a multiple of 8); and the weights of each (tap, chunk) pair, KC x
//    BN, by a 1-D TMA bulk copy (cp.async.bulk) from the wrapper's packing
//    into an mbarrier ring of 9 stages (7 for BN = 256). A tiled TMA box for x
//    was tried first: on the H100 a box at a negative coordinate (the halo
//    left of or above the image) raised an illegal instruction, and boxes
//    clamped into the image still did inside this kernel, so x takes
//    cp.async.
//    Why no producer warp: for a kernel with wgmma, ptxas allots registers
//    per warpgroup, so 288 threads (a producer warp beside two warpgroups)
//    compiled below the registers it needs and spilled; 256 threads leave
//    255, and the wide instantiations use ~254 without a spill.
//  - Transform: both warpgroups read the raw tile, apply normalize, modulate and
//    swish ONCE per element in f32, write 0 at every position outside the image
//    (the halo rule; the loads' zero fill is not enough, act(0) != 0), round
//    to bf16 and store the activated tile as [KC/8][halo pixel][8 channels]:
//    16 bytes per (pixel, channel group), consecutive threads on consecutive
//    pixels, so the stores are free of bank conflicts.
//  - Products: wgmma.mma_async m64nBNk16, both operands from shared memory
//    (SS form) in the no-swizzle K-major layout: a core matrix is 8 rows of 16
//    bytes, the 8-row groups 128 bytes apart. In that layout the rows of any
//    pixel run are 16 bytes apart, so the shift of a tap by (dy, dx) is only
//    the descriptor's start address: tap (dy, dx) of the m64 block of tile row
//    r starts at halo pixel (r + dy) * 66 + dx. No shifted copies, no im2col.
//    Why SS and not the RS form (A from registers, fed by ldmatrix): the RS
//    form would hold A fragments in registers while the products are in
//    flight, beside the 128 accumulator registers a thread; SS leaves those
//    registers free for the transform, below.
//  - Overlap: the transform of chunk c+1 runs in the warpgroups that
//    multiply, while the tensor cores run chunk c. Each of the 9 taps waits
//    for its weights, issues its wgmmas and commits them; taps 0 .. TAPS-1
//    then transform SLICE items of chunk c+1 (IPT a thread, the fewest that
//    cover the chunk in 9 taps: 1 at BN = 128 and 256, 2 at BN = 8) into the
//    other activated buffer; the tap waits for the previous tap's group
//    (wait_group 1), releases that tap's weight stage (one arrival a warp),
//    and, once every warp is past tap k - 3, thread 0 refills that stage with
//    tap k - 3 + WS: two taps of slack between the warpgroups, WS - 3 of lead
//    for the copy. Measured on the H100: a refill waited for by warp 0 alone
//    ran 5-8% slower; one tap of slack, or two items a thread a tap, no
//    faster; 9 stages in place of 7 at BN = 128 1-2% faster. Neither
//    dedicated transform warps nor a ping-pong between the warpgroups: a
//    third warpgroup would cut the register cap of all threads below the 128
//    accumulators plus the transform's registers, and a ping-pong would
//    halve the M each warpgroup owns.
//  - What keeps the products asynchronous: ptxas serialises every wgmma of a
//    kernel (each product waited for before the next instruction) when code
//    between a product and its wait_group may run on a divergent path. The
//    first version of this loop had such paths (spin-waits with a trap
//    branch, thread 0's blocking refill, lane-0 arrivals, the transform's
//    thread-strided loop and halo branch), and ptxas serialised all three
//    instantiations (C7518, "program dependence on compiler-inserted WG.DP in
//    divergent path"); it ran 1.2-1.3x slower than this one. So every
//    instruction of the main loop runs warp-converged: the ring's waits are
//    warp-uniform (every lane tries the barrier, vote.all, a branch marked
//    uniform, the trap a predicated instruction); the arrivals, the bulk
//    copies and the masked stores are predicated instructions, not branches;
//    the transform takes a compile-time count of items a thread, computes the
//    masked tail at a clamped index and applies the halo rule as a select.
//    The products keep the (chunk, tap, k16) order, so outputs and moments are
//    those of the serialised kernel, bit for bit.
//  - Tiles: a warpgroup owns MB m64 blocks, one image row of 64 pixels each,
//    with MB * BN / 2 f32 accumulators a thread: BN = 128 (Cout 9..128): MB = 2,
//    TH = 4, 256 pixels; BN = 256 (Cout 129..256): MB = 1, TH = 2, 128 pixels,
//    so Cout = 256 is activated once; Cout = 512 (per-call only) runs two CTAs
//    along N (grid.y), each 128 x 256, and each activates x again; BN = 8 (Cout
//    <= 8, conv_out): MB = 4, TH = 8, 512 pixels, the same kernel at n8, where
//    the transform, not the products, takes most of the time. Two variants
//    ran slower on the H100 (both with the products serialised): 4 transform
//    items a thread at a time, and 256-pixel tiles with 16-channel chunks at
//    128 registers, two CTAs an SM.
//  - Shared memory (Cin = 512, SpatialNorm form): parameters 13*Cin*4 = 26.6
//    KB, the zq halo 16 B a pixel, raw ring 2 x 20-51 KB, activated tiles 2 x
//    17-42 KB, weight ring 9 x 8 KB (BN = 128), 7 x 16 KB (BN = 256), 9 x 0.5
//    KB (BN = 8): 219-229 KB of the 232 KB, one CTA an SM.
//  - Epilogue: the accumulators are staged through shared memory as
//    [channel][pixel] (aliasing the rings), then bias, residual, rounding and
//    the store run along W in 16-byte vectors (scalar where W is not a
//    multiple of 8), and the moments are a fixed-order warp reduction of the
//    rounded values: no float atomics, bit-stable from run to run.
//
// f32 path (namespace parity, chain_kernel<float, BN>): the parity runs' dtype,
// plain FMAs and never TF32; PR 2's design, unchanged: 8 x 16 pixel tiles
// (16 x 16 at BN = 8), the activation applied while the halo is loaded.
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

constexpr int Z = 4;       // zq channels of the SpatialNorm form
constexpr int kMaxCin = 512;
constexpr size_t kMaxSmem = 232448;

__host__ __device__ inline size_t align_up(size_t x, size_t a) { return (x + a - 1) / a * a; }

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
  const void* w;       // packed weights: f32 [9, Cin, CoutP]; bf16 see pack below
  const float* bias;   // [CoutP]
  const void* res;     // [B, Cout, H, W] T or null
  void* out;           // [B, Cout, H, W] T
  float* mom;          // [B, n_tiles, 2, Cout] or null
  int Cin, Cout, CoutP, H, W, tiles_x, n_tiles, modulate, swish, x_vec;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// =========================================================== f32 parity path

namespace parity {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int TW = 16;     // output columns per tile
constexpr int HWD = TW + 2;

template <int BN>
struct Tile;
template <>
struct Tile<128> {
  static constexpr int TH = 8;
};
template <>
struct Tile<8> {
  static constexpr int TH = 16;
};

// Input channels per chunk and shared-memory row strides (floats), chosen so
// that the FMA loop reads without bank conflicts.
template <int BN>
struct Strides {
  static constexpr int KC = 16;
  static constexpr int LDA = KC + 1;
  static constexpr int LDB = BN + 4;
};

// Dynamic shared memory, byte offsets: per-channel parameters and the zq tile
// live for the whole CTA; the activated tile + weights of the main loop share
// their space with the f32 epilogue tile.
struct Layout {
  size_t p, z, a, b, c, total;
};

template <int BN>
__host__ __device__ inline Layout make_layout(int Cin, int modulate) {
  constexpr int TH = Tile<BN>::TH, M = TH * TW, HP = (TH + 2) * HWD;
  using S = Strides<BN>;
  Layout L;
  size_t off = 0;
  L.p = off;
  off = align_up(off + sizeof(float) * (modulate ? 13 : 3) * Cin, 128);
  L.z = off;
  if (modulate) off = align_up(off + sizeof(float) * HP * Z, 128);
  L.a = off;
  L.b = align_up(off + sizeof(float) * HP * S::LDA, 128);
  const size_t main_end = L.b + sizeof(float) * 9 * S::KC * S::LDB;
  L.c = off;
  const size_t epi_end = off + sizeof(float) * BN * (M + 4);
  L.total = align_up(main_end > epi_end ? main_end : epi_end, 128);
  return L;
}

// The products of one input-channel chunk, accumulated into the f32 tile that
// each thread keeps in registers, then written to sC[n][m] (row stride LDC)
// once the chunk loop is over.
template <int BN>
struct Accum {
  static constexpr int TH = Tile<BN>::TH, M = TH * TW;
  static constexpr int NG = BN / 4;            // threads along N, 4 channels each
  static constexpr int MG = kThreads / NG;     // threads along M
  static constexpr int TM = M / MG;            // consecutive pixels per thread
  static_assert(TW % TM == 0, "a thread's pixels lie in one image row");
  using S = Strides<BN>;
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

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads, 2) chain_kernel(const Args args) {
  constexpr int TH = Tile<BN>::TH, M = TH * TW, HP = (TH + 2) * HWD, LDC = M + 4;
  using S = Strides<BN>;
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
  const Layout L = make_layout<BN>(Cin, args.modulate);
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
        sZ[p * Z + z] = in ? zq[((size_t)z * H + y) * W + xx] : 0.0f;
    }
  }
  __syncthreads();

  Accum<BN> acc;
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
        a = (x[((size_t)ch * H + y) * W + xx] - sMean[ch]) * sScale[ch] + sBeta[ch];
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
      sA[p * LDA + c] = a;
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

  // epilogue: + bias [+ res], store; keep the stored values
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
      if (res) v += res[o];
      out[o] = v;
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

template <int BN>
int launch(Args a, int B, cudaStream_t stream) {
  const Layout L = make_layout<BN>(a.Cin, a.modulate);
  cudaError_t err = cudaFuncSetAttribute(chain_kernel<float, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.total);
  if (err != cudaSuccess) return (int)err;
  a.tiles_x = (a.W + TW - 1) / TW;
  a.n_tiles = n_tiles<BN>(a.H, a.W);
  const dim3 grid(a.n_tiles, a.CoutP / BN, B);
  chain_kernel<float, BN><<<grid, kThreads, L.total, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace parity

// =============================================================== bf16 path

// a pipeline wait that never completes traps (a launch error) instead of
// hanging the card
constexpr uint32_t kSpinLimit = 1u << 26;

constexpr int KC = 32;                      // input channels a chunk
constexpr int TW = 64;                      // output columns a tile: one m64 block
constexpr int HWD = TW + 2;                 // halo columns
constexpr int RW = 80;                      // raw stage row: 10 aligned 16-byte vectors
constexpr int kThreads = 256;               // two warpgroups
constexpr int RS = 2;                       // raw x stages
constexpr int LAG = 3;                      // tap k refills the weight stage of tap k - LAG

template <int BN>
struct Cfg {
  static constexpr int MB = BN == 8 ? 4 : 256 / BN;   // m64 blocks (tile rows) a warpgroup
  static constexpr int TH = 2 * MB;
  static constexpr int M = TH * TW;
  static constexpr int HP = (TH + 2) * HWD;           // halo pixels
  static constexpr int NA = BN / 2;                   // accumulators a thread, per m64 block
  static constexpr int WS = BN == 256 ? 7 : 9;        // weight stages
  static constexpr uint32_t RAW = KC * (TH + 2) * RW * 2;    // [KC][TH+2][RW] bf16
  static constexpr uint32_t ACT = KC * HP * 2;               // [KC/8][HP][8] bf16
  static constexpr uint32_t WST = KC * BN * 2;               // [KC/8][BN][8] bf16
  static constexpr int LDC = M + 4;                          // epilogue row stride (floats)
  static constexpr uint32_t RING = RS * RAW + 2 * ACT + WS * WST;
  static constexpr int ITEMS = HP * (KC / 8);                // transform items a chunk
  // items a thread in a tap that transforms: the fewest that cover a chunk
  // in 9 taps; taps 0 .. TAPS-1 transform SLICE items each, the last masked
  static constexpr int IPT = (ITEMS + 9 * kThreads - 1) / (9 * kThreads);
  static constexpr int SLICE = IPT * kThreads;
  static constexpr int TAPS = (ITEMS + SLICE - 1) / SLICE;
  static_assert(WS > LAG, "the ring holds the taps in flight");
  static_assert(BN * LDC * 4 <= (int)RING, "the epilogue tile fits the rings");
  static_assert(RAW % 128 == 0 && ACT % 128 == 0 && WST % 128 == 0, "aligned stages");
};

struct WLayout {
  uint32_t p, z, bar, ring, total;
};

template <int BN>
__host__ __device__ inline WLayout wlayout(int Cin, int modulate) {
  using K = Cfg<BN>;
  WLayout L;
  L.p = 0;
  uint32_t off = (uint32_t)align_up(4u * (modulate ? 13 : 3) * Cin, 128);
  L.z = off;
  if (modulate) off = (uint32_t)align_up(off + 16u * K::HP, 128);
  L.bar = off;
  off = (uint32_t)align_up(off + 8u * 2 * K::WS, 128);
  L.ring = off;
  L.total = off + K::RING + 128;   // + the alignment of the base
  return L;
}

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// The warp waits for the phase of the given parity to complete. Every lane
// tries the barrier, and the warp leaves only once all of them have seen the
// phase (vote.all), on a branch marked uniform: no path of the loop is
// divergent, so ptxas can keep wgmma products in flight across it. A wait
// that never completes traps (a launch error) instead of hanging the card; the
// trap is a predicated instruction, not a branch.
__device__ __forceinline__ void mbar_wait_warp(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p, q;\n.reg .u32 n;\nmov.u32 n, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "vote.sync.all.pred p, p, 0xffffffff;\n"
      "@p bra.uni DONE;\n"
      "add.u32 n, n, 1;\n"
      "setp.gt.u32 q, n, %2;\n"
      "@q trap;\n"
      "bra.uni WAIT;\n"
      "DONE:\n}\n" ::"r"(bar),
      "r"(parity), "n"(kSpinLimit)
      : "memory");
}

// One arrival on the barrier from the threads where `on` holds, by a
// predicated instruction.
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool on) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"((int)on)
      : "memory");
}

// `bytes` from src into shared memory at dst by a 1-D TMA bulk copy that
// completes on the barrier bar, issued by the threads where `issue` holds (the
// expected bytes announced first), by predicated instructions.
__device__ __forceinline__ void bulk_load_if(uint32_t dst, const void* src, uint32_t bytes,
                                             uint32_t bar, bool issue) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%1], %2;\n"
      "@p cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%3], [%4], %2, "
      "[%1];\n}\n" ::"r"((int)issue),
      "r"(bar), "r"(bytes), "r"(dst), "l"(src)
      : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// generic-proxy writes to shared memory made visible to the async proxy
// (wgmma reads, TMA writes), and the reverse
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// An opaque copy: the compiler cannot hoist what is computed from it.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// a 16-byte store to shared memory where `on` holds, predicated
__device__ __forceinline__ void st_shared_v4_if(uint32_t addr, uint4 v, bool on) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %5, 0;\n"
      "@p st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n}\n" ::"r"(addr),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"((int)on)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma accumulators across
// the asynchronous products.
template <int MB, int N>
__device__ __forceinline__ void fence_acc(float (&r)[MB][N]) {
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[m][i])::"memory");
}

// wgmma shared-memory descriptor, no swizzle: start address, leading byte
// offset (between the two 8-element core matrices of a k16 slice, along K)
// and stride byte offset (between 8-row groups, along M or N), in 16-byte
// units; layout type 0.
__device__ __forceinline__ uint64_t desc_nosw(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// D[64 x N] += A[64 x 16] B[16 x N], A and B from shared memory, both K-major.
// d holds the thread's N/2 accumulators: d[i] is row 16*warp + lane/4 +
// 8*((i/2)%2), column 8*(i/4) + 2*(lane%4) + i%2 of the warpgroup's tile.
__device__ __forceinline__ void wgmma_ss(float (&d)[4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
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
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
chain_kernel_wgmma(const Args args) {
  using K = Cfg<BN>;
  constexpr int MB = K::MB, TH = K::TH, HP = K::HP;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_base = smem_u32(smem_raw);
  const uint32_t base = (raw_base + 127u) & ~127u;
  unsigned char* gbase = smem_raw + (base - raw_base);
  const WLayout L = wlayout<BN>(args.Cin, args.modulate);

  const int Cin = args.Cin, H = args.H, W = args.W, Cout = args.Cout;
  const int b = blockIdx.z, nb = blockIdx.y, n0 = nb * BN, tile = blockIdx.x;
  const int ty = tile / args.tiles_x, tx = tile - ty * args.tiles_x;
  const int y0 = ty * TH, x0 = tx * TW;
  // the raw box: rows from the halo's first row clamped into the image
  // (oy = 0 or -1), columns from the 16-byte aligned x0 - 8, so that halo
  // pixel (r, col) is raw (r + oy, col + 7). What lies outside the image is
  // read as zeros and never used.
  const int ry = max(y0 - 1, 0), oy = y0 - 1 - ry;
  const int nch = Cin / KC, n_w = 9 * nch;
  const bool modulate = args.modulate != 0, swish = args.swish != 0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, wg = warp / 4, wl = warp % 4;
  const bool leader = tid == 0;   // the one thread that issues the bulk copies

  const uint32_t bar = base + L.bar;
  const uint32_t raw0 = base + L.ring;
  const uint32_t act0 = raw0 + RS * K::RAW;
  const uint32_t w0 = act0 + 2 * K::ACT;
  // barriers: weights full [WS], weights empty [WS]
  const uint32_t w_full = bar, w_empty = w_full + 8 * K::WS;

  float* sMean = reinterpret_cast<float*>(gbase + L.p);
  float* sScale = sMean + Cin;
  float* sBeta = sMean + 2 * Cin;
  float* sWy = sMean + 3 * Cin;    // [Z][Cin]
  float* sBy = sMean + 7 * Cin;
  float* sWb = sMean + 8 * Cin;    // [Z][Cin]
  float* sBb = sMean + 12 * Cin;
  float4* sZ = reinterpret_cast<float4*>(gbase + L.z);   // [HP] of Z = 4
  const bf16* xb = static_cast<const bf16*>(args.x) + (size_t)b * Cin * H * W;
  const bf16* wsrc = static_cast<const bf16*>(args.w) + (size_t)nb * 9 * Cin * BN;

  // raw x of chunk c into stage c % RS by every thread: 16-byte cp.async
  // vectors where W allows (waited for at the barrier that ends the
  // iteration before the chunk's transform), plain loads otherwise
  auto load_raw = [&](int c) {
    const uint32_t dst = raw0 + (c % RS) * K::RAW;
    if (args.x_vec) {
      for (int e = tid; e < KC * (TH + 2) * (RW / 8); e += kThreads) {
        const int v = e % (RW / 8), rc = e / (RW / 8);
        const int r = rc % (TH + 2), ch = rc / (TH + 2);
        const int y = ry + r, xs = x0 - 8 + 8 * v;
        const bool in = y < H && xs >= 0 && xs < W;
        cp_async16(dst + (uint32_t)(rc * RW + 8 * v) * 2u,
                   in ? xb + ((size_t)(c * KC + ch) * H + y) * W + xs : xb, in);
      }
      cp_async_commit();
    } else {
      bf16* d = reinterpret_cast<bf16*>(gbase + (dst - base));
      for (int e = tid; e < KC * (TH + 2) * RW; e += kThreads) {
        const int col = e % RW, rc = e / RW, r = rc % (TH + 2), ch = rc / (TH + 2);
        const int y = ry + r, xx = x0 - 8 + col;
        d[e] = (y < H && xx >= 0 && xx < W)
                   ? xb[((size_t)(c * KC + ch) * H + y) * W + xx]
                   : __float2bfloat16(0.0f);
      }
    }
  };
  // the weights of k = 9 * chunk + tap into stage k % WS: called by every
  // thread of a converged warp, issued by the leader's predicate
  auto load_w = [&](int k) {
    const int s = k % K::WS, c = k / 9, t = k - 9 * (k / 9);
    bulk_load_if(w0 + s * K::WST, wsrc + ((size_t)t * nch + c) * KC * BN, K::WST,
                 w_full + 8 * s, leader);
  };

  if (leader) {
    for (int s = 0; s < K::WS; ++s) {
      mbar_init(w_full + 8 * s, 1);
      mbar_init(w_empty + 8 * s, kThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // the loads run while the parameters are staged
  for (int k = 0; k < K::WS && k < n_w; ++k) load_w(k);
  for (int c = 0; c < RS && c < nch; ++c) load_raw(c);
  cp_async_wait_all();
  for (int c = tid; c < Cin; c += kThreads) {
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
    const bf16* zq = static_cast<const bf16*>(args.zq) + (size_t)b * Z * H * W;
    for (int p = tid; p < HP; p += kThreads) {
      const int r = p / HWD, col = p - r * HWD;
      const int y = y0 - 1 + r, xx = x0 - 1 + col;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (y >= 0 && y < H && xx >= 0 && xx < W) {
        const size_t o = (size_t)y * W + xx, plane = (size_t)H * W;
        v = make_float4(__bfloat162float(zq[o]), __bfloat162float(zq[plane + o]),
                        __bfloat162float(zq[2 * plane + o]), __bfloat162float(zq[3 * plane + o]));
      }
      sZ[p] = v;
    }
  }
  __syncthreads();

  // item i of chunk c's activated tile: channel group j = i / HP (8
  // channels) of halo pixel p = i % HP. Branch-free: the halo rule is a
  // select, and an item at or past ITEMS (the masked tail of a slice) is
  // computed at a clamped index and not stored.
  auto act_item = [&](int c, uint32_t dst, int i) {
    const bool valid = i < K::ITEMS;
    i = min(i, K::ITEMS - 1);
    const bf16* sraw = reinterpret_cast<const bf16*>(gbase + (raw0 - base) + (c % RS) * K::RAW);
    const int j = i / HP, p = i - j * HP;
    const int r = p / HWD, col = p - r * HWD;
    const int y = y0 - 1 + r, xx = x0 - 1 + col;
    const bool in = y >= 0 && y < H && xx >= 0 && xx < W;
    const int ch = c * KC + 8 * j;
    // raw row r + oy; the halo row above the image (-1) reads row 0 instead,
    // and is zeroed below
    const bf16* src = sraw + (8 * j * (TH + 2) + max(r + oy, 0)) * RW + col + 7;
    float a[8], m[8], sc[8], be[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) a[e] = __bfloat162float(src[e * (TH + 2) * RW]);
    load8(sMean + ch, m);
    load8(sScale + ch, sc);
    load8(sBeta + ch, be);
#pragma unroll
    for (int e = 0; e < 8; ++e) a[e] = (a[e] - m[e]) * sc[e] + be[e];
    if (modulate) {
      const float4 zv = sZ[p];
      const float zz[Z] = {zv.x, zv.y, zv.z, zv.w};
      float ym[8], bm[8], wz[8];
      load8(sWy + ch, wz);
#pragma unroll
      for (int e = 0; e < 8; ++e) ym[e] = zz[0] * wz[e];
      load8(sWb + ch, wz);
#pragma unroll
      for (int e = 0; e < 8; ++e) bm[e] = zz[0] * wz[e];
#pragma unroll
      for (int z = 1; z < Z; ++z) {
        load8(sWy + z * Cin + ch, wz);
#pragma unroll
        for (int e = 0; e < 8; ++e) ym[e] = fmaf(zz[z], wz[e], ym[e]);
        load8(sWb + z * Cin + ch, wz);
#pragma unroll
        for (int e = 0; e < 8; ++e) bm[e] = fmaf(zz[z], wz[e], bm[e]);
      }
      load8(sBy + ch, wz);
#pragma unroll
      for (int e = 0; e < 8; ++e) ym[e] += wz[e];
      load8(sBb + ch, wz);
#pragma unroll
      for (int e = 0; e < 8; ++e) a[e] = a[e] * ym[e] + (bm[e] + wz[e]);
    }
    if (swish) {
#pragma unroll
      for (int e = 0; e < 8; ++e) a[e] = __fdividef(a[e], 1.0f + __expf(-a[e]));
    }
    const uint4 packed = make_uint4(in ? pack_bf16(a[0], a[1]) : 0u, in ? pack_bf16(a[2], a[3]) : 0u,
                                    in ? pack_bf16(a[4], a[5]) : 0u, in ? pack_bf16(a[6], a[7]) : 0u);
    st_shared_v4_if(dst + (uint32_t)(j * HP + p) * 16u, packed, valid);
  };

  float acc[MB][K::NA];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int i = 0; i < K::NA; ++i) acc[mb][i] = 0.0f;

  // chunk 0's activated tile, before any product
#pragma unroll 1
  for (int i0 = 0; i0 < K::ITEMS; i0 += kThreads) act_item(0, act0, i0 + tid);
  fence_proxy_async();
  __syncthreads();
  if (RS < nch) load_raw(RS);   // into chunk 0's stage, free now

  for (int c = 0; c < nch; ++c) {
    const uint32_t act = act0 + (c & 1) * K::ACT;
    const uint32_t nxt = act0 + ((c + 1) & 1) * K::ACT;
    const bool more = c + 1 < nch;
#pragma unroll 1
    for (int t = 0; t < 9; ++t) {
      const int k = 9 * c + t, s = k % K::WS;
      const int dy = t / 3, dx = t - 3 * dy;
      mbar_wait_warp(w_full + 8 * s, (k / K::WS) & 1);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks) {
        const uint64_t db =
            desc_nosw(opaque(w0) + s * K::WST + ks * 2 * BN * 16, BN * 16, 128);
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) {
          const int p0 = (wg * MB + mb + dy) * HWD + dx;
          const uint64_t da =
              desc_nosw(opaque(act) + ks * 2 * HP * 16 + p0 * 16, HP * 16, 128);
          wgmma_ss(acc[mb], da, db);
        }
      }
      wgmma_commit();
      // while the products run: the next chunk's items [t SLICE, (t+1)
      // SLICE), IPT a thread (the branch is uniform)
      if (more && t < K::TAPS) {
#pragma unroll
        for (int u = 0; u < K::IPT; ++u) act_item(c + 1, nxt, t * K::SLICE + u * kThreads + tid);
      }
      wgmma_wait<1>();
      fence_acc(acc);
      // this warp is past tap k - 1: its weight stage is released
      mbar_arrive_if(w_empty + 8 * ((k + K::WS - 1) % K::WS), t > 0 && lane == 0);
      // the stage of tap k - LAG takes tap k - LAG + WS once every warp is
      // past k - LAG: LAG - 1 taps of slack between the warpgroups, and the
      // copy lands WS - LAG taps ahead of its products
      if (k >= LAG && k - LAG + K::WS < n_w) {
        mbar_wait_warp(w_empty + 8 * ((k - LAG) % K::WS), ((k - LAG) / K::WS) & 1);
        load_w(k - LAG + K::WS);
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    mbar_arrive_if(w_empty + 8 * ((9 * c + 8) % K::WS), lane == 0);
    cp_async_wait_all();   // the raw x of chunk c + 2
    fence_proxy_async();
    __syncthreads();
    // chunk c + 1's stage is free: the chunk after the next one goes there
    if (c + 1 + RS < nch) load_raw(c + 1 + RS);
  }

  // ---------------------------------------------------------- epilogue
  // the accumulators to sC[n][m] (over the rings, which no load or product
  // touches any more), m = tile row * TW + column
  constexpr int LDC = K::LDC, M = K::M;
  float* sC = reinterpret_cast<float*>(gbase + L.ring);
  {
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
      const int m = (wg * MB + mb) * TW + 16 * wl + g;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int n = 8 * i + 2 * q;
        sC[n * LDC + m] = acc[mb][4 * i];
        sC[(n + 1) * LDC + m] = acc[mb][4 * i + 1];
        sC[n * LDC + m + 8] = acc[mb][4 * i + 2];
        sC[(n + 1) * LDC + m + 8] = acc[mb][4 * i + 3];
      }
    }
  }
  __syncthreads();

  // + bias [+ res], round, store 8 pixels along W a thread; keep the rounded
  // values (0 outside the image and past Cout) for the moments
  bf16* out = static_cast<bf16*>(args.out);
  const bf16* res = static_cast<const bf16*>(args.res);
  const bool vec = W % 8 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(res) & 15) == 0;
  for (int idx = tid; idx < BN * TH * (TW / 8); idx += kThreads) {
    const int v = idx % (TW / 8), rn = idx / (TW / 8), row = rn % TH, n = rn / TH;
    const int co = n0 + n, y = y0 + row, xs = x0 + 8 * v;
    float* cp = sC + n * LDC + row * TW + 8 * v;
    float val[8];
    load8(cp, val);
    if (co < Cout && y < H && xs < W) {
      const float bias = args.bias[co];
      const size_t o = (((size_t)b * Cout + co) * H + y) * W + xs;
      if (vec) {
        uint4 rv = make_uint4(0u, 0u, 0u, 0u);
        if (res) rv = __ldg(reinterpret_cast<const uint4*>(res + o));
        const bf16* rp = reinterpret_cast<const bf16*>(&rv);
        uint32_t pk[4];
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          float lo = val[e] + bias, hi = val[e + 1] + bias;
          if (res) {
            lo += __bfloat162float(rp[e]);
            hi += __bfloat162float(rp[e + 1]);
          }
          const __nv_bfloat162 r2 = __floats2bfloat162_rn(lo, hi);
          val[e] = __low2float(r2);
          val[e + 1] = __high2float(r2);
          pk[e / 2] = *reinterpret_cast<const uint32_t*>(&r2);
        }
        *reinterpret_cast<uint4*>(out + o) = make_uint4(pk[0], pk[1], pk[2], pk[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (xs + e < W) {
            float f = val[e] + bias;
            if (res) f += __bfloat162float(res[o + e]);
            const bf16 r = __float2bfloat16(f);
            out[o + e] = r;
            val[e] = __bfloat162float(r);
          } else {
            val[e] = 0.0f;
          }
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) val[e] = 0.0f;
    }
    *reinterpret_cast<float4*>(cp) = make_float4(val[0], val[1], val[2], val[3]);
    *reinterpret_cast<float4*>(cp + 4) = make_float4(val[4], val[5], val[6], val[7]);
  }
  if (args.mom) {
    __syncthreads();
    for (int n = warp; n < BN; n += kThreads / 32) {
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

// -------------------------------------------------------------------- host

inline int block_n_bf16(int Cout) { return Cout <= 8 ? 8 : (Cout <= 128 ? 128 : 256); }

template <int BN>
inline int n_tiles_bf16(int H, int W) {
  return ((H + Cfg<BN>::TH - 1) / Cfg<BN>::TH) * ((W + TW - 1) / TW);
}

template <int BN>
int launch_wgmma(Args a, int B, cudaStream_t stream) {
  const WLayout L = wlayout<BN>(a.Cin, a.modulate);
  if (L.total > kMaxSmem) return -1;
  cudaError_t err = cudaFuncSetAttribute(chain_kernel_wgmma<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.total);
  if (err != cudaSuccess) return (int)err;
  a.tiles_x = (a.W + TW - 1) / TW;
  a.n_tiles = n_tiles_bf16<BN>(a.H, a.W);
  // 16-byte vectors of x along W
  a.x_vec = a.W % 8 == 0 && (reinterpret_cast<uintptr_t>(a.x) & 15) == 0;
  const dim3 grid(a.n_tiles, a.CoutP / BN, B);
  chain_kernel_wgmma<BN><<<grid, kThreads, L.total, stream>>>(a);
  return (int)cudaGetLastError();
}

int block_n(int Cout, int dtype) {
  return dtype == 1 ? block_n_bf16(Cout) : parity::block_n(Cout);
}

}  // namespace

extern "C" {

// Output channels per CTA for a given Cout and dtype (0 = float32, 1 =
// bfloat16): the wrapper pads the packed weights and the bias to a multiple
// of it.
int cgic_norm_conv_chain_block_n(int Cout, int dtype) { return block_n(Cout, dtype); }

// Spatial tiles per image: the second dim of the moment partials.
int cgic_norm_conv_chain_tiles(int H, int W, int Cout, int dtype) {
  if (dtype == 1) {
    switch (block_n_bf16(Cout)) {
      case 8: return n_tiles_bf16<8>(H, W);
      case 128: return n_tiles_bf16<128>(H, W);
      default: return n_tiles_bf16<256>(H, W);
    }
  }
  return parity::block_n(Cout) == 8 ? parity::n_tiles<8>(H, W) : parity::n_tiles<128>(H, W);
}

// dtype: 0 = float32, 1 = bfloat16. w: float32 [9, Cin, CoutP]; bfloat16
// [CoutP/BN, 9, Cin/32, 4, BN, 8] (N-block, tap (dy, dx), chunk of 32 input
// channels, group of 8, output channel, input channel in the group). zq, wy,
// by, wb, bb may be null when modulate = 0; res and mom may be null. Returns
// 0 or a cudaError_t code; -1 for arguments the kernel does not take.
int cgic_norm_conv_chain(const void* x, const void* zq, const float* mean, const float* rstd,
                         const float* gamma, const float* beta, const float* wy,
                         const float* by, const float* wb, const float* bb, const void* w,
                         const float* bias, const void* res, void* out, float* mom, int B,
                         int Cin, int Cout, int CoutP, int H, int W, int dtype, int modulate,
                         int swish, void* stream) {
  if (dtype != 0 && dtype != 1) return -1;
  const int BN = block_n(Cout, dtype);
  if (B <= 0 || B > 65535 || Cin <= 0 || Cin % 32 || Cin > kMaxCin || Cout <= 0 || H <= 0 ||
      W <= 0 || CoutP % BN || CoutP < Cout || CoutP / BN > 65535)
    return -1;
  if (modulate && !(zq && wy && by && wb && bb)) return -1;
  Args a{x, zq, mean, rstd, gamma, beta, wy, by, wb, bb, w, bias, res, out, mom,
         Cin, Cout, CoutP, H, W, 0, 0, modulate, swish, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (BN) {
      case 8: return launch_wgmma<8>(a, B, s);
      case 128: return launch_wgmma<128>(a, B, s);
      default: return launch_wgmma<256>(a, B, s);
    }
  }
  return BN == 8 ? parity::launch<8>(a, B, s) : parity::launch<128>(a, B, s);
}

const char* cgic_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

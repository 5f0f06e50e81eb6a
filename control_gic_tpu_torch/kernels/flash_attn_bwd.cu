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
// past Tq and keys past Tk are zero-filled on load and their p is set to 0
// where it would reach a stored gradient.
//
// What bounds it on an H100: operations. At the training shape (B = 2,
// Tq = Tk = 4096, C = 512) the two kernels do 7 matrix products of
// 2*Tq*Tk*C flops each over some 40 MB of operands.
//
// bf16 path (flash_bwd_dkdv_bf16_kernel<NB>, flash_bwd_dq_bf16_kernel<NB>),
// written for Hopper (sm_90a). NB = C rounded up to 128, in 64-channel boxes.
// A CTA has 256 threads, two warpgroups, and no producer: ptxas allots a
// wgmma kernel's registers by warpgroup, so a producer warp (288 threads)
// or warpgroup (384) leaves 168 a thread, too few for 128 accumulators
// beside the S or dP tile (it spilled and serialised the wgmma); 256
// threads leave 255.
//  - Roles. The dk/dv kernel owns BK keys (K and V stay in shared memory for
//    the launch) and walks the queries 64 rows a step. Warpgroup 0
//    builds S = Q K^T over the whole of C, turns it into p and owns dK;
//    warpgroup 1 builds dP = dO V^T, turns it into ds and owns dV. Each
//    reduces over the full C, so no partial sums are exchanged; p crosses to
//    warpgroup 1 once, in f32, through a thread-major buffer (ds needs the
//    unrounded p). p^T and ds^T are stored as bf16, which is where JAX
//    rounds them, and feed the accumulating products from shared memory.
//    The dq kernel owns 64 query rows (Q and dO stay) and walks the keys BK
//    at a time: warpgroup 0 builds S and p, warpgroup 1 dP and ds, and both
//    then accumulate half of dQ's channels each.
//  - Registers. The accumulating products run swapped, so that wgmma's M
//    (at least 64) runs over channels: dV^T = dO^T p^T, dK^T = Q^T ds^T and
//    dQ^T = K^T ds^T, with dO, Q and K read in place as MN-major ("transposed")
//    A operands of their 128-byte swizzled boxes, and p^T, ds^T as K-major B
//    operands. A 64-channel tile of dK^T (or dV^T) over BK keys is BK/2
//    registers a thread, so a warpgroup holds the whole of C for BK =
//    16384 / CP keys: BK = 32 at C > 256 (128 accumulator registers, 256 CTAs
//    at the training shape), 64 below. dQ^T is 64 query rows, NB/2 tiles a
//    warpgroup: 128 registers at C = 512. dK, dV and dQ never leave
//    registers until the epilogue, which stages them as bf16 through shared
//    memory for coalesced stores. The scale of dk and dq is applied once
//    there, not to each block product as JAX does; the f32 sums differ only
//    in order (ops/attention.py's replay follows it).
//  - Loads. Two rings of 64-channel boxes arrive by TMA (cp.async.bulk.tensor,
//    3-D maps over [B, T, C], so rows past T and channels past C read as
//    zeros, never the next batch element), each slot with a full and an
//    empty mbarrier: Q and dO for dk/dv, K and V for dq; a ring holds at
//    least a step's NB boxes. The warpgroup that reads a box last releases
//    it as soon as its product is done (wait_group 1, the next box's product
//    still running): its 128 threads arrive on the slot's empty barrier,
//    and after the last product they wait for each other and its leader
//    thread loads the box R later into the slot by a predicated copy. The S
//    and dP products run a group a box, each issued once its box is in, so
//    the first boxes' products overlap the last ones' loads. A spin-wait
//    between products of one group, or a wait or a one-thread branch
//    between the accumulating products' groups in flight, made ptxas
//    serialise every wgmma of the kernel (C7520, "divergent path").
//  - Hand-offs between the warpgroups are named barriers (bar.arrive /
//    bar.sync), after fence.proxy.async for what wgmma reads. Every wgmma
//    is issued from code both warpgroups run (only the operands differ):
//    products inside a warpgroup-dependent branch were serialised.
//  - Shared memory at C = 512: dk/dv K and V 64 KB, rings 2 x 8 x 8 KB,
//    p^T (two parities), ds^T and the p exchange 20 KB: 212 KB; dq Q and dO
//    128 KB, rings 2 x 10 x 4 KB, ds and the exchange 12 KB: 220 KB. One
//    CTA an SM.
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
// with ctypes (control_gic_tpu_torch/kernels/build.py). The TMA descriptors
// are encoded on the host through cudaGetDriverEntryPoint(ByVersion), so the
// library needs no -lcuda.

#include <cuda.h>          // CUtensorMap and its enums; the driver is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxC = 512;
constexpr int kSmemMax = 232448;   // dynamic shared memory a block can have
constexpr float kLog2e = 1.4426950408889634f;
// a pipeline wait that never completes traps (a launch error) instead of
// hanging the card
constexpr uint32_t kSpinLimit = 1u << 26;

__device__ inline float to_float(bf16 x) { return __bfloat162float(x); }
__device__ inline float to_float(float x) { return x; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// ---------------------------------------------------------------- bf16 path

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n > kSpinLimit) __trap();
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// An opaque copy: the compiler cannot hoist what is computed from it.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

__device__ __forceinline__ void st_shared(uint32_t addr, float x) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(addr), "f"(x) : "memory");
}
__device__ __forceinline__ float ld_shared(uint32_t addr) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(x) : "r"(addr) : "memory");
  return x;
}
__device__ __forceinline__ void st_shared_b16(uint32_t addr, float x) {
  asm volatile("st.shared.b16 [%0], %1;" ::"r"(addr),
               "h"(__bfloat16_as_ushort(__float2bfloat16(x)))
               : "memory");
}
__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t x) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(x) : "memory");
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Named barriers between the consumer warpgroups (id 0 is __syncthreads):
// arrive does not wait, sync waits until `n` threads have arrived or synced.
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
// Generic-proxy writes to shared memory made visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
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
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int M, int N>
__device__ __forceinline__ void fence_regs(float (&r)[M][N]) {
#pragma unroll
  for (int m = 0; m < M; ++m) fence_regs(r[m]);
}

// wgmma shared-memory descriptors: start address, leading and stride byte
// offsets, in 16-byte units.
//  - 128-byte swizzle (the TMA boxes, 64 channels = 128 bytes a row): K-major
//    (Q, K, dO as the S and dP operands) LBO unused, SBO = 1024 bytes between
//    8-row groups; MN-major (Q^T, dO^T, K^T as the accumulating products' A)
//    LBO = the stride between 64-channel boxes, SBO = 1024 between 8-row
//    groups along K.
//  - no swizzle (p^T, ds^T and ds, written by the consumers): a core matrix
//    is 8 rows of 16 bytes; LBO between the two core matrices of a k16
//    slice, along K, SBO between 8-row groups along N.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t desc_nosw(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// D[64 x N] (+)= A[64 x 16] B[16 x N], both from shared memory, B K-major;
// TA = 1 reads A MN-major. d holds the thread's N/2 accumulators: d[i] is row
// 16*warp + lane/4 + 8*((i/2)%2), column 8*(i/4) + 2*(lane%4) + i%2 of the
// warpgroup's tile.
template <int TA>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA));
}
template <int TA>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA));
}

// Tiles and shared memory of the bf16 kernels, by NB = CP / 64 (CP = C
// rounded up to 128). A "box" is a TMA box of 64 channels (128 bytes a row,
// 128-byte swizzle): QBOX for 64 query rows, KBOX for BK key rows.
template <int NB>
struct Bf16Cfg {
  static constexpr int CP = NB * 64;
  static constexpr int BQ = 64;                      // query rows a step (dk/dv) or a CTA (dq)
  static constexpr int BK = NB <= 4 ? 64 : 32;       // keys a CTA (dk/dv) or a step (dq)
  static constexpr int SN = BK / 2;                  // S or dP accumulators a thread
  static constexpr uint32_t QBOX = BQ * 128;
  static constexpr uint32_t KBOX = BK * 128;
  static constexpr uint32_t PITCH = 2 * CP + 16;     // epilogue staging row, bytes
  static constexpr uint32_t AVAIL = kSmemMax - 1024 - 8 * 65;   // alignment, barriers
  static_assert(NB % 2 == 0 && NB <= 8, "C rounded up to 128, at most 512");
};

// dk/dv: K and V (owned, NB boxes each), p^T [2 parities][BK keys][64 q],
// ds^T [BK][64], the p exchange (128 threads x SN floats), then the Q ring
// and the dO ring of R boxes each.
template <int NB>
struct DkdvCfg : Bf16Cfg<NB> {
  using B = Bf16Cfg<NB>;
  static constexpr uint32_t OFF_K = 0;
  static constexpr uint32_t OFF_V = NB * B::KBOX;
  static constexpr uint32_t OFF_PT = 2 * NB * B::KBOX;
  static constexpr uint32_t OFF_DST = OFF_PT + 2 * B::KBOX;
  static constexpr uint32_t OFF_X = OFF_DST + B::KBOX;
  static constexpr uint32_t OFF_RQ = OFF_X + 2 * B::KBOX;   // 128 * SN * 4 bytes
  static constexpr int R0 = (int)((B::AVAIL - OFF_RQ) / (2 * B::QBOX));
  static constexpr int R = R0 < 16 ? R0 : 16;
  static constexpr uint32_t OFF_RDO = OFF_RQ + R * B::QBOX;
  static constexpr uint32_t OFF_BAR = OFF_RDO + R * B::QBOX;
  static constexpr uint32_t SMEM = OFF_BAR + 8 * (1 + 4 * R) + 1024;
  static_assert(R >= NB, "a ring holds a step's boxes");
  static_assert(B::BK * B::PITCH <= R * B::QBOX, "the epilogue stages in a ring");
  static_assert(SMEM <= kSmemMax, "shared memory of one CTA");
};

// dq: Q and dO (owned, NB boxes of 64 rows each), ds [64 q][BK keys], the p
// exchange, then the K ring and the V ring of R boxes each.
template <int NB>
struct DqCfg : Bf16Cfg<NB> {
  using B = Bf16Cfg<NB>;
  static constexpr uint32_t OFF_Q = 0;
  static constexpr uint32_t OFF_DO = NB * B::QBOX;
  static constexpr uint32_t OFF_DS = 2 * NB * B::QBOX;
  static constexpr uint32_t OFF_X = OFF_DS + B::KBOX;        // ds is 64 x BK x 2 = KBOX bytes
  static constexpr uint32_t OFF_RK = OFF_X + 2 * B::KBOX;
  static constexpr int R0 = (int)((B::AVAIL - OFF_RK) / (2 * B::KBOX));
  static constexpr int R = R0 < 16 ? R0 : 16;
  static constexpr uint32_t OFF_RV = OFF_RK + R * B::KBOX;
  static constexpr uint32_t OFF_BAR = OFF_RV + R * B::KBOX;
  static constexpr uint32_t SMEM = OFF_BAR + 8 * (1 + 4 * R) + 1024;
  static_assert(R >= NB, "the K ring holds a step's boxes");
  static_assert(B::BQ * B::PITCH <= 2 * NB * B::QBOX, "the epilogue stages in Q and dO");
  static_assert(SMEM <= kSmemMax, "shared memory of one CTA");
};

// A ring of TMA boxes: box g of a walk (g = step * nb + j: channels 64 j,
// rows step * rows of batch element b) lives in slot g % R, with a full and
// an empty mbarrier a slot (16 bytes apart: the two rings interleave). The
// warpgroup that reads a box last releases it: every thread arrives on the
// slot's empty barrier once its product is done, and once no product is in
// flight every thread waits for the other 127 and the leader thread loads
// box g + R into the slot, by one predicated instruction, not a branch.
struct Ring {
  const CUtensorMap* map;
  uint32_t base, box, full, empty;
  int R, nb, total, rows, b;

  __device__ __forceinline__ uint32_t addr(int g) const { return base + (g % R) * box; }
  __device__ __forceinline__ void wait(int g) const {
    mbar_wait(full + 16 * (g % R), (g / R) & 1);
  }
  // box g into its slot, issued by the thread where `issue` holds
  __device__ __forceinline__ void load(int g, bool issue) const {
    const uint32_t bar = full + 16 * (g % R);
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n"
        "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%1], %2;\n"
        "@p cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%3], [%4, {%5, %6, %7}], [%1];\n}\n" ::"r"((int)issue),
        "r"(bar), "r"(box), "r"(addr(g)), "l"(reinterpret_cast<uint64_t>(map)),
        "r"(64 * (g % nb)), "r"((g / nb) * rows), "r"(b)
        : "memory");
  }
  // every thread of the releasing warpgroup, once its product of box g is
  // done
  __device__ __forceinline__ void arrive(int g) const { mbar_arrive(empty + 16 * (g % R)); }
  // every thread of the releasing warpgroup, after arrive(g) and with no
  // product in flight: box g + R follows into the slot
  __device__ __forceinline__ void refill(int g, bool leader) const {
    mbar_wait(empty + 16 * (g % R), (g / R) & 1);
    __syncwarp();
    load(g + R, leader && g + R < total);
  }
};

// X[64 rows x BK] = A[64 rows, :C] B[BK rows, :C]^T over the NB boxes
// g0 .. g0+NB-1 of a ring (the S or dP product): A owned and B from the
// ring (dq), or A from the ring and B owned (dk/dv). A group of products a
// box, each issued once its box is in, so the first boxes' products run
// while the last ones load. Releases no box.
template <int NB, int BK, bool kRingA>
__device__ __forceinline__ void scores(float (&x)[BK / 2], uint32_t own, uint32_t own_box,
                                       const Ring& ring, int g0) {
  fence_regs(x);
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    ring.wait(g0 + j);
    __syncwarp();   // wgmma is .aligned: the warp converged
    wgmma_fence();
    const uint32_t ra = opaque(ring.addr(g0 + j)), oa = opaque(own) + j * own_box;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const uint64_t dr = desc_sw128(ra + kc * 32, 16, 1024);
      const uint64_t dw = desc_sw128(oa + kc * 32, 16, 1024);
      wgmma_ss<0>(x, kRingA ? dr : dw, kRingA ? dw : dr, j + kc > 0);
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(x);
}

// acc[m] += A_m^T[64 ch x KD] W[KD x N] for the NT ring boxes g0 .. g0+NT-1
// (A_m: box g0 + m, [KD rows][64 ch], read MN-major; W: the no-swizzle
// K-major buffer at w, LBO wl), releasing each box once its product is
// done, while the next one runs, and refilling the slots after the last.
template <int NT, int KD, int N>
__device__ __forceinline__ void accumulate(float (&acc)[NT][N / 2], const Ring& ring, int g0,
                                           uint32_t w, uint32_t wl, bool leader) {
  for (int m = 0; m < NT; ++m) ring.wait(g0 + m);
  __syncwarp();
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int m = 0; m < NT; ++m) {
    const uint32_t ra = opaque(ring.addr(g0 + m)), wa = opaque(w);
#pragma unroll
    for (int kk = 0; kk < KD / 16; ++kk)
      wgmma_ss<1>(acc[m], desc_sw128(ra + kk * 2048, ring.box, 1024),
                  desc_nosw(wa + kk * 2 * wl, wl, 128), 1);
    wgmma_commit();
    wgmma_wait<1>();
    if (m > 0) ring.arrive(g0 + m - 1);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  ring.arrive(g0 + NT - 1);
  for (int m = 0; m < NT; ++m) ring.refill(g0 + m, leader);
}

// Epilogue: acc[m][i] (channel 64 (c0 + m) + row, column n of the
// accumulator layout) times mul, rounded to bf16, staged as [n][channel] at
// stg, then `rows` rows of C channels copied out to out (row stride C) by
// the nthreads threads from `tid`, after a named barrier `bar`.
template <int NT, int N>
__device__ __forceinline__ void store_tiles(const float (&acc)[NT][N / 2], float mul,
                                            unsigned char* stg, uint32_t pitch, int c0, int w,
                                            int lane, int bar, int tid, int nthreads,
                                            bf16* __restrict__ out, int rows, int C) {
  const uint32_t s = smem_u32(stg);
#pragma unroll
  for (int m = 0; m < NT; ++m)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int ch = 64 * (c0 + m) + 16 * w + lane / 4 + 8 * ((i / 2) % 2);
      const int n = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
      st_shared_b16(s + n * pitch + ch * 2, acc[m][i] * mul);
    }
  bar_sync(bar, nthreads);
  const int chunks = C / 8;
  for (int idx = tid; idx < rows * chunks; idx += nthreads) {
    const int r = idx / chunks, c8 = idx - r * chunks;
    *reinterpret_cast<uint4*>(out + (size_t)r * C + c8 * 8) =
        *reinterpret_cast<const uint4*>(stg + r * pitch + c8 * 16);
  }
}

// Barriers of a CTA: the owned tile's full barrier, then full and empty of
// ring A, then of ring B (R slots each).
__device__ __forceinline__ void init_barriers(uint32_t bars, int R) {
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < 2 * R; ++s) {
      mbar_init(bars + 8 + 16 * s, 1);         // full: the leader's expect_tx
      mbar_init(bars + 16 + 16 * s, 128);      // empty: every reading thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

template <int NB>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dkdv_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, int Tq, int Tk, int C,
                           float scale) {
  using K = DkdvCfg<NB>;
  constexpr int R = K::R, BK = K::BK, SN = K::SN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;   // swizzle atoms sit on 1024 bytes
  unsigned char* gbase = smem_raw + (sbase - raw);
  const uint32_t bars = sbase + K::OFF_BAR;
  init_barriers(bars, R);

  const int b = blockIdx.y, k0 = blockIdx.x * BK;
  const int steps = (Tq + K::BQ - 1) / K::BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4, w = warp % 4, tid = threadIdx.x % 128;
  // ring 0: Q, read by warpgroup 0 (S, p and dK); ring 1: dO, read by
  // warpgroup 1 (dP, ds and dV)
  auto ring_of = [&](int r) {
    return Ring{r ? &tm_do : &tm_q, sbase + (r ? K::OFF_RDO : K::OFF_RQ), K::QBOX,
                bars + 8 + 16 * R * r, bars + 16 + 16 * R * r, R, NB, steps * NB, K::BQ, b};
  };
  const Ring ring = ring_of(wg);
  const bool leader = tid == 0;
  if (threadIdx.x == 0) {
    mbar_expect_tx(bars, 2 * NB * K::KBOX);
    for (int j = 0; j < NB; ++j) {
      tma_load_3d(sbase + K::OFF_K + j * K::KBOX, &tm_k, bars, 64 * j, k0, b);
      tma_load_3d(sbase + K::OFF_V + j * K::KBOX, &tm_v, bars, 64 * j, k0, b);
    }
  }
  for (int g = 0; g < R && g < steps * NB; ++g) ring.load(g, leader);

  const uint32_t own = sbase + (wg ? K::OFF_V : K::OFF_K);
  const uint32_t xch = sbase + K::OFF_X + tid * 4;
  const uint32_t dst = sbase + K::OFF_DST;
  const float* stat = (wg ? delta : lse) + (size_t)b * Tq;
  const float scale_log2 = scale * kLog2e;
  float acc[NB][SN];
#pragma unroll
  for (int m = 0; m < NB; ++m)
#pragma unroll
    for (int i = 0; i < SN; ++i) acc[m][i] = 0.0f;
  mbar_wait(bars, 0);

  for (int t = 0; t < steps; ++t) {
    // the thread's two query rows: lse in log2 units (+inf past Tq: p = 0)
    // for warpgroup 0, delta (0 past Tq) for warpgroup 1
    float st[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = t * K::BQ + 16 * w + lane / 4 + 8 * h;
      st[h] = q < Tq ? (wg ? stat[q] : stat[q] * kLog2e) : (wg ? 0.0f : INFINITY);
    }
    const uint32_t pt = sbase + K::OFF_PT + (t & 1) * K::KBOX;
    float x[SN];
    scores<NB, BK, true>(x, own, K::KBOX, ring, t * NB);
    // p^T and ds^T as [key][q], no swizzle: (q/8) * BK*16 + key * 16 + (q%8) * 2
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < SN; ++i) {
        const int q = 16 * w + lane / 4 + 8 * ((i / 2) % 2);
        const int key = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        const float p = exp2f(fmaf(x[i], scale_log2, -st[(i / 2) % 2]));
        st_shared(xch + i * 512, p);
        st_shared_b16(pt + (q / 8) * (BK * 16) + key * 16 + (q % 8) * 2, p);
      }
      fence_proxy_async();
      bar_arrive(1, 256);   // p ready
      bar_sync(2, 256);     // ds^T ready
    } else {
      bar_sync(1, 256);     // p ready
#pragma unroll
      for (int i = 0; i < SN; ++i) {
        const int q = 16 * w + lane / 4 + 8 * ((i / 2) % 2);
        const int key = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        const float ds = ld_shared(xch + i * 512) * (x[i] - st[(i / 2) % 2]);
        st_shared_b16(dst + (q / 8) * (BK * 16) + key * 16 + (q % 8) * 2, ds);
      }
      fence_proxy_async();
      bar_arrive(2, 256);   // ds^T ready
    }
    // dK^T += Q^T ds^T (warpgroup 0), dV^T += dO^T p^T (1), box by box
    accumulate<NB, 64, BK>(acc, ring, t * NB, wg ? pt : dst, BK * 16, leader);
  }

  // each warpgroup stages its gradient in its own ring, idle now
  store_tiles<NB, BK>(acc, wg ? 1.0f : scale, gbase + (wg ? K::OFF_RDO : K::OFF_RQ), K::PITCH,
                      0, w, lane, 3 + wg, tid, 128, (wg ? dv : dk) + ((size_t)b * Tk + k0) * C,
                      min(BK, Tk - k0), C);
}

template <int NB>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dq, int Tq, int Tk, int C, float scale) {
  using K = DqCfg<NB>;
  constexpr int R = K::R, BK = K::BK, SN = K::SN, NH = NB / 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (sbase - raw);
  const uint32_t bars = sbase + K::OFF_BAR;
  init_barriers(bars, R);

  const int b = blockIdx.y, q0 = blockIdx.x * K::BQ;
  const int steps = (Tk + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4, w = warp % 4, tid = threadIdx.x % 128;
  // ring 0: K, read by warpgroup 0 (S) and by the warpgroup that owns its
  // half of the channels (dQ), which releases it; ring 1: V, read and
  // released by warpgroup 1 (dP)
  auto ring_of = [&](int r) {
    return Ring{r ? &tm_v : &tm_k, sbase + (r ? K::OFF_RV : K::OFF_RK), K::KBOX,
                bars + 8 + 16 * R * r, bars + 16 + 16 * R * r, R, NB, steps * NB, BK, b};
  };
  const Ring ring = ring_of(wg), ring_k = ring_of(0);
  const bool leader = tid == 0;
  if (threadIdx.x == 0) {
    mbar_expect_tx(bars, 2 * NB * K::QBOX);
    for (int j = 0; j < NB; ++j) {
      tma_load_3d(sbase + K::OFF_Q + j * K::QBOX, &tm_q, bars, 64 * j, q0, b);
      tma_load_3d(sbase + K::OFF_DO + j * K::QBOX, &tm_do, bars, 64 * j, q0, b);
    }
  }
  for (int g = 0; g < R && g < steps * NB; ++g) ring.load(g, leader);   // K or V

  const uint32_t own = sbase + (wg ? K::OFF_DO : K::OFF_Q);
  const uint32_t xch = sbase + K::OFF_X + tid * 4;
  const uint32_t ds_buf = sbase + K::OFF_DS;
  const float scale_log2 = scale * kLog2e;
  float st[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = q0 + 16 * w + lane / 4 + 8 * h;
    const float* stat = (wg ? delta : lse) + (size_t)b * Tq;
    st[h] = q < Tq ? (wg ? stat[q] : stat[q] * kLog2e) : (wg ? 0.0f : INFINITY);
  }
  float acc[NH][32];
#pragma unroll
  for (int m = 0; m < NH; ++m)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[m][i] = 0.0f;
  mbar_wait(bars, 0);

  for (int t = 0; t < steps; ++t) {
    float x[SN];
    scores<NB, BK, false>(x, own, K::QBOX, ring, t * NB);
    // ds as [q][key], no swizzle: (key/8) * 64*16 + q * 16 + (key%8) * 2
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < SN; ++i) {
        const int key = t * BK + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        const float p = key < Tk ? exp2f(fmaf(x[i], scale_log2, -st[(i / 2) % 2])) : 0.0f;
        st_shared(xch + i * 512, p);
      }
      bar_arrive(1, 256);   // p ready
    } else {
      for (int j = 0; j < NB; ++j) ring.arrive(t * NB + j);   // V
      for (int j = 0; j < NB; ++j) ring.refill(t * NB + j, leader);
      bar_sync(1, 256);     // p ready
#pragma unroll
      for (int i = 0; i < SN; i += 2) {
        const int q = 16 * w + lane / 4 + 8 * ((i / 2) % 2);
        const int key = 8 * (i / 4) + 2 * (lane % 4);
        const float ds0 = ld_shared(xch + i * 512) * (x[i] - st[(i / 2) % 2]);
        const float ds1 = ld_shared(xch + (i + 1) * 512) * (x[i + 1] - st[(i / 2) % 2]);
        st_shared_b32(ds_buf + (key / 8) * 1024 + q * 16 + (key % 8) * 2, pack_bf16(ds0, ds1));
      }
      fence_proxy_async();
    }
    bar_sync(2, 256);       // ds ready
    // dQ^T[half] += K[:, half]^T ds^T, box by box
    accumulate<NH, BK, 64>(acc, ring_k, t * NB + wg * NH, ds_buf, 1024, leader);
  }

  bar_sync(3, 256);   // both warpgroups are done with Q and dO
  store_tiles<NH, 64>(acc, scale, gbase + K::OFF_Q, K::PITCH, wg * NH, w, lane, 4, threadIdx.x,
                      256, dq + ((size_t)b * Tq + q0) * C, min(K::BQ, Tq - q0), C);
}

// ---------------------------------------------------------------- f32 path

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

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 3-D map over a [B, T, C] bf16 tensor: boxes of `rows` x 64 channels,
// 128-byte swizzle, out-of-range elements read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int B, int T, int C, int rows) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)T * C * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The four maps of a bf16 launch: q and do in 64-row boxes, k and v in BK.
bool make_maps(CUtensorMap (&m)[4], const void* q, const void* k, const void* v,
               const void* dout, int B, int Tq, int Tk, int C, int bk) {
  return make_map(&m[0], q, B, Tq, C, 64) && make_map(&m[1], k, B, Tk, C, bk) &&
         make_map(&m[2], v, B, Tk, C, bk) && make_map(&m[3], dout, B, Tq, C, 64);
}

template <int NB>
int launch_dkdv_bf16(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dk, void* dv, int B, int Tq,
                     int Tk, int C, float scale, cudaStream_t stream) {
  using K = DkdvCfg<NB>;
  CUtensorMap m[4];
  if (!make_maps(m, q, k, v, dout, B, Tq, Tk, C, K::BK)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_bf16_kernel<NB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)K::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tk + K::BK - 1) / K::BK, B);
  flash_bwd_dkdv_bf16_kernel<NB><<<grid, 256, K::SMEM, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), Tq, Tk, C, scale);
  return (int)cudaGetLastError();
}

template <int NB>
int launch_dq_bf16(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                   const void* delta, void* dq, int B, int Tq, int Tk, int C, float scale,
                   cudaStream_t stream) {
  using K = DqCfg<NB>;
  CUtensorMap m[4];
  if (!make_maps(m, q, k, v, dout, B, Tq, Tk, C, K::BK)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_bf16_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + K::BQ - 1) / K::BQ, B);
  flash_bwd_dq_bf16_kernel<NB><<<grid, 256, K::SMEM, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), Tq, Tk, C, scale);
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
  if (dtype == 1) {
    switch ((C + 127) / 128) {
      case 1: return launch_dkdv_bf16<2>(q, k, v, dout, lse, delta, dk, dv, B, Tq, Tk, C, scale, s);
      case 2: return launch_dkdv_bf16<4>(q, k, v, dout, lse, delta, dk, dv, B, Tq, Tk, C, scale, s);
      case 3: return launch_dkdv_bf16<6>(q, k, v, dout, lse, delta, dk, dv, B, Tq, Tk, C, scale, s);
      case 4: return launch_dkdv_bf16<8>(q, k, v, dout, lse, delta, dk, dv, B, Tq, Tk, C, scale, s);
    }
    return -1;
  }
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
  if (dtype == 1) {
    switch ((C + 127) / 128) {
      case 1: return launch_dq_bf16<2>(q, k, v, dout, lse, delta, dq, B, Tq, Tk, C, scale, s);
      case 2: return launch_dq_bf16<4>(q, k, v, dout, lse, delta, dq, B, Tq, Tk, C, scale, s);
      case 3: return launch_dq_bf16<6>(q, k, v, dout, lse, delta, dq, B, Tq, Tk, C, scale, s);
      case 4: return launch_dq_bf16<8>(q, k, v, dout, lse, delta, dq, B, Tq, Tk, C, scale, s);
    }
    return -1;
  }
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

// Flash-attention forward for one head, no mask: o = softmax(q k^T * scale) v,
// written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels control_gic_tpu/ops/attention.py:49
// _flash_kernel (launched by attention_flash, the inference forward) and
// :125 _flash_lse_kernel (attention_flash_with_lse, the training forward).
// Same online softmax: per query row a running max m and denominator l in
// f32 and an f32 accumulator, rescaled by exp(m_prev - m_new) at each key
// tile; p is cast to v's dtype before the PV product; the output is acc / l
// in q's dtype. With an lse pointer the epilogue also stores m + log(l) as
// [B, Tq] f32, the residual of the backward (flash_attn_bwd.cu); without it
// nothing else changes and no launch is added.
//
// Shapes: q [B, Tq, C], k and v [B, Tk, C], contiguous; C a multiple of 16,
// at most 512; Tq and Tk arbitrary. Query rows past Tq are computed on zeros
// and not stored; key columns past Tk are masked to -inf, their v rows read
// as zeros.
//
// What bounds it on an H100: operations. The two products are 4*Tq*Tk*C flops
// against 2*(Tq+Tk)*C*itemsize bytes of q, k, v and o: at Tq = Tk = 4096 and
// C = 512 in bf16 some 1000 flops per byte, far above the card's ~295.
//
// bf16 path (flash_fwd_wgmma_kernel): a CTA owns a 64-row query tile and 384
// threads: two consumer warpgroups and one producer warpgroup.
//  - Tensor cores: wgmma.mma_async m64nNk16, bf16 in, f32 accumulate. S = Q K^T
//    takes both operands from shared memory (K-major, 128-byte swizzle); P V
//    takes P from registers (the S accumulator fragment is the A fragment
//    layout, so P never touches shared memory) and V from shared memory as an
//    MN-major ("transposed") B operand.
//  - The accumulator O lives in registers. C = 512 is the crux: a 64x512 f32
//    tile is 256 registers a thread for one warpgroup. So the two consumer
//    warpgroups split O's columns: each owns 64 x CP/2 (128 registers a thread
//    at C = 512), computes the Q K^T partial over its half of C, and the two
//    partial S tiles are summed through a small shared-memory exchange (double
//    buffered, one named barrier per key tile). Both then hold the same S
//    (float addition commutes) and run the same softmax, so m and l, also in
//    registers, agree. The producer is a whole warpgroup (one thread of it
//    issues the copies) so that setmaxnreg can move registers: 384 threads
//    at 168 a thread at launch, then the producer drops to 24 and the
//    consumers ask for 240 (128 x 24 + 256 x 240 = 64,512 of 65,536). ptxas
//    (CUDA 12.9) compiles the consumer path within 180 of them; at CP = 512
//    a single 32-key Q K^T chain then spilled 56 bytes and serialised every
//    wgmma, so that path runs Q K^T as two 16-key chains (QH = 2), each
//    stored to the exchange as it completes: no spill, and on the H100
//    within 10% of the spilling version's time.
//  - Loads: the producer keeps a ring of K and V tiles in flight with TMA
//    (cp.async.bulk.tensor, 128-byte swizzle matching the wgmma descriptors),
//    each stage with a full and an empty mbarrier; consumers release a K stage
//    right after Q K^T and a V stage right after P V. The tensor maps are 3-D
//    over [B, T, C], so rows past T (and channels past C) are zero-filled,
//    never read from the next batch element. They are encoded on the host per
//    call and passed as __grid_constant__ CUtensorMap; cuTensorMapEncodeTiled
//    is reached through cudaGetDriverEntryPoint(ByVersion), so the library
//    needs no -lcuda.
//  - Tiles (CP = C rounded up to 128; each half of C then is whole 64-channel
//    swizzle boxes): BQ = 64; BK = 32 keys a stage for CP > 256, 64 otherwise;
//    2 stages of K and 2 of V.
//      shared memory, CP = 512: Q 64x512x2 = 64 KB, K and V 2 x 2 x 32x512x2 =
//      128 KB, S exchange 2 parities x 2 warpgroups x 64x32x4 = 32 KB: 224 KB
//      of the 227 KB. CP = 256: Q 32 KB + K/V 128 KB (BK = 64) + exchange
//      64 KB = 224 KB.
//      registers a consumer thread, CP = 512: O 64x256/128 = 128, one
//      16-key S chain 8, S after the exchange 16 (then P, 4 bf16 pairs per
//      k16 slice), m and l 4, addresses and loop state.
//
// f32 path (flash_fwd_f32_kernel), the training recipe's dtype and the parity
// runs: FFMA on the FP32 pipes, never TF32. 256 threads, BQ = 64, BK = 64. A
// thread owns rows rg + 16i (i < 4, rg = tid / 16) and keys kg + 16j (j < 4,
// kg = tid % 16) of S, and columns 64n + 4kg..+3 (n < CP/64) of the same rows
// of O: O is 4 x CP/16 registers (128 at C = 512), S 16. S is built as 4x4
// register outer products over float4 loads of Q and K (64 FMAs per 8
// shared-memory loads, broadcast across the 16 threads that share a row); P
// goes through shared memory once, as P^T, so that P V reads one float4 of P
// per key and CP/64 float4s of V for 16*CP/64 FMAs. K arrives in 64-channel
// chunks and V in 8-key chunks through a 3-buffer cp.async ring.
//      shared memory, CP = 512: Q 64x516x4 = 129 KB, P^T 64x68x4 = 17 KB,
//      ring 3 x 17 KB: 197 KB.
//
// Split KV: where B * ceil(Tq / 64) query tiles would not fill the card,
// cgic_flash_attn_splits picks a number of key splits; each split's CTA
// writes its unnormalised (acc, m, l) to a workspace the caller allocates,
// and flash_fwd_combine_kernel folds the splits in split order (so the
// result is the same from run to run), normalises, and writes the lse.
//
// What the design does about the previous version's limits: O, m and l are
// never in shared memory (it kept O there and rescaled it in a separate
// pass); loads run ahead of the math (TMA ring / cp.async ring) instead of
// synchronously between __syncthreads; wgmma replaces the sm_80 wmma path;
// the softmax stays in registers on the bf16 path (S crosses shared memory
// once, as the two halves' partial sums); 64-row query tiles and
// split KV raise reuse without leaving the card empty at B = 1; the f32 path
// is register-tiled instead of one dot product per thread.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (control_gic_tpu_torch/kernels/build.py).

#include <cuda.h>          // CUtensorMap and its enums; the driver is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxC = 512;
constexpr int kBQ = 64;           // query rows per CTA, both paths
constexpr int kMaxSplits = 16;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// a pipeline wait that never completes traps (a launch error) instead of
// hanging the card
constexpr uint32_t kSpinLimit = 1u << 26;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ PTX helpers

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

__device__ __forceinline__ void consumers_sync() {   // the two consumer warpgroups
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of wgmma accumulators across
// the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets in 16-byte units. K-major operands (Q, K): LBO
// unused (1), SBO = 1024 bytes between 8-row groups. MN-major V: LBO = the
// stride between 64-channel boxes, SBO = 1024 bytes between 8-key groups.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x N] (+)= A[64 x 16] B[16 x N], both from shared memory, K-major.
// d holds the thread's N/2 accumulators: d[i] is row 16*warp + lane/4 +
// 8*((i/2)%2), column 8*(i/4) + 2*(lane%4) + i%2 of the warpgroup's tile.
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}
// D[64 x N] += A[64 x 16] B[16 x N], A from registers (a0..a3: rows
// lane/4 and +8, columns 2*(lane%4)+{0,1} and +8, bf16 pairs), B MN-major.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[96], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
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
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// --------------------------------------------------------------- bf16 path

template <int CP>
struct Bf16Cfg {
  static constexpr int CH = CP / 2;                // O columns of one consumer warpgroup
  static constexpr int BK = CP <= 256 ? 64 : 32;   // keys a stage
  static constexpr int STAGES = 2;
  // Q K^T chains a tile: at CP > 256 two of BK/2 keys, so that the 128 O
  // accumulators, 8 S accumulators and the loop's state fit the registers
  // ptxas gives a consumer (no spill, no serialised wgmma)
  static constexpr int QH = CP > 256 ? 2 : 1;
  static constexpr int NB = CP / 64;               // 64-channel (128-byte) boxes a row
  static constexpr int SN = BK / 2;                // S accumulators a thread
  static constexpr int ON = CH / 2;                // O accumulators a thread
  static constexpr uint32_t Q_BOX = kBQ * 128;
  static constexpr uint32_t KV_BOX = BK * 128;
  static constexpr uint32_t KV_BYTES = NB * KV_BOX;          // one stage of K or V
  static constexpr uint32_t X_BYTES = 2 * 2 * 128 * SN * 4;  // parity x warpgroup
  static constexpr uint32_t OFF_K = NB * Q_BOX;
  static constexpr uint32_t OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr uint32_t OFF_X = OFF_V + STAGES * KV_BYTES;
  static constexpr uint32_t OFF_BAR = OFF_X + X_BYTES;
  static constexpr uint32_t SMEM = OFF_BAR + (1 + 4 * STAGES) * 8 + 1024;  // + alignment
  static_assert(CH % 64 == 0, "each warpgroup owns whole swizzle boxes");
  static_assert(SMEM <= 232448, "shared memory of one CTA");
};

template <int CP>
__global__ void __launch_bounds__(384, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                       float* __restrict__ lse, float* __restrict__ ws, int Tq, int Tk, int C,
                       int tiles_per_split, float scale_log2) {
  using K = Bf16Cfg<CP>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;   // swizzle atoms sit on 1024 bytes
  const uint32_t full_q = sbase + K::OFF_BAR;
  const uint32_t full_k = full_q + 8, empty_k = full_k + 8 * K::STAGES;
  const uint32_t full_v = empty_k + 8 * K::STAGES, empty_v = full_v + 8 * K::STAGES;

  const int b = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int nkt = (Tk + K::BK - 1) / K::BK;
  const int t_begin = blockIdx.z * tiles_per_split;
  const int t_end = min(nkt, t_begin + tiles_per_split);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < K::STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, 8);   // one arrival per consumer warp
      mbar_init(empty_v + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {   // producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (warp % 4 == 0 && lane == 0) {
      mbar_expect_tx(full_q, K::NB * K::Q_BOX);
      for (int j = 0; j < K::NB; ++j) tma_load_3d(sbase + j * K::Q_BOX, &tm_q, full_q, 64 * j, q0, b);
      for (int t = t_begin, it = 0; t < t_end; ++t, ++it) {
        const int st = it % K::STAGES;
        const uint32_t ph = (it / K::STAGES) & 1;
        mbar_wait(empty_k + 8 * st, ph ^ 1);
        mbar_expect_tx(full_k + 8 * st, K::KV_BYTES);
        for (int j = 0; j < K::NB; ++j)
          tma_load_3d(sbase + K::OFF_K + st * K::KV_BYTES + j * K::KV_BOX, &tm_k, full_k + 8 * st,
                      64 * j, t * K::BK, b);
        mbar_wait(empty_v + 8 * st, ph ^ 1);
        mbar_expect_tx(full_v + 8 * st, K::KV_BYTES);
        for (int j = 0; j < K::NB; ++j)
          tma_load_3d(sbase + K::OFF_V + st * K::KV_BYTES + j * K::KV_BOX, &tm_v, full_v + 8 * st,
                      64 * j, t * K::BK, b);
      }
    }
  } else {   // consumers: warpgroup wg owns O's columns [wg * CH, (wg + 1) * CH)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
    float acc[K::ON];
#pragma unroll
    for (int i = 0; i < K::ON; ++i) acc[i] = 0.0f;
    float m2[2] = {-INFINITY, -INFINITY};   // running max, in log2 units
    float lsum[2] = {0.0f, 0.0f};           // this thread's share of l
    mbar_wait(full_q, 0);

    const int wg = warp / 4, tid = threadIdx.x % 128;
    for (int it = 0; it < t_end - t_begin; ++it) {
      const int t = t_begin + it;
      const int st = it % K::STAGES;
      const uint32_t ph = (it / K::STAGES) & 1;
      float s[K::SN];
      mbar_wait(full_k + 8 * st, ph);
      const uint32_t xch = sbase + K::OFF_X + tid * 4;
      const uint32_t mine = xch + ((it & 1) * 2 + wg) * 128 * K::SN * 4;
      const uint32_t other = xch + ((it & 1) * 2 + (wg ^ 1)) * 128 * K::SN * 4;
      // S partial = Q[:, half] K[:, half]^T in QH chains of BK/QH keys each,
      // each stored to the exchange as soon as it is done
      constexpr int QH = K::QH;
#pragma unroll
      for (int hk = 0; hk < QH; ++hk) {
        float sh[K::SN / QH];
#pragma unroll
        for (int i = 0; i < K::SN / QH; ++i) sh[i] = 0.0f;
        // each descriptor is built from an opaque copy of its base right
        // before its product, so that the compiler keeps none of them
        const uint32_t qwg = sbase + wg * (K::CH / 64) * K::Q_BOX;
        const uint32_t kwg = sbase + K::OFF_K + st * K::KV_BYTES + wg * (K::CH / 64) * K::KV_BOX +
                             hk * (K::BK / QH) * 128;
        fence_regs(sh);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < K::CH / 16; ++kk) {
          const int c = kk * 16;   // within the warpgroup's half
          wgmma_ss(sh, desc_sw128(opaque(qwg) + (c / 64) * K::Q_BOX + (c % 64) * 2, 16, 1024),
                   desc_sw128(opaque(kwg) + (c / 64) * K::KV_BOX + (c % 64) * 2, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sh);
#pragma unroll
        for (int i = 0; i < K::SN / QH; ++i) st_shared(mine + (hk * (K::SN / QH) + i) * 512, sh[i]);
      }
      if (lane == 0) mbar_arrive(empty_k + 8 * st);

      // the two halves' partial sums (a + b in one warpgroup, b + a in the
      // other: the same bits)
      consumers_sync();
#pragma unroll
      for (int i = 0; i < K::SN; ++i) s[i] = ld_shared(mine + i * 512) + ld_shared(other + i * 512);

      // online softmax on the thread's two rows (reduced over the 4 lanes of a row)
      const int key0 = t * K::BK + 2 * (lane % 4);
      const bool ragged = (t + 1) * K::BK > Tk;   // only the last tile masks
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < K::SN; ++i) {
        float x = s[i] * scale_log2;
        if (ragged && key0 + (i / 4) * 8 + (i % 2) >= Tk) x = -INFINITY;
        s[i] = x;
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
      }
      float corr[2], part[2] = {0.0f, 0.0f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m2[h], mx[h]);
        corr[h] = exp2f(m2[h] - m_new);
        m2[h] = m_new;
      }
#pragma unroll
      for (int i = 0; i < K::SN; ++i) {
        s[i] = exp2f(s[i] - m2[(i / 2) % 2]);
        part[(i / 2) % 2] += s[i];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) lsum[h] = lsum[h] * corr[h] + part[h];
#pragma unroll
      for (int i = 0; i < K::ON; ++i) acc[i] *= corr[(i / 2) % 2];

      // O[:, half] += P V[:, half]
      mbar_wait(full_v + 8 * st, ph);
      const uint32_t vst = sbase + K::OFF_V + st * K::KV_BYTES + wg * (K::CH / 64) * K::KV_BOX;
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < K::BK / 16; ++kk) {
        // P's k16 slice as the A fragment: the S accumulators of n8 blocks
        // 2kk and 2kk+1, rounded to bf16 pairs (a fence after writing them)
        uint32_t pa[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) pa[r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
        wgmma_fence();
        wgmma_rs(acc, pa, desc_sw128(opaque(vst) + kk * 16 * 128, K::KV_BOX, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty_v + 8 * st);
    }

    // epilogue: the output rows (one split) or the split's partials
    const size_t rows = (size_t)gridDim.y * Tq;
    const int row0 = (warp % 4) * 16 + lane / 4;   // the thread's rows: row0 and row0 + 8
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 1);
      lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 2);
      const int r = q0 + row0 + 8 * h;
      if (r < Tq) {
        const size_t row = (size_t)b * Tq + r;
        const float m_nat = m2[h] * kLn2;
        if (ws == nullptr) {
          bf16* orow = o + row * C;
          const float inv = 1.0f / lsum[h];   // one division a row (bf16 output)
#pragma unroll
          for (int n = 0; n < K::CH / 8; ++n) {
            const int col = wg * K::CH + 8 * n + 2 * (lane % 4);
            if (col < C)
              *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
                  acc[4 * n + 2 * h] * inv, acc[4 * n + 2 * h + 1] * inv);
          }
          if (lse != nullptr && wg == 0 && lane % 4 == 0) lse[row] = m_nat + logf(lsum[h]);
        } else {
          const size_t prow = blockIdx.z * rows + row;
          float* arow = ws + prow * C;
#pragma unroll
          for (int n = 0; n < K::CH / 8; ++n) {
            const int col = wg * K::CH + 8 * n + 2 * (lane % 4);
            if (col < C)
              *reinterpret_cast<float2*>(arow + col) =
                  make_float2(acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]);
          }
          if (wg == 0 && lane % 4 == 0) {
            float* pm = ws + (size_t)gridDim.z * rows * C;
            pm[prow] = m_nat;
            pm[gridDim.z * rows + prow] = lsum[h];
          }
        }
      }
    }
  }
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
  static constexpr int BK = 64;
  static constexpr int LDQ = CP + 4;     // row strides (floats); 4 mod 32 spreads banks
  static constexpr int LDK = 64 + 4;
  static constexpr int LDP = kBQ + 4;
  static constexpr int STAGES = 3;
  static constexpr int CHUNK = BK * LDK > 8 * CP ? BK * LDK : 8 * CP;   // floats
  static constexpr int NCH = NG + BK / 8;   // chunks a key tile: NG of K, 8 of V
  static constexpr size_t OFF_P = (size_t)kBQ * LDQ * 4;
  static constexpr size_t OFF_RING = OFF_P + (size_t)BK * LDP * 4;
  static constexpr size_t SMEM = OFF_RING + (size_t)STAGES * CHUNK * 4;
  static_assert(SMEM <= 232448, "shared memory of one CTA");
};

// Chunk g of a split: part < NG is K rows [64 tile, +64) x channels
// [64 part, +64); otherwise V rows [64 tile + 8 (part - NG), +8) x all
// channels. Rows past Tk and channels past C are zero-filled.
template <int NG>
__device__ __forceinline__ void load_chunk(float* buf, const float* kb, const float* vb, int g,
                                           int t_begin, int Tk, int C) {
  using K = F32Cfg<NG>;
  const int tile = t_begin + g / K::NCH, part = g % K::NCH;
  if (part < NG) {
    for (int idx = threadIdx.x; idx < 64 * 16; idx += blockDim.x) {
      const int r = idx / 16, c = part * 64 + (idx % 16) * 4, key = tile * 64 + r;
      const bool ok = key < Tk && c < C;
      cp_async16(buf + r * K::LDK + (idx % 16) * 4, ok ? kb + (size_t)key * C + c : kb, ok);
    }
  } else {
    const int key0 = tile * 64 + (part - NG) * 8;
    for (int idx = threadIdx.x; idx < 8 * (K::CP / 4); idx += blockDim.x) {
      const int r = idx / (K::CP / 4), c = (idx % (K::CP / 4)) * 4, key = key0 + r;
      const bool ok = key < Tk && c < C;
      cp_async16(buf + r * K::CP + c, ok ? vb + (size_t)key * C + c : vb, ok);
    }
  }
}

__device__ __forceinline__ void fma4(float4& a, float p, const float4& v) {
  a.x = fmaf(p, v.x, a.x);
  a.y = fmaf(p, v.y, a.y);
  a.z = fmaf(p, v.z, a.z);
  a.w = fmaf(p, v.w, a.w);
}

template <int NG>
__global__ void __launch_bounds__(256, 1)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                     float* __restrict__ ws, int Tq, int Tk, int C, int tiles_per_split,
                     float scale_log2) {
  using K = F32Cfg<NG>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sP = reinterpret_cast<float*>(smem_raw + K::OFF_P);   // P^T, [key][4 rg + i]
  float* ring = reinterpret_cast<float*>(smem_raw + K::OFF_RING);

  const int b = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int nkt = (Tk + K::BK - 1) / K::BK;
  const int t_begin = blockIdx.z * tiles_per_split;
  const int total = (min(nkt, t_begin + tiles_per_split) - t_begin) * K::NCH;
  const float* kb = k + (size_t)b * Tk * C;
  const float* vb = v + (size_t)b * Tk * C;
  const float* qb = q + ((size_t)b * Tq + q0) * C;

  for (int idx = threadIdx.x; idx < kBQ * (K::CP / 4); idx += blockDim.x) {
    const int r = idx / (K::CP / 4), c = (idx % (K::CP / 4)) * 4;
    const bool ok = q0 + r < Tq && c < C;
    cp_async16(sQ + r * K::LDQ + c, ok ? qb + (size_t)r * C + c : q, ok);
  }
#pragma unroll
  for (int g = 0; g < K::STAGES - 1; ++g) {   // Q rides in the first group
    if (g < total) load_chunk<NG>(ring + g * K::CHUNK, kb, vb, g, t_begin, Tk, C);
    cp_async_commit();
  }

  const int rg = threadIdx.x / 16, kg = threadIdx.x % 16;
  float4 acc[4][NG];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < NG; ++n) acc[i][n] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m2[4], lsum[4], s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m2[i] = -INFINITY;
    lsum[i] = 0.0f;
  }

  for (int g = 0; g < total; ++g) {
    cp_async_wait<K::STAGES - 2>();
    __syncthreads();   // chunk g is in; every thread is done with chunk g - 1
    if (g + K::STAGES - 1 < total)
      load_chunk<NG>(ring + ((g + K::STAGES - 1) % K::STAGES) * K::CHUNK, kb, vb,
                     g + K::STAGES - 1, t_begin, Tk, C);
    cp_async_commit();
    const float* buf = ring + (g % K::STAGES) * K::CHUNK;
    const int part = g % K::NCH;
    if (part < NG) {   // S += Q[:, chunk] K[:, chunk]^T
      if (part == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
      }
#pragma unroll 2
      for (int c4 = 0; c4 < 16; ++c4) {
        float4 qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = *reinterpret_cast<const float4*>(sQ + (rg + 16 * i) * K::LDQ + part * 64 + c4 * 4);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kv[j] = *reinterpret_cast<const float4*>(buf + (kg + 16 * j) * K::LDK + c4 * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
            s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
            s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
          }
      }
      if (part == NG - 1) {   // online softmax; the 16 threads of a row share rg
        const int key0 = (t_begin + g / K::NCH) * K::BK + kg;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = (key0 + 16 * j < Tk) ? s[i][j] * scale_log2 : -INFINITY;
            mx = fmaxf(mx, s[i][j]);
          }
#pragma unroll
          for (int off = 1; off < 16; off <<= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          const float m_new = fmaxf(m2[i], mx);
          const float corr = exp2f(m2[i] - m_new);
          m2[i] = m_new;
          float part_sum = 0.0f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = exp2f(s[i][j] - m_new);
            part_sum += s[i][j];
          }
          lsum[i] = lsum[i] * corr + part_sum;
#pragma unroll
          for (int n = 0; n < NG; ++n) {
            acc[i][n].x *= corr;
            acc[i][n].y *= corr;
            acc[i][n].z *= corr;
            acc[i][n].w *= corr;
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<float4*>(sP + (kg + 16 * j) * K::LDP + rg * 4) =
              make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      }
    } else {   // O += P[:, 8 keys] V[8 keys, :]
      const int kk0 = (part - NG) * 8;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float4 p = *reinterpret_cast<const float4*>(sP + (kk0 + jj) * K::LDP + rg * 4);
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          const float4 vv = *reinterpret_cast<const float4*>(buf + jj * K::CP + n * 64 + kg * 4);
          fma4(acc[0][n], p.x, vv);
          fma4(acc[1][n], p.y, vv);
          fma4(acc[2][n], p.z, vv);
          fma4(acc[3][n], p.w, vv);
        }
      }
    }
  }
  cp_async_wait<0>();

  const size_t rows = (size_t)gridDim.y * Tq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) lsum[i] += __shfl_xor_sync(0xffffffffu, lsum[i], off);
    const int r = q0 + rg + 16 * i;
    if (r < Tq) {
      const size_t row = (size_t)b * Tq + r;
      const float m_nat = m2[i] * kLn2;
      if (ws == nullptr) {
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          const int col = n * 64 + kg * 4;
          if (col < C)
            *reinterpret_cast<float4*>(o + row * C + col) =
                make_float4(acc[i][n].x / lsum[i], acc[i][n].y / lsum[i],
                            acc[i][n].z / lsum[i], acc[i][n].w / lsum[i]);
        }
        if (lse != nullptr && kg == 0) lse[row] = m_nat + logf(lsum[i]);
      } else {
        const size_t prow = blockIdx.z * rows + row;
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          const int col = n * 64 + kg * 4;
          if (col < C) *reinterpret_cast<float4*>(ws + prow * C + col) = acc[i][n];
        }
        if (kg == 0) {
          float* pm = ws + (size_t)gridDim.z * rows * C;
          pm[prow] = m_nat;
          pm[gridDim.z * rows + prow] = lsum[i];
        }
      }
    }
  }
}

// ----------------------------------------------------------- split combine

// One CTA a row: M = max_s m_s, w_s = exp(m_s - M), L = sum_s l_s w_s,
// o = (sum_s acc_s w_s) / L, lse = M + log L, with the sums taken in split
// order. ws holds acc [S, rows, C], then m [S, rows], then l [S, rows].
__device__ __forceinline__ void store4(float* p, float4 x) { *reinterpret_cast<float4*>(p) = x; }
__device__ __forceinline__ void store4(bf16* p, float4 x) {
  reinterpret_cast<__nv_bfloat162*>(p)[0] = __floats2bfloat162_rn(x.x, x.y);
  reinterpret_cast<__nv_bfloat162*>(p)[1] = __floats2bfloat162_rn(x.z, x.w);
}

template <typename T>
__global__ void __launch_bounds__(128)
flash_fwd_combine_kernel(const float* __restrict__ ws, T* __restrict__ o, float* __restrict__ lse,
                         int splits, int rows, int C) {
  const int row = blockIdx.x;
  const float* pm = ws + (size_t)splits * rows * C;
  const float* pl = pm + (size_t)splits * rows;
  float w[kMaxSplits];
  float M = -INFINITY, L = 0.0f;
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s)
    if (s < splits) M = fmaxf(M, pm[(size_t)s * rows + row]);
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    w[s] = s < splits ? expf(pm[(size_t)s * rows + row] - M) : 0.0f;
    if (s < splits) L += pl[(size_t)s * rows + row] * w[s];
  }
  for (int c = threadIdx.x * 4; c < C; c += blockDim.x * 4) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      if (s < splits) {
        const float4 x = *reinterpret_cast<const float4*>(ws + ((size_t)s * rows + row) * C + c);
        fma4(a, w[s], x);
      }
    }
    store4(o + (size_t)row * C + c, make_float4(a.x / L, a.y / L, a.z / L, a.w / L));
  }
  if (lse != nullptr && threadIdx.x == 0) lse[row] = M + logf(L);
}

// -------------------------------------------------------------------- host

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

int round_up(int x, int a) { return (x + a - 1) / a * a; }
int ceil_div(int x, int a) { return (x + a - 1) / a; }
int f32_groups(int C) {
  int ng = 1;
  while (ng * 64 < C) ng *= 2;
  return ng;
}

// The kernel instance for (C, dtype), its shared memory, threads and keys a tile.
struct Plan {
  const void* fn;
  size_t smem;
  int threads, bk;
};

template <int CP>
Plan bf16_plan() {
  return {(const void*)flash_fwd_wgmma_kernel<CP>, Bf16Cfg<CP>::SMEM, 384, Bf16Cfg<CP>::BK};
}
template <int NG>
Plan f32_plan() {
  return {(const void*)flash_fwd_f32_kernel<NG>, F32Cfg<NG>::SMEM, 256, F32Cfg<NG>::BK};
}

bool make_plan(int C, int dtype, Plan* p) {
  if (dtype == 1) {
    switch (round_up(C, 128)) {
      case 128: *p = bf16_plan<128>(); return true;
      case 256: *p = bf16_plan<256>(); return true;
      case 384: *p = bf16_plan<384>(); return true;
      case 512: *p = bf16_plan<512>(); return true;
    }
  } else if (dtype == 0) {
    switch (f32_groups(C)) {
      case 1: *p = f32_plan<1>(); return true;
      case 2: *p = f32_plan<2>(); return true;
      case 4: *p = f32_plan<4>(); return true;
      case 8: *p = f32_plan<8>(); return true;
    }
  }
  return false;
}

int tiles_per_split(int Tk, int bk, int splits) { return ceil_div(ceil_div(Tk, bk), splits); }

int launch(const void* q, const void* k, const void* v, void* o, void* lse, void* ws, int B,
           int Tq, int Tk, int C, int dtype, int splits, float scale, cudaStream_t stream) {
  Plan p;
  if (!make_plan(C, dtype, &p)) return -1;
  const int per = tiles_per_split(Tk, p.bk, splits);
  if (splits < 1 || splits > kMaxSplits || (splits - 1) * per >= ceil_div(Tk, p.bk) ||
      (splits > 1 && ws == nullptr))
    return -1;
  cudaError_t err =
      cudaFuncSetAttribute(p.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(ceil_div(Tq, kBQ), B, splits);
  float* split_ws = splits > 1 ? static_cast<float*>(ws) : nullptr;
  float* lse_out = splits > 1 ? nullptr : static_cast<float*>(lse);
  const float scale_log2 = scale * kLog2e;
  if (dtype == 1) {
    CUtensorMap mq, mk, mv;
    if (!make_map(&mq, q, B, Tq, C, kBQ) || !make_map(&mk, k, B, Tk, C, p.bk) ||
        !make_map(&mv, v, B, Tk, C, p.bk))
      return (int)cudaErrorInvalidValue;
    void* args[] = {&mq, &mk, &mv, &o, &lse_out, &split_ws, &Tq, &Tk, &C,
                    const_cast<int*>(&per), const_cast<float*>(&scale_log2)};
    err = cudaLaunchKernel(p.fn, grid, dim3(p.threads), args, p.smem, stream);
  } else {
    void* args[] = {const_cast<void**>(&q), const_cast<void**>(&k), const_cast<void**>(&v), &o,
                    &lse_out, &split_ws, &Tq, &Tk, &C, const_cast<int*>(&per),
                    const_cast<float*>(&scale_log2)};
    err = cudaLaunchKernel(p.fn, grid, dim3(p.threads), args, p.smem, stream);
  }
  if (err != cudaSuccess) return (int)err;
  if (splits > 1) {
    const float* cws = static_cast<const float*>(ws);
    const int rows = B * Tq;
    if (dtype == 1)
      flash_fwd_combine_kernel<bf16><<<rows, 128, 0, stream>>>(
          cws, static_cast<bf16*>(o), static_cast<float*>(lse), splits, rows, C);
    else
      flash_fwd_combine_kernel<float><<<rows, 128, 0, stream>>>(
          cws, static_cast<float*>(o), static_cast<float*>(lse), splits, rows, C);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Key splits for these shapes on the current device: 1 where the query tiles
// fill every SM slot; otherwise the count (at most 16, each split non-empty)
// that minimises waves x keys a split, a larger count only where it gains
// 10% over the best smaller one. Negative for arguments the kernel
// does not take, or a cudaError_t code.
int cgic_flash_attn_splits(int B, int Tq, int Tk, int C, int dtype) {
  Plan p;
  if (B <= 0 || Tq <= 0 || Tk <= 0 || C % 16 != 0 || C > kMaxC || !make_plan(C, dtype, &p))
    return -1;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(p.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, p.fn, p.threads, p.smem);
  if (err != cudaSuccess) return -(int)err;
  const double slots = (double)sms * (per_sm > 0 ? per_sm : 1);
  const double tiles = (double)B * ceil_div(Tq, kBQ);
  const int nkt = ceil_div(Tk, p.bk);
  int best = 1;
  double best_cost = ceil(tiles / slots);
  for (int s = 2; s <= kMaxSplits && s <= nkt && tiles < slots; ++s) {
    const int per = ceil_div(nkt, s);
    if (ceil_div(nkt, per) != s) continue;
    const double cost = ceil(tiles * s / slots) * per / nkt;
    if (cost < 0.9 * best_cost) {   // a split must gain 10%: the combine costs too
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

// dtype: 0 = float32, 1 = bfloat16. lse: null, or [B, Tq] f32 for the
// logsumexp. ws: with splits > 1, splits * B * Tq * (C + 2) floats of
// scratch (cgic_flash_attn_splits gives the count); ignored with one split.
// Returns 0 or a cudaError_t code; -1 for arguments the kernel does not take.
int cgic_flash_attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse, void* ws,
                        int B, int Tq, int Tk, int C, int dtype, int splits, float scale,
                        void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || C <= 0 || C % 16 != 0 || C > kMaxC) return -1;
  return launch(q, k, v, o, lse, ws, B, Tq, Tk, C, dtype, splits, scale,
                static_cast<cudaStream_t>(stream));
}

const char* cgic_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

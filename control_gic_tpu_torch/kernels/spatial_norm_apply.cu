// SpatialNorm apply (+ swish) from the GroupNorm moments, the group fold included.
//
// Replaces the Pallas TPU kernel control_gic_tpu/ops/fused_norm.py::_apply_kernel
// (launched by _fused_forward) together with the group fold that XLA ran between it
// and the moment pass (_gn_stats_pallas). For f NCHW [B, C, H, W] and zq [B, Z=4, H, W],
// both in T (float32 or bfloat16), and the moments mom [B, 2, C] f32 (per-channel sum
// and sum of squares over the HW pixels, kernels/gn_moments.cu), one launch computes:
//   prologue, per CTA, in f32, for each GroupNorm group (cg = C/32 channels) of its
//   channel block: s1, s2 = the group's channel moments summed in channel order,
//     mean = s1 / n, var = max(s2 / n - mean^2, 0), rstd = rsqrt(var + 1e-6), n = HW*cg
//   (the fold of gn_stats_from_moments), then per channel, with s = rstd*gamma and
//   t = beta - mean*s, ten coefficients in shared memory:
//     a0 = s*by, a_z = s*wy_z, b0 = t*by + bb, b_z = t*wy_z + wb_z
//   per element:
//     out = x * (a0 + sum_z zq_z*a_z) + (b0 + sum_z zq_z*b_z)    (nine FMAs)
//     out = out / (1 + exp(-out))     (optional swish: __expf and a fast reciprocal)
//   stored rounded to T. This is (x - mean)*rstd*gamma + beta, modulated by
//   (zq.wy + by) and (zq.wb + bb), with the normalize folded into the modulation.
//   ops/fused_norm.py::spatial_norm_apply_replay replays this order on the CPU.
//
// What bounds it on an H100: bytes. It reads f once and writes out once, and reads zq
// (2*|f| + |zq| bytes; 22.6 us at 1x512x192x192 bf16, 3.35 TB/s), against ~20
// operations an element. No product here is worth a tensor core, so the design is a
// streaming pass that keeps enough bytes in flight:
//   - a CTA of 128 threads covers TX*V consecutive pixels (V = 16 / sizeof(T), one
//     16-byte vector a thread) of one image and a block of kc >= 16 channels that is
//     whole groups; its 128/TX thread rows split the block's channels;
//   - a thread loads its 4*V zq values once (kept in f32 registers across the
//     channels), then streams its channels in batches of 4: the 16-byte loads of the
//     next batch are issued before this batch is used (ld.global.nc.L1::no_allocate,
//     every pointer __restrict__), and the stores are streaming (st.global.cs); the
//     loads of zq and of the first batch are issued before the prologue's fold;
//   - TX (128, 64 or 32) is the largest that still gives at least two CTAs an SM, so
//     every APPLY_SHAPES shape fills the card (1x512x64x64: 512 CTAs at TX = 32);
//   - a plane whose length is not a multiple of V takes scalar loads and stores.
//
// Built with nvcc into a shared library with a plain C interface and loaded with
// ctypes (control_gic_tpu_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int Z = 4;                 // zq channels
constexpr int kU = 4;                // channels whose loads are in flight together
constexpr int kMaxKC = 64;           // channels per CTA at most (cg <= 64)
constexpr int kCoef = 12;            // a0, a[Z], b0, b[Z], 2 pad: three float4
constexpr float kEps = 1e-6f;

struct Args {
  const void* f;      // [B, C, HW] T
  const void* zq;     // [B, Z, HW] T
  const float* mom;   // [B, 2, C]: sum, sum of squares over HW
  const float* par;   // [4 + 2Z, C]: gamma, beta, by, bb, wy[Z], wb[Z]
  void* out;          // [B, C, HW] T
  int C, cg, kc;      // channels, channels a group, channels a CTA
  long long HW;
};

template <typename T>
struct Vec;  // one 16-byte vector of T as V floats
template <>
struct Vec<bf16> {
  static constexpr int V = 8;
  __device__ static void unpack(const uint4& u, float (&x)[V]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint4 pack(const float (&x)[V]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ static float load1(const bf16* p) { return __bfloat162float(*p); }
  __device__ static void store1(bf16* p, float v) { *p = __float2bfloat16(v); }
};
template <>
struct Vec<float> {
  static constexpr int V = 4;
  __device__ static void unpack(const uint4& u, float (&x)[V]) {
    x[0] = __uint_as_float(u.x);
    x[1] = __uint_as_float(u.y);
    x[2] = __uint_as_float(u.z);
    x[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float (&x)[V]) {
    return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]), __float_as_uint(x[2]),
                      __float_as_uint(x[3]));
  }
  __device__ static float load1(const float* p) { return *p; }
  __device__ static void store1(float* p, float v) { *p = v; }
};

// A 16-byte load that streams: read-only path, no L1 allocation, a 256-byte L2 fetch;
// volatile, so that it is issued where it is written (before the prologue's barrier).
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

template <bool kSwish>
__device__ __forceinline__ float finish(float v) {
  if (kSwish) v = __fdividef(v, 1.0f + __expf(-v));
  return v;
}

// out for V pixels of one channel from its coefficients (two float4 of a, b and
// one of b's tail) and the pixels' zq
template <bool kSwish, int V>
__device__ __forceinline__ void apply(const float (&x)[V], const float (&z)[Z][V],
                                      const float* __restrict__ k, float (&o)[V]) {
  const float4 k0 = *reinterpret_cast<const float4*>(k);      // a0 a1 a2 a3
  const float4 k1 = *reinterpret_cast<const float4*>(k + 4);  // a4 b0 b1 b2
  const float4 k2 = *reinterpret_cast<const float4*>(k + 8);  // b3 b4 - -
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float a = fmaf(z[0][i], k0.y, k0.x);
    a = fmaf(z[1][i], k0.z, a);
    a = fmaf(z[2][i], k0.w, a);
    a = fmaf(z[3][i], k1.x, a);
    float b = fmaf(z[0][i], k1.z, k1.y);
    b = fmaf(z[1][i], k1.w, b);
    b = fmaf(z[2][i], k2.x, b);
    b = fmaf(z[3][i], k2.y, b);
    o[i] = finish<kSwish>(fmaf(x[i], a, b));
  }
}

template <typename T, int TX, bool kSwish>
__global__ void __launch_bounds__(kThreads, 4) apply_kernel(const Args args) {
  constexpr int V = Vec<T>::V;
  constexpr int TY = kThreads / TX;  // thread rows splitting the channel block
  const int b = blockIdx.z;
  const int C = args.C, cg = args.cg;
  const long long HW = args.HW;
  const int c0 = blockIdx.y * args.kc;
  const int nc = min(args.kc, C - c0);  // whole groups: C and kc are multiples of cg

  const long long p0 = ((long long)blockIdx.x * TX + threadIdx.x) * V;
  const bool active = p0 < HW, vec = HW % V == 0;
  const T* __restrict__ f = static_cast<const T*>(args.f) + ((size_t)b * C + c0) * HW + p0;
  const T* __restrict__ zq = static_cast<const T*>(args.zq) + (size_t)b * Z * HW + p0;
  T* __restrict__ out = static_cast<T*>(args.out) + ((size_t)b * C + c0) * HW + p0;
  const int ty = threadIdx.y;
  // this thread's channels are ty, ty + TY, ...; the loads of zq and of its first kU
  // channels go out before the fold, so that their latency overlaps it
  uint4 zr[Z], cur[kU], nxt[kU];
  if (active && vec) {
#pragma unroll
    for (int zi = 0; zi < Z; ++zi) zr[zi] = __ldg(reinterpret_cast<const uint4*>(zq + zi * HW));
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int ch = ty + u * TY;
      if (ch < nc) cur[u] = ld_stream(f + ch * HW);
    }
  }

  // the group fold and the coefficients, one thread a channel
  __shared__ __align__(16) float coef[kMaxKC][kCoef];
  const int tid = threadIdx.y * TX + threadIdx.x;
  for (int i = tid; i < nc; i += kThreads) {
    const int c = c0 + i;
    const int g0 = c0 + i / cg * cg;
    const float* __restrict__ m = args.mom + (size_t)b * 2 * C;
    float s1 = 0.0f, s2 = 0.0f;
    for (int j = 0; j < cg; ++j) {
      s1 = __fadd_rn(s1, m[g0 + j]);
      s2 = __fadd_rn(s2, m[C + g0 + j]);
    }
    const float n = (float)(HW * cg);
    const float mean = __fdiv_rn(s1, n);
    const float var = fmaxf(__fsub_rn(__fdiv_rn(s2, n), __fmul_rn(mean, mean)), 0.0f);
    const float rstd = rsqrtf(__fadd_rn(var, kEps));
    const float* __restrict__ p = args.par;
    const float s = __fmul_rn(rstd, p[c]);       // gamma
    const float t = fmaf(-mean, s, p[C + c]);    // beta - mean*s
    const float by = p[2 * C + c], bb = p[3 * C + c];
    float* k = coef[i];
    k[0] = __fmul_rn(s, by);
    k[5] = fmaf(t, by, bb);
#pragma unroll
    for (int zi = 0; zi < Z; ++zi) {
      const float wy = p[(4 + zi) * C + c], wb = p[(4 + Z + zi) * C + c];
      k[1 + zi] = __fmul_rn(s, wy);
      k[6 + zi] = fmaf(t, wy, wb);
    }
  }
  __syncthreads();
  if (!active) return;
  float z[Z][V], x[V], o[V];

  if (!vec) {
    // ragged planes: scalar loads and stores of the n pixels inside the plane
    const int n = (int)min((long long)V, HW - p0);
#pragma unroll
    for (int zi = 0; zi < Z; ++zi)
#pragma unroll
      for (int i = 0; i < V; ++i) z[zi][i] = i < n ? Vec<T>::load1(zq + zi * HW + i) : 0.0f;
    for (int ch = ty; ch < nc; ch += TY) {
#pragma unroll
      for (int i = 0; i < V; ++i) x[i] = i < n ? Vec<T>::load1(f + ch * HW + i) : 0.0f;
      apply<kSwish>(x, z, coef[ch], o);
      for (int i = 0; i < n; ++i) Vec<T>::store1(out + ch * HW + i, o[i]);
    }
    return;
  }

#pragma unroll
  for (int zi = 0; zi < Z; ++zi) Vec<T>::unpack(zr[zi], z[zi]);
  // batches of kU channels, the next batch's loads issued before this batch is used
  for (int ch0 = ty; ch0 < nc; ch0 += kU * TY) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int ch = ch0 + (kU + u) * TY;
      if (ch < nc) nxt[u] = ld_stream(f + ch * HW);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int ch = ch0 + u * TY;
      if (ch < nc) {
        Vec<T>::unpack(cur[u], x);
        apply<kSwish>(x, z, coef[ch], o);
        __stcs(reinterpret_cast<uint4*>(out + ch * HW), Vec<T>::pack(o));
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) cur[u] = nxt[u];
  }
}

template <typename T, int TX>
int launch_tx(const Args& a, int B, bool swish, cudaStream_t stream) {
  constexpr int V = Vec<T>::V;
  const long long gx = (a.HW + (long long)TX * V - 1) / ((long long)TX * V);
  const dim3 grid((unsigned)gx, (a.C + a.kc - 1) / a.kc, B), block(TX, kThreads / TX);
  if (swish)
    apply_kernel<T, TX, true><<<grid, block, 0, stream>>>(a);
  else
    apply_kernel<T, TX, false><<<grid, block, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// the current device's SM count, read once a device
int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (!counts[dev] &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return counts[dev];
}

// TX: the largest of 128, 64, 32 that still gives at least two CTAs an SM
template <typename T>
int launch(const Args& a, int B, bool swish, cudaStream_t stream) {
  constexpr int V = Vec<T>::V;
  const int sms = sm_count();
  const long long rest = (long long)((a.C + a.kc - 1) / a.kc) * B;
  const auto ctas = [&](int tx) { return (a.HW + (long long)tx * V - 1) / (tx * V) * rest; };
  if (ctas(128) > 0x7fffffffLL) return -1;
  if (ctas(128) >= 2LL * sms) return launch_tx<T, 128>(a, B, swish, stream);
  if (ctas(64) >= 2LL * sms) return launch_tx<T, 64>(a, B, swish, stream);
  return launch_tx<T, 32>(a, B, swish, stream);
}

}  // namespace

extern "C" {

// a: f, zq, mom, par, out, B, C, HW, dtype (0 = float32, 1 = bfloat16), swish, stream,
// as one block of int64 (the pointers as integers), so that the Python wrapper
// converts one argument. f, zq and out must be 16-byte aligned; C a multiple of 32
// with at most 64 channels a group. Returns 0 or a cudaError_t code; -1 for arguments
// the kernel does not take.
int cgic_spatial_norm_apply(const long long* a) {
  const long long B = a[5], C = a[6], HW = a[7], dtype = a[8];
  if (B <= 0 || B > 65535 || C <= 0 || C % 32 || C / 32 > kMaxKC || HW <= 0) return -1;
  const void* f = reinterpret_cast<const void*>(a[0]);
  const void* zq = reinterpret_cast<const void*>(a[1]);
  const float* mom = reinterpret_cast<const float*>(a[2]);
  const float* par = reinterpret_cast<const float*>(a[3]);
  void* out = reinterpret_cast<void*>(a[4]);
  if (!(f && zq && mom && par && out)) return -1;
  if ((a[0] | a[1] | a[4]) & 15) return -1;
  const int cg = (int)C / 32;
  const int kc = cg * ((16 + cg - 1) / cg);  // whole groups, at least 16 channels
  const Args args{f, zq, mom, par, out, (int)C, cg, kc, HW};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(a[10]);
  if (dtype == 1) return launch<bf16>(args, (int)B, a[9] != 0, s);
  if (dtype == 0) return launch<float>(args, (int)B, a[9] != 0, s);
  return -1;
}

const char* cgic_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// SpatialNorm apply (+ swish) from per-channel GroupNorm stats.
//
// Replaces the Pallas TPU kernel control_gic_tpu/ops/fused_norm.py::_apply_kernel
// (launched by _fused_forward). For f NCHW [B, C, H, W] and zq [B, Z=4, H, W],
// both in T (float32 or bfloat16), one launch computes, per pixel p and channel c:
//   a   = (f.f32 - mean_c) * (rstd_c * gamma_c) + beta_c            (GroupNorm)
//   a   = a * (zq_p . wy_c + by_c) + (zq_p . wb_c + bb_c)   f32, Z = 4 (modulation)
//   a   = a * 1 / (1 + exp(-a))                                      (optional swish)
// and stores a rounded to T. The stats (mean_c, rstd_c) [B, C] f32 come from the
// moment pass (gn_moments.cu + the group fold), as _gn_stats_pallas gives them.
//
// What bounds it on an H100: bytes. It reads f and zq once and writes out once,
// (2*|f| + |zq|) bytes, against ~20 flops per element (22.5 us at 1x512x192x192
// bf16). The design is one streaming pass with 16-byte loads and stores:
//   - a thread owns V = 16 / sizeof(T) consecutive pixels of one image; it loads
//     their 4 zq values per pixel once, into registers, and reuses them for the
//     kChannels channels of its CTA, so zq is read C / kChannels times from L2
//     while f and out stream through once;
//   - the CTA's per-channel parameters (13 floats per channel) are staged in
//     shared memory once;
//   - a plane whose length is not a multiple of V, or a ragged last vector,
//     takes scalar loads and stores.
// The Pallas kernel's [rb, C] row blocks were shaped for TPU VMEM and NHWC; in
// NCHW each (b, c) plane is contiguous, so the pixel axis is the vector axis.
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
constexpr int kChannels = 16;  // channels per CTA
constexpr int Z = 4;           // zq channels
constexpr int kParams = 3 + 2 * (Z + 1);  // mean, scale, beta, wy[Z], by, wb[Z], bb

__device__ inline float to_f(float v) { return v; }
__device__ inline float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ inline T from_f(float v);
template <>
__device__ inline float from_f<float>(float v) { return v; }
template <>
__device__ inline bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

struct Args {
  const void* f;       // [B, C, H, W] T
  const void* zq;      // [B, Z, H, W] T
  const float* mean;   // [B, C]
  const float* rstd;   // [B, C]
  const float* gamma;  // [C]
  const float* beta;   // [C]
  const float* wy;     // [Z, C]
  const float* by;     // [C]
  const float* wb;     // [Z, C]
  const float* bb;     // [C]
  void* out;           // [B, C, H, W] T
  int C;
  long long HW;
  int swish;
};

// V consecutive values of a plane starting at p0 (n of them inside the plane),
// widened to f32: one 16-byte load when `vec`, else scalar loads.
template <typename T, int V>
__device__ inline void load_run(const T* __restrict__ src, bool vec, int n, float (&dst)[V]) {
  if (vec) {
    const uint4 u = *reinterpret_cast<const uint4*>(src);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < V; ++i) dst[i] = to_f(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) dst[i] = i < n ? to_f(src[i]) : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) apply_kernel(const Args a) {
  constexpr int V = 16 / sizeof(T);
  const int b = blockIdx.z;
  const int c0 = blockIdx.y * kChannels;
  const int nc = min(kChannels, a.C - c0);
  const int C = a.C;
  const long long HW = a.HW;

  __shared__ float sp[kParams][kChannels];
  for (int i = threadIdx.x; i < nc; i += kThreads) {
    const int c = c0 + i;
    sp[0][i] = a.mean[(size_t)b * C + c];
    sp[1][i] = a.rstd[(size_t)b * C + c] * a.gamma[c];
    sp[2][i] = a.beta[c];
#pragma unroll
    for (int z = 0; z < Z; ++z) {
      sp[3 + z][i] = a.wy[(size_t)z * C + c];
      sp[4 + Z + z][i] = a.wb[(size_t)z * C + c];
    }
    sp[3 + Z][i] = a.by[c];
    sp[4 + 2 * Z][i] = a.bb[c];
  }
  __syncthreads();

  const long long p0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * V;
  if (p0 >= HW) return;
  const int n = (int)min((long long)V, HW - p0);
  // a plane starts on a 16-byte boundary when HW is a multiple of V (the
  // wrapper checks the base pointers)
  const bool vec = n == V && HW % V == 0;

  float z[Z][V];
  const T* zq = static_cast<const T*>(a.zq) + (size_t)b * Z * HW + p0;
#pragma unroll
  for (int zi = 0; zi < Z; ++zi) load_run<T, V>(zq + (size_t)zi * HW, vec, n, z[zi]);

  const T* f = static_cast<const T*>(a.f);
  T* out = static_cast<T*>(a.out);
  for (int i = 0; i < nc; ++i) {
    const size_t base = ((size_t)b * C + c0 + i) * HW + p0;
    float x[V];
    load_run<T, V>(f + base, vec, n, x);
    const float mean = sp[0][i], scale = sp[1][i], beta = sp[2][i];
    const float by = sp[3 + Z][i], bb = sp[4 + 2 * Z][i];
    alignas(16) T o[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float v = (x[k] - mean) * scale + beta;
      float ym = z[0][k] * sp[3][i];
      float bm = z[0][k] * sp[4 + Z][i];
#pragma unroll
      for (int zi = 1; zi < Z; ++zi) {
        ym = fmaf(z[zi][k], sp[3 + zi][i], ym);
        bm = fmaf(z[zi][k], sp[4 + Z + zi][i], bm);
      }
      v = v * (ym + by) + (bm + bb);
      if (a.swish) v = v * (1.0f / (1.0f + expf(-v)));
      o[k] = from_f<T>(v);
    }
    if (vec) {
      *reinterpret_cast<uint4*>(out + base) = *reinterpret_cast<const uint4*>(o);
    } else {
      for (int k = 0; k < n; ++k) out[base + k] = o[k];
    }
  }
}

template <typename T>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const long long per_cta = (long long)kThreads * V;
  const long long gx = (a.HW + per_cta - 1) / per_cta;
  const int gy = (a.C + kChannels - 1) / kChannels;
  if (gx > 0x7fffffffLL || gy > 65535) return -1;
  const dim3 grid((unsigned)gx, gy, B);
  apply_kernel<T><<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. f, zq and out must be 16-byte aligned.
// Returns 0 or a cudaError_t code; -1 for arguments the kernel does not take.
int cgic_spatial_norm_apply(const void* f, const void* zq, const float* mean, const float* rstd,
                            const float* gamma, const float* beta, const float* wy,
                            const float* by, const float* wb, const float* bb, void* out, int B,
                            int C, long long HW, int dtype, int swish, void* stream) {
  if (B <= 0 || B > 65535 || C <= 0 || HW <= 0) return -1;
  if (!(f && zq && mean && rstd && gamma && beta && wy && by && wb && bb && out)) return -1;
  if (((uintptr_t)f | (uintptr_t)zq | (uintptr_t)out) & 15) return -1;
  const Args a{f, zq, mean, rstd, gamma, beta, wy, by, wb, bb, out, C, HW, swish};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<bf16>(a, B, s);
  if (dtype == 0) return launch<float>(a, B, s);
  return -1;
}

const char* cgic_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

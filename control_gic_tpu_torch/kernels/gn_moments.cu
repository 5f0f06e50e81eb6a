// GroupNorm moment pass: per-(batch, channel) sum and sum of squares in f32.
//
// Replaces the Pallas TPU kernel control_gic_tpu/ops/fused_norm.py::_stats_kernel
// (launched by _gn_stats_pallas). Input x is NCHW [B, C, H, W], contiguous,
// float32 or bfloat16; output mom is [B, 2, C] f32: mom[b, 0, c] = sum over
// H*W of x, mom[b, 1, c] = sum of x*x, both of x's values widened to f32.
// The group fold (mean, var, rstd) is tiny [B, C] work done in torch
// (ops/fused_norm.py::gn_stats_from_moments), as XLA did it after the kernel.
//
// What bounds it on an H100: bytes. It reads x once (at 512x768x256 bf16,
// 201 MB against 3.35 TB/s is 0.060 ms) and does two flops per element. In
// NCHW each (b, c) plane is H*W contiguous elements, so one CTA of 512
// threads reduces one plane: 16-byte vector loads, each thread summing a
// strided run in registers, then a warp shuffle tree and a tree over warps in
// shared memory. The order of every sum is fixed by the thread layout, so the
// result is bit-stable from run to run (no float atomics). At B*C = 128 or
// 256 planes every SM gets one or two CTAs with 16 warps of loads in flight.
// The Pallas kernel's row blocks (sized for TPU VMEM) do not carry over.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (control_gic_tpu_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__device__ inline float to_f(float v) { return v; }
__device__ inline float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ inline void add_vec(const uint4& u, float& s1, float& s2) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < (int)(16 / sizeof(T)); ++i) {
    const float v = to_f(e[i]);
    s1 += v;
    s2 += v * v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_moments_kernel(const T* __restrict__ x, float* __restrict__ mom, int C, long long HW) {
  constexpr int VEC = 16 / sizeof(T);
  const int c = blockIdx.x;
  const int b = blockIdx.y;
  const T* plane = x + ((long long)b * C + c) * HW;
  float s1 = 0.0f, s2 = 0.0f;
  const bool vec_ok = (HW % VEC == 0) && ((reinterpret_cast<uintptr_t>(plane) & 15) == 0);
  if (vec_ok) {
    const uint4* pv = reinterpret_cast<const uint4*>(plane);
    const long long nv = HW / VEC;
    long long i = threadIdx.x;
    // two loads in flight per thread per step
    for (; i + kThreads < nv; i += 2 * kThreads) {
      const uint4 u0 = __ldg(pv + i);
      const uint4 u1 = __ldg(pv + i + kThreads);
      add_vec<T>(u0, s1, s2);
      add_vec<T>(u1, s1, s2);
    }
    if (i < nv) add_vec<T>(__ldg(pv + i), s1, s2);
  } else {
    for (long long i = threadIdx.x; i < HW; i += kThreads) {
      const float v = to_f(plane[i]);
      s1 += v;
      s2 += v * v;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  }
  __shared__ float red[2][kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red[0][warp] = s1;
    red[1][warp] = s2;
  }
  __syncthreads();
  if (warp == 0) {
    s1 = lane < kWarps ? red[0][lane] : 0.0f;
    s2 = lane < kWarps ? red[1][lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    if (lane == 0) {
      mom[((long long)b * 2 + 0) * C + c] = s1;
      mom[((long long)b * 2 + 1) * C + c] = s2;
    }
  }
}

template <typename T>
int launch(const void* x, void* mom, int B, int C, long long HW, cudaStream_t stream) {
  const dim3 grid(C, B);
  gn_moments_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x),
                                                      static_cast<float*>(mom), C, HW);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns 0 or a cudaError_t code; -1 for
// arguments the kernel does not take.
int cgic_gn_moments(const void* x, void* mom, int B, int C, long long HW, int dtype,
                    void* stream) {
  if (B <= 0 || C <= 0 || HW <= 0 || B > 65535) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<bf16>(x, mom, B, C, HW, s);
  if (dtype == 0) return launch<float>(x, mom, B, C, HW, s);
  return -1;
}

const char* cgic_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

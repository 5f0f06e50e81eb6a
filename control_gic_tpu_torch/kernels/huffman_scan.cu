// Huffman decoding by a walk of the decode table, one thread a stream.
//
// The counterpart of control_gic_tpu/coding/huffman_decode_tpu.py::
// huffman_decode_bits_scan, a lax.scan (not a Pallas kernel): S streams
// ("lanes", one per image of a batch for one grain's stream), each decoded
// from bit 0 by repeating, for k < n_cap,
//   idx = the L-bit window at bit `off` (MSB-first 32-bit words),
//   out[s, k] = lut_sym[idx],
//   off = min(off + lut_len[idx], n_cap * L),
// with out[s, k] = 0 from the lane's count on. The plain version is
// huffman_decode_bits_scan_reference in coding/huffman_decode_device.py.
//
// What bounds it on an H100: neither bytes nor operations but latency. Each
// symbol's offset depends on the previous symbol's code length, a table
// load, so a lane is one chain of dependent loads, and a batch has only a
// few lanes (2 to 8 streams). The design keeps that chain short:
//   - one block per lane; its threads stage the table in shared memory when
//     both arrays fit in the default 48 KB (L <= 12: 2 x 4096 int32), so a
//     step waits on a shared-memory load; longer tables are read through
//     the read-only path (__ldg), where they stay in L1 and L2;
//   - the lane's bits sit in a 64-bit window in registers (words wi and
//     wi + 1) with the next word already loaded, so a refill never waits;
//   - the decoding thread stops at the lane's count, and the block's other
//     threads write the zeros past it.
// Splitting a lane at self-synchronising points, so that many threads walk
// one stream, is later work.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (control_gic_tpu_torch/kernels/build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemLutBits = 12;   // 2 x 2^12 int32 = 32 KB of shared memory

template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
huffman_scan_kernel(const uint32_t* __restrict__ payloads, const int* __restrict__ counts,
                    const int* __restrict__ lut_sym, const int* __restrict__ lut_len,
                    int* __restrict__ out, int W, int n_cap, int L) {
  extern __shared__ int smem[];
  const int s = blockIdx.x;
  const uint32_t* words = payloads + (long long)s * W;
  int* row = out + (long long)s * n_cap;
  const int n_dec = min(max(counts[s], 0), n_cap);

  const int* sym_tab = lut_sym;
  const int* len_tab = lut_len;
  if (kSmem) {
    const int size = 1 << L;
    for (int i = threadIdx.x; i < size; i += kThreads) {
      smem[i] = __ldg(lut_sym + i);
      smem[size + i] = __ldg(lut_len + i);
    }
    __syncthreads();
    sym_tab = smem;
    len_tab = smem + size;
  }
  for (int k = n_dec + threadIdx.x; k < n_cap; k += kThreads) row[k] = 0;
  if (threadIdx.x != 0) return;

  const int t_max = n_cap * L;
  const int shift = 64 - L;
  // window = words wi, wi + 1 (bits [32 wi, 32 wi + 64)); nxt = word wi + 2
  int wi = 0;
  uint64_t window = ((uint64_t)__ldg(words) << 32) | __ldg(words + 1);
  uint32_t nxt = (2 < W) ? __ldg(words + 2) : 0u;
  int off = 0;
  for (int k = 0; k < n_dec; ++k) {
    const int bo = off - (wi << 5);  // 0..31
    const int idx = (int)((window << bo) >> shift);
    int len, sym;
    if (kSmem) {
      len = len_tab[idx];
      sym = sym_tab[idx];
    } else {
      len = __ldg(len_tab + idx);
      sym = __ldg(sym_tab + idx);
    }
    row[k] = sym;
    off = min(off + len, t_max);
    // a code is at most 20 bits, so the offset leaves the window's first
    // word at most one word at a time
    if ((off >> 5) > wi) {
      ++wi;
      window = (window << 32) | nxt;
      nxt = (wi + 2 < W) ? __ldg(words + wi + 2) : 0u;
    }
  }
}

}  // namespace

extern "C" {

// payloads [S, W] 32-bit words (MSB-first), counts [S], lut_sym and lut_len
// [2^L], out [S, n_cap], all int32 on one device; W >= n_cap * L / 32 + 2.
// Returns 0 or a cudaError_t code; -1 for arguments the kernel does not take.
int cgic_huffman_scan(const void* payloads, const void* counts, const void* lut_sym,
                      const void* lut_len, void* out, int S, int W, int n_cap, int L,
                      void* stream) {
  if (S <= 0 || n_cap <= 0 || L < 1 || L > 20) return -1;
  if ((long long)n_cap * L >= (1LL << 31) || (long long)W < (long long)n_cap * L / 32 + 2)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* p = static_cast<const uint32_t*>(payloads);
  const int* c = static_cast<const int*>(counts);
  const int* ls = static_cast<const int*>(lut_sym);
  const int* ll = static_cast<const int*>(lut_len);
  int* o = static_cast<int*>(out);
  if (L <= kSmemLutBits) {
    const size_t smem = sizeof(int) * 2 * ((size_t)1 << L);
    huffman_scan_kernel<true><<<S, kThreads, smem, st>>>(p, c, ls, ll, o, W, n_cap, L);
  } else {
    huffman_scan_kernel<false><<<S, kThreads, 0, st>>>(p, c, ls, ll, o, W, n_cap, L);
  }
  return (int)cudaGetLastError();
}

const char* cgic_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

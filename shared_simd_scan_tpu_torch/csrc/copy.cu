// Full-buffer byte copy: the benchmark's bandwidth yardstick.
//
// Replaces shared_simd_scan_tpu/bench/harness.py: _memcpy_kernel /
// chain_memcpy, a copy of the whole buffer in (tb, 1024) uint32 blocks, in
// place by input_output_aliases, so that each call reads and writes every
// byte once.  Here a call copies one buffer into another; the benchmark's
// chain copies back and forth between two equal buffers, so each call still
// reads and writes every byte once.
//
// Bound on the H100: device memory bytes (nbytes read + nbytes written over
// 3.35 TB/s).  Design: 16-byte vector loads and stores; each thread issues
// kCopyBatch loads (coalesced across the warp, a stride of blockDim.x
// vectors apart) before its stores, so several loads are in flight per
// thread; streaming cache hints (__ldcs / __stcs), since every byte is
// touched once.  The bytes past the last whole vector are copied one by one
// by the first threads of CTA 0.  Both pointers must be 16-byte aligned.
#include "common.cuh"

namespace sss {

constexpr int kCopyThreads = 256;
constexpr int kCopyBatch = 8;

__global__ void __launch_bounds__(kCopyThreads)
copy_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst, long long nvec,
            const uint8_t* __restrict__ src_tail, uint8_t* __restrict__ dst_tail, int tail) {
  const long long first = (long long)blockIdx.x * (kCopyThreads * kCopyBatch) + threadIdx.x;
  uint4 r[kCopyBatch];
#pragma unroll
  for (int u = 0; u < kCopyBatch; ++u) {
    const long long i = first + (long long)u * kCopyThreads;
    r[u] = i < nvec ? __ldcs(src + i) : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int u = 0; u < kCopyBatch; ++u) {
    const long long i = first + (long long)u * kCopyThreads;
    if (i < nvec) __stcs(dst + i, r[u]);
  }
  if (blockIdx.x == 0 && threadIdx.x < tail) dst_tail[threadIdx.x] = src_tail[threadIdx.x];
}

}  // namespace sss

// Copy nbytes from src to dst (both 16-byte aligned, not overlapping).
extern "C" int sss_copy(const void* src, void* dst, long long nbytes, cudaStream_t stream) {
  if (nbytes < 0 || reinterpret_cast<uintptr_t>(src) % 16 || reinterpret_cast<uintptr_t>(dst) % 16)
    return (int)cudaErrorInvalidValue;
  if (nbytes == 0) return (int)cudaSuccess;
  const long long nvec = nbytes / 16;
  const int tail = (int)(nbytes % 16);
  const long long per_cta = (long long)sss::kCopyThreads * sss::kCopyBatch;
  const long long grid = nvec > 0 ? (nvec + per_cta - 1) / per_cta : 1;
  if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  sss::copy_kernel<<<(unsigned)grid, sss::kCopyThreads, 0, stream>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst), nvec,
      static_cast<const uint8_t*>(src) + nvec * 16, static_cast<uint8_t*>(dst) + nvec * 16, tail);
  return (int)cudaGetLastError();
}

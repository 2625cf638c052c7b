// Unpack (decompress) and pack (compress) kernels for the tile layout.
//
// Replace shared_simd_scan_tpu/ops/unpack.py: _unpack_kernel / unpack_tiles
// and _pack_kernel / pack_tiles.
//
// Bound on the H100: device memory bytes.  Unpack reads W words per 32
// values and writes 32; pack the reverse; both do a few integer ops per
// value.  Design: one thread per 32-value block, the schedule a template on
// W so every word index and shift is a constant and the block's words stay
// in registers; each warp's load or store of one row is 128 contiguous
// bytes.  No shared memory, no staging: later work (cp.async / TMA, wider
// per-thread loads) starts from here.
#include "common.cuh"

namespace sss {

template <int W>
__global__ void __launch_bounds__(kThreads)
unpack_kernel(const uint32_t* __restrict__ tiles, uint32_t* __restrict__ vals, long long nblocks) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nblocks) return;
  uint32_t w[W];
  load_block<W>(tiles, nblocks, b, true, w);
#pragma unroll
  for (int r = 0; r < kBlockValues; ++r) vals[(size_t)r * nblocks + b] = unpack_value<W>(w, r);
}

template <int W>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const uint32_t* __restrict__ vals, uint32_t* __restrict__ tiles, long long nblocks) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nblocks) return;
  uint32_t w[W];
#pragma unroll
  for (int j = 0; j < W; ++j) w[j] = 0u;
  // layout.pack_schedule: value r adds v << s to word k and, when it
  // straddles, v >> (32-s) to word k+1.  Values are masked to W bits first.
#pragma unroll
  for (int r = 0; r < kBlockValues; ++r) {
    const uint32_t v = __ldg(vals + (size_t)r * nblocks + b) & value_mask<W>();
    const int k = slot_word<W>(r), s = slot_shift<W>(r);
    w[k] |= v << s;
    if (slot_straddles<W>(r)) w[k + 1 < W ? k + 1 : k] |= v >> (32 - s);
  }
#pragma unroll
  for (int j = 0; j < W; ++j) tiles[(size_t)j * nblocks + b] = w[j];
}

}  // namespace sss

extern "C" int sss_unpack(const uint32_t* tiles, uint32_t* vals, long long nblocks, int width,
                          cudaStream_t stream) {
  if (nblocks <= 0) return (int)cudaSuccess;
  const unsigned grid = sss::grid_for(nblocks);
  switch (width) {
#define SSS_CASE(W)                                                                   \
  case W:                                                                             \
    sss::unpack_kernel<W><<<grid, sss::kThreads, 0, stream>>>(tiles, vals, nblocks);  \
    break;
    SSS_FOR_EACH_WIDTH(SSS_CASE)
#undef SSS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int sss_pack(const uint32_t* vals, uint32_t* tiles, long long nblocks, int width,
                        cudaStream_t stream) {
  if (nblocks <= 0) return (int)cudaSuccess;
  const unsigned grid = sss::grid_for(nblocks);
  switch (width) {
#define SSS_CASE(W)                                                                 \
  case W:                                                                           \
    sss::pack_kernel<W><<<grid, sss::kThreads, 0, stream>>>(vals, tiles, nblocks);  \
    break;
    SSS_FOR_EACH_WIDTH(SSS_CASE)
#undef SSS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* sss_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

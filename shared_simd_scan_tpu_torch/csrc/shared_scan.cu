// General compare shared scan: k arbitrary equality keys in one pass.
//
// Replaces shared_simd_scan_tpu/ops/scan.py: _shared_scan_kernel /
// shared_scan_tiles, with its semantics:
//  - a slot that does not straddle a word boundary compares the word ANDed
//    with the clean mask (mask << s, value left in place) against key << s;
//    a straddling slot compares the normalized value against the key;
//  - a key >= 2^W is replaced by 0xFFFFFFFF for the clean compare, which no
//    cleaned word can equal (its bits outside [s, s+W) are zero);
//  - the validity word of the global block block_offset + b clears bits of
//    values at index >= n, so key 0 never matches the zero padding.
//
// Bound on the H100: device memory bytes for small k (reads W words, writes
// k words per 32 values); integer issue for large k (~3 ops per slot per
// key).  Design: one thread per 32-value block; the 32 compare operands are
// built once per block in registers and reused by every key; keys are read
// through the read-only cache (every lane reads the same key).  Hit counts
// are reduced per warp (__reduce_add_sync), per CTA in shared memory, and
// added to the int64 totals with one atomic per key per CTA.
#include "common.cuh"

namespace sss {

template <int W>
__global__ void __launch_bounds__(kThreads)
shared_scan_kernel(const uint32_t* __restrict__ tiles, const uint32_t* __restrict__ keys, int k,
                   uint32_t* __restrict__ bits, unsigned long long* __restrict__ counts,
                   long long nblocks, long long n, long long block_offset) {
  __shared__ unsigned s_cnt[kMaxKeys];
  zero_counts(s_cnt, k);
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = b < nblocks;
  uint32_t w[W];
  load_block<W>(tiles, nblocks, b, active, w);
  const uint32_t valid = active ? valid_word(block_offset + b, n) : 0u;

  // Compare operand per slot: the cleaned word, or the normalized value.
  uint32_t x[kBlockValues];
#pragma unroll
  for (int r = 0; r < kBlockValues; ++r)
    x[r] = slot_straddles<W>(r) ? unpack_value<W>(w, r)
                                : w[slot_word<W>(r)] & (value_mask<W>() << slot_shift<W>(r));

  for (int j = 0; j < k; ++j) {
    const uint32_t key = __ldg(keys + j);
    const bool in_domain = key <= value_mask<W>();
    uint32_t acc = 0u;
#pragma unroll
    for (int r = 0; r < kBlockValues; ++r) {
      const uint32_t want = slot_straddles<W>(r)
                                ? key
                                : (in_domain ? key << slot_shift<W>(r) : 0xFFFFFFFFu);
      acc |= (uint32_t)(x[r] == want) << r;
    }
    store_row(bits, nblocks, b, active, j, acc & valid, s_cnt);
  }
  flush_counts(s_cnt, k, counts);
}

}  // namespace sss

// Keys are launched in chunks of kMaxKeys (the shared counters' size); each
// chunk writes its own rows of bits and counts.
extern "C" int sss_shared_scan(const uint32_t* tiles, const uint32_t* keys, int k, uint32_t* bits,
                               unsigned long long* counts, long long nblocks, int width,
                               long long n, long long block_offset, cudaStream_t stream) {
  if (nblocks <= 0 || k <= 0) return (int)cudaSuccess;
  const unsigned grid = sss::grid_for(nblocks);
  for (int j0 = 0; j0 < k; j0 += sss::kMaxKeys) {
    const int kc = k - j0 < sss::kMaxKeys ? k - j0 : sss::kMaxKeys;
    uint32_t* bits_c = bits + (size_t)j0 * nblocks;
    switch (width) {
#define SSS_CASE(W)                                                               \
  case W:                                                                         \
    sss::shared_scan_kernel<W><<<grid, sss::kThreads, 0, stream>>>(               \
        tiles, keys + j0, kc, bits_c, counts + j0, nblocks, n, block_offset);     \
    break;
      SSS_FOR_EACH_WIDTH(SSS_CASE)
#undef SSS_CASE
      default:
        return (int)cudaErrorInvalidValue;
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

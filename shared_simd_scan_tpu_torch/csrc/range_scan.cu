// Range-predicate shared scan: k half-open ranges [lo_j, hi_j) in one pass.
//
// Replaces shared_simd_scan_tpu/ops/scan.py: _range_scan_kernel /
// range_scan_tiles, with its semantics: value v is in range j iff
// (v - lo_j) mod 2^32 < (hi_j - lo_j) mod 2^32.  hi < lo is a wrapped,
// non-empty span (unlike the conjunction kernel, which clamps it to
// empty), and hi = 2^32, passed as 0, is the range [lo, 2^32).  The member
// scan's interval tier runs here with one range [lo, lo + k).
//
// The zone map's pruned span (shared_simd_scan_tpu/zonemap.py
// _pruned_range_tiles) runs here too: the reference copies the span out
// (dynamic_slice) and scans the copy; here the caller passes pointers to
// the span's first block and the column's row length `ld` as the stride of
// both the tiles and the bits, so the kernel reads the span in place and
// writes into the column's full-length rows (zeroed by the caller).
//
// Bound on the H100: device memory bytes (reads W words, writes k words per
// 32 values) for small k; integer issue for large k (~3 ops per value per
// range).  Design: one thread per 32-value block; the 32 values are
// unpacked once into registers and reused by every range; the bounds are
// read through the read-only cache (every lane reads the same range).
// Counts as in shared_scan.cu.
#include "common.cuh"

namespace sss {

template <int W>
__global__ void __launch_bounds__(kThreads)
range_scan_kernel(const uint32_t* __restrict__ tiles, const uint32_t* __restrict__ lows,
                  const uint32_t* __restrict__ highs, int k, uint32_t* __restrict__ bits,
                  unsigned long long* __restrict__ counts, long long nblocks, long long ld,
                  long long n, long long block_offset) {
  __shared__ unsigned s_cnt[kMaxKeys];
  zero_counts(s_cnt, k);
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = b < nblocks;
  uint32_t w[W];
  load_block<W>(tiles, ld, b, active, w);
  const uint32_t valid = active ? valid_word(block_offset + b, n) : 0u;

  uint32_t v[kBlockValues];
  unpack_values<W>(w, v);

  for (int j = 0; j < k; ++j) {
    const uint32_t lo = __ldg(lows + j);
    const uint32_t span = __ldg(highs + j) - lo;  // uint32 wrap, as the reference
    store_row(bits, ld, b, active, j, range_word(v, lo, span) & valid, s_cnt);
  }
  flush_counts(s_cnt, k, counts);
}

}  // namespace sss

// Scans blocks 0..nblocks-1 of rows of `ld` words (ld >= nblocks; ld =
// nblocks for a whole column).  Ranges are launched in chunks of kMaxKeys
// (the shared counters' size); each chunk writes its own rows of bits and
// counts.
extern "C" int sss_range_scan(const uint32_t* tiles, const uint32_t* lows, const uint32_t* highs,
                              int k, uint32_t* bits, unsigned long long* counts,
                              long long nblocks, long long ld, int width, long long n,
                              long long block_offset, cudaStream_t stream) {
  if (ld < nblocks) return (int)cudaErrorInvalidValue;
  if (nblocks <= 0 || k <= 0) return (int)cudaSuccess;
  const unsigned grid = sss::grid_for(nblocks);
  for (int j0 = 0; j0 < k; j0 += sss::kMaxKeys) {
    const int kc = k - j0 < sss::kMaxKeys ? k - j0 : sss::kMaxKeys;
    uint32_t* bits_c = bits + (size_t)j0 * ld;
    switch (width) {
#define SSS_CASE(W)                                                                     \
  case W:                                                                               \
    sss::range_scan_kernel<W><<<grid, sss::kThreads, 0, stream>>>(                      \
        tiles, lows + j0, highs + j0, kc, bits_c, counts + j0, nblocks, ld, n,          \
        block_offset);                                                                  \
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

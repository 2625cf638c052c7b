// Zone-gated range scan: k half-open ranges over the live steps of a
// column only.
//
// Replaces shared_simd_scan_tpu/zonemap.py _zoned_range_kernel /
// _zoned_range_tiles.  A step is `step_blocks` consecutive blocks (tb
// block rows of 128); entry s of the step list runs step idx[s], and
// counts only when flag[s] == 1 (the reference pads its list to a power
// of two with repeats of a live step and flag 0, and the interface is kept
// so the two map one to one; the port itself passes the live steps only).
// Blocks of steps that no entry names are not read and their bits are not
// written: the caller zero-fills the bits.  The range compare is
// range_scan.cu's, with its semantics.
//
// Bound on the H100: the bytes of the live steps (W words read and k words
// written per 32 values); a few live steps are a handful of CTAs, so a
// pruned call costs about a launch.  Design: the reference's gather grid
// (scalar-prefetched step indices routing each grid step's DMA) becomes a
// flat grid of (list entry, CTA within the step); each CTA reads its
// entry's step and flag from device memory.  Counts as in shared_scan.cu,
// skipped for flag 0.
#include "common.cuh"

namespace sss {

template <int W>
__global__ void __launch_bounds__(kThreads)
zoned_range_kernel(const uint32_t* __restrict__ tiles, const int* __restrict__ idx,
                   const int* __restrict__ flag, int ctas_per_step,
                   const uint32_t* __restrict__ lows, const uint32_t* __restrict__ highs, int k,
                   uint32_t* __restrict__ bits, unsigned long long* __restrict__ counts,
                   long long nblocks, long long step_blocks, long long n) {
  __shared__ unsigned s_cnt[kMaxKeys];
  zero_counts(s_cnt, k);
  const int s = blockIdx.x / ctas_per_step;
  const long long within = (long long)(blockIdx.x % ctas_per_step) * blockDim.x + threadIdx.x;
  const long long b = (long long)__ldg(idx + s) * step_blocks + within;
  const bool live = __ldg(flag + s) == 1;  // CTA-uniform
  const bool active = within < step_blocks && b >= 0 && b < nblocks;
  uint32_t w[W];
  load_block<W>(tiles, nblocks, b, active, w);
  const uint32_t valid = active ? valid_word(b, n) : 0u;

  uint32_t v[kBlockValues];
  unpack_values<W>(w, v);

  for (int j = 0; j < k; ++j) {
    const uint32_t lo = __ldg(lows + j);
    const uint32_t word = range_word(v, lo, __ldg(highs + j) - lo) & valid;
    if (active) bits[(size_t)j * nblocks + b] = word;
    if (live) count_row(j, word, s_cnt);
  }
  flush_counts(s_cnt, k, counts);
}

}  // namespace sss

// g list entries (idx, flag: int32[g] in device memory) over steps of
// step_blocks blocks; k <= kMaxKeys ranges.
extern "C" int sss_zoned_range_scan(const uint32_t* tiles, const int* idx, const int* flag, int g,
                                    const uint32_t* lows, const uint32_t* highs, int k,
                                    uint32_t* bits, unsigned long long* counts, long long nblocks,
                                    long long step_blocks, int width, long long n,
                                    cudaStream_t stream) {
  if (k < 1 || k > sss::kMaxKeys || step_blocks <= 0) return (int)cudaErrorInvalidValue;
  if (g <= 0 || nblocks <= 0) return (int)cudaSuccess;
  const long long per = (step_blocks + sss::kThreads - 1) / sss::kThreads;
  if (per * g > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(per * g);
  switch (width) {
#define SSS_CASE(W)                                                                   \
  case W:                                                                             \
    sss::zoned_range_kernel<W><<<grid, sss::kThreads, 0, stream>>>(                   \
        tiles, idx, flag, (int)per, lows, highs, k, bits, counts, nblocks, step_blocks, \
        n);                                                                           \
    break;
    SSS_FOR_EACH_WIDTH(SSS_CASE)
#undef SSS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

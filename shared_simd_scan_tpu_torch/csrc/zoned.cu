// Zone-gated range scan: k half-open ranges over the listed steps of a
// column, one call that writes every word of the k rows.
//
// Replaces shared_simd_scan_tpu/zonemap.py _zoned_range_kernel /
// _zoned_range_tiles.  A step is `step_blocks` consecutive blocks (tb block
// rows of 128); entry s of the list names step idx[s] and counts only when
// flag[s] == 1 (the reference pads its list with flag-0 repeats of a live
// step; the interface is kept so the two map one to one).  A listed step's
// bits are its blocks' range words whatever its flag, and its counts are
// added once for each of its flag-1 entries; every other block's bits are
// 0, as in the reference's zeroed buffer aliased to its output.  Entries
// come in any order and may repeat; one outside the column writes and
// counts nothing.  The range compare is range_scan.cu's, with its
// semantics.
//
// Bound on the H100: device-memory bytes -- the listed steps' W words read
// and all k * nblocks words of the rows written; with a few listed steps
// the rows' writes are nearly all of it.  Design: the C entry zeroes the
// rows and the counts on the stream (cudaMemsetAsync), then launches the
// reference's gather grid as a flat grid of (list entry, tile of 256
// blocks of its step), each CTA loading its blocks' words and storing
// their range words & valid (a repeated entry stores the same words
// again), counting them for a flag-1 entry.  Section zoned of
// bench/redesign_sweep.py (NVIDIA H100 80GB HBM3, 700 W; 1-227 of 456
// steps listed, widths 9 and 31, device time with the L2 flushed before
// each call, two calls) held this against designs that write every word
// in one launch: zero-filling CTAs storing the unlisted steps' zeros (bulk
// copies of zeroed shared memory or 16-byte stores, 1-8 a multiprocessor)
// beside this grid ran 2.6-7.9% ahead at width 9 and from 2.5% ahead to
// 3.4% behind at width 31, for some 150 more lines; CTAs walking the rows
// a run of 2-16 tiles each, reading the entries themselves, took
// 1.01-1.34x its time with 1-50 steps listed and 1-8.5% less with 227.
//
// The count form (bits == nullptr) writes no row: its flag-0 entries'
// CTAs return at once, the others read the listed steps and count.
#include "common.cuh"

namespace sss {

constexpr long long kStepAlign = 128;  // step_blocks and nblocks are whole block rows

// CTA `cta` of the flat grid: tile cta % tiles_per_step of entry cta /
// tiles_per_step's step, its blocks' range words & valid stored (bits not
// null) and counted for a flag-1 entry.  An entry outside the column, and
// in the count form a flag-0 one, returns at once.
template <int W>
__device__ __forceinline__ void zoned_tile(
    int cta, const uint32_t* __restrict__ tiles, const int* __restrict__ idx,
    const int* __restrict__ flag, int tiles_per_step, const uint32_t* __restrict__ lows,
    const uint32_t* __restrict__ highs, int k, uint32_t* __restrict__ bits,
    unsigned long long* __restrict__ counts, long long nblocks, long long step_blocks,
    long long n, unsigned* s_cnt) {
  const int e = cta / tiles_per_step;
  const long long s = __ldg(idx + e);
  const long long within = (long long)(cta % tiles_per_step) * kThreads;
  const bool counted = __ldg(flag + e) == 1;
  // CTA-uniform
  if (s < 0 || s * step_blocks >= nblocks || (bits == nullptr && !counted)) return;
  zero_counts(s_cnt, k);
  const long long b = s * step_blocks + within + threadIdx.x;
  const bool active = within + threadIdx.x < step_blocks && b < nblocks;
  uint32_t w[W];
  load_block<W>(tiles, nblocks, b, active, w);
  const uint32_t valid = active ? valid_word(b, n) : 0u;
  uint32_t v[kBlockValues];
  unpack_values<W>(w, v);
  for (int j = 0; j < k; ++j) {
    const uint32_t lo = __ldg(lows + j);
    const uint32_t word = range_word(v, lo, __ldg(highs + j) - lo) & valid;
    if (bits != nullptr && active) bits[(size_t)j * nblocks + b] = word;
    if (counted) count_row(j, word, s_cnt);
  }
  flush_counts(s_cnt, k, counts);
}

template <int W>
__global__ void __launch_bounds__(kThreads)
zoned_range_kernel(const uint32_t* __restrict__ tiles, const int* __restrict__ idx,
                   const int* __restrict__ flag, int tiles_per_step,
                   const uint32_t* __restrict__ lows, const uint32_t* __restrict__ highs, int k,
                   uint32_t* __restrict__ bits, unsigned long long* __restrict__ counts,
                   long long nblocks, long long step_blocks, long long n) {
  __shared__ unsigned s_cnt[kMaxKeys];
  zoned_tile<W>((int)blockIdx.x, tiles, idx, flag, tiles_per_step, lows, highs, k, bits, counts,
                nblocks, step_blocks, n, s_cnt);
}

// The checks of the C entry; cudaSuccess when the call may go on.
inline cudaError_t zoned_args_ok(int g, int k, long long nblocks, long long step_blocks,
                                 int width) {
  if (g < 0 || k < 1 || k > kMaxKeys || !width_ok(width) || step_blocks <= 0 ||
      step_blocks % kStepAlign || nblocks < 0 || nblocks % kStepAlign)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace sss

// g list entries (idx, flag: int32[g] in device memory) over steps of
// step_blocks blocks (a multiple of 128, as nblocks is); k <= kMaxKeys
// ranges.  bits uint32[k][nblocks], every word written, or nullptr for the
// count form; counts uint64[k].  Both zeroed here on the stream, then one
// launch.
extern "C" int sss_zoned_range_scan(const uint32_t* tiles, const int* idx, const int* flag, int g,
                                    const uint32_t* lows, const uint32_t* highs, int k,
                                    uint32_t* bits, unsigned long long* counts, long long nblocks,
                                    long long step_blocks, int width, long long n,
                                    cudaStream_t stream) {
  cudaError_t err = sss::zoned_args_ok(g, k, nblocks, step_blocks, width);
  if (err == cudaSuccess) err = cudaMemsetAsync(counts, 0, (size_t)k * 8, stream);
  if (err == cudaSuccess && bits != nullptr)
    err = cudaMemsetAsync(bits, 0, (size_t)k * nblocks * 4, stream);
  if (err != cudaSuccess || g == 0 || nblocks == 0) return (int)err;
  const long long per = (step_blocks + sss::kThreads - 1) / sss::kThreads;
  if (per * g > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  switch (width) {
#define SSS_CASE(W)                                                                        \
  case W:                                                                                  \
    sss::zoned_range_kernel<W><<<(unsigned)(per * g), sss::kThreads, 0, stream>>>(         \
        tiles, idx, flag, (int)per, lows, highs, k, bits, counts, nblocks, step_blocks, n); \
    break;
    SSS_FOR_EACH_WIDTH(SSS_CASE)
#undef SSS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

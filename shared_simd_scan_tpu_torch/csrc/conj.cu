// Conjunctive multi-column scan: AND of one half-open range per column.
//
// Replaces shared_simd_scan_tpu/ops/conj.py: _conj_range_kernel /
// conj_range_scan_tiles, with its semantics: m <= 8 columns of the same n
// (so the same block layout), one range [lo_c, hi_c) each, matched as
// (v - lo_c) mod 2^32 < span_c with span_c = hi_c > lo_c ? hi_c - lo_c : 0
// (inverted bounds are an empty range here, not a wrapped one), ANDed over
// the columns into one bitvector row and one count.
//
// Bound on the H100: device memory bytes (reads sum(W_c) words, writes one
// word per 32 values).  Design: one fused pass, as the reference: one
// thread per 32-value block reads its block of every column once, and only
// the AND is stored, so no per-column row ever reaches device memory.  The
// columns' widths differ, so width cannot be one template argument: the
// columns come in a by-value struct (pointers, widths, bounds) and a
// switch on each column's width (uniform across the grid) picks a
// template <int W> block matcher whose unpack schedule is constant.
// Counts as in shared_scan.cu, with one row.
//
// A zone map's pruned span runs here too, as in range_scan.cu: the caller
// passes pointers to the span's first block of each column and of the bits,
// and the columns' row length `ld` as the stride of the tiles, so the kernel
// reads the span in place and writes into the column's full-length row
// (zeroed by the caller).
#include "common.cuh"

namespace sss {

constexpr int kMaxColumns = 8;

struct ConjColumns {
  const uint32_t* tiles[kMaxColumns];
  int width[kMaxColumns];
  uint32_t lo[kMaxColumns];
  uint32_t span[kMaxColumns];
  int m;
};

// Bit r set iff value r of block b lies in the column's range.
template <int W>
__device__ __forceinline__ uint32_t range_match(const uint32_t* __restrict__ tiles,
                                                long long nblocks, long long b, bool active,
                                                uint32_t lo, uint32_t span) {
  uint32_t w[W];
  load_block<W>(tiles, nblocks, b, active, w);
  uint32_t acc = 0u;
#pragma unroll
  for (int r = 0; r < kBlockValues; ++r) acc |= (uint32_t)(unpack_value<W>(w, r) - lo < span) << r;
  return acc;
}

__device__ uint32_t column_match(int width, const uint32_t* __restrict__ tiles, long long ld,
                                 long long b, bool active, uint32_t lo, uint32_t span) {
  switch (width) {
#define SSS_CASE(W) \
  case W:           \
    return range_match<W>(tiles, ld, b, active, lo, span);
    SSS_FOR_EACH_WIDTH(SSS_CASE)
#undef SSS_CASE
  }
  return 0u;  // not reached: the entry point checks every width
}

__global__ void __launch_bounds__(kThreads)
conj_range_kernel(const ConjColumns cols, uint32_t* __restrict__ bits,
                  unsigned long long* __restrict__ counts, long long nblocks, long long ld,
                  long long n, long long block_offset) {
  __shared__ unsigned s_cnt[1];
  zero_counts(s_cnt, 1);
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = b < nblocks;
  uint32_t acc = active ? valid_word(block_offset + b, n) : 0u;
  for (int c = 0; c < cols.m; ++c)
    acc &= column_match(cols.width[c], cols.tiles[c], ld, b, active, cols.lo[c], cols.span[c]);
  store_row(bits, ld, b, active, 0, acc, s_cnt);
  flush_counts(s_cnt, 1, counts);
}

}  // namespace sss

// tile_ptrs, widths, lows and highs are host arrays of m entries, copied
// into the kernel's by-value argument.  Scans blocks 0..nblocks-1 of rows of
// `ld` words (ld >= nblocks; ld = nblocks for whole columns).
extern "C" int sss_conj_range_scan(const long long* tile_ptrs, const int* widths,
                                   const uint32_t* lows, const uint32_t* highs, int m,
                                   uint32_t* bits, unsigned long long* counts, long long nblocks,
                                   long long ld, long long n, long long block_offset,
                                   cudaStream_t stream) {
  if (m < 1 || m > sss::kMaxColumns || ld < nblocks) return (int)cudaErrorInvalidValue;
  sss::ConjColumns cols = {};
  cols.m = m;
  for (int c = 0; c < m; ++c) {
    if (widths[c] < 1 || widths[c] > 31) return (int)cudaErrorInvalidValue;
    cols.tiles[c] = reinterpret_cast<const uint32_t*>(tile_ptrs[c]);
    cols.width[c] = widths[c];
    cols.lo[c] = lows[c];
    cols.span[c] = highs[c] > lows[c] ? highs[c] - lows[c] : 0u;
  }
  if (nblocks <= 0) return (int)cudaSuccess;
  sss::conj_range_kernel<<<sss::grid_for(nblocks), sss::kThreads, 0, stream>>>(
      cols, bits, counts, nblocks, ld, n, block_offset);
  return (int)cudaGetLastError();
}

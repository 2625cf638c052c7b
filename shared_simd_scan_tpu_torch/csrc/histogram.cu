// Value histograms over a packed column, no bitvector: the counts of keys
// lo..lo+k-1 (1 <= k <= 4096), in two forms of one kernel, and the
// full-domain histogram of a column of width 13-20 in one pass.
//
// The runtime-lo form (sss_histogram) replaces shared_simd_scan_tpu/ops/
// scan.py _histogram_kernel / _histogram_tiles_impl (histogram_tiles), with
// its contract: lo is read from device memory; count j is the number of
// real values v (index < n) with (v - lo) mod 2^32 == j, so a window near
// 2^32 wraps onto the small values, as the reference's uint32 lo + 32c
// does.  The reference builds one-hot masks and transposes them into
// per-key words because Mosaic has no scatter (~500 integer ops per 32
// values per 32 keys); here each value adds one to its bin.
//
// The span form (sss_histogram_span) replaces _histogram_span_kernel /
// _histogram_span_tiles_impl, the concrete-lo tier of histogram_dag_tiles
// for 48 < k <= 512: lo is a host value; count j is the number of real
// values equal to lo + j, and a key past 2^W or past 2^32 - 1 counts 0 --
// no wrap: the entry point clips k to 2^32 - lo, and then (v - lo) mod
// 2^32 < k holds only for lo <= v < lo + k.  The reference interprets the
// span's memoized AND-DAG over the bit planes, a TPU workaround for the
// missing scatter; on this card a scatter into shared memory is cheap, so
// both forms share one body, lo by pointer or by value.
//
// The domain form (sss_histogram_domain) replaces the reference's
// stats.histogram_full loop over _histogram_tiles_impl, one launch per
// 4096-value window (256 at width 20, each reading the whole column): one
// launch adds every real value to its int64 counter in device memory
// (8 * 2^W bytes, 8 MB at width 20, which the 50 MB L2 holds).  Bound on
// the H100: the L2's rate of reductions, one a value (87.6 G/s measured,
// 5.5 ms at width 20 against 0.36 ms of bytes); where many values are
// equal, one address's queue: there a warp counts its hot value in
// registers and merges the lanes of one value into one reduction
// (domain_block).  Integer sums do not depend on order: exact.
//
// Bound on the H100: device memory bytes (W words per 32 values), and the
// integer issue around one shared atomic per value, which came close to
// it (0.353 ms against 0.161 ms of bytes at W = 9).  Design: CTAs as many
// as are resident on the card, each looping over tiles of 256 blocks (one
// thread per block) with its k bins in shared memory (16 KB at k = 4096).
// Each value in the window adds one to its bin with a shared-memory atomic;
// what surrounds the atomic is cut to what a tile needs, by CTA-uniform
// branches: only a tile that holds padding or the last real block tests
// the validity word; a window over the whole domain (lo == 0, k >= 2^W)
// skips the subtract and the compare, and takes the bin's byte offset
// straight from the packed words (a shift or funnel shift and a mask):
// at W = 9 its counting block is 5.1 SASS instructions a value, where the
// kernel's loop before took 18.3, loads included (bench/redesign_sweep.py).
// A value outside another window adds one to a spare counter, so no value
// branches.
// Bin d lives at slot d ^ ((d >> 5) & 31), which spreads bins 32 apart
// (value slot r of 32 neighbouring blocks of an i % 2^w column) over
// distinct banks.  Grouping a warp's lanes by bin first (__match_any_sync,
// one atomic per group), a ballot-guarded uniform path and per-warp bins
// were measured against this form on the card and lost on every column,
// sorted ones included (shared_simd_scan_tpu_torch/bench/bin_variants.py).
// Flush: one int64 atomic per non-zero bin per CTA; a CTA's unsigned
// counters cannot wrap, since a launch gives each CTA fewer than 2^32
// values (histogram_grid).
#include "common.cuh"

namespace sss {

__device__ __forceinline__ uint32_t bin_slot(uint32_t d) { return d ^ ((d >> 5) & 31u); }

// Value r (0..31) of the block shifted left by kShift bits (kShift + W <=
// 32), its other bits zero: one shift, or one funnel shift where the value
// straddles two words, then a mask.
template <int W, int kShift>
__device__ __forceinline__ uint32_t value_at(const uint32_t (&w)[W], int r) {
  static_assert(kShift + W <= 32, "the shifted value must fit a word");
  const int j = slot_word<W>(r), s = slot_shift<W>(r);
  uint32_t x;
  // (a straddling value has s > 32 - W >= kShift; the index guard only
  // keeps non-straddling slots' dead code in bounds)
  if (slot_straddles<W>(r)) x = __funnelshift_r(w[j], w[j + 1 < W ? j + 1 : j], s - kShift);
  else if (s >= kShift) x = w[j] >> (s - kShift);
  else x = w[j] << (kShift - s);
  return x & (value_mask<W>() << kShift);
}

// Count the 32 values of one block into the CTA's bins.  kWhole: the window
// is the whole domain, so every value counts at bin v, and its byte offset
// 4 * bin_slot(v) comes from 4v.  kMasked: only the bits of `valid` hold
// real values.  A value outside the window or past n adds one to the
// spare counter s_bin[spare], read by no one: every value takes the same
// unconditional atomic (lanes on the spare counter merge in it), where a
// branch around the atomic (kSpare false) took 22% longer on the card.
// kSwizzle: bin d at slot bin_slot(d), else at slot d.  (kSwizzle and
// kSpare false are ablations for bench/redesign_sweep.py.)
template <int W, bool kWhole, bool kMasked, bool kSwizzle = true, bool kSpare = true>
__device__ __forceinline__ void count_block(const uint32_t (&w)[W], uint32_t valid, uint32_t lo,
                                            uint32_t k, unsigned* s_bin, uint32_t spare) {
  char* bins = reinterpret_cast<char*>(s_bin);
#pragma unroll
  for (int r = 0; r < kBlockValues; ++r) {
    if constexpr (kWhole) {
      const uint32_t v4 = value_at<W, 2>(w, r);
      atomicAdd(reinterpret_cast<unsigned*>(bins + (kSwizzle ? v4 ^ ((v4 >> 5) & 0x7Cu) : v4)),
                1u);
    } else {
      const uint32_t d = value_at<W, 0>(w, r) - lo;
      const bool in = d < k && (!kMasked || ((valid >> r) & 1u));
      const uint32_t slot = kSwizzle ? bin_slot(d) : d;
      if constexpr (kSpare) atomicAdd(s_bin + (in ? slot : spare), 1u);
      else if (in) atomicAdd(s_bin + slot, 1u);
    }
  }
}

// Whether every block of the tile [first, first + blockDim.x) lies in the
// tiles and holds 32 real values (CTA-uniform).
__device__ __forceinline__ bool full_tile(long long first, long long nblocks, long long n,
                                          long long block_offset) {
  const long long end = first + blockDim.x;
  return end <= nblocks && block_offset + end <= (n >> 5);
}

// lo is read at lo_ptr, or is lo_value where lo_ptr is null; once per CTA.
template <int W, bool kSwizzle = true, bool kSpare = true>
__global__ void __launch_bounds__(kThreads)
histogram_kernel(const uint32_t* __restrict__ tiles, const uint32_t* __restrict__ lo_ptr,
                 uint32_t lo_value, int k, unsigned long long* __restrict__ counts,
                 long long nblocks, long long n, long long block_offset) {
  __shared__ unsigned s_bin[kMaxHistKeys + 1];  // and the spare counter
  const int slots = (k + 31) & ~31;  // bin_slot(d) < slots for every d < k
  zero_counts(s_bin, slots);
  const uint32_t lo = lo_ptr ? __ldg(lo_ptr) : lo_value;
  // (k <= 4096: only W <= 12 has a whole-domain window)
  const bool whole = W <= 12 && lo == 0u && (uint32_t)k >= (1u << W);
  const long long ntiles = (nblocks + blockDim.x - 1) / blockDim.x;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long first = t * blockDim.x;
    const long long b = first + threadIdx.x;
    const bool active = b < nblocks;
    uint32_t w[W];
    load_block<W>(tiles, nblocks, b, active, w);
    if (full_tile(first, nblocks, n, block_offset)) {
      if constexpr (W <= 12) {
        if (whole) {
          count_block<W, true, false, kSwizzle>(w, 0u, 0u, (uint32_t)k, s_bin, 0u);
          continue;
        }
      }
      count_block<W, false, false, kSwizzle, kSpare>(w, 0u, lo, (uint32_t)k, s_bin,
                                                    kMaxHistKeys);
    } else {
      const uint32_t valid = active ? valid_word(block_offset + b, n) : 0u;
      count_block<W, false, true, kSwizzle, kSpare>(w, valid, lo, (uint32_t)k, s_bin,
                                                   kMaxHistKeys);
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < slots; p += blockDim.x) {
    const unsigned c = s_bin[p];
    const uint32_t bin = kSwizzle ? bin_slot((uint32_t)p) : (uint32_t)p;  // its own inverse
    if (c) atomicAdd(counts + bin, (unsigned long long)c);
  }
}

// The domain form: each real value adds one to counts[v] in device memory.
// One reduction per value queues at one L2 slice where many values are
// equal (a skewed column ran 3x slower than 256 windows of the bins
// kernel), so with kMerge each warp (a) counts in registers the values
// equal to its hot value, lane 0's first value, flushed once at the end,
// and (b) merges the lanes of one value (__match_any_sync) into one
// reduction by the lowest of them.  Count: unsigned long long; unsigned
// (wraps at 2^32) and kMerge false only as ablations for
// bench/redesign_sweep.py.
template <int W, bool kMasked, bool kMerge, typename Count>
__device__ __forceinline__ void domain_block(const uint32_t (&w)[W], uint32_t valid, uint32_t hot,
                                             unsigned& hot_count, Count* __restrict__ counts) {
  const unsigned lane = threadIdx.x & 31u;
#pragma unroll
  for (int r = 0; r < kBlockValues; ++r) {
    const uint32_t v = value_at<W, 0>(w, r);
    const bool real = !kMasked || ((valid >> r) & 1u);
    if constexpr (kMerge) {
      hot_count += real && v == hot;
      const uint32_t key = real && v != hot ? v : 0xFFFFFFFFu;  // no value of W <= 20 bits
      const unsigned peers = __match_any_sync(0xFFFFFFFFu, key);
      if (key != 0xFFFFFFFFu && lane == (unsigned)(__ffs(peers) - 1))
        atomicAdd(counts + key, Count(__popc(peers)));
    } else if (real) {
      atomicAdd(counts + v, Count(1));
    }
  }
}

template <int W, typename Count = unsigned long long, bool kMerge = true>
__global__ void __launch_bounds__(kThreads)
histogram_domain_kernel(const uint32_t* __restrict__ tiles, Count* __restrict__ counts,
                        long long nblocks, long long n, long long block_offset) {
  const long long ntiles = (nblocks + blockDim.x - 1) / blockDim.x;
  uint32_t hot = 0xFFFFFFFFu;
  unsigned hot_count = 0;  // fewer than 2^32: a launch gives a CTA fewer values
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {  // CTA-uniform trip count
    const long long first = t * blockDim.x;
    const long long b = first + threadIdx.x;
    const bool active = b < nblocks;
    uint32_t w[W];
    load_block<W>(tiles, nblocks, b, active, w);
    if (kMerge && hot == 0xFFFFFFFFu) hot = __shfl_sync(0xFFFFFFFFu, value_at<W, 0>(w, 0), 0);
    // (CTA-uniform, so each path is taken by whole warps)
    if (full_tile(first, nblocks, n, block_offset)) {
      domain_block<W, false, kMerge>(w, 0xFFFFFFFFu, hot, hot_count, counts);
    } else {
      const uint32_t valid = active ? valid_word(block_offset + b, n) : 0u;
      domain_block<W, true, kMerge>(w, valid, hot, hot_count, counts);
    }
  }
  if constexpr (kMerge) {
    const unsigned c = __reduce_add_sync(0xFFFFFFFFu, hot_count);
    if ((threadIdx.x & 31u) == 0 && c) atomicAdd(counts + hot, Count(c));
  }
}

// Resident CTAs looping over the tiles, and at least as many CTAs as keep
// each CTA's values below 2^32 (its unsigned counters).
template <typename Kernel>
cudaError_t histogram_grid(Kernel kernel, long long nblocks, unsigned* grid) {
  const long long ntiles = (nblocks + kThreads - 1) / kThreads;
  const cudaError_t err = resident_grid(kernel, kThreads, 0, ntiles, grid);
  const long long tiles_per_cta = (1LL << 32) / ((long long)kThreads * kBlockValues) - 1;
  const long long least = (ntiles + tiles_per_cta - 1) / tiles_per_cta;
  if (*grid < least) *grid = (unsigned)least;
  return err;
}

template <int W>
cudaError_t launch_histogram(const uint32_t* tiles, const uint32_t* lo_ptr, uint32_t lo_value,
                             int k, unsigned long long* counts, long long nblocks, long long n,
                             long long block_offset, cudaStream_t stream) {
  unsigned grid = 0;
  const cudaError_t err = histogram_grid(histogram_kernel<W>, nblocks, &grid);
  if (err != cudaSuccess) return err;
  histogram_kernel<W><<<grid, kThreads, 0, stream>>>(tiles, lo_ptr, lo_value, k, counts, nblocks,
                                                     n, block_offset);
  return cudaGetLastError();
}

int histogram_entry(const uint32_t* tiles, const uint32_t* lo_ptr, uint32_t lo_value, int k,
                    unsigned long long* counts, long long nblocks, int width, long long n,
                    long long block_offset, cudaStream_t stream) {
  if (k < 1 || k > kMaxHistKeys) return (int)cudaErrorInvalidValue;
  if (nblocks <= 0) return (int)cudaSuccess;
  switch (width) {
#define SSS_CASE(W)                                                                            \
  case W:                                                                                      \
    return (int)launch_histogram<W>(tiles, lo_ptr, lo_value, k, counts, nblocks, n,            \
                                    block_offset, stream);
    SSS_FOR_EACH_WIDTH(SSS_CASE)
#undef SSS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int W>
cudaError_t launch_histogram_domain(const uint32_t* tiles, unsigned long long* counts,
                                    long long nblocks, long long n, long long block_offset,
                                    cudaStream_t stream) {
  unsigned grid = 0;
  const cudaError_t err = histogram_grid(histogram_domain_kernel<W>, nblocks, &grid);
  if (err != cudaSuccess) return err;
  histogram_domain_kernel<W><<<grid, kThreads, 0, stream>>>(tiles, counts, nblocks, n,
                                                            block_offset);
  return cudaGetLastError();
}

}  // namespace sss

// lo: one uint32 in device memory; counts: int64[k], zeroed by the caller.
extern "C" int sss_histogram(const uint32_t* tiles, const uint32_t* lo, int k,
                             unsigned long long* counts, long long nblocks, int width, long long n,
                             long long block_offset, cudaStream_t stream) {
  return sss::histogram_entry(tiles, lo, 0u, k, counts, nblocks, width, n, block_offset, stream);
}

// lo: a host value; counts: int64[k], zeroed by the caller.  Keys past
// 2^32 - 1 count 0: k is clipped to 2^32 - lo, so nothing wraps.
extern "C" int sss_histogram_span(const uint32_t* tiles, uint32_t lo, int k,
                                  unsigned long long* counts, long long nblocks, int width,
                                  long long n, long long block_offset, cudaStream_t stream) {
  if (k < 1 || k > sss::kMaxHistKeys) return (int)cudaErrorInvalidValue;
  const long long room = (1LL << 32) - lo;
  return sss::histogram_entry(tiles, nullptr, lo, k > room ? (int)room : k, counts, nblocks,
                              width, n, block_offset, stream);
}

// The full-domain histogram of a column of width 13..20: counts int64[2^width],
// zeroed by the caller.
extern "C" int sss_histogram_domain(const uint32_t* tiles, unsigned long long* counts,
                                    long long nblocks, int width, long long n,
                                    long long block_offset, cudaStream_t stream) {
  if (nblocks <= 0) return (int)cudaSuccess;
  switch (width) {
#define SSS_CASE(W)                                                                          \
  case W:                                                                                    \
    return (int)sss::launch_histogram_domain<W>(tiles, counts, nblocks, n, block_offset,     \
                                                stream);
    SSS_CASE(13) SSS_CASE(14) SSS_CASE(15) SSS_CASE(16) SSS_CASE(17) SSS_CASE(18) SSS_CASE(19)
    SSS_CASE(20)
#undef SSS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The host-lo histogram's, the static bit-plane aggregate's and keyed
// MIN/MAX's designs side by side, for bench/redesign_sweep.py (sections
// histdag, aggstatic and minmax) to time on the card.  Not part of the
// kernel library: it includes the library's histogram.cu, bitsliced.cu
// and agg_lookup.cu for their templates (the bins kernel with one spare
// counter or one a lane; the static fold's counts-only form; the key
// lookup aggregates in each of their update forms and lookups) and adds
// keyed MIN/MAX as it was before the redesign (aggregate.cu's
// sss_agg_compare, MIN/MAX form): per key a match word of 32 compares,
// two selects a value, two warp reduces and two shared atomics.
#include "../csrc/histogram.cu"
#include "../csrc/bitsliced.cu"
#include "../csrc/agg_lookup.cu"

namespace sss {

// The bins body with lo by value, one spare counter or one a lane.
template <int W, bool kLaneSpare>
cudaError_t launch_bins_span(const uint32_t* tiles, uint32_t lo, int k, unsigned long long* counts,
                             long long nblocks, long long n, cudaStream_t stream) {
  const auto kernel = histogram_kernel<W, true, true, kLaneSpare>;
  unsigned grid = 0;
  const cudaError_t err = histogram_grid(kernel, nblocks, &grid);
  if (err != cudaSuccess) return err;
  const long long room = (1LL << 32) - lo;
  kernel<<<grid, kThreads, 0, stream>>>(tiles, nullptr, lo, k > room ? (int)room : k, counts,
                                        nblocks, n, 0);
  return cudaGetLastError();
}

// --- keyed MIN/MAX before the redesign ------------------------------------

__global__ void __launch_bounds__(kThreads)
minmax_compare_kernel(const uint32_t* __restrict__ ptiles, const uint32_t* __restrict__ mtiles,
                      const uint32_t* __restrict__ keys, int k, int wp, int wm,
                      unsigned long long* __restrict__ counts, long long* __restrict__ mins,
                      long long* __restrict__ maxs, long long nblocks, long long n) {
  __shared__ unsigned s_cnt[kMaxAggKeys];
  __shared__ int s_mn[kMaxAggKeys], s_mx[kMaxAggKeys];
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    s_cnt[j] = 0u;
    s_mn[j] = kMinIdentity;
    s_mx[j] = kMaxIdentity;
  }
  __syncthreads();
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = b < nblocks;
  const uint32_t valid = active ? valid_word(b, n) : 0u;
  uint32_t vp[kBlockValues], vm[kBlockValues];
  unpack_block_any(wp, ptiles, nblocks, b, active, vp);
  unpack_block_any(wm, mtiles, nblocks, b, active, vm);
#pragma unroll 1
  for (int j = 0; j < k; ++j) {
    const uint32_t key = __ldg(keys + j);
    uint32_t mw = 0u;
#pragma unroll
    for (int r = 0; r < kBlockValues; ++r) mw |= (uint32_t)(vp[r] == key) << r;
    mw &= valid;
    count_row(j, mw, s_cnt);
    int mn = kMinIdentity, mx = kMaxIdentity;
#pragma unroll
    for (int r = 0; r < kBlockValues; ++r) {
      const bool hit = (mw >> r) & 1u;
      mn = min(mn, hit ? (int)vm[r] : kMinIdentity);
      mx = max(mx, hit ? (int)vm[r] : kMaxIdentity);
    }
    mn = __reduce_min_sync(0xFFFFFFFFu, mn);
    mx = __reduce_max_sync(0xFFFFFFFFu, mx);
    if ((threadIdx.x & 31) == 0) {
      atomicMin(s_mn + j, mn);
      atomicMax(s_mx + j, mx);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    if (!s_cnt[j]) continue;
    atomicAdd(counts + j, (unsigned long long)s_cnt[j]);
    atomicMin(mins + j, (long long)s_mn[j]);
    atomicMax(maxs + j, (long long)s_mx[j]);
  }
}

}  // namespace sss

// Candidates for the counts of keys lo..lo+k-1 (counts int64[k] zeroed by
// the caller) at widths 1-6, 8, 9 and 12: 1 the bins body with one spare
// counter, 2 with a spare counter a lane, 3 the static fold's counts form
// at 256 and 4 at 128 threads a CTA (k <= 1024).
extern "C" int sweep_hist(int variant, int width, const uint32_t* tiles, uint32_t lo, int k,
                          unsigned long long* counts, long long nblocks, long long n,
                          cudaStream_t stream) {
  if (k < 1 || k > sss::kMaxHistKeys || nblocks <= 0) return (int)cudaErrorInvalidValue;
  if (variant >= 3 && k > sss::kMaxKeys) return (int)cudaErrorInvalidValue;
  const sss::SpanKeys keys{lo};
#define SSS_HIST(W)                                                                             \
  if (width == W) {                                                                             \
    if (variant == 1)                                                                           \
      return (int)sss::launch_bins_span<W, false>(tiles, lo, k, counts, nblocks, n, stream);    \
    if (variant == 2)                                                                           \
      return (int)sss::launch_bins_span<W, true>(tiles, lo, k, counts, nblocks, n, stream);     \
    if (variant == 3 || variant == 4)                                                           \
      return (int)sss::launch_static_fold<W, sss::SpanKeys, sss::kFoldCounts>(                  \
          tiles, keys, k, sss::static_rows_chunk(W, k), nullptr, counts, nblocks, n, 0,         \
          variant == 3 ? 256 : 128, stream);                                                    \
  }
  SSS_HIST(1)
  SSS_HIST(2)
  SSS_HIST(3)
  SSS_HIST(4)
  SSS_HIST(5)
  SSS_HIST(6)
  SSS_HIST(8)
  SSS_HIST(9)
  SSS_HIST(12)
#undef SSS_HIST
  return (int)cudaErrorInvalidValue;
}

// Variants of the static bit-plane aggregate (keys a host array of k
// uint32; counts and sums int64[k] zeroed by the caller): 1 the library's
// entry, 2 kWide, 3 kCarry with counters per warp, 4 kMerge, 5 kHot, 6
// kCarry, 7 kBatch, 8 kBatchHot, 9 kCarry and 10 the library's form
// (kAdaptive) with the search past kLookupTableBits; each with
// agg_lookup_plan's lookup unless named.
extern "C" int sweep_agg(int variant, const uint32_t* ptiles, const uint32_t* mtiles,
                         const uint32_t* keys, int k, unsigned long long* counts,
                         unsigned long long* sums, long long nblocks, int wp, int wm, long long n,
                         cudaStream_t stream) {
  if (!sss::agg_lookup_args_ok(k, wp, wm) || nblocks <= 0) return (int)cudaErrorInvalidValue;
  sss::AggKeys hk{};
  for (int j = 0; j < k; ++j) hk.key[j] = keys[j];
  int shift = 0;
  const int lookup = sss::agg_lookup_plan(hk, k, wp, &shift);
  switch (variant) {
    case 1:
      return sss_agg_lookup(ptiles, mtiles, keys, k, reinterpret_cast<long long*>(counts),
                            reinterpret_cast<long long*>(sums), nblocks, wp, wm, n, 0, stream);
    case 2:
      return (int)sss::launch_agg_lookup<sss::kWide>(ptiles, mtiles, hk, k, wp, wm, lookup, shift,
                                                     counts, sums, nblocks, n, 0, stream);
    case 3:
      return (int)sss::launch_agg_lookup<sss::kCarry, true>(ptiles, mtiles, hk, k, wp, wm, lookup,
                                                            shift, counts, sums, nblocks, n, 0,
                                                            stream);
    case 4:
      return (int)sss::launch_agg_lookup<sss::kMerge>(ptiles, mtiles, hk, k, wp, wm, lookup,
                                                      shift, counts, sums, nblocks, n, 0, stream);
    case 5:
      return (int)sss::launch_agg_lookup<sss::kHot>(ptiles, mtiles, hk, k, wp, wm, lookup, shift,
                                                    counts, sums, nblocks, n, 0, stream);
    case 6:
      return (int)sss::launch_agg_lookup<sss::kCarry>(ptiles, mtiles, hk, k, wp, wm, lookup,
                                                      shift, counts, sums, nblocks, n, 0, stream);
    case 7:
      return (int)sss::launch_agg_lookup<sss::kBatch>(ptiles, mtiles, hk, k, wp, wm, lookup,
                                                      shift, counts, sums, nblocks, n, 0, stream);
    case 8:
      return (int)sss::launch_agg_lookup<sss::kBatchHot>(ptiles, mtiles, hk, k, wp, wm, lookup,
                                                         shift, counts, sums, nblocks, n, 0,
                                                         stream);
    case 9:
    case 10: {
      const int forced = wp > sss::kLookupTableBits ? sss::kSearch : lookup;
      return variant == 9
                 ? (int)sss::launch_agg_lookup<sss::kCarry>(ptiles, mtiles, hk, k, wp, wm, forced,
                                                            shift, counts, sums, nblocks, n, 0,
                                                            stream)
                 : (int)sss::launch_agg_lookup(ptiles, mtiles, hk, k, wp, wm, forced, shift,
                                               counts, sums, nblocks, n, 0, stream);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Variants of keyed MIN/MAX (keys k uint32 in device memory; counts, mins
// and maxs int64[k] set by the caller to 0, 0x7FFFFFFF and -1): 0 the
// compare kernel before the redesign, 1 the library's entry, the lookup
// with 2 kMmAtomic, 3 kMmLoad, 4 kMmAtomicHot, 5 kMmLoadHot and 8
// kMmAtomicVote (the library's lookup), and the library's form with 6 the
// search at every width and 7 kCtaPlan past kLookupTableBits (its window
// where one separates the keys).
extern "C" int sweep_minmax(int variant, const uint32_t* ptiles, const uint32_t* mtiles,
                            const uint32_t* keys, int k, long long* counts, long long* mins,
                            long long* maxs, long long nblocks, int wp, int wm, long long n,
                            cudaStream_t stream) {
  if (!sss::agg_lookup_args_ok(k, wp, wm) || nblocks <= 0) return (int)cudaErrorInvalidValue;
  auto* c = reinterpret_cast<unsigned long long*>(counts);
  const int lookup = wp <= sss::kLookupTableBits ? sss::kByteTable : sss::kMinMaxWideLookup;
  switch (variant) {
    case 0:
      sss::minmax_compare_kernel<<<sss::grid_for(nblocks), sss::kThreads, 0, stream>>>(
          ptiles, mtiles, keys, k, wp, wm, c, mins, maxs, nblocks, n);
      return (int)cudaGetLastError();
    case 1:
      return sss_minmax_lookup(ptiles, mtiles, keys, k, counts, mins, maxs, nblocks, wp, wm, n, 0,
                               stream);
    case 2:
      return (int)sss::launch_minmax_lookup<sss::kMmAtomic>(ptiles, mtiles, keys, k, wp, wm,
                                                            lookup, c, mins, maxs, nblocks, n, 0,
                                                            stream);
    case 3:
      return (int)sss::launch_minmax_lookup<sss::kMmLoad>(ptiles, mtiles, keys, k, wp, wm, lookup,
                                                          c, mins, maxs, nblocks, n, 0, stream);
    case 4:
      return (int)sss::launch_minmax_lookup<sss::kMmAtomicHot>(ptiles, mtiles, keys, k, wp, wm,
                                                               lookup, c, mins, maxs, nblocks, n,
                                                               0, stream);
    case 5:
      return (int)sss::launch_minmax_lookup<sss::kMmLoadHot>(ptiles, mtiles, keys, k, wp, wm,
                                                             lookup, c, mins, maxs, nblocks, n, 0,
                                                             stream);
    case 8:
      return (int)sss::launch_minmax_lookup<sss::kMmAtomicVote>(ptiles, mtiles, keys, k, wp, wm,
                                                                lookup, c, mins, maxs, nblocks, n,
                                                                0, stream);
    case 6:
      return (int)sss::launch_minmax_lookup(ptiles, mtiles, keys, k, wp, wm, sss::kSearch, c,
                                            mins, maxs, nblocks, n, 0, stream);
    case 7:
      if (wp <= sss::kLookupTableBits) return (int)cudaErrorInvalidValue;
      return (int)sss::launch_minmax_lookup(ptiles, mtiles, keys, k, wp, wm, sss::kCtaPlan, c,
                                            mins, maxs, nblocks, n, 0, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

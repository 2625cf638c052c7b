// Keyed aggregates by select-accumulate (SUM and COUNT, or MIN, MAX and
// COUNT), and the masked aggregate over a bitvector row.
//
// Replaces shared_simd_scan_tpu/ops/aggregate.py:
//  - _agg_kernel / aggregate_scan_tiles: per key, the COUNT and the exact
//    SUM of the measure column over the rows whose predicate equals the key;
//  - _minmax_kernel / minmax_scan_tiles: per key, the COUNT, MIN and MAX;
//  - _masked_agg_kernel / masked_aggregate_tiles: the COUNT and SUM of the
//    measure over the set bits of a device-layout bitvector row (one word
//    per block).  It trusts the tail invariant, as the reference does: bits
//    of values at index >= n are zero.
// Kept: k <= 32 keys; a key >= 2^wp matches nothing; an empty group has min
// 2^wm and max 0 (the wrapper applies it on the device).  Changed: the
// reference rewrites the predicate of padding slots to the sentinel
// 0xFFFFFFFF, which the key 0xFFFFFFFF then matches.  Here each match word
// is ANDed with the block's validity word, so padding matches no key.
//
// Bound on the H100: device memory bytes (wp + wm words read per 32 values)
// for small k; the integer instruction rate beyond (~7 ops per value per key).  Design:
// one thread per 32-value block.  The two columns have their own widths,
// and templating on both would build 31 x 31 bodies, so each column is
// unpacked into 32 registers by unpack_block_any (a switch on its width,
// uniform across the grid).  Per key (the loop is not unrolled): a match
// word of 32 compares ANDed with the validity word, its popcount, and the
// selected measure values summed per thread in 64 bits (< 2^36; exact
// per-CTA sums as add_split_sum in common.cuh says) or folded into MIN and
// MAX.  Measure values are < 2^31, so int32 min/max with the identities
// 0x7FFFFFFF and -1 is exact: __reduce_min/max_sync per warp, a shared
// atomicMin/Max per warp, one int64 atomicMin/Max per key per CTA.
#include "common.cuh"

namespace sss {

constexpr int kMinIdentity = 0x7FFFFFFF;
constexpr int kMaxIdentity = -1;

// kMinMax: counts, mins and maxs; else counts and sums.
template <bool kMinMax>
__global__ void __launch_bounds__(kThreads)
agg_compare_kernel(const uint32_t* __restrict__ ptiles, const uint32_t* __restrict__ mtiles,
                   const uint32_t* __restrict__ keys, int k, int wp, int wm,
                   unsigned long long* __restrict__ counts, long long* __restrict__ out_a,
                   long long* __restrict__ out_b, long long nblocks, long long n,
                   long long block_offset) {
  __shared__ unsigned s_cnt[kMaxAggKeys];
  __shared__ unsigned s_a[kMaxAggKeys];  // sum lo parts, or the min (int bits)
  __shared__ unsigned s_b[kMaxAggKeys];  // sum hi parts, or the max (int bits)
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    s_cnt[j] = 0u;
    s_a[j] = kMinMax ? (unsigned)kMinIdentity : 0u;
    s_b[j] = kMinMax ? (unsigned)kMaxIdentity : 0u;
  }
  __syncthreads();
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = b < nblocks;
  const uint32_t valid = active ? valid_word(block_offset + b, n) : 0u;
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
    if constexpr (kMinMax) {
      int mn = kMinIdentity, mx = kMaxIdentity;
#pragma unroll
      for (int r = 0; r < kBlockValues; ++r) {
        const bool hit = (mw >> r) & 1u;
        mn = min(mn, hit ? (int)vm[r] : kMinIdentity);
        mx = max(mx, hit ? (int)vm[r] : kMaxIdentity);
      }
      mn = __reduce_min_sync(0xFFFFFFFFu, mn);
      mx = __reduce_max_sync(0xFFFFFFFFu, mx);
      // (no test on mn: a wm = 31 value can equal the identity)
      if ((threadIdx.x & 31) == 0) {
        atomicMin(reinterpret_cast<int*>(s_a) + j, mn);
        atomicMax(reinterpret_cast<int*>(s_b) + j, mx);
      }
    } else {
      unsigned long long s = 0ull;
#pragma unroll
      for (int r = 0; r < kBlockValues; ++r) s += ((mw >> r) & 1u) ? vm[r] : 0u;
      add_split_sum(s_a, s_b, j, (unsigned)(s & 0xFFFFu), (unsigned)(s >> 16));
    }
  }

  if constexpr (kMinMax) {
    __syncthreads();
    for (int j = threadIdx.x; j < k; j += blockDim.x) {
      if (!s_cnt[j]) continue;
      atomicAdd(counts + j, (unsigned long long)s_cnt[j]);
      atomicMin(out_a + j, (long long)(int)s_a[j]);
      atomicMax(out_b + j, (long long)(int)s_b[j]);
    }
  } else {
    flush_sums(s_cnt, s_a, s_b, k, counts, reinterpret_cast<unsigned long long*>(out_a));
  }
}

__global__ void __launch_bounds__(kThreads)
masked_agg_kernel(const uint32_t* __restrict__ mtiles, const uint32_t* __restrict__ bits, int wm,
                  unsigned long long* __restrict__ count, unsigned long long* __restrict__ sum,
                  long long nblocks) {
  __shared__ unsigned s_cnt[1], s_lo[1], s_hi[1];
  zero_sums(s_cnt, s_lo, s_hi, 1);
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = b < nblocks;
  const uint32_t bw = active ? __ldg(bits + b) : 0u;
  uint32_t vm[kBlockValues];
  unpack_block_any(wm, mtiles, nblocks, b, active, vm);
  count_row(0, bw, s_cnt);
  unsigned long long s = 0ull;
#pragma unroll
  for (int r = 0; r < kBlockValues; ++r) s += ((bw >> r) & 1u) ? vm[r] : 0u;
  add_split_sum(s_lo, s_hi, 0, (unsigned)(s & 0xFFFFu), (unsigned)(s >> 16));
  flush_sums(s_cnt, s_lo, s_hi, 1, count, sum);
}

}  // namespace sss

// counts, a and b are int64[k]: zeros for SUM (a = sums, b unused); for
// MIN/MAX (minmax != 0) zeros, 0x7FFFFFFF and -1 (a = mins, b = maxs).
extern "C" int sss_agg_compare(const uint32_t* ptiles, const uint32_t* mtiles, const uint32_t* keys,
                               int k, long long* counts, long long* a, long long* b,
                               long long nblocks, int wp, int wm, long long n,
                               long long block_offset, int minmax, cudaStream_t stream) {
  if (k < 1 || k > sss::kMaxAggKeys || !sss::width_ok(wp) || !sss::width_ok(wm))
    return (int)cudaErrorInvalidValue;
  if (nblocks <= 0) return (int)cudaSuccess;
  auto* c = reinterpret_cast<unsigned long long*>(counts);
  if (minmax)
    sss::agg_compare_kernel<true><<<sss::grid_for(nblocks), sss::kThreads, 0, stream>>>(
        ptiles, mtiles, keys, k, wp, wm, c, a, b, nblocks, n, block_offset);
  else
    sss::agg_compare_kernel<false><<<sss::grid_for(nblocks), sss::kThreads, 0, stream>>>(
        ptiles, mtiles, keys, k, wp, wm, c, a, b, nblocks, n, block_offset);
  return (int)cudaGetLastError();
}

// count and sum are int64[1], zeroed by the caller.
extern "C" int sss_masked_agg(const uint32_t* mtiles, const uint32_t* bits, long long* count,
                              long long* sum, long long nblocks, int wm, cudaStream_t stream) {
  if (!sss::width_ok(wm)) return (int)cudaErrorInvalidValue;
  if (nblocks <= 0) return (int)cudaSuccess;
  sss::masked_agg_kernel<<<sss::grid_for(nblocks), sss::kThreads, 0, stream>>>(
      mtiles, bits, wm, reinterpret_cast<unsigned long long*>(count),
      reinterpret_cast<unsigned long long*>(sum), nblocks);
  return (int)cudaGetLastError();
}

// Keyed SUM and COUNT by select-accumulate, and the masked aggregate over a
// bitvector row.
//
// Replaces shared_simd_scan_tpu/ops/aggregate.py:
//  - _agg_kernel / aggregate_scan_tiles: per key, the COUNT and the exact
//    SUM of the measure column over the rows whose predicate equals the key;
//  - _masked_agg_kernel / masked_aggregate_tiles: the COUNT and SUM of the
//    measure over the set bits of a device-layout bitvector row (one word
//    per block).  It trusts the tail invariant, as the reference does: bits
//    of values at index >= n are zero.
// The MIN/MAX form (_minmax_kernel) is a key lookup per value, agg_lookup.cu
// sss_minmax_lookup.  Kept: k <= 32 keys; a key >= 2^wp matches nothing.
// Changed: the reference rewrites the predicate of padding slots to the
// sentinel 0xFFFFFFFF, which the key 0xFFFFFFFF then matches.  Here each
// match word is ANDed with the block's validity word, so padding matches no
// key.
//
// Bound on the H100: device memory bytes (wp + wm words read per 32 values)
// for small k; the integer instruction rate beyond (~7 ops per value per
// key).  Design: one thread per 32-value block.  The two columns have their
// own widths, and templating on both would build 31 x 31 bodies, so each
// column is unpacked into 32 registers by unpack_block_any (a switch on its
// width, uniform across the grid).  Per key (the loop is not unrolled): a
// match word of 32 compares ANDed with the validity word, its popcount, and
// the selected measure values summed per thread in 64 bits (< 2^36; exact
// per-CTA sums as add_split_sum in common.cuh says).
#include "common.cuh"

namespace sss {

__global__ void __launch_bounds__(kThreads)
agg_compare_kernel(const uint32_t* __restrict__ ptiles, const uint32_t* __restrict__ mtiles,
                   const uint32_t* __restrict__ keys, int k, int wp, int wm,
                   unsigned long long* __restrict__ counts, unsigned long long* __restrict__ sums,
                   long long nblocks, long long n, long long block_offset) {
  __shared__ unsigned s_cnt[kMaxAggKeys], s_lo[kMaxAggKeys], s_hi[kMaxAggKeys];
  zero_sums(s_cnt, s_lo, s_hi, k);
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
    unsigned long long s = 0ull;
#pragma unroll
    for (int r = 0; r < kBlockValues; ++r) s += ((mw >> r) & 1u) ? vm[r] : 0u;
    add_split_sum(s_lo, s_hi, j, (unsigned)(s & 0xFFFFu), (unsigned)(s >> 16));
  }
  flush_sums(s_cnt, s_lo, s_hi, k, counts, sums);
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

// counts and sums int64[k], zeroed by the caller.
extern "C" int sss_agg_compare(const uint32_t* ptiles, const uint32_t* mtiles, const uint32_t* keys,
                               int k, long long* counts, long long* sums, long long nblocks,
                               int wp, int wm, long long n, long long block_offset,
                               cudaStream_t stream) {
  if (k < 1 || k > sss::kMaxAggKeys || !sss::width_ok(wp) || !sss::width_ok(wm))
    return (int)cudaErrorInvalidValue;
  if (nblocks <= 0) return (int)cudaSuccess;
  sss::agg_compare_kernel<<<sss::grid_for(nblocks), sss::kThreads, 0, stream>>>(
      ptiles, mtiles, keys, k, wp, wm, reinterpret_cast<unsigned long long*>(counts),
      reinterpret_cast<unsigned long long*>(sums), nblocks, n, block_offset);
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

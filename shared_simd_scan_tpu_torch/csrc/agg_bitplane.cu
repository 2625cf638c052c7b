// Keyed SUM and COUNT through bit planes for runtime keys: SUM_j = sum_p
// 2^p * popcount(match_j & mplane_p), match_j from the XOR plane fold.
//
// Replaces shared_simd_scan_tpu/ops/aggregate.py _agg_bitplane_kernel /
// aggregate_bitplane_tiles: keys read from device memory; per key match =
// AND_p (pplane_p ^ (bit_p(key) - 1)), killed for keys >= 2^wp.  Every
// match word is ANDed with the block's validity word, as in the
// reference, so padding matches no key.  (Host keys take agg_lookup.cu:
// one key lookup and scatter-add per value.)
//
// Bound on the H100: the integer instruction rate, not bytes, from a few
// keys on: per block a fixed unpack and bit-plane transpose of both
// columns, then per key ~4 ops per measure plane (AND, popcount, shift,
// add) on 32 values at once.  Design: one thread per 32-value block, in
// two stages so that no kernel is templated on both widths (31 x 31
// bodies):
//  1. match words (a switch on wp over template<int WP> bodies): the
//     predicate block unpacked and transposed into planes by the pruned
//     butterfly (common.cuh), then the fold per key; the k match words go
//     to shared memory laid out [key][thread] (no bank conflicts, no sync:
//     a thread reads only its own);
//  2. accumulate (a switch on wm over template<int WM> bodies): the
//     measure block's planes in registers, then per key the count and the
//     sum parts lo = sum_{p<16} popc << p and hi = sum_{p>=16} popc <<
//     (p-16), each < 32 * 2^16 = 2^21, reduced exactly by add_split_sum.
// Dynamic shared memory: k words per thread (32 KB at k = 32 and 256
// threads).
#include "common.cuh"

namespace sss {

template <int WP>
__device__ __forceinline__ void runtime_match_words(const uint32_t* __restrict__ ptiles,
                                                    const uint32_t* __restrict__ keys, int k,
                                                    long long nblocks, long long b, bool active,
                                                    uint32_t valid, uint32_t* s_mw, int stride) {
  uint32_t w[WP];
  load_block<WP>(ptiles, nblocks, b, active, w);
  uint32_t x[kBlockValues];
  unpack_values<WP>(w, x);
  transpose_bitplanes<WP>(x);
#pragma unroll 1
  for (int j = 0; j < k; ++j) {
    const uint32_t key = __ldg(keys + j);
    uint32_t acc = key <= value_mask<WP>() ? valid : 0u;
#pragma unroll
    for (int p = 0; p < WP; ++p) acc &= x[p] ^ (((key >> p) & 1u) - 1u);
    s_mw[j * stride + threadIdx.x] = acc;
  }
}

__device__ void runtime_match_words_any(int wp, const uint32_t* __restrict__ ptiles,
                                        const uint32_t* __restrict__ keys, int k,
                                        long long nblocks, long long b, bool active,
                                        uint32_t valid, uint32_t* s_mw, int stride) {
  switch (wp) {
#define SSS_CASE(W)                                                                     \
  case W:                                                                               \
    runtime_match_words<W>(ptiles, keys, k, nblocks, b, active, valid, s_mw, stride);   \
    return;
    SSS_FOR_EACH_WIDTH(SSS_CASE)
#undef SSS_CASE
  }
}

template <int WM>
__device__ __forceinline__ void accumulate(const uint32_t* __restrict__ mtiles, long long nblocks,
                                           long long b, bool active, const uint32_t* s_mw,
                                           int stride, int k, unsigned* s_cnt, unsigned* s_lo,
                                           unsigned* s_hi) {
  uint32_t w[WM];
  load_block<WM>(mtiles, nblocks, b, active, w);
  uint32_t x[kBlockValues];
  unpack_values<WM>(w, x);
  transpose_bitplanes<WM>(x);
#pragma unroll 1
  for (int j = 0; j < k; ++j) {
    const uint32_t mw = s_mw[j * stride + threadIdx.x];
    count_row(j, mw, s_cnt);
    unsigned lo = 0u, hi = 0u;
#pragma unroll
    for (int p = 0; p < WM; ++p) {
      const unsigned pc = (unsigned)__popc(mw & x[p]);
      if (p < 16) lo += pc << p;
      else hi += pc << (p - 16);
    }
    add_split_sum(s_lo, s_hi, j, lo, hi);
  }
}

__device__ void accumulate_any(int wm, const uint32_t* __restrict__ mtiles, long long nblocks,
                               long long b, bool active, const uint32_t* s_mw, int stride, int k,
                               unsigned* s_cnt, unsigned* s_lo, unsigned* s_hi) {
  switch (wm) {
#define SSS_CASE(W)                                                                         \
  case W:                                                                                   \
    accumulate<W>(mtiles, nblocks, b, active, s_mw, stride, k, s_cnt, s_lo, s_hi);          \
    return;
    SSS_FOR_EACH_WIDTH(SSS_CASE)
#undef SSS_CASE
  }
}

__global__ void __launch_bounds__(kThreads)
agg_bitplane_kernel(const uint32_t* __restrict__ ptiles, const uint32_t* __restrict__ mtiles,
                    const uint32_t* __restrict__ keys, int k, int wp, int wm,
                    unsigned long long* __restrict__ counts,
                    unsigned long long* __restrict__ sums, long long nblocks, long long n,
                    long long block_offset) {
  extern __shared__ uint32_t s_mw[];  // [k][thread] match words
  __shared__ unsigned s_cnt[kMaxAggKeys], s_lo[kMaxAggKeys], s_hi[kMaxAggKeys];
  zero_sums(s_cnt, s_lo, s_hi, k);
  const int stride = blockDim.x;
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = b < nblocks;
  const uint32_t valid = active ? valid_word(block_offset + b, n) : 0u;
  runtime_match_words_any(wp, ptiles, keys, k, nblocks, b, active, valid, s_mw, stride);
  accumulate_any(wm, mtiles, nblocks, b, active, s_mw, stride, k, s_cnt, s_lo, s_hi);
  flush_sums(s_cnt, s_lo, s_hi, k, counts, sums);
}

inline bool args_ok(int k, int wp, int wm) {
  return k >= 1 && k <= kMaxAggKeys && width_ok(wp) && width_ok(wm);
}

}  // namespace sss

// counts and sums are int64[k], zeroed by the caller.
extern "C" int sss_agg_bitplane(const uint32_t* ptiles, const uint32_t* mtiles,
                                const uint32_t* keys, int k, long long* counts, long long* sums,
                                long long nblocks, int wp, int wm, long long n,
                                long long block_offset, cudaStream_t stream) {
  if (!sss::args_ok(k, wp, wm)) return (int)cudaErrorInvalidValue;
  if (nblocks <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)k * sss::kThreads * sizeof(uint32_t);  // <= 32 KB
  sss::agg_bitplane_kernel<<<sss::grid_for(nblocks), sss::kThreads, smem, stream>>>(
      ptiles, mtiles, keys, k, wp, wm,
      reinterpret_cast<unsigned long long*>(counts), reinterpret_cast<unsigned long long*>(sums),
      nblocks, n, block_offset);
  return (int)cudaGetLastError();
}

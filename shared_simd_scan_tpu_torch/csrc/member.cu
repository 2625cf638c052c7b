// IN-list (membership) scans: one bitvector row for a whole key set.
//
// Replaces the bodies of shared_simd_scan_tpu/ops/member.py _member_call:
//  - sss_member_compare: _member_compare_kernel and
//    _member_chunked_compare_kernel.  An OR of equality compares over keys
//    read from device memory, any k, so one kernel serves both.  The TPU's
//    32-key chunks (partial rows ORed outside) and 0xFFFFFFFF key padding
//    exist for its VMEM; here the key loop runs to k and padding keys,
//    which no value equals, change nothing;
//  - sss_member_window: _member_window_kernel and
//    _member_chunked_window_kernel.  Walks (base, popmask) windows from
//    device memory, any count: value v matches window (b, p) iff
//    (1 << (v - b)) & p != 0, the one-hot through PTX shl.b32 when the
//    shift canary saw it saturate, gated otherwise (as interval_scan.cu);
//  - sss_member_domain: _member_domain_kernel.  The key set as a 2^W-bit
//    table: each CTA builds it in shared memory from the keys with
//    atomicOr (keys >= 32 * nwords are dropped, duplicates merge), so
//    runtime keys never reach the host; then bit v & 31 of word v >> 5.
//    The TPU selects the word with a select tree because Mosaic has no
//    gather; a shared-memory load is the gather here.  Widths 1..16 (a
//    table of at most 8 KB).
// The OR-tree and bit-sliced bodies run in bitsliced.cu
// (sss_bitsliced_static_scan with OR instructions, sss_member_bitsliced).
//
// Bound on the H100: device memory bytes (reads W words, writes one word
// per 32 values) for small sets; integer issue beyond: compare ~2 ops per
// value per key, window ~4 per value per window, domain ~6 per value flat
// in k.  Design: one thread per 32-value block, the 32 values unpacked
// into registers once; keys and windows read warp-uniformly through the
// read-only cache.  The count is the popcount of the final row, so
// duplicate keys count once; counts as in shared_scan.cu, with one row.
#include "common.cuh"

namespace sss {

template <int W>
__global__ void __launch_bounds__(kThreads)
member_compare_kernel(const uint32_t* __restrict__ tiles, const uint32_t* __restrict__ keys,
                      int k, uint32_t* __restrict__ bits, unsigned long long* __restrict__ counts,
                      long long nblocks, long long n, long long block_offset) {
  __shared__ unsigned s_cnt[1];
  zero_counts(s_cnt, 1);
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = b < nblocks;
  uint32_t w[W];
  load_block<W>(tiles, nblocks, b, active, w);
  const uint32_t valid = active ? valid_word(block_offset + b, n) : 0u;
  uint32_t v[kBlockValues];
  unpack_values<W>(w, v);

  uint32_t acc = 0u;
  for (int j = 0; j < k; ++j) {
    const uint32_t key = __ldg(keys + j);
#pragma unroll
    for (int r = 0; r < kBlockValues; ++r) acc |= (uint32_t)(v[r] == key) << r;
  }
  store_row(bits, nblocks, b, active, 0, acc & valid, s_cnt);
  flush_counts(s_cnt, 1, counts);
}

template <int W, bool kGateless>
__global__ void __launch_bounds__(kThreads)
member_window_kernel(const uint32_t* __restrict__ tiles, const uint2* __restrict__ win, int nwin,
                     uint32_t* __restrict__ bits, unsigned long long* __restrict__ counts,
                     long long nblocks, long long n, long long block_offset) {
  __shared__ unsigned s_cnt[1];
  zero_counts(s_cnt, 1);
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = b < nblocks;
  uint32_t w[W];
  load_block<W>(tiles, nblocks, b, active, w);
  const uint32_t valid = active ? valid_word(block_offset + b, n) : 0u;
  uint32_t v[kBlockValues];
  unpack_values<W>(w, v);

  uint32_t acc = 0u;
  for (int i = 0; i < nwin; ++i) {
    const uint2 bp = __ldg(win + i);  // (base, popmask)
#pragma unroll
    for (int r = 0; r < kBlockValues; ++r)
      acc |= (uint32_t)((onehot<kGateless>(v[r] - bp.x) & bp.y) != 0u) << r;
  }
  store_row(bits, nblocks, b, active, 0, acc & valid, s_cnt);
  flush_counts(s_cnt, 1, counts);
}

template <int W>
__global__ void __launch_bounds__(kThreads)
member_domain_kernel(const uint32_t* __restrict__ tiles, const uint32_t* __restrict__ keys, int k,
                     uint32_t* __restrict__ bits, unsigned long long* __restrict__ counts,
                     long long nblocks, long long n, long long block_offset) {
  constexpr int kWords = W > 5 ? 1 << (W - 5) : 1;
  __shared__ uint32_t s_tab[kWords];
  __shared__ unsigned s_cnt[1];
  for (int i = threadIdx.x; i < kWords; i += blockDim.x) s_tab[i] = 0u;
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const uint32_t key = __ldg(keys + j);
    if ((key >> 5) < (uint32_t)kWords) atomicOr(s_tab + (key >> 5), 1u << (key & 31u));
  }
  zero_counts(s_cnt, 1);  // its barrier also publishes the table
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = b < nblocks;
  uint32_t w[W];
  load_block<W>(tiles, nblocks, b, active, w);
  const uint32_t valid = active ? valid_word(block_offset + b, n) : 0u;

  uint32_t acc = 0u;
#pragma unroll
  for (int r = 0; r < kBlockValues; ++r) {
    const uint32_t x = unpack_value<W>(w, r);
    acc |= ((s_tab[x >> 5] >> (x & 31u)) & 1u) << r;
  }
  store_row(bits, nblocks, b, active, 0, acc & valid, s_cnt);
  flush_counts(s_cnt, 1, counts);
}

}  // namespace sss

// Widths 1..16 for the domain table.
#define SSS_FOR_EACH_DOMAIN_WIDTH(CASE)                                                \
  CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8) CASE(9) CASE(10)     \
  CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)

extern "C" int sss_member_compare(const uint32_t* tiles, const uint32_t* keys, int k,
                                  uint32_t* bits, unsigned long long* counts, long long nblocks,
                                  int width, long long n, long long block_offset,
                                  cudaStream_t stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  if (nblocks <= 0) return (int)cudaSuccess;
  const unsigned grid = sss::grid_for(nblocks);
  switch (width) {
#define SSS_CASE(W)                                                           \
  case W:                                                                     \
    sss::member_compare_kernel<W><<<grid, sss::kThreads, 0, stream>>>(        \
        tiles, keys, k, bits, counts, nblocks, n, block_offset);              \
    break;
    SSS_FOR_EACH_WIDTH(SSS_CASE)
#undef SSS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// win is int32[nwin, 2]: (base, popmask) per window.
extern "C" int sss_member_window(const uint32_t* tiles, const int* win, int nwin, uint32_t* bits,
                                 unsigned long long* counts, long long nblocks, int width,
                                 long long n, long long block_offset, int gateless,
                                 cudaStream_t stream) {
  if (nwin < 1) return (int)cudaErrorInvalidValue;
  if (nblocks <= 0) return (int)cudaSuccess;
  const unsigned grid = sss::grid_for(nblocks);
  const uint2* w2 = reinterpret_cast<const uint2*>(win);
  switch (width) {
#define SSS_CASE(W)                                                                \
  case W:                                                                          \
    if (gateless)                                                                  \
      sss::member_window_kernel<W, true><<<grid, sss::kThreads, 0, stream>>>(      \
          tiles, w2, nwin, bits, counts, nblocks, n, block_offset);                \
    else                                                                           \
      sss::member_window_kernel<W, false><<<grid, sss::kThreads, 0, stream>>>(     \
          tiles, w2, nwin, bits, counts, nblocks, n, block_offset);                \
    break;
    SSS_FOR_EACH_WIDTH(SSS_CASE)
#undef SSS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int sss_member_domain(const uint32_t* tiles, const uint32_t* keys, int k,
                                 uint32_t* bits, unsigned long long* counts, long long nblocks,
                                 int width, long long n, long long block_offset,
                                 cudaStream_t stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  if (nblocks <= 0) return (int)cudaSuccess;
  const unsigned grid = sss::grid_for(nblocks);
  switch (width) {
#define SSS_CASE(W)                                                           \
  case W:                                                                     \
    sss::member_domain_kernel<W><<<grid, sss::kThreads, 0, stream>>>(         \
        tiles, keys, k, bits, counts, nblocks, n, block_offset);              \
    break;
    SSS_FOR_EACH_DOMAIN_WIDTH(SSS_CASE)
#undef SSS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

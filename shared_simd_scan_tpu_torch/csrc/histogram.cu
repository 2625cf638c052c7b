// Value histograms over a packed column, no bitvector: the counts of keys
// lo..lo+k-1 (1 <= k <= 4096), in two forms of one kernel.
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
// missing scatter, which ran here as a program for sss_histogram_dag at
// 179x its bound; on this card a scatter into shared memory is cheap, so
// both forms share one body, lo by pointer or by value.
//
// Bound on the H100: device memory bytes (W words per 32 values); the
// integer issue of unpack, compare and one shared atomic per value in the
// window comes close at W = 9.  Design: CTAs as many as are resident on the
// card, each looping over tiles of 256 blocks (one thread per block) with
// its k bins in shared memory (16 KB at k = 4096).  Each value in the
// window adds one to its bin with a shared-memory atomic.  Bin d lives at
// slot d ^ ((d >> 5) & 31), which spreads bins 32 apart (value slot r of
// 32 neighbouring blocks of an i % 2^w column) over distinct banks.
// Grouping a warp's lanes by bin first (__match_any_sync, one atomic per
// group), a ballot-guarded uniform path and per-warp bins were measured
// against this form on the card and lost on every column, sorted ones
// included (shared_simd_scan_tpu_torch/bench/bin_variants.py).  Flush: one
// int64 atomic per non-zero bin per CTA.
#include "common.cuh"

namespace sss {

__device__ __forceinline__ uint32_t bin_slot(uint32_t d) { return d ^ ((d >> 5) & 31u); }

// lo is read at lo_ptr, or is lo_value where lo_ptr is null.
template <int W>
__global__ void __launch_bounds__(kThreads)
histogram_kernel(const uint32_t* __restrict__ tiles, const uint32_t* __restrict__ lo_ptr,
                 uint32_t lo_value, int k, unsigned long long* __restrict__ counts,
                 long long nblocks, long long n, long long block_offset) {
  __shared__ unsigned s_bin[kMaxHistKeys];
  const int slots = (k + 31) & ~31;  // bin_slot(d) < slots for every d < k
  zero_counts(s_bin, slots);
  const uint32_t lo = lo_ptr ? __ldg(lo_ptr) : lo_value;
  const long long ntiles = (nblocks + blockDim.x - 1) / blockDim.x;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long b = t * blockDim.x + threadIdx.x;
    const bool active = b < nblocks;
    uint32_t w[W];
    load_block<W>(tiles, nblocks, b, active, w);
    const uint32_t valid = active ? valid_word(block_offset + b, n) : 0u;
#pragma unroll
    for (int r = 0; r < kBlockValues; ++r) {
      const uint32_t d = unpack_value<W>(w, r) - lo;
      if (((valid >> r) & 1u) && d < (uint32_t)k) atomicAdd(s_bin + bin_slot(d), 1u);
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < slots; p += blockDim.x) {
    const unsigned c = s_bin[p];
    if (c) atomicAdd(counts + bin_slot((uint32_t)p), (unsigned long long)c);  // bin_slot is its own inverse
  }
}

template <int W>
cudaError_t launch_histogram(const uint32_t* tiles, const uint32_t* lo_ptr, uint32_t lo_value,
                             int k, unsigned long long* counts, long long nblocks, long long n,
                             long long block_offset, cudaStream_t stream) {
  unsigned grid = 0;
  const cudaError_t err =
      resident_grid(histogram_kernel<W>, kThreads, 0, (nblocks + kThreads - 1) / kThreads, &grid);
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

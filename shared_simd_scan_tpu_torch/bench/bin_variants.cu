// Four ways for the runtime-lo histogram (csrc/histogram.cu) to add a
// value to its bin, for bench/bin_variants.py to time on the card.  Not
// part of the kernel library.
//   0: group the warp's lanes by bin (__match_any_sync), one atomic per group
//   1: one shared atomic per value (the form csrc/histogram.cu uses)
//   2: a ballot; one atomic when every lane in the window holds one bin,
//      else one per value
//   3: per-warp bins (k <= 512), summed at the flush
#include "../csrc/common.cuh"

namespace sss {

__device__ __forceinline__ uint32_t slot_of(uint32_t d) { return d ^ ((d >> 5) & 31u); }

template <int W, int V>
__global__ void __launch_bounds__(kThreads)
bin_variant_kernel(const uint32_t* __restrict__ tiles, uint32_t lo, int k,
                   unsigned long long* __restrict__ counts, long long nblocks, long long n) {
  __shared__ unsigned s_bin[kMaxHistKeys];
  __shared__ unsigned s_warp[V == 3 ? 8 * 512 : 1];
  const int slots = (k + 31) & ~31;
  if (V == 3)
    for (int j = threadIdx.x; j < 8 * 512; j += blockDim.x) s_warp[j] = 0u;
  zero_counts(s_bin, slots);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long ntiles = (nblocks + blockDim.x - 1) / blockDim.x;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long b = t * blockDim.x + threadIdx.x;
    const bool active = b < nblocks;
    uint32_t w[W];
    load_block<W>(tiles, nblocks, b, active, w);
    const uint32_t valid = active ? valid_word(b, n) : 0u;
#pragma unroll
    for (int r = 0; r < kBlockValues; ++r) {
      const uint32_t d = unpack_value<W>(w, r) - lo;
      const bool in = ((valid >> r) & 1u) && d < (uint32_t)k;
      if (V == 0) {
        if (__any_sync(0xFFFFFFFFu, in)) {
          const unsigned same = __match_any_sync(0xFFFFFFFFu, in ? d : 0xFFFFFFFFu);
          if (in && lane == __ffs(same) - 1) atomicAdd(s_bin + slot_of(d), (unsigned)__popc(same));
        }
      } else if (V == 1) {
        if (in) atomicAdd(s_bin + slot_of(d), 1u);
      } else if (V == 2) {
        const unsigned ballot = __ballot_sync(0xFFFFFFFFu, in);
        if (ballot) {
          const int first = __ffs(ballot) - 1;
          const uint32_t d0 = __shfl_sync(0xFFFFFFFFu, d, first);
          if (__all_sync(0xFFFFFFFFu, !in || d == d0)) {
            if (lane == first) atomicAdd(s_bin + slot_of(d0), (unsigned)__popc(ballot));
          } else if (in) {
            atomicAdd(s_bin + slot_of(d), 1u);
          }
        }
      } else if (in) {
        atomicAdd(s_warp + warp * 512 + slot_of(d), 1u);
      }
    }
  }
  __syncthreads();
  if (V == 3) {
    for (int p = threadIdx.x; p < slots; p += blockDim.x)
      for (int q = 0; q < 8; ++q) s_bin[p] += s_warp[q * 512 + p];
    __syncthreads();
  }
  for (int p = threadIdx.x; p < slots; p += blockDim.x) {
    const unsigned c = s_bin[p];
    if (c) atomicAdd(counts + slot_of((uint32_t)p), (unsigned long long)c);
  }
}

template <int W, int V>
int launch_variant(const uint32_t* tiles, uint32_t lo, int k, unsigned long long* counts,
                   long long nblocks, long long n, cudaStream_t stream) {
  unsigned grid = 0;
  const cudaError_t err = resident_grid(bin_variant_kernel<W, V>, kThreads, 0,
                                        (nblocks + kThreads - 1) / kThreads, &grid);
  if (err != cudaSuccess) return (int)err;
  bin_variant_kernel<W, V><<<grid, kThreads, 0, stream>>>(tiles, lo, k, counts, nblocks, n);
  return (int)cudaGetLastError();
}

template <int W>
int launch_width(int variant, const uint32_t* tiles, uint32_t lo, int k,
                 unsigned long long* counts, long long nblocks, long long n,
                 cudaStream_t stream) {
  switch (variant) {
    case 0: return launch_variant<W, 0>(tiles, lo, k, counts, nblocks, n, stream);
    case 1: return launch_variant<W, 1>(tiles, lo, k, counts, nblocks, n, stream);
    case 2: return launch_variant<W, 2>(tiles, lo, k, counts, nblocks, n, stream);
    default: return launch_variant<W, 3>(tiles, lo, k, counts, nblocks, n, stream);
  }
}

}  // namespace sss

// Widths 9 and 20 (the columns bench/bin_variants.py draws); counts int64[k], zeroed.
extern "C" int sss_bin_variant(int variant, const uint32_t* tiles, uint32_t lo, int k,
                               unsigned long long* counts, long long nblocks, int width,
                               long long n, cudaStream_t stream) {
  if (variant < 0 || variant > 3 || k < 1 || k > (variant == 3 ? 512 : sss::kMaxHistKeys))
    return (int)cudaErrorInvalidValue;
  if (width == 9) return sss::launch_width<9>(variant, tiles, lo, k, counts, nblocks, n, stream);
  if (width == 20) return sss::launch_width<20>(variant, tiles, lo, k, counts, nblocks, n, stream);
  return (int)cudaErrorInvalidValue;
}

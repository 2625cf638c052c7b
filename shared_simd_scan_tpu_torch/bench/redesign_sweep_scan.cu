// The interval and compare kernels' designs side by side, for
// bench/redesign_sweep.py (sections interval and compare) to time on the
// card.  Not part of the kernel library: it includes the library's
// interval_scan.cu and shared_scan.cu for their bodies and their staged
// tile loop (common.cuh staged_tiles: a ring filled by a 2-D TMA tensor map
// over [W, nblocks], one copy a tile, the ragged tile's blocks past nblocks
// filled with zeros) at any CTA size and ring depth, and adds the designs
// the library does not use:
//   - both kernels before the redesign: one thread a block on a grid of a
//     CTA a tile of 256 blocks, each CTA zeroing and flushing its counters;
//     the interval kernel's masks m[32] held across its rounds, the compare
//     kernel's 32 shifted operands built for every key of every block;
//   - the redesigned bodies on resident CTAs whose threads load their own
//     blocks' words (no ring), and on a grid of a CTA a tile so loading;
//   - the TMA ring with a CTA for every run of 1-16 consecutive tiles in
//     place of the resident grid;
//   - the redesigned bodies on a ring filled by W bulk copies a tile
//     (cp.async.bulk) in place of the tensor map.
// Widths 9, 17, 25 and 31; the interval kernel with the gateless one-hot.
#include "../csrc/interval_scan.cu"
#include "../csrc/shared_scan.cu"

namespace sss {

// ---- before the redesign ---------------------------------------------------

template <int kByte, int kG>
__device__ __forceinline__ uint32_t mask_byte(uint32_t m) {
  constexpr int sh = 8 * (kByte - kG);
  if constexpr (sh > 0) m >>= sh;
  if constexpr (sh < 0) m <<= -sh;
  if constexpr (sh == 24 || sh == -24) return m;
  else return m & (0xFFu << (8 * kG));
}

template <int kByte>
__device__ __forceinline__ void interval_round_m(const uint32_t (&m)[kBlockValues], int j0, int kc,
                                                 uint32_t valid, const BitsSink& sink) {
  uint32_t x[8];
#pragma unroll
  for (int t = 0; t < 8; ++t)
    x[t] = mask_byte<kByte, 0>(m[t]) | mask_byte<kByte, 1>(m[8 + t]) |
           mask_byte<kByte, 2>(m[16 + t]) | mask_byte<kByte, 3>(m[24 + t]);
  transpose8x8_bytes(x);
  sink.rows8(j0 + 8 * kByte, x, valid, kc - 8 * kByte);
}

template <int W>
__global__ void __launch_bounds__(kThreads)
interval_parent_kernel(const uint32_t* __restrict__ tiles, uint32_t lo, int k,
                       uint32_t* __restrict__ bits, unsigned long long* __restrict__ counts,
                       long long nblocks, long long n) {
  __shared__ unsigned s_cnt[kMaxKeys];
  zero_counts(s_cnt, k);
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = b < nblocks;
  uint32_t w[W];
  load_block<W>(tiles, nblocks, b, active, w);
  const uint32_t valid = active ? valid_word(b, n) : 0u;
  uint32_t v[kBlockValues];
  unpack_values<W>(w, v);
  const BitsSink sink{bits, nblocks, b, active, s_cnt};
  for (int j0 = 0; j0 < k; j0 += 32) {
    const uint32_t lo_c = lo + (uint32_t)j0;
    const int kc = k - j0 < 32 ? k - j0 : 32;
    uint32_t m[kBlockValues];
#pragma unroll
    for (int r = 0; r < kBlockValues; ++r) m[r] = onehot<true>(v[r] - lo_c);
    interval_round_m<0>(m, j0, kc, valid, sink);
    if (kc > 8) interval_round_m<1>(m, j0, kc, valid, sink);
    if (kc > 16) interval_round_m<2>(m, j0, kc, valid, sink);
    if (kc > 24) interval_round_m<3>(m, j0, kc, valid, sink);
  }
  flush_counts(s_cnt, k, counts);
}

template <int W>
__global__ void __launch_bounds__(kThreads)
compare_parent_kernel(const uint32_t* __restrict__ tiles, const uint32_t* __restrict__ keys, int k,
                      uint32_t* __restrict__ bits, unsigned long long* __restrict__ counts,
                      long long nblocks, long long n) {
  __shared__ unsigned s_cnt[kMaxKeys];
  zero_counts(s_cnt, k);
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = b < nblocks;
  uint32_t w[W];
  load_block<W>(tiles, nblocks, b, active, w);
  const uint32_t valid = active ? valid_word(b, n) : 0u;
  uint32_t x[kBlockValues];
#pragma unroll
  for (int r = 0; r < kBlockValues; ++r)
    x[r] = slot_straddles<W>(r) ? unpack_value<W>(w, r)
                                : w[slot_word<W>(r)] & (value_mask<W>() << slot_shift<W>(r));
  for (int j = 0; j < k; ++j) {
    const uint32_t key = __ldg(keys + j);
    const bool in_domain = key <= value_mask<W>();
    uint32_t acc = 0u;
#pragma unroll
    for (int r = 0; r < kBlockValues; ++r) {
      const uint32_t want = slot_straddles<W>(r)
                                ? key
                                : (in_domain ? key << slot_shift<W>(r) : 0xFFFFFFFFu);
      acc |= (uint32_t)(x[r] == want) << r;
    }
    store_row(bits, nblocks, b, active, j, acc & valid, s_cnt);
  }
  flush_counts(s_cnt, k, counts);
}

// ---- the other tile loops ------------------------------------------------

// Resident CTAs, each thread loading its own block's words.
template <int W, int T, typename Body>
__device__ __forceinline__ void direct_tiles(const uint32_t* __restrict__ tiles, long long nblocks,
                                             Body&& body) {
  const long long ntiles = (nblocks + T - 1) / T;
#pragma unroll 1
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long b = t * T + threadIdx.x;
    const bool active = b < nblocks;
    uint32_t w[W];
    load_block<W>(tiles, nblocks, b, active, w);
    body(w, b, active);
  }
}

// The staged loop with the ring filled by W bulk copies a tile
// (cp.async.bulk, the TMA's non-tensor form): in the layout [j][nblocks]
// the W words of a tile are W runs of 4T contiguous bytes, 16-byte aligned;
// the ragged tile copies only its blocks, and a thread past nblocks gets
// zeros.
template <int W, int T>
__device__ __forceinline__ void bulk_stage_tile(const uint32_t* __restrict__ tiles,
                                                long long nblocks, long long tile,
                                                uint32_t* stage, uint64_t* bar) {
  const long long first = tile * T;
  const long long left = nblocks - first;
  const uint32_t bytes = (uint32_t)(left < T ? left : T) * 4u;
  mbar_expect_tx(bar, W * bytes);
#pragma unroll 1
  for (int j = 0; j < W; ++j)
    bulk_load(stage + j * T, tiles + (size_t)j * nblocks + first, bytes, bar);
}

template <int W, int T, int kStages, typename Body>
__device__ __forceinline__ void bulk_tiles(const uint32_t* __restrict__ tiles, long long nblocks,
                                           uint32_t* s_ring, uint64_t* s_full, Body&& body) {
  const long long ntiles = (nblocks + T - 1) / T;
  const long long count =
      (long long)blockIdx.x < ntiles ? (ntiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&s_full[s], 1u);
    mbar_init_fence();
    for (int s = 0; s < kStages && s < count; ++s)
      bulk_stage_tile<W, T>(tiles, nblocks, blockIdx.x + (long long)s * gridDim.x,
                            s_ring + s * W * T, &s_full[s]);
  }
  __syncthreads();
#pragma unroll 1
  for (long long i = 0; i < count; ++i) {
    const int s = (int)(i % kStages);
    const long long tile = blockIdx.x + i * gridDim.x;
    const long long b = tile * T + threadIdx.x;
    const bool active = b < nblocks;
    mbar_wait(&s_full[s], (uint32_t)((i / kStages) & 1));
    const uint32_t* st = s_ring + s * W * T + threadIdx.x;
    uint32_t w[W];
#pragma unroll
    for (int j = 0; j < W; ++j) w[j] = active ? st[j * T] : 0u;
    __syncthreads();
    if (threadIdx.x == 0 && i + kStages < count) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      bulk_stage_tile<W, T>(tiles, nblocks, tile + (long long)kStages * gridDim.x,
                            s_ring + s * W * T, &s_full[s]);
    }
    body(w, b, active);
  }
}

// kGridLoop: direct_tiles on a grid of a CTA a tile (not resident).
constexpr int kBulkLoop = 0, kTmaLoop = 1, kDirectLoop = 2, kGridLoop = 3;

template <int W, int T, int kStages, int kLoop, typename Body>
__device__ __forceinline__ void tile_loop(const uint32_t* __restrict__ tiles,
                                          const CUtensorMap* tmap, long long nblocks,
                                          long long run, uint32_t* s_ring, uint64_t* s_full,
                                          Body&& body) {
  if constexpr (kLoop == kBulkLoop)
    bulk_tiles<W, T, kStages>(tiles, nblocks, s_ring, s_full, body);
  else if constexpr (kLoop == kTmaLoop)
    staged_tiles<W, T, kStages>(tmap, nblocks, run, s_ring, s_full, body);
  else  // kDirectLoop, kGridLoop
    direct_tiles<W, T>(tiles, nblocks, body);
}

template <int W, int T, int kStages, int kLoop>
__global__ void __launch_bounds__(T)
interval_variant_kernel(const uint32_t* __restrict__ tiles,
                        const __grid_constant__ CUtensorMap tmap, uint32_t lo, int k,
                        uint32_t* __restrict__ bits, unsigned long long* __restrict__ counts,
                        long long nblocks, long long n, long long run) {
  extern __shared__ __align__(128) uint32_t s_ring[];
  __shared__ __align__(8) uint64_t s_full[kStages];
  __shared__ unsigned s_cnt[kMaxKeys];
  zero_counts(s_cnt, k);
  tile_loop<W, T, kStages, kLoop>(
      tiles, &tmap, nblocks, run, s_ring, s_full,
      [&](const uint32_t (&w)[W], long long b, bool active) {
        const uint32_t valid = active ? valid_word(b, n) : 0u;
        uint32_t v[kBlockValues];
        unpack_values<W>(w, v);
        interval_block<true>(v, lo, k, valid, BitsSink{bits, nblocks, b, active, s_cnt});
      });
  flush_counts(s_cnt, k, counts);
}

template <int W, int T, int kStages, int kLoop>
__global__ void __launch_bounds__(T)
compare_variant_kernel(const uint32_t* __restrict__ tiles,
                       const __grid_constant__ CUtensorMap tmap, const uint32_t* __restrict__ keys,
                       int k, uint32_t* __restrict__ bits, unsigned long long* __restrict__ counts,
                       long long nblocks, long long n, long long run) {
  extern __shared__ __align__(128) uint32_t s_ring[];
  __shared__ __align__(8) uint64_t s_full[kStages];
  __shared__ unsigned s_cnt[kMaxKeys];
  __shared__ uint32_t s_key[kMaxKeys];
  for (int j = threadIdx.x; j < k; j += blockDim.x) s_key[j] = __ldg(keys + j);
  zero_counts(s_cnt, k);
  tile_loop<W, T, kStages, kLoop>(
      tiles, &tmap, nblocks, run, s_ring, s_full,
      [&](const uint32_t (&w)[W], long long b, bool active) {
        const uint32_t valid = active ? valid_word(b, n) : 0u;
        uint32_t v[kBlockValues];
        unpack_values<W>(w, v);
#pragma unroll 1
        for (int j = 0; j < k; ++j)
          store_row(bits, nblocks, b, active, j, compare_row(v, s_key[j]) & valid, s_cnt);
      });
  flush_counts(s_cnt, k, counts);
}

template <int W, int T, int kStages, int kLoop>
cudaError_t launch_variant(bool interval, const uint32_t* tiles, const uint32_t* keys, uint32_t lo,
                           int k, uint32_t* bits, unsigned long long* counts, long long nblocks,
                           long long n, long long run, cudaStream_t stream) {
  CUtensorMap map{};
  if (kLoop == kTmaLoop) {
    const cudaError_t err = tile_map(&map, tiles, W, nblocks, T);
    if (err != cudaSuccess) return err;
  }
  constexpr bool kRing = kLoop == kBulkLoop || kLoop == kTmaLoop;
  const size_t smem = kRing ? tile_ring_bytes(W, T, kStages) : 0;
  const unsigned tiles_grid = (unsigned)((nblocks + T - 1) / T);
  unsigned grid = 0;
  if (interval) {
    const auto kernel = interval_variant_kernel<W, T, kStages, kLoop>;
    cudaError_t err = staged_grid(kernel, T, smem, nblocks, run, &grid);
    if (err != cudaSuccess) return err;
    if (kLoop == kGridLoop) grid = tiles_grid;
    kernel<<<grid, T, smem, stream>>>(tiles, map, lo, k, bits, counts, nblocks, n, run);
  } else {
    const auto kernel = compare_variant_kernel<W, T, kStages, kLoop>;
    cudaError_t err = staged_grid(kernel, T, smem, nblocks, run, &grid);
    if (err != cudaSuccess) return err;
    if (kLoop == kGridLoop) grid = tiles_grid;
    kernel<<<grid, T, smem, stream>>>(tiles, map, keys, k, bits, counts, nblocks, n, run);
  }
  return cudaGetLastError();
}

template <int W>
cudaError_t sweep_at(bool interval, int variant, const uint32_t* tiles, const uint32_t* keys,
                     uint32_t lo, int k, uint32_t* bits, unsigned long long* counts,
                     long long nblocks, long long n, cudaStream_t stream) {
  switch (variant) {
    case 0:
      if (interval)
        interval_parent_kernel<W><<<grid_for(nblocks), kThreads, 0, stream>>>(tiles, lo, k, bits,
                                                                              counts, nblocks, n);
      else
        compare_parent_kernel<W><<<grid_for(nblocks), kThreads, 0, stream>>>(tiles, keys, k, bits,
                                                                             counts, nblocks, n);
      return cudaGetLastError();
#define SSS_VARIANT(V, T, S, L, R)                                                            \
  case V:                                                                                     \
    return launch_variant<W, T, S, L>(interval, tiles, keys, lo, k, bits, counts, nblocks, n, \
                                      R, stream);
    SSS_VARIANT(1, 256, 1, kDirectLoop, 0)
    SSS_VARIANT(2, 128, 2, kBulkLoop, 0)
    SSS_VARIANT(3, 128, 3, kBulkLoop, 0)
    SSS_VARIANT(4, 256, 2, kBulkLoop, 0)
    SSS_VARIANT(5, 256, 3, kBulkLoop, 0)
    SSS_VARIANT(6, 256, 2, kTmaLoop, 0)
    SSS_VARIANT(7, 256, 3, kTmaLoop, 0)
    SSS_VARIANT(8, 128, 3, kTmaLoop, 0)
    SSS_VARIANT(9, 128, 2, kTmaLoop, 0)
    SSS_VARIANT(10, 256, 1, kGridLoop, 0)
    SSS_VARIANT(11, 256, 2, kTmaLoop, 1)
    SSS_VARIANT(12, 256, 2, kTmaLoop, 2)
    SSS_VARIANT(13, 256, 2, kTmaLoop, 4)
    SSS_VARIANT(14, 256, 2, kTmaLoop, 8)
    SSS_VARIANT(15, 256, 2, kTmaLoop, 16)
#undef SSS_VARIANT
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace sss

// Variant `variant` of the interval kernel (interval != 0: keys lo..lo+k-1)
// or the compare kernel (keys, k <= kMaxKeys, in device memory) at width 9,
// 17, 25 or 31; bits (k, nblocks) and counts int64[k], zeroed by the caller.
extern "C" int sweep_scan(int interval, int variant, const uint32_t* tiles, const uint32_t* keys,
                          uint32_t lo, int k, uint32_t* bits, unsigned long long* counts,
                          long long nblocks, int width, long long n, cudaStream_t stream) {
  if (k < 1 || k > sss::kMaxKeys || nblocks <= 0) return (int)cudaErrorInvalidValue;
  switch (width) {
#define SSS_CASE(W)                                                                             \
  case W:                                                                                       \
    return (int)sss::sweep_at<W>(interval != 0, variant, tiles, keys, lo, k, bits, counts,     \
                                 nblocks, n, stream);
    SSS_CASE(9) SSS_CASE(17) SSS_CASE(25) SSS_CASE(31)
#undef SSS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

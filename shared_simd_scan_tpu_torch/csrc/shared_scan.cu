// Compare shared scans: k arbitrary equality keys in one pass, in three
// forms -- the general compare kernel, the chunked compare and the dynamic
// compare (the last two below the first).
//
// The general compare kernel replaces shared_simd_scan_tpu/ops/scan.py:
// _shared_scan_kernel / shared_scan_tiles, with its semantics:
//  - a slot that does not straddle a word boundary compares the word ANDed
//    with the clean mask (mask << s, value left in place) against key << s;
//    a straddling slot compares the normalized value against the key;
//  - a key >= 2^W is replaced by 0xFFFFFFFF for the clean compare, which no
//    cleaned word can equal (its bits outside [s, s+W) are zero);
//  - the validity word of the global block block_offset + b clears bits of
//    values at index >= n, so key 0 never matches the zero padding.
//
// Bound on the H100: device memory bytes for small k (reads W words, writes
// k words per 32 values); integer issue for large k (~3 ops per slot per
// key).  Design: one thread per 32-value block; the 32 compare operands are
// built once per block in registers and reused by every key; keys are read
// through the read-only cache (every lane reads the same key).  Hit counts
// are reduced per warp (__reduce_add_sync), per CTA in shared memory, and
// added to the int64 totals with one atomic per key per CTA.
#include "common.cuh"

namespace sss {

template <int W>
__global__ void __launch_bounds__(kThreads)
shared_scan_kernel(const uint32_t* __restrict__ tiles, const uint32_t* __restrict__ keys, int k,
                   uint32_t* __restrict__ bits, unsigned long long* __restrict__ counts,
                   long long nblocks, long long n, long long block_offset) {
  __shared__ unsigned s_cnt[kMaxKeys];
  zero_counts(s_cnt, k);
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = b < nblocks;
  uint32_t w[W];
  load_block<W>(tiles, nblocks, b, active, w);
  const uint32_t valid = active ? valid_word(block_offset + b, n) : 0u;

  // Compare operand per slot: the cleaned word, or the normalized value.
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

}  // namespace sss

// Keys are launched in chunks of kMaxKeys (the shared counters' size); each
// chunk writes its own rows of bits and counts.
extern "C" int sss_shared_scan(const uint32_t* tiles, const uint32_t* keys, int k, uint32_t* bits,
                               unsigned long long* counts, long long nblocks, int width,
                               long long n, long long block_offset, cudaStream_t stream) {
  if (nblocks <= 0 || k <= 0) return (int)cudaSuccess;
  const unsigned grid = sss::grid_for(nblocks);
  for (int j0 = 0; j0 < k; j0 += sss::kMaxKeys) {
    const int kc = k - j0 < sss::kMaxKeys ? k - j0 : sss::kMaxKeys;
    uint32_t* bits_c = bits + (size_t)j0 * nblocks;
    switch (width) {
#define SSS_CASE(W)                                                               \
  case W:                                                                         \
    sss::shared_scan_kernel<W><<<grid, sss::kThreads, 0, stream>>>(               \
        tiles, keys + j0, kc, bits_c, counts + j0, nblocks, n, block_offset);     \
    break;
      SSS_FOR_EACH_WIDTH(SSS_CASE)
#undef SSS_CASE
      default:
        return (int)cudaErrorInvalidValue;
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// The chunked and dynamic compares compare every key with the 32 normalized
// values of a block (the values unpacked once, as unpack_values gives
// them).  A value is below 2^W, so a key >= 2^W (0xFFFFFFFF included)
// matches nothing with no special case; the validity word clears bits of
// values at index >= n.  Both unpack through unpack_block_any, a switch on
// the runtime width, so one body serves every width.
//
// Bound on the H100: integer issue past a few keys (a compare and an OR per
// value per key), device memory bytes for small k (W words read, k words
// written per 32 values).  Counts are reduced per warp, per CTA in shared
// memory, and added to the int64 totals with one atomic per key per CTA.

namespace sss {

// Chunked compare.  Replaces shared_simd_scan_tpu/ops/scan.py:
// _shared_scan_chunked_kernel / shared_scan_chunked_tiles: a fixed, fully
// unrolled compare block of krows keys, stepped over key chunks on a second
// grid axis, with values unpacked once per block tile.  Here the grid is
// (key chunk, CTA of blocks), the chunk on blockIdx.x, the fast axis, so the
// chunks of one tile run together and all but the first read its W words
// from L2.  A CTA keeps its chunk's C keys in registers and walks tiles
// blockIdx.y, blockIdx.y + gridDim.y, ... (gridDim.y is capped at 65535).
// Keys past k are loaded as 0xFFFFFFFF, and their rows are neither computed
// nor stored.  C is 16: with 32 keys a CTA the compiler re-loads the keys
// instead of holding them beside the 32 values.
constexpr int kChunkKeys = 16;  // CHUNK_KEYS in ops/scan.py

__global__ void __launch_bounds__(kThreads)
shared_scan_chunked_kernel(const uint32_t* __restrict__ tiles, const uint32_t* __restrict__ keys,
                           int k, uint32_t* __restrict__ bits,
                           unsigned long long* __restrict__ counts, long long nblocks, int width,
                           long long n, long long block_offset, long long ntiles) {
  constexpr int C = kChunkKeys;
  __shared__ unsigned s_cnt[C];
  const int j0 = blockIdx.x * C;
  const int kc = k - j0 < C ? k - j0 : C;  // real rows of this chunk
  zero_counts(s_cnt, kc);
  uint32_t key[C];
#pragma unroll
  for (int j = 0; j < C; ++j) key[j] = j < kc ? __ldg(keys + j0 + j) : 0xFFFFFFFFu;
  uint32_t* rows = bits + (size_t)j0 * nblocks;
  for (long long tile = blockIdx.y; tile < ntiles; tile += gridDim.y) {
    const long long b = tile * blockDim.x + threadIdx.x;
    const bool active = b < nblocks;
    uint32_t v[kBlockValues];
    unpack_block_any(width, tiles, nblocks, b, active, v);
    const uint32_t valid = active ? valid_word(block_offset + b, n) : 0u;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (j < kc) {  // uniform across the CTA
        uint32_t acc = 0u;
#pragma unroll
        for (int r = 0; r < kBlockValues; ++r) acc |= (uint32_t)(v[r] == key[j]) << r;
        store_row(rows, nblocks, b, active, j, acc & valid, s_cnt);
      }
    }
  }
  flush_counts(s_cnt, kc, counts + j0);
}

// Dynamic compare.  Replaces shared_simd_scan_tpu/ops/scan.py:
// _shared_scan_dynamic_kernel / shared_scan_dynamic_tiles: the values of a
// tile unpacked once into a scratch, then a runtime loop over the keys with
// the slot loop unrolled.  Here the scratch is shared memory, 32 words a
// thread laid out [slot][thread] (the 32 lanes of a warp read 32 banks),
// read back for every key, so registers hold no compare operands; the
// launch's keys are staged in shared memory.  CTAs are resident and walk
// tiles blockIdx.x, blockIdx.x + gridDim.x, ..., so keys are staged and
// counters flushed once per CTA.
__global__ void __launch_bounds__(kThreads)
shared_scan_dynamic_kernel(const uint32_t* __restrict__ tiles, const uint32_t* __restrict__ keys,
                           int k, uint32_t* __restrict__ bits,
                           unsigned long long* __restrict__ counts, long long nblocks, int width,
                           long long n, long long block_offset, long long ntiles) {
  __shared__ uint32_t s_val[kBlockValues * kThreads];
  __shared__ uint32_t s_key[kMaxKeys];
  __shared__ unsigned s_cnt[kMaxKeys];
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    s_key[j] = __ldg(keys + j);
    s_cnt[j] = 0u;
  }
  __syncthreads();
  // volatile: every key reads the values from shared memory again
  volatile uint32_t* mine = s_val + threadIdx.x;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long b = tile * blockDim.x + threadIdx.x;
    const bool active = b < nblocks;
    uint32_t v[kBlockValues];
    unpack_block_any(width, tiles, nblocks, b, active, v);
#pragma unroll
    for (int r = 0; r < kBlockValues; ++r) mine[r * kThreads] = v[r];
    const uint32_t valid = active ? valid_word(block_offset + b, n) : 0u;
    for (int j = 0; j < k; ++j) {
      const uint32_t key = s_key[j];
      uint32_t acc = 0u;
#pragma unroll
      for (int r = 0; r < kBlockValues; ++r) acc |= (uint32_t)(mine[r * kThreads] == key) << r;
      store_row(bits, nblocks, b, active, j, acc & valid, s_cnt);
    }
  }
  flush_counts(s_cnt, k, counts);
}

}  // namespace sss

// kChunkKeys keys per CTA; any k in one launch.
extern "C" int sss_shared_scan_chunked(const uint32_t* tiles, const uint32_t* keys, int k,
                                       uint32_t* bits, unsigned long long* counts,
                                       long long nblocks, int width, long long n,
                                       long long block_offset, cudaStream_t stream) {
  if (!sss::width_ok(width)) return (int)cudaErrorInvalidValue;
  if (nblocks <= 0 || k <= 0) return (int)cudaSuccess;
  const long long ntiles = (nblocks + sss::kThreads - 1) / sss::kThreads;
  const dim3 grid((unsigned)((k + sss::kChunkKeys - 1) / sss::kChunkKeys),
                  (unsigned)(ntiles < 65535 ? ntiles : 65535));
  sss::shared_scan_chunked_kernel<<<grid, sss::kThreads, 0, stream>>>(
      tiles, keys, k, bits, counts, nblocks, width, n, block_offset, ntiles);
  return (int)cudaGetLastError();
}

// Keys are launched in chunks of kMaxKeys (the staged keys and shared
// counters' size); each chunk writes its own rows of bits and counts.
extern "C" int sss_shared_scan_dynamic(const uint32_t* tiles, const uint32_t* keys, int k,
                                       uint32_t* bits, unsigned long long* counts,
                                       long long nblocks, int width, long long n,
                                       long long block_offset, cudaStream_t stream) {
  if (!sss::width_ok(width)) return (int)cudaErrorInvalidValue;
  if (nblocks <= 0 || k <= 0) return (int)cudaSuccess;
  const long long ntiles = (nblocks + sss::kThreads - 1) / sss::kThreads;
  unsigned grid = 0;
  cudaError_t err = sss::resident_grid(sss::shared_scan_dynamic_kernel, sss::kThreads, 0, ntiles,
                                       &grid);
  if (err != cudaSuccess) return (int)err;
  for (int j0 = 0; j0 < k; j0 += sss::kMaxKeys) {
    const int kc = k - j0 < sss::kMaxKeys ? k - j0 : sss::kMaxKeys;
    sss::shared_scan_dynamic_kernel<<<grid, sss::kThreads, 0, stream>>>(
        tiles, keys + j0, kc, bits + (size_t)j0 * nblocks, counts + j0, nblocks, width, n,
        block_offset, ntiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

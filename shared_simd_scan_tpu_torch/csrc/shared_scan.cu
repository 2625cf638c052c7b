// Shared scans of k arbitrary equality keys in one pass, in three forms --
// the general compare kernel, the chunked scan (a key lookup per value) and
// the dynamic compare (the last two below the first).
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

// The chunked scan and the dynamic compare take the 32 normalized values of
// a block (unpacked once, as unpack_values gives them) through
// unpack_block_any, a switch on the runtime width, so one body serves every
// width.  A value is below 2^W, so a key >= 2^W (0xFFFFFFFF included)
// matches nothing with no special case; the validity word clears bits of
// values at index >= n.  Counts are reduced per warp, per CTA in shared
// memory, and added to the int64 totals with one atomic per key per CTA.

namespace sss {

// Chunked scan.  Replaces shared_simd_scan_tpu/ops/scan.py:
// _shared_scan_chunked_kernel / shared_scan_chunked_tiles: a fixed, fully
// unrolled compare block of krows keys, stepped over key chunks on a second
// grid axis, with values unpacked once per block tile.
//
// Bound on the H100: device memory bytes (W words read, k words written per
// 32 values).  A compare of every key with every value is O(k) integer work
// per value, several times the bytes' time at k = 64; here a value costs
// one lookup among its chunk's keys.  The grid is (key chunk, CTA of
// blocks), the chunk on blockIdx.x, the fast axis, so the chunks of one
// tile run together and all but the first read its words from L2; the
// CTAs are resident and walk tiles blockIdx.y, blockIdx.y + gridDim.y, ...
//
// Once per CTA: the chunk's C keys go to shared memory; rep[j] is the first
// index of the chunk whose key equals key j, so duplicates share its row;
// each first occurrence of a key below 2^W enters a lookup from value to
// local index -- a byte table of 2^W entries for W <= kDirectBits, else the
// chunk's distinct keys sorted (by rank) for a branch-free binary search of
// log2(C) steps: a fixed trip count, so no divergence and no worst case on
// adversarial keys, as a hash table would have.  Per tile, each thread
// unpacks its block once, zeroes its column of the row buffer rows[C][T] in
// shared memory (a column a thread: a warp's accesses fall in 32 banks, with
// no atomics), sets bit r of row lookup(v[r]) for each of its 32 values, and
// stores row j as rows[rep[j]] & valid, coalesced across the warp, counted
// by a warp reduce.  The work per value is O(1) (O(log C) past
// kDirectBits); only the row stores are O(k) per block, and they are the
// bytes that bound the kernel.
constexpr int kChunkKeys = 64;  // CHUNK_KEYS in ops/scan.py
constexpr int kChunkThreads = 256;
constexpr int kDirectBits = 12;    // widths looked up in a byte table (4 KB at most)
constexpr uint32_t kNoKey = 0xFFu;  // what a lookup gives for a value no key of the chunk holds

// A chunked CTA's dynamic shared memory: rows [C][T], key and cnt [C]
// (32-bit words), rep [C] (bytes), then the lookup -- the byte table
// [2^W] for W <= kDirectBits, else the sorted keys [C] and their local
// indices [C] (bytes).
template <int C, int T>
struct ChunkSmem {
  uint32_t* rows;
  uint32_t* key;
  unsigned* cnt;
  uint8_t* rep;
  uint8_t* table;
  uint32_t* sorted;
  uint8_t* sidx;
  __device__ explicit ChunkSmem(uint32_t* base)
      : rows(base), key(base + C * T), cnt(key + C), rep(reinterpret_cast<uint8_t*>(cnt + C)),
        table(rep + C), sorted(reinterpret_cast<uint32_t*>(rep + C)),
        sidx(reinterpret_cast<uint8_t*>(sorted + C)) {}
};

template <int C, int T>
inline size_t chunked_smem(int width) {
  const size_t lookup =
      width <= kDirectBits ? (((size_t)1 << width) + 15) / 16 * 16 : (size_t)C * 5;
  return (size_t)C * T * 4 + (size_t)C * 9 + lookup;
}

// Once per CTA: stage the chunk's kc keys (keys j0..j0+kc-1), find rep,
// build the lookup and zero every thread's column of rows.
template <int C, int T, bool kDirect>
__device__ __forceinline__ void chunk_setup(const ChunkSmem<C, T>& s,
                                            const uint32_t* __restrict__ keys, int j0, int kc,
                                            uint32_t vmask) {
  static_assert(C >= 4 && C <= 128 && (C & (C - 1)) == 0,
                "C: a power of two (the search halves it), local indices below kNoKey");
  for (int j = threadIdx.x; j < C; j += T) {
    s.key[j] = j < kc ? __ldg(keys + j0 + j) : 0xFFFFFFFFu;
    s.cnt[j] = 0u;
    s.rep[j] = (uint8_t)j;
    if (!kDirect) s.sorted[j] = 0xFFFFFFFFu;  // above every value: pads the search
  }
  if (kDirect)
    for (uint32_t v = threadIdx.x; v <= vmask; v += T) s.table[v] = (uint8_t)kNoKey;
  __syncthreads();
  for (int j = threadIdx.x; j < kc; j += T)
    for (int i = 0; i < j; ++i)
      if (s.key[i] == s.key[j]) {
        s.rep[j] = (uint8_t)i;
        break;
      }
  __syncthreads();
  for (int j = threadIdx.x; j < kc; j += T) {
    const uint32_t key = s.key[j];
    if (s.rep[j] != j || key > vmask) continue;  // a duplicate, or no value can match
    if (kDirect) {
      s.table[key] = (uint8_t)j;
    } else {
      int rank = 0;  // distinct keys of the domain below this one
      for (int i = 0; i < kc; ++i) rank += s.rep[i] == i && s.key[i] < key;
      s.sorted[rank] = key;
      s.sidx[rank] = (uint8_t)j;
    }
  }
  for (int i = 0; i < C; ++i) s.rows[i * T + threadIdx.x] = 0u;
  __syncthreads();
}

// The local index of the first key of the chunk equal to v, or kNoKey.
template <int C, int T, bool kDirect>
__device__ __forceinline__ uint32_t chunk_lookup(const ChunkSmem<C, T>& s, uint32_t v) {
  if (kDirect) return s.table[v];
  int pos = 0;
#pragma unroll
  for (int half = C / 2; half > 0; half >>= 1)
    if (s.sorted[pos + half - 1] < v) pos += half;
  return s.sorted[pos] == v ? (uint32_t)s.sidx[pos] : kNoKey;
}

// Set bit r of row lookup(v[r]) in this thread's column of rows, for the 32
// values of its block.  All 32 lookups are issued before the first update:
// the table loads are independent, while an update may alias an earlier one.
template <int C, int T, bool kDirect>
__device__ __forceinline__ void chunk_mark_rows(const ChunkSmem<C, T>& s, uint32_t* col,
                                                uint32_t (&v)[kBlockValues]) {
#pragma unroll
  for (int r = 0; r < kBlockValues; ++r) v[r] = chunk_lookup<C, T, kDirect>(s, v[r]);
#pragma unroll
  for (int r = 0; r < kBlockValues; ++r)
    if (v[r] != kNoKey) col[v[r] * T] |= 1u << r;
}

// Store rows 0..kc-1 of block b (row j is col[rep[j]] & valid) at out, the
// block's word of row 0, a row every nblocks words; inactive lanes store
// nothing.  The rows go 32 at a time: lane l keeps the warp's count of row
// g + l of the group (one __reduce_add_sync a row), and the group's counts
// reach the CTA's counters in one atomic a lane -- not one a row, whose
// branch and aggregation code cost more than the row itself.  kStore and
// kCount (both on in the kernel) let the sweep time the parts.
template <int C, int T, bool kStore = true, bool kCount = true>
__device__ __forceinline__ void chunk_store_rows(const ChunkSmem<C, T>& s, const uint32_t* col,
                                                 uint32_t* out, long long nblocks, bool active,
                                                 int kc, uint32_t valid) {
  const int lane = threadIdx.x & 31;
  for (int g = 0; g < kc; g += 32) {
    unsigned mine = 0u;
#pragma unroll
    for (int l = 0; l < 32; ++l) {
      if (g + l < kc) {  // uniform across the CTA
        const uint32_t word = col[s.rep[g + l] * T] & valid;
        if (kStore && active) *out = word;
        out += nblocks;
        if (kCount) {
          const unsigned c = __reduce_add_sync(0xFFFFFFFFu, (unsigned)__popc(word));
          if (lane == l) mine = c;
        }
      }
    }
    if (kCount && g + lane < kc && mine) atomicAdd(s.cnt + g + lane, mine);
  }
}

template <int C, int T, bool kDirect>
__global__ void __launch_bounds__(T)
shared_scan_chunked_kernel(const uint32_t* __restrict__ tiles, const uint32_t* __restrict__ keys,
                           int k, uint32_t* __restrict__ bits,
                           unsigned long long* __restrict__ counts, long long nblocks, int width,
                           long long n, long long block_offset, long long ntiles) {
  extern __shared__ __align__(16) uint32_t s_mem[];
  const ChunkSmem<C, T> s(s_mem);
  const int j0 = blockIdx.x * C;
  const int kc = k - j0 < C ? k - j0 : C;  // real rows of this chunk
  chunk_setup<C, T, kDirect>(s, keys, j0, kc, (1u << width) - 1u);
  uint32_t* rows = bits + (size_t)j0 * nblocks;
  uint32_t* col = s.rows + threadIdx.x;
  for (long long tile = blockIdx.y; tile < ntiles; tile += gridDim.y) {
    const long long b = tile * T + threadIdx.x;
    const bool active = b < nblocks;
    uint32_t v[kBlockValues];
    unpack_block_any(width, tiles, nblocks, b, active, v);
    for (int i = 0; i < kc; ++i) col[i * T] = 0u;
    chunk_mark_rows<C, T, kDirect>(s, col, v);
    const uint32_t valid = active ? valid_word(block_offset + b, n) : 0u;
    chunk_store_rows<C, T>(s, col, rows + b, nblocks, active, kc, valid);
  }
  flush_counts(s.cnt, kc, counts + j0);
}

// Any k in one launch: the chunks on grid axis x, and as many CTAs of
// blocks on axis y as the card holds beside them at the chunk's shared
// memory (whose limit is raised first: the rows pass the 48 KB default).
// `direct` and `search` are the kernel's two lookups.
template <int C, int T, typename Kernel>
cudaError_t chunked_launch_with(Kernel direct, Kernel search, const uint32_t* tiles,
                                const uint32_t* keys, int k, uint32_t* bits,
                                unsigned long long* counts, long long nblocks, int width,
                                long long n, long long block_offset, cudaStream_t stream) {
  if (!width_ok(width)) return cudaErrorInvalidValue;
  if (nblocks <= 0 || k <= 0) return cudaSuccess;
  const long long ntiles = (nblocks + T - 1) / T;
  const long long nchunks = (k + C - 1) / C;
  const size_t smem = chunked_smem<C, T>(width);
  const Kernel kernel = width <= kDirectBits ? direct : search;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  unsigned resident = 0;
  err = resident_grid(kernel, T, smem, 1LL << 40, &resident);
  if (err != cudaSuccess) return err;
  long long ny = resident / nchunks > 0 ? resident / nchunks : 1;
  if (ny > ntiles) ny = ntiles;
  if (ny > 65535) ny = 65535;
  kernel<<<dim3((unsigned)nchunks, (unsigned)ny), T, smem, stream>>>(
      tiles, keys, k, bits, counts, nblocks, width, n, block_offset, ntiles);
  return cudaGetLastError();
}

template <int C, int T>
cudaError_t chunked_launch(const uint32_t* tiles, const uint32_t* keys, int k, uint32_t* bits,
                           unsigned long long* counts, long long nblocks, int width, long long n,
                           long long block_offset, cudaStream_t stream) {
  return chunked_launch_with<C, T>(shared_scan_chunked_kernel<C, T, true>,
                                   shared_scan_chunked_kernel<C, T, false>, tiles, keys, k, bits,
                                   counts, nblocks, width, n, block_offset, stream);
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
  return (int)sss::chunked_launch<sss::kChunkKeys, sss::kChunkThreads>(
      tiles, keys, k, bits, counts, nblocks, width, n, block_offset, stream);
}

// Dynamic shared memory of one CTA of the chunked scan at this width.
extern "C" long long sss_shared_scan_chunked_smem(int width) {
  return (long long)sss::chunked_smem<sss::kChunkKeys, sss::kChunkThreads>(width);
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

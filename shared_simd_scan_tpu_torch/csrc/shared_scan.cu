// Shared scans of k arbitrary equality keys in one pass, in four forms --
// the general compare kernel, the chunked scan (a key lookup per value
// among 64 keys), the dynamic scan (a key lookup per value among a
// launch's 1024) and the windowed scan (a window lookup per value in the
// host's tables of a launch's keys), the last three below the first.
//
// The general compare kernel replaces shared_simd_scan_tpu/ops/scan.py:
// _shared_scan_kernel / shared_scan_tiles, with its results:
//  - the TPU kernel compares a slot that does not straddle a word boundary
//    as the word ANDed with the clean mask (mask << s) against key << s, a
//    straddling slot as the normalized value against the key, and turns a
//    key >= 2^W into 0xFFFFFFFF for the clean compare, which no cleaned
//    word can equal: bit r of row j is set iff value r equals key j;
//  - the validity word of the global block block_offset + b clears bits of
//    values at index >= n, so key 0 never matches the zero padding.
//
// Bound on the H100: device memory bytes for small k (reads W words, writes
// k words per 32 values); integer issue for large k (~3 ops a value a key:
// a compare and a bit set).  Design: one thread per 32-value block on the
// staged tile loop (common.cuh staged_tiles: CTAs of kCompareThreads
// threads, each tile's W rows one TMA tensor copy into a ring of
// kCompareStages stages ahead of use, a CTA for every run of staged_run
// tiles in address order, counts flushed once a CTA).
// The 32 values are unpacked once a block and compared whole with each key,
// which a CTA reads once into shared memory: a value is below 2^W, so a key
// >= 2^W matches nothing with no sentinel, and no key's 32 shifted operands
// are built per block (the kernel before built them for every key of every
// block, one thread a block on a grid of a CTA a tile).  Hit counts are
// reduced per warp (__reduce_add_sync), per CTA in shared memory, and added
// to the int64 totals with one atomic per key per CTA.  From the k where
// the plane fold runs faster (ops/scan.py _compare_fold_wins, the sweep's
// table), shared_scan_tiles launches the fold on the key tensor instead.
#include "common.cuh"

namespace sss {

// Threads (blocks of a tile) and ring stages of the compare kernel
// (bench/redesign_sweep.py compare).
constexpr int kCompareThreads = 256;
constexpr int kCompareStages = 2;

// Row of one key over the block's 32 normalized values.
__device__ __forceinline__ uint32_t compare_row(const uint32_t (&v)[kBlockValues], uint32_t key) {
  uint32_t acc = 0u;
#pragma unroll
  for (int r = 0; r < kBlockValues; ++r) acc |= (uint32_t)(v[r] == key) << r;
  return acc;
}

template <int W, int T, int kStages>
__global__ void __launch_bounds__(T)
shared_scan_kernel(const __grid_constant__ CUtensorMap map, const uint32_t* __restrict__ keys,
                   int k, uint32_t* __restrict__ bits, unsigned long long* __restrict__ counts,
                   long long nblocks, long long n, long long block_offset, long long run) {
  extern __shared__ __align__(128) uint32_t s_ring[];
  __shared__ __align__(8) uint64_t s_full[kStages];
  __shared__ unsigned s_cnt[kMaxKeys];
  __shared__ uint32_t s_key[kMaxKeys];
  for (int j = threadIdx.x; j < k; j += blockDim.x) s_key[j] = __ldg(keys + j);
  zero_counts(s_cnt, k);  // (its barrier also publishes the keys)
  staged_tiles<W, T, kStages>(
      &map, nblocks, run, s_ring, s_full,
      [&](const uint32_t (&w)[W], long long b, bool active) {
        const uint32_t valid = active ? valid_word(block_offset + b, n) : 0u;
        uint32_t v[kBlockValues];
        unpack_values<W>(w, v);
#pragma unroll 1
        for (int j = 0; j < k; ++j)
          store_row(bits, nblocks, b, active, j, compare_row(v, s_key[j]) & valid, s_cnt);
      });
  flush_counts(s_cnt, k, counts);
}

// One launch of the compare kernel (k <= kMaxKeys): a CTA for every `run`
// tiles (0: the resident grid).
template <int W, int T, int kStages>
cudaError_t launch_compare(const uint32_t* tiles, const uint32_t* keys, int k, uint32_t* bits,
                           unsigned long long* counts, long long nblocks, long long n,
                           long long block_offset, long long run, cudaStream_t stream) {
  const auto kernel = shared_scan_kernel<W, T, kStages>;
  const size_t smem = tile_ring_bytes(W, T, kStages);
  CUtensorMap map;
  unsigned grid = 0;
  cudaError_t err = tile_map(&map, tiles, W, nblocks, T);
  if (err == cudaSuccess) err = staged_grid(kernel, T, smem, nblocks, run, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, T, smem, stream>>>(map, keys, k, bits, counts, nblocks, n, block_offset, run);
  return cudaGetLastError();
}

}  // namespace sss

// Keys are launched in chunks of kMaxKeys (the shared counters' size); each
// chunk writes its own rows of bits and counts.
extern "C" int sss_shared_scan(const uint32_t* tiles, const uint32_t* keys, int k, uint32_t* bits,
                               unsigned long long* counts, long long nblocks, int width,
                               long long n, long long block_offset, cudaStream_t stream) {
  if (!sss::width_ok(width)) return (int)cudaErrorInvalidValue;
  if (nblocks <= 0 || k <= 0) return (int)cudaSuccess;
  for (int j0 = 0; j0 < k; j0 += sss::kMaxKeys) {
    const int kc = k - j0 < sss::kMaxKeys ? k - j0 : sss::kMaxKeys;
    uint32_t* bits_c = bits + (size_t)j0 * nblocks;
    cudaError_t err = cudaErrorInvalidValue;
    switch (width) {
#define SSS_CASE(W)                                                                         \
  case W:                                                                                   \
    err = sss::launch_compare<W, sss::kCompareThreads, sss::kCompareStages>(                \
        tiles, keys + j0, kc, bits_c, counts + j0, nblocks, n, block_offset,                \
        sss::staged_run(W, kc, sss::kCompareThreads), stream);                              \
    break;
      SSS_FOR_EACH_WIDTH(SSS_CASE)
#undef SSS_CASE
    }
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// The chunked scan and the dynamic scan take the 32 normalized values of
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

// Set bit r of row idx[r] - g0 of this thread's column of rows (a row every
// T words) for each of its block's 32 values whose index lies in [g0, g0 +
// G); an index outside (kNoKey, another group's) sets nothing.  kClear
// zeroes those rows instead, so a column is clean again once its rows are
// stored, at a store per value rather than one per row.
template <int T, int G, bool kClear = false>
__device__ __forceinline__ void mark_rows(uint32_t* col, const uint32_t (&idx)[kBlockValues],
                                          uint32_t g0) {
#pragma unroll
  for (int r = 0; r < kBlockValues; ++r) {
    const uint32_t slot = idx[r] - g0;
    if (slot < (uint32_t)G) {
      if (kClear) col[slot * T] = 0u;
      else col[slot * T] |= 1u << r;
    }
  }
}

// Set bit r of row lookup(v[r]) in this thread's column of rows, for the 32
// values of its block.  All 32 lookups are issued before the first update:
// the table loads are independent, while an update may alias an earlier one.
template <int C, int T, bool kDirect>
__device__ __forceinline__ void chunk_mark_rows(const ChunkSmem<C, T>& s, uint32_t* col,
                                                uint32_t (&v)[kBlockValues]) {
#pragma unroll
  for (int r = 0; r < kBlockValues; ++r) v[r] = chunk_lookup<C, T, kDirect>(s, v[r]);
  mark_rows<T, C>(col, v, 0u);
}

// Store rows j0..j1-1 of one block, in order from out (row j0's word of
// the block, a row every nblocks words): word_of(j) gives row j's word
// before the validity word; inactive lanes store nothing.  The rows go 32 at a time: lane l keeps
// the warp's count of row g + l (one __reduce_add_sync a row), and the 32
// counts reach the CTA's counters cnt[j] in one atomic a lane -- not one a
// row, whose branch and aggregation code cost more than the row itself.
// The address steps by nblocks a row: an offset j * nblocks a row would be
// hoisted out of the tile loop as 32 64-bit constants and cost occupancy.
// kStore and kCount (both on in the kernels) let the sweep time the parts.
template <bool kStore = true, bool kCount = true, typename WordOf>
__device__ __forceinline__ void store_rows(WordOf word_of, unsigned* cnt, int j0, int j1,
                                           uint32_t* out, long long nblocks, bool active,
                                           uint32_t valid) {
  const int lane = threadIdx.x & 31;
  for (int g = j0; g < j1; g += 32) {
    unsigned mine = 0u;
#pragma unroll
    for (int l = 0; l < 32; ++l) {
      if (g + l < j1) {  // uniform across the CTA
        const uint32_t word = word_of(g + l) & valid;
        if (kStore && active) *out = word;
        out += nblocks;
        if (kCount) {
          const unsigned c = __reduce_add_sync(0xFFFFFFFFu, (unsigned)__popc(word));
          if (lane == l) mine = c;
        }
      }
    }
    if (kCount && g + lane < j1 && mine) atomicAdd(cnt + g + lane, mine);
  }
}

// Store rows 0..kc-1 of block b: row j is col[rep[j]] & valid.
template <int C, int T, bool kStore = true, bool kCount = true>
__device__ __forceinline__ void chunk_store_rows(const ChunkSmem<C, T>& s, const uint32_t* col,
                                                 uint32_t* out, long long nblocks, bool active,
                                                 int kc, uint32_t valid) {
  store_rows<kStore, kCount>([&](int j) { return col[s.rep[j] * T]; }, s.cnt, 0, kc, out,
                             nblocks, active, valid);
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

// Dynamic scan.  Replaces shared_simd_scan_tpu/ops/scan.py:
// _shared_scan_dynamic_kernel / shared_scan_dynamic_tiles: any k, keys read
// from device memory at run time.  On the TPU the values of a tile are
// unpacked once into a scratch, then a runtime loop compares every key
// with them.
//
// Bound on the H100: device memory bytes (W words read, k words written per
// 32 values); the k row stores are the bytes.  A compare of every key with
// every value is O(k) integer work per value: the compare form of this
// kernel (values in shared memory, read back for every key) ran at 4.5x
// its bound.  The chunked scan above looks a value up once per chunk of 64
// keys, so at k = 256 it reads each tile and redoes its 32 lookups four
// times.  Here a value is looked up once per launch (kMaxKeys keys), and
// only the row stores, the bytes that bound the kernel, are O(k) a block.
// Measured, the lookups hide under the row stores: taken out, the kernel
// is no faster, and the stores run at about 0.7 of the bytes' bound, as
// the chunked scan's do (bench/redesign_sweep.py).
//
// Once per CTA (dynamic_setup): rep[j] is the first index of the launch
// holding key j, kNoRow for a key past the domain; the lookup maps a value
// to the first index holding it, or kNoRow -- a uint16 table of 2^W
// entries for W <= kDirectBits (filled by atomicMin of the indices: O(k +
// 2^W)), else the distinct keys sorted, with their first indices, for a
// branch-free binary search (ranked by comparing every pair of keys: O(k^2)
// a CTA, small beside a pass over the column).  Per tile, each thread
// unpacks its block once and looks its 32 values up once, keeping the
// indices in registers, and stores the rows a group of G at a time through
// its column of rows[G + 1][T] in shared memory (store_groups, below; the
// groups' lists of later duplicates are built in the setup).  A
// duplicate's count is its first occurrence's, added to its total at the
// flush.
constexpr int kDynGroup = 64;     // G: rows per group
constexpr int kDynThreads = 256;  // T
constexpr uint32_t kNoRow = 0xFFFFu;  // a lookup of a value no key holds; rep past the domain

// Words of the groups' list offsets: kMaxKeys / G + 1, in whole 16 bytes.
template <int G>
__host__ __device__ constexpr int dyn_group_words() {
  return (kMaxKeys / G + 1 + 3) & ~3;
}

// A dynamic CTA's dynamic shared memory: rows [G + 1][T] (the setup's
// scratch until it ends; row G stays zero); cnt [kMaxKeys], the counts by row; dstart, the offsets of
// each group's list in dlist; rep [kMaxKeys] and dlist [kMaxKeys] (uint16);
// then the lookup -- the table [2^W] (uint16) for W <= kDirectBits, else
// the sorted distinct keys [kMaxKeys] and their first indices [kMaxKeys]
// (uint16).
template <int G, int T>
struct DynSmem {
  uint32_t* rows;
  unsigned* cnt;
  int* dstart;
  uint16_t* rep;
  uint16_t* dlist;
  uint16_t* table;
  uint32_t* sorted;
  uint16_t* sidx;
  __device__ explicit DynSmem(uint32_t* base)
      : rows(base), cnt(base + (G + 1) * T), dstart(reinterpret_cast<int*>(cnt + kMaxKeys)),
        rep(reinterpret_cast<uint16_t*>(dstart + dyn_group_words<G>())), dlist(rep + kMaxKeys),
        table(dlist + kMaxKeys), sorted(reinterpret_cast<uint32_t*>(table)),
        sidx(reinterpret_cast<uint16_t*>(sorted + kMaxKeys)) {}
};

template <int G, int T>
inline size_t dynamic_smem(int width) {
  const size_t lookup =
      width <= kDirectBits ? (((size_t)2 << width) + 15) / 16 * 16 : (size_t)kMaxKeys * 6;
  return ((size_t)(G + 1) * T + kMaxKeys + dyn_group_words<G>()) * 4 + (size_t)kMaxKeys * 4 +
         lookup;
}

// Once per CTA: rep, the lookup and the groups' lists of later duplicates
// for the launch's kc keys; rows and cnt zeroed.  Returns the size of the
// search (a power of two >= kc).
template <int G, int T, bool kDirect>
__device__ __forceinline__ int dynamic_setup(const DynSmem<G, T>& s,
                                             const uint32_t* __restrict__ keys, int kc,
                                             uint32_t vmask) {
  static_assert(G * T >= 4096 && G % 32 == 0, "rows: the table's scratch (2^kDirectBits words)");
  int span = 1;
  while (span < kc) span <<= 1;
  if (kDirect) {
    uint32_t* first = s.rows;  // per value: the first index holding it
    for (uint32_t v = threadIdx.x; v <= vmask; v += T) first[v] = 0xFFFFFFFFu;
    __syncthreads();
    for (int j = threadIdx.x; j < kc; j += T) {
      const uint32_t key = __ldg(keys + j);
      if (key <= vmask) atomicMin(first + key, (uint32_t)j);
    }
    __syncthreads();
    for (uint32_t v = threadIdx.x; v <= vmask; v += T)
      s.table[v] = (uint16_t)(first[v] < kNoRow ? first[v] : kNoRow);
    for (int j = threadIdx.x; j < kc; j += T) {
      const uint32_t key = __ldg(keys + j);
      s.rep[j] = (uint16_t)(key <= vmask ? first[key] : kNoRow);
    }
  } else {
    uint32_t* key = s.rows;  // the keys, staged
    for (int j = threadIdx.x; j < span; j += T) {
      if (j < kc) key[j] = __ldg(keys + j);
      s.sorted[j] = 0xFFFFFFFFu;  // above every value: pads the search
    }
    __syncthreads();
    for (int j = threadIdx.x; j < kc; j += T) {
      const uint32_t x = key[j];
      uint32_t r = kNoRow;
      if (x <= vmask) {
        r = (uint32_t)j;
        for (int i = 0; i < j; ++i)
          if (key[i] == x) {
            r = (uint32_t)i;
            break;
          }
      }
      s.rep[j] = (uint16_t)r;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < kc; j += T) {
      if (s.rep[j] != j) continue;  // a duplicate, or past the domain
      int rank = 0;                 // distinct keys of the domain below this one
      for (int i = 0; i < kc; ++i) rank += s.rep[i] == i && key[i] < key[j];
      s.sorted[rank] = key[j];
      s.sidx[rank] = (uint16_t)j;
    }
  }
  // The lists of later duplicates, by the group of their first occurrence;
  // cnt counts and then places them before it is zeroed.
  const int ngroups = (kc + G - 1) / G;
  __syncthreads();
  for (int g = threadIdx.x; g < ngroups; g += T) s.cnt[g] = 0u;
  __syncthreads();
  for (int j = threadIdx.x; j < kc; j += T) {
    const uint32_t r = s.rep[j];
    if (r != kNoRow && r / G != (uint32_t)j / G) atomicAdd(s.cnt + r / G, 1u);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int at = 0;
    for (int g = 0; g < ngroups; ++g) {
      s.dstart[g] = at;
      at += (int)s.cnt[g];
      s.cnt[g] = (unsigned)s.dstart[g];
    }
    s.dstart[ngroups] = at;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < kc; j += T) {
    const uint32_t r = s.rep[j];
    if (r != kNoRow && r / G != (uint32_t)j / G) s.dlist[atomicAdd(s.cnt + r / G, 1u)] = j;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < (G + 1) * T; i += T) s.rows[i] = 0u;
  for (int j = threadIdx.x; j < kc; j += T) s.cnt[j] = 0u;
  __syncthreads();
  return span;
}

// Rows 0..kc-1 of block b from idx[r], the first row holding each of its 32
// values (kNoRow: none), a group of G rows g0..g0+G-1 at a time, last group
// first: set bit r of row idx[r] - g0 in this thread's column of rows
// (mark_rows), store the group's rows in order as the chunked scan does (row
// j is col[min(rep[j] - g0, zr)], row zr being zero: a key past the domain,
// or a duplicate whose first occurrence lies in an earlier group, stores
// zeros, branch-free), store the later rows whose first occurrence lies in
// this group over those zeros (dlist[dstart[g] .. dstart[g + 1])), and clear
// the bits it set.  A row's count goes to cnt of its own index.
template <int G, int T, bool kStore = true>
__device__ __forceinline__ void store_groups(uint32_t* col, const uint32_t (&idx)[kBlockValues],
                                             uint32_t zr, const uint16_t* rep, const int* dstart,
                                             const uint16_t* dlist, unsigned* cnt, int kc,
                                             uint32_t* bits, long long nblocks, long long b,
                                             bool active, uint32_t valid) {
  for (int g0 = (kc - 1) / G * G; g0 >= 0; g0 -= G) {
    mark_rows<T, G>(col, idx, (uint32_t)g0);
    store_rows<kStore>(
        [&](int j) {
          const uint32_t slot = rep[j] - (uint32_t)g0;
          return col[(slot < zr ? slot : zr) * T];
        },
        cnt, g0, g0 + G < kc ? g0 + G : kc, bits + (size_t)g0 * nblocks + b, nblocks, active,
        valid);
    const int gi = g0 / G;
    for (int i = dstart[gi]; i < dstart[gi + 1]; ++i) {
      const int j = dlist[i];
      if (kStore && active) bits[(size_t)j * nblocks + b] = col[(rep[j] - g0) * T] & valid;
    }
    mark_rows<T, G, true>(col, idx, (uint32_t)g0);
  }
}

// The first index of the launch holding v, or kNoRow.
template <int G, int T, bool kDirect>
__device__ __forceinline__ uint32_t dynamic_lookup(const DynSmem<G, T>& s, uint32_t v, int span) {
  if (kDirect) return s.table[v];
  int pos = 0;
#pragma unroll
  for (int half = kMaxKeys / 2; half > 0; half >>= 1)
    if (half < span && s.sorted[pos + half - 1] < v) pos += half;
  return s.sorted[pos] == v ? (uint32_t)s.sidx[pos] : kNoRow;
}

// kLookup and kStore (both on in the library) let the sweep time the parts.
// At most 80 registers a thread (768 threads an SM): uncapped, the table
// lookup took 86 and left two CTAs of 256 threads an SM, not three.
template <int G, int T, bool kDirect, bool kLookup = true, bool kStore = true>
__global__ void __launch_bounds__(T, 768 / T)
shared_scan_dynamic_kernel(const uint32_t* __restrict__ tiles, const uint32_t* __restrict__ keys,
                           int kc, uint32_t* __restrict__ bits,
                           unsigned long long* __restrict__ counts, long long nblocks, int width,
                           long long n, long long block_offset, long long ntiles) {
  extern __shared__ __align__(16) uint32_t s_mem[];
  const DynSmem<G, T> s(s_mem);
  const int span = dynamic_setup<G, T, kDirect>(s, keys, kc, (1u << width) - 1u);
  uint32_t* col = s.rows + threadIdx.x;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long b = tile * T + threadIdx.x;
    const bool active = b < nblocks;
    uint32_t v[kBlockValues];
    unpack_block_any(width, tiles, nblocks, b, active, v);
    if (kLookup) {
#pragma unroll
      for (int r = 0; r < kBlockValues; ++r) v[r] = dynamic_lookup<G, T, kDirect>(s, v[r], span);
    }
    const uint32_t valid = active ? valid_word(block_offset + b, n) : 0u;
    store_groups<G, T, kStore>(col, v, (uint32_t)G, s.rep, s.dstart, s.dlist, s.cnt, kc, bits,
                               nblocks, b, active, valid);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < kc; j += T) {
    const uint32_t r = s.rep[j];
    if (r != kNoRow && s.cnt[r]) atomicAdd(counts + j, (unsigned long long)s.cnt[r]);
  }
}

// Launches of kMaxKeys keys (each with its own rep), each on the resident
// grid at the CTA's shared memory (whose limit is raised first: the rows
// pass the 48 KB default).  `direct` and `search` are the two lookups.
template <int G, int T, typename Kernel>
cudaError_t dynamic_launch_with(Kernel direct, Kernel search, const uint32_t* tiles,
                                const uint32_t* keys, int k, uint32_t* bits,
                                unsigned long long* counts, long long nblocks, int width,
                                long long n, long long block_offset, cudaStream_t stream) {
  if (!width_ok(width)) return cudaErrorInvalidValue;
  if (nblocks <= 0 || k <= 0) return cudaSuccess;
  const long long ntiles = (nblocks + T - 1) / T;
  const size_t smem = dynamic_smem<G, T>(width);
  const Kernel kernel = width <= kDirectBits ? direct : search;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  unsigned grid = 0;
  err = resident_grid(kernel, T, smem, ntiles, &grid);
  if (err != cudaSuccess) return err;
  for (int j0 = 0; j0 < k; j0 += kMaxKeys) {
    const int kc = k - j0 < kMaxKeys ? k - j0 : kMaxKeys;
    kernel<<<grid, T, smem, stream>>>(tiles, keys + j0, kc, bits + (size_t)j0 * nblocks,
                                      counts + j0, nblocks, width, n, block_offset, ntiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int G, int T>
cudaError_t dynamic_launch(const uint32_t* tiles, const uint32_t* keys, int k, uint32_t* bits,
                           unsigned long long* counts, long long nblocks, int width, long long n,
                           long long block_offset, cudaStream_t stream) {
  return dynamic_launch_with<G, T>(shared_scan_dynamic_kernel<G, T, true>,
                                   shared_scan_dynamic_kernel<G, T, false>, tiles, keys, k, bits,
                                   counts, nblocks, width, n, block_offset, stream);
}

// Windowed scan.  Replaces shared_simd_scan_tpu/ops/scan.py:
// _windowed_scan_kernel / _windowed_scan_tiles_impl (k <= 48, one window
// plan) and _windowed_chunked_kernel / _windowed_chunked_tiles_impl (k > 48,
// 32-row chunks that each re-mask their own windows).  On the TPU a value
// costs a one-hot per 32-aligned window of the keys, and every populated
// 8-key sub-window an 8x8 transpose: work that grows with the windows, and
// with k past 48, where each chunk of 32 rows re-masks its own.
//
// Bound on the H100: device memory bytes (W words read, k words written per
// 32 values), as the dynamic scan, for many keys; the instructions a value
// for a few (ops/scan.py WINDOW_LOOKUP_KEYS sends those to the static
// fold).  Here a value costs one window lookup, whatever the windows, and
// the rows are the dynamic scan's (store_groups): the same first-row index
// per value, any k in passes of kDynGroup rows over each tile.  The host
// knows the keys and builds, per launch of at most kMaxKeys rows (ops/scan.py
// _window_tables), the sorted distinct windows v >> 5 of its keys below
// 2^W, per window a 32-bit mask of its keys and the index of its first key
// in a window-ordered list, that list (each distinct key's first row), rep
// and the groups' lists of later duplicates.  Each CTA stages them in shared
// memory.  A value's window slot comes from a direct table of the 2^(W-5)
// windows up to kWinDirectBits (4096 entries), else from a binary search of
// the sorted windows, log2 of the launch's windows steps (0 for one window):
// a trip count fixed for the launch, so no divergence.  With o = v & 31, the
// value hits where bit o of the window's mask is set, and its row is
// list[first + popc(mask & ((1 << o) - 1))].  A slot past the windows
// (nwin) holds the mask 0.
constexpr int kWinDirectBits = 17;

__host__ __device__ constexpr uint32_t win_table_size(int width) {
  return width > 5 ? 1u << (width - 5) : 1u;
}

// Byte offsets of a windowed CTA's dynamic shared memory: rows [zr + 1][T]
// (zr = min(kc, G) rows, then a zero row), the window slots' (mask, first)
// [nwin + 1], the sorted windows [span] (search only), cnt [kc], dstart
// [groups + 1], then rep [kc], dlist [ndup], list [nd] and the direct table
// (uint16).
struct WinLayout {
  int zr, span, ngroups;
  size_t wm, win, cnt, dstart, rep, dlist, list, table, bytes;
  __host__ __device__ WinLayout(int width, int kc, int nwin, int nd, int ndup) {
    zr = kc < kDynGroup ? kc : kDynGroup;
    span = 1;
    while (span < nwin) span <<= 1;
    ngroups = (kc + kDynGroup - 1) / kDynGroup;
    const bool direct = width <= kWinDirectBits;
    size_t at = (size_t)(zr + 1) * kDynThreads * 4;
    wm = at;
    at += (size_t)(nwin + 1) * 8;
    win = at;
    at += direct ? 0 : (size_t)span * 4;
    cnt = at;
    at += (size_t)kc * 4;
    dstart = at;
    at += (size_t)(ngroups + 1) * 4;
    rep = at;
    at += (size_t)kc * 2;
    dlist = at;
    at += (size_t)ndup * 2;
    list = at;
    at += (size_t)nd * 2;
    table = at;
    at += direct ? (size_t)win_table_size(width) * 2 : 0;
    bytes = (at + 15) / 16 * 16;
  }
};

// The first row holding each of the 32 values (kNoRow: none), eight values
// at a time: their window slots (the table, or the search's steps, each
// step for the eight at once), then each slot's mask and first index.
template <bool kDirect>
__device__ __forceinline__ void window_lookup(const uint2* wm, const uint32_t* win,
                                              const uint16_t* table, const uint16_t* list,
                                              uint32_t nwin, int span,
                                              uint32_t (&v)[kBlockValues]) {
#pragma unroll
  for (int q = 0; q < kBlockValues; q += 8) {
    uint32_t slot[8];
    if (kDirect) {
#pragma unroll
      for (int r = 0; r < 8; ++r) slot[r] = table[v[q + r] >> 5];
    } else {
#pragma unroll
      for (int r = 0; r < 8; ++r) slot[r] = 0u;
      for (int half = span >> 1; half > 0; half >>= 1) {
#pragma unroll
        for (int r = 0; r < 8; ++r)
          if (win[slot[r] + half - 1] < (v[q + r] >> 5)) slot[r] += half;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) slot[r] = win[slot[r]] == (v[q + r] >> 5) ? slot[r] : nwin;
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const uint2 m = wm[slot[r]];
      const uint32_t o = v[q + r] & 31u;
      v[q + r] = (m.x >> o) & 1u ? (uint32_t)list[m.y + __popc(m.x & ((1u << o) - 1u))] : kNoRow;
    }
  }
}

// The plan (int32, device memory): windows [nwin], masks [nwin], first
// [nwin], list [nd], rep [kc], dstart [groups + 1], dlist [ndup].  At most
// 80 registers a thread (3 CTAs an SM), as the dynamic scan.
template <bool kDirect>
__global__ void __launch_bounds__(kDynThreads, 768 / kDynThreads)
windowed_lookup_kernel(const uint32_t* __restrict__ tiles, const int* __restrict__ plan, int kc,
                       int nwin, int nd, int ndup, uint32_t* __restrict__ bits,
                       unsigned long long* __restrict__ counts, long long nblocks, int width,
                       long long n, long long block_offset, long long ntiles) {
  constexpr int G = kDynGroup, T = kDynThreads;
  extern __shared__ __align__(16) uint8_t s_wplan[];
  const WinLayout L(width, kc, nwin, nd, ndup);
  uint32_t* rows = reinterpret_cast<uint32_t*>(s_wplan);
  uint2* wm = reinterpret_cast<uint2*>(s_wplan + L.wm);
  uint32_t* win = reinterpret_cast<uint32_t*>(s_wplan + L.win);
  unsigned* cnt = reinterpret_cast<unsigned*>(s_wplan + L.cnt);
  int* dstart = reinterpret_cast<int*>(s_wplan + L.dstart);
  uint16_t* rep = reinterpret_cast<uint16_t*>(s_wplan + L.rep);
  uint16_t* dlist = reinterpret_cast<uint16_t*>(s_wplan + L.dlist);
  uint16_t* list = reinterpret_cast<uint16_t*>(s_wplan + L.list);
  uint16_t* table = reinterpret_cast<uint16_t*>(s_wplan + L.table);
  const int* p_win = plan;
  const int* p_mask = p_win + nwin;
  const int* p_first = p_mask + nwin;
  const int* p_list = p_first + nwin;
  const int* p_rep = p_list + nd;
  const int* p_dstart = p_rep + kc;
  const int* p_dlist = p_dstart + L.ngroups + 1;
  for (int i = threadIdx.x; i <= nwin; i += T)
    wm[i] = i < nwin ? make_uint2((uint32_t)__ldg(p_mask + i), (uint32_t)__ldg(p_first + i))
                     : make_uint2(0u, 0u);
  if (kDirect) {
    for (uint32_t i = threadIdx.x; i < win_table_size(width); i += T) table[i] = (uint16_t)nwin;
  } else {
    for (int i = threadIdx.x; i < L.span; i += T)
      win[i] = i < nwin ? (uint32_t)__ldg(p_win + i) : 0xFFFFFFFFu;  // pads the search
  }
  for (int j = threadIdx.x; j < kc; j += T) {
    cnt[j] = 0u;
    rep[j] = (uint16_t)__ldg(p_rep + j);
  }
  for (int i = threadIdx.x; i <= L.ngroups; i += T) dstart[i] = __ldg(p_dstart + i);
  for (int i = threadIdx.x; i < ndup; i += T) dlist[i] = (uint16_t)__ldg(p_dlist + i);
  for (int i = threadIdx.x; i < nd; i += T) list[i] = (uint16_t)__ldg(p_list + i);
  for (int i = threadIdx.x; i < (L.zr + 1) * T; i += T) rows[i] = 0u;
  __syncthreads();
  if (kDirect) {
    for (int i = threadIdx.x; i < nwin; i += T) table[__ldg(p_win + i)] = (uint16_t)i;
    __syncthreads();
  }
  uint32_t* col = rows + threadIdx.x;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long b = tile * T + threadIdx.x;
    const bool active = b < nblocks;
    uint32_t v[kBlockValues];
    unpack_block_any(width, tiles, nblocks, b, active, v);
    window_lookup<kDirect>(wm, win, table, list, (uint32_t)nwin, L.span, v);
    const uint32_t valid = active ? valid_word(block_offset + b, n) : 0u;
    store_groups<G, T>(col, v, (uint32_t)L.zr, rep, dstart, dlist, cnt, kc, bits, nblocks, b,
                       active, valid);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < kc; j += T) {
    const uint32_t r = rep[j];
    if (r != kNoRow && cnt[r]) atomicAdd(counts + j, (unsigned long long)cnt[r]);
  }
}

inline bool window_plan_ok(int width, int k, int nwin, int nd, int ndup) {
  return width_ok(width) && k >= 1 && k <= kMaxKeys && nwin >= 0 && nd >= nwin && nd <= k &&
         ndup >= 0 && ndup <= k;
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

// Keys are launched in chunks of kMaxKeys (the size of rep and the
// counters); each chunk writes its own rows of bits and counts.
extern "C" int sss_shared_scan_dynamic(const uint32_t* tiles, const uint32_t* keys, int k,
                                       uint32_t* bits, unsigned long long* counts,
                                       long long nblocks, int width, long long n,
                                       long long block_offset, cudaStream_t stream) {
  return (int)sss::dynamic_launch<sss::kDynGroup, sss::kDynThreads>(
      tiles, keys, k, bits, counts, nblocks, width, n, block_offset, stream);
}

// Dynamic shared memory of one CTA of the dynamic scan at this width.
extern "C" long long sss_shared_scan_dynamic_smem(int width) {
  return (long long)sss::dynamic_smem<sss::kDynGroup, sss::kDynThreads>(width);
}

// The windowed scan of one launch's k <= kMaxKeys rows: plan is the host's
// tables (int32, device memory; layout at windowed_lookup_kernel), nwin
// windows, nd distinct keys below 2^width, ndup later duplicates in other
// groups; bits (k, nblocks) and counts int64[k] (zeroed by the caller).
extern "C" int sss_windowed_lookup(const uint32_t* tiles, const int* plan, int k, int nwin, int nd,
                                   int ndup, uint32_t* bits, unsigned long long* counts,
                                   long long nblocks, int width, long long n,
                                   long long block_offset, cudaStream_t stream) {
  if (!sss::window_plan_ok(width, k, nwin, nd, ndup)) return (int)cudaErrorInvalidValue;
  if (nblocks <= 0) return (int)cudaSuccess;
  constexpr int T = sss::kDynThreads;
  const long long ntiles = (nblocks + T - 1) / T;
  const sss::WinLayout layout(width, k, nwin, nd, ndup);
  const auto kernel = width <= sss::kWinDirectBits ? sss::windowed_lookup_kernel<true>
                                                   : sss::windowed_lookup_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)layout.bytes);
  unsigned grid = 0;
  if (err == cudaSuccess) err = sss::resident_grid(kernel, T, layout.bytes, ntiles, &grid);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, T, layout.bytes, stream>>>(tiles, plan, k, nwin, nd, ndup, bits, counts, nblocks,
                                            width, n, block_offset, ntiles);
  return (int)cudaGetLastError();
}

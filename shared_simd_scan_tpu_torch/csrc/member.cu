// IN-list (membership) scans: one bitvector row for a whole key set.
//
// Replaces the bodies of shared_simd_scan_tpu/ops/member.py _member_call:
//  - sss_member_compare: _member_compare_kernel and
//    _member_chunked_compare_kernel, and sss_member_window:
//    _member_window_kernel and _member_chunked_window_kernel.  The TPU
//    compares each value with every key, or shifts a one-hot by v - base
//    for every window: Mosaic has no gather.  Here the operand in device
//    memory becomes a table on the card first -- the host never reads it;
//    every size comes from its shape -- and each value takes one lookup in
//    it, for any k or window count.  Rows: a key gives (key & ~31,
//    1 << (key & 31)); a window (base, popmask) gives popmask << (base & 31)
//    at base & ~31 and, unaligned, popmask >> (32 - (base & 31)) at the
//    next word (wrapping past 2^32 as the TPU's v - base does).  Rows at or
//    past 2^W and empty rows are dropped (the 0xFFFFFFFF key padding, the
//    zero-popmask window padding).  The table is member_set_table's layout:
//    at widths 1..16 the 2^W-bit bitmap, built by atomicOr -- in each
//    resident CTA's shared memory in the scan's own launch (fused; the
//    caller picks it up to ops/member.py MEMBER_FUSED_ROWS rows, where
//    bench/redesign_sweep.py member timed it ahead) or by one CTA into
//    device memory before it; past 16 the rows' bases sorted
//    ascending, padded with 0xFFFFFFFF to P (the least power of two at or
//    above the row count), each run of equal bases holding its OR of
//    popmasks in its last entry (where the search lands) and 0 in the
//    others.  Up to kSortChunk rows one CTA sorts them in shared memory
//    (bitonic); past it each CTA sorts a chunk and log2(P / kSortChunk)
//    merge passes (each element's rank in its partner run by binary
//    search) finish the order, then each row ORs its popmask into the last
//    entry of its run;
//  - sss_member_domain: _member_domain_kernel.  The key set as a 2^W-bit
//    table: each CTA builds it in shared memory from the keys with
//    atomicOr (keys >= 32 * nwords are dropped, duplicates merge), so
//    runtime keys never reach the host; then bit v & 31 of word v >> 5.
//    The TPU selects the word with a select tree because Mosaic has no
//    gather; a shared-memory load is the gather here.  Widths 1..16 (a
//    table of at most 8 KB);
//  - sss_member_lookup: _member_ortree_kernel.  The TPU evaluates a host
//    key set as its Shannon-factored OR-tree over bit planes (no gather in
//    Mosaic); here one lookup a value in a table the host builds from the
//    set (ops/member.py member_set_table): at widths 1..16 the 2^W-bit
//    bitmap, bit v & 31 of word v >> 5; past 16 the set's sorted 32-aligned
//    window bases (padded with 0xFFFFFFFF to a power of two P) and their
//    popmasks, a branch-free binary search of v & ~31 in log2(P) steps,
//    then bit v & 31 of the popmask found.  Each CTA copies the table into
//    shared memory once (the bitmap, or up to kLookupSharedWindows
//    windows); a larger search table is read through the read-only cache.
// The bit-sliced body (_member_bitsliced_kernel: a plane fold a key, its
// key rows ORed into one row) computes the compare body's row from the
// same key tensor, so on this card it is sss_member_compare too: its
// 0xFFFFFFFF chunk padding lies past 2^W and is dropped from the table.
//
// Bound on the H100: device memory bytes (reads W words, writes one word
// per 32 values): the lookup is ~6 integer ops a value flat in k, where
// the TPU's bodies took ~2 a value a key (compare) and ~4 a value a
// window; the search adds a shared-memory load and a select a step, and
// those loads bound it past a few steps.  Design: one thread per 32-value
// block, the 32 values unpacked into registers once; the lookup's
// resident CTAs loop over tiles, so each copies or builds its table and
// flushes its count once.  The count is the popcount of the final row, so
// duplicate keys count once; counts as in shared_scan.cu, with one row.
#include "common.cuh"

// Widths 1..16 for the domain table.
#define SSS_FOR_EACH_DOMAIN_WIDTH(CASE)                                                \
  CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8) CASE(9) CASE(10)     \
  CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)

namespace sss {

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

// Where the lookup's table lies: the bitmap in shared memory; the search
// table in shared memory, or in device memory past kLookupSharedWindows;
// or the bitmap each CTA builds in shared memory from the operand's rows.
constexpr int kLookupBitmap = 0, kLookupShared = 1, kLookupGlobal = 2, kLookupBuild = 3;
// Windows a CTA's shared search table holds (bases and popmasks, 32 KB).
constexpr int kLookupSharedWindows = 4096;
// Threads of the table builds; rows one CTA sorts in shared memory (32 KB
// of composite keys).
constexpr int kBuildThreads = 1024;
constexpr int kSortChunk = 4096;
constexpr int kMaxBitmapWidth = 16;
constexpr unsigned long long kNoRow = 0xFFFFFFFF00000000ull;  // base 0xFFFFFFFF, popmask 0

// The rows of an operand: row i is (32-aligned word base, its bits).
struct KeyRows {  // int32[k]: one row a key
  const uint32_t* keys;
  __device__ __forceinline__ uint2 row(int i) const {
    const uint32_t key = __ldg(keys + i);
    return make_uint2(key & ~31u, 1u << (key & 31u));
  }
};
struct WindowRows {  // int32[nwin, 2] (base, popmask): two rows a window
  const uint2* win;
  __device__ __forceinline__ uint2 row(int i) const {
    const uint2 w = __ldg(win + (i >> 1));
    const uint32_t s = w.x & 31u, base = w.x & ~31u;
    if (!(i & 1)) return make_uint2(base, w.y << s);
    return make_uint2(base + 32u, s ? w.y >> (32u - s) : 0u);  // wraps past 2^32 to word 0
  }
};
struct NoRows {  // the lookups of a table built elsewhere
  __device__ __forceinline__ uint2 row(int) const { return make_uint2(0u, 0u); }
};

// Row r restricted to the values below 2^width (width <= 31): none at or
// past it (the key padding 0xFFFFFFFF among them); below width 5 the low
// 2^width bits of word 0.
__device__ __forceinline__ uint2 in_domain(uint2 r, int width) {
  if (r.x >= (1u << width)) r.y = 0u;
  else if (width < 5) r.y &= (1u << (1u << width)) - 1u;
  return r;
}

// The block's bitmap of the rows in s_tab[0..words); the caller's barrier
// publishes it.
template <class Rows>
__device__ __forceinline__ void build_bitmap(uint32_t* s_tab, int words, const Rows& rows,
                                             int nrows, int width) {
  for (int i = threadIdx.x; i < words; i += blockDim.x) s_tab[i] = 0u;
  __syncthreads();
  for (int i = threadIdx.x; i < nrows; i += blockDim.x) {
    const uint2 r = in_domain(rows.row(i), width);
    if (r.y) atomicOr(s_tab + (r.x >> 5), r.y);
  }
}

// Bits of values v[0..7] in the search table (bases tab[0..P), popmasks
// tab[P..2P), P a power of two): eight searches side by side, each
// log2(P) steps of one load and a select.
__device__ __forceinline__ uint32_t search8(const uint32_t* tab, int P, const uint32_t (&v)[8]) {
  uint32_t pos[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int step = P >> 1; step > 0; step >>= 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) pos[i] += tab[pos[i] + step] <= (v[i] & ~31u) ? step : 0;
  }
  uint32_t acc = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t hit = tab[pos[i]] == (v[i] & ~31u) ? tab[P + pos[i]] >> (v[i] & 31u) : 0u;
    acc |= (hit & 1u) << i;
  }
  return acc;
}

// size: the bitmap's words (kLookupBitmap, kLookupBuild), else P.  Only
// kLookupBuild reads rows (nrows of them).
template <int W, int kTable, class Rows>
__global__ void __launch_bounds__(kThreads)
member_lookup_kernel(const uint32_t* __restrict__ table, int size, Rows rows, int nrows,
                     const uint32_t* __restrict__ tiles, uint32_t* __restrict__ bits,
                     unsigned long long* __restrict__ counts, long long nblocks, long long n,
                     long long block_offset) {
  extern __shared__ uint32_t s_tab[];
  __shared__ unsigned s_cnt[1];
  if constexpr (kTable == kLookupBuild) {
    build_bitmap(s_tab, size, rows, nrows, W);
  } else {
    const int words = kTable == kLookupBitmap ? size : kTable == kLookupShared ? 2 * size : 0;
    for (int i = threadIdx.x; i < words; i += blockDim.x) s_tab[i] = __ldg(table + i);
  }
  zero_counts(s_cnt, 1);  // its barrier also publishes the table
  const uint32_t* tab = kTable == kLookupGlobal ? table : s_tab;
  const long long ntiles = (nblocks + blockDim.x - 1) / blockDim.x;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {  // CTA-uniform trip count
    const long long b = t * blockDim.x + threadIdx.x;
    const bool active = b < nblocks;
    uint32_t w[W];
    load_block<W>(tiles, nblocks, b, active, w);
    const uint32_t valid = active ? valid_word(block_offset + b, n) : 0u;
    uint32_t acc = 0u;
    if constexpr (kTable == kLookupBitmap || kTable == kLookupBuild) {
#pragma unroll
      for (int r = 0; r < kBlockValues; ++r) {
        const uint32_t x = unpack_value<W>(w, r);
        acc |= ((tab[x >> 5] >> (x & 31u)) & 1u) << r;
      }
    } else {
#pragma unroll
      for (int g = 0; g < kBlockValues; g += 8) {
        uint32_t v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = unpack_value<W>(w, g + i);
        acc |= search8(tab, size, v) << g;
      }
    }
    store_row(bits, nblocks, b, active, 0, acc & valid, s_cnt);
  }
  flush_counts(s_cnt, 1, counts);
}

template <int W, int kTable, class Rows = NoRows>
cudaError_t launch_member_lookup(const uint32_t* table, int size, const uint32_t* tiles,
                                 uint32_t* bits, unsigned long long* counts, long long nblocks,
                                 long long n, long long block_offset, cudaStream_t stream,
                                 Rows rows = Rows{}, int nrows = 0) {
  const auto kernel = member_lookup_kernel<W, kTable, Rows>;
  const size_t smem =
      (kTable == kLookupShared ? 2 * size : kTable == kLookupGlobal ? 0 : size) * sizeof(uint32_t);
  unsigned grid = 0;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = resident_grid(kernel, kThreads, smem, (nblocks + kThreads - 1) / kThreads, &grid);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(table, size, rows, nrows, tiles, bits, counts, nblocks,
                                           n, block_offset);
  return cudaGetLastError();
}

// The table built elsewhere, looked up at any width: the bitmap up to
// width 16, past it the search (in shared memory up to
// kLookupSharedWindows windows).
cudaError_t lookup_any_width(const uint32_t* table, int size, const uint32_t* tiles,
                             uint32_t* bits, unsigned long long* counts, long long nblocks,
                             int width, long long n, long long block_offset,
                             cudaStream_t stream) {
  const bool shared = size <= kLookupSharedWindows;
  switch (width) {
#define SSS_BITMAP_CASE(W) \
  case W:                  \
    return launch_member_lookup<W, kLookupBitmap>(table, size, tiles, bits, counts, nblocks, n, \
                                                  block_offset, stream);
    SSS_FOR_EACH_DOMAIN_WIDTH(SSS_BITMAP_CASE)
#undef SSS_BITMAP_CASE
#define SSS_SEARCH_CASE(W)                                                                      \
  case W:                                                                                       \
    return shared ? launch_member_lookup<W, kLookupShared>(table, size, tiles, bits, counts,    \
                                                           nblocks, n, block_offset, stream)    \
                  : launch_member_lookup<W, kLookupGlobal>(table, size, tiles, bits, counts,    \
                                                           nblocks, n, block_offset, stream);
    SSS_SEARCH_CASE(17) SSS_SEARCH_CASE(18) SSS_SEARCH_CASE(19) SSS_SEARCH_CASE(20)
    SSS_SEARCH_CASE(21) SSS_SEARCH_CASE(22) SSS_SEARCH_CASE(23) SSS_SEARCH_CASE(24)
    SSS_SEARCH_CASE(25) SSS_SEARCH_CASE(26) SSS_SEARCH_CASE(27) SSS_SEARCH_CASE(28)
    SSS_SEARCH_CASE(29) SSS_SEARCH_CASE(30) SSS_SEARCH_CASE(31)
#undef SSS_SEARCH_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// Words of an operand's table: the bitmap's up to width 16, else P.
inline int operand_table_size(int width, int nrows) {
  if (width <= kMaxBitmapWidth) return width > 5 ? 1 << (width - 5) : 1;
  int p = 1;
  while (p < nrows) p <<= 1;
  return p;
}

// The bitmap of the rows, by one CTA, into device memory.
template <class Rows>
__global__ void __launch_bounds__(kBuildThreads)
member_bitmap_build_kernel(Rows rows, int nrows, int width, uint32_t* __restrict__ table,
                           int words) {
  extern __shared__ uint32_t s_tab[];
  build_bitmap(s_tab, words, rows, nrows, width);
  __syncthreads();
  for (int i = threadIdx.x; i < words; i += blockDim.x) table[i] = s_tab[i];
}

__device__ __forceinline__ uint32_t base_of(unsigned long long x) { return (uint32_t)(x >> 32); }
__device__ __forceinline__ uint32_t base_of(uint32_t x) { return x; }

// The last index of s[0..m) (sorted by base, m a power of two) whose base
// is at or below b, given s[0]'s is: the search of search8.
template <class T>
__device__ __forceinline__ int last_at_or_below(const T* s, int m, uint32_t b) {
  int pos = 0;
  for (int step = m >> 1; step > 0; step >>= 1)
    if (base_of(s[pos + step]) <= b) pos += step;
  return pos;
}

// Ascending bitonic sort of s[0..m) (m a power of two) by the whole block.
__device__ __forceinline__ void bitonic_sort(unsigned long long* s, int m) {
  for (int size = 2; size <= m; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int t = threadIdx.x; t < m / 2; t += blockDim.x) {
        const int i = 2 * t - (t & (stride - 1)), j = i + stride;
        const unsigned long long a = s[i], b = s[j];
        if ((a > b) == ((i & size) == 0)) {
          s[i] = b;
          s[j] = a;
        }
      }
    }
  }
  __syncthreads();
}

// Rows as composite keys (base << 32 | popmask; kNoRow for a dropped row
// or the padding to P), a chunk of min(P, kSortChunk) a CTA, sorted in
// shared memory.  One CTA (P <= kSortChunk) writes the table itself: the
// bases, and each run's OR of popmasks in its last entry; more write
// their sorted chunks to out for the merge passes.
template <class Rows>
__global__ void __launch_bounds__(kBuildThreads)
member_sort_kernel(Rows rows, int nrows, int width, int P, unsigned long long* __restrict__ out,
                   uint32_t* __restrict__ table) {
  extern __shared__ unsigned long long s_key[];
  const int m = P < kSortChunk ? P : kSortChunk;
  const int first = blockIdx.x * m;
  for (int t = threadIdx.x; t < m; t += blockDim.x) {
    const int i = first + t;
    const uint2 r = i < nrows ? in_domain(rows.row(i), width) : make_uint2(0u, 0u);
    s_key[t] = r.y ? (unsigned long long)r.x << 32 | r.y : kNoRow;
  }
  bitonic_sort(s_key, m);
  if (gridDim.x > 1) {
    for (int t = threadIdx.x; t < m; t += blockDim.x) out[first + t] = s_key[t];
    return;
  }
  uint32_t* s_pop = reinterpret_cast<uint32_t*>(s_key + m);
  for (int t = threadIdx.x; t < m; t += blockDim.x) s_pop[t] = 0u;
  __syncthreads();
  for (int t = threadIdx.x; t < m; t += blockDim.x) {
    const uint32_t pop = (uint32_t)s_key[t];
    if (pop) atomicOr(s_pop + last_at_or_below(s_key, m, base_of(s_key[t])), pop);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < m; t += blockDim.x) {
    table[t] = base_of(s_key[t]);
    table[P + t] = s_pop[t];
  }
}

// One merge pass: sorted runs of `run` composite keys in src, pairs of
// them merged into dst.  Each element's place: its index in its run plus
// the number of its partner run's elements below it (at or below it for
// the right run, so equal keys keep the left run's first).  The last pass
// also writes the table's bases and zeroes its popmasks.
__global__ void __launch_bounds__(kThreads)
member_merge_kernel(const unsigned long long* __restrict__ src,
                    unsigned long long* __restrict__ dst, int run, int P,
                    uint32_t* __restrict__ table) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P) return;
  const unsigned long long x = src[i];
  const int p = i & (run - 1), left = i - p;
  const bool right = (left / run) & 1;
  const unsigned long long* q = right ? src + left - run : src + left + run;
  int below = 0;
  for (int step = run; step > 0; step >>= 1) {
    if (below + step <= run) {
      const unsigned long long y = q[below + step - 1];
      if (right ? y <= x : y < x) below += step;
    }
  }
  const int pos = (right ? left - run : left) + p + below;
  dst[pos] = x;
  if (table) {
    table[pos] = base_of(x);
    table[P + pos] = 0u;
  }
}

// Each row ORs its popmask into the last entry of its run of bases.
__global__ void __launch_bounds__(kThreads)
member_or_runs_kernel(const unsigned long long* __restrict__ sorted, uint32_t* __restrict__ table,
                      int P) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P) return;
  const unsigned long long x = sorted[i];
  if ((uint32_t)x) atomicOr(table + P + last_at_or_below(table, P, base_of(x)), (uint32_t)x);
}

// The operand's table (size words: operand_table_size) into device
// memory; past kSortChunk rows scratch holds 2 * size composite keys.
template <class Rows>
cudaError_t build_operand_table(Rows rows, int nrows, int width, uint32_t* table, int size,
                                unsigned long long* scratch, cudaStream_t stream) {
  if (width <= kMaxBitmapWidth) {
    member_bitmap_build_kernel<<<1, kBuildThreads, size * sizeof(uint32_t), stream>>>(
        rows, nrows, width, table, size);
    return cudaGetLastError();
  }
  // one CTA: composite keys and popmasks; more: a chunk of composite keys.
  // The attribute is set on every call: a launch may not take more than
  // the last call set.
  const auto sort = member_sort_kernel<Rows>;
  const bool one = size <= kSortChunk;
  const size_t smem = one ? size * (sizeof(unsigned long long) + sizeof(uint32_t))
                          : kSortChunk * sizeof(unsigned long long);
  if (!one && scratch == nullptr) return cudaErrorInvalidValue;
  const cudaError_t err =
      cudaFuncSetAttribute(sort, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return err;
  }
  if (one) {
    sort<<<1, kBuildThreads, smem, stream>>>(rows, nrows, width, size, nullptr, table);
    return cudaGetLastError();
  }
  sort<<<size / kSortChunk, kBuildThreads, smem, stream>>>(rows, nrows, width, size, scratch,
                                                            nullptr);
  unsigned long long *src = scratch, *dst = scratch + size;
  for (int run = kSortChunk; run < size; run <<= 1) {
    member_merge_kernel<<<size / kThreads, kThreads, 0, stream>>>(
        src, dst, run, size, 2 * run == size ? table : nullptr);
    unsigned long long* t = src;
    src = dst;
    dst = t;
  }
  member_or_runs_kernel<<<size / kThreads, kThreads, 0, stream>>>(src, table, size);
  return cudaGetLastError();
}

// A compare or window body: the operand's table, then one lookup a value;
// fused (widths up to 16): each resident CTA builds the bitmap itself in
// the scan's launch, and table is not touched.
template <class Rows>
int member_operand_scan(const uint32_t* tiles, Rows rows, int nrows, uint32_t* table, int size,
                        unsigned long long* scratch, uint32_t* bits, unsigned long long* counts,
                        long long nblocks, int width, long long n, long long block_offset,
                        int fused, cudaStream_t stream) {
  if (!width_ok(width) || nrows < 1 || nrows > (1 << 30) ||
      size != operand_table_size(width, nrows) || (fused && width > kMaxBitmapWidth))
    return (int)cudaErrorInvalidValue;
  if (nblocks <= 0) return (int)cudaSuccess;
  if (fused) {
    switch (width) {
#define SSS_CASE(W)                                                                              \
  case W:                                                                                        \
    return (int)launch_member_lookup<W, kLookupBuild, Rows>(nullptr, size, tiles, bits, counts,   \
                                                            nblocks, n, block_offset, stream,     \
                                                            rows, nrows);
      SSS_FOR_EACH_DOMAIN_WIDTH(SSS_CASE)
#undef SSS_CASE
    }
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = build_operand_table(rows, nrows, width, table, size, scratch, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)lookup_any_width(table, size, tiles, bits, counts, nblocks, width, n, block_offset,
                               stream);
}

}  // namespace sss


// keys int32[k] or win int32[nwin, 2] (base, popmask) in device memory;
// table int32[size] (size: the bitmap's words up to width 16, else P for
// the k or 2 * nwin rows, the table then 2 x P words), unused when fused;
// scratch uint64[2 * P] past 4096 rows, else unused; bits (1, nblocks) and
// counts int64[1] (zeroed by the caller).
extern "C" int sss_member_compare(const uint32_t* tiles, const uint32_t* keys, int k,
                                  uint32_t* table, int size, unsigned long long* scratch,
                                  uint32_t* bits, unsigned long long* counts, long long nblocks,
                                  int width, long long n, long long block_offset, int fused,
                                  cudaStream_t stream) {
  return sss::member_operand_scan(tiles, sss::KeyRows{keys}, k, table, size, scratch, bits,
                                  counts, nblocks, width, n, block_offset, fused, stream);
}

extern "C" int sss_member_window(const uint32_t* tiles, const int* win, int nwin,
                                 uint32_t* table, int size, unsigned long long* scratch,
                                 uint32_t* bits, unsigned long long* counts, long long nblocks,
                                 int width, long long n, long long block_offset, int fused,
                                 cudaStream_t stream) {
  if (nwin < 1 || nwin > (1 << 29)) return (int)cudaErrorInvalidValue;
  return sss::member_operand_scan(tiles, sss::WindowRows{reinterpret_cast<const uint2*>(win)},
                                  2 * nwin, table, size, scratch, bits, counts, nblocks, width, n,
                                  block_offset, fused, stream);
}

// The table of sss_member_compare (window 0: keys int32[count]) or
// sss_member_window (window 1: int32[count, 2]) alone, into table.
extern "C" int sss_member_table(const uint32_t* operand, int count, int window, int width,
                                uint32_t* table, int size, unsigned long long* scratch,
                                cudaStream_t stream) {
  const int nrows = window ? 2 * count : count;
  if (!sss::width_ok(width) || count < 1 || count > (1 << 29) ||
      size != sss::operand_table_size(width, nrows))
    return (int)cudaErrorInvalidValue;
  if (window)
    return (int)sss::build_operand_table(
        sss::WindowRows{reinterpret_cast<const uint2*>(operand)}, nrows, width, table, size,
        scratch, stream);
  return (int)sss::build_operand_table(sss::KeyRows{operand}, nrows, width, table, size, scratch,
                                       stream);
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

// table: the bitmap (int32[max(1, 2^width / 32)], size its words) at
// widths 1..16; past 16 the search table (int32[2, P]: the sorted window
// bases padded with 0xFFFFFFFF, then their popmasks; size P, a power of
// two).  bits (1, nblocks) and counts int64[1] (zeroed by the caller).
extern "C" int sss_member_lookup(const uint32_t* tiles, const uint32_t* table, int size,
                                 uint32_t* bits, unsigned long long* counts, long long nblocks,
                                 int width, long long n, long long block_offset,
                                 cudaStream_t stream) {
  if (!sss::width_ok(width) || size < 1) return (int)cudaErrorInvalidValue;
  if (width <= 16 ? size != (width > 5 ? 1 << (width - 5) : 1) : (size & (size - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (nblocks <= 0) return (int)cudaSuccess;
  return (int)sss::lookup_any_width(table, size, tiles, bits, counts, nblocks, width, n,
                                   block_offset, stream);
}

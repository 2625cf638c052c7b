// Keyed aggregates by one key lookup per value: SUM and COUNT for host
// keys, one scatter-add per value; MIN, MAX and COUNT for keys in device
// memory, three shared updates per value.
//
// Replaces shared_simd_scan_tpu/ops/aggregate.py:
//  - _agg_bitplane_static_kernel / _agg_bitplane_static_impl
//    (aggregate_bitplane_static_tiles): host keys, 1 <= k <= 32; count j
//    and sum j over the real rows whose predicate equals key j.  The TPU
//    computes the key set's memoized AND-DAG over the predicate's bit
//    planes, then a popcount per key per measure plane, because Mosaic has
//    neither gather nor scatter: k * wm popcounts per 32 values (640 at k =
//    32, wm = 20).  This card has both, so here the work per value depends
//    on neither k nor wm (sss_agg_lookup);
//  - _minmax_kernel / minmax_scan_tiles: keys in device memory (the host
//    never reads them), 1 <= k <= 32; count j, min j and max j of the
//    measure over the real rows whose predicate equals key j.  The TPU
//    compares every value with every key and selects into per-key minima
//    and maxima; here each value's slot takes its count, MIN and MAX
//    (sss_minmax_lookup).
// A key >= 2^wp gives 0 (and an empty group), a duplicate its first
// occurrence's totals; padding slots and indices >= n match no key, key 0
// and 0xFFFFFFFF included (the reference's compare and MIN/MAX kernels
// count padding at the key 0xFFFFFFFF).
//
// Bound on the H100: device memory bytes (wp + wm words per 32 values), and
// the shared-memory updates (two atomics a value for the sum, up to three
// for MIN/MAX) and their issue.  Design: each CTA builds the key set's
// lookup once in shared memory (build_agg_lookup) -- for wp <=
// kLookupTableBits a byte table from value to slot (2^wp bytes, 64 KB at wp
// = 16); past it a byte table on a 16-bit window of the value, (v >> shift)
// & 0xFFFF, at the highest shift where the keys' windows are distinct (the
// host picks it for host keys; for keys in device memory each CTA tests
// the shifts itself, one pair of keys a thread), then one compare with the
// slot's key; if no window separates the keys, a branch-free binary search
// of the sorted keys in five steps (as the lookup scans search,
// shared_scan.cu) -- where a key's slot is the first index holding it.
// Resident CTAs loop over tiles of kThreads blocks; each thread unpacks
// its block of both columns (a switch on each width, so no kernel is
// templated on both) and looks up its 32 predicates.  Per tile each warp
// chooses: where at least half its lanes' first values share one slot (a
// constant or skewed predicate; for the sum lane 0's slot, for MIN/MAX the
// slot most of them share), the values at that slot are folded in
// registers, flushed at the tile's end, and only the others take atomics
// (32 lanes' atomics on one address serialize: 2.06 ms for a constant
// predicate at A2's n, 0.63 this way; MIN/MAX's 3.93 and 0.60).  A value with no slot (no key holds
// it, or it is not real) updates its lane's spare counters, which no one
// reads, so no value branches.  SUM: each value adds 1 to its slot's count
// and its measure to its slot's sum, a 32-bit word whose atomic returns the
// old value, and a count of the carries out of it: exact at any size,
// since a CTA takes fewer than 2^32 values (least_ctas).  MIN/MAX: each
// value adds 1 to its slot's count and folds its measure into the slot's
// int32 MIN and MAX (measure values are below 2^31, so int32 order with
// the identities 0x7FFFFFFF and -1 is exact).  Each CTA flushes one int64
// atomic per key and counter.  The registers are capped for three CTAs an
// SM: at 92 registers (two CTAs) the adaptive SUM ran 28% slower on
// uniform predicates.  The other update forms (kWide, kMerge, kHot, kBatch,
// kBatchHot, kPerWarp counters; for MIN/MAX the atomics with or without a
// load first, with or without the warp's hot slot) are measured against
// the library's by bench/redesign_sweep.py aggstatic and minmax (PERF.md).
#include "common.cuh"

namespace sss {

constexpr int kLookupTableBits = 16;  // predicate widths looked up in a byte table
constexpr uint32_t kNoSlot = 0xFFu;
// The lookup from predicate value to slot: a byte table over the whole
// domain (wp <= kLookupTableBits); a byte table over a 16-bit window of the
// value, (v >> shift) & 0xFFFF, where the keys' windows are distinct, then
// one compare with the slot's key; else a binary search of the sorted keys.
// kCtaPlan (wp > kLookupTableBits, keys the host does not read): each CTA
// finds the window's shift itself, and takes kSearch where none exists.
constexpr int kByteTable = 0, kWindow = 1, kSearch = 2, kCtaPlan = 3;
constexpr int kSlots = kMaxAggKeys + 32;  // the keys' slots, then a spare per lane
// CTAs an SM the registers must allow (at most 84 a thread)
constexpr int kAggCtasPerSm = 3;

// The host's keys, by value in the kernel's parameters.
struct AggKeys {
  uint32_t key[kMaxAggKeys];
  __device__ __forceinline__ uint32_t operator[](int j) const { return key[j]; }
};

// The key set's lookup in shared memory, beside the byte table; built once
// per CTA by build_agg_lookup.
struct AggLookup {
  uint32_t sorted[kMaxAggKeys];  // kSearch: the distinct keys, then 0xFFFFFFFF
  uint32_t key[kMaxAggKeys];     // kWindow: the key of each slot
  uint8_t sidx[kMaxAggKeys];     // kSearch: the slot of sorted[i]
  uint8_t rep[kMaxAggKeys];      // the slot of key j (kNoSlot past the domain)
  unsigned clash;                // kCtaPlan: bit s set where two keys' windows at s meet
};

// How a value's count and measure reach its slot's counters: kCarry every
// value at its counter or its lane's spare, its carry checked right after
// its atomic; kWide a 64-bit sum; kMerge the lanes of one slot merged;
// kHot kCarry, values at the warp's hot slot summed in registers; kBatch
// values with no slot skipped, the atomics of eight values issued before
// their carry checks; kBatchHot kBatch with the hot slot in registers;
// kAdaptive kHot for a tile where half a warp's first values share lane
// 0's slot (its registers flushed at the tile's end), else kCarry.
constexpr int kCarry = 0, kWide = 1, kMerge = 2, kHot = 3, kBatch = 4, kBatchHot = 5,
              kAdaptive = 6;

template <bool kWideSum, int kCopies>
struct AggCounters {
  unsigned cnt[kCopies][kSlots];
  unsigned lo[kCopies][kSlots];  // the sum's low word
  unsigned hi[kCopies][kSlots];  // carries out of it
  unsigned long long wide[kWideSum ? kCopies : 1][kWideSum ? kSlots : 1];
};

// Add v (< 2^32) to the sum kept as lo + 2^32 hi.
__device__ __forceinline__ void add_carry(unsigned* lo, unsigned* hi, unsigned v) {
  const unsigned old = atomicAdd(lo, v);
  if (old + v < old) atomicAdd(hi, 1u);
}

// Add v (< 2^64) to the sum kept as lo + 2^32 hi.
__device__ __forceinline__ void add_carry64(unsigned* lo, unsigned* hi, unsigned long long v) {
  const unsigned low = (unsigned)v;
  const unsigned old = atomicAdd(lo, low);
  const unsigned up = (unsigned)(v >> 32) + (old + low < old ? 1u : 0u);
  if (up) atomicAdd(hi, up);
}

// The slot of predicate value v: the first index of the key equal to v, or
// kNoSlot.
template <int kLookup>
__device__ __forceinline__ uint32_t agg_slot(const uint8_t* table, const AggLookup& L, int shift,
                                             uint32_t v) {
  if constexpr (kLookup == kByteTable) {
    return table[v];
  } else if constexpr (kLookup == kWindow) {
    const uint32_t b = table[(v >> shift) & 0xFFFFu];
    return b < (uint32_t)kMaxAggKeys && L.key[b & (kMaxAggKeys - 1)] == v ? b : kNoSlot;
  } else {
    int pos = 0;
#pragma unroll
    for (int half = kMaxAggKeys / 2; half > 0; half >>= 1)
      if (L.sorted[pos + half - 1] < v) pos += half;
    return L.sorted[pos] == v ? (uint32_t)L.sidx[pos] : kNoSlot;
  }
}

// Once per CTA, all threads: rep[j], the slot of key j (its first
// occurrence; kNoSlot past the domain), then the lookup from each slot's
// key to its slot, in `table` (s_table's bytes) and L.  Returns the lookup
// the CTA takes: kLookup, or for kCtaPlan kWindow at the highest shift
// whose 16-bit windows of the distinct in-domain keys are distinct (set in
// `shift`), else kSearch.  Ends with a barrier.
template <int kLookup, typename Keys>
__device__ __forceinline__ int build_agg_lookup(const Keys& keys, int k, int wp, int& shift,
                                                uint32_t* s_table, AggLookup& L) {
  uint8_t* table = reinterpret_cast<uint8_t*>(s_table);
  const uint32_t vmask = (1u << wp) - 1u;  // wp <= 31
  if (kLookup != kSearch) {
    const int words = ((kLookup == kByteTable ? 1 << wp : 1 << 16) + 3) / 4;
    for (int i = threadIdx.x; i < words; i += blockDim.x) s_table[i] = 0xFFFFFFFFu;
  }
  if (threadIdx.x == 0) L.clash = 0u;
  for (int j = threadIdx.x; j < kMaxAggKeys; j += blockDim.x) {
    L.sorted[j] = 0xFFFFFFFFu;  // above every value: pads the search
    if (j < k) {
      const uint32_t key = keys[j];
      int first = j;
      for (int i = 0; i < j; ++i)
        if (keys[i] == key) {
          first = i;
          break;
        }
      L.rep[j] = key <= vmask ? (uint8_t)first : (uint8_t)kNoSlot;
    }
  }
  __syncthreads();
  int lookup = kLookup;
  if constexpr (kLookup == kCtaPlan) {
    // every pair of distinct in-domain keys marks the shifts (0 .. wp - 16)
    // where their windows meet
    const int top = wp - 16;
    for (int pr = threadIdx.x; pr < kMaxAggKeys * kMaxAggKeys; pr += blockDim.x) {
      const int i = pr / kMaxAggKeys, j = pr % kMaxAggKeys;
      if (i < j && j < k && L.rep[i] == i && L.rep[j] == j) {
        const uint32_t d = keys[i] ^ keys[j];
        unsigned clash = 0u;
        for (int sh = 0; sh <= top; ++sh) clash |= ((d >> sh) & 0xFFFFu) ? 0u : 1u << sh;
        if (clash) atomicOr(&L.clash, clash);
      }
    }
    __syncthreads();
    const unsigned fits = ~L.clash & ((2u << top) - 1u);
    shift = fits ? 31 - __clz(fits) : 0;
    lookup = fits ? kWindow : kSearch;
  }
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    if (L.rep[j] != j) continue;  // a duplicate, or no value can match
    const uint32_t key = keys[j];
    if (lookup == kByteTable) {
      table[key] = (uint8_t)j;
    } else if (lookup == kWindow) {
      table[(key >> shift) & 0xFFFFu] = (uint8_t)j;
      L.key[j] = key;
    } else {
      int rank = 0;  // distinct keys of the domain below this one
      for (int i = 0; i < k; ++i) rank += L.rep[i] == i && keys[i] < key;
      L.sorted[rank] = key;
      L.sidx[rank] = (uint8_t)j;
    }
  }
  __syncthreads();
  return lookup;
}

// Count value v (measure m) at counter idx (a slot, or this lane's spare).
// Must be reached by all 32 lanes of the warp (kMerge).
template <int kForm, bool kW, int kCopies>
__device__ __forceinline__ void add_value(AggCounters<kW, kCopies>& c, int copy, uint32_t idx,
                                          uint32_t m) {
  if constexpr (kForm == kMerge) {
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, idx);
    const unsigned lo = __reduce_add_sync(peers, m & 0xFFFFu);
    const unsigned hi = __reduce_add_sync(peers, m >> 16);
    if ((threadIdx.x & 31u) == (unsigned)(__ffs(peers) - 1)) {
      atomicAdd(&c.cnt[copy][idx], (unsigned)__popc(peers));
      add_carry64(&c.lo[copy][idx], &c.hi[copy][idx], ((unsigned long long)hi << 16) + lo);
    }
  } else {
    atomicAdd(&c.cnt[copy][idx], 1u);
    if constexpr (kForm == kWide) atomicAdd(&c.wide[copy][idx], (unsigned long long)m);
    else add_carry(&c.lo[copy][idx], &c.hi[copy][idx], m);
  }
}

// Count the block's 32 values: value r (counter s[r], measure m[r]) where
// bit r of `valid` is set, else this lane's spare.  kHot: values at the
// warp's hot counter are summed in registers instead.
template <int kForm, bool kW, int kCopies>
__device__ __forceinline__ void add_block(AggCounters<kW, kCopies>& c, int copy,
                                          const uint32_t (&s)[kBlockValues],
                                          const uint32_t (&m)[kBlockValues], uint32_t valid,
                                          uint32_t spare, uint32_t hot, unsigned& hot_cnt,
                                          unsigned long long& hot_sum) {
  if constexpr (kForm == kBatch || kForm == kBatchHot) {
#pragma unroll
    for (int g = 0; g < kBlockValues; g += 8) {
      unsigned old[8];
      bool take[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint32_t idx = s[g + i];
        bool t = ((valid >> (g + i)) & 1u) && idx < (uint32_t)kMaxAggKeys;
        if constexpr (kForm == kBatchHot) {
          const bool h = t && idx == hot;
          hot_cnt += h;
          hot_sum += h ? m[g + i] : 0u;
          t = t && !h;
        }
        take[i] = t;
        old[i] = 0u;
        if (t) {
          atomicAdd(&c.cnt[copy][idx], 1u);
          old[i] = atomicAdd(&c.lo[copy][idx], m[g + i]);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (take[i] && old[i] + m[g + i] < old[i]) atomicAdd(&c.hi[copy][s[g + i]], 1u);
    }
  } else {
#pragma unroll
    for (int r = 0; r < kBlockValues; ++r) {
      const uint32_t idx = ((valid >> r) & 1u) ? s[r] : spare;
      if constexpr (kForm == kHot) {
        if (idx == hot) {
          ++hot_cnt;
          hot_sum += m[r];
          continue;
        }
      }
      add_value<kForm>(c, copy, idx, m[r]);
    }
  }
}

// kAdaptive's hot tile: the warp's registers of its hot slot flushed.
template <bool kW, int kCopies>
__device__ __forceinline__ void flush_hot(AggCounters<kW, kCopies>& c, int copy, uint32_t hot,
                                          unsigned hot_cnt, unsigned long long hot_sum) {
  const unsigned cnt = __reduce_add_sync(0xFFFFFFFFu, hot_cnt);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) hot_sum += __shfl_down_sync(0xFFFFFFFFu, hot_sum, off);
  if ((threadIdx.x & 31u) == 0 && cnt) {
    atomicAdd(&c.cnt[copy][hot], cnt);
    add_carry64(&c.lo[copy][hot], &c.hi[copy][hot], hot_sum);
  }
}

// kLookup: kByteTable (wp <= kLookupTableBits), kWindow (`shift`) or
// kSearch.
template <int kLookup, int kForm = kAdaptive, bool kPerWarp = false>
__global__ void __launch_bounds__(kThreads, kAggCtasPerSm)
agg_lookup_kernel(const uint32_t* __restrict__ ptiles, const uint32_t* __restrict__ mtiles,
                  const __grid_constant__ AggKeys keys, int k, int wp, int wm, int shift,
                  unsigned long long* __restrict__ counts, unsigned long long* __restrict__ sums,
                  long long nblocks, long long n, long long block_offset) {
  constexpr int kCopies = kPerWarp ? kThreads / 32 : 1;
  extern __shared__ uint32_t s_table[];  // the byte table: 2^wp or 2^16 slots
  __shared__ AggCounters<kForm == kWide, kCopies> c;
  __shared__ AggLookup L;
  const uint8_t* table = reinterpret_cast<const uint8_t*>(s_table);

  for (int i = threadIdx.x; i < kCopies * kSlots; i += blockDim.x) {
    (&c.cnt[0][0])[i] = (&c.lo[0][0])[i] = (&c.hi[0][0])[i] = 0u;
    if constexpr (kForm == kWide) (&c.wide[0][0])[i] = 0ull;
  }
  build_agg_lookup<kLookup>(keys, k, wp, shift, s_table, L);

  const uint32_t spare = kMaxAggKeys + (threadIdx.x & 31u);
  const int copy = kPerWarp ? (int)(threadIdx.x >> 5) : 0;
  uint32_t hot = kNoSlot;  // kHot: the warp's hot counter, lane 0's first
  unsigned hot_cnt = 0u;
  unsigned long long hot_sum = 0ull;
  const long long ntiles = (nblocks + blockDim.x - 1) / blockDim.x;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {  // CTA-uniform trip count
    const long long first = t * blockDim.x;
    const long long b = first + threadIdx.x;
    const bool active = b < nblocks;
    uint32_t s[kBlockValues], m[kBlockValues];
    unpack_block_any(wp, ptiles, nblocks, b, active, s);
#pragma unroll
    for (int r = 0; r < kBlockValues; ++r) {
      const uint32_t slot = agg_slot<kLookup>(table, L, shift, s[r]);
      s[r] = slot < (uint32_t)kMaxAggKeys ? slot : spare;
    }
    unpack_block_any(wm, mtiles, nblocks, b, active, m);
    if constexpr (kForm == kHot || kForm == kBatchHot) {
      if (hot == kNoSlot) hot = __shfl_sync(0xFFFFFFFFu, s[0], 0);
    }
    const auto count = [&](uint32_t valid) {
      if constexpr (kForm == kAdaptive) {
        const uint32_t h = __shfl_sync(0xFFFFFFFFu, s[0], 0);
        if (__popc(__ballot_sync(0xFFFFFFFFu, s[0] == h)) >= 16) {  // warp-uniform
          unsigned hc = 0u;
          unsigned long long hs = 0ull;
          add_block<kHot>(c, copy, s, m, valid, spare, h, hc, hs);
          flush_hot(c, copy, h, hc, hs);
        } else {
          add_block<kCarry>(c, copy, s, m, valid, spare, h, hot_cnt, hot_sum);
        }
      } else {
        add_block<kForm>(c, copy, s, m, valid, spare, hot, hot_cnt, hot_sum);
      }
    };
    // (CTA-uniform, so each path is taken by whole warps)
    if (full_tile(first, nblocks, n, block_offset)) count(0xFFFFFFFFu);
    else count(active ? valid_word(block_offset + b, n) : 0u);
  }
  if constexpr (kForm == kHot || kForm == kBatchHot) {
    if (hot != kNoSlot) flush_hot(c, copy, hot, hot_cnt, hot_sum);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const uint32_t r = L.rep[j];
    if (r == kNoSlot) continue;
    unsigned long long cnt = 0ull, sum = 0ull;
    for (int w = 0; w < kCopies; ++w) {
      cnt += c.cnt[w][r];
      if constexpr (kForm == kWide) sum += c.wide[w][r];
      else sum += ((unsigned long long)c.hi[w][r] << 32) + c.lo[w][r];
    }
    if (cnt) atomicAdd(counts + j, cnt);
    if (sum) atomicAdd(sums + j, sum);
  }
}

// The lookup for k host keys of a wp-bit predicate: kByteTable up to
// kLookupTableBits; past it kWindow at the highest `shift` whose 16-bit
// windows of the distinct in-domain keys are distinct, else kSearch.
inline int agg_lookup_plan(const AggKeys& keys, int k, int wp, int* shift) {
  *shift = 0;
  if (wp <= kLookupTableBits) return kByteTable;
  const uint32_t vmask = (1u << wp) - 1u;
  for (int sh = wp - 16; sh >= 0; --sh) {
    bool distinct = true;
    for (int j = 0; j < k && distinct; ++j)
      for (int i = 0; i < j && distinct; ++i) {
        const uint32_t a = keys.key[i], b = keys.key[j];
        distinct = a == b || a > vmask || b > vmask ||
                   ((a >> sh) & 0xFFFFu) != ((b >> sh) & 0xFFFFu);
      }
    if (distinct) {
      *shift = sh;
      return kWindow;
    }
  }
  return kSearch;
}

// One launch on a resident grid (at least least_ctas CTAs); a launch that
// is refused returns its error.
template <int kForm = kAdaptive, bool kPerWarp = false>
cudaError_t launch_agg_lookup(const uint32_t* ptiles, const uint32_t* mtiles, const AggKeys& keys,
                              int k, int wp, int wm, int lookup, int shift,
                              unsigned long long* counts, unsigned long long* sums,
                              long long nblocks, long long n, long long block_offset,
                              cudaStream_t stream) {
  const auto kernel = lookup == kByteTable ? agg_lookup_kernel<kByteTable, kForm, kPerWarp>
                      : lookup == kWindow  ? agg_lookup_kernel<kWindow, kForm, kPerWarp>
                                           : agg_lookup_kernel<kSearch, kForm, kPerWarp>;
  const size_t smem = lookup == kByteTable ? (((size_t)1 << wp) + 15) / 16 * 16
                      : lookup == kWindow  ? (size_t)1 << 16
                                           : 0;
  const long long ntiles = (nblocks + kThreads - 1) / kThreads;
  unsigned grid = 0;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) err = resident_grid(kernel, kThreads, smem, ntiles, &grid);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return err;
  }
  const long long least = least_ctas(ntiles, kThreads);
  if (grid < least) grid = (unsigned)least;
  kernel<<<grid, kThreads, smem, stream>>>(ptiles, mtiles, keys, k, wp, wm, shift, counts, sums,
                                           nblocks, n, block_offset);
  return cudaGetLastError();
}

inline bool agg_lookup_args_ok(int k, int wp, int wm) {
  return k >= 1 && k <= kMaxAggKeys && width_ok(wp) && width_ok(wm);
}

// --- MIN, MAX and COUNT ----------------------------------------------------

constexpr int kMinIdentity = 0x7FFFFFFF;
constexpr int kMaxIdentity = -1;

// How a value folds into its slot's MIN and MAX: kMmAtomic an atomicMin and
// an atomicMax every value; kMmLoad each counter read first and its atomic
// issued only where the value improves on it (a stale read is never below
// the current minimum nor above the current maximum, so a skipped atomic
// would have changed nothing); kMmAtomicHot and kMmLoadHot the same, and
// for a tile where half a warp's first values share lane 0's slot the
// values at that slot folded in registers, flushed at the tile's end;
// kMmAtomicVote kMmAtomicHot with the slot that most of the warp's first
// values share (__match_any_sync once a tile), so a tile whose lane 0
// misses a skewed column's hot key does not send its lanes' atomicMin and
// atomicMax to one address.  Every value adds 1 to its slot's count with
// an atomic.
constexpr int kMmAtomic = 0, kMmLoad = 1, kMmAtomicHot = 2, kMmLoadHot = 3, kMmAtomicVote = 4;
// The library's form, and its lookup past kLookupTableBits
constexpr int kMinMaxForm = kMmAtomicVote;
constexpr int kMinMaxWideLookup = kCtaPlan;

struct MinMaxCounters {
  unsigned cnt[kSlots];
  int mn[kSlots];
  int mx[kSlots];
};

// The block's 32 values: value r (slot s[r], measure m[r]) where bit r of
// `valid` is set, else this lane's spare.  kHot: the values at slot `hot`
// fold into hc, hmn and hmx instead.
template <bool kLoadFirst, bool kHot>
__device__ __forceinline__ void minmax_block(MinMaxCounters& c, const uint32_t (&s)[kBlockValues],
                                             const uint32_t (&m)[kBlockValues], uint32_t valid,
                                             uint32_t spare, uint32_t hot, unsigned& hc,
                                             int& hmn, int& hmx) {
#pragma unroll
  for (int r = 0; r < kBlockValues; ++r) {
    const uint32_t idx = ((valid >> r) & 1u) ? s[r] : spare;
    const int v = (int)m[r];  // < 2^31
    if (kHot && idx == hot) {
      ++hc;
      hmn = min(hmn, v);
      hmx = max(hmx, v);
      continue;
    }
    atomicAdd(&c.cnt[idx], 1u);
    if (!kLoadFirst || v < *(volatile int*)&c.mn[idx]) atomicMin(&c.mn[idx], v);
    if (!kLoadFirst || v > *(volatile int*)&c.mx[idx]) atomicMax(&c.mx[idx], v);
  }
}

// The CTA's tiles: each block's 32 predicates looked up, its 32 measures
// folded into their slots' counters.
template <int kLookup, int kForm>
__device__ __forceinline__ void minmax_tiles(const uint32_t* __restrict__ ptiles,
                                             const uint32_t* __restrict__ mtiles, int wp, int wm,
                                             const uint8_t* table, const AggLookup& L, int shift,
                                             MinMaxCounters& c, long long nblocks, long long n,
                                             long long block_offset) {
  constexpr bool kLoadFirst = kForm == kMmLoad || kForm == kMmLoadHot;
  constexpr bool kAdapt = kForm == kMmAtomicHot || kForm == kMmLoadHot || kForm == kMmAtomicVote;
  const uint32_t spare = kMaxAggKeys + (threadIdx.x & 31u);
  const long long ntiles = (nblocks + blockDim.x - 1) / blockDim.x;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {  // CTA-uniform trip count
    const long long first = t * blockDim.x;
    const long long b = first + threadIdx.x;
    const bool active = b < nblocks;
    uint32_t s[kBlockValues], m[kBlockValues];
    unpack_block_any(wp, ptiles, nblocks, b, active, s);
#pragma unroll
    for (int r = 0; r < kBlockValues; ++r) {
      const uint32_t slot = agg_slot<kLookup>(table, L, shift, s[r]);
      s[r] = slot < (uint32_t)kMaxAggKeys ? slot : spare;
    }
    unpack_block_any(wm, mtiles, nblocks, b, active, m);
    const auto update = [&](uint32_t valid) {
      unsigned hc = 0u;
      int hmn = kMinIdentity, hmx = kMaxIdentity;
      if constexpr (kAdapt) {
        uint32_t h;
        int votes;
        if constexpr (kForm == kMmAtomicVote) {  // the largest group of equal first slots
          const unsigned best = __reduce_max_sync(
              0xFFFFFFFFu, (unsigned)__popc(__match_any_sync(0xFFFFFFFFu, s[0])) << 5 |
                               (threadIdx.x & 31u));
          h = __shfl_sync(0xFFFFFFFFu, s[0], best & 31u);
          votes = (int)(best >> 5);
        } else {
          h = __shfl_sync(0xFFFFFFFFu, s[0], 0);
          votes = __popc(__ballot_sync(0xFFFFFFFFu, s[0] == h));
        }
        if (votes >= 16) {  // warp-uniform
          minmax_block<kLoadFirst, true>(c, s, m, valid, spare, h, hc, hmn, hmx);
          hc = __reduce_add_sync(0xFFFFFFFFu, hc);
          hmn = __reduce_min_sync(0xFFFFFFFFu, hmn);
          hmx = __reduce_max_sync(0xFFFFFFFFu, hmx);
          if ((threadIdx.x & 31u) == 0 && hc) {
            atomicAdd(&c.cnt[h], hc);
            atomicMin(&c.mn[h], hmn);
            atomicMax(&c.mx[h], hmx);
          }
          return;
        }
      }
      minmax_block<kLoadFirst, false>(c, s, m, valid, spare, kNoSlot, hc, hmn, hmx);
    };
    // (CTA-uniform, so each path is taken by whole warps)
    if (full_tile(first, nblocks, n, block_offset)) update(0xFFFFFFFFu);
    else update(active ? valid_word(block_offset + b, n) : 0u);
  }
}

// kLookup: kByteTable (wp <= kLookupTableBits), kCtaPlan or kSearch; keys
// in device memory.
template <int kLookup, int kForm = kMinMaxForm>
__global__ void __launch_bounds__(kThreads, kAggCtasPerSm)
minmax_lookup_kernel(const uint32_t* __restrict__ ptiles, const uint32_t* __restrict__ mtiles,
                     const uint32_t* __restrict__ keys, int k, int wp, int wm,
                     unsigned long long* __restrict__ counts, long long* __restrict__ mins,
                     long long* __restrict__ maxs, long long nblocks, long long n,
                     long long block_offset) {
  extern __shared__ uint32_t s_table[];  // the byte table: 2^wp or 2^16 slots
  __shared__ MinMaxCounters c;
  __shared__ AggLookup L;
  const uint8_t* table = reinterpret_cast<const uint8_t*>(s_table);
  for (int i = threadIdx.x; i < kSlots; i += blockDim.x) {
    c.cnt[i] = 0u;
    c.mn[i] = kMinIdentity;
    c.mx[i] = kMaxIdentity;
  }
  int shift = 0;
  const int lookup = build_agg_lookup<kLookup>(DeviceKeys{keys}, k, wp, shift, s_table, L);
  if constexpr (kLookup == kCtaPlan) {
    if (lookup == kWindow)
      minmax_tiles<kWindow, kForm>(ptiles, mtiles, wp, wm, table, L, shift, c, nblocks, n,
                                   block_offset);
    else
      minmax_tiles<kSearch, kForm>(ptiles, mtiles, wp, wm, table, L, shift, c, nblocks, n,
                                   block_offset);
  } else {
    minmax_tiles<kLookup, kForm>(ptiles, mtiles, wp, wm, table, L, shift, c, nblocks, n,
                                 block_offset);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const uint32_t r = L.rep[j];
    if (r == kNoSlot || c.cnt[r] == 0u) continue;
    atomicAdd(counts + j, (unsigned long long)c.cnt[r]);
    atomicMin(mins + j, (long long)c.mn[r]);
    atomicMax(maxs + j, (long long)c.mx[r]);
  }
}

// One launch on a resident grid (at least least_ctas CTAs); a launch that
// is refused returns its error.
template <int kForm = kMinMaxForm>
cudaError_t launch_minmax_lookup(const uint32_t* ptiles, const uint32_t* mtiles,
                                 const uint32_t* keys, int k, int wp, int wm, int lookup,
                                 unsigned long long* counts, long long* mins, long long* maxs,
                                 long long nblocks, long long n, long long block_offset,
                                 cudaStream_t stream) {
  const auto kernel = lookup == kByteTable ? minmax_lookup_kernel<kByteTable, kForm>
                      : lookup == kCtaPlan ? minmax_lookup_kernel<kCtaPlan, kForm>
                                           : minmax_lookup_kernel<kSearch, kForm>;
  const size_t smem = lookup == kByteTable ? (((size_t)1 << wp) + 15) / 16 * 16
                      : lookup == kCtaPlan ? (size_t)1 << 16
                                           : 0;
  const long long ntiles = (nblocks + kThreads - 1) / kThreads;
  unsigned grid = 0;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) err = resident_grid(kernel, kThreads, smem, ntiles, &grid);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return err;
  }
  const long long least = least_ctas(ntiles, kThreads);
  if (grid < least) grid = (unsigned)least;
  kernel<<<grid, kThreads, smem, stream>>>(ptiles, mtiles, keys, k, wp, wm, counts, mins, maxs,
                                           nblocks, n, block_offset);
  return cudaGetLastError();
}

}  // namespace sss

// keys: a host array of k uint32 (passed by value); counts and sums
// int64[k], zeroed by the caller.
extern "C" int sss_agg_lookup(const uint32_t* ptiles, const uint32_t* mtiles,
                              const uint32_t* keys, int k, long long* counts, long long* sums,
                              long long nblocks, int wp, int wm, long long n,
                              long long block_offset, cudaStream_t stream) {
  if (!sss::agg_lookup_args_ok(k, wp, wm)) return (int)cudaErrorInvalidValue;
  if (nblocks <= 0) return (int)cudaSuccess;
  sss::AggKeys hk{};
  for (int j = 0; j < k; ++j) hk.key[j] = keys[j];
  int shift = 0;
  const int lookup = sss::agg_lookup_plan(hk, k, wp, &shift);
  return (int)sss::launch_agg_lookup(ptiles, mtiles, hk, k, wp, wm, lookup, shift,
                                     reinterpret_cast<unsigned long long*>(counts),
                                     reinterpret_cast<unsigned long long*>(sums), nblocks, n,
                                     block_offset, stream);
}

// keys: k uint32 in device memory, never read on the host; counts, mins and
// maxs int64[k], set by the caller to 0, 0x7FFFFFFF and -1 (what a key that
// no real value holds keeps).  The byte table up to kLookupTableBits, past
// it kMinMaxWideLookup.
extern "C" int sss_minmax_lookup(const uint32_t* ptiles, const uint32_t* mtiles,
                                 const uint32_t* keys, int k, long long* counts, long long* mins,
                                 long long* maxs, long long nblocks, int wp, int wm, long long n,
                                 long long block_offset, cudaStream_t stream) {
  if (!sss::agg_lookup_args_ok(k, wp, wm)) return (int)cudaErrorInvalidValue;
  if (nblocks <= 0) return (int)cudaSuccess;
  const int lookup = wp <= sss::kLookupTableBits ? sss::kByteTable : sss::kMinMaxWideLookup;
  return (int)sss::launch_minmax_lookup(ptiles, mtiles, keys, k, wp, wm, lookup,
                                        reinterpret_cast<unsigned long long*>(counts), mins, maxs,
                                        nblocks, n, block_offset, stream);
}

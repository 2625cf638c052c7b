// The zoned range scan's designs side by side, for bench/redesign_sweep.py
// (section zoned) to time on the card.  Not part of the kernel library: it
// includes the library's zoned.cu for its C entry (the rows and counts
// zeroed by memsets on the stream, then a flat grid of (entry, tile of its
// step), a thread a block) and adds:
//   - one launch that writes every word itself: zero-filling CTAs, 1-8 a
//     multiprocessor, each over a span of the rows, read the entries into
//     a table of their span's steps and store zeros over the unlisted
//     ones -- one warp issuing bulk copies of zeroed shared memory, or a
//     warp a block row storing 16 bytes a lane from registers -- beside
//     the library's grid of listed tiles;
//   - CTAs that walk the rows in address order, a run of 1-16 tiles each:
//     each reads the entries into a table of its run's steps, stores zeros
//     over its tiles with no listed block and computes the others, loading
//     their words itself or through a TMA ring of two stages;
//   - the same walk on a step table built on the card first (a memset of
//     the table and a launch over the entries), so no CTA reads the entries.
// Widths 9 and 31.
#include "../csrc/zoned.cu"

namespace sss {

constexpr int kZonedThreads = kThreads;  // blocks of a tile
constexpr int kZonedFillSteps = 1024;  // steps a zero-filling CTA's table holds
constexpr int kZeroBytes = 16 * 1024;  // the zeros a bulk store writes at most

// Zero-filling CTA `cta`'s span of block rows [r0, r1) and the steps it
// meets, s_lo .. s_lo + nsteps - 1, with s_listed[i] set where an entry
// names step s_lo + i.  False, before any barrier, for an empty span; true
// with the table complete.
__device__ __forceinline__ bool listed_steps(const int* __restrict__ idx, int g, long long cta,
                                             long long nblocks, long long step_blocks,
                                             long long fill_rows, unsigned* s_listed,
                                             long long& r0, long long& r1, long long& s_lo,
                                             int& nsteps) {
  r0 = cta * fill_rows;
  r1 = min(r0 + fill_rows, nblocks / kStepAlign);
  if (r0 >= r1) return false;
  s_lo = r0 * kStepAlign / step_blocks;
  nsteps = (int)((r1 * kStepAlign - 1) / step_blocks - s_lo + 1);
  for (int i = threadIdx.x; i < nsteps; i += blockDim.x) s_listed[i] = 0u;
  __syncthreads();
  for (int e = threadIdx.x; e < g; e += blockDim.x) {
    const long long s = (long long)__ldg(idx + e) - s_lo;
    if (s >= 0 && s < nsteps) s_listed[s] = 1u;
  }
  __syncthreads();
  return true;
}

// One launch that writes every word: nfill zero-filling CTAs (kBulk: one
// warp's bulk copies of kZeroBytes of zeroed shared memory; else a warp a
// block row, 16 bytes a lane from registers), then the library's grid of
// listed tiles.  No word has two writers of different values.
template <int W, bool kBulk>
__global__ void __launch_bounds__(kZonedThreads)
zoned_fill_kernel(const uint32_t* __restrict__ tiles, const int* __restrict__ idx,
                  const int* __restrict__ flag, int g, int tiles_per_step,
                  const uint32_t* __restrict__ lows, const uint32_t* __restrict__ highs, int k,
                  uint32_t* __restrict__ bits, unsigned long long* __restrict__ counts,
                  long long nblocks, long long step_blocks, long long n, int nfill,
                  long long fill_rows) {
  // a listed tile's counters, or a zero-filling CTA's table of listed steps
  __shared__ unsigned s_buf[kMaxKeys > kZonedFillSteps ? kMaxKeys : kZonedFillSteps];
  extern __shared__ __align__(128) uint4 s_zero[];  // kZeroBytes of zeros (kBulk)
  if ((int)blockIdx.x >= nfill) {
    zoned_tile<W>((int)blockIdx.x - nfill, tiles, idx, flag, tiles_per_step, lows, highs, k, bits,
                  counts, nblocks, step_blocks, n, s_buf);
    return;
  }
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (kBulk) {
    for (int i = threadIdx.x; i < kZeroBytes / 16; i += blockDim.x) s_zero[i] = zero;
    // the zeros written through the generic proxy, before the bulk stores read them
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  long long r0, r1, s_lo;
  int nsteps;
  if (!listed_steps(idx, g, blockIdx.x, nblocks, step_blocks, fill_rows, s_buf, r0, r1, s_lo,
                    nsteps))
    return;
  if constexpr (kBulk) {
    if (threadIdx.x >= 32) return;
    // lane l stores rows l, l + 32, ... of each unlisted step's part of the span
    const long long rows_per_step = step_blocks / kStepAlign;
    for (int i = 0; i < nsteps; ++i) {
      if (s_buf[i]) continue;
      const long long a = max(r0, (s_lo + i) * rows_per_step);
      const long long z = min(r1, (s_lo + i + 1) * rows_per_step);
      const long long len = (z - a) * kStepAlign * 4;
      for (int j = threadIdx.x; j < k; j += 32) {
        uint8_t* dst = reinterpret_cast<uint8_t*>(bits + (size_t)j * nblocks + a * kStepAlign);
        for (long long off = 0; off < len; off += kZeroBytes)
          bulk_store(dst + off, s_zero, (uint32_t)min(len - off, (long long)kZeroBytes));
      }
    }
    bulk_wait_all();
  } else {
    for (long long r = r0 + (threadIdx.x >> 5); r < r1; r += blockDim.x >> 5) {
      if (s_buf[r * kStepAlign / step_blocks - s_lo]) continue;
      for (int j = 0; j < k; ++j)
        reinterpret_cast<uint4*>(bits + (size_t)j * nblocks + r * kStepAlign)[threadIdx.x & 31] =
            zero;
    }
  }
}

template <int W, bool kBulk>
cudaError_t launch_zoned_fill(const uint32_t* tiles, const int* idx, const int* flag, int g,
                              const uint32_t* lows, const uint32_t* highs, int k, uint32_t* bits,
                              unsigned long long* counts, long long nblocks,
                              long long step_blocks, long long n, int fill_per_sm,
                              cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long rows = nblocks / kStepAlign;
  // a span meets at most fill_rows + 1 steps, which the CTA's table holds
  const long long least = (rows + kZonedFillSteps - 2) / (kZonedFillSteps - 1);
  long long nfill = (long long)sms * fill_per_sm;
  if (nfill < least) nfill = least;
  const long long fill_rows = (rows + nfill - 1) / nfill;
  nfill = (rows + fill_rows - 1) / fill_rows;
  const long long per = (step_blocks + kZonedThreads - 1) / kZonedThreads;
  zoned_fill_kernel<W, kBulk><<<(unsigned)(nfill + per * g), kZonedThreads,
                                kBulk ? kZeroBytes : 0, stream>>>(
      tiles, idx, flag, g, (int)per, lows, highs, k, bits, counts, nblocks, step_blocks, n,
      (int)nfill, fill_rows);
  return cudaGetLastError();
}

constexpr int kZonedMaxRun = 16;  // tiles of a CTA's run
constexpr int kZonedMaxSteps = (int)(kZonedMaxRun * kZonedThreads / kStepAlign);
constexpr int kZonedStages = 2;  // ring stages of the TMA form

// Zeros over blocks [first, end) of each of the k rows, a warp storing 16
// bytes a lane over 128 blocks at a time (spans are whole block rows).
__device__ __forceinline__ void zero_rows(uint32_t* __restrict__ bits, int k, long long nblocks,
                                          long long first, long long end) {
  const int chunks = (int)((end - first) / kStepAlign);
  const int total = k * chunks;
  const int warps = blockDim.x >> 5, lane = threadIdx.x & 31;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int c = threadIdx.x >> 5; c < total; c += warps) {
    const int j = c / chunks, q = c - j * chunks;
    reinterpret_cast<uint4*>(bits + (size_t)j * nblocks + first + kStepAlign * q)[lane] = zero;
  }
}

// Position of the i-th set bit of m (from 0), or -1.
__device__ __forceinline__ int nth_set_bit(unsigned m, int i) {
  for (; i > 0 && m; --i) m &= m - 1u;
  return m ? __ffs(m) - 1 : -1;
}

template <int W, bool kTma>
__global__ void __launch_bounds__(kZonedThreads)
zoned_rows_kernel(const __grid_constant__ CUtensorMap map, const uint32_t* __restrict__ tiles,
                  const int* __restrict__ idx, const int* __restrict__ flag, int g,
                  const uint32_t* __restrict__ lows, const uint32_t* __restrict__ highs, int k,
                  uint32_t* __restrict__ bits, unsigned long long* __restrict__ counts,
                  long long nblocks, long long step_blocks, long long n, int run) {
  constexpr int T = kZonedThreads;
  // the ring (TMA form), then k 64-bit counters: a count times its step's
  // flag-1 entries may pass 2^32
  extern __shared__ __align__(128) uint32_t s_dyn[];
  __shared__ __align__(8) uint64_t s_full[kZonedStages];
  __shared__ int s_listed[kZonedMaxSteps], s_mult[kZonedMaxSteps];
  __shared__ unsigned s_live;  // bit t: tile t of the run holds a block of a listed step
  unsigned long long* s_cnt =
      reinterpret_cast<unsigned long long*>(s_dyn + (kTma ? kZonedStages * W * T : 0));
  const long long first = (long long)blockIdx.x * run * T;
  const long long end = min(first + (long long)run * T, nblocks);
  const long long s0 = first / step_blocks;
  const int nsteps = (int)((end - 1) / step_blocks - s0 + 1);
  const int ntiles = (int)((end - first + T - 1) / T);

  for (int i = threadIdx.x; i < nsteps; i += T) s_listed[i] = s_mult[i] = 0;
  if (threadIdx.x == 0) s_live = 0u;
  __syncthreads();
  for (int e = threadIdx.x; e < g; e += T) {
    const long long s = (long long)__ldg(idx + e) - s0;
    if (s >= 0 && s < nsteps) {
      s_listed[s] = 1;
      if (__ldg(flag + e) == 1) atomicAdd(&s_mult[s], 1);
    }
  }
  __syncthreads();
  if (threadIdx.x < ntiles) {
    const long long a = first + (long long)threadIdx.x * T;
    const long long z = min(a + T, end) - 1;
    int any = 0;
    for (long long s = a / step_blocks; s <= z / step_blocks; ++s) any |= s_listed[s - s0];
    if (any) atomicOr(&s_live, 1u << threadIdx.x);
  }
  __syncthreads();
  const unsigned live = s_live;  // CTA-uniform
  if (live == 0u) {
    zero_rows(bits, k, nblocks, first, end);
    return;
  }

  for (int j = threadIdx.x; j < k; j += T) s_cnt[j] = 0ull;
  const CUtensorMap* tmap = &map;
  auto issue = [&](int nth, int stage) {  // the nth listed tile into a ring stage
    const int t = nth_set_bit(live, nth);
    if (t < 0) return;
    // order the threads' reads of the stage before the async proxy's writes
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_expect_tx(&s_full[stage], W * T * 4);  // the whole box, zeros past nblocks included
    tile_map_load(s_dyn + stage * W * T, tmap, first + (long long)t * T, &s_full[stage]);
  };
  if constexpr (kTma) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kZonedStages; ++s) mbar_init(&s_full[s], 1u);
      mbar_init_fence();
      for (int s = 0; s < kZonedStages; ++s) issue(s, s);
    }
  }
  __syncthreads();
  int used = 0;  // listed tiles taken
#pragma unroll 1
  for (int t = 0; t < ntiles;) {  // CTA-uniform
    const unsigned ahead = live >> t;
    if (!(ahead & 1u)) {
      const int u = ahead ? t + __ffs(ahead) - 1 : ntiles;
      zero_rows(bits, k, nblocks, first + (long long)t * T, min(first + (long long)u * T, end));
      t = u;
      continue;
    }
    const long long b = first + (long long)t * T + threadIdx.x;
    const bool active = b < end;
    const int step = active ? (int)(b / step_blocks - s0) : 0;
    const bool listed = active && s_listed[step];
    // warp-uniform: a warp's 32 blocks lie in one step
    const unsigned mult = listed ? (unsigned)s_mult[step] : 0u;
    uint32_t w[W];
    if constexpr (kTma) {
      const int stage = used % kZonedStages;
      mbar_wait(&s_full[stage], (uint32_t)((used / kZonedStages) & 1));
      const uint32_t* st = s_dyn + stage * W * T + threadIdx.x;
#pragma unroll
      for (int j = 0; j < W; ++j) w[j] = st[j * T];
      __syncthreads();  // every thread has read the stage
      if (threadIdx.x == 0) issue(used + kZonedStages, stage);
    } else {
#pragma unroll
      for (int j = 0; j < W; ++j) w[j] = listed ? __ldg(tiles + (size_t)j * nblocks + b) : 0u;
    }
    ++used;
    const uint32_t valid = listed ? valid_word(b, n) : 0u;
    uint32_t v[kBlockValues];
    unpack_values<W>(w, v);
    for (int j = 0; j < k; ++j) {
      const uint32_t lo = __ldg(lows + j);
      const uint32_t word = range_word(v, lo, __ldg(highs + j) - lo) & valid;
      if (active) bits[(size_t)j * nblocks + b] = word;
      const unsigned c = __reduce_add_sync(0xFFFFFFFFu, (unsigned)__popc(word));
      if ((threadIdx.x & 31) == 0 && c && mult) atomicAdd(s_cnt + j, (unsigned long long)c * mult);
    }
    ++t;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += T)
    if (s_cnt[j]) atomicAdd(counts + j, s_cnt[j]);
}


// One launch of the row kernel: a CTA for every `run` tiles.
template <int W, bool kTma>
cudaError_t launch_zoned_rows(const uint32_t* tiles, const int* idx, const int* flag, int g,
                              const uint32_t* lows, const uint32_t* highs, int k, uint32_t* bits,
                              unsigned long long* counts, long long nblocks, long long step_blocks,
                              long long n, int run, cudaStream_t stream) {
  if (run < 1 || run > kZonedMaxRun) return cudaErrorInvalidValue;
  const auto kernel = zoned_rows_kernel<W, kTma>;
  const size_t smem =
      (kTma ? tile_ring_bytes(W, kZonedThreads, kZonedStages) : 0) + (size_t)k * 8;
  const long long per = (long long)run * kZonedThreads;
  const long long grid = (nblocks + per - 1) / per;
  if (grid > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  CUtensorMap map{};
  cudaError_t err = kTma ? tile_map(&map, tiles, W, nblocks, kZonedThreads) : cudaSuccess;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return err;
  }
  kernel<<<(unsigned)grid, kZonedThreads, smem, stream>>>(map, tiles, idx, flag, g, lows, highs, k,
                                                          bits, counts, nblocks, step_blocks, n,
                                                          run);
  return cudaGetLastError();
}


// table[s]: step s's entries (low word) and flag-1 entries (high word).
__global__ void step_table_kernel(const int* __restrict__ idx, const int* __restrict__ flag, int g,
                                  unsigned long long* __restrict__ table, long long steps) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= g) return;
  const long long s = idx[e];
  if (s >= 0 && s < steps)
    atomicAdd(table + s, 1ull | (unsigned long long)(flag[e] == 1) << 32);
}

template <int W>
__global__ void __launch_bounds__(kZonedThreads)
zoned_table_kernel(const uint32_t* __restrict__ tiles,
                   const unsigned long long* __restrict__ table,
                   const uint32_t* __restrict__ lows, const uint32_t* __restrict__ highs, int k,
                   uint32_t* __restrict__ bits, unsigned long long* __restrict__ counts,
                   long long nblocks, long long step_blocks, long long n, int run) {
  extern __shared__ unsigned long long s_cnt64[];
  for (int j = threadIdx.x; j < k; j += blockDim.x) s_cnt64[j] = 0ull;
  __syncthreads();
  const long long first = (long long)blockIdx.x * run * kZonedThreads + threadIdx.x;
  unsigned long long entry[kZonedMaxRun];
#pragma unroll
  for (int t = 0; t < kZonedMaxRun; ++t) {  // every tile's step entry in flight at once
    const long long b = first + (long long)t * kZonedThreads;
    entry[t] = t < run && b < nblocks ? __ldg(table + b / step_blocks) : 0ull;
  }
#pragma unroll
  for (int t = 0; t < kZonedMaxRun; ++t) {
    const long long b = first + (long long)t * kZonedThreads;
    if (t >= run || b >= nblocks) break;  // warp-uniform: nblocks is a multiple of 128
    const bool listed = (uint32_t)entry[t] != 0u;
    const unsigned mult = (unsigned)(entry[t] >> 32);
    uint32_t w[W];
#pragma unroll
    for (int j = 0; j < W; ++j) w[j] = listed ? __ldg(tiles + (size_t)j * nblocks + b) : 0u;
    const uint32_t valid = listed ? valid_word(b, n) : 0u;
    uint32_t v[kBlockValues];
    unpack_values<W>(w, v);
    for (int j = 0; j < k; ++j) {
      const uint32_t lo = __ldg(lows + j);
      const uint32_t word = range_word(v, lo, __ldg(highs + j) - lo) & valid;
      bits[(size_t)j * nblocks + b] = word;
      const unsigned c = __reduce_add_sync(0xFFFFFFFFu, (unsigned)__popc(word));
      if ((threadIdx.x & 31) == 0 && c && mult)
        atomicAdd(s_cnt64 + j, (unsigned long long)c * mult);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x)
    if (s_cnt64[j]) atomicAdd(counts + j, s_cnt64[j]);
}

template <int W>
cudaError_t sweep_zoned_width(int variant, int run, const uint32_t* tiles, const int* idx,
                              const int* flag, int g, const uint32_t* lows,
                              const uint32_t* highs, int k, uint32_t* bits,
                              unsigned long long* counts, unsigned long long* table,
                              long long nblocks, long long step_blocks, long long n,
                              cudaStream_t stream) {
  if (variant == 0)
    return (cudaError_t)sss_zoned_range_scan(tiles, idx, flag, g, lows, highs, k, bits, counts,
                                             nblocks, step_blocks, W, n, stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, (size_t)k * 8, stream);
  if (err != cudaSuccess) return err;
  if (variant == 1 || variant == 2)
    return variant == 1 ? launch_zoned_rows<W, false>(tiles, idx, flag, g, lows, highs, k, bits,
                                                      counts, nblocks, step_blocks, n, run, stream)
                        : launch_zoned_rows<W, true>(tiles, idx, flag, g, lows, highs, k, bits,
                                                     counts, nblocks, step_blocks, n, run, stream);
  if (variant == 4 || variant == 5)
    return variant == 4
               ? launch_zoned_fill<W, false>(tiles, idx, flag, g, lows, highs, k, bits, counts,
                                             nblocks, step_blocks, n, run, stream)
               : launch_zoned_fill<W, true>(tiles, idx, flag, g, lows, highs, k, bits, counts,
                                            nblocks, step_blocks, n, run, stream);
  if (variant != 3 || run < 1 || run > kZonedMaxRun) return cudaErrorInvalidValue;
  const long long steps = nblocks / step_blocks;
  err = cudaMemsetAsync(table, 0, (size_t)steps * 8, stream);
  if (err != cudaSuccess) return err;
  step_table_kernel<<<(g + 255) / 256, 256, 0, stream>>>(idx, flag, g, table, steps);
  const long long per = (long long)run * kZonedThreads;
  const size_t smem = (size_t)k * 8;
  err = cudaFuncSetAttribute(zoned_table_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  zoned_table_kernel<W><<<(unsigned)((nblocks + per - 1) / per), kZonedThreads, smem, stream>>>(
      tiles, table, lows, highs, k, bits, counts, nblocks, step_blocks, n, run);
  return cudaGetLastError();
}

}  // namespace sss

// variant 0: the library's C entry (memsets of the rows and counts, the
// flat grid); 1: the walk in runs, loads by its threads; 2: the walk in
// runs, the TMA ring; 3: the walk on a step table built first (table:
// uint64[nblocks / step_blocks] scratch); 4 and 5: one launch, zero-filling
// CTAs beside the flat grid, their zeros by 16-byte stores of registers or
// by bulk stores of zeroed shared memory.  run: tiles a CTA (1-16;
// variants 4 and 5: zero-filling CTAs a multiprocessor).
extern "C" int sweep_zoned(int variant, int run, const uint32_t* tiles, const int* idx,
                           const int* flag, int g, const uint32_t* lows, const uint32_t* highs,
                           int k, uint32_t* bits, unsigned long long* counts,
                           unsigned long long* table, long long nblocks, long long step_blocks,
                           int width, long long n, cudaStream_t stream) {
  if (g < 1 || k < 1 || k > sss::kMaxKeys || step_blocks % sss::kStepAlign ||
      nblocks % sss::kStepAlign)
    return (int)cudaErrorInvalidValue;
  switch (width) {
    case 9:
      return (int)sss::sweep_zoned_width<9>(variant, run, tiles, idx, flag, g, lows, highs, k,
                                            bits, counts, table, nblocks, step_blocks, n, stream);
    case 31:
      return (int)sss::sweep_zoned_width<31>(variant, run, tiles, idx, flag, g, lows, highs, k,
                                             bits, counts, table, nblocks, step_blocks, n,
                                             stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

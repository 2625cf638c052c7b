// Shared pieces of the Hopper kernels: the static unpack schedule, the
// validity word, count and exact-sum reduction, the one-hot mask, the 8x8
// byte transpose, the bit-plane butterfly, the range match word, the grid
// of resident CTAs, bulk and TMA copies with their mbarriers, the staged
// tile loop, and the width dispatch.
//
// Layout (see shared_simd_scan_tpu_torch/layout.py): tiles are
// uint32[width][nblocks] with nblocks = B1*128; block b holds 32 values in
// `width` words at tiles[j*nblocks + b].  Every kernel gives one thread one
// block, so a warp's loads and stores of one row are 32 consecutive words.
#pragma once

#include <atomic>
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace sss {

constexpr int kBlockValues = 32;
constexpr int kThreads = 256;
constexpr int kMaxKeys = 1024;  // keys per launch: bounds the shared counters
constexpr int kMaxAggKeys = 32;  // keys of one aggregate launch
constexpr int kMaxHistKeys = 4096;  // bins of one histogram launch (16 KB of counters)

// Static schedule of layout.unpack_schedule: value r starts at stream bit
// r*W, i.e. in word r*W/32 at shift r*W%32, and straddles into the next
// word when shift + W > 32.  All three fold to constants once the r loop
// is unrolled and W is a template argument.
template <int W> __device__ __forceinline__ constexpr int slot_word(int r) { return (r * W) >> 5; }
template <int W> __device__ __forceinline__ constexpr int slot_shift(int r) { return (r * W) & 31; }
template <int W> __device__ __forceinline__ constexpr bool slot_straddles(int r) {
  return slot_shift<W>(r) + W > 32;
}
template <int W> __device__ __forceinline__ constexpr uint32_t value_mask() { return (1u << W) - 1u; }

// The block's W words; zeros for a thread past the end of the tiles.
template <int W>
__device__ __forceinline__ void load_block(const uint32_t* __restrict__ tiles, long long nblocks,
                                           long long b, bool active, uint32_t (&w)[W]) {
#pragma unroll
  for (int j = 0; j < W; ++j) w[j] = active ? __ldg(tiles + (size_t)j * nblocks + b) : 0u;
}

// Value r (0..31) of the block: (w[k] >> s | w[k+1] << (32-s)) & mask.
template <int W>
__device__ __forceinline__ uint32_t unpack_value(const uint32_t (&w)[W], int r) {
  const int k = slot_word<W>(r), s = slot_shift<W>(r);
  uint32_t v = w[k] >> s;
  // (the index guard only keeps non-straddling slots' dead code in bounds)
  if (slot_straddles<W>(r)) v |= w[k + 1 < W ? k + 1 : k] << (32 - s);
  return v & value_mask<W>();
}

// All 32 values of the block, in registers.
template <int W>
__device__ __forceinline__ void unpack_values(const uint32_t (&w)[W], uint32_t (&v)[kBlockValues]) {
#pragma unroll
  for (int r = 0; r < kBlockValues; ++r) v[r] = unpack_value<W>(w, r);
}

// Bits of global block g that hold real values (value index < n), so key 0
// never matches the zero padding.
__device__ __forceinline__ uint32_t valid_word(long long g, long long n) {
  const long long full = n >> 5;
  const int rem = (int)(n & 31);
  if (g < full) return 0xFFFFFFFFu;
  if (g == full && rem) return (1u << rem) - 1u;
  return 0u;
}

// Per-CTA hit counters: every warp adds its popcount of a row into shared
// memory; flush_counts adds each key's CTA total to the int64 counts with
// one atomic.  Integer sums do not depend on order: the result is exact.
__device__ __forceinline__ void zero_counts(unsigned* s_cnt, int k) {
  for (int j = threadIdx.x; j < k; j += blockDim.x) s_cnt[j] = 0u;
  __syncthreads();
}

// Count the set bits of row j of this block.  Must be reached by all 32
// lanes of the warp (j is warp-uniform).
__device__ __forceinline__ void count_row(int j, uint32_t word, unsigned* s_cnt) {
  const unsigned c = __reduce_add_sync(0xFFFFFFFFu, (unsigned)__popc(word));
  if ((threadIdx.x & 31) == 0 && c) atomicAdd(s_cnt + j, c);
}

// Store row j of this block and count it, as count_row; inactive lanes
// store nothing.
__device__ __forceinline__ void store_row(uint32_t* __restrict__ bits, long long nblocks,
                                          long long b, bool active, int j, uint32_t word,
                                          unsigned* s_cnt) {
  if (active) bits[(size_t)j * nblocks + b] = word;
  count_row(j, word, s_cnt);
}

// Count rows j..j+3 of this block as count_row does, two rows to a warp
// reduce: a row's warp total is at most 1024, so two fit the halves of one
// word.  Must be reached by all 32 lanes of the warp (j is warp-uniform).
__device__ __forceinline__ void count_quad(int j, uint32_t r0, uint32_t r1, uint32_t r2,
                                           uint32_t r3, unsigned* s_cnt) {
  const unsigned c01 = __reduce_add_sync(0xFFFFFFFFu, __popc(r0) | __popc(r1) << 16);
  const unsigned c23 = __reduce_add_sync(0xFFFFFFFFu, __popc(r2) | __popc(r3) << 16);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(s_cnt + j, c01 & 0xFFFFu);
    atomicAdd(s_cnt + j + 1, c01 >> 16);
    atomicAdd(s_cnt + j + 2, c23 & 0xFFFFu);
    atomicAdd(s_cnt + j + 3, c23 >> 16);
  }
}

__device__ __forceinline__ void flush_counts(const unsigned* s_cnt, int k,
                                             unsigned long long* __restrict__ counts) {
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x)
    if (s_cnt[j]) atomicAdd(counts + j, (unsigned long long)s_cnt[j]);
}

// a << d through PTX shl.b32, which gives 0 for d >= 32 (C++ << leaves
// that undefined); the shift canary checks it on the card.
__device__ __forceinline__ uint32_t shl_ptx(uint32_t a, uint32_t d) {
  uint32_t r;
  asm("shl.b32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(d));
  return r;
}

// Match mask 1 << d, 0 for d >= 32: gateless through PTX when the canary
// saw it saturate, else gated.
template <bool kGateless>
__device__ __forceinline__ uint32_t onehot(uint32_t d) {
  if constexpr (kGateless) return shl_ptx(1u, d);
  else return d < 32u ? 1u << (d & 31u) : 0u;
}

// Swap bits of a at positions p+s with bits of b at p (p in m).
__device__ __forceinline__ void swapmove(uint32_t& a, uint32_t& b, uint32_t m, int s) {
  const uint32_t t = ((a >> s) ^ b) & m;
  a ^= t << s;
  b ^= t;
}

// Bit-slice 8x8 transpose over four independent byte channels: byte g,
// bit u of x[t] -> byte g, bit t of x[u].
__device__ __forceinline__ void transpose8x8_bytes(uint32_t (&x)[8]) {
  swapmove(x[0], x[1], 0x55555555u, 1);
  swapmove(x[2], x[3], 0x55555555u, 1);
  swapmove(x[4], x[5], 0x55555555u, 1);
  swapmove(x[6], x[7], 0x55555555u, 1);
  swapmove(x[0], x[2], 0x33333333u, 2);
  swapmove(x[1], x[3], 0x33333333u, 2);
  swapmove(x[4], x[6], 0x33333333u, 2);
  swapmove(x[5], x[7], 0x33333333u, 2);
  swapmove(x[0], x[4], 0x0F0F0F0Fu, 4);
  swapmove(x[1], x[5], 0x0F0F0F0Fu, 4);
  swapmove(x[2], x[6], 0x0F0F0F0Fu, 4);
  swapmove(x[3], x[7], 0x0F0F0F0Fu, 4);
}

// Bit-plane butterfly: 32 values -> bit planes (plane p, bit r = bit p of
// value r) in 5 SWAPMOVE stages of shift 16, 8, 4, 2, 1, pruned to the W
// live planes as the JAX package's _transpose_bitplanes prunes it: a pair
// with no live output is skipped, a pair with one takes a one-sided merge.
// Stage masks and liveness are constants, so the pruning is compile-time.
constexpr int kStages = 5;

__host__ __device__ constexpr int stage_shift(int s) { return 16 >> s; }

__host__ __device__ constexpr uint32_t stage_mask(int s) {
  uint32_t m = 0x0000FFFFu;
  for (int i = 1; i <= s; ++i) m ^= m << stage_shift(i);
  return m;
}

// Indices of x live after stage s, when planes 0..W-1 are the outputs.
template <int W>
__host__ __device__ constexpr uint32_t live_after(int s) {
  uint32_t live = (W >= 32) ? 0xFFFFFFFFu : (1u << W) - 1u;
  for (int t = kStages - 1; t > s; --t) {
    const int j = stage_shift(t);
    uint32_t before = 0u;
    for (int i = 0; i < 32; ++i)
      if (((live >> (i & ~j)) & 1u) || ((live >> ((i & ~j) | j)) & 1u)) before |= 1u << i;
    live = before;
  }
  return live;
}

template <int W, int S>
__device__ __forceinline__ void butterfly_stage(uint32_t (&x)[kBlockValues]) {
  constexpr int j = stage_shift(S);
  constexpr uint32_t m = stage_mask(S);
  constexpr uint32_t live = live_after<W>(S);
#pragma unroll
  for (int i = 0; i < kBlockValues; ++i) {
    if (i & j) continue;
    const bool a_live = (live >> i) & 1u, b_live = (live >> (i + j)) & 1u;
    if (a_live && b_live) swapmove(x[i], x[i + j], m, j);
    else if (a_live) x[i] = (x[i] & ~(m << j)) | ((x[i + j] & m) << j);
    else if (b_live) x[i + j] = (x[i + j] & ~m) | ((x[i] >> j) & m);
  }
}

// In place: x[p] for p < W becomes bit plane p of the 32 values in x.
template <int W>
__device__ __forceinline__ void transpose_bitplanes(uint32_t (&x)[kBlockValues]) {
  butterfly_stage<W, 0>(x);
  butterfly_stage<W, 1>(x);
  butterfly_stage<W, 2>(x);
  butterfly_stage<W, 3>(x);
  butterfly_stage<W, 4>(x);
}

inline unsigned grid_for(long long nblocks) {
  return (unsigned)((nblocks + kThreads - 1) / kThreads);
}

// The current device's SMs, asked of the runtime once per device (a
// launch's grid is sized from them on every call).
inline cudaError_t sm_count(int* sms) {
  constexpr int kDevices = 64;
  static std::atomic<int> known[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev >= 0 && dev < kDevices;
  if (cached && (*sms = known[dev].load(std::memory_order_relaxed)) > 0) return cudaSuccess;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (*sms < 1) *sms = 1;
  if (cached) known[dev].store(*sms, std::memory_order_relaxed);
  return cudaSuccess;
}

// Grid of a kernel whose CTAs loop over its `ntiles` tiles of blockDim.x
// blocks (tile t, t + gridDim.x, ...): as many CTAs as the card holds at
// once, fewer when there are fewer tiles.  Each CTA then flushes its shared
// counters once, not once per tile.
template <typename Kernel>
inline cudaError_t resident_grid(Kernel kernel, int threads, size_t smem, long long ntiles,
                                 unsigned* grid) {
  int sms = 0, per_sm = 0;
  cudaError_t err = sm_count(&sms);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  *grid = (unsigned)(ntiles < cap ? ntiles : cap);
  return cudaSuccess;
}

// The fewest CTAs of `threads` threads that take `ntiles` tiles with fewer
// than 2^32 values each, so a CTA's unsigned shared counters cannot wrap.
inline long long least_ctas(long long ntiles, int threads) {
  const long long tiles_per_cta = (1LL << 32) / ((long long)threads * kBlockValues) - 1;
  return (ntiles + tiles_per_cta - 1) / tiles_per_cta;
}

// Bulk copies (cp.async.bulk, the TMA's non-tensor form) and the mbarriers
// that report them and the TMA's tensor copies: the copy's ring (copy.cu)
// and the staged tile loop below.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Make the barriers' initialization visible to the async proxy (the bulk
// copies) before any copy signals them.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrive once and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the barrier's phase of parity `parity` has completed.  A
// phase that never completes is a fault: trap (the launch fails) rather
// than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0u;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 26)) __trap();
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// Global -> shared, completion reported to `bar` as transaction bytes.
__device__ __forceinline__ void bulk_load(void* smem, const void* gmem, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(smem)), "l"(gmem), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Shared -> global, as one bulk group.
__device__ __forceinline__ void bulk_store(void* gmem, const void* smem, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(gmem),
               "r"(smem_u32(smem)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Wait until at most N bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// Wait until every bulk group has completed (its writes done).
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// The staged tile loop of a scan that gives one thread one block: CTAs of
// T threads walk tiles of T consecutive blocks -- a run of consecutive
// tiles each, or on a resident grid tile t, t + gridDim.x, ... -- and each
// tile's W rows reach shared memory ahead of use.  The tiles [W][nblocks]
// are a 2-D TMA tensor map with a box of [W rows, T blocks] (tile_map
// below): thread 0 fills a stage of the ring with one tensor copy that
// signals the stage's mbarrier, so kStages - 1 tiles
// are on their way while the CTA computes on one, and the ragged last
// tile's blocks past nblocks arrive as zeros.  Each thread reads its
// block's W words from the stage (a warp's 32 lanes on 32 banks), the CTA
// syncs, the stage is refilled with the tile kStages on, and `body(w, b,
// active)` runs on the words in registers (a thread past nblocks: active
// false).  Every tile issued is waited for, so no copy is in flight when
// the loop returns.  Shared memory: kStages * W * T words (the ring, from
// tile_ring_bytes) and kStages barriers, both the caller's.  W bulk copies
// of a tile's rows (cp.async.bulk, 4T bytes each) ran 2-6% slower at width
// 9 (bench/redesign_sweep.py interval and compare).
__device__ __forceinline__ void tile_map_load(uint32_t* stage, const CUtensorMap* map,
                                              long long first, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(stage)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"((int)first), "r"(0), "r"(smem_u32(bar))
      : "memory");
}

template <int W, int T, int kStages, typename Body>
__device__ __forceinline__ void staged_tiles(const CUtensorMap* map, long long nblocks,
                                             long long run, uint32_t* s_ring, uint64_t* s_full,
                                             Body&& body) {
  const long long ntiles = (nblocks + T - 1) / T;
  // run > 0: this CTA's tiles are the run blockIdx.x * run, ... (in address
  // order, as the CTAs are dispatched); run 0: tiles blockIdx.x, blockIdx.x
  // + gridDim.x, ... on a resident grid
  const long long base = run ? (long long)blockIdx.x * run : (long long)blockIdx.x;
  const long long step = run ? 1 : (long long)gridDim.x;
  long long count = base < ntiles ? (ntiles - 1 - base) / step + 1 : 0;
  if (run && count > run) count = run;
  auto issue = [&](long long tile, int s) {
    mbar_expect_tx(&s_full[s], W * T * 4);  // the whole box, zeros past nblocks included
    tile_map_load(s_ring + s * W * T, map, tile * T, &s_full[s]);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&s_full[s], 1u);
    mbar_init_fence();
    for (int s = 0; s < kStages && s < count; ++s) issue(base + s * step, s);
  }
  __syncthreads();  // the barriers are initialized
#pragma unroll 1
  for (long long i = 0; i < count; ++i) {  // CTA-uniform trip count
    const int s = (int)(i % kStages);
    const long long tile = base + i * step;
    const long long b = tile * T + threadIdx.x;
    mbar_wait(&s_full[s], (uint32_t)((i / kStages) & 1));
    const uint32_t* st = s_ring + s * W * T + threadIdx.x;
    uint32_t w[W];
#pragma unroll
    for (int j = 0; j < W; ++j) w[j] = st[j * T];
    __syncthreads();  // every thread has read the stage
    if (threadIdx.x == 0 && i + kStages < count) {
      // order the reads above before the async proxy's writes into the stage
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      issue(tile + kStages * step, s);
    }
    body(w, b, b < nblocks);
  }
}

// Dynamic shared memory of the staged tile loop's ring.
inline size_t tile_ring_bytes(int width, int threads, int stages) {
  return (size_t)stages * width * threads * 4;
}

// The tensor map of tiles uint32[width][nblocks] with a box of [width,
// threads], built by libcuda's cuTensorMapEncodeTiled (its entry point
// found once through the runtime, so the library needs no -lcuda); rows ld
// words apart where ld > 0 (a span of longer rows), else nblocks.  The TMA
// wants the tiles 16-byte aligned, row strides of a multiple of 16 bytes
// (the port's, 4 nblocks bytes, are multiples of 512) and coordinates below
// 2^31; anything else is refused.
inline cudaError_t tile_map(CUtensorMap* map, const uint32_t* tiles, int width, long long nblocks,
                            int threads, long long ld = 0) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<Encode>(fn)
               : nullptr;
  }();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(tiles) % 16) return cudaErrorMisalignedAddress;
  if (nblocks >= (1LL << 31)) return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)nblocks, (cuuint64_t)width};
  const cuuint64_t strides[1] = {(cuuint64_t)(ld > 0 ? ld : nblocks) * 4};
  const cuuint32_t box[2] = {(cuuint32_t)threads, (cuuint32_t)width};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult rc = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 2, const_cast<uint32_t*>(tiles),
                             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The run of tiles a CTA of a staged scan takes: about kRunBytes of device
// memory, each tile reading `width` and writing `rows` rows of 4 * threads
// bytes, between 1 and kMaxRun tiles.  CTAs dispatched in address order
// keep the bytes in flight in one compact window (the copy kernel's
// finding, copy.cu); a longer run amortizes a CTA's start and its counts'
// flush, a shorter one keeps the rows' stores of the CTAs at work close
// together.  Runs of 1-16 tiles against the resident grid at widths 9-31
// and k 1-1024 (bench/redesign_sweep.py interval and compare; NVIDIA H100
// 80GB HBM3, 700 W): 4-8 tiles ran best at width 9 and k <= 8, 1-2 past
// width 24 or at k = 1024; this rule's run came within 2% of the best run
// for the interval kernel and within 5% for the compare kernel; against
// it the resident grid ran 0.5-15% slower for the interval kernel, from
// 1.5% faster to 5.5% slower for the compare kernel.
constexpr long long kRunBytes = 96 * 1024;
constexpr long long kMaxRun = 8;

inline long long staged_run(int width, int rows, int threads) {
  const long long run = kRunBytes / (4LL * threads * (width + rows));
  return run < 1 ? 1 : run > kMaxRun ? kMaxRun : run;
}

// Grid of a staged kernel: with run > 0 a CTA for every run of `run`
// tiles, else resident CTAs, at least least_ctas of them (a run of tiles
// holds fewer than 2^32 values, so its CTA's unsigned counters cannot
// wrap).  The ring's shared memory limit is raised first; a refusal returns
// its error (cleared, so the next launch does not report it).
template <typename Kernel>
inline cudaError_t staged_grid(Kernel kernel, int threads, size_t smem, long long nblocks,
                               long long run, unsigned* grid) {
  const long long ntiles = (nblocks + threads - 1) / threads;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && run) {
    const long long runs = (ntiles + run - 1) / run;
    if (runs > 0x7FFFFFFFLL || run * threads * kBlockValues >= (1LL << 32))
      err = cudaErrorInvalidValue;
    else
      *grid = (unsigned)runs;
  } else if (err == cudaSuccess) {
    err = resident_grid(kernel, threads, smem, ntiles, grid);
    const long long least = least_ctas(ntiles, threads);
    if (err == cudaSuccess && *grid < least) *grid = (unsigned)least;
  }
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// Whether every block of the tile [first, first + blockDim.x) lies in the
// tiles and holds 32 real values (CTA-uniform).
__device__ __forceinline__ bool full_tile(long long first, long long nblocks, long long n,
                                          long long block_offset) {
  const long long end = first + blockDim.x;
  return end <= nblocks && block_offset + end <= (n >> 5);
}

// Range match word of one block: bit r set iff (v[r] - lo) mod 2^32 < span
// (span = hi - lo mod 2^32), the JAX package's unsigned range compare.
__device__ __forceinline__ uint32_t range_word(const uint32_t (&v)[kBlockValues], uint32_t lo,
                                               uint32_t span) {
  uint32_t acc = 0u;
#pragma unroll
  for (int r = 0; r < kBlockValues; ++r) acc |= (uint32_t)(v[r] - lo < span) << r;
  return acc;
}

inline bool width_ok(int width) { return width >= 1 && width <= 31; }

// Keys read from device memory: the runtime keys, and host keys copied
// there once (the folds of bitsliced.cu, the key lookup of agg_lookup.cu).
struct DeviceKeys {
  const uint32_t* p;
  __device__ __forceinline__ uint32_t operator[](int j) const { return __ldg(p + j); }
};

// Linear (interleaved) output, the byte order of the reference's
// shared_scan_128_linear_standard: the k rows of block b (one word each)
// become bytes [4bk, 4bk + 4k) of the output, byte q*k + j = byte q of row
// j.  A fused kernel stages its CTA's rows in shared memory, thread t's 4k
// bytes at word t*(k+1): the stride is odd for k % 4 == 0, so the 32 lanes'
// word stores of one quad of rows fall in 32 banks.  flush_linear then
// stores the CTA's blockDim.x * k words as one contiguous span (coalesced).
constexpr int kMaxLinearKeys = 128;  // the fused kernels' k: 4..128, k % 4 == 0
constexpr int kLinearStageBytes = 40 * 1024;

inline bool linear_k_ok(int k) { return k >= 4 && k <= kMaxLinearKeys && k % 4 == 0; }

// Threads per CTA of a fused kernel: the most (256, 128, 64) whose staging
// fits kLinearStageBytes (256 up to k = 36, 128 up to k = 76, else 64).
inline int linear_threads(int k) {
  for (int threads = kThreads; threads > 64; threads /= 2)
    if ((size_t)threads * (k + 1) * 4 <= (size_t)kLinearStageBytes) return threads;
  return 64;
}

inline size_t linear_stage_bytes(int k, int threads) { return (size_t)threads * (k + 1) * 4; }

// Once every thread staged its rows: store blocks first_block ..
// first_block + nactive - 1 (k words each) to out, then sync so the stage
// can be refilled.  Word g of the span is word g % k of thread g / k,
// tracked without a division per word.
__device__ __forceinline__ void flush_linear(const uint32_t* stage, int k,
                                             uint32_t* __restrict__ out, long long first_block,
                                             int nactive) {
  __syncthreads();
  const int total = nactive * k;
  const int dt = blockDim.x / k, di = blockDim.x % k;
  int t = threadIdx.x / k, i = threadIdx.x % k;
  uint32_t* dst = out + (size_t)first_block * k;
  for (int g = threadIdx.x; g < total; g += blockDim.x) {
    dst[g] = stage[t * (k + 1) + i];
    t += dt;
    i += di;
    if (i >= k) {
      i -= k;
      ++t;
    }
  }
  __syncthreads();
}

// Output sinks of a row-producing body: store rows of block b into the
// (k, nblocks) bits, or stage them in the CTA's linear span, four at a
// time; both count them.  Must be reached by all 32 lanes of the warp (j
// is warp-uniform).  rows8 hands over rows j..j+count-1 (count <= 8) from
// x[0..7], each ANDed with the validity word.
struct BitsSink {
  uint32_t* bits;
  long long nblocks, b;
  bool active;
  unsigned* s_cnt;
  __device__ __forceinline__ void operator()(int j, uint32_t word) const {
    store_row(bits, nblocks, b, active, j, word, s_cnt);
  }
  __device__ __forceinline__ void rows8(int j, const uint32_t (&x)[8], uint32_t valid,
                                        int count) const {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < count) (*this)(j + i, x[i] & valid);
  }
};

struct LinearSink {
  uint8_t* stage;
  int k;
  unsigned* s_cnt;
  // Rows j..j+3 (j % 4 == 0): output word q*(k/4) + j/4 of the block is
  // byte q of the four rows, so four word stores stage them.
  __device__ __forceinline__ void quad(int j, uint32_t a, uint32_t b, uint32_t c,
                                       uint32_t d) const {
    count_quad(j, a, b, c, d, s_cnt);
    const uint32_t ab01 = __byte_perm(a, b, 0x5140), cd01 = __byte_perm(c, d, 0x5140);
    const uint32_t ab23 = __byte_perm(a, b, 0x7362), cd23 = __byte_perm(c, d, 0x7362);
    uint32_t* w = reinterpret_cast<uint32_t*>(stage) + threadIdx.x * (k + 1) + j / 4;
    const int c4 = k / 4;
    w[0] = __byte_perm(ab01, cd01, 0x5410);
    w[c4] = __byte_perm(ab01, cd01, 0x7632);
    w[2 * c4] = __byte_perm(ab23, cd23, 0x5410);
    w[3 * c4] = __byte_perm(ab23, cd23, 0x7632);
  }
  // count is 4 or at least 8 here: the fused kernels take k % 4 == 0.
  __device__ __forceinline__ void rows8(int j, const uint32_t (&x)[8], uint32_t valid,
                                        int count) const {
    quad(j, x[0] & valid, x[1] & valid, x[2] & valid, x[3] & valid);
    if (count > 4) quad(j + 4, x[4] & valid, x[5] & valid, x[6] & valid, x[7] & valid);
  }
};

// Exact per-CTA sums in 32-bit shared counters.  A thread adds lo < 2^21
// and hi < 2^21 (its sum split as hi * 2^16 + lo); a warp's
// __reduce_add_sync gives < 2^26 each, a CTA of at most kThreads = 256
// threads (8 warps) < 2^29, so the unsigned counters never wrap.
// flush_sums adds hi * 2^16 + lo, in 64 bits, to the int64 total with one
// atomic per key per CTA.  Must be reached by all 32 lanes of the warp.
__device__ __forceinline__ void add_split_sum(unsigned* s_lo, unsigned* s_hi, int j, unsigned lo,
                                              unsigned hi) {
  lo = __reduce_add_sync(0xFFFFFFFFu, lo);
  hi = __reduce_add_sync(0xFFFFFFFFu, hi);
  if ((threadIdx.x & 31) == 0) {
    if (lo) atomicAdd(s_lo + j, lo);
    if (hi) atomicAdd(s_hi + j, hi);
  }
}

__device__ __forceinline__ void zero_sums(unsigned* s_cnt, unsigned* s_lo, unsigned* s_hi, int k) {
  for (int j = threadIdx.x; j < k; j += blockDim.x) s_cnt[j] = s_lo[j] = s_hi[j] = 0u;
  __syncthreads();
}

__device__ __forceinline__ void flush_sums(const unsigned* s_cnt, const unsigned* s_lo,
                                           const unsigned* s_hi, int k,
                                           unsigned long long* __restrict__ counts,
                                           unsigned long long* __restrict__ sums) {
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    if (s_cnt[j]) atomicAdd(counts + j, (unsigned long long)s_cnt[j]);
    const unsigned long long s = ((unsigned long long)s_hi[j] << 16) + s_lo[j];
    if (s) atomicAdd(sums + j, s);
  }
}

}  // namespace sss

// Expands CASE(W) for every width 1..31 inside a switch on the runtime width.
#define SSS_FOR_EACH_WIDTH(CASE)                                                        \
  CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8) CASE(9) CASE(10)      \
  CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16) CASE(17) CASE(18) CASE(19)      \
  CASE(20) CASE(21) CASE(22) CASE(23) CASE(24) CASE(25) CASE(26) CASE(27) CASE(28)      \
  CASE(29) CASE(30) CASE(31)

namespace sss {

// The 32 values of block b of a column whose width is known only at run
// time: a switch on the width (uniform across the grid) over the
// template<int W> unpack, so each schedule stays constant.  A kernel that
// reads two columns of different widths calls it once per column instead
// of being templated on both (31 x 31 bodies).
__device__ __forceinline__ void unpack_block_any(int width, const uint32_t* __restrict__ tiles,
                                                 long long nblocks, long long b, bool active,
                                                 uint32_t (&v)[kBlockValues]) {
  switch (width) {
#define SSS_CASE(W)                                 \
  case W: {                                         \
    uint32_t w[W];                                  \
    load_block<W>(tiles, nblocks, b, active, w);    \
    unpack_values<W>(w, v);                         \
    return;                                         \
  }
    SSS_FOR_EACH_WIDTH(SSS_CASE)
#undef SSS_CASE
  }
#pragma unroll
  for (int r = 0; r < kBlockValues; ++r) v[r] = 0u;  // not reached: entry points check widths
}

}  // namespace sss

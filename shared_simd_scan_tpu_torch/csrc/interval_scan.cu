// Interval shared scan (keys lo..lo+k-1, k <= 1024) and the shift canary.
//
// Replaces shared_simd_scan_tpu/ops/scan.py: _interval_scan_kernel /
// _interval_scan_tiles_impl and _shift_canary_kernel / _run_shift_canary,
// with the reference algorithm's results:
//  - one-hot mask m = 1 << (v - lo_c) per value for keys from lo_c; the
//    subtraction is uint32 (lo + j wraps past 2^32 - 1 as it does there),
//    so v < lo_c wraps to a large amount and the mask is 0;
//  - for each 8-key round (byte of the mask), X_t packs the mask bytes of
//    values {t, t+8, t+16, t+24} into its four bytes, and a 12-SWAPMOVE 8x8
//    bit transpose turns X_0..X_7 into the 8 keys' bitvector words;
//  - a last round with fewer than 8 keys writes only its first rows.
//
// The one-hot needs 1 << d == 0 for every d >= 32.  PTX shl.b32 clamps the
// amount (PTX ISA), C++ << leaves it undefined; the canary kernel measures
// both on the card, and the scan takes the gateless PTX shift only when the
// canary saw it saturate, else the gated d < 32 ? 1 << (d & 31) : 0.  The
// verdict (TPU _run_shift_canary's one bool) is its own launch: one warp
// shifts all-ones by each amount, passed by value, through shl_ptx, gathers
// the lanes left nonzero with __ballot_sync and writes that word to mapped
// pinned host memory; the C entry syncs the stream once and hands the word
// back.  Bound: a launch and a sync (68 bytes of amounts and word).  Before
// it the verdict took a host-to-device copy of the amounts, a fill, the
// elementwise canary on 1024 words, a compare, a reduction and a copy back.
//
// Bound on the H100: device memory bytes (reads W words, writes k words per
// 32 values); the arithmetic is ~3 integer ops per value per round of 8
// keys.  Design: one thread per 32-value block, CTAs of kIntervalThreads
// threads on the staged tile loop (common.cuh staged_tiles: each tile's W
// rows one TMA tensor copy into a ring of kIntervalStages stages in shared
// memory, the next tile in flight while the CTA computes on one; a CTA for
// every run of staged_run tiles, dispatched in address order), counts
// flushed once a CTA.  Before it, a CTA a tile of 256 blocks (58,368 CTAs
// at 512 MiB) zeroed and flushed its counters, and each thread's nine
// loads were in flight only while it waited on them.  A round builds X_t
// straight from the four values' shift amounts: byte g of X_t is byte g of
// 1 << (v - lo_c - 8 round + 8 g), the bijection of amounts that moves the
// round's byte to byte g, so no thread holds the 32 masks across rounds.
//
// The fused linear form (sss_interval_scan_linear) replaces
// _interval_linear_kernel / _interval_linear_tiles_impl (scan.py:618): the
// same body, its rows handed to a LinearSink (common.cuh) instead of the
// bits.  The TPU kernel interleaves with SWAPMOVE quads and a permutation
// matmul because its vector unit cannot spread 16 lanes to stride k; here
// each quad of rows becomes four linear words (__byte_perm) stored to their
// places in shared memory, and the CTA's span goes out as one coalesced
// store, so the (k, W) bits never reach device memory.  Bound: the same
// bytes as the bits form (the linear words are as many as the bits words).
#include "common.cuh"

namespace sss {

// Threads (blocks of a tile) and ring stages of the interval kernel
// (bench/redesign_sweep.py interval).
constexpr int kIntervalThreads = 256;
constexpr int kIntervalStages = 2;

// Byte g of X_t in the round of keys key..key+7 (neg_key = -key, uint32):
// the one-hot of v - key + 8g kept to byte g, which is bit v - key of byte
// g when v - key < 8, else 0 (v - key + 8g lies in [8g, 8g + 8) only then).
template <bool kGateless, int kG>
__device__ __forceinline__ uint32_t onehot_byte(uint32_t v, uint32_t neg_key) {
  return onehot<kGateless>(v + neg_key + 8u * kG) & (0xFFu << (8 * kG));
}

// The k rows of one block from its 32 values, in rounds of 8 keys: row j
// is key lo + j (uint32), handed to the sink as row j.
template <bool kGateless, typename Sink>
__device__ __forceinline__ void interval_block(const uint32_t (&v)[kBlockValues], uint32_t lo,
                                               int k, uint32_t valid, const Sink& sink) {
#pragma unroll 1
  for (int j = 0; j < k; j += 8) {
    const uint32_t neg_key = 0u - (lo + (uint32_t)j);
    uint32_t x[8];
#pragma unroll
    for (int t = 0; t < 8; ++t)
      x[t] = onehot_byte<kGateless, 0>(v[t], neg_key) |
             onehot_byte<kGateless, 1>(v[8 + t], neg_key) |
             onehot_byte<kGateless, 2>(v[16 + t], neg_key) |
             onehot_byte<kGateless, 3>(v[24 + t], neg_key);
    transpose8x8_bytes(x);
    sink.rows8(j, x, valid, k - j);
  }
}

template <int W, bool kGateless, int T, int kStages>
__global__ void __launch_bounds__(T)
interval_scan_kernel(const __grid_constant__ CUtensorMap map, uint32_t lo, int k,
                     uint32_t* __restrict__ bits, unsigned long long* __restrict__ counts,
                     long long nblocks, long long n, long long block_offset, long long run) {
  extern __shared__ __align__(128) uint32_t s_ring[];
  __shared__ __align__(8) uint64_t s_full[kStages];
  __shared__ unsigned s_cnt[kMaxKeys];
  zero_counts(s_cnt, k);
  staged_tiles<W, T, kStages>(
      &map, nblocks, run, s_ring, s_full,
      [&](const uint32_t (&w)[W], long long b, bool active) {
        const uint32_t valid = active ? valid_word(block_offset + b, n) : 0u;
        uint32_t v[kBlockValues];
        unpack_values<W>(w, v);
        interval_block<kGateless>(v, lo, k, valid, BitsSink{bits, nblocks, b, active, s_cnt});
      });
  flush_counts(s_cnt, k, counts);
}

// One launch of the staged interval kernel: a CTA for every `run` tiles
// (0: the resident grid).
template <int W, bool kGateless, int T, int kStages>
cudaError_t launch_interval(const uint32_t* tiles, uint32_t lo, int k, uint32_t* bits,
                            unsigned long long* counts, long long nblocks, long long n,
                            long long block_offset, long long run, cudaStream_t stream) {
  const auto kernel = interval_scan_kernel<W, kGateless, T, kStages>;
  const size_t smem = tile_ring_bytes(W, T, kStages);
  CUtensorMap map;
  unsigned grid = 0;
  cudaError_t err = tile_map(&map, tiles, W, nblocks, T);
  if (err == cudaSuccess) err = staged_grid(kernel, T, smem, nblocks, run, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, T, smem, stream>>>(map, lo, k, bits, counts, nblocks, n, block_offset, run);
  return cudaGetLastError();
}

// The fused form (TPU kernel _interval_linear_kernel): the same rows staged
// as the linear bytes of the CTA's blocks and stored as one span.  Resident
// CTAs loop over tiles of blockDim.x blocks and flush their counts once.
template <int W, bool kGateless>
__global__ void __launch_bounds__(kThreads)
interval_scan_linear_kernel(const uint32_t* __restrict__ tiles, uint32_t lo, int k,
                            uint32_t* __restrict__ out, unsigned long long* __restrict__ counts,
                            long long nblocks, long long n, long long block_offset) {
  extern __shared__ uint32_t s_stage[];  // [threadIdx.x][k + 1] words
  __shared__ unsigned s_cnt[kMaxLinearKeys];
  zero_counts(s_cnt, k);
  const LinearSink sink{reinterpret_cast<uint8_t*>(s_stage), k, s_cnt};
  const long long ntiles = (nblocks + blockDim.x - 1) / blockDim.x;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {  // CTA-uniform trip count
    const long long first = t * blockDim.x;
    const long long b = first + threadIdx.x;
    const bool active = b < nblocks;
    uint32_t w[W];
    load_block<W>(tiles, nblocks, b, active, w);
    const uint32_t valid = active ? valid_word(block_offset + b, n) : 0u;
    uint32_t v[kBlockValues];
    unpack_values<W>(w, v);
    interval_block<kGateless>(v, lo, k, valid, sink);
    const long long left = nblocks - first;
    flush_linear(s_stage, k, out, first, left < blockDim.x ? (int)left : (int)blockDim.x);
  }
  flush_counts(s_cnt, k, counts);
}

template <int W, bool kGateless>
cudaError_t launch_interval_linear(const uint32_t* tiles, uint32_t lo, int k, uint32_t* out,
                                   unsigned long long* counts, long long nblocks, long long n,
                                   long long block_offset, cudaStream_t stream) {
  const auto kernel = interval_scan_linear_kernel<W, kGateless>;
  const int threads = linear_threads(k);
  const size_t smem = linear_stage_bytes(k, threads);
  unsigned grid = 0;
  const cudaError_t err =
      resident_grid(kernel, threads, smem, (nblocks + threads - 1) / threads, &grid);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return err;
  }
  kernel<<<grid, threads, smem, stream>>>(tiles, lo, k, out, counts, nblocks, n, block_offset);
  return cudaGetLastError();
}

// out_ptx[i] = base[i] << amounts[i] through PTX shl.b32; out_cxx[i] the
// same through C++ << (undefined for amounts >= 32: that is what it shows).
__global__ void shift_canary_kernel(const uint32_t* __restrict__ base,
                                    const uint32_t* __restrict__ amounts,
                                    uint32_t* __restrict__ out_ptx, uint32_t* __restrict__ out_cxx,
                                    int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const uint32_t a = base[i], d = amounts[i];
  out_ptx[i] = shl_ptx(a, d);
  out_cxx[i] = a << d;
}

// Bit i of *out: all-ones << amounts.d[i] through PTX shl.b32 is not 0.
struct ShiftAmounts {
  uint32_t d[32];
};

__global__ void shift_verdict_kernel(const ShiftAmounts amounts, int count,
                                     uint32_t* __restrict__ out) {
  const int lane = threadIdx.x;
  const bool kept = lane < count && shl_ptx(0xFFFFFFFFu, amounts.d[lane]) != 0u;
  const uint32_t word = __ballot_sync(0xFFFFFFFFu, kept);
  if (lane == 0) *out = word;
}

// Mapped pinned words, one a device, for each calling thread: allocated at
// the thread's first verdict, and tried again on its next call after a
// failed allocation.  Threads verdicting on one device at once do not
// share a word.
constexpr int kVerdictDevices = 64;

inline uint32_t* verdict_words() {
  thread_local uint32_t* words = nullptr;
  if (words == nullptr) {
    void* p = nullptr;
    if (cudaHostAlloc(&p, kVerdictDevices * sizeof(uint32_t),
                      cudaHostAllocMapped | cudaHostAllocPortable) == cudaSuccess)
      words = static_cast<uint32_t*>(p);
  }
  return words;
}

}  // namespace sss

extern "C" int sss_interval_scan(const uint32_t* tiles, uint32_t lo, int k, uint32_t* bits,
                                 unsigned long long* counts, long long nblocks, int width,
                                 long long n, long long block_offset, int gateless,
                                 cudaStream_t stream) {
  if (k < 1 || k > sss::kMaxKeys || !sss::width_ok(width)) return (int)cudaErrorInvalidValue;
  if (nblocks <= 0) return (int)cudaSuccess;
  const long long run = sss::staged_run(width, k, sss::kIntervalThreads);
  switch (width) {
#define SSS_CASE(W)                                                                      \
  case W:                                                                                \
    return (int)(gateless ? sss::launch_interval<W, true, sss::kIntervalThreads,         \
                                                 sss::kIntervalStages>(                  \
                                tiles, lo, k, bits, counts, nblocks, n, block_offset,    \
                                run, stream)                                             \
                          : sss::launch_interval<W, false, sss::kIntervalThreads,        \
                                                 sss::kIntervalStages>(                  \
                                tiles, lo, k, bits, counts, nblocks, n, block_offset,    \
                                run, stream));
    SSS_FOR_EACH_WIDTH(SSS_CASE)
#undef SSS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The fused linear form: out is uint32[nblocks * k], block b's linear bytes
// at [4bk, 4bk + 4k); k % 4 == 0, 4 <= k <= 128.
extern "C" int sss_interval_scan_linear(const uint32_t* tiles, uint32_t lo, int k, uint32_t* out,
                                        unsigned long long* counts, long long nblocks, int width,
                                        long long n, long long block_offset, int gateless,
                                        cudaStream_t stream) {
  if (!sss::linear_k_ok(k)) return (int)cudaErrorInvalidValue;
  if (nblocks <= 0) return (int)cudaSuccess;
  switch (width) {
#define SSS_CASE(W)                                                                          \
  case W:                                                                                    \
    return (int)(gateless ? sss::launch_interval_linear<W, true>(tiles, lo, k, out, counts,  \
                                                                 nblocks, n, block_offset,   \
                                                                 stream)                     \
                          : sss::launch_interval_linear<W, false>(tiles, lo, k, out, counts, \
                                                                  nblocks, n, block_offset,  \
                                                                  stream));
    SSS_FOR_EACH_WIDTH(SSS_CASE)
#undef SSS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int sss_shift_canary(const uint32_t* base, const uint32_t* amounts, uint32_t* out_ptx,
                                uint32_t* out_cxx, int count, cudaStream_t stream) {
  if (count <= 0) return (int)cudaSuccess;
  sss::shift_canary_kernel<<<(count + 255) / 256, 256, 0, stream>>>(base, amounts, out_ptx,
                                                                     out_cxx, count);
  return (int)cudaGetLastError();
}

// The canary's verdict: *word gets bit i set where all-ones << amounts[i]
// (count <= 32 amounts, a host array) is not 0 through PTX shl.b32; one
// launch of one warp, then one sync of the stream.
extern "C" int sss_shift_verdict(const uint32_t* amounts, int count, uint32_t* word,
                                 cudaStream_t stream) {
  if (count < 1 || count > 32) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  uint32_t* host = sss::verdict_words();
  if (host == nullptr || dev >= sss::kVerdictDevices) return (int)cudaErrorMemoryAllocation;
  uint32_t* out = nullptr;
  err = cudaHostGetDevicePointer(reinterpret_cast<void**>(&out), host + dev, 0);
  if (err != cudaSuccess) return (int)err;
  sss::ShiftAmounts a{};
  for (int i = 0; i < count; ++i) a.d[i] = amounts[i];
  sss::shift_verdict_kernel<<<1, 32, 0, stream>>>(a, count, out);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaStreamSynchronize(stream);
  if (err == cudaSuccess) *word = *static_cast<volatile uint32_t*>(host + dev);
  return (int)err;
}

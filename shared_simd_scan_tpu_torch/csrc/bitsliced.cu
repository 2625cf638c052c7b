// Bit-sliced shared scans: runtime keys (plane fold) and host keys (a
// static AND-DAG program); and their member (IN-list) forms, one row.
//
// Replaces shared_simd_scan_tpu/ops/scan.py:
//  - _shared_scan_bitsliced_kernel / shared_scan_bitsliced_tiles: keys read
//    from device memory, any k; per key match = AND_p (plane_p ^
//    (bit_p(key) - 1)), killed for keys >= 2^W;
//  - _shared_scan_bitsliced_static_kernel / _bitsliced_static_tiles_impl:
//    the key set's memoized _combo AND-DAG over the planes and their
//    complements.  On the TPU the DAG is traced into the kernel; nvcc cannot
//    specialize per key set, so the host compiles the DAG into a program
//    (ops/scan.py _static_program) that this kernel interprets:
//      word 0 = kind << 30 | target, word 1 = operand a | operand b << 16,
//      operand = slot | 0x8000 for the complement;
//      AND: slot[target] = a & b;  OR: slot[target] = a | b;
//      OUT: row target = a;  ZERO: row target = 0.
//    Planes hold slots 0..W-1; the host gives every other node a slot freed
//    after its last use, so the slots are W plus the DAG's peak liveness.
//  - ops/member.py _member_ortree_kernel: the member set's Shannon-factored
//    OR-tree (scan.py _member_or_tree), compiled by the host
//    (ops/scan.py _member_program) into a one-row program with OR
//    instructions and run by the same interpreter;
//  - ops/member.py _member_bitsliced_kernel: the runtime plane fold with
//    the key rows ORed into one row (sss_member_bitsliced, the kMember
//    form of the runtime kernel);
//  - _histogram_dag_kernel / _histogram_dag_tiles_impl and
//    _histogram_span_kernel / _histogram_span_tiles_impl: histogram counts
//    of consecutive keys, no bitvector (sss_histogram_dag, the counts-only
//    form of the static kernel).  The chunked form runs _static_program's
//    per-chunk memos, the span form one memo over all k keys
//    (ops/scan.py _span_program); both are the same instruction format.
//
// Bound on the H100: device memory bytes (reads W words, writes k words per
// 32 values) while k is small; the integer instruction rate beyond: the runtime fold costs
// ~3 ops per plane per key, the static DAG one shared-memory AND per node
// (~57 nodes for 8 spread keys at W=9, ~113 for 32).  Design: one thread per
// 32-value block; the 32 values are unpacked and transposed into planes in
// registers by the pruned butterfly (common.cuh).  The runtime kernel keeps
// the planes in registers and does not unroll its key loop.  The static
// kernel keeps node values in dynamic shared memory laid out [slot][thread]
// (neighbouring threads, neighbouring banks: no conflicts), reads each
// warp-uniform instruction through the read-only cache, and asks for more
// than 48 KB of shared memory when the DAG needs it; a launch that is
// refused returns its error.  Counts as in shared_scan.cu.
#include "common.cuh"

namespace sss {

// kMember: OR the k key rows into row 0 (one count) instead of storing k.
template <int W, bool kMember>
__global__ void __launch_bounds__(kThreads)
bitsliced_scan_kernel(const uint32_t* __restrict__ tiles, const uint32_t* __restrict__ keys, int k,
                      uint32_t* __restrict__ bits, unsigned long long* __restrict__ counts,
                      long long nblocks, long long n, long long block_offset) {
  __shared__ unsigned s_cnt[kMember ? 1 : kMaxKeys];
  zero_counts(s_cnt, kMember ? 1 : k);
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = b < nblocks;
  uint32_t w[W];
  load_block<W>(tiles, nblocks, b, active, w);
  const uint32_t valid = active ? valid_word(block_offset + b, n) : 0u;

  uint32_t x[kBlockValues];
  unpack_values<W>(w, x);
  transpose_bitplanes<W>(x);

  uint32_t any = 0u;
#pragma unroll 1
  for (int j = 0; j < k; ++j) {
    const uint32_t key = __ldg(keys + j);
    uint32_t acc = key <= value_mask<W>() ? 0xFFFFFFFFu : 0u;
#pragma unroll
    for (int p = 0; p < W; ++p) acc &= x[p] ^ (((key >> p) & 1u) - 1u);
    if constexpr (kMember) any |= acc;
    else store_row(bits, nblocks, b, active, j, acc & valid, s_cnt);
  }
  if constexpr (kMember) store_row(bits, nblocks, b, active, 0, any & valid, s_cnt);
  flush_counts(s_cnt, kMember ? 1 : k, counts);
}

// One tile of the static kernel: thread threadIdx.x takes block
// t * blockDim.x + threadIdx.x, unpacks and transposes it into planes in
// its slots, and runs the program.  kCounts: the histogram's counts-only
// form (rows 10 and 11 of the TPU kernel table): OUT adds popc(a & valid)
// to its row's shared counter and stores nothing, ZERO adds nothing.
template <int W, bool kCounts>
__device__ __forceinline__ void static_tile(const uint32_t* __restrict__ tiles,
                                            const uint2* __restrict__ prog, int nops,
                                            uint32_t* __restrict__ bits, long long nblocks,
                                            long long n, long long block_offset, long long t,
                                            uint32_t* s_val, unsigned* s_cnt) {
  const int stride = blockDim.x;
  const long long b = t * stride + threadIdx.x;
  const bool active = b < nblocks;
  uint32_t w[W];
  load_block<W>(tiles, nblocks, b, active, w);
  const uint32_t valid = active ? valid_word(block_offset + b, n) : 0u;

  uint32_t x[kBlockValues];
  unpack_values<W>(w, x);
  transpose_bitplanes<W>(x);
#pragma unroll
  for (int p = 0; p < W; ++p) s_val[p * stride + threadIdx.x] = x[p];

  for (int i = 0; i < nops; ++i) {
    const uint2 op = __ldg(prog + i);
    const uint32_t kind = op.x >> 30, target = op.x & 0x3FFFFFFFu;
    const uint32_t a = dag_operand(s_val, op.y & 0xFFFFu, stride);
    if (kind == kAnd || kind == kOr) {
      const uint32_t c = dag_operand(s_val, op.y >> 16, stride);
      s_val[target * stride + threadIdx.x] = kind == kAnd ? a & c : a | c;
    } else if constexpr (kCounts) {
      if (kind == kOut) count_row((int)target, a & valid, s_cnt);
    } else {
      store_row(bits, nblocks, b, active, (int)target, kind == kOut ? a & valid : 0u, s_cnt);
    }
  }
}

// The bitvector form runs one tile per CTA.  The counts-only form runs
// resident CTAs looping over the tiles, so each flushes its counters once.
template <int W, bool kCounts>
__global__ void __launch_bounds__(kStaticThreadsMax)
bitsliced_static_kernel(const uint32_t* __restrict__ tiles, const uint2* __restrict__ prog,
                        int nops, int k, uint32_t* __restrict__ bits,
                        unsigned long long* __restrict__ counts, long long nblocks, long long n,
                        long long block_offset) {
  extern __shared__ uint32_t s_val[];  // [slot][threadIdx.x]
  __shared__ unsigned s_cnt[kCounts ? kMaxHistKeys : kMaxKeys];
  zero_counts(s_cnt, k);
  if constexpr (kCounts) {
    const long long ntiles = (nblocks + blockDim.x - 1) / blockDim.x;
    for (long long t = blockIdx.x; t < ntiles; t += gridDim.x)  // CTA-uniform trip count
      static_tile<W, true>(tiles, prog, nops, bits, nblocks, n, block_offset, t, s_val, s_cnt);
  } else {
    static_tile<W, false>(tiles, prog, nops, bits, nblocks, n, block_offset, blockIdx.x, s_val,
                          s_cnt);
  }
  flush_counts(s_cnt, k, counts);
}

// One launch of a program of k rows with `threads` threads per CTA and
// smem bytes of node slots; a launch that is refused returns its error.
template <int W, bool kCounts>
cudaError_t launch_static(const uint32_t* tiles, const uint2* prog, int nops, int k,
                          uint32_t* bits, unsigned long long* counts, long long nblocks,
                          long long n, long long block_offset, int threads, size_t smem,
                          cudaStream_t stream) {
  const auto kernel = bitsliced_static_kernel<W, kCounts>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const long long ntiles = (nblocks + threads - 1) / threads;
  unsigned grid = (unsigned)ntiles;
  if (err == cudaSuccess && kCounts) err = resident_grid(kernel, threads, smem, ntiles, &grid);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return err;
  }
  bitsliced_static_kernel<W, kCounts><<<grid, threads, smem, stream>>>(
      tiles, prog, nops, k, bits, counts, nblocks, n, block_offset);
  return cudaGetLastError();
}

template <bool kCounts>
int static_scan(const uint32_t* tiles, const int* prog, int nops, int k, uint32_t* bits,
                unsigned long long* counts, long long nblocks, int width, long long n,
                long long block_offset, int threads, int slots, cudaStream_t stream) {
  if (k < 1 || k > (kCounts ? kMaxHistKeys : kMaxKeys) || threads < 32 ||
      threads > kStaticThreadsMax || threads % 32 || slots < width)
    return (int)cudaErrorInvalidValue;
  if (nblocks <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)slots * threads * sizeof(uint32_t);
  const uint2* p = reinterpret_cast<const uint2*>(prog);
  switch (width) {
#define SSS_CASE(W)                                                                         \
  case W:                                                                                   \
    return (int)launch_static<W, kCounts>(tiles, p, nops, k, bits, counts, nblocks, n,      \
                                          block_offset, threads, smem, stream);
    SSS_FOR_EACH_WIDTH(SSS_CASE)
#undef SSS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace sss

// Keys are launched in chunks of kMaxKeys (the shared counters' size); each
// chunk writes its own rows of bits and counts.
extern "C" int sss_bitsliced_scan(const uint32_t* tiles, const uint32_t* keys, int k,
                                  uint32_t* bits, unsigned long long* counts, long long nblocks,
                                  int width, long long n, long long block_offset,
                                  cudaStream_t stream) {
  if (nblocks <= 0 || k <= 0) return (int)cudaSuccess;
  const unsigned grid = sss::grid_for(nblocks);
  for (int j0 = 0; j0 < k; j0 += sss::kMaxKeys) {
    const int kc = k - j0 < sss::kMaxKeys ? k - j0 : sss::kMaxKeys;
    uint32_t* bits_c = bits + (size_t)j0 * nblocks;
    switch (width) {
#define SSS_CASE(W)                                                               \
  case W:                                                                         \
    sss::bitsliced_scan_kernel<W, false><<<grid, sss::kThreads, 0, stream>>>(     \
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

// The member form: all k keys OR into one row and one count (any k).
extern "C" int sss_member_bitsliced(const uint32_t* tiles, const uint32_t* keys, int k,
                                    uint32_t* bits, unsigned long long* counts, long long nblocks,
                                    int width, long long n, long long block_offset,
                                    cudaStream_t stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  if (nblocks <= 0) return (int)cudaSuccess;
  const unsigned grid = sss::grid_for(nblocks);
  switch (width) {
#define SSS_CASE(W)                                                               \
  case W:                                                                         \
    sss::bitsliced_scan_kernel<W, true><<<grid, sss::kThreads, 0, stream>>>(      \
        tiles, keys, k, bits, counts, nblocks, n, block_offset);                  \
    break;
    SSS_FOR_EACH_WIDTH(SSS_CASE)
#undef SSS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// One launch runs one program of k <= kMaxKeys rows with `threads` threads
// per CTA and slots * threads words of dynamic shared memory.
extern "C" int sss_bitsliced_static_scan(const uint32_t* tiles, const int* prog, int nops, int k,
                                         uint32_t* bits, unsigned long long* counts,
                                         long long nblocks, int width, long long n,
                                         long long block_offset, int threads, int slots,
                                         cudaStream_t stream) {
  return sss::static_scan<false>(tiles, prog, nops, k, bits, counts, nblocks, width, n,
                                 block_offset, threads, slots, stream);
}

// The counts-only form: k <= kMaxHistKeys rows, counts only (int64[k],
// zeroed by the caller).
extern "C" int sss_histogram_dag(const uint32_t* tiles, const int* prog, int nops, int k,
                                 unsigned long long* counts, long long nblocks, int width,
                                 long long n, long long block_offset, int threads, int slots,
                                 cudaStream_t stream) {
  return sss::static_scan<true>(tiles, prog, nops, k, nullptr, counts, nblocks, width, n,
                                block_offset, threads, slots, stream);
}

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
//    form of the runtime kernel).
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

template <int W>
__global__ void __launch_bounds__(kStaticThreadsMax)
bitsliced_static_kernel(const uint32_t* __restrict__ tiles, const uint2* __restrict__ prog,
                        int nops, int k, uint32_t* __restrict__ bits,
                        unsigned long long* __restrict__ counts, long long nblocks, long long n,
                        long long block_offset) {
  extern __shared__ uint32_t s_val[];  // [slot][threadIdx.x]
  __shared__ unsigned s_cnt[kMaxKeys];
  zero_counts(s_cnt, k);
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = b < nblocks;
  const int stride = blockDim.x;
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
    } else
      store_row(bits, nblocks, b, active, (int)target, kind == kOut ? a & valid : 0u, s_cnt);
  }
  flush_counts(s_cnt, k, counts);
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
  if (k < 1 || k > sss::kMaxKeys || threads < 32 || threads > sss::kStaticThreadsMax ||
      threads % 32 || slots < width)
    return (int)cudaErrorInvalidValue;
  if (nblocks <= 0) return (int)cudaSuccess;
  const unsigned grid = (unsigned)((nblocks + threads - 1) / threads);
  const size_t smem = (size_t)slots * threads * sizeof(uint32_t);
  const uint2* p = reinterpret_cast<const uint2*>(prog);
  cudaError_t err = cudaSuccess;
  switch (width) {
#define SSS_CASE(W)                                                                      \
  case W:                                                                                \
    err = cudaFuncSetAttribute(sss::bitsliced_static_kernel<W>,                         \
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);  \
    if (err != cudaSuccess) {                                                            \
      cudaGetLastError(); /* clear it, so the next launch does not report it */          \
      return (int)err;                                                                   \
    }                                                                                    \
    sss::bitsliced_static_kernel<W><<<grid, threads, smem, stream>>>(                    \
        tiles, p, nops, k, bits, counts, nblocks, n, block_offset);                      \
    break;
    SSS_FOR_EACH_WIDTH(SSS_CASE)
#undef SSS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

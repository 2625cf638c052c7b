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
//  - _histogram_dag_kernel / _histogram_dag_tiles_impl: histogram counts
//    of consecutive keys, no bitvector (sss_histogram_dag, the counts-only
//    form of the static kernel), on _static_program's per-chunk memos.
//    The span form (_histogram_span_kernel) is not here: on this card it
//    is the bins kernel with lo by value (histogram.cu sss_histogram_span);
//  - _bitsliced_linear_kernel / _bitsliced_linear_tiles_impl (scan.py:1025)
//    and _static_linear_kernel / _static_linear_tiles_impl (scan.py:854):
//    the runtime fold and the static program with their rows staged as
//    linear bytes (sss_bitsliced_scan_linear, the linear form of the static
//    kernel: sss_bitsliced_static_scan_linear), as interval_scan.cu's fused
//    form does.  The stage sits beside the node slots, so the host sizes
//    the static form's CTA for both (ops/scan.py _static_linear_threads).
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

// Row of one key from the bit planes x[0..W-1]: AND_p (plane_p ^
// (bit_p(key) - 1)), zero for a key >= 2^W.
template <int W>
__device__ __forceinline__ uint32_t key_row(const uint32_t (&x)[kBlockValues], uint32_t key) {
  uint32_t acc = key <= value_mask<W>() ? 0xFFFFFFFFu : 0u;
#pragma unroll
  for (int p = 0; p < W; ++p) acc &= x[p] ^ (((key >> p) & 1u) - 1u);
  return acc;
}

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
    const uint32_t acc = key_row<W>(x, __ldg(keys + j));
    if constexpr (kMember) any |= acc;
    else store_row(bits, nblocks, b, active, j, acc & valid, s_cnt);
  }
  if constexpr (kMember) store_row(bits, nblocks, b, active, 0, any & valid, s_cnt);
  flush_counts(s_cnt, kMember ? 1 : k, counts);
}

// The fused linear form of the runtime kernel (TPU kernel
// _bitsliced_linear_kernel): each key's row staged as linear bytes, the
// CTA's span stored at once; resident CTAs loop over tiles of blockDim.x
// blocks and flush their counts once.
template <int W>
__global__ void __launch_bounds__(kThreads)
bitsliced_scan_linear_kernel(const uint32_t* __restrict__ tiles, const uint32_t* __restrict__ keys,
                             int k, uint32_t* __restrict__ out,
                             unsigned long long* __restrict__ counts, long long nblocks,
                             long long n, long long block_offset) {
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
    uint32_t x[kBlockValues];
    unpack_values<W>(w, x);
    transpose_bitplanes<W>(x);
#pragma unroll 1
    for (int j = 0; j < k; j += 4)  // k % 4 == 0
      sink.quad(j, key_row<W>(x, __ldg(keys + j)) & valid,
                key_row<W>(x, __ldg(keys + j + 1)) & valid,
                key_row<W>(x, __ldg(keys + j + 2)) & valid,
                key_row<W>(x, __ldg(keys + j + 3)) & valid);
    const long long left = nblocks - first;
    flush_linear(s_stage, k, out, first, left < blockDim.x ? (int)left : (int)blockDim.x);
  }
  flush_counts(s_cnt, k, counts);
}

template <int W>
cudaError_t launch_bitsliced_linear(const uint32_t* tiles, const uint32_t* keys, int k,
                                    uint32_t* out, unsigned long long* counts, long long nblocks,
                                    long long n, long long block_offset, cudaStream_t stream) {
  const auto kernel = bitsliced_scan_linear_kernel<W>;
  const int threads = linear_threads(k);
  const size_t smem = linear_stage_bytes(k, threads);
  unsigned grid = 0;
  const cudaError_t err =
      resident_grid(kernel, threads, smem, (nblocks + threads - 1) / threads, &grid);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return err;
  }
  kernel<<<grid, threads, smem, stream>>>(tiles, keys, k, out, counts, nblocks, n, block_offset);
  return cudaGetLastError();
}

// Forms of the static kernel: the (k, nblocks) bits; counts only (the
// histogram's, rows 10 and 11 of the TPU kernel table); the linear bytes
// (the fused form, TPU kernel _static_linear_kernel).
constexpr int kFormBits = 0, kFormCounts = 1, kFormLinear = 2;

// One tile of the static kernel: thread threadIdx.x takes block
// t * blockDim.x + threadIdx.x, unpacks and transposes it into planes in
// its slots, and runs the program.  OUT and ZERO by form: the bits form
// stores row target (a & valid, or 0) and counts it; the counts form adds
// popc(a & valid) to its row's shared counter for OUT and nothing for
// ZERO; the linear form stages the row as LinearSink does.
template <int W, int kForm>
__device__ __forceinline__ void static_tile(const uint32_t* __restrict__ tiles,
                                            const uint2* __restrict__ prog, int nops, int k,
                                            uint32_t* __restrict__ bits, long long nblocks,
                                            long long n, long long block_offset, long long t,
                                            uint32_t* s_val, unsigned* s_cnt, uint8_t* stage) {
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
    } else if constexpr (kForm == kFormCounts) {
      if (kind == kOut) count_row((int)target, a & valid, s_cnt);
    } else if constexpr (kForm == kFormLinear) {
      LinearSink{stage, k, s_cnt}((int)target, kind == kOut ? a & valid : 0u);
    } else {
      store_row(bits, nblocks, b, active, (int)target, kind == kOut ? a & valid : 0u, s_cnt);
    }
  }
}

// The bitvector form runs one tile per CTA.  The counts-only and linear
// forms run resident CTAs looping over the tiles, so each flushes its
// counters once; the linear form's stage follows the node slots in dynamic
// shared memory.
template <int W, int kForm>
__global__ void __launch_bounds__(kStaticThreadsMax)
bitsliced_static_kernel(const uint32_t* __restrict__ tiles, const uint2* __restrict__ prog,
                        int nops, int k, uint32_t* __restrict__ bits,
                        unsigned long long* __restrict__ counts, long long nblocks, long long n,
                        long long block_offset, int slots) {
  extern __shared__ uint32_t s_val[];  // [slot][threadIdx.x], then the linear stage
  __shared__ unsigned s_cnt[kForm == kFormCounts ? kMaxHistKeys : kMaxKeys];
  zero_counts(s_cnt, k);
  if constexpr (kForm == kFormBits) {
    static_tile<W, kForm>(tiles, prog, nops, k, bits, nblocks, n, block_offset, blockIdx.x, s_val,
                          s_cnt, nullptr);
  } else {
    uint32_t* stage = s_val + (size_t)slots * blockDim.x;
    const long long ntiles = (nblocks + blockDim.x - 1) / blockDim.x;
    for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {  // CTA-uniform trip count
      static_tile<W, kForm>(tiles, prog, nops, k, bits, nblocks, n, block_offset, t, s_val, s_cnt,
                            reinterpret_cast<uint8_t*>(stage));
      if constexpr (kForm == kFormLinear) {
        const long long first = t * blockDim.x, left = nblocks - first;
        flush_linear(stage, k, bits, first, left < blockDim.x ? (int)left : (int)blockDim.x);
      }
    }
  }
  flush_counts(s_cnt, k, counts);
}

// One launch of a program of k rows with `threads` threads per CTA and
// smem bytes of dynamic shared memory; a launch that is refused returns
// its error.
template <int W, int kForm>
cudaError_t launch_static(const uint32_t* tiles, const uint2* prog, int nops, int k,
                          uint32_t* bits, unsigned long long* counts, long long nblocks,
                          long long n, long long block_offset, int threads, int slots, size_t smem,
                          cudaStream_t stream) {
  const auto kernel = bitsliced_static_kernel<W, kForm>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const long long ntiles = (nblocks + threads - 1) / threads;
  unsigned grid = (unsigned)ntiles;
  if (err == cudaSuccess && kForm != kFormBits)
    err = resident_grid(kernel, threads, smem, ntiles, &grid);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return err;
  }
  kernel<<<grid, threads, smem, stream>>>(tiles, prog, nops, k, bits, counts, nblocks, n,
                                          block_offset, slots);
  return cudaGetLastError();
}

template <int kForm>
int static_scan(const uint32_t* tiles, const int* prog, int nops, int k, uint32_t* bits,
                unsigned long long* counts, long long nblocks, int width, long long n,
                long long block_offset, int threads, int slots, cudaStream_t stream) {
  const bool k_ok = kForm == kFormCounts ? k >= 1 && k <= kMaxHistKeys
                    : kForm == kFormLinear ? linear_k_ok(k)
                                           : k >= 1 && k <= kMaxKeys;
  if (!k_ok || threads < 32 || threads > kStaticThreadsMax || threads % 32 || slots < width)
    return (int)cudaErrorInvalidValue;
  if (nblocks <= 0) return (int)cudaSuccess;
  size_t smem = (size_t)slots * threads * sizeof(uint32_t);
  if (kForm == kFormLinear) smem += linear_stage_bytes(k, threads);
  const uint2* p = reinterpret_cast<const uint2*>(prog);
  switch (width) {
#define SSS_CASE(W)                                                                         \
  case W:                                                                                   \
    return (int)launch_static<W, kForm>(tiles, p, nops, k, bits, counts, nblocks, n,        \
                                        block_offset, threads, slots, smem, stream);
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
  return sss::static_scan<sss::kFormBits>(tiles, prog, nops, k, bits, counts, nblocks, width,
                                          n, block_offset, threads, slots, stream);
}

// The counts-only form: k <= kMaxHistKeys rows, counts only (int64[k],
// zeroed by the caller).
extern "C" int sss_histogram_dag(const uint32_t* tiles, const int* prog, int nops, int k,
                                 unsigned long long* counts, long long nblocks, int width,
                                 long long n, long long block_offset, int threads, int slots,
                                 cudaStream_t stream) {
  return sss::static_scan<sss::kFormCounts>(tiles, prog, nops, k, nullptr, counts, nblocks,
                                            width, n, block_offset, threads, slots, stream);
}

// The fused linear form of the runtime kernel: out is uint32[nblocks * k],
// block b's linear bytes at [4bk, 4bk + 4k); k % 4 == 0, 4 <= k <= 128.
extern "C" int sss_bitsliced_scan_linear(const uint32_t* tiles, const uint32_t* keys, int k,
                                         uint32_t* out, unsigned long long* counts,
                                         long long nblocks, int width, long long n,
                                         long long block_offset, cudaStream_t stream) {
  if (!sss::linear_k_ok(k)) return (int)cudaErrorInvalidValue;
  if (nblocks <= 0) return (int)cudaSuccess;
  switch (width) {
#define SSS_CASE(W)                                                                          \
  case W:                                                                                    \
    return (int)sss::launch_bitsliced_linear<W>(tiles, keys, k, out, counts, nblocks, n,     \
                                                block_offset, stream);
    SSS_FOR_EACH_WIDTH(SSS_CASE)
#undef SSS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The fused linear form of the static kernel: one program of k rows
// (k % 4 == 0, 4 <= k <= 128), out as in sss_bitsliced_scan_linear;
// dynamic shared memory holds slots * threads node words and the stage.
extern "C" int sss_bitsliced_static_scan_linear(const uint32_t* tiles, const int* prog, int nops,
                                                int k, uint32_t* out, unsigned long long* counts,
                                                long long nblocks, int width, long long n,
                                                long long block_offset, int threads, int slots,
                                                cudaStream_t stream) {
  return sss::static_scan<sss::kFormLinear>(tiles, prog, nops, k, out, counts, nblocks, width, n,
                                            block_offset, threads, slots, stream);
}

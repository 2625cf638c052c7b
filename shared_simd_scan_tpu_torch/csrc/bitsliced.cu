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
//    the plane fold with its rows staged as linear bytes, as
//    interval_scan.cu's fused form does, for keys read from device memory
//    (sss_bitsliced_scan_linear) and for host keys passed by value in the
//    kernel's parameters (sss_bitsliced_static_scan_linear).  The TPU
//    traces the host keys' AND-DAG into the kernel; here each CTA turns the
//    keys into plane masks in shared memory once, read back as
//    broadcasts, so a row costs one three-input AND/XOR per plane with no
//    program and no node slots, and the stage has the CTA's shared memory.
//
// Bound on the H100: device memory bytes (reads W words, writes k words per
// 32 values) while k is small; the integer instruction rate beyond: the runtime fold costs
// ~3 ops per plane per key (one with the masks in shared memory), the
// static DAG one shared-memory AND per node (~57 nodes for 8 spread keys
// at W=9, ~113 for 32).  Design: one thread per
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

// Keys of the fused linear fold: read from device memory (the runtime
// keys), or the host's keys by value in the kernel's parameters (512
// bytes at most; __grid_constant__ keeps them in the parameter space,
// and bench/redesign_sweep.py times the fold on them).
struct DeviceKeys {
  const uint32_t* p;
  __device__ __forceinline__ uint32_t operator[](int j) const { return __ldg(p + j); }
};

struct LinearKeys {
  uint32_t key[kMaxLinearKeys];
  __device__ __forceinline__ uint32_t operator[](int j) const { return key[j]; }
};

// The fused linear fold of the runtime keys (TPU kernel
// _bitsliced_linear_kernel): each key's row staged as linear bytes, four
// rows at a time, the CTA's span stored at once; resident CTAs loop over
// tiles of blockDim.x blocks and flush their counts once.
template <int W, typename Keys>
__global__ void __launch_bounds__(kThreads)
fold_linear_kernel(const uint32_t* __restrict__ tiles, const __grid_constant__ Keys keys, int k,
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
    uint32_t x[kBlockValues];
    unpack_values<W>(w, x);
    transpose_bitplanes<W>(x);
#pragma unroll 1
    for (int j = 0; j < k; j += 4)  // k % 4 == 0
      sink.quad(j, key_row<W>(x, keys[j]) & valid, key_row<W>(x, keys[j + 1]) & valid,
                key_row<W>(x, keys[j + 2]) & valid, key_row<W>(x, keys[j + 3]) & valid);
    const long long left = nblocks - first;
    flush_linear(s_stage, k, out, first, left < blockDim.x ? (int)left : (int)blockDim.x);
  }
  flush_counts(s_cnt, k, counts);
}

// One launch of the fold at `threads` threads a CTA (the stage: threads *
// (k + 1) words of dynamic shared memory); a launch that is refused
// returns its error.
template <int W, typename Keys>
cudaError_t launch_fold_linear(const uint32_t* tiles, const Keys& keys, int k, uint32_t* out,
                               unsigned long long* counts, long long nblocks, long long n,
                               long long block_offset, int threads, cudaStream_t stream) {
  const auto kernel = fold_linear_kernel<W, Keys>;
  const size_t smem = linear_stage_bytes(k, threads);
  unsigned grid = 0;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = resident_grid(kernel, threads, smem, (nblocks + threads - 1) / threads, &grid);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return err;
  }
  kernel<<<grid, threads, smem, stream>>>(tiles, keys, k, out, counts, nblocks, n, block_offset);
  return cudaGetLastError();
}

// The fused linear fold for host keys (TPU kernel _static_linear_kernel).
// The keys come by value in the kernel's parameters; each CTA first turns
// them into plane masks in shared memory, per quad of keys W + 1 uint4:
// plane p's masks ((key >> p) & 1) - 1 of the four keys, then the four
// keys' in-domain words.  Every lane reads the same uint4 (a broadcast),
// so a quad of rows costs one shared load a plane and a row one LOP3 a
// plane; with the masks computed from the keys in the loop, each thread
// spent about three more instructions a plane on them.
template <int W>
__global__ void __launch_bounds__(kThreads)
static_fold_linear_kernel(const uint32_t* __restrict__ tiles,
                          const __grid_constant__ LinearKeys keys, int k,
                          uint32_t* __restrict__ out, unsigned long long* __restrict__ counts,
                          long long nblocks, long long n, long long block_offset) {
  extern __shared__ uint4 s_mask[];  // [k / 4][W + 1], then the stage
  uint32_t* s_stage = reinterpret_cast<uint32_t*>(s_mask + (k / 4) * (W + 1));
  __shared__ unsigned s_cnt[kMaxLinearKeys];
  for (int i = threadIdx.x; i < (k / 4) * (W + 1); i += blockDim.x) {
    const int q = i / (W + 1), p = i % (W + 1);
    uint32_t m[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint32_t key = keys[4 * q + u];
      m[u] = p < W ? ((key >> p) & 1u) - 1u : (key <= value_mask<W>() ? 0xFFFFFFFFu : 0u);
    }
    s_mask[i] = make_uint4(m[0], m[1], m[2], m[3]);
  }
  zero_counts(s_cnt, k);  // (its barrier also publishes the masks)
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
    for (int q = 0; q < k / 4; ++q) {
      const uint4* m = s_mask + q * (W + 1);
      const uint4 alive = m[W];
      uint32_t r0 = alive.x, r1 = alive.y, r2 = alive.z, r3 = alive.w;
#pragma unroll
      for (int p = 0; p < W; ++p) {
        const uint4 mp = m[p];
        r0 &= x[p] ^ mp.x;
        r1 &= x[p] ^ mp.y;
        r2 &= x[p] ^ mp.z;
        r3 &= x[p] ^ mp.w;
      }
      sink.quad(4 * q, r0 & valid, r1 & valid, r2 & valid, r3 & valid);
    }
    const long long left = nblocks - first;
    flush_linear(s_stage, k, out, first, left < blockDim.x ? (int)left : (int)blockDim.x);
  }
  flush_counts(s_cnt, k, counts);
}

inline size_t static_fold_smem(int width, int k, int threads) {
  return (size_t)(k / 4) * (width + 1) * sizeof(uint4) + linear_stage_bytes(k, threads);
}

template <int W>
cudaError_t launch_static_fold(const uint32_t* tiles, const LinearKeys& keys, int k, uint32_t* out,
                               unsigned long long* counts, long long nblocks, long long n,
                               long long block_offset, int threads, cudaStream_t stream) {
  const auto kernel = static_fold_linear_kernel<W>;
  const size_t smem = static_fold_smem(W, k, threads);
  unsigned grid = 0;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = resident_grid(kernel, threads, smem, (nblocks + threads - 1) / threads, &grid);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return err;
  }
  kernel<<<grid, threads, smem, stream>>>(tiles, keys, k, out, counts, nblocks, n, block_offset);
  return cudaGetLastError();
}

// Threads a CTA of the static fold: 128 tied 256 at k = 8 and 64 and won
// at k = 128, where 256 threads' stage (132 KB) leaves one CTA an SM
// (bench/redesign_sweep.py).
constexpr int kStaticFoldThreads = 128;

// Forms of the static kernel: the (k, nblocks) bits; counts only (the
// histogram's, row 10 of the TPU kernel table).
constexpr int kFormBits = 0, kFormCounts = 1;

// One tile of the static kernel: thread threadIdx.x takes block
// t * blockDim.x + threadIdx.x, unpacks and transposes it into planes in
// its slots, and runs the program.  OUT and ZERO by form: the bits form
// stores row target (a & valid, or 0) and counts it; the counts form adds
// popc(a & valid) to its row's shared counter for OUT and nothing for
// ZERO.
template <int W, int kForm>
__device__ __forceinline__ void static_tile(const uint32_t* __restrict__ tiles,
                                            const uint2* __restrict__ prog, int nops, int k,
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
    } else if constexpr (kForm == kFormCounts) {
      if (kind == kOut) count_row((int)target, a & valid, s_cnt);
    } else {
      store_row(bits, nblocks, b, active, (int)target, kind == kOut ? a & valid : 0u, s_cnt);
    }
  }
}

// The bitvector form runs one tile per CTA.  The counts-only form runs
// resident CTAs looping over the tiles, so each flushes its counters once.
template <int W, int kForm>
__global__ void __launch_bounds__(kStaticThreadsMax)
bitsliced_static_kernel(const uint32_t* __restrict__ tiles, const uint2* __restrict__ prog,
                        int nops, int k, uint32_t* __restrict__ bits,
                        unsigned long long* __restrict__ counts, long long nblocks, long long n,
                        long long block_offset, int slots) {
  extern __shared__ uint32_t s_val[];  // [slot][threadIdx.x]
  __shared__ unsigned s_cnt[kForm == kFormCounts ? kMaxHistKeys : kMaxKeys];
  zero_counts(s_cnt, k);
  if constexpr (kForm == kFormBits) {
    static_tile<W, kForm>(tiles, prog, nops, k, bits, nblocks, n, block_offset, blockIdx.x, s_val,
                          s_cnt);
  } else {
    const long long ntiles = (nblocks + blockDim.x - 1) / blockDim.x;
    for (long long t = blockIdx.x; t < ntiles; t += gridDim.x)  // CTA-uniform trip count
      static_tile<W, kForm>(tiles, prog, nops, k, bits, nblocks, n, block_offset, t, s_val, s_cnt);
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
  const bool k_ok = kForm == kFormCounts ? k >= 1 && k <= kMaxHistKeys : k >= 1 && k <= kMaxKeys;
  if (!k_ok || threads < 32 || threads > kStaticThreadsMax || threads % 32 || slots < width)
    return (int)cudaErrorInvalidValue;
  if (nblocks <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)slots * threads * sizeof(uint32_t);
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

// The fused linear fold for keys in device memory: out is uint32[nblocks *
// k], block b's linear bytes at [4bk, 4bk + 4k); k % 4 == 0, 4 <= k <= 128.
extern "C" int sss_bitsliced_scan_linear(const uint32_t* tiles, const uint32_t* keys, int k,
                                         uint32_t* out, unsigned long long* counts,
                                         long long nblocks, int width, long long n,
                                         long long block_offset, cudaStream_t stream) {
  if (!sss::linear_k_ok(k)) return (int)cudaErrorInvalidValue;
  if (nblocks <= 0) return (int)cudaSuccess;
  const sss::DeviceKeys dk{keys};
  const int threads = sss::linear_threads(k);
  switch (width) {
#define SSS_CASE(W)                                                                          \
  case W:                                                                                    \
    return (int)sss::launch_fold_linear<W>(tiles, dk, k, out, counts, nblocks, n,            \
                                           block_offset, threads, stream);
    SSS_FOR_EACH_WIDTH(SSS_CASE)
#undef SSS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The fused linear fold for host keys (k % 4 == 0, 4 <= k <= 128), passed
// by value in the kernel's parameters: keys is a host array of k uint32;
// out as in sss_bitsliced_scan_linear.  kStaticFoldThreads threads a CTA;
// shared memory holds the plane masks and the stage.
extern "C" int sss_bitsliced_static_scan_linear(const uint32_t* tiles, const uint32_t* keys, int k,
                                                uint32_t* out, unsigned long long* counts,
                                                long long nblocks, int width, long long n,
                                                long long block_offset, cudaStream_t stream) {
  if (!sss::linear_k_ok(k)) return (int)cudaErrorInvalidValue;
  if (nblocks <= 0) return (int)cudaSuccess;
  sss::LinearKeys hk{};
  for (int j = 0; j < k; ++j) hk.key[j] = keys[j];
  switch (width) {
#define SSS_CASE(W)                                                                          \
  case W:                                                                                    \
    return (int)sss::launch_static_fold<W>(tiles, hk, k, out, counts, nblocks, n,            \
                                           block_offset, sss::kStaticFoldThreads, stream);
    SSS_FOR_EACH_WIDTH(SSS_CASE)
#undef SSS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

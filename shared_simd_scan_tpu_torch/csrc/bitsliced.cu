// Bit-sliced shared scans: runtime keys and host keys by the plane fold;
// their member (IN-list) form for runtime keys, one row; and the static
// AND-DAG interpreter of the histogram's programs.
//
// Replaces shared_simd_scan_tpu/ops/scan.py:
//  - _shared_scan_bitsliced_kernel / shared_scan_bitsliced_tiles: keys read
//    from device memory, any k; per key match = AND_p (plane_p ^
//    (bit_p(key) - 1)), killed for keys >= 2^W;
//  - _shared_scan_bitsliced_static_kernel / _bitsliced_static_tiles_impl:
//    host keys.  The TPU traces the key set's memoized _combo AND-DAG over
//    the planes into the kernel; nvcc cannot specialize per key set.  Here
//    the same plane fold as the runtime keys, with each CTA turning the
//    keys (read once from device memory) into plane masks in shared
//    memory, read back as broadcasts, so a row costs one three-input
//    AND/XOR per plane with no program (sss_bitsliced_static_fold, rows in
//    tile order);
//  - ops/member.py _member_bitsliced_kernel: the runtime plane fold with
//    the key rows ORed into one row (sss_member_bitsliced, the kMember
//    form of the runtime kernel).  The member OR-tree body is not here: on
//    this card it is a set lookup per value (member.cu sss_member_lookup);
//  - _histogram_dag_kernel / _histogram_dag_tiles_impl: histogram counts
//    of consecutive host keys, no bitvector.  The TPU interprets each
//    chunk's AND-DAG, one launch a group of keys; here one launch counts
//    all k.  At width 1, and for a few keys of a narrow column, the static
//    fold counts the keys lo..lo+k-1 from their plane masks, every row
//    popcounted and never stored (sss_histogram_fold, the kFoldCounts
//    form: at width 1 a block's counts are two popcounts, where the bins
//    kernel takes 32 shared atomics on two addresses); elsewhere the bins
//    kernel with lo by value (histogram.cu sss_histogram_span), which is
//    also the span form (_histogram_span_kernel);
//  - _bitsliced_linear_kernel / _bitsliced_linear_tiles_impl (scan.py:1025)
//    and _static_linear_kernel / _static_linear_tiles_impl (scan.py:854):
//    the plane fold with its rows staged as linear bytes, as
//    interval_scan.cu's fused form does, for keys read from device memory
//    (sss_bitsliced_scan_linear) and for host keys passed by value in the
//    kernel's parameters (sss_bitsliced_static_scan_linear, the static
//    fold's body with the linear stage).
//
// Bound on the H100: device memory bytes (reads W words, writes k words per
// 32 values) while k is small; the integer instruction rate beyond: the
// runtime fold costs ~3 ops per plane per key, the static fold one (the
// masks in shared memory).  Design: one thread per 32-value block; the 32
// values are unpacked and transposed into planes in registers by the
// pruned butterfly (common.cuh).  The runtime kernel keeps the planes in
// registers and does not unroll its key loop.  A launch that asks for more
// shared memory than a CTA has is refused and returns its error.  Counts
// as in shared_scan.cu.
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

// Keys of the folds: read from device memory (the runtime keys, and the
// tile-order static fold's up to kMaxKeys host keys, copied once), or the
// host's keys by value in the kernel's parameters (the linear static
// fold's 512 bytes at most; __grid_constant__ keeps them in the parameter
// space, and bench/redesign_sweep.py times the fold on them).
struct DeviceKeys {
  const uint32_t* p;
  __device__ __forceinline__ uint32_t operator[](int j) const { return __ldg(p + j); }
};

struct LinearKeys {
  uint32_t key[kMaxLinearKeys];
  __device__ __forceinline__ uint32_t operator[](int j) const { return key[j]; }
};

// The histogram's keys lo, lo + 1, ...: a key past 2^32 - 1 becomes
// 0xFFFFFFFF, outside every domain, so it counts 0 and nothing wraps.
struct SpanKeys {
  uint32_t lo;
  __device__ __forceinline__ uint32_t operator[](int j) const {
    const unsigned long long key = (unsigned long long)lo + (unsigned)j;
    return key > 0xFFFFFFFFull ? 0xFFFFFFFFu : (uint32_t)key;
  }
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

// Where the static fold's rows go: staged as linear bytes (TPU kernel
// _static_linear_kernel), stored in tile order to (k, nblocks) bits
// (TPU kernel _shared_scan_bitsliced_static_kernel), or only counted (TPU
// kernel _histogram_dag_kernel).
constexpr int kFoldLinear = 0, kFoldRows = 1, kFoldCounts = 2;

// Plane masks of keys j0 .. j0 + 4 * nq - 1 in shared memory, per quad of
// keys W + 1 uint4: plane p's masks ((key >> p) & 1) - 1 of the four
// keys, then the four keys' in-domain words.  A slot past the k keys gets
// the key 0xFFFFFFFF, whose row is zero and is never stored.
template <int W, typename Keys>
__device__ __forceinline__ void stage_fold_masks(uint4* s_mask, const Keys& keys, int j0, int k,
                                                 int nq) {
  for (int i = threadIdx.x; i < nq * (W + 1); i += blockDim.x) {
    const int q = i / (W + 1), p = i % (W + 1);
    uint32_t m[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + 4 * q + u;
      const uint32_t key = j < k ? keys[j] : 0xFFFFFFFFu;
      m[u] = p < W ? ((key >> p) & 1u) - 1u : (key <= value_mask<W>() ? 0xFFFFFFFFu : 0u);
    }
    s_mask[i] = make_uint4(m[0], m[1], m[2], m[3]);
  }
}

// Rows j..j+3 of block b stored at [row, b] and counted; rows at k and
// past are not stored (j and k are warp-uniform).  The launch's last quad
// when k % 4 != 0.
__device__ __forceinline__ void store_quad(uint32_t* __restrict__ bits, long long nblocks,
                                           long long b, bool active, int j, int k, uint32_t r0,
                                           uint32_t r1, uint32_t r2, uint32_t r3,
                                           unsigned* s_cnt) {
  store_row(bits, nblocks, b, active, j, r0, s_cnt);
  if (j + 1 < k) store_row(bits, nblocks, b, active, j + 1, r1, s_cnt);
  if (j + 2 < k) store_row(bits, nblocks, b, active, j + 2, r2, s_cnt);
  if (j + 3 < k) store_row(bits, nblocks, b, active, j + 3, r3, s_cnt);
}

// Rows j0 .. j0 + 4 nq - 1 of this thread's block from their plane masks
// in s_mask (quad q at s_mask + q (W + 1)): staged as linear bytes
// (kFoldLinear), stored to row j at out[j * nblocks + b] (kFoldRows),
// coalesced across the warp, or counted alone (kFoldCounts; a row past k
// is zero and adds 0 to its counter).  Every lane reads the same uint4 (a
// broadcast), so a quad of rows costs one shared load a plane and a row
// one LOP3 a plane.
template <int W, int kOut>
__device__ __forceinline__ void fold_chunk(const uint32_t (&x)[kBlockValues],
                                           const uint4* s_mask, int j0, int nq, int k,
                                           uint32_t valid, const LinearSink& sink,
                                           uint32_t* __restrict__ out, long long nblocks,
                                           long long b, bool active, unsigned* s_cnt) {
  uint32_t* row = out + (size_t)j0 * nblocks + b;  // (kFoldRows) row j0 of block b
#pragma unroll 1
  for (int q = 0; q < nq; ++q, row += 4 * nblocks) {
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
    const int j = j0 + 4 * q;
    r0 &= valid;
    r1 &= valid;
    r2 &= valid;
    r3 &= valid;
    if constexpr (kOut == kFoldLinear) {
      sink.quad(j, r0, r1, r2, r3);
    } else if constexpr (kOut == kFoldCounts) {
      count_quad(j, r0, r1, r2, r3, s_cnt);
    } else if (j + 4 <= k) {
      count_quad(j, r0, r1, r2, r3, s_cnt);
      if (active) {
        row[0] = r0;
        row[nblocks] = r1;
        row[2 * nblocks] = r2;
        row[3 * nblocks] = r3;
      }
    } else {
      store_quad(out, nblocks, b, active, j, k, r0, r1, r2, r3, s_cnt);
    }
  }
}

// The plane fold for host keys, one body for both outputs.  Each CTA
// turns the keys into plane masks in shared memory (stage_fold_masks) and
// folds every row from them (fold_chunk); with the masks computed from
// the keys in the loop, each thread spent about three more instructions
// a plane on them.  Resident CTAs loop over tiles of blockDim.x blocks
// and flush their counts once.  kFoldLinear (k % 4 == 0, k <= 128) stages
// all k keys' masks once and each tile's rows as linear bytes, and stores
// the CTA's span at once.  kFoldRows and kFoldCounts (k <= kMaxKeys) stage
// the masks of up to `chunk` keys (chunk % 4 == 0) once; more keys are
// staged a chunk at a time in every tile, between two barriers.
template <int W, typename Keys, int kOut>
__global__ void __launch_bounds__(kThreads)
static_fold_kernel(const uint32_t* __restrict__ tiles, const __grid_constant__ Keys keys, int k,
                   int chunk, uint32_t* __restrict__ out, unsigned long long* __restrict__ counts,
                   long long nblocks, long long n, long long block_offset) {
  extern __shared__ uint4 s_mask[];  // [chunk / 4][W + 1], then the linear stage
  __shared__ unsigned s_cnt[kOut == kFoldLinear ? kMaxLinearKeys : kMaxKeys];
  uint32_t* s_stage = reinterpret_cast<uint32_t*>(s_mask + (chunk / 4) * (W + 1));
  const bool restage = kOut != kFoldLinear && k > chunk;
  if (!restage) stage_fold_masks<W>(s_mask, keys, 0, k, (k + 3) / 4);
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
    if constexpr (kOut == kFoldLinear) {
      fold_chunk<W, kOut>(x, s_mask, 0, k / 4, k, valid, sink, out, nblocks, b, active, s_cnt);
      const long long left = nblocks - first;
      flush_linear(s_stage, k, out, first, left < blockDim.x ? (int)left : (int)blockDim.x);
    } else {
      for (int j0 = 0; j0 < k; j0 += chunk) {
        const int nq = ((k - j0 < chunk ? k - j0 : chunk) + 3) / 4;
        if (restage) {
          __syncthreads();  // every warp is done with the last chunk's masks
          stage_fold_masks<W>(s_mask, keys, j0, k, nq);
          __syncthreads();
        }
        fold_chunk<W, kOut>(x, s_mask, j0, nq, k, valid, sink, out, nblocks, b, active, s_cnt);
      }
    }
  }
  flush_counts(s_cnt, k, counts);
}

// Dynamic shared memory of the fold: the masks of a chunk, and the linear
// form's stage.
inline size_t static_fold_smem(int width, int k, int chunk, int out_form, int threads) {
  return (size_t)(chunk / 4) * (width + 1) * sizeof(uint4) +
         (out_form == kFoldLinear ? linear_stage_bytes(k, threads) : 0);
}

// One launch of the fold at `threads` threads a CTA; a launch that is
// refused returns its error.
template <int W, typename Keys, int kOut>
cudaError_t launch_static_fold(const uint32_t* tiles, const Keys& keys, int k, int chunk,
                               uint32_t* out, unsigned long long* counts, long long nblocks,
                               long long n, long long block_offset, int threads,
                               cudaStream_t stream) {
  const auto kernel = static_fold_kernel<W, Keys, kOut>;
  const size_t smem = static_fold_smem(W, k, chunk, kOut, threads);
  const long long ntiles = (nblocks + threads - 1) / threads;
  unsigned grid = 0;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) err = resident_grid(kernel, threads, smem, ntiles, &grid);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return err;
  }
  const long long least = least_ctas(ntiles, threads);
  if (grid < least) grid = (unsigned)least;
  kernel<<<grid, threads, smem, stream>>>(tiles, keys, k, chunk, out, counts, nblocks, n,
                                          block_offset);
  return cudaGetLastError();
}

// Threads a CTA of the static fold: for the linear form, 128 tied 256 at
// k = 8 and 64 and won at k = 128, where 256 threads' stage (132 KB)
// leaves one CTA an SM (bench/redesign_sweep.py fold).
constexpr int kStaticFoldThreads = 128;
// The tile-order form: its threads a CTA, and the shared memory its masks
// may take (up to kFoldMaskBytes / (16 (W + 1)) quads of keys at once;
// more keys are staged a chunk at a time).  256 threads beat 128 by 2-4%
// at 8 to 256 keys and by 13% at 1024 keys of width 31, where chunks of
// 16 to 64 KB tied and all 128 KB at once (one CTA an SM) ran 1.65x
// slower (bench/redesign_sweep.py static, NVIDIA H100 80GB HBM3, 700 W).
constexpr int kStaticRowsThreads = 256;
constexpr int kFoldMaskBytes = 48 * 1024;

// Keys of a chunk of the tile-order fold at width w: all k when their
// masks fit kFoldMaskBytes, else the most whole quads that fit.
inline int static_rows_chunk(int width, int k) {
  const int fit = kFoldMaskBytes / (16 * (width + 1)) * 4;
  const int all = (k + 3) / 4 * 4;
  return all < fit ? all : fit;
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

// The static fold in tile order: keys is a device array of k <= kMaxKeys
// uint32 (host keys, copied once by the caller); bits (k, nblocks) and
// counts int64[k] (zeroed by the caller) as in sss_bitsliced_scan.
extern "C" int sss_bitsliced_static_fold(const uint32_t* tiles, const uint32_t* keys, int k,
                                         uint32_t* bits, unsigned long long* counts,
                                         long long nblocks, int width, long long n,
                                         long long block_offset, cudaStream_t stream) {
  if (k < 1 || k > sss::kMaxKeys || !sss::width_ok(width)) return (int)cudaErrorInvalidValue;
  if (nblocks <= 0) return (int)cudaSuccess;
  const sss::DeviceKeys dk{keys};
  const int chunk = sss::static_rows_chunk(width, k);
  switch (width) {
#define SSS_CASE(W)                                                                          \
  case W:                                                                                    \
    return (int)sss::launch_static_fold<W, sss::DeviceKeys, sss::kFoldRows>(                 \
        tiles, dk, k, chunk, bits, counts, nblocks, n, block_offset,                         \
        sss::kStaticRowsThreads, stream);
    SSS_FOR_EACH_WIDTH(SSS_CASE)
#undef SSS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The counts of keys lo..lo+k-1 (1 <= k <= kMaxKeys; keys past 2^32 - 1
// count 0) by the fold, no bitvector: counts int64[k], zeroed by the
// caller.  Widths 1-8, the narrow columns where it can beat the bins
// kernel (ops/scan.py _histogram_fold_keys).
extern "C" int sss_histogram_fold(const uint32_t* tiles, uint32_t lo, int k,
                                  unsigned long long* counts, long long nblocks, int width,
                                  long long n, long long block_offset, cudaStream_t stream) {
  if (k < 1 || k > sss::kMaxKeys || width < 1 || width > 8)
    return (int)cudaErrorInvalidValue;
  if (nblocks <= 0) return (int)cudaSuccess;
  const sss::SpanKeys keys{lo};
  const int chunk = sss::static_rows_chunk(width, k);
  switch (width) {
#define SSS_CASE(W)                                                                          \
  case W:                                                                                    \
    return (int)sss::launch_static_fold<W, sss::SpanKeys, sss::kFoldCounts>(                 \
        tiles, keys, k, chunk, nullptr, counts, nblocks, n, block_offset,                    \
        sss::kStaticRowsThreads, stream);
    SSS_CASE(1) SSS_CASE(2) SSS_CASE(3) SSS_CASE(4) SSS_CASE(5) SSS_CASE(6) SSS_CASE(7)
    SSS_CASE(8)
#undef SSS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
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
    return (int)sss::launch_static_fold<W, sss::LinearKeys, sss::kFoldLinear>(               \
        tiles, hk, k, k, out, counts, nblocks, n, block_offset, sss::kStaticFoldThreads,     \
        stream);
    SSS_FOR_EACH_WIDTH(SSS_CASE)
#undef SSS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Bit-sliced shared scans: runtime keys and host keys by the plane fold;
// the histogram's counts of consecutive host keys; and the fused linear
// export.
//
// Replaces shared_simd_scan_tpu/ops/scan.py:
//  - _shared_scan_bitsliced_kernel / shared_scan_bitsliced_tiles: keys read
//    from device memory, any k; per key match = AND_p (plane_p ^
//    (bit_p(key) - 1)), killed for keys >= 2^W.  Here the fold in tile order
//    below on the key tensor (sss_bitsliced_static_fold, one launch per
//    kMaxKeys keys): each CTA stages the keys' plane masks in shared memory
//    once, so a row costs one three-input AND/XOR a plane, where the masks
//    computed from each key in the key loop cost about three instructions
//    (ops/scan.py _runtime_lookup_wins sends some widths and k to the
//    dynamic scan's key lookup instead);
//  - _shared_scan_bitsliced_static_kernel / _bitsliced_static_tiles_impl:
//    host keys.  The TPU traces the key set's memoized _combo AND-DAG over
//    the planes into the kernel; nvcc cannot specialize per key set.  Here
//    the same fold, the keys copied to device memory once a key set
//    (sss_bitsliced_static_fold, rows in tile order);
//  - the member (IN-list) bodies are not here: ops/member.py
//    _member_bitsliced_kernel, the plane fold with the key rows ORed into
//    one row, is on this card one lookup a value in the keys' table built
//    on the card (member.cu sss_member_compare), and the OR-tree body a
//    set lookup per value (member.cu sss_member_lookup);
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
//    the static fold's body with its rows staged as linear bytes, as
//    interval_scan.cu's fused form does, for keys read from device memory
//    (sss_bitsliced_scan_linear: each CTA stages the runtime keys' plane
//    masks once, as it does host keys') and for host keys passed by value
//    in the kernel's parameters (sss_bitsliced_static_scan_linear).
//
// Bound on the H100: device memory bytes (reads W words, writes k words per
// 32 values) while k is small; the integer instruction rate beyond: every
// fold stages its masks in shared memory and pays one LOP3 per plane per
// key (masks computed from each key in its loop cost about three).
// Design: one thread per 32-value block; the 32 values are unpacked and
// transposed into planes in registers by the pruned butterfly
// (common.cuh).  A launch that asks for more shared memory than a CTA has
// is refused and returns its error.  Counts as in shared_scan.cu.
#include "common.cuh"

namespace sss {

// Row of one key from the bit planes x[0..W-1]: AND_p (plane_p ^
// (bit_p(key) - 1)), zero for a key >= 2^W; its masks computed from the key
// (bench/redesign_sweep_bins_fold.cu times it beside the staged masks).
template <int W>
__device__ __forceinline__ uint32_t key_row(const uint32_t (&x)[kBlockValues], uint32_t key) {
  uint32_t acc = key <= value_mask<W>() ? 0xFFFFFFFFu : 0u;
#pragma unroll
  for (int p = 0; p < W; ++p) acc &= x[p] ^ (((key >> p) & 1u) - 1u);
  return acc;
}

// Keys of the folds: read from device memory (DeviceKeys, common.cuh: the
// runtime keys, and the tile-order static fold's up to kMaxKeys host keys,
// copied once), or the host's keys by value in the kernel's parameters (the
// linear static fold's 512 bytes at most; __grid_constant__ keeps them in
// the parameter space, and bench/redesign_sweep.py times the fold on them).
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

// The plane fold for a key set, one body for every output: host keys, and
// runtime keys (in tile order, and the linear export's).  Each CTA turns
// the keys into plane masks in shared memory (stage_fold_masks) and folds
// every row from them (fold_chunk); with the masks computed from the keys
// in the loop, each thread spent about three more instructions a plane on
// them.  Resident CTAs loop over tiles of blockDim.x blocks and flush their
// counts once.  kFoldLinear (k % 4 == 0, k <= 128) stages
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

// The fold in tile order: keys is a device array of k <= kMaxKeys uint32
// (the runtime keys, or host keys copied once by the caller); bits (k,
// nblocks) and counts int64[k] (zeroed by the caller), row j at bits[j *
// nblocks + b].
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

// The fused linear fold for keys in device memory (never read on the host):
// out is uint32[nblocks * k], block b's linear bytes at [4bk, 4bk + 4k); k
// % 4 == 0, 4 <= k <= 128.  The static fold's body on the keys through
// DeviceKeys: each CTA stages their plane masks once (a key >= 2^W, and
// 0xFFFFFFFF, gets a zero in-domain word, so its row is zero), then the
// stage of kStaticFoldThreads blocks' rows (at k = 128, 66 KB and 16 KB of
// masks at width 31).
extern "C" int sss_bitsliced_scan_linear(const uint32_t* tiles, const uint32_t* keys, int k,
                                         uint32_t* out, unsigned long long* counts,
                                         long long nblocks, int width, long long n,
                                         long long block_offset, cudaStream_t stream) {
  if (!sss::linear_k_ok(k)) return (int)cudaErrorInvalidValue;
  if (nblocks <= 0) return (int)cudaSuccess;
  const sss::DeviceKeys dk{keys};
  switch (width) {
#define SSS_CASE(W)                                                                          \
  case W:                                                                                    \
    return (int)sss::launch_static_fold<W, sss::DeviceKeys, sss::kFoldLinear>(               \
        tiles, dk, k, k, out, counts, nblocks, n, block_offset, sss::kStaticFoldThreads,     \
        stream);
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

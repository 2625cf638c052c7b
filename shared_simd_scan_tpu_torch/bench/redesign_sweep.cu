// The copy, chunked-scan and dynamic-scan designs side by side, for
// bench/redesign_sweep.py to time on the card.  Not part of the kernel
// library: it includes the library's copy.cu and shared_scan.cu for their
// templates (the bulk-copy ring at any stage size, depth and run of chunks
// a CTA, or on the resident grid; the key-lookup chunked scan at any chunk
// and CTA size; the dynamic scan at any group of rows and CTA size, and
// without its lookups or its row stores) and adds the designs the library
// does not use:
//   - the per-thread batch copy: one CTA per 2048 16-byte vectors, each
//     thread eight streaming loads, then its eight stores;
//   - the persistent grid-stride copy, software-pipelined: the loads of the
//     next step are issued before the stores of this one;
//   - the register compare chunked scan: a CTA holds 16 keys in registers
//     and compares each with the 32 values of its block;
//   - the key-lookup chunked scan with a shared atomic per row and warp for
//     the counts, each row update right after its lookup;
//   - the key-lookup chunked scan with rep in registers (four bytes a
//     word) and a warp's count of row j in lane j % 32's register, flushed
//     once per CTA, instead of a shared atomic per row and warp;
//   - the library's chunked kernel with its lookups, its counts or its row
//     stores taken out, to time each part;
//   - the dynamic compare, which the library's dynamic scan replaced:
//     the values of a tile in shared memory, read back for every key.
#include "../csrc/copy.cu"
#include "../csrc/shared_scan.cu"

namespace sss {

constexpr int kBatch = 8;

__global__ void __launch_bounds__(kThreads)
copy_batch_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst, long long nvec,
                  const uint8_t* __restrict__ src_tail, uint8_t* __restrict__ dst_tail, int tail) {
  const long long first = (long long)blockIdx.x * (kThreads * kBatch) + threadIdx.x;
  uint4 r[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const long long i = first + (long long)u * kThreads;
    r[u] = i < nvec ? __ldcs(src + i) : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const long long i = first + (long long)u * kThreads;
    if (i < nvec) __stcs(dst + i, r[u]);
  }
  if (blockIdx.x == 0 && (int)threadIdx.x < tail) dst_tail[threadIdx.x] = src_tail[threadIdx.x];
}

template <int B>
__global__ void __launch_bounds__(kThreads)
copy_pipelined_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst, long long nvec,
                      const uint8_t* __restrict__ src_tail, uint8_t* __restrict__ dst_tail,
                      int tail) {
  const long long stride = (long long)gridDim.x * kThreads * B;
  long long i = (long long)blockIdx.x * kThreads * B + threadIdx.x;
  uint4 cur[B];
#pragma unroll
  for (int u = 0; u < B; ++u) {
    const long long j = i + (long long)u * kThreads;
    cur[u] = j < nvec ? __ldcs(src + j) : make_uint4(0u, 0u, 0u, 0u);
  }
  for (; i < nvec; i += stride) {
    uint4 nxt[B];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const long long j = i + stride + (long long)u * kThreads;
      nxt[u] = j < nvec ? __ldcs(src + j) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const long long j = i + (long long)u * kThreads;
      if (j < nvec) __stcs(dst + j, cur[u]);
    }
#pragma unroll
    for (int u = 0; u < B; ++u) cur[u] = nxt[u];
  }
  if (blockIdx.x == 0 && (int)threadIdx.x < tail) dst_tail[threadIdx.x] = src_tail[threadIdx.x];
}

template <int C, int T, bool kDirect>
__global__ void __launch_bounds__(T)
chunked_register_counts_kernel(const uint32_t* __restrict__ tiles,
                               const uint32_t* __restrict__ keys, int k,
                               uint32_t* __restrict__ bits,
                               unsigned long long* __restrict__ counts, long long nblocks,
                               int width, long long n, long long block_offset, long long ntiles) {
  extern __shared__ __align__(16) uint32_t s_mem[];
  const ChunkSmem<C, T> s(s_mem);
  const int j0 = blockIdx.x * C;
  const int kc = k - j0 < C ? k - j0 : C;  // real rows of this chunk
  chunk_setup<C, T, kDirect>(s, keys, j0, kc, (1u << width) - 1u);
  uint32_t rep4[C / 4];
#pragma unroll
  for (int q = 0; q < C / 4; ++q) rep4[q] = reinterpret_cast<const uint32_t*>(s.rep)[q];
  unsigned cnt[C / 32];
#pragma unroll
  for (int q = 0; q < C / 32; ++q) cnt[q] = 0u;
  const int lane = threadIdx.x & 31;
  uint32_t* rows = bits + (size_t)j0 * nblocks;
  uint32_t* col = s.rows + threadIdx.x;
  for (long long tile = blockIdx.y; tile < ntiles; tile += gridDim.y) {
    const long long b = tile * T + threadIdx.x;
    const bool active = b < nblocks;
    uint32_t v[kBlockValues];
    unpack_block_any(width, tiles, nblocks, b, active, v);
#pragma unroll
    for (int r = 0; r < kBlockValues; ++r) {  // v[r] becomes the row value r hit
      v[r] = chunk_lookup<C, T, kDirect>(s, v[r]);
      if (v[r] != kNoKey) col[v[r] * T] |= 1u << r;
    }
    const uint32_t valid = active ? valid_word(block_offset + b, n) : 0u;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (j < kc) {  // uniform across the CTA
        const uint32_t word = col[((rep4[j / 4] >> (8 * (j % 4))) & 0xFFu) * T] & valid;
        if (active) rows[(size_t)j * nblocks + b] = word;
        const unsigned c = __reduce_add_sync(0xFFFFFFFFu, (unsigned)__popc(word));
        if (lane == j % 32) cnt[j / 32] += c;
      }
    }
#pragma unroll
    for (int r = 0; r < kBlockValues; ++r)
      if (v[r] != kNoKey) col[v[r] * T] = 0u;
  }
#pragma unroll
  for (int q = 0; q < C / 32; ++q)
    if (q * 32 + lane < kc && cnt[q]) atomicAdd(s.cnt + q * 32 + lane, cnt[q]);
  flush_counts(s.cnt, kc, counts + j0);
}

// The library's chunked kernel with one part taken out, to time the parts:
// kMode 1 skips the lookups (each value marks the row of its own value, so
// the values and the tile loads stay live), 2 stores the rows
// without counting them, 3 counts the rows without storing them.  Its bits
// or counts are wrong by design; the sweep only times it.
template <int C, int T, bool kDirect, int kMode>
__global__ void __launch_bounds__(T)
chunked_ablation_kernel(const uint32_t* __restrict__ tiles, const uint32_t* __restrict__ keys,
                        int k, uint32_t* __restrict__ bits,
                        unsigned long long* __restrict__ counts, long long nblocks, int width,
                        long long n, long long block_offset, long long ntiles) {
  extern __shared__ __align__(16) uint32_t s_mem[];
  const ChunkSmem<C, T> s(s_mem);
  const int j0 = blockIdx.x * C;
  const int kc = k - j0 < C ? k - j0 : C;
  chunk_setup<C, T, kDirect>(s, keys, j0, kc, (1u << width) - 1u);
  uint32_t* rows = bits + (size_t)j0 * nblocks;
  uint32_t* col = s.rows + threadIdx.x;
  for (long long tile = blockIdx.y; tile < ntiles; tile += gridDim.y) {
    const long long b = tile * T + threadIdx.x;
    const bool active = b < nblocks;
    uint32_t v[kBlockValues];
    unpack_block_any(width, tiles, nblocks, b, active, v);
    for (int i = 0; i < kc; ++i) col[i * T] = 0u;
    if (kMode != 1) chunk_mark_rows<C, T, kDirect>(s, col, v);
    else mark_rows<T, C>(col, v, 0u);  // each value marks the row of its own value
    const uint32_t valid = active ? valid_word(block_offset + b, n) : 0u;
    chunk_store_rows<C, T, kMode != 3, kMode != 2>(s, col, rows + b, nblocks, active, kc,
                                                    valid);
  }
  flush_counts(s.cnt, kc, counts + j0);
}

// The key lookup with a shared atomic per row and warp for the counts
// (through store_row), and each row update right after its lookup.
template <int C, int T, bool kDirect>
__global__ void __launch_bounds__(T)
chunked_row_atomics_kernel(const uint32_t* __restrict__ tiles, const uint32_t* __restrict__ keys,
                           int k, uint32_t* __restrict__ bits,
                           unsigned long long* __restrict__ counts, long long nblocks, int width,
                           long long n, long long block_offset, long long ntiles) {
  extern __shared__ __align__(16) uint32_t s_mem[];
  const ChunkSmem<C, T> s(s_mem);
  const int j0 = blockIdx.x * C;
  const int kc = k - j0 < C ? k - j0 : C;
  chunk_setup<C, T, kDirect>(s, keys, j0, kc, (1u << width) - 1u);
  uint32_t* rows = bits + (size_t)j0 * nblocks;
  uint32_t* col = s.rows + threadIdx.x;
  for (long long tile = blockIdx.y; tile < ntiles; tile += gridDim.y) {
    const long long b = tile * T + threadIdx.x;
    const bool active = b < nblocks;
    uint32_t v[kBlockValues];
    unpack_block_any(width, tiles, nblocks, b, active, v);
    for (int i = 0; i < kc; ++i) col[i * T] = 0u;
#pragma unroll
    for (int r = 0; r < kBlockValues; ++r) {
      const uint32_t idx = chunk_lookup<C, T, kDirect>(s, v[r]);
      if (idx != kNoKey) col[idx * T] |= 1u << r;
    }
    const uint32_t valid = active ? valid_word(block_offset + b, n) : 0u;
    for (int j = 0; j < kc; ++j)
      store_row(rows, nblocks, b, active, j, col[s.rep[j] * T] & valid, s.cnt);
  }
  flush_counts(s.cnt, kc, counts + j0);
}

template <int B>
cudaError_t copy_pipelined_launch(const void* src, void* dst, long long nbytes,
                                  cudaStream_t stream) {
  const long long nvec = nbytes / 16;
  unsigned grid = 0;
  const long long steps = (nvec + kThreads * B - 1) / (kThreads * B);
  cudaError_t err = resident_grid(copy_pipelined_kernel<B>, kThreads, 0, steps > 0 ? steps : 1,
                                  &grid);
  if (err != cudaSuccess) return err;
  copy_pipelined_kernel<B><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst), nvec,
      static_cast<const uint8_t*>(src) + nvec * 16, static_cast<uint8_t*>(dst) + nvec * 16,
      (int)(nbytes % 16));
  return cudaGetLastError();
}

constexpr int kCompareKeys = 16;

__global__ void __launch_bounds__(kThreads)
chunked_compare_kernel(const uint32_t* __restrict__ tiles, const uint32_t* __restrict__ keys,
                       int k, uint32_t* __restrict__ bits, unsigned long long* __restrict__ counts,
                       long long nblocks, int width, long long n, long long block_offset,
                       long long ntiles) {
  constexpr int C = kCompareKeys;
  __shared__ unsigned s_cnt[C];
  const int j0 = blockIdx.x * C;
  const int kc = k - j0 < C ? k - j0 : C;
  zero_counts(s_cnt, kc);
  uint32_t key[C];
#pragma unroll
  for (int j = 0; j < C; ++j) key[j] = j < kc ? __ldg(keys + j0 + j) : 0xFFFFFFFFu;
  uint32_t* rows = bits + (size_t)j0 * nblocks;
  for (long long tile = blockIdx.y; tile < ntiles; tile += gridDim.y) {
    const long long b = tile * blockDim.x + threadIdx.x;
    const bool active = b < nblocks;
    uint32_t v[kBlockValues];
    unpack_block_any(width, tiles, nblocks, b, active, v);
    const uint32_t valid = active ? valid_word(block_offset + b, n) : 0u;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (j < kc) {
        uint32_t acc = 0u;
#pragma unroll
        for (int r = 0; r < kBlockValues; ++r) acc |= (uint32_t)(v[r] == key[j]) << r;
        store_row(rows, nblocks, b, active, j, acc & valid, s_cnt);
      }
    }
  }
  flush_counts(s_cnt, kc, counts + j0);
}

// The dynamic compare: the values of a tile unpacked once into shared
// memory, 32 words a thread laid out [slot][thread], read back for every
// key of a runtime loop; the launch's keys staged in shared memory; CTAs
// resident, walking the tiles.
__global__ void __launch_bounds__(kThreads)
dynamic_compare_kernel(const uint32_t* __restrict__ tiles, const uint32_t* __restrict__ keys,
                       int k, uint32_t* __restrict__ bits, unsigned long long* __restrict__ counts,
                       long long nblocks, int width, long long n, long long block_offset,
                       long long ntiles) {
  __shared__ uint32_t s_val[kBlockValues * kThreads];
  __shared__ uint32_t s_key[kMaxKeys];
  __shared__ unsigned s_cnt[kMaxKeys];
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    s_key[j] = __ldg(keys + j);
    s_cnt[j] = 0u;
  }
  __syncthreads();
  // volatile: every key reads the values from shared memory again
  volatile uint32_t* mine = s_val + threadIdx.x;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long b = tile * blockDim.x + threadIdx.x;
    const bool active = b < nblocks;
    uint32_t v[kBlockValues];
    unpack_block_any(width, tiles, nblocks, b, active, v);
#pragma unroll
    for (int r = 0; r < kBlockValues; ++r) mine[r * kThreads] = v[r];
    const uint32_t valid = active ? valid_word(block_offset + b, n) : 0u;
    for (int j = 0; j < k; ++j) {
      const uint32_t key = s_key[j];
      uint32_t acc = 0u;
#pragma unroll
      for (int r = 0; r < kBlockValues; ++r) acc |= (uint32_t)(mine[r * kThreads] == key) << r;
      store_row(bits, nblocks, b, active, j, acc & valid, s_cnt);
    }
  }
  flush_counts(s_cnt, k, counts);
}

cudaError_t dynamic_compare_launch(const uint32_t* tiles, const uint32_t* keys, int k,
                                   uint32_t* bits, unsigned long long* counts, long long nblocks,
                                   int width, long long n, long long block_offset,
                                   cudaStream_t stream) {
  if (!width_ok(width)) return cudaErrorInvalidValue;
  if (nblocks <= 0 || k <= 0) return cudaSuccess;
  const long long ntiles = (nblocks + kThreads - 1) / kThreads;
  unsigned grid = 0;
  cudaError_t err = resident_grid(dynamic_compare_kernel, kThreads, 0, ntiles, &grid);
  if (err != cudaSuccess) return err;
  for (int j0 = 0; j0 < k; j0 += kMaxKeys) {
    const int kc = k - j0 < kMaxKeys ? k - j0 : kMaxKeys;
    dynamic_compare_kernel<<<grid, kThreads, 0, stream>>>(
        tiles, keys + j0, kc, bits + (size_t)j0 * nblocks, counts + j0, nblocks, width, n,
        block_offset, ntiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace sss

// Copy variant: 0 the per-thread batch; 1-2 the pipelined grid-stride loop
// with 4 or 8 vectors a thread and step; 3-5 the ring on the resident grid
// (stage KB x stages: 16x4, 32x4, 64x3); 6-11 the ring with a CTA for every
// run of consecutive chunks (stage KB x stages, run: 32x4 2, 32x4 4 -- the
// library's --, 32x4 8, 16x4 4, 16x4 16, 16x4 32).
extern "C" int sweep_copy(int variant, const void* src, void* dst, long long nbytes,
                          cudaStream_t stream) {
  using namespace sss;
  switch (variant) {
    case 0: {
      const long long nvec = nbytes / 16, per_cta = (long long)kThreads * kBatch;
      const long long grid = nvec > 0 ? (nvec + per_cta - 1) / per_cta : 1;
      copy_batch_kernel<<<(unsigned)grid, kThreads, 0, stream>>>(
          static_cast<const uint4*>(src), static_cast<uint4*>(dst), nvec,
          static_cast<const uint8_t*>(src) + nvec * 16, static_cast<uint8_t*>(dst) + nvec * 16,
          (int)(nbytes % 16));
      return (int)cudaGetLastError();
    }
    case 1: return (int)copy_pipelined_launch<4>(src, dst, nbytes, stream);
    case 2: return (int)copy_pipelined_launch<8>(src, dst, nbytes, stream);
    case 3: return (int)copy_ring_launch<16 * 1024, 4, 0>(src, dst, nbytes, stream);
    case 4: return (int)copy_ring_launch<32 * 1024, 4, 0>(src, dst, nbytes, stream);
    case 5: return (int)copy_ring_launch<64 * 1024, 3, 0>(src, dst, nbytes, stream);
    case 6: return (int)copy_ring_launch<32 * 1024, 4, 2>(src, dst, nbytes, stream);
    case 7: return (int)copy_ring_launch<32 * 1024, 4, 4>(src, dst, nbytes, stream);
    case 8: return (int)copy_ring_launch<32 * 1024, 4, 8>(src, dst, nbytes, stream);
    case 9: return (int)copy_ring_launch<16 * 1024, 4, 4>(src, dst, nbytes, stream);
    case 10: return (int)copy_ring_launch<16 * 1024, 4, 16>(src, dst, nbytes, stream);
    case 11: return (int)copy_ring_launch<16 * 1024, 4, 32>(src, dst, nbytes, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// Chunked variant: 0 the register compare (16 keys a CTA); 1-6 the key
// lookup at (C, threads) = (32, 128), (32, 256), (64, 128), (64, 256),
// (128, 128), (128, 256); 7 the key lookup with a shared atomic per row and
// warp, each update right after its lookup; 8 with rep and counts in
// registers; 9-11 the library's kernel without its lookups, its counts or
// its stores (timing only); all of 7-11 at (64, 256).
extern "C" int sweep_chunked(int variant, const uint32_t* tiles, const uint32_t* keys, int k,
                             uint32_t* bits, unsigned long long* counts, long long nblocks,
                             int width, long long n, long long block_offset,
                             cudaStream_t stream) {
  using namespace sss;
  switch (variant) {
    case 0: {
      if (!width_ok(width)) return (int)cudaErrorInvalidValue;
      const long long ntiles = (nblocks + kThreads - 1) / kThreads;
      const dim3 grid((unsigned)((k + kCompareKeys - 1) / kCompareKeys),
                      (unsigned)(ntiles < 65535 ? ntiles : 65535));
      chunked_compare_kernel<<<grid, kThreads, 0, stream>>>(tiles, keys, k, bits, counts, nblocks,
                                                             width, n, block_offset, ntiles);
      return (int)cudaGetLastError();
    }
#define SWEEP_CASE(V, C, T)                                                                   \
  case V:                                                                                     \
    return (int)chunked_launch<C, T>(tiles, keys, k, bits, counts, nblocks, width, n,         \
                                     block_offset, stream);
    SWEEP_CASE(1, 32, 128)
    SWEEP_CASE(2, 32, 256)
    SWEEP_CASE(3, 64, 128)
    SWEEP_CASE(4, 64, 256)
    SWEEP_CASE(5, 128, 128)
    SWEEP_CASE(6, 128, 256)
#undef SWEEP_CASE
    case 7:
      return (int)chunked_launch_with<64, 256>(
          chunked_row_atomics_kernel<64, 256, true>, chunked_row_atomics_kernel<64, 256, false>,
          tiles, keys, k, bits, counts, nblocks, width, n, block_offset, stream);
    case 8:
      return (int)chunked_launch_with<64, 256>(
          chunked_register_counts_kernel<64, 256, true>,
          chunked_register_counts_kernel<64, 256, false>, tiles, keys, k, bits, counts, nblocks,
          width, n, block_offset, stream);
#define SWEEP_ABLATION(V, M)                                                              \
  case V:                                                                                 \
    return (int)chunked_launch_with<64, 256>(                                             \
        chunked_ablation_kernel<64, 256, true, M>, chunked_ablation_kernel<64, 256, false, M>, \
        tiles, keys, k, bits, counts, nblocks, width, n, block_offset, stream);
    SWEEP_ABLATION(9, 1)
    SWEEP_ABLATION(10, 2)
    SWEEP_ABLATION(11, 3)
#undef SWEEP_ABLATION
  }
  return (int)cudaErrorInvalidValue;
}

// Dynamic variant: 0 the dynamic compare; 1-4 the library's dynamic scan
// at (G, threads) = (32, 128), (32, 256), (64, 128), (64, 256); 5-6 the
// library's dynamic scan at its own (G, threads) without its lookups (each
// value marks the row of its own value) or without its row stores (timing
// only).
extern "C" int sweep_dynamic(int variant, const uint32_t* tiles, const uint32_t* keys, int k,
                             uint32_t* bits, unsigned long long* counts, long long nblocks,
                             int width, long long n, long long block_offset,
                             cudaStream_t stream) {
  using namespace sss;
  constexpr int G = kDynGroup, T = kDynThreads;
  switch (variant) {
    case 0:
      return (int)dynamic_compare_launch(tiles, keys, k, bits, counts, nblocks, width, n,
                                         block_offset, stream);
#define SWEEP_CASE(V, G_, T_)                                                              \
  case V:                                                                                  \
    return (int)dynamic_launch<G_, T_>(tiles, keys, k, bits, counts, nblocks, width, n,    \
                                       block_offset, stream);
    SWEEP_CASE(1, 32, 128)
    SWEEP_CASE(2, 32, 256)
    SWEEP_CASE(3, 64, 128)
    SWEEP_CASE(4, 64, 256)
#undef SWEEP_CASE
    case 5:
      return (int)dynamic_launch_with<G, T>(
          shared_scan_dynamic_kernel<G, T, true, false>,
          shared_scan_dynamic_kernel<G, T, false, false>, tiles, keys, k, bits, counts, nblocks,
          width, n, block_offset, stream);
    case 6:
      return (int)dynamic_launch_with<G, T>(
          shared_scan_dynamic_kernel<G, T, true, true, false>,
          shared_scan_dynamic_kernel<G, T, false, true, false>, tiles, keys, k, bits, counts,
          nblocks, width, n, block_offset, stream);
  }
  return (int)cudaErrorInvalidValue;
}

namespace sss {

template <typename Kernel>
int ctas_per_sm(Kernel direct, Kernel search, int width, int threads, size_t smem) {
  const Kernel kernel = width <= kDirectBits ? direct : search;
  int n = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem))
    return -1;
  return n;
}

}  // namespace sss

// CTAs an SM of dynamic variants 1-4 at this width (0: the library's
// chunked kernel), as the occupancy calculator gives them; -1 on an error.
extern "C" int sweep_dynamic_ctas(int variant, int width) {
  using namespace sss;
  switch (variant) {
    case 0:
      return ctas_per_sm(shared_scan_chunked_kernel<kChunkKeys, kChunkThreads, true>,
                         shared_scan_chunked_kernel<kChunkKeys, kChunkThreads, false>, width,
                         kChunkThreads, chunked_smem<kChunkKeys, kChunkThreads>(width));
#define SWEEP_CASE(V, G_, T_)                                                                  \
  case V:                                                                                      \
    return ctas_per_sm(shared_scan_dynamic_kernel<G_, T_, true>,                               \
                       shared_scan_dynamic_kernel<G_, T_, false>, width, T_,                   \
                       dynamic_smem<G_, T_>(width));
    SWEEP_CASE(1, 32, 128)
    SWEEP_CASE(2, 32, 256)
    SWEEP_CASE(3, 64, 128)
    SWEEP_CASE(4, 64, 256)
#undef SWEEP_CASE
  }
  return -1;
}

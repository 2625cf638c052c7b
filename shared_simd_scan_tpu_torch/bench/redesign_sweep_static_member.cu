// The static tier's and the member OR-tree body's designs side by side,
// for bench/redesign_sweep.py to time on the card.  Not part of the kernel
// library: it includes the library's bitsliced.cu and member.cu for their
// templates (the tile-order static fold at any CTA size and mask chunk;
// the set lookup with its search table in shared or device memory) and
// adds the design the library does not use, at the widths the sweep times
// (9, 20 and 31): the IN-list as a plane fold, the set's plane masks staged
// in shared memory as the static fold stages them, every key's row ORed
// into one.
#include "../csrc/bitsliced.cu"
#include "../csrc/member.cu"

namespace sss {

// --- the IN-list as a plane fold -------------------------------------------

template <int W>
__global__ void __launch_bounds__(kThreads)
member_fold_kernel(const uint32_t* __restrict__ tiles, const uint32_t* __restrict__ keys, int k,
                   uint32_t* __restrict__ bits, unsigned long long* __restrict__ counts,
                   long long nblocks, long long n, long long block_offset) {
  extern __shared__ uint4 s_mask[];  // [(k + 3) / 4][W + 1]
  __shared__ unsigned s_cnt[1];
  const int nq = (k + 3) / 4;
  stage_fold_masks<W>(s_mask, DeviceKeys{keys}, 0, k, nq);
  zero_counts(s_cnt, 1);  // (its barrier also publishes the masks)
  const long long ntiles = (nblocks + blockDim.x - 1) / blockDim.x;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long b = t * blockDim.x + threadIdx.x;
    const bool active = b < nblocks;
    uint32_t w[W];
    load_block<W>(tiles, nblocks, b, active, w);
    const uint32_t valid = active ? valid_word(block_offset + b, n) : 0u;
    uint32_t x[kBlockValues];
    unpack_values<W>(w, x);
    transpose_bitplanes<W>(x);
    uint32_t any = 0u;
#pragma unroll 1
    for (int q = 0; q < nq; ++q) {
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
      any |= (r0 | r1) | (r2 | r3);
    }
    store_row(bits, nblocks, b, active, 0, any & valid, s_cnt);
  }
  flush_counts(s_cnt, 1, counts);
}

template <int W>
cudaError_t launch_member_fold(const uint32_t* tiles, const uint32_t* keys, int k, int threads,
                               uint32_t* bits, unsigned long long* counts, long long nblocks,
                               long long n, cudaStream_t stream) {
  const auto kernel = member_fold_kernel<W>;
  const size_t smem = (size_t)((k + 3) / 4) * (W + 1) * sizeof(uint4);
  unsigned grid = 0;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = resident_grid(kernel, threads, smem, (nblocks + threads - 1) / threads, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(tiles, keys, k, bits, counts, nblocks, n, 0);
  return cudaGetLastError();
}

// (threads, mask bytes) of the static fold's variants 1..10
constexpr int kFoldThreads[] = {0, 128, 256, 128, 128, 128, 128, 256, 256, 256, 256};
constexpr int kFoldMaskKB[] = {0, 48, 48, 16, 32, 64, 128, 16, 32, 64, 128};

template <int W>
int sweep_static_w(int variant, const uint32_t* tiles, const uint32_t* keys, int k,
                   uint32_t* bits, unsigned long long* counts, long long nblocks, long long n,
                   cudaStream_t stream) {
  if (variant < 1 || variant > 10) return (int)cudaErrorInvalidValue;
  const int fit = kFoldMaskKB[variant] * 1024 / (16 * (W + 1)) * 4;
  const int all = (k + 3) / 4 * 4;
  return (int)launch_static_fold<W, DeviceKeys, kFoldRows>(
      tiles, DeviceKeys{keys}, k, all < fit ? all : fit, bits, counts, nblocks, n, 0,
      kFoldThreads[variant], stream);
}

template <int W>
int sweep_member_w(int variant, const uint32_t* tiles, const uint32_t* keys, int k,
                   const uint32_t* table, int size, uint32_t* bits, unsigned long long* counts,
                   long long nblocks, long long n, cudaStream_t stream) {
  switch (variant) {
    case 1:
    case 2:
      return (int)launch_member_fold<W>(tiles, keys, k, variant == 1 ? 128 : 256, bits, counts,
                                        nblocks, n, stream);
    case 3:
      if constexpr (W > 16)
        return (int)launch_member_lookup<W, kLookupGlobal>(table, size, tiles, bits, counts,
                                                           nblocks, n, 0, stream);
      return (int)cudaErrorInvalidValue;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace sss

// Variants of the static tier at width 9, 20 or 31 (keys a device array
// of k uint32): 1-10 the tile-order fold at (threads, mask bytes) = (128,
// 48 KB: the package's), (256, 48 KB), (128, 16 / 32 / 64 / 128 KB), (256,
// 16 / 32 / 64 / 128 KB).
extern "C" int sweep_static(int variant, int width, const uint32_t* tiles, const uint32_t* keys,
                            int k, uint32_t* bits, unsigned long long* counts, long long nblocks,
                            long long n, cudaStream_t stream) {
  switch (width) {
    case 9:
      return sss::sweep_static_w<9>(variant, tiles, keys, k, bits, counts, nblocks, n, stream);
    case 20:
      return sss::sweep_static_w<20>(variant, tiles, keys, k, bits, counts, nblocks, n, stream);
    case 31:
      return sss::sweep_static_w<31>(variant, tiles, keys, k, bits, counts, nblocks, n, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Variants of the member OR-tree body at width 9, 20 or 31 (keys the
// set's k in-domain keys on the card; table, size its lookup table): 1, 2
// the plane fold at 128 and 256 threads a CTA; 3 the lookup with its
// search table read from device memory (widths 20, 31).
extern "C" int sweep_member(int variant, int width, const uint32_t* tiles, const uint32_t* keys,
                            int k, const uint32_t* table, int size, uint32_t* bits,
                            unsigned long long* counts, long long nblocks, long long n,
                            cudaStream_t stream) {
  switch (width) {
    case 9:
      return sss::sweep_member_w<9>(variant, tiles, keys, k, table, size, bits, counts, nblocks,
                                    n, stream);
    case 20:
      return sss::sweep_member_w<20>(variant, tiles, keys, k, table, size, bits, counts, nblocks,
                                     n, stream);
    case 31:
      return sss::sweep_member_w<31>(variant, tiles, keys, k, table, size, bits, counts, nblocks,
                                     n, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

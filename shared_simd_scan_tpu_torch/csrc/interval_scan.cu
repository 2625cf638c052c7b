// Interval shared scan (keys lo..lo+k-1, k <= 1024) and the shift canary.
//
// Replaces shared_simd_scan_tpu/ops/scan.py: _interval_scan_kernel /
// _interval_scan_tiles_impl and _shift_canary_kernel / _run_shift_canary,
// with the reference algorithm:
//  - one-hot mask m = 1 << (v - lo_c) per value for a 32-key chunk starting
//    at lo_c; the subtraction is uint32, so v < lo_c wraps to a large amount
//    and the mask is 0;
//  - for each 8-key round (byte of the mask), X_t packs the mask bytes of
//    values {t, t+8, t+16, t+24} into its four bytes, and a 12-SWAPMOVE 8x8
//    bit transpose turns X_0..X_7 into the 8 keys' bitvector words;
//  - a last round with fewer than 8 keys writes only its first rows.
//
// The one-hot needs 1 << d == 0 for every d >= 32.  PTX shl.b32 clamps the
// amount (PTX ISA), C++ << leaves it undefined; the canary kernel measures
// both on the card, and the scan takes the gateless PTX shift only when the
// canary saw it saturate, else the gated d < 32 ? 1 << (d & 31) : 0.
//
// Bound on the H100: device memory bytes (reads W words, writes k words per
// 32 values) at small k; integer issue (~0.7 ops per value per key plus the
// unpack) at large k.  Design: one thread per 32-value block; the 32 values
// stay in registers for every key chunk (the TPU kernel's VMEM scratch);
// counts as in shared_scan.cu.
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

// Byte `byte` of mask m, placed at byte position g.
template <int kByte, int kG>
__device__ __forceinline__ uint32_t mask_byte(uint32_t m) {
  constexpr int sh = 8 * (kByte - kG);
  if constexpr (sh > 0) m >>= sh;
  if constexpr (sh < 0) m <<= -sh;
  if constexpr (sh == 24 || sh == -24) return m;  // the shift itself isolated the byte
  else return m & (0xFFu << (8 * kG));
}

// One 8-key round: rows for keys lo_c + 8*kByte + i, i < min(8, kc - 8*kByte),
// handed to the sink as rows j0 + 8*kByte + i.
template <int kByte, typename Sink>
__device__ __forceinline__ void interval_round(const uint32_t (&m)[kBlockValues], int j0, int kc,
                                               uint32_t valid, const Sink& sink) {
  uint32_t x[8];
#pragma unroll
  for (int t = 0; t < 8; ++t)
    x[t] = mask_byte<kByte, 0>(m[t]) | mask_byte<kByte, 1>(m[8 + t]) |
           mask_byte<kByte, 2>(m[16 + t]) | mask_byte<kByte, 3>(m[24 + t]);
  transpose8x8_bytes(x);
  sink.rows8(j0 + 8 * kByte, x, valid, kc - 8 * kByte);
}

// The k rows of one block from its 32 values, in 32-key chunks.
template <bool kGateless, typename Sink>
__device__ __forceinline__ void interval_block(const uint32_t (&v)[kBlockValues], uint32_t lo,
                                               int k, uint32_t valid, const Sink& sink) {
  for (int j0 = 0; j0 < k; j0 += 32) {  // 32-key chunks
    const uint32_t lo_c = lo + (uint32_t)j0;
    const int kc = k - j0 < 32 ? k - j0 : 32;
    uint32_t m[kBlockValues];
#pragma unroll
    for (int r = 0; r < kBlockValues; ++r) m[r] = onehot<kGateless>(v[r] - lo_c);
    interval_round<0>(m, j0, kc, valid, sink);
    if (kc > 8) interval_round<1>(m, j0, kc, valid, sink);
    if (kc > 16) interval_round<2>(m, j0, kc, valid, sink);
    if (kc > 24) interval_round<3>(m, j0, kc, valid, sink);
  }
}

template <int W, bool kGateless>
__global__ void __launch_bounds__(kThreads)
interval_scan_kernel(const uint32_t* __restrict__ tiles, uint32_t lo, int k,
                     uint32_t* __restrict__ bits, unsigned long long* __restrict__ counts,
                     long long nblocks, long long n, long long block_offset) {
  __shared__ unsigned s_cnt[kMaxKeys];
  zero_counts(s_cnt, k);
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = b < nblocks;
  uint32_t w[W];
  load_block<W>(tiles, nblocks, b, active, w);
  const uint32_t valid = active ? valid_word(block_offset + b, n) : 0u;

  uint32_t v[kBlockValues];
  unpack_values<W>(w, v);
  interval_block<kGateless>(v, lo, k, valid, BitsSink{bits, nblocks, b, active, s_cnt});
  flush_counts(s_cnt, k, counts);
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

}  // namespace sss

extern "C" int sss_interval_scan(const uint32_t* tiles, uint32_t lo, int k, uint32_t* bits,
                                 unsigned long long* counts, long long nblocks, int width,
                                 long long n, long long block_offset, int gateless,
                                 cudaStream_t stream) {
  if (k < 1 || k > sss::kMaxKeys) return (int)cudaErrorInvalidValue;
  if (nblocks <= 0) return (int)cudaSuccess;
  const unsigned grid = sss::grid_for(nblocks);
  switch (width) {
#define SSS_CASE(W)                                                                      \
  case W:                                                                                \
    if (gateless)                                                                        \
      sss::interval_scan_kernel<W, true><<<grid, sss::kThreads, 0, stream>>>(            \
          tiles, lo, k, bits, counts, nblocks, n, block_offset);                         \
    else                                                                                 \
      sss::interval_scan_kernel<W, false><<<grid, sss::kThreads, 0, stream>>>(           \
          tiles, lo, k, bits, counts, nblocks, n, block_offset);                         \
    break;
    SSS_FOR_EACH_WIDTH(SSS_CASE)
#undef SSS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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

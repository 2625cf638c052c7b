// Windowed shared scan: host keys through 32-aligned mask windows.
//
// Replaces shared_simd_scan_tpu/ops/scan.py: _windowed_scan_kernel /
// _windowed_scan_tiles_impl (k <= 48, one window plan) and
// _windowed_chunked_kernel / _windowed_chunked_tiles_impl (k > 48, 32-row
// chunks that each re-mask their own windows).  Both plans are data here:
// the host (ops/scan.py _window_stream) writes the int32 stream
//     nwin, then per window: base, nsub,
//     then per sub-window: byte, nent, then per entry: bit, row
// and one kernel walks it.  Per window the one-hot m_r = 1 << (v_r - base)
// holds the matches of all 32 keys base..base+31; per populated 8-key
// sub-window X_t packs byte `byte` of the masks of values {t, t+8, t+16,
// t+24} (three __byte_perm), the 12-SWAPMOVE 8x8 transpose turns X into
// the 8 keys' words, and each entry stores word `bit` as its caller-order
// row, so duplicate keys each get their row.  Keys >= 2^W have windows no
// value reaches and come out zero.  The one-hot goes through PTX shl.b32
// when the shift canary saw it saturate, gated otherwise (as interval_scan.cu).
//
// Bound on the H100: device memory bytes (reads W words, writes k words per
// 32 values) for clustered keys; the integer instruction rate (32 one-hots per window,
// ~100 ops per sub-window) when the keys spread over many windows.  Design:
// one thread per 32-value block; the 32 values and the window's 32 one-hots
// stay in registers; the plan is read warp-uniformly through the read-only
// cache, so the loops over windows, sub-windows and entries do not diverge.
// Counts as in shared_scan.cu.
#include "common.cuh"

namespace sss {

template <int W, bool kGateless>
__global__ void __launch_bounds__(kThreads)
windowed_scan_kernel(const uint32_t* __restrict__ tiles, const int* __restrict__ plan, int k,
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

  int p = 0;
  const int nwin = __ldg(plan + p++);
  for (int win = 0; win < nwin; ++win) {
    const uint32_t base = (uint32_t)__ldg(plan + p++);
    const int nsub = __ldg(plan + p++);
    uint32_t m[kBlockValues];
#pragma unroll
    for (int r = 0; r < kBlockValues; ++r) m[r] = onehot<kGateless>(v[r] - base);
    for (int sub = 0; sub < nsub; ++sub) {
      const uint32_t byte = (uint32_t)__ldg(plan + p++);
      const int nent = __ldg(plan + p++);
      // byte `byte` of the first operand to byte 0, of the second to byte 1
      const uint32_t sel = byte | ((byte + 4u) << 4);
      uint32_t x[8];
#pragma unroll
      for (int t = 0; t < 8; ++t)
        x[t] = __byte_perm(__byte_perm(m[t], m[8 + t], sel),
                           __byte_perm(m[16 + t], m[24 + t], sel), 0x5410);
      transpose8x8_bytes(x);
      for (int e = 0; e < nent; ++e) {
        const int bit = __ldg(plan + p++);
        const int row = __ldg(plan + p++);
        uint32_t y = 0u;
#pragma unroll
        for (int u = 0; u < 8; ++u) y = u == bit ? x[u] : y;
        store_row(bits, nblocks, b, active, row, y & valid, s_cnt);
      }
    }
  }
  flush_counts(s_cnt, k, counts);
}

}  // namespace sss

// One launch walks one plan of k <= kMaxKeys rows.
extern "C" int sss_windowed_scan(const uint32_t* tiles, const int* plan, int k, uint32_t* bits,
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
      sss::windowed_scan_kernel<W, true><<<grid, sss::kThreads, 0, stream>>>(            \
          tiles, plan, k, bits, counts, nblocks, n, block_offset);                       \
    else                                                                                 \
      sss::windowed_scan_kernel<W, false><<<grid, sss::kThreads, 0, stream>>>(           \
          tiles, plan, k, bits, counts, nblocks, n, block_offset);                       \
    break;
    SSS_FOR_EACH_WIDTH(SSS_CASE)
#undef SSS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

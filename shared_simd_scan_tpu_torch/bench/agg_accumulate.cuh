// The accumulate stage of the runtime-key bit-plane aggregate that the
// library ran before its redesign (csrc/agg_bitplane.cu, now the key
// lookup of csrc/agg_lookup.cu sss_agg_device_lookup): per key the count
// and the sum parts lo = sum_{p<16} popc(match & plane_p) << p and hi =
// sum_{p>=16} popc(match & plane_p) << (p-16), each < 32 * 2^16 = 2^21,
// reduced exactly by add_split_sum (common.cuh).  The match words lie in
// shared memory laid out [key][thread].  Only the sweeps' "before"
// kernels read it (bench/redesign_sweep_hist_agg.cu's DAG interpreter).
#pragma once

#include "../csrc/common.cuh"

namespace sss {

template <int WM>
__device__ __forceinline__ void accumulate(const uint32_t* __restrict__ mtiles, long long nblocks,
                                           long long b, bool active, const uint32_t* s_mw,
                                           int stride, int k, unsigned* s_cnt, unsigned* s_lo,
                                           unsigned* s_hi) {
  uint32_t w[WM];
  load_block<WM>(mtiles, nblocks, b, active, w);
  uint32_t x[kBlockValues];
  unpack_values<WM>(w, x);
  transpose_bitplanes<WM>(x);
#pragma unroll 1
  for (int j = 0; j < k; ++j) {
    const uint32_t mw = s_mw[j * stride + threadIdx.x];
    count_row(j, mw, s_cnt);
    unsigned lo = 0u, hi = 0u;
#pragma unroll
    for (int p = 0; p < WM; ++p) {
      const unsigned pc = (unsigned)__popc(mw & x[p]);
      if (p < 16) lo += pc << p;
      else hi += pc << (p - 16);
    }
    add_split_sum(s_lo, s_hi, j, lo, hi);
  }
}

__device__ void accumulate_any(int wm, const uint32_t* __restrict__ mtiles, long long nblocks,
                               long long b, bool active, const uint32_t* s_mw, int stride, int k,
                               unsigned* s_cnt, unsigned* s_lo, unsigned* s_hi) {
  switch (wm) {
#define SSS_CASE(W)                                                                         \
  case W:                                                                                   \
    accumulate<W>(mtiles, nblocks, b, active, s_mw, stride, k, s_cnt, s_lo, s_hi);          \
    return;
    SSS_FOR_EACH_WIDTH(SSS_CASE)
#undef SSS_CASE
  }
}

}  // namespace sss

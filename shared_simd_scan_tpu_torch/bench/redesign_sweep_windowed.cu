// The windowed tier's window lookup with its rows by key index, for
// bench/redesign_sweep.py to time beside the library's
// (sss_windowed_lookup, rows by the first caller row holding each key).
// Not part of the kernel library: it includes the library's shared_scan.cu
// for its templates and adds the form the library does not use.
//
// This form numbers the launch's nd distinct keys below 2^W in key order:
// a direct table of the 2^(W-5) windows holds each window's (mask, first)
// itself, one 8-byte shared load a value, and a value's key index is first
// + popc(mask << (31 - o)) - 1, with no list of rows; the rows are stored a
// group of kDynGroup key indices at a time, each caller row j from row
// pos[j] of the group (its address j * nblocks computed a row), and a few
// rows are cleared by row, not by value.  Its tables (windows [nwin], masks
// [nwin], first [nwin], pos [kc], order [kc], gstart [groups + 1]) come
// from bench/redesign_sweep.py _key_index_tables.
#include "../csrc/shared_scan.cu"

namespace sss {

// Byte offsets of a windowed CTA's dynamic shared memory: rows [zr + 1][T]
// (zr = min(nd, G) rows, then a zero row); the direct table [2^(W-5)] of
// (mask, first), or the search's sorted windows [span] and their (mask,
// first) [nwin + 1]; cnt [kc] and gstart [groups + 1] (32-bit words); then
// pos [kc] and order [kc] (uint16).
struct KeyIndexLayout {
  int zr, span, ngroups;
  size_t table, win, cnt, gstart, pos, order, bytes;
  __host__ __device__ KeyIndexLayout(int width, int kc, int nwin, int nd) {
    zr = nd < kDynGroup ? nd : kDynGroup;
    span = 1;
    while (span < nwin) span <<= 1;
    ngroups = nd > kDynGroup ? (nd + kDynGroup - 1) / kDynGroup : 1;
    size_t at = (size_t)(zr + 1) * kDynThreads * 4;
    table = at;  // the direct table, or the search's (mask, first)
    at += (width <= kWinDirectBits ? (size_t)win_table_size(width) : (size_t)nwin + 1) * 8;
    win = at;
    at += width <= kWinDirectBits ? 0 : (size_t)span * 4;
    cnt = at;
    at += (size_t)kc * 4;
    gstart = at;
    at += (size_t)(ngroups + 1) * 4;
    pos = at;
    at += (size_t)kc * 2;
    order = at;
    at += (size_t)kc * 2;
    bytes = (at + 15) / 16 * 16;
  }
};

// The key index of each of the 32 values (kNoRow: none), eight values at a
// time: their (mask, first) from the direct table, or from the search of
// the sorted windows (each step for the eight at once; a window not found
// takes slot nwin, the mask 0).
template <bool kDirect>
__device__ __forceinline__ void key_index_lookup(const uint2* wm, const uint32_t* win,
                                                 uint32_t nwin, int span,
                                                 uint32_t (&v)[kBlockValues]) {
#pragma unroll
  for (int q = 0; q < kBlockValues; q += 8) {
    uint2 m[8];
    if (kDirect) {
#pragma unroll
      for (int r = 0; r < 8; ++r) m[r] = wm[v[q + r] >> 5];
    } else {
      uint32_t slot[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) slot[r] = 0u;
      for (int half = span >> 1; half > 0; half >>= 1) {
#pragma unroll
        for (int r = 0; r < 8; ++r)
          if (win[slot[r] + half - 1] < (v[q + r] >> 5)) slot[r] += half;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
        m[r] = wm[win[slot[r]] == (v[q + r] >> 5) ? slot[r] : nwin];
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const uint32_t x = m[r].x << (31u - (v[q + r] & 31u));
      v[q + r] = (int)x < 0 ? m[r].y + __popc(x) - 1u : kNoRow;
    }
  }
}

// The plan (int32, device memory): windows [nwin], masks [nwin], first
// [nwin], pos [kc], order [kc], gstart [groups + 1].  At most 80 registers
// a thread (3 CTAs an SM), as the dynamic scan.
template <bool kDirect>
__global__ void __launch_bounds__(kDynThreads, 768 / kDynThreads)
window_key_index_kernel(const uint32_t* __restrict__ tiles, const int* __restrict__ plan, int kc,
                        int nwin, int nd, uint32_t* __restrict__ bits,
                        unsigned long long* __restrict__ counts, long long nblocks, int width,
                        long long n, long long block_offset, long long ntiles) {
  constexpr int G = kDynGroup, T = kDynThreads;
  extern __shared__ __align__(16) uint8_t s_kplan[];
  const KeyIndexLayout L(width, kc, nwin, nd);
  uint32_t* rows = reinterpret_cast<uint32_t*>(s_kplan);
  uint2* wm = reinterpret_cast<uint2*>(s_kplan + L.table);
  uint32_t* win = reinterpret_cast<uint32_t*>(s_kplan + L.win);
  unsigned* cnt = reinterpret_cast<unsigned*>(s_kplan + L.cnt);
  int* gstart = reinterpret_cast<int*>(s_kplan + L.gstart);
  uint16_t* pos = reinterpret_cast<uint16_t*>(s_kplan + L.pos);
  uint16_t* order = reinterpret_cast<uint16_t*>(s_kplan + L.order);
  const int* p_win = plan;
  const int* p_mask = p_win + nwin;
  const int* p_first = p_mask + nwin;
  const int* p_pos = p_first + nwin;
  const int* p_order = p_pos + kc;
  const int* p_gstart = p_order + kc;
  const int nslots = kDirect ? (int)win_table_size(width) : nwin + 1;
  for (int i = threadIdx.x; i < nslots; i += T) {
    const bool listed = !kDirect && i < nwin;  // the direct table is filled below
    wm[i] = listed ? make_uint2((uint32_t)__ldg(p_mask + i), (uint32_t)__ldg(p_first + i))
                   : make_uint2(0u, 0u);
  }
  if (!kDirect)
    for (int i = threadIdx.x; i < L.span; i += T)
      win[i] = i < nwin ? (uint32_t)__ldg(p_win + i) : 0xFFFFFFFFu;  // pads the search
  for (int j = threadIdx.x; j < kc; j += T) {
    cnt[j] = 0u;
    pos[j] = (uint16_t)__ldg(p_pos + j);
    order[j] = (uint16_t)__ldg(p_order + j);
  }
  for (int i = threadIdx.x; i <= L.ngroups; i += T) gstart[i] = __ldg(p_gstart + i);
  for (int i = threadIdx.x; i < (L.zr + 1) * T; i += T) rows[i] = 0u;
  __syncthreads();
  if (kDirect) {
    for (int i = threadIdx.x; i < nwin; i += T)
      wm[__ldg(p_win + i)] =
          make_uint2((uint32_t)__ldg(p_mask + i), (uint32_t)__ldg(p_first + i));
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const uint32_t zr = (uint32_t)L.zr;
  uint32_t* col = rows + threadIdx.x;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long b = tile * T + threadIdx.x;
    const bool active = b < nblocks;
    uint32_t v[kBlockValues];
    unpack_block_any(width, tiles, nblocks, b, active, v);
    key_index_lookup<kDirect>(wm, win, (uint32_t)nwin, L.span, v);
    const uint32_t valid = active ? valid_word(block_offset + b, n) : 0u;
    for (int g = 0; g < L.ngroups; ++g) {
      const uint32_t g0 = (uint32_t)(g * G);
      mark_rows<T, G>(col, v, g0);
      // the group's rows, 32 at a time: lane l keeps the warp's count of
      // row order[i + l], one atomic a lane (as store_rows)
      for (int i0 = gstart[g]; i0 < gstart[g + 1]; i0 += 32) {
        unsigned mine = 0u;
        int jl = 0;
#pragma unroll
        for (int l = 0; l < 32; ++l) {
          if (i0 + l < gstart[g + 1]) {  // uniform across the CTA
            const int j = order[i0 + l];
            const uint32_t slot = pos[j] - g0;
            const uint32_t word = col[(slot < zr ? slot : zr) * T] & valid;
            if (active) bits[(size_t)j * nblocks + b] = word;
            const unsigned c = __reduce_add_sync(0xFFFFFFFFu, (unsigned)__popc(word));
            if (lane == l) {
              mine = c;
              jl = j;
            }
          }
        }
        if (mine) atomicAdd(cnt + jl, mine);
      }
      if (zr <= 32) {
        for (uint32_t i = 0; i < zr; ++i) col[i * T] = 0u;
      } else {
        mark_rows<T, G, true>(col, v, g0);
      }
    }
  }
  flush_counts(cnt, kc, counts);
}

}  // namespace sss

// One launch of the key-index form on k <= kMaxKeys rows (bits, counts as
// sss_windowed_lookup's).
extern "C" int sweep_window_key_index(const uint32_t* tiles, const int* plan, int k, int nwin,
                                      int nd, uint32_t* bits, unsigned long long* counts,
                                      long long nblocks, int width, long long n,
                                      cudaStream_t stream) {
  if (k < 1 || k > sss::kMaxKeys || !sss::width_ok(width) || nd < nwin || nd > k)
    return (int)cudaErrorInvalidValue;
  constexpr int T = sss::kDynThreads;
  const long long ntiles = (nblocks + T - 1) / T;
  const sss::KeyIndexLayout layout(width, k, nwin, nd);
  const auto kernel = width <= sss::kWinDirectBits ? sss::window_key_index_kernel<true>
                                                   : sss::window_key_index_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)layout.bytes);
  unsigned grid = 0;
  if (err == cudaSuccess) err = sss::resident_grid(kernel, T, layout.bytes, ntiles, &grid);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, T, layout.bytes, stream>>>(tiles, plan, k, nwin, nd, bits, counts, nblocks, width,
                                            n, 0, ntiles);
  return (int)cudaGetLastError();
}

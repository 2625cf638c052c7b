// Conjunctive multi-column scan: AND of one half-open range per column.
//
// Replaces shared_simd_scan_tpu/ops/conj.py: _conj_range_kernel /
// conj_range_scan_tiles, with its semantics: m <= 8 columns of the same n
// (so the same block layout), one range [lo_c, hi_c) each, matched as
// (v - lo_c) mod 2^32 < span_c with span_c = hi_c > lo_c ? hi_c - lo_c : 0
// (inverted bounds are an empty range here, not a wrapped one), ANDed over
// the columns into one bitvector row and one count.
//
// Bound on the H100: device memory bytes (reads sum(W_c) words, writes one
// word per 32 values), and close behind it the integer pipe: every value of
// every column is compared, 32 m compares a block.  Design: one fused pass,
// one thread per 32-value block, on a staged multi-column tile loop (the
// design of common.cuh staged_tiles): each column is a 2-D TMA tensor map
// with a box of [W_c rows, T blocks], and a stage of the ring in shared
// memory holds every column's box of one tile (sum(W_c) * T words) behind
// one mbarrier that waits for all their bytes.  Thread 0 issues a stage's m
// tensor copies, so kConjStages - 1 tiles are in flight while the CTA
// matches one; CTAs take runs of tiles in address order (staged_run, capped
// so that every SM gets a CTA where the span has the tiles) and flush their
// count once.  Each thread reads its block's words of each column from the
// stage (a warp's lanes on 32 banks; a switch on the column's width, uniform
// across the grid, picks a template <int W> matcher whose schedule is
// constant) and matches a value in three integer instructions: x, the value
// at the top of a word, above bits of the values before it (which cannot
// move a compare against bounds shifted up the same way); a = lo - 1 - x,
// one multiply-add with x's shift where the value lies in one word (a funnel
// shift and a subtract where it straddles two); and the carry of a + span,
// set iff x - lo < span, added into the match word as it doubles (add.cc,
// addc: IADD3 and IMAD.X), where a compare and a select took two.  Only the
// AND is stored, so no per-column row reaches device memory.
//
// Before it, a thread loaded its block's words straight from device
// memory, one column after the other with the width's switch between them,
// so at most one column's words were in flight; every CTA of 256 blocks
// zeroed and flushed its counter; and a value took a shift, a mask, a
// subtract, a compare and a select.  At flight 1's widths (12, 6, 4) and
// 600M rows it ran 0.776 ms against a 0.515 ms bound (66%), now 0.585 ms
// (88%); at m=2 (widths 9, 5) and m=3 (9, 5, 4) over 477M rows 0.438 and
// 0.576 ms against 0.267 and 0.338 ms, now 0.310 and 0.391 ms (NVIDIA
// H100 80GB HBM3, 700 W).
//
// A zone map's pruned span runs here too, as in range_scan.cu: the caller
// passes pointers to the span's first block of each column and of the bits,
// and the columns' row length `ld` as the tensor maps' row stride, so the
// kernel reads the span in place and writes into the column's full-length
// row (zeroed by the caller).
//
// The TMA refuses a column that does not start on 16 bytes (a view at an
// odd word) and a span of 2^31 blocks or more (coordinates are 32-bit
// signed): such a scan is refused, as the interval and shared scans refuse
// it.  Every column the port allocates starts on 512 bytes, and so does a
// span of it.
#include "common.cuh"

namespace sss {

constexpr int kMaxColumns = 8;
constexpr int kConjStages = 2;
// The ring a CTA aims at: the tile is the most blocks (256 or 128) whose
// kConjStages stages fit in it, so up to 56 words a block (flight 1's 22
// among them) a CTA takes 256 blocks a tile and an SM holds two CTAs or
// more, up to 112 words 128 blocks; past that 64 blocks, a ring of up to
// 124 KB (eight 31-bit columns, 248 words), one CTA an SM.
constexpr size_t kConjRingBytes = 112 * 1024;

// The columns' tensor maps, by value in the kernel's parameter space.
struct ConjMaps {
  CUtensorMap map[kMaxColumns];
};

struct ConjColumns {
  int width[kMaxColumns];
  int row[kMaxColumns];        // first row of the column's box in a stage
  uint32_t lo[kMaxColumns];    // lo_c << (32 - W_c): the bound at the values' place
  uint32_t span[kMaxColumns];  // (hi_c - lo_c) << (32 - W_c); 0 for an empty range
  unsigned full;               // bit c: column c's range holds every W_c-bit value
  int m, rows;                 // columns, and their words a block (a stage's rows)
};

// Value r (0..31) of the block at the top of a word: the block's stream
// bits [(r + 1) W - 32, (r + 1) W), the values before it below (zeros
// below the first word).
template <int W>
__device__ __forceinline__ uint32_t top_value(const uint32_t (&w)[W], int r) {
  const int end = (r + 1) * W;
  if (end <= 32) return w[0] << (32 - end);
  const int k = (end - 32) >> 5;
  // (the index guard only keeps a word-aligned top's dead operand in bounds)
  return __funnelshift_r(w[k], w[k + 1 < W ? k + 1 : k], (end - 32) & 31);
}

// acc * 2 + (d < span) for d = (x - lo) mod 2^32, given a = lo - 1 - x =
// ~d: the carry of a + span, since a + span >= 2^32 iff d < span.
__device__ __forceinline__ uint32_t shift_in_match(uint32_t acc, uint32_t a, uint32_t span) {
  asm("{\n\t.reg .u32 t;\n\t"
      "add.cc.u32 t, %1, %2;\n\t"
      "addc.u32 %0, %0, %0;\n\t}"
      : "+r"(acc)
      : "r"(a), "r"(span));
  return acc;
}

// Bit r set iff value r of the block (its W words in w) lies in the
// column's range.  With W-bit values v and bounds below 2^W, x = v 2^(32-W)
// + g (g < 2^(32-W), bits of the values before) lies in [lo, lo + span) iff
// v lies in the range.
template <int W>
__device__ __forceinline__ uint32_t match_bits(const uint32_t (&w)[W], uint32_t lo, uint32_t span) {
  const uint32_t lo_less = lo - 1u;
  uint32_t acc = 0u;
#pragma unroll
  for (int r = kBlockValues - 1; r >= 0; --r)
    acc = shift_in_match(acc, lo_less - top_value<W>(w, r), span);
  return acc;
}

// The same from the column's box in the stage, st at the thread's block.
template <int W, int T>
__device__ __forceinline__ uint32_t range_bits(const uint32_t* st, uint32_t lo, uint32_t span) {
  uint32_t w[W];
#pragma unroll
  for (int j = 0; j < W; ++j) w[j] = st[j * T];
  return match_bits<W>(w, lo, span);
}

template <int T>
__device__ __forceinline__ uint32_t column_bits(int width, const uint32_t* st, uint32_t lo,
                                                uint32_t span) {
  switch (width) {
#define SSS_CASE(W) \
  case W:           \
    return range_bits<W, T>(st, lo, span);
    SSS_FOR_EACH_WIDTH(SSS_CASE)
#undef SSS_CASE
  }
  return 0u;  // not reached: the entry point checks every width
}

template <int T>
__global__ void __launch_bounds__(T)
conj_range_kernel(const __grid_constant__ ConjMaps maps, const ConjColumns cols,
                  uint32_t* __restrict__ bits, unsigned long long* __restrict__ counts,
                  long long nblocks, long long n, long long block_offset, long long run) {
  extern __shared__ __align__(128) uint32_t s_ring[];
  __shared__ __align__(8) uint64_t s_full[kConjStages];
  __shared__ unsigned s_cnt[1];
  zero_counts(s_cnt, 1);
  const long long ntiles = (nblocks + T - 1) / T;
  const long long first = (long long)blockIdx.x * run;  // this CTA's tiles: first, ...
  const long long count = run < ntiles - first ? run : ntiles - first;
  const int stage_words = cols.rows * T;
  auto issue = [&](long long tile, int s) {
    uint32_t* stage = s_ring + s * stage_words;
    mbar_expect_tx(&s_full[s], stage_words * 4);  // every box whole, zeros past nblocks
    for (int c = 0; c < cols.m; ++c)
      tile_map_load(stage + cols.row[c] * T, &maps.map[c], tile * T, &s_full[s]);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kConjStages; ++s) mbar_init(&s_full[s], 1u);
    mbar_init_fence();
    for (int s = 0; s < kConjStages && s < count; ++s) issue(first + s, s);
  }
  __syncthreads();  // the barriers are initialized
#pragma unroll 1
  for (long long i = 0; i < count; ++i) {  // CTA-uniform trip count
    const int s = (int)(i % kConjStages);
    const long long b = (first + i) * T + threadIdx.x;
    const bool active = b < nblocks;
    mbar_wait(&s_full[s], (uint32_t)((i / kConjStages) & 1));
    const uint32_t* st = s_ring + s * stage_words + threadIdx.x;
    uint32_t acc = active ? valid_word(block_offset + b, n) : 0u;
    for (int c = 0; c < cols.m; ++c)
      if (!((cols.full >> c) & 1u))
        acc &= column_bits<T>(cols.width[c], st + cols.row[c] * T, cols.lo[c], cols.span[c]);
    __syncthreads();  // every thread has read the stage
    if (threadIdx.x == 0 && i + kConjStages < count) {
      // order the reads above before the async proxy's writes into the stage
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      issue(first + i + kConjStages, s);
    }
    store_row(bits, nblocks, b, active, 0, acc, s_cnt);
  }
  flush_counts(s_cnt, 1, counts);
}

// The tile of a ring of `rows` words a block.
inline int conj_tile(int rows) {
  for (int t = 256; t > 64; t /= 2)
    if (tile_ring_bytes(rows, t, kConjStages) <= kConjRingBytes) return t;
  return 64;
}

// The run of tiles a CTA takes over `nblocks` blocks: staged_run's, cut
// so that the grid has a CTA for each SM while the tiles last.
inline cudaError_t conj_run(int rows, int threads, long long nblocks, long long* run) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long per_sm = (nblocks + threads - 1) / threads / sms;
  const long long r = staged_run(rows, 1, threads);
  *run = r < per_sm ? r : per_sm > 1 ? per_sm : 1;
  return cudaSuccess;
}

// The staged scan of blocks 0..nblocks-1 of rows `ld` words long.
// tile_ptrs[c]: column c's first block scanned.
template <int T>
cudaError_t launch_conj(const ConjColumns& cols, const long long* tile_ptrs, uint32_t* bits,
                        unsigned long long* counts, long long nblocks, long long ld, long long n,
                        long long block_offset, cudaStream_t stream) {
  const auto kernel = conj_range_kernel<T>;
  const size_t smem = tile_ring_bytes(cols.rows, T, kConjStages);
  ConjMaps maps;
  cudaError_t err = cudaSuccess;
  for (int c = 0; c < cols.m && err == cudaSuccess; ++c)
    err = tile_map(&maps.map[c], reinterpret_cast<const uint32_t*>(tile_ptrs[c]), cols.width[c],
                   nblocks, T, ld);
  long long run = 0;
  if (err == cudaSuccess) err = conj_run(cols.rows, T, nblocks, &run);
  unsigned grid = 0;
  if (err == cudaSuccess) err = staged_grid(kernel, T, smem, nblocks, run, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, T, smem, stream>>>(maps, cols, bits, counts, nblocks, n, block_offset, run);
  return cudaGetLastError();
}

// The kernel's columns from the host arrays; false for a width out of 1..31.
inline bool conj_columns(const int* widths, const uint32_t* lows, const uint32_t* highs, int m,
                         ConjColumns* cols) {
  *cols = {};
  cols->m = m;
  for (int c = 0; c < m; ++c) {
    const int w = widths[c];
    if (!width_ok(w)) return false;
    cols->width[c] = w;
    cols->row[c] = cols->rows;
    cols->rows += w;
    // W-bit values: a bound past 2^W acts as 2^W
    const unsigned long long dom = 1ULL << w;
    const unsigned long long lo = lows[c] < dom ? lows[c] : dom;
    const unsigned long long hi = highs[c] < dom ? highs[c] : dom;
    if (lo == 0 && hi == dom) {
      cols->full |= 1u << c;
    } else if (hi > lo) {
      cols->lo[c] = (uint32_t)(lo << (32 - w));
      cols->span[c] = (uint32_t)((hi - lo) << (32 - w));
    }
  }
  return true;
}

}  // namespace sss

// tile_ptrs, widths, lows and highs are host arrays of m entries, copied
// into the kernel's by-value argument.  Scans blocks 0..nblocks-1 of rows of
// `ld` words (ld >= nblocks; ld = nblocks for whole columns); every tile
// pointer 16-byte aligned, ld a multiple of 4 and nblocks < 2^31, else the
// TMA's refusal is returned.
extern "C" int sss_conj_range_scan(const long long* tile_ptrs, const int* widths,
                                   const uint32_t* lows, const uint32_t* highs, int m,
                                   uint32_t* bits, unsigned long long* counts, long long nblocks,
                                   long long ld, long long n, long long block_offset,
                                   cudaStream_t stream) {
  sss::ConjColumns cols;
  if (m < 1 || m > sss::kMaxColumns || ld < nblocks ||
      !sss::conj_columns(widths, lows, highs, m, &cols))
    return (int)cudaErrorInvalidValue;
  if (nblocks <= 0) return (int)cudaSuccess;
  switch (sss::conj_tile(cols.rows)) {
    case 256:
      return (int)sss::launch_conj<256>(cols, tile_ptrs, bits, counts, nblocks, ld, n,
                                        block_offset, stream);
    case 128:
      return (int)sss::launch_conj<128>(cols, tile_ptrs, bits, counts, nblocks, ld, n,
                                        block_offset, stream);
    default:
      return (int)sss::launch_conj<64>(cols, tile_ptrs, bits, counts, nblocks, ld, n,
                                       block_offset, stream);
  }
}

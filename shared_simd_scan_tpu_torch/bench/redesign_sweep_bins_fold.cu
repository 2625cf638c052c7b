// The histogram's bins designs and the static linear export's fold designs
// side by side, for bench/redesign_sweep.py to time on the card.  Not part
// of the kernel library: it includes the library's histogram.cu and
// bitsliced.cu for their templates (the bins kernel with or without its
// bank swizzle and its spare counter; the domain histogram with
// 64- or 32-bit counters, with or without its merging; the linear fold on
// any kind of keys and at any CTA size) and adds the designs the
// library does not use, at the widths the sweep times (9 and 20):
//   - the bins kernel as it was before its redesign: every value unpacked
//     by a shift and an OR, its lo subtracted, its validity bit and its
//     window tested, then one shared atomic at its swizzled slot;
//   - the domain histogram as G windows of 4096 bins a CTA in shared
//     memory: the CTAs of a window group side by side in launch order, so
//     the groups read each tile at about the same time (once from device
//     memory, the rest from the L2);
//   - the static linear export as it was before its redesign: the
//     host-compiled AND-DAG program interpreted over node slots in shared
//     memory, each row staged a byte at a time beside the slots;
//   - the linear fold with its keys in constant memory.
#include "dag_program.cuh"
#include "../csrc/histogram.cu"
#include "../csrc/bitsliced.cu"

namespace sss {

// --- the bins kernel before its redesign ----------------------------------

template <int W>
__global__ void __launch_bounds__(kThreads)
bins_baseline_kernel(const uint32_t* __restrict__ tiles, const uint32_t* __restrict__ lo_ptr,
                     int k, unsigned long long* __restrict__ counts, long long nblocks,
                     long long n, long long block_offset) {
  __shared__ unsigned s_bin[kMaxHistKeys];
  const int slots = (k + 31) & ~31;
  zero_counts(s_bin, slots);
  const uint32_t lo = __ldg(lo_ptr);
  const long long ntiles = (nblocks + blockDim.x - 1) / blockDim.x;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long b = t * blockDim.x + threadIdx.x;
    const bool active = b < nblocks;
    uint32_t w[W];
    load_block<W>(tiles, nblocks, b, active, w);
    const uint32_t valid = active ? valid_word(block_offset + b, n) : 0u;
#pragma unroll
    for (int r = 0; r < kBlockValues; ++r) {
      const uint32_t d = unpack_value<W>(w, r) - lo;
      if (((valid >> r) & 1u) && d < (uint32_t)k) atomicAdd(s_bin + bin_slot(d), 1u);
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < slots; p += blockDim.x) {
    const unsigned c = s_bin[p];
    if (c) atomicAdd(counts + bin_slot((uint32_t)p), (unsigned long long)c);
  }
}

template <typename Kernel, typename... Args>
cudaError_t launch_resident(Kernel kernel, size_t smem, long long nblocks, cudaStream_t stream,
                            Args... args) {
  unsigned grid = 0;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = resident_grid(kernel, kThreads, smem, (nblocks + kThreads - 1) / kThreads, &grid);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// --- the domain histogram as G windows a CTA in shared memory -------------

constexpr int kWindow = 4096;

template <int W>
__global__ void __launch_bounds__(kThreads)
domain_windows_kernel(const uint32_t* __restrict__ tiles, int g, int groups,
                      unsigned long long* __restrict__ counts, long long nblocks, long long n,
                      long long block_offset) {
  extern __shared__ unsigned s_win[];  // g * kWindow bins, then a spare counter
  const int group = blockIdx.x % groups;
  const long long lane = blockIdx.x / groups, lanes = gridDim.x / groups;
  const uint32_t span = (uint32_t)g * kWindow, lo = (uint32_t)group * span;
  zero_counts(s_win, (int)span);
  const long long ntiles = (nblocks + blockDim.x - 1) / blockDim.x;
  for (long long t = lane; t < ntiles; t += lanes) {
    const long long first = t * blockDim.x;
    const long long b = first + threadIdx.x;
    const bool active = b < nblocks;
    uint32_t w[W];
    load_block<W>(tiles, nblocks, b, active, w);
    if (full_tile(first, nblocks, n, block_offset)) {
      count_block<W, false, false>(w, 0u, lo, span, s_win, span);
    } else {
      const uint32_t valid = active ? valid_word(block_offset + b, n) : 0u;
      count_block<W, false, true>(w, valid, lo, span, s_win, span);
    }
  }
  __syncthreads();
  for (uint32_t p = threadIdx.x; p < span; p += blockDim.x) {
    const unsigned c = s_win[p];
    if (c) atomicAdd(counts + lo + bin_slot(p), (unsigned long long)c);
  }
}

template <int W>
cudaError_t launch_domain_windows(const uint32_t* tiles, int g, unsigned long long* counts,
                                  long long nblocks, long long n, cudaStream_t stream) {
  const auto kernel = domain_windows_kernel<W>;
  const size_t smem = ((size_t)g * kWindow + 1) * sizeof(unsigned);
  const int groups = (int)(((1LL << W) + (long long)g * kWindow - 1) / ((long long)g * kWindow));
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long lanes = resident / groups > 0 ? resident / groups : 1;
  kernel<<<(unsigned)(lanes * groups), kThreads, smem, stream>>>(tiles, g, groups, counts,
                                                                 nblocks, n, 0);
  return cudaGetLastError();
}

// --- the static linear export before its redesign --------------------------

__device__ __forceinline__ void stage_byte_row(uint8_t* stage, int k, int j, uint32_t word) {
  uint8_t* p = stage + (size_t)threadIdx.x * (k + 1) * 4 + j;
  p[0] = (uint8_t)word;
  p[k] = (uint8_t)(word >> 8);
  p[2 * k] = (uint8_t)(word >> 16);
  p[3 * k] = (uint8_t)(word >> 24);
}

template <int W>
__global__ void __launch_bounds__(kStaticThreadsMax)
static_linear_baseline_kernel(const uint32_t* __restrict__ tiles, const uint2* __restrict__ prog,
                              int nops, int k, uint32_t* __restrict__ out,
                              unsigned long long* __restrict__ counts, long long nblocks,
                              long long n, long long block_offset, int slots) {
  extern __shared__ uint32_t s_val[];  // [slot][threadIdx.x], then the linear stage
  __shared__ unsigned s_cnt[kMaxLinearKeys];
  zero_counts(s_cnt, k);
  uint8_t* stage = reinterpret_cast<uint8_t*>(s_val + (size_t)slots * blockDim.x);
  const int stride = blockDim.x;
  const long long ntiles = (nblocks + blockDim.x - 1) / blockDim.x;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long first = t * stride;
    const long long b = first + threadIdx.x;
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
      } else {
        const uint32_t row = kind == kOut ? a & valid : 0u;
        count_row((int)target, row, s_cnt);
        stage_byte_row(stage, k, (int)target, row);
      }
    }
    const long long left = nblocks - first;
    flush_linear(reinterpret_cast<uint32_t*>(stage), k, out, first,
                 left < blockDim.x ? (int)left : (int)blockDim.x);
  }
  flush_counts(s_cnt, k, counts);
}

// --- the linear fold with its keys in constant memory ----------------------

__constant__ uint32_t c_fold_keys[kMaxLinearKeys];

struct ConstKeys {
  __device__ __forceinline__ uint32_t operator[](int j) const { return c_fold_keys[j]; }
};

}  // namespace sss

// Variants of the single-window bins kernel at widths 9 and 20 (lo a
// device pointer, counts int64[k] zeroed by the caller): 0 the kernel
// before its redesign, 1 the library's, 2 the library's without its bank
// swizzle, 3 with a branch around its atomics in place of the spare
// counter.
extern "C" int sweep_bins(int variant, const uint32_t* tiles, const uint32_t* lo, int k,
                          unsigned long long* counts, long long nblocks, int width, long long n,
                          cudaStream_t stream) {
  if (k < 1 || k > sss::kMaxHistKeys || nblocks <= 0) return (int)cudaErrorInvalidValue;
#define SSS_BINS(W)                                                                              \
  if (width == W) {                                                                              \
    if (variant == 0)                                                                            \
      return (int)sss::launch_resident(sss::bins_baseline_kernel<W>, 0, nblocks, stream, tiles,  \
                                       lo, k, counts, nblocks, n, 0LL);                          \
    if (variant == 1)                                                                            \
      return (int)sss::launch_resident(sss::histogram_kernel<W>, 0, nblocks, stream,           \
                                       tiles, lo, 0u, k, counts, nblocks, n, 0LL);               \
    if (variant == 2)                                                                            \
      return (int)sss::launch_resident(sss::histogram_kernel<W, false>, 0, nblocks,              \
                                       stream, tiles, lo, 0u, k, counts, nblocks, n, 0LL);       \
    if (variant == 3)                                                                            \
      return (int)sss::launch_resident(sss::histogram_kernel<W, true, false>, 0, nblocks,        \
                                       stream, tiles, lo, 0u, k, counts, nblocks, n, 0LL);       \
  }
  SSS_BINS(9)
  SSS_BINS(20)
#undef SSS_BINS
  return (int)cudaErrorInvalidValue;
}

// Variants of the domain histogram at width 20 (counts int64[2^20], or for
// variant 2 uint32[2^20], zeroed by the caller): 0 the library's, 1 without
// its merging, 2 with 32-bit counters, 3.. G = variant windows of 4096
// bins a CTA in shared memory.
extern "C" int sweep_domain(int variant, const uint32_t* tiles, void* counts, long long nblocks,
                            int width, long long n, cudaStream_t stream) {
  if (width != 20 || nblocks <= 0) return (int)cudaErrorInvalidValue;
  auto* c64 = static_cast<unsigned long long*>(counts);
  if (variant == 0) return (int)sss::launch_histogram_domain<20>(tiles, c64, nblocks, n, 0, stream);
  if (variant == 1)
    return (int)sss::launch_resident(sss::histogram_domain_kernel<20, unsigned long long, false>,
                                     0, nblocks, stream, tiles, c64, nblocks, n, 0LL);
  if (variant == 2)
    return (int)sss::launch_resident(sss::histogram_domain_kernel<20, unsigned, true>, 0, nblocks,
                                     stream, tiles, static_cast<unsigned*>(counts), nblocks, n,
                                     0LL);
  return (int)sss::launch_domain_windows<20>(tiles, variant, c64, nblocks, n, stream);
}

// Variants of the static linear export at width 9 (keys a host array of k
// uint32, dev_keys the same keys in device memory, prog / nops / slots the
// key set's program for variant 0; out uint32[nblocks * k], counts
// int64[k] zeroed by the caller): 0 the kernel before its redesign
// (`threads` threads a CTA), 1 the library's entry, its plane masks in
// shared memory at 2 256 and 3 128 threads a CTA, and the fold with its
// masks computed from the keys in the loop: 4 keys as kernel parameters at
// 256 and 5 at 128 threads, 6 keys in constant memory, 7 keys read from
// device memory.
extern "C" int sweep_fold(int variant, const uint32_t* tiles, const uint32_t* keys,
                          const uint32_t* dev_keys, const int* prog, int nops, int slots,
                          int threads, int k, uint32_t* out, unsigned long long* counts,
                          long long nblocks, int width, long long n, cudaStream_t stream) {
  if (width != 9 || !sss::linear_k_ok(k) || nblocks <= 0) return (int)cudaErrorInvalidValue;
  sss::LinearKeys hk{};
  for (int j = 0; j < k; ++j) hk.key[j] = keys[j];
  switch (variant) {
    case 0: {
      const auto kernel = sss::static_linear_baseline_kernel<9>;
      const size_t smem = ((size_t)slots + k + 1) * threads * sizeof(uint32_t);
      unsigned grid = 0;
      cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err == cudaSuccess)
        err = sss::resident_grid(kernel, threads, smem, (nblocks + threads - 1) / threads, &grid);
      if (err != cudaSuccess) {
        cudaGetLastError();
        return (int)err;
      }
      kernel<<<grid, threads, smem, stream>>>(tiles, reinterpret_cast<const uint2*>(prog), nops,
                                              k, out, counts, nblocks, n, 0, slots);
      return (int)cudaGetLastError();
    }
    case 1:
      return sss_bitsliced_static_scan_linear(tiles, keys, k, out, counts, nblocks, 9, n, 0,
                                              stream);
    case 2:
    case 3:
      return (int)sss::launch_static_fold<9, sss::LinearKeys, sss::kFoldLinear>(
          tiles, hk, k, k, out, counts, nblocks, n, 0, variant == 2 ? 256 : 128, stream);
    case 4:
    case 5:
      return (int)sss::launch_fold_linear<9>(tiles, hk, k, out, counts, nblocks, n, 0,
                                             variant == 4 ? 256 : 128, stream);
    case 6: {
      const cudaError_t err = cudaMemcpyToSymbolAsync(sss::c_fold_keys, keys, k * sizeof(uint32_t),
                                                      0, cudaMemcpyHostToDevice, stream);
      if (err != cudaSuccess) return (int)err;
      return (int)sss::launch_fold_linear<9>(tiles, sss::ConstKeys{}, k, out, counts, nblocks, n,
                                             0, 256, stream);
    }
    case 7:
      return (int)sss::launch_fold_linear<9>(tiles, sss::DeviceKeys{dev_keys}, k, out, counts,
                                             nblocks, n, 0, 256, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

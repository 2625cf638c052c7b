// Full-buffer byte copy: the benchmark's bandwidth yardstick.
//
// Replaces shared_simd_scan_tpu/bench/harness.py: _memcpy_kernel /
// chain_memcpy, a copy of the whole buffer in (tb, 1024) uint32 blocks, in
// place by input_output_aliases, so that each call reads and writes every
// byte once.  Here a call copies one buffer into another; the benchmark's
// chain copies back and forth between two equal buffers, so each call still
// reads and writes every byte once.
//
// Bound on the H100: device memory bytes (nbytes read + nbytes written over
// 3.35 TB/s).  Design: bulk copies through shared memory.  The whole 16-byte
// vectors are cut into chunks of kStageBytes, and a CTA copies a run of kRun
// consecutive chunks through a ring of kStages stages in dynamic shared
// memory.  One thread drives it: a bulk load (cp.async.bulk, the TMA's
// non-tensor form) fills a stage and signals the stage's mbarrier with the
// bytes it delivered; once the barrier completes, a bulk store writes the
// stage out; in a run longer than the ring a stage is refilled as soon as
// its store has read it (cp.async.bulk.wait_group.read).  No register holds
// a byte.  At 32 KB stages, four of them and runs of four, a CTA moves 128
// KB: four loads in flight at once, each stored as it lands; its 128 KB of
// shared memory keeps one CTA on an SM, and the CTAs, dispatched in address
// order as others retire, keep the bytes in flight in one compact window.
// A persistent grid walking the buffer with the same ring (kRun 0) was 3-4%
// slower in bench/redesign_sweep.py, we suppose because its CTAs drift
// apart and spread the bytes in flight over the buffer.  The last chunk is
// ragged (a multiple of 16 bytes); the bytes past the last whole vector are
// copied one by one by the lanes of CTA 0.  Both pointers must be 16-byte
// aligned, the bulk copies' rule.  The bulk-copy and mbarrier helpers are
// in common.cuh: the scans' staged tile loop shares them.
#include "common.cuh"

namespace sss {

constexpr int kCopyStageBytes = 32 * 1024;  // COPY_STAGE_BYTES in bench/harness.py
constexpr int kCopyStages = 4;
constexpr int kCopyRun = 4;  // chunks a CTA copies (see copy_ring_kernel)
constexpr int kCopyThreads = 32;  // one warp: lane 0 drives the ring, lanes < 16 copy the tail

// kRun 0: the resident grid, CTA g taking chunks g, g + gridDim.x, ...;
// kRun > 0: a CTA for every kRun consecutive chunks.
template <int kStageBytes, int kStages, int kRun>
__global__ void __launch_bounds__(kCopyThreads)
copy_ring_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, long long nbulk,
                 long long nchunks, int tail) {
  extern __shared__ __align__(128) uint8_t s_stage[];
  __shared__ __align__(8) uint64_t s_full[kStages];
  if (blockIdx.x == 0 && (int)threadIdx.x < tail)
    dst[nbulk + threadIdx.x] = src[nbulk + threadIdx.x];
  if (threadIdx.x != 0) return;
  const long long first = kRun ? (long long)blockIdx.x * kRun : blockIdx.x;
  const long long step = kRun ? 1 : gridDim.x;
  long long count = first < nchunks ? (nchunks - 1 - first) / step + 1 : 0;
  if (kRun && count > kRun) count = kRun;
  for (int s = 0; s < kStages; ++s) mbar_init(&s_full[s], 1u);
  mbar_init_fence();

  // Chunk i of this CTA: offset and bytes (the last chunk of the buffer is ragged).
  auto offset = [&](long long i) { return (first + i * step) * kStageBytes; };
  auto bytes = [&](long long i) {
    const long long left = nbulk - offset(i);
    return (uint32_t)(left < kStageBytes ? left : kStageBytes);
  };
  auto load = [&](long long i) {
    const int s = (int)(i % kStages);
    mbar_expect_tx(&s_full[s], bytes(i));
    bulk_load(s_stage + s * kStageBytes, src + offset(i), bytes(i), &s_full[s]);
  };
  for (long long i = 0; i < count && i < kStages; ++i) load(i);
  for (long long i = 0; i < count; ++i) {
    const int s = (int)(i % kStages);
    mbar_wait(&s_full[s], (uint32_t)((i / kStages) & 1));
    bulk_store(dst + offset(i), s_stage + s * kStageBytes, bytes(i));
    // the store of chunk i - 1 has read its stage: refill it with chunk i - 1 + kStages
    bulk_wait_read<1>();
    if (i >= 1 && i - 1 + kStages < count) load(i - 1 + kStages);
  }
  bulk_wait_all();
}

template <int kStageBytes, int kStages>
constexpr size_t copy_ring_smem() {
  return (size_t)kStageBytes * kStages;
}

// Launch the ring (on the resident grid for kRun 0); the ring's shared
// memory limit is raised first (the stages pass the 48 KB default).
template <int kStageBytes, int kStages, int kRun>
cudaError_t copy_ring_launch(const void* src, void* dst, long long nbytes, cudaStream_t stream) {
  if (nbytes < 0 || reinterpret_cast<uintptr_t>(src) % 16 ||
      reinterpret_cast<uintptr_t>(dst) % 16)
    return cudaErrorInvalidValue;
  if (nbytes == 0) return cudaSuccess;
  const long long nbulk = nbytes / 16 * 16;
  const long long nchunks = (nbulk + kStageBytes - 1) / kStageBytes;
  const int tail = (int)(nbytes - nbulk);
  auto kernel = copy_ring_kernel<kStageBytes, kStages, kRun>;
  constexpr size_t smem = copy_ring_smem<kStageBytes, kStages>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  unsigned grid = 0;
  if (kRun) {
    const long long runs = nchunks > 0 ? (nchunks + kRun - 1) / kRun : 1;
    if (runs > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
    grid = (unsigned)runs;
  } else {
    err = resident_grid(kernel, kCopyThreads, smem, nchunks > 0 ? nchunks : 1, &grid);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kCopyThreads, smem, stream>>>(static_cast<const uint8_t*>(src),
                                                static_cast<uint8_t*>(dst), nbulk, nchunks, tail);
  return cudaGetLastError();
}

}  // namespace sss

// Copy nbytes from src to dst (both 16-byte aligned, not overlapping).
extern "C" int sss_copy(const void* src, void* dst, long long nbytes, cudaStream_t stream) {
  return (int)sss::copy_ring_launch<sss::kCopyStageBytes, sss::kCopyStages, sss::kCopyRun>(
      src, dst, nbytes, stream);
}

// Dynamic shared memory of one CTA of the copy (its ring of stages).
extern "C" long long sss_copy_smem() {
  return (long long)sss::copy_ring_smem<sss::kCopyStageBytes, sss::kCopyStages>();
}

// Interleave of m byte streams at a granularity of G bytes: the linear
// relayout.
//
// out byte q*(m*G) + s*G + r = stream s byte q*G + r, zero past a stream's
// in_len bytes, for out_len bytes.  Replaces shared_simd_scan_tpu/ops/linear.py:
//  - _interleave_mxu_kernel / _interleave_mxu_call (linear.py:339): G = 1
//    and m = k turn (k, W) bitvectors into the linear bytes (out byte
//    g*k + j = byte g of key j's bitvector), here for any k;
//  - _interleave_streams_kernel / interleave_streams_mxu_words
//    (linear.py:201): G = 4g, the g-word round-robin of m word streams,
//    zero past each stream's M words.
// The TPU kernels do the byte mixing with SWAPMOVE quads and the placement
// with a 0/1 permutation matmul, because the TPU's vector unit cannot
// spread 16 lanes to stride k.  A Hopper thread can address any byte of
// shared memory, so here the placement is a gather.
//
// Bound on the H100: device memory bytes (every input byte read once,
// every output byte written once).  Design: a CTA owns Q consecutive
// groups q, a contiguous output span of Q*m*G bytes.  It loads the m rows'
// segments [q0*G, (q0+Q)*G) into shared memory as 4-byte words, coalesced
// along each row (row stride seg + 1 words, odd), each thread keeping
// kLoadBatch loads in flight, then each thread assembles 16-byte output
// chunks from the staged bytes (words when G % 4 == 0) and stores each
// with one 16-byte store, coalesced across the warp.  The host picks seg, the words of a row segment (ops/linear.py
// _interleave_seg): a multiple of 4 and of G/4, about 32 KB of staging.
#include "common.cuh"

namespace sss {

constexpr int kInterleaveThreads = 256;
constexpr int kLoadBatch = 8;
constexpr size_t kInterleaveMaxSmem = 200 * 1024;

__global__ void __launch_bounds__(kInterleaveThreads)
interleave_kernel(const uint8_t* __restrict__ in, long long ld, long long in_len, int m, int G,
                  int seg, uint8_t* __restrict__ out, long long out_len) {
  extern __shared__ uint32_t s_in[];  // [m][seg + 1] words
  const int rs = seg + 1;
  const long long tile = blockIdx.x;
  const long long w0 = tile * seg;  // first word of every row's segment
  const int total = m * seg;
  // kLoadBatch independent loads in flight per thread before their stores
  for (int first = threadIdx.x; first < total; first += blockDim.x * kLoadBatch) {
    uint32_t r[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int idx = first + u * blockDim.x;
      const int s = idx / seg;
      const long long gw = w0 + (idx - s * seg);
      r[u] = idx < total && gw * 4 < in_len
                 ? __ldg(reinterpret_cast<const uint32_t*>(in + s * ld) + gw)
                 : 0u;
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int idx = first + u * blockDim.x;
      const int s = idx / seg;
      if (idx < total) s_in[s * rs + idx - s * seg] = r[u];
    }
  }
  __syncthreads();

  const long long span = (long long)seg * 4 * m;  // output bytes of the tile
  const long long base = tile * span;
  const int nchunks = (int)(span / 16);
  const uint8_t* s_bytes = reinterpret_cast<const uint8_t*>(s_in);
  for (int c = threadIdx.x; c < nchunks; c += blockDim.x) {
    const long long off = base + 16LL * c;
    if (off >= out_len) break;
    uint32_t v[4];
    if (G == 1) {  // local out byte o = ql*m + s takes byte ql of row s
      const int o = 16 * c;
      int ql = o / m, s = o - ql * m;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t word = 0u;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          word |= (uint32_t)s_bytes[(size_t)s * rs * 4 + ql] << (8 * i);
          if (++s == m) {
            s = 0;
            ++ql;
          }
        }
        v[e] = word;
      }
    } else {  // local out word o = ql*m*g + s*g + r takes word ql*g + r of row s
      const int g = G / 4, mg = m * g, o = 4 * c;
      int ql = o / mg, s = (o - ql * mg) / g, r = o - ql * mg - s * g;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = s_in[s * rs + ql * g + r];
        if (++r == g) {
          r = 0;
          if (++s == m) {
            s = 0;
            ++ql;
          }
        }
      }
    }
    if (off + 16 <= out_len) {
      *reinterpret_cast<uint4*>(out + off) = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
      for (int i = 0; i < 16 && off + i < out_len; ++i)
        out[off + i] = (uint8_t)(v[i / 4] >> (8 * (i % 4)));
    }
  }
}

}  // namespace sss

// in: m rows of in_len bytes at a stride of ld bytes (4-byte aligned, in_len
// and ld multiples of 4); out: out_len bytes, 16-byte aligned.  G is 1 or a
// multiple of 4; seg a multiple of 4 and of G/4.
extern "C" int sss_interleave(const void* in, long long ld, long long in_len, int m, int G,
                              int seg, void* out, long long out_len, cudaStream_t stream) {
  if (m < 1 || G < 1 || (G != 1 && G % 4) || seg < 4 || seg % 4 || (G > 4 && seg % (G / 4)) ||
      ld < 0 || ld % 4 || in_len < 0 || in_len % 4 || reinterpret_cast<uintptr_t>(in) % 4 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  if (out_len <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)m * (seg + 1) * sizeof(uint32_t);
  const long long span = (long long)seg * 4 * m;
  const long long ntiles = (out_len + span - 1) / span;
  if (smem > sss::kInterleaveMaxSmem || ntiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(sss::interleave_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return (int)err;
  }
  sss::interleave_kernel<<<(unsigned)ntiles, sss::kInterleaveThreads, smem, stream>>>(
      static_cast<const uint8_t*>(in), ld, in_len, m, G, seg, static_cast<uint8_t*>(out), out_len);
  return (int)cudaGetLastError();
}

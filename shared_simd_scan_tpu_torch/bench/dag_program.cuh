// The host-compiled AND-DAG program of the interpreter kernels that the
// library ran before their redesign (ops/scan.py _static_program and
// _member_program): 8-byte instructions, word 0 = kind << 30 | target,
// word 1 = operand a | operand b << 16, operand = node slot | kNeg for its
// complement.  Node values live in dynamic shared memory laid out
// [slot][threadIdx.x].  Only the sweeps' "before" kernels read it.
#pragma once

#include "../csrc/common.cuh"

namespace sss {

constexpr int kStaticThreadsMax = 128;
constexpr uint32_t kAnd = 0u, kOut = 1u, kOr = 3u;
constexpr uint32_t kNeg = 0x8000u;

__device__ __forceinline__ uint32_t dag_operand(const uint32_t* s_val, uint32_t op, int stride) {
  const uint32_t v = s_val[(op & (kNeg - 1u)) * stride + threadIdx.x];
  return (op & kNeg) ? ~v : v;
}

}  // namespace sss

// Device helpers shared by the mLSTM scan (mlstm.cu) and its gradient
// (mlstm_bwd.cu): the gate's log sigmoid, the split-bf16 pair, the
// transposing stmatrix, and the narrow wgmma shapes the two kernels' state
// passes run (m64n32k16 and m64n8k16, bf16 -> fp32).  In an unnamed
// namespace: each translation unit keeps its own copy.
#pragma once

#include "hopper.cuh"

namespace {

// log sigma(x) = -softplus(-x), stable for either sign; 0 at x = +inf
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// (hi, lo) of two values, each pair packed as bf16x2: hi = bf16(x),
// lo = bf16(x - hi)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = rt::pack_bf16(x0 - hf.x, x1 - hf.y);
}

// Four 8x8 b16 matrices from mma fragments, stored transposed: the row
// address given by lane 8 i + r receives column r of matrix i.
__device__ __forceinline__ void stmatrix_x4_trans(void* p, uint32_t r0,
                                                  uint32_t r1, uint32_t r2,
                                                  uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, "
      "%4};\n" ::"r"(rt::smem_addr(p)),
      "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}

#define MLSTM_ACC8(d, i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 32) += A (64 x 16) @ B (16 x 32), A and B from shared memory; TA
// the transpose bit of A (1: M-major), B K-major.
template <int TA>
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, 0;\n}\n"
      : MLSTM_ACC8(d, 0), MLSTM_ACC8(d, 8)
      : "l"(da), "l"(db), "r"(1), "n"(TA));
}

// d (64 x 8) += A (64 x 16) @ B (16 x 8), A and B from shared memory; TA
// the transpose bit of A, B K-major.
template <int TA>
__device__ __forceinline__ void wgmma_n8(float (&d)[4], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3}, %4, %5, p, 1, 1, %7, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1), "n"(TA));
}

#undef MLSTM_ACC8

}  // namespace

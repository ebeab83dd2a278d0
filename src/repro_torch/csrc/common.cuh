// Building blocks shared by the port's Hopper kernels (sm_90a).
//
// The kernels are written on the warp-level tensor-core instruction
// mma.sync.m16n8k16 (bf16 inputs, fp32 accumulators), fed from shared
// memory by ldmatrix and staged from device memory by cp.async.  The
// fragment layouts are PTX's documented ones, so an epilogue can address
// every accumulator element by (row, column):
//
//   A (16x16, row-major)  a[0]: (g, 2t..2t+1)    a[1]: (g+8, 2t..2t+1)
//                         a[2]: (g, 2t+8..+9)    a[3]: (g+8, 2t+8..+9)
//   B (16x8,  k x n)      b[0]: (k=2t..2t+1, n=g) b[1]: (k=2t+8..+9, n=g)
//   C (16x8,  fp32)       c[0..1]: (g, 2t..2t+1) c[2..3]: (g+8, 2t..2t+1)
//
// with g = lane / 4 and t = lane % 4.  Shared-memory tiles are padded by
// 8 bf16 (16 bytes) per row so that ldmatrix's eight row addresses fall
// in distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

using bf16 = __nv_bfloat16;

constexpr float kNeg = -1e30f;  // the reference kernels' mask constant

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; bytes past ``src_bytes``
// (0 or 16) are zero-filled, so a tile's ragged edge reads as zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy 8 consecutive bf16 (one 16-byte chunk) of a row into shared memory.
// ``vec``: the row pitch and base are 16-byte aligned, so a chunk is either
// wholly inside the row or wholly outside it (cp.async, zero-filled).
// Otherwise each element is checked against ``valid`` (elements left in
// the row) and stored synchronously; the caller's __syncthreads publishes
// both kinds alike.  ``base`` is any valid address of the same tensor: a
// zero-filled copy is handed it instead of the out-of-range ``src``.
__device__ __forceinline__ void load_chunk(bf16* dst, const bf16* src,
                                           int valid, bool vec,
                                           const bf16* base) {
  if (vec) {
    cp_async16(dst, valid > 0 ? src : base, valid > 0);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      dst[e] = e < valid ? src[e] : __float2bfloat16(0.f);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a @ b for one 16x8x16 tile (bf16 in, fp32 accumulate).
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A-operand fragment of rows [row0, row0+16) x cols [col0, col0+16) of a
// row-major shared tile with row stride ``ld`` (elements).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int ld, int row0, int col0, int lane) {
  ldmatrix_x4(a, tile + (row0 + (lane & 15)) * ld + col0 + (lane >> 4) * 8);
}

// B-operand fragments of two neighbouring n8 tiles, [n0, n0+8) and
// [n0+8, n0+16), at k rows [k0, k0+16) of a row-major (k x n) shared tile:
// b[0..1] for the first n8 tile, b[2..3] for the second.
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const bf16* tile,
                                          int ld, int k0, int n0, int lane) {
  ldmatrix_x4_trans(
      b, tile + (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld + n0 +
             8 * (lane >> 4));
}

// B-operand fragments when the shared tile holds B transposed, row-major
// (n x k) -- the keys of attention's Q K^T: b[0..1] for keys [n0, n0+8),
// b[2..3] for keys [n0+8, n0+16), at k columns [k0, k0+16).
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const bf16* tile,
                                          int ld, int n0, int k0, int lane) {
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + 8 * (lane >> 4)) * ld + k0 +
                     8 * ((lane >> 3) & 1));
}

// Activations, matching repro.kernels.ref.act_fn: 0 gelu (tanh form),
// 1 gelu_exact, 2 silu, 3 relu, 4 identity.  ``act_k<Kind>`` is one of
// them; ``with_act`` hands an epilogue the functor of a kind picked at run
// time, so that its unrolled loop holds one activation's code and not a
// switch over all of them per element.
template <int Kind>
__device__ __forceinline__ float act_k(float x) {
  if constexpr (Kind == 0) {
    // 0.5 x (1 + tanh(u)) = x sigmoid(2u), u = sqrt(2 / pi) (x + 0.044715
    // x^3): one exponential and one reciprocal instead of tanhf
    const float k2 = 1.5957691216057308f;  // 2 sqrt(2 / pi)
    return __fdividef(x, 1.f + __expf(-k2 * (x + 0.044715f * x * x * x)));
  } else if constexpr (Kind == 1) {
    return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
  } else if constexpr (Kind == 2) {
    return x / (1.f + __expf(-x));
  } else if constexpr (Kind == 3) {
    return x > 0.f ? x : 0.f;
  } else {
    return x;
  }
}

template <int Kind>
struct Act {
  __device__ __forceinline__ float operator()(float x) const {
    return act_k<Kind>(x);
  }
};

// f(act) with the functor of activation ``kind``: an epilogue picks its
// activation once, outside its unrolled loop
template <class F>
__device__ __forceinline__ void with_act(int kind, F f) {
  switch (kind) {
    case 0:
      return f(Act<0>{});
    case 1:
      return f(Act<1>{});
    case 2:
      return f(Act<2>{});
    case 3:
      return f(Act<3>{});
    default:
      return f(Act<4>{});
  }
}

}  // namespace rt

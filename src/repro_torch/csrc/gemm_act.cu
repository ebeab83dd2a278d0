// y = act(x @ w + b): the paper's GEMM + activation benchmark op.
//
// Replaces the TPU kernel repro/kernels/gemm_gelu.py:gemm_act and computes
// what it computes: the pre-activation lives only in the fp32 accumulator
// tile, the bias (optional: a null pointer) is added and the activation
// applied in fp32 in the epilogue, and the result is rounded to bf16 once.
// Activations as rt::act: gelu (the tanh form), gelu_exact (erf), silu,
// relu, identity.  On the serving path it is granite-20b's MLP up
// projection (M = the prefill bucket, 6144 -> 24576), compute-bound on an
// H100 at M = 2048 (6.2e11 FLOP against 428 MB) and bound by the 302 MB
// weight panel at M = 128.  Design: the tile loop of gemm.cu
// (gemm_tile.cuh: 128 x 128 output tiles, mma.sync, a two-stage cp.async
// ring over K, any M, N, K); only the epilogue differs, so the hidden
// tensor's pre-activation never reaches device memory.  The TPU's k grid
// axis with its epilogue on the last k step becomes the k loop inside one
// block followed by the epilogue.
#include "gemm_tile.cuh"

namespace {

using rt::bf16;
namespace gt = rt::gemm_tile;

__global__ void __launch_bounds__(gt::THREADS)
gemm_act_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                const bf16* __restrict__ b, bf16* __restrict__ y, int M,
                int N, int K, int vec, int act_kind) {
  __shared__ gt::Smem sm;
  const int m0 = blockIdx.y * gt::BM, n0 = blockIdx.x * gt::BN;
  gt::Acc acc;
  gt::mainloop(acc, sm, x, w, M, N, K, vec, m0, n0);
  gt::store(acc, y, M, N, m0, n0, [&](float v, int c) {
    return rt::act(b ? v + __bfloat162float(b[c]) : v, act_kind);
  });
}

}  // namespace

extern "C" int rt_gemm_act(const void* x, const void* w, const void* b,
                           void* y, int M, int N, int K, int vec,
                           int act_kind, void* stream) {
  const dim3 grid((N + gt::BN - 1) / gt::BN, (M + gt::BM - 1) / gt::BM);
  gemm_act_kernel<<<grid, gt::THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(b), static_cast<bf16*>(y), M, N, K, vec,
      act_kind);
  return static_cast<int>(cudaGetLastError());
}

// y = act(x @ w + b): the paper's GEMM + activation benchmark op.
//
// Replaces the TPU kernel repro/kernels/gemm_gelu.py:gemm_act and computes
// what it computes: the pre-activation lives only in fp32 (accumulator
// registers, or the split-K partials), the bias (optional: a null pointer)
// is added and the activation applied in fp32 to the whole sum, and the
// result is rounded to bf16 once.  Activations as rt::act_k: gelu (the tanh
// form), gelu_exact (erf), silu, relu, identity.  On the serving path it
// is granite-20b's MLP up projection (M = the prefill bucket, 6144 ->
// 24576), compute-bound on an H100 at M = 2048 (6.2e11 FLOP against 428
// MB) and bound by the 302 MB weight panel at M = 128.  Design: the tile
// loops of gemm.cu (gemm_tile.cuh: TMA + wgmma, persistent, split along K
// where the tiles are too few; mma.sync for operands TMA cannot take);
// only the epilogue differs, and with split-K it runs in the reduction,
// after the partials are summed, since act(sum) is not the sum of acts.
// The TPU's k grid axis with its epilogue on the last k step becomes the k
// loop inside one block followed by the epilogue.
#include "gemm_tile.cuh"

namespace {

using rt::bf16;
namespace gt = rt::gemm_tile;

// the epilogue: act(sum + b[c]) (the loops add the bias), the activation
// picked once
struct Act {
  template <class F>
  __device__ __forceinline__ static void with(const gt::Params& p, F f) {
    rt::with_act(p.act, f);
  }
};

template <class Loop>
__global__ void __launch_bounds__(Loop::kThreads, Loop::kMinBlocks)
    gemm_act_kernel(const __grid_constant__ gt::Params p) {
  Loop::template run<Act>(p);
}

}  // namespace

extern "C" int rt_gemm_act(const void* x, const void* w, const void* b,
                           void* y, void* ws, int M, int N, int K,
                           int act_kind, int tma, int bn, int split,
                           int grid, void* stream) {
  gt::Params p{};
  p.x = static_cast<const bf16*>(x);
  p.w = static_cast<const bf16*>(w);
  p.bias = static_cast<const bf16*>(b);
  p.y = static_cast<bf16*>(y);
  p.ws = static_cast<float*>(ws);
  p.M = M, p.N = N, p.K = K, p.act = act_kind, p.split = split;
  return gt::launch({&gemm_act_kernel<gt::TmaLoop<128>>,
                     &gemm_act_kernel<gt::TmaLoop<256>>,
                     &gemm_act_kernel<gt::SyncLoop>,
                     &gemm_act_kernel<gt::Reduce>},
                    p, tma, bn, grid, static_cast<cudaStream_t>(stream));
}

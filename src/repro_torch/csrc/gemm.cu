// y = x @ w with an fp32 accumulator, cast to bf16 on the flush.
//
// Replaces the TPU kernel repro/kernels/gemm.py:gemm.  On the serving path
// it is granite-20b's MLP down projection (the partial schedule, every
// prefill layer: M = the bucket, 24576 -> 6144) and the QKV/O projections
// of run_block.  At M = 2048 the down projection is compute-bound on an
// H100 (6.2e11 FLOP against 428 MB of operands); at a 128-row bucket it
// is bound by the 302 MB weight panel, and granite's MQA wk/wv (N = 128)
// gives 16 output tiles for 132 SMs.  Design (gemm_tile.cuh): operands TMA
// can take run the persistent, warp-specialised TMA + wgmma loop on
// 128 x 128 or 128 x 256 tiles, split along K where the tiles are too few
// to fill the SMs (fp32 partials summed in a fixed order by a second
// launch); anything else runs the mma.sync loop.  kernels/gemm.py:schedule
// picks the route, the tile width, the split and the grid.  The TPU's
// (block_m, block_n, block_k) grid with a VMEM accumulator carried across
// the k grid axis becomes the k loop inside one block (or inside one
// split's range, summed by the reduction).
#include "gemm_tile.cuh"

namespace {

using rt::bf16;
namespace gt = rt::gemm_tile;

// the epilogue: the fp32 sum as it is (no bias, no activation)
struct Plain {
  template <class F>
  __device__ __forceinline__ static void with(const gt::Params&, F f) {
    f([](float v) { return v; });
  }
};

template <class Loop>
__global__ void __launch_bounds__(Loop::kThreads, Loop::kMinBlocks)
    gemm_kernel(const __grid_constant__ gt::Params p) {
  Loop::template run<Plain>(p);
}

}  // namespace

extern "C" int rt_gemm(const void* x, const void* w, void* y, void* ws,
                       int M, int N, int K, int tma, int bn, int split,
                       int grid, void* stream) {
  gt::Params p{};
  p.x = static_cast<const bf16*>(x);
  p.w = static_cast<const bf16*>(w);
  p.y = static_cast<bf16*>(y);
  p.ws = static_cast<float*>(ws);
  p.M = M, p.N = N, p.K = K, p.split = split;
  return gt::launch({&gemm_kernel<gt::TmaLoop<128>>,
                     &gemm_kernel<gt::TmaLoop<256>>,
                     &gemm_kernel<gt::SyncLoop>, &gemm_kernel<gt::Reduce>},
                    p, tma, bn, grid, static_cast<cudaStream_t>(stream));
}

extern "C" int rt_gemm_smem_bytes() { return gt::SMEM_BYTES; }

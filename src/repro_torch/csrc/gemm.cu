// y = x @ w with an fp32 accumulator, cast to bf16 on the flush.
//
// Replaces the TPU kernel repro/kernels/gemm.py:gemm.  At the QKV/O
// projections of llama3.2-3b at M = 1024 (K = 3072, N = 3072 or 1024) the
// work is compute-bound on an H100 (~2 * M * N * K FLOP against ~25 MB of
// operands).  Design (gemm_tile.cuh): one 128 x 128 output tile per block
// of 8 warps, each warp a 64 x 32 sub-tile of mma.sync m16n8k16
// accumulators; K is walked in steps of 32 with a two-stage cp.async
// pipeline so the next step's tiles load while this step's multiply runs.
// Any M, N and K: the ragged edges load as zeros and the epilogue stores
// only in-range elements.  The TPU's (block_m, block_n, block_k) grid with
// a VMEM accumulator carried across the k grid axis becomes the k loop
// inside one block; Hopper's wgmma/TMA path is later work.
#include "gemm_tile.cuh"

namespace {

using rt::bf16;
namespace gt = rt::gemm_tile;

__global__ void __launch_bounds__(gt::THREADS)
gemm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
            bf16* __restrict__ y, int M, int N, int K, int vec) {
  __shared__ gt::Smem sm;
  const int m0 = blockIdx.y * gt::BM, n0 = blockIdx.x * gt::BN;
  gt::Acc acc;
  gt::mainloop(acc, sm, x, w, M, N, K, vec, m0, n0);
  gt::store(acc, y, M, N, m0, n0, [](float v, int) { return v; });
}

}  // namespace

extern "C" int rt_gemm(const void* x, const void* w, void* y, int M, int N,
                       int K, int vec, void* stream) {
  const dim3 grid((N + gt::BN - 1) / gt::BN, (M + gt::BM - 1) / gt::BM);
  gemm_kernel<<<grid, gt::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<bf16*>(y), M, N, K, vec);
  return static_cast<int>(cudaGetLastError());
}

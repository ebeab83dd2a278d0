// y = x @ w with an fp32 accumulator, cast to bf16 on the flush.
//
// Replaces the TPU kernel repro/kernels/gemm.py:gemm.  At the QKV/O
// projections of llama3.2-3b at M = 1024 (K = 3072, N = 3072 or 1024) the
// work is compute-bound on an H100 (~2 * M * N * K FLOP against ~25 MB of
// operands).  Design: one 128 x 128 output tile per block of 8 warps,
// each warp a 64 x 32 sub-tile of mma.sync m16n8k16 accumulators; K is
// walked in steps of 32 with a two-stage cp.async pipeline so the next
// step's tiles load while this step's multiply runs.  Any M, N and K: the
// ragged edges load as zeros and the epilogue stores only in-range
// elements.  The TPU's (block_m, block_n, block_k) grid with a VMEM
// accumulator carried across the k grid axis becomes the k loop inside
// one block; Hopper's wgmma/TMA path is later work.
#include "common.cuh"

namespace {

using rt::bf16;

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int THREADS = 256;          // 8 warps: 2 along M x 4 along N
constexpr int WM = 64, WN = 32;       // warp tile
constexpr int MI = WM / 16, NI = WN / 8;
constexpr int LDA = BK + 8, LDB = BN + 8;

__global__ void __launch_bounds__(THREADS)
gemm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
            bf16* __restrict__ y, int M, int N, int K, int vec) {
  __shared__ __align__(16) bf16 As[2][BM * LDA];
  __shared__ __align__(16) bf16 Bs[2][BK * LDB];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  auto load = [&](int kt, int st) {
    const int k0 = kt * BK;
    // A tile: BM rows x BK cols = 512 chunks of 8
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / (BK / 8), cc = (c % (BK / 8)) * 8;
      const int gr = m0 + r, gc = k0 + cc;
      const int valid = gr < M ? K - gc : 0;
      rt::load_chunk(&As[st][r * LDA + cc], x + (size_t)gr * K + gc, valid,
                     vec, x);
    }
    // B tile: BK rows x BN cols = 512 chunks of 8
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / (BN / 8), cc = (c % (BN / 8)) * 8;
      const int gr = k0 + r, gc = n0 + cc;
      const int valid = gr < K ? N - gc : 0;
      rt::load_chunk(&Bs[st][r * LDB + cc], w + (size_t)gr * N + gc, valid,
                     vec, w);
    }
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int ktiles = (K + BK - 1) / BK;
  load(0, 0);
  rt::cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    if (kt + 1 < ktiles) load(kt + 1, (kt + 1) & 1);
    rt::cp_async_commit();
    rt::cp_async_wait<1>();
    __syncthreads();
    const bf16* a_t = As[kt & 1];
    const bf16* b_t = Bs[kt & 1];
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t a[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        rt::load_a(a[i], a_t, LDA, wm * WM + i * 16, ks, lane);
#pragma unroll
      for (int j = 0; j < NI; j += 2) {
        uint32_t b[4];
        rt::load_b_kn(b, b_t, LDB, ks, wn * WN + j * 8, lane);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          rt::mma16816(acc[i][j], a[i], b[0], b[1]);
          rt::mma16816(acc[i][j + 1], a[i], b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm * WM + i * 16 + g + h * 8;
        const int c = n0 + wn * WN + j * 8 + 2 * t;
        if (r >= M) continue;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        bf16* dst = y + (size_t)r * N + c;
        if (c + 1 < N && (N & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (c < N) dst[0] = __float2bfloat16(v0);
          if (c + 1 < N) dst[1] = __float2bfloat16(v1);
        }
      }
}

}  // namespace

extern "C" int rt_gemm(const void* x, const void* w, void* y, int M, int N,
                       int K, int vec, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<bf16*>(y), M, N, K, vec);
  return static_cast<int>(cudaGetLastError());
}

// The tile loop shared by the GEMM kernels (gemm.cu, gemm_act.cu).
//
// One 128 x 128 output tile per block of 8 warps, each warp a 64 x 32
// sub-tile of mma.sync m16n8k16 accumulators (bf16 in, fp32 accumulate);
// K is walked in steps of 32 through a two-stage cp.async ring so the
// next step's tiles load while this step's multiply runs.  Any M, N and
// K: the ragged edges load as zeros, and ``store`` writes only in-range
// elements.  A kernel is ``mainloop`` followed by ``store`` with its own
// epilogue, so each kernel keeps its own device symbol.
#pragma once

#include "common.cuh"

namespace rt::gemm_tile {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int THREADS = 256;          // 8 warps: 2 along M x 4 along N
constexpr int WM = 64, WN = 32;       // warp tile
constexpr int MI = WM / 16, NI = WN / 8;
constexpr int LDA = BK + 8, LDB = BN + 8;

struct Smem {
  __align__(16) bf16 As[2][BM * LDA];
  __align__(16) bf16 Bs[2][BK * LDB];
};

using Acc = float[MI][NI][4];

// acc = x[m0:m0+BM, :] @ w[:, n0:n0+BN] in fp32.  ``vec``: K and N are
// multiples of 8 and both operands 16-byte aligned (rt::load_chunk).
__device__ __forceinline__ void mainloop(Acc& acc, Smem& sm,
                                         const bf16* __restrict__ x,
                                         const bf16* __restrict__ w, int M,
                                         int N, int K, int vec, int m0,
                                         int n0) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / 4, wn = warp % 4;

  auto load = [&](int kt, int st) {
    const int k0 = kt * BK;
    // A tile: BM rows x BK cols = 512 chunks of 8
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / (BK / 8), cc = (c % (BK / 8)) * 8;
      const int gr = m0 + r, gc = k0 + cc;
      const int valid = gr < M ? K - gc : 0;
      load_chunk(&sm.As[st][r * LDA + cc], x + (size_t)gr * K + gc, valid,
                 vec, x);
    }
    // B tile: BK rows x BN cols = 512 chunks of 8
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / (BN / 8), cc = (c % (BN / 8)) * 8;
      const int gr = k0 + r, gc = n0 + cc;
      const int valid = gr < K ? N - gc : 0;
      load_chunk(&sm.Bs[st][r * LDB + cc], w + (size_t)gr * N + gc, valid,
                 vec, w);
    }
  };

#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int ktiles = (K + BK - 1) / BK;
  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    if (kt + 1 < ktiles) load(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* a_t = sm.As[kt & 1];
    const bf16* b_t = sm.Bs[kt & 1];
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t a[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        load_a(a[i], a_t, LDA, wm * WM + i * 16, ks, lane);
#pragma unroll
      for (int j = 0; j < NI; j += 2) {
        uint32_t b[4];
        load_b_kn(b, b_t, LDB, ks, wn * WN + j * 8, lane);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          mma16816(acc[i][j], a[i], b[0], b[1]);
          mma16816(acc[i][j + 1], a[i], b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }
}

// y[r, c] = bf16(epi(acc element, c)) for the block's in-range elements;
// ``epi(v, c)`` maps the fp32 sum at column c to the fp32 value stored.
template <class Epilogue>
__device__ __forceinline__ void store(const Acc& acc, bf16* __restrict__ y,
                                      int M, int N, int m0, int n0,
                                      Epilogue epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / 4, wn = warp % 4;
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
        bf16* dst = y + (size_t)r * N + c;
        if (c + 1 < N && (N & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(
              epi(acc[i][j][2 * h], c), epi(acc[i][j][2 * h + 1], c + 1));
        } else {
          if (c < N) dst[0] = __float2bfloat16(epi(acc[i][j][2 * h], c));
          if (c + 1 < N)
            dst[1] = __float2bfloat16(epi(acc[i][j][2 * h + 1], c + 1));
        }
      }
}

}  // namespace rt::gemm_tile

// Fused MLP: y = (act(x @ w1 + b1) [* (x @ wg)]) @ w2 + b2, with the
// (M, F) hidden tensor kept out of device memory.
//
// Replaces the TPU kernel repro/kernels/fused_mlp.py:fused_mlp and
// computes what it computes: fp32 accumulation of both products, h formed
// in fp32 and rounded to bf16 before the second product, b2 added in fp32
// at the end.
//
// Dataflow.  The TPU kernel keeps N whole and carries a (block_m, N) fp32
// accumulator across the F grid axis; at llama3.2-3b's N = 3072 that is
// 768 KiB even at block_m = 64, far beyond the 227 KiB of shared memory a
// Hopper block may claim, and Hopper blocks run in no order, so nothing
// carries from one to the next.  This kernel *splits F across blocks*:
// block (i, s) owns rows [64 i, 64 i + 64) and the F slice
// [BF s, BF s + BF).  It computes its hidden slice h (64 x BF, bf16) into
// shared memory -- K walked in steps of 32 through a two-stage cp.async
// ring, 64 or 128 hidden columns at a time -- and then multiplies it by
// the matching w2 rows, 128 output columns at a time, writing fp32
// partial sums part[s] (M x N).  A second kernel adds the F/BF partials
// and b2 in fp32, in a fixed order, and rounds to bf16.  The alternative,
// tiling N and recomputing h for each N tile, would redo the up
// projections (two thirds of the FLOPs) N/128 = 24 times over.  The split
// costs device traffic instead: 8 * M * N * F/BF bytes of partials, which
// at M = 1024 and BF = 1024 (the widest slice that fits) is 201 MB, six
// times the 34 MB that writing and reading a bf16 h would cost.
//
// Bound on an H100: at prefill (M = 1024, K = N = 3072, F = 8192, gated)
// 2 * 3 * M * K * F = 155 GFLOP make it compute-bound (~156 us at the bf16
// peak, against ~109 us at BF = 1024 and ~169 us at BF = 512 for its bytes,
// partials included); at decode
// (M = slots = 4) it is memory-bound on the 151 MB of weights (~45 us at
// 3.35 TB/s).  BF comes from the planner (kernels/fused_mlp.py:
// plan_blocks), which prices each slice's bytes, partials included,
// against how its blocks occupy the SMs: a block alone on an SM does not
// hide its load latency, so at M = 1024 it takes BF = 512 (two blocks per
// SM, 403 MB of partials) over BF = 1024 (one, 201 MB); at decode it
// spreads the weight stream over 128 blocks of BF = 64.
#include "common.cuh"

namespace {

using rt::bf16;

constexpr int BM = 64, BK = 32, BN = 128, THREADS = 256;
constexpr int LDX = BK + 8, LDW2 = BN + 8;

// shared bytes of the two-stage staging ring of phase 1 (x, w1, wg tiles)
// and phase 2 (w2 tiles); the phases run one after the other and share it
__host__ __device__ constexpr int stage_bytes(int fc) {
  const int p1 = 2 * (BM * LDX + 2 * BK * (fc + 8)) * 2;
  const int p2 = 2 * BK * LDW2 * 2;
  return p1 > p2 ? p1 : p2;
}

template <int FC, bool GATED>
__global__ void __launch_bounds__(THREADS)
fused_mlp_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                 const bf16* __restrict__ wg, const bf16* __restrict__ w2,
                 const bf16* __restrict__ b1, float* __restrict__ part, int M,
                 int K, int F, int N, int BF, int act_kind) {
  constexpr int LDW = FC + 8;
  constexpr int NI1 = FC / 16;  // n8 tiles per warp in phase 1 (16 x FC/2)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LDH = BF + 8;
  bf16* Hs = reinterpret_cast<bf16*>(smem_raw);
  unsigned char* stage = smem_raw + BM * LDH * 2;
  bf16* Xs = reinterpret_cast<bf16*>(stage);     // [2][BM * LDX]
  bf16* W1s = Xs + 2 * BM * LDX;                 // [2][BK * LDW]
  bf16* WGs = W1s + 2 * BK * LDW;                // [2][BK * LDW]
  bf16* W2s = reinterpret_cast<bf16*>(stage);    // [2][BK * LDW2]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * BM, split = blockIdx.y, f_base = split * BF;

  // ---- phase 1: h = act(x @ w1[:, slice] + b1) [* x @ wg[:, slice]] ----
  const int wm1 = warp / 2, wn1 = warp % 2;  // 4 x 2 warps, 16 x FC/2 each
  const int ktiles = (K + BK - 1) / BK;
  for (int fc0 = 0; fc0 < BF; fc0 += FC) {
    auto load = [&](int kt, int st) {
      const int k0 = kt * BK;
      {  // x tile: 64 x 32 = 256 chunks
        const int r = tid / (BK / 8), cc = (tid % (BK / 8)) * 8;
        const int gr = m0 + r, gc = k0 + cc;
        rt::load_chunk(Xs + st * BM * LDX + r * LDX + cc,
                       x + (size_t)gr * K + gc, gr < M ? K - gc : 0, true, x);
      }
      for (int c = tid; c < BK * FC / 8; c += THREADS) {
        const int r = c / (FC / 8), cc = (c % (FC / 8)) * 8;
        const int gr = k0 + r, gc = f_base + fc0 + cc;
        const size_t off = (size_t)gr * F + gc;
        rt::load_chunk(W1s + st * BK * LDW + r * LDW + cc, w1 + off,
                       gr < K ? 8 : 0, true, w1);
        if (GATED)
          rt::load_chunk(WGs + st * BK * LDW + r * LDW + cc, wg + off,
                         gr < K ? 8 : 0, true, wg);
      }
    };
    float a1[NI1][4], ag[NI1][4];
#pragma unroll
    for (int j = 0; j < NI1; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) a1[j][e] = ag[j][e] = 0.f;

    load(0, 0);
    rt::cp_async_commit();
    for (int kt = 0; kt < ktiles; ++kt) {
      if (kt + 1 < ktiles) load(kt + 1, (kt + 1) & 1);
      rt::cp_async_commit();
      rt::cp_async_wait<1>();
      __syncthreads();
      const bf16* xt = Xs + (kt & 1) * BM * LDX;
      const bf16* w1t = W1s + (kt & 1) * BK * LDW;
      const bf16* wgt = WGs + (kt & 1) * BK * LDW;
#pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
        uint32_t a[4];
        rt::load_a(a, xt, LDX, wm1 * 16, ks, lane);
#pragma unroll
        for (int j = 0; j < NI1; j += 2) {
          uint32_t bb[4];
          rt::load_b_kn(bb, w1t, LDW, ks, wn1 * (FC / 2) + j * 8, lane);
          rt::mma16816(a1[j], a, bb[0], bb[1]);
          rt::mma16816(a1[j + 1], a, bb[2], bb[3]);
          if (GATED) {
            rt::load_b_kn(bb, wgt, LDW, ks, wn1 * (FC / 2) + j * 8, lane);
            rt::mma16816(ag[j], a, bb[0], bb[1]);
            rt::mma16816(ag[j + 1], a, bb[2], bb[3]);
          }
        }
      }
      __syncthreads();
    }
    // epilogue: bias + activation (+ gate) in fp32, rounded to bf16 into Hs
#pragma unroll
    for (int j = 0; j < NI1; ++j) {
      const int col = fc0 + wn1 * (FC / 2) + j * 8 + 2 * t;
      const float bias0 =
          b1 ? __bfloat162float(b1[f_base + col]) : 0.f;
      const float bias1 =
          b1 ? __bfloat162float(b1[f_base + col + 1]) : 0.f;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = wm1 * 16 + g + hr * 8;
        float h0 = rt::act(a1[j][2 * hr] + bias0, act_kind);
        float h1 = rt::act(a1[j][2 * hr + 1] + bias1, act_kind);
        if (GATED) {
          h0 *= ag[j][2 * hr];
          h1 *= ag[j][2 * hr + 1];
        }
        *reinterpret_cast<__nv_bfloat162*>(Hs + r * LDH + col) =
            __floats2bfloat162_rn(h0, h1);
      }
    }
  }
  rt::cp_async_wait<0>();
  __syncthreads();

  // ---- phase 2: part[split] = h @ w2[slice, :], 128 columns at a time ----
  const int wm2 = warp / 4, wn2 = warp % 4;  // 2 x 4 warps, 32 x 32 each
  const int ftiles = BF / BK;
  for (int n0 = 0; n0 < N; n0 += BN) {
    auto load = [&](int kt, int st) {
      for (int c = tid; c < BK * BN / 8; c += THREADS) {
        const int r = c / (BN / 8), cc = (c % (BN / 8)) * 8;
        const int gr = f_base + kt * BK + r, gc = n0 + cc;
        rt::load_chunk(W2s + st * BK * LDW2 + r * LDW2 + cc,
                       w2 + (size_t)gr * N + gc, N - gc, true, w2);
      }
    };
    float acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    load(0, 0);
    rt::cp_async_commit();
    for (int kt = 0; kt < ftiles; ++kt) {
      if (kt + 1 < ftiles) load(kt + 1, (kt + 1) & 1);
      rt::cp_async_commit();
      rt::cp_async_wait<1>();
      __syncthreads();
      const bf16* w2t = W2s + (kt & 1) * BK * LDW2;
#pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          rt::load_a(a[i], Hs, LDH, wm2 * 32 + i * 16, kt * BK + ks, lane);
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
          uint32_t bb[4];
          rt::load_b_kn(bb, w2t, LDW2, ks, wn2 * 32 + j * 8, lane);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            rt::mma16816(acc[i][j], a[i], bb[0], bb[1]);
            rt::mma16816(acc[i][j + 1], a[i], bb[2], bb[3]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = m0 + wm2 * 32 + i * 16 + g + hr * 8;
          const int c = n0 + wn2 * 32 + j * 8 + 2 * t;
          if (r < M && c < N)
            *reinterpret_cast<float2*>(part + ((size_t)split * M + r) * N +
                                       c) =
                make_float2(acc[i][j][2 * hr], acc[i][j][2 * hr + 1]);
        }
  }
  rt::cp_async_wait<0>();
}

// y = bf16(sum over splits of part + b2), the sum and the bias in fp32
__global__ void reduce_kernel(const float* __restrict__ part,
                              const bf16* __restrict__ b2,
                              bf16* __restrict__ y, int M, int N, int S) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)M * N;
  if (idx >= total) return;
  float s = 0.f;
  for (int i = 0; i < S; ++i) s += part[(size_t)i * total + idx];
  if (b2) s += __bfloat162float(b2[idx % N]);
  y[idx] = __float2bfloat16(s);
}

template <int FC, bool GATED>
int launch_main(const bf16* x, const bf16* w1, const bf16* wg, const bf16* w2,
                const bf16* b1, float* part, int M, int K, int F, int N,
                int BF, int act_kind, cudaStream_t stream) {
  const int smem = BM * (BF + 8) * 2 + stage_bytes(FC);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel<FC, GATED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + BM - 1) / BM, F / BF);
  fused_mlp_kernel<FC, GATED><<<grid, THREADS, smem, stream>>>(
      x, w1, wg, w2, b1, part, M, K, F, N, BF, act_kind);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rt_fused_mlp_smem_bytes(int BF) {
  return BM * (BF + 8) * 2 + stage_bytes(BF % 128 == 0 ? 128 : 64);
}

// Blocks of the kernel at F slice BF one SM holds at once, by the CUDA
// runtime's occupancy calculator (a negative cudaError_t on failure).
extern "C" int rt_fused_mlp_blocks_per_sm(int BF, int gated) {
  const int smem = rt_fused_mlp_smem_bytes(BF);
  auto* k = BF % 128 == 0
                ? (gated ? fused_mlp_kernel<128, true> : fused_mlp_kernel<128, false>)
                : (gated ? fused_mlp_kernel<64, true> : fused_mlp_kernel<64, false>);
  int n = 0;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, THREADS, smem);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

extern "C" int rt_fused_mlp(const void* x, const void* w1, const void* wg,
                            const void* w2, const void* b1, const void* b2,
                            void* part, void* y, int M, int K, int F, int N,
                            int BF, int act_kind, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* xx = static_cast<const bf16*>(x);
  auto* ww1 = static_cast<const bf16*>(w1);
  auto* wwg = static_cast<const bf16*>(wg);
  auto* ww2 = static_cast<const bf16*>(w2);
  auto* bb1 = static_cast<const bf16*>(b1);
  auto* pp = static_cast<float*>(part);
  if (BF <= 0 || BF % 64 != 0 || F % BF != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int err;
  if (BF % 128 == 0)
    err = wg ? launch_main<128, true>(xx, ww1, wwg, ww2, bb1, pp, M, K, F, N,
                                      BF, act_kind, s)
             : launch_main<128, false>(xx, ww1, wwg, ww2, bb1, pp, M, K, F, N,
                                       BF, act_kind, s);
  else
    err = wg ? launch_main<64, true>(xx, ww1, wwg, ww2, bb1, pp, M, K, F, N,
                                     BF, act_kind, s)
             : launch_main<64, false>(xx, ww1, wwg, ww2, bb1, pp, M, K, F, N,
                                      BF, act_kind, s);
  if (err != 0) return err;
  const size_t total = (size_t)M * N;
  const int threads = 256;
  reduce_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                  s>>>(pp, static_cast<const bf16*>(b2),
                       static_cast<bf16*>(y), M, N, F / BF);
  return static_cast<int>(cudaGetLastError());
}

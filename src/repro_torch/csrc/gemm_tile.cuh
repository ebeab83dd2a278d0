// The tile loops shared by the GEMM kernels (gemm.cu, gemm_act.cu).
//
// A kernel is ``gemm_kernel<Loop>`` (or ``gemm_act_kernel<Loop>``): one of
// the loops below, handed the kernel's own epilogue.  Every loop stores
// bf16(act(sum + b[c])), all in fp32 up to that one rounding, b optional
// (gemm has none); ``Epi::with(p, f)`` calls f once with the activation
// functor ``act(v)``, picked once, outside the unrolled store, so that the
// store holds one activation's code and not a switch over all of them per
// element.  The TMA loop reads a thread's bias a column pair at a time,
// all pairs before the store, once for the two rows it holds at each.
// Which loop runs, and with which tile width, split and grid, is decided
// on the host from shape and alignment alone (kernels/gemm.py:schedule)
// and handed to ``launch`` below.
//
// TmaLoop<BN>, for K and N multiples of 8 and 16-byte-aligned operands
// (what a TMA tensor map takes).  A persistent, warp-specialised loop:
// min(units, SMs) blocks of three warpgroups walk 128 x BN output tiles
// (BN = 128 or 256), grouped along M (GROUP_M tiles) so that blocks that
// run together share w's panels in L2.  Warpgroup 0 is the producer: one
// thread issues TMA loads of x (128 x 64, K-major) and w (64 x BN as
// BN / 64 boxes of 64 x 64, N-major) into a ring of 192 KB of shared
// memory with the 128-byte swizzle (6 stages at BN = 128, 4 at 256), each
// stage with a "full" mbarrier (TMA bytes landed) and an "empty" one (its
// consumers done).  Warpgroups 1 and 2 are the consumers, 64 rows of the
// tile each, on wgmma m64nBNk16 (bf16 in, fp32 accumulators in registers,
// w read through the descriptor's transpose bit, so the weights keep the
// reference's (K, N) layout); setmaxnreg moves registers from the
// producer (40) to them (232).  One k step's products stay in flight
// while the next step's are issued; a stage is released when its
// products are done.  The producer runs ahead into the next tile's
// loads while the consumers store this one.  TMA zero-fills rows and
// columns past M, N and K, so ragged edges need no masking until the
// store.
// Split-K (p.split > 1): a unit is a tile and one of ``split`` contiguous
// ranges of its k steps; each unit writes its fp32 partial sums to
// ws[split, M, N], and Reduce sums them in a fixed order and applies the
// epilogue to the whole sum: deterministic, no atomics.
//
// SyncLoop, for everything else (K or N not a multiple of 8, or an
// operand not 16-byte aligned): one 128 x 128 tile per block of 8 warps,
// each warp a 64 x 32 sub-tile of mma.sync m16n8k16 accumulators, K in
// steps of 32 through two shared-memory stages, operands loaded element by
// element with the ragged edges zero-filled.
#pragma once

#include "hopper.cuh"

namespace rt::gemm_tile {

constexpr int BM = 128, BK = 64;  // TMA route: tile rows, k step
constexpr int GROUP_M = 8;        // tiles along M walked before N moves
constexpr int RING_BYTES = 192 * 1024;
constexpr int BAR_BYTES = 256;    // the full and empty mbarriers
// dynamic shared memory of the TMA route: the ring, its barriers, and the
// slack to align the ring to the 128-byte swizzle's 1024-byte pattern
constexpr int SMEM_BYTES = RING_BYTES + BAR_BYTES + 1024;

// Everything a loop reads: the TMA descriptors (TMA route), the raw
// pointers, and the shape; ``bias`` and ``act`` are read only by
// gemm_act's epilogue, ``ws`` only with split > 1.
struct Params {
  CUtensorMap a, b;  // x (M x K) and w (K x N), bf16, 128-byte swizzle
  const bf16* x;
  const bf16* w;
  const bf16* bias;
  bf16* y;
  float* ws;
  int M, N, K, act, split;
};

__host__ __device__ constexpr int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// b[c] (0 without a bias), through the read-only path: its loads need not
// wait for the stores to y before them
__device__ __forceinline__ float bias_at(const Params& p, int c) {
  return p.bias ? __bfloat162float(__ldg(p.bias + c)) : 0.f;
}

// (b[c], b[c + 1]) for an even c < N - 1 (zeros without a bias): one
// 4-byte load where b is 4-byte aligned
__device__ __forceinline__ __nv_bfloat162 bias_pair(const Params& p, int c) {
  if (!p.bias) return __floats2bfloat162_rn(0.f, 0.f);
  if ((reinterpret_cast<uintptr_t>(p.bias) & 3) == 0)
    return __ldg(reinterpret_cast<const __nv_bfloat162*>(p.bias + c));
  return __halves2bfloat162(__ldg(p.bias + c), __ldg(p.bias + c + 1));
}

// ---------------------------------------------------------------------------
// TMA + wgmma, persistent, warp-specialised, optionally split along K
// ---------------------------------------------------------------------------

// One unit of work: an output tile and the k steps [kb, ke) it sums.
struct Unit {
  int m0, n0, s, kb, ke;
};

// Unit u of tiles_m * tiles_n * split: the split index outermost, then
// tiles in groups of GROUP_M rows, M fastest inside a group, so that the
// blocks running together read few of w's column panels.  The k steps
// are cut evenly: range s is [s * kt / split, (s + 1) * kt / split).
template <int BN>
__device__ __forceinline__ Unit unit_of(int u, int tiles_m, int tiles_n,
                                        int split, int kt) {
  const int tiles = tiles_m * tiles_n;
  const int s = u / tiles, t = u % tiles;
  const int per_group = GROUP_M * tiles_n;
  const int first_m = t / per_group * GROUP_M;
  const int rows = min(tiles_m - first_m, GROUP_M);
  const int in = t % per_group;
  return {(first_m + in % rows) * BM, in / rows * BN, s, s * kt / split,
          (s + 1) * kt / split};
}

template <int BN>
struct TmaLoop {
  static constexpr int kThreads = 384;  // producer + two consumer groups
  static constexpr int kMinBlocks = 1;
  static constexpr int A_BYTES = BM * BK * 2;  // 16 KB
  static constexpr int B_BYTES = BK * BN * 2;  // BN / 64 boxes of 8 KB
  static constexpr int BOX_BYTES = BK * 64 * 2;
  static constexpr int STAGES = RING_BYTES / (A_BYTES + B_BYTES);
  static_assert(STAGES * (A_BYTES + B_BYTES) == RING_BYTES, "ring");
  static_assert(2 * STAGES * 8 <= BAR_BYTES, "barriers");

  template <class Epi>
  __device__ static void run(const Params& p) {
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem =
        smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
    uint8_t* As = smem;
    uint8_t* Bs = smem + STAGES * A_BYTES;
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + RING_BYTES);
    uint64_t* empty = full + STAGES;

    const int tiles_m = cdiv(p.M, BM), tiles_n = cdiv(p.N, BN);
    const int units = tiles_m * tiles_n * p.split;
    const int kt = cdiv(p.K, BK);

    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(&full[s], 1);   // the producer's expect_tx
        mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
      }
      mbar_init_fence();
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == 0) {
      // ---- producer: one thread keeps the ring full ------------------
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
      if (threadIdx.x == 0) {
        int stage = 0;
        uint32_t phase = 0;
        for (int u = blockIdx.x; u < units; u += gridDim.x) {
          const Unit t = unit_of<BN>(u, tiles_m, tiles_n, p.split, kt);
          for (int k = t.kb; k < t.ke; ++k) {
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_expect_tx(&full[stage], A_BYTES + B_BYTES);
            tma_load(As + stage * A_BYTES, &p.a, k * BK, t.m0, &full[stage]);
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              tma_load(Bs + stage * B_BYTES + j * BOX_BYTES, &p.b,
                       t.n0 + 64 * j, k * BK, &full[stage]);
            if (++stage == STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    } else {
      // ---- consumers: rows [64 (wg - 1), 64 wg) of each tile ----------
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
      const int cw = wg - 1, warp = threadIdx.x / 32 % 4,
                lane = threadIdx.x % 32;
      const bool signal = threadIdx.x % 128 == 0;
      int stage = 0;
      uint32_t phase = 0;
      float acc[BN / 2];
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit t = unit_of<BN>(u, tiles_m, tiles_n, p.split, kt);
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
        int prev = -1;
        for (int k = t.kb; k < t.ke; ++k) {
          mbar_wait(&full[stage], phase);
          wgmma_fence();
          // x: rows 128 bytes apart, 8-row swizzle atoms 1024 apart; a
          // k16 slice is 32 bytes further along the row.  w: 64-column
          // boxes BOX_BYTES apart (leading offset), 8-row atoms 1024
          // apart (stride offset); a k16 slice is 16 rows further.
          const uint8_t* a = As + stage * A_BYTES + cw * 64 * 128;
          const uint8_t* b = Bs + stage * B_BYTES;
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            Wgmma<BN, 1>::ss(acc, desc(a + kk * 32, 16, 1024),
                             desc(b + kk * 16 * 128, BOX_BYTES, 1024), 1);
          wgmma_commit();
          wgmma_wait<1>();  // the step before is done: free its stage
          if (prev >= 0 && signal) mbar_arrive(&empty[prev]);
          prev = stage;
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
        wgmma_wait<0>();
        if (prev >= 0 && signal) mbar_arrive(&empty[prev]);

        // accumulator layout: warp w of the group holds rows 16w + g and
        // 16w + g + 8 (g = lane / 4); acc[4j + 2h + e] is column
        // 8j + 2 (lane % 4) + e of row 16w + g + 8h
        const int r0 = t.m0 + cw * 64 + warp * 16 + (lane >> 2);
        const int c0 = t.n0 + 2 * (lane & 3);
        if (p.split > 1) {
          float* ws = p.ws + static_cast<size_t>(t.s) * p.M * p.N;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int c = c0 + 8 * j;
            if (c >= p.N) continue;  // N is even: c + 1 < N as well
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = r0 + 8 * h;
              if (r >= p.M) continue;
              *reinterpret_cast<float2*>(ws + static_cast<size_t>(r) * p.N +
                                         c) =
                  make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
            }
          }
        } else {
          // the bias of every column pair first, all loads in flight at
          // once (a column past N reads column N - 2 and is not stored)
          __nv_bfloat162 bias[BN / 8];
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
            bias[j] = bias_pair(p, min(c0 + 8 * j, p.N - 2));
          Epi::with(p, [&](auto act) {
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
              const int c = c0 + 8 * j;
              if (c >= p.N) continue;
              const float2 b = __bfloat1622float2(bias[j]);
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int r = r0 + 8 * h;
                if (r >= p.M) continue;
                *reinterpret_cast<__nv_bfloat162*>(
                    p.y + static_cast<size_t>(r) * p.N + c) =
                    __floats2bfloat162_rn(act(acc[4 * j + 2 * h] + b.x),
                                          act(acc[4 * j + 2 * h + 1] + b.y));
              }
            }
          });
        }
      }
    }
  }
};

// y = bf16(act(sum over s of ws[s] + b)), four columns a thread, the
// partials summed in the order of s.
struct Reduce {
  static constexpr int kThreads = 256, kMinBlocks = 1;

  template <class Epi>
  __device__ static void run(const Params& p) {
    const size_t mn = static_cast<size_t>(p.M) * p.N;
    const size_t e =
        (static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x) * 4;
    if (e >= mn) return;
    float4 v = *reinterpret_cast<const float4*>(p.ws + e);
    for (int s = 1; s < p.split; ++s) {
      const float4 w = *reinterpret_cast<const float4*>(p.ws + s * mn + e);
      v.x += w.x;
      v.y += w.y;
      v.z += w.z;
      v.w += w.w;
    }
    const int c = static_cast<int>(e % p.N);
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(p.y + e);
    const float2 b0 = __bfloat1622float2(bias_pair(p, c)),
                 b1 = __bfloat1622float2(bias_pair(p, c + 2));
    Epi::with(p, [&](auto act) {
      dst[0] = __floats2bfloat162_rn(act(v.x + b0.x), act(v.y + b0.y));
      dst[1] = __floats2bfloat162_rn(act(v.z + b1.x), act(v.w + b1.y));
    });
  }
};

// ---------------------------------------------------------------------------
// mma.sync, for operands TMA cannot take
// ---------------------------------------------------------------------------

struct SyncLoop {
  static constexpr int kThreads = 256;  // 8 warps: 2 along M x 4 along N
  static constexpr int kMinBlocks = 2;  // at most 128 registers
  static constexpr int SBN = 128, SBK = 32;
  static constexpr int WM = 64, WN = 32;  // warp tile
  static constexpr int MI = WM / 16, NI = WN / 8;
  static constexpr int LDA = SBK + 8, LDB = SBN + 8;

  struct Smem {
    __align__(16) bf16 As[2][BM * LDA];
    __align__(16) bf16 Bs[2][SBK * LDB];
  };

  template <class Epi>
  __device__ static void run(const Params& p) {
    __shared__ Smem sm;
    const int tiles_n = cdiv(p.N, SBN);
    const int m0 = blockIdx.x / tiles_n * BM, n0 = blockIdx.x % tiles_n * SBN;
    const int M = p.M, N = p.N, K = p.K;
    const bf16* __restrict__ x = p.x;
    const bf16* __restrict__ w = p.w;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp / 4, wn = warp % 4;

    auto load = [&](int kt, int st) {
      const int k0 = kt * SBK;
      // A tile: BM rows x SBK cols = 512 chunks of 8
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = tid + i * kThreads;
        const int r = c / (SBK / 8), cc = (c % (SBK / 8)) * 8;
        const int gr = m0 + r, gc = k0 + cc;
        const int valid = gr < M ? K - gc : 0;
        load_chunk(&sm.As[st][r * LDA + cc], x + (size_t)gr * K + gc, valid,
                   false, x);
      }
      // B tile: SBK rows x SBN cols = 512 chunks of 8
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = tid + i * kThreads;
        const int r = c / (SBN / 8), cc = (c % (SBN / 8)) * 8;
        const int gr = k0 + r, gc = n0 + cc;
        const int valid = gr < K ? N - gc : 0;
        load_chunk(&sm.Bs[st][r * LDB + cc], w + (size_t)gr * N + gc, valid,
                   false, w);
      }
    };

    float acc[MI][NI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    const int ktiles = cdiv(K, SBK);
    load(0, 0);
    for (int kt = 0; kt < ktiles; ++kt) {
      if (kt + 1 < ktiles) load(kt + 1, (kt + 1) & 1);
      __syncthreads();
      const bf16* a_t = sm.As[kt & 1];
      const bf16* b_t = sm.Bs[kt & 1];
#pragma unroll
      for (int ks = 0; ks < SBK; ks += 16) {
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

    // y[r, c] = bf16(act(acc element + b[c])) for the in-range elements
    const int g = lane >> 2, t = lane & 3;
    Epi::with(p, [&](auto act) {
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = m0 + wm * WM + i * 16 + g + h * 8;
            const int c = n0 + wn * WN + j * 8 + 2 * t;
            if (r >= M) continue;
            bf16* dst = p.y + (size_t)r * N + c;
            const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
            if (c + 1 < N && (N & 1) == 0) {
              *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(
                  act(v0 + bias_at(p, c)), act(v1 + bias_at(p, c + 1)));
            } else {
              if (c < N) dst[0] = __float2bfloat16(act(v0 + bias_at(p, c)));
              if (c + 1 < N)
                dst[1] = __float2bfloat16(act(v1 + bias_at(p, c + 1)));
            }
          }
    });
  }
};

// ---------------------------------------------------------------------------
// host side: the launch (the tensor maps come from hopper.cuh)
// ---------------------------------------------------------------------------

// One kernel's instantiations, one for each loop.
using KernelFn = void (*)(Params);
struct Kernels {
  KernelFn tma128, tma256, sync, reduce;
};

// Launch on ``stream`` what kernels/gemm.py:schedule chose: ``tma`` (the
// TMA route, else mma.sync), the tile width ``bn``, ``p.split`` and the
// grid.  Returns the first cudaError_t; a tensor map the driver refuses
// returns 1000 + its CUresult.
inline int launch(const Kernels& k, Params p, int tma, int bn, int grid,
                  cudaStream_t stream) {
  void* args[] = {&p};
  if (!tma) {
    return static_cast<int>(cudaLaunchKernel(
        reinterpret_cast<const void*>(k.sync), dim3(grid),
        dim3(SyncLoop::kThreads), args, 0, stream));
  }
  const Encode enc = encode_fn();
  if (!enc) return static_cast<int>(cudaErrorSymbolNotFound);
  CUresult cr = make_map(enc, &p.a, p.x, p.M, p.K, BM);
  if (cr == CUDA_SUCCESS) cr = make_map(enc, &p.b, p.w, p.K, p.N, BK);
  if (cr != CUDA_SUCCESS) return 1000 + static_cast<int>(cr);
  const void* fn = reinterpret_cast<const void*>(bn == 256 ? k.tma256
                                                           : k.tma128);
  cudaError_t rc = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (rc == cudaSuccess)
    rc = cudaLaunchKernel(fn, dim3(grid), dim3(384), args, SMEM_BYTES,
                          stream);
  if (rc != cudaSuccess || p.split == 1) return static_cast<int>(rc);
  const size_t quads = static_cast<size_t>(p.M) * p.N / 4;
  return static_cast<int>(cudaLaunchKernel(
      reinterpret_cast<const void*>(k.reduce),
      dim3(static_cast<unsigned>((quads + Reduce::kThreads - 1) /
                                 Reduce::kThreads)),
      dim3(Reduce::kThreads), args, 0, stream));
}

}  // namespace rt::gemm_tile

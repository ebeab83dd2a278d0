// Stabilised mLSTM matrix-memory recurrence (xLSTM), per (batch, head).
//
// Replaces the TPU kernel repro/kernels/mlstm.py:mlstm_scan and computes
// what it computes, from C = 0, n = 0, m = 0:
//
//   m_t = max(log sigma(f_t) + m_{t-1}, i_t)
//   i'_t = exp(i_t - m_t),  f'_t = exp(log sigma(f_t) + m_{t-1} - m_t)
//   C_t = f'_t C_{t-1} + i'_t v_t k_t^T,   n_t = f'_t n_{t-1} + i'_t k_t
//   h_t = C_t q~_t / max(|n_t . q~_t|, exp(-m_t)),   q~_t = q_t Dh^-0.5
//
// with C, n, m and every product in fp32, h_t rounded once to bf16, and
// (optionally) the final C (Dh x Dh), n (Dh) and m written out in fp32:
// the state serving's prefill hands to the decode steps, which the TPU
// kernel does not return.
//
// Bound on an H100: 5 (Dh^2 + Dh) fp32 operations a step and head (three
// for each element of C's update, two for C q~, the same for n), against
// 8 Dh bytes of q, k, v and h; at Dh = 1024 that is 640 operations a byte,
// so fp32 arithmetic bounds it: 0.64 ms at B = 1, H = 4, T = 2048 at
// 67 TFLOP/s.
//
// Design.  The TPU kernel keeps one head's C (4 MiB at Dh = 1024) in VMEM
// for the whole sequence; a Hopper block has 227 KB of shared memory.  But
// row i of C depends only on v_t[i], k_t, q_t and the scalar gates, so the
// rows split across blocks that never talk to each other: block x owns
// rows [32x, 32x + 32) of one head's C, each of its eight warps four of
// them, and each lane those rows' Dh / 32 columns in registers (lane l
// holds columns 128c + 4l .. 128c + 4l + 3), beside the same columns of n.
// Every warp carries all of n and m itself (Dh and one value, against
// 4 Dh of C), so no warp waits on another within a step: C q~ and n . q~
// are reduced with warp shuffles and the warp's lanes 0..3 store its four
// h values.  The gates are computed identically by every warp.  Time is
// staged through shared memory in chunks of TC steps: a cp.async ring of
// STAGES chunks of bf16 q and k rows, the block's 32 rows of v and the two
// gates, converted once per chunk into fp32 (q scaled by Dh^-0.5, log
// sigma(f) computed) so the step loop reads 16-byte fp32 vectors.  Grid:
// (Dh / 32, B * H); at B = 1, H = 4, Dh = 1024 that is 128 blocks of 256
// threads, one per SM.  Any T (a ragged last chunk is cut), any Dh that is
// a multiple of 32 up to 1024: the register tile is 32 NC columns wide,
// NC a power of two, and columns past Dh hold zeros in q~ and k, so they
// stay zero in C and n and add nothing to the sums.  Steps whose gates are
// i = -inf, f = +inf (a bucket's padding) carry C, n and m exactly:
// i' = 0, f' = 1.  Every lane keeps 4 NC + NC state registers; at NC = 32
// that is 160 of the 255 ptxas gives it, so one 256-thread block fills an
// SM's register file.
#include "common.cuh"

#include <math.h>

namespace {

using rt::bf16;

constexpr int R = 4;             // rows of C per warp
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = R * WARPS;  // rows of C per block
constexpr int TC = 8;            // time steps per staged chunk
constexpr int STAGES = 3;        // chunks in the cp.async ring

// bytes of dynamic shared memory for head dim ``dh`` and a register tile
// ``dp`` columns wide
size_t smem_bytes(int dh, int dp) {
  const size_t staging = (size_t)STAGES * TC * (2 * dh + ROWS) * 2;
  const size_t gates = (size_t)STAGES * 2 * TC * 4;
  const size_t converted = (size_t)TC * (2 * dp + ROWS + 2) * 4;
  return staging + gates + converted;
}

// 4-byte asynchronous copy global -> shared, zero-filled when !pred
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   rt::smem_addr(dst)),
               "l"(src), "r"(n));
}

// log sigma(x) = -softplus(-x), stable for either sign; 0 at x = +inf
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float bf_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

template <int NC>
__global__ void __launch_bounds__(THREADS, 1)
mlstm_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const float* __restrict__ ig,
             const float* __restrict__ fg, bf16* __restrict__ h,
             float* __restrict__ c_out, float* __restrict__ n_out,
             float* __restrict__ m_out, int T, int Dh, float scale) {
  constexpr int DP = 32 * NC;  // columns of the register tile
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);            // [STAGES][TC][Dh]
  bf16* sk = sq + (size_t)STAGES * TC * Dh;            // [STAGES][TC][Dh]
  bf16* sv = sk + (size_t)STAGES * TC * Dh;            // [STAGES][TC][ROWS]
  float* sg = reinterpret_cast<float*>(sv + STAGES * TC * ROWS);
  //                                                      [STAGES][2][TC]
  float* fq = sg + STAGES * 2 * TC;                    // [TC][DP] q~
  float* fk = fq + TC * DP;                            // [TC][DP] k
  float* fv = fk + TC * DP;                            // [TC][ROWS] v
  float* fi = fv + TC * ROWS;                          // [TC] i
  float* flf = fi + TC;                                // [TC] log sigma(f)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * ROWS;
  const size_t base = (size_t)bh * T;  // row of (bh, t = 0)
  const int nchunks = (T + TC - 1) / TC;
  const int cpr = Dh / 8;              // 16-byte chunks in a q or k row

  auto load = [&](int chunk, int st) {
    const int t0 = chunk * TC;
    for (int i = tid; i < TC * cpr; i += THREADS) {
      const int r = i / cpr, cc = (i % cpr) * 8;
      const bool ok = t0 + r < T;
      const size_t off = (base + (ok ? t0 + r : 0)) * Dh + cc;
      const size_t dst = ((size_t)st * TC + r) * Dh + cc;
      rt::cp_async16(sq + dst, q + off, ok);
      rt::cp_async16(sk + dst, k + off, ok);
    }
    constexpr int VCH = ROWS / 8;      // 16-byte chunks of the block's v
    if (tid < TC * VCH) {
      const int r = tid / VCH, cc = (tid % VCH) * 8;
      const bool ok = t0 + r < T;
      rt::cp_async16(sv + (st * TC + r) * ROWS + cc,
                     v + (base + (ok ? t0 + r : 0)) * Dh + row0 + cc, ok);
    } else if (tid < TC * VCH + 2 * TC) {
      const int j = tid - TC * VCH, g = j / TC, r = j % TC;
      const bool ok = t0 + r < T;
      cp_async4(sg + (st * 2 + g) * TC + r,
                (g ? fg : ig) + base + (ok ? t0 + r : 0), ok);
    }
  };

  // columns past Dh stay zero in q~ and k for the whole run
  for (int i = tid; i < TC * (DP - Dh); i += THREADS) {
    const int r = i / (DP - Dh), c = Dh + i % (DP - Dh);
    fq[r * DP + c] = 0.f;
    fk[r * DP + c] = 0.f;
  }

  float C[R][NC], n[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    n[c] = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) C[r][c] = 0.f;
  }
  float m = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nchunks) load(s, s);
    rt::cp_async_commit();
  }
  for (int kc = 0; kc < nchunks; ++kc) {
    rt::cp_async_wait<STAGES - 2>();  // chunk kc has landed
    __syncthreads();                  // ... for all; every warp done with f*
    const int next = kc + STAGES - 1;
    if (next < nchunks) load(next, next % STAGES);
    rt::cp_async_commit();
    const int st = kc % STAGES;

    // convert the chunk to fp32 once, for every warp's step loop
    for (int i = tid; i < TC * cpr; i += THREADS) {
      const int r = i / cpr, cc = (i % cpr) * 8;
      const size_t src = ((size_t)st * TC + r) * Dh + cc;
      const uint4 qa = *reinterpret_cast<const uint4*>(sq + src);
      const uint4 ka = *reinterpret_cast<const uint4*>(sk + src);
      float4* dq = reinterpret_cast<float4*>(fq + r * DP + cc);
      float4* dk = reinterpret_cast<float4*>(fk + r * DP + cc);
      dq[0] = make_float4(bf_lo(qa.x) * scale, bf_hi(qa.x) * scale,
                          bf_lo(qa.y) * scale, bf_hi(qa.y) * scale);
      dq[1] = make_float4(bf_lo(qa.z) * scale, bf_hi(qa.z) * scale,
                          bf_lo(qa.w) * scale, bf_hi(qa.w) * scale);
      dk[0] = make_float4(bf_lo(ka.x), bf_hi(ka.x), bf_lo(ka.y),
                          bf_hi(ka.y));
      dk[1] = make_float4(bf_lo(ka.z), bf_hi(ka.z), bf_lo(ka.w),
                          bf_hi(ka.w));
    }
    for (int i = tid; i < TC * ROWS; i += THREADS)
      fv[i] = __bfloat162float(sv[st * TC * ROWS + i]);
    if (tid < TC) {
      fi[tid] = sg[(st * 2) * TC + tid];
      flf[tid] = log_sigmoid(sg[(st * 2 + 1) * TC + tid]);
    }
    __syncthreads();

    const int tn = min(TC, T - kc * TC);
    for (int s = 0; s < tn; ++s) {
      const float it = fi[s], lf = flf[s];
      const float m_new = fmaxf(lf + m, it);
      const float ip = expf(it - m_new);
      const float fp = expf(lf + m - m_new);
      const float floor_den = expf(-m_new);
      m = m_new;
      float a[R], acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        a[r] = ip * fv[s * ROWS + warp * R + r];
        acc[r] = 0.f;
      }
      float accn = 0.f;
      const float* qs = fq + s * DP;
      const float* ks = fk + s * DP;
#pragma unroll
      for (int c4 = 0; c4 < NC / 4; ++c4) {
        const float4 kv = *reinterpret_cast<const float4*>(
            ks + c4 * 128 + 4 * lane);
        const float4 qv = *reinterpret_cast<const float4*>(
            qs + c4 * 128 + 4 * lane);
        const float kk[4] = {kv.x, kv.y, kv.z, kv.w};
        const float qq[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 4 * c4 + e;
          n[c] = fmaf(fp, n[c], ip * kk[e]);
          accn = fmaf(n[c], qq[e], accn);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            C[r][c] = fmaf(fp, C[r][c], a[r] * kk[e]);
            acc[r] = fmaf(C[r][c], qq[e], acc[r]);
          }
        }
      }
      // butterfly sums: every lane ends with the same bits
#pragma unroll
      for (int o = 16; o; o >>= 1) {
        accn += __shfl_xor_sync(0xffffffffu, accn, o);
#pragma unroll
        for (int r = 0; r < R; ++r)
          acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], o);
      }
      const float den = fmaxf(fabsf(accn), floor_den);
      float mine = acc[0];
#pragma unroll
      for (int r = 1; r < R; ++r)
        if (lane == r) mine = acc[r];
      if (lane < R)
        h[(base + kc * TC + s) * Dh + row0 + warp * R + lane] =
            __float2bfloat16(mine / den);
    }
  }
  rt::cp_async_wait<0>();

  if (c_out != nullptr) {
    float* crow = c_out + ((size_t)bh * Dh + row0 + warp * R) * Dh;
#pragma unroll
    for (int c4 = 0; c4 < NC / 4; ++c4) {
      const int j = c4 * 128 + 4 * lane;
      if (j < Dh) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          *reinterpret_cast<float4*>(crow + (size_t)r * Dh + j) =
              make_float4(C[r][4 * c4], C[r][4 * c4 + 1], C[r][4 * c4 + 2],
                          C[r][4 * c4 + 3]);
        if (blockIdx.x == 0 && warp == 0)
          *reinterpret_cast<float4*>(n_out + (size_t)bh * Dh + j) =
              make_float4(n[4 * c4], n[4 * c4 + 1], n[4 * c4 + 2],
                          n[4 * c4 + 3]);
      }
    }
    if (blockIdx.x == 0 && tid == 0) m_out[bh] = m;
  }
}

template <int NC>
int launch(const bf16* q, const bf16* k, const bf16* v, const float* ig,
           const float* fg, bf16* h, float* c, float* n, float* m, int BH,
           int T, int Dh, cudaStream_t s) {
  const size_t smem = smem_bytes(Dh, 32 * NC);
  cudaError_t e = cudaFuncSetAttribute(
      mlstm_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const float scale = static_cast<float>(pow(static_cast<double>(Dh), -0.5));
  const dim3 grid(Dh / ROWS, BH);
  mlstm_kernel<NC><<<grid, THREADS, smem, s>>>(q, k, v, ig, fg, h, c, n, m,
                                               T, Dh, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, h: (B*H, T, Dh) bf16, 16-byte aligned; ig, fg: (B*H, T) fp32.
// c (B*H, Dh, Dh), n (B*H, Dh), m (B*H) fp32: the final state, written
// when c is not null (then n and m must not be null either).
extern "C" int rt_mlstm_scan(const void* q, const void* k, const void* v,
                             const void* ig, const void* fg, void* h,
                             void* c, void* n, void* m, int BH, int T,
                             int Dh, void* stream) {
  if (BH <= 0 || BH > 65535 || T <= 0 || Dh <= 0 || Dh % ROWS ||
      Dh > 1024 || (c != nullptr && (n == nullptr || m == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto* qq = static_cast<const bf16*>(q);
  auto* kk = static_cast<const bf16*>(k);
  auto* vv = static_cast<const bf16*>(v);
  auto* ii = static_cast<const float*>(ig);
  auto* ff = static_cast<const float*>(fg);
  auto* hh = static_cast<bf16*>(h);
  auto* cc = static_cast<float*>(c);
  auto* nn = static_cast<float*>(n);
  auto* mm = static_cast<float*>(m);
  if (Dh <= 128)
    return launch<4>(qq, kk, vv, ii, ff, hh, cc, nn, mm, BH, T, Dh, s);
  if (Dh <= 256)
    return launch<8>(qq, kk, vv, ii, ff, hh, cc, nn, mm, BH, T, Dh, s);
  if (Dh <= 512)
    return launch<16>(qq, kk, vv, ii, ff, hh, cc, nn, mm, BH, T, Dh, s);
  return launch<32>(qq, kk, vv, ii, ff, hh, cc, nn, mm, BH, T, Dh, s);
}

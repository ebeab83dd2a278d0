// The gradient of the stabilised mLSTM scan (mlstm.cu), chunkwise on the
// tensor cores.
//
// Replaces no TPU kernel of its own: the TPU kernel repro/kernels/mlstm.py:
// mlstm_scan has no backward, and jax.grad differentiates the plain
// recurrence.  This computes that gradient for the cotangent dh of h:
// dq, dk, dv (bf16) and the gates' di, df (fp32).
//
// m held constant.  The stabilised state is exp(-m) times the unstabilised
// one, and so is the floor exp(-m), so h does not depend on m: the exact
// gradient is the one with m frozen.  Then, with F_t the cumulative sum of
// log sigma(f), q_t enters only as exp(F_t) q_t and k_s only as
// exp(i_s - F_s) k_s, so di_s = k_s . dk_s and d log sigma(f_r) =
// sum_{t >= r} (q_t . dq_t - k_t . dk_t), df = sigma(-f) d log sigma(f).
//
// Per chunk of L = 64 steps (the forward's), from the training forward's
// saved state X = [C_prev; n_prev] ((Dh + 1) x Dh fp32), m_prev, the fp32 h
// and den with its sign, and the end-of-chunk state gradient G (carried
// from the last chunk back, G = 0 there), with the forward's weights
// recomputed (a_t = b_t - m_t, e_s = i_s - b_s, gq_t = scale exp(b_t +
// m_prev - m_t), D[t,s] = scale exp(a_t + e_s) for s <= t, w_s, g_end):
//   inv = 1/den, dHn = -sign (dh . h)/den (0 where the floor won),
//   gi = gq inv, gn = gq dHn, Pi = (S o D) inv, dS = (inv dh V^T + dHn) o D
//   dQ = gi o (dh X[:Dh]) + gn (x) X[Dh] + dS K
//   dK = w o (V G[:Dh]) + w (x) G[Dh] + dS^T Q
//   dV = w o (K G[:Dh]^T) + Pi^T dh
//   G <- g_end G + [gi o dh | gn]^T Q       (the chunk before's G)
// kernels/mlstm.py:chunkwise_bwd_model computes the same on the CPU.
//
// Precision.  q, k, v and dh are bf16 already and enter the products as
// they are; every fp32 operand (X, G, dS, Pi, gi o dh) enters as a bf16
// pair hi = bf16(x), lo = bf16(x - hi), two products into one fp32
// accumulator, as in the forward.  Rounded once to bf16 instead, the
// gates' gradients miss their tolerance (chunkwise_bwd_model, split=False;
// tests/test_torch_mlstm_grad.py).  The row dots take dq and dk in fp32,
// before their rounding.
//
// Bound: 8 Dh^2 + 10 L Dh tensor-core operations a step and head (the
// function's products, unsplit); at (4, 4, 512, 1024) 0.075 ms at
// 989 TFLOP/s, and reading the saved states once 0.16 ms at 3.35 TB/s.
// This design does more: the pairs double the products, and the state
// gradient G (as large as the saved states) is written once and read
// twice.
//
// Design: four kernels on one stream, no atomics (two launches are
// bit-identical).
// * mlstm_bwd_prep_kernel, one block per (chunk, head): the gate scan (m
//   step by step from the saved m_prev, as the forward), dh . h,
//   S = Q K^T and U = dh V^T (mma.sync over Dh), then Pi, dS and the
//   per-step weights into a scratch.
// * mlstm_bwd_state_kernel, one block per 16 rows of G and head: the
//   chunks from the last back, G's 16 rows x Dh in registers (8 warps,
//   Dh / 8 columns each), the chunk's Q in shared memory; writes each
//   chunk's G (fp32) before taking it a chunk back.
// * mlstm_bwd_grad_kernel, one block per (64 columns x output, chunk,
//   head): one of dQ, dK, dV for 64 columns, the Dh contraction in full
//   inside the block (a two-stage cp.async ring of 64-wide tiles), then
//   the L x L one; writes the output in bf16 and, for dQ and dK, its 64
//   columns' share of the row dots q . dq and k . dk.
// * mlstm_bwd_gate_kernel, one warp per head: the shares summed in column
//   order, di, and the reverse cumulative sum for df.
#include "common.cuh"

#include <math.h>

namespace {

using rt::bf16;

constexpr int L = 64;          // the forward's chunk
constexpr int ROWS = 16;       // rows of G a state-pass block owns
constexpr int COLS = 64;       // columns a gradient block owns
constexpr int LDB = 72;        // bf16 tile rows: 64 + 8 of padding
constexpr int LDF = 68;        // fp32 tile rows: 64 + 4 of padding
constexpr int STATE_THREADS = 256;

constexpr int prep_smem_bytes() { return 4 * L * LDB * 2 + 16 * L * 4; }
inline int state_smem_bytes(int Dh) {
  return L * (Dh + 8) * 2 + 2 * ROWS * LDB * 2 + 4 * L * 4;
}
constexpr int GRAD_STAGE = L * LDB * 2 + 64 * LDF * 4;
constexpr int grad_smem_bytes() { return 2 * GRAD_STAGE + 8 * 64 * 4; }

struct BwdParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dh;
  const float* ig;
  const float* fg;
  const float* xs;  // (B H, chunks, Dh + 1, Dh): the forward's saved state
  const float* ms;  // (B H, chunks): its m_prev
  const float* hf;  // (B H, T, Dh): the fp32 h
  const float* dn;  // (B H, T, 2): den, and the sign h took through it
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* di;
  float* df;
  float* G;     // (B H, chunks, Dh + 1, Dh): each chunk's end-gradient
  float* PD;    // (B H, chunks, 2, L, L): Pi, dS
  float* W;     // (B H, chunks, 4, L): gi, gn, w, g_end (at [3][0])
  float* dots;  // (B H, 2, tiles, T): q . dq and k . dk, 64 columns each
  int T, Dh, nchunks, tiles;
  float scale;
};

// log sigma(x) = -softplus(-x), stable for either sign; 0 at x = +inf
// (mlstm.cu's, so that m is recomputed to the same bits)
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// (hi, lo) of two values, each pair packed as bf16x2: hi = bf16(x),
// lo = bf16(x - hi)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = rt::pack_bf16(x0 - hf.x, x1 - hf.y);
}

// ---------------------------------------------------------------------------
// prep: per (chunk, head)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(128)
    mlstm_bwd_prep_kernel(const __grid_constant__ BwdParams p) {
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + L * LDB;
  bf16* Hs = Ks + L * LDB;
  bf16* Vs = Hs + L * LDB;
  float* ai = reinterpret_cast<float*>(Vs + L * LDB);  // i
  float* al = ai + L;                                  // log sigma(f)
  float* ab = al + L;                                  // b_t
  float* am = ab + L;                                  // m_t
  float* ainv = am + L;                                // 1 / den
  float* adhn = ainv + L;                              // dHn
  float* ar = adhn + L;                                // dh . h
  float* aa = ar + L;                                  // a_t
  float* ae = aa + L;                                  // e_s
  const int c = blockIdx.x, bh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int t0 = c * L;
  const size_t gb = (size_t)bh * p.T;

  for (int u = tid; u < L; u += 128) {
    const bool ok = t0 + u < p.T;
    ai[u] = ok ? p.ig[gb + t0 + u] : -INFINITY;
    al[u] = ok ? log_sigmoid(p.fg[gb + t0 + u]) : 0.f;
  }
  // dh . h of each step, 16 rows a warp
  for (int r = 0; r < 16; ++r) {
    const int u = 16 * warp + r, t = t0 + u;
    float s = 0.f;
    if (t < p.T) {
      const bf16* dr = p.dh + (gb + t) * p.Dh;
      const float* hr = p.hf + (gb + t) * p.Dh;
      for (int d = lane; d < p.Dh; d += 32)
        s += __bfloat162float(dr[d]) * hr[d];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) ar[u] = s;
  }
  __syncthreads();
  const float m_prev = p.ms[(size_t)bh * p.nchunks + c];
  if (tid == 0) {  // the gate scan, step by step as the forward runs it
    float bb = 0.f, mm = m_prev;
    for (int u = 0; u < L; ++u) {
      bb += al[u];
      mm = fmaxf(al[u] + mm, ai[u]);
      ab[u] = bb;
      am[u] = mm;
    }
  }
  __syncthreads();
  float* W = p.W + ((size_t)bh * p.nchunks + c) * 4 * L;
  const float b_end = ab[L - 1], m_end = am[L - 1];
  for (int u = tid; u < L; u += 128) {
    const int t = t0 + u;
    const float b = ab[u], m = am[u];
    aa[u] = b - m;
    ae[u] = ai[u] - b;
    float inv = 0.f, dhn = 0.f;
    if (t < p.T) {
      const float2 dd = *reinterpret_cast<const float2*>(p.dn + (gb + t) * 2);
      inv = 1.f / dd.x;
      dhn = -dd.y * ar[u] / dd.x;
    }
    ainv[u] = inv;
    adhn[u] = dhn;
    const float gq = p.scale * expf(b + m_prev - m);
    W[u] = gq * inv;                          // gi
    W[L + u] = gq * dhn;                      // gn
    W[2 * L + u] = expf(ae[u] + (b_end - m_end));  // w
  }
  if (tid == 0) W[3 * L] = expf(b_end + m_prev - m_end);  // g_end

  // S = Q K^T and U = dh V^T over Dh, 16 rows a warp
  float accS[8][4], accU[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) accS[i][e] = accU[i][e] = 0.f;
  for (int k0 = 0; k0 < p.Dh; k0 += 64) {
    __syncthreads();
    for (int i = tid; i < 4 * 512; i += 128) {
      const int which = i / 512, o = i % 512, row = o / 8, ch = o % 8;
      const bf16* src = which == 0 ? p.q : which == 1 ? p.k
                        : which == 2 ? p.dh : p.v;
      bf16* dst = Qs + which * L * LDB + row * LDB + ch * 8;
      const int t = t0 + row, col = k0 + ch * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (t < p.T && col < p.Dh)
        val = *reinterpret_cast<const uint4*>(src + (gb + t) * p.Dh + col);
      *reinterpret_cast<uint4*>(dst) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 64; kk += 16) {
      uint32_t aq[4], ah[4];
      rt::load_a(aq, Qs, LDB, 16 * warp, kk, lane);
      rt::load_a(ah, Hs, LDB, 16 * warp, kk, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4], bv[4];
        rt::load_b_nk(bk, Ks, LDB, 16 * np, kk, lane);
        rt::load_b_nk(bv, Vs, LDB, 16 * np, kk, lane);
        rt::mma16816(accS[2 * np], aq, bk[0], bk[1]);
        rt::mma16816(accS[2 * np + 1], aq, bk[2], bk[3]);
        rt::mma16816(accU[2 * np], ah, bv[0], bv[1]);
        rt::mma16816(accU[2 * np + 1], ah, bv[2], bv[3]);
      }
    }
  }
  // Pi = (S o D) inv, dS = (inv U + dHn) o D
  float* Pi = p.PD + ((size_t)bh * p.nchunks + c) * 2 * L * L;
  float* dS = Pi + L * L;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = 16 * warp + g + 8 * h, s = 8 * nt + 2 * tq;
      float pv[2], dv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float D =
            s + e <= t ? p.scale * expf(aa[t] + ae[s + e]) : 0.f;
        pv[e] = accS[nt][2 * h + e] * D * ainv[t];
        dv[e] = (ainv[t] * accU[nt][2 * h + e] + adhn[t]) * D;
      }
      *reinterpret_cast<float2*>(Pi + t * L + s) = make_float2(pv[0], pv[1]);
      *reinterpret_cast<float2*>(dS + t * L + s) = make_float2(dv[0], dv[1]);
    }
}

// ---------------------------------------------------------------------------
// the state pass: per 16 rows of G and head, the chunks from the last back
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(STATE_THREADS, 1)
    mlstm_bwd_state_kernel(const __grid_constant__ BwdParams p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int ldq = p.Dh + 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ahi = Qs + L * ldq;
  bf16* Alo = Ahi + ROWS * LDB;
  const int r0 = ROWS * blockIdx.x, bh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const size_t gb = (size_t)bh * p.T;
  // each warp owns NTW n8 tiles of G's Dh columns (an even count)
  const int ntile = p.Dh / 8;
  const int ntw = 2 * ((ntile + 15) / 16);
  const int nt0 = warp * ntw;
  float acc[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  const size_t gsz = (size_t)(p.Dh + 1) * p.Dh;

  for (int c = p.nchunks - 1; c >= 0; --c) {
    float* Gc = p.G + ((size_t)bh * p.nchunks + c) * gsz;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int nt = nt0 + i;
      if (i < ntw && nt < ntile) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + g + 8 * h;
          if (r <= p.Dh)
            *reinterpret_cast<float2*>(Gc + (size_t)r * p.Dh + 8 * nt +
                                       2 * tq) =
                make_float2(acc[i][2 * h], acc[i][2 * h + 1]);
        }
      }
    }
    if (c == 0) break;
    __syncthreads();  // the chunk before's operands are read
    const int t0 = c * L;
    const int row_ch = p.Dh / 8;
    for (int i = tid; i < L * row_ch; i += STATE_THREADS) {
      const int row = i / row_ch, ch = i % row_ch, t = t0 + row;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (t < p.T)
        val = *reinterpret_cast<const uint4*>(p.q + (gb + t) * p.Dh + 8 * ch);
      *reinterpret_cast<uint4*>(Qs + row * ldq + 8 * ch) = val;
    }
    const float* W = p.W + ((size_t)bh * p.nchunks + c) * 4 * L;
    for (int i = tid; i < ROWS * L; i += STATE_THREADS) {
      const int r = i % ROWS, u = i / ROWS, t = t0 + u, rr = r0 + r;
      float x = 0.f;
      if (t < p.T) {
        if (rr < p.Dh)
          x = W[u] * __bfloat162float(p.dh[(gb + t) * p.Dh + rr]);
        else if (rr == p.Dh)
          x = W[L + u];
      }
      const bf16 hi = __float2bfloat16(x);
      Ahi[r * LDB + u] = hi;
      Alo[r * LDB + u] = __float2bfloat16(x - __bfloat162float(hi));
    }
    const float gend = W[3 * L];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= gend;
#pragma unroll
    for (int kk = 0; kk < L; kk += 16) {
      uint32_t ahi[4], alo[4];
      rt::load_a(ahi, Ahi, LDB, 0, kk, lane);
      rt::load_a(alo, Alo, LDB, 0, kk, lane);
#pragma unroll
      for (int ip = 0; ip < 8; ++ip) {
        const int nt = nt0 + 2 * ip;
        if (2 * ip < ntw && nt < ntile) {
          uint32_t b[4];
          rt::load_b_kn(b, Qs, ldq, kk, 8 * nt, lane);
          rt::mma16816(acc[2 * ip], ahi, b[0], b[1]);
          rt::mma16816(acc[2 * ip], alo, b[0], b[1]);
          rt::mma16816(acc[2 * ip + 1], ahi, b[2], b[3]);
          rt::mma16816(acc[2 * ip + 1], alo, b[2], b[3]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the gradients: per (64 columns x output, chunk, head)
// ---------------------------------------------------------------------------

// A-operand hi / lo fragments of rows [m0, m0 + 16) x [k0, k0 + 16) of an
// fp32 64 x 64 tile (rows of LDF), or of its transpose
template <bool TRANS>
__device__ __forceinline__ void frag_a_f32(const float* M, int m0, int k0,
                                           int g, int tq, uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int m = m0 + g + 8 * (q & 1), k = k0 + 2 * tq + 8 * (q >> 1);
    const float x0 = TRANS ? M[k * LDF + m] : M[m * LDF + k];
    const float x1 = TRANS ? M[(k + 1) * LDF + m] : M[m * LDF + k + 1];
    split2(x0, x1, hi[q], lo[q]);
  }
}

// B-operand hi / lo fragments of column n, k rows [k0, k0 + 16), of an fp32
// 64 x 64 tile held [k][n] (NK: [n][k]), rows of LDF
template <bool NK>
__device__ __forceinline__ void frag_b_f32(const float* B, int k0, int n,
                                           int tq, uint32_t (&hi)[2],
                                           uint32_t (&lo)[2]) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int k = k0 + 2 * tq + 8 * q;
    const float x0 = NK ? B[n * LDF + k] : B[k * LDF + n];
    const float x1 = NK ? B[n * LDF + k + 1] : B[(k + 1) * LDF + n];
    split2(x0, x1, hi[q], lo[q]);
  }
}

// ROLE 0: dQ = gi o (dh X[:Dh]) + gn (x) X[Dh] + dS K
// ROLE 1: dK = w o (V G[:Dh]) + w (x) G[Dh] + dS^T Q
// ROLE 2: dV = w o (K G[:Dh]^T) + Pi^T dh
template <int ROLE>
__device__ __forceinline__ void grad_block(const BwdParams& p, uint8_t* smem,
                                           int tile, int c, int bh) {
  constexpr bool NK = ROLE == 2;  // B1 held [n][k]: G's rows are the columns
  bf16* As[2];
  float* Bs[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    As[s] = reinterpret_cast<bf16*>(smem + s * GRAD_STAGE);
    Bs[s] = reinterpret_cast<float*>(smem + s * GRAD_STAGE + L * LDB * 2);
  }
  float* vs = reinterpret_cast<float*>(smem + 2 * GRAD_STAGE);  // row scale
  float* vr = vs + 64;     // the rank-1 term's row weight
  float* nrow = vr + 64;   // ... and its column values (X's or G's row Dh)
  float* red = nrow + 64;  // the row dots' warp shares, 4 x 64
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int t0 = c * L, col0 = COLS * tile;
  const size_t gb = (size_t)bh * p.T;
  const size_t soff =
      ((size_t)bh * p.nchunks + c) * (size_t)(p.Dh + 1) * p.Dh;
  const float* B1 = (ROLE == 0 ? p.xs : p.G) + soff;
  const bf16* A1 = ROLE == 0 ? p.dh : ROLE == 1 ? p.v : p.k;
  const float* W = p.W + ((size_t)bh * p.nchunks + c) * 4 * L;
  if (tid < 64) {
    vs[tid] = ROLE == 0 ? W[tid] : W[2 * L + tid];
    vr[tid] = ROLE == 0 ? W[L + tid] : ROLE == 1 ? W[2 * L + tid] : 0.f;
    const int col = col0 + tid;
    nrow[tid] = ROLE != 2 && col < p.Dh ? B1[(size_t)p.Dh * p.Dh + col] : 0.f;
  }

  auto load1 = [&](int kt, int st) {
    const int k0 = 64 * kt;
    for (int i = tid; i < 512; i += 128) {
      const int row = i >> 3, ch = i & 7, t = t0 + row, kc = k0 + 8 * ch;
      const bool ok = t < p.T && kc < p.Dh;
      rt::cp_async16(As[st] + row * LDB + 8 * ch,
                     ok ? A1 + (gb + t) * p.Dh + kc : A1, ok);
    }
    for (int i = tid; i < 1024; i += 128) {
      const int row = i >> 4, ch = i & 15;
      const int kk = NK ? k0 + 4 * ch : k0 + row;
      const int nn = NK ? col0 + row : col0 + 4 * ch;
      const bool ok = kk < p.Dh && nn < p.Dh;
      const float* src =
          NK ? B1 + (size_t)nn * p.Dh + kk : B1 + (size_t)kk * p.Dh + nn;
      rt::cp_async16(Bs[st] + row * LDF + 4 * ch, ok ? src : B1, ok);
    }
    rt::cp_async_commit();
  };

  float acc[4][2][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // the Dh contraction: A1 (bf16, rows t) by B1 (fp32, split)
  const int nk = (p.Dh + 63) / 64;
  load1(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load1(kt + 1, (kt + 1) & 1);
      rt::cp_async_wait<1>();
    } else {
      rt::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* as = As[kt & 1];
    const float* bs = Bs[kt & 1];
#pragma unroll
    for (int kk = 0; kk < 64; kk += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) rt::load_a(a[mi], as, LDB, 16 * mi, kk, lane);
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        uint32_t bh_[2], bl_[2];
        frag_b_f32<NK>(bs, kk, 16 * warp + 8 * ni + g, tq, bh_, bl_);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          rt::mma16816(acc[mi][ni], a[mi], bh_[0], bh_[1]);
          rt::mma16816(acc[mi][ni], a[mi], bl_[0], bl_[1]);
        }
      }
    }
    __syncthreads();
  }

  // the row scale and the rank-1 term; then the L x L contraction's
  // operands into stage 0
  {
    const float* A2 = p.PD + ((size_t)bh * p.nchunks + c) * 2 * L * L +
                      (ROLE == 2 ? 0 : L * L);  // Pi or dS
    for (int i = tid; i < 1024; i += 128) {
      const int row = i >> 4, ch = i & 15;
      rt::cp_async16(Bs[0] + row * LDF + 4 * ch, A2 + row * L + 4 * ch, true);
    }
    const bf16* B2 = ROLE == 0 ? p.k : ROLE == 1 ? p.q : p.dh;
    for (int i = tid; i < 512; i += 128) {
      const int row = i >> 3, ch = i & 7, t = t0 + row, col = col0 + 8 * ch;
      const bool ok = t < p.T && col < p.Dh;
      rt::cp_async16(As[0] + row * LDB + 8 * ch,
                     ok ? B2 + (gb + t) * p.Dh + col : B2, ok);
    }
    rt::cp_async_commit();
  }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 16 * mi + g + 8 * (e >> 1);
        const int n = 16 * warp + 8 * ni + 2 * tq + (e & 1);
        acc[mi][ni][e] = acc[mi][ni][e] * vs[t] + vr[t] * nrow[n];
      }
  rt::cp_async_wait<0>();
  __syncthreads();
  {
    const float* M = Bs[0];
    const bf16* B2s = As[0];
#pragma unroll
    for (int kk = 0; kk < L; kk += 16) {
      uint32_t b[4];
      rt::load_b_kn(b, B2s, LDB, kk, 16 * warp, lane);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        uint32_t ahi[4], alo[4];
        frag_a_f32<ROLE != 0>(M, 16 * mi, kk, g, tq, ahi, alo);
        rt::mma16816(acc[mi][0], ahi, b[0], b[1]);
        rt::mma16816(acc[mi][0], alo, b[0], b[1]);
        rt::mma16816(acc[mi][1], ahi, b[2], b[3]);
        rt::mma16816(acc[mi][1], alo, b[2], b[3]);
      }
    }
  }

  // the output in bf16 and, for dQ and dK, the row dots' share
  bf16* out = ROLE == 0 ? p.dq : ROLE == 1 ? p.dk : p.dv;
  const bf16* X = ROLE == 0 ? p.q : p.k;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int u = 16 * mi + g + 8 * h, t = t0 + u;
      float dot = 0.f;
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        const int col = col0 + 16 * warp + 8 * ni + 2 * tq;
        const float x0 = acc[mi][ni][2 * h], x1 = acc[mi][ni][2 * h + 1];
        if (t < p.T && col < p.Dh) {
          *reinterpret_cast<uint32_t*>(out + (gb + t) * p.Dh + col) =
              rt::pack_bf16(x0, x1);
          if (ROLE != 2) {
            const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(
                X + (gb + t) * p.Dh + col);
            const float2 xf = __bfloat1622float2(xv);
            dot += xf.x * x0 + xf.y * x1;
          }
        }
      }
      if (ROLE != 2) {
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        if (tq == 0) red[warp * 64 + u] = dot;
      }
    }
  if (ROLE != 2) {
    __syncthreads();
    if (tid < 64 && t0 + tid < p.T) {
      const float s = ((red[tid] + red[64 + tid]) + red[128 + tid]) +
                      red[192 + tid];
      p.dots[(((size_t)bh * 2 + ROLE) * p.tiles + tile) * p.T + t0 + tid] = s;
    }
  }
}

__global__ void __launch_bounds__(128)
    mlstm_bwd_grad_kernel(const __grid_constant__ BwdParams p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int role = blockIdx.x % 3, tile = blockIdx.x / 3;
  if (role == 0)
    grad_block<0>(p, smem, tile, blockIdx.y, blockIdx.z);
  else if (role == 1)
    grad_block<1>(p, smem, tile, blockIdx.y, blockIdx.z);
  else
    grad_block<2>(p, smem, tile, blockIdx.y, blockIdx.z);
}

// ---------------------------------------------------------------------------
// the gates: one warp per head, from the last step back
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(32)
    mlstm_bwd_gate_kernel(const __grid_constant__ BwdParams p) {
  const int bh = blockIdx.x, lane = threadIdx.x;
  const size_t gb = (size_t)bh * p.T;
  const float* qd = p.dots + (size_t)bh * 2 * p.tiles * p.T;
  const float* kd = qd + (size_t)p.tiles * p.T;
  float carry = 0.f;
  for (int base = (p.T - 1) / 32 * 32; base >= 0; base -= 32) {
    const int t = base + lane;
    float sq = 0.f, sk = 0.f;
    if (t < p.T)
      for (int j = 0; j < p.tiles; ++j) {
        sq += qd[(size_t)j * p.T + t];
        sk += kd[(size_t)j * p.T + t];
      }
    // the sum over this step and every later one
    float x = sq - sk;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_down_sync(0xffffffffu, x, off);
      if (lane + off < 32) x += y;
    }
    const float cum = x + carry;
    carry = __shfl_sync(0xffffffffu, cum, 0);
    if (t < p.T) {
      p.di[gb + t] = sk;
      p.df[gb + t] = cum / (1.f + expf(p.fg[gb + t]));  // sigma(-f)
    }
  }
}

int set_smem(const void* fn, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace

// q, k, v, dh, dq, dk, dv: (B*H, T, Dh) bf16, 16-byte aligned; ig, fg, di,
// df: (B*H, T) fp32; xs, ms, hf, dn: the training forward's outputs
// (mlstm.cu); scratch: kernels/mlstm.py:bwd_schedule's scratch_bytes of
// fp32.  Returns the first cudaError_t.
extern "C" int rt_mlstm_bwd(const void* q, const void* k, const void* v,
                            const void* ig, const void* fg, const void* xs,
                            const void* ms, const void* hf, const void* dn,
                            const void* dh, void* dq, void* dk, void* dv,
                            void* di, void* df, void* scratch, int BH, int T,
                            int Dh, void* stream) {
  if (BH <= 0 || BH > 65535 || T <= 0 || Dh <= 0 || Dh % 32 || Dh > 1024 ||
      state_smem_bytes(Dh) > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p{};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dh = static_cast<const bf16*>(dh);
  p.ig = static_cast<const float*>(ig);
  p.fg = static_cast<const float*>(fg);
  p.xs = static_cast<const float*>(xs);
  p.ms = static_cast<const float*>(ms);
  p.hf = static_cast<const float*>(hf);
  p.dn = static_cast<const float*>(dn);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.di = static_cast<float*>(di);
  p.df = static_cast<float*>(df);
  p.T = T, p.Dh = Dh, p.nchunks = (T + L - 1) / L;
  p.tiles = (Dh + COLS - 1) / COLS;
  p.scale = static_cast<float>(pow(static_cast<double>(Dh), -0.5));
  float* s = static_cast<float*>(scratch);
  p.G = s;
  s += (size_t)BH * p.nchunks * (Dh + 1) * Dh;
  p.PD = s;
  s += (size_t)BH * p.nchunks * 2 * L * L;
  p.W = s;
  s += (size_t)BH * p.nchunks * 4 * L;
  p.dots = s;
  auto st = static_cast<cudaStream_t>(stream);
  void* args[] = {&p};

  const void* prep = reinterpret_cast<const void*>(&mlstm_bwd_prep_kernel);
  const void* state = reinterpret_cast<const void*>(&mlstm_bwd_state_kernel);
  const void* grad = reinterpret_cast<const void*>(&mlstm_bwd_grad_kernel);
  const void* gate = reinterpret_cast<const void*>(&mlstm_bwd_gate_kernel);
  int rc = set_smem(prep, prep_smem_bytes());
  if (!rc) rc = set_smem(state, state_smem_bytes(Dh));
  if (!rc) rc = set_smem(grad, grad_smem_bytes());
  if (!rc)
    rc = static_cast<int>(cudaLaunchKernel(prep, dim3(p.nchunks, BH),
                                           dim3(128), args,
                                           prep_smem_bytes(), st));
  if (!rc)
    rc = static_cast<int>(cudaLaunchKernel(
        state, dim3((Dh + 1 + ROWS - 1) / ROWS, BH), dim3(STATE_THREADS),
        args, state_smem_bytes(Dh), st));
  if (!rc)
    rc = static_cast<int>(cudaLaunchKernel(
        grad, dim3(3 * p.tiles, p.nchunks, BH), dim3(128), args,
        grad_smem_bytes(), st));
  if (!rc)
    rc = static_cast<int>(cudaLaunchKernel(gate, dim3(BH), dim3(32), args, 0,
                                           st));
  return rc;
}

// Dynamic shared memory of the prep (kernel 0), state-pass (1) and
// gradient (2) blocks at head dim Dh (kernels/mlstm.py: prep_smem_bytes,
// state_smem_bytes, grad_smem_bytes must agree), or -1.
extern "C" int rt_mlstm_bwd_smem_bytes(int kernel, int Dh) {
  if (kernel == 0) return prep_smem_bytes();
  if (kernel == 1) return state_smem_bytes(Dh);
  if (kernel == 2) return grad_smem_bytes();
  return -1;
}

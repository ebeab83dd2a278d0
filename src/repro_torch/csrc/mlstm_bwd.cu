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
//   G^T <- g_end G^T + Q^T [gi o dh | gn]       (the chunk before's G)
// kernels/mlstm.py:chunkwise_bwd_model computes the same on the CPU.
//
// The state recurrence has the forward's shape, C^T <- g C^T + K^T [w o V
// | w], with Q in K's place and gi o dh, gn in w o V's and w's; dV's state
// term K G^T is the forward's Q C_prev^T with K in Q's place, and its
// other term Pi^T dh the forward's (S o D) V.  So the state pass is the
// forward's scan kernel run from the last chunk back, and writes dV.
//
// Precision.  q, k, v and dh are bf16 already and enter the products as
// they are; every fp32 operand (G, X, Pi, dS, gi o dh, gn) enters as a
// bf16 pair hi = bf16(x), lo = bf16(x - hi), two products into one fp32
// accumulator, as in the forward.  Rounded once to bf16 instead, the
// gates' gradients miss their tolerance (chunkwise_bwd_model, split=False;
// tests/test_torch_mlstm_grad.py).  The row dots take dq and dk in fp32,
// before their rounding.
//
// Bound: 8 Dh^2 + 10 L Dh tensor-core operations a step and head (the
// function's products, unsplit); at (4, 4, 512, 1024) 0.075 ms at
// 989 TFLOP/s, and reading the saved states once 0.21 ms at 3.35 TB/s.
// This design does more: the pairs double the products, and G (as large
// as the saved states, less the last chunk's, which is zero) is written
// once and read once.
//
// Design: four kernels on one stream, no atomics (two launches are
// bit-identical).
// * mlstm_bwd_prep_kernel, one block per (chunk, head), on mma.sync: the
//   gate scan (m step by step from the saved m_prev, as the forward),
//   S = Q K^T, U = dh V^T and dh . h over Dh (a two-stage cp.async ring of
//   64-column tiles), then the per-step weights, Pi^T (fp32) and dS as its
//   bf16 pair into a scratch.
// * mlstm_bwd_state_kernel, one block per 32 columns of dv of one head
//   (grid Dh / 32 x B H), the chunks from the last back: the forward's
//   mlstm_scan_kernel with the tensors swapped.  Four owner warpgroups
//   keep the block's slice G^T[dk, dv0..dv0+32) as fp32 wgmma
//   accumulators, the 64-row tiles j = owner + 4 i of G^T's Dh rows
//   (padded to a multiple of 256; the rows past Dh stay zero), and G's n
//   row beside them as an m64n8 accumulator's column.  Per chunk and tile
//   j, through a TMA ring of (Q_j, K_j) tiles:
//   - the owner stores its tile of G (fp32) to the scratch for dK, but
//     not on the last chunk, where it is zero; writes the tile as a bf16
//     pair into the ring slot (stmatrix.trans into [dv][dk] rows); then
//     G^T_j <- g_end G^T_j + Q_j^T (gi o dh)_hi + Q_j^T (gi o dh)_lo, and
//     the n column with gn's pair (wgmma m64n32k16 and m64n8k16, Q_j^T
//     read M-major);
//   - the output warpgroup accumulates K_j G_j^T (hi and lo) over the
//     tiles, scales the rows by w, adds Pi^T dh with Pi^T's pair in
//     registers (wgmma with A from registers), and writes its 32 columns
//     of dV in bf16;
//   - the aux warpgroup: one thread issues the TMA loads; three warps
//     stage gi o dh's pair and dh's 32 columns ([dv][t], K-major), gn's
//     pair, Pi^T and the weights into one of two chunk buffers, a chunk
//     ahead.
//   The ring has one stage an owner, so that a slot is always filled for
//   the same owner.  An owner waits on its slot's full barrier by phase
//   parity knowing only that its own previous tile has landed; were the
//   slot's previous tile another owner's (six stages), TMA may complete
//   it after the owner's own, the barrier is then a phase behind with the
//   parity waited for, and the wait passes on a slot still being filled
//   (at six stages this gave other bits now and then, then a launch
//   failure, on the card).  Registers bound the slice: 64
//   accumulators a thread at Dh = 1024; setmaxnreg gives the owners 96,
//   the output group 64 and the aux 32.
// * mlstm_bwd_grad_kernel, one block per (64 columns, output, chunk,
//   head), output dQ or dK, one warpgroup: dQ^T (or dK^T) of its 64
//   columns, the Dh contraction in full inside the block through a TMA
//   ring of (dh or V) boxes and (X or G) tiles, the fp32 tile split into
//   a bf16 pair in registers as the A operand (wgmma m64n64k16, A from
//   registers); then the columns' scale and the rank-1 term, then the
//   L x L term with dS's pair from the scratch (K^T dS^T, Q^T dS).  dK of
//   the last chunk has no state term and reads no G.  It writes the
//   output in bf16 (stmatrix.trans into a swizzled box, a TMA store) and
//   its 64 columns' share of the row dots q . dq and k . dk.
// * mlstm_bwd_gate_kernel, one warp per head: the shares summed in column
//   order, di, and the reverse cumulative sum for df.
#include "mlstm.cuh"

#include <atomic>
#include <math.h>

namespace {

using rt::bf16;

constexpr int L = 64;              // the forward's chunk
constexpr int TILE = L * 128;      // a 64-row box of 64 bf16 (or 32 fp32)
constexpr int LDB = 72;            // the prep kernel's bf16 tile rows
constexpr int COLS = 64;           // columns of dQ or dK a gradient block owns

// the state pass
constexpr int OWNERS = 4;
constexpr int THREADS = 128 * (OWNERS + 2);  // owners, output, aux
constexpr int DV = 32;                       // columns of dv a block owns
constexpr int MAX_STAGES = 8;  // the mbarrier arrays' room
constexpr int PAIR_BYTES = DV * 128;         // a 32-row bf16 pair tile
constexpr int SLOT = 2 * TILE + 2 * PAIR_BYTES;  // Q_j, K_j, G_j's pair
constexpr int STAGE_THREADS = 96;            // the aux group's staging warps
constexpr int PIT_LD = 72;                   // Pi^T rows: 64 + 8 fp32
constexpr int NB = 2;                        // chunk buffers
// a chunk buffer: gi o dh's hi and lo and dh ([dv][t], 32 rows each), gn's
// pair (8 rows), Pi^T (fp32), dh's 32 columns as loaded ([t][dv]) and the
// chunk's weights (gi, gn, w, g_end); 1 KB-aligned
constexpr int BUF_GD = 0;
constexpr int BUF_DH = 2 * PAIR_BYTES;
constexpr int BUF_GN = 3 * PAIR_BYTES;
constexpr int BUF_PIT = BUF_GN + 1024;
constexpr int BUF_RAW = BUF_PIT + L * PIT_LD * 4;
constexpr int BUF_W = BUF_RAW + L * DV * 2;
constexpr int BUF = (BUF_W + 4 * L * 4 + 1023) / 1024 * 1024;
constexpr int state_smem_bytes(int stages) {
  return 1024 + stages * SLOT + NB * BUF + 256;
}
// one stage an owner (mlstm.py:BWD_STATE_STAGES must agree): slot s is
// then filled for owner s only, and an owner's parity wait on it is sound
// (see the note above); eight stages do not fit
constexpr int STATE_STAGES = OWNERS;
static_assert(state_smem_bytes(STATE_STAGES) <= 232448, "a block's limit");
constexpr int OWNER_REGS = 96;
constexpr int OUT_REGS = 64;
constexpr int AUX_REGS = 32;

// the gradient kernel: a ring stage is one (dh or V) box and one (X or G)
// tile of 64 rows x 64 fp32 (two 32-column boxes)
constexpr int GRAD_STAGES = 3;
constexpr int GSLOT = 3 * TILE;

// the prep kernel: a stage of its Dh loop is Q, K, dh, V (L x 64 bf16,
// rows of LDB) and h (L x 64 fp32, rows of LDF)
constexpr int LDF = 68;
constexpr int PREP_STAGES = 2;
constexpr int PREP_STAGE = 4 * L * LDB * 2 + L * LDF * 4;
constexpr int prep_smem_bytes() {
  return PREP_STAGES * PREP_STAGE + 16 * L * 4;
}
constexpr int grad_smem_bytes() {
  // 1 KB of alignment slack, the ring, the Q and K boxes and dS's pair,
  // 7 fp32 arrays of 64, the mbarriers
  return 1024 + GRAD_STAGES * GSLOT + 4 * TILE + 7 * 64 * 4 + 64;
}

struct BwdParams {
  // (Dh, T, B H) bf16 in boxes of 64 steps x 64 columns, 128-byte swizzled
  CUtensorMap mq, mk, mv, mdh, mdq, mdk;
  // (Dh, Dh + 1, B H chunks) fp32 in boxes of 64 rows x 32 columns: the
  // saved states X and the end-gradients G (chunks - 1 a head)
  CUtensorMap mxs, mG;
  CUtensorMap mdS;  // (L, 2 L, B H chunks) bf16: dS's hi over its lo
  CUtensorMap mdh32;  // dh in boxes of 64 steps x 32 columns, unswizzled
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
  bf16* dv;
  float* di;
  float* df;
  float* G;     // (B H, chunks - 1, Dh + 1, Dh): each chunk's end-gradient
  float* PiT;   // (B H, chunks, L, L): Pi^T
  bf16* dS;     // (B H, chunks, 2, L, L): dS's hi and lo
  float* W;     // (B H, chunks, 4, L): gi, gn, w, g_end (at [3][0])
  float* dots;  // (B H, 2, tiles, T): q . dq and k . dk, 64 columns each
  int T, Dh, nchunks, tiles;
  float scale;
};

// Expect ``bytes`` more transaction bytes in the barrier's current phase,
// without arriving.
__device__ __forceinline__ void mbar_expect_tx_only(uint64_t* bar,
                                                    int bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(
                   rt::smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

#define BWD_ACC8(d, i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 32) (+)= A (64 x 16) @ B (16 x 32), both K-major from shared
// memory; d is overwritten where scale_d is 0.
__device__ __forceinline__ void wgmma_n32_ss(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : BWD_ACC8(d, 0), BWD_ACC8(d, 8)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 32) += A (64 x 16, registers, mma.sync's A-fragment layout) @
// B (16 x 32, K-major, shared memory).
__device__ __forceinline__ void wgmma_n32_rs(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : BWD_ACC8(d, 0), BWD_ACC8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64) += A (64 x 16) @ B (16 x 64) from shared memory, A M-major
// (the transpose bit), TB the transpose bit of B (1: N-major).
template <int TB>
__device__ __forceinline__ void wgmma_n64_tss(float (&d)[32], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, %35;\n}\n"
      : BWD_ACC8(d, 0), BWD_ACC8(d, 8), BWD_ACC8(d, 16), BWD_ACC8(d, 24)
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

#undef BWD_ACC8

// ---------------------------------------------------------------------------
// prep: per (chunk, head), on mma.sync
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(128)
    mlstm_bwd_prep_kernel(const __grid_constant__ BwdParams p) {
  extern __shared__ __align__(16) uint8_t smem[];
  float* ai = reinterpret_cast<float*>(smem + PREP_STAGES * PREP_STAGE);
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

  // stage st of the Dh loop: Q, K, dh, V (bf16, rows of LDB) and the fp32
  // h (rows of LDF) of 64 columns, zero past T and Dh
  auto load = [&](int k0, int st) {
    bf16* tiles = reinterpret_cast<bf16*>(smem + st * PREP_STAGE);
    for (int i = tid; i < 4 * 512; i += 128) {
      const int which = i / 512, o = i % 512, row = o / 8, ch = o % 8;
      const bf16* src = which == 0 ? p.q : which == 1 ? p.k
                        : which == 2 ? p.dh : p.v;
      const int t = t0 + row, col = k0 + ch * 8;
      const bool ok = t < p.T && col < p.Dh;
      rt::cp_async16(tiles + which * L * LDB + row * LDB + ch * 8,
                     ok ? src + (gb + t) * p.Dh + col : src, ok);
    }
    float* hs = reinterpret_cast<float*>(tiles + 4 * L * LDB);
    for (int i = tid; i < 1024; i += 128) {
      const int row = i / 16, ch = i % 16, t = t0 + row, col = k0 + 4 * ch;
      const bool ok = t < p.T && col < p.Dh;
      rt::cp_async16(hs + row * LDF + 4 * ch,
                     ok ? p.hf + (gb + t) * p.Dh + col : p.hf, ok);
    }
    rt::cp_async_commit();
  };
  load(0, 0);

  for (int u = tid; u < L; u += 128) {
    const bool ok = t0 + u < p.T;
    ai[u] = ok ? p.ig[gb + t0 + u] : -INFINITY;
    al[u] = ok ? log_sigmoid(p.fg[gb + t0 + u]) : 0.f;
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

  // S = Q K^T and U = dh V^T over Dh, 16 rows a warp; dh . h of row
  // 16 warp + lane / 2, half its columns a lane
  float accS[8][4], accU[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) accS[i][e] = accU[i][e] = 0.f;
  float dot = 0.f;
  const int nk = (p.Dh + 63) / 64;
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load(64 * (kt + 1), (kt + 1) % PREP_STAGES);
      rt::cp_async_wait<1>();
    } else {
      rt::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qs =
        reinterpret_cast<const bf16*>(smem + kt % PREP_STAGES * PREP_STAGE);
    const bf16* Ks = Qs + L * LDB;
    const bf16* Hs = Ks + L * LDB;
    const bf16* Vs = Hs + L * LDB;
    const float* hs = reinterpret_cast<const float*>(Vs + L * LDB);
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
    {
      const int row = 16 * warp + lane / 2, c0 = 32 * (lane & 1);
#pragma unroll
      for (int j = 0; j < 32; j += 8) {
        const uint4 dv8 =
            *reinterpret_cast<const uint4*>(Hs + row * LDB + c0 + j);
        const bf16* d8 = reinterpret_cast<const bf16*>(&dv8);
        const float4 h0 =
            *reinterpret_cast<const float4*>(hs + row * LDF + c0 + j);
        const float4 h1 =
            *reinterpret_cast<const float4*>(hs + row * LDF + c0 + j + 4);
        const float hv[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) dot += __bfloat162float(d8[e]) * hv[e];
      }
    }
    __syncthreads();  // the stage is read
  }
  dot += __shfl_xor_sync(0xffffffffu, dot, 1);
  if ((lane & 1) == 0) ar[16 * warp + lane / 2] = dot;
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
  __syncthreads();
  // Pi = (S o D) inv, stored transposed; dS = (inv U + dHn) o D, stored
  // as its bf16 pair
  const size_t ck = (size_t)bh * p.nchunks + c;
  float* PiT = p.PiT + ck * L * L;
  bf16* dSh = p.dS + ck * 2 * L * L;
  bf16* dSl = dSh + L * L;
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
      PiT[s * L + t] = pv[0];
      PiT[(s + 1) * L + t] = pv[1];
      uint32_t hi, lo;
      split2(dv[0], dv[1], hi, lo);
      *reinterpret_cast<uint32_t*>(dSh + t * L + s) = hi;
      *reinterpret_cast<uint32_t*>(dSl + t * L + s) = lo;
    }
}

// ---------------------------------------------------------------------------
// the state pass: per 32 columns of dv and head, the chunks from the last
// back (mlstm.cu's mlstm_scan_kernel with the tensors swapped)
// ---------------------------------------------------------------------------

template <int MTO>
__global__ void __launch_bounds__(THREADS, 1)
    mlstm_bwd_state_kernel(const __grid_constant__ BwdParams p) {
  constexpr int MTP = OWNERS * MTO;  // 64-row tiles of G^T
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (rt::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* ring = smem;
  uint8_t* cbuf = ring + STATE_STAGES * SLOT;
  uint64_t* bars = reinterpret_cast<uint64_t*>(cbuf + NB * BUF);
  uint64_t* full = bars;                    // a slot's Q and K landed
  uint64_t* empty = bars + MAX_STAGES;      // its owner and output are done
  uint64_t* pairf = bars + 2 * MAX_STAGES;  // its G pair is written
  uint64_t* pfull = bars + 3 * MAX_STAGES;  // a chunk buffer is written
  uint64_t* pempty = pfull + NB;            // ... and used
  uint64_t* sfull = pempty + NB;            // its dh and weights landed

  const int bh = blockIdx.y, dv0 = blockIdx.x * DV, nc = p.nchunks;
  const int tid = threadIdx.x, wg = tid / 128;
  const int warp = tid / 32 % 4, lane = tid % 32, g = lane >> 2,
            tq = lane & 3;

  // gn's pair tiles: rows 2..7 stay zero
  for (int i = tid; i < NB * 64; i += THREADS)
    reinterpret_cast<uint4*>(cbuf + i / 64 * BUF + BUF_GN)[i % 64] =
        make_uint4(0, 0, 0, 0);
  if (tid == 0) {
    for (int s = 0; s < STATE_STAGES; ++s) {
      rt::mbar_init(&full[s], 1);
      rt::mbar_init(&empty[s], 128 + 1);  // the owner's threads, output
      rt::mbar_init(&pairf[s], 128);      // the owner's threads
    }
    for (int b = 0; b < NB; ++b) {
      rt::mbar_init(&pfull[b], STAGE_THREADS);
      rt::mbar_init(&pempty[b], (OWNERS + 1) * 128);
      rt::mbar_init(&sfull[b], 1);
    }
    rt::mbar_init_fence();
  }
  rt::fence_async_smem();
  __syncthreads();

  if (wg == OWNERS + 1) {
    // ---- aux: the producer thread and the chunks' operands --------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(AUX_REGS));
    if (warp == 0) {
      if (lane == 0) {
        for (int n = 0; n < nc * MTP; ++n) {
          const int slot = n % STATE_STAGES, use = n / STATE_STAGES;
          const int c = nc - 1 - n / MTP, j = n % MTP;
          rt::mbar_wait(&empty[slot], (use & 1) ^ 1);
          uint8_t* st = ring + slot * SLOT;
          rt::mbar_expect_tx(&full[slot], 2 * TILE);
          rt::tma_load_3d(st, &p.mq, 64 * j, c * L, bh, &full[slot]);
          rt::tma_load_3d(st + TILE, &p.mk, 64 * j, c * L, bh, &full[slot]);
        }
      }
    } else {
      const int pt = tid - (OWNERS + 1) * 128 - 32;  // 0 .. 95
      for (int ci = 0; ci < nc; ++ci) {
        const int cb = ci % NB, c = nc - 1 - ci;
        rt::mbar_wait(&pempty[cb], ((ci / NB) & 1) ^ 1);
        uint8_t* buf = cbuf + cb * BUF;
        float* pit = reinterpret_cast<float*>(buf + BUF_PIT);
        const float* wa = reinterpret_cast<const float*>(buf + BUF_W);
        const bf16* raw = reinterpret_cast<const bf16*>(buf + BUF_RAW);
        // copies: dh's 32 columns (zero past T) and the weights on sfull,
        // Pi^T's rows (into rows of PIT_LD) on pfull
        const size_t ck = (size_t)bh * nc + c;
        if (pt == 0) {
          mbar_expect_tx_only(&pfull[cb], L * L * 4);
          rt::mbar_expect_tx(&sfull[cb], L * DV * 2 + 4 * L * 4);
          rt::tma_load_3d(buf + BUF_RAW, &p.mdh32, dv0, c * L, bh,
                          &sfull[cb]);
          rt::bulk_load(buf + BUF_W, p.W + ck * 4 * L, 4 * L * 4,
                        &sfull[cb]);
        }
        __syncwarp();
        if (pt < 32)
          for (int r = pt; r < L; r += 32)
            rt::bulk_load(pit + r * PIT_LD, p.PiT + (ck * L + r) * L, L * 4,
                          &pfull[cb]);
        rt::mbar_wait(&sfull[cb], (ci / NB) & 1);
        // gi o dh as a bf16 pair and dh itself, K-major [dv][t]: lane =
        // dv, eight steps a 16-byte store
        for (int sg = pt / 32; sg < L / 8; sg += STAGE_THREADS / 32) {
          uint32_t hi[4], lo[4], dx[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int s0 = 8 * sg + 2 * r;
            const float d0 = __bfloat162float(raw[s0 * DV + lane]);
            const float d1 = __bfloat162float(raw[(s0 + 1) * DV + lane]);
            split2(wa[s0] * d0, wa[s0 + 1] * d1, hi[r], lo[r]);
            dx[r] = rt::pack_bf16(d0, d1);
          }
          const int off = lane * 128 + ((sg ^ (lane & 7)) << 4);
          *reinterpret_cast<uint4*>(buf + BUF_GD + off) =
              make_uint4(hi[0], hi[1], hi[2], hi[3]);
          *reinterpret_cast<uint4*>(buf + BUF_GD + PAIR_BYTES + off) =
              make_uint4(lo[0], lo[1], lo[2], lo[3]);
          *reinterpret_cast<uint4*>(buf + BUF_DH + off) =
              make_uint4(dx[0], dx[1], dx[2], dx[3]);
        }
        // gn's pair: rows 0 (hi) and 1 (lo) of an 8-row K-major tile,
        // 16-byte chunk u / 8 of row r at chunk (u / 8) ^ r
        uint8_t* gp = buf + BUF_GN;
        for (int u = pt; u < L; u += STAGE_THREADS) {
          const float gn = wa[L + u];
          const bf16 gh = __float2bfloat16(gn);
          const int ch = u / 8, at = u % 8 * 2;
          *reinterpret_cast<bf16*>(gp + at + (ch << 4)) = gh;
          *reinterpret_cast<bf16*>(gp + 128 + at + ((ch ^ 1) << 4)) =
              __float2bfloat16(gn - __bfloat162float(gh));
        }
        rt::fence_async_smem();
        rt::mbar_arrive(&pfull[cb]);
      }
    }
  } else if (wg < OWNERS) {
    // ---- owners: G^T's tiles j = wg + 4 i, G's n row beside them ---------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(OWNER_REGS));
    float acc[MTO][16];
    // n at rows 64 j + 16 warp + g and + 8 (the m64n8 accumulator's column
    // 0, in the lanes with tq == 0; zero in the others)
    float nr[MTO][2];
#pragma unroll
    for (int i = 0; i < MTO; ++i) {
      nr[i][0] = nr[i][1] = 0.f;
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[i][e] = 0.f;
    }
    for (int ci = 0; ci < nc; ++ci) {
      const int cb = ci % NB, c = nc - 1 - ci;
      rt::mbar_wait(&pfull[cb], (ci / NB) & 1);
      const uint8_t* buf = cbuf + cb * BUF;
      const float ge = reinterpret_cast<const float*>(buf + BUF_W)[3 * L];
      // chunk c's end-gradient for dK; none for the last chunk (zero)
      float* Gc = ci == 0 ? nullptr
                          : p.G + ((size_t)bh * (nc - 1) + c) *
                                      (size_t)(p.Dh + 1) * p.Dh;
#pragma unroll
      for (int i = 0; i < MTO; ++i) {
        const int nt = ci * MTP + wg + OWNERS * i;
        const int slot = nt % STATE_STAGES;
        // sound as slot is filled for this owner only (the note above)
        rt::mbar_wait(&full[slot], (nt / STATE_STAGES) & 1);
        uint8_t* st = ring + slot * SLOT;
        uint8_t* phi = st + 2 * TILE;
        uint8_t* plo = phi + PAIR_BYTES;
        // G^T's tile as a bf16 pair, transposed into [dv][dk] rows
#pragma unroll
        for (int q2 = 0; q2 < 2; ++q2) {
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            const int h = mi & 1, jj = 2 * q2 + (mi >> 1);
            split2(acc[i][4 * jj + 2 * h], acc[i][4 * jj + 2 * h + 1],
                   hi[mi], lo[mi]);
          }
          const int ml = lane >> 3, r = lane & 7;
          const int dv = 8 * (2 * q2 + (ml >> 1)) + r;
          const int off = dv * 128 + (((2 * warp + (ml & 1)) ^ r) << 4);
          stmatrix_x4_trans(phi + off, hi[0], hi[1], hi[2], hi[3]);
          stmatrix_x4_trans(plo + off, lo[0], lo[1], lo[2], lo[3]);
        }
        rt::fence_async_smem();
        rt::mbar_arrive(&pairf[slot]);
        if (Gc != nullptr) {
          const int j = wg + OWNERS * i;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int dk = 64 * j + 16 * warp + g + 8 * h;
            if (dk < p.Dh) {
#pragma unroll
              for (int jj = 0; jj < 4; ++jj)
#pragma unroll
                for (int e = 0; e < 2; ++e)
                  Gc[(size_t)(dv0 + 8 * jj + 2 * tq + e) * p.Dh + dk] =
                      acc[i][4 * jj + 2 * h + e];
              if (blockIdx.x == 0 && tq == 0)
                Gc[(size_t)p.Dh * p.Dh + dk] = nr[i][h];
            }
          }
        }
        // G^T_j <- g_end G^T_j + Q_j^T (gi o dh)_hi + Q_j^T (gi o dh)_lo,
        // and n_j <- g_end n_j + Q_j^T gn_hi + Q_j^T gn_lo (columns 0, 1)
        float na[4] = {ge * nr[i][0], 0.f, ge * nr[i][1], 0.f};
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[i][e] *= ge;
        rt::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < L / 16; ++kk) {
          const uint64_t da = rt::desc(st + kk * 16 * 128, TILE, 1024);
          wgmma_n32<1>(acc[i], da,
                       rt::desc(buf + BUF_GD + kk * 32, 16, 1024));
          wgmma_n32<1>(acc[i], da,
                       rt::desc(buf + BUF_GD + PAIR_BYTES + kk * 32, 16,
                                1024));
          wgmma_n8<1>(na, da, rt::desc(buf + BUF_GN + kk * 32, 16, 1024));
        }
        rt::wgmma_commit();
        rt::wgmma_wait<0>();
        rt::fence_regs(acc[i]);
        rt::fence_regs(na);
        nr[i][0] = na[0] + na[1];
        nr[i][1] = na[2] + na[3];
        rt::mbar_arrive(&empty[slot]);
      }
      rt::mbar_arrive(&pempty[cb]);
    }
  } else {
    // ---- output: dV of the chunk's L rows, this block's 32 columns -------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(OUT_REGS));
    const bool leader = tid % 128 == 0;
    float H[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) H[i] = 0.f;
    for (int ci = 0; ci < nc; ++ci) {
      const int cb = ci % NB, c = nc - 1 - ci;
      // the state term: H = K G^T (hi + lo) over the tiles
      auto issue = [&](int nt, bool first) {
        const int slot = nt % STATE_STAGES, ph = (nt / STATE_STAGES) & 1;
        rt::mbar_wait(&full[slot], ph);
        rt::mbar_wait(&pairf[slot], ph);
        const uint8_t* st = ring + slot * SLOT;
        const uint8_t* phi = st + 2 * TILE;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t da = rt::desc(st + TILE + kk * 32, 16, 1024);
          wgmma_n32_ss(H, da, rt::desc(phi + kk * 32, 16, 1024),
                       !first || kk > 0);
          wgmma_n32_ss(H, da, rt::desc(phi + PAIR_BYTES + kk * 32, 16, 1024),
                       1);
        }
        rt::wgmma_commit();
      };
      const int nt0 = ci * MTP;
      rt::wgmma_fence();
      issue(nt0, true);
#pragma unroll 1
      for (int j = 1; j < MTP; ++j) {
        issue(nt0 + j, false);
        rt::wgmma_wait<1>();
        if (leader) rt::mbar_arrive(&empty[(nt0 + j - 1) % STATE_STAGES]);
      }
      rt::wgmma_wait<0>();
      rt::fence_regs(H);
      if (leader) rt::mbar_arrive(&empty[(nt0 + MTP - 1) % STATE_STAGES]);

      // dV = w o H + Pi^T dh, Pi^T as a bf16 pair
      rt::mbar_wait(&pfull[cb], (ci / NB) & 1);
      const uint8_t* buf = cbuf + cb * BUF;
      const float* wa = reinterpret_cast<const float*>(buf + BUF_W) + 2 * L;
      const float* pit = reinterpret_cast<const float*>(buf + BUF_PIT);
      const int r0 = 16 * warp + g, r1 = r0 + 8;
      const float w0 = wa[r0], w1 = wa[r1];
#pragma unroll
      for (int i = 0; i < 16; ++i) H[i] *= (i & 2) ? w1 : w0;
#pragma unroll
      for (int k2 = 0; k2 < L / 32; ++k2) {
        uint32_t ph[2][4], pl[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int kk = 2 * k2 + u;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int r = (q & 1) ? r1 : r0;
            const int t = 16 * kk + 2 * tq + 8 * (q >> 1);
            const float2 pv =
                *reinterpret_cast<const float2*>(pit + r * PIT_LD + t);
            split2(pv.x, pv.y, ph[u][q], pl[u][q]);
          }
        }
        rt::wgmma_fence();
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const uint64_t db =
              rt::desc(buf + BUF_DH + (2 * k2 + u) * 32, 16, 1024);
          wgmma_n32_rs(H, ph[u], db);
          wgmma_n32_rs(H, pl[u], db);
        }
        rt::wgmma_commit();
        rt::wgmma_wait<0>();
        rt::fence_regs(H);
        rt::fence_regs(ph);
        rt::fence_regs(pl);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = c * L + r0 + 8 * h;
        if (t < p.T) {
          bf16* dst = p.dv + ((size_t)bh * p.T + t) * p.Dh + dv0 + 2 * tq;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            *reinterpret_cast<uint32_t*>(dst + 8 * jj) =
                rt::pack_bf16(H[4 * jj + 2 * h], H[4 * jj + 2 * h + 1]);
        }
      }
      rt::mbar_arrive(&pempty[cb]);  // done with the chunk's buffer
    }
  }
}

// ---------------------------------------------------------------------------
// the gradients: per (64 columns, output, chunk, head)
// ---------------------------------------------------------------------------

// ROLE 0: dQ^T = (X[:Dh]^T dh^T) o gi + X[Dh] (x) gn + K^T dS^T
// ROLE 1: dK^T = (G[:Dh]^T V^T) o w + G[Dh] (x) w + Q^T dS
// (columns t, rows the block's 64 of Dh)
template <int ROLE>
__device__ __forceinline__ void grad_block(const BwdParams& p, uint8_t* smem,
                                           int tile, int c, int bh) {
  uint8_t* ring = smem;
  uint8_t* qt = ring + GRAD_STAGES * GSLOT;
  uint8_t* kt = qt + TILE;
  uint8_t* dsp = kt + TILE;  // dS's hi, then its lo
  float* sc = reinterpret_cast<float*>(dsp + 2 * TILE);  // gi or w
  float* rk = sc + 64;      // the rank-1 term's weight: gn or w
  float* nrow = rk + 64;    // ... and its values: X's or G's row Dh
  float* red = nrow + 64;   // the row dots' warp shares, 4 x 64
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 4 * 64);
  uint64_t* fixed = full + GRAD_STAGES;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int nc = p.nchunks, t0 = c * L, col0 = COLS * tile;
  // dK's state term is zero on the last chunk, and G is not stored there
  const bool state = ROLE == 0 || c < nc - 1;
  const int nk = state ? (p.Dh + 63) / 64 : 0;
  const int mat = ROLE == 0 ? bh * nc + c : bh * (nc - 1) + c;
  const CUtensorMap* smap = ROLE == 0 ? &p.mxs : &p.mG;
  const CUtensorMap* bmap = ROLE == 0 ? &p.mdh : &p.mv;

  // stage kt: the (dh or V) box of steps t0.. and columns 64 kt.., and the
  // (X or G) tile of rows 64 kt.. and this block's 64 columns
  auto load = [&](int k) {
    uint8_t* st = ring + (k % GRAD_STAGES) * GSLOT;
    uint64_t* bar = &full[k % GRAD_STAGES];
    rt::mbar_expect_tx(bar, GSLOT);
    rt::tma_load_3d(st, bmap, 64 * k, t0, bh, bar);
    rt::tma_load_3d(st + TILE, smap, col0, 64 * k, mat, bar);
    rt::tma_load_3d(st + 2 * TILE, smap, col0 + 32, 64 * k, mat, bar);
  };
  if (tid == 0) {
    for (int s = 0; s < GRAD_STAGES; ++s) rt::mbar_init(&full[s], 1);
    rt::mbar_init(fixed, 1);
    rt::mbar_init_fence();
    rt::mbar_expect_tx(fixed, 4 * TILE);
    rt::tma_load_3d(qt, &p.mq, col0, t0, bh, fixed);
    rt::tma_load_3d(kt, &p.mk, col0, t0, bh, fixed);
    rt::tma_load_3d(dsp, &p.mdS, 0, 0, bh * nc + c, fixed);
    rt::tma_load_3d(dsp + TILE, &p.mdS, 0, L, bh * nc + c, fixed);
    for (int s = 0; s < GRAD_STAGES && s < nk; ++s) load(s);
  }
  if (tid < 64) {
    const float* W = p.W + ((size_t)bh * nc + c) * 4 * L;
    sc[tid] = ROLE == 0 ? W[tid] : W[2 * L + tid];
    rk[tid] = ROLE == 0 ? W[L + tid] : W[2 * L + tid];
    const int col = col0 + tid;
    float nv = 0.f;
    if (state && col < p.Dh)
      nv = (ROLE == 0 ? p.xs : p.G)[((size_t)mat * (p.Dh + 1) + p.Dh) *
                                        p.Dh + col];
    nrow[tid] = nv;
  }
  __syncthreads();

  // the Dh contraction: A = the state tile transposed (64 of Dh x 16 of
  // dv), fp32 from the two swizzled 32-column boxes, split into bf16
  // pairs in registers; B = the (dh or V) box, K-major
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int k = 0; k < nk; ++k) {
    const int s = k % GRAD_STAGES;
    rt::mbar_wait(&full[s], (k / GRAD_STAGES) & 1);
    const uint8_t* st = ring + s * GSLOT;
    uint32_t ahi[4][4], alo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = 16 * warp + g + 8 * (q & 1);      // column of Dh
        const int r = 16 * kk + 2 * tq + 8 * (q >> 1);  // row of the tile
        const uint8_t* box = st + TILE + (m >> 5) * TILE;
        const int cm = m & 31;
        const int word = (cm & 3) << 2;
        const float x0 = *reinterpret_cast<const float*>(
            box + r * 128 + ((((cm >> 2) ^ (r & 7)) << 4) | word));
        const float x1 = *reinterpret_cast<const float*>(
            box + (r + 1) * 128 + ((((cm >> 2) ^ ((r + 1) & 7)) << 4) | word));
        split2(x0, x1, ahi[kk][q], alo[kk][q]);
      }
    rt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = rt::desc(st + kk * 32, 16, 1024);
      rt::Wgmma<64, 0>::rs(acc, ahi[kk], db);
      rt::Wgmma<64, 0>::rs(acc, alo[kk], db);
    }
    rt::wgmma_commit();
    rt::wgmma_wait<0>();
    rt::fence_regs(acc);
    rt::fence_regs(ahi);
    rt::fence_regs(alo);
    __syncthreads();  // every warp is done with the slot
    if (tid == 0 && k + GRAD_STAGES < nk) load(k + GRAD_STAGES);
  }

  // the columns' scale and the rank-1 term: acc[4 jj + 2 h + e] is row
  // 16 warp + g + 8 h (of Dh), column 8 jj + 2 tq + e (the step)
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = 8 * jj + 2 * tq + e, m = 16 * warp + g + 8 * h;
        float& a = acc[4 * jj + 2 * h + e];
        a = a * sc[t] + rk[t] * nrow[m];
      }

  // the L x L term, dS as its bf16 pair: dQ^T += K^T dS^T (dS K-major),
  // dK^T += Q^T dS (dS N-major)
  rt::mbar_wait(fixed, 0);
  const uint8_t* at = ROLE == 0 ? kt : qt;
  rt::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t da = rt::desc(at + kk * 16 * 128, TILE, 1024);
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      const uint8_t* ds = dsp + part * TILE;
      wgmma_n64_tss<ROLE>(acc, da,
                          ROLE == 0 ? rt::desc(ds + kk * 32, 16, 1024)
                                    : rt::desc(ds + kk * 16 * 128, TILE,
                                               1024));
    }
  }
  rt::wgmma_commit();
  rt::wgmma_wait<0>();
  rt::fence_regs(acc);

  // this block's share of the row dots, q . dq or k . dk over its 64
  // columns, in fp32: each thread's two rows, then the eight of its warp
  // (lanes g), then the four warps in order
  const uint8_t* xt = ROLE == 0 ? qt : kt;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = 8 * jj + 2 * tq + e;
      float d = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 16 * warp + g + 8 * h;
        const float x = __bfloat162float(*reinterpret_cast<const bf16*>(
            xt + t * 128 + ((((m >> 3) ^ (t & 7)) << 4) | ((m & 7) << 1))));
        d += x * acc[4 * jj + 2 * h + e];
      }
      d += __shfl_xor_sync(0xffffffffu, d, 4);
      d += __shfl_xor_sync(0xffffffffu, d, 8);
      d += __shfl_xor_sync(0xffffffffu, d, 16);
      if (g == 0) red[warp * 64 + t] = d;
    }

  // the output in bf16: the accumulator transposed into [t][Dh] rows of a
  // swizzled box in the ring (every load has been consumed), then one TMA
  // store, which writes nothing past T or Dh
  uint8_t* ot = ring;
#pragma unroll
  for (int q2 = 0; q2 < 4; ++q2) {
    uint32_t r[4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int h = mi & 1, jj = 2 * q2 + (mi >> 1);
      r[mi] = rt::pack_bf16(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]);
    }
    const int ml = lane >> 3, rr = lane & 7;
    const int t = 8 * (2 * q2 + (ml >> 1)) + rr;
    stmatrix_x4_trans(ot + t * 128 + (((2 * warp + (ml & 1)) ^ rr) << 4),
                      r[0], r[1], r[2], r[3]);
  }
  rt::fence_async_smem();
  __syncthreads();
  if (tid == 0) {
    rt::tma_store_3d(ROLE == 0 ? &p.mdq : &p.mdk, ot, col0, t0, bh);
    rt::tma_store_wait_read();
  }
  if (tid < 64 && t0 + tid < p.T)
    p.dots[(((size_t)bh * 2 + ROLE) * p.tiles + tile) * p.T + t0 + tid] =
        ((red[tid] + red[64 + tid]) + red[128 + tid]) + red[192 + tid];
}

__global__ void __launch_bounds__(128)
    mlstm_bwd_grad_kernel(const __grid_constant__ BwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (rt::smem_addr(smem_raw) & 1023)) & 1023);
  const int tile = blockIdx.x >> 1;
  if (blockIdx.x & 1)
    grad_block<1>(p, smem, tile, blockIdx.y, blockIdx.z);
  else
    grad_block<0>(p, smem, tile, blockIdx.y, blockIdx.z);
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

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// A (mats, rows, cols) tensor of ``type`` (``bytes`` an element), read in
// boxes of 64 rows x ``box`` columns of one matrix; what lies past a
// matrix's edges reads as zeros.
CUresult map_3d(rt::Encode enc, CUtensorMap* map, const void* base,
                CUtensorMapDataType type, int bytes, int mats, int rows,
                int cols, int box, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(mats)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(cols) * bytes,
      static_cast<cuuint64_t>(rows) * static_cast<cuuint64_t>(cols) * bytes};
  const cuuint32_t boxes[3] = {static_cast<cuuint32_t>(box), 64, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return enc(map, type, 3, const_cast<void*>(base), dims, strides, boxes,
             step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// fp32 (Dh + 1) x Dh states in 128-byte swizzled boxes of 32 columns
CUresult make_map_f32(rt::Encode enc, CUtensorMap* map, const void* base,
                      int mats, int rows, int cols) {
  return map_3d(enc, map, base, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, mats,
                rows, cols, 32, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int MTO>
const void* state_fn() {
  return reinterpret_cast<const void*>(&mlstm_bwd_state_kernel<MTO>);
}

const void* state_kernel(int Dh) {
  switch ((Dh + 255) / 256) {
    case 1:
      return state_fn<1>();
    case 2:
      return state_fn<2>();
    case 3:
      return state_fn<3>();
    default:
      return state_fn<4>();
  }
}

// The kernels' dynamic shared memory limits, set once a device; and
// setmaxnreg moves registers within the state pass's allocation, so a
// build whose allocation cannot cover what its groups ask for is refused.
int prepare_device() {
  static std::atomic<unsigned long long> ready{0};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (ready.load() & bit) return 0;
  auto set = [](const void* fn, int bytes) {
    return cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  };
  rc = set(reinterpret_cast<const void*>(&mlstm_bwd_prep_kernel),
           prep_smem_bytes());
  if (rc == cudaSuccess)
    rc = set(reinterpret_cast<const void*>(&mlstm_bwd_grad_kernel),
             grad_smem_bytes());
  for (int Dh = 256; Dh <= 1024 && rc == cudaSuccess; Dh += 256) {
    const void* fn = state_kernel(Dh);
    cudaFuncAttributes attr;
    rc = cudaFuncGetAttributes(&attr, fn);
    if (rc == cudaSuccess &&
        attr.numRegs * THREADS <
            128 * (OWNERS * OWNER_REGS + OUT_REGS + AUX_REGS))
      rc = cudaErrorInvalidConfiguration;
    if (rc == cudaSuccess) rc = set(fn, state_smem_bytes(STATE_STAGES));
  }
  if (rc == cudaSuccess) ready.fetch_or(bit);
  return static_cast<int>(rc);
}

}  // namespace

// q, k, v, dh, dq, dk, dv: (B*H, T, Dh) bf16, 16-byte aligned; ig, fg, di,
// df: (B*H, T) fp32; xs, ms, hf, dn: the training forward's outputs
// (mlstm.cu); scratch: kernels/mlstm.py:bwd_schedule's scratch_bytes of
// fp32, 16-byte aligned.  Returns the first cudaError_t; a tensor map the
// driver refuses returns 1000 + its CUresult.
extern "C" int rt_mlstm_bwd(const void* q, const void* k, const void* v,
                            const void* ig, const void* fg, const void* xs,
                            const void* ms, const void* hf, const void* dn,
                            const void* dh, void* dq, void* dk, void* dv,
                            void* di, void* df, void* scratch, int BH, int T,
                            int Dh, void* stream) {
  if (BH <= 0 || BH > 65535 || T <= 0 || Dh <= 0 || Dh % DV || Dh > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  int rc = prepare_device();
  if (rc) return rc;
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
  p.dv = static_cast<bf16*>(dv);
  p.di = static_cast<float*>(di);
  p.df = static_cast<float*>(df);
  const int nc = (T + L - 1) / L;
  p.T = T, p.Dh = Dh, p.nchunks = nc;
  p.tiles = (Dh + COLS - 1) / COLS;
  p.scale = static_cast<float>(pow(static_cast<double>(Dh), -0.5));
  float* s = static_cast<float*>(scratch);
  p.G = s;
  s += (size_t)BH * (nc - 1) * (Dh + 1) * Dh;
  p.PiT = s;
  s += (size_t)BH * nc * L * L;
  p.dS = reinterpret_cast<bf16*>(s);
  s += (size_t)BH * nc * L * L;  // 2 L^2 bf16
  p.W = s;
  s += (size_t)BH * nc * 4 * L;
  p.dots = s;

  const rt::Encode enc = rt::encode_fn();
  if (!enc) return static_cast<int>(cudaErrorSymbolNotFound);
  CUresult cr = rt::make_map_3d(enc, &p.mq, q, BH, T, Dh, 64);
  if (cr == CUDA_SUCCESS) cr = rt::make_map_3d(enc, &p.mk, k, BH, T, Dh, 64);
  if (cr == CUDA_SUCCESS) cr = rt::make_map_3d(enc, &p.mv, v, BH, T, Dh, 64);
  if (cr == CUDA_SUCCESS)
    cr = rt::make_map_3d(enc, &p.mdh, dh, BH, T, Dh, 64);
  if (cr == CUDA_SUCCESS)  // dh's 32 columns of a state-pass block
    cr = map_3d(enc, &p.mdh32, dh, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, BH,
                T, Dh, 32, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (cr == CUDA_SUCCESS)
    cr = rt::make_map_3d(enc, &p.mdq, dq, BH, T, Dh, 64);
  if (cr == CUDA_SUCCESS)
    cr = rt::make_map_3d(enc, &p.mdk, dk, BH, T, Dh, 64);
  if (cr == CUDA_SUCCESS)
    cr = make_map_f32(enc, &p.mxs, xs, BH * nc, Dh + 1, Dh);
  if (cr == CUDA_SUCCESS && nc > 1)
    cr = make_map_f32(enc, &p.mG, p.G, BH * (nc - 1), Dh + 1, Dh);
  if (cr == CUDA_SUCCESS)
    cr = rt::make_map_3d(enc, &p.mdS, p.dS, BH * nc, 2 * L, L, 64);
  if (cr != CUDA_SUCCESS) return 1000 + static_cast<int>(cr);

  auto st = static_cast<cudaStream_t>(stream);
  void* args[] = {&p};
  rc = static_cast<int>(cudaLaunchKernel(
      reinterpret_cast<const void*>(&mlstm_bwd_prep_kernel), dim3(nc, BH),
      dim3(128), args, prep_smem_bytes(), st));
  if (!rc)
    rc = static_cast<int>(cudaLaunchKernel(
        state_kernel(Dh), dim3(Dh / DV, BH), dim3(THREADS), args,
        state_smem_bytes(STATE_STAGES), st));
  if (!rc)
    rc = static_cast<int>(cudaLaunchKernel(
        reinterpret_cast<const void*>(&mlstm_bwd_grad_kernel),
        dim3(2 * p.tiles, nc, BH), dim3(128), args, grad_smem_bytes(), st));
  if (!rc)
    rc = static_cast<int>(cudaLaunchKernel(
        reinterpret_cast<const void*>(&mlstm_bwd_gate_kernel), dim3(BH),
        dim3(32), args, 0, st));
  return rc;
}

// Dynamic shared memory of the prep (kernel 0), state-pass (1) and
// gradient (2) blocks at head dim Dh (kernels/mlstm.py: prep_smem_bytes,
// state_smem_bytes, grad_smem_bytes must agree), or -1.
extern "C" int rt_mlstm_bwd_smem_bytes(int kernel, int Dh) {
  if (Dh <= 0 || Dh % DV || Dh > 1024) return -1;
  if (kernel == 0) return prep_smem_bytes();
  if (kernel == 1) return state_smem_bytes(STATE_STAGES);
  if (kernel == 2) return grad_smem_bytes();
  return -1;
}

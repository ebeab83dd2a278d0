// Stabilised mLSTM matrix-memory recurrence (xLSTM), chunkwise on the
// tensor cores.
//
// Replaces the TPU kernel repro/kernels/mlstm.py:mlstm_scan and computes
// what it computes, per (batch, head), from C = 0, n = 0, m = 0:
//
//   m_t = max(log sigma(f_t) + m_{t-1}, i_t)
//   C_t = f'_t C_{t-1} + i'_t v_t k_t^T,   n_t = f'_t n_{t-1} + i'_t k_t
//   h_t = C_t q~_t / max(|n_t . q~_t|, exp(-m_t)),   q~_t = q_t Dh^-0.5
//
// with C, n, m in fp32, h_t rounded once to bf16 and (optionally) the
// final C, n and m written out in fp32 (what serving's prefill hands its
// decode steps).  Its training build (template flag TRAIN) also writes what
// the backward (mlstm_bwd.cu) reads: at each chunk's start the fp32 state
// it already holds, C_prev's rows with n_prev as row Dh and m_prev, and at
// each step the fp32 h before its rounding and the denominator with the
// sign h took through it (+1 or -1 where |n . q~| won, 0 where the floor
// did); B H ceil(T / L) (Dh + 1) Dh 4 bytes of states.
//
// The chunkwise form.  Inside a chunk of L steps (chunks anchored at
// t = 0), with b_t the in-chunk cumulative sum of log sigma(f) and m_t the
// reference's own recurrence, the stabilised recurrence unrolls exactly to
//   C_t = g_t C_prev + sum_{s<=t} D[t,s] v_s k_s^T,
//   g_t = exp(b_t + m_prev - m_t),  D[t,s] = exp(b_t - b_s + i_s - m_t),
// every weight <= 1.  So h's numerator is g_t (Q C_prev^T)[t] + ((S o D)
// V)[t] with S = Q~ K^T, its denominator the same with n for C (n rides
// along as one more row of C, V as one more column of ones), and the
// state at the chunk's end is C^T <- g C^T + K^T (w o V), w_s = D[L-1, s].
// Operations a step and head: 4 Dh^2 + 4 L Dh, all on the tensor cores.
//
// Precision.  q, k and v are bf16 already and enter the products as they
// are.  Every fp32 operand -- the state C_prev (and n) in Q C_prev^T,
// S o D in (S o D) V, w o V and w in the state update -- enters as a bf16
// pair, hi = bf16(x), lo = bf16(x - hi), two products into one fp32
// accumulator: rounded once to bf16 the state misses its 1e-3 tolerance
// several times over (kernels/mlstm.py:chunkwise_model, split=False).
// The function bounds it at 4 Dh^2 + 4 L Dh operations a step and head:
// at B = 1, H = 4, T = 2048, Dh = 1024 37 GFLOP, 0.037 ms at 989 TFLOP/s
// (its bytes, 84 MB, take 0.025 ms).  This design does more: the pairs
// make 8 Dh^2 + 6 L Dh operations (0.073 ms), and the Q K^T scratch adds
// 4 MB of traffic.  What holds it on the card is shared memory's bandwidth
// and the products' latency, not the tensor cores: the products are 32
// to 40 columns wide, so each re-reads its A operand for little work
// (PERF.md).
//
// Design.  A call is two kernels.
// * mlstm_qk_kernel: S = Q K^T of every chunk (fp32, L x L, 4 L^2 bytes a
//   chunk and head into a scratch), one block per 64 rows of a chunk:
//   a TMA ring of Q and K tiles 64 columns wide, wgmma m64nLk16.
// * mlstm_scan_kernel: one block per 32 columns of one head's C (grid
//   Dh / 32 x B * H: 128 blocks at B * H = 4, Dh = 1024), the chunks in
//   order.  The block keeps its slice C^T[dk, dv0..dv0+32) as fp32 wgmma
//   accumulators (M runs over dk) in four "owner" warpgroups, each holding
//   the 64-row tiles j = owner + 4 i of C^T's Dh rows (padded to a
//   multiple of 256; the rows past Dh stay zero), and n's matching rows
//   as the column of an m64n8 accumulator.  Per chunk and 64-row tile j,
//   through a TMA ring of (Q_j, K_j) tiles 64 columns wide:
//   - the owner writes C^T's tile j (C_prev) as a bf16 pair into the
//     ring slot (stmatrix.trans into wgmma's K-major B layout, n as row
//     32), then runs the update C^T_j <- g C^T_j + K_j^T (w o V)_hi +
//     K_j^T (w o V)_lo and n_j <- g n_j + K_j^T w_hi + K_j^T w_lo (wgmma
//     m64n32k16 and m64n8k16, K_j^T read M-major through the descriptor's
//     transpose bit);
//   - the output warpgroup accumulates Q_j C_prev^T (hi and lo,
//     m64n40k16: 32 columns and n) over the tiles, then, with the chunk's
//     S from the scratch, forms S o D as a bf16 pair in registers and adds
//     (S o D) [V | 1] (wgmma with A from registers), and writes h.
//   - the aux warpgroup: one thread issues the TMA loads; three warps
//     stage the gates and V with cp.async a chunk ahead and run the gate
//     scan (m step by step, as the reference computes it, in every lane
//     of one warp on values passed by shuffles; b; the weights; w o V and
//     w split into their pairs; V with its ones row) into one of two
//     chunk buffers, a chunk ahead.
//     The ring's depth is a multiple of the four owners (four: eight do
//     not fit), so that slot s only ever holds owner s mod 4's tiles (tile
//     nt belongs to owner nt mod 4).  An owner waits on its slot's full
//     barrier by phase parity, which is sound only if the slot's previous
//     tile was its own, one it has waited for: with any other depth the
//     slot's previous tile is another owner's, TMA may complete it after
//     the waiting owner's own, the barrier is then a phase behind with
//     the parity waited for, and the wait passes on a slot TMA is still
//     filling (at six stages the backward's state pass, this kernel's
//     shape, gave other bits and then a launch failure on the card; two
//     and three stages faulted here).
//   Registers bound the slice: 64 accumulators a thread at Dh = 1024;
//   setmaxnreg gives the owners 96, the output group 64 and the aux 32.
//   (A 128-step chunk was slower at every measured shape: PERF.md.)
// * Steps past T in the last chunk, like a bucket's padding (i = -inf,
//   f = +inf), have zero weights and change no state: a padded scan's
//   state and h equal the unpadded scan's bit for bit.  No atomics: two
//   launches are bit-identical.
#include "mlstm.cuh"  // hopper.cuh, and the helpers shared with mlstm_bwd.cu

#include <math.h>

namespace {

using rt::bf16;

constexpr int OWNERS = 4;
constexpr int THREADS = 128 * (OWNERS + 2);  // owners, output, aux
constexpr int DV = 32;                       // columns of C a block owns
constexpr int MAX_STAGES = 8;
constexpr int QK_STAGES = 4;
constexpr int PAIR_ROWS = 40;  // a pair tile: 32 columns of C, n, 7 zeros
constexpr int PAIR_BYTES = PAIR_ROWS * 128;
// registers a thread after setmaxnreg: the block's allocation at launch is
// 80 a thread (768 threads), 61,440 in all, moved to where the state is
constexpr int OWNER_REGS = 96;
constexpr int PREP_THREADS = 96;  // the aux group's three gate-scan warps

template <int L>
struct Cfg {
  static_assert(L == 64, "the kernels take chunks of 64 steps");
  static constexpr int BOXES = L / 64;          // 64-step boxes a chunk
  static constexpr int TILE = L * 128;          // a Q or K tile (L x 64)
  static constexpr int SLOT = 2 * TILE + 2 * PAIR_BYTES;
  static constexpr int WV = BOXES * DV * 128;   // w o V's hi or lo
  static constexpr int VX = BOXES * PAIR_BYTES; // V with its ones row
  static constexpr int WP = BOXES * 1024;       // w's pair, 8 rows
  static constexpr int CHUNK = 2 * WV + VX + WP;  // a chunk's operands
  static constexpr int ARR = (5 * L + 2 + 2) * 4;  // ... its weights (16 B)
  static constexpr int STG = 2 * L * 4 + L * DV * 2;  // staged i, f, V
  // chunk buffers: two, so that the gate scan runs a chunk ahead
  static constexpr int NB = 2;
  // the output group holds 64 x L of h; what it gives up goes to the aux
  static constexpr int OUT_REGS = 64;
  static constexpr int AUX_REGS = 32;
  static constexpr int smem_bytes(int stages) {
    return 1024 + stages * SLOT + NB * (CHUNK + ARR + STG) + 256;
  }
  static constexpr int qk_smem_bytes() {
    return 1024 + QK_STAGES * (64 * 128 + TILE) + 256;
  }
};

struct Params {
  CUtensorMap q, k;  // (Dh, T, B * H) bf16, boxes of L rows x 64, swizzled
  const bf16* v;
  const float* ig;
  const float* fg;
  const float* S;  // Q K^T of every chunk, (B * H, chunks, L, L) fp32
  bf16* h;
  float* c_out;  // final C (B * H, Dh, Dh), n (B * H, Dh), m (B * H), or
  float* n_out;  // null
  float* m_out;
  // the training build's: states (B * H, chunks, Dh + 1, Dh), m0 (B * H,
  // chunks), hf (B * H, T, Dh), den (B * H, T, 2), all fp32
  float* xs;
  float* ms;
  float* hf;
  float* dn;
  int T, Dh, nchunks, stages;
  float scale;
};

struct QkParams {
  CUtensorMap q, k;  // boxes of 64 and of L rows x 64
  float* S;
  int T, Dh, nchunks;
};

// 4-byte asynchronous copy global -> shared, zero-filled when !pred
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   rt::smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

#define ACC8(d, i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 40) (+)= A (64 x 16) @ B (16 x 40), A K-major and B K-major from
// shared memory; d is overwritten where scale_d is 0.
__device__ __forceinline__ void wgmma_n40_ss(float (&d)[20], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19"
      "}, %20, %21, p, 1, 1, 0, 0;\n}\n"
      : ACC8(d, 0), ACC8(d, 8), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 40) += A (64 x 16, registers, mma.sync's A-fragment layout) @
// B (16 x 40, K-major, shared memory).
__device__ __forceinline__ void wgmma_n40_rs(float (&d)[20],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19"
      "}, {%20, %21, %22, %23}, %24, p, 1, 1, 0;\n}\n"
      : ACC8(d, 0), ACC8(d, 8), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef ACC8

// the Q K^T kernel: S[t, s] = sum_d q[t, d] k[s, d] of rows [64 half,
// 64 half + 64) of one chunk, in fp32 (unscaled)
template <int L>
__global__ void __launch_bounds__(128, 1)
    mlstm_qk_kernel(const __grid_constant__ QkParams p) {
  using C = Cfg<L>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (rt::smem_addr(smem_raw) & 1023)) & 1023);
  constexpr int STAGE = 64 * 128 + C::TILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + QK_STAGES * STAGE);

  const int half = blockIdx.x % C::BOXES;
  const int rest = blockIdx.x / C::BOXES;
  const int c = rest % p.nchunks, bh = rest / p.nchunks;
  const int tiles = (p.Dh + 63) / 64;
  const int tid = threadIdx.x;

  auto load = [&](int j) {
    uint8_t* st = smem + (j % QK_STAGES) * STAGE;
    uint64_t* bar = &full[j % QK_STAGES];
    rt::mbar_expect_tx(bar, STAGE);
    rt::tma_load_3d(st, &p.q, 64 * j, c * L + 64 * half, bh, bar);
    rt::tma_load_3d(st + 64 * 128, &p.k, 64 * j, c * L, bh, bar);
  };
  if (tid == 0) {
    for (int s = 0; s < QK_STAGES; ++s) rt::mbar_init(&full[s], 1);
    rt::mbar_init_fence();
    for (int j = 0; j < QK_STAGES && j < tiles; ++j) load(j);
  }
  __syncthreads();

  float acc[L / 2];
  for (int j = 0; j < tiles; ++j) {
    rt::mbar_wait(&full[j % QK_STAGES], (j / QK_STAGES) & 1);
    const uint8_t* st = smem + (j % QK_STAGES) * STAGE;
    rt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      rt::Wgmma<L, 0>::ss(acc, rt::desc(st + kk * 32, 16, 1024),
                          rt::desc(st + 64 * 128 + kk * 32, 16, 1024),
                          (j | kk) != 0);
    rt::wgmma_commit();
    rt::wgmma_wait<0>();
    rt::fence_regs(acc);
    __syncthreads();  // every warp is done with the slot
    if (tid == 0 && j + QK_STAGES < tiles) load(j + QK_STAGES);
  }

  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, tq = lane & 3;
  float* out = p.S + ((size_t)bh * p.nchunks + c) * L * L;
#pragma unroll
  for (int jn = 0; jn < L / 8; ++jn)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 64 * half + 16 * warp + g + 8 * h;
      *reinterpret_cast<float2*>(out + (size_t)r * L + 8 * jn + 2 * tq) =
          make_float2(acc[4 * jn + 2 * h], acc[4 * jn + 2 * h + 1]);
    }
}

template <int L, int MTO, bool TRAIN>
__global__ void __launch_bounds__(THREADS, 1)
    mlstm_scan_kernel(const __grid_constant__ Params p) {
  using C = Cfg<L>;
  constexpr int MTP = OWNERS * MTO;  // 64-row tiles of C^T
  constexpr int NH = L / 64;         // 64-row halves of a chunk
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (rt::smem_addr(smem_raw) & 1023)) & 1023);
  // 1 KB-aligned: the ring, the two chunk buffers (w o V's pair, V with its
  // ones row, w's pair); then each chunk's weights, the staged gates and V
  // of two chunks, and the mbarriers
  uint8_t* ring = smem;
  uint8_t* cbuf = ring + p.stages * C::SLOT;
  float* arrs = reinterpret_cast<float*>(cbuf + C::NB * C::CHUNK);
  uint8_t* stg = reinterpret_cast<uint8_t*>(arrs) + C::NB * C::ARR;
  uint64_t* bars = reinterpret_cast<uint64_t*>(stg + C::NB * C::STG);
  uint64_t* full = bars;                   // a slot's Q and K landed
  uint64_t* empty = bars + MAX_STAGES;     // its owner and output are done
  uint64_t* pairf = bars + 2 * MAX_STAGES; // its C_prev pair is written
  uint64_t* pfull = bars + 3 * MAX_STAGES; // a chunk buffer is written
  uint64_t* pempty = pfull + 2;            // ... and used

  const int bh = blockIdx.y;
  const int dv0 = blockIdx.x * DV;
  const int tid = threadIdx.x, wg = tid / 128;
  const int warp = tid / 32 % 4, lane = tid % 32, g = lane >> 2,
            tq = lane & 3;

  // constant rows: the pair tiles' rows 33..39, V's rows 33..39 and w's
  // rows 2..7 stay zero, V's row 32 stays one
  for (int i = tid; i < p.stages * 2 * PAIR_BYTES / 16; i += THREADS) {
    const int s = i / (2 * PAIR_BYTES / 16), o = i % (2 * PAIR_BYTES / 16);
    reinterpret_cast<uint4*>(ring + s * C::SLOT + 2 * C::TILE)[o] =
        make_uint4(0, 0, 0, 0);
  }
  for (int i = tid; i < C::NB * C::BOXES * 64; i += THREADS) {
    const int b = i / (C::BOXES * 64), o = i % (C::BOXES * 64);
    const uint32_t one = o % 64 < 8 ? 0x3f803f80u : 0u;  // row 32: 1.0
    uint8_t* buf = cbuf + b * C::CHUNK;
    reinterpret_cast<uint4*>(buf + 2 * C::WV + o / 64 * PAIR_BYTES +
                             32 * 128)[o % 64] =
        make_uint4(one, one, one, one);
    reinterpret_cast<uint4*>(buf + 2 * C::WV + C::VX + o / 64 * 1024)
        [o % 64] = make_uint4(0, 0, 0, 0);
  }
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      rt::mbar_init(&full[s], 1);
      rt::mbar_init(&empty[s], 128 + 1);  // the owner's threads, output
      rt::mbar_init(&pairf[s], 128);      // the owner's threads
    }
    for (int b = 0; b < C::NB; ++b) {
      rt::mbar_init(&pfull[b], PREP_THREADS);
      rt::mbar_init(&pempty[b], (OWNERS + 1) * 128);
    }
    rt::mbar_init_fence();
  }
  rt::fence_async_smem();
  __syncthreads();

  const int nt_total = p.nchunks * MTP;

  if (wg == OWNERS + 1) {
    // ---- aux: the producer thread and the gate scan ---------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::AUX_REGS));
    if (warp == 0) {
      if (lane == 0) {
        for (int n = 0; n < nt_total; ++n) {
          const int slot = n % p.stages, use = n / p.stages;
          const int c = n / MTP, j = n % MTP;
          rt::mbar_wait(&empty[slot], (use & 1) ^ 1);
          uint8_t* st = ring + slot * C::SLOT;
          rt::mbar_expect_tx(&full[slot], 2 * C::TILE);
          rt::tma_load_3d(st, &p.q, 64 * j, c * L, bh, &full[slot]);
          rt::tma_load_3d(st + C::TILE, &p.k, 64 * j, c * L, bh,
                          &full[slot]);
        }
      }
    } else {
      const int pt = tid - (OWNERS + 1) * 128 - 32;  // 0 .. 95
      float m_run = 0.f;  // the running m, in every lane of the first warp
      const size_t gbase = (size_t)bh * p.T;
      // i, f and this block's 32 columns of V for chunk c, staged in
      // shared memory a chunk ahead (zero past T)
      auto stage = [&](int c) {
        uint8_t* sb = stg + (c % C::NB) * C::STG;
        const int t0 = c * L;
        for (int u = pt; u < L; u += PREP_THREADS) {
          const bool ok = t0 + u < p.T;
          const size_t src = gbase + (ok ? t0 + u : 0);
          cp_async4(sb + 4 * u, p.ig + src, ok);
          cp_async4(sb + 4 * (L + u), p.fg + src, ok);
        }
        for (int u = pt; u < 4 * L; u += PREP_THREADS) {
          const int r = u / 4, part = u % 4;
          const bool ok = t0 + r < p.T;
          rt::cp_async16(sb + 8 * L + r * DV * 2 + part * 16,
                         p.v + (gbase + (ok ? t0 + r : 0)) * p.Dh + dv0 +
                             8 * part,
                         ok);
        }
        rt::cp_async_commit();
      };
      stage(0);
      for (int c = 0; c < p.nchunks; ++c) {
        const int cb = c % C::NB, t0 = c * L;
        rt::mbar_wait(&pempty[cb], ((c / C::NB) & 1) ^ 1);
        // stage the next chunk while this one is read
        rt::named_barrier(1, PREP_THREADS);  // its buffer is read
        if (c + 1 < p.nchunks)
          stage(c + 1);
        else
          rt::cp_async_commit();
        rt::cp_async_wait<C::NB - 1>();  // chunk c's stage has landed
        rt::named_barrier(1, PREP_THREADS);
        const uint8_t* sb = stg + cb * C::STG;
        const float* si = reinterpret_cast<const float*>(sb);
        const bf16* sv = reinterpret_cast<const bf16*>(sb + 8 * L);
        uint8_t* buf = cbuf + cb * C::CHUNK;
        float* arr = arrs + cb * (C::ARR / 4);
        float* wts = arr + 4 * L;
        if (pt < 32) {
          // the gate scan: lane l holds steps l, l + 32, ...; every lane
          // runs the chain (m step by step as the reference computes it,
          // b the in-chunk sum) on values passed by shuffles, and keeps
          // b and m at its own steps
          constexpr int PER = L / 32;
          float li[PER], ll[PER], mb[PER], mv[PER];
#pragma unroll
          for (int r = 0; r < PER; ++r) {
            const int u = 32 * r + lane;
            const bool ok = t0 + u < p.T;
            li[r] = ok ? si[u] : -INFINITY;
            ll[r] = ok ? log_sigmoid(si[L + u]) : 0.f;
          }
          const float m_prev = m_run;
          if (TRAIN && pt == 0 && blockIdx.x == 0)
            p.ms[(size_t)bh * p.nchunks + c] = m_prev;
          float bb = 0.f, mm = m_run;
#pragma unroll
          for (int r = 0; r < PER; ++r)
#pragma unroll 4
            for (int l = 0; l < 32; ++l) {
              const float lf = __shfl_sync(0xffffffffu, ll[r], l);
              const float iv = __shfl_sync(0xffffffffu, li[r], l);
              bb += lf;
              mm = fmaxf(lf + mm, iv);
              if (l == lane) {
                mb[r] = bb;
                mv[r] = mm;
              }
            }
          m_run = mm;
          const float b_end = bb, m_end = mm;
          uint8_t* wp = buf + 2 * C::WV + C::VX;
#pragma unroll
          for (int r = 0; r < PER; ++r) {
            const int u = 32 * r + lane;
            const float b = mb[r], m = mv[r], e = li[r] - b;
            arr[u] = b - m;                                  // a_t
            arr[L + u] = e;                                  // e_s
            arr[2 * L + u] = p.scale * expf(b + m_prev - m); // scaled g_t
            arr[3 * L + u] = expf(-m);                       // floor
            const float w = expf(e + (b_end - m_end));       // w_s
            wts[u] = w;
            // w's pair: rows 0 (hi) and 1 (lo) of an 8-row K-major tile,
            // 16-byte chunk u / 8 of row r at chunk (u / 8) ^ r
            const bf16 wh = __float2bfloat16(w);
            const int ch = u % 64 / 8, at = u / 64 * 1024 + u % 8 * 2;
            *reinterpret_cast<bf16*>(wp + at + (ch << 4)) = wh;
            *reinterpret_cast<bf16*>(wp + at + 128 + ((ch ^ 1) << 4)) =
                __float2bfloat16(w - __bfloat162float(wh));
          }
          if (pt == 0) arr[5 * L] = expf(b_end + m_prev - m_end);  // g
        }
        rt::named_barrier(1, PREP_THREADS);
        // w o V as a bf16 pair and V itself, K-major [dv][s]: lane = dv,
        // eight steps a 16-byte store
        for (int sg = pt / 32; sg < L / 8; sg += PREP_THREADS / 32) {
          uint32_t hi[4], lo[4], vx[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int s0 = 8 * sg + 2 * r;
            const float v0 = __bfloat162float(sv[s0 * DV + lane]);
            const float v1 = __bfloat162float(sv[(s0 + 1) * DV + lane]);
            split2(wts[s0] * v0, wts[s0 + 1] * v1, hi[r], lo[r]);
            vx[r] = rt::pack_bf16(v0, v1);
          }
          const int box = sg / 8, ch = (sg % 8) ^ (lane & 7);
          const int off = lane * 128 + ch * 16;
          *reinterpret_cast<uint4*>(buf + box * DV * 128 + off) =
              make_uint4(hi[0], hi[1], hi[2], hi[3]);
          *reinterpret_cast<uint4*>(buf + C::WV + box * DV * 128 + off) =
              make_uint4(lo[0], lo[1], lo[2], lo[3]);
          *reinterpret_cast<uint4*>(buf + 2 * C::WV + box * PAIR_BYTES +
                                    off) = make_uint4(vx[0], vx[1], vx[2],
                                                      vx[3]);
        }
        rt::fence_async_smem();
        rt::mbar_arrive(&pfull[cb]);
      }
      if (pt == 0 && p.c_out != nullptr && blockIdx.x == 0)
        p.m_out[bh] = m_run;
    }
  } else if (wg < OWNERS) {
    // ---- owners: C^T's tiles j = wg + 4 i, n beside them -----------------
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
    for (int c = 0; c < p.nchunks; ++c) {
      const int cb = c % C::NB;
      rt::mbar_wait(&pfull[cb], (c / C::NB) & 1);
      const uint8_t* buf = cbuf + cb * C::CHUNK;
      const uint8_t* wp = buf + 2 * C::WV + C::VX;
      const float gc = arrs[cb * (C::ARR / 4) + 5 * L];
#pragma unroll
      for (int i = 0; i < MTO; ++i) {
        const int nt = c * MTP + wg + OWNERS * i;
        const int slot = nt % p.stages;
        // sound only with stages a multiple of OWNERS: tile nt - stages,
        // the slot's previous use, is then this owner's own and has
        // landed, or a barrier one phase behind shows the parity waited
        // for
        rt::mbar_wait(&full[slot], (nt / p.stages) & 1);
        uint8_t* st = ring + slot * C::SLOT;
        uint8_t* phi = st + 2 * C::TILE;
        uint8_t* plo = phi + PAIR_BYTES;
        // C_prev's tile as a bf16 pair, transposed into [dv][dk] rows
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
        // ... and n_prev as row 32
        if (tq == 0) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int dk = 16 * warp + g + 8 * h;
            const int off = 32 * 128 + (dk >> 3) * 16 + (dk & 7) * 2;
            const bf16 nh = __float2bfloat16(nr[i][h]);
            *reinterpret_cast<bf16*>(phi + off) = nh;
            *reinterpret_cast<bf16*>(plo + off) =
                __float2bfloat16(nr[i][h] - __bfloat162float(nh));
          }
        }
        rt::fence_async_smem();
        rt::mbar_arrive(&pairf[slot]);
        if constexpr (TRAIN) {  // C_prev's tile and n_prev, for the backward
          const int j = wg + OWNERS * i;
          float* xc = p.xs + ((size_t)bh * p.nchunks + c) * (p.Dh + 1) * p.Dh;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int dk = 64 * j + 16 * warp + g + 8 * h;
            if (dk < p.Dh) {
#pragma unroll
              for (int jj = 0; jj < 4; ++jj)
#pragma unroll
                for (int e = 0; e < 2; ++e)
                  xc[(size_t)(dv0 + 8 * jj + 2 * tq + e) * p.Dh + dk] =
                      acc[i][4 * jj + 2 * h + e];
              if (blockIdx.x == 0 && tq == 0)
                xc[(size_t)p.Dh * p.Dh + dk] = nr[i][h];
            }
          }
        }
        // C^T_j <- g C^T_j + K_j^T (w o V)_hi + K_j^T (w o V)_lo, and
        // n_j <- g n_j + K_j^T w_hi + K_j^T w_lo (columns 0 and 1)
        float na[4] = {gc * nr[i][0], 0.f, gc * nr[i][1], 0.f};
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[i][e] *= gc;
        rt::wgmma_fence();
        const uint8_t* kt = st + C::TILE;
#pragma unroll
        for (int kk = 0; kk < L / 16; ++kk) {
          const uint64_t da = rt::desc(kt + kk * 16 * 128, C::TILE, 1024);
          const int wo = kk / 4 * DV * 128 + kk % 4 * 32;
          wgmma_n32<1>(acc[i], da, rt::desc(buf + wo, 16, 1024));
          wgmma_n32<1>(acc[i], da, rt::desc(buf + C::WV + wo, 16, 1024));
          wgmma_n8<1>(na, da,
                      rt::desc(wp + kk / 4 * 1024 + kk % 4 * 32, 16, 1024));
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
    if (p.c_out != nullptr) {
#pragma unroll
      for (int i = 0; i < MTO; ++i) {
        const int j = wg + OWNERS * i;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int dk = 64 * j + 16 * warp + g + 8 * h;
              const int dv = dv0 + 8 * jj + 2 * tq + e;
              if (dk < p.Dh)
                p.c_out[((size_t)bh * p.Dh + dv) * p.Dh + dk] =
                    acc[i][4 * jj + 2 * h + e];
            }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int dk = 64 * j + 16 * warp + g + 8 * h;
          if (blockIdx.x == 0 && tq == 0 && dk < p.Dh)
            p.n_out[(size_t)bh * p.Dh + dk] = nr[i][h];
        }
      }
    }
  } else {
    // ---- output: h of the chunk's L rows, this block's 32 columns -------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::OUT_REGS));
    const bool leader = tid % 128 == 0;
    float H[NH][20];
#pragma unroll
    for (int mh = 0; mh < NH; ++mh)
#pragma unroll
      for (int i = 0; i < 20; ++i) H[mh][i] = 0.f;
    for (int c = 0; c < p.nchunks; ++c) {
      const int cb = c % C::NB;
      // inter-chunk: H = Q C_prev^T (hi + lo), n's column 32 beside it
      auto issue = [&](int nt, bool first) {
        const int slot = nt % p.stages, ph = (nt / p.stages) & 1;
        rt::mbar_wait(&full[slot], ph);
        rt::mbar_wait(&pairf[slot], ph);
        const uint8_t* st = ring + slot * C::SLOT;
        const uint8_t* phi = st + 2 * C::TILE;
#pragma unroll
        for (int mh = 0; mh < NH; ++mh)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t da =
                rt::desc(st + mh * 64 * 128 + kk * 32, 16, 1024);
            wgmma_n40_ss(H[mh], da, rt::desc(phi + kk * 32, 16, 1024),
                         !first || kk > 0);
            wgmma_n40_ss(H[mh], da,
                         rt::desc(phi + PAIR_BYTES + kk * 32, 16, 1024), 1);
          }
        rt::wgmma_commit();
      };
      const int nt0 = c * MTP;
      rt::wgmma_fence();
      issue(nt0, true);
#pragma unroll 1
      for (int j = 1; j < MTP; ++j) {
        issue(nt0 + j, false);
        rt::wgmma_wait<1>();
        if (leader) rt::mbar_arrive(&empty[(nt0 + j - 1) % p.stages]);
      }
      rt::wgmma_wait<0>();
#pragma unroll
      for (int mh = 0; mh < NH; ++mh) rt::fence_regs(H[mh]);
      if (leader) rt::mbar_arrive(&empty[(nt0 + MTP - 1) % p.stages]);

      // intra-chunk: H = g~_t H + (S o D) [V | 1], S o D as a bf16 pair
      rt::mbar_wait(&pfull[cb], (c / C::NB) & 1);
      const uint8_t* vx = cbuf + cb * C::CHUNK + 2 * C::WV;
      const float* arr = arrs + cb * (C::ARR / 4);
      const float* S = p.S + ((size_t)bh * p.nchunks + c) * L * L;
#pragma unroll
      for (int mh = 0; mh < NH; ++mh) {
        const int r0 = 64 * mh + 16 * warp + g, r1 = r0 + 8;
        const float a0 = arr[r0], a1 = arr[r1];
        const float gq0 = arr[2 * L + r0], gq1 = arr[2 * L + r1];
#pragma unroll
        for (int i = 0; i < 20; ++i) H[mh][i] *= (i & 2) ? gq1 : gq0;
        // KG k16 steps at a time (fewer registers where H is two tiles)
        constexpr int KG = NH == 1 ? 2 : 1;
#pragma unroll
        for (int k2 = 0; k2 < L / (16 * KG); ++k2) {
          uint32_t ph[KG][4], pl[KG][4];
#pragma unroll
          for (int u = 0; u < KG; ++u) {
            const int kk = KG * k2 + u;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int r = (q & 1) ? r1 : r0;
              const int s = 16 * kk + 2 * tq + 8 * (q >> 1);
              const float2 sv =
                  *reinterpret_cast<const float2*>(S + (size_t)r * L + s);
              const float ar = (q & 1) ? a1 : a0;
              // exponents <= 0 up to rounding: the fast exponential's
              // relative error (about 1e-6 here) is far inside h's
              const float d0 =
                  s <= r ? p.scale * __expf(ar + arr[L + s]) : 0.f;
              const float d1 =
                  s + 1 <= r ? p.scale * __expf(ar + arr[L + s + 1]) : 0.f;
              split2(sv.x * d0, sv.y * d1, ph[u][q], pl[u][q]);
            }
          }
          rt::wgmma_fence();
#pragma unroll
          for (int u = 0; u < KG; ++u) {
            const int kk = KG * k2 + u;
            const uint64_t db = rt::desc(
                vx + kk / 4 * PAIR_BYTES + kk % 4 * 32, 16, 1024);
            wgmma_n40_rs(H[mh], ph[u], db);
            wgmma_n40_rs(H[mh], pl[u], db);
          }
          rt::wgmma_commit();
          rt::wgmma_wait<0>();
          rt::fence_regs(H[mh]);
          rt::fence_regs(ph);
          rt::fence_regs(pl);
        }
      }
      // h = H[:, :32] / max(|H[:, 32]|, exp(-m_t)), rounded to bf16
#pragma unroll
      for (int mh = 0; mh < NH; ++mh)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 64 * mh + 16 * warp + g + 8 * h;
          const float nq =
              __shfl_sync(0xffffffffu, H[mh][16 + 2 * h], lane & ~3);
          const float floor_t = arr[3 * L + r];
          const float den = fmaxf(fabsf(nq), floor_t);
          const int t = c * L + r;
          if (t < p.T) {
            bf16* dst = p.h + ((size_t)bh * p.T + t) * p.Dh + dv0 + 2 * tq;
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              *reinterpret_cast<uint32_t*>(dst + 8 * jj) = rt::pack_bf16(
                  H[mh][4 * jj + 2 * h] / den,
                  H[mh][4 * jj + 2 * h + 1] / den);
            if constexpr (TRAIN) {  // h in fp32, den and its sign
              float* hd = p.hf + ((size_t)bh * p.T + t) * p.Dh + dv0 + 2 * tq;
#pragma unroll
              for (int jj = 0; jj < 4; ++jj)
                *reinterpret_cast<float2*>(hd + 8 * jj) =
                    make_float2(H[mh][4 * jj + 2 * h] / den,
                                H[mh][4 * jj + 2 * h + 1] / den);
              if (blockIdx.x == 0 && tq == 0)
                *reinterpret_cast<float2*>(p.dn + ((size_t)bh * p.T + t) * 2) =
                    make_float2(den, fabsf(nq) > floor_t ? copysignf(1.f, nq)
                                                         : 0.f);
            }
          }
        }
      rt::mbar_arrive(&pempty[cb]);  // done with the chunk's buffer
    }
  }
}

template <int L, int MTO, bool TRAIN>
int launch_scan(Params& p, int BH, cudaStream_t stream) {
  const void* fn =
      reinterpret_cast<const void*>(&mlstm_scan_kernel<L, MTO, TRAIN>);
  // setmaxnreg moves registers within the block's allocation: refuse to
  // launch a build whose allocation cannot cover what the groups ask for
  cudaFuncAttributes attr;
  cudaError_t rc = cudaFuncGetAttributes(&attr, fn);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (attr.numRegs * THREADS <
      128 * (OWNERS * OWNER_REGS + Cfg<L>::OUT_REGS + Cfg<L>::AUX_REGS))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int smem = Cfg<L>::smem_bytes(p.stages);
  rc = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            smem);
  void* args[] = {&p};
  if (rc == cudaSuccess)
    rc = cudaLaunchKernel(fn, dim3(p.Dh / DV, BH), dim3(THREADS), args, smem,
                          stream);
  return static_cast<int>(rc);
}

template <int L, bool TRAIN>
int launch_mto(Params& p, int BH, cudaStream_t stream) {
  switch ((p.Dh + 255) / 256) {
    case 1:
      return launch_scan<L, 1, TRAIN>(p, BH, stream);
    case 2:
      return launch_scan<L, 2, TRAIN>(p, BH, stream);
    case 3:
      return launch_scan<L, 3, TRAIN>(p, BH, stream);
    default:
      return launch_scan<L, 4, TRAIN>(p, BH, stream);
  }
}

template <int L>
int launch(const void* q, const void* k, Params& p, int BH,
           cudaStream_t stream) {
  const rt::Encode enc = rt::encode_fn();
  if (!enc) return static_cast<int>(cudaErrorSymbolNotFound);
  QkParams qp{};
  CUresult cr = rt::make_map_3d(enc, &qp.q, q, BH, p.T, p.Dh, 64);
  if (cr == CUDA_SUCCESS)
    cr = rt::make_map_3d(enc, &qp.k, k, BH, p.T, p.Dh, L);
  if (cr == CUDA_SUCCESS)
    cr = rt::make_map_3d(enc, &p.q, q, BH, p.T, p.Dh, L);
  if (cr == CUDA_SUCCESS) p.k = qp.k;
  if (cr != CUDA_SUCCESS) return 1000 + static_cast<int>(cr);
  qp.S = const_cast<float*>(p.S);
  qp.T = p.T, qp.Dh = p.Dh, qp.nchunks = p.nchunks;

  const void* qk = reinterpret_cast<const void*>(&mlstm_qk_kernel<L>);
  const int qk_smem = Cfg<L>::qk_smem_bytes();
  cudaError_t rc = cudaFuncSetAttribute(
      qk, cudaFuncAttributeMaxDynamicSharedMemorySize, qk_smem);
  void* qargs[] = {&qp};
  if (rc == cudaSuccess)
    rc = cudaLaunchKernel(qk, dim3(L / 64 * p.nchunks * BH), dim3(128),
                          qargs, qk_smem, stream);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return p.xs != nullptr ? launch_mto<L, true>(p, BH, stream)
                         : launch_mto<L, false>(p, BH, stream);
}

}  // namespace

// q, k, v, h: (B*H, T, Dh) bf16, 16-byte aligned; ig, fg: (B*H, T) fp32;
// scratch: (B*H, ceil(T / 64), 64, 64) fp32.  c (B*H, Dh, Dh), n (B*H, Dh),
// m (B*H) fp32: the final state, written when c is not null (then n and m
// must not be null either).  xs, ms, hf, dn: the training build's outputs
// (Params), written when xs is not null (then none of them may be null).
// ``stages`` as kernels/mlstm.py:schedule picks it.  Returns the first
// cudaError_t; a tensor map the driver refuses returns 1000 + its CUresult.
extern "C" int rt_mlstm_scan(const void* q, const void* k, const void* v,
                             const void* ig, const void* fg, void* h,
                             void* c, void* n, void* m, void* scratch,
                             void* xs, void* ms, void* hf, void* dn, int BH,
                             int T, int Dh, int stages, void* stream) {
  if (BH <= 0 || BH > 65535 || T <= 0 || Dh <= 0 || Dh % DV ||
      Dh > 1024 ||
      stages < OWNERS || stages % OWNERS ||  // the owners' parity waits
                                             // (see the source note)
      stages > MAX_STAGES || Cfg<64>::smem_bytes(stages) > 232448 ||
      (c != nullptr && (n == nullptr || m == nullptr)) ||
      (xs != nullptr && (ms == nullptr || hf == nullptr || dn == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.v = static_cast<const bf16*>(v);
  p.ig = static_cast<const float*>(ig);
  p.fg = static_cast<const float*>(fg);
  p.S = static_cast<const float*>(scratch);
  p.h = static_cast<bf16*>(h);
  p.c_out = static_cast<float*>(c);
  p.n_out = static_cast<float*>(n);
  p.m_out = static_cast<float*>(m);
  p.xs = static_cast<float*>(xs);
  p.ms = static_cast<float*>(ms);
  p.hf = static_cast<float*>(hf);
  p.dn = static_cast<float*>(dn);
  p.T = T, p.Dh = Dh, p.nchunks = (T + 63) / 64, p.stages = stages;
  p.scale = static_cast<float>(pow(static_cast<double>(Dh), -0.5));
  return launch<64>(q, k, p, BH, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of one scan block (kernels/mlstm.py:
// smem_bytes_for must agree).
extern "C" int rt_mlstm_smem_bytes(int stages) {
  return Cfg<64>::smem_bytes(stages);
}

// ... and of one Q K^T block (kernels/mlstm.py:qk_smem_bytes).
extern "C" int rt_mlstm_qk_smem_bytes() { return Cfg<64>::qk_smem_bytes(); }

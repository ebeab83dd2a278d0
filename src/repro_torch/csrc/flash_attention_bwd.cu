// The backward pass of flash attention: dQ, dK and dV, with GQA, causal /
// local-window masks and a query position offset.
//
// Replaces the gradient of the TPU kernel
// repro/kernels/flash_attention.py:flash_attention (the JAX package
// differentiates its plain attention; the Pallas kernel has no VJP).  It
// takes q, k, v, the forward's bf16 output o, the output gradient dO and
// the forward's fp32 row logsumexp lse, and computes, with fp32
// accumulation and P recomputed tile by tile from lse:
//
//   S = q k^T,  P = exp(S * Dh^-0.5 - lse)  (masked entries 0),
//   dV = P^T dO,  dP = dO V^T,  D = rowsum(dO o),  dS = P (dP - D),
//   dQ = dS K * Dh^-0.5,  dK = dS^T Q * Dh^-0.5,
//
// P and dS enter the dV and dK products as split-bf16 pairs (hi + lo, two
// products each) and dQ's rounded to bf16; q-head h reads kv-head h / (Hq
// / Hk), and dK, dV sum over the group's q heads.  A row that saw
// no key has lse = +inf (the forward writes it so) and gives zero
// gradients; masked entries are zero whatever lse holds.
//
// Bound on an H100: 10 * Tq * Tk * Dh FLOP a head (five products, halved
// by the causal mask, cut to about Tq * window pairs by a local window)
// against a few MB of operands: compute-bound at training lengths, on the
// tensor cores.  Design, on the forward's parts (TMA, mbarrier rings,
// wgmma; csrc/hopper.cuh):
// * dsum_kernel: D = rowsum(dO o) and lse * log2(e), one warp a row, into
//   rows padded to a multiple of 64 queries (+inf and 0 past Tq), so that
//   a tile's 64 values are one bulk copy and rows past Tq give P = 0.
// * dkdv_kernel: one block per (key tile, kv head, batch, split of the
//   group's q heads), launched heaviest first (the host's order of the key
//   tiles by the query tiles they see).  Warpgroup 0 is the producer: one
//   thread loads the block's K and V tiles once by TMA, then streams the
//   (Q, dO) tiles of 64 queries of each of its q heads, with their lse and
//   D rows, through a ring of full / empty mbarriers.  Two consumer
//   warpgroups run wgmma: S^T = K Q^T and dP^T = V dO^T (m64n64k16, both
//   from shared memory), then dV += P^T dO and dK += dS^T Q with P^T and
//   dS^T from registers (the accumulators turn into A fragments in place)
//   and dO and Q N-major.  ``COLS`` picks how they share the tile:
//   - rows (128 keys, Dh <= 128): each group owns 64 keys and every column
//     of their dK and dV (64 + 64 fp32 a thread at Dh = 128);
//   - columns (64 keys, Dh = 256, where 64 keys x 256 columns of dK and
//     dV would be 256 fp32 a thread): both own the same 64 keys, one
//     computes S^T and the other dP^T, they trade them through shared
//     memory, and each keeps half the columns of dK and dV.
//   The block walks its q heads in order, so the sum over them is a
//   fixed-order sum in registers: no atomics.
// * With one kv head for many q heads (MQA) the key tiles alone leave
//   most SMs idle, so the group's q heads are split across ``splits``
//   blocks (kernels/flash_attention.py:bwd_splits: the fewest that fill
//   the card).  Each split writes its fp32 dK and dV partials to a
//   scratch, and split_sum_kernel adds them in split order and rounds:
//   the sum is fixed-order too, and two launches give the same bits.
// * dq_kernel: one block per (query tile, q head, batch), heaviest first:
//   128 rows at Dh = 128, 64 at Dh = 64 and 256.  A producer streams K
//   and V tiles of 64 keys through a TMA ring, and each consumer
//   warpgroup (64 rows) runs S = Q K^T and dP = dO V^T from shared memory,
//   then dQ += dS K with dS from registers and K N-major, dQ a fixed-order
//   sum in registers.
// * Masks only where needed: each kernel splits its loop into the tiles
//   every row sees whole (no mask code) and those on the causal diagonal,
//   the window's edge or past Tk, a template flag as the forward's
//   softmax<MASK> (no branch on the group sits between a wgmma and its
//   wait: ptxas would serialise them).  Rows past Tq and keys past Tk load
//   as zeros (TMA's fill); rows past Tq have lse = +inf, so P = 0 there in
//   either loop, and a key past Tk only touches its own dK and dV rows,
//   which are not written.
#include <type_traits>

#include "hopper.cuh"

namespace {

using rt::bf16;

constexpr int MAX_STAGES = 4;
constexpr int MAX_TILES = 1024;   // tiles a launch order can list
constexpr int BAR_BYTES = 256;    // the mbarriers
constexpr int ROW_BYTES = 2 * 64 * 4;  // a stage's lse and D rows
constexpr int BOX = 64 * 128;     // a 64-row, 64-column box (bf16)
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  CUtensorMap q, k, v, dout;  // (Dh, T, B * H) bf16, boxes of 64 x 64
  const bf16 *o, *dout_ptr;   // (B, Hq, Tq, Dh)
  const float* lse;           // (B, Hq, Tq)
  float *lp, *dp;             // (B * Hq, Tq_pad): lse * log2(e) and D
  bf16 *dq, *dk, *dv;
  float *pk, *pv;             // (splits, B, Hk, Tk, Dh) partials
  int B, Hq, Hk, Tq, Tk, Tq_pad, causal, window, q_offset, splits, stages;
  float scale, scale_log2;    // Dh^-0.5, and times log2(e)
  uint16_t order[MAX_TILES];  // tiles, heaviest first
};

// The dK/dV block: keys a block owns, columns of dK and dV a consumer
// group owns, and the shared memory of K, V, a stage's Q or dO tile and
// the S^T / dP^T trade (columns only).
template <int D, bool COLS>
struct KvCfg {
  static constexpr int BK = COLS ? 64 : 128;
  static constexpr int DC = COLS ? D / 2 : D;
  static constexpr int THREADS = 384;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int KBOX = BK * 128;      // a 64-column box of K or V
  static constexpr int QT_BYTES = 64 * D * 2;
  static constexpr int XCHG = COLS ? 2 * 32 * 128 * 4 : 0;
  static constexpr int smem_bytes(int stages) {
    return 1024 + 2 * KV_BYTES + stages * (2 * QT_BYTES + ROW_BYTES) +
           XCHG + BAR_BYTES;
  }
};

// The dQ block: BQ query rows, one consumer group of 64 each, or (COLS,
// Dh = 256, where 64 rows x 256 columns of dQ beside S and dP would not
// fit the registers) two groups on the same 64 rows, one computing S and
// the other dP, trading them, each keeping half the columns of dQ.  Its
// ring holds K and V tiles of 64 keys.
template <int D, int BQ>
struct QCfg {
  static constexpr bool COLS = D == 256;
  static constexpr int NC = COLS ? 2 : BQ / 64;
  static constexpr int DC = COLS ? D / 2 : D;
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int QBOX = BQ * 128;
  static constexpr int KV_BYTES = 64 * D * 2;  // one K or V tile
  static constexpr int XCHG = COLS ? 2 * 32 * 128 * 4 : 0;
  static constexpr int smem_bytes(int stages) {
    return 1024 + 2 * Q_BYTES + 2 * stages * KV_BYTES + XCHG + BAR_BYTES;
  }
};

// registers a thread after setmaxnreg, where two consumer groups take
// them from the producer (384 threads: 168 a thread at launch)
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

// Tiles [lo, hi) of one axis that some position of a tile of the other
// sees, and [full_lo, full_hi) among them, seen whole: those run no mask.
struct Span {
  int lo, full_lo, full_hi, hi;
};

// The key tiles of a query tile (csrc/flash_attention.cu: key_span, and
// kernels/flash_attention.py:key_tiles, with full_lo kept within hi);
// rows past Tq do not count, and a tile holding a key past Tk is not
// whole.
__device__ __forceinline__ Span key_span(int q0, int bq, int bk,
                                         const Params& p) {
  const int first = q0 + p.q_offset;
  const int last = min(q0 + bq, p.Tq) - 1 + p.q_offset;
  const int k_min = p.window > 0 ? max(0, first - p.window + 1) : 0;
  const int k_max = p.causal ? min(p.Tk - 1, last) : p.Tk - 1;
  if (k_min > k_max) return {0, 0, 0, 0};
  const int f_min = p.window > 0 ? max(0, last - p.window + 1) : 0;
  const int f_max = p.causal ? min(p.Tk - 1, first) : p.Tk - 1;
  Span s;
  s.lo = k_min / bk;
  s.hi = k_max / bk + 1;
  s.full_lo = min(s.hi, max(s.lo, (f_min + bk - 1) / bk));
  s.full_hi = max(s.full_lo, min(s.hi, (f_max + 1) / bk));
  return s;
}

// The query tiles (64 rows) that some row of key tile [k0, k0 + bk) sees
// (kernels/flash_attention.py:query_tiles): the transpose of key_span, a
// tile whole where every real row sees every key and no key is past Tk.
__device__ __forceinline__ Span query_span(int k0, int bk, const Params& p) {
  const int k1 = min(k0 + bk, p.Tk) - 1;  // the last real key
  const int q_lo = p.causal ? max(0, k0 - p.q_offset) : 0;
  const int q_hi = p.window > 0
                       ? min(p.Tq - 1, k1 + p.window - 1 - p.q_offset)
                       : p.Tq - 1;
  if (q_lo > q_hi) return {0, 0, 0, 0};
  Span s;
  s.lo = q_lo / 64;
  s.hi = q_hi / 64 + 1;
  // rows that see every key of the tile: from the one that sees its last
  // key (causal) to the one that still sees its first (window)
  const int f_lo = p.causal ? max(0, k0 + bk - 1 - p.q_offset) : 0;
  const int f_hi = p.window > 0 ? k0 + p.window - 1 - p.q_offset : p.Tq - 1;
  s.full_lo = min(s.hi, max(s.lo, (f_lo + 63) / 64));
  const int top = f_hi >= p.Tq - 1 ? s.hi : (f_hi + 1) / 64;
  s.full_hi = k0 + bk > p.Tk ? s.full_lo
                             : max(s.full_lo, min(s.hi, top));
  return s;
}

// Whether query row qi sees key kp.
__device__ __forceinline__ bool visible(int qi, int kp, const Params& p) {
  const int qp = qi + p.q_offset;
  bool ok = qi < p.Tq && kp < p.Tk;
  if (p.causal) ok = ok && kp <= qp;
  if (p.window > 0) ok = ok && kp > qp - p.window;
  return ok;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// What rounding x0, x1 to the bf16 pair ``hi`` left, as a bf16 pair: hi
// + lo carries x to about 2^-17 of itself (x - hi is exact in fp32).
__device__ __forceinline__ uint32_t residual(uint32_t hi, float x0,
                                             float x1) {
  return rt::pack_bf16(x0 - __uint_as_float(hi << 16),
                       x1 - __uint_as_float(hi & 0xffff0000u));
}

// An m64n64 accumulator as the A fragments of its four k16 slices (its
// n8 tiles 2kk and 2kk + 1), rounded to bf16: hi, and (SPLIT) lo, what
// the rounding left.
template <bool SPLIT>
__device__ __forceinline__ void to_a(uint32_t (&hi)[4][4],
                                     uint32_t (&lo)[4][4],
                                     const float (&c)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = c[8 * kk + 2 * r], x1 = c[8 * kk + 2 * r + 1];
      hi[kk][r] = rt::pack_bf16(x0, x1);
      if constexpr (SPLIT) lo[kk][r] = residual(hi[kk][r], x0, x1);
    }
}

// Rows [r0, r0 + 16) (this thread's r0 + g and r0 + g + 8) x columns
// [col0, col0 + N) of a (T, D) matrix from an m64nN accumulator, times
// ``mul``, rounded to bf16 (or, OutT = float, as they are); rows past
// ``nrows`` are not written.
template <int D, int N, typename OutT = bf16>
__device__ __forceinline__ void store_rows(OutT* dst, const float (&acc)[N / 2],
                                           int r0, int nrows, float mul,
                                           int col0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    if (r >= nrows) continue;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      OutT* at = dst + static_cast<size_t>(r) * D + col0 + 8 * j + 2 * t;
      const float x0 = acc[4 * j + 2 * h] * mul;
      const float x1 = acc[4 * j + 2 * h + 1] * mul;
      if constexpr (std::is_same_v<OutT, float>)
        *reinterpret_cast<float2*>(at) = make_float2(x0, x1);
      else
        *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(x0, x1);
    }
  }
}

// The offset (16-byte units) of k16 slice kk of a K-major operand from
// its tile's descriptor: 32 bytes along the 128-byte row, a 64-column box
// of ``box`` bytes further every fourth slice.
__device__ __forceinline__ int kmaj(int kk, int box) {
  return (kk / 4 * box + kk % 4 * 32) >> 4;
}

// A descriptor (rt::desc) is held as its low word: the start address >> 4
// and the leading byte offset ``lbo``; its high word, the 1024-byte stride
// and the 128-byte swizzle, is the same for every operand here.
constexpr uint32_t DESC_HI = (1024 >> 4) | (1u << 30);

__device__ __forceinline__ uint32_t dlo(const void* p, uint32_t lbo) {
  return ((rt::smem_addr(p) & 0x3FFFF) >> 4) | (lbo >> 4) << 16;
}

// The descriptor of low word lo + off, formed where it is used: as a
// volatile asm it stays beside its wgmma, instead of every slice's
// descriptor being formed up front and held beside the accumulators.
__device__ __forceinline__ uint64_t dadd(uint32_t lo, int off) {
  uint64_t d;
  asm volatile(
      "{\n.reg .u32 t;\nadd.u32 t, %1, %2;\nmov.b64 %0, {t, %3};\n}\n"
      : "=l"(d)
      : "r"(lo), "r"(off), "r"(DESC_HI));
  return d;
}

// Where two consumer groups share 64 rows: group cw's product ``s`` into
// slot cw of the trade (thread ct's 32 values 128 floats apart), then both
// groups read slot 0 into s and slot 1 into dp.  Named barriers 1 and 2
// among the 256 consumer threads: the second frees the trade.
__device__ __forceinline__ void trade(float* Xs, float (&s)[32],
                                      float (&dp)[32], int cw, int ct) {
#pragma unroll
  for (int e = 0; e < 32; ++e) Xs[(32 * cw + e) * 128 + ct] = s[e];
  rt::named_barrier(1, 256);
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    s[e] = Xs[e * 128 + ct];
    dp[e] = Xs[(32 + e) * 128 + ct];
  }
  rt::named_barrier(2, 256);
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (rt::smem_addr(p) & 1023)) & 1023);
}

// D and lse * log2(e) of every row, padded to Tq_pad rows a head: D / 8
// lanes a row, 16 bytes of o and of dO a lane.
template <int D>
__global__ void __launch_bounds__(256) dsum_kernel(const Params p) {
  constexpr int LPR = D / 8, RPB = 256 / LPR;  // lanes a row, rows a block
  const int rows = p.B * p.Hq * p.Tq_pad;
  const int row = blockIdx.x * RPB + threadIdx.x / LPR;
  const int lane = threadIdx.x % LPR;
  if (row >= rows) return;  // whole rows: LPR divides 32
  const int bh = row / p.Tq_pad, qi = row % p.Tq_pad;
  const bool in = qi < p.Tq;
  const size_t at = static_cast<size_t>(bh) * p.Tq + qi;
  float acc = 0.f;
  if (in) {
    const uint4 a = *reinterpret_cast<const uint4*>(p.o + at * D + 8 * lane);
    const uint4 b =
        *reinterpret_cast<const uint4*>(p.dout_ptr + at * D + 8 * lane);
    const uint32_t av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&av[i]));
      const float2 y = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&bv[i]));
      acc += x.x * y.x + x.y * y.y;
    }
  }
#pragma unroll
  for (int off = LPR / 2; off; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    p.dp[row] = in ? acc : 0.f;
    p.lp[row] = in ? p.lse[at] * kLog2e : __int_as_float(0x7f800000);
  }
}

template <int D, bool COLS>
__global__ void __launch_bounds__(384, 1)
    dkdv_kernel(const __grid_constant__ Params p) {
  using C = KvCfg<D, COLS>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = align_1024(smem_raw);
  uint8_t* Vs = Ks + C::KV_BYTES;
  uint8_t* Qs = Vs + C::KV_BYTES;              // [stages][QT_BYTES]
  uint8_t* Os = Qs + p.stages * C::QT_BYTES;   // dO, [stages][QT_BYTES]
  float* Xs = reinterpret_cast<float*>(Os + p.stages * C::QT_BYTES);
  float* Rs = Xs + C::XCHG / 4;                // [stages]: 64 lse, 64 D
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(Rs + p.stages * 128);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + MAX_STAGES;

  const int per = p.B * p.Hk * p.splits;
  const int k0 = p.order[blockIdx.x / per] * C::BK;
  const int rem = blockIdx.x % per;
  const int b = rem / (p.Hk * p.splits), hk = rem / p.splits % p.Hk;
  const int sp = rem % p.splits;
  const int group = p.Hq / p.Hk, heads = group / p.splits;
  const int bhk = b * p.Hk + hk;
  const int bh0 = b * p.Hq + hk * group + sp * heads;  // its first q head
  const Span span = query_span(k0, C::BK, p);

  if (threadIdx.x == 0) {
    rt::mbar_init(kvbar, 1);
    for (int s = 0; s < p.stages; ++s) {
      rt::mbar_init(&full[s], 1);   // the producer's expect_tx
      rt::mbar_init(&empty[s], 2);  // one arrival per consumer group
    }
    rt::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread loads K, V, then keeps the ring full -----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      rt::mbar_expect_tx(kvbar, 2 * C::KV_BYTES);
#pragma unroll
      for (int x = 0; x < D / 64; ++x)
#pragma unroll
        for (int r = 0; r < C::BK / 64; ++r) {
          rt::tma_load_3d(Ks + x * C::KBOX + r * BOX, &p.k, 64 * x,
                          k0 + 64 * r, bhk, kvbar);
          rt::tma_load_3d(Vs + x * C::KBOX + r * BOX, &p.v, 64 * x,
                          k0 + 64 * r, bhk, kvbar);
        }
      int stage = 0;
      uint32_t phase = 0;
      for (int hh = 0; hh < heads; ++hh) {
        const int bh = bh0 + hh;
        const float* lrow = p.lp + static_cast<size_t>(bh) * p.Tq_pad;
        const float* drow = p.dp + static_cast<size_t>(bh) * p.Tq_pad;
        for (int i = span.lo; i < span.hi; ++i) {
          rt::mbar_wait(&empty[stage], phase ^ 1);
          rt::mbar_expect_tx(&full[stage], 2 * C::QT_BYTES + ROW_BYTES);
          uint8_t* qd = Qs + stage * C::QT_BYTES;
          uint8_t* od = Os + stage * C::QT_BYTES;
#pragma unroll
          for (int x = 0; x < D / 64; ++x) {
            rt::tma_load_3d(qd + x * BOX, &p.q, 64 * x, 64 * i, bh,
                            &full[stage]);
            rt::tma_load_3d(od + x * BOX, &p.dout, 64 * x, 64 * i, bh,
                            &full[stage]);
          }
          rt::bulk_load(Rs + stage * 128, lrow + 64 * i, 256, &full[stage]);
          rt::bulk_load(Rs + stage * 128 + 64, drow + 64 * i, 256,
                        &full[stage]);
          if (++stage == p.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers ------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int cw = wg - 1, warp = threadIdx.x / 32 % 4;
    const int lane = threadIdx.x % 32, ct = threadIdx.x % 128;
    const int g = lane >> 2, t = lane & 3;
    const bool leader = ct == 0;
    // this group's keys start at kr0; its dK and dV columns at col0
    const int kr0 = k0 + (COLS ? 0 : 64 * cw);
    const int kr = kr0 + 16 * warp + g;  // the thread's first key
    const int col0 = COLS ? C::DC * cw : 0;
    // K and V (A, K-major): this group's 64 rows
    const uint8_t* ka = Ks + (COLS ? 0 : 64 * 128 * cw);
    const uint8_t* va = Vs + (COLS ? 0 : 64 * 128 * cw);

    float dk[C::DC / 2], dv[C::DC / 2];
#pragma unroll
    for (int i = 0; i < C::DC / 2; ++i) dk[i] = dv[i] = 0.f;

    int stage = 0;
    uint32_t phase = 0;
    // One (q head, query tile) of the ring: S^T and dP^T, then P^T and dS^T
    // in registers, then dV and dK.  MASK: a template flag of each loop.
    auto step = [&](int i, auto mask) {
      rt::mbar_wait(&full[stage], phase);
      const uint8_t* qt = Qs + stage * C::QT_BYTES;
      const uint8_t* ot = Os + stage * C::QT_BYTES;
      const float* L = Rs + stage * 128;
      const float* Ds = L + 64;
      const uint32_t qd = dlo(qt, 16), od = dlo(ot, 16);
      // zeroed ahead of the fence (the first product overwrites them), so
      // that they are dead outside the step and defined where read
      float s[32], dp[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;
      if constexpr (!COLS) {
        const uint32_t kd = dlo(ka, 16);
        const uint32_t vd = dlo(va, 16);
        rt::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          rt::Wgmma<64, 0>::ss(s, dadd(kd, kmaj(kk, C::KBOX)),
                               dadd(qd, kmaj(kk, BOX)), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          rt::Wgmma<64, 0>::ss(dp, dadd(vd, kmaj(kk, C::KBOX)),
                               dadd(od, kmaj(kk, BOX)), kk > 0);
        rt::wgmma_commit();
        rt::wgmma_wait<0>();
        rt::fence_regs(s);
        rt::fence_regs(dp);
      } else {
        // group 0 multiplies K by Q and group 1 V by dO (the same code, on
        // other operands: no branch on the group), each into the trade;
        // then both read both
        const uint32_t xa = dlo(cw ? va : ka, 16);
        const uint32_t xb = cw ? od : qd;
        rt::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          rt::Wgmma<64, 0>::ss(s, dadd(xa, kmaj(kk, C::KBOX)),
                               dadd(xb, kmaj(kk, BOX)), kk > 0);
        rt::wgmma_commit();
        rt::wgmma_wait<0>();
        rt::fence_regs(s);
        trade(Xs, s, dp, cw, ct);
      }
      // P^T (keys x queries), then dS^T = P^T (dP^T - D), in place (the
      // empty asm keeps the D rows' loads from rising above P^T's: both
      // rows at once would not fit the registers beside dK and dV)
      const int q0 = 64 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(L + 8 * j + 2 * t);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int at = 4 * j + 2 * h + e;
            float pv = ex2(fmaf(s[at], p.scale_log2, -(e ? l.y : l.x)));
            if constexpr (decltype(mask)::value)
              pv = visible(q0 + 8 * j + 2 * t + e, kr + 8 * h, p) ? pv : 0.f;
            s[at] = pv;
          }
      }
      asm volatile("" ::: "memory");
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 d = *reinterpret_cast<const float2*>(Ds + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - (e & 1 ? d.y : d.x));
      }
      // dV += P^T dO, dK += dS^T Q on this group's columns, P^T and dS^T
      // as split-bf16 pairs: summed over a group's heads and queries, their
      // bf16 rounding alone leaves dK and dV outside the bf16 tolerance at
      // MQA 16/1, head_dim 256
      // (B N-major: this group's first column box, 64-column boxes BOX
      // apart, a k16 slice 16 rows further)
      uint32_t ph[4][4], pl[4][4], sh[4][4], sl[4][4];
      to_a<true>(ph, pl, s);
      to_a<true>(sh, sl, dp);
      const uint32_t on = dlo(ot + col0 / 64 * BOX, BOX);
      const uint32_t qn = dlo(qt + col0 / 64 * BOX, BOX);
      rt::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        rt::Wgmma<C::DC, 1>::rs(dv, ph[kk], dadd(on, kk * 128));
        rt::Wgmma<C::DC, 1>::rs(dv, pl[kk], dadd(on, kk * 128));
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        rt::Wgmma<C::DC, 1>::rs(dk, sh[kk], dadd(qn, kk * 128));
        rt::Wgmma<C::DC, 1>::rs(dk, sl[kk], dadd(qn, kk * 128));
      }
      rt::wgmma_commit();
      rt::wgmma_wait<0>();
      rt::fence_regs(dv);
      rt::fence_regs(dk);
      rt::fence_regs(ph);
      rt::fence_regs(pl);
      rt::fence_regs(sh);
      rt::fence_regs(sl);
      if (leader) rt::mbar_arrive(&empty[stage]);
      if (++stage == p.stages) {
        stage = 0;
        phase ^= 1;
      }
    };
    using Masked = std::integral_constant<bool, true>;
    using Whole = std::integral_constant<bool, false>;

    rt::mbar_wait(kvbar, 0);
    for (int hh = 0; hh < heads; ++hh) {
      // the causal diagonal, the tiles every row sees whole, the window's
      // upper edge
      for (int i = span.lo; i < span.full_lo; ++i) step(i, Masked{});
      for (int i = span.full_lo; i < span.full_hi; ++i) step(i, Whole{});
      for (int i = span.full_hi; i < span.hi; ++i) step(i, Masked{});
    }

    const int r0 = kr0 + 16 * warp;
    const size_t base = static_cast<size_t>(bhk) * p.Tk * D;
    if (p.splits == 1) {
      store_rows<D, C::DC>(p.dk + base, dk, r0, p.Tk, p.scale, col0, lane);
      store_rows<D, C::DC>(p.dv + base, dv, r0, p.Tk, 1.f, col0, lane);
    } else {  // this split's partials, summed by split_sum_kernel
      const size_t part =
          static_cast<size_t>(sp) * p.B * p.Hk * p.Tk * D + base;
      store_rows<D, C::DC, float>(p.pk + part, dk, r0, p.Tk, 1.f, col0,
                                  lane);
      store_rows<D, C::DC, float>(p.pv + part, dv, r0, p.Tk, 1.f, col0,
                                  lane);
    }
  }
}

// dK and dV from the splits' fp32 partials, summed in split order:
// blockIdx.y 0 is dK (times Dh^-0.5), 1 is dV; four elements a thread.
__global__ void __launch_bounds__(256) split_sum_kernel(const Params p,
                                                        size_t n) {
  const bool is_k = blockIdx.y == 0;
  const float* part = is_k ? p.pk : p.pv;
  bf16* out = is_k ? p.dk : p.dv;
  const float mul = is_k ? p.scale : 1.f;
  const size_t i = 4 * (static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x);
  if (i >= n) return;
  float4 acc = *reinterpret_cast<const float4*>(part + i);
  for (int s = 1; s < p.splits; ++s) {
    const float4 v = *reinterpret_cast<const float4*>(part + s * n + i);
    acc.x += v.x, acc.y += v.y, acc.z += v.z, acc.w += v.w;
  }
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out + i);
  o[0] = __floats2bfloat162_rn(acc.x * mul, acc.y * mul);
  o[1] = __floats2bfloat162_rn(acc.z * mul, acc.w * mul);
}

template <int D, int BQ>
__global__ void __launch_bounds__(QCfg<D, BQ>::THREADS, 1)
    dq_kernel(const __grid_constant__ Params p) {
  using C = QCfg<D, BQ>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align_1024(smem_raw);
  uint8_t* Os = Qs + C::Q_BYTES;               // dO
  uint8_t* Ks = Os + C::Q_BYTES;               // [stages][KV_BYTES]
  uint8_t* Vs = Ks + p.stages * C::KV_BYTES;   // [stages][KV_BYTES]
  float* Xs = reinterpret_cast<float*>(Vs + p.stages * C::KV_BYTES);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(Xs + C::XCHG / 4);
  uint64_t* full_k = qbar + 1;
  uint64_t* full_v = full_k + MAX_STAGES;
  uint64_t* empty = full_v + MAX_STAGES;

  const int heads = p.B * p.Hq;
  const int q0 = p.order[blockIdx.x / heads] * BQ;
  const int bh = blockIdx.x % heads;  // b * Hq + h
  const int bhk = bh / p.Hq * p.Hk + bh % p.Hq / (p.Hq / p.Hk);
  const Span span = key_span(q0, BQ, 64, p);

  if (threadIdx.x == 0) {
    rt::mbar_init(qbar, 1);
    for (int s = 0; s < p.stages; ++s) {
      rt::mbar_init(&full_k[s], 1);
      rt::mbar_init(&full_v[s], 1);
      rt::mbar_init(&empty[s], C::NC);
    }
    rt::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer -------------------------------------------------------
    if constexpr (C::NC == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          PRODUCER_REGS));
    if (threadIdx.x == 0) {
      rt::mbar_expect_tx(qbar, 2 * C::Q_BYTES);
#pragma unroll
      for (int x = 0; x < D / 64; ++x)
#pragma unroll
        for (int r = 0; r < BQ / 64; ++r) {
          rt::tma_load_3d(Qs + x * C::QBOX + r * BOX, &p.q, 64 * x,
                          q0 + 64 * r, bh, qbar);
          rt::tma_load_3d(Os + x * C::QBOX + r * BOX, &p.dout, 64 * x,
                          q0 + 64 * r, bh, qbar);
        }
      int stage = 0;
      uint32_t phase = 0;
      for (int j = span.lo; j < span.hi; ++j) {
        rt::mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* kd = Ks + stage * C::KV_BYTES;
        uint8_t* vd = Vs + stage * C::KV_BYTES;
        rt::mbar_expect_tx(&full_k[stage], C::KV_BYTES);
#pragma unroll
        for (int x = 0; x < D / 64; ++x)
          rt::tma_load_3d(kd + x * BOX, &p.k, 64 * x, 64 * j, bhk,
                          &full_k[stage]);
        rt::mbar_expect_tx(&full_v[stage], C::KV_BYTES);
#pragma unroll
        for (int x = 0; x < D / 64; ++x)
          rt::tma_load_3d(vd + x * BOX, &p.v, 64 * x, 64 * j, bhk,
                          &full_v[stage]);
        if (++stage == p.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: query rows [64 cw, 64 cw + 64) of the tile (COLS:
    // rows [0, 64) and columns [DC cw, DC cw + DC) of dQ) -----------------
    if constexpr (C::NC == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
          CONSUMER_REGS));
    const int cw = wg - 1, warp = threadIdx.x / 32 % 4;
    const int lane = threadIdx.x % 32, ct = threadIdx.x % 128;
    const int g = lane >> 2, t = lane & 3;
    const bool leader = ct == 0;
    const int row0 = q0 + (C::COLS ? 0 : 64 * cw) + 16 * warp;
    const int col0 = C::COLS ? C::DC * cw : 0;
    const int qr = row0 + g;  // the thread's first row
    float lr[2], dr[2];  // its rows' lse * log2(e) and D
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = qr + 8 * h;
      const size_t at = static_cast<size_t>(bh) * p.Tq_pad + r;
      lr[h] = r < p.Tq ? p.lp[at] : __int_as_float(0x7f800000);
      dr[h] = r < p.Tq ? p.dp[at] : 0.f;
    }
    const uint8_t* qa = Qs + (C::COLS ? 0 : 64 * 128 * cw);
    const uint8_t* oa = Os + (C::COLS ? 0 : 64 * 128 * cw);
    const uint32_t qd = dlo(qa, 16), od = dlo(oa, 16);

    float dq[C::DC / 2];
#pragma unroll
    for (int i = 0; i < C::DC / 2; ++i) dq[i] = 0.f;

    int stage = 0;
    uint32_t phase = 0;
    // Key tile j: S and dP, dS in registers, then dQ += dS K.
    auto step = [&](int j, auto mask) {
      const uint8_t* kt = Ks + stage * C::KV_BYTES;
      const uint32_t kd = dlo(kt, 16);
      const uint32_t vd = dlo(Vs + stage * C::KV_BYTES, 16);
      float s[32], dp[32];  // as in dkdv_kernel's step
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;
      rt::mbar_wait(&full_k[stage], phase);
      rt::mbar_wait(&full_v[stage], phase);
      if constexpr (!C::COLS) {
        rt::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          rt::Wgmma<64, 0>::ss(s, dadd(qd, kmaj(kk, C::QBOX)),
                               dadd(kd, kmaj(kk, BOX)), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          rt::Wgmma<64, 0>::ss(dp, dadd(od, kmaj(kk, C::QBOX)),
                               dadd(vd, kmaj(kk, BOX)), kk > 0);
        rt::wgmma_commit();
        rt::wgmma_wait<0>();
        rt::fence_regs(s);
        rt::fence_regs(dp);
      } else {
        // group 0 computes S and group 1 dP (other operands, the same
        // code), each into the trade; then both read both
        const uint32_t xa = cw ? od : qd, xb = cw ? vd : kd;
        rt::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          rt::Wgmma<64, 0>::ss(s, dadd(xa, kmaj(kk, C::QBOX)),
                               dadd(xb, kmaj(kk, BOX)), kk > 0);
        rt::wgmma_commit();
        rt::wgmma_wait<0>();
        rt::fence_regs(s);
        trade(Xs, s, dp, cw, ct);
      }
      // dS = P (dP - D) in place
#pragma unroll
      for (int at = 0; at < 32; ++at) {
        const int h = (at >> 1) & 1;
        float pv = ex2(fmaf(s[at], p.scale_log2, -lr[h]));
        if constexpr (decltype(mask)::value) {
          const int kp = 64 * j + 8 * (at >> 2) + 2 * t + (at & 1);
          pv = visible(qr + 8 * h, kp, p) ? pv : 0.f;
        }
        dp[at] = pv * (dp[at] - dr[h]);
      }
      uint32_t da[4][4], unused[4][4];
      to_a<false>(da, unused, dp);
      // K N-major, from this group's first column box
      const uint32_t kn = dlo(kt + col0 / 64 * BOX, BOX);
      rt::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        rt::Wgmma<C::DC, 1>::rs(dq, da[kk], dadd(kn, kk * 128));
      rt::wgmma_commit();
      rt::wgmma_wait<0>();
      rt::fence_regs(dq);
      rt::fence_regs(da);
      if (leader) rt::mbar_arrive(&empty[stage]);
      if (++stage == p.stages) {
        stage = 0;
        phase ^= 1;
      }
    };
    using Masked = std::integral_constant<bool, true>;
    using Whole = std::integral_constant<bool, false>;

    rt::mbar_wait(qbar, 0);
    // the window's lower edge, the tiles every row sees whole, then the
    // causal diagonal and Tk's edge
    for (int j = span.lo; j < span.full_lo; ++j) step(j, Masked{});
    for (int j = span.full_lo; j < span.full_hi; ++j) step(j, Whole{});
    for (int j = span.full_hi; j < span.hi; ++j) step(j, Masked{});

    store_rows<D, C::DC>(p.dq + static_cast<size_t>(bh) * p.Tq * D, dq,
                         row0, p.Tq, p.scale, col0, lane);
  }
}

// setmaxnreg moves registers within the block's allocation: refuse to
// launch a build whose allocation cannot cover what the groups ask for
int check_regs(const void* fn, int threads, int groups) {
  cudaFuncAttributes attr;
  cudaError_t rc = cudaFuncGetAttributes(&attr, fn);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (groups == 2 &&
      attr.numRegs * threads < 128 * (PRODUCER_REGS + 2 * CONSUMER_REGS))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  return 0;
}

int launch_kernel(const void* fn, const Params& p, int grid, int threads,
                  int smem, int groups, cudaStream_t s) {
  int rc = check_regs(fn, threads, groups);
  if (rc) return rc;
  rc = static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (rc) return rc;
  void* args[] = {const_cast<Params*>(&p)};
  return static_cast<int>(
      cudaLaunchKernel(fn, dim3(grid), dim3(threads), args, smem, s));
}

template <int D, bool COLS>
int launch_dkdv(const Params& p, int grid, cudaStream_t s) {
  using C = KvCfg<D, COLS>;
  return launch_kernel(reinterpret_cast<const void*>(&dkdv_kernel<D, COLS>),
                       p, grid, C::THREADS, C::smem_bytes(p.stages), 2, s);
}

template <int D, int BQ>
int launch_dq(const Params& p, int grid, cudaStream_t s) {
  using C = QCfg<D, BQ>;
  return launch_kernel(reinterpret_cast<const void*>(&dq_kernel<D, BQ>), p,
                       grid, C::THREADS, C::smem_bytes(p.stages), C::NC, s);
}

// Which builds exist, one a head dim for each kernel: the key tile 128
// (rows) at Dh <= 128 and 64 (columns) at 256; the query tile 64 at Dh 64
// and 256, 128 at 128 (kernels/flash_attention.py: BWD_BLOCK_K and
// BWD_BLOCK_Q).
int dkdv_smem(int D, int block_k, int stages) {
  if (D == 64 && block_k == 128) return KvCfg<64, false>::smem_bytes(stages);
  if (D == 128 && block_k == 128)
    return KvCfg<128, false>::smem_bytes(stages);
  if (D == 256 && block_k == 64) return KvCfg<256, true>::smem_bytes(stages);
  return -1;
}

int dq_smem(int D, int block_q, int stages) {
  if (D == 64 && block_q == 64) return QCfg<64, 64>::smem_bytes(stages);
  if (D == 128 && block_q == 128) return QCfg<128, 128>::smem_bytes(stages);
  if (D == 256 && block_q == 64) return QCfg<256, 64>::smem_bytes(stages);
  return -1;
}

// the launcher checks the tile against dkdv_smem / dq_smem first
int dispatch_dkdv(const Params& p, int D, int grid, cudaStream_t s) {
  if (D == 64) return launch_dkdv<64, false>(p, grid, s);
  if (D == 128) return launch_dkdv<128, false>(p, grid, s);
  return launch_dkdv<256, true>(p, grid, s);
}

int dispatch_dq(const Params& p, int D, int grid, cudaStream_t s) {
  if (D == 64) return launch_dq<64, 64>(p, grid, s);
  if (D == 128) return launch_dq<128, 128>(p, grid, s);
  return launch_dq<256, 64>(p, grid, s);
}

constexpr int SMEM_LIMIT = 232448;

}  // namespace

// dq, dk, dv (bf16, the shapes of q, k, v) on ``stream``, on what
// kernels/flash_attention.py:bwd_schedule chose: the key tile ``block_k``
// and ring depth ``kv_stages`` of the dK/dV kernel, with the launch order
// of its ``n_kv`` key tiles; the query tile ``block_q`` and ring depth
// ``q_stages`` of the dQ kernel, with the order of its ``n_q`` query
// tiles; the ``splits`` of a group's q heads (which must divide Hq / Hk).
// ``rows``: 2 x (B, Hq, Tq rounded up to 64) fp32 of scratch; ``partials``:
// with splits > 1, 2 x (splits, B, Hk, Tk, Dh) fp32 of scratch for dK's
// and dV's partials, else null.  Kernels: D; then dK/dV and the splits'
// sum on ``stream`` and dQ on ``side``, joined before this returns.  Returns the first cudaError_t; a tensor map
// the driver refuses returns 1000 + its CUresult.
extern "C" int rt_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* rows, void* partials, int B, int Hq, int Hk, int Tq, int Tk, int D,
    int causal, int window, int q_offset, int block_k, int block_q,
    int kv_stages, int q_stages, int splits, const void* kv_order, int n_kv,
    const void* q_order, int n_q, void* stream, void* side) {
  if (B < 1 || Hk < 1 || Hq % Hk || Tq < 1 || Tk < 1 || q_offset < 0 ||
      window < 0 || splits < 1 || (Hq / Hk) % splits ||
      (splits > 1 && partials == nullptr) || side == nullptr ||
      kv_stages < 2 ||
      kv_stages > MAX_STAGES || q_stages < 2 || q_stages > MAX_STAGES ||
      dkdv_smem(D, block_k, kv_stages) < 0 ||
      dkdv_smem(D, block_k, kv_stages) > SMEM_LIMIT ||
      dq_smem(D, block_q, q_stages) < 0 ||
      dq_smem(D, block_q, q_stages) > SMEM_LIMIT ||
      n_kv != (Tk + block_k - 1) / block_k ||
      n_q != (Tq + block_q - 1) / block_q || n_kv > MAX_TILES ||
      n_q > MAX_TILES ||
      static_cast<long long>(n_kv) * B * Hk * splits > 0x7fffffff ||
      static_cast<long long>(n_q) * B * Hq > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const rt::Encode enc = rt::encode_fn();
  if (!enc) return static_cast<int>(cudaErrorSymbolNotFound);
  Params p{};
  CUresult cr = rt::make_map_3d(enc, &p.q, q, B * Hq, Tq, D, 64);
  if (cr == CUDA_SUCCESS)
    cr = rt::make_map_3d(enc, &p.dout, dout, B * Hq, Tq, D, 64);
  if (cr == CUDA_SUCCESS)
    cr = rt::make_map_3d(enc, &p.k, k, B * Hk, Tk, D, 64);
  if (cr == CUDA_SUCCESS)
    cr = rt::make_map_3d(enc, &p.v, v, B * Hk, Tk, D, 64);
  if (cr != CUDA_SUCCESS) return 1000 + static_cast<int>(cr);
  p.o = static_cast<const bf16*>(o);
  p.dout_ptr = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.Tq_pad = (Tq + 63) / 64 * 64;
  p.lp = static_cast<float*>(rows);
  p.dp = p.lp + static_cast<size_t>(B) * Hq * p.Tq_pad;
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.pk = static_cast<float*>(partials);
  p.pv = p.pk == nullptr
             ? nullptr
             : p.pk + static_cast<size_t>(splits) * B * Hk * Tk * D;
  p.B = B, p.Hq = Hq, p.Hk = Hk, p.Tq = Tq, p.Tk = Tk;
  p.causal = causal, p.window = window, p.q_offset = q_offset;
  p.splits = splits;
  // as the forward computes them, so that P is the forward's
  p.scale = 1.f / sqrtf(static_cast<float>(D));
  p.scale_log2 = kLog2e / sqrtf(static_cast<float>(D));
  auto s = static_cast<cudaStream_t>(stream);

  // 256 / (D / 8) rows a block
  const int nrows = B * Hq * p.Tq_pad, per = 2048 / D;
  if (D == 256)
    dsum_kernel<256><<<(nrows + per - 1) / per, 256, 0, s>>>(p);
  else if (D == 128)
    dsum_kernel<128><<<(nrows + per - 1) / per, 256, 0, s>>>(p);
  else
    dsum_kernel<64><<<(nrows + per - 1) / per, 256, 0, s>>>(p);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;

  // dK/dV, then its splits' sum, on ``stream``; dQ beside them on ``side``
  // (all need only D's rows): it fills the SMs dK/dV's tail leaves and
  // runs beside the memory-bound sum.  ``stream`` waits for it before
  // returning.
  auto s2 = static_cast<cudaStream_t>(side);
  cudaEvent_t fork = nullptr, join = nullptr;
  rc = static_cast<int>(
      cudaEventCreateWithFlags(&fork, cudaEventDisableTiming));
  if (!rc)
    rc = static_cast<int>(
        cudaEventCreateWithFlags(&join, cudaEventDisableTiming));
  if (!rc) rc = static_cast<int>(cudaEventRecord(fork, s));
  if (!rc) {
    p.stages = kv_stages;
    const auto* ko = static_cast<const uint16_t*>(kv_order);
    for (int i = 0; i < n_kv; ++i) p.order[i] = ko[i];
    rc = dispatch_dkdv(p, D, n_kv * B * Hk * splits, s);
  }
  if (!rc) rc = static_cast<int>(cudaStreamWaitEvent(s2, fork, 0));
  if (!rc) {
    Params pq = p;
    pq.stages = q_stages;
    const auto* qo = static_cast<const uint16_t*>(q_order);
    for (int i = 0; i < n_q; ++i) pq.order[i] = qo[i];
    rc = dispatch_dq(pq, D, n_q * B * Hq, s2);
  }
  if (!rc) rc = static_cast<int>(cudaEventRecord(join, s2));
  if (!rc && splits > 1) {
    const size_t n = static_cast<size_t>(B) * Hk * Tk * D;
    split_sum_kernel<<<dim3(static_cast<unsigned>((n / 4 + 255) / 256), 2),
                       256, 0, s>>>(p, n);
    rc = static_cast<int>(cudaGetLastError());
  }
  if (!rc) rc = static_cast<int>(cudaStreamWaitEvent(s, join, 0));
  if (fork) cudaEventDestroy(fork);
  if (join) cudaEventDestroy(join);
  return rc;
}

// Dynamic shared memory of one block of the dK/dV kernel (``kernel`` 0, at
// key tile ``tile``) or the dQ kernel (1, at query tile ``tile``) with
// ``stages`` ring stages (kernels/flash_attention.py:bwd_smem_bytes must
// agree), or -1 for a shape no build takes.
extern "C" int rt_flash_bwd_smem_bytes(int kernel, int D, int tile,
                                       int stages) {
  if (D != 64 && D != 128 && D != 256) return -1;
  return kernel == 0 ? dkdv_smem(D, tile, stages) : dq_smem(D, tile, stages);
}

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
// tensor cores.  This kernel is the simple design, right before fast
// (mma.sync m16n8k16 fed by ldmatrix from cp.async double buffers; no TMA
// or wgmma yet):
// * dsum_kernel: D = rowsum(dO o) in fp32, one warp a row.
// * dkdv_kernel: one block per (64-key tile, kv head, batch, split of the
//   group's q heads).  Four key groups of 16 keys keep their dK and dV in
//   registers: at Dh <= 128 one warp a key group owns all Dh columns; at
//   Dh = 256 (256 fp32 accumulators a thread would not fit) two warps
//   share a key group, one computing S^T = K Q^T and the other dP^T = V
//   dO^T, and trade P^T and dS^T through shared memory, each then owning
//   128 columns of dK and dV.  The block walks its q heads in order and,
//   for each, the 64-query tiles that see some key of the tile (the
//   window's range [kp, kp + window) bounds them), so the sum over its
//   heads is a fixed-order sum in registers: no atomics.
// * With one kv head for many q heads (MQA) the key tiles alone leave
//   most SMs idle, so the group's q heads are split across ``splits``
//   blocks (kernels/flash_attention.py:bwd_splits: the fewest that fill
//   the card).  Each split writes its fp32 dK and dV partials to a
//   scratch, and split_sum_kernel adds them in split order and rounds:
//   the sum is fixed-order too, and two launches give the same bits.
// * dq_kernel: one block of 4 warps per (64-query tile, q head, batch);
//   each warp owns 16 query rows and walks the key tiles its rows see.
// Every element is masked by position (no unmasked fast path yet); rows
// past Tq and keys past Tk load as zeros and are masked.
#include <type_traits>

#include "hopper.cuh"

namespace {

using rt::bf16;

constexpr int BQ = 64, BKV = 64, THREADS = 128;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const bf16 *q, *k, *v, *o, *dout;  // (B, H, T, Dh) bf16
  const float* lse;                  // (B, Hq, Tq)
  bf16 *dq, *dk, *dv;
  float* dsum;                       // (B, Hq, Tq) scratch
  float *pk, *pv;                    // (splits, B, Hk, Tk, Dh) partials
  int B, Hq, Hk, Tq, Tk, causal, window, q_offset, splits;
  float scale, scale_log2;           // Dh^-0.5, and times log2(e)
};

// The dK/dV block: warps sharing a key group (each owning Dh / WPK of the
// columns of dK and dV), its threads, the parts a query tile is taken in
// (QH: a warp holds S^T and dS^T of 64 / QH queries at a time, so that
// the dK and dV accumulators fit the registers at Dh >= 128), and the
// shared-memory tile a key group trades P^T and dS^T through (16 x 64 /
// QH fp32, in the accumulator's own layout).
template <int D>
struct KV {
  static constexpr int WPK = D > 128 ? 2 : 1;
  static constexpr int DC = D / WPK;
  static constexpr int THREADS = 128 * WPK;
  static constexpr int QH = D >= 128 ? 2 : 1;
  static constexpr int QN = 8 / QH;  // n8 tiles of queries a part
  static constexpr int XCHG = WPK > 1 ? 4 * QN * 4 * 32 * 4 : 0;
};


__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// Whether query row qi sees key kp.
__device__ __forceinline__ bool visible(int qi, int kp, const Params& p) {
  const int qp = qi + p.q_offset;
  bool ok = qi < p.Tq && kp < p.Tk;
  if (p.causal) ok = ok && kp <= qp;
  if (p.window > 0) ok = ok && kp > qp - p.window;
  return ok;
}

// 64 rows of a (T, D) matrix from row ``row0`` into a shared tile with
// row pitch D + 8, by the block's NT threads; rows past ``nrows`` are
// zero-filled.
template <int D, int NT = THREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int row0, int nrows) {
  constexpr int LD = D + 8, CH = D / 8;
  for (int c = threadIdx.x; c < 64 * CH; c += NT) {
    const int r = c / CH, cc = (c % CH) * 8;
    const bool in = row0 + r < nrows;
    rt::cp_async16(dst + r * LD + cc,
                   in ? src + static_cast<size_t>(row0 + r) * D + cc : src,
                   in);
  }
}

// Two n8 accumulator tiles (columns [16kk, 16kk + 16)) as a bf16 A
// fragment of a 16 x 16 slice.
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&c0)[4],
                                     const float (&c1)[4]) {
  a[0] = rt::pack_bf16(c0[0], c0[1]);
  a[1] = rt::pack_bf16(c0[2], c0[3]);
  a[2] = rt::pack_bf16(c1[0], c1[1]);
  a[3] = rt::pack_bf16(c1[2], c1[3]);
}

// acc (16 x 8N) = A rows [row0, row0 + 16) of ``at`` times the n x k tile
// ``bt`` transposed (both row-major with pitch LD, k = D).
template <int D, int N>
__device__ __forceinline__ void rows_times_nk(float (&acc)[N][4],
                                              const bf16* at, int row0,
                                              const bf16* bt, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // at Dh >= 128 an unroll of every step hoists enough fragment loads to
  // spill (the dK/dV and dQ accumulators hold 128 registers); 4 does not
#pragma unroll (D >= 128 ? 4 : D / 16)
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    rt::load_a(a, at, LD, row0, kk * 16, lane);
#pragma unroll
    for (int n = 0; n < N; n += 2) {
      uint32_t bb[4];
      rt::load_b_nk(bb, bt, LD, n * 8, kk * 16, lane);
      rt::mma16816(acc[n], a, bb[0], bb[1]);
      rt::mma16816(acc[n + 1], a, bb[2], bb[3]);
    }
  }
}

// What rounding x0, x1 to the bf16 pair ``hi`` left, as a bf16 pair: hi
// + lo carries x to about 2^-17 of itself (x - hi is exact in fp32).
__device__ __forceinline__ uint32_t residual(uint32_t hi, float x0,
                                             float x1) {
  return rt::pack_bf16(x0 - __uint_as_float(hi << 16),
                       x1 - __uint_as_float(hi & 0xffff0000u));
}

// acc (16 x 8 DN) += A (16 x 8 NC, from the n8 tiles ``c``) times columns
// [col0, col0 + 8 DN) of the k x n tile ``bt`` (8 NC rows, pitch D + 8).
// SPLIT: A enters as a split-bf16 pair, hi then lo, each product in turn.
template <int D, int DN = D / 8, int NC = 8, bool SPLIT = false>
__device__ __forceinline__ void add_times_kn(float (&acc)[DN][4],
                                             const float (&c)[NC][4],
                                             const bf16* bt, int lane,
                                             int col0 = 0) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < NC / 2; ++kk) {
    uint32_t a[4], lo[4];
    to_a(a, c[2 * kk], c[2 * kk + 1]);
    if constexpr (SPLIT) {
      const float(&c0)[4] = c[2 * kk];
      const float(&c1)[4] = c[2 * kk + 1];
      lo[0] = residual(a[0], c0[0], c0[1]);
      lo[1] = residual(a[1], c0[2], c0[3]);
      lo[2] = residual(a[2], c1[0], c1[1]);
      lo[3] = residual(a[3], c1[2], c1[3]);
    }
#pragma unroll
    for (int dn = 0; dn < DN; dn += 2) {
      uint32_t bb[4];
      rt::load_b_kn(bb, bt, LD, kk * 16, col0 + dn * 8, lane);
      rt::mma16816(acc[dn], a, bb[0], bb[1]);
      rt::mma16816(acc[dn + 1], a, bb[2], bb[3]);
      if constexpr (SPLIT) {
        rt::mma16816(acc[dn], lo, bb[0], bb[1]);
        rt::mma16816(acc[dn + 1], lo, bb[2], bb[3]);
      }
    }
  }
}

// rows [r0, r0 + 16) x columns [col0, col0 + 8 DN) of a (T, D) matrix from
// this warp's accumulator, times ``mul``, rounded to bf16 (or, OutT =
// float, as they are); rows past ``nrows`` are not written.
template <int D, int DN = D / 8, typename OutT = bf16>
__device__ __forceinline__ void store_rows(OutT* dst,
                                           const float (&acc)[DN][4],
                                           int r0, int nrows, float mul,
                                           int lane, int col0 = 0) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + g + 8 * hr;
    if (r >= nrows) continue;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      OutT* at = dst + static_cast<size_t>(r) * D + col0 + dn * 8 + 2 * t;
      const float lo = acc[dn][2 * hr] * mul, hi = acc[dn][2 * hr + 1] * mul;
      if constexpr (std::is_same_v<OutT, float>)
        *reinterpret_cast<float2*>(at) = make_float2(lo, hi);
      else
        *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(lo, hi);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) dsum_kernel(const Params p) {
  const int rows = p.B * p.Hq * p.Tq;
  const int row = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const bf16* o = p.o + static_cast<size_t>(row) * D;
  const bf16* d = p.dout + static_cast<size_t>(row) * D;
  float acc = 0.f;
#pragma unroll
  for (int c = lane * 2; c < D; c += 64) {
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + c));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(d + c));
    acc += a.x * b.x + a.y * b.y;
  }
#pragma unroll
  for (int off = 16; off; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.dsum[row] = acc;
}

template <int D>
__global__ void __launch_bounds__(KV<D>::THREADS, 1)
    dkdv_kernel(const Params p) {
  using C = KV<D>;
  constexpr int LD = D + 8, DN = C::DC / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BKV * LD;
  bf16* Qs = Vs + BKV * LD;      // [2][BQ * LD]
  bf16* Os = Qs + 2 * BQ * LD;   // dO, [2][BQ * LD]
  float* Ls = reinterpret_cast<float*>(Os + 2 * BQ * LD);  // [2][BQ]
  float* Ss = Ls + 2 * BQ;       // [2][BQ]
  float* Xs = Ss + 2 * BQ;       // [4 key groups][32 values][32 lanes]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // key group kg owns keys [16 kg, 16 kg + 16) of the tile; its warp
  // ``half`` owns columns [half * DC, (half + 1) * DC) of dK and dV
  const int kg = warp % 4, half = warp / 4, col0 = half * C::DC;
  const int k0 = blockIdx.x * BKV, hk = blockIdx.y;
  const int b = blockIdx.z / p.splits, sp = blockIdx.z % p.splits;
  const int group = p.Hq / p.Hk, heads = group / p.splits;
  const size_t bhk = static_cast<size_t>(b) * p.Hk + hk;

  // the query rows that see some key of [k0, k1]
  const int k1 = min(k0 + BKV, p.Tk) - 1;
  const int q_lo = p.causal ? max(0, k0 - p.q_offset) : 0;
  const int q_hi = p.window > 0
                       ? min(p.Tq - 1, k1 - p.q_offset + p.window - 1)
                       : p.Tq - 1;
  const int t_lo = q_lo / BQ;
  const int nt = q_lo <= q_hi ? q_hi / BQ + 1 - t_lo : 0;
  const int items = nt * heads;  // (q head, query tile), heads outermost

  auto load_item = [&](int it, int buf) {
    const size_t bh = static_cast<size_t>(b) * p.Hq + hk * group +
                      sp * heads + it / nt;
    const int q0 = (t_lo + it % nt) * BQ;
    load_tile<D, C::THREADS>(Qs + buf * BQ * LD, p.q + bh * p.Tq * D, q0,
                             p.Tq);
    load_tile<D, C::THREADS>(Os + buf * BQ * LD, p.dout + bh * p.Tq * D, q0,
                             p.Tq);
    if (tid < BQ) {
      const int r = q0 + tid;
      const bool in = r < p.Tq;
      Ls[buf * BQ + tid] = in ? p.lse[bh * p.Tq + r] * kLog2e : pos_inf();
      Ss[buf * BQ + tid] = in ? p.dsum[bh * p.Tq + r] : 0.f;
    }
  };

  load_tile<D, C::THREADS>(Ks, p.k + bhk * p.Tk * D, k0, p.Tk);
  load_tile<D, C::THREADS>(Vs, p.v + bhk * p.Tk * D, k0, p.Tk);
  if (items > 0) load_item(0, 0);
  rt::cp_async_commit();

  float dk[DN][4], dv[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dn][e] = dv[dn][e] = 0.f;

  for (int it = 0; it < items; ++it) {
    const int buf = it & 1;
    if (it + 1 < items) load_item(it + 1, buf ^ 1);
    rt::cp_async_commit();
    rt::cp_async_wait<1>();
    __syncthreads();
    const bf16* Qt = Qs + buf * BQ * LD;
    const bf16* Ot = Os + buf * BQ * LD;
    const float* Lt = Ls + buf * BQ;
    const float* St = Ss + buf * BQ;
    const int q0 = (t_lo + it % nt) * BQ;
#pragma unroll 1
    for (int part = 0; part < C::QH; ++part) {
      constexpr int QN = C::QN;
      const int qb = part * QN * 8;  // the part's first query in the tile
      const bf16* Qp = Qt + qb * LD;
      const bf16* Op = Ot + qb * LD;
      // P^T of this key group's element (n, e), 0 where masked
      auto prob = [&](float st, int n, int e) {
        const int kp = k0 + kg * 16 + g + 8 * (e >> 1);
        const int ql = qb + n * 8 + 2 * t + (e & 1);
        return visible(q0 + ql, kp, p) ? exp2f(st * p.scale_log2 - Lt[ql])
                                       : 0.f;
      };
      auto dsum_at = [&](int n, int e) {
        return St[qb + n * 8 + 2 * t + (e & 1)];
      };

      // this key group's 16 keys x the part's queries: pt = P^T, dst =
      // dS^T
      float pt[QN][4], dst[QN][4];
      if constexpr (C::WPK == 1) {
        // S^T = K Q^T and dP^T = V dO^T; P^T, and dS^T = P^T (dP^T - D)
        rows_times_nk<D, QN>(pt, Ks, kg * 16, Qp, lane);
        rows_times_nk<D, QN>(dst, Vs, kg * 16, Op, lane);
#pragma unroll
        for (int n = 0; n < QN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pt[n][e] = prob(pt[n][e], n, e);
            dst[n][e] = pt[n][e] * (dst[n][e] - dsum_at(n, e));
          }
      } else {
        // half 0: S^T = K Q^T to P^T, which it hands to half 1; half 1:
        // dP^T = V dO^T, then dS^T = P^T (dP^T - D), which it hands back
        float* xg = Xs + kg * QN * 4 * 32;
        if (half == 0) {
          rows_times_nk<D, QN>(pt, Ks, kg * 16, Qp, lane);
#pragma unroll
          for (int n = 0; n < QN; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              pt[n][e] = prob(pt[n][e], n, e);
              xg[(4 * n + e) * 32 + lane] = pt[n][e];
            }
        } else {
          rows_times_nk<D, QN>(dst, Vs, kg * 16, Op, lane);
        }
        rt::named_barrier(1 + kg, 64);
        if (half == 1) {
#pragma unroll
          for (int n = 0; n < QN; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              pt[n][e] = xg[(4 * n + e) * 32 + lane];
              dst[n][e] = pt[n][e] * (dst[n][e] - dsum_at(n, e));
              xg[(4 * n + e) * 32 + lane] = dst[n][e];
            }
        }
        rt::named_barrier(1 + kg, 64);
        if (half == 0) {
#pragma unroll
          for (int n = 0; n < QN; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dst[n][e] = xg[(4 * n + e) * 32 + lane];
        }
      }
      // dV += P^T dO, dK += dS^T Q, on this warp's columns, P^T and dS^T
      // as split-bf16 pairs: summed over a group's heads and queries, their
      // bf16 rounding alone leaves dK and dV outside the bf16 tolerance at
      // MQA 16/1, head_dim 256
      add_times_kn<D, DN, QN, true>(dv, pt, Op, lane, col0);
      add_times_kn<D, DN, QN, true>(dk, dst, Qp, lane, col0);
    }
    __syncthreads();
  }
  rt::cp_async_wait<0>();

  const int r0 = k0 + kg * 16;
  if (p.splits == 1) {
    store_rows<D, DN>(p.dk + bhk * p.Tk * D, dk, r0, p.Tk, p.scale, lane,
                      col0);
    store_rows<D, DN>(p.dv + bhk * p.Tk * D, dv, r0, p.Tk, 1.f, lane, col0);
  } else {  // this split's partials, summed by split_sum_kernel
    const size_t part = (static_cast<size_t>(sp) * p.B * p.Hk + bhk) *
                        p.Tk * D;
    store_rows<D, DN, float>(p.pk + part, dk, r0, p.Tk, 1.f, lane, col0);
    store_rows<D, DN, float>(p.pv + part, dv, r0, p.Tk, 1.f, lane, col0);
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

template <int D>
__global__ void __launch_bounds__(THREADS) dq_kernel(const Params p) {
  constexpr int LD = D + 8, DN = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Os = Qs + BQ * LD;       // dO
  bf16* Ks = Os + BQ * LD;       // [2][BKV * LD]
  bf16* Vs = Ks + 2 * BKV * LD;  // [2][BKV * LD]
  float* Ls = reinterpret_cast<float*>(Vs + 2 * BKV * LD);  // [BQ]
  float* Ss = Ls + BQ;           // [BQ]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * p.Hq + h;
  const size_t bhk = static_cast<size_t>(b) * p.Hk + h / (p.Hq / p.Hk);
  const bf16* kb = p.k + bhk * p.Tk * D;
  const bf16* vb = p.v + bhk * p.Tk * D;

  // the key tiles some row of the tile sees
  const int first = q0 + p.q_offset;
  const int last = min(q0 + BQ, p.Tq) - 1 + p.q_offset;
  const int k_min = p.window > 0 ? max(0, first - p.window + 1) : 0;
  const int k_max = p.causal ? min(p.Tk - 1, last) : p.Tk - 1;
  const int j_lo = k_min / BKV;
  const int j_hi = k_min <= k_max ? k_max / BKV + 1 : j_lo;

  load_tile<D>(Qs, p.q + bh * p.Tq * D, q0, p.Tq);
  load_tile<D>(Os, p.dout + bh * p.Tq * D, q0, p.Tq);
  if (j_lo < j_hi) {
    load_tile<D>(Ks, kb, j_lo * BKV, p.Tk);
    load_tile<D>(Vs, vb, j_lo * BKV, p.Tk);
  }
  rt::cp_async_commit();
  if (tid < BQ) {
    const int r = q0 + tid;
    const bool in = r < p.Tq;
    Ls[tid] = in ? p.lse[bh * p.Tq + r] * kLog2e : pos_inf();
    Ss[tid] = in ? p.dsum[bh * p.Tq + r] : 0.f;
  }

  float dq[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[dn][e] = 0.f;

  for (int j = j_lo; j < j_hi; ++j) {
    const int buf = (j - j_lo) & 1;
    if (j + 1 < j_hi) {
      load_tile<D>(Ks + (buf ^ 1) * BKV * LD, kb, (j + 1) * BKV, p.Tk);
      load_tile<D>(Vs + (buf ^ 1) * BKV * LD, vb, (j + 1) * BKV, p.Tk);
    }
    rt::cp_async_commit();
    rt::cp_async_wait<1>();
    __syncthreads();
    const bf16* Kt = Ks + buf * BKV * LD;
    const bf16* Vt = Vs + buf * BKV * LD;

    // a key tile in KH parts of 64 / KH keys (the dQ accumulator alone is
    // 128 fp32 a thread at Dh = 256)
    constexpr int KH = D > 128 ? 2 : 1, KN = 8 / KH;
#pragma unroll 1
    for (int part = 0; part < KH; ++part) {
      const int kb = part * KN * 8;  // the part's first key in the tile
      // S = Q K^T and dP = dO V^T: this warp's 16 rows x the part's keys
      float s[KN][4], dp[KN][4];
      rows_times_nk<D, KN>(s, Qs, warp * 16, Kt + kb * LD, lane);
      rows_times_nk<D, KN>(dp, Os, warp * 16, Vt + kb * LD, lane);
      // dS = P (dP - D) in place
#pragma unroll
      for (int n = 0; n < KN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = warp * 16 + g + 8 * (e >> 1);
          const int kp = j * BKV + kb + n * 8 + 2 * t + (e & 1);
          const float pv = visible(q0 + ql, kp, p)
                               ? exp2f(s[n][e] * p.scale_log2 - Ls[ql])
                               : 0.f;
          dp[n][e] = pv * (dp[n][e] - Ss[ql]);
        }
      // dQ += dS K
      add_times_kn<D, DN, KN>(dq, dp, Kt + kb * LD, lane);
    }
    __syncthreads();
  }
  rt::cp_async_wait<0>();

  store_rows<D>(p.dq + bh * p.Tq * D, dq, q0 + warp * 16, p.Tq, p.scale,
                lane);
}

template <int D>
constexpr int smem_bytes() {
  // dK/dV: K, V, two Q and two dO tiles, two lse and two D rows, and the
  // key groups' P^T / dS^T trade at Dh = 256; dQ: Q, dO, two K and two V
  // tiles, one lse and one D row (no larger)
  return 6 * 64 * (D + 8) * 2 + 4 * BQ * 4 + KV<D>::XCHG;
}

template <int D>
int launch(const Params& p, cudaStream_t s) {
  const int rows = p.B * p.Hq * p.Tq;
  dsum_kernel<D><<<(rows + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0,
                   s>>>(p);
  cudaError_t rc = cudaGetLastError();
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute(dkdv_kernel<D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes<D>());
  if (rc == cudaSuccess) {
    dkdv_kernel<D><<<dim3((p.Tk + BKV - 1) / BKV, p.Hk, p.B * p.splits),
                     KV<D>::THREADS, smem_bytes<D>(), s>>>(p);
    rc = cudaGetLastError();
  }
  if (rc == cudaSuccess && p.splits > 1) {
    const size_t n = static_cast<size_t>(p.B) * p.Hk * p.Tk * D;
    split_sum_kernel<<<dim3(static_cast<unsigned>((n / 4 + 255) / 256), 2),
                       256, 0, s>>>(p, n);
    rc = cudaGetLastError();
  }
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute(dq_kernel<D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes<D>());
  if (rc == cudaSuccess) {
    dq_kernel<D><<<dim3((p.Tq + BQ - 1) / BQ, p.Hq, p.B), THREADS,
                   smem_bytes<D>(), s>>>(p);
    rc = cudaGetLastError();
  }
  return static_cast<int>(rc);
}

}  // namespace

// dq, dk, dv (bf16, the shapes of q, k, v) on ``stream``; ``dsum`` is a
// (B, Hq, Tq) fp32 scratch; ``partials``: with ``splits`` > 1 (which must
// divide Hq / Hk), 2 x (splits, B, Hk, Tk, Dh) fp32 of scratch for dK's
// and dV's partials, else null.  Kernels in order: D, dK/dV, the splits'
// sum, dQ.  Returns the first cudaError_t.
extern "C" int rt_flash_attention_bwd(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const void* lse,
                                      void* dq, void* dk, void* dv,
                                      void* dsum, void* partials, int B,
                                      int Hq, int Hk, int Tq, int Tk, int D,
                                      int causal, int window, int q_offset,
                                      int splits, void* stream) {
  if (B < 1 || Hk < 1 || Hq > 65535 || Hq % Hk || Tq < 1 || Tk < 1 ||
      q_offset < 0 || window < 0 || splits < 1 || (Hq / Hk) % splits ||
      static_cast<long long>(B) * splits > 65535 ||
      (splits > 1 && partials == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<const bf16*>(o);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.dsum = static_cast<float*>(dsum);
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
  if (D == 256) return launch<256>(p, s);
  if (D == 128) return launch<128>(p, s);
  if (D == 64) return launch<64>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

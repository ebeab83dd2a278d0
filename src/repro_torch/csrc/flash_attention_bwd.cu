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
// P and dS rounded to bf16 as they enter a product; q-head h reads kv-head
// h / (Hq / Hk), and dK, dV sum over the group's q heads.  A row that saw
// no key has lse = +inf (the forward writes it so) and gives zero
// gradients; masked entries are zero whatever lse holds.
//
// Bound on an H100: 10 * Tq * Tk * Dh FLOP a head (five products, halved
// by the causal mask) against a few MB of operands: compute-bound at
// training lengths, on the tensor cores.  This first kernel is the simple
// design, right before fast (mma.sync m16n8k16 fed by ldmatrix from
// cp.async double buffers, PR 12's level; no TMA or wgmma yet):
// * dsum_kernel: D = rowsum(dO o) in fp32, one warp a row.
// * dkdv_kernel: one block of 4 warps per (64-key tile, kv head, batch);
//   each warp owns 16 keys and keeps their dK and dV in registers.  The
//   block walks the q heads of its group in order and, for each, the
//   64-query tiles that see some key of the tile, so the GQA sum is a
//   fixed-order sum in registers: no atomics, and two launches give the
//   same bits.
// * dq_kernel: one block of 4 warps per (64-query tile, q head, batch);
//   each warp owns 16 query rows and walks the key tiles its rows see.
// Every element is masked by position (no unmasked fast path yet); rows
// past Tq and keys past Tk load as zeros and are masked.
#include "common.cuh"

namespace {

using rt::bf16;

constexpr int BQ = 64, BKV = 64, THREADS = 128;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const bf16 *q, *k, *v, *o, *dout;  // (B, H, T, Dh) bf16
  const float* lse;                  // (B, Hq, Tq)
  bf16 *dq, *dk, *dv;
  float* dsum;                       // (B, Hq, Tq) scratch
  int B, Hq, Hk, Tq, Tk, causal, window, q_offset;
  float scale, scale_log2;           // Dh^-0.5, and times log2(e)
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
// row pitch D + 8; rows past ``nrows`` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int row0, int nrows) {
  constexpr int LD = D + 8, CH = D / 8;
  for (int c = threadIdx.x; c < 64 * CH; c += THREADS) {
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
#pragma unroll
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

// acc (16 x D) += A (16 x 64, from the n8 tiles ``c``) times the k x n
// tile ``bt`` (64 rows, pitch LD).
template <int D>
__device__ __forceinline__ void add_times_kn(float (&acc)[D / 8][4],
                                             const float (&c)[8][4],
                                             const bf16* bt, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    to_a(a, c[2 * kk], c[2 * kk + 1]);
#pragma unroll
    for (int dn = 0; dn < D / 8; dn += 2) {
      uint32_t bb[4];
      rt::load_b_kn(bb, bt, LD, kk * 16, dn * 8, lane);
      rt::mma16816(acc[dn], a, bb[0], bb[1]);
      rt::mma16816(acc[dn + 1], a, bb[2], bb[3]);
    }
  }
}

// rows [r0, r0 + 16) of a (T, D) bf16 matrix from this warp's
// accumulator, times ``mul``; rows past ``nrows`` are not written.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[D / 8][4],
                                           int r0, int nrows, float mul,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + g + 8 * hr;
    if (r >= nrows) continue;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<__nv_bfloat162*>(dst + static_cast<size_t>(r) * D +
                                         dn * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[dn][2 * hr] * mul,
                                acc[dn][2 * hr + 1] * mul);
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
__global__ void __launch_bounds__(THREADS) dkdv_kernel(const Params p) {
  constexpr int LD = D + 8, DN = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BKV * LD;
  bf16* Qs = Vs + BKV * LD;      // [2][BQ * LD]
  bf16* Os = Qs + 2 * BQ * LD;   // dO, [2][BQ * LD]
  float* Ls = reinterpret_cast<float*>(Os + 2 * BQ * LD);  // [2][BQ]
  float* Ss = Ls + 2 * BQ;       // [2][BQ]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BKV, hk = blockIdx.y, b = blockIdx.z;
  const int group = p.Hq / p.Hk;
  const size_t bhk = static_cast<size_t>(b) * p.Hk + hk;

  // the query rows that see some key of [k0, k1]
  const int k1 = min(k0 + BKV, p.Tk) - 1;
  const int q_lo = p.causal ? max(0, k0 - p.q_offset) : 0;
  const int q_hi = p.window > 0
                       ? min(p.Tq - 1, k1 - p.q_offset + p.window - 1)
                       : p.Tq - 1;
  const int t_lo = q_lo / BQ;
  const int nt = q_lo <= q_hi ? q_hi / BQ + 1 - t_lo : 0;
  const int items = nt * group;  // (q head, query tile), heads outermost

  auto load_item = [&](int it, int buf) {
    const size_t bh = static_cast<size_t>(b) * p.Hq + hk * group + it / nt;
    const int q0 = (t_lo + it % nt) * BQ;
    load_tile<D>(Qs + buf * BQ * LD, p.q + bh * p.Tq * D, q0, p.Tq);
    load_tile<D>(Os + buf * BQ * LD, p.dout + bh * p.Tq * D, q0, p.Tq);
    if (tid < BQ) {
      const int r = q0 + tid;
      const bool in = r < p.Tq;
      Ls[buf * BQ + tid] = in ? p.lse[bh * p.Tq + r] * kLog2e : pos_inf();
      Ss[buf * BQ + tid] = in ? p.dsum[bh * p.Tq + r] : 0.f;
    }
  };

  load_tile<D>(Ks, p.k + bhk * p.Tk * D, k0, p.Tk);
  load_tile<D>(Vs, p.v + bhk * p.Tk * D, k0, p.Tk);
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

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 64 queries
    float st[8][4], dpt[8][4];
    rows_times_nk<D>(st, Ks, warp * 16, Qt, lane);
    rows_times_nk<D>(dpt, Vs, warp * 16, Ot, lane);
    // P^T, and dS^T = P^T (dP^T - D) in place
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + warp * 16 + g + 8 * (e >> 1);
        const int ql = n * 8 + 2 * t + (e & 1);
        const float pv = visible(q0 + ql, kp, p)
                             ? exp2f(st[n][e] * p.scale_log2 - Lt[ql])
                             : 0.f;
        st[n][e] = pv;
        dpt[n][e] = pv * (dpt[n][e] - St[ql]);
      }
    // dV += P^T dO, dK += dS^T Q
    add_times_kn<D>(dv, st, Ot, lane);
    add_times_kn<D>(dk, dpt, Qt, lane);
    __syncthreads();
  }
  rt::cp_async_wait<0>();

  store_rows<D>(p.dk + bhk * p.Tk * D, dk, k0 + warp * 16, p.Tk, p.scale,
                lane);
  store_rows<D>(p.dv + bhk * p.Tk * D, dv, k0 + warp * 16, p.Tk, 1.f, lane);
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

    // S = Q K^T and dP = dO V^T: this warp's 16 rows x 64 keys
    float s[8][4], dp[8][4];
    rows_times_nk<D>(s, Qs, warp * 16, Kt, lane);
    rows_times_nk<D>(dp, Os, warp * 16, Vt, lane);
    // dS = P (dP - D) in place
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = warp * 16 + g + 8 * (e >> 1);
        const int kp = j * BKV + n * 8 + 2 * t + (e & 1);
        const float pv = visible(q0 + ql, kp, p)
                             ? exp2f(s[n][e] * p.scale_log2 - Ls[ql])
                             : 0.f;
        dp[n][e] = pv * (dp[n][e] - Ss[ql]);
      }
    // dQ += dS K
    add_times_kn<D>(dq, dp, Kt, lane);
    __syncthreads();
  }
  rt::cp_async_wait<0>();

  store_rows<D>(p.dq + bh * p.Tq * D, dq, q0 + warp * 16, p.Tq, p.scale,
                lane);
}

template <int D>
constexpr int smem_bytes() {
  // dK/dV: K, V, two Q and two dO tiles, two lse and two D rows; dQ: Q,
  // dO, two K and two V tiles, one lse and one D row (no larger)
  return 6 * 64 * (D + 8) * 2 + 4 * BQ * 4;
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
    dkdv_kernel<D><<<dim3((p.Tk + BKV - 1) / BKV, p.Hk, p.B), THREADS,
                     smem_bytes<D>(), s>>>(p);
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
// (B, Hq, Tq) fp32 scratch.  Three kernels in order: D, then dK/dV, then
// dQ.  Returns the first cudaError_t.
extern "C" int rt_flash_attention_bwd(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const void* lse,
                                      void* dq, void* dk, void* dv,
                                      void* dsum, int B, int Hq, int Hk,
                                      int Tq, int Tk, int D, int causal,
                                      int window, int q_offset,
                                      void* stream) {
  if (B < 1 || B > 65535 || Hk < 1 || Hq > 65535 || Hq % Hk || Tq < 1 ||
      Tk < 1 || q_offset < 0 || window < 0)
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
  p.B = B, p.Hq = Hq, p.Hk = Hk, p.Tq = Tq, p.Tk = Tk;
  p.causal = causal, p.window = window, p.q_offset = q_offset;
  // as the forward computes them, so that P is the forward's
  p.scale = 1.f / sqrtf(static_cast<float>(D));
  p.scale_log2 = kLog2e / sqrtf(static_cast<float>(D));
  auto s = static_cast<cudaStream_t>(stream);
  if (D == 128) return launch<128>(p, s);
  if (D == 64) return launch<64>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

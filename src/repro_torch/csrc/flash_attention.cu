// Online-softmax (flash) attention with GQA, causal / local-window masks
// and a query position offset.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:flash_attention
// and computes what it computes: S = (q k^T) * Dh^-0.5 with fp32
// accumulation, masked entries at -1e30 with explicit zero guards (a row
// with nothing unmasked gives zeros), P rounded to bf16 before P V, the
// fp32 running max / sum / accumulator rescaled per key tile, and
// q-head h reading kv-head h / (Hq / Hk).
//
// Bound on an H100: at prefill lengths (T <= 1024, Dh = 128) the work is
// small and compute-light -- q, k, v and o are a few MB -- so launch and
// latency dominate; at long T it is compute-bound (4 * Tq * Tk * Dh FLOP
// per head, halved by the causal mask).  Design: one block of 4 warps per
// (64-query tile, head, batch); each warp owns 16 query rows and keeps its
// Q fragments, running max/sum and output accumulator in registers (the
// mma.sync fragment layout lets the rescale address rows directly, and
// P goes from the S accumulators straight into A fragments without a trip
// through shared memory).  Key/value tiles of 64 rows stream through a
// two-stage cp.async ring.  Key tiles that the causal or window mask
// hides from every row of the query tile are skipped; ragged Tq / Tk edges
// load as zeros and are masked.  The TPU's (batch*heads, q, kv) grid with
// kv innermost becomes the kv loop inside one block.
#include "common.cuh"

namespace {

using rt::bf16;

constexpr int BQ = 64, BKV = 64, THREADS = 128;

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o, int Hq, int Hk,
             int Tq, int Tk, int causal, int window, int q_offset,
             float scale) {
  constexpr int LD = D + 8;
  constexpr int DN = D / 8;       // n8 tiles of the output row
  constexpr int KN = BKV / 8;     // n8 tiles of one S row block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BQ * LD;        // [2][BKV * LD]
  bf16* Vs = Ks + 2 * BKV * LD;   // [2][BKV * LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hk);
  const bf16* qb = q + ((size_t)b * Hq + h) * Tq * D;
  const bf16* kb = k + ((size_t)b * Hk + hk) * Tk * D;
  const bf16* vb = v + ((size_t)b * Hk + hk) * Tk * D;
  bf16* ob = o + ((size_t)b * Hq + h) * Tq * D;

  // key tiles some row of this query tile can see
  const int nk = (Tk + BKV - 1) / BKV;
  int j_hi = nk;
  if (causal) {
    const int last = q0 + BQ - 1 + q_offset;  // largest visible key
    j_hi = last < 0 ? 0 : min(nk, last / BKV + 1);
  }
  int j_lo = 0;
  if (window > 0) {
    const int first = q0 + q_offset - window + 1;  // smallest visible key
    j_lo = first > 0 ? first / BKV : 0;
  }

  constexpr int CH = D / 8;  // 16-byte chunks per row
  auto load_rows = [&](bf16* dst, const bf16* src, int row0, int nrows) {
    for (int c = tid; c < BQ * CH; c += THREADS) {
      const int r = c / CH, cc = (c % CH) * 8;
      const bool in = row0 + r < nrows;
      rt::cp_async16(dst + r * LD + cc,
                     in ? src + (size_t)(row0 + r) * D + cc : src, in);
    }
  };

  load_rows(Qs, qb, q0, Tq);
  if (j_lo < j_hi) {
    load_rows(Ks, kb, j_lo * BKV, Tk);
    load_rows(Vs, vb, j_lo * BKV, Tk);
  }
  rt::cp_async_commit();

  float m_run[2] = {rt::kNeg, rt::kNeg}, l_run[2] = {0.f, 0.f};
  float acc[DN][4];
#pragma unroll
  for (int j = 0; j < DN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  uint32_t qa[D / 16][4];

  const int row_base = q0 + warp * 16;
  for (int j = j_lo; j < j_hi; ++j) {
    const int st = (j - j_lo) & 1;
    if (j + 1 < j_hi) {
      load_rows(Ks + (st ^ 1) * BKV * LD, kb, (j + 1) * BKV, Tk);
      load_rows(Vs + (st ^ 1) * BKV * LD, vb, (j + 1) * BKV, Tk);
    }
    rt::cp_async_commit();
    rt::cp_async_wait<1>();
    __syncthreads();
    if (j == j_lo) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        rt::load_a(qa[kk], Qs, LD, warp * 16, kk * 16, lane);
    }
    const bf16* Kt = Ks + st * BKV * LD;
    const bf16* Vt = Vs + st * BKV * LD;

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[KN][4];
#pragma unroll
    for (int n = 0; n < KN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int n = 0; n < KN; n += 2) {
        uint32_t bb[4];
        rt::load_b_nk(bb, Kt, LD, n * 8, kk * 16, lane);
        rt::mma16816(s[n], qa[kk], bb[0], bb[1]);
        rt::mma16816(s[n + 1], qa[kk], bb[2], bb[3]);
      }

    // scale + mask, row max over the tile
    float mx[2] = {rt::kNeg, rt::kNeg};
#pragma unroll
    for (int n = 0; n < KN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        const int qpos = row_base + g + hr * 8 + q_offset;
        const int kpos = j * BKV + n * 8 + 2 * t + (e & 1);
        bool ok = kpos < Tk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        const float val = ok ? s[n][e] * scale : rt::kNeg;
        s[n][e] = val;
        mx[hr] = fmaxf(mx[hr], val);
      }
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      const float m_new = fmaxf(m_run[hr], mx[hr]);
      alpha[hr] = m_run[hr] > rt::kNeg / 2 ? __expf(m_run[hr] - m_new) : 0.f;
      m_run[hr] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < KN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        const float p =
            s[n][e] > rt::kNeg / 2 ? __expf(s[n][e] - m_run[hr]) : 0.f;
        s[n][e] = p;
        rs[hr] += p;
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 1);
      rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 2);
      l_run[hr] = l_run[hr] * alpha[hr] + rs[hr];
    }
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      acc[dn][0] *= alpha[0];
      acc[dn][1] *= alpha[0];
      acc[dn][2] *= alpha[1];
      acc[dn][3] *= alpha[1];
    }

    // O += P V: P (bf16) straight from the S accumulators as A fragments
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = rt::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = rt::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = rt::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = rt::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dn = 0; dn < DN; dn += 2) {
        uint32_t bb[4];
        rt::load_b_kn(bb, Vt, LD, kk * 16, dn * 8, lane);
        rt::mma16816(acc[dn], pa, bb[0], bb[1]);
        rt::mma16816(acc[dn + 1], pa, bb[2], bb[3]);
      }
    }
    __syncthreads();
  }
  rt::cp_async_wait<0>();

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row_base + g + hr * 8;
    if (r >= Tq) continue;
    const float inv = l_run[hr] == 0.f ? 1.f : 1.f / l_run[hr];
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      const int c = dn * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r * D + c) =
          __floats2bfloat162_rn(acc[dn][2 * hr] * inv,
                                acc[dn][2 * hr + 1] * inv);
    }
  }
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B,
           int Hq, int Hk, int Tq, int Tk, int causal, int window,
           int q_offset, cudaStream_t stream) {
  const int smem = (BQ + 4 * BKV) * (D + 8) * (int)sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tq + BQ - 1) / BQ, Hq, B);
  flash_kernel<D><<<grid, THREADS, smem, stream>>>(
      q, k, v, o, Hq, Hk, Tq, Tk, causal, window, q_offset,
      1.0f / sqrtf((float)D));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rt_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, int B, int Hq, int Hk, int Tq,
                                  int Tk, int D, int causal, int window,
                                  int q_offset, void* stream) {
  auto* qq = static_cast<const bf16*>(q);
  auto* kk = static_cast<const bf16*>(k);
  auto* vv = static_cast<const bf16*>(v);
  auto* oo = static_cast<bf16*>(o);
  auto s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch<128>(qq, kk, vv, oo, B, Hq, Hk, Tq, Tk, causal, window,
                       q_offset, s);
  if (D == 64)
    return launch<64>(qq, kk, vv, oo, B, Hq, Hk, Tq, Tk, causal, window,
                      q_offset, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

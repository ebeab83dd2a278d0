// Online-softmax (flash) attention with GQA, causal / local-window masks
// and a query position offset.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:flash_attention
// and computes what it computes: S = (q k^T) * Dh^-0.5 with fp32
// accumulation, masked entries at -1e30 with explicit zero guards (a row
// with nothing unmasked gives zeros), P rounded to bf16 before P V, the
// fp32 running max / sum / accumulator rescaled per key tile, the divide
// by l with l == 0 taken as 1, and q-head h reading kv-head h / (Hq / Hk).
//
// Bound on an H100: 4 * Tq * Tk * Dh FLOP per head (halved by the causal
// mask, cut to about 4 * Tq * window * Dh by a local window) against a few
// MB of q, k, v and o, so at prefill lengths it is compute-bound, on the
// tensor cores.  Design, for wgmma's rate:
// * One block per (query tile of BQ = 64 or 128 rows, q-head, batch),
//   launched heaviest first: kernels/flash_attention.py:schedule sorts the
//   query tiles by their number of key tiles and passes that order, so the
//   last wave is short blocks, not long ones.
// * Warpgroup 0 is the producer: one thread issues every TMA load, the Q
//   tile once, then the K and V tiles of BKV keys (128 at Dh <= 128, 64 at
//   Dh = 256) into a ring as deep as shared memory allows (``stages``: 3
//   at Dh = 128), each stage with a "full" mbarrier for K, one for V, and
//   an "empty" one its consumers release.  It runs ahead bounded only by
//   the empty barriers; the key loop has no __syncthreads.  q, k, v and o are (Dh, T, B * H) tensor maps with the
//   128-byte swizzle (a row arrives as Dh / 64 boxes 64 wide), so rows past
//   Tq or Tk read as zeros and a ragged output tile's store stops at Tq
//   instead of reaching the next head's rows.
// * Warpgroups 1.. are the consumers, 64 query rows each (setmaxnreg moves
//   registers to them from the producer where there are two).  S = Q K^T
//   is wgmma m64nBKVk16 with Q and K (K-major as [keys, Dh] rows) read from
//   shared memory; O += P V is wgmma m64nDhk16 with P from registers (the
//   S accumulators turn into A fragments in place) and V read N-major
//   through the descriptor's transpose bit.  Tile j's Q K^T and tile j-1's
//   P V are issued together; tile j's softmax runs while P V is on the
//   tensor cores.  Two consumer groups (Dh <= 128) also take turns issuing
//   their products, so that one group's softmax runs under the other's
//   products.  Row max and sum are quad shuffles; the exponential is exp2
//   of one FMA with scale * log2(e) folded in.
// * Masks only where needed: the key tiles every row of the query tile
//   sees whole run no mask code; those on the causal diagonal, on the
//   window's lower edge or past Tk do.
// * The output is rounded to bf16 into the consumer's own rows of the Q
//   tile and leaves by TMA stores.
// The TPU's (batch * heads, q, kv) grid with kv innermost becomes the
// key loop inside one block.
#include <type_traits>

#include "hopper.cuh"

namespace {

using rt::bf16;

constexpr int MAX_STAGES = 4;
constexpr int MAX_TILES = 1024;  // query tiles the launch order can list
constexpr int BAR_BYTES = 256;   // the Q, full and empty mbarriers
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  CUtensorMap q, k, v, o;  // (Dh, T, B * H) bf16, 128-byte swizzle
  float* lse;              // (B * Hq, Tq) row logsumexp, written if LSE
  int B, Hq, Hk, Tq, Tk, causal, window, q_offset, stages;
  float scale_log2;            // Dh^-0.5 * log2(e)
  uint16_t order[MAX_TILES];   // query tiles, heaviest first
};

template <int D, int BQ>
struct Cfg {
  static constexpr int NC = BQ / 64;  // consumer warpgroups
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int BKV = D == 256 ? 64 : 128;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BKV * D * 2;  // one K or one V tile
  static constexpr int QBOX = BQ * 128;         // one 64-column box of Q
  static constexpr int KVBOX = BKV * 128;       // ... of K or V
  static constexpr int SN = BKV / 2, ON = D / 2;  // fp32 S and O a thread
  // two consumer groups take turns on the tensor cores (not at Dh = 256,
  // where the products dwarf the softmax and the turns cost more than
  // they hide)
  static constexpr bool PINGPONG = NC == 2 && D < 256;
  // the ring, its barriers, and the slack to align it to the 128-byte
  // swizzle's 1024-byte pattern
  static constexpr int smem_bytes(int stages) {
    return 1024 + Q_BYTES + 2 * stages * KV_BYTES + BAR_BYTES;
  }
};

// The key tiles [lo, hi) some row of a query tile sees, and among them
// [full_lo, full_hi), the ones every row sees whole (no mask needed);
// rows past Tq do not count.  kernels/flash_attention.py:key_tiles
// computes the same.
struct Span {
  int lo, full_lo, full_hi, hi;
};

__device__ __forceinline__ Span key_span(int q0, int bq, int bkv,
                                         const Params& p) {
  const int first = q0 + p.q_offset;                     // first row
  const int last = min(q0 + bq, p.Tq) - 1 + p.q_offset;  // last real row
  const int k_min = p.window > 0 ? max(0, first - p.window + 1) : 0;
  const int k_max = p.causal ? min(p.Tk - 1, last) : p.Tk - 1;
  if (k_min > k_max) return {0, 0, 0, 0};
  // keys every real row sees
  const int f_min = p.window > 0 ? max(0, last - p.window + 1) : 0;
  const int f_max = p.causal ? min(p.Tk - 1, first) : p.Tk - 1;
  Span s;
  s.lo = k_min / bkv;
  s.hi = k_max / bkv + 1;
  // clamped to hi: with a window and Tq > Tk the rows' last key can lie
  // past every key tile, and an unclamped full_lo would send the masked
  // loop to tiles the producer never loads
  s.full_lo = min(s.hi, max(s.lo, (f_min + bkv - 1) / bkv));
  s.full_hi = max(s.full_lo, min(s.hi, (f_max + 1) / bkv));
  return s;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Tile j's scores s (this thread's part of the m64nBKV accumulator) to
// probabilities, in place: the mask (MASK only), the running max m, the
// rescale factor alpha of the rows' earlier sums, and the thread's part
// of the running row sums l.  kbase: the key of s[0]; qpos: the position
// of the thread's first row (its second is 8 further).
template <bool MASK, int SN>
__device__ __forceinline__ void softmax(float (&s)[SN], float (&m)[2],
                                        float (&l)[2], float (&alpha)[2],
                                        int kbase, int qpos,
                                        const Params& p) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < SN / 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      if constexpr (MASK) {
        const int qp = qpos + 8 * h, kp = kbase + 8 * n + (e & 1);
        bool ok = kp < p.Tk;
        if (p.causal) ok = ok && kp <= qp;
        if (p.window > 0) ok = ok && kp > qp - p.window;
        if (!ok) s[4 * n + e] = rt::kNeg;
      }
      mx[h] = fmaxf(mx[h], s[4 * n + e]);
    }
  float mc[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    alpha[h] =
        m[h] > rt::kNeg / 2 ? ex2((m[h] - mx[h]) * p.scale_log2) : 0.f;
    m[h] = mx[h];
    mc[h] = mx[h] * p.scale_log2;
  }
#pragma unroll
  for (int i = 0; i < SN; ++i) {
    const int h = (i >> 1) & 1;
    float e = ex2(fmaf(s[i], p.scale_log2, -mc[h]));
    if constexpr (MASK) e = s[i] > rt::kNeg / 2 ? e : 0.f;
    s[i] = e;
    rs[h] += e;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
}

// LSE: also write each row's logsumexp of its scaled scores, m * scale +
// ln(l) (+inf for a row that saw no key), which the backward reads.  A
// template flag, not a run-time branch: it is read only in the epilogue,
// after the last wgmma wait, and serving's kernel holds no trace of it.
template <int D, int BQ, bool LSE>
__global__ void __launch_bounds__(Cfg<D, BQ>::THREADS, 1)
    flash_kernel(const __grid_constant__ Params p) {
  using C = Cfg<D, BQ>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (rt::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = smem;
  uint8_t* Ks = Qs + C::Q_BYTES;
  uint8_t* Vs = Ks + p.stages * C::KV_BYTES;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(Vs + p.stages * C::KV_BYTES);
  uint64_t* full_k = qbar + 1;
  uint64_t* full_v = full_k + MAX_STAGES;
  uint64_t* empty = full_v + MAX_STAGES;

  const int heads = p.B * p.Hq;
  const int tile = p.order[blockIdx.x / heads];
  const int bh = blockIdx.x % heads;  // b * Hq + h
  const int bhk = bh / p.Hq * p.Hk + bh % p.Hq / (p.Hq / p.Hk);
  const int q0 = tile * BQ;
  const Span sp = key_span(q0, BQ, C::BKV, p);

  if (threadIdx.x == 0) {
    rt::mbar_init(qbar, 1);
    for (int s = 0; s < p.stages; ++s) {
      rt::mbar_init(&full_k[s], 1);       // the producer's expect_tx
      rt::mbar_init(&full_v[s], 1);
      rt::mbar_init(&empty[s], C::NC);    // one arrival per consumer group
    }
    rt::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the ring full ----------------------
    if constexpr (C::NC == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      rt::mbar_expect_tx(qbar, C::Q_BYTES);
#pragma unroll
      for (int x = 0; x < D / 64; ++x)
        rt::tma_load_3d(Qs + x * C::QBOX, &p.q, 64 * x, q0, bh, qbar);
      int stage = 0;
      uint32_t phase = 0;
      for (int j = sp.lo; j < sp.hi; ++j) {
        rt::mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* kd = Ks + stage * C::KV_BYTES;
        uint8_t* vd = Vs + stage * C::KV_BYTES;
        rt::mbar_expect_tx(&full_k[stage], C::KV_BYTES);
#pragma unroll
        for (int x = 0; x < D / 64; ++x)
          rt::tma_load_3d(kd + x * C::KVBOX, &p.k, 64 * x, j * C::BKV, bhk,
                          &full_k[stage]);
        rt::mbar_expect_tx(&full_v[stage], C::KV_BYTES);
#pragma unroll
        for (int x = 0; x < D / 64; ++x)
          rt::tma_load_3d(vd + x * C::KVBOX, &p.v, 64 * x, j * C::BKV, bhk,
                          &full_v[stage]);
        if (++stage == p.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: query rows [64 (wg - 1), 64 wg) of the tile ----------
    if constexpr (C::NC == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1, warp = threadIdx.x / 32 % 4,
              lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const bool leader = threadIdx.x % 128 == 0;
    const int qpos = q0 + cw * 64 + warp * 16 + g + p.q_offset;
    // Q: rows 128 bytes apart, 8-row swizzle atoms 1024 apart, a k16 slice
    // 32 bytes along the row, a 64-column box QBOX further; K the same in
    // KVBOX boxes.  V (N-major): 64-column boxes KVBOX apart (leading
    // offset), 8-key atoms 1024 apart (stride offset), a k16 slice 16 keys
    // further.
    const uint8_t* qa = Qs + cw * 64 * 128;

    float o[C::ON];
#pragma unroll
    for (int i = 0; i < C::ON; ++i) o[i] = 0.f;
    float m[2] = {rt::kNeg, rt::kNeg}, l[2] = {0.f, 0.f};
    float s[C::SN];
    uint32_t pa[C::BKV / 16][4];

    int stage = 0, prev = 0;
    uint32_t phase = 0, prev_phase = 0;
    auto advance = [&] {
      prev = stage;
      prev_phase = phase;
      if (++stage == p.stages) {
        stage = 0;
        phase ^= 1;
      }
    };
    // S = Q K^T of the tile in ``stage``, issued and committed
    auto qk = [&] {
      const uint8_t* kt = Ks + stage * C::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        rt::Wgmma<C::BKV, 0>::ss(
            s, rt::desc(qa + kk / 4 * C::QBOX + kk % 4 * 32, 16, 1024),
            rt::desc(kt + kk / 4 * C::KVBOX + kk % 4 * 32, 16, 1024),
            kk > 0);
      rt::wgmma_commit();
    };
    // O += P V of the tile in ``prev``, issued and committed
    auto pv = [&] {
      rt::mbar_wait(&full_v[prev], prev_phase);
      const uint8_t* vt = Vs + prev * C::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < C::BKV / 16; ++kk)
        rt::Wgmma<D, 1>::rs(o, pa[kk],
                            rt::desc(vt + kk * 16 * 128, C::KVBOX, 1024));
      rt::wgmma_commit();
    };
    // P's A fragment for keys [16kk, 16kk + 16): S's n8 tiles 2kk, 2kk+1
    auto to_p = [&] {
#pragma unroll
      for (int kk = 0; kk < C::BKV / 16; ++kk) {
        pa[kk][0] = rt::pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = rt::pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = rt::pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = rt::pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };
    // Tile j: its Q K^T and tile j-1's P V issued together, tile j's
    // softmax while P V runs, then O rescaled and tile j's P formed.  No
    // branch lies between the products and their waits: MASK is a
    // template argument of each of the three key loops below.
    // With two consumer groups, they take turns issuing their products
    // (named barriers 3 and 4), so that one group's softmax runs while the
    // other group's products hold the tensor cores.  Each waits for its
    // turn once a tile and passes it on once; the first group starts, and
    // takes one turn more at the end so that no arrival is left pending.
    // The groups differ only in the barriers' ids and counts, never in a
    // branch: ptxas serialises every wgmma of a kernel with a branch on
    // the group around one.  (A barrier id 5 or 6 with a count of 128 is
    // one group meeting itself: a no-op.)
    auto my_turn = [&] {
      if constexpr (C::PINGPONG) rt::named_barrier(3 + cw, 256);
    };
    auto pass_turn = [&] {
      if constexpr (C::PINGPONG) rt::named_barrier_arrive(4 - cw, 256);
    };
    auto step = [&](int j, auto mask) {
      rt::mbar_wait(&full_k[stage], phase);
      my_turn();
      rt::wgmma_fence();
      qk();
      pv();
      pass_turn();
      rt::wgmma_wait<1>();
      rt::fence_regs(s);
      float alpha[2];
      softmax<decltype(mask)::value>(s, m, l, alpha, j * C::BKV + 2 * t,
                                     qpos, p);
      rt::wgmma_wait<0>();
      rt::fence_regs(o);
      rt::fence_regs(pa);
      if (leader) rt::mbar_arrive(&empty[prev]);
#pragma unroll
      for (int i = 0; i < C::ON; ++i) o[i] *= alpha[(i >> 1) & 1];
      to_p();
      advance();
    };
    using Masked = std::integral_constant<bool, true>;
    using Whole = std::integral_constant<bool, false>;

    rt::mbar_wait(qbar, 0);
    if (sp.lo < sp.hi) {
      if constexpr (C::PINGPONG)  // the first group's first turn
        rt::named_barrier_arrive(cw ? 3 : 5, cw ? 256 : 128);
      // the first tile alone (O is still zero: nothing to overlap)
      rt::mbar_wait(&full_k[stage], phase);
      my_turn();
      rt::wgmma_fence();
      qk();
      pass_turn();
      rt::wgmma_wait<0>();
      rt::fence_regs(s);
      float alpha[2];
      if (sp.lo < sp.full_lo || sp.lo >= sp.full_hi)
        softmax<true>(s, m, l, alpha, sp.lo * C::BKV + 2 * t, qpos, p);
      else
        softmax<false>(s, m, l, alpha, sp.lo * C::BKV + 2 * t, qpos, p);
      to_p();
      advance();
      // the rest: the window's lower edge, the tiles every row sees
      // whole, then the causal diagonal and Tk's edge
      const int mid = max(sp.lo + 1, sp.full_lo);
      const int top = max(sp.lo + 1, sp.full_hi);
      for (int j = sp.lo + 1; j < sp.full_lo; ++j) step(j, Masked{});
      for (int j = mid; j < sp.full_hi; ++j) step(j, Whole{});
      for (int j = top; j < sp.hi; ++j) step(j, Masked{});
      rt::wgmma_fence();
      pv();
      rt::wgmma_wait<0>();
      rt::fence_regs(o);
      if (leader) rt::mbar_arrive(&empty[prev]);
      if constexpr (C::PINGPONG)  // the first group's last turn
        rt::named_barrier(cw ? 6 : 3, cw ? 128 : 256);
    }

    // O / l (l == 0: a row that saw no key gives zeros), rounded to bf16
    // into this group's rows of the Q tile, swizzled as TMA reads it
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      inv[h] = l[h] == 0.f ? 1.f : 1.f / l[h];
    }
    if constexpr (LSE) {
      if (t == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = q0 + cw * 64 + warp * 16 + g + 8 * h;
          if (r < p.Tq)
            p.lse[static_cast<size_t>(bh) * p.Tq + r] =
                l[h] == 0.f ? __int_as_float(0x7f800000)
                            : (m[h] * p.scale_log2 + __log2f(l[h])) * kLn2;
        }
      }
    }
#pragma unroll
    for (int jn = 0; jn < D / 8; ++jn)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = cw * 64 + warp * 16 + g + 8 * h;  // row of the tile
        uint8_t* dst = Qs + jn / 8 * C::QBOX + r * 128 +
                       ((jn % 8) ^ g) * 16 + 4 * t;
        *reinterpret_cast<uint32_t*>(dst) = rt::pack_bf16(
            o[4 * jn + 2 * h] * inv[h], o[4 * jn + 2 * h + 1] * inv[h]);
      }
    rt::fence_async_smem();
    rt::named_barrier(1 + cw, 128);
    if (leader && q0 + cw * 64 < p.Tq) {
#pragma unroll
      for (int x = 0; x < D / 64; ++x)
        rt::tma_store_3d(&p.o, Qs + x * C::QBOX + cw * 64 * 128, 64 * x,
                         q0 + cw * 64, bh);
      rt::tma_store_wait_read();
    }
  }
}

template <int D, int BQ, bool LSE>
int launch(Params& p, const void* q, const void* k, const void* v, void* o,
           int n_tiles, cudaStream_t stream) {
  using C = Cfg<D, BQ>;
  const rt::Encode enc = rt::encode_fn();
  if (!enc) return static_cast<int>(cudaErrorSymbolNotFound);
  CUresult cr = rt::make_map_3d(enc, &p.q, q, p.B * p.Hq, p.Tq, D, BQ);
  if (cr == CUDA_SUCCESS)
    cr = rt::make_map_3d(enc, &p.k, k, p.B * p.Hk, p.Tk, D, C::BKV);
  if (cr == CUDA_SUCCESS)
    cr = rt::make_map_3d(enc, &p.v, v, p.B * p.Hk, p.Tk, D, C::BKV);
  if (cr == CUDA_SUCCESS)
    cr = rt::make_map_3d(enc, &p.o, o, p.B * p.Hq, p.Tq, D, 64);
  if (cr != CUDA_SUCCESS) return 1000 + static_cast<int>(cr);
  const int smem = C::smem_bytes(p.stages);
  const void* fn = reinterpret_cast<const void*>(&flash_kernel<D, BQ, LSE>);
  cudaError_t rc = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  void* args[] = {&p};
  if (rc == cudaSuccess)
    rc = cudaLaunchKernel(fn, dim3(n_tiles * p.B * p.Hq), dim3(C::THREADS),
                          args, smem, stream);
  return static_cast<int>(rc);
}

template <bool LSE>
int dispatch(Params& p, const void* q, const void* k, const void* v, void* o,
             int D, int block_q, int n_tiles, cudaStream_t s) {
  const bool tall = block_q == 128;
  if (D == 256)
    return tall ? launch<256, 128, LSE>(p, q, k, v, o, n_tiles, s)
                : launch<256, 64, LSE>(p, q, k, v, o, n_tiles, s);
  if (D == 128)
    return tall ? launch<128, 128, LSE>(p, q, k, v, o, n_tiles, s)
                : launch<128, 64, LSE>(p, q, k, v, o, n_tiles, s);
  if (D == 64)
    return tall ? launch<64, 128, LSE>(p, q, k, v, o, n_tiles, s)
                : launch<64, 64, LSE>(p, q, k, v, o, n_tiles, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int smem_of(int block_q, int stages) {
  return block_q == 128 ? Cfg<D, 128>::smem_bytes(stages)
                        : Cfg<D, 64>::smem_bytes(stages);
}

}  // namespace

// Launch on ``stream`` what kernels/flash_attention.py:schedule chose: the
// tile height ``block_q``, the ring's ``stages`` and the launch order of
// the ``n_tiles`` query tiles.  ``lse``: null, or a (B, Hq, Tq) fp32 buffer
// for the rows' logsumexp (training).  Returns the first cudaError_t; a
// tensor map the driver refuses returns 1000 + its CUresult.
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int B, int Hq, int Hk,
                                  int Tq, int Tk, int D, int causal,
                                  int window, int q_offset, int block_q,
                                  int stages, const void* order, int n_tiles,
                                  void* stream) {
  if ((block_q != 64 && block_q != 128) || stages < 2 ||
      stages > MAX_STAGES || n_tiles < 1 || n_tiles > MAX_TILES ||
      n_tiles != (Tq + block_q - 1) / block_q || Tk < 1 || Hk < 1 ||
      Hq % Hk)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.B = B, p.Hq = Hq, p.Hk = Hk, p.Tq = Tq, p.Tk = Tk;
  p.causal = causal, p.window = window, p.q_offset = q_offset;
  p.stages = stages;
  p.lse = static_cast<float*>(lse);
  p.scale_log2 = kLog2e / sqrtf(static_cast<float>(D));
  const auto* ord = static_cast<const uint16_t*>(order);
  for (int i = 0; i < n_tiles; ++i) p.order[i] = ord[i];
  auto s = static_cast<cudaStream_t>(stream);
  if (lse) return dispatch<true>(p, q, k, v, o, D, block_q, n_tiles, s);
  return dispatch<false>(p, q, k, v, o, D, block_q, n_tiles, s);
}

// Dynamic shared memory of one block (kernels/flash_attention.py:
// smem_bytes_for must agree), or -1 for a shape the kernel does not take.
extern "C" int rt_flash_smem_bytes(int D, int block_q, int stages) {
  if (block_q != 64 && block_q != 128) return -1;
  if (D == 256) return smem_of<256>(block_q, stages);
  if (D == 128) return smem_of<128>(block_q, stages);
  if (D == 64) return smem_of<64>(block_q, stages);
  return -1;
}

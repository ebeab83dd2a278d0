// The backward pass of the RG-LRU scan h_t = a_t * h_{t-1} + x_t: dx, da
// and dh0 for the cotangents dh of every h_t and dh_T of the final carry.
//
// Replaces the gradient of the TPU kernel repro/kernels/rg_lru.py:
// rg_lru_scan (the JAX package differentiates its plain lax.scan, which
// keeps the fp32 carry h_{t-1} as its residual; the Pallas kernel has no
// VJP).  It computes, in fp32, the reverse recurrence
//
//   g_{T-1} = dh_{T-1} + dh_T,   g_t = dh_t + a_{t+1} g_{t+1},
//   dx_t = g_t,   da_t = g_t h_{t-1},   dh0 = a_0 g_0,
//
// dx and da rounded to bf16, dh0 kept in fp32.  h_{t-1} is the fp32 carry
// exactly as the forward kernel (rg_lru.cu) computed it: the training
// forward writes the carry at each 64-step unit's start (the anchors), and
// this kernel recomputes the steps between from x and a.  It never reads
// the bf16 h, whose rounding would enter every da_t.
//
// Bound on an H100: it reads dh, a and x and writes dx and da, 10 bytes an
// element (plus 4 / 64 of the anchors), and does a few FLOPs an element,
// so bytes bind it: 10 * B * T * W bytes, 0.038 ms at (1, 3072, 4096).
//
// Design: the forward's structure run backward in time.  The reverse
// recurrence has the forward's form, g_t = c_t * g_{t+1} + dh_t with c_t =
// a_{t+1} (1 for the last step and past T), so a block runs one job as
// the forward does: a tile of ``ct`` channels and a chunk of ``chunk``
// steps of one batch row, 8 channels and one 16-step segment a compute
// thread, the publisher warp putting x, a and dh in flight by TMA, one box
// of 64 steps a barrier (or element copies where W % 8 != 0).  Each
// compute thread folds its segment twice: forward, (A, X) of h as the
// forward kernel does, and backward from its last step, (C, G) of g; every
// 64 steps anchored at t = 0 make a unit whose backward aggregate folds
// its four segments' from the last, and the block publishes its units'
// to a global scratch unless it runs the first chunk.  Blocks take their
// chunks from an atomic ticket from the last chunk down, so a block waits
// only on blocks that took earlier tickets; its fold warps take the
// carry-in as the fold from dh_T over every later unit, from the last:
//     carry <- C_u * carry + G_u,   u = U - 1, U - 2, ..., u1,
// 16 aggregates in flight a lane.  Each compute thread then carries h from
// its unit's anchor through the unit's earlier segments and re-scans its
// 16 steps forward into shared memory (h_{t-1} in fp32), carries g from
// the carry-in through the block's later units and segments, and walks
// its steps backward, writing dx and da with 16-byte stores; the thread of
// the first segment of the first chunk writes dh0.
//
// Every value is fixed by the 16-step segments, the 64-step units and
// these orders, never by the tile, the chunk or the timing, and every
// product and sum is rounded on its own: kernels/rg_lru.py:
// chunked_bwd_model gives the kernel's bits on the CPU.  The ticket, the
// generation and the flags work as the forward's (rg_lru.cu), on the same
// per-stream sync buffer.
#include "rg_lru.cuh"

namespace {

using namespace rglru;

// named barriers: the compute warps once the tile is staged; after their
// segments; the compute warps' units before the publisher releases them;
// the fold warps after the flags; compute and fold warps once the
// carry-in is known
constexpr int BAR_STAGE = 1, BAR_SEG = 2, BAR_PUB = 3, BAR_FLAGS = 4,
              BAR_CARRY = 5;

struct Shape : Warps {
  // dynamic shared memory (kernels/rg_lru.py:bwd_smem_bytes must agree):
  // 128 bytes of alignment slack, x, a and dh of the chunk x ct tile
  // (bf16), h_{t-1} (fp32), the segments' forward and backward aggregates
  // (float2 a channel each), the units' backward aggregates (float2) and
  // anchors (fp32), and the carry-in (fp32)
  __host__ __device__ constexpr int smem_bytes() const {
    return 128 + 10 * chunk * ct + 2 * (chunk / SEG) * ct * 8 +
           (chunk / UNIT) * ct * 12 + ct * 4;
  }
};

struct Params {
  CUtensorMap mx, ma, md;  // (W, T, B) bf16 in boxes of ct x BOX x 1 (vec)
  const bf16* x;
  const bf16* a;
  const bf16* dh;
  const float* anchors;  // (B, n_u, W): the carry at each unit's start
  const float* dhT;      // (B, W) or null: zeros
  bf16* dx;
  bf16* da;
  float* dh0;            // (B, W)
  float2* agg;           // (B, (n_chunks - 1) * chunk / UNIT, W)
  uint32_t* sync;        // ticket | generation word, then one flag a block
  int B, T, W, ct, chunk, n_chunks, n_tiles, n_u;
};

template <bool VEC>
__global__ void __launch_bounds__(MAX_THREADS, 1)
rg_lru_bwd_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint32_t s_ticket, s_gen;
  __shared__ __align__(8) uint64_t landed[MAX_BOXES];  // x, a, dh of a box
  const Shape sh{{p.ct, p.chunk}};
  const int tid = threadIdx.x, warp = tid / 32;
  const int ct = p.ct, segs = p.chunk / SEG, units = p.chunk / UNIT;
  const int ncomp = sh.compute(), cw = sh.cwarps(), fw = sh.fwarps();
  // TMA's destination, 128-byte aligned
  unsigned char* smem = smem_raw + (-rt::smem_addr(smem_raw) & 127u);
  bf16* xs = reinterpret_cast<bf16*>(smem);  // [chunk][ct]
  bf16* as = xs + p.chunk * ct;
  bf16* ds = as + p.chunk * ct;
  float* hs = reinterpret_cast<float*>(ds + p.chunk * ct);  // h_{t-1}
  float2* fseg = reinterpret_cast<float2*>(hs + p.chunk * ct);  // (A, X)
  float2* bseg = fseg + segs * ct;                              // (C, G)
  float2* uagg = bseg + segs * ct;                      // [units][ct]
  float* anc = reinterpret_cast<float*>(uagg + units * ct);  // [units][ct]
  float* kin = anc + units * ct;                             // [ct]

  // ---- the ticket: chunk-major launch order, from the last chunk ---------
  if (tid == 0) {
    take_ticket(p.sync, &s_ticket, &s_gen);
    if constexpr (VEC) {
      for (int j = 0; j < p.chunk / BOX; ++j) rt::mbar_init(&landed[j], 1);
      rt::mbar_init_fence();
    }
  }
  __syncthreads();
  const uint32_t ticket = s_ticket, want = s_gen + 1u;
  uint32_t* flags = p.sync + SYNC_HEADER;
  const int tile = ticket % p.n_tiles;
  const int b = ticket / p.n_tiles % p.B;
  const int c = p.n_chunks - 1 - static_cast<int>(ticket / p.n_tiles / p.B);
  const bool first = c == 0;        // no chunk before it reads its units
  const int c0 = tile * ct;         // the tile's first channel
  const int u0 = c * units;         // the chunk's first unit
  const size_t n_pub = static_cast<size_t>(p.n_chunks - 1) * units;
  // chunk c >= 1 publishes unit u0 + j at u0 + j - units
  float2* agg = p.agg + static_cast<size_t>(b) * n_pub * p.W;

  if (warp >= cw + fw) {
    // ---- publisher: put each box of x, a and dh in flight on its barrier
    // (vec), then release the units once the compute warps wrote them
    if (VEC && tid % 32 == 0) {
      for (int j = 0; j < p.chunk / BOX; ++j) {
        const int row = c * p.chunk + j * BOX;
        if (row >= p.T) break;
        rt::mbar_expect_tx(&landed[j], 3 * BOX * ct * 2);
        rt::tma_load_3d(xs + j * BOX * ct, &p.mx, c0, row, b, &landed[j]);
        rt::tma_load_3d(as + j * BOX * ct, &p.ma, c0, row, b, &landed[j]);
        rt::tma_load_3d(ds + j * BOX * ct, &p.md, c0, row, b, &landed[j]);
      }
    }
    if (!first) {
      rt::named_barrier(BAR_PUB, 32 * (cw + 1));
      if (tid % 32 == 0) st_release(&flags[ticket], want);
    }
    return;
  }

  if (warp >= cw) {
    // ---- fold warps: wait for every later chunk of this row and tile,
    // then fold from dh_T over every later unit, from the last; runs while
    // the compute warps stage and scan
    const int f = tid - 32 * cw, nf = 32 * fw;
    for (int j = c + 1 + f; j < p.n_chunks; j += nf) {
      const uint32_t* fl =
          &flags[(static_cast<size_t>(p.n_chunks - 1 - j) * p.B + b) *
                     p.n_tiles +
                 tile];
      while (ld_acquire(fl) != want) __nanosleep(32);
    }
    rt::named_barrier(BAR_FLAGS, nf);
    const int u_hi = p.n_chunks * units, u_lo = u0 + units;
    for (int ch = f; ch < ct; ch += nf) {
      const int w = c0 + ch;
      float k = 0.f;
      if (w < p.W) {
        if (p.dhT != nullptr) k = p.dhT[static_cast<size_t>(b) * p.W + w];
        const float2* src = agg + w;
        for (int u = u_hi - 1; u >= u_lo; u -= FOLD_BATCH) {
          float2 v[FOLD_BATCH];
#pragma unroll
          for (int i = 0; i < FOLD_BATCH; ++i)
            if (u - i >= u_lo)
              v[i] = __ldcg(src + (u - i - units) * static_cast<size_t>(p.W));
#pragma unroll
          for (int i = 0; i < FOLD_BATCH; ++i)
            if (u - i >= u_lo) k = step(v[i].x, k, v[i].y);
        }
      }
      kin[ch] = k;
    }
    rt::named_barrier(BAR_CARRY, 32 * (cw + fw));
    return;
  }

  // ---- compute warps ------------------------------------------------------
  const int groups = ct / CV;
  const bool active = tid < ncomp;
  const int g = tid % groups, s = tid / groups;
  const int ch0 = g * CV;           // this thread's first channel in the tile
  const int w0 = c0 + ch0;
  const int t0 = c * p.chunk + s * SEG;
  const int t_end = (c + 1) * p.chunk;  // the step after the chunk
  const size_t row0 = static_cast<size_t>(b) * p.T;
  const int valid = p.W - w0;       // channels left in a row

  // rows of this thread's 8 channels in the block's [chunk][ct] tiles; row
  // SEG of a is the next segment's first
  auto row_x = [&](int r) {
    return reinterpret_cast<uint4*>(xs + (s * SEG + r) * ct + ch0);
  };
  auto row_a = [&](int r) {
    return reinterpret_cast<uint4*>(as + (s * SEG + r) * ct + ch0);
  };
  auto row_d = [&](int r) {
    return reinterpret_cast<uint4*>(ds + (s * SEG + r) * ct + ch0);
  };

  // the anchors of the chunk's units
  for (int i = tid; i < units * ct; i += 32 * cw) {
    const int u = u0 + i / ct, w = c0 + i % ct;
    anc[i] = u < p.n_u && w < p.W
                 ? p.anchors[(static_cast<size_t>(b) * p.n_u + u) * p.W + w]
                 : 0.f;
  }
  // a at the step after the chunk (1 past T): the last segment's c
  float cnext[CV];
#pragma unroll
  for (int i = 0; i < CV; ++i) cnext[i] = 1.f;
  if (active && s == segs - 1 && t_end < p.T && valid > 0) {
    const bf16* src = p.a + (row0 + t_end) * p.W + w0;
    if constexpr (VEC) {
      unpack8(*reinterpret_cast<const uint4*>(src), cnext);
    } else {
#pragma unroll
      for (int e = 0; e < CV; ++e)
        if (e < valid) cnext[e] = __bfloat162float(src[e]);
    }
  }

  if (active) {
    // stage: wait for this segment's TMA box (vec), or copy the rows
    // element by element; steps past T become identity steps, a = 1 and
    // x = dh = 0 (TMA reads zeros there, and past W)
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    const uint4 ones = make_uint4(0x3f803f80u, 0x3f803f80u, 0x3f803f80u,
                                  0x3f803f80u);  // bf16 1.0 x 8
    if constexpr (VEC) {
      const int box = s * SEG / BOX;
      if (c * p.chunk + box * BOX < p.T) rt::mbar_wait(&landed[box], 0);
      for (int r = max(0, p.T - t0); r < SEG; ++r) {
        *row_x(r) = zero;
        *row_a(r) = ones;
        *row_d(r) = zero;
      }
    } else {
      for (int r = 0; r < SEG; ++r) {
        const int t = t0 + r;
        if (t >= p.T || valid <= 0) {
          *row_x(r) = zero;
          *row_a(r) = ones;
          *row_d(r) = zero;
          continue;
        }
        const size_t off = (row0 + t) * p.W + w0;
        __align__(16) bf16 vx[CV], va[CV], vd[CV];
#pragma unroll
        for (int e = 0; e < CV; ++e) {
          vx[e] = e < valid ? p.x[off + e] : __float2bfloat16(0.f);
          va[e] = e < valid ? p.a[off + e] : __float2bfloat16(1.f);
          vd[e] = e < valid ? p.dh[off + e] : __float2bfloat16(0.f);
        }
        *row_x(r) = *reinterpret_cast<const uint4*>(vx);
        *row_a(r) = *reinterpret_cast<const uint4*>(va);
        *row_d(r) = *reinterpret_cast<const uint4*>(vd);
      }
    }
  }
  // the next segment's first row of a is another thread's
  rt::named_barrier(BAR_STAGE, 32 * cw);

  // c of this thread's step r (r < SEG), from the staged a of row r + 1
  auto next_a = [&](int r, float (&cv)[CV]) {
    if (r + 1 < SEG || s + 1 < segs) {
      unpack8(*row_a(r + 1), cv);
    } else {
#pragma unroll
      for (int i = 0; i < CV; ++i) cv[i] = cnext[i];
    }
  };

  if (active) {
    // the segment's forward aggregate (A, X) and backward one (C, G)
    float A[CV], X[CV];
#pragma unroll
    for (int i = 0; i < CV; ++i) {
      A[i] = 1.f;
      X[i] = 0.f;
    }
#pragma unroll 4
    for (int r = 0; r < SEG; ++r) {
      float av[CV], xv[CV];
      unpack8(*row_a(r), av);
      unpack8(*row_x(r), xv);
#pragma unroll
      for (int i = 0; i < CV; ++i) {
        X[i] = step(av[i], X[i], xv[i]);
        A[i] = __fmul_rn(av[i], A[i]);
      }
    }
    float4* dst = reinterpret_cast<float4*>(fseg + s * ct + ch0);
#pragma unroll
    for (int i = 0; i < CV / 2; ++i)
      dst[i] = make_float4(A[2 * i], X[2 * i], A[2 * i + 1], X[2 * i + 1]);
    float cv[CV];
    next_a(SEG - 1, cv);
#pragma unroll
    for (int i = 0; i < CV; ++i) {
      A[i] = 1.f;   // C
      X[i] = 0.f;   // G
    }
#pragma unroll 4
    for (int r = SEG - 1; r >= 0; --r) {
      float dv[CV];
      unpack8(*row_d(r), dv);
#pragma unroll
      for (int i = 0; i < CV; ++i) {
        X[i] = step(cv[i], X[i], dv[i]);
        A[i] = __fmul_rn(cv[i], A[i]);
      }
      unpack8(*row_a(r), cv);
    }
    dst = reinterpret_cast<float4*>(bseg + s * ct + ch0);
#pragma unroll
    for (int i = 0; i < CV / 2; ++i)
      dst[i] = make_float4(A[2 * i], X[2 * i], A[2 * i + 1], X[2 * i + 1]);
  }
  rt::named_barrier(BAR_SEG, 32 * cw);

  // the units' backward aggregates (their segments from the last),
  // published unless this is the first chunk
  for (int i = tid; i < units * ct; i += 32 * cw) {
    const int j = i / ct, ch = i % ct;
    float gC = 1.f, gG = 0.f;
#pragma unroll
    for (int q = SPU - 1; q >= 0; --q) {
      const float2 v = bseg[(j * SPU + q) * ct + ch];
      gG = step(v.x, gG, v.y);
      gC = __fmul_rn(v.x, gC);
    }
    uagg[j * ct + ch] = make_float2(gC, gG);
    if (!first && c0 + ch < p.W)
      __stcg(&agg[(u0 + j - units) * static_cast<size_t>(p.W) + c0 + ch],
             make_float2(gC, gG));
  }
  if (!first) rt::named_barrier_arrive(BAR_PUB, 32 * (cw + 1));
  rt::named_barrier(BAR_CARRY, 32 * (cw + fw));

  // ---- this segment's carries, then its steps again -----------------------
  if (!active || t0 >= p.T || valid <= 0) return;
  const int unit = s / SPU;
  // h: the unit's anchor on through the unit's earlier segments
  float H[CV];
#pragma unroll
  for (int i = 0; i < CV; ++i) H[i] = anc[unit * ct + ch0 + i];
  for (int q = unit * SPU; q < s; ++q) {
#pragma unroll
    for (int i = 0; i < CV; ++i) {
      const float2 v = fseg[q * ct + ch0 + i];
      H[i] = step(v.x, H[i], v.y);
    }
  }
  // g: the carry-in on through the block's later units and segments
  float G[CV];
#pragma unroll
  for (int i = 0; i < CV; ++i) G[i] = kin[ch0 + i];
  for (int j = units - 1; j > unit; --j) {
#pragma unroll
    for (int i = 0; i < CV; ++i) {
      const float2 v = uagg[j * ct + ch0 + i];
      G[i] = step(v.x, G[i], v.y);
    }
  }
  for (int q = unit * SPU + SPU - 1; q > s; --q) {
#pragma unroll
    for (int i = 0; i < CV; ++i) {
      const float2 v = bseg[q * ct + ch0 + i];
      G[i] = step(v.x, G[i], v.y);
    }
  }
  // h_{t-1} of each real step, in this thread's rows of hs
  const int rows = min(SEG, p.T - t0);
  float* hrow = hs + s * SEG * ct + ch0;
  for (int r = 0; r < rows; ++r) {
    float4* hp = reinterpret_cast<float4*>(hrow + r * ct);
    hp[0] = make_float4(H[0], H[1], H[2], H[3]);
    hp[1] = make_float4(H[4], H[5], H[6], H[7]);
    float av[CV], xv[CV];
    unpack8(*row_a(r), av);
    unpack8(*row_x(r), xv);
#pragma unroll
    for (int i = 0; i < CV; ++i) H[i] = step(av[i], H[i], xv[i]);
  }
  // the steps backward (past T: identity steps, skipped)
  float cv[CV];
  next_a(rows - 1, cv);
  bf16* out_x = p.dx + (row0 + t0) * p.W + w0;
  bf16* out_a = p.da + (row0 + t0) * p.W + w0;
  for (int r = rows - 1; r >= 0; --r) {
    float dv[CV], hv[CV];
    unpack8(*row_d(r), dv);
    const float4* hp = reinterpret_cast<const float4*>(hrow + r * ct);
    const float4 h_lo = hp[0], h_hi = hp[1];
    hv[0] = h_lo.x, hv[1] = h_lo.y, hv[2] = h_lo.z, hv[3] = h_lo.w;
    hv[4] = h_hi.x, hv[5] = h_hi.y, hv[6] = h_hi.z, hv[7] = h_hi.w;
    __align__(16) __nv_bfloat162 ox[CV / 2], oa[CV / 2];
#pragma unroll
    for (int i = 0; i < CV; ++i) G[i] = step(cv[i], G[i], dv[i]);
#pragma unroll
    for (int i = 0; i < CV / 2; ++i) {
      ox[i] = __floats2bfloat162_rn(G[2 * i], G[2 * i + 1]);
      oa[i] = __floats2bfloat162_rn(__fmul_rn(G[2 * i], hv[2 * i]),
                                    __fmul_rn(G[2 * i + 1], hv[2 * i + 1]));
    }
    bf16* dxr = out_x + static_cast<size_t>(r) * p.W;
    bf16* dar = out_a + static_cast<size_t>(r) * p.W;
    if constexpr (VEC) {
      *reinterpret_cast<uint4*>(dxr) = *reinterpret_cast<const uint4*>(ox);
      *reinterpret_cast<uint4*>(dar) = *reinterpret_cast<const uint4*>(oa);
    } else {
      const bf16* vx = reinterpret_cast<const bf16*>(ox);
      const bf16* va = reinterpret_cast<const bf16*>(oa);
#pragma unroll
      for (int e = 0; e < CV; ++e)
        if (e < valid) {
          dxr[e] = vx[e];
          dar[e] = va[e];
        }
    }
    unpack8(*row_a(r), cv);
  }
  if (c == 0 && s == 0) {  // dh0 = a_0 g_0 (cv holds a_0 now)
    float* dst = p.dh0 + static_cast<size_t>(b) * p.W + w0;
#pragma unroll
    for (int e = 0; e < CV; ++e)
      if (e < valid) dst[e] = __fmul_rn(cv[e], G[e]);
  }
}

// What the kernel takes: rglru::takes_shape within the shared memory a
// block may have.
bool takes(int ct, int chunk) {
  return takes_shape(ct, chunk) &&
         Shape{{ct, chunk}}.smem_bytes() <= SMEM_LIMIT;
}

}  // namespace

// x, a, dh, dx, da: (B, T, W) bf16; anchors (B, ceil(T / 64), W) fp32, as
// the training forward (rt_rg_lru_scan with anchors) wrote them; dhT (B,
// W) fp32 or null; dh0 (B, W) fp32.  ``agg``: (B, (n_chunks - 1) * chunk
// / 64, W) float2 of scratch; ``sync``: as rt_rg_lru_scan's (the same
// buffer may serve both, one launch at a time).  ``vec``: W % 8 == 0 and
// x, a, dh, dx, da 16-byte aligned.
extern "C" int rt_rg_lru_bwd(const void* x, const void* a, const void* dh,
                             const void* anchors, const void* dhT, void* dx,
                             void* da, void* dh0, void* agg, void* sync,
                             int B, int T, int W, int ct, int chunk, int vec,
                             void* stream) {
  if (B <= 0 || T <= 0 || W <= 0 || B > 65535 || !takes(ct, chunk) ||
      sync == nullptr || anchors == nullptr || dh0 == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.x = static_cast<const bf16*>(x);
  p.a = static_cast<const bf16*>(a);
  p.dh = static_cast<const bf16*>(dh);
  p.anchors = static_cast<const float*>(anchors);
  p.dhT = static_cast<const float*>(dhT);
  p.dx = static_cast<bf16*>(dx);
  p.da = static_cast<bf16*>(da);
  p.dh0 = static_cast<float*>(dh0);
  p.agg = static_cast<float2*>(agg);
  p.sync = static_cast<uint32_t*>(sync);
  p.B = B, p.T = T, p.W = W, p.ct = ct, p.chunk = chunk;
  p.n_chunks = (T + chunk - 1) / chunk;
  p.n_tiles = (W + ct - 1) / ct;
  p.n_u = (T + UNIT - 1) / UNIT;
  const long long blocks =
      static_cast<long long>(B) * p.n_chunks * p.n_tiles;
  if (blocks > 0x7fffffffLL || (p.n_chunks > 1 && agg == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec) {
    const rt::Encode enc = rt::encode_fn();
    if (!enc) return static_cast<int>(cudaErrorSymbolNotFound);
    CUresult cr = make_map(enc, &p.mx, x, B, T, W, ct);
    if (cr == CUDA_SUCCESS) cr = make_map(enc, &p.ma, a, B, T, W, ct);
    if (cr == CUDA_SUCCESS) cr = make_map(enc, &p.md, dh, B, T, W, ct);
    if (cr != CUDA_SUCCESS) return 1000 + static_cast<int>(cr);
  }
  const Shape sh{{ct, chunk}};
  const int smem = sh.smem_bytes();
  const void* fn =
      vec ? reinterpret_cast<const void*>(&rg_lru_bwd_kernel<true>)
          : reinterpret_cast<const void*>(&rg_lru_bwd_kernel<false>);
  cudaError_t rc = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  void* args[] = {&p};
  if (rc == cudaSuccess)
    rc = cudaLaunchKernel(fn, dim3(static_cast<unsigned>(blocks)),
                          dim3(sh.threads()), args, smem,
                          static_cast<cudaStream_t>(stream));
  return static_cast<int>(rc);
}

// The footprint of one block (kernels/rg_lru.py:bwd_smem_bytes), -1 for
// a tile and chunk the kernel does not take.
extern "C" int rt_rg_lru_bwd_smem_bytes(int ct, int chunk) {
  return takes(ct, chunk) ? Shape{{ct, chunk}}.smem_bytes() : -1;
}

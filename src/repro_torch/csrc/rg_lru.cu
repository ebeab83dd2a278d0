// RG-LRU gated linear recurrence h_t = a_t * h_{t-1} + x_t, per channel.
//
// Replaces the TPU kernel repro/kernels/rg_lru.py:rg_lru_scan and computes
// what it computes: the carry in fp32 (starting from h0, or zeros), every
// h_t rounded to the input dtype (bf16) on the way out, and the final
// carry h_T kept in fp32.
//
// Bound on an H100: it reads x and a and writes h once (6 bytes per
// element in bf16) and does two FLOPs per element, so it is bound by
// bytes: 6 * B * T * W + 8 * B * W bytes, ~30 us at B = 1, T = W = 4096.
// The recurrence is sequential in time and independent across channels,
// so a kernel that walks all T steps of a channel in one thread is bound
// by the latency of that chain instead (the one-warp kernel this replaces
// moved 1.25 TB/s at B = 1, T = W = 4096: one chain per lane, one warp an
// SM).
//
// Design: one pass, time spread across blocks.  A block runs one job: a
// tile of ``ct`` channels and a chunk of ``chunk`` steps of one batch row.
// Its compute warps give each thread 8 channels (16 bytes) and one segment
// of SEG = 16 steps.  The publisher warp puts the tile's x and a in flight
// by TMA, one box of 64 steps a barrier (or the compute threads copy their
// rows element by element where W % 8 != 0), and each compute thread folds
// its rows into the segment's aggregate, A = prod a_t and X = the scan
// from 0.  Every UNIT = 64 steps anchored at t = 0 make a unit, whose
// aggregate is the fold of its four segments' in time order; the block
// writes its units' aggregates to a global scratch (B, units, W) and the
// publisher releases them with a flag.  Meanwhile the fold warps wait for
// every earlier chunk of the row and tile and take the carry-in as the
// fold from h0 over all earlier units, in order:
//     carry <- A_u * carry + X_u,   u = 0, 1, ..., u0 - 1,
// 16 aggregates in flight a lane.  Each compute thread then carries that
// on through the block's own units and segments before its own and
// re-scans its 16 steps from shared memory, writing h with 16-byte stores;
// the last chunk's fold warps carry it through the chunk's units into h_T.
//
// So every value is fixed by SEG and UNIT and the order above, never by
// the tile, the chunk length or the timing: two launches agree bit for
// bit, and so do two schedules.  Every product and sum is rounded on its
// own (__fmul_rn, __fadd_rn: never contracted into an fma), as the plain
// version rounds them, so a CPU model of these steps
// (kernels/rg_lru.py:chunked_model) gives the kernel's bits.  Steps past T
// are staged as a = 1, x = 0, whose fold is exact: a scan padded that way
// (a bucket's padding) gives the unpadded scan's h and h_T to the bit.
// Nothing divides by A, which may underflow to 0 over a long unit.
//
// Jobs are handed out by an atomic ticket in launch order, chunk-major, so
// a block waits only on blocks that took earlier tickets and are resident
// or done: the wait cannot deadlock.  The ticket and a launch generation
// share one 64-bit word of a per-stream sync buffer, which the last
// ticket's taker resets to (generation + 1, ticket 0); a job's flag is set
// to its launch's generation + 1, so stale flags never match and no call
// clears them.  A ragged W masks the last tile's channels (TMA reads zeros
// past W; no such channel is stored or published).
//
// Training (ANCHOR): the kernel also writes the fp32 carry at each unit's
// start, anchors (B, ceil(T / 64), W), which the backward kernel
// (rg_lru_bwd.cu) recomputes h_{t-1} from.  The compute thread of each
// unit's first segment holds it once the carry-in is known and writes its
// 8 channels; serving's build (ANCHOR false) holds no trace of it.
#include "rg_lru.cuh"

namespace {

using namespace rglru;

// named barriers: the compute warps after their segments; the compute
// warps' units before the publisher releases them; the fold warps after
// the flags; compute and fold warps once the carry-in is known
constexpr int BAR_SEG = 1, BAR_PUB = 2, BAR_FLAGS = 3, BAR_CARRY = 4;

// A block's warps (rglru::Warps) and its shared memory.
struct Shape : Warps {
  // dynamic shared memory (kernels/rg_lru.py:smem_bytes must agree): 128
  // bytes of alignment slack, x and a of the chunk x ct tile (bf16), the
  // segments' and the units' aggregates (float2 a channel) and the
  // carry-in (fp32 a channel)
  __host__ __device__ constexpr int smem_bytes() const {
    return 128 + 4 * chunk * ct + (chunk / SEG) * ct * 8 +
           (chunk / UNIT) * ct * 8 + ct * 4;
  }
};

struct Params {
  CUtensorMap mx, ma;  // (W, T, B) bf16 in boxes of ct x BOX x 1 (vec only)
  const bf16* x;
  const bf16* a;
  const float* h0;   // (B, W) or null: zeros
  bf16* h;
  float* hT;
  float2* agg;       // (B, (n_chunks - 1) * chunk / UNIT, W) unit aggregates
  float* anchors;    // (B, n_u, W) unit-start carries, written if ANCHOR
  uint32_t* sync;    // 64-bit ticket | generation word, then one flag a block
  int B, T, W, ct, chunk, n_chunks, n_tiles, n_u;
};

// __launch_bounds__(MAX_THREADS, 2) caps a thread at 80 registers, so
// that three blocks of the 224 threads the widest schedule runs fit an SM
template <bool VEC, bool ANCHOR>
__global__ void __launch_bounds__(MAX_THREADS, 2)
rg_lru_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint32_t s_ticket, s_gen;
  __shared__ __align__(8) uint64_t landed[MAX_BOXES];  // a box of x and a
  const Shape sh{{p.ct, p.chunk}};
  const int tid = threadIdx.x, warp = tid / 32;
  const int ct = p.ct, segs = p.chunk / SEG, units = p.chunk / UNIT;
  const int ncomp = sh.compute(), cw = sh.cwarps(), fw = sh.fwarps();
  // TMA's destination, 128-byte aligned
  unsigned char* smem = smem_raw + (-rt::smem_addr(smem_raw) & 127u);
  bf16* xs = reinterpret_cast<bf16*>(smem);  // [chunk][ct]
  bf16* as = xs + p.chunk * ct;
  float2* seg = reinterpret_cast<float2*>(as + p.chunk * ct);  // [segs][ct]
  float2* uagg = seg + segs * ct;                             // [units][ct]
  float* kin = reinterpret_cast<float*>(uagg + units * ct);   // [ct]

  // ---- the ticket: chunk-major launch order ------------------------------
  if (tid == 0) {
    take_ticket(p.sync, &s_ticket, &s_gen);
    if constexpr (VEC) {
      for (int j = 0; j < p.chunk / BOX; ++j) rt::mbar_init(&landed[j], 1);
      rt::mbar_init_fence();
    }
  }
  __syncthreads();
  // a block's flag, once its units are published: its launch's generation
  // + 1, which no earlier launch left there
  const uint32_t ticket = s_ticket, want = s_gen + 1u;
  uint32_t* flags = p.sync + SYNC_HEADER;
  const int tile = ticket % p.n_tiles;
  const int b = ticket / p.n_tiles % p.B;
  const int c = ticket / p.n_tiles / p.B;
  const bool last = c == p.n_chunks - 1;
  const int c0 = tile * ct;         // the tile's first channel
  const int u0 = c * units;         // the chunk's first unit
  const size_t n_units = static_cast<size_t>(p.n_chunks - 1) * units;
  float2* agg = p.agg + static_cast<size_t>(b) * n_units * p.W;

  if (warp >= cw + fw) {
    // ---- publisher: put each box of x and a in flight on its barrier
    // (vec), then release the units once the compute warps wrote them
    if (VEC && tid % 32 == 0) {
      for (int j = 0; j < p.chunk / BOX; ++j) {
        const int row = c * p.chunk + j * BOX;
        if (row >= p.T) break;
        rt::mbar_expect_tx(&landed[j], 2 * BOX * ct * 2);
        rt::tma_load_3d(xs + j * BOX * ct, &p.mx, c0, row, b, &landed[j]);
        rt::tma_load_3d(as + j * BOX * ct, &p.ma, c0, row, b, &landed[j]);
      }
    }
    if (!last) {
      rt::named_barrier(BAR_PUB, 32 * (cw + 1));
      if (tid % 32 == 0) st_release(&flags[ticket], want);
    }
    return;
  }

  if (warp >= cw) {
    // ---- fold warps: wait for every earlier chunk of this row and tile,
    // then fold from h0 over every earlier unit, in order; runs while the
    // compute warps stage and scan
    const int f = tid - 32 * cw, nf = 32 * fw;
    for (int j = f; j < c; j += nf) {
      const uint32_t* fl =
          &flags[(static_cast<size_t>(j) * p.B + b) * p.n_tiles + tile];
      while (ld_acquire(fl) != want) __nanosleep(32);
    }
    rt::named_barrier(BAR_FLAGS, nf);
    for (int ch = f; ch < ct; ch += nf) {
      const int w = c0 + ch;
      float k = 0.f;
      if (w < p.W) {
        if (p.h0 != nullptr) k = p.h0[static_cast<size_t>(b) * p.W + w];
        const float2* src = agg + w;
        for (int u = 0; u < u0; u += FOLD_BATCH) {
          float2 v[FOLD_BATCH];
#pragma unroll
          for (int i = 0; i < FOLD_BATCH; ++i)
            if (u + i < u0)
              v[i] = __ldcg(src + (u + i) * static_cast<size_t>(p.W));
#pragma unroll
          for (int i = 0; i < FOLD_BATCH; ++i)
            if (u + i < u0) k = step(v[i].x, k, v[i].y);
        }
      }
      kin[ch] = k;
    }
    rt::named_barrier(BAR_CARRY, 32 * (cw + fw));
    if (last) {  // h_T: on through this chunk's units
      for (int ch = f; ch < ct; ch += nf) {
        const int w = c0 + ch;
        if (w >= p.W) continue;
        float e = kin[ch];
        for (int j = 0; j < units; ++j) {
          const float2 v = uagg[j * ct + ch];
          e = step(v.x, e, v.y);
        }
        p.hT[static_cast<size_t>(b) * p.W + w] = e;
      }
    }
    return;
  }

  // ---- compute warps ------------------------------------------------------
  const int groups = ct / CV;
  const bool active = tid < ncomp;
  const int g = tid % groups, s = tid / groups;
  const int ch0 = g * CV;           // this thread's first channel in the tile
  const int w0 = c0 + ch0;
  const int t0 = c * p.chunk + s * SEG;
  const size_t row0 = static_cast<size_t>(b) * p.T;
  const int valid = p.W - w0;       // channels left in a row

  // this thread's 16 rows of 8 channels, in the block's [chunk][ct] tile
  auto row_x = [&](int r) {
    return reinterpret_cast<uint4*>(xs + (s * SEG + r) * ct + ch0);
  };
  auto row_a = [&](int r) {
    return reinterpret_cast<uint4*>(as + (s * SEG + r) * ct + ch0);
  };

  if (active) {
    // stage: wait for this segment's TMA box (vec), or copy the rows
    // element by element; steps past T become identity steps, a = 1 and
    // x = 0 (TMA reads zeros there, and past W)
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    const uint4 ones = make_uint4(0x3f803f80u, 0x3f803f80u, 0x3f803f80u,
                                  0x3f803f80u);  // bf16 1.0 x 8
    if constexpr (VEC) {
      const int box = s * SEG / BOX;
      if (c * p.chunk + box * BOX < p.T) rt::mbar_wait(&landed[box], 0);
      for (int r = max(0, p.T - t0); r < SEG; ++r) {
        *row_x(r) = zero;
        *row_a(r) = ones;
      }
    } else {
      for (int r = 0; r < SEG; ++r) {
        const int t = t0 + r;
        if (t >= p.T || valid <= 0) {
          *row_x(r) = zero;
          *row_a(r) = ones;
          continue;
        }
        const size_t off = (row0 + t) * p.W + w0;
        __align__(16) bf16 vx[CV], va[CV];
#pragma unroll
        for (int e = 0; e < CV; ++e) {
          vx[e] = e < valid ? p.x[off + e] : __float2bfloat16(0.f);
          va[e] = e < valid ? p.a[off + e] : __float2bfloat16(1.f);
        }
        *row_x(r) = *reinterpret_cast<const uint4*>(vx);
        *row_a(r) = *reinterpret_cast<const uint4*>(va);
      }
    }
    // the segment's aggregate (this thread's own rows: no barrier needed)
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
    float4* dst = reinterpret_cast<float4*>(seg + s * ct + ch0);
#pragma unroll
    for (int i = 0; i < CV / 2; ++i)
      dst[i] = make_float4(A[2 * i], X[2 * i], A[2 * i + 1], X[2 * i + 1]);
  }
  rt::named_barrier(BAR_SEG, 32 * cw);

  // the units' aggregates, published unless no chunk follows
  for (int i = tid; i < units * ct; i += 32 * cw) {
    const int j = i / ct, ch = i % ct;
    float gA = 1.f, gX = 0.f;
#pragma unroll
    for (int q = 0; q < SPU; ++q) {
      const float2 v = seg[(j * SPU + q) * ct + ch];
      gX = step(v.x, gX, v.y);
      gA = __fmul_rn(v.x, gA);
    }
    uagg[j * ct + ch] = make_float2(gA, gX);
    if (!last && c0 + ch < p.W)
      __stcg(&agg[(u0 + j) * static_cast<size_t>(p.W) + c0 + ch],
             make_float2(gA, gX));
  }
  if (!last) rt::named_barrier_arrive(BAR_PUB, 32 * (cw + 1));
  rt::named_barrier(BAR_CARRY, 32 * (cw + fw));

  // ---- this segment's carry, then its steps again -------------------------
  if (!active || t0 >= p.T || valid <= 0) return;
  float H[CV];
#pragma unroll
  for (int i = 0; i < CV; ++i) H[i] = kin[ch0 + i];
  const int unit = s / SPU;
  for (int j = 0; j < unit; ++j) {
#pragma unroll
    for (int i = 0; i < CV; ++i) {
      const float2 v = uagg[j * ct + ch0 + i];
      H[i] = step(v.x, H[i], v.y);
    }
  }
  if constexpr (ANCHOR) {  // the unit's carry: its first segment's start
    if (s % SPU == 0) {
      float* dst = p.anchors +
                   (static_cast<size_t>(b) * p.n_u + u0 + unit) * p.W + w0;
      if constexpr (VEC) {
        reinterpret_cast<float4*>(dst)[0] =
            make_float4(H[0], H[1], H[2], H[3]);
        reinterpret_cast<float4*>(dst)[1] =
            make_float4(H[4], H[5], H[6], H[7]);
      } else {
#pragma unroll
        for (int e = 0; e < CV; ++e)
          if (e < valid) dst[e] = H[e];
      }
    }
  }
  for (int q = unit * SPU; q < s; ++q) {
#pragma unroll
    for (int i = 0; i < CV; ++i) {
      const float2 v = seg[q * ct + ch0 + i];
      H[i] = step(v.x, H[i], v.y);
    }
  }
  const int rows = min(SEG, p.T - t0);
  bf16* out = p.h + (row0 + t0) * p.W + w0;
#pragma unroll 4
  for (int r = 0; r < rows; ++r) {
    float av[CV], xv[CV];
    unpack8(*row_a(r), av);
    unpack8(*row_x(r), xv);
    __align__(16) __nv_bfloat162 o[CV / 2];
#pragma unroll
    for (int i = 0; i < CV; ++i) H[i] = step(av[i], H[i], xv[i]);
#pragma unroll
    for (int i = 0; i < CV / 2; ++i)
      o[i] = __floats2bfloat162_rn(H[2 * i], H[2 * i + 1]);
    bf16* dst = out + static_cast<size_t>(r) * p.W;
    if constexpr (VEC) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(o);
    } else {
      const bf16* ov = reinterpret_cast<const bf16*>(o);
#pragma unroll
      for (int e = 0; e < CV; ++e)
        if (e < valid) dst[e] = ov[e];
    }
  }
}

// What the kernel takes: rglru::takes_shape within the shared memory a
// block may have.
bool takes(int ct, int chunk) {
  return takes_shape(ct, chunk) &&
         Shape{{ct, chunk}}.smem_bytes() <= SMEM_LIMIT;
}

}  // namespace

// x, a, h: (B, T, W) bf16; h0 (B, W) fp32 or null; hT (B, W) fp32.
// ``agg``: (B, (n_chunks - 1) * chunk / 64, W) float2 of scratch, n_chunks
// = ceil(T / chunk); ``sync``: 4 + B * n_chunks * ceil(W / ct) 32-bit
// words, zeroed once before a stream's first launch and left by each
// launch for the next (see the source note); one launch at a time on it.
// ``vec``: W % 8 == 0 and x, a, h 16-byte aligned (16-byte copies).
// ``anchors``: null (serving), or (B, ceil(T / 64), W) fp32, 16-byte
// aligned, for each unit's starting carry (training).
extern "C" int rt_rg_lru_scan(const void* x, const void* a, const void* h0,
                              void* h, void* hT, void* agg, void* anchors,
                              void* sync, int B, int T, int W, int ct,
                              int chunk, int vec, void* stream) {
  if (B <= 0 || T <= 0 || W <= 0 || B > 65535 || !takes(ct, chunk) ||
      sync == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{{}, {}, static_cast<const bf16*>(x), static_cast<const bf16*>(a),
           static_cast<const float*>(h0), static_cast<bf16*>(h),
           static_cast<float*>(hT), static_cast<float2*>(agg),
           static_cast<float*>(anchors), static_cast<uint32_t*>(sync), B,
           T, W, ct, chunk, (T + chunk - 1) / chunk, (W + ct - 1) / ct,
           (T + UNIT - 1) / UNIT};
  const long long blocks =
      static_cast<long long>(B) * p.n_chunks * p.n_tiles;
  if (blocks > 0x7fffffffLL || (p.n_chunks > 1 && agg == nullptr) ||
      (vec && reinterpret_cast<uintptr_t>(anchors) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec) {
    const rt::Encode enc = rt::encode_fn();
    if (!enc) return static_cast<int>(cudaErrorSymbolNotFound);
    CUresult cr = make_map(enc, &p.mx, x, B, T, W, ct);
    if (cr == CUDA_SUCCESS) cr = make_map(enc, &p.ma, a, B, T, W, ct);
    if (cr != CUDA_SUCCESS) return 1000 + static_cast<int>(cr);
  }
  const Shape sh{{ct, chunk}};
  const int smem = sh.smem_bytes();
  const void* fn =
      anchors ? (vec ? reinterpret_cast<const void*>(&rg_lru_kernel<true, true>)
                     : reinterpret_cast<const void*>(
                           &rg_lru_kernel<false, true>))
              : (vec ? reinterpret_cast<const void*>(
                           &rg_lru_kernel<true, false>)
                     : reinterpret_cast<const void*>(
                           &rg_lru_kernel<false, false>));
  cudaError_t rc = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  void* args[] = {&p};
  if (rc == cudaSuccess)
    rc = cudaLaunchKernel(fn, dim3(static_cast<unsigned>(blocks)),
                          dim3(sh.threads()), args, smem,
                          static_cast<cudaStream_t>(stream));
  return static_cast<int>(rc);
}

// The footprint of one block (kernels/rg_lru.py:smem_bytes), -1 for a
// tile and chunk the kernel does not take.
extern "C" int rt_rg_lru_smem_bytes(int ct, int chunk) {
  return takes(ct, chunk) ? Shape{{ct, chunk}}.smem_bytes() : -1;
}

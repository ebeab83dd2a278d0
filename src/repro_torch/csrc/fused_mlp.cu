// Fused MLP: y = (act(x @ w1 + b1) [* (x @ wg)]) @ w2 + b2, with the
// (M, F) hidden tensor kept out of device memory.
//
// Replaces the TPU kernel repro/kernels/fused_mlp.py:fused_mlp and
// computes what it computes: fp32 accumulation of both products, h formed
// in fp32 and rounded to bf16 before the second product, b2 added in fp32
// at the end.
//
// Dataflow.  The TPU kernel keeps N whole and carries a (block_m, N) fp32
// accumulator across the F grid axis; at llama3.2-3b's N = 3072 that is
// 768 KiB even at block_m = 64, far beyond the 227 KiB of shared memory a
// Hopper block may claim, and Hopper blocks run in no order, so nothing
// carries from one to the next.  This kernel splits F across blocks:
// block (i, s) owns the BM rows of M tile i (BM = 64 or 128) and the F
// slice [BF s, BF s + BF).  It computes its hidden slice h (BM x BF, bf16)
// into shared memory, multiplies it by the matching rows of w2 one N chunk
// (BN = 256 columns) at a time, and writes each chunk's fp32 partial to
// part[s].  The F / BF partials of a chunk are summed in this kernel: a
// block that has stored its partial bumps the chunk's arrival counter, and
// the block whose arrival completes the count adds the partials in slice
// order (not arrival order), adds b2 in fp32, rounds to bf16 and writes y.
// The result is bit-identical from launch to launch; no atomics touch the
// data.  Tiling N and recomputing h for each N chunk instead would redo
// the up projections (two thirds of the FLOPs) N / BN times over.
//
// Design, for wgmma's rate (csrc/hopper.cuh):
// * Warpgroup 0 is the producer: one thread issues every TMA load into an
//   mbarrier ring of ``stages`` slots with the 128-byte swizzle.  The up
//   phase walks the slice's hidden chunks (FC = 64 or 128 columns) and, in
//   each, K in steps of 64: an x tile (BM x 64, K-major) and the w1 and wg
//   tiles (64 x FC as FC / 64 boxes, N-major) per slot.  The down phase
//   walks the N chunks and, in each, the slice in steps of 64: a w2 tile
//   (64 x BN as BN / 64 boxes, N-major).  Both are one stream through one
//   ring, so the producer runs ahead across the phase change and from one
//   N chunk to the next and the ring never drains between them.
// * Warpgroups 1.. are the consumers, 64 rows of the M tile each (two
//   where BM = 128; setmaxnreg moves registers to them).  Up: wgmma
//   m64nFCk16 for x @ w1 and x @ wg, the weights read through the
//   descriptor's transpose bit so they keep the reference's (K, F)
//   layout; the epilogue adds b1, applies the activation (picked once) and
//   the gate in fp32 and writes bf16 into h in shared memory, swizzled
//   K-major as wgmma reads an A operand.  Down: wgmma m64nBNk16 with h as
//   A and the w2 tile as B.  A consumer owns its rows of h, so the phases
//   meet at a barrier of its own warpgroup only.
// * The sum.  Each consumer stores its partial chunk with plain stores and
//   hands it to the helper warps of warpgroup 0 through an mbarrier queue.
//   A helper makes the stores visible (a release fence) and bumps the
//   arrival counter of those 64 rows and that chunk with one atomicAdd;
//   both are round trips through a memory system the weight stream keeps
//   full, so three helpers take chunks in turn and the consumer reads the
//   outcome two chunks later.  Where its arrival completed the count, the
//   consumer adds the F / BF partials read through L2 (ld.global.cg), in
//   slice order, with b2, rounds to bf16 and writes y; the helper has reset
//   the counter.  Each slice walks the N chunks from its own offset, so
//   the last arrivals, and the sums, spread over the blocks.  The counters
//   and the partials are scratch the wrapper allocates; the kernel
//   allocates nothing.
//
// Bound on an H100: at prefill (M = 1024, K = N = 3072, F = 8192, gated)
// 2 * 3 * M * K * F = 155 GFLOP make it compute-bound (~156 us at the bf16
// peak); at decode (M = slots = 4) it is bound by the 151 MB of weights
// (~45 us at 3.35 TB/s).  What holds it above that, on the card (PERF.md):
// the fp32 partials, 8 M N F / BF bytes written and read (at M = 1024,
// 201 MB against h's 34 MB), whose stores stall behind the weight stream;
// the sums, latency-bound reads; and a ring two or three slots deep where
// h takes most of shared memory.  Which M tile, slice, hidden chunk and
// ring depth run is decided on the host (kernels/fused_mlp.py:schedule).
#include "hopper.cuh"

namespace {

using rt::bf16;

constexpr int MAX_STAGES = 8;
constexpr int BOX = 64 * 64 * 2;     // one 64 x 64 bf16 TMA box
constexpr int BN = 256;              // N chunk of the down phase and the sum
constexpr int GROUP_M = 8;           // M tiles walked slice by slice
// The count queue between a consumer group and the helper warps: Q slots,
// each a "stored" mbarrier (the group's 128 threads arrive once its
// partial chunk is stored), a "counted" one (a helper arrives once it has
// counted the chunk) and the flag saying whether that count completed.
// A fence and an atomic are each a round trip of microseconds through a
// loaded memory system, so HELPERS warps count chunks in turn, and a group
// reads a chunk's flag, and sums it where it completed, LAG chunks later.
// (Handing chunks over in batches, one arrival for several, was measured
// slower: a slow block is then the last arrival for the whole batch.)
constexpr int Q = 4, LAG = 2, HELPERS = 3;
static_assert(LAG < Q, "a slot is reused only after its flag is read");
// full and empty mbarriers of the ring, stored and counted ones of the
// queue (two groups), the flags
constexpr int BAR_BYTES = 512;
static_assert(2 * MAX_STAGES * 8 + 2 * 2 * Q * 8 + 2 * Q * 4 <= BAR_BYTES,
              "barriers");
constexpr int BAR_H = 1;  // named barrier: consumer group c's rows of h

struct Params {
  CUtensorMap x, w1, wg, w2;  // bf16, 128-byte swizzle, 64-column boxes
  const bf16* b1;
  const bf16* b2;
  bf16* y;
  float* part;  // [F / BF][M][N] fp32 partials
  int* count;   // [cdiv(M, 64)][cdiv(N, BN)] arrivals, left zero
  int M, K, F, N, BF, stages, act;
};

__host__ __device__ constexpr int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

template <int BM, int FC, bool GATED>
struct Cfg {
  static constexpr int NC = BM / 64;  // consumer warpgroups
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int X_BYTES = BM * 128;      // BM x 64 of x
  static constexpr int W_BYTES = FC / 64 * BOX;  // 64 x FC of w1 or wg
  static constexpr int UP_BYTES = X_BYTES + (GATED ? 2 : 1) * W_BYTES;
  static constexpr int DOWN_BYTES = BN / 64 * BOX;  // 64 x BN of w2
  static constexpr int STAGE =
      UP_BYTES > DOWN_BYTES ? UP_BYTES : DOWN_BYTES;
  // the alignment slack, h, the ring and its barriers
  static constexpr int smem_bytes(int bf, int stages) {
    return 1024 + BM * bf * 2 + stages * STAGE + BAR_BYTES;
  }
};

// y[rows, cols] = bf16(part[0] + part[1] + ... + part[S-1] + b2), the
// partials added in slice order, for rows [row0, row0 + 64) and the
// chunk's columns, by the 128 threads of one warpgroup: each sums U float4
// positions at a time, their loads for R slices in flight (the partials
// are in L2 or further, microseconds away under load).  The accumulators
// are stored by then: the registers are free.
template <int U, int R>
__device__ __forceinline__ void sum_rows(const Params& p, int row0, int n0,
                                         int tid) {
  const int rows = min(64, p.M - row0), quads = min(BN, p.N - n0) / 4;
  const int total = rows * quads, S = p.F / p.BF;
  const size_t mn = static_cast<size_t>(p.M) * p.N;
  for (int q0 = tid; q0 < total; q0 += 128 * U) {
    size_t off[U];
    float4 acc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = min(q0 + 128 * u, total - 1);
      off[u] = static_cast<size_t>(row0 + q / quads) * p.N + n0 +
               q % quads * 4;
      acc[u] = __ldcg(reinterpret_cast<const float4*>(p.part + off[u]));
    }
#pragma unroll R
    for (int s = 1; s < S; ++s)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float4 v = __ldcg(
            reinterpret_cast<const float4*>(p.part + s * mn + off[u]));
        acc[u].x += v.x;
        acc[u].y += v.y;
        acc[u].z += v.z;
        acc[u].w += v.w;
      }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (q0 + 128 * u >= total) break;
      const int c = static_cast<int>(off[u] % p.N);
      float2 b0 = make_float2(0.f, 0.f), b1 = b0;
      if (p.b2) {
        b0 = __bfloat1622float2(
            __ldg(reinterpret_cast<const __nv_bfloat162*>(p.b2 + c)));
        b1 = __bfloat1622float2(
            __ldg(reinterpret_cast<const __nv_bfloat162*>(p.b2 + c + 2)));
      }
      uint2 out;
      out.x = rt::pack_bf16(acc[u].x + b0.x, acc[u].y + b0.y);
      out.y = rt::pack_bf16(acc[u].z + b1.x, acc[u].w + b1.y);
      *reinterpret_cast<uint2*>(p.y + off[u]) = out;
    }
  }
}

// 32 loads in flight a thread: eight positions where the chunk has rows
// for eight a thread, else two (decode: a few rows, many slices) and more
// slices (measured on the card; PERF.md)
__device__ __forceinline__ void sum_partials(const Params& p, int row0,
                                             int n0, int tid) {
  if (min(64, p.M - row0) * min(BN, p.N - n0) >= 8 * 128 * 4)
    sum_rows<8, 4>(p, row0, n0, tid);
  else
    sum_rows<2, 16>(p, row0, n0, tid);
}

template <int BM, int FC, bool GATED>
__global__ void __launch_bounds__(Cfg<BM, FC, GATED>::THREADS, 1)
    fused_mlp_kernel(const __grid_constant__ Params p) {
  using C = Cfg<BM, FC, GATED>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (rt::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* hs = smem;                  // BF / 64 boxes of BM x 64
  uint8_t* ring = hs + BM * p.BF * 2;  // ``stages`` slots of STAGE bytes
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + p.stages * C::STAGE);
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* stored = empty + MAX_STAGES;  // [group][Q]
  uint64_t* counted = stored + 2 * Q;     // [group][Q]
  // [group][Q]: whether the chunk counted in that slot completed its count
  volatile int* last = reinterpret_cast<volatile int*>(counted + 2 * Q);

  // block -> (M tile, F slice): groups of GROUP_M tiles, each walked slice
  // by slice with the tile fastest, so that the blocks running together
  // share weight slices in L2 and finish an M tile's partials together
  const int S = p.F / p.BF, tiles_m = cdiv(p.M, BM);
  const int first = blockIdx.x / (GROUP_M * S) * GROUP_M;
  const int span = min(tiles_m - first, GROUP_M);
  const int in = blockIdx.x - first * S;
  const int slice = in / span, m0 = (first + in % span) * BM;
  const int f0 = slice * p.BF;
  const int kt = cdiv(p.K, 64), nch = cdiv(p.N, BN);
  // the i-th N chunk this slice walks: each slice starts at its own, so
  // that the chunks' last arrivals, and their sums, spread over the blocks
  auto chunk = [&](int i) { return (slice + i) % nch; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      rt::mbar_init(&full[s], 1);       // the producer's expect_tx
      rt::mbar_init(&empty[s], C::NC);  // one arrival per consumer group
    }
    for (int s = 0; s < 2 * Q; ++s) {
      rt::mbar_init(&stored[s], 128);
      rt::mbar_init(&counted[s], 1);
    }
    rt::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4,
            lane = threadIdx.x % 32;
  if (wg == 0) {
    if constexpr (C::NC == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      // ---- producer: one thread keeps the ring full --------------------
      int stage = 0;
      uint32_t phase = 0;
      auto next = [&](int bytes) {
        rt::mbar_wait(&empty[stage], phase ^ 1);
        rt::mbar_expect_tx(&full[stage], bytes);
        return ring + stage * C::STAGE;
      };
      auto advance = [&] {
        if (++stage == p.stages) {
          stage = 0;
          phase ^= 1;
        }
      };
      for (int fc = 0; fc < p.BF; fc += FC)
        for (int k = 0; k < kt; ++k) {
          uint8_t* st = next(C::UP_BYTES);
          rt::tma_load(st, &p.x, 64 * k, m0, &full[stage]);
#pragma unroll
          for (int j = 0; j < FC / 64; ++j) {
            rt::tma_load(st + C::X_BYTES + j * BOX, &p.w1,
                         f0 + fc + 64 * j, 64 * k, &full[stage]);
            if constexpr (GATED)
              rt::tma_load(st + C::X_BYTES + C::W_BYTES + j * BOX, &p.wg,
                           f0 + fc + 64 * j, 64 * k, &full[stage]);
          }
          advance();
        }
      for (int i = 0; i < nch; ++i)
        for (int kf = 0; kf < p.BF; kf += 64) {
          uint8_t* st = next(C::DOWN_BYTES);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            rt::tma_load(st + j * BOX, &p.w2, chunk(i) * BN + 64 * j,
                         f0 + kf, &full[stage]);
          advance();
        }
    } else if (warp >= 1) {
      // ---- helpers: warp w counts chunks w - 1, w - 1 + HELPERS, ...,
      // lane c those of consumer group c; the consumers do not wait
      if (lane < C::NC) {
        const int c = lane, row0 = m0 + 64 * c;
        for (int i = warp - 1; i < nch; i += HELPERS) {
          const int q = c * Q + i % Q;
          rt::mbar_wait(&stored[q], i / Q & 1);
          int done = 0;
          if (row0 < p.M) {
            int* cnt = p.count + row0 / 64 * nch + chunk(i);
            // release: the group's stores, which its arrival ordered
            // before this thread's wait, are visible before the count is
            asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
            done = atomicAdd(cnt, 1) == S - 1;
            if (done) {
              *cnt = 0;  // every slice has arrived: ready for the next call
              // acquire: the other slices' partials
              asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
            }
          }
          last[q] = done;
          rt::mbar_arrive(&counted[q]);
        }
      }
    }
  } else {
    // ---- consumers: rows [64 (wg - 1), 64 wg) of the M tile -------------
    if constexpr (C::NC == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1, tid = threadIdx.x % 128;
    const int g = lane >> 2, t = lane & 3;
    const bool leader = tid == 0;
    const int row0 = m0 + cw * 64;  // this group's first row
    int stage = 0, prev = -1;
    uint32_t phase = 0;
    // wait for the slot in ``stage``; after the products issued on it,
    // ``retire`` frees the slot before it (its products are done)
    auto acquire = [&] {
      rt::mbar_wait(&full[stage], phase);
      rt::wgmma_fence();
      return ring + stage * C::STAGE;
    };
    auto retire = [&] {
      rt::wgmma_commit();
      rt::wgmma_wait<1>();
      if (prev >= 0 && leader) rt::mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == p.stages) {
        stage = 0;
        phase ^= 1;
      }
    };
    auto drain = [&] {
      rt::wgmma_wait<0>();
      if (leader) rt::mbar_arrive(&empty[prev]);
      prev = -1;
    };

    // ---- up: h[:, fc : fc + FC] = act(x @ w1 + b1) [* (x @ wg)] --------
    // x: rows 128 bytes apart, 8-row swizzle atoms 1024 apart, a k16 slice
    // 32 bytes along the row.  w1, wg (N-major): 64-column boxes BOX apart
    // (leading offset), 8-row atoms 1024 apart (stride offset), a k16
    // slice 16 rows further.
    for (int fc = 0; fc < p.BF; fc += FC) {
      float a1[FC / 2], ag[GATED ? FC / 2 : 1];
#pragma unroll
      for (int j = 0; j < FC / 2; ++j) a1[j] = 0.f;
#pragma unroll
      for (int j = 0; j < (GATED ? FC / 2 : 1); ++j) ag[j] = 0.f;
      for (int k = 0; k < kt; ++k) {
        const uint8_t* st = acquire();
        const uint8_t* a = st + cw * 64 * 128;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          rt::Wgmma<FC, 1>::ss(
              a1, rt::desc(a + kk * 32, 16, 1024),
              rt::desc(st + C::X_BYTES + kk * 16 * 128, BOX, 1024), 1);
          if constexpr (GATED)
            rt::Wgmma<FC, 1>::ss(
                ag, rt::desc(a + kk * 32, 16, 1024),
                rt::desc(st + C::X_BYTES + C::W_BYTES + kk * 16 * 128, BOX,
                         1024),
                1);
        }
        retire();
      }
      drain();
      rt::fence_regs(a1);
      rt::fence_regs(ag);
      // a1[4j + 2h + e] is column 8j + 2t + e of row 16 warp + g + 8h:
      // into h's box (fc + 8j) / 64, 16-byte chunk j % 8 swizzled by the
      // row's g
      __nv_bfloat162 bias[FC / 8];
#pragma unroll
      for (int j = 0; j < FC / 8; ++j)
        bias[j] = p.b1 ? __ldg(reinterpret_cast<const __nv_bfloat162*>(
                             p.b1 + f0 + fc + 8 * j + 2 * t))
                       : __floats2bfloat162_rn(0.f, 0.f);
      rt::with_act(p.act, [&](auto act) {
#pragma unroll
        for (int j = 0; j < FC / 8; ++j) {
          const float2 b = __bfloat1622float2(bias[j]);
          uint8_t* box = hs + (fc + 8 * j) / 64 * BM * 128;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = cw * 64 + warp * 16 + g + 8 * h;
            float v0 = act(a1[4 * j + 2 * h] + b.x);
            float v1 = act(a1[4 * j + 2 * h + 1] + b.y);
            if constexpr (GATED) {
              v0 *= ag[4 * j + 2 * h];
              v1 *= ag[4 * j + 2 * h + 1];
            }
            *reinterpret_cast<uint32_t*>(box + r * 128 +
                                         ((j % 8) ^ g) * 16 + 4 * t) =
                rt::pack_bf16(v0, v1);
          }
        }
      });
    }
    // this group's rows of h, visible to its own wgmma reads
    rt::fence_async_smem();
    rt::named_barrier(BAR_H + cw, 128);

    // ---- down: part[slice][:, chunk] = h @ w2[slice, chunk] -------------
    // Chunk i: its products; its partial stored and queued for counting;
    // then chunk i - LAG settled: where its count completed, summed (the
    // accumulators are stored: the sum has the registers).
    const size_t mn = static_cast<size_t>(p.M) * p.N;
    float* part = p.part + slice * mn;
    const uint8_t* ha = hs + cw * 64 * 128;
    const int r0 = row0 + warp * 16 + g;
    auto settle = [&](int j) {
      const int q = cw * Q + j % Q;
      rt::mbar_wait(&counted[q], j / Q & 1);
      if (last[q]) sum_partials(p, row0, chunk(j) * BN, tid);
    };
    float acc[BN / 2];
    for (int i = 0; i < nch; ++i) {
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
      for (int kf = 0; kf < p.BF / 64; ++kf) {
        const uint8_t* st = acquire();
        const uint8_t* a = ha + kf * BM * 128;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          rt::Wgmma<BN, 1>::ss(acc, rt::desc(a + kk * 32, 16, 1024),
                               rt::desc(st + kk * 16 * 128, BOX, 1024), 1);
        retire();
      }
      drain();
      rt::fence_regs(acc);
      const int c0 = chunk(i) * BN + 2 * t;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = c0 + 8 * j;
        if (c >= p.N) continue;  // N is even: c + 1 < N as well
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          if (r >= p.M) continue;
          *reinterpret_cast<float2*>(part + static_cast<size_t>(r) * p.N +
                                     c) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
      rt::mbar_arrive(&stored[cw * Q + i % Q]);
      if (i >= LAG) settle(i - LAG);
    }
    for (int j = max(0, nch - LAG); j < nch; ++j) settle(j);
  }
}

using KernelFn = void (*)(Params);

// the kernel of a configuration, its threads and its shared memory at the
// slice and ring depth asked for (a null kernel: there is none)
struct Launch {
  KernelFn fn;
  int threads, smem;
};

template <int BM, int FC>
Launch launch_of(int gated, int bf, int stages) {
  if (gated)
    return {&fused_mlp_kernel<BM, FC, true>, Cfg<BM, FC, true>::THREADS,
            Cfg<BM, FC, true>::smem_bytes(bf, stages)};
  return {&fused_mlp_kernel<BM, FC, false>, Cfg<BM, FC, false>::THREADS,
          Cfg<BM, FC, false>::smem_bytes(bf, stages)};
}

Launch pick(int block_m, int block_f, int hidden_chunk, int stages,
            int gated) {
  if (block_f <= 0 || block_f % hidden_chunk || stages < 2 ||
      stages > MAX_STAGES)
    return {nullptr, 0, 0};
  if (block_m == 64 && hidden_chunk == 64)
    return launch_of<64, 64>(gated, block_f, stages);
  if (block_m == 64 && hidden_chunk == 128)
    return launch_of<64, 128>(gated, block_f, stages);
  if (block_m == 128 && hidden_chunk == 64)
    return launch_of<128, 64>(gated, block_f, stages);
  if (block_m == 128 && hidden_chunk == 128)
    return launch_of<128, 128>(gated, block_f, stages);
  return {nullptr, 0, 0};
}

}  // namespace

// Dynamic shared memory of one block (kernels/fused_mlp.py:smem_bytes must
// agree), or -1 for a configuration the kernel does not take.
extern "C" int rt_fused_mlp_smem_bytes(int block_m, int block_f,
                                       int hidden_chunk, int stages,
                                       int gated) {
  const Launch l = pick(block_m, block_f, hidden_chunk, stages, gated);
  return l.fn ? l.smem : -1;
}

// Launch on ``stream`` what kernels/fused_mlp.py:schedule chose: the M
// tile ``block_m`` (64 or 128 rows), the F slice ``block_f``, the hidden
// chunk (64 or 128) and the ring's ``stages``.  ``part`` holds the
// F / block_f fp32 partials (M x N each); ``count`` the cdiv(M, 64) x
// cdiv(N, 256) arrival counters, zero on entry and left zero.  wg, b1 and b2 may be
// null.  Returns the first cudaError_t; a tensor map the driver refuses
// returns 1000 + its CUresult.
extern "C" int rt_fused_mlp(const void* x, const void* w1, const void* wg,
                            const void* w2, const void* b1, const void* b2,
                            void* part, void* count, void* y, int M, int K,
                            int F, int N, int act_kind, int block_m,
                            int block_f, int hidden_chunk, int stages,
                            void* stream) {
  const Launch l =
      pick(block_m, block_f, hidden_chunk, stages, wg != nullptr);
  if (!l.fn || F % block_f || M < 1 || K < 1 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const rt::Encode enc = rt::encode_fn();
  if (!enc) return static_cast<int>(cudaErrorSymbolNotFound);
  Params p{};
  CUresult cr = rt::make_map(enc, &p.x, x, M, K, block_m);
  if (cr == CUDA_SUCCESS) cr = rt::make_map(enc, &p.w1, w1, K, F, 64);
  if (cr == CUDA_SUCCESS && wg) cr = rt::make_map(enc, &p.wg, wg, K, F, 64);
  if (cr == CUDA_SUCCESS) cr = rt::make_map(enc, &p.w2, w2, F, N, 64);
  if (cr != CUDA_SUCCESS) return 1000 + static_cast<int>(cr);
  p.b1 = static_cast<const bf16*>(b1);
  p.b2 = static_cast<const bf16*>(b2);
  p.y = static_cast<bf16*>(y);
  p.part = static_cast<float*>(part);
  p.count = static_cast<int*>(count);
  p.M = M, p.K = K, p.F = F, p.N = N, p.BF = block_f, p.stages = stages;
  p.act = act_kind;
  const void* fn = reinterpret_cast<const void*>(l.fn);
  cudaError_t rc = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, l.smem);
  void* args[] = {&p};
  const int grid = cdiv(M, block_m) * (F / block_f);
  if (rc == cudaSuccess)
    rc = cudaLaunchKernel(fn, dim3(grid), dim3(l.threads), args, l.smem,
                          static_cast<cudaStream_t>(stream));
  return static_cast<int>(rc);
}

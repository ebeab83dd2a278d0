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
// The recurrence is sequential in time and independent across channels.
//
// Design.  The TPU kernel tiles channels and walks time chunks in grid
// order, carrying the state in VMEM scratch between chunks; on Hopper the
// time loop lives inside the block.  One block of one warp owns 32
// channels of one batch row and keeps each channel's carry in a register
// of its lane.  Time is staged through shared memory in chunks of 64 steps
// x 32 channels (4 KiB per operand) by a four-stage cp.async ring, so
// three chunks of loads are in flight while the warp scans the fourth:
// without that, a lane issuing one 2-byte load per step would wait a full
// device-memory latency per few steps.  The lane reads its channel's x and
// a from shared memory (32 lanes on 64 contiguous bytes: no bank
// conflict), does one fma and stores h straight to device memory (one
// 64-byte coalesced store per step and warp).  At B = 1, W = 4096 that is
// 128 blocks, about one per SM.  A ragged T is cut at the last chunk; a
// ragged W masks the last block's lanes, with 16-byte copies when rows are
// 16-byte aligned (W % 8 == 0) and element copies otherwise.  A chunked
// two-pass scan that spreads T across blocks is a later step.
#include "common.cuh"

namespace {

using rt::bf16;

constexpr int CW = 32;      // channels per block: one per lane
constexpr int TC = 64;      // time steps per staged chunk
constexpr int STAGES = 4;   // chunks in the cp.async ring

template <bool VEC>
__global__ void __launch_bounds__(CW)
rg_lru_kernel(const bf16* __restrict__ x, const bf16* __restrict__ a,
              const float* __restrict__ h0, bf16* __restrict__ h,
              float* __restrict__ hT, int T, int W) {
  __shared__ __align__(16) bf16 xs[STAGES][TC][CW];
  __shared__ __align__(16) bf16 as[STAGES][TC][CW];

  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * CW, b = blockIdx.y;
  const int c = c0 + lane;
  const bool live = c < W;
  const size_t row0 = (size_t)b * T;
  const int nchunks = (T + TC - 1) / TC;

  auto load = [&](int chunk, int st) {
    for (int i = lane; i < TC * CW / 8; i += CW) {
      const int r = i / (CW / 8), cc = (i % (CW / 8)) * 8;
      const int t = chunk * TC + r;
      const int valid = t < T ? W - (c0 + cc) : 0;  // elements left in row
      const size_t off = (row0 + t) * W + c0 + cc;
      rt::load_chunk(&xs[st][r][cc], x + off, valid, VEC, x);
      rt::load_chunk(&as[st][r][cc], a + off, valid, VEC, a);
    }
  };

  float carry = (h0 != nullptr && live) ? h0[(size_t)b * W + c] : 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nchunks) load(s, s);
    rt::cp_async_commit();
  }
  for (int k = 0; k < nchunks; ++k) {
    rt::cp_async_wait<STAGES - 2>();  // chunk k has landed
    __syncthreads();                  // ... for every lane; chunk k-1 freed
    const int next = k + STAGES - 1;
    if (next < nchunks) load(next, next % STAGES);
    rt::cp_async_commit();
    const int st = k % STAGES;
    const int t0 = k * TC, tn = min(TC, T - t0);
    if (live) {
      bf16* out = h + (row0 + t0) * W + c;
#pragma unroll 8
      for (int r = 0; r < tn; ++r) {
        carry = fmaf(__bfloat162float(as[st][r][lane]), carry,
                     __bfloat162float(xs[st][r][lane]));
        out[(size_t)r * W] = __float2bfloat16(carry);
      }
    }
  }
  rt::cp_async_wait<0>();
  if (live) hT[(size_t)b * W + c] = carry;
}

}  // namespace

// x, a, h: (B, T, W) bf16; h0 (B, W) fp32 or null; hT (B, W) fp32.
// ``vec``: W % 8 == 0 and x, a 16-byte aligned (16-byte cp.async copies).
extern "C" int rt_rg_lru_scan(const void* x, const void* a, const void* h0,
                              void* h, void* hT, int B, int T, int W,
                              int vec, void* stream) {
  if (B <= 0 || T <= 0 || W <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + CW - 1) / CW, B);
  auto s = static_cast<cudaStream_t>(stream);
  auto* xx = static_cast<const bf16*>(x);
  auto* aa = static_cast<const bf16*>(a);
  auto* hh0 = static_cast<const float*>(h0);
  auto* hh = static_cast<bf16*>(h);
  auto* hhT = static_cast<float*>(hT);
  if (vec)
    rg_lru_kernel<true><<<grid, CW, 0, s>>>(xx, aa, hh0, hh, hhT, T, W);
  else
    rg_lru_kernel<false><<<grid, CW, 0, s>>>(xx, aa, hh0, hh, hhT, T, W);
  return static_cast<int>(cudaGetLastError());
}

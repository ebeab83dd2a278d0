// What the RG-LRU scan's forward kernel (rg_lru.cu) and its backward
// kernel (rg_lru_bwd.cu) share: the 16-step segments and 64-step units
// that fix their values, a block's warps, the rounded step, the flags'
// acquire and release, and the (W, T, B) tensor map read in boxes of one
// unit of steps.
#pragma once

#include "hopper.cuh"

namespace rglru {

using rt::bf16;

constexpr int SEG = 16;           // steps a compute thread scans
constexpr int UNIT = 64;          // steps a published aggregate covers
constexpr int SPU = UNIT / SEG;   // segments a unit
constexpr int CV = 8;             // channels a thread owns (16 bytes)
constexpr int MAX_THREADS = 384;
constexpr int MAX_CHUNK = 1024;
constexpr int SMEM_LIMIT = 232448;
constexpr int BOX = 64;           // steps a TMA box (and its barrier) holds
constexpr int MAX_BOXES = MAX_CHUNK / BOX;
constexpr int FOLD_BATCH = 16;    // aggregates a fold lane has in flight
constexpr int SYNC_HEADER = 4;    // 32-bit words before the flags

// A block's warps: compute warps (8 channels x 16 steps a thread), fold
// warps (one for a tile of up to 32 channels, two beyond; a lane folds one
// channel at a time) and one publisher warp.
struct Warps {
  int ct, chunk;
  __host__ __device__ constexpr int compute() const {
    return ct / CV * (chunk / SEG);
  }
  __host__ __device__ constexpr int cwarps() const {
    return (compute() + 31) / 32;
  }
  __host__ __device__ constexpr int fwarps() const {
    return ct > 32 ? 2 : 1;
  }
  __host__ __device__ constexpr int threads() const {
    return 32 * (cwarps() + fwarps() + 1);
  }
};

// A tile of 8 to 128 channels (a power of two), a chunk of whole units up
// to 1024 steps, at most MAX_THREADS threads (the footprint is each
// kernel's own).
inline bool takes_shape(int ct, int chunk) {
  return (ct == 8 || ct == 16 || ct == 32 || ct == 64 || ct == 128) &&
         chunk >= UNIT && chunk <= MAX_CHUNK && chunk % UNIT == 0 &&
         Warps{ct, chunk}.threads() <= MAX_THREADS;
}

// One step, its product and its sum each rounded (never an fma), as the
// plain version rounds them.
__device__ __forceinline__ float step(float a, float h, float x) {
  return __fadd_rn(__fmul_rn(a, h), x);
}

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[CV]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(uint32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// The block's ticket, in launch order, from the 64-bit ticket |
// generation word at the head of the sync buffer; the last ticket's taker
// resets the word to (generation + 1, ticket 0).  Thread 0 only.
__device__ __forceinline__ void take_ticket(uint32_t* sync, uint32_t* ticket,
                                            uint32_t* gen) {
  auto* word = reinterpret_cast<unsigned long long*>(sync);
  const unsigned long long old = atomicAdd(word, 1ull);
  *ticket = static_cast<uint32_t>(old);
  *gen = static_cast<uint32_t>(old >> 32);
  if (*ticket >= gridDim.x) __trap();  // the word was not left by a launch
  if (*ticket == gridDim.x - 1)        // every ticket is taken: reset
    atomicExch(word, static_cast<unsigned long long>(*gen + 1u) << 32);
}

// (B, T, W) bf16 as a 3-D map read in boxes of ct channels x one unit of
// steps, unswizzled: rows past T and channels past W read as zeros.
inline CUresult make_map(rt::Encode enc, CUtensorMap* map, const void* base,
                         int B, int T, int W, int ct) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(W) * 2,
      static_cast<cuuint64_t>(T) * static_cast<cuuint64_t>(W) * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(ct), BOX, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(base), dims, strides, box, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace rglru

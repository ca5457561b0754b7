// The warpgroup pieces the bf16 flash-attention kernels share: K1
// (flash_fwd.cu) and K2/K3 (flash_bwd.cu), all wgmma fed by a TMA ring
// (hopper.cuh). A block is CONSUMERS warpgroups that compute, each on
// WG_ROWS rows of a TILE_ROWS-row resident tile, and one producer
// warpgroup whose first warp issues the copies; a streamed tile lands in
// shared memory as TMA writes it (Tile); an accumulator leaves as bf16
// rows through shared memory (store_wg).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace flash {

constexpr int WG_ROWS = 64;                       // rows a consumer warpgroup owns
constexpr int CONSUMERS = 2;                      // consumer warpgroups a block
constexpr int TILE_ROWS = CONSUMERS * WG_ROWS;    // resident rows a block
constexpr int WG_THREADS = 128;
constexpr int TC_THREADS = (CONSUMERS + 1) * WG_THREADS;  // + the producer's
constexpr int CONSUMER_WARPS = CONSUMERS * WG_THREADS / 32;
// Registers a thread after setmaxnreg: the producer warpgroup only issues
// copies; 40 x 128 + 232 x 256 fits the 65,536 of a SM.
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr float LOG2E = 1.4426950408889634f;

// Returned by a launcher when a tensor map cannot be made: this plus its
// CUresult.
constexpr int TENSOR_MAP_FAILED = 100000;

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

// A bf16 tile of ROWS x D as TMA lands it: column blocks of COLS columns
// (D itself up to 64, else two halves of 64), each ROWS rows of ROW_BYTES
// swizzled across ROW_BYTES, one block after the other.
template <int D, int ROWS>
struct Tile {
  static constexpr int COLS = D < 64 ? D : 64;
  static constexpr int ROW_BYTES = COLS * 2;
  static constexpr int BLOCK_BYTES = ROWS * ROW_BYTES;
  static constexpr int BYTES = ROWS * D * 2;

  // TMA the (batch b, head h) rows row0.. of `map` into dst.
  static __device__ __forceinline__ void load(uint8_t* dst, const CUtensorMap* map,
                                              uint64_t* bar, int h, int row0,
                                              int b) {
#pragma unroll
    for (int c = 0; c < D / COLS; ++c)
      hopper::tma_load_4d(dst + c * BLOCK_BYTES, map, bar, c * COLS, h, row0, b);
  }

  // K-major operand: rows row0..row0+63 (or the B tile's n rows), k-step kk
  // of the head dim.
  static __device__ __forceinline__ uint64_t k_desc(const uint8_t* t, int row0,
                                                    int kk) {
    const int col = kk * 16;
    return hopper::desc_k<ROW_BYTES>(t + (col / COLS) * BLOCK_BYTES
                                     + row0 * ROW_BYTES + (col % COLS) * 2);
  }

  // MN-major B: rows 16kk..16kk+15 as the k of the product, all D columns
  // as its n.
  static __device__ __forceinline__ uint64_t mn_desc(const uint8_t* t, int kk) {
    return hopper::desc_mn<ROW_BYTES>(t + kk * 16 * ROW_BYTES, BLOCK_BYTES);
  }
};

// The tensor maps of n_maps bf16 (B, S, H, D) inputs, ptr[i] with
// (batch, seq, head) strides st[3i..3i+2] in elements, read in boxes of
// rows[i] rows. Returns 0 or TENSOR_MAP_FAILED + the CUresult.
template <int D>
int make_maps(CUtensorMap* m, int n_maps, const void* const* ptr,
              const long long* st, const int* rows, int B, int S, int H) {
  constexpr int COLS = D < 64 ? D : 64;
  for (int i = 0; i < n_maps; ++i)
    if (int err = hopper::encode_bshd_bf16(&m[i], ptr[i], B, S, H, D, st[3 * i],
                                           st[3 * i + 1], st[3 * i + 2],
                                           rows[i], COLS))
      return TENSOR_MAP_FAILED + err;
  return 0;
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (hopper::smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// A consumer warp is done with ring stage `bar`.
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) hopper::mbar_arrive(bar);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// k-step kk of an accumulator (column chunks 2kk, 2kk+1) as a bf16 A operand.
template <int R>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&acc)[R],
                                         int kk) {
  a[0] = pack_bf16(acc[8 * kk + 0], acc[8 * kk + 1]);
  a[1] = pack_bf16(acc[8 * kk + 2], acc[8 * kk + 3]);
  a[2] = pack_bf16(acc[8 * kk + 4], acc[8 * kk + 5]);
  a[3] = pack_bf16(acc[8 * kk + 6], acc[8 * kk + 7]);
}

// 2^x in one MUFU.EX2; a result below the fp32 normal range flushes to 0.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Sum and max over the 4 threads that share an accumulator row (lanes
// differing in bits 0-1).
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// Write a warpgroup's 64 x D accumulator (rows row0.. of the (b, h) head)
// as bf16 rows: through `stage` (64 x D x 2 bytes of shared memory, 16-byte
// pieces of a row rotated by the row so a warp's writes spread over the
// banks), then 16 bytes a thread to global memory; rows at or past S are
// not written. `bar` is the warpgroup's named barrier.
template <int D>
__device__ __forceinline__ void store_wg(__nv_bfloat16* out, uint8_t* stage,
                                         const float (&acc)[D / 2], int b, int S,
                                         int H, int h, int row0, int bar) {
  constexpr int PIECES = D / 8;                  // 16-byte pieces a row
  constexpr int ROT = PIECES < 8 ? PIECES : 8;
  const int wtid = threadIdx.x % WG_THREADS;
  const int lane = wtid & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = (wtid >> 5) * 16 + g + 8 * half;
#pragma unroll
    for (int i = 0; i < PIECES; ++i)
      *reinterpret_cast<uint32_t*>(stage + r * D * 2 + ((i ^ (r % ROT)) * 16)
                                   + tq * 4) =
          pack_bf16(acc[4 * i + 2 * half], acc[4 * i + 2 * half + 1]);
  }
  named_sync(bar, WG_THREADS);
  for (int idx = wtid; idx < WG_ROWS * PIECES; idx += WG_THREADS) {
    const int r = idx / PIECES, c = idx % PIECES;
    if (row0 + r < S)
      *reinterpret_cast<uint4*>(out + (((long long)b * S + row0 + r) * H + h) * D
                                + c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * D * 2 + ((c ^ (r % ROT)) * 16));
  }
}

}  // namespace flash

// Bucket tables of the one-launch optimizer kernels for Hopper (sm_90a):
// K5 in adam_fp32.cu, K7 in adam_q.cu.
//
// A step's buckets reach a kernel as one table passed by value (a
// __grid_constant__ parameter: nothing is uploaded): each bucket's
// pointers and float4 count, and cend[i], the chunks of THREADS float4s
// in buckets 0..i (a bucket's last chunk may be partial). One grid covers
// every chunk. A block walks its chunks c, c + gridDim.x, ... in order, so
// the bucket of its next chunk is found by stepping forward from the
// bucket of the last one.
//
// The grid is the number of blocks the card holds at once. Each block
// takes an equal share of the chunks, so a grid any larger leaves a
// second wave of whole shares running on a fraction of the card.

#pragma once

#include <cuda_runtime.h>

namespace edl {

// The bucket of chunk c, stepping forward from bucket b (that of the
// block's previous chunk, or 0): a block's chunks only grow.
__device__ __forceinline__ int bucket_of(const int* cend, int b, int c) {
  while (cend[b] <= c) ++b;
  return b;
}

// Blocks of `threads` threads of `kernel` resident on the current card
// at once (at least one a SM).
template <typename Kernel>
inline long long resident_blocks(Kernel kernel, int threads) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  return static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
}

}  // namespace edl

// Tables of the one-call kernels for Hopper (sm_90a): K4 and K6 in
// sgdm.cu, K5 in adam_fp32.cu, K7 in adam_q.cu, K8 in pack.cu. Each file
// keeps its row (a bucket's or a shard's pointers and length) and its
// pass bodies; the table, its chunk prefix, the grid and the last-block
// count are here.
//
// A step's rows reach a kernel as one Table passed by value (a
// __grid_constant__ parameter: nothing is uploaded): the rows, and
// cend[i], the chunks in rows 0..i (a row's last chunk may be partial).
// One grid covers every chunk. A block walks its chunks c, c + gridDim.x,
// ... in order, so the row of its next chunk is found by stepping forward
// from the row of the last one.
//
// The grid is the number of blocks the card holds at once
// (launch_resident). Each block takes an equal share of the chunks, so a
// grid any larger leaves a second wave of whole shares running on a
// fraction of the card.

#pragma once

#include <cuda_runtime.h>

namespace edl {

constexpr int THREADS = 256;

// Up to MAX rows of one call; words: the device words its passes fold
// into (so many a row, zeroed by the call), or null.
template <typename Row, int MAX>
struct Table {
  Row b[MAX];
  int cend[MAX];
  int n;
  unsigned* words;
};

// Fills tab with `count` rows: row(i, &tab->b[i]) fills row i and returns
// its length in the units a chunk holds `per_chunk` of (0 or less refuses
// the row). False if count is outside 1..MAX, a row is refused or the
// chunks overflow an int.
template <typename Row, int MAX, typename MakeRow>
bool fill_table(Table<Row, MAX>* tab, int count, long long per_chunk,
                unsigned* words, MakeRow row) {
  if (count <= 0 || count > MAX) return false;
  tab->n = count;
  tab->words = words;
  long long chunks = 0;
  for (int i = 0; i < count; ++i) {
    const long long units = row(i, &tab->b[i]);
    if (units <= 0) return false;
    chunks += (units + per_chunk - 1) / per_chunk;
    if (chunks > 0x7fffffffLL) return false;
    tab->cend[i] = static_cast<int>(chunks);
  }
  return true;
}

// The row of chunk c, stepping forward from row b (that of the block's
// previous chunk, or 0): a block's chunks only grow.
__device__ __forceinline__ int bucket_of(const int* cend, int b, int c) {
  while (cend[b] <= c) ++b;
  return b;
}

// Row b's chunks.
__device__ __forceinline__ unsigned chunks_of(const int* cend, int b) {
  return cend[b] - (b ? cend[b - 1] : 0);
}

// Adds the block's `done` chunks of row b to *count, a word of the row
// zeroed before the pass. True in thread 0 of the block that finishes the
// row last: by then no block of the pass still reads the row. Every
// thread of the block calls it.
__device__ __forceinline__ bool last_block(const int* cend, int b,
                                           unsigned* count, unsigned done) {
  __syncthreads();   // the block's threads are done with the row
  if (threadIdx.x != 0) return false;
  __threadfence();
  return atomicAdd(count, done) + done == chunks_of(cend, b);
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

// Launches KERNEL(tab, args...) over the table's chunks, THREADS threads
// a block, on a grid of the blocks the card holds at once (no more than
// the chunks).
template <auto KERNEL, typename Tab, typename... Args>
cudaError_t launch_resident(cudaStream_t st, const Tab& tab,
                            const Args&... args) {
  static const long long resident = resident_blocks(KERNEL, THREADS);
  const long long chunks = tab.cend[tab.n - 1];
  KERNEL<<<static_cast<unsigned>(chunks < resident ? chunks : resident),
           THREADS, 0, st>>>(tab, args...);
  return cudaGetLastError();
}

}  // namespace edl

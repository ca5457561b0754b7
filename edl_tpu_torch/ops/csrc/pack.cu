// The int8 gradient pack for Hopper (sm_90a): K8.
//
// K8 replaces edl_tpu/ops/pack.py::_pack_kernel (called from _pack_pallas
// through pl.pallas_call): a flat fp32 shard becomes an int8 payload of the
// same length and one fp32 scale,
//   scale = max|x| / 127   (1.0 for an all-zero shard)
//   q     = clip(round_half_even(x / scale), -127, 127).
// On the TPU one Pallas program held the whole shard in VMEM, so the
// abs-max and the quantized store shared one read of HBM. Here the max
// crosses blocks, so a call takes two passes on one stream over a table of
// every shard of a step (table.cuh: one grid over all their chunks of
// CHUNK elements), after one memset of a word a shard:
//   1. the abs-max pass folds the bits of each shard's |x| into its word
//      with atomicMax (quant.cuh's block_amax: non-negative floats order
//      like their bits and a max is exact, so the word does not depend on
//      block order);
//   2. the pack pass derives each shard's scale from its word with a true
//      division, the block holding the shard's first chunk writes it once,
//      and every element is quantized with a true division, rintf and a
//      clip (quant.cuh's quant).
// The scales stay on the card; nothing is read back to the host. One shard
// is the one-entry table. Packing a step's shards one call each (a memset
// and two kernels a shard, 72 stream entries a step over ResNet50_vd's 24
// compressed buckets) paid each small kernel's ramp and tail.
//
// Bound on an H100 SXM: 5 bytes an element (x read, q written), memory
// bound at 3.35 TB/s. This design reads x twice: 9 bytes. Any length is
// taken (no 128-lane pad: that was a TPU need, and no 4-element one), so
// each thread takes PER_THREAD elements of a chunk one by one, THREADS
// apart, all loaded before any is used. Walking the pack pass from the
// table's end, to start on what the abs-max pass left in L2, was slower.
//
// Built with -fmad=false -prec-div=true -ftz=false: the kernel matches the
// plain PyTorch version (ops/pack.py) bit for bit, subnormals included.

#include "quant.cuh"
#include "table.cuh"

namespace {

using edl::THREADS;

constexpr int PER_THREAD = 16;
constexpr int CHUNK = THREADS * PER_THREAD;
// Shards a call takes: at 36 bytes a shard the table stays within 4 KB of
// kernel parameters.
constexpr int MAX_SHARDS = 96;
// Pointers a shard, in Shard's order.
constexpr int PTRS = 3;

struct Shard {
  const float* x;
  int8_t* q;
  float* scale;
  long long n;          // elements
};

// words: one a shard, the bits of max|x|.
using Table = edl::Table<Shard, MAX_SHARDS>;

// The abs-max pass (PACK = false) or the pack pass (PACK = true) over the
// table.
template <bool PACK>
__global__ void __launch_bounds__(THREADS)
pack_kernel(const __grid_constant__ Table tab) {
  const int chunks = tab.cend[tab.n - 1];
  int b = -1;
  unsigned bits = 0u;
  float scale = 0.f;
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    const int nb = edl::bucket_of(tab.cend, b < 0 ? 0 : b, c);
    if (nb != b) {   // the same for every thread of the block
      if (!PACK && b >= 0) edl::block_amax(bits, tab.words + b);
      b = nb;
      bits = 0u;
      if (PACK) scale = edl::scale_of(tab.words[b], 0);
    }
    const Shard& sh = tab.b[b];
    const long long base =
        (long long)(c - (b ? tab.cend[b - 1] : 0)) * CHUNK + threadIdx.x;
    if (PACK && base == 0) *sh.scale = scale;
    float x[PER_THREAD];
    for (int k = 0; k < PER_THREAD; ++k) {
      const long long i = base + k * THREADS;
      x[k] = i < sh.n ? sh.x[i] : 0.f;
    }
    for (int k = 0; k < PER_THREAD; ++k) {
      const long long i = base + k * THREADS;
      if (PACK) {
        if (i < sh.n) sh.q[i] = edl::quant(x[k], scale, 0);
      } else {
        bits = max(bits, edl::abs_bits(x[k]));
      }
    }
  }
  if (!PACK && b >= 0) edl::block_amax(bits, tab.words + b);
}

template <bool PACK>
cudaError_t launch(const Table& tab, cudaStream_t st) {
  return edl::launch_resident<&pack_kernel<PACK>>(st, tab);
}

// The table of `count` shards (1..MAX_SHARDS): ptrs holds PTRS a shard,
// n the elements, each positive. False if a size is out of range or the
// chunks overflow an int.
bool make_table(void* const* ptrs, const long long* n, int count,
                unsigned* words, Table* tab) {
  return edl::fill_table(
      tab, count, CHUNK, words, [&](int i, Shard* row) -> long long {
        void* const* p = ptrs + PTRS * i;
        *row = {static_cast<const float*>(p[0]), static_cast<int8_t*>(p[1]),
                static_cast<float*>(p[2]), n[i]};
        return n[i];
      });
}

}  // namespace

extern "C" {

// K8 over `count` shards (1..96): a memset of the words, the abs-max pass,
// then the pack pass. ptrs: x, q, scale of each shard in turn (3 a shard:
// n[i] fp32 read, n[i] int8 and one fp32 written); n[i] > 0. words: count
// words of scratch, zeroed here. Returns a cudaError_t (0 = launched).
int edl_pack_int8_buckets(void* const* ptrs, const long long* n, int count,
                          void* words, void* stream) {
  Table tab;
  if (!make_table(ptrs, n, count, static_cast<unsigned*>(words), &tab))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(words, 0, count * sizeof(unsigned), st);
  if (err == cudaSuccess) err = launch<false>(tab, st);
  if (err == cudaSuccess) err = launch<true>(tab, st);
  return static_cast<int>(err);
}

// One pass of K8 alone over the table, for timing: 0 = the abs-max pass,
// 1 = the pack pass. No memset: the words keep what the last call left.
// Arguments as edl_pack_int8_buckets'.
int edl_pack_int8_pass(void* const* ptrs, const long long* n, int count,
                       void* words, int pass, void* stream) {
  Table tab;
  if (!make_table(ptrs, n, count, static_cast<unsigned*>(words), &tab) ||
      pass < 0 || pass > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(pass == 0 ? launch<false>(tab, st)
                                    : launch<true>(tab, st));
}

// K8 over one shard of n > 0 fp32 elements (the one-entry table): q gets n
// int8, scale one fp32; amax is one word of scratch, zeroed here.
int edl_pack_int8(const void* x, void* q, void* scale, void* amax,
                  long long n, void* stream) {
  void* ptrs[PTRS] = {const_cast<void*>(x), q, scale};
  return edl_pack_int8_buckets(ptrs, &n, 1, amax, stream);
}

const char* edl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Fused momentum-SGD over flat fp32 buckets for Hopper (sm_90a): K4
// with fp32 momentum, K6 with a quantized momentum plane.
//
// K4 replaces edl_tpu/ops/opt_kernels.py::_sgdm_fp32_kernel (called from
// _sgdm_fp32_pallas through pl.pallas_call, once per bucket). Per
// element, in _sgdm_math's order:
//   g' = g + wd p        (only when wd != 0)
//   m' = g' + mu m
//   p' = p + m' (-lr)
// p and m are rewritten in place. Bound on an H100 SXM: 20 bytes an
// element (p, g, m read; p, m written), memory bound at 3.35 TB/s:
// ResNet50_vd's 25.58M parameters take at least 0.153 ms a step.
// One launch covers every bucket of a step (up to MAX_BUCKETS): a table
// of each bucket's p, g, m and float4 count (table.cuh) and one grid over
// the chunks of THREADS float4s of them all; each thread updates one
// float4 (buckets are padded to a multiple of 128 elements and 16-byte
// aligned). Launching once per bucket paid each launch's ramp and tail,
// and a small bucket (BatchNorm, biases) could not fill the card. One
// bucket is the one-entry case.
//
// K6 replaces _sgdm_q_kernel (_sgdm_q_pallas): the momentum lives as a
// QPlane (q, scale, rq, rscale; int8 or fp8 e4m3 bits), dequantized as
// m = q scale + rq rscale, updated as above, and requantized with its
// residual (quant.cuh): q = quant(m', s'), r = m' - deq(q, s'),
// rq = quant(r, rs'), s' the bucket's max|m'| and rs' its max|r| over
// the codec's 127 or 448 (1.0 for zero). The two abs-maxes cross blocks
// and rs' depends on s', but m' needs only p, g and the old plane, and
// the same IEEE operations give the same bits every time. So a step is a
// memset and three passes over a table of every bucket (table.cuh), each
// recomputing m' with nothing staged:
//   A  reads g and the old planes (and p when wd != 0): 6 or 10 bytes an
//      element; folds max|m'| into the bucket's first word;
//   B  reads the same; with s' from A, folds max|r| into the second;
//   C  reads p, g and the old planes; writes p, q and rq in place (16
//      bytes an element, the bound).
// Every pass dequantizes with the OLD scales, so the new ones are written
// by the last block of C to finish a bucket (each block adds the chunks it
// did to the bucket's third word): by then no block can still read the
// old ones. Staging m' instead (the earlier design: an update pass,
// then two requantization passes a bucket, 96 stream entries a step over
// ResNet50_vd's 24 buckets) took a 4-byte fp32 workspace an element and
// paid each small pass's ramp and tail. Bound on an H100 SXM: 16 bytes
// an element; this design moves 36 (28 with wd = 0): ResNet50_vd's 25.58M
// parameters take at least 0.122 ms a step, 0.275 ms at this design's
// bytes.
//
// Every operation is an IEEE intrinsic and the file is built with
// -fmad=false: the kernels match the plain PyTorch version bit for bit.

#include "quant.cuh"
#include "table.cuh"

static_assert(CUDART_VERSION >= 12010,
              "K6's table needs the kernel parameters of CUDA 12.1 or later");

namespace {

using edl::THREADS;

struct Hyper {
  float neg_lr, mu, wd;
  int use_wd;
};

// m' = (g + wd p) + mu m, in _sgdm_math's order.
__device__ __forceinline__ float momentum(float p, float g, float m,
                                         const Hyper& hp) {
  if (hp.use_wd) g = __fadd_rn(g, __fmul_rn(hp.wd, p));
  return __fadd_rn(g, __fmul_rn(hp.mu, m));
}

__device__ __forceinline__ void sgdm_one(float& p, float g, float& m,
                                         const Hyper& hp) {
  m = momentum(p, g, m, hp);
  p = __fadd_rn(p, __fmul_rn(m, hp.neg_lr));
}

// Buckets a K4 launch takes: the table stays within the 4 KB of kernel
// parameters.
constexpr int MAX_BUCKETS = 96;

struct Bucket {
  float4* p;
  const float4* g;
  float4* m;
  long long n4;         // float4s
};

using Table = edl::Table<Bucket, MAX_BUCKETS>;

static_assert(sizeof(Table) + sizeof(Hyper) <= 4096,
              "K4's table must fit 4 KB of kernel parameters");

__global__ void __launch_bounds__(THREADS)
sgdm_fp32_kernel(const __grid_constant__ Table tab, Hyper hp) {
  const int chunks = tab.cend[tab.n - 1];
  int b = 0;
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    b = edl::bucket_of(tab.cend, b, c);
    const Bucket& bk = tab.b[b];
    const long long i =
        (long long)(c - (b ? tab.cend[b - 1] : 0)) * THREADS + threadIdx.x;
    if (i < bk.n4) {
      float4 pp = bk.p[i], mm = bk.m[i];
      const float4 gg = bk.g[i];
      sgdm_one(pp.x, gg.x, mm.x, hp);
      sgdm_one(pp.y, gg.y, mm.y, hp);
      sgdm_one(pp.z, gg.z, mm.z, hp);
      sgdm_one(pp.w, gg.w, mm.w, hp);
      bk.p[i] = pp;
      bk.m[i] = mm;
    }
  }
}

// K4 over count buckets (1..MAX_BUCKETS) in one launch.
int sgdm_fp32_launch(void* const* p, const void* const* g, void* const* m,
                     const long long* n, int count, const Hyper& hp,
                     cudaStream_t stream) {
  Table tab;
  const bool ok = edl::fill_table(
      &tab, count, THREADS, nullptr, [&](int i, Bucket* row) -> long long {
        if (n[i] % 4 != 0) return 0;
        *row = {static_cast<float4*>(p[i]), static_cast<const float4*>(g[i]),
                static_cast<float4*>(m[i]), n[i] / 4};
        return row->n4;
      });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      edl::launch_resident<&sgdm_fp32_kernel>(stream, tab, hp));
}

// -- K6 ---------------------------------------------------------------------

namespace k6 {

// Buckets a launch takes. At 56 bytes a bucket the table passes the 4 KB
// of kernel parameters of older toolkits; CUDA 12.1 and later take up to
// 32,764 bytes.
constexpr int MAX_BUCKETS = 96;
// Device words a bucket: max|m'|, max|r| (the bits of each), and the
// chunks pass C has finished.
constexpr int WORDS = 3;
// Pointers a bucket, in Bucket's order.
constexpr int PTRS = 6;

// p and g, then the momentum's plane (q, scale, rq, rscale).
struct Bucket {
  float4* p;
  const float4* g;
  char4* q;
  float* scale;
  char4* rq;
  float* rscale;
  long long n4;         // float4s
};

using Table = edl::Table<Bucket, MAX_BUCKETS>;

enum Pass { kAmax = 0, kResid = 1, kWrite = 2 };

// The end of a block's run of chunks in bucket b: fold its abs-max (A,
// B), or add its chunks to C's count and, in the bucket's last block,
// write the new scales. Every thread of the block calls it.
template <int PASS, bool FP8>
__device__ __forceinline__ void finish(const Table& tab, int b,
                                       unsigned bits, unsigned done) {
  unsigned* w = tab.words + WORDS * b;
  if constexpr (PASS == kAmax) {
    edl::block_amax(bits, w);
  } else if constexpr (PASS == kResid) {
    edl::block_amax(bits, w + 1);
  } else if (edl::last_block(tab.cend, b, w + 2, done)) {
    *tab.b[b].scale = edl::scale_of(w[0], FP8);
    *tab.b[b].rscale = edl::scale_of(w[1], FP8);
  }
}

// One pass over the table.
template <int PASS, bool FP8>
__global__ void __launch_bounds__(THREADS)
sgdm_q_kernel(const __grid_constant__ Table tab, Hyper hp) {
  const int chunks = tab.cend[tab.n - 1];
  int b = -1;
  unsigned bits = 0u, done = 0u;
  float s_old = 0.f, rs_old = 0.f, s = 0.f, rs = 0.f;
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    const int nb = edl::bucket_of(tab.cend, b < 0 ? 0 : b, c);
    if (nb != b) {   // the same for every thread of the block
      if (b >= 0) finish<PASS, FP8>(tab, b, bits, done);
      b = nb;
      bits = done = 0u;
      const Bucket& bk = tab.b[b];
      s_old = *bk.scale;
      rs_old = *bk.rscale;
      const unsigned* w = tab.words + WORDS * b;
      if (PASS != kAmax) s = edl::scale_of(w[0], FP8);
      if (PASS == kWrite) rs = edl::scale_of(w[1], FP8);
    }
    ++done;
    const Bucket& bk = tab.b[b];
    const long long i =
        (long long)(c - (b ? tab.cend[b - 1] : 0)) * THREADS + threadIdx.x;
    if (i >= bk.n4) continue;
    const float4 gg = bk.g[i];
    const char4 qq = bk.q[i], rr = bk.rq[i];
    float4 pp = make_float4(0.f, 0.f, 0.f, 0.f);
    if (PASS == kWrite || hp.use_wd) pp = bk.p[i];
    float ps[4] = {pp.x, pp.y, pp.z, pp.w};
    const float gs[4] = {gg.x, gg.y, gg.z, gg.w};
    const int8_t qs[4] = {qq.x, qq.y, qq.z, qq.w};
    const int8_t rqs[4] = {rr.x, rr.y, rr.z, rr.w};
    int8_t oq[4], orq[4];
    for (int k = 0; k < 4; ++k) {
      const float m = momentum(
          ps[k], gs[k],
          __fadd_rn(edl::dequant(qs[k], s_old, FP8),
                    edl::dequant(rqs[k], rs_old, FP8)), hp);
      if constexpr (PASS == kAmax) {
        bits = max(bits, edl::abs_bits(m));
      } else {
        const float r = edl::residual(m, s, FP8, &oq[k]);
        if constexpr (PASS == kResid) {
          bits = max(bits, edl::abs_bits(r));
        } else {
          ps[k] = __fadd_rn(ps[k], __fmul_rn(m, hp.neg_lr));
          orq[k] = edl::quant(r, rs, FP8);
        }
      }
    }
    if constexpr (PASS == kWrite) {
      bk.p[i] = make_float4(ps[0], ps[1], ps[2], ps[3]);
      bk.q[i] = make_char4(oq[0], oq[1], oq[2], oq[3]);
      bk.rq[i] = make_char4(orq[0], orq[1], orq[2], orq[3]);
    }
  }
  if (b >= 0) finish<PASS, FP8>(tab, b, bits, done);
}

template <int PASS>
cudaError_t launch(const Table& tab, const Hyper& hp, int fp8,
                   cudaStream_t st) {
  if (fp8) return edl::launch_resident<&sgdm_q_kernel<PASS, true>>(st, tab, hp);
  return edl::launch_resident<&sgdm_q_kernel<PASS, false>>(st, tab, hp);
}

// The table of `count` buckets (1..MAX_BUCKETS): ptrs holds PTRS a
// bucket, n the elements, each a positive multiple of 4. False if a size
// is out of range or the chunks overflow an int.
bool make_table(void* const* ptrs, const long long* n, int count,
                unsigned* words, Table* tab) {
  return edl::fill_table(
      tab, count, THREADS, words, [&](int i, Bucket* row) -> long long {
        if (n[i] % 4 != 0) return 0;
        void* const* q = ptrs + PTRS * i;
        *row = {static_cast<float4*>(q[0]), static_cast<const float4*>(q[1]),
                static_cast<char4*>(q[2]),  static_cast<float*>(q[3]),
                static_cast<char4*>(q[4]),  static_cast<float*>(q[5]),
                n[i] / 4};
        return row->n4;
      });
}

}  // namespace k6

}  // namespace

extern "C" {

// K4 over one bucket. n: elements, a multiple of 4; every pointer 16-byte
// aligned. Returns a cudaError_t (0 = launched).
int edl_sgdm_fp32(void* p, const void* g, void* m, long long n, float lr,
                  float mu, float wd, int use_wd, void* stream) {
  return sgdm_fp32_launch(&p, &g, &m, &n, 1, Hyper{-lr, mu, wd, use_wd},
                          static_cast<cudaStream_t>(stream));
}

// K4 over `count` buckets (1..96) in one launch: p[i], g[i], m[i] of n[i]
// elements each, as edl_sgdm_fp32 takes one.
int edl_sgdm_fp32_buckets(void* const* p, const void* const* g,
                          void* const* m, const long long* n, int count,
                          float lr, float mu, float wd, int use_wd,
                          void* stream) {
  return sgdm_fp32_launch(p, g, m, n, count, Hyper{-lr, mu, wd, use_wd},
                          static_cast<cudaStream_t>(stream));
}

// K6 over `count` buckets (1..96): a memset of the words, then passes A,
// B and C. ptrs: p, g, q, scale, rq, rscale of each bucket in turn (6 a
// bucket; p and g 16-byte aligned fp32, q and rq int8, 4-byte aligned
// (fp8 = 1: e4m3 bits), the scales one fp32 each, read by all three
// passes and rewritten at the end of C); n[i]: bucket i's elements, a
// multiple of 4. words: 3 * count words of scratch, zeroed here. Returns
// a cudaError_t (0 = launched).
int edl_sgdm_q_buckets(void* const* ptrs, const long long* n, int count,
                       void* words, float lr, float mu, float wd, int use_wd,
                       int fp8, void* stream) {
  k6::Table tab;
  if (!k6::make_table(ptrs, n, count, static_cast<unsigned*>(words), &tab))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(words, 0, k6::WORDS * count * sizeof(unsigned), st);
  const Hyper hp{-lr, mu, wd, use_wd};
  if (err == cudaSuccess) err = k6::launch<k6::kAmax>(tab, hp, fp8, st);
  if (err == cudaSuccess) err = k6::launch<k6::kResid>(tab, hp, fp8, st);
  if (err == cudaSuccess) err = k6::launch<k6::kWrite>(tab, hp, fp8, st);
  return static_cast<int>(err);
}

// One pass of K6 alone over the table, for timing: 0 = A, 1 = B, 2 = C.
// No memset: the words keep what the last call left. Arguments as
// edl_sgdm_q_buckets'.
int edl_sgdm_q_pass(void* const* ptrs, const long long* n, int count,
                    void* words, int pass, float lr, float mu, float wd,
                    int use_wd, int fp8, void* stream) {
  k6::Table tab;
  if (!k6::make_table(ptrs, n, count, static_cast<unsigned*>(words), &tab))
    return static_cast<int>(cudaErrorInvalidValue);
  const Hyper hp{-lr, mu, wd, use_wd};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (pass) {
    case k6::kAmax:
      return static_cast<int>(k6::launch<k6::kAmax>(tab, hp, fp8, st));
    case k6::kResid:
      return static_cast<int>(k6::launch<k6::kResid>(tab, hp, fp8, st));
    case k6::kWrite:
      return static_cast<int>(k6::launch<k6::kWrite>(tab, hp, fp8, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* edl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

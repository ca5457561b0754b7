// Fused Adam(W) over flat fp32 buckets with quantized moments, for
// Hopper (sm_90a): K7.
//
// Replaces edl_tpu/ops/opt_kernels.py::_adam_q_kernel (_adam_q_pallas,
// through pl.pallas_call, once per bucket). Both moments live as QPlanes
// (quant.cuh): m on the mode's codec (int8 or fp8 e4m3), v always on fp8
// (V_QUANT: a linear int8 grid under the update's square root
// zero-floors small entries). Per element: m = q_m s_m + rq_m rs_m,
// v = q_v s_v + rq_v rs_v, then _adam_math's update as in adam_fp32.cu
// (v clamped at 0 first), p rewritten in place, and both moments
// requantized with their residuals: q = quant(m', s'), r = m' - deq(q, s'),
// rq = quant(r, rs'), where s' is the bucket's max|m'| and rs' its max|r|
// over the codec's 127 or 448 (1.0 for zero). lr, c1 = 1 - b1^t and
// c2 = 1 - b2^t come by value from the host.
//
// Design. The two abs-max reductions cross blocks, and rs' depends on
// s'. Neither needs p or a staged m': m' and v' come from g and the old
// planes alone, and the same IEEE operations give the same bits every
// time. So a step is three passes over a table of buckets (table.cuh),
// each recomputing m' and v', with nothing staged:
//   A  reads g and the old planes (8 bytes an element); folds max|m'| and
//      max|v'| into the bucket's words;
//   B  reads the same; with s' from A, folds max|r_m| and max|r_v|;
//   C  reads p, g and the old planes; writes p and the four planes in
//      place (20 bytes an element, the bound).
// Every pass dequantizes with the OLD scales, so the new ones are written
// by the last block of C to finish a bucket (each block adds the chunks
// it did to the bucket's count): by then no block can still read the old
// ones. The words (WORDS a bucket: the four abs-maxes and C's count) are
// zeroed by one memset a call: a step is 4 stream entries. A bucket is
// the one-entry table. Running the three passes per group of buckets
// small enough for B and C to find A's bytes in the 50 MB L2 was slower
// on the base LM's plan: only its smallest buckets fit, and each group
// paid three more launches.
//
// Bound on an H100 SXM: 20 bytes an element (p, g read; p written; four
// int8 planes read and written). This design moves 36 and keeps no fp32
// workspace. At the base LM config's 168.9M parameters the bound is 1.01
// ms a step. Pass C also does 7 IEEE divisions and a square root an
// element; edl_adam_q_pass times C with its loads and stores alone.
//
// Every operation is an IEEE intrinsic and the file is built with
// -fmad=false -prec-div=true -prec-sqrt=true: the kernel matches the
// plain PyTorch version bit for bit.

#include "quant.cuh"
#include "table.cuh"

static_assert(CUDART_VERSION >= 12010,
              "K7's table needs the kernel parameters of CUDA 12.1 or later");

namespace {

using edl::THREADS;

struct Hyper {
  float lr, c1, c2, b1, omb1, b2, omb2, eps, wd;
  int use_wd;
};

// Buckets a launch takes. At 88 bytes a bucket the table passes the
// 4 KB of kernel parameters of older toolkits; CUDA 12.1 and later take
// up to 32,764 bytes.
constexpr int MAX_BUCKETS = 96;
// Device words a bucket: max|m'|, max|v'|, max|r_m|, max|r_v| (the bits
// of each), and the chunks pass C has finished.
constexpr int WORDS = 5;
// Pointers a bucket, in Bucket's order.
constexpr int PTRS = 10;

// p and g, then m's plane and v's plane, each (q, scale, rq, rscale).
struct Bucket {
  float4* p;
  const float4* g;
  char4* qm;
  float* sm;
  char4* rqm;
  float* rsm;
  char4* qv;
  float* sv;
  char4* rqv;
  float* rsv;
  long long n4;         // float4s
};

using Table = edl::Table<Bucket, MAX_BUCKETS>;

enum Pass { kAmax = 0, kResid = 1, kWrite = 2, kWriteLoadsOnly = 3 };

// A bucket's scales and rscales of m and of v.
struct Scales {
  float m, rm, v, rv;
};

// m' and v' of one element from g and the old planes, in _adam_math's
// order.
template <bool MFP8>
__device__ __forceinline__ void moments(float g, int8_t qm, int8_t rqm,
                                        int8_t qv, int8_t rqv,
                                        const Scales& s, const Hyper& hp,
                                        float& m, float& v) {
  m = __fadd_rn(edl::dequant(qm, s.m, MFP8), edl::dequant(rqm, s.rm, MFP8));
  v = __fadd_rn(edl::dequant(qv, s.v, 1), edl::dequant(rqv, s.rv, 1));
  const float vc = (v != v) ? v : fmaxf(v, 0.f);   // NaN passes, as in torch
  m = __fadd_rn(__fmul_rn(hp.omb1, g), __fmul_rn(hp.b1, m));
  v = __fadd_rn(__fmul_rn(hp.omb2, __fmul_rn(g, g)), __fmul_rn(hp.b2, vc));
}

__device__ __forceinline__ float update(float p, float m, float v,
                                        const Hyper& hp) {
  float u = __fdiv_rn(__fdiv_rn(m, hp.c1),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, hp.c2)), hp.eps));
  if (hp.use_wd) u = __fadd_rn(u, __fmul_rn(hp.wd, p));
  return __fadd_rn(p, __fmul_rn(u, -hp.lr));
}

// The end of a block's run of chunks in bucket b: fold its abs-maxes (A,
// B), or add its chunks to C's count and, in the bucket's last block,
// write the new scales. Every thread of the block calls it.
template <int PASS, bool MFP8>
__device__ __forceinline__ void finish(const Table& tab, int b,
                                       unsigned mbits, unsigned vbits,
                                       unsigned done) {
  unsigned* w = tab.words + WORDS * b;
  if constexpr (PASS == kAmax) {
    edl::block_amax(mbits, w);
    edl::block_amax(vbits, w + 1);
  } else if constexpr (PASS == kResid) {
    edl::block_amax(mbits, w + 2);
    edl::block_amax(vbits, w + 3);
  } else if constexpr (PASS == kWrite) {
    if (edl::last_block(tab.cend, b, w + 4, done)) {
      const Bucket& bk = tab.b[b];
      *bk.sm = edl::scale_of(w[0], MFP8);
      *bk.rsm = edl::scale_of(w[2], MFP8);
      *bk.sv = edl::scale_of(w[1], 1);
      *bk.rsv = edl::scale_of(w[3], 1);
    }
  }
}

template <int PASS, bool MFP8>
__global__ void __launch_bounds__(THREADS)
adam_q_kernel(const __grid_constant__ Table tab, Hyper hp) {
  const int chunks = tab.cend[tab.n - 1];
  int b = -1;
  unsigned mbits = 0u, vbits = 0u, done = 0u;
  Scales old{}, s{};
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    const int nb = edl::bucket_of(tab.cend, b < 0 ? 0 : b, c);
    if (nb != b) {   // the same for every thread of the block
      if (b >= 0) finish<PASS, MFP8>(tab, b, mbits, vbits, done);
      b = nb;
      mbits = vbits = done = 0u;
      const Bucket& bk = tab.b[b];
      old = {*bk.sm, *bk.rsm, *bk.sv, *bk.rsv};
      const unsigned* w = tab.words + WORDS * b;
      if (PASS != kAmax) {
        s.m = edl::scale_of(w[0], MFP8);
        s.v = edl::scale_of(w[1], 1);
      }
      if (PASS != kAmax && PASS != kResid) {
        s.rm = edl::scale_of(w[2], MFP8);
        s.rv = edl::scale_of(w[3], 1);
      }
    }
    ++done;
    const Bucket& bk = tab.b[b];
    const long long i =
        (long long)(c - (b ? tab.cend[b - 1] : 0)) * THREADS + threadIdx.x;
    if (i >= bk.n4) continue;
    const float4 gg = bk.g[i];
    const char4 a = bk.qm[i], ar = bk.rqm[i], e = bk.qv[i], er = bk.rqv[i];
    float4 pp = make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (PASS >= kWrite) pp = bk.p[i];
    if constexpr (PASS == kWriteLoadsOnly) {
      // C's loads and stores without its arithmetic: each value goes back
      // unchanged, g read too (z is 0 at run time, which the compiler
      // cannot know)
      const float z = __fmul_rn(hp.lr, 0.f);
      const signed char zi = z != 0.f;
      bk.p[i] = make_float4(__fadd_rn(pp.x, __fmul_rn(gg.x, z)),
                            __fadd_rn(pp.y, __fmul_rn(gg.y, z)),
                            __fadd_rn(pp.z, __fmul_rn(gg.z, z)),
                            __fadd_rn(pp.w, __fmul_rn(gg.w, z)));
      bk.qm[i] = make_char4(a.x + zi, a.y, a.z, a.w);
      bk.rqm[i] = make_char4(ar.x + zi, ar.y, ar.z, ar.w);
      bk.qv[i] = make_char4(e.x + zi, e.y, e.z, e.w);
      bk.rqv[i] = make_char4(er.x + zi, er.y, er.z, er.w);
      continue;
    }
    float ps[4] = {pp.x, pp.y, pp.z, pp.w};
    const float gs[4] = {gg.x, gg.y, gg.z, gg.w};
    const int8_t qm[4] = {a.x, a.y, a.z, a.w};
    const int8_t rqm[4] = {ar.x, ar.y, ar.z, ar.w};
    const int8_t qv[4] = {e.x, e.y, e.z, e.w};
    const int8_t rqv[4] = {er.x, er.y, er.z, er.w};
    int8_t oqm[4], orqm[4], oqv[4], orqv[4];
    for (int k = 0; k < 4; ++k) {
      float m, v;
      moments<MFP8>(gs[k], qm[k], rqm[k], qv[k], rqv[k], old, hp, m, v);
      if constexpr (PASS == kAmax) {
        mbits = max(mbits, edl::abs_bits(m));
        vbits = max(vbits, edl::abs_bits(v));
      } else {
        const float rm = edl::residual(m, s.m, MFP8, &oqm[k]);
        const float rv = edl::residual(v, s.v, 1, &oqv[k]);
        if constexpr (PASS == kResid) {
          mbits = max(mbits, edl::abs_bits(rm));
          vbits = max(vbits, edl::abs_bits(rv));
        } else {
          ps[k] = update(ps[k], m, v, hp);
          orqm[k] = edl::quant(rm, s.rm, MFP8);
          orqv[k] = edl::quant(rv, s.rv, 1);
        }
      }
    }
    if constexpr (PASS == kWrite) {
      bk.p[i] = make_float4(ps[0], ps[1], ps[2], ps[3]);
      bk.qm[i] = make_char4(oqm[0], oqm[1], oqm[2], oqm[3]);
      bk.rqm[i] = make_char4(orqm[0], orqm[1], orqm[2], orqm[3]);
      bk.qv[i] = make_char4(oqv[0], oqv[1], oqv[2], oqv[3]);
      bk.rqv[i] = make_char4(orqv[0], orqv[1], orqv[2], orqv[3]);
    }
  }
  if (b >= 0) finish<PASS, MFP8>(tab, b, mbits, vbits, done);
}

template <int PASS>
cudaError_t launch(const Table& tab, const Hyper& hp, int m_fp8,
                   cudaStream_t st) {
  if (m_fp8)
    return edl::launch_resident<&adam_q_kernel<PASS, true>>(st, tab, hp);
  return edl::launch_resident<&adam_q_kernel<PASS, false>>(st, tab, hp);
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
                static_cast<char4*>(q[6]),  static_cast<float*>(q[7]),
                static_cast<char4*>(q[8]),  static_cast<float*>(q[9]),
                n[i] / 4};
        return row->n4;
      });
}

}  // namespace

extern "C" {

// K7 over `count` buckets (1..96). ptrs: p, g, q_m, s_m, rq_m, rs_m, q_v,
// s_v, rq_v, rs_v of each bucket in turn (10 a bucket; p and g 16-byte
// aligned fp32, the planes int8, 4-byte aligned, the scales one fp32
// each, read by all three passes and rewritten at the end of C); n[i]:
// bucket i's elements, a multiple of 4. words: WORDS * count words of
// scratch, zeroed here. m planes on the fp8 codec when m_fp8 = 1 (else
// int8), v planes always fp8. omb1 = 1 - b1 and omb2 = 1 - b2 as the host
// rounds them to fp32. Returns a cudaError_t (0 = launched).
int edl_adam_q_buckets(void* const* ptrs, const long long* n, int count,
                       void* words, float lr, float c1, float c2, float b1,
                       float omb1, float b2, float omb2, float eps, float wd,
                       int use_wd, int m_fp8, void* stream) {
  Table tab;
  if (!make_table(ptrs, n, count, static_cast<unsigned*>(words), &tab))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(words, 0, WORDS * count * sizeof(unsigned), st);
  const Hyper hp{lr, c1, c2, b1, omb1, b2, omb2, eps, wd, use_wd};
  if (err == cudaSuccess) err = launch<kAmax>(tab, hp, m_fp8, st);
  if (err == cudaSuccess) err = launch<kResid>(tab, hp, m_fp8, st);
  if (err == cudaSuccess) err = launch<kWrite>(tab, hp, m_fp8, st);
  return static_cast<int>(err);
}

// One pass of K7 alone over the table, for timing: 0 = A, 1 = B, 2 = C,
// 3 = C's loads and stores without its arithmetic (p and the planes
// written back unchanged). No memset: the words keep what the last call
// left. Arguments as edl_adam_q_buckets'.
int edl_adam_q_pass(void* const* ptrs, const long long* n, int count,
                    void* words, int pass, float lr, float c1, float c2,
                    float b1, float omb1, float b2, float omb2, float eps,
                    float wd, int use_wd, int m_fp8, void* stream) {
  Table tab;
  if (!make_table(ptrs, n, count, static_cast<unsigned*>(words), &tab))
    return static_cast<int>(cudaErrorInvalidValue);
  const Hyper hp{lr, c1, c2, b1, omb1, b2, omb2, eps, wd, use_wd};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (pass) {
    case kAmax: return static_cast<int>(launch<kAmax>(tab, hp, m_fp8, st));
    case kResid: return static_cast<int>(launch<kResid>(tab, hp, m_fp8, st));
    case kWrite: return static_cast<int>(launch<kWrite>(tab, hp, m_fp8, st));
    case kWriteLoadsOnly:
      return static_cast<int>(launch<kWriteLoadsOnly>(tab, hp, m_fp8, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* edl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

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
// One launch covers every bucket of a step (up to MAX_BUCKETS): a bucket
// table passed by value (each entry's p, g, m and float4 count, and the
// prefix of its chunks of THREADS float4s) and one grid over all the
// chunks; a block finds its chunk's bucket by binary search over the
// prefix, then each thread updates one float4 (buckets are padded to a
// multiple of 128 elements and 16-byte aligned). Launching once per
// bucket paid each launch's ramp and tail, and a small bucket (BatchNorm,
// biases) could not fill the card. One bucket is the one-entry case.
//
// K6 replaces _sgdm_q_kernel (_sgdm_q_pallas): the momentum lives as a
// QPlane (q, scale, rq, rscale; int8 or fp8 e4m3 bits), dequantized as
// m = q scale + rq rscale, updated as above, and requantized with its
// residual (quant.cuh). Three passes on one stream: this file's update
// pass, then quant.cuh's two requantization passes. Bound: 16 bytes an
// element (p, g read; p written; q, rq read and written); this design
// moves 28 (m' is staged in fp32 and read twice more), 0.122 ms a step at
// the bound for ResNet50_vd.
//
// Every operation is an IEEE intrinsic and the file is built with
// -fmad=false: the kernels match the plain PyTorch version bit for bit.

#include "quant.cuh"

namespace {

using edl::THREADS;

struct Hyper {
  float neg_lr, mu, wd;
  int use_wd;
};

__device__ __forceinline__ void sgdm_one(float& p, float g, float& m,
                                         const Hyper& hp) {
  if (hp.use_wd) g = __fadd_rn(g, __fmul_rn(hp.wd, p));
  m = __fadd_rn(g, __fmul_rn(hp.mu, m));
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

// The buckets of one launch and cend[i], the chunks of THREADS float4s in
// buckets 0..i (a bucket's last chunk may be partial).
struct Table {
  Bucket b[MAX_BUCKETS];
  int cend[MAX_BUCKETS];
  int n;
};

__global__ void __launch_bounds__(THREADS)
sgdm_fp32_kernel(const __grid_constant__ Table tab, Hyper hp) {
  const int chunks = tab.cend[tab.n - 1];
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    int lo = 0, hi = tab.n - 1;     // the first bucket whose cend > c
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (tab.cend[mid] > c) hi = mid; else lo = mid + 1;
    }
    const Bucket& bk = tab.b[lo];
    const long long i =
        (long long)(c - (lo ? tab.cend[lo - 1] : 0)) * THREADS + threadIdx.x;
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
  if (count <= 0 || count > MAX_BUCKETS)
    return static_cast<int>(cudaErrorInvalidValue);
  Table tab;
  tab.n = count;
  long long chunks = 0;
  for (int i = 0; i < count; ++i) {
    if (n[i] % 4 != 0 || n[i] <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const long long n4 = n[i] / 4;
    tab.b[i] = {static_cast<float4*>(p[i]), static_cast<const float4*>(g[i]),
                static_cast<float4*>(m[i]), n4};
    chunks += (n4 + THREADS - 1) / THREADS;
    if (chunks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    tab.cend[i] = static_cast<int>(chunks);
  }
  const unsigned grid = static_cast<unsigned>(
      chunks < edl::MAX_BLOCKS ? chunks : edl::MAX_BLOCKS);
  sgdm_fp32_kernel<<<grid, THREADS, 0, stream>>>(tab, hp);
  return static_cast<int>(cudaGetLastError());
}

// Pass 1 of K6: dequantize, update, write p, stage m', fold max|m'|.
__global__ void __launch_bounds__(THREADS)
sgdm_q_update_kernel(float4* __restrict__ p, const float4* __restrict__ g,
                     const char4* __restrict__ q, const float* scale,
                     const char4* __restrict__ rq, const float* rscale,
                     float4* __restrict__ work, unsigned* amax, long long n4,
                     Hyper hp, int fp8) {
  const float s = *scale, rs = *rscale;
  unsigned bits = 0u;
  for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x; i < n4;
       i += (long long)gridDim.x * THREADS) {
    float4 pp = p[i];
    const float4 gg = g[i];
    const char4 qq = q[i], rr = rq[i];
    float ps[4] = {pp.x, pp.y, pp.z, pp.w};
    const float gs[4] = {gg.x, gg.y, gg.z, gg.w};
    const int8_t qs[4] = {qq.x, qq.y, qq.z, qq.w};
    const int8_t rs4[4] = {rr.x, rr.y, rr.z, rr.w};
    float ms[4];
    for (int k = 0; k < 4; ++k) {
      ms[k] = __fadd_rn(edl::dequant(qs[k], s, fp8),
                        edl::dequant(rs4[k], rs, fp8));
      sgdm_one(ps[k], gs[k], ms[k], hp);
      bits = max(bits, edl::abs_bits(ms[k]));
    }
    p[i] = make_float4(ps[0], ps[1], ps[2], ps[3]);
    work[i] = make_float4(ms[0], ms[1], ms[2], ms[3]);
  }
  edl::block_amax(bits, amax);
}

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

// K6: the three passes over one bucket. q/rq: n int8 (fp8 = 1: e4m3
// bits); scale/rscale: one fp32 each, read by pass 1 and rewritten by
// passes 2 and 3; work: n fp32 of scratch; amax: 2 words of scratch,
// zeroed here. Returns a cudaError_t (0 = launched).
int edl_sgdm_q(void* p, const void* g, void* q, void* scale, void* rq,
               void* rscale, void* work, void* amax, long long n, float lr,
               float mu, float wd, int use_wd, int fp8, void* stream) {
  if (n % 4 != 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n4 = n / 4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned* words = static_cast<unsigned*>(amax);
  cudaError_t err = cudaMemsetAsync(words, 0, 2 * sizeof(unsigned), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Hyper hp{-lr, mu, wd, use_wd};
  sgdm_q_update_kernel<<<edl::grid_for(n4), THREADS, 0, st>>>(
      static_cast<float4*>(p), static_cast<const float4*>(g),
      static_cast<const char4*>(q), static_cast<const float*>(scale),
      static_cast<const char4*>(rq), static_cast<const float*>(rscale),
      static_cast<float4*>(work), words, n4, hp, fp8);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const edl::Plane pass2[1] = {{static_cast<const float4*>(work),
                                static_cast<char4*>(q),
                                static_cast<float*>(scale), words, words + 1,
                                fp8}};
  const edl::Plane pass3[1] = {edl::resid_plane(pass2[0], rq, rscale)};
  return edl::requant(pass2, pass3, n4, st);
}

const char* edl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

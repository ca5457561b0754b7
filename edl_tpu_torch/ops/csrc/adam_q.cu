// Fused Adam(W) over one flat fp32 bucket with quantized moments, for
// Hopper (sm_90a): K7.
//
// Replaces edl_tpu/ops/opt_kernels.py::_adam_q_kernel (_adam_q_pallas,
// through pl.pallas_call). Both moments live as QPlanes (quant.cuh): m on
// the mode's codec (int8 or fp8 e4m3), v always on fp8 (V_QUANT: a linear
// int8 grid under the update's square root zero-floors small entries).
// Per element: m = q_m s_m + rq_m rs_m, v = q_v s_v + rq_v rs_v, then
// _adam_math's update as in adam_fp32.cu (v clamped at 0 first), p
// rewritten in place, and both moments requantized with their residuals.
// Three passes on one stream: this file's update pass stages m' and v' in
// an fp32 workspace of 2n and folds max|m'| and max|v'|; quant.cuh's two
// requantization passes then handle both planes at once. lr, c1 = 1 - b1^t
// and c2 = 1 - b2^t come by value from the host.
//
// Bound on an H100 SXM: 20 bytes an element (p, g read; p written; four
// int8 planes read and written). This design moves 44 (m' and v' staged
// in fp32, read twice more). At the base LM config's 168.9M parameters
// the bound is 1.01 ms a step.
//
// Every operation is an IEEE intrinsic and the file is built with
// -fmad=false -prec-div=true -prec-sqrt=true: the kernel matches the
// plain PyTorch version bit for bit.

#include "quant.cuh"

namespace {

using edl::THREADS;

struct Hyper {
  float lr, c1, c2, b1, omb1, b2, omb2, eps, wd;
  int use_wd;
};

__device__ __forceinline__ void adam_one(float& p, float g, float& m, float& v,
                                         const Hyper& hp) {
  const float vc = (v != v) ? v : fmaxf(v, 0.f);   // NaN passes, as in torch
  m = __fadd_rn(__fmul_rn(hp.omb1, g), __fmul_rn(hp.b1, m));
  v = __fadd_rn(__fmul_rn(hp.omb2, __fmul_rn(g, g)), __fmul_rn(hp.b2, vc));
  float u = __fdiv_rn(__fdiv_rn(m, hp.c1),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, hp.c2)), hp.eps));
  if (hp.use_wd) u = __fadd_rn(u, __fmul_rn(hp.wd, p));
  p = __fadd_rn(p, __fmul_rn(u, -hp.lr));
}

struct QIn {
  const char4* q;
  const float* scale;
  const char4* rq;
  const float* rscale;
};

// Pass 1 of K7: dequantize both moments, update, write p, stage m' in
// work[0, n) and v' in work[n, 2n), fold max|m'| into amax[0] and max|v'|
// into amax[1].
__global__ void __launch_bounds__(THREADS)
adam_q_update_kernel(float4* __restrict__ p, const float4* __restrict__ g,
                     QIn mq, QIn vq, float4* __restrict__ work,
                     unsigned* amax, long long n4, Hyper hp, int m_fp8) {
  const float sm = *mq.scale, rsm = *mq.rscale;
  const float sv = *vq.scale, rsv = *vq.rscale;
  unsigned mbits = 0u, vbits = 0u;
  for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x; i < n4;
       i += (long long)gridDim.x * THREADS) {
    const float4 pp = p[i], gg = g[i];
    const char4 a = mq.q[i], ar = mq.rq[i], b = vq.q[i], br = vq.rq[i];
    float ps[4] = {pp.x, pp.y, pp.z, pp.w};
    const float gs[4] = {gg.x, gg.y, gg.z, gg.w};
    const int8_t qm[4] = {a.x, a.y, a.z, a.w};
    const int8_t rqm[4] = {ar.x, ar.y, ar.z, ar.w};
    const int8_t qv[4] = {b.x, b.y, b.z, b.w};
    const int8_t rqv[4] = {br.x, br.y, br.z, br.w};
    float ms[4], vs[4];
    for (int k = 0; k < 4; ++k) {
      ms[k] = __fadd_rn(edl::dequant(qm[k], sm, m_fp8),
                        edl::dequant(rqm[k], rsm, m_fp8));
      vs[k] = __fadd_rn(edl::dequant(qv[k], sv, 1),
                        edl::dequant(rqv[k], rsv, 1));
      adam_one(ps[k], gs[k], ms[k], vs[k], hp);
      mbits = max(mbits, edl::abs_bits(ms[k]));
      vbits = max(vbits, edl::abs_bits(vs[k]));
    }
    p[i] = make_float4(ps[0], ps[1], ps[2], ps[3]);
    work[i] = make_float4(ms[0], ms[1], ms[2], ms[3]);
    work[n4 + i] = make_float4(vs[0], vs[1], vs[2], vs[3]);
  }
  edl::block_amax(mbits, amax);
  edl::block_amax(vbits, amax + 1);
}

}  // namespace

extern "C" {

// K7: the three passes over one bucket. n: elements, a multiple of 4;
// every pointer 16-byte aligned. m planes on the fp8 codec when m_fp8 = 1
// (else int8), v planes always fp8. Scales: one fp32 each, read by pass 1
// and rewritten by passes 2 and 3. work: 2n fp32 of scratch; amax: 4 words
// of scratch, zeroed here. omb1 = 1 - b1 and omb2 = 1 - b2 as the host
// rounds them to fp32. Returns a cudaError_t (0 = launched).
int edl_adam_q(void* p, const void* g, void* qm, void* sm, void* rqm,
               void* rsm, void* qv, void* sv, void* rqv, void* rsv,
               void* work, void* amax, long long n, float lr, float c1,
               float c2, float b1, float omb1, float b2, float omb2,
               float eps, float wd, int use_wd, int m_fp8, void* stream) {
  if (n % 4 != 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n4 = n / 4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned* words = static_cast<unsigned*>(amax);
  cudaError_t err = cudaMemsetAsync(words, 0, 4 * sizeof(unsigned), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Hyper hp{lr, c1, c2, b1, omb1, b2, omb2, eps, wd, use_wd};
  const QIn mq{static_cast<const char4*>(qm), static_cast<const float*>(sm),
               static_cast<const char4*>(rqm),
               static_cast<const float*>(rsm)};
  const QIn vq{static_cast<const char4*>(qv), static_cast<const float*>(sv),
               static_cast<const char4*>(rqv),
               static_cast<const float*>(rsv)};
  float4* w = static_cast<float4*>(work);
  adam_q_update_kernel<<<edl::grid_for(n4), THREADS, 0, st>>>(
      static_cast<float4*>(p), static_cast<const float4*>(g), mq, vq, w,
      words, n4, hp, m_fp8);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // words: max|m'|, max|v'|, max|r_m|, max|r_v|
  const edl::Plane m2{w, static_cast<char4*>(qm), static_cast<float*>(sm),
                      words, words + 2, m_fp8};
  const edl::Plane v2{w + n4, static_cast<char4*>(qv),
                      static_cast<float*>(sv), words + 1, words + 3, 1};
  const edl::Plane pass2[2] = {m2, v2};
  const edl::Plane pass3[2] = {edl::resid_plane(m2, rqm, rsm),
                               edl::resid_plane(v2, rqv, rsv)};
  return edl::requant(pass2, pass3, n4, st);
}

const char* edl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

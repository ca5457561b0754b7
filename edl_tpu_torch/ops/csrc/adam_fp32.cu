// Fused Adam(W) update of one flat fp32 bucket for Hopper (sm_90a).
//
// Replaces the TPU kernel edl_tpu/ops/opt_kernels.py::_adam_fp32_kernel
// (called from _adam_fp32_pallas through pl.pallas_call). Same contract:
// p, g, m, v are one flat fp32 bucket, padded to a multiple of 128
// elements (the zero padding is a fixed point of the update); p, m and v
// are rewritten in place. Per element, in _adam_math's expression order:
//   v  = max(v, 0)
//   m' = (1 - b1) g + b1 m
//   v' = (1 - b2) (g g) + b2 v
//   u  = (m' / c1) / (sqrt(v' / c2) + eps)   [+ wd p]
//   p' = p + u (-lr)
// lr, c1 = 1 - b1^t and c2 = 1 - b2^t come by value from the host, so a
// step needs no device-to-host read.
//
// Design. The TPU kernel ran the bucket through VMEM in one pass. Here a
// grid-stride loop reads p, g, m, v as float4 (buckets are 128-aligned)
// and writes p, m, v back, once each. Every operation is an IEEE
// intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn), which nvcc
// never contracts, and the file is built with -fmad=false besides: the
// kernel then matches the unfused PyTorch sequence of _adam_math bit for
// bit.
//
// Bound on an H100 SXM: 28 bytes an element (p, g, m, v read; p, m, v
// written) and 12 flops; memory bound at 3.35 TB/s. At the base LM
// config's 168.9M parameters that is 4.73 GB, about 1.41 ms a step,
// spread over the buckets of the plan.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 8;   // 8 resident blocks on each of 132 SMs

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

__global__ void __launch_bounds__(THREADS)
adam_fp32_kernel(float4* __restrict__ p, const float4* __restrict__ g,
                 float4* __restrict__ m, float4* __restrict__ v, long long n4,
                 Hyper hp) {
  for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x; i < n4;
       i += (long long)gridDim.x * THREADS) {
    float4 pp = p[i], mm = m[i], vv = v[i];
    const float4 gg = g[i];
    adam_one(pp.x, gg.x, mm.x, vv.x, hp);
    adam_one(pp.y, gg.y, mm.y, vv.y, hp);
    adam_one(pp.z, gg.z, mm.z, vv.z, hp);
    adam_one(pp.w, gg.w, mm.w, vv.w, hp);
    p[i] = pp;
    m[i] = mm;
    v[i] = vv;
  }
}

}  // namespace

extern "C" {

// n: elements, a multiple of 4 (buckets are padded to 128); every pointer
// 16-byte aligned. omb1 = 1 - b1 and omb2 = 1 - b2 as the host rounds
// them to fp32. Returns a cudaError_t (0 = launched).
int edl_adam_fp32(void* p, const void* g, void* m, void* v, long long n,
                  float lr, float c1, float c2, float b1, float omb1, float b2,
                  float omb2, float eps, float wd, int use_wd, void* stream) {
  if (n % 4 != 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n4 = n / 4;
  long long blocks = (n4 + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  const Hyper hp{lr, c1, c2, b1, omb1, b2, omb2, eps, wd, use_wd};
  adam_fp32_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<float4*>(p), static_cast<const float4*>(g),
      static_cast<float4*>(m), static_cast<float4*>(v), n4, hp);
  return static_cast<int>(cudaGetLastError());
}

const char* edl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Fused Adam(W) over flat fp32 buckets for Hopper (sm_90a): K5.
//
// Replaces the TPU kernel edl_tpu/ops/opt_kernels.py::_adam_fp32_kernel
// (called from _adam_fp32_pallas through pl.pallas_call, once per
// bucket). Same contract: p, g, m, v are one flat fp32 bucket each,
// padded to a multiple of 128 elements (the zero padding is a fixed point
// of the update); p, m and v are rewritten in place. Per element, in
// _adam_math's expression order:
//   v  = max(v, 0)
//   m' = (1 - b1) g + b1 m
//   v' = (1 - b2) (g g) + b2 v
//   u  = (m' / c1) / (sqrt(v' / c2) + eps)   [+ wd p]
//   p' = p + u (-lr)
// lr, c1 = 1 - b1^t and c2 = 1 - b2^t come by value from the host, so a
// step needs no device-to-host read.
//
// Design. One launch covers every bucket of a step (up to MAX_BUCKETS):
// a table of each bucket's p, g, m, v and float4 count (table.cuh), one
// grid over all the chunks, each thread updating one float4 of a chunk
// (buckets are 128-aligned), reading p, g, m, v and writing p, m, v once
// each. One bucket is the one-entry table. Launching once per bucket
// paid each launch's ramp and tail (the base LM has 60 buckets), and a
// grid of 8 blocks a SM left a second wave: this body needs more than 32
// registers a thread, so fewer blocks fit; the grid is now what the card
// holds at once. Every operation is an IEEE intrinsic (__fmul_rn,
// __fadd_rn, __fdiv_rn, __fsqrt_rn), which nvcc never contracts, and the
// file is built with -fmad=false besides: the kernel then matches the
// unfused PyTorch sequence of _adam_math bit for bit.
//
// Bound on an H100 SXM: 28 bytes an element (p, g, m, v read; p, m, v
// written) and 12 flops; memory bound at 3.35 TB/s. At the base LM
// config's 168.9M parameters that is 4.73 GB, about 1.41 ms a step.

#include <cuda_runtime.h>

#include "table.cuh"

namespace {

using edl::THREADS;
// Buckets a launch takes: the table stays within 4 KB of parameters.
constexpr int MAX_BUCKETS = 90;

struct Hyper {
  float lr, c1, c2, b1, omb1, b2, omb2, eps, wd;
  int use_wd;
};

struct Bucket {
  float4* p;
  const float4* g;
  float4* m;
  float4* v;
  long long n4;         // float4s
};

using Table = edl::Table<Bucket, MAX_BUCKETS>;

static_assert(sizeof(Table) + sizeof(Hyper) <= 4096,
              "K5's table must fit 4 KB of kernel parameters");

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
adam_fp32_kernel(const __grid_constant__ Table tab, Hyper hp) {
  const int chunks = tab.cend[tab.n - 1];
  int b = 0;
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    b = edl::bucket_of(tab.cend, b, c);
    const Bucket& bk = tab.b[b];
    const long long i =
        (long long)(c - (b ? tab.cend[b - 1] : 0)) * THREADS + threadIdx.x;
    if (i < bk.n4) {
      float4 pp = bk.p[i], mm = bk.m[i], vv = bk.v[i];
      const float4 gg = bk.g[i];
      adam_one(pp.x, gg.x, mm.x, vv.x, hp);
      adam_one(pp.y, gg.y, mm.y, vv.y, hp);
      adam_one(pp.z, gg.z, mm.z, vv.z, hp);
      adam_one(pp.w, gg.w, mm.w, vv.w, hp);
      bk.p[i] = pp;
      bk.m[i] = mm;
      bk.v[i] = vv;
    }
  }
}

}  // namespace

extern "C" {

// K5 over `count` buckets (1..90) in one launch. ptrs: p, g, m, v of
// each bucket in turn (4 a bucket, each 16-byte aligned); n[i]: bucket
// i's elements, a multiple of 4. omb1 = 1 - b1 and omb2 = 1 - b2 as the
// host rounds them to fp32. Returns a cudaError_t (0 = launched).
int edl_adam_fp32_buckets(void* const* ptrs, const long long* n, int count,
                          float lr, float c1, float c2, float b1, float omb1,
                          float b2, float omb2, float eps, float wd,
                          int use_wd, void* stream) {
  Table tab;
  const bool ok = edl::fill_table(
      &tab, count, THREADS, nullptr, [&](int i, Bucket* row) -> long long {
        if (n[i] % 4 != 0) return 0;
        void* const* q = ptrs + 4 * i;
        *row = {static_cast<float4*>(q[0]), static_cast<const float4*>(q[1]),
                static_cast<float4*>(q[2]), static_cast<float4*>(q[3]),
                n[i] / 4};
        return row->n4;
      });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const Hyper hp{lr, c1, c2, b1, omb1, b2, omb2, eps, wd, use_wd};
  return static_cast<int>(edl::launch_resident<&adam_fp32_kernel>(
      static_cast<cudaStream_t>(stream), tab, hp));
}

const char* edl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

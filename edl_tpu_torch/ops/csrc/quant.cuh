// Shared pieces of the quantized-moment optimizer kernels (K6 in sgdm.cu,
// K7 in adam_q.cu) for Hopper (sm_90a): the QPlane codec of
// edl_tpu/ops/opt_kernels.py (_dq2 / _rq2) and a block-wide abs-max that
// folds into one device word; K8 (pack.cu) takes the int8 codec and the
// abs-max too.
//
// A moment plane at rest is (q, scale, rq, rscale): q = quant(m, scale),
// rq = quant(m - deq(q, scale), rscale), each scale the bucket's abs-max
// over 127 (int8) or 448 (fp8 e4m3), 1.0 for an all-zero bucket. On the
// TPU one Pallas program held the whole bucket, so both abs-max
// reductions were free. Here they cross blocks, and rscale depends on
// scale, so K6 and K7 take three passes over a table of buckets, each
// recomputing the new moment: fold max|m'|, then max|r| under the new
// scale, then write (sgdm.cu, adam_q.cu). The scales stay on the card:
// no pass reads anything back to the host. The abs-max folds the bits of
// |x| with atomicMax: non-negative floats order like their bits, and a
// max is exact, so the result does not depend on block order.
//
// Rounding matches the plain PyTorch version bit for bit (the sources are
// built with -fmad=false -prec-div=true): x / scale and amax / 127 are IEEE
// divisions; int8 rounds half to even and clips to +-127; fp8 is e4m3 with
// round to nearest even and saturation to +-448.

#pragma once

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "table.cuh"   // THREADS

namespace edl {

__device__ __forceinline__ float dequant(int8_t q, float scale, int fp8) {
  float x;
  if (fp8) {
    const __half_raw h = __nv_cvt_fp8_to_halfraw(
        static_cast<__nv_fp8_storage_t>(static_cast<uint8_t>(q)), __NV_E4M3);
    x = __half2float(__half(h));
  } else {
    x = static_cast<float>(q);
  }
  return __fmul_rn(x, scale);
}

__device__ __forceinline__ int8_t quant(float x, float scale, int fp8) {
  const float t = __fdiv_rn(x, scale);
  if (fp8) {
    return static_cast<int8_t>(
        __nv_cvt_float_to_fp8(t, __NV_SATFINITE, __NV_E4M3));
  }
  return static_cast<int8_t>(
      static_cast<int>(fminf(fmaxf(rintf(t), -127.f), 127.f)));
}

// The codec's scale from the bits of the bucket's abs-max.
__device__ __forceinline__ float scale_of(unsigned amax_bits, int fp8) {
  const float amax = __uint_as_float(amax_bits);
  return amax > 0.f ? __fdiv_rn(amax, fp8 ? 448.f : 127.f) : 1.f;
}

__device__ __forceinline__ unsigned abs_bits(float x) {
  return __float_as_uint(fabsf(x));
}

// Fold this thread's bits into *word: a warp max, a block max, then one
// atomicMax per block. Every thread of the block must call it.
__device__ __forceinline__ void block_amax(unsigned bits, unsigned* word) {
  __shared__ unsigned warp_bits[THREADS / 32];
  __syncthreads();   // a previous call's readers are done with warp_bits
  for (int o = 16; o > 0; o >>= 1) {
    bits = max(bits, __shfl_xor_sync(0xffffffffu, bits, o));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_bits[warp] = bits;
  __syncthreads();
  if (warp == 0) {
    bits = lane < THREADS / 32 ? warp_bits[lane] : 0u;
    for (int o = 16; o > 0; o >>= 1) {
      bits = max(bits, __shfl_xor_sync(0xffffffffu, bits, o));
    }
    if (lane == 0 && bits != 0u) atomicMax(word, bits);
  }
}

// q = quant(m, scale) and the residual m - deq(q, scale).
__device__ __forceinline__ float residual(float m, float scale, int fp8,
                                          int8_t* q) {
  *q = quant(m, scale, fp8);
  return __fsub_rn(m, dequant(*q, scale, fp8));
}

}  // namespace edl

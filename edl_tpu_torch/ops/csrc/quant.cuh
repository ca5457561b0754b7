// Shared pieces of the quantized-moment optimizer kernels (K6 in sgdm.cu,
// K7 in adam_q.cu) for Hopper (sm_90a): the QPlane codec of
// edl_tpu/ops/opt_kernels.py (_dq2 / _rq2) and a block-wide abs-max that
// folds into one device word, used by both; and K6's two requantization
// passes (K7 recomputes its moments in each pass instead, adam_q.cu).
//
// A moment plane at rest is (q, scale, rq, rscale): q = quant(m, scale),
// rq = quant(m - deq(q, scale), rscale), each scale the bucket's abs-max
// over 127 (int8) or 448 (fp8 e4m3), 1.0 for an all-zero bucket. On the
// TPU one Pallas program held the whole bucket, so both abs-max
// reductions were free. Here they cross blocks, and rscale depends on
// scale, so K6 takes three passes a bucket on one stream:
//   1. the update (sgdm.cu): dequantize, update, write p, stage m' in an
//      fp32 workspace, fold max|m'| into amax[0];
//   2. requant_kernel<..., false>: scale from amax[0], write q and the
//      scale, fold max|r| into amax[1], r = m' - deq(q, scale);
//   3. requant_kernel<..., true>: scale and rscale from the words,
//      recompute q and r, write rq and rscale.
// The scales stay on the card: no pass reads anything back to the host.
// The abs-max folds the bits of |x| with atomicMax: non-negative floats
// order like their bits, and a max is exact, so the result does not
// depend on block order.
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

namespace edl {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 8;   // 8 resident blocks on each of 132 SMs

inline unsigned grid_for(long long n4) {
  long long blocks = (n4 + THREADS - 1) / THREADS;
  return static_cast<unsigned>(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS);
}

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

// One plane of a requantization pass.
struct Plane {
  const float4* work;      // m', staged by the update pass
  char4* out;              // q (pass 2) or rq (pass 3), rewritten in place
  float* scale_out;        // scale (pass 2) or rscale (pass 3)
  const unsigned* amax;    // bits of max|m'|
  unsigned* ramax;         // bits of max|r|: folded in pass 2, read in 3
  int fp8;
};

__device__ __forceinline__ float residual(float m, float scale, int fp8,
                                          int8_t* q) {
  *q = quant(m, scale, fp8);
  return __fsub_rn(m, dequant(*q, scale, fp8));
}

template <bool RESID>
__device__ __forceinline__ void requant4(const Plane& pl, long long i,
                                         float scale, float rscale,
                                         unsigned& bits) {
  const float4 m = pl.work[i];
  const float ms[4] = {m.x, m.y, m.z, m.w};
  int8_t o[4];
  for (int k = 0; k < 4; ++k) {
    int8_t q;
    const float r = residual(ms[k], scale, pl.fp8, &q);
    if (RESID) {
      o[k] = quant(r, rscale, pl.fp8);
    } else {
      o[k] = q;
      bits = max(bits, abs_bits(r));
    }
  }
  pl.out[i] = make_char4(o[0], o[1], o[2], o[3]);
}

// The NP planes (1 or 2) of one pass, passed to its kernel by value.
template <int NP>
struct Planes {
  Plane p[NP];
};

// Pass 2 (RESID = false) or 3 (RESID = true) over NP planes.
template <int NP, bool RESID>
__global__ void __launch_bounds__(THREADS)
requant_kernel(Planes<NP> planes, long long n4) {
  float scale[NP], rscale[NP];
  unsigned bits[NP];
  for (int k = 0; k < NP; ++k) {
    const Plane& pl = planes.p[k];
    scale[k] = scale_of(*pl.amax, pl.fp8);
    rscale[k] = RESID ? scale_of(*pl.ramax, pl.fp8) : 0.f;
    bits[k] = 0u;
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      *pl.scale_out = RESID ? rscale[k] : scale[k];
    }
  }
  for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x; i < n4;
       i += (long long)gridDim.x * THREADS) {
    for (int k = 0; k < NP; ++k) {
      requant4<RESID>(planes.p[k], i, scale[k], rscale[k], bits[k]);
    }
  }
  if (!RESID) {
    for (int k = 0; k < NP; ++k) block_amax(bits[k], planes.p[k].ramax);
  }
}

// Passes 2 and 3 of one bucket, after its update pass, on `stream`:
// pass2[k] writes plane k's q and scale, pass3[k] its rq and rscale.
template <int NP>
inline int requant(const Plane (&pass2)[NP], const Plane (&pass3)[NP],
                   long long n4, cudaStream_t stream) {
  Planes<NP> q, r;
  for (int k = 0; k < NP; ++k) {
    q.p[k] = pass2[k];
    r.p[k] = pass3[k];
  }
  const unsigned grid = grid_for(n4);
  requant_kernel<NP, false><<<grid, THREADS, 0, stream>>>(q, n4);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  requant_kernel<NP, true><<<grid, THREADS, 0, stream>>>(r, n4);
  return static_cast<int>(cudaGetLastError());
}

// The plane of pass 3 from the plane of pass 2: rq and rscale are
// written in place of q and scale.
inline Plane resid_plane(Plane pl, void* rq, void* rscale) {
  pl.out = static_cast<char4*>(rq);
  pl.scale_out = static_cast<float*>(rscale);
  return pl;
}

}  // namespace edl

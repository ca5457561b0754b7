// The int8 gradient pack for Hopper (sm_90a): K8.
//
// K8 replaces edl_tpu/ops/pack.py::_pack_kernel (called from _pack_pallas
// through pl.pallas_call): a flat fp32 shard becomes an int8 payload of the
// same length and one fp32 scale,
//   scale = max|x| / 127   (1.0 for an all-zero shard)
//   q     = clip(round_half_even(x / scale), -127, 127).
// On the TPU one Pallas program held the whole shard in VMEM, so the
// abs-max and the quantized store shared one read of HBM. Here the max
// crosses blocks, so the shard takes two passes on one stream:
//   1. amax_kernel folds the bits of |x| into one device word with
//      atomicMax (quant.cuh's block_amax: non-negative floats order like
//      their bits and a max is exact, so the word does not depend on block
//      order);
//   2. pack_kernel derives the scale from the word with a true division,
//      block 0 writes it once, and every element is quantized with a true
//      division, rintf and a clip (quant.cuh's quant).
// The scale stays on the card; nothing is read back to the host.
//
// Bound on an H100 SXM: 5 bytes an element (x read, q written), memory
// bound at 3.35 TB/s. This design reads x twice: 9 bytes. Any length is
// taken (no 128-lane pad: that was a TPU need), element by element.
//
// Built with -fmad=false -prec-div=true -ftz=false: the kernel matches the
// plain PyTorch version (ops/pack.py) bit for bit, subnormals included.

#include "quant.cuh"

namespace {

using edl::THREADS;

__global__ void __launch_bounds__(THREADS)
amax_kernel(const float* __restrict__ x, long long n, unsigned* amax) {
  unsigned bits = 0u;
  for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS) {
    bits = max(bits, edl::abs_bits(x[i]));
  }
  edl::block_amax(bits, amax);
}

__global__ void __launch_bounds__(THREADS)
pack_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
            float* scale_out, const unsigned* amax, long long n) {
  const float scale = edl::scale_of(*amax, 0);
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale_out = scale;
  for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS) {
    q[i] = edl::quant(x[i], scale, 0);
  }
}

}  // namespace

extern "C" {

// K8 over one shard of n > 0 fp32 elements: q gets n int8, scale one fp32;
// amax is one word of scratch, zeroed here. Returns a cudaError_t
// (0 = launched).
int edl_pack_int8(const void* x, void* q, void* scale, void* amax,
                  long long n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned* word = static_cast<unsigned*>(amax);
  cudaError_t err = cudaMemsetAsync(word, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = edl::grid_for(n);
  amax_kernel<<<grid, THREADS, 0, st>>>(static_cast<const float*>(x), n,
                                        word);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pack_kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(scale), word, n);
  return static_cast<int>(cudaGetLastError());
}

const char* edl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

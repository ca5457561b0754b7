// Hopper (sm_90a) building blocks in inline PTX for the port's hand-written
// kernels: mbarriers, TMA tile loads and their tensor maps, shared-memory
// matrix descriptors, and the warpgroup products (wgmma) with their fence,
// commit and wait. Nothing here allocates or launches; csrc/*.cu compose
// these pieces. Every library's build digest covers this header.
//
// - mbarrier: a 64-bit barrier in shared memory counting arrivals and the
//   bytes of asynchronous copies in flight ("transactions"). A phase
//   completes when both reach zero; a waiter names the parity of the phase
//   it waits past, so a ring of STAGES buffers flips its parity each lap.
// - TMA: one thread asks the Tensor Memory Accelerator for a box of a
//   tensor, described by a CUtensorMap built on the host; the box lands in
//   shared memory swizzled as the map says, elements past the tensor's
//   bounds read as zero, and the barrier is credited with the bytes.
//   Scattered words (a strided row of scalars) go by cp.async instead,
//   each thread's copies completing as one arrival on the barrier.
// - setmaxnreg: a warpgroup that only issues copies hands registers to
//   the warpgroups that compute.
// - wgmma: a warpgroup (four consecutive warps, 128 threads) issues an
//   asynchronous 64 x N x 16 product of bf16 or fp16 operands (Elem) with
//   fp32 accumulators in registers.
//   B comes from shared memory through a descriptor, A from shared memory
//   (wgmma_ss) or from registers (wgmma_rs). The accumulator of an
//   m64nN product is, per warp w, rows 16w + lane/4 (+8) and columns
//   8i + 2(lane%4) (+1): register 4i + {0,1} on the upper row, 4i + {2,3}
//   on the lower. That is also the layout of the A register operand of
//   the next product (a k16 step takes the accumulators of column chunks
//   2kk and 2kk+1), so a score tile feeds the next product in registers.

#pragma once

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cudaTypedefs.h>    // PFN_cuTensorMapEncodeTiled
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// The 16-bit element types the wgmma bodies take: bf16 and fp16 are read
// by the tensor cores at the same rate and laid out alike (2 bytes, the
// same swizzles and descriptors); they differ in the tensor map's data
// type, the PTX type of the products and the conversion from fp32.
template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static constexpr bool F16 = false;
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // two fp32 values rounded to nearest, lo in the low half
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  // two packed values as fp32, the low half first
  static __device__ __forceinline__ float2 unpack(uint32_t w) {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
  }
};

template <>
struct Elem<__half> {
  static constexpr bool F16 = true;
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  // two fp32 values rounded to nearest (past 65504: inf), lo in the low half
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t w) {
    return __half22float2(*reinterpret_cast<__half2*>(&w));
  }
};

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, reached through the runtime's entry-point query
// (cudaGetDriverEntryPoint) so that no library links libcuda; null where
// it is not offered.
inline PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// A map over a 16-bit (B, S, H, D) view of data type `type` (Elem::MAP)
// with the given (batch, seq, head) strides in elements (the head dim
// contiguous), read in boxes of box_rows sequence rows x box_cols
// head-dim columns of one (batch, head).
// Its dims, innermost first, are (D, H, S, B): a box's coordinates are
// (column, head, row, batch). box_cols x 2 bytes is the swizzle span:
// 128 (64 columns) or 64 (32 columns), the layouts desc_k/desc_mn read.
// Rows past S read as zero. Returns the CUresult of the encoding.
inline int encode_bshd(CUtensorMap* map, CUtensorMapDataType type,
                       const void* ptr, int B, int S, int H, int D,
                       long long sb, long long ss, long long sh, int box_rows,
                       int box_cols) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(H), cuuint64_t(S),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(sh) * 2, cuuint64_t(ss) * 2,
                                 cuuint64_t(sb) * 2};   // bytes, dims 1..3
  const cuuint32_t box[4] = {cuuint32_t(box_cols), 1, cuuint32_t(box_rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return static_cast<int>(encode(
      map, type, 4, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

// ---------------------------------------------------------------------------
// device: mbarriers and TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread initializes each barrier to expect `count` arrivals a phase,
// then fence_barrier_init() and a __syncthreads() publish them.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival, releasing this thread's earlier writes to the waiters.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// One arrival that also tells the phase to wait for `bytes` of copies.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Spin until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n"
      :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// Copy 4 bytes from global memory to shared memory asynchronously; with
// `valid` false, write zeros and read nothing (src need not be valid).
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// One arrival on `bar` once this thread's earlier cp_async_4 copies have
// landed. It counts against the barrier's expected arrivals (.noinc).
__device__ __forceinline__ void mbar_arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// TMA: the box of `map` at coordinates (c0, c1, c2, c3), innermost first,
// into shared memory at dst (aligned to the swizzle's repeat: 1024 bytes
// for 128-byte rows); its bytes complete a transaction on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Warp specialization: a warpgroup that only issues copies gives back
// registers (dec) for the warpgroups that compute (inc). All four warps of
// the warpgroup execute it together, on paths that never rejoin.
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

// ---------------------------------------------------------------------------
// device: wgmma
// ---------------------------------------------------------------------------

// The descriptor of a 16-bit operand in shared memory, as TMA left it: rows
// of ROW_BYTES (128: a 128-byte swizzle, 64: a 64-byte one), each group of
// 8 rows one swizzle atom of 8 x ROW_BYTES bytes. Bits: start address
// >> 4 at 0, leading offset >> 4 at 16, stride offset >> 4 at 32, the
// layout at 62 (1 = 128-byte swizzle, 2 = 64-byte).
template <int ROW_BYTES>
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lead_bytes,
                                         uint32_t stride_bytes) {
  static_assert(ROW_BYTES == 128 || ROW_BYTES == 64, "swizzle span");
  constexpr uint64_t layout = ROW_BYTES == 128 ? 1 : 2;
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4)
         | uint64_t(lead_bytes >> 4) << 16
         | uint64_t(stride_bytes >> 4) << 32 | layout << 62;
}

// K-major: the product's k runs along a row (A = rows x k, or B = n x k
// with k contiguous). p points at the first row's k-step: row base plus
// 32 bytes a k16 step within the swizzle span; the next 8 rows are one
// atom on. The leading offset is unused.
template <int ROW_BYTES>
__device__ __forceinline__ uint64_t desc_k(const void* p) {
  return desc<ROW_BYTES>(p, 16, 8 * ROW_BYTES);
}

// MN-major B (k x n, n contiguous): a row holds ROW_BYTES / 2 n-columns of
// one k. p points at the k-step's first row; its 16 rows are two atoms,
// one stride apart; n-columns past one row's span are in the next
// column block, `block_bytes` on (a D = 128 tile kept as two 64-column
// halves).
template <int ROW_BYTES>
__device__ __forceinline__ uint64_t desc_mn(const void* p,
                                            uint32_t block_bytes) {
  return desc<ROW_BYTES>(p, block_bytes, 8 * ROW_BYTES);
}

// Order register and shared-memory accesses before the next wgmma reads
// its operands (accumulators and A fragments written by other code).
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// Close the wgmmas issued since the last commit into one group.
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of accumulators across a
// wgmma issue or wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// The wgmma forms below, one asm statement each, for the element type
// string TY ("bf16" or "f16") of A and B; the operand lists are the
// accumulator's registers d[0..N/2), then the descriptors or A registers.
#define HOPPER_ACC16                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define HOPPER_ACC32                                                        \
  HOPPER_ACC16, "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),         \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),      \
      "+f"(d[30]), "+f"(d[31])
#define HOPPER_ACC64                                                        \
  HOPPER_ACC32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),         \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),      \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),      \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),      \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),      \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),      \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define HOPPER_REGS16                                                       \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define HOPPER_REGS32                                                       \
  HOPPER_REGS16 ", %16, %17, %18, %19, %20, %21, %22, %23, "                \
                "%24, %25, %26, %27, %28, %29, %30, %31"
#define HOPPER_REGS64                                                       \
  HOPPER_REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, "                \
                "%40, %41, %42, %43, %44, %45, %46, %47, "                  \
                "%48, %49, %50, %51, %52, %53, %54, %55, "                  \
                "%56, %57, %58, %59, %60, %61, %62, %63"
// both operands from shared memory: descriptors %R, %R+1, accumulate %R+2
#define HOPPER_WGMMA_SS(N, TY, REGS, ACC, R, R1, R2)                        \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" R2 ", 0;\n"             \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY  \
               " {" REGS "}, %" R ", %" R1 ", p, 1, 1, 0, 0;\n}\n"          \
               : ACC                                                        \
               : "l"(a), "l"(b), "r"(accumulate))
// A from registers %R..%R+3, B's descriptor %R+4, accumulate %R+5
#define HOPPER_WGMMA_RS(N, TY, REGS, ACC, R, R1, R2, R3, R4, R5)            \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" R5 ", 0;\n"             \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY  \
               " {" REGS "}, {%" R ", %" R1 ", %" R2 ", %" R3 "}, %" R4     \
               ", p, 1, 1, 1;\n}\n"                                         \
               : ACC                                                        \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),        \
                 "r"(accumulate))

// d (64 x N fp32) = a * b (+ d if accumulate): A (64 x 16) and B (N x 16)
// of element type T (Elem), both K-major in shared memory.
template <int N, typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int accumulate) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma width");
  if constexpr (N == 32) {
    if constexpr (Elem<T>::F16)
      HOPPER_WGMMA_SS(32, "f16", HOPPER_REGS16, HOPPER_ACC16, "16", "17", "18");
    else
      HOPPER_WGMMA_SS(32, "bf16", HOPPER_REGS16, HOPPER_ACC16, "16", "17", "18");
  } else if constexpr (N == 64) {
    if constexpr (Elem<T>::F16)
      HOPPER_WGMMA_SS(64, "f16", HOPPER_REGS32, HOPPER_ACC32, "32", "33", "34");
    else
      HOPPER_WGMMA_SS(64, "bf16", HOPPER_REGS32, HOPPER_ACC32, "32", "33", "34");
  } else {
    if constexpr (Elem<T>::F16)
      HOPPER_WGMMA_SS(128, "f16", HOPPER_REGS64, HOPPER_ACC64, "64", "65", "66");
    else
      HOPPER_WGMMA_SS(128, "bf16", HOPPER_REGS64, HOPPER_ACC64, "64", "65", "66");
  }
}

// d (64 x N fp32) = a * b (+ d if accumulate): A (64 x 16) of element type
// T from registers in the accumulator layout (Elem<T>::pack of two fp32
// values a register), B (16 x N) MN-major in shared memory. The A
// registers must keep their values until the wait that covers the
// product. ptxas has been seen to give a register to another value while
// a wgmma in flight would still read it (an A operand loaded once before
// a loop, overwritten inside it); chip_smoke.py's build phase reads the
// SASS for such writes.
template <int N, typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma width");
  if constexpr (N == 32) {
    if constexpr (Elem<T>::F16)
      HOPPER_WGMMA_RS(32, "f16", HOPPER_REGS16, HOPPER_ACC16, "16", "17", "18",
                      "19", "20", "21");
    else
      HOPPER_WGMMA_RS(32, "bf16", HOPPER_REGS16, HOPPER_ACC16, "16", "17",
                      "18", "19", "20", "21");
  } else if constexpr (N == 64) {
    if constexpr (Elem<T>::F16)
      HOPPER_WGMMA_RS(64, "f16", HOPPER_REGS32, HOPPER_ACC32, "32", "33", "34",
                      "35", "36", "37");
    else
      HOPPER_WGMMA_RS(64, "bf16", HOPPER_REGS32, HOPPER_ACC32, "32", "33",
                      "34", "35", "36", "37");
  } else {
    if constexpr (Elem<T>::F16)
      HOPPER_WGMMA_RS(128, "f16", HOPPER_REGS64, HOPPER_ACC64, "64", "65",
                      "66", "67", "68", "69");
    else
      HOPPER_WGMMA_RS(128, "bf16", HOPPER_REGS64, HOPPER_ACC64, "64", "65",
                      "66", "67", "68", "69");
  }
}

#undef HOPPER_WGMMA_RS
#undef HOPPER_WGMMA_SS
#undef HOPPER_REGS64
#undef HOPPER_REGS32
#undef HOPPER_REGS16
#undef HOPPER_ACC64
#undef HOPPER_ACC32
#undef HOPPER_ACC16

}  // namespace hopper

// Flash-attention forward for Hopper (sm_90a), causal or full.
//
// Replaces the TPU kernel edl_tpu/ops/flash_attention.py::_fwd_kernel
// (called from _fwd through pl.pallas_call). Same contract: q, k, v are
// (B, S, H, D) in fp32 or bf16; o is written in the input dtype, and the
// log-sum-exp lse = m + log(max(l, 1e-30)) in fp32, laid out (B, S, H).
//
// Design. The TPU program kept a whole (S, D) K/V block resident in VMEM
// and walked KV blocks in a sequential grid. Here one thread block owns
// one (batch*head, 64-row q tile); a loop inside the block streams 64-row
// K/V tiles through shared memory, carrying the running max m, the
// denominator l and the (64, D) accumulator in fp32 registers, so no
// score tile ever reaches device memory. Under the causal mask the loop
// stops at the tile holding the q tile's last row, and only that diagonal
// tile is masked. The kernel reads q, k, v in place from their
// (B, S, H, D) strides (no transposed copies) and writes o contiguous.
// The q tiles of a head are scheduled heaviest first (causal work grows
// with the tile index).
//
// Two bodies share that plan:
// - bf16 inputs run on the tensor cores (flash_fwd_mma_kernel): 4 warps,
//   each owning 16 q rows; S = Q K^T and O += P V are mma.sync m16n8k16
//   bf16 products with fp32 accumulation, fragments loaded with ldmatrix
//   from padded shared-memory tiles. P is rounded to bf16 for the second
//   product (its row sum l stays fp32), as in FlashAttention-2.
// - fp32 inputs run on the CUDA cores in fp32 FMA (flash_fwd_kernel), to
//   stay within 2e-5 of the fp32 reference: 256 threads as a 16x16 grid,
//   each owning 4 q rows x 4 kv columns of the score tile and the same
//   4 rows x D/16 output columns; row max and sum reduce across the 16
//   threads of a row with warp shuffles.
// Tile loads are synchronous; cp.async/TMA pipelining and wgmma are the
// next steps.
//
// Bound on an H100 SXM at the serving path's shape (B=8, S=1024, H=16,
// D=64, causal, bf16): 2 matmuls x 2 flops x B*H*D*S(S+1)/2 = 17.2 GFLOP,
// 17 us at 989 TFLOP/s (bf16 tensor cores); q, k, v, o = 67 MB, 20 us at
// 3.35 TB/s. Memory sets the bound, about 20 us a launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // q rows per block
constexpr int BK = 64;          // kv rows per tile
constexpr int THREADS = 256;    // 16 x 16
constexpr int KPAD = BK + 4;    // row stride of the transposed K and P tiles
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

constexpr size_t smem_floats(int d) {
  return size_t(d) * BQ + size_t(d) * KPAD + size_t(BK) * d + size_t(BK) * KPAD;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int S, int H,
                 long long qsb, long long qss, long long qsh,
                 long long ksb, long long kss, long long ksh,
                 long long vsb, long long vss, long long vsh,
                 float scale, int causal) {
  constexpr int NPT = D / 16;   // output columns per thread
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [D][BQ]    q tile^T, scaled
  float* Kt = Qt + D * BQ;                      // [D][KPAD]  k tile^T
  float* Vs = Kt + D * KPAD;                    // [BK][D]    v tile
  float* Pt = Vs + BK * D;                      // [BK][KPAD] p tile^T

  const int tid = threadIdx.x;
  const int tx = tid & 15;      // kv columns tx*4.., output columns tx*NPT..
  const int ty = tid >> 4;      // q rows ty*4..
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = qt * BQ;

  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + h * ksh;
  const float* vb = v + b * vsb + h * vsh;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int s = q0 + r;
    Qt[d * BQ + r] = s < S ? qb[s * qss + d] * scale : 0.f;
  }

  float acc[4][NPT];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NPT; ++n) acc[i][n] = 0.f;
  }

  const int kv_end = causal ? min(S, q0 + BQ) : S;
  const int n_kt = (kv_end + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int c = i / D, d = i % D;
      const int s = k0 + c;
      const bool ok = s < S;
      Kt[d * KPAD + c] = ok ? kb[s * kss + d] : 0.f;
      Vs[c * D + d] = ok ? vb[s * vss + d] : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qt[d * BQ + ty * 4]);
      const float4 ka = *reinterpret_cast<const float4*>(&Kt[d * KPAD + tx * 4]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        if (col >= S || (causal && col > row)) sc[i][j] = NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = expf(sc[i][j] - m_new);
        rs += sc[i][j];
      }
      l[i] = l[i] * corr + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < NPT; ++n) acc[i][n] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Pt[(tx * 4 + j) * KPAD + ty * 4]) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
    __syncthreads();

    // columns past kv_end hold p == 0: skip them
    const int c_end = min(BK, kv_end - k0);
    for (int c = 0; c < c_end; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(&Pt[c * KPAD + ty * 4]);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
      float vv[NPT];
      const float* vr = &Vs[c * D + tx * NPT];
      if constexpr (NPT % 4 == 0) {
#pragma unroll
        for (int n = 0; n < NPT; n += 4) {
          const float4 t = *reinterpret_cast<const float4*>(vr + n);
          vv[n] = t.x; vv[n + 1] = t.y; vv[n + 2] = t.z; vv[n + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int n = 0; n < NPT; n += 2) {
          const float2 t = *reinterpret_cast<const float2*>(vr + n);
          vv[n] = t.x; vv[n + 1] = t.y;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < NPT; ++n) acc[i][n] = fmaf(pv[i], vv[n], acc[i][n]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float li = fmaxf(l[i], 1e-30f);
    const long long orow = ((long long)b * S + row) * H + h;
    float* op = o + orow * D + tx * NPT;
#pragma unroll
    for (int n = 0; n < NPT; ++n) op[n] = acc[i][n] / li;
    if (tx == 0) lse[orow] = m[i] + logf(li);
  }
}

template <int D>
int launch_fma(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int S, int H, const long long* st,
               float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_floats(D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse),
      S, H, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 4;                 // 16 q rows each
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_PAD = 8;                   // keeps ldmatrix rows conflict-free

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a * b, a 16x16 (row), b 16x8 (col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

constexpr size_t tc_smem_bytes(int d) {
  return size_t(BQ + 2 * BK) * (d + TC_PAD) * sizeof(__nv_bfloat16);
}

// Copy `rows` rows of D bf16 (row r at base + r * stride) into a padded
// shared tile, 16 bytes a thread; rows at or past `limit` read as zero.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* base,
                                          long long stride, int row0,
                                          int limit, int tid) {
  constexpr int VPR = D / 8;   // 16-byte vectors per row
  constexpr int LD = D + TC_PAD;
  for (int i = tid; i < 64 * VPR; i += TC_THREADS) {
    const int r = i / VPR, c8 = (i % VPR) * 8;
    const int s = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < limit) val = *reinterpret_cast<const uint4*>(base + s * stride + c8);
    *reinterpret_cast<uint4*>(dst + r * LD + c8) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int S, int H,
                     long long qsb, long long qss, long long qsh,
                     long long ksb, long long kss, long long ksh,
                     long long vsb, long long vss, long long vsh,
                     float scale, int causal) {
  constexpr int LD = D + TC_PAD;
  constexpr int KSTEPS = D / 16;     // k-steps of S = Q K^T
  constexpr int ONT = D / 8;         // n-tiles of O
  extern __shared__ uint4 tc_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(tc_smem);  // [BQ][LD]
  __nv_bfloat16* Ks = Qs + BQ * LD;                               // [BK][LD]
  __nv_bfloat16* Vs = Ks + BK * LD;                               // [BK][LD]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;      // mma fragment coordinates
  const int lm = lane >> 3, lr = lane & 7;     // ldmatrix: matrix, row
  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = qt * BQ;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;

  load_tile<D>(Qs, q + b * qsb + h * qsh, qss, q0, S, tid);
  __syncthreads();
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
    ldsm_x4(qf[kk], Qs + (warp * 16 + (lm & 1) * 8 + lr) * LD + kk * 16 +
                        (lm >> 1) * 8);

  float oacc[ONT][4];
#pragma unroll
  for (int nt = 0; nt < ONT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[nt][e] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  const int kv_end = causal ? min(S, q0 + BQ) : S;
  const int n_kt = (kv_end + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(Ks, k + b * ksb + h * ksh, kss, k0, S, tid);
    load_tile<D>(Vs, v + b * vsb + h * vsh, vss, k0, S, tid);
    __syncthreads();

    // S = Q K^T: 16 rows x 64 kv columns per warp, 8 n-tiles
    float sacc[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int nt = 0; nt < BK / 8; nt += 2) {
        uint32_t bf[4];
        ldsm_x4(bf, Ks + ((nt + (lm >> 1)) * 8 + lr) * LD + kk * 16 + (lm & 1) * 8);
        mma_bf16(sacc[nt], qf[kk], bf[0], bf[1]);
        mma_bf16(sacc[nt + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // scale, mask, online softmax for rows row0 (e = 0, 1) and row1 (e = 2, 3)
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row0 : row1;
        const int col = k0 + nt * 8 + 2 * tq + (e & 1);
        float x = sacc[nt][e] * scale;
        if (col >= S || (causal && col > row)) x = NEG_INF;
        sacc[nt][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(sacc[nt][0], sacc[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(sacc[nt][2], sacc[nt][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      sacc[nt][0] = expf(sacc[nt][0] - mn0);
      sacc[nt][1] = expf(sacc[nt][1] - mn0);
      sacc[nt][2] = expf(sacc[nt][2] - mn1);
      sacc[nt][3] = expf(sacc[nt][3] - mn1);
      rs0 += sacc[nt][0] + sacc[nt][1];
      rs1 += sacc[nt][2] + sacc[nt][3];
    }
    l0 = l0 * c0 + quad_sum(rs0);
    l1 = l1 * c1 + quad_sum(rs1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int nt = 0; nt < ONT; ++nt) {
      oacc[nt][0] *= c0;
      oacc[nt][1] *= c0;
      oacc[nt][2] *= c1;
      oacc[nt][3] *= c1;
    }

    // O += P V: the S accumulator of n-tiles 2kk, 2kk+1 is the A fragment
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]),
                              pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]),
                              pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]),
                              pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3])};
#pragma unroll
      for (int nt = 0; nt < ONT; nt += 2) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, Vs + (kk * 16 + (lm & 1) * 8 + lr) * LD + (nt + (lm >> 1)) * 8);
        mma_bf16(oacc[nt], pa, bf[0], bf[1]);
        mma_bf16(oacc[nt + 1], pa, bf[2], bf[3]);
      }
    }
  }

  const float li0 = fmaxf(l0, 1e-30f), li1 = fmaxf(l1, 1e-30f);
  if (row0 < S) {
    const long long orow = ((long long)b * S + row0) * H + h;
    uint32_t* op = reinterpret_cast<uint32_t*>(o + orow * D + 2 * tq);
#pragma unroll
    for (int nt = 0; nt < ONT; ++nt)
      op[nt * 4] = pack_bf16(oacc[nt][0] / li0, oacc[nt][1] / li0);
    if (tq == 0) lse[orow] = m0 + logf(li0);
  }
  if (row1 < S) {
    const long long orow = ((long long)b * S + row1) * H + h;
    uint32_t* op = reinterpret_cast<uint32_t*>(o + orow * D + 2 * tq);
#pragma unroll
    for (int nt = 0; nt < ONT; ++nt)
      op[nt * 4] = pack_bf16(oacc[nt][2] / li1, oacc[nt][3] / li1);
    if (tq == 0) lse[orow] = m1 + logf(li1);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, void* lse,
               int B, int S, int H, const long long* st, float scale,
               int causal, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_mma_kernel<D><<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), S, H, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], scale, causal);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_fma(const void* q, const void* k, const void* v, void* o, void* lse,
                 int B, int S, int H, int D, const long long* st, float scale,
                 int causal, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_fma<32>(q, k, v, o, lse, B, S, H, st, scale, causal, stream);
    case 64: return launch_fma<64>(q, k, v, o, lse, B, S, H, st, scale, causal, stream);
    case 128: return launch_fma<128>(q, k, v, o, lse, B, S, H, st, scale, causal, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch_mma(const void* q, const void* k, const void* v, void* o, void* lse,
                 int B, int S, int H, int D, const long long* st, float scale,
                 int causal, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_mma<32>(q, k, v, o, lse, B, S, H, st, scale, causal, stream);
    case 64: return launch_mma<64>(q, k, v, o, lse, B, S, H, st, scale, causal, stream);
    case 128: return launch_mma<128>(q, k, v, o, lse, B, S, H, st, scale, causal, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = fp32 (the FMA body), 1 = bf16 (the tensor-core body, which
// needs 16-byte aligned rows). Strides are in elements, (batch, seq,
// head) for each of q, k, v; the head dimension is contiguous. Returns a
// cudaError_t (0 = launched).
int edl_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, int B, int S, int H, int D,
                  long long qsb, long long qss, long long qsh,
                  long long ksb, long long kss, long long ksh,
                  long long vsb, long long vss, long long vsh,
                  float scale, int causal, int dtype, void* stream) {
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_fma(q, k, v, o, lse, B, S, H, D, st, scale, causal, s);
  if (dtype == 1)
    return dispatch_mma(q, k, v, o, lse, B, S, H, D, st, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* edl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

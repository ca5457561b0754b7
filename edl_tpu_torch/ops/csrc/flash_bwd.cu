// Flash-attention backward for Hopper (sm_90a), causal or full: two
// kernels, as on the TPU.
//
// Replaces the TPU kernels edl_tpu/ops/flash_attention.py::_bwd_dkdv_kernel
// (K2) and ::_bwd_dq_kernel (K3), both called from _bwd_pallas through
// pl.pallas_call. Same contract: q, k, v, dO are (B, S, H, D) in fp32 or
// bf16, read in place from their strides; lse (the forward's log-sum-exp)
// and the optional cotangent dlse are fp32 (B, S, H), contiguous. With
// p = exp(q.k * scale - lse) and dS = p * (dO.v - rt) * scale:
//   K3: rt = sum_k p (dO.v) - dlse, written fp32 (B, S, H) for K2, and
//       dQ = sum_k dS k, written in q's dtype;
//   K2: dV = sum_q p^T dO, dK = sum_q dS^T q, written in k/v's dtype;
// every gradient (B, S, H, D) contiguous. K3 runs first.
//
// The row term. The JAX package takes rt = rowsum(dO * O) - dlse, with O
// the forward's output in the input dtype. That equals sum_k p dP only up
// to O's bf16 rounding, and the error does not cancel: sum_k dS is then
// off by it, and dQ (dK) picks up that error times the mean key (query).
// Where a head's keys share one large component and its true dQ is tiny
// (trained weights, upper layers), the rounding swamped dQ. K3 therefore
// sums rt = sum_k p dP in fp32 from the same p and dP it uses, in a first
// sweep over the kv tiles, and hands it to K2.
//
// Design. The TPU program kept a whole (S, D) Q (K2) or K/V (K3) resident
// in VMEM and walked the other side in a sequential grid. Here one thread
// block owns one (batch*head, 64-row tile) and streams the other side's
// tiles through shared memory, with the sums in fp32 registers:
// - K2 keeps a 64-row K/V tile and streams Q/dO tiles, starting, under
//   the causal mask, at the tile that holds the K/V tile's first row (the
//   TPU kernel's q_start); only tiles touching the diagonal are masked.
// - K3 keeps a 64-row Q/dO tile and streams K/V tiles up to the diagonal,
//   twice (the row term, then dQ).
// dQ stays a kernel of its own: adding it atomically inside K2 would make
// the gradients depend on the order blocks finish in.
// The score tile is recomputed in each kernel and never reaches device
// memory.
//
// Two bodies share that plan:
// - bf16 runs on the tensor cores (4 warps, each owning 16 rows of the
//   resident tile): every product is mma.sync m16n8k16 with fp32
//   accumulation, fragments loaded with ldmatrix from padded tiles; p and
//   dS are rounded to bf16 as the A operand of the second products, as in
//   FlashAttention-2. At D = 128, K2 streams 32-row Q/dO tiles instead of
//   64: its dK and dV accumulators (2 x 64 fp32 a thread) plus two 16x64
//   score tiles would not fit the 255 registers of a thread, and halving
//   the score tiles (16 + 16 fp32) keeps everything in registers.
// - fp32 runs on the CUDA cores in fp32 FMA, to stay within 5e-5 of the
//   fp32 reference (TF32 would not): 256 threads as a 16x16 grid, each
//   owning 4x4 of the score tile and 4 rows x D/16 columns of the sums.
// Tile loads are synchronous; cp.async/TMA pipelining and wgmma are the
// next steps.
//
// Bounds on an H100 SXM at the training shape (B=16, S=1024, H=16, D=64,
// causal, bf16), counting each input read once and each output written
// once, and the visible (q, k) pairs: B*H*S(S+1)/2 = 134.3M.
// - K2: 4 products of 2*D flops per pair = 68.8 GFLOP, 69.6 us at
//   989 TFLOP/s; q, k, v, dO in and dK, dV out (6 x 33.6 MB) plus lse
//   and rt (2 x 1.0 MB) = 203.4 MB, 60.7 us at 3.35 TB/s. Compute bound,
//   about 70 us a launch.
// - K3: the 3 products dQ needs (S, dP, dS K) = 51.6 GFLOP, 52.2 us;
//   q, k, v, dO in and dQ out plus lse, rt = 169.9 MB, 50.7 us. Compute
//   bound, about 52 us a launch. The first sweep, which recomputes S and
//   dP to sum the row term, is this design's overhead on top (2 more
//   products, 34.4 GFLOP, 34.8 us at the peak rate).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BT = 64;              // rows of a resident or streamed tile

struct Strides {                    // (batch, seq, head) strides in elements
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;        // 16 x 16
constexpr int TP = BT + 4;          // row stride of the transposed tiles

// Copy a 64-row tile transposed into dst[d][TP]; rows at or past S read 0.
template <int D>
__device__ __forceinline__ void load_t(float* dst, const float* base,
                                       long long stride, int row0, int S,
                                       int tid) {
  for (int i = tid; i < BT * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int s = row0 + r;
    dst[d * TP + r] = s < S ? base[s * stride + d] : 0.f;
  }
}

constexpr size_t fma_smem_floats(int d) {
  return size_t(4) * d * TP + size_t(2) * BT * TP + 2 * BT;
}

// K2, fp32: one block per (64-row kv tile, batch*head).
template <int D>
__global__ void __launch_bounds__(THREADS)
dkdv_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ rt,
                float* __restrict__ dk, float* __restrict__ dv, int S, int H,
                Strides st, float scale, int causal) {
  constexpr int NPT = D / 16;   // columns of dK/dV a thread owns
  extern __shared__ float4 smem4[];
  float* Kt = reinterpret_cast<float*>(smem4);  // [D][TP] k tile^T
  float* Vt = Kt + D * TP;                      // [D][TP] v tile^T
  float* Qt = Vt + D * TP;                      // [D][TP] q tile^T
  float* Ot = Qt + D * TP;                      // [D][TP] dO tile^T
  float* Pt = Ot + D * TP;                      // [q][TP] p^T tile
  float* St = Pt + BT * TP;                     // [q][TP] dS^T tile
  float* lse_s = St + BT * TP;                  // [BT]
  float* rt_s = lse_s + BT;                     // [BT]

  const int tid = threadIdx.x;
  const int tx = tid & 15;      // q columns tx*4.., dK/dV columns tx*NPT..
  const int ty = tid >> 4;      // kv rows ty*4..
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BT;

  const float* qb = q + b * st.qb + h * st.qh;
  const float* ob = dout + b * st.ob + h * st.oh;
  load_t<D>(Kt, k + b * st.kb + h * st.kh, st.ks, k0, S, tid);
  load_t<D>(Vt, v + b * st.vb + h * st.vh, st.vs, k0, S, tid);

  float dka[4][NPT], dva[4][NPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < NPT; ++n) dka[i][n] = dva[i][n] = 0.f;

  // causal: the first q tile that sees this kv tile starts at its row k0
  for (int q0 = causal ? k0 : 0; q0 < S; q0 += BT) {
    __syncthreads();  // the previous tile's readers are done
    load_t<D>(Qt, qb, st.qs, q0, S, tid);
    load_t<D>(Ot, ob, st.os, q0, S, tid);
    for (int i = tid; i < BT; i += THREADS) {
      const int s = q0 + i;
      const long long r = ((long long)b * S + s) * H + h;
      lse_s[i] = s < S ? lse[r] : 0.f;
      rt_s[i] = s < S ? rt[r] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this thread's 4x4
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 ka = *reinterpret_cast<const float4*>(&Kt[d * TP + ty * 4]);
      const float4 va = *reinterpret_cast<const float4*>(&Vt[d * TP + ty * 4]);
      const float4 qa = *reinterpret_cast<const float4*>(&Qt[d * TP + tx * 4]);
      const float4 oa = *reinterpret_cast<const float4*>(&Ot[d * TP + tx * 4]);
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
      const float vv[4] = {va.x, va.y, va.z, va.w};
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float ov[4] = {oa.x, oa.y, oa.z, oa.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(kv[i], qv[j], sc[i][j]);
          dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
        }
    }
    // p^T = exp(s * scale - lse), masked; dS^T = p^T (dP^T - rt) scale
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx * 4 + j, col = q0 + c;
        const bool vis = col < S && !(causal && col < row);
        const float p = vis ? expf(sc[i][j] * scale - lse_s[c]) : 0.f;
        sc[i][j] = p;
        dp[i][j] = p * (dp[i][j] - rt_s[c]) * scale;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(&Pt[(tx * 4 + j) * TP + ty * 4]) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
      *reinterpret_cast<float4*>(&St[(tx * 4 + j) * TP + ty * 4]) =
          make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
    }
    __syncthreads();

    // dV += p^T dO, dK += dS^T Q; columns past S hold p == dS == 0
    const int c_end = min(BT, S - q0);
    for (int c = 0; c < c_end; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(&Pt[c * TP + ty * 4]);
      const float4 sa = *reinterpret_cast<const float4*>(&St[c * TP + ty * 4]);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
      const float sv[4] = {sa.x, sa.y, sa.z, sa.w};
#pragma unroll
      for (int n = 0; n < NPT; ++n) {
        const float o = Ot[(tx * NPT + n) * TP + c];
        const float x = Qt[(tx * NPT + n) * TP + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dva[i][n] = fmaf(pv[i], o, dva[i][n]);
          dka[i][n] = fmaf(sv[i], x, dka[i][n]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= S) continue;
    const long long orow = (((long long)b * S + row) * H + h) * D + tx * NPT;
#pragma unroll
    for (int n = 0; n < NPT; ++n) {
      dk[orow + n] = dka[i][n];
      dv[orow + n] = dva[i][n];
    }
  }
}

// Sum over the 16 threads of a row group (lanes differing in bits 0-3).
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// S = Q K^T and dP = dO V^T for a thread's 4 q rows x 4 kv columns.
template <int D>
__device__ __forceinline__ void dq_fma_scores(float (&sc)[4][4], float (&dp)[4][4],
                                              const float* Qt, const float* Ot,
                                              const float* Kt, const float* Vt,
                                              int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float4 qa = *reinterpret_cast<const float4*>(&Qt[d * TP + ty * 4]);
    const float4 oa = *reinterpret_cast<const float4*>(&Ot[d * TP + ty * 4]);
    const float4 ka = *reinterpret_cast<const float4*>(&Kt[d * TP + tx * 4]);
    const float4 va = *reinterpret_cast<const float4*>(&Vt[d * TP + tx * 4]);
    const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
    const float ov[4] = {oa.x, oa.y, oa.z, oa.w};
    const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
    const float vv[4] = {va.x, va.y, va.z, va.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
}

// K3, fp32: one block per (64-row q tile, batch*head). Two sweeps over
// the visible kv tiles: the first sums the row term r = sum_j p dP (and
// writes rt = r - dlse for K2), the second accumulates dQ.
template <int D>
__global__ void __launch_bounds__(THREADS)
dq_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ dlse,
              float* __restrict__ rt_out, float* __restrict__ dq, int S,
              int H, Strides st, float scale, int causal) {
  constexpr int NPT = D / 16;   // columns of dQ a thread owns
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [D][TP] q tile^T
  float* Ot = Qt + D * TP;                      // [D][TP] dO tile^T
  float* Kt = Ot + D * TP;                      // [D][TP] k tile^T
  float* Vt = Kt + D * TP;                      // [D][TP] v tile^T
  float* St = Vt + D * TP;                      // [kv][TP] dS^T tile

  const int tid = threadIdx.x;
  const int tx = tid & 15;      // kv columns tx*4.., dQ columns tx*NPT..
  const int ty = tid >> 4;      // q rows ty*4..
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BT;  // heaviest tiles first

  load_t<D>(Qt, q + b * st.qb + h * st.qh, st.qs, q0, S, tid);
  load_t<D>(Ot, dout + b * st.ob + h * st.oh, st.os, q0, S, tid);
  const float* kb = k + b * st.kb + h * st.kh;
  const float* vb = v + b * st.vb + h * st.vh;
  float lse_r[4], rt_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    lse_r[i] = s < S ? lse[((long long)b * S + s) * H + h] : 0.f;
    rt_r[i] = 0.f;
  }
  const int kv_end = causal ? min(S, q0 + BT) : S;

  // sweep 1: the row term
  for (int k0 = 0; k0 < kv_end; k0 += BT) {
    __syncthreads();  // the previous tile's readers are done
    load_t<D>(Kt, kb, st.ks, k0, S, tid);
    load_t<D>(Vt, vb, st.vs, k0, S, tid);
    __syncthreads();
    float sc[4][4], dp[4][4];
    dq_fma_scores<D>(sc, dp, Qt, Ot, Kt, Vt, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        if (col < S && !(causal && col > row))
          rt_r[i] += expf(sc[i][j] * scale - lse_r[i]) * dp[i][j];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    const long long r = ((long long)b * S + s) * H + h;
    rt_r[i] = row_sum16(rt_r[i]);
    if (s < S) {
      if (dlse != nullptr) rt_r[i] -= dlse[r];
      if (tx == 0) rt_out[r] = rt_r[i];
    }
  }

  float dqa[4][NPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < NPT; ++n) dqa[i][n] = 0.f;

  // sweep 2: dQ
  for (int k0 = 0; k0 < kv_end; k0 += BT) {
    __syncthreads();  // the previous tile's readers are done
    load_t<D>(Kt, kb, st.ks, k0, S, tid);
    load_t<D>(Vt, vb, st.vs, k0, S, tid);
    __syncthreads();
    float sc[4][4], dp[4][4];
    dq_fma_scores<D>(sc, dp, Qt, Ot, Kt, Vt, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        const bool vis = col < S && !(causal && col > row);
        const float p = vis ? expf(sc[i][j] * scale - lse_r[i]) : 0.f;
        dp[i][j] = p * (dp[i][j] - rt_r[i]) * scale;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&St[(tx * 4 + j) * TP + ty * 4]) =
          make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
    __syncthreads();

    // dQ += dS K; columns past kv_end hold dS == 0
    const int c_end = min(BT, kv_end - k0);
    for (int c = 0; c < c_end; ++c) {
      const float4 sa = *reinterpret_cast<const float4*>(&St[c * TP + ty * 4]);
      const float sv[4] = {sa.x, sa.y, sa.z, sa.w};
#pragma unroll
      for (int n = 0; n < NPT; ++n) {
        const float x = Kt[(tx * NPT + n) * TP + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) dqa[i][n] = fmaf(sv[i], x, dqa[i][n]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const long long orow = (((long long)b * S + row) * H + h) * D + tx * NPT;
#pragma unroll
    for (int n = 0; n < NPT; ++n) dq[orow + n] = dqa[i][n];
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 4;                 // 16 resident rows each
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

// The accumulators of n-tiles 2kk and 2kk+1 as the A fragment of k-step kk.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Copy ROWS rows of D bf16 (row r at base + r * stride) into a padded
// shared tile, 16 bytes a thread; rows at or past S read as zero.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* base,
                                          long long stride, int row0, int S,
                                          int tid) {
  constexpr int VPR = D / 8;   // 16-byte vectors per row
  constexpr int LD = D + TC_PAD;
  for (int i = tid; i < ROWS * VPR; i += TC_THREADS) {
    const int r = i / VPR, c8 = (i % VPR) * 8;
    const int s = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < S) val = *reinterpret_cast<const uint4*>(base + s * stride + c8);
    *reinterpret_cast<uint4*>(dst + r * LD + c8) = val;
  }
}

// Store one accumulator row pair (rows r0, r0 + 8 of 16) as bf16.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, int b, int S,
                                           int H, int h, int r0, int tq,
                                           const float (&acc)[D / 8][4]) {
  if (r0 < S) {
    uint32_t* op = reinterpret_cast<uint32_t*>(
        out + (((long long)b * S + r0) * H + h) * D + 2 * tq);
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) op[nt * 4] = pack_bf16(acc[nt][0], acc[nt][1]);
  }
  if (r0 + 8 < S) {
    uint32_t* op = reinterpret_cast<uint32_t*>(
        out + (((long long)b * S + r0 + 8) * H + h) * D + 2 * tq);
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) op[nt * 4] = pack_bf16(acc[nt][2], acc[nt][3]);
  }
}

// Q/dO rows K2 streams a tile: 32 at D = 128 (registers), else 64.
template <int D>
__host__ __device__ constexpr int k2_q_rows() { return D > 64 ? 32 : 64; }

template <int D>
constexpr size_t dkdv_mma_smem_bytes() {
  return size_t(2 * BT + 2 * k2_q_rows<D>()) * (D + TC_PAD) * sizeof(__nv_bfloat16)
         + 2 * k2_q_rows<D>() * sizeof(float);
}

// K2, bf16: one block per (64-row kv tile, batch*head); warp w owns kv
// rows 16w..16w+15 of the tile.
template <int D>
__global__ void __launch_bounds__(TC_THREADS)
dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ rt,
                __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                int S, int H, Strides st, float scale, int causal) {
  constexpr int LD = D + TC_PAD;
  constexpr int BQ = k2_q_rows<D>();
  constexpr int KSTEPS = D / 16;     // k-steps of the D-deep products
  constexpr int SNT = BQ / 8;        // n-tiles of S^T, dP^T (q columns)
  constexpr int QSTEPS = BQ / 16;    // k-steps of the q-deep products
  constexpr int DNT = D / 8;         // n-tiles of dK, dV
  extern __shared__ uint4 tc_smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(tc_smem);  // [BT][LD]
  __nv_bfloat16* Vs = Ks + BT * LD;                               // [BT][LD]
  __nv_bfloat16* Qs = Vs + BT * LD;                               // [BQ][LD]
  __nv_bfloat16* Os = Qs + BQ * LD;                               // [BQ][LD]
  float* lse_s = reinterpret_cast<float*>(Os + BQ * LD);          // [BQ]
  float* rt_s = lse_s + BQ;                                       // [BQ]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;      // mma fragment coordinates
  const int lm = lane >> 3, lr = lane & 7;     // ldmatrix: matrix, row
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BT;              // causal: tile 0 is heaviest
  const int kr0 = k0 + warp * 16 + g, kr1 = kr0 + 8;

  const __nv_bfloat16* qb = q + b * st.qb + h * st.qh;
  const __nv_bfloat16* ob = dout + b * st.ob + h * st.oh;
  load_tile<D, BT>(Ks, k + b * st.kb + h * st.kh, st.ks, k0, S, tid);
  load_tile<D, BT>(Vs, v + b * st.vb + h * st.vh, st.vs, k0, S, tid);

  float dka[DNT][4], dva[DNT][4];
#pragma unroll
  for (int nt = 0; nt < DNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nt][e] = dva[nt][e] = 0.f;

  const __nv_bfloat16* ka_row = Ks + (warp * 16 + (lm & 1) * 8 + lr) * LD + (lm >> 1) * 8;
  const __nv_bfloat16* va_row = Vs + (warp * 16 + (lm & 1) * 8 + lr) * LD + (lm >> 1) * 8;

  for (int q0 = causal ? k0 : 0; q0 < S; q0 += BQ) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<D, BQ>(Qs, qb, st.qs, q0, S, tid);
    load_tile<D, BQ>(Os, ob, st.os, q0, S, tid);
    for (int i = tid; i < BQ; i += TC_THREADS) {
      const int s = q0 + i;
      const long long r = ((long long)b * S + s) * H + h;
      lse_s[i] = s < S ? lse[r] : 0.f;
      rt_s[i] = s < S ? rt[r] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: 16 kv rows x BQ q columns per warp
    float sacc[SNT][4], pacc[SNT][4];
#pragma unroll
    for (int nt = 0; nt < SNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[nt][e] = pacc[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t ka[4], va[4];
      ldsm_x4(ka, ka_row + kk * 16);
      ldsm_x4(va, va_row + kk * 16);
#pragma unroll
      for (int nt = 0; nt < SNT; nt += 2) {
        const int off = ((nt + (lm >> 1)) * 8 + lr) * LD + kk * 16 + (lm & 1) * 8;
        uint32_t bq[4], bo[4];
        ldsm_x4(bq, Qs + off);
        ldsm_x4(bo, Os + off);
        mma_bf16(sacc[nt], ka, bq[0], bq[1]);
        mma_bf16(sacc[nt + 1], ka, bq[2], bq[3]);
        mma_bf16(pacc[nt], va, bo[0], bo[1]);
        mma_bf16(pacc[nt + 1], va, bo[2], bo[3]);
      }
    }

    // p^T = exp(s * scale - lse), masked; dS^T = p^T (dP^T - rt) scale
#pragma unroll
    for (int nt = 0; nt < SNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kr = e < 2 ? kr0 : kr1;
        const int c = nt * 8 + 2 * tq + (e & 1), col = q0 + c;
        const bool vis = col < S && !(causal && col < kr);
        const float p = vis ? expf(sacc[nt][e] * scale - lse_s[c]) : 0.f;
        sacc[nt][e] = p;
        pacc[nt][e] = p * (pacc[nt][e] - rt_s[c]) * scale;
      }
    }

    // dV += p^T dO and dK += dS^T Q, q as the k dimension
#pragma unroll
    for (int kk = 0; kk < QSTEPS; ++kk) {
      uint32_t pa[4], sa[4];
      acc_to_a(pa, sacc[2 * kk], sacc[2 * kk + 1]);
      acc_to_a(sa, pacc[2 * kk], pacc[2 * kk + 1]);
#pragma unroll
      for (int nt = 0; nt < DNT; nt += 2) {
        const int off = (kk * 16 + (lm & 1) * 8 + lr) * LD + (nt + (lm >> 1)) * 8;
        uint32_t bo[4], bq[4];
        ldsm_x4_trans(bo, Os + off);
        ldsm_x4_trans(bq, Qs + off);
        mma_bf16(dva[nt], pa, bo[0], bo[1]);
        mma_bf16(dva[nt + 1], pa, bo[2], bo[3]);
        mma_bf16(dka[nt], sa, bq[0], bq[1]);
        mma_bf16(dka[nt + 1], sa, bq[2], bq[3]);
      }
    }
  }

  store_rows<D>(dk, b, S, H, h, kr0, tq, dka);
  store_rows<D>(dv, b, S, H, h, kr0, tq, dva);
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// S = Q K^T and dP = dO V^T: a warp's 16 q rows x 64 kv columns.
template <int D>
__device__ __forceinline__ void dq_mma_scores(float (&sacc)[BT / 8][4],
                                              float (&pacc)[BT / 8][4],
                                              const __nv_bfloat16* qa_row,
                                              const __nv_bfloat16* oa_row,
                                              const __nv_bfloat16* Ks,
                                              const __nv_bfloat16* Vs, int lm,
                                              int lr) {
  constexpr int LD = D + TC_PAD;
#pragma unroll
  for (int nt = 0; nt < BT / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) sacc[nt][e] = pacc[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t qa[4], oa[4];
    ldsm_x4(qa, qa_row + kk * 16);
    ldsm_x4(oa, oa_row + kk * 16);
#pragma unroll
    for (int nt = 0; nt < BT / 8; nt += 2) {
      const int off = ((nt + (lm >> 1)) * 8 + lr) * LD + kk * 16 + (lm & 1) * 8;
      uint32_t bk[4], bv[4];
      ldsm_x4(bk, Ks + off);
      ldsm_x4(bv, Vs + off);
      mma_bf16(sacc[nt], qa, bk[0], bk[1]);
      mma_bf16(sacc[nt + 1], qa, bk[2], bk[3]);
      mma_bf16(pacc[nt], oa, bv[0], bv[1]);
      mma_bf16(pacc[nt + 1], oa, bv[2], bv[3]);
    }
  }
}

template <int D>
constexpr size_t dq_mma_smem_bytes() {
  return size_t(4 * BT) * (D + TC_PAD) * sizeof(__nv_bfloat16);
}

// K3, bf16: one block per (64-row q tile, batch*head); warp w owns q rows
// 16w..16w+15 of the tile. Two sweeps over the visible kv tiles: the
// first sums the row term r = sum_j p dP in fp32 (and writes rt = r - dlse
// for K2), the second accumulates dQ.
template <int D>
__global__ void __launch_bounds__(TC_THREADS)
dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ dlse,
              float* __restrict__ rt_out, __nv_bfloat16* __restrict__ dq,
              int S, int H, Strides st, float scale, int causal) {
  constexpr int LD = D + TC_PAD;
  constexpr int SNT = BT / 8;        // n-tiles of S, dP (kv columns)
  constexpr int KVSTEPS = BT / 16;   // k-steps of dS K
  constexpr int DNT = D / 8;         // n-tiles of dQ
  extern __shared__ uint4 tc_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(tc_smem);  // [BT][LD]
  __nv_bfloat16* Os = Qs + BT * LD;                               // [BT][LD]
  __nv_bfloat16* Ks = Os + BT * LD;                               // [BT][LD]
  __nv_bfloat16* Vs = Ks + BT * LD;                               // [BT][LD]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BT;  // heaviest tiles first
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;

  load_tile<D, BT>(Qs, q + b * st.qb + h * st.qh, st.qs, q0, S, tid);
  load_tile<D, BT>(Os, dout + b * st.ob + h * st.oh, st.os, q0, S, tid);
  const __nv_bfloat16* kb = k + b * st.kb + h * st.kh;
  const __nv_bfloat16* vb = v + b * st.vb + h * st.vh;
  const long long r0 = ((long long)b * S + row0) * H + h;
  const long long r1 = ((long long)b * S + row1) * H + h;
  const float lse0 = row0 < S ? lse[r0] : 0.f, lse1 = row1 < S ? lse[r1] : 0.f;
  const __nv_bfloat16* qa_row = Qs + (warp * 16 + (lm & 1) * 8 + lr) * LD + (lm >> 1) * 8;
  const __nv_bfloat16* oa_row = Os + (warp * 16 + (lm & 1) * 8 + lr) * LD + (lm >> 1) * 8;
  const int kv_end = causal ? min(S, q0 + BT) : S;

  // sweep 1: the row term of rows row0 (e = 0, 1) and row1 (e = 2, 3)
  float rt0 = 0.f, rt1 = 0.f;
  for (int k0 = 0; k0 < kv_end; k0 += BT) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<D, BT>(Ks, kb, st.ks, k0, S, tid);
    load_tile<D, BT>(Vs, vb, st.vs, k0, S, tid);
    __syncthreads();
    float sacc[SNT][4], pacc[SNT][4];
    dq_mma_scores<D>(sacc, pacc, qa_row, oa_row, Ks, Vs, lm, lr);
#pragma unroll
    for (int nt = 0; nt < SNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lo = e < 2;
        const int col = k0 + nt * 8 + 2 * tq + (e & 1);
        if (col < S && !(causal && col > (lo ? row0 : row1))) {
          const float pdp = expf(sacc[nt][e] * scale - (lo ? lse0 : lse1)) * pacc[nt][e];
          if (lo) rt0 += pdp; else rt1 += pdp;
        }
      }
    }
  }
  rt0 = quad_sum(rt0);
  rt1 = quad_sum(rt1);
  if (row0 < S) {
    if (dlse != nullptr) rt0 -= dlse[r0];
    if (tq == 0) rt_out[r0] = rt0;
  }
  if (row1 < S) {
    if (dlse != nullptr) rt1 -= dlse[r1];
    if (tq == 0) rt_out[r1] = rt1;
  }

  float dqa[DNT][4];
#pragma unroll
  for (int nt = 0; nt < DNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[nt][e] = 0.f;

  // sweep 2: dQ
  for (int k0 = 0; k0 < kv_end; k0 += BT) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<D, BT>(Ks, kb, st.ks, k0, S, tid);
    load_tile<D, BT>(Vs, vb, st.vs, k0, S, tid);
    __syncthreads();
    float sacc[SNT][4], pacc[SNT][4];
    dq_mma_scores<D>(sacc, pacc, qa_row, oa_row, Ks, Vs, lm, lr);

    // dS = p (dP - rt) scale, p = exp(s * scale - lse), masked
#pragma unroll
    for (int nt = 0; nt < SNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lo = e < 2;
        const int row = lo ? row0 : row1;
        const int col = k0 + nt * 8 + 2 * tq + (e & 1);
        const bool vis = col < S && !(causal && col > row);
        const float p = vis ? expf(sacc[nt][e] * scale - (lo ? lse0 : lse1)) : 0.f;
        pacc[nt][e] = p * (pacc[nt][e] - (lo ? rt0 : rt1)) * scale;
      }
    }

    // dQ += dS K, kv as the k dimension
#pragma unroll
    for (int kk = 0; kk < KVSTEPS; ++kk) {
      uint32_t sa[4];
      acc_to_a(sa, pacc[2 * kk], pacc[2 * kk + 1]);
#pragma unroll
      for (int nt = 0; nt < DNT; nt += 2) {
        uint32_t bk[4];
        ldsm_x4_trans(bk, Ks + (kk * 16 + (lm & 1) * 8 + lr) * LD + (nt + (lm >> 1)) * 8);
        mma_bf16(dqa[nt], sa, bk[0], bk[1]);
        mma_bf16(dqa[nt + 1], sa, bk[2], bk[3]);
      }
    }
  }

  store_rows<D>(dq, b, S, H, h, row0, tq, dqa);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

template <int D>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* rt, void* dk, void* dv, int B,
                int S, int H, const Strides& st, float scale, int causal,
                int dtype, cudaStream_t stream) {
  const dim3 grid((S + BT - 1) / BT, B * H);
  if (dtype == 0) {
    const size_t smem = fma_smem_floats(D) * sizeof(float);
    if (int err = set_smem(dkdv_fma_kernel<D>, smem)) return err;
    dkdv_fma_kernel<D><<<grid, THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse, rt,
        static_cast<float*>(dk), static_cast<float*>(dv), S, H, st, scale,
        causal);
  } else {
    const size_t smem = dkdv_mma_smem_bytes<D>();
    if (int err = set_smem(dkdv_mma_kernel<D>, smem)) return err;
    dkdv_mma_kernel<D><<<grid, TC_THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<const __nv_bfloat16*>(dout), lse, rt,
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), S, H,
        st, scale, causal);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* dlse, float* rt, void* dq, int B,
              int S, int H, const Strides& st, float scale, int causal,
              int dtype, cudaStream_t stream) {
  const dim3 grid((S + BT - 1) / BT, B * H);
  if (dtype == 0) {
    const size_t smem = fma_smem_floats(D) * sizeof(float);
    if (int err = set_smem(dq_fma_kernel<D>, smem)) return err;
    dq_fma_kernel<D><<<grid, THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        dlse, rt, static_cast<float*>(dq), S, H, st, scale, causal);
  } else {
    const size_t smem = dq_mma_smem_bytes<D>();
    if (int err = set_smem(dq_mma_kernel<D>, smem)) return err;
    dq_mma_kernel<D><<<grid, TC_THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<const __nv_bfloat16*>(dout), lse, dlse, rt,
        static_cast<__nv_bfloat16*>(dq), S, H, st, scale, causal);
  }
  return static_cast<int>(cudaGetLastError());
}

Strides to_strides(const long long* s) {
  return Strides{s[0], s[1], s[2], s[3], s[4], s[5],
                 s[6], s[7], s[8], s[9], s[10], s[11]};
}

}  // namespace

extern "C" {

// dtype: 0 = fp32 (the FMA bodies), 1 = bf16 (the tensor-core bodies,
// which need 16-byte aligned rows). strides: 12 values in elements, the
// (batch, seq, head) strides of q, k, v and dO in that order; the head
// dimension is contiguous. lse, dlse (may be null: zero) and rt are
// (B, S, H) fp32 contiguous: edl_flash_bwd_dq writes rt, which
// edl_flash_bwd_dkdv then reads. The gradients are (B, S, H, D)
// contiguous in the input dtype. Each returns a cudaError_t (0 =
// launched).
int edl_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* rt,
                       void* dk, void* dv, int B, int S, int H, int D,
                       const long long* strides, float scale, int causal,
                       int dtype, void* stream) {
  const Strides st = to_strides(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 32: return launch_dkdv<32>(q, k, v, dout, lse, rt, dk, dv, B, S, H, st, scale, causal, dtype, s);
    case 64: return launch_dkdv<64>(q, k, v, dout, lse, rt, dk, dv, B, S, H, st, scale, causal, dtype, s);
    case 128: return launch_dkdv<128>(q, k, v, dout, lse, rt, dk, dv, B, S, H, st, scale, causal, dtype, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int edl_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* dlse,
                     float* rt, void* dq, int B, int S, int H, int D,
                     const long long* strides, float scale, int causal,
                     int dtype, void* stream) {
  const Strides st = to_strides(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 32: return launch_dq<32>(q, k, v, dout, lse, dlse, rt, dq, B, S, H, st, scale, causal, dtype, s);
    case 64: return launch_dq<64>(q, k, v, dout, lse, dlse, rt, dq, B, S, H, st, scale, causal, dtype, s);
    case 128: return launch_dq<128>(q, k, v, dout, lse, dlse, rt, dq, B, S, H, st, scale, causal, dtype, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* edl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

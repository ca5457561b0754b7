// Flash-attention backward for Hopper (sm_90a), causal or full: two
// kernels, as on the TPU.
//
// Replaces the TPU kernels edl_tpu/ops/flash_attention.py::_bwd_dkdv_kernel
// (K2) and ::_bwd_dq_kernel (K3), both called from _bwd_pallas through
// pl.pallas_call. Same contract: q, k, v, dO are (B, S, H, D) in fp32,
// bf16 or fp16, read in place from their strides; lse (the forward's
// log-sum-exp) and the optional cotangent dlse are fp32 (B, S, H),
// contiguous. With
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
// sweep over the kv tiles, and hands it to K2. The shortcut
// dQ = scale ((p o dP) K - rt (p K)) would save that sweep but subtracts
// two large sums whose difference is the small dQ: the same cancellation.
//
// Plan. The TPU program kept a whole (S, D) Q (K2) or K/V (K3) resident
// in VMEM and walked the other side in a sequential grid. Here one thread
// block owns one (batch*head, 128-row tile) and streams the other side's
// tiles through shared memory, with the sums in fp32 registers:
// - K2 keeps a 128-row K/V tile and streams Q/dO tiles, starting, under
//   the causal mask, at the tile that holds the K/V tile's first row (the
//   TPU kernel's q_start); the heaviest kv tiles are scheduled first.
// - K3 keeps a 128-row Q/dO tile and streams K/V tiles up to the
//   diagonal, twice: the row term, then dQ; heaviest q tiles first.
// dQ stays a kernel of its own: adding it atomically inside K2 would make
// the gradients depend on the order blocks finish in. As it is, each
// gradient element is written by one block and every sum runs in a fixed
// order, so the same inputs give the same bits on every launch. The
// score tile is recomputed in each kernel and never reaches device
// memory.
//
// bf16 and fp16 (dkdv_wgmma_kernel<T, D>, dq_wgmma_kernel<T, D>, one body
// each compiled for each element type T: the tensor maps' data type, the
// products' PTX type and the rounding of p, dS and the gradients are T's;
// fp16 also scales each row of dS by a power of two before rounding it,
// see ds_row_exp; all else is shared, and the row term stays fp32) run
// on the Hopper tensor cores, with the pieces of hopper.cuh and flash.cuh
// (shared with K1):
// - A block is two consumer warpgroups, each owning 64 rows of the
//   resident tile, and a producer warpgroup whose first warp issues the
//   copies (setmaxnreg gives its registers to the consumers: 40 against
//   232). The producer fills a ring of shared-memory stages with TMA
//   copies of the streamed tiles: one tensor map per input over its
//   (B, S, H, D) view and strides, so a strided view of a fused qkv
//   projection is no special case, and rows past S read as zero. K2's
//   stages also carry the tile's lse and rt, copied with cp.async, as
//   they are strided scalars. An mbarrier per stage says "full", another
//   "empty"; the copies of the next stages run while the consumers
//   compute on this one.
// - Every product is wgmma with fp32 accumulators. The first two of a
//   tile (K2: S^T = K Q^T, dP^T = V dO^T; K3: S = Q K^T, dP = dO V^T)
//   read both operands from shared memory, K-major in the 128-byte
//   swizzle TMA wrote (64-byte at D = 32; D = 128 as two 64-column
//   halves), and are committed as two groups, so that p = exp(S...)
//   runs while dP still computes. p and dS are formed in registers,
//   rounded to T (fp16: dS scaled a row at a time) only as the A operand
//   of the second products (K2: dV += p^T dO, dK += dS^T Q; K3: dQ +=
//   dS K), whose B is the same streamed tile read MN-major. The second products are waited for
//   after the next tile's first ones are issued.
// - A warpgroup issues its products on every tile, also on one that the
//   causal mask hides from all of its rows (p and dS come out 0 there):
//   wgmmas under a branch, or waits that cover a group only on some
//   paths, make ptxas serialize them.
// - exp is one ex2.approx with log2(e) folded into scale and lse; the
//   causal and ragged mask runs only on tiles that cross the diagonal or
//   S (a body compiled apart from the unmasked one).
// - At D = 128, K2 streams 32-row Q/dO tiles, so the dK and dV
//   accumulators (2 x 64 fp32 a thread) and the score tiles fit in
//   registers; otherwise 64 rows.
// - The gradients leave through shared memory as whole 16-byte row
//   pieces.
// A register that an in-flight wgmma reads as its A operand must keep its
// value until the wait that covers it; ptxas has been seen to hand such a
// register to another value (an A operand loaded once before the loop
// was overwritten inside it). chip_smoke.py's build phase reads the SASS
// and fails on any such write.
// fp32 (dkdv_fma_kernel, dq_fma_kernel) runs on the CUDA cores in fp32
// FMA, to stay within 5e-5 of the fp32 reference (TF32 would not): 64-row
// tiles, 256 threads as a 16x16 grid, each owning 4x4 of the score tile
// and 4 rows x D/16 columns of the sums, synchronous tile loads.
//
// Bounds on an H100 SXM at the training shape (B=16, S=1024, H=16, D=64,
// causal, bf16 or fp16), counting each input read once and each output
// written once, and the visible (q, k) pairs: B*H*S(S+1)/2 = 134.3M.
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
#include <stdio.h>

#include "flash.cuh"

namespace {

using namespace flash;

constexpr int BT = 64;              // rows of an fp32 resident or streamed tile

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
// bf16 and fp16: wgmma fed by a TMA ring
// ---------------------------------------------------------------------------

// p = exp(s * scale - lse) in place of a score tile, as exp2(s * c2 - lse2)
// with c2 = scale * log2(e) and lse2 = lse * log2(e), over a warpgroup's
// 64 rows x N columns; this thread's columns are col0 + 8i + 2(lane%4)
// (+1) and its rows row0 (registers 4i + 0, 1), row0 + 8 (4i + 2, 3).
// K2 (ROW_LSE false) holds S^T: rows are kv, columns q, and each column
// has its lse (lse[] from shared memory, by column within the tile); an
// element is visible where q >= kv. K3 (ROW_LSE true) holds S: rows are
// q with their lse l0, l1, columns kv; visible where kv <= q. MASK: the
// tile crosses the diagonal or S, so each element is tested.
template <bool MASK, bool ROW_LSE, int N>
__device__ __forceinline__ void probs(float (&sacc)[N / 2], const float* lse,
                                      float l0, float l1, float c2, int col0,
                                      int row0, int S, int causal) {
  const int tq4 = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    float2 l = make_float2(l0, l1);
    if (!ROW_LSE) {
      l = *reinterpret_cast<const float2*>(lse + 8 * i + 2 * tq4);
      l = make_float2(l.x * LOG2E, l.y * LOG2E);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float lse_e = ROW_LSE ? (e < 2 ? l.x : l.y) : ((e & 1) ? l.y : l.x);
      float p = exp2_ftz(fmaf(sacc[4 * i + e], c2, -lse_e));
      if (MASK) {
        const int col = col0 + 8 * i + 2 * tq4 + (e & 1);
        const int row = row0 + 8 * (e >> 1);
        if (col >= S || (causal && (ROW_LSE ? col > row : col < row))) p = 0.f;
      }
      sacc[4 * i + e] = p;
    }
  }
}

// probs() with the mask tested on each element only where `mask` says
// the tile needs it.
template <bool ROW_LSE, int N>
__device__ __forceinline__ void tile_probs(bool mask, float (&sacc)[N / 2],
                                           const float* lse, float l0,
                                           float l1, float c2, int col0,
                                           int row0, int S, int causal) {
  if (mask)
    probs<true, ROW_LSE, N>(sacc, lse, l0, l1, c2, col0, row0, S, causal);
  else
    probs<false, ROW_LSE, N>(sacc, lse, l0, l1, c2, col0, row0, S, causal);
}

// dS = p (dP - rt) scale in place of dP; rt per column (K2: rts[] by
// column within the tile) or per row (K3: r0, r1), as in probs(); scale
// is sc0 on row0 and sc1 on row0 + 8 (fp16: times the row's 2^k).
template <bool ROW_RT, int N>
__device__ __forceinline__ void grads(const float (&p)[N / 2], float (&pacc)[N / 2],
                                      const float* rts, float r0, float r1,
                                      float sc0, float sc1) {
  const int tq4 = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    float2 r = make_float2(r0, r1);
    if (!ROW_RT) r = *reinterpret_cast<const float2*>(rts + 8 * i + 2 * tq4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float rt_e = ROW_RT ? (e < 2 ? r.x : r.y) : ((e & 1) ? r.y : r.x);
      pacc[4 * i + e] = p[4 * i + e] * (pacc[4 * i + e] - rt_e) * (e < 2 ? sc0 : sc1);
    }
  }
}

// K3's row terms: rt0 (rt1) += sum over this thread's columns of p dP on
// row0 (row0 + 8).
template <int N>
__device__ __forceinline__ void row_terms(const float (&p)[N / 2],
                                          const float (&pacc)[N / 2],
                                          float& rt0, float& rt1) {
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    rt0 = fmaf(p[4 * i + 0], pacc[4 * i + 0], rt0);
    rt0 = fmaf(p[4 * i + 1], pacc[4 * i + 1], rt0);
    rt1 = fmaf(p[4 * i + 2], pacc[4 * i + 2], rt1);
    rt1 = fmaf(p[4 * i + 3], pacc[4 * i + 3], rt1);
  }
}

// fp16's narrow range. dS = p (dP - rt) scale is a small difference
// times a probability: at the training shape its elements sit near
// 1e-5, below fp16's smallest normal (6.1e-5), where rounding to fp16
// keeps a few bits or none; and dQ (dK) sums them against keys (queries)
// that share a large mean, so the rounding of sum_k dS is multiplied into
// the gradient (the bf16 row-term fault, above, by another road). bf16
// has fp32's exponent range and needs none of this. The fp16 bodies
// therefore multiply each row of dS by a power of two 2^k before it
// becomes an A operand, and the fp32 accumulator's row by 2^-k at the
// end; both multiplies are exact. k is fixed for the whole loop, from a
// bound B on the row's |dS| known before it, such that 2^k B lies in
// [2^13, 2^14): far from fp16's 65504, and however loose the bound, the
// row's elements stay normal unless they are 2^27 below it. (Scaling
// each tile to its own maximum instead, and rescaling the accumulator
// when a row's scale shrinks, makes ptxas serialize every wgmma of the
// kernel: non-wgmma instructions then write an accumulator inside the
// pipelined loop.) The bounds: |dS_ij| <= scale (p_ij |dP_ij| + |rt_i|).
// - K3's rows are q rows: B_i = scale (max_j p_ij |dP_ij| + |rt_i|), both
//   terms from the first sweep, which forms p and dP for the row term.
// - K2's rows are kv rows: |dP_ij| <= |dO_i| |v_j|, so B_j = scale
//   (max_i |dO_i| |v_j| + max_i |rt_i|), the two maxima over the head's
//   rows written by K3 (head_max: atomicMax on the bits of values >= 0,
//   so the same inputs give the same bits), |v_j| from K2's resident V.

// The exponent k that takes a row bound B to [2^13, 2^14): 13 - e for
// B = f 2^e, f in [1, 2), with e clamped to [-100, 127] (a row of zeros
// takes 2^113; inf or NaN 2^-114, and the gradient comes out
// non-finite, as it should).
__device__ __forceinline__ int ds_row_exp(float bound) {
  return 13 - max(-100,
                  min(127, int((__float_as_uint(bound) >> 23) & 0xff) - 127));
}

// 2^k for k in [-126, 127], built from its bits.
__device__ __forceinline__ float pow2(int k) {
  return __uint_as_float(uint32_t(127 + k) << 23);
}

// K3's max_j p_ij |dP_ij| of this thread's rows row0 (registers 4i + 0,
// 1) and row0 + 8 (4i + 2, 3), over one tile.
template <int N>
__device__ __forceinline__ void pdp_absmax(const float (&p)[N / 2],
                                           const float (&pacc)[N / 2],
                                           float& a0, float& a1) {
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    a0 = fmaxf(a0, fmaxf(fabsf(p[4 * i + 0] * pacc[4 * i + 0]),
                         fabsf(p[4 * i + 1] * pacc[4 * i + 1])));
    a1 = fmaxf(a1, fmaxf(fabsf(p[4 * i + 2] * pacc[4 * i + 2]),
                         fabsf(p[4 * i + 3] * pacc[4 * i + 3])));
  }
}

// The squared L2 norm of row r of a resident tile as TMA wrote it, over
// the row's 4 threads (tq: this thread's quarter). The swizzle permutes
// 16-byte pieces within a row, so a row's bytes are where they were.
template <typename T, int D, int ROWS>
__device__ __forceinline__ float row_sq_norm(const uint8_t* tile, int r,
                                             int tq) {
  using Tl = Tile<D, ROWS>;
  constexpr int QUARTER = Tl::ROW_BYTES / 4;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < D / Tl::COLS; ++c) {
    const uint4* piece = reinterpret_cast<const uint4*>(
        tile + c * Tl::BLOCK_BYTES + r * Tl::ROW_BYTES + tq * QUARTER);
#pragma unroll
    for (int i = 0; i < QUARTER / 16; ++i) {
      const uint4 w = piece[i];
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = hopper::Elem<T>::unpack(words[j]);
        acc = fmaf(f.x, f.x, fmaf(f.y, f.y, acc));
      }
    }
  }
  return quad_sum(acc);
}

// The accumulator's rows multiplied by 2^-k0, 2^-k1 (exact).
template <int D>
__device__ __forceinline__ void unscale_rows(float (&acc)[D / 2], int k0,
                                             int k1) {
  const float u0 = pow2(-k0), u1 = pow2(-k1);
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    acc[4 * i + 0] *= u0;
    acc[4 * i + 1] *= u0;
    acc[4 * i + 2] *= u1;
    acc[4 * i + 3] *= u1;
  }
}

// K2's shared memory: K, V (TILE_ROWS rows, resident), a ring of STAGES
// (Q, dO) tiles of BQ rows and their rows' lse and rt, then the barriers.
// Tiles start on 1024-byte boundaries (the swizzle's repeat).
template <int D>
struct K2Smem {
  static constexpr int BQ = D > 64 ? 32 : 64;      // q rows a streamed tile
  static constexpr int STAGES = D > 64 ? 6 : 8;
  using KV = Tile<D, TILE_ROWS>;
  using Q = Tile<D, BQ>;
  static constexpr int V = KV::BYTES;
  static constexpr int RING = 2 * KV::BYTES;
  static constexpr int STAGE = 2 * Q::BYTES;
  static constexpr int ROWS = RING + STAGES * STAGE;          // float [STAGES][2][BQ]
  static constexpr int BARS = ROWS + STAGES * 2 * BQ * 4;     // kv, full[], empty[]
  static constexpr int BYTES = BARS + (1 + 2 * STAGES) * 8 + 1024;
};

// K2, bf16 or fp16 (T): one block per (128-row kv tile, batch*head).
template <typename T, int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse, const float* __restrict__ rt,
                  const float* __restrict__ head_max, T* __restrict__ dk,
                  T* __restrict__ dv,
                  int S, int H, float scale, int causal) {
  using L = K2Smem<D>;
  constexpr int BQ = L::BQ, STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* Ks = smem;
  uint8_t* Vs = smem + L::V;
  float* rows = reinterpret_cast<float*>(smem + L::ROWS);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * TILE_ROWS;       // causal: tile 0 is heaviest
  const int q_first = causal ? k0 / BQ : 0;    // the first q tile that sees k0
  const int n_q = (S + BQ - 1) / BQ;

  if (tid == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1 + 32);   // the TMA's + each lane's copies
      hopper::mbar_init(&empty[s], CONSUMER_WARPS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS * WG_THREADS) {
    // producer warpgroup; its first warp streams K, V once, then Q, dO,
    // lse, rt a stage at a time
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (tid >= CONSUMERS * WG_THREADS + 32) return;
    const int lane = tid & 31;
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(kv_full, 2 * L::KV::BYTES);
      L::KV::load(Ks, &tk, kv_full, h, k0, b);
      L::KV::load(Vs, &tv, kv_full, h, k0, b);
    }
    for (int j = q_first, it = 0; j < n_q; ++j, ++it) {
      const int s = it % STAGES;
      const int q0 = j * BQ;
      hopper::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
      uint8_t* st = smem + L::RING + s * L::STAGE;
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(&full[s], L::STAGE);
        L::Q::load(st, &tq, &full[s], h, q0, b);
        L::Q::load(st + L::Q::BYTES, &tdo, &full[s], h, q0, b);
      }
      float* row = rows + s * 2 * BQ;
      for (int i = lane; i < BQ; i += 32) {
        const bool valid = q0 + i < S;
        const long long idx = valid ? ((long long)b * S + q0 + i) * H + h : 0;
        hopper::cp_async_4(row + i, lse + idx, valid);
        hopper::cp_async_4(row + BQ + i, rt + idx, valid);
      }
      hopper::mbar_arrive_on_copies(&full[s]);
    }
    return;
  }
  hopper::setmaxnreg_inc<CONSUMER_REGS>();

  // consumer warpgroup wg: kv rows kw..kw+63
  const int wg = tid / WG_THREADS;
  const int lane = tid & 31, g = lane >> 2, tq4 = lane & 3;
  const int kw = k0 + wg * WG_ROWS;
  const int kr0 = kw + ((tid % WG_THREADS) >> 5) * 16 + g;   // and kr0 + 8
  const float c2 = scale * LOG2E;

  float dka[D / 2], dva[D / 2], sacc[BQ / 2], pacc[BQ / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) sacc[i] = pacc[i] = 0.f;

  hopper::mbar_wait(kv_full, 0);
  // dS's scale on this thread's kv rows kr0, kr0 + 8: fp16 also takes
  // each row's 2^k from its bound (see ds_row_exp)
  float sc0 = scale, sc1 = scale;
  int ks0 = 0, ks1 = 0;
  if constexpr (hopper::Elem<T>::F16) {
    const int vr = wg * WG_ROWS + ((tid % WG_THREADS) >> 5) * 16 + g;
    const float mo = sqrtf(head_max[2 * bh]), mr = head_max[2 * bh + 1];
    ks0 = ds_row_exp(scale * fmaf(
        mo, sqrtf(row_sq_norm<T, D, TILE_ROWS>(Vs, vr, tq4)), mr));
    ks1 = ds_row_exp(scale * fmaf(
        mo, sqrtf(row_sq_norm<T, D, TILE_ROWS>(Vs, vr + 8, tq4)), mr));
    sc0 = scale * pow2(ks0);
    sc1 = scale * pow2(ks1);
  }
  int prev = -1;     // the stage the last tile's dV, dK products may still read
  for (int j = q_first, it = 0; j < n_q; ++j, ++it) {
    const int s = it % STAGES;
    const int q0 = j * BQ;
    const uint8_t* Qst = smem + L::RING + s * L::STAGE;
    const uint8_t* Ost = Qst + L::Q::BYTES;
    hopper::mbar_wait(&full[s], (it / STAGES) & 1);

    // S^T = K Q^T and dP^T = V dO^T, 64 kv rows x BQ q columns, as two
    // groups. Every tile issues them, also one the causal mask hides from
    // this warpgroup (its p and dS come out 0): wgmmas under a branch
    // make ptxas serialize them.
    hopper::fence_regs(sacc);
    hopper::fence_regs(pacc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_ss<BQ, T>(sacc, L::KV::k_desc(Ks, wg * WG_ROWS, kk),
                              L::Q::k_desc(Qst, 0, kk), kk > 0);
    hopper::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_ss<BQ, T>(pacc, L::KV::k_desc(Vs, wg * WG_ROWS, kk),
                              L::Q::k_desc(Ost, 0, kk), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();        // S^T and the last tile's dV, dK
    hopper::fence_regs(sacc);
    hopper::fence_regs(dka);
    hopper::fence_regs(dva);
    if (prev >= 0) release(&empty[prev], lane);

    // p^T = exp(s * scale - lse) while dP^T finishes, then
    // dS^T = p^T (dP^T - rt) scale
    const float* lse_rt = rows + s * 2 * BQ;      // lse, then rt
    tile_probs<false, BQ>((causal && q0 < kw + WG_ROWS - 1) || q0 + BQ > S,
                          sacc, lse_rt, 0.f, 0.f, c2, q0, kr0, S, causal);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(pacc);
    grads<false, BQ>(sacc, pacc, lse_rt + BQ, 0.f, 0.f, sc0, sc1);
    uint32_t pa[BQ / 16][4], sa[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      acc_to_a<T>(pa[kk], sacc, kk);
      acc_to_a<T>(sa[kk], pacc, kk);
    }

    // dV += p^T dO and dK += dS^T Q, q as the k dimension; waited for
    // after the next tile's first products are issued
    hopper::fence_regs(dka);
    hopper::fence_regs(dva);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      hopper::wgmma_rs<D, T>(dva, pa[kk], L::Q::mn_desc(Ost, kk), 1);
      hopper::wgmma_rs<D, T>(dka, sa[kk], L::Q::mn_desc(Qst, kk), 1);
    }
    hopper::wgmma_commit();
    prev = s;
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(dka);
  hopper::fence_regs(dva);
  release(&empty[prev], lane);

  // both warpgroups are done with K and V: their tiles stage the output
  named_sync(1, CONSUMERS * WG_THREADS);
  if constexpr (hopper::Elem<T>::F16) unscale_rows<D>(dka, ks0, ks1);
  store_wg<T, D>(dk, Ks + wg * WG_ROWS * D * 2, dka, b, S, H, h, kw, 2 + wg);
  store_wg<T, D>(dv, Vs + wg * WG_ROWS * D * 2, dva, b, S, H, h, kw, 2 + wg);
}

// K3's shared memory: Q, dO (TILE_ROWS rows, resident), a ring of STAGES
// (K, V) tiles of BK rows, then the barriers.
template <int D>
struct K3Smem {
  static constexpr int BK = 64;                    // kv rows a streamed tile
  static constexpr int STAGES = D > 64 ? 4 : 8;
  using QO = Tile<D, TILE_ROWS>;
  using KV = Tile<D, BK>;
  static constexpr int O = QO::BYTES;
  static constexpr int RING = 2 * QO::BYTES;
  static constexpr int STAGE = 2 * KV::BYTES;
  static constexpr int BARS = RING + STAGES * STAGE;          // qo, full[], empty[]
  static constexpr int BYTES = BARS + (1 + 2 * STAGES) * 8 + 1024;
};

// K3's S = Q K^T and dP = dO V^T for the kv tile at st: warpgroup wg's
// 64 q rows x BK kv columns, committed as two groups, S first.
template <typename T, int D>
__device__ __forceinline__ void dq_scores(float (&sacc)[K3Smem<D>::BK / 2],
                                          float (&pacc)[K3Smem<D>::BK / 2],
                                          const uint8_t* Qs, const uint8_t* Os,
                                          const uint8_t* st, int wg) {
  using L = K3Smem<D>;
  hopper::fence_regs(sacc);
  hopper::fence_regs(pacc);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hopper::wgmma_ss<L::BK, T>(sacc, L::QO::k_desc(Qs, wg * WG_ROWS, kk),
                               L::KV::k_desc(st, 0, kk), kk > 0);
  hopper::wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hopper::wgmma_ss<L::BK, T>(pacc, L::QO::k_desc(Os, wg * WG_ROWS, kk),
                               L::KV::k_desc(st + L::KV::BYTES, 0, kk), kk > 0);
  hopper::wgmma_commit();
}

// K3, bf16 or fp16 (T): one block per (128-row q tile, batch*head). Two
// sweeps over the visible kv tiles through one ring: the first sums the
// row term r = sum_j p dP in fp32 (and writes rt = r - dlse for K2), the
// second accumulates dQ.
template <typename T, int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdo,
                const float* __restrict__ lse, const float* __restrict__ dlse,
                float* __restrict__ rt_out, float* __restrict__ head_max,
                T* __restrict__ dq,
                int S, int H, float scale, int causal) {
  using L = K3Smem<D>;
  constexpr int BK = L::BK, STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* Qs = smem;
  uint8_t* Os = smem + L::O;
  uint64_t* qo_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = qo_full + 1;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TILE_ROWS;  // heaviest first
  const int kv_end = causal ? min(S, q0 + TILE_ROWS) : S;
  const int n_kv = (kv_end + BK - 1) / BK;

  if (tid == 0) {
    hopper::mbar_init(qo_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMER_WARPS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS * WG_THREADS) {
    // producer warpgroup; one thread streams Q, dO once, then K, V a stage
    // at a time, two sweeps
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == CONSUMERS * WG_THREADS) {
      hopper::mbar_arrive_expect_tx(qo_full, 2 * L::QO::BYTES);
      L::QO::load(Qs, &tq, qo_full, h, q0, b);
      L::QO::load(Os, &tdo, qo_full, h, q0, b);
      for (int it = 0; it < 2 * n_kv; ++it) {
        const int s = it % STAGES;
        const int k0 = (it % n_kv) * BK;
        hopper::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        uint8_t* st = smem + L::RING + s * L::STAGE;
        hopper::mbar_arrive_expect_tx(&full[s], L::STAGE);
        L::KV::load(st, &tk, &full[s], h, k0, b);
        L::KV::load(st + L::KV::BYTES, &tv, &full[s], h, k0, b);
      }
    }
    return;
  }
  hopper::setmaxnreg_inc<CONSUMER_REGS>();

  // consumer warpgroup wg: q rows qw..qw+63; this thread's rows row0, row0 + 8
  const int wg = tid / WG_THREADS;
  const int lane = tid & 31, g = lane >> 2, tq4 = lane & 3;
  const int qw = q0 + wg * WG_ROWS;
  const int row0 = qw + ((tid % WG_THREADS) >> 5) * 16 + g, row1 = row0 + 8;
  const long long r0 = ((long long)b * S + row0) * H + h;
  const long long r1 = ((long long)b * S + row1) * H + h;
  const float lse0 = row0 < S ? lse[r0] * LOG2E : 0.f;
  const float lse1 = row1 < S ? lse[r1] * LOG2E : 0.f;
  const float c2 = scale * LOG2E;

  float sacc[BK / 2], pacc[BK / 2], dqa[D / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sacc[i] = pacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;

  hopper::mbar_wait(qo_full, 0);
  // sweep 1: the row term of rows row0 (e = 0, 1) and row1 (e = 2, 3).
  // Every tile issues its products, also the one past this warpgroup's
  // diagonal (its p comes out 0): wgmmas under a branch make ptxas
  // serialize them.
  float rt0 = 0.f, rt1 = 0.f;
  float am0 = 0.f, am1 = 0.f;     // fp16: max p |dP| of the rows
  for (int it = 0; it < n_kv; ++it) {
    const int s = it % STAGES;
    const int k0 = it * BK;
    hopper::mbar_wait(&full[s], (it / STAGES) & 1);
    dq_scores<T, D>(sacc, pacc, Qs, Os, smem + L::RING + s * L::STAGE, wg);
    hopper::wgmma_wait<1>();
    hopper::fence_regs(sacc);
    tile_probs<true, BK>((causal && k0 + BK - 1 > qw) || k0 + BK > S, sacc,
                         nullptr, lse0, lse1, c2, k0, row0, S, causal);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(pacc);
    release(&empty[s], lane);
    row_terms<BK>(sacc, pacc, rt0, rt1);
    if constexpr (hopper::Elem<T>::F16) pdp_absmax<BK>(sacc, pacc, am0, am1);
  }
  rt0 = quad_sum(rt0);
  rt1 = quad_sum(rt1);
  if (row0 < S) {
    if (dlse != nullptr) rt0 -= dlse[r0];
    if (tq4 == 0) rt_out[r0] = rt0;
  }
  if (row1 < S) {
    if (dlse != nullptr) rt1 -= dlse[r1];
    if (tq4 == 0) rt_out[r1] = rt1;
  }
  // dS's scale on the rows: fp16 also takes each row's 2^k from its
  // bound, and folds the head's largest |dO_i|^2 and |rt_i| over this
  // warp's rows into head_max, K2's bound (see ds_row_exp)
  float sc0 = scale, sc1 = scale;
  int ks0 = 0, ks1 = 0;
  if constexpr (hopper::Elem<T>::F16) {
    ks0 = ds_row_exp(scale * (quad_max(am0) + fabsf(rt0)));
    ks1 = ds_row_exp(scale * (quad_max(am1) + fabsf(rt1)));
    sc0 = scale * pow2(ks0);
    sc1 = scale * pow2(ks1);
    const int qr = wg * WG_ROWS + ((tid % WG_THREADS) >> 5) * 16 + g;
    const float n0 = row_sq_norm<T, D, TILE_ROWS>(Os, qr, tq4);
    const float n1 = row_sq_norm<T, D, TILE_ROWS>(Os, qr + 8, tq4);
    float mo = fmaxf(row0 < S ? n0 : 0.f, row1 < S ? n1 : 0.f);
    float mr = fmaxf(row0 < S ? fabsf(rt0) : 0.f, row1 < S ? fabsf(rt1) : 0.f);
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      mo = fmaxf(mo, __shfl_xor_sync(0xffffffffu, mo, off));
      mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, off));
    }
    if (lane == 0) {
      unsigned* hm = reinterpret_cast<unsigned*>(head_max) + 2 * bh;
      atomicMax(hm, __float_as_uint(mo));
      atomicMax(hm + 1, __float_as_uint(mr));
    }
  }

  // sweep 2: dQ += dS K, kv as the k dimension
  int prev = -1;     // the stage the last tile's dQ product may still read
  for (int it = n_kv; it < 2 * n_kv; ++it) {
    const int s = it % STAGES;
    const int k0 = (it - n_kv) * BK;
    const uint8_t* st = smem + L::RING + s * L::STAGE;
    hopper::mbar_wait(&full[s], (it / STAGES) & 1);
    dq_scores<T, D>(sacc, pacc, Qs, Os, st, wg);
    hopper::wgmma_wait<1>();        // S and the last tile's dQ
    hopper::fence_regs(sacc);
    hopper::fence_regs(dqa);
    if (prev >= 0) release(&empty[prev], lane);

    // p = exp(s * scale - lse) while dP finishes, then dS = p (dP - rt) scale
    tile_probs<true, BK>((causal && k0 + BK - 1 > qw) || k0 + BK > S, sacc,
                         nullptr, lse0, lse1, c2, k0, row0, S, causal);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(pacc);
    grads<true, BK>(sacc, pacc, nullptr, rt0, rt1, sc0, sc1);
    uint32_t sa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) acc_to_a<T>(sa[kk], pacc, kk);

    hopper::fence_regs(dqa);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      hopper::wgmma_rs<D, T>(dqa, sa[kk], L::KV::mn_desc(st, kk), 1);
    hopper::wgmma_commit();
    prev = s;
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(dqa);
  release(&empty[prev], lane);

  // both warpgroups are done with Q: it stages the output
  named_sync(1, CONSUMERS * WG_THREADS);
  if constexpr (hopper::Elem<T>::F16) unscale_rows<D>(dqa, ks0, ks1);
  store_wg<T, D>(dq, Qs + wg * WG_ROWS * D * 2, dqa, b, S, H, h, qw, 2 + wg);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// The tensor maps of q, k, v and dO, streamed in boxes of q_rows (q, dO)
// and kv_rows (k, v) rows. Returns 0 or TENSOR_MAP_FAILED + the CUresult.
template <typename T, int D>
int bwd_maps(CUtensorMap (&m)[4], const void* q, const void* k, const void* v,
             const void* dout, int B, int S, int H, const Strides& st,
             int q_rows, int kv_rows) {
  const void* ptr[4] = {q, k, v, dout};
  const long long s[12] = {st.qb, st.qs, st.qh, st.kb, st.ks, st.kh,
                          st.vb, st.vs, st.vh, st.ob, st.os, st.oh};
  const int rows[4] = {q_rows, kv_rows, kv_rows, q_rows};
  return make_maps<T, D>(m, 4, ptr, s, rows, B, S, H);
}
// K2's and K3's wgmma bodies for element type T.
template <typename T, int D>
int launch_dkdv_wgmma(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* rt,
                      const float* head_max, void* dk, void* dv, int B, int S,
                      int H,
                      const Strides& st, float scale, int causal,
                      cudaStream_t stream) {
  using L = K2Smem<D>;
  CUtensorMap m[4];
  if (int err = bwd_maps<T, D>(m, q, k, v, dout, B, S, H, st, L::BQ, TILE_ROWS))
    return err;
  if (int err = set_smem(dkdv_wgmma_kernel<T, D>, L::BYTES)) return err;
  const dim3 grid((S + TILE_ROWS - 1) / TILE_ROWS, B * H);
  dkdv_wgmma_kernel<T, D><<<grid, TC_THREADS, L::BYTES, stream>>>(
      m[0], m[1], m[2], m[3], lse, rt, head_max, static_cast<T*>(dk),
      static_cast<T*>(dv), S, H, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dq_wgmma(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* dlse,
                    float* rt, float* head_max, void* dq, int B, int S, int H,
                    const Strides& st,
                    float scale, int causal, cudaStream_t stream) {
  using L = K3Smem<D>;
  CUtensorMap m[4];
  if (int err = bwd_maps<T, D>(m, q, k, v, dout, B, S, H, st, TILE_ROWS, L::BK))
    return err;
  if (int err = set_smem(dq_wgmma_kernel<T, D>, L::BYTES)) return err;
  const dim3 grid((S + TILE_ROWS - 1) / TILE_ROWS, B * H);
  dq_wgmma_kernel<T, D><<<grid, TC_THREADS, L::BYTES, stream>>>(
      m[0], m[1], m[2], m[3], lse, dlse, rt, head_max, static_cast<T*>(dq), S,
      H, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* rt, const float* head_max,
                void* dk, void* dv, int B, int S, int H, const Strides& st,
                float scale, int causal, int dtype, cudaStream_t stream) {
  if (dtype == 1)
    return launch_dkdv_wgmma<__nv_bfloat16, D>(q, k, v, dout, lse, rt,
                                               head_max, dk, dv, B, S, H, st,
                                               scale, causal, stream);
  if (dtype == 2)
    return launch_dkdv_wgmma<__half, D>(q, k, v, dout, lse, rt, head_max, dk,
                                        dv, B, S, H, st, scale, causal, stream);
  const dim3 grid((S + BT - 1) / BT, B * H);
  const size_t smem = fma_smem_floats(D) * sizeof(float);
  if (int err = set_smem(dkdv_fma_kernel<D>, smem)) return err;
  dkdv_fma_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, rt,
      static_cast<float*>(dk), static_cast<float*>(dv), S, H, st, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* dlse, float* rt, float* head_max,
              void* dq, int B, int S, int H, const Strides& st, float scale,
              int causal, int dtype, cudaStream_t stream) {
  if (dtype == 1)
    return launch_dq_wgmma<__nv_bfloat16, D>(q, k, v, dout, lse, dlse, rt,
                                             head_max, dq, B, S, H, st, scale,
                                             causal, stream);
  if (dtype == 2)
    return launch_dq_wgmma<__half, D>(q, k, v, dout, lse, dlse, rt, head_max,
                                      dq, B, S, H, st, scale, causal, stream);
  const dim3 grid((S + BT - 1) / BT, B * H);
  const size_t smem = fma_smem_floats(D) * sizeof(float);
  if (int err = set_smem(dq_fma_kernel<D>, smem)) return err;
  dq_fma_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      dlse, rt, static_cast<float*>(dq), S, H, st, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

Strides to_strides(const long long* s) {
  return Strides{s[0], s[1], s[2], s[3], s[4], s[5],
                 s[6], s[7], s[8], s[9], s[10], s[11]};
}

}  // namespace

extern "C" {

// dtype: 0 = fp32 (the FMA bodies), 1 = bf16 and 2 = fp16 (the wgmma
// bodies, whose TMA copies need 16-byte aligned data and (batch, seq,
// head) strides in multiples of 8 elements). strides: 12 values in
// elements, the (batch, seq, head) strides of q, k, v and dO in that
// order; the head dimension is contiguous. lse, dlse (may be null: zero)
// and rt are (B, S, H) fp32 contiguous: edl_flash_bwd_dq writes rt, which
// edl_flash_bwd_dkdv then reads. head_max, (B, H, 2) fp32, is used by the
// fp16 bodies only (null otherwise): zeroed by the caller, raised by
// edl_flash_bwd_dq to each head's largest |dO_i|^2 and |rt_i|, read by
// edl_flash_bwd_dkdv (see ds_row_exp). The gradients are (B, S, H, D)
// contiguous in the input dtype. Each returns a cudaError_t (0 =
// launched), or TENSOR_MAP_FAILED plus the CUresult when a
// tensor map cannot be made.
int edl_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* rt,
                       const float* head_max, void* dk, void* dv, int B, int S,
                       int H, int D,
                       const long long* strides, float scale, int causal,
                       int dtype, void* stream) {
  const Strides st = to_strides(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype < 0 || dtype > 2) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 32: return launch_dkdv<32>(q, k, v, dout, lse, rt, head_max, dk, dv, B, S, H, st, scale, causal, dtype, s);
    case 64: return launch_dkdv<64>(q, k, v, dout, lse, rt, head_max, dk, dv, B, S, H, st, scale, causal, dtype, s);
    case 128: return launch_dkdv<128>(q, k, v, dout, lse, rt, head_max, dk, dv, B, S, H, st, scale, causal, dtype, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int edl_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* dlse,
                     float* rt, float* head_max, void* dq, int B, int S,
                     int H, int D,
                     const long long* strides, float scale, int causal,
                     int dtype, void* stream) {
  const Strides st = to_strides(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype < 0 || dtype > 2) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 32: return launch_dq<32>(q, k, v, dout, lse, dlse, rt, head_max, dq, B, S, H, st, scale, causal, dtype, s);
    case 64: return launch_dq<64>(q, k, v, dout, lse, dlse, rt, head_max, dq, B, S, H, st, scale, causal, dtype, s);
    case 128: return launch_dq<128>(q, k, v, dout, lse, dlse, rt, head_max, dq, B, S, H, st, scale, causal, dtype, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* edl_cuda_error_string(int err) {
  if (err >= TENSOR_MAP_FAILED) {
    static thread_local char msg[80];
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed (CUresult %d)",
             err - TENSOR_MAP_FAILED);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

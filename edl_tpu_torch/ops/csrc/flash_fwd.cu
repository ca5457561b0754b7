// Flash-attention forward for Hopper (sm_90a), causal or full.
//
// Replaces the TPU kernel edl_tpu/ops/flash_attention.py::_fwd_kernel
// (called from _fwd through pl.pallas_call). Same contract: q, k, v are
// (B, S, H, D) in fp32 or bf16, read in place from their strides (no
// transposed copies); o is written (B, S, H, D) contiguous in the input
// dtype, and the log-sum-exp lse = m + log(max(l, 1e-30)) in fp32, laid
// out (B, S, H).
//
// Plan. The TPU program kept a whole (S, D) K/V block resident in VMEM
// and walked KV blocks in a sequential grid. Here a (batch*head, q tile)
// pair is one work item: a loop streams its K/V tiles through shared
// memory, carrying the running max m, the denominator l and the (rows, D)
// accumulator in fp32 registers, so no score tile ever reaches device
// memory. Under the causal mask the loop stops at the tile holding the q
// tile's last row, so the items are taken heaviest first (causal work
// grows with the q tile index). One block writes each output row, every
// sum in a fixed order: the same inputs give the same bits on every
// launch.
//
// bf16 (flash_fwd_wgmma_kernel) runs on the Hopper tensor cores, with the
// pieces of hopper.cuh and flash.cuh that K2/K3 (flash_bwd.cu) use:
// - A persistent grid, one block a SM, each block walking items c,
//   c + gridDim.x, ... At S = 1024 an item has 4.5 kv tiles on average
//   under the causal mask, and one block per item exposed each item's
//   first copies, its first and last products and its stores; here the
//   next item's copies run while the consumers finish this one.
// - An item is a 128-row q tile: two consumer warpgroups of 64 rows and a
//   producer warpgroup whose one busy thread issues the TMA copies
//   (setmaxnreg gives its registers to the consumers). The q tile has a
//   full and an empty mbarrier (a consumer warp frees it after its last S
//   product); K and V tiles (128 rows at D <= 64, 64 at D = 128) stream
//   through a ring of 4 stages with a full and an empty mbarrier each, the
//   ring's position carried from item to item. One tensor map per input
//   over its (B, S, H, D) view and strides, so a strided view of a fused
//   qkv projection needs no copy; rows past S read as zero.
// - S = Q K^T is a wgmma with both operands in shared memory, K-major (Q,
//   the loop-invariant operand, is never held in registers). O += P V
//   takes P as the register A operand, rounded to bf16 from S's fp32
//   accumulator, and V read MN-major; l stays the fp32 sum of the
//   unrounded p, reduced across a row's 4 threads once, at the end.
// - Softmax in the log2 domain: t = s * scale * log2(e), p = 2^(t - m) by
//   one FFMA and one ex2.approx (the max is taken over s where scale > 0:
//   no multiply an element); lse = (m + log2(max(l, 1e-30))) * ln 2.
// - Each turn of the loop issues this tile's S, then the last tile's
//   O += P V, as two commit groups, and runs this tile's softmax while
//   the second computes; O is rescaled once that product is done. Every
//   visited tile issues its products on every path: a wgmma under a
//   branch makes ptxas serialize them all.
// - The mask (col >= S, or col > row under causal; set to -1e30, the
//   reference's _NEG_INF, since TMA fills rows past S with zeros, not
//   -inf) runs only on tiles that cross the diagonal or S, in a body
//   compiled apart from the unmasked one.
// - o leaves through a staging tile in shared memory as 16-byte row
//   pieces; rows past S are not written.
// fp32 (flash_fwd_kernel) runs on the CUDA cores in fp32 FMA, to stay
// within 2e-5 of the fp32 reference (TF32 would not): 64-row tiles, 256
// threads as a 16x16 grid, each owning 4 q rows x 4 kv columns of the
// score tile and the same 4 rows x D/16 output columns; row max and sum
// reduce across the 16 threads of a row with warp shuffles; synchronous
// tile loads.
//
// Bound on an H100 SXM at the serving path's shape (B=8, S=1024, H=16,
// D=64, causal, bf16): 2 matmuls x 2 flops x B*H*D*S(S+1)/2 = 17.2 GFLOP,
// 17 us at 989 TFLOP/s (bf16 tensor cores); q, k, v, o = 67 MB, 20 us at
// 3.35 TB/s. Memory sets the bound, about 20 us a launch. Per 128 x 128
// tile at D = 64 the 16,384 exp2 take as many cycles of a SM's 16 MUFU
// lanes (1,024) as the two products take of its tensor cores at their
// peak, so the softmax runs under the products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "flash.cuh"

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
// bf16: wgmma fed by a TMA ring
// ---------------------------------------------------------------------------

using flash::CONSUMERS;
using flash::TILE_ROWS;
using flash::WG_ROWS;
using flash::WG_THREADS;

// K1's shared memory: Q (TILE_ROWS rows), a ring of STAGES (K, V) tiles
// of BK rows, the output's staging tile (TILE_ROWS rows), then the
// barriers. Tiles start on 1024-byte boundaries (the swizzle's repeat).
template <int D>
struct FwdSmem {
  static constexpr int BK = D > 64 ? 64 : 128;     // kv rows a streamed tile
  static constexpr int STAGES = 4;
  using Q = flash::Tile<D, TILE_ROWS>;
  using KV = flash::Tile<D, BK>;
  static constexpr int RING = Q::BYTES;
  static constexpr int STAGE = 2 * KV::BYTES;
  static constexpr int OUT = RING + STAGES * STAGE;
  static constexpr int BARS = OUT + TILE_ROWS * D * 2;   // q full/empty, full[], empty[]
  static constexpr int BYTES = BARS + (2 + 2 * STAGES) * 8 + 1024;
};

// Work item t of a launch: the (batch*head, q tile) pairs ordered with the
// q tile index slower and heaviest first (the last q tiles see the most
// kv tiles under the causal mask), so every head's heaviest tiles come
// before any lighter one.
struct FwdTile {
  int b, h, q0, n_kv;
  __device__ __forceinline__ FwdTile(int t, int BH, int n_qt, int H, int S,
                                     int causal, int bk) {
    const int bh = t % BH;
    b = bh / H;
    h = bh % H;
    q0 = (n_qt - 1 - t / BH) * TILE_ROWS;
    const int kv_end = causal ? min(S, q0 + TILE_ROWS) : S;
    n_kv = (kv_end + bk - 1) / bk;
  }
};

// The online softmax of one score tile, in place: this thread's rows
// row0 (registers 4i + 0, 1) and row0 + 8 (4i + 2, 3), its columns
// col0 + 8i + 2(lane%4) (+1). In the log2 domain, t = s * c2 (c2 = scale
// * log2(e)); where MASK finds the column past S or, under causal, past
// the row, the score is set to NEG_INF. The running maxes m0, m1 of t
// (reduced across the row's 4 threads) move to the tile's, corr0, corr1 =
// 2^(m_old - m_new) rescale this thread's partial sums l0, l1 (and the
// caller's O), and p = 2^(t - m) replaces the score and adds to l. With
// FOLD (c2 > 0) the max is taken over s and t - m is one FFMA, s * c2 -
// m; otherwise t is formed first. A row sees its column 0 in the first
// tile, so m is finite from there on and a masked score gives p = 0.
template <bool MASK, bool FOLD, int N>
__device__ __forceinline__ void softmax_tile(float (&sacc)[N / 2], float& m0,
                                             float& m1, float& l0, float& l1,
                                             float& corr0, float& corr1,
                                             float c2, int col0, int row0,
                                             int S, int causal) {
  const int tq4 = threadIdx.x & 3;
  float mx[4] = {NEG_INF, NEG_INF, NEG_INF, NEG_INF};   // (row, i parity)
#pragma unroll
  for (int i = 0; i < N / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = FOLD ? sacc[4 * i + e] : sacc[4 * i + e] * c2;
      if (MASK) {
        const int col = col0 + 8 * i + 2 * tq4 + (e & 1);
        const int row = row0 + 8 * (e >> 1);
        if (col >= S || (causal && col > row)) x = NEG_INF;
      }
      sacc[4 * i + e] = x;
      float& m = mx[(e >> 1) * 2 + (i & 1)];
      m = fmaxf(m, x);
    }
  float mt0 = flash::quad_max(fmaxf(mx[0], mx[1]));
  float mt1 = flash::quad_max(fmaxf(mx[2], mx[3]));
  if (FOLD) {
    mt0 *= c2;
    mt1 *= c2;
  }
  const float mn0 = fmaxf(m0, mt0), mn1 = fmaxf(m1, mt1);
  corr0 = flash::exp2_ftz(m0 - mn0);
  corr1 = flash::exp2_ftz(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float rs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < N / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float mn = e < 2 ? mn0 : mn1;
      const float x = sacc[4 * i + e];
      const float p = flash::exp2_ftz(FOLD ? fmaf(x, c2, -mn) : x - mn);
      sacc[4 * i + e] = p;
      rs[(e >> 1) * 2 + (i & 1)] += p;
    }
  l0 = fmaf(l0, corr0, rs[0] + rs[1]);
  l1 = fmaf(l1, corr1, rs[2] + rs[3]);
}

// softmax_tile() over the kv tile at k0, with the per-element mask only
// where the tile crosses the diagonal of the warpgroup's rows qw.. or S.
template <int N>
__device__ __forceinline__ void tile_softmax(float (&sacc)[N / 2], float& m0,
                                             float& m1, float& l0, float& l1,
                                             float& corr0, float& corr1,
                                             float c2, int k0, int qw,
                                             int row0, int S, int causal) {
  const bool mask = (causal && k0 + N - 1 > qw) || k0 + N > S;
  if (c2 > 0.f) {
    if (mask)
      softmax_tile<true, true, N>(sacc, m0, m1, l0, l1, corr0, corr1, c2, k0,
                                  row0, S, causal);
    else
      softmax_tile<false, true, N>(sacc, m0, m1, l0, l1, corr0, corr1, c2, k0,
                                   row0, S, causal);
  } else if (mask) {
    softmax_tile<true, false, N>(sacc, m0, m1, l0, l1, corr0, corr1, c2, k0,
                                 row0, S, causal);
  } else {
    softmax_tile<false, false, N>(sacc, m0, m1, l0, l1, corr0, corr1, c2, k0,
                                  row0, S, causal);
  }
}

// K1's S = Q K^T for the kv tile at Kst: warpgroup wg's 64 q rows x BK kv
// columns, one commit group.
template <int D>
__device__ __forceinline__ void fwd_scores(float (&sacc)[FwdSmem<D>::BK / 2],
                                           const uint8_t* Qs, const uint8_t* Kst,
                                           int wg) {
  using L = FwdSmem<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hopper::wgmma_ss<L::BK>(sacc, L::Q::k_desc(Qs, wg * WG_ROWS, kk),
                            L::KV::k_desc(Kst, 0, kk), kk > 0);
  hopper::wgmma_commit();
}

// K1's O += P V for the kv tile whose V is at Vst, kv as the k dimension,
// one commit group.
template <int D>
__device__ __forceinline__ void fwd_pv(float (&oacc)[D / 2],
                                       const uint32_t (&pa)[FwdSmem<D>::BK / 16][4],
                                       const uint8_t* Vst) {
  using L = FwdSmem<D>;
#pragma unroll
  for (int kk = 0; kk < L::BK / 16; ++kk)
    hopper::wgmma_rs<D>(oacc, pa[kk], L::KV::mn_desc(Vst, kk), 1);
  hopper::wgmma_commit();
}

// K1, bf16: a persistent grid; block c takes work items c, c + gridDim.x,
// ... (FwdTile). The producer streams each item's Q and K/V tiles through
// one ring, so the next item's copies run while the consumers finish this
// one; a consumer warp frees Q once its last S product is done.
template <int D>
__global__ void __launch_bounds__(flash::TC_THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                       int B, int S, int H, float scale, int causal) {
  using L = FwdSmem<D>;
  constexpr int BK = L::BK, STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = flash::align_1024(smem_raw);
  uint8_t* Qs = smem;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* q_empty = q_full + 1;
  uint64_t* full = q_full + 2;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int BH = B * H;
  const int n_qt = (S + TILE_ROWS - 1) / TILE_ROWS;
  const int n_items = n_qt * BH;

  if (tid == 0) {
    hopper::mbar_init(q_full, 1);
    hopper::mbar_init(q_empty, flash::CONSUMER_WARPS);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], flash::CONSUMER_WARPS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS * WG_THREADS) {
    // producer warpgroup; one thread streams each item's Q, then its K, V
    // a stage at a time
    hopper::setmaxnreg_dec<flash::PRODUCER_REGS>();
    if (tid == CONSUMERS * WG_THREADS) {
      int it = 0;     // kv tiles streamed so far: the ring's position
      for (int t = blockIdx.x, j = 0; t < n_items; t += gridDim.x, ++j) {
        const FwdTile w(t, BH, n_qt, H, S, causal, BK);
        hopper::mbar_wait(q_empty, (j & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(q_full, L::Q::BYTES);
        L::Q::load(Qs, &tq, q_full, w.h, w.q0, w.b);
        for (int kv = 0; kv < w.n_kv; ++kv, ++it) {
          const int s = it % STAGES;
          hopper::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          uint8_t* st = smem + L::RING + s * L::STAGE;
          hopper::mbar_arrive_expect_tx(&full[s], L::STAGE);
          L::KV::load(st, &tk, &full[s], w.h, kv * BK, w.b);
          L::KV::load(st + L::KV::BYTES, &tv, &full[s], w.h, kv * BK, w.b);
        }
      }
    }
    return;
  }
  hopper::setmaxnreg_inc<flash::CONSUMER_REGS>();

  // consumer warpgroup wg: rows wg * 64.. of each q tile
  const int wg = tid / WG_THREADS;
  const int lane = tid & 31;
  const int wrow = wg * WG_ROWS + ((tid % WG_THREADS) >> 5) * 16 + (lane >> 2);
  const float c2 = scale * flash::LOG2E;
  uint8_t* stage = smem + L::OUT + wg * WG_ROWS * D * 2;

  float sacc[BK / 2], oacc[D / 2];
  uint32_t pa[BK / 16][4];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sacc[i] = 0.f;
  int it = 0;         // kv tiles consumed so far: the ring's position
  for (int t = blockIdx.x, j = 0; t < n_items; t += gridDim.x, ++j) {
    const FwdTile w(t, BH, n_qt, H, S, causal, BK);
    const int qw = w.q0 + wg * WG_ROWS;
    const int row0 = w.q0 + wrow, row1 = row0 + 8;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f, corr0, corr1;

    hopper::mbar_wait(q_full, j & 1);
    // the first kv tile: S, its softmax (O is still zero: no rescale)
    int s = it % STAGES;
    hopper::mbar_wait(&full[s], (it / STAGES) & 1);
    hopper::fence_regs(sacc);
    hopper::wgmma_fence();
    fwd_scores<D>(sacc, Qs, smem + L::RING + s * L::STAGE, wg);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sacc);
    if (w.n_kv == 1) flash::release(q_empty, lane);
    tile_softmax<BK>(sacc, m0, m1, l0, l1, corr0, corr1, c2, 0, qw, row0, S,
                     causal);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) flash::acc_to_a(pa[kk], sacc, kk);

    int prev = s;      // the stage whose V the pending O += P V reads
    ++it;
    for (int kv = 1; kv < w.n_kv; ++kv, ++it) {
      s = it % STAGES;
      const uint8_t* st = smem + L::RING + s * L::STAGE;
      hopper::mbar_wait(&full[s], (it / STAGES) & 1);
      // this tile's S, then the last tile's O += P V: two groups; the
      // softmax of this tile runs while the second computes
      hopper::fence_regs(sacc);
      hopper::fence_regs(oacc);
      hopper::wgmma_fence();
      fwd_scores<D>(sacc, Qs, st, wg);
      fwd_pv<D>(oacc, pa, smem + L::RING + prev * L::STAGE + L::KV::BYTES);
      hopper::wgmma_wait<1>();
      hopper::fence_regs(sacc);
      if (kv == w.n_kv - 1) flash::release(q_empty, lane);
      tile_softmax<BK>(sacc, m0, m1, l0, l1, corr0, corr1, c2, kv * BK, qw,
                       row0, S, causal);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(oacc);
      flash::release(&empty[prev], lane);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        oacc[4 * i + 0] *= corr0;
        oacc[4 * i + 1] *= corr0;
        oacc[4 * i + 2] *= corr1;
        oacc[4 * i + 3] *= corr1;
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) flash::acc_to_a(pa[kk], sacc, kk);
      prev = s;
    }
    // the last tile's O += P V
    hopper::fence_regs(oacc);
    hopper::wgmma_fence();
    fwd_pv<D>(oacc, pa, smem + L::RING + prev * L::STAGE + L::KV::BYTES);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(oacc);
    flash::release(&empty[prev], lane);

    // l over the row's 4 threads; o = O / l, lse = (m + log2 l) ln 2
    const float li0 = fmaxf(flash::quad_sum(l0), 1e-30f);
    const float li1 = fmaxf(flash::quad_sum(l1), 1e-30f);
    const float r0 = 1.f / li0, r1 = 1.f / li1;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      oacc[4 * i + 0] *= r0;
      oacc[4 * i + 1] *= r0;
      oacc[4 * i + 2] *= r1;
      oacc[4 * i + 3] *= r1;
    }
    constexpr float LN2 = 0.6931471805599453f;
    if ((lane & 3) == 0) {
      const long long r = ((long long)w.b * S + row0) * H + w.h;
      if (row0 < S) lse[r] = (m0 + log2f(li0)) * LN2;
      if (row1 < S) lse[r + 8LL * H] = (m1 + log2f(li1)) * LN2;
    }
    // the warpgroup's last item is done with the staging tile
    flash::named_sync(2 + wg, WG_THREADS);
    flash::store_wg<D>(o, stage, oacc, w.b, S, H, w.h, qw, 2 + wg);
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 void* lse, int B, int S, int H, const long long* st,
                 float scale, int causal, cudaStream_t stream) {
  using L = FwdSmem<D>;
  CUtensorMap m[3];
  const void* ptr[3] = {q, k, v};
  const int rows[3] = {TILE_ROWS, L::BK, L::BK};
  if (int err = flash::make_maps<D>(m, 3, ptr, st, rows, B, S, H)) return err;
  if (int err = flash::set_smem(flash_fwd_wgmma_kernel<D>, L::BYTES)) return err;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items = (long long)B * H * ((S + TILE_ROWS - 1) / TILE_ROWS);
  const long long grid = items < sms ? items : sms;    // one block a SM
  flash_fwd_wgmma_kernel<D><<<static_cast<unsigned>(grid), flash::TC_THREADS,
                              L::BYTES, stream>>>(
      m[0], m[1], m[2], static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      B, S, H, scale, causal);
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

int dispatch_wgmma(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int S, int H, int D, const long long* st,
                   float scale, int causal, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_wgmma<32>(q, k, v, o, lse, B, S, H, st, scale, causal, stream);
    case 64: return launch_wgmma<64>(q, k, v, o, lse, B, S, H, st, scale, causal, stream);
    case 128: return launch_wgmma<128>(q, k, v, o, lse, B, S, H, st, scale, causal, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = fp32 (the FMA body), 1 = bf16 (the wgmma body, whose TMA
// copies need 16-byte aligned data and (batch, seq, head) strides in
// multiples of 8 elements). Strides are in elements, (batch, seq, head)
// for each of q, k, v; the head dimension is contiguous. Returns a
// cudaError_t (0 = launched), or TENSOR_MAP_FAILED plus the CUresult
// when a tensor map cannot be made.
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
    return dispatch_wgmma(q, k, v, o, lse, B, S, H, D, st, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* edl_cuda_error_string(int err) {
  if (err >= flash::TENSOR_MAP_FAILED) {
    static thread_local char msg[80];
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed (CUresult %d)",
             err - flash::TENSOR_MAP_FAILED);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Forward flash attention on Hopper (sm_90a): causal and/or sliding window,
// tanh softcap, GQA, ragged lengths.
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py::
// flash_attention (_flash_kernel). Same contract: q (B, H, Tq, dh), k
// (B, Hk, Tk, dh), v (B, Hk, Tk, dv) -> o (B, H, Tq, dv) in q's dtype,
// online softmax in f32, fully masked key tiles never visited, l floored at
// 1e-30. Differences the card asks for: K/V are read by kv head h / (H / Hk)
// (no materialized GQA broadcast), every tensor is addressed through its
// strides (the caller passes head-transposed views without copying), and a
// ragged Tq or Tk is masked here (no Tq % bq == 0 requirement).
//
// What bounds it: the operations. 4 * dh flops per unmasked (query, key)
// pair; at 1k causal, 32 heads, dh = 128 that is 8.6 GFLOP per sequence and
// layer, 8.7 us at the 989 TFLOP/s bf16 tensor-core rate.
//
// Three paths, one contract, chosen by flash_attention/ops.py::fwd_route.
//
// flash_fwd_wgmma (bf16, dh = dv in {64, 80, 128, 256} or MLA's dh = 192
// (nope 128 + rope 64) with dv = 128, 16-byte aligned rows; the main path
// of the served models and of training, gemma2-2b's prefill at 256,
// h2o-danube-1.8b's at 80): Hopper's warpgroup tensor-core products fed by
// TMA, in the structure of FlashAttention-3. Persistent: one block of three
// warpgroups per SM takes work tiles (128 query rows of one batch * head)
// in the order of a walk that keeps a group of heads' K/V in L2 and runs
// each group's heaviest tiles first, claiming the next tile from an atomic
// counter as it frees up. A producer warpgroup (one thread issues TMA; its
// registers go to the consumers by setmaxnreg) loads each tile's Q and
// keeps a ring of 128-key K/V tiles in flight (3 stages at dh <= 128, 2 at
// MLA's 192: fwd_stages; 64-key tiles in 2 stages at dv 256, where the
// output accumulator alone takes 128 registers a thread: fwd_kn), reading the caller's strided (d, T, heads, B)
// views through 4-D tensor maps (MLA's V is the slice 256 bytes into each
// (nope + v) row; TMA zero-fills the ragged T edge), with full and empty
// mbarriers per stage and for Q, so the next tile's loads run under the
// current tile's last products and its output stores. Each of two consumer
// warpgroups owns 64 query rows: S = Q K^T by wgmma m64n128k16 from shared
// memory (both K-major), the online softmax on the accumulators in f32
// (scale * log2 e folded into the exponent's FFMA, one exp2 per score; the
// mask and the softcap's tanh in separate instances of the pass, the mask
// only on tiles that cut the causal or window band or the Tk edge; l summed
// per thread and reduced once at the end), then O += P V by wgmma with P
// rounded to bf16 in registers as the A operand and V read MN-major through
// the descriptor's transpose bit: no transposed copy. The P V products stay
// in flight while the next tile's S products are issued behind them. Key
// tiles outside a warpgroup's band are not computed; a block visits only
// the tiles its rows can see. dh = dv = 80 runs the (128, 128) instance:
// its tensor maps give the head dim as 80, so the second 64-column box of
// each Q, K and V row reads columns 64-79 and TMA zero-fills 80-127; the
// zero columns add exact zeros to S and give zero output columns, which
// the store leaves out (it writes the caller's dv columns of each row: a
// wider store would write into the next head of a head-transposed view).
// The padding costs 128 / 80 = 1.6x the products. Shared memory: FwdSmem
// (230,472 bytes at dh 128 and 80, 214,072 at 192, 197,688 at 256), one
// block per SM. Where it stands (PERF.md §6, on an H100 at 700 W): 2.8x
// its operations bound at the serving shape, 2.2x with lse at the training
// shape, 1.2-1.3x scaled_dot_product_attention; at dh 80 3.1x its bound
// and 1.2x SDPA.
// What is left: no ping-pong between the two consumers and no second S
// tile to overlap a warpgroup's softmax with its own products (232
// registers a thread hold one), and the output leaves by 4-byte stores,
// not TMA.
//
// flash_fwd_mma (bf16, dh = dv in {16, 32}: test-sized models): mma.sync
// m16n8k16 as in FlashAttention-2. One block of 4 warps per (64-row query
// tile, batch * head); each warp owns 16 query rows, keeps its Q fragments,
// the scores of a 64-key tile, the output accumulator and the running
// (m, l) of its rows in registers; K row-major and V transposed in shared
// memory, padded against bank conflicts.
//
// flash_fwd_kernel (f32, and any other head dims or unaligned rows: dh <=
// 256, dv <= 256): CUDA cores in f32. One block of 256 threads per (64-row
// query tile, batch * head) loops over 32-key tiles; each thread owns a
// 4 x 2 tile of scores and a 4 x NC slice of the output (NC 8 up to dv 128,
// 16 above), with Q, K, V in shared memory (rows padded to dh + 1 floats).
//
// All run the query tiles heaviest first and visit only the key tiles
// between the first key the window allows and the last key causality
// allows.
//
// Training also asks for lse (B, H, Tq) f32, the residual of the backward
// (flash_attention_bwd.cu). It replaces repro/kernels/flash_attention/
// flash_attention_bwd.py::flash_attention_fwd_lse, which gets lse from a
// second O(T^2) pass; here each row writes m + log(max(l, 1e-30)) from its
// own running (m, l), with m taken as 0 for a row with no live key (as
// repro/models/attention.py::_attend_fwd). Serving passes a null lse and
// launches what it launched before.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"
#include "mma.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr int BQ = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int MAXDQK = 256;   // q/k head dim limit (f32 path: dynamic smem)
constexpr int MAXDV = 256;    // v head dim limit (acc: NC x 16 columns)
constexpr int SP = BK + 1;   // padded score row

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {
  long long b, h, t;
};

template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Strides qs,
                 Strides ks, Strides vs, Strides os, int H, int group, int Tq,
                 int Tk, int dh, int dv, float scale, int causal, int window,
                 float softcap) {
  extern __shared__ float smem[];
  const int dhp = dh + 1;
  float* Qs = smem;                 // BQ x dhp
  float* Ks = Qs + BQ * dhp;        // BK x dhp
  float* Vs = Ks + BK * dhp;        // BK x dv
  float* Ss = Vs + BK * dv;         // BQ x SP
  float* m_s = Ss + BQ * SP;        // BQ
  float* l_s = m_s + BQ;            // BQ
  float* c_s = l_s + BQ;            // BQ

  const int tid = threadIdx.x;
  const int qi = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H, hk = h / group;
  const int q0 = qi * BQ;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  T* ob = o + b * os.b + h * os.h;

  for (int idx = tid; idx < BQ * dh; idx += THREADS) {
    const int r = idx / dh, d = idx % dh, row = q0 + r;
    Qs[r * dhp + d] = row < Tq ? to_f(qb[row * qs.t + d]) * scale : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }

  const int tx = tid % 16, ty = tid / 16;
  float acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;

  const int q1 = min(q0 + BQ, Tq) - 1;          // last query row of the tile
  const int k_lo = window ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(Tk - 1, q1) : Tk - 1;
  for (int k0 = (k_lo / BK) * BK; k0 <= k_hi; k0 += BK) {
    __syncthreads();                            // previous tile consumed
    for (int idx = tid; idx < BK * dh; idx += THREADS) {
      const int r = idx / dh, d = idx % dh, key = k0 + r;
      Ks[r * dhp + d] = key < Tk ? to_f(kb[key * ks.t + d]) : 0.f;
    }
    for (int idx = tid; idx < BK * dv; idx += THREADS) {
      const int r = idx / dv, d = idx % dv, key = k0 + r;
      Vs[r * dv + d] = key < Tk ? to_f(vb[key * vs.t + d]) : 0.f;
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int r = 0; r < 4; ++r) s[r][0] = s[r][1] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float qv[4], kv[2];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = Qs[(ty + 16 * r) * dhp + d];
#pragma unroll
      for (int c = 0; c < 2; ++c) kv[c] = Ks[(tx + 16 * c) * dhp + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) s[r][c] += qv[r] * kv[c];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int row = q0 + ty + 16 * r, key = k0 + tx + 16 * c;
        float x = s[r][c];
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        const bool ok = row < Tq && key < Tk && (!causal || key <= row) &&
                        (!window || key > row - window);
        Ss[(ty + 16 * r) * SP + tx + 16 * c] = ok ? x : NEG;
      }
    }
    __syncthreads();

    {  // online softmax, four threads per row (adjacent lanes of one warp)
      const int r = tid / 4, part = tid % 4;
      float* srow = Ss + r * SP;
      float mx = NEG;
      for (int j = part; j < BK; j += 4) mx = fmaxf(mx, srow[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float m_safe = m_new <= NEG / 2 ? 0.f : m_new;
      float sum = 0.f;
      for (int j = part; j < BK; j += 4) {
        const float x = srow[j];
        const float p = x <= NEG / 2 ? 0.f : expf(x - m_safe);
        srow[j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = expf((m_old <= NEG / 2 ? NEG : m_old) - m_safe);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float corr = c_s[ty + 16 * r];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= corr;
    }
    for (int j = 0; j < BK; ++j) {
      float pv[4], vv[NC];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = Ss[(ty + 16 * r) * SP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        vv[c] = col < dv ? Vs[j * dv + col] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] += pv[r] * vv[c];
    }
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row >= Tq) continue;
    const float inv = 1.f / fmaxf(l_s[ty + 16 * r], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < dv) ob[row * os.t + col] = from_f<T>(acc[r][c] * inv);
    }
  }
  if (lse != nullptr && tid < BQ && q0 + tid < Tq) {
    const float m = m_s[tid];
    lse[(long long)blockIdx.y * Tq + q0 + tid] =
        (m <= NEG / 2 ? 0.f : m) + logf(fmaxf(l_s[tid], 1e-30f));
  }
}

// ------------------------------------------- mma.sync bf16 path (dh 16, 32)
constexpr int MQ = 64;        // query rows per block (16 per warp)
constexpr int MK = 64;        // keys per tile
constexpr int MTHREADS = 128;

template <int DH, int DV>
__global__ void __launch_bounds__(MTHREADS)
flash_fwd_mma(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
              Strides qs, Strides ks, Strides vs, Strides os, int H,
              int group, int Tq, int Tk, float scale, int causal, int window,
              float softcap) {
  constexpr int KP = DH + 8;      // padded K row (bf16)
  constexpr int VP = MK + 8;      // padded V^T row (bf16)
  __shared__ __align__(16) __nv_bfloat16 Ks[MK][KP];
  __shared__ __align__(16) __nv_bfloat16 Vt[DV][VP];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tg = lane & 3;     // fragment row / column pair
  const int qi = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H, hk = h / group;
  const int q0 = qi * MQ;
  const int rows[2] = {q0 + warp * 16 + gq, q0 + warp * 16 + gq + 8};
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + hk * vs.h;
  __nv_bfloat16* ob = o + b * os.b + h * os.h;

  uint32_t qf[DH / 16][4];                     // A fragments of Q
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = rows[r & 1], col = kk * 16 + tg * 2 + (r >> 1) * 8;
      qf[kk][r] = row < Tq ? *reinterpret_cast<const uint32_t*>(
                                 qb + row * qs.t + col)
                           : 0u;
    }
  }
  float oacc[DV / 8][4];
#pragma unroll
  for (int j = 0; j < DV / 8; ++j)
    oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;
  float mrow[2] = {NEG, NEG}, lrow[2] = {0.f, 0.f};

  const int q1 = min(q0 + MQ, Tq) - 1;
  const int k_lo = window ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(Tk - 1, q1) : Tk - 1;
  for (int k0 = (k_lo / MK) * MK; k0 <= k_hi; k0 += MK) {
    __syncthreads();                           // previous tile consumed
    for (int idx = tid; idx < MK * DH / 8; idx += MTHREADS) {
      const int r = idx / (DH / 8), c = (idx % (DH / 8)) * 8, key = k0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (key < Tk)
        val = *reinterpret_cast<const uint4*>(kb + key * ks.t + c);
      *reinterpret_cast<uint4*>(&Ks[r][c]) = val;
    }
    for (int idx = tid; idx < MK * DV / 8; idx += MTHREADS) {
      const int r = idx % MK, c = (idx / MK) * 8, key = k0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (key < Tk)
        val = *reinterpret_cast<const uint4*>(vb + key * vs.t + c);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) Vt[c + i][r] = e[i];
    }
    __syncthreads();

    float sacc[MK / 8][4];
#pragma unroll
    for (int j = 0; j < MK / 8; ++j)
      sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < MK / 8; ++j) {
        const __nv_bfloat16* kr = &Ks[j * 8 + gq][kk * 16 + tg * 2];
        mma_bf16(sacc[j], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {           // rows gq and gq + 8
      const int row = rows[rr];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < MK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + j * 8 + tg * 2 + e;
          float x = sacc[j][2 * rr + e] * scale;
          if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
          const bool ok = row < Tq && key < Tk && (!causal || key <= row) &&
                          (!window || key > row - window);
          x = ok ? x : NEG;
          sacc[j][2 * rr + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(mrow[rr], mx);
      const float m_safe = m_new <= NEG / 2 ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < MK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = sacc[j][2 * rr + e];
          const float p = x <= NEG / 2 ? 0.f : expf(x - m_safe);
          sacc[j][2 * rr + e] = p;
          sum += p;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float corr =
          expf((mrow[rr] <= NEG / 2 ? NEG : mrow[rr]) - m_safe);
      lrow[rr] = lrow[rr] * corr + sum;
      mrow[rr] = m_new;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        oacc[j][2 * rr] *= corr;
        oacc[j][2 * rr + 1] *= corr;
      }
    }

#pragma unroll
    for (int kk = 0; kk < MK / 16; ++kk) {     // P (C layout) as A fragments
      const uint32_t pa[4] = {
          pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]),
          pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]),
          pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]),
          pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        const __nv_bfloat16* vr = &Vt[j * 8 + gq][kk * 16 + tg * 2];
        mma_bf16(oacc[j], pa, *reinterpret_cast<const uint32_t*>(vr),
                 *reinterpret_cast<const uint32_t*>(vr + 8));
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = rows[rr];
    if (row >= Tq) continue;
    const float inv = 1.f / fmaxf(lrow[rr], 1e-30f);
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(ob + row * os.t + j * 8 + tg * 2) =
          __floats2bfloat162_rn(oacc[j][2 * rr] * inv,
                                oacc[j][2 * rr + 1] * inv);
    }
    if (lse != nullptr && tg == 0)   // the quad agrees on (m, l) of its row
      lse[(long long)blockIdx.y * Tq + row] =
          (mrow[rr] <= NEG / 2 ? 0.f : mrow[rr]) +
          logf(fmaxf(lrow[rr], 1e-30f));
  }
}

// ------------------------------------------- wgmma + TMA bf16 path
constexpr int WQ = 128;          // query rows per work tile: 2 warpgroups
constexpr int WK = 128;          // keys per K/V tile (64 at dv 256: fwd_kn)
constexpr int WCONSUMERS = 256;  // threads of the two consumer warpgroups
constexpr int WTHREADS = WCONSUMERS + 128;  // + the producer warpgroup
// Registers per thread after the split (setmaxnreg): 128 x 40 + 256 x 232
// <= 65,536
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Keys per K/V tile (flash_attention/ops.py::fwd_kn): WK, and 64 at dv 256,
// where the output accumulator alone takes 128 registers a thread and a
// 64-key tile keeps the scores and P at 32 and 16.
constexpr int fwd_kn(int dv) { return dv > 128 ? 64 : WK; }

// Shared memory of one block (flash_attention/ops.py::fwd_smem_bytes): Q
// (WQ x dh), a ring of K (kn x dh) and V (kn x dv) tiles, the barriers (Q
// full and empty, and full and empty per stage), the current work tile's
// index (8 bytes), and the 1024-byte alignment. The ring has 3 stages where
// they fit in the 227 KiB a block may use, else 2
// (flash_attention/ops.py::fwd_stages).
constexpr int fwd_bytes(int dh, int dv, int stages) {
  return SMEM_ALIGN + WQ * dh * 2 + stages * fwd_kn(dv) * (dh + dv) * 2 +
         8 * (3 + 2 * stages);
}

template <int DH, int DV>
struct FwdSmem {
  static constexpr int stages = fwd_bytes(DH, DV, 3) <= SMEM_LIMIT ? 3 : 2;
  static constexpr int kn = fwd_kn(DV);
  static constexpr int q = WQ * DH * 2;
  static constexpr int k = kn * DH * 2;
  static constexpr int stage = k + kn * DV * 2;
  static constexpr int bytes = fwd_bytes(DH, DV, stages);
};
static_assert(FwdSmem<64, 64>::bytes == 115784, "fwd_smem_bytes(64, 64)");
static_assert(FwdSmem<128, 128>::bytes == 230472,
              "fwd_smem_bytes(128, 128)");
static_assert(FwdSmem<192, 128>::bytes == 214072,
              "fwd_smem_bytes(192, 128)");
static_assert(FwdSmem<256, 256>::bytes == 197688,
              "fwd_smem_bytes(256, 256)");

// A work tile: WQ query rows of one (batch, head) and the key tiles
// [t0, t0 + nt) they can see. The walk takes the (batch, head)s in groups
// of `gsize` (about two waves of work tiles: a group's K/V stay in L2
// while its tiles run) and, within a group, the query tiles heaviest first
// (the last causal rows see the most keys): every head of the group's last
// tile, then of the one before. Blocks take the walk's tiles in order as
// they free up (an atomic counter), so the light tiles fill the gaps.
struct FwdTile {
  int b, h, q0, t0, nt;
};

__device__ __forceinline__ FwdTile fwd_tile(int p, int B, int H, int Tq,
                                            int Tk, int causal, int window,
                                            int gsize, int kn) {
  const int nq = (Tq + WQ - 1) / WQ;
  const int g = p / (gsize * nq), rem = p - g * gsize * nq;
  const int size = min(gsize, B * H - g * gsize);
  const int bh = g * gsize + rem % size;
  FwdTile f;
  f.b = bh / H;
  f.h = bh % H;
  f.q0 = (nq - 1 - rem / size) * WQ;
  const int q1 = min(f.q0 + WQ, Tq) - 1;
  const int k_lo = window ? max(0, f.q0 - window + 1) : 0;
  const int k_hi = causal ? min(Tk - 1, q1) : Tk - 1;
  f.t0 = k_lo / kn;
  f.nt = k_hi >= f.t0 * kn ? (k_hi - f.t0 * kn) / kn + 1 : 0;
  return f;
}

// The keys a row may see: key < Tk, key <= row if causal, key > row -
// window if windowed. key0: this thread's first key of the tile.
struct Band {
  int row0, row1, key0, Tk, causal, window;
  __device__ __forceinline__ bool live(int row, int key) const {
    return key < Tk && (!causal || key <= row) &&
           (!window || key > row - window);
  }
};

// A tile's scores (64 x N per warpgroup, the wgmma accumulator layout)
// ready for the exponent, and their row maxima mx (rows lane / 4 and + 8 of
// the warp's 16). CAP: softcap * tanh(scale * s / softcap) in log2 units
// (sl2 = scale / softcap, cap2 = softcap * log2 e); else the raw scores
// (the caller scales). MASK: keys outside the band become NEG.
template <bool CAP, bool MASK, int N>
__device__ __forceinline__ void tile_scores(float* sacc, float* mx,
                                            float sl2, float cap2,
                                            const Band& band) {
  mx[0] = mx[1] = NEG;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x = sacc[4 * j + i];
      if (CAP) x = tanhf(x * sl2) * cap2;
      if (MASK && !band.live(i < 2 ? band.row0 : band.row1,
                             band.key0 + 8 * j + (i & 1)))
        x = NEG;
      sacc[4 * j + i] = x;
      mx[i >> 1] = fmaxf(mx[i >> 1], x);
    }
  }
}

// Persistent: one block per SM. Its first work tile is blockIdx.x; the
// producer claims each next one from `counter` (0 at launch) and loads its
// Q and K/V while the consumers finish and write the current one. It
// publishes the tile's index in shared memory (`tile`) before its arrival
// on q_full; an index past the last tile ends the consumers' loop. Maps
// over (d, T, heads, B) of q, k and v (d the caller's head dim, zero-filled
// to DH); o and lse are written from the accumulators, o's first dv_out
// columns of each row (a multiple of 8, at most DV).
template <int DH, int DV>
__global__ void __launch_bounds__(WTHREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                Strides os, int dv_out, int B, int H, int group, int Tq,
                int Tk, float scale, int causal, int window, float softcap,
                int gsize, int* __restrict__ counter) {
  using SM = FwdSmem<DH, DV>;
  constexpr int S = SM::stages;
  constexpr int KN = SM::kn;     // keys per K/V tile
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = smem_base(smem_raw);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(sm);
  uint8_t* ring = sm + SM::q;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + S * SM::stage);
  uint64_t* q_empty = q_full + 1;
  uint64_t* full = q_full + 2;
  uint64_t* empty = full + S;
  volatile int* tile = reinterpret_cast<volatile int*>(empty + S);
  const int n_work = B * H * ((Tq + WQ - 1) / WQ);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, WCONSUMERS);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WCONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= WCONSUMERS) {       // the producer: one thread issues TMA
    reg_dealloc<PRODUCER_REGS>();
    if (tid == WCONSUMERS) {
      int it = 0;                // K/V tiles so far
      int p = blockIdx.x;        // the first wave by block, then claimed
      for (int wi = 0;; ++wi) {
        if (wi > 0) mbar_wait(q_empty, (wi - 1) & 1);
        *tile = p;               // published by the arrival on q_full
        if (p >= n_work) {
          mbar_arrive(q_full);
          break;
        }
        const FwdTile f =
            fwd_tile(p, B, H, Tq, Tk, causal, window, gsize, KN);
        const int hk = f.h / group;
        mbar_expect_tx(q_full, SM::q);
#pragma unroll
        for (int c = 0; c < DH / 64; ++c)
          tma_load(Qs + c * WQ * 64, &tq, q_full, c * 64, f.q0, f.h, f.b);
        for (int t = 0; t < f.nt; ++t, ++it) {
          const int s = it % S;
          if (it >= S) mbar_wait(&empty[s], (it / S - 1) & 1);
          __nv_bfloat16* Ks =
              reinterpret_cast<__nv_bfloat16*>(ring + s * SM::stage);
          __nv_bfloat16* Vs = Ks + SM::k / 2;
          const int k0 = (f.t0 + t) * KN;
          mbar_expect_tx(&full[s], SM::stage);
#pragma unroll
          for (int c = 0; c < DH / 64; ++c)
            tma_load(Ks + c * KN * 64, &tk, &full[s], c * 64, k0, hk, f.b);
#pragma unroll
          for (int c = 0; c < DV / 64; ++c)
            tma_load(Vs + c * KN * 64, &tv, &full[s], c * 64, k0, hk, f.b);
        }
        p = gridDim.x + atomicAdd(counter, 1);
      }
    }
  } else {
    // a consumer warpgroup: 64 query rows of each work tile, each warp 16
    reg_alloc<CONSUMER_REGS>();
    const int wg = warp >> 2, wl = warp & 3, gq = lane >> 2, tg = lane & 3;
    const float sl2 = softcap > 0.f ? scale / softcap : scale * LOG2E;
    const float cap2 = softcap * LOG2E;
    float oacc[DV / 2], sacc[KN / 2];
    uint32_t pa[KN / 16][4];
    int it = 0;
    for (int wi = 0;; ++wi) {
      mbar_wait(q_full, wi & 1);
      const int p = *tile;
      if (p >= n_work) break;
      const FwdTile f =
          fwd_tile(p, B, H, Tq, Tk, causal, window, gsize, KN);
      const int r0 = f.q0 + 64 * wg;
      const int r1 = min(r0 + 63, Tq - 1);
      const int rows[2] = {r0 + 16 * wl + gq, r0 + 16 * wl + gq + 8};
      const int w_lo = window ? max(0, r0 - window + 1) : 0;
      const int w_hi = causal ? min(Tk - 1, r1) : Tk - 1;
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) oacc[i] = 0.f;
      float mrow[2] = {NEG, NEG}, lrow[2] = {0.f, 0.f};  // l: this thread's
      int pending = -1;      // the stage whose P V products are in flight

      for (int t = 0; t < f.nt; ++t, ++it) {
        const int s = it % S;
        const int k0 = (f.t0 + t) * KN;
        const __nv_bfloat16* Ks =
            reinterpret_cast<const __nv_bfloat16*>(ring + s * SM::stage);
        const __nv_bfloat16* Vs = Ks + SM::k / 2;
        mbar_wait(&full[s], (it / S) & 1);
        if (!(r0 < Tq && k0 <= w_hi && k0 + KN - 1 >= w_lo)) {
          if (pending >= 0) {                   // outside this band
            wg_wait<0>();
            reg_fence<DV / 2>(oacc);
            reg_fence<KN / 4>(&pa[0][0]);
            mbar_arrive(&empty[pending]);
            pending = -1;
          }
          mbar_arrive(&empty[s]);
          if (t == f.nt - 1) mbar_arrive(q_empty);
          continue;
        }
        // S = Q K^T, both K-major, issued behind the previous tile's P V
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          const int c = kk / 4, k4 = (kk % 4) * 16;
          WgmmaSS<KN>::template run<0, 0>(
              sacc, sw128_desc(Qs + c * WQ * 64 + 64 * wg * 64 + k4, 16, 1024),
              sw128_desc(Ks + c * KN * 64 + k4, 16, 1024), kk > 0);
        }
        wg_commit();
        wg_wait<0>();
        reg_fence<KN / 2>(sacc);
        reg_fence<DV / 2>(oacc);
        reg_fence<KN / 4>(&pa[0][0]);
        if (pending >= 0) mbar_arrive(&empty[pending]);
        if (t == f.nt - 1) mbar_arrive(q_empty);

        // online softmax in log2 units; the mask only where the tile cuts an
        // edge of the causal or window band or of Tk
        const bool masked = k0 + KN > Tk || (causal && k0 + KN - 1 > r0) ||
                            (window && k0 <= r1 - window);
        float mx[2];
        const Band band{rows[0], rows[1], k0 + 2 * tg, Tk, causal, window};
        if (softcap > 0.f) {
          if (masked)
            tile_scores<true, true, KN>(sacc, mx, sl2, cap2, band);
          else
            tile_scores<true, false, KN>(sacc, mx, sl2, cap2, band);
        } else if (masked) {
          tile_scores<false, true, KN>(sacc, mx, sl2, cap2, band);
        } else {
          tile_scores<false, false, KN>(sacc, mx, sl2, cap2, band);
        }
        // without a softcap the scores stay raw: scale * log2 e enters the
        // exponent's FFMA, and the maxima are scaled here
        const float xs = softcap > 0.f ? 1.f : sl2;
        float msafe[2];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
          mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
          const float m_new =
              fmaxf(mrow[rr], mx[rr] <= NEG / 2 ? NEG : mx[rr] * xs);
          msafe[rr] = m_new <= NEG / 2 ? 0.f : m_new;
          const float corr = exp2f(mrow[rr] - msafe[rr]);
          mrow[rr] = m_new;
          lrow[rr] *= corr;
#pragma unroll
          for (int j = 0; j < DV / 8; ++j) {
            oacc[4 * j + 2 * rr] *= corr;
            oacc[4 * j + 2 * rr + 1] *= corr;
          }
        }
#pragma unroll
        for (int j = 0; j < KN / 8; ++j) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = exp2f(fmaf(sacc[4 * j + i], xs, -msafe[i >> 1]));
            sacc[4 * j + i] = p;
            lrow[i >> 1] += p;
          }
        }
        // P as the A operand from registers (the accumulator layout is
        // mma.sync's A fragment layout), V MN-major: no transposed copy.
        // Left in flight: the next tile's S products queue behind them.
#pragma unroll
        for (int kk = 0; kk < KN / 16; ++kk) {
          pa[kk][0] = pack_bf16(sacc[8 * kk], sacc[8 * kk + 1]);
          pa[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
          pa[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
          pa[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
        }
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < KN / 16; ++kk)
          WgmmaRS<DV>::template run<1>(
              oacc, pa[kk], sw128_desc(Vs + kk * 16 * 64, KN * 128, 1024),
              1);
        wg_commit();
        pending = s;
      }
      wg_wait<0>();
      reg_fence<DV / 2>(oacc);
      reg_fence<KN / 4>(&pa[0][0]);
      if (pending >= 0) mbar_arrive(&empty[pending]);
      if (f.nt == 0) mbar_arrive(q_empty);

#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float l = lrow[rr];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const int row = rows[rr];
        if (row >= Tq) continue;
        const float inv = 1.f / fmaxf(l, 1e-30f);
        __nv_bfloat16* orow = o + f.b * os.b + f.h * os.h + row * os.t;
#pragma unroll
        for (int j = 0; j < DV / 8; ++j)
          if (8 * j < dv_out)
            *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * tg) =
                __floats2bfloat162_rn(oacc[4 * j + 2 * rr] * inv,
                                      oacc[4 * j + 2 * rr + 1] * inv);
        if (lse != nullptr && tg == 0)
          lse[((long long)f.b * H + f.h) * Tq + row] =
              (mrow[rr] <= NEG / 2 ? 0.f : mrow[rr] * LN2) +
              logf(fmaxf(l, 1e-30f));
      }
    }
  }
}

// The instance (DH, DV) computes a call of head dims (dh, dv) <= (DH, DV):
// the maps give the caller's dims, and TMA zero-fills the rest of each
// tile row.
template <int DH, int DV>
cudaError_t launch_wgmma(int device, int* counter, const void* q,
                         const void* k, const void* v, void* o, float* lse,
                         Strides qs, Strides ks, Strides vs, Strides os,
                         int B, int H, int Hk, int Tq, int Tk, int dh,
                         int dv, float scale, int causal, int window,
                         float softcap, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  const int box_q[4] = {64, WQ, 1, 1};
  const int box_kv[4] = {64, FwdSmem<DH, DV>::kn, 1, 1};
  const long long mq[4] = {dh, Tq, H, B}, sq[3] = {qs.t, qs.h, qs.b};
  const long long mk[4] = {dh, Tk, Hk, B}, sk[3] = {ks.t, ks.h, ks.b};
  const long long mv[4] = {dv, Tk, Hk, B}, sv[3] = {vs.t, vs.h, vs.b};
  cudaError_t err = make_map(&tq, q, 4, mq, sq, box_q);
  if (err == cudaSuccess) err = make_map(&tk, k, 4, mk, sk, box_kv);
  if (err == cudaSuccess) err = make_map(&tv, v, 4, mv, sv, box_kv);
  if (err != cudaSuccess) return err;
  constexpr int smem = FwdSmem<DH, DV>::bytes;
  err = cudaFuncSetAttribute(flash_fwd_wgmma<DH, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const int nq = (Tq + WQ - 1) / WQ;
  const long long n_work = (long long)B * H * nq;
  if (n_work + 2LL * sm_count(device) > 0x7fffffff)
    return cudaErrorInvalidValue;
  const int grid = (int)std::min<long long>(n_work, sm_count(device));
  const int gsize = std::min(B * H, std::max(1, 2 * grid / nq));
  flash_fwd_wgmma<DH, DV><<<grid, WTHREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, os, dv, B, H, H / Hk,
      Tq, Tk, scale, causal, window, softcap, gsize, counter);
  return cudaGetLastError();
}

template <int DH, int DV>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       float* lse, Strides qs, Strides ks, Strides vs,
                       Strides os, int B, int H, int Hk, int Tq, int Tk,
                       float scale, int causal, int window, float softcap,
                       cudaStream_t stream) {
  dim3 grid((Tq + MQ - 1) / MQ, B * H);
  flash_fwd_mma<DH, DV><<<grid, MTHREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, qs, ks, vs, os, H, H / Hk, Tq, Tk, scale, causal, window,
      softcap);
  return cudaGetLastError();
}

bool aligned16(const void* p, Strides s) {
  return (uintptr_t)p % 16 == 0 && s.b % 8 == 0 && s.h % 8 == 0 &&
         s.t % 8 == 0;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, Strides qs, Strides ks, Strides vs, Strides os,
                   int B, int H, int Hk, int Tq, int Tk, int dh, int dv,
                   float scale, int causal, int window, float softcap,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)(BQ + BK) * (dh + 1) + (size_t)BK * dv + BQ * SP + 3 * BQ);
  auto kernel = dv > 128 ? flash_fwd_kernel<T, 16> : flash_fwd_kernel<T, 8>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BQ - 1) / BQ, B * H);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, qs, ks, vs, os, H,
      H / Hk, Tq, Tk, dh, dv, scale, causal, window, softcap);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o). route (the pure
// function flash_attention/ops.py::fwd_route): 0 = CUDA cores, any dims;
// 1 = mma.sync, bf16, dh = dv in {16, 32}; 2 = wgmma and TMA, bf16, (dh, dv)
// in {(64, 64), (80, 80), (128, 128), (256, 256), (192, 128)} ((80, 80) on
// the (128, 128) instance, zero-filled); routes 1 and 2 need
// 16-byte aligned rows (every pointer and stride a multiple of 8 elements).
// Strides are in elements, the last dim of every tensor is contiguous. lse,
// when not null, is a contiguous (B, H, Tq) float32 output. counter: route
// 2's work-tile claims, one int32 on the device set to 0 (unused by the
// other routes). Returns the CUDA error of the launch (0 = success).
int flash_attention_fwd(int device, int dtype, int route, const void* q,
                        const void* k, const void* v, void* o, void* lse_out,
                        void* counter, long long qsb, long long qsh,
                        long long qst, long long ksb, long long ksh,
                        long long kst,
                        long long vsb, long long vsh, long long vst,
                        long long osb, long long osh, long long ost, int B,
                        int H, int Hk, int Tq, int Tk, int dh, int dv,
                        float scale, int causal, int window, float softcap,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (dh < 1 || dh > MAXDQK || dv < 1 || dv > MAXDV || Hk < 1 ||
      H % Hk || Tq < 1 || Tk < 1 || B < 1 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qsh, qst}, ks{ksb, ksh, kst}, vs{vsb, vsh, vst},
      os{osb, osh, ost};
  const bool aligned = aligned16(q, qs) && aligned16(k, ks) &&
                       aligned16(v, vs) && aligned16(o, os);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
  if (route == 0 && dtype == 0)
    err = launch<float>(q, k, v, o, lse, qs, ks, vs, os, B, H, Hk, Tq, Tk,
                        dh, dv, scale, causal, window, softcap, st);
  else if (route == 0)
    err = launch<__nv_bfloat16>(q, k, v, o, lse, qs, ks, vs, os, B, H, Hk,
                                Tq, Tk, dh, dv, scale, causal, window,
                                softcap, st);
  else if (route == 1 && dtype == 1 && aligned && dh == dv &&
           (dh == 16 || dh == 32))
    err = (dh == 16 ? launch_mma<16, 16> : launch_mma<32, 32>)(
        q, k, v, o, lse, qs, ks, vs, os, B, H, Hk, Tq, Tk, scale, causal,
        window, softcap, st);
  else if (route == 2 && dtype == 1 && aligned && counter != nullptr &&
           ((dh == dv && (dh == 64 || dh == 80 || dh == 128 || dh == 256)) ||
            (dh == 192 && dv == 128)))
    err = (dh == 64    ? launch_wgmma<64, 64>
           : dh <= 128 ? launch_wgmma<128, 128>     // 80: zero-filled to 128
           : dh == 256 ? launch_wgmma<256, 256>
                       : launch_wgmma<192, 128>)(   // MLA: nope + rope, v
        device, static_cast<int*>(counter), q, k, v, o, lse, qs, ks, vs, os,
        B, H, Hk, Tq, Tk, dh, dv, scale, causal, window, softcap, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

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
// Two paths, one contract.
//
// flash_fwd_mma (bf16, dh == dv in {16, 32, 64, 128} or MLA's dh = 192 (nope
// 128 + rope 64) with dv = 128, 16-byte aligned rows; the main path of both
// served models): the tensor cores through mma.sync m16n8k16 (bf16 in, f32
// accumulate), as in FlashAttention-2. One block of 4 warps per (64-row
// query tile, batch * head); each warp owns 16 query rows, keeps its Q
// fragments, the scores of a 64-key tile, the output accumulator and the
// running (m, l) of its rows in registers. K is staged in shared memory
// row-major and V transposed, both padded so the fragment loads of a warp
// hit 32 distinct banks. The probabilities go back into the tensor cores as
// bf16 (the row sums l stay f32). Not yet used: wgmma, TMA, a pipelined
// ring of K/V tiles, warp specialisation.
//
// flash_fwd_kernel (f32, and any other head dims: dh <= 256, dv <= 128):
// CUDA cores in f32. One block of 256 threads per (64-row query tile,
// batch * head) loops over 32-key tiles; each thread owns a 4 x 2 tile of
// scores and a 4 x 8 slice of the output, with Q, K, V in shared memory
// (rows padded to dh + 1 floats).
//
// Both run the query tiles in reverse so the longest causal rows start
// first, and visit only the key tiles between the first key the window
// allows and the last key causality allows.
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

namespace {

constexpr float NEG = -1e30f;
constexpr int BQ = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int MAXDQK = 256;   // q/k head dim limit (f32 path: dynamic smem)
constexpr int MAXDV = 128;    // v head dim limit (acc covers 8 x 16 columns)
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

template <typename T>
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
  float acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

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
      for (int c = 0; c < 8; ++c) acc[r][c] *= corr;
    }
    for (int j = 0; j < BK; ++j) {
      float pv[4], vv[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = Ss[(ty + 16 * r) * SP + j];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = tx + 16 * c;
        vv[c] = col < dv ? Vs[j * dv + col] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] += pv[r] * vv[c];
    }
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row >= Tq) continue;
    const float inv = 1.f / fmaxf(l_s[ty + 16 * r], 1e-30f);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
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

// ------------------------------------------------- tensor-core bf16 path
constexpr int MQ = 64;        // query rows per block (16 per warp)
constexpr int MK = 64;        // keys per tile
constexpr int MTHREADS = 128;

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

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

bool mma_ok(const void* p, Strides s) {
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
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, qs, ks, vs, os, H,
      H / Hk, Tq, Tk, dh, dv, scale, causal, window, softcap);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o). Strides are in
// elements, the last dim of every tensor is contiguous. lse, when not null,
// is a contiguous (B, H, Tq) float32 output. Returns the CUDA error of the
// launch (0 = success).
int flash_attention_fwd(int device, int dtype, const void* q, const void* k,
                        const void* v, void* o, void* lse_out, long long qsb,
                        long long qsh, long long qst, long long ksb,
                        long long ksh,
                        long long kst, long long vsb, long long vsh,
                        long long vst, long long osb, long long osh,
                        long long ost, int B, int H, int Hk, int Tq, int Tk,
                        int dh, int dv, float scale, int causal, int window,
                        float softcap, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (dh < 1 || dh > MAXDQK || dv < 1 || dv > MAXDV || Hk < 1 || H % Hk ||
      Tq < 1 || Tk < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qsh, qst}, ks{ksb, ksh, kst}, vs{vsb, vsh, vst},
      os{osb, osh, ost};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
  if (dtype == 0)
    err = launch<float>(q, k, v, o, lse, qs, ks, vs, os, B, H, Hk, Tq, Tk,
                        dh, dv, scale, causal, window, softcap, st);
  else if (dtype == 1 && mma_ok(q, qs) && mma_ok(k, ks) && mma_ok(v, vs) &&
           mma_ok(o, os) &&
           ((dh == dv && (dh == 16 || dh == 32 || dh == 64 || dh == 128)) ||
            (dh == 192 && dv == 128))) {
    auto fn = dh == 16    ? launch_mma<16, 16>
            : dh == 32    ? launch_mma<32, 32>
            : dh == 64    ? launch_mma<64, 64>
            : dh == 128   ? launch_mma<128, 128>
                          : launch_mma<192, 128>;   // MLA: nope + rope, v
    err = fn(q, k, v, o, lse, qs, ks, vs, os, B, H, Hk, Tq, Tk, scale,
             causal, window, softcap, st);
  } else if (dtype == 1)
    err = launch<__nv_bfloat16>(q, k, v, o, lse, qs, ks, vs, os, B, H, Hk,
                                Tq, Tk, dh, dv, scale, causal, window,
                                softcap, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

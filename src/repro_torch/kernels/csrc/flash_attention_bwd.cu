// Backward flash attention on Hopper (sm_90a): causal and/or sliding window,
// tanh softcap, GQA, ragged lengths.
//
// Replaces the TPU kernels repro/kernels/flash_attention/
// flash_attention_bwd.py::flash_attention_bwd (_dq_kernel, _dkv_kernel).
// Same math: p is recomputed per tile from the forward's lse,
//
//   delta = rowsum(do * o)
//   p  = exp(s - lse) where the mask is live, else 0
//   ds = p * (do v^T - delta)          (* (1 - t^2) with softcap, t = tanh)
//   dq = scale * ds k,  dk = scale * ds^T q,  dv = p^T do
//
// and the same split into two passes so that every accumulator is local to
// its block, with no atomics: a dq pass over (query tile, B * H) and a dk/dv
// pass over (key tile, B * Hk). Differences the card asks for: K/V carry Hk
// heads and query head h reads kv head h / (H / Hk); the dk/dv pass loops
// over the G query heads of its kv head, so dk and dv come back with Hk
// heads, summed over each group, and no GQA broadcast is materialized.
// Every tensor is read and written through its strides (the caller passes
// head-transposed views), a ragged Tq or Tk is masked here (no T % 256),
// and tiles the mask kills are never visited. delta is a small first
// kernel (one warp per row).
//
// What bounds it: the operations. 5 products per live (query, key) pair
// and head (S = q k^T and dP = do v^T recomputed, then dq, dk, dv): 2 *
// (3 dqk + 2 dv) flops, 10 * dh with dh = dv; at B = 4, T = 2048 causal, 32
// heads, dh = 128 that is 0.35 ms at the 989 TFLOP/s bf16 rate, and 1.81
// ms at MLA's 128 heads of (dqk, dv) = (192, 128).
//
// Two paths, one contract.
//
// bwd_*_mma<DQK, DV> (bf16, (dqk, dv) in {(64, 64), (128, 128), (192,
// 128)}, 16-byte aligned rows: the training paths of the GQA models,
// whisper and deepseek-v2's MLA): the tensor cores through mma.sync
// m16n8k16 (bf16 in, f32 accumulate). S = Q K^T runs DQK / 16 k-steps and
// dP = dO V^T DV / 16 (one unrolled loop over the longer, each product
// issued where its depth reaches; at DQK = DV the same code as one loop).
// Every tile is stored once, row-major (Q, K rows padded to DQK + 8 bf16,
// V, dO rows to DV + 8, so the 8 row addresses of an ldmatrix phase hit
// 32 banks), and every fragment comes from it by ldmatrix: the operands
// that the products read transposed (K^T for dS K; Q^T and dO^T for P^T dO
// and dS^T Q) by its .trans form. Streamed tiles arrive by 16-byte
// cp.async in a ring of two stages with one barrier per tile: the next
// tile is in flight while the current one's products run.
// - dq pass: 4 warps of 16 query rows (64 per block). Q and dO stay in
//   shared memory and are re-read by ldmatrix, not held in registers, so
//   three blocks fit an SM at dh <= 128 (launch bounds cap registers at
//   168; 69.6 KiB of shared memory at dh 128) and two at dqk 192, whose
//   96 f32 dq accumulators a thread need more (86 KiB each). K and V
//   stream in tiles of 32 keys.
// - dk/dv pass: 8 warps of 16 keys (128 per block), so each Q/dO tile
//   serves 128 keys; dk and dv (DQK / 2 + DV / 2 f32 registers a thread:
//   128 at dh 128, 160 at (192, 128)) stay in registers, K and V in shared
//   memory. Q/dO tiles with their lse and delta stream through the ring,
//   over every query head of the group, and are taken KvTiles::qs rows at
//   a time to bound S^T and dP^T's registers: tiles of 128 rows taken 32 at
//   a time at dh <= 128 (206 KiB of shared memory), of 64 rows taken 16 at
//   a time at (192, 128) (173 KiB; two stages of 128 rows beside K and V
//   would need 258; 32 rows a step there spill, 16 do not). One block of 8
//   warps per SM.
// - Blocks start with the heaviest causal tiles; a warp skips a piece of a
//   tile that its mask kills whole.
// p and ds are rounded to bf16 before they enter the second products, as
// the forward rounds p before P V (so p takes the hardware exp, __expf);
// every sum stays f32. Where it stands (PERF.md §6, on an H100 at 700 W):
// 8.1x its operations bound at dh 128 and 8.4x at (192, 128), 2.9x and
// 3.2x scaled_dot_product_attention's backward.
// Not yet used: wgmma, TMA.
//
// bwd_*_kernel (f32, and bf16 at any other head dims, or rows not 16-byte
// aligned: dh, dv <= 256): CUDA cores in f32, 32 x 32 tiles, every operand
// and accumulator in shared memory, 256 threads.
//
// Masked scores are never exponentiated (exp above the causal diagonal
// would overflow), and a row with no live key has p = 0 everywhere.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int MAXD = 256;      // head dim limit of the f32 path

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

struct Mask {
  int Tq, Tk, causal, window;
  __device__ __forceinline__ bool live(int row, int key) const {
    return row < Tq && key < Tk && (!causal || key <= row) &&
           (!window || key > row - window);
  }
  // key range [lo, hi] that the query rows [r0, r1] can see
  __device__ __forceinline__ int key_lo(int r0) const {
    return window ? max(0, r0 - window + 1) : 0;
  }
  __device__ __forceinline__ int key_hi(int r1) const {
    return causal ? min(Tk - 1, r1) : Tk - 1;
  }
  // query range [lo, hi] that sees some key of [k0, k1]
  __device__ __forceinline__ int row_lo(int k0) const {
    return causal ? k0 : 0;
  }
  __device__ __forceinline__ int row_hi(int k1) const {
    return window ? min(Tq - 1, k1 + window - 1) : Tq - 1;
  }
};

// p and ds of one score from s_pre = q.k (unscaled), the row's lse and
// delta, and dp = do.v. FAST takes the hardware exp (the tensor-core path,
// whose p and ds enter the next products rounded to bf16).
template <bool FAST = false>
__device__ __forceinline__ void p_ds(float s_pre, float dp, float lse,
                                     float delta, bool ok, float scale,
                                     float softcap, float* p, float* ds) {
  if (!ok) {
    *p = 0.f;
    *ds = 0.f;
    return;
  }
  float x = s_pre * scale, dt = 1.f;
  if (softcap > 0.f) {
    const float t = tanhf(x / softcap);
    x = t * softcap;
    dt = 1.f - t * t;
  }
  const float pv = FAST ? __expf(x - lse) : expf(x - lse);
  *p = pv;
  *ds = pv * (dp - delta) * dt;
}

// ---------------------------------------------------------------- delta
template <typename T>
__global__ void __launch_bounds__(256)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, Strides os, Strides dos, int H,
             int Tq, int dv, long long rows) {
  const long long r = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const int t = (int)(r % Tq);
  const long long bh = r / Tq;
  const int b = (int)(bh / H), h = (int)(bh % H);
  const T* orow = o + b * os.b + h * os.h + t * os.t;
  const T* drow = dout + b * dos.b + h * dos.h + t * dos.t;
  float acc = 0.f;
  for (int d = lane; d < dv; d += 32) acc += to_f(orow[d]) * to_f(drow[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[r] = acc;
}

// ------------------------------------------------------ f32 CUDA-core path
constexpr int FT = 32;          // query and key tile
constexpr int FTHREADS = 256;
constexpr int FSP = FT + 1;     // padded score row

template <typename T>
__global__ void __launch_bounds__(FTHREADS)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, Strides qs, Strides ks, Strides vs,
              Strides dos, Strides dqs, int H, int group, Mask mk, int dh,
              int dv, float scale, float softcap) {
  extern __shared__ float smem[];
  const int dhp = dh + 1, dvp = dv + 1;
  float* Qs = smem;                   // FT x dhp
  float* Ds = Qs + FT * dhp;          // FT x dvp  (dO)
  float* Ks = Ds + FT * dvp;          // FT x dhp
  float* Vs = Ks + FT * dhp;          // FT x dvp
  float* Ss = Vs + FT * dvp;          // FT x FSP  (ds)
  float* acc = Ss + FT * FSP;         // FT x dh
  float* lse_s = acc + FT * dh;       // FT
  float* dl_s = lse_s + FT;           // FT

  const int tid = threadIdx.x;
  const int qi = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H, hk = h / group;
  const int q0 = qi * FT, Tq = mk.Tq, Tk = mk.Tk;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* db = dout + b * dos.b + h * dos.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  const float* lb = lse + (long long)blockIdx.y * Tq;
  const float* dlb = delta + (long long)blockIdx.y * Tq;

  for (int i = tid; i < FT * dh; i += FTHREADS) {
    const int r = i / dh, d = i % dh, row = q0 + r;
    Qs[r * dhp + d] = row < Tq ? to_f(qb[row * qs.t + d]) : 0.f;
    acc[i] = 0.f;
  }
  for (int i = tid; i < FT * dv; i += FTHREADS) {
    const int r = i / dv, d = i % dv, row = q0 + r;
    Ds[r * dvp + d] = row < Tq ? to_f(db[row * dos.t + d]) : 0.f;
  }
  if (tid < FT) {
    const int row = q0 + tid;
    lse_s[tid] = row < Tq ? lb[row] : 0.f;
    dl_s[tid] = row < Tq ? dlb[row] : 0.f;
  }

  const int q1 = min(q0 + FT, Tq) - 1;
  const int k_hi = mk.key_hi(q1);
  for (int k0 = (mk.key_lo(q0) / FT) * FT; k0 <= k_hi; k0 += FT) {
    __syncthreads();                     // previous tile consumed
    for (int i = tid; i < FT * dh; i += FTHREADS) {
      const int r = i / dh, d = i % dh, key = k0 + r;
      Ks[r * dhp + d] = key < Tk ? to_f(kb[key * ks.t + d]) : 0.f;
    }
    for (int i = tid; i < FT * dv; i += FTHREADS) {
      const int r = i / dv, d = i % dv, key = k0 + r;
      Vs[r * dvp + d] = key < Tk ? to_f(vb[key * vs.t + d]) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < FT * FT; i += FTHREADS) {
      const int r = i / FT, c = i % FT;   // a warp shares its query row
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < dh; ++d) s += Qs[r * dhp + d] * Ks[c * dhp + d];
      for (int d = 0; d < dv; ++d) dp += Ds[r * dvp + d] * Vs[c * dvp + d];
      float p, ds;
      p_ds(s, dp, lse_s[r], dl_s[r], mk.live(q0 + r, k0 + c), scale,
           softcap, &p, &ds);
      Ss[r * FSP + c] = ds;
    }
    __syncthreads();
    for (int i = tid; i < FT * dh; i += FTHREADS) {
      const int r = i / dh, d = i % dh;
      float a = 0.f;
      for (int c = 0; c < FT; ++c) a += Ss[r * FSP + c] * Ks[c * dhp + d];
      acc[i] += a;
    }
  }
  __syncthreads();
  T* out = dq + b * dqs.b + h * dqs.h;
  for (int i = tid; i < FT * dh; i += FTHREADS) {
    const int r = i / dh, d = i % dh, row = q0 + r;
    if (row < Tq) out[row * dqs.t + d] = from_f<T>(acc[i] * scale);
  }
}

template <typename T>
__global__ void __launch_bounds__(FTHREADS)
bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk,
               T* __restrict__ dv_out, Strides qs, Strides ks, Strides vs,
               Strides dos, Strides dks, Strides dvs, int H, int Hk,
               int group, Mask mk, int dh, int dv, float scale,
               float softcap) {
  extern __shared__ float smem[];
  const int dhp = dh + 1, dvp = dv + 1;
  float* Ks = smem;                   // FT x dhp
  float* Vs = Ks + FT * dhp;          // FT x dvp
  float* Qs = Vs + FT * dvp;          // FT x dhp
  float* Ds = Qs + FT * dhp;          // FT x dvp  (dO)
  float* Ps = Ds + FT * dvp;          // FT x FSP  (row = query, col = key)
  float* Gs = Ps + FT * FSP;          // FT x FSP  (ds)
  float* dk_acc = Gs + FT * FSP;      // FT x dh
  float* dv_acc = dk_acc + FT * dh;   // FT x dv
  float* lse_s = dv_acc + FT * dv;    // FT
  float* dl_s = lse_s + FT;           // FT

  const int tid = threadIdx.x;
  const int kj = blockIdx.x;
  const int b = blockIdx.y / Hk, hk = blockIdx.y % Hk;
  const int k0 = kj * FT, Tq = mk.Tq, Tk = mk.Tk;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int i = tid; i < FT * dh; i += FTHREADS) {
    const int r = i / dh, d = i % dh, key = k0 + r;
    Ks[r * dhp + d] = key < Tk ? to_f(kb[key * ks.t + d]) : 0.f;
    dk_acc[i] = 0.f;
  }
  for (int i = tid; i < FT * dv; i += FTHREADS) {
    const int r = i / dv, d = i % dv, key = k0 + r;
    Vs[r * dvp + d] = key < Tk ? to_f(vb[key * vs.t + d]) : 0.f;
    dv_acc[i] = 0.f;
  }

  const int k1 = min(k0 + FT, Tk) - 1;
  const int r_hi = mk.row_hi(k1);
  for (int h = hk * group; h < (hk + 1) * group; ++h) {
    const T* qb = q + b * qs.b + h * qs.h;
    const T* db = dout + b * dos.b + h * dos.h;
    const float* lb = lse + ((long long)b * H + h) * Tq;
    const float* dlb = delta + ((long long)b * H + h) * Tq;
    for (int q0 = (mk.row_lo(k0) / FT) * FT; q0 <= r_hi; q0 += FT) {
      __syncthreads();                   // previous tile consumed
      for (int i = tid; i < FT * dh; i += FTHREADS) {
        const int r = i / dh, d = i % dh, row = q0 + r;
        Qs[r * dhp + d] = row < Tq ? to_f(qb[row * qs.t + d]) : 0.f;
      }
      for (int i = tid; i < FT * dv; i += FTHREADS) {
        const int r = i / dv, d = i % dv, row = q0 + r;
        Ds[r * dvp + d] = row < Tq ? to_f(db[row * dos.t + d]) : 0.f;
      }
      if (tid < FT) {
        const int row = q0 + tid;
        lse_s[tid] = row < Tq ? lb[row] : 0.f;
        dl_s[tid] = row < Tq ? dlb[row] : 0.f;
      }
      __syncthreads();
      for (int i = tid; i < FT * FT; i += FTHREADS) {
        const int r = i / FT, c = i % FT;
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < dh; ++d) s += Qs[r * dhp + d] * Ks[c * dhp + d];
        for (int d = 0; d < dv; ++d)
          dp += Ds[r * dvp + d] * Vs[c * dvp + d];
        float p, ds;
        p_ds(s, dp, lse_s[r], dl_s[r], mk.live(q0 + r, k0 + c), scale,
             softcap, &p, &ds);
        Ps[r * FSP + c] = p;
        Gs[r * FSP + c] = ds;
      }
      __syncthreads();
      for (int i = tid; i < FT * dv; i += FTHREADS) {
        const int c = i / dv, d = i % dv;
        float a = 0.f;
        for (int r = 0; r < FT; ++r) a += Ps[r * FSP + c] * Ds[r * dvp + d];
        dv_acc[i] += a;
      }
      for (int i = tid; i < FT * dh; i += FTHREADS) {
        const int c = i / dh, d = i % dh;
        float a = 0.f;
        for (int r = 0; r < FT; ++r) a += Gs[r * FSP + c] * Qs[r * dhp + d];
        dk_acc[i] += a;
      }
    }
  }
  __syncthreads();
  T* dkb = dk + b * dks.b + hk * dks.h;
  T* dvb = dv_out + b * dvs.b + hk * dvs.h;
  for (int i = tid; i < FT * dh; i += FTHREADS) {
    const int c = i / dh, d = i % dh, key = k0 + c;
    if (key < Tk) dkb[key * dks.t + d] = from_f<T>(dk_acc[i] * scale);
  }
  for (int i = tid; i < FT * dv; i += FTHREADS) {
    const int c = i / dv, d = i % dv, key = k0 + c;
    if (key < Tk) dvb[key * dvs.t + d] = from_f<T>(dv_acc[i]);
  }
}

// ------------------------------------------------- tensor-core bf16 path
constexpr int DQ_WARPS = 4;               // dq pass: warps of 16 query rows
constexpr int DQ_ROWS = 16 * DQ_WARPS;    // query rows per block
constexpr int DQ_KT = 32;                 // keys per K/V tile
constexpr int KV_WARPS = 8;               // dk/dv pass: warps of 16 keys
constexpr int KV_KEYS = 16 * KV_WARPS;    // keys per block
constexpr int RING = 2;                   // cp.async stages of each ring
constexpr size_t SMEM_MAX = 232448;       // shared memory a block may use

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_f(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// true when no (row, key) of [r0, r1] x [c0, c1] is live: a warp skips
// such a piece of a tile (p and ds would be 0 there)
__device__ __forceinline__ bool dead(const Mask& mk, int r0, int r1, int c0,
                                     int c1) {
  return r0 >= mk.Tq || c0 >= mk.Tk || (mk.causal && r1 < c0) ||
         (mk.window && r0 - mk.window + 1 > c1);
}

// Rows [r0, r0 + N) of a (rows, D) bf16 tensor with row stride st into a
// row-major tile of pitch D + 8 by 16-byte cp.async, NT threads; rows at
// or past `limit` are zero-filled.
template <int D, int N, int NT>
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* src,
                                          long long st, int r0, int limit,
                                          int tid) {
  constexpr int VPR = D / 8;                     // 16-byte vectors per row
  static_assert(N * VPR % NT == 0, "tile copy");
#pragma unroll
  for (int it = 0; it < N * VPR / NT; ++it) {
    const int i = tid + it * NT, r = i / VPR, c = (i % VPR) * 8;
    const int row = r0 + r;
    const bool ok = row < limit;
    cp_async16(dst + r * (D + 8) + c, ok ? src + row * st + c : src, ok);
  }
}

// src[r0, r0 + N) (f32) into dst by 4-byte cp.async; zero at or past limit
template <int N, int NT>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          int r0, int limit, int tid) {
  for (int i = tid; i < N; i += NT) {
    const bool ok = r0 + i < limit;
    cp_async4(dst + i, ok ? src + r0 + i : src, ok);
  }
}

// Shared memory of the dq pass: Q and dO (DQ_ROWS rows), and a ring of K
// and V tiles (DQ_KT keys); rows padded to DQK + 8 (Q, K) and DV + 8 (dO,
// V).
template <int DQK, int DV>
constexpr size_t dq_smem() {
  return sizeof(bf16) * (size_t)(DQK + DV + 16) * (DQ_ROWS + RING * DQ_KT);
}

// Shared memory of the dk/dv pass with Q/dO tiles of qt rows: K and V
// (KV_KEYS rows), a ring of Q and dO tiles, and their lse and delta.
constexpr size_t dkv_bytes(int dqk, int dv, int qt) {
  return sizeof(bf16) * (size_t)(dqk + dv + 16) * (KV_KEYS + RING * qt) +
         sizeof(float) * RING * 2 * qt;
}

// The dk/dv pass's query tiles: qt rows a Q/dO tile (128, or 64 where two
// stages of 128 do not fit beside K and V), taken qs rows a product step
// (32, or 16 at dqk 192, where dk and dv hold 160 registers a thread).
template <int DQK, int DV>
struct KvTiles {
  static constexpr int qt = dkv_bytes(DQK, DV, 128) <= SMEM_MAX ? 128 : 64;
  static constexpr int qs = DQK > 128 ? 16 : 32;
  static constexpr size_t bytes = dkv_bytes(DQK, DV, qt);
};
static_assert(KvTiles<64, 64>::qt == 128 && KvTiles<128, 128>::qt == 128 &&
                  KvTiles<192, 128>::qt == 64,
              "dk/dv pass query tiles");
static_assert(dq_smem<192, 128>() <= SMEM_MAX &&
                  KvTiles<192, 128>::bytes <= SMEM_MAX,
              "the (192, 128) passes fit a block");

// dq pass: one block per (query tile of DQ_ROWS, b * H + h), the heaviest
// causal tiles first (blockIdx.y counts down from the last tile). Q and dO
// sit in shared memory for the block's life and are re-read through
// ldmatrix (no fragments held: fewer registers, more blocks per SM); K and
// V tiles of DQ_KT keys stream through a ring of RING stages. Three blocks
// an SM at dqk <= 128, two at 192 (its dq accumulators need more than 168
// registers a thread).
template <int DQK, int DV>
__global__ void __launch_bounds__(32 * DQ_WARPS, DQK > 128 ? 2 : 3)
bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           bf16* __restrict__ dq, Strides qs, Strides ks, Strides vs,
           Strides dos, Strides dqs, int H, int group, Mask mk, float scale,
           float softcap) {
  constexpr int PQ = DQK + 8, PV = DV + 8, NT = 32 * DQ_WARPS;
  constexpr int STAGE = DQ_KT * (PQ + PV);       // K and V tiles
  constexpr int KSTEPS = (DQK > DV ? DQK : DV) / 16;
  extern __shared__ __align__(16) unsigned char raw[];
  bf16* Qs = reinterpret_cast<bf16*>(raw);       // (query, d) DQ_ROWS x PQ
  bf16* Ds = Qs + DQ_ROWS * PQ;                  // (query, d) dO, x PV
  bf16* ring = Ds + DQ_ROWS * PV;                // RING x {K, V} (key, d)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tg = lane & 3;
  const int qi = gridDim.y - 1 - blockIdx.y;
  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / group;
  const int q0 = qi * DQ_ROWS, Tq = mk.Tq, Tk = mk.Tk;
  const int w0 = q0 + warp * 16;                 // the warp's first row
  const int rows[2] = {w0 + gq, w0 + gq + 8};
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;

  const int q1 = min(q0 + DQ_ROWS, Tq) - 1;
  const int k_lo = (mk.key_lo(q0) / DQ_KT) * DQ_KT, k_hi = mk.key_hi(q1);
  const int n_tiles = k_hi >= k_lo ? (k_hi - k_lo) / DQ_KT + 1 : 0;
  auto load_kv = [&](int t) {
    bf16* Kt = ring + (t % RING) * STAGE;
    copy_tile<DQK, DQ_KT, NT>(Kt, kb, ks.t, k_lo + t * DQ_KT, Tk, tid);
    copy_tile<DV, DQ_KT, NT>(Kt + DQ_KT * PQ, vb, vs.t, k_lo + t * DQ_KT, Tk,
                             tid);
  };
  copy_tile<DQK, DQ_ROWS, NT>(Qs, q + b * qs.b + h * qs.h, qs.t, q0, Tq,
                              tid);
  copy_tile<DV, DQ_ROWS, NT>(Ds, dout + b * dos.b + h * dos.h, dos.t, q0, Tq,
                             tid);
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();

  float lr[2], dl[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const long long at = (long long)blockIdx.x * Tq + rows[rr];
    lr[rr] = rows[rr] < Tq ? lse[at] : 0.f;
    dl[rr] = rows[rr] < Tq ? delta[at] : 0.f;
  }
  float acc[DQK / 8][4];
#pragma unroll
  for (int j = 0; j < DQK / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] =
      acc[j][3] = 0.f;

  // lane offsets of the ldmatrix patterns (mma.cuh)
  const int a_row = lane & 15, a_col = 8 * (lane >> 4);
  const int b_row = (lane & 7) + 8 * (lane >> 4), b_col = 8 * ((lane >> 3) & 1);
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();                          // tile t landed (this thread)
    __syncthreads();                             // (all); t - 1's stage free
    if (t + 1 < n_tiles) load_kv(t + 1);         // in flight during tile t
    cp_async_commit();
    const int k0 = k_lo + t * DQ_KT;
    if (dead(mk, w0, w0 + 15, k0, k0 + DQ_KT - 1)) continue;
    const bf16* Kt = ring + (t % RING) * STAGE;
    const bf16* Vt = Kt + DQ_KT * PQ;

    // S = Q K^T (DQK / 16 k-steps) and dP = dO V^T (DV / 16) for the
    // warp's 16 rows
    float s[DQ_KT / 8][4], dp[DQ_KT / 8][4];
#pragma unroll
    for (int j = 0; j < DQ_KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      constexpr int NQK = DQK / 16, NV = DV / 16;
      uint32_t aq[4], ad[4];
      const int ar = warp * 16 + a_row, ac = kk * 16 + a_col;
      if (kk < NQK) ldsm_x4(aq, Qs + ar * PQ + ac);
      if (kk < NV) ldsm_x4(ad, Ds + ar * PV + ac);
#pragma unroll
      for (int jp = 0; jp < DQ_KT / 16; ++jp) {
        uint32_t bk[4], bv[4];
        const int br = jp * 16 + b_row, bc = kk * 16 + b_col;
        if (kk < NQK) ldsm_x4(bk, Kt + br * PQ + bc);
        if (kk < NV) ldsm_x4(bv, Vt + br * PV + bc);
        if (kk < NQK) {
          mma_bf16(s[2 * jp], aq, bk[0], bk[1]);
          mma_bf16(s[2 * jp + 1], aq, bk[2], bk[3]);
        }
        if (kk < NV) {
          mma_bf16(dp[2 * jp], ad, bv[0], bv[1]);
          mma_bf16(dp[2 * jp + 1], ad, bv[2], bv[3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < DQ_KT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e >> 1, key = k0 + j * 8 + tg * 2 + (e & 1);
        float p, ds;
        p_ds<true>(s[j][e], dp[j][e], lr[rr], dl[rr], mk.live(rows[rr], key),
                   scale, softcap, &p, &ds);
        s[j][e] = ds;
      }
    }
    // dq += dS K: dS (C layout) as A, K^T fragments by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < DQ_KT / 16; ++kk) {
      const uint32_t a[4] = {pack_f(s[2 * kk][0], s[2 * kk][1]),
                             pack_f(s[2 * kk][2], s[2 * kk][3]),
                             pack_f(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_f(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int jp = 0; jp < DQK / 16; ++jp) {
        uint32_t bt[4];
        ldsm_x4_t(bt, Kt + (kk * 16 + a_row) * PQ + jp * 16 + a_col);
        mma_bf16(acc[2 * jp], a, bt[0], bt[1]);
        mma_bf16(acc[2 * jp + 1], a, bt[2], bt[3]);
      }
    }
  }
  cp_async_wait<0>();

  bf16* out = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = rows[rr];
    if (row >= Tq) continue;
#pragma unroll
    for (int j = 0; j < DQK / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + row * dqs.t + j * 8 + tg * 2) =
          __floats2bfloat162_rn(acc[j][2 * rr] * scale,
                                acc[j][2 * rr + 1] * scale);
  }
}

// dk/dv pass: one block per (key tile of KV_KEYS, b * Hk + hk), the key
// tiles with the most causal queries first (blockIdx.y counts up). K and V
// sit in shared memory for the block's life; Q and dO tiles of KV_QT rows,
// with their lse and delta, of every query head of the group stream
// through a ring of RING stages, each taken in steps of KvTiles::qs rows.
template <int DQK, int DV>
__global__ void __launch_bounds__(32 * KV_WARPS, 1)
bwd_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            bf16* __restrict__ dk, bf16* __restrict__ dv_out, Strides qs,
            Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs,
            int H, int Hk, int group, Mask mk, float scale, float softcap) {
  constexpr int PQ = DQK + 8, PV = DV + 8, NT = 32 * KV_WARPS;
  constexpr int KV_QT = KvTiles<DQK, DV>::qt, KV_QS = KvTiles<DQK, DV>::qs;
  constexpr int STAGE = KV_QT * (PQ + PV);       // Q and dO tiles
  constexpr int NQK = DQK / 16, NV = DV / 16;
  constexpr int KSTEPS = NQK > NV ? NQK : NV;
  extern __shared__ __align__(16) unsigned char raw[];
  bf16* Ks = reinterpret_cast<bf16*>(raw);       // (key, d)   KV_KEYS x PQ
  bf16* Vs = Ks + KV_KEYS * PQ;                  // (key, d)   KV_KEYS x PV
  bf16* ring = Vs + KV_KEYS * PV;                // RING x {Q, dO} (query, d)
  float* rowf = reinterpret_cast<float*>(ring + RING * STAGE);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tg = lane & 3;
  const int b = blockIdx.x / Hk, hk = blockIdx.x % Hk;
  const int k0 = blockIdx.y * KV_KEYS, Tq = mk.Tq, Tk = mk.Tk;
  const int kw = warp * 16;                      // the warp's first tile row
  const int keys[2] = {k0 + kw + gq, k0 + kw + gq + 8};

  const int k1 = min(k0 + KV_KEYS, Tk) - 1;
  const int q_lo = (mk.row_lo(k0) / KV_QT) * KV_QT, r_hi = mk.row_hi(k1);
  const int n_qt = r_hi >= q_lo ? (r_hi - q_lo) / KV_QT + 1 : 0;
  const int n_tiles = group * n_qt;              // (head, query tile) pairs
  auto load_q = [&](int t) {
    const int h = hk * group + t / n_qt, r0 = q_lo + (t % n_qt) * KV_QT;
    bf16* Qt = ring + (t % RING) * STAGE;
    copy_tile<DQK, KV_QT, NT>(Qt, q + b * qs.b + h * qs.h, qs.t, r0, Tq,
                              tid);
    copy_tile<DV, KV_QT, NT>(Qt + KV_QT * PQ, dout + b * dos.b + h * dos.h,
                             dos.t, r0, Tq, tid);
    float* lt = rowf + (t % RING) * 2 * KV_QT;
    const long long lb = ((long long)b * H + h) * Tq;
    copy_rows<KV_QT, NT>(lt, lse + lb, r0, Tq, tid);
    copy_rows<KV_QT, NT>(lt + KV_QT, delta + lb, r0, Tq, tid);
  };
  copy_tile<DQK, KV_KEYS, NT>(Ks, k + b * ks.b + hk * ks.h, ks.t, k0, Tk,
                              tid);
  copy_tile<DV, KV_KEYS, NT>(Vs, v + b * vs.b + hk * vs.h, vs.t, k0, Tk,
                             tid);
  if (n_tiles > 0) load_q(0);
  cp_async_commit();

  float dka[DQK / 8][4], dva[DV / 8][4];
#pragma unroll
  for (int j = 0; j < DQK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < DV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dva[j][e] = 0.f;

  const int a_row = lane & 15, a_col = 8 * (lane >> 4);
  const int b_row = (lane & 7) + 8 * (lane >> 4), b_col = 8 * ((lane >> 3) & 1);
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < n_tiles) load_q(t + 1);
    cp_async_commit();
    const int q0 = q_lo + (t % n_qt) * KV_QT;
    const bf16* Qt = ring + (t % RING) * STAGE;
    const bf16* Dt = Qt + KV_QT * PQ;
    const float* lt = rowf + (t % RING) * 2 * KV_QT;
    const float* dlt = lt + KV_QT;
#pragma unroll 1
    for (int qs0 = 0; qs0 < KV_QT; qs0 += KV_QS) {
      if (dead(mk, q0 + qs0, q0 + qs0 + KV_QS - 1, k0 + kw, k0 + kw + 15))
        continue;
      // S^T = K Q^T and dP^T = V dO^T: rows are the warp's keys
      float st[KV_QS / 8][4], dpt[KV_QS / 8][4];
#pragma unroll
      for (int j = 0; j < KV_QS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t ak[4], av[4];
        const int ar = kw + a_row, ac = kk * 16 + a_col;
        if (kk < NQK) ldsm_x4(ak, Ks + ar * PQ + ac);
        if (kk < NV) ldsm_x4(av, Vs + ar * PV + ac);
#pragma unroll
        for (int jp = 0; jp < KV_QS / 16; ++jp) {
          uint32_t bq[4], bd[4];
          const int br = qs0 + jp * 16 + b_row, bc = kk * 16 + b_col;
          if (kk < NQK) ldsm_x4(bq, Qt + br * PQ + bc);
          if (kk < NV) ldsm_x4(bd, Dt + br * PV + bc);
          if (kk < NQK) {
            mma_bf16(st[2 * jp], ak, bq[0], bq[1]);
            mma_bf16(st[2 * jp + 1], ak, bq[2], bq[3]);
          }
          if (kk < NV) {
            mma_bf16(dpt[2 * jp], av, bd[0], bd[1]);
            mma_bf16(dpt[2 * jp + 1], av, bd[2], bd[3]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < KV_QS / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = qs0 + j * 8 + tg * 2 + (e & 1);  // query in the tile
          float p, ds;
          p_ds<true>(st[j][e], dpt[j][e], lt[c], dlt[c],
                     mk.live(q0 + c, keys[e >> 1]), scale, softcap, &p, &ds);
          st[j][e] = p;
          dpt[j][e] = ds;
        }
      }
      // dV += P^T dO and dK += dS^T Q, the queries as depth: P^T and dS^T
      // (C layout) as A, dO and Q fragments by ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < KV_QS / 16; ++kk) {
        const uint32_t ap[4] = {pack_f(st[2 * kk][0], st[2 * kk][1]),
                                pack_f(st[2 * kk][2], st[2 * kk][3]),
                                pack_f(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                                pack_f(st[2 * kk + 1][2], st[2 * kk + 1][3])};
        const uint32_t ad[4] = {
            pack_f(dpt[2 * kk][0], dpt[2 * kk][1]),
            pack_f(dpt[2 * kk][2], dpt[2 * kk][3]),
            pack_f(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
            pack_f(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
#pragma unroll
        for (int jp = 0; jp < KSTEPS; ++jp) {
          uint32_t bd[4], bq[4];
          const int tr = qs0 + kk * 16 + a_row, tc = jp * 16 + a_col;
          if (jp < NV) ldsm_x4_t(bd, Dt + tr * PV + tc);
          if (jp < NQK) ldsm_x4_t(bq, Qt + tr * PQ + tc);
          if (jp < NV) {
            mma_bf16(dva[2 * jp], ap, bd[0], bd[1]);
            mma_bf16(dva[2 * jp + 1], ap, bd[2], bd[3]);
          }
          if (jp < NQK) {
            mma_bf16(dka[2 * jp], ad, bq[0], bq[1]);
            mma_bf16(dka[2 * jp + 1], ad, bq[2], bq[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  bf16* dkb = dk + b * dks.b + hk * dks.h;
  bf16* dvb = dv_out + b * dvs.b + hk * dvs.h;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = keys[rr];
    if (key >= Tk) continue;
#pragma unroll
    for (int j = 0; j < DQK / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dkb + key * dks.t + j * 8 + tg * 2) =
          __floats2bfloat162_rn(dka[j][2 * rr] * scale,
                                dka[j][2 * rr + 1] * scale);
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dvb + key * dvs.t + j * 8 + tg * 2) =
          __floats2bfloat162_rn(dva[j][2 * rr], dva[j][2 * rr + 1]);
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int B, H, Hk, dh, dv_dim;
  Mask mk;
  float scale, softcap;
};

template <typename T>
cudaError_t launch_delta(const Args& a, cudaStream_t st) {
  const long long rows = (long long)a.B * a.H * a.mk.Tq;
  delta_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.delta,
      a.os, a.dos, a.H, a.mk.Tq, a.dv_dim, rows);
  return cudaGetLastError();
}

template <int DQK, int DV>
cudaError_t launch_mma(const Args& a, cudaStream_t st) {
  cudaError_t err = launch_delta<bf16>(a, st);
  if (err != cudaSuccess) return err;
  const int G = a.H / a.Hk;
  const bf16 *q = static_cast<const bf16*>(a.q),
             *k = static_cast<const bf16*>(a.k),
             *v = static_cast<const bf16*>(a.v),
             *d = static_cast<const bf16*>(a.dout);
  constexpr size_t dq_sm = dq_smem<DQK, DV>();
  err = cudaFuncSetAttribute(bwd_dq_mma<DQK, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dq_sm);
  if (err != cudaSuccess) return err;
  bwd_dq_mma<DQK, DV><<<dim3(a.B * a.H, (a.mk.Tq + DQ_ROWS - 1) / DQ_ROWS),
                        32 * DQ_WARPS, dq_sm, st>>>(
      q, k, v, d, a.lse, a.delta, static_cast<bf16*>(a.dq), a.qs, a.ks, a.vs,
      a.dos, a.dqs, a.H, G, a.mk, a.scale, a.softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t dkv_sm = KvTiles<DQK, DV>::bytes;
  err = cudaFuncSetAttribute(bwd_dkv_mma<DQK, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dkv_sm);
  if (err != cudaSuccess) return err;
  bwd_dkv_mma<DQK, DV><<<dim3(a.B * a.Hk, (a.mk.Tk + KV_KEYS - 1) / KV_KEYS),
                         32 * KV_WARPS, dkv_sm, st>>>(
      q, k, v, d, a.lse, a.delta, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.qs, a.ks, a.vs, a.dos, a.dks, a.dvs, a.H,
      a.Hk, G, a.mk, a.scale, a.softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_f32(const Args& a, cudaStream_t st) {
  cudaError_t err = launch_delta<T>(a, st);
  if (err != cudaSuccess) return err;
  const int dh = a.dh, dv = a.dv_dim, G = a.H / a.Hk;
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k),
          *v = static_cast<const T*>(a.v),
          *d = static_cast<const T*>(a.dout);
  const size_t dq_smem = sizeof(float) *
      ((size_t)2 * FT * (dh + 1) + (size_t)2 * FT * (dv + 1) + FT * FSP +
       (size_t)FT * dh + 2 * FT);
  err = cudaFuncSetAttribute(bwd_dq_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dq_smem);
  if (err != cudaSuccess) return err;
  bwd_dq_kernel<T><<<dim3((a.mk.Tq + FT - 1) / FT, a.B * a.H), FTHREADS,
                     dq_smem, st>>>(q, k, v, d, a.lse, a.delta,
                                    static_cast<T*>(a.dq), a.qs, a.ks, a.vs,
                                    a.dos, a.dqs, a.H, G, a.mk, dh, dv,
                                    a.scale, a.softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t dkv_smem_f = sizeof(float) *
      ((size_t)2 * FT * (dh + 1) + (size_t)2 * FT * (dv + 1) +
       2 * FT * FSP + (size_t)FT * (dh + dv) + 2 * FT);
  err = cudaFuncSetAttribute(bwd_dkv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dkv_smem_f);
  if (err != cudaSuccess) return err;
  bwd_dkv_kernel<T><<<dim3((a.mk.Tk + FT - 1) / FT, a.B * a.Hk), FTHREADS,
                      dkv_smem_f, st>>>(q, k, v, d, a.lse, a.delta,
                                        static_cast<T*>(a.dk),
                                        static_cast<T*>(a.dv), a.qs, a.ks,
                                        a.vs, a.dos, a.dks, a.dvs, a.H, a.Hk,
                                        G, a.mk, dh, dv, a.scale, a.softcap);
  return cudaGetLastError();
}

bool mma_ok(const void* p, Strides s) {
  return (uintptr_t)p % 16 == 0 && s.b % 8 == 0 && s.h % 8 == 0 &&
         s.t % 8 == 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, do and the three grads).
// route: 1 = the mma.sync passes (bf16, (dh, dv) in {(64, 64), (128, 128),
// (192, 128)}, every pointer and stride of q, k, v, do and the grads a
// multiple of 8 elements; any other call is refused), 0 = the CUDA-core
// passes (the wrapper's bwd_route).
// lse (the forward's) and delta (scratch) are contiguous (B, H, Tq)
// float32. Strides are in elements; the last dim of every tensor is
// contiguous. Three launches: delta, the dq pass, the dk/dv pass. Returns
// the CUDA error of the first launch that failed (0 = success).
int flash_attention_bwd(
    int device, int dtype, int route, const void* q, const void* k,
    const void* v, const void* o, const void* dout, const void* lse,
    void* delta, void* dq,
    void* dk, void* dv, long long qsb, long long qsh, long long qst,
    long long ksb, long long ksh, long long kst, long long vsb, long long vsh,
    long long vst, long long osb, long long osh, long long ost, long long dosb,
    long long dosh, long long dost, long long dqsb, long long dqsh,
    long long dqst, long long dksb, long long dksh, long long dkst,
    long long dvsb, long long dvsh, long long dvst, int B, int H, int Hk,
    int Tq, int Tk, int dh, int dv_dim, float scale, int causal, int window,
    float softcap, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (dh < 1 || dh > MAXD || dv_dim < 1 || dv_dim > MAXD || Hk < 1 ||
      H % Hk || Tq < 1 || Tk < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, dout, static_cast<const float*>(lse),
         static_cast<float*>(delta), dq, dk, dv,
         {qsb, qsh, qst}, {ksb, ksh, kst}, {vsb, vsh, vst}, {osb, osh, ost},
         {dosb, dosh, dost}, {dqsb, dqsh, dqst}, {dksb, dksh, dkst},
         {dvsb, dvsh, dvst}, B, H, Hk, dh, dv_dim,
         Mask{Tq, Tk, causal, window}, scale, softcap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool tc = dtype == 1 &&
                  ((dh == dv_dim && (dh == 64 || dh == 128)) ||
                   (dh == 192 && dv_dim == 128)) &&
                  mma_ok(q, a.qs) && mma_ok(k, a.ks) && mma_ok(v, a.vs) &&
                  mma_ok(dout, a.dos) && mma_ok(dq, a.dqs) &&
                  mma_ok(dk, a.dks) && mma_ok(dv, a.dvs);
  if (route == 1 && !tc) return (int)cudaErrorInvalidValue;
  if (route == 1)
    err = dh == 64    ? launch_mma<64, 64>(a, st)
          : dh == 128 ? launch_mma<128, 128>(a, st)
                      : launch_mma<192, 128>(a, st);   // MLA: nope + rope, v
  else if (dtype == 0)
    err = launch_f32<float>(a, st);
  else if (dtype == 1)
    err = launch_f32<bf16>(a, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

// Paged flash-decode attention on Hopper (sm_90a): GQA (paged_gqa_kernel)
// and absorbed MLA (paged_mla_kernel, below).
//
// Replaces the TPU kernel repro/kernels/paged_attention/paged_attention.py::
// paged_flash_decode_gqa (_gqa_kernel, _online_update, _store_partials):
// one query token per slot attends to the K/V rows its page table points at
// in the shared pools, and the kernel returns the UNNORMALIZED partials
// (o, m, l) in f32, with m = -1e30, l = 0, o = 0 for a row with nothing live.
//
// What bounds it: the bytes of live K/V. Each live key costs 2 * Hkv * dh
// elements read once; at B = 8, Hkv = 8, dh = 128, 1k context in bf16 that
// is 33.5 MB per layer, 10 us at 3.35 TB/s. The arithmetic (4 flops per
// element and query row of the group) is far below the card's rate.
//
// Design. One block per (kv head h, slot b); 8 warps. The keys of the slot
// are numbered in page-table order (key kk is offset kk % ps of table entry
// kk / ps); the keys at or before pos form a prefix of that order, so the
// kernel reads exactly the live keys and never a dead page. Warp w takes
// chunks of 32 keys (w, w + 8, ...), one key per lane:
//   scores  each lane reads its key's K row, 8 16-byte loads issued
//           before their arithmetic, and dots it with the G query rows of
//           the group (kept scaled in shared memory, read as broadcasts) —
//           no reduction across lanes;
//   softmax one warp max and one warp sum per query row and chunk update
//           the warp's running (m, l);
//   values  lanes switch to 4 contiguous dims each; every key's p is
//           broadcast by a shuffle and its V row read as one coalesced
//           256-byte line, 16 rows' loads issued before their arithmetic.
// At the end the 8 warp partials are merged in shared memory with the exact
// rescaling of serve/decode.py::_merge_partials.
//
// A grid of B * Hkv blocks (64 at the main-path shape) leaves half of the
// 132 SMs idle, and a long slot's block runs alone after the short ones
// finish. Splitting the keys of one slot across blocks, which the partials
// contract already allows (the caller combines (o, m, l)), is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int WARPS = 8;
constexpr int MAXD = 128;      // head dim limit
constexpr int CHUNK = 32;      // keys per warp step, one per lane
constexpr int KPASS = 8;       // 16-byte K chunks a lane loads together
constexpr int VB = 16;         // V rows whose loads a warp issues together

// eight contiguous elements as raw 16-byte loads (two for f32)
template <typename T> struct Raw8;
template <> struct Raw8<float> {
  struct type { float4 a, b; };
  __device__ static type load(const float* p) {
    return {reinterpret_cast<const float4*>(p)[0],
            reinterpret_cast<const float4*>(p)[1]};
  }
  __device__ static void unpack(const type& r, float* out) {
    out[0] = r.a.x; out[1] = r.a.y; out[2] = r.a.z; out[3] = r.a.w;
    out[4] = r.b.x; out[5] = r.b.y; out[6] = r.b.z; out[7] = r.b.w;
  }
};
template <> struct Raw8<__nv_bfloat16> {
  using type = uint4;
  __device__ static type load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  __device__ static void unpack(const type& r, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};
// four contiguous elements as one raw load (16 bytes of f32, 8 of bf16)
template <typename T> struct Raw4;
template <> struct Raw4<float> {
  using type = float4;
  __device__ static type zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static void unpack(type r, float* out) {
    out[0] = r.x; out[1] = r.y; out[2] = r.z; out[3] = r.w;
  }
};
template <> struct Raw4<__nv_bfloat16> {
  using type = uint2;
  __device__ static type zero() { return make_uint2(0u, 0u); }
  __device__ static void unpack(type r, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
  }
};
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int G>
__global__ void __launch_bounds__(WARPS * 32)
paged_gqa_kernel(const T* __restrict__ q,        // (B, Hkv, G, dh)
                 const T* __restrict__ pool_k,   // (N, ps, Hkv, dh)
                 const T* __restrict__ pool_v,   // (N, ps, Hkv, dh)
                 const int* __restrict__ table,  // (B, width)
                 const int* __restrict__ pos,    // (B,)
                 float* __restrict__ o,          // (B, Hkv * G, dh)
                 float* __restrict__ m_out,      // (B, Hkv * G)
                 float* __restrict__ l_out,      // (B, Hkv * G)
                 int n_pages, int ps, int hkv, int dh, int width,
                 int page_size, int base, float scale, float softcap) {
  __shared__ __align__(16) float s_q[G][MAXD];
  __shared__ float s_m[WARPS][G];
  __shared__ float s_l[WARPS][G];
  __shared__ __align__(16) float s_acc[WARPS][G][MAXD];

  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t head = (size_t)b * hkv + h;
  const T* qb = q + head * G * dh;
  for (int i = threadIdx.x; i < G * MAXD; i += WARPS * 32) {
    const int g = i / MAXD, d = i % MAXD;     // zero past dh
    s_q[g][d] = d < dh ? to_f(qb[g * dh + d]) * scale : 0.f;
  }
  __syncthreads();

  // live keys: a prefix of the page-table order (see the note on top)
  const int p = pos[b];
  int n_keys = 0;
  if (p >= base) {
    const int t_last = (p - base) / page_size;
    const int off_last = (p - base) - t_last * page_size;
    n_keys = min(t_last * ps + min(ps, off_last + 1), width * ps);
  }
  const long long row = (long long)hkv * dh;    // elements per pool row
  const int d0 = lane * 4;                      // this lane's value dims

  float m[G], l[G], acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[g][i] = 0.f;
  }

  for (int k0 = warp * CHUNK; k0 < n_keys; k0 += WARPS * CHUNK) {
    const int kk = k0 + lane;
    const bool live = kk < n_keys;
    long long off = 0;                          // this lane's row offset
    if (live) {
      const int page =
          min(max(table[(size_t)b * width + kk / ps], 0), n_pages - 1);
      off = ((long long)page * ps + kk % ps) * row + (long long)h * dh;
    }
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    const T* kr = pool_k + off;                 // a dead lane reads row 0
    for (int c0 = 0; c0 * 8 < dh; c0 += KPASS) {
      typename Raw8<T>::type kraw[KPASS];       // all loads first, then math
#pragma unroll
      for (int c = 0; c < KPASS; ++c)
        if ((c0 + c) * 8 < dh) kraw[c] = Raw8<T>::load(kr + (c0 + c) * 8);
#pragma unroll
      for (int c = 0; c < KPASS; ++c) {
        if ((c0 + c) * 8 >= dh) break;
        float kv[8];
        Raw8<T>::unpack(kraw[c], kv);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4* q4 = reinterpret_cast<const float4*>(s_q[g]);
          const float4 qa = q4[2 * (c0 + c)], qc = q4[2 * (c0 + c) + 1];
          s[g] += qa.x * kv[0] + qa.y * kv[1] + qa.z * kv[2] + qa.w * kv[3] +
                  qc.x * kv[4] + qc.y * kv[5] + qc.z * kv[6] + qc.w * kv[7];
        }
      }
    }
    float pr[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float sg = s[g];
      if (softcap > 0.f) sg = tanhf(sg / softcap) * softcap;
      sg = live ? sg : NEG;
      const float m_new = fmaxf(m[g], warp_max(sg));   // a live key exists
      pr[g] = live ? expf(sg - m_new) : 0.f;
      const float corr = expf(m[g] - m_new);          // 0 while m[g] == NEG
      l[g] = l[g] * corr + warp_sum(pr[g]);
      m[g] = m_new;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[g][i] *= corr;
    }
    const int n = min(CHUNK, n_keys - k0);
    for (int j0 = 0; j0 < n; j0 += VB) {       // VB V rows in flight
      typename Raw4<T>::type vr[VB];
#pragma unroll
      for (int j = 0; j < VB; ++j) {
        const long long oj = __shfl_sync(0xffffffffu, off, j0 + j);
        if (j0 + j < n && d0 < dh)
          vr[j] = *reinterpret_cast<const typename Raw4<T>::type*>(
              pool_v + oj + d0);
        else
          vr[j] = Raw4<T>::zero();
      }
#pragma unroll
      for (int j = 0; j < VB; ++j) {
        float v[4];
        Raw4<T>::unpack(vr[j], v);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pj = __shfl_sync(0xffffffffu, pr[g], j0 + j);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[g][i] += pj * v[i];
        }
      }
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      s_m[warp][g] = m[g];
      s_l[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) s_acc[warp][g][d0 + i] = acc[g][i];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < G * dh; idx += WARPS * 32) {
    const int g = idx / dh, d = idx % dh;
    float mg = NEG;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mg = fmaxf(mg, s_m[w][g]);
    const float m_safe = mg <= NEG / 2 ? 0.f : mg;
    float ov = 0.f, lv = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float mw = s_m[w][g];
      const float c = expf((mw <= NEG / 2 ? NEG : mw) - m_safe);
      ov += s_acc[w][g][d] * c;
      lv += s_l[w][g] * c;
    }
    const size_t r = head * G + g;
    o[r * dh + d] = ov;
    if (d == 0) {
      m_out[r] = mg;
      l_out[r] = lv;
    }
  }
}

template <typename T, int G>
void launch(const void* q, const void* pk, const void* pv, const int* table,
            const int* pos, float* o, float* m, float* l, int B, int hkv,
            int dh, int n_pages, int ps, int width, int page_size, int base,
            float scale, float softcap, cudaStream_t stream) {
  dim3 grid(hkv, B);
  paged_gqa_kernel<T, G><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pk),
      static_cast<const T*>(pv), table, pos, o, m, l, n_pages, ps, hkv, dh,
      width, page_size, base, scale, softcap);
}

template <typename T>
cudaError_t dispatch(int G, const void* q, const void* pk, const void* pv,
                     const int* table, const int* pos, float* o, float* m,
                     float* l, int B, int hkv, int dh, int n_pages, int ps,
                     int width, int page_size, int base, float scale,
                     float softcap, cudaStream_t stream) {
#define PAGED_CASE(NG)                                                     \
  case NG:                                                                 \
    launch<T, NG>(q, pk, pv, table, pos, o, m, l, B, hkv, dh, n_pages, ps, \
                  width, page_size, base, scale, softcap, stream);         \
    break;
  switch (G) {
    PAGED_CASE(1) PAGED_CASE(2) PAGED_CASE(3) PAGED_CASE(4)
    PAGED_CASE(5) PAGED_CASE(6) PAGED_CASE(7) PAGED_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef PAGED_CASE
  return cudaGetLastError();
}

// ------------------------------------------------------------ absorbed MLA
// Replaces paged_attention.py::paged_flash_decode_mla (_mla_kernel): one
// absorbed query row q (R = kv_lora + rope dims) per (slot, head) attends to
// the latent rows its page table points at in one pool (N, ps, R); the row
// is the key and its first kv_lora dims the value. Same partials as GQA.
//
// What bounds it. Each live key costs R dims for the score and kv_lora for
// the value of every head: 2 * (R + kv_lora) flops per key and head, 2.28
// GFLOP at B = 8, H = 128, R = 576, 1k context, against 9.4 MB of rows
// read. So it is bound by its arithmetic unless that runs on the tensor
// cores (989 TFLOP/s bf16: 2.3 us; f32 CUDA cores, 67 TFLOP/s: 34 us).
//
// Design (CUDA cores, f32 arithmetic). A slot's 128 heads do not fit one
// block (128 x 576 queries), so the grid is (head group of MLA_HB = 8 heads,
// slot, key split). The slot's live keys, a prefix of page-table order as
// for GQA, are cut into chunks of at most `chunk` keys, one per grid z (a
// block whose chunk lies past the slot's last key stores an empty
// partial); each block walks its chunk in tiles of MLA_KT = 32 rows:
//   load    the tile's rows once into shared memory (16-byte loads, row
//           stride R + 1 floats so a warp reading one dim of 32 rows hits
//           32 banks); every row then serves all 8 heads of the block;
//   scores  lane j takes key j, warp w a 1/8 slice of the R dims, and each
//           thread keeps the 8 heads' partial dots (queries transposed in
//           shared memory, read as two float4 broadcasts); the 8 slices are
//           summed through shared memory;
//   softmax warp h keeps head h's running (m, l) over the tile's 32 keys;
//   values  thread t owns value dims t and t + 256 of all 8 heads and adds
//           p * row for each key.
// With more than one chunk, each block stores its (o, m, l) partial and
// mla_combine merges a row's partials exactly, as the GQA kernel merges
// its warps. A tensor-core product of Q (heads x R) against the key tile is the later
// step that moves it toward its bound.
constexpr int MLA_HB = 8;          // heads per block
constexpr int MLA_KT = 32;         // keys per tile, one per lane
constexpr int MLA_WARPS = 8;
constexpr int MLA_THREADS = MLA_WARPS * 32;
constexpr int MLA_MAXR = 1024;     // row dims
constexpr int MLA_VPT = 2;         // value dims per thread
constexpr int MLA_MAXV = MLA_VPT * MLA_THREADS;
static_assert(MLA_HB == 8 && MLA_WARPS == MLA_HB,
              "the score loop unrolls 8 heads; warp h runs head h's softmax");

size_t mla_smem_bytes(int R) {
  return sizeof(long long) * MLA_KT +
         sizeof(float) * ((size_t)MLA_KT * (R + 1) + (size_t)R * MLA_HB +
                          MLA_WARPS * MLA_HB * MLA_KT + MLA_KT * MLA_HB +
                          MLA_HB);
}

template <typename T>
__global__ void __launch_bounds__(MLA_THREADS)
paged_mla_kernel(const T* __restrict__ q,         // (B, H, R)
                 const T* __restrict__ pool,      // (N, ps, R)
                 const int* __restrict__ table,   // (B, width)
                 const int* __restrict__ pos,     // (B,)
                 float* __restrict__ o,           // (splits, B, H, kv_lora)
                 float* __restrict__ m_out,       // (splits, B, H)
                 float* __restrict__ l_out,       // (splits, B, H)
                 int H, int R, int kv_lora, int n_pages, int ps, int width,
                 int page_size, int base, float scale, int chunk) {
  extern __shared__ __align__(16) unsigned char mla_smem[];
  long long* roff = reinterpret_cast<long long*>(mla_smem);  // KT row offsets
  float* Ks = reinterpret_cast<float*>(roff + MLA_KT);       // KT x (R + 1)
  float* Qt = Ks + MLA_KT * (R + 1);                         // R x HB
  float* Sp = Qt + R * MLA_HB;                  // WARPS x HB x KT partials
  float* Pt = Sp + MLA_WARPS * MLA_HB * MLA_KT;              // KT x HB
  float* corr_s = Pt + MLA_KT * MLA_HB;                      // HB
  const int RP = R + 1;

  const int b = blockIdx.y, h0 = blockIdx.x * MLA_HB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < R * MLA_HB; i += MLA_THREADS) {
    const int r = i / MLA_HB, h = i % MLA_HB;
    Qt[i] = h0 + h < H
                ? to_f(q[((size_t)b * H + h0 + h) * R + r]) * scale
                : 0.f;
  }

  // live keys: a prefix of the page-table order (see paged_gqa_kernel)
  const int p = pos[b];
  int n_keys = 0;
  if (p >= base) {
    const int t_last = (p - base) / page_size;
    const int off_last = (p - base) - t_last * page_size;
    n_keys = min(t_last * ps + min(ps, off_last + 1), width * ps);
  }
  const int k_begin = blockIdx.z * chunk;             // this block's chunk
  const int k_end = min(n_keys, k_begin + chunk);
  const size_t row0 = ((size_t)blockIdx.z * gridDim.y + b) * H + h0;
  const int rc = (R + MLA_WARPS - 1) / MLA_WARPS;     // dims per warp slice
  const int r_lo = warp * rc, r_hi = min(R, r_lo + rc);
  const int h_me = warp;                              // softmax: warp = head
  const bool head_live = h0 + h_me < H;

  float acc[MLA_HB][MLA_VPT];
#pragma unroll
  for (int h = 0; h < MLA_HB; ++h)
#pragma unroll
    for (int i = 0; i < MLA_VPT; ++i) acc[h][i] = 0.f;
  float m_run = NEG, l_run = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += MLA_KT) {
    __syncthreads();                    // the previous tile is consumed
    if (tid < MLA_KT) {
      const int kk = k0 + tid;
      long long off = -1;
      if (kk < k_end) {
        const int page =
            min(max(table[(size_t)b * width + kk / ps], 0), n_pages - 1);
        off = ((long long)page * ps + kk % ps) * R;
      }
      roff[tid] = off;
    }
    __syncthreads();
    for (int i = tid; i < MLA_KT * (R / 8); i += MLA_THREADS) {
      const int j = i / (R / 8), c = (i % (R / 8)) * 8;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (roff[j] >= 0) Raw8<T>::unpack(Raw8<T>::load(pool + roff[j] + c), v);
#pragma unroll
      for (int e = 0; e < 8; ++e) Ks[j * RP + c + e] = v[e];
    }
    __syncthreads();

    float s[MLA_HB];
#pragma unroll
    for (int h = 0; h < MLA_HB; ++h) s[h] = 0.f;
    const float* krow = Ks + lane * RP;
    for (int r = r_lo; r < r_hi; ++r) {
      const float k = krow[r];
      const float4 qa = reinterpret_cast<const float4*>(Qt)[2 * r];
      const float4 qb = reinterpret_cast<const float4*>(Qt)[2 * r + 1];
      s[0] += qa.x * k; s[1] += qa.y * k; s[2] += qa.z * k; s[3] += qa.w * k;
      s[4] += qb.x * k; s[5] += qb.y * k; s[6] += qb.z * k; s[7] += qb.w * k;
    }
#pragma unroll
    for (int h = 0; h < MLA_HB; ++h)
      Sp[(warp * MLA_HB + h) * MLA_KT + lane] = s[h];
    __syncthreads();

    {
      const bool live = head_live && k0 + lane < k_end;
      float x = 0.f;
#pragma unroll
      for (int w = 0; w < MLA_WARPS; ++w)
        x += Sp[(w * MLA_HB + h_me) * MLA_KT + lane];
      x = live ? x : NEG;
      const float m_new = fmaxf(m_run, warp_max(x));
      const float pr = live ? expf(x - m_new) : 0.f;
      const float corr = expf(m_run - m_new);   // 0 while m_run == NEG
      l_run = l_run * corr + warp_sum(pr);
      m_run = m_new;
      Pt[lane * MLA_HB + h_me] = pr;
      if (lane == 0) corr_s[h_me] = corr;
    }
    __syncthreads();

#pragma unroll
    for (int h = 0; h < MLA_HB; ++h) {
      const float c = corr_s[h];
#pragma unroll
      for (int i = 0; i < MLA_VPT; ++i) acc[h][i] *= c;
    }
    const int n = min(MLA_KT, k_end - k0);
    for (int j = 0; j < n; ++j) {
      const float4 pa = reinterpret_cast<const float4*>(Pt)[2 * j];
      const float4 pb = reinterpret_cast<const float4*>(Pt)[2 * j + 1];
      const float pj[MLA_HB] = {pa.x, pa.y, pa.z, pa.w,
                                pb.x, pb.y, pb.z, pb.w};
#pragma unroll
      for (int i = 0; i < MLA_VPT; ++i) {
        const int d = tid + i * MLA_THREADS;
        const float v = d < kv_lora ? Ks[j * RP + d] : 0.f;
#pragma unroll
        for (int h = 0; h < MLA_HB; ++h) acc[h][i] += pj[h] * v;
      }
    }
  }

#pragma unroll
  for (int h = 0; h < MLA_HB; ++h) {
    if (h0 + h >= H) break;
    const size_t row = row0 + h;
#pragma unroll
    for (int i = 0; i < MLA_VPT; ++i) {
      const int d = tid + i * MLA_THREADS;
      if (d < kv_lora) o[row * kv_lora + d] = acc[h][i];
    }
  }
  if (head_live && lane == 0) {
    m_out[row0 + h_me] = m_run;
    l_out[row0 + h_me] = l_run;
  }
}

// Exact merge of the per-chunk partials of one (slot, head) row: rescale
// each chunk's (o, l) by exp(m_z - max m) and sum (chunks with nothing live
// hold m = -1e30 and contribute 0).
__global__ void __launch_bounds__(MLA_THREADS)
mla_combine(const float* __restrict__ o_part, const float* __restrict__ m_part,
            const float* __restrict__ l_part, float* __restrict__ o,
            float* __restrict__ m, float* __restrict__ l, int rows,
            int kv_lora, int splits) {
  const int row = blockIdx.x;
  float mg = NEG;
  for (int z = 0; z < splits; ++z)
    mg = fmaxf(mg, m_part[(size_t)z * rows + row]);
  const float m_safe = mg <= NEG / 2 ? 0.f : mg;
  for (int d = threadIdx.x; d < kv_lora; d += MLA_THREADS) {
    float ov = 0.f;
    for (int z = 0; z < splits; ++z) {
      const float mz = m_part[(size_t)z * rows + row];
      ov += o_part[((size_t)z * rows + row) * kv_lora + d] *
            expf((mz <= NEG / 2 ? NEG : mz) - m_safe);
    }
    o[(size_t)row * kv_lora + d] = ov;
  }
  if (threadIdx.x == 0) {
    float lv = 0.f;
    for (int z = 0; z < splits; ++z) {
      const float mz = m_part[(size_t)z * rows + row];
      lv += l_part[(size_t)z * rows + row] *
            expf((mz <= NEG / 2 ? NEG : mz) - m_safe);
    }
    m[row] = mg;
    l[row] = lv;
  }
}

template <typename T>
cudaError_t launch_mla(const void* q, const void* pool, const int* table,
                       const int* pos, float* o, float* m, float* l,
                       float* o_part, float* m_part, float* l_part, int B,
                       int H, int R, int kv_lora, int n_pages, int ps,
                       int width, int page_size, int base, float scale,
                       int splits, int chunk, cudaStream_t stream) {
  const size_t smem = mla_smem_bytes(R);
  cudaError_t err = cudaFuncSetAttribute(
      paged_mla_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((H + MLA_HB - 1) / MLA_HB, B, splits);
  const bool one = splits == 1;         // one chunk: its partial is the result
  paged_mla_kernel<T><<<grid, MLA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool), table, pos,
      one ? o : o_part, one ? m : m_part, one ? l : l_part, H, R, kv_lora,
      n_pages, ps, width, page_size, base, scale, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess || one) return err;
  mla_combine<<<B * H, MLA_THREADS, 0, stream>>>(o_part, m_part, l_part, o, m,
                                                 l, B * H, kv_lora, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q and both pools). dh must be a
// multiple of 8 and at most 128, the pools 16-byte aligned. Returns the
// CUDA error of the launch (0 = success).
int paged_attention_gqa(int device, int dtype, const void* q, const void* pk,
                        const void* pv, const void* table, const void* pos,
                        void* o, void* m, void* l, int B, int hkv, int G,
                        int dh, int n_pages, int ps, int width, int page_size,
                        int base, float scale, float softcap, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (dh > MAXD || dh < 8 || dh % 8 || B < 1 || hkv < 1 || width < 1 ||
      ps < 1 || ps > page_size || (uintptr_t)pk % 16 || (uintptr_t)pv % 16)
    return (int)cudaErrorInvalidValue;
  const int* tb = static_cast<const int*>(table);
  const int* pp = static_cast<const int*>(pos);
  float* of = static_cast<float*>(o);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = dispatch<float>(G, q, pk, pv, tb, pp, of, mf, lf, B, hkv, dh,
                          n_pages, ps, width, page_size, base, scale, softcap,
                          st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(G, q, pk, pv, tb, pp, of, mf, lf, B, hkv,
                                  dh, n_pages, ps, width, page_size, base,
                                  scale, softcap, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

// dtype: 0 = float32, 1 = bfloat16 (q and the pool). R must be a multiple
// of 8 and at most 1024, kv_lora at most 512 and R, the pool 16-byte
// aligned. The keys of a slot are cut into `splits` chunks of `chunk` keys
// (splits * chunk >= width * ps); with splits > 1, o_part (splits, B, H,
// kv_lora), m_part and l_part (splits, B, H) are f32 scratch. Returns the
// CUDA error of the launches (0 = success).
int paged_attention_mla(int device, int dtype, const void* q,
                        const void* pool, const void* table, const void* pos,
                        void* o, void* m, void* l, void* o_part, void* m_part,
                        void* l_part, int B, int H, int R, int kv_lora,
                        int n_pages, int ps, int width, int page_size,
                        int base, float scale, int splits, int chunk,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R < 8 || R % 8 || R > MLA_MAXR || kv_lora < 1 || kv_lora > R ||
      kv_lora > MLA_MAXV || B < 1 || H < 1 || width < 1 || ps < 1 ||
      ps > page_size || B > 65535 || (uintptr_t)pool % 16 || splits < 1 ||
      splits > 65535 || chunk < 1 || (long long)splits * chunk < width * ps)
    return (int)cudaErrorInvalidValue;
  float* op = static_cast<float*>(o_part);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  const int* tb = static_cast<const int*>(table);
  const int* pp = static_cast<const int*>(pos);
  float* of = static_cast<float*>(o);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch_mla<float>(q, pool, tb, pp, of, mf, lf, op, mp, lp, B, H, R,
                            kv_lora, n_pages, ps, width, page_size, base,
                            scale, splits, chunk, st);
  else if (dtype == 1)
    err = launch_mla<__nv_bfloat16>(q, pool, tb, pp, of, mf, lf, op, mp, lp,
                                    B, H, R, kv_lora, n_pages, ps, width,
                                    page_size, base, scale, splits, chunk, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

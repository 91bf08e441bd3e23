// Paged flash-decode attention for GQA on Hopper (sm_90a).
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

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

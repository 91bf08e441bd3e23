// Paged flash-decode attention on Hopper (sm_90a): GQA and absorbed MLA.
//
// Replaces the TPU kernels repro/kernels/paged_attention/paged_attention.py::
// paged_flash_decode_gqa (_gqa_kernel) and paged_flash_decode_mla
// (_mla_kernel): one query token per slot attends to the rows its page table
// points at in the shared pools, and the kernel returns the UNNORMALIZED
// partials (o, m, l) in f32, with m = -1e30, l = 0, o = 0 for a row with
// nothing live. The keys of a slot are numbered in page-table order (key kk
// is offset kk % ps of table entry kk / ps); the keys at or before pos form
// a prefix of that order, so every kernel here uses exactly the live rows
// and never reads a dead page (the trash page 0 included). `base` is the
// global position of in-page offset 0 (a shard's offset).
//
// Two routes per op, one contract, chosen by paged_attention/ops.py::
// gqa_route and mla_route; the split of a slot's keys over blocks comes
// from the table width alone (ops.py::split_plan), never from pos, so the
// grid of a width bucket is static.
//
// paged_gqa_mma (bf16, G <= 8, dh 64, 128 or 256: mistral-nemo-12b,
// phi3.5-moe and nemotron-4-15b decode at 128, gemma2-2b's global layers at
// 256). What bounds it: the bytes of live K/V, 2 Hkv dh
// elements per key read once; at the main-path shape (B 8, Hkv 8, G 4, dh
// 128, 15,239 live keys) 62.4 MB, 18.7 us at 3.35 TB/s. The arithmetic (4
// flops per element and query row) is far below the card's rate, but on
// CUDA cores it costs ~10 instructions per element read. Design:
//   split    grid (Hkv, B, splits): a block takes one chunk (512 keys at the
//            main path) of one slot and kv head, so a 4k-key slot spreads
//            over 8 blocks instead of walking its 2 MB alone; a block past
//            the slot's last key exits at once;
//   copies   each of 4 warps takes the chunk's 16-key tiles w, w + 4, ...
//            through its own ring of 3 stages of K and V tiles, filled by
//            16-byte cp.async (rows XOR-swizzled for ldmatrix; rows past
//            the live keys zero-filled, read nothing), so 2 tiles stay in
//            flight under each tile's arithmetic; two blocks per SM (one
//            at dh 256, whose rings take 192 KiB);
//   products mma.sync m16n8k16 with the keys as M ("swap AB": a group of 4
//            query rows is too few for M): S^T = K Q^T with Q^T padded to
//            n = 8 in registers, then O^T = V^T P^T with V^T's fragments by
//            ldmatrix.trans and P^T moved from the score accumulators by
//            shuffles. mma.sync, not wgmma: the products are a few percent
//            of the issue slots, a 64-row wgmma tile would need 4 pages per
//            step per warpgroup, and per-warp rings need no block-wide
//            barrier in the loop;
//   merge    the 4 warps' (o, m, l) merge exactly in shared memory; the
//            block stores its partial, and the last block of the (slot, kv
//            head) to arrive (one counter per row, wrapped back to 0 by
//            atomicInc, as gemm.cu's split K) sums the partials in split
//            order: one launch per call, two calls bit-equal.
// Softcap and no softcap are two instances (no runtime condition in the
// per-score code).
//
// paged_mla_wgmma (bf16, kv_lora 512, R = kv_lora + rope 512 or 576, pages
// of 8 to 64 rows: deepseek-v2 decode). All H heads of a slot share each
// latent row, so Q (heads x R) K^T is a real tile product. What bounds it:
// at the main path (H 128, R 576, 15,239 live keys) 17.6 MB of rows (5.3
// us) against 4.24 GFLOP (4.3 us at the bf16 tensor-core rate): near the
// ridge. Design:
//   blocks   grid (ceil(H / 64), B, splits): 64 heads (wgmma's M) and one
//            chunk of a slot's keys (8 splits a slot: 512 keys at the main
//            path); three warpgroups, one block per SM (MlaSmem: Q 64 x R
//            and 2 stages of 64 x R key tiles, 222,240 bytes at R 576);
//   copies   one producer thread keeps the ring full by TMA, a box per
//            page of the slot's table into the 128-byte swizzle that
//            wgmma's descriptors read (pages past the slot's last key out
//            of range: zeros, nothing read); Q rides with the first tile.
//            In the slot's last tile the rows past pos of its last page
//            came with the page and are zeroed in shared memory before any
//            product reads them. TMA rather than cp.async: one thread
//            keeps whole pages in flight, and the producer's other threads
//            give their registers to the consumers;
//   products S = Q K^T by wgmma m64n64k16 (R / 16 steps, both operands in
//            shared memory) in both consumer warpgroups, so the softmax and
//            P stay in registers (P through shared memory would need 16 KB
//            more than the block has); then O += P V with V the tile's
//            first 512 columns read MN-major through the descriptor's
//            transpose bit (no copy), each consumer warpgroup owning 256
//            columns (64 x 256 f32 in 128 registers a thread);
//   merge    a partial is 64 x 512 f32 (128 KB), as large as the keys a
//            block reads, so the merge is built to move it as little as
//            possible: clusters of 4 blocks of consecutive splits stage
//            their partials in shared memory and rank r merges 128 of the
//            512 columns through distributed shared memory; a slot with
//            more than one cluster merges the clusters' slices in the last
//            cluster to arrive at each slice (one counter per slice), four
//            blocks at once. One launch per call; every sum in a fixed
//            order, so two calls are bit-equal.
// Precision (both): q, k, v are bf16, so the score products are exact in
// the f32 sums, and the scale is applied to S in f32 after the product.
// Only P would round: it enters P V as two bf16 operands, hi = bf16(p) and
// lo = bf16(p - hi), summed by two products into one f32 accumulator, so p
// keeps 16 bits and the results stay within the f32 checks (1e-4) of the
// Pallas kernels' f32 arithmetic. That doubles only the P V products.
//
// paged_gqa_kernel and paged_mla_kernel + mla_combine (f32, and the shapes
// the tensor-core kernels do not take): CUDA cores in f32, described at
// each.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr int WARPS = 8;
constexpr int MAXD = 256;      // head dim limit of the CUDA-core GQA kernel
constexpr int CHUNK = 32;      // keys per warp step, one per lane
constexpr int KPASS = 8;       // 16-byte K chunks a lane loads together
constexpr int VB = 16;         // V rows whose loads a warp issues together

// eight contiguous elements as raw 16-byte loads (two for f32)
template <typename T> struct Raw8;
template <> struct Raw8<float> {
  struct type { float4 a, b; };
  __device__ static type zero() {
    return {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
  }
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
  __device__ static type zero() { return make_uint4(0u, 0u, 0u, 0u); }
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
// a lane's VPL contiguous value dims as one or two raw loads
template <typename T, int VPL> struct RawV;
template <typename T> struct RawV<T, 4> {
  using type = typename Raw4<T>::type;
  __device__ static type zero() { return Raw4<T>::zero(); }
  __device__ static type load(const T* p) {
    return *reinterpret_cast<const type*>(p);
  }
  __device__ static void unpack(const type& r, float* out) {
    Raw4<T>::unpack(r, out);
  }
};
template <typename T> struct RawV<T, 8> {
  using type = typename Raw8<T>::type;
  __device__ static type zero() { return Raw8<T>::zero(); }
  __device__ static type load(const T* p) { return Raw8<T>::load(p); }
  __device__ static void unpack(const type& r, float* out) {
    Raw8<T>::unpack(r, out);
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

// cudaFuncSetAttribute once per kernel instance and device
template <typename K>
cudaError_t allow_smem(K kernel, int device, int bytes, bool* done) {
  if (device >= 0 && device < 64 && done[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && device >= 0 && device < 64) done[device] = true;
  return err;
}

// ------------------------------------------------ GQA on the CUDA cores
// paged_gqa_kernel (f32, and bf16 at group sizes or head dims that
// paged_gqa_mma does not take). One block per (kv head h, slot b); 8
// warps. Warp w takes chunks of 32 keys (w, w + 8, ...), one key per lane:
//   scores  each lane reads its key's K row, 8 16-byte loads issued
//           before their arithmetic, and dots it with the G query rows of
//           the group (kept scaled in shared memory, read as broadcasts);
//   softmax one warp max and one warp sum per query row and chunk update
//           the warp's running (m, l);
//   values  lanes switch to DC / 32 contiguous dims each (4 at head dims up
//           to 128, 8 up to 256); every key's p is broadcast by a shuffle
//           and its V row read as one coalesced line, 16 rows' loads issued
//           before their arithmetic.
// At the end the 8 warp partials are merged in shared memory with the exact
// rescaling of serve/decode.py::_merge_partials. DC, the head-dim cap of an
// instance (128 or 256), sizes the query rows and the warps' partials in
// dynamic shared memory (gqa_core_smem_bytes): past 48 KB (G > 5 at DC
// 256) the launch opts in to more.
constexpr int gqa_core_smem_bytes(int G, int DC) {
  return 4 * G * (DC * (1 + WARPS) + 2 * WARPS);
}
static_assert(gqa_core_smem_bytes(8, 128) == 37376,
              "gqa_core_smem_bytes(8, 128)");
static_assert(gqa_core_smem_bytes(8, 256) == 74240,
              "gqa_core_smem_bytes(8, 256)");
static_assert(gqa_core_smem_bytes(5, 256) == 46400,
              "gqa_core_smem_bytes(5, 256)");
static_assert(gqa_core_smem_bytes(6, 256) == 55680,
              "gqa_core_smem_bytes(6, 256)");

template <typename T, int G, int DC>
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
  constexpr int VPL = DC / 32;                  // value dims per lane
  extern __shared__ __align__(16) float core_smem[];
  float* s_q = core_smem;                       // [G][DC]
  float* s_acc = s_q + G * DC;                  // [WARPS][G][DC]
  float* s_m = s_acc + WARPS * G * DC;          // [WARPS][G]
  float* s_l = s_m + WARPS * G;                 // [WARPS][G]

  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t head = (size_t)b * hkv + h;
  const T* qb = q + head * G * dh;
  for (int i = threadIdx.x; i < G * DC; i += WARPS * 32) {
    const int g = i / DC, d = i % DC;           // zero past dh
    s_q[i] = d < dh ? to_f(qb[g * dh + d]) * scale : 0.f;
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
  const int d0 = lane * VPL;                    // this lane's value dims

  float m[G], l[G], acc[G][VPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) acc[g][i] = 0.f;
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
          const float4* q4 = reinterpret_cast<const float4*>(s_q + g * DC);
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
      for (int i = 0; i < VPL; ++i) acc[g][i] *= corr;
    }
    const int n = min(CHUNK, n_keys - k0);
    for (int j0 = 0; j0 < n; j0 += VB) {       // VB V rows in flight
      typename RawV<T, VPL>::type vr[VB];
#pragma unroll
      for (int j = 0; j < VB; ++j) {
        const long long oj = __shfl_sync(0xffffffffu, off, j0 + j);
        if (j0 + j < n && d0 < dh)
          vr[j] = RawV<T, VPL>::load(pool_v + oj + d0);
        else
          vr[j] = RawV<T, VPL>::zero();
      }
#pragma unroll
      for (int j = 0; j < VB; ++j) {
        float v[VPL];
        RawV<T, VPL>::unpack(vr[j], v);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pj = __shfl_sync(0xffffffffu, pr[g], j0 + j);
#pragma unroll
          for (int i = 0; i < VPL; ++i) acc[g][i] += pj * v[i];
        }
      }
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      s_m[warp * G + g] = m[g];
      s_l[warp * G + g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < VPL; ++i)
      s_acc[(warp * G + g) * DC + d0 + i] = acc[g][i];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < G * dh; idx += WARPS * 32) {
    const int g = idx / dh, d = idx % dh;
    float mg = NEG;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mg = fmaxf(mg, s_m[w * G + g]);
    const float m_safe = mg <= NEG / 2 ? 0.f : mg;
    float ov = 0.f, lv = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float mw = s_m[w * G + g];
      const float c = expf((mw <= NEG / 2 ? NEG : mw) - m_safe);
      ov += s_acc[(w * G + g) * DC + d] * c;
      lv += s_l[w * G + g] * c;
    }
    const size_t r = head * G + g;
    o[r * dh + d] = ov;
    if (d == 0) {
      m_out[r] = mg;
      l_out[r] = lv;
    }
  }
}

template <typename T, int G, int DC>
cudaError_t launch(int device, const void* q, const void* pk, const void* pv,
                   const int* table, const int* pos, float* o, float* m,
                   float* l, int B, int hkv, int dh, int n_pages, int ps,
                   int width, int page_size, int base, float scale,
                   float softcap, cudaStream_t stream) {
  constexpr int smem = gqa_core_smem_bytes(G, DC);
  if (smem > 48 * 1024) {
    static bool done[64] = {};
    const cudaError_t err =
        allow_smem(paged_gqa_kernel<T, G, DC>, device, smem, done);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(hkv, B);
  paged_gqa_kernel<T, G, DC><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pk),
      static_cast<const T*>(pv), table, pos, o, m, l, n_pages, ps, hkv, dh,
      width, page_size, base, scale, softcap);
  return cudaGetLastError();
}

template <typename T, int DC>
cudaError_t dispatch_dc(int device, int G, const void* q, const void* pk,
                        const void* pv, const int* table, const int* pos,
                        float* o, float* m, float* l, int B, int hkv, int dh,
                        int n_pages, int ps, int width, int page_size,
                        int base, float scale, float softcap,
                        cudaStream_t stream) {
#define PAGED_CASE(NG)                                                     \
  case NG:                                                                 \
    return launch<T, NG, DC>(device, q, pk, pv, table, pos, o, m, l, B,    \
                             hkv, dh, n_pages, ps, width, page_size, base, \
                             scale, softcap, stream);
  switch (G) {
    PAGED_CASE(1) PAGED_CASE(2) PAGED_CASE(3) PAGED_CASE(4)
    PAGED_CASE(5) PAGED_CASE(6) PAGED_CASE(7) PAGED_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef PAGED_CASE
}

// the instance of the smallest head-dim cap that holds dh
template <typename T>
cudaError_t dispatch(int device, int G, const void* q, const void* pk,
                     const void* pv, const int* table, const int* pos,
                     float* o, float* m, float* l, int B, int hkv, int dh,
                     int n_pages, int ps, int width, int page_size, int base,
                     float scale, float softcap, cudaStream_t stream) {
  if (dh <= 128)
    return dispatch_dc<T, 128>(device, G, q, pk, pv, table, pos, o, m, l, B,
                               hkv, dh, n_pages, ps, width, page_size, base,
                               scale, softcap, stream);
  return dispatch_dc<T, MAXD>(device, G, q, pk, pv, table, pos, o, m, l, B,
                              hkv, dh, n_pages, ps, width, page_size, base,
                              scale, softcap, stream);
}

// ------------------------------------------------ GQA on the tensor cores
// paged_gqa_mma (bf16, G <= 8, dh 64, 128 or 256: the served models'
// path). See the note on top of this file.
constexpr int GQ_WARPS = 4;
constexpr int GQ_THREADS = GQ_WARPS * 32;
constexpr int GQ_TILE = 16;      // keys per warp step: the M of m16n8k16
constexpr int GQ_STAGES = 3;     // a warp's tiles in flight
constexpr int GQ_N = 8;          // the group's query rows, padded to mma's n
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Shared memory of one block (paged_attention/ops.py::gqa_smem_bytes): each
// warp's ring of GQ_STAGES K and V tiles of GQ_TILE rows of dh bf16. The
// warps' partials, merged at the end, reuse it.
constexpr int gqa_ring_bytes(int dh) {
  return GQ_WARPS * GQ_STAGES * 2 * GQ_TILE * dh * 2;
}
constexpr int gqa_merge_bytes(int dh) {
  return GQ_WARPS * GQ_N * (dh + 2) * 4;
}
template <int DH>
struct GqaSmem {
  static constexpr int bytes = gqa_ring_bytes(DH);
  static_assert(gqa_merge_bytes(DH) <= bytes, "the merge reuses the ring");
};
static_assert(GqaSmem<64>::bytes == 49152, "gqa_smem_bytes(64)");
static_assert(GqaSmem<128>::bytes == 98304, "gqa_smem_bytes(128)");
static_assert(GqaSmem<256>::bytes == 196608, "gqa_smem_bytes(256)");
// two blocks per SM: 228 KiB, 1 KiB reserved for each block
static_assert(2 * (GqaSmem<128>::bytes + 1024) <= 228 * 1024,
              "two GQA blocks per SM");

// Live keys of slot b: a prefix of the page-table order (see the note on
// top); 0 when pos lies before the shard base.
__device__ __forceinline__ int live_keys(const int* pos, int b, int base,
                                         int page_size, int ps, int width) {
  const int p = pos[b];
  if (p < base) return 0;
  const int t_last = (p - base) / page_size;
  const int off_last = (p - base) - t_last * page_size;
  return min(t_last * ps + min(ps, off_last + 1), width * ps);
}

// Byte offset of 16-byte chunk c of row r in a tile whose rows are ROWB
// bytes: chunks XOR-swizzled by r % 8, so ldmatrix's 8 rows of one chunk
// column hit 8 distinct bank groups.
template <int ROWB>
__device__ __forceinline__ int swz(int r, int c) {
  return r * ROWB + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// p as two bf16 pairs, hi = bf16(p) and lo = bf16(p - hi): the P operand of
// P V in two products, so P enters the f32 sum with 16 bits, not 8.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - f.x, b - f.y);
}

// Grid (Hkv, B, splits): block (h, b, z) takes keys [z chunk, (z + 1)
// chunk) of slot b's live keys for kv head h; a block past the slot's last
// key exits at once. Warp w takes the block's 16-key tiles w, w + 4, ...
// through its own ring. The block's partial (log2 units) goes to ws_*
// (splits, B, Hkv, G[, dh]); the last block of (b, h) to arrive (cnt, one
// counter per (b, h), wrapped back to 0 by atomicInc) merges them in split
// order. A slot with one live split writes o, m, l directly.
template <int DH, bool CAP>
__global__ void __launch_bounds__(GQ_THREADS)
paged_gqa_mma(const __nv_bfloat16* __restrict__ q,       // (B, Hkv, G, dh)
              const __nv_bfloat16* __restrict__ pool_k,  // (N, ps, Hkv, dh)
              const __nv_bfloat16* __restrict__ pool_v,
              const int* __restrict__ table,             // (B, width)
              const int* __restrict__ pos,               // (B,)
              float* __restrict__ o,                     // (B, Hkv G, dh)
              float* __restrict__ m_out, float* __restrict__ l_out,
              float* __restrict__ ws_o, float* __restrict__ ws_m,
              float* __restrict__ ws_l, unsigned* __restrict__ cnt, int G,
              int n_pages, int ps, int hkv, int width, int page_size,
              int base, float scale, float softcap, int chunk) {
  constexpr int ROWB = DH * 2;             // bytes of a K or V row
  constexpr int TILEB = GQ_TILE * ROWB;
  constexpr int CPR = DH / 8;              // 16-byte chunks per row
  constexpr int RPI = 32 / CPR;            // rows one warp copy covers
  constexpr int NM = DH / 16;              // k steps of S, m tiles of O
  extern __shared__ __align__(128) uint8_t gq_smem[];
  __shared__ unsigned last;
  const int h = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t head = (size_t)b * hkv + h;
  const int n_keys = live_keys(pos, b, base, page_size, ps, width);
  if (n_keys == 0) {                 // nothing live: split 0 says so
    if (z == 0) {
      for (int i = tid; i < G * DH; i += GQ_THREADS) o[head * G * DH + i] = 0.f;
      if (tid < G) {
        m_out[head * G + tid] = NEG;
        l_out[head * G + tid] = 0.f;
      }
    }
    return;
  }
  const int n_live = (n_keys + chunk - 1) / chunk;   // splits with a key
  if (z >= n_live) return;
  const int k_begin = z * chunk, k_end = min(n_keys, k_begin + chunk);
  const int n_tiles = (k_end - k_begin + GQ_TILE - 1) / GQ_TILE;
  const int my_tiles =
      n_tiles > warp ? (n_tiles - warp + GQ_WARPS - 1) / GQ_WARPS : 0;

  // Q^T as mma's B operand (k = dh, n = query row g of the group), zero
  // past G; bf16 as given, the scale applied to S in f32
  uint32_t qf[NM][2];
  const __nv_bfloat16* qg = q + (head * G + min(g, G - 1)) * DH + 2 * t;
#pragma unroll
  for (int kk = 0; kk < NM; ++kk) {
    qf[kk][0] = g < G ? ld_u32(qg + 16 * kk) : 0u;
    qf[kk][1] = g < G ? ld_u32(qg + 16 * kk + 8) : 0u;
  }

  uint8_t* ring = gq_smem + warp * GQ_STAGES * 2 * TILEB;
  const long long row_el = (long long)hkv * DH;   // elements per pool row
  const int* tb = table + (size_t)b * width;
  // this warp's j-th tile into stage j % GQ_STAGES as one cp.async group
  // (an empty group past its last tile); rows past the live keys are
  // zero-filled and read nothing
  auto issue = [&](int j) {
    if (j < my_tiles) {
      const int key0 = k_begin + (warp + GQ_WARPS * j) * GQ_TILE;
      long long off = -1;              // lane r < 16: row r's offset
      if (lane < GQ_TILE && key0 + lane < k_end) {
        const int kk = key0 + lane;
        const int page = min(max(tb[kk / ps], 0), n_pages - 1);
        off = ((long long)page * ps + kk % ps) * row_el + (long long)h * DH;
      }
      uint8_t* ks = ring + (j % GQ_STAGES) * 2 * TILEB;
      uint8_t* vs = ks + TILEB;
      const int c = lane % CPR;
#pragma unroll
      for (int i = 0; i < GQ_TILE / RPI; ++i) {
        const int r = lane / CPR + RPI * i;
        const long long ro = __shfl_sync(0xffffffffu, off, r);
        const bool ok = ro >= 0;
        const long long src = ok ? ro + c * 8 : 0;
        cp_async16(ks + swz<ROWB>(r, c), pool_k + src, ok);
        cp_async16(vs + swz<ROWB>(r, c), pool_v + src, ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < GQ_STAGES; ++j) issue(j);

  float oacc[NM][4];                   // O^T: d 16 mt + g (+ 8), q 2t (+ 1)
#pragma unroll
  for (int mt = 0; mt < NM; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) oacc[mt][i] = 0.f;
  float mrow[2] = {NEG, NEG}, lrow[2] = {0.f, 0.f};   // q 2t, 2t + 1
  const float sl = CAP ? scale / softcap : scale * LOG2E;
  const float cap2 = softcap * LOG2E;
  const int srcA = 8 * t + (g >> 1), srcB = srcA + 4;
  const bool odd = g & 1;

  for (int j = 0; j < my_tiles; ++j) {
    cp_async_wait<GQ_STAGES - 1>();
    __syncwarp();                      // every lane's copies of tile j
    const uint8_t* ks = ring + (j % GQ_STAGES) * 2 * TILEB;
    const uint8_t* vs = ks + TILEB;
    const int key0 = k_begin + (warp + GQ_WARPS * j) * GQ_TILE;

    // S^T = K Q^T: s[0] (key g, q 2t), s[1] (g, 2t + 1), s[2] (g + 8, 2t),
    // s[3] (g + 8, 2t + 1)
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < NM; ++kk) {
      const int r = lane & 15;
      uint32_t a[4];
      ldsm_x4(a, ks + swz<ROWB>(r, 2 * kk + (lane >> 4)));
      mma_bf16(s, a, qf[kk][0], qf[kk][1]);
    }
    // scores in log2 units; keys past the live ones (only in a slot's last
    // tile) become NEG
    const int n_ok = k_end - key0;     // >= 1: a tile starts on a live key
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = CAP ? tanhf(s[i] * sl) * cap2 : s[i] * sl;
      s[i] = g + 8 * (i >> 1) < n_ok ? x : NEG;
    }
    float mx0 = fmaxf(s[0], s[2]), mx1 = fmaxf(s[1], s[3]);
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(mrow[0], mx0), mn1 = fmaxf(mrow[1], mx1);
    const float c0 = exp2f(mrow[0] - mn0), c1 = exp2f(mrow[1] - mn1);
    mrow[0] = mn0;
    mrow[1] = mn1;
    const float p0 = exp2f(s[0] - mn0), p1 = exp2f(s[1] - mn1);
    const float p2 = exp2f(s[2] - mn0), p3 = exp2f(s[3] - mn1);
    lrow[0] = lrow[0] * c0 + p0 + p2;
    lrow[1] = lrow[1] * c1 + p1 + p3;
#pragma unroll
    for (int mt = 0; mt < NM; ++mt) {
      oacc[mt][0] *= c0;
      oacc[mt][1] *= c1;
      oacc[mt][2] *= c0;
      oacc[mt][3] *= c1;
    }
    // P^T as mma's B operand (k = key, n = q): lane (g, t) needs P of
    // query g at keys 2t, 2t + 1, 2t + 8, 2t + 9, held by lanes srcA (keys
    // 2t, 2t + 8) and srcB (2t + 1, 2t + 9) at the register of q's parity
    const float a0 = __shfl_sync(0xffffffffu, p0, srcA);
    const float a1 = __shfl_sync(0xffffffffu, p1, srcA);
    const float a2 = __shfl_sync(0xffffffffu, p2, srcA);
    const float a3 = __shfl_sync(0xffffffffu, p3, srcA);
    const float b0 = __shfl_sync(0xffffffffu, p0, srcB);
    const float b1 = __shfl_sync(0xffffffffu, p1, srcB);
    const float b2 = __shfl_sync(0xffffffffu, p2, srcB);
    const float b3 = __shfl_sync(0xffffffffu, p3, srcB);
    uint32_t ph[2], pl[2];
    split_bf16(odd ? a1 : a0, odd ? b1 : b0, ph[0], pl[0]);
    split_bf16(odd ? a3 : a2, odd ? b3 : b2, ph[1], pl[1]);
    // O^T += V^T P^T: V^T's fragments by ldmatrix.trans of the V tile
#pragma unroll
    for (int mt = 0; mt < NM; ++mt) {
      const int r = (lane & 7) + 8 * (lane >> 4);
      uint32_t a[4];
      ldsm_x4_t(a, vs + swz<ROWB>(r, 2 * mt + ((lane >> 3) & 1)));
      mma_bf16(oacc[mt], a, ph[0], ph[1]);
      mma_bf16(oacc[mt], a, pl[0], pl[1]);
    }
    __syncwarp();                      // the stage is read: refill it
    issue(j + GQ_STAGES);
  }
  cp_async_wait<0>();

  // the warps' partials through shared memory (the ring is free), merged
  // exactly: rescale each by exp2(m_w - max m) and sum in warp order
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
      lrow[rr] += __shfl_xor_sync(0xffffffffu, lrow[rr], off);
  __syncthreads();
  float* s_o = reinterpret_cast<float*>(gq_smem);   // [warp][q][dh]
  float* s_m = s_o + GQ_WARPS * GQ_N * DH;          // [warp][q]
  float* s_l = s_m + GQ_WARPS * GQ_N;
#pragma unroll
  for (int mt = 0; mt < NM; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      s_o[(warp * GQ_N + 2 * t + (i & 1)) * DH + 16 * mt + g + 8 * (i >> 1)] =
          oacc[mt][i];
  if (g == 0) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      s_m[warp * GQ_N + 2 * t + rr] = mrow[rr];
      s_l[warp * GQ_N + 2 * t + rr] = lrow[rr];
    }
  }
  __syncthreads();
  const bool direct = n_live == 1;
  const size_t part = (size_t)z * gridDim.y * hkv + head;   // ws row block
  for (int idx = tid; idx < G * DH; idx += GQ_THREADS) {
    const int gq = idx / DH, d = idx % DH;
    float mg = NEG;
#pragma unroll
    for (int w = 0; w < GQ_WARPS; ++w) mg = fmaxf(mg, s_m[w * GQ_N + gq]);
    float ov = 0.f, lv = 0.f;          // mg is live: warp 0 has a tile
#pragma unroll
    for (int w = 0; w < GQ_WARPS; ++w) {
      const float c = exp2f(s_m[w * GQ_N + gq] - mg);
      ov += s_o[(w * GQ_N + gq) * DH + d] * c;
      lv += s_l[w * GQ_N + gq] * c;
    }
    if (direct) {
      o[(head * G + gq) * DH + d] = ov;
      if (d == 0) {
        m_out[head * G + gq] = mg * LN2;
        l_out[head * G + gq] = lv;
      }
    } else {
      ws_o[(part * G + gq) * DH + d] = ov;
      if (d == 0) {
        ws_m[part * G + gq] = mg;
        ws_l[part * G + gq] = lv;
      }
    }
  }
  if (direct) return;

  // the last block of (b, h) to arrive merges the splits' partials
  __threadfence();                     // this block's partial before its count
  __syncthreads();
  if (tid == 0)
    last = atomicInc(cnt + head, n_live - 1) == (unsigned)(n_live - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const size_t stride = (size_t)gridDim.y * hkv;      // one split's rows
  for (int idx = tid; idx < G * DH; idx += GQ_THREADS) {
    const int gq = idx / DH, d = idx % DH;
    float mg = NEG;
    for (int zz = 0; zz < n_live; ++zz)
      mg = fmaxf(mg, __ldcg(ws_m + (zz * stride + head) * G + gq));
    float ov = 0.f, lv = 0.f;
    for (int zz = 0; zz < n_live; ++zz) {
      const size_t r = (zz * stride + head) * G + gq;
      const float c = exp2f(__ldcg(ws_m + r) - mg);
      ov += __ldcg(ws_o + r * DH + d) * c;
      lv += __ldcg(ws_l + r) * c;
    }
    o[(head * G + gq) * DH + d] = ov;
    if (d == 0) {
      m_out[head * G + gq] = mg * LN2;
      l_out[head * G + gq] = lv;
    }
  }
}

template <int DH, bool CAP>
cudaError_t launch_gqa_mma(int device, const void* q, const void* pk,
                           const void* pv, const int* table, const int* pos,
                           float* o, float* m, float* l, float* ws_o,
                           float* ws_m, float* ws_l, unsigned* cnt, int B,
                           int hkv, int G, int n_pages, int ps, int width,
                           int page_size, int base, float scale,
                           float softcap, int splits, int chunk,
                           cudaStream_t stream) {
  constexpr int smem = GqaSmem<DH>::bytes;
  static bool done[64] = {};
  cudaError_t err = allow_smem(paged_gqa_mma<DH, CAP>, device, smem, done);
  if (err != cudaSuccess) return err;
  dim3 grid(hkv, B, splits);
  paged_gqa_mma<DH, CAP><<<grid, GQ_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(pk),
      static_cast<const __nv_bfloat16*>(pv), table, pos, o, m, l, ws_o, ws_m,
      ws_l, cnt, G, n_pages, ps, hkv, width, page_size, base, scale, softcap,
      chunk);
  return cudaGetLastError();
}

cudaError_t dispatch_gqa_mma(int device, int dh, float softcap,
                             const void* q, const void* pk, const void* pv,
                             const int* table, const int* pos, float* o,
                             float* m, float* l, float* ws_o, float* ws_m,
                             float* ws_l, unsigned* cnt, int B, int hkv,
                             int G, int n_pages, int ps, int width,
                             int page_size, int base, float scale,
                             int splits, int chunk, cudaStream_t stream) {
#define GQA_MMA(D, C)                                                        \
  return launch_gqa_mma<D, C>(device, q, pk, pv, table, pos, o, m, l, ws_o,  \
                              ws_m, ws_l, cnt, B, hkv, G, n_pages, ps,       \
                              width, page_size, base, scale, softcap,        \
                              splits, chunk, stream)
  const bool cap = softcap > 0.f;
  if (dh == 64) {
    if (cap) GQA_MMA(64, true);
    GQA_MMA(64, false);
  }
  if (dh == 128) {
    if (cap) GQA_MMA(128, true);
    GQA_MMA(128, false);
  }
  if (dh == 256) {
    if (cap) GQA_MMA(256, true);
    GQA_MMA(256, false);
  }
#undef GQA_MMA
  return cudaErrorInvalidValue;
}

// ------------------------------------------- absorbed MLA on the CUDA cores
// paged_mla_kernel (f32, and shapes paged_mla_wgmma does not take): one
// absorbed query row q (R = kv_lora + rope dims) per (slot, head) attends
// to the latent rows of one pool (N, ps, R); the row is the key and its
// first kv_lora dims the value. The grid is (head group of MLA_HB = 8
// heads, slot, key split); each block walks its chunk in tiles of MLA_KT =
// 32 rows:
//   load    the tile's rows once into shared memory as f32 (row stride R +
//           1 floats so a warp reading one dim of 32 rows hits 32 banks);
//           every row then serves all 8 heads of the block;
//   scores  lane j takes key j, warp w a 1/8 slice of the R dims, and each
//           thread keeps the 8 heads' partial dots; the 8 slices are summed
//           through shared memory;
//   softmax warp h keeps head h's running (m, l) over the tile's 32 keys;
//   values  thread t owns value dims t and t + 256 of all 8 heads.
// With more than one split, each block stores its (o, m, l) partial and
// mla_combine, a second launch, merges a row's partials exactly.
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

// --------------------------------------- absorbed MLA on the tensor cores
// paged_mla_wgmma (bf16, kv_lora 512, R 512 or 576: deepseek-v2's path).
// See the note above.
constexpr int ML_M = 64;           // heads per block: wgmma's M
constexpr int ML_KT = 64;          // keys per tile
constexpr int ML_LORA = 512;       // value dims: 256 per consumer warpgroup
constexpr int ML_STAGES = 2;       // key tiles in flight
constexpr int ML_CLUSTER = 4;      // blocks of consecutive splits merged
                                   // through distributed shared memory
constexpr int ML_OP = ML_LORA + 8; // floats per staged partial row (padded)
constexpr int ML_CONSUMERS = 256;  // two consumer warpgroups
constexpr int ML_LOADERS = 128;    // the producer warpgroup (one TMA thread)
constexpr int ML_THREADS = ML_CONSUMERS + ML_LOADERS;
// Registers per thread after the split (setmaxnreg). The block launches
// with 168 a thread (65,536 / 384, in steps of 8), and setmaxnreg.inc takes
// only what the producer's setmaxnreg.dec gave back: 128 x (168 - 40) =
// 256 x (232 - 168)
constexpr int ML_LAUNCH_REGS = 65536 / ML_THREADS / 8 * 8;
constexpr int ML_PRODUCER_REGS = 40, ML_CONSUMER_REGS = 232;
static_assert(ML_LOADERS * (ML_LAUNCH_REGS - ML_PRODUCER_REGS) >=
                  ML_CONSUMERS * (ML_CONSUMER_REGS - ML_LAUNCH_REGS),
              "the consumers' registers come from the producer");
static_assert(ML_LORA == 2 * 256, "each consumer warpgroup owns 256 values");

// Shared memory of one block (paged_attention/ops.py::mla_smem_bytes): Q
// (64 x R), a ring of ML_STAGES key tiles (64 x R), bf16, full and empty
// mbarriers per stage, and the 1024-byte alignment of the 128-byte
// swizzle. Each tile is R / 64 column blocks of 64 rows x 128 bytes.
constexpr int mla_wgmma_bytes(int R) {
  return SMEM_ALIGN + (ML_M + ML_STAGES * ML_KT) * R * 2 + 8 * 2 * ML_STAGES;
}
template <int R>
struct MlaSmem {
  static constexpr int q = ML_M * R * 2;
  static constexpr int stage = ML_KT * R * 2;
  static constexpr int bytes = mla_wgmma_bytes(R);
  static_assert(R % 64 == 0 && R >= ML_LORA, "R: 64-column blocks");
  static_assert(bytes <= SMEM_LIMIT, "one block's shared memory");
  static_assert(ML_M * ML_OP * 4 + 2 * ML_M * 4 * (1 + ML_CLUSTER) <=
                    q + ML_STAGES * stage,
                "the staged partial and the cluster's m, l fit over Q and "
                "the ring");
};
static_assert(ML_LORA == 128 * ML_CLUSTER && ML_M % (ML_CONSUMERS / 32) == 0,
              "a cluster block's slice: a float4 a lane, a row a warp");
static_assert(MlaSmem<512>::bytes == 197664, "mla_smem_bytes(512)");
static_assert(MlaSmem<576>::bytes == 222240, "mla_smem_bytes(576)");

// 16-byte chunk c of row r of a 64-row tile in the 128-byte swizzle that
// wgmma's descriptors read (column block c / 8, 1024-byte aligned)
__device__ __forceinline__ int sw128(int r, int c) {
  return (c >> 3) * (64 * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// A tile's scores (64 x 64 per warpgroup, the wgmma accumulator layout)
// and their row maxima mx; MASK: keys at or past n_ok become NEG (only a
// slot's last tile).
template <bool MASK>
__device__ __forceinline__ void mla_scores(float* sacc, float* mx, int n_ok,
                                           int tg) {
  mx[0] = mx[1] = NEG;
#pragma unroll
  for (int j = 0; j < ML_KT / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x = sacc[4 * j + i];
      if (MASK && 8 * j + 2 * tg + (i & 1) >= n_ok) x = NEG;
      sacc[4 * j + i] = x;
      mx[i >> 1] = fmaxf(mx[i >> 1], x);
    }
}

// Thread-block clusters: the ML_CLUSTER blocks of consecutive splits of
// one (slot, head group) are scheduled together and read each other's
// shared memory, which the merge uses.
__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The address of p's counterpart in the shared memory of cluster block rank
__device__ __forceinline__ uint32_t cluster_addr(const void* p, uint32_t rank) {
  uint32_t d;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(d)
               : "r"(smem_addr(p)), "r"(rank));
  return d;
}

__device__ __forceinline__ float ld_cluster(uint32_t a) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ float4 ld_cluster4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

// Grid (ceil(H / 64), B, splits rounded up to ML_CLUSTER), clusters of
// ML_CLUSTER along z: block (hg, b, z) takes heads [64 hg, 64 hg + 64) and
// keys [z chunk, (z + 1) chunk) of slot b's live keys. A cluster past the
// slot's last key exits at once; a block past it in a live cluster takes
// part in the merge with an empty partial. The merge (log2 units):
//   cluster  each block stages its partial (64 x 512 f32, m, l) in its
//            shared memory; after a cluster barrier, rank r merges columns
//            [128 r, 128 r + 128) of the cluster's partials in rank order,
//            read through distributed shared memory; the slot's only
//            cluster writes o, m, l;
//   slices   otherwise rank r stores its slice of the cluster's partial
//            in ws (cluster, B, H, 512) and counts its arrival at slice r
//            (one counter per (slot, head group, slice), wrapped back to 0
//            by atomicInc); the last cluster to arrive at a slice merges
//            the clusters' slices in cluster order into o. The four slices
//            merge in four blocks at once.
// Two calls give the same bits: every sum runs in a fixed order.
template <int R>
__global__ void __launch_bounds__(ML_THREADS, 1)
    __cluster_dims__(1, 1, ML_CLUSTER)
paged_mla_wgmma(const __grid_constant__ CUtensorMap tq,   // q (R, H, B)
                const __grid_constant__ CUtensorMap tp,   // pool (R, ps, N)
                const int* __restrict__ table,            // (B, width)
                const int* __restrict__ pos,              // (B,)
                float* __restrict__ o,                    // (B, H, 512)
                float* __restrict__ m_out, float* __restrict__ l_out,
                float* __restrict__ ws_o, float* __restrict__ ws_m,
                float* __restrict__ ws_l, unsigned* __restrict__ cnt, int H,
                int n_pages, int ps, int width, int page_size, int base,
                float scale, int chunk) {
  using SM = MlaSmem<R>;
  constexpr int CPR = R / 8;           // 16-byte chunks per row
  extern __shared__ __align__(1024) uint8_t ml_smem[];
  __shared__ unsigned last;
  const int hg = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int h0 = hg * ML_M, B = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int n_keys = live_keys(pos, b, base, page_size, ps, width);
  if (n_keys == 0) {                 // nothing live: split 0 says so
    if (z == 0) {
      const int rows = min(ML_M, H - h0);
      for (int i = tid; i < rows * ML_LORA; i += ML_THREADS)
        o[((size_t)b * H + h0) * ML_LORA + i] = 0.f;
      if (tid < rows) {
        m_out[(size_t)b * H + h0 + tid] = NEG;
        l_out[(size_t)b * H + h0 + tid] = 0.f;
      }
    }
    return;
  }
  const int n_live = (n_keys + chunk - 1) / chunk;
  const int cl = z / ML_CLUSTER;
  if (cl * ML_CLUSTER >= n_live) return;       // the whole cluster
  const bool live = z < n_live;
  const int k_begin = z * chunk, k_end = min(n_keys, k_begin + chunk);
  const int n_tiles = live ? (k_end - k_begin + ML_KT - 1) / ML_KT : 0;

  uint8_t* sm = smem_base(ml_smem);
  uint8_t* Qs = sm;
  uint8_t* ring = sm + SM::q;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ML_STAGES * SM::stage);
  uint64_t* empty = full + ML_STAGES;
  // the staged partial, over Q and the ring once the tiles are consumed
  float* s_o = reinterpret_cast<float*>(sm);       // 64 x ML_OP
  float* s_m = s_o + ML_M * ML_OP;
  float* s_l = s_m + ML_M;
  if (tid == 0) {
    for (int s = 0; s < ML_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], ML_CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= ML_CONSUMERS) {
    // the producer: one thread keeps the ring full by TMA, a page per box
    // (the slot's pages through its table; pages past its last key out of
    // range, so TMA writes zeros and reads nothing); Q rides with tile 0.
    // Its registers go to the consumers.
    reg_dealloc<ML_PRODUCER_REGS>();
    if (tid == ML_CONSUMERS && live) {
      const int* tb = table + (size_t)b * width;
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % ML_STAGES;
        if (t >= ML_STAGES) mbar_wait(&empty[s], (t / ML_STAGES - 1) & 1);
        uint8_t* st = ring + s * SM::stage;
        mbar_expect_tx(&full[s], SM::stage + (t == 0 ? SM::q : 0));
        if (t == 0)
          for (int c = 0; c < R / 64; ++c)
            tma_load(Qs + c * ML_M * 128, &tq, &full[s], c * 64, h0, b);
        const int key0 = k_begin + t * ML_KT;   // a multiple of ps
        for (int j = 0; j < ML_KT / ps; ++j) {
          const int k = key0 + j * ps;
          const int page =
              k < k_end ? min(max(tb[k / ps], 0), n_pages - 1) : n_pages;
          for (int c = 0; c < R / 64; ++c)
            tma_load(st + c * ML_KT * 128 + j * ps * 128, &tp, &full[s],
                     c * 64, 0, page);
        }
      }
    }
    cluster_sync_all();                // the partials are staged
    cluster_sync_all();                // the cluster's smem is read
    return;
  }

  // a consumer warpgroup: S = Q K^T for all 64 heads and keys of the tile
  // (both warpgroups: the softmax stays in registers), then O += P V on its
  // 256 value columns, P as hi + lo bf16 products
  reg_alloc<ML_CONSUMER_REGS>();
  const int lane = tid & 31;
  const int wg = warp >> 2, wl = warp & 3, gq = lane >> 2, tg = lane & 3;
  const float xs = scale * LOG2E;
  float oacc[128];                     // two n128 halves of the 256 columns
#pragma unroll
  for (int i = 0; i < 128; ++i) oacc[i] = 0.f;
  float sacc[ML_KT / 2];
  uint32_t ph[ML_KT / 16][4], pl[ML_KT / 16][4];
  float mrow[2] = {NEG, NEG}, lrow[2] = {0.f, 0.f};
  const __nv_bfloat16* Qb = reinterpret_cast<const __nv_bfloat16*>(Qs);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % ML_STAGES;
    const __nv_bfloat16* Ks =
        reinterpret_cast<const __nv_bfloat16*>(ring + s * SM::stage);
    mbar_wait(&full[s], (t / ML_STAGES) & 1);
    const int n_ok = k_end - (k_begin + t * ML_KT);
    if (n_ok < ML_KT && n_ok % ps) {
      // the slot's last page is partly live: its rows past pos came with
      // the page; zeros take their place before any product reads them
      const int r1 = (n_ok + ps - 1) / ps * ps;
      uint8_t* st = ring + s * SM::stage;
      for (int i = tid; i < (r1 - n_ok) * CPR; i += ML_CONSUMERS)
        *reinterpret_cast<uint4*>(st + sw128(n_ok + i / CPR, i % CPR)) =
            make_uint4(0u, 0u, 0u, 0u);
      fence_async_shared();
      named_sync(1, ML_CONSUMERS);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk) {
      const int c = kk / 4, k4 = (kk % 4) * 16;
      WgmmaSS<ML_KT>::run<0, 0>(
          sacc, sw128_desc(Qb + c * ML_M * 64 + k4, 16, 1024),
          sw128_desc(Ks + c * ML_KT * 64 + k4, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait<0>();
    reg_fence<ML_KT / 2>(sacc);

    float mx[2];
    if (n_ok < ML_KT)
      mla_scores<true>(sacc, mx, n_ok, tg);
    else
      mla_scores<false>(sacc, mx, n_ok, tg);
    float msafe[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float m_new = fmaxf(mrow[rr], mx[rr] * xs);  // key 0 is live
      const float corr = exp2f(mrow[rr] - m_new);
      mrow[rr] = m_new;
      msafe[rr] = m_new;
      lrow[rr] *= corr;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        oacc[4 * j + 2 * rr] *= corr;
        oacc[4 * j + 2 * rr + 1] *= corr;
      }
    }
#pragma unroll
    for (int j = 0; j < ML_KT / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = exp2f(fmaf(sacc[4 * j + i], xs, -msafe[i >> 1]));
        sacc[4 * j + i] = p;
        lrow[i >> 1] += p;
      }
    // P in mma.sync's A fragment layout (the accumulator's), hi and lo
#pragma unroll
    for (int kk = 0; kk < ML_KT / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_bf16(sacc[8 * kk + 2 * e], sacc[8 * kk + 2 * e + 1], ph[kk][e],
                   pl[kk][e]);
    // V: the tile's first 512 columns, MN-major (the transpose bit)
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < ML_KT / 16; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint64_t dv = sw128_desc(
            Ks + (4 * wg + 2 * half) * ML_KT * 64 + kk * 16 * 64,
            ML_KT * 128, 1024);
        WgmmaRS<128>::run<1>(oacc + 64 * half, ph[kk], dv, 1);
        WgmmaRS<128>::run<1>(oacc + 64 * half, pl[kk], dv, 1);
      }
    wg_commit();
    wg_wait<0>();
    reg_fence<128>(oacc);
    reg_fence<ML_KT / 4>(&ph[0][0]);
    reg_fence<ML_KT / 4>(&pl[0][0]);
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    lrow[rr] += __shfl_xor_sync(0xffffffffu, lrow[rr], 1);
    lrow[rr] += __shfl_xor_sync(0xffffffffu, lrow[rr], 2);
  }
  // stage the partial: row 16 wl + gq (+ 8), columns 256 wg + 128 half +
  // 8 j + 2 tg (+ 1), from oacc[64 half + 4 j + 2 rr (+ 1)]; Q and the
  // ring are free once both warpgroups' products have completed
  named_sync(1, ML_CONSUMERS);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = 16 * wl + gq + 8 * rr;
    float* dst = s_o + row * ML_OP + 256 * wg + 2 * tg;
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<float2*>(dst + 128 * half + 8 * j) =
            make_float2(oacc[64 * half + 4 * j + 2 * rr],
                        oacc[64 * half + 4 * j + 2 * rr + 1]);
    if (wg == 0 && tg == 0) {
      s_m[row] = mrow[rr];             // NEG: a block past the last key
      s_l[row] = lrow[rr];
    }
  }
  cluster_sync_all();

  // rank r: columns [CPB r, CPB r + CPB) of the cluster's partials, in
  // rank order. Lane l of warp w takes columns CPB r + 4 l .. + 3 of rows
  // w, w + 8, ...: a warp reads and writes one row's slice contiguously
  // (no bank conflicts in the remote shared memory, whole lines to L2).
  // The partials' m and l come over first. Every block staged finite
  // values (zeros and m = NEG past the last key), so all loads issue at
  // once.
  constexpr int CPB = ML_LORA / ML_CLUSTER;        // one lane's float4 each
  constexpr int RPW = ML_M / (ML_CONSUMERS / 32);  // rows a warp takes
  const uint32_t rank = cluster_rank();
  const int c0 = CPB * rank + 4 * lane;
  float* c_m = s_l + ML_M;                         // [rank][row]
  float* c_l = c_m + ML_CLUSTER * ML_M;
  for (int i = tid; i < ML_CLUSTER * ML_M; i += ML_CONSUMERS) {
    c_m[i] = ld_cluster(cluster_addr(s_m + i % ML_M, i / ML_M));
    c_l[i] = ld_cluster(cluster_addr(s_l + i % ML_M, i / ML_M));
  }
  float4 v[ML_CLUSTER][RPW];
#pragma unroll
  for (int r = 0; r < ML_CLUSTER; ++r) {
    const uint32_t a = cluster_addr(s_o + warp * ML_OP + c0, r);
#pragma unroll
    for (int i = 0; i < RPW; ++i)
      v[r][i] = ld_cluster4(a + i * (ML_CONSUMERS / 32) * ML_OP * 4);
  }
  named_sync(1, ML_CONSUMERS);                     // c_m, c_l
  float mg[RPW], lv[RPW];
  float4 acc[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int row = warp + i * (ML_CONSUMERS / 32);
    mg[i] = NEG;
#pragma unroll
    for (int r = 0; r < ML_CLUSTER; ++r)
      mg[i] = fmaxf(mg[i], c_m[r * ML_M + row]);  // the cluster's first
    lv[i] = 0.f;                                  // split is live
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < ML_CLUSTER; ++r) {
      const float c = exp2f(c_m[r * ML_M + row] - mg[i]);
      lv[i] += c_l[r * ML_M + row] * c;
      acc[i].x += v[r][i].x * c;
      acc[i].y += v[r][i].y * c;
      acc[i].z += v[r][i].z * c;
      acc[i].w += v[r][i].w * c;
    }
  }
  const int n_cl = (n_live + ML_CLUSTER - 1) / ML_CLUSTER;
  const bool ml_writer = rank == 0 && lane == 0;
  if (n_cl == 1) {                     // the slot's only cluster
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int hh = h0 + warp + i * (ML_CONSUMERS / 32);
      if (hh >= H) continue;
      *reinterpret_cast<float4*>(o + ((size_t)b * H + hh) * ML_LORA + c0) =
          acc[i];
      if (ml_writer) {
        m_out[(size_t)b * H + hh] = mg[i] * LN2;
        l_out[(size_t)b * H + hh] = lv[i];
      }
    }
    cluster_sync_all();                // no block leaves while read
    return;
  }
  const size_t slot = ((size_t)cl * B + b) * H;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int hh = h0 + warp + i * (ML_CONSUMERS / 32);
    if (hh >= H) continue;
    __stcg(reinterpret_cast<float4*>(ws_o + (slot + hh) * ML_LORA + c0),
           acc[i]);
    if (ml_writer) {
      __stcg(ws_m + slot + hh, mg[i]);
      __stcg(ws_l + slot + hh, lv[i]);
    }
  }
  __threadfence();                     // the cluster's slices and m, l
  cluster_sync_all();                  // ... before any of its counts
  if (tid == 0)
    last = atomicInc(cnt + ((size_t)b * gridDim.x + hg) * ML_CLUSTER + rank,
                     n_cl - 1) == (unsigned)(n_cl - 1);
  named_sync(1, ML_CONSUMERS);
  if (!last) return;
  __threadfence();
  // the clusters' slices in cluster order: all rows' m first, then each
  // cluster's rows together, so a thread keeps RPW loads in flight (rows
  // past H read row H - 1 and are not stored)
  float m2[RPW], l2[RPW];
  float4 a2[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m2[i] = NEG;
    l2[i] = 0.f;
    a2[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int ci = 0; ci < n_cl; ++ci) {
    const size_t r0 = ((size_t)ci * B + b) * H;
#pragma unroll
    for (int i = 0; i < RPW; ++i)
      m2[i] = fmaxf(m2[i], __ldcg(ws_m + r0 + min(h0 + warp + i * (
                                   ML_CONSUMERS / 32), H - 1)));
  }
  for (int ci = 0; ci < n_cl; ++ci) {
    const size_t r0 = ((size_t)ci * B + b) * H;
    float4 w[RPW];
    float mc[RPW], lc[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const size_t r =
          r0 + min(h0 + warp + i * (ML_CONSUMERS / 32), H - 1);
      w[i] = __ldcg(reinterpret_cast<const float4*>(ws_o + r * ML_LORA +
                                                    c0));
      mc[i] = __ldcg(ws_m + r);
      lc[i] = __ldcg(ws_l + r);
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const float c = exp2f(mc[i] - m2[i]);
      l2[i] += lc[i] * c;
      a2[i].x += w[i].x * c;
      a2[i].y += w[i].y * c;
      a2[i].z += w[i].z * c;
      a2[i].w += w[i].w * c;
    }
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int hh = h0 + warp + i * (ML_CONSUMERS / 32);
    if (hh >= H) continue;
    *reinterpret_cast<float4*>(o + ((size_t)b * H + hh) * ML_LORA + c0) =
        a2[i];
    if (ml_writer) {
      m_out[(size_t)b * H + hh] = m2[i] * LN2;
      l_out[(size_t)b * H + hh] = l2[i];
    }
  }
}

template <int R>
cudaError_t launch_mla_wgmma(int device, const void* q, const void* pool,
                             const int* table, const int* pos, float* o,
                             float* m, float* l, float* ws_o, float* ws_m,
                             float* ws_l, unsigned* cnt, int B, int H,
                             int n_pages, int ps, int width, int page_size,
                             int base, float scale, int splits, int chunk,
                             cudaStream_t stream) {
  CUtensorMap tq, tp;
  const long long dq[3] = {R, H, B}, sq[2] = {R, (long long)H * R};
  const long long dp[3] = {R, ps, n_pages}, sp[2] = {R, (long long)ps * R};
  const int box_q[3] = {64, ML_M, 1}, box_p[3] = {64, ps, 1};
  cudaError_t err = make_map(&tq, q, 3, dq, sq, box_q);
  if (err == cudaSuccess) err = make_map(&tp, pool, 3, dp, sp, box_p);
  if (err != cudaSuccess) return err;
  constexpr int smem = MlaSmem<R>::bytes;
  static bool done[64] = {};
  err = allow_smem(paged_mla_wgmma<R>, device, smem, done);
  if (err != cudaSuccess) return err;
  const int zs = (splits + ML_CLUSTER - 1) / ML_CLUSTER * ML_CLUSTER;
  dim3 grid((H + ML_M - 1) / ML_M, B, zs);
  paged_mla_wgmma<R><<<grid, ML_THREADS, smem, stream>>>(
      tq, tp, table, pos, o, m, l, ws_o, ws_m, ws_l, cnt, H, n_pages, ps,
      width, page_size, base, scale, chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q and both pools); route: 0 = the CUDA
// cores (paged_gqa_kernel, any dtype, dh a multiple of 8 up to 256), 1 =
// the tensor cores (paged_gqa_mma: bf16, G <= 8, dh 64, 128 or 256). Route 1
// cuts each slot's keys into `splits` chunks of `chunk` keys (splits *
// chunk >= width * ps); with splits > 1, ws_o (splits, B, Hkv, G, dh),
// ws_m and ws_l (splits, B, Hkv, G) are f32 scratch and cnt holds B * Hkv
// unsigned counters that are 0 between calls. The pools must be 16-byte
// aligned. Returns the CUDA error of the launch (0 = success).
int paged_attention_gqa(int device, int dtype, const void* q, const void* pk,
                        const void* pv, const void* table, const void* pos,
                        void* o, void* m, void* l, void* ws_o, void* ws_m,
                        void* ws_l, void* cnt, int B, int hkv, int G, int dh,
                        int n_pages, int ps, int width, int page_size,
                        int base, float scale, float softcap, int splits,
                        int chunk, int route, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (dh < 8 || dh % 8 || B < 1 || hkv < 1 || width < 1 || ps < 1 ||
      ps > page_size || (uintptr_t)pk % 16 || (uintptr_t)pv % 16)
    return (int)cudaErrorInvalidValue;
  const int* tb = static_cast<const int*>(table);
  const int* pp = static_cast<const int*>(pos);
  float* of = static_cast<float*>(o);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (dtype != 1 || G < 1 || G > GQ_N || splits < 1 || splits > 65535 ||
        B > 65535 || chunk < 1 || (long long)splits * chunk < width * ps ||
        (splits > 1 && (ws_o == nullptr || ws_m == nullptr ||
                        ws_l == nullptr || cnt == nullptr)))
      return (int)cudaErrorInvalidValue;
    return (int)dispatch_gqa_mma(
        device, dh, softcap, q, pk, pv, tb, pp, of, mf, lf,
        static_cast<float*>(ws_o), static_cast<float*>(ws_m),
        static_cast<float*>(ws_l), static_cast<unsigned*>(cnt), B, hkv, G,
        n_pages, ps, width, page_size, base, scale, splits, chunk, st);
  }
  if (route != 0 || dh > MAXD) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    err = dispatch<float>(device, G, q, pk, pv, tb, pp, of, mf, lf, B, hkv,
                          dh, n_pages, ps, width, page_size, base, scale,
                          softcap, st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(device, G, q, pk, pv, tb, pp, of, mf, lf,
                                  B, hkv, dh, n_pages, ps, width, page_size,
                                  base, scale, softcap, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

// dtype: 0 = float32, 1 = bfloat16 (q and the pool); route: 0 = the CUDA
// cores (paged_mla_kernel, R a multiple of 8 up to 1024, kv_lora at most
// 512 and R; with splits > 1 mla_combine merges the partials), 1 = the
// tensor cores (paged_mla_wgmma: bf16, kv_lora 512, R 512 or 576, ps 8,
// 16, 32 or 64, chunk a multiple of 64, q and the pool 16-byte aligned; one
// launch). The keys of a slot are cut into
// `splits` chunks of `chunk` keys (splits * chunk >= width * ps); with
// splits > 1, o_part (splits, B, H, kv_lora), m_part and l_part (splits, B,
// H) are f32 scratch (route 1 uses ceil(splits / 4) of the splits' rows),
// and route 1 takes cnt, B * ceil(H / 64) * 4 unsigned counters that are 0
// between calls. Returns the CUDA error of the
// launches (0 = success).
int paged_attention_mla(int device, int dtype, const void* q,
                        const void* pool, const void* table, const void* pos,
                        void* o, void* m, void* l, void* o_part, void* m_part,
                        void* l_part, void* cnt, int B, int H, int R,
                        int kv_lora, int n_pages, int ps, int width,
                        int page_size, int base, float scale, int splits,
                        int chunk, int route, void* stream) {
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
  if (route == 1) {
    if (dtype != 1 || kv_lora != ML_LORA || (uintptr_t)q % 16 ||
        splits > 65535 - ML_CLUSTER || ps % 8 || ML_KT % ps ||
        chunk % ML_KT ||
        (splits > 1 && (op == nullptr || mp == nullptr || lp == nullptr ||
                        cnt == nullptr)))
      return (int)cudaErrorInvalidValue;
    unsigned* cf = static_cast<unsigned*>(cnt);
    if (R == 512)
      return (int)launch_mla_wgmma<512>(device, q, pool, tb, pp, of, mf, lf,
                                        op, mp, lp, cf, B, H, n_pages, ps,
                                        width, page_size, base, scale,
                                        splits, chunk, st);
    if (R == 576)
      return (int)launch_mla_wgmma<576>(device, q, pool, tb, pp, of, mf, lf,
                                        op, mp, lp, cf, B, H, n_pages, ps,
                                        width, page_size, base, scale,
                                        splits, chunk, st);
    return (int)cudaErrorInvalidValue;
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
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

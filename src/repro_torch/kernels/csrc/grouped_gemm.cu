// Grouped (per-expert) GEMM on Hopper (sm_90a): out[e] = a[e] @ w[e].
//
// Replaces the TPU kernel repro/kernels/grouped_gemm/grouped_gemm.py::
// grouped_gemm (_kernel). Same contract: a (E, M, K) @ w (E, K, N) ->
// (E, M, N) in a's dtype with an f32 accumulator. Differences the card asks
// for: any M, N and K tile edge is handled here (the TPU kernel needs M, N,
// K to divide its blocks), and a is addressed through its expert and row
// strides, so decode passes its tokens broadcast over the experts with
// stride 0 and no copy.
//
// What bounds it. Prefill (M = expert capacity, 384 at 8 rows x 1024
// tokens of deepseek-v2): operations and bytes alike, 2 E M K N against
// w's E K N bf16 (0.98 ms and 1.00 ms for one (160, 384, 5120) x (160,
// 5120, 1536) product at 989 TFLOP/s and 3.35 TB/s). Decode (M = 8 tokens,
// every expert): the bytes of w, 7.55 GB per layer, 2.25 ms.
//
// Three paths, one contract, chosen by grouped_gemm/ops.py::route.
//
// gg_prefill (bf16, M > 16): Hopper's warpgroup products fed by TMA.
// Persistent: one block of 288 threads per SM walks the (128-row,
// 256-column, expert) output tiles: two consumer warpgroups of 64 rows and
// one producer warp. One lane of the producer keeps a ring of PSTAGES = 4
// K-steps of 64 in flight, across tiles: a's tile through a 3-D tensor map
// over (K, M, E) with a's own row and expert strides (a broadcast a,
// expert stride 0, is mapped once and read at expert 0), w's tile through a
// map over (N, K, E). Each consumer runs wgmma m64n256k16 with a K-major
// from shared memory and w, row-major (K, N), as the transposed (MN-major)
// B: no copy. One group of products stays in flight while the next stage's
// barrier is awaited. The epilogue writes bf16 pairs from the accumulators
// with the ragged M and N edges masked (K's edge is zero-filled by TMA)
// while the producer already loads the next tile. The row tiles of one
// expert's column tile are neighbours in the walk, so w's tile is read
// from device memory once and from L2 by the others. Shared memory
// 197,696 bytes: one block per SM. Where it stands (PERF.md §6, on an H100
// at 700 W): 1.4-1.6x its bound at deepseek-v2's prefill shapes, 1.0-1.2x
// torch.bmm. What is left: no cluster multicasts w, and the output leaves
// by 4-byte stores, not TMA.
//
// gg_decode (bf16, M <= 16): the bytes of w are the cost, so the design is
// a deep ring of w: one block of 288 threads per (128 columns, expert), a
// ring of DSTAGES = 4 stages of a 64 x 128 w tile (16 KB) and the 16 x 64
// tile of a (a 2-D map with zero rows past M when a is a broadcast), three
// blocks per SM: up to 192 KB of w in flight on each SM. The product runs
// transposed, out^T = w^T a^T, so the 64 columns of each consumer
// warpgroup are wgmma's M and the tokens its N = 16: w's tile as the
// MN-major A from shared memory and a's as the K-major B, wgmma m64n16k16.
// Chosen over mma.sync on 16-row tiles because it takes w straight from
// TMA's swizzled tile with no fragment loads and shares the prefill's
// producer and descriptors; its products cost nothing beside the bytes. It
// moves w at 3.0-3.1 TB/s, 91-93 % of the HBM bound, level with torch.bmm.
//
// gg_f32 (f32): CUDA cores, a 64 x 64 tile per block of 256 threads, each
// thread a 4 x 4 piece, K in steps of 16 through shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int GK = 64;          // K step of both bf16 paths
constexpr int GTHREADS = 288;   // two consumer warpgroups + a producer warp
constexpr int GCONSUMERS = 256;
constexpr int PM = 128, PN = 256, PSTAGES = 4;    // prefill tile and ring
constexpr int DM = 16, DN = 128, DSTAGES = 4;     // decode tile and ring

// Shared memory of one block (grouped_gemm/ops.py::smem_bytes): the ring of
// a and w tiles, full and empty barriers per stage, the 1024-byte alignment.
template <int BM, int BN, int STAGES>
struct GgSmem {
  static constexpr int a = BM * GK * 2;
  static constexpr int w = GK * BN * 2;
  static constexpr int stage = a + w;
  static constexpr int bytes = SMEM_ALIGN + STAGES * stage + 16 * STAGES;
};
using PrefillSmem = GgSmem<PM, PN, PSTAGES>;
using DecodeSmem = GgSmem<DM, DN, DSTAGES>;
static_assert(PrefillSmem::bytes == 197696, "smem_bytes(\"prefill\")");
static_assert(DecodeSmem::bytes == 74816, "smem_bytes(\"decode\")");

// The producer's loop over one output tile, shared by both paths: ring
// position `it` (counted across the block's tiles) holds a's tile (BM x GK
// at (k, m0, ea)) and w's tile (GK x BN at (n0, k, e), BN / 64 boxes).
// Returns the ring position after the tile.
template <int BM, int BN, int STAGES>
__device__ __forceinline__ int produce(const CUtensorMap* ta,
                                       const CUtensorMap* tw, uint8_t* ring,
                                       uint64_t* full, uint64_t* empty,
                                       int it, int nk, int m0, int n0, int e,
                                       int ea) {
  using SM = GgSmem<BM, BN, STAGES>;
  for (int t = 0; t < nk; ++t, ++it) {
    const int s = it % STAGES;
    if (it >= STAGES) mbar_wait(&empty[s], (it / STAGES - 1) & 1);
    uint8_t* st = ring + s * SM::stage;
    mbar_expect_tx(&full[s], SM::stage);
    tma_load(st, ta, &full[s], t * GK, m0, ea);
#pragma unroll
    for (int c = 0; c < BN / 64; ++c)
      tma_load(st + SM::a + c * GK * 128, tw, &full[s], n0 + 64 * c, t * GK,
               e);
  }
  return it;
}

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty,
                                          int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], GCONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// Persistent: one block per SM walks the output tiles w = blockIdx.x,
// blockIdx.x + gridDim.x, ... (row tiles fastest, then column tiles, then
// experts, so the row tiles that share a w tile run together); the
// producer fills the ring with the next tile's steps while the consumers
// write the current one.
__global__ void __launch_bounds__(GTHREADS, 1)
gg_prefill(const __grid_constant__ CUtensorMap ta,
           const __grid_constant__ CUtensorMap tw,
           __nv_bfloat16* __restrict__ out, int E, int M, int K, int N,
           int a_bcast) {
  using SM = PrefillSmem;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = smem_base(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + PSTAGES * SM::stage);
  uint64_t* empty = full + PSTAGES;
  const int nm = (M + PM - 1) / PM, nn = (N + PN - 1) / PN;
  const int n_tiles = nm * nn * E, nk = (K + GK - 1) / GK;
  init_ring(full, empty, PSTAGES);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid >= GCONSUMERS) {
    if (lane == 0) {
      int it = 0;
      for (int w = blockIdx.x; w < n_tiles; w += gridDim.x) {
        const int e = w / (nm * nn);
        it = produce<PM, PN, PSTAGES>(&ta, &tw, ring, full, empty, it, nk,
                                      (w % nm) * PM, (w / nm % nn) * PN, e,
                                      a_bcast ? 0 : e);
      }
    }
    return;
  }
  const int wg = warp >> 2, wl = warp & 3, gq = lane >> 2, tg = lane & 3;
  float acc[PN / 2];
  int it = 0;
  for (int w = blockIdx.x; w < n_tiles; w += gridDim.x) {
    const int m0 = (w % nm) * PM, n0 = (w / nm % nn) * PN, e = w / (nm * nn);
#pragma unroll
    for (int i = 0; i < PN / 2; ++i) acc[i] = 0.f;
    for (int t = 0; t < nk; ++t, ++it) {
      const int s = it % PSTAGES;
      const __nv_bfloat16* As =
          reinterpret_cast<const __nv_bfloat16*>(ring + s * SM::stage);
      const __nv_bfloat16* Ws = As + SM::a / 2;
      mbar_wait(&full[s], (it / PSTAGES) & 1);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < GK / 16; ++kk)
        WgmmaSS<PN>::run<0, 1>(
            acc, sw128_desc(As + 64 * wg * 64 + 16 * kk, 16, 1024),
            sw128_desc(Ws + 16 * kk * 64, GK * 128, 1024), 1);
      wg_commit();
      wg_wait<1>();               // the previous step's products are done
      if (t > 0) mbar_arrive(&empty[(it - 1) % PSTAGES]);
    }
    wg_wait<0>();
    reg_fence<PN / 2>(acc);
    mbar_arrive(&empty[(it - 1) % PSTAGES]);

    __nv_bfloat16* ob = out + (long long)e * M * N;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = m0 + 64 * wg + 16 * wl + gq + 8 * rr;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < PN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * tg;           // N % 8 == 0
        if (col < N)
          *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row * N + col) =
              __floats2bfloat162_rn(acc[4 * j + 2 * rr],
                                    acc[4 * j + 2 * rr + 1]);
      }
    }
  }
}

__global__ void __launch_bounds__(GTHREADS, 3)
gg_decode(const __grid_constant__ CUtensorMap ta,
          const __grid_constant__ CUtensorMap tw,
          __nv_bfloat16* __restrict__ out, int E, int M, int K, int N,
          int a_bcast) {
  using SM = DecodeSmem;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = smem_base(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + DSTAGES * SM::stage);
  uint64_t* empty = full + DSTAGES;
  const int n0 = blockIdx.x * DN, e = blockIdx.y;
  const int nk = (K + GK - 1) / GK;
  init_ring(full, empty, DSTAGES);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid >= GCONSUMERS) {
    if (lane == 0)
      produce<DM, DN, DSTAGES>(&ta, &tw, ring, full, empty, 0, nk, 0, n0, e,
                               a_bcast ? 0 : e);
    return;
  }
  const int wg = warp >> 2, wl = warp & 3, gq = lane >> 2, tg = lane & 3;
  float acc[DM / 2] = {};
  for (int t = 0; t < nk; ++t) {
    const int s = t % DSTAGES;
    const __nv_bfloat16* As =
        reinterpret_cast<const __nv_bfloat16*>(ring + s * SM::stage);
    const __nv_bfloat16* Ws = As + SM::a / 2 + wg * GK * 64;   // 64 columns
    mbar_wait(&full[s], (t / DSTAGES) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < GK / 16; ++kk)   // out^T (64 x 16) += w^T a^T
      WgmmaSS<DM>::run<1, 0>(acc, sw128_desc(Ws + 16 * kk * 64, 16, 1024),
                             sw128_desc(As + 16 * kk, 16, 1024), 1);
    wg_commit();
    wg_wait<1>();
    if (t > 0) mbar_arrive(&empty[(t - 1) % DSTAGES]);
  }
  wg_wait<0>();
  reg_fence<DM / 2>(acc);

  // acc[4 j + i]: column n of w's row 16 wl + gq + 8 (i / 2), token
  // 8 j + 2 tg + i % 2
  __nv_bfloat16* ob = out + (long long)e * M * N;
#pragma unroll
  for (int i = 0; i < DM / 2; ++i) {
    const int n = n0 + 64 * wg + 16 * wl + gq + 8 * ((i >> 1) & 1);
    const int m = 8 * (i >> 2) + 2 * tg + (i & 1);
    if (n < N && m < M)
      ob[(long long)m * N + n] = __float2bfloat16(acc[i]);
  }
}

constexpr int FT = 64;       // f32 tile (rows and columns)
constexpr int FK = 16;       // f32 K step
constexpr int FTHREADS = 256;

__global__ void __launch_bounds__(FTHREADS)
gg_f32(const float* __restrict__ a, const float* __restrict__ w,
       float* __restrict__ out, long long sae, long long sam, int M, int K,
       int N) {
  __shared__ float As[FK][FT + 4];   // transposed: [k][m]
  __shared__ float Ws[FK][FT + 4];   // [k][n]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int e = blockIdx.z, m0 = blockIdx.y * FT, n0 = blockIdx.x * FT;
  const float* ab = a + (long long)e * sae;
  const float* wb = w + (long long)e * K * N;
  float* ob = out + (long long)e * M * N;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FK) {
    for (int idx = tid; idx < FT * FK; idx += FTHREADS) {
      const int r = idx / FK, c = idx % FK;
      const int row = m0 + r, k = k0 + c;
      As[c][r] = row < M && k < K ? ab[row * sam + k] : 0.f;
    }
    for (int idx = tid; idx < FK * FT; idx += FTHREADS) {
      const int r = idx / FT, c = idx % FT;
      const int k = k0 + r, n = n0 + c;
      Ws[r][c] = k < K && n < N ? wb[(long long)k * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      float av[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = Ws[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * wv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < N) ob[(long long)row * N + col] = acc[i][j];
    }
  }
}

// a's map covers (K, M, E), or (K, M) at expert 0 when a is a broadcast
// (TMA cannot step by 0); w's covers (N, K, E).
template <bool DECODE>
cudaError_t launch_bf16(int device, const void* a, const void* w, void* out,
                        long long sae, long long sam, int E, int M, int K,
                        int N, cudaStream_t stream) {
  constexpr int BM = DECODE ? DM : PM;
  using SM = GgSmem<BM, DECODE ? DN : PN, DECODE ? DSTAGES : PSTAGES>;
  const int a_bcast = sae == 0 || E == 1;
  CUtensorMap ta, tw;
  const long long da[3] = {K, M, a_bcast ? 1 : E}, sa[2] = {sam, sae};
  const long long dw[3] = {N, K, E}, sw[2] = {N, (long long)K * N};
  const int box_a[3] = {GK, BM, 1}, box_w[3] = {64, GK, 1};
  cudaError_t err = make_map(&ta, a, 3, da, sa, box_a);
  if (err == cudaSuccess) err = make_map(&tw, w, 3, dw, sw, box_w);
  if (err != cudaSuccess) return err;
  auto kernel = DECODE ? gg_decode : gg_prefill;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SM::bytes);
  if (err != cudaSuccess) return err;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (DECODE) {
    gg_decode<<<dim3((N + DN - 1) / DN, E), GTHREADS, SM::bytes, stream>>>(
        ta, tw, o, E, M, K, N, a_bcast);
  } else {
    const long long tiles = (long long)((M + PM - 1) / PM) *
                            ((N + PN - 1) / PN) * E;
    if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
    gg_prefill<<<(int)std::min<long long>(tiles, sm_count(device)), GTHREADS,
                 SM::bytes, stream>>>(ta, tw, o, E, M, K, N, a_bcast);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (a, w and out). route (the pure
// function grouped_gemm/ops.py::route): 0 = f32 on CUDA cores; 1 = bf16
// prefill (any M); 2 = bf16 decode (M <= 16). a is addressed as
// a + e * sae + m * sam + k (elements; sae may be 0), w and out are
// contiguous. bf16 needs K > 0, K and N multiples of 8 and 16-byte aligned
// rows. Returns the CUDA error of the launch (0 = success).
int grouped_gemm(int device, int dtype, int route, const void* a,
                 const void* w, void* out, long long sae, long long sam,
                 int E, int M, int K, int N, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E < 1 || M < 1 || K < 0 || N < 1 || E > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 0 && dtype == 0) {
    dim3 grid((N + FT - 1) / FT, (M + FT - 1) / FT, E);
    gg_f32<<<grid, FTHREADS, 0, st>>>(static_cast<const float*>(a),
                                      static_cast<const float*>(w),
                                      static_cast<float*>(out), sae, sam, M,
                                      K, N);
    err = cudaGetLastError();
  } else if ((route == 1 || (route == 2 && M <= DM)) && dtype == 1) {
    if (K < 1 || K % 8 || N % 8 || (uintptr_t)a % 16 || (uintptr_t)w % 16 ||
        (E > 1 && sae % 8) || (M > 1 && sam % 8))
      return (int)cudaErrorInvalidValue;
    err = (route == 2 ? launch_bf16<true> : launch_bf16<false>)(
        device, a, w, out, sae, sam, E, M, K, N, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

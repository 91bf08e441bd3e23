// Grouped (per-expert) GEMM on Hopper (sm_90a): out[e] = a[e] @ w[e].
//
// Replaces the TPU kernel repro/kernels/grouped_gemm/grouped_gemm.py::
// grouped_gemm (_kernel). Same contract: a (E, M, K) @ w (E, K, N) ->
// (E, M, N) in a's dtype with an f32 accumulator. Differences the card asks
// for: any M, N and K tile edge is masked here (the TPU kernel needs M, N,
// K to divide its blocks), and a is addressed through its expert and row
// strides, so decode passes its tokens broadcast over the experts with
// stride 0 and no copy.
//
// What bounds it. Prefill (M = expert capacity, 384 at 8 rows x 1024
// tokens of deepseek-v2): the operations, 2 * E * M * K * N; one MoE layer's
// three products are 2.9 TFLOP, 2.9 ms at the 989 TFLOP/s bf16 rate.
// Decode (M = 8 tokens, every expert): the bytes of w, 7.55 GB per layer,
// 2.25 ms at 3.35 TB/s.
//
// Two paths, one contract.
//
// gg_mma (bf16, the main path): the tensor cores through mma.sync
// m16n8k16 (bf16 in, f32 accumulate), the fragment layout of
// flash_attention.cu. One block of 4 warps per (BN-column tile, BM-row
// tile, expert); each warp owns a (16 MT) x (8 NT) piece of the block's
// output in registers. K advances in steps of 32: the next step's tiles of
// a and w are loaded from device memory into registers (16-byte loads,
// neighbouring threads on neighbouring addresses) while the tensor cores
// work on the current step's tiles in shared memory. a's tile is stored
// row-major and read as 32-bit A fragments; w's tile is stored as it lies
// in memory (K x N) and its B fragments are gathered from 16-bit loads.
// Rows are padded so the fragment loads of a warp hit distinct banks. Two
// shapes: 64 x 128 (2 x 2 warps of 32 x 64) for prefill, 16 x 128 (1 x 4
// warps of 16 x 32) when M <= 16, so decode issues no products for rows
// that do not exist. Not yet used: wgmma, TMA, a deeper ring of tiles.
//
// gg_f32 (f32): CUDA cores, a 64 x 64 tile per block of 256 threads, each
// thread a 4 x 4 piece, K in steps of 16 through shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int BK = 32;   // K step of the bf16 path

template <int WM, int WN, int MT, int NT>
__global__ void __launch_bounds__(WM * WN * 32)
gg_mma(const __nv_bfloat16* __restrict__ a,
       const __nv_bfloat16* __restrict__ w, __nv_bfloat16* __restrict__ out,
       long long sae, long long sam, int M, int K, int N) {
  constexpr int BM = WM * 16 * MT, BN = WN * 8 * NT;
  constexpr int THREADS = WM * WN * 32;
  constexpr int AP = BK + 8;      // padded a row (bf16)
  constexpr int WP = BN + 8;      // padded w row (bf16)
  constexpr int AV = BM * BK / 8, WV = BK * BN / 8;    // 16-byte vectors
  constexpr int AVT = (AV + THREADS - 1) / THREADS;
  constexpr int WVT = (WV + THREADS - 1) / THREADS;
  __shared__ __align__(16) __nv_bfloat16 As[BM][AP];
  __shared__ __align__(16) __nv_bfloat16 Ws[BK][WP];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tg = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int e = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const __nv_bfloat16* ab = a + (long long)e * sae;
  const __nv_bfloat16* wb = w + (long long)e * K * N;
  __nv_bfloat16* ob = out + (long long)e * M * N;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  uint4 ra[AVT], rw[WVT];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < AVT; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / (BK / 8), c = (idx % (BK / 8)) * 8;
      const int row = m0 + r, k = k0 + c;
      ra[i] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < AV && row < M && k < K)
        ra[i] = *reinterpret_cast<const uint4*>(ab + row * sam + k);
    }
#pragma unroll
    for (int i = 0; i < WVT; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / (BN / 8), c = (idx % (BN / 8)) * 8;
      const int k = k0 + r, n = n0 + c;
      rw[i] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < WV && k < K && n < N)
        rw[i] = *reinterpret_cast<const uint4*>(wb + (long long)k * N + n);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < AVT; ++i) {
      const int idx = tid + i * THREADS;
      if (idx < AV)
        *reinterpret_cast<uint4*>(
            &As[idx / (BK / 8)][(idx % (BK / 8)) * 8]) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < WVT; ++i) {
      const int idx = tid + i * THREADS;
      if (idx < WV)
        *reinterpret_cast<uint4*>(
            &Ws[idx / (BN / 8)][(idx % (BN / 8)) * 8]) = rw[i];
    }
  };

  load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();                 // the previous step's tiles are consumed
    store();
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);  // in flight while the tensor cores run
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = wm * 16 * MT + mt * 16 + gq, c = kk * 16 + tg * 2;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(&As[r][c]);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][c]);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(&As[r][c + 8]);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][c + 8]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = wn * 8 * NT + nt * 8 + gq, k = kk * 16 + tg * 2;
        const uint32_t b0 = pack2(Ws[k][n], Ws[k + 1][n]);
        const uint32_t b1 = pack2(Ws[k + 8][n], Ws[k + 9][n]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt], af[mt], b0, b1);
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = m0 + wm * 16 * MT + mt * 16 + gq + 8 * rr;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = n0 + wn * 8 * NT + nt * 8 + tg * 2;   // N % 8 == 0
        if (col < N)
          *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row * N + col) =
              __floats2bfloat162_rn(acc[mt][nt][2 * rr],
                                    acc[mt][nt][2 * rr + 1]);
      }
    }
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

template <int WM, int WN, int MT, int NT>
cudaError_t launch_mma(const void* a, const void* w, void* out,
                       long long sae, long long sam, int E, int M, int K,
                       int N, cudaStream_t stream) {
  constexpr int BM = WM * 16 * MT, BN = WN * 8 * NT;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, E);
  gg_mma<WM, WN, MT, NT><<<grid, WM * WN * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out),
      sae, sam, M, K, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (a, w and out). a is addressed as
// a + e * sae + m * sam + k (elements; sae may be 0), w and out are
// contiguous. bf16 needs K and N multiples of 8 and 16-byte aligned rows.
// Returns the CUDA error of the launch (0 = success).
int grouped_gemm(int device, int dtype, const void* a, const void* w,
                 void* out, long long sae, long long sam, int E, int M,
                 int K, int N, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E < 1 || M < 1 || K < 0 || N < 1 || E > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dim3 grid((N + FT - 1) / FT, (M + FT - 1) / FT, E);
    gg_f32<<<grid, FTHREADS, 0, st>>>(static_cast<const float*>(a),
                                      static_cast<const float*>(w),
                                      static_cast<float*>(out), sae, sam, M,
                                      K, N);
    err = cudaGetLastError();
  } else if (dtype == 1) {
    if (K % 8 || N % 8 || (uintptr_t)a % 16 || (uintptr_t)w % 16 ||
        (E > 1 && sae % 8) || (M > 1 && sam % 8))
      return (int)cudaErrorInvalidValue;
    err = M <= 16 ? launch_mma<1, 4, 1, 4>(a, w, out, sae, sam, E, M, K, N, st)
                  : launch_mma<2, 2, 2, 8>(a, w, out, sae, sam, E, M, K, N, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

// Tiled GEMM on Hopper (sm_90a): C = A @ B, the paper's §4 benchmark.
//
// Replaces the TPU kernel repro/kernels/gemm/gemm.py::gemm (_gemm_kernel).
// Same contract: A (M, K) @ B (K, N) -> C (M, N) in A's dtype, f32 sums,
// a (M / bm, N / bn) grid of output tiles with K walked in steps of bk. The
// block shape is a real launch shape: every (bm, bn, bk) of GEMM_SHAPES below
// is its own template instance, so the paper's "buffered columns" knob (bn)
// measures what it names. What the card asks for besides:
// - the TPU kernel holds its (bm, bn) f32 accumulator in VMEM; here it
//   lives in registers, and only the A and B tiles sit in shared memory, so
//   the capacity law is smem_bytes() (kernels/gemm/ops.py) against the
//   227 KiB a block may opt into, and a shape over it is refused;
// - HBB hands the accelerator chunks of any row count: rows are masked at
//   the ragged edge of M (the TPU kernel needs M % bm == 0), and A is read
//   through its row stride, so a chunk is the view A[b:e] of a card-resident
//   A, not a copy.
//
// What bounds it. bf16: operations, 2 M N K at 989 TFLOP/s (4096^3: 0.139
// ms). f32 on CUDA cores (no TF32: the contract holds f32 to 1e-4):
// operations at 67 TFLOP/s (4096^3: 2.05 ms; 1024^3: 32 us).
//
// Two paths, one contract, 256 threads (8 warps) per block.
//
// gemm_mma (bf16): the tensor cores through mma.sync m16n8k16 (mma.cuh), the
// design of grouped_gemm.cu's gg_mma: warps 2 x 4, each a (16 MT) x (8 NT)
// piece of the tile in registers; the next K step's tiles are loaded from
// device memory into registers (16-byte loads) while the tensor cores work
// on the current step's tiles in shared memory. Needs K and N multiples of
// 8 and 16-byte aligned rows.
//
// gemm_f32 (f32): FFMA on CUDA cores, threads 16 x 16, each a (bm / 16) x
// (bn / 16) piece of the tile; A's tile is stored K-major so both operands
// are read as rows of shared memory. Any M, N, K.
//
// Not yet used: wgmma, TMA, a ring of tiles in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int SMEM_LIMIT = 232448;   // 227 KiB: the most one block may use

// Shared memory of one block (the capacity law, ops.py::smem_bytes): bf16
// tiles row-major with 8 elements of padding per row (A: bm x bk, B: bk x
// bn); f32 tiles K-major with 4 (A^T: bk x bm, B: bk x bn).
constexpr int smem_bf16(int bm, int bn, int bk) {
  return (bm * (bk + 8) + bk * (bn + 8)) * 2;
}
constexpr int smem_f32(int bm, int bn, int bk) {
  return (bk * (bm + 4) + bk * (bn + 4)) * 4;
}

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(THREADS)
gemm_mma(const __nv_bfloat16* __restrict__ a,
         const __nv_bfloat16* __restrict__ b, __nv_bfloat16* __restrict__ c,
         long long lda, int M, int K, int N) {
  constexpr int WN = 4;                         // warps 2 x WN
  constexpr int MT = BM / 32, NT = BN / 32;     // mma tiles per warp
  constexpr int AP = BK + 8, BP = BN + 8;       // padded rows (bf16)
  constexpr int AV = BM * BK / 8, BV = BK * BN / 8;   // 16-byte vectors
  constexpr int AVT = (AV + THREADS - 1) / THREADS;
  constexpr int BVT = (BV + THREADS - 1) / THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);   // [BM][AP]
  __nv_bfloat16* Bs = As + BM * AP;                              // [BK][BP]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tg = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  uint4 ra[AVT], rb[BVT];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < AVT; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / (BK / 8), cc = (idx % (BK / 8)) * 8;
      const int row = m0 + r, k = k0 + cc;
      ra[i] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < AV && row < M && k < K)
        ra[i] = *reinterpret_cast<const uint4*>(a + row * lda + k);
    }
#pragma unroll
    for (int i = 0; i < BVT; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / (BN / 8), cc = (idx % (BN / 8)) * 8;
      const int k = k0 + r, n = n0 + cc;
      rb[i] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < BV && k < K && n < N)
        rb[i] = *reinterpret_cast<const uint4*>(b + (long long)k * N + n);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < AVT; ++i) {
      const int idx = tid + i * THREADS;
      if (idx < AV)
        *reinterpret_cast<uint4*>(
            As + (idx / (BK / 8)) * AP + (idx % (BK / 8)) * 8) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < BVT; ++i) {
      const int idx = tid + i * THREADS;
      if (idx < BV)
        *reinterpret_cast<uint4*>(
            Bs + (idx / (BN / 8)) * BP + (idx % (BN / 8)) * 8) = rb[i];
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
        const int r = wm * 16 * MT + mt * 16 + gq, cc = kk * 16 + tg * 2;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(As + r * AP + cc);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(As + (r + 8) * AP + cc);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(As + r * AP + cc + 8);
        af[mt][3] =
            *reinterpret_cast<const uint32_t*>(As + (r + 8) * AP + cc + 8);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = wn * 8 * NT + nt * 8 + gq, k = kk * 16 + tg * 2;
        const uint32_t b0 = pack2(Bs[k * BP + n], Bs[(k + 1) * BP + n]);
        const uint32_t b1 = pack2(Bs[(k + 8) * BP + n], Bs[(k + 9) * BP + n]);
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
          *reinterpret_cast<__nv_bfloat162*>(c + (long long)row * N + col) =
              __floats2bfloat162_rn(acc[mt][nt][2 * rr],
                                    acc[mt][nt][2 * rr + 1]);
      }
    }
  }
}

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(THREADS)
gemm_f32(const float* __restrict__ a, const float* __restrict__ b,
         float* __restrict__ c, long long lda, int M, int K, int N) {
  constexpr int TM = BM / 16, TN = BN / 16;     // per-thread piece
  constexpr int AP = BM + 4, BP = BN + 4;       // padded rows (f32)
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);   // [BK][AP], A^T
  float* Bs = As + BK * AP;                      // [BK][BP]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += THREADS) {
      const int r = idx / BK, cc = idx % BK;
      const int row = m0 + r, k = k0 + cc;
      As[cc * AP + r] = row < M && k < K ? a[row * lda + k] : 0.f;
    }
    for (int idx = tid; idx < BK * BN; idx += THREADS) {
      const int r = idx / BN, cc = idx % BN;
      const int k = k0 + r, n = n0 + cc;
      Bs[r * BP + cc] = k < K && n < N ? b[(long long)k * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[k * AP + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[k * BP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < N) c[(long long)row * N + col] = acc[i][j];
    }
  }
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <int BM, int BN, int BK>
cudaError_t launch(int dtype, const void* a, const void* b, void* c,
                   long long lda, int M, int K, int N, cudaStream_t st) {
  static_assert(BM % 32 == 0 && BN % 32 == 0 && BK % 16 == 0,
                "tile shape");
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaError_t err;
  if (dtype == 1) {
    constexpr int smem = smem_bf16(BM, BN, BK);
    static_assert(smem <= SMEM_LIMIT, "bf16 tiles over the law");
    err = opt_in(gemm_mma<BM, BN, BK>, smem);
    if (err != cudaSuccess) return err;
    gemm_mma<BM, BN, BK><<<grid, THREADS, smem, st>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(c),
        lda, M, K, N);
  } else {
    constexpr int smem = smem_f32(BM, BN, BK);
    static_assert(smem <= SMEM_LIMIT, "f32 tiles over the law");
    err = opt_in(gemm_f32<BM, BN, BK>, smem);
    if (err != cudaSuccess) return err;
    gemm_f32<BM, BN, BK><<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(c), lda, M, K, N);
  }
  return cudaGetLastError();
}

}  // namespace

// The compiled block shapes (bm, bn, bk); ops.py::SHAPES lists the same:
// the default (128, 128, 32) and the Table 2 sweep of bn at bm = 64,
// bk = 32. A thread's accumulator is at most 64 registers in both paths.
#define GEMM_SHAPES(X)                                                      \
  X(64, 32, 32) X(64, 64, 32) X(64, 128, 32) X(64, 256, 32) X(128, 128, 32)

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (a, b and c). a is addressed as
// a + m * lda + k (lda >= K), b and c are contiguous. bf16 needs K, N and
// lda multiples of 8 and 16-byte aligned a and b. Returns the CUDA error of
// the launch (0 = success); an uncompiled block shape is
// cudaErrorInvalidValue.
int gemm(int device, int dtype, const void* a, const void* b, void* c,
         long long lda, int M, int K, int N, int bm, int bn, int bk,
         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M < 1 || K < 0 || N < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && (K % 8 || N % 8 || lda % 8 || (uintptr_t)a % 16 ||
                     (uintptr_t)b % 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GEMM_CASE(BM_, BN_, BK_)                                         \
  if (bm == BM_ && bn == BN_ && bk == BK_)                               \
    return (int)launch<BM_, BN_, BK_>(dtype, a, b, c, lda, M, K, N, st);
  GEMM_SHAPES(GEMM_CASE)
#undef GEMM_CASE
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory one block of (dtype, bm, bn, bk) allocates.
int gemm_smem_bytes(int dtype, int bm, int bn, int bk) {
  return dtype == 1 ? smem_bf16(bm, bn, bk) : smem_f32(bm, bn, bk);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

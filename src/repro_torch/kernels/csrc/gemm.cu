// Tiled GEMM on Hopper (sm_90a): C = A @ B, the paper's §4 benchmark.
//
// Replaces the TPU kernel repro/kernels/gemm/gemm.py::gemm (_gemm_kernel).
// Same contract: A (M, K) @ B (K, N) -> C (M, N) in A's dtype, f32 sums,
// (bm, bn) output tiles with K walked in steps of bk. Every (bm, bn, bk) of
// GEMM_SHAPES below is its own template instance, so the paper's "buffered
// columns" knob (bn) measures what it names. What the card asks for besides:
// - the TPU kernel holds its (bm, bn) f32 accumulator in VMEM; here it
//   lives in registers, and only the A and B tiles sit in shared memory, so
//   the capacity law is smem_bytes() (kernels/gemm/ops.py) against the
//   227 KiB a block may opt into, and a shape over it is refused;
// - the TPU grid runs in order on one core; here 132 SMs want blocks. HBB
//   hands the accelerator chunks of S_f <= 256 rows of a 1024-wide product:
//   8-16 output tiles. So the f32 path splits K over `splits` blocks
//   (ops.py::plan picks tile and splits by shape), and the last block of a
//   tile to arrive sums the partial tiles in split order: one launch, no
//   float atomics, bit-equal across calls;
// - HBB's chunks have any row count: rows are masked at the ragged edge of
//   M (the TPU kernel needs M % bm == 0), and A is read through its row
//   stride, so a chunk is the view A[b:e] of a card-resident A, not a copy.
//
// What bounds it. bf16: operations, 2 M N K at 989 TFLOP/s (4096^3: 0.139
// ms). f32 on CUDA cores (no TF32: the contract holds f32 to 1e-5 of the
// plain product): operations at 67 TFLOP/s (4096^3: 2.05 ms; an HBB chunk of
// 256 x 1024 x 1024: 8 us); below 32 chunk rows, bytes (B's 4 MiB: 1.3 us).
//
// Two paths, one contract, 256 threads (8 warps) per block.
//
// gemm_f32 (f32): FFMA on CUDA cores. A ring of 3 stages of A and B tiles
// in shared memory, filled by 16-byte cp.async copies (4-byte copies where
// K, N or the row stride is not a multiple of 4), with one barrier per K
// step: the copies of step k + 2 run while the FFMAs of step k do. Both
// tiles are stored row-major as they arrive (cp.async cannot transpose);
// threads 16 x 16, each a (bm / 16) x (bn / 16) piece, read A's rows as
// float4 runs along K (a warp shares two rows: broadcast loads) and B's as
// float4 runs along N, so 4 k steps of an 8 x 8 piece cost 16 shared loads
// for 256 FFMAs. Split, each block writes its partial tile to a workspace
// the caller allocates, (splits, M, N) f32, then counts its arrival on the
// tile's counter (atomicInc, which wraps it back to 0 for the next call);
// the last to arrive reads the partials (L2, __ldcg) into its accumulator
// registers, a split's loads independent of each other, and writes C.
//
// gemm_mma (bf16): the tensor cores through mma.sync m16n8k16 (mma.cuh), the
// design of grouped_gemm.cu's gg_mma: warps 2 x 4, each a (16 MT) x (8 NT)
// piece of the tile in registers; the next K step's tiles are loaded from
// device memory into registers (16-byte loads) while the tensor cores work
// on the current step's tiles in shared memory. Needs K and N multiples of
// 8 and 16-byte aligned rows. Not split.
//
// Not yet used: wgmma, TMA (the bf16 path's next step).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int SMEM_LIMIT = 232448;   // 227 KiB: the most one block may use
constexpr int STAGES = 3;            // f32 ring depth

// Shared memory of one block (the capacity law, ops.py::smem_bytes): bf16
// tiles row-major with 8 elements of padding per row (A: bm x bk, B: bk x
// bn); f32 tiles row-major with 4, STAGES of each.
constexpr int smem_bf16(int bm, int bn, int bk) {
  return (bm * (bk + 8) + bk * (bn + 8)) * 2;
}
constexpr int smem_f32(int bm, int bn, int bk) {
  return STAGES * (bm * (bk + 4) + bk * (bn + 4)) * 4;
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

// Block z walks K in [z * kspan, min(K, (z + 1) * kspan)). With one split
// it writes C. With gridDim.z splits it writes its partial tile to
// ws + z * M * N, and the last of the tile's blocks to arrive (its counter
// in cnt, zero before and after the call) sums the partials into C.
template <int BM, int BN, int BK, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
gemm_f32(const float* __restrict__ a, const float* __restrict__ b,
         float* __restrict__ c, float* __restrict__ ws,
         unsigned* __restrict__ cnt, long long lda, int M, int K, int N,
         int kspan) {
  constexpr int TM = BM / 16, TN = BN / 16;     // per-thread piece
  constexpr int V = TN < 4 ? TN : 4;            // B's run along N (floats)
  constexpr int NV = TN / V;
  constexpr int AP = BK + 4, BP = BN + 4;       // padded rows (f32)
  constexpr int STAGE = BM * AP + BK * BP;
  static_assert(BK % 4 == 0 && TN % V == 0 && BM * BK % (4 * THREADS) == 0 &&
                    BK * BN % (4 * THREADS) == 0,
                "tile shape");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);   // STAGES x {A, B}
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * kspan, ke = min(K, kb + kspan);
  const int steps = (ke - kb + BK - 1) / BK;

  // step s of this block's K range into ring stage s % STAGES; copies
  // past M, N or the range's end are zero-filled
  auto load = [&](int s) {
    float* As = smem + (s % STAGES) * STAGE;   // [BM][AP]
    float* Bs = As + BM * AP;                  // [BK][BP]
    const int k0 = kb + s * BK;
    if constexpr (VEC) {
#pragma unroll
      for (int it = 0; it < BM * BK / 4 / THREADS; ++it) {
        const int i = tid + it * THREADS;
        const int r = i / (BK / 4), cc = (i % (BK / 4)) * 4;
        const bool ok = m0 + r < M && k0 + cc < ke;
        cp_async16(As + r * AP + cc, ok ? a + (m0 + r) * lda + k0 + cc : a,
                   ok);
      }
#pragma unroll
      for (int it = 0; it < BK * BN / 4 / THREADS; ++it) {
        const int i = tid + it * THREADS;
        const int r = i / (BN / 4), cc = (i % (BN / 4)) * 4;
        const bool ok = k0 + r < ke && n0 + cc < N;
        cp_async16(Bs + r * BP + cc,
                   ok ? b + (long long)(k0 + r) * N + n0 + cc : b, ok);
      }
    } else {
#pragma unroll 4
      for (int i = tid; i < BM * BK; i += THREADS) {
        const int r = i / BK, cc = i % BK;
        const bool ok = m0 + r < M && k0 + cc < ke;
        cp_async4(As + r * AP + cc, ok ? a + (m0 + r) * lda + k0 + cc : a,
                  ok);
      }
#pragma unroll 4
      for (int i = tid; i < BK * BN; i += THREADS) {
        const int r = i / BN, cc = i % BN;
        const bool ok = k0 + r < ke && n0 + cc < N;
        cp_async4(Bs + r * BP + cc,
                  ok ? b + (long long)(k0 + r) * N + n0 + cc : b, ok);
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();              // one group per step, empty or not
  }
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<STAGES - 2>();    // this thread's copies of step t landed
    __syncthreads();                // everyone's; step t - 1's stage is free
    if (t + STAGES - 1 < steps) load(t + STAGES - 1);
    cp_async_commit();
    const float* As = smem + (t % STAGES) * STAGE;
    const float* Bs = As + BM * AP;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float av[TM][4];              // rows ty + 16 i, k steps kk .. kk + 3
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 x =
            *reinterpret_cast<const float4*>(As + (ty + 16 * i) * AP + kk);
        av[i][0] = x.x, av[i][1] = x.y, av[i][2] = x.z, av[i][3] = x.w;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float bv[TN];               // cols 16 V jv + V tx + u
        const float* br = Bs + (kk + k) * BP + V * tx;
#pragma unroll
        for (int jv = 0; jv < NV; ++jv) {
          if constexpr (V == 4) {
            const float4 y =
                *reinterpret_cast<const float4*>(br + 16 * V * jv);
            bv[4 * jv] = y.x, bv[4 * jv + 1] = y.y, bv[4 * jv + 2] = y.z,
            bv[4 * jv + 3] = y.w;
          } else {
#pragma unroll
            for (int u = 0; u < V; ++u) bv[V * jv + u] = br[16 * V * jv + u];
          }
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(av[i][k], bv[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();

  const int splits = gridDim.z;
  const long long mn = (long long)M * N;
  // the thread's piece of the tile, rows ty + 16 i and runs of V columns,
  // to o (C or a partial in ws)
  auto store = [&](float* o) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = m0 + ty + 16 * i;
      if (row >= M) continue;
#pragma unroll
      for (int jv = 0; jv < NV; ++jv) {
        const int col = n0 + 16 * V * jv + V * tx;
        float* dst = o + (long long)row * N + col;
        if (VEC && V == 4) {        // N % 4 == 0: the run is in or out
          if (col < N)
            *reinterpret_cast<float4*>(dst) =
                make_float4(acc[i][4 * jv], acc[i][4 * jv + 1],
                            acc[i][4 * jv + 2], acc[i][4 * jv + 3]);
        } else {
#pragma unroll
          for (int u = 0; u < V; ++u)
            if (col + u < N) dst[u] = acc[i][V * jv + u];
        }
      }
    }
  };
  if (splits == 1) {
    store(c);
    return;
  }
  store(ws + blockIdx.z * mn);

  // the last block of the tile to arrive sums the partials in split order
  // (into acc, whose values are in ws now); a split's loads are independent
  __shared__ unsigned last;
  __threadfence();                  // this block's partial before its count
  __syncthreads();
  if (tid == 0)                     // atomicInc wraps the counter to 0
    last = atomicInc(cnt + blockIdx.y * gridDim.x + blockIdx.x,
                     splits - 1) == (unsigned)(splits - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int z = 0; z < splits; ++z) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = min(m0 + ty + 16 * i, M - 1);   // rows past M unused
#pragma unroll
      for (int jv = 0; jv < NV; ++jv) {
        const int col = n0 + 16 * V * jv + V * tx;
        const float* src = ws + z * mn + (long long)row * N + col;
        float x[V];
        if constexpr (VEC && V == 4) {
          const float4 y = col < N
              ? __ldcg(reinterpret_cast<const float4*>(src))
              : make_float4(0.f, 0.f, 0.f, 0.f);
          x[0] = y.x, x[1] = y.y, x[2] = y.z, x[3] = y.w;
        } else {
#pragma unroll
          for (int u = 0; u < V; ++u)
            x[u] = col + u < N ? __ldcg(src + u) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < V; ++u)
          acc[i][V * jv + u] = z ? acc[i][V * jv + u] + x[u] : x[u];
      }
    }
  }
  store(c);
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <int BM, int BN, int BK, bool VEC>
cudaError_t launch_f32(const float* a, const float* b, float* c, float* ws,
                       unsigned* cnt, long long lda, int M, int K, int N,
                       int kspan, dim3 grid, cudaStream_t st) {
  constexpr int smem = smem_f32(BM, BN, BK);
  static_assert(smem <= SMEM_LIMIT, "f32 tiles over the law");
  cudaError_t err = opt_in(gemm_f32<BM, BN, BK, VEC>, smem);
  if (err != cudaSuccess) return err;
  gemm_f32<BM, BN, BK, VEC><<<grid, THREADS, smem, st>>>(a, b, c, ws, cnt,
                                                         lda, M, K, N, kspan);
  return cudaGetLastError();
}

template <int BM, int BN, int BK>
cudaError_t launch(int dtype, const void* a, const void* b, void* c, void* ws,
                   void* cnt, long long lda, int M, int K, int N, int splits,
                   cudaStream_t st) {
  static_assert(BM % 32 == 0 && BN % 32 == 0 && BK % 16 == 0,
                "tile shape");
  cudaError_t err;
  if (dtype == 1) {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    constexpr int smem = smem_bf16(BM, BN, BK);
    static_assert(smem <= SMEM_LIMIT, "bf16 tiles over the law");
    err = opt_in(gemm_mma<BM, BN, BK>, smem);
    if (err != cudaSuccess) return err;
    gemm_mma<BM, BN, BK><<<grid, THREADS, smem, st>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(c),
        lda, M, K, N);
    return cudaGetLastError();
  }
  // K in slices of whole steps; the last slice may be short
  const int kspan = splits > 1
      ? ((K + splits - 1) / splits + BK - 1) / BK * BK : (K > 0 ? K : 1);
  const int z = splits > 1 ? (K + kspan - 1) / kspan : 1;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, z);
  const bool vec = K % 4 == 0 && N % 4 == 0 && lda % 4 == 0 &&
                   (uintptr_t)a % 16 == 0 && (uintptr_t)b % 16 == 0 &&
                   (uintptr_t)c % 16 == 0 && (uintptr_t)ws % 16 == 0;
  const float *fa = static_cast<const float*>(a),
              *fb = static_cast<const float*>(b);
  float *fc = static_cast<float*>(c), *fw = static_cast<float*>(ws);
  unsigned* fn = static_cast<unsigned*>(cnt);
  return vec ? launch_f32<BM, BN, BK, true>(fa, fb, fc, fw, fn, lda, M, K, N,
                                            kspan, grid, st)
             : launch_f32<BM, BN, BK, false>(fa, fb, fc, fw, fn, lda, M, K, N,
                                             kspan, grid, st);
}

}  // namespace

// The compiled block shapes (bm, bn, bk); ops.py::SHAPES lists the same:
// the default (128, 128, 32), the Table 2 sweep of bn at bm = 64, bk = 32,
// and (32, 64, 32) for chunks of few rows. A thread's accumulator is at most
// 64 registers in both paths.
#define GEMM_SHAPES(X)                                                      \
  X(32, 64, 32) X(64, 32, 32) X(64, 64, 32) X(64, 128, 32) X(64, 256, 32)  \
  X(128, 128, 32)

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (a, b and c). a is addressed as
// a + m * lda + k (lda >= K), b and c are contiguous. bf16 needs K, N and
// lda multiples of 8 and 16-byte aligned a and b, and splits = 1. f32 with
// splits > 1 splits K over as many blocks (fewer if K is short) and needs
// ws, a (splits, M, N) f32 workspace, and cnt, one unsigned counter per
// output tile, zero (the kernel leaves it zero). Returns the CUDA error of
// the launch (0 = success); an uncompiled block shape is
// cudaErrorInvalidValue.
int gemm(int device, int dtype, const void* a, const void* b, void* c,
         void* ws, void* cnt, long long lda, int M, int K, int N, int bm,
         int bn, int bk, int splits, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M < 1 || K < 0 || N < 1 || (dtype != 0 && dtype != 1) || splits < 1 ||
      (splits > 1 && (dtype != 0 || ws == nullptr || cnt == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && (K % 8 || N % 8 || lda % 8 || (uintptr_t)a % 16 ||
                     (uintptr_t)b % 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GEMM_CASE(BM_, BN_, BK_)                                         \
  if (bm == BM_ && bn == BN_ && bk == BK_)                               \
    return (int)launch<BM_, BN_, BK_>(dtype, a, b, c, ws, cnt, lda, M, K, N, \
                                      splits, st);
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

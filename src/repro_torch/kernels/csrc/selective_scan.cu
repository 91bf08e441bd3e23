// Mamba-1 selective scan on Hopper (sm_90a), forward and backward.
//
// Replaces no TPU kernel: JAX computes the scan as an associative_scan
// inside a lax.scan over chunks (repro/models/mamba.py::mamba1_mixer,
// chunk_body) and differentiates it in XLA. Same arithmetic for each batch
// row b and channel c, in f32:
//   h_t = exp(dt_t * A[c]) ⊙ h_{t-1} + (dt_t * x_t) * B_t      (N,)
//   y_t = Σ_n h_t[n] * C_t[n]
// with x, dt (B, S, C), A (C, N), B and C (B, S, N), the state h0 and
// h_last (B, C, N), all contiguous. The D skip, the silu(z) gate and the
// projections stay in the caller, as in JAX.
//
// Forward. What bounds it: the bytes. x, dt and y are 4 B per (t, c), so a
// jamba prefill row of 2000 tokens at C 8192 moves ~197 MB (0.059 ms at
// 3.35 TB/s); B and C are N floats per t and shared by every channel. The
// operations (an exp and 4 flops per (t, c, n)) are ~1.3 GFLOP on the f32
// CUDA cores, 0.02 ms at 67 TFLOP/s. The design:
// - The state stays in registers for the whole walk over t, in order, so
//   nothing but x, dt, y, B and C touches memory and no chunk padding is
//   needed: a step is a step.
// - A channel's N = 16 state entries are split over LANES = 8 lanes of a
//   warp (NPT = N / LANES each), 4 channels a warp, and y_t is the sum of
//   the lanes' partials by three xor shuffles. At C 8192 that is 65,536
//   threads for one row (256 blocks of 256), where one thread a channel
//   would give 8192.
// - A block owns 32 channels of one row. It stages a tile of TS = 32 steps
//   in shared memory: x and dt of its channels (128-byte rows, coalesced),
//   and B_t and C_t, which every channel reads. The tile's y goes to shared
//   memory and out in 128-byte rows.
// - For training, the forward also writes the state entering each tile,
//   hs (B, ceil(S / TS), C, N): the backward's checkpoints. Serving passes
//   no hs and runs instances compiled without that store.
//
// Backward (selective_scan_bwd_kernel). With g_t = dL/dh_t, walked from the
// last step to the first from g = dh_last:
//   g_t = C_t dy_t + a_{t+1} g_{t+1},   a_t = exp(dt_t A)
//   dx_t = dt_t Σ_n B_t g_t,   ddt_t = x_t Σ_n B_t g_t + Σ_n A a_t h_{t-1} g_t
//   dA = Σ_{b,t} dt_t a_t h_{t-1} g_t,   dh0 = a_0 g_0
//   dB_t = Σ_c dt_t x_t g_t,   dC_t = Σ_c h_t dy_t   (sums over channels)
// The states are never recovered by dividing by a_t (it underflows): each
// tile, last to first, recomputes its states from the saved hs with the
// same expf on the same operands as the forward (so they are the forward's
// bits), keeping them in registers, then walks its steps in reverse. At
// jamba's training layer (B 2, S 2048, C 8192, N 16) it reads x, dt, dy and
// hs and writes dx and ddt, ~0.74 GB (0.22 ms at 3.35 TB/s), and takes two
// expf a (t, c, n), 1.07 G, on the special-function units. The layout is
// the forward's (8 lanes a channel, 32 channels a block, a tile of x, dt,
// dy, B and C in shared memory); dx and ddt are lane sums by shuffles; dA
// stays in registers across tiles; dB and dC are summed over a warp's 4
// channels by shuffles and over a block's 8 warps in shared memory, in a
// fixed order, into one partial per block of channels, and a second launch
// (sum_parts_kernel) adds the partials (and dA over the batch) in a fixed
// order: no atomics, so two calls give the same bits.
// This is the first, simple kernel: one expf a state entry and step
// (expf, as the plain version), and no overlap of a tile's loads with the
// previous tile's steps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 8;                 // lanes of one channel
constexpr int CPB = 32;                  // channels of a block
constexpr int THREADS = LANES * CPB;     // 256
constexpr int WARPS = THREADS / 32;      // 8
constexpr int TS = 32;                   // steps staged a tile
constexpr int N_MAX = 64;                // NPT up to 8

// one step of the state entry: the forward's and the backward's recompute
// share it, so both round alike
__device__ __forceinline__ float step(float h, float d, float a, float u,
                                      float b) {
  return fmaf(expf(d * a), h, u * b);
}

// SAVE: also write the state entering each tile to hs (training); serving's
// instances (SAVE false) compile without it
template <int NPT, bool SAVE>
__global__ void __launch_bounds__(THREADS)
selective_scan_kernel(const float* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ h_last, float* __restrict__ hs,
                      int S, int C) {
  constexpr int N = NPT * LANES;
  __shared__ float sx[TS][CPB];
  __shared__ float sdt[TS][CPB];
  __shared__ float sy[TS][CPB];
  __shared__ float sB[TS][N];
  __shared__ float sC[TS][N];

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * CPB;
  const int tid = threadIdx.x;
  const int ch = tid / LANES;            // channel of the block
  const int lane = tid % LANES;          // entries lane * NPT + i
  const int c = c0 + ch;
  const bool live = c < C;
  const long long row = (long long)b * S;
  const int K = (S + TS - 1) / TS;

  float a[NPT], h[NPT];
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    const int n = lane * NPT + i;
    a[i] = live ? A[(long long)c * N + n] : 0.f;
    h[i] = live ? h0[((long long)b * C + c) * N + n] : 0.f;
  }

  for (int t0 = 0; t0 < S; t0 += TS) {
    const int ts = min(TS, S - t0);
    if (SAVE && live) {
      float* dst = hs + (((long long)b * K + t0 / TS) * C + c) * N +
                   lane * NPT;
#pragma unroll
      for (int i = 0; i < NPT; ++i) dst[i] = h[i];
    }
    for (int i = tid; i < TS * CPB; i += THREADS) {
      const int r = i / CPB, k = i % CPB;
      const bool ok = r < ts && c0 + k < C;
      const long long off = (row + t0 + r) * C + c0 + k;
      sx[r][k] = ok ? x[off] : 0.f;
      sdt[r][k] = ok ? dt[off] : 0.f;
    }
    for (int i = tid; i < TS * N; i += THREADS) {
      const int r = i / N, k = i % N;
      const bool ok = r < ts;
      const long long off = (row + t0 + r) * N + k;
      sB[r][k] = ok ? Bm[off] : 0.f;
      sC[r][k] = ok ? Cm[off] : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < ts; ++r) {
      const float d = sdt[r][ch];
      const float u = d * sx[r][ch];
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < NPT; ++i) {
        const int n = lane * NPT + i;
        h[i] = step(h[i], d, a[i], u, sB[r][n]);
        part = fmaf(h[i], sC[r][n], part);
      }
#pragma unroll
      for (int o = LANES / 2; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) sy[r][ch] = part;
    }
    __syncthreads();
    for (int i = tid; i < ts * CPB; i += THREADS) {
      const int r = i / CPB, k = i % CPB;
      if (c0 + k < C) y[(row + t0 + r) * C + c0 + k] = sy[r][k];
    }
    // the next tile's staging writes sx, sdt, sB and sC, which no thread
    // reads after the barrier above; sy is written only after the next
    // tile's barrier, when every thread has stored this one's
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < NPT; ++i)
      h_last[((long long)b * C + c) * N + lane * NPT + i] = h[i];
  }
}

// Steps of a sub-tile whose states a thread keeps in registers (NPT * SUB
// floats): the whole tile up to N 16 (64 floats), a quarter or an eighth of
// it above (at most 32). Sub-tile j's entering state is recomputed from
// the tile's saved one over the j * SUB steps before it: no extra steps up
// to N 16, 1.5 and 3.5 tiles' more above.
template <int NPT>
__host__ __device__ constexpr int sub_steps() {
  return NPT <= 2 ? TS : NPT <= 4 ? TS / 4 : TS / 8;
}

// floats of the backward's dynamic shared memory at state width N
__host__ __device__ constexpr int bwd_smem_floats(int N) {
  return 5 * TS * CPB + 2 * TS * N + 2 * WARPS * TS * N;
}

// two blocks an SM up to N 32 (128 registers a thread); one above, where a
// lane's 5 to 8 state entries and their sub-tile states want more
template <int NPT>
__global__ void __launch_bounds__(THREADS, NPT <= 4 ? 2 : 1)
selective_scan_bwd_kernel(const float* __restrict__ x,
                          const float* __restrict__ dt,
                          const float* __restrict__ A,
                          const float* __restrict__ Bm,
                          const float* __restrict__ Cm,
                          const float* __restrict__ hs,
                          const float* __restrict__ dy,
                          const float* __restrict__ dh_last,
                          float* __restrict__ dx, float* __restrict__ ddt,
                          float* __restrict__ dA_part,
                          float* __restrict__ dB_part,
                          float* __restrict__ dC_part,
                          float* __restrict__ dh0, int S, int C) {
  constexpr int N = NPT * LANES;
  constexpr int SUB = sub_steps<NPT>();
  constexpr int NSUB = TS / SUB;
  extern __shared__ float smem[];
  float (*sx)[CPB] = reinterpret_cast<float (*)[CPB]>(smem);
  float (*sdt)[CPB] = sx + TS;
  float (*sdy)[CPB] = sdt + TS;
  float (*sdx)[CPB] = sdy + TS;
  float (*sddt)[CPB] = sdx + TS;
  float (*sB)[N] = reinterpret_cast<float (*)[N]>(sddt + TS);
  float (*sC)[N] = sB + TS;
  // per warp: its 4 channels' sums of dB and dC, (WARPS, TS, N) each
  float (*sdB)[N] = sC + TS;
  float (*sdC)[N] = sdB + WARPS * TS;

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * CPB;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int ch = tid / LANES;
  const int lane = tid % LANES;
  const bool first_of_warp = tid % 32 < LANES;   // channel 0 of its warp
  const int c = c0 + ch;
  const bool live = c < C;
  const long long row = (long long)b * S;
  const int K = (S + TS - 1) / TS;
  const long long part_row =
      ((long long)b * gridDim.x + blockIdx.x) * S;   // dB/dC partial rows

  float a[NPT], g[NPT], da[NPT];
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    const int n = lane * NPT + i;
    a[i] = live ? A[(long long)c * N + n] : 0.f;
    g[i] = live && dh_last != nullptr
               ? dh_last[((long long)b * C + c) * N + n] : 0.f;
    da[i] = 0.f;
  }

  for (int k = K - 1; k >= 0; --k) {
    const int t0 = k * TS;
    const int ts = min(TS, S - t0);
    for (int i = tid; i < TS * CPB; i += THREADS) {
      const int r = i / CPB, kk = i % CPB;
      const bool ok = r < ts && c0 + kk < C;
      const long long off = (row + t0 + r) * C + c0 + kk;
      sx[r][kk] = ok ? x[off] : 0.f;
      sdt[r][kk] = ok ? dt[off] : 0.f;
      sdy[r][kk] = ok ? dy[off] : 0.f;
    }
    for (int i = tid; i < TS * N; i += THREADS) {
      const int r = i / N, kk = i % N;
      const bool ok = r < ts;
      const long long off = (row + t0 + r) * N + kk;
      sB[r][kk] = ok ? Bm[off] : 0.f;
      sC[r][kk] = ok ? Cm[off] : 0.f;
    }
    // Steps past ts have x = dt = 0 staged: exp(0) = 1 and u = 0, exact
    // no-op steps in both walks, so no step needs a guard.
    float hin[NPT];
#pragma unroll
    for (int i = 0; i < NPT; ++i)
      hin[i] = live ? hs[(((long long)b * K + k) * C + c) * N +
                         lane * NPT + i] : 0.f;
    __syncthreads();
#pragma unroll
    for (int j = NSUB - 1; j >= 0; --j) {
      // hst[q] = the state after step j * SUB + q - 1
      float hst[SUB + 1][NPT];
#pragma unroll
      for (int i = 0; i < NPT; ++i) hst[0][i] = hin[i];
#pragma unroll 1
      for (int r = 0; r < j * SUB; ++r) {
        const float d = sdt[r][ch];
        const float u = d * sx[r][ch];
#pragma unroll
        for (int i = 0; i < NPT; ++i)
          hst[0][i] = step(hst[0][i], d, a[i], u, sB[r][lane * NPT + i]);
      }
#pragma unroll
      for (int q = 0; q < SUB; ++q) {
        const int r = j * SUB + q;
        const float d = sdt[r][ch];
        const float u = d * sx[r][ch];
#pragma unroll
        for (int i = 0; i < NPT; ++i)
          hst[q + 1][i] = step(hst[q][i], d, a[i], u,
                               sB[r][lane * NPT + i]);
      }
#pragma unroll
      for (int q = SUB - 1; q >= 0; --q) {
        const int r = j * SUB + q;
        const float d = sdt[r][ch];
        const float xv = sx[r][ch];
        const float u = d * xv;
        const float dyv = sdy[r][ch];
        float sbg = 0.f, sahg = 0.f, vb[NPT], vc[NPT];
#pragma unroll
        for (int i = 0; i < NPT; ++i) {
          const int n = lane * NPT + i;
          const float ai = expf(d * a[i]);
          g[i] = fmaf(sC[r][n], dyv, g[i]);          // dL/dh_r
          vc[i] = hst[q + 1][i] * dyv;
          vb[i] = u * g[i];
          sbg = fmaf(sB[r][n], g[i], sbg);
          const float w = ai * hst[q][i] * g[i];
          da[i] = fmaf(d, w, da[i]);
          sahg = fmaf(a[i], w, sahg);
          g[i] *= ai;                                 // into dL/dh_{r-1}
        }
#pragma unroll
        for (int o = LANES / 2; o > 0; o >>= 1) {
          sbg += __shfl_xor_sync(0xffffffffu, sbg, o);
          sahg += __shfl_xor_sync(0xffffffffu, sahg, o);
        }
#pragma unroll
        for (int i = 0; i < NPT; ++i) {
#pragma unroll
          for (int o = LANES; o < 32; o <<= 1) {
            vb[i] += __shfl_xor_sync(0xffffffffu, vb[i], o);
            vc[i] += __shfl_xor_sync(0xffffffffu, vc[i], o);
          }
        }
        if (lane == 0) {
          sdx[r][ch] = d * sbg;
          sddt[r][ch] = fmaf(xv, sbg, sahg);
        }
        if (first_of_warp) {
#pragma unroll
          for (int i = 0; i < NPT; ++i) {
            sdB[warp * TS + r][lane * NPT + i] = vb[i];
            sdC[warp * TS + r][lane * NPT + i] = vc[i];
          }
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < ts * CPB; i += THREADS) {
      const int r = i / CPB, kk = i % CPB;
      if (c0 + kk < C) {
        const long long off = (row + t0 + r) * C + c0 + kk;
        dx[off] = sdx[r][kk];
        ddt[off] = sddt[r][kk];
      }
    }
    for (int i = tid; i < ts * N; i += THREADS) {
      const int r = i / N, n = i % N;
      float sb = 0.f, sc = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        sb += sdB[w * TS + r][n];
        sc += sdC[w * TS + r][n];
      }
      const long long off = (part_row + t0 + r) * N + n;
      dB_part[off] = sb;
      dC_part[off] = sc;
    }
    // the next tile's staging writes sx … sC, read only before the barrier
    // above; sdx … sdC are written only after the next tile's barrier
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < NPT; ++i) {
      const long long off = ((long long)b * C + c) * N + lane * NPT + i;
      dh0[off] = g[i];
      dA_part[off] = da[i];
    }
  }
}

// out[o, i] = Σ_{j < J} part[o, j, i], j in order: one job a blockIdx.z
struct SumJob {
  const float* part;
  float* out;
  int outer, J;
  long long inner;
};
struct SumJobs {
  SumJob job[3];
};

__global__ void __launch_bounds__(256) sum_parts_kernel(SumJobs jobs) {
  const SumJob jb = jobs.job[blockIdx.z];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int o = blockIdx.y;
  if (o >= jb.outer || i >= jb.inner) return;
  const float* p = jb.part + (long long)o * jb.J * jb.inner + i;
  float s = 0.f;
  for (int j = 0; j < jb.J; ++j) s += p[(long long)j * jb.inner];
  jb.out[(long long)o * jb.inner + i] = s;
}

template <int NPT>
cudaError_t launch(const float* x, const float* dt, const float* A,
                   const float* Bm, const float* Cm, const float* h0,
                   float* y, float* h_last, float* hs, int B, int S, int C,
                   cudaStream_t stream) {
  dim3 grid((C + CPB - 1) / CPB, B);
  if (hs != nullptr)
    selective_scan_kernel<NPT, true><<<grid, THREADS, 0, stream>>>(
        x, dt, A, Bm, Cm, h0, y, h_last, hs, S, C);
  else
    selective_scan_kernel<NPT, false><<<grid, THREADS, 0, stream>>>(
        x, dt, A, Bm, Cm, h0, y, h_last, hs, S, C);
  return cudaGetLastError();
}

struct BwdArgs {
  const float *x, *dt, *A, *Bm, *Cm, *hs, *dy, *dh_last;
  float *dx, *ddt, *dA_part, *dB_part, *dC_part, *dA, *dB, *dC, *dh0;
  int B, S, C, N;
};

template <int NPT>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  const int ncb = (a.C + CPB - 1) / CPB;
  const size_t smem = sizeof(float) * bwd_smem_floats(NPT * LANES);
  cudaError_t err = cudaFuncSetAttribute(
      selective_scan_bwd_kernel<NPT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  selective_scan_bwd_kernel<NPT><<<dim3(ncb, a.B), THREADS, smem, stream>>>(
      a.x, a.dt, a.A, a.Bm, a.Cm, a.hs, a.dy, a.dh_last, a.dx, a.ddt,
      a.dA_part, a.dB_part, a.dC_part, a.dh0, a.S, a.C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long sn = (long long)a.S * a.N, cn = (long long)a.C * a.N;
  SumJobs jobs{{{a.dB_part, a.dB, a.B, ncb, sn},
                {a.dC_part, a.dC, a.B, ncb, sn},
                {a.dA_part, a.dA, 1, a.B, cn}}};
  const long long widest = sn > cn ? sn : cn;
  sum_parts_kernel<<<dim3((unsigned)((widest + 255) / 256), a.B, 3), 256, 0,
                     stream>>>(jobs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, dt (B, S, C), A (C, N), Bm, Cm (B, S, N), h0 (B, C, N) → y (B, S, C),
// h_last (B, C, N), and with hs non-null the state entering each tile of 32
// steps, hs (B, ceil(S / 32), C, N); f32, contiguous. N a multiple of 8 up
// to 64. Returns the CUDA error of the launch.
int selective_scan(int device, const float* x, const float* dt,
                   const float* A, const float* Bm, const float* Cm,
                   const float* h0, float* y, float* h_last, float* hs,
                   int B, int S, int C, int N, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || B > 65535 || S < 1 || C < 1 || N < LANES || N > N_MAX ||
      N % LANES)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N / LANES) {
    case 1: err = launch<1>(x, dt, A, Bm, Cm, h0, y, h_last, hs, B, S, C, s); break;
    case 2: err = launch<2>(x, dt, A, Bm, Cm, h0, y, h_last, hs, B, S, C, s); break;
    case 3: err = launch<3>(x, dt, A, Bm, Cm, h0, y, h_last, hs, B, S, C, s); break;
    case 4: err = launch<4>(x, dt, A, Bm, Cm, h0, y, h_last, hs, B, S, C, s); break;
    case 5: err = launch<5>(x, dt, A, Bm, Cm, h0, y, h_last, hs, B, S, C, s); break;
    case 6: err = launch<6>(x, dt, A, Bm, Cm, h0, y, h_last, hs, B, S, C, s); break;
    case 7: err = launch<7>(x, dt, A, Bm, Cm, h0, y, h_last, hs, B, S, C, s); break;
    default: err = launch<8>(x, dt, A, Bm, Cm, h0, y, h_last, hs, B, S, C, s);
  }
  return (int)err;
}

// The backward of selective_scan given its saved hs and the cotangents dy
// (B, S, C) and dh_last (B, C, N; null for zeros) → dx, ddt (B, S, C), dA
// (C, N), dB, dC (B, S, N), dh0 (B, C, N). Scratch: dA_part (B, C, N),
// dB_part and dC_part (B, ceil(C / 32), S, N). f32, contiguous. Two
// launches: the reverse walk, then the sums of the partials. Returns the
// CUDA error of the first launch that failed.
int selective_scan_bwd(int device, const float* x, const float* dt,
                       const float* A, const float* Bm, const float* Cm,
                       const float* hs, const float* dy,
                       const float* dh_last, float* dx, float* ddt,
                       float* dA_part, float* dB_part, float* dC_part,
                       float* dA, float* dB, float* dC, float* dh0, int B,
                       int S, int C, int N, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || B > 65535 || S < 1 || C < 1 || N < LANES || N > N_MAX ||
      N % LANES)
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{x, dt, A, Bm, Cm, hs, dy, dh_last, dx, ddt, dA_part,
                  dB_part, dC_part, dA, dB, dC, dh0, B, S, C, N};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N / LANES) {
    case 1: err = launch_bwd<1>(a, s); break;
    case 2: err = launch_bwd<2>(a, s); break;
    case 3: err = launch_bwd<3>(a, s); break;
    case 4: err = launch_bwd<4>(a, s); break;
    case 5: err = launch_bwd<5>(a, s); break;
    case 6: err = launch_bwd<6>(a, s); break;
    case 7: err = launch_bwd<7>(a, s); break;
    default: err = launch_bwd<8>(a, s);
  }
  return (int)err;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

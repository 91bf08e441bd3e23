// Mamba-1 selective scan on Hopper (sm_90a).
//
// Replaces no TPU kernel: JAX computes the scan as an associative_scan
// inside a lax.scan over chunks (repro/models/mamba.py::mamba1_mixer,
// chunk_body). Same arithmetic for each batch row b and channel c, in f32:
//   h_t = exp(dt_t * A[c]) ⊙ h_{t-1} + (dt_t * x_t) * B_t      (N,)
//   y_t = Σ_n h_t[n] * C_t[n]
// with x, dt (B, S, C), A (C, N), B and C (B, S, N), the state h0 and
// h_last (B, C, N), all contiguous. The D skip, the silu(z) gate and the
// projections stay in the caller, as in JAX.
//
// What bounds it: the bytes. x, dt and y are 4 B per (t, c), so a jamba
// prefill row of 2000 tokens at C 8192 moves ~197 MB (0.059 ms at 3.35
// TB/s); B and C are N floats per t and shared by every channel. The
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
// This is the first, simple kernel: one exp a state entry and step
// (expf, as the plain version), and no overlap of a tile's loads with the
// previous tile's steps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 8;                 // lanes of one channel
constexpr int CPB = 32;                  // channels of a block
constexpr int THREADS = LANES * CPB;     // 256
constexpr int TS = 32;                   // steps staged a tile
constexpr int N_MAX = 64;                // NPT up to 8

template <int NPT>
__global__ void __launch_bounds__(THREADS)
selective_scan_kernel(const float* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ h_last, int S, int C) {
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

  float a[NPT], h[NPT];
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    const int n = lane * NPT + i;
    a[i] = live ? A[(long long)c * N + n] : 0.f;
    h[i] = live ? h0[((long long)b * C + c) * N + n] : 0.f;
  }

  for (int t0 = 0; t0 < S; t0 += TS) {
    const int ts = min(TS, S - t0);
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
        h[i] = fmaf(expf(d * a[i]), h[i], u * sB[r][n]);
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

template <int NPT>
cudaError_t launch(const float* x, const float* dt, const float* A,
                   const float* Bm, const float* Cm, const float* h0,
                   float* y, float* h_last, int B, int S, int C,
                   cudaStream_t stream) {
  dim3 grid((C + CPB - 1) / CPB, B);
  selective_scan_kernel<NPT><<<grid, THREADS, 0, stream>>>(
      x, dt, A, Bm, Cm, h0, y, h_last, S, C);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, dt (B, S, C), A (C, N), Bm, Cm (B, S, N), h0 (B, C, N) → y (B, S, C),
// h_last (B, C, N); f32, contiguous. N a multiple of 8 up to 64. Returns the
// CUDA error of the launch.
int selective_scan(int device, const float* x, const float* dt,
                   const float* A, const float* Bm, const float* Cm,
                   const float* h0, float* y, float* h_last, int B, int S,
                   int C, int N, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || B > 65535 || S < 1 || C < 1 || N < LANES || N > N_MAX ||
      N % LANES)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N / LANES) {
    case 1: err = launch<1>(x, dt, A, Bm, Cm, h0, y, h_last, B, S, C, s); break;
    case 2: err = launch<2>(x, dt, A, Bm, Cm, h0, y, h_last, B, S, C, s); break;
    case 3: err = launch<3>(x, dt, A, Bm, Cm, h0, y, h_last, B, S, C, s); break;
    case 4: err = launch<4>(x, dt, A, Bm, Cm, h0, y, h_last, B, S, C, s); break;
    case 5: err = launch<5>(x, dt, A, Bm, Cm, h0, y, h_last, B, S, C, s); break;
    case 6: err = launch<6>(x, dt, A, Bm, Cm, h0, y, h_last, B, S, C, s); break;
    case 7: err = launch<7>(x, dt, A, Bm, Cm, h0, y, h_last, B, S, C, s); break;
    default: err = launch<8>(x, dt, A, Bm, Cm, h0, y, h_last, B, S, C, s);
  }
  return (int)err;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

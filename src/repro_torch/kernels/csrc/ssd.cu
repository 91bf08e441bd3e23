// Mamba-2 SSD intra-chunk on Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd/ssd.py::ssd_intra_chunk
// (_ssd_kernel). Same arithmetic for each (g, h) in f32:
//   L[t, s] = exp(cs[t] - cs[s]) for t >= s, 0 above the diagonal
//   y  = ((C B^T) ⊙ L) x                 (Q, P)
//   st = (B ⊙ exp(cs[Q-1] - cs))^T x     (N, P), the chunk-final state
// with x (Q, P), cs (Q), B and C (Q, N) of one chunk and head. The TPU
// contract's flat G is split into (g, h) = (chunk rows, heads), and every
// operand is read through its (g, h, t) strides: ssd_scan passes its
// (rows * chunks, Q, H, P) activations as they lie, and B and C, which all
// heads share, with stride 0 over h instead of H copies. The state is
// written through (g, h, n, p) strides, so the scan's (g, H, P, N) layout is
// stored directly: the (N, P) -> (P, N) transpose happens in this store.
//
// What the card asks for besides. The TPU kernel holds the whole (Q, Q)
// score matrix per grid cell (0.6 MiB at Q = 256); one f32 256 x 256 tile
// alone is over a block's 227 KiB. Here a block owns 64 rows t of y (one
// tile of the grid's y axis) and walks the key tiles s <= t, as a flash
// kernel walks keys: a 64 x 64 score tile over N in steps of 16, the decay
// mask applied by selection (exp is taken only where t >= s, where
// cs[t] - cs[s] <= 0: above the diagonal it may overflow, and inf * 0 would
// be NaN), then the tile's product with x. Key tiles above the diagonal are
// skipped. The state is a second kind of block on the same grid axis: 64
// rows n of st over all Q, B scaled by its decay to the chunk end. Any Q
// (exact-length prefill gives e.g. Q = 97), P and N; ragged tiles are masked.
//
// What bounds it: operations on f32 CUDA cores (67 TFLOP/s), 2 (N + P)
// Q (Q + 1) / 2 + 2 Q N P per (g, h); at mamba2-130m's Q = 256, P = 64,
// N = 128 that is 16.8 MFLOP, against about 0.17 MB of f32 traffic per head.
// Threads 16 x 16, each a 4 x 4 piece of a 64 x 64 tile. Not yet used: the
// tensor cores (a TF32 or split-bf16 product would loosen the f32 contract).

#include <cuda_runtime.h>

namespace {

constexpr int T = 64;          // rows t / keys s / state rows n per tile
constexpr int NK = 16;         // depth step through shared memory
constexpr int THREADS = 256;   // 16 x 16

struct Strides {
  long long g, h, t;
};

__global__ void __launch_bounds__(THREADS)
ssd_intra(const float* __restrict__ x, Strides sx,
          const float* __restrict__ cs, Strides scs,
          const float* __restrict__ B, Strides sb,
          const float* __restrict__ C, Strides sc, float* __restrict__ y,
          Strides sy, float* __restrict__ st, long long st_g, long long st_h,
          long long st_n, long long st_p, int H, int Q, int P, int N,
          int y_tiles) {
  __shared__ float At[NK][T + 4];   // y: C tile [n][t]; state: B·decay [s][n]
  __shared__ float Bt[NK][T + 4];   // y: B tile [n][s]; state: x [s][p]
  __shared__ float St[T][T + 4];    // masked scores [s][t]
  __shared__ float Xs[T][T + 4];    // x tile [s][p]
  __shared__ float cst[T], css[T], dec[NK];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int g = blockIdx.x / H, h = blockIdx.x % H;
  const int p0 = blockIdx.z * T;
  const float* xg = x + g * sx.g + h * sx.h;
  const float* csg = cs + g * scs.g + h * scs.h;
  const float* Bg = B + g * sb.g + h * sb.h;
  const float* Cg = C + g * sc.g + h * sc.h;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if ((int)blockIdx.y < y_tiles) {
    // ------------------------------------------------ y rows [t0, t0 + T)
    const int t0 = blockIdx.y * T;
    if (tid < T) cst[tid] = t0 + tid < Q ? csg[(t0 + tid) * scs.t] : 0.f;
    for (int s0 = 0; s0 <= t0; s0 += T) {
      if (tid < T) css[tid] = s0 + tid < Q ? csg[(s0 + tid) * scs.t] : 0.f;
      float sacc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sacc[i][j] = 0.f;
      for (int n0 = 0; n0 < N; n0 += NK) {
        for (int idx = tid; idx < T * NK; idx += THREADS) {
          const int r = idx / NK, c = idx % NK, n = n0 + c;
          At[c][r] = t0 + r < Q && n < N ? Cg[(t0 + r) * sc.t + n] : 0.f;
          Bt[c][r] = s0 + r < Q && n < N ? Bg[(s0 + r) * sb.t + n] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = At[k][ty + 16 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Bt[k][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              sacc[i][j] = fmaf(cv[i], bv[j], sacc[i][j]);
        }
        __syncthreads();
      }
      // decay mask by selection, stored transposed for the product with x
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int tl = ty + 16 * i, t = t0 + tl;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int sl = tx + 16 * j, s = s0 + sl;
          float v = 0.f;
          if (t < Q && s <= t) v = sacc[i][j] * expf(cst[tl] - css[sl]);
          St[sl][tl] = v;
        }
      }
      for (int idx = tid; idx < T * T; idx += THREADS) {
        const int r = idx / T, c = idx % T, s = s0 + r, p = p0 + c;
        Xs[r][c] = s < Q && p < P ? xg[s * sx.t + p] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int s = 0; s < T; ++s) {
        float sv[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) sv[i] = St[s][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = Xs[s][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(sv[i], xv[j], acc[i][j]);
      }
      __syncthreads();
    }
    float* yg = y + g * sy.g + h * sy.h;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + ty + 16 * i;
      if (t >= Q) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = p0 + tx + 16 * j;
        if (p < P) yg[t * sy.t + p] = acc[i][j];
      }
    }
    return;
  }

  // ------------------------------------------------- state rows [n0, n0 + T)
  const int n0 = (blockIdx.y - y_tiles) * T;
  const float cs_last = csg[(Q - 1) * scs.t];
  for (int s0 = 0; s0 < Q; s0 += NK) {
    if (tid < NK)
      dec[tid] = s0 + tid < Q ? expf(cs_last - csg[(s0 + tid) * scs.t]) : 0.f;
    __syncthreads();
    for (int idx = tid; idx < NK * T; idx += THREADS) {
      const int r = idx / T, c = idx % T, s = s0 + r;
      At[r][c] = s < Q && n0 + c < N ? Bg[s * sb.t + n0 + c] * dec[r] : 0.f;
      Bt[r][c] = s < Q && p0 + c < P ? xg[s * sx.t + p0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      float bv[4], xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) bv[i] = At[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) xv[j] = Bt[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(bv[i], xv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* stg = st + g * st_g + h * st_h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty + 16 * i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + tx + 16 * j;
      if (p < P) stg[n * st_n + p * st_p] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// x (G, H, Q, P), cs (G, H, Q), B and C (G, H, Q, N), y (G, H, Q, P), all
// f32 with a contiguous last dim and the other strides (elements) given in
// `strides`: x, cs, B, C, y as (g, h, t) each, then st (G, H, N, P) as
// (g, h, n, p): 19 values. Returns the CUDA error of the launch.
int ssd_intra_chunk(int device, const float* x, const float* cs,
                    const float* B, const float* C, float* y, float* st,
                    const long long* strides, int G, int H, int Q, int P,
                    int N, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (G < 1 || H < 1 || Q < 1 || P < 1 || N < 1 ||
      (long long)G * H > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const long long* s = strides;
  const Strides sx{s[0], s[1], s[2]}, scs{s[3], s[4], s[5]},
      sb{s[6], s[7], s[8]}, sc{s[9], s[10], s[11]}, sy{s[12], s[13], s[14]};
  const int y_tiles = (Q + T - 1) / T, n_tiles = (N + T - 1) / T;
  dim3 grid(G * H, y_tiles + n_tiles, (P + T - 1) / T);
  ssd_intra<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, sx, cs, scs, B, sb, C, sc, y, sy, st, s[15], s[16], s[17], s[18], H,
      Q, P, N, y_tiles);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

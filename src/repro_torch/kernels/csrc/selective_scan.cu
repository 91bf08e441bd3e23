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
// What bounds both kernels on an H100. Per (t, c, n) each takes one exp,
// which runs on the special-function units: 16 a clock an SM, 3.7-4.2 G a
// millisecond at 1.755-1.98 GHz. A jamba prefill row (S 2000, C 8192,
// N 16) holds 262 M of them, 0.063-0.071 ms, beside its ~197 MB of x, dt
// and y (0.059 ms at 3.35 TB/s). The f32 operations around the exp (~4 an
// entry) are a third of that on the CUDA cores, but every instruction
// issues from the same four schedulers an SM, and the shared-memory
// traffic of a channel's inputs and of the channel sums goes through one
// pipe an SM. The design (tools/scan_probe.py measured the choices):
// - exp(dt A) is one ex2.approx of dt * (A log2 e): one MUFU op and one
//   multiply, where expf's range handling cost ~8 instructions. The
//   backward's recompute uses the same code on the same operands, so its
//   states are the forward's bits.
// - Forward: a channel's N state entries are split over flanes(N) lanes,
//   2 up to N 32 and 4 above (8 entries a lane at N 16, B and C read as
//   two 16-byte shared loads each), 64 (or 32) channels a block; y_t is
//   the sum of the lanes' partials by xor shuffles. Fewer lanes a channel
//   issue fewer loads and shuffles an entry: at N 16, 2 lanes against 4
//   took 0.76 against 0.99 ms for 8 rows of jamba's prefill and 0.18
//   against 0.17 for one. The state stays in registers for the whole walk
//   over t, in order: nothing but x, dt, y, B and C (and, in training,
//   the checkpoints) touches memory. Steps go in groups of FQ: the
//   group's exps and inputs first, then its states in order, then its y
//   sums, so a lane's exps, loads and shuffles overlap instead of waiting
//   on the state's chain of FMAs (one row of jamba's prefill at 4 lanes:
//   0.2349 ms step by step, 0.1737 grouped).
// - The inputs come in by 16-byte cp.async (4-byte where C is not a
//   multiple of 4) into a ring of FSTAGES tiles of TS steps, three tiles'
//   loads in flight while a block walks one. The tile's y goes out from
//   shared memory in 16-byte rows one tile later.
// The first kernel (8 lanes a channel, expf, plain loads staged between two
// barriers) took 50 instructions a step a lane for 2 entries, and its
// plain loads alone 0.25 ms of its 0.41.
//
// Training. The forward instance with SAVE also writes the state entering
// each tile of TS steps, hs (B, ceil(S / TS), C, N): the backward's
// checkpoints. Serving runs the instances compiled without that store.
//
// Backward (selective_scan_bwd_kernel). With g_t = dL/dh_t, walked from the
// last step to the first from g = dh_last:
//   g_t = C_t dy_t + a_{t+1} g_{t+1},   a_t = exp(dt_t A)
//   dx_t = dt_t Σ_n B_t g_t,   ddt_t = x_t Σ_n B_t g_t + Σ_n A a_t h_{t-1} g_t
//   dA = Σ_{b,t} dt_t a_t h_{t-1} g_t,   dh0 = a_0 g_0
//   dB_t = Σ_c dt_t x_t g_t,   dC_t = Σ_c h_t dy_t   (sums over channels)
// The states are never recovered by dividing by a_t (it underflows): each
// checkpoint interval, last to first, recomputes its states from the saved
// one by the forward's code, keeping every state and every decay in
// registers (a sub-tile of SUB steps: the whole interval up to N 16), then
// walks its steps in reverse with those decays: one exp a (t, c, n). Above
// N 16 a sub-tile's entering state is recomputed from the interval's saved
// one, which costs more exps (up to 3.5 intervals' more at N 64). Layout:
// a lane holds N / BLANES entries of two neighbouring channels (BLANES = 8
// lanes a pair, 64 channels a block), so the sums over channels start in
// registers: each lane adds its pair's terms of dB and dC before writing
// them to shared memory (one store each), and at the start of the next
// sub-tile the block adds its 32 pairs in a fixed order (16-byte shared
// loads, each sum split over two lanes and joined by one shuffle) into one
// partial per 64 channels, one barrier a sub-tile. dx and ddt are sums
// over a pair's 8 lanes, by halving: three shuffle rounds leave each lane
// one of the four sums. The next sub-tile's decays are taken during this
// one's reverse walk, into the registers its steps free, so the exps
// overlap the walk's arithmetic instead of stalling a phase of their own;
// the inputs (x, dt, dy, B, C and the saved states) come in by cp.async
// two intervals ahead. dA stays in registers. A second launch
// (sum_parts_kernel) adds the partials, and dA over the batch, in a fixed
// order: no atomics, so two calls give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int NMUL = 8;                  // N is a multiple of this
constexpr int N_MAX = 64;                // the widest state
constexpr int TS = 16;                   // steps of a tile: a checkpoint interval

// forward
constexpr int FTHREADS = 128;
constexpr int FSTAGES = 4;               // tiles in the cp.async ring

// the forward's lanes of one channel (N / flanes(N) entries each) and its
// channels of a block
__host__ __device__ constexpr int flanes(int N) { return N <= 32 ? 2 : 4; }
__host__ __device__ constexpr int fcpb(int N) { return FTHREADS / flanes(N); }

// backward
constexpr int BLANES = 8;                // lanes of a pair of channels
constexpr int BTHREADS = 256;
constexpr int BCPB = 2 * BTHREADS / BLANES;   // channels of a block (one partial)
constexpr int BBUF = 3;                  // intervals' inputs in shared memory

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// bytes of dynamic shared memory: the forward's ring and y tiles
__host__ __device__ constexpr int fwd_smem_bytes(int N) {
  return 4 * (FSTAGES * (2 * TS * fcpb(N) + 2 * TS * N) + 2 * TS * fcpb(N));
}

// Steps of a sub-tile whose states and decays a backward lane holding
// ``entries`` state entries keeps in registers ((2 SUB + 1) entries
// floats): the whole interval up to 4 entries (N 16), half of it up to 6,
// a quarter up to 10, an eighth above.
__host__ __device__ constexpr int sub_steps(int entries) {
  return entries <= 4 ? TS : entries <= 6 ? TS / 2 : entries <= 10 ? TS / 4
                                                                   : TS / 8;
}

// floats of one backward input buffer: x, dt, dy (TS, BCPB), B, C (TS, N)
// and the interval's saved states (BCPB, N)
__host__ __device__ constexpr int bwd_in_floats(int N) {
  return 3 * TS * BCPB + 2 * TS * N + BCPB * N;
}

// bytes of the backward's dynamic shared memory: BBUF input buffers, two
// of an interval's dx and ddt, and two of a sub-tile's dB and dC terms (a
// pair of channels a row)
__host__ __device__ constexpr int bwd_smem_bytes(int N) {
  return 4 * (BBUF * bwd_in_floats(N) + 4 * TS * BCPB +
              2 * sub_steps(2 * N / BLANES) * BCPB * N);
}

constexpr bool fits_every_n() {
  for (int n = NMUL; n <= N_MAX; n += NMUL)
    if (fwd_smem_bytes(n) > 232448 || bwd_smem_bytes(n) > 232448)
      return false;
  return true;
}
static_assert(fits_every_n(), "a block may use 227 KB of shared memory");
static_assert(flanes(16) == 2, "forward lanes a channel, N 16");
static_assert(flanes(64) == 4, "forward lanes a channel, N 64");
static_assert(fwd_smem_bytes(16) == 49152, "forward, N 16");
static_assert(fwd_smem_bytes(64) == 53248, "forward, N 64");
static_assert(bwd_smem_bytes(16) == 202752, "backward, N 16");
static_assert(bwd_smem_bytes(64) == 192512, "backward, N 64");

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// the decay exp(dt A) from dt and A log2 e, a step's input (dt x) B, and
// one step of a state entry: the forward and the backward's recompute
// share all three, so both round alike
__device__ __forceinline__ float decay(float d, float a2) {
  return ex2(__fmul_rn(d, a2));
}

__device__ __forceinline__ float input(float u, float b) {
  return __fmul_rn(u, b);
}

__device__ __forceinline__ float step(float h, float e, float ub) {
  return fmaf(e, h, ub);
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// K consecutive floats between registers and memory, 16 bytes at a time
// where K allows (p aligned to the widest access K allows)
template <int K>
__device__ __forceinline__ void load_k(float (&v)[K], const float* p) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int j = 0; j < K; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + j);
      v[j] = q.x, v[j + 1] = q.y, v[j + 2] = q.z, v[j + 3] = q.w;
    }
  } else if constexpr (K % 2 == 0) {
#pragma unroll
    for (int j = 0; j < K; j += 2) {
      const float2 q = *reinterpret_cast<const float2*>(p + j);
      v[j] = q.x, v[j + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) v[j] = p[j];
  }
}

template <int K>
__device__ __forceinline__ void store_k(float* p, const float (&v)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int j = 0; j < K; j += 4)
      *reinterpret_cast<float4*>(p + j) =
          make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  } else if constexpr (K % 2 == 0) {
#pragma unroll
    for (int j = 0; j < K; j += 2)
      *reinterpret_cast<float2*>(p + j) = make_float2(v[j], v[j + 1]);
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) p[j] = v[j];
  }
}

// Rows [t0, t0 + T) of a row-major (S, ld) array, columns [c0, c0 + W),
// into dst (T, W) by NT threads' cp.async; zeros past S or ld. 16-byte
// copies with vec (ld and c0 multiples of 4), else 4-byte ones.
template <int T, int W, int NT>
__device__ __forceinline__ void stage(float* dst, const float* src, int t0,
                                      int S, int c0, int ld, bool vec,
                                      int tid) {
  if (vec) {
    constexpr int Q = W / 4;
#pragma unroll
    for (int j = 0; j < (T * Q + NT - 1) / NT; ++j) {
      const int i = tid + j * NT, r = i / Q, k = 4 * (i % Q);
      const bool ok = t0 + r < S && c0 + k < ld;
      if (i >= T * Q) break;
      cp_async16(dst + r * W + k,
                 ok ? src + (long long)(t0 + r) * ld + c0 + k : src, ok);
    }
  } else {
#pragma unroll
    for (int j = 0; j < (T * W + NT - 1) / NT; ++j) {
      const int i = tid + j * NT, r = i / W, k = i % W;
      const bool ok = t0 + r < S && c0 + k < ld;
      if (i >= T * W) break;
      cp_async4(dst + r * W + k,
                ok ? src + (long long)(t0 + r) * ld + c0 + k : src, ok);
    }
  }
}

// Rows [t0, t0 + TS) of a tile (TS, W) in shared memory to columns
// [c0, c0 + W) of a row-major (S, ld) array, rows before S and columns
// before ld; 16-byte stores with vec.
template <int W, int NT>
__device__ __forceinline__ void unstage(float* dst, const float* src,
                                        int t0, int S, int c0, int ld,
                                        bool vec, int tid) {
  if (vec) {
    constexpr int Q = W / 4;
#pragma unroll
    for (int j = 0; j < (TS * Q + NT - 1) / NT; ++j) {
      const int i = tid + j * NT, r = i / Q, k = 4 * (i % Q);
      if (i < TS * Q && t0 + r < S && c0 + k < ld)
        *reinterpret_cast<float4*>(dst + (long long)(t0 + r) * ld + c0 + k) =
            *reinterpret_cast<const float4*>(src + r * W + k);
    }
  } else {
#pragma unroll
    for (int j = 0; j < (TS * W + NT - 1) / NT; ++j) {
      const int i = tid + j * NT, r = i / W, k = i % W;
      if (i < TS * W && t0 + r < S && c0 + k < ld)
        dst[(long long)(t0 + r) * ld + c0 + k] = src[r * W + k];
    }
  }
}

// Slot k % FSTAGES of the forward's ring: rows [k TS, k TS + TS) of x and
// dt at the block's channels, and of B and C
template <int N>
__device__ __forceinline__ void fwd_load(float* smem, int k, const float* xb,
                                         const float* dtb, const float* Bb,
                                         const float* Cb, int S, int c0,
                                         int C, bool vec, int tid) {
  constexpr int FCPB = fcpb(N), STAGE = 2 * TS * FCPB + 2 * TS * N;
  float* s = smem + (k % FSTAGES) * STAGE;
  stage<TS, FCPB, FTHREADS>(s, xb, k * TS, S, c0, C, vec, tid);
  stage<TS, FCPB, FTHREADS>(s + TS * FCPB, dtb, k * TS, S, c0, C, vec, tid);
  stage<TS, N, FTHREADS>(s + 2 * TS * FCPB, Bb, k * TS, S, 0, N, true, tid);
  stage<TS, N, FTHREADS>(s + 2 * TS * FCPB + TS * N, Cb, k * TS, S, 0, N,
                         true, tid);
}

// SAVE: also write the state entering each tile to hs (training); serving's
// instances (SAVE false) compile without it
template <int N, bool SAVE>
__global__ void __launch_bounds__(FTHREADS)
selective_scan_kernel(const float* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ h_last, float* __restrict__ hs,
                      int S, int C, int vec) {
  constexpr int FLANES = flanes(N), FCPB = fcpb(N), NPT = N / FLANES;
  constexpr int STAGE = 2 * TS * FCPB + 2 * TS * N;   // floats of a tile
  // steps taken a group: the group's decays and inputs first (independent
  // of the state, so their exps and loads overlap), then its states in
  // order, then its y sums
  constexpr int FQ = NPT <= 4 ? 8 : NPT <= 8 ? 4 : NPT <= 12 ? 2 : 1;
  extern __shared__ __align__(16) float smem[];
  float* sy = smem + FSTAGES * STAGE;                 // (2, TS, FCPB)

  const int b = blockIdx.y, c0 = blockIdx.x * FCPB, tid = threadIdx.x;
  const int ch = tid / FLANES, lane = tid % FLANES, c = c0 + ch;
  const bool live = c < C;
  const int K = (S + TS - 1) / TS;
  const float* xb = x + (long long)b * S * C;
  const float* dtb = dt + (long long)b * S * C;
  const float* Bb = Bm + (long long)b * S * N;
  const float* Cb = Cm + (long long)b * S * N;
  float* yb = y + (long long)b * S * C;
  const long long st = ((long long)b * C + c) * N + lane * NPT;

  float a2[NPT] = {}, h[NPT] = {};
  if (live) {
    load_k(a2, A + (long long)c * N + lane * NPT);
    load_k(h, h0 + st);
  }
#pragma unroll
  for (int i = 0; i < NPT; ++i) a2[i] *= LOG2E;

#pragma unroll
  for (int k = 0; k < FSTAGES - 1; ++k) {
    if (k < K) fwd_load<N>(smem, k, xb, dtb, Bb, Cb, S, c0, C, vec, tid);
    cp_async_commit();
  }
  for (int k = 0; k < K; ++k) {
    cp_async_wait<FSTAGES - 2>();   // tile k landed (this thread's copies)
    __syncthreads();                // everyone's; tile k - 1's slot is free
    if (k > 0)
      unstage<FCPB, FTHREADS>(yb, sy + ((k - 1) & 1) * TS * FCPB,
                              (k - 1) * TS, S, c0, C, vec, tid);
    if (k + FSTAGES - 1 < K)
      fwd_load<N>(smem, k + FSTAGES - 1, xb, dtb, Bb, Cb, S, c0, C, vec,
                  tid);
    cp_async_commit();
    if (SAVE && live)
      store_k(hs + (((long long)b * K + k) * C + c) * N + lane * NPT, h);
    // Steps past S have x = dt = 0 and B = C = 0 staged: a decay of
    // exp2(0) = 1 and an input of 0, exact no-op steps.
    const float* s = smem + (k % FSTAGES) * STAGE;
    const float* sx = s + ch;
    const float* sdt = s + TS * FCPB + ch;
    const float* sB = s + 2 * TS * FCPB + lane * NPT;
    const float* sC = sB + TS * N;
    float* syk = sy + (k & 1) * TS * FCPB + ch;
#pragma unroll
    for (int r0 = 0; r0 < TS; r0 += FQ) {
      float e[FQ][NPT], ub[FQ][NPT], v[FQ];
#pragma unroll
      for (int r = 0; r < FQ; ++r) {
        const float d = sdt[(r0 + r) * FCPB];
        const float u = __fmul_rn(d, sx[(r0 + r) * FCPB]);
        float bv[NPT];
        load_k(bv, sB + (r0 + r) * N);
#pragma unroll
        for (int i = 0; i < NPT; ++i) {
          e[r][i] = decay(d, a2[i]);
          ub[r][i] = input(u, bv[i]);
        }
      }
#pragma unroll
      for (int r = 0; r < FQ; ++r) {
        float cv[NPT];
        load_k(cv, sC + (r0 + r) * N);
        v[r] = 0.f;
#pragma unroll
        for (int i = 0; i < NPT; ++i) {
          h[i] = step(h[i], e[r][i], ub[r][i]);
          v[r] = fmaf(h[i], cv[i], v[r]);
        }
      }
#pragma unroll
      for (int o = FLANES / 2; o > 0; o >>= 1)
#pragma unroll
        for (int r = 0; r < FQ; ++r)
          v[r] += __shfl_xor_sync(0xffffffffu, v[r], o);
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < FQ; ++r) syk[(r0 + r) * FCPB] = v[r];
      }
    }
    // tile k's y tile (sy[k & 1]) goes out after the next barrier; the
    // tile after it writes sy[k & 1] only after one more
  }
  __syncthreads();
  unstage<FCPB, FTHREADS>(yb, sy + ((K - 1) & 1) * TS * FCPB, (K - 1) * TS,
                          S, c0, C, vec, tid);
  if (live) store_k(h_last + st, h);
}

// Buffer k % BBUF of the backward: rows [k TS, k TS + TS) of x, dt and dy
// at the block's channels and of B and C, and the block's rows of hs[b, k]
template <int N>
__device__ __forceinline__ void bwd_load(float* smem, int k, const float* xb,
                                         const float* dtb, const float* dyb,
                                         const float* Bb, const float* Cb,
                                         const float* hsb, int S, int c0,
                                         int C, bool vec, int tid) {
  float* s = smem + (k % BBUF) * bwd_in_floats(N);
  stage<TS, BCPB, BTHREADS>(s, xb, k * TS, S, c0, C, vec, tid);
  stage<TS, BCPB, BTHREADS>(s + TS * BCPB, dtb, k * TS, S, c0, C, vec, tid);
  stage<TS, BCPB, BTHREADS>(s + 2 * TS * BCPB, dyb, k * TS, S, c0, C, vec,
                            tid);
  stage<TS, N, BTHREADS>(s + 3 * TS * BCPB, Bb, k * TS, S, 0, N, true, tid);
  stage<TS, N, BTHREADS>(s + 3 * TS * BCPB + TS * N, Cb, k * TS, S, 0, N,
                         true, tid);
  stage<BCPB, N, BTHREADS>(s + 3 * TS * BCPB + 2 * TS * N,
                           hsb + (long long)k * C * N, c0, C, 0, N, true,
                           tid);
}

// dB's and dC's terms of a backward sub-tile of SUB steps from its first
// step t0, summed over the block's pairs of channels (red: (2, SUB, PAIRS,
// N)) into the block's partial rows: a pair of lanes a (term, step, quad),
// the even and the odd pairs in order, joined by one shuffle
template <int N, int SUB>
__device__ __forceinline__ void bwd_sums(const float* red, float* dBp,
                                         float* dCp, int t0, int S,
                                         int tid) {
  constexpr int PAIRS = BCPB / 2, NQ = N / 4, SUMS = 2 * SUB * NQ;
#pragma unroll
  for (int base = 0; base < 2 * SUMS; base += BTHREADS) {
    const int o = base + tid, m = o >> 1, half = o & 1;
    const bool on = m < SUMS;
    const int qty = m / (SUB * NQ), q = (m / NQ) % SUB, nq = m % NQ;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    if (on) {
      const float* p = red + ((qty * SUB + q) * PAIRS + half) * N + 4 * nq;
#pragma unroll 8
      for (int cc = 0; cc < PAIRS / 2; ++cc) {
        const float4 v = *reinterpret_cast<const float4*>(p + 2 * cc * N);
        sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
      }
    }
    sum.x += __shfl_xor_sync(0xffffffffu, sum.x, 1);
    sum.y += __shfl_xor_sync(0xffffffffu, sum.y, 1);
    sum.z += __shfl_xor_sync(0xffffffffu, sum.z, 1);
    sum.w += __shfl_xor_sync(0xffffffffu, sum.w, 1);
    const int t = t0 + q;
    if (on && half == 0 && t < S)
      *reinterpret_cast<float4*>((qty ? dCp : dBp) + (long long)t * N +
                                 4 * nq) = sum;
  }
}

// Each lane holds NPT entries of two neighbouring channels (BLANES lanes a
// pair), so dB's and dC's terms are summed over the pair in registers
// before they reach shared memory. Launch bounds: one block an SM (its
// registers), up to 255 registers.
template <int N>
__global__ void __launch_bounds__(BTHREADS, 1)
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
                          float* __restrict__ dh0, int S, int C, int vec) {
  constexpr int NPT = N / BLANES;            // entries of each channel
  constexpr int SUB = sub_steps(2 * NPT);
  constexpr int NSUB = TS / SUB;
  constexpr int IN = bwd_in_floats(N);
  constexpr int PAIRS = BCPB / 2;
  constexpr int RED = 2 * SUB * PAIRS * N;   // floats of a sred buffer
  extern __shared__ __align__(16) float smem[];
  float* sdx = smem + BBUF * IN;             // (2, TS, BCPB)
  float* sddt = sdx + 2 * TS * BCPB;         // (2, TS, BCPB)
  float* sred = sddt + 2 * TS * BCPB;        // (2, 2, SUB, PAIRS, N)

  const int b = blockIdx.y, cb = blockIdx.x, c0 = cb * BCPB;
  const int tid = threadIdx.x;
  const int pair = tid / BLANES, lane = tid % BLANES, cp = c0 + 2 * pair;
  const bool live[2] = {cp < C, cp + 1 < C};
  const int K = (S + TS - 1) / TS;
  const long long row = (long long)b * S * C;
  const float* Bb = Bm + (long long)b * S * N;
  const float* Cb = Cm + (long long)b * S * N;
  const float* hsb = hs + (long long)b * K * C * N;
  const long long part = ((long long)b * gridDim.x + cb) * S * N;
  // this lane's entries of channel cp + m in a (B, C, N) array
  const long long st = ((long long)b * C + cp) * N + lane * NPT;

  float a2[2][NPT] = {}, g[2][NPT] = {}, da[2][NPT] = {};
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    if (live[m]) {
      load_k(a2[m], A + (long long)(cp + m) * N + lane * NPT);
      if (dh_last != nullptr) load_k(g[m], dh_last + st + m * N);
    }
#pragma unroll
    for (int i = 0; i < NPT; ++i) a2[m][i] *= LOG2E;
  }

  // Sub-tiles are walked last to first over the whole row; sub-tile u
  // writes its dB and dC terms to sred buffer u & 1, and the block sums
  // them at the start of sub-tile u + 1, behind the one barrier a
  // sub-tile takes.
  // The decays of the next sub-tile are taken during this one's
  // reverse walk, each into the register its step just freed, so the exps
  // overlap the walk's arithmetic: the inputs are loaded two intervals
  // ahead. dx and ddt of an interval go out at the start of the next one.
  bwd_load<N>(smem, K - 1, x + row, dt + row, dy + row, Bb, Cb, hsb, S, c0,
              C, vec, tid);
  if (K > 1)
    bwd_load<N>(smem, K - 2, x + row, dt + row, dy + row, Bb, Cb, hsb, S,
                c0, C, vec, tid);
  cp_async_commit();
  // e[q] = the decays of step q of the sub-tile being walked
  float e[SUB][2][NPT];
  int u = 0, prev = 0;            // sub-tiles walked, the last one's first step
  for (int k = K - 1; k >= 0; --k) {
    const int t0 = k * TS;
    cp_async_wait<0>();           // intervals k and k - 1 landed (this
    __syncthreads();              // thread's copies; everyone's), k + 1 walked
    if (k > 1) {                  // into buffer (k + 1) % BBUF, free since now
      bwd_load<N>(smem, k - 2, x + row, dt + row, dy + row, Bb, Cb, hsb, S,
                  c0, C, vec, tid);
      cp_async_commit();
    }
    if (k + 1 < K) {
      unstage<BCPB, BTHREADS>(dx + row, sdx + ((k + 1) & 1) * TS * BCPB,
                              t0 + TS, S, c0, C, vec, tid);
      unstage<BCPB, BTHREADS>(ddt + row, sddt + ((k + 1) & 1) * TS * BCPB,
                              t0 + TS, S, c0, C, vec, tid);
    }
    // Steps past S have x = dt = dy = 0 and B = C = 0 staged: exact no-op
    // steps in both walks, whose dx, ddt, dB and dC are never stored.
    const float* s = smem + (k % BBUF) * IN;
    const float* sx = s + 2 * pair;
    const float* sdt = s + TS * BCPB + 2 * pair;
    const float* sdy = s + 2 * TS * BCPB + 2 * pair;
    const float* sB = s + 3 * TS * BCPB + lane * NPT;
    const float* sC = sB + TS * N;
    const float* shs = s + 3 * TS * BCPB + 2 * TS * N + 2 * pair * N +
                       lane * NPT;
    // dt of the interval walked next (interval 0: this one, unused)
    const float* sdt_next =
        smem + ((k > 0 ? k - 1 : k) % BBUF) * IN + TS * BCPB + 2 * pair;
    float* sdxk = sdx + (k & 1) * TS * BCPB;
    float* sddtk = sddt + (k & 1) * TS * BCPB;
    if (k == K - 1) {             // the first sub-tile's decays
#pragma unroll
      for (int q = 0; q < SUB; ++q) {
        const float2 d = load2(sdt + ((NSUB - 1) * SUB + q) * BCPB);
#pragma unroll
        for (int i = 0; i < NPT; ++i) {
          e[q][0][i] = decay(d.x, a2[0][i]);
          e[q][1][i] = decay(d.y, a2[1][i]);
        }
      }
    }
#pragma unroll
    for (int j = NSUB - 1; j >= 0; --j) {
      if (j < NSUB - 1) __syncthreads();   // sub-tile j + 1 walked
      if (u > 0)
        bwd_sums<N, SUB>(sred + ((u - 1) & 1) * RED, dB_part + part,
                         dC_part + part, prev, S, tid);
      float* red = sred + (u & 1) * RED;
      // dt rows of the sub-tile walked next: j - 1 of this interval, or
      // the last of the next interval
      const float* dnext = j > 0 ? sdt + (j - 1) * SUB * BCPB
                                 : sdt_next + (NSUB - 1) * SUB * BCPB;
      // hst[q] = the states after step j SUB + q - 1
      float hst[SUB + 1][2][NPT];
      load_k(hst[0][0], shs);
      load_k(hst[0][1], shs + N);
#pragma unroll 1
      for (int r = 0; r < j * SUB; ++r) {
        const float2 d = load2(sdt + r * BCPB), xv = load2(sx + r * BCPB);
        const float u0 = __fmul_rn(d.x, xv.x), u1 = __fmul_rn(d.y, xv.y);
        float bv[NPT];
        load_k(bv, sB + r * N);
#pragma unroll
        for (int i = 0; i < NPT; ++i) {
          hst[0][0][i] = step(hst[0][0][i], decay(d.x, a2[0][i]),
                              input(u0, bv[i]));
          hst[0][1][i] = step(hst[0][1][i], decay(d.y, a2[1][i]),
                              input(u1, bv[i]));
        }
      }
      // the states in order, from the decays taken before
#pragma unroll
      for (int q = 0; q < SUB; ++q) {
        const int r = j * SUB + q;
        const float2 d = load2(sdt + r * BCPB), xv = load2(sx + r * BCPB);
        const float u0 = __fmul_rn(d.x, xv.x), u1 = __fmul_rn(d.y, xv.y);
        float bv[NPT];
        load_k(bv, sB + r * N);
#pragma unroll
        for (int i = 0; i < NPT; ++i) {
          hst[q + 1][0][i] = step(hst[q][0][i], e[q][0][i], input(u0, bv[i]));
          hst[q + 1][1][i] = step(hst[q][1][i], e[q][1][i], input(u1, bv[i]));
        }
      }
#pragma unroll
      for (int q = SUB - 1; q >= 0; --q) {
        const int r = j * SUB + q;
        const float2 d = load2(sdt + r * BCPB), xv = load2(sx + r * BCPB);
        const float2 dyv = load2(sdy + r * BCPB);
        const float u0 = __fmul_rn(d.x, xv.x), u1 = __fmul_rn(d.y, xv.y);
        float bv[NPT], cv[NPT], vb[NPT], vc[NPT];
        load_k(bv, sB + r * N);
        load_k(cv, sC + r * N);
        float sb0 = 0.f, sb1 = 0.f, sa0 = 0.f, sa1 = 0.f;
#pragma unroll
        for (int i = 0; i < NPT; ++i) {
          g[0][i] = fmaf(cv[i], dyv.x, g[0][i]);      // dL/dh_r
          g[1][i] = fmaf(cv[i], dyv.y, g[1][i]);
          // the pair's terms of dC and dB
          vc[i] = fmaf(hst[q + 1][1][i], dyv.y,
                       __fmul_rn(hst[q + 1][0][i], dyv.x));
          vb[i] = fmaf(u1, g[1][i], __fmul_rn(u0, g[0][i]));
          sb0 = fmaf(bv[i], g[0][i], sb0);
          sb1 = fmaf(bv[i], g[1][i], sb1);
          const float w0 = __fmul_rn(__fmul_rn(e[q][0][i], hst[q][0][i]),
                                     g[0][i]);
          const float w1 = __fmul_rn(__fmul_rn(e[q][1][i], hst[q][1][i]),
                                     g[1][i]);
          da[0][i] = fmaf(d.x, w0, da[0][i]);
          da[1][i] = fmaf(d.y, w1, da[1][i]);
          sa0 = fmaf(a2[0][i], w0, sa0);              // Σ A w / ln 2
          sa1 = fmaf(a2[1][i], w1, sa1);
          g[0][i] = __fmul_rn(g[0][i], e[q][0][i]);   // into dL/dh_{r-1}
          g[1][i] = __fmul_rn(g[1][i], e[q][1][i]);
        }
        // step q of the next sub-tile: its decays into e[q], now free
        const float2 dn = load2(dnext + q * BCPB);
#pragma unroll
        for (int i = 0; i < NPT; ++i) {
          e[q][0][i] = decay(dn.x, a2[0][i]);
          e[q][1][i] = decay(dn.y, a2[1][i]);
        }
        // this lane's shares of dx and ddt of both channels, summed over
        // the pair's lanes by halving: lane l keeps value 2 (l & 4) / 4 +
        // (l & 2) / 2 of (dx0, ddt0, dx1, ddt1)
        const float v0 = __fmul_rn(d.x, sb0), v1 = fmaf(xv.x, sb0, sa0 * LN2);
        const float v2 = __fmul_rn(d.y, sb1), v3 = fmaf(xv.y, sb1, sa1 * LN2);
        const bool hi4 = lane & 4, hi2 = lane & 2;
        float k0 = hi4 ? v2 : v0, k1 = hi4 ? v3 : v1;
        k0 += __shfl_xor_sync(0xffffffffu, hi4 ? v0 : v2, 4);
        k1 += __shfl_xor_sync(0xffffffffu, hi4 ? v1 : v3, 4);
        float kk = hi2 ? k1 : k0;
        kk += __shfl_xor_sync(0xffffffffu, hi2 ? k0 : k1, 2);
        kk += __shfl_xor_sync(0xffffffffu, kk, 1);
        if (!(lane & 1))
          (hi2 ? sddtk : sdxk)[r * BCPB + 2 * pair + (hi4 ? 1 : 0)] = kk;
        store_k(red + (q * PAIRS + pair) * N + lane * NPT, vb);
        store_k(red + ((SUB + q) * PAIRS + pair) * N + lane * NPT, vc);
      }
      prev = t0 + j * SUB;
      ++u;
    }
  }
  __syncthreads();
  bwd_sums<N, SUB>(sred + ((u - 1) & 1) * RED, dB_part + part,
                   dC_part + part, prev, S, tid);
  unstage<BCPB, BTHREADS>(dx + row, sdx, 0, S, c0, C, vec, tid);
  unstage<BCPB, BTHREADS>(ddt + row, sddt, 0, S, c0, C, vec, tid);
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    if (live[m]) {
      store_k(dh0 + st + m * N, g[m]);
      store_k(dA_part + st + m * N, da[m]);
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

// Raise a kernel's dynamic shared memory limit once (above the default
// 48 KB only): not on every call, so that a call inside a CUDA graph
// capture makes no such request.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done || bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = err == cudaSuccess;
  return err;
}

template <int N>
cudaError_t launch(const float* x, const float* dt, const float* A,
                   const float* Bm, const float* Cm, const float* h0,
                   float* y, float* h_last, float* hs, int B, int S, int C,
                   cudaStream_t stream) {
  static bool ready[2] = {false, false};
  const int smem = fwd_smem_bytes(N);
  const dim3 grid((C + fcpb(N) - 1) / fcpb(N), B);
  const int vec = C % 4 == 0;
  auto kernel = hs != nullptr ? selective_scan_kernel<N, true>
                              : selective_scan_kernel<N, false>;
  const cudaError_t err = allow_smem(kernel, smem, ready[hs != nullptr]);
  if (err != cudaSuccess) return err;
  kernel<<<grid, FTHREADS, smem, stream>>>(x, dt, A, Bm, Cm, h0, y, h_last,
                                           hs, S, C, vec);
  return cudaGetLastError();
}

struct BwdArgs {
  const float *x, *dt, *A, *Bm, *Cm, *hs, *dy, *dh_last;
  float *dx, *ddt, *dA_part, *dB_part, *dC_part, *dA, *dB, *dC, *dh0;
  int B, S, C, N;
};

template <int N>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  static bool ready = false;
  const int ncb = (a.C + BCPB - 1) / BCPB;
  const int smem = bwd_smem_bytes(N);
  cudaError_t err = allow_smem(selective_scan_bwd_kernel<N>, smem, ready);
  if (err != cudaSuccess) return err;
  selective_scan_bwd_kernel<N><<<dim3(ncb, a.B), BTHREADS, smem, stream>>>(
      a.x, a.dt, a.A, a.Bm, a.Cm, a.hs, a.dy, a.dh_last, a.dx, a.ddt,
      a.dA_part, a.dB_part, a.dC_part, a.dh0, a.S, a.C, a.C % 4 == 0);
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

bool bad_shape(int B, int S, int C, int N) {
  return B < 1 || B > 65535 || S < 1 || C < 1 || N < NMUL || N > N_MAX ||
         N % NMUL;
}

}  // namespace

extern "C" {

// x, dt (B, S, C), A (C, N), Bm, Cm (B, S, N), h0 (B, C, N) → y (B, S, C),
// h_last (B, C, N), and with hs non-null the state entering each tile of 16
// steps, hs (B, ceil(S / 16), C, N); f32, contiguous, every pointer 16-byte
// aligned. N a multiple of 8 up to 64. Returns the CUDA error of the
// launch.
int selective_scan(int device, const float* x, const float* dt,
                   const float* A, const float* Bm, const float* Cm,
                   const float* h0, float* y, float* h_last, float* hs,
                   int B, int S, int C, int N, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(B, S, C, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N / NMUL) {
    case 1: err = launch<8>(x, dt, A, Bm, Cm, h0, y, h_last, hs, B, S, C, s); break;
    case 2: err = launch<16>(x, dt, A, Bm, Cm, h0, y, h_last, hs, B, S, C, s); break;
    case 3: err = launch<24>(x, dt, A, Bm, Cm, h0, y, h_last, hs, B, S, C, s); break;
    case 4: err = launch<32>(x, dt, A, Bm, Cm, h0, y, h_last, hs, B, S, C, s); break;
    case 5: err = launch<40>(x, dt, A, Bm, Cm, h0, y, h_last, hs, B, S, C, s); break;
    case 6: err = launch<48>(x, dt, A, Bm, Cm, h0, y, h_last, hs, B, S, C, s); break;
    case 7: err = launch<56>(x, dt, A, Bm, Cm, h0, y, h_last, hs, B, S, C, s); break;
    default: err = launch<64>(x, dt, A, Bm, Cm, h0, y, h_last, hs, B, S, C, s);
  }
  return (int)err;
}

// The backward of selective_scan given its saved hs and the cotangents dy
// (B, S, C) and dh_last (B, C, N; null for zeros) → dx, ddt (B, S, C), dA
// (C, N), dB, dC (B, S, N), dh0 (B, C, N). Scratch: dA_part (B, C, N),
// dB_part and dC_part (B, ceil(C / 64), S, N). f32, contiguous, 16-byte
// aligned. Two launches: the reverse walk, then the sums of the partials.
// Returns the CUDA error of the first launch that failed.
int selective_scan_bwd(int device, const float* x, const float* dt,
                       const float* A, const float* Bm, const float* Cm,
                       const float* hs, const float* dy,
                       const float* dh_last, float* dx, float* ddt,
                       float* dA_part, float* dB_part, float* dC_part,
                       float* dA, float* dB, float* dC, float* dh0, int B,
                       int S, int C, int N, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(B, S, C, N)) return (int)cudaErrorInvalidValue;
  const BwdArgs a{x, dt, A, Bm, Cm, hs, dy, dh_last, dx, ddt, dA_part,
                  dB_part, dC_part, dA, dB, dC, dh0, B, S, C, N};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N / NMUL) {
    case 1: err = launch_bwd<8>(a, s); break;
    case 2: err = launch_bwd<16>(a, s); break;
    case 3: err = launch_bwd<24>(a, s); break;
    case 4: err = launch_bwd<32>(a, s); break;
    case 5: err = launch_bwd<40>(a, s); break;
    case 6: err = launch_bwd<48>(a, s); break;
    case 7: err = launch_bwd<56>(a, s); break;
    default: err = launch_bwd<64>(a, s);
  }
  return (int)err;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

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
// Two kernels; ops.py::ssd_route picks one per call, ops.py::ssd_plan sizes
// the first.
//
// ssd_mma: f32 with P <= 64 and N <= 128, both multiples of 8, and x, B, C
// rows 16-byte aligned (mamba2: P 64, N 128). What bounds it at mamba2's
// 8 chunk rows x 24 heads, Q 256: the bytes (x, y, st, B, C, cs: 33.75 MB,
// 0.0101 ms at 3.35 TB/s) and about as much the products once the heads
// share their scores (1.68 GFLOP as three TF32 products each, 0.0102 ms at
// 495 TFLOP/s). The design:
// - Scores once per chunk row. With B and C shared by the heads, a y block
//   owns (chunk row g, 64 rows t, a group of up to 4 heads): it forms S =
//   C_t B_s^T for each key tile s <= t once, keeps it in shared memory, and
//   each head of the group takes S ⊙ L_h as an operand of its product with
//   x_h. L is applied by selection: a score is kept only where t >= s (above
//   the diagonal exp may overflow, and inf * 0 would be NaN); key tiles
//   above the diagonal are skipped.
// - The product with x is taken transposed, yᵀ = xᵀ (S ⊙ L)ᵀ: x is the A
//   operand, so a warp covers all 64 columns of y and every x value it loads
//   feeds its 4 t n-tiles, and the masked scores are the B operand, which
//   the score accumulators give without shuffles (the scores' key columns
//   are permuted within each 8).
// - The state is one product per chunk row, (N x Q) (Q x H P): a state
//   block owns the (N, P) outputs of one or two heads, reads B once for
//   them, and scales x by its decay to the chunk end as it enters the
//   product.
// - f32 on the tensor cores (3xTF32): both operands of every product are
//   split, after masking and scaling, into hi + lo, each a TF32 value (the
//   low 13 mantissa bits clear), and a b = a_lo b_hi + a_hi b_lo + a_hi
//   b_hi in one f32 accumulator; the dropped a_lo b_lo is below 2^-20 of
//   the term. mma.sync m16n8k8, since wgmma takes TF32 operands only
//   K-major and x and the scores reach the products in the other order.
// - Shared loads of 8 or 16 bytes a thread: the sum index of every product
//   is permuted within its slices, a y block's x tile swizzles its 16-byte
//   chunks by row and the other tiles are padded, so the threads of a
//   quarter warp (half warp for 8 bytes) read distinct banks.
// - A ring of 2 stages filled by 16-byte cp.async, one barrier a step: a y
//   block's steps are B half tiles (64 keys x 64 of N) and one x step of
//   its heads' x tiles (64 keys x 64 of P, with cs at those keys); a state
//   block's steps are 32 keys of B and of its heads' x. Ragged tiles are
//   zero-filled by the copy, never branched on in the products.
// - One 187 KB block an SM (8 warps), and the grid runs its longest blocks
//   first: the y blocks of the last t tile (the most key tiles), down to
//   the first, with the state blocks where their length falls. Each output
//   element is summed by one block in a fixed order: two calls give equal
//   bits.
//
// ssd_intra: everything else, f32 on the CUDA cores. A block owns 64 rows t
// of y of one (g, h) and walks the key tiles s <= t, as a flash kernel walks
// keys: a 64 x 64 score tile over N in steps of 16, the decay mask applied by
// selection, then the tile's product with x. The state is a second kind of
// block on the same grid axis: 64 rows n of st over all Q, B scaled by its
// decay to the chunk end. Any Q, P and N; ragged tiles are masked. Threads
// 16 x 16, each a 4 x 4 piece of a 64 x 64 tile. Bound by operations on the
// f32 CUDA cores: 2 (N + P) Q (Q + 1) / 2 + 2 Q N P per (g, h).

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

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


// ------------------------------------------------------------------ ssd_mma
constexpr int MT = 64;          // rows t of a y block; keys of a key tile
constexpr int MP = 64;          // columns p of a block (P <= MP)
constexpr int MN = 128;         // state dim of the route (N <= MN)
constexpr int SK = 32;          // keys of a state block's step
constexpr int MSTAGES = 2;      // stages of the ring
constexpr int MTHREADS = 256;   // 8 warps
constexpr int SLOTS = 4;        // heads of a y block's x step (2 warps each)
constexpr int HPB_MAX = 4;      // heads of a y block
constexpr int HS_MAX = 2;       // heads of a state block
// Pitches (floats) of the shared tiles: rows 16-byte aligned, and the 8
// threads of a quarter warp's 16-byte (state B: 8-byte) loads on distinct
// banks for the rows each tile's threads read together. A y block's x tile
// has no pad: its 16-byte chunks are swizzled instead (xswz).
constexpr int BP = 68;          // y block's B half tile: rows 4 apart
constexpr int CP = 144;         // y block's C tile: adjacent rows
constexpr int SBP = 136;        // state block's B: rows q (8-byte loads)
constexpr int XSP = 72;         // state block's x: rows q, q + 1, q + 2, q + 3
constexpr int SFP = 20;         // a lane's S fragments of a key slice
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory in floats. y block: the C tile (64 x 128), the S fragments
// of a key tile (64 x 64, SFP a lane and key slice), cs at the block's
// rows t for each head, and the ring, a stage holding SLOTS x tiles and cs
// at their keys (or a B half tile). State block: the ring, a stage holding
// 32 rows of B, and of x and cs for each of its heads.
constexpr int Y_STAGE = SLOTS * (MT * MP + MT);
constexpr int Y_FLOATS = MT * CP + 8 * 32 * SFP + HPB_MAX * MT +
                         MSTAGES * Y_STAGE;
constexpr int S_STAGE = SK * SBP + HS_MAX * SK * (XSP + 1);
constexpr int S_FLOATS = MSTAGES * S_STAGE;
struct MmaSmem {
  static constexpr int bytes =
      4 * (Y_FLOATS > S_FLOATS ? Y_FLOATS : S_FLOATS);
};
static_assert(MmaSmem::bytes == 191488, "the size the header states");
static_assert(MmaSmem::bytes <= 232448, "one block on an SM");
static_assert(MT * BP <= Y_STAGE && MN <= CP && MN <= SBP && MP <= XSP,
              "tiles fit their pitches and stages");
static_assert(SLOTS == HPB_MAX && MTHREADS == 32 * 2 * SLOTS &&
                  MTHREADS == 32 * 8,
              "x step: 2 warps a head; scores and state: 4 x 2 warps");

struct MmaArgs {
  const float* x;
  const float* cs;
  const float* B;
  const float* C;
  float* y;                      // (g, h, t) strides sy, p contiguous
  float* st;                     // (g, h, p) strides, n contiguous
  Strides sx, scs, sb, sc, sy;
  long long st_g, st_h, st_p;
  int G, H, Q, P, N;
  int hpb, hs, state_pos;        // ops.py::ssd_plan
};

// 2^x (ex2.approx.ftz: within 2 ulp; below 2^-126 it is 0)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The 16-byte chunk u of row r of a y block's x tile lies at chunk u ^
// xswz(r): the 8 threads of a quarter warp read rows q = 0..3 at chunks 2 g
// + c (g = 0, 1) and land on 8 distinct bank groups.
__device__ __forceinline__ int xswz(int r) { return (r & 1) | ((r & 2) << 1); }

// rows [0, ROWS) x columns [0, 4 CHUNKS) of a row-major f32 tile at src
// (row stride ld) into shared memory at pitch `pitch` (SWZ: pitch 4 CHUNKS,
// chunks swizzled by xswz), by 16-byte cp.async; rows from rows_ok and
// columns from cols_ok on are zero-filled.
template <int ROWS, int CHUNKS, bool SWZ = false>
__device__ __forceinline__ void copy_tile(float* dst, int pitch,
                                          const float* src, long long ld,
                                          int rows_ok, int cols_ok) {
  for (int c = threadIdx.x; c < ROWS * CHUNKS; c += MTHREADS) {
    const int r = c / CHUNKS, u = c % CHUNKS, col = 4 * u;
    const bool ok = r < rows_ok && col < cols_ok;
    float* d = dst + r * pitch + 4 * (SWZ ? u ^ xswz(r) : u);
    cp_async16(d, ok ? src + r * ld + col : src, ok);
  }
}

// n values at stride ld (cs along t) by 4-byte cp.async, zero from n_ok on
__device__ __forceinline__ void copy_cs(float* dst, const float* src,
                                        long long ld, int n, int n_ok) {
  for (int i = threadIdx.x; i < n; i += MTHREADS) {
    const bool ok = i < n_ok;
    cp_async4(dst + i, ok ? src + i * ld : src, ok);
  }
}

// Step k of a ring: wait for its stage, make it visible to the block (and
// every shared write before), then refill the stage that step k - 1 read.
template <class Issue>
__device__ __forceinline__ void acquire(int k, Issue& issue) {
  cp_async_wait<MSTAGES - 2>();
  __syncthreads();
  issue(k + MSTAGES - 1);
}

// S (16 rows t x 32 keys of this warp) += C B^T over a half tile (64 of N).
// The sum index is permuted: pair m of k slices takes n = 16 m + 4 q +
// {0, 1, 2, 3} as (k q, k q + 4) of slice 2 m, then of 2 m + 1, so a
// thread's A fragments of a row are one 16-byte load of C and its B
// fragments of a key one of B. ca: C at (row g, 4 q) of the half tile; bb:
// B at (the key of n-tile 0 this thread loads, 4 q).
__device__ __forceinline__ void scores_step(const float* ca, const float* bb,
                                            float (&sacc)[4][4]) {
#pragma unroll 1
  for (int m = 0; m < 4; ++m) {
    const float4 u = lds4(ca + 16 * m), v = lds4(ca + 8 * CP + 16 * m);
    uint32_t ah[2][4], al[2][4];
    split_tf32(u.x, ah[0][0], al[0][0]);
    split_tf32(v.x, ah[0][1], al[0][1]);
    split_tf32(u.y, ah[0][2], al[0][2]);
    split_tf32(v.y, ah[0][3], al[0][3]);
    split_tf32(u.z, ah[1][0], al[1][0]);
    split_tf32(v.z, ah[1][1], al[1][1]);
    split_tf32(u.w, ah[1][2], al[1][2]);
    split_tf32(v.w, ah[1][3], al[1][3]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 w = lds4(bb + 8 * j * BP + 16 * m);
      uint32_t bh[2][2], bl[2][2];
      split_tf32(w.x, bh[0][0], bl[0][0]);
      split_tf32(w.y, bh[0][1], bl[0][1]);
      split_tf32(w.z, bh[1][0], bl[1][0]);
      split_tf32(w.w, bh[1][1], bl[1][1]);
      mma_3xtf32(sacc[j], ah[0], al[0], bh[0], bl[0]);
      mma_3xtf32(sacc[j], ah[1], al[1], bh[1], bl[1]);
    }
  }
}

// yᵀ (64 columns p x 32 rows t of this warp) += xᵀ (S ⊙ L)ᵀ over one key
// tile for one head: x is the A operand (rows p), the masked scores the B
// operand (columns t), so a warp covers all 64 columns of y and each x value
// a thread loads feeds its 4 t n-tiles. Row g (g + 8) of m-tile mt is p =
// 8 g + 2 mt (+ 1): a thread's A fragments of a key are two 16-byte loads
// of x (xs: row q of the tile; chunks 2 g, 2 g + 1 before the swizzle).
// sf: this thread's S of key slice 0 (slice kk at + 32 SFP kk): (b0, b1)
// of t n-tile 4 nh + j at + 2 j, S at (t, s) = (8 n + g, q), (8 n + g, q +
// 4). css: cs at the tile's keys; ct[j]: cs at t = tl + 8 j (local); L
// selects s <= tl + 8 j (tl past the tile for a key tile below the
// diagonal).
__device__ __forceinline__ void y_step(const float* sf, const float* xs,
                                       const float* css, const float (&ct)[4],
                                       int tl, int q, int g,
                                       float (&acc)[4][4][4]) {
  const int sw = xswz(q);
#pragma unroll 1
  for (int kk = 0; kk < 8; ++kk) {
    const int sa = 8 * kk + q;
    const float ca = css[sa], cb = css[sa + 4];
    uint32_t bh[4][2], bl[4][2];
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      const float4 f = lds4(sf + 32 * SFP * kk + 4 * jp);
      const float sv[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 2 * jp + e / 2, t = tl + 8 * j, s = e % 2 ? sa + 4 : sa;
        const float v =
            s <= t ? sv[e] * exp2_ftz((ct[j] - (e % 2 ? cb : ca)) * LOG2E)
                   : 0.f;
        split_tf32(v, bh[j][e % 2], bl[j][e % 2]);
      }
    }
    const float* r0 = xs + 8 * kk * MP;
    const float* r1 = r0 + 4 * MP;                  // row q + 4: same xswz
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      // (a0, a1) and (a2, a3) are 8-byte loads: each lands in one half of
      // the fragment's registers
      const int o = 4 * ((2 * g + (mt >> 1)) ^ sw) + 2 * (mt & 1);
      const float2 u = *reinterpret_cast<const float2*>(r0 + o);
      const float2 v = *reinterpret_cast<const float2*>(r1 + o);
      uint32_t ah[4], al[4];
      split_tf32(u.x, ah[0], al[0]);
      split_tf32(u.y, ah[1], al[1]);
      split_tf32(v.x, ah[2], al[2]);
      split_tf32(v.y, ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma_3xtf32(acc[mt][j], ah, al, bh[j], bl[j]);
    }
  }
}

// y rows [t0, t0 + 64) of chunk row g for heads [h0, h0 + hpb). Scores:
// warp (wt, ws) = (warp % 4, warp / 4) takes rows 16 wt, keys 32 ws of each
// tile. Products: an x step holds the group's heads (up to SLOTS); warp
// (hh, nh) = (warp / 2, warp % 2) takes head h0 + hh, rows 32 nh, all 64
// columns.
__device__ __forceinline__ void y_block(const MmaArgs& a, float* smem, int g,
                                        int ti, int h0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, q = lane & 3, wt = warp & 3, ws = warp >> 2;
  const int hh = warp >> 1, nh = warp & 1;
  float* Cs = smem;
  float* Sf = Cs + MT * CP;
  float* cst = Sf + 8 * 32 * SFP;
  float* ring = cst + HPB_MAX * MT;
  const int t0 = ti * MT, hpb = a.hpb;
  const int nbh = (a.N + 63) / 64, per = nbh + 1, items = (ti + 1) * per;
  const float* Bg = a.B + g * a.sb.g + h0 * a.sb.h;
  const float* csg = a.cs + g * a.scs.g;

  copy_tile<MT, MN / 4>(Cs, CP, a.C + g * a.sc.g + h0 * a.sc.h +
                        t0 * a.sc.t, a.sc.t, a.Q - t0, a.N);
  for (int i = 0; i < hpb; ++i)
    copy_cs(cst + i * MT, csg + (h0 + i) * a.scs.h + t0 * a.scs.t,
            a.scs.t, MT, a.Q - t0);
  // item k of key tile k / per: B half tiles, then the x step of the heads
  auto issue = [&](int k) {
    if (k < items) {
      const int s0 = (k / per) * MT, r = k % per;
      float* dst = ring + (k % MSTAGES) * Y_STAGE;
      if (r < nbh) {
        copy_tile<MT, 16>(dst, BP, Bg + s0 * a.sb.t + 64 * r, a.sb.t,
                          a.Q - s0, a.N - 64 * r);
      } else {
        for (int i = 0; i < hpb; ++i) {
          const int h = h0 + i;
          float* xd = dst + i * (MT * MP + MT);
          copy_tile<MT, MP / 4, true>(xd, MP, a.x + g * a.sx.g +
                                      h * a.sx.h + s0 * a.sx.t, a.sx.t,
                                      a.Q - s0, a.P);
          copy_cs(xd + MT * MP, csg + h * a.scs.h + s0 * a.scs.t, a.scs.t,
                  MT, a.Q - s0);
        }
      }
    }
    cp_async_commit();
  };
  for (int k = 0; k < MSTAGES - 1; ++k) issue(k);

  // the key each thread loads for n-tile 0 of the scores: key column 2 c
  // (2 c + 1) of the accumulators is key c (c + 4) of the 8
  const float* ca = Cs + (16 * wt + gq) * CP + 4 * q;
  const int boff = (32 * ws + (gq >> 1) + 4 * (gq & 1)) * BP + 4 * q;
  const int tl = 32 * nh + gq;
  const bool mine = hh < hpb;
  float ct[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) ct[j] = 0.f;
  float acc[4][4][4] = {};
  int k = 0;
  for (int si = 0; si <= ti; ++si) {
    float sacc[4][4] = {};
    for (int hn = 0; hn < nbh; ++hn, ++k) {
      acquire(k, issue);
      scores_step(ca + 64 * hn,
                  ring + (k % MSTAGES) * Y_STAGE + boff, sacc);
    }
    // accumulators of key column block j: (d0, d1) is (b0, b1) of the
    // product's t n-tile 2 wt at key slice 4 ws + j, (d2, d3) of 2 wt + 1
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Sf + ((4 * ws + j) * 32 + lane) * SFP +
                                 4 * wt) =
          make_float4(sacc[j][0], sacc[j][1], sacc[j][2], sacc[j][3]);
    acquire(k, issue);
    if (mine) {
      if (si == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) ct[j] = cst[hh * MT + tl + 8 * j];
      }
      const float* st = ring + (k % MSTAGES) * Y_STAGE + hh * (MT * MP + MT);
      const float* sf = Sf + lane * SFP + 8 * nh;
      y_step(sf, st + q * MP, st + MT * MP, ct, si == ti ? tl : MT, q, gq,
             acc);
    }
    ++k;
  }
  cp_async_wait<0>();
  if (!mine) return;

  // D (row g, column 2 q) of m-tile mt, t n-tile j is y at (t, p) = (32 nh +
  // 8 j + 2 q, 8 g + 2 mt); d1 the next t, d2 the next p, d3 both
  float* yh = a.y + g * a.sy.g + (h0 + hh) * a.sy.h;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const int p = 8 * gq + 2 * mt;
    if (p >= a.P) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = t0 + 32 * nh + 8 * j + 2 * q;
      const float(&c)[4] = acc[mt][j];
      if (t < a.Q)
        *reinterpret_cast<float2*>(yh + t * a.sy.t + p) =
            make_float2(c[0], c[2]);
      if (t + 1 < a.Q)
        *reinterpret_cast<float2*>(yh + (t + 1) * a.sy.t + p) =
            make_float2(c[1], c[3]);
    }
  }
}

// st (N x P) of chunk row g for heads [h0, h0 + hs): the sum over keys of
// B[s, n] d_h[s] x_h[s, p], d_h[s] = exp(cs[Q - 1] - cs[s]) for s < Q (0
// beyond, by selection). Warp (wn, wp) = (warp % 4, warp / 4): rows n 32 wn
// (row g of m-tile mt is n = 32 wn + 16 mt + 2 g, row g + 8 the next n, so
// a0, a1 are one 8-byte load), columns p 32 wp, both heads.
__device__ __forceinline__ void state_block(const MmaArgs& a, float* smem,
                                            int g, int h0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, q = lane & 3, wn = warp & 3, wp = warp >> 2;
  const int hs = a.hs, steps = (a.Q + SK - 1) / SK;
  const float* Bg = a.B + g * a.sb.g + h0 * a.sb.h;
  const float* csg = a.cs + g * a.scs.g;
  float cl[HS_MAX];
#pragma unroll
  for (int i = 0; i < HS_MAX; ++i)
    cl[i] = i < hs ? csg[(h0 + i) * a.scs.h + (a.Q - 1) * a.scs.t] : 0.f;
  auto issue = [&](int k) {
    if (k < steps) {
      const int s0 = k * SK;
      float* dst = smem + (k % MSTAGES) * S_STAGE;
      copy_tile<SK, MN / 4>(dst, SBP, Bg + s0 * a.sb.t, a.sb.t, a.Q - s0,
                            a.N);
      for (int i = 0; i < hs; ++i) {
        const int h = h0 + i;
        copy_tile<SK, MP / 4>(dst + SK * SBP + i * SK * XSP, XSP,
                              a.x + g * a.sx.g + h * a.sx.h + s0 * a.sx.t,
                              a.sx.t, a.Q - s0, a.P);
        copy_cs(dst + SK * SBP + HS_MAX * SK * XSP + i * SK,
                csg + h * a.scs.h + s0 * a.scs.t, a.scs.t, SK, a.Q - s0);
      }
    }
    cp_async_commit();
  };
  for (int k = 0; k < MSTAGES - 1; ++k) issue(k);

  float acc[HS_MAX][2][4][4] = {};
  for (int k = 0; k < steps; ++k) {
    acquire(k, issue);
    const float* bt = smem + (k % MSTAGES) * S_STAGE;
    const float* xt = bt + SK * SBP;
    const float* ct = xt + HS_MAX * SK * XSP;
#pragma unroll 1
    for (int kk = 0; kk < SK / 8; ++kk) {
      const int sa = 8 * kk + q, s = k * SK + sa;
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* b = bt + sa * SBP + 32 * wn + 16 * mt + 2 * gq;
        const float2 u = *reinterpret_cast<const float2*>(b);
        const float2 v = *reinterpret_cast<const float2*>(b + 4 * SBP);
        split_tf32(u.x, ah[mt][0], al[mt][0]);
        split_tf32(u.y, ah[mt][1], al[mt][1]);
        split_tf32(v.x, ah[mt][2], al[mt][2]);
        split_tf32(v.y, ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int i = 0; i < HS_MAX; ++i) {
        if (i >= hs) break;
        const float da =
            s < a.Q ? exp2_ftz((cl[i] - ct[i * SK + sa]) * LOG2E) : 0.f;
        const float db =
            s + 4 < a.Q ? exp2_ftz((cl[i] - ct[i * SK + sa + 4]) * LOG2E)
                        : 0.f;
        const float* xr = xt + i * SK * XSP + sa * XSP + 32 * wp + 4 * gq;
        const float4 p = lds4(xr), r = lds4(xr + 4 * XSP);
        const float b0[4] = {p.x, p.y, p.z, p.w}, b1[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bh[2], bl[2];
          split_tf32(b0[j] * da, bh[0], bl[0]);
          split_tf32(b1[j] * db, bh[1], bl[1]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            mma_3xtf32(acc[i][mt][j], ah[mt], al[mt], bh, bl);
        }
      }
    }
  }
  cp_async_wait<0>();

  // D column 2 c (2 c + 1) of n-tile j is column 32 wp + 8 c + j (+ 4)
  const int p = 32 * wp + 8 * q;
  if (p >= a.P) return;
#pragma unroll
  for (int i = 0; i < HS_MAX; ++i) {
    if (i >= hs) break;
    float* sth = a.st + g * a.st_g + (h0 + i) * a.st_h + p * a.st_p;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int n = 32 * wn + 16 * mt + 2 * gq;
      if (n >= a.N) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float(&c)[4] = acc[i][mt][j];
        *reinterpret_cast<float2*>(sth + j * a.st_p + n) =
            make_float2(c[0], c[2]);
        *reinterpret_cast<float2*>(sth + (j + 4) * a.st_p + n) =
            make_float2(c[1], c[3]);
      }
    }
  }
}

// One block per (chunk row, t tile, head group) of y and per (chunk row,
// head group) of the state, longest first: the y classes by t tile from the
// last, the state class after the first state_pos of them.
__global__ void __launch_bounds__(MTHREADS, 1) ssd_mma(const MmaArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int nt = (a.Q + MT - 1) / MT;
  const int ngy = a.H / a.hpb, ngs = a.H / a.hs;
  int r = blockIdx.x;
  for (int c = 0; c <= nt; ++c) {
    if (c == a.state_pos) {
      if (r < a.G * ngs) {
        state_block(a, smem, r / ngs, (r % ngs) * a.hs);
        return;
      }
      r -= a.G * ngs;
    } else {
      if (r < a.G * ngy) {
        const int ti = nt - 1 - (c < a.state_pos ? c : c - 1);
        y_block(a, smem, r / ngy, ti, (r % ngy) * a.hpb);
        return;
      }
      r -= a.G * ngy;
    }
  }
}

bool aligned16(const void* p, const long long* s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s[0] % 4 == 0 &&
         s[1] % 4 == 0 && s[2] % 4 == 0;
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

// The tensor-core route, same arguments as ssd_intra_chunk plus the plan of
// ops.py::ssd_plan: heads per y block (hpb) and per state block (hs), both
// dividing H, and the state class's place among the y classes (state_pos,
// 0..ceil(Q / 64)). Takes 8 <= P <= 64 and 8 <= N <= 128, multiples of 8,
// x, B and C 16-byte aligned with (g, h, t) strides of multiples of 4, y
// with its p and st with its n stride 1; B and C may share one head (stride
// 0) and groups of heads (hpb or hs above 1) are taken only then. Returns the
// CUDA error of the launch.
int ssd_intra_chunk_mma(int device, const float* x, const float* cs,
                        const float* B, const float* C, float* y, float* st,
                        const long long* strides, int G, int H, int Q, int P,
                        int N, int hpb, int hs, int state_pos, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long* s = strides;
  const int nt = Q > 0 ? (Q + MT - 1) / MT : 0;
  if (G < 1 || H < 1 || Q < 1 || P < 8 || P > MP || P % 8 || N < 8 ||
      N > MN || N % 8 || hpb < 1 || hpb > HPB_MAX || H % hpb || hs < 1 ||
      hs > HS_MAX || H % hs || state_pos < 0 || state_pos > nt ||
      ((hpb > 1 || hs > 1) && (s[7] != 0 || s[10] != 0)) || s[17] != 1 || !aligned16(x, s) || !aligned16(B, s + 6) ||
      !aligned16(C, s + 9))
    return (int)cudaErrorInvalidValue;
  const long long blocks =
      (long long)G * ((long long)nt * (H / hpb) + H / hs);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  static bool done[64] = {};
  if (device < 0 || device >= 64 || !done[device]) {
    err = cudaFuncSetAttribute(ssd_mma,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MmaSmem::bytes);
    if (err != cudaSuccess) return (int)err;
    if (device >= 0 && device < 64) done[device] = true;
  }
  MmaArgs a{x, cs, B, C, y, st,
            Strides{s[0], s[1], s[2]}, Strides{s[3], s[4], s[5]},
            Strides{s[6], s[7], s[8]}, Strides{s[9], s[10], s[11]},
            Strides{s[12], s[13], s[14]}, s[15], s[16], s[18],
            G, H, Q, P, N, hpb, hs, state_pos};
  ssd_mma<<<(unsigned)blocks, MTHREADS, MmaSmem::bytes,
            static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

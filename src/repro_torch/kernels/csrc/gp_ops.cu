// K1a, K1b, K2: the incremental GP's tell and ask kernels, float64, for
// Hopper (sm_90a).
//
// Replace the Pallas TPU kernels of repro/kernels/gp_ops.py:
//   K1a gp_w    <- _w_kernel    (gp_append, w = L^-1 K12)
//   K1b gp_g    <- _g_kernel    (gp_append, g = w^T L^-1)
//   K2  gp_ehvi <- _ehvi_kernel (gp_fused_ehvi, predict + EHVI sweep)
// and compute the same functions, in float64, with the same RBF form:
//   d2 = (|a|^2 + |b|^2) - 2 a.b, clamped at 0;  k = signal * exp(-0.5 d2 / ls2)
// (ARD lengthscales arrive as inputs pre-scaled by 1/ls with ls2 = 1).
//
// Buffer invariant the kernels rely on (as the TPU kernels do): L^-1 is
// lower-triangular and its rows and columns >= n are exactly zero.
//
// What bounds K1a/K1b on an H100 at the search path's size (cap 8192,
// n <= 6250, d = 14): a fold (B = 512 new rows) does 2 * n^2/2 * 512 flop
// (2.0e10, ~0.30 ms at the 67 TFLOP/s float64 tensor rate: operations); a
// tell (B = 1) reads the active lower triangle of L^-1 (n^2/2 * 8 B =
// 156 MB, ~47 us at 3.35 TB/s: bytes).  So each has two forms, picked by
// the padded block height B:
//
// * Both forms of K1a first build K12 (masked to rows < n and columns < m)
//   once per call into a workspace of n rounded up to FM rows (gp_k12_kernel):
//   one RBF per entry, where building it inside every product tile would
//   evaluate each entry once per row tile.
// * Fold (B a multiple of 16): gp_fold_kernel, one template for both
//   products, on the float64 tensor cores (DMMA: mma.sync m16n8k4 f64, fp64
//   accumulators in registers).  FM x FN = 128 x 128 output tiles, 8 warps
//   of 64 x 32, FK = 32-deep contraction steps staged by cp.async in a
//   3-stage ring (211,968 B of shared memory, one block per SM).  A
//   128-column tile reads each L^-1 tile once per 128 columns of B (4 times
//   at B = 512; the tiles that share a panel lie next to each other in the
//   walk, so their blocks run at about the same time; how many re-reads
//   hit L2 is not measured).  Only the active lower tiles are
//   walked: K1a's row tile t contracts over k < min(n, end of t), K1b's
//   column tile t over start of t <= i < n, so a tile's work grows (K1a) or
//   shrinks (K1b) linearly with t.  Whole tiles per block would leave the
//   SMs unequal (pairing t with T - 1 - t gives 100 equal blocks on 132
//   SMs at n = 6250, B = 512); instead the steps of all active tiles are
//   laid end to end and each of one block per SM takes an equal share
//   (stream-K).  A tile cut between blocks leaves one part per block in a
//   workspace, and gp_fold_fixup_kernel sums the parts in block order and
//   writes the zero tiles beyond n.  K1b reads w^T straight from the
//   (cap, B) w: its [k][m] layout is the [k][n] one of the other operand.
// * Tell (B in 1, 2, 4, 8): bandwidth-bound forms that read the triangle
//   about once with 16-byte loads.  K1a (gp_w_tell_kernel): one warp per
//   pair of rows p and n - 1 - p (so every warp reads n + 1 entries), lanes
//   striding along the row, the B sums reduced by a fixed xor butterfly.
//   K1b (gp_g_tell_partial_kernel, then gp_g_tell_reduce_kernel): blocks of
//   PANEL rows x PCOLS columns read their rows coalesced along j into
//   per-panel partial column sums; the second pass adds, for each column j,
//   the panels that hold rows >= j, in panel order.  At B <= 8 the tell's
//   2B flop per 8-byte element stay under the CUDA cores' float64 ridge
//   (34 TFLOP/s over 3.35 TB/s), while a 128-column DMMA tile would waste
//   at least 15/16 of its work; at B = 16 the tell's 16 sums and 16 K12
//   values per element would be bound by L1 instead.
// * Deterministic sums, no atomics: every output is summed by one thread in
//   a fixed order, or by a warp in a fixed lane order and a fixed xor
//   butterfly, or from per-block parts or per-panel partials in block or
//   panel order; the split depends only on (n, B, the SM count), so two
//   launches on the same inputs are bitwise equal.
// * n, m and the tile counts are host integers passed by value: no device
//   read, no sync.  float64 exp() throughout; build without --use_fast_math.
//
// K2 (gp_ehvi) at the search path's size (P = 512, n = 6250, d = 14) is
// P n = 3.2 M float64 exp()s beside 3.2 M x 2d flop of contraction, over
// < 1 MB: operations bound it, mostly the exp() sequence (18 float64
// instructions in its SASS) on the CUDA cores, a few microseconds (PERF.md
// gives the bound).  Its earlier form (one warp per candidate, 4 warps per
// block, ceil(P / 4) = 128 blocks) left each SM about 4 warps to walk all
// n rows with one dependent dot product per lane, and every block
// recomputed |x_j|^2 from device memory.  So it is two passes:
// * gp_ehvi_partial_kernel, a 2-D grid of candidate tiles x row splits.
//   Block (c, g) takes EHVI_TILE = 64 candidates and the contiguous rows
//   of split g: the ceil(n / EHVI_STEP) steps of EHVI_STEP = 64 rows are
//   cut into G equal runs, G = max(1, min(steps, ceil(2 SMs / tiles)))
//   (gp_ops.ehvi_splits), so the grid holds at least two blocks per SM at
//   the search shape (8 x 33 = 264 on 132 SMs; 16 or 66 splits were
//   slower on the card).  Rows and alpha are staged through cp.async in a
//   double buffer (the next step loads while this one computes);
//   |x_j|^2 is computed once per staged step from shared memory, |q|^2
//   once per candidate, 4 lanes a row.  The contraction runs on the
//   float64 tensor cores (DMMA m16n8k4, d padded with zeros to a multiple
//   of 4): each warp's 16 candidates x 32 rows are four tiles per 4-deep
//   slice, and leave every lane 16 dot products (2 candidates x 8 rows),
//   whose 16 exp()s are independent.  The same pass with the contraction
//   on the CUDA cores (4 x 4 register patches) was slower on the card, the
//   more so at larger d.  The 4 lanes of a candidate pair add their sums
//   by a fixed butterfly, the two warps of a candidate tile in a fixed
//   order through shared memory, and the block writes a (tile, 2) partial
//   of mu.
// * gp_ehvi_sweep_kernel, one warp per candidate: the G partials summed
//   lane-strided and then by a fixed butterfly, denormalised, and swept
//   through the staircase, read from device memory in strides of 32, so
//   its width S has no bound.  The staircase's first `lows` entry is -inf
//   and fmax(-inf, mu) is exact.
// The exponent is d2 times -0.5 / ls2 computed once on the host (no
// float64 division per pair): within one rounding of the plain version's
// -0.5 d2 / ls2.  G comes from the wrapper (gp_ops.ehvi_splits); the row
// runs are cut here from (n, G) alone.

#include <cuda_runtime.h>

namespace {

// ---- fold form (K1a, K1b at B a multiple of 16)
constexpr int FM = 128;               // output tile rows
constexpr int FN = 128;               // output tile columns
constexpr int FK = 32;                // contraction step
constexpr int FSTAGES = 3;            // cp.async ring depth
constexpr int FTHREADS = 256;         // 8 warps: 2 along rows x 4 along columns
constexpr int WM = 64, WN = 32;       // warp tile
constexpr int MI = WM / 16, NI = WN / 8;   // m16n8k4 tiles per warp
constexpr int LDK = FK + 4;           // [row][k] stage: rows 16-byte aligned, and
constexpr int LDX = FM + 4;           // [k][col] stage: fragment loads free of bank conflicts
constexpr int A_STAGE = FM * LDK > FK * LDX ? FM * LDK : FK * LDX;
constexpr int B_STAGE = FK * LDX;
constexpr int FOLD_SMEM = FSTAGES * (A_STAGE + B_STAGE) * (int)sizeof(double);
constexpr int FIX_ROWS = 16;          // fix-up: rows of a tile per block
static_assert(FM == FN, "one [k][x] stage layout serves both operands");
static_assert(FIX_ROWS * FN / 2 % FTHREADS == 0, "fix-up rows split evenly");
static_assert(FM % 64 == 0, "K12 blocks of 64 rows tile the workspace");

// ---- tell form (K1a, K1b at B <= 8)
constexpr int TELL_MAX_B = 8;
constexpr int TELL_THREADS = 256;
constexpr int PANEL = 64;                   // K1b: rows per partial
constexpr int PCOLS = 2 * TELL_THREADS;     // K1b: columns per block (a double2 each)

// ---- K12 prologue and K2
constexpr int K12_THREADS = 256;
constexpr int K12_ROWS = 64;      // rows of K12 per block (FM is a multiple): 16 x 4
constexpr int K12_COLS = 64;      // columns of K12 per block, at most: 16 x 4
constexpr int EHVI_TILE = 64;         // K2: candidates per block (4 warps' 16-row tiles)
constexpr int EHVI_STEP = 64;         // K2: training rows staged per step (2 warps' 32)
constexpr int EHVI_THREADS = 256;
constexpr int EHVI_BLOCKS_PER_SM = 2;  // the split aims at this many blocks per SM
constexpr int SWEEP_THREADS = 256;    // K2's second pass: a warp per candidate

// K2's width d padded to the DMMA depth 4, and its shared-memory row
// stride: at least that, and 4 mod 16 doubles (bank-conflict-free fragments)
__host__ __device__ constexpr int ehvi_dpad(int d) { return (d + 3) / 4 * 4; }
__host__ __device__ constexpr int ehvi_ld(int d) {
  return ehvi_dpad(d) + (20 - ehvi_dpad(d) % 16) % 16;
}

__host__ __device__ constexpr int ehvi_smem_doubles(int d) {
  // two stages of s_x ([row][ld]), s_a ([row][2]) and s_xn, then s_q
  // ([candidate][ld]), s_qn and the two row halves' sums
  return 2 * EHVI_STEP * (ehvi_ld(d) + 3) + EHVI_TILE * (ehvi_ld(d) + 1) + 4 * EHVI_TILE;
}

__device__ __forceinline__ double rbf(double d2, double ls2, double signal) {
  d2 = fmax(d2, 0.0);
  return signal * exp(-0.5 * d2 / ls2);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// K12 (both forms of K1a): k12[k, c] = rbf(xs[k], xq[c]) for k < n and
// c < m, else 0, over n rounded up to FM rows and B columns.  A block
// stages K12_ROWS rows of xs and up to K12_COLS rows of xq with their
// squared norms in shared memory (rows padded to an odd stride, so lanes
// reading consecutive rows hit distinct banks); each thread computes a
// 4 x 4 patch (rows ty + 16 i, columns tx + 16 j), so a staged value feeds
// four dot products, and writes coalesced along c.
// ---------------------------------------------------------------------------
__host__ __device__ constexpr int k12_smem_doubles(int d) {
  return (K12_ROWS + K12_COLS) * (d | 1) + K12_ROWS + K12_COLS;
}

__global__ void __launch_bounds__(K12_THREADS)
gp_k12_kernel(const double* __restrict__ xs, const double* __restrict__ xq,
              double* __restrict__ k12, int d, int B, int n, int m, double ls2,
              double signal) {
  extern __shared__ double k12_smem[];
  const int dp = d | 1, cb = min(B, K12_COLS);
  double* s_x = k12_smem;
  double* s_q = s_x + K12_ROWS * dp;
  double* s_xn = s_q + K12_COLS * dp;
  double* s_qn = s_xn + K12_ROWS;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int k0 = blockIdx.x * K12_ROWS, c0 = blockIdx.y * cb;
  for (int e = tid; e < K12_ROWS * d; e += K12_THREADS) {
    const int r = e / d, k = k0 + r;
    s_x[r * dp + e % d] = k < n ? xs[(size_t)k * d + e % d] : 0.0;
  }
  for (int e = tid; e < cb * d; e += K12_THREADS) {
    const int c = e / d;
    s_q[c * dp + e % d] = c0 + c < m ? xq[(size_t)(c0 + c) * d + e % d] : 0.0;
  }
  __syncthreads();
  if (tid < K12_ROWS + cb) {
    const double* v = tid < K12_ROWS ? s_x + tid * dp : s_q + (tid - K12_ROWS) * dp;
    double s = 0.0;
    for (int f = 0; f < d; ++f) s += v[f] * v[f];
    (tid < K12_ROWS ? s_xn[tid] : s_qn[tid - K12_ROWS]) = s;
  }
  __syncthreads();
  if (tx >= cb) return;   // no barrier follows
  double dot[4][4] = {};
  for (int f = 0; f < d; ++f) {
    double a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = s_x[(ty + 16 * i) * dp + f];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = tx + 16 * j < cb ? s_q[(tx + 16 * j) * dp + f] : 0.0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dot[i][j] += a[i] * b[j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, k = k0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j, col = c0 + c;
      if (c >= cb || col >= B) continue;
      k12[(size_t)k * B + col] =
          k < n && col < m ? rbf((s_xn[r] + s_qn[c]) - 2.0 * dot[i][j], ls2, signal) : 0.0;
    }
  }
}

// ---------------------------------------------------------------------------
// Fold form: DMMA tiles.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// c (16 x 8) += a (16 x 4) b (4 x 8) on the float64 tensor cores.  Lane
// (g, t) = (lane / 4, lane % 4) holds a[g][t], a[g + 8][t], b[t][g] and
// c[g][2t], c[g][2t + 1], c[g + 8][2t], c[g + 8][2t + 1].
__device__ __forceinline__ void dmma_16x8x4(double (&c)[4], double a0, double a1, double b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b0));
}

// Stages rows k0 .. k0 + FK - 1 and columns x0 .. x0 + FM - 1 of a
// row-major matrix (leading dimension ld) as s[k][x]; rows >= kend and
// columns >= xend (even) are zero-filled.
__device__ __forceinline__ void stage_kx(double* s, const double* g, int ld, int k0,
                                         int kend, int x0, int xend, int tid) {
#pragma unroll
  for (int r = 0; r < FK * FM / 2 / FTHREADS; ++r) {
    const int e = tid + r * FTHREADS;
    const int kk = e / (FM / 2), xx = 2 * (e % (FM / 2));
    const int k = k0 + kk, x = x0 + xx;
    const bool ok = k < kend && x < xend;
    cp_async16(s + kk * LDX + xx, ok ? g + (size_t)k * ld + x : g, ok ? 16 : 0);
  }
}

// Stages rows x0 .. x0 + FM - 1 and columns k0 .. k0 + FK - 1 of a
// row-major matrix as s[x][k]; rows >= xend and columns >= kend are
// zero-filled (kend may be odd: a chunk may carry one element).
__device__ __forceinline__ void stage_xk(double* s, const double* g, int ld, int x0,
                                         int xend, int k0, int kend, int tid) {
#pragma unroll
  for (int r = 0; r < FM * FK / 2 / FTHREADS; ++r) {
    const int e = tid + r * FTHREADS;
    const int xx = e / (FK / 2), kk = 2 * (e % (FK / 2));
    const int x = x0 + xx, k = k0 + kk;
    const int bytes = x < xend ? 8 * max(0, min(2, kend - k)) : 0;
    cp_async16(s + xx * LDK + kk, bytes ? g + (size_t)x * ld + k : g, bytes);
  }
}

// The fold's iteration space.  Triangle tile t < T (K1a: rows of w; K1b:
// columns of g) holds Y width tiles (the B columns of w, rows of g), each
// of fold_steps(t) contraction steps of FK rows: K1a's row tile walks
// k < min(n, end of t), K1b's column tile i from the start of t to n.  The
// tiles lie in order (t, then y) and block g of G takes the iterations
// [split_begin(g), split_begin(g + 1)): equal shares of the triangle's
// work, whatever its shape (stream-K).
__host__ __device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <bool K1A>
__host__ __device__ __forceinline__ int fold_steps(int t, int n) {
  return K1A ? ceil_div(min(n, FM * (t + 1)), FK) : ceil_div(n - FM * t, FK);
}

__host__ __device__ __forceinline__ long split_begin(int g, long iters, int G) {
  return (long)g * iters / G;
}

// The block whose share holds iteration `it` (G <= iters: no share is empty).
__host__ __device__ __forceinline__ int split_block(long it, long iters, int G) {
  int g = (int)(it * G / iters);
  while (g + 1 < G && split_begin(g + 1, iters, G) <= it) ++g;
  return g;
}

// K1A: w (cap, B) = L^-1 @ K12: A = L^-1 (rows = the triangle's tiles),
//      B operand = the K12 workspace (columns = the width tiles).
// !K1A: g (B, cap) = w^T @ L^-1 over rows < n: A = w read as [k][m] (rows
//      = the width tiles), B operand = L^-1 (columns = the triangle's tiles).
// A tile whose steps one block computes whole is stored straight to c; a
// tile split between blocks leaves each block's part in `part` (slot 0 if
// it is the block's first tile, 1 if its last) for gp_fold_fixup_kernel.
template <bool K1A>
__global__ void __launch_bounds__(FTHREADS, 1)
gp_fold_kernel(const double* __restrict__ a, const double* __restrict__ b,
               double* __restrict__ c, double* __restrict__ part, int cap, int B,
               int n, int T, int Y, long iters) {
  extern __shared__ __align__(16) double fold_smem[];
  double* s_a = fold_smem;
  double* s_b = fold_smem + FSTAGES * A_STAGE;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp / (FN / WN)) * WM, wn = (warp % (FN / WN)) * WN;
  const int gq = lane >> 2, tq = lane & 3;
  const int G = gridDim.x, blk = blockIdx.x;
  const int mend = K1A ? cap : B, nend = K1A ? B : cap, ldc = K1A ? B : cap;

  long it = split_begin(blk, iters, G);
  const long end = split_begin(blk + 1, iters, G);
  int t = 0, s = fold_steps<K1A>(0, n);
  long base = 0;   // the first iteration of tile (t, 0)
  while (base + (long)Y * s <= it) {
    base += (long)Y * s;
    s = fold_steps<K1A>(++t, n);
  }
  int y = (int)((it - base) / s);
  bool first = true;

  while (it < end) {
    const long pu = base + (long)y * s;
    const int kb = (int)(it - pu), ke = (int)min((long)s, end - pu), nk = ke - kb;
    const int m0 = K1A ? t * FM : y * FM;
    const int n0 = K1A ? y * FN : t * FN;
    const int kend = K1A ? min(n, m0 + FM) : n;
    const int k0 = (K1A ? 0 : n0) + kb * FK;

    double acc[MI][NI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0;

    auto stage = [&](int slot, int kr) {
      double* sa = s_a + slot * A_STAGE;
      double* sb = s_b + slot * B_STAGE;
      if (K1A) {
        stage_xk(sa, a, cap, m0, cap, kr, kend, tid);
        stage_kx(sb, b, B, kr, kend, n0, B, tid);
      } else {
        stage_kx(sa, a, B, kr, kend, m0, B, tid);
        stage_kx(sb, b, cap, kr, kend, n0, cap, tid);
      }
    };

    __syncthreads();   // the previous tile's stages are consumed
#pragma unroll
    for (int st = 0; st < FSTAGES - 1; ++st) {
      if (st < nk) stage(st, k0 + st * FK);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<FSTAGES - 2>();
      __syncthreads();   // step kt has landed; step kt - 1's slot is free
      const int nxt = kt + FSTAGES - 1;
      if (nxt < nk) stage(nxt % FSTAGES, k0 + nxt * FK);
      cp_async_commit();
      const double* sa = s_a + (kt % FSTAGES) * A_STAGE;
      const double* sb = s_b + (kt % FSTAGES) * B_STAGE;
#pragma unroll
      for (int kk = 0; kk < FK; kk += 4) {
        double af[MI][2], bf[NI];
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const int r = wm + i * 16 + gq;
          if (K1A) {
            af[i][0] = sa[r * LDK + kk + tq];
            af[i][1] = sa[(r + 8) * LDK + kk + tq];
          } else {
            af[i][0] = sa[(kk + tq) * LDX + r];
            af[i][1] = sa[(kk + tq) * LDX + r + 8];
          }
        }
#pragma unroll
        for (int j = 0; j < NI; ++j) bf[j] = sb[(kk + tq) * LDX + wn + j * 8 + gq];
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NI; ++j) dmma_16x8x4(acc[i][j], af[i][0], af[i][1], bf[j]);
      }
    }
    cp_async_wait<0>();

    const bool whole = kb == 0 && ke == s;
    double* dst = whole ? c : part + (size_t)(2 * blk + (first ? 0 : 1)) * FM * FN;
    const int ld = whole ? ldc : FN, r0 = whole ? m0 : 0, c0 = whole ? n0 : 0;
    const int rend = whole ? mend : FM, cend = whole ? nend : FN;
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int r = r0 + wm + i * 16 + gq;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int col = c0 + wn + j * 8 + 2 * tq;
        if (col >= cend) continue;
        if (r < rend)
          *reinterpret_cast<double2*>(dst + (size_t)r * ld + col) =
              make_double2(acc[i][j][0], acc[i][j][1]);
        if (r + 8 < rend)
          *reinterpret_cast<double2*>(dst + (size_t)(r + 8) * ld + col) =
              make_double2(acc[i][j][2], acc[i][j][3]);
      }
    }
    first = false;
    it = pu + ke;
    if (++y == Y && t + 1 < T) {
      y = 0;
      base += (long)Y * s;
      s = fold_steps<K1A>(++t, n);
    }
  }
}

// Rows [FIX_ROWS z, FIX_ROWS (z + 1)) of output tile (t, y): a split
// tile is the sum of its blocks' parts in block order; a tile past the T
// active ones is zero; a whole one was stored by its block.
template <bool K1A>
__global__ void __launch_bounds__(FTHREADS)
gp_fold_fixup_kernel(const double* __restrict__ part, double* __restrict__ c, int cap,
                     int B, int n, int T, int Y, long iters, int G) {
  const int t = blockIdx.x, y = blockIdx.y, z = blockIdx.z;
  const int m0 = K1A ? t * FM : y * FM, n0 = K1A ? y * FN : t * FN;
  const int mend = K1A ? cap : B, nend = K1A ? B : cap, ldc = K1A ? B : cap;
  int g0 = 0, g1 = -1;
  long pu = 0;
  if (t < T) {
    for (int u = 0; u < t; ++u) pu += (long)Y * fold_steps<K1A>(u, n);
    const int s = fold_steps<K1A>(t, n);
    pu += (long)y * s;
    g0 = split_block(pu, iters, G);
    g1 = split_block(pu + s - 1, iters, G);
    if (g0 == g1) return;
  }
  constexpr int PER = FIX_ROWS * FN / 2 / FTHREADS;   // double2 per thread
  double2 v[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) v[u] = make_double2(0.0, 0.0);
  for (int g = g0; g <= g1; ++g) {
    const int slot = split_begin(g, iters, G) >= pu ? 0 : 1;
    const double2* src = reinterpret_cast<const double2*>(
        part + ((size_t)(2 * g + slot) * FM + z * FIX_ROWS) * FN);
    double2 p[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u) p[u] = src[threadIdx.x + u * FTHREADS];
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      v[u].x += p[u].x;
      v[u].y += p[u].y;
    }
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = threadIdx.x + u * FTHREADS;
    const int r = m0 + z * FIX_ROWS + e / (FN / 2), col = n0 + 2 * (e % (FN / 2));
    if (r < mend && col < nend) *reinterpret_cast<double2*>(c + (size_t)r * ldc + col) = v[u];
  }
}

// ---------------------------------------------------------------------------
// Tell form of K1a: w[p, :] = L^-1[p, 0..p] . K12[0..p, :], one warp per
// pair of rows (p, n - 1 - p); rows >= n are written as zeros.
// ---------------------------------------------------------------------------
template <int NB>
__device__ __forceinline__ void tell_step(double (&acc)[NB], double2 l, const double2* kv) {
  double k[2 * NB];   // K12 rows 2c and 2c + 1: 2 NB contiguous doubles
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const double2 v = __ldg(kv + j);
    k[2 * j] = v.x;
    k[2 * j + 1] = v.y;
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b] = fma(l.y, k[NB + b], fma(l.x, k[b], acc[b]));
}

template <int NB>
__global__ void __launch_bounds__(TELL_THREADS)
gp_w_tell_kernel(const double* __restrict__ lib, const double* __restrict__ k12,
                 double* __restrict__ w, int cap, int n) {
  const int gw = (blockIdx.x * TELL_THREADS + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  const double2* kv = reinterpret_cast<const double2*>(k12);
  if (gw < (n + 1) / 2) {
    for (int h = 0; h < 2; ++h) {
      const int p = h == 0 ? gw : n - 1 - gw;
      if (h == 1 && p == gw) break;
      // double2 chunks covering columns 0..p; an odd p + 1 reads L[p, p + 1]
      // = 0 (< cap, which is even) against K12 row p + 1 <= n (zero).
      const int nch = (p + 2) / 2;
      const double2* row = reinterpret_cast<const double2*>(lib + (size_t)p * cap);
      double acc[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) acc[b] = 0.0;
      int ch = lane;
      for (; ch + 96 < nch; ch += 128) {
        double2 l[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) l[u] = __ldg(row + ch + 32 * u);
#pragma unroll
        for (int u = 0; u < 4; ++u) tell_step<NB>(acc, l[u], kv + (size_t)(ch + 32 * u) * NB);
      }
      for (; ch < nch; ch += 32) tell_step<NB>(acc, __ldg(row + ch), kv + (size_t)ch * NB);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const double s = warp_sum(acc[b]);
        if (lane == b) w[(size_t)p * NB + b] = s;
      }
    }
  }
  const int stride = gridDim.x * TELL_THREADS;
  for (int e = blockIdx.x * TELL_THREADS + threadIdx.x; e < (cap - n) * NB; e += stride)
    w[(size_t)n * NB + e] = 0.0;
}

// ---------------------------------------------------------------------------
// Tell form of K1b.  Pass 1: block (column chunk, panel) sums rows
// max(panel start, j) <= i < panel end of w[i, b] L^-1[i, j] for its PCOLS
// columns into part[panel, b, j]; a block whose rows all lie above its
// columns exits without writing.  Pass 2: g[b, j] = the sum over panels
// j / PANEL .. npanels - 1 (exactly the panels that hold a row >= j), in
// panel order; g[b, j >= n] = 0.
// ---------------------------------------------------------------------------
template <int NB>
__global__ void __launch_bounds__(TELL_THREADS)
gp_g_tell_partial_kernel(const double* __restrict__ w, const double* __restrict__ lib,
                         double* __restrict__ part, int cap, int n, int jpad) {
  const int j0 = blockIdx.x * PCOLS, p = blockIdx.y;
  const int r0 = p * PANEL, r1 = min(r0 + PANEL, n);
  if (r1 - 1 < j0) return;
  const int j = j0 + 2 * threadIdx.x;
  double acc[NB][2];
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b][0] = acc[b][1] = 0.0;
  if (j < cap) {
    const double* col = lib + j;
    int i = max(r0, j);   // L^-1[i, j] = 0 for i < j; L^-1[j, j + 1] = 0
    for (; i + 3 < r1; i += 4) {
      double2 l[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        l[u] = __ldg(reinterpret_cast<const double2*>(col + (size_t)(i + u) * cap));
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const double wv = __ldg(w + (size_t)(i + u) * NB + b);
          acc[b][0] = fma(wv, l[u].x, acc[b][0]);
          acc[b][1] = fma(wv, l[u].y, acc[b][1]);
        }
    }
    for (; i < r1; ++i) {
      const double2 l = __ldg(reinterpret_cast<const double2*>(col + (size_t)i * cap));
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const double wv = __ldg(w + (size_t)i * NB + b);
        acc[b][0] = fma(wv, l.x, acc[b][0]);
        acc[b][1] = fma(wv, l.y, acc[b][1]);
      }
    }
  }
#pragma unroll
  for (int b = 0; b < NB; ++b)
    *reinterpret_cast<double2*>(part + ((size_t)p * NB + b) * jpad + j) =
        make_double2(acc[b][0], acc[b][1]);
}

template <int NB>
__global__ void __launch_bounds__(TELL_THREADS)
gp_g_tell_reduce_kernel(const double* __restrict__ part, double* __restrict__ g, int cap,
                        int n, int npanels, int jpad) {
  const int e = blockIdx.x * TELL_THREADS + threadIdx.x;
  if (e >= NB * cap) return;
  const int b = e / cap, j = e % cap;
  double s = 0.0;
  if (j < n) {
    const double* src = part + (size_t)b * jpad + j;
    const size_t step = (size_t)NB * jpad;
    int p = j / PANEL;
    for (; p + 7 < npanels; p += 8) {
      double v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = src[(p + u) * step];
#pragma unroll
      for (int u = 0; u < 8; ++u) s += v[u];
    }
    for (; p < npanels; ++p) s += src[p * step];
  }
  g[e] = s;
}

// ---------------------------------------------------------------------------
// K2: per candidate p, mu[t] = sum_{j < n} rbf(xq[p], xs[j]) alpha[j, t] for
// the 2 objectives, denormalised mu * ymd[1] + ymd[0], then the EHVI sum
// over the (3, S) staircase rows lows / ups / levels.  Pass 1 writes
// part[g, p, t], the sum over row split g; pass 2 adds the splits and
// sweeps the staircase.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

// The first step of row split g of G over `steps` steps of EHVI_STEP rows
// (gp_ops.ehvi_split): equal runs of whole steps, none empty for G <= steps.
__host__ __device__ __forceinline__ int ehvi_split_step(int g, int steps, int G) {
  return (int)((long)g * steps / G);
}

// Block (c, g): candidates c EHVI_TILE .. + 63 against the rows of split g.
// Warp w takes candidates 16 (w % 4) .. + 15 and rows 32 (w / 4) .. + 31
// of each staged step: four m16n8k4 DMMA tiles per 4-deep slice of d
// (padded to dp, a multiple of 4, with zeros), which leave lane (gq, tq)
// the dot products of candidates gq, gq + 8 with rows 8 j + 2 tq, + 1.
// Stages hold rows as [row][ld] and candidates as [candidate][ld], ld = 4
// mod 16 doubles, so fragment loads are free of bank conflicts.
__global__ void __launch_bounds__(EHVI_THREADS, EHVI_BLOCKS_PER_SM)
gp_ehvi_partial_kernel(const double* __restrict__ xq, const double* __restrict__ xs,
                       const double* __restrict__ alpha, double* __restrict__ part, int P,
                       int d, int n, double scale, double signal) {
  extern __shared__ __align__(16) double ehvi_smem[];
  const int dp = ehvi_dpad(d), ld = ehvi_ld(d);
  // a stage: s_x [row][ld], s_a [row][2], s_xn [row]
  const int stage_len = EHVI_STEP * (ld + 3);
  double* s_q = ehvi_smem + 2 * stage_len;   // [candidate][ld]
  double* s_qn = s_q + EHVI_TILE * ld;
  double* s_red = s_qn + EHVI_TILE;          // [row half][candidate][2]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int ca = (warp & 3) * 16 + gq, wr = warp >> 2;
  const int c0 = blockIdx.x * EHVI_TILE, g = blockIdx.y;
  const int steps = ceil_div(n, EHVI_STEP);
  const int s0 = ehvi_split_step(g, steps, gridDim.y);
  const int s1 = ehvi_split_step(g + 1, steps, gridDim.y);
  const int hi = min(n, s1 * EHVI_STEP);

  // rows j0 .. j0 + EHVI_STEP - 1 of xs and alpha into stage `buf`; rows
  // >= hi and columns >= d are zero-filled (a zero row adds k * 0 = 0)
  auto stage = [&](int buf, int s) {
    double* sx = ehvi_smem + buf * stage_len;
    double* sa = sx + EHVI_STEP * ld;
    const int j0 = s * EHVI_STEP;
    for (int e = tid; e < EHVI_STEP * dp; e += EHVI_THREADS) {
      const int r = e / dp, f = e - r * dp, j = j0 + r;
      const bool ok = j < hi && f < d;
      cp_async8(sx + r * ld + f, ok ? xs + (size_t)j * d + f : xs, ok ? 8 : 0);
    }
    if (tid < EHVI_STEP) {
      const int j = j0 + tid;
      const bool ok = j < hi;
      cp_async16(sa + 2 * tid, ok ? alpha + 2 * (size_t)j : alpha, ok ? 16 : 0);
    }
  };
  // squared norms of the 64 rows of a [row][ld] stage: 4 lanes a row, each
  // a fixed quarter of the columns, added by a fixed butterfly
  auto norms = [&](const double* sv, double* out) {
    const int r = tid >> 2, q = tid & 3;
    double v2 = 0.0;
    for (int f = q; f < dp; f += 4) {
      const double v = sv[r * ld + f];
      v2 += v * v;
    }
    v2 += __shfl_xor_sync(0xffffffffu, v2, 1);
    v2 += __shfl_xor_sync(0xffffffffu, v2, 2);
    if (q == 0) out[r] = v2;
  };

  for (int e = tid; e < EHVI_TILE * dp; e += EHVI_THREADS) {
    const int c = e / dp, f = e - c * dp, p = c0 + c;
    s_q[c * ld + f] = p < P && f < d ? xq[(size_t)p * d + f] : 0.0;
  }
  if (s0 < s1) stage(0, s0);
  cp_async_commit();
  __syncthreads();
  norms(s_q, s_qn);
  __syncthreads();
  const double qn0 = s_qn[ca], qn1 = s_qn[ca + 8];
  double acc[2][2] = {{0.0, 0.0}, {0.0, 0.0}};   // [candidate ca, ca + 8][objective]

  for (int s = s0; s < s1; ++s) {
    const int buf = (s - s0) & 1;
    if (s + 1 < s1) stage(buf ^ 1, s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // step s has landed
    const double* sx = ehvi_smem + buf * stage_len;
    const double* sa = sx + EHVI_STEP * ld;
    double* sxn = ehvi_smem + buf * stage_len + EHVI_STEP * (ld + 2);
    norms(sx, sxn);
    __syncthreads();
    double c[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) c[j][r] = 0.0;
    for (int k0 = 0; k0 < dp; k0 += 4) {
      const double a0 = s_q[ca * ld + k0 + tq], a1 = s_q[(ca + 8) * ld + k0 + tq];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dmma_16x8x4(c[j], a0, a1, sx[(wr * 32 + j * 8 + gq) * ld + k0 + tq]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wr * 32 + j * 8 + 2 * tq + h;
        const double xn = sxn[r];
        const double2 a = *reinterpret_cast<const double2*>(sa + 2 * r);
        const double k0v = signal * exp(fmax((qn0 + xn) - 2.0 * c[j][h], 0.0) * scale);
        const double k1v = signal * exp(fmax((qn1 + xn) - 2.0 * c[j][2 + h], 0.0) * scale);
        acc[0][0] = fma(k0v, a.x, acc[0][0]);
        acc[0][1] = fma(k0v, a.y, acc[0][1]);
        acc[1][0] = fma(k1v, a.x, acc[1][0]);
        acc[1][1] = fma(k1v, a.y, acc[1][1]);
      }
    __syncthreads();   // stage buf is read before step s + 2 refills it
  }
  cp_async_wait<0>();

  // the 4 lanes of a candidate pair add their sums by a fixed butterfly;
  // the two row halves meet in shared memory and are added in order
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      acc[i][o] += __shfl_xor_sync(0xffffffffu, acc[i][o], 1);
      acc[i][o] += __shfl_xor_sync(0xffffffffu, acc[i][o], 2);
    }
  if (tq == 0)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      s_red[(wr * EHVI_TILE + ca + 8 * i) * 2] = acc[i][0];
      s_red[(wr * EHVI_TILE + ca + 8 * i) * 2 + 1] = acc[i][1];
    }
  __syncthreads();
  if (tid < EHVI_TILE && c0 + tid < P) {
    const double* lo = s_red + 2 * tid;
    const double* up = s_red + 2 * (EHVI_TILE + tid);
    *reinterpret_cast<double2*>(part + 2 * ((size_t)g * P + c0 + tid)) =
        make_double2(lo[0] + up[0], lo[1] + up[1]);
  }
}

__global__ void __launch_bounds__(SWEEP_THREADS)
gp_ehvi_sweep_kernel(const double* __restrict__ part, const double* __restrict__ stair,
                     const double* __restrict__ ymd, double* __restrict__ out, int P, int S,
                     int G) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * (SWEEP_THREADS / 32) + (threadIdx.x >> 5);
  if (p >= P) return;   // uniform across the warp; no barrier follows
  double m0 = 0.0, m1 = 0.0;
  for (int g = lane; g < G; g += 32) {
    const double2 v = *reinterpret_cast<const double2*>(part + 2 * ((size_t)g * P + p));
    m0 += v.x;
    m1 += v.y;
  }
  const double mu0 = warp_sum(m0) * ymd[2] + ymd[0];
  const double mu1 = warp_sum(m1) * ymd[3] + ymd[1];
  double sum = 0.0;
  for (int s = lane; s < S; s += 32) {
    const double width = fmax(stair[S + s] - fmax(stair[s], mu0), 0.0);
    const double height = fmax(stair[2 * (size_t)S + s] - mu1, 0.0);
    sum += width * height;
  }
  sum = warp_sum(sum);
  if (lane == 0) out[p] = sum;
}

// Raises a kernel's dynamic shared memory limit on the current device to
// `bytes` once: `set[device]` remembers the largest size already granted
// there, so a launch does not call cudaFuncSetAttribute again.
constexpr int MAX_DEVICES = 64;

int set_smem(const void* kernel, int bytes, int device, int* set) {
  if (bytes <= set[device]) return 0;
  const int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (!err) set[device] = bytes;
  return err;
}

int fold_smem_set[2][MAX_DEVICES], k12_smem_set[MAX_DEVICES], ehvi_smem_set[MAX_DEVICES];

bool tell_form(int B) { return B == 1 || B == 2 || B == 4 || B == 8; }
bool valid_B(int B) { return tell_form(B) || (B > 0 && B % 16 == 0); }

// Runs `launch` with `device` current, restoring the caller's device.
template <typename F>
int on_device(int device, F launch) {
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  int cur = 0;
  int err = (int)cudaGetDevice(&cur);
  if (err) return err;
  if (cur != device && (err = (int)cudaSetDevice(device))) return err;
  err = launch();
  if (cur != device) cudaSetDevice(cur);
  return err;
}

// Streaming multiprocessors of `device`, read once.
int sm_count(int device) {
  static int count[MAX_DEVICES];
  if (!count[device] &&
      cudaDeviceGetAttribute(&count[device], cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return 0;
  return count[device];
}

// (T, Y, iterations, blocks) of a fold: the active triangle tiles, the
// width tiles, the contraction steps of all of them, and one block per SM
// (fewer where there are fewer steps).
template <bool K1A>
void fold_plan(int B, int n, int device, int* T, int* Y, long* iters, int* G) {
  *T = ceil_div(n, FM);
  *Y = ceil_div(B, FN);
  *iters = 0;
  for (int t = 0; t < *T; ++t) *iters += (long)*Y * fold_steps<K1A>(t, n);
  *G = (int)min((long)sm_count(device), *iters);
}

template <bool K1A>
int launch_fold(const double* a, const double* b, double* c, double* part, int cap, int B,
                int n, int device, cudaStream_t st) {
  int err = set_smem((const void*)gp_fold_kernel<K1A>, FOLD_SMEM, device, fold_smem_set[K1A]);
  if (err) return err;
  int T, Y, G;
  long iters;
  fold_plan<K1A>(B, n, device, &T, &Y, &iters, &G);
  if (iters > 0 && G <= 0) return (int)cudaErrorInvalidDevice;   // no SM count
  if (G > 0) {
    gp_fold_kernel<K1A><<<G, FTHREADS, FOLD_SMEM, st>>>(a, b, c, part, cap, B, n, T, Y, iters);
    if ((err = (int)cudaGetLastError())) return err;
  }
  gp_fold_fixup_kernel<K1A><<<dim3(ceil_div(cap, FM), Y, FM / FIX_ROWS), FTHREADS, 0, st>>>(
      part, c, cap, B, n, T, Y, iters, max(G, 1));
  return (int)cudaGetLastError();
}

template <int NB>
int launch_w_tell(const double* lib, const double* k12, double* w, int cap, int n,
                  cudaStream_t st) {
  const int warps_per_block = TELL_THREADS / 32;
  const int grid = max(1, max(ceil_div((n + 1) / 2, warps_per_block),
                              ceil_div((cap - n) * NB, 4 * TELL_THREADS)));
  gp_w_tell_kernel<NB><<<grid, TELL_THREADS, 0, st>>>(lib, k12, w, cap, n);
  return (int)cudaGetLastError();
}

template <int NB>
int launch_g_tell(const double* w, const double* lib, double* g, double* part, int cap,
                  int n, cudaStream_t st) {
  const int npanels = ceil_div(n, PANEL), jpad = ceil_div(n, PCOLS) * PCOLS;
  if (n > 0) {
    gp_g_tell_partial_kernel<NB><<<dim3(jpad / PCOLS, npanels), TELL_THREADS, 0, st>>>(
        w, lib, part, cap, n, jpad);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  gp_g_tell_reduce_kernel<NB><<<ceil_div(NB * cap, TELL_THREADS), TELL_THREADS, 0, st>>>(
      part, g, cap, n, npanels, jpad);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry returns a cudaError_t: cudaGetLastError() right after each
// launch (0 when every launch was accepted).  Pointers are contiguous
// float64 device buffers on `device`, 16-byte aligned; cap is a multiple
// of 16 and B is 1, 2, 4, 8 (tell) or a multiple of 16 (fold); the stream
// is PyTorch's current stream.  Workspace sizes, in doubles, are those of
// gp_workspace.

// The doubles of workspace a call on `device` needs: which = 0 (K1a: K12,
// n rounded up to FM rows by B, then at a fold the split tiles' parts),
// 1 (K1b: the tell's per-panel partials, or the fold's parts).
long gp_workspace(int which, int cap, int B, int n, int device) {
  if (!valid_B(B) || n < 0 || n > cap || device < 0 || device >= MAX_DEVICES) return -1;
  const long k12 = which == 0 ? (long)ceil_div(n, FM) * FM * B : 0;
  if (tell_form(B))
    return which == 0 ? k12 : (long)ceil_div(n, PANEL) * B * ceil_div(n, PCOLS) * PCOLS;
  int T, Y, G;
  long iters;
  if (which == 0) fold_plan<true>(B, n, device, &T, &Y, &iters, &G);
  else fold_plan<false>(B, n, device, &T, &Y, &iters, &G);
  return k12 + 2L * G * FM * FN;
}

int gp_w(const double* lib, const double* xs, const double* xq, double* w, double* ws,
         long ws_len, int cap, int d, int B, int n, int m, double ls2, double signal,
         int device, void* stream) {
  if (cap <= 0 || cap % 16 || d <= 0 || !valid_B(B) || n < 0 || n > cap || m < 0 || m > B ||
      device < 0 || device >= MAX_DEVICES || ws_len < gp_workspace(0, cap, B, n, device))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> int {
    if (n > 0) {
      const int smem = k12_smem_doubles(d) * (int)sizeof(double);
      int err = set_smem((const void*)gp_k12_kernel, smem, device, k12_smem_set);
      if (err) return err;
      const dim3 grid(ceil_div(n, FM) * FM / K12_ROWS, ceil_div(B, min(B, K12_COLS)));
      gp_k12_kernel<<<grid, K12_THREADS, smem, st>>>(xs, xq, ws, d, B, n, m, ls2, signal);
      if ((err = (int)cudaGetLastError())) return err;
    }
    double* part = ws + (size_t)ceil_div(n, FM) * FM * B;
    switch (B) {
      case 1: return launch_w_tell<1>(lib, ws, w, cap, n, st);
      case 2: return launch_w_tell<2>(lib, ws, w, cap, n, st);
      case 4: return launch_w_tell<4>(lib, ws, w, cap, n, st);
      case 8: return launch_w_tell<8>(lib, ws, w, cap, n, st);
      default: return launch_fold<true>(lib, ws, w, part, cap, B, n, device, st);
    }
  });
}

int gp_g(const double* w, const double* lib, double* g, double* ws, long ws_len, int cap,
         int B, int n, int device, void* stream) {
  if (cap <= 0 || cap % 16 || !valid_B(B) || n < 0 || n > cap || device < 0 ||
      device >= MAX_DEVICES || ws_len < gp_workspace(1, cap, B, n, device))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> int {
    switch (B) {
      case 1: return launch_g_tell<1>(w, lib, g, ws, cap, n, st);
      case 2: return launch_g_tell<2>(w, lib, g, ws, cap, n, st);
      case 4: return launch_g_tell<4>(w, lib, g, ws, cap, n, st);
      case 8: return launch_g_tell<8>(w, lib, g, ws, cap, n, st);
      default: return launch_fold<false>(w, lib, g, ws, cap, B, n, device, st);
    }
  });
}

int gp_ehvi(const double* xq, const double* xs, const double* alpha, const double* stair,
            const double* ymd, double* out, double* ws, long ws_len, int P, int d, int n,
            int S, int splits, double ls2, double signal, int device, void* stream) {
  if (P <= 0 || d <= 0 || n < 0 || S <= 0 || splits < 1 ||
      splits > max(1, ceil_div(n, EHVI_STEP)) || splits > 65535 || ws_len < 2L * splits * P)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> int {
    const int smem = ehvi_smem_doubles(d) * (int)sizeof(double);
    int err = set_smem((const void*)gp_ehvi_partial_kernel, smem, device, ehvi_smem_set);
    if (err) return err;
    gp_ehvi_partial_kernel<<<dim3(ceil_div(P, EHVI_TILE), splits), EHVI_THREADS, smem, st>>>(
        xq, xs, alpha, ws, P, d, n, -0.5 / ls2, signal);
    if ((err = (int)cudaGetLastError())) return err;
    gp_ehvi_sweep_kernel<<<ceil_div(P, SWEEP_THREADS / 32), SWEEP_THREADS, 0, st>>>(
        ws, stair, ymd, out, P, S, splits);
    return (int)cudaGetLastError();
  });
}

// The kernels' shape constants, in this order: fold tile rows, fold tile
// columns, contraction step, fold threads, ring stages, fold shared memory
// bytes, rows per fix-up block, largest tell B, tell threads, K1b tell
// panel rows and columns, K2's candidates per block, rows per step and
// the blocks per SM its split aims at.
void gp_config(int* out) {
  const int v[] = {FM, FN, FK, FTHREADS, FSTAGES, FOLD_SMEM, FIX_ROWS, TELL_MAX_B,
                   TELL_THREADS, PANEL, PCOLS, EHVI_TILE, EHVI_STEP, EHVI_BLOCKS_PER_SM};
  for (int i = 0; i < (int)(sizeof(v) / sizeof(v[0])); ++i) out[i] = v[i];
}

// Dynamic shared memory that depends on the width d, per block: which = 0
// (K1a's K12 prologue), 1 (K1b: none), 2 (K2).  A fold's product and
// fix-up blocks take gp_config's fold bytes whatever d is.
int gp_smem_bytes(int which, int d) {
  const int doubles = which == 0 ? k12_smem_doubles(d) : which == 2 ? ehvi_smem_doubles(d) : 0;
  return doubles * (int)sizeof(double);
}

// The most dynamic shared memory a block may opt into on this device.
int gp_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess)
    return -1;
  return v;
}

const char* gp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

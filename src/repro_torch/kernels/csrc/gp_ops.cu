// K1a, K1b, K2: the incremental GP's tell and ask kernels, float64, for
// Hopper (sm_90a).
//
// Replace the Pallas TPU kernels of repro/kernels/gp_ops.py:
//   K1a gp_w_kernel    <- _w_kernel    (gp_append, w = L^-1 K12)
//   K1b gp_g_kernel    <- _g_kernel    (gp_append, g = w^T L^-1)
//   K2  gp_ehvi_kernel <- _ehvi_kernel (gp_fused_ehvi, predict + EHVI sweep)
// and compute the same functions, in float64, with the same RBF form:
//   d2 = (|a|^2 + |b|^2) - 2 a.b, clamped at 0;  k = signal * exp(-0.5 d2 / ls2)
// (ARD lengthscales arrive as inputs pre-scaled by 1/ls with ls2 = 1).
//
// Buffer invariant the kernels rely on (as the TPU kernels do): L^-1 is
// lower-triangular and its rows and columns >= n are exactly zero.
//
// Design (a first, simple version; DFMA on the CUDA cores, no DMMA):
// * The TPU carries an accumulator across a sequential minor grid axis and
//   skips tiles with pl.when.  Here one block owns an output tile and loops
//   over only the contraction tiles the triangle and n allow, keeping the
//   sums in registers: K1a walks k < min(n, end of its row tile), K1b walks
//   i from its column tile's start to n, K2 walks training rows j < n.
// * n and m are host integers passed by value: no device read, no sync.
// * Tiles: K1a and K1b compute 64 x 64 output tiles with 256 threads, each
//   thread a 4 x 4 patch (rows 4*(t/16)+r, columns t%16 + 16*c), over
//   contraction steps of 16 staged in shared memory.  The B columns of K1a's
//   w (up to 512) go on a second grid dimension, so B = 512 gives 8 column
//   tiles per row tile and the grid fills the 132 SMs.  K1a builds each
//   16 x 64 tile of K12 in shared memory from the staged X rows, never in
//   device memory.  K2 gives one warp to each pool candidate (4 per block):
//   the lanes stride over the training rows staged 128 at a time, and the
//   staircase is read from device memory in strides of 32, so its width S
//   has no bound.  The triangle makes K1a's and K1b's row/column tiles
//   unequal in work; that is recorded, not balanced.
// * Deterministic sums, no atomics: every output is summed by one thread in
//   a fixed order, or by a warp in a fixed lane order and a fixed xor
//   butterfly, so two launches on the same inputs are bitwise equal.
// * float64 exp() throughout; build without --use_fast_math.  The
//   staircase's first `lows` entry is -inf and fmax(-inf, mu) is exact.
//
// What bounds them on an H100 at the search path's size (cap 8192, n <=
// 6250, d = 14): K1a/K1b at B = 1 read the active lower triangle of L^-1
// (n^2/2 * 8 B = 156 MB, ~47 us at 3.35 TB/s: bytes); at B = 512 they do
// 2 * n^2/2 * 512 flop (2.0e10, ~0.30 ms at the 67 TFLOP/s float64 tensor
// rate: operations), so this CUDA-core version is bound far above the
// roofline by its DFMA rate.  K2 at P = 512 is ~1.2e8 flop plus 3.2 M exp
// over < 1 MB: the launch dominates.

#include <cuda_runtime.h>

namespace {

constexpr int TM = 64;     // K1a: rows of w per block; K1b: columns of g
constexpr int TN = 64;     // K1a: columns of w per block; K1b: rows of g
constexpr int TK = 16;     // contraction rows staged per step
constexpr int NT = 256;    // threads per K1a / K1b block
constexpr int WARPS = 4;   // K2: candidates (warps) per block
constexpr int TJ = 128;    // K2: training rows staged per step

__host__ __device__ constexpr int w_smem_doubles(int d) {
  // s_q (TN x d), s_qn (TN), s_x (TK x d), s_xn (TK), s_k (TK x TN),
  // s_l (TM x (TK + 1), padded against bank conflicts)
  return TN * d + TN + TK * d + TK + TK * TN + TM * (TK + 1);
}

__host__ __device__ constexpr int g_smem_doubles() {
  return TK * TN + TK * TM;     // s_w (TK x TN), s_l (TK x TM)
}

__host__ __device__ constexpr int ehvi_smem_doubles(int d) {
  // s_x (TJ x d), s_xn (TJ), s_a (TJ x 2), s_q (WARPS x d)
  return TJ * d + TJ + 2 * TJ + WARPS * d;
}

__device__ __forceinline__ double rbf(double d2, double ls2, double signal) {
  d2 = fmax(d2, 0.0);
  return signal * exp(-0.5 * d2 / ls2);
}

// ---------------------------------------------------------------------------
// K1a: w (cap, B) = L^-1 (cap, cap) @ K12, with K12[k, c] = rbf(xs[k], xq[c])
// for k < n and c < m, else 0.  Row tiles at or past n write zeros.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT)
gp_w_kernel(const double* __restrict__ lib, const double* __restrict__ xs,
            const double* __restrict__ xq, double* __restrict__ w, int cap,
            int d, int B, int n, int m, double ls2, double signal) {
  extern __shared__ double smem[];
  double* s_q = smem;
  double* s_qn = s_q + TN * d;
  double* s_x = s_qn + TN;
  double* s_xn = s_x + TK * d;
  double* s_k = s_xn + TK;
  double* s_l = s_k + TK * TN;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int i0 = blockIdx.x * TM;
  const int c0 = blockIdx.y * TN;
  double acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0;

  const int kend = min(n, i0 + TM);   // lower triangle, active rows only
  if (i0 < n) {
    for (int e = tid; e < TN * d; e += NT) {
      const int c = c0 + e / d;
      s_q[e] = c < B ? xq[(size_t)c0 * d + e] : 0.0;
    }
    if (tid < TN) {
      const int c = c0 + tid;
      double s = 0.0;
      if (c < B)
        for (int f = 0; f < d; ++f) {
          const double v = xq[(size_t)c * d + f];
          s += v * v;
        }
      s_qn[tid] = s;
    }
    for (int k0 = 0; k0 < kend; k0 += TK) {
      __syncthreads();   // the previous step's s_k / s_l are consumed
      for (int e = tid; e < TK * d; e += NT) {
        const int k = k0 + e / d;
        s_x[e] = k < n ? xs[(size_t)k0 * d + e] : 0.0;
      }
      if (tid < TK) {
        const int k = k0 + tid;
        double s = 0.0;
        if (k < n)
          for (int f = 0; f < d; ++f) {
            const double v = xs[(size_t)k * d + f];
            s += v * v;
          }
        s_xn[tid] = s;
      }
      for (int e = tid; e < TM * TK; e += NT) {
        const int r = e / TK, kk = e % TK;
        const int i = i0 + r, k = k0 + kk;
        s_l[r * (TK + 1) + kk] = (i < cap && k < cap) ? lib[(size_t)i * cap + k] : 0.0;
      }
      __syncthreads();
      for (int e = tid; e < TK * TN; e += NT) {
        const int kk = e / TN, c = e % TN;
        double v = 0.0;
        if (k0 + kk < n && c0 + c < m) {
          double dot = 0.0;
          for (int f = 0; f < d; ++f) dot += s_x[kk * d + f] * s_q[c * d + f];
          v = rbf((s_xn[kk] + s_qn[c]) - 2.0 * dot, ls2, signal);
        }
        s_k[e] = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < TK; ++kk) {
        double a[4], b[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = s_l[(ty * 4 + r) * (TK + 1) + kk];
#pragma unroll
        for (int c = 0; c < 4; ++c) b[c] = s_k[kk * TN + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] += a[r] * b[c];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    if (i >= cap) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = c0 + tx + 16 * c;
      if (col < B) w[(size_t)i * B + col] = acc[r][c];
    }
  }
}

// ---------------------------------------------------------------------------
// K1b: g (B, cap) = w^T @ L^-1 over rows i < n.  L^-1[i, j] = 0 for i < j,
// so a column tile starting at j0 sums rows j0 <= i < n; column tiles at or
// past n write zeros.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT)
gp_g_kernel(const double* __restrict__ w, const double* __restrict__ lib,
            double* __restrict__ g, int cap, int B, int n) {
  extern __shared__ double smem[];
  double* s_w = smem;             // [TK][TN]: w rows, this block's B columns
  double* s_l = s_w + TK * TN;    // [TK][TM]: L^-1 rows, this block's columns

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int j0 = blockIdx.x * TM;
  const int c0 = blockIdx.y * TN;
  double acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0;

  for (int k0 = j0; k0 < n; k0 += TK) {
    __syncthreads();
    for (int e = tid; e < TK * TN; e += NT) {
      const int kk = e / TN, x = e % TN;
      const int i = k0 + kk;
      s_w[e] = (i < n && c0 + x < B) ? w[(size_t)i * B + c0 + x] : 0.0;
      s_l[e] = (i < n && j0 + x < cap) ? lib[(size_t)i * cap + j0 + x] : 0.0;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      double a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = s_w[kk * TN + ty * 4 + r];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = s_l[kk * TM + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] += a[r] * b[c];
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = c0 + ty * 4 + r;
    if (row >= B) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      if (j < cap) g[(size_t)row * cap + j] = acc[r][c];
    }
  }
}

// ---------------------------------------------------------------------------
// K2: per candidate p, mu[t] = sum_{j < n} rbf(xq[p], xs[j]) alpha[j, t] for
// the 2 objectives, denormalised mu * ymd[1] + ymd[0], then the EHVI sum
// over the (3, S) staircase rows lows / ups / levels.
// ---------------------------------------------------------------------------
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(WARPS * 32)
gp_ehvi_kernel(const double* __restrict__ xq, const double* __restrict__ xs,
               const double* __restrict__ alpha,
               const double* __restrict__ stair,
               const double* __restrict__ ymd, double* __restrict__ out,
               int P, int d, int n, int S, double ls2, double signal) {
  extern __shared__ double smem[];
  double* s_x = smem;
  double* s_xn = s_x + TJ * d;
  double* s_a = s_xn + TJ;
  double* s_q = s_a + 2 * TJ;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int p = blockIdx.x * WARPS + warp;
  const bool live = p < P;

  for (int e = tid; e < WARPS * d; e += WARPS * 32) {
    const int pp = blockIdx.x * WARPS + e / d;
    s_q[e] = pp < P ? xq[(size_t)pp * d + e % d] : 0.0;
  }
  __syncthreads();
  const double* q = s_q + warp * d;
  double qn = 0.0;
  for (int f = 0; f < d; ++f) qn += q[f] * q[f];

  double acc0 = 0.0, acc1 = 0.0;
  for (int j0 = 0; j0 < n; j0 += TJ) {
    __syncthreads();
    for (int e = tid; e < TJ * d; e += WARPS * 32) {
      const int j = j0 + e / d;
      s_x[e] = j < n ? xs[(size_t)j0 * d + e] : 0.0;
    }
    for (int e = tid; e < TJ; e += WARPS * 32) {
      const int j = j0 + e;
      double s = 0.0;
      if (j < n)
        for (int f = 0; f < d; ++f) {
          const double v = xs[(size_t)j * d + f];
          s += v * v;
        }
      s_xn[e] = s;
      s_a[2 * e] = j < n ? alpha[2 * (size_t)j] : 0.0;
      s_a[2 * e + 1] = j < n ? alpha[2 * (size_t)j + 1] : 0.0;
    }
    __syncthreads();
    if (live) {
      const int jn = min(TJ, n - j0);
      for (int jj = lane; jj < jn; jj += 32) {
        double dot = 0.0;
        for (int f = 0; f < d; ++f) dot += q[f] * s_x[jj * d + f];
        const double k = rbf((qn + s_xn[jj]) - 2.0 * dot, ls2, signal);
        acc0 += k * s_a[2 * jj];
        acc1 += k * s_a[2 * jj + 1];
      }
    }
  }
  if (!live) return;   // no block-wide barrier follows
  const double mu0 = warp_sum(acc0) * ymd[2] + ymd[0];
  const double mu1 = warp_sum(acc1) * ymd[3] + ymd[1];
  double part = 0.0;
  for (int s = lane; s < S; s += 32) {
    const double width = fmax(stair[S + s] - fmax(stair[s], mu0), 0.0);
    const double height = fmax(stair[2 * (size_t)S + s] - mu1, 0.0);
    part += width * height;
  }
  part = warp_sum(part);
  if (lane == 0) out[p] = part;
}

// Raises a kernel's dynamic shared memory limit on the current device to
// `bytes` once: `set[device]` remembers the largest size already granted
// there, so a launch does not call cudaFuncSetAttribute again.
constexpr int MAX_DEVICES = 64;

int set_smem(const void* kernel, int bytes, int* set) {
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev < MAX_DEVICES && bytes <= set[dev]) return 0;
  err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (!err && dev < MAX_DEVICES) set[dev] = bytes;
  return err;
}

int w_smem_set[MAX_DEVICES], g_smem_set[MAX_DEVICES], ehvi_smem_set[MAX_DEVICES];

}  // namespace

extern "C" {

// Each entry returns a cudaError_t: cudaGetLastError() right after the
// launch (0 when it was accepted).  Pointers are contiguous float64 device
// buffers; the stream is PyTorch's current stream.

int gp_w(const double* lib, const double* xs, const double* xq, double* w,
         int cap, int d, int B, int n, int m, double ls2, double signal,
         void* stream) {
  if (cap <= 0 || d <= 0 || B <= 0 || n < 0 || n > cap || m < 0 || m > B)
    return (int)cudaErrorInvalidValue;
  const int smem = w_smem_doubles(d) * (int)sizeof(double);
  int err = set_smem((const void*)gp_w_kernel, smem, w_smem_set);
  if (err) return err;
  const dim3 grid((cap + TM - 1) / TM, (B + TN - 1) / TN);
  gp_w_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      lib, xs, xq, w, cap, d, B, n, m, ls2, signal);
  return (int)cudaGetLastError();
}

int gp_g(const double* w, const double* lib, double* g, int cap, int B, int n,
         void* stream) {
  if (cap <= 0 || B <= 0 || n < 0 || n > cap) return (int)cudaErrorInvalidValue;
  const int smem = g_smem_doubles() * (int)sizeof(double);
  int err = set_smem((const void*)gp_g_kernel, smem, g_smem_set);
  if (err) return err;
  const dim3 grid((cap + TM - 1) / TM, (B + TN - 1) / TN);
  gp_g_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(w, lib, g, cap, B, n);
  return (int)cudaGetLastError();
}

int gp_ehvi(const double* xq, const double* xs, const double* alpha,
            const double* stair, const double* ymd, double* out, int P, int d,
            int n, int S, double ls2, double signal, void* stream) {
  if (P <= 0 || d <= 0 || n < 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const int smem = ehvi_smem_doubles(d) * (int)sizeof(double);
  int err = set_smem((const void*)gp_ehvi_kernel, smem, ehvi_smem_set);
  if (err) return err;
  const dim3 grid((P + WARPS - 1) / WARPS);
  gp_ehvi_kernel<<<grid, WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      xq, xs, alpha, stair, ymd, out, P, d, n, S, ls2, signal);
  return (int)cudaGetLastError();
}

// Dynamic shared memory one block needs: which = 0 (K1a), 1 (K1b), 2 (K2).
int gp_smem_bytes(int which, int d) {
  switch (which) {
    case 0: return w_smem_doubles(d) * (int)sizeof(double);
    case 1: return g_smem_doubles() * (int)sizeof(double);
    case 2: return ehvi_smem_doubles(d) * (int)sizeof(double);
    default: return 0;
  }
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

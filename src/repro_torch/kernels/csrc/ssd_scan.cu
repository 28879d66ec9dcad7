// K4: the Mamba-2 SSD chunked scan (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py::_ssd_kernel (and
// the padding wrapper repro/kernels/ops.py::ssd_scan).  Per chunk of Q
// positions, with cum the chunk-relative inclusive cumsum of a_log:
//
//   y_i    = sum_{j<=i} (c_i . b_j) exp(cum_i - cum_j) dt_j x_j
//            + exp(cum_i) (c_i . state_p)                     for each p
//   state  = state exp(cum_last) + sum_j x_j dt_j exp(cum_last - cum_j) b_j^T
//
// Layout: x, y (B, S, H, P); a_log, dt (B, S, H) fp32; b, c (B, S, N); the
// final state (B, H, P, N) fp32.  The kernel computes its own offsets, so the
// caller needs no transpose, and it masks the ragged last chunk by the real
// length S instead of padding it (the reference's pads have dt = 0 and
// a_log = 0, so they change neither y nor the state).
//
// Design (a first, simple version): one block of 256 threads per (batch,
// head) walks the chunks in order, in place of the TPU grid's sequential
// chunk axis; the (P, N) state stays in shared memory between chunks.  A
// chunk is cut into 64-row tiles: for each row tile i the block stages
// C_i, starts its 64 x P accumulator from the incoming state's term, then
// for each column tile j <= i stages B_j and X_j, forms the 64 x 64 score
// tile (masked by j <= i before the exp, so exp never sees cum_i - cum_j > 0)
// and adds S @ X_j.  The state update then walks the column tiles once more.
// Everything is fp32 FMAs on the CUDA cores; no tensor cores, TMA or
// pipelining.  Shared memory: 2 Q + P (N+1) + 2 * 64 (N+1) + 64 P + 64 * 65
// floats, 134,144 B at P = 64, N = 128, Q = 256.  C.B^T is the same for all
// heads of a (batch, chunk) and is recomputed per head.  Sums run in a fixed
// order with no atomics, so two launches on the same inputs are bitwise equal.
//
// What bounds it on an H100: at the Engine's prefill the card's least time is
// the bytes (9.7 MB against 0.46 GFLOP), but this version's fp32 FMAs run at
// one 132.6 KB block (8 warps) per SM, too few warps to hide the shared-memory
// loads that feed them; the grid is B * H blocks (192 at the Engine's
// prefill, two waves; 48 at a slot prefill) on 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;     // threads per block: 16 x 16
constexpr int TILE = 64;    // rows of a chunk tile
constexpr int MAX_N = 128;  // largest state dim

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Shared memory, in floats: cum and dt of the chunk, the state (rows of N+1),
// C and B row tiles (rows of N+1), the X tile, the score tile (rows of 65).
__host__ __device__ inline int smem_floats(int P, int N, int Q) {
  return 2 * Q + P * (N + 1) + 2 * TILE * (N + 1) + TILE * P + TILE * (TILE + 1);
}

// Stage rows [r0, r0 + nrows) of a (S, width) row-major slab (row stride
// `stride` elements) into dst (rows of `ld` floats), scaled by scale[r] when
// given; rows past nrows are zero.  width is a power of two, 1 << lg.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const T* src, long stride,
                                           int r0, int nrows, int lg, const float* scale) {
  const int width = 1 << lg;
  for (int e = threadIdx.x; e < TILE * width; e += NT) {
    const int r = e >> lg, col = e & (width - 1);
    float v = 0.f;
    if (r < nrows) {
      v = load_f32(src + (long)(r0 + r) * stride + col);
      if (scale) v *= scale[r];
    }
    dst[r * ld + col] = v;
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(NT)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ a_log,
                const T* __restrict__ bm, const T* __restrict__ cm,
                const float* __restrict__ dt, T* __restrict__ y,
                float* __restrict__ state_out, int S, int H, int lgN, int Q) {
  constexpr int PC = P / 16;                 // accumulator columns per thread
  constexpr int SE = P * MAX_N / NT;         // most state elements per thread
  constexpr int LGP = P == 16 ? 4 : P == 32 ? 5 : P == 64 ? 6 : 7;
  static_assert((1 << LGP) == P, "P must be 16, 32, 64 or 128");
  const int N = 1 << lgN;
  const int NS = N + 1;
  extern __shared__ float smem[];
  float* sCum = smem;
  float* sDt = sCum + Q;
  float* sState = sDt + Q;
  float* sC = sState + P * NS;
  float* sB = sC + TILE * NS;
  float* sX = sB + TILE * NS;
  float* sS = sX + TILE * P;
  float* sScale = sS;  // the state update reuses the score tile for x's scale

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const int ti = tid >> 4;   // accumulator rows ti + 16 r
  const int tj = tid & 15;   // accumulator columns tj + 16 c
  // state elements of this thread: column n_t, rows p0 + k * pstep
  const int n_t = tid & (N - 1);
  const int p0 = tid >> lgN;
  const int pstep = NT >> lgN;

  const long xstride = (long)H * P;          // x, y: between positions
  const T* xb = x + (long)b * S * xstride + (long)h * P;
  T* yb = y + (long)b * S * xstride + (long)h * P;
  const float* ab = a_log + (long)b * S * H + h;
  const float* db = dt + (long)b * S * H + h;
  const T* bb = bm + (long)b * S * N;
  const T* cb = cm + (long)b * S * N;

  for (int e = tid; e < P * NS; e += NT) sState[e] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int L = min(Q, S - c0);            // real rows of this chunk
    __syncthreads();                         // the last chunk's readers are done
    if (tid < 32) {                          // warp 0: inclusive scan of a_log
      float carry = 0.f;
      for (int base = 0; base < L; base += 32) {
        const int r = base + tid;
        float v = r < L ? ab[(long)(c0 + r) * H] : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, off);
          if (tid >= off) v += u;
        }
        v += carry;
        if (r < L) sCum[r] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    for (int r = tid; r < L; r += NT) sDt[r] = db[(long)(c0 + r) * H];
    __syncthreads();
    const float total = sCum[L - 1];

    // ---- y, one 64-row tile at a time
    for (int i0 = 0; i0 < L; i0 += TILE) {
      __syncthreads();                       // sC's last readers are done
      stage_rows(sC, NS, cb, N, c0 + i0, min(TILE, L - i0), lgN, nullptr);
      __syncthreads();
      float acc[4][PC];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < PC; ++c) acc[r][c] = 0.f;
      // the incoming state: exp(cum_i) * (c_i . state_p)
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[PC];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = sC[(ti + 16 * r) * NS + n];
#pragma unroll
        for (int c = 0; c < PC; ++c) sv[c] = sState[(tj + 16 * c) * NS + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < PC; ++c) acc[r][c] = fmaf(cv[r], sv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ti + 16 * r;
        const float dec = i < L ? expf(sCum[i]) : 0.f;
#pragma unroll
        for (int c = 0; c < PC; ++c) acc[r][c] *= dec;
      }
      // intra-chunk: the column tiles j0 <= i0
      for (int j0 = 0; j0 <= i0; j0 += TILE) {
        const int lj = min(TILE, L - j0);
        __syncthreads();                     // sB, sX, sS's last readers are done
        stage_rows(sB, NS, bb, N, c0 + j0, lj, lgN, nullptr);
        stage_rows(sX, P, xb, xstride, c0 + j0, lj, LGP, nullptr);
        __syncthreads();
        float sc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) sc[r][q] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = sC[(ti + 16 * r) * NS + n];
#pragma unroll
          for (int q = 0; q < 4; ++q) bv[q] = sB[(tj + 16 * q) * NS + n];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) sc[r][q] = fmaf(cv[r], bv[q], sc[r][q]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ti + 16 * r;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = j0 + tj + 16 * q;
            // select before the exp: above the diagonal cum_i - cum_j > 0
            float v = 0.f;
            if (i < L && j <= i) v = sc[r][q] * expf(sCum[i] - sCum[j]) * sDt[j];
            sS[(ti + 16 * r) * (TILE + 1) + tj + 16 * q] = v;
          }
        }
        __syncthreads();
        for (int jj = 0; jj < lj; ++jj) {
          float sv[4], xv[PC];
#pragma unroll
          for (int r = 0; r < 4; ++r) sv[r] = sS[(ti + 16 * r) * (TILE + 1) + jj];
#pragma unroll
          for (int c = 0; c < PC; ++c) xv[c] = sX[jj * P + tj + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < PC; ++c) acc[r][c] = fmaf(sv[r], xv[c], acc[r][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ti + 16 * r;
        if (i >= L) continue;
#pragma unroll
        for (int c = 0; c < PC; ++c)
          store_f32(yb + (long)(c0 + i) * xstride + tj + 16 * c, acc[r][c]);
      }
    }

    // ---- state = state * exp(total) + sum_j (x_j dt_j exp(total - cum_j)) b_j^T
    float sacc[SE];
#pragma unroll
    for (int k = 0; k < SE; ++k) sacc[k] = 0.f;
    for (int j0 = 0; j0 < L; j0 += TILE) {
      const int lj = min(TILE, L - j0);
      __syncthreads();                       // sB, sX, sScale's last readers are done
      for (int r = tid; r < lj; r += NT)
        sScale[r] = sDt[j0 + r] * expf(total - sCum[j0 + r]);
      __syncthreads();
      stage_rows(sB, NS, bb, N, c0 + j0, lj, lgN, nullptr);
      stage_rows(sX, P, xb, xstride, c0 + j0, lj, LGP, sScale);
      __syncthreads();
      for (int jj = 0; jj < lj; ++jj) {
        const float bv = sB[jj * NS + n_t];
#pragma unroll
        for (int k = 0; k < SE; ++k) {
          const int p = p0 + k * pstep;
          if (p < P) sacc[k] = fmaf(sX[jj * P + p], bv, sacc[k]);
        }
      }
    }
    const float et = expf(total);
#pragma unroll
    for (int k = 0; k < SE; ++k) {
      const int p = p0 + k * pstep;
      if (p < P) sState[p * NS + n_t] = sState[p * NS + n_t] * et + sacc[k];
    }
  }

  // Each thread writes the state elements it owns (no barrier needed).
  float* so = state_out + ((long)b * H + h) * P * N;
#pragma unroll
  for (int k = 0; k < SE; ++k) {
    const int p = p0 + k * pstep;
    if (p < P) so[(long)p * N + n_t] = sState[p * NS + n_t];
  }
}

template <typename T, int P>
int launch(const void* x, const void* a_log, const void* b, const void* c, const void* dt,
           void* y, void* state, int B, int S, int H, int lgN, int Q, cudaStream_t stream) {
  const int smem = smem_floats(P, 1 << lgN, Q) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<T, P><<<B * H, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(a_log), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const float*>(dt), static_cast<T*>(y),
      static_cast<float*>(state), S, H, lgN, Q);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_p(int P, const void* x, const void* a_log, const void* b, const void* c,
             const void* dt, void* y, void* state, int B, int S, int H, int lgN, int Q,
             cudaStream_t st) {
  switch (P) {
    case 16: return launch<T, 16>(x, a_log, b, c, dt, y, state, B, S, H, lgN, Q, st);
    case 32: return launch<T, 32>(x, a_log, b, c, dt, y, state, B, S, H, lgN, Q, st);
    case 64: return launch<T, 64>(x, a_log, b, c, dt, y, state, B, S, H, lgN, Q, st);
    case 128: return launch<T, 128>(x, a_log, b, c, dt, y, state, B, S, H, lgN, Q, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int log2_exact(int v) {
  int lg = 0;
  while ((1 << lg) < v) ++lg;
  return (1 << lg) == v ? lg : -1;
}

}  // namespace

extern "C" {

// dtype (of x, b, c and y): 0 = float32, 1 = bfloat16.  Launches on
// `device` (made current for the launch when it is not, then restored) and
// `stream`.  Returns a cudaError_t: the result of cudaGetLastError() right
// after the launch (0 when it was accepted).
int ssd_scan_fwd(const void* x, const void* a_log, const void* b, const void* c,
                 const void* dt, void* y, void* state, int dtype, int B, int S, int H,
                 int P, int N, int Q, int device, void* stream) {
  const int lgN = log2_exact(N);
  if (B <= 0 || S <= 0 || H <= 0 || Q <= 0 || Q > 256 || lgN < 4 || N > MAX_N ||
      (long)B * H > 2147483647L || (dtype != 0 && dtype != 1) || device < 0)
    return (int)cudaErrorInvalidValue;
  int cur = 0;
  int err = (int)cudaGetDevice(&cur);
  if (err) return err;
  if (cur != device && (err = (int)cudaSetDevice(device))) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = dtype == 0
            ? launch_p<float>(P, x, a_log, b, c, dt, y, state, B, S, H, lgN, Q, st)
            : launch_p<__nv_bfloat16>(P, x, a_log, b, c, dt, y, state, B, S, H, lgN, Q, st);
  if (cur != device) cudaSetDevice(cur);
  return err;
}

// Dynamic shared memory one block needs (0 if the sizes are unsupported).
int ssd_scan_smem_bytes(int P, int N, int Q) {
  if (log2_exact(P) < 4 || P > 128 || log2_exact(N) < 4 || N > MAX_N || Q <= 0 || Q > 256)
    return 0;
  return smem_floats(P, N, Q) * (int)sizeof(float);
}

// The most dynamic shared memory a block may opt into on this device.
int ssd_scan_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess)
    return -1;
  return v;
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// K3: causal / sliding-window GQA flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::_flash_kernel
// (and the layout/padding wrapper repro/kernels/ops.py::flash_attention).
// It computes the same function: scale d**-0.5, causal mask with an optional
// sliding window, query head h reading KV head h / (H / Hkv), fp32 running
// max / sum / accumulator with the online-softmax update, output in the input
// dtype.
//
// Layout: q, o (B, S, H, D) and k, v (B, S, Hkv, D), contiguous; the kernel
// computes its own offsets, so the caller needs no transpose and no padding
// copy (the ragged sequence edge is masked by the real length S).
//
// Design (a first, simple version): one block of 128 threads per
// (q tile of BQ = 64 rows, batch * head).  The block walks the KV tiles
// (BKV = 64 keys) from the first one the window can reach to the causal
// frontier only, in place of the TPU grid's walk-and-skip.  Q, K, V tiles are
// staged in shared memory as fp32 (rows padded by one float against bank
// conflicts); scores and the P @ V product are fp32 FMAs on the CUDA cores.
// Thread t owns rows 4*(t/8) .. 4*(t/8)+3 and columns (t%8) + 8*j of both the
// score tile and the output accumulator, so the row statistics reduce over 8
// neighbouring lanes with shuffles.  Tiles are fixed: the TPU kernel's block
// sizes (128..512 rows) do not fit a Hopper block's shared memory at D=128.
//
// What bounds it on an H100: at the serving path's prompt lengths (S=64) the
// work is a few MFLOP and the grid (S/64 * B*H blocks) does not fill the 132
// SMs, so launch and latency dominate; at long prompts it is bound by
// operations, and since this version does not use the tensor cores (no
// mma/wgmma, no TMA, no pipelining) it runs far below the bf16 roofline.
// The q tiles are issued heaviest-first so long causal rows start early.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BKV = 64;           // keys per KV tile
constexpr int NT = 128;           // threads per block: 16 row groups x 8 lanes
constexpr float NEG_INF = -1e30f; // the reference kernel's mask value

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
constexpr int smem_floats() {
  // sQ, sK: rows of D+1 floats; sV: rows of D; sP: rows of BKV+1.
  return BQ * (D + 1) + BKV * (D + 1) + BKV * D + BQ * (BKV + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int H,
                 int Hkv, int causal, int window, float scale) {
  static_assert(D % 8 == 0, "head dim must be a multiple of 8");
  constexpr int DJ = D / 8;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * (D + 1);
  float* sV = sK + BKV * (D + 1);
  float* sP = sV + BKV * D;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int rg = tid >> 3;  // row group: rows 4*rg .. 4*rg+3 of the tile
  const int cl = tid & 7;   // lane within the row group

  const long q_stride = (long)H * D;     // between consecutive positions
  const long kv_stride = (long)Hkv * D;
  const T* qb = q + (long)b * S * q_stride + (long)h * D;
  const T* kb = k + (long)b * S * kv_stride + (long)hk * D;
  const T* vb = v + (long)b * S * kv_stride + (long)hk * D;
  T* ob = o + (long)b * S * q_stride + (long)h * D;

  // Q tile, pre-scaled as the reference kernel does; rows past S are zero.
  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, c = e % D, s = q0 + r;
    sQ[r * (D + 1) + c] = s < S ? load_f32(qb + s * q_stride + c) * scale : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // KV tiles that any row of this q tile can reach.
  const int last_q = min(q0 + BQ, S) - 1;
  const int kv_hi = causal ? last_q : S - 1;
  const int kv_lo = window ? max(0, q0 - window + 1) : 0;

  for (int t = kv_lo / BKV; t <= kv_hi / BKV; ++t) {
    const int k0 = t * BKV;
    __syncthreads();  // the previous tile's sK / sV / sP reads are done
    for (int e = tid; e < BKV * D; e += NT) {
      const int r = e / D, c = e % D, s = k0 + r;
      const bool in = s < S;
      sK[r * (D + 1) + c] = in ? load_f32(kb + s * kv_stride + c) : 0.f;
      sV[r * D + c] = in ? load_f32(vb + s * kv_stride + c) : 0.f;
    }
    __syncthreads();

    // Scores S = (q * scale) . k for this thread's 4 x 8 entries.
    float sc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; ++kk) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(4 * rg + i) * (D + 1) + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = sK[(cl + 8 * j) * (D + 1) + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

    // Mask, then the online-softmax update of each of the 4 rows.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * rg + i;
      bool ok[8];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + cl + 8 * j;
        ok[j] = col < S && (!causal || col <= row) && (!window || row - col < window);
        if (ok[j]) mx = fmaxf(mx, sc[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // A masked entry contributes 0.  (The reference adds exp(0) for a
        // row with nothing unmasked yet; its alpha later zeroes that, so
        // the results agree for every row that attends to any key.)
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        sum += p;
        sP[(4 * rg + i) * (BKV + 1) + cl + 8 * j] = p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += P @ V for this thread's 4 rows x DJ columns.
#pragma unroll 2
    for (int j = 0; j < BKV; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(4 * rg + i) * (BKV + 1) + j];
#pragma unroll
      for (int c = 0; c < DJ; ++c) {
        const float vv = sV[j * D + cl + 8 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * rg + i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DJ; ++c)
      store_f32(ob + row * q_stride + cl + 8 * c, acc[i][c] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int Hkv, int causal, int window, float scale,
           cudaStream_t stream) {
  const int smem = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, Hkv, causal, window,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* o,
             int B, int S, int H, int Hkv, int causal, int window, float scale,
             cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, H, Hkv, causal, window, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, Hkv, causal, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, Hkv, causal, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, Hkv, causal, window, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t: the result of
// cudaGetLastError() right after the launch (0 when it was accepted).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int B, int S, int H, int Hkv, int D,
                        int causal, int window, float scale, void* stream) {
  if (S <= 0 || B <= 0 || Hkv <= 0 || H % Hkv != 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(D, q, k, v, o, B, S, H, Hkv, causal, window, scale, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, o, B, S, H, Hkv, causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory one block needs at head dim D (0 if D is unsupported).
int flash_attention_smem_bytes(int D) {
  switch (D) {
    case 16: return smem_floats<16>() * (int)sizeof(float);
    case 32: return smem_floats<32>() * (int)sizeof(float);
    case 64: return smem_floats<64>() * (int)sizeof(float);
    case 128: return smem_floats<128>() * (int)sizeof(float);
    default: return 0;
  }
}

// The most dynamic shared memory a block may opt into on this device.
int flash_attention_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess)
    return -1;
  return v;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// K3: causal / sliding-window GQA flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::_flash_kernel
// (and the layout/padding wrapper repro/kernels/ops.py::flash_attention).
// It computes the same function: scale d**-0.5, causal mask with an optional
// sliding window, query head h reading KV head h / (H / Hkv), fp32 running
// max / sum / accumulator with the online-softmax update, output in the input
// dtype.
//
// Layout: q, o (B, S, H, D) and k, v (B, S, Hkv, D), contiguous; the kernels
// address them in place, so the caller needs no transpose and no padding copy
// (the ragged sequence edge is masked by the real length S).
//
// What bounds it on an H100: at the serving path's prompts (S = 64) the
// bytes (q, k, v read once, o written once: about 2 MB, 0.6 us at 3.35 TB/s)
// and the latency of one short pass; at long prompts the operations
// (4 * H * D flops per attended (query, key) pair, 0.035 ms at
// (1, 2048, 32, 32, 128) at 989 TFLOP/s).
//
// bf16 (the serving path): one block per (64-row q tile, batch * head), the
// q tiles heaviest-first.  Warps 0-3 are one consumer warpgroup; warp 4 is
// the producer.  The producer's first lane loads the Q tile and then the K
// and V tiles of BN keys, each into a ring of STAGES slots, with TMA
// (cp.async.bulk.tensor; per slot one mbarrier that completes on the bytes
// and one the consumers arrive on when they are done with it), so copies
// run ahead of the math; TMA's zero fill covers the rows past S.  The
// consumers compute S = Q K^T with wgmma (bf16 in, fp32 accumulate, both
// operands K-major in swizzled shared memory), scale and mask the fp32
// scores (masks only on tiles that straddle the diagonal, the window's
// lower edge or the sequence end), keep the running max and sum in fp32
// registers, and add P V with two register-A wgmmas: one on
// P_hi = bf16(P), one on P_lo = bf16(P - P_hi), so P keeps about 16
// significant bits and the output stays within one bf16 rounding of the
// fp32 computation (P rounded once to bf16 does not).  V is the B operand
// read with the transpose bit (D is its contiguous axis).  S of tile i + 1
// and P V of tile i go to the tensor cores together, and tile i + 1's
// softmax runs on the CUDA cores while P V is on the tensor cores.
// Shared-memory rows are one swizzle span (128, 64 or 32 bytes: D = 128 is
// two column chunks of 64).  The tiles are fixed (Tile<D>): 64 query rows,
// so a 64-token prompt wastes no rows and B * H blocks fill the SMs, and 64
// keys, to keep the S, P and O fragments in registers (83,016 B of shared
// memory at D = 128: two blocks per SM).
//
// fp32 (tests and the small fp32 reference, not the serving path): the
// CUDA-core kernel of the first port, 64 x 64 tiles staged in shared memory
// as fp32, scores and P V as fp32 FMAs.  TF32 tensor cores would miss the
// fp32 tolerance (2e-5).

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;  // the reference kernel's mask value
constexpr int MAX_DEVICES = 64;

// ---------------------------------------------------------------------------
// fp32: the CUDA-core kernel
// ---------------------------------------------------------------------------

namespace fp32 {

constexpr int BQ = 64;    // query rows per block
constexpr int BKV = 64;   // keys per KV tile
constexpr int NT = 128;   // threads per block: 16 row groups x 8 lanes

template <int D>
constexpr int smem_bytes() {
  // sQ, sK: rows of D+1 floats; sV: rows of D; sP: rows of BKV+1.
  return (BQ * (D + 1) + BKV * (D + 1) + BKV * D + BQ * (BKV + 1)) * 4;
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_fp32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, int S, int H,
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
  const float* qb = q + (long)b * S * q_stride + (long)h * D;
  const float* kb = k + (long)b * S * kv_stride + (long)hk * D;
  const float* vb = v + (long)b * S * kv_stride + (long)hk * D;
  float* ob = o + (long)b * S * q_stride + (long)h * D;

  // Q tile, pre-scaled as the reference kernel does; rows past S are zero.
  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, c = e % D, s = q0 + r;
    sQ[r * (D + 1) + c] = s < S ? qb[s * q_stride + c] * scale : 0.f;
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
      sK[r * (D + 1) + c] = in ? kb[s * kv_stride + c] : 0.f;
      sV[r * D + c] = in ? vb[s * kv_stride + c] : 0.f;
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
    for (int c = 0; c < DJ; ++c) ob[row * q_stride + cl + 8 * c] = acc[i][c] / denom;
  }
}

}  // namespace fp32

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma) fed by TMA
// ---------------------------------------------------------------------------

namespace hopper {

constexpr int CONSUMERS = 128;          // one warpgroup: 64 query rows
constexpr int THREADS = CONSUMERS + 32; // and one producer warp

template <int D>
struct Tile {
  static constexpr int BM = 64;                     // query rows per block
  static constexpr int BN = 64;                     // keys per K/V slot
  static constexpr int STAGES = 2;                  // K/V ring depth
  static constexpr int SW = D * 2 < 128 ? D * 2 : 128;  // bytes per smem row = swizzle span
  static constexpr int CE = SW / 2;                 // head-dim elements per column chunk
  static constexpr int NCH = D / CE;                // column chunks (one TMA box each)
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;       // K or V, one stage
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_BAR = OFF_V + STAGES * KV_BYTES;
  // barriers: Q, then K and V full and empty per stage; +1024 to align the base
  static constexpr int SMEM = OFF_BAR + 8 * (1 + 4 * STAGES) + 1024;
  // wgmma descriptor layout type: 1 = 128 B, 2 = 64 B, 3 = 32 B swizzle
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0, "tiles stay swizzle-aligned");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// One TMA box of a (D, heads, S, B) tensor into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
        "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pin registers an asynchronous wgmma reads or writes in place around it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// m64nNk16, bf16 x bf16 -> fp32.  wgmma_ss (N = 64): A and B from shared
// memory, both K-major; scale_d = 0 overwrites d.  wgmma_rs: A from registers, B from
// shared memory with the transpose bit (N-major); accumulates into d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
               int S, int H, int Hkv, int causal, int window, float scale_log2) {
  using T = Tile<D>;
  constexpr int BM = T::BM, BN = T::BN, STAGES = T::STAGES, SW = T::SW, CE = T::CE;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + T::OFF_K, sV = base + T::OFF_V;
  // mbarriers: Q; then per stage K full, V full, K empty, V empty
  const uint32_t bar_q = base + T::OFF_BAR;
  const uint32_t full_k = bar_q + 8, full_v = full_k + 8 * STAGES;
  const uint32_t empty_k = full_v + 8 * STAGES, empty_v = empty_k + 8 * STAGES;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * BM;
  // KV tiles that any row of this q tile can reach.
  const int last_q = min(q0 + BM, S) - 1;
  const int kv_hi = causal ? last_q : S - 1;
  const int kv_lo = window ? max(0, q0 - window + 1) : 0;
  const int t_lo = kv_lo / BN;
  const int n_tiles = kv_hi / BN - t_lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, CONSUMERS);
      mbar_init(empty_v + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // Producer: one lane starts every copy, K and V of a tile on barriers
    // of their own, each into a slot its consumers have released.
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(bar_q, T::Q_BYTES);
#pragma unroll
      for (int c = 0; c < T::NCH; ++c)
        tma_load(sQ + c * BM * SW, &tq, bar_q, c * CE, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES, k0 = (t_lo + j) * BN;
        const uint32_t reuse = (j / STAGES - 1) & 1;
        if (j >= STAGES) mbar_wait(empty_k + 8 * s, reuse);
        mbar_expect_tx(full_k + 8 * s, T::KV_BYTES);
#pragma unroll
        for (int c = 0; c < T::NCH; ++c)
          tma_load(sK + s * T::KV_BYTES + c * BN * SW, &tk, full_k + 8 * s, c * CE, hk, k0, b);
        if (j >= STAGES) mbar_wait(empty_v + 8 * s, reuse);
        mbar_expect_tx(full_v + 8 * s, T::KV_BYTES);
#pragma unroll
        for (int c = 0; c < T::NCH; ++c)
          tma_load(sV + s * T::KV_BYTES + c * BN * SW, &tv, full_v + 8 * s, c * CE, hk, k0, b);
      }
    }
    return;
  }

  // Consumers.  Thread t holds rows r0 and r0 + 8 of the tile and, in every
  // 8-column group j of an accumulator, columns 8j + c0 and 8j + c0 + 1:
  // fragment index 4j + 2*half + e.
  const int tid = threadIdx.x;
  const int r0 = 16 * (tid >> 5) + ((tid & 31) >> 2);
  const int c0 = 2 * (tid & 3);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of the scaled (log2) scores
  float l[2] = {0.f, 0.f};              // this thread's share of the running sum
  float sc[BN / 2];                     // scores, then P, of one tile
  uint32_t p_hi[BN / 16][4], p_lo[BN / 16][4];  // P as register A fragments

  // S = Q K^T of tile i over D / 16 steps of 16 head-dim columns.
  auto start_qk = [&](int i) {
    const uint32_t tK = sK + (i % STAGES) * T::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      // Head-dim columns 16kk .. 16kk+15: column chunk, then bytes into its rows.
      const int chunk = kk * 16 / CE, col_bytes = kk * 16 % CE * 2;
      wgmma_ss(sc, make_desc(sQ + chunk * BM * SW + col_bytes, 16, 8 * SW, T::LAYOUT),
               make_desc(tK + chunk * BN * SW + col_bytes, 16, 8 * SW, T::LAYOUT), kk > 0);
    }
  };

  // Mask tile i where needed, then the online softmax in the log2 domain:
  // sc becomes p = 2^(s * scale * log2(e) - m); alpha rescales what came before.
  auto softmax = [&](int i, float (&alpha)[2]) {
    const int k0 = (t_lo + i) * BN;
    if ((causal && k0 + BN - 1 > q0) || (window && q0 + BM - 1 - k0 >= window) ||
        k0 + BN > S) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int row = q0 + r0 + 8 * (x >> 1), col = k0 + 8 * j + c0 + (x & 1);
          const bool ok = col < S && (!causal || col <= row) && (!window || row - col < window);
          if (!ok) sc[4 * j + x] = -INFINITY;
        }
    }
    float m_use[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * hf], sc[4 * j + 2 * hf + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hf], mx * scale_log2);
      m_use[hf] = m_new == -INFINITY ? 0.f : m_new;  // a row with nothing unmasked yet
      alpha[hf] = exp2f(m[hf] - m_use[hf]);
      m[hf] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i2 = 0; i2 < BN / 2; ++i2) {
      const int hf = (i2 >> 1) & 1;
      sc[i2] = exp2f(fmaf(sc[i2], scale_log2, -m_use[hf]));
      rs[hf] += sc[i2];
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) l[hf] = l[hf] * alpha[hf] + rs[hf];
  };

  // P into register A fragments, split into a bf16 high and low part.  The
  // m64 accumulator's columns 16kk .. 16kk+15 are already the A layout of
  // k-step kk: register x holds fragment entries 8kk + 2x and 8kk + 2x + 1.
  auto split_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float a = sc[8 * kk + 2 * x], c = sc[8 * kk + 2 * x + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(a, c);
        const float2 back = __bfloat1622float2(hi);
        p_hi[kk][x] = *reinterpret_cast<const uint32_t*>(&hi);
        p_lo[kk][x] = pack_bf16(a - back.x, c - back.y);
      }
  };

  // O += P_hi V + P_lo V of tile i over BN / 16 steps of 16 keys.  V: keys
  // 16kk .. 16kk+15 (K, rows of SW bytes), head dim in NCH chunks of CE
  // columns BN * SW bytes apart (N).
  auto start_pv = [&](int i) {
    const uint32_t tV = sV + (i % STAGES) * T::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint64_t dv = make_desc(tV + kk * 16 * SW, BN * SW, 8 * SW, T::LAYOUT);
      wgmma_rs(acc, p_hi[kk], dv);
      wgmma_rs(acc, p_lo[kk], dv);
    }
  };

  // Tile 0's scores and P, then per tile i: S of tile i + 1 and P V of tile
  // i go to the tensor cores together, and tile i + 1's softmax runs on the
  // CUDA cores while P V is still in flight.
  float alpha[2];
  mbar_wait(bar_q, 0);
  mbar_wait(full_k, 0);
  wgmma_fence();
  start_qk(0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  mbar_arrive(empty_k);
  softmax(0, alpha);
  split_p();
  for (int i = 0; i + 1 < n_tiles; ++i) {
    const int s = i % STAGES, n = (i + 1) % STAGES;
    // Each product is its own wgmma group, fenced on its own registers; the
    // loop holds no condition on them, so the compiler sees which group
    // each wait retires and keeps them asynchronous.
    mbar_wait(full_k + 8 * n, ((i + 1) / STAGES) & 1);
    fence_regs(sc);
    wgmma_fence();
    start_qk(i + 1);
    wgmma_commit();
    mbar_wait(full_v + 8 * s, (i / STAGES) & 1);
    fence_regs(acc);
    fence_regs(p_hi);
    fence_regs(p_lo);
    wgmma_fence();
    start_pv(i);
    wgmma_commit();
    wgmma_wait<1>();  // S of tile i + 1
    fence_regs(sc);
    mbar_arrive(empty_k + 8 * n);
    softmax(i + 1, alpha);
    wgmma_wait<0>();  // P V of tile i
    fence_regs(acc);
    fence_regs(p_hi);
    fence_regs(p_lo);
    mbar_arrive(empty_v + 8 * s);
#pragma unroll
    for (int i2 = 0; i2 < D / 2; ++i2) acc[i2] *= alpha[(i2 >> 1) & 1];
    split_p();
  }
  // The last tile's P V.
  mbar_wait(full_v + 8 * ((n_tiles - 1) % STAGES), ((n_tiles - 1) / STAGES) & 1);
  fence_regs(acc);
  fence_regs(p_hi);
  fence_regs(p_lo);
  wgmma_fence();
  start_pv(n_tiles - 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);

  // The row sums over the 4 threads that share a row, then O / l.
  float inv[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float t = l[hf];
    t += __shfl_xor_sync(0xffffffffu, t, 1);
    t += __shfl_xor_sync(0xffffffffu, t, 2);
    inv[hf] = 1.f / fmaxf(t, 1e-30f);
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = q0 + r0 + 8 * hf;
    if (row >= S) continue;
    __nv_bfloat16* orow = o + ((long)(b * S + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + c0) =
          pack_bf16(acc[4 * j + 2 * hf] * inv[hf], acc[4 * j + 2 * hf + 1] * inv[hf]);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (libcuda), looked up once through the runtime.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// Tensor map of a contiguous (B, S, heads, D) bf16 tensor, addressed as
// (D, heads, S, B), whose box is `rows` positions of one head's CE columns.
template <int D>
int encode(CUtensorMap* map, const void* ptr, int B, int S, int heads, int rows) {
  using T = Tile<D>;
  EncodeTiled fn = encode_tiled();
  if (!fn) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)T::CE, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = T::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : T::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                              : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
           int Hkv, int causal, int window, float scale, int dev, cudaStream_t stream) {
  using T = Tile<D>;
  static bool attr_set[MAX_DEVICES];  // the smem opt-in, once per device
  if (!attr_set[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return (int)err;
    attr_set[dev] = true;
  }
  CUtensorMap tq, tk, tv;
  int err = encode<D>(&tq, q, B, S, H, T::BM);
  if (!err) err = encode<D>(&tk, k, B, S, Hkv, T::BN);
  if (!err) err = encode<D>(&tv, v, B, S, Hkv, T::BN);
  if (err) return err;
  const dim3 grid((S + T::BM - 1) / T::BM, B * H);
  flash_fwd_bf16<D><<<grid, THREADS, T::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), S, H, Hkv, causal, window,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace hopper

namespace fp32 {

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
           int Hkv, int causal, int window, float scale, int dev, cudaStream_t stream) {
  static bool attr_set[MAX_DEVICES];
  if (!attr_set[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_fp32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<D>());
    if (err != cudaSuccess) return (int)err;
    attr_set[dev] = true;
  }
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_fp32<D><<<grid, NT, smem_bytes<D>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, Hkv, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace fp32

typedef int (*LaunchFn)(const void*, const void*, const void*, void*, int, int, int, int, int,
                        int, float, int, cudaStream_t);

// The launcher of (dtype, D): dtype 0 = float32, 1 = bfloat16.
LaunchFn launcher(int dtype, int D) {
  static const int dims[4] = {16, 32, 64, 128};
  static const LaunchFn table[2][4] = {
      {fp32::launch<16>, fp32::launch<32>, fp32::launch<64>, fp32::launch<128>},
      {hopper::launch<16>, hopper::launch<32>, hopper::launch<64>, hopper::launch<128>}};
  if (dtype < 0 || dtype > 1) return nullptr;
  for (int i = 0; i < 4; ++i)
    if (dims[i] == D) return table[dtype][i];
  return nullptr;
}

template <int D>
void config_of(int dtype, int* out) {
  using T = hopper::Tile<D>;
  if (dtype == 1) {
    const int cfg[5] = {T::BM, T::BN, hopper::THREADS, T::STAGES, T::SMEM};
    for (int i = 0; i < 5; ++i) out[i] = cfg[i];
  } else {
    const int cfg[5] = {fp32::BQ, fp32::BKV, fp32::NT, 1, fp32::smem_bytes<D>()};
    for (int i = 0; i < 5; ++i) out[i] = cfg[i];
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  `device` is the index of the device the
// tensors and the stream belong to.  Returns a cudaError_t: the result of
// cudaGetLastError() right after the launch (0 when it was accepted).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int dtype,
                        int B, int S, int H, int Hkv, int D, int causal, int window,
                        float scale, int device, void* stream) {
  if (S <= 0 || B <= 0 || Hkv <= 0 || H % Hkv != 0 || B * H > 65535 || device < 0 ||
      device >= MAX_DEVICES)
    return (int)cudaErrorInvalidValue;
  const LaunchFn fn = launcher(dtype, D);
  if (!fn) return (int)cudaErrorInvalidValue;
  int cur = 0;
  cudaGetDevice(&cur);
  if (cur != device) cudaSetDevice(device);
  const int err = fn(q, k, v, o, B, S, H, Hkv, causal, window, scale, device,
                     static_cast<cudaStream_t>(stream));
  if (cur != device) cudaSetDevice(cur);
  return err;
}

// The tiles of (dtype, D): out = {query rows, keys per stage, threads,
// K/V stages, dynamic shared memory bytes}.  Returns 0, or -1 if unsupported.
int flash_attention_config(int dtype, int D, int* out) {
  if (dtype < 0 || dtype > 1) return -1;
  switch (D) {
    case 16: config_of<16>(dtype, out); return 0;
    case 32: config_of<32>(dtype, out); return 0;
    case 64: config_of<64>(dtype, out); return 0;
    case 128: config_of<128>(dtype, out); return 0;
    default: return -1;
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

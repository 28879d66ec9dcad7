// K3: causal / sliding-window GQA flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::_flash_kernel
// (and the layout/padding wrapper repro/kernels/ops.py::flash_attention).
// It computes the same function: scale d**-0.5 (the caller passes the scale,
// so a model may set another), causal mask with an optional
// sliding window, query head h reading KV head h / (H / Hkv), fp32 running
// max / sum / accumulator with the online-softmax update, output in the input
// dtype.
//
// Layout: q, o (B, S, H, D) and k, v (B, S, Hkv, D), contiguous; the kernels
// address them in place, so the caller needs no transpose and no padding copy
// (the ragged sequence edge is masked by the real length S).
//
// What bounds it on an H100: at the serving path's prompts (S = 64) the
// bytes (q, k, v read once, o written once: about 2 MB, 0.6 us at 3.35 TB/s
// in bf16) and the latency of one short pass; at long prompts the
// operations (4 * H * D flops per attended (query, key) pair, 0.035 ms at
// (1, 2048, 32, 32, 128) at 989 TFLOP/s in bf16, 0.208 ms in fp32 at three
// TF32 passes).
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
// fp32 (launch.serve's default dtype, the fp32 train and sharded prefills):
// tensor cores in three TF32 passes.  It replaces the first port's CUDA-core
// kernel (fp32 FMAs, 67 TFLOP/s at most, one block of 4 warps an SM at
// D = 128, scalar loads between barriers).  One TF32 product keeps 11
// significant bits and misses the fp32 gate (2e-5); three, hi·hi + hi·lo +
// lo·hi with hi = tf32(x) and lo = tf32(x - hi) (cvt.rna), keep about 22,
// at 495 / 3 = 165 TFLOP/s: that rate bounds a long prompt, the bytes a
// short one.  mma.sync m16n8k8 rather than wgmma, which takes TF32 only
// K-major: in P V, V's keys are K and its head dim is the contiguous axis.
// One block per (64-row q tile, batch * head), 8 warps in two groups of 4;
// warp w owns rows 16 (w % 4) .. + 15, and group w / 4 one half of the
// keys of every K/V tile, with its own running max, sum and O; the second
// group's are merged into the first's at the end through shared memory,
// in a fixed order.  Each thread copies Q and each K/V tile with 16-byte
// cp.async into a two-stage ring (the next tile's copy runs under this
// one's math) and then splits the chunks it copied: the high part in
// place, the low part into a plane beside it, so every staged element is
// split once (Q, pre-scaled by D**-0.5, once per block).  S = Q Kᵀ takes
// both operands as stored (ldmatrix of 8 x 4 fp32 tiles); P V takes the
// score accumulator as its A fragment by ordering each step's 8 keys
// 0, 2, 4, 6, 1, 3, 5, 7, and V's B fragment as two scalar loads.  Rows of
// D + 4 floats keep every fragment load free of bank conflicts.  The tiles
// (Tile<D>): 32 keys a tile at D >= 64, so that D = 128 (Q's two planes,
// 67,584 B, and two stages of four 32-key planes, 135,168 B) fits one
// block of 8 warps an SM, and D = 64 two blocks; 64 keys at D <= 32, where
// they fit as well.  The tensor cores round their fp32 sums toward zero,
// so a chain of 48 products into one accumulator (S at D = 128) drifts:
// each 8-deep step of S, and each tile's P V, is summed alone and added to
// the running sum on the CUDA cores, rounded to nearest (a third of the
// error against the plain version; 254 registers at D = 128, no spills).
// Every sum has a fixed order and there are no atomics.

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;  // the reference kernel's mask value
constexpr int MAX_DEVICES = 64;

// ---------------------------------------------------------------------------
// fp32: tensor cores in three TF32 passes (mma.sync m16n8k8)
// ---------------------------------------------------------------------------

namespace fp32 {

constexpr int BM = 64;                // query rows per block: 16 per warp of a group
constexpr int WARPS = 8;              // two groups of 4 warps, each on half of every K/V tile
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 2;             // K/V ring depth

template <int D>
struct Tile {
  static constexpr int BN = D <= 32 ? 64 : 32;  // keys per K/V tile (both groups)
  static constexpr int HB = BN / 2;             // keys per group
  static constexpr int LD = D + 4;              // floats per shared row (conflict-free fragments)
  static constexpr int PLANE = BN * LD;         // one K or V plane of a stage
  static constexpr int Q_FLOATS = 2 * BM * LD;  // Q high, Q low
  static constexpr int STAGE_FLOATS = 4 * PLANE;  // K high, K low, V high, V low
  static constexpr int SMEM = (Q_FLOATS + STAGES * STAGE_FLOATS) * 4;
  static_assert(D % 8 == 0 && HB % 16 == 0, "fragments of 8 dims and pairs of 8-key tiles");
  static_assert(BM * LD + 2 * BM <= STAGES * STAGE_FLOATS, "the merge fits the ring");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; valid = false zero-fills (no global read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 4 fp32 tiles (8 rows of 16 bytes each, row addresses from lanes
// 8i .. 8i+7): register i holds element [lane / 4][lane % 4] of tile i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x as a TF32 high part and the TF32 rounding of the rest: hi + lo is x to
// about 2^-22 of |x|.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d += a (16x8, row) * b (8x8, col), TF32 in, fp32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d = a (16x8, row) * b (8x8, col), TF32 in, fp32 out (no accumulator in).
__device__ __forceinline__ void mma_zero(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}
// d (= when `fresh`, else +=) a b in three TF32 passes, the small terms
// first: lo·hi, hi·lo, hi·hi.
template <bool fresh>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                     uint32_t bl0, uint32_t bl1) {
  if constexpr (fresh)
    mma_zero(d, al, bh0, bh1);
  else
    mma(d, al, bh0, bh1);
  mma(d, ah, bl0, bl1);
  mma(d, ah, bh0, bh1);
}
// The tensor cores round an accumulation toward zero, so a long chain of
// products into one accumulator drifts.  Each 8-deep step (or tile) is
// summed alone and added to the running sum on the CUDA cores (rounded to
// nearest).
__device__ __forceinline__ void add4(float (&acc)[4], const float (&part)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += part[e];
}

template <int D>
__global__ void __launch_bounds__(THREADS, D == 128 ? 1 : 2)
flash_fwd_fp32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, int S, int H,
               int Hkv, int causal, int window, float scale) {
  using T = Tile<D>;
  constexpr int BN = T::BN, HB = T::HB, LD = T::LD, PLANE = T::PLANE;
  constexpr int NKT = HB / 8;   // 8-key tiles of a group's part
  constexpr int NDT = D / 8;    // 8-column tiles of the head dim
  constexpr int C4 = D / 4;     // 16-byte chunks of a row
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                      // Q high; Q low BM * LD floats on
  float* sKV = smem + T::Q_FLOATS;       // per stage: K high, K low, V high, V low

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * BM;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int grp = w >> 2;            // keys grp * HB .. grp * HB + HB - 1 of every tile
  const int r0 = 16 * (w & 3);       // the warp's 16 rows of the q tile
  const int g = lane >> 2, t4 = lane & 3;

  const long q_stride = (long)H * D;  // between consecutive positions
  const long kv_stride = (long)Hkv * D;
  const float* qb = q + (long)b * S * q_stride + (long)h * D;
  const float* kb = k + (long)b * S * kv_stride + (long)hk * D;
  const float* vb = v + (long)b * S * kv_stride + (long)hk * D;
  float* ob = o + (long)b * S * q_stride + (long)h * D;

  // KV tiles that any row of this q tile can reach.
  const int last_q = min(q0 + BM, S) - 1;
  const int kv_hi = causal ? last_q : S - 1;
  const int kv_lo = window ? max(0, q0 - window + 1) : 0;
  const int t_lo = kv_lo / BN;
  const int n_tiles = kv_hi / BN - t_lo + 1;

  // Each thread copies fixed 16-byte chunks and later splits those same
  // chunks, so its own cp.async writes are all it reads before the barrier.
  // Rows past S are zero-filled.
  auto stage_kv = [&](int j) {
    float* st = sKV + (j % STAGES) * T::STAGE_FLOATS;
    const int k0 = (t_lo + j) * BN;
    for (int e = tid; e < BN * C4; e += THREADS) {
      const int r = e / C4, c = e - r * C4, s = k0 + r;
      const bool in = s < S;
      cp_async16(smem_u32(st + r * LD + 4 * c), in ? kb + s * kv_stride + 4 * c : kb, in);
      cp_async16(smem_u32(st + 2 * PLANE + r * LD + 4 * c), in ? vb + s * kv_stride + 4 * c : vb,
                 in);
    }
    cp_async_commit();
  };
  // x * mul -> its high part in place, its low part `lo` floats further.
  auto split_rows = [&](float* base, int rows, int lo, float mul) {
    for (int e = tid; e < rows * C4; e += THREADS) {
      const int r = e / C4, c = e - r * C4;
      float4* p = reinterpret_cast<float4*>(base + r * LD + 4 * c);
      const float4 x = *p;
      uint4 hi, lo4;
      split(x.x * mul, hi.x, lo4.x);
      split(x.y * mul, hi.y, lo4.y);
      split(x.z * mul, hi.z, lo4.z);
      split(x.w * mul, hi.w, lo4.w);
      *reinterpret_cast<uint4*>(p) = hi;
      *reinterpret_cast<uint4*>(base + lo + r * LD + 4 * c) = lo4;
    }
  };

  // The Q tile joins tile 0's copy group; pre-scaled as the reference kernel does.
  for (int e = tid; e < BM * C4; e += THREADS) {
    const int r = e / C4, c = e - r * C4, s = q0 + r;
    cp_async16(smem_u32(sQ + r * LD + 4 * c), s < S ? qb + s * q_stride + 4 * c : qb, s < S);
  }
  stage_kv(0);

  float acc[NDT][4];
#pragma unroll
  for (int nt = 0; nt < NDT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows r0 + g, r0 + g + 8
  float l[2] = {0.f, 0.f};              // this thread's share of their running sums

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      stage_kv(j + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    float* st = sKV + (j % STAGES) * T::STAGE_FLOATS;
    if (j == 0) split_rows(sQ, BM, BM * LD, scale);
    split_rows(st, BN, PLANE, 1.f);
    split_rows(st + 2 * PLANE, BN, PLANE, 1.f);
    __syncthreads();

    // S = Q Kᵀ on this group's HB keys: A = Q rows (ldmatrix), B = K rows
    // (keys x head dim, K-major as stored: ldmatrix, two 8-key tiles at once).
    const float* kh = st + grp * HB * LD;
    float sc[NKT][4];
#pragma unroll
    for (int nt = 0; nt < NKT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NDT; ++ks) {
      uint32_t ah[4], al[4];
      const int qoff = (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * ks + 4 * (lane >> 4);
      ldsm_x4(ah, smem_u32(sQ + qoff));
      ldsm_x4(al, smem_u32(sQ + BM * LD + qoff));
#pragma unroll
      for (int nt = 0; nt < NKT; nt += 2) {
        uint32_t bh[4], bl[4];
        const int koff = (8 * nt + (lane & 7) + 8 * (lane >> 4)) * LD + 8 * ks +
                         4 * ((lane >> 3) & 1);
        ldsm_x4(bh, smem_u32(kh + koff));
        ldsm_x4(bl, smem_u32(kh + PLANE + koff));
        float part[2][4];
        mma3<true>(part[0], ah, al, bh[0], bh[1], bl[0], bl[1]);
        mma3<true>(part[1], ah, al, bh[2], bh[3], bl[2], bl[3]);
        add4(sc[nt], part[0]);
        add4(sc[nt + 1], part[1]);
      }
    }

    // Mask where the part straddles the diagonal, the window's edge or S;
    // then the online softmax of rows r0 + g (hf 0) and r0 + g + 8 (hf 1).
    const int k0 = (t_lo + j) * BN + grp * HB;
    if ((causal && k0 + HB - 1 > q0 + r0) || (window && q0 + r0 + 15 - k0 >= window) ||
        k0 + HB > S) {
#pragma unroll
      for (int nt = 0; nt < NKT; ++nt)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int row = q0 + r0 + g + 8 * (x >> 1), col = k0 + 8 * nt + 2 * t4 + (x & 1);
          const bool ok = col < S && (!causal || col <= row) && (!window || row - col < window);
          if (!ok) sc[nt][x] = -INFINITY;
        }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NKT; ++nt) mx = fmaxf(mx, fmaxf(sc[nt][2 * hf], sc[nt][2 * hf + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hf], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // nothing unmasked yet
      const float alpha = expf(m[hf] - m_use);
      m[hf] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int nt = 0; nt < NKT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // A masked entry contributes 0.
          sc[nt][2 * hf + e] = expf(sc[nt][2 * hf + e] - m_use);
          rs += sc[nt][2 * hf + e];
        }
      l[hf] = l[hf] * alpha + rs;
#pragma unroll
      for (int nt = 0; nt < NDT; ++nt) {
        acc[nt][2 * hf] *= alpha;
        acc[nt][2 * hf + 1] *= alpha;
      }
    }

    // O += P V.  The 8 keys of a step are taken in the order 0, 2, 4, 6,
    // 1, 3, 5, 7 (A column t4 is key 2 t4, column t4 + 4 key 2 t4 + 1), so
    // the score accumulator is already the A fragment, and V's B fragment is
    // rows 2 t4 and 2 t4 + 1 of the stored (keys x head dim) tile.
    const float* vh = st + 2 * PLANE + grp * HB * LD + 2 * t4 * LD + g;
    uint32_t ph[NKT][4], pl[NKT][4];
#pragma unroll
    for (int kk = 0; kk < NKT; ++kk) {
      split(sc[kk][0], ph[kk][0], pl[kk][0]);
      split(sc[kk][2], ph[kk][1], pl[kk][1]);
      split(sc[kk][1], ph[kk][2], pl[kk][2]);
      split(sc[kk][3], ph[kk][3], pl[kk][3]);
    }
    // This tile's P V for each 8 columns summed alone, then added to O.
#pragma unroll
    for (int nt = 0; nt < NDT; ++nt) {
      float part[4];
#pragma unroll
      for (int kk = 0; kk < NKT; ++kk) {
        const float* v0 = vh + 8 * kk * LD + 8 * nt;
        const uint32_t bh0 = __float_as_uint(v0[0]), bh1 = __float_as_uint(v0[LD]);
        const uint32_t bl0 = __float_as_uint(v0[PLANE]), bl1 = __float_as_uint(v0[PLANE + LD]);
        if (kk == 0)
          mma3<true>(part, ph[kk], pl[kk], bh0, bh1, bl0, bl1);
        else
          mma3<false>(part, ph[kk], pl[kk], bh0, bh1, bl0, bl1);
      }
      add4(acc[nt], part);
    }
    __syncthreads();  // the stage is free for tile j + 2
  }

  // The row sums over the 4 threads that share a row; then the second
  // group's (m, l, O) through shared memory into the first group's.
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
  }
  float* sO = sKV;
  float* sM = sO + BM * LD;
  float* sL = sM + BM;
  if (grp == 1) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = r0 + g + 8 * hf;
#pragma unroll
      for (int nt = 0; nt < NDT; ++nt)
        *reinterpret_cast<float2*>(sO + row * LD + 8 * nt + 2 * t4) =
            make_float2(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
      if (t4 == 0) {
        sM[row] = m[hf];
        sL[row] = l[hf];
      }
    }
  }
  __syncthreads();
  if (grp == 1) return;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = r0 + g + 8 * hf;
    if (q0 + row >= S) continue;
    const float m1 = sM[row];
    const float mm = fmaxf(m[hf], m1);
    const float mu = mm == -INFINITY ? 0.f : mm;
    const float a0 = expf(m[hf] - mu), a1 = expf(m1 - mu);
    const float denom = fmaxf(l[hf] * a0 + sL[row] * a1, 1e-30f);
    float* orow = ob + (long)(q0 + row) * q_stride + 2 * t4;
#pragma unroll
    for (int nt = 0; nt < NDT; ++nt) {
      const float2 other = *reinterpret_cast<const float2*>(sO + row * LD + 8 * nt + 2 * t4);
      *reinterpret_cast<float2*>(orow + 8 * nt) =
          make_float2((acc[nt][2 * hf] * a0 + other.x * a1) / denom,
                      (acc[nt][2 * hf + 1] * a0 + other.y * a1) / denom);
    }
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
  using T = Tile<D>;
  static bool attr_set[MAX_DEVICES];
  if (!attr_set[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_fp32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return (int)err;
    attr_set[dev] = true;
  }
  const dim3 grid((S + BM - 1) / BM, B * H);
  flash_fwd_fp32<D><<<grid, THREADS, T::SMEM, stream>>>(
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
    using F = fp32::Tile<D>;
    const int cfg[5] = {fp32::BM, F::BN, fp32::THREADS, fp32::STAGES, F::SMEM};
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

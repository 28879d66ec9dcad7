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
// One design for both dtypes, one wrapper (kernels/ssd_scan.py::ssd_scan),
// one launch count: tensor cores (mma.sync; bf16 m16n8k16, fp32 as three
// TF32 passes of m16n8k8) and chunks in parallel.  A call is one launch of
// ssd_chunk_kernel when S fits one chunk (every prompt on the serving path
// but the 600-token one), else three: the chunk kernel, ssd_state_kernel,
// the chunk kernel again.  The chunk kernel runs two kinds of block of 128
// threads (4 warps), decoded from blockIdx by block_work:
//   * y blocks, one per (64-row tile i of a chunk, head, batch, chunk).
//     C rows i stay in registers as A fragments over all of N.  For each
//     column tile j <= i the block stages B_j, forms C·Bᵀ in registers,
//     stages X_j and adds S·X_j with S = (C·Bᵀ) ∘ exp(cum_i - cum_j) ∘ dt_j
//     (the exp only where j <= i < L, so it cannot overflow).  For a chunk
//     after the first it starts from the incoming state's term
//     exp(cum_i) (c_i · state_in).
//   * state blocks, one per (64 columns of N, head, chunk, batch): the
//     chunk-local state ΔS = dxᵀ·B with dx_j = x_j dt_j exp(total - cum_j),
//     written as the final state when there is one chunk, else to a scratch
//     from which ssd_state_kernel forms each chunk's incoming state
//     (state_in(c+1) = state_in(c) exp(total_c) + ΔS_c), as bf16 high and
//     low parts that the y blocks stage like any other tile, and the final
//     state.
// One head a y block: C·Bᵀ is the same for every head, but a block that
// kept it for a group of heads needs an fp32 tile of it in shared memory
// and a chain of tiles as long as the group, and the serving path's grids
// (144 to 576 blocks) have too few blocks to share it over.
// Precision: C, B and X are bf16 inputs, exact as operands.  The three fp32
// intermediates that meet a tensor core (S, the incoming state, dx) go in
// as a bf16 high part plus a bf16 low part, two products into one fp32
// accumulator; one rounding would miss the gates against fp32.  Loads are
// 16-byte cp.async into a two-slot ring; rows past the chunk's real length
// L are zero-filled, and so are cum and dt from L to the tile edge, so the
// ragged last chunk is masked, not padded, and no block reads shared
// memory it has not written.  Every sum has a fixed order and there are no
// atomics, so two launches on the same inputs are bitwise equal.
//
// fp32 (launch.serve's default dtype, and sharded_ssm's prefill): the same
// grids, blocks, ring and pass order (y_block_f32, state_block_f32; the
// chunk kernel's second template argument), in three TF32 passes per
// product: hi·hi + hi·lo + lo·hi with hi = tf32(x) and lo = tf32(x - hi)
// (cvt.rna), about 22 significant bits where one TF32 product keeps 11 and
// misses the fp32 gate.  Every operand is split: C, B and X as well as the
// three intermediates (S, the incoming state, dx).  It replaces the first
// port's fp32 kernel, one block per (batch, head) walking the chunks in
// order on the CUDA cores (48 blocks for 132 SMs at a one-sequence
// prompt).  The state pass writes state_in in fp32, one plane, split as the
// y blocks load it.  Fragments: A from stored rows by ldmatrix of 8 x 4
// fp32 tiles; where a product's k runs across stored rows (S·X's positions,
// ΔS's positions in both operands) each 8-row step takes rows 2 t4 and
// 2 t4 + 1 for its k indices t4 and t4 + 4, a reordering of k that leaves
// the sum as it is and makes the score accumulator S's A fragment.  Rows of
// width + 4 floats keep those loads free of bank conflicts.  C's fragments
// stay in registers (64 at N = 128) and are split once per tile they meet.
// 69,632 B of shared memory a block at mamba2-780m's widths.
//
// What bounds it on an H100: at mamba2-780m's widths (H 48, P 64, N 128)
// the Engine's prefill (B 4, S 64) moves about 9.7 MB in bf16, 6.3 MB of it
// the fp32 final state (2.9 us at 3.35 TB/s), and does about 0.46 GFLOP
// (0.5 us at the bf16 tensor-core peak): the bytes.  In fp32 it moves 12.9
// MB (3.9 us); a 600-token prompt (1.4 GFLOP, 8.5 us at 495 / 3 TFLOP/s)
// and sharded_ssm's (4, 512) prefill are bound by the operations.  The state blocks write those
// bytes, so they are spread over B·H·N/64 blocks (384 at the Engine's
// prefill) beside the y blocks; at a one-sequence slot prefill the grid is
// 144 blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TILE = 64;    // rows of a chunk tile
constexpr int MAX_N = 128;  // largest state dim

// ---------------------------------------------------------------------------
// Tensor cores, chunks in parallel: what both dtypes share
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 128;  // 4 warps; warp w owns rows 16w..16w+15 of a tile
constexpr int STATE_COLS = 64;   // columns of N per state block
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 zero-fills (no global read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (u, v) -> a bf16 pair of their high parts and one of the remainders; u is
// the lower element (the lower column or k index) of each pair.
__device__ __forceinline__ void split2(float u, float v, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(u, v);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(u - hf.x, v - hf.y));
}

// 2^x on the special function unit (relative error about 2^-22).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float LOG2E = 1.4426950408889634f;
#define NEG_INF (-__int_as_float(0x7f800000))

// Rows a chunk's cum and dt take in shared memory: Q rounded up to the tile
// edge, so each region starts 16-byte aligned whatever Q is.
__host__ __device__ inline int round_tile(int q) { return (q + TILE - 1) / TILE * TILE; }

// Inclusive scan of a_log over rows [0, L) of a chunk (row stride H) by one
// warp, in 32-row steps with a carry, stored times `scale` (1, or log2(e)
// for ex2); dt copied beside it.  Both are zero from L to the tile edge,
// which the 16-row steps of a ragged tile read.  Every load starts before
// the scan starts (L <= 256: 8 rows a lane).
__device__ __forceinline__ void scan_chunk(const float* ab, const float* db, int H, int L,
                                           float scale, float* cum, float* dtv, int lane) {
  const int end = round_tile(L);
  float av[8], dv[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int r = 32 * k + lane;
    av[k] = r < L ? ab[(long)r * H] : 0.f;
    dv[k] = r < L ? db[(long)r * H] : 0.f;
  }
  float carry = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (32 * k >= end) break;
    const int r = 32 * k + lane;
    float v = av[k];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    v += carry;
    cum[r] = r < L ? v * scale : 0.f;
    dtv[r] = dv[k];
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
}

// Stage rows [r0, r0 + 64) of a row-major slab of T (row stride `stride`
// elements, `width` elements a row, a multiple of 16 bytes) into shared
// memory rows of `pitch` bytes; rows at or past `nvalid` are zero-filled.
template <typename T>
__device__ __forceinline__ void stage_tile(uint32_t dst, int pitch, const T* src, long stride,
                                           int r0, int nvalid, int width) {
  constexpr int PER16 = 16 / (int)sizeof(T);   // elements in 16 bytes
  const int per_row = width / PER16;
  for (int e = threadIdx.x; e < TILE * per_row; e += TC_THREADS) {
    const int r = e / per_row, k = e - r * per_row;
    const bool valid = r < nvalid;
    const T* g = valid ? src + (long)(r0 + r) * stride + k * PER16 : src;
    cp_async16(dst + r * pitch + k * 16, g, valid);
  }
}

// The sizes of a call, which fix its grids and the decode of its blocks
// (the same for both dtypes).
struct Grid {
  int B, S, H, N, Q, nc;
  int n_it;        // 64-row tiles of a chunk
  int parts;       // state blocks per (chunk, head): ceil(N / 64)
  int launch;      // chunk kernel 0 (the first chunk's y blocks, every state block) or 1
};

// A call's tensors: x, b, c, y in T (bf16 or fp32), the rest fp32.
template <typename T>
struct Args : Grid {
  const T *x, *b, *c;
  const float *a_log, *dt;
  T* y;
  float* state;    // (B, H, P, N): written by the state blocks when nc == 1
  float* ds;       // (B, nc, H, P, N) scratch when nc > 1: each chunk's ΔS
  T* sin;          // when nc > 1, each chunk's state_in: (B, nc, H, 2, P, N) bf16 high
                   // and low parts, or (B, nc, H, P, N) fp32
  float* totals;   // (B, nc, H) scratch when nc > 1: cum at each chunk's last row
};

Grid sized(int B, int S, int H, int N, int Q) {
  Grid a{};
  a.B = B, a.S = S, a.H = H, a.N = N, a.Q = Q;
  a.nc = (S + Q - 1) / Q;
  a.n_it = (Q + TILE - 1) / TILE;
  a.parts = (N + STATE_COLS - 1) / STATE_COLS;
  return a;
}

// y blocks of a chunk-kernel launch: the first chunk's (launch 0) or the
// later chunks' (launch 1), one per (row tile, head, batch, chunk).
__host__ __device__ inline int y_blocks(const Grid& a) {
  return (a.launch ? a.nc - 1 : 1) * a.n_it * a.B * a.H;
}

struct Work {
  int kind;  // 0: a y block, 1: a state block, -1: none (a row tile past its chunk's end)
  int b, c, h;
  int tile;  // y: the chunk's 64-row tile; state: the 64 columns of N
};

// What block `blk` of a chunk-kernel launch computes: the y blocks first,
// their row tiles from the last (the longest chain) down, then in launch 0
// the state blocks.  ssd_scan.py::block_work repeats this decode.
__host__ __device__ inline Work block_work(const Grid& a, int blk) {
  Work w;
  const int n_y = y_blocks(a);
  int rest;
  if (blk < n_y) {
    const int per_it = n_y / a.n_it;
    w.kind = 0;
    w.tile = a.n_it - 1 - blk / per_it;
    rest = blk % per_it;
  } else {
    rest = blk - n_y;
    w.kind = 1;
    w.tile = rest % a.parts;
    rest /= a.parts;
  }
  w.h = rest % a.H;
  rest /= a.H;
  w.b = rest % a.B;
  w.c = rest / a.B + (w.kind == 0 ? a.launch : 0);
  const int L = a.S - w.c * a.Q < a.Q ? a.S - w.c * a.Q : a.Q;
  if (w.kind == 0 && w.tile * TILE >= L) w.kind = -1;
  return w;
}

// Shared memory of the two kinds of block (bytes).
__host__ __device__ inline int y_block_smem(int P, int N, int Q) {
  return 2 * TILE * ((N > P ? N : P) + 8) * 2 + 2 * round_tile(Q) * 4;
}
__host__ __device__ inline int state_block_smem(int P, int N, int Q) {
  const int nw = N < STATE_COLS ? N : STATE_COLS;
  return 2 * TILE * ((nw + 8) + (P + 8)) * 2 + 2 * round_tile(Q) * 4;
}
// fp32: rows of 4 more floats than the tile's width (conflict-free fragments)
__host__ __device__ inline int y_block_smem_f32(int P, int N, int Q) {
  return 2 * TILE * ((N > P ? N : P) + 4) * 4 + 2 * round_tile(Q) * 4;
}
__host__ __device__ inline int state_block_smem_f32(int P, int N, int Q) {
  const int nw = N < STATE_COLS ? N : STATE_COLS;
  return 2 * TILE * ((nw + 4) + (P + 4)) * 4 + 2 * round_tile(Q) * 4;
}
// The dynamic shared memory of a chunk-kernel block of either kind.
template <typename T>
__host__ __device__ inline int tc_smem(int P, int N, int Q) {
  const bool f32 = sizeof(T) == 4;
  const int a = f32 ? y_block_smem_f32(P, N, Q) : y_block_smem(P, N, Q);
  const int b = f32 ? state_block_smem_f32(P, N, Q) : state_block_smem(P, N, Q);
  return a > b ? a : b;
}

// A y block: rows [i0, i0 + 64) of chunk c, head h, batch bi.  The ring's
// tiles, in order: C rows i (t = 0), the incoming state's high and low
// parts in 64-row tiles of p (after the first chunk), then for each column
// tile j <= i its B rows and its X rows.  C stays in registers as A
// fragments over all of N; C·Bᵀ of a column tile is formed in registers
// from the B rows and used there on the X rows, so no fp32 tile is stored.
template <int P>
__device__ __forceinline__ void y_block(const Args<__nv_bfloat16>& a, const Work& wk,
                                        char* smem) {
  constexpr int PT = P / 8;                 // 8-column tiles of a y row
  constexpr int SPT = (P + TILE - 1) / TILE;  // 64-row tiles of a (P, N) state
  const int bi = wk.b, c = wk.c, h = wk.h;
  const int c0 = c * a.Q;
  const int L = min(a.Q, a.S - c0);         // real rows of this chunk
  const int i0 = wk.tile * TILE;
  const int N = a.N, H = a.H, nks = N >> 4;
  const int NJ = wk.tile + 1;               // column tiles j <= i
  const int pitch = ((N > P ? N : P) + 8) * 2;
  const int slot_bytes = TILE * pitch;
  float* sCum = reinterpret_cast<float*>(smem + 2 * slot_bytes);   // cum * log2(e)
  float* sDt = sCum + round_tile(a.Q);
  const uint32_t ring = smem_u32(smem);

  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int lrow = lane & 7, lsel = (lane >> 3) & 1, lhi = lane >> 4;
  const int ia = i0 + 16 * w + g, ib = ia + 8;   // this thread's two rows
  const long row0 = (long)bi * a.S + c0;         // the chunk's first position
  const long xrow0 = (row0 * H + h) * P;         // its x and y row of head h

  const int ST = c > 0 ? 2 * SPT : 0;      // state tiles
  const int T = 1 + ST + 2 * NJ;
  auto fetch = [&](int t) {
    const uint32_t dst = ring + (t & 1) * slot_bytes;
    if (t == 0) {
      stage_tile(dst, pitch, a.c + row0 * N, N, i0, L - i0, N);
    } else if (t <= ST) {
      const int k = t - 1, r0 = (k % SPT) * TILE;
      const long plane = (((long)bi * a.nc + c) * H + h) * 2 + k / SPT;
      stage_tile(dst, pitch, a.sin + plane * P * N + (long)r0 * N, N, 0, P - r0, N);
    } else {
      const int u = t - 1 - ST, j0 = (u >> 1) * TILE;
      if (u & 1)
        stage_tile(dst, pitch, a.x + xrow0, (long)H * P, j0, L - j0, P);
      else
        stage_tile(dst, pitch, a.b + row0 * N, N, j0, L - j0, N);
    }
    cp_async_commit();
  };
  fetch(0);
  if (w == 0)
    scan_chunk(a.a_log + row0 * H + h, a.dt + row0 * H + h, H, min(L, i0 + TILE), LOG2E, sCum,
               sDt, lane);

  uint32_t cf[MAX_N / 16][4];               // C rows ia, ib as A fragments over all of N
  float acc[PT][4];
  float cb[8][4];                           // C·Bᵀ of the current column tile, rows ia, ib
#pragma unroll
  for (int nt = 0; nt < PT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  for (int t = 0; t < T; ++t) {
    if (t + 1 < T) {
      fetch(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t cur = ring + (t & 1) * slot_bytes;
    const float cia = ia < L ? sCum[ia] : NEG_INF, cib = ib < L ? sCum[ib] : NEG_INF;
    if (t == 0) {
#pragma unroll
      for (int ks = 0; ks < MAX_N / 16; ++ks)
        if (ks < nks)
          ldsm_x4(cf[ks], cur + (16 * w + lrow + lsel * 8) * pitch + (ks * 16 + lhi * 8) * 2);
    } else if (t <= ST) {
      // the incoming state: c_i · state_in, its high then its low part, for
      // rows [64 q, 64 q + 64) of p; then scaled by exp(cum_i)
      const int k = t - 1;
#pragma unroll
      for (int q = 0; q < SPT; ++q) {
        if (q != k % SPT) continue;
#pragma unroll
        for (int ks = 0; ks < MAX_N / 16; ++ks) {
          if (ks >= nks) continue;
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            if (q * TILE + np * 16 >= P) continue;
            uint32_t bq[4];
            ldsm_x4(bq, cur + (np * 16 + lrow + lhi * 8) * pitch + (ks * 16 + lsel * 8) * 2);
            mma_bf16(acc[q * 8 + 2 * np], cf[ks], bq[0], bq[1]);
            mma_bf16(acc[q * 8 + 2 * np + 1], cf[ks], bq[2], bq[3]);
          }
        }
      }
      if (t == ST) {
        const float ea = ex2(cia), eb = ex2(cib);   // 0 past L
#pragma unroll
        for (int nt = 0; nt < PT; ++nt) {
          acc[nt][0] *= ea;
          acc[nt][1] *= ea;
          acc[nt][2] *= eb;
          acc[nt][3] *= eb;
        }
      }
    } else if (!((t - 1 - ST) & 1)) {
      // C·Bᵀ for this column tile
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) cb[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < MAX_N / 16; ++ks) {
        if (ks < nks) {
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t bq[4];
            ldsm_x4(bq, cur + (np * 16 + lrow + lhi * 8) * pitch + (ks * 16 + lsel * 8) * 2);
            mma_bf16(cb[2 * np], cf[ks], bq[0], bq[1]);
            mma_bf16(cb[2 * np + 1], cf[ks], bq[2], bq[3]);
          }
        }
      }
    } else {
      // S·X_j over 16-column steps that reach this warp's rows
      const int jt = (t - 1 - ST) >> 1, j0 = jt * TILE;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int jk = j0 + 16 * kk;
        if (jk > i0 + 16 * w + 15 || jk >= L) continue;
        // below the diagonal and inside L: no mask
        const bool full = jk + 15 <= i0 + 16 * w && jk + 15 < L;
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float* v = cb[2 * kk + e];
          const int j = jk + 8 * e + 2 * t4;
          const float2 cj = *reinterpret_cast<const float2*>(sCum + j);  // 0 past L
          const float2 dj = *reinterpret_cast<const float2*>(sDt + j);
          float e0 = cia - cj.x, e1 = cia - cj.y, e2 = cib - cj.x, e3 = cib - cj.y;
          if (!full) {
            // select before the exp: above the diagonal cum_i - cum_j > 0
            e0 = j <= ia ? e0 : NEG_INF;
            e1 = j + 1 <= ia ? e1 : NEG_INF;
            e2 = j <= ib ? e2 : NEG_INF;
            e3 = j + 1 <= ib ? e3 : NEG_INF;
          }
          const float s0 = v[0] * ex2(e0) * dj.x, s1 = v[1] * ex2(e1) * dj.y;
          const float s2 = v[2] * ex2(e2) * dj.x, s3 = v[3] * ex2(e3) * dj.y;
          split2(s0, s1, ah[2 * e], al[2 * e]);
          split2(s2, s3, ah[2 * e + 1], al[2 * e + 1]);
        }
#pragma unroll
        for (int np = 0; np < P / 16; ++np) {
          uint32_t xq[4];
          ldsm_x4_t(xq, cur + (16 * kk + lrow + lsel * 8) * pitch + (np * 16 + lhi * 8) * 2);
          mma_bf16(acc[2 * np], ah, xq[0], xq[1]);
          mma_bf16(acc[2 * np], al, xq[0], xq[1]);
          mma_bf16(acc[2 * np + 1], ah, xq[2], xq[3]);
          mma_bf16(acc[2 * np + 1], al, xq[2], xq[3]);
        }
      }
      if (jt == NJ - 1) {
        __nv_bfloat16* yh = a.y + xrow0 + 2 * t4;
#pragma unroll
        for (int nt = 0; nt < PT; ++nt) {
          if (ia < L)
            *reinterpret_cast<__nv_bfloat162*>(yh + (long)ia * H * P + nt * 8) =
                __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
          if (ib < L)
            *reinterpret_cast<__nv_bfloat162*>(yh + (long)ib * H * P + nt * 8) =
                __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
        }
      }
    }
    __syncthreads();
  }
}

// A state block: ΔS = dxᵀ·B for columns [n0, n0 + 64) of N, head h, chunk
// c, batch bi, over the chunk's 64-row tiles.  dx is formed in registers:
// the X tile's fragments (exact bf16) times w_j = dt_j exp(total - cum_j),
// split high + low.
template <int P>
__device__ __forceinline__ void state_block(const Args<__nv_bfloat16>& a, const Work& wk,
                                            char* smem) {
  constexpr int MT = P / 16;                // 16-row tiles of p
  constexpr int WM = MT < 4 ? MT : 4;       // warps along p
  constexpr int WN = 4 / WM;                // warps along n
  constexpr int MR = MT / WM;               // p tiles per warp
  constexpr int NQ = 8 / WN;                // most n tiles per warp
  const int bi = wk.b, c = wk.c, h = wk.h;
  const int c0 = c * a.Q;
  const int L = min(a.Q, a.S - c0);
  const int N = a.N, H = a.H;
  const int n0 = wk.tile * STATE_COLS;
  const int nw = min(N - n0, STATE_COLS);
  const int ntw = nw >> 3;
  const int pb = (nw + 8) * 2, px = (P + 8) * 2;
  const int slot_bytes = TILE * (pb + px);
  const int T = (L + TILE - 1) / TILE;
  float* sCum = reinterpret_cast<float*>(smem + 2 * slot_bytes);
  float* sW = sCum + round_tile(a.Q);       // dt, then w; zero past L, to the tile edge
  const uint32_t ring = smem_u32(smem);

  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int lrow = lane & 7, lsel = (lane >> 3) & 1, lhi = lane >> 4;
  const int wm = w % WM, wn = w / WM;
  const long row0 = (long)bi * a.S + c0;

  auto fetch = [&](int t) {
    const uint32_t dst = ring + (t & 1) * slot_bytes;
    const int j0 = t * TILE;
    stage_tile(dst, pb, a.b + row0 * N + n0, N, j0, L - j0, nw);
    stage_tile(dst + TILE * pb, px, a.x + (row0 * H + h) * P, (long)H * P, j0, L - j0, P);
    cp_async_commit();
  };
  fetch(0);
  if (w == 0) scan_chunk(a.a_log + row0 * H + h, a.dt + row0 * H + h, H, L, 1.f, sCum, sW, lane);
  __syncthreads();
  const float total = sCum[L - 1];
  for (int j = tid; j < L; j += TC_THREADS) sW[j] *= expf(total - sCum[j]);
  if (wk.tile == 0 && tid == 0 && a.nc > 1) a.totals[((long)bi * a.nc + c) * H + h] = total;

  float acc[MR][NQ][4];
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][q][e] = 0.f;

  for (int t = 0; t < T; ++t) {
    if (t + 1 < T) {
      fetch(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                        // the tile and sW are in place
    const uint32_t cur = ring + (t & 1) * slot_bytes;
    const int j0 = t * TILE;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (j0 + 16 * kk >= L) break;
      const int jb = j0 + 16 * kk + 2 * t4;
      const float2 wlo = *reinterpret_cast<const float2*>(sW + jb);      // rows jb, jb + 1
      const float2 whi = *reinterpret_cast<const float2*>(sW + jb + 8);  // and 8 further
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        const int mt = wm + WM * r;
        uint32_t xa[4], ah[4], al[4];
        ldsm_x4_t(xa, cur + TILE * pb + (16 * kk + lrow + lhi * 8) * px + (16 * mt + lsel * 8) * 2);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xa[e]));
          const float2 wv = e < 2 ? wlo : whi;
          split2(xv.x * wv.x, xv.y * wv.y, ah[e], al[e]);
        }
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int nt = wn + WN * q;
          if (nt < ntw) {
            uint32_t bq[2];
            ldsm_x2_t(bq, cur + (16 * kk + lrow + lsel * 8) * pb + nt * 16);
            mma_bf16(acc[r][q], ah, bq[0], bq[1]);
            mma_bf16(acc[r][q], al, bq[0], bq[1]);
          }
        }
      }
    }
    __syncthreads();                        // the ring slot is free again
  }

  float* dst = a.nc == 1 ? a.state + ((long)bi * H + h) * P * N
                         : a.ds + (((long)bi * a.nc + c) * H + h) * P * N;
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    const int p = 16 * (wm + WM * r) + g;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int nt = wn + WN * q;
      if (nt >= ntw) continue;
      const int n = n0 + nt * 8 + 2 * t4;
      *reinterpret_cast<float2*>(dst + (long)p * N + n) = make_float2(acc[r][q][0], acc[r][q][1]);
      *reinterpret_cast<float2*>(dst + (long)(p + 8) * N + n) =
          make_float2(acc[r][q][2], acc[r][q][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: the same blocks in three TF32 passes (mma.sync m16n8k8)
// ---------------------------------------------------------------------------

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x as a TF32 high part and the TF32 rounding of the rest.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}
__device__ __forceinline__ void split_tf32(const uint32_t (&x)[4], uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(x[e]), hi[e], lo[e]);
}

// d += a (16x8, row) * b (8x8, col), TF32 in, fp32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a b in three TF32 passes, the small terms first: lo·hi, hi·lo, hi·hi.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                     uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}
// b split into TF32 parts, then d += a b (b0, b1 as fp32 bits).
__device__ __forceinline__ void mma3_b(float (&d)[4], const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4], float b0, float b1) {
  uint32_t h0, l0, h1, l1;
  split_tf32(b0, h0, l0);
  split_tf32(b1, h1, l1);
  mma3(d, ah, al, h0, h1, l0, l1);
}

// Offsets (in floats) of this lane's row address for ldmatrix of an A
// fragment (16 rows from `row`, 8 columns from `col`: [g][t4], [g+8][t4],
// [g][t4+4], [g+8][t4+4]) and of two B fragments (16 rows from `row`, the
// n index, 8 columns of k from `col`: b0, b1 of rows row..+7, then of
// row+8..+15), in fp32 tiles of rows of `ld` floats.
__device__ __forceinline__ int a_frag_off(int lane, int row, int col, int ld) {
  return (row + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld + col + 4 * (lane >> 4);
}
__device__ __forceinline__ int b_frag_off(int lane, int row, int col, int ld) {
  return (row + (lane & 7) + 8 * (lane >> 4)) * ld + col + 4 * ((lane >> 3) & 1);
}

// A y block in fp32: y_block's tiles and pass order, with the incoming
// state in one fp32 plane (split as it is loaded).  C stays in registers
// as fp32 A fragments over all of N (ldmatrix of 8 x 4 fp32 tiles), split
// into TF32 parts for each tile it meets.  In S·X the 8 columns of a step
// are taken in the order 0, 2, 4, 6, 1, 3, 5, 7, so C·Bᵀ's accumulator is
// already S's A fragment and X's B fragment is rows 2 t4 and 2 t4 + 1.
template <int P>
__device__ __forceinline__ void y_block_f32(const Args<float>& a, const Work& wk, char* smem) {
  constexpr int PT = P / 8;                 // 8-column tiles of a y row
  constexpr int SPT = (P + TILE - 1) / TILE;  // 64-row tiles of a (P, N) state
  const int bi = wk.b, c = wk.c, h = wk.h;
  const int c0 = c * a.Q;
  const int L = min(a.Q, a.S - c0);         // real rows of this chunk
  const int i0 = wk.tile * TILE;
  const int N = a.N, H = a.H, nk8 = N >> 3;
  const int NJ = wk.tile + 1;               // column tiles j <= i
  const int ld = (N > P ? N : P) + 4;       // floats a shared row
  const int slot = TILE * ld;               // floats a ring slot
  float* ringf = reinterpret_cast<float*>(smem);
  float* sCum = ringf + 2 * slot;           // cum * log2(e)
  float* sDt = sCum + round_tile(a.Q);

  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int ia = i0 + 16 * w + g, ib = ia + 8;   // this thread's two rows
  const long row0 = (long)bi * a.S + c0;         // the chunk's first position
  const long xrow0 = (row0 * H + h) * P;         // its x and y row of head h

  const int ST = c > 0 ? SPT : 0;          // state tiles
  const int T = 1 + ST + 2 * NJ;
  auto fetch = [&](int t) {
    const uint32_t dst = smem_u32(ringf + (t & 1) * slot);
    if (t == 0) {
      stage_tile(dst, ld * 4, a.c + row0 * N, N, i0, L - i0, N);
    } else if (t <= ST) {
      const int r0 = (t - 1) * TILE;
      const long plane = ((long)bi * a.nc + c) * H + h;
      stage_tile(dst, ld * 4, a.sin + plane * P * N + (long)r0 * N, N, 0, P - r0, N);
    } else {
      const int u = t - 1 - ST, j0 = (u >> 1) * TILE;
      if (u & 1)
        stage_tile(dst, ld * 4, a.x + xrow0, (long)H * P, j0, L - j0, P);
      else
        stage_tile(dst, ld * 4, a.b + row0 * N, N, j0, L - j0, N);
    }
    cp_async_commit();
  };
  fetch(0);
  if (w == 0)
    scan_chunk(a.a_log + row0 * H + h, a.dt + row0 * H + h, H, min(L, i0 + TILE), LOG2E, sCum,
               sDt, lane);

  uint32_t cf[MAX_N / 8][4];                // C rows ia, ib as fp32 A fragments over all of N
  float acc[PT][4];
  float cb[8][4];                           // C·Bᵀ of the current column tile, rows ia, ib
#pragma unroll
  for (int nt = 0; nt < PT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  for (int t = 0; t < T; ++t) {
    if (t + 1 < T) {
      fetch(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* cur = ringf + (t & 1) * slot;
    const float cia = ia < L ? sCum[ia] : NEG_INF, cib = ib < L ? sCum[ib] : NEG_INF;
    if (t == 0) {
#pragma unroll
      for (int ks = 0; ks < MAX_N / 8; ++ks)
        if (ks < nk8) ldsm_x4(cf[ks], smem_u32(cur + a_frag_off(lane, 16 * w, 8 * ks, ld)));
    } else if (t <= ST) {
      // the incoming state: c_i · state_in for rows [64 q, 64 q + 64) of p;
      // then scaled by exp(cum_i)
      const int k = t - 1;
#pragma unroll
      for (int q = 0; q < SPT; ++q) {
        if (q != k) continue;
#pragma unroll
        for (int ks = 0; ks < MAX_N / 8; ++ks) {
          if (ks >= nk8) continue;
          uint32_t ch[4], cl[4];
          split_tf32(cf[ks], ch, cl);
#pragma unroll
          for (int np = 0; np < 8; np += 2) {
            if (q * TILE + np * 8 >= P) continue;
            uint32_t bq[4], bh[4], bl[4];
            ldsm_x4(bq, smem_u32(cur + b_frag_off(lane, 8 * np, 8 * ks, ld)));
            split_tf32(bq, bh, bl);
            mma3(acc[q * 8 + np], ch, cl, bh[0], bh[1], bl[0], bl[1]);
            mma3(acc[q * 8 + np + 1], ch, cl, bh[2], bh[3], bl[2], bl[3]);
          }
        }
      }
      if (t == ST) {
        const float ea = ex2(cia), eb = ex2(cib);   // 0 past L
#pragma unroll
        for (int nt = 0; nt < PT; ++nt) {
          acc[nt][0] *= ea;
          acc[nt][1] *= ea;
          acc[nt][2] *= eb;
          acc[nt][3] *= eb;
        }
      }
    } else if (!((t - 1 - ST) & 1)) {
      // C·Bᵀ for this column tile
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) cb[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < MAX_N / 8; ++ks) {
        if (ks >= nk8) continue;
        uint32_t ch[4], cl[4];
        split_tf32(cf[ks], ch, cl);
#pragma unroll
        for (int np = 0; np < 8; np += 2) {
          uint32_t bq[4], bh[4], bl[4];
          ldsm_x4(bq, smem_u32(cur + b_frag_off(lane, 8 * np, 8 * ks, ld)));
          split_tf32(bq, bh, bl);
          mma3(cb[np], ch, cl, bh[0], bh[1], bl[0], bl[1]);
          mma3(cb[np + 1], ch, cl, bh[2], bh[3], bl[2], bl[3]);
        }
      }
    } else {
      // S·X_j over 8-column steps that reach this warp's rows
      const int jt = (t - 1 - ST) >> 1, j0 = jt * TILE;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int jk = j0 + 8 * kk;
        if (jk > i0 + 16 * w + 15 || jk >= L) continue;
        // below the diagonal and inside L: no mask
        const bool full = jk + 7 <= i0 + 16 * w && jk + 7 < L;
        const int j = jk + 2 * t4;
        const float2 cj = *reinterpret_cast<const float2*>(sCum + j);  // 0 past L
        const float2 dj = *reinterpret_cast<const float2*>(sDt + j);
        float e0 = cia - cj.x, e1 = cia - cj.y, e2 = cib - cj.x, e3 = cib - cj.y;
        if (!full) {
          // select before the exp: above the diagonal cum_i - cum_j > 0
          e0 = j <= ia ? e0 : NEG_INF;
          e1 = j + 1 <= ia ? e1 : NEG_INF;
          e2 = j <= ib ? e2 : NEG_INF;
          e3 = j + 1 <= ib ? e3 : NEG_INF;
        }
        const float* v = cb[kk];
        uint32_t ah[4], al[4];
        split_tf32(v[0] * ex2(e0) * dj.x, ah[0], al[0]);   // S[ia][j]
        split_tf32(v[2] * ex2(e2) * dj.x, ah[1], al[1]);   // S[ib][j]
        split_tf32(v[1] * ex2(e1) * dj.y, ah[2], al[2]);   // S[ia][j + 1]
        split_tf32(v[3] * ex2(e3) * dj.y, ah[3], al[3]);   // S[ib][j + 1]
        const float* x0 = cur + (8 * kk + 2 * t4) * ld + g;
#pragma unroll
        for (int np = 0; np < PT; ++np) mma3_b(acc[np], ah, al, x0[8 * np], x0[ld + 8 * np]);
      }
      if (jt == NJ - 1) {
        float* yh = a.y + xrow0 + 2 * t4;
#pragma unroll
        for (int nt = 0; nt < PT; ++nt) {
          if (ia < L)
            *reinterpret_cast<float2*>(yh + (long)ia * H * P + nt * 8) =
                make_float2(acc[nt][0], acc[nt][1]);
          if (ib < L)
            *reinterpret_cast<float2*>(yh + (long)ib * H * P + nt * 8) =
                make_float2(acc[nt][2], acc[nt][3]);
        }
      }
    }
    __syncthreads();
  }
}

// A state block in fp32: state_block's tiles and warp layout.  dxᵀ is the
// A operand and B the B operand, both read across their stored rows (the
// chunk's positions, the product's k), so each 8-row step takes its rows
// in the order 0, 2, 4, 6, 1, 3, 5, 7 in both, and every fragment is two
// rows 2 t4 and 2 t4 + 1 of a tile: dx = x · w formed in registers, both
// split into TF32 parts.
template <int P>
__device__ __forceinline__ void state_block_f32(const Args<float>& a, const Work& wk,
                                                char* smem) {
  constexpr int MT = P / 16;                // 16-row tiles of p
  constexpr int WM = MT < 4 ? MT : 4;       // warps along p
  constexpr int WN = 4 / WM;                // warps along n
  constexpr int MR = MT / WM;               // p tiles per warp
  constexpr int NQ = 8 / WN;                // most n tiles per warp
  const int bi = wk.b, c = wk.c, h = wk.h;
  const int c0 = c * a.Q;
  const int L = min(a.Q, a.S - c0);
  const int N = a.N, H = a.H;
  const int n0 = wk.tile * STATE_COLS;
  const int nw = min(N - n0, STATE_COLS);
  const int ntw = nw >> 3;
  const int pb = nw + 4, px = P + 4;        // floats a row of the B and the X tile
  const int slot = TILE * (pb + px);
  const int T = (L + TILE - 1) / TILE;
  float* ringf = reinterpret_cast<float*>(smem);
  float* sCum = ringf + 2 * slot;
  float* sW = sCum + round_tile(a.Q);       // dt, then w; zero past L, to the tile edge

  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = w % WM, wn = w / WM;
  const long row0 = (long)bi * a.S + c0;

  auto fetch = [&](int t) {
    const uint32_t dst = smem_u32(ringf + (t & 1) * slot);
    const int j0 = t * TILE;
    stage_tile(dst, pb * 4, a.b + row0 * N + n0, N, j0, L - j0, nw);
    stage_tile(dst + TILE * pb * 4, px * 4, a.x + (row0 * H + h) * P, (long)H * P, j0, L - j0,
               P);
    cp_async_commit();
  };
  fetch(0);
  if (w == 0) scan_chunk(a.a_log + row0 * H + h, a.dt + row0 * H + h, H, L, 1.f, sCum, sW, lane);
  __syncthreads();
  const float total = sCum[L - 1];
  for (int j = tid; j < L; j += TC_THREADS) sW[j] *= expf(total - sCum[j]);
  if (wk.tile == 0 && tid == 0 && a.nc > 1) a.totals[((long)bi * a.nc + c) * H + h] = total;

  float acc[MR][NQ][4];
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][q][e] = 0.f;

  for (int t = 0; t < T; ++t) {
    if (t + 1 < T) {
      fetch(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                        // the tile and sW are in place
    const float* bt = ringf + (t & 1) * slot;
    const float* xt = bt + TILE * pb;
    const int j0 = t * TILE;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      if (j0 + 8 * kk >= L) break;
      const int lr = 8 * kk + 2 * t4;        // rows lr, lr + 1 of the tile
      const float2 wv = *reinterpret_cast<const float2*>(sW + j0 + lr);
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        const int p = 16 * (wm + WM * r) + g;
        uint32_t ah[4], al[4];
        split_tf32(xt[lr * px + p] * wv.x, ah[0], al[0]);
        split_tf32(xt[lr * px + p + 8] * wv.x, ah[1], al[1]);
        split_tf32(xt[(lr + 1) * px + p] * wv.y, ah[2], al[2]);
        split_tf32(xt[(lr + 1) * px + p + 8] * wv.y, ah[3], al[3]);
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int nt = wn + WN * q;
          if (nt < ntw)
            mma3_b(acc[r][q], ah, al, bt[lr * pb + 8 * nt + g], bt[(lr + 1) * pb + 8 * nt + g]);
        }
      }
    }
    __syncthreads();                        // the ring slot is free again
  }

  float* dst = a.nc == 1 ? a.state + ((long)bi * H + h) * P * N
                         : a.ds + (((long)bi * a.nc + c) * H + h) * P * N;
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    const int p = 16 * (wm + WM * r) + g;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int nt = wn + WN * q;
      if (nt >= ntw) continue;
      const int n = n0 + nt * 8 + 2 * t4;
      *reinterpret_cast<float2*>(dst + (long)p * N + n) = make_float2(acc[r][q][0], acc[r][q][1]);
      *reinterpret_cast<float2*>(dst + (long)(p + 8) * N + n) =
          make_float2(acc[r][q][2], acc[r][q][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// The kernels and their launch (both dtypes)
// ---------------------------------------------------------------------------

template <int P, typename T>
__global__ void __launch_bounds__(TC_THREADS) ssd_chunk_kernel(const __grid_constant__ Args<T> a) {
  extern __shared__ __align__(16) char tc_buf[];
  const Work wk = block_work(a, blockIdx.x);   // uniform over the block: no barrier is left waiting
  if constexpr (sizeof(T) == 4) {
    if (wk.kind == 0)
      y_block_f32<P>(a, wk, tc_buf);
    else if (wk.kind == 1)
      state_block_f32<P>(a, wk, tc_buf);
  } else {
    if (wk.kind == 0)
      y_block<P>(a, wk, tc_buf);
    else if (wk.kind == 1)
      state_block<P>(a, wk, tc_buf);
  }
}

// The state pass, elementwise over (b, h, p, n) in float4s and in order over
// chunks: state_in(c+1) = state_in(c) exp(total_c) + ΔS_c, each chunk's
// state_in after the first written for the y blocks (bf16: high and low
// parts; fp32: as it is), and the final state.
template <typename T>
__global__ void __launch_bounds__(256)
ssd_state_kernel(const float* __restrict__ ds, const float* __restrict__ totals,
                 T* __restrict__ sin, float* __restrict__ state, int B, int H, int nc, int pn4) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long)B * H * pn4) return;
  const long bh = e / pn4;
  const int k = (int)(e - bh * pn4);
  const int b = (int)(bh / H), h = (int)(bh - (long)b * H);
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < nc; ++c) {
    const long bch = ((long)b * nc + c) * H + h;
    if (c > 0) {
      if constexpr (sizeof(T) == 4) {
        reinterpret_cast<float4*>(sin + bch * pn4 * 4)[k] = s;
      } else {
        uint2 hi, lo;
        split2(s.x, s.y, hi.x, lo.x);
        split2(s.z, s.w, hi.y, lo.y);
        reinterpret_cast<uint2*>(sin + 2 * bch * pn4 * 4)[k] = hi;
        reinterpret_cast<uint2*>(sin + (2 * bch + 1) * pn4 * 4)[k] = lo;
      }
    }
    const float4 d = reinterpret_cast<const float4*>(ds + bch * pn4 * 4)[k];
    const float et = expf(totals[bch]);
    s = make_float4(s.x * et + d.x, s.y * et + d.y, s.z * et + d.z, s.w * et + d.w);
  }
  reinterpret_cast<float4*>(state + bh * pn4 * 4)[k] = s;
}

// The blocks of each launch of a call (either dtype): the chunk kernel,
// then with more than one chunk the state pass (256 threads a block) and
// the chunk kernel again.  Returns the number of launches.
int grids(Grid a, int P, long (&g)[3]) {
  a.launch = 0;
  g[0] = y_blocks(a) + (long)a.nc * a.B * a.H * a.parts;
  if (a.nc == 1) return 1;
  g[1] = ((long)a.B * a.H * P * a.N / 4 + 255) / 256;
  a.launch = 1;
  g[2] = y_blocks(a);
  return 3;
}

template <int P, typename T>
int launch(Args<T> a, int dev, cudaStream_t st) {
  static bool attr_set[MAX_DEVICES];        // the smem opt-in, once per device
  if (!attr_set[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel<P, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        tc_smem<T>(P, MAX_N, 256));
    if (err != cudaSuccess) return (int)err;
    attr_set[dev] = true;
  }
  const int smem = tc_smem<T>(P, a.N, a.Q);
  long g[3];
  const int n = grids(a, P, g);
  a.launch = 0;
  ssd_chunk_kernel<P, T><<<(unsigned)g[0], TC_THREADS, smem, st>>>(a);
  int err = (int)cudaGetLastError();
  if (err || n == 1) return err;
  ssd_state_kernel<T><<<(unsigned)g[1], 256, 0, st>>>(a.ds, a.totals, a.sin, a.state, a.B, a.H,
                                                      a.nc, P * a.N / 4);
  if ((err = (int)cudaGetLastError())) return err;
  a.launch = 1;
  ssd_chunk_kernel<P, T><<<(unsigned)g[2], TC_THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// A call of dtype T: its tensors in Args, the launch for its P.
template <typename T>
int launch_call(const void* x, const void* a_log, const void* b, const void* c, const void* dt,
                void* y, void* state, void* work, int B, int S, int H, int P, int N, int Q,
                int dev, cudaStream_t st) {
  Args<T> a{};
  static_cast<Grid&>(a) = sized(B, S, H, N, Q);
  const long pn = (long)B * a.nc * H * P * N;
  a.x = static_cast<const T*>(x);
  a.b = static_cast<const T*>(b);
  a.c = static_cast<const T*>(c);
  a.a_log = static_cast<const float*>(a_log);
  a.dt = static_cast<const float*>(dt);
  a.y = static_cast<T*>(y);
  a.state = static_cast<float*>(state);
  a.ds = static_cast<float*>(work);
  a.sin = a.nc > 1 ? reinterpret_cast<T*>(a.ds + pn) : nullptr;  // P·N floats of room a plane
  a.totals = a.nc > 1 ? a.ds + 2 * pn : nullptr;
  auto* fn = P == 16 ? launch<16, T> : P == 32 ? launch<32, T> : P == 64 ? launch<64, T>
                                                                         : launch<128, T>;
  return fn(a, dev, st);
}

int log2_exact(int v) {
  int lg = 0;
  while ((1 << lg) < v) ++lg;
  return (1 << lg) == v ? lg : -1;
}

bool sizes_ok(int P, int N, int Q) {
  const int lgP = log2_exact(P), lgN = log2_exact(N);
  return lgP >= 4 && P <= 128 && lgN >= 4 && N <= MAX_N && Q > 0 && Q <= 256;
}

// Sizes the grids and block decode can index in an int.
bool grid_ok(int B, int S, int H, int P, int N, int Q) {
  if (B <= 0 || S <= 0 || H <= 0 || !sizes_ok(P, N, Q)) return false;
  const Grid a = sized(B, S, H, N, Q);
  return (long)a.nc * B * H * (a.n_it + a.parts) <= 2147483647L;
}

// Fills the dynamic shared memory of every block with `value` (volatile:
// the stores are the kernel's whole effect).
__global__ void fill_smem_kernel(float value, int n) {
  extern __shared__ float fill_buf[];
  volatile float* v = fill_buf;
  for (int i = threadIdx.x; i < n; i += blockDim.x) v[i] = value;
}

}  // namespace

extern "C" {

// dtype (of x, b, c and y): 0 = float32, 1 = bfloat16.  work: with more
// than one chunk, B*nc*H*(2*P*N + 1) floats of scratch (nc = ceil(S / Q));
// else unused.  Launches on `device` (made current for the launch when it
// is not, then restored) and `stream`.  Returns a cudaError_t: the result
// of cudaGetLastError() after the launches (0 when they were accepted).
int ssd_scan_fwd(const void* x, const void* a_log, const void* b, const void* c,
                 const void* dt, void* y, void* state, void* work, int dtype, int B, int S,
                 int H, int P, int N, int Q, int device, void* stream) {
  if (!grid_ok(B, S, H, P, N, Q) || (dtype != 0 && dtype != 1) || device < 0 ||
      device >= MAX_DEVICES || (S > Q && work == nullptr))
    return (int)cudaErrorInvalidValue;
  int cur = 0;
  int err = (int)cudaGetDevice(&cur);
  if (err) return err;
  if (cur != device && (err = (int)cudaSetDevice(device))) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = dtype == 0 ? launch_call<float>(x, a_log, b, c, dt, y, state, work, B, S, H, P, N, Q,
                                        device, st)
                   : launch_call<__nv_bfloat16>(x, a_log, b, c, dt, y, state, work, B, S, H, P,
                                                N, Q, device, st);
  if (cur != device) cudaSetDevice(cur);
  return err;
}

// The kernel's constants: out = {TILE, STATE_COLS, threads a block}.
void ssd_scan_config(int* out) {
  out[0] = TILE;
  out[1] = STATE_COLS;
  out[2] = TC_THREADS;
}

// The blocks of each launch of a call into grids[0..2]; returns the number
// of launches (1 or 3), or 0 if the sizes are unsupported.
int ssd_scan_grids(int B, int S, int H, int P, int N, int Q, long long* out) {
  if (!grid_ok(B, S, H, P, N, Q)) return 0;
  long g[3];
  const int n = grids(sized(B, S, H, N, Q), P, g);
  for (int i = 0; i < n; ++i) out[i] = g[i];
  return n;
}

// What block `blk` of chunk-kernel launch `launch` (0 or 1) of a call
// computes, decoded as the kernel decodes it: out = {kind, b, c, h, tile}
// (kind 0: y, tile the row tile; 1: state, tile the 64 columns of N; -1:
// none).  Returns 0, or -1 if the sizes or the block are out of range.
int ssd_scan_block(int B, int S, int H, int P, int N, int Q, int launch, int blk, int* out) {
  if (!grid_ok(B, S, H, P, N, Q) || launch < 0 || launch > 1 || blk < 0) return -1;
  Grid a = sized(B, S, H, N, Q);
  long g[3];
  const int n = grids(a, P, g);
  if ((launch == 1 && n == 1) || blk >= g[launch ? 2 : 0]) return -1;
  a.launch = launch;
  const Work w = block_work(a, blk);
  out[0] = w.kind, out[1] = w.b, out[2] = w.c, out[3] = w.h, out[4] = w.tile;
  return 0;
}

// Dynamic shared memory one block of a call of `dtype` needs (0 if the
// sizes are unsupported).
int ssd_scan_smem_bytes(int dtype, int P, int N, int Q) {
  if (!sizes_ok(P, N, Q)) return 0;
  return dtype == 1 ? tc_smem<__nv_bfloat16>(P, N, Q) : tc_smem<float>(P, N, Q);
}

// The most dynamic shared memory a block may opt into on this device.
int ssd_scan_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess)
    return -1;
  return v;
}

// Writes `value` over all the shared memory a block may opt into, in four
// blocks per SM on `device` and `stream`: what the next kernel finds in
// shared memory it does not write (for tests).  Returns a cudaError_t.
int ssd_scan_fill_smem(float value, int device, void* stream) {
  int cur = 0, bytes = 0, sms = 0;
  int err = (int)cudaGetDevice(&cur);
  if (err) return err;
  if (cur != device && (err = (int)cudaSetDevice(device))) return err;
  if (!(err = (int)cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                          device)) &&
      !(err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) &&
      !(err = (int)cudaFuncSetAttribute(fill_smem_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes))) {
    fill_smem_kernel<<<4 * sms, 256, bytes, static_cast<cudaStream_t>(stream)>>>(
        value, bytes / (int)sizeof(float));
    err = (int)cudaGetLastError();
  }
  if (cur != device) cudaSetDevice(cur);
  return err;
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

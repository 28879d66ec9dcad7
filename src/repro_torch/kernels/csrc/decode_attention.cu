// K6: one-token GQA decode attention against a (B, S_max, Hkv, D) K/V cache,
// with the rotary embedding and the cache write, for Hopper (sm_90a).
//
// It replaces no TPU kernel: the reference's decode attention
// (repro/models/attention.py::decode_attention) is plain jnp, which XLA
// fuses.  It was added because the port's plain PyTorch version of that
// function could not be batched over (b, kv head) in the cache's layout:
// its einsum copied the whole cache, K and V, in every layer of every step
// (79 % of a deepseek-moe-16b chat step's device time), and its rope, mask
// and write took some 70 host dispatches a layer.
//
// It computes, for each row b with position p = pos[b]: rope on q and the
// new k in fp32 as models.layers.apply_rope does (angles p * inv, inv the
// plain rope_freqs passed in; x1 c - x2 s and x2 c + x1 s, each product and
// sum rounded as PyTorch's separate ops round them; rounded to the model's
// dtype), or no rope where the plan has no
// frequencies (NoPE attention), the new k and v rows written into the
// cache at p, then attention of the rep query heads of each kv head over
// positions max(0, p - window + 1) .. p (window 0: 0 .. p) at the plan's
// softmax scale (D**-0.5 unless the model sets another).
// Logits, probabilities and P V stay in fp32 (the plain version rounds the
// logits and the probabilities to bf16 in a bf16 model); the output is
// rounded once, to q's dtype.  A row whose p lies outside [0, S_max) writes
// nothing and gets a zero output.
//
// Layout: q (B, H, D), k_new, v_new (B, Hkv, D), out (B, H, D), all
// contiguous; the caches contiguous (B, S_max, Hkv, D), read and written
// where they lie: no copy, no transpose and no mask tensor.
//
// What bounds it on an H100: the bytes.  A decode step attends about one
// K and one V row per (row, kv head, position), each read once; at 2
// flops per multiply-add it does 4 * rep operations per element read,
// three orders below the card's ridge (hopper-kernels guide, section 1).
// So the design moves only the bytes the positions in use need:
//
// * Grid (splits, Hkv, B): block (s, h, b) owns positions
//   [s * split_len, (s + 1) * split_len) of row b, kv head h.  The split
//   count depends on S_max and B * Hkv alone (the wrapper's `schedule`),
//   so that rows of unequal length still fill the 132 SMs.  A block whose
//   split lies wholly past the row's frontier (or before its window)
//   exits at once; a split's own range stops at the frontier.
// * One block handles all rep query heads of its kv head: each K and V
//   byte is read from device memory once.  K and V arrive in TILE-row
//   tiles through a two-stage ring of 16-byte cp.async copies (the next
//   tile's copy runs under this one's math), only the rows in range.
// * Logits: a group of D / E threads (E elements in 16 bytes) takes one
//   key row, an fp32 dot product per query head, summed over the group by
//   xor shuffles.  An online softmax (a warp per query head) keeps the
//   running max and sum in fp32.  P V: each thread owns two columns of
//   every query head's output and a slice of the tile's rows; the slices
//   are summed in a fixed order at the end.
// * Only the split that holds p writes the new rows (to the cache, and
//   into its last tile in shared memory in place of the stale row, which
//   it never loads).  No other block reads that row.
// * A row whose positions lie in one split gets its output from that
//   block.  Otherwise each of its splits writes its unnormalised output,
//   max and sum (fp32) to a scratch buffer and takes a ticket (an atomic
//   counter per (row, kv head)); the last one merges the row's splits in
//   split order and sets the counter back to zero.  Every sum has a fixed
//   order, whichever block merges: two launches on the same inputs are
//   bitwise equal.  One launch a layer.
// * The launch depends on the shapes and the window alone (positions are
//   read on the device), so a CUDA graph can hold it.  Everything but the
//   tensors' addresses is fixed once per shape in a plan
//   (decode_attention_plan), so a call passes ten arguments.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;            // threads per block
constexpr int MAX_DEVICES = 64;
constexpr int MAX_REP = 16;        // query heads per kv head
constexpr int SPLIT_ALIGN = 64;    // split_len is a multiple of this, and so of every TILE

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int TILE = 32;  // key rows per stage: 16 KB of K at D = 128
  __device__ static float f(float x) { return x; }
  __device__ static float cast(float x) { return x; }
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int TILE = 64;
  __device__ static float f(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 cast(float x) { return __float2bfloat16_rn(x); }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes of shared memory as fp32.
__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
// Two adjacent elements as fp32.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T, int D>
struct Shape {
  static constexpr int TILE = Elem<T>::TILE;
  static constexpr int E = 16 / sizeof(T);          // elements per 16-byte chunk
  static constexpr int CPR = D / E;                 // chunks per row: threads per key row
  static constexpr int ROWS = NT / CPR;             // key rows a pass of the block takes
  static constexpr int PAIRS = D / 2;               // column pairs of an output row
  static constexpr int SLICES = NT / PAIRS;         // row slices of P V
  static constexpr int H2 = D / 2;
  static constexpr int RING = 4 * TILE * D * (int)sizeof(T);  // K, V x 2 stages
  static_assert(CPR <= 32 && 32 % CPR == 0 && TILE % ROWS == 0, "a key row within a warp");
  static_assert(SLICES >= 1 && NT % PAIRS == 0 && TILE % 32 == 0, "pairs and softmax lanes");
  // Dynamic shared memory at `rep` query heads: the ring (reused by the
  // slice sums at the end), q, the tile's scores, the running max, sum and
  // rescale, the rope's cos and sin, and the new k row.
  static int smem(int rep) {
    const int red = SLICES * rep * D * 4;
    return (RING > red ? RING : red) + rep * D * 4 + rep * TILE * 4 + 3 * rep * 4 + D * 4 +
           D * (int)sizeof(T);
  }
};

template <typename T, int D, int RMAX>
__global__ void __launch_bounds__(NT)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                    const T* __restrict__ v_new, T* __restrict__ cache_k,
                    T* __restrict__ cache_v, const int* __restrict__ pos,
                    const float* __restrict__ inv, T* __restrict__ out,
                    float* __restrict__ part, unsigned int* __restrict__ tickets, int S,
                    int Hkv, int rep, int window, float scale, int split_len) {
  using Sh = Shape<T, D>;
  using El = Elem<T>;
  constexpr int TILE = Sh::TILE, E = Sh::E, CPR = Sh::CPR, H2 = Sh::H2;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;

  T* ob = out + ((size_t)b * Hkv + kvh) * rep * D;  // this kv head's rep output rows
  const int p_hi = pos[b];
  if (p_hi < 0 || p_hi >= S) {
    if (split == 0)
      for (int i = tid; i < rep * D; i += NT) ob[i] = Elem<T>::cast(0.f);
    return;
  }
  const int p_lo = window > 0 ? max(0, p_hi - window + 1) : 0;
  const int first = max(p_lo, split * split_len);              // this block's positions
  const int last = min(p_hi, split * split_len + split_len - 1);
  if (first > last) return;
  const bool holds_new = last == p_hi;

  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);                 // [2][TILE][D]
  T* vs = ks + 2 * TILE * D;                          // [2][TILE][D]
  float* red = reinterpret_cast<float*>(smem);        // [SLICES][rep][D], after the loop
  const int ring = Sh::RING > Sh::SLICES * rep * D * 4 ? Sh::RING : Sh::SLICES * rep * D * 4;
  float* qs = reinterpret_cast<float*>(smem + ring);  // [rep][D], roped
  float* sc = qs + rep * D;                           // [rep][TILE]: scores, then P
  float* run_m = sc + rep * TILE;                     // [rep]
  float* run_l = run_m + rep;
  float* run_a = run_l + rep;                         // this tile's rescale
  float* cs = run_a + rep;                            // [H2] cos, [H2] sin
  T* kn = reinterpret_cast<T*>(cs + D);               // [D]: the new k row, roped

  const size_t row_stride = (size_t)Hkv * D;          // elements between positions
  const size_t cache_base = (size_t)b * S * row_stride + (size_t)kvh * D;
  const int t_first = first / TILE, t_last = last / TILE;
  const int load_last = holds_new ? p_hi - 1 : last;  // the stale row at p_hi is not read

  auto load_tile = [&](int ti, int slot) {
    const int r0 = max(first, ti * TILE), r1 = min(load_last, ti * TILE + TILE - 1);
    const int n = (r1 - r0 + 1) * CPR;
    for (int c = tid; c < n; c += NT) {
      const int p = r0 + c / CPR, col = (c % CPR) * E;
      const size_t g = cache_base + (size_t)p * row_stride + col;
      const int s = (slot * TILE + p - ti * TILE) * D + col;
      cp_async16(smem_u32(ks + s), cache_k + g);
      cp_async16(smem_u32(vs + s), cache_v + g);
    }
  };
  load_tile(t_first, 0);
  cp_async_commit();

  // Rope's angles for this row, then q's rep heads (and the new k row where
  // this block holds p), each rotated as apply_rope does and rounded to T.
  if (inv)
    for (int j = tid; j < H2; j += NT) {
      const float ang = __fmul_rn(static_cast<float>(p_hi), inv[j]);
      cs[j] = cosf(ang);
      cs[H2 + j] = sinf(ang);
    }
  for (int r = tid; r < rep; r += NT) {
    run_m[r] = -INFINITY;
    run_l[r] = 0.f;
  }
  __syncthreads();
  const T* qb = q + ((size_t)b * Hkv + kvh) * rep * D;
  for (int i = tid; i < rep * H2; i += NT) {
    const int r = i / H2, j = i % H2;
    const float x1 = El::f(qb[r * D + j]), x2 = El::f(qb[r * D + H2 + j]);
    if (!inv) {  // no rope: q as it is
      qs[r * D + j] = x1;
      qs[r * D + H2 + j] = x2;
      continue;
    }
    const float c = cs[j], s = cs[H2 + j];
    qs[r * D + j] = El::f(El::cast(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s))));
    qs[r * D + H2 + j] = El::f(El::cast(__fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s))));
  }
  if (holds_new) {
    const T* kb = k_new + ((size_t)b * Hkv + kvh) * D;
    const T* vb = v_new + ((size_t)b * Hkv + kvh) * D;
    const size_t g = cache_base + (size_t)p_hi * row_stride;
    for (int j = tid; j < H2; j += NT) {
      T lo = kb[j], hi = kb[H2 + j];
      if (inv) {
        const float x1 = El::f(lo), x2 = El::f(hi);
        const float c = cs[j], s = cs[H2 + j];
        lo = El::cast(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s)));
        hi = El::cast(__fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s)));
      }
      kn[j] = lo;
      kn[H2 + j] = hi;
      cache_k[g + j] = lo;
      cache_k[g + H2 + j] = hi;
    }
    for (int j = tid; j < D; j += NT) cache_v[g + j] = vb[j];
  }

  __syncthreads();

  // A thread's chunk of each query head, in registers while they fit.
  constexpr bool QREG = RMAX * E <= 32;
  const int chunk = tid % CPR;
  float qreg[QREG ? RMAX : 1][E];
  if constexpr (QREG) {
#pragma unroll
    for (int r = 0; r < RMAX; ++r)
#pragma unroll
      for (int e = 0; e < E; ++e) qreg[r][e] = r < rep ? qs[r * D + chunk * E + e] : 0.f;
  }
  float acc[RMAX][2];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) acc[r][0] = acc[r][1] = 0.f;
  const int warp = tid / 32, lane = tid % 32;
  const int pair = tid % Sh::PAIRS, slice = tid / Sh::PAIRS;

  for (int ti = t_first; ti <= t_last; ++ti) {
    const int slot = (ti - t_first) & 1;
    if (ti < t_last) load_tile(ti + 1, slot ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    const int base = ti * TILE;
    const int t0 = max(first, base) - base, t1 = min(last, base + TILE - 1) - base;
    T* kt = ks + slot * TILE * D;
    T* vt = vs + slot * TILE * D;
    if (holds_new && ti == t_last) {
      const T* vb = v_new + ((size_t)b * Hkv + kvh) * D;
      for (int j = tid; j < D; j += NT) {
        kt[(p_hi - base) * D + j] = kn[j];
        vt[(p_hi - base) * D + j] = vb[j];
      }
    }
    __syncthreads();

    // Logits: each group of CPR lanes one key row; lanes of a group agree.
    for (int t = tid / CPR; t < TILE; t += Sh::ROWS) {
      float kx[E];
      load16(kt + t * D + chunk * E, kx);
      const bool in = t >= t0 && t <= t1;
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        if (r < rep) {
          float qx[E];
          if constexpr (QREG) {
#pragma unroll
            for (int e = 0; e < E; ++e) qx[e] = qreg[r][e];
          } else {
#pragma unroll
            for (int e = 0; e < E; e += 4) {
              const float4 v4 = *reinterpret_cast<const float4*>(qs + r * D + chunk * E + e);
              qx[e] = v4.x; qx[e + 1] = v4.y; qx[e + 2] = v4.z; qx[e + 3] = v4.w;
            }
          }
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) d = fmaf(qx[e], kx[e], d);
#pragma unroll
          for (int off = CPR / 2; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
          if (chunk == 0) sc[r * TILE + t] = in ? d * scale : -INFINITY;
        }
      }
    }
    __syncthreads();

    // Online softmax: a warp per query head.
    for (int r = warp; r < rep; r += NT / 32) {
      float v[TILE / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < TILE / 32; ++i) {
        v[i] = sc[r * TILE + lane + 32 * i];
        mx = fmaxf(mx, v[i]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(run_m[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < TILE / 32; ++i) {
        const float p = expf(v[i] - m_new);
        sc[r * TILE + lane + 32 * i] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(run_m[r] - m_new);
        run_a[r] = alpha;
        run_l[r] = run_l[r] * alpha + sum;
        run_m[r] = m_new;
      }
    }
    __syncthreads();

    // P V: two columns of every head, over one slice of the tile's rows.
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      if (r < rep) {
        acc[r][0] *= run_a[r];
        acc[r][1] *= run_a[r];
      }
    }
    for (int t = t0 + slice; t <= t1; t += Sh::SLICES) {
      const float2 vv = load2(vt + t * D + 2 * pair);
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        if (r < rep) {
          const float p = sc[r * TILE + t];
          acc[r][0] = fmaf(p, vv.x, acc[r][0]);
          acc[r][1] = fmaf(p, vv.y, acc[r][1]);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  // Sum the slices in slice order.  A row whose positions lie in one split
  // writes its output here; otherwise each split writes its partial (o
  // unnormalised, then max and sum per head), and the last of the row's
  // splits to finish (a ticket per (row, kv head)) merges them in split
  // order, so the result does not depend on which one is last.
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    if (r < rep) {
      red[(slice * rep + r) * D + 2 * pair] = acc[r][0];
      red[(slice * rep + r) * D + 2 * pair + 1] = acc[r][1];
    }
  }
  __syncthreads();
  const int s_first = p_lo / split_len, s_last = p_hi / split_len;
  if (s_first == s_last) {
    for (int i = tid; i < rep * D; i += NT) {
      float o = 0.f;
#pragma unroll
      for (int s = 0; s < Sh::SLICES; ++s) o += red[s * rep * D + i];
      ob[i] = El::cast(o / run_l[i / D]);
    }
    return;
  }
  const size_t row = ((size_t)b * Hkv + kvh) * gridDim.x;   // (b, kvh, split 0)
  float* o_part = part + row * rep * D;
  float* ml = part + (size_t)gridDim.z * Hkv * gridDim.x * rep * D + row * rep * 2;
  for (int i = tid; i < rep * D; i += NT) {
    float o = 0.f;
#pragma unroll
    for (int s = 0; s < Sh::SLICES; ++s) o += red[s * rep * D + i];
    o_part[(size_t)split * rep * D + i] = o;
  }
  for (int r = tid; r < rep; r += NT) {
    ml[(split * rep + r) * 2] = run_m[r];
    ml[(split * rep + r) * 2 + 1] = run_l[r];
  }
  __threadfence();
  __syncthreads();
  __shared__ bool merges;
  if (tid == 0)
    merges = atomicAdd(&tickets[(size_t)b * Hkv + kvh], 1u) == (unsigned)(s_last - s_first);
  __syncthreads();
  if (!merges) return;
  __threadfence();
  for (int i = tid; i < rep * D; i += NT) {
    const int r = i / D;
    float mx = -INFINITY;
    for (int s = s_first; s <= s_last; ++s) mx = fmaxf(mx, __ldcg(&ml[(s * rep + r) * 2]));
    float l = 0.f, o = 0.f;
    for (int s = s_first; s <= s_last; ++s) {
      const float w = expf(__ldcg(&ml[(s * rep + r) * 2]) - mx);
      l = fmaf(w, __ldcg(&ml[(s * rep + r) * 2 + 1]), l);
      o = fmaf(w, __ldcg(&o_part[(size_t)s * rep * D + i]), o);
    }
    ob[i] = El::cast(o / l);
  }
  if (tid == 0) tickets[(size_t)b * Hkv + kvh] = 0u;  // ready for the next launch
}

// A launch's shape, fixed per plan: everything but the tensors' addresses.
struct Plan {
  int dtype, B, S, Hkv, rep, D, window, splits, split_len, device;
  float scale;
  const float* inv;       // rope_freqs(D, theta) on the device; null: no rope
  float* part;            // B * Hkv * splits * rep * (D + 2) floats when splits > 1
  unsigned int* tickets;  // B * Hkv counters, zero between launches, when splits > 1
};

typedef int (*LaunchFn)(const Plan&, const void*, const void*, const void*, void*, void*,
                        const int*, void*, cudaStream_t);

template <typename T, int D, int RMAX>
int launch(const Plan& p, const void* q, const void* k_new, const void* v_new, void* cache_k,
           void* cache_v, const int* pos, void* out, cudaStream_t stream) {
  using Sh = Shape<T, D>;
  static bool attr_set[MAX_DEVICES];  // the smem opt-in at RMAX heads, once per device
  if (!attr_set[p.device]) {
    const cudaError_t err =
        cudaFuncSetAttribute(decode_split_kernel<T, D, RMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::smem(RMAX));
    if (err != cudaSuccess) return (int)err;
    attr_set[p.device] = true;
  }
  decode_split_kernel<T, D, RMAX><<<dim3(p.splits, p.Hkv, p.B), NT, Sh::smem(p.rep), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<T*>(cache_k), static_cast<T*>(cache_v), pos, p.inv,
      static_cast<T*>(out), p.part, p.tickets, p.S, p.Hkv, p.rep, p.window, p.scale,
      p.split_len);
  return (int)cudaGetLastError();
}

template <typename T, int D>
LaunchFn by_rep(int rep) {
  return rep == 1 ? launch<T, D, 1> : rep <= 4 ? launch<T, D, 4> : launch<T, D, MAX_REP>;
}

template <typename T>
LaunchFn by_dim(int D, int rep) {
  switch (D) {
    case 16: return by_rep<T, 16>(rep);
    case 32: return by_rep<T, 32>(rep);
    case 64: return by_rep<T, 64>(rep);
    case 128: return by_rep<T, 128>(rep);
    default: return nullptr;
  }
}

constexpr int MAX_PLANS = 4096;
Plan plans[MAX_PLANS];
LaunchFn plan_fns[MAX_PLANS];
int n_plans = 0;

template <typename T>
int smem_of(int D, int rep) {
  switch (D) {
    case 16: return Shape<T, 16>::smem(rep);
    case 32: return Shape<T, 32>::smem(rep);
    case 64: return Shape<T, 64>::smem(rep);
    case 128: return Shape<T, 128>::smem(rep);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// A plan for launches of one shape: dtype 0 = float32, 1 = bfloat16; inv
// the D / 2 inverse frequencies on `device`, or null for no rope; scale the
// softmax scale; part and tickets as in Plan
// (the tickets zeroed), both unused when splits == 1.  Returns the plan's
// index (>= 0), or minus a cudaError_t when the shape is not taken.
int decode_attention_plan(int dtype, int B, int S, int Hkv, int rep, int D, int window,
                          float scale, int splits, int split_len, int device, const void* inv,
                          void* part, void* tickets) {
  if (B <= 0 || B > 65535 || S <= 0 || Hkv <= 0 || Hkv > 65535 || rep <= 0 ||
      rep > MAX_REP || window < 0 || splits <= 0 || split_len <= 0 ||
      split_len % SPLIT_ALIGN || (long)(splits - 1) * split_len >= S ||
      (long)splits * split_len < S || (splits > 1 && (!part || !tickets)) ||
      device < 0 || device >= MAX_DEVICES || n_plans >= MAX_PLANS)
    return -(int)cudaErrorInvalidValue;
  const LaunchFn fn = dtype == 0 ? by_dim<float>(D, rep)
                      : dtype == 1 ? by_dim<__nv_bfloat16>(D, rep) : nullptr;
  if (!fn) return -(int)cudaErrorInvalidValue;
  plans[n_plans] = Plan{dtype, B, S, Hkv, rep, D, window, splits, split_len, device, scale,
                        static_cast<const float*>(inv), static_cast<float*>(part),
                        static_cast<unsigned int*>(tickets)};
  plan_fns[n_plans] = fn;
  return n_plans++;
}

// One launch of plan `plan` on `stream`: q (B, H, D), k_new, v_new (B, Hkv,
// D), the caches (B, S, Hkv, D), out (B, H, D); pos a (B,) int32 device
// array.  Makes the plan's device
// current for the launch when it is not.  Returns a cudaError_t: the result
// of cudaGetLastError() right after the launch (0 when it was accepted).
int decode_attention_run(int plan, const void* q, const void* k_new, const void* v_new,
                         void* cache_k, void* cache_v, const void* pos, void* out, void* stream) {
  if (plan < 0 || plan >= n_plans) return (int)cudaErrorInvalidValue;
  const Plan& p = plans[plan];
  int cur = 0;
  int err = (int)cudaGetDevice(&cur);
  if (err) return err;
  if (cur != p.device && (err = (int)cudaSetDevice(p.device))) return err;
  err = plan_fns[plan](p, q, k_new, v_new, cache_k, cache_v, static_cast<const int*>(pos),
                       out, static_cast<cudaStream_t>(stream));
  if (cur != p.device) cudaSetDevice(cur);
  return err;
}

// Dynamic shared memory of the split kernel at (dtype, D, rep); -1 if unsupported.
int decode_attention_smem(int dtype, int D, int rep) {
  if (rep <= 0 || rep > MAX_REP) return -1;
  return dtype == 0 ? smem_of<float>(D, rep) : dtype == 1 ? smem_of<__nv_bfloat16>(D, rep) : -1;
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

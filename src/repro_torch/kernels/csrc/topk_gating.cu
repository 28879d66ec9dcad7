// K5: fused MoE router gating (softmax over E experts, then top-k) for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/topk_gating.py::_gating_kernel.
// It computes the same function: probs = exp(x - max) / sum(exp(x - max)) over
// a row of E fp32 logits, then k argmax-and-mask steps, each taking the
// largest remaining probability with ties going to the smallest expert index
// (the order of lax.top_k), and masking it with -1.
//
// Layout: logits (T, E) fp32, row-major; outputs top_p (T, k) fp32 and
// top_ids (T, k) int32.  The kernel masks T itself: no padding to a block.
//
// Design: one warp per token row, 8 rows per block of 256 threads.  Lane l
// holds columns l, l + 32, ... (at most 8, so E <= 256); the max and the sum
// go through xor shuffles, and each argmax step reduces (value, index) pairs
// the same way under a total order (larger value, then smaller index), so
// every lane agrees on the pick.  k <= 32 results are kept in lanes 0..k-1
// (result i in lane i) and written once; k is a loop bound, so k = 6
// (deepseek-moe-16b) and k = 10 of E = 72 (granite-4.0-h-small) run the
// same code.  Sums run in a fixed order: two launches on the same
// inputs are bitwise equal.
//
// What bounds it on an H100: at deepseek-moe-16b's router (E = 64, k = 6)
// and T = 256 tokens it reads 64 KB and writes 12 KB, a fraction of a
// microsecond at 3.35 TB/s; the launch itself dominates (about 3 us of
// device time per launch), and a call's time is its host path.  So the
// entry point takes the device index and makes it current only when it is
// not (no torch.cuda.device context around the call), and the stream as a
// raw handle.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;          // threads per block
constexpr int ROWS = NT / 32;    // rows per block, one warp each
constexpr int MAX_E = 256;
constexpr int EPL = MAX_E / 32;  // columns per lane
constexpr int MAX_K = 32;        // a lane per result

__global__ void __launch_bounds__(NT)
topk_gating_kernel(const float* __restrict__ logits, float* __restrict__ top_p,
                   int* __restrict__ top_ids, int T, int E, int K) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS + (threadIdx.x >> 5);
  if (row >= T) return;  // uniform across the warp
  const float* lr = logits + (long)row * E;

  float p[EPL];
  float m = -INFINITY;
#pragma unroll
  for (int c = 0; c < EPL; ++c) {
    const int col = lane + 32 * c;
    p[c] = col < E ? lr[col] : -INFINITY;
    m = fmaxf(m, p[c]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < EPL; ++c) {
    p[c] = lane + 32 * c < E ? expf(p[c] - m) : 0.f;
    s += p[c];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  // Columns past E hold -1, below every probability, as a taken one does.
#pragma unroll
  for (int c = 0; c < EPL; ++c) p[c] = lane + 32 * c < E ? p[c] / s : -1.f;

  float out_p = 0.f;
  int out_id = 0;
  for (int i = 0; i < K; ++i) {
    float bv = -2.f;
    int bi = 0x7fffffff;
#pragma unroll
    for (int c = 0; c < EPL; ++c)
      if (p[c] > bv) {  // strict: the lower column of this lane wins a tie
        bv = p[c];
        bi = lane + 32 * c;
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == i) {
      out_p = bv;
      out_id = bi;
    }
#pragma unroll
    for (int c = 0; c < EPL; ++c)
      if (lane + 32 * c == bi) p[c] = -1.f;
  }
  if (lane < K) {
    top_p[(long)row * K + lane] = out_p;
    top_ids[(long)row * K + lane] = out_id;
  }
}

}  // namespace

extern "C" {

// Launches on `device` (made current for the launch when it is not, then
// restored) and `stream`.  Returns a cudaError_t: the result of
// cudaGetLastError() right after the launch (0 when it was accepted).
int topk_gating_fwd(const void* logits, void* top_p, void* top_ids, int T, int E, int K,
                    int device, void* stream) {
  if (T <= 0 || E <= 0 || E > MAX_E || K <= 0 || K > MAX_K || K > E || device < 0)
    return (int)cudaErrorInvalidValue;
  int cur = 0;
  int err = (int)cudaGetDevice(&cur);
  if (err) return err;
  if (cur != device && (err = (int)cudaSetDevice(device))) return err;
  const int blocks = (T + ROWS - 1) / ROWS;
  topk_gating_kernel<<<blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<float*>(top_p),
      static_cast<int*>(top_ids), T, E, K);
  err = (int)cudaGetLastError();
  if (cur != device) cudaSetDevice(cur);
  return err;
}

const char* topk_gating_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// What the two flash attention backward libraries share
// (flash_attention_bwd.cu on the fp32 cores, flash_bwd_tc.cu on the tensor
// cores): their parameters, the mask of a (query, key) pair, and the
// row-delta pass delta_i = sum_d dO_id * O_id that both run first.  With
// o_lo (the rounding residual the bf16 tensor-core forward writes beside
// O, fp32 O - O, in bf16) the pass sums dO_id * (O_id + o_lo_id): the
// unrounded output's delta, to ~2^-16.  Over the rounded O alone delta
// misses sum_j P_ij dP_ij by dO . (rounding of O), so the row sums of dS
// are no longer zero, and a gradient that sums them (a key bias: it is
// zero wherever the softmax ignores a shift) picks up that bias, growing
// with the query heads a kv head sums (PERF.md, section 6).
#pragma once

#include "common.cuh"

namespace {

constexpr int kDeltaThreads = 256;   // 8 rows (one warp each) a block

struct Params {
  const float* lse;     // (B, Hq, Sq)
  const float* delta;   // (B, Hq, Sq)
  int Sq, Skv, Hq, Hkv, causal, chunk;
  float scale;
  int window = 0;       // a key sees queries up to window - 1 later; 0
                        // for none (both kernels take it)
};

__device__ __forceinline__ bool visible(const Params& p, int qp, int kp) {
  bool ok = qp < p.Sq && kp < p.Skv;
  if (p.causal) ok = ok && kp <= qp;
  if (p.window) ok = ok && kp > qp - p.window;
  if (p.chunk) ok = ok && kp / p.chunk == qp / p.chunk;
  return ok;
}

template <typename T>
__global__ void __launch_bounds__(kDeltaThreads)
delta_kernel(const T* __restrict__ o, const T* __restrict__ o_lo,
             const T* __restrict__ dout, float* __restrict__ delta,
             long long rows, int Sq, int Hq, int D) {
  const long long r = (long long)blockIdx.x * (kDeltaThreads / 32) +
                      threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  float acc = 0.f;
  if (o_lo)
    for (int d = lane; d < D; d += 32)
      acc = fmaf(to_f32(o[r * D + d]) + to_f32(o_lo[r * D + d]),
                 to_f32(dout[r * D + d]), acc);
  else
    for (int d = lane; d < D; d += 32)
      acc = fmaf(to_f32(o[r * D + d]), to_f32(dout[r * D + d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {   // row r of the model layout is (b, i, h)
    const int h = (int)(r % Hq);
    const long long bi = r / Hq;
    const int i = (int)(bi % Sq), b = (int)(bi / Sq);
    delta[((size_t)b * Hq + h) * Sq + i] = acc;
  }
}

// delta (B, Hq, Sq) from o, o_lo (null: none) and dout (B, Sq, Hq, D);
// the launch's error
template <typename T>
cudaError_t launch_delta(const void* o, const void* o_lo, const void* dout,
                         float* delta, int B, int Sq, int Hq, int D,
                         cudaStream_t s) {
  const long long rows = (long long)B * Sq * Hq;
  constexpr int kRows = kDeltaThreads / 32;
  delta_kernel<T><<<(unsigned)((rows + kRows - 1) / kRows), kDeltaThreads, 0,
                    s>>>(static_cast<const T*>(o),
                         static_cast<const T*>(o_lo),
                         static_cast<const T*>(dout), delta, rows, Sq, Hq, D);
  return cudaGetLastError();
}

}  // namespace

// RG-LRU gated linear recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan/kernel.py:
// rglru_scan_kernel (body _rglru_kernel): h[t] = a[t] * h[t-1] + b[t],
// elementwise over the width W, from h[-1] = 0, the state in fp32, every
// h[t] written in the input type.
//
// Layout: a, b, h (B, S, W), contiguous, one type (fp32 or bf16).
//
// Bound: bytes (one multiply-add per three elements moved).  Design, simple
// first: one thread per (batch, channel) holds the state in a register and
// loops over time; the TPU grid's sequential time axis becomes that loop,
// its width blocks become the grid (64-thread blocks, so B * W / 64 blocks
// spread over the 132 SMs).  A warp's 32 threads touch 32 neighbouring
// channels, so every load and store is coalesced.  The loads of a and b do
// not depend on h: each thread issues kUnroll steps' loads before the
// dependent multiply-adds, so that many loads are in flight per thread.  No
// padding: channels >= W and steps >= S are masked.
#include "common.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 16;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  T* __restrict__ h, int S, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const size_t base = (size_t)blockIdx.y * S * W + w;
  float state = 0.f;
  for (int t0 = 0; t0 < S; t0 += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t off = base + (size_t)(t0 + u) * W;
      av[u] = t0 + u < S ? to_f32(a[off]) : 0.f;
      bv[u] = t0 + u < S ? to_f32(b[off]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < S) {
        state = fmaf(av[u], state, bv[u]);
        h[base + (size_t)(t0 + u) * W] = from_f32<T>(state);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, void* h, int B, int S,
                   int W, cudaStream_t stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(h),
      S, W);
  return cudaGetLastError();
}

}  // namespace

// a, b, h (B, S, W) in `dtype`.  Returns the CUDA error of the launch.
extern "C" int rglru_scan_fwd(const void* a, const void* b, void* h,
                              int dtype, int B, int S, int W, void* stream) {
  if (B == 0 || S == 0 || W == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch<float>(a, b, h, B, S, W, s);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(a, b, h, B, S, W, s);
  return cudaErrorInvalidValue;
}

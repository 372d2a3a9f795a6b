// Mamba-1 selective scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba_scan/kernel.py:
// mamba_scan_kernel (body _scan_kernel), on already discretised inputs:
//   h[t, d, n] = da[t, d, n] * h[t-1, d, n] + dbx[t, d, n]     (h[-1] = 0)
//   y[t, d]    = sum_n h[t, d, n] * c[t, n]
// with the state and the sum in fp32 (n in order 0..N-1) and y in the input
// type.  Unlike the TPU kernel, which keeps the state in VMEM scratch and
// drops it, this one also writes the final state h_last (B, Di, N) fp32: the
// model's prefill seeds the decode cache with it.
//
// Layout: da, dbx (B, S, Di, N), c (B, S, N), y (B, S, Di), one type (fp32
// or bf16), contiguous, da and dbx 16-byte aligned; N in {4, 8, 16}.
//
// Bound: bytes (da and dbx are read once, 2 * N elements a step for 4 * N
// flops).  Design, simple first: one thread per (batch, channel) holds its N
// states in registers and loops over time (the TPU grid's sequential time
// axis); the channel blocks become the grid.  A step's N coefficients of a
// channel are contiguous and read with 16-byte (8-byte for bf16 N = 4)
// loads, a warp's 32 channels side by side; the next step's loads are issued
// before the current step's multiply-adds, so they overlap.  c[b, t, :] is
// the same for every channel: a block stages kChunk steps of it in shared
// memory and every thread reads it from there.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 64;

template <typename T, int N>
__device__ __forceinline__ void load_row(const T* __restrict__ p,
                                         float (&out)[N]) {
  constexpr int kBytes = N * (int)sizeof(T);
  if constexpr (kBytes % 16 == 0) {
    uint4 raw[kBytes / 16];
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i)
      raw[i] = reinterpret_cast<const uint4*>(p)[i];
    const T* e = reinterpret_cast<const T*>(raw);
#pragma unroll
    for (int n = 0; n < N; ++n) out[n] = to_f32(e[n]);
  } else {
    static_assert(kBytes == 8, "rows of 8 bytes or a multiple of 16");
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int n = 0; n < N; ++n) out[n] = to_f32(e[n]);
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const T* __restrict__ da, const T* __restrict__ dbx,
                  const T* __restrict__ c, T* __restrict__ y,
                  float* __restrict__ h_last, int S, int Di) {
  __shared__ float cs[kChunk][N];
  const int d = blockIdx.x * kThreads + threadIdx.x, bb = blockIdx.y;
  const bool active = d < Di;   // inactive threads still stage c
  const size_t step = (size_t)Di * N;                  // elements a step
  const T* pa = da + (size_t)bb * S * step + (size_t)d * N;
  const T* pb = dbx + (size_t)bb * S * step + (size_t)d * N;
  const T* pc = c + (size_t)bb * S * N;
  T* py = y + (size_t)bb * S * Di + d;

  float h[N], an[N], bn[N];
#pragma unroll
  for (int n = 0; n < N; ++n) h[n] = an[n] = bn[n] = 0.f;
  if (active) {
    load_row<T, N>(pa, an);
    load_row<T, N>(pb, bn);
  }
  for (int t = 0; t < S; ++t) {
    const int tt = t % kChunk;
    if (tt == 0) {               // uniform over the block
      __syncthreads();
      const int nt = min(kChunk, S - t);
      for (int i = threadIdx.x; i < nt * N; i += kThreads)
        cs[i / N][i % N] = to_f32(pc[(size_t)t * N + i]);
      __syncthreads();
    }
    float av[N], bv[N];
#pragma unroll
    for (int n = 0; n < N; ++n) {
      av[n] = an[n];
      bv[n] = bn[n];
    }
    if (active && t + 1 < S) {   // the next step's loads, in flight now
      load_row<T, N>(pa + (size_t)(t + 1) * step, an);
      load_row<T, N>(pb + (size_t)(t + 1) * step, bn);
    }
    if (active) {
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = fmaf(av[n], h[n], bv[n]);
        acc = fmaf(h[n], cs[tt][n], acc);
      }
      py[(size_t)t * Di] = from_f32<T>(acc);
    }
  }
  if (active) {
    float* hl = h_last + ((size_t)bb * Di + d) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) hl[n] = h[n];
  }
}

template <typename T, int N>
cudaError_t launch(const void* da, const void* dbx, const void* c, void* y,
                   float* h_last, int B, int S, int Di, cudaStream_t stream) {
  const dim3 grid((Di + kThreads - 1) / kThreads, B);
  mamba_scan_kernel<T, N><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(da), static_cast<const T*>(dbx),
      static_cast<const T*>(c), static_cast<T*>(y), h_last, S, Di);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_n(const void* da, const void* dbx, const void* c,
                       void* y, float* h_last, int B, int S, int Di, int N,
                       cudaStream_t s) {
  switch (N) {
    case 4: return launch<T, 4>(da, dbx, c, y, h_last, B, S, Di, s);
    case 8: return launch<T, 8>(da, dbx, c, y, h_last, B, S, Di, s);
    case 16: return launch<T, 16>(da, dbx, c, y, h_last, B, S, Di, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// da, dbx (B, S, Di, N), c (B, S, N), y (B, S, Di) in `dtype`; h_last
// (B, Di, N) fp32.  Returns the CUDA error of the launch (0 on success).
extern "C" int mamba_scan_fwd(const void* da, const void* dbx, const void* c,
                              void* y, void* h_last, int dtype, int B, int S,
                              int Di, int N, void* stream) {
  if (B == 0 || Di == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* hl = static_cast<float*>(h_last);
  if (dtype == kFloat32)
    return dispatch_n<float>(da, dbx, c, y, hl, B, S, Di, N, s);
  if (dtype == kBFloat16)
    return dispatch_n<__nv_bfloat16>(da, dbx, c, y, hl, B, S, Di, N, s);
  return cudaErrorInvalidValue;
}

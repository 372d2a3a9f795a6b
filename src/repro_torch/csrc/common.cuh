// Shared helpers of the port's CUDA kernels: element types and conversions,
// event marks, shared-memory opt-in, block tickets.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes passed from Python (repro_torch/kernels/_build.py callers)
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);   // round to nearest even, as XLA/PyTorch do
}

// Records event i of ``marks`` (an array of cudaEvent_t, or null) on the
// stream: the boundaries of a C entry's launches, for a caller that times
// them apart (a failed record surfaces at the next cudaGetLastError).
inline void mark(void* marks, int i, cudaStream_t s) {
  if (marks != nullptr)
    cudaEventRecord(static_cast<cudaEvent_t*>(marks)[i], s);
}

// The block's ticket: its place in the order blocks started in (a chain
// of blocks waits only for earlier tickets, which run or have finished)
__device__ __forceinline__ int take_ticket(int* counter) {
  __shared__ int ticket;
  if (threadIdx.x == 0) ticket = atomicAdd(counter, 1);
  __syncthreads();
  return ticket;
}

// Lets kernel ``Kern`` take ``bytes`` of dynamic shared memory, set once per
// device (the attribute outlives the launch).
template <auto Kern>
inline cudaError_t allow_smem(size_t bytes) {
  static unsigned ready = 0;   // bit d: set on device d
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (ready >> dev & 1u)) return e;
  e = cudaFuncSetAttribute(Kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess) ready |= 1u << dev;
  return e;
}

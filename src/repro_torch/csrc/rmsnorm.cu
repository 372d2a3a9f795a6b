// Fused RMSNorm, plain and residual forms, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm/kernel.py:
// rmsnorm_kernel (bodies _rmsnorm_kernel and _rmsnorm_residual_kernel).
//   plain:    y = x * rsqrt(mean(x^2) + eps) * w            (fp32, cast to T)
//   residual: s = x + r (fp32); res = T(s); y = norm of the UNROUNDED s
//
// Bound: bytes.  A row is read once and written once (~4 flops/element
// against ~4 bytes moved in bf16), far below the card's ridge point.  Two
// variants; the wrapper's plan (kernels/rmsnorm/ops.py) picks one per call:
//
// vector (rmsnorm_vector_kernel): a group of G threads (32-256, a power of
//   two) per row, 256 / G rows a block, a grid-stride loop over rows with the
//   grid sized to the blocks the card holds at once.  A thread moves its
//   part of a row as V 16-byte vectors (8 bf16 or 4 fp32 values; V a
//   template argument, so all V loads are issued before the sum starts, with
//   streaming cache hints; the next row's loads are issued before this
//   row's sum), keeps the row in registers as it was loaded (unpacked to
//   fp32 once for the sum and once for the output) and its V vectors of w
//   in registers for every row it walks.  The sum of squares
//   is a warp shuffle, and where a row spans several warps one exchange
//   through shared memory (double-buffered: one block barrier a row).  Needs
//   16-byte vectors to divide d and 16-byte aligned pointers.
// generic (rmsnorm_kernel): one block of 256 threads per row, scalar
//   accesses, the row staged as fp32 in shared memory; any d.  The first
//   design of the port, kept for what the vector variant does not take (d
//   not a multiple of a vector, pointers not aligned).
//
// Launch overhead bounds the decode shape (8 rows) in both.
//
// Backward of the plain form (rmsnorm_bwd; no TPU counterpart: the
// reference differentiates its plain rmsnorm, src/repro/models/common.py:
// 177-181, through XLA): from x, w and dy, with rstd = rsqrt(mean(x^2) +
// eps) recomputed per row, xhat = x * rstd and g = dy * w in fp32,
//   dx = rstd * (g - xhat * mean(g * xhat))     (cast to x's type)
//   dw = sum over rows of dy * xhat              (cast to w's type)
// Bound: bytes (x and dy read, dx written once: ~176 MB at qwen2-7b's 8192
// x 3584 bf16 rows).  rmsnorm_bwd_kernel: a block of 256 threads a row, the
// blocks walking rows blockIdx.x, + gridDim.x, ...; thread t holds columns
// t, t + 256, ... of the row (C of them, a template argument) in registers,
// both row sums (x^2 and g * x) in one block reduction, and its columns'
// dw sums in registers across the block's rows, written at the end as the
// block's partial row; rmsnorm_dw_kernel then sums the partials of each
// column in block order.  dw's terms are fp32 and its sums fp64: in fp32
// a sum of 8192 rows rounds at ~1e-6 of its running magnitude, which a
// component that cancels shows as an error far beyond fp32's 2e-5 (8192
// x 3584 rows, ~30 M fp64 additions: no cost that shows).  No atomics: two
// runs give the same bits.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float block_sum(float v, float* warp_sums) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? warp_sums[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sums[0] = v;
  }
  __syncthreads();
  return warp_sums[0];
}

template <typename T, bool kResidual>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ r,
               const T* __restrict__ w, T* __restrict__ y,
               T* __restrict__ res, int d, float eps) {
  extern __shared__ float row[];           // d floats
  __shared__ float warp_sums[kThreads / 32];
  const size_t base = (size_t)blockIdx.x * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    float v = to_f32(x[base + i]);
    if (kResidual) {
      v += to_f32(r[base + i]);
      res[base + i] = from_f32<T>(v);
    }
    row[i] = v;
    ss += v * v;
  }
  const float inv = 1.f / sqrtf(block_sum(ss, warp_sums) / d + eps);
  for (int i = threadIdx.x; i < d; i += kThreads)
    y[base + i] = from_f32<T>(row[i] * inv * to_f32(w[i]));
}

template <typename T>
cudaError_t launch(const void* x, const void* r, const void* w, void* y,
                   void* res, long long n, int d, float eps,
                   cudaStream_t stream) {
  const size_t smem = (size_t)d * sizeof(float);
  auto kern = r ? rmsnorm_kernel<T, true> : rmsnorm_kernel<T, false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<(unsigned)n, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const T*>(w), static_cast<T*>(y), static_cast<T*>(res), d,
      eps);
  return cudaGetLastError();
}


// ---- vector variant --------------------------------------------------------

constexpr int kVecBlock = 256;
constexpr int kMaxVectors = 6;   // V: ops.py VMAX

__device__ __forceinline__ void unpack(uint4 u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(uint4 u, float* f, __nv_bfloat16) {
  const unsigned v[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {               // element 2i in the low half
    f[2 * i] = __uint_as_float(v[i] << 16);
    f[2 * i + 1] = __uint_as_float(v[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack(const float* f, float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  // round to nearest even, as from_f32 and the generic variant do
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}
__device__ __forceinline__ uint4 pack(const float* f, __nv_bfloat16) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                    pack2(f[6], f[7]));
}

// Loads row `row`'s part of thread t (vectors t, t + G, ...) of x (and r);
// zeros past the row or past n.
template <bool kResidual, int V>
__device__ __forceinline__ void load_row(const uint4* __restrict__ x,
                                         const uint4* __restrict__ r,
                                         long long row, long long n, int nvec,
                                         int t, int G, uint4 (&xv)[V],
                                         uint4 (&rv)[V]) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
  const size_t off = (size_t)(row < n ? row : 0) * nvec;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int j = t + k * G;
    const bool ok = row < n && j < nvec;
    xv[k] = ok ? __ldcs(x + off + j) : zero;
    if (kResidual) rv[k] = ok ? __ldcs(r + off + j) : zero;
  }
}

template <typename T, bool kResidual, int V>
__global__ void __launch_bounds__(kVecBlock)
rmsnorm_vector_kernel(const uint4* __restrict__ x, const uint4* __restrict__ r,
                      const uint4* __restrict__ w, uint4* __restrict__ y,
                      uint4* __restrict__ res, long long n, int d, int G,
                      float eps) {
  constexpr int E = 16 / sizeof(T);           // values a vector
  __shared__ float part[2][kVecBlock / 32];   // per warp, double-buffered
  const int nvec = d / E, rows = kVecBlock / G, wpg = G / 32;
  const int grp = threadIdx.x / G, t = threadIdx.x % G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long stride = (long long)gridDim.x * rows;
  uint4 wv[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int j = t + k * G;
    wv[k] = j < nvec ? __ldg(w + j) : make_uint4(0, 0, 0, 0);
  }
  // the row stays packed in registers as loaded (unpacked to fp32 once for
  // the sum and once for the output); the next row's loads are issued
  // before this row's sum, so they are in flight across its barrier
  uint4 xn[V], rn[V];
  load_row<kResidual>(x, r, (long long)blockIdx.x * rows + grp, n, nvec, t, G,
                      xn, rn);
  int buf = 0;
  // block-uniform loop: every thread of a block takes every turn, so the
  // block barrier below is reached by all of them
  for (long long base = (long long)blockIdx.x * rows; base < n;
       base += stride, buf ^= 1) {
    const long long row = base + grp;
    const bool live = row < n;
    const size_t off = (size_t)(live ? row : 0) * nvec;
    uint4 xv[V], rv[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      xv[k] = xn[k];
      if (kResidual) rv[k] = rn[k];
    }
    load_row<kResidual>(x, r, row + stride, n, nvec, t, G, xn, rn);
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float v[E];
      unpack(xv[k], v, T());
      if (kResidual) {
        float b[E];
        unpack(rv[k], b, T());
#pragma unroll
        for (int e = 0; e < E; ++e) v[e] += b[e];
        const int j = t + k * G;
        if (live && j < nvec) __stcs(res + off + j, pack(v, T()));
      }
#pragma unroll
      for (int e = 0; e < E; ++e) ss += v[e] * v[e];
    }
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (wpg > 1) {                            // uniform: G is the block's
      if (lane == 0) part[buf][warp] = ss;
      __syncthreads();
      ss = 0.f;
      for (int i = 0; i < wpg; ++i) ss += part[buf][grp * wpg + i];
    }
    const float inv = 1.f / sqrtf(ss / d + eps);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int j = t + k * G;
      if (!live || j >= nvec) continue;
      float v[E], wf[E], o[E];
      unpack(xv[k], v, T());
      if (kResidual) {                        // the same fp32 sum again
        float b[E];
        unpack(rv[k], b, T());
#pragma unroll
        for (int e = 0; e < E; ++e) v[e] += b[e];
      }
      unpack(wv[k], wf, T());
#pragma unroll
      for (int e = 0; e < E; ++e) o[e] = v[e] * inv * wf[e];
      __stcs(y + off + j, pack(o, T()));
    }
  }
}

// Blocks of one instance the card holds at once (occupancy x SMs), read once
// per device.
template <auto Kern>
int resident_blocks() {
  static int cache[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 0;
  if (!cache[dev]) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kern,
                                                      kVecBlock, 0) ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
      return 0;
    cache[dev] = per_sm * sms;
  }
  return cache[dev];
}

template <typename T, bool kResidual, int V>
cudaError_t launch_vector(const void* x, const void* r, const void* w,
                          void* y, void* res, long long n, int d, int G,
                          float eps, cudaStream_t stream) {
  const int resident =
      resident_blocks<rmsnorm_vector_kernel<T, kResidual, V>>();
  if (resident <= 0) return cudaErrorInvalidValue;
  // the row sets (256 / G rows) split evenly: each block takes the same
  // number of turns, so no last turn runs on a few blocks
  const long long sets = (n + kVecBlock / G - 1) / (kVecBlock / G);
  const long long turns = (sets + resident - 1) / resident;
  const unsigned grid = (unsigned)((sets + turns - 1) / turns);
  rmsnorm_vector_kernel<T, kResidual, V><<<grid, kVecBlock, 0, stream>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(r),
      static_cast<const uint4*>(w), static_cast<uint4*>(y),
      static_cast<uint4*>(res), n, d, G, eps);
  return cudaGetLastError();
}

template <typename T, bool kResidual>
cudaError_t dispatch_vector(const void* x, const void* r, const void* w,
                            void* y, void* res, long long n, int d, int G,
                            int V, float eps, cudaStream_t s) {
  switch (V) {
#define RMS_V(v) \
  case v: return launch_vector<T, kResidual, v>(x, r, w, y, res, n, d, G, eps, s);
    RMS_V(1) RMS_V(2) RMS_V(3) RMS_V(4) RMS_V(5) RMS_V(6)
#undef RMS_V
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t vector_form(const void* x, const void* r, const void* w, void* y,
                        void* res, long long n, int d, int G, int V,
                        float eps, cudaStream_t s) {
  return r ? dispatch_vector<T, true>(x, r, w, y, res, n, d, G, V, eps, s)
           : dispatch_vector<T, false>(x, r, w, y, res, n, d, G, V, eps, s);
}


// ---- backward ----------------------------------------------------------------

// the sums of a and b over the block (256 threads), both at once
__device__ __forceinline__ float2 block_sum2(float a, float b,
                                             float2* warp_sums) {
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();               // the previous row's sums are read
  if (lane == 0) warp_sums[warp] = make_float2(a, b);
  __syncthreads();
  float2 t = make_float2(0.f, 0.f);
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) {
    t.x += warp_sums[i].x;
    t.y += warp_sums[i].y;
  }
  return t;
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ dy, T* __restrict__ dx,
                   double* __restrict__ partial, long long n, int d,
                   float eps) {
  __shared__ float2 warp_sums[kThreads / 32];
  const int t = threadIdx.x;
  float wv[C];
  double dw[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = t + c * kThreads;
    wv[c] = j < d ? to_f32(w[j]) : 0.f;
    dw[c] = 0.0;
  }
  for (long long row = blockIdx.x; row < n; row += gridDim.x) {
    const size_t base = (size_t)row * d;
    float xv[C], gv[C], ss = 0.f, gx = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = t + c * kThreads;
      xv[c] = j < d ? to_f32(x[base + j]) : 0.f;
      gv[c] = j < d ? to_f32(dy[base + j]) : 0.f;
      ss += xv[c] * xv[c];
      gx += gv[c] * wv[c] * xv[c];
    }
    const float2 sums = block_sum2(ss, gx, warp_sums);
    const float rstd = 1.f / sqrtf(sums.x / d + eps);
    const float c_mean = sums.y * rstd / d;     // mean(g * xhat)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = t + c * kThreads;
      if (j >= d) continue;
      const float xhat = xv[c] * rstd;
      dx[base + j] = from_f32<T>(rstd * (gv[c] * wv[c] - xhat * c_mean));
      dw[c] += (double)(gv[c] * xhat);
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = t + c * kThreads;
    if (j < d) partial[(size_t)blockIdx.x * d + j] = dw[c];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_dw_kernel(const double* __restrict__ partial, T* __restrict__ dw,
                  int blocks, int d) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= d) return;
  double acc = 0.0;
  for (int b = 0; b < blocks; ++b) acc += partial[(size_t)b * d + j];
  dw[j] = from_f32<T>((float)acc);
}

template <typename T, int C>
cudaError_t launch_bwd(const void* x, const void* w, const void* dy, void* dx,
                       void* dw, double* partial, long long n, int d,
                       int blocks, float eps, cudaStream_t s) {
  rmsnorm_bwd_kernel<T, C><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(dy), static_cast<T*>(dx), partial, n, d, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  rmsnorm_dw_kernel<T><<<(d + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      partial, static_cast<T*>(dw), blocks, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_form(const void* x, const void* w, const void* dy, void* dx,
                     void* dw, double* partial, long long n, int d, int blocks,
                     float eps, cudaStream_t s) {
  const int cols = (d + kThreads - 1) / kThreads;   // columns a thread
#define RMS_C(cc)                                                          \
  if (cols <= cc)                                                          \
    return launch_bwd<T, cc>(x, w, dy, dx, dw, partial, n, d, blocks, eps, \
                             s);
  RMS_C(1) RMS_C(2) RMS_C(4) RMS_C(8) RMS_C(12) RMS_C(16) RMS_C(24) RMS_C(32)
#undef RMS_C
  return cudaErrorInvalidValue;
}

}  // namespace

// x, r, w, y, res in `dtype`: x, r, y, res (n, d) row-major, w (d,).
// r == res == nullptr selects the plain form.
// Returns the CUDA error of the launch (0 on success).
extern "C" int rmsnorm_fwd(const void* x, const void* r, const void* w,
                           void* y, void* res, long long n, int d, float eps,
                           int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  if (dtype == kFloat32)
    return launch<float>(x, r, w, y, res, n, d, eps, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(x, r, w, y, res, n, d, eps, s);
  return cudaErrorInvalidValue;
}

// The vector variant: G threads a row (32, 64, 128 or 256), V 16-byte
// vectors a thread (1-6), G * V vectors covering the row's d / (16 /
// sizeof(T)); every pointer 16-byte aligned (kernels/rmsnorm/ops.py:plan
// checks all of it).  Arguments and result as rmsnorm_fwd.
extern "C" int rmsnorm_vector_fwd(const void* x, const void* r,
                                  const void* w, void* y, void* res,
                                  long long n, int d, float eps, int dtype,
                                  int G, int V, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  if (G < 32 || G > kVecBlock || (G & (G - 1)) || V < 1 || V > kMaxVectors)
    return cudaErrorInvalidValue;
  if (dtype == kFloat32)
    return vector_form<float>(x, r, w, y, res, n, d, G, V, eps, s);
  if (dtype == kBFloat16)
    return vector_form<__nv_bfloat16>(x, r, w, y, res, n, d, G, V, eps, s);
  return cudaErrorInvalidValue;
}

// The backward of the plain form: x, dy, dx (n, d) and w, dw (d,) in
// `dtype`, d <= 8192; partial: fp64 scratch (blocks, d), blocks <= n the
// first kernel's grid.  Returns the first CUDA error of the two launches.
extern "C" int rmsnorm_bwd(const void* x, const void* w, const void* dy,
                           void* dx, void* dw, void* partial, long long n,
                           int d, float eps, int dtype, int blocks,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0 || d == 0) return 0;
  if (blocks < 1 || blocks > n) return cudaErrorInvalidValue;
  double* part = static_cast<double*>(partial);
  if (dtype == kFloat32)
    return bwd_form<float>(x, w, dy, dx, dw, part, n, d, blocks, eps, s);
  if (dtype == kBFloat16)
    return bwd_form<__nv_bfloat16>(x, w, dy, dx, dw, part, n, d, blocks, eps,
                                   s);
  return cudaErrorInvalidValue;
}

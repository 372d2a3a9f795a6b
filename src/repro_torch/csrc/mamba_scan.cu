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
//
// mamba_scan_bwd is its backward (training): no TPU counterpart, the
// reference differentiates mamba_mix (src/repro/models/mamba.py:72) through
// XLA; see "the backward" below.
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

// ---- the backward ----
//
// For dy (B, S, Di) and dh_last (B, Di, N) or null: dda, ddbx (B, S, Di, N)
// and dc (B, S, N), all fp32, by the reverse recurrence
//   g[t] = dy[t, d] c[t, n] + da[t+1] g[t+1]     (g[S-1] += dh_last)
//   dda[t] = g[t] h[t-1], ddbx[t] = g[t], dc[t, n] = sum_d dy[t, d] h[t]
// without saving or allocating the (B, S, Di, N) states: they are
// recomputed a chunk of kMbL steps at a time from carried chunk states.
// Every (d, n) is its own recurrence, so a thread takes one element e =
// d * N + n of a step's row for one chunk of one batch row (a warp takes 32
// neighbouring elements: coalesced loads and stores), in four launches:
// 1. mb_fold: the chunk folded forward into (A, H) = (prod da, the state
//    from zero) and backward into E, the e = da * g reaching the step
//    before the chunk from zero after it;
// 2. mb_carry: a thread per (batch, element) walks the chunks: the state
//    entering each chunk in place of H, the e leaving it (from dh_last)
//    in place of E;
// 3. mb_grads: the chunk again from its carried state (h[t-1] and da in
//    registers), dy (x) h summed over the block's channels for each step
//    (shuffles within a warp, then the warps in order through shared
//    memory) into a partial row of dc, then backwards g, dda, ddbx;
// 4. mb_dc: a thread per (batch, step, n) sums the blocks' partials in
//    block order (fp64).  No atomics: two runs give the same bits.
// Bound: bytes (da and dbx read once, dda and ddbx written once: 4 fp32
// (B, S, Di, N) tensors).  Passes 1 and 3 both read da and dbx, so the
// kernel moves about 1.5 times that, plus its scratch (carry: 3 fp32
// values an element a chunk, 3/kMbL of a tensor; partials: a (B, S, N) row
// per block of 256 / N channels).  Registers (nvcc -Xptxas -v, sm_90a):
// mb_fold 80, mb_grads 128 (4 bytes spilled at fp32 N 4), mb_carry 62,
// mb_dc 38.

constexpr int kMbThreads = 256;
constexpr int kMbL = 32;           // steps a chunk
constexpr int kMbAhead = 8;        // loads issued ahead in the serial passes

struct MbArgs {
  const void* da;        // (B, S, Di, N), the inputs' type
  const void* dbx;
  const void* c;         // (B, S, N)
  const void* dy;        // (B, S, Di)
  const float* dh_last;  // (B, Di, N) or null
  float* dda;            // (B, S, Di, N)
  float* ddbx;
  float* dc;             // (B, S, N)
  float* carry;          // (3, B, K, Di * N) scratch: A, H, E
  float* part;           // (blocks, B, S, N) scratch: dc by block
  int B, S, Di, K;
};

template <typename T, int N>
__global__ void __launch_bounds__(kMbThreads)
mb_fold(const MbArgs p) {
  const int DN = p.Di * N;
  const int e = blockIdx.x * kMbThreads + threadIdx.x;
  if (e >= DN) return;
  const int k = blockIdx.y, bb = blockIdx.z, t0 = k * kMbL;
  const int n = e % N, d = e / N, steps = min(kMbL, p.S - t0);
  const size_t row = (size_t)bb * p.S + t0;
  const T* da = static_cast<const T*>(p.da) + row * DN + e;
  const T* dbx = static_cast<const T*>(p.dbx) + row * DN + e;
  const T* c = static_cast<const T*>(p.c) + row * N + n;
  const T* dy = static_cast<const T*>(p.dy) + row * p.Di + d;
  float av[kMbL], qv[kMbL];
  float A = 1.f, H = 0.f;
#pragma unroll
  for (int u = 0; u < kMbL; ++u) {
    if (u < steps) {
      av[u] = to_f32(da[(size_t)u * DN]);
      H = fmaf(av[u], H, to_f32(dbx[(size_t)u * DN]));
      A *= av[u];
      qv[u] = to_f32(dy[(size_t)u * p.Di]) * to_f32(c[u * N]);
    }
  }
  float E = 0.f;
#pragma unroll
  for (int u = kMbL - 1; u >= 0; --u)
    if (u < steps) E = av[u] * (qv[u] + E);
  const size_t plane = (size_t)p.B * p.K * DN;
  const size_t slot = ((size_t)bb * p.K + k) * DN + e;
  p.carry[slot] = A;
  p.carry[plane + slot] = H;
  p.carry[2 * plane + slot] = E;
}

__global__ void __launch_bounds__(kMbThreads)
mb_carry(const MbArgs p, int DN) {
  const int e = blockIdx.x * kMbThreads + threadIdx.x;
  if (e >= DN) return;
  const int bb = blockIdx.y;
  const size_t plane = (size_t)p.B * p.K * DN;
  float* A = p.carry + (size_t)bb * p.K * DN + e;
  float* H = A + plane;
  float* E = A + 2 * plane;
  // kMbAhead chunks' values loaded ahead of each run of dependent
  // multiply-adds
  float h = 0.f;
  for (int k0 = 0; k0 < p.K; k0 += kMbAhead) {
    float av[kMbAhead], hv[kMbAhead];
#pragma unroll
    for (int u = 0; u < kMbAhead; ++u)
      if (k0 + u < p.K) {
        av[u] = A[(size_t)(k0 + u) * DN];
        hv[u] = H[(size_t)(k0 + u) * DN];
      }
#pragma unroll
    for (int u = 0; u < kMbAhead; ++u)
      if (k0 + u < p.K) {
        H[(size_t)(k0 + u) * DN] = h;      // the state entering the chunk
        h = fmaf(av[u], h, hv[u]);
      }
  }
  float g = p.dh_last != nullptr ? p.dh_last[(size_t)bb * DN + e] : 0.f;
  for (int k1 = p.K - 1; k1 >= 0; k1 -= kMbAhead) {
    float av[kMbAhead], ev[kMbAhead];
#pragma unroll
    for (int u = 0; u < kMbAhead; ++u)
      if (k1 - u >= 0) {
        av[u] = A[(size_t)(k1 - u) * DN];
        ev[u] = E[(size_t)(k1 - u) * DN];
      }
#pragma unroll
    for (int u = 0; u < kMbAhead; ++u)
      if (k1 - u >= 0) {
        E[(size_t)(k1 - u) * DN] = g;      // the e entering the chunk's end
        g = fmaf(av[u], g, ev[u]);
      }
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kMbThreads)
mb_grads(const MbArgs p) {
  constexpr int kWarps = kMbThreads / 32;
  __shared__ float sums[kWarps][kMbL][N];
  const int DN = p.Di * N;
  const int e = blockIdx.x * kMbThreads + threadIdx.x;
  const bool live = e < DN;            // dead threads still shuffle
  const int k = blockIdx.y, bb = blockIdx.z, t0 = k * kMbL;
  const int n = e % N, d = min(e / N, p.Di - 1), steps = min(kMbL, p.S - t0);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const size_t row = (size_t)bb * p.S + t0;
  const size_t off = row * DN + (live ? e : 0);
  const T* da = static_cast<const T*>(p.da) + off;
  const T* dbx = static_cast<const T*>(p.dbx) + off;
  const T* c = static_cast<const T*>(p.c) + row * N + n;
  const T* dy = static_cast<const T*>(p.dy) + row * p.Di + d;
  const size_t plane = (size_t)p.B * p.K * DN;
  const size_t slot = ((size_t)bb * p.K + k) * DN + e;
  float h = live ? p.carry[plane + slot] : 0.f;
  float g = live ? p.carry[2 * plane + slot] : 0.f;
  float av[kMbL], hp[kMbL];
#pragma unroll
  for (int u = 0; u < kMbL; ++u) {
    if (u < steps) {                   // uniform over the block
      av[u] = live ? to_f32(da[(size_t)u * DN]) : 0.f;
      hp[u] = h;
      h = fmaf(av[u], h, live ? to_f32(dbx[(size_t)u * DN]) : 0.f);
      float v = live ? to_f32(dy[(size_t)u * p.Di]) * h : 0.f;
#pragma unroll
      for (int o = 16; o >= N; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
      if (lane < N) sums[warp][u][lane] = v;
    }
  }
  __syncthreads();
  // dc's partial of this block: (step, n) pairs, the warps in order
  const int blk = blockIdx.x;
  for (int j = threadIdx.x; j < steps * N; j += kMbThreads) {
    const int u = j / N, m = j % N;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc += sums[w][u][m];
    p.part[(((size_t)blk * p.B + bb) * p.S + t0 + u) * N + m] = acc;
  }
  if (!live) return;
  float* dda = p.dda + off;
  float* ddbx = p.ddbx + off;
#pragma unroll
  for (int u = kMbL - 1; u >= 0; --u) {
    if (u < steps) {
      const float q = to_f32(dy[(size_t)u * p.Di]) * to_f32(c[u * N]);
      const float gt = q + g;
      ddbx[(size_t)u * DN] = gt;
      dda[(size_t)u * DN] = gt * hp[u];
      g = av[u] * gt;
    }
  }
}

__global__ void __launch_bounds__(kMbThreads)
mb_dc(const MbArgs p, int N, int blocks) {
  const size_t j = (size_t)blockIdx.x * kMbThreads + threadIdx.x;
  const size_t total = (size_t)p.B * p.S * N;
  if (j >= total) return;
  double acc = 0.0;
  for (int b0 = 0; b0 < blocks; b0 += kMbAhead) {   // loads ahead
    float v[kMbAhead];
#pragma unroll
    for (int u = 0; u < kMbAhead; ++u)
      if (b0 + u < blocks) v[u] = p.part[(size_t)(b0 + u) * total + j];
#pragma unroll
    for (int u = 0; u < kMbAhead; ++u)
      if (b0 + u < blocks) acc += v[u];              // in block order
  }
  p.dc[j] = (float)acc;
}

template <typename T, int N>
cudaError_t launch_bwd(const MbArgs& p, cudaStream_t s) {
  const int DN = p.Di * N, blocks = (DN + kMbThreads - 1) / kMbThreads;
  const dim3 chunks(blocks, p.K, p.B);
  mb_fold<T, N><<<chunks, kMbThreads, 0, s>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  mb_carry<<<dim3(blocks, p.B), kMbThreads, 0, s>>>(p, DN);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  mb_grads<T, N><<<chunks, kMbThreads, 0, s>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const size_t total = (size_t)p.B * p.S * N;
  mb_dc<<<(unsigned)((total + kMbThreads - 1) / kMbThreads), kMbThreads, 0,
          s>>>(p, N, blocks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bwd(const MbArgs& p, int N, cudaStream_t s) {
  switch (N) {
    case 4: return launch_bwd<T, 4>(p, s);
    case 8: return launch_bwd<T, 8>(p, s);
    case 16: return launch_bwd<T, 16>(p, s);
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

// The backward: da, dbx (B, S, Di, N), c (B, S, N), dy (B, S, Di) in
// `dtype`; dh_last (B, Di, N) fp32 or null; dda, ddbx (B, S, Di, N) and dc
// (B, S, N) fp32; carry: fp32 scratch (3, B, K, Di * N) and part: fp32
// scratch (ceil(Di * N / threads), B, S, N), K = ceil(S / steps); `steps`
// and `threads` must be the kernel's chunk (32) and block (256), which
// size the scratch.  Returns the first CUDA error of the four launches.
extern "C" int mamba_scan_bwd(const void* da, const void* dbx, const void* c,
                              const void* dy, const float* dh_last,
                              float* dda, float* ddbx, float* dc,
                              float* carry, float* part, int dtype, int B,
                              int S, int Di, int N, int steps, int threads,
                              void* stream) {
  if (B == 0 || S == 0 || Di == 0) return 0;
  if (steps != kMbL || threads != kMbThreads) return cudaErrorInvalidValue;
  const MbArgs p{da, dbx, c, dy, dh_last, dda, ddbx, dc, carry, part,
                 B, S, Di, (S + kMbL - 1) / kMbL};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return dispatch_bwd<float>(p, N, s);
  if (dtype == kBFloat16) return dispatch_bwd<__nv_bfloat16>(p, N, s);
  return cudaErrorInvalidValue;
}

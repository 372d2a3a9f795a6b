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
// recomputed a chunk of kMbL steps at a time.
// Bound: bytes: da and dbx read once, dda and ddbx written once, 4 fp32
// (B, S, Di, N) tensors (17.4 GB at falcon-mamba-7b's 8 x 1024 by 8192 x
// 16).  Every (d, n) is its own recurrence, so the design is about moving
// those bytes (a first design, four launches with a pass of its own for
// the chunks' carries, read da and dbx twice with 4-byte loads a thread a
// step, at ~1.4 TB/s):
// - a block takes kMbBlock = 512 neighbouring elements e = d * N + n of a
//   step's row over a chunk of kMbL steps of one batch row, a thread 4 of
//   them: one 16-byte load a step of fp32 da (8 bytes of bf16), one
//   16-byte store of each output; a block's step row is 2 KB contiguous;
// - the chunks are chained, not carried by a pass of their own: a block
//   takes a ticket (one atomicAdd) at its start, and the ticket names its
//   chunk and element block, every element block of a chunk before any of
//   the next, so a block waits only for a block that started before it
//   (which therefore runs or has finished: no deadlock) and, at the
//   training shape, 2048 tickets before it, long done.  The waiting block
//   issues its chunk's loads first; thread 0 spins on the predecessor's
//   flag (acquire), the predecessor stores its values, fences and sets the
//   flag (release).  Each recurrence is then one fmaf chain over the whole
//   sequence in step order: the bits depend neither on timing nor on the
//   chunking;
// - mb_fold walks the chunks from the last: it reads da and dy (c staged in
//   shared memory), takes the g entering its chunk's end (dh_last for the
//   last chunk), stores it for mb_grads and runs e = da (dy c + e) back
//   through the chunk to the e leaving its start, the next block's: dbx is
//   not read;
// - mb_grads walks them from the first: it reads da and dy into
//   registers and dbx into shared memory (cp.async, a thread's own 16-byte
//   slots), takes the state entering its chunk, runs h = da h + dbx
//   leaving h[t-1] in dbx[t]'s slot, publishes the chunk's last state, then
//   sums dy (x) h over the block's channels for each step (shuffles within
//   a warp, the warps in order through shared memory) into a partial row
//   of dc, and runs backwards from the stored g: dda, ddbx.  Holding dbx
//   and the states in registers instead took 203 registers (two blocks an
//   SM) and moved the bytes more slowly; here 126, capped for four blocks
//   an SM;
// - mb_dc: a thread per (batch, step, n) sums the element blocks' partials
//   in block order (fp64).  No atomics touch a result: two runs give the
//   same bits.
// Bytes: da twice, dbx once, dda and ddbx once (~1.25x the bound), plus
// the scratch (two fp32 planes of a value an element a chunk, 2 / kMbL of
// a tensor, and dc's partials, a (B, S, N) row per element block).
// Measured at falcon-mamba-7b's training shape (chip_smoke.py, H100 80GB
// HBM3 at 700 W): 8.07 ms against the bound's 5.21, fold 1.71 and grads
// 6.31 at 2.8-2.9 TB/s, dc 0.06.
// Registers (nvcc -Xptxas -v, sm_90a; fp32 / bf16): mb_fold 106-115 /
// 108, mb_grads 126 / 125-127 (37.9 KB of shared memory at N 16), mb_dc
// 38; no spills.

constexpr int kMbThreads = 128;
constexpr int kMbVec = 4;                        // elements a thread
constexpr int kMbBlock = kMbThreads * kMbVec;    // elements a block
constexpr int kMbL = 16;                         // steps a chunk
constexpr int kMbAhead = 8;                      // mb_dc's loads ahead
constexpr int kMbGradsBlocks = 4;                // mb_grads' blocks an SM

struct MbArgs {
  const void* da;        // (B, S, Di, N), the inputs' type
  const void* dbx;
  const void* c;         // (B, S, N)
  const void* dy;        // (B, S, Di)
  const float* dh_last;  // (B, Di, N) or null
  float* dda;            // (B, S, Di, N)
  float* ddbx;
  float* dc;             // (B, S, N)
  float* carry;          // (2, B, K, Di * N) scratch: the g entering each
                         // chunk's end (mb_fold), the state leaving each
                         // chunk (mb_grads)
  float* part;           // (EB, B, S, N) scratch: dc by element block
  int* sync;             // scratch, zero: two tickets, then (2, K, B * EB)
                         // flags (mb_fold's, mb_grads')
  int B, S, Di, K, EB;   // EB: element blocks of a step's row
};

// four neighbouring elements as fp32: one 16-byte (fp32) or 8-byte (bf16)
// load that does not stay in the cache
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldcs(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = __ldcs(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float& at(float4& v, int j) {
  return reinterpret_cast<float*>(&v)[j];
}
__device__ __forceinline__ float at(const float4& v, int j) {
  return reinterpret_cast<const float*>(&v)[j];
}

// Wait until *flag is set (thread 0 spins; then a block barrier).  A wait
// still open after two seconds is a fault: trap, so that the launch fails
// instead of hanging the card.
__device__ __forceinline__ void chain_wait(const int* flag) {
  if (threadIdx.x == 0) {
    uint64_t t0, t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
    for (;;) {
      int v;
      asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
                   : "=r"(v) : "l"(flag) : "memory");
      if (v) break;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      if (t - t0 > 2000000000ull) __trap();
    }
  }
  __syncthreads();
}

// Set *flag once every thread's stores before it are visible to the card
__device__ __forceinline__ void chain_publish(int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(flag), "r"(1)
                 : "memory");
}

// The block's place: chunk k (counted from the first), chain ch = (batch
// row, element block), first element e, steps in the chunk; c of the
// chunk staged in cs
template <typename T, int N>
struct MbBlock {
  int k, ch, bb, e, d, n0, t0, steps;
  bool live;
  size_t row;   // (batch row, first step) of the (B, S, ...) tensors

  __device__ MbBlock(const MbArgs& p, int ticket, bool reverse,
                     float (&cs)[kMbL][N]) {
    const int C = p.B * p.EB, r = ticket / C;
    k = reverse ? p.K - 1 - r : r;
    ch = ticket % C;
    bb = ch / p.EB;
    e = ((ch % p.EB) * kMbThreads + threadIdx.x) * kMbVec;
    live = e < p.Di * N;
    d = live ? e / N : 0;
    n0 = e % N;
    t0 = k * kMbL;
    steps = min(kMbL, p.S - t0);
    row = (size_t)bb * p.S + t0;
    const T* c = static_cast<const T*>(p.c) + row * N;
    for (int i = threadIdx.x; i < steps * N; i += kMbThreads)
      cs[i / N][i % N] = to_f32(c[i]);
  }
};

template <typename T, int N>
__global__ void __launch_bounds__(kMbThreads)
mb_fold(const MbArgs p) {
  __shared__ float cs[kMbL][N];
  const int ticket = take_ticket(p.sync);
  const MbBlock<T, N> m(p, ticket, true, cs);
  const int DN = p.Di * N, C = p.B * p.EB;
  const T* da = static_cast<const T*>(p.da) + m.row * DN + m.e;
  const T* dy = static_cast<const T*>(p.dy) + m.row * p.Di + m.d;
  float4 av[kMbL];
  float dyv[kMbL];
#pragma unroll
  for (int u = 0; u < kMbL; ++u) {
    av[u] = make_float4(0.f, 0.f, 0.f, 0.f);   // dead threads: no loads
    dyv[u] = 0.f;
    if (u < m.steps && m.live) {
      av[u] = load4(da + (size_t)u * DN);
      dyv[u] = to_f32(dy[(size_t)u * p.Di]);
    }
  }
  // the g entering the chunk's end
  float* E = p.carry + (size_t)m.bb * p.K * DN + m.e;
  int* flags = p.sync + 2;
  float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
  if (m.k == p.K - 1) {
    if (m.live && p.dh_last != nullptr)
      g = *reinterpret_cast<const float4*>(p.dh_last + (size_t)m.bb * DN +
                                           m.e);
    if (m.live) *reinterpret_cast<float4*>(E + (size_t)m.k * DN) = g;
    __syncthreads();   // cs
  } else {
    chain_wait(flags + (size_t)m.k * C + m.ch);
    if (m.live) g = __ldcg(reinterpret_cast<const float4*>(
                    E + (size_t)m.k * DN));
  }
#pragma unroll
  for (int u = kMbL - 1; u >= 0; --u)
    if (u < m.steps)
#pragma unroll
      for (int j = 0; j < kMbVec; ++j)
        at(g, j) = at(av[u], j) * (dyv[u] * cs[u][m.n0 + j] + at(g, j));
  if (m.k > 0) {   // the g entering the previous chunk's end
    if (m.live) *reinterpret_cast<float4*>(E + (size_t)(m.k - 1) * DN) = g;
    chain_publish(flags + (size_t)(m.k - 1) * C + m.ch);
  }
}

// dbx's four elements of a step into a 16-byte slot of shared memory, by
// cp.async (bf16: the slot's first 8 bytes), and back as fp32
__device__ __forceinline__ void copy4(float4* slot, const float* p) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(slot))),
               "l"(p)
               : "memory");
}
__device__ __forceinline__ void copy4(float4* slot, const __nv_bfloat16* p) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(slot))),
               "l"(p)
               : "memory");
}
template <typename T>
__device__ __forceinline__ float4 slot4(const float4& v) {
  if constexpr (sizeof(T) == 4) {
    return v;
  } else {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kMbThreads, kMbGradsBlocks)
mb_grads(const MbArgs p) {
  constexpr int kWarps = kMbThreads / 32, kTpc = N / kMbVec;  // threads a
                                                              // channel
  __shared__ float cs[kMbL][N];
  __shared__ float sums[kWarps][kMbL][N];
  // the thread's dbx[t] (as loaded), then h[t-1]: only the thread itself
  // reads its slots, so no barrier guards them
  __shared__ float4 hs[kMbL][kMbThreads];
  const int ticket = take_ticket(p.sync + 1);
  const MbBlock<T, N> m(p, ticket, false, cs);
  const int DN = p.Di * N, C = p.B * p.EB;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const size_t off = m.row * DN + m.e;
  const T* da = static_cast<const T*>(p.da) + off;
  const T* dbx = static_cast<const T*>(p.dbx) + off;
  const T* dy = static_cast<const T*>(p.dy) + m.row * p.Di + m.d;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int t = threadIdx.x;
  float4 av[kMbL];   // da[t]
  float dyv[kMbL];
#pragma unroll
  for (int u = 0; u < kMbL; ++u) {
    av[u] = zero;   // dead threads: zeros, no loads
    dyv[u] = 0.f;
    if (u < m.steps && m.live) {
      av[u] = load4(da + (size_t)u * DN);
      copy4(&hs[u][t], dbx + (size_t)u * DN);
      dyv[u] = to_f32(dy[(size_t)u * p.Di]);
    } else {
      hs[u][t] = zero;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  // the state entering the chunk
  float* H = p.carry + ((size_t)p.B + m.bb) * p.K * DN + m.e;
  int* flags = p.sync + 2 + (size_t)p.K * C;
  float4 h = zero;
  if (m.k == 0) {
    __syncthreads();   // cs
  } else {
    chain_wait(flags + (size_t)(m.k - 1) * C + m.ch);
    if (m.live) h = __ldcg(reinterpret_cast<const float4*>(
                    H + (size_t)(m.k - 1) * DN));
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#pragma unroll
  for (int u = 0; u < kMbL; ++u)
    if (u < m.steps) {
      const float4 b = slot4<T>(hs[u][t]);
      hs[u][t] = h;
#pragma unroll
      for (int j = 0; j < kMbVec; ++j)
        at(h, j) = fmaf(at(av[u], j), at(h, j), at(b, j));
    }
  if (m.k < p.K - 1) {   // the state leaving the chunk
    if (m.live) *reinterpret_cast<float4*>(H + (size_t)m.k * DN) = h;
    chain_publish(flags + (size_t)m.k * C + m.ch);
  }
  // dc's partial of this block: dy[t, d] h[t, d, n] over the block's
  // channels, for each (step, n); h[t] is in the next slot, or h after the
  // last step
#pragma unroll
  for (int u = 0; u < kMbL; ++u)
    if (u < m.steps) {
      const float4 ht = u + 1 < m.steps ? hs[(u + 1) % kMbL][t] : h;
      float v[kMbVec];
#pragma unroll
      for (int j = 0; j < kMbVec; ++j) {
        v[j] = dyv[u] * at(ht, j);
#pragma unroll
        for (int o = 16; o >= kTpc; o >>= 1)
          v[j] += __shfl_xor_sync(~0u, v[j], o);
      }
      if (lane < kTpc)
#pragma unroll
        for (int j = 0; j < kMbVec; ++j)
          sums[warp][u][lane * kMbVec + j] = v[j];
    }
  __syncthreads();
  const int eb = m.ch % p.EB;
  for (int j = threadIdx.x; j < m.steps * N; j += kMbThreads) {
    const int u = j / N, n = j % N;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc += sums[w][u][n];
    p.part[(((size_t)eb * p.B + m.bb) * p.S + m.t0 + u) * N + n] = acc;
  }
  if (!m.live) return;
  const float* E = p.carry + (size_t)m.bb * p.K * DN + m.e;
  float4 g = *reinterpret_cast<const float4*>(E + (size_t)m.k * DN);
  float4* dda = reinterpret_cast<float4*>(p.dda + off);
  float4* ddbx = reinterpret_cast<float4*>(p.ddbx + off);
#pragma unroll
  for (int u = kMbL - 1; u >= 0; --u)
    if (u < m.steps) {
      float4 gt, ga;
#pragma unroll
      for (int j = 0; j < kMbVec; ++j) {
        at(gt, j) = dyv[u] * cs[u][m.n0 + j] + at(g, j);
        at(ga, j) = at(gt, j) * at(hs[u][t], j);
        at(g, j) = at(av[u], j) * at(gt, j);
      }
      __stcs(ddbx + (size_t)u * DN / kMbVec, gt);
      __stcs(dda + (size_t)u * DN / kMbVec, ga);
    }
}

__global__ void __launch_bounds__(kMbThreads)
mb_dc(const MbArgs p, int N) {
  const size_t j = (size_t)blockIdx.x * kMbThreads + threadIdx.x;
  const size_t total = (size_t)p.B * p.S * N;
  if (j >= total) return;
  double acc = 0.0;
  for (int b0 = 0; b0 < p.EB; b0 += kMbAhead) {   // loads ahead
    float v[kMbAhead];
#pragma unroll
    for (int u = 0; u < kMbAhead; ++u)
      if (b0 + u < p.EB) v[u] = p.part[(size_t)(b0 + u) * total + j];
#pragma unroll
    for (int u = 0; u < kMbAhead; ++u)
      if (b0 + u < p.EB) acc += v[u];              // in block order
  }
  p.dc[j] = (float)acc;
}

template <typename T, int N>
cudaError_t launch_bwd(const MbArgs& p, cudaStream_t s, void* marks) {
  const unsigned blocks = (unsigned)p.K * p.B * p.EB;
  mb_fold<T, N><<<blocks, kMbThreads, 0, s>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  mark(marks, 1, s);
  mb_grads<T, N><<<blocks, kMbThreads, 0, s>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  mark(marks, 2, s);
  const size_t total = (size_t)p.B * p.S * N;
  mb_dc<<<(unsigned)((total + kMbThreads - 1) / kMbThreads), kMbThreads, 0,
          s>>>(p, N);
  mark(marks, 3, s);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bwd(const MbArgs& p, int N, cudaStream_t s,
                         void* marks) {
  switch (N) {
    case 4: return launch_bwd<T, 4>(p, s, marks);
    case 8: return launch_bwd<T, 8>(p, s, marks);
    case 16: return launch_bwd<T, 16>(p, s, marks);
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
// `dtype`, da and dbx 16-byte aligned; dh_last (B, Di, N) fp32, 16-byte
// aligned, or null; dda, ddbx (B, S, Di, N) and dc (B, S, N) fp32; carry:
// fp32 scratch (2, B, K, Di * N), K = ceil(S / steps); part: fp32 scratch
// (EB, B, S, N), EB = ceil(Di * N / block); sync: int32 scratch of 2 + 2 *
// K * B * EB (zeroed here, on the stream).  `steps` and `block` must be the
// kernel's chunk (16) and elements a block (512), which size the scratch.
// marks: null, or four cudaEvent_t recorded before the memset, after the
// fold, after the grads and after the dc launch.  Returns the first CUDA
// error of the memset and the three launches.
extern "C" int mamba_scan_bwd(const void* da, const void* dbx, const void* c,
                              const void* dy, const float* dh_last,
                              float* dda, float* ddbx, float* dc,
                              float* carry, float* part, int* sync,
                              int dtype, int B, int S, int Di, int N,
                              int steps, int block, void* stream,
                              void* marks) {
  if (B == 0 || S == 0 || Di == 0) return 0;
  if (steps != kMbL || block != kMbBlock) return cudaErrorInvalidValue;
  const int K = (S + kMbL - 1) / kMbL, EB = (Di * N + kMbBlock - 1) / kMbBlock;
  const MbArgs p{da, dbx, c, dy, dh_last, dda, ddbx, dc, carry, part, sync,
                 B, S, Di, K, EB};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mark(marks, 0, s);
  cudaError_t e = cudaMemsetAsync(
      sync, 0, (2 + 2 * (size_t)K * B * EB) * sizeof(int), s);
  if (e != cudaSuccess) return e;
  if (dtype == kFloat32) return dispatch_bwd<float>(p, N, s, marks);
  if (dtype == kBFloat16)
    return dispatch_bwd<__nv_bfloat16>(p, N, s, marks);
  return cudaErrorInvalidValue;
}

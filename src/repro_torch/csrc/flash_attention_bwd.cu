// Flash attention, backward, for Hopper (sm_90a): dQ, dK and dV from q, k,
// v, the forward's output o, its per-row log-sum-exp lse and dO, the
// FlashAttention-2 recomputation (Dao, 2023) on the fp32 cores.
//
// Backward: no TPU counterpart.  The reference never calls its Pallas
// kernel src/repro/kernels/flash_attention/kernel.py:78 on the training
// path: it differentiates its plain attention
// (src/repro/models/attention.py:149-176) through XLA.  This is the
// derivative of what the port's forward kernels (csrc/flash_attention.cu,
// csrc/flash_prefill_tc.cu) compute: with s = scale * q.k and
// P = exp(s - lse) over the visible keys,
//   delta_i = sum_d dO_id * O_id          (over the O the forward wrote,
//                                          plus its rounding residual
//                                          o_lo where the forward wrote one)
//   dV_j = sum_i P_ij dO_i
//   dS_ij = P_ij (dO_i . v_j - delta_i)
//   dQ_i = scale * sum_j dS_ij k_j,  dK_j = scale * sum_i dS_ij q_i
// with GQA's sum over the G query heads of a kv head.  Masks: causal,
// window and chunk, or none (Sq != Skv allowed: cross attention, an
// encoder); the queries start at position 0 and every key slot is written
// (no q_offset, kv_len or key positions: the wrapper raises for those).  D
// 16, 32, 64, 96, 128 or 256; fp32 or bf16 in, fp32 accumulators, outputs
// in the input type.  A masked (query, key) pair has P = 0.
//
// Three kernels, no atomics (two runs give the same bits):
// - delta: one warp a query row;
// - dK/dV: one block per (TL-key tile, kv head, batch), K and V of the
//   tile in shared memory as fp32; it loops over the G query heads of its
//   kv head and over the TL-row query tiles that can see the tile,
//   recomputing S and dP = dO V^T, then P and dS, and accumulates dK and dV
//   in registers, so GQA's sum over heads stays inside the block;
// - dQ: one block per (TL-row query tile, query head, batch), Q and dO in
//   shared memory; it loops over the key tiles the rows can see,
//   recomputing S, dP and dS, and accumulates dQ in registers.
// The causal, window and chunk bounds of a tile's keys or rows give the
// range of tiles a block visits (a window of 2048 over 4096 positions
// skips about a quarter of the causal tiles); only a tile that cuts a
// bound is masked pair by pair (whole_tile).
// 256 threads a block as 16 x 16: a thread holds R x R of a score tile
// (R = TL / 16; rows t/16 + 16i, keys t%16 + 16j) and R rows x D/16
// columns of its accumulators (columns t%16 + 16c); shared rows are padded
// to D + 1 floats, so the 16 columns of a half-warp fall in 16 banks.
// TL is 64, and 32 at D 256 (tile_of).  The accumulators sum a tile at a
// time, then add the tile's sum to the total: a key of recurrentgemma-2b's
// MQA 10:1 over a 2048 window gathers 20480 terms, and one fp32 chain of
// them drifted past fp32's TOL of the plain version (6.6e-5).
//
// Bound: operations (4 D flops a visible (query, key) pair in the forward;
// the backward does 7 such products, 2.5x the forward's FLOPs by the
// usual count; it reads q, k, v, o, dO once and writes dq, dk, dv).  This
// first design runs on the fp32 cores, not the tensor cores, so it sits far
// from the bf16 bound; the wrapper's plan sends bf16 at D 64, 96, 128 and
// 256, with or without a window, to the tensor-core design
// (csrc/flash_bwd_tc.cu) and keeps this kernel, the ``simt`` variant, for
// fp32 and for D 16 and 32 (the reduced configs), at every mask; it is
// also forced beside ``tc`` in chip_smoke.py's checks.  Both run the delta
// pass of flash_bwd_common.cuh.  Shared memory:
// dK/dV 4 x TL x (D + 1) + 2 x TL x (TL + 1) floats (166 KB at D 128, 137
// KB at D 256), dQ 4 x TL x (D + 1) + TL x (TL + 1) (149 KB, 133 KB): one
// block an SM.  Registers (nvcc -Xptxas -v, sm_90a; bf16 / fp32 alike
// within 4): dK/dV 73, 99, 128, 127, 192, 170 and dQ 64, 64, 77, 100, 128,
// 96 at D 16, 32, 64, 96, 128, 256; no spills.
#include "flash_bwd_common.cuh"   // Params, visible, the delta pass

namespace {

constexpr int kThreads = 256;   // 16 x 16

// The tile of a head_dim: TL query rows and TL keys, a thread holding
// R x R scores (R = TL / 16); 64, and 32 at D 256, where four 64-row fp32
// tiles of 257 floats would need 263 KB of shared memory.
template <int D>
__host__ __device__ constexpr int tile_of() {
  return D == 256 ? 32 : 64;
}

// rows [r0, r0 + TL) of head hh of x (B, S, H, D) into dst [TL][D + 1] as
// fp32, zeros past S; 16-byte loads
template <typename T, int D, int TL>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ x,
                                          int b, int r0, int S, int H,
                                          int hh) {
  constexpr int kVec = 16 / sizeof(T), kRowVecs = D / kVec;
  for (int vi = threadIdx.x; vi < TL * kRowVecs; vi += kThreads) {
    const int r = vi / kRowVecs, d0 = vi % kRowVecs * kVec;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (r0 + r < S)
      raw = *reinterpret_cast<const uint4*>(
          x + ((size_t)(b * S + r0 + r) * H + hh) * D + d0);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec; ++j) dst[r * (D + 1) + d0 + j] = to_f32(e[j]);
  }
}

// lse and delta of rows [q0, q0 + TL) of head h into ls, ds (0 past Sq)
template <int TL>
__device__ __forceinline__ void load_rows(float* ls, float* ds,
                                          const Params& p, int b, int h,
                                          int q0) {
  if (threadIdx.x < TL) {
    const int r = q0 + threadIdx.x;
    const size_t at = ((size_t)b * p.Hq + h) * p.Sq + r;
    ls[threadIdx.x] = r < p.Sq ? p.lse[at] : 0.f;
    ds[threadIdx.x] = r < p.Sq ? p.delta[at] : 0.f;
  }
}

// Every (query, key) pair of the tile at (q0, k0) is visible: no mask
// needed.  Only tiles that cut a bound (Sq, Skv, causal, window, chunk) are
// masked pair by pair.
template <int TL>
__device__ __forceinline__ bool whole_tile(const Params& p, int q0, int k0) {
  const int q1 = q0 + TL - 1, k1 = k0 + TL - 1;
  if (q1 >= p.Sq || k1 >= p.Skv) return false;
  if (p.causal && k1 > q0) return false;
  if (p.window && k0 <= q1 - p.window) return false;
  if (p.chunk) {
    const int c = q0 / p.chunk;
    if (q1 / p.chunk != c || k0 / p.chunk != c || k1 / p.chunk != c)
      return false;
  }
  return true;
}

// s = Q K^T and dp = dO V^T for the thread's R x R (rows tr + 16i of Qs /
// dOs, keys tc + 16j of Ks / Vs)
template <int D, int R>
__device__ __forceinline__ void scores(const float* Qs, const float* dOs,
                                       const float* Ks, const float* Vs,
                                       int tr, int tc, float (&s)[R][R],
                                       float (&dp)[R][R]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[R], ov[R], kv[R], vv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      qv[i] = Qs[(tr + 16 * i) * (D + 1) + d];
      ov[i] = dOs[(tr + 16 * i) * (D + 1) + d];
      kv[i] = Ks[(tc + 16 * i) * (D + 1) + d];
      vv[i] = Vs[(tc + 16 * i) * (D + 1) + d];
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
}

// P and dS of the thread's R x R into Ps / dSs [TL rows][TL + 1]; a whole
// tile skips the mask
template <int TL, int R>
__device__ __forceinline__ void probs(const Params& p, bool whole, int q0,
                                      int k0, int tr, int tc,
                                      const float* ls, const float* ds,
                                      const float (&s)[R][R],
                                      const float (&dp)[R][R], float* Ps,
                                      float* dSs) {
  constexpr int PS = TL + 1;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = tr + 16 * i;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int c = tc + 16 * j;
      const float pij = whole || visible(p, q0 + r, k0 + c)
                            ? expf(s[i][j] * p.scale - ls[r]) : 0.f;
      if (Ps) Ps[r * PS + c] = pij;
      dSs[r * PS + c] = pij * (dp[i][j] - ds[r]);
    }
  }
}

template <int D>
constexpr size_t dkdv_smem() {
  constexpr int TL = tile_of<D>();
  return (4 * TL * (D + 1) + 2 * TL * (TL + 1) + 2 * TL) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            T* __restrict__ dk, T* __restrict__ dv, Params p) {
  constexpr int TL = tile_of<D>(), R = TL / 16, PS = TL + 1;
  constexpr int DPT = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + TL * (D + 1);
  float* Qs = Vs + TL * (D + 1);
  float* dOs = Qs + TL * (D + 1);
  float* Ps = dOs + TL * (D + 1);
  float* dSs = Ps + TL * PS;
  float* ls = dSs + TL * PS;
  float* ds = ls + TL;

  // key tile 0 first: under the causal mask it sees the most queries
  const int k0 = blockIdx.x * TL, hk = blockIdx.y, b = blockIdx.z;
  const int G = p.Hq / p.Hkv;
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  load_tile<T, D, TL>(Ks, k, b, k0, p.Skv, p.Hkv, hk);
  load_tile<T, D, TL>(Vs, v, b, k0, p.Skv, p.Hkv, hk);

  // the queries that can see a key of the tile: [q_lo, q_hi)
  const int k_last = min(k0 + TL, p.Skv) - 1;
  int q_lo = 0, q_hi = p.Sq;
  if (p.causal) q_lo = k0;
  if (p.window) q_hi = min(q_hi, k_last + p.window);
  if (p.chunk) {
    q_lo = max(q_lo, k0 / p.chunk * p.chunk);
    q_hi = min(q_hi, (k_last / p.chunk + 1) * p.chunk);
  }

  float dK[R][DPT], dV[R][DPT];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < DPT; ++c) dK[i][c] = dV[i][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int q0 = q_lo / TL * TL; q0 < q_hi; q0 += TL) {
      __syncthreads();   // the previous tile's Q, dO, P, dS are consumed
      load_tile<T, D, TL>(Qs, q, b, q0, p.Sq, p.Hq, h);
      load_tile<T, D, TL>(dOs, dout, b, q0, p.Sq, p.Hq, h);
      load_rows<TL>(ls, ds, p, b, h, q0);
      __syncthreads();
      float s[R][R], dp[R][R];
      scores<D, R>(Qs, dOs, Ks, Vs, tr, tc, s, dp);
      probs<TL, R>(p, whole_tile<TL>(p, q0, k0), q0, k0, tr, tc, ls, ds, s,
                   dp, Ps, dSs);
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q: keys tr + 16i, columns tc + 16c; the
      // tile's sums first, then into the totals (a blocked sum: GQA's
      // G x Sq terms a key would otherwise pile up in one fp32 chain)
      float tK[R][DPT], tV[R][DPT];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < DPT; ++c) tK[i][c] = tV[i][c] = 0.f;
#pragma unroll 2
      for (int r = 0; r < TL; ++r) {
        float pv[R], sv[R], ov[DPT], qv[DPT];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          pv[i] = Ps[r * PS + tr + 16 * i];
          sv[i] = dSs[r * PS + tr + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < DPT; ++c) {
          ov[c] = dOs[r * (D + 1) + tc + 16 * c];
          qv[c] = Qs[r * (D + 1) + tc + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int c = 0; c < DPT; ++c) {
            tV[i][c] = fmaf(pv[i], ov[c], tV[i][c]);
            tK[i][c] = fmaf(sv[i], qv[c], tK[i][c]);
          }
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < DPT; ++c) {
          dV[i][c] += tV[i][c];
          dK[i][c] += tK[i][c];
        }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int key = k0 + tr + 16 * i;
    if (key >= p.Skv) continue;
    const size_t at = ((size_t)(b * p.Skv + key) * p.Hkv + hk) * D;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      dk[at + tc + 16 * c] = from_f32<T>(dK[i][c] * p.scale);
      dv[at + tc + 16 * c] = from_f32<T>(dV[i][c]);
    }
  }
}

template <int D>
constexpr size_t dq_smem() {
  constexpr int TL = tile_of<D>();
  return (4 * TL * (D + 1) + TL * (TL + 1) + 2 * TL) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          T* __restrict__ dq, Params p) {
  constexpr int TL = tile_of<D>(), R = TL / 16, PS = TL + 1;
  constexpr int DPT = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + TL * (D + 1);
  float* Ks = dOs + TL * (D + 1);
  float* Vs = Ks + TL * (D + 1);
  float* dSs = Vs + TL * (D + 1);
  float* ls = dSs + TL * PS;
  float* ds = ls + TL;

  // the last query tile first: under the causal mask it sees the most keys
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TL;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (p.Hq / p.Hkv);
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  load_tile<T, D, TL>(Qs, q, b, q0, p.Sq, p.Hq, h);
  load_tile<T, D, TL>(dOs, dout, b, q0, p.Sq, p.Hq, h);
  load_rows<TL>(ls, ds, p, b, h, q0);

  // the keys a row of the tile can see: [k_lo, k_hi)
  const int q_last = min(q0 + TL, p.Sq) - 1;
  int k_lo = 0, k_hi = p.Skv;
  if (p.causal) k_hi = min(k_hi, q_last + 1);
  if (p.window) k_lo = max(k_lo, q0 - p.window + 1);
  if (p.chunk) {
    k_lo = max(k_lo, q0 / p.chunk * p.chunk);
    k_hi = min(k_hi, (q_last / p.chunk + 1) * p.chunk);
  }

  float dQ[R][DPT];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < DPT; ++c) dQ[i][c] = 0.f;

  for (int k0 = k_lo / TL * TL; k0 < k_hi; k0 += TL) {
    __syncthreads();   // the previous tile's K, V, dS are consumed
    load_tile<T, D, TL>(Ks, k, b, k0, p.Skv, p.Hkv, hk);
    load_tile<T, D, TL>(Vs, v, b, k0, p.Skv, p.Hkv, hk);
    __syncthreads();
    float s[R][R], dp[R][R];
    scores<D, R>(Qs, dOs, Ks, Vs, tr, tc, s, dp);
    probs<TL, R>(p, whole_tile<TL>(p, q0, k0), q0, k0, tr, tc, ls, ds, s,
                 dp, nullptr, dSs);
    __syncthreads();
    // dQ += dS K: rows tr + 16i, columns tc + 16c; the tile's sum first,
    // then into the total (a blocked sum, as dK and dV)
    float tQ[R][DPT];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < DPT; ++c) tQ[i][c] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < TL; ++kk) {
      float sv[R], kv[DPT];
#pragma unroll
      for (int i = 0; i < R; ++i) sv[i] = dSs[(tr + 16 * i) * PS + kk];
#pragma unroll
      for (int c = 0; c < DPT; ++c) kv[c] = Ks[kk * (D + 1) + tc + 16 * c];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < DPT; ++c) tQ[i][c] = fmaf(sv[i], kv[c], tQ[i][c]);
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < DPT; ++c) dQ[i][c] += tQ[i][c];
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + tr + 16 * i;
    if (row >= p.Sq) continue;
    const size_t at = ((size_t)(b * p.Sq + row) * p.Hq + h) * D;
#pragma unroll
    for (int c = 0; c < DPT; ++c)
      dq[at + tc + 16 * c] = from_f32<T>(dQ[i][c] * p.scale);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* o_lo, const void* dout,
                   void* dq, void* dk, void* dv, float* delta, int B,
                   const Params& p, cudaStream_t s, void* marks) {
  constexpr int TL = tile_of<D>();
  mark(marks, 0, s);
  cudaError_t e = launch_delta<T>(o, o_lo, dout, delta, B, p.Sq, p.Hq, D, s);
  if (e != cudaSuccess) return e;
  mark(marks, 1, s);
  if ((e = allow_smem<dkdv_kernel<T, D>>(dkdv_smem<D>())) != cudaSuccess ||
      (e = allow_smem<dq_kernel<T, D>>(dq_smem<D>())) != cudaSuccess)
    return e;
  const dim3 gk((p.Skv + TL - 1) / TL, p.Hkv, B);
  dkdv_kernel<T, D><<<gk, kThreads, dkdv_smem<D>(), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<T*>(dk), static_cast<T*>(dv), p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  mark(marks, 2, s);
  const dim3 gq((p.Sq + TL - 1) / TL, p.Hq, B);
  dq_kernel<T, D><<<gq, kThreads, dq_smem<D>(), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<T*>(dq), p);
  mark(marks, 3, s);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const void* o, const void* o_lo, const void* dout,
                       void* dq, void* dk, void* dv, float* delta, int B,
                       int D, const Params& p, cudaStream_t s, void* marks) {
  switch (D) {
#define REPRO_CASE(DD)                                                   \
  case DD:                                                               \
    return launch<T, DD>(q, k, v, o, o_lo, dout, dq, dk, dv, delta, B, p, \
                         s, marks);
    REPRO_CASE(16)
    REPRO_CASE(32)
    REPRO_CASE(64)
    REPRO_CASE(96)
    REPRO_CASE(128)
    REPRO_CASE(256)
#undef REPRO_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o, o_lo, dout, dq (B, Sq, Hq, D); k, v, dk, dv (B, Skv, Hkv, D):
// `dtype`, contiguous, 16-byte aligned; o_lo: the rounding residual of O
// that the bf16 tensor-core forward writes, or null (the SIMT forward
// writes none); lse (B, Hq, Sq) fp32 from the forward;
// delta: fp32 scratch (B, Hq, Sq).  D in {16, 32, 64, 96, 128, 256};
// window 0 for none; marks: null, or four cudaEvent_t recorded before the
// delta launch, after it, after dK/dV and after dQ.  Returns the first CUDA
// error of the three launches (0 on success).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* o_lo, const void* lse,
                                   const void* dout,
                                   void* dq, void* dk, void* dv, void* delta,
                                   int dtype, int B, int Sq, int Skv, int Hq,
                                   int Hkv, int D, int causal, int window,
                                   int chunk, float scale, void* stream,
                                   void* marks) {
  if (B == 0 || Sq == 0 || Skv == 0) return 0;
  Params p{static_cast<const float*>(lse), static_cast<const float*>(delta),
           Sq, Skv, Hq, Hkv, causal, chunk, scale};
  p.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* d = static_cast<float*>(delta);
  if (dtype == kFloat32)
    return dispatch_d<float>(q, k, v, o, o_lo, dout, dq, dk, dv, d, B, D, p,
                             s, marks);
  if (dtype == kBFloat16)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, o_lo, dout, dq, dk, dv, d,
                                     B, D, p, s, marks);
  return cudaErrorInvalidValue;
}

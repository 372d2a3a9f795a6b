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
//   delta_i = sum_d dO_id * O_id          (over the O the forward wrote)
//   dV_j = sum_i P_ij dO_i
//   dS_ij = P_ij (dO_i . v_j - delta_i)
//   dQ_i = scale * sum_j dS_ij k_j,  dK_j = scale * sum_i dS_ij q_i
// with GQA's sum over the G query heads of a kv head.  Masks: causal and
// chunk, or none (Sq != Skv allowed: cross attention, an encoder); the
// queries start at position 0 and every key slot is written (no q_offset,
// kv_len or key positions, no window: the wrapper raises for those).  D 16,
// 32, 64, 96 or 128; fp32 or bf16 in, fp32 accumulators, outputs in the
// input type.  A masked (query, key) pair has P = 0.
//
// Three kernels, no atomics (two runs give the same bits):
// - delta: one warp a query row;
// - dK/dV: one block per (64-key tile, kv head, batch), K and V of the
//   tile in shared memory as fp32; it loops over the G query heads of its
//   kv head and over the 64-row query tiles that can see the tile,
//   recomputing S and dP = dO V^T, then P and dS, and accumulates dK and dV
//   in registers, so GQA's sum over heads stays inside the block;
// - dQ: one block per (64-row query tile, query head, batch), Q and dO in
//   shared memory; it loops over the key tiles the rows can see,
//   recomputing S, dP and dS, and accumulates dQ in registers.
// 256 threads a block as 16 x 16: a thread holds 4 x 4 of a score tile
// (rows t/16 + 16i, keys t%16 + 16j) and 4 rows x D/16 columns of its
// accumulators (columns t%16 + 16c); shared rows are padded to D + 1
// floats, so the 16 columns of a half-warp fall in 16 banks.
//
// Bound: operations (4 D flops a visible (query, key) pair in the forward;
// the backward does 7 such products, 2.5x the forward's FLOPs by the
// usual count; it reads q, k, v, o, dO once and writes dq, dk, dv).  This
// first design runs on the fp32 cores, not the tensor cores, so it sits far
// from the bf16 bound; the wrapper's plan sends bf16 at D 64, 96 and 128 to
// the tensor-core design (csrc/flash_bwd_tc.cu) and keeps this kernel, the
// ``simt`` variant, for fp32 and for D 16 and 32.  Both run the delta pass
// of flash_bwd_common.cuh.  Shared
// memory: dK/dV 4 x 64 x (D + 1) + 2 x 64 x 65 floats (166 KB at D 128),
// dQ 4 x 64 x (D + 1) + 64 x 65 (149 KB): one block an SM.
#include "flash_bwd_common.cuh"   // Params, visible, the delta pass

namespace {

constexpr int kThreads = 256;   // 16 x 16
constexpr int kTile = 64;       // query rows and keys of a tile
constexpr int kPS = kTile + 1;  // padded stride of a score tile

// rows [r0, r0 + 64) of head hh of x (B, S, H, D) into dst [64][D + 1] as
// fp32, zeros past S; 16-byte loads
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ x,
                                          int b, int r0, int S, int H,
                                          int hh) {
  constexpr int kVec = 16 / sizeof(T), kRowVecs = D / kVec;
  for (int vi = threadIdx.x; vi < kTile * kRowVecs; vi += kThreads) {
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

// lse and delta of rows [q0, q0 + 64) of head h into ls, ds (0 past Sq)
__device__ __forceinline__ void load_rows(float* ls, float* ds,
                                          const Params& p, int b, int h,
                                          int q0) {
  if (threadIdx.x < kTile) {
    const int r = q0 + threadIdx.x;
    const size_t at = ((size_t)b * p.Hq + h) * p.Sq + r;
    ls[threadIdx.x] = r < p.Sq ? p.lse[at] : 0.f;
    ds[threadIdx.x] = r < p.Sq ? p.delta[at] : 0.f;
  }
}

// s = Q K^T and dp = dO V^T for the thread's 4 x 4 (rows tr + 16i of Qs /
// dOs, keys tc + 16j of Ks / Vs)
template <int D>
__device__ __forceinline__ void scores(const float* Qs, const float* dOs,
                                       const float* Ks, const float* Vs,
                                       int tr, int tc, float (&s)[4][4],
                                       float (&dp)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = Qs[(tr + 16 * i) * (D + 1) + d];
      ov[i] = dOs[(tr + 16 * i) * (D + 1) + d];
      kv[i] = Ks[(tc + 16 * i) * (D + 1) + d];
      vv[i] = Vs[(tc + 16 * i) * (D + 1) + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
}

// P and dS of the thread's 4 x 4 into Ps / dSs [64 rows][65]
__device__ __forceinline__ void probs(const Params& p, int q0, int k0,
                                      int tr, int tc, const float* ls,
                                      const float* ds, const float (&s)[4][4],
                                      const float (&dp)[4][4], float* Ps,
                                      float* dSs) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tc + 16 * j;
      const float pij = visible(p, q0 + r, k0 + c)
                            ? expf(s[i][j] * p.scale - ls[r]) : 0.f;
      if (Ps) Ps[r * kPS + c] = pij;
      dSs[r * kPS + c] = pij * (dp[i][j] - ds[r]);
    }
  }
}

template <int D>
constexpr size_t dkdv_smem() {
  return (4 * kTile * (D + 1) + 2 * kTile * kPS + 2 * kTile) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            T* __restrict__ dk, T* __restrict__ dv, Params p) {
  constexpr int DPT = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile * (D + 1);
  float* Qs = Vs + kTile * (D + 1);
  float* dOs = Qs + kTile * (D + 1);
  float* Ps = dOs + kTile * (D + 1);
  float* dSs = Ps + kTile * kPS;
  float* ls = dSs + kTile * kPS;
  float* ds = ls + kTile;

  // key tile 0 first: under the causal mask it sees the most queries
  const int k0 = blockIdx.x * kTile, hk = blockIdx.y, b = blockIdx.z;
  const int G = p.Hq / p.Hkv;
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  load_tile<T, D>(Ks, k, b, k0, p.Skv, p.Hkv, hk);
  load_tile<T, D>(Vs, v, b, k0, p.Skv, p.Hkv, hk);

  // the queries that can see a key of the tile: [q_lo, q_hi)
  const int k_last = min(k0 + kTile, p.Skv) - 1;
  int q_lo = 0, q_hi = p.Sq;
  if (p.causal) q_lo = k0;
  if (p.chunk) {
    q_lo = max(q_lo, k0 / p.chunk * p.chunk);
    q_hi = min(q_hi, (k_last / p.chunk + 1) * p.chunk);
  }

  float dK[4][DPT], dV[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DPT; ++c) dK[i][c] = dV[i][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int q0 = q_lo / kTile * kTile; q0 < q_hi; q0 += kTile) {
      __syncthreads();   // the previous tile's Q, dO, P, dS are consumed
      load_tile<T, D>(Qs, q, b, q0, p.Sq, p.Hq, h);
      load_tile<T, D>(dOs, dout, b, q0, p.Sq, p.Hq, h);
      load_rows(ls, ds, p, b, h, q0);
      __syncthreads();
      float s[4][4], dp[4][4];
      scores<D>(Qs, dOs, Ks, Vs, tr, tc, s, dp);
      probs(p, q0, k0, tr, tc, ls, ds, s, dp, Ps, dSs);
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q: keys tr + 16i, columns tc + 16c
#pragma unroll 2
      for (int r = 0; r < kTile; ++r) {
        float pv[4], sv[4], ov[DPT], qv[DPT];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Ps[r * kPS + tr + 16 * i];
          sv[i] = dSs[r * kPS + tr + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < DPT; ++c) {
          ov[c] = dOs[r * (D + 1) + tc + 16 * c];
          qv[c] = Qs[r * (D + 1) + tc + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < DPT; ++c) {
            dV[i][c] = fmaf(pv[i], ov[c], dV[i][c]);
            dK[i][c] = fmaf(sv[i], qv[c], dK[i][c]);
          }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
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
  return (4 * kTile * (D + 1) + kTile * kPS + 2 * kTile) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          T* __restrict__ dq, Params p) {
  constexpr int DPT = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kTile * (D + 1);
  float* Ks = dOs + kTile * (D + 1);
  float* Vs = Ks + kTile * (D + 1);
  float* dSs = Vs + kTile * (D + 1);
  float* ls = dSs + kTile * kPS;
  float* ds = ls + kTile;

  // the last query tile first: under the causal mask it sees the most keys
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (p.Hq / p.Hkv);
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  load_tile<T, D>(Qs, q, b, q0, p.Sq, p.Hq, h);
  load_tile<T, D>(dOs, dout, b, q0, p.Sq, p.Hq, h);
  load_rows(ls, ds, p, b, h, q0);

  // the keys a row of the tile can see: [k_lo, k_hi)
  const int q_last = min(q0 + kTile, p.Sq) - 1;
  int k_lo = 0, k_hi = p.Skv;
  if (p.causal) k_hi = min(k_hi, q_last + 1);
  if (p.chunk) {
    k_lo = q0 / p.chunk * p.chunk;
    k_hi = min(k_hi, (q_last / p.chunk + 1) * p.chunk);
  }

  float dQ[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DPT; ++c) dQ[i][c] = 0.f;

  for (int k0 = k_lo / kTile * kTile; k0 < k_hi; k0 += kTile) {
    __syncthreads();   // the previous tile's K, V, dS are consumed
    load_tile<T, D>(Ks, k, b, k0, p.Skv, p.Hkv, hk);
    load_tile<T, D>(Vs, v, b, k0, p.Skv, p.Hkv, hk);
    __syncthreads();
    float s[4][4], dp[4][4];
    scores<D>(Qs, dOs, Ks, Vs, tr, tc, s, dp);
    probs(p, q0, k0, tr, tc, ls, ds, s, dp, nullptr, dSs);
    __syncthreads();
    // dQ += dS K: rows tr + 16i, columns tc + 16c
#pragma unroll 2
    for (int kk = 0; kk < kTile; ++kk) {
      float sv[4], kv[DPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = dSs[(tr + 16 * i) * kPS + kk];
#pragma unroll
      for (int c = 0; c < DPT; ++c) kv[c] = Ks[kk * (D + 1) + tc + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DPT; ++c) dQ[i][c] = fmaf(sv[i], kv[c], dQ[i][c]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
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
                   const void* o, const void* dout, void* dq, void* dk,
                   void* dv, float* delta, int B, const Params& p,
                   cudaStream_t s) {
  cudaError_t e = launch_delta<T>(o, dout, delta, B, p.Sq, p.Hq, D, s);
  if (e != cudaSuccess) return e;
  if ((e = allow_smem<dkdv_kernel<T, D>>(dkdv_smem<D>())) != cudaSuccess ||
      (e = allow_smem<dq_kernel<T, D>>(dq_smem<D>())) != cudaSuccess)
    return e;
  const dim3 gk((p.Skv + kTile - 1) / kTile, p.Hkv, B);
  dkdv_kernel<T, D><<<gk, kThreads, dkdv_smem<D>(), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<T*>(dk), static_cast<T*>(dv), p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const dim3 gq((p.Sq + kTile - 1) / kTile, p.Hq, B);
  dq_kernel<T, D><<<gq, kThreads, dq_smem<D>(), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<T*>(dq), p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, void* dq, void* dk,
                       void* dv, float* delta, int B, int D, const Params& p,
                       cudaStream_t s) {
  switch (D) {
#define REPRO_CASE(DD) \
  case DD:             \
    return launch<T, DD>(q, k, v, o, dout, dq, dk, dv, delta, B, p, s);
    REPRO_CASE(16)
    REPRO_CASE(32)
    REPRO_CASE(64)
    REPRO_CASE(96)
    REPRO_CASE(128)
#undef REPRO_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o, dout, dq (B, Sq, Hq, D); k, v, dk, dv (B, Skv, Hkv, D): `dtype`,
// contiguous, 16-byte aligned; lse (B, Hq, Sq) fp32 from the forward;
// delta: fp32 scratch (B, Hq, Sq).  D in {16, 32, 64, 96, 128}.  Returns the
// first CUDA error of the three launches (0 on success).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* lse, const void* dout,
                                   void* dq, void* dk, void* dv, void* delta,
                                   int dtype, int B, int Sq, int Skv, int Hq,
                                   int Hkv, int D, int causal, int chunk,
                                   float scale, void* stream) {
  if (B == 0 || Sq == 0 || Skv == 0) return 0;
  const Params p{static_cast<const float*>(lse),
                 static_cast<const float*>(delta), Sq, Skv, Hq, Hkv, causal,
                 chunk, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* d = static_cast<float*>(delta);
  if (dtype == kFloat32)
    return dispatch_d<float>(q, k, v, o, dout, dq, dk, dv, d, B, D, p, s);
  if (dtype == kBFloat16)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, d, B, D,
                                     p, s);
  return cudaErrorInvalidValue;
}

// Forward flash attention (online softmax) for Hopper (sm_90a), SIMT: the
// prefill path for fp32, for bf16 at head_dim 16 and 32, and for calls with
// key positions and more than 8 query rows; head_dim 16, 32, 64, 96, 128 or
// 256.  The wrapper's plan (repro_torch/kernels/flash_attention/ops.py:plan)
// sends bf16 prefill at head_dim 64-256 to csrc/flash_prefill_tc.cu and
// every call of at most 8 query rows to csrc/flash_decode.cu.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py:78 (flash_attention_kernel,
// body _attn_kernel).  Same function: scale 1/sqrt(D); GQA maps query head
// h to kv head h / (Hq / Hkv); masks causal, sliding window, chunk-local and
// kv length, a masked score is -2^30 (not -inf); m, l and acc are fp32; the
// output is acc / max(l, 1e-30) in the input type; q_offset is the position
// of the first query (cache-relative decode), a runtime value.  Key slot j
// sits at position j, or at kpos[j] when the optional int32 vector kpos
// (Skv,) is given (a rolling cache buffer); a key at a negative position is
// masked, as the reference masks unwritten cache slots.
//
// Optionally (a training forward, for csrc/flash_attention_bwd.cu) it also
// writes each query row's log-sum-exp of its scaled scores, lse = m +
// log(l), fp32 (B, Hq, Sq); a row that saw no key (l = 0) writes -inf.
// Serving passes no lse pointer.
//
// Layout: model layout, all contiguous: q, o (B, Sq, Hq, D); k, v
// (B, Skv, Hkv, D), k and v 16-byte aligned.  Key slots >= kv_len are never
// read.
//
// Bound: operations at prefill shapes (~512 flops per key and query at D
// 128 against ~0.5 byte).  It is the fp32 parity path: products on the fp32
// cores, where fp32 inputs have to run anyway (TF32 would not hold the
// reference's 2e-5), so it stays simple.  One block of 128 threads per (q
// tile, query head, batch).  The TPU's sequential kv grid axis becomes a
// loop inside the block over 64-key tiles, read with 16-byte loads and
// staged through shared memory as fp32 with their positions; without kpos
// the loop covers only the tiles that hold an unmasked key of the q tile
// (with kpos it visits every slot below kv_len, since a slot no longer
// tells its position; kpos is a template switch).  Each thread owns a
// register micro-tile of RPT rows x 4 keys of the score tile and RPT rows x
// D/16 columns of the output accumulator, so the running max, sum and
// rescale of a row stay in the registers of the 16 threads that share it
// (reduced with shuffles).  Tiles hold 64 query rows (RPT = 8), or 32 (RPT
// = 4) at D = 256, where 64 rows would give each thread 128 fp32
// accumulators and 209 KB of shared memory.  D 96 takes RPT 8: 48
// accumulators a thread (D / 16 = 6 columns of 8 rows), 89 KB of shared
// memory; 168 registers in fp32, 165 in bf16 (128 each with key
// positions; nvcc -Xptxas -v, sm_90a), no spills.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;   // 8 row groups x 16 column groups
constexpr int kBKV = 64;        // keys per tile: 16 column groups x 4
constexpr float kNegInf = -1073741824.f;   // -2^30, as the reference

struct Params {
  const int* kpos;   // (Skv,) key positions, or nullptr: slot j at position j
  int Sq, Skv, Hq, Hkv;
  int causal, window, chunk, q_offset, kv_len;
  float scale;
  float* lse;        // (B, Hq, Sq) log-sum-exp of each row, or nullptr
};

template <int D, int RPT>
constexpr size_t smem_floats() {
  return (size_t)(8 * RPT) * (D + 1) + (size_t)kBKV * (D + 1) +
         (size_t)kBKV * D + (size_t)(8 * RPT) * (kBKV + 1);
}

// kPos: the launch has key positions (p.kpos); without, the mask and the
// tile range are computed from the slot index alone.
template <typename T, int D, int RPT, bool kPos>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       Params p) {
  constexpr int BQ = 8 * RPT;
  constexpr int DPT = D / 16;          // output columns per thread
  constexpr int QS = D + 1, KS = D + 1, PS = kBKV + 1;   // padded strides
  constexpr int kVec = 16 / sizeof(T);                    // elements per load
  static_assert(kBKV * D % (kVec * kThreads) == 0, "tile load must divide");
  extern __shared__ float smem[];
  float* Qs = smem;                    // [BQ][D+1]
  float* Ks = Qs + BQ * QS;            // [kBKV][D+1]
  float* Vs = Ks + kBKV * KS;          // [kBKV][D]
  float* Ps = Vs + kBKV * D;           // [BQ][kBKV+1]
  __shared__ int Kp[kPos ? kBKV : 1];  // the tile's key positions

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const int nq = min(BQ, p.Sq - q0);

  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int r = idx / D, dd = idx % D;
    Qs[r * QS + dd] =
        r < nq ? to_f32(q[((size_t)(b * p.Sq + q0 + r) * p.Hq + h) * D + dd])
               : 0.f;
  }

  // keys that can be unmasked for some row of this q tile
  const int q_first = p.q_offset + q0, q_last = q_first + nq - 1;
  int kv_lo = 0, kv_hi = p.kv_len;
  if (p.causal && !kPos) {
    kv_hi = min(kv_hi, q_last + 1);
    if (p.window) kv_lo = max(kv_lo, q_first - p.window + 1);
    if (p.chunk) kv_lo = max(kv_lo, q_first / p.chunk * p.chunk);
  }

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  for (int kv0 = kv_lo / kBKV * kBKV; kv0 < kv_hi; kv0 += kBKV) {
    __syncthreads();   // the previous tile's K, V and P are consumed
    if (kPos && tid < kBKV)
      Kp[tid] = kv0 + tid < p.kv_len ? p.kpos[kv0 + tid] : -1;
    // 16-byte vector loads, unrolled so that (up to 16 a thread) they are in
    // flight at once
    constexpr int kLoads = kBKV * D / kVec / kThreads;
#pragma unroll (kLoads < 16 ? kLoads : 16)
    for (int it = 0; it < kLoads; ++it) {
      const int vi = tid + it * kThreads;
      const int c = vi / (D / kVec), d0 = vi % (D / kVec) * kVec;
      const int kp = kv0 + c;
      uint4 kraw = make_uint4(0, 0, 0, 0), vraw = kraw;   // zero: no NaN
      if (kp < p.kv_len) {
        const size_t off = ((size_t)(b * p.Skv + kp) * p.Hkv + hk) * D + d0;
        kraw = *reinterpret_cast<const uint4*>(k + off);
        vraw = *reinterpret_cast<const uint4*>(v + off);
      }
      const T* ke = reinterpret_cast<const T*>(&kraw);
      const T* ve = reinterpret_cast<const T*>(&vraw);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        Ks[c * KS + d0 + e] = to_f32(ke[e]);
        Vs[c * D + d0 + e] = to_f32(ve[e]);
      }
    }
    __syncthreads();

    float s[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      float qv[RPT], kv[4];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(tr + 8 * i) * QS + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tc + 16 * j) * KS + dd];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qp = p.q_offset + q0 + tr + 8 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // the key's position and whether it is written (without kpos: the
        // slot itself, written below kv_len)
        const int kp = kPos ? Kp[tc + 16 * j] : kv0 + tc + 16 * j;
        bool ok = kPos ? kp >= 0 : kp < p.kv_len;
        if (p.causal) ok = ok && kp <= qp;
        if (p.window) ok = ok && kp > qp - p.window;
        if (p.chunk) ok = ok && kp / p.chunk == qp / p.chunk;
        s[i][j] = ok ? s[i][j] * p.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row are 16 consecutive lanes of one warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj = expf(s[i][j] - m_new);
        Ps[(tr + 8 * i) * PS + tc + 16 * j] = pj;
        sum += pj;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBKV; ++c) {
      float pv[RPT], vv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(tr + 8 * i) * PS + c];
#pragma unroll
      for (int cc = 0; cc < DPT; ++cc) vv[cc] = Vs[c * D + tc + 16 * cc];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int cc = 0; cc < DPT; ++cc)
          acc[i][cc] = fmaf(pv[i], vv[cc], acc[i][cc]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = tr + 8 * i;
    if (r >= nq) continue;
    if (p.lse && tc == 0)
      p.lse[((size_t)b * p.Hq + h) * p.Sq + q0 + r] =
          l[i] > 0.f ? m[i] + logf(l[i])
                     : __int_as_float(0xff800000);
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + ((size_t)(b * p.Sq + q0 + r) * p.Hq + h) * D;
#pragma unroll
    for (int cc = 0; cc < DPT; ++cc)
      orow[tc + 16 * cc] = from_f32<T>(acc[i][cc] / denom);
  }
}

template <typename T, int D, int RPT, bool kPos>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<D, RPT>() * sizeof(float);
  const cudaError_t e =
      allow_smem<flash_attention_kernel<T, D, RPT, kPos>>(smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.Sq + 8 * RPT - 1) / (8 * RPT), p.Hq, B);
  flash_attention_kernel<T, D, RPT, kPos><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), p);
  return cudaGetLastError();
}

template <typename T, int D, int RPT>
cudaError_t dispatch_tile(const void* q, const void* k, const void* v,
                          void* o, int B, const Params& p, cudaStream_t s) {
  return p.kpos ? launch<T, D, RPT, true>(q, k, v, o, B, p, s)
                : launch<T, D, RPT, false>(q, k, v, o, B, p, s);
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int B, int D, const Params& p, cudaStream_t s) {
#define REPRO_CASE(DD, RPT) \
  case DD:                  \
    return dispatch_tile<T, DD, RPT>(q, k, v, o, B, p, s);
  switch (D) {
    REPRO_CASE(16, 8)
    REPRO_CASE(32, 8)
    REPRO_CASE(64, 8)
    REPRO_CASE(96, 8)
    REPRO_CASE(128, 8)
    REPRO_CASE(256, 4)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_CASE
}

}  // namespace

// kpos: (Skv,) int32 key positions, or nullptr; lse: fp32 (B, Hq, Sq),
// written when not null.
// Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, const void* kpos,
                                   int dtype, int B, int Sq, int Skv, int Hq,
                                   int Hkv, int D, int causal, int window,
                                   int chunk, int q_offset, int kv_len,
                                   float scale, void* lse, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  const Params p{static_cast<const int*>(kpos), Sq, Skv, Hq, Hkv, causal,
                 window, chunk, q_offset, kv_len, scale,
                 static_cast<float*>(lse)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return dispatch_d<float>(q, k, v, o, B, D, p, s);
  if (dtype == kBFloat16)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, B, D, p, s);
  return cudaErrorInvalidValue;
}

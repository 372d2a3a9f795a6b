// Flash attention forward, prefill, on the tensor cores (sm_90a): bf16,
// head_dim 64, 96, 128 or 256, more than 8 query rows.
//
// Replaces, for that dtype and those shapes, the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py:78 (flash_attention_kernel,
// body _attn_kernel).  Same function as csrc/flash_attention.cu: scale
// 1/sqrt(D); GQA maps query head h to kv head h / (Hq / Hkv); causal, sliding
// window and chunk masks, kv_len and q_offset (runtime values); a masked
// score is -2^30; m, l and acc are fp32; the output is acc / max(l, 1e-30)
// in bf16.  One numerical change: the probabilities P go into the second
// product as bf16 (the reference keeps them fp32); l sums them in fp32.
// Key positions (a rolling cache) are not taken here: the wrapper's plan
// sends such calls to the SIMT kernel.  Optionally (a training forward, for
// csrc/flash_attention_bwd.cu) it also writes each query row's log-sum-exp
// of its scaled scores, lse = m + log(l) in fp32 (B, Hq, Sq): the running
// max is kept in log2 units of the scaled score, so lse = (m2 + log2(l)) *
// ln 2; a row that saw no key (l = 0) writes -inf.  With the lse a
// training forward also writes o_lo, O's rounding residual: bf16 of the
// fp32 output less its bf16 O, which the backward's delta pass adds back
// (csrc/flash_bwd_common.cuh).  Serving passes neither pointer, and the
// kernel then writes neither.
//
// Bound: operations.  At chatglm3-6b's prefill (B 8, S 1024, D 128, causal)
// each (query, key) pair costs 4*D flops against ~0.5 byte, far above the
// H100's ~295 flop/byte, and only wgmma reaches the bf16 peak.  Design:
// - one block per (128 query rows, query head, batch): two consumer
//   warpgroups of 64 rows, which share each K/V tile and take turns on the
//   tensor cores while the other runs its softmax.  Also at D 256, where O
//   alone is 128 fp32 registers a thread: 2 x 128 threads of ~200
//   registers fit an SM's 64 K, and Q plus the ring take 193 KB (PERF.md
//   has one warpgroup against two there);
// - S = Q K^T with wgmma m64n64k16 (Q and K in shared memory, both K-major:
//   rows contiguous along D); O += P V with wgmma m64nDk16, P from
//   registers (the fp32 accumulator layout of S, rounded to bf16 pairs, is
//   the A-fragment layout: no shuffle), V from shared memory MN-major (rows
//   contiguous along D: the transpose bit);
// - Q and a two-stage ring of K/V tiles of 64 keys are loaded by TMA
//   (cp.async.bulk.tensor, 4-D maps over the model layout (B, S, H, D),
//   boxes of 64 rows by 64 columns with the 128-byte swizzle the
//   descriptors name; at D 96, whose 192-byte row is no whole number of
//   128-byte atoms, boxes of 32 columns with the 64-byte swizzle: three
//   boxes a row, each a whole atom of both operands, the same 6 k16 steps
//   for Q K^T and one m64n96k16 per 16 keys for P V) and
//   complete on mbarriers; thread 0 issues every copy, tile t + 2 once all
//   warps are past tile t (no warp specialisation, no persistent grid yet);
// - the online softmax stays in registers: a thread holds 2 rows of its
//   warp's 16, and a row's max and sum are reduced over its 4-thread quad
//   with shuffles; exp2 with the scale folded into log2(e);
// - the causal, window and chunk bounds of the block's rows give its range
//   of key tiles, and a warpgroup skips the tiles outside its own range;
//   only tiles that cut a mask boundary (kv_len, causal, window, chunk) are
//   masked, against two bounds per row computed once: a mask test written
//   per element (with kp / chunk) unrolled into thousands of instructions,
//   and the instruction fetch, not the tensor cores, set the time.  Ragged
//   Sq and Skv: TMA fills rows out of bounds with zeros, and their keys are
//   masked by kv_len, their queries not stored.
// Tried and not kept (PERF.md): overlapping a warpgroup's softmax
// with its own next product (S of tile i + 1 and P V of tile i in flight
// together, as FlashAttention-3 does) - with these inline wgmma wrappers
// ptxas serialises the products (C7514/C7515: accumulator registers
// touched inside the asynchronous stage); a producer warp with empty/full
// barriers instead of the block barrier - a ninth warp caps registers at
// 168 and D 256 spills (C7512), and setmaxnreg did not lift the cap.
// Also right on the card at D 96 and not kept: 64-column boxes with the
// 128-byte swizzle, the second box of a row half out of bounds (TMA fills
// it with zeros) and P V reading one and a half atoms of V - a layout
// outside the documented canonical ones, for a small difference in time.
// Registers and spills (nvcc -Xptxas -v, sm_90a, with the o_lo store):
// D 64: 105 registers, D 96: 122, D 128: 139, D 256: 218 (201 before it);
// no spills, no local memory.
#include "hopper.cuh"   // TMA, mbarriers, descriptors, wgmma, tensor maps

namespace {

constexpr int kBKV = kBoxRows;              // keys per tile
constexpr int kWG = 2;                      // consumer warpgroups a block
constexpr float kNegInf = -1073741824.f;    // -2^30, as the reference

struct Params {
  int Sq, Hq, Hkv;
  int causal, window, chunk, q_offset, kv_len;
  float scale_log2;                         // 1/sqrt(D) * log2(e)
  float* lse;                               // (B, Hq, Sq) or nullptr
  __nv_bfloat16* o_lo;                      // like o, or nullptr
};

// The slots [lo, hi) that a query at a position in [q_first, q_last] can
// see under the masks (a superset: each bound on its own).
__device__ __forceinline__ void key_range(const Params& p, int q_first,
                                          int q_last, int& lo, int& hi) {
  lo = 0;
  hi = p.kv_len;
  if (p.causal) hi = min(hi, q_last + 1);
  if (p.window) lo = max(lo, q_first - p.window + 1);
  if (p.chunk) {
    lo = max(lo, q_first / p.chunk * p.chunk);
    hi = min(hi, (q_last / p.chunk + 1) * p.chunk);
  }
}

// K and V tile t (64 keys of kv head hk, batch b) into ring stage st
template <int D>
__device__ __forceinline__ void load_kv(__nv_bfloat16* Ks, __nv_bfloat16* Vs,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv, uint64_t* bar,
                                        int st, int t, int hk, int b) {
  using T = Tiles<D>;
  mbar_expect_tx(bar, 2u * T::kNB * T::kBox * 2);
#pragma unroll
  for (int nb = 0; nb < T::kNB; ++nb) {
    tma_load_4d(Ks + (st * T::kNB + nb) * T::kBox, tk, bar, nb * T::kCols, hk,
                t * kBKV, b);
    tma_load_4d(Vs + (st * T::kNB + nb) * T::kBox, tv, bar, nb * T::kCols, hk,
                t * kBKV, b);
  }
}

// Shared memory: Q [kWG][NB][64][cols], then K and V rings
// [2][NB][64][cols], each box swizzled, 1024-byte aligned.
template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(kWG + 4) * Tiles<D>::kNB * Tiles<D>::kBox * 2 + 1024;
}

template <int D>
__global__ void __launch_bounds__(128 * kWG, 1)
flash_prefill_tc_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        __nv_bfloat16* __restrict__ o, Params p) {
  using TL = Tiles<D>;
  constexpr int BQ = 64 * kWG;              // query rows of the block
  constexpr int NB = TL::kNB, kBox = TL::kBox;
  extern __shared__ unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* Ks = Qs + kWG * NB * kBox;
  __nv_bfloat16* Vs = Ks + 2 * NB * kBox;
  __shared__ __align__(8) uint64_t bar_kv[2];
  __shared__ __align__(8) uint64_t bar_q;

  const int tid = threadIdx.x, wg = tid / 128, warp = tid % 128 / 32,
            lane = tid % 32;
  // heaviest q tiles (latest under the causal mask) first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (p.Hq / p.Hkv);

  int lo, hi;
  key_range(p, p.q_offset + q0, p.q_offset + min(q0 + BQ, p.Sq) - 1, lo, hi);
  const int t_lo = lo / kBKV;
  const int ntiles = hi > lo ? (hi + kBKV - 1) / kBKV - t_lo : 0;
  // this warpgroup's rows and tiles
  const int wq0 = q0 + wg * 64, wrows = min(64, p.Sq - wq0);
  int wlo = 0, whi = 0;
  if (wrows > 0)
    key_range(p, p.q_offset + wq0, p.q_offset + wq0 + wrows - 1, wlo, whi);
  const int w_tlo = wlo / kBKV, w_thi = whi > wlo ? (whi + kBKV - 1) / kBKV : 0;

  if (tid == 0) {
    mbar_init(&bar_kv[0], 1);
    mbar_init(&bar_kv[1], 1);
    mbar_init(&bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    const int nwg = min(kWG, (p.Sq - q0 + 63) / 64);   // warpgroups with rows
    mbar_expect_tx(&bar_q, (uint32_t)nwg * NB * kBox * 2);
    for (int w = 0; w < nwg; ++w)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        tma_load_4d(Qs + (w * NB + nb) * kBox, &tq, &bar_q, nb * TL::kCols,
                    h, q0 + w * 64, b);
    for (int s = 0; s < 2 && s < ntiles; ++s)
      load_kv<D>(Ks, Vs, &tk, &tv, &bar_kv[s], s, t_lo + s, hk, b);
  }

  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  // the thread's two rows (of the accumulator layout): each admits the
  // keys [row_lo, row_hi), the masks folded into two bounds once (a chunk
  // test kp / chunk == qp / chunk is chunk_start <= kp < chunk_start +
  // chunk for non-negative positions)
  const int row0 = wq0 + warp * 16 + lane / 4;
  int row_lo[2], row_hi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = p.q_offset + row0 + 8 * i;
    key_range(p, qp, qp, row_lo[i], row_hi[i]);
  }
  const int wq_first = p.q_offset + wq0, wq_last = wq_first + wrows - 1;
  const __nv_bfloat16* Qw = Qs + wg * NB * kBox;

  mbar_wait(&bar_q, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int t = t_lo + it, st = it & 1;
    mbar_wait(&bar_kv[st], (it >> 1) & 1);
    if (wrows > 0 && t >= w_tlo && t < w_thi) {   // warpgroup-uniform
      // S = Q K^T: D/16 steps of k16; within a box a step moves the
      // descriptor 32 bytes, the next box is 64 rows further; the stride
      // of 8-row groups is 8 rows of the box
      float s[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk / TL::kSteps) * kBox + (kk % TL::kSteps) * 16;
        wgmma_ss_m64n64(s, make_desc<D>(Qw + off, 16, 8 * TL::kRowBytes),
                        make_desc<D>(Ks + st * NB * kBox + off, 16,
                                     8 * TL::kRowBytes),
                        kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(s);

      // s[4j + 2i + c]: row row0 + 8i, key t*64 + 8j + 2*(lane%4) + c.
      // Only a tile that cuts a mask boundary of the warpgroup's rows is
      // masked (one branch for the tile: the per-element code stays short)
      const int k0 = t * kBKV;
      const bool edge = k0 + kBKV > p.kv_len ||
                        (p.causal && k0 + kBKV - 1 > wq_first) ||
                        (p.window && k0 <= wq_last - p.window) || p.chunk;
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] *= p.scale_log2;
      if (edge) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int kp = k0 + 8 * (e / 4) + 2 * (lane % 4) + e % 2;
          const int i = e / 2 % 2;
          s[e] = kp >= row_lo[i] && kp < row_hi[i] ? s[e] : kNegInf;
        }
      }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int e = 0; e < 32; ++e) mx[e / 2 % 2] = fmaxf(mx[e / 2 % 2], s[e]);
      float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m_r[i], mx[i]);
        corr[i] = exp2f(m_r[i] - m_new);
        m_r[i] = m_new;
      }
      uint32_t pa[4][4];   // P as bf16 A fragments, one per k16 step
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float e[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            e[2 * i + c] = exp2f(s[4 * j + 2 * i + c] - m_r[i]);
            sum[i] += e[2 * i + c];
          }
        // key block j is half (j % 2) of k16 step j / 2: registers
        // {0, 1} hold rows row0 / row0 + 8 of its first 8 keys, {2, 3}
        // of its second 8
        pa[j / 2][2 * (j % 2) + 0] = pack_bf16(e[0], e[1]);
        pa[j / 2][2 * (j % 2) + 1] = pack_bf16(e[2], e[3]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * corr[i] + sum[i];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        oacc[4 * j + 0] *= corr[0];
        oacc[4 * j + 1] *= corr[0];
        oacc[4 * j + 2] *= corr[1];
        oacc[4 * j + 3] *= corr[1];
      }

      // O += P V: 4 steps of 16 keys; a step is 16 rows of each V box;
      // along D the boxes (the swizzle atoms of the MN-major operand) are
      // a box apart, along the keys 8-row groups 8 rows apart
      reg_fence(oacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<D>(oacc, pa[kk],
                    make_desc<D>(Vs + st * NB * kBox + kk * 16 * TL::kCols,
                                 kBox * 2, 8 * TL::kRowBytes));
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(oacc);
    }
    __syncthreads();   // every warp is done with stage st
    if (tid == 0 && it + 2 < ntiles)
      load_kv<D>(Ks, Vs, &tk, &tv, &bar_kv[st], st, t + 2, hk, b);
  }

  // l: sum over the quad; out = acc / max(l, 1e-30), as acc times the
  // reciprocal (the output is bf16: the last fp32 bit does not reach it)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    const int row = row0 + 8 * i;
    if (p.lse && lane % 4 == 0 && row < p.Sq)
      p.lse[((size_t)b * p.Hq + h) * p.Sq + row] =
          l_r[i] > 0.f ? (m_r[i] + log2f(l_r[i])) * 0.6931471805599453f
                       : __int_as_float(0xff800000);
    l_r[i] = 1.f / fmaxf(l_r[i], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= p.Sq) continue;
    const size_t at = ((size_t)(b * p.Sq + row) * p.Hq + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      const float x = oacc[4 * j + 2 * i] * l_r[i];
      const float y = oacc[4 * j + 2 * i + 1] * l_r[i];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
      *reinterpret_cast<__nv_bfloat162*>(o + at + col) = hi;
      if (p.o_lo)
        *reinterpret_cast<__nv_bfloat162*>(p.o_lo + at + col) =
            __floats2bfloat162_rn(x - __low2float(hi), y - __high2float(hi));
    }
  }
}

// ---- host side ----

template <int D>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, void* o, int B, const Params& p,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  const cudaError_t e = allow_smem<flash_prefill_tc_kernel<D>>(smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.Sq + 64 * kWG - 1) / (64 * kWG), p.Hq, B);
  flash_prefill_tc_kernel<D><<<grid, 128 * kWG, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), p);
  return cudaGetLastError();
}

}  // namespace

// q, o (B, Sq, Hq, D), k, v (B, Skv, Hkv, D): bf16, contiguous, 16-byte
// aligned; D in {64, 96, 128, 256}; Sq > 8 (fewer rows take the split decode
// kernel); lse: fp32 (B, Hq, Sq) written when not null; o_lo: like o,
// O's rounding residual, written when not null.  Returns the CUDA error of the launch (0 on
// success; cudaErrorInvalidValue for another D or a tensor map the driver
// refuses).
extern "C" int flash_prefill_tc_fwd(const void* q, const void* k,
                                    const void* v, void* o, int B, int Sq,
                                    int Skv, int Hq, int Hkv, int D,
                                    int causal, int window, int chunk,
                                    int q_offset, int kv_len, float scale,
                                    void* lse, void* o_lo, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, Sq, Hq, D) || !make_map(&tk, k, B, Skv, Hkv, D) ||
      !make_map(&tv, v, B, Skv, Hkv, D))
    return cudaErrorInvalidValue;
  const Params p{Sq, Hq, Hkv, causal, window, chunk, q_offset, kv_len,
                 scale * 1.4426950408889634f, static_cast<float*>(lse),
                 static_cast<__nv_bfloat16*>(o_lo)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(tq, tk, tv, o, B, p, s);
    case 96:
      return launch<96>(tq, tk, tv, o, B, p, s);
    case 128:
      return launch<128>(tq, tk, tv, o, B, p, s);
    case 256:
      return launch<256>(tq, tk, tv, o, B, p, s);
    default:
      return cudaErrorInvalidValue;
  }
}

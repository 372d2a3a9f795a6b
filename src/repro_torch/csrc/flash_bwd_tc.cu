// Flash attention, backward, on the tensor cores (sm_90a): bf16, head_dim
// 64, 96, 128 or 256, with or without a sliding window.  dQ, dK and dV from
// q, k, v, the forward's output o, its per-row log-sum-exp lse and dO.
//
// Backward: no TPU counterpart.  The reference never calls its Pallas
// kernel src/repro/kernels/flash_attention/kernel.py:78 on the training
// path: it differentiates its plain attention
// (src/repro/models/attention.py:149-176) through XLA.  This is the
// derivative of what csrc/flash_prefill_tc.cu computes, the same function
// as csrc/flash_attention_bwd.cu (which keeps fp32, D 16 and 32): with
// s = scale * q.k and P = exp(s - lse) over the visible keys,
//   delta_i = sum_d dO_id * O_id          (over the O the forward wrote,
//                                          plus its rounding residual
//                                          o_lo where the forward wrote one)
//   dV_j = sum_i P_ij dO_i
//   dS_ij = P_ij (dO_i . v_j - delta_i)
//   dQ_i = scale * sum_j dS_ij k_j,  dK_j = scale * sum_i dS_ij q_i
// with GQA's sum over the G query heads of a kv head.  Masks: causal,
// window and chunk, or none (Sq != Skv allowed), queries from position 0,
// every key slot written; ragged Sq and Skv.  Inputs bf16, accumulators
// fp32, outputs bf16.  lse arrives in natural-log units and is taken to
// log2 units as it is staged (P = exp2(s * scale * log2(e) - lse * log2(e))).
//
// Bound: operations.  The usual count is 2.5x the forward's 4 D flops a
// visible (query, key) pair (five products); this design issues seven: S
// and dP are recomputed in the dQ kernel in exchange for no atomics, so its
// own floor at the bf16 peak is 1.4x the bound (0.213 ms at qwen2-7b's
// 8 x 1024, GQA 28:4, D 128, causal, against 0.152).  Design:
// - three launches, no atomics (two runs give the same bits): delta (the
//   pass of flash_bwd_common.cuh), dK/dV, dQ;
// - dK/dV (D 64-128): one block per (64-key tile, kv head, batch), one
//   warpgroup.  K
//   and V of the tile are loaded once by TMA; a two-stage TMA ring holds
//   the 64-row Q and dO tiles, and the threads stage the rows' lse and
//   delta beside them.  The block walks the G query heads of its kv head
//   and the query tiles that can see its keys: S^T = K Q^T and dP^T = V dO^T
//   by wgmma m64n64k16 (both operands K-major in shared memory, one commit
//   group), P^T and dS^T in registers, then dV += P^T dO and dK += dS^T Q
//   by wgmma m64nDk16 with the A operand from registers (the accumulator
//   layout of a 64 x 64 tile, rounded to bf16 pairs, is the A fragment
//   layout: no shuffle) and dO / Q read MN-major (the transpose bit), as
//   tc_prefill reads V.  dK and dV stay in registers for the whole walk
//   (2 x D / 2 fp32 a thread), so GQA's sum stays in the block.  About 97 KB
//   of shared memory at D 128: two blocks an SM.  Key tile 0 (under the
//   causal mask the one with the most query tiles) first;
// - dQ (D 64-128): one block per (128 query rows, query head, batch), two
//   warpgroups of 64 rows, as tc_prefill.  Q, dO, lse and delta of the rows
//   are loaded once; a two-stage TMA ring holds the 64-key K and V tiles.
//   Per key tile a warpgroup can see: S = Q K^T and dP = dO V^T (shared
//   memory), dS in registers, dQ += dS K (K read MN-major).  The heaviest
//   row blocks first;
// - D 256 (recurrentgemma-2b's local attention: MQA 10:1, window 2048) is a
//   design of its own, the "wide" kernels: a warpgroup's accumulators for
//   all 256 columns would be 2 x 128 fp32 a thread in dK/dV (D 128 already
//   takes 240 registers) and 128 in dQ, and dQ's D 128 layout (two 64-row
//   warpgroups, each with its own Q and dO, and a K/V ring) needs 256 KB of
//   shared memory at D 256.  So both kernels take one 64-row (dQ) or 64-key
//   (dK/dV) tile a block with two warpgroups that split D: each owns 128
//   columns of dK and dV (or of dQ), D 128's register profile.  S (S^T) and
//   dP (dP^T) are full-D contractions that both warpgroups need; warpgroup
//   0 computes S and P, warpgroup 1 dP, each for the whole tile (16 k16
//   steps, one product each, no branch around wgmma: the operands are
//   picked by warpgroup), and they exchange the two 64 x 64 fp32 tiles
//   through 32 KB of shared memory (a thread's 32 accumulator values to
//   the same thread of the other warpgroup: same layout, no shuffle), one
//   block barrier.  Both then form dS = P (dP - delta) with the same fp32
//   operations and take their halves' products from registers (m64n128k16,
//   B MN-major from the half's two boxes).  The other route, each
//   warpgroup computing both S and dP, issues 1.4x the dK/dV products and
//   needs no exchange; the exchange costs 32 KB a tile of shared-memory
//   traffic against ~10 MFLOP of products.  Shared memory: K, V and a
//   two-stage (Q, dO) ring (dK/dV) or Q, dO and a two-stage (K, V) ring
//   (dQ) are six 32 KB tiles, and the exchange 32 KB: 225 KB, one block an
//   SM.  At recurrentgemma-2b's 2 x 4096 the dK/dV grid is 64 key tiles x
//   1 kv head x 2 = 128 blocks on 132 SMs, each walking 10 heads x ~33
//   query tiles (the window's), so that walk sets its time; dQ has 64 x 10
//   x 2 = 1280 blocks.  Measured there (chip_smoke.py, H100 80GB HBM3 at
//   700 W): dK/dV 1.30 ms, dQ 0.64, delta 0.04, about 3.9 us a (head,
//   query tile) step of dK/dV against 1.4 us of products at an SM's peak;
// - the TMA maps, boxes (64 rows by 64 columns with the 128-byte swizzle;
//   at D 96 three 32-column boxes with the 64-byte swizzle), descriptors
//   and wgmma wrappers are tc_prefill's (hopper.cuh);
// - masks: the key range of a row block (dQ) or the query range of a key
//   tile (dK/dV) comes from the tiles' bounds, the window's included; only
//   a tile that cuts a causal, window, chunk or Skv bound is masked
//   (tile_cuts), against two bounds per row computed once (tc_prefill's
//   lesson: a test per element unrolls into instruction fetch).  TMA fills
//   rows past Sq and keys past Skv with zeros, which would give S = 0 and
//   P = exp(-lse), not 0: a row past Sq is staged with lse = +inf (P = 0
//   exactly), and the key tile that crosses Skv is masked.
// Rounding, fixed at compile time: P enters dV += P^T dO as one bf16 term
// (the forward's own choice for P); dS enters dK += dS^T Q and dQ += dS K
// as two, hi = bf16(x) and lo = bf16(x - hi), in two accumulating products,
// which leaves only the fp32 accumulation's error: 9 products, not 7.  Why
// dS is split (measured on the H100 with chip_smoke.py's gradient check,
// qwen2-7b at 2 layers, limit 1.1x the bf16 floor; PERF.md): with P and dS
// both rounded the worst leaf, the key bias, whose gradient is analytically
// zero, sat at 1.0925, with dS split at 1.0707, with P split as well still
// 1.0707; dS's split costs 0.10 ms a launch at qwen2-7b's shape (0.70 ->
// 0.80 ms), P's would cost another 0.06 (0.86 ms) and buy nothing.
// Registers and spills (nvcc -Xptxas -v, sm_90a; dK/dV / dQ): D 64: 168 /
// 137; D 96: 206 / 145; D 128: 240 / 161; D 256 (the wide kernels, 256
// threads): 252 / 160; no spills, no local memory.  The delta pass: 32.
#include "flash_bwd_common.cuh"   // Params, the delta pass
#include "hopper.cuh"             // TMA, mbarriers, descriptors, wgmma

namespace {

constexpr int kTile = kBoxRows;   // query rows and keys of a tile
constexpr int kDQWG = 2;          // warpgroups of a dQ block
constexpr float kLog2e = 1.4426950408889634f;

// The keys [lo, hi) that queries in [q_first, q_last] can see (a superset:
// each bound on its own).
__device__ __forceinline__ void key_range(const Params& p, int q_first,
                                          int q_last, int& lo, int& hi) {
  lo = 0;
  hi = p.Skv;
  if (p.causal) hi = min(hi, q_last + 1);
  if (p.window) lo = max(lo, q_first - p.window + 1);
  if (p.chunk) {
    lo = max(lo, q_first / p.chunk * p.chunk);
    hi = min(hi, (q_last / p.chunk + 1) * p.chunk);
  }
}

// The queries [lo, hi) that can see a key in [k_first, k_last].
__device__ __forceinline__ void query_range(const Params& p, int k_first,
                                            int k_last, int& lo, int& hi) {
  lo = 0;
  hi = p.Sq;
  if (p.causal) lo = k_first;
  if (p.window) hi = min(hi, k_last + p.window);
  if (p.chunk) {
    lo = max(lo, k_first / p.chunk * p.chunk);
    hi = min(hi, (k_last / p.chunk + 1) * p.chunk);
  }
}

// Whether the queries [q0, q0 + 63] and keys [k0, k0 + 63] do not all lie in
// one chunk.
__device__ __forceinline__ bool cuts_chunk(const Params& p, int q0, int k0) {
  if (!p.chunk) return false;
  const int c = q0 / p.chunk;
  return (q0 + kTile - 1) / p.chunk != c || k0 / p.chunk != c ||
         (k0 + kTile - 1) / p.chunk != c;
}

// Whether the tile of queries [q0, q0 + 63] and keys [k0, k0 + 63] holds a
// pair the masks hide: a key past Skv, a key after a query (causal), a key
// window or more before a query (the forward's test, flash_prefill_tc.cu),
// or a chunk bound.  Only such a tile is masked element by element.
__device__ __forceinline__ bool tile_cuts(const Params& p, int q0, int k0) {
  return k0 + kTile > p.Skv || (p.causal && k0 + kTile - 1 > q0) ||
         (p.window && k0 <= q0 + kTile - 1 - p.window) ||
         cuts_chunk(p, q0, k0);
}

// x0, x1 (two columns of a row) as a bf16 pair; with kSplitIt also the
// pair of what rounding left (x ~ hi + lo)
template <bool kSplitIt>
__device__ __forceinline__ void pack(float x0, float x1, uint32_t& hi,
                                     uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  if constexpr (kSplitIt)
    lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// A 64 x 64 accumulator tile in the A fragments of four k16 steps: element
// 4j + 2i + c (row 8i of the thread's pair, column 8j + 2(lane % 4) + c) to
// step j / 2, register 2 (j % 2) + i
template <bool kSplitIt>
__device__ __forceinline__ void to_frags(const float (&x)[32],
                                         uint32_t (&hi)[4][4],
                                         uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      pack<kSplitIt>(x[4 * j + 2 * i], x[4 * j + 2 * i + 1],
                     hi[j / 2][2 * (j % 2) + i], lo[j / 2][2 * (j % 2) + i]);
}

// acc (64 x D) += A (64 x 64, fragments) B, B a 64 x D tile in shared memory
// read MN-major; with kSplitIt a second product of the remainders
template <int D, bool kSplitIt>
__device__ __forceinline__ void rs_tile(float (&acc)[D / 2],
                                        const uint32_t (&hi)[4][4],
                                        const uint32_t (&lo)[4][4],
                                        const __nv_bfloat16* B) {
  using TL = Tiles<D>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t desc = make_desc<D>(B + kk * 16 * TL::kCols, TL::kBox * 2,
                                       8 * TL::kRowBytes);
    wgmma_rs<D>(acc, hi[kk], desc);
    if constexpr (kSplitIt) wgmma_rs<D>(acc, lo[kk], desc);
  }
}

// acc (64 x 64) = A B^T, A and B 64 x D tiles in shared memory, K-major:
// D / 16 steps of k16; within a box a step moves 32 bytes, the next box is
// a box further
template <int D>
__device__ __forceinline__ void ss_tile(float (&acc)[32],
                                        const __nv_bfloat16* A,
                                        const __nv_bfloat16* B) {
  using TL = Tiles<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk / TL::kSteps) * TL::kBox + (kk % TL::kSteps) * 16;
    wgmma_ss_m64n64(acc, make_desc<D>(A + off, 16, 8 * TL::kRowBytes),
                    make_desc<D>(B + off, 16, 8 * TL::kRowBytes), kk > 0);
  }
}

template <int D>
__host__ __device__ constexpr int tile_elems() {
  return Tiles<D>::kNB * Tiles<D>::kBox;
}

// K, V and a ring of two (Q, dO) stages: six 64 x D tiles
template <int D>
constexpr size_t dkdv_smem() {
  return (size_t)6 * tile_elems<D>() * 2 + 1024;
}

template <int D>
__global__ void __launch_bounds__(128, 1)
dkdv_tc_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tdo,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
               Params p) {
  constexpr int kT = tile_elems<D>();
  extern __shared__ unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* Vs = Ks + kT;
  __nv_bfloat16* Qs = Vs + kT;          // [2 stages][tile]
  __nv_bfloat16* dOs = Qs + 2 * kT;     // [2 stages][tile]
  __shared__ float Ls[2][kTile], Ds[2][kTile];   // lse (log2 units), delta
  __shared__ __align__(8) uint64_t bar_kv;
  __shared__ __align__(8) uint64_t bar_q[2];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.x * kTile, hk = blockIdx.y, b = blockIdx.z;
  const int G = p.Hq / p.Hkv;
  const float scale_log2 = p.scale * kLog2e;
  int q_lo, q_hi;
  query_range(p, k0, min(k0 + kTile, p.Skv) - 1, q_lo, q_hi);
  const int qt_lo = q_lo / kTile;
  const int nqt = q_hi > q_lo ? (q_hi + kTile - 1) / kTile - qt_lo : 0;
  const int niter = G * nqt;   // (query head, query tile) pairs

  // iteration it: query head hk * G + it / nqt, rows from q0_of(it)
  auto q0_of = [&](int it) { return (qt_lo + it % nqt) * kTile; };
  auto h_of = [&](int it) { return hk * G + it / nqt; };
  auto stage_rows = [&](int it) {   // lse and delta of its rows
    if (tid < kTile) {
      const int r = q0_of(it) + tid;
      const size_t at = ((size_t)b * p.Hq + h_of(it)) * p.Sq + r;
      Ls[it & 1][tid] = r < p.Sq ? p.lse[at] * kLog2e
                                 : __int_as_float(0x7f800000);
      Ds[it & 1][tid] = r < p.Sq ? p.delta[at] : 0.f;
    }
  };
  auto load_q = [&](int it) {       // Q and dO of its rows, by thread 0
    const int st = it & 1;
    mbar_expect_tx(&bar_q[st], 2u * kT * 2);
    tma_load_rows<D>(Qs + st * kT, &tq, &bar_q[st], h_of(it), q0_of(it), b);
    tma_load_rows<D>(dOs + st * kT, &tdo, &bar_q[st], h_of(it), q0_of(it),
                     b);
  };

  if (tid == 0) {
    mbar_init(&bar_kv, 1);
    mbar_init(&bar_q[0], 1);
    mbar_init(&bar_q[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (niter > 0) stage_rows(0);
  __syncthreads();
  if (tid == 0 && niter > 0) {
    mbar_expect_tx(&bar_kv, 2u * kT * 2);
    tma_load_rows<D>(Ks, &tk, &bar_kv, hk, k0, b);
    tma_load_rows<D>(Vs, &tv, &bar_kv, hk, k0, b);
    for (int s = 0; s < 2 && s < niter; ++s) load_q(s);
  }

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  // the thread's two keys (rows of the accumulator layout): each is seen
  // by the queries [row_lo, row_hi)
  const int row0 = warp * 16 + lane / 4;
  int row_lo[2], row_hi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kp = k0 + row0 + 8 * i;
    query_range(p, kp, kp, row_lo[i], row_hi[i]);
  }

  if (niter > 0) mbar_wait(&bar_kv, 0);
  for (int it = 0; it < niter; ++it) {
    const int st = it & 1, q0 = q0_of(it);
    // the next iteration's rows into the other buffer (last read in it - 1)
    if (it + 1 < niter) stage_rows(it + 1);
    mbar_wait(&bar_q[st], (it >> 1) & 1);
    const __nv_bfloat16* Qt = Qs + st * kT;
    const __nv_bfloat16* dOt = dOs + st * kT;

    float s[32], dp[32];   // S^T, dP^T: keys x queries
    wgmma_fence();
    ss_tile<D>(s, Ks, Qt);
    ss_tile<D>(dp, Vs, dOt);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s);
    reg_fence(dp);

    // s[4j + 2i + c]: key k0 + row0 + 8i, query q0 + 8j + 2(lane % 4) + c;
    // P^T into s, dS^T into dp.  Only a tile that cuts a bound is masked
    // (rows past Sq have lse = +inf: P = 0)
    const bool edge = tile_cuts(p, q0, k0);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int col = 8 * (e / 4) + 2 * (lane % 4) + e % 2, i = e / 2 % 2;
      float pe = exp2f(fmaf(s[e], scale_log2, -Ls[st][col]));
      if (edge)
        pe = q0 + col >= row_lo[i] && q0 + col < row_hi[i] ? pe : 0.f;
      s[e] = pe;
      dp[e] = pe * (dp[e] - Ds[st][col]);
    }
    uint32_t pa[4][4], pl[4][4], da[4][4], dl[4][4];
    to_frags<false>(s, pa, pl);
    to_frags<true>(dp, da, dl);

    // dV += P^T dO, dK += dS^T Q
    reg_fence(dka);
    reg_fence(dva);
    wgmma_fence();
    rs_tile<D, false>(dva, pa, pl, dOt);
    rs_tile<D, true>(dka, da, dl, Qt);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(dka);
    reg_fence(dva);
    __syncthreads();   // every warp is done with stage st and Ls/Ds[st]
    if (tid == 0 && it + 2 < niter) load_q(it + 2);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + row0 + 8 * i;
    if (key >= p.Skv) continue;
    const size_t at = ((size_t)(b * p.Skv + key) * p.Hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(dk + at + col) =
          __floats2bfloat162_rn(dka[4 * j + 2 * i] * p.scale,
                                dka[4 * j + 2 * i + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + col) =
          __floats2bfloat162_rn(dva[4 * j + 2 * i], dva[4 * j + 2 * i + 1]);
    }
  }
}

// Q and dO of the block's rows, then a ring of two (K, V) stages
template <int D>
constexpr size_t dq_smem() {
  return (size_t)(2 * kDQWG + 4) * tile_elems<D>() * 2 + 1024;
}

template <int D>
__global__ void __launch_bounds__(128 * kDQWG, 1)
dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const __grid_constant__ CUtensorMap tdo,
             __nv_bfloat16* __restrict__ dq, Params p) {
  constexpr int kT = tile_elems<D>();
  constexpr int BQ = kTile * kDQWG;     // query rows of the block
  extern __shared__ unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* dOs = Qs + kDQWG * kT;
  __nv_bfloat16* Ks = dOs + kDQWG * kT;   // [2 stages][tile]
  __nv_bfloat16* Vs = Ks + 2 * kT;        // [2 stages][tile]
  __shared__ __align__(8) uint64_t bar_kv[2];
  __shared__ __align__(8) uint64_t bar_q;

  const int tid = threadIdx.x, wg = tid / 128, warp = tid % 128 / 32,
            lane = tid % 32;
  // heaviest row blocks (latest under the causal mask) first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (p.Hq / p.Hkv);
  const float scale_log2 = p.scale * kLog2e;

  int lo, hi;
  key_range(p, q0, min(q0 + BQ, p.Sq) - 1, lo, hi);
  const int t_lo = lo / kTile;
  const int ntiles = hi > lo ? (hi + kTile - 1) / kTile - t_lo : 0;
  // this warpgroup's rows and key tiles
  const int wq0 = q0 + wg * kTile, wrows = min(kTile, p.Sq - wq0);
  int wlo = 0, whi = 0;
  if (wrows > 0) key_range(p, wq0, wq0 + wrows - 1, wlo, whi);
  const int w_tlo = wlo / kTile,
            w_thi = whi > wlo ? (whi + kTile - 1) / kTile : 0;

  auto load_kv = [&](int st, int t) {   // K and V tile t, by thread 0
    mbar_expect_tx(&bar_kv[st], 2u * kT * 2);
    tma_load_rows<D>(Ks + st * kT, &tk, &bar_kv[st], hk, t * kTile, b);
    tma_load_rows<D>(Vs + st * kT, &tv, &bar_kv[st], hk, t * kTile, b);
  };
  if (tid == 0) {
    mbar_init(&bar_kv[0], 1);
    mbar_init(&bar_kv[1], 1);
    mbar_init(&bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    const int nwg = min(kDQWG, (p.Sq - q0 + kTile - 1) / kTile);
    mbar_expect_tx(&bar_q, 2u * nwg * kT * 2);
    for (int w = 0; w < nwg; ++w) {
      tma_load_rows<D>(Qs + w * kT, &tq, &bar_q, h, q0 + w * kTile, b);
      tma_load_rows<D>(dOs + w * kT, &tdo, &bar_q, h, q0 + w * kTile, b);
    }
    for (int s = 0; s < 2 && s < ntiles; ++s) load_kv(s, t_lo + s);
  }

  float dqa[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
  // the thread's two rows: keys [row_lo, row_hi), lse (log2 units), delta
  const int row0 = wq0 + warp * 16 + lane / 4;
  int row_lo[2], row_hi[2];
  float L[2], Dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = row0 + 8 * i;
    key_range(p, qp, qp, row_lo[i], row_hi[i]);
    const size_t at = ((size_t)b * p.Hq + h) * p.Sq + qp;
    L[i] = qp < p.Sq ? p.lse[at] * kLog2e : __int_as_float(0x7f800000);
    Dl[i] = qp < p.Sq ? p.delta[at] : 0.f;
  }
  const __nv_bfloat16* Qw = Qs + wg * kT;
  const __nv_bfloat16* dOw = dOs + wg * kT;

  mbar_wait(&bar_q, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int t = t_lo + it, st = it & 1;
    mbar_wait(&bar_kv[st], (it >> 1) & 1);
    if (wrows > 0 && t >= w_tlo && t < w_thi) {   // warpgroup-uniform
      const __nv_bfloat16* Kt = Ks + st * kT;
      float s[32], dp[32];   // S, dP: rows x keys
      wgmma_fence();
      ss_tile<D>(s, Qw, Kt);
      ss_tile<D>(dp, dOw, Vs + st * kT);
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(s);
      reg_fence(dp);

      // s[4j + 2i + c]: row row0 + 8i, key t * 64 + 8j + 2(lane % 4) + c;
      // dS into dp.  Only a tile that cuts a bound of the warpgroup's rows
      // is masked
      const int k0 = t * kTile;
      const bool edge = tile_cuts(p, wq0, k0);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int kp = k0 + 8 * (e / 4) + 2 * (lane % 4) + e % 2;
        const int i = e / 2 % 2;
        float pe = exp2f(fmaf(s[e], scale_log2, -L[i]));
        if (edge) pe = kp >= row_lo[i] && kp < row_hi[i] ? pe : 0.f;
        dp[e] = pe * (dp[e] - Dl[i]);
      }
      uint32_t da[4][4], dl[4][4];
      to_frags<true>(dp, da, dl);

      // dQ += dS K
      reg_fence(dqa);
      wgmma_fence();
      rs_tile<D, true>(dqa, da, dl, Kt);
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(dqa);
    }
    __syncthreads();   // every warp is done with stage st
    if (tid == 0 && it + 2 < ntiles) load_kv(st, t + 2);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= p.Sq) continue;
    __nv_bfloat16* out = dq + ((size_t)(b * p.Sq + row) * p.Hq + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(out + col) = __floats2bfloat162_rn(
          dqa[4 * j + 2 * i] * p.scale, dqa[4 * j + 2 * i + 1] * p.scale);
    }
  }
}

// ---- head_dim 256: two warpgroups split D ----

constexpr int kWideD = 256;
constexpr int kHalf = kWideD / 2;        // columns a warpgroup owns
constexpr int kXch = 32 * 128;           // floats of a warpgroup's 64 x 64
                                         // tile in the exchange

// A thread's 32 values of a 64 x 64 accumulator tile into (or from) a
// warpgroup's slot of the exchange, as 8 float4 [i][t]: the 128 threads of
// a warpgroup write 2 KB of consecutive 16-byte words a step
__device__ __forceinline__ void put_tile(float* x, const float (&v)[32],
                                         int t) {
  float4* d = reinterpret_cast<float4*>(x);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    d[i * 128 + t] =
        make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

__device__ __forceinline__ void get_tile(const float* x, float (&v)[32],
                                         int t) {
  const float4* d = reinterpret_cast<const float4*>(x);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 w = d[i * 128 + t];
    v[4 * i] = w.x;
    v[4 * i + 1] = w.y;
    v[4 * i + 2] = w.z;
    v[4 * i + 3] = w.w;
  }
}

// Six 64 x 256 tiles (K, V and the (Q, dO) ring; or Q, dO and the (K, V)
// ring) and the two warpgroups' exchange slots
constexpr size_t wide_smem() {
  return (size_t)6 * tile_elems<kWideD>() * 2 + 2 * kXch * 4 + 1024;
}

__global__ void __launch_bounds__(256, 1)
dkdv_tc_wide_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, Params p) {
  constexpr int D = kWideD;
  constexpr int kT = tile_elems<D>();
  constexpr int kBox = Tiles<D>::kBox;
  extern __shared__ unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* Vs = Ks + kT;
  __nv_bfloat16* Qs = Vs + kT;          // [2 stages][tile]
  __nv_bfloat16* dOs = Qs + 2 * kT;     // [2 stages][tile]
  float* Xs = reinterpret_cast<float*>(dOs + 2 * kT);   // [2][kXch]
  __shared__ float Ls[2][kTile], Ds[2][kTile];   // lse (log2 units), delta
  __shared__ __align__(8) uint64_t bar_kv;
  __shared__ __align__(8) uint64_t bar_q[2];

  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128,
            warp = t / 32, lane = tid % 32;
  const int k0 = blockIdx.x * kTile, hk = blockIdx.y, b = blockIdx.z;
  const int G = p.Hq / p.Hkv;
  const float scale_log2 = p.scale * kLog2e;
  int q_lo, q_hi;
  query_range(p, k0, min(k0 + kTile, p.Skv) - 1, q_lo, q_hi);
  const int qt_lo = q_lo / kTile;
  const int nqt = q_hi > q_lo ? (q_hi + kTile - 1) / kTile - qt_lo : 0;
  const int niter = G * nqt;   // (query head, query tile) pairs

  auto q0_of = [&](int it) { return (qt_lo + it % nqt) * kTile; };
  auto h_of = [&](int it) { return hk * G + it / nqt; };
  auto stage_rows = [&](int it) {   // lse and delta of its rows
    if (tid < kTile) {
      const int r = q0_of(it) + tid;
      const size_t at = ((size_t)b * p.Hq + h_of(it)) * p.Sq + r;
      Ls[it & 1][tid] = r < p.Sq ? p.lse[at] * kLog2e
                                 : __int_as_float(0x7f800000);
      Ds[it & 1][tid] = r < p.Sq ? p.delta[at] : 0.f;
    }
  };
  auto load_q = [&](int it) {       // Q and dO of its rows, by thread 0
    const int st = it & 1;
    mbar_expect_tx(&bar_q[st], 2u * kT * 2);
    tma_load_rows<D>(Qs + st * kT, &tq, &bar_q[st], h_of(it), q0_of(it), b);
    tma_load_rows<D>(dOs + st * kT, &tdo, &bar_q[st], h_of(it), q0_of(it),
                     b);
  };

  if (tid == 0) {
    mbar_init(&bar_kv, 1);
    mbar_init(&bar_q[0], 1);
    mbar_init(&bar_q[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (niter > 0) stage_rows(0);
  __syncthreads();
  if (tid == 0 && niter > 0) {
    mbar_expect_tx(&bar_kv, 2u * kT * 2);
    tma_load_rows<D>(Ks, &tk, &bar_kv, hk, k0, b);
    tma_load_rows<D>(Vs, &tv, &bar_kv, hk, k0, b);
    for (int s = 0; s < 2 && s < niter; ++s) load_q(s);
  }

  // columns [wg * 128, wg * 128 + 128) of dK and dV
  float dka[kHalf / 2], dva[kHalf / 2];
#pragma unroll
  for (int i = 0; i < kHalf / 2; ++i) dka[i] = dva[i] = 0.f;
  const int row0 = warp * 16 + lane / 4;
  int row_lo[2], row_hi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kp = k0 + row0 + 8 * i;
    query_range(p, kp, kp, row_lo[i], row_hi[i]);
  }
  // this warpgroup's full-D product: S^T = K Q^T (0) or dP^T = V dO^T (1)
  const __nv_bfloat16* A = wg ? Vs : Ks;
  float* mine = Xs + wg * kXch;
  const float* theirs = Xs + (1 - wg) * kXch;

  if (niter > 0) mbar_wait(&bar_kv, 0);
  for (int it = 0; it < niter; ++it) {
    const int st = it & 1, q0 = q0_of(it);
    if (it + 1 < niter) stage_rows(it + 1);
    mbar_wait(&bar_q[st], (it >> 1) & 1);
    const __nv_bfloat16* Qt = Qs + st * kT;
    const __nv_bfloat16* dOt = dOs + st * kT;

    float x[32];   // keys x queries
    wgmma_fence();
    ss_tile<D>(x, A, wg ? dOt : Qt);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(x);
    // x[4j + 2i + c]: key k0 + row0 + 8i, query q0 + 8j + 2(lane % 4) + c
    if (wg == 0) {   // P^T; only a tile that cuts a bound is masked
      const bool edge = tile_cuts(p, q0, k0);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int col = 8 * (e / 4) + 2 * (lane % 4) + e % 2, i = e / 2 % 2;
        float pe = exp2f(fmaf(x[e], scale_log2, -Ls[st][col]));
        if (edge)
          pe = q0 + col >= row_lo[i] && q0 + col < row_hi[i] ? pe : 0.f;
        x[e] = pe;
      }
    }
    put_tile(mine, x, t);
    __syncthreads();   // both tiles in the exchange
    float y[32];
    get_tile(theirs, y, t);
    // P^T into x, dS^T into y, the same operations in both warpgroups
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int col = 8 * (e / 4) + 2 * (lane % 4) + e % 2;
      const float pe = wg ? y[e] : x[e], dpe = wg ? x[e] : y[e];
      x[e] = pe;
      y[e] = pe * (dpe - Ds[st][col]);
    }
    uint32_t pa[4][4], pl[4][4], da[4][4], dl[4][4];
    to_frags<false>(x, pa, pl);
    to_frags<true>(y, da, dl);

    // the half's dV += P^T dO and dK += dS^T Q (two boxes from wg * 128)
    reg_fence(dka);
    reg_fence(dva);
    wgmma_fence();
    rs_tile<kHalf, false>(dva, pa, pl, dOt + wg * 2 * kBox);
    rs_tile<kHalf, true>(dka, da, dl, Qt + wg * 2 * kBox);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(dka);
    reg_fence(dva);
    __syncthreads();   // stage st, Ls/Ds[st] and the exchange are free
    if (tid == 0 && it + 2 < niter) load_q(it + 2);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + row0 + 8 * i;
    if (key >= p.Skv) continue;
    const size_t at = ((size_t)(b * p.Skv + key) * p.Hkv + hk) * D +
                      wg * kHalf;
#pragma unroll
    for (int j = 0; j < kHalf / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(dk + at + col) =
          __floats2bfloat162_rn(dka[4 * j + 2 * i] * p.scale,
                                dka[4 * j + 2 * i + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + col) =
          __floats2bfloat162_rn(dva[4 * j + 2 * i], dva[4 * j + 2 * i + 1]);
    }
  }
}

__global__ void __launch_bounds__(256, 1)
dq_tc_wide_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo,
                  __nv_bfloat16* __restrict__ dq, Params p) {
  constexpr int D = kWideD;
  constexpr int kT = tile_elems<D>();
  constexpr int kBox = Tiles<D>::kBox;
  extern __shared__ unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* dOs = Qs + kT;
  __nv_bfloat16* Ks = dOs + kT;           // [2 stages][tile]
  __nv_bfloat16* Vs = Ks + 2 * kT;        // [2 stages][tile]
  float* Xs = reinterpret_cast<float*>(Vs + 2 * kT);   // [2][kXch]
  __shared__ __align__(8) uint64_t bar_kv[2];
  __shared__ __align__(8) uint64_t bar_q;

  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128,
            warp = t / 32, lane = tid % 32;
  // heaviest row blocks (latest under the causal mask) first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (p.Hq / p.Hkv);
  const float scale_log2 = p.scale * kLog2e;

  int lo, hi;
  key_range(p, q0, min(q0 + kTile, p.Sq) - 1, lo, hi);
  const int t_lo = lo / kTile;
  const int ntiles = hi > lo ? (hi + kTile - 1) / kTile - t_lo : 0;

  auto load_kv = [&](int st, int tile) {   // K and V tile, by thread 0
    mbar_expect_tx(&bar_kv[st], 2u * kT * 2);
    tma_load_rows<D>(Ks + st * kT, &tk, &bar_kv[st], hk, tile * kTile, b);
    tma_load_rows<D>(Vs + st * kT, &tv, &bar_kv[st], hk, tile * kTile, b);
  };
  if (tid == 0) {
    mbar_init(&bar_kv[0], 1);
    mbar_init(&bar_kv[1], 1);
    mbar_init(&bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar_q, 2u * kT * 2);
    tma_load_rows<D>(Qs, &tq, &bar_q, h, q0, b);
    tma_load_rows<D>(dOs, &tdo, &bar_q, h, q0, b);
    for (int s = 0; s < 2 && s < ntiles; ++s) load_kv(s, t_lo + s);
  }

  // columns [wg * 128, wg * 128 + 128) of dQ
  float dqa[kHalf / 2];
#pragma unroll
  for (int i = 0; i < kHalf / 2; ++i) dqa[i] = 0.f;
  // the thread's two rows: keys [row_lo, row_hi), lse (log2 units), delta
  const int row0 = q0 + warp * 16 + lane / 4;
  int row_lo[2], row_hi[2];
  float L[2], Dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = row0 + 8 * i;
    key_range(p, qp, qp, row_lo[i], row_hi[i]);
    const size_t at = ((size_t)b * p.Hq + h) * p.Sq + qp;
    L[i] = qp < p.Sq ? p.lse[at] * kLog2e : __int_as_float(0x7f800000);
    Dl[i] = qp < p.Sq ? p.delta[at] : 0.f;
  }
  // this warpgroup's full-D product: S = Q K^T (0) or dP = dO V^T (1)
  const __nv_bfloat16* A = wg ? dOs : Qs;
  float* mine = Xs + wg * kXch;
  const float* theirs = Xs + (1 - wg) * kXch;

  mbar_wait(&bar_q, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int tile = t_lo + it, st = it & 1;
    mbar_wait(&bar_kv[st], (it >> 1) & 1);
    const __nv_bfloat16* Kt = Ks + st * kT;
    float x[32];   // rows x keys
    wgmma_fence();
    ss_tile<D>(x, A, wg ? Vs + st * kT : Kt);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(x);
    // x[4j + 2i + c]: row row0 + 8i, key tile * 64 + 8j + 2(lane % 4) + c
    const int k0 = tile * kTile;
    if (wg == 0) {   // P; only a tile that cuts a bound is masked
      const bool edge = tile_cuts(p, q0, k0);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int kp = k0 + 8 * (e / 4) + 2 * (lane % 4) + e % 2;
        const int i = e / 2 % 2;
        float pe = exp2f(fmaf(x[e], scale_log2, -L[i]));
        if (edge) pe = kp >= row_lo[i] && kp < row_hi[i] ? pe : 0.f;
        x[e] = pe;
      }
    }
    put_tile(mine, x, t);
    __syncthreads();   // both tiles in the exchange
    float y[32];
    get_tile(theirs, y, t);
#pragma unroll
    for (int e = 0; e < 32; ++e) {   // dS, the same operations in both
      const float pe = wg ? y[e] : x[e], dpe = wg ? x[e] : y[e];
      y[e] = pe * (dpe - Dl[e / 2 % 2]);
    }
    uint32_t da[4][4], dl[4][4];
    to_frags<true>(y, da, dl);

    // the half's dQ += dS K (two boxes from wg * 128)
    reg_fence(dqa);
    wgmma_fence();
    rs_tile<kHalf, true>(dqa, da, dl, Kt + wg * 2 * kBox);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(dqa);
    __syncthreads();   // stage st and the exchange are free
    if (tid == 0 && it + 2 < ntiles) load_kv(st, tile + 2);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= p.Sq) continue;
    __nv_bfloat16* out =
        dq + ((size_t)(b * p.Sq + row) * p.Hq + h) * D + wg * kHalf;
#pragma unroll
    for (int j = 0; j < kHalf / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(out + col) = __floats2bfloat162_rn(
          dqa[4 * j + 2 * i] * p.scale, dqa[4 * j + 2 * i + 1] * p.scale);
    }
  }
}

// ---- host side ----

struct Maps {
  CUtensorMap q, k, v, dout;
};

template <int D>
cudaError_t launch(const Maps& m, void* dq, void* dk, void* dv, int B,
                   const Params& p, cudaStream_t s, void* marks) {
  cudaError_t e;
  if ((e = allow_smem<dkdv_tc_kernel<D>>(dkdv_smem<D>())) !=
          cudaSuccess ||
      (e = allow_smem<dq_tc_kernel<D>>(dq_smem<D>())) != cudaSuccess)
    return e;
  const dim3 gk((p.Skv + kTile - 1) / kTile, p.Hkv, B);
  dkdv_tc_kernel<D><<<gk, 128, dkdv_smem<D>(), s>>>(
      m.q, m.k, m.v, m.dout, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  mark(marks, 2, s);
  const dim3 gq((p.Sq + kTile * kDQWG - 1) / (kTile * kDQWG), p.Hq, B);
  dq_tc_kernel<D><<<gq, 128 * kDQWG, dq_smem<D>(), s>>>(
      m.q, m.k, m.v, m.dout, static_cast<__nv_bfloat16*>(dq), p);
  mark(marks, 3, s);
  return cudaGetLastError();
}

cudaError_t launch_wide(const Maps& m, void* dq, void* dk, void* dv, int B,
                        const Params& p, cudaStream_t s, void* marks) {
  cudaError_t e;
  if ((e = allow_smem<dkdv_tc_wide_kernel>(wide_smem())) != cudaSuccess ||
      (e = allow_smem<dq_tc_wide_kernel>(wide_smem())) != cudaSuccess)
    return e;
  const dim3 gk((p.Skv + kTile - 1) / kTile, p.Hkv, B);
  dkdv_tc_wide_kernel<<<gk, 256, wide_smem(), s>>>(
      m.q, m.k, m.v, m.dout, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  mark(marks, 2, s);
  const dim3 gq((p.Sq + kTile - 1) / kTile, p.Hq, B);
  dq_tc_wide_kernel<<<gq, 256, wide_smem(), s>>>(
      m.q, m.k, m.v, m.dout, static_cast<__nv_bfloat16*>(dq), p);
  mark(marks, 3, s);
  return cudaGetLastError();
}

}  // namespace

// The arguments of flash_attention_bwd (csrc/flash_attention_bwd.cu).
// q, o, o_lo, dout,
// dq (B, Sq, Hq, D); k, v, dk, dv (B, Skv, Hkv, D): bf16 (dtype must be
// kBFloat16), contiguous, 16-byte aligned; o_lo: the forward's rounding
// residual of O, or null; lse (B, Hq, Sq) fp32 from the
// forward; delta: fp32 scratch (B, Hq, Sq).  D in {64, 96, 128, 256};
// window 0 for none; marks: null, or four cudaEvent_t recorded before the
// delta launch, after it, after dK/dV and after dQ.  Returns the first CUDA
// error of the three launches (0 on success; cudaErrorInvalidValue for
// another dtype or D, or a tensor map the driver refuses).
extern "C" int flash_bwd_tc(const void* q, const void* k, const void* v,
                            const void* o, const void* o_lo,
                            const void* lse, const void* dout,
                            void* dq, void* dk, void* dv, void* delta,
                            int dtype, int B, int Sq, int Skv, int Hq,
                            int Hkv, int D, int causal, int window,
                            int chunk, float scale, void* stream,
                            void* marks) {
  if (dtype != kBFloat16) return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || Skv == 0) return 0;
  Maps m;
  if (!make_map(&m.q, q, B, Sq, Hq, D) || !make_map(&m.k, k, B, Skv, Hkv, D) ||
      !make_map(&m.v, v, B, Skv, Hkv, D) ||
      !make_map(&m.dout, dout, B, Sq, Hq, D))
    return cudaErrorInvalidValue;
  const Params p{static_cast<const float*>(lse),
                 static_cast<const float*>(delta), Sq, Skv, Hq, Hkv, causal,
                 chunk, scale, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mark(marks, 0, s);
  cudaError_t e = launch_delta<__nv_bfloat16>(
      o, o_lo, dout, static_cast<float*>(delta), B, Sq, Hq, D, s);
  if (e != cudaSuccess) return e;
  mark(marks, 1, s);
  switch (D) {
    case 64:
      return launch<64>(m, dq, dk, dv, B, p, s, marks);
    case 96:
      return launch<96>(m, dq, dk, dv, B, p, s, marks);
    case 128:
      return launch<128>(m, dq, dk, dv, B, p, s, marks);
    case kWideD:
      return launch_wide(m, dq, dk, dv, B, p, s, marks);
    default:
      return cudaErrorInvalidValue;
  }
}

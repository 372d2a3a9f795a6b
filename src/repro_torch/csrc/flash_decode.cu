// Flash attention forward, decode, two kernels (sm_90a; fp32 or bf16;
// head_dim 16, 32, 64, 96, 128 or 256; at most 8 query rows): the split
// kernel, a split over the keys then a merge, for many query rows per kv
// head (G * Sq > 8); and the warp kernel, for few (see "Warp decode"
// below).  The wrapper's plan (ops.plan) picks one by G * Sq.
//
// Replaces, for queries of at most 8 rows, the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py:78 (flash_attention_kernel,
// body _attn_kernel).  Same function as csrc/flash_attention.cu: scale
// 1/sqrt(D); GQA maps query head h to kv head h / G; causal, sliding window
// and chunk masks, kv_len, q_offset and the optional int32 key positions
// kpos (Skv,) of a rolling cache (a negative position is masked); a masked
// score is -2^30; m, l and acc are fp32; the output is acc / max(l, 1e-30)
// in the input type.
//
// Bound: bytes.  One query row (per head) against the K/V cache: ~1 flop per
// byte read, far below the H100's ~295 flop/byte (bf16), so the products
// stay on the fp32 cores and the design is about reading each byte of the
// cache once and keeping all 132 SMs reading:
// - one block per (key split, kv head and 16 of its G * Sq query rows,
//   batch): the rows of the block's score tile are the G query heads of the
//   kv head times Sq, so each K/V tile is read once for all of them, not G
//   times (chatglm3-6b: G 16, Sq 1: 16 rows; recurrentgemma-2b: 10; at G 1
//   a block would score and multiply 16 rows for one: the warp kernel
//   takes such calls);
// - the split count and split size (whole 64-key tiles) are chosen by the
//   wrapper (ops.plan) so that the grid holds >= 2 x 132 blocks: chatglm3-6b
//   decode 17 splits of one tile (272 blocks), recurrentgemma-2b's rolling
//   decode 64 (512);
// - a tile no query of the block can see is skipped before its K/V are
//   read: without kpos by the causal, window and chunk bounds of the query
//   positions; with kpos the block first reads the tile's 64 positions and
//   skips it unless one is >= 0 and visible to one of its queries (the
//   rolling decode then reads the ~2048 slots of its window, not 4096);
// - K/V tiles go to shared memory by 16-byte cp.async copies, all of a tile
//   in flight at once, K and V as two groups: the score pass waits for K
//   only, and V arrives under it; the next visible tile's copies are issued
//   before the current one is used where a split has several tiles (a
//   two-stage ring where two stages of K and V fit in 64 KB: bf16 up to D
//   128, fp32 up to 64; a split of one tile takes one stage, so more blocks
//   fit on an SM); rows are stored with their 16-byte chunks XOR-swizzled
//   by the row, so neither the score pass (lanes on consecutive keys) nor
//   the P.V pass (a thread 8 columns) has bank conflicts (a bf16 row of D
//   96 is 12 chunks: Layout::kSwzShift);
// - 256 threads a block: warp w scores rows 2w and 2w + 1 against the
//   tile's 64 keys (a lane two keys) and runs their online softmax on
//   those registers (the row max and sum are warp reductions); a thread
//   then accumulates 8 output columns of 1 or 2 rows, reading P four keys
//   at a time; the masks are two bounds per row, computed once (no
//   division per element).  Q is loaded with 16-byte loads, all in flight
//   with the key positions and the first tile's copies;
// - each split writes its partial (m, l, acc) in fp32 to scratch the
//   wrapper allocates; a second kernel, one block per (query head, batch),
//   merges the splits in a fixed order with the log-sum-exp rule (no
//   atomics: deterministic).
// Registers and spills (nvcc -Xptxas -v, sm_90a), split kernel: bf16 D 128
// 77 registers (64 with kpos, 8 bytes spilled), D 256 80 (122 with kpos);
// fp32 D 128 80 (108), D 256 128 (174); spills otherwise only at D 256
// without kpos (56 bytes bf16, 40 fp32; on no served path); D 96: bf16 69
// (80 with kpos), fp32 64 (64), no spills; merge kernel 40.
//
// Warp decode.  Bound: bytes, and at few rows the split kernel's 16-row
// tiles are mostly padding (phi-3-vision-4.2b, MHA: its time followed the
// 16 rows' score and P.V work, 22% of its bound).  So the rows come from
// the keys instead:
// - one block per (key split, kv head and up to 8 of its G * Sq query
//   rows, batch) holds all of the kv head's rows, so each K/V byte is read
//   once for all of them;
// - warp w takes keys [w 64 / warps, (w + 1) 64 / warps) of each tile the
//   split can see (the split kernel's skipping rule, so a rolling decode
//   still reads only its window); a key's row is held by a lane group (8
//   columns a lane: one 16-byte word of bf16, two of fp32; D 96 uses 12 of
//   16 lanes), the group's dot products reduced by shuffles, and each lane
//   group loads 64 bytes of K and of V a step with all of them in flight;
// - each warp keeps its own online softmax per row in registers, in base
//   2 (the scale carries log2 e, so the exponentials are exp2), and its
//   lanes accumulate P.V into their own columns; at the end the warps'
//   (m, l, acc) go through shared memory and are merged in warp order by
//   the log-sum-exp rule (no atomics: deterministic);
// - one split (the plan's choice when the grid already holds 256 blocks)
//   writes o itself: no scratch and no merge launch; more splits write the
//   partials for the merge kernel above;
// - two row caps, so that the MHA decode does not pay for 8 rows of
//   registers: up to 2 rows with 8 warps a block, up to 8 with 4.
// Registers and spills (nvcc -Xptxas -v, sm_90a), warp kernel, up to 2 /
// up to 8 rows: bf16 D 96 122 / 196 (125 / 198 with kpos), D 128 121 /
// 194, D 256 121 / 194, D 64 80 / 192, D 16-32 60-64 / 128-156; fp32 D
// 96-256 88-91 / 152-156, D 16-64 61-80 / 128-154; spills only at D 16
// with kpos and 8 rows (4 bytes, on no served path).
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWRows = 2;         // rows a warp scores (kRows / kWarps)
constexpr int kBKV = 64;          // keys per tile
constexpr int kRows = 16;         // query rows of a block (G * Sq, grouped)
constexpr int kPS = kBKV + 4;     // row stride of P: float4 reads, and
                                  // the P.V pass's rows on other banks
static_assert(kRows == kWRows * kWarps, "a warp scores kWRows rows");
constexpr float kNegInf = -1073741824.f;   // -2^30, as the reference

struct Params {
  const int* kpos;     // (Skv,) key positions, or nullptr: slot j at j
  float* part_ml;      // (B, Hq, Sq, splits, 2): m, l of each split
  float* part_acc;     // (B, Hq, Sq, splits, D): unnormalised acc
  int Sq, Skv, Hq, Hkv, G;
  int causal, window, chunk, q_offset, kv_len;
  int splits, tiles_per_split;
  float scale;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  // src-size 0 fills the 16 bytes with zeros (slots beyond kv_len)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// wait until at most n (0-3) copy groups are pending
__device__ __forceinline__ void cp_async_wait_n(int n) {
  if (n >= 3)
    cp_async_wait<3>();
  else if (n == 2)
    cp_async_wait<2>();
  else if (n == 1)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// 8 consecutive elements as fp32 (one 16-byte chunk of bf16, two of fp32)
__device__ __forceinline__ void load8(const float* src0, const float* src1,
                                      float (&out)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(src0);
  const float4 b = *reinterpret_cast<const float4*>(src1);
  out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
  out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* src0,
                                      const __nv_bfloat16*, float (&out)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src0);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(e[i]);
}

template <typename T, int D>
struct Layout {
  static constexpr int kVec = 16 / sizeof(T);     // elements of a chunk
  static constexpr int kChunks = D / kVec;        // 16-byte chunks of a row
  // chunk c of row j is stored at c ^ ((j >> kSwzShift) & kSwz): the XOR
  // stays inside c's aligned group of kSwz + 1 chunks, the largest power
  // of two (at most 8) that divides the row.  A row of 12 chunks (bf16 D
  // 96, 192 bytes) puts rows j and j + 1 four chunks apart on the banks,
  // so the XOR takes j / 2 there: eight consecutive rows then cover all 8
  // bank groups of a 16-byte column
  static constexpr int kSwz = (kChunks % 8 == 0   ? 8
                               : kChunks % 4 == 0 ? 4
                               : kChunks % 2 == 0 ? 2
                                                  : 1) -
                              1;
  static constexpr int kSwzShift = kChunks > 4 && kChunks % 8 == 4 ? 1 : 0;
  static constexpr int kStages =
      2 * 2 * kBKV * D * (int)sizeof(T) <= 65536 ? 2 : 1;
  static constexpr int kCols = D / 8;             // P.V: 8 columns a thread
  // (D 96: 12 column groups, 21 row groups; the last 4 threads idle)
  static constexpr int kRowGroups = kThreads / kCols;
  static constexpr int kRPT = (kRows + kRowGroups - 1) / kRowGroups;
  // shared memory with ``stages`` K/V stages
  static constexpr size_t smem(int stages) {
    return (size_t)kRows * D * 4 + 2 * (size_t)stages * kBKV * D * sizeof(T) +
           (size_t)kRows * kPS * 4 + kRows * 4;
  }
};

// A split of one tile needs one stage: its blocks then take less shared
// memory and more of them fit on an SM.
template <typename T, int D>
__host__ __device__ __forceinline__ int stages_of(int tiles_per_split) {
  return tiles_per_split > 1 ? Layout<T, D>::kStages : 1;
}

// element offset of chunk c of row j in a swizzled [64][D] tile
template <typename T, int D>
__device__ __forceinline__ int swz(int j, int c) {
  using L = Layout<T, D>;
  return j * D + (c ^ ((j >> L::kSwzShift) & L::kSwz)) * L::kVec;
}

template <typename T, int D, bool kPos>
__global__ void __launch_bounds__(kThreads)
flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, Params p) {
  using L = Layout<T, D>;
  const int stages = stages_of<T, D>(p.tiles_per_split);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);          // [kRows][D]
  T* Ks = reinterpret_cast<T*>(Qs + kRows * D);            // [stages][64][D]
  T* Vs = Ks + stages * kBKV * D;                          // [stages][64][D]
  float* Ps = reinterpret_cast<float*>(Vs + stages * kBKV * D);
  float* Corr = Ps + kRows * kPS;                          // [kRows]
  __shared__ int Kp[L::kStages][kBKV];   // the tiles' key positions

  const int tid = threadIdx.x, split = blockIdx.x, b = blockIdx.z;
  const int groups = (p.G * p.Sq + kRows - 1) / kRows;
  const int hk = blockIdx.y / groups, r_base = blockIdx.y % groups * kRows;
  const int rows = min(kRows, p.G * p.Sq - r_base);
  // block row r is query i = (r_base + r) % Sq of head hk*G + (r_base+r)/Sq

  // slots a query at a position in [q_first, q_last] can see (each bound
  // on its own: a superset)
  const int q_first = p.q_offset, q_last = p.q_offset + p.Sq - 1;
  int lo = 0, hi = p.kv_len;
  if (p.causal) hi = min(hi, q_last + 1);
  if (p.window) lo = max(lo, q_first - p.window + 1);
  if (p.chunk) {
    lo = max(lo, q_first / p.chunk * p.chunk);
    hi = min(hi, (q_last / p.chunk + 1) * p.chunk);
  }
  const int t0 = split * p.tiles_per_split;
  const int t1 = min(t0 + p.tiles_per_split, (p.kv_len + kBKV - 1) / kBKV);

  // Is tile t visible to some query of the block?  Block-uniform; with kpos
  // it stages the tile's positions in Kp[st].
  auto visible = [&](int t, int st) -> bool {
    const int s0 = t * kBKV;
    if constexpr (!kPos) return s0 < hi && s0 + kBKV > lo;
    bool any = false;
    if (tid < kBKV) {
      const int slot = s0 + tid;
      const int kp = slot < p.kv_len ? p.kpos[slot] : -1;
      Kp[st][tid] = kp;
      any = kp >= 0 && (!p.causal || kp <= q_last) &&
            (!p.window || kp > q_first - p.window) &&
            (!p.chunk || (kp / p.chunk >= q_first / p.chunk &&
                          kp / p.chunk <= q_last / p.chunk));
    }
    return __syncthreads_or(any);
  };
  auto next_visible = [&](int t, int st) {
    while (t < t1 && !visible(t, st)) ++t;
    return t;
  };
  // K and V of tile t into stage st, as two copy groups (K first: the
  // score pass waits for K only)
  auto issue = [&](int t, int st) {
    constexpr int kChunksAll = kBKV * L::kChunks;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const T* src = half ? v : k;
      T* dst = (half ? Vs : Ks) + st * kBKV * D;
#pragma unroll
      for (int it = 0; it < (kChunksAll + kThreads - 1) / kThreads; ++it) {
        const int idx = tid + it * kThreads;
        if (kChunksAll % kThreads && idx >= kChunksAll) break;
        const int j = idx / L::kChunks, c = idx % L::kChunks;
        const int slot = t * kBKV + j;
        const bool ok = slot < p.kv_len;
        const size_t off =
            ((size_t)(b * p.Skv + (ok ? slot : 0)) * p.Hkv + hk) * D +
            c * L::kVec;
        cp_async16(dst + swz<T, D>(j, c), src + off, ok);
      }
      cp_async_commit();
    }
  };

  const int warp = tid / 32, lane = tid % 32;
  float m[kWRows], l[kWRows];   // warp w's rows kWRows * w + i
#pragma unroll
  for (int i = 0; i < kWRows; ++i) m[i] = kNegInf, l[i] = 0.f;
  const int cc = tid % L::kCols, rg = tid / L::kCols;   // P.V mapping
  float acc[L::kRPT][8];
#pragma unroll
  for (int i = 0; i < L::kRPT; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;

  // the keys [row_lo, row_hi) that the score pass's rows r0 .. r0 + 3
  // admit: the masks as two bounds (a chunk test kp / chunk == qp / chunk
  // is chunk_start <= kp < chunk_start + chunk for non-negative positions;
  // without kpos the slot is the position and kv_len caps it, with kpos an
  // unwritten slot is at -1, below every row_lo)
  const int r0 = warp * kWRows;
  int row_lo[kWRows], row_hi[kWRows];
#pragma unroll
  for (int r = 0; r < kWRows; ++r) {
    const int qp = p.q_offset + (r_base + r0 + r) % p.Sq;
    row_lo[r] = 0;
    row_hi[r] = kPos ? INT_MAX : p.kv_len;
    if (p.causal) row_hi[r] = min(row_hi[r], qp + 1);
    if (p.window) row_lo[r] = max(row_lo[r], qp - p.window + 1);
    if (p.chunk) {
      row_lo[r] = max(row_lo[r], qp / p.chunk * p.chunk);
      row_hi[r] = min(row_hi[r], qp / p.chunk * p.chunk + p.chunk);
    }
  }

  // Q: 16-byte loads into registers first (all in flight together, and
  // under the key-position check and the first tile's copies), then to
  // shared memory as fp32
  constexpr int kQChunks = kRows * L::kChunks;
  constexpr int kQLoads = (kQChunks + kThreads - 1) / kThreads;
  uint4 qraw[kQLoads];
#pragma unroll
  for (int it = 0; it < kQLoads; ++it) {
    const int idx = tid + it * kThreads, r = idx / L::kChunks;
    const int gr = r_base + r;
    qraw[it] = make_uint4(0, 0, 0, 0);
    if (idx < kQChunks && r < rows)
      qraw[it] = *reinterpret_cast<const uint4*>(
          q + ((size_t)(b * p.Sq + gr % p.Sq) * p.Hq + hk * p.G + gr / p.Sq) *
                  D + idx % L::kChunks * L::kVec);
  }
  int st = 0;
  int cur = next_visible(t0, 0);
  if (cur < t1) issue(cur, 0);
#pragma unroll
  for (int it = 0; it < kQLoads; ++it) {
    const int idx = tid + it * kThreads;
    if (idx >= kQChunks) break;
    const T* e = reinterpret_cast<const T*>(&qraw[it]);
#pragma unroll
    for (int x = 0; x < L::kVec; ++x) Qs[idx * L::kVec + x] = to_f32(e[x]);
  }
  while (cur < t1) {
    int nxt = t1;
    if (stages == 2) {
      nxt = next_visible(cur + 1, st ^ 1);
      if (nxt < t1) issue(nxt, st ^ 1);
    }
    // groups in flight: K, V of this tile, then K, V of the next if issued
    const int later = stages == 2 && nxt < t1 ? 2 : 0;
    cp_async_wait_n(later + 1);   // this tile's K
    __syncthreads();
    const T* Kt = Ks + st * kBKV * D;
    const T* Vt = Vs + st * kBKV * D;

    // scores and online softmax: warp w scores its rows r0, r0 + 1 against
    // the tile, a lane keys lane and lane + 32, so the row max and sum are
    // warp reductions over registers
    {
      float s[kWRows][2];
#pragma unroll
      for (int r = 0; r < kWRows; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 4
      for (int c8 = 0; c8 < D / 8; ++c8) {
        float kf[2][8];
        const int c = c8 * 8 / L::kVec;   // first chunk of the 8 elements
#pragma unroll
        for (int h = 0; h < 2; ++h)
          load8(Kt + swz<T, D>(lane + 32 * h, c),
                Kt + swz<T, D>(lane + 32 * h, c + 1), kf[h]);
#pragma unroll
        for (int r = 0; r < kWRows; ++r) {
          float qf[8];
          load8(Qs + (r0 + r) * D + c8 * 8, Qs + (r0 + r) * D + c8 * 8 + 4,
                qf);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            s[r][0] = fmaf(qf[e], kf[0][e], s[r][0]);
            s[r][1] = fmaf(qf[e], kf[1][e], s[r][1]);
          }
        }
      }
      int kp[2];   // the keys' positions (-1: unwritten)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        kp[h] = kPos ? Kp[st][lane + 32 * h] : cur * kBKV + lane + 32 * h;
#pragma unroll
      for (int r = 0; r < kWRows; ++r) {
        float x[2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          x[h] = kp[h] >= row_lo[r] && kp[h] < row_hi[r] ? s[r][h] * p.scale
                                                          : kNegInf;
        const float m_new = fmaxf(m[r], warp_max(fmaxf(x[0], x[1])));
        const float corr = expf(m[r] - m_new);
        x[0] = expf(x[0] - m_new);
        x[1] = expf(x[1] - m_new);
        Ps[(r0 + r) * kPS + lane] = x[0];
        Ps[(r0 + r) * kPS + lane + 32] = x[1];
        l[r] = l[r] * corr + warp_sum(x[0] + x[1]);
        m[r] = m_new;
        if (lane == 0) Corr[r0 + r] = corr;
      }
    }
    cp_async_wait_n(later);   // this tile's V
    __syncthreads();

    // acc = acc * corr + P V: thread (rows rg + kRowGroups * i, columns
    // 8 cc .. 8 cc + 7)
#pragma unroll
    for (int i = 0; i < L::kRPT; ++i) {
      const int r = rg + L::kRowGroups * i;
      const float corr = r < kRows ? Corr[r] : 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] *= corr;
    }
    {
      const int c = cc * 8 / L::kVec;
#pragma unroll 2
      for (int j4 = 0; j4 < kBKV; j4 += 4) {
        float4 pj[L::kRPT];
#pragma unroll
        for (int i = 0; i < L::kRPT; ++i) {
          const int r = rg + L::kRowGroups * i;
          pj[i] = r < kRows
                      ? *reinterpret_cast<const float4*>(Ps + r * kPS + j4)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float vf[8];
          load8(Vt + swz<T, D>(j4 + u, c), Vt + swz<T, D>(j4 + u, c + 1), vf);
#pragma unroll
          for (int i = 0; i < L::kRPT; ++i) {
            const float pu = u == 0   ? pj[i].x
                             : u == 1 ? pj[i].y
                             : u == 2 ? pj[i].z
                                      : pj[i].w;
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[i][e] = fmaf(pu, vf[e], acc[i][e]);
          }
        }
      }
    }
    __syncthreads();   // stage st, Ps and Corr are free again
    if (stages == 1) {
      nxt = next_visible(cur + 1, 0);
      if (nxt < t1) issue(nxt, 0);
    }
    cur = nxt;
    if (stages == 2) st ^= 1;
  }

  // partials of this split: (m, l) from the softmax warps, acc from the P.V
  // threads; a split that saw no tile writes m = -2^30, l = 0, acc = 0
  auto part = [&](int r) {
    const int gr = r_base + r;
    return ((size_t)(b * p.Hq + hk * p.G + gr / p.Sq) * p.Sq + gr % p.Sq) *
               p.splits + split;
  };
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kWRows; ++i) {
      const int r = r0 + i;
      if (r < rows) {
        p.part_ml[2 * part(r)] = m[i];
        p.part_ml[2 * part(r) + 1] = l[i];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < L::kRPT; ++i) {
    const int r = rg + L::kRowGroups * i;
    if (r < rows) {
      float4* dst =
          reinterpret_cast<float4*>(p.part_acc + part(r) * D + cc * 8);
      dst[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      dst[1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
}

// One block per (query head, batch): for each of its Sq rows, out =
// sum_s acc_s w_s / max(sum_s l_s w_s, 1e-30) with w_s = exp(m_s - max m),
// the splits taken in order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_decode_merge_kernel(const float* __restrict__ part_ml,
                          const float* __restrict__ part_acc,
                          T* __restrict__ o, int Sq, int Hq, int D,
                          int splits) {
  extern __shared__ float w[];   // [splits]
  __shared__ float red[kThreads / 32];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  for (int i = 0; i < Sq; ++i) {
    const size_t base = ((size_t)(b * Hq + h) * Sq + i) * splits;
    float mx = kNegInf;
    for (int s = tid; s < splits; s += kThreads)
      mx = fmaxf(mx, part_ml[2 * (base + s)]);
    mx = warp_max(mx);
    if (lane == 0) red[warp] = mx;
    __syncthreads();
    mx = red[0];
#pragma unroll
    for (int x = 1; x < kThreads / 32; ++x) mx = fmaxf(mx, red[x]);
    __syncthreads();
    float lsum = 0.f;
    for (int s = tid; s < splits; s += kThreads) {
      const float ws = expf(part_ml[2 * (base + s)] - mx);
      w[s] = ws;
      lsum += part_ml[2 * (base + s) + 1] * ws;
    }
    lsum = warp_sum(lsum);
    if (lane == 0) red[warp] = lsum;
    __syncthreads();   // w and red complete
    lsum = 0.f;
#pragma unroll
    for (int x = 0; x < kThreads / 32; ++x) lsum += red[x];
    const float denom = fmaxf(lsum, 1e-30f);
    for (int d = tid; d < D; d += kThreads) {
      const float* src = part_acc + base * D + d;
      float a = 0.f;
      int s = 0;
      for (; s + 8 <= splits; s += 8) {   // 8 loads in flight, summed in order
        float x[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) x[u] = src[(size_t)(s + u) * D];
#pragma unroll
        for (int u = 0; u < 8; ++u) a = fmaf(x[u], w[s + u], a);
      }
      for (; s < splits; ++s) a = fmaf(src[(size_t)s * D], w[s], a);
      o[((size_t)(b * Sq + i) * Hq + h) * D + d] = from_f32<T>(a / denom);
    }
    __syncthreads();   // before the next row rewrites w and red
  }
}

// ---- warp decode: few query rows per kv head ----

constexpr int kWDRows = 8;        // query rows (G * Sq) of a block, at most
constexpr float kLog2e = 1.4426950408889634f;

// The block's shape by its row cap: kWarps warps (warp w takes keys
// [w kKeys, (w + 1) kKeys) of each tile) and kLoadBytes of K a lane loads
// a step (V as many).  Two caps: 2 rows (MHA decode: 8 warps of ~120
// registers, two blocks an SM) and kWDRows (4 warps: the acc of 8 rows
// takes ~200 registers).
template <int kR>
struct WarpBlock;
template <>
struct WarpBlock<2> {
  static constexpr int kWarps = 8, kLoadBytes = 64;
};
template <>
struct WarpBlock<kWDRows> {
  static constexpr int kWarps = 4, kLoadBytes = 64;
};

// A lane holds 8 columns of a key's row (one 16-byte word of bf16, two of
// fp32); kLG lanes, the power of two >= D / 8, hold the row (D 96: 12 of 16
// lanes, the other 4 load nothing), so a warp holds kKPW keys at once, and
// kU of them a lane group per step: kStep keys a warp step.
template <typename T, int D, int kR>
struct WarpLayout {
  using Blk = WarpBlock<kR>;
  static constexpr int kWarps = Blk::kWarps, kThreads = 32 * kWarps;
  static constexpr int kKeys = kBKV / kWarps;
  static constexpr int kCols = D / 8;
  static constexpr int kLG = kCols <= 2    ? 2
                             : kCols <= 4  ? 4
                             : kCols <= 8  ? 8
                             : kCols <= 16 ? 16
                                           : 32;
  static constexpr int kKPW = 32 / kLG;
  static constexpr int kWords = 8 * (int)sizeof(T) / 16;
  static constexpr int kVec = 16 / (int)sizeof(T);
  static constexpr int kUMax = Blk::kLoadBytes / (16 * kWords);
  static constexpr int kU = kKeys / kKPW < 1      ? 1
                            : kKeys / kKPW < kUMax ? kKeys / kKPW
                                                   : kUMax;
  static constexpr int kStep = kKPW * kU;
  static constexpr int kSteps = (kKeys + kStep - 1) / kStep;
  static_assert(D % 8 == 0 && kCols <= 32, "8 columns a lane, <= 32 lanes");
};

// 8 columns from their 16-byte words
__device__ __forceinline__ void unpack8(const uint4 (&w)[1], float (&f)[8]) {
  const uint32_t x[4] = {w[0].x, w[0].y, w[0].z, w[0].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // bf16 2i in the low half, 2i + 1 high
    f[2 * i] = __uint_as_float(x[i] << 16);
    f[2 * i + 1] = __uint_as_float(x[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack8(const uint4 (&w)[2], float (&f)[8]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    f[4 * h] = __uint_as_float(w[h].x);
    f[4 * h + 1] = __uint_as_float(w[h].y);
    f[4 * h + 2] = __uint_as_float(w[h].z);
    f[4 * h + 3] = __uint_as_float(w[h].w);
  }
}

// One block per (key split, kv head and up to kR of its G * Sq query rows,
// batch), so each K/V byte is read once for all the rows.  Each warp takes
// its keys of each visible tile of the split, runs its own online softmax
// per row in registers (in the base-2 domain: the scale carries log2 e)
// and accumulates P.V into its lanes' columns; at the end the warps' (m,
// l, acc) are merged in warp order through shared memory.  One split
// writes o; several write part_ml / part_acc for the merge kernel.
template <typename T, int D, bool kPos, int kR>
__global__ void __launch_bounds__(WarpLayout<T, D, kR>::kThreads)
flash_decode_warp_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o,
                         Params p) {
  using L = WarpLayout<T, D, kR>;
  constexpr int kWarps = L::kWarps;
  extern __shared__ __align__(16) float wsm[];
  __shared__ float Wm[kWarps][kR], Wl[kWarps][kR];
  __shared__ int Rlo[kR], Rhi[kR];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.x, b = blockIdx.z;
  const int groups = (p.G * p.Sq + kWDRows - 1) / kWDRows;
  const int hk = blockIdx.y / groups, r_base = blockIdx.y % groups * kWDRows;
  const int rows = min(kR, p.G * p.Sq - r_base);
  // block row r is query (r_base + r) % Sq of head hk*G + (r_base + r) / Sq
  float* Qs = wsm;                   // [rows][D]
  float* Wacc = wsm + rows * D;      // [kWarps][rows][D]
  for (int i = tid; i < rows * D; i += L::kThreads) {
    const int gr = r_base + i / D;
    Qs[i] = to_f32(q[((size_t)(b * p.Sq + gr % p.Sq) * p.Hq + hk * p.G +
                      gr / p.Sq) * D + i % D]);
  }
  // the keys [Rlo, Rhi) each row admits (as the split kernel's row bounds)
  if (tid < rows) {
    const int qp = p.q_offset + (r_base + tid) % p.Sq;
    int rlo = 0, rhi = kPos ? INT_MAX : p.kv_len;
    if (p.causal) rhi = min(rhi, qp + 1);
    if (p.window) rlo = max(rlo, qp - p.window + 1);
    if (p.chunk) {
      rlo = max(rlo, qp / p.chunk * p.chunk);
      rhi = min(rhi, qp / p.chunk * p.chunk + p.chunk);
    }
    Rlo[tid] = rlo;
    Rhi[tid] = rhi;
  }
  // tiles: the split kernel's rule (visible to some query of the block)
  const int q_first = p.q_offset, q_last = p.q_offset + p.Sq - 1;
  int lo = 0, hi = p.kv_len;
  if (p.causal) hi = min(hi, q_last + 1);
  if (p.window) lo = max(lo, q_first - p.window + 1);
  if (p.chunk) {
    lo = max(lo, q_first / p.chunk * p.chunk);
    hi = min(hi, (q_last / p.chunk + 1) * p.chunk);
  }
  const int t0 = split * p.tiles_per_split;
  const int t1 = min(t0 + p.tiles_per_split, (p.kv_len + kBKV - 1) / kBKV);
  // the first tile >= t that some query of the block can see, or t1; every
  // warp decides alike (block-uniform, no barrier)
  auto next_visible = [&](int t) -> int {
    for (; t < t1; ++t) {
      const int s0 = t * kBKV;
      if constexpr (!kPos) {
        if (s0 < hi && s0 + kBKV > lo) return t;
      } else {
        bool any = false;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int slot = s0 + lane + 32 * h;
          const int kp = slot < p.kv_len ? __ldg(p.kpos + slot) : -1;
          any |= kp >= 0 && (!p.causal || kp <= q_last) &&
                 (!p.window || kp > q_first - p.window) &&
                 (!p.chunk || (kp / p.chunk >= q_first / p.chunk &&
                               kp / p.chunk <= q_last / p.chunk));
        }
        if (__any_sync(0xffffffffu, any)) return t;
      }
    }
    return t1;
  };
  const int g = lane / L::kLG, li = lane % L::kLG;
  const bool act = li < L::kCols;
  const int col = (act ? li : 0) * 8;
  const float scale2 = p.scale * kLog2e;
  float m[kR], l[kR], acc[kR][8];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    m[r] = kNegInf, l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
  }
  __syncthreads();   // Qs, Rlo, Rhi

  for (int t = next_visible(t0); t < t1; t = next_visible(t + 1)) {
#pragma unroll 1
    for (int st = 0; st < L::kSteps; ++st) {
      // step st of tile t: kU keys a lane group, all their K and V words in
      // flight at once; a key past kv_len or the warp's slice is not "in"
      uint4 kw[L::kU][L::kWords], vw[L::kU][L::kWords];
      int kp[L::kU];
      bool in[L::kU];
#pragma unroll
      for (int u = 0; u < L::kU; ++u) {
        const int j = st * L::kStep + u * L::kKPW + g;   // of the warp's keys
        const int slot = t * kBKV + warp * L::kKeys + j;
        in[u] = j < L::kKeys && slot < p.kv_len;
        const size_t off =
            ((size_t)(b * p.Skv + (in[u] ? slot : 0)) * p.Hkv + hk) * D + col;
#pragma unroll
        for (int x = 0; x < L::kWords; ++x) {
          kw[u][x] = in[u] && act ? __ldcs(reinterpret_cast<const uint4*>(
                                        k + off + x * L::kVec))
                                  : make_uint4(0, 0, 0, 0);
          vw[u][x] = in[u] && act ? __ldcs(reinterpret_cast<const uint4*>(
                                        v + off + x * L::kVec))
                                  : make_uint4(0, 0, 0, 0);
        }
        if constexpr (kPos)
          kp[u] = in[u] ? __ldg(p.kpos + slot) : -1;
        else
          kp[u] = slot;
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (r >= rows) break;   // block-uniform
        float qf[8];
        load8(Qs + r * D + col, Qs + r * D + col + 4, qf);
        float s[L::kU];
#pragma unroll
        for (int u = 0; u < L::kU; ++u) {
          float kf[8];
          unpack8(kw[u], kf);
          s[u] = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) s[u] = fmaf(qf[e], kf[e], s[u]);
        }
        // the dot products over the lane group, then the step's max over
        // the warp's groups
#pragma unroll
        for (int off = L::kLG / 2; off > 0; off >>= 1)
#pragma unroll
          for (int u = 0; u < L::kU; ++u)
            s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
        const int rlo = Rlo[r], rhi = Rhi[r];
        float mx = kNegInf;
#pragma unroll
        for (int u = 0; u < L::kU; ++u) {
          s[u] = in[u] && kp[u] >= rlo && kp[u] < rhi ? s[u] * scale2
                                                      : kNegInf;
          mx = fmaxf(mx, s[u]);
        }
#pragma unroll
        for (int off = L::kLG; off < 32; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        if (mx > m[r]) {   // warp-uniform
          const float corr = exp2f(m[r] - mx);
          l[r] *= corr;
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[r][e] *= corr;
          m[r] = mx;
        }
        float ps = 0.f;
#pragma unroll
        for (int u = 0; u < L::kU; ++u) {
          const float pu = in[u] ? exp2f(s[u] - m[r]) : 0.f;
          float vf[8];
          unpack8(vw[u], vf);
          ps += pu;
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(pu, vf[e], acc[r][e]);
        }
        l[r] += ps;   // this lane group's keys; summed over groups below
      }
    }
  }

  // the warp's (m, l, acc): l and acc summed over its lane groups; m back
  // to the natural-log domain (a warp that saw no key keeps -2^30)
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if (r >= rows) break;
#pragma unroll
    for (int off = L::kLG; off < 32; off <<= 1) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], off);
    }
    if (lane < L::kCols) {
      float4* dst = reinterpret_cast<float4*>(Wacc + (warp * rows + r) * D +
                                              col);
      dst[0] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      dst[1] = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
    }
    if (lane == 0) {
      Wm[warp][r] = m[r] == kNegInf ? kNegInf : m[r] / kLog2e;
      Wl[warp][r] = l[r];
    }
  }
  __syncthreads();

  // the block's (m, l, acc): the warps merged in order by the log-sum-exp
  // rule; one split writes o, several their partials
  for (int i = tid; i < rows * D; i += L::kThreads) {
    const int r = i / D, d = i % D, gr = r_base + r;
    float mb = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, Wm[w][r]);
    float lb = 0.f, ab = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(Wm[w][r] - mb);
      lb = fmaf(Wl[w][r], e, lb);
      ab = fmaf(Wacc[(w * rows + r) * D + d], e, ab);
    }
    const int h = hk * p.G + gr / p.Sq, qi = gr % p.Sq;
    if (p.splits == 1) {
      o[((size_t)(b * p.Sq + qi) * p.Hq + h) * D + d] =
          from_f32<T>(ab / fmaxf(lb, 1e-30f));
    } else {
      const size_t part =
          ((size_t)(b * p.Hq + h) * p.Sq + qi) * p.splits + split;
      p.part_acc[part * D + d] = ab;
      if (d == 0) p.part_ml[2 * part] = mb, p.part_ml[2 * part + 1] = lb;
    }
  }
}

template <typename T, int D, bool kPos, int kR>
cudaError_t launch_warp(const void* q, const void* k, const void* v, void* o,
                        int B, const Params& p, cudaStream_t stream) {
  // Q and the warps' acc for the block's rows in shared memory
  using L = WarpLayout<T, D, kR>;
  const int groups = (p.G * p.Sq + kWDRows - 1) / kWDRows;
  const size_t per_row = (size_t)(1 + L::kWarps) * D * sizeof(float);
  cudaError_t e =
      allow_smem<flash_decode_warp_kernel<T, D, kPos, kR>>(kR * per_row);
  if (e != cudaSuccess) return e;
  flash_decode_warp_kernel<T, D, kPos, kR>
      <<<dim3(p.splits, p.Hkv * groups, B), L::kThreads,
         min(kR, p.G * p.Sq) * per_row, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(o), p);
  return cudaGetLastError();
}

template <typename T, int D, bool kPos, bool kWarp>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, const Params& p, cudaStream_t stream) {
  cudaError_t e;
  if constexpr (kWarp) {
    e = p.G * p.Sq <= 2
            ? launch_warp<T, D, kPos, 2>(q, k, v, o, B, p, stream)
            : launch_warp<T, D, kPos, kWDRows>(q, k, v, o, B, p, stream);
    if (e != cudaSuccess || p.splits == 1) return e;
  } else {
    const size_t smem =
        Layout<T, D>::smem(stages_of<T, D>(p.tiles_per_split));
    e = allow_smem<flash_decode_split_kernel<T, D, kPos>>(
        Layout<T, D>::smem(Layout<T, D>::kStages));
    if (e != cudaSuccess) return e;
    const int groups = (p.G * p.Sq + kRows - 1) / kRows;
    flash_decode_split_kernel<T, D, kPos>
        <<<dim3(p.splits, p.Hkv * groups, B), kThreads, smem, stream>>>(
            static_cast<const T*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v), p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  flash_decode_merge_kernel<T><<<dim3(p.Hq, B), kThreads,
                                 p.splits * sizeof(float), stream>>>(
      p.part_ml, p.part_acc, static_cast<T*>(o), p.Sq, p.Hq, D, p.splits);
  return cudaGetLastError();
}

template <typename T, bool kWarp>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int B, int D, const Params& p, cudaStream_t s) {
#define REPRO_CASE(DD)                                              \
  case DD:                                                          \
    return p.kpos ? launch<T, DD, true, kWarp>(q, k, v, o, B, p, s) \
                  : launch<T, DD, false, kWarp>(q, k, v, o, B, p, s);
  switch (D) {
    REPRO_CASE(16)
    REPRO_CASE(32)
    REPRO_CASE(64)
    REPRO_CASE(96)
    REPRO_CASE(128)
    REPRO_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_CASE
}

}  // namespace

namespace {

template <bool kWarp>
int entry(const void* q, const void* k, const void* v, void* o,
          const void* kpos, void* part_ml, void* part_acc, int dtype, int B,
          int Sq, int Skv, int Hq, int Hkv, int D, int causal, int window,
          int chunk, int q_offset, int kv_len, int splits,
          int tiles_per_split, float scale, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  if (Sq > 8 || splits < 1 || tiles_per_split < 1 || Hkv < 1 || Hq % Hkv)
    return cudaErrorInvalidValue;
  const Params p{static_cast<const int*>(kpos), static_cast<float*>(part_ml),
                 static_cast<float*>(part_acc), Sq, Skv, Hq, Hkv, Hq / Hkv,
                 causal, window, chunk, q_offset, kv_len, splits,
                 tiles_per_split, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch<float, kWarp>(q, k, v, o, B, D, p, s);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16, kWarp>(q, k, v, o, B, D, p, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, o (B, Sq, Hq, D) with Sq <= 8; k, v (B, Skv, Hkv, D), 16-byte aligned;
// kpos (Skv,) int32 or nullptr; part_ml (B*Hq*Sq*splits*2) and part_acc
// (B*Hq*Sq*splits*D) fp32 scratch.  Split s covers the 64-key tiles
// [s * tiles_per_split, (s + 1) * tiles_per_split) below kv_len.  Launches
// the split kernel and the merge kernel; returns the first CUDA error (0 on
// success).
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v,
                                void* o, const void* kpos, void* part_ml,
                                void* part_acc, int dtype, int B, int Sq,
                                int Skv, int Hq, int Hkv, int D, int causal,
                                int window, int chunk, int q_offset,
                                int kv_len, int splits, int tiles_per_split,
                                float scale, void* stream) {
  return entry<false>(q, k, v, o, kpos, part_ml, part_acc, dtype, B, Sq, Skv,
                      Hq, Hkv, D, causal, window, chunk, q_offset, kv_len,
                      splits, tiles_per_split, scale, stream);
}

// The warp decode kernel, same arguments: one block per (split, kv head and
// 8 of its G * Sq query rows, batch).  With one split it writes o and
// launches nothing else (part_ml and part_acc may be null); with several it
// writes the partials and launches the merge kernel.
extern "C" int flash_decode_warp_fwd(const void* q, const void* k,
                                     const void* v, void* o, const void* kpos,
                                     void* part_ml, void* part_acc, int dtype,
                                     int B, int Sq, int Skv, int Hq, int Hkv,
                                     int D, int causal, int window, int chunk,
                                     int q_offset, int kv_len, int splits,
                                     int tiles_per_split, float scale,
                                     void* stream) {
  return entry<true>(q, k, v, o, kpos, part_ml, part_acc, dtype, B, Sq, Skv,
                     Hq, Hkv, D, causal, window, chunk, q_offset, kv_len,
                     splits, tiles_per_split, scale, stream);
}

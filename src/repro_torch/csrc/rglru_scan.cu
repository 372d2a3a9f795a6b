// RG-LRU linear recurrence for Hopper (sm_90a): one ring-fed scan kernel
// with two entries, and the port's first kernel kept as variant `simple`.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan/kernel.py:
// rglru_scan_kernel (body _rglru_kernel): h[t] = a[t] * h[t-1] + b[t],
// elementwise over the width W, the state in fp32, every h[t] written in
// the input type.  The gated entry also takes in the gate arithmetic that
// feeds it in the reference model (src/repro/models/rglru.py:75-89), which
// XLA fuses on a TPU and eager PyTorch would run as ~18 passes over fp32
// (B, S, W) tensors.
//
// Entries (all tensors contiguous; E = fp32 or bf16):
// - rglru_scan_fwd: variant `simple` (unchanged): a, b (B, S, W) -> h, one
//   thread per (batch, channel) looping over time with 16 steps of loads
//   issued ahead of the dependent multiply-adds;
// - rglru_scan_ring_fwd: variant `ring` of the same function (ring_kernel
//   with the Direct loader);
// - rglru_gated_fwd: xa = xc @ w_a, xi = xc @ w_i, xc (B, S, W) in E;
//   b_a, b_i, lambda (W,) fp32; h0 (B, W) fp32 or null (zero) ->
//   h (B, S, W) in E and h_last (B, W) fp32 (ring_kernel with the Gated
//   loader), where
//     r = sigmoid(xa + b_a), i = sigmoid(xi + b_i)       (fp32)
//     a = exp(8 * r * log_a_hat), log_a_hat = -softplus(lambda)
//     b = sqrt(max(1 - a * a, 1e-12)) * i * xc
//     h[t] = a[t] * h[t-1] + b[t] from h[-1] = h0.
//   At S = 1 with h0 it is the model's decode step.  Under autograd it also
//   keeps `states`, the fp32 state entering every 64th step (the
//   backward's chunk), for the backward.
// - rglru_gated_bwd: the gated entry's backward (training): from dh (B, S,
//   W), dh_last (B, W) and the forward's states to dxa, dxi, dxc, db_a,
//   db_i, dlambda and dh0, recomputing a, b and h in fp32 with the
//   forward's arithmetic (gate_math) from the saved states; see "the gated
//   entry's backward" below.  No TPU counterpart: the reference
//   differentiates rglru_mix (src/repro/models/rglru.py:65) through XLA.
//
// Bound: bytes (a multiply-add per three elements moved; the gated entry's
// ~40 operations an element, several on the special-function unit, come
// close to its 8 bytes an element in bf16).  What held the simple kernel at
// half its bound: a thread per channel gives 20480 threads at
// recurrentgemma-2b's (8, 4096, 2560), ~5 warps an SM, and each issues 16
// steps of loads then waits for them, so the memory pipe drains between
// bursts.  The ring design (one kernel template, ring_kernel, whose per-step
// loader is a template parameter: Direct reads a and b, Gated computes them
// from xa, xi, xc):
// - a block owns a strip of C channels (32 or 64, template instances) of
//   one batch row and walks time in tiles of T = G * NL steps;
// - a ring of P shared-memory stages, each a [T x C] tile of every input,
//   is kept full by cp.async copies (16 bytes where the rows allow, 8 or 4
//   where W * sizeof(E) is not a multiple of 16; bf16 rows of odd W go
//   through registers): while tile k is used, tiles k+1 .. k+P-1 are in
//   flight;
// - G threads a channel (warp-aligned: warp w holds sub-chunk w / (C/32)),
//   each owning NL consecutive steps of a tile (NL 8 or 16, template
//   instances): the loader's (a, b) go to registers and fold into
//   (A, H) = (prod a, the state from zero); the G pairs of a channel meet
//   in shared memory; each thread folds the pairs before its own into the
//   tile's incoming state and runs its NL steps from there with the same
//   multiply-adds as a sequential scan, and folds the rest into the next
//   tile's state (every thread of a channel in the same order, so they
//   agree bit for bit).  The gate arithmetic and the serial chain are thus
//   spread over C * G threads, not C;
// - two barriers a tile, stores coalesced (a warp writes 32 neighbouring
//   channels of one step), h_last from the carried state; ragged S and W
//   are masked (zero-filled copies, no writes), no padding; a tile wholly
//   inside S and W runs without the masks (with the sigmoids and square
//   root moved to the special-function unit, that took the gated bf16
//   kernel from 0.426 to 0.276 ms at one tile of the sweep, H100 80GB HBM3
//   at 700 W).
// The launch shape (C, T, G, P, copy width) comes from the wrapper's plan
// (kernels/rglru_scan/ops.py: TILES, placed by chip_smoke.py --scan-sweep).
// Registers and spills (nvcc -Xptxas -v, sm_90a; launch bound 512 threads):
// Gated NL 8: 56 (bf16), 58 (fp32); NL 16: 94, 96; Direct NL 8: 50, 57;
// NL 16: 92, 105; no spills (an NL 32 instance spilled 40-68 bytes and was
// dropped); the same for C 32 and 64; simple: 168 (bf16), 128 (fp32).
// The backward rg_bwd (256 threads, four blocks an SM): 64 in both
// instances with 8-byte accesses; the element-wise ones (two blocks an SM)
// 96 (bf16), 94 (fp32); no spills.
#include "common.cuh"

namespace {

// ---- variant `simple`: the port's first design ----

constexpr int kThreads = 64;
constexpr int kUnroll = 16;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  T* __restrict__ h, int S, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const size_t base = (size_t)blockIdx.y * S * W + w;
  float state = 0.f;
  for (int t0 = 0; t0 < S; t0 += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t off = base + (size_t)(t0 + u) * W;
      av[u] = t0 + u < S ? to_f32(a[off]) : 0.f;
      bv[u] = t0 + u < S ? to_f32(b[off]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < S) {
        state = fmaf(av[u], state, bv[u]);
        h[base + (size_t)(t0 + u) * W] = from_f32<T>(state);
      }
    }
  }
}

template <typename T>
cudaError_t launch_simple(const void* a, const void* b, void* h, int B,
                          int S, int W, cudaStream_t stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(h),
      S, W);
  return cudaGetLastError();
}

// ---- the ring kernel ----

constexpr int kMaxThreads = 512;
constexpr int kMaxStages = 4;
constexpr int kMaxSmem = 232448;    // an H100 block's opt-in shared memory
constexpr float kC = 8.f;           // the reference's c

struct Args {
  const void* in[3];    // Direct: a, b; Gated: xa, xi, xc; (B, S, W) each
  void* h;              // (B, S, W), the inputs' type
  const float* h0;      // (B, W) initial state, or null: zero
  float* h_last;        // (B, W) final state, or null
  float* states;        // (B, K, W) the state entering steps 0, 2^shift,
                        // 2 * 2^shift, ... (K = ceil(S / 2^shift)), or null
  const float* b_a;     // (W,) each, Gated only
  const float* b_i;
  const float* lam;
  int S, W;
  int C, G, P;          // channels a block, threads a channel, ring stages
  int copy_bytes;       // 16, 8, 4 (cp.async) or 2 (through registers)
  int shift, K;         // states: 2^shift a multiple of the steps a thread
};

// One chunk of `bytes` from global to shared memory; zero-filled when !ok.
__device__ __forceinline__ void copy_chunk(void* dst, const void* src,
                                           bool ok, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 16 : 0) : "memory");
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 8 : 0) : "memory");
  } else if (bytes == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 4 : 0) : "memory");
  } else {
    *static_cast<uint16_t*>(dst) = ok ? *static_cast<const uint16_t*>(src)
                                      : uint16_t(0);
  }
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n (0 .. kMaxStages - 2) copy groups are pending.
__device__ __forceinline__ void wait_groups(int n) {
  if (n >= 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The per-step loaders: (a, b) of one element of a stage, e its offset in
// an input's [T x C] tile.
// The interface entry: a and b as they are.
template <typename E>
struct Direct {
  static constexpr int kIn = 2;
  __device__ Direct(const Args&, int, bool) {}
  __device__ void load(const E* st, int e, int tile, float& a,
                       float& b) const {
    a = to_f32(st[e]);
    b = to_f32(st[tile + e]);
  }
};

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// softplus(lam) as F.softplus (beta 1, threshold 20), times -8: the k of
// a = exp(k * r)
__device__ __forceinline__ float gate_k(float lam) {
  return kC * -(lam > 20.f ? lam : log1pf(expf(lam)));
}

// The gate arithmetic of one element (see Gated): r, i, a, the clamped
// y = max(1 - a * a, 1e-12), s = sqrt(y) as y / sqrt(y) and rs = 1 / sqrt(y),
// from xa, xi and the channel's b_a, b_i and k; b = s * i * xc.  The forward
// and the backward both call it, so the backward recomputes the forward's a
// and b bit for bit.
__device__ __forceinline__ void gate_math(float xa, float xi, float ba,
                                          float bi, float k, float& r,
                                          float& i, float& a, float& y,
                                          float& s, float& rs) {
  constexpr float kLog2e = 1.4426950408889634f;
  const float xr = fmaxf(xa + ba, -30.f);
  const float xq = fmaxf(xi + bi, -30.f);
  const float dr = 1.f + ex2_approx(-xr * kLog2e);
  const float di = 1.f + ex2_approx(-xq * kLog2e);
  const float inv = rcp_approx(dr * di);
  r = di * inv;
  i = dr * inv;
  // (8 * r) * log_a_hat in the reference: the same product, rounded once
  a = expf(k * r);
  y = fmaxf(__fsub_rn(1.f, __fmul_rn(a, a)), 1e-12f);
  rs = rsqrtf(y);
  s = y * rs;
}

// The gated entry: (a, b) from xa, xi, xc and the thread's channel's b_a,
// b_i and 8 * log_a_hat, held in registers.  The arithmetic is the
// reference's; where an error cannot compound it uses the special-function
// unit's approximations (each within ~2 ulp): both sigmoids share one
// reciprocal, 1 / ((1 + e^-x) (1 + e^-y)), their arguments floored at -30
// so the product stays finite (sigmoid(-30) ~ 1e-13: the floor moves r or i
// by less than that); r's error reaches a scaled by |8 * log_a_hat * r|
// (at most 0.105 at the model's init); b's square root is y * rsqrt(y).
// a itself is the
// accurate expf: near a = 1, 1 - a * a (rounded as the reference rounds
// it, no FMA contraction) magnifies a's error some thousand times, and the
// state carries it from step to step.
template <typename E>
struct Gated {
  static constexpr int kIn = 3;
  float ba = 0.f, bi = 0.f, k = 0.f;
  __device__ Gated(const Args& p, int w, bool live) {
    if (live) {
      ba = p.b_a[w];
      bi = p.b_i[w];
      k = gate_k(p.lam[w]);
    }
  }
  __device__ void load(const E* st, int e, int tile, float& a,
                       float& b) const {
    float r, i, y, s, rs;
    gate_math(to_f32(st[e]), to_f32(st[tile + e]), ba, bi, k, r, i, a, y, s,
              rs);
    b = s * i * to_f32(st[2 * tile + e]);
  }
};

// Phase 1 of a tile for one thread: its NL (a, b) into registers, folded
// into (A, H) = (prod a, the state from zero) over its n valid steps (all
// NL when Full).
template <bool Full, int C, int NL, class Ld, typename E>
__device__ __forceinline__ float2 fold_steps(const Ld& ld, const E* st,
                                             int e0, int tile, int n,
                                             float (&a)[NL], float (&b)[NL]) {
  float A = 1.f, H = 0.f;
#pragma unroll
  for (int u = 0; u < NL; ++u) {
    ld.load(st, e0 + u * C, tile, a[u], b[u]);
    if (Full || u < n) {
      H = fmaf(a[u], H, b[u]);
      A *= a[u];
    }
  }
  return make_float2(A, H);
}

// Phase 2 for one thread: its n valid steps from the incoming state h, the
// same multiply-adds as a sequential scan, each stored (when live).
template <bool Full, int NL, typename E>
__device__ __forceinline__ void run_steps(float h, const float (&a)[NL],
                                          const float (&b)[NL], int n,
                                          bool live, E* o, size_t W) {
#pragma unroll
  for (int u = 0; u < NL; ++u) {
    if (Full || u < n) {
      h = fmaf(a[u], h, b[u]);
      if (Full || live) o[(size_t)u * W] = from_f32<E>(h);
    }
  }
}

// Grid (ceil(W / C), B), C * G threads: thread (j, c) = (tid / C, tid % C)
// owns steps j*NL .. j*NL + NL - 1 of each T = G * NL step tile of channel
// c.  Per tile k: wait for its copies, a barrier, the copies of tile
// k + P - 1 into the stage that tile k - 1 freed; each thread loads its NL
// (a, b) into registers and folds them into (A, H) = (prod a, the state
// from zero), shares (A, H) in shared memory, a barrier; then folds the
// (A, H) of sub-chunks 0..j-1 into the tile's incoming state, runs its NL
// steps from there (the same multiply-adds as a sequential scan) and
// stores them, and folds the rest (all threads of a channel compute the
// same carry, in the same order).  A tile wholly inside S and W (every tile
// but the last, and every strip but a ragged last one) runs without the
// masks.  With p.states, the thread whose steps start at a multiple of
// 2^p.shift stores the state it starts them from: the bits it runs on.
template <typename E, class Ld, int C, int NL>
__global__ void __launch_bounds__(kMaxThreads)
ring_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = p.G, P = p.P, T = G * NL, tid = threadIdx.x;
  const int j = tid / C, c = tid - j * C;
  const int tile = T * C;                        // elements of one input
  const int c0 = blockIdx.x * C;
  const int cols = min(C, p.W - c0);
  const bool live = c < cols;
  const int n_tiles = (p.S + T - 1) / T;
  const int vec = p.copy_bytes / (int)sizeof(E);  // elements a chunk
  const int per_row = C / vec;                   // chunks a tile row: 2^sh
  const int sh = __ffs(per_row) - 1;
  const size_t base = (size_t)blockIdx.y * p.S * p.W + c0;
  const size_t W = p.W;
  const int stage_elems = Ld::kIn * tile;
  E* ring = reinterpret_cast<E*>(smem);
  float2* xchg = reinterpret_cast<float2*>(
      smem + (size_t)P * stage_elems * sizeof(E));   // [G][C]: (A, H)
  const Ld ld(p, c0 + c, live);

  // tile k's copies into stage s (nothing past the last tile), then a
  // commit: every call is one group
  auto issue = [&](int k, int s) {
    if (k < n_tiles) {
      E* st = ring + s * stage_elems;
      const int t0 = k * T, rows = min(T, p.S - t0);
      const size_t row0 = base + (size_t)t0 * W;
      for (int i = tid; i < T * per_row; i += blockDim.x) {
        const int r = i >> sh, cc = (i & (per_row - 1)) * vec;
        const bool ok = r < rows && cc < cols;
        const size_t off = row0 + (size_t)r * W + cc;
#pragma unroll
        for (int q = 0; q < Ld::kIn; ++q) {
          const E* src = static_cast<const E*>(p.in[q]);
          copy_chunk(st + q * tile + r * C + cc, ok ? src + off : src, ok,
                     p.copy_bytes);
        }
      }
    }
    commit_group();
  };

  for (int k = 0; k < P - 1; ++k) issue(k, k);
  float carry = live && p.h0 != nullptr
                    ? p.h0[(size_t)blockIdx.y * W + c0 + c] : 0.f;
  E* out = static_cast<E*>(p.h) + base + c;
  int s = 0;                                     // tile k's stage, k % P
  for (int k = 0; k < n_tiles; ++k) {
    wait_groups(P - 2);        // tile k has landed (this thread's copies)
    __syncthreads();           // ... everyone's; stage (k-1) % P is free
    issue(k + P - 1, s == 0 ? P - 1 : s - 1);
    const E* st = ring + s * stage_elems;
    s = s + 1 == P ? 0 : s + 1;
    const int t0 = k * T + j * NL;
    const int n = max(0, min(NL, p.S - t0));     // this thread's steps
    const bool full = (k + 1) * T <= p.S && cols == C;   // block-uniform
    const int e0 = j * NL * C + c;
    float a[NL], b[NL];
    xchg[j * C + c] = full
        ? fold_steps<true, C>(ld, st, e0, tile, n, a, b)
        : fold_steps<false, C>(ld, st, e0, tile, n, a, b);
    __syncthreads();
    float h = carry;
    for (int q = 0; q < G; ++q) {
      if (q == j) {                              // this thread's steps
        if (p.states != nullptr && live && n > 0 &&
            (t0 & ((1 << p.shift) - 1)) == 0)
          p.states[((size_t)blockIdx.y * p.K + (t0 >> p.shift)) * W + c0 + c] =
              h;
        E* o = out + (size_t)t0 * W;
        if (full)
          run_steps<true>(h, a, b, n, live, o, W);
        else
          run_steps<false>(h, a, b, n, live, o, W);
      }
      const float2 x = xchg[q * C + c];
      h = fmaf(x.x, h, x.y);
    }
    carry = h;
  }
  if (live && j == 0 && p.h_last != nullptr)
    p.h_last[(size_t)blockIdx.y * W + c0 + c] = carry;
}

template <typename E, template <typename> class Ld, int C, int NL>
cudaError_t launch_nl(const Args& p, int B, size_t smem,
                      cudaStream_t stream) {
  cudaError_t e = allow_smem<ring_kernel<E, Ld<E>, C, NL> >(kMaxSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.W + C - 1) / C, B);
  ring_kernel<E, Ld<E>, C, NL><<<grid, C * p.G, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename E, template <typename> class Ld, int C>
cudaError_t launch_c(const Args& p, int B, int nl, size_t smem,
                     cudaStream_t stream) {
  if (nl == 8) return launch_nl<E, Ld, C, 8>(p, B, smem, stream);
  if (nl == 16) return launch_nl<E, Ld, C, 16>(p, B, smem, stream);
  return cudaErrorInvalidValue;
}

// channels C 32 or 64; steps T = G * NL with NL (steps a thread) 8 or 16
// (template instances).
template <typename E, template <typename> class Ld>
cudaError_t launch_ring(const Args& p, int B, int steps,
                        cudaStream_t stream) {
  const int es = (int)sizeof(E);
  const size_t smem = (size_t)p.P * Ld<E>::kIn * steps * p.C * es +
                      (size_t)p.G * p.C * sizeof(float2);
  const bool copy_ok = (p.copy_bytes == 16 || p.copy_bytes == 8 ||
                        p.copy_bytes == 4 || p.copy_bytes == 2) &&
                       p.copy_bytes >= es && p.copy_bytes <= p.C * es &&
                       (size_t)p.W * es % p.copy_bytes == 0;
  if (p.G < 1 || p.C * p.G > kMaxThreads || steps % p.G != 0 || p.P < 2 ||
      p.P > kMaxStages || !copy_ok || smem > kMaxSmem)
    return cudaErrorInvalidValue;
  if (p.C == 32) return launch_c<E, Ld, 32>(p, B, steps / p.G, smem, stream);
  if (p.C == 64) return launch_c<E, Ld, 64>(p, B, steps / p.G, smem, stream);
  return cudaErrorInvalidValue;
}

// ---- the gated entry's backward ----
//
// Bound: bytes (xa, xi, xc and dh read, dxa, dxi and dxc written once each:
// 14 bytes an element in bf16; ~80 fp32 operations an element, ~10 of them
// on the special-function unit).  The forward keeps the fp32 state entering
// every 64th step (`states`, 1/64 of an fp32 tensor), so the backward reads
// each input once: it recomputes a chunk's h from the saved state instead
// of from a pass of its own.  (The first design, four launches, read the
// four inputs twice with 2-byte loads, a thread a channel, at ~1 TB/s.)
// One launch, rg_bwd: a block takes a strip of CB channels of one batch row
// over a chunk of kRgL = 64 steps, 256 threads;
// thread (j, c) owns V channels (an 8-byte slot: 4 bf16, 2 fp32) over
// sub-chunk j of kRgNL = 4 steps:
// - it stages its 16 slots (4 inputs x 4 steps) in shared memory by
//   cp.async (only the thread reads them: no barrier guards them);
// - phase 1: a and b by gate_math (the forward's arithmetic: the same
//   bits), kept in registers, folded into (A, H, E) = (prod a, the state
//   from zero, the e from zero: sum over t of dh[t] times the product of a
//   up to t) for the sub-chunk; the G = 16 triples of a channel meet in
//   shared memory;
// - a thread a channel group folds them: sub-chunk 0's the chunk's (A, E),
//   the last sub-chunk's the state entering each sub-chunk, from the saved
//   one (in place of H);
// - phase 2: h forward from the sub-chunk's state, h[t-1] kept in b's
//   registers;
// - the chain: the chunks cross in reverse step order.  A block takes a
//   ticket at its start, every strip of chunk k + 1 before any of chunk k,
//   so it waits only for a block that started before it (no deadlock).
//   Sub-chunk 0's threads wait for the e entering the chunk's end
//   (dh_last, or zero, for the last chunk), store the e leaving its start
//   (one multiply-add by the chunk's (A, E); chunk 0: dh0) for chunk k - 1,
//   then turn E into the e entering each sub-chunk's end.  The value is
//   its own flag: the slots start as 0xffffffff, a NaN that no arithmetic
//   gives, and are written and polled with relaxed gpu-scope accesses, so a
//   hand-off is one store and one poll, no fence.  Two launches give the
//   same bits: every value is the same fmaf chain, whatever the timing;
// - phase 3, after a barrier: backwards from the e entering the
//   sub-chunk's end: g[t] = dh[t] + e, e = a[t] g[t], da = g h[t-1],
//   db = g and the chain rule to dxa, dxi, dxc (gate_math again: twice an
//   element), 8-byte stores;
// - the (W,) sums: the thread's sums of db_a, db_i and d(k r) r over its
//   steps (fp32), summed over the sub-chunks in order in fp64 into a
//   partial row of (batch, chunk); the last block of a strip to finish (a
//   counter a strip) sums the strip's rows in fixed order (256 / CB
//   strided groups of rows, each in (batch, chunk) order, then the groups
//   in order), in fp64: db_a, db_i, dlam = sum * 8 * -sigmoid(lam).  No
//   atomics on a result: two runs give the same bits.
// Rows W does not divide into 8-byte groups, or tensors not 8-byte aligned,
// take element loads and stores (Vec false, its own instance).
// Bytes of the function: the four inputs and three outputs once, and the
// saved states (1/64 of an fp32 tensor).  Scratch this design moves
// besides: the chain slots and the fp64 partials (3 values a chunk per
// (batch, channel), written and read once), ~7% more at (2, 4096, 2560).
// Measured (chip_smoke.py, H100 80GB HBM3 at 700 W) at recurrentgemma-2b's
// (2, 4096, 2560) bf16: 0.164-0.166 ms with its memset, ~54% of the bytes
// bound (0.088 ms; the first design: 0.499 ms); 32-step chunks 0.194 (the
// chain's hand-offs doubled).  Ablations (chip_smoke.py --rglru-ablate):
// without the input copies 0.134, without the chain wait 0.158, without
// phase 3's gate_math 0.168, without all three 0.109 ms: the input reads
// are a fifth of the time, the chain and the special-function unit little;
// most of it is each block's fixed phases (ticket, folds, barriers, the
// stores) at four blocks an SM, which 64 registers allow.  Eight bf16
// channels a thread in 16-byte loads took 128 registers and two blocks an
// SM, and was slower; at four blocks an SM it spilled.

constexpr int kRgThreads = 256;
constexpr int kRgL = 64;                 // steps a chunk (32: slower)
constexpr int kRgNL = 4;                 // steps a thread
constexpr int kRgBlocks = 4;             // blocks an SM (launch bound; 2
                                         // for the element-wise instances)
constexpr uint32_t kUnset = 0xffffffffu; // an empty chain slot
constexpr long long kWaitCycles = 4000000000ll;   // ~2 s: a fault

struct BwdArgs {
  const void* xa;
  const void* xi;
  const void* xc;
  const void* dh;         // (B, S, W), the inputs' type
  const float* b_a;       // (W,) each
  const float* b_i;
  const float* lam;
  const float* states;    // (B, K, W): the forward's state entering each chunk
  const float* dh_last;   // (B, W) or null
  void* dxa;              // (B, S, W), the inputs' type
  void* dxi;
  void* dxc;
  float* db_a;            // (W,) each
  float* db_i;
  float* dlam;
  float* dh0;             // (B, W) or null
  double* part;           // (3, B, K, W) fp64 scratch: partial sums
  int* ticket;            // scratch, -1
  int* done;              // scratch, -1: finished blocks a strip, less one
  float* chain;           // (B, K, W) scratch, kUnset: the e entering each
                          // chunk's end (chunks 0 .. K-2)
  int B, S, W, K;
  int NS;                 // strips a batch row
  int vec;                // 8-byte groups and addresses (see the C entry)
};

// A chain slot, relaxed at gpu scope: each value is its own flag
__device__ __forceinline__ float ld_relaxed(const float* p) {
  float v;
  asm volatile("ld.relaxed.gpu.global.f32 %0, [%1];" : "=f"(v) : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_relaxed(float* p, float v) {
  asm volatile("st.relaxed.gpu.global.f32 [%0], %1;" ::"l"(p), "f"(v)
               : "memory");
}

// Wait until the first nv of V chain slots at p are set (every poll issues
// all nv loads at once); the rest are zero.  A wait still open after ~2 s
// is a fault: trap, so that the launch fails instead of hanging the card.
template <int V>
__device__ __forceinline__ void wait_slots(const float* p, int nv,
                                           float (&e)[V]) {
  const long long t0 = clock64();   // the SM's cycles: cheap to read
  for (;;) {
    bool set = true;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      e[v] = v < nv ? ld_relaxed(p + v) : 0.f;
      set &= __float_as_uint(e[v]) != kUnset;
    }
    if (set) return;
    if (clock64() - t0 > kWaitCycles) __trap();
  }
}

template <typename E>
struct RgShape {
  static constexpr int V = 8 / (int)sizeof(E);   // channels a thread
  static constexpr int G = kRgL / kRgNL;         // sub-chunks a chunk
  static constexpr int NG = kRgThreads / G;      // channel groups a block
  static constexpr int CB = NG * V;              // channels a block
  static constexpr int kSlots = 4 * kRgNL * kRgThreads;   // of 8 bytes
  // the slots, then A, H, E [G][CB], then b_a, b_i, k, the chunk's A, E
  // [CB] each
  static constexpr size_t kSmem =
      (size_t)kSlots * 8 + (size_t)(3 * G + 5) * CB * sizeof(float);
  static_assert(kRgL % kRgNL == 0 && kRgThreads % G == 0 && G > 1 &&
                    kRgThreads % CB == 0 && CB <= kRgThreads &&
                    3 * G * CB * sizeof(float) >=
                        3 * kRgThreads * sizeof(double),
                "chunk shape");
};

template <typename E>
__device__ __forceinline__ void unpack(const float2& s, float (&f)[8 / sizeof(E)]) {
  const E* e = reinterpret_cast<const E*>(&s);
#pragma unroll
  for (int v = 0; v < (int)(8 / sizeof(E)); ++v) f[v] = to_f32(e[v]);
}

template <typename E, bool Vec, int V>
__device__ __forceinline__ void store_out(E* dst, const float (&f)[V],
                                          int nv, bool whole) {
  if (Vec) {
    if (whole) {
      float2 s;
      E* e = reinterpret_cast<E*>(&s);
#pragma unroll
      for (int v = 0; v < V; ++v) e[v] = from_f32<E>(f[v]);
      __stcs(reinterpret_cast<float2*>(dst), s);
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (v < nv) dst[v] = from_f32<E>(f[v]);
  }
}

template <typename E, bool Vec>
__global__ void __launch_bounds__(kRgThreads, Vec ? kRgBlocks : 2)
rg_bwd(const BwdArgs p) {
  using Sh = RgShape<E>;
  constexpr int V = Sh::V, G = Sh::G, NG = Sh::NG, CB = Sh::CB;
  constexpr int NL = kRgNL, T = kRgThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  float2* raw = reinterpret_cast<float2*>(smem);      // [4][NL][T]
  float* xA = reinterpret_cast<float*>(raw + Sh::kSlots);   // [G][CB]
  float* xH = xA + G * CB;
  float* xE = xH + G * CB;
  float* prm = xE + G * CB;                           // [3][CB]
  float* xAt = prm + 3 * CB;                          // [CB]
  float* xEt = xAt + CB;                              // [CB]

  const int ticket = take_ticket(p.ticket) + 1;   // the counter starts at -1
  const int per_chunk = p.B * p.NS;
  const int k = p.K - 1 - ticket / per_chunk;
  const int bb = ticket % per_chunk / p.NS, strip = ticket % p.NS;
  const int tid = threadIdx.x, j = tid / NG, c = tid % NG, cv = c * V;
  const int w0 = strip * CB + cv;                     // the thread's first
  // its channels in W and steps in S (plain comparisons: nvcc 12.9 gave
  // `max(0, min(V, ...)) == V` false at V)
  const bool whole = w0 + V <= p.W;
  const int nv = whole ? V : (w0 < p.W ? p.W - w0 : 0);
  const int t0 = k * kRgL + j * NL;
  const int n = t0 + NL <= p.S ? NL : (t0 < p.S ? p.S - t0 : 0);
  const size_t W = p.W, off = ((size_t)bb * p.S + t0) * W + w0;
  const size_t row = ((size_t)bb * p.K + k) * W + w0;   // of (B, K, W)
  // the channels' b_a, b_i and lambda, loaded before the copies are issued
  const int pw = strip * CB + tid;
  const bool pok = tid < CB && pw < p.W;
  const float pa = pok ? p.b_a[pw] : 0.f, pi = pok ? p.b_i[pw] : 0.f,
              pl = pok ? p.lam[pw] : 0.f;
  const E* src[4] = {static_cast<const E*>(p.xa) + off,
                     static_cast<const E*>(p.xi) + off,
                     static_cast<const E*>(p.xc) + off,
                     static_cast<const E*>(p.dh) + off};
#pragma unroll
  for (int u = 0; u < NL; ++u)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float2* slot = &raw[(q * NL + u) * T + tid];
      if (Vec && u < n && whole) {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                         static_cast<uint32_t>(__cvta_generic_to_shared(slot))),
                     "l"(src[q] + u * W)
                     : "memory");
      } else if (Vec) {
        *slot = make_float2(0.f, 0.f);
      } else {
        E* s = reinterpret_cast<E*>(slot);
#pragma unroll
        for (int v = 0; v < V; ++v)
          s[v] = u < n && v < nv ? src[q][u * W + v] : from_f32<E>(0.f);
      }
    }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if (tid < CB) {
    prm[tid] = pa;
    prm[CB + tid] = pi;
    prm[2 * CB + tid] = pok ? gate_k(pl) : 0.f;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // phase 1: a, b and the sub-chunk's (A, H, E)
  float a[NL][V], b[NL][V];
  {
    float A[V], H[V], Ev[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      A[v] = 1.f;
      H[v] = Ev[v] = 0.f;
    }
#pragma unroll
    for (int u = 0; u < NL; ++u) {
      float xa[V], xi[V], xc[V], dh[V];
      unpack<E>(raw[(0 * NL + u) * T + tid], xa);
      unpack<E>(raw[(1 * NL + u) * T + tid], xi);
      unpack<E>(raw[(2 * NL + u) * T + tid], xc);
      unpack<E>(raw[(3 * NL + u) * T + tid], dh);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float r, i, y, s, rs;
        gate_math(xa[v], xi[v], prm[cv + v], prm[CB + cv + v],
                  prm[2 * CB + cv + v], r, i, a[u][v], y, s, rs);
        b[u][v] = s * i * xc[v];
        if (u < n) {
          H[v] = fmaf(a[u][v], H[v], b[u][v]);
          A[v] *= a[u][v];
          Ev[v] = fmaf(A[v], dh[v], Ev[v]);
        }
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      xA[j * CB + cv + v] = A[v];
      xH[j * CB + cv + v] = H[v];
      xE[j * CB + cv + v] = Ev[v];
    }
  }
  __syncthreads();

  // the sub-chunks folded, a thread a channel group: sub-chunk 0's threads
  // the chunk's (A, E) for the chain; the last's the state entering each
  // sub-chunk, from the saved one, over H
  if (j == 0) {
    float At[V], Et[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      At[v] = 1.f;
      Et[v] = 0.f;
    }
#pragma unroll 4
    for (int q = G - 1; q >= 0; --q)
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float aq = xA[q * CB + cv + v];
        Et[v] = fmaf(aq, Et[v], xE[q * CB + cv + v]);
        At[v] *= aq;
      }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      xAt[cv + v] = At[v];
      xEt[cv + v] = Et[v];
    }
  } else if (j == G - 1) {
    float h[V];
#pragma unroll
    for (int v = 0; v < V; ++v) h[v] = v < nv ? p.states[row + v] : 0.f;
#pragma unroll 4
    for (int q = 0; q < G; ++q)
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float hq = xH[q * CB + cv + v];
        xH[q * CB + cv + v] = h[v];
        h[v] = fmaf(xA[q * CB + cv + v], h[v], hq);
      }
  }
  __syncthreads();

  // phase 2: h forward from the sub-chunk's state; b[u] ends as h[t-1]
#pragma unroll
  for (int v = 0; v < V; ++v) {
    float h = xH[j * CB + cv + v];
#pragma unroll
    for (int u = 0; u < NL; ++u) {
      const float hp = h;
      h = fmaf(a[u][v], h, b[u][v]);
      b[u][v] = hp;
    }
  }

  // the chain: sub-chunk 0's threads take the e entering the chunk's end
  // (dh_last, or zero, for the last chunk), pass on the e leaving its start
  // (one multiply-add), then turn E into the e entering each sub-chunk's
  // end
  if (j == 0) {
    float e[V];
    if (k == p.K - 1 || nv == 0) {
#pragma unroll
      for (int v = 0; v < V; ++v)
        e[v] = v < nv && p.dh_last != nullptr
                   ? p.dh_last[(size_t)bb * W + w0 + v] : 0.f;
    } else {
      wait_slots<V>(p.chain + row, nv, e);
    }
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (v < nv) {
        const float out = fmaf(xAt[cv + v], e[v], xEt[cv + v]);
        if (k > 0)
          st_relaxed(p.chain + row - W + v, out);   // chunk k - 1's slot
        else if (p.dh0 != nullptr)
          p.dh0[(size_t)bb * W + w0 + v] = out;
      }
#pragma unroll 4
    for (int q = G - 1; q >= 0; --q)
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float eq = xE[q * CB + cv + v];
        xE[q * CB + cv + v] = e[v];
        e[v] = fmaf(xA[q * CB + cv + v], e[v], eq);
      }
  }
  __syncthreads();

  // phase 3: backwards from the e entering the sub-chunk's end
  float e[V], sa[V], si[V], sk[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    e[v] = xE[j * CB + cv + v];
    sa[v] = si[v] = sk[v] = 0.f;
  }
  E* dst[3] = {static_cast<E*>(p.dxa) + off, static_cast<E*>(p.dxi) + off,
               static_cast<E*>(p.dxc) + off};
#pragma unroll
  for (int u = NL - 1; u >= 0; --u) {
    if (u < n) {
      float xa[V], xi[V], xc[V], dh[V], oa[V], oi[V], oc[V];
      unpack<E>(raw[(0 * NL + u) * T + tid], xa);
      unpack<E>(raw[(1 * NL + u) * T + tid], xi);
      unpack<E>(raw[(2 * NL + u) * T + tid], xc);
      unpack<E>(raw[(3 * NL + u) * T + tid], dh);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float kk = prm[2 * CB + cv + v];
        float r, i, av, y, s, rs;
        gate_math(xa[v], xi[v], prm[cv + v], prm[CB + cv + v], kk, r, i, av,
                  y, s, rs);
        const float x = xc[v];
        const float g = dh[v] + e[v];
        e[v] = av * g;
        float da = g * b[u][v];                          // g h[t-1]
        // b = s i xc: through s only where the clamp does not hold
        if (y > 1e-12f) da -= g * i * x * av * rs;
        const float dkr = da * av;                       // d(k r)
        oa[v] = dkr * kk * r * (1.f - r);                // d(xa + b_a)
        oi[v] = g * s * x * i * (1.f - i);               // d(xi + b_i)
        oc[v] = g * s * i;
        sa[v] += oa[v];
        si[v] += oi[v];
        sk[v] += dkr * r;
      }
      store_out<E, Vec>(dst[0] + u * W, oa, nv, whole);
      store_out<E, Vec>(dst[1] + u * W, oi, nv, whole);
      store_out<E, Vec>(dst[2] + u * W, oc, nv, whole);
    }
  }

  // the chunk's partial sums: the sub-chunks' in order, in fp64
  __syncthreads();   // every read of xE done
#pragma unroll
  for (int v = 0; v < V; ++v) {
    xA[j * CB + cv + v] = sa[v];
    xH[j * CB + cv + v] = si[v];
    xE[j * CB + cv + v] = sk[v];
  }
  __syncthreads();
  const size_t plane = (size_t)p.B * p.K * W;
  for (int i = tid; i < CB; i += T) {
    const int w = strip * CB + i;
    if (w < p.W) {
      double da = 0.0, di = 0.0, dk = 0.0;
      for (int q = 0; q < G; ++q) {
        da += xA[q * CB + i];
        di += xH[q * CB + i];
        dk += xE[q * CB + i];
      }
      const size_t slot = ((size_t)bb * p.K + k) * W + w;
      p.part[slot] = da;
      p.part[plane + slot] = di;
      p.part[2 * plane + slot] = dk;
    }
  }

  // the last block of the strip to finish sums its partial rows
  __shared__ int last;
  __threadfence();   // this block's partials, before its count
  __syncthreads();
  if (tid == 0) last = atomicAdd(p.done + strip, 1) == p.B * p.K - 2;
  __syncthreads();
  if (!last) return;
  __threadfence();
  constexpr int RG = kRgThreads / CB;     // row groups, a thread each
  double* acc = reinterpret_cast<double*>(xA);   // [3][RG][CB]
  {
    const int g = tid / CB, i = tid % CB, w = strip * CB + i;
    double da = 0.0, di = 0.0, dk = 0.0;
    if (w < p.W) {
      const int rows = p.B * p.K;
      for (int r = g; r < rows; r += RG) {   // in (batch, chunk) order
        const size_t at = (size_t)r * W + w;
        da += __ldcg(p.part + at);
        di += __ldcg(p.part + plane + at);
        dk += __ldcg(p.part + 2 * plane + at);
      }
    }
    acc[g * CB + i] = da;
    acc[(RG + g) * CB + i] = di;
    acc[(2 * RG + g) * CB + i] = dk;
  }
  __syncthreads();
  for (int i = tid; i < CB; i += T) {
    const int w = strip * CB + i;
    if (w < p.W) {
      double da = 0.0, di = 0.0, dk = 0.0;
      for (int g = 0; g < RG; ++g) {   // the groups in order
        da += acc[g * CB + i];
        di += acc[(RG + g) * CB + i];
        dk += acc[(2 * RG + g) * CB + i];
      }
      p.db_a[w] = (float)da;
      p.db_i[w] = (float)di;
      p.dlam[w] = (float)dk * kC * -(1.f / (1.f + expf(-p.lam[w])));
    }
  }
}

template <typename E, bool Vec>
cudaError_t launch_bwd(BwdArgs p, cudaStream_t s, void* marks) {
  using Sh = RgShape<E>;
  cudaError_t e = allow_smem<rg_bwd<E, Vec> >(Sh::kSmem);
  if (e != cudaSuccess) return e;
  p.NS = (p.W + Sh::CB - 1) / Sh::CB;
  const unsigned blocks = (unsigned)p.K * p.B * p.NS;
  mark(marks, 1, s);
  rg_bwd<E, Vec><<<blocks, kRgThreads, Sh::kSmem, s>>>(p);
  mark(marks, 2, s);
  return cudaGetLastError();
}

template <typename E>
cudaError_t dispatch_bwd(const BwdArgs& p, cudaStream_t s, void* marks) {
  return p.vec ? launch_bwd<E, true>(p, s, marks)
               : launch_bwd<E, false>(p, s, marks);
}

}  // namespace

// Variant `simple`: a, b, h (B, S, W) in `dtype`.  Returns the CUDA error
// of the launch.
extern "C" int rglru_scan_fwd(const void* a, const void* b, void* h,
                              int dtype, int B, int S, int W, void* stream) {
  if (B == 0 || S == 0 || W == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_simple<float>(a, b, h, B, S, W, s);
  if (dtype == kBFloat16)
    return launch_simple<__nv_bfloat16>(a, b, h, B, S, W, s);
  return cudaErrorInvalidValue;
}

// Variant `ring` of the same function; channels (C), steps (a tile),
// stages (P), split (G, threads a channel) and copy_bytes from the plan.
extern "C" int rglru_scan_ring_fwd(const void* a, const void* b, void* h,
                                   int dtype, int B, int S, int W,
                                   int channels, int steps, int stages,
                                   int split, int copy_bytes,
                                   void* stream) {
  if (B == 0 || S == 0 || W == 0) return 0;
  Args p{{a, b, nullptr}, h, nullptr, nullptr, nullptr, nullptr, nullptr,
         nullptr, S, W, channels, split, stages, copy_bytes, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_ring<float, Direct>(p, B, steps, s);
  if (dtype == kBFloat16)
    return launch_ring<__nv_bfloat16, Direct>(p, B, steps, s);
  return cudaErrorInvalidValue;
}

// The gated entry: xa, xi, xc, h (B, S, W) in `dtype`; b_a, b_i, lam (W,),
// h0 (B, W) or null, h_last (B, W) in fp32; states: null, or (B, ceil(S /
// every), W) fp32 for the state entering every `every`-th step (the
// backward's chunk), `every` a power of two and a multiple of the tile's
// steps a thread.
extern "C" int rglru_gated_fwd(const void* xa, const void* xi,
                               const void* xc, const float* b_a,
                               const float* b_i, const float* lam,
                               const float* h0, void* h, float* h_last,
                               float* states, int dtype, int B, int S, int W,
                               int channels, int steps, int stages, int split,
                               int copy_bytes, int every, void* stream) {
  if (B == 0 || S == 0 || W == 0) return 0;
  int shift = 0;
  while (shift < 30 && (1 << shift) < every) ++shift;
  if (states != nullptr && (every != (1 << shift) || split < 1 ||
                            steps % split || every % (steps / split)))
    return cudaErrorInvalidValue;
  Args p{{xa, xi, xc}, h, h0, h_last, states, b_a, b_i, lam,
         S, W, channels, split, stages, copy_bytes, shift,
         (S + (1 << shift) - 1) >> shift};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_ring<float, Gated>(p, B, steps, s);
  if (dtype == kBFloat16)
    return launch_ring<__nv_bfloat16, Gated>(p, B, steps, s);
  return cudaErrorInvalidValue;
}

// The gated entry's backward: xa, xi, xc, dh, dxa, dxi, dxc (B, S, W) in
// `dtype`; b_a, b_i, lam, db_a, db_i, dlam (W,), dh_last, dh0 (B, W) in
// fp32 (dh_last: null for zero; dh0: null when the forward had no h0);
// states: (B, K, W) fp32, the forward's state entering every 64th step
// (rglru_gated_fwd's `states` at every = 64), K = ceil(S / 64); part:
// fp64 scratch (3, B, K, W); sync: int32 scratch of 4 + W + B * K * W (a
// ticket counter, padding, a counter a strip, the chain's slots; all set to
// 0xffffffff here, on the stream, by one memset: the counters count from
// -1).  vec: W * the input type's size a multiple of 8 bytes and every
// (B, S, W) tensor 8-byte aligned.  marks: null, or three cudaEvent_t
// recorded before the scratch's memset, after it and after the launch.
// Returns the first CUDA error.
extern "C" int rglru_gated_bwd(const void* xa, const void* xi,
                               const void* xc, const void* dh,
                               const float* b_a, const float* b_i,
                               const float* lam, const float* states,
                               const float* dh_last, void* dxa, void* dxi,
                               void* dxc, float* db_a, float* db_i,
                               float* dlam, float* dh0, double* part,
                               int* sync, int dtype, int B, int S, int W,
                               int vec, void* stream, void* marks) {
  if (B == 0 || S == 0 || W == 0) return 0;
  const int K = (S + kRgL - 1) / kRgL;
  BwdArgs p{xa, xi, xc, dh, b_a, b_i, lam, states, dh_last, dxa, dxi, dxc,
            db_a, db_i, dlam, dh0, part, sync, sync + 4,
            reinterpret_cast<float*>(sync + 4 + W), B, S, W, K, 0, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mark(marks, 0, s);
  const cudaError_t e = cudaMemsetAsync(
      sync, 0xff, (4 + W + (size_t)B * K * W) * sizeof(int), s);
  if (e != cudaSuccess) return e;
  if (dtype == kFloat32) return dispatch_bwd<float>(p, s, marks);
  if (dtype == kBFloat16) return dispatch_bwd<__nv_bfloat16>(p, s, marks);
  return cudaErrorInvalidValue;
}

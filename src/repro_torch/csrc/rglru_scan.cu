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
//   At S = 1 with h0 it is the model's decode step.
// - rglru_gated_bwd: the gated entry's backward (training): from dh (B, S,
//   W) and dh_last (B, W) to dxa, dxi, dxc, db_a, db_i, dlambda and dh0,
//   recomputing a, b and h in fp32 with the forward's arithmetic
//   (gate_math); see "the gated entry's backward" below.  No TPU
//   counterpart: the reference differentiates rglru_mix
//   (src/repro/models/rglru.py:65) through XLA.
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
// Gated NL 8: 63 (bf16), 57 (fp32); NL 16: 94, 92; Direct NL 8: 50, 57;
// NL 16: 81, 108; no spills (an NL 32 instance spilled 40-68 bytes and was
// dropped); the same for C 32 and 64; simple: 168 (bf16), 128 (fp32).
// The backward (launch bound 128): bwd_fold 80 (bf16, fp32), bwd_grads 69,
// 72, bwd_carry 64, bwd_params 72; no spills.
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
  const float* b_a;     // (W,) each, Gated only
  const float* b_i;
  const float* lam;
  int S, W;
  int C, G, P;          // channels a block, threads a channel, ring stages
  int copy_bytes;       // 16, 8, 4 (cp.async) or 2 (through registers)
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
// y = max(1 - a * a, 1e-12) and s = sqrt(y), from xa, xi and the channel's
// b_a, b_i and k; b = s * i * xc.  The forward and the backward both call
// it, so the backward recomputes the forward's a and b bit for bit.
__device__ __forceinline__ void gate_math(float xa, float xi, float ba,
                                          float bi, float k, float& r,
                                          float& i, float& a, float& y,
                                          float& s) {
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
  s = y * rsqrtf(y);
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
    float r, i, y, s;
    gate_math(to_f32(st[e]), to_f32(st[tile + e]), ba, bi, k, r, i, a, y, s);
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
// masks.
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
// Bound: bytes (xa, xi, xc and dh read, dxa, dxi and dxc written: 14 bytes
// an element in bf16; ~50 fp32 operations an element).  This first design
// reads the four inputs twice (passes 1 and 3) and keeps nothing of the
// forward; its scratch is 3 fp32 and 3 fp64 values a chunk per (batch,
// channel), 1/32 of a tensor each.
// Chunk-parallel, three passes over chunks of kBwdL steps (a thread per
// (batch, chunk, channel); a warp takes 32 neighbouring channels of one
// step, so every load and store is coalesced), then a fixed-order sum:
// 1. bwd_fold: the chunk's (a, b) from xa, xi, xc by gate_math (the
//    forward's arithmetic), folded forward into (A, H) = (prod a, the state
//    from zero), and the chunk's dh folded backward into E, the e = a * g
//    that reaches the step before the chunk from zero after it;
// 2. bwd_carry: a thread per (batch, channel) walks the chunks: the state
//    entering each chunk (from h0) in place of H, and the e leaving it
//    backwards (from dh_last) in place of E; the e before step 0 is dh0;
// 3. bwd_grads: the chunk again, h from the carried state (h[t-1] and a in
//    registers), then backwards g[t] = dh[t] + e[t+1], e[t] = a[t] g[t],
//    da = g h[t-1], db = g and the chain rule to dxa, dxi, dxc; the
//    thread's sums of db_a, db_i and d(k r) r over its steps (fp64) go to a
//    partial row of (batch, chunk);
// 4. bwd_params: a thread per channel sums the partials in (batch, chunk)
//    order: db_a, db_i, dlam = sum * 8 * -sigmoid(lam).  No atomics: two
//    runs give the same bits.

constexpr int kBwdThreads = 128;
constexpr int kBwdL = 32;        // steps a chunk
constexpr int kCarryAhead = 8;   // loads issued ahead in the serial passes

struct BwdArgs {
  const void* xa;
  const void* xi;
  const void* xc;
  const void* dh;         // (B, S, W), the inputs' type
  const float* b_a;       // (W,) each
  const float* b_i;
  const float* lam;
  const float* h0;        // (B, W) or null
  const float* dh_last;   // (B, W) or null
  void* dxa;              // (B, S, W), the inputs' type
  void* dxi;
  void* dxc;
  float* db_a;            // (W,) each
  float* db_i;
  float* dlam;
  float* dh0;             // (B, W) or null
  float* carry;           // (3, B, K, W) fp32 scratch: A, H, E
  double* part;           // (3, B, K, W) fp64 scratch: partial sums
  int B, S, W, K;
};

template <typename E>
__global__ void __launch_bounds__(kBwdThreads)
bwd_fold(const BwdArgs p) {
  const int w = blockIdx.x * kBwdThreads + threadIdx.x;
  if (w >= p.W) return;
  const int k = blockIdx.y, bb = blockIdx.z, t0 = k * kBwdL;
  const int n = min(kBwdL, p.S - t0);
  const size_t W = p.W, at = ((size_t)bb * p.S + t0) * W + w;
  const E* xa = static_cast<const E*>(p.xa) + at;
  const E* xi = static_cast<const E*>(p.xi) + at;
  const E* xc = static_cast<const E*>(p.xc) + at;
  const E* dh = static_cast<const E*>(p.dh) + at;
  const float ba = p.b_a[w], bi = p.b_i[w], kk = gate_k(p.lam[w]);
  float av[kBwdL], gv[kBwdL];
  float A = 1.f, H = 0.f;
#pragma unroll
  for (int u = 0; u < kBwdL; ++u) {
    if (u < n) {
      float r, i, y, s;
      gate_math(to_f32(xa[u * W]), to_f32(xi[u * W]), ba, bi, kk, r, i,
                av[u], y, s);
      H = fmaf(av[u], H, s * i * to_f32(xc[u * W]));
      A *= av[u];
      gv[u] = to_f32(dh[u * W]);
    }
  }
  float e = 0.f;
#pragma unroll
  for (int u = kBwdL - 1; u >= 0; --u)
    if (u < n) e = av[u] * (gv[u] + e);
  const size_t slot = ((size_t)bb * p.K + k) * W + w;
  const size_t plane = (size_t)p.B * p.K * W;
  p.carry[slot] = A;
  p.carry[plane + slot] = H;
  p.carry[2 * plane + slot] = e;
}

__global__ void __launch_bounds__(kBwdThreads)
bwd_carry(const BwdArgs p) {
  const int w = blockIdx.x * kBwdThreads + threadIdx.x;
  if (w >= p.W) return;
  const int bb = blockIdx.y;
  const size_t W = p.W, plane = (size_t)p.B * p.K * W;
  float* A = p.carry + (size_t)bb * p.K * W + w;
  float* H = A + plane;
  float* E = A + 2 * plane;
  // kCarryAhead chunks' values loaded ahead of each run of dependent
  // multiply-adds
  float h = p.h0 != nullptr ? p.h0[(size_t)bb * W + w] : 0.f;
  for (int k0 = 0; k0 < p.K; k0 += kCarryAhead) {
    float av[kCarryAhead], hv[kCarryAhead];
#pragma unroll
    for (int u = 0; u < kCarryAhead; ++u)
      if (k0 + u < p.K) {
        av[u] = A[(k0 + u) * W];
        hv[u] = H[(k0 + u) * W];
      }
#pragma unroll
    for (int u = 0; u < kCarryAhead; ++u)
      if (k0 + u < p.K) {
        H[(k0 + u) * W] = h;               // the state entering the chunk
        h = fmaf(av[u], h, hv[u]);
      }
  }
  float e = p.dh_last != nullptr ? p.dh_last[(size_t)bb * W + w] : 0.f;
  for (int k1 = p.K - 1; k1 >= 0; k1 -= kCarryAhead) {
    float av[kCarryAhead], ev[kCarryAhead];
#pragma unroll
    for (int u = 0; u < kCarryAhead; ++u)
      if (k1 - u >= 0) {
        av[u] = A[(k1 - u) * W];
        ev[u] = E[(k1 - u) * W];
      }
#pragma unroll
    for (int u = 0; u < kCarryAhead; ++u)
      if (k1 - u >= 0) {
        E[(k1 - u) * W] = e;               // the e entering the chunk's end
        e = fmaf(av[u], e, ev[u]);
      }
  }
  if (p.dh0 != nullptr) p.dh0[(size_t)bb * W + w] = e;
}

template <typename E>
__global__ void __launch_bounds__(kBwdThreads)
bwd_grads(const BwdArgs p) {
  const int w = blockIdx.x * kBwdThreads + threadIdx.x;
  if (w >= p.W) return;
  const int k = blockIdx.y, bb = blockIdx.z, t0 = k * kBwdL;
  const int n = min(kBwdL, p.S - t0);
  const size_t W = p.W, at = ((size_t)bb * p.S + t0) * W + w;
  const E* xa = static_cast<const E*>(p.xa) + at;
  const E* xi = static_cast<const E*>(p.xi) + at;
  const E* xc = static_cast<const E*>(p.xc) + at;
  const E* dh = static_cast<const E*>(p.dh) + at;
  E* dxa = static_cast<E*>(p.dxa) + at;
  E* dxi = static_cast<E*>(p.dxi) + at;
  E* dxc = static_cast<E*>(p.dxc) + at;
  const float ba = p.b_a[w], bi = p.b_i[w], kk = gate_k(p.lam[w]);
  const size_t slot = ((size_t)bb * p.K + k) * W + w;
  const size_t plane = (size_t)p.B * p.K * W;
  float h = p.carry[plane + slot];
  float e = p.carry[2 * plane + slot];
  float hp[kBwdL];                                    // h[t-1]
#pragma unroll
  for (int u = 0; u < kBwdL; ++u) {
    if (u < n) {
      float r, i, a, y, s;
      gate_math(to_f32(xa[u * W]), to_f32(xi[u * W]), ba, bi, kk, r, i, a,
                y, s);
      hp[u] = h;
      h = fmaf(a, h, s * i * to_f32(xc[u * W]));
    }
  }
  double sa = 0.0, si = 0.0, sk = 0.0;
#pragma unroll
  for (int u = kBwdL - 1; u >= 0; --u) {
    if (u < n) {
      float r, i, a, y, s;
      const float x = to_f32(xc[u * W]);
      gate_math(to_f32(xa[u * W]), to_f32(xi[u * W]), ba, bi, kk, r, i, a,
                y, s);
      const float g = to_f32(dh[u * W]) + e;
      e = a * g;
      float da = g * hp[u];
      // b = s i xc: through s only where the clamp does not hold
      if (y > 1e-12f) da -= g * i * x * a / s;
      const float dkr = da * a;                       // d(k r)
      const float dra = dkr * kk * r * (1.f - r);     // d(xa + b_a)
      const float dri = g * s * x * i * (1.f - i);    // d(xi + b_i)
      dxa[u * W] = from_f32<E>(dra);
      dxi[u * W] = from_f32<E>(dri);
      dxc[u * W] = from_f32<E>(g * s * i);
      sa += dra;
      si += dri;
      sk += (double)(dkr * r);
    }
  }
  p.part[slot] = sa;
  p.part[plane + slot] = si;
  p.part[2 * plane + slot] = sk;
}

__global__ void __launch_bounds__(kBwdThreads)
bwd_params(const BwdArgs p) {
  const int w = blockIdx.x * kBwdThreads + threadIdx.x;
  if (w >= p.W) return;
  const size_t W = p.W, plane = (size_t)p.B * p.K * W, rows = p.B * p.K;
  double sa = 0.0, si = 0.0, sk = 0.0;
  for (size_t r0 = 0; r0 < rows; r0 += kCarryAhead) {   // loads ahead
    double va[kCarryAhead], vi[kCarryAhead], vk[kCarryAhead];
#pragma unroll
    for (int u = 0; u < kCarryAhead; ++u)
      if (r0 + u < rows) {
        const size_t at = (r0 + u) * W + w;
        va[u] = p.part[at];
        vi[u] = p.part[plane + at];
        vk[u] = p.part[2 * plane + at];
      }
#pragma unroll
    for (int u = 0; u < kCarryAhead; ++u)
      if (r0 + u < rows) {                 // in row order
        sa += va[u];
        si += vi[u];
        sk += vk[u];
      }
  }
  const float lam = p.lam[w];
  p.db_a[w] = (float)sa;
  p.db_i[w] = (float)si;
  p.dlam[w] = (float)sk * kC * -(1.f / (1.f + expf(-lam)));
}

template <typename E>
cudaError_t launch_bwd(const BwdArgs& p, cudaStream_t s) {
  const int wb = (p.W + kBwdThreads - 1) / kBwdThreads;
  const dim3 chunks(wb, p.K, p.B), rows(wb, p.B);
  bwd_fold<E><<<chunks, kBwdThreads, 0, s>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_carry<<<rows, kBwdThreads, 0, s>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  bwd_grads<E><<<chunks, kBwdThreads, 0, s>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  bwd_params<<<wb, kBwdThreads, 0, s>>>(p);
  return cudaGetLastError();
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
         S, W, channels, split, stages, copy_bytes};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_ring<float, Direct>(p, B, steps, s);
  if (dtype == kBFloat16)
    return launch_ring<__nv_bfloat16, Direct>(p, B, steps, s);
  return cudaErrorInvalidValue;
}

// The gated entry: xa, xi, xc, h (B, S, W) in `dtype`; b_a, b_i, lam (W,),
// h0 (B, W) or null, h_last (B, W) in fp32.
extern "C" int rglru_gated_fwd(const void* xa, const void* xi,
                               const void* xc, const float* b_a,
                               const float* b_i, const float* lam,
                               const float* h0, void* h, float* h_last,
                               int dtype, int B, int S, int W, int channels,
                               int steps, int stages, int split,
                               int copy_bytes, void* stream) {
  if (B == 0 || S == 0 || W == 0) return 0;
  Args p{{xa, xi, xc}, h, h0, h_last, b_a, b_i, lam,
         S, W, channels, split, stages, copy_bytes};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_ring<float, Gated>(p, B, steps, s);
  if (dtype == kBFloat16)
    return launch_ring<__nv_bfloat16, Gated>(p, B, steps, s);
  return cudaErrorInvalidValue;
}

// The gated entry's backward: xa, xi, xc, dh, dxa, dxi, dxc (B, S, W) in
// `dtype`; b_a, b_i, lam, db_a, db_i, dlam (W,), h0, dh_last, dh0 (B, W)
// in fp32 (h0, dh_last: null for zero; dh0: null when there is no h0);
// carry: fp32 scratch (3, B, K, W) and part: fp64 scratch (3, B, K, W), K
// = ceil(S / steps); `steps` must be the kernel's chunk (32).  Returns the
// first CUDA error of the four launches.
extern "C" int rglru_gated_bwd(const void* xa, const void* xi,
                               const void* xc, const void* dh,
                               const float* b_a, const float* b_i,
                               const float* lam, const float* h0,
                               const float* dh_last, void* dxa, void* dxi,
                               void* dxc, float* db_a, float* db_i,
                               float* dlam, float* dh0, float* carry,
                               double* part, int dtype, int B, int S, int W,
                               int steps, void* stream) {
  if (B == 0 || S == 0 || W == 0) return 0;
  if (steps != kBwdL) return cudaErrorInvalidValue;
  const BwdArgs p{xa, xi, xc, dh, b_a, b_i, lam, h0, dh_last, dxa, dxi, dxc,
                  db_a, db_i, dlam, dh0, carry, part, B, S, W,
                  (S + kBwdL - 1) / kBwdL};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_bwd<float>(p, s);
  if (dtype == kBFloat16) return launch_bwd<__nv_bfloat16>(p, s);
  return cudaErrorInvalidValue;
}

// Group labels of the GA's population engine, for Hopper (sm_90a).
//
// Replaces the reference's jitted-JAX label pass (no pallas_call):
// src/repro/core/population.py:_build_jax_labels (kernel body :619-646),
// whose numpy twin is PopulationEvaluator._labels_np (:353-383).  For each
// genome row it labels every node as _labels_np does:
//   1. run starts: node i starts a run unless the chain edge (i-1 -> i) is
//      fused; lab[i] = i at a start, else 0, then lab = cummax(lab);
//   2. rounds over the fused non-chain ("extra") edges, as long as one of
//      them has two labels a != b at its ends: every such edge hooks
//      lab[a] and lab[b] to min(a, b) (a minimum, so the order of the
//      atomics does not matter), then one synchronous pointer jump
//      lab = lab[lab];
//   3. pointer jumping to the fixpoint.
// The rounds are synchronous as the numpy passes are: the edges' labels
// are all read before any hook, and a jump reads one buffer and writes the
// other.  That is not a detail: a hook may land on a label that is no
// longer a root and cut its link to its parent, so the reference's labels
// are not always the connected components (ROADMAP queue C: a 1040-node
// chain with skips shows it; the zoo graphs have shown no case), and only
// the same rounds give the same labels.  Integers only; bit-equal to
// _labels_np.
//
// Layout: bits (P, m) uint8 (0/1, one byte per edge, the CompiledGraph's
// edge order); labels (P, n) int32.  Static tables, int32 on the device:
// chain edge k is (chain_nodes[k] -> chain_nodes[k] + 1) with id
// chain_eids[k], and chain_into[i] is the id of the chain edge into node i
// (-1: none); extra edge k is (xu[k] -> xv[k]) with id extra_eids[k].  A row
// works in 2 n + 2 n_extra words: labels, the jump's second buffer, and
// each extra edge's two labels read at the start of a round.
//
// Bound: bytes at 65536 genomes (P * m in, P * n * 4 out; a few integer
// operations per byte); latency at the engine's batches (63-128 rows: 30 KB).
// Three variants; the wrapper's plan (kernels/ga_labels/ops.py) picks one:
//
// warp (ga_labels_warp_kernel): one warp per genome row, R rows a block (R
//   from P, so that a 63-row batch spreads over SMs and 65536 rows fill the
//   card).  The row's edge bytes are read coalesced once and packed by
//   __ballot_sync into words held in registers (lane l keeps words l, l +
//   32, ...: K of them, a template argument), so an edge's bit is a shuffle
//   and a shift, with no dependent global load.  The static tables go into
//   shared memory once per block.  The cummax reads a 32-node chunk's run
//   starts from one ballot (a node's label is the last start at or before
//   it) and carries the last start from chunk to chunk.  The rounds are the
//   same synchronous ones, separated by __syncwarp (independent thread
//   scheduling: no lockstep assumed), and end on __any_sync; which extra
//   edges are fused is read once, a bit per edge in its lane's register,
//   and a lane's first extra edge and its end labels stay in registers.
//   The final compression is one pass in which each node chases its chain
//   of labels to its root.  A row's 2 n + 2 n_extra words sit in its warp's
//   slice of shared memory.  What holds it back at 65536 genomes is
//   latency, with at most 64 warps an SM: a row's byte loads and label
//   stores, then the rounds' chains of dependent shared-memory accesses
//   (the label gathers among them, with bank conflicts).
// block (ga_labels_kernel<true>): one block per genome row, looping over
//   nodes, a block scan for the cummax (a segment per thread, Hillis-Steele
//   over the segment maxima), __syncthreads_or to end each loop, the final
//   compression in place pass by pass (any order reaches the same roots);
//   the row's words in shared memory.  The port's first design, kept for
//   rows whose words exceed a warp's share of an SM's shared memory (there
//   a warp per row leaves the SM too few warps: on a 1040-node chain it is
//   slower).
// global (ga_labels_kernel<false>): the block variant with the row's words
//   in a scratch row in device memory, for rows past the opt-in shared
//   memory, so no size is refused.
// In all three a row with no fused extra edge leaves step 2 at once.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;

// In-place inclusive max-scan of lab[0, n) by the whole block.
__device__ void block_cummax(int* lab, int n, int* carry) {
  const int T = blockDim.x, t = threadIdx.x;
  const int seg = (n + T - 1) / T;
  const int lo = min(n, t * seg), hi = min(n, lo + seg);
  int run = -1;                           // labels are >= 0
  for (int i = lo; i < hi; ++i) {
    run = max(run, lab[i]);
    lab[i] = run;
  }
  carry[t] = run;
  __syncthreads();
  for (int off = 1; off < T; off <<= 1) {
    const int v = t >= off ? carry[t - off] : -1;
    __syncthreads();
    carry[t] = max(carry[t], v);
    __syncthreads();
  }
  const int prev = t > 0 ? carry[t - 1] : -1;
  for (int i = lo; i < hi; ++i) lab[i] = max(lab[i], prev);
  __syncthreads();
}

template <bool kShared>
__global__ void __launch_bounds__(kMaxThreads)
ga_labels_kernel(const uint8_t* __restrict__ bits, int m, int n,
                 const int* __restrict__ chain_nodes,
                 const int* __restrict__ chain_eids, int n_chain,
                 const int* __restrict__ extra_eids,
                 const int* __restrict__ xu, const int* __restrict__ xv,
                 int n_extra, int* scratch,
                 int* __restrict__ out) {
  extern __shared__ int smem[];
  __shared__ int carry[kMaxThreads];
  const uint8_t* b = bits + (size_t)blockIdx.x * m;
  int* o = out + (size_t)blockIdx.x * n;
  int* lab = kShared ? smem
                     : scratch + (size_t)blockIdx.x * (2 * n + 2 * n_extra);
  int* nxt = lab + n;
  int* ea = lab + 2 * n;                  // each extra edge's end labels
  int* eb = ea + n_extra;                 // (ea -1: the edge is not fused)
  const int T = blockDim.x, t = threadIdx.x;

  // 1. run starts, then cummax
  for (int i = t; i < n; i += T) lab[i] = i;
  __syncthreads();
  for (int k = t; k < n_chain; k += T)
    if (b[chain_eids[k]]) lab[chain_nodes[k] + 1] = 0;
  __syncthreads();
  block_cummax(lab, n, carry);

  // 2. synchronous rounds: read every edge's labels, hook, jump once
  while (n_extra) {
    int differ = 0;
    for (int k = t; k < n_extra; k += T) {
      int a = -1, c = -1;
      if (b[extra_eids[k]]) {
        a = lab[xu[k]];
        c = lab[xv[k]];
        differ |= a != c;
      }
      ea[k] = a;
      eb[k] = c;
    }
    if (!__syncthreads_or(differ)) break;
    for (int k = t; k < n_extra; k += T) {
      const int a = ea[k], c = eb[k];
      if (a >= 0) {
        atomicMin(&lab[a], min(a, c));
        atomicMin(&lab[c], min(a, c));
      }
    }
    __syncthreads();
    for (int i = t; i < n; i += T) nxt[i] = lab[lab[i]];
    __syncthreads();
    int* swap = lab;
    lab = nxt;
    nxt = swap;
  }

  // 3. compress to the fixpoint
  int moved;
  do {
    moved = 0;
    for (int i = t; i < n; i += T) {
      const int l = lab[i], ll = lab[l];
      if (ll != l) {
        lab[i] = ll;
        moved = 1;
      }
    }
  } while (__syncthreads_or(moved));
  for (int i = t; i < n; i += T) o[i] = lab[i];
}

// ---- warp variant ------------------------------------------------------

constexpr unsigned kFull = 0xffffffffu;

// Bit of edge e of the row: lane (e / 32) % 32 holds its word in w[e / 1024].
// Every lane of the warp must call it (a shuffle).
template <int K>
__device__ __forceinline__ int edge_bit(const unsigned (&w)[K], int e) {
  unsigned word = 0;
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const unsigned v = __shfl_sync(kFull, w[q], (e >> 5) & 31);
    if (q == (e >> 10)) word = v;
  }
  return (word >> (e & 31)) & 1;
}

constexpr int kMaxRows = 8;   // warps (rows) a block: ops.py MAX_ROWS

template <int K>
__global__ void __launch_bounds__(32 * kMaxRows)
ga_labels_warp_kernel(const uint8_t* __restrict__ bits, int P, int m, int n,
                      const int* __restrict__ chain_into,
                      const int* __restrict__ extra_eids,
                      const int* __restrict__ xu, const int* __restrict__ xv,
                      int n_extra, int* __restrict__ out) {
  extern __shared__ int smem[];
  const int R = blockDim.x / 32, warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * R + warp;
  const bool live = row < P;               // the same in the whole warp

  // the row's bits, packed: word c holds edges 32c .. 32c + 31, lane l
  // keeps words l, l + 32, ...
  const uint8_t* b = bits + (size_t)(live ? row : 0) * m;
  unsigned w[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    w[q] = 0;
    for (int c0 = q * 32; live && c0 < q * 32 + 32 && c0 * 32 < m; c0 += 4) {
      int by[4];                           // four loads in flight, then
#pragma unroll                             // four ballots
      for (int j = 0; j < 4; ++j) {
        const int e = (c0 + j) * 32 + lane;
        by[j] = e < m ? b[e] : 0;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned word = __ballot_sync(kFull, by[j] != 0);
        if (((c0 + j) & 31) == lane) w[q] = word;
      }
    }
  }

  // static tables, once per block: each node's incoming chain edge id (-1:
  // none), and the extra edges
  int* into = smem;
  int* s_eid = into + n;
  int* s_u = s_eid + n_extra;
  int* s_v = s_u + n_extra;
  for (int i = threadIdx.x; i < n; i += blockDim.x) into[i] = chain_into[i];
  for (int k = threadIdx.x; k < n_extra; k += blockDim.x) {
    s_eid[k] = extra_eids[k];
    s_u[k] = xu[k];
    s_v[k] = xv[k];
  }
  __syncthreads();
  if (!live) return;                       // no block barrier below
  int* lab = s_v + n_extra + (size_t)warp * (2 * n + 2 * n_extra);
  int* nxt = lab + n;
  int* ea = lab + 2 * n;                   // each fused extra edge's end
  int* eb = ea + n_extra;                  // labels, read at a round's start

  // 1. run starts (node i starts a run unless its incoming chain edge is
  // fused), then cummax: a node's label is the last start at or before it,
  // read from the ballot of a 32-node chunk's starts, the last start of the
  // chunks before carried along
  int carry = 0;                           // node 0 always starts a run
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const int e = i < n ? into[i] : -1;
    const int fused = edge_bit(w, e < 0 ? 0 : e) && e >= 0;
    const unsigned starts = __ballot_sync(kFull, i < n && !fused);
    const unsigned upto = starts & (kFull >> (31 - lane));
    if (i < n) lab[i] = upto ? base + 31 - __clz(upto) : carry;
    if (starts) carry = base + 31 - __clz(starts);
  }
  // each lane's extra edges k = lane + 32 j: bit j set where edge k is
  // fused; the first (k = lane: every extra edge of the zoo graphs) kept in
  // registers, with its end labels of a round, the others in shared memory
  unsigned xfused = 0;
  for (int j = 0; 32 * j < n_extra; ++j) {
    const int k = 32 * j + lane;
    if (edge_bit(w, k < n_extra ? s_eid[k] : 0) && k < n_extra)
      xfused |= 1u << j;
  }
  const int u0 = xfused & 1 ? s_u[lane] : 0, v0 = xfused & 1 ? s_v[lane] : 0;
  __syncwarp();

  // 2. synchronous rounds: read every fused edge's labels, hook, jump once
  const bool any_fused = __any_sync(kFull, xfused != 0);
  while (any_fused) {
    int a0 = 0, c0 = 0, differ = 0;
    if (xfused & 1) {
      a0 = lab[u0];
      c0 = lab[v0];
      differ = a0 != c0;
    }
    for (int j = 1; 32 * j < n_extra; ++j) {
      const int k = 32 * j + lane;
      if (xfused >> j & 1) {
        const int a = lab[s_u[k]], c = lab[s_v[k]];
        ea[k] = a;
        eb[k] = c;
        differ |= a != c;
      }
    }
    if (!__any_sync(kFull, differ)) break;
    __syncwarp();                          // every read before any hook
    if (xfused & 1) {
      atomicMin(&lab[a0], min(a0, c0));
      atomicMin(&lab[c0], min(a0, c0));
    }
    for (int j = 1; 32 * j < n_extra; ++j) {
      const int k = 32 * j + lane;
      if (xfused >> j & 1) {
        const int a = ea[k], c = eb[k];
        atomicMin(&lab[a], min(a, c));
        atomicMin(&lab[c], min(a, c));
      }
    }
    __syncwarp();
    for (int i = lane; i < n; i += 32) nxt[i] = lab[lab[i]];
    __syncwarp();
    int* swap = lab;
    lab = nxt;
    nxt = swap;
  }

  // 3. compress to the fixpoint in one pass: every label is at most its node
  // (run starts, hooks to minima and jumps keep lab[i] <= i), so each
  // node's chain of labels ends at a root (lab[r] == r) that no write
  // changes; a node chases its chain there (another lane's write on the way
  // only shortens it) and its root is the label the synchronous jumps reach
  int* o = out + (size_t)row * n;
  for (int i = lane; i < n; i += 32) {
    int l = lab[i];
    for (int ll = lab[l]; ll != l; ll = lab[l]) l = ll;
    lab[i] = l;
    o[i] = l;
  }
}

template <int K>
cudaError_t launch_warp(const uint8_t* b, int P, int m, int n,
                        const int* into, const int* ee, const int* u,
                        const int* v, int n_extra, int R, int smem_bytes,
                        int max_smem_bytes, int* o, cudaStream_t s) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = allow_smem<ga_labels_warp_kernel<K>>(max_smem_bytes);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (P + R - 1) / R;
  ga_labels_warp_kernel<K><<<blocks, 32 * R, smem_bytes, s>>>(
      b, P, m, n, into, ee, u, v, n_extra, o);
  return cudaGetLastError();
}

}  // namespace

// Most words of dynamic shared memory a block of the block or warp variant
// may take on the current device: its opt-in shared memory less the block
// variant's static carry (0 on error).  The wrapper reads it once per device
// and passes it back, in bytes, as max_smem_bytes.
extern "C" int ga_labels_max_shared_words() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return (bytes - kMaxThreads * (int)sizeof(int)) / (int)sizeof(int);
}

// The block and global variants.  bits (P, m) uint8 -> out (P, n) int32.
// scratch: nullptr for the block variant, else (P, 2 n + 2 n_extra) int32
// for the global one.  max_smem_bytes: 4 ga_labels_max_shared_words(), the
// most a block may take.  Returns the CUDA error of the launch.
extern "C" int ga_labels_fwd(const void* bits, void* out, void* scratch,
                             int P, int m, int n, const void* chain_nodes,
                             const void* chain_eids, int n_chain,
                             const void* extra_eids, const void* xu,
                             const void* xv, int n_extra, int max_smem_bytes,
                             void* stream) {
  if (P == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads =
      std::min(kMaxThreads, std::max(32, (n + 31) / 32 * 32));
  const auto* b = static_cast<const uint8_t*>(bits);
  const auto* cn = static_cast<const int*>(chain_nodes);
  const auto* ce = static_cast<const int*>(chain_eids);
  const auto* ee = static_cast<const int*>(extra_eids);
  const auto* u = static_cast<const int*>(xu);
  const auto* v = static_cast<const int*>(xv);
  int* o = static_cast<int*>(out);
  int* w = static_cast<int*>(scratch);
  if (w != nullptr) {
    ga_labels_kernel<false><<<P, threads, 0, s>>>(
        b, m, n, cn, ce, n_chain, ee, u, v, n_extra, w, o);
    return cudaGetLastError();
  }
  const size_t bytes = (2 * (size_t)n + 2 * (size_t)n_extra) * sizeof(int);
  cudaError_t e = allow_smem<ga_labels_kernel<true>>(max_smem_bytes);
  if (e != cudaSuccess) return e;
  ga_labels_kernel<true><<<P, threads, bytes, s>>>(
      b, m, n, cn, ce, n_chain, ee, u, v, n_extra, nullptr, o);
  return cudaGetLastError();
}

// The warp variant: R rows (warps) a block, the row's bits in K words a lane
// (m <= 1024 K; K 1, 2 or 4), at most 1024 extra edges (a bit each of a
// lane's word), smem_bytes of dynamic shared memory: (n + 3 n_extra + R (2 n
// + 2 n_extra)) int32 (kernels/ga_labels/ops.py:plan).  chain_into (n,): the
// id of the chain edge into each node, -1 where there is none.  Other
// arguments and result as ga_labels_fwd.
extern "C" int ga_labels_warp_fwd(const void* bits, void* out, int P, int m,
                                  int n, const void* chain_into,
                                  const void* extra_eids, const void* xu,
                                  const void* xv, int n_extra, int R, int K,
                                  int smem_bytes, int max_smem_bytes,
                                  void* stream) {
  if (P == 0 || n == 0) return 0;
  if (R < 1 || R > kMaxRows || m > 1024 * K || n_extra > 1024)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* b = static_cast<const uint8_t*>(bits);
  const auto* into = static_cast<const int*>(chain_into);
  const auto* ee = static_cast<const int*>(extra_eids);
  const auto* u = static_cast<const int*>(xu);
  const auto* v = static_cast<const int*>(xv);
  int* o = static_cast<int*>(out);
  switch (K) {
    case 1: return launch_warp<1>(b, P, m, n, into, ee, u, v, n_extra, R,
                                  smem_bytes, max_smem_bytes, o, s);
    case 2: return launch_warp<2>(b, P, m, n, into, ee, u, v, n_extra, R,
                                  smem_bytes, max_smem_bytes, o, s);
    case 4: return launch_warp<4>(b, P, m, n, into, ee, u, v, n_extra, R,
                                  smem_bytes, max_smem_bytes, o, s);
  }
  return cudaErrorInvalidValue;
}

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
// chain_eids[k]; extra edge k is (xu[k] -> xv[k]) with id extra_eids[k].
// A row works in 2 n + 2 n_extra words: labels, the jump's second buffer,
// and each extra edge's two labels read at the start of a round.
//
// Bound: bytes (P * m in, P * n * 4 out; a few integer operations per
// byte).  Design, simple first: one block per genome row, looping over
// nodes (n is 22-92 on the zoo graphs, 1040+ on the engine's wide tests).
// The row's words live in shared memory (kShared); a graph whose row does
// not fit the opt-in shared memory works in a global scratch row instead
// (the global variant), so no size is refused.  The cummax is a block
// scan: each thread scans a contiguous segment, a Hillis-Steele scan over
// the segment maxima gives each its carry.  The loops end on
// __syncthreads_or of a flag; the final compression runs in place (any
// order reaches the same roots).  A row with no fused extra edge leaves
// step 2 at once.
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

int optin_smem_bytes() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return bytes - kMaxThreads * (int)sizeof(int);   // less the static carry
}

}  // namespace

// Most words (2 n + 2 n_extra) a row may need in the shared-memory variant
// (0 on error).
extern "C" int ga_labels_max_shared_words() {
  return optin_smem_bytes() / (int)sizeof(int);
}

// bits (P, m) uint8 -> out (P, n) int32.  scratch: nullptr for the
// shared-memory variant, else (P, 2 n + 2 n_extra) int32 for the global
// one.  Returns the CUDA error of the launch.
extern "C" int ga_labels_fwd(const void* bits, void* out, void* scratch,
                             int P, int m, int n, const void* chain_nodes,
                             const void* chain_eids, int n_chain,
                             const void* extra_eids, const void* xu,
                             const void* xv, int n_extra, void* stream) {
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
  cudaError_t e = allow_smem<ga_labels_kernel<true>>(optin_smem_bytes());
  if (e != cudaSuccess) return e;
  ga_labels_kernel<true><<<P, threads, bytes, s>>>(
      b, m, n, cn, ce, n_chain, ee, u, v, n_extra, nullptr, o);
  return cudaGetLastError();
}

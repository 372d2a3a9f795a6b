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
// ln 2; a row that saw no key (l = 0) writes -inf.  Serving passes no lse
// pointer, and the kernel then writes none.
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
// Registers and spills (nvcc -Xptxas -v, sm_90a): D 64: 104 registers,
// D 96: 122, D 128: 138, D 256: 201; no spills, no local memory.
#include <cuda.h>   // CUtensorMap and its enums (the driver function is
                    // fetched at run time: no -lcuda)

#include "common.cuh"

namespace {

constexpr int kBKV = 64;                    // keys per tile
constexpr int kWG = 2;                      // consumer warpgroups a block
constexpr float kNegInf = -1073741824.f;    // -2^30, as the reference

// The boxes a row of D columns is cut into: 64 columns (128-byte rows, the
// 128-byte swizzle) where D is a multiple of 64, else 32 (64-byte rows, the
// 64-byte swizzle), so that every box is a whole swizzle atom of its
// operand: D 96 is three 32-column boxes.
__host__ __device__ constexpr int box_cols(int D) {
  return D % 64 == 0 ? 64 : 32;
}

template <int D>
struct Tiles {
  static constexpr int kCols = box_cols(D);            // columns of a box
  static constexpr int kNB = D / kCols;                // boxes of a row
  static constexpr int kBox = kBKV * kCols;   // elements of a box (64 rows)
  static constexpr int kRowBytes = kCols * 2;          // = the swizzle span
  static constexpr int kSteps = kCols / 16;   // k16 steps within a box
  // descriptor swizzle mode (bits 62-63): 1 = 128-byte, 2 = 64-byte
  static constexpr uint64_t kSwizzle = kCols == 64 ? 1 : 2;
};

struct Params {
  int Sq, Hq, Hkv;
  int causal, window, chunk, q_offset, kv_len;
  float scale_log2;                         // 1/sqrt(D) * log2(e)
  float* lse;                               // (B, Hq, Sq) or nullptr
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier and TMA ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, int phase) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(phase)
      : "memory");
  return done;
}

// Wait for the completion of the barrier's phase of parity ``phase``.  A
// wait still open after a second is a fault in the pipeline: trap, so that
// the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int phase) {
  if (mbar_try_wait(bar, phase)) return;
  uint64_t t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  while (!mbar_try_wait(bar, phase)) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (t - t0 > 1000000000ull) __trap();
  }
}

// one box of a 4-D tensor map (coordinates innermost first) into shared
// memory, completing on ``bar``
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---- wgmma ----

// shared-memory matrix descriptor of a box of Tiles<D>, swizzled as its
// TMA map wrote it; offsets in bytes
template <int D>
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) |
         (Tiles<D>::kSwizzle << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous region (the asm that issues wgmma names them as
// outputs, but they are written only by the time the wait returns).
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t desc_a,
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]: A in registers, B MN-major
// (the transpose bit) in shared memory
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 96] += A[64 x 16] B[16 x 96]: A in registers, B MN-major
// (the transpose bit) in shared memory
__device__ __forceinline__ void wgmma_rs_m64n96(float (&d)[48],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128]: A in registers, B MN-major
// (the transpose bit) in shared memory
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 256] += A[64 x 16] B[16 x 256]: A in registers, B MN-major
// (the transpose bit) in shared memory
__device__ __forceinline__ void wgmma_rs_m64n256(float (&d)[128],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (D == 64) wgmma_rs_m64n64(d, a, desc_b);
  if constexpr (D == 96) wgmma_rs_m64n96(d, a, desc_b);
  if constexpr (D == 128) wgmma_rs_m64n128(d, a, desc_b);
  if constexpr (D == 256) wgmma_rs_m64n256(d, a, desc_b);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo: low half
  return *reinterpret_cast<uint32_t*>(&v);
}

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
    __nv_bfloat16* orow = o + ((size_t)(b * p.Sq + row) * p.Hq + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
          oacc[4 * j + 2 * i] * l_r[i], oacc[4 * j + 2 * i + 1] * l_r[i]);
    }
  }
}

// ---- host side ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &res) == cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The model layout (B, S, H, D), bf16, contiguous, as a 4-D map with
// box_cols(D) (of D) x 1 x 64 (of S) x 1 boxes, swizzled by the box's row
// bytes (128 or 64), zeros out of bounds.
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int D) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols(D), 1, kBKV, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
             box_cols(D) == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                               : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

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
// kernel); lse: fp32 (B, Hq, Sq) written when not null.  Returns the CUDA error of the launch (0 on
// success; cudaErrorInvalidValue for another D or a tensor map the driver
// refuses).
extern "C" int flash_prefill_tc_fwd(const void* q, const void* k,
                                    const void* v, void* o, int B, int Sq,
                                    int Skv, int Hq, int Hkv, int D,
                                    int causal, int window, int chunk,
                                    int q_offset, int kv_len, float scale,
                                    void* lse, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, Sq, Hq, D) || !make_map(&tk, k, B, Skv, Hkv, D) ||
      !make_map(&tv, v, B, Skv, Hkv, D))
    return cudaErrorInvalidValue;
  const Params p{Sq, Hq, Hkv, causal, window, chunk, q_offset, kv_len,
                 scale * 1.4426950408889634f, static_cast<float*>(lse)};
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

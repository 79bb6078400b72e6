// Forward Laplacian of one whole PsiFormer layer (attention + MLP), per walker:
//
//   att = h + mha_core(h Wq, h Wk, h Wv) Wo
//   y   = att + tanh(tanh(att W1 + b1) W2 + b2)
//
// on the FL triple of h (x [B, n, d], J [B, K, n, d], L [B, n, d]) to the FL
// triple of y in the same layout.  Weights keep the [in, out] layout: Wq, Wk,
// Wv [d, H*dh] with H*dh = d, Wo, W1, W2 [d, d], b1, b2 [d].
//
// Replaces the TPU kernel deepqmc_tpu/ops/fl_block.py `_pallas_block` (entered
// through `block_fl_call`), which runs an in-kernel jaxpr interpreter over a
// few walkers whose Jacobians it keeps whole in VMEM.  Plain twin:
// deepqmc_tpu_torch/ops/fl_block.py `psiformer_block_fl_plain`.
//
// What bounds it: operations.  At the H2O PsiFormer's shapes (n = 10,
// d = 256, H = 4, K = 30, B = 2048) the six d x d products run over
// (K + 2) n = 320 rows per walker: 0.52 TFLOP, plus about 0.02 TFLOP in the
// attention core, 535 GFLOP in all.  That is 8.0 ms at the card's 67 TFLOP/s
// float32 peak without tensor cores, and 3.2 ms on the tensor cores (495
// TFLOP/s TF32) for the three TF32 products that each float32 product takes
// here (below).  The Jacobian in and out is 1.26 GB, 0.4 ms at 3.35 TB/s.
//
// Why not the TPU's plan: one walker's Jacobian (30 x 10 x 256 floats,
// 307 KB) does not fit the 227 KB of shared memory of a block.  What makes a
// block per walker possible: Jacobian rows of direction k depend only on the
// primals and on direction k's own rows, and every Laplacian rule is linear in
// the incoming Laplacians plus sums over k of products of direction-k
// Jacobians.  So one block per walker runs three phases:
//  A. primal pass: q, k, v and the softmax a (per head) stay in shared memory,
//     m1 = tanh(u1) and m2 = tanh(u2) go to the walker's scratch (tanh' =
//     1 - m^2, tanh'' = -2 m tanh'); y is written out.  L's rows ride along
//     in the q, k, v products (they need nothing but L), and Lq, Lk, Lv go to
//     the scratch for phase C.
//  B. the directions in chunks of kc (kc n <= 64 rows, one tensor-core tile):
//     a chunk of J streams in, goes through the six products and the attention
//     core, and the chunk of J_y streams out.  Each chunk adds its share of the
//     K-sums: per head [n, n] in shared memory: Sqk = sum_k Jq_k Jk_k^T,
//     Q = sum_k Jz_k^2, P = sum_k Jz_k g_k; per head [n]: G = sum_k g_k^2,
//     with g_k = sum_j a_j Jz_kj; [n, d] in the scratch: Sav = sum_k Ja_k Jv_k
//     (all heads) and, per MLP layer, Su = sum_k (J u_k)^2.
//  C. Laplacian pass: L goes through the linearised block, and the sums
//     enter at their sites.  The softmax rules in terms of a:
//       Ja_k = a (Jz_k - g_k)
//       La   = a (Lz + Q - m - 2 P + 2 G),  m = sum_j a (Lz + Q)
//     (the same algebra as fl_attention._softmax_fl with e = a s).
// The scratch ([B, 8, n, d], 82 KB a walker, read and written only by the
// walker's block, from L2) keeps those eight [n, d] arrays out of shared
// memory, which then holds kc = 6 directions at the H2O shapes (60 rows a
// product).
// Each sum over k has one owner thread per entry, which adds the chunk's
// directions in order, and every product sums in a fixed order: no float
// atomics, no reduction across blocks, so the result is bitwise the same from
// launch to launch.  The Jacobian crosses device memory once in and once out.
//
// The products (`tc_gemm`) run on the tensor cores as `wgmma` m64nNk8 with
// TF32 operands, accurate to float32 by the split-TF32 scheme: each float32
// operand is x = hi + lo with hi and lo rounded to TF32 (to nearest), and a
// product sums lo*hi + hi*lo + hi*hi in float32 (the dropped lo*lo is about
// 2^-22 relative).  A product's rows (at most 64) are the A operand, split in
// registers; the weights are the B operand, split into hi and lo tiles in
// shared memory.  The block's two warpgroups take up to 128 columns each.
// Each streams its columns of the weight matrix, 8 input rows at a time,
// through its own ring of 4 shared-memory stages (`cp.async`, 3 stages
// ahead); its 128 threads split a landed stage into the K-major hi and lo
// tiles, and the warpgroup multiplies them: every weight byte is read from L2
// once per block and pass and serves all the rows of the pass.  The rings
// share their memory with the chunk's per-head Jq, Jk, Jv, which are written
// only after the product that makes them has left the rings.
//
// Weight bytes from L2: 6 d^2 floats per walker for the primal pass and for
// each of the ceil(K / kc) chunks, 3 d^2 for the Laplacian pass (its q, k, v
// products ride with the primal pass): 10.2 MB per walker at kc = 6, 20.9 GB
// for 2048 walkers (the float32 version before it read 15.7 MB per walker at
// kc = 4, each byte requested once per pair of token rows).
//
// Tile padding stays inside: rows of the 64-row tile past R repeat row R - 1
// and are not stored, columns past N are computed and not stored, and the
// reduction pads to a multiple of 8 with zeros (the rows' spare columns
// d..d+7 are zeroed at the start, the stages' rows past d are zero-filled by
// `cp.async`).  Requires n <= 32, dh % 4 == 0, kc n <= 64 and 16-byte aligned
// operands (the wrapper checks them).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 2 warpgroups
constexpr int kGroups = kThreads / 128;
constexpr int kMaxN = 32;
constexpr int kMaxRows = 64;        // rows of a product: one 64-row wgmma tile
constexpr int kScratch = 8;         // [n, d] arrays per walker in the scratch
constexpr int kGroupCols = 128;     // columns of a warpgroup per pass
constexpr int kPassCols = kGroups * kGroupCols;  // 256
constexpr int kStages = 4;          // raw weight stages per warpgroup, 8 input rows each
constexpr int kRawLd = kGroupCols;
constexpr int kRaw = kStages * 8 * kRawLd;
constexpr int kTile = 8 * kGroupCols;         // one hi or lo tile of a step
constexpr int kGroupRing = kRaw + 2 * kTile;  // raw stages, the hi and the lo tile
constexpr int kPieces = 8 * kGroupCols / 4 / 128;  // 16-byte pieces of a stage per thread

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ void fma4(float4& acc, float s, float4 w) {
  acc.x += s * w.x;
  acc.y += s * w.y;
  acc.z += s * w.z;
  acc.w += s * w.w;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void st2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}

__device__ __forceinline__ void st4u(uint32_t* p, uint32_t a, uint32_t b, uint32_t c,
                                     uint32_t d) {
  *reinterpret_cast<uint4*>(p) = make_uint4(a, b, c, d);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

__device__ __forceinline__ float dtanh(float m) { return 1.f - m * m; }  // tanh' from tanh

__device__ __forceinline__ float4 dtanh4(float4 m) {
  return make_float4(dtanh(m.x), dtanh(m.y), dtanh(m.z), dtanh(m.w));
}

__host__ __device__ inline int round4(long x) { return (int)((x + 3) / 4 * 4); }

// ---- split-TF32 tensor-core product ----

// The tensor cores read the top 19 bits of a TF32 operand and ignore the low 13,
// so adding half a TF32 unit to the bits rounds to nearest, ties away (what
// `cvt.rna.tf32.f32` gives, in one integer add instead of its longer sequence).
__device__ __forceinline__ uint32_t tf32_bits(float x) { return __float_as_uint(x) + 0x1000u; }

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi & 0xffffe000u));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// ---- warpgroup products (wgmma) ----

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// shared-memory writes of this thread become visible to the tensor cores' reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void group_barrier(int id) {  // the 128 threads of one warpgroup
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}
// keeps the compiler from moving accesses of v across the asynchronous products
__device__ __forceinline__ void fence_reg(float& v) { asm volatile("" : "+f"(v)::"memory"); }

// d += a b for the warpgroup: a 64 x 8 A fragment (registers) and an 8 x n B tile
// (descriptor), n = 16, 32, ..., 128
__device__ __forceinline__ void wgmma_n16(float* d, const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n32(float* d, const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n48(float* d, const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(float* d, const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n80(float* d, const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n96(float* d, const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n112(float* d, const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float* d, const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Shared-memory descriptor of a K-major B tile without swizzle: core matrices
// of 8 columns (n) x 4 inputs (16 bytes), 128 bytes each; the two core
// matrices of an 8-input step 128 bytes apart (leading offset), consecutive
// 8-column groups 256 bytes apart (stride offset).
__device__ __forceinline__ uint64_t tile_desc(const float* tile) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(tile);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// One 8-input step over a warpgroup's W columns, W a multiple of 16
template <int W>
__device__ __forceinline__ void wg_step(float* acc, const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (W == 16) wgmma_n16(acc, a, desc);
  if constexpr (W == 32) wgmma_n32(acc, a, desc);
  if constexpr (W == 48) wgmma_n48(acc, a, desc);
  if constexpr (W == 64) wgmma_n64(acc, a, desc);
  if constexpr (W == 80) wgmma_n80(acc, a, desc);
  if constexpr (W == 96) wgmma_n96(acc, a, desc);
  if constexpr (W == 112) wgmma_n112(acc, a, desc);
  if constexpr (W == 128) wgmma_n128(acc, a, desc);
}

template <int V>
struct Int {
  static constexpr int value = V;
};

// out(r, c) = sum_p A(r, p) W(p, c) for r < R <= 64, c < N, with A in shared
// memory (row stride lda >= P + 8, spare columns zero) and W in global memory
// (row stride ldg; `wsrc(c)` is the address of W(0, c), c a multiple of 4).
// `epi(r, c, v0, v1)` receives out(r, c) and out(r, c + 1); it runs after every
// warp has finished reading A, so it may overwrite it.  Each output has one
// owner and a fixed order of sums.
//
// The block's two warpgroups split a pass of up to 256 columns into two
// ranges of the same width w (a multiple of 16, at most 128).  Each streams its
// own columns of W through its own ring of kStages raw stages of 8 input rows
// (cp.async, 16-byte pieces), splits a landed stage into TF32 hi and lo tiles
// (K-major core matrices), and runs the three products lo*hi, hi*lo, hi*hi as
// `wgmma` m64nwk8 with A (one 64-row tile, split in registers) and the B tiles
// from shared memory.  Only the warpgroup's own 128 threads meet at a barrier
// inside the loop.
//
// The 8 inputs of a step are ordered so that lane t holds inputs 2t and 2t + 1
// of its rows (one float2): the A fragment's columns t and t + 4; the B tiles
// place input k at column k / 2 (k even) or 4 + k / 2 (k odd) to match.
template <class WSrc, class Epi>
__device__ __forceinline__ void tc_gemm(const float* A, int lda, int R, int P, int N, int ldg,
                                        WSrc wsrc, float* ring, Epi epi) {
  const int tid = threadIdx.x, grp = tid >> 7, wt = tid & 127, wq = wt >> 5;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int nk = (P + 7) >> 3;
  const int r0 = min(16 * wq + g, R - 1) * lda + 2 * t;
  const int r1 = min(16 * wq + g + 8, R - 1) * lda + 2 * t;
  float* raw = ring + grp * kGroupRing;
  uint32_t* hi = reinterpret_cast<uint32_t*>(raw + kRaw);  // [kTile], then lo [kTile]
  uint32_t* lo = hi + kTile;
  for (int c0 = 0; c0 < N; c0 += kPassCols) {
    const int np = min(kPassCols, N - c0);
    // every warpgroup takes w columns, a multiple of 16, and issues the same
    // products (columns past np are computed and not stored)
    const int w = 16 * (((np + 7) / 8 + 2 * kGroups - 1) / (2 * kGroups));
    const int gc0 = grp * w;                  // first column of this warpgroup
    const int vc = max(0, min(w, np - gc0));  // of which real, a multiple of 4
    float acc[kGroupCols / 2];
#pragma unroll
    for (int e = 0; e < kGroupCols / 2; ++e) acc[e] = 0.f;
    // this thread's pieces of a stage: input row pr[u], columns pc[u]..pc[u]+3
    const int q4 = max(1, vc / 4);
    bool has[kPieces];
    int pr[kPieces];
    const float* src[kPieces];
    float* mine[kPieces];
#pragma unroll
    for (int u = 0; u < kPieces; ++u) {
      const int e = wt + 128 * u;
      has[u] = e < 8 * (vc / 4);
      pr[u] = has[u] ? e / q4 : 0;
      const int pc = has[u] ? 4 * (e % q4) : 0;
      src[u] = wsrc(c0 + (has[u] ? gc0 + pc : 0));
      mine[u] = raw + pr[u] * kRawLd + pc;
    }
    auto load = [&](int s) {
#pragma unroll
      for (int u = 0; u < kPieces; ++u) {
        if (s < nk && has[u]) {
          const int p = 8 * s + pr[u];
          cp_async16(mine[u] + (s % kStages) * 8 * kRawLd, src[u] + (long)min(p, P - 1) * ldg,
                     p < P);
        }
      }
      cp_async_commit();
    };
    // the k loop for a width known at compile time: every wgmma is issued by
    // all warps of the warpgroup on a path that does not diverge
    auto run = [&](auto width) {
      constexpr int W = decltype(width)::value;
      const uint64_t dh = tile_desc(reinterpret_cast<float*>(hi));
      const uint64_t dl = tile_desc(reinterpret_cast<float*>(lo));
      // one step: meet once stage s is in (and the products of step s - 1 are
      // done), split column wt of it into the hi and lo tiles, meet, refill the
      // slot of stage s - 1, split the A fragment, issue the three products
      auto step = [&](int s) {
        cp_async_wait<kStages - 2>();
        group_barrier(1 + grp);  // stage s is in; stage s - 1 has been split
        if (wt < W) {
          const float* rs = raw + (s % kStages) * 8 * kRawLd + wt;
          uint32_t h[8], l[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) split(rs[k * kRawLd], h[k], l[k]);
          // core matrix rows of column wt: inputs 0, 2, 4, 6, then 1, 3, 5, 7
          const int o = (wt >> 3) * 64 + (wt & 7) * 4;
          st4u(hi + o, h[0], h[2], h[4], h[6]);
          st4u(hi + o + 32, h[1], h[3], h[5], h[7]);
          st4u(lo + o, l[0], l[2], l[4], l[6]);
          st4u(lo + o + 32, l[1], l[3], l[5], l[7]);
        }
        fence_async_smem();
        // refill the slot of stage s - 1 only now: the proxy fence above would
        // otherwise wait for the copies in flight
        load(s + kStages - 1);
        group_barrier(1 + grp);
        uint32_t ah[4], al[4];
        const float2 x0 = ld2(A + r0 + 8 * s), x1 = ld2(A + r1 + 8 * s);
        split(x0.x, ah[0], al[0]);
        split(x1.x, ah[1], al[1]);
        split(x0.y, ah[2], al[2]);
        split(x1.y, ah[3], al[3]);
#pragma unroll
        for (int e = 0; e < kGroupCols / 2; ++e) fence_reg(acc[e]);
        wgmma_fence();
        wg_step<W>(acc, al, dh);
        wg_step<W>(acc, ah, dl);
        wg_step<W>(acc, ah, dh);
        wgmma_commit();
        wgmma_wait<0>();  // the tiles and the A registers are free again
#pragma unroll
        for (int e = 0; e < kGroupCols / 2; ++e) fence_reg(acc[e]);
      };
#pragma unroll
      for (int s = 0; s < kStages - 1; ++s) load(s);
      for (int s = 0; s < nk; ++s) step(s);
      cp_async_wait<0>();
    };
    switch (w) {
      case 16: run(Int<16>{}); break;
      case 32: run(Int<32>{}); break;
      case 48: run(Int<48>{}); break;
      case 64: run(Int<64>{}); break;
      case 80: run(Int<80>{}); break;
      case 96: run(Int<96>{}); break;
      case 112: run(Int<112>{}); break;
      default: run(Int<128>{}); break;
    }
    __syncthreads();  // every warpgroup is done with A
#pragma unroll
    for (int j = 0; j < kGroupCols / 8; ++j) {
      const int c = gc0 + 8 * j + 2 * t, r = 16 * wq + g;
      if (8 * j < w && c < np) {
        if (r < R) epi(r, c0 + c, acc[4 * j], acc[4 * j + 1]);
        if (r + 8 < R) epi(r + 8, c0 + c, acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
    __syncthreads();
  }
}

// Offsets (in floats) of the shared-memory regions; each starts 16-byte aligned.
struct Smem {
  int ld, ldh;
  int q, k, v;                         // [n][ld], persistent
  int a, sqk, sq, sp;                  // [H][n][n], persistent
  int sg;                              // [H][n], persistent
  int bufa, bufb;                      // [kc n][ld], one chunk
  int hq, hk, hv;                      // [kc n][ldh], one head of one chunk
  int ring;                            // [kGroups][kGroupRing], over hq, hk, hv
  int jz, cr;                          // [kc][n][n]
  int g;                               // [kc][n]
  int total;
};

__host__ __device__ inline Smem smem_layout(int n, int d, int H, int kc) {
  Smem s;
  const int dh = d / H;
  s.ld = d + 8;  // spare columns for the k-step padding; float2 fragments conflict-free
  s.ldh = dh + 4;
  int o = 0;
  const int tile = round4((long)n * s.ld);
  s.q = o; o += tile;
  s.k = o; o += tile;
  s.v = o; o += tile;
  const int hnn = round4((long)H * n * n);
  s.a = o; o += hnn;
  s.sqk = o; o += hnn;
  s.sq = o; o += hnn;
  s.sp = o; o += hnn;
  s.sg = o; o += round4((long)H * n);
  const int chunk = round4((long)kc * n * s.ld);
  s.bufa = o; o += kc > 1 ? chunk : round4(2L * n * s.ld);  // also x and L, stacked
  s.bufb = o; o += chunk;
  const int hchunk = round4((long)kc * n * s.ldh);
  const int ring = kGroups * kGroupRing;
  s.hq = o;
  s.hk = o + hchunk;
  s.hv = o + 2 * hchunk;
  s.ring = o;
  o += 3 * hchunk > ring ? 3 * hchunk : ring;
  const int knn = round4((long)kc * n * n);
  s.jz = o; o += knn;
  s.cr = o; o += knn;
  s.g = o; o += round4((long)kc * n);
  s.total = o;
  return s;
}

struct Params {
  const float *x, *jac, *lap, *wq, *wk, *wv, *wo, *w1, *b1, *w2, *b2;
  float *y, *jy, *ly;
  float* scr;  // [B][kScratch][n][d]: m1, m2, Su1, Su2, Sav, then [n][3 d]: Lq | Lk | Lv
  int K, n, d, H, kc;
};

// [Wq_h | Wk_h | Wv_h]: column c of the head's 3 dh projected columns
struct QkvCols {
  const float *wq, *wk, *wv;
  int h, dh;
  __device__ const float* operator()(int c) const {
    const int which = (c >= dh) + (c >= 2 * dh), col = h * dh + c - which * dh;
    return (which == 0 ? wq : which == 1 ? wk : wv) + col;
  }
};

struct Cols {
  const float* w;
  __device__ const float* operator()(int c) const { return w + c; }
};

__global__ void __launch_bounds__(kThreads, 1) fl_block_kernel(Params pr) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int n = pr.n, d = pr.d, H = pr.H, K = pr.K, kc = pr.kc;
  const int dh = d / H, nn = n * n, d4 = d / 4, dh4 = dh / 4;
  const Smem L = smem_layout(n, d, H, kc);
  const int ld = L.ld, ldh = L.ldh;
  const int tid = threadIdx.x, T = blockDim.x;
  const long b = blockIdx.x;
  const float scale = 1.f / sqrtf((float)dh);

  float *sq = sm + L.q, *sk = sm + L.k, *sv = sm + L.v;
  // per-walker [n, d] state in global memory (L2), read and written by its owner threads
  float* ws = pr.scr + b * kScratch * n * d;
  float *gm1 = ws, *gm2 = ws + n * d, *su1 = ws + 2 * n * d, *su2 = ws + 3 * n * d,
        *sav = ws + 4 * n * d, *glq = ws + 5 * n * d;  // glq: Lq | Lk | Lv, [n][3 d]
  float *sa = sm + L.a, *ssqk = sm + L.sqk, *ssq = sm + L.sq, *ssp = sm + L.sp, *ssg = sm + L.sg;
  float *bufa = sm + L.bufa, *bufb = sm + L.bufb;
  float *hq = sm + L.hq, *hk = sm + L.hk, *hv = sm + L.hv, *ring = sm + L.ring;
  float *sjz = sm + L.jz, *scr = sm + L.cr, *sg = sm + L.g;
  const Cols wo{pr.wo}, w1{pr.w1}, w2{pr.w2};

  // zero everything: the K-sums and the rows' spare columns; load x and,
  // below it, L: the Laplacian's q, k, v products need nothing but L, so they
  // ride along with the primal pass's
  for (int e = tid; e < L.total; e += T) sm[e] = 0.f;
  for (int e = tid; e < 3 * n * d; e += T) su1[e] = 0.f;  // Su1, Su2, Sav
  __syncthreads();
  const float *xb = pr.x + b * n * d, *lb = pr.lap + b * n * d;
  for (int e = tid; e < n * d4; e += T) {
    const int i = e / d4, c = 4 * (e % d4);
    st4(bufa + i * ld + c, ldg4(xb + i * d + c));
    st4(bufa + (n + i) * ld + c, ldg4(lb + i * d + c));
  }
  __syncthreads();

  // ---------------- phase A: primal pass ----------------
  for (int h = 0; h < H; ++h) {  // q, k, v into shared memory, Lq, Lk, Lv into the scratch
    tc_gemm(bufa, ld, 2 * n, d, 3 * dh, d, QkvCols{pr.wq, pr.wk, pr.wv, h, dh}, ring,
            [&](int i, int c, float v0, float v1) {
              const int which = (c >= dh) + (c >= 2 * dh), col = h * dh + c - which * dh;
              if (i < n) {
                float* dst = which == 0 ? sq : which == 1 ? sk : sv;
                st2(dst + i * ld + col, make_float2(v0, v1));
              } else {
                st2(glq + (i - n) * 3 * d + which * d + col, make_float2(v0, v1));
              }
            });
  }
  for (int e = tid; e < H * n; e += T) {  // softmax rows a[h][i][:]
    const int h = e / n, i = e % n;
    float* arow = sa + e * n;
    for (int j = 0; j < n; ++j) {
      float z = 0.f;
      for (int c = 0; c < dh; c += 4)
        z += dot4(ld4(sq + i * ld + h * dh + c), ld4(sk + j * ld + h * dh + c));
      arow[j] = z * scale;
    }
    float mx = arow[0];
    for (int j = 1; j < n; ++j) mx = fmaxf(mx, arow[j]);
    float s = 0.f;
    for (int j = 0; j < n; ++j) {
      arow[j] = expf(arow[j] - mx);
      s += arow[j];
    }
    const float inv = 1.f / s;
    for (int j = 0; j < n; ++j) arow[j] *= inv;
  }
  __syncthreads();
  for (int e = tid; e < n * d4; e += T) {  // t = a v
    const int i = e / d4, c = 4 * (e % d4), h = c / dh;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < n; ++j) fma4(t, sa[(h * n + i) * n + j], ld4(sv + j * ld + c));
    st4(bufb + i * ld + c, t);
  }
  __syncthreads();
  tc_gemm(bufb, ld, n, d, d, d, wo, ring, [&](int i, int c, float v0, float v1) {
    float* p = bufa + i * ld + c;  // att = x + t Wo
    const float2 a = ld2(p);
    st2(p, make_float2(a.x + v0, a.y + v1));
  });
  tc_gemm(bufa, ld, n, d, d, d, w1, ring, [&](int i, int c, float v0, float v1) {
    const float2 m1 = make_float2(tanhf(v0 + __ldg(pr.b1 + c)), tanhf(v1 + __ldg(pr.b1 + c + 1)));
    st2(bufb + i * ld + c, m1);
    st2(gm1 + i * d + c, m1);
  });
  tc_gemm(bufb, ld, n, d, d, d, w2, ring, [&](int i, int c, float v0, float v1) {
    const float2 m2 = make_float2(tanhf(v0 + __ldg(pr.b2 + c)), tanhf(v1 + __ldg(pr.b2 + c + 1)));
    const float2 a = ld2(bufa + i * ld + c);
    st2(gm2 + i * d + c, m2);
    st2(pr.y + (b * n + i) * d + c, make_float2(a.x + m2.x, a.y + m2.y));
  });

  // ---------------- phase B: the directions, kc at a time ----------------
  for (int k0 = 0; k0 < K; k0 += kc) {
    const int kn = min(kc, K - k0), R = kn * n;
    const float* jb = pr.jac + (b * K + k0) * n * d;
    for (int e = tid; e < R * d4; e += T) {  // all of the chunk's copies in flight at once
      const int r = e / d4, c = 4 * (e % d4);
      cp_async16(bufa + r * ld + c, jb + (long)r * d + c, true);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int h = 0; h < H; ++h) {
      const float* ah = sa + h * nn;
      // Jq, Jk, Jv of head h
      tc_gemm(bufa, ld, R, d, 3 * dh, d, QkvCols{pr.wq, pr.wk, pr.wv, h, dh}, ring,
                  [&](int r, int c, float v0, float v1) {
                    const int which = (c >= dh) + (c >= 2 * dh);
                    float* dst = which == 0 ? hq : which == 1 ? hk : hv;
                    st2(dst + r * ldh + c - which * dh, make_float2(v0, v1));
                  });
      // Jz_k = (Jq_k k^T + q Jk_k^T) / sqrt(dh) and Jq_k Jk_k^T
      for (int e = tid; e < kn * nn; e += T) {
        const int kk = e / nn, i = (e / n) % n, j = e % n;
        const float *jq = hq + (kk * n + i) * ldh, *jk = hk + (kk * n + j) * ldh;
        const float *qi = sq + i * ld + h * dh, *kj = sk + j * ld + h * dh;
        float z = 0.f, cr = 0.f;
        for (int c = 0; c < dh; c += 4) {
          const float4 jqv = ld4(jq + c), jkv = ld4(jk + c);
          z += dot4(jqv, ld4(kj + c)) + dot4(ld4(qi + c), jkv);
          cr += dot4(jqv, jkv);
        }
        sjz[e] = z * scale;
        scr[e] = cr;
      }
      __syncthreads();
      for (int e = tid; e < kn * n; e += T) {  // g_k[i] = sum_j a_ij Jz_kij
        const int kk = e / n, i = e % n;
        float g = 0.f;
        for (int j = 0; j < n; ++j) g += ah[i * n + j] * sjz[kk * nn + i * n + j];
        sg[e] = g;
      }
      __syncthreads();
      for (int e = tid; e < nn; e += T) {  // the chunk's sums; Jz -> Ja in place
        const int i = e / n;
        const float aij = ah[e];
        float qs = 0.f, ps = 0.f, cs = 0.f;
        for (int kk = 0; kk < kn; ++kk) {
          const float jz = sjz[kk * nn + e], g = sg[kk * n + i];
          qs += jz * jz;
          ps += jz * g;
          cs += scr[kk * nn + e];
          sjz[kk * nn + e] = aij * (jz - g);
        }
        ssq[h * nn + e] += qs;
        ssp[h * nn + e] += ps;
        ssqk[h * nn + e] += cs;
      }
      for (int i = tid; i < n; i += T) {
        float gs = 0.f;
        for (int kk = 0; kk < kn; ++kk) gs += sg[kk * n + i] * sg[kk * n + i];
        ssg[h * n + i] += gs;
      }
      __syncthreads();
      // Jt_k = Ja_k v + a Jv_k into the head's columns of bufb; Sav += Ja_k Jv_k
      for (int e = tid; e < n * dh4; e += T) {
        const int i = e / dh4, c = 4 * (e % dh4);
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int kk = 0; kk < kn; ++kk) {
          float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
          const float* ja = sjz + kk * nn + i * n;
          for (int j = 0; j < n; ++j) {
            const float4 jv = ld4(hv + (kk * n + j) * ldh + c);
            fma4(t, ja[j], ld4(sv + j * ld + h * dh + c));
            fma4(t, ah[i * n + j], jv);
            fma4(s, ja[j], jv);
          }
          st4(bufb + (kk * n + i) * ld + h * dh + c, t);
        }
        float* p = sav + i * d + h * dh + c;
        st4(p, add4(ld4(p), s));
      }
      __syncthreads();
    }
    // J_att = J + Jt Wo (in place in bufa)
    tc_gemm(bufb, ld, R, d, d, d, wo, ring, [&](int r, int c, float v0, float v1) {
      float* p = bufa + r * ld + c;
      const float2 a = ld2(p);
      st2(p, make_float2(a.x + v0, a.y + v1));
    });
    // J u1 = J_att W1 into bufb
    tc_gemm(bufa, ld, R, d, d, d, w1, ring, [&](int r, int c, float v0, float v1) {
      st2(bufb + r * ld + c, make_float2(v0, v1));
    });
    for (int e = tid; e < n * d4; e += T) {  // Su1 += (J u1)^2; J m1 = tanh'(u1) J u1
      const int i = e / d4, c = 4 * (e % d4);
      const float4 t1 = dtanh4(ld4(gm1 + i * d + c));
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int kk = 0; kk < kn; ++kk) {
        float* p = bufb + (kk * n + i) * ld + c;
        const float4 u = ld4(p);
        s = add4(s, mul4(u, u));
        st4(p, mul4(t1, u));
      }
      float* p = su1 + i * d + c;
      st4(p, add4(ld4(p), s));
    }
    __syncthreads();
    // J u2 = J m1 W2 into bufb
    tc_gemm(bufb, ld, R, d, d, d, w2, ring, [&](int r, int c, float v0, float v1) {
      st2(bufb + r * ld + c, make_float2(v0, v1));
    });
    float* jyb = pr.jy + (b * K + k0) * n * d;
    for (int e = tid; e < n * d4; e += T) {  // Su2 += (J u2)^2; J y = J_att + tanh'(u2) J u2
      const int i = e / d4, c = 4 * (e % d4);
      const float4 t2 = dtanh4(ld4(gm2 + i * d + c));
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int kk = 0; kk < kn; ++kk) {
        const int r = kk * n + i;
        const float4 u = ld4(bufb + r * ld + c);
        s = add4(s, mul4(u, u));
        st4(jyb + (long)r * d + c, add4(ld4(bufa + r * ld + c), mul4(t2, u)));
      }
      float* p = su2 + i * d + c;
      st4(p, add4(ld4(p), s));
    }
    __syncthreads();
  }

  // ---------------- phase C: Laplacian pass ----------------
  for (int e = tid; e < n * d4; e += T) {
    const int i = e / d4, c = 4 * (e % d4);
    st4(bufa + i * ld + c, ldg4(lb + i * d + c));
  }
  __syncthreads();
  for (int h = 0; h < H; ++h) {
    const float* ah = sa + h * nn;
    const float *glk = glq + d, *glv = glq + 2 * d;  // rows 3 d apart
    for (int e = tid; e < nn; e += T) {  // w = Lz + Q
      const int i = e / n, j = e % n;
      const float *lq = glq + i * 3 * d + h * dh, *lk = glk + j * 3 * d + h * dh;
      const float *qi = sq + i * ld + h * dh, *kj = sk + j * ld + h * dh;
      float z = 0.f;
      for (int c = 0; c < dh; c += 4) z += dot4(ld4(lq + c), ld4(kj + c)) + dot4(ld4(qi + c), ld4(lk + c));
      sjz[e] = (z + 2.f * ssqk[h * nn + e]) * scale + ssq[h * nn + e];
    }
    __syncthreads();
    for (int i = tid; i < n; i += T) {  // La = a (w - m - 2 P + 2 G) in place
      float m = 0.f;
      for (int j = 0; j < n; ++j) m += ah[i * n + j] * sjz[i * n + j];
      const float g2 = 2.f * ssg[h * n + i];
      for (int j = 0; j < n; ++j) {
        const int e = i * n + j;
        sjz[e] = ah[e] * (sjz[e] - m - 2.f * ssp[h * nn + e] + g2);
      }
    }
    __syncthreads();
    for (int e = tid; e < n * dh4; e += T) {  // Lt = La v + a Lv + 2 Sav
      const int i = e / dh4, c = 4 * (e % dh4);
      float4 t = ld4(sav + i * d + h * dh + c);
      t = add4(t, t);
      for (int j = 0; j < n; ++j) {
        fma4(t, sjz[i * n + j], ld4(sv + j * ld + h * dh + c));
        fma4(t, ah[i * n + j], ld4(glv + j * 3 * d + h * dh + c));
      }
      st4(bufb + i * ld + h * dh + c, t);
    }
    __syncthreads();
  }
  tc_gemm(bufb, ld, n, d, d, d, wo, ring, [&](int i, int c, float v0, float v1) {
    float* p = bufa + i * ld + c;  // L_att = L + Lt Wo
    const float2 a = ld2(p);
    st2(p, make_float2(a.x + v0, a.y + v1));
  });
  // L m1 = tanh' L u1 + tanh'' Su1, tanh'' = -2 m1 tanh'
  tc_gemm(bufa, ld, n, d, d, d, w1, ring, [&](int i, int c, float v0, float v1) {
    const float2 m1 = ld2(gm1 + i * d + c), s = ld2(su1 + i * d + c);
    st2(bufb + i * ld + c, make_float2(dtanh(m1.x) * (v0 - 2.f * m1.x * s.x),
                                       dtanh(m1.y) * (v1 - 2.f * m1.y * s.y)));
  });
  tc_gemm(bufb, ld, n, d, d, d, w2, ring, [&](int i, int c, float v0, float v1) {
    const float2 m2 = ld2(gm2 + i * d + c), s = ld2(su2 + i * d + c), a = ld2(bufa + i * ld + c);
    st2(pr.ly + (b * n + i) * d + c, make_float2(a.x + dtanh(m2.x) * (v0 - 2.f * m2.x * s.x),
                                                 a.y + dtanh(m2.y) * (v1 - 2.f * m2.y * s.y)));
  });
}

int launch(const Params& pr, int B, cudaStream_t stream) {
  const long smem = (long)smem_layout(pr.n, pr.d, pr.H, pr.kc).total * (long)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fl_block_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fl_block_kernel<<<B, kThreads, smem, stream>>>(pr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes of one block; the wrapper picks kc from it.
long fl_block_smem_bytes(int n, int d, int H, int kc) {
  return (long)smem_layout(n, d, H, kc).total * (long)sizeof(float);
}

int fl_block_launch(const float* x, const float* jac, const float* lap, const float* wq,
                    const float* wk, const float* wv, const float* wo, const float* w1,
                    const float* b1, const float* w2, const float* b2, float* y, float* jy,
                    float* ly, float* scratch, int B, int K, int n, int d, int H, int kc,
                    void* stream) {
  if (n < 1 || n > kMaxN || H < 1 || d % H != 0 || (d / H) % 4 != 0 || kc < 1 ||
      kc * n > kMaxRows)
    return (int)cudaErrorInvalidValue;
  const Params pr{x, jac, lap, wq, wk, wv, wo, w1, b1, w2, b2, y, jy, ly, scratch, K, n, d, H, kc};
  return launch(pr, B, (cudaStream_t)stream);
}

}  // extern "C"

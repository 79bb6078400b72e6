// Forward-Laplacian log-determinant traces, three layouts of the Jacobian.
//
// Replaces the TPU kernels of deepqmc_tpu/ops/fl_slogdet.py:
//   fl_slogdet_traces_launch        `_pallas_blocked_flat_split` (body
//                                   `_flat_split_kernel`): flat, row-split;
//   fl_slogdet_square_launch        `_pallas_blocked` (body `_kernel`):
//                                   square, whole Jacobian;
//   fl_slogdet_square_split_launch  `_pallas_blocked_split` (body
//                                   `_split_kernel`): square, row-split.
// Plain twins: deepqmc_tpu_torch/ops/fl_slogdet.py `slogdet_traces_plain`,
// `square_traces_plain`, `square_split_traces_plain`.
//
// For each walker b and determinant d, with A_d^-1 = inv[b, d] and J_{k,d} the
// Jacobian of A_d in direction k, its rows 0 .. nu-1 from the up block and
// nu .. n-1 from the down block:
//   jout[b, k, d] = tr(A_d^-1 J_{k,d})
//   out[b, d]     = sum_k tr((A_d^-1 J_{k,d})^2)             (flat entry)
//   out[b, d]     = tr(A_d^-1 L_d) - sum_k tr((A_d^-1 J_{k,d})^2)  (square)
//
// Layouts (contiguous; float but for the Jacobians, float or bf16):
//   inv [B, D, n, n]; jout [B, K, D]; out [B, D];
//   flat:         ju [B, K, nu, D*n], jd [B, K, nd, D*n] (row stride D*n);
//   square:       ja [B, K, D, n, n] (row stride n), the up block with nd = 0;
//   square split: ju [B, K, D, nu, n], jd [B, K, D, nd, n] (row stride n);
//   la [B, D, n, n] (square entries only).
// Layouts are read in place: the TPU's `rearrange_dirs` transpose, its
// transposed inverse `invt` and its pre-split column halves of A^-1 existed for
// Mosaic's lane layout and have no use here.  nd = 0 is allowed: the down block
// is then never read.  Requires n <= 64 (the wrappers check).
//
// What bounds them: bytes at small n.  The Jacobian is read once (0.39 GB per
// call for the H2O PsiFormer at B = 2048, n = 10, D = 16, K = 30) against about
// n flops per byte; at n = 42 and 64 the 2 n^3 flops per (walker, direction,
// determinant) bound them.
//
// Two bodies serve the three layouts.  Every layout is contiguous per (walker,
// direction): the flat one is two runs (nu D n and nd D n floats), the square
// one one run of D n^2, the square split one two runs (D nu n and D nd n).  The
// layout record `RowBlocks`, made by the wrapper (`row_blocks` in
// ops/fl_slogdet.py), says which copies fill a stage of a ring with direction
// k's rows of a block's G determinants (one TMA copy a run where the block
// holds whole runs, else one a row; 8- or 4-byte `cp.async` copies where a run
// or row is not 16-byte aligned, except that a square layout's run goes by TMA
// at its shift, when that is the same for every direction), and where
// determinant g's row r lies in the stage.  The kernels derive the stage's
// strides from their layout at compile time (`stage_rows`) and each launch
// checks the record against them.  Each launch picks its body by n
// (`fl_slogdet_body`).
//
// Staged body (`fl_slogdet_staged_kernel`, small n).  One block takes a walker
// and a group of G determinants (all D at n = 10; fewer at larger n, so that
// the block stays at most 256 threads and the grid fills the card).  A ring of
// S = 3 stages (the wrapper's FLAT_STAGES), each one direction's rows of the
// group, is filled two directions ahead, completing on the stage's mbarrier.  A
// determinant's rows of m = A_d^-1 J_{k,d} are formed by L lanes of one warp,
// R rows a lane (rows l, l + L, ...; L = 4, R = 3 at n = 10) in registers, so a
// staged row J[r][:] loaded once serves R rows of m; up to n = 16 a lane also
// keeps its rows of A^-1 in registers (beyond, A^-1 sits transposed in shared
// memory), and n = 10 has its own instance with no padded columns.  The rows
// of m meet in the warp's part of shared memory (a warp barrier, not a block
// one); each lane forms m[i][i] and sum_c m[i][c] m[c][i] of its rows, the L
// lanes sum them by shuffles, and the determinant's first lane writes tr(m_k)
// and adds tr(m_k^2) to its sum over k.  The square entries' lanes form
// tr(A^-1 L) once, from the rows of A^-1 they hold.  One block barrier a
// direction (the stage has landed; the stage before it is free for the next
// copy).  What holds it on the card is latency with few blocks per SM, so the
// plan keeps shared memory small.
//
// Tiled body (`fl_slogdet_tiled_kernel`, large n).  One block per (walker,
// determinant) keeps A_d^-1 transposed in shared memory, padded to np = n
// rounded up to 4 with zero rows, for all K directions, and streams the
// directions through a ring of S stages (the wrapper's plan: the deepest ring
// that costs no block an SM).  Each thread forms a 4 x 4 tile of m_k = A^-1 J_k
// in registers as outer products: per step a float4 of a column of A^-1 and 4
// values of a row of J_k, 16 FMAs for two or three shared loads (against one
// FMA a load in the staged body at large n).  Where a row of J_k is only
// 8-byte aligned a thread's 4 columns are two pairs np / 2 apart, so that a
// warp reads a row without bank conflicts.  The tiles meet in a
// double-buffered shared array (float4 chunks swizzled by row), so one block
// barrier a direction serves both the ring and the exchange: after it each
// thread adds sum m[i][c] m[c][i] over its tile and the transposed tile (its
// share of tr(m_k^2), kept over k), and warp 0 sums the diagonal, which each
// entry's holder wrote beside the tiles, into tr(m_k); then the next
// direction's product starts.  Columns beyond n read past a row's end and are
// masked out of the traces.  One block sum at the end.  On the card what
// holds it is the shared-memory pipe and latency in the product loop (about
// 30 % of the float32 peak at n = 42, 45 % at n = 64; PERF.md).
//
// Both bodies sum in a fixed order with one writer per output and no atomics:
// two launches give bitwise-equal results.
//
// bf16 Jacobians (the JAX package's DEEPQMC_TPU_JAC_DTYPE=bf16 store).  The
// Jacobian's element type TJ (float or bf16) is a template argument of both
// bodies: the stages hold the rows as they lie in memory, so the copies above
// count elements of TJ (the record and the stage strides are in elements, a
// 16-byte copy is kVec<TJ> of them, a stage row is padded to 16 bytes), and the
// bodies widen each staged value to float as they load it.  A copy of a single
// bf16 (2 bytes, which cp.async cannot move) is a plain load and store, with a
// plain arrival on the stage's mbarrier.  The inverse, the Laplacian, every
// sum and the outputs stay float.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Layout { kFlat = 0, kSquare = 1, kSquareSplit = 2 };
enum Body { kStaged = 0, kTiled = 1 };

// Up to these n a launch takes the staged body, above them the tiled one.  On
// an H100 (700 W; deepqmc_tpu_torch/sweep_slogdet.py, B = 256, D = 16,
// K = 3 n, ms a call, staged against tiled): flat 0.238 against 0.358 at
// n = 16, 0.549 against 0.590 at 18, 1.145 against 0.527 at 20; square 0.224
// against 0.248 at 16, 0.539 against 0.375 at 18; square split 0.270 against
// 0.298 at 16, 0.550 against 0.457 at 18 (PERF.md).
constexpr int kFlatMaxN = 18;
constexpr int kSquareMaxN = 16;
constexpr int kStagedMaxN = 48;       // the staged body's largest instance
constexpr int kStagedMaxThreads = 256;
constexpr int kTiledMaxThreads = 256;  // (64 / 4)^2 tiles at n = 64
constexpr int kRegInvN = 16;  // up to this n a staged lane keeps its rows of A^-1 in registers

// The layout record, field for field ops/fl_slogdet.py `RowBlocks` (all in
// elements of the Jacobian, floats below; a bf16 record counts bf16 values
// and 16 bytes are 8 of them where these comments say 4 floats).  In memory, determinant d's up row r of (walker b, direction k)
// lies at ju + (b K + k) up_bk + d up_d + r row, its down rows likewise in jd.
// In a stage, determinant g of the block's group has its up row r at
// g s_up_d + r s_row and its down row r at s_dn + g s_dn_d + r s_row.  runs:
// each block (up, down) of the group is one run of G nu n (G nd n) floats,
// laid out in the stage as in memory (up at 0, down at s_dn); else a copy a
// row of G n floats.  vw: floats a copy, 4 by TMA, 2 or 1 by cp.async.
// align: the floats both Jacobian pointers are aligned to (4, 2 or 1).
// shift (square layouts whose runs are not all 16-byte aligned, where the
// (walker, direction) strides are multiples of 4 floats): each run lands at
// its address mod 16 bytes past its place in the stage, 0 to 3 floats
// further (the run's shift, the same for every direction of a block), its
// 16-byte-aligned interior by TMA and the up to 3 floats before and after it
// by plain copies, in place of cp.async copies of vw floats.
struct RowBlocks {
  long up_bk, up_d, dn_bk, dn_d, row;
  long s_up_d, s_dn, s_dn_d, s_row, stage;
  long runs, vw, align, shift;
};

struct Params {
  const float* inv;
  const void *ju, *jd;  // TJ
  const float* la;
  float *jout, *out;
  int D, K, nu, nd, G, S;
  RowBlocks rb;
};

// The stage half of the record as each layout makes it (ops/fl_slogdet.py
// `row_blocks`): the kernels derive it from their layout, a template
// argument, so that the compiler sees how the strides follow from n and G
// (the staged body's row loads schedule much better so; PERF.md), and each
// launch checks that the wrapper's record agrees.
struct StageRows {
  int s_up_d, s_dn, s_dn_d, s_row, stage;
};

// Elements of the Jacobian's type in 16 bytes: 4 floats, 8 bf16.
template <typename TJ>
constexpr int kVec = 16 / (int)sizeof(TJ);

// x rounded up to a multiple of v (a power of 2)
__host__ __device__ inline int up_to(int x, int v) { return (x + v - 1) / v * v; }

// `vec`: elements in 16 bytes (kVec of the Jacobian's type).
__host__ __device__ inline StageRows stage_rows(int layout, int nu, int nd, int G, bool shift,
                                               int vec) {
  const int n = nu + nd;
  if (layout == kFlat) {  // the group's G n columns of each row, rows padded to 16 bytes
    const int ldr = up_to(G * n, vec);
    return {n, nu * ldr, n, ldr, n * ldr};
  }
  // the up run, then the down run from a 16-byte boundary, with shift each
  // with room for its shift
  const int room = shift ? vec - 1 : 0;
  const int s_dn = up_to(G * nu * n + room, vec);
  return {nu * n, s_dn, nd * n, n, s_dn + (nd ? up_to(G * nd * n + room, vec) : 0)};
}

// The shift of the run that starts at `p`: its address mod 16 bytes, in elements.
template <typename TJ>
__device__ __forceinline__ int run_shift(const TJ* p) {
  return (int)(reinterpret_cast<uintptr_t>(p) / sizeof(TJ)) & (kVec<TJ> - 1);
}

// Staged Jacobian values widened to float: 1, 2 (4-byte aligned) or 4 (8-byte
// aligned for bf16, 16 for float) in a row.
__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// ---- copies: TMA, cp.async and mbarriers ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(smem_addr(dst)), "l"(src),
               "n"(BYTES)
               : "memory");
}

// One arrival on `bar` once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// One arrival on `bar`, releasing this thread's earlier writes to shared memory.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16) from global to shared memory by the copy engine
// (TMA), both ends 16-byte aligned; completion counts on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The mbarriers of a ring: one arrival (thread 0's expect_tx) for TMA, one a
// thread for cp.async.
__device__ __forceinline__ void init_ring(uint64_t* bars, int S, bool bulk, int T) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) mbar_init(bars + s, bulk ? 1 : T);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
}

// Direction k's rows of determinants d0 .. d0 + G - 1 of walker b into the
// stage `dst`, completing on `bar` (sizes in elements of TJ, kVec<TJ> = V in
// 16 bytes).  Flat layout: by TMA (vw = V), one copy a run, the up and the
// down block by threads 0 and 32 (1 in a one-warp block), or one a row
// (thread r); thread 0 announces the bytes, G n^2 elements; else copies of vw
// elements by every thread, each arriving once its copies have landed: by
// cp.async where they are 4 or 8 bytes, by plain loads and stores (one bf16)
// with a plain arrival.  SHIFT (square layouts): each run at its shift, its
// interior by TMA (threads 0 and 32 again; thread 0 announces the interiors'
// bytes) and its ends, up to V - 1 elements each, by plain copies (threads 1
// to 4 (V - 1)), which the block barrier before the stage is read makes
// visible.
template <typename TJ, int LAYOUT, bool SHIFT>
__device__ __forceinline__ void issue_stage(const Params& pr, const StageRows& sr, int b, int k,
                                            int d0, TJ* dst, uint64_t* bar, int tid, int T) {
  constexpr int V = kVec<TJ>, E = (int)sizeof(TJ);
  const RowBlocks& rb = pr.rb;
  const int nu = pr.nu, nd = pr.nd, n = nu + nd, gn = pr.G * n;
  const int s_dn = sr.s_dn, s_row = sr.s_row;
  const long bk = (long)b * pr.K + k;
  const TJ* up = static_cast<const TJ*>(pr.ju) + bk * rb.up_bk + d0 * rb.up_d;
  const TJ* dn = static_cast<const TJ*>(pr.jd) + bk * rb.dn_bk + d0 * rb.dn_d;
  const int tid2 = T > 32 ? 32 : 1;  // the second copying thread
  if constexpr (SHIFT) {
    const int sh_u = run_shift(up), sh_d = nd ? run_shift(dn) : 0;
    const int len_u = gn * nu, len_d = gn * nd;
    const int head_u = min((V - sh_u) & (V - 1), len_u), head_d = min((V - sh_d) & (V - 1), len_d);
    const int in_u = (len_u - head_u) & ~(V - 1), in_d = (len_d - head_d) & ~(V - 1);
    TJ *to_u = dst + sh_u, *to_d = dst + s_dn + sh_d;
    if (tid == 0) mbar_expect(bar, (uint32_t)E * (in_u + in_d));
    if (tid == 0 && in_u) bulk_copy(to_u + head_u, up + head_u, (uint32_t)E * in_u, bar);
    if (tid == tid2 && in_d) bulk_copy(to_d + head_d, dn + head_d, (uint32_t)E * in_d, bar);
    // threads 1 .. 4 (V - 1): up to V - 1 elements before and V - 1 after each run
    const int e = tid - 1, ends = 2 * (V - 1);
    if (e >= 0 && e < 2 * ends) {
      const bool u = e < ends;
      const int i = e % ends, head = u ? head_u : head_d, inner = u ? in_u : in_d;
      const int tail = (u ? len_u : len_d) - head - inner;
      const int at = i < V - 1 ? (i < head ? i : -1)
                               : (i - (V - 1) < tail ? head + inner + i - (V - 1) : -1);
      if (at >= 0) (u ? to_u : to_d)[at] = (u ? up : dn)[at];
    }
    return;
  }
  if (rb.vw == V) {
    if (tid == 0) mbar_expect(bar, (uint32_t)E * gn * n);
    if (rb.runs) {
      if (tid == 0) bulk_copy(dst, up, (uint32_t)E * gn * nu, bar);
      if (tid == tid2 && nd) bulk_copy(dst + s_dn, dn, (uint32_t)E * gn * nd, bar);
    } else {
      for (int r = tid; r < n; r += T)
        bulk_copy(r < nu ? dst + r * s_row : dst + s_dn + (r - nu) * s_row,
                  r < nu ? up + r * rb.row : dn + (r - nu) * rb.row, (uint32_t)E * gn, bar);
    }
    return;
  }
  const int v = (int)rb.vw, bytes = v * E;
  const auto copy = [&](TJ* to, const TJ* from) {
    if (bytes == 8)
      cp_async<8>(to, from);
    else if (bytes == 4)
      cp_async<4>(to, from);
    else
      *to = *from;  // one bf16
  };
  if (rb.runs) {
    const int cu = gn * nu / v, cd = gn * nd / v;  // copies of the up and the down run
    for (int e = tid; e < cu + cd; e += T)
      copy(e < cu ? dst + e * v : dst + s_dn + (e - cu) * v,
           e < cu ? up + e * v : dn + (long)(e - cu) * v);
  } else {
    const int cr = gn / v;  // copies a row
    for (int e = tid; e < n * cr; e += T) {
      const int r = e / cr, c = (e % cr) * v;
      copy((r < nu ? dst + r * s_row : dst + s_dn + (r - nu) * s_row) + c,
           (r < nu ? up + r * rb.row : dn + (r - nu) * rb.row) + c);
    }
  }
  if (bytes >= 4)
    cp_async_arrive(bar);
  else
    mbar_arrive(bar);
}

// The shifts (up, down) of the runs of determinants d0 .. of walker b, the
// same for every direction; 0 without SHIFT.
template <typename TJ, bool SHIFT>
__device__ __forceinline__ int2 run_shifts(const Params& pr, int b, int d0) {
  if constexpr (!SHIFT) return make_int2(0, 0);
  const long b0 = (long)b * pr.K;
  return make_int2(
      run_shift(static_cast<const TJ*>(pr.ju) + b0 * pr.rb.up_bk + d0 * pr.rb.up_d),
      pr.nd ? run_shift(static_cast<const TJ*>(pr.jd) + b0 * pr.rb.dn_bk + d0 * pr.rb.dn_d) : 0);
}

// ---- the staged body (small n) ----

// Rows of m a lane of the staged body forms (R) and the largest n it takes
// (NMAX): a determinant's rows i = l + L r (r < R) lie on L = lanes(n, R) lanes
// of one warp, a power of 2 at most 32.
__host__ __device__ inline int staged_lanes(int n, int R) {
  int l = 1;
  while (l * R < n) l <<= 1;
  return l;
}

// Shared-memory plan of the staged body, in floats: S stages of `stage`
// Jacobian elements of `jbytes` bytes, A^-1 transposed [n][G n] (n > kRegInvN only: below, the lanes keep
// their rows of A^-1 in registers), the rows of m [G n][n + 1] and the stages'
// mbarriers (8 bytes each).
struct StagedLayout {
  int invt, xm, bar, total;
};

__host__ __device__ inline StagedLayout staged_layout(int n, int G, int S, int stage,
                                                     int jbytes) {
  StagedLayout L;
  const int gn = G * n;
  L.invt = S * stage * jbytes / 4;
  L.xm = L.invt + (n > kRegInvN ? n * gn : 0);
  L.bar = (L.xm + gn * (n + 1) + 1) / 2 * 2;
  L.total = L.bar + 2 * S;
  return L;
}

// m[r][:] += a[r] J[rr][:] for one staged row J[rr][:] of a determinant
template <int NMAX, int R, int VEC, typename TJ>
__device__ __forceinline__ void add_row(float (&m)[R][NMAX], const float (&a)[R],
                                        const TJ* row, int n) {
  if (VEC == 2) {
#pragma unroll
    for (int c = 0; c < NMAX; c += 2) {
      if (c < n) {
        const float2 jv = ld2(row + c);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          m[r][c] = fmaf(a[r], jv.x, m[r][c]);
          m[r][c + 1] = fmaf(a[r], jv.y, m[r][c + 1]);
        }
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < NMAX; ++c) {
      if (c < n) {
        const float jv = ld1(row + c);
#pragma unroll
        for (int r = 0; r < R; ++r) m[r][c] = fmaf(a[r], jv, m[r][c]);
      }
    }
  }
}

// LAYOUT kFlat: out = sum_k tr(m_k^2); else out = tr(A^-1 L) - sum_k tr(m_k^2).
// In the flat and the square stage a determinant's down rows follow its up
// rows at the same stride; only the square split stage needs a jump between
// the two (an offset picked per row, so each row is loaded once).
template <typename TJ, int NMAX, int R, int VEC, int LAYOUT, bool SHIFT>
__global__ void __launch_bounds__(kStagedMaxThreads) fl_slogdet_staged_kernel(Params pr) {
  constexpr bool WITH_L = LAYOUT != kFlat;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int D = pr.D, K = pr.K, nu = pr.nu, nd = pr.nd, G = pr.G, S = pr.S;
  const int n = nu + nd, gn = G * n, ldx = n + 1;
  const StageRows sr = stage_rows(LAYOUT, nu, nd, G, SHIFT, kVec<TJ>);
  const int stage = sr.stage, s_row = sr.s_row;
  const int L = staged_lanes(n, R);
  const StagedLayout Lo = staged_layout(n, G, S, stage, (int)sizeof(TJ));
  TJ* ring = reinterpret_cast<TJ*>(sm);
  float *invt = sm + Lo.invt, *xm = sm + Lo.xm;
  const int groups = D / G;
  const int b = blockIdx.x / groups, d0 = (blockIdx.x % groups) * G;
  const int tid = threadIdx.x, T = blockDim.x;
  const int dl = tid / L, l = tid % L;  // determinant of the group, lane in it
  const bool act = dl < G;

  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + Lo.bar);
  init_ring(bars, S, SHIFT || pr.rb.vw == kVec<TJ>, T);
  // A^-1 of the group, transposed: invt[r][dl n + i] = A_dl^-1[i][r]
  const float* inv_g = pr.inv + ((long)b * D + d0) * n * n;
  if (n > kRegInvN)
    for (int e = tid; e < gn * n; e += T) invt[e] = __ldg(inv_g + (e % gn) * n + e / gn);
  __syncthreads();  // the mbarriers are initialised
  for (int k = 0; k < S - 1 && k < K; ++k)
    issue_stage<TJ, LAYOUT, SHIFT>(pr, sr, b, k, d0, ring + k * stage, bars + k, tid, T);
  uint32_t phase = 0;  // bit s: the parity of stage s's next fill

  const int dlc = act ? dl : 0;
  const float* xd = xm + dlc * n * ldx;  // the determinant's rows of m
  const int up_off = dlc * sr.s_up_d;  // row rr at up_off + rr s_row (+ jump if rr >= nu)
  const int2 sh = run_shifts<TJ, SHIFT>(pr, b, d0);
  const int jump =
      LAYOUT == kSquareSplit ? sr.s_dn + sh.y + dlc * sr.s_dn_d - nu * s_row - up_off - sh.x : 0;
  // small n: the lane's rows of A^-1 in registers for the whole block
  constexpr bool kRegInv = NMAX <= kRegInvN;
  float ainv[R][kRegInv ? NMAX : 1];
  if constexpr (kRegInv) {
    const float* inv_d = inv_g + dlc * n * n;
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < NMAX; ++c)
        ainv[r][c] = (l + L * r < n && c < n) ? __ldg(inv_d + (l + L * r) * n + c) : 0.f;
  }
  float trq_acc = 0.f;  // lane 0 of a determinant: sum_k tr(m_k^2)
  for (int k = 0; k < K; ++k) {
    const int sk = k % S;
    mbar_wait(bars + sk, (phase >> sk) & 1u);  // direction k has landed
    phase ^= 1u << sk;
    __syncthreads();  // ... and every thread is done with stage (k - 1) % S
    if (k + S - 1 < K) {
      const int s = (k + S - 1) % S;
      issue_stage<TJ, LAYOUT, SHIFT>(pr, sr, b, k + S - 1, d0, ring + s * stage, bars + s, tid,
                                     T);
    }
    // rows i = l + L r of m = A^-1 J_k in registers
    float m[R][NMAX];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < NMAX; ++c) m[r][c] = 0.f;
    const TJ* up = ring + sk * stage + up_off + sh.x;
    if constexpr (kRegInv) {
#pragma unroll
      for (int rr = 0; rr < NMAX; ++rr) {
        if (rr < n) {
          float a[R];
#pragma unroll
          for (int r = 0; r < R; ++r) a[r] = ainv[r][rr];
          add_row<NMAX, R, VEC, TJ>(m, a, up + rr * s_row + (rr < nu ? 0 : jump), n);
        }
      }
    } else {
      for (int rr = 0; rr < n; ++rr) {
        float a[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = l + L * r;
          a[r] = i < n ? invt[rr * gn + dlc * n + i] : 0.f;
        }
        add_row<NMAX, R, VEC, TJ>(m, a, up + rr * s_row + (rr < nu ? 0 : jump), n);
      }
    }
    // the rows meet in the determinant's part of xm (one warp: no block barrier)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = l + L * r;
      if (act && i < n) {
#pragma unroll
        for (int c = 0; c < NMAX; ++c)
          if (c < n) xm[(dlc * n + i) * ldx + c] = m[r][c];
      }
    }
    __syncwarp();
    float tr = 0.f, q = 0.f;  // the lane's rows: m[i][i] and sum_c m[i][c] m[c][i]
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = l + L * r;
      if (act && i < n) {
        float qr = 0.f;
#pragma unroll
        for (int c = 0; c < NMAX; ++c)
          if (c < n) qr = fmaf(m[r][c], xd[c * ldx + i], qr);
        tr += xd[i * ldx + i];
        q += qr;
      }
    }
    for (int o = L / 2; o > 0; o >>= 1) {
      tr += __shfl_xor_sync(0xffffffffu, tr, o);
      q += __shfl_xor_sync(0xffffffffu, q, o);
    }
    if (act && l == 0) {
      pr.jout[((long)b * K + k) * D + d0 + dl] = tr;
      trq_acc += q;
    }
    __syncwarp();  // the reads of xm end before the next direction's writes
  }
  float lin = 0.f;  // tr(A^-1 L) = sum_i sum_c A^-1[i][c] L[c][i], the lane's rows i
  if constexpr (WITH_L) {
    const float* l_d = pr.la + ((long)b * D + d0 + dlc) * n * n;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = l + L * r;
      if (act && i < n) {
        if constexpr (kRegInv) {
#pragma unroll
          for (int c = 0; c < NMAX; ++c)
            if (c < n) lin = fmaf(ainv[r][c], __ldg(l_d + c * n + i), lin);
        } else {
          for (int c = 0; c < n; ++c)
            lin = fmaf(invt[c * gn + dlc * n + i], __ldg(l_d + c * n + i), lin);
        }
      }
    }
    for (int o = L / 2; o > 0; o >>= 1) lin += __shfl_xor_sync(0xffffffffu, lin, o);
  }
  if (act && l == 0) pr.out[(long)b * D + d0 + dl] = WITH_L ? lin - trq_acc : trq_acc;
}

// ---- the tiled body (large n) ----

// Shared-memory plan of the tiled body, in floats: A^-1 transposed [n][np]
// (np = n rounded up to 4, zero columns beyond n), S stages of `stage`
// Jacobian elements of `jbytes` bytes and 4 floats of slack (a thread's last
// columns read up to 3 elements past a row's end), the tiles of m twice [np][64], m's diagonal twice [np], the warps'
// sums and the stages' mbarriers.  Row r of m keeps its float4 chunk q at
// chunk q ^ (r / 4 % 8) of a 64-float row, so the 8 threads of a quarter warp
// (consecutive tj) writing their tiles' rows meet 8 different bank groups,
// and so do those reading the rows of the transposed tiles where a thread's
// columns are 4 in a row.
constexpr int kTileLd = 64;

__device__ __forceinline__ int tile_at(int r, int col) {
  return r * kTileLd + 4 * ((col >> 2) ^ (r / 4 % 8)) + (col & 3);
}

struct TiledLayout {
  int np, ring, xm, diag, red, bar, total;
};

__host__ __device__ inline TiledLayout tiled_layout(int n, int S, int stage, int jbytes) {
  TiledLayout L;
  L.np = (n + 3) / 4 * 4;
  L.ring = n * L.np;
  L.xm = L.ring + S * stage * jbytes / 4 + 4;
  L.diag = L.xm + 2 * L.np * kTileLd;
  L.red = L.diag + 2 * L.np;
  L.bar = L.red + kTiledMaxThreads / 32;
  L.total = L.bar + 2 * S;
  return L;
}

__host__ __device__ inline int tiled_threads(int n) {
  const int nt = (n + 3) / 4;
  return (nt * nt + 31) / 32 * 32;
}

// Column q (0 .. 3) of thread tj's tile, of nt tiles a row: two pairs np / 2
// apart where a row of J is 8-byte aligned but not 16 (VEC 2), else 4 in a
// row.  With two floats a load the threads of a warp read a row of J without
// bank conflicts, where 11 tiles of 4 floats in a row would wrap the 32 banks
// (n = 42).
template <int VEC>
__device__ __forceinline__ int tile_col(int tj, int q, int nt) {
  return VEC == 2 ? 2 * tj + (q & 1) + (q >> 1) * 2 * nt : 4 * tj + q;
}

// acc += A^-1[rows 4 ti ..][c] (x) J[c][columns of tj] for c in [c0, c1): `a`
// points at column 4 ti of the transposed A^-1 (row stride np), `j` at row 0
// of the stage's block (row stride s_row).
template <int VEC, typename TJ>
__device__ __forceinline__ void tile_rows(float (&acc)[4][4], const float* a, const TJ* j,
                                          int tj, int nt, int c0, int c1, int np, int s_row) {
#pragma unroll 4
  for (int c = c0; c < c1; ++c) {
    const float4 av = *reinterpret_cast<const float4*>(a + c * np);
    const TJ* jr = j + c * s_row;
    float jv[4];
    if (VEC == 4) {
      const float4 t = ld4(jr + 4 * tj);
      jv[0] = t.x, jv[1] = t.y, jv[2] = t.z, jv[3] = t.w;
    } else if (VEC == 2) {
      const float2 t0 = ld2(jr + 2 * tj);
      const float2 t1 = ld2(jr + 2 * tj + 2 * nt);
      jv[0] = t0.x, jv[1] = t0.y, jv[2] = t1.x, jv[3] = t1.y;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) jv[q] = ld1(jr + 4 * tj + q);
    }
    const float ai[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(ai[i], jv[q], acc[i][q]);
  }
}

// LAYOUT kFlat: out = sum_k tr(m_k^2); else out = tr(A^-1 L) - sum_k tr(m_k^2).
// The float2 instance (n = 42) may take registers enough for one block an SM:
// ptxas otherwise holds it to 64 and spills.
template <typename TJ, int VEC, int LAYOUT, bool SHIFT>
__global__ void __launch_bounds__(kTiledMaxThreads, VEC == 2 ? 1 : 2)
    fl_slogdet_tiled_kernel(Params pr) {
  constexpr bool WITH_L = LAYOUT != kFlat;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int D = pr.D, K = pr.K, nu = pr.nu, nd = pr.nd, S = pr.S, n = nu + nd;
  const StageRows sr = stage_rows(LAYOUT, nu, nd, 1, SHIFT, kVec<TJ>);
  const int stage = sr.stage, s_row = sr.s_row;
  const TiledLayout Lo = tiled_layout(n, S, stage, (int)sizeof(TJ));
  const int np = Lo.np, nt = np / 4;
  TJ* ring = reinterpret_cast<TJ*>(sm + Lo.ring);
  float *at = sm, *xm = sm + Lo.xm, *diag = sm + Lo.diag, *red = sm + Lo.red;
  const int b = blockIdx.x / D, d = blockIdx.x % D;
  const int tid = threadIdx.x, T = blockDim.x;
  const int ti = tid / nt, tj = tid % nt;  // the tile: rows 4 ti .., columns tile_col(tj, .)
  const bool act = ti < nt;
  const long bd = (long)b * D + d;

  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + Lo.bar);
  init_ring(bars, S, SHIFT || pr.rb.vw == kVec<TJ>, T);
  // at[c][i] = A^-1[i][c], zero for n <= i < np
  const float* inv_d = pr.inv + bd * n * n;
  for (int e = tid; e < n * n; e += T) at[(e % n) * np + e / n] = __ldg(inv_d + e);
  for (int e = tid; e < n * (np - n); e += T) at[(e / (np - n)) * np + n + e % (np - n)] = 0.f;
  __syncthreads();  // A^-1 and the mbarriers are ready
  for (int k = 0; k < S - 1 && k < K; ++k)
    issue_stage<TJ, LAYOUT, SHIFT>(pr, sr, b, k, d, ring + k * stage, bars + k, tid, T);

  float part = 0.f;  // the thread's share of tr(A^-1 L): la[e] = L[c][i] at e = c n + i
  if constexpr (WITH_L) {
    const float* l_d = pr.la + bd * n * n;
    for (int e = tid; e < n * n; e += T)
      part = fmaf(at[(e / n) * np + e % n], __ldg(l_d + e), part);
  }
  int col[4];  // the thread's columns of m
#pragma unroll
  for (int q = 0; q < 4; ++q) col[q] = tile_col<VEC>(tj, q, nt);
  uint32_t phase = 0;  // bit s: the parity of stage s's next fill
  float acc[4][4];
  float q2 = 0.f;  // the thread's share of sum_k tr(m_k^2)
  const float* a = at + 4 * ti;
  const int2 sh = run_shifts<TJ, SHIFT>(pr, b, d);
  const int dn_off = sr.s_dn - nu * s_row;  // row c >= nu of the stage at dn_off + c s_row
  for (int k = 0; k <= K; ++k) {
    if (k < K) {
      const int sk = k % S;
      mbar_wait(bars + sk, (phase >> sk) & 1u);  // direction k has landed
      phase ^= 1u << sk;
    }
    // every thread is done with stage (k - 1) % S and has put direction
    // k - 1's tile into xm
    __syncthreads();
    if (k + S - 1 < K) {
      const int s = (k + S - 1) % S;
      issue_stage<TJ, LAYOUT, SHIFT>(pr, sr, b, k + S - 1, d, ring + s * stage, bars + s, tid, T);
    }
    if (k > 0) {  // the traces of direction k - 1
      const float* x = xm + ((k - 1) & 1) * np * kTileLd;
      if (act) {  // sum over the tile of m[i][c] m[c][i], m[c][i] from the transposed tile
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(x + tile_at(col[q], 4 * ti));
          const float vt[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (4 * ti + i < n && col[q] < n) q2 = fmaf(acc[i][q], vt[i], q2);
        }
      }
      if (tid < 32) {  // tr(m_{k-1}) from the diagonal, by warp 0
        float t = 0.f;
        for (int r = tid; r < n; r += 32) t += diag[((k - 1) & 1) * np + r];
        for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
        if (tid == 0) pr.jout[((long)b * K + k - 1) * D + d] = t;
      }
    }
    if (k == K) break;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
    if (act) {
      const TJ* st = ring + (k % S) * stage;
      tile_rows<VEC, TJ>(acc, a, st + sh.x, tj, nt, 0, nu, np, s_row);
      tile_rows<VEC, TJ>(acc, a, st + dn_off + sh.y, tj, nt, nu, n, np, s_row);
      float* x = xm + (k & 1) * np * kTileLd;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * ti + i;
#pragma unroll
        for (int q = 0; q < 4; ++q)  // the holder of m[r][r] puts it on the diagonal
          if (col[q] == r) diag[(k & 1) * np + r] = acc[i][q];
        if (VEC == 2) {
          *reinterpret_cast<float2*>(x + tile_at(r, col[0])) = make_float2(acc[i][0], acc[i][1]);
          *reinterpret_cast<float2*>(x + tile_at(r, col[2])) = make_float2(acc[i][2], acc[i][3]);
        } else {
          *reinterpret_cast<float4*>(x + tile_at(r, col[0])) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        }
      }
    }
  }
  // one block sum, in a fixed order
  float v = WITH_L ? part - q2 : q2;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (tid % 32 == 0) red[tid / 32] = v;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < T / 32; ++w) s += red[w];
    pr.out[bd] = s;
  }
}

// ---- launches ----

long smem_bytes(int body, int n, int G, int S, int stage, int jbytes) {
  const int floats = body == kTiled ? tiled_layout(n, S, stage, jbytes).total
                                    : staged_layout(n, G, S, stage, jbytes).total;
  return (long)floats * (long)sizeof(float);
}

template <typename TJ, int LAYOUT, bool SHIFT>
int launch_body(const Params& pr, int B, int body, long smem, cudaStream_t stream) {
  const RowBlocks& rb = pr.rb;
  const int n = pr.nu + pr.nd;
  const auto go = [&](auto kernel, int blocks, int threads) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks, threads, smem, stream>>>(pr);
    return (int)cudaGetLastError();
  };
  if (body == kTiled) {
    if (pr.G != 1) return (int)cudaErrorInvalidValue;
    const int blocks = B * pr.D, threads = tiled_threads(n);
    // a square layout's rows start at multiples of 4 (2) elements where n is
    // and so are the pointers (then so is every shift); flat rows are padded
    // to 16 bytes
    if (LAYOUT == kFlat || (n % 4 == 0 && rb.align >= 4))
      return go(fl_slogdet_tiled_kernel<TJ, 4, LAYOUT, SHIFT>, blocks, threads);
    if (n % 2 == 0 && rb.align >= 2)
      return go(fl_slogdet_tiled_kernel<TJ, 2, LAYOUT, SHIFT>, blocks, threads);
    return go(fl_slogdet_tiled_kernel<TJ, 1, LAYOUT, SHIFT>, blocks, threads);
  }
  if (body != kStaged || n > kStagedMaxN || pr.G * n > kStagedMaxThreads)
    return (int)cudaErrorInvalidValue;
  // two elements a load where every staged row starts at an even element: n
  // even (then so is every stage stride) and, in the square layouts, the
  // pointers aligned to two elements (then so is every shift)
  const bool even = n % 2 == 0 && (LAYOUT == kFlat || rb.align >= 2);
  const int blocks = B * (pr.D / pr.G);
#define FL_STAGED_CASE(N, R)                                                                  \
  if (n <= N) {                                                                               \
    const int threads = (pr.G * staged_lanes(n, R) + 31) / 32 * 32;                           \
    return even ? go(fl_slogdet_staged_kernel<TJ, N, R, 2, LAYOUT, SHIFT>, blocks, threads)   \
                : go(fl_slogdet_staged_kernel<TJ, N, R, 1, LAYOUT, SHIFT>, blocks, threads);  \
  }
  FL_STAGED_CASE(10, 3)  // H2O's 10 electrons: no padded columns
  FL_STAGED_CASE(16, 3)
  FL_STAGED_CASE(32, 2)
  FL_STAGED_CASE(48, 2)
#undef FL_STAGED_CASE
  return (int)cudaErrorInvalidValue;
}

template <typename TJ, int LAYOUT>
int launch(const Params& pr, int B, int body, cudaStream_t stream) {
  constexpr int V = kVec<TJ>;
  const RowBlocks& rb = pr.rb;
  const int n = pr.nu + pr.nd;
  const auto pow2_to_v = [](long x) { return x >= 1 && x <= V && (x & (x - 1)) == 0; };
  if (n < 1 || n > 64 || pr.nu < 0 || pr.nd < 0 || pr.K < 1 || pr.G < 1 || pr.D % pr.G ||
      pr.S < 2 || pr.S > 32 || rb.stage < 1 || !pow2_to_v(rb.vw) || !pow2_to_v(rb.align) ||
      (rb.shift && (LAYOUT == kFlat || rb.up_bk % V || rb.dn_bk % V)))
    return (int)cudaErrorInvalidValue;
  const StageRows sr = stage_rows(LAYOUT, pr.nu, pr.nd, pr.G, rb.shift, V);
  if (rb.s_up_d != sr.s_up_d || rb.s_dn != sr.s_dn || rb.s_dn_d != sr.s_dn_d ||
      rb.s_row != sr.s_row || rb.stage != sr.stage)
    return (int)cudaErrorInvalidValue;
  const long smem = smem_bytes(body, n, pr.G, pr.S, sr.stage, (int)sizeof(TJ));
  if constexpr (LAYOUT != kFlat)
    if (rb.shift) return launch_body<TJ, LAYOUT, true>(pr, B, body, smem, stream);
  return launch_body<TJ, LAYOUT, false>(pr, B, body, smem, stream);
}

int body_of(int layout, int n) {
  return n > (layout == kFlat ? kFlatMaxN : kSquareMaxN) ? kTiled : kStaged;
}

}  // namespace

// The source is compiled twice, by two nvcc processes at once (ops/_cuda.py):
// FL_SLOGDET_PART 1 instantiates the bf16 kernels behind one internal entry,
// part 0 the float ones and the library's entries.
#ifndef FL_SLOGDET_PART
#define FL_SLOGDET_PART 0
#endif

extern "C" int fl_slogdet_bf16_launch(int layout, const void* params, int B, int body,
                                      void* stream);

#if FL_SLOGDET_PART == 1

extern "C" int fl_slogdet_bf16_launch(int layout, const void* params, int B, int body,
                                      void* stream) {
  const Params& pr = *static_cast<const Params*>(params);
  const cudaStream_t st = (cudaStream_t)stream;
  if (layout == kFlat) return launch<__nv_bfloat16, kFlat>(pr, B, body, st);
  if (layout == kSquare) return launch<__nv_bfloat16, kSquare>(pr, B, body, st);
  return launch<__nv_bfloat16, kSquareSplit>(pr, B, body, st);
}

#else

namespace {

// jdtype: the Jacobian's element type, 0 float, 1 bf16
template <int LAYOUT>
int launch_typed(const Params& pr, int B, int body, int jdtype, cudaStream_t stream) {
  if (jdtype == 0) return launch<float, LAYOUT>(pr, B, body, stream);
  if (jdtype == 1) return fl_slogdet_bf16_launch(LAYOUT, &pr, B, body, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The body a launch of `layout` takes at n electrons (Body: 0 staged, 1 tiled).
int fl_slogdet_body(int layout, int n) { return body_of(layout, n); }

// Shared-memory bytes of a block of `body` with G determinants, S stages of
// `stage` Jacobian elements of `jbytes` bytes.
long fl_slogdet_smem_bytes(int body, int n, int G, int S, long stage, int jbytes) {
  return smem_bytes(body, n, G, S, (int)stage, jbytes);
}

// Each entry: body < 0 takes the body by n; G divides D (1 for the tiled
// body), 2 <= S <= 32; jdtype the Jacobian's element type (0 float, 1 bf16);
// `rows` points at the layout record (RowBlocks) of a block of G determinants,
// in elements of that type.
//
// Kernel 2: flat row blocks; trq = sum_k tr(m_k^2).
int fl_slogdet_traces_launch(const float* inv, const void* ju, const void* jd, float* jout,
                             float* trq, int B, int D, int K, int nu, int nd, int body, int G,
                             int S, int jdtype, const void* rows, void* stream) {
  const Params pr{inv, ju, jd, nullptr, jout, trq, D, K, nu, nd, G, S,
                  *static_cast<const RowBlocks*>(rows)};
  return launch_typed<kFlat>(pr, B, body < 0 ? body_of(kFlat, nu + nd) : body, jdtype,
                             (cudaStream_t)stream);
}

// Kernel 3: the square Jacobian [B, K, D, n, n] whole; lout with tr(A^-1 L).
int fl_slogdet_square_launch(const float* inv, const void* ja, const float* la, float* jout,
                             float* lout, int B, int D, int K, int n, int body, int G, int S,
                             int jdtype, const void* rows, void* stream) {
  const Params pr{inv, ja, ja, la, jout, lout, D, K, n, 0, G, S,
                  *static_cast<const RowBlocks*>(rows)};
  return launch_typed<kSquare>(pr, B, body < 0 ? body_of(kSquare, n) : body, jdtype,
                               (cudaStream_t)stream);
}

// Kernel 4: the square Jacobian in row blocks [B, K, D, nu, n], [B, K, D, nd, n].
int fl_slogdet_square_split_launch(const float* inv, const void* ju, const void* jd,
                                   const float* la, float* jout, float* lout, int B, int D,
                                   int K, int nu, int nd, int body, int G, int S, int jdtype,
                                   const void* rows, void* stream) {
  const Params pr{inv, ju, jd, la, jout, lout, D, K, nu, nd, G, S,
                  *static_cast<const RowBlocks*>(rows)};
  return launch_typed<kSquareSplit>(pr, B, body < 0 ? body_of(kSquareSplit, nu + nd) : body,
                                    jdtype, (cudaStream_t)stream);
}

}  // extern "C"

#endif  // FL_SLOGDET_PART

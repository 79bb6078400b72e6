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
// Layouts (f32, contiguous): inv [B, D, n, n]; jout [B, K, D]; out [B, D];
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
// Kernel 2 (`fl_slogdet_flat_kernel`).  In the flat layout direction k's rows
// of walker b are two contiguous runs, nu D n floats in ju and nd D n in jd.
// One block takes a walker and a group of G determinants (all D at n = 10;
// fewer at large n, so that the block stays at most 256 threads and the grid
// fills the card).  A ring of 3 stages (the wrapper's FLAT_STAGES), each one
// direction's rows restricted to the group's G n columns, is filled two
// directions ahead by TMA copies (`cp.async.bulk`) completing on the stage's
// mbarrier: one copy each for the up and the down run when the group holds
// every determinant, else one a row; 4-byte `cp.async` copies where the rows
// are not 16-byte aligned.  A determinant's rows of m = A_d^-1 J_{k,d} are
// formed by L lanes of one warp, R rows a lane (rows l, l + L, ...; L = 4,
// R = 3 at n = 10) in registers, so a staged row J[r][:] loaded once serves R
// rows of m; up to n = 16 a lane also keeps its rows of A^-1 in registers
// (beyond, A^-1 sits transposed in shared memory), and n = 10 has its own
// instance with no padded columns.  The rows of m meet in the warp's part of
// shared memory (a warp barrier, not a block one); each lane forms m[i][i]
// and sum_c m[i][c] m[c][i] of its rows, the L lanes sum them by shuffles,
// and the determinant's first lane writes tr(m_k) and adds tr(m_k^2) to its
// sum over k.  One block barrier a direction (the stage has landed; the
// stage before it is free for the next copy).  No atomics: two launches give
// bitwise-equal results.  On the card what holds it is latency with few
// blocks per SM, so the plan keeps shared memory small; above n = 48
// (kFlatMaxN) the launch takes the body of kernels 3 and 4 instead.
//
// Kernels 3 and 4 (`fl_slogdet_kernel`): one block per (walker, determinant)
// with A_d^-1 in shared memory.  One thread per (direction k, row i) forms row
// i of m_k in registers, reading the rows of J_{k,d} from global memory (the n
// threads of one direction read the same rows, so the loads broadcast); the
// rows of m meet in shared memory for tr(m_k) and tr(m_k^2).  m never reaches
// HBM.  At n = 64 a round takes 5 directions and the 64-float row may spill to
// local memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 320;
constexpr int kWarps = kThreads / 32;

__host__ __device__ inline int dirs_per_round(int n) { return kThreads / n; }

__host__ __device__ inline long smem_floats(int n) {
  const long kr = dirs_per_round(n);
  return (long)n * n + kr * n * (n + 1) + 2 * kr * n + kWarps;
}

// Where the rows of J_{k,d} lie: block (b, k, d) of the up rows starts at
// ju + (b * K + k) * up_bk + d * up_d, the down rows likewise, and row r of a
// block at r * row.
struct RowBlocks {
  long up_bk, up_d, dn_bk, dn_d, row;
};

__device__ inline float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

// Kernels 3 and 4.  WITH_L: out = tr(A^-1 L) - trq; else out = trq.
template <int NMAX, bool WITH_L>
__global__ void __launch_bounds__(kThreads) fl_slogdet_kernel(
    const float* __restrict__ inv, const float* __restrict__ ju,
    const float* __restrict__ jd, const float* __restrict__ la,
    float* __restrict__ jout, float* __restrict__ out, int D, int K, int nu,
    int nd, RowBlocks g) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / D;
  const int d = blockIdx.x % D;
  const int n = nu + nd;
  const int ld = n + 1;
  const int kr = dirs_per_round(n);
  const int tid = threadIdx.x;

  float* a = smem;                // [n][n]        A_d^-1
  float* m = a + n * n;           // [kr][n][ld]   rows of m_k
  float* diag = m + kr * n * ld;  // [kr * n]      m_k[i][i]
  float* part = diag + kr * n;    // [kr * n]      sum_c m_k[i][c] m_k[c][i]
  float* red = part + kr * n;     // [kWarps]      warp sums

  const long bd = (long)b * D + d;
  const float* inv_bd = inv + bd * n * n;
  for (int e = tid; e < n * n; e += kThreads) a[e] = inv_bd[e];
  __syncthreads();

  // tr(A^-1 L) = sum_{j,i} A^-1[i][j] L[j][i], each thread a share of it
  float acc = 0.f;
  if (WITH_L) {
    const float* l_bd = la + bd * n * n;
    for (int e = tid; e < n * n; e += kThreads)
      acc = fmaf(a[(e % n) * n + e / n], __ldg(l_bd + e), acc);
  }

  const int slot = tid / n, i = tid % n;
  float trq_acc = 0.f;  // threads with tid < kr: their direction slot's sum
  for (int k0 = 0; k0 < K; k0 += kr) {
    const int k = k0 + slot;
    const bool active = slot < kr && k < K;
    if (active) {
      float row[NMAX];
#pragma unroll
      for (int c = 0; c < NMAX; ++c) row[c] = 0.f;
      const long bk = (long)b * K + k;
      const float* up = ju + bk * g.up_bk + d * g.up_d;
      const float* dn = nd ? jd + bk * g.dn_bk + d * g.dn_d : nullptr;
      for (int r = 0; r < n; ++r) {
        const float air = a[i * n + r];
        const float* src = r < nu ? up + r * g.row : dn + (r - nu) * g.row;
#pragma unroll
        for (int c = 0; c < NMAX; ++c)
          if (c < n) row[c] = fmaf(air, __ldg(src + c), row[c]);
      }
      float dg = 0.f;
#pragma unroll
      for (int c = 0; c < NMAX; ++c) {
        if (c < n) {
          m[(slot * n + i) * ld + c] = row[c];
          if (c == i) dg = row[c];
        }
      }
      diag[tid] = dg;
    }
    __syncthreads();
    if (active) {
      const float* mk = m + slot * n * ld;
      float q = 0.f;
      for (int c = 0; c < n; ++c) q = fmaf(mk[i * ld + c], mk[c * ld + i], q);
      part[tid] = q;
    }
    __syncthreads();
    if (tid < kr && k0 + tid < K) {
      float tr = 0.f, q = 0.f;
      for (int r = 0; r < n; ++r) {
        tr += diag[tid * n + r];
        q += part[tid * n + r];
      }
      jout[((long)b * K + k0 + tid) * D + d] = tr;
      trq_acc += q;
    }
    __syncthreads();
  }
  const float s = block_sum(WITH_L ? acc - trq_acc : trq_acc, red);
  if (tid == 0) out[bd] = s;
}

template <int NMAX, bool WITH_L>
int launch(const float* inv, const float* ju, const float* jd, const float* la,
           float* jout, float* out, int B, int D, int K, int nu, int nd,
           RowBlocks g, cudaStream_t stream) {
  const long smem = smem_floats(nu + nd) * (long)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fl_slogdet_kernel<NMAX, WITH_L>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fl_slogdet_kernel<NMAX, WITH_L><<<B * D, kThreads, smem, stream>>>(
      inv, ju, jd, la, jout, out, D, K, nu, nd, g);
  return (int)cudaGetLastError();
}

template <bool WITH_L>
int dispatch(const float* inv, const float* ju, const float* jd,
             const float* la, float* jout, float* out, int B, int D, int K,
             int nu, int nd, RowBlocks g, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int n = nu + nd;
  if (n < 1 || nu < 0 || nd < 0) return (int)cudaErrorInvalidValue;
#define FL_SLOGDET_CASE(N)                                                  \
  if (n <= N)                                                               \
    return launch<N, WITH_L>(inv, ju, jd, la, jout, out, B, D, K, nu, nd, g, \
                             s);
  FL_SLOGDET_CASE(4)
  FL_SLOGDET_CASE(8)
  FL_SLOGDET_CASE(12)
  FL_SLOGDET_CASE(16)
  FL_SLOGDET_CASE(32)
  FL_SLOGDET_CASE(64)
#undef FL_SLOGDET_CASE
  return (int)cudaErrorInvalidValue;
}


// ---- kernel 2: flat row blocks through a copy ring ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
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
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

constexpr int kFlatMaxThreads = 256;
// Above this n kernel 2 runs the body of kernels 3 and 4 instead: a direction's
// staged rows (16 KB a determinant at n = 64) leave two blocks of one warp on
// an SM, and the body that reads its rows from global memory through L1 is
// faster there (6.6-6.8 ms against 9.2 ms at n = 64 on an H100; slower at
// n = 42, 22.6 against 17.3 ms; chip_smoke.py, PERF.md).
constexpr int kFlatMaxN = 48;
constexpr int kRegInvN = 16;  // up to this n a lane keeps its rows of A^-1 in registers

// Rows of m a lane of kernel 2 forms (R) and the largest n it takes (NMAX):
// a determinant's rows i = l + L r (r < R) lie on L = lanes(n, R) lanes of one
// warp, a power of 2 at most 32.
__host__ __device__ inline int flat_lanes(int n, int R) {
  int l = 1;
  while (l * R < n) l <<= 1;
  return l;
}

// Shared-memory plan of kernel 2, in floats: S stages [n][ldr] (ldr = G n
// rounded up to 4), A^-1 transposed [n][G n] (n > kRegInvN only: below, the
// lanes keep their rows of A^-1 in registers), the rows of m [G n][n + 1] and
// the stages' mbarriers (8 bytes each).
struct FlatLayout {
  int ldr, stage, invt, xm, bar, total;
};

__host__ __device__ inline FlatLayout flat_layout(int n, int G, int S) {
  FlatLayout L;
  const int gn = G * n;
  L.ldr = (gn + 3) / 4 * 4;
  L.stage = n * L.ldr;
  L.invt = S * L.stage;
  L.xm = L.invt + (n > kRegInvN ? n * gn : 0);
  L.bar = (L.xm + gn * (n + 1) + 1) / 2 * 2;
  L.total = L.bar + 2 * S;
  return L;
}

struct FlatParams {
  const float *inv, *ju, *jd;
  float *jout, *trq;
  int D, K, nu, nd, G, S;
  bool bulk;  // rows and pointers 16-byte aligned: TMA copies, else 4-byte cp.async
};

// m[r][:] += a[r] J[rr][:] for one staged row J[rr][:] of a determinant
template <int NMAX, int R, int VEC>
__device__ __forceinline__ void add_row(float (&m)[R][NMAX], const float (&a)[R],
                                        const float* row, int n) {
  if (VEC == 2) {
#pragma unroll
    for (int c = 0; c < NMAX; c += 2) {
      if (c < n) {
        const float2 jv = *reinterpret_cast<const float2*>(row + c);
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
        const float jv = row[c];
#pragma unroll
        for (int r = 0; r < R; ++r) m[r][c] = fmaf(a[r], jv, m[r][c]);
      }
    }
  }
}

template <int NMAX, int R, int VEC>
__global__ void __launch_bounds__(kFlatMaxThreads) fl_slogdet_flat_kernel(FlatParams pr) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int D = pr.D, K = pr.K, nu = pr.nu, nd = pr.nd, G = pr.G, S = pr.S;
  const int n = nu + nd, gn = G * n, ldx = n + 1;
  const int L = flat_lanes(n, R);
  const FlatLayout Lo = flat_layout(n, G, S);
  float *ring = sm, *invt = sm + Lo.invt, *xm = sm + Lo.xm;
  const int groups = D / G;
  const int b = blockIdx.x / groups, d0 = (blockIdx.x % groups) * G;
  const int tid = threadIdx.x, T = blockDim.x;
  const int dl = tid / L, l = tid % L;  // determinant of the group, lane in it
  const bool act = dl < G;
  const long Dn = (long)D * n;

  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + Lo.bar);
  // direction k's rows of the group into stage k % S: one TMA copy for each of
  // the up and the down block when the group holds every determinant (their
  // rows are then one run each), else one a row, or, where the rows are not
  // 16-byte aligned, 4-byte cp.async copies by every thread; each completing
  // on the stage's mbarrier
  const auto issue = [&](int k) {
    float* dst = ring + (k % S) * Lo.stage;
    uint64_t* bar = bars + k % S;
    const float* up = pr.ju + ((long)b * K + k) * nu * Dn + d0 * n;
    const float* dn = pr.jd + ((long)b * K + k) * nd * Dn + d0 * n;
    if (pr.bulk) {
      if (tid == 0) mbar_expect(bar, 4u * gn * n);
      if (gn == Dn) {
        if (tid == 0) bulk_copy(dst, up, 4u * gn * nu, bar);
        if (tid == (T > 32 ? 32 : 1) && nd) bulk_copy(dst + nu * Lo.ldr, dn, 4u * gn * nd, bar);
      } else {
        for (int r = tid; r < n; r += T)
          bulk_copy(dst + r * Lo.ldr, r < nu ? up + r * Dn : dn + (r - nu) * Dn, 4u * gn, bar);
      }
    } else {
      for (int e = tid; e < n * gn; e += T) {
        const int r = e / gn, c = e % gn;
        cp_async4(dst + r * Lo.ldr + c, (r < nu ? up + r * Dn : dn + (r - nu) * Dn) + c);
      }
      cp_async_arrive(bar);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(bars + s, pr.bulk ? 1 : T);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // A^-1 of the group, transposed: invt[r][dl n + i] = A_dl^-1[i][r]
  const float* inv_g = pr.inv + ((long)b * D + d0) * n * n;
  if (n > kRegInvN)
    for (int e = tid; e < gn * n; e += T) invt[e] = __ldg(inv_g + (e % gn) * n + e / gn);
  __syncthreads();  // the mbarriers are initialised
  for (int k = 0; k < S - 1 && k < K; ++k) issue(k);
  uint32_t phase = 0;  // bit s: the parity of stage s's next fill

  const int dlc = act ? dl : 0;
  const float* xd = xm + dlc * n * ldx;  // the determinant's rows of m
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
    if (k + S - 1 < K) issue(k + S - 1);
    // rows i = l + L r of m = A^-1 J_k in registers
    float m[R][NMAX];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < NMAX; ++c) m[r][c] = 0.f;
    const float* st = ring + (k % S) * Lo.stage + dlc * n;
    if constexpr (kRegInv) {
#pragma unroll
      for (int rr = 0; rr < NMAX; ++rr) {
        if (rr < n) {
          float a[R];
#pragma unroll
          for (int r = 0; r < R; ++r) a[r] = ainv[r][rr];
          add_row<NMAX, R, VEC>(m, a, st + rr * Lo.ldr, n);
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
        add_row<NMAX, R, VEC>(m, a, st + rr * Lo.ldr, n);
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
  if (act && l == 0) pr.trq[(long)b * D + d0 + dl] = trq_acc;
}

template <int NMAX, int R, int VEC>
int launch_flat(const FlatParams& pr, int B, cudaStream_t stream) {
  const int n = pr.nu + pr.nd;
  const long smem = (long)flat_layout(n, pr.G, pr.S).total * (long)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fl_slogdet_flat_kernel<NMAX, R, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = (pr.G * flat_lanes(n, R) + 31) / 32 * 32;
  fl_slogdet_flat_kernel<NMAX, R, VEC><<<B * (pr.D / pr.G), threads, smem, stream>>>(pr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

long fl_slogdet_square_smem_bytes(int n) { return smem_floats(n) * (long)sizeof(float); }
long fl_slogdet_square_split_smem_bytes(int n) { return fl_slogdet_square_smem_bytes(n); }

// Kernel 2: shared-memory bytes of a block of G determinants and S stages.
long fl_slogdet_traces_smem_bytes(int n, int G, int S) {
  return (long)flat_layout(n, G, S).total * (long)sizeof(float);
}

// Kernel 2: flat row blocks; trq = sum_k tr(m_k^2).  G divides D, G n <= 256,
// S >= 3 (the wrapper picks them).
int fl_slogdet_traces_launch(const float* inv, const float* ju, const float* jd,
                             float* jout, float* trq, int B, int D, int K,
                             int nu, int nd, int G, int S, void* stream) {
  const int n = nu + nd;
  if (n > kFlatMaxN) {  // the body of kernels 3 and 4 (G, S unused): see the note above
    const long Dn = (long)D * n;
    const RowBlocks g{nu * Dn, n, nd * Dn, n, Dn};
    return dispatch<false>(inv, ju, jd, nullptr, jout, trq, B, D, K, nu, nd, g, stream);
  }
  if (n < 1 || nu < 0 || nd < 0 || G < 1 || D % G || G * n > kFlatMaxThreads || S < 3 ||
      S > 32 || K < 1)
    return (int)cudaErrorInvalidValue;
  const auto aligned = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  const bool bulk = (D * n) % 4 == 0 && (G * n) % 4 == 0 && aligned(ju) &&
                    (nd == 0 || aligned(jd));
  const FlatParams pr{inv, ju, jd, jout, trq, D, K, nu, nd, G, S, bulk};
  const cudaStream_t s = (cudaStream_t)stream;
  const bool even = n % 2 == 0;
#define FL_FLAT_CASE(N, R)                                                         \
  if (n <= N)                                                                      \
    return even ? launch_flat<N, R, 2>(pr, B, s) : launch_flat<N, R, 1>(pr, B, s);
  FL_FLAT_CASE(10, 3)  // H2O's 10 electrons: no padded columns
  FL_FLAT_CASE(16, 3)
  FL_FLAT_CASE(32, 2)
  FL_FLAT_CASE(48, 2)  // benzene's 42
#undef FL_FLAT_CASE
  return (int)cudaErrorInvalidValue;
}

// Kernel 3: the square Jacobian [B, K, D, n, n] whole; lout with tr(A^-1 L).
int fl_slogdet_square_launch(const float* inv, const float* ja, const float* la,
                             float* jout, float* lout, int B, int D, int K,
                             int n, void* stream) {
  const RowBlocks g{(long)D * n * n, (long)n * n, 0, 0, n};
  return dispatch<true>(inv, ja, nullptr, la, jout, lout, B, D, K, n, 0, g,
                        stream);
}

// Kernel 4: the square Jacobian in row blocks [B, K, D, nu, n], [B, K, D, nd, n].
int fl_slogdet_square_split_launch(const float* inv, const float* ju,
                                   const float* jd, const float* la,
                                   float* jout, float* lout, int B, int D,
                                   int K, int nu, int nd, void* stream) {
  const long n = nu + nd;
  const RowBlocks g{D * nu * n, nu * n, D * nd * n, nd * n, n};
  return dispatch<true>(inv, ju, jd, la, jout, lout, B, D, K, nu, nd, g,
                        stream);
}

}  // extern "C"

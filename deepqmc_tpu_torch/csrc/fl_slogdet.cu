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
// The kernel reads each layout in place through the strides of `RowBlocks`:
// the TPU's `rearrange_dirs` transpose, its transposed inverse `invt` and its
// pre-split column halves of A^-1 existed for Mosaic's lane layout and have no
// use here.  nd = 0 is allowed: the down block is then never read.  Requires
// n <= 64 (the wrappers check).
//
// What bounds it: bytes.  The Jacobian is read once (about 0.4 GB per call for
// the H2O PsiFormer at B = 2048) against about n flops per byte.  Design: one
// block per (walker, determinant) with A_d^-1 in shared memory.  One thread
// per (direction k, row i) forms row i of m_k = A_d^-1 J_{k,d} in registers,
// reading the rows of J_{k,d} from global memory (the n threads of one
// direction read the same rows, so the loads broadcast); the rows of m meet in
// shared memory for tr(m_k) and tr(m_k^2).  m never reaches HBM.  At n = 64 a
// round takes 5 directions and the 64-float row may spill to local memory.

#include <cuda_runtime.h>

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

// WITH_L: out = tr(A^-1 L) - trq; else out = trq.
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

}  // namespace

extern "C" {

long fl_slogdet_smem_bytes(int n) { return smem_floats(n) * (long)sizeof(float); }
long fl_slogdet_square_smem_bytes(int n) { return fl_slogdet_smem_bytes(n); }
long fl_slogdet_square_split_smem_bytes(int n) { return fl_slogdet_smem_bytes(n); }

// Kernel 2: flat row blocks; trq = sum_k tr(m_k^2).
int fl_slogdet_traces_launch(const float* inv, const float* ju, const float* jd,
                             float* jout, float* trq, int B, int D, int K,
                             int nu, int nd, void* stream) {
  const long n = nu + nd, Dn = (long)D * n;
  const RowBlocks g{nu * Dn, n, nd * Dn, n, Dn};
  return dispatch<false>(inv, ju, jd, nullptr, jout, trq, B, D, K, nu, nd, g,
                         stream);
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

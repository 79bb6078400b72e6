// Forward-Laplacian log-determinant traces on the flat, row-split layout.
//
// Replaces the TPU kernel deepqmc_tpu/ops/fl_slogdet.py
// `_pallas_blocked_flat_split` (kernel body `_flat_split_kernel`).  Plain
// twin: deepqmc_tpu_torch/ops/fl_slogdet.py `slogdet_traces_plain`.
//
// For each walker b and determinant d, with A_d^-1 = inv[b, d] and the
// Jacobian J_{k,d} = rows [ju[b, k]; jd[b, k]] of columns d*n .. d*n+n-1:
//   jout[b, k, d] = tr(A_d^-1 J_{k,d})
//   trq[b, d]     = sum_k tr((A_d^-1 J_{k,d})^2)
// The caller forms the Laplacian tr(A^-1 L) - trq outside the kernel.
//
// Layouts (f32, contiguous): inv [B, D, n, n]; ju [B, K, nu, D*n];
// jd [B, K, nd, D*n]; jout [B, K, D]; trq [B, D].  Requires n <= 32 (the
// wrapper checks).  ju and jd are read in the port's own layout through
// strides: the TPU kernel's `rearrange_dirs` transpose existed for Mosaic's
// lane layout and has no use here.
//
// What bounds it: bytes.  ju and jd are read once (about 0.4 GB per call for
// the H2O PsiFormer at B = 2048) against about n flops per byte.  Design: one
// block per (walker, determinant) with A_d^-1 in shared memory.  One thread
// per (direction k, row i) forms row i of m_k = A_d^-1 J_{k,d} in registers,
// reading the rows of J_{k,d} from global memory (the n threads of one
// direction read the same rows, so the loads broadcast); the rows of m meet in
// shared memory for tr(m_k) and tr(m_k^2).  m never reaches HBM.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 320;

__host__ __device__ inline int dirs_per_round(int n) { return kThreads / n; }

__host__ __device__ inline long smem_floats(int n) {
  const long kr = dirs_per_round(n);
  return (long)n * n + kr * n * (n + 1) + 2 * kr * n + kThreads;
}

template <int NMAX>
__global__ void __launch_bounds__(kThreads) fl_slogdet_traces_kernel(
    const float* __restrict__ inv, const float* __restrict__ ju,
    const float* __restrict__ jd, float* __restrict__ jout,
    float* __restrict__ trq, int D, int K, int nu, int nd) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / D;
  const int d = blockIdx.x % D;
  const int n = nu + nd;
  const int ld = n + 1;
  const int kr = dirs_per_round(n);
  const int tid = threadIdx.x;
  const long Dn = (long)D * n;

  float* a = smem;              // [n][n]        A_d^-1
  float* m = a + n * n;         // [kr][n][ld]   rows of m_k
  float* diag = m + kr * n * ld;  // [kr * n]    m_k[i][i]
  float* part = diag + kr * n;  // [kr * n]      sum_c m_k[i][c] m_k[c][i]
  float* red = part + kr * n;   // [kThreads]    per-thread trq sums

  const float* inv_bd = inv + ((long)b * D + d) * n * n;
  for (int e = tid; e < n * n; e += kThreads) a[e] = inv_bd[e];
  __syncthreads();

  const int slot = tid / n, i = tid % n;
  float trq_acc = 0.f;  // threads with tid < kr: their direction slot's sum
  for (int k0 = 0; k0 < K; k0 += kr) {
    const int k = k0 + slot;
    const bool active = slot < kr && k < K;
    if (active) {
      float row[NMAX];
#pragma unroll
      for (int c = 0; c < NMAX; ++c) row[c] = 0.f;
      const float* up = ju + ((long)b * K + k) * nu * Dn + (long)d * n;
      const float* dn = jd + ((long)b * K + k) * nd * Dn + (long)d * n;
      for (int r = 0; r < n; ++r) {
        const float air = a[i * n + r];
        const float* src = r < nu ? up + r * Dn : dn + (r - nu) * Dn;
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
  red[tid] = trq_acc;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int r = 0; r < kr; ++r) s += red[r];
    trq[(long)b * D + d] = s;
  }
}

template <int NMAX>
int launch(const float* inv, const float* ju, const float* jd, float* jout,
           float* trq, int B, int D, int K, int nu, int nd, cudaStream_t stream) {
  const long smem = smem_floats(nu + nd) * (long)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fl_slogdet_traces_kernel<NMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fl_slogdet_traces_kernel<NMAX><<<B * D, kThreads, smem, stream>>>(
      inv, ju, jd, jout, trq, D, K, nu, nd);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

long fl_slogdet_smem_bytes(int n) { return smem_floats(n) * (long)sizeof(float); }

int fl_slogdet_traces_launch(const float* inv, const float* ju, const float* jd,
                             float* jout, float* trq, int B, int D, int K,
                             int nu, int nd, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int n = nu + nd;
  if (n < 1) return (int)cudaErrorInvalidValue;
  if (n <= 4) return launch<4>(inv, ju, jd, jout, trq, B, D, K, nu, nd, s);
  if (n <= 8) return launch<8>(inv, ju, jd, jout, trq, B, D, K, nu, nd, s);
  if (n <= 12) return launch<12>(inv, ju, jd, jout, trq, B, D, K, nu, nd, s);
  if (n <= 16) return launch<16>(inv, ju, jd, jout, trq, B, D, K, nu, nd, s);
  if (n <= 32) return launch<32>(inv, ju, jd, jout, trq, B, D, K, nu, nd, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

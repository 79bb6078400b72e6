// Forward-Laplacian attention core: (t, J_t, L_t) of softmax(q k^T / sqrt(dh)) v.
//
// Replaces the TPU kernel deepqmc_tpu/ops/fl_attention.py `_pallas_blocked`
// (kernel body `_kernel`, default head body `_make_head_fn`).  Plain twin:
// deepqmc_tpu_torch/ops/fl_attention.py `mha_core_fl_plain`.
//
// Layouts (f32, contiguous): primals q, k, v, Lq, Lk, Lv and outputs t, Lt are
// [B, n, H, dh]; Jacobians Jq, Jk, Jv and the output Jt are [B, K, n, H, dh].
// Requires dh % 4 == 0 and n <= 32 (the wrapper checks both).
//
// What bounds it: bytes.  Each Jacobian is read from HBM once and Jt written
// once (about 2.7 GB per call for the H2O PsiFormer at B = 2048) against
// about 8 flops per Jacobian byte.  Design: one block per (walker, head).
// The head's primal and Laplacian [n, dh] tiles sit in shared memory; the
// logits Jacobian Jz (overwritten in place by the softmax Jacobian Ja),
// [K, n, n], stays in shared memory for the whole block.
//  - Pass 1: one thread per (direction k, row i) keeps the row's n logits
//    Jacobians and n cross products sum_d Jq_k[i] Jk_k[j] in registers; it
//    streams its Jq row and the direction's Jk rows straight from global
//    memory as float4 (the Jk rows are shared by the n threads of one
//    direction, so the loads broadcast), and the primal rows from shared
//    memory.
//  - The softmax forward Laplacian (fl_attention._softmax_fl) in shared memory.
//  - Pass 2: Jv streams through a shared-memory window of kc directions; one
//    thread per (direction parity, row pair, column pair) forms
//    Jt_k = Ja_k v + a Jv_k for its 2 x 2 outputs and accumulates
//    sum_k Ja_k Jv_k in registers; the two parities meet in shared memory for
//    t and Lt.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 320;

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

struct Layout {
  int ldt, nn, tile, scratch;
};

__host__ __device__ inline Layout layout(int K, int n, int dh, int kc) {
  Layout L;
  L.ldt = dh + 4;  // row stride of the [n, dh] tiles: float4 aligned, banks shifted
  L.nn = n * n;
  L.tile = n * L.ldt;
  int s = K * L.nn;                        // pass 1: cross products per direction
  if (kc * n * dh > s) s = kc * n * dh;    // pass 2: the Jv window
  if (2 * n * dh > s) s = 2 * n * dh;      // the two parities' cross terms
  L.scratch = (s + 3) / 4 * 4;
  return L;
}

__host__ __device__ inline long smem_floats(int K, int n, int dh, int kc) {
  const Layout L = layout(K, n, dh, kc);
  return 6L * L.tile + L.scratch + (long)K * L.nn + 3L * L.nn + (long)K * n + 3L * n;
}

template <int NMAX>
__global__ void __launch_bounds__(kThreads, 3) fl_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ jq,
    const float* __restrict__ jk, const float* __restrict__ jv,
    const float* __restrict__ lq, const float* __restrict__ lk,
    const float* __restrict__ lv, float* __restrict__ t,
    float* __restrict__ jt, float* __restrict__ lt, int K, int n, int H,
    int dh, int kc) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const Layout L = layout(K, n, dh, kc);
  const int ldt = L.ldt, nn = L.nn, dq = dh / 4;
  const float scale = 1.0f / sqrtf((float)dh);

  float* sq = smem;
  float* sk = sq + L.tile;
  float* sv = sk + L.tile;
  float* slq = sv + L.tile;
  float* slk = slq + L.tile;
  float* slv = slk + L.tile;
  float* scr = slv + L.tile;     // cross products / Jv window / parity cross terms
  float* sjz = scr + L.scratch;  // [K][n][n]: Jz, then Ja
  float* sz = sjz + K * nn;      // [n][n]: z, then a
  float* slz = sz + nn;          // [n][n]: Lz, Le, then La
  float* se = slz + nn;          // [n][n]: exp(z - max)
  float* sjs = se + nn;          // [K][n]: sum_j Je
  float* srs = sjs + K * n;      // [n]: s
  float* sls = srs + n;          // [n]: Ls
  float* sjsq = sls + n;         // [n]: sum_k Js^2

  const long HD = (long)H * dh;
  const long pbase = (long)b * n * HD + (long)h * dh;
  for (int e = tid; e < n * dq; e += T) {
    const int i = e / dq, c = e % dq;
    const long g = pbase + i * HD;
    const int o = i * ldt + 4 * c;
    *reinterpret_cast<float4*>(sq + o) = __ldg(reinterpret_cast<const float4*>(q + g) + c);
    *reinterpret_cast<float4*>(sk + o) = __ldg(reinterpret_cast<const float4*>(k + g) + c);
    *reinterpret_cast<float4*>(sv + o) = __ldg(reinterpret_cast<const float4*>(v + g) + c);
    *reinterpret_cast<float4*>(slq + o) = __ldg(reinterpret_cast<const float4*>(lq + g) + c);
    *reinterpret_cast<float4*>(slk + o) = __ldg(reinterpret_cast<const float4*>(lk + g) + c);
    *reinterpret_cast<float4*>(slv + o) = __ldg(reinterpret_cast<const float4*>(lv + g) + c);
  }
  __syncthreads();

  // ---- pass 1: Jz_k[i, :] and sum_d Jq_k[i] Jk_k[:] per (direction, row)
  for (int r = tid; r < K * n; r += T) {
    const int kk = r / n, i = r % n;
    const long jbase = ((long)b * K + kk) * n * HD + (long)h * dh;
    const float4* jq_row = reinterpret_cast<const float4*>(jq + jbase + i * HD);
    const float4* q_row = reinterpret_cast<const float4*>(sq + i * ldt);
    float jz[NMAX], cr[NMAX];
#pragma unroll
    for (int j = 0; j < NMAX; ++j) jz[j] = cr[j] = 0.f;
    for (int c = 0; c < dq; ++c) {
      const float4 a = __ldg(jq_row + c);
      const float4 qv = q_row[c];
#pragma unroll
      for (int j = 0; j < NMAX; ++j) {
        if (j < n) {
          const float4 kv = reinterpret_cast<const float4*>(sk + j * ldt)[c];
          const float4 jkv = __ldg(reinterpret_cast<const float4*>(jk + jbase + j * HD) + c);
          jz[j] += dot4(a, kv) + dot4(qv, jkv);
          cr[j] += dot4(a, jkv);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NMAX; ++j) {
      if (j < n) {
        sjz[kk * nn + i * n + j] = jz[j] * scale;
        scr[kk * nn + i * n + j] = cr[j];
      }
    }
  }
  __syncthreads();

  // z and Lz = (Lq k^T + q Lk^T + 2 sum_k Jq_k Jk_k^T) / sqrt(dh)
  for (int r = tid; r < nn; r += T) {
    const int i = r / n, j = r % n;
    float cross = 0.f;
    for (int kk = 0; kk < K; ++kk) cross += scr[kk * nn + r];
    const float4* qi = reinterpret_cast<const float4*>(sq + i * ldt);
    const float4* kj = reinterpret_cast<const float4*>(sk + j * ldt);
    const float4* lqi = reinterpret_cast<const float4*>(slq + i * ldt);
    const float4* lkj = reinterpret_cast<const float4*>(slk + j * ldt);
    float z = 0.f, lz = 0.f;
    for (int c = 0; c < dq; ++c) {
      z += dot4(qi[c], kj[c]);
      lz += dot4(lqi[c], kj[c]) + dot4(qi[c], lkj[c]);
    }
    sz[r] = z * scale;
    slz[r] = (lz + 2.f * cross) * scale;
  }
  __syncthreads();

  // ---- softmax over j with its Jacobian and Laplacian (fl_attention._softmax_fl)
  for (int i = tid; i < n; i += T) {
    float m = sz[i * n];
    for (int j = 1; j < n; ++j) m = fmaxf(m, sz[i * n + j]);
    float sum = 0.f;
    for (int j = 0; j < n; ++j) {
      const float ez = expf(sz[i * n + j] - m);
      se[i * n + j] = ez;
      sum += ez;
    }
    srs[i] = sum;
  }
  __syncthreads();
  for (int r = tid; r < K * n; r += T) {  // Js[k][i] = sum_j e_ij Jz_kij
    const int kk = r / n, i = r % n;
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc += se[i * n + j] * sjz[kk * nn + i * n + j];
    sjs[r] = acc;
  }
  for (int r = tid; r < nn; r += T) {  // Le = e (Lz + sum_k Jz_k^2)
    float acc = 0.f;
    for (int kk = 0; kk < K; ++kk) {
      const float jzv = sjz[kk * nn + r];
      acc += jzv * jzv;
    }
    slz[r] = se[r] * (slz[r] + acc);
  }
  __syncthreads();
  for (int i = tid; i < n; i += T) {
    float ls = 0.f, jsq = 0.f;
    for (int j = 0; j < n; ++j) ls += slz[i * n + j];
    for (int kk = 0; kk < K; ++kk) jsq += sjs[kk * n + i] * sjs[kk * n + i];
    sls[i] = ls;
    sjsq[i] = jsq;
  }
  __syncthreads();
  for (int r = tid; r < nn; r += T) {
    const int i = r / n;
    const float inv = 1.f / srs[i];
    const float ev = se[r];
    const float a = ev * inv;
    float cross = 0.f;  // sum_k Je_k Js_k
    for (int kk = 0; kk < K; ++kk) {
      const float jsv = sjs[kk * n + i];
      const float je = ev * sjz[kk * nn + r];
      cross += je * jsv;
      sjz[kk * nn + r] = (je - a * jsv) * inv;  // Ja
    }
    slz[r] = (slz[r] - a * sls[i]) * inv - 2.f * inv * inv * cross +
             2.f * a * inv * inv * sjsq[i];  // La
    sz[r] = a;
  }
  __syncthreads();

  // ---- pass 2: Jt_k = Ja_k v + a Jv_k, cross_t = sum_k Ja_k Jv_k
  const int nI = (n + 1) / 2, nD = dh / 2;
  const int items = 2 * nI * nD;
  for (int base = 0; base < items; base += T) {
    // neighbouring threads take the two parities of one (row pair, column
    // pair), so both always fall in the same round of the loop
    const int it = base + tid;
    const bool active = it < items;
    const int par = it % 2, dp = (it / 2) % nD, ip = it / (2 * nD);
    const int i0 = 2 * ip, i1 = 2 * ip + 1, d = 2 * dp;
    const bool has1 = i1 < n;
    float2 cr0 = make_float2(0.f, 0.f), cr1 = make_float2(0.f, 0.f);
    for (int k0 = 0; k0 < K; k0 += kc) {
      const int kn = min(kc, K - k0);
      for (int e = tid; e < kn * n * dq; e += T) {
        const int kk = e / (n * dq), r = e % (n * dq);
        const int j = r / dq, c = r % dq;
        const long g = (((long)b * K + k0 + kk) * n + j) * HD + (long)h * dh;
        reinterpret_cast<float4*>(scr)[e] = __ldg(reinterpret_cast<const float4*>(jv + g) + c);
      }
      __syncthreads();
      if (active) {
        for (int kk = par; kk < kn; kk += 2) {
          const float* ja = sjz + (k0 + kk) * nn;
          float2 t0 = make_float2(0.f, 0.f), t1 = make_float2(0.f, 0.f);
          for (int j = 0; j < n; ++j) {
            const float2 vv = *reinterpret_cast<const float2*>(sv + j * ldt + d);
            const float2 jvv = *reinterpret_cast<const float2*>(scr + (kk * n + j) * dh + d);
            const float ja0 = ja[i0 * n + j], a0 = sz[i0 * n + j];
            t0.x += ja0 * vv.x + a0 * jvv.x;
            t0.y += ja0 * vv.y + a0 * jvv.y;
            cr0.x += ja0 * jvv.x;
            cr0.y += ja0 * jvv.y;
            if (has1) {
              const float ja1 = ja[i1 * n + j], a1 = sz[i1 * n + j];
              t1.x += ja1 * vv.x + a1 * jvv.x;
              t1.y += ja1 * vv.y + a1 * jvv.y;
              cr1.x += ja1 * jvv.x;
              cr1.y += ja1 * jvv.y;
            }
          }
          const long g = ((long)b * K + k0 + kk) * n * HD + (long)h * dh + d;
          *reinterpret_cast<float2*>(jt + g + i0 * HD) = t0;
          if (has1) *reinterpret_cast<float2*>(jt + g + i1 * HD) = t1;
        }
      }
      __syncthreads();
    }
    // the two direction parities' cross terms meet in shared memory
    if (active) {
      *reinterpret_cast<float2*>(scr + (par * n + i0) * dh + d) = cr0;
      if (has1) *reinterpret_cast<float2*>(scr + (par * n + i1) * dh + d) = cr1;
    }
    __syncthreads();
    if (active && par == 0) {
      for (int s = 0; s < (has1 ? 2 : 1); ++s) {
        const int i = i0 + s;
        float2 tv = make_float2(0.f, 0.f), lv2 = make_float2(0.f, 0.f);
        for (int j = 0; j < n; ++j) {
          const float a = sz[i * n + j], la = slz[i * n + j];
          const float2 vv = *reinterpret_cast<const float2*>(sv + j * ldt + d);
          const float2 lvv = *reinterpret_cast<const float2*>(slv + j * ldt + d);
          tv.x += a * vv.x;
          tv.y += a * vv.y;
          lv2.x += la * vv.x + a * lvv.x;
          lv2.y += la * vv.y + a * lvv.y;
        }
        const float2 c0 = *reinterpret_cast<const float2*>(scr + i * dh + d);
        const float2 c1 = *reinterpret_cast<const float2*>(scr + (n + i) * dh + d);
        lv2.x += 2.f * (c0.x + c1.x);
        lv2.y += 2.f * (c0.y + c1.y);
        const long g = pbase + i * HD + d;
        *reinterpret_cast<float2*>(t + g) = tv;
        *reinterpret_cast<float2*>(lt + g) = lv2;
      }
    }
    __syncthreads();
  }
}

template <int NMAX>
int launch(const float* q, const float* k, const float* v, const float* jq,
           const float* jk, const float* jv, const float* lq, const float* lk,
           const float* lv, float* t, float* jt, float* lt, int B, int K, int n,
           int H, int dh, int kc, cudaStream_t stream) {
  const long smem = smem_floats(K, n, dh, kc) * (long)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fl_attention_kernel<NMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fl_attention_kernel<NMAX><<<B * H, kThreads, smem, stream>>>(
      q, k, v, jq, jk, jv, lq, lk, lv, t, jt, lt, K, n, H, dh, kc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes of one block; the wrapper picks kc from it.
long fl_attention_smem_bytes(int K, int n, int dh, int kc) {
  return smem_floats(K, n, dh, kc) * (long)sizeof(float);
}

int fl_attention_launch(const float* q, const float* k, const float* v,
                        const float* jq, const float* jk, const float* jv,
                        const float* lq, const float* lk, const float* lv,
                        float* t, float* jt, float* lt, int B, int K, int n,
                        int H, int dh, int kc, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (dh % 4 != 0 || n < 1) return (int)cudaErrorInvalidValue;
  if (n <= 4) return launch<4>(q, k, v, jq, jk, jv, lq, lk, lv, t, jt, lt, B, K, n, H, dh, kc, s);
  if (n <= 8) return launch<8>(q, k, v, jq, jk, jv, lq, lk, lv, t, jt, lt, B, K, n, H, dh, kc, s);
  if (n <= 12) return launch<12>(q, k, v, jq, jk, jv, lq, lk, lv, t, jt, lt, B, K, n, H, dh, kc, s);
  if (n <= 16) return launch<16>(q, k, v, jq, jk, jv, lq, lk, lv, t, jt, lt, B, K, n, H, dh, kc, s);
  if (n <= 32) return launch<32>(q, k, v, jq, jk, jv, lq, lk, lv, t, jt, lt, B, K, n, H, dh, kc, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

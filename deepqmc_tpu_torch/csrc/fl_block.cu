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
// attention core, about 8.0 ms at the card's 67 TFLOP/s float32 peak; the
// Jacobian in and out is 1.26 GB, about 0.4 ms at 3.35 TB/s.
//
// Why not the TPU's plan: one walker's Jacobian (30 x 10 x 256 floats,
// 307 KB) does not fit the 227 KB of shared memory of a block.  What makes a
// block per walker possible: Jacobian rows of direction k depend only on the
// primals and on direction k's own rows, and every Laplacian rule is linear in
// the incoming Laplacians plus sums over k of products of direction-k
// Jacobians.  So one block per walker runs three phases:
//  A. primal pass: q, k, v, the softmax a (per head), m1 = tanh(u1) and
//     m2 = tanh(u2) stay in shared memory (tanh' = 1 - m^2, tanh'' =
//     -2 m tanh'); y is written out.
//  B. the directions in chunks of kc: a chunk of J streams in, goes through
//     the six products and the attention core, and the chunk of J_y streams
//     out.  Each chunk adds its share of the small K-sums in shared memory:
//     per head [n, n]: Sqk = sum_k Jq_k Jk_k^T, Q = sum_k Jz_k^2,
//     P = sum_k Jz_k g_k; per head [n]: G = sum_k g_k^2, with
//     g_k = sum_j a_j Jz_kj; [n, d]: Sav = sum_k Ja_k Jv_k (all heads) and,
//     per MLP layer, Su = sum_k (J u_k)^2.
//  C. Laplacian pass: L goes through the linearised block, and the sums
//     enter at their sites.  The softmax rules in terms of a:
//       Ja_k = a (Jz_k - g_k)
//       La   = a (Lz + Q - m - 2 P + 2 G),  m = sum_j a (Lz + Q)
//     (the same algebra as fl_attention._softmax_fl with e = a s).
// Each sum over k has one owner thread per entry, which adds the chunk's
// directions in order: no float atomics, no reduction across blocks, so the
// result is deterministic.  The Jacobian crosses device memory once in and
// once out; the weights (six d x d matrices, 1.5 MB at d = 256) are read
// from L2 by every block, once per chunk and product.
//
// The products are written out here in float32 on the CUDA cores (no tensor
// cores, no TF32): a work item is a pair of tokens times 4 output columns for
// every direction of the chunk, i.e. a (2 kc) x 4 register tile; the input
// rows are read from shared memory as float4 (broadcast within a warp), the
// weight rows from global memory as float4, both one step of 4 inputs ahead.
// Requires n <= 32, dh % 4 == 0 and 16-byte aligned operands (the wrapper
// checks them).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 384;
constexpr int kMaxN = 32;

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

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

__device__ __forceinline__ float4 tanh4(float4 a) {
  return make_float4(tanhf(a.x), tanhf(a.y), tanhf(a.z), tanhf(a.w));
}

__device__ __forceinline__ float4 dtanh4(float4 m) {  // tanh' from tanh
  return make_float4(1.f - m.x * m.x, 1.f - m.y * m.y, 1.f - m.z * m.z, 1.f - m.w * m.w);
}

__host__ __device__ inline int round4(long x) { return (int)((x + 3) / 4 * 4); }

// Offsets (in floats) of the shared-memory regions; each starts 16-byte aligned.
struct Smem {
  int ld, ldh;
  int q, k, v, m1, m2, su1, su2, sav;  // [n][ld], persistent
  int a, sqk, sq, sp;                  // [H][n][n], persistent
  int sg;                              // [H][n], persistent
  int bufa, bufb;                      // [kc n][ld], one chunk
  int hq, hk, hv;                      // [kc n][ldh], one head of one chunk
  int jz, cr;                          // [kc][n][n]
  int g;                               // [kc][n]
  int total;
};

__host__ __device__ inline Smem smem_layout(int n, int d, int H, int kc) {
  Smem s;
  const int dh = d / H;
  s.ld = d + 4;  // float4 aligned rows, banks shifted between rows
  s.ldh = dh + 4;
  int o = 0;
  const int tile = round4((long)n * s.ld);
  s.q = o; o += tile;
  s.k = o; o += tile;
  s.v = o; o += tile;
  s.m1 = o; o += tile;
  s.m2 = o; o += tile;
  s.su1 = o; o += tile;
  s.su2 = o; o += tile;
  s.sav = o; o += tile;
  const int hnn = round4((long)H * n * n);
  s.a = o; o += hnn;
  s.sqk = o; o += hnn;
  s.sq = o; o += hnn;
  s.sp = o; o += hnn;
  s.sg = o; o += round4((long)H * n);
  const int chunk = round4((long)kc * n * s.ld);
  s.bufa = o; o += chunk;
  s.bufb = o; o += chunk;
  const int hchunk = round4((long)kc * n * s.ldh);
  s.hq = o; o += hchunk;
  s.hk = o; o += hchunk;
  s.hv = o; o += hchunk;
  const int knn = round4((long)kc * n * n);
  s.jz = o; o += knn;
  s.cr = o; o += knn;
  s.g = o; o += round4((long)kc * n);
  s.total = o;
  return s;
}

// out(kk, i, c) = sum_p A[(kk n + i) lda + p] W(p, c) for kk < kc, i < n and
// c < N, with A in shared memory and W in global memory.  A work item is a
// token pair (i0, i0 + 1) times the 4 columns c0..c0+3, for every kk < kc;
// `wcol(c0)` gives the address of W(0, c0) (rows ldw apart) and
// `epi(i, c0, acc)` receives the item's sums acc[kk] for token i.  One owner
// per (i, c0) over all kk, so an epilogue may sum over kk without races.
// Steps of 4 inputs alternate between two register sets (x*, w*), each
// loaded one step ahead, so that no load is waited for by a register copy.
template <int KC, class WCol, class Epi>
__device__ __forceinline__ void block_gemm(const float* A, int lda, int n, int kc, int P,
                                           int N, int ldw, WCol wcol, Epi epi) {
  const int ncg = N / 4, nrg = (n + 1) / 2;
  for (int item = threadIdx.x; item < nrg * ncg; item += blockDim.x) {
    const int i0 = 2 * (item / ncg), c0 = 4 * (item % ncg);
    const bool has1 = i0 + 1 < n;
    const float* w = wcol(c0);
    float4 acc0[KC], acc1[KC];
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      acc0[kk] = make_float4(0.f, 0.f, 0.f, 0.f);
      acc1[kk] = acc0[kk];
    }
    float4 wa[4], wb[4], xa[KC][2], xb[KC][2];
    auto load = [&](int p, float4 (&w4)[4], float4 (&x)[KC][2]) {
#pragma unroll
      for (int s = 0; s < 4; ++s) w4[s] = ldg4(w + (long)(p + s) * ldw);
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        if (kk < kc) {
          x[kk][0] = ld4(A + (kk * n + i0) * lda + p);
          if (has1) x[kk][1] = ld4(A + (kk * n + i0 + 1) * lda + p);
        }
      }
    };
    auto step = [&](const float4 (&w4)[4], const float4 (&x)[KC][2]) {
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        if (kk < kc) {
          fma4(acc0[kk], x[kk][0].x, w4[0]);
          fma4(acc0[kk], x[kk][0].y, w4[1]);
          fma4(acc0[kk], x[kk][0].z, w4[2]);
          fma4(acc0[kk], x[kk][0].w, w4[3]);
          if (has1) {
            fma4(acc1[kk], x[kk][1].x, w4[0]);
            fma4(acc1[kk], x[kk][1].y, w4[1]);
            fma4(acc1[kk], x[kk][1].z, w4[2]);
            fma4(acc1[kk], x[kk][1].w, w4[3]);
          }
        }
      }
    };
    load(0, wa, xa);
    for (int p = 0; p < P; p += 8) {
      const bool second = p + 4 < P;
      if (second) load(p + 4, wb, xb);
      step(wa, xa);
      if (p + 8 < P) load(p + 8, wa, xa);
      if (second) step(wb, xb);
    }
    epi(i0, c0, acc0);
    if (has1) epi(i0 + 1, c0, acc1);
  }
}

struct Params {
  const float *x, *jac, *lap, *wq, *wk, *wv, *wo, *w1, *b1, *w2, *b2;
  float *y, *jy, *ly;
  int K, n, d, H, kc;
};

// [Wq_h | Wk_h | Wv_h]: column c0 of the head's 3 dh projected columns
struct QkvCols {
  const float *wq, *wk, *wv;
  int h, dh;
  __device__ const float* operator()(int c0) const {
    const int which = c0 / dh, col = h * dh + c0 % dh;
    return (which == 0 ? wq : which == 1 ? wk : wv) + col;
  }
};

struct Cols {
  const float* w;
  __device__ const float* operator()(int c0) const { return w + c0; }
};

template <int KC>
__global__ void __launch_bounds__(kMaxThreads, 1) fl_block_kernel(Params pr) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int n = pr.n, d = pr.d, H = pr.H, K = pr.K, kc = pr.kc;
  const int dh = d / H, nn = n * n, d4 = d / 4, dh4 = dh / 4;
  const Smem L = smem_layout(n, d, H, kc);
  const int ld = L.ld, ldh = L.ldh;
  const int tid = threadIdx.x, T = blockDim.x;
  const long b = blockIdx.x;
  const float scale = 1.f / sqrtf((float)dh);

  float *sq = sm + L.q, *sk = sm + L.k, *sv = sm + L.v, *sm1 = sm + L.m1, *sm2 = sm + L.m2;
  float *su1 = sm + L.su1, *su2 = sm + L.su2, *sav = sm + L.sav;
  float *sa = sm + L.a, *ssqk = sm + L.sqk, *ssq = sm + L.sq, *ssp = sm + L.sp, *ssg = sm + L.sg;
  float *bufa = sm + L.bufa, *bufb = sm + L.bufb;
  float *hq = sm + L.hq, *hk = sm + L.hk, *hv = sm + L.hv;
  float *sjz = sm + L.jz, *scr = sm + L.cr, *sg = sm + L.g;

  // zero the K-sums; load x
  for (int e = tid; e < L.a - L.su1; e += T) sm[L.su1 + e] = 0.f;
  for (int e = tid; e < L.bufa - L.sqk; e += T) sm[L.sqk + e] = 0.f;
  const float* xb = pr.x + b * n * d;
  for (int e = tid; e < n * d4; e += T) {
    const int i = e / d4, c = 4 * (e % d4);
    st4(bufa + i * ld + c, ldg4(xb + i * d + c));
  }
  __syncthreads();

  // ---------------- phase A: primal pass ----------------
  for (int h = 0; h < H; ++h) {
    block_gemm<1>(bufa, ld, n, 1, d, 3 * dh, d, QkvCols{pr.wq, pr.wk, pr.wv, h, dh},
                  [&](int i, int c0, const float4* acc) {
                    const int which = c0 / dh, col = h * dh + c0 % dh;
                    float* dst = which == 0 ? sq : which == 1 ? sk : sv;
                    st4(dst + i * ld + col, acc[0]);
                  });
  }
  __syncthreads();
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
  block_gemm<1>(bufb, ld, n, 1, d, d, d, Cols{pr.wo}, [&](int i, int c0, const float4* acc) {
    float* p = bufa + i * ld + c0;  // att = x + t Wo
    st4(p, add4(ld4(p), acc[0]));
  });
  __syncthreads();
  block_gemm<1>(bufa, ld, n, 1, d, d, d, Cols{pr.w1}, [&](int i, int c0, const float4* acc) {
    st4(sm1 + i * ld + c0, tanh4(add4(acc[0], ldg4(pr.b1 + c0))));
  });
  __syncthreads();
  block_gemm<1>(sm1, ld, n, 1, d, d, d, Cols{pr.w2}, [&](int i, int c0, const float4* acc) {
    const float4 m2 = tanh4(add4(acc[0], ldg4(pr.b2 + c0)));
    st4(sm2 + i * ld + c0, m2);
    st4(pr.y + (b * n + i) * d + c0, add4(ld4(bufa + i * ld + c0), m2));
  });
  __syncthreads();

  // ---------------- phase B: the directions, kc at a time ----------------
  for (int k0 = 0; k0 < K; k0 += kc) {
    const int kn = min(kc, K - k0);
    const float* jb = pr.jac + (b * K + k0) * n * d;
    for (int e = tid; e < kn * n * d4; e += T) {
      const int r = e / d4, c = 4 * (e % d4);
      st4(bufa + r * ld + c, ldg4(jb + (long)r * d + c));
    }
    __syncthreads();
    for (int h = 0; h < H; ++h) {
      const float* ah = sa + h * nn;
      // Jq, Jk, Jv of head h
      block_gemm<KC>(bufa, ld, n, kn, d, 3 * dh, d, QkvCols{pr.wq, pr.wk, pr.wv, h, dh},
                     [&](int i, int c0, const float4* acc) {
                       const int which = c0 / dh, col = c0 % dh;
                       float* dst = which == 0 ? hq : which == 1 ? hk : hv;
#pragma unroll
                       for (int kk = 0; kk < KC; ++kk)
                         if (kk < kn) st4(dst + (kk * n + i) * ldh + col, acc[kk]);
                     });
      __syncthreads();
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
        float* p = sav + i * ld + h * dh + c;
        st4(p, add4(ld4(p), s));
      }
      __syncthreads();
    }
    // J_att = J + Jt Wo (in place in bufa)
    block_gemm<KC>(bufb, ld, n, kn, d, d, d, Cols{pr.wo}, [&](int i, int c0, const float4* acc) {
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        if (kk < kn) {
          float* p = bufa + (kk * n + i) * ld + c0;
          st4(p, add4(ld4(p), acc[kk]));
        }
      }
    });
    __syncthreads();
    // J u1 = J_att W1; Su1 += (J u1)^2; J m1 = tanh'(u1) J u1 into bufb
    block_gemm<KC>(bufa, ld, n, kn, d, d, d, Cols{pr.w1}, [&](int i, int c0, const float4* acc) {
      const float4 t1 = dtanh4(ld4(sm1 + i * ld + c0));
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        if (kk < kn) {
          s = add4(s, mul4(acc[kk], acc[kk]));
          st4(bufb + (kk * n + i) * ld + c0, mul4(t1, acc[kk]));
        }
      }
      float* p = su1 + i * ld + c0;
      st4(p, add4(ld4(p), s));
    });
    __syncthreads();
    // J u2 = J m1 W2; Su2 += (J u2)^2; J y = J_att + tanh'(u2) J u2 to global
    float* jyb = pr.jy + (b * K + k0) * n * d;
    block_gemm<KC>(bufb, ld, n, kn, d, d, d, Cols{pr.w2}, [&](int i, int c0, const float4* acc) {
      const float4 t2 = dtanh4(ld4(sm2 + i * ld + c0));
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        if (kk < kn) {
          s = add4(s, mul4(acc[kk], acc[kk]));
          const int r = kk * n + i;
          st4(jyb + (long)r * d + c0, add4(ld4(bufa + r * ld + c0), mul4(t2, acc[kk])));
        }
      }
      float* p = su2 + i * ld + c0;
      st4(p, add4(ld4(p), s));
    });
    __syncthreads();
  }

  // ---------------- phase C: Laplacian pass ----------------
  const float* lb = pr.lap + b * n * d;
  for (int e = tid; e < n * d4; e += T) {
    const int i = e / d4, c = 4 * (e % d4);
    st4(bufa + i * ld + c, ldg4(lb + i * d + c));
  }
  __syncthreads();
  for (int h = 0; h < H; ++h) {
    const float* ah = sa + h * nn;
    block_gemm<1>(bufa, ld, n, 1, d, 3 * dh, d, QkvCols{pr.wq, pr.wk, pr.wv, h, dh},
                  [&](int i, int c0, const float4* acc) {
                    const int which = c0 / dh, col = c0 % dh;
                    float* dst = which == 0 ? hq : which == 1 ? hk : hv;
                    st4(dst + i * ldh + col, acc[0]);
                  });
    __syncthreads();
    for (int e = tid; e < nn; e += T) {  // w = Lz + Q
      const int i = e / n, j = e % n;
      const float *lq = hq + i * ldh, *lk = hk + j * ldh;
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
      float4 t = ld4(sav + i * ld + h * dh + c);
      t = add4(t, t);
      for (int j = 0; j < n; ++j) {
        fma4(t, sjz[i * n + j], ld4(sv + j * ld + h * dh + c));
        fma4(t, ah[i * n + j], ld4(hv + j * ldh + c));
      }
      st4(bufb + i * ld + h * dh + c, t);
    }
    __syncthreads();
  }
  block_gemm<1>(bufb, ld, n, 1, d, d, d, Cols{pr.wo}, [&](int i, int c0, const float4* acc) {
    float* p = bufa + i * ld + c0;  // L_att = L + Lt Wo
    st4(p, add4(ld4(p), acc[0]));
  });
  __syncthreads();
  block_gemm<1>(bufa, ld, n, 1, d, d, d, Cols{pr.w1}, [&](int i, int c0, const float4* acc) {
    const float4 m1 = ld4(sm1 + i * ld + c0), t1 = dtanh4(m1);
    const float4 s = ld4(su1 + i * ld + c0);
    // L m1 = tanh' L u1 + tanh'' Su1, tanh'' = -2 m1 tanh'
    st4(bufb + i * ld + c0, mul4(t1, add4(acc[0], make_float4(-2.f * m1.x * s.x, -2.f * m1.y * s.y,
                                                              -2.f * m1.z * s.z, -2.f * m1.w * s.w))));
  });
  __syncthreads();
  block_gemm<1>(bufb, ld, n, 1, d, d, d, Cols{pr.w2}, [&](int i, int c0, const float4* acc) {
    const float4 m2 = ld4(sm2 + i * ld + c0), t2 = dtanh4(m2);
    const float4 s = ld4(su2 + i * ld + c0);
    const float4 lm2 = mul4(t2, add4(acc[0], make_float4(-2.f * m2.x * s.x, -2.f * m2.y * s.y,
                                                         -2.f * m2.z * s.z, -2.f * m2.w * s.w)));
    st4(pr.ly + (b * n + i) * d + c0, add4(ld4(bufa + i * ld + c0), lm2));
  });
}

inline int block_threads(int n, int d) {
  const int items = (n + 1) / 2 * (d / 4);
  int t = (items + 31) / 32 * 32;
  if (t < 64) t = 64;
  return t > kMaxThreads ? kMaxThreads : t;
}

template <int KC>
int launch(const Params& pr, int B, cudaStream_t stream) {
  const long smem = (long)smem_layout(pr.n, pr.d, pr.H, pr.kc).total * (long)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fl_block_kernel<KC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fl_block_kernel<KC><<<B, block_threads(pr.n, pr.d), smem, stream>>>(pr);
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
                    float* ly, int B, int K, int n, int d, int H, int kc, void* stream) {
  if (n < 1 || n > kMaxN || H < 1 || d % H != 0 || (d / H) % 4 != 0 || kc < 1 || kc > 4)
    return (int)cudaErrorInvalidValue;
  const Params pr{x, jac, lap, wq, wk, wv, wo, w1, b1, w2, b2, y, jy, ly, K, n, d, H, kc};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (kc) {
    case 1: return launch<1>(pr, B, s);
    case 2: return launch<2>(pr, B, s);
    case 3: return launch<3>(pr, B, s);
    default: return launch<4>(pr, B, s);
  }
}

}  // extern "C"

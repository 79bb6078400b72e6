// Forward-Laplacian attention core: (t, J_t, L_t) of softmax(q k^T / sqrt(dh)) v.
//
// Replaces the TPU kernel deepqmc_tpu/ops/fl_attention.py `_pallas_blocked`
// (kernel body `_kernel`, default head body `_make_head_fn`).  Plain twin:
// deepqmc_tpu_torch/ops/fl_attention.py `mha_core_fl_plain`.
//
// Layouts (contiguous): primals q, k, v, Lq, Lk, Lv and outputs t, Lt are
// [B, n, H, dh], float; Jacobians Jq, Jk, Jv and the output Jt are
// [B, K, n, H, dh], float or bf16 (see the precision levers below).
// Requires 1 <= n <= 64, dh % 4 == 0 and 16-byte aligned operands (the
// wrapper checks them).
//
// What bounds it: bytes at small n.  Each Jacobian is read from HBM once and
// Jt written once (2.68 GB per call for the H2O PsiFormer at B = 2048, n = 10)
// against about 7 flops per Jacobian byte; at n = 42 and 64 the flops (12 n^2
// dh a direction) bound it.  What bounds this kernel on the card at n = 10 is
// the shared-memory pipe (loads, shuffles and copies share it), so the passes
// are laid out to feed many multiply-adds from each load.
//
// Design: one block per (walker, head), one pass over the directions.  Every
// cross-direction term of the softmax's forward Laplacian is a sum over k of
// products of direction-k quantities (fl_block.cu uses the same algebra):
//   Jz_k = (Jq_k k^T + q Jk_k^T) / sqrt(dh),  g_k[i] = sum_j a_ij Jz_k[i, j]
//   Ja_k = a (Jz_k - g_k)
//   La   = a (w - m - 2 P + 2 G),  w = (Lq k^T + q Lk^T) / sqrt(dh) + W,
//          m[i] = sum_j a_ij w_ij
// with the sums W = sum_k (2 Jq_k Jk_k^T / sqrt(dh) + Jz_k^2) (that is,
// Lz's cross term and Q), P = sum_k Jz_k g_k, G = sum_k g_k^2 ([n, n], [n, n],
// [n]) and Sav = sum_k Ja_k Jv_k ([n, dh]).  What stays resident is O(n^2 +
// n dh) and does not grow with K:
//  - start: q, k, v land in shared memory; a = softmax(z).  Row i and row
//    i + ceil(n/2) of a (and of Ja, La) are stored as one float2 a column;
//  - the direction stream: a copying warp (the block's last) moves the tiles
//    Jq_k, Jk_k, Jv_k ([n, dh] each, rows H dh apart in memory) in order into
//    a ring of `slots` tiles by 16-byte `cp.async` copies; each slot has a
//    "full" mbarrier (the copying lanes arrive as their copies land) and an
//    "empty" one (thread 0 arrives once the computing threads are past it).
//    The computing threads never issue a copy;
//  - pass A, per direction: a lane forms Jz_k and Jq_k Jk_k^T on a 2 x 2
//    tile (rows i, i + ceil(n/2); columns j, j + ceil(n/2)) over the whole of
//    dh, 8 loads of 16 bytes for 48 multiply-adds; g_k of its two rows is the
//    sum over the ceil(n/2) lanes of the row pair (shuffles); the lane adds
//    its entries' shares to W and P (G for the pair's first lane) and writes
//    its entries of Ja_k;
//  - pass B, per direction: thread (row pair, float4 column c) forms
//    Jt_k = Ja_k v + a Jv_k for its two rows (one 8-byte load each of a and
//    Ja a column), stores them (16 consecutive threads write one 256-byte row
//    at dh = 64), and adds Ja_k Jv_k to its Sav entries.  Ja_k is never kept
//    past its direction;
//  - end: Lq, Lk, Lv land in the ring; La replaces Ja; t = a v and
//    Lt = La v + a Lv + 2 Sav are written.
// Two barriers of the computing threads a direction, none in the passes.
// Each sum has one owner thread and adds the directions in order, and the
// shuffles sum in a fixed pattern: no atomics, so two launches give
// bitwise-equal results.
//
// Precision levers (the JAX package's DEEPQMC_TPU_JAC_DTYPE and
// DEEPQMC_TPU_JAC_MATMUL).  The Jacobians Jq, Jk, Jv and the output Jt have one
// element type TJ, float or bf16 (a template argument): bf16 tiles go through
// the ring as they lie in memory (8 elements a 16-byte copy, the bytes of the
// stream halved) and widen to float as the passes load them; Jt is rounded to
// bf16 as it is stored, as the JAX package rounds its float32 output outside.
// Everything else is float.  LOW (the JAX kernel's `_bmm(low=True)`): the
// Jacobian contractions, those that scale with K (Jz_k, Jq_k Jk_k^T, Ja_k v,
// a Jv_k, Ja_k Jv_k), take both operands rounded to bf16 and accumulate in
// float; the products of two bf16 values are exact in float, so this is the
// function of a bf16 tensor-core product with float accumulation, here on
// the CUDA cores.  The primal and Laplacian contractions stay float.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 64;
constexpr int kMaxThreads = 256;  // computing threads; one more warp copies
// Blocks of at most kSmallBlock threads (the copying warp included; H2O's
// n = 10, dh = 64 takes 128) are held to the registers of kSmallBlocks of
// them an SM: more blocks in flight beat a few spilled registers there.
constexpr int kSmallBlock = 128, kSmallBlocks = 8;

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// acc + a . b as four fused multiply-adds
__device__ __forceinline__ float fma4sum(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// 4 bf16 values (8 bytes) widened to float: a bf16 is a float's upper half
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// 4 floats rounded to bf16 (nearest even) and stored in 8 bytes
__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
}

// x rounded to bf16 (nearest even), as a float
__device__ __forceinline__ float bf(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__device__ __forceinline__ float4 bf4(float4 v) {
  return make_float4(bf(v.x), bf(v.y), bf(v.z), bf(v.w));
}

// An operand of a Jacobian contraction: rounded to bf16 in LOW mode (a no-op
// on values that are bf16 already)
template <bool LOW>
__device__ __forceinline__ float4 op4(float4 v) {
  if constexpr (LOW) return bf4(v);
  return v;
}

template <bool LOW>
__device__ __forceinline__ float2 op2(float2 v) {
  if constexpr (LOW) return make_float2(bf(v.x), bf(v.y));
  return v;
}

__device__ __forceinline__ void fma4(float4& acc, float s, float4 w) {
  acc.x = fmaf(s, w.x, acc.x);
  acc.y = fmaf(s, w.y, acc.y);
  acc.z = fmaf(s, w.z, acc.z);
  acc.w = fmaf(s, w.w, acc.w);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// Wait until this thread's cp.async copies have landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// One arrival on `bar` once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

// Wait for the phase of `bar` with this parity to complete.
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

// Barrier of the computing threads only (the copying warp does not take part).
__device__ __forceinline__ void compute_sync(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// Sum (or max) over the `width` lanes of a row group; width a power of 2.
__device__ __forceinline__ float group_sum(float v, int width) {
  for (int o = width / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the `width` lanes base .. base + width - 1 of the warp, each lane
// of them getting it: a butterfly where width is a power of 2 (the group then
// starts at a multiple of it), else the members in order.
__device__ __forceinline__ float pair_sum(float v, int base, int width) {
  if ((width & (width - 1)) == 0) return group_sum(v, width);
  float s = 0.f;
  for (int q = 0; q < width; ++q) s += __shfl_sync(0xffffffffu, v, (base + q) & 31);
  return s;
}

__device__ __forceinline__ float group_max(float v, int width) {
  for (int o = width / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Shared-memory plan of one block, in floats; the Jacobian tiles have
// elements of `jbytes` bytes (4 float, 2 bf16).
struct Layout {
  int ldt;   // row stride of an [n, dh] tile: float4 aligned, banks shifted by 4 a row
  int tile;  // n * ldt
  int ldj;   // row stride of a Jacobian tile in its elements: 16 bytes past dh, as ldt
  int slot;  // floats of a ring slot (one Jacobian tile, n * ldj elements)
  int q, k, v, sav, at, jat, w, p, g, ring, bar, total;
};

__host__ __device__ inline Layout layout(int n, int dh, int slots, int jbytes) {
  Layout L;
  L.ldt = dh + 4;
  L.tile = n * L.ldt;
  L.ldj = dh + 16 / jbytes;
  L.slot = n * L.ldj * jbytes / 4;
  const int nn = n * n;
  L.q = 0;
  L.k = L.tile;
  L.v = 2 * L.tile;
  const int pairs = n * ((n + 1) / 2);  // [n][ceil(n/2)] float2
  L.sav = 3 * L.tile;          // [n][ldt]  sum_k Ja_k Jv_k
  L.at = 4 * L.tile;           // a:   at[j][p] = (a[p][j], a[p + ceil(n/2)][j])
  L.jat = L.at + 2 * pairs;    // Ja_k (then La), the same pairing
  L.w = L.jat + 2 * pairs;     // [n][n]    W
  L.p = L.w + nn;        // [n][n]    P
  L.g = L.p + nn;        // [n]       G
  L.ring = (L.g + n + 3) / 4 * 4;
  // the ring's slots, which at the end hold the three float tiles Lq, Lk, Lv;
  // per slot a "full" and an "empty" mbarrier, 8 bytes each
  L.bar = L.ring + (slots * L.slot > 3 * L.tile ? slots * L.slot : 3 * L.tile);
  L.total = L.bar + 4 * slots;
  return L;
}

// Lanes of a row group of the softmax and the Laplacian: a power of 2 >=
// ceil(n / 2); lane jp takes columns jp and jp + ceil(n / 2) of the row.
__host__ __device__ inline int lanes_per_row(int n) {
  const int hn = (n + 1) / 2;
  int l = 1;
  while (l < hn) l <<= 1;
  return l;
}

// Computing threads of a block: enough warps for pass A's row pairs and pass
// B's (row pair, float4 column) items, at most kMaxThreads.
inline int threads_for(int n, int dh) {
  const int hn = (n + 1) / 2, ppw = 32 / hn;  // pass A: row pairs a warp
  const int warps_a = (hn + ppw - 1) / ppw;
  const int warps_b = ((n + 1) / 2 * (dh / 4) + 31) / 32;
  int w = warps_a > warps_b ? warps_a : warps_b;
  if (w * 32 > kMaxThreads) w = kMaxThreads / 32;
  return w * 32;
}

struct Params {
  const float *q, *k, *v;
  const void *jq, *jk, *jv;  // TJ
  const float *lq, *lk, *lv;
  float* t;
  void* jt;  // TJ
  float* lt;
  int K, n, H, dh, slots;
};

template <int MAX_THREADS, int MIN_BLOCKS, typename TJ, bool LOW>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS) fl_attention_kernel(Params pr) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int K = pr.K, n = pr.n, H = pr.H, dh = pr.dh, slots = pr.slots;
  const Layout L = layout(n, dh, slots, (int)sizeof(TJ));
  const int ldt = L.ldt, dq = dh / 4, ldj = L.ldj;
  constexpr int kVec = 16 / (int)sizeof(TJ);  // Jacobian elements a 16-byte copy
  // a Jacobian operand of a contraction: rounded in LOW mode unless it is bf16
  constexpr bool kRoundJ = LOW && sizeof(TJ) == 4;
  TJ* ringj = reinterpret_cast<TJ*>(sm + L.ring);
  const int slot_el = n * ldj;  // elements of a ring slot
  float *sq = sm + L.q, *sk = sm + L.k, *sv = sm + L.v, *sav = sm + L.sav;
  float2 *sat = reinterpret_cast<float2*>(sm + L.at), *sjat = reinterpret_cast<float2*>(sm + L.jat);
  float *sw = sm + L.w, *sp = sm + L.p;
  float *sg = sm + L.g, *ring = sm + L.ring;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.bar);
  uint64_t* empty = full + slots;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, T = blockDim.x - 32;  // T computing threads, then the copying warp
  const int lane = tid & 31, warp = tid >> 5, nwarps = T >> 5;
  const long HD = (long)H * dh;
  const long pbase = (long)b * n * HD + (long)h * dh;  // row 0 of (b, h) in [B, n, H, dh]
  const float scale = 1.0f / sqrtf((float)dh);

  // row groups of lpr lanes, lane jp takes columns jp and jp + hn
  const int hn = (n + 1) / 2, lpr = lanes_per_row(n), rpw = 32 / lpr;
  const int jp = lane % lpr, rsub = lane / lpr;
  const bool ok0 = jp < hn, ok1 = jp + hn < n;
  const int j0 = min(jp, hn - 1), j1 = min(jp + hn, n - 1);  // clamped: loads stay in range
  // a row-pair matrix entry: m[i][j] in pm[j * hn + i % hn], .x for i < hn
  const auto pget = [&](const float2* pm, int i, int j) {
    const float2 v = pm[j * hn + (i < hn ? i : i - hn)];
    return i < hn ? v.x : v.y;
  };
  const auto pset = [&](float2* pm, int i, int j, float v) {
    float* f = reinterpret_cast<float*>(pm + j * hn + (i < hn ? i : i - hn));
    f[i < hn ? 0 : 1] = v;
  };
  // pass A's lanes: groups of hn lanes, one a row pair (rows ip, ip + hn);
  // lane jp of a group takes columns jp and jp + hn
  const int ppw = 32 / hn, a_sub = lane / hn, a_jp = lane % hn;
  const bool a_ok = a_sub < ppw, a_ok1 = a_jp + hn < n;
  const int a_j1 = min(a_jp + hn, n - 1);

  // [n, dh] tile of rows HD apart from `src` into `dst`, 16-byte cp.async
  // copies by the `threads` threads from `first` on
  const auto copy_tile = [&](float* dst, const float* src, int first, int threads) {
    for (int e = tid - first; e < n * dq; e += threads) {
      const int r = e / dq, c = 4 * (e % dq);
      cp_async16(dst + r * ldt + c, src + r * HD + c);
    }
  };
  // the same for a Jacobian tile (rows ldj apart in the ring), by the copying warp
  const auto copy_jtile = [&](TJ* dst, const TJ* src) {
    for (int e = tid - T; e < n * (dh / kVec); e += 32) {
      const int r = e / (dh / kVec), c = kVec * (e % (dh / kVec));
      cp_async16(dst + r * ldj + c, src + r * HD + c);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < slots; ++s) {
      mbar_init(full + s, 32);  // the copying warp's lanes, as their copies land
      mbar_init(empty + s, 1);  // thread 0, once the computing threads are done with it
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= T) {
    // the copying warp: tiles 3 kk + {0, 1, 2} (Jq, Jk, Jv of direction kk)
    // in order, into ring slot tile % slots once that slot is released
    uint32_t phase = 0;  // bit s: the parity of slot s's next release
    int slot = 0, kk = 0, which = 0;
    for (int t = 0; t < 3 * K; ++t) {
      if (t >= slots) {
        mbar_wait(empty + slot, (phase >> slot) & 1u);
        phase ^= 1u << slot;
      }
      const TJ* base = static_cast<const TJ*>(which == 0 ? pr.jq : which == 1 ? pr.jk : pr.jv);
      copy_jtile(ringj + slot * slot_el, base + ((long)b * K + kk) * n * HD + (long)h * dh);
      cp_async_arrive(full + slot);
      if (++slot == slots) slot = 0;
      if (++which == 3) {
        which = 0;
        ++kk;
      }
    }
    cp_async_wait_all();
    return;
  }

  copy_tile(sq, pr.q + pbase, 0, T);
  copy_tile(sk, pr.k + pbase, 0, T);
  copy_tile(sv, pr.v + pbase, 0, T);
  for (int e = tid; e < L.tile; e += T) sav[e] = 0.f;
  for (int e = tid; e < L.ring - L.at; e += T) sm[L.at + e] = 0.f;  // a, Ja, W, P, G
  cp_async_wait_all();  // the primal tiles have landed
  compute_sync(T);
  uint32_t phase = 0;  // bit s: the parity of slot s's next fill
  const auto wait_full = [&](int s) {
    mbar_wait(full + s, (phase >> s) & 1u);
    phase ^= 1u << s;
  };

  // a = softmax(q k^T / sqrt(dh)) over j, stored transposed
  for (int i0 = warp * rpw; i0 < n; i0 += nwarps * rpw) {
    const int i = min(i0 + rsub, n - 1);
    const bool oki = i0 + rsub < n;
    const float *qi = sq + i * ldt, *k0 = sk + j0 * ldt, *k1 = sk + j1 * ldt;
    float z0 = 0.f, z1 = 0.f;
    for (int c = 0; c < dh; c += 4) {
      const float4 qv = ld4(qi + c);
      z0 += dot4(qv, ld4(k0 + c));
      z1 += dot4(qv, ld4(k1 + c));
    }
    z0 *= scale;
    z1 *= scale;
    const float mx = group_max(fmaxf(ok0 ? z0 : -INFINITY, ok1 ? z1 : -INFINITY), lpr);
    const float e0 = ok0 ? expf(z0 - mx) : 0.f, e1 = ok1 ? expf(z1 - mx) : 0.f;
    const float inv_s = 1.f / group_sum(e0 + e1, lpr);
    if (oki && ok0) pset(sat, i, j0, e0 * inv_s);
    if (oki && ok1) pset(sat, i, j1, e1 * inv_s);
  }

  int slot_q = 0, slot_prev = -1;  // ring slots of direction kk's Jq tile, of kk - 1's Jv
  for (int kk = 0; kk < K; ++kk) {
    const int slot_k = slot_q + 1 == slots ? 0 : slot_q + 1;
    const int slot_v = slot_k + 1 == slots ? 0 : slot_k + 1;
    wait_full(slot_q);  // Jq_k and Jk_k have landed
    wait_full(slot_k);
    compute_sync(T);  // every thread is done with direction kk - 1
    if (tid == 0 && slot_prev >= 0) mbar_arrive(empty + slot_prev);
    const TJ* sjq = ringj + slot_q * slot_el;
    const TJ* sjk = ringj + slot_k * slot_el;

    // pass A: Jz_k and Jq_k Jk_k^T on the lane's 2 x 2 tile, g_k of its two
    // rows summed over the group's lanes, the sums' shares, Ja_k
    for (int p0 = warp * ppw; p0 < hn; p0 += nwarps * ppw) {
      const bool okp = a_ok && p0 + a_sub < hn;
      const int i0 = min(p0 + a_sub, hn - 1), i1 = min(i0 + hn, n - 1);
      const bool ok_i1 = okp && i0 + hn < n;
      const float *q0 = sq + i0 * ldt, *q1 = sq + i1 * ldt;
      const TJ *y0 = sjq + i0 * ldj, *y1 = sjq + i1 * ldj;
      const float *k0 = sk + a_jp * ldt, *k1 = sk + a_j1 * ldt;
      const TJ *x0 = sjk + a_jp * ldj, *x1 = sjk + a_j1 * ldj;
      float z00 = 0.f, z01 = 0.f, z10 = 0.f, z11 = 0.f;
      float c00 = 0.f, c01 = 0.f, c10 = 0.f, c11 = 0.f;
#pragma unroll 1
      for (int c = 0; c < dh; c += 4) {
        const float4 qa = op4<LOW>(ld4(q0 + c)), qb = op4<LOW>(ld4(q1 + c));
        const float4 ka = op4<LOW>(ld4(k0 + c)), kb = op4<LOW>(ld4(k1 + c));
        const float4 ya = op4<kRoundJ>(ld4(y0 + c)), yb = op4<kRoundJ>(ld4(y1 + c));
        const float4 xa = op4<kRoundJ>(ld4(x0 + c)), xb = op4<kRoundJ>(ld4(x1 + c));
        z00 = fma4sum(ya, ka, fma4sum(qa, xa, z00));
        z01 = fma4sum(ya, kb, fma4sum(qa, xb, z01));
        z10 = fma4sum(yb, ka, fma4sum(qb, xa, z10));
        z11 = fma4sum(yb, kb, fma4sum(qb, xb, z11));
        c00 = fma4sum(ya, xa, c00);
        c01 = fma4sum(ya, xb, c01);
        c10 = fma4sum(yb, xa, c10);
        c11 = fma4sum(yb, xb, c11);
      }
      z00 *= scale;
      z01 *= scale;
      z10 *= scale;
      z11 *= scale;
      const float2 aa = sat[a_jp * hn + i0], ab = a_ok1 ? sat[a_j1 * hn + i0] : make_float2(0.f, 0.f);
      const float g0 = pair_sum(aa.x * z00 + ab.x * z01, a_sub * hn, hn);
      const float g1 = pair_sum(aa.y * z10 + ab.y * z11, a_sub * hn, hn);
      const auto put = [&](int i, int j, float a, float z, float x, float g) {
        const int e = i * n + j;
        sw[e] += 2.f * scale * x + z * z;
        sp[e] += z * g;
        pset(sjat, i, j, LOW ? bf(a * (z - g)) : a * (z - g));  // Ja_k feeds only contractions
      };
      if (okp) {
        put(i0, a_jp, aa.x, z00, c00, g0);
        if (a_ok1) put(i0, a_j1, ab.x, z01, c01, g0);
        if (a_jp == 0) sg[i0] += g0 * g0;
      }
      if (ok_i1) {
        put(i1, a_jp, aa.y, z10, c10, g1);
        if (a_ok1) put(i1, a_j1, ab.y, z11, c11, g1);
        if (a_jp == 0) sg[i1] += g1 * g1;
      }
    }

    wait_full(slot_v);  // Jv_k has landed
    compute_sync(T);  // Ja_k is written, Jq_k and Jk_k are read
    if (tid == 0) {
      mbar_arrive(empty + slot_q);
      mbar_arrive(empty + slot_k);
    }
    const TJ* sjv = ringj + slot_v * slot_el;
    slot_prev = slot_v;
    slot_q = slot_v + 1 == slots ? 0 : slot_v + 1;

    // pass B: Jt_k = Ja_k v + a Jv_k for rows i and i + hn; Sav += Ja_k Jv_k
    TJ* jtk = static_cast<TJ*>(pr.jt) + ((long)b * K + kk) * n * HD + (long)h * dh;
    for (int e = tid; e < hn * dq; e += T) {
      const int i0 = e / dq, c = 4 * (e % dq);
      const bool has1 = i0 + hn < n;
      const int i1 = has1 ? i0 + hn : i0;
      float4 t0v = make_float4(0.f, 0.f, 0.f, 0.f), t1v = t0v, s0 = t0v, s1 = t0v;
      for (int j = 0; j < n; ++j) {
        const float4 vj = op4<LOW>(ld4(sv + j * ldt + c)), jvj = op4<kRoundJ>(ld4(sjv + j * ldj + c));
        const float2 ja = sjat[j * hn + i0], a = op2<LOW>(sat[j * hn + i0]);
        fma4(t0v, ja.x, vj);
        fma4(t0v, a.x, jvj);
        fma4(s0, ja.x, jvj);
        fma4(t1v, ja.y, vj);
        fma4(t1v, a.y, jvj);
        fma4(s1, ja.y, jvj);
      }
      st4(jtk + i0 * HD + c, t0v);
      st4(sav + i0 * ldt + c, add4(ld4(sav + i0 * ldt + c), s0));
      if (has1) {
        st4(jtk + i1 * HD + c, t1v);
        st4(sav + i1 * ldt + c, add4(ld4(sav + i1 * ldt + c), s1));
      }
    }
  }

  // ---- the Laplacian: Lq, Lk, Lv into the ring's room, as float tiles (every
  // tile of the stream has landed and been read)
  compute_sync(T);
  float *slq = ring, *slk = ring + L.tile, *slv = ring + 2 * L.tile;
  copy_tile(slq, pr.lq + pbase, 0, T);
  copy_tile(slk, pr.lk + pbase, 0, T);
  copy_tile(slv, pr.lv + pbase, 0, T);
  cp_async_wait_all();
  compute_sync(T);
  for (int i0 = warp * rpw; i0 < n; i0 += nwarps * rpw) {  // La = a (w - m - 2 P + 2 G)
    const int i = min(i0 + rsub, n - 1);
    const bool oki = i0 + rsub < n;
    const float *qi = sq + i * ldt, *lqi = slq + i * ldt;
    const float *k0 = sk + j0 * ldt, *k1 = sk + j1 * ldt;
    const float *lk0 = slk + j0 * ldt, *lk1 = slk + j1 * ldt;
    float z0 = 0.f, z1 = 0.f;
    for (int c = 0; c < dh; c += 4) {
      const float4 lqv = ld4(lqi + c), qv = ld4(qi + c);
      z0 += dot4(lqv, ld4(k0 + c)) + dot4(qv, ld4(lk0 + c));
      z1 += dot4(lqv, ld4(k1 + c)) + dot4(qv, ld4(lk1 + c));
    }
    const float w0 = z0 * scale + sw[i * n + j0], w1 = z1 * scale + sw[i * n + j1];
    const float a0 = ok0 ? pget(sat, i, j0) : 0.f, a1 = ok1 ? pget(sat, i, j1) : 0.f;
    const float m = group_sum(a0 * w0 + a1 * w1, lpr);
    const float g2 = 2.f * sg[i];
    if (oki && ok0) pset(sjat, i, j0, a0 * (w0 - m - 2.f * sp[i * n + j0] + g2));
    if (oki && ok1) pset(sjat, i, j1, a1 * (w1 - m - 2.f * sp[i * n + j1] + g2));
  }
  compute_sync(T);
  for (int e = tid; e < hn * dq; e += T) {  // t = a v, Lt = La v + a Lv + 2 Sav
    const int i0 = e / dq, c = 4 * (e % dq);
    const bool has1 = i0 + hn < n;
    const int i1 = has1 ? i0 + hn : i0;
    float4 t0v = make_float4(0.f, 0.f, 0.f, 0.f), t1v = t0v;
    float4 l0 = add4(ld4(sav + i0 * ldt + c), ld4(sav + i0 * ldt + c));
    float4 l1 = add4(ld4(sav + i1 * ldt + c), ld4(sav + i1 * ldt + c));
    for (int j = 0; j < n; ++j) {
      const float4 vj = ld4(sv + j * ldt + c), lvj = ld4(slv + j * ldt + c);
      const float2 a = sat[j * hn + i0], la = sjat[j * hn + i0];
      fma4(t0v, a.x, vj);
      fma4(l0, la.x, vj);
      fma4(l0, a.x, lvj);
      fma4(t1v, a.y, vj);
      fma4(l1, la.y, vj);
      fma4(l1, a.y, lvj);
    }
    st4(pr.t + pbase + i0 * HD + c, t0v);
    st4(pr.lt + pbase + i0 * HD + c, l0);
    if (has1) {
      st4(pr.t + pbase + i1 * HD + c, t1v);
      st4(pr.lt + pbase + i1 * HD + c, l1);
    }
  }
}

// The kernel for n, dh, the Jacobians' element type and the mode: the
// small-block instance where the block fits it.
using Kernel = void (*)(Params);

template <typename TJ, bool LOW>
Kernel kernel_of(int n, int dh) {
  return threads_for(n, dh) + 32 <= kSmallBlock
             ? fl_attention_kernel<kSmallBlock, kSmallBlocks, TJ, LOW>
             : fl_attention_kernel<kMaxThreads + 32, 1, TJ, LOW>;
}

Kernel kernel_for(int n, int dh, int jdtype, int low) {
  if (jdtype == 0) return low ? kernel_of<float, true>(n, dh) : kernel_of<float, false>(n, dh);
  return low ? kernel_of<__nv_bfloat16, true>(n, dh) : kernel_of<__nv_bfloat16, false>(n, dh);
}

}  // namespace

extern "C" {

// Shared-memory bytes of one block with a ring of `slots` [n, dh] Jacobian
// tiles of `jbytes`-byte elements; the wrapper picks `slots` from it.  K does
// not enter: nothing resident grows with it.
long fl_attention_smem_bytes(int n, int dh, int slots, int jbytes) {
  return (long)layout(n, dh, slots, jbytes).total * (long)sizeof(float);
}

// jdtype: the element type of jq, jk, jv and jt, 0 float, 1 bf16 (then dh % 8
// == 0); low: the Jacobian contractions on bf16-rounded operands.
int fl_attention_launch(const float* q, const float* k, const float* v,
                        const void* jq, const void* jk, const void* jv,
                        const float* lq, const float* lk, const float* lv,
                        float* t, void* jt, float* lt, int B, int K, int n,
                        int H, int dh, int slots, int jdtype, int low, void* stream) {
  if (dh % 4 != 0 || dh < 4 || n < 1 || n > kMaxN || K < 1 || slots < 3 || slots > 32 ||
      (jdtype != 0 && jdtype != 1) || (jdtype == 1 && dh % 8 != 0))
    return (int)cudaErrorInvalidValue;
  const long smem = fl_attention_smem_bytes(n, dh, slots, jdtype == 0 ? 4 : 2);
  const Kernel kernel = kernel_for(n, dh, jdtype, low);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Params pr{q, k, v, jq, jk, jv, lq, lk, lv, t, jt, lt, K, n, H, dh, slots};
  kernel<<<B * H, threads_for(n, dh) + 32, smem, (cudaStream_t)stream>>>(pr);
  return (int)cudaGetLastError();
}

}  // extern "C"

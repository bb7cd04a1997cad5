// Blocked flash-attention backward with GQA for Hopper (sm_90a).
//
// The JAX package has no backward kernel: its training step takes
// jax.value_and_grad (src/repro/train/step.py:54) through its XLA
// attention (src/repro/models/attention.py), whose forward the Pallas
// kernel src/repro/kernels/attention/kernel.py::_flash_kernel mirrors.
// The port differentiates its hand-written forward (attention.cu), so its
// backward is hand-written too.  From q (B,S,H,hd) and k, v (B,T,K,hd),
// bf16 or float32, with the forward's o (B,S,H,hd) f32, the output
// gradient dO (B,S,H,hd) f32 and the forward's lse (B,H,S) f32 (log2 of
// sum_t 2^(scale log2(e) q.k_t)), it gives dq, dk and dv in float32:
//
//   P  = 2^(scale log2(e) Q.K^T - lse)     (recomputed, never stored)
//   D  = rowsum(dO o)                      dP = dO.V^T
//   dS = P (dP - D)                        dV = sum_g P^T.dO
//   dQ = scale dS.K                        dK = scale sum_g dS^T.Q
//
// with query head h on kv head h / (H/K), causal aligned at the first
// position or not, any S and T, hd 16, 32, 64 or 128.
//
// Deterministic: two kernels a call and no float atomics.  (b) runs first:
// one CTA per (64-row q block, q head, batch) computes D for its rows,
// writes it (and, for bf16, dO rounded to bf16) for (a), and loops over the
// key blocks up to the diagonal accumulating dQ in registers.  (a) then
// runs one CTA per (64-row key block, kv head, batch): it loops over the G
// query heads of its group and over the q blocks the causal mask leaves,
// accumulating dK and dV in registers, so the sum over the group is a
// fixed-order loop inside the CTA.
//
// What bounds it on the card: at the training path's shape (B 2, S = T
// 4096, H 16, K 8, hd 128, bf16, causal) the five products over the
// unmasked pairs are ~0.34 TFLOP against ~0.34 GB of traffic, so the tensor
// cores bound it (bf16, 989 TFLOP/s), ~0.35 ms.  This first design does
// seven products over whole tiles (both kernels recompute P and dP), and is
// simple:
//
// bf16 inputs: mma.sync.m16n8k16 bf16 products with float32 accumulation
// (dO, P and dS rounded to bf16 for their products, as the JAX package's
// bf16 compute rounds them), 128 threads a CTA, each warp owning 16 rows
// of the CTA's block.  The tiles sit in shared memory as bf16 rows padded
// by 16 bytes (conflict-free ldmatrix); the operands come in by ldmatrix
// (.trans where the product runs along the rows of a tile).  The scores
// and dP of a 16 x 32 strip live in registers, and their accumulator
// layout is the A fragment of the next product, so P and dS never touch
// shared memory.  The streamed tiles (K and V in (b); Q, bf16 dO, lse and D
// in (a)) load by cp.async into two stages, the next while the current
// one's products run; (b) keeps its Q and dO A fragments in registers.
// Two CTAs share an SM (105 KB of shared memory each at hd 128).  wgmma,
// TMA and a persistent grid are later work.
//
// float32 inputs: the CUDA cores in float32 FMAs (67 TFLOP/s peak), which
// hold the float32 gate; 256 threads a CTA, every tile in shared memory with
// odd row strides, each thread owning 4 x 4 of a 64 x 64 product and
// 4 x hd/16 of a 64 x hd one.
//
// Both: masked pairs (causal, past T) give P = 0 exactly; rows past S read
// lse = +inf and D = 0, so they give P = 0 too; rows with no unmasked key
// carry lse = +inf from the forward and give 0, never NaN.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;  // rows of a q block and of a key block
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// ---------------------------------------------------------------------------
// bf16: mma.sync on the tensor cores

namespace tc {

constexpr int NT = 128;  // four warps, 16 rows of the block each

template <int HD>
struct Geo {
  static constexpr int LD = HD + 8;  // bf16 row stride: rows 16 B apart
  static constexpr int TILE = BM * LD;
  // two resident tiles, two stages of two streamed ones, and two stages
  // of (lse, D) rows
  static constexpr int SMEM = 6 * TILE * 2 + 4 * BM * 4;
  static_assert(HD % 16 == 0 && HD <= 128, "head dim");
};

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm4(uint32_t a, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm4_t(uint32_t a, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d (16 x 8, f32) += A (16 x 16 bf16, row) . B (16 x 8 bf16, col)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // a in the low half
  return *reinterpret_cast<const uint32_t*>(&h);
}

// A fragment of rows r0..r0+15, columns c0..c0+15 of a [row][col] tile
template <int HD>
__device__ __forceinline__ void frag_a(const bf16* t, int r0, int c0,
                                       int lane, uint32_t (&a)[4]) {
  ldsm4(saddr(t + (r0 + lane % 16) * Geo<HD>::LD + c0 + lane / 16 * 8), a);
}

// B fragments of two n-tiles (n0..n0+7, n0+8..n0+15) over k0..k0+15, from
// a tile stored [n][k] (k contiguous): b = {b0, b1 of n0; b0, b1 of n0+8}
template <int HD>
__device__ __forceinline__ void frag_b_nk(const bf16* t, int n0, int k0,
                                          int lane, uint32_t (&b)[4]) {
  ldsm4(saddr(t + (n0 + lane % 8 + lane / 16 * 8) * Geo<HD>::LD + k0 +
              (lane / 8) % 2 * 8),
        b);
}

// the same from a tile stored [k][n] (n contiguous), transposed on the way
template <int HD>
__device__ __forceinline__ void frag_b_kn(const bf16* t, int k0, int n0,
                                          int lane, uint32_t (&b)[4]) {
  ldsm4_t(saddr(t + (k0 + lane % 8 + (lane / 8) % 2 * 8) * Geo<HD>::LD +
                n0 + lane / 16 * 8),
          b);
}

__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int bytes, bool valid) {
  // src-size 0 zero-fills the destination and reads nothing
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
                 "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// rows [0, valid) of a (BM, HD) bf16 tile whose rows are `stride` elements
// apart in device memory -> shared memory by cp.async (not waited for);
// rows past `valid` are zero
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          size_t stride, int valid) {
  constexpr int V = HD / 8;  // 16-byte vectors a row
  for (int idx = threadIdx.x; idx < BM * V; idx += NT) {
    const int r = idx / V, c = idx % V * 8;
    const bool in = r < valid;
    cp_async(saddr(dst + r * Geo<HD>::LD + c), src + (in ? r * stride + c : 0),
             16, in);
  }
}

// (b) dQ, and D and bf16(dO) for (a).  Grid (q blocks, H, B).  The key
// blocks stream through two shared-memory stages: block j + 1 loads by
// cp.async while block j's products run.  Q and bf16(dO) stay in
// registers as A fragments.
template <int HD>
__global__ void __launch_bounds__(NT)
    flash_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const float* __restrict__ o,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            float* __restrict__ dq, float* __restrict__ delta,
                            bf16* __restrict__ dob, int S, int Tn, int H,
                            int KH, int causal, float scale) {
  using G = Geo<HD>;
  constexpr int LD = G::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + G::TILE;
  bf16* Ks = dOs + G::TILE;     // two stages of K, then two of V
  bf16* Vs = Ks + 2 * G::TILE;
  float* lse_s = reinterpret_cast<float*>(Vs + 2 * G::TILE);
  float* del_s = lse_s + BM;

  const int qb = gridDim.x - 1 - blockIdx.x;  // heaviest causal first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int q0 = qb * BM;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rows = min(BM, S - q0);
  const size_t row_q = (size_t)H * HD;  // q, o, dO: elements between rows
  const size_t row_k = (size_t)KH * HD;
  const int kv_end = causal ? min(q0 + BM, Tn) : Tn;
  const int n_tiles = (kv_end + BM - 1) / BM;
  const auto load_kv = [&](int jt) {
    const int t0 = jt * BM, st = jt & 1;
    const size_t kofs = ((size_t)b * Tn + t0) * row_k + (size_t)kh * HD;
    load_tile<HD>(Ks + st * G::TILE, k + kofs, row_k, min(BM, Tn - t0));
    load_tile<HD>(Vs + st * G::TILE, v + kofs, row_k, min(BM, Tn - t0));
  };

  load_tile<HD>(Qs, q + ((size_t)b * S + q0) * row_q + (size_t)h * HD, row_q,
                rows);
  load_kv(0);
  cp_commit();
  // D = rowsum(dO o) in float32, two threads a row, each over half of hd
  // in order, then their sum; dO rounded to bf16 for the products
  {
    const int r = tid / 2, c0 = tid % 2 * (HD / 2);
    float acc = 0.f;
    if (r < rows) {
      const size_t off =
          ((size_t)b * S + q0 + r) * row_q + (size_t)h * HD + c0;
      for (int c = 0; c < HD / 2; c += 4) {
        const float4 g = *reinterpret_cast<const float4*>(dout + off + c);
        const float4 y = *reinterpret_cast<const float4*>(o + off + c);
        acc = fmaf(g.x, y.x, acc);
        acc = fmaf(g.y, y.y, acc);
        acc = fmaf(g.z, y.z, acc);
        acc = fmaf(g.w, y.w, acc);
        const uint2 pk = make_uint2(pack(g.x, g.y), pack(g.z, g.w));
        *reinterpret_cast<uint2*>(dOs + r * LD + c0 + c) = pk;
        *reinterpret_cast<uint2*>(dob + off + c) = pk;
      }
    } else {
      for (int c = 0; c < HD / 2; c += 4)
        *reinterpret_cast<uint2*>(dOs + r * LD + c0 + c) = make_uint2(0u, 0u);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (tid % 2 == 0) {
      const bool in = r < rows;
      del_s[r] = in ? acc : 0.f;
      lse_s[r] = in ? lse[((size_t)b * H + h) * S + q0 + r] : inf();
      if (in) delta[((size_t)b * H + h) * S + q0 + r] = acc;
    }
  }
  cp_wait_all();
  __syncthreads();

  const int g = lane / 4, t = lane % 4;
  const int rw = warp * 16;  // the warp's first row in the block
  float lse_r[2], del_r[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    lse_r[e] = lse_s[rw + g + 8 * e];
    del_r[e] = del_s[rw + g + 8 * e];
  }
  uint32_t qf[HD / 16][4], df[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    frag_a<HD>(Qs, rw, kk * 16, lane, qf[kk]);
    frag_a<HD>(dOs, rw, kk * 16, lane, df[kk]);
  }
  const float sl2 = scale * kLog2e;

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int jt = 0; jt < n_tiles; ++jt) {
    const int t0 = jt * BM;
    const bf16* Kt = Ks + (jt & 1) * G::TILE;
    const bf16* Vt = Vs + (jt & 1) * G::TILE;
    if (jt + 1 < n_tiles) {  // the other stage was freed by the last barrier
      load_kv(jt + 1);
      cp_commit();
    }
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const int c0 = half * 32;  // key columns c0..c0+31 of the tile
      float s[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t bb[4];
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          frag_b_nk<HD>(Kt, c0 + np * 16, kk * 16, lane, bb);
          mma(s[2 * np], qf[kk], bb[0], bb[1]);
          mma(s[2 * np + 1], qf[kk], bb[2], bb[3]);
          frag_b_nk<HD>(Vt, c0 + np * 16, kk * 16, lane, bb);
          mma(dp[2 * np], df[kk], bb[0], bb[1]);
          mma(dp[2 * np + 1], df[kk], bb[2], bb[3]);
        }
      }
      // dS = P (dP - D) in place of s; element (n, e): row rw + g + 8 (e/2),
      // key t0 + c0 + 8 n + 2 t + e % 2
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = q0 + rw + g + 8 * (e / 2);
          const int col = t0 + c0 + 8 * n + 2 * t + e % 2;
          const bool ok = col < Tn && (!causal || col <= row);
          const float p = ok ? exp2f(fmaf(s[n][e], sl2, -lse_r[e / 2])) : 0.f;
          s[n][e] = p * (dp[n][e] - del_r[e / 2]);
        }
      // dQ += dS . K[c0 .. c0 + 31]
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const uint32_t a[4] = {pack(s[2 * ks][0], s[2 * ks][1]),
                               pack(s[2 * ks][2], s[2 * ks][3]),
                               pack(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                               pack(s[2 * ks + 1][2], s[2 * ks + 1][3])};
#pragma unroll
        for (int n0 = 0; n0 < HD; n0 += 16) {
          uint32_t bb[4];
          frag_b_kn<HD>(Kt, c0 + ks * 16, n0, lane, bb);
          mma(acc[n0 / 8], a, bb[0], bb[1]);
          mma(acc[n0 / 8 + 1], a, bb[2], bb[3]);
        }
      }
    }
    cp_wait_all();
    __syncthreads();  // the next stage has landed; this one is free
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = rw + g + 8 * e;
    if (r >= rows) continue;
    float* dst = dq + ((size_t)b * S + q0 + r) * row_q + (size_t)h * HD;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n + 2 * t) =
          make_float2(acc[n][2 * e] * scale, acc[n][2 * e + 1] * scale);
  }
}

// (a) dK and dV.  Grid (key blocks, KH, B); reads D and bf16(dO) from (b).
// The (query head, q block) steps stream Q, bf16(dO), lse and D through
// two shared-memory stages, step i + 1 loading by cp.async while step i's
// products run.
template <int HD>
__global__ void __launch_bounds__(NT)
    flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ dob,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv,
                              int S, int Tn, int H, int KH, int causal,
                              float scale) {
  using G = Geo<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + G::TILE;
  bf16* Qs = Vs + G::TILE;      // two stages of Q, then two of dO
  bf16* dOs = Qs + 2 * G::TILE;
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * G::TILE);  // two stages
  float* del_s = lse_s + 2 * BM;

  const int kb = blockIdx.x;  // heaviest causal first: block 0 sees all q
  const int kh = blockIdx.y, b = blockIdx.z;
  const int GH = H / KH;
  const int t0 = kb * BM;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int rw = warp * 16;
  const size_t row_q = (size_t)H * HD, row_k = (size_t)KH * HD;
  const int krows = min(BM, Tn - t0);
  const float sl2 = scale * kLog2e;
  // steps i = (query head gi, q block qt_begin + it), q blocks innermost
  const int qt_begin = causal ? t0 / BM : 0;
  const int n_qt = (S + BM - 1) / BM - qt_begin;
  const int n_steps = n_qt > 0 ? GH * n_qt : 0;
  const auto load_step = [&](int i) {
    const int st = i & 1;
    const int h = kh * GH + i / n_qt;
    const int q0 = (qt_begin + i % n_qt) * BM;
    const int rows = min(BM, S - q0);
    const size_t qofs = ((size_t)b * S + q0) * row_q + (size_t)h * HD;
    load_tile<HD>(Qs + st * G::TILE, q + qofs, row_q, rows);
    load_tile<HD>(dOs + st * G::TILE, dob + qofs, row_q, rows);
    if (tid < BM) {
      const bool in = tid < rows;
      const size_t at = ((size_t)b * H + h) * S + q0 + (in ? tid : 0);
      cp_async(saddr(lse_s + st * BM + tid), lse + at, 4, in);
      cp_async(saddr(del_s + st * BM + tid), delta + at, 4, in);
    }
  };

  const size_t kofs = ((size_t)b * Tn + t0) * row_k + (size_t)kh * HD;
  load_tile<HD>(Ks, k + kofs, row_k, krows);
  load_tile<HD>(Vs, v + kofs, row_k, krows);
  if (n_steps > 0) load_step(0);
  cp_commit();
  cp_wait_all();
  __syncthreads();

  float ak[HD / 8][4], av[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[n][e] = av[n][e] = 0.f;

#pragma unroll 1
  for (int i = 0; i < n_steps; ++i) {
    const int q0 = (qt_begin + i % n_qt) * BM;
    const bf16* Qt = Qs + (i & 1) * G::TILE;
    const bf16* dOt = dOs + (i & 1) * G::TILE;
    const float* lse_t = lse_s + (i & 1) * BM;
    const float* del_t = del_s + (i & 1) * BM;
    if (i + 1 < n_steps) {  // the other stage was freed by the last barrier
      load_step(i + 1);
      cp_commit();
    }
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const int c0 = half * 32;  // q columns c0..c0+31 of the block
      float s[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      // S^T = K.Q^T and dP^T = V.dO^T for the warp's 16 keys
#pragma unroll
      for (int kk = 0; kk < HD; kk += 16) {
        uint32_t a[4], bb[4];
        frag_a<HD>(Ks, rw, kk, lane, a);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          frag_b_nk<HD>(Qt, c0 + np * 16, kk, lane, bb);
          mma(s[2 * np], a, bb[0], bb[1]);
          mma(s[2 * np + 1], a, bb[2], bb[3]);
        }
        frag_a<HD>(Vs, rw, kk, lane, a);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          frag_b_nk<HD>(dOt, c0 + np * 16, kk, lane, bb);
          mma(dp[2 * np], a, bb[0], bb[1]);
          mma(dp[2 * np + 1], a, bb[2], bb[3]);
        }
      }
      // P^T into s, dS^T into dp; element (n, e): key t0 + rw + g +
      // 8 (e/2), query q0 + c0 + 8 n + 2 t + e % 2
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = t0 + rw + g + 8 * (e / 2);
          const int qc = c0 + 8 * n + 2 * t + e % 2;
          const bool ok = key < Tn && q0 + qc < S &&
                          (!causal || key <= q0 + qc);
          const float p = ok ? exp2f(fmaf(s[n][e], sl2, -lse_t[qc])) : 0.f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - del_t[qc]);
        }
      // dV += P^T . dO[c0 .. c0 + 31], dK += dS^T . Q[c0 .. c0 + 31]
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const uint32_t ap[4] = {pack(s[2 * ks][0], s[2 * ks][1]),
                                pack(s[2 * ks][2], s[2 * ks][3]),
                                pack(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                                pack(s[2 * ks + 1][2], s[2 * ks + 1][3])};
        const uint32_t ad[4] = {pack(dp[2 * ks][0], dp[2 * ks][1]),
                                pack(dp[2 * ks][2], dp[2 * ks][3]),
                                pack(dp[2 * ks + 1][0], dp[2 * ks + 1][1]),
                                pack(dp[2 * ks + 1][2], dp[2 * ks + 1][3])};
#pragma unroll
        for (int n0 = 0; n0 < HD; n0 += 16) {
          uint32_t bb[4];
          frag_b_kn<HD>(dOt, c0 + ks * 16, n0, lane, bb);
          mma(av[n0 / 8], ap, bb[0], bb[1]);
          mma(av[n0 / 8 + 1], ap, bb[2], bb[3]);
          frag_b_kn<HD>(Qt, c0 + ks * 16, n0, lane, bb);
          mma(ak[n0 / 8], ad, bb[0], bb[1]);
          mma(ak[n0 / 8 + 1], ad, bb[2], bb[3]);
        }
      }
    }
    cp_wait_all();
    __syncthreads();  // the next stage has landed; this one is free
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = rw + g + 8 * e;
    if (r >= krows) continue;
    const size_t off = ((size_t)b * Tn + t0 + r) * row_k + (size_t)kh * HD;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      *reinterpret_cast<float2*>(dk + off + 8 * n + 2 * t) =
          make_float2(ak[n][2 * e] * scale, ak[n][2 * e + 1] * scale);
      *reinterpret_cast<float2*>(dv + off + 8 * n + 2 * t) =
          make_float2(av[n][2 * e], av[n][2 * e + 1]);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* dq, void* dk, void* dv,
           void* delta, void* dob, int B, int S, int Tn, int H, int KH,
           int causal, float scale, cudaStream_t st) {
  const int smem = Geo<HD>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_mma_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dkdv_mma_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_mma_kernel<HD><<<dim3((S + BM - 1) / BM, H, B), NT, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(o),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(dq), static_cast<float*>(delta),
      static_cast<bf16*>(dob), S, Tn, H, KH, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_mma_kernel<HD>
      <<<dim3((Tn + BM - 1) / BM, KH, B), NT, smem, st>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(dob),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<float*>(dk), static_cast<float*>(dv), S, Tn, H, KH,
          causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// float32: the CUDA cores

namespace simt {

constexpr int NT = 256;  // (ty, tx) = (tid / 16, tid % 16)

template <int HD>
struct Geo {
  static constexpr int LD = HD + 1;  // odd float strides: no conflicts
  static constexpr int PD = BM + 1;
  static constexpr int ND = HD / 16;  // head dims a thread owns
  static constexpr int TILE = BM * LD;
  static constexpr int SMEM = (4 * TILE + 2 * BM * PD + 2 * BM) * 4;
  static_assert(HD % 16 == 0 && HD <= 128, "head dim");
};

// rows [0, valid) of a (BM, HD) float32 tile, `stride` floats apart ->
// shared memory; rows past `valid` are zero
template <int HD, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          size_t stride, int valid) {
  for (int idx = threadIdx.x; idx < BM * HD; idx += NT) {
    const int r = idx / HD, c = idx % HD;
    dst[r * Geo<HD>::LD + c] = r < valid ? (float)src[r * stride + c] : 0.f;
  }
}

// c[i][j] = sum_d A[ty + 16 i][d] B[tx + 16 j][d] over two (BM, HD) tiles
template <int HD>
__device__ __forceinline__ void nt_product(const float* A, const float* Bt,
                                           int ty, int tx, float (&c)[4][4]) {
  constexpr int LD = Geo<HD>::LD;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float a[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bb[j] = Bt[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = fmaf(a[i], bb[j], c[i][j]);
  }
}

// acc[i][n] += sum_c P[ty + 16 i][c] X[c][tx + 16 n], P (BM, BM), X (BM, HD)
template <int HD>
__device__ __forceinline__ void nn_product(const float* P, const float* X,
                                           int ty, int tx,
                                           float (&acc)[4][Geo<HD>::ND]) {
  constexpr int LD = Geo<HD>::LD, PD = Geo<HD>::PD, ND = Geo<HD>::ND;
#pragma unroll 4
  for (int c = 0; c < BM; ++c) {
    float p[4], x[ND];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[(ty + 16 * i) * PD + c];
#pragma unroll
    for (int n = 0; n < ND; ++n) x[n] = X[c * LD + tx + 16 * n];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int n = 0; n < ND; ++n) acc[i][n] = fmaf(p[i], x[n], acc[i][n]);
  }
}

// (b) dQ, and D for (a).  Grid (q blocks, H, B).
template <int HD>
__global__ void __launch_bounds__(NT)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ o,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        float* __restrict__ dq, float* __restrict__ delta,
                        int S, int Tn, int H, int KH, int causal,
                        float scale) {
  using G = Geo<HD>;
  constexpr int PD = G::PD, ND = G::ND;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + G::TILE;
  float* Ks = dOs + G::TILE;
  float* Vs = Ks + G::TILE;
  float* Ps = Vs + G::TILE;  // dS
  float* lse_s = Ps + 2 * BM * PD;
  float* del_s = lse_s + BM;

  const int qb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int q0 = qb * BM;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int rows = min(BM, S - q0);
  const size_t row_q = (size_t)H * HD, row_k = (size_t)KH * HD;
  const size_t qofs = ((size_t)b * S + q0) * row_q + (size_t)h * HD;

  load_tile<HD>(Qs, q + qofs, row_q, rows);
  load_tile<HD>(dOs, dout + qofs, row_q, rows);
  // D = rowsum(dO o): four threads a row, each over every 4th head dim in
  // order, then a fixed pairwise sum
  {
    const int r = tid / 4, part = tid % 4;
    float acc = 0.f;
    if (r < rows)
      for (int c = part; c < HD; c += 4)
        acc = fmaf(dout[qofs + r * row_q + c], o[qofs + r * row_q + c], acc);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      const bool in = r < rows;
      del_s[r] = in ? acc : 0.f;
      lse_s[r] = in ? lse[((size_t)b * H + h) * S + q0 + r] : inf();
      if (in) delta[((size_t)b * H + h) * S + q0 + r] = acc;
    }
  }
  const float sl2 = scale * kLog2e;
  float acc[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < ND; ++n) acc[i][n] = 0.f;

  const int kv_end = causal ? min(q0 + BM, Tn) : Tn;
  const int n_tiles = (kv_end + BM - 1) / BM;
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int t0 = jt * BM;
    __syncthreads();
    const size_t kofs = ((size_t)b * Tn + t0) * row_k + (size_t)kh * HD;
    load_tile<HD>(Ks, k + kofs, row_k, min(BM, Tn - t0));
    load_tile<HD>(Vs, v + kofs, row_k, min(BM, Tn - t0));
    __syncthreads();
    float s[4][4], dp[4][4];
    nt_product<HD>(Qs, Ks, ty, tx, s);
    nt_product<HD>(dOs, Vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const bool ok = t0 + c < Tn && (!causal || t0 + c <= q0 + r);
        const float p = ok ? exp2f(fmaf(s[i][j], sl2, -lse_s[r])) : 0.f;
        Ps[r * PD + c] = p * (dp[i][j] - del_s[r]);
      }
    __syncthreads();
    nn_product<HD>(Ps, Ks, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      dq[qofs + r * row_q + tx + 16 * n] = acc[i][n] * scale;
  }
}

// (a) dK and dV.  Grid (key blocks, KH, B); reads D from (b).
template <int HD>
__global__ void __launch_bounds__(NT)
    flash_bwd_dkdv_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int S, int Tn, int H, int KH, int causal,
                          float scale) {
  using G = Geo<HD>;
  constexpr int PD = G::PD, ND = G::ND;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + G::TILE;
  float* Qs = Vs + G::TILE;
  float* dOs = Qs + G::TILE;
  float* Ps = dOs + G::TILE;  // P^T
  float* Ds = Ps + BM * PD;   // dS^T
  float* lse_s = Ds + BM * PD;
  float* del_s = lse_s + BM;

  const int kb = blockIdx.x;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int GH = H / KH;
  const int t0 = kb * BM;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t row_q = (size_t)H * HD, row_k = (size_t)KH * HD;
  const int krows = min(BM, Tn - t0);
  const float sl2 = scale * kLog2e;
  const size_t kofs = ((size_t)b * Tn + t0) * row_k + (size_t)kh * HD;
  load_tile<HD>(Ks, k + kofs, row_k, krows);
  load_tile<HD>(Vs, v + kofs, row_k, krows);

  float ak[4][ND], av[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < ND; ++n) ak[i][n] = av[i][n] = 0.f;

  const int qt_begin = causal ? t0 / BM : 0;
  const int n_qt = (S + BM - 1) / BM;
  for (int gi = 0; gi < GH; ++gi) {
    const int h = kh * GH + gi;
    for (int it = qt_begin; it < n_qt; ++it) {
      const int q0 = it * BM;
      const int rows = min(BM, S - q0);
      __syncthreads();
      const size_t qofs = ((size_t)b * S + q0) * row_q + (size_t)h * HD;
      load_tile<HD>(Qs, q + qofs, row_q, rows);
      load_tile<HD>(dOs, dout + qofs, row_q, rows);
      if (tid < BM) {
        const bool in = tid < rows;
        const size_t at = ((size_t)b * H + h) * S + q0 + tid;
        lse_s[tid] = in ? lse[at] : inf();
        del_s[tid] = in ? delta[at] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      nt_product<HD>(Ks, Qs, ty, tx, s);
      nt_product<HD>(Vs, dOs, ty, tx, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;  // key r, query c
          const bool ok = t0 + r < Tn && (!causal || t0 + r <= q0 + c);
          const float p = ok ? exp2f(fmaf(s[i][j], sl2, -lse_s[c])) : 0.f;
          Ps[r * PD + c] = p;
          Ds[r * PD + c] = p * (dp[i][j] - del_s[c]);
        }
      __syncthreads();
      nn_product<HD>(Ps, dOs, ty, tx, av);
      nn_product<HD>(Ds, Qs, ty, tx, ak);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= krows) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      dk[kofs + r * row_k + tx + 16 * n] = ak[i][n] * scale;
      dv[kofs + r * row_k + tx + 16 * n] = av[i][n];
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* dq, void* dk, void* dv,
           void* delta, int B, int S, int Tn, int H, int KH, int causal,
           float scale, cudaStream_t st) {
  const int smem = Geo<HD>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return (int)err;
  const float* fq = static_cast<const float*>(q);
  const float* fk = static_cast<const float*>(k);
  const float* fv = static_cast<const float*>(v);
  const float* fdo = static_cast<const float*>(dout);
  const float* fl = static_cast<const float*>(lse);
  flash_bwd_dq_kernel<HD><<<dim3((S + BM - 1) / BM, H, B), NT, smem, st>>>(
      fq, fk, fv, static_cast<const float*>(o), fdo, fl,
      static_cast<float*>(dq), static_cast<float*>(delta), S, Tn, H, KH,
      causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_kernel<HD><<<dim3((Tn + BM - 1) / BM, KH, B), NT, smem, st>>>(
      fq, fk, fv, fdo, fl, static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), S, Tn, H, KH, causal,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace simt

}  // namespace

extern "C" {

// dynamic shared memory of the instances for (hd, input type), bytes
int repro_flash_attention_bwd_smem(int hd, int is_bf16) {
  switch (hd) {
    case 16: return is_bf16 ? tc::Geo<16>::SMEM : simt::Geo<16>::SMEM;
    case 32: return is_bf16 ? tc::Geo<32>::SMEM : simt::Geo<32>::SMEM;
    case 64: return is_bf16 ? tc::Geo<64>::SMEM : simt::Geo<64>::SMEM;
    case 128: return is_bf16 ? tc::Geo<128>::SMEM : simt::Geo<128>::SMEM;
    default: return 0;
  }
}

// q (B,S,H,hd), k/v (B,T,KH,hd) contiguous, f32 (is_bf16 = 0) or bf16;
// o, dout (B,S,H,hd) and lse (B,H,S) float32 from the forward; outputs dq
// (B,S,H,hd), dk/dv (B,T,KH,hd) float32; scratch delta (B,H,S) float32
// and, for bf16, dob (B,S,H,hd) bf16.  All 16-byte aligned.  Launches (b)
// then (a) on `stream`.  Returns a cudaError_t.
int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const void* lse, void* dq, void* dk, void* dv,
                              void* delta, void* dob, int B, int S, int Tn,
                              int H, int KH, int hd, int is_bf16, int causal,
                              float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_BWD(HD)                                                        \
  return is_bf16 ? tc::launch<HD>(q, k, v, o, dout, lse, dq, dk, dv, delta, \
                                  dob, B, S, Tn, H, KH, causal, scale, st)  \
                 : simt::launch<HD>(q, k, v, o, dout, lse, dq, dk, dv, delta, \
                                   B, S, Tn, H, KH, causal, scale, st)
  switch (hd) {
    case 16: REPRO_BWD(16);
    case 32: REPRO_BWD(32);
    case 64: REPRO_BWD(64);
    case 128: REPRO_BWD(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_BWD
}

}  // extern "C"

// Blocked flash-attention forward with GQA for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/attention/kernel.py::_flash_kernel
// (pallas_call in flash_attention_pallas): q (B,S,H,hd), k/v (B,T,K,hd)
// with kv head = h / (H/K), online softmax with float32 accumulation,
// float32 output (B,S,H,hd), causal (aligned at the first position, as
// attention_ref masks) or not.  Any S and T (tails are masked), hd 16,
// 32, 64, 112, 128 or 256.  Every instance takes an attention-logit
// softcap and a sliding window as launch arguments (0 = none), which the
// JAX package computes in its XLA attention, not in the Pallas kernel
// (src/repro/models/attention.py): scores s = scale q.k, then
// softcap tanh(s / softcap), then the causal mask, then keys t <= q -
// window masked.  The bf16 kernel has two instances a head dim: a call
// with neither a softcap nor a window runs the one where both are
// compiled out.
//
// What bounds it on the card: at the serving path's prefill shape
// (B 8, S = T 1024, H 16, K 8, hd 128, bf16, causal) the function does
// ~34 GFLOP against ~134 MB of traffic, so the tensor-core bound (bf16,
// 989 TFLOP/s) and the bytes bound (3.35 TB/s) are both ~0.04 ms.  Two
// designs, one per input type:
//
// bf16 inputs (the serving path): flash_fwd_wgmma_kernel, on the tensor
// cores.  One CTA of 160 threads per (64-row q block, q head, batch),
// heaviest causal blocks first; two CTAs share an SM (81 KB of shared
// memory and <= 168 registers a thread each at hd 128), so one CTA's
// loads and stores overlap the other's products.  Warp 4 is the producer:
// one thread issues TMA loads, Q once and K and V tiles of 64 rows into a
// ring of two stages, K and V each with a "full" mbarrier (TMA bytes) and
// an "empty" one (the four consumer warps' releases), since a K tile is
// free as soon as its scores are in and a V tile only a step later.  The
// tensor maps are 4-d (hd, heads, seq, batch), so rows past S or T arrive
// as zeros, never as the next batch's rows; rows are cut into 64-column
// panels with the 128-byte swizzle (32- and 64-byte swizzles for hd 16
// and 32).  Warps 0-3 are the consumer warpgroup:
//   S = Q.K^T   wgmma m64n64k16, Q and K from shared memory (K-major),
//               bf16 products exact, float32 sums;
//   softmax     in registers on the accumulator layout (a thread holds
//               rows r and r + 8); `scale` applied to the float32 scores
//               as attention_ref does, exponentials in base 2; only the
//               diagonal and T-tail tiles are masked, tiles above the
//               diagonal are never loaded;
//   O += P.V    P split as P_hi = bf16(p), P_lo = bf16(p - P_hi), each fed
//               from registers (the accumulator layout is the A fragment)
//               to wgmma m64n{hd}k16 with V from shared memory as an
//               MN-major (transposed) operand: two bf16 products bring P's
//               rounding from 2^-9 (which misses the 1e-3 gate against the
//               float32 plain version) to ~2^-17, at twice P.V's work.
// Step j issues S_j and then P_{j-1}.V_{j-1} and runs tile j's softmax
// while the second product is in flight.  With one producer warp every
// thread has the registers it needs, so no setmaxnreg.  The output,
// acc / max(l, 1e-30), is stored straight from the accumulator (each
// warp store fills whole 32-byte sectors), rows past S dropped.
//
// float32 inputs: flash_fwd_kernel, on the CUDA cores
// in float32 FMAs (67 TFLOP/s peak), which holds the 2e-4 float32 gate.
// One CTA of 128 threads per (64-row q block, q head, batch).  The q tile
// is staged once in shared memory, pre-scaled by `scale` (the Pallas
// kernel scales q before its dot).  K and V tiles of 64 rows stream
// through shared memory; rows past T are zero-filled.  Thread (ty, tx) =
// (tid / 8, tid % 8) owns q rows ty + 16 i (i < 4) and, for scores, kv
// columns tx + 8 j (j < 8); the row max and sum are reduced across the 8
// tx lanes with shuffles.  P goes through shared memory for P.V, where
// the thread owns its 4 rows and hd/8 interleaved head dims.  Padded row
// strides keep every shared-memory access conflict-free.
//
// Both: masked scores (causal, windowed, or past T) contribute p = 0
// exactly and do not enter the row max; the running max starts at the
// finite -1e30 and the output divides by max(l, 1e-30), so a wholly
// masked row yields 0, not NaN (the reference gives such a row, which
// only a window can leave with no key, the mean of v: the wrapper
// refuses those calls).  Causal blocks stop at the diagonal; a
// windowed block starts at the tile that holds q0 - window + 1, so the
// tiles left of the window are never loaded, and the left-edge tiles are
// masked as the diagonal and T-tail tiles are.  The softcap's tanh is
// hopper.cuh's softcap_tanh in the bf16 kernel (1 - 2 / (1 + 2^(2 log2(e)
// x)) from ex2.approx and rcp.approx, a few 1e-7 absolute; the backward
// recomputes P with the same function) and the accurate tanhf in the f32
// kernel; tanh.approx.f32's 2^-11 relative error, times a cap of 50,
// would move a score by up to ~0.02.
//
// hd 112 (zamba2's shared attention) and hd 256 (gemma2): the bf16 kernel
// runs hd 112 on the 128-wide geometry: the tensor maps keep the tensor's
// 112 columns, so the TMA zero-fills columns 112-127 of the second
// 64-column panel; Q.K^T runs only the 7 k-steps that hold data, P.V runs
// n = 128 (14% more products there), and the epilogue stores 112
// columns.  hd 256 needs 128 accumulator registers a consumer thread and
// ~161 KB of shared memory (Q and two K/V stages), so its instance runs
// one CTA an SM (254 and 255 registers a thread without and with the cap
// and window, no setmaxnreg, no spill), P.V as two n = 128 products per
// k-step, and its softmax's exponentials as ex2.approx.ftz.  Two consumer
// warpgroups over one K/V ring were measured on an H100 and not taken
// (PERF.md): 128-row CTAs of two 64-row warpgroups need more than the 240
// registers setmaxnreg leaves a consumer (the 192 of the accumulators, S,
// P_hi and P_lo, plus the softmax's), and ptxas then spills and serializes
// every wgmma (C7512), also with P through shared memory: 1.8-2.0x the
// time; 64-row CTAs whose warpgroups score half a tile's keys each
// (m64n32k16) and exchange row maxima and P through shared memory fit
// (168 registers) but take 1.11-1.17x, for the two barriers a tile and
// the narrower products.
// The f32 kernel takes both with a P.V vector width that divides the head
// dim (2 at hd 112).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"  // mbarriers, TMA, wgmma (shared with the backward)

namespace {

constexpr int BQ = 64;        // q rows per CTA
constexpr int BK = 64;        // kv rows per tile
constexpr int NT = 128;       // threads per CTA
constexpr float NEG = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// log2 of a row's sum of exponentials, from its running max m (log2
// domain) and sum l: +inf for a row with no unmasked key, so that the
// backward's 2^(s - lse) is 0 there, never inf or NaN
__device__ __forceinline__ float row_lse2(float m2, float l) {
  return l > 0.f ? m2 + log2f(l) : __int_as_float(0x7f800000);
}

// the first kv tile of a q block starting at q0 under a sliding window
// (keys t > q - window; 0 = none): the tile that holds q0 - window + 1,
// at most the last one, so a block none of whose rows has a key still
// runs one wholly masked tile and writes zeros
__device__ __forceinline__ int first_tile(int q0, int window, int n_tiles) {
  if (window <= 0) return 0;
  return min(max(q0 - window + 1, 0) / BK, n_tiles - 1);
}

template <int N>
struct FV {
  float v[N];
};

// N consecutive elements of type T at p -> floats (p aligned to N elems)
template <int N, typename T>
__device__ __forceinline__ FV<N> loadv(const T* p);

template <>
__device__ __forceinline__ FV<4> loadv<4, float>(const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  return FV<4>{{a.x, a.y, a.z, a.w}};
}

template <>
__device__ __forceinline__ FV<2> loadv<2, float>(const float* p) {
  const float2 a = *reinterpret_cast<const float2*>(p);
  return FV<2>{{a.x, a.y}};
}

template <int HD, typename T>
struct Layout {
  static constexpr int E = 16 / sizeof(T);     // elements per 16 bytes
  static constexpr int QST = HD + 4;           // float row stride of Qs
  static constexpr int KST = HD + E;           // T row stride of Ks, Vs
  static constexpr int PST = BK + 8;           // float row stride of Ps
  // head dims per P.V load: 4 where 8 lanes x 4 divide the head dim, else
  // 2 (hd 16 and 112)
  static constexpr int VW = HD % 32 == 0 ? 4 : 2;
  static constexpr int NC = HD / (8 * VW);     // P.V loads per kv row
  static constexpr size_t SMEM =
      sizeof(float) * BQ * QST + 2 * sizeof(T) * BK * KST +
      sizeof(float) * BQ * PST;
  static_assert(HD % 16 == 0 && NC * 8 * VW == HD, "head dim");
  static_assert(SMEM <= 232448, "shared memory");
};

template <int HD, typename T>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int S, int Tn, int H, int KH,
                     int causal, float scale, float softcap, int window) {
  using L = Layout<HD, T>;
  constexpr int E = L::E, QST = L::QST, KST = L::KST, PST = L::PST;
  constexpr int VW = L::VW, NC = L::NC;

  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  T* Ks = reinterpret_cast<T*>(Qs + BQ * QST);
  T* Vs = Ks + BK * KST;
  float* Ps = reinterpret_cast<float*>(Vs + BK * KST);

  const int qb = gridDim.x - 1 - blockIdx.x;  // heaviest causal first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int q0 = qb * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int ty = tid >> 3;

  // q tile -> float32, scaled; rows past S are zero
  for (int idx = tid; idx < BQ * HD / 4; idx += NT) {
    const int r = idx / (HD / 4);
    const int c = (idx % (HD / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < S) {
      const FV<4> f =
          loadv<4, T>(q + ((size_t)(b * (size_t)S + q0 + r) * H + h) * HD + c);
      val = make_float4(f.v[0] * scale, f.v[1] * scale, f.v[2] * scale,
                        f.v[3] * scale);
    }
    *reinterpret_cast<float4*>(Qs + r * QST + c) = val;
  }

  float acc[4][NC][VW];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int jc = 0; jc < NC; ++jc)
#pragma unroll
      for (int e = 0; e < VW; ++e) acc[i][jc][e] = 0.f;
  }

  const int kv_end = causal ? min(q0 + BQ, Tn) : Tn;
  const int n_tiles = (kv_end + BK - 1) / BK;
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;

  for (int jt = first_tile(q0, window, n_tiles); jt < n_tiles; ++jt) {
    const int t0 = jt * BK;
    __syncthreads();  // Qs written; last tile's Ks/Vs/Ps reads finished
    for (int idx = tid; idx < BK * HD / E; idx += NT) {
      const int r = idx / (HD / E);
      const int c = (idx % (HD / E)) * E;
      uint4 kk = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = kk;
      if (t0 + r < Tn) {
        const size_t off =
            ((size_t)(b * (size_t)Tn + t0 + r) * KH + kh) * HD + c;
        kk = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(Ks + r * KST + c) = kk;
      *reinterpret_cast<uint4*>(Vs + r * KST + c) = vv;
    }
    __syncthreads();

    // scores: rows ty + 16 i, columns tx + 8 j
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      float4 qf[4];
      FV<4> kf[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qf[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * QST + d);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        kf[j] = loadv<4, T>(Ks + (tx + 8 * j) * KST + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float a = s[i][j];
          a = fmaf(qf[i].x, kf[j].v[0], a);
          a = fmaf(qf[i].y, kf[j].v[1], a);
          a = fmaf(qf[i].z, kf[j].v[2], a);
          a = fmaf(qf[i].w, kf[j].v[3], a);
          s[i][j] = a;
        }
    }
    if (softcap > 0.f) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = softcap * tanhf(s[i][j] * inv_cap);
    }

    // mask, online softmax update, P -> shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      bool ok[8];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int tj = t0 + tx + 8 * j;
        ok[j] = tj < Tn && (!causal || tj <= qi) &&
                (window <= 0 || tj > qi - window);
        if (ok[j]) mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * PST + tx + 8 * j] = p;
        rs += p;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int jc = 0; jc < NC; ++jc)
#pragma unroll
        for (int e = 0; e < VW; ++e) acc[i][jc][e] *= alpha;
    }
    __syncthreads();

    // acc += P . V over this tile
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 pf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pf[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * PST + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int jc = 0; jc < NC; ++jc) {
          const FV<VW> vf =
              loadv<VW, T>(Vs + (c + cc) * KST + jc * 8 * VW + tx * VW);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = cc == 0   ? pf[i].x
                            : cc == 1 ? pf[i].y
                            : cc == 2 ? pf[i].z
                                      : pf[i].w;
#pragma unroll
            for (int e = 0; e < VW; ++e)
              acc[i][jc][e] = fmaf(p, vf.v[e], acc[i][jc][e]);
          }
        }
      }
    }
  }

  // out = acc / max(l, 1e-30), rows past S dropped; the row's lse in
  // base 2 where asked for (m is the natural-log max of the scaled scores)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= S) continue;
    if (lse != nullptr && tx == 0)
      lse[((size_t)b * H + h) * S + r] = row_lse2(m[i] * kLog2e, l[i]);
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = o + ((size_t)(b * (size_t)S + r) * H + h) * HD;
#pragma unroll
    for (int jc = 0; jc < NC; ++jc)
#pragma unroll
      for (int e = 0; e < VW; ++e)
        orow[jc * 8 * VW + tx * VW + e] = acc[i][jc][e] / den;
  }
}

template <int HD, typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int S, int Tn, int H, int KH, int causal, float scale,
           float softcap, int window, cudaStream_t stream) {
  const size_t smem = Layout<HD, T>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<HD, T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(o), lse, S, Tn, H, KH,
      causal, scale, softcap, window);
  return (int)cudaGetLastError();
}

// the instances: f(std::integral_constant<int, hd>) for a supported hd
template <typename F>
int with_hd(int hd, F f) {
  switch (hd) {
    case 16: return f(std::integral_constant<int, 16>());
    case 32: return f(std::integral_constant<int, 32>());
    case 64: return f(std::integral_constant<int, 64>());
    case 112: return f(std::integral_constant<int, 112>());
    case 128: return f(std::integral_constant<int, 128>());
    case 256: return f(std::integral_constant<int, 256>());
    default: return -1;
  }
}


// ---------------------------------------------------------------------------
// bf16: wgmma + TMA (see the note at the top)

namespace tc {

constexpr int BQ = 64;       // q rows per CTA: one consumer warpgroup
constexpr int BK = 64;       // kv rows per tile
constexpr int STAGES = 2;    // K/V ring depth
constexpr int NT = 160;      // the consumer warpgroup, then a producer warp

template <int HD>
struct Geo {
  // the head dims the tiles hold: HD, or 128 for hd 112 (TMA zero-fills
  // columns 112-127)
  static constexpr int HDP = HD <= 64 ? HD : (HD + 63) / 64 * 64;
  static constexpr int SW = HDP * 2 < 128 ? HDP * 2 : 128;  // swizzle bytes
  static constexpr int PC = SW / 2;        // head dims per panel (a row of
  static constexpr int NP = HDP / PC;      // SW bytes); panels per row
  // two CTAs an SM up to hd 128 (<= 168 registers a thread); one at hd 256
  static constexpr int CTAS_PER_SM = HDP <= 128 ? 2 : 1;
  static constexpr uint32_t Q_BYTES = BQ * HDP * 2;
  static constexpr uint32_t KV_BYTES = BK * HDP * 2;  // one K or V tile
  // 1024 bytes of alignment slack, Q, the K and V rings, the mbarriers
  static constexpr int SMEM =
      1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (4 * STAGES + 1);
  static_assert(HD % 16 == 0 && HDP <= 256 && NP * PC == HDP, "head dim");
  static_assert(SMEM * CTAS_PER_SM <= 232448, "shared memory");
};

using namespace hopper;

// 2^x for the softmax: at hd 256 the MUFU's ex2.approx.ftz, as the
// backward takes its exponentials (results below 2^-126 flush to 0;
// scripts/kernel_turns.py --variant exp2f times the exp2f form).  The
// instances at hd <= 128 keep exp2f, the form their times were taken
// with; ex2 has not been timed there.
template <int HDP>
__device__ __forceinline__ float softmax_exp2(float x) {
  if constexpr (HDP > 128) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
  } else {
    return exp2f(x);
  }
}

// (a, b) -> bf16 pairs hi = bf16(a, b) and lo = bf16((a, b) - hi): hi + lo
// equals (a, b) to ~2^-17 relative, where hi alone is 2^-9
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// scores -> log2 domain: scale log2(e) s, or with a softcap
// cap log2(e) tanh(scale s / cap) (cap_in = scale / cap, cap_out =
// cap log2(e)); cap_out = 0 means no softcap
struct Scaling {
  float scale_log2, cap_in, cap_out;
};

// CW: the instance for a call with a softcap or a window; a call with
// neither runs CW = false, where both are compiled out
template <int HD, bool CW>
__global__ void __launch_bounds__(NT, Geo<HD>::CTAS_PER_SM)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           float* __restrict__ o, float* __restrict__ lse,
                           int S, int Tn, int H, int KH, int causal,
                           Scaling sg, int window) {
  using G = Geo<HD>;
  constexpr int HDP = G::HDP, SW = G::SW, PC = G::PC, NP = G::NP;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  // the swizzles repeat every 1024 bytes of shared-memory address
  const uint32_t sQ = (smem_addr(tc_smem) + 1023u) & ~1023u;
  const uint32_t sK = sQ + G::Q_BYTES;                 // STAGES K tiles
  const uint32_t sV = sK + STAGES * G::KV_BYTES;       // STAGES V tiles
  const uint32_t bars = sV + STAGES * G::KV_BYTES;
  // K and V have a full/empty pair each per stage: K is free once S is in,
  // V only after the P.V of the next step
  const auto full_k = [bars](int s) { return bars + 8u * s; };
  const auto full_v = [bars](int s) { return bars + 8u * (STAGES + s); };
  const auto empty_k = [bars](int s) { return bars + 8u * (2 * STAGES + s); };
  const auto empty_v = [bars](int s) { return bars + 8u * (3 * STAGES + s); };
  const uint32_t qbar = bars + 32u * STAGES;

  const int qb = gridDim.x - 1 - blockIdx.x;  // heaviest causal first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int q0 = qb * BQ;
  const int kv_end = causal ? min(q0 + BQ, Tn) : Tn;
  const int n_end = (kv_end + BK - 1) / BK;
  // the window's first tile, and the tiles this CTA runs
  const int jt0 = CW ? first_tile(q0, window, n_end) : 0;
  const int n_tiles = n_end - jt0;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k(s), 1);  // the producer's expect_tx arrival
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 4);  // one arrival per consumer warp
      mbar_init(empty_v(s), 4);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128) {
    // producer: one thread keeps the rings full
    if (tid == 128) {
      mbar_expect_tx(qbar, G::Q_BYTES);
      for (int p = 0; p < NP; ++p)
        tma_load(sQ + p * BQ * SW, &tq, qbar, p * PC, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES, row = (jt0 + j) * BK;
        const uint32_t free_parity = ((j / STAGES) & 1) ^ 1;  // 1st: free
        const uint32_t k_s = sK + s * G::KV_BYTES, v_s = sV + s * G::KV_BYTES;
        mbar_wait(empty_k(s), free_parity);
        mbar_expect_tx(full_k(s), G::KV_BYTES);
        for (int p = 0; p < NP; ++p)
          tma_load(k_s + p * BK * SW, &tk, full_k(s), p * PC, kh, row, b);
        mbar_wait(empty_v(s), free_parity);
        mbar_expect_tx(full_v(s), G::KV_BYTES);
        for (int p = 0; p < NP; ++p)
          tma_load(v_s + p * BK * SW, &tv, full_v(s), p * PC, kh, row, b);
      }
    }
    return;
  }

  // Consumers: step j issues S_j = Q.K_j^T, then O += P_{j-1}.V_{j-1}, and
  // runs the softmax of tile j while that second product is in flight.
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = q0 + warp * 16 + lane / 4;  // and row0 + 8
  const int cq = 2 * (lane % 4);  // column pair within each 8 columns
  float acc[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG, NEG};  // running max, log2 domain
  float l[2] = {0.f, 0.f};  // this thread's part of the running sum
  float alpha[2];
  float sc[BK / 2];
  uint32_t phi[BK / 4], plo[BK / 4];  // P of the previous step, bf16 pairs

  // S = Q.K^T of the tile in K stage s, over the k-steps of 16 head dims
  // (32 bytes of a panel row) that hold data, issued and committed
  const auto issue_qk = [&](int s) {
    const uint32_t ka = sK + s * G::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk * 16) / PC * BQ * SW + (kk * 16) % PC * 2;
      const uint32_t offk = (kk * 16) / PC * BK * SW + (kk * 16) % PC * 2;
      wgmma_ss(sc, desc_k<SW>(sQ + off), desc_k<SW>(ka + offk), kk > 0);
    }
    wg_commit();
  };
  // O += P_hi.V + P_lo.V with V in stage s, issued and committed; the pairs
  // 4 kk .. 4 kk + 3 are the A fragment of k-step kk; at hd 256 two
  // n = 128 products per k-step, each over two panels of V
  const auto issue_pv = [&](int s) {
    const uint32_t va = sV + s * G::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if constexpr (HDP <= 128) {
        const uint64_t dv = desc_mn<SW>(va + kk * 16 * SW, BK * SW);
        wgmma_rs(acc, phi[4 * kk], phi[4 * kk + 1], phi[4 * kk + 2],
                 phi[4 * kk + 3], dv);
        wgmma_rs(acc, plo[4 * kk], plo[4 * kk + 1], plo[4 * kk + 2],
                 plo[4 * kk + 3], dv);
      } else {
#pragma unroll
        for (int c = 0; c < HDP / 128; ++c) {
          float(&a)[64] = *reinterpret_cast<float(*)[64]>(acc + 64 * c);
          const uint64_t dv =
              desc_mn<SW>(va + 2 * c * BK * SW + kk * 16 * SW, BK * SW);
          wgmma_rs(a, phi[4 * kk], phi[4 * kk + 1], phi[4 * kk + 2],
                   phi[4 * kk + 3], dv);
          wgmma_rs(a, plo[4 * kk], plo[4 * kk + 1], plo[4 * kk + 2],
                   plo[4 * kk + 3], dv);
        }
      }
    }
    wg_commit();
  };
  // tile scores -> p = 2^(s' - m) in place, s' the scores in the log2
  // domain (Scaling), masked entries 0 (element i: row row0 + 8 ((i >> 1)
  // & 1), column t0 + 8 (i >> 2) + cq + (i & 1)); m and l updated, alpha
  // the rescale of the earlier sums
  const auto softmax = [&](int t0) {
    if (CW && sg.cap_out != 0.f) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        sc[i] = sg.cap_out * softcap_tanh(sc[i] * sg.cap_in);
    } else {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] *= sg.scale_log2;
    }
    if (t0 + BK > Tn || (causal && t0 + BK - 1 > q0) ||
        (CW && window > 0 && t0 <= q0 + BQ - 1 - window)) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int col = t0 + 8 * (i >> 2) + cq + (i & 1);
        const int row = row0 + 8 * ((i >> 1) & 1);
        if (col >= Tn || (causal && col > row) ||
            (CW && window > 0 && col <= row - window))
          sc[i] = __int_as_float(0xff800000);  // -inf: p = 0
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = softmax_exp2<HDP>(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      sc[i] = softmax_exp2<HDP>(sc[i] - m[(i >> 1) & 1]);
      l[(i >> 1) & 1] += sc[i];
    }
  };
  const auto split = [&]() {
#pragma unroll
    for (int j = 0; j < BK / 4; ++j)
      split_bf16(sc[2 * j], sc[2 * j + 1], phi[j], plo[j]);
  };
  const auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);  // this warp is done with the stage
  };

  mbar_wait(qbar, 0);
  mbar_wait(full_k(0), 0);
  wg_fence();
  issue_qk(0);
  wg_wait<0>();
  reg_fence(sc);
  release(empty_k(0));
  softmax(jt0 * BK);
  split();
  for (int j = 1; j < n_tiles; ++j) {
    const int s = j % STAGES, sp = (j - 1) % STAGES;
    mbar_wait(full_k(s), (j / STAGES) & 1);
    mbar_wait(full_v(sp), ((j - 1) / STAGES) & 1);
    reg_fence(acc);
    wg_fence();
    issue_qk(s);
    issue_pv(sp);
    wg_wait<1>();  // S_j is in; P_{j-1}.V_{j-1} may still run
    reg_fence(sc);
    release(empty_k(s));
    softmax((jt0 + j) * BK);
    wg_wait<0>();
    reg_fence(acc);
    reg_fence(sc);
    release(empty_v(sp));
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    split();
  }
  const int sl = (n_tiles - 1) % STAGES;
  mbar_wait(full_v(sl), ((n_tiles - 1) / STAGES) & 1);
  reg_fence(acc);
  wg_fence();
  issue_pv(sl);
  wg_wait<0>();
  reg_fence(acc);
  release(empty_v(sl));

  // out = acc / max(l, 1e-30), rows past S and columns past HD dropped;
  // the row's lse (m is in the log2 domain already) where asked for
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (lse != nullptr && lane % 4 == 0 && row < S)
      lse[((size_t)b * H + h) * S + row] = row_lse2(m[r], l[r]);
    l[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    float* orow = o + ((size_t)(b * (size_t)S + row) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j + cq) =
          make_float2(acc[4 * j + 2 * r] * l[r], acc[4 * j + 2 * r + 1] * l[r]);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int S, int Tn, int H, int KH, int causal, float scale,
           float softcap, int window, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  constexpr int SW = Geo<HD>::SW;
  // the maps hold the tensor's HD columns; a box past them reads zeros
  if (!encode_map<HD, SW>(&mq, q, B, S, H, BQ) ||
      !encode_map<HD, SW>(&mk, k, B, Tn, KH, BK) ||
      !encode_map<HD, SW>(&mv, v, B, Tn, KH, BK))
    return (int)cudaErrorInvalidValue;
  const int smem = Geo<HD>::SMEM;
  const auto kernel = softcap > 0.f || window > 0
                          ? flash_fwd_wgmma_kernel<HD, true>
                          : flash_fwd_wgmma_kernel<HD, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const Scaling sg = softcap > 0.f
                         ? Scaling{0.f, scale / softcap, softcap * kLog2e}
                         : Scaling{scale * kLog2e, 0.f, 0.f};
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kernel<<<grid, NT, smem, stream>>>(
      mq, mk, mv, static_cast<float*>(o), lse, S, Tn, H, KH, causal, sg,
      window);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// 1 when the kernel has an instance for this head dim
int repro_flash_attention_supported(int hd) {
  return with_hd(hd, [](auto) { return 1; }) == 1;
}

// dynamic shared memory of the instance for (hd, input type), bytes; 0
// for a head dim without an instance
int repro_flash_attention_smem(int hd, int is_bf16) {
  const int bytes = with_hd(hd, [is_bf16](auto c) {
    constexpr int HD = decltype(c)::value;
    return is_bf16 ? tc::Geo<HD>::SMEM : (int)Layout<HD, float>::SMEM;
  });
  return bytes < 0 ? 0 : bytes;
}

// q (B,S,H,hd), k/v (B,T,KH,hd) contiguous, f32 (is_bf16 = 0) or bf16,
// 16-byte aligned; o (B,S,H,hd) float32; lse (B,H,S) float32, each row's
// log2 of sum 2^(log2(e) s') over its unmasked scores s' (after the
// softcap), written when not null (the training path's backward reads
// it; serving passes null).  softcap <= 0: none; window <= 0: none.
// Returns a cudaError_t.
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* o, void* lse, int B, int S, int Tn, int H,
                          int KH, int hd, int is_bf16, int causal,
                          float scale, float softcap, int window,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const int rc = with_hd(hd, [&](auto c) {
    constexpr int HD = decltype(c)::value;
    return is_bf16 ? tc::launch<HD>(q, k, v, o, l, B, S, Tn, H, KH, causal,
                                    scale, softcap, window, st)
                   : launch<HD, float>(q, k, v, o, l, B, S, Tn, H, KH,
                                       causal, scale, softcap, window, st);
  });
  return rc < 0 ? (int)cudaErrorInvalidValue : rc;
}

}  // extern "C"

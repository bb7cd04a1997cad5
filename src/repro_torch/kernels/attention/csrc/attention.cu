// Blocked flash-attention forward with GQA for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/attention/kernel.py::_flash_kernel
// (pallas_call in flash_attention_pallas): q (B,S,H,hd), k/v (B,T,K,hd)
// with kv head = h / (H/K), online softmax with float32 accumulation,
// float32 output (B,S,H,hd), causal (aligned at the first position, as
// attention_ref masks) or not.
//
// What bounds it on the card: at the serving path's prefill shape
// (B 8, S = T 1024, H 16, K 8, hd 128, bf16) the work is ~34 GFLOP
// against ~134 MB of traffic, so the tensor-core bound (bf16, 989
// TFLOP/s) and the bytes bound (3.35 TB/s) are both ~0.04 ms.  This
// first version does the products on the CUDA cores in float32 (67
// TFLOP/s peak), so it is compute-bound far above that line; its design
// aims at being right at every length and at the stated tolerances
// (2e-4 for f32 inputs, 1e-3 for bf16 against the float32 plain
// version), which a bf16 P in a tensor-core P.V product would miss.
// wgmma, TMA and warp specialisation are later work.
//
// Design: one CTA of 128 threads per (64-row q block, q head, batch);
// heaviest causal blocks are scheduled first.  The q tile is staged once
// in shared memory as float32, pre-scaled by `scale` (the Pallas kernel
// scales q before its dot).  K and V tiles of 64 rows stream through
// shared memory in the input type; rows past T are zero-filled.  Thread
// (ty, tx) = (tid / 8, tid % 8) owns q rows ty + 16 i (i < 4) and, for
// scores, kv columns tx + 8 j (j < 8); the row max and sum are reduced
// across the 8 tx lanes with shuffles.  P goes through shared memory for
// P.V, where the thread owns its 4 rows and hd/8 interleaved head dims.
// Padded row strides keep every shared-memory access conflict-free.
// Masked scores (causal, or past T) contribute p = 0 exactly and do not
// enter the row max; the running max starts at the finite -1e30 and the
// output divides by max(l, 1e-30), so a wholly masked row yields 0, not
// NaN.  Causal blocks stop at the diagonal.  Any S and T: tails are
// masked, no divisibility is assumed.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // q rows per CTA
constexpr int BK = 64;        // kv rows per tile
constexpr int NT = 128;       // threads per CTA
constexpr float NEG = -1e30f;

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

template <>
__device__ __forceinline__ FV<4> loadv<4, __nv_bfloat16>(
    const __nv_bfloat16* p) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  return FV<4>{{a.x, a.y, b.x, b.y}};
}

template <>
__device__ __forceinline__ FV<2> loadv<2, __nv_bfloat16>(
    const __nv_bfloat16* p) {
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  return FV<2>{{a.x, a.y}};
}

template <int HD, typename T>
struct Layout {
  static constexpr int E = 16 / sizeof(T);     // elements per 16 bytes
  static constexpr int QST = HD + 4;           // float row stride of Qs
  static constexpr int KST = HD + E;           // T row stride of Ks, Vs
  static constexpr int PST = BK + 8;           // float row stride of Ps
  static constexpr int VW = HD >= 32 ? 4 : 2;  // head dims per P.V load
  static constexpr int NC = HD / (8 * VW);     // P.V loads per kv row
  static constexpr size_t SMEM =
      sizeof(float) * BQ * QST + 2 * sizeof(T) * BK * KST +
      sizeof(float) * BQ * PST;
  static_assert(HD % 16 == 0 && NC >= 1, "head dim must be 16..128");
};

template <int HD, typename T>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, float* __restrict__ o, int S,
                     int Tn, int H, int KH, int causal, float scale) {
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

  for (int jt = 0; jt < n_tiles; ++jt) {
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

    // mask, online softmax update, P -> shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      bool ok[8];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int tj = t0 + tx + 8 * j;
        ok[j] = tj < Tn && (!causal || tj <= qi);
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

  // out = acc / max(l, 1e-30), rows past S dropped
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= S) continue;
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
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int Tn, int H, int KH, int causal, float scale,
           cudaStream_t stream) {
  const size_t smem = Layout<HD, T>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<HD, T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(o), S, Tn, H, KH, causal,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v, void* o,
             int B, int S, int Tn, int H, int KH, int causal, float scale,
             cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<16, T>(q, k, v, o, B, S, Tn, H, KH, causal, scale, stream);
    case 32:
      return launch<32, T>(q, k, v, o, B, S, Tn, H, KH, causal, scale, stream);
    case 64:
      return launch<64, T>(q, k, v, o, B, S, Tn, H, KH, causal, scale, stream);
    case 128:
      return launch<128, T>(q, k, v, o, B, S, Tn, H, KH, causal, scale,
                            stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// 1 when the kernel has an instance for this head dim
int repro_flash_attention_supported(int hd) {
  return hd == 16 || hd == 32 || hd == 64 || hd == 128;
}

// q (B,S,H,hd), k/v (B,T,KH,hd) contiguous, f32 (is_bf16 = 0) or bf16,
// 16-byte aligned; o (B,S,H,hd) float32.  Returns a cudaError_t.
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* o, int B, int S, int Tn, int H, int KH,
                          int hd, int is_bf16, int causal, float scale,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(hd, q, k, v, o, B, S, Tn, H, KH, causal,
                                   scale, st);
  return dispatch<float>(hd, q, k, v, o, B, S, Tn, H, KH, causal, scale, st);
}

}  // extern "C"

// Mamba-2 SSD intra-chunk step for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/ssd/kernel.py::ssd_chunk_kernel (pallas_call in
// ssd_chunk_pallas).  For every (batch b, chunk c, head h), with the
// chunk's Q rows and float32 inputs x (B,c,Q,H,P), dt (B,c,Q,H), A (H,),
// B and C (B,c,Q,N):
//   a = dt * A, acum = inclusive cumsum of a over the chunk,
//   y_i    = sum_{j<=i} (C_i . B_j) exp(acum_i - acum_j) dt_j x_j  (Q,H,P)
//   state  = sum_j x_j (x) B_j dt_j exp(acum_last - acum_j)        (P,N)
//   decay  = exp(acum_last).
//
// What bounds it on the card: at the mamba2-2.7b prefill shape (B 8,
// S 1024, Q 256, c 4, H 80, P 64, N 128) the kernel must move ~431 MB
// (x and y 168 MB each, the states 84 MB), 0.129 ms at 3.35 TB/s, while
// its least arithmetic (C.B^T once per chunk, the causal half of the
// products) is ~21.5 GFLOP.  This first version does every product in
// float32 FMAs on the CUDA cores, so it is compute-bound well above the
// bytes bound; tensor cores (TF32 or split bf16 at this tolerance), TMA
// and a persistent schedule are later work.
//
// Design.  One CTA of 128 threads per (block of 64 output rows, group of
// HG = 8 heads, (b, c)), plus one CTA per (head group, (b, c)) for the
// chunk states and decays (blockIdx.x == 0, scheduled first; the heaviest
// causal row blocks follow).
// * Every CTA computes acum for its heads over the whole chunk: a = dt*A
//   in shared memory, then one thread per head sums it in order.  The
//   decay exponents are differences of sums of up to 256 terms of
//   magnitude ~1, so the order of the sum shows in them at ~1e-4
//   relative; summing in row order reproduces the plain version's
//   cumsum, which sums in order too.
// * Row-block CTAs first compute the head-independent scores
//   S = C_i . B_j for the block's 64 rows and every source row up to the
//   diagonal (64 x 64 tiles, N in chunks of 32 through padded shared
//   memory) and keep them in shared memory: C.B^T is computed once for 8
//   heads, not once per head as on the TPU.  Then for each head and each
//   source tile up to the diagonal: W = S * exp(acum_i - acum_j) where
//   j <= i and exactly 0 elsewhere (the exponential is never evaluated
//   above the diagonal, where it could overflow and make inf * 0 = NaN),
//   the source tile of x scaled by dt goes to shared memory, and the
//   thread's 4 rows x P/8 columns accumulate W . (dt x) in registers.
// * State CTAs accumulate (x dt exp(acum_last - acum))^T . B per head in
//   32-row steps, 64 state columns per pass, 8 x 16 threads over (P, 64).
// Thread (ty, tx) = (tid / 8, tid % 8) owns rows ty + 16 i (i < 4) and
// score columns tx + 8 j (j < 8), as in attention.cu; padded row strides
// keep the shared-memory accesses conflict-free.  Rows past Q are
// zero-filled and never written.  Any Q in 1..256, P in {8,16,32,64},
// N a multiple of 4.  Shared memory at Q 256, P 64: 111.6 KB, two CTAs
// per SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;       // threads per CTA
constexpr int BQ = 64;        // output rows per CTA, source rows per tile
constexpr int HG = 8;         // heads per CTA
constexpr int NCH = 32;       // state-dim chunk of the score product
constexpr int CST = NCH + 4;  // row stride of the C and B chunks
constexpr int WST = BQ + 8;   // row stride of the weight tile
constexpr int SQ = 32;        // rows per step of the state product
constexpr int SN = 64;        // state columns per pass
constexpr int BST = SN + 4;   // row stride of the B tile (states)
constexpr int QMAX = 256;

template <int P>
struct Lay {
  static constexpr int VW = P >= 32 ? 4 : P / 8;  // columns per x load
  static constexpr int NC = P / (8 * VW);         // x loads per row
  static constexpr int XST = P + 4;               // row stride of x tiles
  static constexpr int PI = P / 8;                // state rows per thread
  static_assert(P % 8 == 0 && P <= 64, "P must be 8, 16, 32 or 64");
};

__host__ __device__ inline int score_stride(int Q) {
  return ((Q + BQ - 1) / BQ) * BQ + 8;
}

template <int P>
size_t smem_floats(int Q) {
  using L = Lay<P>;
  int work = 2 * BQ * CST;
  work = work > BQ * WST + BQ * L::XST ? work : BQ * WST + BQ * L::XST;
  work = work > SQ * L::XST + SQ * BST ? work : SQ * L::XST + SQ * BST;
  return (size_t)HG * Q + (size_t)BQ * score_stride(Q) + work;
}

template <int W>
__device__ __forceinline__ void load_vec(const float* p, float* o) {
  if constexpr (W == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    o[0] = a.x;
    o[1] = a.y;
    o[2] = a.z;
    o[3] = a.w;
  } else if constexpr (W == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    o[0] = a.x;
    o[1] = a.y;
  } else {
    o[0] = p[0];
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

template <int P>
__global__ void __launch_bounds__(NT)
    ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const float* __restrict__ Bm,
                     const float* __restrict__ Cm, float* __restrict__ y,
                     float* __restrict__ st, float* __restrict__ decay,
                     int Q, int H, int N) {
  using L = Lay<P>;
  constexpr int VW = L::VW, NC = L::NC, XST = L::XST, PI = L::PI;
  extern __shared__ __align__(16) float smem[];
  const int SST = score_stride(Q);
  float* acum = smem;               // [HG][Q]
  float* S = acum + HG * Q;         // [BQ][SST] scores of the row block
  float* work = S + BQ * SST;       // phase buffers (aliased)

  const int bc = blockIdx.z;        // b * c + chunk
  const int h0 = blockIdx.y * HG;
  const int ng = min(HG, H - h0);
  const int tid = threadIdx.x;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  // ---- acum = inclusive cumsum of dt * A over the chunk, per head ------
  for (int idx = tid; idx < ng * Q; idx += NT) {
    const int g = idx / Q, q = idx - g * Q;
    acum[g * Q + q] = dt[((size_t)bc * Q + q) * H + h0 + g] * A[h0 + g];
  }
  __syncthreads();
  // in order, one thread per head: the rounding of the plain version's
  // cumsum, whose sums of hundreds of terms set the decays' exponents
  if (tid < ng) {
    float* a = acum + tid * Q;
    float run = 0.f;
    for (int q = 0; q < Q; ++q) {
      run += a[q];
      a[q] = run;
    }
  }
  __syncthreads();

  // ---- chunk states and decays ------------------------------------------
  if (blockIdx.x == 0) {
    float* XW = work;                 // [SQ][XST] x * dt * exp(last - acum)
    float* Bs = work + SQ * XST;      // [SQ][BST]
    const int tp = tid >> 4, tn = tid & 15;
    for (int g = 0; g < ng; ++g) {
      const int h = h0 + g;
      const float* ag = acum + g * Q;
      const float alast = ag[Q - 1];
      if (tid == 0) decay[(size_t)bc * H + h] = expf(alast);
      for (int n0 = 0; n0 < N; n0 += SN) {
        float acc[PI][4];
#pragma unroll
        for (int i = 0; i < PI; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
        for (int q0 = 0; q0 < Q; q0 += SQ) {
          __syncthreads();  // the last step's reads are done
          for (int idx = tid; idx < SQ * (P / 4); idx += NT) {
            const int r = idx / (P / 4), c = (idx % (P / 4)) * 4;
            const int q = q0 + r;
            float4 v = zero4;
            if (q < Q) {
              const size_t row = (size_t)bc * Q + q;
              const float w = dt[row * H + h] * expf(alast - ag[q]);
              v = ld4(x + (row * H + h) * P + c);
              v = make_float4(v.x * w, v.y * w, v.z * w, v.w * w);
            }
            st4(XW + r * XST + c, v);
          }
          for (int idx = tid; idx < SQ * (SN / 4); idx += NT) {
            const int r = idx / (SN / 4), c = (idx % (SN / 4)) * 4;
            const int q = q0 + r, n = n0 + c;
            float4 v = zero4;
            if (q < Q && n < N) v = ld4(Bm + ((size_t)bc * Q + q) * N + n);
            st4(Bs + r * BST + c, v);
          }
          __syncthreads();
          const int kmax = min(SQ, Q - q0);
          for (int k = 0; k < kmax; ++k) {
            float xv[PI], bv[4];
#pragma unroll
            for (int i = 0; i < PI; ++i) xv[i] = XW[k * XST + tp + 8 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) bv[j] = Bs[k * BST + tn + 16 * j];
#pragma unroll
            for (int i = 0; i < PI; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < PI; ++i) {
          const int p = tp + 8 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = n0 + tn + 16 * j;
            if (n < N) st[(((size_t)bc * H + h) * P + p) * N + n] = acc[i][j];
          }
        }
      }
    }
    return;
  }

  // ---- a block of 64 output rows -----------------------------------------
  const int ib = (gridDim.x - 1) - blockIdx.x;  // heaviest blocks first
  const int i0 = ib * BQ;
  const int n_tiles = ib + 1;                   // causal: up to the diagonal
  const int tx = tid & 7, ty = tid >> 3;

  // scores S[r][j] = C_{i0 + r} . B_j, shared by the CTA's heads
  {
    float* Cs = work;                 // [BQ][CST]
    float* Bs = work + BQ * CST;      // [BQ][CST]
    for (int jt = 0; jt < n_tiles; ++jt) {
      float s[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
      for (int n0 = 0; n0 < N; n0 += NCH) {
        const int w4 = min(NCH, N - n0) / 4;
        __syncthreads();  // the last chunk's reads are done
        for (int idx = tid; idx < BQ * w4; idx += NT) {
          const int r = idx / w4, c = (idx % w4) * 4;
          const int qi = i0 + r, qj = jt * BQ + r;
          float4 cv = zero4, bv = zero4;
          if (qi < Q) cv = ld4(Cm + ((size_t)bc * Q + qi) * N + n0 + c);
          if (qj < Q) bv = ld4(Bm + ((size_t)bc * Q + qj) * N + n0 + c);
          st4(Cs + r * CST + c, cv);
          st4(Bs + r * CST + c, bv);
        }
        __syncthreads();
        for (int k = 0; k < 4 * w4; k += 4) {
          float4 cf[4], bf[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) cf[i] = ld4(Cs + (ty + 16 * i) * CST + k);
#pragma unroll
          for (int j = 0; j < 8; ++j) bf[j] = ld4(Bs + (tx + 8 * j) * CST + k);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              float a = s[i][j];
              a = fmaf(cf[i].x, bf[j].x, a);
              a = fmaf(cf[i].y, bf[j].y, a);
              a = fmaf(cf[i].z, bf[j].z, a);
              a = fmaf(cf[i].w, bf[j].w, a);
              s[i][j] = a;
            }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          S[(ty + 16 * i) * SST + jt * BQ + tx + 8 * j] = s[i][j];
    }
  }

  // per head: y_i = sum_j W_ij (dt_j x_j) over the source tiles
  float* Ws = work;                   // [BQ][WST]
  float* Xs = work + BQ * WST;        // [BQ][XST]
  for (int g = 0; g < ng; ++g) {
    const int h = h0 + g;
    const float* ag = acum + g * Q;
    float acc[4][NC][VW];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jc = 0; jc < NC; ++jc)
#pragma unroll
        for (int e = 0; e < VW; ++e) acc[i][jc][e] = 0.f;

    for (int jt = 0; jt < n_tiles; ++jt) {
      __syncthreads();  // S written; the last tile's Ws/Xs reads are done
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i, qi = i0 + r;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = tx + 8 * j, qj = jt * BQ + c;
          float wv = 0.f;
          if (qj <= qi && qi < Q)
            wv = S[r * SST + jt * BQ + c] * expf(ag[qi] - ag[qj]);
          Ws[r * WST + c] = wv;
        }
      }
      for (int idx = tid; idx < BQ * (P / 4); idx += NT) {
        const int r = idx / (P / 4), c = (idx % (P / 4)) * 4;
        const int q = jt * BQ + r;
        float4 v = zero4;
        if (q < Q) {
          const size_t row = (size_t)bc * Q + q;
          const float d = dt[row * H + h];
          v = ld4(x + (row * H + h) * P + c);
          v = make_float4(v.x * d, v.y * d, v.z * d, v.w * d);
        }
        st4(Xs + r * XST + c, v);
      }
      __syncthreads();

#pragma unroll 2
      for (int c = 0; c < BQ; c += 4) {
        float4 wf[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) wf[i] = ld4(Ws + (ty + 16 * i) * WST + c);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
          for (int jc = 0; jc < NC; ++jc) {
            float xv[VW];
            load_vec<VW>(Xs + (c + cc) * XST + jc * 8 * VW + tx * VW, xv);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float w = cc == 0   ? wf[i].x
                              : cc == 1 ? wf[i].y
                              : cc == 2 ? wf[i].z
                                        : wf[i].w;
#pragma unroll
              for (int e = 0; e < VW; ++e)
                acc[i][jc][e] = fmaf(w, xv[e], acc[i][jc][e]);
            }
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i0 + ty + 16 * i;
      if (r >= Q) continue;
      float* orow = y + (((size_t)bc * Q + r) * H + h) * P;
#pragma unroll
      for (int jc = 0; jc < NC; ++jc)
#pragma unroll
        for (int e = 0; e < VW; ++e)
          orow[jc * 8 * VW + tx * VW + e] = acc[i][jc][e];
    }
  }
}

template <int P>
int launch(const float* x, const float* dt, const float* A, const float* Bm,
           const float* Cm, float* y, float* st, float* decay, int BC, int Q,
           int H, int N, cudaStream_t stream) {
  const size_t smem = smem_floats<P>(Q) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(1 + (Q + BQ - 1) / BQ, (H + HG - 1) / HG, BC);
  ssd_chunk_kernel<P><<<grid, NT, smem, stream>>>(x, dt, A, Bm, Cm, y, st,
                                                  decay, Q, H, N);
  return (int)cudaGetLastError();
}

bool supported(int Q, int P, int N) {
  return Q >= 1 && Q <= QMAX && N >= 4 && N % 4 == 0 &&
         (P == 8 || P == 16 || P == 32 || P == 64);
}

}  // namespace

extern "C" {

// x (BC,Q,H,P), dt (BC,Q,H), A (H,), Bm/Cm (BC,Q,N), all float32,
// contiguous, 16-byte aligned, BC = batch * chunks; writes y (BC,Q,H,P),
// st (BC,H,P,N) and decay (BC,H), float32.  Returns a cudaError_t.
int repro_ssd_chunk(const void* x, const void* dt, const void* A,
                    const void* Bm, const void* Cm, void* y, void* st,
                    void* decay, int BC, int Q, int H, int P, int N,
                    void* stream) {
  if (!supported(Q, P, N) || BC < 1 || BC > 65535 || H < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Bf = static_cast<const float*>(Bm);
  const float* Cf = static_cast<const float*>(Cm);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(st);
  float* df = static_cast<float*>(decay);
  switch (P) {
    case 8:
      return launch<8>(xf, dtf, Af, Bf, Cf, yf, sf, df, BC, Q, H, N, s);
    case 16:
      return launch<16>(xf, dtf, Af, Bf, Cf, yf, sf, df, BC, Q, H, N, s);
    case 32:
      return launch<32>(xf, dtf, Af, Bf, Cf, yf, sf, df, BC, Q, H, N, s);
    default:
      return launch<64>(xf, dtf, Af, Bf, Cf, yf, sf, df, BC, Q, H, N, s);
  }
}

}  // extern "C"

// The backward of the Mamba-2 SSD intra-chunk step for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package differentiates its SSD with
// jax.value_and_grad (src/repro/train/step.py:54) through the plain
// chunked form (src/repro/models/ssm.py:104), and its Pallas forward
// (src/repro/kernels/ssd/kernel.py::ssd_chunk_kernel) has no backward.
// It exists because the port's forward is a hand-written kernel
// (csrc/ssd.cu) that autograd cannot see into: ops.SSDChunkFn calls this
// kernel for the gradient, so that training an ssm model runs its
// intra-chunk step on the card both ways.  For every (batch b, chunk c,
// head h), float32 inputs x (B,c,Q,H,P), dt (B,c,Q,H), A (H,), B and C
// (B,c,Q,N) and the cotangents dy (B,c,Q,H,P), dstate (B,c,H,P,N) and
// ddecay (B,c,H), with acum the inclusive cumsum of dt * A, CB = C.B^T,
// the causal L_ij = exp(acum_i - acum_j), M = CB o L o dt_j,
// dte = exp(acum_last - acum) and w = dt o dte:
//   dM = dy.x^T (causal), G = dM o L,
//   dx = M^T.dy + w o (B.dstate^T),
//   dCB = sum_h G_h o dt_h (B and C are shared by the heads),
//   dC = dCB.B,  dB = dCB^T.C + sum_h w_h o (x_h.dstate_h),
//   dw_j = x_j.dstate.B_j,  R = G o CB o dt_j,
//   dacum = rowsum(R) - colsum(R) - dw o w (+ sum_j dw_j w_j
//           + ddecay exp(acum_last) on the last row),
//   da = the reverse cumsum of dacum,
//   ddt = colsum(G o CB) + dw o dte + A da,  dA = sum_{b,c,rows} da o dt.
//
// What bounds it on the card: at the training path's chunk step (B 2,
// c 16, Q 256, H 80, P 64, N 128) it must read x and dy and write dx,
// 168 MB each, and read dstate, 84 MB: ~0.6 GB in all, 0.18 ms at
// 3.35 TB/s.  Its least arithmetic is the causal half of dy.x^T and
// M^T.dy and the whole of B.dstate^T and x.dstate per head, and the
// causal half of C.B^T, dCB.B and dCB^T.C per chunk: 43.8 GFLOP, 0.65 ms
// at the 67 TFLOP/s float32 rate, 0.27 ms as 3xTF32 tensor-core products
// at 495 TFLOP/s.  It is bound by operations, 98% of them four per-head
// products: U = B_j.dstate^T, V = x_j.dstate, dM = dy_i.x_j^T and
// dx_j += M^T.dy_i.
//
// Products.  Those four run on the tensor cores as warp-level
// mma.sync.m16n8k8 3xTF32 with float32 accumulators (the helpers of
// tf32.cuh, shared with the forward; TF32 wgmma would need dy and x
// K-major for two of them).  Each warp owns a 32 x 32 warp tile (2 x 4
// mma tiles; 32 x P for U and dx at P <= 32), so each fragment element it
// reads and splits feeds 2 to 4 products.  Fragments are read with 32-bit
// shared loads.  Tiles read along their rows only (x_j, the B_j chunk,
// the CB tile, M^T) have a row stride of 4 mod 32 floats (P + 4, 68), the
// dstate tile of ssd_bwd_v, read down its rows, 8 mod 32 (72).  dy_i is
// read both ways (along p for dM, down i for M^T.dy), so no stride serves
// it; it is stored swizzled instead, as is the dstate chunk of
// ssd_bwd_main: element (r, c) at r ld + (c ^ s(r mod 8)), ld a multiple
// of 32 and s(r) = 8 (r mod 4) + 4 [r mod 8 >= 4], which puts both a
// row-read fragment (g ld + t) and a column-read one (t ld + g) on 32
// distinct banks and keeps every 16-byte group whole for cp.async.  K
// that is not a multiple of 8 (N 4 or 12, a ragged Q) is padded with
// zeros in shared memory.
//
// Design.  Seven launches; nothing uses float atomics, and every sum
// across CTAs, heads or warps is taken in a fixed order, so two calls
// give equal bits.
//  1. ssd_bwd_cb: CB = C.B^T per chunk, its causal 64 x 64 tiles, float32
//     FMA (0.7% of a call before this design), into scratch (B*c, Q, Q4)
//     whose rows are padded to Q4 = Q rounded up to 4 with zeros.
//  2. ssd_bwd_main: a CTA of 4 warps per (group of HG = 8 heads, b*c,
//     block of 64 source rows j), the heaviest blocks (j 0) launched
//     first, two CTAs an SM (111.25 KB of shared memory at P 64, Q 256).
//     It sums acum for its heads in row order (as the forward does), then
//     per head runs a sequence of steps, each fed by 16-byte cp.async
//     copies (zero-filled past Q, P and N) into a ring of two stage
//     buffers: a step starts the next step's copies, waits for its own,
//     computes, and ends at a barrier.  State steps (one per 64 state
//     columns: the B_j chunk, the dstate chunk and, on a head's first,
//     x_j into one of two x tiles) accumulate U over N; then dw =
//     rowsum(x o U) and dx = w o U in the accumulators.  Pair steps (one
//     per block of target rows i >= j: dy_i and the CB tile) compute dM,
//     then G, M and G o CB from its fragments in registers, exp taken
//     only where j <= i < Q (exp of 0 elsewhere, so steep decays never
//     overflow); colsum(G o CB) and rowsum(G o CB o dt_j) reduce by warp
//     shuffles, then in one cross-warp pass through shared memory in a
//     fixed order; M goes once through shared memory, written transposed
//     over the spent CB tile, as the A operand of dx_j += M^T.dy_i, whose
//     k-steps above the diagonal are skipped.  Each head's G o dt_j tile
//     is written once to scratch (B*c, causal tiles, H, 64, 64) by plain
//     stores, which nothing waits for; a read-modify-write of a sum over
//     the group's heads waited on the memory for every head, and the
//     registers cannot hold the sum across the target blocks.  The
//     price is scratch: 2.5 times x's bytes at Q 256 (0.42 GB at the
//     training shape).
//  3. ssd_bwd_v: dB's state term sum_h w_h o (x_h.dstate_h), one 3xTF32
//     product per chunk over K = H P with w folded into x's rows (w
//     written by step 2); kept out of step 2, whose registers could not
//     hold the sum over a group's heads without spilling.
//  4. ssd_bwd_dcb: dCB = the heads' tiles summed in order.
//  5. ssd_bwd_dbc: dC = dCB.B and dB = dCB^T.C + the state term, float32
//     FMA (1.6% of a call before this design).
//  6. ssd_bwd_finish: a warp per (b*c, h) sums the row partials, forms
//     dacum and its reverse cumsum da 32 rows at a time (a shuffle scan in
//     a fixed order), ddt and the chunk's share of dA (a thread per (b*c,
//     h) took 0.32 ms, 6.6% of a call before this design).
//  7. ssd_bwd_da: dA summed over b*c in order.
// Any Q in 1..256, P in {8, 16, 32, 64}, N a multiple of 4.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; scripts/ssd_bwd_turns.py,
// device ms a call from a profiler trace): at (2, 16, 256, 80, 64, 128)
// the design before this one, all on float32 FMA, took 4.86 ms
// (ssd_bwd_main 4.350, _finish 0.321, _dbc 0.074, _dcb 0.039, _cb 0.032,
// _da 0.002); this one 1.60 ms (ssd_bwd_main 1.069, _v 0.253, _dcb
// 0.142, _dbc 0.046, _finish 0.041, _cb 0.029, _da 0.002), 27.4 TFLOP/s
// of the function.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32.cuh"

namespace {

constexpr int NT = 256;          // threads per CTA of the CUDA-core kernels
constexpr int BT = 64;           // tile rows and columns
constexpr int TS = BT + 1;       // row stride of a CUDA-core tile
constexpr int TILE = BT * TS;    // floats of a CUDA-core tile
constexpr int HG = 8;            // heads per CTA of ssd_bwd_main
constexpr int QMAX = 256;
constexpr int MNT = 128;         // threads per CTA of ssd_bwd_main: 4 warps
constexpr int FST = BT + 4;      // row stride of a 64-wide row-read tile
constexpr int VST = BT + 8;      // row stride of a tile read down its rows
constexpr int VS = 3;            // stages of ssd_bwd_v's ring

constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline size_t round4(size_t n) {
  return (n + 3) / 4 * 4;
}

// ---- CUDA-core helpers of ssd_bwd_cb and ssd_bwd_dbc --------------------
// acc[a][b] += sum_{k < K} A(tr + 16 a, k) * B(k, tc + 16 b)
template <typename FA, typename FB>
__device__ __forceinline__ void tile_fma(float (&acc)[4][4], int K, int tr,
                                         int tc, FA fa, FB fb) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = fa(tr + 16 * i, k);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = fb(k, tc + 16 * j);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero4(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// t[r][c] = src[(row0 + r) * ld + col0 + c] where row0 + r < rows and
// col0 + c < cols, else 0
__device__ __forceinline__ void load_tile(float* t, const float* src,
                                          size_t ld, int row0, int rows,
                                          int col0, int cols) {
  for (int idx = threadIdx.x; idx < BT * BT; idx += NT) {
    const int r = idx >> 6, c = idx & 63;
    const int gr = row0 + r, gc = col0 + c;
    t[r * TS + c] = (gr < rows && gc < cols) ? src[gr * ld + gc] : 0.f;
  }
}

// ---- 1. CB = C.B^T, the causal 64 x 64 tiles of each chunk -------------
// rows of Q4 floats, the columns past Q zero (B's rows past Q are)
__global__ void __launch_bounds__(NT)
    ssd_bwd_cb(const float* __restrict__ Bm, const float* __restrict__ Cm,
               float* __restrict__ CB, int Q, int N) {
  extern __shared__ float smem[];
  float* Cs = smem;
  float* Bs = smem + TILE;
  const int nb = cdiv(Q, BT), Q4 = (int)round4(Q);
  const int ib = blockIdx.x / nb, jb = blockIdx.x % nb;
  if (jb > ib) return;
  const size_t bc = blockIdx.y;
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const float* C0 = Cm + bc * Q * N;
  const float* B0 = Bm + bc * Q * N;
  float acc[4][4];
  zero4(acc);
  for (int n0 = 0; n0 < N; n0 += BT) {
    load_tile(Cs, C0, N, ib * BT, Q, n0, N);
    load_tile(Bs, B0, N, jb * BT, Q, n0, N);
    __syncthreads();
    tile_fma(acc, BT, tr, tc, [&](int r, int k) { return Cs[r * TS + k]; },
             [&](int k, int c) { return Bs[c * TS + k]; });
    __syncthreads();
  }
  float* out = CB + bc * Q * Q4;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = ib * BT + tr + 16 * a, j = jb * BT + tc + 16 * b;
      if (i < Q && j < Q4) out[(size_t)i * Q4 + j] = acc[a][b];
    }
}

// ---- 2. the per-head products on the tensor cores ----------------------
struct MainArgs {
  const float *x, *dt, *A, *Bm, *dy, *dst, *CB;
  float *dx, *ddt, *dcb_head, *w_row, *r_part, *q_row, *dww_row, *alast;
  int Q, H, N;
};

// s(r): the XOR applied to the column of row r of a swizzled tile
__device__ __forceinline__ int swz(int r) { return ((r & 3) << 3) | (r & 4); }

template <int P>
struct MainLay {
  static_assert(P % 8 == 0 && P <= 64, "P must be 8, 16, 32 or 64");
  static constexpr int XST = P + 4;            // x tile row stride
  static constexpr int DYST = P < 32 ? 32 : P; // dy tile row stride, swizzled
  static constexpr int WP = P < 32 ? P : 32;   // warp tile width of U, dx
  static constexpr int NP = WP / 8;            // its n-tiles
  // a stage: [B_j chunk (64 x FST) | dstate chunk (P x 64, swizzled)] or
  // [dy_i (64 x DYST, swizzled) | CB tile, then M^T (64 x FST)]
  static constexpr int STG = BT * FST + cmax(BT * DYST, P * BT);
  static constexpr int XT = BT * XST;          // an x tile
};

template <int P>
size_t main_smem_floats(int Q) {
  using L = MainLay<P>;
  return 2 * (size_t)L::STG + 2 * (size_t)L::XT + round4(HG * Q) + HG * BT +
         5 * BT;
}

template <int P>
__global__ void __launch_bounds__(MNT, 2) ssd_bwd_main(MainArgs p) {
  using L = MainLay<P>;
  constexpr int XST = L::XST, DYST = L::DYST, NP = L::NP, STG = L::STG;
  constexpr int XT = L::XT;
  extern __shared__ __align__(16) float smem[];
  const int Q = p.Q, H = p.H, N = p.N;
  const int Q4 = (int)round4(Q), nb = cdiv(Q, BT), nn = cdiv(N, BT);
  const int jb = blockIdx.z;          // block 0, the heaviest, first
  const int grp = blockIdx.x;
  const size_t bc = blockIdx.y;
  const int h0 = grp * HG, ng = min(HG, H - h0);
  const int j0 = jb * BT;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid >> 2) & 7, t = tid & 3;
  // warp tiles: rows 32 wr .. + 31, columns 32 wc .. + 31 of a 64-wide
  // output; U and dx have P columns, so at P <= 32 the warps of wc 1 sit
  // them out
  const int wr = warp & 1, wc = warp >> 1;
  const bool pw = wc * 32 < P;

  float* stg = smem;                  // two stage buffers
  float* xs = smem + 2 * STG;         // two x tiles, a head's each
  float* acum = xs + 2 * XT;          // [HG][Q]
  float* dtj = acum + round4(HG * Q); // [HG][BT] dt of the source rows
  float* wsh = dtj + HG * BT;         // [BT] w of the source rows, one head
  float* red_row = wsh + BT;          // [2][BT] the warps' row sums
  float* red_col = red_row + 2 * BT;  // [2][BT] the warps' column sums

  const size_t row0 = bc * Q;         // the chunk's first row
  const int n_head = nn + nb - jb;    // steps per head
  const int n_steps = ng * n_head;
  const float* CBc = p.CB + bc * Q * Q4;
  const int n_tile = nb * (nb + 1) / 2;   // causal 64 x 64 tiles a chunk

  // the copies of step s into its stage buffer
  auto issue = [&](int s) {
    float* b = stg + (s & 1) * STG;
    const int hg = s / n_head, r = s - hg * n_head, h = h0 + hg;
    if (r < nn) {
      // state step r: B_j and dstate columns 64 r .. + 63, and x_j on the
      // head's first
      const int n0 = r * BT;
      if (r == 0) {
        float* xt = xs + (hg & 1) * XT;
        for (int idx = tid; idx < BT * (P / 4); idx += MNT) {
          const int rr = idx / (P / 4), cc = (idx % (P / 4)) * 4;
          const int j = j0 + rr;
          cp16(xt + rr * XST + cc,
               p.x + ((row0 + min(j, Q - 1)) * H + h) * P + cc, j < Q);
        }
      }
      for (int idx = tid; idx < BT * (BT / 4); idx += MNT) {
        const int rr = idx >> 4, cc = (idx & 15) * 4;
        const int j = j0 + rr, n = n0 + cc;
        cp16(b + rr * FST + cc, p.Bm + (row0 + min(j, Q - 1)) * N +
             min(n, N - 4), j < Q && n < N);
      }
      float* ds = b + BT * FST;
      const float* dsth = p.dst + (bc * H + h) * (size_t)P * N;
      for (int idx = tid; idx < P * (BT / 4); idx += MNT) {
        const int rr = idx >> 4, cc = (idx & 15) * 4, n = n0 + cc;
        cp16(ds + rr * BT + (cc ^ swz(rr)),
             dsth + (size_t)rr * N + min(n, N - 4), n < N);
      }
    } else {
      // pair step: dy_i and the CB tile (rows i, columns j)
      const int i0 = (jb + r - nn) * BT;
      for (int idx = tid; idx < BT * (P / 4); idx += MNT) {
        const int rr = idx / (P / 4), cc = (idx % (P / 4)) * 4;
        const int i = i0 + rr;
        cp16(b + rr * DYST + (cc ^ swz(rr)),
             p.dy + ((row0 + min(i, Q - 1)) * H + h) * P + cc, i < Q);
      }
      float* ct = b + BT * DYST;
      for (int idx = tid; idx < BT * (BT / 4); idx += MNT) {
        const int rr = idx >> 4, cc = (idx & 15) * 4;
        const int i = i0 + rr, j = j0 + cc;
        cp16(ct + rr * FST + cc,
             CBc + (size_t)min(i, Q - 1) * Q4 + min(j, Q4 - 4),
             i < Q && j < Q4);
      }
    }
    cp_commit();
  };
  // start the next step's copies into the other buffer, wait for this
  // step's, and publish them
  auto advance = [&](int s) {
    if (s + 1 < n_steps) {
      issue(s + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    return stg + (s & 1) * STG;
  };
  issue(0);   // the first stage's copies fly while acum is summed

  // acum = the inclusive cumsum of dt * A in row order, per head
  for (int idx = tid; idx < ng * Q; idx += MNT) {
    const int q = idx / ng, hg = idx - q * ng;
    acum[hg * Q + q] = p.dt[(row0 + q) * H + h0 + hg] * p.A[h0 + hg];
  }
  for (int idx = tid; idx < ng * BT; idx += MNT) {
    const int r = idx / ng, hg = idx - r * ng;
    const int j = j0 + r;
    dtj[hg * BT + r] = j < Q ? p.dt[(row0 + j) * H + h0 + hg] : 0.f;
  }
  __syncthreads();
  if (tid < ng) {
    float* a = acum + tid * Q;
    float run = 0.f;
    for (int q = 0; q < Q; ++q) {
      run += a[q];
      a[q] = run;
    }
    if (jb == 0) p.alast[bc * H + h0 + tid] = run;
  }
  __syncthreads();

  float uacc[2][NP][4];               // U, then dx
  float macc[2][4][4];                // dM, then M
  float s_col = 0.f, dw = 0.f;        // thread j < 64: row j0 + j's
  int s = 0;
  for (int hg = 0; hg < ng; ++hg) {
    const int h = h0 + hg;
    const float* ag = acum + hg * Q;
    const float* dth = dtj + hg * BT;
    const float alast = ag[Q - 1];
    const float* xt = xs + (hg & 1) * XT;
    if (tid < BT) {
      const int j = j0 + tid;
      wsh[tid] = j < Q ? dth[tid] * expf(alast - ag[j]) : 0.f;
    }
    s_col = 0.f;
    zero(uacc);

    // ---- state steps: U = B_j.dstate^T, accumulated over N ------------
    for (int nc = 0; nc < nn; ++nc, ++s) {
      const float* b = advance(s);
      const float* Bs = b;
      const float* Ds = b + BT * FST;
      const int n0 = nc * BT;
      if (pw) {
        // A (j, k = n): B_j rows; B (k = n, p): dstate row p, along n
        kloop(uacc, 0, cdiv(min(BT, N - n0), 8),
              [&](int ks, Frags<2, NP>& f) {
#pragma unroll
                for (int m = 0; m < 2; ++m) {
                  const float* a = Bs + (wr * 32 + m * 16 + g) * FST +
                                   ks * 8 + t;
                  split(a[0], f.ab[m][0], f.as[m][0]);
                  split(a[8 * FST], f.ab[m][1], f.as[m][1]);
                  split(a[4], f.ab[m][2], f.as[m][2]);
                  split(a[8 * FST + 4], f.ab[m][3], f.as[m][3]);
                }
                const int sw = swz(g);
#pragma unroll
                for (int n = 0; n < NP; ++n) {
                  const float* d = Ds + (wc * 32 + n * 8 + g) * BT;
                  split(d[(ks * 8 + t) ^ sw], f.bb[n][0], f.bs[n][0]);
                  split(d[(ks * 8 + t + 4) ^ sw], f.bb[n][1], f.bs[n][1]);
                }
              });
      }
      __syncthreads();                // every warp is done with the buffer
    }

    // ---- dw = rowsum(x_j o U) from U's fragments; dx starts as w o U ----
    {
      float rs[2][2] = {};
      if (pw) {
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int n = 0; n < NP; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = wr * 32 + m * 16 + g + 8 * (e >> 1);
              const int c = wc * 32 + n * 8 + 2 * t + (e & 1);
              rs[m][e >> 1] += xt[r * XST + c] * uacc[m][n][e];
            }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          float v = rs[m][hi];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          if (t == 0) red_row[wc * BT + wr * 32 + m * 16 + hi * 8 + g] = v;
        }
      __syncthreads();
      if (tid < BT) dw = red_row[tid] + red_row[BT + tid];
      if (pw) {
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int n = 0; n < NP; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              uacc[m][n][e] *= wsh[wr * 32 + m * 16 + g + 8 * (e >> 1)];
      }
    }

    // ---- pair steps: a block of target rows i >= j each -----------------
    for (int ib = jb; ib < nb; ++ib, ++s) {
      float* b = stg + (s & 1) * STG;
      advance(s);
      const float* Dy = b;            // dy_i, swizzled
      float* Ct = b + BT * DYST;      // the CB tile, then M^T
      const int i0 = ib * BT;
      const bool diag = ib == jb;
      zero(macc);
      // dM = dy_i.x_j^T; warp tiles wholly above the diagonal stay 0
      if (!(diag && wc > wr)) {
        // A (i, k = p): dy_i along p; B (k = p, j): x_j rows
        kloop(macc, 0, P / 8, [&](int ks, Frags<2, 4>& f) {
          const int sw = swz(g);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const float* a = Dy + (wr * 32 + m * 16 + g) * DYST;
            const int c0 = (ks * 8 + t) ^ sw, c1 = (ks * 8 + t + 4) ^ sw;
            split(a[c0], f.ab[m][0], f.as[m][0]);
            split(a[8 * DYST + c0], f.ab[m][1], f.as[m][1]);
            split(a[c1], f.ab[m][2], f.as[m][2]);
            split(a[8 * DYST + c1], f.ab[m][3], f.as[m][3]);
          }
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const float* xb = xt + (wc * 32 + n * 8 + g) * XST + ks * 8 + t;
            split(xb[0], f.bb[n][0], f.bs[n][0]);
            split(xb[4], f.bb[n][1], f.bs[n][1]);
          }
        });
      }
      // G = dM o L, M = CB o L o dt_j, G o CB, from the fragments; L is
      // exp(acum_i - acum_j) where j <= i < Q and exactly 0 elsewhere
      float ai[2][2];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int i = i0 + wr * 32 + m * 16 + hi * 8 + g;
          ai[m][hi] = ag[min(i, Q - 1)];
        }
      float aj[4][2], dj[4][2];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int bb = 0; bb < 2; ++bb) {
          const int jl = wc * 32 + n * 8 + 2 * t + bb;
          aj[n][bb] = ag[min(j0 + jl, Q - 1)];
          dj[n][bb] = dth[jl];
        }
      // this head's G o dt_j tile, written once (ssd_bwd_dcb sums the heads)
      float* dcb = p.dcb_head +
          (((bc * n_tile + ib * (ib + 1) / 2 + jb) * H) + h) * (BT * BT);
      float csum[4][2] = {}, rsum[2][2] = {};
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int il = wr * 32 + m * 16 + hi * 8 + g, i = i0 + il;
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            float gd[2];
#pragma unroll
            for (int bb = 0; bb < 2; ++bb) {
              const int jl = wc * 32 + n * 8 + 2 * t + bb, j = j0 + jl;
              const bool on = i < Q && j <= i;  // j <= i < Q: j < Q too
              const float L = on ? __expf(ai[m][hi] - aj[n][bb]) : 0.f;
              float& v = macc[m][n][2 * hi + bb];
              const float gij = v * L;
              const float cb = Ct[il * FST + jl];
              const float gcb = gij * cb;
              csum[n][bb] += gcb;
              rsum[m][hi] += gcb * dj[n][bb];
              gd[bb] = gij * dj[n][bb];
              v = cb * L * dj[n][bb];   // M
            }
            __stcg(reinterpret_cast<float2*>(dcb + il * BT + wc * 32 +
                                             n * 8 + 2 * t),
                   make_float2(gd[0], gd[1]));
          }
        }
      // the column sums over the warp's rows (lanes of one t), the row
      // sums over its columns (lanes of one g)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int bb = 0; bb < 2; ++bb) {
          float v = csum[n][bb];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          csum[n][bb] = v;
        }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          float v = rsum[m][hi];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          rsum[m][hi] = v;
        }
      __syncthreads();                // every warp is done with the CB tile
      // M^T over the CB tile; the warps' sums, then one pass in order
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int il = wr * 32 + m * 16 + g + 8 * (e >> 1);
            const int jl = wc * 32 + n * 8 + 2 * t + (e & 1);
            Ct[jl * FST + il] = macc[m][n][e];
          }
      if (g == 0) {
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int bb = 0; bb < 2; ++bb)
            red_col[wr * BT + wc * 32 + n * 8 + 2 * t + bb] = csum[n][bb];
      }
      if (t == 0) {
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int hi = 0; hi < 2; ++hi)
            red_row[wc * BT + wr * 32 + m * 16 + hi * 8 + g] = rsum[m][hi];
      }
      __syncthreads();
      if (tid < BT) {
        s_col += red_col[tid] + red_col[BT + tid];
      } else {
        const int r = tid - BT, i = i0 + r;
        if (i < Q)
          p.r_part[((bc * nb + jb) * Q + i) * H + h] =
              red_row[r] + red_row[BT + r];
      }
      // dx_j += M^T.dy_i; M^T[j][i] = 0 for i < j, so the k-steps below
      // the warp's first row j are skipped on the diagonal
      if (pw) {
        // A (j, k = i): M^T rows; B (k = i, p): dy_i down i
        kloop(uacc, diag ? wr * 4 : 0, cdiv(min(BT, Q - i0), 8),
              [&](int ks, Frags<2, NP>& f) {
#pragma unroll
                for (int m = 0; m < 2; ++m) {
                  const float* a = Ct + (wr * 32 + m * 16 + g) * FST +
                                   ks * 8 + t;
                  split(a[0], f.ab[m][0], f.as[m][0]);
                  split(a[8 * FST], f.ab[m][1], f.as[m][1]);
                  split(a[4], f.ab[m][2], f.as[m][2]);
                  split(a[8 * FST + 4], f.ab[m][3], f.as[m][3]);
                }
                const int sw = swz(t);
                const float* d0 = Dy + (ks * 8 + t) * DYST;
                const float* d1 = d0 + 4 * DYST;
#pragma unroll
                for (int n = 0; n < NP; ++n) {
                  const int col = wc * 32 + n * 8 + g;
                  split(d0[col ^ sw], f.bb[n][0], f.bs[n][0]);
                  split(d1[col ^ (sw | 4)], f.bb[n][1], f.bs[n][1]);
                }
              });
      }
      __syncthreads();                // every warp is done with the buffer
    }

    // ---- the head's outputs: dx, ddt's first terms, dacum's row terms ---
    if (pw) {
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < NP; ++n) {
          const int ja = j0 + wr * 32 + m * 16 + g, jc = ja + 8;
          const int c = wc * 32 + n * 8 + 2 * t;
          if (ja < Q)
            st2(p.dx + ((row0 + ja) * H + h) * P + c, uacc[m][n][0],
                uacc[m][n][1]);
          if (jc < Q)
            st2(p.dx + ((row0 + jc) * H + h) * P + c, uacc[m][n][2],
                uacc[m][n][3]);
        }
    }
    if (tid < BT) {
      const int j = j0 + tid;
      if (j < Q) {
        const float w = wsh[tid];
        const float dte = expf(alast - ag[j]);
        const size_t o = (row0 + j) * H + h;
        p.ddt[o] = s_col + dw * dte;
        p.q_row[o] = -dth[tid] * s_col - dw * w;
        p.dww_row[o] = dw * w;
        p.w_row[o] = w;
      }
    }
  }
}

// ---- 3. dB's state term sum_h w_h o (x_h.dstate_h) on the tensor cores ---
// One product per (b*c): (w o x) (Q x H P) . dstate (H P x N), K = H P in
// order of the heads.  A CTA of 4 warps per 64 rows x 64 state columns;
// per head a step copies x_h's rows (raw), dstate_h's columns and w's
// column into a ring of VS stages.
template <int P>
struct VLay {
  static constexpr int XST = P + 4;            // x rows, read along p
  static constexpr int STG = BT * XST + P * VST + BT;
};

template <int P>
__global__ void __launch_bounds__(MNT, 2)
    ssd_bwd_v(const float* __restrict__ x, const float* __restrict__ dst,
              const float* __restrict__ w_row, float* __restrict__ dbs,
              int Q, int H, int N) {
  using L = VLay<P>;
  constexpr int XST = L::XST, STG = L::STG;
  extern __shared__ __align__(16) float smem[];
  const int n0 = blockIdx.x * BT, j0 = blockIdx.y * BT;
  const size_t bc = blockIdx.z, row0 = bc * Q;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid >> 2) & 7, t = tid & 3;
  const int wr = warp & 1, wc = warp >> 1;
  auto issue = [&](int h) {
    if (h < H) {
      float* b = smem + (h % VS) * STG;
      for (int idx = tid; idx < BT * (P / 4); idx += MNT) {
        const int rr = idx / (P / 4), cc = (idx % (P / 4)) * 4;
        const int j = j0 + rr;
        cp16(b + rr * XST + cc, x + ((row0 + min(j, Q - 1)) * H + h) * P + cc,
             j < Q);
      }
      float* ds = b + BT * XST;
      const float* dh = dst + (bc * H + h) * (size_t)P * N;
      for (int idx = tid; idx < P * (BT / 4); idx += MNT) {
        const int rr = idx >> 4, cc = (idx & 15) * 4, n = n0 + cc;
        cp16(ds + rr * VST + cc, dh + (size_t)rr * N + min(n, N - 4), n < N);
      }
      if (tid < BT)
        cp4(ds + P * VST + tid, w_row + (row0 + min(j0 + tid, Q - 1)) * H + h,
            j0 + tid < Q);
    }
    cp_commit();                      // (empty past the last head)
  };
  for (int h = 0; h < VS - 1; ++h) issue(h);
  float acc[2][4][4];
  zero(acc);
  for (int h = 0; h < H; ++h) {
    issue(h + VS - 1);
    cp_wait<VS - 1>();
    __syncthreads();
    const float* Xs = smem + (h % VS) * STG;
    const float* Ds = Xs + BT * XST;
    const float* ws = Ds + P * VST;
    float wv[2][2];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi)
        wv[m][hi] = ws[wr * 32 + m * 16 + hi * 8 + g];
    // A (j, k = p): x rows scaled by w_j; B (k = p, n): dstate down p
    kloop(acc, 0, P / 8, [&](int ks, Frags<2, 4>& f) {
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float* a = Xs + (wr * 32 + m * 16 + g) * XST + ks * 8 + t;
        split(a[0] * wv[m][0], f.ab[m][0], f.as[m][0]);
        split(a[8 * XST] * wv[m][1], f.ab[m][1], f.as[m][1]);
        split(a[4] * wv[m][0], f.ab[m][2], f.as[m][2]);
        split(a[8 * XST + 4] * wv[m][1], f.ab[m][3], f.as[m][3]);
      }
      const float* d = Ds + (ks * 8 + t) * VST + wc * 32 + g;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        split(d[n * 8], f.bb[n][0], f.bs[n][0]);
        split(d[4 * VST + n * 8], f.bb[n][1], f.bs[n][1]);
      }
    });
    __syncthreads();                  // every warp is done with the stage
  }
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int c = n0 + wc * 32 + n * 8 + 2 * t;
      const int ja = j0 + wr * 32 + m * 16 + g, jc = ja + 8;
      if (c >= N) continue;
      if (ja < Q)
        st2(dbs + (row0 + ja) * N + c, acc[m][n][0], acc[m][n][1]);
      if (jc < Q)
        st2(dbs + (row0 + jc) * N + c, acc[m][n][2], acc[m][n][3]);
    }
}

// ---- 4. dCB = the heads' tiles summed in order ---------------------------
// a thread per 4 elements of a causal tile; the heads' tiles lie H apart
__global__ void __launch_bounds__(NT)
    ssd_bwd_dcb(const float* __restrict__ part, float* __restrict__ dCB,
                int Q, int H) {
  const int nb = cdiv(Q, BT), n_tile = nb * (nb + 1) / 2;
  const int tile = blockIdx.x / (BT * BT / 4 / NT);
  int ib = 0;
  while ((ib + 1) * (ib + 2) / 2 <= tile) ++ib;
  const int jb = tile - ib * (ib + 1) / 2;
  const int e4 = ((blockIdx.x % (BT * BT / 4 / NT)) * NT + threadIdx.x) * 4;
  const size_t bc = blockIdx.y;
  const float4* src = reinterpret_cast<const float4*>(
      part + (bc * n_tile + tile) * H * (size_t)(BT * BT) + e4);
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int h = 0; h < H; ++h) {
    const float4 v = __ldcs(src + (size_t)h * (BT * BT / 4));
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  const int i = ib * BT + e4 / BT, j = jb * BT + e4 % BT;
  if (i >= Q) return;
  float* o = dCB + (bc * Q + i) * Q + j;
  const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (j + k < Q) o[k] = sv[k];
}

// ---- 5. dC = dCB.B, dB = dCB^T.C + the state term -------------------------
__global__ void __launch_bounds__(NT)
    ssd_bwd_dbc(const float* __restrict__ dCB, const float* __restrict__ Bm,
                const float* __restrict__ Cm,
                const float* __restrict__ dbs, float* __restrict__ dB,
                float* __restrict__ dC, int Q, int N) {
  extern __shared__ float smem[];
  float* Ts = smem;
  float* Ms = smem + TILE;
  const int nb = cdiv(Q, BT), nn = cdiv(N, BT);
  const int kind = blockIdx.x / (nb * nn);        // 0: dC, 1: dB
  const int rb = (blockIdx.x / nn) % nb, n0 = (blockIdx.x % nn) * BT;
  const size_t bc = blockIdx.y;
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const float* T = dCB + bc * Q * Q;
  float acc[4][4];
  zero4(acc);
  if (kind == 0) {            // rows i of block rb: sum over j <= i
    for (int jb = 0; jb <= rb; ++jb) {
      load_tile(Ts, T + jb * BT, Q, rb * BT, Q, 0, Q - jb * BT);
      load_tile(Ms, Bm + bc * Q * N, N, jb * BT, Q, n0, N);
      __syncthreads();
      tile_fma(acc, BT, tr, tc, [&](int r, int k) { return Ts[r * TS + k]; },
               [&](int k, int c) { return Ms[k * TS + c]; });
      __syncthreads();
    }
  } else {                    // rows j of block rb: sum over i >= j
    for (int ib = rb; ib < nb; ++ib) {
      load_tile(Ts, T + rb * BT, Q, ib * BT, Q, 0, Q - rb * BT);
      load_tile(Ms, Cm + bc * Q * N, N, ib * BT, Q, n0, N);
      __syncthreads();
      tile_fma(acc, BT, tr, tc, [&](int r, int k) { return Ts[k * TS + r]; },
               [&](int k, int c) { return Ms[k * TS + c]; });
      __syncthreads();
    }
  }
  float* out = (kind == 0 ? dC : dB) + bc * Q * N;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int r = rb * BT + tr + 16 * a, n = n0 + tc + 16 * b;
      if (r >= Q || n >= N) continue;
      out[(size_t)r * N + n] =
          kind == 1 ? acc[a][b] + dbs[(bc * Q + r) * N + n] : acc[a][b];
    }
}

// ---- 6. dacum, da, ddt and the chunk's share of dA: a warp per (b*c, h) -
// Lane l takes row j = top - l of each 32 rows from the last; da, the
// reverse cumsum of dacum, is a shuffle scan over the lanes plus the rows
// above, in a fixed order.
__global__ void __launch_bounds__(128)
    ssd_bwd_finish(const float* __restrict__ dt, const float* __restrict__ A,
                   const float* __restrict__ ddecay,
                   const float* __restrict__ alast,
                   const float* __restrict__ r_part,
                   const float* __restrict__ q_row,
                   const float* __restrict__ dww_row, float* __restrict__ ddt,
                   float* __restrict__ da_part, int BC, int Q, int H) {
  const int wid = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (wid >= BC * H) return;          // whole warps
  const size_t bc = wid / H;
  const int h = wid % H, nb = cdiv(Q, BT);
  const float a = A[h];
  const size_t row0 = bc * Q;
  float tot = 0.f;                    // sum_j dw_j w_j
  for (int q = lane; q < Q; q += 32) tot += dww_row[(row0 + q) * H + h];
#pragma unroll
  for (int d = 16; d; d >>= 1) tot += __shfl_xor_sync(0xffffffffu, tot, d);
  float carry = 0.f, dA = 0.f;
  for (int top = Q - 1; top >= 0; top -= 32) {
    const int j = top - lane;
    const size_t o = (row0 + max(j, 0)) * H + h;
    float dacum = 0.f;
    if (j >= 0) {
      float r = 0.f;
      for (int jb = 0; jb <= j / BT; ++jb)
        r += r_part[((bc * nb + jb) * Q + j) * H + h];
      dacum = r + q_row[o];
      if (j == Q - 1)
        dacum += tot + ddecay[bc * H + h] * expf(alast[bc * H + h]);
    }
    float v = dacum;                  // inclusive scan from lane 0
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v += u;
    }
    const float da = carry + v;       // da_j
    carry += __shfl_sync(0xffffffffu, v, 31);
    if (j >= 0) {
      ddt[o] += a * da;
      dA += da * dt[o];
    }
  }
#pragma unroll
  for (int d = 16; d; d >>= 1) dA += __shfl_xor_sync(0xffffffffu, dA, d);
  if (lane == 0) da_part[wid] = dA;
}

// ---- 7. dA = the chunks' shares summed in order --------------------------
__global__ void ssd_bwd_da(const float* __restrict__ da_part,
                           float* __restrict__ dA, int BC, int H) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  float s = 0.f;
  for (int bc = 0; bc < BC; ++bc) s += da_part[(size_t)bc * H + h];
  dA[h] = s;
}

constexpr size_t PAIR_SMEM = 2 * (size_t)TILE * sizeof(float);

// the scratch regions, in floats, each a multiple of 4 (16 bytes)
struct Scratch {
  size_t cb, dcb_head, dcb, dbs, w_row, r_part, q_row, dww_row, alast,
      da_part, total;
  Scratch(int BC, int Q, int H, int N) {
    const size_t nb = cdiv(Q, BT);
    size_t off = 0;
    auto take = [&](size_t n) {
      const size_t at = off;
      off += round4(n);
      return at;
    };
    cb = take((size_t)BC * Q * round4(Q));
    dcb_head = take((size_t)BC * (nb * (nb + 1) / 2) * H * BT * BT);
    dcb = take((size_t)BC * Q * Q);
    dbs = take((size_t)BC * Q * N);
    w_row = take((size_t)BC * Q * H);
    r_part = take((size_t)BC * nb * Q * H);
    q_row = take((size_t)BC * Q * H);
    dww_row = take((size_t)BC * Q * H);
    alast = take((size_t)BC * H);
    da_part = take((size_t)BC * H);
    total = off;
  }
};

template <int P>
int launch_main(const MainArgs& a, int BC, int G, cudaStream_t s) {
  const size_t smem = main_smem_floats<P>(a.Q) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_main<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_main<P><<<dim3(G, BC, cdiv(a.Q, BT)), MNT, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <int P>
int launch_v(const MainArgs& a, float* dbs, int BC, cudaStream_t s) {
  const size_t smem = (size_t)VS * VLay<P>::STG * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_v<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_v<P><<<dim3(cdiv(a.N, BT), cdiv(a.Q, BT), BC), MNT, smem, s>>>(
      a.x, a.dst, a.w_row, dbs, a.Q, a.H, a.N);
  return (int)cudaGetLastError();
}

bool supported(int Q, int P, int N) {
  return Q >= 1 && Q <= QMAX && N >= 4 && N % 4 == 0 &&
         (P == 8 || P == 16 || P == 32 || P == 64);
}

}  // namespace

extern "C" {

// floats of scratch that repro_ssd_chunk_bwd needs at these sizes
size_t repro_ssd_chunk_bwd_scratch(int BC, int Q, int H, int N) {
  return Scratch(BC, Q, H, N).total;
}

// x (BC,Q,H,P), dt (BC,Q,H), A (H,), Bm/Cm (BC,Q,N), dy (BC,Q,H,P),
// dstate (BC,H,P,N), ddecay (BC,H), all float32, contiguous, 16-byte
// aligned, BC = batch * chunks; writes dx (BC,Q,H,P), ddt (BC,Q,H), dA
// (H,), dB and dC (BC,Q,N), float32, using ``scratch`` (the floats
// repro_ssd_chunk_bwd_scratch gives, 16-byte aligned).  Returns a
// cudaError_t.
int repro_ssd_chunk_bwd(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, const void* dy,
                        const void* dstate, const void* ddecay, void* dx,
                        void* ddt, void* dA, void* dB, void* dC,
                        void* scratch, int BC, int Q, int H, int P, int N,
                        void* stream) {
  if (!supported(Q, P, N) || BC < 1 || BC > 65535 || H < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Scratch L(BC, Q, H, N);
  float* sc = static_cast<float*>(scratch);
  const int G = cdiv(H, HG), nb = cdiv(Q, BT), nn = cdiv(N, BT);
  const float* Bf = static_cast<const float*>(Bm);
  const float* Cf = static_cast<const float*>(Cm);

  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_cb, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)PAIR_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ssd_bwd_dbc,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)PAIR_SMEM);
  if (err != cudaSuccess) return (int)err;

  ssd_bwd_cb<<<dim3(nb * nb, BC), NT, PAIR_SMEM, s>>>(Bf, Cf, sc + L.cb, Q,
                                                       N);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  MainArgs a;
  a.x = static_cast<const float*>(x);
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.Bm = Bf;
  a.dy = static_cast<const float*>(dy);
  a.dst = static_cast<const float*>(dstate);
  a.CB = sc + L.cb;
  a.dx = static_cast<float*>(dx);
  a.ddt = static_cast<float*>(ddt);
  a.dcb_head = sc + L.dcb_head;
  a.w_row = sc + L.w_row;
  a.r_part = sc + L.r_part;
  a.q_row = sc + L.q_row;
  a.dww_row = sc + L.dww_row;
  a.alast = sc + L.alast;
  a.Q = Q;
  a.H = H;
  a.N = N;
  int rc;
  switch (P) {
    case 8: rc = launch_main<8>(a, BC, G, s); break;
    case 16: rc = launch_main<16>(a, BC, G, s); break;
    case 32: rc = launch_main<32>(a, BC, G, s); break;
    default: rc = launch_main<64>(a, BC, G, s); break;
  }
  if (rc != 0) return rc;
  float* dbs = sc + L.dbs;
  switch (P) {
    case 8: rc = launch_v<8>(a, dbs, BC, s); break;
    case 16: rc = launch_v<16>(a, dbs, BC, s); break;
    case 32: rc = launch_v<32>(a, dbs, BC, s); break;
    default: rc = launch_v<64>(a, dbs, BC, s); break;
  }
  if (rc != 0) return rc;

  ssd_bwd_dcb<<<dim3(nb * (nb + 1) / 2 * (BT * BT / 4 / NT), BC), NT, 0,
                s>>>(sc + L.dcb_head, sc + L.dcb, Q, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  ssd_bwd_dbc<<<dim3(2 * nb * nn, BC), NT, PAIR_SMEM, s>>>(
      sc + L.dcb, Bf, Cf, dbs, static_cast<float*>(dB),
      static_cast<float*>(dC), Q, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  ssd_bwd_finish<<<cdiv(BC * H, 4), 128, 0, s>>>(
      a.dt, a.A, static_cast<const float*>(ddecay), sc + L.alast,
      sc + L.r_part, sc + L.q_row, sc + L.dww_row, a.ddt, sc + L.da_part, BC,
      Q, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  ssd_bwd_da<<<cdiv(H, 128), 128, 0, s>>>(sc + L.da_part,
                                           static_cast<float*>(dA), BC, H);
  return (int)cudaGetLastError();
}

}  // extern "C"

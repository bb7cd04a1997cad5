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
// (x and y 168 MB each, the states 84 MB), 0.129 ms at 3.35 TB/s.  Its
// least arithmetic (C.B^T once per chunk, the causal half of the
// products) is ~21.8 GFLOP; the outputs are held to 1e-4 of float32, so
// a product on the tensor cores needs three TF32 products (3xTF32), 65
// GFLOP, 0.132 ms at the 495 TFLOP/s TF32 peak: the two bounds are level.
// mma.sync reaches about 300 TFLOP/s of TF32 on the card, and what this
// kernel spends per product is mostly elsewhere: reading fragments from
// shared memory, splitting them and building W.
//
// Products.  Every product (the scores C.B^T, y = W.x and the states)
// runs on the tensor cores as warp-level
// mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32 with float32 accumulators
// (the helpers of tf32.cuh, shared with the backward), 3xTF32 as in
// CUTLASS: each operand a splits into big = tf32(a) and
// small = tf32(a - big), both rounded to nearest, ties away from zero
// (the bit form of cvt.rna.tf32.f32 for finite values, two integer
// operations), and each k-step accumulates small_A.big_B, big_A.small_B,
// then big_A.big_B.  The split is made when a fragment is read from
// shared memory.  The lost small.small term and the roundings leave
// ~2^-22 of each product, well inside the 1e-4 gates; a bf16 split with
// three products does not hold them.  Fragments (lane = 4 g + t): A (g,t)
// (g+8,t) (g,t+4) (g+8,t+4); B (k t, n g) (k t+4, n g); C (g,2t)
// (g,2t+1) (g+8,2t) (g+8,2t+1).  Each is read with plain 32-bit shared
// loads: a row-read fragment from a tile whose row stride is 4 mod 32
// floats, a fragment whose k runs down the rows from one whose stride is
// 8 mod 32, both free of bank conflicts.  Shared-memory traffic per
// product is what a k-step costs, so every warp owns a 32-wide warp tile
// (2 x 8 or 4 x 4 mma tiles at P 64): each fragment element it reads
// feeds 4 to 8 products.
//
// Design.  CTAs of 128 threads (4 warps) per (group of HG = 8 heads,
// (b, c)): first ceil(N / 64) state CTAs, each the chunk states of its 8
// heads for 64 state columns (the first also writes the decays), then one
// CTA per block of 64 output rows, heaviest causal block first.  Tiles
// reach shared memory by cp.async (16 bytes a thread, zero-filled past Q
// and N) into two buffers: a step starts the next step's copies, waits
// for its own, computes, and ends at a barrier.
// * Every CTA computes acum for its heads over the whole chunk: a = dt*A
//   in shared memory, then one thread per head sums it in order.  The
//   decay exponents are differences of sums of up to 256 terms of
//   magnitude ~1, so the order of the sum shows in them at ~1e-4
//   relative; summing in row order reproduces the plain version's
//   cumsum, which sums in order too.
// * Row-block CTAs compute the head-independent scores S = C_i . B_j for
//   their 64 rows and every source row up to the diagonal (C and B copied
//   in chunks of 32 state columns; warp tile 32 rows x 32 source rows) and
//   keep them in shared memory: C.B^T is computed once for 8 heads.  Then
//   for each head and each source tile up to the diagonal, x and dt of
//   the tile are copied, and each warp builds its A fragments of
//   W = S * exp(acum_i - acum_j) * dt_j straight from S where j <= i
//   (exactly 0 elsewhere: exp is taken of 0 there, never of an argument
//   above the diagonal, where it could overflow and make inf * 0 = NaN)
//   and accumulates y over its warp tile, 32 rows x P columns, for one
//   half of the tile's k-steps; k-steps wholly above a warp's rows are
//   skipped.  The two halves' sums meet in shared memory once per head.
// * State CTAs accumulate X^T . B, X = x dt exp(acum_last - acum), in
//   64-row steps, the scores' space serving as their buffers; warp tile
//   P rows x 32 state columns, one half of each step's k-steps.
// Rows past Q and state columns past N are zero-filled in shared memory
// (so Q and N need not be multiples of 8) and never written.  Any Q in
// 1..256, P in {8,16,32,64}, N a multiple of 4.  Shared memory at Q 256,
// P 64: 109 KB, two CTAs per SM.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32.cuh"

namespace {

constexpr int NT = 128;       // threads per CTA: 4 warps
constexpr int BQ = 64;        // output rows per CTA, source rows per tile
constexpr int HG = 8;         // heads per CTA
constexpr int NCH = 32;       // state-dim chunk of the score product
constexpr int CST = NCH + 4;  // row stride of the C and B chunks
constexpr int SQ = 64;        // rows per step of the state product
constexpr int SN = 64;        // state columns per state CTA
constexpr int BST = SN + 8;   // row stride of the B tile (states)
constexpr int QMAX = 256;

constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int P>
struct Lay {
  static constexpr int XST = P + 8;                // row stride of x tiles
  static constexpr int NTY = P / 8;                // n-tiles of y
  static constexpr int MT = P >= 16 ? P / 16 : 1;  // m-tiles of a state
  // floats of a row-block CTA's stage buffer (a score step's C and B
  // chunks, or a y step's x tile and dt), and of a state CTA's (x rows, B
  // rows and dt), which takes the place of the scores
  static constexpr int BUF = (cmax(2 * BQ * CST, BQ * (XST + 1)) + 3) / 4 * 4;
  static constexpr int SBUF = (SQ * (XST + BST + 1) + 3) / 4 * 4;
  static_assert(P % 8 == 0 && P <= 64, "P must be 8, 16, 32 or 64");
};

__host__ __device__ inline int score_stride(int Q) {
  return ((Q + BQ - 1) / BQ) * BQ + 4;
}

template <int P>
size_t smem_floats(int Q) {
  using L = Lay<P>;
  return (size_t)HG * Q +
         (size_t)cmax(BQ * score_stride(Q) + 2 * L::BUF, 2 * L::SBUF);
}

// B fragments of NTL n-tiles whose element (k, n) lies at p[k * ld + n],
// p at (k0, n0)
template <int MTL, int NTL>
__device__ __forceinline__ void load_b_kn(const float* p, int ld, int g,
                                          int t, Frags<MTL, NTL>& f) {
#pragma unroll
  for (int i = 0; i < NTL; ++i) {
    split(p[t * ld + i * 8 + g], f.bb[i][0], f.bs[i][0]);
    split(p[(t + 4) * ld + i * 8 + g], f.bb[i][1], f.bs[i][1]);
  }
}

template <int P>
__global__ void __launch_bounds__(NT)
    ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const float* __restrict__ Bm,
                     const float* __restrict__ Cm, float* __restrict__ y,
                     float* __restrict__ st, float* __restrict__ decay,
                     int Q, int H, int N) {
  using L = Lay<P>;
  constexpr int XST = L::XST, NTY = L::NTY, MT = L::MT;
  constexpr int BUF = L::BUF;
  extern __shared__ __align__(16) float smem[];
  const int SST = score_stride(Q);
  float* acum = smem;               // [HG][Q]
  float* S = acum + HG * Q;         // [BQ][SST] scores of the row block
  float* work = S + BQ * SST;       // two stage buffers of BUF floats

  const int bc = blockIdx.z;        // b * c + chunk
  const int h0 = blockIdx.y * HG;
  const int ng = min(HG, H - h0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, g = (tid >> 2) & 7, t = tid & 3;
  const int n_state = (N + SN - 1) / SN;
  const bool is_state = blockIdx.x < n_state;
  const size_t row0 = (size_t)bc * Q;   // the chunk's first row

  // ---- the stages: what each step copies into its buffer ---------------
  auto buf = [&](int s) {
    return is_state ? S + (s & 1) * L::SBUF : work + (s & 1) * BUF;
  };
  // state CTA, step s = (head, 64-row step): x rows [SQ][XST] raw, B rows
  // [SQ][BST] of its 64 state columns, dt [SQ]
  const int nb0 = blockIdx.x * SN;
  const int n_q = (Q + SQ - 1) / SQ;
  auto issue_state = [&](int s) {
    float* b = buf(s);
    const int h = h0 + s / n_q, q0 = (s % n_q) * SQ;
    for (int idx = tid; idx < SQ * (P / 4); idx += NT) {
      const int r = idx / (P / 4), c = (idx % (P / 4)) * 4, q = q0 + r;
      cp16(b + r * XST + c, x + ((row0 + min(q, Q - 1)) * H + h) * P + c,
           q < Q);
    }
    for (int idx = tid; idx < SQ * (SN / 4); idx += NT) {
      const int r = idx / (SN / 4), c = (idx % (SN / 4)) * 4, q = q0 + r;
      const int n = nb0 + c;
      cp16(b + SQ * XST + r * BST + c,
           Bm + (row0 + min(q, Q - 1)) * N + min(n, N - 4), q < Q && n < N);
    }
    if (tid < SQ)
      cp4(b + SQ * (XST + BST) + tid,
          dt + (row0 + min(q0 + tid, Q - 1)) * H + h, q0 + tid < Q);
    cp_commit();
  };
  // row-block CTA: steps [0, n_score) are score steps (source tile jt,
  // 32 state columns: C rows [BQ][CST], B rows [BQ][CST]), then one step
  // per (head, source tile): x rows [BQ][XST] raw, dt [BQ]
  const int ib = (gridDim.x - 1) - blockIdx.x;  // heaviest blocks first
  const int i0 = ib * BQ;
  const int n_tiles = ib + 1;                   // causal: up to the diagonal
  const int n_chunks = (N + NCH - 1) / NCH;
  const int n_score = n_tiles * n_chunks;
  auto issue_rows = [&](int s) {
    float* b = buf(s);
    if (s < n_score) {
      const int jt = s / n_chunks, n0 = (s % n_chunks) * NCH;
      for (int idx = tid; idx < BQ * (NCH / 4); idx += NT) {
        const int r = idx / (NCH / 4), c = (idx % (NCH / 4)) * 4;
        const int qi = i0 + r, qj = jt * BQ + r, n = n0 + c;
        const int nn = min(n, N - 4);
        cp16(b + r * CST + c, Cm + (row0 + min(qi, Q - 1)) * N + nn,
             qi < Q && n < N);
        cp16(b + BQ * CST + r * CST + c,
             Bm + (row0 + min(qj, Q - 1)) * N + nn, qj < Q && n < N);
      }
    } else {
      const int u = s - n_score;
      const int h = h0 + u / n_tiles, q0 = (u % n_tiles) * BQ;
      for (int idx = tid; idx < BQ * (P / 4); idx += NT) {
        const int r = idx / (P / 4), c = (idx % (P / 4)) * 4, q = q0 + r;
        cp16(b + r * XST + c, x + ((row0 + min(q, Q - 1)) * H + h) * P + c,
             q < Q);
      }
      if (tid < BQ)
        cp4(b + BQ * XST + tid, dt + (row0 + min(q0 + tid, Q - 1)) * H + h,
            q0 + tid < Q);
    }
    cp_commit();
  };
  const int n_steps = is_state ? ng * n_q : n_score + ng * n_tiles;
  // the first stage's copies fly while acum is summed
  if (is_state) issue_state(0); else issue_rows(0);

  // ---- acum = inclusive cumsum of dt * A over the chunk, per head ------
  for (int idx = tid; idx < ng * Q; idx += NT) {
    const int q = idx / ng, hg = idx - q * ng;
    acum[hg * Q + q] = dt[(row0 + q) * H + h0 + hg] * A[h0 + hg];
  }
  __syncthreads();
  // in order, one thread per head: the rounding of the plain version's
  // cumsum, whose sums of hundreds of terms set the decays' exponents
  if (tid < ng) {
    float* a = acum + tid * Q;
    float run = 0.f;
#pragma unroll 8
    for (int q = 0; q < Q; ++q) {
      run += a[q];
      a[q] = run;
    }
  }
  // (the first step's barrier publishes acum)

  // Each step: start the next step's copies into the other buffer, wait
  // for this step's, compute, and let every warp finish reading before
  // the buffer is filled again.
  auto advance = [&](int s) {
    if (s + 1 < n_steps) {
      if (is_state) issue_state(s + 1); else issue_rows(s + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    return buf(s);
  };

  // Warp tiles: a warp owns 32 rows or columns (w1) of a 64-wide tile;
  // in y and the states it takes one half (kh) of each step's k-steps,
  // the two halves' sums meeting through shared memory once per head; in
  // the scores kh picks the half of the source rows.
  const int w1 = warp & 1, kh = warp >> 1;
  const int k_lo = 4 * kh, k_hi = 4 * kh + 4;

  // ---- chunk states (64 columns a CTA) and decays ------------------------
  if (is_state) {
    // warp tile: all P rows x state columns nb0 + 32 w1 .. + 31
    float acc[MT][4][4];
    for (int s = 0; s < n_steps; ++s) {
      const float* b = advance(s);
      const int hg = s / n_q, qs = s % n_q, q0 = qs * SQ;
      const float* ag = acum + hg * Q;
      const float alast = ag[Q - 1];
      if (qs == 0) zero(acc);
      const float* Xh = b;                     // x rows, raw
      const float* Bs = b + SQ * XST;
      const float* dts = b + SQ * (XST + BST);
      const int ksteps = (min(SQ, Q - q0) + 7) / 8;
      // A (m = p, k = q) = x_q[p] dt_q exp(acum_last - acum_q), read down
      // the staged rows; rows past Q weigh 0 (exp of 0 there)
      kloop(acc, k_lo, min(ksteps, k_hi), [&](int ks, Frags<MT, 4>& f) {
        const int ka = ks * 8 + t, kb = ka + 4;
        const bool ma = q0 + ka < Q, mb = q0 + kb < Q;
        const float ea = expf(ma ? alast - ag[q0 + ka] : 0.f);
        const float eb = expf(mb ? alast - ag[q0 + kb] : 0.f);
        const float wa = ma ? dts[ka] * ea : 0.f;
        const float wb = mb ? dts[kb] * eb : 0.f;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float* xa = Xh + m * 16 + g;
          split(xa[ka * XST] * wa, f.ab[m][0], f.as[m][0]);
          split(xa[kb * XST] * wb, f.ab[m][2], f.as[m][2]);
          if constexpr (P >= 16) {
            split(xa[ka * XST + 8] * wa, f.ab[m][1], f.as[m][1]);
            split(xa[kb * XST + 8] * wb, f.ab[m][3], f.as[m][3]);
          } else {
            f.ab[m][1] = f.as[m][1] = f.ab[m][3] = f.as[m][3] = 0u;
          }
        }
        load_b_kn(Bs + ks * 8 * BST + w1 * 32, BST, g, t, f);
      });
      if (qs == n_q - 1) {
        // the second k-half's sums join the first's through the buffer
        float* red = buf(s);
        __syncthreads();
        if (kh == 1) {
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int n = 0; n < 4; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                red[((m * 4 + n) * 4 + e) * 64 + tid - 64] = acc[m][n][e];
        }
        __syncthreads();
        const int h = h0 + hg;
        if (blockIdx.x == 0 && tid == 0)
          decay[(size_t)bc * H + h] = expf(alast);
        if (kh == 0) {
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[m][nt][e] += red[((m * 4 + nt) * 4 + e) * 64 + tid];
              const int n = nb0 + w1 * 32 + nt * 8 + 2 * t;
              if (n >= N) continue;
              float* o =
                  st + (((size_t)bc * H + h) * P + m * 16 + g) * N + n;
              st2(o, acc[m][nt][0], acc[m][nt][1]);
              if constexpr (P >= 16)
                st2(o + 8 * (size_t)N, acc[m][nt][2], acc[m][nt][3]);
            }
        }
      }
      __syncthreads();  // every warp is done with this buffer
    }
    return;
  }

  // ---- a block of 64 output rows -----------------------------------------
  // scores S[r][j] = C_{i0 + r} . B_j, shared by the CTA's heads; warp
  // tile: rows 32 w1 .. + 31 x source columns 32 kh .. + 31 of each tile
  {
    float sacc[2][4][4];
    for (int s = 0; s < n_score; ++s) {
      const float* b = advance(s);
      const int jt = s / n_chunks, ch = s % n_chunks;
      if (ch == 0) zero(sacc);
      const float* Cs = b;
      const float* Bs = b + BQ * CST;
      const int ksteps = (min(NCH, N - ch * NCH) + 7) / 8;
      kloop(sacc, 0, ksteps, [&](int ks, Frags<2, 4>& f) {
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const float* ca = Cs + (w1 * 32 + m * 16 + g) * CST + ks * 8 + t;
          split(ca[0], f.ab[m][0], f.as[m][0]);
          split(ca[8 * CST], f.ab[m][1], f.as[m][1]);
          split(ca[4], f.ab[m][2], f.as[m][2]);
          split(ca[8 * CST + 4], f.ab[m][3], f.as[m][3]);
        }
        // B (k = n, n = j): row j of the staged B, as stored
        const float* bp = Bs + (kh * 32 + g) * CST + ks * 8 + t;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          split(bp[n * 8 * CST], f.bb[n][0], f.bs[n][0]);
          split(bp[n * 8 * CST + 4], f.bb[n][1], f.bs[n][1]);
        }
      });
      if (ch == n_chunks - 1) {
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            float* o = S + (w1 * 32 + m * 16 + g) * SST + jt * BQ + kh * 32 +
                       n * 8 + 2 * t;
            st2(o, sacc[m][n][0], sacc[m][n][1]);
            st2(o + 8 * SST, sacc[m][n][2], sacc[m][n][3]);
          }
      }
      __syncthreads();
    }
  }

  // per head: y_i = sum_{j <= i} S_ij exp(acum_i - acum_j) dt_j x_j over
  // the source tiles; warp tile: rows 32 w1 .. + 31 x all P columns,
  // k-steps 4 kh .. 4 kh + 3 of each tile
  const int r0 = w1 * 32;                       // the warp's first row
  float acc[2][NTY][4];
  float ar[2][2];                               // acum of the lane's rows
  for (int s = n_score; s < n_steps; ++s) {
    const float* b = advance(s);
    const int u = s - n_score, hg = u / n_tiles, jt = u % n_tiles;
    const float* ag = acum + hg * Q;
    if (jt == 0) {
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int i = i0 + r0 + m * 16 + hi * 8 + g;
          ar[m][hi] = i < Q ? ag[i] : 0.f;
        }
      zero(acc);
    }
    const float* Xs = b;                        // x rows, raw
    const float* dts = b + BQ * XST;
    int ksteps = (min(BQ, Q - jt * BQ) + 7) / 8;
    if (jt == ib) ksteps = min(ksteps, (r0 + 32) / 8);  // j <= the warp's rows
    // W = S * exp(acum_i - acum_j) * dt_j where j <= i < Q, else exactly
    // 0; exp is taken of 0 there, never of an argument above the diagonal
    kloop(acc, k_lo, min(ksteps, k_hi), [&](int ks, Frags<2, NTY>& f) {
      const int ka = ks * 8 + t, kb = ka + 4;
      const int ja = jt * BQ + ka, jb = ja + 4;
      const float gja = ag[ja], gjb = ag[jb], da = dts[ka], db = dts[kb];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float* sp = S + (r0 + m * 16 + g) * SST + ja;
#pragma unroll
        for (int e = 0; e < 4; ++e) {   // (g, t) (g+8, t) (g, t+4) (g+8, t+4)
          const int hi = e & 1, kj = e >> 1;
          const int i = i0 + r0 + m * 16 + hi * 8 + g;
          const bool on = i < Q && (kj ? jb : ja) <= i;
          const float ex = expf(on ? ar[m][hi] - (kj ? gjb : gja) : 0.f);
          const float sv = sp[hi * 8 * SST + kj * 4];
          split(on ? sv * ex * (kj ? db : da) : 0.f, f.ab[m][e], f.as[m][e]);
        }
      }
      load_b_kn(Xs + ks * 8 * XST, XST, g, t, f);
    });
    if (jt == n_tiles - 1) {
      // the second k-half's sums join the first's through the spent buffer
      float* red = buf(s);
      __syncthreads();
      if (kh == 1) {
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int n = 0; n < NTY; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              red[((m * NTY + n) * 4 + e) * 64 + tid - 64] = acc[m][n][e];
      }
      __syncthreads();
      if (kh == 0) {
        const int h = h0 + hg;
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int n = 0; n < NTY; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[m][n][e] += red[((m * NTY + n) * 4 + e) * 64 + tid];
            const int col = n * 8 + 2 * t;
            const int ia = i0 + r0 + m * 16 + g, ic = ia + 8;
            if (ia < Q)
              st2(y + ((row0 + ia) * H + h) * P + col, acc[m][n][0],
                  acc[m][n][1]);
            if (ic < Q)
              st2(y + ((row0 + ic) * H + h) * P + col, acc[m][n][2],
                  acc[m][n][3]);
          }
      }
    }
    __syncthreads();
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
  const dim3 grid((N + SN - 1) / SN + (Q + BQ - 1) / BQ, (H + HG - 1) / HG,
                  BC);
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

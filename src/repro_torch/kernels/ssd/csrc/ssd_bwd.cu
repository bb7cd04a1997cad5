// The backward of the Mamba-2 SSD intra-chunk step for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package differentiates its SSD with
// jax.value_and_grad (src/repro/train/step.py:54) through the plain
// chunked form (src/repro/models/ssm.py:104), and its Pallas forward
// (src/repro/kernels/ssd/kernel.py::ssd_chunk_kernel) has no backward.
// It is the backward of csrc/ssd.cu's function: for every (batch b,
// chunk c, head h), float32 inputs x (B,c,Q,H,P), dt (B,c,Q,H), A (H,),
// B and C (B,c,Q,N) and the cotangents dy (B,c,Q,H,P), dstate
// (B,c,H,P,N) and ddecay (B,c,H), with acum the inclusive cumsum of
// dt * A, CB = C.B^T, the causal L_ij = exp(acum_i - acum_j),
// M = CB o L o dt_j, dte = exp(acum_last - acum) and w = dt o dte:
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
// causal half of C.B^T, dCB.B and dCB^T.C per chunk: ~44 GFLOP, 0.65 ms
// at the 67 TFLOP/s float32 rate, 0.27 ms as 3xTF32 tensor-core products
// at 495 TFLOP/s.  It is bound by operations.
//
// Design: a simple kernel that is right.  Every product runs as float32
// FMA on the CUDA cores from shared memory (no tensor cores): 256
// threads, each a 4 x 4 block of a 64 x 64 output tile (rows tr + 16 a,
// columns tc + 16 b), tiles stored with an odd row stride (65) so that a
// tile is read down its rows or its columns without bank conflicts.
// Nothing uses float atomics: every sum across CTAs is a second pass in
// a fixed order, so two calls give equal bits.  Six launches:
//  1. ssd_bwd_cb: CB = C.B^T per chunk, its causal 64 x 64 tiles, into
//     scratch (B*c, Q, Q).
//  2. ssd_bwd_main: a CTA per (b*c, group of HG = 8 heads, block of 64
//     source rows j), heaviest blocks first.  It sums acum for its heads
//     in row order (as the forward does), then per head: U = B_j.dstate^T
//     and V = x_j.dstate (N in chunks of 64), dw and dx's state term;
//     w o V summed over the group's heads into its own slice of a
//     (B*c, groups, Q, N) scratch; then for every block of target rows
//     i >= j: dM = dy_i.x_j^T, G, M, G o CB, with dx_j += M^T.dy_i,
//     colsum(G o CB) kept, rowsum(G o CB o dt_j) written per source
//     block, and G o dt_j summed over the group's heads into its slice
//     of a (B*c, groups, Q, Q) scratch (84 MB at the training shape).
//     A thread adds into those slices the same elements for each head,
//     so no two threads touch one element.  It exponentiates only where
//     j <= i < Q (exp of 0 elsewhere), so steep decays never overflow.
//  3. ssd_bwd_dcb: dCB = the group slices summed in order.
//  4. ssd_bwd_dbc: dC = dCB.B and dB = dCB^T.C + the groups' w o V.
//  5. ssd_bwd_finish: a thread per (b*c, h) sums the row partials, forms
//     dacum, its reverse cumsum da, ddt and the chunk's share of dA.
//  6. ssd_bwd_da: dA summed over b*c in order.
// Any Q in 1..256, P in {8, 16, 32, 64} (tiles are 64 wide, columns past
// P zero), N a multiple of 4.  Shared memory of ssd_bwd_main: 108 KB,
// two CTAs per SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;          // threads per CTA
constexpr int BT = 64;           // tile rows and columns
constexpr int TS = BT + 1;       // row stride of a tile in shared memory
constexpr int TILE = BT * TS;    // floats of a tile
constexpr int HG = 8;            // heads per CTA of ssd_bwd_main
constexpr int QMAX = 256;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

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

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
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
__global__ void __launch_bounds__(NT)
    ssd_bwd_cb(const float* __restrict__ Bm, const float* __restrict__ Cm,
               float* __restrict__ CB, int Q, int N) {
  extern __shared__ float smem[];
  float* Cs = smem;
  float* Bs = smem + TILE;
  const int nb = cdiv(Q, BT);
  const int ib = blockIdx.x / nb, jb = blockIdx.x % nb;
  if (jb > ib) return;
  const size_t bc = blockIdx.y;
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const float* C0 = Cm + bc * Q * N;
  const float* B0 = Bm + bc * Q * N;
  float acc[4][4];
  zero(acc);
  for (int n0 = 0; n0 < N; n0 += BT) {
    load_tile(Cs, C0, N, ib * BT, Q, n0, N);
    load_tile(Bs, B0, N, jb * BT, Q, n0, N);
    __syncthreads();
    tile_fma(acc, BT, tr, tc, [&](int r, int k) { return Cs[r * TS + k]; },
             [&](int k, int c) { return Bs[c * TS + k]; });
    __syncthreads();
  }
  float* out = CB + bc * Q * Q;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = ib * BT + tr + 16 * a, j = jb * BT + tc + 16 * b;
      if (i < Q && j < Q) out[(size_t)i * Q + j] = acc[a][b];
    }
}

// ---- 2. the per-head products ------------------------------------------
struct MainArgs {
  const float *x, *dt, *A, *Bm, *dy, *dst, *CB;
  float *dx, *ddt, *dcb_part, *v_part, *r_part, *q_row, *dww_row;
  int Q, H, P, N, G;
};

__global__ void __launch_bounds__(NT, 2) ssd_bwd_main(MainArgs p) {
  extern __shared__ float smem[];
  const int Q = p.Q, H = p.H, P = p.P, N = p.N, G = p.G;
  const int nb = cdiv(Q, BT);
  const int jb = blockIdx.x;          // block 0, the heaviest, first
  const int g = blockIdx.y;
  const size_t bc = blockIdx.z;
  const int h0 = g * HG, ng = min(HG, H - h0);
  const int j0 = jb * BT;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;

  float* acum = smem;                 // [HG][Q]
  float* dtj = acum + HG * QMAX;      // [HG][BT] dt of the source rows
  float* wsh = dtj + HG * BT;         // [BT] w of the source rows, one head
  float* dwsh = wsh + BT;             // [BT] dw of the source rows
  float* Xs = dwsh + BT;              // x_j            [BT][TS]
  float* Us = Xs + TILE;              // U = B_j.dstate^T
  float* T1 = Us + TILE;              // B_j chunk / dy_i
  float* T2 = T1 + TILE;              // dstate chunk (p rows) / CB tile
  float* T3 = T2 + TILE;              // M tile
  float* T4 = T3 + TILE;              // G o CB tile

  const size_t row0 = bc * Q;         // the chunk's first row
  // acum = the inclusive cumsum of dt * A in row order, per head
  for (int idx = tid; idx < ng * Q; idx += NT) {
    const int q = idx / ng, hg = idx - q * ng;
    acum[hg * Q + q] = p.dt[(row0 + q) * H + h0 + hg] * p.A[h0 + hg];
  }
  for (int idx = tid; idx < ng * BT; idx += NT) {
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
  }
  __syncthreads();

  const size_t part = bc * G + g;     // this group's slice of the scratch
  float* dcb = p.dcb_part + part * Q * Q;
  float* vp = p.v_part + part * Q * N;

  for (int hg = 0; hg < ng; ++hg) {
    const int h = h0 + hg;
    const float* ag = acum + hg * Q;
    const float alast = ag[Q - 1];
    if (tid < BT) {
      const int j = j0 + tid;
      wsh[tid] = j < Q ? dtj[hg * BT + tid] * expf(alast - ag[j]) : 0.f;
    }
    // x_j rows (columns past P zero)
    load_tile(Xs, p.x + (row0 * H + h) * P, (size_t)H * P, j0, Q, 0, P);

    // U = B_j.dstate^T (P columns) and V = x_j.dstate, N in chunks
    float uacc[4][4];
    zero(uacc);
    const float* dsth = p.dst + (bc * H + h) * (size_t)P * N;
    for (int n0 = 0; n0 < N; n0 += BT) {
      __syncthreads();                        // T1, T2 free; wsh, Xs ready
      load_tile(T1, p.Bm + row0 * N, N, j0, Q, n0, N);
      load_tile(T2, dsth, N, 0, P, n0, N);    // rows p, columns n
      __syncthreads();
      tile_fma(uacc, BT, tr, tc, [&](int r, int k) { return T1[r * TS + k]; },
               [&](int k, int c) { return T2[c * TS + k]; });
      float vacc[4][4];
      zero(vacc);
      tile_fma(vacc, P, tr, tc, [&](int r, int k) { return Xs[r * TS + k]; },
               [&](int k, int c) { return T2[k * TS + c]; });
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int r = tr + 16 * a, j = j0 + r, n = n0 + tc + 16 * b;
          if (j < Q && n < N) {
            float* o = vp + (size_t)j * N + n;
            const float v = wsh[r] * vacc[a][b];
            *o = hg == 0 ? v : *o + v;
          }
        }
    }
    // dx starts as w o U; dw = x_j.U_j
    float dxacc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int r = tr + 16 * a, c = tc + 16 * b;
        Us[r * TS + c] = uacc[a][b];
        dxacc[a][b] = wsh[r] * uacc[a][b];
      }
    __syncthreads();
    if (tid < BT) {
      float s = 0.f;
      for (int c = 0; c < P; ++c) s += Xs[tid * TS + c] * Us[tid * TS + c];
      dwsh[tid] = s;
    }

    float s_col = 0.f;                        // colsum of G o CB, row j
    for (int ib = jb; ib < nb; ++ib) {
      const int i0 = ib * BT;
      __syncthreads();                        // T1-T4 free
      load_tile(T1, p.dy + (row0 * H + h) * P, (size_t)H * P, i0, Q, 0, P);
      load_tile(T2, p.CB + bc * Q * Q + j0, Q, i0, Q, 0, Q - j0);
      __syncthreads();
      float dm[4][4];
      zero(dm);
      tile_fma(dm, P, tr, tc, [&](int r, int k) { return T1[r * TS + k]; },
               [&](int k, int c) { return Xs[c * TS + k]; });
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int r = tr + 16 * a, c = tc + 16 * b;
          const int i = i0 + r, j = j0 + c;
          const bool on = i < Q && j <= i;    // j <= i < Q: j < Q too
          const float L = on ? expf(ag[i] - ag[j]) : 0.f;
          const float gij = dm[a][b] * L;
          const float cb = T2[r * TS + c];
          const float dj = dtj[hg * BT + c];
          T3[r * TS + c] = cb * L * dj;       // M
          T4[r * TS + c] = gij * cb;          // G o CB
          if (i < Q && j < Q) {
            float* o = dcb + (size_t)i * Q + j;
            const float v = gij * dj;
            *o = hg == 0 ? v : *o + v;
          }
        }
      __syncthreads();
      if (tid < BT) {
        for (int r = 0; r < BT; ++r) s_col += T4[r * TS + tid];
      } else if (tid < 2 * BT) {
        const int r = tid - BT, i = i0 + r;
        float s = 0.f;
        for (int c = 0; c < BT; ++c) s += T4[r * TS + c] * dtj[hg * BT + c];
        if (i < Q)
          p.r_part[((bc * nb + jb) * Q + i) * H + h] = s;
      }
      // dx_j += M^T.dy_i
      tile_fma(dxacc, min(BT, Q - i0), tr, tc,
               [&](int r, int k) { return T3[k * TS + r]; },
               [&](int k, int c) { return T1[k * TS + c]; });
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = j0 + tr + 16 * a, c = tc + 16 * b;
        if (j < Q && c < P) p.dx[((row0 + j) * H + h) * P + c] = dxacc[a][b];
      }
    if (tid < BT) {
      const int j = j0 + tid;
      if (j < Q) {
        const float w = wsh[tid], dw = dwsh[tid];
        const float dte = expf(alast - ag[j]);
        const size_t o = (row0 + j) * H + h;
        p.ddt[o] = s_col + dw * dte;
        p.q_row[o] = -dtj[hg * BT + tid] * s_col - dw * w;
        p.dww_row[o] = dw * w;
      }
    }
  }
}

// ---- 3. dCB = the groups' slices summed in order ------------------------
__global__ void __launch_bounds__(NT)
    ssd_bwd_dcb(const float* __restrict__ part, float* __restrict__ dCB,
                int Q, int G) {
  const int nb = cdiv(Q, BT);
  const int ib = blockIdx.x / nb, jb = blockIdx.x % nb;
  if (jb > ib) return;
  const size_t bc = blockIdx.y;
  for (int idx = threadIdx.x; idx < BT * BT; idx += NT) {
    const int i = ib * BT + (idx >> 6), j = jb * BT + (idx & 63);
    if (i >= Q || j >= Q) continue;
    const size_t e = (size_t)i * Q + j;
    float s = 0.f;
    for (int gg = 0; gg < G; ++gg) s += part[(bc * G + gg) * Q * Q + e];
    dCB[bc * Q * Q + e] = s;
  }
}

// ---- 4. dC = dCB.B, dB = dCB^T.C + sum_g w o V --------------------------
__global__ void __launch_bounds__(NT)
    ssd_bwd_dbc(const float* __restrict__ dCB, const float* __restrict__ Bm,
                const float* __restrict__ Cm,
                const float* __restrict__ v_part, float* __restrict__ dB,
                float* __restrict__ dC, int Q, int N, int G) {
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
  zero(acc);
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
      float v = acc[a][b];
      if (kind == 1)
        for (int gg = 0; gg < G; ++gg)
          v += v_part[((bc * G + gg) * Q + r) * N + n];
      out[(size_t)r * N + n] = v;
    }
}

// ---- 5. dacum, da, ddt and the chunk's share of dA, per (b*c, h) --------
__global__ void __launch_bounds__(128)
    ssd_bwd_finish(const float* __restrict__ dt, const float* __restrict__ A,
                   const float* __restrict__ ddecay,
                   const float* __restrict__ r_part,
                   const float* __restrict__ q_row,
                   const float* __restrict__ dww_row, float* __restrict__ ddt,
                   float* __restrict__ da_part, int BC, int Q, int H) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= BC * H) return;
  const size_t bc = t / H;
  const int h = t % H, nb = cdiv(Q, BT);
  const float a = A[h];
  const size_t row0 = bc * Q;
  float alast = 0.f, tot = 0.f;
  for (int q = 0; q < Q; ++q) {
    alast = __fadd_rn(alast, __fmul_rn(dt[(row0 + q) * H + h], a));
    tot += dww_row[(row0 + q) * H + h];
  }
  float run = 0.f, dA = 0.f;
  for (int j = Q - 1; j >= 0; --j) {
    const size_t o = (row0 + j) * H + h;
    float r = 0.f;
    for (int jb = 0; jb <= j / BT; ++jb)
      r += r_part[((bc * nb + jb) * Q + j) * H + h];
    float dacum = r + q_row[o];
    if (j == Q - 1) dacum += tot + ddecay[bc * H + h] * expf(alast);
    run += dacum;                               // da_j
    ddt[o] += a * run;
    dA += run * dt[o];
  }
  da_part[t] = dA;
}

// ---- 6. dA = the chunks' shares summed in order --------------------------
__global__ void ssd_bwd_da(const float* __restrict__ da_part,
                           float* __restrict__ dA, int BC, int H) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  float s = 0.f;
  for (int bc = 0; bc < BC; ++bc) s += da_part[(size_t)bc * H + h];
  dA[h] = s;
}

constexpr size_t MAIN_SMEM =
    (size_t)(HG * QMAX + HG * BT + 2 * BT + 6 * TILE) * sizeof(float);
constexpr size_t PAIR_SMEM = 2 * (size_t)TILE * sizeof(float);

size_t align4(size_t n) { return (n + 3) / 4 * 4; }

// the scratch regions, in floats, each a multiple of 4 (16 bytes)
struct Scratch {
  size_t cb, dcb_part, dcb, v_part, r_part, q_row, dww_row, da_part, total;
  Scratch(int BC, int Q, int H, int N) {
    const size_t G = cdiv(H, HG), nb = cdiv(Q, BT);
    size_t off = 0;
    auto take = [&](size_t n) {
      const size_t at = off;
      off += align4(n);
      return at;
    };
    cb = take((size_t)BC * Q * Q);
    dcb_part = take((size_t)BC * G * Q * Q);
    dcb = take((size_t)BC * Q * Q);
    v_part = take((size_t)BC * G * Q * N);
    r_part = take((size_t)BC * nb * Q * H);
    q_row = take((size_t)BC * Q * H);
    dww_row = take((size_t)BC * Q * H);
    da_part = take((size_t)BC * H);
    total = off;
  }
};

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
// repro_ssd_chunk_bwd_scratch gives).  Returns a cudaError_t.
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
      ssd_bwd_main, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)MAIN_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ssd_bwd_cb,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  a.dcb_part = sc + L.dcb_part;
  a.v_part = sc + L.v_part;
  a.r_part = sc + L.r_part;
  a.q_row = sc + L.q_row;
  a.dww_row = sc + L.dww_row;
  a.Q = Q;
  a.H = H;
  a.P = P;
  a.N = N;
  a.G = G;
  ssd_bwd_main<<<dim3(nb, G, BC), NT, MAIN_SMEM, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  ssd_bwd_dcb<<<dim3(nb * nb, BC), NT, 0, s>>>(sc + L.dcb_part, sc + L.dcb,
                                               Q, G);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  ssd_bwd_dbc<<<dim3(2 * nb * nn, BC), NT, PAIR_SMEM, s>>>(
      sc + L.dcb, Bf, Cf, sc + L.v_part, static_cast<float*>(dB),
      static_cast<float*>(dC), Q, N, G);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  ssd_bwd_finish<<<cdiv(BC * H, 128), 128, 0, s>>>(
      a.dt, a.A, static_cast<const float*>(ddecay), sc + L.r_part,
      sc + L.q_row, sc + L.dww_row, a.ddt, sc + L.da_part, BC, Q, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  ssd_bwd_da<<<cdiv(H, 128), 128, 0, s>>>(sc + L.da_part,
                                           static_cast<float*>(dA), BC, H);
  return (int)cudaGetLastError();
}

}  // extern "C"

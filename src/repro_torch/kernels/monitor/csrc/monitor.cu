// Hopper (sm_90a) kernels of the fleet service-rate monitor.
//
// Built by repro_torch/kernels/monitor/kernel.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded through ctypes.
// Every entry point launches on the stream it is given, allocates
// nothing, never synchronises, and returns cudaGetLastError().
//
// -fmad=false: the plain PyTorch versions (kernels/monitor/ref.py) run
// every multiply and add as its own rounded operation.  The convergence
// test `resp < tol` is exact, so a fused multiply-add that rounds once
// where the plain version rounds twice would move an epoch boundary.
//
// Both kernels give a CTA of THREADS threads a block of THREADS rows
// (queues).  A row-major (rows, w) array's block is one contiguous run of
// bytes: the CTA copies it into shared memory with 16-byte loads that
// neighbouring threads issue on neighbouring addresses (stage_rows), at a
// row stride of an odd number of 4-byte words, so that the per-row reads
// that follow -- thread r walking row r -- hit 32 different banks.
//
// ---------------------------------------------------------------------------
// monitor_fleet_kernel
//   Replaces the TPU kernel src/repro/kernels/monitor/kernel.py ::
//   monitor_fleet_kernel (launched by monitor_fleet_pallas): the fused,
//   time-batched Algorithm 1 over a compacted (Q, T) tile.  Stage A is the
//   Gaussian stencil plus the sliding mean/std of ref.py::fleet_window_stage,
//   Stage B the sequential fold of ref.py::fleet_step.
//
//   Design: one thread per queue; the TPU kernel's sequential time loop is
//   a loop inside the thread.  The stencil taps, the n = W - 2R centred
//   filtered values of the current window, the q-bar and response
//   histories and every scalar of the state stay in registers for the
//   whole tile (W, CW and R are template parameters, so every array index
//   is a compile-time constant).
//   Memory: the state's row-major leaves (win, qhist, rhist, shist) are
//   staged through shared memory, read and written once per tile, in
//   place; the window row stays in shared memory and the new window is
//   built there.  The tile goes through shared memory TC steps at a time
//   as a [step][queue] block, from either layout of comp (a template
//   parameter): time-major -- comp[t * ld + q], the transposed view of the
//   service's (T, Q) staging, where a warp reads 128 contiguous bytes a
//   step -- or row-major -- comp[q * ld + t], where a warp reads one
//   queue's TC steps.  A tile of at most TC steps (the service's) is read
//   from device memory once for both passes (the centring constant needs
//   every filtered value first); a longer one twice.  The six (Q, T)
//   output planes are stored only in full mode, thread per row.
//   A queue stops at its compacted count m in state mode: the steps past
//   m change nothing.
//
//   Bound on the card: bytes by the function's traffic (per state-mode
//   dispatch: the f32 tile, m, and the state read and written once,
//   4*(W + 2*CW + 8) bytes per queue).  What holds it is the fold, not
//   the bytes: about 500 unfused instructions per queue and step (IEEE
//   divisions and square roots, no fused multiply-adds, the register
//   shifts of the sliding window and histories) in dependent chains, at
//   16 resident warps an SM (128 registers a thread).  The response
//   history's max is a tree of nan_max, not a chain, to shorten the
//   step's longest dependent chain.
//
// batched_monitor_kernel
//   Replaces the TPU kernel src/repro/kernels/monitor/kernel.py ::
//   monitor_kernel (launched by batched_monitor_pallas): the per-tick
//   window stage, a normalised Gaussian stencil over each (w,) row, then
//   the mean and population std of the w - 2R filtered values;
//   q = mu + z * sd.  The std is taken in two passes (mean first, then the
//   mean squared deviation), as ref.py::batched_monitor_ref does, not as
//   E[x^2] - mu^2 like the Pallas kernel.
//
//   Design: the CTA's rows are staged in shared memory in their input
//   type (f32 or bf16, converted with __bfloat162float on the read from
//   shared memory).  Instances with the window and tap count as template
//   parameters (w = 16, 32, 64 with 5 taps) keep the filtered values in
//   registers and read each input once; the runtime instance (any
//   w >= ntaps, at most ROWS_CAP_BYTES of rows a CTA) recomputes the
//   stencil from shared memory in its second pass.
//   Bound on the card: bytes (read Q*w inputs, write 3*Q floats; ~w*12
//   flops per row).
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#define MAX_TAPS 9
#define THREADS 128          // threads a CTA = rows (queues) a CTA
#define TC 32                // tile steps staged in shared memory at once
#define SMEM_DEFAULT 49152   // dynamic shared memory without an opt-in
#define SMEM_MAX 232448      // the most a CTA may opt in to on sm_90
#define ROWS_CAP_BYTES 98304 // runtime batched instance: rows a CTA

namespace {

struct Taps {
  float v[MAX_TAPS];
};

struct FleetParams {
  Taps gauss;       // 2R + 1 Eq. 2 taps
  float log0, log1, log2;
  float z;          // Eq. 3 quantile multiplier
  float conv_tol;
  float trace_min;  // max(CW + 2, min_q_samples)
  float tiny;       // 1e-12 as float
  float big;        // _BIG as float
  int rel_tol;
  int window_std;
};

// ---- shared-memory staging -------------------------------------------------
// Row stride, in elements of T, of a w-wide row in shared memory: the
// smallest odd number of 4-byte words that holds the row, so thread r's
// word k of row r falls in bank (r * stride_words + k) mod 32, a
// different bank for each of 32 consecutive rows.
template <typename T>
__host__ __device__ constexpr int row_stride(int w) {
  return ((((int)sizeof(T) * w + 3) / 4) | 1) * 4 / (int)sizeof(T);
}

// Copies the n consecutive elements at src into shared memory as rows of
// w elements: element i lands at dst[(i / w) * stride + i % w].  The CTA's
// threads take 16-byte vectors in turn (neighbouring threads,
// neighbouring addresses), B of them loaded before any is stored;
// elements before the first 16-byte boundary and after the last whole
// vector go one at a time.  WC is w when it is a
// compile-time constant (the division becomes a shift), else 0.
template <typename T, int WC>
__device__ __forceinline__ void stage_rows(const T* src, int n, T* dst,
                                           int w, int stride) {
  constexpr int V = 16 / sizeof(T);
  const int wd = WC ? WC : w;
  auto put = [&](int i, T x) { dst[(i / wd) * stride + i % wd] = x; };
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  int head = (int)(((16 - (a & 15)) & 15) / sizeof(T));
  if (a % sizeof(T) != 0 || head > n) head = n;
  const int nvec = (n - head) / V;
  for (int i = threadIdx.x; i < head; i += blockDim.x) put(i, src[i]);
  const uint4* vsrc = reinterpret_cast<const uint4*>(src + head);
  constexpr int B = 8;       // vectors a thread has in flight at once
  for (int v0 = threadIdx.x; v0 < nvec; v0 += B * blockDim.x) {
    uint4 x[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int v = v0 + b * blockDim.x;
      if (v < nvec) x[b] = vsrc[v];
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int v = v0 + b * blockDim.x;
      if (v < nvec) {
        const T* e = reinterpret_cast<const T*>(&x[b]);
#pragma unroll
        for (int k = 0; k < V; ++k) put(head + v * V + k, e[k]);
      }
    }
  }
  for (int i = head + nvec * V + threadIdx.x; i < n; i += blockDim.x)
    put(i, src[i]);
}

// The inverse of stage_rows: the rows in shared memory back to the n
// consecutive elements at dst.
template <typename T, int WC>
__device__ __forceinline__ void unstage_rows(T* dst, int n, const T* src,
                                             int w, int stride) {
  constexpr int V = 16 / sizeof(T);
  const int wd = WC ? WC : w;
  auto get = [&](int i) { return src[(i / wd) * stride + i % wd]; };
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst);
  int head = (int)(((16 - (a & 15)) & 15) / sizeof(T));
  if (a % sizeof(T) != 0 || head > n) head = n;
  const int nvec = (n - head) / V;
  for (int i = threadIdx.x; i < head; i += blockDim.x) dst[i] = get(i);
  uint4* vdst = reinterpret_cast<uint4*>(dst + head);
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
    uint4 x;
    T* e = reinterpret_cast<T*>(&x);
#pragma unroll
    for (int k = 0; k < V; ++k) e[k] = get(head + v * V + k);
    vdst[v] = x;
  }
  for (int i = head + nvec * V + threadIdx.x; i < n; i += blockDim.x)
    dst[i] = get(i);
}

// Steps [t0, t0 + tc) of the CTA's `rows` queues into s[tt * (THREADS + 1)
// + r].  Time-major: a warp takes 32 neighbouring queues of one step;
// row-major: a warp takes one queue's TC steps.  The odd stride keeps
// both the writes here and thread r's reads of column r free of bank
// conflicts.  Ends with the CTA's barrier.
template <bool TIME_MAJOR>
__device__ __forceinline__ void stage_tile(const float* __restrict__ comp,
                                           long long ld, int q0, int rows,
                                           int t0, int tc, float* s) {
  constexpr int CP = THREADS + 1;
  for (int i = threadIdx.x; i < TC * THREADS; i += THREADS) {
    int r, tt;
    if (TIME_MAJOR) {
      tt = i / THREADS;
      r = i % THREADS;
    } else {
      r = i / TC;
      tt = i % TC;
    }
    if (r < rows && tt < tc) {
      const long long q = q0 + r, t = t0 + tt;
      s[tt * CP + r] = TIME_MAJOR ? comp[t * ld + q] : comp[q * ld + t];
    }
  }
  __syncthreads();
}

// ---- the doubling ladder of ref.py::_ladder, at compile time -------------
// pows[2k][j] = pows[k][j] + pows[k][j + k]: a balanced tree over K values.
template <int K, int OFF, bool SQ, int N>
__device__ __forceinline__ float tree_sum(const float (&a)[N]) {
  if constexpr (K == 1) {
    if constexpr (SQ) return a[OFF] * a[OFF];
    else return a[OFF];
  } else {
    return tree_sum<K / 2, OFF, SQ, N>(a) + tree_sum<K / 2, OFF + K / 2, SQ, N>(a);
  }
}

// parts in descending power-of-two order, acc = acc + part
template <int N, int K, int OFF, bool SQ>
__device__ __forceinline__ float ladder_rest(const float (&a)[N], float acc) {
  if constexpr (K == 0) {
    return acc;
  } else if constexpr ((N & K) != 0) {
    return ladder_rest<N, K / 2, OFF + K, SQ>(a, acc + tree_sum<K, OFF, SQ, N>(a));
  } else {
    return ladder_rest<N, K / 2, OFF, SQ>(a, acc);
  }
}

__host__ __device__ constexpr int high_bit(int n) {
  int k = 1;
  while (k * 2 <= n) k *= 2;
  return k;
}

template <int N, bool SQ>
__device__ __forceinline__ float ladder_sum(const float (&a)[N]) {
  constexpr int HI = high_bit(N);
  return ladder_rest<N, HI / 2, HI, SQ>(a, tree_sum<HI, 0, SQ, N>(a));
}

// NaN-propagating max, as jnp.maximum / torch.amax / torch.clamp
__device__ __forceinline__ float nan_max(float acc, float x) {
  return (isnan(x) || x > acc) ? x : acc;
}

// max |a[i]| over a[OFF, OFF + K), as a balanced tree of nan_max: a NaN
// anywhere gives NaN (nan_max passes one on from either side), otherwise
// the largest magnitude -- the plain version's amax in any order, and a
// chain of K - 1 dependent steps shortened to log2(K)
template <int K, int OFF, int N>
__device__ __forceinline__ float tree_absmax(const float (&a)[N]) {
  if constexpr (K == 1) {
    return fabsf(a[OFF]);
  } else {
    return nan_max(tree_absmax<K / 2, OFF, N>(a),
                   tree_absmax<K - K / 2, OFF + K / 2, N>(a));
  }
}

// mean over a history, in the ladder order (a power-of-two CW is one tree)
template <int N>
__device__ __forceinline__ float hist_mean(const float (&a)[N]) {
  return ladder_sum<N, false>(a) / (float)N;
}

// Shared memory of one fleet CTA, in floats: the window rows, then one
// region that first holds the histories (staging in and out) and, between
// those, the [step][queue] tile block.
template <int W, int CW>
__host__ __device__ constexpr int fleet_smem_floats() {
  constexpr int hist = THREADS * (2 * row_stride<float>(CW) + row_stride<float>(2));
  constexpr int tile = TC * (THREADS + 1);
  return THREADS * row_stride<float>(W) + (hist > tile ? hist : tile);
}

template <int W, int CW, int R, bool FULL, bool TIME_MAJOR>
__global__ void __launch_bounds__(THREADS)
monitor_fleet_kernel(const float* __restrict__ comp, long long ld,
                     const int* __restrict__ m_ptr, int Q, int T,
                     float* __restrict__ win, int* __restrict__ s_fill_p,
                     float* __restrict__ count_p, float* __restrict__ mean_p,
                     float* __restrict__ m2_p, float* __restrict__ qhist_p,
                     float* __restrict__ shist_p, float* __restrict__ rhist_p,
                     int* __restrict__ epoch_p, float* __restrict__ last_p,
                     float* __restrict__ q_out, float* __restrict__ qbar_out,
                     float* __restrict__ sig_out, bool* __restrict__ conv_out,
                     float* __restrict__ est_out, int* __restrict__ ep_out,
                     FleetParams P) {
  constexpr int NT = 2 * R + 1;   // stencil taps
  constexpr int N = W - 2 * R;    // filtered values per window
  constexpr int WS = row_stride<float>(W), CS = row_stride<float>(CW);
  constexpr int SS = row_stride<float>(2), CP = THREADS + 1;
  extern __shared__ float smem[];
  float* s_win = smem;
  float* s_qh = smem + THREADS * WS;   // histories, staged in and out ...
  float* s_rh = s_qh + THREADS * CS;
  float* s_sh = s_rh + THREADS * CS;
  float* s_c = s_qh;                   // ... and the tile block in between

  const int r = threadIdx.x;
  const int q0 = blockIdx.x * THREADS;
  const int rows = min(THREADS, Q - q0);
  const int q = q0 + r;
  const bool live = r < rows;
  const int mq = live ? m_ptr[q] : 0;
  // no valid sample in state mode: the state is unchanged
  const bool run = live && (FULL || mq > 0);

  stage_rows<float, W>(win + (long long)q0 * W, rows * W, s_win, W, WS);
  stage_rows<float, CW>(qhist_p + (long long)q0 * CW, rows * CW, s_qh, CW, CS);
  stage_rows<float, CW>(rhist_p + (long long)q0 * CW, rows * CW, s_rh, CW, CS);
  stage_rows<float, 2>(shist_p + (long long)q0 * 2, rows * 2, s_sh, 2, SS);
  __syncthreads();
  float qh[CW], rh[CW];
#pragma unroll
  for (int i = 0; i < CW; ++i) {
    qh[i] = s_qh[r * CS + i];
    rh[i] = s_rh[r * CS + i];
  }
  float sh0 = s_sh[r * SS], sh1 = s_sh[r * SS + 1];
  __syncthreads();                     // the region now takes the tile

  float* wrow = s_win + r * WS;
  float g[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) g[i] = P.gauss.v[i];
  const int L = W + T - 2 * R;
  const int n_tiles = (T + TC - 1) / TC;

  // ---- pass 1: centring constant c = mean of all L filtered values of
  // [win | comp] (the zero tail past m included, as in ref.py) ----------
  double csum = 0.0;
  float e[NT];
  if (run) {
#pragma unroll
    for (int i = 0; i < NT - 1; ++i) e[i] = wrow[i];
#pragma unroll
    for (int j = 0; j < W - 2 * R; ++j) {      // windows inside win
      e[NT - 1] = wrow[j + 2 * R];
      float cv = e[0] * g[0];
#pragma unroll
      for (int i = 1; i < NT; ++i) cv = cv + e[i] * g[i];
      csum += (double)cv;
#pragma unroll
      for (int i = 0; i < NT - 1; ++i) e[i] = e[i + 1];
    }
  }
  for (int k = 0; k < n_tiles; ++k) {          // windows reaching comp
    const int t0 = k * TC, tc = min(TC, T - t0);
    stage_tile<TIME_MAJOR>(comp, ld, q0, rows, t0, tc, s_c);
    if (run) {
      for (int tt = 0; tt < tc; ++tt) {
        e[NT - 1] = s_c[tt * CP + r];
        float cv = e[0] * g[0];
#pragma unroll
        for (int i = 1; i < NT; ++i) cv = cv + e[i] * g[i];
        csum += (double)cv;
#pragma unroll
        for (int i = 0; i < NT - 1; ++i) e[i] = e[i + 1];
      }
    }
    if (n_tiles > 1) __syncthreads();          // before the next block
  }
  const float c = (float)(csum / (double)L);

  // ---- pass 2: Stage A + Stage B, one compacted sample per step -------
  // d[0..N-2] hold centred filtered values 1..N-1 of the carried window;
  // step t appends value t+N, whose stencil ends at comp[t].
  float d[N];
  int s_fill = 0, epoch = 0;
  float count = 0.0f, mean = 0.0f, m2 = 0.0f, last = 0.0f;
  if (run) {
#pragma unroll
    for (int j = 1; j < N; ++j) {
      float cv = wrow[j] * g[0];
#pragma unroll
      for (int i = 1; i < NT; ++i) cv = cv + wrow[j + i] * g[i];
      d[j - 1] = cv - c;
    }
#pragma unroll
    for (int i = 0; i < NT - 1; ++i) e[i] = wrow[W - 2 * R + i];
    // new window = [win | comp][m : m + W]: the carried part moves down
    // here (ascending, reading index i + m >= i), the samples from comp
    // land behind it in the step loop
    for (int i = 0; i + mq < W; ++i) wrow[i] = wrow[i + mq];
    s_fill = s_fill_p[q];
    count = count_p[q];
    mean = mean_p[q];
    m2 = m2_p[q];
    epoch = epoch_p[q];
    last = last_p[q];
  }

  const float nf = (float)N;
  const int t_end = run ? (FULL ? T : mq) : 0;
  for (int k = 0; k < n_tiles; ++k) {
    const int t0 = k * TC, tc = min(TC, T - t0);
    if (n_tiles > 1) stage_tile<TIME_MAJOR>(comp, ld, q0, rows, t0, tc, s_c);
    for (int tt = 0; tt < tc && t0 + tt < t_end; ++tt) {
      const int t = t0 + tt;
      const bool valid = !FULL || t < mq;   // state mode stops at m
      float q_t = 0.0f;
      if (valid) {
        const float x = s_c[tt * CP + r];
        if (t >= mq - W) wrow[t - mq + W] = x;
        e[NT - 1] = x;
        float cv = e[0] * g[0];
#pragma unroll
        for (int i = 1; i < NT; ++i) cv = cv + e[i] * g[i];
        d[N - 1] = cv - c;
        const float s1 = ladder_sum<N, false>(d);
        const float s2 = ladder_sum<N, true>(d);
        const float mu = s1 / nf;
        const float var = s2 / nf - mu * mu;
        const float sd = sqrtf(nan_max(0.0f, var));
        q_t = (mu + c) + P.z * sd;
#pragma unroll
        for (int i = 0; i < N - 1; ++i) d[i] = d[i + 1];
#pragma unroll
        for (int i = 0; i < NT - 1; ++i) e[i] = e[i + 1];
      }

      s_fill = min(s_fill + (valid ? 1 : 0), W);
      const bool ready = valid && s_fill >= W;

      if (ready) {  // Welford fold, op order of stats.welford_update
        const float cnt1 = count + 1.0f;
        const float delta = q_t - mean;
        const float mean1 = mean + delta / cnt1;
        const float m21 = m2 + delta * (q_t - mean1);
        count = cnt1;
        mean = mean1;
        m2 = m21;
#pragma unroll
        for (int i = 0; i < CW - 1; ++i) qh[i] = qh[i + 1];
        qh[CW - 1] = mean;
      }
      const float qbar = mean;

      float sig;
      if (P.window_std) {
        const float muq = hist_mean<CW>(qh);
        float dq[CW];
#pragma unroll
        for (int i = 0; i < CW; ++i) dq[i] = (qh[i] - muq) * (qh[i] - muq);
        const float s = sqrtf(hist_mean<CW>(dq));
        sig = count >= (float)CW ? s : P.big;
      } else {
        const float safe = count > 0.0f ? count : 1.0f;
        const float var = count > 0.0f ? m2 / safe : 0.0f;
        sig = sqrtf(nan_max(0.0f, var / safe));
      }

      const float resp_new = (P.log0 * sh0 + P.log1 * sh1) + P.log2 * sig;
      if (ready && count >= 3.0f) {
#pragma unroll
        for (int i = 0; i < CW - 1; ++i) rh[i] = rh[i + 1];
        rh[CW - 1] = resp_new;
      }
      if (ready) {
        sh0 = sh1;
        sh1 = sig;
      }

      const float resp = tree_absmax<CW, 0, CW>(rh);
      const bool trace_ready = count >= P.trace_min;
      const float tol = P.rel_tol ? P.conv_tol * nan_max(P.tiny, fabsf(qbar))
                                  : P.conv_tol;
      const bool conv = ready && trace_ready && isfinite(resp) && resp < tol;

      if (conv) {  // emit + resetStats()
        last = qbar;
        epoch += 1;
        count = 0.0f;
        mean = 0.0f;
        m2 = 0.0f;
      }
      if (FULL) {
        const long long o = (long long)q * T + t;
        q_out[o] = ready ? q_t : 0.0f;
        qbar_out[o] = qbar;
        sig_out[o] = sig;
        conv_out[o] = conv;
        est_out[o] = last;
        ep_out[o] = epoch;
      }
    }
    if (n_tiles > 1) __syncthreads();          // before the next block
  }

  // ---- state write-back, in place ----------------------------------------
  __syncthreads();                     // the tile block is done with
#pragma unroll
  for (int i = 0; i < CW; ++i) {
    s_qh[r * CS + i] = qh[i];
    s_rh[r * CS + i] = rh[i];
  }
  s_sh[r * SS] = sh0;
  s_sh[r * SS + 1] = sh1;
  __syncthreads();
  unstage_rows<float, W>(win + (long long)q0 * W, rows * W, s_win, W, WS);
  unstage_rows<float, CW>(qhist_p + (long long)q0 * CW, rows * CW, s_qh, CW, CS);
  unstage_rows<float, CW>(rhist_p + (long long)q0 * CW, rows * CW, s_rh, CW, CS);
  unstage_rows<float, 2>(shist_p + (long long)q0 * 2, rows * 2, s_sh, 2, SS);
  if (run) {
    s_fill_p[q] = s_fill;
    count_p[q] = count;
    mean_p[q] = mean;
    m2_p[q] = m2;
    epoch_p[q] = epoch;
    last_p[q] = last;
  }
}

template <typename Tin>
__device__ __forceinline__ float to_f32(Tin x);

template <>
__device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// WC, NTAPS > 0: compile-time window and tap count, the filtered values in
// registers.  WC = NTAPS = 0: runtime w and ntaps, recomputed from shared
// memory in the second pass.  blockDim.x rows a CTA.
template <typename Tin, int WC, int NTAPS>
__global__ void __launch_bounds__(THREADS)
batched_monitor_kernel(const Tin* __restrict__ win, int Q, int W, Taps taps,
                       int ntaps, float z, float* __restrict__ q_out,
                       float* __restrict__ mu_out, float* __restrict__ sd_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tin* s = reinterpret_cast<Tin*>(smem_raw);
  const int w = WC ? WC : W;
  const int stride = row_stride<Tin>(w);
  const long long r0 = (long long)blockIdx.x * blockDim.x;
  const int rows = (int)min((long long)blockDim.x, (long long)Q - r0);
  stage_rows<Tin, WC>(win + r0 * w, rows * w, s, w, stride);
  __syncthreads();
  const int r = threadIdx.x;
  if (r >= rows) return;
  const Tin* x = s + r * stride;

  float mu, ss;
  if constexpr (WC > 0) {
    constexpr int NO = WC - NTAPS + 1;
    float a[NO], e[NTAPS], t[NTAPS];
#pragma unroll
    for (int i = 0; i < NTAPS; ++i) t[i] = taps.v[i];
#pragma unroll
    for (int i = 0; i < NTAPS - 1; ++i) e[i] = to_f32(x[i]);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      e[NTAPS - 1] = to_f32(x[j + NTAPS - 1]);
      float v = e[0] * t[0];
#pragma unroll
      for (int i = 1; i < NTAPS; ++i) v = v + e[i] * t[i];
      a[j] = v;
      sum += v;
#pragma unroll
      for (int i = 0; i < NTAPS - 1; ++i) e[i] = e[i + 1];
    }
    mu = sum / (float)NO;
    ss = 0.0f;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const float dv = a[j] - mu;
      ss += dv * dv;
    }
    ss = ss / (float)NO;
  } else {
    const int n_out = w - (ntaps - 1);
    float sum = 0.0f;
    for (int j = 0; j < n_out; ++j) {
      float a = to_f32(x[j]) * taps.v[0];
      for (int i = 1; i < ntaps; ++i) a = a + to_f32(x[j + i]) * taps.v[i];
      sum += a;
    }
    mu = sum / (float)n_out;
    ss = 0.0f;
    for (int j = 0; j < n_out; ++j) {
      float a = to_f32(x[j]) * taps.v[0];
      for (int i = 1; i < ntaps; ++i) a = a + to_f32(x[j + i]) * taps.v[i];
      const float dv = a - mu;
      ss += dv * dv;
    }
    ss = ss / (float)n_out;
  }
  const float sd = sqrtf(ss);
  const long long o = r0 + r;
  q_out[o] = mu + z * sd;
  mu_out[o] = mu;
  sd_out[o] = sd;
}

// Opts a kernel in to more than the default 48 KB of dynamic shared
// memory when it needs it.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= SMEM_DEFAULT) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename Tin, int WC, int NTAPS>
int launch_batched(const Tin* win, int Q, int W, const Taps& t, int ntaps,
                   float z, float* q_out, float* mu_out, float* sd_out,
                   cudaStream_t s) {
  const size_t row_bytes = (size_t)row_stride<Tin>(W) * sizeof(Tin);
  int rows = THREADS;
  if (WC == 0) {             // wide rows: fewer a CTA, whole warps first
    rows = (int)(ROWS_CAP_BYTES / row_bytes);
    if (rows > THREADS) rows = THREADS;
    if (rows >= 32) rows -= rows % 32;
    if (rows < 1) rows = 1;
  }
  const size_t bytes = (size_t)rows * row_bytes;
  if (bytes > SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto kernel = batched_monitor_kernel<Tin, WC, NTAPS>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Q + rows - 1) / rows)), block(rows);
  kernel<<<grid, block, bytes, s>>>(win, Q, W, t, ntaps, z, q_out, mu_out,
                                    sd_out);
  return (int)cudaGetLastError();
}

template <typename Tin>
int dispatch_batched(const Tin* win, int Q, int W, const Taps& t, int ntaps,
                     float z, float* q_out, float* mu_out, float* sd_out,
                     cudaStream_t s) {
  if (ntaps == 5) {
    if (W == 32)
      return launch_batched<Tin, 32, 5>(win, Q, W, t, ntaps, z, q_out,
                                        mu_out, sd_out, s);
    if (W == 16)
      return launch_batched<Tin, 16, 5>(win, Q, W, t, ntaps, z, q_out,
                                        mu_out, sd_out, s);
    if (W == 64)
      return launch_batched<Tin, 64, 5>(win, Q, W, t, ntaps, z, q_out,
                                        mu_out, sd_out, s);
  }
  return launch_batched<Tin, 0, 0>(win, Q, W, t, ntaps, z, q_out, mu_out,
                                   sd_out, s);
}

}  // namespace

// (W, CW, R) shapes the fleet kernel is instantiated for; MonitorConfig()
// and paper_faithful() are (32, 16, 2).
#define FLEET_SHAPES(X) \
  X(32, 16, 2)          \
  X(16, 16, 2)          \
  X(64, 16, 2)          \
  X(32, 8, 2)           \
  X(32, 32, 2)          \
  X(32, 16, 1)          \
  X(32, 16, 3)

extern "C" int repro_monitor_fleet_supported(int W, int CW, int R) {
#define SUPPORTED(w, cw, r) \
  if (W == w && CW == cw && R == r) return 1;
  FLEET_SHAPES(SUPPORTED)
#undef SUPPORTED
  return 0;
}

// Shared memory of one fleet CTA at (W, CW), in bytes; 0 if the shape is
// not instantiated.
extern "C" int repro_monitor_fleet_smem(int W, int CW, int R) {
#define SMEM(w, cw, r) \
  if (W == w && CW == cw && R == r) return (int)(fleet_smem_floats<w, cw>() * sizeof(float));
  FLEET_SHAPES(SMEM)
#undef SMEM
  return 0;
}

template <int W, int CW, int R, bool FULL, bool TM>
static int launch_fleet(const void* comp, long long ld, const void* m, int Q,
                        int T, void* win, void* s_fill, void* count,
                        void* mean, void* m2, void* qhist, void* shist,
                        void* rhist, void* epoch, void* last_qbar,
                        void* q_out, void* qbar_out, void* sig_out,
                        void* conv_out, void* est_out, void* ep_out,
                        const FleetParams& P, cudaStream_t s) {
  const size_t bytes = fleet_smem_floats<W, CW>() * sizeof(float);
  auto kernel = monitor_fleet_kernel<W, CW, R, FULL, TM>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Q + THREADS - 1) / THREADS), block(THREADS);
  kernel<<<grid, block, bytes, s>>>(
      (const float*)comp, ld, (const int*)m, Q, T, (float*)win, (int*)s_fill,
      (float*)count, (float*)mean, (float*)m2, (float*)qhist, (float*)shist,
      (float*)rhist, (int*)epoch, (float*)last_qbar, (float*)q_out,
      (float*)qbar_out, (float*)sig_out, (bool*)conv_out, (float*)est_out,
      (int*)ep_out, P);
  return (int)cudaGetLastError();
}

// Launches the fused scan.  comp is the (Q, T) tile: comp[q * ld + t]
// (row-major, time_major == 0) or comp[t * ld + q] (time_major != 0).
// Host-side parameter arrays (gauss_taps: 2R+1, log_taps: 3) are copied
// into the kernel's by-value parameters.  The six output planes are
// written when full != 0 and may be null otherwise.  Returns
// cudaErrorInvalidValue for a shape that is not instantiated.
extern "C" int repro_monitor_fleet(
    const void* comp, long long ld, int time_major, const void* m, int Q,
    int T, void* win, void* s_fill, void* count, void* mean, void* m2,
    void* qhist, void* shist, void* rhist, void* epoch, void* last_qbar,
    void* q_out, void* qbar_out, void* sig_out, void* conv_out, void* est_out,
    void* ep_out, int full, int W, int CW, int R, const float* gauss_taps,
    const float* log_taps, float z, float conv_tol, float trace_min,
    int rel_tol, int window_std, void* stream) {
  if (Q <= 0) return (int)cudaSuccess;
  if (2 * R + 1 > MAX_TAPS) return (int)cudaErrorInvalidValue;
  FleetParams P;
  for (int i = 0; i < MAX_TAPS; ++i) P.gauss.v[i] = i < 2 * R + 1 ? gauss_taps[i] : 0.0f;
  P.log0 = log_taps[0];
  P.log1 = log_taps[1];
  P.log2 = log_taps[2];
  P.z = z;
  P.conv_tol = conv_tol;
  P.trace_min = trace_min;
  P.tiny = 1e-12f;
  P.big = 1e30f;
  P.rel_tol = rel_tol;
  P.window_std = window_std;
  cudaStream_t s = (cudaStream_t)stream;
#define ARGS                                                                 \
  comp, ld, m, Q, T, win, s_fill, count, mean, m2, qhist, shist, rhist,      \
      epoch, last_qbar, q_out, qbar_out, sig_out, conv_out, est_out, ep_out, \
      P, s
#define LAUNCH(w, cw, r)                                                     \
  if (W == w && CW == cw && R == r) {                                        \
    if (full)                                                                \
      return time_major ? launch_fleet<w, cw, r, true, true>(ARGS)           \
                        : launch_fleet<w, cw, r, true, false>(ARGS);         \
    return time_major ? launch_fleet<w, cw, r, false, true>(ARGS)            \
                      : launch_fleet<w, cw, r, false, false>(ARGS);          \
  }
  FLEET_SHAPES(LAUNCH)
#undef LAUNCH
#undef ARGS
  return (int)cudaErrorInvalidValue;
}

// Launches the per-tick window stage over (Q, W) rows of f32 (is_bf16 == 0)
// or bf16 (is_bf16 != 0) input.  Returns cudaErrorInvalidValue for a
// row too wide for one CTA's shared memory.
extern "C" int repro_batched_monitor(const void* win, int is_bf16, int Q,
                                     int W, const float* taps, int ntaps,
                                     float z, void* q_out, void* mu_out,
                                     void* sd_out, void* stream) {
  if (Q <= 0) return (int)cudaSuccess;
  if (ntaps < 1 || ntaps > MAX_TAPS || W < ntaps) return (int)cudaErrorInvalidValue;
  Taps t;
  for (int i = 0; i < MAX_TAPS; ++i) t.v[i] = i < ntaps ? taps[i] : 0.0f;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return dispatch_batched<__nv_bfloat16>(
        (const __nv_bfloat16*)win, Q, W, t, ntaps, z, (float*)q_out,
        (float*)mu_out, (float*)sd_out, s);
  return dispatch_batched<float>((const float*)win, Q, W, t, ntaps, z,
                                 (float*)q_out, (float*)mu_out,
                                 (float*)sd_out, s);
}

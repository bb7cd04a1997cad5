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
// ---------------------------------------------------------------------------
// monitor_fleet_kernel
//   Replaces the TPU kernel src/repro/kernels/monitor/kernel.py ::
//   monitor_fleet_kernel (launched by monitor_fleet_pallas): the fused,
//   time-batched Algorithm 1 over a compacted (Q, T) tile.  Stage A is the
//   Gaussian stencil plus the sliding mean/std of ref.py::fleet_window_stage,
//   Stage B the sequential fold of ref.py::fleet_step.
//
//   Design: one thread per queue; the TPU kernel's sequential time loop is
//   a loop inside the thread.  The window stencil taps, the n = W - 2R
//   centred filtered values of the current window, the q-bar and response
//   histories and every scalar of the state stay in registers for the whole
//   tile (all array indices are compile-time constants: W, CW and R are
//   template parameters).  State is read once and written once per tile,
//   in place; the six (Q, T) output planes are stored only in full mode.
//   A queue stops at its compacted count m in state mode: the steps past
//   m change nothing.
//
//   Bound on the card: memory.  Per state-mode dispatch it must read the
//   f32 tile (4*Q*T bytes) and m, and read and write the state
//   (4*(W + 2*CW + 8) bytes per queue); it does O(T*(W + CW)) flops per
//   queue, far below the f32 rate.  At Q = 2e5 queues, T = 256 that is
//   ~0.2 GB, ~0.06 ms at 3.35 TB/s (the caller's compaction of the raw
//   (tc, blocked) tile into this one is separate PyTorch work).
//   What holds this design back: thread q reads row q of a row-major
//   (Q, T) tile, so neighbouring threads load addresses 4*T bytes apart
//   (uncoalesced; each 128-byte line serves one thread for 32 steps and
//   lives or dies in L1), and the centring constant needs a first pass
//   over the row, so the tile is read twice.  Reading the time-major
//   (T, Q) staging directly (coalesced, one pass through shared memory)
//   is the next step.
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
//   Design: one thread per row, f32 or bf16 input (converted with
//   __bfloat162float), f32 outputs; the stencil is recomputed in the second
//   pass instead of kept, so any w works without local memory.
//   Bound on the card: memory (read Q*w inputs, write 3*Q floats; ~w*12
//   flops per row).  Same uncoalesced row-per-thread reads as above.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#define MAX_TAPS 9
#define THREADS 128

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

// mean over a history, in the ladder order (a power-of-two CW is one tree)
template <int N>
__device__ __forceinline__ float hist_mean(const float (&a)[N]) {
  return ladder_sum<N, false>(a) / (float)N;
}

template <int W, int CW, int R, bool FULL>
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
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;

  const float* row = comp + (long long)q * ld;
  float* wrow = win + (long long)q * W;
  const int mq = m_ptr[q];
  if (!FULL && mq == 0) return;   // no valid sample: the state is unchanged
  const int L = W + T - 2 * R;

  float g[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) g[i] = P.gauss.v[i];

  // ---- pass 1: centring constant c = mean of all L filtered values of
  // [win | comp] (the zero tail past m included, as in ref.py) ----------
  double csum = 0.0;
  {
    float e[NT];
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
    for (int j = W - 2 * R; j < L; ++j) {      // windows reaching comp
      e[NT - 1] = row[j + 2 * R - W];
      float cv = e[0] * g[0];
#pragma unroll
      for (int i = 1; i < NT; ++i) cv = cv + e[i] * g[i];
      csum += (double)cv;
#pragma unroll
      for (int i = 0; i < NT - 1; ++i) e[i] = e[i + 1];
    }
  }
  const float c = (float)(csum / (double)L);

  // ---- pass 2: Stage A + Stage B, one compacted sample per step -------
  // d[0..N-2] hold centred filtered values 1..N-1 of the carried window;
  // step t appends value t+N, whose stencil ends at comp[t].
  float d[N];
  float e[NT];
#pragma unroll
  for (int j = 1; j < N; ++j) {
    float cv = wrow[j] * g[0];
#pragma unroll
    for (int i = 1; i < NT; ++i) cv = cv + wrow[j + i] * g[i];
    d[j - 1] = cv - c;
  }
#pragma unroll
  for (int i = 0; i < NT - 1; ++i) e[i] = wrow[W - 2 * R + i];

  int s_fill = s_fill_p[q];
  float count = count_p[q], mean = mean_p[q], m2 = m2_p[q];
  float qh[CW], rh[CW];
#pragma unroll
  for (int i = 0; i < CW; ++i) {
    qh[i] = qhist_p[(long long)q * CW + i];
    rh[i] = rhist_p[(long long)q * CW + i];
  }
  float sh0 = shist_p[(long long)q * 2], sh1 = shist_p[(long long)q * 2 + 1];
  int epoch = epoch_p[q];
  float last = last_p[q];

  const float nf = (float)N;
  const int t_end = FULL ? T : mq;
  for (int t = 0; t < t_end; ++t) {
    const bool valid = t < mq;
    float q_t = 0.0f;
    if (valid) {
      e[NT - 1] = row[t];
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

    float resp = fabsf(rh[0]);
#pragma unroll
    for (int i = 1; i < CW; ++i) resp = nan_max(resp, fabsf(rh[i]));
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

  // ---- state write-back, in place --------------------------------------
  // new window = [win | comp][m : m + W]; ascending order reads index
  // i + m >= i, so no entry is overwritten before it is read
  for (int i = 0; i < W; ++i) {
    const int k = i + mq;
    wrow[i] = k < W ? wrow[k] : row[k - W];
  }
  s_fill_p[q] = s_fill;
  count_p[q] = count;
  mean_p[q] = mean;
  m2_p[q] = m2;
#pragma unroll
  for (int i = 0; i < CW; ++i) {
    qhist_p[(long long)q * CW + i] = qh[i];
    rhist_p[(long long)q * CW + i] = rh[i];
  }
  shist_p[(long long)q * 2] = sh0;
  shist_p[(long long)q * 2 + 1] = sh1;
  epoch_p[q] = epoch;
  last_p[q] = last;
}

template <typename Tin>
__device__ __forceinline__ float load_f32(const Tin* p);

template <>
__device__ __forceinline__ float load_f32<float>(const float* p) {
  return *p;
}

template <>
__device__ __forceinline__ float load_f32<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename Tin>
__global__ void __launch_bounds__(THREADS)
batched_monitor_kernel(const Tin* __restrict__ win, int Q, int W, Taps taps,
                       int ntaps, float z, float* __restrict__ q_out,
                       float* __restrict__ mu_out, float* __restrict__ sd_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= Q) return;
  const Tin* x = win + (long long)r * W;
  const int n_out = W - (ntaps - 1);
  float sum = 0.0f;
  for (int j = 0; j < n_out; ++j) {
    float a = load_f32(x + j) * taps.v[0];
    for (int i = 1; i < ntaps; ++i) a = a + load_f32(x + j + i) * taps.v[i];
    sum += a;
  }
  const float mu = sum / (float)n_out;
  float ss = 0.0f;
  for (int j = 0; j < n_out; ++j) {
    float a = load_f32(x + j) * taps.v[0];
    for (int i = 1; i < ntaps; ++i) a = a + load_f32(x + j + i) * taps.v[i];
    const float dv = a - mu;
    ss += dv * dv;
  }
  const float sd = sqrtf(ss / (float)n_out);
  q_out[r] = mu + z * sd;
  mu_out[r] = mu;
  sd_out[r] = sd;
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

// Launches the fused scan.  Host-side parameter arrays (gauss_taps: 2R+1,
// log_taps: 3) are copied into the kernel's by-value parameters.  The six
// output planes are written when full != 0 and may be null otherwise.
// Returns cudaErrorInvalidValue for a shape that is not instantiated.
extern "C" int repro_monitor_fleet(
    const void* comp, long long ld, const void* m, int Q, int T,
    void* win, void* s_fill, void* count, void* mean, void* m2, void* qhist,
    void* shist, void* rhist, void* epoch, void* last_qbar,
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
  const dim3 grid((Q + THREADS - 1) / THREADS), block(THREADS);
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(w, cw, r)                                                      \
  if (W == w && CW == cw && R == r) {                                         \
    if (full)                                                                 \
      monitor_fleet_kernel<w, cw, r, true><<<grid, block, 0, s>>>(            \
          (const float*)comp, ld, (const int*)m, Q, T, (float*)win,           \
          (int*)s_fill, (float*)count, (float*)mean, (float*)m2,              \
          (float*)qhist, (float*)shist, (float*)rhist, (int*)epoch,           \
          (float*)last_qbar, (float*)q_out, (float*)qbar_out,                 \
          (float*)sig_out, (bool*)conv_out, (float*)est_out, (int*)ep_out,    \
          P);                                                                 \
    else                                                                      \
      monitor_fleet_kernel<w, cw, r, false><<<grid, block, 0, s>>>(           \
          (const float*)comp, ld, (const int*)m, Q, T, (float*)win,           \
          (int*)s_fill, (float*)count, (float*)mean, (float*)m2,              \
          (float*)qhist, (float*)shist, (float*)rhist, (int*)epoch,           \
          (float*)last_qbar, nullptr, nullptr, nullptr, nullptr, nullptr,     \
          nullptr, P);                                                        \
    return (int)cudaGetLastError();                                           \
  }
  FLEET_SHAPES(LAUNCH)
#undef LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Launches the per-tick window stage over (Q, W) rows of f32 (is_bf16 == 0)
// or bf16 (is_bf16 != 0) input.
extern "C" int repro_batched_monitor(const void* win, int is_bf16, int Q,
                                     int W, const float* taps, int ntaps,
                                     float z, void* q_out, void* mu_out,
                                     void* sd_out, void* stream) {
  if (Q <= 0) return (int)cudaSuccess;
  if (ntaps < 1 || ntaps > MAX_TAPS || W < ntaps) return (int)cudaErrorInvalidValue;
  Taps t;
  for (int i = 0; i < MAX_TAPS; ++i) t.v[i] = i < ntaps ? taps[i] : 0.0f;
  const dim3 grid((Q + THREADS - 1) / THREADS), block(THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    batched_monitor_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)win, Q, W, t, ntaps, z, (float*)q_out,
        (float*)mu_out, (float*)sd_out);
  else
    batched_monitor_kernel<float><<<grid, block, 0, s>>>(
        (const float*)win, Q, W, t, ntaps, z, (float*)q_out, (float*)mu_out,
        (float*)sd_out);
  return (int)cudaGetLastError();
}

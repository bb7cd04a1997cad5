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
// sum_t 2^(log2(e) s'_t)), it gives dq, dk and dv in float32:
//
//   s' = scale Q.K^T, or cap tanh(scale Q.K^T / cap) with a softcap
//   P  = 2^(log2(e) s' - lse)              (recomputed, never stored)
//   D  = rowsum(dO o)                      dP = dO.V^T
//   dS = P (dP - D) (1 - t^2)              dV = sum_g P^T.dO
//   dQ = scale dS.K                        dK = scale sum_g dS^T.Q
//
// with t = tanh(scale Q.K^T / cap) (t = 0 without a softcap), query head
// h on kv head h / (H/K), causal aligned at the first position or not, a
// sliding window (keys t <= q - window masked, as the forward masks
// them), any S and T, hd 16, 32, 64, 112, 128 or 256.  The wrapper
// refuses a window that leaves a row with no key (S >= T + window), as
// the forward's does.
//
// What bounds it on the card: at the training path's shape (B 2, S = T
// 4096, H 16, K 8, hd 128, bf16, causal) the five products over the
// unmasked pairs are 343.7 GFLOP against ~0.34 GB of traffic, so the
// tensor cores bound it (bf16, 989 TFLOP/s): 0.3475 ms.
//
// bf16 inputs: three kernels on the tensor cores, in the manner of
// FlashAttention-3.  It replaces a first design (mma.sync.m16n8k16 fed by
// ldmatrix, each warp re-reading the streamed tiles from shared memory for
// its 16 rows, cp.async copies addressed by every thread, a grid of one CTA
// per block with the causal tail on a few SMs: 198 TFLOP/s of its own
// products, 3.0x SDPA's backward).
//
// (p) flash_bwd_prep_kernel: D = rowsum(dO o) in float32 and dO rounded
//     to bf16, so that the main kernels can load bf16 dO by TMA; lse and
//     D copied into rows padded to a multiple of ROW_PAD, rows past S
//     holding lse = +inf and D = 0, so that a 64-row block of both is one
//     TMA box of a 3-d map.  A row takes L lanes, L the largest power of
//     two that divides hd / 4, at most 32 (4 at hd 112, 32 at hd 128 and
//     256): L divides the warp, so a row never straddles two warps, and
//     the butterfly over its lanes never reaches the next row.  Each lane
//     sums its float4 chunks p, p + L, ... in order before the butterfly,
//     a fixed order: two calls give equal bits.
// Both main kernels run NWG = 2 consumer warpgroups a CTA and a producer
// warpgroup whose one working thread keeps a ring of TMA loads full
// (mbarriers: full and empty per stage, full and empty for the resident
// tiles).  384 threads a CTA get 168 registers a thread; the producer
// gives its registers to the consumers (setmaxnreg: it keeps 24, each
// consumer gets 240), which hold two 64 x 128 float32 accumulators at
// most.  Below: the design up to hd 128 without a cap or a window; the
// split one (hd 256, and (a) with CW at hd 112 and 128) after it.
// (a) flash_bwd_dkdv_wgmma_kernel: a CTA owns 128 keys of one kv head at
//     a time, 64 a consumer warpgroup, with K and V resident in shared
//     memory, and walks the (query head of the group, q block) steps,
//     query heads outermost in a fixed order; the producer TMA-loads Q,
//     bf16 dO and the rows' lse and D of each step into a ring of
//     DKDV_STAGES stages.  Per step and warpgroup:
//       S^T  = K.Q^T, dP^T = V.dO^T   wgmma m64n64k16, both operands
//                                     K-major in shared memory
//       P^T, dS^T                     in registers on the accumulator
//                                     layout, which is the A fragment of
//       dV += P^T.dO, dK += dS^T.Q    wgmma m64n{hd}k16, A from registers,
//                                     B (dO, Q) MN-major in shared memory
//     in the order S^T; P^T; dV and dP^T together; dS^T; dK, left in
//     flight while the next step's S^T runs.  dP^T is issued after P^T is
//     made, not beside S^T: with its accumulators live during the
//     exponentials a consumer would spill at hd 128.
// (b) flash_bwd_dq_wgmma_kernel: a CTA owns 128 query rows of one head, 64
//     a consumer warpgroup, Q and bf16 dO resident, and streams the K and
//     V blocks of its rows' keys through a ring of DQ_STAGES stages: S =
//     Q.K^T and dP = dO.V^T (m64n64k16, shared memory), dQ += dS.K (A
//     from registers, K MN-major), the dQ product left in flight while the
//     next step's S and dP run.
// Seven products over whole tiles, not five: both (a) and (b) recompute S
// and dP.  A fused five-product kernel would sum dQ over key blocks from
// several CTAs, which needs float atomics (another sum order every run)
// or a per-q-block semaphore that admits the key blocks in order and
// stalls the CTAs that wait on it; two kernels keep every sum a fixed
// loop inside one CTA, so two calls give equal bits (the checkpoint
// resume's bit-for-bit check depends on it).
//
// Both main kernels are persistent: min(tiles, SMs x CTAs an SM) CTAs
// walk a static list of tiles ordered longest first ((a): key blocks in
// ascending order, whose causal work, the q blocks from the diagonal on
// times G, falls with the key; (b): q blocks in descending order, the
// ragged last one leading), dealt out in a snake (CTA c takes tile c of
// the first round, grid - 1 - c of the second, ...), so the causal tail
// is spread over the card and each CTA's work stays near the mean.
// Which SM takes a tile does not change its result.  Under a window a
// tile's work is capped: (a) walks a key block's q blocks only up to the
// one that holds its last key + window - 1, (b) starts at the key block
// that holds q0 - window + 1 (the forward's first_tile); causal (the
// training paths), both lists stay longest first in the same order (a
// key block's work is constant, then falls; a q block's rises, then is
// constant).
//
// The softcap and the window (CW, a template flag, as in the forward): a
// call with neither runs CW = false, where both are compiled out, with
// the registers and the time of a kernel without them.  With a softcap
// the scores are s' = cap tanh(scale s / cap) in the forward's arithmetic
// (hopper.cuh's softcap_tanh, in the log2 domain: cap log2(e)
// tanh(...)), so that P matches the forward's lse, and dS takes the
// factor 1 - t^2.  Keeping
// t beside the dP^T accumulators would cost 32 registers more in (a), and
// at hd 128 those accumulators are issued late precisely so as not to
// spill; instead (a) packs bf16(P) for the dV product and then overwrites
// P^T's float32 registers with P (1 - t^2) in the same loop, so that dS^T
// = P^T (1 - t^2) (dP^T - D) needs no register more than without a cap;
// (b) needs P only inside dS and keeps P (1 - t^2) from the start.  Keys
// at or before q - window are masked on the tiles that cross the window's
// left edge, as the diagonal and T-tail tiles are.
//
// hd 112 (zamba2's shared attention) runs on the 128-wide geometry, as
// the forward does: the tensor maps keep the tensors' 112 columns, so the
// TMA zero-fills columns 112-127 of Q, K, V and bf16 dO; S^T, dP^T, S and
// dP contract over the 7 k-steps that hold data; the dV, dK and dQ
// products run at n = 128 (their columns 112-127 are zeros); the
// epilogues store 112 columns.
//
// hd 256 (gemma2): two 64 x 256 float32 accumulators a warpgroup would be
// 256 registers a thread, and 128 resident rows with two stages would not
// fit shared memory.  So a CTA owns 64 keys ((a)) or 64 query rows ((b)),
// its two consumer warpgroups split the accumulators' head dims, 128
// columns each, and they split the score products' other operand:
//   (a) warpgroup w computes S^T = K.Q^T and dP^T = V.dO^T only for its
//       32 of the step's 64 queries (m64n32k16 over the 256 head dims, B
//       32 rows into the Q and dO tiles), makes P^T and dS^T of them in
//       registers (the softcap's 1 - t^2, the masks, the lse and D of its
//       columns), and stores bf16(P^T) and bf16(dS^T) into two 64 x 64
//       exchange tiles in shared memory (K-major, 128-byte swizzle,
//       put_pair); after a named barrier over the 256 consumer threads
//       (bar.sync 1; the producer is not in it) it issues dV += P^T.dO
//       and dK += dS^T.Q for its 128 columns (m64n128k16, A from the
//       exchange tiles, B MN-major) and leaves them in flight;
//   (b) warpgroup w computes S = Q.K^T and dP = dO.V^T for its 32 of the
//       step's 64 keys, stores bf16(dS) into a 64 x 64 exchange tile,
//       and after the barrier issues dQ += dS.K for its 128 columns.
// A block's S^T and dP^T (S and dP) are thus computed once, not once a
// warpgroup: in units of one 64 x 64 x 256 product, (a) issues 4 (S^T,
// dP^T, dV, dK) and (b) 3 (S, dP, dQ), 7 in all, where the column split
// alone took 6 and 5; the softcap's tanh and the exponentials run once
// too.  The exchange tiles are double-buffered by live step: a warpgroup
// rewrites buffer u % 2 at live step u once it has passed step u - 1's
// barrier, which the other warpgroup reaches only after waiting for its
// own products of step u - 2, the last to read that buffer; one barrier
// a step suffices.  A consumer holds two 64 x 128 accumulators ((a);
// one in (b)) and two 64 x 32 score blocks.  Shared memory at hd 256: the
// two resident 64-row tiles (64 KiB), two stages of two 64-row tiles
// (128 KiB) with their lse and D, and the exchange tiles ((a) four, 32
// KiB: 231 472 of the 232 448 bytes; (b) two: 215 088), (b) in two
// stages, not DQ_STAGES.  (a) with the cap or the window splits its
// columns the same way from 112 head dims on (GeoA), with two 64 x 64
// accumulators and four exchange tiles.
//
// Rounding: dO, P and dS are rounded to bf16 for their products, as the
// JAX package's bf16 compute rounds them; every sum is float32.  Masks:
// TMA fills rows past S or T with zeros, which would give P = 2^-lse for
// a zero key, so keys past T, rows past S, the causal upper triangle and
// the keys left of the window are masked explicitly on the tiles that
// cross them; rows past S also read the padded lse = +inf, and rows with
// no unmasked key carry lse = +inf from the forward, so they give P = 0,
// never NaN.
//
// float32 inputs: the CUDA cores in float32 FMAs (67 TFLOP/s peak), which
// hold the float32 gate; two kernels, (b) then (a), one CTA per block of
// BR rows (64, or 32 at hd 256, where four 64-row tiles of 257 floats a
// row would not fit shared memory), 256 threads, every tile in shared
// memory with odd row strides, each thread owning (BR/16) x (BR/16) of a
// BR x BR product and BR/16 x hd/16 of a BR x hd one.  The softcap and
// the window as in the bf16 kernels (CW; the factor 1 - t^2 on dS).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"  // mbarriers, TMA, wgmma (shared with the forward)

namespace {

constexpr int BM = 64;  // rows of a q block and of a key block
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// scores -> log2 domain with a softcap: cap log2(e) tanh(scale s / cap)
// (cap_in = scale / cap, cap_out = cap log2(e)); cap_out = 0 means none
// (then s scale log2(e))
struct Scaling {
  float cap_in, cap_out;
};

// log2(e) s' - m for a raw score s: with a softcap t = tanh(scale s /
// cap) (the forward's: softcap_tanh in the bf16 kernels, TC, the accurate
// tanhf in the float32 ones), else t = 0 and s scale log2(e) (sl2 = scale
// log2(e)) in the same fmaf as without CW
template <bool CW, bool TC = false>
__device__ __forceinline__ float score2(float s, float m, float sl2,
                                        const Scaling& sg, float& t) {
  if (CW && sg.cap_out != 0.f) {
    t = TC ? hopper::softcap_tanh(s * sg.cap_in) : tanhf(s * sg.cap_in);
    return fmaf(sg.cap_out, t, -m);
  }
  t = 0.f;
  return fmaf(s, sl2, -m);
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA (see the note at the top)

namespace tc {

using namespace hopper;

// consumer warpgroups a CTA, the producer's and each consumer's registers
// after setmaxnreg, the stages of (a)'s and (b)'s rings (see the note)
constexpr int NWG = 2;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int DKDV_STAGES = 2;
constexpr int DQ_STAGES = 3;
constexpr int ROW_PAD = 128;  // lse/D rows padded to this
static_assert((168 - PRODUCER_REGS) * 128 >= (CONSUMER_REGS - 168) * 128 * NWG,
              "the producer frees the registers the consumers take");

// the head dims the tiles hold: HD, or 128 for hd 112 (TMA zero-fills
// columns 112-127)
template <int HD>
constexpr int padded() {
  return HD <= 64 ? HD : (HD + 63) / 64 * 64;
}

// SPLIT: the warpgroups split the accumulators' columns and share the
// CTA's 64 rows, else each owns 64 rows of every column; by default above
// 128 head dims (see the note).  A split CTA also holds NSCR shared 64 x
// 64 bf16 tiles of P^T and dS^T ((a): two of each, double-buffered) or
// dS ((b): two), through which its warpgroups exchange their halves.
template <int HD, int ST, bool SPLIT_ = (padded<HD>() > 128), int NSCR_ = 0>
struct Geo {
  static constexpr int HDP = padded<HD>();
  static constexpr int SW = HDP * 2 < 128 ? HDP * 2 : 128;  // swizzle bytes
  static constexpr int PC = SW / 2;       // head dims per panel (a row of
  static constexpr int NP = HDP / PC;     // SW bytes); panels per row
  static constexpr bool SPLIT = SPLIT_;
  static constexpr int HA = SPLIT ? HDP / NWG : HDP;  // a warpgroup's columns
  static constexpr int NT = 128 * (NWG + 1);  // consumers, then producer
  static constexpr int RES = SPLIT ? BM : BM * NWG;  // rows of a resident tile
  static constexpr uint32_t TILE = BM * HDP * 2;       // a streamed tile
  static constexpr uint32_t RES_TILE = RES * HDP * 2;  // a resident tile
  static constexpr uint32_t ROWS = 2 * BM * 4;  // a stage's lse and D
  static constexpr int NSCR = SPLIT ? NSCR_ : 0;
  static constexpr uint32_t SCR_TILE = BM * BM * 2;  // 64 rows of 128 bytes
  // 1024 bytes of alignment slack, two resident tiles, ST x (two streamed
  // tiles, lse and D), the exchange tiles, the mbarriers (full and empty
  // per stage, resident full and empty)
  static constexpr int SMEM = 1024 + 2 * RES_TILE + ST * (2 * TILE + ROWS) +
                              NSCR * SCR_TILE + 8 * (2 * ST + 2);
  static_assert(HD % 16 == 0 && HA <= 128 && NP * PC == HDP, "head dim");
  static_assert(!SPLIT || (SW == 128 && HA % 64 == 0), "split geometry");
  static_assert(SMEM <= 232448, "shared memory");
};

// (a) with the softcap and the window (CW) splits the columns from 112
// head dims on (see the note); a split (a) holds four exchange tiles
template <int HD, bool CW>
using GeoA = Geo<HD, DKDV_STAGES,
                 (padded<HD>() > 128 || (CW && padded<HD>() == 128)), 4>;
// (b) at hd 256 in two stages (three do not fit), with two exchange tiles
template <int HD>
using GeoB = Geo<HD, (HD > 128 ? 2 : DQ_STAGES), (padded<HD>() > 128), 2>;

// the producer's and each consumer's registers after setmaxnreg in (a):
// with CW the producer keeps 40 (its window bounds), the consumers 232
template <bool CW>
__host__ __device__ constexpr int producer_regs() {
  return CW ? 40 : PRODUCER_REGS;
}
template <bool CW>
__host__ __device__ constexpr int consumer_regs() {
  return CW ? 232 : CONSUMER_REGS;
}
static_assert((168 - producer_regs<true>()) * 128 >=
                  (consumer_regs<true>() - 168) * 128 * NWG,
              "the producer frees the registers the consumers take");

constexpr int max3(int a, int b, int c) {
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

// dynamic shared memory of an instance: the largest of (a)'s (with and
// without CW) and (b)'s
template <int HD>
constexpr int smem_bytes() {
  return max3(GeoA<HD, false>::SMEM, GeoA<HD, true>::SMEM, GeoB<HD>::SMEM);
}

// (p)'s lanes a row: the largest power of two dividing HD / 4, at most 32
template <int HD>
__host__ __device__ constexpr int prep_lanes() {
  return ((HD / 4) & -(HD / 4)) < 32 ? ((HD / 4) & -(HD / 4)) : 32;
}

// 2^x (the MUFU's approximation, as exp2f; results below 2^-126 flush
// to 0, 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // a in the low half
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Shared-memory carve-up of both main kernels: the resident tiles R0, R1
// ((a): K, V; (b): Q, dO), the streamed tiles A, B of each stage ((a): Q,
// dO; (b): K, V), a split CTA's exchange tiles (1024-byte aligned, as the
// 128-byte swizzle needs), (a)'s lse and D rows, the barriers.
template <class G, int ST>
struct Smem {
  uint32_t r0;  // the rest are fixed offsets from it (no registers held)
  __device__ __forceinline__ explicit Smem(unsigned char* raw)
      : r0((smem_addr(raw) + 1023u) & ~1023u) {}  // swizzles repeat every 1 KB
  __device__ __forceinline__ uint32_t r1() const { return r0 + G::RES_TILE; }
  __device__ __forceinline__ uint32_t a() const { return r1() + G::RES_TILE; }
  __device__ __forceinline__ uint32_t b() const { return a() + ST * G::TILE; }
  __device__ __forceinline__ uint32_t scr(int i) const {
    return b() + ST * G::TILE + i * G::SCR_TILE;
  }
  __device__ __forceinline__ uint32_t rows() const { return scr(G::NSCR); }
  __device__ __forceinline__ uint32_t full(int s) const {
    return rows() + ST * G::ROWS + 8u * s;
  }
  __device__ __forceinline__ uint32_t empty(int s) const { return full(ST + s); }
  __device__ __forceinline__ uint32_t res_full() const { return full(2 * ST); }
  __device__ __forceinline__ uint32_t res_empty() const {
    return full(2 * ST + 1);
  }
  __device__ void init(int tid) const {
    constexpr int consumer_warps = 4 * NWG;
    if (tid == 0) {
      for (int s = 0; s < ST; ++s) {
        mbar_init(full(s), 1);  // the producer's expect_tx arrival
        mbar_init(empty(s), consumer_warps);
      }
      mbar_init(res_full(), 1);
      mbar_init(res_empty(), consumer_warps);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }
};

// two floats at a shared-memory address
__device__ __forceinline__ float2 lds2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr));
  return v;
}

// the i-th tile of CTA c of `grid`: the static longest-first list dealt
// out in a snake (c in even rounds, grid - 1 - c in odd ones), so each
// CTA's sum of work stays near the mean; -1 past the list
__device__ __forceinline__ int tile_of(int c, int i, int grid, int n_tiles) {
  const int t = i * grid + ((i & 1) ? grid - 1 - c : c);
  return t < n_tiles ? t : -1;
}

// this warp is done with what the barrier guards
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// k-step kk (16 head dims) of a K-major operand: rows `row0`.. of a tile
// of `rows` rows at `tile`
template <class G>
__device__ __forceinline__ uint64_t kstep(uint32_t tile, int rows, int row0,
                                          int kk) {
  return desc_k<G::SW>(tile + (kk * 16) / G::PC * rows * G::SW +
                       row0 * G::SW + (kk * 16) % G::PC * 2);
}

// d = A.B^T over the HD head dims that hold data: A rows row0.. of the
// `rows`-row tile at `ta`, B rows brow0.. of the 64-row streamed tile at
// `tb` (64 of them for d[32], 32 for d[16]), both K-major; issued, not
// committed
template <class G, int HD, int NA>
__device__ __forceinline__ void issue_nt(float (&d)[NA], uint32_t ta,
                                         int rows, int row0, uint32_t tb,
                                         int brow0 = 0) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss(d, kstep<G>(ta, rows, row0, kk), kstep<G>(tb, BM, brow0, kk),
             kk > 0);
}

// d += A.B over 64 rows of B: A 64 x 64 bf16 pairs in registers (pairs
// 4 kk .. 4 kk + 3 the fragment of k-step kk), B the 64-row streamed tile
// at `tb` (from its first column on), MN-major; issued, not committed
template <class G, int N>
__device__ __forceinline__ void issue_nn(float (&d)[N], const uint32_t (&a)[16],
                                         uint32_t tb) {
#pragma unroll
  for (int kk = 0; kk < BM / 16; ++kk)
    wgmma_rs(d, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
             desc_mn<G::SW>(tb + kk * 16 * G::SW, BM * G::SW));
}

// the same with A a 64 x 64 exchange tile at `x` in shared memory
// (K-major, 128-byte swizzle)
template <class G, int N>
__device__ __forceinline__ void issue_xn(float (&d)[N], uint32_t x,
                                         uint32_t tb) {
#pragma unroll
  for (int kk = 0; kk < BM / 16; ++kk)
    wgmma_ss_mn(d, desc_k<128>(x + kk * 32),
                desc_mn<G::SW>(tb + kk * 16 * G::SW, BM * G::SW));
}

// a bf16 pair into row r, columns c and c + 1 (c even) of the exchange
// tile at `x`: rows of 128 bytes, 16-byte chunk c / 8 at chunk (c / 8) ^
// (r % 8), the 128-byte swizzle the K-major descriptor reads (the tile
// 1024-byte aligned).  A warp's 32 stores of one pair index fill 32
// different banks.
__device__ __forceinline__ void put_pair(uint32_t x, int r, int c,
                                         uint32_t v) {
  st_shared(x + r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2, v);
}

// (p) D = rowsum(dO o) and bf16(dO); lse and D into padded rows.  L =
// prep_lanes lanes a row, each over the float4 chunks part, part + L, ...
// in order, then a butterfly over the lanes.  Rows are (b, h, s) with s <
// S_pad; s >= S writes the padding.
template <int HD>
__global__ void __launch_bounds__(256)
    flash_bwd_prep_kernel(const float* __restrict__ o,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          bf16* __restrict__ dob, float* __restrict__ rows,
                          int B, int S, int H, int S_pad) {
  constexpr int L = prep_lanes<HD>();
  constexpr int NC = HD / 4 / L;  // chunks a lane
  static_assert(32 % L == 0 && NC * L * 4 == HD, "lane map");
  const int part = threadIdx.x % L;
  const long long total = (long long)B * H * S_pad;
  const long long vr =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / L;
  const int s = (int)(vr % S_pad);
  const long long bh = vr / S_pad;  // b * H + h
  const int h = (int)(bh % H), b = (int)(bh / H);
  const bool in = vr < total && s < S;
  float acc = 0.f;
  if (in) {
    const size_t row = (((size_t)b * S + s) * H + h) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const size_t off = row + (part + L * c) * 4;
      const float4 g = *reinterpret_cast<const float4*>(dout + off);
      const float4 y = *reinterpret_cast<const float4*>(o + off);
      acc = fmaf(g.x, y.x, acc);
      acc = fmaf(g.y, y.y, acc);
      acc = fmaf(g.z, y.z, acc);
      acc = fmaf(g.w, y.w, acc);
      *reinterpret_cast<uint2*>(dob + off) =
          make_uint2(pack(g.x, g.y), pack(g.z, g.w));
    }
  }
#pragma unroll
  for (int m = L / 2; m >= 1; m /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (part == 0 && vr < total) {
    rows[bh * S_pad + s] = in ? lse[bh * S + s] : inf();
    rows[total + bh * S_pad + s] = in ? acc : 0.f;
  }
}

// (a)'s q blocks [lo, hi) of the key block starting at key k0: from the
// diagonal (causal) and, under a window, up to the one that holds the
// block's last key + window - 1
template <class G, bool CW>
__device__ __forceinline__ int2 q_range(int k0, int n_qb, int causal,
                                        int window) {
  const int lo = causal ? min(k0 / BM, n_qb) : 0;
  const int hi = CW && window > 0
                     ? min(n_qb, (k0 + G::RES - 1 + window - 1) / BM + 1)
                     : n_qb;
  return make_int2(lo, hi);
}

// (b)'s first key block for the rows starting at q0: the one that holds
// q0 - window + 1 (0 without a window)
template <bool CW>
__device__ __forceinline__ int first_kv(int q0, int window) {
  return CW && window > 0 ? max(q0 - window + 1, 0) / BM : 0;
}

// (a) dK and dV.  Tiles: key blocks of RES keys x kv heads x batch, key
// block outermost (longest first).  Steps of a tile: (query head gi, q
// block) for the q blocks of q_range, q blocks innermost.
template <int HD, bool CW>
__global__ void __launch_bounds__(GeoA<HD, CW>::NT, 1)
    flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tdo,
                                const __grid_constant__ CUtensorMap trows,
                                float* __restrict__ dk,
                                float* __restrict__ dv, int B, int S, int Tn,
                                int H, int KH, int causal, float scale,
                                Scaling sg, int window) {
  using G = GeoA<HD, CW>;
  constexpr int ST = DKDV_STAGES;
  constexpr int SW = G::SW, PC = G::PC, NP = G::NP, RES = G::RES;
  constexpr int HA = G::HA;
  extern __shared__ __align__(128) unsigned char bwd_smem[];
  const Smem<G, ST> sm(bwd_smem);
  const int tid = threadIdx.x;
  sm.init(tid);

  const int GH = H / KH;
  const int n_qb = (S + BM - 1) / BM;
  const int n_kb = (Tn + RES - 1) / RES;
  const int n_tiles = n_kb * KH * B;

  if (tid >= 128 * NWG) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(
        producer_regs<CW>()));
    if (tid == 128 * NWG) {
      int it = 0, nt = 0;
      for (int i = 0, t; (t = tile_of(blockIdx.x, i, gridDim.x, n_tiles)) >= 0;
           ++i) {
        const int kb = t / (KH * B), kh = t % KH, b = t / KH % B;
        // q_range's rows, bounded by the kernel's arguments where it can
        // (24 registers): from the diagonal (causal) up to S and, under a
        // window, up to the block's last key + window - 1
        const int q_first = causal ? kb * RES : 0;
        if (q_first >= S) continue;
        const int q_last = CW && window > 0 ? kb * RES + RES + window - 2 : S;
        mbar_wait(sm.res_empty(), (nt++ & 1) ^ 1);
        mbar_expect_tx(sm.res_full(), 2 * G::RES_TILE);
        for (int p = 0; p < NP; ++p) {
          tma_load(sm.r0 + p * RES * SW, &tk, sm.res_full(), p * PC, kh,
                   kb * RES, b);
          tma_load(sm.r1() + p * RES * SW, &tv, sm.res_full(), p * PC, kh,
                   kb * RES, b);
        }
        for (int h = kh * GH; h < kh * GH + GH; ++h)
          for (int q0 = q_first; q0 < S && q0 <= q_last; q0 += BM, ++it) {
            const int s = it % ST;
            mbar_wait(sm.empty(s), ((it / ST) & 1) ^ 1);  // 1st pass: free
            mbar_expect_tx(sm.full(s), 2 * G::TILE + G::ROWS);
            for (int p = 0; p < NP; ++p) {
              tma_load(sm.a() + s * G::TILE + p * BM * SW, &tq, sm.full(s),
                       p * PC, h, q0, b);
              tma_load(sm.b() + s * G::TILE + p * BM * SW, &tdo, sm.full(s),
                       p * PC, h, q0, b);
            }
            // lse and D of the rows: (q0.., b H + h, 0..1) of the rows map
            tma_load3(sm.rows() + s * G::ROWS, &trows, sm.full(s), q0,
                      b * H + h, 0);
          }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns keys k0 + 64 wg .. + 63 of each tile
  // (split: keys k0 .. + 63, columns HA wg .. + HA - 1); a thread holds
  // accumulator rows (keys) r0 and r0 + 8, columns 8 j + cq and + 1
  // (element 4 j + 2 r + e: row r0 + 8 r, column 8 j + cq + e).
  // Software-pipelined: step i's dK product is left in flight while step
  // i + 1's S^T is issued; step i's stage is released once that product
  // is done.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(
      consumer_regs<CW>()));
  const int wg = tid / 128, warp = tid / 32 % 4, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4, cq = 2 * (lane % 4);
  const int rw = G::SPLIT ? 0 : 64 * wg;  // the warpgroup's first row
  const int c0 = G::SPLIT ? HA * wg : 0;  // and first column
  const uint32_t cofs = (uint32_t)(c0 / PC) * BM * SW;  // its panel
  const float sl2 = scale * kLog2e;
  // S^T and dP^T: the block's 64 queries, or (split) this warpgroup's 32
  constexpr int NS = G::SPLIT ? 16 : 32;
  float adk[HA / 2], adv[HA / 2], st[NS], dpt[NS];
  uint32_t pa[16];  // P^T, then dS^T, as bf16 pairs
  int it = 0, nt = 0, u = 0;  // u: live steps (split: the exchange buffer)
  for (int ti = 0, t; (t = tile_of(blockIdx.x, ti, gridDim.x, n_tiles)) >= 0;
       ++ti) {
    const int kb = t / (KH * B), kh = t % KH, b = t / KH % B;
    const int k0 = kb * RES, kw0 = k0 + rw;
    const int2 qr = q_range<G, CW>(k0, n_qb, causal, window);
    const int qlo = qr.x, nq = qr.y - qr.x;
#pragma unroll
    for (int i = 0; i < HA / 2; ++i) adk[i] = adv[i] = 0.f;
    if (nq > 0) {
      mbar_wait(sm.res_full(), nt & 1);
      ++nt;
      int held = -1;  // the stage the dK product in flight reads
      for (int i = 0; i < nq * GH; ++i, ++it) {
        const int q0 = (qlo + i % nq) * BM;
        const int s = it % ST;
        mbar_wait(sm.full(s), (it / ST) & 1);
        if (kw0 >= Tn || (causal && kw0 > q0 + BM - 1) ||
            (CW && window > 0 && q0 >= kw0 + 63 + window)) {
          // no pair of this warpgroup's (split: of the CTA's, so both
          // warpgroups skip): free the stage, and the one the product in
          // flight reads (the next live step may reuse it)
          if (held >= 0) {
            wg_wait<0>();
            reg_fence(adk);
            if constexpr (G::SPLIT) reg_fence(adv);  // dV in flight too
            release(sm.empty(held), lane);
            held = -1;
          }
          release(sm.empty(s), lane);
          continue;
        }
        const uint32_t qs = sm.a() + s * G::TILE, dos = sm.b() + s * G::TILE;
        const uint32_t kres = opaque(sm.r0), vres = opaque(sm.r1());
        const uint32_t lse_s = sm.rows() + s * G::ROWS;  // shared addresses
        const uint32_t del_s = lse_s + BM * 4;
        if constexpr (G::SPLIT) {
          // S^T and dP^T of the block's 64 keys and queries qh .. qh + 31
          // (m64n32k16, B 32 rows into the Q and dO tiles); P^T and dS^T of
          // them into this live step's exchange tiles; after both
          // warpgroups' halves are in, dV and dK over all 64 queries for
          // this warpgroup's columns (A from the exchange tiles)
          const int qh = 32 * wg;
          const uint32_t xp = sm.scr(2 * (u & 1)), xd = xp + G::SCR_TILE;
          reg_fence(st);
          reg_fence(dpt);
          wg_fence();
          issue_nt<G, HD>(st, kres, RES, 0, qs, qh);   // S^T = K.Q^T
          wg_commit();
          issue_nt<G, HD>(dpt, vres, RES, 0, dos, qh);  // dP^T = V.dO^T
          wg_commit();
          wg_wait<1>();  // the last dV, dK products and S^T are in
          reg_fence(st);
          reg_fence(adk);
          reg_fence(adv);
          if (held >= 0) release(sm.empty(held), lane);
          const bool edge = (causal && kw0 + 63 > q0) || kw0 + 64 > Tn ||
                            q0 + BM > S ||
                            (CW && window > 0 && q0 + BM - 1 - kw0 >= window);
          float2 l;  // the lse of queries qh + 8 (j / 2) + cq, + 1
#pragma unroll
          for (int j = 0; j < NS / 2; ++j) {
            const int col = qh + 8 * (j >> 1) + cq;  // query q0 + col
            const int key = kw0 + r0 + 8 * (j & 1);
            if ((j & 1) == 0) l = lds2(lse_s + 4 * col);
            float p[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float tt;
              p[e] = ex2(score2<CW, true>(st[2 * j + e], e ? l.y : l.x, sl2, sg, tt));
              if (edge) {
                const int qr_ = q0 + col + e;
                if (key >= Tn || qr_ >= S || (causal && key > qr_) ||
                    (CW && window > 0 && key <= qr_ - window))
                  p[e] = 0.f;
              }
              st[2 * j + e] = CW ? p[e] * (1.f - tt * tt) : p[e];
            }
            put_pair(xp, r0 + 8 * (j & 1), col, pack(p[0], p[1]));
          }
          wg_wait<0>();  // dP^T is in
          reg_fence(dpt);
#pragma unroll
          for (int j = 0; j < NS / 4; ++j) {
            const float2 d = lds2(del_s + 4 * (qh + 8 * j + cq));
#pragma unroll
            for (int e = 4 * j; e < 4 * j + 4; ++e)
              dpt[e] = st[e] * (dpt[e] - ((e & 1) ? d.y : d.x));
          }
#pragma unroll
          for (int j = 0; j < NS / 2; ++j)
            put_pair(xd, r0 + 8 * (j & 1), qh + 8 * (j >> 1) + cq,
                     pack(dpt[2 * j], dpt[2 * j + 1]));
          fence_proxy_async();
          bar_sync<1, 128 * NWG>();  // both halves of P^T and dS^T are in
          reg_fence(adk);
          reg_fence(adv);
          wg_fence();
          issue_xn<G>(adv, xp, dos + cofs);  // dV += P^T.dO
          issue_xn<G>(adk, xd, qs + cofs);   // dK += dS^T.Q, left in flight
          wg_commit();
        } else {
          reg_fence(st);
          reg_fence(dpt);
          wg_fence();
          issue_nt<G, HD>(st, kres, RES, rw, qs);   // S^T = K.Q^T
          wg_commit();
          wg_wait<0>();  // the last dK product and S^T are in
          reg_fence(st);
          reg_fence(adk);
          reg_fence(pa);
          if (held >= 0) release(sm.empty(held), lane);
          const bool edge = (causal && kw0 + 63 > q0) || kw0 + 64 > Tn ||
                            q0 + BM > S ||
                            (CW && window > 0 && q0 + BM - 1 - kw0 >= window);
          float2 l;  // the lse of columns 8 j + cq, + 1
          if constexpr (CW) {
            // P for dV's product, then P (1 - t^2) in P^T's registers
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              float p[2];
#pragma unroll
              for (int u2 = 0; u2 < 2; ++u2) {
                const int e = 2 * j + u2;
                const int col = 8 * (e >> 2) + cq + u2;  // query q0 + col
                if ((e & 3) == 0) l = lds2(lse_s + 4 * col);
                float tt;
                p[u2] = ex2(score2<CW, true>(st[e], u2 ? l.y : l.x, sl2, sg, tt));
                if (edge) {
                  const int key = kw0 + r0 + 8 * ((e >> 1) & 1),
                            qr_ = q0 + col;
                  if (key >= Tn || qr_ >= S || (causal && key > qr_) ||
                      (window > 0 && key <= qr_ - window))
                    p[u2] = 0.f;
                }
                st[e] = p[u2] * (1.f - tt * tt);
              }
              pa[j] = pack(p[0], p[1]);
            }
          } else {
#pragma unroll
            for (int e = 0; e < 32; ++e) {
              const int col = 8 * (e >> 2) + cq + (e & 1);  // query q0 + col
              if ((e & 3) == 0) l = lds2(lse_s + 4 * (col - (e & 1)));
              float p = ex2(fmaf(st[e], sl2, -((e & 1) ? l.y : l.x)));
              if (edge) {
                const int key = kw0 + r0 + 8 * ((e >> 1) & 1), qr_ = q0 + col;
                if (key >= Tn || qr_ >= S || (causal && key > qr_)) p = 0.f;
              }
              st[e] = p;
            }
#pragma unroll
            for (int j = 0; j < 16; ++j) pa[j] = pack(st[2 * j], st[2 * j + 1]);
          }
          reg_fence(pa);
          reg_fence(adv);
          wg_fence();
          // dV += P^T.dO, then dP^T = V.dO^T (issued only now: live beside
          // P^T's registers, its 32 accumulators would spill at hd 128)
          issue_nn<G>(adv, pa, dos + cofs);
          wg_commit();
          issue_nt<G, HD>(dpt, vres, RES, rw, dos);
          wg_commit();
          wg_wait<0>();
          reg_fence(adv);
          reg_fence(pa);
          reg_fence(dpt);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 d = lds2(del_s + 8 * 4 * j + 4 * cq);
#pragma unroll
            for (int e = 4 * j; e < 4 * j + 4; ++e)
              dpt[e] = st[e] * (dpt[e] - ((e & 1) ? d.y : d.x));
          }
#pragma unroll
          for (int j = 0; j < 16; ++j)
            pa[j] = pack(dpt[2 * j], dpt[2 * j + 1]);
          reg_fence(pa);
          reg_fence(adk);
          wg_fence();
          issue_nn<G>(adk, pa, qs + cofs);  // dK += dS^T.Q, left in flight
          wg_commit();
        }
        held = s;
        ++u;
      }
      wg_wait<0>();
      reg_fence(adk);
      if constexpr (G::SPLIT) reg_fence(adv);
      if (held >= 0) release(sm.empty(held), lane);
      release(sm.res_empty(), lane);
    }
    // dK = scale acc, dV = acc, keys past T and columns past HD dropped
    constexpr int NJ = (G::SPLIT ? HA : HD) / 8;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = kw0 + r0 + 8 * r;
      if (key >= Tn) continue;
      const size_t off = (((size_t)b * Tn + key) * KH + kh) * HD + c0 + cq;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (G::SPLIT && HD < G::HDP && c0 + 8 * j >= HD) continue;
        *reinterpret_cast<float2*>(dk + off + 8 * j) = make_float2(
            adk[4 * j + 2 * r] * scale, adk[4 * j + 2 * r + 1] * scale);
        *reinterpret_cast<float2*>(dv + off + 8 * j) =
            make_float2(adv[4 * j + 2 * r], adv[4 * j + 2 * r + 1]);
      }
    }
  }
}

// (b) dQ.  Tiles: q blocks of RES rows x heads x batch, q block outermost
// in descending order (longest first).  Steps: the key blocks of 64 from
// first_kv to the diagonal (causal) or to T.
template <int HD, bool CW>
__global__ void __launch_bounds__(GeoB<HD>::NT, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const float* __restrict__ rows,
                              float* __restrict__ dq, int B, int S, int Tn,
                              int H, int KH, int S_pad, int causal,
                              float scale, Scaling sg, int window) {
  using G = GeoB<HD>;
  constexpr int ST = HD > 128 ? 2 : DQ_STAGES;
  constexpr int SW = G::SW, PC = G::PC, NP = G::NP, RES = G::RES;
  constexpr int HA = G::HA;
  extern __shared__ __align__(128) unsigned char bwd_smem[];
  const Smem<G, ST> sm(bwd_smem);
  const int tid = threadIdx.x;
  sm.init(tid);

  const int GH = H / KH;
  const int n_rb = (S + RES - 1) / RES;
  const int n_tiles = n_rb * H * B;
  // key blocks of the tile whose rows start at q0: [first_kv, n_kv)
  const auto n_kv = [&](int q0) {
    const int end = causal ? min(q0 + RES, Tn) : Tn;
    return (end + BM - 1) / BM;
  };

  if (tid >= 128 * NWG) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (tid == 128 * NWG) {
      int it = 0, nt = 0;
      for (int i = 0, t; (t = tile_of(blockIdx.x, i, gridDim.x, n_tiles)) >= 0;
           ++i, ++nt) {
        const int q0 = (n_rb - 1 - t / (H * B)) * RES;
        const int h = t % H, b = t / H % B, kh = h / GH;
        mbar_wait(sm.res_empty(), (nt & 1) ^ 1);
        mbar_expect_tx(sm.res_full(), 2 * G::RES_TILE);
        for (int p = 0; p < NP; ++p) {
          tma_load(sm.r0 + p * RES * SW, &tq, sm.res_full(), p * PC, h, q0, b);
          tma_load(sm.r1() + p * RES * SW, &tdo, sm.res_full(), p * PC, h, q0,
                   b);
        }
        const int nk = n_kv(q0);
        for (int j = first_kv<CW>(q0, window); j < nk; ++j, ++it) {
          const int s = it % ST;
          mbar_wait(sm.empty(s), ((it / ST) & 1) ^ 1);
          mbar_expect_tx(sm.full(s), 2 * G::TILE);
          for (int p = 0; p < NP; ++p) {
            tma_load(sm.a() + s * G::TILE + p * BM * SW, &tk, sm.full(s),
                     p * PC, kh, j * BM, b);
            tma_load(sm.b() + s * G::TILE + p * BM * SW, &tv, sm.full(s),
                     p * PC, kh, j * BM, b);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows q0 + 64 wg .. + 63 (split: rows q0
  // .. + 63, columns HA wg ..); a thread holds rows r0, r0 + 8 of them
  // (accumulator layout as in (a)).  Pipelined as (a): step j's dQ
  // product runs while step j + 1's S and dP are issued.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const int wg = tid / 128, warp = tid / 32 % 4, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4, cq = 2 * (lane % 4);
  const int rw = G::SPLIT ? 0 : 64 * wg;  // the warpgroup's first row
  const int c0 = G::SPLIT ? HA * wg : 0;  // and first column
  const uint32_t cofs = (uint32_t)(c0 / PC) * BM * SW;  // its panel
  const float sl2 = scale * kLog2e;
  const size_t plane = (size_t)B * H * S_pad;
  // S and dP: the block's 64 keys, or (split) this warpgroup's 32
  constexpr int NS = G::SPLIT ? 16 : 32;
  float adq[HA / 2], sc[NS], dp[NS];
  uint32_t da[16];
  int it = 0, nt = 0, u = 0;  // u: live steps (split: the exchange buffer)
  for (int ti = 0, t; (t = tile_of(blockIdx.x, ti, gridDim.x, n_tiles)) >= 0;
       ++ti, ++nt) {
    const int q0 = (n_rb - 1 - t / (H * B)) * RES, qw0 = q0 + rw;
    const int h = t % H, b = t / H % B;
    // the rows' lse and D (padded: rows past S read +inf and 0)
    float lse_r[2], del_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const size_t at = ((size_t)b * H + h) * S_pad + qw0 + r0 + 8 * r;
      lse_r[r] = rows[at];
      del_r[r] = rows[plane + at];
    }
#pragma unroll
    for (int i = 0; i < HA / 2; ++i) adq[i] = 0.f;
    mbar_wait(sm.res_full(), nt & 1);
    const int nk = n_kv(q0);
    int held = -1;  // the stage the dQ product in flight reads
    for (int j = first_kv<CW>(q0, window); j < nk; ++j, ++it) {
      const int t0 = j * BM;
      const int s = it % ST;
      mbar_wait(sm.full(s), (it / ST) & 1);
      if (qw0 >= S || (causal && t0 > qw0 + 63) ||
          (CW && window > 0 && t0 + 63 + window <= qw0)) {
        if (held >= 0) {  // as in (a)
          wg_wait<0>();
          reg_fence(adq);
          release(sm.empty(held), lane);
          held = -1;
        }
        release(sm.empty(s), lane);
        continue;
      }
      const uint32_t ks = sm.a() + s * G::TILE, vs = sm.b() + s * G::TILE;
      const uint32_t qres = opaque(sm.r0), dores = opaque(sm.r1());
      // split: keys t0 + kh0 .. + 31 (B 32 rows into the K and V tiles)
      const int kh0 = G::SPLIT ? 32 * wg : 0;
      reg_fence(sc);
      reg_fence(dp);
      wg_fence();
      issue_nt<G, HD>(sc, qres, RES, rw, ks, kh0);  // S = Q.K^T
      wg_commit();
      issue_nt<G, HD>(dp, dores, RES, rw, vs, kh0);  // dP = dO.V^T
      wg_commit();
      wg_wait<1>();  // the last dQ product and S are in
      reg_fence(sc);
      reg_fence(adq);
      reg_fence(da);
      if (held >= 0) release(sm.empty(held), lane);
      const bool edge = (causal && t0 + 63 > qw0) || t0 + BM > Tn ||
                        qw0 + 64 > S ||
                        (CW && window > 0 && qw0 + 63 - t0 >= window);
#pragma unroll
      for (int e = 0; e < NS; ++e) {
        const int rr = (e >> 1) & 1;
        float tt;
        float p = ex2(score2<CW, true>(sc[e], lse_r[rr], sl2, sg, tt));
        if (edge) {
          const int key = t0 + kh0 + 8 * (e >> 2) + cq + (e & 1);
          const int row = qw0 + r0 + 8 * rr;
          if (key >= Tn || row >= S || (causal && key > row) ||
              (CW && window > 0 && key <= row - window))
            p = 0.f;
        }
        sc[e] = CW ? p * (1.f - tt * tt) : p;  // P (1 - t^2)
      }
      wg_wait<0>();
      reg_fence(dp);
#pragma unroll
      for (int e = 0; e < NS; ++e) dp[e] = sc[e] * (dp[e] - del_r[(e >> 1) & 1]);
      if constexpr (G::SPLIT) {
        // this warpgroup's half of dS into the live step's exchange tile;
        // after both halves are in, dQ over all 64 keys for its columns
        const uint32_t xs = sm.scr(u & 1);
#pragma unroll
        for (int jj = 0; jj < NS / 2; ++jj)
          put_pair(xs, r0 + 8 * (jj & 1), kh0 + 8 * (jj >> 1) + cq,
                   pack(dp[2 * jj], dp[2 * jj + 1]));
        fence_proxy_async();
        bar_sync<1, 128 * NWG>();  // both halves of dS are in
        reg_fence(adq);
        wg_fence();
        issue_xn<G>(adq, xs, ks + cofs);  // dQ += dS.K, left in flight
        wg_commit();
      } else {
#pragma unroll
        for (int jj = 0; jj < 16; ++jj)
          da[jj] = pack(dp[2 * jj], dp[2 * jj + 1]);
        reg_fence(da);
        reg_fence(adq);
        wg_fence();
        issue_nn<G>(adq, da, ks + cofs);  // dQ += dS.K, left in flight
        wg_commit();
      }
      held = s;
      ++u;
    }
    wg_wait<0>();
    reg_fence(adq);
    if (held >= 0) release(sm.empty(held), lane);
    release(sm.res_empty(), lane);
    // dQ = scale acc, rows past S and columns past HD dropped
    constexpr int NJ = (G::SPLIT ? HA : HD) / 8;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qw0 + r0 + 8 * r;
      if (row >= S) continue;
      float* dst = dq + (((size_t)b * S + row) * H + h) * HD + c0 + cq;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
        *reinterpret_cast<float2*>(dst + 8 * jj) = make_float2(
            adq[4 * jj + 2 * r] * scale, adq[4 * jj + 2 * r + 1] * scale);
    }
  }
}

// persistent grid of `kernel`: min(tiles, SMs x CTAs an SM).  The kernel
// must have been given 168 registers a thread, or the consumers'
// setmaxnreg.inc would wait for registers that never come: refused rather
// than launched.
template <class G, typename K>
int persistent_grid(K kernel, int tiles, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  if (attr.numRegs != 168) return (int)cudaErrorInvalidConfiguration;
  const int threads = G::NT, smem = G::SMEM;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *grid = tiles < sms * per_sm ? tiles : sms * per_sm;
  return 0;
}

// (a) then (b), the instances for CW
template <int HD, bool CW>
int launch_main(const CUtensorMap (&m)[8], const CUtensorMap& ra,
                const float* rows, void* dq, void* dk, void* dv, int B, int S,
                int Tn, int H, int KH, int S_pad, int causal, float scale,
                Scaling sg, int window, cudaStream_t st) {
  using GA = GeoA<HD, CW>;
  using GB = GeoB<HD>;
  const auto ka_fn = flash_bwd_dkdv_wgmma_kernel<HD, CW>;
  const auto kb_fn = flash_bwd_dq_wgmma_kernel<HD, CW>;
  int grid = 0;
  int rc = persistent_grid<GA>(ka_fn, (Tn + GA::RES - 1) / GA::RES * KH * B,
                               &grid);
  if (rc != 0) return rc;
  ka_fn<<<grid, GA::NT, GA::SMEM, st>>>(
      m[0], m[2], m[3], m[1], ra, static_cast<float*>(dk),
      static_cast<float*>(dv), B, S, Tn, H, KH, causal, scale, sg, window);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rc = persistent_grid<GB>(kb_fn, (S + GB::RES - 1) / GB::RES * H * B, &grid);
  if (rc != 0) return rc;
  kb_fn<<<grid, GB::NT, GB::SMEM, st>>>(m[4], m[6], m[7], m[5], rows,
                                        static_cast<float*>(dq), B, S, Tn, H,
                                        KH, S_pad, causal, scale, sg, window);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* dq, void* dk, void* dv,
           void* rows, void* dob, int B, int S, int Tn, int H, int KH,
           int causal, float scale, float softcap, int window,
           cudaStream_t st) {
  using GB = GeoB<HD>;
  constexpr int SW = GB::SW;
  const int S_pad = (S + ROW_PAD - 1) / ROW_PAD * ROW_PAD;
  const long long prep_threads =
      (long long)B * H * S_pad * prep_lanes<HD>();
  flash_bwd_prep_kernel<HD><<<(unsigned)((prep_threads + 255) / 256), 256, 0,
                              st>>>(
      static_cast<const float*>(o), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<bf16*>(dob),
      static_cast<float*>(rows), B, S, H, S_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // (a)'s q, dO, k, v and (b)'s; the maps hold the tensors' HD columns,
  // so a box past them reads zeros (hd 112)
  const int res_a = softcap > 0.f || window > 0 ? GeoA<HD, true>::RES
                                                : GeoA<HD, false>::RES;
  CUtensorMap m[8];
  if (!encode_map<HD, SW>(&m[0], q, B, S, H, BM) ||
      !encode_map<HD, SW>(&m[1], dob, B, S, H, BM) ||
      !encode_map<HD, SW>(&m[2], k, B, Tn, KH, res_a) ||
      !encode_map<HD, SW>(&m[3], v, B, Tn, KH, res_a) ||
      !encode_map<HD, SW>(&m[4], q, B, S, H, GB::RES) ||
      !encode_map<HD, SW>(&m[5], dob, B, S, H, GB::RES) ||
      !encode_map<HD, SW>(&m[6], k, B, Tn, KH, BM) ||
      !encode_map<HD, SW>(&m[7], v, B, Tn, KH, BM))
    return (int)cudaErrorInvalidValue;
  // the rows as (S_pad, B H, 2): a box is one q block's lse and D
  CUtensorMap ra;
  if (!encode_map_f32(&ra, rows, S_pad, B * H, 2, BM, 1, 2))
    return (int)cudaErrorInvalidValue;
  const float* r = static_cast<const float*>(rows);
  const Scaling sg = softcap > 0.f ? Scaling{scale / softcap, softcap * kLog2e}
                                   : Scaling{0.f, 0.f};
  return softcap > 0.f || window > 0
             ? launch_main<HD, true>(m, ra, r, dq, dk, dv, B, S, Tn, H, KH,
                                     S_pad, causal, scale, sg, window, st)
             : launch_main<HD, false>(m, ra, r, dq, dk, dv, B, S, Tn, H, KH,
                                      S_pad, causal, scale, sg, window, st);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// float32: the CUDA cores

namespace simt {

// (ty, tx) = (tid / 16, tid % 16); two CTAs an SM in the launch bounds (at
// most 128 registers a thread), without which ptxas held the softcap's
// instances to 64 registers and spilled
constexpr int NT = 256;

template <int HD>
struct Geo {
  // rows of a block: 64, or 32 at hd 256 (four 64-row tiles would not fit)
  static constexpr int BR = HD > 128 ? 32 : BM;
  static constexpr int RI = BR / 16;  // a thread's rows (and columns) of
                                      // a BR x BR product
  static constexpr int LD = HD + 1;  // odd float strides: no conflicts
  static constexpr int PD = BR + 1;
  static constexpr int ND = HD / 16;  // head dims a thread owns
  static constexpr int TILE = BR * LD;
  static constexpr int SMEM = (4 * TILE + 2 * BR * PD + 2 * BR) * 4;
  static_assert(HD % 16 == 0 && HD <= 256, "head dim");
  static_assert(SMEM <= 232448, "shared memory");
};

// rows [0, valid) of a (BR, HD) float32 tile, `stride` floats apart ->
// shared memory; rows past `valid` are zero
template <int HD, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          size_t stride, int valid) {
  constexpr int BR = Geo<HD>::BR;
  for (int idx = threadIdx.x; idx < BR * HD; idx += NT) {
    const int r = idx / HD, c = idx % HD;
    dst[r * Geo<HD>::LD + c] = r < valid ? (float)src[r * stride + c] : 0.f;
  }
}

// c[i][j] = sum_d A[ty + 16 i][d] B[tx + 16 j][d] over two (BR, HD) tiles
template <int HD>
__device__ __forceinline__ void nt_product(
    const float* A, const float* Bt, int ty, int tx,
    float (&c)[Geo<HD>::RI][Geo<HD>::RI]) {
  constexpr int LD = Geo<HD>::LD, RI = Geo<HD>::RI;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RI; ++j) c[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float a[RI], bb[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) a[i] = A[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < RI; ++j) bb[j] = Bt[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) c[i][j] = fmaf(a[i], bb[j], c[i][j]);
  }
}

// acc[i][n] += sum_c P[ty + 16 i][c] X[c][tx + 16 n], P (BR, BR), X (BR, HD)
template <int HD>
__device__ __forceinline__ void nn_product(
    const float* P, const float* X, int ty, int tx,
    float (&acc)[Geo<HD>::RI][Geo<HD>::ND]) {
  constexpr int LD = Geo<HD>::LD, PD = Geo<HD>::PD, ND = Geo<HD>::ND;
  constexpr int BR = Geo<HD>::BR, RI = Geo<HD>::RI;
#pragma unroll 4
  for (int c = 0; c < BR; ++c) {
    float p[RI], x[ND];
#pragma unroll
    for (int i = 0; i < RI; ++i) p[i] = P[(ty + 16 * i) * PD + c];
#pragma unroll
    for (int n = 0; n < ND; ++n) x[n] = X[c * LD + tx + 16 * n];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int n = 0; n < ND; ++n) acc[i][n] = fmaf(p[i], x[n], acc[i][n]);
  }
}

// (b) dQ, and D for (a).  Grid (q blocks, H, B).
template <int HD, bool CW>
__global__ void __launch_bounds__(NT, 2)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ o,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        float* __restrict__ dq, float* __restrict__ delta,
                        int S, int Tn, int H, int KH, int causal,
                        float scale, Scaling sg, int window) {
  using G = Geo<HD>;
  constexpr int PD = G::PD, ND = G::ND, BR = G::BR, RI = G::RI;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + G::TILE;
  float* Ks = dOs + G::TILE;
  float* Vs = Ks + G::TILE;
  float* Ps = Vs + G::TILE;  // dS
  float* lse_s = Ps + 2 * BR * PD;
  float* del_s = lse_s + BR;

  const int qb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int q0 = qb * BR;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int rows = min(BR, S - q0);
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
    if (part == 0 && r < BR) {
      const bool in = r < rows;
      del_s[r] = in ? acc : 0.f;
      lse_s[r] = in ? lse[((size_t)b * H + h) * S + q0 + r] : inf();
      if (in) delta[((size_t)b * H + h) * S + q0 + r] = acc;
    }
  }
  const float sl2 = scale * kLog2e;
  float acc[RI][ND];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int n = 0; n < ND; ++n) acc[i][n] = 0.f;

  const int kv_end = causal ? min(q0 + BR, Tn) : Tn;
  const int n_tiles = (kv_end + BR - 1) / BR;
  const int jt0 = CW && window > 0 ? max(q0 - window + 1, 0) / BR : 0;
  for (int jt = jt0; jt < n_tiles; ++jt) {
    const int t0 = jt * BR;
    __syncthreads();
    const size_t kofs = ((size_t)b * Tn + t0) * row_k + (size_t)kh * HD;
    load_tile<HD>(Ks, k + kofs, row_k, min(BR, Tn - t0));
    load_tile<HD>(Vs, v + kofs, row_k, min(BR, Tn - t0));
    __syncthreads();
    float s[RI][RI], dp[RI][RI];
    nt_product<HD>(Qs, Ks, ty, tx, s);
    nt_product<HD>(dOs, Vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const bool ok = t0 + c < Tn && (!causal || t0 + c <= q0 + r) &&
                        (!CW || window <= 0 || t0 + c > q0 + r - window);
        if constexpr (CW) {
          float tt;
          const float x = score2<CW>(s[i][j], lse_s[r], sl2, sg, tt);
          const float p = ok ? exp2f(x) : 0.f;
          Ps[r * PD + c] = p * (1.f - tt * tt) * (dp[i][j] - del_s[r]);
        } else {
          const float p = ok ? exp2f(fmaf(s[i][j], sl2, -lse_s[r])) : 0.f;
          Ps[r * PD + c] = p * (dp[i][j] - del_s[r]);
        }
      }
    __syncthreads();
    nn_product<HD>(Ps, Ks, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      dq[qofs + r * row_q + tx + 16 * n] = acc[i][n] * scale;
  }
}

// (a) dK and dV.  Grid (key blocks, KH, B); reads D from (b).
template <int HD, bool CW>
__global__ void __launch_bounds__(NT, 2)
    flash_bwd_dkdv_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int S, int Tn, int H, int KH, int causal,
                          float scale, Scaling sg, int window) {
  using G = Geo<HD>;
  constexpr int PD = G::PD, ND = G::ND, BR = G::BR, RI = G::RI;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + G::TILE;
  float* Qs = Vs + G::TILE;
  float* dOs = Qs + G::TILE;
  float* Ps = dOs + G::TILE;  // P^T
  float* Ds = Ps + BR * PD;   // dS^T
  float* lse_s = Ds + BR * PD;
  float* del_s = lse_s + BR;

  const int kb = blockIdx.x;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int GH = H / KH;
  const int t0 = kb * BR;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t row_q = (size_t)H * HD, row_k = (size_t)KH * HD;
  const int krows = min(BR, Tn - t0);
  const float sl2 = scale * kLog2e;
  const size_t kofs = ((size_t)b * Tn + t0) * row_k + (size_t)kh * HD;
  load_tile<HD>(Ks, k + kofs, row_k, krows);
  load_tile<HD>(Vs, v + kofs, row_k, krows);

  float ak[RI][ND], av[RI][ND];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int n = 0; n < ND; ++n) ak[i][n] = av[i][n] = 0.f;

  const int qt_begin = causal ? t0 / BR : 0;
  const int n_qt = (S + BR - 1) / BR;
  // under a window, up to the q block that holds the last key + window - 1
  const int qt_end = CW && window > 0
                         ? min(n_qt, (t0 + BR - 1 + window - 1) / BR + 1)
                         : n_qt;
  for (int gi = 0; gi < GH; ++gi) {
    const int h = kh * GH + gi;
    for (int it = qt_begin; it < qt_end; ++it) {
      const int q0 = it * BR;
      const int rows = min(BR, S - q0);
      __syncthreads();
      const size_t qofs = ((size_t)b * S + q0) * row_q + (size_t)h * HD;
      load_tile<HD>(Qs, q + qofs, row_q, rows);
      load_tile<HD>(dOs, dout + qofs, row_q, rows);
      if (tid < BR) {
        const bool in = tid < rows;
        const size_t at = ((size_t)b * H + h) * S + q0 + tid;
        lse_s[tid] = in ? lse[at] : inf();
        del_s[tid] = in ? delta[at] : 0.f;
      }
      __syncthreads();
      float s[RI][RI], dp[RI][RI];
      nt_product<HD>(Ks, Qs, ty, tx, s);
      nt_product<HD>(Vs, dOs, ty, tx, dp);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;  // key r, query c
          const bool ok = t0 + r < Tn && (!causal || t0 + r <= q0 + c) &&
                          (!CW || window <= 0 || t0 + r > q0 + c - window);
          if constexpr (CW) {
            float tt;
            const float x = score2<CW>(s[i][j], lse_s[c], sl2, sg, tt);
            const float p = ok ? exp2f(x) : 0.f;
            Ps[r * PD + c] = p;
            Ds[r * PD + c] = p * (1.f - tt * tt) * (dp[i][j] - del_s[c]);
          } else {
            const float p = ok ? exp2f(fmaf(s[i][j], sl2, -lse_s[c])) : 0.f;
            Ps[r * PD + c] = p;
            Ds[r * PD + c] = p * (dp[i][j] - del_s[c]);
          }
        }
      __syncthreads();
      nn_product<HD>(Ps, dOs, ty, tx, av);
      nn_product<HD>(Ds, Qs, ty, tx, ak);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
    if (r >= krows) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      dk[kofs + r * row_k + tx + 16 * n] = ak[i][n] * scale;
      dv[kofs + r * row_k + tx + 16 * n] = av[i][n];
    }
  }
}

template <int HD, bool CW>
int launch_cw(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, void* dq, void* dk, void* dv,
              void* delta, int B, int S, int Tn, int H, int KH, int causal,
              float scale, Scaling sg, int window, cudaStream_t st) {
  using G = Geo<HD>;
  const int smem = G::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<HD, CW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<HD, CW>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return (int)err;
  const float* fq = static_cast<const float*>(q);
  const float* fk = static_cast<const float*>(k);
  const float* fv = static_cast<const float*>(v);
  const float* fdo = static_cast<const float*>(dout);
  const float* fl = static_cast<const float*>(lse);
  flash_bwd_dq_kernel<HD, CW>
      <<<dim3((S + G::BR - 1) / G::BR, H, B), NT, smem, st>>>(
          fq, fk, fv, static_cast<const float*>(o), fdo, fl,
          static_cast<float*>(dq), static_cast<float*>(delta), S, Tn, H, KH,
          causal, scale, sg, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_kernel<HD, CW>
      <<<dim3((Tn + G::BR - 1) / G::BR, KH, B), NT, smem, st>>>(
          fq, fk, fv, fdo, fl, static_cast<const float*>(delta),
          static_cast<float*>(dk), static_cast<float*>(dv), S, Tn, H, KH,
          causal, scale, sg, window);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* dq, void* dk, void* dv,
           void* delta, int B, int S, int Tn, int H, int KH, int causal,
           float scale, float softcap, int window, cudaStream_t st) {
  const Scaling sg = softcap > 0.f ? Scaling{scale / softcap, softcap * kLog2e}
                                   : Scaling{0.f, 0.f};
  return softcap > 0.f || window > 0
             ? launch_cw<HD, true>(q, k, v, o, dout, lse, dq, dk, dv, delta,
                                   B, S, Tn, H, KH, causal, scale, sg, window,
                                   st)
             : launch_cw<HD, false>(q, k, v, o, dout, lse, dq, dk, dv, delta,
                                    B, S, Tn, H, KH, causal, scale, sg,
                                    window, st);
}

}  // namespace simt

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

}  // namespace

extern "C" {

// dynamic shared memory of the instances for (hd, input type), bytes (for
// bf16 the larger of the dK/dV and dQ kernels'); 0 for a head dim
// without an instance
int repro_flash_attention_bwd_smem(int hd, int is_bf16) {
  const int bytes = with_hd(hd, [is_bf16](auto c) {
    constexpr int HD = decltype(c)::value;
    return is_bf16 ? tc::smem_bytes<HD>() : simt::Geo<HD>::SMEM;
  });
  return bytes < 0 ? 0 : bytes;
}

// q (B,S,H,hd), k/v (B,T,KH,hd) contiguous, f32 (is_bf16 = 0) or bf16;
// o, dout (B,S,H,hd) and lse (B,H,S) float32 from the forward (called
// with the same causal, scale, softcap and window); outputs dq
// (B,S,H,hd), dk/dv (B,T,KH,hd) float32; scratch delta, float32: (B,H,S)
// for float32 inputs, 2 x (B,H,S_pad) for bf16 (lse, then D, with S_pad =
// S rounded up to a multiple of 128), and for bf16 dob (B,S,H,hd) bf16.
// softcap <= 0: none; window <= 0: none (a window must leave every row a
// key: S < T + window).  All 16-byte aligned.  Launches on `stream` (f32:
// (b) then (a); bf16: (p), (a), (b)).  Returns a cudaError_t.
int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const void* lse, void* dq, void* dk, void* dv,
                              void* delta, void* dob, int B, int S, int Tn,
                              int H, int KH, int hd, int is_bf16, int causal,
                              float scale, float softcap, int window,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = with_hd(hd, [&](auto c) {
    constexpr int HD = decltype(c)::value;
    return is_bf16 ? tc::launch<HD>(q, k, v, o, dout, lse, dq, dk, dv, delta,
                                    dob, B, S, Tn, H, KH, causal, scale,
                                    softcap, window, st)
                   : simt::launch<HD>(q, k, v, o, dout, lse, dq, dk, dv,
                                      delta, B, S, Tn, H, KH, causal, scale,
                                      softcap, window, st);
  });
  return rc < 0 ? (int)cudaErrorInvalidValue : rc;
}

}  // extern "C"

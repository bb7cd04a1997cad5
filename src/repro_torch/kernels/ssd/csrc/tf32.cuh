// Helpers shared by the SSD kernels (ssd.cu, the forward, and ssd_bwd.cu,
// its backward): 3xTF32 products on the tensor cores as warp-level
// mma.sync.m16n8k8 with float32 accumulators, and cp.async copies into
// shared memory.
//
// 3xTF32 as in CUTLASS: each operand a splits into big = tf32(a) and
// small = tf32(a - big), both rounded to nearest, ties away from zero
// (the bit form of cvt.rna.tf32.f32 for finite values, two integer
// operations), and each k-step accumulates small_A.big_B, big_A.small_B,
// then big_A.big_B.  The lost small.small term and the roundings leave
// ~2^-22 of each product.  Fragments (lane = 4 g + t): A (g,t) (g+8,t)
// (g,t+4) (g+8,t+4); B (k t, n g) (k t+4, n g); C (g,2t) (g,2t+1)
// (g+8,2t) (g+8,2t+1).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// a TF32 value: float32 rounded to 10 mantissa bits, to nearest, ties
// away from zero (cvt.rna.tf32.f32 for finite a), low 13 bits zero
__device__ __forceinline__ uint32_t tf32(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float a, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(a);
  small = tf32(a - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A (MTL m-tiles) and B (NTL n-tiles) fragments of one k-step, split
template <int MTL, int NTL>
struct Frags {
  uint32_t ab[MTL][4], as[MTL][4];   // A big, small
  uint32_t bb[NTL][2], bs[NTL][2];   // B big, small
};

// d[m][n] += a[m] . b[n] in 3xTF32, the small terms first; each product
// runs over the whole warp tile before the next, so that the
// accumulators' dependent mma chains interleave
template <int MTL, int NTL>
__device__ __forceinline__ void mma3(float (&d)[MTL][NTL][4],
                                     const Frags<MTL, NTL>& f) {
#pragma unroll
  for (int m = 0; m < MTL; ++m)
#pragma unroll
    for (int n = 0; n < NTL; ++n) mma_tf32(d[m][n], f.as[m], f.bb[n]);
#pragma unroll
  for (int m = 0; m < MTL; ++m)
#pragma unroll
    for (int n = 0; n < NTL; ++n) mma_tf32(d[m][n], f.ab[m], f.bs[n]);
#pragma unroll
  for (int m = 0; m < MTL; ++m)
#pragma unroll
    for (int n = 0; n < NTL; ++n) mma_tf32(d[m][n], f.ab[m], f.bb[n]);
}

// acc += the products of k-steps k0..k1-1 over a warp tile of MTL x NTL
// mma tiles (3xTF32); frag(ks, f) reads and splits k-step ks's fragments.
// Each fragment element read from shared memory feeds NTL (A) or MTL (B)
// products: shared-memory traffic, not the tensor cores, bounds a k-step.
template <int MTL, int NTL, typename Frag>
__device__ __forceinline__ void kloop(float (&acc)[MTL][NTL][4], int k0,
                                      int k1, Frag&& frag) {
  for (int ks = k0; ks < k1; ++ks) {
    Frags<MTL, NTL> f;
    frag(ks, f);
    mma3(acc, f);
  }
}

template <int MTL, int NTL>
__device__ __forceinline__ void zero(float (&acc)[MTL][NTL][4]) {
#pragma unroll
  for (int m = 0; m < MTL; ++m)
#pragma unroll
    for (int n = 0; n < NTL; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
}

__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// cp.async of 16 (or 4) bytes into shared memory; zero-fills the
// destination when ok is false (the source, clamped in range by the
// caller, is then not read)
__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most `pending` of this thread's copy groups are in flight
template <int pending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending));
}

}  // namespace

// bn256 tower device library: Fp2 = Fp[i]/(i^2 + 1), one element per
// thread, over the Fp code of bn256_g1.cuh; Fp6 = Fp2[v]/(v^3 - XI) and
// Fp12 = Fp2[w]/(w^6 - XI) with XI = 3 + i are spread over the lanes of
// the team kernels (gt_ops.cu, miller.cu), one Fp2 slot each.
//
// Counterpart of make_fp2 / make_fp12 in drynx_tpu/crypto/pallas_pairing.py.
// The tensors outside the kernels keep the reference layout: Fp2 (..., 2, 16)
// and Fp12 (..., 6, 2, 16) of 16-bit limbs in int32 words, repacked here into
// 8 x 32-bit words at the kernel edge with 16-byte vector loads and stores
// (the wrappers hand the kernels 16-byte-aligned, contiguous tensors).
//
// Every result is the canonical residue, so any correct formula gives the
// reference's bytes; the formulas are the reference's all the same:
// Karatsuba Fp2 products (3 Fp products) here, and in the team kernels
// 3-way Karatsuba Fp6 products (6 Fp2) and Karatsuba over Fp6 for Fp12
// (18 Fp2 products), the tower inverse and the Granger-Scott cyclotomic
// square.
#pragma once

#include <stdint.h>

#include "bn256_g1.cuh"

namespace bn256 {

constexpr int XI_A = 3;   // XI = XI_A + i (params.XI)

struct Fp2 {
  Fp c0, c1;
};

// ---------------------------------------------------------------------------
// Tensor edge, vectorised: one Fp is 16 int32 words = 4 x int4 (load_fp_v
// is in bn256_g1.cuh)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void store_fp_v(int32_t* dst, const Fp& a) {
  int4* d = reinterpret_cast<int4*>(dst);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    d[q] = make_int4((int32_t)(a.w[2 * q] & 0xFFFFu), (int32_t)(a.w[2 * q] >> 16),
                     (int32_t)(a.w[2 * q + 1] & 0xFFFFu),
                     (int32_t)(a.w[2 * q + 1] >> 16));
  }
}

__device__ __forceinline__ Fp2 load_fp2(const int32_t* src) {
  Fp2 r;
  r.c0 = load_fp_v(src);
  r.c1 = load_fp_v(src + NL16);
  return r;
}

__device__ __forceinline__ void store_fp2(int32_t* dst, const Fp2& a) {
  store_fp_v(dst, a.c0);
  store_fp_v(dst + NL16, a.c1);
}

// ---------------------------------------------------------------------------
// Fp2 (make_fp2)
// ---------------------------------------------------------------------------

__device__ __forceinline__ Fp fp_zero() {
  Fp r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = 0;
  return r;
}

// R mod p, the Montgomery form of 1 (R = 2^256)
__device__ __forceinline__ uint32_t one_word(int i) {
  switch (i) {
    case 0: return 0xa1f76999u;
    case 1: return 0xe7a35393u;
    case 2: return 0xdf4a4a61u;
    case 3: return 0x11a4772eu;
    case 4: return 0x9e7b23deu;
    case 5: return 0x55901347u;
    case 6: return 0xb55c7806u;
    default: return 0x704afe1cu;
  }
}

__device__ __forceinline__ Fp fp_one() {
  Fp r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = one_word(i);
  return r;
}

__device__ __forceinline__ Fp2 f2add(const Fp2& a, const Fp2& b) {
  return Fp2{fadd(a.c0, b.c0), fadd(a.c1, b.c1)};
}

__device__ __forceinline__ Fp2 f2sub(const Fp2& a, const Fp2& b) {
  return Fp2{fsub(a.c0, b.c0), fsub(a.c1, b.c1)};
}

__device__ __forceinline__ Fp2 f2neg(const Fp2& a) {
  const Fp z = fp_zero();
  return Fp2{fsub(z, a.c0), fsub(z, a.c1)};
}

// Karatsuba over i^2 = -1: 3 Montgomery products
__device__ __forceinline__ Fp2 f2mul(const Fp2& a, const Fp2& b) {
  const Fp t0 = mont_mul(a.c0, b.c0);
  const Fp t1 = mont_mul(a.c1, b.c1);
  const Fp t2 = mont_mul(fadd(a.c0, a.c1), fadd(b.c0, b.c1));
  return Fp2{fsub(t0, t1), fsub(fsub(t2, t0), t1)};
}

// (a0 + a1 i)^2 = (a0 + a1)(a0 - a1) + 2 a0 a1 i: 2 Montgomery products
__device__ __forceinline__ Fp2 f2sqr(const Fp2& a) {
  const Fp re = mont_mul(fadd(a.c0, a.c1), fsub(a.c0, a.c1));
  const Fp im = mont_mul(a.c0, a.c1);
  return Fp2{re, fadd(im, im)};
}

__device__ __forceinline__ Fp2 f2conj(const Fp2& a) {
  return Fp2{a.c0, fsub(fp_zero(), a.c1)};
}

__device__ __forceinline__ Fp2 f2mul_fp(const Fp2& a, const Fp& s) {
  return Fp2{mont_mul(a.c0, s), mont_mul(a.c1, s)};
}

__device__ __forceinline__ Fp mul3(const Fp& x) { return fadd(fadd(x, x), x); }

// (a0 + a1 i)(3 + i) = (3 a0 - a1) + (a0 + 3 a1) i
__device__ __forceinline__ Fp2 f2mul_xi(const Fp2& a) {
  static_assert(XI_A == 3, "f2mul_xi is written for XI = 3 + i");
  return Fp2{fsub(mul3(a.c0), a.c1), fadd(a.c0, mul3(a.c1))};
}

__device__ __forceinline__ bool f2is_zero(const Fp2& a) {
  return fis_zero(a.c0) && fis_zero(a.c1);
}

__device__ __forceinline__ Fp2 f2select(uint32_t mask, const Fp2& a, const Fp2& b) {
  return Fp2{fp_select(mask, a.c0, b.c0), fp_select(mask, a.c1, b.c1)};
}

}  // namespace bn256

// bn256 tower device library: Fp2 = Fp[i]/(i^2 + 1), Fp6 = Fp2[v]/(v^3 - XI)
// and Fp12 = Fp2[w]/(w^6 - XI) with XI = 3 + i, one element per thread, over
// the Fp code of bn256_g1.cuh.
//
// Counterpart of make_fp2 / make_fp12 in drynx_tpu/crypto/pallas_pairing.py.
// The tensors outside the kernels keep the reference layout: Fp2 (..., 2, 16)
// and Fp12 (..., 6, 2, 16) of 16-bit limbs in int32 words, repacked here into
// 8 x 32-bit words at the kernel edge with 16-byte vector loads and stores
// (the wrappers hand the kernels 16-byte-aligned, contiguous tensors).
//
// Every result is the canonical residue, so any correct formula gives the
// reference's bytes; the formulas are the reference's all the same: Karatsuba
// Fp2 products (3 Fp products), 3-way Karatsuba Fp6 products (6 Fp2) and
// Karatsuba over Fp6 for Fp12 (18 Fp2 products), the complex-method Fp12
// square (12) and the sparse line product (18); the tower inverse and the
// Granger-Scott cyclotomic square are gt_ops.cu's team kernels.
// The big tower functions are not inlined: one body each, their
// temporaries in their own frame.
#pragma once

#include <stdint.h>

#include "bn256_g1.cuh"

namespace bn256 {

constexpr int XI_A = 3;   // XI = XI_A + i (params.XI)

struct Fp2 {
  Fp c0, c1;
};

struct Fp6 {
  Fp2 c[3];
};

struct Fp12 {
  Fp2 c[6];
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

__device__ __forceinline__ Fp12 load_fp12(const int32_t* src) {
  Fp12 r;
#pragma unroll
  for (int k = 0; k < 6; ++k) r.c[k] = load_fp2(src + 2 * NL16 * k);
  return r;
}

__device__ __forceinline__ void store_fp12(int32_t* dst, const Fp12& a) {
#pragma unroll
  for (int k = 0; k < 6; ++k) store_fp2(dst + 2 * NL16 * k, a.c[k]);
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

// ---------------------------------------------------------------------------
// Fp6 and Fp12 (make_fp12); Fp12 f = A(v) + w B(v), A = (f0, f2, f4),
// B = (f1, f3, f5), v = w^2
// ---------------------------------------------------------------------------

__device__ __forceinline__ Fp6 fp6_add(const Fp6& a, const Fp6& b) {
  Fp6 r;
#pragma unroll
  for (int k = 0; k < 3; ++k) r.c[k] = f2add(a.c[k], b.c[k]);
  return r;
}

__device__ __forceinline__ Fp6 fp6_sub(const Fp6& a, const Fp6& b) {
  Fp6 r;
#pragma unroll
  for (int k = 0; k < 3; ++k) r.c[k] = f2sub(a.c[k], b.c[k]);
  return r;
}

// multiply by v: (a0, a1, a2) -> (XI a2, a0, a1)
__device__ __forceinline__ Fp6 fp6_mul_v(const Fp6& a) {
  return Fp6{{f2mul_xi(a.c[2]), a.c[0], a.c[1]}};
}

// 3-way Karatsuba: 6 Fp2 products. Not inlined: its temporaries then live
// in its own frame, and the three call sites of an Fp12 product share one
// body (code size, compile time).
static __device__ __noinline__ Fp6 fp6_mul(const Fp6& a, const Fp6& b) {
  const Fp2 t0 = f2mul(a.c[0], b.c[0]);
  const Fp2 t1 = f2mul(a.c[1], b.c[1]);
  const Fp2 t2 = f2mul(a.c[2], b.c[2]);
  const Fp2 m01 = f2mul(f2add(a.c[0], a.c[1]), f2add(b.c[0], b.c[1]));
  const Fp2 m02 = f2mul(f2add(a.c[0], a.c[2]), f2add(b.c[0], b.c[2]));
  const Fp2 m12 = f2mul(f2add(a.c[1], a.c[2]), f2add(b.c[1], b.c[2]));
  Fp6 r;
  r.c[0] = f2add(t0, f2mul_xi(f2sub(f2sub(m12, t1), t2)));
  r.c[1] = f2add(f2sub(f2sub(m01, t0), t1), f2mul_xi(t2));
  r.c[2] = f2add(f2sub(f2sub(m02, t0), t2), t1);
  return r;
}

// Karatsuba over Fp6: 3 Fp6 products = 18 Fp2 products
__device__ __forceinline__ Fp12 f12mul(const Fp12& a, const Fp12& b) {
  const Fp6 A1{{a.c[0], a.c[2], a.c[4]}}, B1{{a.c[1], a.c[3], a.c[5]}};
  const Fp6 A2{{b.c[0], b.c[2], b.c[4]}}, B2{{b.c[1], b.c[3], b.c[5]}};
  const Fp6 t0 = fp6_mul(A1, A2);
  const Fp6 t1 = fp6_mul(B1, B2);
  const Fp6 t2 = fp6_mul(fp6_add(A1, B1), fp6_add(A2, B2));
  const Fp6 c = fp6_add(t0, fp6_mul_v(t1));
  const Fp6 d = fp6_sub(fp6_sub(t2, t0), t1);
  Fp12 r;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    r.c[2 * k] = c.c[k];
    r.c[2 * k + 1] = d.c[k];
  }
  return r;
}

__device__ __forceinline__ Fp12 f12_one() {
  Fp12 r;
  r.c[0] = Fp2{fp_one(), fp_zero()};
#pragma unroll
  for (int k = 1; k < 6; ++k) r.c[k] = Fp2{fp_zero(), fp_zero()};
  return r;
}

// mask is 0 or 0xFFFFFFFF: r = mask ? a : b
__device__ __forceinline__ Fp12 f12select(uint32_t mask, const Fp12& a,
                                          const Fp12& b) {
  Fp12 r;
#pragma unroll
  for (int k = 0; k < 6; ++k) r.c[k] = f2select(mask, a.c[k], b.c[k]);
  return r;
}

// a^(p^6): negate the odd-w coefficients
__device__ __forceinline__ Fp12 f12conj6(const Fp12& a) {
  Fp12 r;
#pragma unroll
  for (int k = 0; k < 6; ++k) r.c[k] = (k % 2) ? f2neg(a.c[k]) : a.c[k];
  return r;
}

// complex-method square over Fp6: 2 Fp6 products = 12 Fp2 products
static __device__ __noinline__ Fp12 f12sqr(const Fp12& a) {
  const Fp6 A{{a.c[0], a.c[2], a.c[4]}}, B{{a.c[1], a.c[3], a.c[5]}};
  const Fp6 ab = fp6_mul(A, B);
  const Fp6 t = fp6_mul(fp6_add(A, B), fp6_add(A, fp6_mul_v(B)));
  const Fp6 c = fp6_sub(fp6_sub(t, ab), fp6_mul_v(ab));
  const Fp6 d = fp6_add(ab, ab);
  Fp12 r;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    r.c[2 * k] = c.c[k];
    r.c[2 * k + 1] = d.c[k];
  }
  return r;
}

// f * (l0 + l1 w + l3 w^3), the product with a line value: 18 Fp2 products
static __device__ __noinline__ Fp12 sparse013(const Fp12& f, const Fp2& l0,
                                              const Fp2& l1, const Fp2& l3) {
  Fp2 acc[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) acc[k] = Fp2{fp_zero(), fp_zero()};
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    acc[k] = f2add(acc[k], f2mul(f.c[k], l0));
    acc[k + 1] = f2add(acc[k + 1], f2mul(f.c[k], l1));
    acc[k + 3] = f2add(acc[k + 3], f2mul(f.c[k], l3));
  }
  Fp12 r;
#pragma unroll
  for (int k = 0; k < 6; ++k) r.c[k] = acc[k];
#pragma unroll
  for (int k = 6; k < 9; ++k) r.c[k - 6] = f2add(r.c[k - 6], f2mul_xi(acc[k]));
  return r;
}

}  // namespace bn256

// bn256 G1 device library: Fp Montgomery arithmetic and the complete
// Jacobian group law, one curve element per thread.
//
// Counterpart of drynx_tpu/crypto/pallas_ops.py: mont_mul, fadd, fsub,
// fis_zero and make_group (pdouble, padd). The tensors outside the kernels
// keep the reference layout, 16 little-endian 16-bit limbs per element held
// in int32 words; a kernel repacks them at its edge into 8 x 32-bit words,
// where Hopper multiplies 32 x 32 -> 64 bits natively. A Montgomery value
// with R = 2^256 is the same number in either limb width, so only n' changes
// (-p^-1 mod 2^32 here, mod 2^16 in the reference).
//
// Every field result is the canonical residue in [0, p) and the group law
// follows the reference's formulas and select order step for step, so a
// kernel's output equals its plain PyTorch version byte for byte.
#pragma once

#include <stdint.h>

namespace bn256 {

constexpr int NW = 8;           // 32-bit words per field element
constexpr int NL16 = 16;        // 16-bit limbs per field element (tensor layout)
constexpr uint32_t NPRIME32 = 0x7f17daa9u;  // -p^-1 mod 2^32

struct Fp {
  uint32_t w[NW];
};

struct G1 {
  Fp X, Y, Z;
};

__device__ __forceinline__ uint32_t p_word(int i) {
  // p = 65000549695646603732796438742359905742825358107623003571877145026864184071783
  switch (i) {
    case 0: return 0x5e089667u;
    case 1: return 0x185cac6cu;
    case 2: return 0x20b5b59eu;
    case 3: return 0xee5b88d1u;
    case 4: return 0x6184dc21u;
    case 5: return 0xaa6fecb8u;
    case 6: return 0x4aa387f9u;
    default: return 0x8fb501e3u;
  }
}

// ---------------------------------------------------------------------------
// Tensor edge: 16 x 16-bit limbs (int32 words) <-> 8 x 32-bit words
// ---------------------------------------------------------------------------

__device__ __forceinline__ Fp load_fp(const int32_t* src) {
  Fp r;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    r.w[i] = (uint32_t)src[2 * i] | ((uint32_t)src[2 * i + 1] << 16);
  }
  return r;
}

__device__ __forceinline__ void store_fp(int32_t* dst, const Fp& a) {
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    dst[2 * i] = (int32_t)(a.w[i] & 0xFFFFu);
    dst[2 * i + 1] = (int32_t)(a.w[i] >> 16);
  }
}

__device__ __forceinline__ G1 load_g1(const int32_t* src) {
  G1 p;
  p.X = load_fp(src);
  p.Y = load_fp(src + NL16);
  p.Z = load_fp(src + 2 * NL16);
  return p;
}

__device__ __forceinline__ void store_g1(int32_t* dst, const G1& p) {
  store_fp(dst, p.X);
  store_fp(dst + NL16, p.Y);
  store_fp(dst + 2 * NL16, p.Z);
}

// ---------------------------------------------------------------------------
// Fp arithmetic
// ---------------------------------------------------------------------------

// r = a - b over 256 bits; returns the borrow (0 or 1).
__device__ __forceinline__ uint32_t sub_words(Fp& r, const Fp& a, const Fp& b) {
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t d = (uint64_t)a.w[i] - b.w[i] - borrow;
    r.w[i] = (uint32_t)d;
    borrow = d >> 63;
  }
  return (uint32_t)borrow;
}

__device__ __forceinline__ Fp p_fp() {
  Fp p;
#pragma unroll
  for (int i = 0; i < NW; ++i) p.w[i] = p_word(i);
  return p;
}

// mask is 0 or 0xFFFFFFFF: r = mask ? a : b, without a branch
__device__ __forceinline__ Fp fp_select(uint32_t mask, const Fp& a, const Fp& b) {
  Fp r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = (a.w[i] & mask) | (b.w[i] & ~mask);
  return r;
}

__device__ __forceinline__ G1 g1_select(uint32_t mask, const G1& a, const G1& b) {
  G1 r;
  r.X = fp_select(mask, a.X, b.X);
  r.Y = fp_select(mask, a.Y, b.Y);
  r.Z = fp_select(mask, a.Z, b.Z);
  return r;
}

__device__ __forceinline__ uint32_t mask_of(bool c) { return 0u - (uint32_t)c; }

// (a + b) mod p, inputs below p (pallas_ops.fadd)
__device__ __forceinline__ Fp fadd(const Fp& a, const Fp& b) {
  Fp s;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    c += (uint64_t)a.w[i] + b.w[i];
    s.w[i] = (uint32_t)c;
    c >>= 32;
  }
  Fp d;
  uint32_t borrow = sub_words(d, s, p_fp());
  return fp_select(mask_of(borrow == 0 || c != 0), d, s);
}

// (a - b) mod p, inputs below p (pallas_ops.fsub)
__device__ __forceinline__ Fp fsub(const Fp& a, const Fp& b) {
  Fp d;
  uint32_t borrow = sub_words(d, a, b);
  Fp pm;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    c += (uint64_t)d.w[i] + p_word(i);
    pm.w[i] = (uint32_t)c;
    c >>= 32;
  }
  return fp_select(mask_of(borrow != 0), pm, d);
}

__device__ __forceinline__ bool fis_zero(const Fp& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) acc |= a.w[i];
  return acc == 0;
}

// a*b*2^-256 mod p: CIOS Montgomery multiplication over 8 x 32-bit words
// with 64-bit products; the result is below 2p before one conditional
// subtract (pallas_ops.mont_mul computes the same residue over 16 x 16 bits).
__device__ __forceinline__ Fp mont_mul(const Fp& a, const Fp& b) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int i = 0; i < NW + 2; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      c += (uint64_t)a.w[j] * b.w[i] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[NW];
    t[NW] = (uint32_t)c;
    t[NW + 1] = (uint32_t)(c >> 32);

    uint32_t m = t[0] * NPRIME32;
    c = ((uint64_t)m * p_word(0) + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      c += (uint64_t)m * p_word(j) + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[NW];
    t[NW - 1] = (uint32_t)c;
    t[NW] = t[NW + 1] + (uint32_t)(c >> 32);
  }
  Fp r, d;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = t[i];
  uint32_t borrow = sub_words(d, r, p_fp());
  return fp_select(mask_of(borrow == 0 || t[NW] != 0), d, r);
}

// ---------------------------------------------------------------------------
// G1 group law (pallas_ops.make_group)
// ---------------------------------------------------------------------------

// The reference kernels' point at infinity: X = Y = 1 (plain), Z = 0
// (pallas_ops._inf_like).
__device__ __forceinline__ G1 g1_inf() {
  G1 p;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    p.X.w[i] = 0;
    p.Y.w[i] = 0;
    p.Z.w[i] = 0;
  }
  p.X.w[0] = 1;
  p.Y.w[0] = 1;
  return p;
}

// Jacobian doubling, a = 0 (dbl-2009-l)
__device__ __forceinline__ G1 pdouble(const G1& p) {
  Fp A = mont_mul(p.X, p.X);
  Fp B = mont_mul(p.Y, p.Y);
  Fp C = mont_mul(B, B);
  Fp t0 = fadd(p.X, B);
  Fp t = fsub(mont_mul(t0, t0), fadd(A, C));
  Fp D = fadd(t, t);
  Fp E = fadd(fadd(A, A), A);
  Fp F = mont_mul(E, E);
  G1 r;
  r.X = fsub(F, fadd(D, D));
  Fp C2 = fadd(C, C);
  Fp C4 = fadd(C2, C2);
  Fp C8 = fadd(C4, C4);
  r.Y = fsub(mont_mul(E, fsub(D, r.X)), C8);
  Fp YZ = mont_mul(p.Y, p.Z);
  r.Z = fadd(YZ, YZ);
  return r;
}

// Complete Jacobian addition (add-2007-bl plus the reference's selects for
// P == Q, P == -Q and either operand at infinity). Like the reference it
// always computes the double as well, so its work does not depend on the
// operands.
__device__ __forceinline__ G1 padd(const G1& p, const G1& q) {
  Fp Z1Z1 = mont_mul(p.Z, p.Z);
  Fp Z2Z2 = mont_mul(q.Z, q.Z);
  Fp U1 = mont_mul(p.X, Z2Z2);
  Fp U2 = mont_mul(q.X, Z1Z1);
  Fp S1 = mont_mul(p.Y, mont_mul(q.Z, Z2Z2));
  Fp S2 = mont_mul(q.Y, mont_mul(p.Z, Z1Z1));
  Fp H = fsub(U2, U1);
  Fp HH = fadd(H, H);
  Fp I = mont_mul(HH, HH);
  Fp J = mont_mul(H, I);
  Fp r = fsub(S2, S1);
  r = fadd(r, r);
  Fp V = mont_mul(U1, I);
  G1 res;
  res.X = fsub(fsub(mont_mul(r, r), J), fadd(V, V));
  Fp SJ = mont_mul(S1, J);
  res.Y = fsub(mont_mul(r, fsub(V, res.X)), fadd(SJ, SJ));
  Fp t1 = fadd(p.Z, q.Z);
  Fp ZZ = fsub(fsub(mont_mul(t1, t1), Z1Z1), Z2Z2);
  res.Z = mont_mul(ZZ, H);

  bool p_inf = fis_zero(p.Z);
  bool q_inf = fis_zero(q.Z);
  bool h0 = fis_zero(H);
  bool r0 = fis_zero(r);
  G1 dbl = pdouble(p);
  res = g1_select(mask_of(h0 && r0 && !p_inf && !q_inf), dbl, res);
  res = g1_select(mask_of(h0 && !r0 && !p_inf && !q_inf), g1_inf(), res);
  res = g1_select(mask_of(q_inf), p, res);
  res = g1_select(mask_of(p_inf), q, res);
  return res;
}

// 4-bit window digit w of a scalar held as 16 x 16-bit limbs
__device__ __forceinline__ uint32_t window_digit(const int32_t* k, int w) {
  return ((uint32_t)k[w >> 2] >> (4 * (w & 3))) & 0xFu;
}

}  // namespace bn256

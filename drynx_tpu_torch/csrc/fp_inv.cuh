// Fp inversion by Bernstein and Yang's constant-time divsteps ("Fast
// constant-time gcd computation and modular inversion", TCHES 2019), in the
// layout of libsecp256k1's portable 32-bit modinv32: numbers as 9 signed
// 30-bit limbs, 20 batches of 30 branch-free divsteps on the low 32 bits of
// f and g, each batch's 2 x 2 transition matrix (entries within 2^30)
// applied to (f, g) and, modulo p, to (d, e), then d brought into [0, p).
// 600 divsteps bound every input below 2^256 (590 suffice with the
// half-delta start, zeta = -1), so g is 0 and f is +-1 at the end.
//
// Why this, on Hopper: the card multiplies 32 x 32 -> 64 bits in one
// instruction, so 30-bit limbs keep every product and sum in one 64-bit
// word; a row's work is ~600 short integer steps and 40 small matrix
// products over four 9-limb numbers, against the Fermat chain's 379
// dependent Montgomery products of 8 x 8 words, and it needs no stack.
//
// Constant time: the batches are always 20, with no exit when g reaches 0,
// and every swap, negation and conditional add is a mask, never a branch
// on the data.
//
// Montgomery form: the stored value is y = x R mod p (R = 2^256). The
// divsteps give y^-1 = x^-1 R^-1, and fp_inv_safegcd returns
// mont_mul(y^-1, R^3 mod p) = x^-1 R, the residue x^(p-2) gives; 0 maps to
// 0, as x^(p-2) does. The constants (p's limbs, p^-1 mod 2^30, R^3 mod p)
// are checked against Python's by tests/test_torch_inverse.py.
#pragma once

#include <stdint.h>

#include "bn256_g1.cuh"

namespace bn256 {

constexpr int kInvBatches = 20;      // batches of divsteps
constexpr int kInvSteps = 30;        // divsteps a batch
constexpr int kS30 = 9;              // 30-bit limbs of a number
constexpr int32_t kM30 = 0x3FFFFFFF;
constexpr uint32_t kPInv30 = 0x00e82557u;   // p^-1 mod 2^30

// sum v[i] 2^(30 i); limbs below the top in [0, 2^30) after each update,
// the top limb signed
struct S30 {
  int32_t v[kS30];
};

// a batch's transition matrix [[u, v], [q, r]], entries in [-2^30, 2^30]
struct Trans {
  int32_t u, v, q, r;
};

// p in signed 30-bit limbs
__device__ __forceinline__ int32_t p30(int i) {
  switch (i) {
    case 0: return 0x1e089667;
    case 1: return 0x2172b1b1;
    case 2: return 0x0b5b59e1;
    case 3: return 0x16e23448;
    case 4: return 0x04dc21ee;
    case 5: return 0x3fb2e186;
    case 6: return 0x387f9aa6;
    case 7: return 0x0078d2a8;
    default: return 0x00008fb5;
  }
}

// R^3 mod p as 8 x 32-bit words
__device__ __forceinline__ uint32_t r3_word(int i) {
  switch (i) {
    case 0: return 0x324a5bb8u;
    case 1: return 0x2af2dfb9u;
    case 2: return 0x54f538a4u;
    case 3: return 0x388f8990u;
    case 4: return 0x96b107a7u;
    case 5: return 0xdf2ff663u;
    case 6: return 0xa2529292u;
    default: return 0x24ebbbb3u;
  }
}

// 30 divsteps on the low 32 bits of f (odd) and g; returns the new zeta =
// -(delta + 1/2) and the batch's matrix, scaled by 2^30 (libsecp256k1's
// secp256k1_modinv32_divsteps_30). u, v, q, r are signed values kept as
// words mod 2^32, so that the left shifts are defined.
__device__ __forceinline__ int32_t inv_divsteps(int32_t zeta, uint32_t f,
                                                uint32_t g, Trans& t) {
  uint32_t u = 1, v = 0, q = 0, r = 1;
#pragma unroll
  for (int i = 0; i < kInvSteps; ++i) {
    // masks: zeta < 0, g odd
    uint32_t m1 = (uint32_t)(zeta >> 31);
    const uint32_t m2 = 0u - (g & 1u);
    // if zeta < 0, negate f, u, v; if g is odd, add them to g, q, r
    const uint32_t x = (f ^ m1) - m1;
    const uint32_t y = (u ^ m1) - m1;
    const uint32_t z = (v ^ m1) - m1;
    g += x & m2;
    q += y & m2;
    r += z & m2;
    // if both, zeta becomes -zeta - 2 and f, u, v gain the new g, q, r
    // (g - f, q - u, r - v), so they hold the old g, q, r: the swap;
    // otherwise zeta becomes zeta - 1
    m1 &= m2;
    zeta = (int32_t)(((uint32_t)zeta ^ m1) - 1u);
    f += g & m1;
    u += q & m1;
    v += r & m1;
    g >>= 1;
    u <<= 1;
    v <<= 1;
  }
  t = Trans{(int32_t)u, (int32_t)v, (int32_t)q, (int32_t)r};
  return zeta;
}

// (d, e) <- (t [d, e] + p [md, me]) / 2^30, with md, me chosen so that the
// low 30 bits are 0 (and so that d, e stay in (-2p, p));
// secp256k1_modinv32_update_de_30
__device__ __forceinline__ void inv_update_de(S30& d, S30& e, const Trans& t) {
  const int32_t sd = d.v[kS30 - 1] >> 31, se = e.v[kS30 - 1] >> 31;
  int32_t md = (t.u & sd) + (t.v & se);
  int32_t me = (t.q & sd) + (t.r & se);
  int64_t cd = (int64_t)t.u * d.v[0] + (int64_t)t.v * e.v[0];
  int64_t ce = (int64_t)t.q * d.v[0] + (int64_t)t.r * e.v[0];
  md -= (int32_t)((kPInv30 * (uint32_t)cd + (uint32_t)md) & (uint32_t)kM30);
  me -= (int32_t)((kPInv30 * (uint32_t)ce + (uint32_t)me) & (uint32_t)kM30);
  cd += (int64_t)p30(0) * md;
  ce += (int64_t)p30(0) * me;
  cd >>= 30;
  ce >>= 30;
#pragma unroll
  for (int i = 1; i < kS30; ++i) {
    cd += (int64_t)t.u * d.v[i] + (int64_t)t.v * e.v[i];
    ce += (int64_t)t.q * d.v[i] + (int64_t)t.r * e.v[i];
    cd += (int64_t)p30(i) * md;
    ce += (int64_t)p30(i) * me;
    d.v[i - 1] = (int32_t)cd & kM30;
    e.v[i - 1] = (int32_t)ce & kM30;
    cd >>= 30;
    ce >>= 30;
  }
  d.v[kS30 - 1] = (int32_t)cd;
  e.v[kS30 - 1] = (int32_t)ce;
}

// (f, g) <- t [f, g] / 2^30, exact; secp256k1_modinv32_update_fg_30
__device__ __forceinline__ void inv_update_fg(S30& f, S30& g, const Trans& t) {
  int64_t cf = (int64_t)t.u * f.v[0] + (int64_t)t.v * g.v[0];
  int64_t cg = (int64_t)t.q * f.v[0] + (int64_t)t.r * g.v[0];
  cf >>= 30;
  cg >>= 30;
#pragma unroll
  for (int i = 1; i < kS30; ++i) {
    cf += (int64_t)t.u * f.v[i] + (int64_t)t.v * g.v[i];
    cg += (int64_t)t.q * f.v[i] + (int64_t)t.r * g.v[i];
    f.v[i - 1] = (int32_t)cf & kM30;
    g.v[i - 1] = (int32_t)cg & kM30;
    cf >>= 30;
    cg >>= 30;
  }
  f.v[kS30 - 1] = (int32_t)cf;
  g.v[kS30 - 1] = (int32_t)cg;
}

// carry each limb's bits above 30 into the next
__device__ __forceinline__ void inv_carry(S30& r) {
#pragma unroll
  for (int i = 0; i < kS30 - 1; ++i) {
    r.v[i + 1] += r.v[i] >> 30;
    r.v[i] &= kM30;
  }
}

// d in (-2p, p) -> d (or -d if sign < 0) in [0, p), limbs in [0, 2^30);
// secp256k1_modinv32_normalize_30
__device__ __forceinline__ void inv_normalize(S30& d, int32_t sign) {
  int32_t add = d.v[kS30 - 1] >> 31;
  const int32_t neg = sign >> 31;
#pragma unroll
  for (int i = 0; i < kS30; ++i) {
    d.v[i] += p30(i) & add;
    d.v[i] = (d.v[i] ^ neg) - neg;
  }
  inv_carry(d);
  add = d.v[kS30 - 1] >> 31;
#pragma unroll
  for (int i = 0; i < kS30; ++i) d.v[i] += p30(i) & add;
  inv_carry(d);
}

__device__ __forceinline__ S30 s30_of(const Fp& a) {
  S30 r;
#pragma unroll
  for (int i = 0; i < kS30 - 1; ++i) {
    const int b = 30 * i, k = b >> 5, s = b & 31;
    uint32_t x = a.w[k] >> s;
    if (s > 2) x |= a.w[k + 1] << (32 - s);
    r.v[i] = (int32_t)(x & (uint32_t)kM30);
  }
  r.v[kS30 - 1] = (int32_t)(a.w[NW - 1] >> 16);
  return r;
}

// limbs in [0, 2^30), value below 2^256
__device__ __forceinline__ Fp fp_of(const S30& a) {
  Fp r;
  uint64_t acc = 0;
  int bits = 0, k = 0;
#pragma unroll
  for (int i = 0; i < kS30; ++i) {
    acc |= (uint64_t)(uint32_t)a.v[i] << bits;
    bits += 30;
    if (bits >= 32 && k < NW) {
      r.w[k++] = (uint32_t)acc;
      acc >>= 32;
      bits -= 32;
    }
  }
  if (k < NW) r.w[k] = (uint32_t)acc;
  return r;
}

// x^(p-2) of a Montgomery residue y = x R, canonical in [0, p): x^-1 R
__device__ __forceinline__ Fp fp_inv_safegcd(const Fp& y) {
  S30 d, e, f, g = s30_of(y);
#pragma unroll
  for (int i = 0; i < kS30; ++i) {
    d.v[i] = 0;
    e.v[i] = i == 0;
    f.v[i] = p30(i);
  }
  int32_t zeta = -1;
#pragma unroll 1
  for (int b = 0; b < kInvBatches; ++b) {
    Trans t;
    zeta = inv_divsteps(zeta, (uint32_t)f.v[0], (uint32_t)g.v[0], t);
    inv_update_de(d, e, t);
    inv_update_fg(f, g, t);
  }
  inv_normalize(d, f.v[kS30 - 1]);
  Fp r3;
#pragma unroll
  for (int i = 0; i < NW; ++i) r3.w[i] = r3_word(i);
  return mont_mul(fp_of(d), r3);
}

}  // namespace bn256

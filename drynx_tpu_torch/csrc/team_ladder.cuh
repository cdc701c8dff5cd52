// The variable-base ladder k*P computed by a team of lanes, one body over
// G1 (coordinates in Fp; g1_ops.cu's scalar_mul_kernel) and over G2, the
// sextic twist (coordinates in Fp2; g2_ops.cu's g2_scalar_mul_kernel).
//
// 4-bit windows MSB-first over the table T[d] = d*P (T[2j] = 2T[j],
// T[2j+1] = T[2j] + P): 4 doublings, then a complete add of the entry the
// digit names. The windows depend on each other, so the team splits each
// group-law step: the independent products of a formula level are spread
// over the lanes (team.cuh's team_products) and every lane reads them all
// back, so every lane holds the same point, H, r and select masks with no
// further exchange. The double (dbl-2009-l) is 3 levels of 3, 3 and 1
// products (the last one each lane computes itself); the complete add
// (add-2007-bl) runs the double it may select beside its first three
// levels:
//   1. Z1^2, Z2^2, X1^2, Y1^2
//   2. U1 = X1 Z2^2, U2 = X2 Z1^2, Z2 Z2^2, Z1 Z1^2, (Z1 + Z2)^2, B^2,
//      (X1 + B)^2, E^2
//   3. S1, S2, I = (2H)^2, ZZ H, E (D - X3'), Y1 Z1
//   4. J = H I, V = U1 I, r^2
//   5. S1 J, r (V - X3)
// and then takes the reference's selects in its order (P = Q, P = -Q,
// either operand at infinity; bn256_g1.cuh padd, make_g2_group). The
// formulas are the plain versions' on canonical residues (a square taken
// as the product a a gives the same residue as any square), so a kernel's
// Jacobian limbs equal its plain version's byte for byte. The digits are
// secret: the table sits in shared memory, written by lane 0 and published
// by a __syncwarp, and each window's entry is chosen by reading all 16
// entries under masks, never by an indexed load.
#pragma once

#include <stdint.h>

#include "team.cuh"

namespace bn256 {

constexpr int kLadderEntries = 16;   // 4-bit windows
constexpr int kLadderWidth = 8;      // the most products in one level

// A point of the twist E'(Fp2), Jacobian
struct G2 {
  Fp2 X, Y, Z;
};

__device__ __forceinline__ G2 load_g2(const int32_t* src) {
  return G2{load_fp2(src), load_fp2(src + 2 * NL16), load_fp2(src + 4 * NL16)};
}

__device__ __forceinline__ void store_g2(int32_t* dst, const G2& p) {
  store_fp2(dst, p.X);
  store_fp2(dst + 2 * NL16, p.Y);
  store_fp2(dst + 4 * NL16, p.Z);
}

// The group law's field operations, overloaded on Fp2 beside bn256_g1.cuh's
// on Fp, so that one body serves both groups
__device__ __forceinline__ Fp2 fadd(const Fp2& a, const Fp2& b) {
  return f2add(a, b);
}

__device__ __forceinline__ Fp2 fsub(const Fp2& a, const Fp2& b) {
  return f2sub(a, b);
}

__device__ __forceinline__ bool fis_zero(const Fp2& a) { return f2is_zero(a); }

template <typename T>
__device__ __forceinline__ T times8(const T& c) {
  const T c2 = fadd(c, c);
  const T c4 = fadd(c2, c2);
  return fadd(c4, c4);
}

__device__ __forceinline__ G1 point_select(uint32_t m, const G1& a,
                                           const G1& b) {
  return g1_select(m, a, b);
}

__device__ __forceinline__ G2 point_select(uint32_t m, const G2& a,
                                           const G2& b) {
  return G2{f2select(m, a.X, b.X), f2select(m, a.Y, b.Y),
            f2select(m, a.Z, b.Z)};
}

// The reference kernels' point at infinity: X = Y = plain 1 (in Fp2, the
// real part), Z = 0
template <typename P>
__device__ P point_inf();

template <>
__device__ __forceinline__ G1 point_inf<G1>() {
  return g1_inf();
}

template <>
__device__ __forceinline__ G2 point_inf<G2>() {
  Fp one = fp_zero();
  one.w[0] = 1;
  const Fp2 x{one, fp_zero()};
  const Fp2 z{fp_zero(), fp_zero()};
  return G2{x, x, z};
}

// A row's table and its team's two exchange buffers, in shared memory
template <typename T, typename P>
struct LadderMem {
  T xch[2][kLadderWidth];
  P tab[kLadderEntries];
};

// 2P (pdouble, dbl-2009-l)
template <typename T, int kSize, typename P>
__device__ __forceinline__ P team_double(Team<T, kSize, kLadderWidth>& tm,
                                         const P& p) {
  const T* r = team_products<3>(tm, {p.X, p.Y, p.Y}, {p.X, p.Y, p.Z});
  const T A = r[0], B = r[1], YZ = r[2];
  const T E = fadd(fadd(A, A), A);
  const T XB = fadd(p.X, B);
  r = team_products<3>(tm, {B, XB, E}, {B, XB, E});
  const T C = r[0];
  const T t = fsub(r[1], fadd(A, C));
  const T D = fadd(t, t);
  P q;
  q.X = fsub(r[2], fadd(D, D));
  q.Y = fsub(team_mul(E, fsub(D, q.X)), times8(C));
  q.Z = fadd(YZ, YZ);
  return q;
}

// P + Q, complete (padd, add-2007-bl and the reference's selects)
template <typename T, int kSize, typename P>
__device__ __forceinline__ P team_add(Team<T, kSize, kLadderWidth>& tm,
                                      const P& p, const P& q) {
  const T* r = team_products<4>(tm, {p.Z, q.Z, p.X, p.Y},
                                {p.Z, q.Z, p.X, p.Y});
  const T Z1Z1 = r[0], Z2Z2 = r[1], A = r[2], B = r[3];
  const T E = fadd(fadd(A, A), A);
  const T XB = fadd(p.X, B);
  const T t1 = fadd(p.Z, q.Z);
  r = team_products<8>(tm, {p.X, q.X, q.Z, p.Z, t1, B, XB, E},
                       {Z2Z2, Z1Z1, Z2Z2, Z1Z1, t1, B, XB, E});
  const T U1 = r[0], U2 = r[1], Z2c = r[2], Z1c = r[3];
  const T ZZ = fsub(fsub(r[4], Z1Z1), Z2Z2);
  const T C = r[5];
  const T t = fsub(r[6], fadd(A, C));
  const T D = fadd(t, t);
  P dbl;
  dbl.X = fsub(r[7], fadd(D, D));
  const T H = fsub(U2, U1);
  const T HH = fadd(H, H);
  r = team_products<6>(tm, {p.Y, q.Y, HH, ZZ, E, p.Y},
                       {Z2c, Z1c, HH, H, fsub(D, dbl.X), p.Z});
  const T S1 = r[0], S2 = r[1], I = r[2];
  P res;
  res.Z = r[3];
  dbl.Y = fsub(r[4], times8(C));
  dbl.Z = fadd(r[5], r[5]);
  T rr = fsub(S2, S1);
  rr = fadd(rr, rr);
  r = team_products<3>(tm, {H, U1, rr}, {I, I, rr});
  const T J = r[0], V = r[1];
  res.X = fsub(fsub(r[2], J), fadd(V, V));
  r = team_products<2>(tm, {S1, rr}, {J, fsub(V, res.X)});
  res.Y = fsub(r[1], fadd(r[0], r[0]));

  const bool p_inf = fis_zero(p.Z);
  const bool q_inf = fis_zero(q.Z);
  const bool h0 = fis_zero(H);
  const bool r0 = fis_zero(rr);
  res = point_select(mask_of(h0 && r0 && !p_inf && !q_inf), dbl, res);
  res = point_select(mask_of(h0 && !r0 && !p_inf && !q_inf), point_inf<P>(),
                     res);
  res = point_select(mask_of(q_inf), p, res);
  res = point_select(mask_of(p_inf), q, res);
  return res;
}

// the entry the digit d names, all 16 read under masks
template <typename P>
__device__ __forceinline__ P ladder_pick(const P* tab, uint32_t d) {
  P s = tab[0];
#pragma unroll 1
  for (int v = 1; v < kLadderEntries; ++v) {
    s = point_select(mask_of(d == (uint32_t)v), tab[v], s);
  }
  return s;
}

// k*P of the team's row over the low n_windows digits of k (16 x 16-bit
// limbs); tab is the row's table in shared memory. Every lane returns the
// result.
template <typename T, int kSize, typename P>
__device__ __forceinline__ P team_ladder(Team<T, kSize, kLadderWidth>& tm,
                                         P* tab, const P& base,
                                         const int32_t* k, int n_windows) {
  P prev = base;
  if (tm.slot == 0) {
    tab[0] = point_inf<P>();
    tab[1] = base;
  }
  __syncwarp(tm.mask);
#pragma unroll 1
  for (int d = 2; d < kLadderEntries; ++d) {
    // T[d - 1] is in prev; T[d / 2] in the table (written by lane 0 and
    // published by the exchanges since)
    prev = (d % 2 == 0) ? team_double(tm, tab[d / 2])
                        : team_add(tm, prev, base);
    if (tm.slot == 0) tab[d] = prev;
    __syncwarp(tm.mask);
  }
  P acc = ladder_pick(tab, window_digit(k, n_windows - 1));
#pragma unroll 1
  for (int w = n_windows - 2; w >= 0; --w) {
#pragma unroll 1
    for (int s = 0; s < 4; ++s) acc = team_double(tm, acc);
    acc = team_add(tm, acc, ladder_pick(tab, window_digit(k, w)));
  }
  return acc;
}

}  // namespace bn256

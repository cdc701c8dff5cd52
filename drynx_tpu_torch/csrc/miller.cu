// The optimal-ate Miller loop of range-proof verification, one pairing per
// team of six threads. It replaces the Pallas TPU kernel _miller_kernel of
// drynx_tpu/crypto/pallas_pairing.py; drynx_tpu_torch/crypto/cuda_pairing.py
// binds it with ctypes (miller_flat) and holds it beside its plain PyTorch
// version (miller_plain).
//
// The loop walks the 65 bits of 6u + 2 below its leading one. Each step
// doubles T (the twist point, Jacobian) and multiplies f^2 by the tangent
// line scaled by 2YZ^3; where the bit is set (23 of the 65 bits) it then
// adds Q to T and multiplies f by the line through T and Q (madd-2007-bl,
// the line negated against pairing.py's). The bits are public constants,
// the same in every thread, so the add runs only at the set bits and no
// thread diverges. Two more adds take in pi(Q) = (conj(qx) g12,
// conj(qy) g13) and -pi^2(Q) = (qx g22, qy), whose three products by
// constants the team computes at the end. A vertical line (T and the
// added point share x, possible only on crafted inputs) contributes 1 and
// leaves T as it was.
//
// Team layout. f = sum_k c_k w^k has six Fp2 slots (w^6 = XI); lane s of a
// team owns slot c_s in registers. Five teams share a warp (lanes 0-29;
// lanes 30 and 31 leave at once), so no team straddles two warps, and a
// block of four warps runs 20 pairings. Team lanes trade values through
// two buffers of six Fp2 slots per team in shared memory, written in turn,
// with __syncwarp on the team's six lanes after each write (the exchange
// of team.cuh, shared with the other team kernels). Every lane runs the
// same instructions on its own operands:
//   - f^2: lane m computes its slot from four Fp2 products of slots,
//     c_i c_j with i + j = m (mod 6), the cross terms doubled, XI where
//     i + j >= 6 (odd slots need three; the fourth is computed and
//     masked off);
//   - f * l with l = l0 + l1 w + l3 w^3: lane m takes f_m l0, f_{m-1} l1
//     and f_{m-3} l3 (XI where the index wraps), three products;
//   - T and the line: the products of one formula level are spread over
//     the lanes (the double step is 4, 6 and 3 products in three levels,
//     the add step 1, 2, 4, 6 and 3 in five) and every lane reads all of
//     them back, so each lane holds the same T, line and vertical-line mask
//     with no further exchange.
// Each lane's chain is 10 Fp2 products (30 Montgomery products) per double
// step and 8 (24) per add step, against 121 and 96 for one thread per
// pairing, and 6 threads per pairing keep six times the warps in flight.
// Every Fp2 product goes through one function body (mul2), so the loop's
// code stays small.
//
// Output bytes. Line values and Jacobian coordinates are not canonical, so
// the output equals the reference's only after the final exponentiation;
// it equals the plain version's byte for byte. T and the lines are the
// same polynomials in T, Q and P as in _miller_kernel (pallas_pairing.py:
// 343-432), only spread over the lanes, and f's update is Fp12 arithmetic
// on canonical residues: any correct way to compute f^2 l or f l gives the
// same residues, hence the same bytes.
//
// What bounds it now: the latency of each lane's chain of ~2,550 dependent
// Montgomery products, ~1.3 us each for a warp alone on its scheduler (one
// pairing takes 3.4 ms on an H100 80GB HBM3 at 700 W), against a bound of
// ~10,300 products per pairing in the function (65 x 121 for the double
// steps, 25 x 96 for the adds) at the card's multiply rate; the team issues
// ~16,300 per pairing (the fourth square term of the odd slots, the idle
// lanes of the G2 levels and of each warp). Memory traffic is 1 KB per
// pairing. ptxas: 255 registers, a 776-byte stack, 232 bytes of spill
// stores; so 8 warps an SM, and the verifier's 13,500 pairings (2,700 warps)
// run in three rounds. Capping the registers (168 or 128) spills more and is
// slower (scripts/torch_team_variants.py), as was inlining mul2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "team.cuh"

using namespace bn256;

namespace {

constexpr int kTeam = 6;                    // lanes per pairing
constexpr int kTeamsPerWarp = 32 / kTeam;   // 5
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPairingsPerBlock = kWarps * kTeamsPerWarp;
constexpr int kF12Words = 6 * 2 * NL16;
constexpr int kFp2Words = 2 * NL16;
// 6u + 2 = kAteHi * 2^64 + kAteLo (params.U); the loop reads bits 64..0
constexpr uint64_t kAteLo = 0x1ec817a18a131208ull;
constexpr uint32_t kAteHi = 2u;
constexpr int kAteTop = 64;

inline int blocks_for(int n) {
  return (n + kPairingsPerBlock - 1) / kPairingsPerBlock;
}

struct G2 {
  Fp2 X, Y, Z;
};

struct Line {
  Fp2 l0, l1, l3;
};

// XI^((p-1)/3), XI^((p-1)/2), XI^((p^2-1)/3) as Montgomery Fp2
// (refimpl._G12, _G13, _G22): the Frobenius maps' twist factors
__constant__ uint32_t kFrob[3][2][NW] = {
    {{0xd3816f2cu, 0xf8606916u, 0x26de927eu, 0x1e5c0d79u, 0x6d81185eu,
      0xbc45f394u, 0xaa738091u, 0x80752a25u},
     {0x01832e57u, 0x4f59e37cu, 0xc2bbbfe4u, 0xae6be39au, 0x697512f8u,
      0xe04ea1bbu, 0xfc40e10eu, 0x3097caa8u}},
    {{0xfb7708fau, 0x18dbee03u, 0x02c843c7u, 0x1e7601a6u, 0xcdb231cbu,
      0x5dde0688u, 0xc605a524u, 0x86db5cf2u},
     {0x3653ee20u, 0x19da7133u, 0xc6ed6019u, 0x7eaaf34fu, 0xa60cdd1du,
      0xc4ba3a29u, 0xbcc9df79u, 0x75281311u}},
    {{0xe1ada57du, 0x12d3cef5u, 0x3753babbu, 0xe2eca146u, 0xddccf750u,
      0x0ca41e40u, 0x0397e04cu, 0x55133706u},
     {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u}}};

__device__ __forceinline__ Fp2 frob_factor(int k) {
  Fp2 r;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    r.c0.w[i] = kFrob[k][0][i];
    r.c1.w[i] = kFrob[k][1][i];
  }
  return r;
}

__device__ __forceinline__ uint32_t ate_bit(int b) {
  return b >= 64 ? (kAteHi >> (b - 64)) & 1u : (uint32_t)(kAteLo >> b) & 1u;
}

// The terms of slot m of f^2, one byte each: i | j << 3, then flags
constexpr uint32_t kXiTerm = 1u << 6;    // times XI (i + j >= 6)
constexpr uint32_t kTwice = 1u << 7;     // a cross term, doubled
__host__ __device__ constexpr uint32_t term(int i, int j) {
  return (uint32_t)i | ((uint32_t)j << 3) | (i + j >= 6 ? kXiTerm : 0u) |
         (i != j ? kTwice : 0u);
}
__host__ __device__ constexpr uint32_t terms(uint32_t a, uint32_t b,
                                             uint32_t c, uint32_t d) {
  return a | (b << 8) | (c << 16) | (d << 24);
}
// the fourth term of an odd slot: a placeholder (c_0 c_0 with flags no
// term has), masked off
constexpr uint32_t kUnused = kXiTerm | kTwice;

__device__ __forceinline__ uint32_t sqr_terms(int m) {
  switch (m) {
    case 0: return terms(term(0, 0), term(3, 3), term(1, 5), term(2, 4));
    case 1: return terms(term(0, 1), term(2, 5), term(3, 4), kUnused);
    case 2: return terms(term(1, 1), term(4, 4), term(0, 2), term(3, 5));
    case 3: return terms(term(0, 3), term(1, 2), term(4, 5), kUnused);
    case 4: return terms(term(2, 2), term(5, 5), term(0, 4), term(1, 3));
    default: return terms(term(0, 5), term(1, 4), term(2, 3), kUnused);
  }
}

// A lane's place in its team: two exchange buffers of six Fp2 slots
using MillerTeam = Team<Fp2, kTeam, kTeam>;

// T <- 2T and the tangent at T scaled by 2YZ^3: l0 = 2YZ^3 yp,
// l1 = -3X^2 Z^2 xp, l3 = 3X^3 - 2Y^2; the point double is make_group's
// dbl-2009-l
__device__ __forceinline__ void dbl_line(MillerTeam& tm, G2& T,
                                         const Fp2& xp, const Fp2& yp,
                                         Line& l) {
  const Fp2* r = team_products<4>(tm, {T.X, T.Y, T.Z, T.Y},
                                  {T.X, T.Y, T.Z, T.Z});
  const Fp2 A = r[0], Bv = r[1], zz = r[2], YZ = r[3];
  const Fp2 E = f2add(f2add(A, A), A);
  const Fp2 XB = f2add(T.X, Bv);
  r = team_products<6>(tm, {A, E, Bv, XB, E, YZ}, {T.X, zz, Bv, XB, E, zz});
  const Fp2 AX = r[0], Ezz = r[1], Cv = r[2], S = r[3], EE = r[4];
  const Fp2 YZ3 = r[5];
  l.l3 = f2sub(f2add(f2add(AX, AX), AX), f2add(Bv, Bv));
  const Fp2 t = f2sub(S, f2add(A, Cv));
  const Fp2 D = f2add(t, t);
  const Fp2 X3 = f2sub(EE, f2add(D, D));
  const Fp2 C2 = f2add(Cv, Cv);
  const Fp2 C8 = f2add(f2add(C2, C2), f2add(C2, C2));
  r = team_products<3>(tm, {f2neg(Ezz), f2add(YZ3, YZ3), E},
                       {xp, yp, f2sub(D, X3)});
  l.l1 = r[0];
  l.l0 = r[1];
  T.Y = f2sub(r[2], C8);
  T.X = X3;
  T.Z = f2add(YZ, YZ);
}

// Where the line is not vertical: T <- T + (qx, qy) and the line through
// them, l0 = HZ yp, l1 = -r xp, l3 = r qx - HZ qy, H = qx Z^2 - X,
// r = qy Z^3 - Y (madd-2007-bl). Returns the mask of a line that is not
// vertical; T is left as it was elsewhere.
__device__ __forceinline__ uint32_t add_line(MillerTeam& tm, G2& T,
                                             const Fp2& qx, const Fp2& qy,
                                             const Fp2& xp, const Fp2& yp,
                                             Line& l) {
  const Fp2 zz = mul2(T.Z, T.Z);
  const Fp2* r = team_products<2>(tm, {qx, T.Z}, {zz, zz});
  const Fp2 Hm = f2sub(r[0], T.X);
  const Fp2 Zzz = r[1];
  const Fp2 ZH = f2add(T.Z, Hm);
  r = team_products<4>(tm, {qy, Hm, Hm, ZH}, {Zzz, T.Z, Hm, ZH});
  const Fp2 r1 = f2sub(r[0], T.Y);
  const Fp2 HmZ = r[1], HH = r[2];
  const Fp2 Z3 = f2sub(f2sub(r[3], zz), HH);
  const Fp2 I4 = f2add(f2add(HH, HH), f2add(HH, HH));
  const Fp2 rm = f2add(r1, r1);
  r = team_products<6>(tm, {HmZ, f2neg(r1), r1, Hm, T.X, rm},
                       {yp, xp, qx, I4, I4, rm});
  l.l0 = r[0];
  l.l1 = r[1];
  const Fp2 rq = r[2], J = r[3], V = r[4];
  const Fp2 X3 = f2sub(f2sub(r[5], J), f2add(V, V));
  r = team_products<3>(tm, {HmZ, T.Y, rm}, {qy, J, f2sub(V, X3)});
  l.l3 = f2sub(rq, r[0]);
  const Fp2 Y3 = f2sub(r[2], f2add(r[1], r[1]));
  const uint32_t keep = ~mask_of(f2is_zero(Hm));
  T.X = f2select(keep, X3, T.X);
  T.Y = f2select(keep, Y3, T.Y);
  T.Z = f2select(keep, Z3, T.Z);
  return keep;
}

// This lane's slot of f^2, f's slots being c across the team
__device__ __forceinline__ Fp2 sqr_slot(MillerTeam& tm, uint32_t sqr,
                                        const Fp2& c) {
  const Fp2* f = tm.exchange(c);
  const Fp2 zero{fp_zero(), fp_zero()};
  Fp2 single = zero, cross = zero;
#pragma unroll 1
  for (int k = 0; k < 4; ++k) {
    const uint32_t t = (sqr >> (8 * k)) & 0xFFu;
    Fp2 p = mul2(f[t & 7u], f[(t >> 3) & 7u]);
    p = f2select(mask_of(t & kXiTerm), f2mul_xi(p), p);
    const uint32_t used = mask_of(t != kUnused);
    const uint32_t twice = mask_of(t & kTwice);
    single = f2add(single, f2select(used & ~twice, p, zero));
    cross = f2add(cross, f2select(used & twice, p, zero));
  }
  return f2add(single, f2add(cross, cross));
}

// This lane's slot of f * (l0 + l1 w + l3 w^3), f's slots being c
__device__ __forceinline__ Fp2 line_slot(MillerTeam& tm, const Fp2& c,
                                         const Line& l) {
  const Fp2* f = tm.exchange(c);
  const int m = tm.slot;
  const Fp2 a = mul2(f[m], l.l0);
  const Fp2 b = mul2(f[m == 0 ? 5 : m - 1], l.l1);
  const Fp2 d = mul2(f[m < 3 ? m + 3 : m - 3], l.l3);
  return f2add(f2add(a, f2select(mask_of(m == 0), f2mul_xi(b), b)),
               f2select(mask_of(m < 3), f2mul_xi(d), d));
}

// p: (n, 2, 16) affine G1 (x, y); q: (n, 2, 2, 16) affine twist points
// (x, y); all Montgomery
__global__ void __launch_bounds__(kThreads)
    miller_kernel(const int32_t* __restrict__ p, const int32_t* __restrict__ q,
                  int32_t* __restrict__ out, int n) {
  __shared__ Fp2 xch[kWarps * kTeamsPerWarp][2][kTeam];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int team = lane / kTeam;
  if (team == kTeamsPerWarp) return;   // lanes 30 and 31
  const int i = (blockIdx.x * kWarps + warp) * kTeamsPerWarp + team;
  if (i >= n) return;                  // the whole team leaves
  const int slot = lane - kTeam * team;
  MillerTeam tm{xch[warp * kTeamsPerWarp + team],
                team_mask<kTeam>(kTeam * team), slot, 0};
  const uint32_t sqr = sqr_terms(slot);
  const int32_t* pi = p + (size_t)i * 2 * NL16;
  const int32_t* qi = q + (size_t)i * 2 * kFp2Words;
  const Fp2 xp{load_fp_v(pi), fp_zero()};
  const Fp2 yp{load_fp_v(pi + NL16), fp_zero()};
  G2 T{load_fp2(qi), load_fp2(qi + kFp2Words), Fp2{fp_one(), fp_zero()}};
  Fp2 c{fp_select(mask_of(slot == 0), fp_one(), fp_zero()), fp_zero()};
  Line l;
#pragma unroll 1
  for (int b = kAteTop; b >= 0; --b) {
    dbl_line(tm, T, xp, yp, l);
    c = line_slot(tm, sqr_slot(tm, sqr, c), l);
    if (ate_bit(b)) {
      const uint32_t keep = add_line(tm, T, load_fp2(qi),
                                     load_fp2(qi + kFp2Words), xp, yp, l);
      c = f2select(keep, line_slot(tm, c, l), c);
    }
  }
  const Fp2 qx = load_fp2(qi), qy = load_fp2(qi + kFp2Words);
  const Fp2* r = team_products<3>(tm, {f2conj(qx), f2conj(qy), qx},
                                  {frob_factor(0), frob_factor(1),
                                   frob_factor(2)});
  const Fp2 q1x = r[0], q1y = r[1], nq2x = r[2];
  uint32_t keep = add_line(tm, T, q1x, q1y, xp, yp, l);
  c = f2select(keep, line_slot(tm, c, l), c);
  keep = add_line(tm, T, nq2x, qy, xp, yp, l);
  c = f2select(keep, line_slot(tm, c, l), c);
  store_fp2(out + (size_t)i * kF12Words + slot * kFp2Words, c);
}

}  // namespace

extern "C" {

int miller(const int32_t* p, const int32_t* q, int32_t* out, int n,
           void* stream) {
  miller_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(p, q,
                                                                       out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"

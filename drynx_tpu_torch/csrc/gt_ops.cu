// Fp12 (GT) kernels of range-proof creation and verification. Each
// replaces one Pallas TPU kernel of drynx_tpu/crypto/pallas_pairing.py;
// drynx_tpu_torch/crypto/cuda_pairing.py binds them with ctypes and holds
// each beside its plain PyTorch version. f12_wpow, f12_mul,
// f12_mulreduce8, f12_inv, f12_csqr and f12_pow give each row a team of
// threads (their notes below; the first three one team product, f12_pow
// two in one round, f12_wpow and f12_csqr one team cyclotomic square),
// f12_slotmul each Fp2 slot a thread.
//
//   f12_mul         replaces _f12_mul_kernel         (f12_mul_flat)
//   f12_mulreduce8  replaces _f12_mulreduce8_kernel  (f12_mulreduce8_flat)
//   f12_inv         replaces _f12_inv_kernel         (f12_inv_flat)
//   f12_csqr        replaces _f12_csqr_kernel        (f12_csqr_flat)
//   f12_slotmul     replaces _f12_slotmul_kernel     (f12_slotmul_flat)
//   f12_wpow        replaces _f12_wpow_kernel        (f12_wpow_flat)
//   f12_pow         replaces _f12_pow_kernel         (f12_pow_flat)
//
// What bounds them: an Fp12 product is 54 Montgomery products (18 Fp2
// products of 3), 256 32-bit multiply-adds each, against 2 x 384 bytes in
// and 384 out; mulreduce8 does 7 products per 3 KB read. Both are
// operation-bound by that count (about 40 multiply-adds per byte against
// the card's ~5 per byte). An Fp12 value is 96 32-bit words, so one
// thread a row would hold most of its registers in the operands alone:
// every kernel here gives a lane a few Fp2 slots of each value instead.
// Rows are read with 16-byte vector loads. The window gather that feeds
// mulreduce8 in the fixed-base GT powers stays a torch index op (an
// intermediate of 64 entries x 768 bytes per power); fusing it here is
// later work.
//
// The verification kernels are the same kind of chain. f12_csqr's 9 Fp2
// squares and f12_inv's tower inverse are spread over a team (their notes
// below). f12_slotmul's 18 products a row (six Fp2 products by constants)
// are independent, one Fp2 product a thread (its note below).
//
// f12_pow is the reference's first power, square-and-multiply-always
// LSB-first over n_bits bits: per bit one product (kept by mask where the
// bit is set) and one square, 108 Montgomery products per bit as two
// products. No path of the port runs it (the windowed power replaced it
// in the reference too); it is kept so that every Pallas kernel has its
// counterpart.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fp_inv.cuh"
#include "team.cuh"

using namespace bn256;

namespace {

constexpr int kThreads = 128;
constexpr int kF12Words = 6 * 2 * NL16;   // int32 words of one Fp12 value
constexpr int kPowEntries = 8;           // f12_wpow: 3-bit windows

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

// f12_slotmul: out[k] = (conj(a[k]) if conj else a[k]) * c[k], as
// _f12_slotmul_kernel (pallas_pairing.py:645): the Frobenius maps of the
// flat tower (c = powers of XI^((p^e - 1)/6), conj for odd e) and conj6
// (c = +-1); c is one (6, 2, 16) Montgomery array shared by every row.
//
// The six slots of a row do not depend on each other, so each Fp2 slot has
// a thread of its own: thread t takes slot t % 6 of row t / 6, which is the
// t-th Fp2 of the flat (6N, 2, 16) input, 128 contiguous bytes read and
// written with 16-byte vector accesses; it conjugates where the map does
// and runs one Fp2 product (3 Montgomery products) by c[t % 6], which each
// block copies into shared memory first. The same tower functions as the
// plain version, so the output is its bytes. No exchange, no barrier past
// the copy of c.
//
// What bounds it: bytes at the verifier's 13,500 rows (81,000 threads, one
// wave; 768 bytes in and out a row against 18 Montgomery products), the
// launch at N = 1 (the final exponentiation's, 6 threads). The one thread
// a row it replaces ran all six slots' 18 products as one thread's chain.
// kSlotmulSlots is the slots a thread takes: 1 here; 6 is one thread a row
// (scripts/torch_team_variants.py times both). On an H100 80GB HBM3 at
// 700 W, device time from a CUDA graph: 0.019 ms at 13,500 rows and
// 0.0045 at N = 1, against 0.038 and 0.030 for one thread a row; through
// the wrapper every launch takes 0.024-0.058 ms, the host's launch path.
// ptxas: 62 registers, no stack.
constexpr int kSlotmulSlots = 1;
static_assert(6 % kSlotmulSlots == 0, "a thread's slots lie in one row");

__global__ void __launch_bounds__(kThreads)
    f12_slotmul_kernel(const int32_t* __restrict__ a,
                       const int32_t* __restrict__ c,
                       int32_t* __restrict__ out, int n_threads, int conj) {
  __shared__ __align__(16) int32_t cs[kF12Words];
  for (int j = threadIdx.x; j < kF12Words; j += kThreads) cs[j] = c[j];
  __syncthreads();
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_threads) return;
#pragma unroll
  for (int s = 0; s < kSlotmulSlots; ++s) {
    const int slot = t * kSlotmulSlots + s;
    const size_t off = (size_t)slot * 2 * NL16;
    const Fp2 x = load_fp2(a + off);
    store_fp2(out + off, f2mul(conj ? f2conj(x) : x,
                               load_fp2(cs + 2 * NL16 * (slot % 6))));
  }
}

// 3-bit window w (bits 3w..3w+2) of a scalar held as 16 x 16-bit limbs; a
// window may straddle two limbs, and bits past the top limb are 0
__device__ __forceinline__ uint32_t window3(const int32_t* k, int w) {
  const int limb = (3 * w) >> 4, s = (3 * w) & 15;
  uint32_t d = (uint32_t)k[limb] >> s;
  if (s > 13 && limb + 1 < NL16) d |= (uint32_t)k[limb + 1] << (16 - s);
  return d & 7u;
}

// f12_wpow: f^k over ceil(n_bits / 3) windows MSB-first, as
// _f12_wpow_kernel (pallas_pairing.py:572): the table T[d] = f^d (T[2j] =
// T[j]^2, T[2j+1] = T[2j] f), then per window three squares and a product
// with the entry its digit picks. cyc swaps every square, in the table and
// in the chain, for Granger-Scott's cyclotomic one: the kernel computes
// that function itself, which is the square only on GPhi12, so on any f
// it gives the plain version's bytes.
//
// A team of kPowTeam lanes computes one row; lane t owns the kPowSlots Fp2
// slots c_m, m = t kPowSlots + s, of the accumulator (f = sum c_m w^m,
// w^6 = XI), in registers, and of every table entry, in shared memory (a
// row's table is 3 KB: no local memory). A lane only ever reads its own
// slots of the table, so the table needs no barrier. Every step trades
// values through the team's exchange (team.cuh):
//   - a product a b (f12mul's Karatsuba over Fp6, 18 Fp2 products): the
//     lanes publish their slots of a and b; every one of the 18 products
//     multiplies a sum of a's slots by the same sum of b's slots, so each
//     lane forms its 18 / kPowTeam products' operands from the published
//     slots; the products are published and each lane forms its output
//     slots from them (c_k = t0_k + v t1, d_k = t2_k - t0_k - t1_k, the
//     Fp6 parts of Karatsuba's three products);
//   - a cyclotomic square: the lanes publish their slots; the 9 Fp2
//     squares of Granger-Scott (s0-s5 and the three squares of sums) are
//     spread over the lanes, published, and each lane forms its output
//     slots (3t -+ 2f);
//   - a square without cyc is the product a a (any correct square gives
//     the same canonical residues; no path of the port takes it).
// A window is then a chain of 3 x 2 Fp2 squares and 3 Fp2 products a lane
// with six lanes (21 Montgomery products) against 3 x 9 squares and 18
// products (108) for one thread; the entry is chosen by reading a lane's
// slots of all eight entries under masks (the exponents are secret RLC
// weights), never by an indexed load.
//
// What bounds it: the chain's latency, in which each product's operand
// sums and each slot's Karatsuba combination weigh as much as its
// Montgomery products. The verifier's 13,500 rows are 2,700 warps, at 8
// an SM (255 registers); at N = 1 (the final exponentiation's powers by u)
// one team carries the whole chain. On an H100 80GB HBM3 at 700 W: 9.4 ms
// at 128 bits and 4.8 at 63 on 13,500 rows, 1.3 ms at 63 bits on one; 3
// lanes a row (two slots each) measured slower at each of these shapes
// (scripts/torch_team_variants.py).
constexpr int kPowTeam = 6;                     // lanes per row
constexpr int kPowSlots = 6 / kPowTeam;         // Fp2 slots a lane owns
constexpr int kPowSqrs = (9 + kPowTeam - 1) / kPowTeam;   // a square's
constexpr int kPowTeamsPerWarp = 32 / kPowTeam;
constexpr int kPowWarps = 1;
constexpr int kPowThreads = 32 * kPowWarps;
constexpr int kPowRows = kPowWarps * kPowTeamsPerWarp;
constexpr int kFp2Words = 2 * NL16;

// A team of kSize lanes holding Fp12 values slot by slot: lane t owns the
// 6 / kSize Fp2 slots c_m, m = t (6 / kSize) + s, of each value
template <int kSize>
using F12Team = Team<Fp2, kSize, 18>;

using PowTeam = F12Team<kPowTeam>;
using Slots = Fp2[kPowSlots];

struct PowMem {
  Fp2 xch[2][18];
  Fp2 tab[kPowEntries][6];
};
constexpr size_t kPowSmem = sizeof(PowMem) * kPowRows;

// every Fp2 square of the kernel: one body, called
static __device__ __noinline__ Fp2 sqr2(const Fp2& a) { return f2sqr(a); }

__device__ __forceinline__ Fp2 f2zero() { return Fp2{fp_zero(), fp_zero()}; }

// component kk of the Fp6 product whose six Fp2 products (t0, t1, t2, m01,
// m02, m12) are P[0..5], as fp6_mul forms it
__device__ __forceinline__ Fp2 fp6_part(const Fp2* P, int kk) {
  const Fp2 p0 = P[0], p1 = P[1], p2 = P[2];
  const Fp2 r0 = f2add(p0, f2mul_xi(f2sub(f2sub(P[5], p1), p2)));
  const Fp2 r1 = f2add(f2sub(f2sub(P[3], p0), p1), f2mul_xi(p2));
  const Fp2 r2 = f2add(f2sub(f2sub(P[4], p0), p2), p1);
  return f2select(mask_of(kk == 0), r0, f2select(mask_of(kk == 1), r1, r2));
}

// this lane's slots of the kN Fp12 products a_p b_p, p < kN, in one
// exchange round, a_p's slots being ca[p] and b_p's cb[p] across the team;
// where bit p of `squares` is set, b_p = a_p and cb[p] is not read.
// f12mul's Karatsuba, so its bytes. The lanes publish their slots of the
// operands (a_p at 12 p, b_p at 12 p + 6); lane t computes products
// j = t (18 kN / kSize) ... of the 18 kN Fp2 products (product j is
// Karatsuba's product j - 18 p of a_p b_p, p = j / 18), publishes them,
// and forms its slots of every a_p b_p from them.
template <int kN, int kSize, int kWidth>
__device__ __forceinline__ void team_f12muls(Team<Fp2, kSize, kWidth>& tm,
                                             Fp2 (&out)[kN][6 / kSize],
                                             const Fp2 (&ca)[kN][6 / kSize],
                                             const Fp2 (&cb)[kN][6 / kSize],
                                             uint32_t squares) {
  static_assert(6 % kSize == 0, "a lane owns whole slots");
  static_assert(18 * kN <= kWidth, "the products fit in one buffer");
  constexpr int kSlots = 6 / kSize;
  constexpr int kProds = 18 * kN / kSize;   // a lane's Fp2 products
  Fp2* w = tm.out();
#pragma unroll
  for (int p = 0; p < kN; ++p) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      w[12 * p + tm.slot * kSlots + s] = ca[p][s];
      if (!((squares >> p) & 1u)) {
        w[12 * p + 6 + tm.slot * kSlots + s] = cb[p][s];
      }
    }
  }
  const Fp2* v = tm.publish();
  // product jj = 6h + r of Karatsuba over Fp6 (h: A1 A2, B1 B2, (A1 + B1)
  // (A2 + B2)) and 3-way Karatsuba within it (r: components {0}, {1},
  // {2}, {0, 1}, {0, 2}, {1, 2}); component e of the h-th Fp6 operand is
  // slot 2e + h, or slots 2e and 2e + 1 for h = 2. Its two operands are
  // the same sums of a_p's and of b_p's slots.
  Fp2* pw = tm.out();
#pragma unroll
  for (int q = 0; q < kProds; ++q) {
    const int j = tm.slot * kProds + q;
    const int p = kN == 1 ? 0 : j / 18, jj = j - 18 * p;
    const Fp2* a = v + 12 * p;
    const Fp2* b = (squares >> p) & 1u ? a : a + 6;
    const int h = jj / 6, r = jj % 6;
    const int e0 = r < 3 ? r : (r == 5 ? 1 : 0);
    const int e1 = r < 3 ? e0 : (r == 3 ? 1 : 2);
    const uint32_t two = mask_of(h == 2), both = mask_of(r >= 3);
    const int o = h & 1;
    auto sum = [&](const Fp2* x) {
      const Fp2 s0 = f2add(x[2 * e0 + o], f2select(two, x[2 * e0 + 1],
                                                    f2zero()));
      const Fp2 s1 = f2add(x[2 * e1 + o], f2select(two, x[2 * e1 + 1],
                                                    f2zero()));
      return f2add(s0, f2select(both, s1, f2zero()));
    };
    pw[j] = mul2(sum(a), sum(b));
  }
  const Fp2* P = tm.publish();
#pragma unroll
  for (int p = 0; p < kN; ++p) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int m = tm.slot * kSlots + s;
      const int kk = m >> 1;
      const bool odd = m & 1;
      // c_k = t0_k + (v t1)_k, (v t1) = (XI t1_2, t1_0, t1_1); d_k = t2_k -
      // t0_k - t1_k; slot 2k is c_k, slot 2k + 1 is d_k
      const Fp2* Pp = P + 18 * p;
      const Fp2 t0 = fp6_part(Pp, kk);
      const Fp2 t1 = fp6_part(Pp + 6, odd ? kk : (kk + 2) % 3);
      const Fp2 t2 = fp6_part(Pp + 12, kk);
      const Fp2 c = f2add(t0, f2select(mask_of(kk == 0), f2mul_xi(t1), t1));
      const Fp2 d = f2sub(f2sub(t2, t0), t1);
      out[p][s] = f2select(mask_of(odd), d, c);
    }
  }
}

// this lane's slots of a b, a's slots being ca, b's cb across the team
// (cb == nullptr: b = a): team_f12muls of one product
template <int kSize, int kWidth>
__device__ __forceinline__ void team_f12mul(Team<Fp2, kSize, kWidth>& tm,
                                            Fp2 (&out)[6 / kSize],
                                            const Fp2 (&ca)[6 / kSize],
                                            const Fp2 (*cb)[6 / kSize]) {
  constexpr int kSlots = 6 / kSize;
  Fp2 a[1][kSlots], b[1][kSlots], r[1][kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    a[0][s] = ca[s];
    b[0][s] = cb ? (*cb)[s] : ca[s];
  }
  team_f12muls<1>(tm, r, a, b, cb ? 0u : 1u);
#pragma unroll
  for (int s = 0; s < kSlots; ++s) out[s] = r[0][s];
}

// this lane's slots of Granger-Scott's cyclotomic square of f (eprint
// 2009/565, section 3.2, with the reference's formulas), f's slots being
// c across the team. It is the square only for f in the cyclotomic
// subgroup GPhi12(p); elsewhere it computes an unrelated function of f.
__device__ __forceinline__ void team_f12csqr(PowTeam& tm, Slots& c) {
  Fp2* w = tm.out();
#pragma unroll
  for (int s = 0; s < kPowSlots; ++s) w[tm.slot * kPowSlots + s] = c[s];
  const Fp2* f = tm.publish();
  // square j = 3g + r of group g: f_{3+g}^2, f_g^2, (f_{3+g} + f_g)^2 (s0,
  // s1, then the square of the sum for g = 0; s2, s3 for g = 1; s4, s5
  // for g = 2); a lane's squares past the ninth are not stored
  Fp2* sw = tm.out();
#pragma unroll
  for (int q = 0; q < kPowSqrs; ++q) {
    const int j = tm.slot + q * kPowTeam;
    const int jj = j < 9 ? j : 0;
    const int g = jj / 3, r = jj % 3;
    const Fp2 hi = f[3 + g], lo = f[g];
    const Fp2 x = f2add(f2select(mask_of(r == 1), lo, hi),
                        f2select(mask_of(r == 2), lo, f2zero()));
    const Fp2 y = sqr2(x);
    if (j < 9) sw[j] = y;
  }
  const Fp2* S = tm.publish();
#pragma unroll
  for (int s = 0; s < kPowSlots; ++s) {
    const int m = tm.slot * kPowSlots + s;
    const int kk = m >> 1;
    const bool odd = m & 1;
    // even slot 2k: t = XI S[3k] + S[3k + 1], out 3t - 2f; odd slot: group
    // g = (k + 2) % 3, t = S[3g + 2] - S[3g] - S[3g + 1] (times XI for
    // slot 1), out 3t + 2f
    const Fp2 te = f2add(f2mul_xi(S[3 * kk]), S[3 * kk + 1]);
    const int g = (kk + 2) % 3;
    Fp2 to = f2sub(f2sub(S[3 * g + 2], S[3 * g]), S[3 * g + 1]);
    to = f2select(mask_of(m == 1), f2mul_xi(to), to);
    const Fp2 t = f2select(mask_of(odd), to, te);
    const Fp2 u = f2select(mask_of(odd), f2add(t, c[s]), f2sub(t, c[s]));
    c[s] = f2add(f2add(u, u), t);
  }
}

__device__ __forceinline__ void team_square(PowTeam& tm, Slots& c, int cyc) {
  if (cyc) {
    team_f12csqr(tm, c);
  } else {
    Slots r;
    team_f12mul(tm, r, c, nullptr);
#pragma unroll
    for (int s = 0; s < kPowSlots; ++s) c[s] = r[s];
  }
}

__global__ void __launch_bounds__(kPowThreads)
    f12_wpow_kernel(const int32_t* __restrict__ f,
                    const int32_t* __restrict__ k, int32_t* __restrict__ out,
                    int n, int n_bits, int cyc) {
  extern __shared__ __align__(16) unsigned char pow_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int team = lane / kPowTeam;
  if (team == kPowTeamsPerWarp) return;   // lanes past the last team
  const int i = (blockIdx.x * kPowWarps + warp) * kPowTeamsPerWarp + team;
  if (i >= n) return;                     // the whole team leaves
  const int slot = lane - kPowTeam * team;
  PowMem& mem = reinterpret_cast<PowMem*>(
      pow_smem)[warp * kPowTeamsPerWarp + team];
  PowTeam tm{mem.xch, team_mask<kPowTeam>(kPowTeam * team), slot, 0};
  const int32_t* ki = k + (size_t)i * NL16;
  const int32_t* fi = f + (size_t)i * kF12Words;
  Slots base, c;
#pragma unroll
  for (int s = 0; s < kPowSlots; ++s) {
    const int m = slot * kPowSlots + s;
    base[s] = load_fp2(fi + m * kFp2Words);
    mem.tab[0][m] = Fp2{fp_select(mask_of(m == 0), fp_one(), fp_zero()),
                        fp_zero()};
    mem.tab[1][m] = base[s];
  }
#pragma unroll 1
  for (int d = 2; d < kPowEntries; ++d) {
    // T[d - 1] is in c (d odd)
#pragma unroll
    for (int s = 0; s < kPowSlots; ++s) {
      if (d % 2 == 0) c[s] = mem.tab[d / 2][slot * kPowSlots + s];
    }
    if (d % 2 == 0) {
      team_square(tm, c, cyc);
    } else {
      Slots r;
      team_f12mul(tm, r, c, &base);
#pragma unroll
      for (int s = 0; s < kPowSlots; ++s) c[s] = r[s];
    }
#pragma unroll
    for (int s = 0; s < kPowSlots; ++s) mem.tab[d][slot * kPowSlots + s] = c[s];
  }
  auto pick = [&](Slots& e, uint32_t dg) {
#pragma unroll
    for (int s = 0; s < kPowSlots; ++s) {
      const int m = slot * kPowSlots + s;
      e[s] = mem.tab[0][m];
#pragma unroll 1
      for (int v = 1; v < kPowEntries; ++v) {
        e[s] = f2select(mask_of(dg == (uint32_t)v), mem.tab[v][m], e[s]);
      }
    }
  };
  const int n_win = (n_bits + 2) / 3;
  pick(c, window3(ki, n_win - 1));
#pragma unroll 1
  for (int w = n_win - 2; w >= 0; --w) {
#pragma unroll 1
    for (int s = 0; s < 3; ++s) team_square(tm, c, cyc);
    Slots e, r;
    pick(e, window3(ki, w));
    team_f12mul(tm, r, c, &e);
#pragma unroll
    for (int s = 0; s < kPowSlots; ++s) c[s] = r[s];
  }
#pragma unroll
  for (int s = 0; s < kPowSlots; ++s) {
    store_fp2(out + (size_t)i * kF12Words +
                  (slot * kPowSlots + s) * kFp2Words,
              c[s]);
  }
}

// f12_mul and f12_mulreduce8: products of Fp12 values, each row computed
// by a team of kProdTeam lanes of a one-warp block. A lane holds its Fp2
// slots of the operands and the result in registers and loads only those
// slots of each value, so a team reads each 768-byte value as one
// contiguous run; the products go through team_f12mul, the windowed
// power's team product (with six lanes a chain of 3 Fp2 products, 9
// Montgomery products, against 54 for one thread). Lanes past the last
// team, and teams past n, leave whole.
//
// f12_mul: out[i] = a[i] b[i], as _f12_mul_kernel (pallas_pairing.py:529).
// The cluster survey launches it on 13,500 rows twice (the collection's a
// = gt1 gt2, the joint check's GPhi12 gate) and 17 times at N = 1 (the
// final exponentiation and the joint check's total), where one team
// carries the whole chain. Unlike mulreduce8 it runs without a register
// cap: 0.140 ms at 13,500 rows against 0.161 capped at 168 (292 B of
// spill stores), the same at N = 1 (0.035 ms); 3 lanes a row 1.4x slower
// at N = 1 (scripts/torch_team_variants.py; H100 80GB HBM3, 700 W).
//
// f12_mulreduce8: out[i] = g[i][0] g[i][1] ... g[i][7], left to right, as
// _f12_mulreduce8_kernel (pallas_pairing.py:629): seven team products in
// row order, a chain of 63 Montgomery products against 378.
//
// What bounds them: at the joint check's folds (N = 4,096 down to 1) and
// f12_mul's N = 1 a launch is a few warps, so the chain's latency sets its
// time: 0.26-0.28 ms for mulreduce8. At the collection's 4,500-108,000
// rows (up to 21,600 warps, 2.3 KB of exchange a row) the warps an SM
// holds: capping the registers at 168 (kProdWarpsPerSM, 248 B of spill
// stores) lets 12 warps in where 255 registers let 8, 5.3 ms at N =
// 108,000 against 7.1 uncapped and 6.0 at 128 registers; 3 lanes a row
// (two slots each) were slower at every shape (scripts/torch_team_variants.py;
// H100 80GB HBM3, 700 W).
constexpr int kProdTeam = 6;                   // lanes per row
constexpr int kProdSlots = 6 / kProdTeam;
constexpr int kProdTeamsPerWarp = 32 / kProdTeam;
constexpr int kProdWarpsPerSM = 12;   // at most 65536 / (12 x 32) registers

using ProdTeam = F12Team<kProdTeam>;
using ProdSlots = Fp2[kProdSlots];

// This lane's row and team in a one-warp block of teams of kSize lanes
// (the products', the inverse's), with the team's exchange in xch; false
// for a lane past the last team or of a team past n, which leaves whole
template <int kSize, int kWidth>
__device__ __forceinline__ bool prod_lane(int n, Fp2 (*xch)[2][kWidth],
                                          int& row,
                                          Team<Fp2, kSize, kWidth>& tm) {
  constexpr int kTeams = 32 / kSize;
  const int lane = threadIdx.x;
  const int team = lane / kSize;
  if (team == kTeams) return false;
  row = blockIdx.x * kTeams + team;
  if (row >= n) return false;
  const int slot = lane - kSize * team;
  tm = Team<Fp2, kSize, kWidth>{xch[team], team_mask<kSize>(kSize * team),
                                slot, 0};
  return true;
}

// this lane's kSlots slots of the Fp12 value at v, and back
template <int kSlots>
__device__ __forceinline__ void load_slots(Fp2 (&x)[kSlots], const int32_t* v,
                                           int slot) {
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    x[s] = load_fp2(v + (slot * kSlots + s) * kFp2Words);
  }
}

template <int kSlots>
__device__ __forceinline__ void store_slots(int32_t* v, int slot,
                                            const Fp2 (&x)[kSlots]) {
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    store_fp2(v + (slot * kSlots + s) * kFp2Words, x[s]);
  }
}

// one-warp blocks of teams of kSize lanes for n rows; n < 2^31 rows are
// fewer than 2^31 - 1 blocks, the grid's limit
template <int kSize>
inline unsigned prod_blocks(int n) {
  constexpr int kTeams = 32 / kSize;
  return (unsigned)(((size_t)n + kTeams - 1) / kTeams);
}

__global__ void __launch_bounds__(32)
    f12_mul_kernel(const int32_t* __restrict__ a,
                   const int32_t* __restrict__ b, int32_t* __restrict__ out,
                   int n) {
  __shared__ Fp2 xch[kProdTeamsPerWarp][2][18];
  int i;
  ProdTeam tm;
  if (!prod_lane(n, xch, i, tm)) return;
  const size_t off = (size_t)i * kF12Words;
  ProdSlots x, y, r;
  load_slots(x, a + off, tm.slot);
  load_slots(y, b + off, tm.slot);
  team_f12mul(tm, r, x, &y);
  store_slots(out + off, tm.slot, r);
}

__global__ void __launch_bounds__(32, kProdWarpsPerSM)
    f12_mulreduce8_kernel(const int32_t* __restrict__ g,
                          int32_t* __restrict__ out, int n) {
  __shared__ Fp2 xch[kProdTeamsPerWarp][2][18];
  int i;
  ProdTeam tm;
  if (!prod_lane(n, xch, i, tm)) return;
  const int32_t* row = g + (size_t)i * 8 * kF12Words;
  ProdSlots acc;
  load_slots(acc, row, tm.slot);
#pragma unroll 1
  for (int w = 1; w < 8; ++w) {
    ProdSlots x, r;
    load_slots(x, row + w * kF12Words, tm.slot);
    team_f12mul(tm, r, acc, &x);
#pragma unroll
    for (int s = 0; s < kProdSlots; ++s) acc[s] = r[s];
  }
  store_slots(out + (size_t)i * kF12Words, tm.slot, acc);
}

// f12_inv: 1/f, as _f12_inv_kernel (pallas_pairing.py:535): the tower
// inverse, f = A + w B -> (A - w B) / N with N = A^2 - v B^2 in Fp6, N
// inverted by its adjugate C over the Fp2 value t = N0 C0 + XI (N1 C2 +
// N2 C1), and t by its conjugate over its norm in Fp.
//
// A team of kInvTeam lanes computes one row, on the product teams' lane
// setup and slot loads; a lane owns 6 / kInvTeam Fp2 slots of f and of the
// result. The tower's products are spread over the lanes level by level,
// each level's products independent, every lane reading them all back
// (inv_level), so every lane holds N, C and t with no further exchange:
//   1. A^2 and B^2, fp6_mul's six products each (12)
//   2. C: N0^2, N1 N2, N2^2, N0 N1, N1^2, N0 N2 (6)
//   3. N0 C0, N1 C2, N2 C1, making t (3)
//   4. t^-1 = conj(t) / (t0^2 + t1^2), on every lane alone: two products,
//      Bernstein and Yang's safegcd (fp_inv.cuh) for the Fp inverse, two
//      products
//   5. N^-1 = C t^-1 (3)
//   6. A N^-1 and B N^-1, fp6_mul's six products each (12), the odd slots
//      negated.
// Every level returns canonical residues, the inverse of a non-zero value
// is unique, and safegcd maps 0 to 0 as x^(p-2) does, so the output is
// f12_inv_plain's bytes, 0 included.
//
// What bounds it: at N = 1 (the final exponentiation's, one team) one
// row's chain: 2 + 1 + 1 + 1 + 2 Fp2 products and 4 Montgomery products
// (25 Montgomery products) and one safegcd (20 batches of dependent
// integer steps), against 488 Montgomery products for one thread a row
// through the tower with a Fermat inverse, 379 of them the Fermat chain.
// Every lane runs the safegcd itself: a warp issues its steps once
// whichever of its lanes are active, and no exchange is spent publishing
// it. At the per-value check's 13,500 rows (2,700 warps) the warps'
// instruction issue: each warp runs a safegcd for its five rows, where
// one thread a row runs one for 32. On an H100 80GB HBM3 at 700 W through
// the wrapper: 0.077-0.078 ms at N = 1 and 0.313 at 13,500, against
// 0.517-0.519 and 0.655-0.665 for one thread a row with Fermat; one lane
// a row with safegcd 0.160 and 0.190-0.198 (faster at 13,500), 2 and 3
// lanes 0.129 and 0.100 at N = 1, six lanes with Fermat 0.330 and 1.47;
// capping the registers at 168 or 128 slower at both
// (scripts/torch_team_variants.py). ptxas: 255 registers, 272-byte stack,
// 16 bytes of spills.
constexpr int kInvTeam = 6;                  // lanes per row
constexpr int kInvSlots = 6 / kInvTeam;      // Fp2 slots a lane owns
constexpr int kInvWidth = 12;                // the most values a level trades
static_assert(6 % kInvTeam == 0, "a lane owns whole slots");

using InvTeam = Team<Fp2, kInvTeam, kInvWidth>;

// Karatsuba's product r of two Fp6 values (r < 3: component r; r = 3, 4,
// 5: components 0 + 1, 0 + 2, 1 + 2) multiplies the same sum of each
// operand's components: that sum, for the operand whose component e is
// at v[stride e]
__device__ __forceinline__ Fp2 fp6_sum(const Fp2* v, int stride, int r) {
  const int e0 = r < 3 ? r : (r == 5 ? 1 : 0);
  const int e1 = r < 3 ? e0 : (r == 3 ? 1 : 2);
  return f2add(v[stride * e0],
               f2select(mask_of(r >= 3), v[stride * e1], f2zero()));
}

// the one of a, b, c that k in {0, 1, 2} names
__device__ __forceinline__ Fp2 pick3(uint32_t k, const Fp2& a, const Fp2& b,
                                     const Fp2& c) {
  return f2select(mask_of(k == 0), a, f2select(mask_of(k == 1), b, c));
}

// One level of the inverse: its K products, product j = x y with x, y set
// by ops(j, x, y), computed by lane j % kInvTeam; every lane gets all K
// back. Unlike team_products, a lane forms only its own products'
// operands. A lane with no product in a round repeats the round's first
// one and stores nothing.
template <int K, typename Ops>
__device__ __forceinline__ const Fp2* inv_level(InvTeam& tm, const Ops& ops) {
  static_assert(K <= kInvWidth, "a level's products fit in one buffer");
  Fp2* w = tm.out();
#pragma unroll
  for (int j0 = 0; j0 < K; j0 += kInvTeam) {
    const int j = j0 + tm.slot;
    Fp2 x, y;
    ops(j < K ? j : j0, x, y);
    const Fp2 p = mul2(x, y);
    if (j < K) w[j] = p;
  }
  return tm.publish();
}

// this lane's slots of 1/f, f's slots being x across the team
__device__ __forceinline__ void team_f12inv(InvTeam& tm,
                                            Fp2 (&x)[kInvSlots]) {
  Fp2* w = tm.out();
#pragma unroll
  for (int s = 0; s < kInvSlots; ++s) w[tm.slot * kInvSlots + s] = x[s];
  const Fp2* f = tm.publish();
  // 1. product j = 6h + r of A^2 (h = 0; A's component e is slot 2e) and
  // of B^2 (h = 1; slot 2e + 1)
  const Fp2* P = inv_level<12>(tm, [&](int j, Fp2& a, Fp2& b) {
    a = b = fp6_sum(f + j / 6, 2, j % 6);
  });
  // N = A^2 - v B^2, v (b0, b1, b2) = (XI b2, b0, b1)
  const Fp2 n0 = f2sub(fp6_part(P, 0), f2mul_xi(fp6_part(P + 6, 2)));
  const Fp2 n1 = f2sub(fp6_part(P, 1), fp6_part(P + 6, 0));
  const Fp2 n2 = f2sub(fp6_part(P, 2), fp6_part(P + 6, 1));
  // 2. product j of C is N_x N_y, (x, y) = (0, 0), (1, 2), (2, 2), (0, 1),
  // (1, 1), (0, 2): the 2-bit fields j of kAdjX and kAdjY
  constexpr uint32_t kAdjX = 0x124u, kAdjY = 0x968u;
  const Fp2* Q = inv_level<6>(tm, [&](int j, Fp2& a, Fp2& b) {
    a = pick3((kAdjX >> 2 * j) & 3u, n0, n1, n2);
    b = pick3((kAdjY >> 2 * j) & 3u, n0, n1, n2);
  });
  const Fp2 c0 = f2sub(Q[0], f2mul_xi(Q[1]));
  const Fp2 c1 = f2sub(f2mul_xi(Q[2]), Q[3]);
  const Fp2 c2 = f2sub(Q[4], Q[5]);
  // 3. N0 C0, N1 C2, N2 C1
  const Fp2* T = inv_level<3>(tm, [&](int j, Fp2& a, Fp2& b) {
    a = pick3(j, n0, n1, n2);
    b = pick3((3 - j) % 3, c0, c1, c2);
  });
  const Fp2 t = f2add(T[0], f2mul_xi(f2add(T[1], T[2])));
  // 4. t^-1 = conj(t) / (t0^2 + t1^2)
  const Fp ni =
      fp_inv_safegcd(fadd(mont_mul(t.c0, t.c0), mont_mul(t.c1, t.c1)));
  const Fp2 ti{mont_mul(t.c0, ni), mont_mul(fsub(fp_zero(), t.c1), ni)};
  // 5. N^-1 = C t^-1, and f's slots again beside it for level 6
  w = tm.out();
#pragma unroll
  for (int s = 0; s < kInvSlots; ++s) w[3 + tm.slot * kInvSlots + s] = x[s];
  const Fp2* R = inv_level<3>(tm, [&](int j, Fp2& a, Fp2& b) {
    a = pick3(j, c0, c1, c2);
    b = ti;
  });
  // 6. product j = 6h + r of A N^-1 (h = 0) and B N^-1 (h = 1)
  const Fp2* S = inv_level<12>(tm, [&](int j, Fp2& a, Fp2& b) {
    a = fp6_sum(R + 3 + j / 6, 2, j % 6);
    b = fp6_sum(R, 1, j % 6);
  });
  // slot 2k is (A N^-1)_k, slot 2k + 1 is -(B N^-1)_k
#pragma unroll
  for (int s = 0; s < kInvSlots; ++s) {
    const int m = tm.slot * kInvSlots + s;
    const bool odd = m & 1;
    const Fp2 v = fp6_part(S + (odd ? 6 : 0), m >> 1);
    x[s] = f2select(mask_of(odd), f2neg(v), v);
  }
}

__global__ void __launch_bounds__(32)
    f12_inv_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                   int n) {
  __shared__ Fp2 xch[32 / kInvTeam][2][kInvWidth];
  int i;
  InvTeam tm;
  if (!prod_lane(n, xch, i, tm)) return;
  const size_t off = (size_t)i * kF12Words;
  Fp2 x[kInvSlots];
  load_slots(x, a + off, tm.slot);
  team_f12inv(tm, x);
  store_slots(out + off, tm.slot, x);
}

// f12_csqr: the cyclotomic square of every row, as _f12_csqr_kernel
// (pallas_pairing.py:851). The kernel computes Granger-Scott's function
// on any input, so its bytes are f12_csqr_plain's on rows outside GPhi12
// too. A team of kPowTeam lanes computes one row, in one-warp blocks of
// five teams, on the product teams' lane setup and slot loads, through
// the windowed power's team_f12csqr: each lane loads its Fp2 slot, the
// team publishes them, lane t squares the sums t and t + 6 (below 9) of
// the 9 Fp2 squares, the team publishes those, and each lane forms its
// own output slot (3t -+ 2f) and stores it. A lane's chain is 2 Fp2
// squares (4 Montgomery products) and two exchanges, against the 18
// products of one thread a row, the kernel this one replaced.
//
// What bounds it: at N = 1 (the final exponentiation's four squares) the
// host's launch path, then one team's chain; at the per-value check's
// 13,500 rows (2,700 warps, one wave at 96 registers) not the bytes (768
// in and 768 out a row take a fifth of its time) but, likely, the lanes'
// integer work: each lane forms both slot formulas and keeps one, and
// lanes 3-5 square a sum they discard (not measured apart). On an H100
// 80GB HBM3 at 700 W, device time from a CUDA graph: 0.007 ms at N = 1 and
// 0.032-0.033 at 13,500, against 0.047 and 0.076 for one thread a row;
// through the wrapper 0.030-0.044 (the host's floor) and 0.036-0.039;
// 3 lanes a row (two slots each) 0.009 and 0.035 of device time
// (scripts/torch_team_variants.py). ptxas: 96 registers, a 64-byte stack
// (the call frame of sqr2), no spills.
__global__ void __launch_bounds__(32)
    f12_csqr_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                    int n) {
  __shared__ Fp2 xch[kPowTeamsPerWarp][2][18];
  int i;
  PowTeam tm;
  if (!prod_lane(n, xch, i, tm)) return;
  const size_t off = (size_t)i * kF12Words;
  Slots c;
  load_slots(c, a + off, tm.slot);
  team_f12csqr(tm, c);
  store_slots(out + off, tm.slot, c);
}

// f12_pow: f^k, LSB-first over n_bits bits, as _f12_pow_kernel
// (pallas_pairing.py:541-569): at bit w, acc = acc base where bit w of k
// is set, then base = base^2. The product is computed at every bit and
// kept by mask (f2select), so neither the time nor a branch depends on k;
// bits of k at or above n_bits are never read.
//
// A team of kPowTeam lanes computes one row, in one-warp blocks of five
// teams, on the product teams' lane setup and slot loads; lane t owns
// the 6 / kPowTeam Fp2 slots of acc and of base. At each bit acc base
// and base^2 do not depend on each other, so one team_f12muls round
// computes both: the lanes publish their slots of acc and base, each lane
// computes 36 / kPowTeam of the two products' 36 Fp2 products (lanes 0-2
// acc base's, lanes 3-5 base^2's, with six lanes), the team publishes
// them and each lane forms its slots of both. A bit is then two exchanges
// and a chain of 6 Fp2 products (18 Montgomery products) a lane, against
// 30 Fp2 products (90 Montgomery products) for the one thread a row this
// kernel replaced. The exchange holds 2 x 36 Fp2 values, 4.6 KB a team
// and 23 KB a warp.
//
// What bounds it: on a few rows the chain's latency, each Fp2 product's
// Montgomery carry chains and each product's operand sums, as in f12_wpow;
// at 13,500 rows (2,700 warps, 8 an SM at 255 registers) instruction
// issue, where the lanes' glue (operand sums, every output slot's three
// Karatsuba combinations before a select) makes six lanes issue ~1.7x the
// instructions of one thread a row. On an H100 80GB HBM3 at 700 W: 68.2
// ms at 256 bits and 12.8 at 48 on 13,500 rows, 19.3 ms at 256 bits on
// one row, against 75.3-75.7, 14.2 and 60.9-61.2 for one thread a row;
// the two products as two team_f12mul rounds (four exchanges a bit) 4 %
// slower, 168 registers or 3 lanes slower at 13,500 rows
// (scripts/torch_team_variants.py). ptxas: 255 registers, a 208-byte
// stack, 84 bytes of spill stores. No path of the port runs it (the
// windowed power replaced it in the reference too).
constexpr int kPowWidth = 36;   // two products' Fp2 products

using PowPairTeam = Team<Fp2, kPowTeam, kPowWidth>;

__global__ void __launch_bounds__(32)
    f12_pow_kernel(const int32_t* __restrict__ f,
                   const int32_t* __restrict__ k, int32_t* __restrict__ out,
                   int n, int n_bits) {
  __shared__ Fp2 xch[kPowTeamsPerWarp][2][kPowWidth];
  int i;
  PowPairTeam tm;
  if (!prod_lane(n, xch, i, tm)) return;
  const size_t off = (size_t)i * kF12Words;
  const int32_t* ki = k + (size_t)i * NL16;
  // v[0] is acc, v[1] base
  Fp2 v[2][kPowSlots], r[2][kPowSlots];
  load_slots(v[1], f + off, tm.slot);
#pragma unroll
  for (int s = 0; s < kPowSlots; ++s) {
    const int m = tm.slot * kPowSlots + s;
    v[0][s] = Fp2{fp_select(mask_of(m == 0), fp_one(), fp_zero()),
                  fp_zero()};
  }
#pragma unroll 1
  for (int w = 0; w < n_bits; ++w) {
    const uint32_t bit = ((uint32_t)ki[w >> 4] >> (w & 15)) & 1u;
    // acc base and base^2 (bit 1 of squares: the second is a square)
    Fp2 b[2][kPowSlots];
#pragma unroll
    for (int s = 0; s < kPowSlots; ++s) b[0][s] = b[1][s] = v[1][s];
    team_f12muls<2>(tm, r, v, b, 2u);
#pragma unroll
    for (int s = 0; s < kPowSlots; ++s) {
      v[0][s] = f2select(mask_of(bit == 1u), r[0][s], v[0][s]);
      v[1][s] = r[1][s];
    }
  }
  store_slots(out + off, tm.slot, v[0]);
}

}  // namespace

extern "C" {

int f12_mul(const int32_t* a, const int32_t* b, int32_t* out, int n,
            void* stream) {
  f12_mul_kernel<<<prod_blocks<kProdTeam>(n), 32, 0,
                   (cudaStream_t)stream>>>(a, b, out, n);
  return (int)cudaGetLastError();
}

int f12_mulreduce8(const int32_t* g, int32_t* out, int n, void* stream) {
  f12_mulreduce8_kernel<<<prod_blocks<kProdTeam>(n), 32, 0,
                          (cudaStream_t)stream>>>(g, out, n);
  return (int)cudaGetLastError();
}

int f12_inv(const int32_t* a, int32_t* out, int n, void* stream) {
  f12_inv_kernel<<<prod_blocks<kInvTeam>(n), 32, 0,
                   (cudaStream_t)stream>>>(a, out, n);
  return (int)cudaGetLastError();
}

int f12_csqr(const int32_t* a, int32_t* out, int n, void* stream) {
  f12_csqr_kernel<<<prod_blocks<kPowTeam>(n), 32, 0,
                    (cudaStream_t)stream>>>(a, out, n);
  return (int)cudaGetLastError();
}

int f12_slotmul(const int32_t* a, const int32_t* c, int32_t* out, int n,
                int conj, void* stream) {
  const int threads = 6 / kSlotmulSlots * n;
  f12_slotmul_kernel<<<blocks_for(threads), kThreads, 0,
                       (cudaStream_t)stream>>>(a, c, out, threads, conj);
  return (int)cudaGetLastError();
}

int f12_wpow(const int32_t* f, const int32_t* k, int32_t* out, int n,
             int n_bits, int cyc, void* stream) {
  // a warp of 3-lane teams holds 54 KB of tables and exchanges, past the
  // 48 KB of static shared memory: the kernel asks for it at launch
  const cudaError_t e = cudaFuncSetAttribute(
      f12_wpow_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kPowSmem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n + kPowRows - 1) / kPowRows;
  f12_wpow_kernel<<<blocks, kPowThreads, kPowSmem, (cudaStream_t)stream>>>(
      f, k, out, n, n_bits, cyc);
  return (int)cudaGetLastError();
}

int f12_pow(const int32_t* f, const int32_t* k, int32_t* out, int n,
            int n_bits, void* stream) {
  f12_pow_kernel<<<prod_blocks<kPowTeam>(n), 32, 0, (cudaStream_t)stream>>>(
      f, k, out, n, n_bits);
  return (int)cudaGetLastError();
}

}  // extern "C"

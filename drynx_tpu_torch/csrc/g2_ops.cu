// bn256 G2 kernels of range-proof creation, one element per thread. Each
// replaces one Pallas TPU kernel of drynx_tpu/crypto/pallas_pairing.py;
// drynx_tpu_torch/crypto/cuda_pairing.py binds them with ctypes and holds
// each beside its plain PyTorch version.
//
//   g2_scalar_mul  replaces _g2_scalar_mul_kernel (g2_scalar_mul_flat)
//   f2_inv         replaces _f2_inv_kernel        (f2_inv_flat)
//
// What bounds them: 32-bit integer multiply-adds. The ladder is ~8.9k
// Montgomery products per element (16-entry table, then 63 windows of 4
// doublings and one complete add, every add also computing a double), the
// inversion 381. Memory traffic is a few hundred bytes per element. At the
// main path's 13,500 elements a launch holds ~3 warps per SM, so the
// latency of each thread's dependent multiply chain, not the card's
// multiply rate, sets the time. The ladder's 16-entry table is 3 KB per
// thread and lives in local memory (L1/L2); the group law is not inlined,
// which keeps one copy of its body and its temporaries in its own frame.
//
// The scalar v of a digit signature is a secret blinding factor, so table
// entries are chosen by reading all 16 under masks, never by an indexed
// load (pallas_pairing.py:1138-1143). The formulas, the select order and
// the point at infinity (X = Y = plain 1, Z = 0) are those of make_g2_group,
// so the kernel's raw Jacobian limbs equal its plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bn256_tower.cuh"

using namespace bn256;

namespace {

constexpr int kThreads = 128;
constexpr int kPointWords = 3 * 2 * NL16;   // int32 words of one G2 point
constexpr int kWindowEntries = 16;
constexpr int kWindows = 64;

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

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

__device__ __forceinline__ G2 g2_select(uint32_t mask, const G2& a, const G2& b) {
  return G2{f2select(mask, a.X, b.X), f2select(mask, a.Y, b.Y),
            f2select(mask, a.Z, b.Z)};
}

// make_g2_group's infinity: X = Y = (1, 0) with a plain 1, Z = 0
__device__ __forceinline__ G2 g2_inf() {
  Fp one = fp_zero();
  one.w[0] = 1;
  const Fp2 x{one, fp_zero()};
  const Fp2 z{fp_zero(), fp_zero()};
  return G2{x, x, z};
}

// Jacobian doubling on the twist, a = 0 (dbl-2009-l)
static __device__ __noinline__ G2 g2_double(const G2& p) {
  const Fp2 A = f2sqr(p.X);
  const Fp2 B = f2sqr(p.Y);
  const Fp2 C = f2sqr(B);
  const Fp2 t = f2sub(f2sqr(f2add(p.X, B)), f2add(A, C));
  const Fp2 D = f2add(t, t);
  const Fp2 E = f2add(f2add(A, A), A);
  G2 r;
  r.X = f2sub(f2sqr(E), f2add(D, D));
  const Fp2 C2 = f2add(C, C);
  const Fp2 C4 = f2add(C2, C2);
  r.Y = f2sub(f2mul(E, f2sub(D, r.X)), f2add(C4, C4));
  const Fp2 YZ = f2mul(p.Y, p.Z);
  r.Z = f2add(YZ, YZ);
  return r;
}

// Complete Jacobian addition on the twist: add-2007-bl, then the selects of
// make_g2_group for P == Q, P == -Q and either operand at infinity. Like the
// reference it always computes the double too, so its work does not depend
// on the operands.
static __device__ __noinline__ G2 g2_add(const G2& p, const G2& q) {
  const Fp2 Z1Z1 = f2sqr(p.Z);
  const Fp2 Z2Z2 = f2sqr(q.Z);
  const Fp2 U1 = f2mul(p.X, Z2Z2);
  const Fp2 U2 = f2mul(q.X, Z1Z1);
  const Fp2 S1 = f2mul(p.Y, f2mul(q.Z, Z2Z2));
  const Fp2 S2 = f2mul(q.Y, f2mul(p.Z, Z1Z1));
  const Fp2 H = f2sub(U2, U1);
  const Fp2 HH = f2add(H, H);
  const Fp2 I = f2sqr(HH);
  const Fp2 J = f2mul(H, I);
  Fp2 r = f2sub(S2, S1);
  r = f2add(r, r);
  const Fp2 V = f2mul(U1, I);
  G2 res;
  res.X = f2sub(f2sub(f2sqr(r), J), f2add(V, V));
  const Fp2 SJ = f2mul(S1, J);
  res.Y = f2sub(f2mul(r, f2sub(V, res.X)), f2add(SJ, SJ));
  const Fp2 ZZ = f2sub(f2sub(f2sqr(f2add(p.Z, q.Z)), Z1Z1), Z2Z2);
  res.Z = f2mul(ZZ, H);

  const bool p_inf = f2is_zero(p.Z);
  const bool q_inf = f2is_zero(q.Z);
  const bool h0 = f2is_zero(H);
  const bool r0 = f2is_zero(r);
  const G2 dbl = g2_double(p);
  res = g2_select(mask_of(h0 && r0 && !p_inf && !q_inf), dbl, res);
  res = g2_select(mask_of(h0 && !r0 && !p_inf && !q_inf), g2_inf(), res);
  res = g2_select(mask_of(q_inf), p, res);
  res = g2_select(mask_of(p_inf), q, res);
  return res;
}

// g2_scalar_mul: k*Q. The thread builds its table T[d] = d*Q
// (T[2j] = 2 T[j], T[2j+1] = T[2j] + Q) in local memory, then walks 64
// 4-bit windows MSB-first: 4 doublings and one add of the entry chosen by
// a masked read of all 16.
__global__ void g2_scalar_mul_kernel(const int32_t* __restrict__ p,
                                     const int32_t* __restrict__ k,
                                     int32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t* ki = k + (size_t)i * NL16;
  G2 tab[kWindowEntries];
  tab[0] = g2_inf();
  tab[1] = load_g2(p + (size_t)i * kPointWords);
#pragma unroll 1
  for (int d = 2; d < kWindowEntries; ++d) {
    tab[d] = (d % 2 == 0) ? g2_double(tab[d / 2]) : g2_add(tab[d - 1], tab[1]);
  }
  auto pick = [&](uint32_t d) {
    G2 s = tab[0];
#pragma unroll 1
    for (int v = 1; v < kWindowEntries; ++v) {
      s = g2_select(mask_of(d == (uint32_t)v), tab[v], s);
    }
    return s;
  };
  G2 acc = pick(window_digit(ki, kWindows - 1));
#pragma unroll 1
  for (int w = kWindows - 2; w >= 0; --w) {
#pragma unroll 1
    for (int s = 0; s < 4; ++s) acc = g2_double(acc);
    acc = g2_add(acc, pick(window_digit(ki, w)));
  }
  store_g2(out + (size_t)i * kPointWords, acc);
}

// f2_inv: 1/(a0 + a1 i) = (a0, -a1) / (a0^2 + a1^2), the norm inverted by
// Fermat over the bits of p - 2
__global__ void f2_inv_kernel(const int32_t* __restrict__ a,
                              int32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fp2 x = load_fp2(a + (size_t)i * 2 * NL16);
  const Fp ni = fp_inv_fermat(fadd(mont_mul(x.c0, x.c0), mont_mul(x.c1, x.c1)));
  const Fp2 r{mont_mul(x.c0, ni), mont_mul(fsub(fp_zero(), x.c1), ni)};
  store_fp2(out + (size_t)i * 2 * NL16, r);
}

}  // namespace

extern "C" {

int g2_scalar_mul(const int32_t* p, const int32_t* k, int32_t* out, int n,
                  void* stream) {
  g2_scalar_mul_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      p, k, out, n);
  return (int)cudaGetLastError();
}

int f2_inv(const int32_t* a, int32_t* out, int n, void* stream) {
  f2_inv_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(a, out,
                                                                       n);
  return (int)cudaGetLastError();
}

}  // extern "C"

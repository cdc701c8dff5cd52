// The optimal-ate Miller loop of range-proof verification, one pairing per
// thread. It replaces the Pallas TPU kernel _miller_kernel of
// drynx_tpu/crypto/pallas_pairing.py; drynx_tpu_torch/crypto/cuda_pairing.py
// binds it with ctypes (miller_flat) and holds it beside its plain PyTorch
// version (miller_plain).
//
// The loop walks the 65 bits of 6u + 2 below its leading one. Each step
// squares f, doubles T (the twist point, Jacobian) and multiplies f by the
// tangent line scaled by 2YZ^3; then it computes the mixed add T + Q with the
// line through T and Q (madd-2007-bl, the line negated against pairing.py's)
// and keeps it where the bit is set. Two more adds take in pi(Q) and
// -pi^2(Q), whose coordinates the wrapper computes before the launch. A
// vertical line (T and the added point share x, possible only on crafted
// inputs) contributes 1 and leaves T as it was. Line values and Jacobian
// coordinates are not canonical, so the output equals the reference's only
// after the final exponentiation; it equals the plain version's byte for
// byte because both follow _miller_kernel's formulas (pallas_pairing.py:
// 343-432) and every field value is a canonical residue.
//
// What bounds it: 32-bit multiply-adds, ~14,300 Montgomery products per
// pairing (65 x (121 for the double step + 96 for the add step) + 2 x 96).
// Memory traffic is 1 KB per pairing. At the verifier's 13,500 pairings a
// launch is one wave of ~106 blocks, so each thread's dependent chain sets
// the time. The state (T: 48 words, f: 96, the point P: 16) alone is most
// of a thread's 255 registers: the steps and the tower functions they call
// are not inlined, and Q and its Frobenius images are read again from
// global memory (L1) where they are needed instead of held in registers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bn256_tower.cuh"

using namespace bn256;

namespace {

constexpr int kThreads = 128;
constexpr int kF12Words = 6 * 2 * NL16;
constexpr int kFp2Words = 2 * NL16;
// 6u + 2 = kAteHi * 2^64 + kAteLo (params.U); the loop reads bits 64..0
constexpr uint64_t kAteLo = 0x1ec817a18a131208ull;
constexpr uint32_t kAteHi = 2u;
constexpr int kAteTop = 64;

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

struct G2 {
  Fp2 X, Y, Z;
};

__device__ __forceinline__ uint32_t ate_bit(int b) {
  return b >= 64 ? (kAteHi >> (b - 64)) & 1u : (uint32_t)(kAteLo >> b) & 1u;
}

// T <- 2T, f <- f^2 * l_{T,T}(P) with l = 2YZ^3 yp - 3X^2 Z^2 xp w
// + (3X^3 - 2Y^2) w^3
static __device__ __noinline__ void dbl_step(G2& T, Fp12& f, const Fp& xp,
                                             const Fp& yp) {
  const Fp2 A = f2sqr(T.X);
  const Fp2 Bv = f2sqr(T.Y);
  const Fp2 zz = f2sqr(T.Z);
  const Fp2 E = f2add(f2add(A, A), A);
  const Fp2 AX = f2mul(A, T.X);
  const Fp2 l3 = f2sub(f2add(f2add(AX, AX), AX), f2add(Bv, Bv));
  const Fp2 l1 = f2mul_fp(f2neg(f2mul(E, zz)), xp);
  const Fp2 YZ = f2mul(T.Y, T.Z);
  const Fp2 YZ3 = f2mul(YZ, zz);
  const Fp2 l0 = f2mul_fp(f2add(YZ3, YZ3), yp);
  // the point double: make_group's dbl-2009-l
  const Fp2 Cv = f2sqr(Bv);
  const Fp2 t = f2sub(f2sqr(f2add(T.X, Bv)), f2add(A, Cv));
  const Fp2 D = f2add(t, t);
  const Fp2 X3 = f2sub(f2sqr(E), f2add(D, D));
  const Fp2 C2 = f2add(Cv, Cv);
  const Fp2 C8 = f2add(f2add(C2, C2), f2add(C2, C2));
  T.Y = f2sub(f2mul(E, f2sub(D, X3)), C8);
  T.X = X3;
  T.Z = f2add(YZ, YZ);
  f = sparse013(f12sqr(f), l0, l1, l3);
}

// Where `take` is set and the line is not vertical: T <- T + (qx, qy),
// f <- f * l_{T,Q}(P) with l = HZ yp - r xp w + (r qx - HZ qy) w^3,
// H = qx Z^2 - X, r = qy Z^3 - Y
static __device__ __noinline__ void add_step(G2& T, Fp12& f, const Fp2& qx,
                                             const Fp2& qy, const Fp& xp,
                                             const Fp& yp, uint32_t take) {
  const Fp2 zz = f2sqr(T.Z);
  const Fp2 U2 = f2mul(qx, zz);
  const Fp2 S2 = f2mul(qy, f2mul(T.Z, zz));
  const Fp2 Hm = f2sub(U2, T.X);
  const Fp2 r1 = f2sub(S2, T.Y);
  const Fp2 HmZ = f2mul(Hm, T.Z);
  const Fp2 l0 = f2mul_fp(HmZ, yp);
  const Fp2 l1 = f2mul_fp(f2neg(r1), xp);
  const Fp2 l3 = f2sub(f2mul(r1, qx), f2mul(HmZ, qy));
  const Fp12 f2 = sparse013(f, l0, l1, l3);
  // madd-2007-bl
  const Fp2 HH = f2sqr(Hm);
  const Fp2 I4 = f2add(f2add(HH, HH), f2add(HH, HH));
  const Fp2 J = f2mul(Hm, I4);
  const Fp2 rm = f2add(r1, r1);
  const Fp2 V = f2mul(T.X, I4);
  G2 R;
  R.X = f2sub(f2sub(f2sqr(rm), J), f2add(V, V));
  const Fp2 YJ = f2mul(T.Y, J);
  R.Y = f2sub(f2mul(rm, f2sub(V, R.X)), f2add(YJ, YJ));
  R.Z = f2sub(f2sub(f2sqr(f2add(T.Z, Hm)), zz), HH);
  const uint32_t keep = take & ~mask_of(f2is_zero(Hm));
  T.X = f2select(keep, R.X, T.X);
  T.Y = f2select(keep, R.Y, T.Y);
  T.Z = f2select(keep, R.Z, T.Z);
  f = f12select(keep, f2, f);
}

// p: (n, 2, 16) affine G1 (x, y); q: (n, 5, 2, 16) twist points as
// (qx, qy, pi(Q)x, pi(Q)y, -pi^2(Q)x), -pi^2(Q)y being qy; all Montgomery
__global__ void miller_kernel(const int32_t* __restrict__ p,
                              const int32_t* __restrict__ q,
                              int32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t* pi = p + (size_t)i * 2 * NL16;
  const int32_t* qi = q + (size_t)i * 5 * kFp2Words;
  const Fp xp = load_fp_v(pi);
  const Fp yp = load_fp_v(pi + NL16);
  G2 T{load_fp2(qi), load_fp2(qi + kFp2Words), Fp2{fp_one(), fp_zero()}};
  Fp12 f = f12_one();
#pragma unroll 1
  for (int b = kAteTop; b >= 0; --b) {
    dbl_step(T, f, xp, yp);
    add_step(T, f, load_fp2(qi), load_fp2(qi + kFp2Words), xp, yp,
             mask_of(ate_bit(b) != 0));
  }
  add_step(T, f, load_fp2(qi + 2 * kFp2Words), load_fp2(qi + 3 * kFp2Words),
           xp, yp, 0xFFFFFFFFu);
  add_step(T, f, load_fp2(qi + 4 * kFp2Words), load_fp2(qi + kFp2Words), xp,
           yp, 0xFFFFFFFFu);
  store_fp12(out + (size_t)i * kF12Words, f);
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

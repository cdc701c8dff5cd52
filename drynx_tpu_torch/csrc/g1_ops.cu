// bn256 G1 kernels of the encrypted survey's main path. Each replaces one
// Pallas TPU kernel of drynx_tpu/crypto/pallas_ops.py;
// drynx_tpu_torch/crypto/cuda_ops.py binds them with ctypes and holds each
// beside its plain PyTorch version. The two ladders give each row a team
// of threads (their notes below); the others run one curve element per
// thread.
//
// What bounds them: integer multiply-adds (a Montgomery product is 64
// 32x32->64-bit products plus as many for the reduction, on the IMAD
// pipe); memory traffic is a few hundred bytes per element. At the main
// path's 90-900 elements the launches fill only a few of the 132 SMs, so
// the latency of the dependent multiply chains, not the card's multiply
// rate, sets their time: a Montgomery product's carry chain is one long
// dependency, ~1-2 us for one warp alone on its scheduler.
//
// Plain C entry points: each launches on the caller's stream and returns
// cudaGetLastError(), so a refused launch reaches the wrapper, which raises.

#include <cuda_runtime.h>
#include <stdint.h>

#include "team.cuh"

using namespace bn256;

namespace {

constexpr int kThreads = 128;
constexpr int kPointWords = 3 * NL16;   // int32 words of one point
constexpr int kWindowEntries = 16;      // 4-bit windows

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

// Kernel 1 (pallas_ops._fixed_base_kernel): k*P from a shared window table
// table[w][v] = v * 16^w * P, W add-only windows, little-endian digits.
//
// k*P = sum_w T[w][d_w] is a sum of independent table entries, so a team of
// kFixedBaseTeam threads computes one row. Lane t sums the windows
// [t * kLaneWindows, (t + 1) * kLaneWindows) below W in order, from a copy
// of its first selected entry; a lane with no window below W holds the
// point at infinity. The team's partial sums then meet in shared memory in
// a binary tree of complete adds, level by level: partials 2i and 2i + 1
// make partial i of the next level, down to one. Each window's entry is
// chosen by reading all 16 under masks: the digit is secret, so no address
// depends on it. The table (192 KB at W = 64) stays in device memory and
// reaches the lanes through L2 and L1, read with 16-byte vector loads:
// staged in shared memory it would hold one block per SM. The plain version
// (cuda_ops.fixed_base_mul_plain) sums in the same grouping and tree order,
// so the two agree byte for byte; the Jacobian representative differs from
// the one-thread ladder's, the point does not.
//
// What bounds it: each lane's chain of complete adds, kLaneWindows - 1 for
// its windows and log2(kFixedBaseTeam) for the tree: 6 with 32 lanes,
// against 63 for one thread per row. At the main path's 90-900 rows the
// launch is one partial wave, so the chain's latency sets the time, ~0.28
// ms at 270 rows and 0.34 at 900 on an H100 80GB HBM3 at 700 W. 16 lanes
// (a chain of 7) and 64 (a chain of 6 over twice the warps) measured
// slower at these shapes (scripts/torch_team_variants.py). ptxas: 188
// registers, no stack.
constexpr int kFixedBaseTeam = 32;   // cuda_ops.FIXED_BASE_TEAM
constexpr int kLaneWindows = 64 / kFixedBaseTeam;
constexpr int kFixedBaseRows = kThreads / kFixedBaseTeam;
static_assert((kFixedBaseTeam & (kFixedBaseTeam - 1)) == 0 &&
                  kFixedBaseTeam <= kThreads,
              "the team is a power of two within a block");

// the entry of window w named by digit d, all 16 entries read under masks
__device__ __forceinline__ G1 select_entry(const int32_t* __restrict__ table,
                                           int w, uint32_t d) {
  const int32_t* row = table + (size_t)w * kWindowEntries * kPointWords;
  G1 sel = load_g1_v(row);
#pragma unroll 1
  for (int v = 1; v < kWindowEntries; ++v) {
    sel = g1_select(mask_of(d == (uint32_t)v),
                    load_g1_v(row + v * kPointWords), sel);
  }
  return sel;
}

__global__ void __launch_bounds__(kThreads)
    fixed_base_mul_kernel(const int32_t* __restrict__ table,
                          const int32_t* __restrict__ k,
                          int32_t* __restrict__ out, int n, int n_windows) {
  __shared__ G1 part[kThreads];
  const int t = threadIdx.x % kFixedBaseTeam;
  const int row = threadIdx.x / kFixedBaseTeam;
  const int i = blockIdx.x * kFixedBaseRows + row;
  const bool live = i < n;
  const int32_t* ki = k + (size_t)(live ? i : 0) * NL16;
  const int w0 = t * kLaneWindows;
  const int w1 = min(w0 + kLaneWindows, n_windows);
  G1 acc = g1_inf();
  if (w0 < w1) acc = select_entry(table, w0, window_digit(ki, w0));
#pragma unroll 1
  for (int w = w0 + 1; w < w1; ++w) {
    acc = padd(acc, select_entry(table, w, window_digit(ki, w)));
  }
  G1* team = part + row * kFixedBaseTeam;
#pragma unroll 1
  for (int m = kFixedBaseTeam; m > 1; m /= 2) {
    if (t < m) team[t] = acc;
    __syncthreads();
    if (t < m / 2) acc = padd(team[2 * t], team[2 * t + 1]);
    __syncthreads();
  }
  if (t == 0 && live) store_g1(out + (size_t)i * kPointWords, acc);
}

// Kernel 2 (pallas_ops._scalar_mul_kernel): variable-base k*P, 4-bit
// windows MSB-first over the table T[d] = d*P (T[2j] = 2T[j], T[2j+1] =
// T[2j] + P): 4 doublings, then a complete add of the entry the digit
// names.
//
// The windows depend on each other, so a team of kLadderTeam lanes works
// on one row by splitting each group-law step: the independent Montgomery
// products of a formula level are spread over the lanes (team.cuh's
// team_products) and every lane reads them all back, so every lane holds
// the same point, H, r and select masks with no further exchange. The
// double (dbl-2009-l) is 3 levels of 3, 3 and 1 products (the last one
// each lane computes itself); the complete add (add-2007-bl) runs the
// double it may select beside its first three levels:
//   1. Z1^2, Z2^2, X1^2, Y1^2
//   2. U1 = X1 Z2^2, U2 = X2 Z1^2, Z2 Z2^2, Z1 Z1^2, (Z1 + Z2)^2, B^2,
//      (X1 + B)^2, E^2
//   3. S1, S2, I = (2H)^2, ZZ H, E (D - X3'), Y1 Z1
//   4. J = H I, V = U1 I, r^2
//   5. S1 J, r (V - X3)
// and then takes the reference's selects in its order (P = Q, P = -Q,
// either operand at infinity; bn256_g1.cuh padd). The formulas are padd's
// and pdouble's on canonical residues, so the kernel's Jacobian limbs equal
// the plain version's byte for byte. The digits are secret: the table (1.5
// KB a row) sits in shared memory, and each window's entry is chosen by
// reading all 16 entries under masks, never by an indexed load.
//
// What bounds it: the chain of dependent products. With 4 lanes a window
// is 4 x 3 + 7 = 19 products of chain against 51 for one thread (4
// doubles of 7, an add of 16 and the masked double of 7), and 4 times the
// warps; the main path's 90-2,700 rows leave most SMs idle, so the chain's
// latency sets the time: 1.4-1.6 ms at W = 64 on 90-2,700 rows, 1.3 ms at
// W = 16 on 13,500, on an H100 80GB HBM3 at 700 W. 6 and 8 lanes measured
// slower at 2,700 and 13,500 rows (scripts/torch_team_variants.py).
// ptxas: 182 registers, no stack.
constexpr int kLadderTeam = 4;   // lanes per row
constexpr int kLadderTeamsPerWarp = 32 / kLadderTeam;
constexpr int kLadderWarps = 2;
constexpr int kLadderThreads = 32 * kLadderWarps;
constexpr int kLadderRows = kLadderWarps * kLadderTeamsPerWarp;
constexpr int kLadderWidth = 8;   // the most products in one level

using LadderTeam = Team<Fp, kLadderTeam, kLadderWidth>;

struct LadderMem {
  Fp xch[2][kLadderWidth];
  G1 tab[kWindowEntries];
};

__device__ __forceinline__ Fp times8(const Fp& c) {
  const Fp c2 = fadd(c, c);
  const Fp c4 = fadd(c2, c2);
  return fadd(c4, c4);
}

// 2P (pdouble)
__device__ __forceinline__ G1 team_double(LadderTeam& tm, const G1& p) {
  const Fp* r = team_products<3>(tm, {p.X, p.Y, p.Y}, {p.X, p.Y, p.Z});
  const Fp A = r[0], B = r[1], YZ = r[2];
  const Fp E = fadd(fadd(A, A), A);
  const Fp XB = fadd(p.X, B);
  r = team_products<3>(tm, {B, XB, E}, {B, XB, E});
  const Fp C = r[0];
  const Fp t = fsub(r[1], fadd(A, C));
  const Fp D = fadd(t, t);
  G1 q;
  q.X = fsub(r[2], fadd(D, D));
  q.Y = fsub(mont_mul(E, fsub(D, q.X)), times8(C));
  q.Z = fadd(YZ, YZ);
  return q;
}

// P + Q, complete (padd)
__device__ __forceinline__ G1 team_add(LadderTeam& tm, const G1& p,
                                       const G1& q) {
  const Fp* r = team_products<4>(tm, {p.Z, q.Z, p.X, p.Y},
                                 {p.Z, q.Z, p.X, p.Y});
  const Fp Z1Z1 = r[0], Z2Z2 = r[1], A = r[2], B = r[3];
  const Fp E = fadd(fadd(A, A), A);
  const Fp XB = fadd(p.X, B);
  const Fp t1 = fadd(p.Z, q.Z);
  r = team_products<8>(tm, {p.X, q.X, q.Z, p.Z, t1, B, XB, E},
                       {Z2Z2, Z1Z1, Z2Z2, Z1Z1, t1, B, XB, E});
  const Fp U1 = r[0], U2 = r[1], Z2c = r[2], Z1c = r[3];
  const Fp ZZ = fsub(fsub(r[4], Z1Z1), Z2Z2);
  const Fp C = r[5];
  const Fp t = fsub(r[6], fadd(A, C));
  const Fp D = fadd(t, t);
  G1 dbl;
  dbl.X = fsub(r[7], fadd(D, D));
  const Fp H = fsub(U2, U1);
  const Fp HH = fadd(H, H);
  r = team_products<6>(tm, {p.Y, q.Y, HH, ZZ, E, p.Y},
                       {Z2c, Z1c, HH, H, fsub(D, dbl.X), p.Z});
  const Fp S1 = r[0], S2 = r[1], I = r[2];
  G1 res;
  res.Z = r[3];
  dbl.Y = fsub(r[4], times8(C));
  dbl.Z = fadd(r[5], r[5]);
  Fp rr = fsub(S2, S1);
  rr = fadd(rr, rr);
  r = team_products<3>(tm, {H, U1, rr}, {I, I, rr});
  const Fp J = r[0], V = r[1];
  res.X = fsub(fsub(r[2], J), fadd(V, V));
  r = team_products<2>(tm, {S1, rr}, {J, fsub(V, res.X)});
  res.Y = fsub(r[1], fadd(r[0], r[0]));

  const bool p_inf = fis_zero(p.Z);
  const bool q_inf = fis_zero(q.Z);
  const bool h0 = fis_zero(H);
  const bool r0 = fis_zero(rr);
  res = g1_select(mask_of(h0 && r0 && !p_inf && !q_inf), dbl, res);
  res = g1_select(mask_of(h0 && !r0 && !p_inf && !q_inf), g1_inf(), res);
  res = g1_select(mask_of(q_inf), p, res);
  res = g1_select(mask_of(p_inf), q, res);
  return res;
}

// the entry the digit d names, all 16 read under masks
__device__ __forceinline__ G1 ladder_pick(const G1* tab, uint32_t d) {
  G1 s = tab[0];
#pragma unroll 1
  for (int v = 1; v < kWindowEntries; ++v) {
    s = g1_select(mask_of(d == (uint32_t)v), tab[v], s);
  }
  return s;
}

__global__ void __launch_bounds__(kLadderThreads)
    scalar_mul_kernel(const int32_t* __restrict__ p,
                      const int32_t* __restrict__ k,
                      int32_t* __restrict__ out, int n, int n_windows) {
  __shared__ LadderMem mem[kLadderRows];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int team = lane / kLadderTeam;
  if (team == kLadderTeamsPerWarp) return;   // lanes past the last team
  const int i = (blockIdx.x * kLadderWarps + warp) * kLadderTeamsPerWarp +
                team;
  if (i >= n) return;                        // the whole team leaves
  const int slot = lane - kLadderTeam * team;
  LadderMem& m = mem[warp * kLadderTeamsPerWarp + team];
  LadderTeam tm{m.xch, team_mask<kLadderTeam>(kLadderTeam * team), slot, 0};
  const int32_t* ki = k + (size_t)i * NL16;
  const G1 P = load_g1_v(p + (size_t)i * kPointWords);
  G1 prev = P;
  if (slot == 0) {
    m.tab[0] = g1_inf();
    m.tab[1] = P;
  }
  __syncwarp(tm.mask);
#pragma unroll 1
  for (int d = 2; d < kWindowEntries; ++d) {
    // T[d - 1] is in prev; T[d / 2] in the table (written by lane 0 and
    // published by the exchanges since)
    prev = (d % 2 == 0) ? team_double(tm, m.tab[d / 2])
                        : team_add(tm, prev, P);
    if (slot == 0) m.tab[d] = prev;
    __syncwarp(tm.mask);
  }
  G1 acc = ladder_pick(m.tab, window_digit(ki, n_windows - 1));
#pragma unroll 1
  for (int w = n_windows - 2; w >= 0; --w) {
#pragma unroll 1
    for (int s = 0; s < 4; ++s) acc = team_double(tm, acc);
    acc = team_add(tm, acc, ladder_pick(m.tab, window_digit(ki, w)));
  }
  if (slot == 0) store_g1(out + (size_t)i * kPointWords, acc);
}

// Kernel 3 (pallas_ops._point_reduce_kernel): complete-add sum over axis 0
// of (R, N, 3, 16), rows in order 0..R-1.
__global__ void point_reduce_kernel(const int32_t* __restrict__ pts,
                                    int32_t* __restrict__ out, int r, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  G1 acc = load_g1(pts + (size_t)i * kPointWords);
#pragma unroll 1
  for (int j = 1; j < r; ++j) {
    acc = padd(acc, load_g1(pts + ((size_t)j * n + i) * kPointWords));
  }
  store_g1(out + (size_t)i * kPointWords, acc);
}

// Kernel 5 (pallas_ops._point_add_kernel): batched complete add.
__global__ void point_add_kernel(const int32_t* __restrict__ p,
                                 const int32_t* __restrict__ q,
                                 int32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  G1 r = padd(load_g1(p + (size_t)i * kPointWords),
              load_g1(q + (size_t)i * kPointWords));
  store_g1(out + (size_t)i * kPointWords, r);
}

}  // namespace

extern "C" {

int g1_fixed_base_mul(const int32_t* table, const int32_t* k, int32_t* out,
                      int n, int n_windows, void* stream) {
  const int blocks = (n + kFixedBaseRows - 1) / kFixedBaseRows;
  fixed_base_mul_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      table, k, out, n, n_windows);
  return (int)cudaGetLastError();
}

int g1_scalar_mul(const int32_t* p, const int32_t* k, int32_t* out, int n,
                  int n_windows, void* stream) {
  const int blocks = (n + kLadderRows - 1) / kLadderRows;
  scalar_mul_kernel<<<blocks, kLadderThreads, 0, (cudaStream_t)stream>>>(
      p, k, out, n, n_windows);
  return (int)cudaGetLastError();
}

int g1_point_reduce(const int32_t* pts, int32_t* out, int r, int n,
                    void* stream) {
  point_reduce_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      pts, out, r, n);
  return (int)cudaGetLastError();
}

int g1_point_add(const int32_t* p, const int32_t* q, int32_t* out, int n,
                 void* stream) {
  point_add_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      p, q, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"

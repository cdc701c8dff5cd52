// bn256 G2 kernels of range-proof creation. Each replaces one Pallas TPU
// kernel of drynx_tpu/crypto/pallas_pairing.py;
// drynx_tpu_torch/crypto/cuda_pairing.py binds them with ctypes and holds
// each beside its plain PyTorch version.
//
//   g2_scalar_mul  replaces _g2_scalar_mul_kernel (g2_scalar_mul_flat)
//   f2_inv         replaces _f2_inv_kernel        (f2_inv_flat)
//
// f2_inv: 1/(a0 + a1 i) = (a0, -a1) / (a0^2 + a1^2), one row a thread, 32
// threads a block, as fp_inv.cu: the norm (two Montgomery products and an
// add), its Fp inverse by Bernstein and Yang's constant-time safegcd
// (fp_inv.cuh: 20 batches of 30 branch-free divsteps on 30-bit limbs, then
// one product), then the two products by the inverse: the expression of
// gt_ops.cu's team_f12inv, step 4. Every field value the G2 ladder emits
// is a canonical residue, and mont_mul and fadd return canonical residues
// for inputs below p, so the norm handed to safegcd is below p; safegcd
// maps 0 to 0 as x^(p-2) does, so the output is f2_inv_plain's bytes (a
// Fermat power), 0 included. No branch depends on the data. What bounds
// it: instruction issue. The main path's 13,500 rows are 422 warps, about
// 3 an SM, so one thread's chain of ~22,000 integer steps sets the time.
// No team: for the same safegcd at 13,500 rows one lane a row was
// measured faster than six (gt_ops.cu's f12_inv note). On an H100 80GB
// HBM3 at 700 W, at 13,500 rows: 0.028 ms of device time (CUDA graph)
// and 0.033-0.044 through the wrapper, against 0.276 and 0.278 for the
// Fermat chain it replaced; 64 and 128 threads a block within 1.5 % of
// 32 (scripts/torch_team_variants.py). ptxas: 78 registers, no stack.
//
// g2_scalar_mul: k*Q on the twist, 4-bit windows MSB-first over the table
// T[d] = d*Q, 4 doublings and a complete add a window, as
// _g2_scalar_mul_kernel (pallas_pairing.py:1114). A team of kG2LadderTeam
// lanes computes one row: the group law's independent Fp2 products are
// spread over the lanes level by level, in team_ladder.cuh's body, which
// the variable-base G1 ladder of g1_ops.cu shares (the same formulas over
// Fp). The formulas, the select order (P = Q, P = -Q, either operand at
// infinity) and the point at infinity (X = Y = plain (1, 0), Z = 0) are
// those of make_g2_group, so the kernel's Jacobian limbs equal
// g2_scalar_mul_plain's byte for byte. The scalar v of a digit signature
// is a secret blinding factor (pallas_pairing.py:1138-1143): the 16-entry
// table (3 KB a row) sits in shared memory, written by lane 0 and
// published by a __syncwarp, and each window's entry is read from all 16
// under masks, never by an indexed load.
//
// What bounds it: registers, then the chain of dependent Fp2 products.
// Every lane holds whole points (48 words each) and a level's operands, so
// ptxas gives 255 registers and spills (a 584-byte stack, 400 B of spill
// stores): an SM holds 8 warps, and the main path's 13,500 rows (3,375
// warps of 8-lane teams) take about four rounds. With 8 lanes a window is
// 17 Fp2 products of chain (4 doubles of 1 + 1 + 1, an add of 5 levels of
// one round each) against the ~8,000 dependent Montgomery products a row
// of the one-thread kernel this one replaced. On an H100 80GB HBM3 at 700
// W: 23.2 ms at N = 13,500 against that kernel's 29.0, timed in one call;
// 4 and 6 lanes took 24.9 and 24.7 ms, registers capped at 168 35.5 ms
// (scripts/torch_team_variants.py). A row's table and exchange take 4 KB
// of shared memory, a warp's 16 KB.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fp_inv.cuh"
#include "team_ladder.cuh"

using namespace bn256;

namespace {

constexpr int kF2InvThreads = 32;   // f2_inv's block
constexpr int kPointWords = 3 * 2 * NL16;   // int32 words of one G2 point
constexpr int kWindows = 64;

constexpr int kG2LadderTeam = 8;   // lanes per row
constexpr int kG2TeamsPerWarp = 32 / kG2LadderTeam;   // a block is a warp

using G2LadderTeam = Team<Fp2, kG2LadderTeam, kLadderWidth>;

__global__ void __launch_bounds__(32)
    g2_scalar_mul_kernel(const int32_t* __restrict__ p,
                         const int32_t* __restrict__ k,
                         int32_t* __restrict__ out, int n) {
  __shared__ LadderMem<Fp2, G2> mem[kG2TeamsPerWarp];
  const int lane = threadIdx.x;
  const int team = lane / kG2LadderTeam;
  if (team == kG2TeamsPerWarp) return;   // lanes past the last team
  const int i = blockIdx.x * kG2TeamsPerWarp + team;
  if (i >= n) return;                    // the whole team leaves
  const int slot = lane - kG2LadderTeam * team;
  LadderMem<Fp2, G2>& m = mem[team];
  G2LadderTeam tm{m.xch, team_mask<kG2LadderTeam>(kG2LadderTeam * team),
                  slot, 0};
  const G2 acc = team_ladder(tm, m.tab, load_g2(p + (size_t)i * kPointWords),
                             k + (size_t)i * NL16, kWindows);
  if (slot == 0) store_g2(out + (size_t)i * kPointWords, acc);
}

__global__ void __launch_bounds__(kF2InvThreads)
    f2_inv_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                  int n) {
  const int i = blockIdx.x * kF2InvThreads + threadIdx.x;
  if (i >= n) return;
  const Fp2 x = load_fp2(a + (size_t)i * 2 * NL16);
  const Fp ni =
      fp_inv_safegcd(fadd(mont_mul(x.c0, x.c0), mont_mul(x.c1, x.c1)));
  const Fp2 r{mont_mul(x.c0, ni), mont_mul(fsub(fp_zero(), x.c1), ni)};
  store_fp2(out + (size_t)i * 2 * NL16, r);
}

}  // namespace

extern "C" {

int g2_scalar_mul(const int32_t* p, const int32_t* k, int32_t* out, int n,
                  void* stream) {
  const int blocks = (n + kG2TeamsPerWarp - 1) / kG2TeamsPerWarp;
  g2_scalar_mul_kernel<<<blocks, 32, 0, (cudaStream_t)stream>>>(p, k, out,
                                                                 n);
  return (int)cudaGetLastError();
}

int f2_inv(const int32_t* a, int32_t* out, int n, void* stream) {
  f2_inv_kernel<<<(n + kF2InvThreads - 1) / kF2InvThreads, kF2InvThreads, 0,
                  (cudaStream_t)stream>>>(a, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"

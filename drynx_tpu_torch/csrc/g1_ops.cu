// bn256 G1 kernels of the encrypted survey's main path. Each replaces one
// Pallas TPU kernel of drynx_tpu/crypto/pallas_ops.py;
// drynx_tpu_torch/crypto/cuda_ops.py binds them with ctypes and holds each
// beside its plain PyTorch version. Each gives a row a team of threads
// (their notes below); the reduce and the batched add share one body.
//
// What bounds them: integer multiply-adds (a Montgomery product is 64
// 32x32->64-bit products plus as many for the reduction, on the IMAD
// pipe); memory traffic is a few hundred bytes per element. At the main
// path's 90-900 elements the launches fill only a few of the 132 SMs, so
// the latency of the dependent multiply chains, not the card's multiply
// rate, sets their time: a Montgomery product's carry chain is one long
// dependency, ~1-2 us for one warp alone on its scheduler. The teams cut
// that chain: each splits a group-law step's independent products over
// its lanes.
//
// Plain C entry points: each launches on the caller's stream and returns
// cudaGetLastError(), so a refused launch reaches the wrapper, which raises.

#include <cuda_runtime.h>
#include <stdint.h>

#include "team_ladder.cuh"

using namespace bn256;

namespace {

constexpr int kThreads = 128;
constexpr int kPointWords = 3 * NL16;   // int32 words of one point
constexpr int kWindowEntries = 16;      // 4-bit windows

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
// windows MSB-first over the table T[d] = d*P: 4 doublings, then a complete
// add of the entry the digit names.
//
// A team of kLadderTeam lanes computes one row, its group law spread level
// by level over the lanes: team_ladder.cuh, one body with the G2 ladder of
// g2_ops.cu. The table (1.5 KB a row) sits in shared memory.
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

using LadderTeam = Team<Fp, kLadderTeam, kLadderWidth>;

__global__ void __launch_bounds__(kLadderThreads)
    scalar_mul_kernel(const int32_t* __restrict__ p,
                      const int32_t* __restrict__ k,
                      int32_t* __restrict__ out, int n, int n_windows) {
  __shared__ LadderMem<Fp, G1> mem[kLadderRows];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int team = lane / kLadderTeam;
  if (team == kLadderTeamsPerWarp) return;   // lanes past the last team
  const int i = (blockIdx.x * kLadderWarps + warp) * kLadderTeamsPerWarp +
                team;
  if (i >= n) return;                        // the whole team leaves
  const int slot = lane - kLadderTeam * team;
  LadderMem<Fp, G1>& m = mem[warp * kLadderTeamsPerWarp + team];
  LadderTeam tm{m.xch, team_mask<kLadderTeam>(kLadderTeam * team), slot, 0};
  const G1 acc = team_ladder(tm, m.tab,
                             load_g1_v(p + (size_t)i * kPointWords),
                             k + (size_t)i * NL16, n_windows);
  if (slot == 0) store_g1(out + (size_t)i * kPointWords, acc);
}

// Kernels 3 (pallas_ops._point_reduce_kernel) and 5
// (pallas_ops._point_add_kernel): the complete-add sum of a column's rows
// in order 0..R-1. The reduce sums axis 0 of (R, N, 3, 16); the batched
// add is that sum at R = 2, its two rows in two (N, 3, 16) tensors.
//
// The sum is a chain: each add needs the one before. So a team of
// kReduceTeam lanes computes one column, and each complete add is
// team_ladder.cuh's team_add, the body the two ladders share: its 5
// levels of 4, 8, 6, 3 and 2 independent products spread over the lanes,
// then the reference's selects. The team adds the rows in the reference's
// order, 0 to R - 1, with the plain formulas on canonical residues, so its
// limbs equal point_reduce_plain's and point_add_plain's byte for byte (a
// tree over R would give another Jacobian representative). Every lane
// reads each summand itself, a broadcast 16-byte load of the same 192
// bytes, and every lane holds the running sum; lane 0 writes it. The two
// kernels differ only in where row j of column i lies (ReduceRows,
// AddRows), the template argument of their one body, team_column_sum.
//
// What bounds them: the chain's latency. With 8 lanes an add is 5
// products of chain (one a level) against the ~23 of one thread's padd
// (the add's 16 and the double it may select, 7); the main path's 90-900
// columns (23-225 warps, one a block) leave most SMs idle, its 13,500
// fill them about twice. On an H100 80GB HBM3 at 700 W, the reduce: 0.063
// ms at R = 10 over 180 columns and 0.022-0.027 at R = 3 over 90 through
// the wrapper, against 0.389 and 0.088 for one thread a column (an add
// ~6.5 us of device time); 4 lanes measured 10-22 % slower, lane 0
// staging each summand in shared memory no faster. The add: 0.022-0.034
// ms through the wrapper at 90-900 rows and 0.037-0.038 at 13,500,
// against 0.044-0.056 and 0.054 for one thread a row; device time from a
// CUDA graph 0.008 ms at 90-900 rows and 0.035 at 13,500 (one thread a
// row 0.042-0.046 and 0.051). 4 lanes take 0.009-0.010 ms at 90-900 rows
// and 0.027 at 13,500 (half the warps): 6 % more over the cluster
// survey's adds (scripts/torch_team_variants.py). ptxas: 166 registers
// (the add 164), no stack.
constexpr int kReduceTeam = 8;   // lanes per column
constexpr int kReduceTeamsPerWarp = 32 / kReduceTeam;   // a block is a warp
static_assert(32 % kReduceTeam == 0, "the teams tile a warp");

using ReduceTeam = Team<Fp, kReduceTeam, kLadderWidth>;

// row j of column i: the reduce's (R, N) points
struct ReduceRows {
  const int32_t* pts;
  int n;
  __device__ __forceinline__ const int32_t* operator()(int j, int i) const {
    return pts + ((size_t)j * n + i) * kPointWords;
  }
};

// row j of column i: the add's p (j = 0) and q (j = 1)
struct AddRows {
  const int32_t* p;
  const int32_t* q;
  __device__ __forceinline__ const int32_t* operator()(int j, int i) const {
    return (j == 0 ? p : q) + (size_t)i * kPointWords;
  }
};

// out[i] = row 0 + row 1 + ... + row r - 1 of column i, one team a column
template <typename Rows>
__device__ __forceinline__ void team_column_sum(const Rows& rows, int r,
                                                int32_t* __restrict__ out,
                                                int n) {
  __shared__ Fp xch[kReduceTeamsPerWarp][2][kLadderWidth];
  const int team = threadIdx.x / kReduceTeam;
  const int i = blockIdx.x * kReduceTeamsPerWarp + team;
  if (i >= n) return;                    // the whole team leaves
  const int slot = threadIdx.x - kReduceTeam * team;
  ReduceTeam tm{xch[team], team_mask<kReduceTeam>(kReduceTeam * team), slot,
                0};
  G1 acc = load_g1_v(rows(0, i));
#pragma unroll 1
  for (int j = 1; j < r; ++j) {
    const G1 q = load_g1_v(rows(j, i));
    acc = team_add(tm, acc, q);
  }
  if (slot == 0) store_g1(out + (size_t)i * kPointWords, acc);
}

__global__ void __launch_bounds__(32)
    point_reduce_kernel(const int32_t* __restrict__ pts,
                        int32_t* __restrict__ out, int r, int n) {
  team_column_sum(ReduceRows{pts, n}, r, out, n);
}

__global__ void __launch_bounds__(32)
    point_add_kernel(const int32_t* __restrict__ p,
                     const int32_t* __restrict__ q,
                     int32_t* __restrict__ out, int n) {
  team_column_sum(AddRows{p, q}, 2, out, n);
}

inline int column_blocks(int n) {
  return (n + kReduceTeamsPerWarp - 1) / kReduceTeamsPerWarp;
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
  point_reduce_kernel<<<column_blocks(n), 32, 0, (cudaStream_t)stream>>>(
      pts, out, r, n);
  return (int)cudaGetLastError();
}

int g1_point_add(const int32_t* p, const int32_t* q, int32_t* out, int n,
                 void* stream) {
  point_add_kernel<<<column_blocks(n), 32, 0, (cudaStream_t)stream>>>(
      p, q, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"

// bn256 G1 kernels of the encrypted survey's main path, one curve element
// per thread. Each replaces one Pallas TPU kernel of
// drynx_tpu/crypto/pallas_ops.py; drynx_tpu_torch/crypto/cuda_ops.py binds
// them with ctypes and holds each beside its plain PyTorch version.
//
// What bounds them: integer multiply-adds (a Montgomery product is 64
// 32x32->64-bit products plus as many for the reduction, on the IMAD
// pipe); memory traffic is a few hundred bytes per element. At the main
// path's 90-900 elements the launches fill only a few of the 132 SMs, with
// one warp or less per SM, so latency of the dependent multiply chains,
// not the card's multiply rate, sets their time. Filling the card (more
// threads per element, shared-memory tables) is later work.
//
// Plain C entry points: each launches on the caller's stream and returns
// cudaGetLastError(), so a refused launch reaches the wrapper, which raises.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bn256_g1.cuh"

using namespace bn256;

namespace {

constexpr int kThreads = 128;
constexpr int kPointWords = 3 * NL16;   // int32 words of one point
constexpr int kWindowEntries = 16;      // 4-bit windows

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

// Kernel 1 (pallas_ops._fixed_base_kernel): k*P from a shared window table
// table[w][v] = v * 16^w * P, W add-only windows, little-endian digits.
// Each window's 16 entries are staged in shared memory, already repacked
// to 32-bit words, and every thread reads all 16 under masks: the digit is
// secret, so no load depends on it.
__global__ void fixed_base_mul_kernel(const int32_t* __restrict__ table,
                                      const int32_t* __restrict__ k,
                                      int32_t* __restrict__ out, int n,
                                      int n_windows) {
  __shared__ G1 row[kWindowEntries];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const int32_t* ki = k + (size_t)(live ? i : 0) * NL16;
  G1 acc = g1_inf();
  for (int w = 0; w < n_windows; ++w) {
    __syncthreads();
    if (threadIdx.x < kWindowEntries) {
      row[threadIdx.x] = load_g1(
          table + ((size_t)w * kWindowEntries + threadIdx.x) * kPointWords);
    }
    __syncthreads();
    const uint32_t d = window_digit(ki, w);
    G1 sel = row[0];
#pragma unroll 1
    for (int v = 1; v < kWindowEntries; ++v) {
      sel = g1_select(mask_of(d == (uint32_t)v), row[v], sel);
    }
    acc = padd(acc, sel);
  }
  if (live) store_g1(out + (size_t)i * kPointWords, acc);
}

// Kernel 2 (pallas_ops._scalar_mul_kernel): variable-base k*P. The thread
// builds its own table T[d] = d*P (T[2j] = 2T[j], T[2j+1] = T[2j] + P) in
// local memory, then walks 4-bit windows MSB-first: 4 doublings and one
// add of a table entry chosen by a masked read of all 16 entries.
__global__ void scalar_mul_kernel(const int32_t* __restrict__ p,
                                  const int32_t* __restrict__ k,
                                  int32_t* __restrict__ out, int n,
                                  int n_windows) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t* ki = k + (size_t)i * NL16;
  G1 tab[kWindowEntries];
  tab[0] = g1_inf();
  tab[1] = load_g1(p + (size_t)i * kPointWords);
#pragma unroll 1
  for (int d = 2; d < kWindowEntries; ++d) {
    tab[d] = (d % 2 == 0) ? pdouble(tab[d / 2]) : padd(tab[d - 1], tab[1]);
  }
  auto pick = [&](uint32_t d) {
    G1 s = tab[0];
#pragma unroll 1
    for (int v = 1; v < kWindowEntries; ++v) {
      s = g1_select(mask_of(d == (uint32_t)v), tab[v], s);
    }
    return s;
  };
  G1 acc = pick(window_digit(ki, n_windows - 1));
#pragma unroll 1
  for (int w = n_windows - 2; w >= 0; --w) {
#pragma unroll 1
    for (int s = 0; s < 4; ++s) acc = pdouble(acc);
    acc = padd(acc, pick(window_digit(ki, w)));
  }
  store_g1(out + (size_t)i * kPointWords, acc);
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
  fixed_base_mul_kernel<<<blocks_for(n), kThreads, 0,
                          (cudaStream_t)stream>>>(table, k, out, n, n_windows);
  return (int)cudaGetLastError();
}

int g1_scalar_mul(const int32_t* p, const int32_t* k, int32_t* out, int n,
                  int n_windows, void* stream) {
  scalar_mul_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
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

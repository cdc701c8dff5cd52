// Fp12 (GT) product kernels of range-proof creation, one row per thread.
// Each replaces one Pallas TPU kernel of drynx_tpu/crypto/pallas_pairing.py;
// drynx_tpu_torch/crypto/cuda_pairing.py binds them with ctypes and holds
// each beside its plain PyTorch version.
//
//   f12_mul         replaces _f12_mul_kernel         (f12_mul_flat)
//   f12_mulreduce8  replaces _f12_mulreduce8_kernel  (f12_mulreduce8_flat)
//
// What bounds them: an Fp12 product is 54 Montgomery products (18 Fp2
// products of 3), 256 32-bit multiply-adds each, against 2 x 384 bytes in
// and 384 out; mulreduce8 does 7 products per 3 KB read. Both are
// operation-bound by that count (about 40 multiply-adds per byte against
// the card's ~5 per byte). An Fp12 value is 96 32-bit words, so the
// accumulator and the operand alone fill most of a thread's registers; the
// Fp6 products are not inlined and keep their temporaries in their own
// frame, and what does not fit spills to local memory (L1). Rows are read
// with 16-byte vector loads. The window gather that feeds mulreduce8 in the
// fixed-base GT powers stays a torch index op (an intermediate of 64
// entries x 768 bytes per power); fusing it here is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bn256_tower.cuh"

using namespace bn256;

namespace {

constexpr int kThreads = 128;
constexpr int kF12Words = 6 * 2 * NL16;   // int32 words of one Fp12 value

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

__global__ void f12_mul_kernel(const int32_t* __restrict__ a,
                               const int32_t* __restrict__ b,
                               int32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t off = (size_t)i * kF12Words;
  store_fp12(out + off, f12mul(load_fp12(a + off), load_fp12(b + off)));
}

// out[i] = g[i][0] * g[i][1] * ... * g[i][7], left to right
__global__ void f12_mulreduce8_kernel(const int32_t* __restrict__ g,
                                      int32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t* row = g + (size_t)i * 8 * kF12Words;
  Fp12 acc = load_fp12(row);
#pragma unroll 1
  for (int w = 1; w < 8; ++w) acc = f12mul(acc, load_fp12(row + w * kF12Words));
  store_fp12(out + (size_t)i * kF12Words, acc);
}

}  // namespace

extern "C" {

int f12_mul(const int32_t* a, const int32_t* b, int32_t* out, int n,
            void* stream) {
  f12_mul_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      a, b, out, n);
  return (int)cudaGetLastError();
}

int f12_mulreduce8(const int32_t* g, int32_t* out, int n, void* stream) {
  f12_mulreduce8_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      g, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"

// Kernel 4: per-element Fermat inversion x^(p-2) in Fp, one element per
// thread. Replaces the Pallas TPU kernel _fp_inv_kernel / fp_inv_flat of
// drynx_tpu/crypto/pallas_pairing.py; drynx_tpu_torch/crypto/cuda_pairing.py
// binds it with ctypes and holds it beside its plain PyTorch version.
//
// The reference multiplies always and selects per bit, to keep its traced
// loop body small. The exponent here is the public constant p - 2, so this
// kernel multiplies only where a bit is set: 255 squarings and 124
// products, the same residue. What bounds it: the dependent chain of 379
// Montgomery products per element; at the 90 elements of the main path
// one block of threads runs on one SM, so the chain's latency sets the time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bn256_g1.cuh"

using namespace bn256;

namespace {

constexpr int kThreads = 128;

__global__ void fp_inv_kernel(const int32_t* __restrict__ x,
                              int32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fp base = load_fp(x + (size_t)i * NL16);
  Fp acc = base;
  // bits of p - 2 below its top bit (bit 255), MSB first; p - 2 differs
  // from p only in word 0
#pragma unroll 1
  for (int b = 254; b >= 0; --b) {
    acc = mont_mul(acc, acc);
    const uint32_t word = (b < 32) ? p_word(0) - 2u : p_word(b >> 5);
    if ((word >> (b & 31)) & 1u) acc = mont_mul(acc, base);
  }
  store_fp(out + (size_t)i * NL16, acc);
}

}  // namespace

extern "C" int fp_inv(const int32_t* x, int32_t* out, int n, void* stream) {
  fp_inv_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                  (cudaStream_t)stream>>>(x, out, n);
  return (int)cudaGetLastError();
}

// Kernel 4: per-element inversion in Fp, one element per thread. Replaces
// the Pallas TPU kernel _fp_inv_kernel / fp_inv_flat of
// drynx_tpu/crypto/pallas_pairing.py; drynx_tpu_torch/crypto/cuda_pairing.py
// binds it with ctypes and holds it beside its plain PyTorch version, the
// Fermat power x^(p-2).
//
// The kernel computes the same residue by Bernstein and Yang's
// constant-time safegcd (fp_inv.cuh): 20 batches of 30 divsteps and their
// matrix products on 30-bit limbs, then one Montgomery product, in place of
// the Fermat chain's 379 dependent Montgomery products. Canonical residues
// in and out, so its bytes are the plain version's. What bounds it: one
// thread's chain of integer steps; the main path's launches (<= 13,500
// rows) are one wave, so that chain's latency sets the time at every shape:
// 0.022-0.025 ms from 90 to 13,500 rows at 32 threads a block, 11-13 % less
// than at 64 or 128 (scripts/torch_team_variants.py; H100 80GB HBM3,
// 700 W).

#include <cuda_runtime.h>
#include <stdint.h>

#include "fp_inv.cuh"

using namespace bn256;

namespace {

constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads)
    fp_inv_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                  int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  store_fp(out + (size_t)i * NL16,
           fp_inv_safegcd(load_fp(x + (size_t)i * NL16)));
}

}  // namespace

extern "C" int fp_inv(const int32_t* x, int32_t* out, int n, void* stream) {
  fp_inv_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                  (cudaStream_t)stream>>>(x, out, n);
  return (int)cudaGetLastError();
}

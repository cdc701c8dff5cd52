// Fp12 (GT) kernels of range-proof creation and verification, one row per
// thread. Each replaces one Pallas TPU kernel of
// drynx_tpu/crypto/pallas_pairing.py; drynx_tpu_torch/crypto/cuda_pairing.py
// binds them with ctypes and holds each beside its plain PyTorch version.
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
// the card's ~5 per byte). An Fp12 value is 96 32-bit words, so the
// accumulator and the operand alone fill most of a thread's registers; the
// Fp6 products are not inlined and keep their temporaries in their own
// frame, and what does not fit spills to local memory (L1). Rows are read
// with 16-byte vector loads. The window gather that feeds mulreduce8 in the
// fixed-base GT powers stays a torch index op (an intermediate of 64
// entries x 768 bytes per power); fusing it here is later work.
//
// The verification kernels are the same kind of chain. f12_inv is 488
// Montgomery products per row, 379 of them the Fermat inverse's dependent
// chain; f12_csqr 18 and f12_slotmul 18 (six Fp2 products by constants that
// every thread reads from one small array). f12_wpow is f^k by 3-bit windows
// MSB-first over an 8-entry table [1, f, f^2, ..., f^7] in local memory
// (3 KB per thread, like the G2 ladder's): 4,752 products at 128 bits and
// 2,376 at 63 with cyclotomic squares. The exponents are RLC weights the
// verifier keeps secret, so a window's entry is chosen by reading all eight
// under masks (pallas_pairing.py:611-615), never by an indexed load. At the
// verifier's 13,500 rows a launch is one wave, so the per-thread chain's
// latency, not the card's multiply rate, sets the time.
//
// f12_pow is the reference's first power, square-and-multiply-always
// LSB-first over n_bits bits: per bit one product (kept by mask where the
// bit is set) and one square, 90 Montgomery products per bit. No path of
// the port runs it (the windowed power replaced it in the reference too);
// it is kept so that every Pallas kernel has its counterpart.

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

__global__ void f12_inv_kernel(const int32_t* __restrict__ a,
                               int32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t off = (size_t)i * kF12Words;
  store_fp12(out + off, f12inv(load_fp12(a + off)));
}

__global__ void f12_csqr_kernel(const int32_t* __restrict__ a,
                                int32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t off = (size_t)i * kF12Words;
  store_fp12(out + off, f12csqr(load_fp12(a + off)));
}

// out[k] = (conj(a[k]) if conj else a[k]) * c[k]: the Frobenius maps of the
// flat tower (c = powers of XI^((p^e - 1)/6), conj for odd e) and conj6
// (c = +-1); c is one (6, 2, 16) Montgomery array shared by every row
__global__ void f12_slotmul_kernel(const int32_t* __restrict__ a,
                                   const int32_t* __restrict__ c,
                                   int32_t* __restrict__ out, int n, int conj) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t off = (size_t)i * kF12Words;
  const Fp12 f = load_fp12(a + off);
  Fp12 r;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const Fp2 x = conj ? f2conj(f.c[k]) : f.c[k];
    r.c[k] = f2mul(x, load_fp2(c + 2 * NL16 * k));
  }
  store_fp12(out + off, r);
}

// 3-bit window w (bits 3w..3w+2) of a scalar held as 16 x 16-bit limbs; a
// window may straddle two limbs, and bits past the top limb are 0
__device__ __forceinline__ uint32_t window3(const int32_t* k, int w) {
  const int limb = (3 * w) >> 4, s = (3 * w) & 15;
  uint32_t d = (uint32_t)k[limb] >> s;
  if (s > 13 && limb + 1 < NL16) d |= (uint32_t)k[limb + 1] << (16 - s);
  return d & 7u;
}

__device__ __forceinline__ Fp12 square(const Fp12& a, int cyc) {
  return cyc ? f12csqr(a) : f12sqr(a);
}

// f^k over ceil(n_bits / 3) windows MSB-first: the table T[d] = f^d
// (T[2j] = T[j]^2, T[2j+1] = T[2j] f), then per window three squares and a
// product with the entry its digit picks. cyc swaps every square, in the
// table and in the chain, for the cyclotomic one (f in GPhi12 only).
__global__ void f12_wpow_kernel(const int32_t* __restrict__ f,
                                const int32_t* __restrict__ k,
                                int32_t* __restrict__ out, int n, int n_bits,
                                int cyc) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t* ki = k + (size_t)i * NL16;
  Fp12 tab[8];
  tab[0] = f12_one();
  tab[1] = load_fp12(f + (size_t)i * kF12Words);
#pragma unroll 1
  for (int d = 2; d < 8; ++d) {
    tab[d] = (d % 2 == 0) ? square(tab[d / 2], cyc)
                          : f12mul(tab[d - 1], tab[1]);
  }
  auto pick = [&](uint32_t d) {
    Fp12 s = tab[0];
#pragma unroll 1
    for (int v = 1; v < 8; ++v) {
      s = f12select(mask_of(d == (uint32_t)v), tab[v], s);
    }
    return s;
  };
  const int n_win = (n_bits + 2) / 3;
  Fp12 acc = pick(window3(ki, n_win - 1));
#pragma unroll 1
  for (int w = n_win - 2; w >= 0; --w) {
#pragma unroll 1
    for (int s = 0; s < 3; ++s) acc = square(acc, cyc);
    acc = f12mul(acc, pick(window3(ki, w)));
  }
  store_fp12(out + (size_t)i * kF12Words, acc);
}

// f^k, LSB-first: acc *= base where bit w of k is set, base squared after
// every bit, as _f12_pow_kernel (pallas_pairing.py:541-569). The product is
// computed at every bit and kept by mask, so the time does not depend on k.
__global__ void f12_pow_kernel(const int32_t* __restrict__ f,
                               const int32_t* __restrict__ k,
                               int32_t* __restrict__ out, int n, int n_bits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t* ki = k + (size_t)i * NL16;
  Fp12 acc = f12_one();
  Fp12 base = load_fp12(f + (size_t)i * kF12Words);
#pragma unroll 1
  for (int w = 0; w < n_bits; ++w) {
    const uint32_t bit = ((uint32_t)ki[w >> 4] >> (w & 15)) & 1u;
    acc = f12select(mask_of(bit == 1u), f12mul(acc, base), acc);
    base = f12sqr(base);
  }
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

int f12_inv(const int32_t* a, int32_t* out, int n, void* stream) {
  f12_inv_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(a, out,
                                                                        n);
  return (int)cudaGetLastError();
}

int f12_csqr(const int32_t* a, int32_t* out, int n, void* stream) {
  f12_csqr_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(a, out,
                                                                         n);
  return (int)cudaGetLastError();
}

int f12_slotmul(const int32_t* a, const int32_t* c, int32_t* out, int n,
                int conj, void* stream) {
  f12_slotmul_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      a, c, out, n, conj);
  return (int)cudaGetLastError();
}

int f12_wpow(const int32_t* f, const int32_t* k, int32_t* out, int n,
             int n_bits, int cyc, void* stream) {
  f12_wpow_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      f, k, out, n, n_bits, cyc);
  return (int)cudaGetLastError();
}

int f12_pow(const int32_t* f, const int32_t* k, int32_t* out, int n,
            int n_bits, void* stream) {
  f12_pow_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      f, k, out, n, n_bits);
  return (int)cudaGetLastError();
}

}  // extern "C"

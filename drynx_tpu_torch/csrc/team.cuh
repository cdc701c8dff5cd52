// A team of lanes of one warp computing one row together, and the
// exchange through which its lanes trade values: the layout shared by the
// port's team kernels (miller.cu; the variable-base ladders of g1_ops.cu
// and g2_ops.cu, through team_ladder.cuh; gt_ops.cu's windowed GT power
// and 8-way product).
//
// A team's lanes are consecutive lanes of one warp, so a team never
// straddles two warps and __syncwarp on the team's lanes is its barrier.
// Each team owns two exchange buffers in shared memory, written in turn:
// a lane writes its values into the next buffer, the team meets at the
// barrier, and every lane then reads the whole buffer. A lane reads a
// buffer only before its next exchange, and a buffer is written again
// only two exchanges later, after every lane of the team has passed the
// barrier between, so one barrier per exchange suffices.
//
// team_products spreads one level of a formula (products that do not
// depend on each other) over the lanes: with K products and S lanes, each
// lane computes ceil(K / S) of them, and every lane reads all K back. So
// every lane holds the same values afterwards with no further exchange,
// and its dependent chain is the number of levels times ceil(K / S)
// products, not the formula's whole count.
#pragma once

#include <stdint.h>

#include "bn256_tower.cuh"

namespace bn256 {

// Every Fp2 product of the team kernels: one body, called (code size; the
// Miller loop measured slower with it inlined)
static __device__ __noinline__ Fp2 mul2(const Fp2& a, const Fp2& b) {
  return f2mul(a, b);
}

__device__ __forceinline__ Fp team_mul(const Fp& a, const Fp& b) {
  return mont_mul(a, b);
}

__device__ __forceinline__ Fp2 team_mul(const Fp2& a, const Fp2& b) {
  return mul2(a, b);
}

__device__ __forceinline__ Fp team_select(uint32_t m, const Fp& a,
                                          const Fp& b) {
  return fp_select(m, a, b);
}

__device__ __forceinline__ Fp2 team_select(uint32_t m, const Fp2& a,
                                           const Fp2& b) {
  return f2select(m, a, b);
}

// A lane's place in its team of kSize lanes, and the team's two exchange
// buffers of kWidth values of type T each
template <typename T, int kSize, int kWidth>
struct Team {
  T (*buf)[kWidth];    // two buffers, in shared memory
  uint32_t mask;       // the team's lanes, for __syncwarp
  int slot;            // this lane's index in the team, 0 .. kSize - 1
  int next;            // the buffer of the next exchange

  // The buffer this lane writes its values into before publish()
  __device__ __forceinline__ T* out() const { return buf[next]; }

  // Returns the buffer written since the last exchange, once every lane
  // of the team has written its values
  __device__ __forceinline__ const T* publish() {
    T* b = buf[next];
    next ^= 1;
    __syncwarp(mask);
    return b;
  }

  // Leave v at this lane's slot of the next buffer and publish it
  __device__ __forceinline__ const T* exchange(const T& v) {
    buf[next][slot] = v;
    return publish();
  }
};

// The team's lanes for the team of kSize lanes starting at warp lane `first`
template <int kSize>
__device__ __forceinline__ uint32_t team_mask(int first) {
  static_assert(kSize >= 1 && kSize <= 32, "a team lies within one warp");
  return (kSize == 32 ? 0xFFFFFFFFu : ((1u << kSize) - 1u)) << first;
}

// One level of a formula spread over the team: product j = a[j] b[j] is
// computed by lane j % kSize (in round j / kSize) and every lane gets all K
// back, at indices 0 .. K - 1 of the returned buffer. A lane with no
// product in a round repeats the round's first one and stores nothing.
template <int K, typename T, int kSize, int kWidth>
__device__ __forceinline__ const T* team_products(Team<T, kSize, kWidth>& tm,
                                                  const T (&a)[K],
                                                  const T (&b)[K]) {
  static_assert(K <= kWidth, "a level's products fit in one buffer");
  T* dst = tm.out();
#pragma unroll
  for (int j0 = 0; j0 < K; j0 += kSize) {
    T x = a[j0], y = b[j0];
#pragma unroll
    for (int s = 1; s < kSize && j0 + s < K; ++s) {
      const uint32_t m = mask_of(tm.slot == s);
      x = team_select(m, a[j0 + s], x);
      y = team_select(m, b[j0 + s], y);
    }
    const T p = team_mul(x, y);
    if (j0 + tm.slot < K) dst[j0 + tm.slot] = p;
  }
  return tm.publish();
}

}  // namespace bn256

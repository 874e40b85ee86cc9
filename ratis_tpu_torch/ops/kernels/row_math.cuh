// Row math shared by the kernel sources that reduce a group row: the
// majority-min of K1, K5 and K6's row pass (resident_step.cu) and of
// K7c (vote_lease.cu), the bitmask of a bool peer row, XLA's index
// normalisation and int32 arithmetic that wraps as XLA's does.
//
// A row holds at most MAXP peer slots, kept in registers.  Signed
// overflow is undefined in C++, so every int32 sum or difference that XLA
// wraps is done in uint32 and cast back.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define MAXP 16

namespace {

constexpr int32_t kIntMin = INT32_MIN;
constexpr int32_t kIntMax = INT32_MAX;
constexpr int kThreads = 256;

inline int blocks(int n) { return (n + kThreads - 1) / kThreads; }

__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

// XLA's index normalisation: [-n, -1] -> [0, n); the caller drops the rest
__device__ __forceinline__ int wrap_index(int32_t i, int n) {
  return i < 0 ? i + n : i;
}

__device__ __forceinline__ unsigned row_bits(const uint8_t* m, int P) {
  unsigned bits = 0;
#pragma unroll
  for (int i = 0; i < MAXP; ++i)
    if (i < P && m[i]) bits |= 1u << i;
  return bits;
}

// ascending-sorted member values at position (k-1)/2, found by counting
// ranks (O(P^2) compares, no sort, no local memory); INT32_MIN when the
// mask is empty (ops.quorum.majority_min)
__device__ __forceinline__ int32_t majority_min(const int32_t (&v)[MAXP],
                                                unsigned mask) {
  int k = __popc(mask);
  if (k == 0) return kIntMin;
  int pos = (k - 1) / 2;
  int32_t res = kIntMin;
#pragma unroll
  for (int i = 0; i < MAXP; ++i) {
    if (!((mask >> i) & 1u)) continue;
    int rank = 0;
#pragma unroll
    for (int j = 0; j < MAXP; ++j)
      if (((mask >> j) & 1u) && (v[j] < v[i] || (v[j] == v[i] && j < i)))
        ++rank;
    if (rank == pos) res = v[i];
  }
  return res;
}

// joint consensus: the min over both confs while conf_old is non-empty
// (ops.quorum.combined_majority_min)
__device__ __forceinline__ int32_t combined_majority_min(
    const int32_t (&v)[MAXP], unsigned cur, unsigned old) {
  int32_t m = majority_min(v, cur);
  if (old != 0) m = min(m, majority_min(v, old));
  return m;
}

}  // namespace

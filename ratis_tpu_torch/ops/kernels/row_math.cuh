// Row math shared by the kernel sources that reduce a group row: the
// majority-min of the row pass of K1, K2, K5 and K6 (resident_step.cu)
// and of K7c (vote_lease.cu), in one thread per row (``majority_min``)
// or with a row's slots spread over the lanes of a warp segment
// (``lane_majority_min``, ``lane_pick``); the launch of a kernel in rows
// of kRowLanes lanes and the bit word of one of its slot planes
// (``lane_row_blocks``, ``lane_bits``: K7b, K7c and K3's public tally);
// the bitmask of a bool peer row, XLA's index normalisation, int32
// arithmetic that wraps as XLA's does, the staging of rows into shared
// memory with 16-byte asynchronous copies (K1, K2, K5 and K3's public
// tally), and the block-wide scan of an int32 index array that K1, K2,
// K5, K6 and K7a run over their events' rows.
//
// A row holds at most MAXP peer slots, kept in registers.  Signed
// overflow is undefined in C++, so every int32 sum or difference that XLA
// wraps is done in uint32 and cast back.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

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

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// Copy nbytes of global memory into shared memory with the block's
// threads: 16-byte asynchronous copies for the aligned bulk (complete
// after cp_async_wait_all), plain byte loads for the rest.
__device__ __forceinline__ void stage(void* smem, const void* gmem,
                                      int nbytes) {
  int head = 0;
  if (aligned16(gmem)) {
    head = nbytes & ~15;
    for (int i = threadIdx.x * 16; i < head; i += blockDim.x * 16)
      cp_async16((char*)smem + i, (const char*)gmem + i);
  }
  for (int i = head + threadIdx.x; i < nbytes; i += blockDim.x)
    ((char*)smem)[i] = ((const char*)gmem)[i];
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// f(i, a[i]) for every i in [0, n), split over the block's threads, with
// 16-byte loads when the array is aligned, kScanBatch of them issued
// together before f runs on any (f's shared-memory atomics would
// otherwise hold each load back until the one before had landed)
constexpr int kScanBatch = 4;

template <typename F>
__device__ __forceinline__ void for_each_index(const int32_t* a, int n,
                                               F&& f) {
  int head = 0;
  if (aligned16(a)) {
    head = n & ~3;
    const int4* v = reinterpret_cast<const int4*>(a);
    const int nv = head / 4;
    for (int base = threadIdx.x; base < nv;
         base += kScanBatch * blockDim.x) {
      int4 x[kScanBatch];
#pragma unroll
      for (int k = 0; k < kScanBatch; ++k) {
        const int i = base + k * blockDim.x;
        x[k] = i < nv ? __ldg(v + i) : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int k = 0; k < kScanBatch; ++k) {
        const int i = base + k * blockDim.x;
        if (i < nv) {
          f(4 * i, x[k].x);
          f(4 * i + 1, x[k].y);
          f(4 * i + 2, x[k].z);
          f(4 * i + 3, x[k].w);
        }
      }
    }
  }
  for (int i = head + threadIdx.x; i < n; i += blockDim.x) f(i, __ldg(a + i));
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

constexpr unsigned kFullWarp = 0xffffffffu;

// The value ``cand`` of the first lane of this lane's L-lane segment
// whose ``pick`` is set, INT32_MIN where none is; every lane of the warp
// must call it.
template <int L>
__device__ __forceinline__ int32_t lane_pick(bool pick, int32_t cand,
                                             int shift) {
  const unsigned who =
      (__ballot_sync(kFullWarp, pick) >> shift) & ((1u << L) - 1u);
  const int32_t m = __shfl_sync(kFullWarp, cand, who ? __ffs(who) - 1 : 0,
                                L);
  return who ? m : kIntMin;
}

// The majority-min of one row whose peer values lie one per lane in a
// segment of L lanes (lane i holds peer i): the member whose rank, counted
// over ``mask`` with ties broken by peer index, is (k-1)/2; INT32_MIN for
// an empty mask (ops.quorum.majority_min).  ``rank`` is the lane's rank
// among the members; every lane of the warp must call it.
template <int L>
__device__ __forceinline__ int32_t lane_majority_min(int32_t v, int rank,
                                                     unsigned mask,
                                                     int lane, int shift) {
  const int k = __popc(mask);
  return lane_pick<L>(((mask >> lane) & 1u) && rank == (k - 1) / 2, v,
                      shift);
}

// Rows of kRowLanes lanes, 4 rows a warp: lane l of a row holds peer
// slot l, and slot l + 8 where a lane holds two (``slots``, 1 or 2;
// ops.quorum.lease_slots).
constexpr int kRowLanes = 8;

// The blocks that cover G rows of kRowLanes lanes, kThreads threads a
// block; -1 where the launch cannot hold them (G < 0, P outside [1, 8 *
// slots], slots not 1 or 2, or more threads than an int counts).
inline int lane_row_blocks(int G, int P, int slots) {
  if (G < 0 || P < 1 || (slots != 1 && slots != 2) ||
      P > slots * kRowLanes || (long long)G * kRowLanes > INT_MAX)
    return -1;
  return (int)(((long long)G * kRowLanes + kThreads - 1) / kThreads);
}

// One slot plane of a row held over L lanes as a bit word: bit (l + L s)
// is ``v`` on lane l of this lane's segment (``shift``: the segment's
// first lane in the warp).  Every lane of the warp must call it.
template <int L>
__device__ __forceinline__ unsigned lane_bits(bool v, int shift, int s) {
  return ((__ballot_sync(kFullWarp, v) >> shift) & ((1u << L) - 1u))
         << (L * s);
}

}  // namespace

// K7: the vote-reply scatter (K7a), the all-members replicated index
// (K7b) and the leader-lease expiry (K7c).
//
// Replaces ratis_tpu/ops/quorum.py:apply_vote_events (K7a),
// ratis_tpu/ops/quorum.py:all_replicated_min (K7b) and
// ratis_tpu/ops/quorum.py:lease_expiry (K7c), which XLA compiled from jnp
// ops.  All three are functional, like their JAX originals: they write
// fresh outputs and none of their inputs.
//
// K7a: first reply wins.  The gate reads the INPUT masks: an event whose
// (group, peer) already granted or rejected is dropped, and two events for
// one (group, peer) in a batch both pass it (a grant and a reject in one
// batch set both masks, as in JAX).  So the outputs are copies of the
// input masks, and an event that passes stores 1 into an output byte; it
// never reads what it writes.  Stores of the same value are idempotent,
// so no atomics.  Indices follow XLA: a group or peer in [-n, -1] counts
// from the end of its own dimension, one outside [-n, n) is dropped, and
// an invalid event writes nothing.
//
// K7b: the min over the members of conf_cur | conf_old, each slot's
// value ``self ? flush : match`` (so several self bits in a row, or none,
// behave as in JAX); INT32_MIN for an empty union.
//
// K7c: the joint majority-min of the ack times with the leader's slot set
// to INT32_MAX, then min(q, INT32_MAX - t) + t.  Both int32 operations
// wrap as XLA's do (a negative t wraps the cap and the sum), so they are
// done in uint32.
//
// Bound on the card: each is a pass over [G, P] bytes and int32s with a
// few operations per element.  At G = 1024, P = 8 K7b reads ~65 KB and
// K7c ~57 KB (~0.02 us at 3.35 TB/s); K7a reads and writes the two bool
// masks (~33 KB) plus 10 bytes per event.  At 1024 rows latency binds
// them: of the launch, and of the dependent steps inside it.  At 102400
// rows K7b must move 6.6 MB (2.0 us), K7c 5.7 MB (1.7 us) and K7a with
// 2G events 5.3 MB (1.6 us), so there the loads must be coalesced and
// spread over the whole card.  So:
//
// - K7b (``replicated_min``) is one launch in rows of 8 lanes, 4 rows a
//   warp, G * 8 / 256 blocks (3200 at 102400 rows); a lane holds one
//   slot (P <= 8) or two (slots l and l + 8).  A lane issues all of its
//   loads before it uses any: its slots' match index and three mask
//   bytes, and the row's flush index (one address on the row's 8 lanes),
//   so a row's loads are in flight together and a warp's cover 4 rows of
//   neighbouring bytes (128 B of match at P = 8).  The row's min is three
//   shuffle steps over the 8 lanes, the empty union one ballot; lane 0
//   stores.  Staged tiles of rows with one thread a row (as K3's design
//   (b), tally_votes.cu) measured no faster at 102400 x 8 and slower at
//   1024 rows.
// - K7c (``lease``) is one launch with a row's peer slots spread over
//   the lanes of a warp segment, as the tile kernel's row math
//   (resident_step.cu): rows of 8 lanes, 4 rows a warp, G * 8 / 256
//   blocks; a lane holds one slot (P <= 8) or two (slots l and l + 8).
//   A lane issues its loads together, each slot's ack time and three mask
//   bytes (a warp reads 4 rows x 32 B of acks at P = 8: coalesced); the
//   conf bits come from ballots over the row's lanes, the slots ordered
//   before each of the lane's from 8 shuffles a slot held (a bit mask, so
//   its rank among either conf's members is one popcount), and the
//   member of rank (k-1)/2 from one more ballot (row_math.cuh
//   ``lane_pick``).  Slots past P load nothing and are no member of
//   either conf.  An earlier design took a row per thread: 8 strided
//   loads and 24 byte loads a thread, two O(P^2) rank loops, 4 blocks at
//   1024 rows; one with a lane per slot, rows of 16 lanes for P > 8, took
//   as long as it at 102400 x 16 (each of its 16 lanes 16 shuffle steps).
//   At 102400 rows the shuffle steps bind it, not the bytes.
// - K7a is one launch, by one of two designs that the host picks from
//   (G, P, E) (``ops.quorum.vote_rows``); an earlier design copied both
//   masks with two device copies before the event launch, three graph
//   nodes.  The copy of a row must land before an event sets a bit in
//   it, across blocks:
//   (a) ``vote_rows``: each block owns a range of rows (a multiple of 16:
//       its byte range of each mask starts 16-byte aligned), copies them
//       in 16-byte vectors, scans the group row of every event (16-byte
//       loads, from L2) listing those that land in its rows (up to
//       kVoteHits; a block that more land in has each thread scan the
//       events again), and after a block barrier lands them.  Every
//       block reads every event's group row, so a block's scan grows
//       with E: the host takes (a) up to 4096 events;
//   (b) ``vote_grid``: one cooperative launch of at most two blocks a
//       multiprocessor: a grid-stride copy in 16-byte vectors, one grid
//       sync, a grid-stride pass over the events.  O(G * P + E) work and
//       one grid sync; at 2G events the gate's and the store's random
//       bytes bind it.
//   Both read the gate from the input masks, never from the outputs.

#include <cooperative_groups.h>

#include <algorithm>

#include "row_math.cuh"

namespace {

// -- K7a ---------------------------------------------------------------------

// the input masks and events, and the two output masks
struct VoteArgs {
  const uint8_t* grants;
  const uint8_t* rejects;
  const int32_t* ev_g;
  const int32_t* ev_p;
  const uint8_t* ev_granted;
  const uint8_t* ev_valid;
  uint8_t* out_g;
  uint8_t* out_r;
};

// the events a design (a) block lists
constexpr int kVoteHits = 1024;

// Land event e if its group row lies in [r0, r1).  Its four fields are
// loaded together, the gate after them: two dependent loads before the
// store, not four.
__device__ __forceinline__ void land_vote(const VoteArgs& a, int e, int r0,
                                          int r1, int G, int P) {
  const int32_t raw_g = a.ev_g[e], raw_p = a.ev_p[e];
  const uint8_t valid = a.ev_valid[e], granted = a.ev_granted[e];
  const int g = wrap_index(raw_g, G), p = wrap_index(raw_p, P);
  // invalid, dropped, or another block's row
  if (!valid || g < r0 || g >= r1 || p < 0 || p >= P) return;
  const size_t i = (size_t)g * P + p;
  if (a.grants[i] | a.rejects[i]) return;  // this peer already replied
  (granted ? a.out_g : a.out_r)[i] = 1;
}

// Copy bytes [lo, hi) of src to dst, thread t of n: 16-byte vectors where
// both sides are 16-byte aligned at lo, bytes for the rest.
__device__ __forceinline__ void copy_range(uint8_t* __restrict__ dst,
                                           const uint8_t* __restrict__ src,
                                           size_t lo, size_t hi, size_t t,
                                           size_t n) {
  size_t head = lo;
  if (aligned16(dst + lo) && aligned16(src + lo)) {
    const size_t nv = (hi - lo) / 16;
    const int4* s = reinterpret_cast<const int4*>(src + lo);
    int4* d = reinterpret_cast<int4*>(dst + lo);
    for (size_t k = t; k < nv; k += n) d[k] = __ldg(s + k);
    head = lo + nv * 16;
  }
  for (size_t k = head + t; k < hi; k += n) dst[k] = src[k];
}

// Design (a): block b owns rows [b * rows, (b + 1) * rows).
__global__ void __launch_bounds__(kThreads)
    vote_rows(VoteArgs a, int G, int P, int E, int rows) {
  __shared__ int hit[kVoteHits];
  __shared__ int n_hits;
  const int r0 = blockIdx.x * rows;
  const int r1 = min(G, r0 + rows);
  if (threadIdx.x == 0) n_hits = 0;
  __syncthreads();
  copy_range(a.out_g, a.grants, (size_t)r0 * P, (size_t)r1 * P, threadIdx.x,
             blockDim.x);
  copy_range(a.out_r, a.rejects, (size_t)r0 * P, (size_t)r1 * P, threadIdx.x,
             blockDim.x);
  for_each_index(a.ev_g, E, [&](int e, int32_t raw) {
    const int g = wrap_index(raw, G);
    if (g < r0 || g >= r1) return;
    const int k = atomicAdd(&n_hits, 1);
    if (k < kVoteHits) hit[k] = e;
  });
  // the block's copies land before any of its events
  __syncthreads();
  const int n = n_hits;
  if (n <= kVoteHits) {
    for (int h = threadIdx.x; h < n; h += blockDim.x)
      land_vote(a, hit[h], r0, r1, G, P);
  } else {  // more events landed in the block than it listed
    for (int e = threadIdx.x; e < E; e += blockDim.x)
      land_vote(a, e, r0, r1, G, P);
  }
}

// Design (b): one cooperative launch.
__global__ void __launch_bounds__(kThreads)
    vote_grid(VoteArgs a, int G, int P, int E) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n = (size_t)gridDim.x * blockDim.x;
  const size_t gp = (size_t)G * P;
  copy_range(a.out_g, a.grants, 0, gp, t, n);
  copy_range(a.out_r, a.rejects, 0, gp, t, n);
  // every copy lands before any event
  cooperative_groups::this_grid().sync();
  for (size_t e = t; e < (size_t)E; e += n) land_vote(a, (int)e, 0, G, G, P);
}

// vote_grid's blocks: at most kGridPerSm a multiprocessor (more made the
// grid sync dearer than the extra blocks saved), and no more than the
// device holds at once, which the cooperative launch requires (cached per
// device: the query costs host time on every call otherwise)
constexpr int kGridPerSm = 2;
constexpr int kMaxDevices = 64;
int coop_blocks[kMaxDevices];

int launch_vote_grid(const VoteArgs& a, int G, int P, int E,
                     cudaStream_t s) {
  int device = -1;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  int cap = device >= 0 && device < kMaxDevices ? coop_blocks[device] : 0;
  if (cap == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, vote_grid,
                                                        kThreads, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) return (int)err;
    cap = std::min(per_sm, kGridPerSm) * sms;
    if (cap < 1) return (int)cudaErrorLaunchOutOfResources;
    if (device >= 0 && device < kMaxDevices) coop_blocks[device] = cap;
  }
  // a thread per 16 bytes of a mask or per event, at most what fits
  const long long work = std::max((long long)G * P / 16 + 1, (long long)E);
  const int grid = (int)std::min<long long>(cap, (work + kThreads - 1) /
                                                     kThreads);
  void* args[] = {(void*)&a, &G, &P, &E};
  err = cudaLaunchCooperativeKernel((const void*)vote_grid, grid, kThreads,
                                    args, 0, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// -- K7b ---------------------------------------------------------------------

// Rows of kRowLanes lanes, S slots a lane (lane l holds slots l and, for
// S = 2, l + 8; S * 8 >= P).
template <int S>
__global__ void __launch_bounds__(kThreads)
    replicated_min(const int32_t* __restrict__ match,
                   const uint8_t* __restrict__ self_mask,
                   const int32_t* __restrict__ flush,
                   const uint8_t* __restrict__ cur,
                   const uint8_t* __restrict__ old,
                   int32_t* __restrict__ out, int G, int P) {
  constexpr int L = kRowLanes;
  const int lane = threadIdx.x % L;
  const int shift = (threadIdx.x % 32) / L * L;
  const int g = (blockIdx.x * blockDim.x + threadIdx.x) / L;
  // every load issued before any is used; a slot past P or a row past G
  // is no member
  int32_t m[S];
  uint8_t self[S], c[S], o[S];
  int32_t fl = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int slot = lane + L * s;
    m[s] = 0;
    self[s] = c[s] = o[s] = 0;
    if (g < G && slot < P) {
      const size_t i = (size_t)g * P + slot;
      m[s] = match[i];
      self[s] = self_mask[i];
      c[s] = cur[i];
      o[s] = old[i];
    }
  }
  if (g < G) fl = flush[g];  // the same address on the row's lanes
  // a member counts its match index, or the flush index in a self slot
  int32_t v = kIntMax;
  bool member = false;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (c[s] | o[s]) {
      v = min(v, self[s] ? fl : m[s]);
      member = true;
    }
  }
  // the row's min over its 8 lanes, and whether it has any member
#pragma unroll
  for (int d = L / 2; d > 0; d /= 2)
    v = min(v, __shfl_xor_sync(kFullWarp, v, d, L));
  const bool any = lane_bits<L>(member, shift, 0) != 0;
  if (lane == 0 && g < G) out[g] = any ? v : kIntMin;
}

// -- K7c ---------------------------------------------------------------------

// Rows of kRowLanes lanes, S slots a lane (lane l holds slots l and, for
// S = 2, l + 8; S * 8 >= P).
template <int S>
__global__ void __launch_bounds__(kThreads)
    lease(const int32_t* __restrict__ ack,
          const uint8_t* __restrict__ self_mask,
          const uint8_t* __restrict__ cur, const uint8_t* __restrict__ old,
          int timeout, int32_t* __restrict__ out, int G, int P) {
  constexpr int L = kRowLanes;
  const int lane = threadIdx.x % L;
  const int shift = (threadIdx.x % 32) / L * L;
  const int g = (blockIdx.x * blockDim.x + threadIdx.x) / L;
  // every load issued before any is used; a slot past P or a row past G
  // is no member of either conf
  int32_t a[S];
  uint8_t self[S], c[S], o[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int slot = lane + L * s;
    a[s] = kIntMax;
    self[s] = 1;
    c[s] = o[s] = 0;
    if (g < G && slot < P) {
      const int i = g * P + slot;
      a[s] = ack[i];
      self[s] = self_mask[i];
      c[s] = cur[i];
      o[s] = old[i];
    }
  }
  int32_t v[S];
  unsigned cb = 0, ob = 0;  // the row's conf bits, bit = slot
#pragma unroll
  for (int s = 0; s < S; ++s) {
    v[s] = self[s] ? kIntMax : a[s];
    cb |= lane_bits<L>(c[s], shift, s);
    ob |= lane_bits<L>(o[s], shift, s);
  }
  // before[s]: the slots ordered before slot lane + L s (by value, ties
  // by slot), so its rank among either conf's members is a popcount
  unsigned before[S];
#pragma unroll
  for (int s = 0; s < S; ++s) before[s] = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
#pragma unroll
    for (int t = 0; t < S; ++t) {
      const int32_t u = __shfl_sync(kFullWarp, v[t], j, L);  // slot j + L t
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const bool earlier = t < s || (t == s && j < lane);
        if (earlier ? u <= v[s] : u < v[s]) before[s] |= 1u << (j + L * t);
      }
    }
  }
  // the member of rank (k-1)/2 in each conf
  const int pos_c = (__popc(cb) - 1) / 2, pos_o = (__popc(ob) - 1) / 2;
  bool pick_c = false, pick_o = false;
  int32_t cand_c = v[0], cand_o = v[0];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int slot = lane + L * s;
    if (((cb >> slot) & 1u) && __popc(before[s] & cb) == pos_c) {
      pick_c = true;
      cand_c = v[s];
    }
    if (((ob >> slot) & 1u) && __popc(before[s] & ob) == pos_o) {
      pick_o = true;
      cand_o = v[s];
    }
  }
  // joint consensus: the min over both confs while conf_old is non-empty
  int32_t q = lane_pick<L>(pick_c, cand_c, shift);
  const int32_t q_old = lane_pick<L>(pick_o, cand_o, shift);
  if (ob != 0) q = min(q, q_old);
  if (lane == 0 && g < G)
    out[g] = wrap_add(min(q, wrap_sub(kIntMax, timeout)), timeout);
}

}  // namespace

extern "C" {

const char* k_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K7a: grants/rejects bool [G, P]; ev_g/ev_p int32 [E], ev_granted/
// ev_valid bool [E]; out_g/out_r bool [G, P] (new tensors, neither an
// input).  ONE launch: ``rows`` > 0 runs design (a) with that many rows a
// block, 0 design (b).
int k7a_apply_vote_events(const uint8_t* grants, const uint8_t* rejects,
                          const int32_t* ev_g, const int32_t* ev_p,
                          const uint8_t* ev_granted, const uint8_t* ev_valid,
                          uint8_t* out_g, uint8_t* out_r, int G, int P,
                          int E, int rows, void* stream) {
  if (P < 1 || P > MAXP || G < 0 || E < 0 || rows < 0)
    return (int)cudaErrorInvalidValue;
  if (G == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  VoteArgs a{grants, rejects, ev_g, ev_p, ev_granted, ev_valid, out_g,
             out_r};
  if (rows == 0) return launch_vote_grid(a, G, P, E, s);
  vote_rows<<<(G + rows - 1) / rows, kThreads, 0, s>>>(a, G, P, E, rows);
  return (int)cudaGetLastError();
}

// K7b: match int32 [G, P], self/cur/old bool [G, P], flush int32 [G];
// out int32 [G]; rows of 8 lanes, ``slots`` (1 or 2, slots * 8 >= P)
// slots a lane, ``blocks`` blocks (at least the rows' G * 8 / kThreads)
int k7b_all_replicated_min(const int32_t* match, const uint8_t* self_mask,
                           const int32_t* flush, const uint8_t* cur,
                           const uint8_t* old, int32_t* out, int G, int P,
                           int slots, int blocks, void* stream) {
  const int need = lane_row_blocks(G, P, slots);
  if (need < 0 || blocks < need) return (int)cudaErrorInvalidValue;
  if (G == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (slots == 1)
    replicated_min<1><<<blocks, kThreads, 0, s>>>(match, self_mask, flush,
                                                  cur, old, out, G, P);
  else
    replicated_min<2><<<blocks, kThreads, 0, s>>>(match, self_mask, flush,
                                                  cur, old, out, G, P);
  return (int)cudaGetLastError();
}

// K7c: ack int32 [G, P], self/cur/old bool [G, P], the lease timeout by
// value; out int32 [G]; rows of 8 lanes, ``slots`` (1 or 2, slots * 8 >=
// P) slots a lane
int k7c_lease_expiry(const int32_t* ack, const uint8_t* self_mask,
                     const uint8_t* cur, const uint8_t* old, int timeout_ms,
                     int32_t* out, int G, int P, int slots, void* stream) {
  const int grid = lane_row_blocks(G, P, slots);
  if (grid < 0) return (int)cudaErrorInvalidValue;
  if (G == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (slots == 1)
    lease<1><<<grid, kThreads, 0, s>>>(ack, self_mask, cur, old, timeout_ms,
                                       out, G, P);
  else
    lease<2><<<grid, kThreads, 0, s>>>(ack, self_mask, cur, old, timeout_ms,
                                       out, G, P);
  return (int)cudaGetLastError();
}

}  // extern "C"

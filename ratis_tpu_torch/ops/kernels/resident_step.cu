// The engine tick: K1 (resident fast), K2 (resident dirty-row refresh), K5
// (the resident fast tick of a mesh engine, over S slices) and K6 (the
// stateless fused tick).
//
// Replaces ratis_tpu/ops/quorum.py:engine_step_resident_fast (K1),
// ratis_tpu/ops/quorum.py:engine_step_resident (K2),
// ratis_tpu/ops/quorum.py:engine_step_resident_fast_sliced (K5, run by
// ratis_tpu/parallel/mesh.py:sharded_resident_fast_step_sliced) and
// ratis_tpu/ops/quorum.py:engine_step (K6), which XLA compiled from jnp
// ops.  K1, K2 and K5 update the resident [G, P] state IN PLACE (JAX
// donated the buffers and returned new ones) and write the packed int32
// [4, G] output (new_commit, commit_changed, timeouts, stale).  K6 is
// functional like its JAX original: it writes only fresh outputs (match and
// ack copies [G, P], new_commit [G], bool flags [3, G]) and none of its
// inputs.
//
// K5 is K1 over S contiguous slices of G / S rows, each with its own event
// plane of E columns ([7, S, E]) whose row indices are local to the slice.
// JAX vmaps the flat fast tick over the slices, so every slice wraps and
// drops its indices by its OWN extent: a local row past the slice is
// dropped (not spilled into the next slice) and row -1 is the slice's last
// row.  So K5 cannot be K1 on offset indices; it is K1's event pass told
// the slice extent, then K1's row pass unchanged (the row math is
// row-local).  With S = 1 it is K1: both run the same code.
//
// Bound on the card: at the main path's shape (G = 1024, P = 8, E <= 16384)
// one K1/K2 tick moves ~0.2 MB, ~0.06 us at 3.35 TB/s, and does a few
// thousand integer operations.  K6 at the bench's shapes must move ~1.9 MB
// (G = 10240, P = 8, E = 4096; ~0.56 us) and ~18 MB (G = 102400, E = 8192;
// ~5.4 us), most of it the copy of the two [G, P] arrays.  Bytes bind none
// of them at 1024 and 10240 groups: the launch latency of the 2-4 steps
// (a few us each) and the host's work around them do.  The design
// therefore keeps each pass a single flat launch with no shared memory, no
// second sweep over the batch and no host synchronisation, so a tick costs
// its launches and nothing else; K6's copies are plain device-to-device
// copies on the same stream.  K5 moves what K1 moves plus its padding
// columns: E is the bucket of the FULLEST slice, so a tick ships S x E
// columns, most of them padding, and the event pass reads them all (at
// the mesh100k rung's 102400 x 8 x 8192 over 8 slices, ~2.6 MB of events
// beside ~11 MB of state, ~4 us).
//
// Design:
// - Scatter indices follow XLA's mode="drop": an index in [-n, -1] counts
//   from the end of its own dimension (n + idx), one outside [-n, n) is
//   skipped (the engine pads with index G).
// - Pass R (K2 only): one thread per dirty row scatters the host's rows
//   into the state.  Dirty rows are unique, so plain stores.
// - Pass A: one thread per event column.  A valid ack does atomicMax on
//   match_index[g, p] and last_ack_ms[g, p] (integer max is order-free, so
//   the result is deterministic); invalid acks write nothing.  Update
//   columns (K1, K5) atomicMax the flush index and store the deadline;
//   update slots are unique per tick (the engine keys them by slot).  For
//   K5 the pass covers all S x E columns and takes each column's slice
//   from its position; padding columns (valid 0, both update rows
//   PACK_SENTINEL) write nothing.
// - Pass B: one thread per group row, its <= MAXP peer values in
//   registers.  The majority-min of a row is the member of rank (k-1)/2
//   in ascending order, found by counting ranks (O(P^2) compares, no
//   sort, no local memory).  In place (K1, K2, K5) it writes the new
//   commit and the disarmed deadline back into the state and writes
//   out[4, G]; K6's instance writes new_commit [G] and the flags [3, G]
//   only.
// - int32 arithmetic that XLA wraps (now - quorum_ack) is done in uint32:
//   signed overflow is undefined in C++.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAXP 16

namespace {

constexpr int32_t kIntMin = INT32_MIN;
constexpr int32_t kIntMax = INT32_MAX;
constexpr int32_t kSentinel = INT32_MIN;  // ops.quorum.PACK_SENTINEL
constexpr int8_t kRoleFollower = 1;
constexpr int8_t kRoleLeader = 3;
constexpr int kThreads = 256;

__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
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

// ascending-sorted member values at position (k-1)/2; INT32_MIN when the
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

__device__ __forceinline__ int32_t combined_majority_min(
    const int32_t (&v)[MAXP], unsigned cur, unsigned old) {
  int32_t m = majority_min(v, cur);
  if (old != 0) m = min(m, majority_min(v, old));
  return m;
}

// Pass R: scatter the refreshed rows (K2)
__global__ void refresh_rows(
    const int32_t* __restrict__ rf_idx, int D, int G, int P,
    const int32_t* __restrict__ rf_match, const int32_t* __restrict__ rf_ack,
    const uint8_t* __restrict__ rf_self, const uint8_t* __restrict__ rf_cur,
    const uint8_t* __restrict__ rf_old, const int8_t* __restrict__ rf_role,
    const int32_t* __restrict__ rf_flush,
    const int32_t* __restrict__ rf_commit,
    const int32_t* __restrict__ rf_first,
    const int32_t* __restrict__ rf_deadline,
    int32_t* match, int32_t* ack, uint8_t* self_mask, uint8_t* cur,
    uint8_t* old, int8_t* role, int32_t* flush, int32_t* commit,
    int32_t* first, int32_t* deadline) {
  int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D) return;
  int g = wrap_index(rf_idx[d], G);
  if (g < 0 || g >= G) return;  // padding: dropped
  for (int p = 0; p < P; ++p) {
    size_t src = (size_t)d * P + p, dst = (size_t)g * P + p;
    match[dst] = rf_match[src];
    ack[dst] = rf_ack[src];
    self_mask[dst] = rf_self[src];
    cur[dst] = rf_cur[src];
    old[dst] = rf_old[src];
  }
  role[g] = rf_role[d];
  flush[g] = rf_flush[d];
  commit[g] = rf_commit[d];
  first[g] = rf_first[d];
  deadline[g] = rf_deadline[d];
}

// Pass A: scatter ack events and (K1, K5) slot updates.  ``valid`` is read
// through its own type: int32 row 4 of the fast pack, bool for K2 and K6.
// Column e belongs to slice e / Es, whose rows are [s * Gs, (s + 1) * Gs);
// its row index is local to the slice and wraps and drops by Gs.  K1, K2
// and K6 are one slice: Es = E, Gs = G.
template <typename V>
__global__ void apply_events(
    const int32_t* __restrict__ ev_g, const int32_t* __restrict__ ev_p,
    const int32_t* __restrict__ ev_m, const int32_t* __restrict__ ev_t,
    const V* __restrict__ ev_valid, const int32_t* __restrict__ up_flush,
    const int32_t* __restrict__ up_deadline, int E, int Es, int Gs, int P,
    int32_t* match, int32_t* ack, int32_t* flush, int32_t* deadline) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  int g = wrap_index(ev_g[e], Gs);
  bool in_row = g >= 0 && g < Gs;
  g += (e / Es) * Gs;
  if (ev_valid[e] != 0) {
    int p = wrap_index(ev_p[e], P);
    if (in_row && p >= 0 && p < P) {
      size_t i = (size_t)g * P + p;
      atomicMax(&match[i], ev_m[e]);
      atomicMax(&ack[i], ev_t[e]);
    }
  }
  if (up_flush != nullptr && in_row) {
    int32_t f = up_flush[e];
    if (f != kSentinel) atomicMax(&flush[g], f);
    int32_t dl = up_deadline[e];
    if (dl != kSentinel) deadline[g] = dl;
  }
}

// Pass B: the row math.  now/timeout come from ``meta`` when given (K1's
// device-side meta), else from the arguments (K2, K6).  kInPlace (K1, K2):
// commit and deadline are updated and out is int32 [4, G]; otherwise (K6)
// out is new_commit [G], flags bool [3, G], and no input is written.
template <bool kInPlace>
__global__ void row_pass(
    const int32_t* __restrict__ match, const int32_t* __restrict__ ack,
    const uint8_t* __restrict__ self_mask, const uint8_t* __restrict__ cur,
    const uint8_t* __restrict__ old, const int8_t* __restrict__ role,
    const int32_t* __restrict__ flush, int32_t* commit,
    const int32_t* __restrict__ first, int32_t* deadline,
    const int32_t* __restrict__ meta, int now_arg, int timeout_arg,
    int32_t* __restrict__ out, uint8_t* __restrict__ flags, int G, int P) {
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  int32_t now = meta != nullptr ? meta[0] : now_arg;
  int32_t timeout = meta != nullptr ? meta[1] : timeout_arg;
  const size_t base = (size_t)g * P;
  unsigned cb = row_bits(cur + base, P);
  unsigned ob = row_bits(old + base, P);
  unsigned sb = row_bits(self_mask + base, P);
  int8_t r = role[g];
  bool is_leader = r == kRoleLeader;
  int32_t fl = flush[g];
  int32_t eff[MAXP], eff_ack[MAXP];
#pragma unroll
  for (int i = 0; i < MAXP; ++i) {
    bool self = (sb >> i) & 1u;
    eff[i] = i < P ? (self ? fl : match[base + i]) : kIntMax;
    eff_ack[i] = i < P ? (self ? now : ack[base + i]) : kIntMax;
  }
  // update_commit
  int32_t c = commit[g];
  int32_t cand = combined_majority_min(eff, cb, ob);
  bool ok = is_leader && cand > c && cand >= first[g];
  int32_t new_commit = ok ? cand : c;
  // election_timeout
  int32_t dl = deadline[g];
  bool timed_out = r == kRoleFollower && now >= dl;
  // check_leadership (int32 subtraction wraps, as in XLA)
  int32_t quorum_ack = combined_majority_min(eff_ack, cb, ob);
  bool stale = is_leader && wrap_sub(now, quorum_ack) > timeout;

  out[g] = new_commit;
  if constexpr (kInPlace) {
    commit[g] = new_commit;
    if (timed_out) deadline[g] = kIntMax;
    out[G + g] = ok;
    out[2 * G + g] = timed_out;
    out[3 * G + g] = stale;
  } else {
    flags[g] = ok;
    flags[G + g] = timed_out;
    flags[2 * G + g] = stale;
  }
}

inline int blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

const char* k_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K1 (S = 1) and K5: ev is int32 [7, S, E] (rows: slot local to the
// slice, peer, match, time, valid, flush, deadline), meta int32 [2]
// (now_ms, leadership_timeout_ms); G is a multiple of S
static int resident_fast(int32_t* match, int32_t* ack,
                         const uint8_t* self_mask, const uint8_t* cur,
                         const uint8_t* old, const int8_t* role,
                         int32_t* flush, int32_t* commit,
                         const int32_t* first, int32_t* deadline,
                         const int32_t* ev, const int32_t* meta, int32_t* out,
                         int G, int P, int S, int E, cudaStream_t s) {
  const int cols = S * E;
  if (cols > 0) {
    const size_t n = (size_t)cols;
    apply_events<int32_t><<<blocks(cols), kThreads, 0, s>>>(
        ev, ev + n, ev + 2 * n, ev + 3 * n, ev + 4 * n, ev + 5 * n,
        ev + 6 * n, cols, E, G / S, P, match, ack, flush, deadline);
  }
  if (G > 0)
    row_pass<true><<<blocks(G), kThreads, 0, s>>>(
        match, ack, self_mask, cur, old, role, flush, commit, first,
        deadline, meta, 0, 0, out, nullptr, G, P);
  return (int)cudaGetLastError();
}

int k1_resident_fast(int32_t* match, int32_t* ack, const uint8_t* self_mask,
                     const uint8_t* cur, const uint8_t* old,
                     const int8_t* role, int32_t* flush, int32_t* commit,
                     const int32_t* first, int32_t* deadline,
                     const int32_t* ev, const int32_t* meta, int32_t* out,
                     int G, int P, int E, void* stream) {
  return resident_fast(match, ack, self_mask, cur, old, role, flush, commit,
                       first, deadline, ev, meta, out, G, P, 1, E,
                       (cudaStream_t)stream);
}

int k5_resident_fast_sliced(int32_t* match, int32_t* ack,
                            const uint8_t* self_mask, const uint8_t* cur,
                            const uint8_t* old, const int8_t* role,
                            int32_t* flush, int32_t* commit,
                            const int32_t* first, int32_t* deadline,
                            const int32_t* ev, const int32_t* meta,
                            int32_t* out, int G, int P, int S, int E,
                            void* stream) {
  if (S < 1 || G % S != 0) return (int)cudaErrorInvalidValue;
  return resident_fast(match, ack, self_mask, cur, old, role, flush, commit,
                       first, deadline, ev, meta, out, G, P, S, E,
                       (cudaStream_t)stream);
}

// K2: refresh D rows, scatter E unpacked acks, then the row pass
int k2_resident(int32_t* match, int32_t* ack, uint8_t* self_mask,
                uint8_t* cur, uint8_t* old, int8_t* role, int32_t* flush,
                int32_t* commit, int32_t* first, int32_t* deadline,
                const int32_t* rf_idx, const int32_t* rf_match,
                const int32_t* rf_ack, const uint8_t* rf_self,
                const uint8_t* rf_cur, const uint8_t* rf_old,
                const int8_t* rf_role, const int32_t* rf_flush,
                const int32_t* rf_commit, const int32_t* rf_first,
                const int32_t* rf_deadline, const int32_t* ev_g,
                const int32_t* ev_p, const int32_t* ev_m,
                const int32_t* ev_t, const uint8_t* ev_valid, int now_ms,
                int timeout_ms, int32_t* out, int G, int P, int D, int E,
                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D > 0)
    refresh_rows<<<blocks(D), kThreads, 0, s>>>(
        rf_idx, D, G, P, rf_match, rf_ack, rf_self, rf_cur, rf_old, rf_role,
        rf_flush, rf_commit, rf_first, rf_deadline, match, ack, self_mask,
        cur, old, role, flush, commit, first, deadline);
  if (E > 0)
    apply_events<uint8_t><<<blocks(E), kThreads, 0, s>>>(
        ev_g, ev_p, ev_m, ev_t, ev_valid, nullptr, nullptr, E, E, G, P,
        match, ack, flush, deadline);
  if (G > 0)
    row_pass<true><<<blocks(G), kThreads, 0, s>>>(
        match, ack, self_mask, cur, old, role, flush, commit, first,
        deadline, nullptr, now_ms, timeout_ms, out, nullptr, G, P);
  return (int)cudaGetLastError();
}

// K6: the stateless tick, arguments in engine_step's order.  Copies match
// and ack into match_out / ack_out, scatters the E unpacked acks there,
// then the row pass writes new_commit [G] and flags bool [3, G]
// (commit_changed, timeouts, stale).  No input is written.
int k6_engine_step(const int32_t* match, const int32_t* ack,
                   const int32_t* ev_g, const int32_t* ev_p,
                   const int32_t* ev_m, const int32_t* ev_t,
                   const uint8_t* ev_valid, const uint8_t* self_mask,
                   const int32_t* flush, const uint8_t* cur,
                   const uint8_t* old, const int32_t* commit,
                   const int32_t* first, const int8_t* role,
                   const int32_t* deadline, int now_ms, int timeout_ms,
                   int32_t* match_out, int32_t* ack_out,
                   int32_t* new_commit, uint8_t* flags, int G, int P, int E,
                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t gp = (size_t)G * P * sizeof(int32_t);
  if (gp > 0) {
    cudaError_t err = cudaMemcpyAsync(match_out, match, gp,
                                      cudaMemcpyDeviceToDevice, s);
    if (err == cudaSuccess)
      err = cudaMemcpyAsync(ack_out, ack, gp, cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (E > 0)
    apply_events<uint8_t><<<blocks(E), kThreads, 0, s>>>(
        ev_g, ev_p, ev_m, ev_t, ev_valid, nullptr, nullptr, E, E, G, P,
        match_out, ack_out, nullptr, nullptr);
  if (G > 0)
    row_pass<false><<<blocks(G), kThreads, 0, s>>>(
        match_out, ack_out, self_mask, cur, old, role, flush,
        const_cast<int32_t*>(commit), first, const_cast<int32_t*>(deadline),
        nullptr, now_ms, timeout_ms, new_commit, flags, G, P);
  return (int)cudaGetLastError();
}

}  // extern "C"

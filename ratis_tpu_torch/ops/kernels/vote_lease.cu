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
// batch set both masks, as in JAX).  So the grant and reject masks are
// copied into the outputs first, and one thread per event reads the
// inputs and stores 1 into an output byte; it never reads what it writes.
// Stores of the same value are idempotent, so no atomics.  Indices follow
// XLA: a group or peer in [-n, -1] counts from the end of its own
// dimension, one outside [-n, n) is dropped, and an invalid event writes
// nothing.
//
// K7b: one thread per row: the min over the members of conf_cur |
// conf_old, the leader's own slot counted at its flush index; INT32_MIN
// for an empty union.
//
// K7c: one thread per row: the joint majority-min of the ack times with
// the leader's slot set to INT32_MAX (row_math.cuh, K1's row math), then
// min(q, INT32_MAX - t) + t.  Both int32 operations wrap as XLA's do (a
// negative t wraps the cap and the sum), so they are done in uint32.
//
// Bound on the card: each is a pass over [G, P] bytes and int32s with a
// few operations per element.  At G = 1024, P = 8 K7b reads ~65 KB and
// K7c ~57 KB (~0.02 us at 3.35 TB/s); K7a reads and writes the two bool
// masks (~33 KB) plus 10 bytes per event.  No launch gets near its bound:
// launch latency and the wrapper's host time bind them, so each is one
// flat launch (K7a: two device copies and one launch) with no shared
// memory and no host synchronisation.

#include "row_math.cuh"

namespace {

// K7a: one thread per event; grants/rejects are the inputs, out_g/out_r
// copies of them
__global__ void vote_events(const uint8_t* __restrict__ grants,
                            const uint8_t* __restrict__ rejects,
                            const int32_t* __restrict__ ev_g,
                            const int32_t* __restrict__ ev_p,
                            const uint8_t* __restrict__ ev_granted,
                            const uint8_t* __restrict__ ev_valid, int E,
                            int G, int P, uint8_t* __restrict__ out_g,
                            uint8_t* __restrict__ out_r) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E || !ev_valid[e]) return;
  int g = wrap_index(ev_g[e], G), p = wrap_index(ev_p[e], P);
  if (g < 0 || g >= G || p < 0 || p >= P) return;  // dropped
  size_t i = (size_t)g * P + p;
  if (grants[i] | rejects[i]) return;  // this peer already replied
  if (ev_granted[e])
    out_g[i] = 1;
  else
    out_r[i] = 1;
}

// K7b
__global__ void replicated_min(const int32_t* __restrict__ match,
                               const uint8_t* __restrict__ self_mask,
                               const int32_t* __restrict__ flush,
                               const uint8_t* __restrict__ cur,
                               const uint8_t* __restrict__ old,
                               int32_t* __restrict__ out, int G, int P) {
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const size_t base = (size_t)g * P;
  unsigned u = row_bits(cur + base, P) | row_bits(old + base, P);
  unsigned sb = row_bits(self_mask + base, P);
  int32_t fl = flush[g];
  int32_t m = kIntMax;
#pragma unroll
  for (int i = 0; i < MAXP; ++i)
    if ((u >> i) & 1u) m = min(m, (sb >> i) & 1u ? fl : match[base + i]);
  out[g] = u != 0 ? m : kIntMin;
}

// K7c
__global__ void lease(const int32_t* __restrict__ ack,
                      const uint8_t* __restrict__ self_mask,
                      const uint8_t* __restrict__ cur,
                      const uint8_t* __restrict__ old, int timeout,
                      int32_t* __restrict__ out, int G, int P) {
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const size_t base = (size_t)g * P;
  unsigned cb = row_bits(cur + base, P);
  unsigned ob = row_bits(old + base, P);
  unsigned sb = row_bits(self_mask + base, P);
  int32_t eff[MAXP];
#pragma unroll
  for (int i = 0; i < MAXP; ++i)
    eff[i] = i < P && !((sb >> i) & 1u) ? ack[base + i] : kIntMax;
  int32_t q = combined_majority_min(eff, cb, ob);
  out[g] = wrap_add(min(q, wrap_sub(kIntMax, timeout)), timeout);
}

}  // namespace

extern "C" {

const char* k_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K7a: grants/rejects bool [G, P]; ev_g/ev_p int32 [E], ev_granted/
// ev_valid bool [E]; out_g/out_r bool [G, P] (new tensors)
int k7a_apply_vote_events(const uint8_t* grants, const uint8_t* rejects,
                          const int32_t* ev_g, const int32_t* ev_p,
                          const uint8_t* ev_granted, const uint8_t* ev_valid,
                          uint8_t* out_g, uint8_t* out_r, int G, int P,
                          int E, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t gp = (size_t)G * P;
  if (gp > 0) {
    cudaError_t err = cudaMemcpyAsync(out_g, grants, gp,
                                      cudaMemcpyDeviceToDevice, s);
    if (err == cudaSuccess)
      err = cudaMemcpyAsync(out_r, rejects, gp, cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (E > 0 && gp > 0)
    vote_events<<<blocks(E), kThreads, 0, s>>>(grants, rejects, ev_g, ev_p,
                                               ev_granted, ev_valid, E, G, P,
                                               out_g, out_r);
  return (int)cudaGetLastError();
}

// K7b: match int32 [G, P], self/cur/old bool [G, P], flush int32 [G];
// out int32 [G]
int k7b_all_replicated_min(const int32_t* match, const uint8_t* self_mask,
                           const int32_t* flush, const uint8_t* cur,
                           const uint8_t* old, int32_t* out, int G, int P,
                           void* stream) {
  if (G > 0)
    replicated_min<<<blocks(G), kThreads, 0, (cudaStream_t)stream>>>(
        match, self_mask, flush, cur, old, out, G, P);
  return (int)cudaGetLastError();
}

// K7c: ack int32 [G, P], self/cur/old bool [G, P], the lease timeout by
// value; out int32 [G]
int k7c_lease_expiry(const int32_t* ack, const uint8_t* self_mask,
                     const uint8_t* cur, const uint8_t* old, int timeout_ms,
                     int32_t* out, int G, int P, void* stream) {
  if (G > 0)
    lease<<<blocks(G), kThreads, 0, (cudaStream_t)stream>>>(
        ack, self_mask, cur, old, timeout_ms, out, G, P);
  return (int)cudaGetLastError();
}

}  // extern "C"

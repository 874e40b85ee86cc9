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
// of them at 1024 and 10240 groups: the launch latency of each step (a
// few us) and the host's work around it do.  K5 moves what K1 moves plus
// its padding columns: E is the bucket of the FULLEST slice, so a tick
// ships S x E columns, most of them padding, and the event pass reads them
// all (at the mesh100k rung's 102400 x 8 x 8192 over 8 slices, ~2.6 MB of
// events beside ~11 MB of state, ~4 us).
//
// K1, K5 and K6 are two flat launches (an event pass, then a row pass;
// K6 after two device-to-device copies on the same stream).
//
// K2, the refresh tick (the engine's most common tick), is ONE launch of
// ``refresh_tick``: each block owns a tile of T consecutive group rows
// (T = 32, or 128 above 16384 rows, where the ack scans below would
// dominate: ``ops.quorum.refresh_tile``) and does the whole tick for them
// in shared memory:
// 1. it starts asynchronous 16-byte copies (cp.async) of its tile of the
//    ten state arrays into shared memory (~3 KB at T = 32, P = 8) and,
//    while they are in flight, scans the D refresh indices (16-byte
//    loads, from L2: every block reads all of them) and notes, per tile
//    row, which refresh entry lands on it;
// 2. it waits for the copies and overlays the refreshed rows;
// 3. it scans the E ack columns the same way and applies the ones that
//    land in the tile with shared-memory atomicMax on match and ack
//    (integer max is order-free, so the result is deterministic); a
//    column's other fields are read only when its row is in the tile;
// 4. it runs the row math on the shared tile with one lane per peer slot
//    (8 or 16 lanes a row): a member's rank in its row is counted over
//    the row's lanes with warp shuffles, O(P) dependent steps a lane
//    where one thread per row takes O(P^2), which at a few rows per
//    block is most of a tick; lane 0 of each row stores the new commit
//    and the (disarmed) deadline and writes out[4, G];
// 5. it writes back, with 16-byte stores, only what changed: every array
//    of a tile that a refresh row landed in, match and ack of a tile an
//    ack landed in, nothing else.
// So the refresh lands before the acks, as in JAX, and no tick needs a
// second launch.  The scans cost every block D + E index loads from L2
// (at most 64 KB each at the engine's caps).
//
// The engine reaches K2 through a prepared call (``k2_plan_new`` once per
// resident state, ``k2_tick`` per tick): the host packs the refresh rows
// and acks into one pinned buffer (the layout is the host's: each tick
// passes its sections' byte offsets), and one C call copies it to the
// card, launches ``refresh_tick``, copies out[4, G] back and synchronises
// the stream.  The public wrapper launches the same kernel on separate
// tensors (``k2_resident``).
//
// Design of the rest:
// - Scatter indices follow XLA's mode="drop": an index in [-n, -1] counts
//   from the end of its own dimension (n + idx), one outside [-n, n) is
//   skipped (the engine pads with index G).  Refresh rows are unique
//   once wrapped (the engine packs each dirty row once); if two were not,
//   either may land, as either may in XLA.
// - Event pass (K1, K5, K6): one thread per event column.  A valid ack
//   does atomicMax on match_index[g, p] and last_ack_ms[g, p]; invalid
//   acks write nothing.  Update columns (K1, K5) atomicMax the flush index
//   and store the deadline; update slots are unique per tick (the engine
//   keys them by slot).  For K5 the pass covers all S x E columns and
//   takes each column's slice from its position; padding columns (valid
//   0, both update rows PACK_SENTINEL) write nothing.
// - Row pass (K1, K5, K6): one thread per group row, its <= MAXP peer
//   values in registers.  The majority-min of a row is the member of rank
//   (k-1)/2 in ascending order, found by counting ranks (O(P^2) compares,
//   no sort, no local memory; ``row_math.cuh``, shared with K7c).  In
//   place (K1, K5) it writes the new commit and the disarmed deadline
//   back into the state and writes out[4, G]; K6's instance writes
//   new_commit [G] and the flags [3, G] only.  K2's row math takes the
//   same ranks with ties broken by peer index, so both pick one member.
// - int32 arithmetic that XLA wraps (now - quorum_ack) is done in uint32:
//   signed overflow is undefined in C++.

#include "row_math.cuh"

namespace {

constexpr int32_t kSentinel = INT32_MIN;  // ops.quorum.PACK_SENTINEL
constexpr int8_t kRoleFollower = 1;
constexpr int8_t kRoleLeader = 3;

// Pass A: scatter ack events and (K1, K5) slot updates.  ``valid`` is read
// through its own type: int32 row 4 of the fast pack, bool for K6.
// Column e belongs to slice e / Es, whose rows are [s * Gs, (s + 1) * Gs);
// its row index is local to the slice and wraps and drops by Gs.  K1 and
// K6 are one slice: Es = E, Gs = G.
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
// device-side meta), else from the arguments (K6).  kInPlace (K1, K5):
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

// -- K2: the refresh tick in one launch -------------------------------------

constexpr int kTileThreads = 256;

struct StateArgs {
  int32_t* match;
  int32_t* ack;
  uint8_t* self_mask;
  uint8_t* cur;
  uint8_t* old;
  int8_t* role;
  int32_t* flush;
  int32_t* commit;
  int32_t* first;
  int32_t* deadline;
};

struct RefreshArgs {  // D refreshed rows
  const int32_t* idx;
  const int32_t* match;
  const int32_t* ack;
  const uint8_t* self_mask;
  const uint8_t* cur;
  const uint8_t* old;
  const int8_t* role;
  const int32_t* flush;
  const int32_t* commit;
  const int32_t* first;
  const int32_t* deadline;
};

struct AckArgs {  // E unpacked ack columns
  const int32_t* g;
  const int32_t* p;
  const int32_t* m;
  const int32_t* t;
  const uint8_t* valid;
};

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

// Write nbytes of shared memory back to global memory: 16-byte stores for
// the aligned bulk, bytes for the rest.
__device__ __forceinline__ void unstage(void* gmem, const void* smem,
                                        int nbytes) {
  int head = 0;
  if (aligned16(gmem)) {
    head = nbytes & ~15;
    for (int i = threadIdx.x * 16; i < head; i += blockDim.x * 16)
      *(int4*)((char*)gmem + i) = *(const int4*)((const char*)smem + i);
  }
  for (int i = head + threadIdx.x; i < nbytes; i += blockDim.x)
    ((char*)gmem)[i] = ((const char*)smem)[i];
}

// f(i, a[i]) for every i in [0, n), split over the block's threads, with
// 16-byte loads when the array is aligned
template <typename F>
__device__ __forceinline__ void for_each_index(const int32_t* a, int n,
                                               F&& f) {
  int head = 0;
  if (aligned16(a)) {
    head = n & ~3;
    const int4* v = reinterpret_cast<const int4*>(a);
    for (int i = threadIdx.x; i < head / 4; i += blockDim.x) {
      int4 x = __ldg(v + i);
      f(4 * i, x.x);
      f(4 * i + 1, x.y);
      f(4 * i + 2, x.z);
      f(4 * i + 3, x.w);
    }
  }
  for (int i = head + threadIdx.x; i < n; i += blockDim.x) f(i, __ldg(a + i));
}

constexpr unsigned kFullWarp = 0xffffffffu;

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
  const bool pick = ((mask >> lane) & 1u) && rank == (k - 1) / 2;
  const unsigned who =
      (__ballot_sync(kFullWarp, pick) >> shift) & ((1u << L) - 1u);
  const int32_t m = __shfl_sync(kFullWarp, v, who ? __ffs(who) - 1 : 0, L);
  return who ? m : kIntMin;
}

// Step 4 of refresh_tick: the row math of the tile in shared memory, one
// lane per peer slot.  L (8 or 16, >= P) consecutive lanes hold a row; a
// member's rank in its row is counted over L shuffles, so a row costs
// O(P) steps per lane instead of O(P^2) in one thread.  Lane 0 of each
// row stores the new commit and deadline and writes out[4, G].
template <int L>
__device__ __forceinline__ void tile_row_math(
    const StateArgs& st, const int32_t* s_match, const int32_t* s_ack,
    const uint8_t* s_self, const uint8_t* s_cur, const uint8_t* s_old,
    const int8_t* s_role, const int32_t* s_flush, const int32_t* s_commit,
    const int32_t* s_first, const int32_t* s_deadline, int r0, int n,
    int now, int timeout, int32_t* __restrict__ out, int G, int P) {
  const int lane = threadIdx.x % L;
  const int shift = (threadIdx.x % 32) / L * L;
  const int rows_per_pass = blockDim.x / L;
  for (int base = 0; base < n; base += rows_per_pass) {
    const int r = base + threadIdx.x / L;
    const bool row = r < n;
    const bool in = row && lane < P;
    const int i = r * P + lane;
    const int32_t fl = row ? s_flush[r] : 0;
    const bool self = in && s_self[i];
    const int32_t eff = self ? fl : (in ? s_match[i] : kIntMax);
    const int32_t eff_ack = self ? now : (in ? s_ack[i] : kIntMax);
    const unsigned cb =
        (__ballot_sync(kFullWarp, in && s_cur[i]) >> shift) & ((1u << L) - 1u);
    const unsigned ob =
        (__ballot_sync(kFullWarp, in && s_old[i]) >> shift) & ((1u << L) - 1u);
    int rc = 0, ro = 0, rac = 0, rao = 0;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int32_t v = __shfl_sync(kFullWarp, eff, j, L);
      const int32_t a = __shfl_sync(kFullWarp, eff_ack, j, L);
      const bool before = v < eff || (v == eff && j < lane);
      const bool a_before = a < eff_ack || (a == eff_ack && j < lane);
      const bool c = (cb >> j) & 1u, o = (ob >> j) & 1u;
      rc += c && before;
      ro += o && before;
      rac += c && a_before;
      rao += o && a_before;
    }
    // joint consensus: the min over both confs while conf_old is non-empty
    int32_t cand = lane_majority_min<L>(eff, rc, cb, lane, shift);
    const int32_t cand_old = lane_majority_min<L>(eff, ro, ob, lane, shift);
    int32_t q = lane_majority_min<L>(eff_ack, rac, cb, lane, shift);
    const int32_t q_old = lane_majority_min<L>(eff_ack, rao, ob, lane, shift);
    if (ob != 0) {
      cand = min(cand, cand_old);
      q = min(q, q_old);
    }
    if (!row || lane != 0) continue;
    const int8_t role = s_role[r];
    const bool is_leader = role == kRoleLeader;
    const int32_t c = s_commit[r], dl = s_deadline[r];
    const bool ok = is_leader && cand > c && cand >= s_first[r];
    const int32_t new_commit = ok ? cand : c;
    const bool timed_out = role == kRoleFollower && now >= dl;
    // int32 subtraction wraps, as in XLA
    const bool stale = is_leader && wrap_sub(now, q) > timeout;
    const int g = r0 + r;
    st.commit[g] = new_commit;
    st.deadline[g] = timed_out ? kIntMax : dl;
    out[g] = new_commit;
    out[G + g] = ok;
    out[2 * G + g] = timed_out;
    out[3 * G + g] = stale;
  }
}

template <int T, int L>
__global__ void __launch_bounds__(kTileThreads)
    refresh_tick(StateArgs st, RefreshArgs rf, AckArgs ev, int now,
                 int timeout, int32_t* __restrict__ out, int G, int P, int D,
                 int E) {
  __shared__ __align__(16) int32_t s_match[T * MAXP];
  __shared__ __align__(16) int32_t s_ack[T * MAXP];
  __shared__ __align__(16) uint8_t s_self[T * MAXP];
  __shared__ __align__(16) uint8_t s_cur[T * MAXP];
  __shared__ __align__(16) uint8_t s_old[T * MAXP];
  __shared__ __align__(16) int32_t s_flush[T];
  __shared__ __align__(16) int32_t s_commit[T];
  __shared__ __align__(16) int32_t s_first[T];
  __shared__ __align__(16) int32_t s_deadline[T];
  __shared__ __align__(16) int8_t s_role[T];
  __shared__ int s_src[T];  // the refresh entry that lands on a row, or -1
  __shared__ int s_refreshed, s_acked;

  const int r0 = blockIdx.x * T;
  const int n = min(T, G - r0);
  const size_t base = (size_t)r0 * P;
  const int np = n * P;

  // 1. the tile, copied while the refresh indices are scanned
  stage(s_match, st.match + base, np * 4);
  stage(s_ack, st.ack + base, np * 4);
  stage(s_self, st.self_mask + base, np);
  stage(s_cur, st.cur + base, np);
  stage(s_old, st.old + base, np);
  stage(s_flush, st.flush + r0, n * 4);
  stage(s_commit, st.commit + r0, n * 4);
  stage(s_first, st.first + r0, n * 4);
  stage(s_deadline, st.deadline + r0, n * 4);
  stage(s_role, st.role + r0, n);
  for (int i = threadIdx.x; i < T; i += blockDim.x) s_src[i] = -1;
  if (threadIdx.x == 0) s_refreshed = s_acked = 0;
  __syncthreads();
  for_each_index(rf.idx, D, [&](int d, int32_t raw) {
    int r = wrap_index(raw, G) - r0;
    if (r >= 0 && r < n) {
      s_src[r] = d;
      s_refreshed = 1;
    }
  });
  cp_async_wait_all();
  __syncthreads();

  // 2. the refreshed rows over the staged tile
  if (s_refreshed) {
    for (int i = threadIdx.x; i < np; i += blockDim.x) {
      int d = s_src[i / P];
      if (d < 0) continue;
      size_t src = (size_t)d * P + i % P;
      s_match[i] = rf.match[src];
      s_ack[i] = rf.ack[src];
      s_self[i] = rf.self_mask[src];
      s_cur[i] = rf.cur[src];
      s_old[i] = rf.old[src];
    }
    for (int r = threadIdx.x; r < n; r += blockDim.x) {
      int d = s_src[r];
      if (d < 0) continue;
      s_role[r] = rf.role[d];
      s_flush[r] = rf.flush[d];
      s_commit[r] = rf.commit[d];
      s_first[r] = rf.first[d];
      s_deadline[r] = rf.deadline[d];
    }
  }
  __syncthreads();

  // 3. the acks that land in the tile, on top of the refresh
  for_each_index(ev.g, E, [&](int e, int32_t raw) {
    int r = wrap_index(raw, G) - r0;
    if (r < 0 || r >= n || ev.valid[e] == 0) return;
    int p = wrap_index(ev.p[e], P);
    if (p < 0 || p >= P) return;
    atomicMax(&s_match[r * P + p], ev.m[e]);
    atomicMax(&s_ack[r * P + p], ev.t[e]);
    s_acked = 1;
  });
  __syncthreads();

  // 4. the row math; commit and deadline go straight to the state
  tile_row_math<L>(st, s_match, s_ack, s_self, s_cur, s_old, s_role, s_flush,
                   s_commit, s_first, s_deadline, r0, n, now, timeout, out, G,
                   P);

  // 5. write back what the refresh or the acks changed
  if (s_refreshed) {
    unstage(st.self_mask + base, s_self, np);
    unstage(st.cur + base, s_cur, np);
    unstage(st.old + base, s_old, np);
    unstage(st.role + r0, s_role, n);
    unstage(st.flush + r0, s_flush, n * 4);
    unstage(st.first + r0, s_first, n * 4);
  }
  if (s_refreshed || s_acked) {
    unstage(st.match + base, s_match, np * 4);
    unstage(st.ack + base, s_ack, np * 4);
  }
}

template <int T>
void launch_tile(const StateArgs& st, const RefreshArgs& rf,
                 const AckArgs& ev, int now, int timeout, int32_t* out,
                 int G, int P, int D, int E, cudaStream_t s) {
  const int grid = (G + T - 1) / T;
  if (P <= 8)
    refresh_tick<T, 8><<<grid, kTileThreads, 0, s>>>(st, rf, ev, now,
                                                     timeout, out, G, P, D, E);
  else
    refresh_tick<T, 16><<<grid, kTileThreads, 0, s>>>(
        st, rf, ev, now, timeout, out, G, P, D, E);
}

int launch_refresh(const StateArgs& st, const RefreshArgs& rf,
                   const AckArgs& ev, int now, int timeout, int32_t* out,
                   int G, int P, int D, int E, int tile, cudaStream_t s) {
  if (P < 1 || P > MAXP) return (int)cudaErrorInvalidValue;
  if (G > 0) {
    switch (tile) {
      case 32:
        launch_tile<32>(st, rf, ev, now, timeout, out, G, P, D, E, s);
        break;
      case 128:
        launch_tile<128>(st, rf, ev, now, timeout, out, G, P, D, E, s);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

struct RefreshPlan {
  StateArgs st;
  const uint8_t* host_in;  // pinned
  uint8_t* dev_in;
  const int32_t* dev_out;  // int32 [4, G]
  int32_t* host_out;       // pinned int32 [4, G]
  int G, P, tile, device;
};

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

// K2 on separate tensors: refresh D rows, scatter E unpacked acks, the
// row math, in one launch of ``refresh_tick`` with tiles of ``tile`` rows
// (32 or 128)
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
                int tile, void* stream) {
  StateArgs st{match, ack, self_mask, cur, old, role, flush, commit, first,
               deadline};
  RefreshArgs rf{rf_idx, rf_match, rf_ack, rf_self, rf_cur, rf_old,
                 rf_role, rf_flush, rf_commit, rf_first, rf_deadline};
  AckArgs ev{ev_g, ev_p, ev_m, ev_t, ev_valid};
  return launch_refresh(st, rf, ev, now_ms, timeout_ms, out, G, P, D, E,
                        tile, (cudaStream_t)stream);
}

// A prepared K2 call on one resident state: its ten arrays, a pinned
// input buffer and its device copy (room for the largest packed tick),
// and out[4, G] on the card and pinned on the host.  Freed by
// k2_plan_free.
void* k2_plan_new(int32_t* match, int32_t* ack, uint8_t* self_mask,
                  uint8_t* cur, uint8_t* old, int8_t* role, int32_t* flush,
                  int32_t* commit, int32_t* first, int32_t* deadline,
                  const uint8_t* host_in, uint8_t* dev_in,
                  const int32_t* dev_out, int32_t* host_out, int G, int P,
                  int tile, int device) {
  return new RefreshPlan{{match, ack, self_mask, cur, old, role, flush,
                          commit, first, deadline},
                         host_in, dev_in, dev_out, host_out, G, P, tile,
                         device};
}

void k2_plan_free(void* plan) { delete (RefreshPlan*)plan; }

// One refresh tick through a plan: the packed input (D refresh rows, E
// ack columns) to the card, the launch, out[4, G] back to the pinned
// host buffer, and the stream synchronised, in one call.  The host owns
// the packed layout: ``offsets`` holds the byte offsets in it of idx [D],
// match, ack [D, P], self, cur, old [D, P], role [D], flush, commit,
// first, deadline [D], the ack columns [4, E] (group, peer, match, time)
// and valid [E], in that order, then the bytes to copy; every int32
// section 4-byte aligned.
int k2_tick(void* plan, int D, int E, int now_ms, int timeout_ms,
            const long long* offsets, void* stream) {
  const RefreshPlan& k = *(const RefreshPlan*)plan;
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != k.device) err = cudaSetDevice(k.device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const long long* o = offsets;
  err = cudaMemcpyAsync(k.dev_in, k.host_in, (size_t)o[13],
                        cudaMemcpyHostToDevice, s);
  if (err == cudaSuccess) {
    const uint8_t* b = k.dev_in;
    const int32_t* evs = (const int32_t*)(b + o[11]);
    RefreshArgs rf{(const int32_t*)(b + o[0]), (const int32_t*)(b + o[1]),
                   (const int32_t*)(b + o[2]), b + o[3], b + o[4], b + o[5],
                   (const int8_t*)(b + o[6]), (const int32_t*)(b + o[7]),
                   (const int32_t*)(b + o[8]), (const int32_t*)(b + o[9]),
                   (const int32_t*)(b + o[10])};
    AckArgs ev{evs, evs + E, evs + 2 * (size_t)E, evs + 3 * (size_t)E,
               b + o[12]};
    err = (cudaError_t)launch_refresh(k.st, rf, ev, now_ms, timeout_ms,
                                      const_cast<int32_t*>(k.dev_out), k.G,
                                      k.P, D, E, k.tile, s);
  }
  if (err == cudaSuccess)
    err = cudaMemcpyAsync(k.host_out, k.dev_out, (size_t)16 * k.G,
                          cudaMemcpyDeviceToHost, s);
  if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  if (prev != k.device) cudaSetDevice(prev);
  return (int)err;
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

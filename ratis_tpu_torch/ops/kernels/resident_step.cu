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
// Bound on the card: at the main path's shape (G = 1024, P = 8, E <= 16384)
// one K1/K2/K5 tick moves ~0.2 MB, ~0.06 us at 3.35 TB/s, and does a few
// thousand integer operations.  K6 at the bench's shapes must move ~1.9 MB
// (G = 10240, P = 8, E = 4096; ~0.56 us) and ~18 MB (G = 102400, E = 8192;
// ~5.4 us), most of it the two [G, P] arrays read and their copies written.
// Bytes bind none of them at 1024 and 10240 groups: the latency of each
// launch and of the dependent steps inside it (a few us) and the host's
// work around it do.  So K1, K2 and K5 are each ONE launch of one tile
// kernel, ``tile_tick``, and the engine reaches each through a prepared
// call that is one C call per tick; K6 is ONE launch of ``engine_step``.
//
// tile_tick: each block owns a tile of T consecutive group rows (T = 32,
// or 128 above 16384 rows, where the event scans below would dominate:
// ``ops.quorum.tick_tile``; 64 was never faster on an H100) and does the
// whole tick for them in shared memory:
// 1. it starts asynchronous 16-byte copies (cp.async) of its tile of the
//    ten state arrays into shared memory (~3 KB at T = 32, P = 8) and,
//    while they are in flight, scans the tick's row indices (16-byte
//    loads, from L2: every block reads them all):
//    - K2: the D refresh indices, noting per tile row which refresh entry
//      lands on it;
//    - K1, K5: the packed event columns of the planes the tile overlaps,
//      listing those that land in it (a shared list of up to kHitCap); a
//      tile that more land in (a hot group's acks) scans the columns
//      again after the copies and lands its hits kLandBatch a thread at
//      a time (the engine pads a tick with a row index that lands in no
//      tile);
// 2. it waits for the copies and lands the tick's events on the tile:
//    - K2: the refreshed rows over the staged tile, then the E ack columns
//      with shared-memory atomicMax on match and ack (a column's other
//      fields are read only when its row is in the tile);
//    - K1, K5: each listed column's slot update (flush by shared atomicMax;
//      the deadline by a plain store: update slots are unique per tick,
//      and where two name one row either may land, as in XLA) and its ack
//      (atomicMax on match and ack); integer max is order-free, so the
//      result is deterministic.  Updates and acks touch disjoint arrays,
//      so one pass lands both, and both land before the row math, as in
//      JAX: a deadline re-armed in the same tick is seen by the timeout
//      check;
// 3. it runs the row math on the shared tile with one lane per peer slot
//    (8 or 16 lanes a row): a member's rank in its row is counted over the
//    row's lanes with warp shuffles, O(P) dependent steps a lane where one
//    thread per row takes O(P^2), and the majority member is picked by a
//    ballot, ties broken by peer index; lane 0 of each row writes out[4, G]
//    and the new commit and (disarmed) deadline where they changed;
// 4. it writes back, with 16-byte stores, only what changed: every array
//    of a tile that a refresh row landed in, flush of a tile a flush
//    update landed in, match and ack of a tile an ack landed in.
// The scans cost every block its events' index loads from L2: D + E for
// K2, E for K1 (at most 64 KB at the engine's caps).  K5 is K1 over S
// contiguous slices of Gs = G / S rows, each with its own event plane of E
// columns ([7, S, E]) whose rows are local to the slice: a block scans
// only the planes of the slices its tile overlaps (Gs need not be a
// multiple of T, so a tile may straddle two slices), and a column of
// plane s wraps and drops its row by Gs, so a row past the slice is
// dropped, never spilled into the next, and -1 is the slice's last row.
// With S = 1 it is K1: both run the same code.
//
// The engine reaches K2 through ``k2_tick`` and K1 / K5 through
// ``fast_tick`` on a prepared call (``tick_plan_new`` once per resident
// state): the host packs the tick into one pinned buffer (the layout is
// the host's: each tick passes its sections' byte offsets), and one C call
// copies it to the card, launches ``tile_tick``, copies out[4, G] back and
// synchronises the stream.  The public wrappers launch the same kernel on
// separate tensors (``k1_resident_fast``, ``k5_resident_fast_sliced``,
// ``k2_resident``).
//
// K6, ``engine_step``, is one launch.  Each block owns a range of about
// G / 256 consecutive group rows (a multiple of 32: 64 at 10240 rows, 416
// at 102400), so the grid is about two blocks an SM at the bench's shapes:
// 1. the block scans the group row of every ack column (16-byte loads,
//    from L2) and lists those landing in its rows (up to kStepHits; a
//    block that more land in has each warp scan the columns itself);
// 2. each warp takes 32 of its rows at a time: it stages their match and
//    ack (32 x P contiguous values, coalesced loads) in shared memory,
//    lands the listed acks there (separate atomicMax on match and ack,
//    the column's other fields read only for a listed column), writes
//    the rows to match_out / ack_out (coalesced stores) and runs the row
//    math a lane per row on its <= MAXP peer values in registers (ranks
//    counted in O(P^2) compares by ``row_math.cuh``), writing new_commit
//    and flags.
// So K6 reads each input once and writes each output once, writes no
// input and needs no copy before it (an earlier design copied match and
// ack into the outputs with two device-to-device copies, then scattered
// into them and ran the rows in two more launches).  Every block scans
// every ack column's row index, which is why a block owns hundreds of
// rows at 102400 (the tile kernel of K1 scans them from 800 blocks
// there, and that cost it more than its one launch saved); a
// cooperative design (the acks into a scratch, a grid sync, the rows)
// measured slower than the old four nodes at both bench shapes.
//
// Scatter indices follow XLA's mode="drop": an index in [-n, -1] counts
// from the end of its own dimension (n + idx), one outside [-n, n) is
// skipped (the engine pads refresh rows with index G, fast-tick columns
// with PACK_SENTINEL).  Refresh rows are unique once wrapped (the engine
// packs each dirty row once); if two were not, either may land, as either
// may in XLA.  int32 arithmetic that XLA wraps
// (now - quorum_ack) is done in uint32: signed overflow is undefined in
// C++.

#include <climits>

#include "row_math.cuh"

namespace {

constexpr int32_t kSentinel = INT32_MIN;  // ops.quorum.PACK_SENTINEL
constexpr int8_t kRoleFollower = 1;
constexpr int8_t kRoleLeader = 3;

// -- K1, K2, K5: the tile kernel --------------------------------------------

constexpr int kTileThreads = 256;
constexpr int kMaxTile = 128;
// the event columns a K1 / K5 block lists while its tile is copied in,
// and the listed columns whose fields a thread loads before landing any
// (kTileThreads * kLandBatch <= kHitCap: the rescan of a tile whose list
// overflowed gathers each thread's hits in the list)
constexpr int kHitCap = 2048;
constexpr int kLandBatch = 4;
static_assert(kTileThreads * kLandBatch <= kHitCap, "rescan slots");
// a listed column is (column << 8) | tile row: at most 2^23 columns
constexpr long long kMaxColumns = 1 << 23;

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

// The packed fast tick's seven rows, each [S, E] (plane s at s * E): slot
// local to the slice, peer, match, time, valid (acks), new flush, new
// deadline (updates; PACK_SENTINEL where none)
struct FastArgs {
  const int32_t* slot;
  const int32_t* peer;
  const int32_t* match;
  const int32_t* time;
  const int32_t* valid;
  const int32_t* flush;
  const int32_t* deadline;
};

// A block's tile of the state in shared memory, and what the tick changed
// in it
template <int T>
struct Tile {
  alignas(16) int32_t match[T * MAXP];
  alignas(16) int32_t ack[T * MAXP];
  alignas(16) uint8_t self_mask[T * MAXP];
  alignas(16) uint8_t cur[T * MAXP];
  alignas(16) uint8_t old[T * MAXP];
  alignas(16) int32_t flush[T];
  alignas(16) int32_t commit[T];
  alignas(16) int32_t first[T];
  alignas(16) int32_t deadline[T];
  alignas(16) int8_t role[T];
  int rows;       // a refresh row landed: every array changed
  int flushed;    // a flush update landed
  int deadlined;  // a deadline update landed
  int acked;      // an ack landed
};

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

// Step 1: start the copies of rows [r0, r0 + n) into the tile.
template <int T>
__device__ __forceinline__ void stage_tile(Tile<T>& t, const StateArgs& st,
                                           int r0, int n, int P) {
  const size_t base = (size_t)r0 * P;
  const int np = n * P;
  stage(t.match, st.match + base, np * 4);
  stage(t.ack, st.ack + base, np * 4);
  stage(t.self_mask, st.self_mask + base, np);
  stage(t.cur, st.cur + base, np);
  stage(t.old, st.old + base, np);
  stage(t.flush, st.flush + r0, n * 4);
  stage(t.commit, st.commit + r0, n * 4);
  stage(t.first, st.first + r0, n * 4);
  stage(t.deadline, st.deadline + r0, n * 4);
  stage(t.role, st.role + r0, n);
}

// Step 3: the row math of the tile, one lane per peer slot.  L (8 or 16,
// >= P) consecutive lanes hold a row; a member's rank in its row is
// counted over L shuffles, so a row costs O(P) steps per lane instead of
// O(P^2) in one thread.  Lane 0 of each row writes out[4, G], and the new
// commit and deadline into the state where the tick changed them.
template <int L, int T>
__device__ __forceinline__ void tile_row_math(
    const StateArgs& st, const Tile<T>& t, int r0, int n, int now,
    int timeout, int32_t* __restrict__ out, int G, int P) {
  const int lane = threadIdx.x % L;
  const int shift = (threadIdx.x % 32) / L * L;
  const int rows_per_pass = blockDim.x / L;
  const bool rows_changed = t.rows != 0;
  const bool deadlines_changed = rows_changed || t.deadlined != 0;
  for (int base = 0; base < n; base += rows_per_pass) {
    const int r = base + threadIdx.x / L;
    const bool row = r < n;
    const bool in = row && lane < P;
    const int i = r * P + lane;
    const int32_t fl = row ? t.flush[r] : 0;
    const bool self = in && t.self_mask[i];
    const int32_t eff = self ? fl : (in ? t.match[i] : kIntMax);
    const int32_t eff_ack = self ? now : (in ? t.ack[i] : kIntMax);
    const unsigned cb =
        (__ballot_sync(kFullWarp, in && t.cur[i]) >> shift) & ((1u << L) - 1u);
    const unsigned ob =
        (__ballot_sync(kFullWarp, in && t.old[i]) >> shift) & ((1u << L) - 1u);
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
    const int8_t role = t.role[r];
    const bool is_leader = role == kRoleLeader;
    const int32_t c = t.commit[r], dl = t.deadline[r];
    const bool ok = is_leader && cand > c && cand >= t.first[r];
    const int32_t new_commit = ok ? cand : c;
    const bool timed_out = role == kRoleFollower && now >= dl;
    // int32 subtraction wraps, as in XLA
    const bool stale = is_leader && wrap_sub(now, q) > timeout;
    const int g = r0 + r;
    if (ok || rows_changed) st.commit[g] = new_commit;
    if (timed_out || deadlines_changed)
      st.deadline[g] = timed_out ? kIntMax : dl;
    out[g] = new_commit;
    out[G + g] = ok;
    out[2 * G + g] = timed_out;
    out[3 * G + g] = stale;
  }
}

// Step 4: write back what the tick changed (commit and deadline went
// straight to the state in step 3).
template <int T>
__device__ __forceinline__ void write_back(const Tile<T>& t,
                                           const StateArgs& st, int r0,
                                           int n, int P) {
  const size_t base = (size_t)r0 * P;
  const int np = n * P;
  if (t.rows) {
    unstage(st.self_mask + base, t.self_mask, np);
    unstage(st.cur + base, t.cur, np);
    unstage(st.old + base, t.old, np);
    unstage(st.role + r0, t.role, n);
    unstage(st.first + r0, t.first, n * 4);
  }
  if (t.rows || t.flushed) unstage(st.flush + r0, t.flush, n * 4);
  if (t.rows || t.acked) {
    unstage(st.match + base, t.match, np * 4);
    unstage(st.ack + base, t.ack, np * 4);
  }
}

// K2's events: D refresh rows, then E unpacked acks with global rows.
struct RefreshEvents {
  RefreshArgs rf;
  AckArgs ev;
  int D, E;

  struct Shared {
    int src[kMaxTile];  // the refresh entry that lands on a row, or -1
    int refreshed;
  };

  __device__ void init(Shared& s) const {
    for (int i = threadIdx.x; i < kMaxTile; i += blockDim.x) s.src[i] = -1;
    if (threadIdx.x == 0) s.refreshed = 0;
  }

  // step 1, while the tile is copied in: which refresh entry lands where
  __device__ void scan(Shared& s, int r0, int n, int G) const {
    for_each_index(rf.idx, D, [&](int d, int32_t raw) {
      int r = wrap_index(raw, G) - r0;
      if (r >= 0 && r < n) {
        s.src[r] = d;
        s.refreshed = 1;
      }
    });
  }

  // step 2: the refreshed rows over the staged tile, then the acks on top
  template <int T>
  __device__ void land(Shared& s, Tile<T>& t, int r0, int n, int G,
                       int P) const {
    if (s.refreshed) {
      const int np = n * P;
      for (int i = threadIdx.x; i < np; i += blockDim.x) {
        int d = s.src[i / P];
        if (d < 0) continue;
        size_t src = (size_t)d * P + i % P;
        t.match[i] = rf.match[src];
        t.ack[i] = rf.ack[src];
        t.self_mask[i] = rf.self_mask[src];
        t.cur[i] = rf.cur[src];
        t.old[i] = rf.old[src];
      }
      for (int r = threadIdx.x; r < n; r += blockDim.x) {
        int d = s.src[r];
        if (d < 0) continue;
        t.role[r] = rf.role[d];
        t.flush[r] = rf.flush[d];
        t.commit[r] = rf.commit[d];
        t.first[r] = rf.first[d];
        t.deadline[r] = rf.deadline[d];
      }
      if (threadIdx.x == 0) t.rows = 1;
    }
    __syncthreads();
    for_each_index(ev.g, E, [&](int e, int32_t raw) {
      int r = wrap_index(raw, G) - r0;
      if (r < 0 || r >= n) return;
      // the column's fields, loaded together
      const uint8_t valid = __ldg(ev.valid + e);
      const int p = wrap_index(__ldg(ev.p + e), P);
      const int32_t m = __ldg(ev.m + e), ts = __ldg(ev.t + e);
      if (valid == 0 || p < 0 || p >= P) return;
      atomicMax(&t.match[r * P + p], m);
      atomicMax(&t.ack[r * P + p], ts);
      t.acked = 1;
    });
  }
};

// K1's and K5's events: S planes of E packed columns, rows local to the
// slice of Gs = G / S rows (K1: S = 1).
struct FastEvents {
  FastArgs a;
  int S, E;

  struct Shared {
    int hits[kHitCap];  // (column << 8) | tile row of the listed columns
    int n;              // the columns that land in the tile
  };

  __device__ void init(Shared& s) const {
    if (threadIdx.x == 0) s.n = 0;
  }

  // the tile row a column of plane s lands on, or -1
  __device__ __forceinline__ int row_of(int s, int32_t raw, int r0, int n,
                                        int gs) const {
    int l = wrap_index(raw, gs);
    if (l < 0 || l >= gs) return -1;
    int r = s * gs + l - r0;
    return r >= 0 && r < n ? r : -1;
  }

  // f(column, tile row) for each column of the planes this tile overlaps
  // that lands in it
  template <typename F>
  __device__ __forceinline__ void for_each_hit(int r0, int n, int G,
                                               F&& f) const {
    const int gs = G / S;
    for (int s = r0 / gs; s <= (r0 + n - 1) / gs; ++s)
      for_each_index(a.slot + (size_t)s * E, E, [&](int e, int32_t raw) {
        const int r = row_of(s, raw, r0, n, gs);
        if (r >= 0) f(s * E + e, r);
      });
  }

  // step 1, while the tile is copied in: list the columns that land in it
  __device__ void scan(Shared& sh, int r0, int n, int G) const {
    for_each_hit(r0, n, G, [&](int c, int r) {
      const int k = atomicAdd(&sh.n, 1);
      if (k < kHitCap) sh.hits[k] = (c << 8) | r;
    });
  }

  // the updates (flush by atomicMax, the deadline by a plain store) and
  // acks (atomicMax on match and ack) of the listed columns h[0, nh),
  // nh <= kLandBatch, every column's fields loaded before any lands
  template <int T>
  __device__ __forceinline__ void land_batch(Tile<T>& t, const int* h,
                                             int nh, int P) const {
    int r[kLandBatch], p[kLandBatch];
    int32_t f[kLandBatch], dl[kLandBatch], valid[kLandBatch];
    int32_t m[kLandBatch], ts[kLandBatch];
#pragma unroll
    for (int k = 0; k < kLandBatch; ++k) {
      r[k] = -1;
      if (k >= nh) continue;
      const int c = h[k] >> 8;
      r[k] = h[k] & 255;
      f[k] = __ldg(a.flush + c);
      dl[k] = __ldg(a.deadline + c);
      valid[k] = __ldg(a.valid + c);
      p[k] = wrap_index(__ldg(a.peer + c), P);
      m[k] = __ldg(a.match + c);
      ts[k] = __ldg(a.time + c);
    }
#pragma unroll
    for (int k = 0; k < kLandBatch; ++k) {
      if (r[k] < 0) continue;
      if (f[k] != kSentinel) {
        atomicMax(&t.flush[r[k]], f[k]);
        t.flushed = 1;
      }
      if (dl[k] != kSentinel) {
        t.deadline[r[k]] = dl[k];
        t.deadlined = 1;
      }
      if (valid[k] == 0 || p[k] < 0 || p[k] >= P) continue;
      atomicMax(&t.match[r[k] * P + p[k]], m[k]);
      atomicMax(&t.ack[r[k] * P + p[k]], ts[k]);
      t.acked = 1;
    }
  }

  // step 2: the listed columns, kLandBatch a thread at a time.  A tile
  // that more columns landed in than the list holds (a hot group's, or
  // padding on one row) scans its planes again, each thread gathering its
  // hits in its own kLandBatch slots of the list and landing them a batch
  // at a time.
  template <int T>
  __device__ void land(Shared& sh, Tile<T>& t, int r0, int n, int G,
                       int P) const {
    const int hits = sh.n;
    if (hits <= kHitCap) {
      for (int i = threadIdx.x * kLandBatch; i < hits;
           i += blockDim.x * kLandBatch)
        land_batch(t, sh.hits + i, min(kLandBatch, hits - i), P);
      return;
    }
    int* mine = sh.hits + threadIdx.x * kLandBatch;
    int nb = 0;
    for_each_hit(r0, n, G, [&](int c, int r) {
      mine[nb++] = (c << 8) | r;
      if (nb == kLandBatch) {
        land_batch(t, mine, nb, P);
        nb = 0;
      }
    });
    land_batch(t, mine, nb, P);
  }
};

// One tick on a tile of T rows: copy in while scanning the events (1),
// land the events (2), the row math (3), write back (4).  ``meta``, when
// given, holds (now, timeout) on the card (the K1 / K5 public wrappers);
// otherwise they are the arguments.
template <int T, int L, class Events>
__global__ void __launch_bounds__(kTileThreads)
    tile_tick(StateArgs st, Events ev, int now, int timeout,
              const int32_t* __restrict__ meta, int32_t* __restrict__ out,
              int G, int P) {
  __shared__ Tile<T> t;
  __shared__ typename Events::Shared es;
  const int r0 = blockIdx.x * T;
  const int n = min(T, G - r0);
  if (meta != nullptr) {
    now = meta[0];
    timeout = meta[1];
  }

  stage_tile(t, st, r0, n, P);
  if (threadIdx.x == 0) t.rows = t.flushed = t.deadlined = t.acked = 0;
  ev.init(es);
  __syncthreads();
  ev.scan(es, r0, n, G);
  cp_async_wait_all();
  __syncthreads();

  ev.land(es, t, r0, n, G, P);
  __syncthreads();

  tile_row_math<L>(st, t, r0, n, now, timeout, out, G, P);
  write_back(t, st, r0, n, P);
}

template <int T, class Events>
void launch_tile(const StateArgs& st, const Events& ev, int now, int timeout,
                 const int32_t* meta, int32_t* out, int G, int P,
                 cudaStream_t s) {
  const int grid = (G + T - 1) / T;
  if (P <= 8)
    tile_tick<T, 8><<<grid, kTileThreads, 0, s>>>(st, ev, now, timeout,
                                                  meta, out, G, P);
  else
    tile_tick<T, 16><<<grid, kTileThreads, 0, s>>>(st, ev, now, timeout,
                                                   meta, out, G, P);
}

// One launch of ``tile_tick`` with tiles of ``tile`` rows (32 or 128),
// then the launch's error.
template <class Events>
int launch_tick(const StateArgs& st, const Events& ev, int now, int timeout,
                const int32_t* meta, int32_t* out, int G, int P, int tile,
                cudaStream_t s) {
  if (P < 1 || P > MAXP) return (int)cudaErrorInvalidValue;
  if (G > 0) {
    switch (tile) {
      case 32:
        launch_tile<32>(st, ev, now, timeout, meta, out, G, P, s);
        break;
      case 128:
        launch_tile<128>(st, ev, now, timeout, meta, out, G, P, s);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

// K1 (S = 1) and K5 on a packed [7, S, E] event array: G a multiple of S,
// S * E an int
int launch_fast(const StateArgs& st, const int32_t* ev, const int32_t* meta,
                int now, int timeout, int32_t* out, int G, int P, int S,
                int E, int tile, cudaStream_t s) {
  if (S < 1 || E < 0 || G % S != 0 || (long long)S * E > kMaxColumns)
    return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)S * E;
  FastEvents fe{{ev, ev + n, ev + 2 * n, ev + 3 * n, ev + 4 * n, ev + 5 * n,
                 ev + 6 * n},
                S,
                E};
  return launch_tick(st, fe, now, timeout, meta, out, G, P, tile, s);
}

// A prepared call on one resident state: its ten arrays, a pinned input
// buffer and its device copy (room for the largest packed tick), and
// out[4, G] on the card and pinned on the host.
struct TickPlan {
  StateArgs st;
  const uint8_t* host_in;  // pinned
  uint8_t* dev_in;
  const int32_t* dev_out;  // int32 [4, G]
  int32_t* host_out;       // pinned int32 [4, G]
  int G, P, tile, device;
};

// One tick through a plan, in one call: ``nbytes`` of the packed input to
// the card, ``launch(dev_in)``, out[4, G] back to the pinned host buffer,
// and the stream synchronised.
template <class Launch>
int run_plan(const TickPlan& k, size_t nbytes, cudaStream_t s,
             Launch&& launch) {
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != k.device) err = cudaSetDevice(k.device);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyAsync(k.dev_in, k.host_in, nbytes, cudaMemcpyHostToDevice,
                        s);
  if (err == cudaSuccess) err = (cudaError_t)launch(k.dev_in);
  if (err == cudaSuccess)
    err = cudaMemcpyAsync(k.host_out, k.dev_out, (size_t)16 * k.G,
                          cudaMemcpyDeviceToHost, s);
  if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  if (prev != k.device) cudaSetDevice(prev);
  return (int)err;
}

// -- K6: the stateless tick in one launch ----------------------------------

// engine_step's inputs
struct StepArgs {
  const int32_t* match;
  const int32_t* ack;
  const int32_t* ev_g;
  const int32_t* ev_p;
  const int32_t* ev_m;
  const int32_t* ev_t;
  const uint8_t* ev_valid;
  const uint8_t* self_mask;
  const int32_t* flush;
  const uint8_t* cur;
  const uint8_t* old;
  const int32_t* commit;
  const int32_t* first;
  const int8_t* role;
  const int32_t* deadline;
};

// its outputs: match and ack [G, P], new_commit [G], flags bool [3, G]
// (commit_changed, timeouts, stale)
struct StepOut {
  int32_t* match;
  int32_t* ack;
  int32_t* new_commit;
  uint8_t* flags;
};

constexpr int kStepThreads = 256;
constexpr int kStepWarps = kStepThreads / 32;
// the ack columns a block lists (more, and each warp scans the columns
// itself), and the blocks a grid aims at (rows per block: a multiple of
// 32 that gives about this many)
constexpr int kStepHits = 1024;
constexpr int kStepBlocks = 256;

// Land ack column e on local row lr of a warp's staged rows (wm, wt).
__device__ __forceinline__ void step_land(const StepArgs& a, int e, int lr,
                                          int32_t* wm, int32_t* wt, int P) {
  const uint8_t valid = a.ev_valid[e];
  const int p = wrap_index(a.ev_p[e], P);
  const int32_t m = a.ev_m[e], t = a.ev_t[e];
  if (valid == 0 || p < 0 || p >= P) return;
  atomicMax(&wm[lr * P + p], m);
  atomicMax(&wt[lr * P + p], t);
}

// Each block owns ``rows`` consecutive group rows: it lists the ack
// columns that land in them (one pass over the group row of every column,
// 16-byte loads), then each warp, 32 rows at a time, stages its rows of
// match and ack in shared memory (coalesced), lands the listed acks
// there (atomicMax), writes the rows out (coalesced) and runs the row
// math on them, a lane per row.
__global__ void __launch_bounds__(kStepThreads)
    engine_step(StepArgs a, StepOut o, int now, int timeout, int G, int P,
                int E, int rows) {
  __shared__ int32_t s_match[kStepWarps][32 * MAXP];
  __shared__ int32_t s_ack[kStepWarps][32 * MAXP];
  __shared__ int hit_e[kStepHits];
  __shared__ int hit_r[kStepHits];
  __shared__ int n_hits;
  const int r0 = blockIdx.x * rows;
  const int n_rows = min(rows, G - r0);
  if (threadIdx.x == 0) n_hits = 0;
  __syncthreads();
  for_each_index(a.ev_g, E, [&](int e, int32_t raw) {
    const int g = wrap_index(raw, G);
    if (g < 0 || g >= G || g < r0 || g >= r0 + n_rows) return;
    const int k = atomicAdd(&n_hits, 1);
    if (k < kStepHits) {
      hit_e[k] = e;
      hit_r[k] = g - r0;
    }
  });
  __syncthreads();
  const int listed = min(n_hits, kStepHits);
  const bool overflow = n_hits > kStepHits;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t* wm = s_match[warp];
  int32_t* wt = s_ack[warp];
  for (int t0 = warp * 32; t0 < n_rows; t0 += 32 * kStepWarps) {
    const int row0 = r0 + t0;
    const int n = min(32, n_rows - t0);
    const int ne = n * P;
    const size_t base = (size_t)row0 * P;
#pragma unroll 4
    for (int k = lane; k < ne; k += 32) {
      wm[k] = a.match[base + k];
      wt[k] = a.ack[base + k];
    }
    __syncwarp();
    if (!overflow) {
      for (int h = lane; h < listed; h += 32) {
        const int lr = hit_r[h] - t0;
        if (lr >= 0 && lr < n) step_land(a, hit_e[h], lr, wm, wt, P);
      }
    } else {  // more acks landed in the block than it listed
      for (int e = lane; e < E; e += 32) {
        const int lr = wrap_index(a.ev_g[e], G) - row0;
        if (lr >= 0 && lr < n) step_land(a, e, lr, wm, wt, P);
      }
    }
    __syncwarp();
#pragma unroll 4
    for (int k = lane; k < ne; k += 32) {
      o.match[base + k] = wm[k];
      o.ack[base + k] = wt[k];
    }
    if (lane < n) {
      const int g = row0 + lane;
      const size_t rb = (size_t)g * P;
      const unsigned cb = row_bits(a.cur + rb, P);
      const unsigned ob = row_bits(a.old + rb, P);
      const unsigned sb = row_bits(a.self_mask + rb, P);
      const int8_t r = a.role[g];
      const int32_t fl = a.flush[g], c = a.commit[g], first = a.first[g];
      const int32_t dl = a.deadline[g];
      const bool is_leader = r == kRoleLeader;
      int32_t eff[MAXP], eff_ack[MAXP];
#pragma unroll
      for (int i = 0; i < MAXP; ++i) {
        eff[i] = eff_ack[i] = kIntMax;
        if (i >= P) continue;
        const bool self = (sb >> i) & 1u;
        eff[i] = self ? fl : wm[lane * P + i];
        eff_ack[i] = self ? now : wt[lane * P + i];
      }
      // update_commit
      const int32_t cand = combined_majority_min(eff, cb, ob);
      const bool ok = is_leader && cand > c && cand >= first;
      // election_timeout
      const bool timed_out = r == kRoleFollower && now >= dl;
      // check_leadership (int32 subtraction wraps, as in XLA)
      const int32_t quorum_ack = combined_majority_min(eff_ack, cb, ob);
      const bool stale = is_leader && wrap_sub(now, quorum_ack) > timeout;
      o.new_commit[g] = ok ? cand : c;
      o.flags[g] = ok;
      o.flags[G + g] = timed_out;
      o.flags[2 * (size_t)G + g] = stale;
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" {

const char* k_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K1 on separate tensors: ev is int32 [7, E] (rows: slot, peer, match,
// time, valid, flush, deadline), meta int32 [2] (now_ms,
// leadership_timeout_ms) on the card; one launch of ``tile_tick``
int k1_resident_fast(int32_t* match, int32_t* ack, uint8_t* self_mask,
                     uint8_t* cur, uint8_t* old, int8_t* role,
                     int32_t* flush, int32_t* commit, int32_t* first,
                     int32_t* deadline, const int32_t* ev,
                     const int32_t* meta, int32_t* out, int G, int P, int E,
                     int tile, void* stream) {
  StateArgs st{match, ack, self_mask, cur, old, role, flush, commit, first,
               deadline};
  return launch_fast(st, ev, meta, 0, 0, out, G, P, 1, E, tile,
                     (cudaStream_t)stream);
}

// K5 on separate tensors: ev is int32 [7, S, E], rows local to each
// slice of G / S rows; otherwise as K1
int k5_resident_fast_sliced(int32_t* match, int32_t* ack, uint8_t* self_mask,
                            uint8_t* cur, uint8_t* old, int8_t* role,
                            int32_t* flush, int32_t* commit, int32_t* first,
                            int32_t* deadline, const int32_t* ev,
                            const int32_t* meta, int32_t* out, int G, int P,
                            int S, int E, int tile, void* stream) {
  StateArgs st{match, ack, self_mask, cur, old, role, flush, commit, first,
               deadline};
  return launch_fast(st, ev, meta, 0, 0, out, G, P, S, E, tile,
                     (cudaStream_t)stream);
}

// K2 on separate tensors: refresh D rows, scatter E unpacked acks, the
// row math, in one launch of ``tile_tick`` with tiles of ``tile`` rows
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
  RefreshEvents re{{rf_idx, rf_match, rf_ack, rf_self, rf_cur, rf_old,
                    rf_role, rf_flush, rf_commit, rf_first, rf_deadline},
                   {ev_g, ev_p, ev_m, ev_t, ev_valid},
                   D,
                   E};
  return launch_tick(st, re, now_ms, timeout_ms, nullptr, out, G, P, tile,
                     (cudaStream_t)stream);
}

// A prepared call (K2's refresh plan, or K1's / K5's fast plan) on one
// resident state: its ten arrays, a pinned input buffer and its device
// copy, out[4, G] on the card and pinned on the host, and the tile size.
// Freed by tick_plan_free.
void* tick_plan_new(int32_t* match, int32_t* ack, uint8_t* self_mask,
                    uint8_t* cur, uint8_t* old, int8_t* role, int32_t* flush,
                    int32_t* commit, int32_t* first, int32_t* deadline,
                    const uint8_t* host_in, uint8_t* dev_in,
                    const int32_t* dev_out, int32_t* host_out, int G, int P,
                    int tile, int device) {
  return new TickPlan{{match, ack, self_mask, cur, old, role, flush, commit,
                       first, deadline},
                      host_in, dev_in, dev_out, host_out, G, P, tile,
                      device};
}

void tick_plan_free(void* plan) { delete (TickPlan*)plan; }

// One refresh tick through a plan (D refresh rows, E ack columns).  The
// host owns the packed layout: ``offsets`` holds the byte offsets in it of
// idx [D], match, ack [D, P], self, cur, old [D, P], role [D], flush,
// commit, first, deadline [D], the ack columns [4, E] (group, peer, match,
// time) and valid [E], in that order, then the bytes to copy; every int32
// section 4-byte aligned.
int k2_tick(void* plan, int D, int E, int now_ms, int timeout_ms,
            const long long* offsets, void* stream) {
  const TickPlan& k = *(const TickPlan*)plan;
  const long long* o = offsets;
  return run_plan(k, (size_t)o[13], (cudaStream_t)stream,
                  [&](const uint8_t* b) {
    const int32_t* evs = (const int32_t*)(b + o[11]);
    RefreshEvents re{
        {(const int32_t*)(b + o[0]), (const int32_t*)(b + o[1]),
         (const int32_t*)(b + o[2]), b + o[3], b + o[4], b + o[5],
         (const int8_t*)(b + o[6]), (const int32_t*)(b + o[7]),
         (const int32_t*)(b + o[8]), (const int32_t*)(b + o[9]),
         (const int32_t*)(b + o[10])},
        {evs, evs + E, evs + 2 * (size_t)E, evs + 3 * (size_t)E, b + o[12]},
        D,
        E};
    return launch_tick(k.st, re, now_ms, timeout_ms, nullptr,
                       const_cast<int32_t*>(k.dev_out), k.G, k.P, k.tile,
                       (cudaStream_t)stream);
  });
}

// One fast tick through a plan (K1 with S = 1, K5 with the mesh's S): S
// planes of E packed columns.  ``offsets`` holds the byte offsets in the
// host's layout of the seven int32 [S, E] rows (slot, peer, match, time,
// valid, flush, deadline), in that order, then the bytes to copy.
int fast_tick(void* plan, int S, int E, int now_ms, int timeout_ms,
              const long long* offsets, void* stream) {
  const TickPlan& k = *(const TickPlan*)plan;
  const long long* o = offsets;
  if (S < 1 || E < 0 || k.G % S != 0 || (long long)S * E > kMaxColumns)
    return (int)cudaErrorInvalidValue;
  return run_plan(k, (size_t)o[7], (cudaStream_t)stream,
                  [&](const uint8_t* b) {
    FastEvents fe{{(const int32_t*)(b + o[0]), (const int32_t*)(b + o[1]),
                   (const int32_t*)(b + o[2]), (const int32_t*)(b + o[3]),
                   (const int32_t*)(b + o[4]), (const int32_t*)(b + o[5]),
                   (const int32_t*)(b + o[6])},
                  S,
                  E};
    return launch_tick(k.st, fe, now_ms, timeout_ms, nullptr,
                       const_cast<int32_t*>(k.dev_out), k.G, k.P, k.tile,
                       (cudaStream_t)stream);
  });
}

// K6: the stateless tick, arguments in engine_step's order, in ONE
// launch: each block lists the acks landing in its rows, then copies its
// rows of match and ack with those acks into match_out / ack_out and runs
// the row math into new_commit [G] and flags bool [3, G] (commit_changed,
// timeouts, stale).  No input is written.
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
  if (P < 1 || P > MAXP || G < 0 || E < 0) return (int)cudaErrorInvalidValue;
  if (G == 0) return (int)cudaSuccess;
  // rows per block: a multiple of 32 giving about kStepBlocks blocks
  const long long per = ((long long)G + kStepBlocks - 1) / kStepBlocks;
  const int rows = (int)((per + 31) / 32 * 32);
  const int grid = (G + rows - 1) / rows;
  StepArgs a{match, ack, ev_g, ev_p, ev_m, ev_t, ev_valid, self_mask, flush,
             cur, old, commit, first, role, deadline};
  StepOut o{match_out, ack_out, new_commit, flags};
  engine_step<<<grid, kStepThreads, 0, (cudaStream_t)stream>>>(
      a, o, now_ms, timeout_ms, G, P, E, rows);
  return (int)cudaGetLastError();
}

}  // extern "C"

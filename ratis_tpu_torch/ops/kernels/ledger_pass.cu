// K4: the fused lag & health ledger pass, in one launch.
//
// Replaces ratis_tpu/ops/ledger.py:ledger_pass (jitted by XLA): per-group
// gap / commit delta / worst follower link, a per-peer log2 lag histogram,
// six per-peer link rollups and two scalars, packed into one int32 vector
// (layout: ops.ledger.pack_slices) so the host fetches it in one copy.
//
// Bound on the card: at G = 1024, P = 8, W = 8 it reads ~170 KB (four
// int32 and three bool [G, P] arrays plus the [G] vectors) and writes
// ~17 KB, ~0.06 us at 3.35 TB/s.  Latency bounds it: of the launch, of
// the loads of a row's links, and of the atomics on a few hundred per-peer
// counters, which every link hits.  So the pass is ONE cooperative launch
// (an earlier design cleared the counters in a launch of their own, and
// ran a row's links one after another in one thread), reached by the
// engine through one prepared call per ledger sample (``k4_tick``: inputs
// up, the launch, the packed vector down, one synchronisation):
// 1. the grid sets the output's W x 38 + 2 counters to their identity (0,
//    -1 for the peer max lag) while each block counts its rows' links
//    into its own copy of them in shared memory; one lane per link (L = 8
//    or 16 lanes a row, >= P), so a row's link loads are issued together
//    and its worst link is a shuffle reduction (ties: the first column);
// 2. one grid sync, after which every block adds its non-zero counters
//    to the output with global atomics.
// Where the counters do not fit in 48 KB of shared memory (W > 323) the
// grid syncs after step 1's clearing and the links count straight into
// the output with global atomics.  The grid is no larger than the card
// holds at once (the cooperative launch guarantees the sync), rows in
// grid-stride.
//
// Counts are int32 throughout: the JAX version forms the histogram as an
// f32 einsum, which is exact on the CPU but would lose counts above 2^11
// under TF32.  Differences that XLA computes in wrapping int32
// (commit - match, commit - prev, now - last_ack) are taken in uint32
// here; signed overflow is undefined in C++.  The gap sum wraps as XLA's
// int32 sum does (unsigned adds).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBuckets = 32;  // ops.ledger.LAG_BUCKETS
constexpr int kPeerRows = 6;  // links, up, laggy, active, laggy_active, max
constexpr size_t kSmemCounters = 48 * 1024;
constexpr int kMaxPeers = 16;  // ops.quorum.MAX_KERNEL_PEERS
constexpr unsigned kFull = 0xffffffffu;
constexpr int8_t kRoleUnused = 0;
constexpr int8_t kRoleLeader = 3;

// the counters after the four [G] sections: hist [W * 32], the six
// per-peer rows [W] each (the last, the max lag), then the leader count
// and the gap sum
__host__ __device__ __forceinline__ int n_counters(int W) {
  return W * (kBuckets + kPeerRows) + 2;
}

__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}

// bit_length by integer compare-sum against 1 << i, i < 31
__device__ __forceinline__ int lag_bucket(int32_t lag) {
  int b = 0;
#pragma unroll
  for (int i = 0; i < kBuckets - 1; ++i) b += lag >= (int32_t)(1u << i);
  return b;
}

// the eleven inputs, in ledger_pass's order
struct LedgerArgs {
  const int8_t* role;
  const int32_t* match;
  const int32_t* commit;
  const int32_t* applied;
  const uint8_t* cur;
  const uint8_t* old;
  const uint8_t* self_mask;
  const int32_t* last_ack;
  const int32_t* peer_index;
  const int32_t* prev_commit;
  const uint8_t* prev_valid;
};

// a counter's identity: -1 for the peer max lag, else 0
__device__ __forceinline__ int32_t identity(int i, int W) {
  const int max_row = W * kBuckets + 5 * W;
  return (i >= max_row && i < max_row + W) ? -1 : 0;
}

// Rows of L lanes, one lane per peer slot (L >= P).
template <int L>
__global__ void __launch_bounds__(kThreads)
    ledger(LedgerArgs a, int now, int lag_threshold, int up_window,
           int32_t* __restrict__ out, int G, int P, int W, int use_smem) {
  extern __shared__ int32_t smem[];
  const int n = n_counters(W);
  int32_t* tail = out + 4 * (size_t)G;
  // 1. the output's counters to their identity, the block's copy too
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    tail[i] = identity(i, W);
  if (use_smem) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) smem[i] = identity(i, W);
    __syncthreads();
  } else {
    cooperative_groups::this_grid().sync();
  }
  int32_t* acc = use_smem ? smem : tail;
  int32_t* hist = acc;
  int32_t* links = acc + W * kBuckets;
  int32_t* up_n = links + W;
  int32_t* laggy_n = up_n + W;
  int32_t* active_n = laggy_n + W;
  int32_t* laggy_active_n = active_n + W;
  int32_t* max_lag = laggy_active_n + W;
  int32_t* scalars = max_lag + W;

  const int p = threadIdx.x % L;
  const int rows_per_block = blockDim.x / L;
  // every lane of a block runs every step (a lane past G or P counts
  // nothing), so the row's shuffles see all its lanes
  for (int base = blockIdx.x * rows_per_block; base < G;
       base += gridDim.x * rows_per_block) {
    const int g = base + threadIdx.x / L;
    const bool row = g < G;
    const bool slot = row && p < P;
    const size_t i = (size_t)g * P + p;
    // every load of the row and its link issued before any is used
    const int8_t r = row ? a.role[g] : kRoleUnused;
    const int32_t c = row ? a.commit[g] : 0;
    const int32_t applied = row ? a.applied[g] : 0;
    const int32_t prev = row ? a.prev_commit[g] : 0;
    const bool prev_ok = row && a.prev_valid[g];
    const int32_t pidx = slot ? a.peer_index[i] : -1;
    const bool member = slot && (a.cur[i] || a.old[i]) && !a.self_mask[i];
    const int32_t m = slot ? a.match[i] : 0;
    const int32_t ack = slot ? a.last_ack[i] : 0;

    const bool active = r != kRoleUnused;
    const bool is_leader = r == kRoleLeader;
    const int32_t gap = active ? max(wrap_sub(c, applied), 0) : 0;
    const int32_t delta =
        (is_leader && prev_ok) ? max(wrap_sub(c, prev), 0) : 0;
    const bool valid = member && is_leader && pidx >= 0;
    const int32_t lag = valid ? max(wrap_sub(c, m), 0) : 0;
    // the worst link: the largest lag, the first column on ties
    long long key = valid ? ((long long)lag << 5) | (31 - p) : -1;
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1)
      key = max(key, __shfl_xor_sync(kFull, key, off, L));
    const int worst_p = key >= 0 ? 31 - (int)(key & 31) : 0;
    const int32_t worst_peer = __shfl_sync(kFull, pidx, worst_p, L);
    if (p == 0 && row) {
      out[g] = gap;
      out[G + g] = delta;
      out[2 * (size_t)G + g] = key >= 0 ? (int32_t)(key >> 5) : -1;
      out[3 * (size_t)G + g] = key >= 0 ? worst_peer : -1;
    }
    // a peer outside the dense table is counted nowhere
    if (valid && pidx < W) {
      const bool up = wrap_sub(now, ack) <= up_window;
      const bool laggy = lag >= lag_threshold;
      const bool link_active = up && delta > 0;
      atomicAdd(&hist[pidx * kBuckets + lag_bucket(lag)], 1);
      atomicAdd(&links[pidx], 1);
      if (up) atomicAdd(&up_n[pidx], 1);
      if (laggy) atomicAdd(&laggy_n[pidx], 1);
      if (link_active) atomicAdd(&active_n[pidx], 1);
      if (link_active && laggy) atomicAdd(&laggy_active_n[pidx], 1);
      atomicMax(&max_lag[pidx], lag);
    }
    // the scalars, a warp at a time
    const bool first = p == 0;
    const unsigned leaders = __popc(__ballot_sync(kFull, first && is_leader));
    const unsigned gaps =
        __reduce_add_sync(kFull, first ? (unsigned)gap : 0u);
    if (threadIdx.x % 32 == 0) {
      if (leaders) atomicAdd(&scalars[0], (int32_t)leaders);
      if (gaps) atomicAdd((unsigned*)&scalars[1], gaps);
    }
  }
  if (!use_smem) return;

  // 2. after the grid sync (the output's counters are cleared), the
  // block's non-zero counters into the output
  __syncthreads();
  cooperative_groups::this_grid().sync();
  const int max_row = W * kBuckets + 5 * W;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int32_t v = smem[i];
    if (i >= max_row && i < max_row + W) {
      if (v >= 0) atomicMax(&tail[i], v);
    } else if (v != 0) {
      atomicAdd((unsigned*)&tail[i], (unsigned)v);
    }
  }
}

template <int L>
int launch_rows(const LedgerArgs& a, int now, int lag_threshold,
                int up_window, int32_t* out, int G, int P, int W,
                cudaStream_t s) {
  const size_t smem_bytes = (size_t)n_counters(W) * sizeof(int32_t);
  int use_smem = smem_bytes <= kSmemCounters;
  const size_t smem = use_smem ? smem_bytes : 0;
  int device = -1, per_sm = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ledger<L>,
                                                        kThreads, smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return (int)err;
  if (per_sm * sms < 1) return (int)cudaErrorLaunchOutOfResources;
  const int rows_per_block = kThreads / L;
  int grid = G > 0 ? (G + rows_per_block - 1) / rows_per_block : 1;
  if (grid > per_sm * sms) grid = per_sm * sms;
  void* args[] = {(void*)&a, &now, &lag_threshold, &up_window, &out,
                  &G, &P, &W, &use_smem};
  err = cudaLaunchCooperativeKernel((const void*)ledger<L>, grid, kThreads,
                                    args, smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// One cooperative launch with rows of 8 lanes (P <= 8) or 16.
int launch_ledger(const LedgerArgs& a, int now, int lag_threshold,
                  int up_window, int32_t* out, int G, int P, int W,
                  cudaStream_t s) {
  if (G < 0 || P < 0 || P > kMaxPeers || W < 1)
    return (int)cudaErrorInvalidValue;
  return P <= 8 ? launch_rows<8>(a, now, lag_threshold, up_window, out, G,
                                 P, W, s)
                : launch_rows<16>(a, now, lag_threshold, up_window, out, G,
                                  P, W, s);
}

// The engine's prepared call: the packed inputs in a pinned host buffer
// and its device copy, and out on the card and pinned on the host (room
// for a table of W_cap).
struct LedgerPlan {
  const uint8_t* host_in;  // pinned
  uint8_t* dev_in;
  int32_t* dev_out;
  int32_t* host_out;  // pinned
  int G, P, W_cap, device;
};

}  // namespace

extern "C" {

const char* k_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The public wrapper's launch.  out is int32 [4G + 38W + 2], fully written
// by the one launch.
int k4_ledger_pass(const int8_t* role, const int32_t* match,
                   const int32_t* commit, const int32_t* applied,
                   const uint8_t* cur, const uint8_t* old,
                   const uint8_t* self_mask, const int32_t* last_ack,
                   const int32_t* peer_index, const int32_t* prev_commit,
                   const uint8_t* prev_valid, int now, int lag_threshold,
                   int up_window, int32_t* out, int G, int P, int W,
                   void* stream) {
  LedgerArgs a{role, match, commit, applied, cur, old, self_mask, last_ack,
               peer_index, prev_commit, prev_valid};
  return launch_ledger(a, now, lag_threshold, up_window, out, G, P, W,
                       (cudaStream_t)stream);
}

// A prepared call of G rows, P peer slots and tables up to W_cap wide;
// freed by k4_plan_free.
void* k4_plan_new(const uint8_t* host_in, uint8_t* dev_in, int32_t* dev_out,
                  int32_t* host_out, int G, int P, int W_cap, int device) {
  return new LedgerPlan{host_in, dev_in, dev_out, host_out, G, P, W_cap,
                        device};
}

void k4_plan_free(void* plan) { delete (LedgerPlan*)plan; }

// One ledger sample through a plan, in one call: the packed inputs to the
// card, one launch, the packed output (4G + 38W + 2 int32) back to the
// pinned host buffer, the stream synchronised.  The host owns the input
// layout: ``offsets`` holds the byte offsets of the eleven inputs in
// ledger_pass's order, then the bytes to copy.  A stream being captured
// into a CUDA graph is not synchronised (it cannot be), so a captured call
// shows its copies and its one kernel.
int k4_tick(void* plan, int W, int now, int lag_threshold, int up_window,
            const long long* offsets, void* stream) {
  const LedgerPlan& k = *(const LedgerPlan*)plan;
  if (W < 1 || W > k.W_cap) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long* o = offsets;
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != k.device) err = cudaSetDevice(k.device);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyAsync(k.dev_in, k.host_in, (size_t)o[11],
                        cudaMemcpyHostToDevice, s);
  if (err == cudaSuccess) {
    const uint8_t* b = k.dev_in;
    LedgerArgs a{(const int8_t*)(b + o[0]),  (const int32_t*)(b + o[1]),
                 (const int32_t*)(b + o[2]), (const int32_t*)(b + o[3]),
                 b + o[4],                   b + o[5],
                 b + o[6],                   (const int32_t*)(b + o[7]),
                 (const int32_t*)(b + o[8]), (const int32_t*)(b + o[9]),
                 b + o[10]};
    err = (cudaError_t)launch_ledger(a, now, lag_threshold, up_window,
                                     k.dev_out, k.G, k.P, W, s);
  }
  if (err == cudaSuccess)
    err = cudaMemcpyAsync(
        k.host_out, k.dev_out,
        (4 * (size_t)k.G + n_counters(W)) * sizeof(int32_t),
        cudaMemcpyDeviceToHost, s);
  cudaStreamCaptureStatus capture = cudaStreamCaptureStatusNone;
  if (err == cudaSuccess) err = cudaStreamIsCapturing(s, &capture);
  if (err == cudaSuccess && capture == cudaStreamCaptureStatusNone)
    err = cudaStreamSynchronize(s);
  if (prev != k.device) cudaSetDevice(prev);
  return (int)err;
}

}  // extern "C"

// K3: the batched vote tally.
//
// Replaces ratis_tpu/ops/quorum.py:tally_votes (jitted by XLA): one pass
// over every group's open election round — grant majority in the current
// conf (and the old one when joint), reject majority ceil(k/2), the
// priority veto, and the strict pass that waits on every higher-priority
// member.
//
// Every count is one __popc over a row's bit words (bit p = peer p):
// ``tally_verdict`` takes the five words of a row (grants, rejects,
// conf_cur, conf_old, and the peers whose priority is above the
// candidate's) and gives the four bools, written once for both kernels:
//
// - ``tally_rows``, the one the engine runs: R gathered rows, each row's
//   four masks as bit words (one uint16 per mask, P <= 16) and its int32
//   priority row, a thread per row, so the veto compare stays on the
//   card.  The row entry reads 8 + 4P + 4 bytes a row and writes 4
//   (~3 KB at the engine's usual 64-row bucket) with a few dozen integer
//   operations: launch latency binds it, and around the launch the
//   host's work (the engine used to upload all G rows of six host arrays
//   on every vote pass, though only the rows of open rounds are read).
//   The engine's vote pass reaches it through a prepared call
//   (``k3_plan_new`` once, ``k3_tick`` per pass) over only the rows of
//   open rounds, packed by the host into one pinned buffer (the layout is
//   the host's: each pass passes its sections' byte offsets): one C call
//   copies the rows to the card, launches ``tally_rows``, copies bool
//   [4, R] back and synchronises.  ``k3_tally_rows`` launches it on
//   separate tensors.
// - ``k3_tally_votes``: the public [G, P] function, bool masks in; no
//   path of the server launches it.  It reads four bool and one int32
//   [G, P] array and int32 [G], and writes bool [4, G]: 8P + 8 bytes a
//   row, ~74 KB at G = 1024, P = 8 (latency binds it) and 7.4 MB (2.2 us
//   at 3.35 TB/s) at 102400 rows, where the bytes bind it.  One launch,
//   by one of two designs that the host picks from G
//   (``ops.quorum.tally_tile``):
//   (a) ``tally_lanes``: rows of 8 lanes, 4 rows a warp, G * 8 / 256
//       blocks, as K7b (vote_lease.cu); a lane holds one slot (P <= 8) or
//       two (slots l and l + 8) and issues all of its loads before it
//       uses any (its slots' four mask bytes and priority, and the row's
//       self priority); five ballots give the row's bit words, lanes 0-3
//       store one output plane each.  A row's loads are spread over 8
//       lanes, so the latency is short: the faster up to ~20000 rows.
//       But it issues 8 threads a row and a byte load per slot and mask,
//       and each warp writes 4 bytes of each plane, so at 102400 rows it
//       is the slower by half;
//   (b) ``tally_tile``: each block stages a tile of kTileRows rows into
//       shared memory with 16-byte asynchronous copies (row_math.cuh
//       ``stage``), then one thread a row reads its mask bytes as the
//       32-bit words that hold them (``tile_row_bits``) and its
//       priorities from a column that differs by lane, so a warp's 32
//       rows of P words fall in distinct banks; each warp writes 32 bytes
//       of each plane.  Fewer instructions move each row's bytes, so it
//       is the faster from ~20000 rows; below, its longer chain a thread
//       (copy, barrier, shared loads) shows.

#include "row_math.cuh"

namespace {

__device__ __forceinline__ bool has_majority(unsigned grants, unsigned mask) {
  return __popc(grants & mask) >= __popc(mask) / 2 + 1;
}

__device__ __forceinline__ bool majority_rejected(unsigned rejects,
                                                  unsigned mask) {
  int k = __popc(mask);
  return k > 0 && __popc(rejects & mask) >= (k + 1) / 2;
}

// The tally of one row from its bit words (bit p = peer p): grants,
// rejects, conf_cur, conf_old, and the peers whose priority is above the
// candidate's.  Bit k of the result is VoteTally's field k: passed,
// passed_on_timeout, rejected, decided.
__device__ __forceinline__ unsigned tally_verdict(unsigned gb, unsigned rb,
                                                  unsigned cb, unsigned ob,
                                                  unsigned higher) {
  higher &= cb | ob;
  const bool in_joint = ob != 0;
  const bool majority =
      has_majority(gb, cb) && (!in_joint || has_majority(gb, ob));
  const bool veto = (rb & higher) != 0;
  const bool rejected = veto || majority_rejected(rb, cb) ||
                        (in_joint && majority_rejected(rb, ob));
  const bool hp_all_replied = (higher & ~(gb | rb)) == 0;
  const bool passed = majority && hp_all_replied && !rejected;
  return (unsigned)passed | (unsigned)(majority && !rejected) << 1 |
         (unsigned)rejected << 2 | (unsigned)(passed || rejected) << 3;
}

// Design (a): rows of kRowLanes lanes, S slots a lane (lane l holds slots
// l and, for S = 2, l + 8; S * 8 >= P).  out is bool [4, G].
template <int S>
__global__ void __launch_bounds__(kThreads)
    tally_lanes(const uint8_t* __restrict__ grants,
          const uint8_t* __restrict__ rejects,
          const uint8_t* __restrict__ cur, const uint8_t* __restrict__ old,
          const int32_t* __restrict__ priority,
          const int32_t* __restrict__ self_priority,
          uint8_t* __restrict__ out, int G, int P) {
  constexpr int L = kRowLanes;
  const int lane = threadIdx.x % L;
  const int shift = (threadIdx.x % 32) / L * L;
  const int g = (blockIdx.x * blockDim.x + threadIdx.x) / L;
  // every load issued before any is used; a slot past P or a row past G
  // is in no conf and replied nothing
  uint8_t gr[S], rj[S], c[S], o[S];
  int32_t pr[S];
  int32_t sp = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int slot = lane + L * s;
    gr[s] = rj[s] = c[s] = o[s] = 0;
    pr[s] = kIntMin;
    if (g < G && slot < P) {
      const size_t i = (size_t)g * P + slot;
      gr[s] = grants[i];
      rj[s] = rejects[i];
      c[s] = cur[i];
      o[s] = old[i];
      pr[s] = priority[i];
    }
  }
  if (g < G) sp = self_priority[g];  // the same address on the row's lanes
  unsigned gb = 0, rb = 0, cb = 0, ob = 0, hb = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    gb |= lane_bits<L>(gr[s], shift, s);
    rb |= lane_bits<L>(rj[s], shift, s);
    cb |= lane_bits<L>(c[s], shift, s);
    ob |= lane_bits<L>(o[s], shift, s);
    hb |= lane_bits<L>(pr[s] > sp, shift, s);
  }
  const unsigned v = tally_verdict(gb, rb, cb, ob, hb);
  if (g < G && lane < 4) out[(size_t)lane * G + g] = (v >> lane) & 1u;
}

// Design (b): each block stages a tile of kTileRows rows, then one thread
// per row reads it.
constexpr int kTileRows = 128;

struct TallyTile {
  alignas(16) uint8_t grants[kTileRows * MAXP];
  alignas(16) uint8_t rejects[kTileRows * MAXP];
  alignas(16) uint8_t cur[kTileRows * MAXP];
  alignas(16) uint8_t old[kTileRows * MAXP];
  alignas(16) int32_t priority[kTileRows * MAXP];
  alignas(16) int32_t self_priority[kTileRows];
};

// Bytes [r P, r P + P) of a staged bool tile as a bit word (bit i = byte
// r P + i), read as the 32-bit words that hold them: the low bits of a
// word's 4 bytes gathered by one multiply.  At most S * 2 + 1 words a row
// (P <= 8 S).
template <int S>
__device__ __forceinline__ unsigned tile_row_bits(const uint8_t* m, int r,
                                                  int P) {
  const int b0 = r * P;
  const uint32_t* w = reinterpret_cast<const uint32_t*>(m) + (b0 >> 2);
  const int nw = ((b0 & 3) + P + 3) >> 2;
  unsigned bits = 0;
#pragma unroll
  for (int k = 0; k < 2 * S + 1; ++k)
    if (k < nw)
      bits |= (((w[k] & 0x01010101u) * 0x01020408u) >> 24) << (4 * k);
  return (bits >> (b0 & 3)) & ((1u << P) - 1u);
}

template <int S>
__global__ void __launch_bounds__(kTileRows)
    tally_tile(const uint8_t* __restrict__ grants,
               const uint8_t* __restrict__ rejects,
               const uint8_t* __restrict__ cur,
               const uint8_t* __restrict__ old,
               const int32_t* __restrict__ priority,
               const int32_t* __restrict__ self_priority,
               uint8_t* __restrict__ out, int G, int P) {
  __shared__ TallyTile t;
  const int r0 = blockIdx.x * kTileRows;
  const int n = min(kTileRows, G - r0);
  const size_t base = (size_t)r0 * P;
  stage(t.priority, priority + base, n * P * 4);
  stage(t.grants, grants + base, n * P);
  stage(t.rejects, rejects + base, n * P);
  stage(t.cur, cur + base, n * P);
  stage(t.old, old + base, n * P);
  stage(t.self_priority, self_priority + r0, n * 4);
  cp_async_wait_all();
  __syncthreads();
  const int r = threadIdx.x;
  if (r >= n) return;
  // the row's priorities from column (lane P / 32) on, wrapping, so the
  // warp's 32 rows of P words fall in distinct banks
  const int32_t sp = t.self_priority[r];
  const int rot = (r % 32) * P / 32;
  unsigned hb = 0;
#pragma unroll
  for (int i = 0; i < 8 * S; ++i) {
    if (i < P) {
      const int c = i + rot < P ? i + rot : i + rot - P;
      if (t.priority[r * P + c] > sp) hb |= 1u << c;
    }
  }
  const unsigned v = tally_verdict(
      tile_row_bits<S>(t.grants, r, P), tile_row_bits<S>(t.rejects, r, P),
      tile_row_bits<S>(t.cur, r, P), tile_row_bits<S>(t.old, r, P), hb);
#pragma unroll
  for (int k = 0; k < 4; ++k) out[(size_t)k * G + r0 + r] = (v >> k) & 1u;
}

// R gathered rows: masks uint16 [4, R] (grants, rejects, cur, old; bit p
// is peer p), priority int32 [R, P], self_priority int32 [R]
__global__ void tally_rows(const uint16_t* __restrict__ masks,
                           const int32_t* __restrict__ priority,
                           const int32_t* __restrict__ self_priority,
                           uint8_t* __restrict__ out, int R, int P) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int32_t* pr = priority + (size_t)r * P;
  const int32_t sp = self_priority[r];
  unsigned higher = 0;
#pragma unroll
  for (int i = 0; i < MAXP; ++i)
    if (i < P && pr[i] > sp) higher |= 1u << i;
  const unsigned v = tally_verdict(masks[r], masks[R + r], masks[2 * R + r],
                                   masks[3 * R + r], higher);
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k * R + r] = (v >> k) & 1u;
}

int launch_rows(const uint16_t* masks, const int32_t* priority,
                const int32_t* self_priority, uint8_t* out, int R, int P,
                cudaStream_t s) {
  if (R > 0)
    tally_rows<<<(R + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        masks, priority, self_priority, out, R, P);
  return (int)cudaGetLastError();
}

struct TallyPlan {
  const uint8_t* host_in;  // pinned
  uint8_t* dev_in;
  uint8_t* dev_out;        // bool [4, R] for the largest R
  uint8_t* host_out;       // pinned
  int P, device;
};

}  // namespace

extern "C" {

const char* k_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// out is bool [4, G]: passed, passed_on_timeout, rejected, decided.  ONE
// launch, ``slots`` (1 or 2, slots * 8 >= P) slots a lane of a row of 8
// lanes or a tile's row limit, by ``tile``: 0 runs design (a) in
// ``blocks`` blocks (at least the rows' G * 8 / kThreads), kTileRows
// design (b) in ``blocks`` blocks (at least G / kTileRows).
int k3_tally_votes(const uint8_t* grants, const uint8_t* rejects,
                   const uint8_t* cur, const uint8_t* old,
                   const int32_t* priority, const int32_t* self_priority,
                   uint8_t* out, int G, int P, int slots, int tile,
                   int blocks, void* stream) {
  int need = lane_row_blocks(G, P, slots);
  if (tile == kTileRows && need >= 0)
    need = (G + kTileRows - 1) / kTileRows;
  else if (tile != 0)
    need = -1;
  if (need < 0 || blocks < need) return (int)cudaErrorInvalidValue;
  if (G == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (tile && slots == 1)
    tally_tile<1><<<blocks, kTileRows, 0, s>>>(
        grants, rejects, cur, old, priority, self_priority, out, G, P);
  else if (tile)
    tally_tile<2><<<blocks, kTileRows, 0, s>>>(
        grants, rejects, cur, old, priority, self_priority, out, G, P);
  else if (slots == 1)
    tally_lanes<1><<<blocks, kThreads, 0, s>>>(
        grants, rejects, cur, old, priority, self_priority, out, G, P);
  else
    tally_lanes<2><<<blocks, kThreads, 0, s>>>(
        grants, rejects, cur, old, priority, self_priority, out, G, P);
  return (int)cudaGetLastError();
}

// K3's row entry on R gathered rows: masks uint16 [4, R], priority int32
// [R, P], self_priority int32 [R]; out is bool [4, R]
int k3_tally_rows(const uint16_t* masks, const int32_t* priority,
                  const int32_t* self_priority, uint8_t* out, int R, int P,
                  void* stream) {
  return launch_rows(masks, priority, self_priority, out, R, P,
                     (cudaStream_t)stream);
}

void* k3_plan_new(const uint8_t* host_in, uint8_t* dev_in, uint8_t* dev_out,
                  uint8_t* host_out, int P, int device) {
  return new TallyPlan{host_in, dev_in, dev_out, host_out, P, device};
}

void k3_plan_free(void* plan) { delete (TallyPlan*)plan; }

// One vote pass through a plan: R packed rows to the card, the tally,
// bool [4, R] back to the pinned host buffer, the stream synchronised.
// The host owns the packed layout: ``offsets`` holds the byte offsets in
// it of the mask words [4, R], priority [R, P] and self_priority [R], in
// that order, then the bytes to copy; the int32 sections 4-byte aligned,
// the mask words 2-byte aligned.
int k3_tick(void* plan, int R, const long long* offsets, void* stream) {
  const TallyPlan& k = *(const TallyPlan*)plan;
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != k.device) err = cudaSetDevice(k.device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const long long* o = offsets;
  err = cudaMemcpyAsync(k.dev_in, k.host_in, (size_t)o[3],
                        cudaMemcpyHostToDevice, s);
  if (err == cudaSuccess) {
    const uint8_t* b = k.dev_in;
    err = (cudaError_t)launch_rows(
        (const uint16_t*)(b + o[0]), (const int32_t*)(b + o[1]),
        (const int32_t*)(b + o[2]), k.dev_out, R, k.P, s);
  }
  if (err == cudaSuccess)
    err = cudaMemcpyAsync(k.host_out, k.dev_out, (size_t)4 * R,
                          cudaMemcpyDeviceToHost, s);
  if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  if (prev != k.device) cudaSetDevice(prev);
  return (int)err;
}

}  // extern "C"

// K3: the batched vote tally.
//
// Replaces ratis_tpu/ops/quorum.py:tally_votes (jitted by XLA): one pass
// over every group's open election round — grant majority in the current
// conf (and the old one when joint), reject majority ceil(k/2), the
// priority veto, and the strict pass that waits on every higher-priority
// member.
//
// Bound on the card: the public tally at G = 1024, P = 8 reads ~45 KB
// (four bool and one int32 [G, P] arrays) and writes 4 KB, ~0.015 us at
// 3.35 TB/s; the row entry reads 8 + 4P + 4 bytes a row and writes 4
// (~44 KB at R = 1024, ~3 KB at the engine's usual 64-row bucket), with
// a few dozen integer operations per row.  Launch latency bounds both,
// and around the launch the host's work: the engine used to upload all G
// rows of six host arrays on every vote pass, though only the rows of
// open rounds are read.
//
// Design: one thread per row, the row's masks folded into 32-bit words so
// every count is one __popc (``tally_row``).  Two kernels share it:
// - ``tally`` (``k3_tally_votes``): the public [G, P] function, bool
//   masks in; no path of the server launches it any more;
// - ``tally_rows``, the one the engine runs: R gathered rows, each row's
//   four masks as bit words (one uint16 per mask, P <= 16) and its int32
//   priority row, so the veto compare stays on the card.  The engine's
//   vote pass reaches it through a prepared call (``k3_plan_new`` once,
//   ``k3_tick`` per pass) over only the rows of open rounds, packed by
//   the host into one pinned buffer (the layout is the host's: each pass
//   passes its sections' byte offsets): one C call copies the rows to
//   the card, launches ``tally_rows``, copies bool [4, R] back and
//   synchronises.  ``k3_tally_rows`` launches it on separate tensors.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAXP 16

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned row_bits(const uint8_t* m, int P) {
  unsigned bits = 0;
#pragma unroll
  for (int i = 0; i < MAXP; ++i)
    if (i < P && m[i]) bits |= 1u << i;
  return bits;
}

__device__ __forceinline__ bool has_majority(unsigned grants, unsigned mask) {
  return __popc(grants & mask) >= __popc(mask) / 2 + 1;
}

__device__ __forceinline__ bool majority_rejected(unsigned rejects,
                                                  unsigned mask) {
  int k = __popc(mask);
  return k > 0 && __popc(rejects & mask) >= (k + 1) / 2;
}

// the tally of one row from its bit words; writes out[g], out[n + g],
// out[2n + g], out[3n + g] (passed, passed_on_timeout, rejected, decided)
__device__ __forceinline__ void tally_row(
    unsigned gb, unsigned rb, unsigned cb, unsigned ob,
    const int32_t* __restrict__ priority, int32_t sp, int P,
    uint8_t* __restrict__ out, int g, int n) {
  unsigned higher = 0;
#pragma unroll
  for (int i = 0; i < MAXP; ++i)
    if (i < P && priority[i] > sp) higher |= 1u << i;
  higher &= cb | ob;

  bool in_joint = ob != 0;
  bool majority = has_majority(gb, cb) && (!in_joint || has_majority(gb, ob));
  bool veto = (rb & higher) != 0;
  bool rejected = veto || majority_rejected(rb, cb) ||
                  (in_joint && majority_rejected(rb, ob));
  bool hp_all_replied = (higher & ~(gb | rb)) == 0;
  bool passed = majority && hp_all_replied && !rejected;
  out[g] = passed;
  out[n + g] = majority && !rejected;
  out[2 * n + g] = rejected;
  out[3 * n + g] = passed || rejected;
}

__global__ void tally(const uint8_t* __restrict__ grants,
                      const uint8_t* __restrict__ rejects,
                      const uint8_t* __restrict__ cur,
                      const uint8_t* __restrict__ old,
                      const int32_t* __restrict__ priority,
                      const int32_t* __restrict__ self_priority,
                      uint8_t* __restrict__ out, int G, int P) {
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const size_t base = (size_t)g * P;
  tally_row(row_bits(grants + base, P), row_bits(rejects + base, P),
            row_bits(cur + base, P), row_bits(old + base, P),
            priority + base, self_priority[g], P, out, g, G);
}

// R gathered rows: masks uint16 [4, R] (grants, rejects, cur, old; bit p
// is peer p), priority int32 [R, P], self_priority int32 [R]
__global__ void tally_rows(const uint16_t* __restrict__ masks,
                           const int32_t* __restrict__ priority,
                           const int32_t* __restrict__ self_priority,
                           uint8_t* __restrict__ out, int R, int P) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  tally_row(masks[r], masks[R + r], masks[2 * R + r], masks[3 * R + r],
            priority + (size_t)r * P, self_priority[r], P, out, r, R);
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

// out is bool [4, G]: passed, passed_on_timeout, rejected, decided
int k3_tally_votes(const uint8_t* grants, const uint8_t* rejects,
                   const uint8_t* cur, const uint8_t* old,
                   const int32_t* priority, const int32_t* self_priority,
                   uint8_t* out, int G, int P, void* stream) {
  if (G > 0)
    tally<<<(G + kThreads - 1) / kThreads, kThreads, 0,
            (cudaStream_t)stream>>>(grants, rejects, cur, old, priority,
                                    self_priority, out, G, P);
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

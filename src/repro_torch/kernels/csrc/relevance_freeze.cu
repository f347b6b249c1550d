// Fused ASR-KF-EGR freeze-state update (Algorithm 1 lines 3-15), for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/relevance_freeze.py::relevance_freeze_update, extended to
// per-lane clocks and thresholds: pos, step and tau arrive as (B,) device
// arrays (the Pallas kernel takes scalar [pos, step] and a compile-time
// tau), so the continuous engines' per-lane clocks and the quantile
// threshold run through it; window, k_soft and history stay launch
// arguments.  One elementwise pass over the (B, S) state: flag written,
// out-of-window, unfrozen slots with relevance < tau; increment c; set
// d = floor(sqrt(c) / k_soft) and freeze when d > 0; decrement only the
// timers frozen in earlier steps and restore at d <= 0; decay c by one on
// every history-th step; emit the active mask.
//
// Exactness: the integer and bool outputs must equal the plain PyTorch
// version bit for bit.  The file is built without --use_fast_math, so
// sqrtf and the division keep nvcc's IEEE defaults (-prec-sqrt=true,
// -prec-div=true): no rsqrtf, no reciprocal multiply.  relevance < tau is
// compared in f32 and step % history is a floor modulo, as in Python.
//
// What bounds it on this card: HBM bytes (5 words in and 5 out a slot, a
// few integer operations), and at the serving shape (B=4, S=2048 a layer)
// launch latency more than either.  Design: one thread a slot, a
// grid-stride loop, coalesced loads; nothing is shared between threads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
relevance_freeze_kernel(const int* __restrict__ c, const int* __restrict__ d,
                        const uint8_t* __restrict__ frozen,
                        const int* __restrict__ frozen_at,
                        const float* __restrict__ rel,
                        const int* __restrict__ pos,
                        const int* __restrict__ step,
                        const float* __restrict__ tau, int* __restrict__ c_o,
                        int* __restrict__ d_o, uint8_t* __restrict__ fro_o,
                        int* __restrict__ fat_o, uint8_t* __restrict__ act_o,
                        int B, int S, int window, float k_soft, int history) {
  const long long n = (long long)B * S;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int b = (int)(i / S), s = (int)(i - (long long)b * S);
    const int p = pos[b], st = step[b];
    const bool exists = s <= p;
    const bool in_window = s > p - window;
    const bool was_frozen = frozen[i] != 0;
    // lines 3-9: flag low-importance slots outside the window
    const bool eligible = exists && !in_window && !was_frozen;
    const bool flagged = eligible && (rel[i] < tau[b]);
    int c_new = c[i] + (flagged ? 1 : 0);
    const int d_sched = (int)floorf(sqrtf((float)c_new) / k_soft);
    const bool just_frozen = flagged && d_sched > 0;
    const int d_mid = just_frozen ? d_sched : d[i];
    // lines 10-14: decrement + restore, previously frozen slots only
    const int d_dec = was_frozen ? d_mid - 1 : d_mid;
    const bool restored = was_frozen && d_dec <= 0;
    const bool frozen_new = (was_frozen || just_frozen) && !restored;
    // history window: periodic decay of the detection counter
    int r = st % history;
    if (r < 0) r += history;
    if (r == history - 1) c_new = c_new - 1 > 0 ? c_new - 1 : 0;
    c_o[i] = c_new;
    d_o[i] = restored ? 0 : d_dec;
    fro_o[i] = frozen_new ? 1 : 0;
    fat_o[i] = just_frozen ? st : frozen_at[i];
    act_o[i] = (exists && !frozen_new) ? 1 : 0;
  }
}

}  // namespace

// Launches the kernel on `stream`; returns cudaGetLastError().  Pointers:
// c, d, frozen_at (B,S) int32; frozen (B,S) bytes; rel (B,S) f32; pos,
// step (B,) int32; tau (B,) f32; the outputs c_o, d_o, fat_o (B,S) int32
// and fro_o, act_o (B,S) bytes (0 or 1).  All contiguous; history > 0.
extern "C" int relevance_freeze_launch(
    const void* c, const void* d, const void* frozen, const void* frozen_at,
    const void* rel, const void* pos, const void* step, const void* tau,
    void* c_o, void* d_o, void* fro_o, void* fat_o, void* act_o, int B,
    int S, int window, float k_soft, int history, void* stream) {
  const long long n = (long long)B * S;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;
  if (blocks < 1) blocks = 1;
  relevance_freeze_kernel<<<(unsigned)blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(c), static_cast<const int*>(d),
      static_cast<const uint8_t*>(frozen), static_cast<const int*>(frozen_at),
      static_cast<const float*>(rel), static_cast<const int*>(pos),
      static_cast<const int*>(step), static_cast<const float*>(tau),
      static_cast<int*>(c_o), static_cast<int*>(d_o),
      static_cast<uint8_t*>(fro_o), static_cast<int*>(fat_o),
      static_cast<uint8_t*>(act_o), B, S, window, k_soft, history);
  return static_cast<int>(cudaGetLastError());
}

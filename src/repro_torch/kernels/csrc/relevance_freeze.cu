// Fused ASR-KF-EGR freeze-state update with its per-lane quantile threshold
// (Algorithm 1 lines 3-15), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/relevance_freeze.py::relevance_freeze_update and fuses
// repro.core.freeze.effective_tau into it: the threshold tau of each lane,
// the cfg.quantile quantile (jnp.nanquantile, linear) of its eligible
// relevance, is found here, so one launch does what took a segmented sort
// and some forty small PyTorch ops a layer.  Beyond the Pallas kernel it
// takes per-lane (B,) pos/step clocks.  Three threshold modes: quantile
// (phase A below), fixed (cfg.tau), or a caller-given (B,) tau (the Pallas
// kernel's function; phase A skipped).
//
// One block per lane, three phases:
//   A. load and select.  Each eligible slot (written, outside the window,
//      not frozen) whose relevance is not NaN becomes an order-preserving
//      uint32 key (sign set: flip all bits; else set the sign bit).  A
//      radix select of 8 bits a pass, 4 passes, finds the order statistics
//      at ranks low and high together: each pass builds a 256-bin
//      histogram in shared memory (atomicAdd), two once the two selects'
//      prefixes differ; one warp a select scans it and publishes the
//      prefix.  Keys stay in shared memory up to kSmemKeys slots; a longer
//      row is read again from global memory (L2) on every pass.
//   B. tau.  Every thread repeats the plain version's f32 arithmetic
//      (core/freeze.py::effective_tau) with _rn intrinsics, so nvcc's FMA
//      contraction cannot round once where the plain version rounds twice;
//      the blend takes hi * w_hi exactly in double, as XLA fuses it.  A lane
//      with no eligible number gets -inf, and a NaN blend -inf, as there.
//   C. the update.  Flag eligible slots with relevance < tau, increment c,
//      d = floor(sqrt(c) / k_soft), freeze when d > 0, decrement only the
//      timers frozen in earlier steps and restore at d <= 0, decay c every
//      history-th step; write the state, the optional active mask, and add
//      the lane's active count to an optional (B,) accumulator.
//
// In place: the outputs may be the inputs themselves (out == in).  That is
// safe because one block owns a lane's whole row, a slot is read and
// written by one thread only (the same slot-to-thread map in every phase;
// threads share only keys, histograms and counts in shared memory), and a
// slot's writes depend only on its own old values, read before they are
// written.  No pointer is __restrict__.  Splitting a lane over several
// blocks, or remapping slots between phases, would break this.
//
// Exactness: state and masks must equal the plain version bit for bit.
// The file is built without --use_fast_math, so sqrtf and / keep nvcc's
// IEEE defaults; relevance < tau is compared in f32 and step % history is
// a floor modulo, as in Python.  The radix order puts -0.0 before +0.0
// where torch.sort ties them, so a zero tau may differ in its sign only,
// which decides every comparison the same way.
//
// What bounds it on this card: at the serving shape (B=4, S=2048 a layer)
// launch latency, the select's four serial passes (each a pass over the
// keys, a barrier, a warp scan and a barrier) and the update's per-slot
// arithmetic on the B SMs that run it, not its 30 bytes a slot.  What the
// design does about it: one launch a layer and no host-side op; a block
// per lane turns the threshold's dependence on the whole row into
// barriers, not a second launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemKeys = 4096;           // 16 KB of keys a block
constexpr int kBatch = 4;                 // phase C slots in flight a thread
constexpr uint32_t kNoKey = 0xFFFFFFFFu;  // not eligible, or NaN

struct Args {
  const int* c;
  const int* d;
  const uint8_t* frozen;
  const int* frozen_at;
  const float* rel;
  const int* pos;
  const int* step;
  const float* tau_in;   // (B,) or null
  int* c_o;
  int* d_o;
  uint8_t* fro_o;
  int* fat_o;
  uint8_t* act_o;        // (B, S) or null
  int* act_count;        // (B,) accumulator or null
  float* tau_o;          // (B,) or null
  int S;
  int window;
  float k_soft;
  int history;
  int quantile;          // nonzero: tau is the quantile (when tau_in null)
  float q;
  float tau_fixed;
};

// Order-preserving key of a float that is not NaN; the bit pattern of a
// positive NaN (0xFFFFFFFF once mapped) is never one, so it marks "no key".
__device__ __forceinline__ uint32_t order_key(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

__device__ __forceinline__ uint32_t slot_key(const Args& a, long long row,
                                             int s, int p) {
  const bool eligible =
      s <= p && !(s > p - a.window) && a.frozen[row + s] == 0;
  const float r = a.rel[row + s];
  return (eligible && !isnan(r)) ? order_key(r) : kNoKey;
}

// The block's total of v, in every thread.
__device__ __forceinline__ int block_total(int v, int* warp_part) {
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = v;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  return __reduce_add_sync(0xffffffffu, lane < kWarps ? warp_part[lane] : 0);
}

// Rank k's digit in a 256-bin histogram, and k's rank inside that bin,
// found by one warp (8 consecutive bins a lane, two 16-byte loads); the
// lane that owns k's bin returns true.  It also clears `next`, the same
// bins of the other buffer, for the next pass.
__device__ __forceinline__ bool find_digit(const unsigned* bins,
                                           unsigned* next, unsigned k,
                                           int lane, unsigned& digit,
                                           unsigned& rest) {
  const uint4 x = reinterpret_cast<const uint4*>(bins)[2 * lane];
  const uint4 y = reinterpret_cast<const uint4*>(bins)[2 * lane + 1];
  reinterpret_cast<uint4*>(next)[2 * lane] = make_uint4(0, 0, 0, 0);
  reinterpret_cast<uint4*>(next)[2 * lane + 1] = make_uint4(0, 0, 0, 0);
  const unsigned cnt[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
  unsigned sum = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) sum += cnt[i];
  unsigned incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  unsigned c = incl - sum;
  if (k < c || k >= incl) return false;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (k < c + cnt[i]) {
      digit = lane * 8 + i;
      rest = k - c;
      return true;
    }
    c += cnt[i];
  }
  return false;
}

__global__ void __launch_bounds__(kThreads)
relevance_freeze_kernel(const Args a) {
  __shared__ uint32_t keys[kSmemKeys];
  __shared__ __align__(16) unsigned hist[2][2][256];  // [buffer][select][digit]
  __shared__ int warp_n[kWarps], warp_act[kWarps];
  __shared__ uint32_t sel_key[2];                     // prefixes: low, high

  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const long long row = (long long)b * a.S;
  const int p = a.pos[b];

  // ---- phase A: load and select -------------------------------------- //
  float tau = a.tau_fixed;
  if (a.tau_in != nullptr) {
    tau = a.tau_in[b];
  } else if (a.quantile) {
    const bool in_smem = a.S <= kSmemKeys;
    for (int i = tid; i < 2 * 256; i += kThreads) (&hist[0][0][0])[i] = 0;
    if (tid < 2) sel_key[tid] = 0u;
    int n = 0;
    for (int s = tid; s < a.S; s += kThreads) {
      const uint32_t k = slot_key(a, row, s, p);
      if (in_smem) keys[s] = k;
      n += k != kNoKey;
    }
    n = block_total(n, warp_n);
    tau = -INFINITY;
    if (n > 0) {
      // effective_tau's rank arithmetic, in f32, rounding as it does (in
      // every thread: the same inputs give the same bits)
      const float top = __fsub_rn((float)n, 1.f);
      const float rank = __fmul_rn(a.q, top);
      const float low = floorf(rank), high = ceilf(rank);
      const float w_hi = __fsub_rn(rank, low);
      const float w_lo = __fsub_rn(1.f, w_hi);
      // warp j (j < 2) selects order statistic j: low, then high
      const int j = tid >> 5;
      unsigned k_rank =
          (unsigned)fmaxf(fminf(j == 0 ? low : high, top), 0.f);
      for (int pass = 0; pass < 4; ++pass) {
        const int shift = 24 - 8 * pass;
        const uint32_t fixed = pass == 0 ? 0u : 0xFFFFFFFFu << (shift + 8);
        unsigned(*h)[256] = hist[pass & 1];
        const uint32_t pre0 = sel_key[0], pre1 = sel_key[1];
        // one histogram serves both selects while their prefixes agree
        const bool shared = pre0 == pre1;
        for (int s = tid; s < a.S; s += kThreads) {
          const uint32_t k = in_smem ? keys[s] : slot_key(a, row, s, p);
          const unsigned digit = (k >> shift) & 0xFFu;
          if (k != kNoKey && ((k ^ pre0) & fixed) == 0)
            atomicAdd(&h[0][digit], 1u);
          if (!shared && k != kNoKey && ((k ^ pre1) & fixed) == 0)
            atomicAdd(&h[1][digit], 1u);
        }
        __syncthreads();
        if (j < 2) {
          unsigned digit = 0, rest = 0;
          const bool mine = find_digit(h[shared ? 0 : j],
                                       hist[(pass + 1) & 1][j], k_rank, lane,
                                       digit, rest);
          if (mine) sel_key[j] = (j == 0 ? pre0 : pre1) | digit << shift;
          k_rank = __shfl_sync(0xffffffffu, rest,
                               __ffs(__ballot_sync(0xffffffffu, mine)) - 1);
        }
        __syncthreads();
      }
      // ---- phase B: tau, in the plain version's arithmetic ------------- //
      const float lo = key_value(sel_key[0]), hi = key_value(sel_key[1]);
      const float lo_part = __fmul_rn(lo, w_lo);
      const float t = __double2float_rn(__dadd_rn(
          __dmul_rn((double)hi, (double)w_hi), (double)lo_part));
      tau = isnan(t) ? -INFINITY : t;
    }
  }
  if (a.tau_o != nullptr && tid == 0) a.tau_o[b] = tau;

  // ---- phase C: the Algorithm-1 update ---------------------------------- //
  const int st = a.step[b];
  int r = st % a.history;
  if (r < 0) r += a.history;
  const bool decay = r == a.history - 1;
  int n_active = 0;
  for (int s0 = tid; s0 < a.S; s0 += kBatch * kThreads) {
    // every load of the batch before any store: slots are distinct, so
    // this is the per-slot order whatever the outputs alias
    int cv[kBatch], dv[kBatch], fav[kBatch];
    bool fz[kBatch];
    float rv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int s = s0 + u * kThreads;
      if (s < a.S) {
        const long long i = row + s;
        cv[u] = a.c[i];
        dv[u] = a.d[i];
        fz[u] = a.frozen[i] != 0;
        fav[u] = a.frozen_at[i];
        rv[u] = a.rel[i];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int s = s0 + u * kThreads;
      if (s >= a.S) break;
      const long long i = row + s;
      const bool exists = s <= p;
      const bool in_window = s > p - a.window;
      const bool was_frozen = fz[u];
      // lines 3-9: flag low-importance slots outside the window
      const bool flagged = exists && !in_window && !was_frozen && rv[u] < tau;
      int c_new = cv[u] + (flagged ? 1 : 0);
      const int d_sched = (int)floorf(sqrtf((float)c_new) / a.k_soft);
      const bool just_frozen = flagged && d_sched > 0;
      const int d_mid = just_frozen ? d_sched : dv[u];
      // lines 10-14: decrement + restore, previously frozen slots only
      const int d_dec = was_frozen ? d_mid - 1 : d_mid;
      const bool restored = was_frozen && d_dec <= 0;
      const bool frozen_new = (was_frozen || just_frozen) && !restored;
      // history window: periodic decay of the detection counter
      if (decay) c_new = c_new - 1 > 0 ? c_new - 1 : 0;
      const bool active = exists && !frozen_new;
      a.c_o[i] = c_new;
      a.d_o[i] = restored ? 0 : d_dec;
      a.fro_o[i] = frozen_new ? 1 : 0;
      a.fat_o[i] = just_frozen ? st : fav[u];
      if (a.act_o != nullptr) a.act_o[i] = active ? 1 : 0;
      n_active += active ? 1 : 0;
    }
  }
  if (a.act_count != nullptr) {
    // one block per lane: a single writer of act_count[b], no atomics
    n_active = block_total(n_active, warp_act);
    if (tid == 0) a.act_count[b] += n_active;
  }
}

__global__ void __launch_bounds__(kThreads) empty_kernel() {}

}  // namespace

// Launches the kernel on `stream` (one block per lane); returns
// cudaGetLastError().  Pointers: c, d, frozen_at (B,S) int32; frozen (B,S)
// bytes; rel (B,S) f32; pos, step (B,) int32; tau_in (B,) f32 or null; the
// outputs c_o, d_o, fat_o (B,S) int32 and fro_o (B,S) bytes, each either
// its input or disjoint from every input; act_o (B,S) bytes or null;
// act_count (B,) int32 or null (added to); tau_o (B,) f32 or null.  All
// contiguous; B, S >= 1; history > 0.  Without tau_in, quantile != 0 takes
// tau as the q-quantile of each lane's eligible relevance, else tau_fixed.
extern "C" int relevance_freeze_launch(
    const void* c, const void* d, const void* frozen, const void* frozen_at,
    const void* rel, const void* pos, const void* step, const void* tau_in,
    void* c_o, void* d_o, void* fro_o, void* fat_o, void* act_o,
    void* act_count, void* tau_o, int B, int S, int window, float k_soft,
    int history, int quantile, float q, float tau_fixed, void* stream) {
  Args a;
  a.c = static_cast<const int*>(c);
  a.d = static_cast<const int*>(d);
  a.frozen = static_cast<const uint8_t*>(frozen);
  a.frozen_at = static_cast<const int*>(frozen_at);
  a.rel = static_cast<const float*>(rel);
  a.pos = static_cast<const int*>(pos);
  a.step = static_cast<const int*>(step);
  a.tau_in = static_cast<const float*>(tau_in);
  a.c_o = static_cast<int*>(c_o);
  a.d_o = static_cast<int*>(d_o);
  a.fro_o = static_cast<uint8_t*>(fro_o);
  a.fat_o = static_cast<int*>(fat_o);
  a.act_o = static_cast<uint8_t*>(act_o);
  a.act_count = static_cast<int*>(act_count);
  a.tau_o = static_cast<float*>(tau_o);
  a.S = S;
  a.window = window;
  a.k_soft = k_soft;
  a.history = history;
  a.quantile = quantile;
  a.q = q;
  a.tau_fixed = tau_fixed;
  relevance_freeze_kernel<<<(unsigned)B, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel on the same grid: the card's launch floor for this
// kernel's shape, for timing only.
extern "C" int relevance_freeze_floor_launch(int B, void* stream) {
  empty_kernel<<<(unsigned)B, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

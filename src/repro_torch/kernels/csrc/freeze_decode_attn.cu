// Freeze-masked flash-decode attention over a contiguous KV cache, with
// fused per-slot relevance, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/freeze_decode_attn.py::freeze_decode_attention.  It
// computes what that kernel computes: one query token per lane (q (B,H,hd))
// attends over the lane's cache k, v (B,S,KVH,hd) under active_mask (B,S),
// with an online softmax in f32.  Per-slot relevance is the paper's Eq. 2
// score, the mean over all H query heads of |q.k|; it is exactly 0 on an
// inactive slot, also inside a partly active chunk.  A chunk of slots with
// no active slot does no math and reads no K/V (frozen slots may hold
// anything).  A lane with nothing active outputs zeros.  Any S is taken:
// the ragged last chunk is masked here (the Pallas kernel asserts
// S % block_s == 0).
//
// What bounds it on this card: HBM bytes.  Each active chunk's K and V rows
// are read once (bytes ~ active slots * KVH * hd * 2 * sizeof(T), plus q,
// the mask, out and relevance); the arithmetic is ~4 flops per K/V element,
// far below the H100's ridge point.
//
// Design (the paged kernel's shape, with the walk split across blocks): a
// block (lane b, kv head kh, split z) holds that head's G = H / KVH query
// rows in registers (G is a template parameter) and walks its share of the
// chunks of kChunk slots with a running (m, l, acc) in f32; the TPU grid's
// sequential S axis becomes this loop.  The caller picks the number of
// splits (kernels/freeze_decode_attn.py: about 512 blocks in all, one chunk
// a block at the serving shape, 4 x 8 x 16), since B * KVH blocks alone
// (32) leave most of the card's 132 SMs idle; a split past the last chunk
// finds nothing active.  A chunk's mask is read first and the chunk
// is skipped when no slot is active.  Each warp keeps kTokPerWarp K rows in
// flight; its lane 0 holds the G dot products of a slot and writes their
// |.| sum, in g order, as the (b, kh, s) relevance partial to a
// (B, KVH, S) scratch.  V is staged through shared memory a chunk of rows
// at a time.  Each block writes its unnormalised (m, l, acc) to a
// (B, H, splits) scratch; a merge kernel combines the splits in index
// order, and a third sums the relevance partials over kv heads in index
// order and divides by H: no atomics, so the output and the freeze
// decisions fed by the relevance do not change from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHd = 128;        // head_dim: a power of two up to this
constexpr int kChunk = 128;        // slots per step of the walk
constexpr int kHdPerLane = kMaxHd / 32;
constexpr int kTokPerWarp = kChunk / kWarps;   // K rows a warp has in flight
constexpr int kVChunk = 32;        // V rows staged in shared memory
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float x, float* o) { *o = x; }
__device__ __forceinline__ void store_f32(float x, __nv_bfloat16* o) {
  *o = __float2bfloat16(x);                               // round to nearest even
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
freeze_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const uint8_t* __restrict__ mask,
                   float* __restrict__ part_ml, float* __restrict__ part_acc,
                   float* __restrict__ relp, int S, int KVH, int hd,
                   int chunks_per_split, float scale) {
  const int b = blockIdx.x, kh = blockIdx.y, z = blockIdx.z;
  const int n_split = gridDim.z;
  const int H = G * KVH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  __shared__ float s_s[G * kChunk];          // raw scores, then probabilities
  __shared__ float v_s[kVChunk * kMaxHd];   // one chunk of V rows
  __shared__ uint8_t mask_s[kChunk];
  __shared__ float m_s[G], l_s[G], corr_s[G];

  // each lane keeps its head_dim slice of the G query rows in registers
  float q_r[G][kHdPerLane];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < kHdPerLane; ++j) {
      const int d = lane + 32 * j;
      q_r[g][j] = d < hd ? to_f32(q[((size_t)b * H + kh * G + g) * hd + d])
                         : 0.f;
    }
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  // this thread's output column d_own and rows g0, g0 + gstep, ...: hd is a
  // power of two dividing kMaxHd, so a thread owns at most kRows rows
  constexpr int kRows = (G * kMaxHd + kThreads - 1) / kThreads;
  const int hd_shift = __ffs(hd) - 1;
  const int d_own = tid & (hd - 1), g0 = tid >> hd_shift;
  const int gstep = kThreads >> hd_shift;
  float acc[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) acc[j] = 0.f;
  __syncthreads();

  const size_t tok_stride = (size_t)KVH * hd;
  const T* kb = k + (size_t)b * S * tok_stride + (size_t)kh * hd;
  const T* vb = v + (size_t)b * S * tok_stride + (size_t)kh * hd;
  float* relp_b = relp + ((size_t)b * KVH + kh) * S;
  const int s_end = min(S, (z + 1) * chunks_per_split * kChunk);
  for (int s0 = z * chunks_per_split * kChunk; s0 < s_end; s0 += kChunk) {
    const int n = min(kChunk, S - s0);
    uint8_t mk = 0;
    if (tid < kChunk) {
      mk = tid < n ? mask[(size_t)b * S + s0 + tid] : 0;
      mask_s[tid] = mk;
    }
    // a chunk with no active slot reads no K/V; its relevance is written 0
    // by the sum pass, which reads the mask first
    if (__syncthreads_count(mk != 0) == 0) continue;

    // raw scores q.k: a warp per slot, lanes across head_dim; a warp loads
    // kTokPerWarp active rows, then reduces each row's G dot products
    // together
    float kv[kTokPerWarp][kHdPerLane];
#pragma unroll
    for (int u = 0; u < kTokPerWarp; ++u) {
      const int t = warp + kWarps * u;
      const bool ok = t < n && mask_s[t];
#pragma unroll
      for (int j = 0; j < kHdPerLane; ++j) {
        const int d = lane + 32 * j;
        kv[u][j] = (ok && d < hd)
            ? to_f32(kb[(size_t)(s0 + t) * tok_stride + d]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kTokPerWarp; ++u) {
      const int t = warp + kWarps * u;
      if (t >= n || !mask_s[t]) continue;
      float part[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        part[g] = 0.f;
#pragma unroll
        for (int j = 0; j < kHdPerLane; ++j) part[g] += q_r[g][j] * kv[u][j];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int g = 0; g < G; ++g)
          part[g] += __shfl_xor_sync(0xffffffffu, part[g], o);
      if (lane == 0) {
        float r = 0.f;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          s_s[g * kChunk + t] = part[g];
          r += fabsf(part[g]);
        }
        relp_b[s0 + t] = r;
      }
    }
    __syncthreads();

    // running max and probabilities (0 on inactive slots): one warp per row
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int t = lane; t < n; t += 32)
        if (mask_s[t]) mx = fmaxf(mx, s_s[g * kChunk + t] * scale);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float lsum = 0.f;
      for (int t = lane; t < kChunk; t += 32) {
        float pr = 0.f;
        if (t < n && mask_s[t]) pr = expf(s_s[g * kChunk + t] * scale - m_new);
        s_s[g * kChunk + t] = pr;
        lsum += pr;
      }
      lsum = warp_sum(lsum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + lsum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // rescale, then accumulate P.V for this thread's rows at column d_own
    // over chunks of kVChunk slots: the block loads a chunk's V rows into
    // shared memory in one coalesced wave (0 on inactive slots), then each
    // thread reads its column from there
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      if (g0 + gstep * j < G) acc[j] *= corr_s[g0 + gstep * j];
    for (int tc = 0; tc < n; tc += kVChunk) {
#pragma unroll 8
      for (int e = tid; e < kVChunk * hd; e += kThreads) {
        const int t = tc + (e >> hd_shift), d = e & (hd - 1);
        v_s[e] = (t < n && mask_s[t])
            ? to_f32(vb[(size_t)(s0 + t) * tok_stride + d]) : 0.f;
      }
      __syncthreads();
      const int tn = min(kVChunk, n - tc);
      for (int u = 0; u < tn; ++u) {
        const float vu = v_s[u * hd + d_own];
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const int g = g0 + gstep * j;
          if (g < G) acc[j] += s_s[g * kChunk + tc + u] * vu;
        }
      }
      __syncthreads();
    }
  }

  // this split's unnormalised partials; l = 0 marks a split with nothing
  // active, whose acc the merge never reads
  if (tid < G) {
    float* ml = part_ml + (((size_t)b * H + kh * G + tid) * n_split + z) * 2;
    ml[0] = m_s[tid];
    ml[1] = l_s[tid];
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int g = g0 + gstep * j;
    if (g >= G) continue;
    part_acc[(((size_t)b * H + kh * G + g) * n_split + z) * hd + d_own] =
        acc[j];
  }
}

// out[b, h] = sum_z e^(m_z - M) acc_z / sum_z e^(m_z - M) l_z over the
// splits z with l_z > 0, in index order; zeros when no split had an active
// slot.  A block per (b, h), a thread per output column.
template <typename T>
__global__ void merge_splits_kernel(const float* __restrict__ part_ml,
                                    const float* __restrict__ part_acc,
                                    T* __restrict__ out, int n_split,
                                    int hd) {
  const int bh = blockIdx.x, d = threadIdx.x;
  const float* ml = part_ml + (size_t)bh * n_split * 2;
  float m = kNegInf;
  for (int z = 0; z < n_split; ++z)
    if (ml[2 * z + 1] > 0.f) m = fmaxf(m, ml[2 * z]);
  float l = 0.f, acc = 0.f;
  for (int z = 0; z < n_split; ++z) {
    const float lz = ml[2 * z + 1];
    if (lz > 0.f) {
      const float w = expf(ml[2 * z] - m);
      l += w * lz;
      acc += w * part_acc[((size_t)bh * n_split + z) * hd + d];
    }
  }
  store_f32(l > 0.f ? acc / fmaxf(l, 1e-30f) : 0.f, &out[(size_t)bh * hd + d]);
}

// rel[b, s] = active ? sum_kh relp[b, kh, s] / H : 0, kv heads summed in
// index order (deterministic); the partials of inactive slots are never read
__global__ void slot_relevance_kernel(const float* __restrict__ relp,
                                      const uint8_t* __restrict__ mask,
                                      float* __restrict__ rel, int B, int S,
                                      int H, int KVH) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * S) return;
  if (!mask[i]) {
    rel[i] = 0.f;
    return;
  }
  const int b = i / S, s = i - b * S;
  float r = 0.f;
  for (int kh = 0; kh < KVH; ++kh) r += relp[((size_t)b * KVH + kh) * S + s];
  rel[i] = r / (float)H;
}

template <typename T>
cudaError_t launch_attn(int G, dim3 grid, cudaStream_t s, const void* q,
                        const void* k, const void* v, const uint8_t* mask,
                        void* out, float* ml, float* acc, float* rp, int S,
                        int KVH, int hd, int chunks_per_split, float scale) {
#define FREEZE_ATTN_CASE(NG)                                                 \
  case NG:                                                                   \
    freeze_attn_kernel<T, NG><<<grid, kThreads, 0, s>>>(                     \
        static_cast<const T*>(q), static_cast<const T*>(k),                  \
        static_cast<const T*>(v), mask, ml, acc, rp, S, KVH, hd,             \
        chunks_per_split, scale);                                            \
    break;
  switch (G) {
    FREEZE_ATTN_CASE(1)
    FREEZE_ATTN_CASE(2)
    FREEZE_ATTN_CASE(4)
    default:
      return cudaErrorInvalidValue;
  }
#undef FREEZE_ATTN_CASE
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_splits_kernel<T><<<grid.x * grid.y * G, hd, 0, s>>>(
      ml, acc, static_cast<T*>(out), grid.z, hd);
  return cudaGetLastError();
}

}  // namespace

// Launches the three kernels on `stream`; returns the first launch error,
// else cudaGetLastError().  Pointers: q (B,H,hd), k/v (B,S,KVH,hd) of type
// T (is_bf16 ? bf16 : f32); active_mask (B,S) as bytes; out (B,H,hd) T;
// rel (B,S) f32; scratch: part_ml (B,H,n_split,2) f32, part_acc
// (B,H,n_split,hd) f32 and relp (B,KVH,S) f32.  All contiguous; n_split
// >= 1, H / KVH 1, 2 or 4 and hd a power of two up to 128.
extern "C" int freeze_decode_attention_launch(
    const void* q, const void* k, const void* v, const void* active_mask,
    void* out, void* rel, void* part_ml, void* part_acc, void* relp, int B,
    int S, int H, int KVH, int hd, int n_split, int is_bf16, float scale,
    void* stream) {
  if (n_split < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = (S + kChunk - 1) / kChunk;
  const int per = (n_chunks + n_split - 1) / n_split;
  const dim3 grid(B, KVH, n_split);
  const auto* mask = static_cast<const uint8_t*>(active_mask);
  auto* ml = static_cast<float*>(part_ml);
  auto* acc = static_cast<float*>(part_acc);
  auto* rp = static_cast<float*>(relp);
  const int G = H / KVH;
  const cudaError_t err =
      is_bf16 ? launch_attn<__nv_bfloat16>(G, grid, s, q, k, v, mask, out,
                                           ml, acc, rp, S, KVH, hd, per,
                                           scale)
              : launch_attn<float>(G, grid, s, q, k, v, mask, out, ml, acc,
                                   rp, S, KVH, hd, per, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = B * S;
  slot_relevance_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      rp, mask, static_cast<float*>(rel), B, S, H, KVH);
  return static_cast<int>(cudaGetLastError());
}

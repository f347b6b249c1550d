// Paged flash-decode attention with fused page relevance, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/paged_decode_attn.py::paged_decode_attention_kernel.
// It computes what that kernel computes: one query token per lane attends
// over the lane's bounded page pool with an online softmax in f32.  A page
// is skipped (no K/V read, relevance 0) when it is unmapped
// (page_table < 0), invisible (page_visible == 0, frozen and not thawed)
// or has an empty slot mask.  Flagged pages (page_quant != 0) are
// dequantized per kv head (K * kv_scales[b,p,0,kh], V * kv_scales[b,p,1,kh]);
// unflagged pages multiply by exactly 1.0, so kv_quant="none" is
// bit-identical to no quant.  Page relevance is the mean over the page's
// valid slots of the mean over all H heads of |q.k|.  A lane with no live
// page outputs zeros.
//
// What bounds it on this card: HBM bytes.  Each live page's K and V are
// read once (bytes = live pages * page * KVH * hd * 2 * sizeof(T), plus q,
// the tables, out and relevance); the arithmetic is ~4 flops per K/V
// element, far below the H100's ridge point.
//
// Design (simple first): one block per (lane b, kv head kh) holds that
// head's G = H / KVH query rows (G is a template parameter, so the per-row
// loops unroll exactly), reads the lane's page_table / page_visible /
// page_quant itself and walks the P pages in a loop with a running
// (m, l, acc) in f32, checking liveness before it touches a page's K/V.
// Each warp keeps several K rows in flight before reducing them, and V is
// staged through shared memory a chunk of rows at a time.  Per-(b, kh, p) partial relevance goes to a
// (B, KVH, P) f32 scratch; a second small kernel sums over kv heads in a
// fixed order and divides by H * n_act.  No atomics, so the freeze
// decisions fed by the relevance do not change from run to run.  Only
// B * KVH blocks of 16 warps run (32 at the serving shape), so the walk is
// latency-bound; the fast design is later work: flash-decoding that splits
// the page walk across blocks plus a merge, with cp.async / TMA staging of
// pages into shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHd = 128;        // head_dim: a power of two up to this
constexpr int kMaxPage = 256;
constexpr int kHdPerLane = kMaxHd / 32;
constexpr int kTokPerWarp = 8;     // K rows a warp has in flight at once
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
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v,
                  const uint8_t* __restrict__ slot_mask,
                  const int* __restrict__ page_table,
                  const uint8_t* __restrict__ page_visible,
                  const int* __restrict__ page_quant,
                  const float* __restrict__ kv_scales,
                  T* __restrict__ out, float* __restrict__ relp,
                  int P, int page, int KVH, int hd, float scale) {
  const int b = blockIdx.x, kh = blockIdx.y;
  const int H = G * KVH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  __shared__ float s_s[G * kMaxPage];        // raw scores, then probabilities
  __shared__ float v_s[kVChunk * kMaxHd];   // one chunk of V rows
  __shared__ uint8_t mask_s[kMaxPage];
  __shared__ float m_s[G], l_s[G], corr_s[G], rel_s[G];

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
  // power of two dividing kMaxHd, so gstep >= kThreads / kMaxHd and a
  // thread owns at most kRows rows
  constexpr int kRows = (G * kMaxHd + kThreads - 1) / kThreads;
  const int hd_shift = __ffs(hd) - 1;
  const int d_own = tid & (hd - 1), g0 = tid >> hd_shift;
  const int gstep = kThreads >> hd_shift;
  float acc[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) acc[j] = 0.f;
  __syncthreads();

  const size_t tok_stride = (size_t)KVH * hd;
  for (int p = 0; p < P; ++p) {
    const int bp = b * P + p;
    float* relp_out = relp + ((size_t)b * KVH + kh) * P + p;
    // liveness from the tables alone: a skipped page's K/V, mask bits and
    // scales are never read
    if (page_table[bp] < 0 || page_visible[bp] == 0) {
      if (tid == 0) *relp_out = 0.f;
      continue;
    }
    int n_act = 0;
    for (int t0 = 0; t0 < page; t0 += kThreads) {
      const int t = t0 + tid;
      const uint8_t mk = (t < page) ? slot_mask[(size_t)bp * page + t] : 0;
      if (t < page) mask_s[t] = mk;
      n_act += __syncthreads_count(mk != 0);
    }
    if (n_act == 0) {
      if (tid == 0) *relp_out = 0.f;
      continue;
    }
    const bool quant = page_quant[bp] != 0;
    const float sk = quant ? kv_scales[((size_t)bp * 2 + 0) * KVH + kh] : 1.f;
    const float sv = quant ? kv_scales[((size_t)bp * 2 + 1) * KVH + kh] : 1.f;
    const T* kp = k + (size_t)bp * page * tok_stride + (size_t)kh * hd;
    const T* vp = v + (size_t)bp * page * tok_stride + (size_t)kh * hd;

    // raw scores q.k: a warp per token, lanes across head_dim; a warp loads
    // kTokPerWarp valid rows, then reduces each row's G dot products
    // together
    for (int tb = 0; tb < page; tb += kWarps * kTokPerWarp) {
      float kv[kTokPerWarp][kHdPerLane];
#pragma unroll
      for (int u = 0; u < kTokPerWarp; ++u) {
        const int t = tb + warp + kWarps * u;
        const bool ok = t < page && mask_s[t];
#pragma unroll
        for (int j = 0; j < kHdPerLane; ++j) {
          const int d = lane + 32 * j;
          kv[u][j] = (ok && d < hd)
              ? to_f32(kp[(size_t)t * tok_stride + d]) * sk : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kTokPerWarp; ++u) {
        const int t = tb + warp + kWarps * u;
        if (t >= page || !mask_s[t]) continue;
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
#pragma unroll
          for (int g = 0; g < G; ++g) s_s[g * page + t] = part[g];
        }
      }
    }
    __syncthreads();

    // relevance partial, running max and probabilities (0 on invalid
    // slots): one warp per row
    for (int g = warp; g < G; g += kWarps) {
      float a = 0.f, mx = kNegInf;
      for (int t = lane; t < page; t += 32) {
        if (mask_s[t]) {
          const float r = s_s[g * page + t];
          a += fabsf(r);
          mx = fmaxf(mx, r * scale);
        }
      }
      a = warp_sum(a);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float lsum = 0.f;
      for (int t = lane; t < page; t += 32) {
        float pr = 0.f;
        if (mask_s[t]) pr = expf(s_s[g * page + t] * scale - m_new);
        s_s[g * page + t] = pr;
        lsum += pr;
      }
      lsum = warp_sum(lsum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + lsum;
        m_s[g] = m_new;
        rel_s[g] = a;
      }
    }
    __syncthreads();
    if (tid == 0) {
      float r = 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) r += rel_s[g];
      *relp_out = r;
    }

    // rescale, then accumulate P.V for this thread's rows at column d_own
    // over chunks of kVChunk tokens: the block loads a chunk's V rows into
    // shared memory in one coalesced wave (0 on invalid slots), then each
    // thread reads its column from there
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      if (g0 + gstep * j < G) acc[j] *= corr_s[g0 + gstep * j];
    for (int tc = 0; tc < page; tc += kVChunk) {
#pragma unroll 8
      for (int e = tid; e < kVChunk * hd; e += kThreads) {
        const int t = tc + (e >> hd_shift), d = e & (hd - 1);
        v_s[e] = (t < page && mask_s[t])
            ? to_f32(vp[(size_t)t * tok_stride + d]) * sv : 0.f;
      }
      __syncthreads();
      const int tn = min(kVChunk, page - tc);
      for (int u = 0; u < tn; ++u) {
        const float vu = v_s[u * hd + d_own];
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const int g = g0 + gstep * j;
          if (g < G) acc[j] += s_s[g * page + tc + u] * vu;
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int g = g0 + gstep * j;
    if (g >= G) continue;
    const float l = l_s[g];
    const float o = l > 0.f ? acc[j] / fmaxf(l, 1e-30f) : 0.f;
    store_f32(o, &out[((size_t)b * H + kh * G + g) * hd + d_own]);
  }
}

// rel[b, p] = sum_kh relp[b, kh, p] / H / max(n_act, 1), kv heads summed in
// index order (deterministic)
__global__ void page_relevance_kernel(const float* __restrict__ relp,
                                      const uint8_t* __restrict__ slot_mask,
                                      float* __restrict__ rel, int B, int P,
                                      int page, int H, int KVH) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * P) return;
  const int b = i / P, p = i - b * P;
  float s = 0.f;
  for (int kh = 0; kh < KVH; ++kh) s += relp[((size_t)b * KVH + kh) * P + p];
  int n = 0;
  for (int t = 0; t < page; ++t) n += slot_mask[(size_t)i * page + t] != 0;
  rel[i] = s / (float)H / (float)(n > 0 ? n : 1);
}

template <typename T>
cudaError_t launch_attn(int G, dim3 grid, cudaStream_t s, const void* q,
                        const void* k, const void* v, const uint8_t* sm,
                        const int* pt, const uint8_t* vis, const int* pq,
                        const float* sc, void* out, float* rp, int P,
                        int page, int KVH, int hd, float scale) {
#define PAGED_ATTN_CASE(NG)                                                  \
  case NG:                                                                   \
    paged_attn_kernel<T, NG><<<grid, kThreads, 0, s>>>(                      \
        static_cast<const T*>(q), static_cast<const T*>(k),                  \
        static_cast<const T*>(v), sm, pt, vis, pq, sc, static_cast<T*>(out), \
        rp, P, page, KVH, hd, scale);                                        \
    return cudaSuccess;
  switch (G) {
    PAGED_ATTN_CASE(1)
    PAGED_ATTN_CASE(2)
    PAGED_ATTN_CASE(4)
    default:
      return cudaErrorInvalidValue;
  }
#undef PAGED_ATTN_CASE
}

}  // namespace

// Launches both kernels on `stream`; returns the first launch error, else
// cudaGetLastError().  Pointers: q (B,H,hd), k/v (B,P,page,KVH,hd) of type
// T (is_bf16 ? bf16 : f32); slot_mask (B,P,page) and page_visible (B,P) as
// bytes; page_table and page_quant (B,P) int32; kv_scales (B,P,2,KVH) f32;
// out (B,H,hd) T; rel (B,P) f32; relp scratch (B,KVH,P) f32.  All
// contiguous.  H / KVH must be 1, 2 or 4 and hd a power of two up
// to 128.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k, const void* v, const void* slot_mask,
    const void* page_table, const void* page_visible, const void* page_quant,
    const void* kv_scales, void* out, void* rel, void* relp, int B, int P,
    int page, int H, int KVH, int hd, int is_bf16, float scale,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(B, KVH);
  const auto* sm = static_cast<const uint8_t*>(slot_mask);
  const auto* pt = static_cast<const int*>(page_table);
  const auto* vis = static_cast<const uint8_t*>(page_visible);
  const auto* pq = static_cast<const int*>(page_quant);
  const auto* sc = static_cast<const float*>(kv_scales);
  auto* rp = static_cast<float*>(relp);
  const int G = H / KVH;
  const cudaError_t err =
      is_bf16 ? launch_attn<__nv_bfloat16>(G, grid, s, q, k, v, sm, pt, vis,
                                           pq, sc, out, rp, P, page, KVH, hd,
                                           scale)
              : launch_attn<float>(G, grid, s, q, k, v, sm, pt, vis, pq, sc,
                                   out, rp, P, page, KVH, hd, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = B * P;
  page_relevance_kernel<<<(n + 127) / 128, 128, 0, s>>>(
      rp, sm, static_cast<float*>(rel), B, P, page, H, KVH);
  return static_cast<int>(cudaGetLastError());
}

// Paged flash-decode attention with fused page relevance, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/paged_decode_attn.py::paged_decode_attention_kernel.
// It computes what that kernel computes: one query token per lane attends
// over the lane's bounded page pool with an online softmax in f32.  A page
// is skipped (no K/V read, relevance 0) when it is unmapped
// (page_table < 0), invisible (page_visible == 0, frozen and not thawed)
// or has an empty slot mask; liveness is decided from the tables before
// any mask bit, scale or K/V of the page is read, and the mask before any
// scale or K/V.  Flagged pages (page_quant != 0) are dequantized per kv
// head (K * kv_scales[b,p,0,kh], V * kv_scales[b,p,1,kh]); unflagged pages
// multiply by exactly 1.0, so kv_quant="none" is bit-identical to no
// quant.  Page relevance is the mean over the page's valid slots of the
// mean over all H heads of |q.k|.  A lane with no live page outputs zeros.
//
// What bounds it on this card: HBM bytes.  Each live page's K and V rows
// of valid slots are read once (bytes = valid slots * KVH * hd * 2 *
// sizeof(T), plus q, the tables, out and relevance; 6.1 MB and 0.0018 ms
// at the main path's B=4, P=8, page 64, H=32, KVH=8, hd=128, bf16); the
// arithmetic is ~4 flops per K/V element, far below the H100's ridge
// point, so the only lever is having the bytes in flight.
//
// Design (flash-decoding, two launches a call).  The first version had one
// block per (lane, kv head) walk the pages in a loop, a chain of ~40
// dependent HBM round trips; this one puts every byte in flight at once:
//  1. paged_attn_kernel: the grid is the independent work, one block of
//     128 threads per (page group z, kv head kh, lane b), a page group
//     being pages_per_block consecutive pages (one at the main path: 256
//     blocks, all resident in one wave).  A block reads its page's tables,
//     then its mask, then issues every K and V row chunk of the page's
//     valid slots as 16-byte cp.async copies into shared memory (zero-fill
//     for masked rows, so nothing of them is read) and waits once: three
//     dependent round trips in all.  Thread (r, c) owns chunk c of rows r,
//     r + rpp, ...; the G = H / KVH query rows' chunks sit in registers.
//     Each thread's share of q.k goes to shared memory and one thread a
//     row adds the row's shares; one warp per query row runs the softmax
//     and the relevance sum (lane-strided over slots, then a butterfly,
//     then over g in order: the in-page order of the first version); every
//     thread accumulates P.V for its rows and chunk, and the rows' sums go
//     through shared memory too, in index order.  The block writes its
//     unnormalised (m, l, acc) per query row and its per-(b, kh, p)
//     relevance partial to scratch.  Shuffle butterflies per row were the
//     slow part of the first cut; shared-memory sums replaced them.
//  2. paged_combine_kernel, launched as a programmatic dependent of the
//     first (sm_90, CUDA 12.3 or later), so its launch overlaps the first
//     kernel's run: a warp per (b, h) merges the splits' (m, l, acc) in
//     split index order, and a thread per page sums the page's relevance
//     partials over kv heads in index order before dividing by H and the
//     page's valid-slot count.
// No atomics: outputs and the freeze decisions fed by the relevance do
// not change from run to run.  A last-block-merges single launch was
// tried and was slower (its fences and atomics cost more than the second
// launch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHd = 128;        // head_dim: a power of two up to this
constexpr int kMaxPage = 256;
constexpr int kLoads = 8;          // K rows and V rows a thread has in flight
constexpr float kNegInf = -1e30f;

// 16 bytes of T as kVec floats (bf16 is the high half of an f32)
template <typename T> struct Pack;
template <> struct Pack<float> {
  static constexpr int kVec = 4;
  using Bits = uint32_t;
  static __device__ __forceinline__ void unpack(const uint4& u,
                                                float (&f)[kVec]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <> struct Pack<__nv_bfloat16> {
  static constexpr int kVec = 8;
  using Bits = uint16_t;
  static __device__ __forceinline__ void unpack(const uint4& u,
                                                float (&f)[kVec]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// kVec elements from p: one 16-byte load when `vec` (p 16-byte aligned),
// else the first n elements one by one and zeros after them
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* __restrict__ p, int n,
                                            bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  constexpr int kVec = Pack<T>::kVec, kPerWord = 4 / sizeof(T);
  const auto* src = reinterpret_cast<const typename Pack<T>::Bits*>(p);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < kVec; ++e)
    if (e < n)
      w[e / kPerWord] |= static_cast<uint32_t>(src[e])
                         << ((32 / kPerWord) * (e % kPerWord));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 16 bytes from global to shared memory by cp.async, zero-filled with
// nothing read when src_bytes is 0; complete after cp_async_wait()
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// A thread's own chunk of a K or V row into shared memory (zeros when not
// ok): a 16-byte cp.async when kAsync, so every chunk of a tile is in
// flight at once with no register held; else element loads.
template <typename T, bool kAsync>
__device__ __forceinline__ void stage(uint4* dst, const T* src, bool ok,
                                      int n) {
  if constexpr (kAsync)
    cp_async16(dst, src, ok ? 16 : 0);
  else
    *dst = ok ? load_chunk(src, n, false) : make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ void store_f32(float x, float* o) { *o = x; }
__device__ __forceinline__ void store_f32(float x, __nv_bfloat16* o) {
  *o = __float2bfloat16(x);                               // round to nearest even
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Programmatic dependent launch (sm_90): the attention kernel lets the
// combine kernel be scheduled while it runs, and the combine waits for the
// attention grid's completion (and its writes) before reading partials.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void wait_for_primary() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Row `row` of out by one warp from its splits' partials: out = sum_z
// e^(m_z - M) acc_z / sum_z e^(m_z - M) l_z over the splits z with l_z > 0,
// summed in index order (zeros when none).  Lane j takes columns j, j + 32,
// ...; every split writes its acc (zeros when it had nothing live), so the
// first kB splits' acc go out together with the (m, l) loads, lane z
// loading split z's (m, l), and the weights pass between lanes by shuffle.
template <typename T>
__device__ void merge_row(const float* __restrict__ ml,
                          const float* __restrict__ acc, T* __restrict__ out,
                          int n_split, int hd) {
  constexpr int kB = 8, kCols = kMaxHd / 32;
  const int lane = threadIdx.x & 31;
  const float2* ml2 = reinterpret_cast<const float2*>(ml);
  float av[kB][kCols];
#pragma unroll
  for (int j = 0; j < kB; ++j)
#pragma unroll
    for (int e = 0; e < kCols; ++e)
      av[j][e] = j < n_split && lane + 32 * e < hd
          ? acc[(size_t)j * hd + lane + 32 * e] : 0.f;
  const float2 own = lane < n_split ? ml2[lane] : make_float2(kNegInf, 0.f);
  float m = own.y > 0.f ? own.x : kNegInf;
  for (int z = lane + 32; z < n_split; z += 32) {
    const float2 e = ml2[z];
    if (e.y > 0.f) m = fmaxf(m, e.x);
  }
  m = warp_max(m);
  float l = 0.f, a[kCols];
#pragma unroll
  for (int e = 0; e < kCols; ++e) a[e] = 0.f;
  for (int z0 = 0; z0 < n_split; z0 += 32) {
    const float2 mine = z0 == 0 ? own
        : z0 + lane < n_split ? ml2[z0 + lane] : make_float2(kNegInf, 0.f);
    const float w = mine.y > 0.f ? expf(mine.x - m) : 0.f;
    const int nz = min(32, n_split - z0);
    for (int j0 = 0; j0 < nz; j0 += kB) {
      if (z0 + j0 > 0) {
#pragma unroll
        for (int j = 0; j < kB; ++j)
#pragma unroll
          for (int e = 0; e < kCols; ++e)
            av[j][e] = j0 + j < nz && lane + 32 * e < hd
                ? acc[(size_t)(z0 + j0 + j) * hd + lane + 32 * e] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kB; ++j) {
        if (j0 + j >= nz) break;
        const float wj = __shfl_sync(0xffffffffu, w, j0 + j);
        const float lj = __shfl_sync(0xffffffffu, mine.y, j0 + j);
        if (lj > 0.f) {
          l += wj * lj;
#pragma unroll
          for (int e = 0; e < kCols; ++e) a[e] += wj * av[j][e];
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < kCols; ++e)
    if (lane + 32 * e < hd)
      store_f32(l > 0.f ? a[e] / fmaxf(l, 1e-30f) : 0.f,
                out + lane + 32 * e);
}

// Thread (r, c) of the attention kernels: chunk c of rows r, r + rpp, ...
// of a tile, a row being L chunks of kVec elements (L a power of two up to
// 32).  Its K and V chunks are staged in its own slots of kv_s (K slot i at
// i * kThreads + tid, V at (kLoads + i) * kThreads + tid), and it is the
// only thread that reads them; the cross-thread sums go through those
// slots, each thread writing over its own after reading it.
struct Layout {
  int L, lshift, c, r, rpp, tile;
  __device__ explicit Layout(int hd, int kVec) {
    L = hd >= kVec ? hd / kVec : 1;
    lshift = __ffs(L) - 1;
    c = threadIdx.x & (L - 1);
    r = threadIdx.x >> lshift;
    rpp = kThreads >> lshift;
    tile = rpp * kLoads;
  }
};

// Scores of the tile's rows: each thread writes the G partial dot products
// of each of its rows (a float4) over its own K slot; after a barrier, one
// thread a row adds the row's L partials, starting at chunk (row mod L) so
// that the eight rows of a 128-bit shared-memory phase hit distinct banks.
// Returns the G sums of row `row` in s (G <= 4).
__device__ __forceinline__ void row_sums(const float4* part, const Layout& y,
                                         int row, float (&s)[4]) {
  const int base = (row >> (__ffs(y.rpp) - 1)) * kThreads +
                   (row & (y.rpp - 1)) * y.L;
  s[0] = s[1] = s[2] = s[3] = 0.f;
  for (int k = 0; k < y.L; ++k) {
    const float4 v = part[base + ((k + row) & (y.L - 1))];
    s[0] += v.x;
    s[1] += v.y;
    s[2] += v.z;
    s[3] += v.w;
  }
}

// The block's unnormalised P.V for its G query rows, (G, hd) f32 at out:
// each thread writes its acc over its own K slots (free after the last
// tile), and after a barrier each output column sums the rpp row slots in
// index order.
template <int G, int kVec>
__device__ __forceinline__ void write_acc(uint4* kv_s, const Layout& y,
                                          const float (&acc)[G][kVec],
                                          float* out, size_t g_stride,
                                          int hd) {
  const float* acc_s = reinterpret_cast<const float*>(kv_s);
  const int tid = threadIdx.x;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < kVec; e += 4)
      reinterpret_cast<float4*>(kv_s)[((g * kVec + e) >> 2) * kThreads + tid] =
          make_float4(acc[g][e], acc[g][e + 1], acc[g][e + 2], acc[g][e + 3]);
  __syncthreads();
  const int hd_shift = __ffs(hd) - 1;
  for (int o = tid; o < G * hd; o += kThreads) {
    const int g = o >> hd_shift, d = o & (hd - 1);
    const int f = g * kVec + (d & (kVec - 1));
    const float* src = acc_s + ((f >> 2) * kThreads + (d / kVec)) * 4 +
                       (f & 3);
    float sum = 0.f;
#pragma unroll 8
    for (int rr = 0; rr < y.rpp; ++rr) sum += src[rr * y.L * 4];
    out[g * g_stride + d] = sum;
  }
}

template <typename T, int G, bool kAsync>
__global__ void __launch_bounds__(kThreads, 3)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v,
                  const uint8_t* __restrict__ slot_mask,
                  const int* __restrict__ page_table,
                  const uint8_t* __restrict__ page_visible,
                  const int* __restrict__ page_quant,
                  const float* __restrict__ kv_scales,
                  float* __restrict__ part_ml, float* __restrict__ part_acc,
                  float* __restrict__ relp, float* __restrict__ nact, int P,
                  int page, int KVH, int hd, int pages_per_block,
                  float scale) {
  launch_dependents();
  constexpr int kVec = Pack<T>::kVec;
  const int z = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int H = G * KVH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Layout y(hd, kVec);
  const int cn = min(kVec, hd - y.c * kVec);   // elements of chunk c
  __shared__ float s_s[G][kMaxPage];           // raw scores, then probabilities
  __shared__ uint4 kv_s[2 * kLoads * kThreads];
  __shared__ uint8_t mask_s[kMaxPage];
  __shared__ float m_s[G], l_s[G], corr_s[G], rel_s[G];
  const float4* part = reinterpret_cast<const float4*>(kv_s);

  float q_r[G][kVec];
#pragma unroll
  for (int g = 0; g < G; ++g)
    Pack<T>::unpack(load_chunk(q + ((size_t)b * H + kh * G + g) * hd +
                                   y.c * kVec, cn, kAsync), q_r[g]);
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[G][kVec];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[g][e] = 0.f;

  const size_t tok_stride = (size_t)KVH * hd;
  const int p_end = min(P, (z + 1) * pages_per_block);
  for (int p = z * pages_per_block; p < p_end; ++p) {
    const int bp = b * P + p;
    float* relp_out = relp + ((size_t)b * KVH + kh) * P + p;
    // liveness from the tables alone (all three loaded together): a
    // skipped page's K/V, mask bits and scales are never read
    const int mapped = page_table[bp];
    const uint8_t visible = page_visible[bp];
    const bool quant = page_quant[bp] != 0;
    if ((mapped < 0) | (visible == 0)) {
      if (tid == 0) {
        *relp_out = 0.f;
        if (kh == 0) nact[bp] = 0.f;
      }
      continue;
    }
    int n_act = 0;
    for (int t0 = 0; t0 < page; t0 += kThreads) {
      const int t = t0 + tid;
      const uint8_t mk = t < page ? slot_mask[(size_t)bp * page + t] : 0;
      if (t < page) mask_s[t] = mk;
      n_act += __syncthreads_count(mk != 0);
    }
    if (tid == 0 && kh == 0) nact[bp] = (float)n_act;
    if (n_act == 0) {
      if (tid == 0) *relp_out = 0.f;
      continue;
    }
    const float sk = quant ? kv_scales[((size_t)bp * 2 + 0) * KVH + kh] : 1.f;
    const float sv = quant ? kv_scales[((size_t)bp * 2 + 1) * KVH + kh] : 1.f;
    const T* kp = k + (size_t)bp * page * tok_stride + (size_t)kh * hd +
                  y.c * kVec;
    const T* vp = v + (size_t)bp * page * tok_stride + (size_t)kh * hd +
                  y.c * kVec;
    float a = 0.f;                   // warp g's relevance partial of row g
    for (int t0 = 0; t0 < page; t0 += y.tile) {
      const int tn = min(y.tile, page - t0);
      // every K and V chunk of the tile's valid rows in flight at once
      // (zeros for the others)
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const int t = i * y.rpp + y.r;
        const bool ok = t < tn && mask_s[t0 + t];
        const size_t off = ok ? (size_t)(t0 + t) * tok_stride : 0;
        stage<T, kAsync>(&kv_s[i * kThreads + tid], kp + off, ok, cn);
        stage<T, kAsync>(&kv_s[(kLoads + i) * kThreads + tid], vp + off, ok,
                         cn);
      }
      if constexpr (kAsync) cp_async_wait();
      // this thread's share of q.k, then each valid row's sums
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        float kf[kVec];
        Pack<T>::unpack(kv_s[i * kThreads + tid], kf);
        float pg[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < kVec; ++e) pg[g] += q_r[g][e] * (kf[e] * sk);
        reinterpret_cast<float4*>(kv_s)[i * kThreads + tid] =
            make_float4(pg[0], pg[1], pg[2], pg[3]);
      }
      __syncthreads();
      for (int t = tid; t < tn; t += kThreads) {
        if (!mask_s[t0 + t]) continue;
        float sg[4];
        row_sums(part, y, t, sg);
#pragma unroll
        for (int g = 0; g < G; ++g) s_s[g][t] = sg[g];
      }
      __syncthreads();

      // relevance partial, running max and probabilities (0 on invalid
      // slots): one warp per query row
      if (warp < G) {
        const int g = warp;
        float mx = kNegInf;
        for (int t = lane; t < tn; t += 32) {
          if (mask_s[t0 + t]) {
            const float sc = s_s[g][t];
            a += fabsf(sc);
            mx = fmaxf(mx, sc * scale);
          }
        }
        mx = warp_max(mx);
        const float m_prev = m_s[g];
        const float m_new = fmaxf(m_prev, mx);
        float lsum = 0.f;
        for (int t = lane; t < tn; t += 32) {
          float pr = 0.f;
          if (mask_s[t0 + t]) pr = expf(s_s[g][t] * scale - m_new);
          s_s[g][t] = pr;
          lsum += pr;
        }
        // the two sums' butterflies interleaved (a is summed on the page's
        // last tile only)
        const bool last = t0 + y.tile >= page;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
          const float ao = __shfl_xor_sync(0xffffffffu, a, o);
          if (last) a += ao;
        }
        if (lane == 0) {
          const float corr = expf(m_prev - m_new);
          corr_s[g] = corr;
          l_s[g] = l_s[g] * corr + lsum;
          m_s[g] = m_new;
          if (t0 + y.tile >= page) rel_s[g] = a;
        }
      }
      __syncthreads();
      if (tid == 0 && t0 + y.tile >= page) {
        float rs = 0.f;
#pragma unroll
        for (int g = 0; g < G; ++g) rs += rel_s[g];
        *relp_out = rs;
      }

      // rescale, then P.V over this thread's rows at chunk c (invalid rows
      // have p = 0 and zero-filled V)
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float corr = corr_s[g];
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[g][e] *= corr;
      }
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const int t = i * y.rpp + y.r;
        float vf[kVec];
        Pack<T>::unpack(kv_s[(kLoads + i) * kThreads + tid], vf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pr = t < tn ? s_s[g][t] : 0.f;
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[g][e] += pr * (vf[e] * sv);
        }
      }
      __syncthreads();             // s_s, mask_s and kv_s are rewritten next
    }
  }

  // this split's unnormalised partials; l = 0 marks a split with nothing
  // live, whose acc is 0 and not merged
  if (tid < G) {
    float* ml = part_ml + (((size_t)b * H + kh * G + tid) * n_split + z) * 2;
    ml[0] = m_s[tid];
    ml[1] = l_s[tid];
  }
  write_acc<G, kVec>(kv_s, y, acc,
                     part_acc + (((size_t)b * H + kh * G) * n_split + z) * hd,
                     (size_t)n_split * hd, hd);
}

// The first ceil(B*H / kWarps) blocks: a warp per row (b, h) of out from
// the splits' partials (merge_row).  The blocks after them, a thread per page: rel[b, p] =
// sum_kh relp[b, kh, p] / H / max(n_act, 1), kv heads summed in index
// order, their partials loaded kBatch at a time.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const float* __restrict__ part_ml,
                     const float* __restrict__ part_acc,
                     const float* __restrict__ relp,
                     const float* __restrict__ nact, T* __restrict__ out,
                     float* __restrict__ rel, int B, int H, int P, int KVH,
                     int hd, int n_split) {
  wait_for_primary();
  constexpr int kBatch = 8;
  const int n_merge = (B * H + kWarps - 1) / kWarps;
  if ((int)blockIdx.x < n_merge) {
    const size_t bh = (size_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (bh < (size_t)B * H)
      merge_row(part_ml + bh * n_split * 2, part_acc + bh * n_split * hd,
                out + bh * hd, n_split, hd);
    return;
  }
  const int i = (blockIdx.x - n_merge) * kThreads + threadIdx.x;
  if (i >= B * P) return;
  const int b = i / P, p = i - b * P;
  const float n = nact[i];
  const float* rp = relp + (size_t)b * KVH * P + p;
  float s = 0.f;
  for (int k0 = 0; k0 < KVH; k0 += kBatch) {
    float part[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      part[j] = k0 + j < KVH ? rp[(size_t)(k0 + j) * P] : 0.f;
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (k0 + j < KVH) s += part[j];
  }
  rel[i] = s / (float)H / (n > 0.f ? n : 1.f);
}

// Launches `kernel` (blocks x kThreads) on `s` as a programmatic dependent
// of the kernel before it on the stream.
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), unsigned blocks,
                             cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename T>
cudaError_t launch(int G, cudaStream_t s, const void* q, const void* k,
                   const void* v, const uint8_t* sm, const int* pt,
                   const uint8_t* vis, const int* pq, const float* sc,
                   void* out, float* rel, float* scratch, int B, int P,
                   int page, int H, int KVH, int hd, int ppb, int vec,
                   float scale) {
  const int n_split = (P + ppb - 1) / ppb;
  float* part_ml = scratch;        // first: its float2 reads stay aligned
  float* part_acc = part_ml + (size_t)B * H * n_split * 2;
  float* relp = part_acc + (size_t)B * H * n_split * hd;
  float* nact = relp + (size_t)B * KVH * P;
  const dim3 grid(n_split, KVH, B);
#define PAGED_ATTN_ARGS                                                      \
  static_cast<const T*>(q), static_cast<const T*>(k),                        \
      static_cast<const T*>(v), sm, pt, vis, pq, sc, part_ml, part_acc,      \
      relp, nact, P, page, KVH, hd, ppb, scale
#define PAGED_ATTN_CASE(NG)                                                  \
  case NG:                                                                   \
    if (vec)                                                                 \
      paged_attn_kernel<T, NG, true><<<grid, kThreads, 0, s>>>(              \
          PAGED_ATTN_ARGS);                                                  \
    else                                                                     \
      paged_attn_kernel<T, NG, false><<<grid, kThreads, 0, s>>>(             \
          PAGED_ATTN_ARGS);                                                  \
    break;
  switch (G) {
    PAGED_ATTN_CASE(1)
    PAGED_ATTN_CASE(2)
    PAGED_ATTN_CASE(4)
    default:
      return cudaErrorInvalidValue;
  }
#undef PAGED_ATTN_CASE
#undef PAGED_ATTN_ARGS
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int blocks = (B * H + kWarps - 1) / kWarps +
                     (B * P + kThreads - 1) / kThreads;
  return launch_dependent(paged_combine_kernel<T>, blocks, s, part_ml,
                          part_acc, relp, nact, static_cast<T*>(out), rel, B,
                          H, P, KVH, hd, n_split);
}

}  // namespace

// Launches the two kernels on `stream`; returns the first launch error.
// Pointers: q (B,H,hd), k/v (B,P,page,KVH,hd) of type T (is_bf16 ? bf16 :
// f32); slot_mask (B,P,page) and page_visible (B,P) as bytes; page_table
// and page_quant (B,P) int32; kv_scales (B,P,2,KVH) f32; out (B,H,hd) T;
// rel (B,P) f32; scratch f32 of B*H*n_split*(hd+2) + B*KVH*P + B*P
// elements, n_split = ceil(P / pages_per_block).  All contiguous; `vec`
// says q, k and v are 16-byte aligned and hd * sizeof(T) >= 16.  H / KVH
// must be 1, 2 or 4, hd a power of two up to 128 and page at most 256.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k, const void* v, const void* slot_mask,
    const void* page_table, const void* page_visible, const void* page_quant,
    const void* kv_scales, void* out, void* rel, void* scratch, int B, int P,
    int page, int H, int KVH, int hd, int is_bf16, int pages_per_block,
    int vec, float scale, void* stream) {
  if (pages_per_block < 1 || hd > kMaxHd || page > kMaxPage || hd & (hd - 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* sm = static_cast<const uint8_t*>(slot_mask);
  const auto* pt = static_cast<const int*>(page_table);
  const auto* vis = static_cast<const uint8_t*>(page_visible);
  const auto* pq = static_cast<const int*>(page_quant);
  const auto* sc = static_cast<const float*>(kv_scales);
  auto* rl = static_cast<float*>(rel);
  auto* scr = static_cast<float*>(scratch);
  const int G = H / KVH;
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(G, s, q, k, v, sm, pt, vis, pq, sc,
                                      out, rl, scr, B, P, page, H, KVH, hd,
                                      pages_per_block, vec, scale)
              : launch<float>(G, s, q, k, v, sm, pt, vis, pq, sc, out, rl,
                              scr, B, P, page, H, KVH, hd, pages_per_block,
                              vec, scale);
  return static_cast<int>(err);
}

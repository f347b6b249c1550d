// Freeze-masked flash-decode attention over a contiguous KV cache, with
// fused per-slot relevance, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/freeze_decode_attn.py::freeze_decode_attention.  It
// computes what that kernel computes: one query token per lane (q (B,H,hd))
// attends over the lane's cache k, v (B,S,KVH,hd) under active_mask (B,S),
// with an online softmax in f32.  Per-slot relevance is the paper's Eq. 2
// score, the mean over all H query heads of |q.k|; it is exactly 0 on an
// inactive slot, also inside a partly active chunk.  Inactive slots' K/V
// are never read (frozen slots may hold anything), so a chunk with no
// active slot reads none.  A lane with nothing active outputs zeros.  Any
// S is taken: the ragged last chunk is masked here (the Pallas kernel
// asserts S % block_s == 0).
//
// What bounds it on this card: HBM bytes.  Only active slots' K and V rows
// are read (bytes ~ active slots * KVH * hd * 2 * sizeof(T), plus q, the
// mask, out and relevance; 9.2 MB and 0.0028 ms at the main path's B=4,
// S=2048, H=32, KVH=8, hd=128, bf16 with 2,226 of 8,192 slots active); the
// arithmetic is ~4 flops per K/V element, far below the H100's ridge
// point, so the only lever is having the bytes in flight.
//
// Design (flash-decoding, two launches a call).  The previous version
// walked a split's chunks with a chain of barriers and 2-byte loads; this
// one puts every active row's bytes in flight at once:
//  1. freeze_attn_kernel: one block of 128 threads per (chunk z of `chunk`
//     slots, kv head kh, lane b), 512 blocks at the main path.  The block
//     reads its chunk's mask and compacts the active slots, in slot order,
//     into a shared index list (a ballot and popcount prefix per warp), so
//     only active rows are loaded and a chunk with none reads no K/V.  It
//     then issues every active K and V row chunk as 16-byte cp.async
//     copies into shared memory and waits once.  Thread (r, c) owns chunk
//     c of compacted rows r, r + rpp, ...; the G = H / KVH query rows'
//     chunks sit in registers.  Each thread's share of q.k goes to shared
//     memory and one thread a row adds the row's shares and writes the
//     slot's relevance partial (|q.k| summed over the G rows, in g order)
//     to a (B, KVH, S) scratch; one warp per query row runs the softmax;
//     every thread accumulates P.V for its rows and chunk, and the rows'
//     sums go through shared memory in index order.  The block writes its
//     unnormalised (m, l, acc) per query row to scratch (acc 0 for a chunk
//     with nothing active).
//  2. freeze_combine_kernel, launched as a programmatic dependent of the
//     first (sm_90, CUDA 12.3 or later): a warp per (b, h) merges the
//     chunks' (m, l, acc) in chunk index order, and a thread per slot sums
//     an active slot's relevance partials over kv heads in index order
//     before dividing by H (0 on inactive slots, whose partials are never
//     read).
// No atomics: the output and the freeze decisions fed by the relevance
// do not change from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHd = 128;        // head_dim: a power of two up to this
constexpr int kMaxChunk = 256;     // slots a block: a multiple of 32 up to this
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
freeze_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const uint8_t* __restrict__ mask,
                   float* __restrict__ part_ml, float* __restrict__ part_acc,
                   float* __restrict__ relp, int S, int KVH, int hd,
                   int chunk, float scale) {
  launch_dependents();
  constexpr int kVec = Pack<T>::kVec;
  constexpr int kPasses = kMaxChunk / kThreads;
  const int z = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int H = G * KVH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Layout y(hd, kVec);
  const int cn = min(kVec, hd - y.c * kVec);   // elements of chunk c
  __shared__ float s_s[G][kMaxChunk];          // raw scores, then probabilities
  __shared__ uint4 kv_s[2 * kLoads * kThreads];
  __shared__ int16_t idx_s[kMaxChunk];         // active slots of the chunk
  __shared__ int cnt_s[kMaxChunk / 32];        // active slots a word of 32
  __shared__ float m_s[G], l_s[G], corr_s[G];
  const float4* part = reinterpret_cast<const float4*>(kv_s);

  const int s0 = z * chunk, n = min(chunk, S - s0);
  // the chunk's mask as ballots, a word of 32 slots a warp and pass
  unsigned bal[kPasses];
#pragma unroll
  for (int j = 0; j < kPasses; ++j) {
    const int t = j * kThreads + tid;
    const bool act = t < n && mask[(size_t)b * S + s0 + t] != 0;
    bal[j] = __ballot_sync(0xffffffffu, act);
    if (lane == 0) cnt_s[j * kWarps + warp] = __popc(bal[j]);
  }
  float q_r[G][kVec];
#pragma unroll
  for (int g = 0; g < G; ++g)
    Pack<T>::unpack(load_chunk(q + ((size_t)b * H + kh * G + g) * hd +
                                   y.c * kVec, cn, kAsync), q_r[g]);
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  __syncthreads();
  // compact: active slot t goes to the count of active slots before it
  int n_act = 0;
  for (int w = 0; w < (chunk + 31) / 32; ++w) {
#pragma unroll
    for (int j = 0; j < kPasses; ++j)
      if (w == j * kWarps + warp && (bal[j] >> lane & 1u))
        idx_s[n_act + __popc(bal[j] & ((1u << lane) - 1u))] =
            static_cast<int16_t>(j * kThreads + tid);
    n_act += cnt_s[w];
  }
  __syncthreads();

  float acc[G][kVec];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[g][e] = 0.f;

  const size_t tok_stride = (size_t)KVH * hd;
  const T* kb = k + ((size_t)b * S + s0) * tok_stride + (size_t)kh * hd +
                y.c * kVec;
  const T* vb = v + ((size_t)b * S + s0) * tok_stride + (size_t)kh * hd +
                y.c * kVec;
  float* relp_b = relp + ((size_t)b * KVH + kh) * S + s0;
  for (int i0 = 0; i0 < n_act; i0 += y.tile) {
    const int tn = min(y.tile, n_act - i0);
    // every K and V chunk of the tile's active rows in flight at once
    // (zeros past the last)
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int j = i * y.rpp + y.r;
      const bool ok = j < tn;
      const size_t off = ok ? (size_t)idx_s[i0 + j] * tok_stride : 0;
      stage<T, kAsync>(&kv_s[i * kThreads + tid], kb + off, ok, cn);
      stage<T, kAsync>(&kv_s[(kLoads + i) * kThreads + tid], vb + off, ok,
                       cn);
    }
    if constexpr (kAsync) cp_async_wait();
    // this thread's share of q.k, then each row's sums; the row's thread
    // writes the slot's relevance partial (|q.k| summed over g in order)
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      float kf[kVec];
      Pack<T>::unpack(kv_s[i * kThreads + tid], kf);
      float pg[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < kVec; ++e) pg[g] += q_r[g][e] * kf[e];
      reinterpret_cast<float4*>(kv_s)[i * kThreads + tid] =
          make_float4(pg[0], pg[1], pg[2], pg[3]);
    }
    __syncthreads();
    for (int j = tid; j < tn; j += kThreads) {
      float sg[4];
      row_sums(part, y, j, sg);
      float rs = 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        s_s[g][j] = sg[g];
        rs += fabsf(sg[g]);
      }
      relp_b[idx_s[i0 + j]] = rs;
    }
    __syncthreads();

    // running max and probabilities: one warp per query row
    if (warp < G) {
      const int g = warp;
      float mx = kNegInf;
      for (int j = lane; j < tn; j += 32) mx = fmaxf(mx, s_s[g][j] * scale);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float lsum = 0.f;
      for (int j = lane; j < tn; j += 32) {
        const float pr = expf(s_s[g][j] * scale - m_new);
        s_s[g][j] = pr;
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

    // rescale, then P.V over this thread's rows at chunk c (rows past the
    // last have p = 0 and zero-filled V)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float corr = corr_s[g];
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[g][e] *= corr;
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int j = i * y.rpp + y.r;
      float vf[kVec];
      Pack<T>::unpack(kv_s[(kLoads + i) * kThreads + tid], vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pr = j < tn ? s_s[g][j] : 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[g][e] += pr * vf[e];
      }
    }
    __syncthreads();               // s_s and kv_s are rewritten next
  }

  // this chunk's unnormalised partials; l = 0 marks a chunk with nothing
  // active, whose acc is 0 and not merged
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
// the chunks' partials (merge_row).  The blocks after them, a thread per slot: rel[b, s] =
// active ? sum_kh relp[b, kh, s] / H : 0, kv heads summed in index order,
// their partials loaded kBatch at a time.
template <typename T>
__global__ void __launch_bounds__(kThreads)
freeze_combine_kernel(const float* __restrict__ part_ml,
                      const float* __restrict__ part_acc,
                      const float* __restrict__ relp,
                      const uint8_t* __restrict__ mask, T* __restrict__ out,
                      float* __restrict__ rel, int B, int H, int S, int KVH,
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
  const size_t i = (size_t)(blockIdx.x - n_merge) * kThreads + threadIdx.x;
  if (i >= (size_t)B * S) return;
  if (!mask[i]) {
    rel[i] = 0.f;
    return;
  }
  const size_t b = i / S, s = i - b * S;
  const float* rp = relp + b * KVH * S + s;
  float r = 0.f;
  for (int k0 = 0; k0 < KVH; k0 += kBatch) {
    float part[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      part[j] = k0 + j < KVH ? rp[(size_t)(k0 + j) * S] : 0.f;
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (k0 + j < KVH) r += part[j];
  }
  rel[i] = r / (float)H;
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
                   const void* v, const uint8_t* mask, void* out, float* rel,
                   float* scratch, int B, int S, int H, int KVH, int hd,
                   int chunk, int vec, float scale) {
  const int n_split = (S + chunk - 1) / chunk;
  float* part_ml = scratch;        // first: its float2 reads stay aligned
  float* part_acc = part_ml + (size_t)B * H * n_split * 2;
  float* relp = part_acc + (size_t)B * H * n_split * hd;
  const dim3 grid(n_split, KVH, B);
#define FREEZE_ATTN_ARGS                                                     \
  static_cast<const T*>(q), static_cast<const T*>(k),                        \
      static_cast<const T*>(v), mask, part_ml, part_acc, relp, S, KVH, hd,   \
      chunk, scale
#define FREEZE_ATTN_CASE(NG)                                                 \
  case NG:                                                                   \
    if (vec)                                                                 \
      freeze_attn_kernel<T, NG, true><<<grid, kThreads, 0, s>>>(             \
          FREEZE_ATTN_ARGS);                                                 \
    else                                                                     \
      freeze_attn_kernel<T, NG, false><<<grid, kThreads, 0, s>>>(            \
          FREEZE_ATTN_ARGS);                                                 \
    break;
  switch (G) {
    FREEZE_ATTN_CASE(1)
    FREEZE_ATTN_CASE(2)
    FREEZE_ATTN_CASE(4)
    default:
      return cudaErrorInvalidValue;
  }
#undef FREEZE_ATTN_CASE
#undef FREEZE_ATTN_ARGS
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t blocks = ((size_t)B * H + kWarps - 1) / kWarps +
                        ((size_t)B * S + kThreads - 1) / kThreads;
  return launch_dependent(freeze_combine_kernel<T>, (unsigned)blocks, s,
                          part_ml, part_acc, relp, mask,
                          static_cast<T*>(out), rel, B, H, S, KVH, hd,
                          n_split);
}

}  // namespace

// Launches the two kernels on `stream`; returns the first launch error.
// Pointers: q (B,H,hd), k/v (B,S,KVH,hd) of type T (is_bf16 ? bf16 : f32);
// active_mask (B,S) as bytes; out (B,H,hd) T; rel (B,S) f32; scratch f32
// of B*H*n_split*(hd+2) + B*KVH*S elements, n_split = ceil(S / chunk).
// All contiguous; `vec` says q, k and v are 16-byte aligned and hd *
// sizeof(T) >= 16.  chunk is a multiple of 32 up to 256, H / KVH 1, 2 or
// 4 and hd a power of two up to 128.
extern "C" int freeze_decode_attention_launch(
    const void* q, const void* k, const void* v, const void* active_mask,
    void* out, void* rel, void* scratch, int B, int S, int H, int KVH,
    int hd, int chunk, int is_bf16, int vec, float scale, void* stream) {
  if (chunk < 32 || chunk > kMaxChunk || chunk % 32 || hd > kMaxHd ||
      hd & (hd - 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* mask = static_cast<const uint8_t*>(active_mask);
  auto* rl = static_cast<float*>(rel);
  auto* scr = static_cast<float*>(scratch);
  const int G = H / KVH;
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(G, s, q, k, v, mask, out, rl, scr, B,
                                      S, H, KVH, hd, chunk, vec, scale)
              : launch<float>(G, s, q, k, v, mask, out, rl, scr, B, S, H,
                              KVH, hd, chunk, vec, scale);
  return static_cast<int>(err);
}

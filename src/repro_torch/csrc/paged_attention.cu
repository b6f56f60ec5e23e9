// Paged decode attention on Hopper.
//
// Replaces the Pallas kernel `paged_attention` in
// src/repro/kernels/paged_attention/kernel.py:101 (pallas_call at :129):
// one query token per sequence attends over that sequence's K/V pages,
// addressed through a within-sequence block table; GQA maps each group of
// h/g query heads onto one kv-head; scores are scaled by d^-0.5; an f32
// online softmax (m, l, acc) runs across pages; pages at or past the
// context length are skipped; masked scores are -1e30 and l is floored at
// 1e-30.
//
// What bounds it on an H100: bytes and, at decode sizes, launch latency.
// Each (sequence, kv-head) reads ctx * d * 2 K/V elements and does about
// 4 * (h/g) * ctx * d flops on them, about 2 flops per byte in bf16, far
// below the ~295 flops per byte where the tensor cores would bind.  At
// Yi-9B decode shapes (b <= 4, ctx ~ 128) one layer reads about 1 MiB,
// a fraction of a microsecond at 3.35 TB/s, so the launch dominates.
//
// What the design does about it: one thread block per (sequence, kv-head),
// so the h/g query heads of a group share every K/V page load from device
// memory (the Pallas kernel re-read a page per query head group and
// sequence the same way).  The block reads its own block-table row, loops
// over the pages below ctx only, stages one page of K (rows padded by one
// float to avoid shared-memory bank conflicts) and of V in shared memory,
// and keeps the output accumulator in registers; the running max and sum
// of each query head live in shared memory next to the page.  No tensor
// cores yet: plain FMA, right first.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kAccPerThread = 32;  // (h/g) * d <= kThreads * kAccPerThread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void paged_attention_kernel(const T* __restrict__ q,       // [b, h, d]
                                       const T* __restrict__ k_pages, // [b, per_seq, bs, g, d]
                                       const T* __restrict__ v_pages,
                                       const int32_t* __restrict__ block_tables,  // [b, per_seq]
                                       const int32_t* __restrict__ context_lens,  // [b]
                                       T* __restrict__ out,           // [b, h, d]
                                       int h, int g, int d, int per_seq, int bs,
                                       float scale) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x;
  const int seq = blockIdx.y;
  const int qpg = h / g;
  const int kld = d + 1;  // padded K row
  float* qs = smem;                 // [qpg, d]
  float* ks = qs + qpg * d;         // [bs, d + 1]
  float* vs = ks + bs * kld;        // [bs, d]
  float* ps = vs + bs * d;          // [qpg, bs]
  float* m_s = ps + qpg * bs;       // [qpg]
  float* l_s = m_s + qpg;           // [qpg]
  float* c_s = l_s + qpg;           // [qpg]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = kThreads / 32;
  const int n_acc = qpg * d;

  const T* qb = q + (static_cast<int64_t>(seq) * h + kvh * qpg) * d;
  for (int e = tid; e < n_acc; e += kThreads) qs[e] = to_float(qb[e]);
  for (int i = tid; i < qpg; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  float acc[kAccPerThread];
#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) acc[i] = 0.f;

  const int ctx = context_lens[seq];
  const int n_pages = min(per_seq, (ctx + bs - 1) / bs);
  __syncthreads();

  for (int p = 0; p < n_pages; ++p) {
    const int blk = block_tables[static_cast<int64_t>(seq) * per_seq + p];
    const int page_start = p * bs;
    const int64_t page_base = (static_cast<int64_t>(seq) * per_seq + blk) * bs;
    for (int e = tid; e < bs * d; e += kThreads) {
      const int t = e / d, j = e - t * d;
      const int64_t src = ((page_base + t) * g + kvh) * d + j;
      ks[t * kld + j] = to_float(k_pages[src]);
      vs[e] = to_float(v_pages[src]);
    }
    __syncthreads();

    for (int e = tid; e < qpg * bs; e += kThreads) {
      const int qh = e / bs, t = e - qh * bs;
      float s = kNegInf;
      if (page_start + t < ctx) {
        const float* qr = qs + qh * d;
        const float* kr = ks + t * kld;
        float dot = 0.f;
        for (int j = 0; j < d; ++j) dot = fmaf(qr[j], kr[j], dot);
        s = dot * scale;
      }
      ps[e] = s;
    }
    __syncthreads();

    for (int qh = warp; qh < qpg; qh += n_warps) {
      float* row = ps + qh * bs;
      float mx = kNegInf;
      for (int t = lane; t < bs; t += 32) mx = fmaxf(mx, row[t]);
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[qh];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < bs; t += 32) {
        const float s = row[t];
        const float pv = (s <= kNegInf) ? 0.f : expf(s - m_new);
        row[t] = pv;
        sum += pv;
      }
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[qh] = corr;
        l_s[qh] = l_s[qh] * corr + sum;
        m_s[qh] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kAccPerThread; ++i) {
      const int e = tid + i * kThreads;
      if (e < n_acc) {
        const int qh = e / d, j = e - qh * d;
        const float* pr = ps + qh * bs;
        float a = acc[i] * c_s[qh];
        for (int t = 0; t < bs; ++t) a = fmaf(pr[t], vs[t * d + j], a);
        acc[i] = a;
      }
    }
    __syncthreads();
  }

  T* ob = out + (static_cast<int64_t>(seq) * h + kvh * qpg) * d;
#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) {
    const int e = tid + i * kThreads;
    if (e < n_acc) {
      const int qh = e / d;
      ob[e] = from_float<T>(acc[i] / fmaxf(l_s[qh], 1e-30f));
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* tables,
           const void* ctx, void* out, int b, int h, int g, int d, int per_seq,
           int bs, float scale, cudaStream_t stream) {
  const int qpg = h / g;
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(qpg) * d + static_cast<size_t>(bs) * (d + 1) +
       static_cast<size_t>(bs) * d + static_cast<size_t>(qpg) * bs + 3 * qpg);
  auto kernel = paged_attention_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(g, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(tables), static_cast<const int32_t*>(ctx),
      static_cast<T*>(out), h, g, d, per_seq, bs, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pages and out share it).
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages, const void* block_tables,
                                      const void* context_lens, void* out, int b, int h,
                                      int g, int d, int per_seq, int bs, float scale,
                                      int dtype, void* stream) {
  if (b <= 0) return 0;
  if (g <= 0 || h % g != 0 || (h / g) * d > kThreads * kAccPerThread)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, block_tables, context_lens, out, b, h, g,
                         d, per_seq, bs, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, block_tables, context_lens, out,
                                 b, h, g, d, per_seq, bs, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

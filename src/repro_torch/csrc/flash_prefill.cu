// Blockwise (flash) prefill attention on Hopper.
//
// Replaces the Pallas kernel `flash_prefill` in
// src/repro/kernels/flash_prefill/kernel.py:103 (pallas_call at :133):
// causal attention with an optional sliding window and an always-visible
// prefix, GQA by index (kv-head = head // (h/g), no K/V repeat), fully
// masked kv tiles skipped with the block-level rule of
// models.flash.pair_schedule, f32 online softmax.  Unlike the TPU kernel,
// which raised on lengths that are not block multiples, this one masks
// ragged s and t itself: real prompts (96, 130, 257 tokens) are not
// aligned.
//
// What bounds it on an H100: at prompt lengths of a few hundred tokens,
// launch and latency.  s = 96 at Yi-9B widths (32 heads x 128) is about
// 2 * s^2 * h * d = 75 MFLOP per layer; at the bf16 tensor-core rate that
// is well under a microsecond, and the q/k/v/out bytes are under 1 MB.
// For long prompts it becomes bound by operations (O(s^2 d) flops on
// O(s d) bytes).
//
// What the design does about it: one thread block per (q tile, head,
// batch), looping over k tiles only up to the causal limit and skipping
// tiles the window hides, so only visible tiles cost anything.  A 32-row
// q tile and one 32-row K and V tile live in shared memory (K rows padded
// by one float against bank conflicts); each warp owns 8 query rows and
// does their softmax with warp shuffles (one lane per key of the tile);
// the 32 x d output accumulator lives in registers across the k loop.
// Plain FMA for now: tensor cores (mma.sync / wgmma) are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 32;
constexpr int kBK = 32;      // one key per lane in the softmax
constexpr int kMaxD = 128;
constexpr int kAccPerThread = kBQ * kMaxD / kThreads;
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
__global__ void flash_prefill_kernel(const T* __restrict__ q,  // [b, s, h, d]
                                     const T* __restrict__ k,  // [b, t, g, d]
                                     const T* __restrict__ v,
                                     T* __restrict__ out,      // [b, s, h, d]
                                     int s, int t, int h, int g, int d, int causal,
                                     int window, int prefix, float scale) {
  extern __shared__ float smem[];
  const int qt = blockIdx.x;
  const int head = blockIdx.y;
  const int bat = blockIdx.z;
  const int kvh = head / (h / g);
  const int kld = d + 1;
  float* qs = smem;               // [BQ, d]
  float* ks = qs + kBQ * d;       // [BK, d + 1]
  float* vs = ks + kBK * kld;     // [BK, d]
  float* ps = vs + kBK * d;       // [BQ, BK]
  float* m_s = ps + kBQ * kBK;    // [BQ]
  float* l_s = m_s + kBQ;         // [BQ]
  float* c_s = l_s + kBQ;         // [BQ]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q_lo = qt * kBQ;
  const int q_rows = min(kBQ, s - q_lo);
  const int n_acc = kBQ * d;

  for (int e = tid; e < n_acc; e += kThreads) {
    const int r = e / d, j = e - r * d;
    float x = 0.f;
    if (r < q_rows)
      x = to_float(q[((static_cast<int64_t>(bat) * s + q_lo + r) * h + head) * d + j]);
    qs[e] = x;
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  float acc[kAccPerThread];
#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) acc[i] = 0.f;

  const int q_hi = q_lo + q_rows - 1;
  int n_kt = (t + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, q_hi / kBK + 1);
  __syncthreads();

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k_lo = kt * kBK;
    if (window) {  // block-level visibility, as models.flash.pair_schedule
      const bool fully_out = (k_lo + kBK - 1) <= q_lo - window;
      const bool covers_prefix = prefix > 0 && k_lo < prefix;
      if (fully_out && !covers_prefix) continue;
    }
    for (int e = tid; e < kBK * d; e += kThreads) {
      const int r = e / d, j = e - r * d;
      float kx = 0.f, vx = 0.f;
      if (k_lo + r < t) {
        const int64_t src = ((static_cast<int64_t>(bat) * t + k_lo + r) * g + kvh) * d + j;
        kx = to_float(k[src]);
        vx = to_float(v[src]);
      }
      ks[r * kld + j] = kx;
      vs[e] = vx;
    }
    __syncthreads();

    for (int e = tid; e < kBQ * kBK; e += kThreads) {
      const int r = e / kBK, c = e - r * kBK;
      const int qi = q_lo + r, kj = k_lo + c;
      bool valid = r < q_rows && kj < t;
      if (causal) valid = valid && kj <= qi;
      if (window) valid = valid && (kj > qi - window || kj < prefix);
      float sc = kNegInf;
      if (valid) {
        const float* qr = qs + r * d;
        const float* kr = ks + c * kld;
        float dot = 0.f;
        for (int j = 0; j < d; ++j) dot = fmaf(qr[j], kr[j], dot);
        sc = dot * scale;
      }
      ps[e] = sc;
    }
    __syncthreads();

    for (int r = warp; r < kBQ; r += kThreads / 32) {
      const float sc = ps[r * kBK + lane];
      float mx = sc;
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float pv = (sc <= kNegInf) ? 0.f : expf(sc - m_new);
      ps[r * kBK + lane] = pv;
      float sum = pv;
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kAccPerThread; ++i) {
      const int e = tid + i * kThreads;
      if (e < n_acc) {
        const int r = e / d, j = e - r * d;
        const float* pr = ps + r * kBK;
        float a = acc[i] * c_s[r];
#pragma unroll 8
        for (int c = 0; c < kBK; ++c) a = fmaf(pr[c], vs[c * d + j], a);
        acc[i] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) {
    const int e = tid + i * kThreads;
    if (e < n_acc) {
      const int r = e / d, j = e - r * d;
      if (r < q_rows)
        out[((static_cast<int64_t>(bat) * s + q_lo + r) * h + head) * d + j] =
            from_float<T>(acc[i] / fmaxf(l_s[r], 1e-30f));
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int b, int s, int t,
           int h, int g, int d, int causal, int window, int prefix, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(kBQ) * d + static_cast<size_t>(kBK) * (d + 1) +
       static_cast<size_t>(kBK) * d + kBQ * kBK + 3 * kBQ);
  auto kernel = flash_prefill_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((s + kBQ - 1) / kBQ, h, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), s, t, h, g, d, causal, window, prefix, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
extern "C" int flash_prefill_launch(const void* q, const void* k, const void* v,
                                    void* out, int b, int s, int t, int h, int g, int d,
                                    int causal, int window, int prefix, float scale,
                                    int dtype, void* stream) {
  if (b <= 0 || s <= 0) return 0;
  if (g <= 0 || h % g != 0 || d <= 0 || d > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, b, s, t, h, g, d, causal, window, prefix, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, b, s, t, h, g, d, causal, window, prefix,
                                 scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// A decoder layer's normalisation, RoPE and gated activation on Hopper,
// each one launch: rmsnorm_launch (RMSNorm, with an optional residual added
// first), rope_launch (rotate-half RoPE of q and k together) and
// silu_mul_launch (SiLU(gate) * up).
//
// Replaces no Pallas kernel: the reference computes these with jnp ops
// that XLA fuses into the neighbouring matmuls.  Eager PyTorch runs them
// as chains of small f32 elementwise, cast and reduce kernels (9 for an
// RMSNorm, about 16 for a RoPE call), each a launch, and a decode step
// replayed as CUDA graphs walks those launches one after the other.
//
// What bounds them on an H100: bytes, and in practice the launch.  Each
// reads its inputs once and writes its outputs once (a Yi-9B decode row:
// 8 KiB in, 8 KiB out for the norm), far under a microsecond at 3.35 TB/s,
// so a launch costs more than its traffic.  The design keeps one launch for
// each and the intermediates in registers, in f32, rounded where the plain
// version rounds:
//   * rmsnorm: one block a row, 16-byte loads, the sum of squares in f32
//     by warp shuffles, rsqrtf(mean + eps), (h * rsqrt) * scale, one
//     rounding to the input's dtype.  With a residual the block first
//     writes r = round(x + res), the rounding of the plain add, and
//     normalises r (recomputed from x and res in the second pass);
//   * rope: a token's (head, i) pairs, q's heads then k's, over a row of
//     blocks (blockIdx.y), a pair a thread, so that no thread waits on a
//     chain of loads; the angle pos * freqs[i] in f32, accurate sincosf,
//     x1 * cos - x2 * sin and x2 * cos + x1 * sin each product rounded in
//     f32 (no contraction into fma), then one rounding to x's dtype;
//   * silu_mul: a grid-stride pass, 16-byte loads, silu(a) = a / (1 +
//     expf(-a)) rounded to the dtype before the product, as F.silu(a) * b
//     rounds.
// Each kernel launches on the stream it is given (PyTorch's current one),
// so a CUDA graph being captured on it records the launch.  The rows and
// elements off the 16-byte grid take the same kernels with scalar loads.
// The model runs them in bfloat16 (its weights' dtype) and in float32 (its
// weights cast, for comparisons at f32 precision); the norm's scale and
// RoPE's k come in x's and q's dtype.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// dtype codes of the C interface: 0 = float32, 1 = bfloat16
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// N values of T at p as f32: 16-byte loads when N values fill whole 16-byte
// pieces (p then lies on the 16-byte grid), else one value at a time.
template <typename T, int N>
__device__ __forceinline__ void load(const T* p, float (&f)[N]) {
  if constexpr ((N * sizeof(T)) % 16 == 0) {
    __align__(16) T buf[N];
#pragma unroll
    for (int c = 0; c < static_cast<int>(N * sizeof(T) / 16); ++c)
      reinterpret_cast<uint4*>(buf)[c] = reinterpret_cast<const uint4*>(p)[c];
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = to_f32(buf[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = to_f32(p[i]);
  }
}

template <typename T, int N>
__device__ __forceinline__ void store(T* p, const T (&v)[N]) {
  if constexpr ((N * sizeof(T)) % 16 == 0) {
#pragma unroll
    for (int c = 0; c < static_cast<int>(N * sizeof(T) / 16); ++c)
      reinterpret_cast<uint4*>(p)[c] = reinterpret_cast<const uint4*>(v)[c];
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = v[i];
  }
}

// The sum of v over the block (blockDim.x a multiple of 32), on every thread.
__device__ float block_sum(float v) {
  __shared__ float warp_sums[32];
  __shared__ float total;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < static_cast<int>(blockDim.x >> 5) ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) total = v;
  }
  __syncthreads();
  return total;
}

// The row's values of vector i as f32: x, or with res, r = round(x + res)
// (written to sum_out when ``keep``).
template <typename T, int VEC>
__device__ __forceinline__ void row_values(const T* x, const T* res, T* sum_out, int64_t at,
                                           bool keep, float (&h)[VEC]) {
  load<T, VEC>(x + at, h);
  if (res == nullptr) return;
  float r[VEC];
  __align__(16) T s[VEC];
  load<T, VEC>(res + at, r);
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    s[j] = from_f32<T>(__fadd_rn(h[j], r[j]));
    h[j] = to_f32(s[j]);
  }
  if (keep) store<T, VEC>(sum_out + at, s);
}

// One block a row of d: out = round(h * rsqrt(mean(h * h) + eps) * scale),
// h = x, or with res, h = r = round(x + res), which is written to sum_out.
template <typename T, int VEC>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ res,
                               T* __restrict__ sum_out, const T* __restrict__ scale,
                               T* __restrict__ out, int d, float eps) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * d;
  const int nvec = d / VEC;
  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    float h[VEC];
    row_values<T, VEC>(x, res, sum_out, base + i * VEC, true, h);
#pragma unroll
    for (int j = 0; j < VEC; ++j) ss = __fadd_rn(ss, __fmul_rn(h[j], h[j]));
  }
  const float mean = __fmul_rn(block_sum(ss), 1.f / static_cast<float>(d));
  const float inv = rsqrtf(__fadd_rn(mean, eps));
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    float h[VEC], sc[VEC];
    __align__(16) T o[VEC];
    row_values<T, VEC>(x, res, sum_out, base + i * VEC, false, h);  // the same values again
    load<T, VEC>(scale + i * VEC, sc);
#pragma unroll
    for (int j = 0; j < VEC; ++j) o[j] = from_f32<T>(__fmul_rn(__fmul_rn(h[j], inv), sc[j]));
    store<T, VEC>(out + base + i * VEC, o);
  }
}

// Token t = blockIdx.x, its pairs split over blockIdx.y; its position is
// pos[(t / inner) * s0 + (t % inner) * s1].
template <typename T, typename P>
__global__ void rope_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            T* __restrict__ q_out, T* __restrict__ k_out,
                            const P* __restrict__ pos, int64_t inner, int64_t s0, int64_t s1,
                            const float* __restrict__ freqs, int hq, int hk, int hd) {
  const int64_t t = blockIdx.x;
  const int half = hd / 2;
  const float p = static_cast<float>(pos[(t / inner) * s0 + (t % inner) * s1]);
  const int pairs = (hq + hk) * half;
  for (int i = blockIdx.y * blockDim.x + threadIdx.x; i < pairs; i += gridDim.y * blockDim.x) {
    const int head = i / half, j = i - head * half;
    const T* src;
    T* dst;
    if (head < hq) {
      src = q + (t * hq + head) * hd;
      dst = q_out + (t * hq + head) * hd;
    } else {
      src = k + (t * hk + head - hq) * hd;
      dst = k_out + (t * hk + head - hq) * hd;
    }
    float s, c;
    sincosf(__fmul_rn(p, freqs[j]), &s, &c);
    const float x1 = to_f32(src[j]), x2 = to_f32(src[j + half]);
    dst[j] = from_f32<T>(__fadd_rn(__fmul_rn(x1, c), -__fmul_rn(x2, s)));
    dst[j + half] = from_f32<T>(__fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s)));
  }
}

template <typename T, int VEC>
__global__ void silu_mul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                                T* __restrict__ out, int64_t nvec) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < nvec;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float av[VEC], bv[VEC];
    __align__(16) T o[VEC];
    load<T, VEC>(a + i * VEC, av);
    load<T, VEC>(b + i * VEC, bv);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const T s = from_f32<T>(__fdiv_rn(av[j], __fadd_rn(1.f, expf(-av[j]))));
      o[j] = from_f32<T>(__fmul_rn(to_f32(s), bv[j]));
    }
    store<T, VEC>(out + i * VEC, o);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int round_up_warps(int64_t n, int max_threads) {
  const int64_t t = (n + 31) / 32 * 32;
  return static_cast<int>(t < 32 ? 32 : (t > max_threads ? max_threads : t));
}

template <typename T>
int rmsnorm_typed(const void* x, const void* res, void* sum_out, const void* scale, void* out,
                  int64_t rows, int d, float eps, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = d % V == 0 && aligned16(x) && aligned16(out) && aligned16(scale) &&
                   (res == nullptr || (aligned16(res) && aligned16(sum_out)));
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(res);
  T* st_out = static_cast<T*>(sum_out);
  const T* sc = static_cast<const T*>(scale);
  T* ot = static_cast<T*>(out);
  if (vec) {
    rmsnorm_kernel<T, V><<<static_cast<unsigned>(rows), round_up_warps(d / V, 1024), 0, st>>>(
        xt, rt, st_out, sc, ot, d, eps);
  } else {
    rmsnorm_kernel<T, 1><<<static_cast<unsigned>(rows), round_up_warps(d, 1024), 0, st>>>(
        xt, rt, st_out, sc, ot, d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int rope_typed(const void* q, const void* k, void* q_out, void* k_out, const void* pos,
               int pos_int64, int64_t rows, int64_t inner, int64_t s0, int64_t s1,
               const void* freqs, int hq, int hk, int hd, cudaStream_t st) {
  const int64_t pairs = static_cast<int64_t>(hq + hk) * (hd / 2);
  const int threads = round_up_warps(pairs, 256);
  const dim3 grid(static_cast<unsigned>(rows),
                  static_cast<unsigned>((pairs + threads - 1) / threads));
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  T* qo = static_cast<T*>(q_out);
  T* ko = static_cast<T*>(k_out);
  const float* f = static_cast<const float*>(freqs);
  if (pos_int64) {
    rope_kernel<T, int64_t><<<grid, threads, 0, st>>>(
        qt, kt, qo, ko, static_cast<const int64_t*>(pos), inner, s0, s1, f, hq, hk, hd);
  } else {
    rope_kernel<T, int32_t><<<grid, threads, 0, st>>>(
        qt, kt, qo, ko, static_cast<const int32_t*>(pos), inner, s0, s1, f, hq, hk, hd);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int silu_mul_typed(const void* a, const void* b, void* out, int64_t n, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kThreads = 256;
  const bool vec = n % V == 0 && aligned16(a) && aligned16(b) && aligned16(out);
  const int64_t nvec = vec ? n / V : n;
  int64_t blocks = (nvec + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (vec) {
    silu_mul_kernel<T, V><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out), nvec);
  } else {
    silu_mul_kernel<T, 1><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out), nvec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows x d contiguous rows of x (and res, sum_out, out); scale [d], all of
// one dtype.  res and sum_out both null, or both given (sum_out = round(x +
// res) is normalised).
extern "C" int rmsnorm_launch(const void* x, const void* res, void* sum_out, const void* scale,
                              void* out, int64_t rows, int d, float eps, int dtype,
                              void* stream) {
  if (rows <= 0) return 0;
  if (d <= 0 || (res == nullptr) != (sum_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return rmsnorm_typed<float>(x, res, sum_out, scale, out, rows, d, eps, st);
    case 1: return rmsnorm_typed<__nv_bfloat16>(x, res, sum_out, scale, out, rows, d, eps, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// q [rows, hq, hd] and k [rows, hk, hd] contiguous, outputs alike; pos int32
// or int64 (pos_int64), read as described at rope_kernel; freqs [hd / 2] f32.
extern "C" int rope_launch(const void* q, const void* k, void* q_out, void* k_out,
                           const void* pos, int pos_int64, int64_t rows, int64_t inner,
                           int64_t s0, int64_t s1, const void* freqs, int hq, int hk, int hd,
                           int dtype, void* stream) {
  if (rows <= 0) return 0;
  if (hd <= 0 || hd % 2 || hq <= 0 || hk <= 0 || inner <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return rope_typed<float>(q, k, q_out, k_out, pos, pos_int64, rows, inner, s0, s1,
                                     freqs, hq, hk, hd, st);
    case 1: return rope_typed<__nv_bfloat16>(q, k, q_out, k_out, pos, pos_int64, rows, inner, s0,
                                             s1, freqs, hq, hk, hd, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// out[i] = round(round(silu(a[i])) * b[i]) over n contiguous elements.
extern "C" int silu_mul_launch(const void* a, const void* b, void* out, int64_t n, int dtype,
                               void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return silu_mul_typed<float>(a, b, out, n, st);
    case 1: return silu_mul_typed<__nv_bfloat16>(a, b, out, n, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

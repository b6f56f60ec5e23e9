// Mamba-2 SSD chunked scan (state-space duality) on Hopper.
//
// Replaces the Pallas kernel `ssd_scan` in
// src/repro/kernels/ssd_scan/kernel.py:87 (pallas_call at :125): per
// (batch, head), walk the sequence in chunks; within a chunk the
// recurrence is attention-like block compute (the l x l decay-masked
// score matrix C.B^T o L, the [l, hd] outputs, the [hd, ns] state
// update), across chunks a running state is carried.  y includes the D
// skip term; the final state is returned in f32.
//
// Translation.  The TPU grid (b, nh, chunks) ran its chunk axis in order
// and kept the state in VMEM scratch.  Here a block walks its chunks in a
// loop and keeps the state in shared memory.  State row p of [hd, ns]
// depends only on column p of x, so the grid is (hd tile, head, batch):
// at b = 1 mamba2-780m puts 2 x 48 blocks in flight instead of 48, and
// each hd tile recomputes its chunk's scores.  Internal chunk: the
// caller's, at most kMaxL = 64 (at ns = 128 and chunk 128 in f32, B, C
// and the scores alone would take 192 KB); the SSD result is the same
// for any chunk length, only the order of the sums changes.  Unlike the
// TPU kernel, which raised unless s divided by the chunk, rows >= s count
// as dt = 0, x = 0 (no decay, no contribution) and write no y.  The
// exponentials are taken only where they are used (j <= i), so the
// upper triangle never overflows to inf: every argument is <= 0.
//
// What bounds it on an H100: operations.  Per head and chunk the SSD
// does ~l*l*ns/2 + l*hd*(l/2 + ns) + hd*ns*l multiply-adds on
// (l*(hd + 2*ns + 1)) inputs, about 70 flops per byte at mamba2 widths,
// against the f32 FMA rate of 67 TFLOP/s (no tensor cores here).
//
// What the design does about it: B, C (rows padded to ns + 1 floats
// against bank conflicts), the raw x tile, dt, the scores and the state
// all sit in shared memory; every inner product reads one operand as a
// warp-wide broadcast and the other conflict-free.  Plain FMA in f32 for
// now: mma.sync / wgmma and register tiling are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxL = 64;    // longest internal chunk
constexpr int kP = 32;       // hd columns per block
constexpr size_t kMaxSmem = 232448;

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

size_t smem_bytes(int l, int ns) {
  const size_t ld = static_cast<size_t>(ns) + 1;
  return sizeof(float) * (2 * l * ld + kP * ld + static_cast<size_t>(l) * l +
                          static_cast<size_t>(l) * kP + 3 * l);
}

template <typename T>
__global__ void ssd_scan_kernel(const T* __restrict__ x,        // [b, s, nh, hd]
                                const float* __restrict__ dt,   // [b, s, nh]
                                const float* __restrict__ a,    // [nh]
                                const float* __restrict__ B,    // [b, s, ns]
                                const float* __restrict__ C,    // [b, s, ns]
                                const float* __restrict__ d_skip,  // [nh]
                                T* __restrict__ y,              // [b, s, nh, hd]
                                float* __restrict__ state_out,  // [b, nh, hd, ns]
                                int s, int nh, int hd, int ns, int l) {
  extern __shared__ float smem[];
  const int p0 = blockIdx.x * kP;
  const int head = blockIdx.y;
  const int bat = blockIdx.z;
  const int np = min(kP, hd - p0);
  const int ld = ns + 1;
  float* bs = smem;            // [l, ns + 1]
  float* cs = bs + l * ld;     // [l, ns + 1]
  float* st = cs + l * ld;     // [kP, ns + 1] running state, rows p0..p0+kP
  float* sc = st + kP * ld;    // [l, l] scores, dt_j folded in
  float* xs = sc + l * l;      // [l, kP] raw x
  float* cum = xs + l * kP;    // [l] in-chunk cumulative log-decay
  float* dts = cum + l;        // [l]
  float* wst = dts + l;        // [l] exp(cum_last - cum_j) * dt_j

  const int tid = threadIdx.x;
  const float av = a[head];
  const float dv = d_skip[head];
  for (int e = tid; e < kP * ld; e += kThreads) st[e] = 0.f;

  const int n_chunks = (s + l - 1) / l;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * l;
    for (int e = tid; e < l * ns; e += kThreads) {
      const int r = e / ns, n = e - r * ns;
      float bv = 0.f, cv = 0.f;
      if (t0 + r < s) {
        const int64_t off = (static_cast<int64_t>(bat) * s + t0 + r) * ns + n;
        bv = B[off];
        cv = C[off];
      }
      bs[r * ld + n] = bv;
      cs[r * ld + n] = cv;
    }
    for (int e = tid; e < l * kP; e += kThreads) {
      const int r = e / kP, p = e - r * kP;
      float xv = 0.f;
      if (t0 + r < s && p < np)
        xv = to_float(x[((static_cast<int64_t>(bat) * s + t0 + r) * nh + head) * hd + p0 + p]);
      xs[e] = xv;
    }
    for (int r = tid; r < l; r += kThreads)
      dts[r] = (t0 + r < s) ? dt[(static_cast<int64_t>(bat) * s + t0 + r) * nh + head] : 0.f;
    __syncthreads();
    if (tid == 0) {  // l <= 64 dependent adds: not worth a parallel scan
      float acc = 0.f;
      for (int r = 0; r < l; ++r) {
        acc += dts[r] * av;
        cum[r] = acc;
      }
    }
    __syncthreads();
    const float c_last = cum[l - 1];
    for (int r = tid; r < l; r += kThreads) wst[r] = expf(c_last - cum[r]) * dts[r];

    // scores[i][j] = (C_i . B_j) * exp(cum_i - cum_j) * dt_j for j <= i, else 0
    for (int e = tid; e < l * l; e += kThreads) {
      const int i = e / l, j = e - i * l;
      float v = 0.f;
      if (j <= i) {
        const float* ci = cs + i * ld;
        const float* bj = bs + j * ld;
        float dot = 0.f;
        for (int n = 0; n < ns; ++n) dot = fmaf(ci[n], bj[n], dot);
        v = dot * expf(cum[i] - cum[j]) * dts[j];
      }
      sc[e] = v;
    }
    __syncthreads();

    // y_i = sum_j scores[i][j] x_j + exp(cum_i) (C_i . state_p) + D x_i
    for (int e = tid; e < l * kP; e += kThreads) {
      const int i = e / kP, p = e - i * kP;
      if (t0 + i >= s || p >= np) continue;
      const float* si = sc + i * l;
      float acc = 0.f;
      for (int j = 0; j <= i; ++j) acc = fmaf(si[j], xs[j * kP + p], acc);
      const float* ci = cs + i * ld;
      const float* sp = st + p * ld;
      float off = 0.f;
      for (int n = 0; n < ns; ++n) off = fmaf(ci[n], sp[n], off);
      const float out = acc + expf(cum[i]) * off + dv * xs[e];
      y[((static_cast<int64_t>(bat) * s + t0 + i) * nh + head) * hd + p0 + p] =
          from_float<T>(out);
    }
    __syncthreads();

    // state' = exp(cum_last) state + sum_j exp(cum_last - cum_j) dt_j x_j^T B_j
    const float decay = expf(c_last);
    for (int e = tid; e < kP * ns; e += kThreads) {
      const int p = e / ns, n = e - p * ns;
      float acc = 0.f;
      for (int j = 0; j < l; ++j) acc = fmaf(wst[j] * xs[j * kP + p], bs[j * ld + n], acc);
      st[p * ld + n] = st[p * ld + n] * decay + acc;
    }
    __syncthreads();
  }

  for (int e = tid; e < kP * ns; e += kThreads) {
    const int p = e / ns, n = e - p * ns;
    if (p < np)
      state_out[((static_cast<int64_t>(bat) * nh + head) * hd + p0 + p) * ns + n] =
          st[p * ld + n];
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* a, const float* B, const float* C,
           const float* d_skip, void* y, float* state, int b, int s, int nh, int hd, int ns,
           int l, cudaStream_t stream) {
  const size_t smem = smem_bytes(l, ns);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = ssd_scan_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((hd + kP - 1) / kP, nh, b);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), dt, a, B, C, d_skip,
                                           static_cast<T*>(y), state, s, nh, hd, ns, l);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y share it; dt, a, B, C,
// d_skip and the state are float32).  chunk: 1..kMaxL.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a, const void* B,
                               const void* C, const void* d_skip, void* y, void* state,
                               int b, int s, int nh, int hd, int ns, int chunk, int dtype,
                               void* stream) {
  if (b <= 0 || nh <= 0 || hd <= 0) return 0;
  if (s <= 0 || ns <= 0 || chunk <= 0 || chunk > kMaxL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int l = s < chunk ? s : chunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f_dt = static_cast<const float*>(dt);
  const float* f_a = static_cast<const float*>(a);
  const float* f_b = static_cast<const float*>(B);
  const float* f_c = static_cast<const float*>(C);
  const float* f_d = static_cast<const float*>(d_skip);
  float* f_st = static_cast<float*>(state);
  if (dtype == 0)
    return launch<float>(x, f_dt, f_a, f_b, f_c, f_d, y, f_st, b, s, nh, hd, ns, l, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, f_dt, f_a, f_b, f_c, f_d, y, f_st, b, s, nh, hd, ns, l,
                                 st);
  return static_cast<int>(cudaErrorInvalidValue);
}

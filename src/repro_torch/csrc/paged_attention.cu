// Paged decode attention on Hopper, split over the context (flash-decoding).
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
// What bounds it on an H100: bytes.  Each (sequence, kv-head) reads
// ctx * d K/V pairs and does 4 * (h/g) * ctx * d flops on them, 2 flops a
// byte in bf16 at Yi-9B's h/g = 8, far below the ~295 where the tensor
// cores would bind.  At Yi-9B decode (b = 3, contexts 104/138/265) a layer
// reads 1 MB, a 0.3 us bound; at b = 8 and 4096 tokens, 67 MB, 20 us.  The
// first port of this kernel ran one block per (kv-head, sequence): 12
// blocks on 132 SMs at b = 3, each walking its pages in order with four
// barriers a page and K/V widened to f32 in shared memory.  It took
// 0.1038 ms, 2.9x the library's attention (H100 80GB HBM3, 700 W): too
// little parallelism and too many serial steps, not bytes.
//
// What the design does about it:
// - The grid is (kv-head x head chunk, sequence, partition).  A partition
//   is `part_pages` pages of the sequence, chosen by the wrapper
//   (kernels/paged_attention/ops.py::partitions) for about four blocks per
//   SM: 132 blocks at Yi-9B b = 3 (one page each), 512 at b = 8 with 4096
//   tokens.  A block whose partition starts at or past ctx exits.
// - In a block, up to 8 query heads of one group share every K/V load;
//   a group of fewer heads masks the rest.  There is one kernel width:
//   Yi-9B, the config this kernel serves on the main path, has h/g = 8,
//   and narrower kernels were never timed.  A key is read by L = d / 8
//   lanes (d in {8, 16, 32, 64, 128}), 8 elements (16 bytes of bf16)
//   each; its dot products with the block's heads are summed over those lanes
//   with xor shuffles.  The block's 128 / L streams of lanes each run
//   their own f32 online softmax over every (128 / L)-th batch of keys
//   (4 keys a batch in bf16, 2 in f32).  Each lane keeps 3 batches in
//   flight: cp.async copies its own 16-byte pieces into its own slots of
//   a ring in shared memory (kept in the input dtype, never widened), and
//   the lane reads back only what it copied, so the key loop has no
//   barrier at all; the partition's block-table entries are copied to
//   shared memory first (one barrier).  All streams run the same trip
//   count, so the shuffles always see the whole warp.  Two barriers at the
//   end merge the streams through shared memory.  At h/g = 8 the loop
//   holds 255 registers a thread, two blocks an SM.
// - With one partition the block writes the output.  Otherwise it writes
//   its partial (m, l, acc in f32, log2 domain) to scratch that the
//   wrapper allocates, and a second small kernel combines the live
//   partitions: out = sum_p acc_p 2^(m_p - M) / max(sum_p l_p 2^(m_p - M),
//   1e-30), M = max_p m_p.  A second launch, rather than the last block to
//   arrive combining through an atomic counter, keeps the kernels free of
//   cross-block synchronisation and of counters that must start at zero,
//   and costs a few microseconds that the timings include.
// - Optionally (lse != nullptr) each head's log-sum-exp of its scaled
//   scores, f32 [b, h], natural log: written by the combine kernel, or by
//   the split kernel itself when there is one partition.  A sequence
//   parallel decode across cards combines its slices' outputs with it
//   (models/attention.py).  One float a (sequence, head) beside the d of
//   the output: at Yi-9B b = 3, 384 bytes a launch.
// - A context of 0 (a rank whose slice holds no key of the sequence) is a
//   contract: out = 0 and lse = -inf, no NaN.  No key is loaded, every
//   stream keeps m = -1e30, l = 0, acc = 0, and the merge gives 0 / 1e-30.
// The merges sum in another order than a single pass; the results stay
// within the f32 (2e-4) and bf16 (2e-2) tolerances of the plain version.
// The wrapper models this design (heads a block, key batches, the
// partition rule); paged_attention_design() reports the constants it
// depends on, and the wrapper refuses to launch when they differ.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxHeads = 8;     // query heads per block (ops.py::HEADS_PER_BLOCK)
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kWritesLse = 1;    // the interface takes an lse output (ops.py::DESIGN)

constexpr int kStages = 3;       // key batches a lane has in flight, in shared memory
constexpr int kMaxPartPages = 1024;  // ops.py::MAX_PART_PAGES (the table's shared copy)
template <typename T>
constexpr int kKeyBatch = sizeof(T) == 2 ? 4 : 2;  // keys a stream loads (ops.py::KEY_BATCH)

// 8 consecutive elements of a row: 16 bytes of bf16, 32 of f32
template <typename T>
struct Vec8;
template <>
struct Vec8<float> {
  static constexpr int kPieces = 2;  // 16-byte pieces
  float4 a, b;
  __device__ __forceinline__ void load(const uint4* p, int stride) {
    a = *reinterpret_cast<const float4*>(p);
    b = *reinterpret_cast<const float4*>(p + stride);
  }
  __device__ __forceinline__ void zero() { a = b = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ float operator[](int i) const {
    const float x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    return x[i];
  }
};
template <>
struct Vec8<__nv_bfloat16> {
  static constexpr int kPieces = 1;
  uint4 a;
  __device__ __forceinline__ void load(const uint4* p, int) { a = *p; }
  __device__ __forceinline__ void zero() { a = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ float operator[](int i) const {
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
    const uint32_t x = w[i >> 1];
    return __uint_as_float((i & 1) ? (x & 0xffff0000u) : (x << 16));  // bf16 -> f32
  }
};

// 16 bytes global -> shared, zero-filled (nothing read) when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 2^x (ex2.approx: relative error below 2^-22)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <typename T>
__host__ __device__ constexpr int ring_bytes(int nb) {
  return kStages * nb * 2 * Vec8<T>::kPieces * kThreads * 16;
}

// natural-log lse from the log2-domain max and sum; -inf for no key
__device__ __forceinline__ float lse_of(float m_log2, float l) {
  return l > 0.f ? (m_log2 + log2f(l)) * kLn2 : __int_as_float(0xff800000u);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
paged_attention_split_kernel(const T* __restrict__ q,        // [b, h, d]
                             const T* __restrict__ k_pages,  // [b, per_seq, bs, g, d]
                             const T* __restrict__ v_pages,
                             const int32_t* __restrict__ block_tables,  // [b, per_seq]
                             const int32_t* __restrict__ context_lens,  // [b]
                             T* __restrict__ out,            // [b, h, d]
                             float* __restrict__ lse,        // [b, h] or null
                             float* __restrict__ part_ml,    // [b, h, n_part, 2]
                             float* __restrict__ part_acc,   // [b, h, n_part, d]
                             int h, int g, int per_seq, int bs, int part_pages, int n_part,
                             float scale_log2) {
  constexpr int D = 8 * L;
  constexpr int NG = kThreads / L;  // streams of lanes in the block
  constexpr int NB = kKeyBatch<T>;
  __shared__ float m_s[NG][kMaxHeads];   // each stream's max, then its weight
  __shared__ float l_s[NG][kMaxHeads];
  __shared__ __align__(16) float a_s[NG][kMaxHeads][D];
  __shared__ float mt_s[kMaxHeads], lt_s[kMaxHeads];

  const int qpg = h / g;
  const int chunks = (qpg + kMaxHeads - 1) / kMaxHeads;
  const int kvh = blockIdx.x / chunks;
  const int h0 = kvh * qpg + (blockIdx.x % chunks) * kMaxHeads;  // the block's first head
  const int nq = min(kMaxHeads, kvh * qpg + qpg - h0);
  const int seq = blockIdx.y;
  const int part = blockIdx.z;
  const int ctx = context_lens[seq];
  const int tok0 = part * part_pages * bs;
  if (part > 0 && tok0 >= ctx) return;  // an empty trailing partition: never combined
  const int n_keys = max(0, min(min(part_pages * bs, ctx - tok0), per_seq * bs - tok0));

  const int li = threadIdx.x % L;
  const int st = threadIdx.x / L;
  // the partition's block-table entries, then a ring of kStages key
  // batches per lane: each lane copies and reads only its own slots
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* ring = reinterpret_cast<uint4*>(smem_raw);
  int32_t* tbl_s = reinterpret_cast<int32_t*>(smem_raw + ring_bytes<T>(NB));
  const int page0 = part * part_pages;
  const int n_pages = min(part_pages, per_seq - page0);
  for (int i = threadIdx.x; i < n_pages; i += kThreads)
    tbl_s[i] = block_tables[static_cast<int64_t>(seq) * per_seq + page0 + i];
  __syncthreads();

  constexpr int P = Vec8<T>::kPieces;
  const int64_t seq_row0 = static_cast<int64_t>(seq) * per_seq;
  // every stream runs the same trip count (the shuffles need the whole
  // warp); keys at or past n_keys are zero-filled and masked
  const int n_iter = (n_keys + NG * NB - 1) / (NG * NB);
  auto issue = [&](int it) {
    uint4* stage = ring + (it % kStages) * NB * 2 * P * kThreads;
    const int base = (it * NG + st) * NB;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const bool ok = base + j < n_keys;
      const int pos = ok ? base + j : 0;  // within the partition
      const int64_t row = (seq_row0 + tbl_s[pos / bs]) * bs + pos % bs;
      const int64_t off = (row * g + kvh) * D + li * 8;
#pragma unroll
      for (int u = 0; u < P; ++u) {
        cp_async16(stage + ((2 * j) * P + u) * kThreads + threadIdx.x,
                   k_pages + off + u * (16 / sizeof(T)), ok);
        cp_async16(stage + ((2 * j + 1) * P + u) * kThreads + threadIdx.x,
                   v_pages + off + u * (16 / sizeof(T)), ok);
      }
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_iter) issue(i);
    cp_async_commit();
  }

  float qv[kMaxHeads][8];
#pragma unroll
  for (int hh = 0; hh < kMaxHeads; ++hh) {
    const T* qp = q + (static_cast<int64_t>(seq) * h + h0 + min(hh, nq - 1)) * D + li * 8;
#pragma unroll
    for (int e = 0; e < 8; ++e) qv[hh][e] = hh < nq ? to_float(qp[e]) * scale_log2 : 0.f;
  }
  float m[kMaxHeads], l[kMaxHeads], acc[kMaxHeads][8];
#pragma unroll
  for (int hh = 0; hh < kMaxHeads; ++hh) {
    m[hh] = kNegInf;
    l[hh] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[hh][e] = 0.f;
  }

  for (int it = 0; it < n_iter; ++it) {
    if (it + kStages - 1 < n_iter) issue(it + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this lane's copies of batch it have landed
    const uint4* stage = ring + (it % kStages) * NB * 2 * P * kThreads + threadIdx.x;
    const int base = (it * NG + st) * NB;
    Vec8<T> kr[NB], vr[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      kr[j].load(stage + (2 * j) * P * kThreads, kThreads);
      vr[j].load(stage + (2 * j + 1) * P * kThreads, kThreads);
    }
    float sc[NB][kMaxHeads];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int hh = 0; hh < kMaxHeads; ++hh) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) dot = fmaf(qv[hh][e], kr[j][e], dot);
        sc[j][hh] = dot;
      }
    }
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int j = 0; j < NB; ++j) {
#pragma unroll
        for (int hh = 0; hh < kMaxHeads; ++hh)
          sc[j][hh] += __shfl_xor_sync(0xffffffffu, sc[j][hh], o);
      }
    }
#pragma unroll
    for (int hh = 0; hh < kMaxHeads; ++hh) {
      float mb = kNegInf;
#pragma unroll
      for (int j = 0; j < NB; ++j)
        if (base + j < n_keys) mb = fmaxf(mb, sc[j][hh]);
      const float mn = fmaxf(m[hh], mb);
      const float corr = ex2(m[hh] - mn);
      m[hh] = mn;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        sc[j][hh] = base + j < n_keys ? ex2(sc[j][hh] - mn) : 0.f;
        sum += sc[j][hh];
      }
      l[hh] = l[hh] * corr + sum;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[hh][e] *= corr;
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float x = vr[j][e];
#pragma unroll
        for (int hh = 0; hh < kMaxHeads; ++hh) acc[hh][e] = fmaf(sc[j][hh], x, acc[hh][e]);
      }
    }
  }
  cp_async_wait<0>();

  // merge the block's streams: weight 2^(m_stream - M) per head
#pragma unroll
  for (int hh = 0; hh < kMaxHeads; ++hh) {
    if (li == 0) {
      m_s[st][hh] = m[hh];
      l_s[st][hh] = l[hh];
    }
    float4* dst = reinterpret_cast<float4*>(&a_s[st][hh][li * 8]);
    dst[0] = make_float4(acc[hh][0], acc[hh][1], acc[hh][2], acc[hh][3]);
    dst[1] = make_float4(acc[hh][4], acc[hh][5], acc[hh][6], acc[hh][7]);
  }
  __syncthreads();
  if (threadIdx.x < nq) {
    const int hh = threadIdx.x;
    float mx = kNegInf;
    for (int i = 0; i < NG; ++i) mx = fmaxf(mx, m_s[i][hh]);
    float tot = 0.f;
    for (int i = 0; i < NG; ++i) {
      const float w = ex2(m_s[i][hh] - mx);
      m_s[i][hh] = w;
      tot += l_s[i][hh] * w;
    }
    mt_s[hh] = mx;
    lt_s[hh] = tot;
  }
  __syncthreads();
  for (int o = threadIdx.x; o < nq * D; o += kThreads) {
    const int hh = o / D, jj = o - hh * D;
    float a = 0.f;
    for (int i = 0; i < NG; ++i) a = fmaf(a_s[i][hh][jj], m_s[i][hh], a);
    const int64_t head_row = static_cast<int64_t>(seq) * h + h0 + hh;
    if (n_part == 1) {
      store(out + head_row * D + jj, a / fmaxf(lt_s[hh], 1e-30f));
      if (lse && jj == 0) lse[head_row] = lse_of(mt_s[hh], lt_s[hh]);
    } else {
      const int64_t p = head_row * n_part + part;
      part_acc[p * D + jj] = a;
      if (jj == 0) {
        part_ml[2 * p] = mt_s[hh];
        part_ml[2 * p + 1] = lt_s[hh];
      }
    }
  }
}

// One block per (head, sequence), one thread per output column: combine the
// partitions that start below ctx.
template <typename T>
__global__ void paged_attention_combine_kernel(const float* __restrict__ part_ml,
                                               const float* __restrict__ part_acc,
                                               const int32_t* __restrict__ context_lens,
                                               T* __restrict__ out, float* __restrict__ lse,
                                               int h, int d, int n_part,
                                               int part_tokens) {
  const int head = blockIdx.x, seq = blockIdx.y, jj = threadIdx.x;
  const int ctx = context_lens[seq];
  const int live = min(n_part, max(1, (ctx + part_tokens - 1) / part_tokens));
  const int64_t head_row = static_cast<int64_t>(seq) * h + head;
  const float* ml = part_ml + head_row * n_part * 2;
  const float* acc = part_acc + head_row * n_part * d;
  float mx = kNegInf;
  for (int p = 0; p < live; ++p) mx = fmaxf(mx, ml[2 * p]);
  float tot = 0.f, a = 0.f;
  for (int p = 0; p < live; ++p) {
    const float w = ex2(ml[2 * p] - mx);
    tot += ml[2 * p + 1] * w;
    a = fmaf(acc[static_cast<int64_t>(p) * d + jj], w, a);
  }
  store(out + head_row * d + jj, a / fmaxf(tot, 1e-30f));
  if (lse && jj == 0) lse[head_row] = lse_of(mx, tot);
}

template <typename T, int L>
int launch_split(const void* q, const void* k, const void* v, const void* tables,
                 const void* ctx, void* out, void* lse, void* part_ml, void* part_acc, int b,
                 int h, int g, int per_seq, int bs, int part_pages, int n_part, float scale,
                 int* grid_out, cudaStream_t stream) {
  const int chunks = (h / g + kMaxHeads - 1) / kMaxHeads;
  const size_t smem = ring_bytes<T>(kKeyBatch<T>) + sizeof(int32_t) * part_pages;
  auto kernel = paged_attention_split_kernel<T, L>;
  cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (set != cudaSuccess) return static_cast<int>(set);
  dim3 grid(g * chunks, b, n_part);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(tables), static_cast<const int32_t*>(ctx),
      static_cast<T*>(out), static_cast<float*>(lse), static_cast<float*>(part_ml),
      static_cast<float*>(part_acc), h, g, per_seq, bs, part_pages, n_part,
      scale * 1.4426950408889634f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  grid_out[0] = grid.x;
  grid_out[1] = grid.y;
  grid_out[2] = grid.z;
  if (n_part == 1) return 0;
  paged_attention_combine_kernel<T><<<dim3(h, b), 8 * L, 0, stream>>>(
      static_cast<const float*>(part_ml), static_cast<const float*>(part_acc),
      static_cast<const int32_t*>(ctx), static_cast<T*>(out), static_cast<float*>(lse), h,
      8 * L, n_part, part_pages * bs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v, const void* tables,
             const void* ctx, void* out, void* lse, void* part_ml, void* part_acc, int b, int h,
             int g, int per_seq, int bs, int part_pages, int n_part, float scale, int* grid_out,
             cudaStream_t s) {
#define PA_CASE(D)                                                                       \
  case D:                                                                                \
    return launch_split<T, D / 8>(q, k, v, tables, ctx, out, lse, part_ml, part_acc, b, h, \
                                  g, per_seq, bs, part_pages, n_part, scale, grid_out, s);
  switch (d) {
    PA_CASE(8)
    PA_CASE(16)
    PA_CASE(32)
    PA_CASE(64)
    PA_CASE(128)
  }
#undef PA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The design the wrapper models (kernels/paged_attention/ops.py checks it
// against its own constants before the first launch): threads a block,
// query heads a block, keys a stream loads at once in f32 and in bf16,
// most pages a partition, and 1 for the lse output the interface takes.
// Returns how many values it wrote.
extern "C" int paged_attention_design(int* out, int n) {
  const int v[] = {kThreads, kMaxHeads, kKeyBatch<float>, kKeyBatch<__nv_bfloat16>,
                   kMaxPartPages, kWritesLse};
  const int m = static_cast<int>(sizeof(v) / sizeof(v[0]));
  for (int i = 0; i < m && i < n; ++i) out[i] = v[i];
  return m;
}

// dtype: 0 = float32, 1 = bfloat16 (q, pages and out share it); d in
// {8, 16, 32, 64, 128}.  lse [b, h] f32 is written when not null.
// part_ml [b, h, n_part, 2] and part_acc
// [b, h, n_part, d] (f32) are scratch, unused when n_part == 1.  The grid
// the split kernel launched is written to grid_out[3].
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages, const void* block_tables,
                                      const void* context_lens, void* out, void* lse,
                                      void* part_ml, void* part_acc, int b, int h, int g, int d,
                                      int per_seq, int bs, int part_pages, int n_part,
                                      float scale, int dtype, int* grid_out, void* stream) {
  if (b <= 0) return 0;
  if (g <= 0 || h % g != 0 || per_seq <= 0 || bs <= 0 || part_pages <= 0 || n_part <= 0 ||
      part_pages > kMaxPartPages || (n_part - 1) * part_pages >= per_seq ||
      (n_part > 1 && (!part_ml || !part_acc)) || !grid_out)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(d, q, k_pages, v_pages, block_tables, context_lens, out, lse,
                           part_ml, part_acc, b, h, g, per_seq, bs, part_pages, n_part, scale,
                           grid_out, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(d, q, k_pages, v_pages, block_tables, context_lens, out,
                                   lse, part_ml, part_acc, b, h, g, per_seq, bs, part_pages,
                                   n_part, scale, grid_out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

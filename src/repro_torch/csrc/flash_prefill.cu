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
// What bounds it on an H100: at Yi-9B widths (32 heads x 128) a 257-token
// prompt is 4 * h * d * s(s+1)/2 = 0.54 GFLOP and 1.4 MB of q/k/v/out, a
// 1.4 us byte bound; at 4096 tokens it is bound by operations (137 GFLOP,
// 0.139 ms at 989 TFLOP/s).  The first port of this kernel did every
// product with scalar f32 FMA over shared memory (32 x 32 tiles, four
// barriers per k tile) and ran at about 200x its bound, no faster than its
// own plain version (0.2766 ms at s = 257, H100 80GB HBM3, 700 W): the
// arithmetic, not launch latency, was the cost.
//
// What the design does about it (bf16, the serving dtype): the products run
// on the tensor cores with warp-level mma.sync.m16n8k16 (bf16 in, f32
// accumulate), as FlashAttention-2 does.  One block of 4 warps takes a
// 64-row q tile of one head; each warp owns 16 rows and holds their Q
// fragments in registers for the whole k loop.  64-row K and V tiles stay
// bf16 in shared memory (rows padded by 8 elements, so the 8 row addresses
// of an ldmatrix hit 8 different bank groups), double-buffered with
// cp.async so that the next tile's load overlaps this tile's products: one
// barrier per k tile.  Q is staged in K's second buffer, which its first
// fill overwrites only after every warp holds its fragments, so a block
// takes four tiles of shared memory (69.6 KB at d = 128) and three blocks
// fit on an SM; the launch bounds hold registers to 168 for that (d = 128
// spills a few dozen bytes a thread).  Each thread copies the same 16-byte
// column of the same rows of every tile, so a tile's copies cost a few
// instructions each: at one or two warps a scheduler the loop is bound by
// instruction latency, not by the tensor cores.  Whole tiles (away from
// the diagonal, the window's edge and the ragged ends) skip the
// per-element mask, and the scale rides in the FFMA before ex2.approx.
// S = Q K^T comes out in the mma accumulator layout;
// the online softmax (m and l per row, f32) reduces across the quad of
// lanes that share a row with two shuffles; P is rounded to bf16 in
// registers and fed straight back as the A operand of P V (dense_ref also
// casts the softmax weights to v's dtype before that product).  GQA stays
// one head per block: packing the h/g heads of a group into the 64 rows
// would not change the ratio of shared-memory loads to tensor-core work
// per block, and the L2 cache (50 MB) already serves the group's re-reads
// of the same K/V tile.  Visited k tiles follow
// kernels/flash_prefill/ops.py::k_tiles (causal limit, window, prefix);
// partly masked tiles mask per element, rows and keys past s and t too.
// Blocks of the last q tiles, which visit the most k tiles, start first.
//
// f32 calls keep the first, scalar kernel (f32 FMA, 32 x 32 tiles): TF32
// tensor cores keep about three decimal digits, which would break the
// 2e-4 tolerance of the f32 checks and the f32 consistency checks that run
// models through this kernel.  It stays the right-first design for f32;
// a bf16 call never reaches it.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- f32
constexpr int kThreads = 128;
constexpr int kBQ = 32;
constexpr int kBK = 32;      // one key per lane in the softmax
constexpr int kMaxD = 128;
constexpr int kAccPerThread = kBQ * kMaxD / kThreads;
constexpr float kNegInf = -1e30f;

__global__ void flash_prefill_f32_kernel(const float* __restrict__ q,  // [b, s, h, d]
                                         const float* __restrict__ k,  // [b, t, g, d]
                                         const float* __restrict__ v,
                                         float* __restrict__ out,      // [b, s, h, d]
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
    if (r < q_rows) x = q[((static_cast<int64_t>(bat) * s + q_lo + r) * h + head) * d + j];
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
        kx = k[src];
        vx = v[src];
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
            acc[i] / fmaxf(l_s[r], 1e-30f);
    }
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* out, int b, int s, int t,
               int h, int g, int d, int causal, int window, int prefix, float scale,
               cudaStream_t stream) {
  if (d > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(kBQ) * d + static_cast<size_t>(kBK) * (d + 1) +
       static_cast<size_t>(kBK) * d + kBQ * kBK + 3 * kBQ);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((s + kBQ - 1) / kBQ, h, b);
  flash_prefill_f32_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), s, t, h, g, d, causal, window,
      prefix, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- bf16
constexpr int kTile = 64;    // q rows and k rows of a tile (ops.py::BF16_TILE)
constexpr int kPad = 8;      // bf16 elements of padding per shared-memory row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (nothing read) when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a (16 x 16, row) * b (16 x 8, col); bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x (ex2.approx: relative error below 2^-22; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

// mma fragment layout (PTX ISA, m16n8k16): lane = 4 * group + quad; an
// accumulator holds rows group and group + 8, columns 2 * quad and
// 2 * quad + 1 of its 16 x 8 tile, as c[0], c[1] (row group) and c[2],
// c[3] (row group + 8).
template <int D>
__global__ void __launch_bounds__(128, 3)
flash_prefill_bf16_kernel(const __nv_bfloat16* __restrict__ q,  // [b, s, h, D]
                          const __nv_bfloat16* __restrict__ k,  // [b, t, g, D]
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ out,      // [b, s, h, D]
                          int s, int t, int h, int g, int causal, int window, int prefix,
                          float scale_log2) {
  constexpr int LD = D + kPad;
  constexpr int CPR = D / 8;          // 16-byte chunks per row
  constexpr int NKB = kTile / 8;      // 8-key blocks of S per k tile
  constexpr int NDB = D / 8;          // 8-column blocks of O
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][kTile][LD]
  __nv_bfloat16* vs = ks + 2 * kTile * LD;                          // [2][kTile][LD]
  __nv_bfloat16* qs = ks + kTile * LD;  // Q in K's second buffer: read before its first fill

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest k loops first
  const int head = blockIdx.y;
  const int bat = blockIdx.z;
  const int kvh = head / (h / g);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q_lo = qt * kTile;
  const int q_rows = min(kTile, s - q_lo);

  // the k tiles this q tile visits: [0, n_pref) and [j0, n_kt), as k_tiles
  int n_kt = (t + kTile - 1) / kTile;
  if (causal) n_kt = min(n_kt, (q_lo + q_rows - 1) / kTile + 1);
  int n_pref = 0, j0 = 0;
  if (window) {
    n_pref = prefix > 0 ? (prefix + kTile - 1) / kTile : 0;
    const int x = q_lo - window - kTile + 1;  // tiles j <= x / kTile lie fully out
    j0 = x >= 0 ? x / kTile + 1 : 0;
  }
  auto next_tile = [&](int j) {
    ++j;
    return (j >= n_pref && j < j0) ? j0 : j;
  };

  // a thread copies the same 16-byte column of rows r0, r0 + RPI, ... of
  // every tile: only the tile's base moves
  constexpr int RPI = 128 / CPR;      // rows a pass of the block covers
  const int r0 = tid / CPR, col = (tid % CPR) * 8;
  const int64_t q_row0 = static_cast<int64_t>(bat) * s;
  const __nv_bfloat16* q0 = q + (q_row0 * h + head) * D + col;  // row 0 of this batch
#pragma unroll
  for (int i = 0; i < kTile / RPI; ++i) {
    const int r = r0 + i * RPI;
    const bool ok = r < q_rows;
    cp_async16(qs + r * LD + col, ok ? q0 + static_cast<int64_t>(q_lo + r) * h * D : q0, ok);
  }
  const int64_t k_row0 = static_cast<int64_t>(bat) * t;
  const int64_t k_stride = static_cast<int64_t>(g) * D;  // one key row
  const __nv_bfloat16* k0 = k + k_row0 * k_stride + kvh * D + col;  // key 0 of this batch
  const __nv_bfloat16* v0 = v + k_row0 * k_stride + kvh * D + col;
  auto load_kv = [&](int j, int buf) {
    __nv_bfloat16* kd = ks + buf * kTile * LD + r0 * LD + col;
    __nv_bfloat16* vd = vs + buf * kTile * LD + r0 * LD + col;
    const int key0 = j * kTile + r0;
#pragma unroll
    for (int i = 0; i < kTile / RPI; ++i) {
      const bool ok = key0 + i * RPI < t;
      const int64_t off = ok ? (key0 + i * RPI) * k_stride : 0;
      cp_async16(kd + i * RPI * LD, k0 + off, ok);
      cp_async16(vd + i * RPI * LD, v0 + off, ok);
    }
  };

  int j = next_tile(-1);
  if (j < n_kt) load_kv(j, 0);
  cp_async_commit();

  const int grp = lane >> 2, quad = lane & 3;
  const int row0 = q_lo + warp * 16 + grp;  // this thread's two q rows
  const int row1 = row0 + 8;
  uint32_t qf[D / 16][4];
  float o[NDB][4];
#pragma unroll
  for (int i = 0; i < NDB; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  // Q fragments for this warp's 16 rows (before any k tile: there may be none)
  cp_async_wait_all();
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);

  for (int buf = 0; j < n_kt; buf ^= 1) {
    const int jn = next_tile(j);
    cp_async_wait_all();
    __syncthreads();  // tile j landed; every warp is done with buffer buf ^ 1
    if (jn < n_kt) load_kv(jn, buf ^ 1);
    cp_async_commit();

    // S = Q K^T (16 x 64 per warp), f32 accumulators
    const __nv_bfloat16* kb = ks + buf * kTile * LD;
    float sc[NKB][4];
#pragma unroll
    for (int i = 0; i < NKB; ++i) sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nb = 0; nb < NKB / 2; ++nb) {
        uint32_t b[4];
        ldmatrix_x4(b, kb + (nb * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                           ((lane >> 3) & 1) * 8);
        mma_bf16(sc[2 * nb], qf[kk], b[0], b[1]);
        mma_bf16(sc[2 * nb + 1], qf[kk], b[2], b[3]);
      }
    }

    // mask per element, unless every key of the tile is visible to every
    // row of this warp (the usual case away from the diagonal and the edges)
    const int w_lo = q_lo + warp * 16;
    const int k_lo = j * kTile, k_hi = k_lo + kTile - 1;
    bool whole = k_hi < t;
    if (causal) whole = whole && k_hi <= w_lo;
    if (window) whole = whole && (k_lo > w_lo + 15 - window || k_hi < prefix);
    if (!whole) {
#pragma unroll
      for (int nb = 0; nb < NKB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k_lo + nb * 8 + quad * 2 + (e & 1);
          const int qi = e < 2 ? row0 : row1;
          bool ok = kj < t;
          if (causal) ok = ok && kj <= qi;
          if (window) ok = ok && (kj > qi - window || kj < prefix);
          if (!ok) sc[nb][e] = -INFINITY;
        }
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < NKB; ++nb) {
      mx0 = fmaxf(mx0, fmaxf(sc[nb][0], sc[nb][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[nb][2], sc[nb][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));

    // online softmax on the raw scores, scaled inside the exponent's FFMA;
    // a row with nothing visible yet keeps m = -inf and p = 0
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float mu0 = (mn0 == -INFINITY ? 0.f : mn0) * scale_log2;
    const float mu1 = (mn1 == -INFINITY ? 0.f : mn1) * scale_log2;
    const float c0 = ex2(fmaf(m0, scale_log2, -mu0)), c1 = ex2(fmaf(m1, scale_log2, -mu1));
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nb = 0; nb < NKB; ++nb) {
      sc[nb][0] = ex2(fmaf(sc[nb][0], scale_log2, -mu0));
      sc[nb][1] = ex2(fmaf(sc[nb][1], scale_log2, -mu0));
      sc[nb][2] = ex2(fmaf(sc[nb][2], scale_log2, -mu1));
      sc[nb][3] = ex2(fmaf(sc[nb][3], scale_log2, -mu1));
      sum0 += sc[nb][0] + sc[nb][1];
      sum1 += sc[nb][2] + sc[nb][3];
    }
    l0 = l0 * c0 + sum0;  // this lane's share; the quad is summed at the end
    l1 = l1 * c1 + sum1;
#pragma unroll
    for (int i = 0; i < NDB; ++i) {
      o[i][0] *= c0;
      o[i][1] *= c0;
      o[i][2] *= c1;
      o[i][3] *= c1;
    }

    // O += P V: P (bf16) straight from the S accumulators as the A operand
    const __nv_bfloat16* vb = vs + buf * kTile * LD;
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                             pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                             pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                             pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int nd = 0; nd < NDB / 2; ++nd) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vb + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                 nd * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * nd], a, b[0], b[1]);
        mma_bf16(o[2 * nd + 1], a, b[2], b[3]);
      }
    }
    j = jn;
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int i = 0; i < NDB; ++i) {
    const int col = i * 8 + quad * 2;
    if (row0 < q_lo + q_rows)
      *reinterpret_cast<__nv_bfloat162*>(out + ((q_row0 + row0) * h + head) * D + col) =
          __floats2bfloat162_rn(o[i][0] * inv0, o[i][1] * inv0);
    if (row1 < q_lo + q_rows)
      *reinterpret_cast<__nv_bfloat162*>(out + ((q_row0 + row1) * h + head) * D + col) =
          __floats2bfloat162_rn(o[i][2] * inv1, o[i][3] * inv1);
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int b, int s, int t,
                int h, int g, int causal, int window, int prefix, float scale,
                cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * 4 * kTile * (D + kPad);
  auto kernel = flash_prefill_bf16_kernel<D>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((s + kTile - 1) / kTile, h, b);
  kernel<<<grid, 128, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), s, t, h, g,
      causal, window, prefix, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The tiles the wrapper models (kernels/flash_prefill/ops.py::k_tiles,
// checked against these before the first launch): the f32 kernel's q and k
// tile rows, the bf16 kernel's tile rows, the f32 kernel's largest d.
// Returns how many values it wrote.
extern "C" int flash_prefill_design(int* out, int n) {
  const int v[] = {kBQ, kBK, kTile, kMaxD};
  const int m = static_cast<int>(sizeof(v) / sizeof(v[0]));
  for (int i = 0; i < m && i < n; ++i) out[i] = v[i];
  return m;
}

// dtype: 0 = float32 (scalar kernel, d <= 128), 1 = bfloat16 (tensor-core
// kernel, d in {32, 64, 128}); q, k, v and out share it.
extern "C" int flash_prefill_launch(const void* q, const void* k, const void* v,
                                    void* out, int b, int s, int t, int h, int g, int d,
                                    int causal, int window, int prefix, float scale,
                                    int dtype, void* stream) {
  if (b <= 0 || s <= 0) return 0;
  if (g <= 0 || h % g != 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(q, k, v, out, b, s, t, h, g, d, causal, window, prefix, scale, st);
  if (dtype == 1) {
    switch (d) {
      case 32:
        return launch_bf16<32>(q, k, v, out, b, s, t, h, g, causal, window, prefix, scale, st);
      case 64:
        return launch_bf16<64>(q, k, v, out, b, s, t, h, g, causal, window, prefix, scale, st);
      case 128:
        return launch_bf16<128>(q, k, v, out, b, s, t, h, g, causal, window, prefix, scale,
                                st);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

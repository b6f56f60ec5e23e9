// Mamba-2 SSD chunked scan (state-space duality) on Hopper's tensor cores.
//
// Replaces the Pallas kernel `ssd_scan` in
// src/repro/kernels/ssd_scan/kernel.py:87 (pallas_call at :125): within a
// chunk the recurrence is attention-like block compute (the l x l
// decay-masked score matrix C.B^T o L, the [l, hd] outputs, the [hd, ns]
// chunk state), across chunks a state is carried.  y includes the D skip
// term; the final state is returned in f32.
//
// Translation.  The TPU grid (b, nh, chunks) ran its chunk axis in order
// and kept the state in VMEM scratch.  Blocks on the card run in no
// order, so the chunk loop is split the way Mamba-2's GPU implementation
// splits it (ssd_combined: chunk cumsum, chunk state, state passing, chunk
// scan) into four steps, three launches of one C entry:
//   1. C.B^T, in the grid of step 2 (it needs nothing step 2 makes), one
//      block a (chunk, 16-row tile): CB = C.B^T of the chunk once for
//      every head (B and C are shared: one group);
//   2. ssd_state_kernel, grid (hd tile x chunk, head, batch): the head's
//      cumulative log-decay over the chunk, cum_i = sum_{r<=i} dt_r a, as
//      a warp scan, and the chunk's own state
//      S_c = sum_j exp(cum_last - cum_j) dt_j x_j^T B_j into f32 scratch;
//   3. ssd_pass_kernel, grid (element block, head, batch): serial over
//      chunks but elementwise, prior_c = carry; carry = carry
//      exp(cum_last,c) + S_c, the prior written over S_c; the final carry
//      is the returned state;
//   4. ssd_out_kernel, grid (hd tile x chunk, head, batch):
//      y = (CB o L o dt) x + exp(cum) (C prior^T) + D x.
// At mamba2-780m's s = 257 steps 2 and 4 put 5 x 48 = 240 blocks on the
// card (hymba-1.5b's s = 1328: 21 x 50 = 1050) where one block used to walk
// every chunk of a head in a row.  Internal chunk: the caller's, at most
// kMaxL = 64 rows, the rows of every tile; the SSD result is the same for
// any chunk length, only the order of the sums changes.  Unlike the TPU
// kernel, which raised unless s divided by the chunk, rows >= s count as
// dt = 0, x = 0 (no decay, no contribution) and write no y.  Every
// exponential is taken only where it is used (j <= i) and of an argument
// clamped to <= 0 (the scan's sums need not be monotone to the last bit),
// so none overflows.
//
// What bounds it on an H100: at mamba2 widths (48 heads x 64, ns = 128,
// s = 257) about 0.5 GFLOP on 8.2 MB of inputs and outputs, a 2.4 us
// byte bound at 3.35 TB/s (1 us of operations at 495 TFLOP/s TF32); the
// split adds the chunk states' round trips through scratch (7.9 MB a
// chunk pass at mamba2 widths, mostly in L2).  The first port of this
// kernel did every product with scalar FMA from shared memory, recomputed
// C.B^T in every head and hd tile, and walked the chunks of a head in one
// block: 0.2677 ms (H100 80GB HBM3, 700 W).
//
// What the design does about it: every product runs on the tensor cores
// as mma.sync.m16n8k8 TF32 with f32 accumulation.  TF32 keeps 10 mantissa
// bits, which alone gives about 7e-4 at mamba2 widths, so f32 operands
// are split a = hi + lo (both TF32) and a b ~ hi hi + hi lo + lo hi
// (3xTF32, f32 accuracy); a bf16 x is exact in TF32 and takes no split on
// its side.  Each block has 4 warps; a warp owns a 16-row m tile (in step
// 1, two 8-column tiles of one) and keeps its accumulators in registers.
// What made the difference on the card, in order: tiles move into shared
// memory as 16-byte cp.async pieces, all of a block's in flight at once
// (scalar loads with a few in flight a thread cost each step 10-40 us);
// tile counts are compile-time, so that no mma.sync is predicated (each
// predicated one costs a WARPSYNC and a NOP) and the padding of every tile
// is zero instead; the split takes 4 integer and float instructions, not
// cvt.rna.tf32.f32 (about 10, it tests for infinities); each 3xTF32 term is
// issued for all n tiles before the next term, so no product waits on the
// one before it; results leave through shared memory as whole rows of
// 16-byte stores; step 4 runs C prior^T while the CB and x tiles still
// load.  Rows of every shared tile are padded so that each fragment load
// is conflict-free (strides = 4 mod 32 for tiles read along their rows,
// = 8 mod 32 along their columns).  Only the k tiles at or below the
// diagonal of the causal products run.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

#include <type_traits>

namespace {

constexpr int kThreads = 128;  // 4 warps, one 16-row m tile each
constexpr int kWarps = kThreads / 32;
constexpr int kMaxL = 64;      // longest internal chunk: the rows of every tile
constexpr int kP = 64;         // hd columns per block (steps 2 and 4)
constexpr int kNS = 128;       // state columns per block (step 2)
constexpr int kGroup = 8;      // n tiles whose products issue together
constexpr int kPassThreads = 256;
constexpr int kPassBatch = 8;  // chunks whose loads step 3 issues together
constexpr size_t kMaxSmem = 232448;

static_assert(kWarps * 16 == kMaxL && kWarps * 16 == kP, "one 16-row m tile a warp");

__host__ __device__ constexpr int round8(int n) { return (n + 7) / 8 * 8; }
// Row strides in floats.  A tile read as the A operand (or as a B operand
// stored [n][k]) takes 8 rows x 4 columns a load: a stride = 4 mod 32 puts
// them on 32 banks.  A tile read as a B operand stored [k][n] (or as A
// stored [k][m]), or written as accumulator pairs, takes 4 rows x 8
// columns: a stride = 8 mod 32.
__host__ __device__ constexpr int ld4(int n) { return n + ((4 - n % 32) + 32) % 32; }
__host__ __device__ constexpr int ld8(int n) { return n + ((8 - n % 32) + 32) % 32; }

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// x = hi + lo to about 2^-21 |x|: hi is x rounded to TF32 (to nearest, ties
// away, as cvt.rna does; x is finite), lo = x - hi (exact) cut to TF32.
// Four integer and float instructions; cvt.rna.tf32.f32 takes about ten
// on this card (it tests for infinities).  With kExact (x already TF32,
// as bf16 is) lo = 0.
template <bool kExact = false>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if (kExact) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
  }
}

// c += a b, one m16n8k8 TF32 product, f32 accumulate.  Fragments (PTX ISA,
// lane = 4 g + q): a0 (g, q), a1 (g+8, q), a2 (g, q+4), a3 (g+8, q+4);
// b0 (k q, n g), b1 (k q+4, n g); c0/c1 (g, 2q/2q+1), c2/c3 (g+8, ...).
// Not volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32 over NT n tiles: c += a_lo b_hi + a_hi b_lo + a_hi b_hi, the
// small terms first, each term issued for every tile before the next, so
// that no product waits on the one before it.  An exact side (bf16 x)
// skips its lo term.  Tile counts are compile-time and nothing is
// predicated: a predicated mma.sync costs a WARPSYNC and a NOP, and the
// padding of every tile is zero.
template <int NT, bool kExactA, bool kExactB>
__device__ __forceinline__ void mma3(float (&c)[NT][4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], const uint32_t (&bhi)[NT][2],
                                     const uint32_t (&blo)[NT][2]) {
  if (!kExactA) {
#pragma unroll
    for (int t = 0; t < NT; ++t) mma_tf32(c[t], alo, bhi[t][0], bhi[t][1]);
  }
  if (!kExactB) {
#pragma unroll
    for (int t = 0; t < NT; ++t) mma_tf32(c[t], ahi, blo[t][0], blo[t][1]);
  }
#pragma unroll
  for (int t = 0; t < NT; ++t) mma_tf32(c[t], ahi, bhi[t][0], bhi[t][1]);
}

// A fragment of rows m0.., columns k0.. of a row-major tile (stride ld).
__device__ __forceinline__ void load_a(const float* t, int ld, int m0, int k0, int g, int q,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split(t[(m0 + g) * ld + k0 + q], hi[0], lo[0]);
  split(t[(m0 + g + 8) * ld + k0 + q], hi[1], lo[1]);
  split(t[(m0 + g) * ld + k0 + q + 4], hi[2], lo[2]);
  split(t[(m0 + g + 8) * ld + k0 + q + 4], hi[3], lo[3]);
}

// B fragments of n tiles [n0, n0 + 8 NT) of a tile stored [n][k] (rows n).
template <int NT, bool kExact = false>
__device__ __forceinline__ void load_b_nk(const float* t, int ld, int n0, int k0, int g, int q,
                                          uint32_t (&hi)[NT][2], uint32_t (&lo)[NT][2]) {
#pragma unroll
  for (int u = 0; u < NT; ++u) {
    split<kExact>(t[(n0 + u * 8 + g) * ld + k0 + q], hi[u][0], lo[u][0]);
    split<kExact>(t[(n0 + u * 8 + g) * ld + k0 + q + 4], hi[u][1], lo[u][1]);
  }
}

// B fragments of n tiles [n0, n0 + 8 NT) of a tile stored [k][n] (rows k).
template <int NT, bool kExact = false>
__device__ __forceinline__ void load_b_kn(const float* t, int ld, int n0, int k0, int g, int q,
                                          uint32_t (&hi)[NT][2], uint32_t (&lo)[NT][2]) {
#pragma unroll
  for (int u = 0; u < NT; ++u) {
    split<kExact>(t[(k0 + q) * ld + n0 + u * 8 + g], hi[u][0], lo[u][0]);
    split<kExact>(t[(k0 + q + 4) * ld + n0 + u * 8 + g], hi[u][1], lo[u][1]);
  }
}

// Accumulators of the warp's 16 rows from m0, n tiles [n0, n0 + 8 NT), into
// a row-major shared tile (stride = 8 mod 32: conflict-free pairs).
template <int NT>
__device__ __forceinline__ void stage_acc(float* t, int ld, int m0, int n0, int g, int q,
                                          const float (&c)[NT][4]) {
#pragma unroll
  for (int u = 0; u < NT; ++u) {
    *reinterpret_cast<float2*>(t + (m0 + g) * ld + n0 + u * 8 + 2 * q) =
        make_float2(c[u][0], c[u][1]);
    *reinterpret_cast<float2*>(t + (m0 + g + 8) * ld + n0 + u * 8 + 2 * q) =
        make_float2(c[u][2], c[u][3]);
  }
}

// f(r, c) for every r < nrows, c < ncols, spread over the block's threads
// (one division a thread, not one a piece).
template <typename F>
__device__ __forceinline__ void for_tile(int nrows, int ncols, F f) {
  int r = threadIdx.x / ncols, c = threadIdx.x - r * ncols;
  const int dr = kThreads / ncols, dc = kThreads - dr * ncols;
  while (r < nrows) {
    f(r, c);
    c += dc;
    r += dr;
    if (c >= ncols) {
      c -= ncols;
      ++r;
    }
  }
}

// 16 bytes global -> shared, zero-filled (nothing read) when !valid
__device__ __forceinline__ void cp_async16(float* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  cp_async_commit();
  cp_async_wait<0>();
}

// Rows [0, nrows) x columns [0, ncols) of a row-major f32 tile in device
// memory (row r at src + r * gstride; rows >= vrows and columns >= vcols
// read as 0) into shared memory at stride ld.  With vec (vcols, gstride
// and src on 16-byte lines) as 16-byte cp.async pieces, all in flight at
// once (wait with cp_async_wait_all); else element by element.
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src, int64_t gstride,
                                          int nrows, int ncols, int vrows, int vcols,
                                          bool vec) {
  if (vec) {
    for_tile(nrows, ncols / 4, [&](int r, int c) {
      const bool ok = r < vrows && 4 * c < vcols;
      cp_async16(dst + r * ld + 4 * c, ok ? src + r * gstride + 4 * c : src, ok);
    });
  } else {
    for_tile(nrows, ncols, [&](int r, int c) {
      dst[r * ld + c] = (r < vrows && c < vcols) ? src[r * gstride + c] : 0.f;
    });
  }
}

// The [kMaxL x kP] x tile, x[j][p] as f32.  bf16 takes 8-byte loads, all
// issued before the first conversion.
__device__ __forceinline__ void load_x(float* dst, int ld, const float* src, int64_t gstride,
                                       int vrows, int vcols, bool vec) {
  load_tile(dst, ld, src, gstride, kMaxL, kP, vrows, vcols, vec);
}
__device__ __forceinline__ void load_x(float* dst, int ld, const __nv_bfloat16* src,
                                       int64_t gstride, int vrows, int vcols, bool vec) {
  constexpr int kPieces = kMaxL * kP / 4 / kThreads, kRowPieces = kP / 4;
  if (vec) {
    uint2 v[kPieces];
#pragma unroll
    for (int u = 0; u < kPieces; ++u) {
      const int e = u * kThreads + threadIdx.x, r = e / kRowPieces, c = 4 * (e % kRowPieces);
      v[u] = (r < vrows && c < vcols) ? *reinterpret_cast<const uint2*>(src + r * gstride + c)
                                      : make_uint2(0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kPieces; ++u) {
      const int e = u * kThreads + threadIdx.x, r = e / kRowPieces, c = 4 * (e % kRowPieces);
      *reinterpret_cast<float4*>(dst + r * ld + c) =
          make_float4(__uint_as_float(v[u].x << 16), __uint_as_float(v[u].x & 0xffff0000u),
                      __uint_as_float(v[u].y << 16), __uint_as_float(v[u].y & 0xffff0000u));
    }
  } else {
    for_tile(kMaxL, kP, [&](int r, int c) {
      dst[r * ld + c] = (r < vrows && c < vcols) ? to_float(src[r * gstride + c]) : 0.f;
    });
  }
}

// 4 staged floats -> 16 bytes of f32 or 8 of bf16 in device memory
__device__ __forceinline__ void put4(float* d, const float* s) {
  *reinterpret_cast<float4*>(d) = *reinterpret_cast<const float4*>(s);
}
__device__ __forceinline__ void put4(__nv_bfloat16* d, const float* s) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(s[0], s[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(s[2], s[3]);
  *reinterpret_cast<uint2*>(d) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                            *reinterpret_cast<const uint32_t*>(&hi));
}
__device__ __forceinline__ void put1(float* d, float s) { *d = s; }
__device__ __forceinline__ void put1(__nv_bfloat16* d, float s) { *d = __float2bfloat16_rn(s); }

// A staged f32 tile (stride ld) out to rows r < vrows, columns c < vcols
// of a row-major tile in device memory: with vec as 16-byte (f32) or
// 8-byte (bf16) pieces, each warp on whole rows.
template <typename T>
__device__ __forceinline__ void store_tile(T* dst, int64_t gstride, const float* src, int ld,
                                           int nrows, int ncols, int vrows, int vcols,
                                           bool vec) {
  if (vec) {
    for_tile(nrows, ncols / 4, [&](int r, int c) {
      if (r < vrows && 4 * c < vcols) put4(dst + r * gstride + 4 * c, src + r * ld + 4 * c);
    });
  } else {
    for_tile(nrows, ncols, [&](int r, int c) {
      if (r < vrows && c < vcols) put1(dst + r * gstride + c, src[r * ld + c]);
    });
  }
}

// ---------------------------------------------------------------- step 1
// CB [b, nc, kMaxL, kMaxL], rows i, columns j, of chunk c: a block takes
// the 16-row tile rt; warp w computes its 8-column tiles w and w + 4 and
// writes those at or left of the diagonal (no one reads the others), and
// a warp with neither stops.  These blocks run in step 2's grid (they need
// nothing it makes).
__device__ __forceinline__ void cb_tile(float* smem, const float* __restrict__ B,
                                        const float* __restrict__ C, float* __restrict__ cb,
                                        int s, int ns, int l, int nc, bool vec, int c, int rt,
                                        int bat) {
  const int t0 = c * l, m0 = rt * 16;
  const int rows = min(l, s - t0);
  if (m0 >= rows) return;  // rows past the chunk's end are never read
  const int nsp = round8(ns), ld = ld4(nsp);
  float* cs = smem;            // [16][ld] C rows m0..m0+15
  float* bs = cs + 16 * ld;    // [kMaxL][ld] B rows
  const int64_t row0 = static_cast<int64_t>(bat) * s + t0;
  load_tile(cs, ld, C + (row0 + m0) * ns, ns, 16, nsp, rows - m0, ns, vec);
  load_tile(bs, ld, B + row0 * ns, ns, kMaxL, nsp, rows, ns, vec);
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, q = lane & 3;
  const int n_tiles = min(2 * rt + 2, (rows + 7) / 8);  // j tiles at or left of the diagonal
  if (warp >= n_tiles) return;
  float acc[2][4] = {};
  for (int k0 = 0; k0 < nsp; k0 += 8) {  // B^T[k = n][col = j] = B[j][n]: tiles w, w + 4
    uint32_t ahi[4], alo[4], bhi[2][2], blo[2][2];
    load_a(cs, ld, 0, k0, g, q, ahi, alo);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = (warp + u * kWarps) * 8 + g;
      split(bs[j * ld + k0 + q], bhi[u][0], blo[u][0]);
      split(bs[j * ld + k0 + q + 4], bhi[u][1], blo[u][1]);
    }
    mma3<2, false, false>(acc, ahi, alo, bhi, blo);
  }
  float* out = cb + (static_cast<int64_t>(bat) * nc + c) * kMaxL * kMaxL;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (warp + u * kWarps < n_tiles) {
      const int j = (warp + u * kWarps) * 8 + 2 * q;
      *reinterpret_cast<float2*>(out + (m0 + g) * kMaxL + j) = make_float2(acc[u][0], acc[u][1]);
      *reinterpret_cast<float2*>(out + (m0 + g + 8) * kMaxL + j) =
          make_float2(acc[u][2], acc[u][3]);
    }
  }
}

// ---------------------------------------------------------------- step 2
// grid (hd tile x state tile x chunk, head + 4, batch), NT 8-column n
// tiles a state tile: the blocks of rows nh.. take step 1 (block x < nc:
// chunk x, 16-row tile y - nh).  While the x and B tiles load, warp 0
// takes the head's cumulative log-decay over the chunk
// as a warp scan (lane r holds rows 2r and 2r + 1; rows past the chunk
// add 0), and the first tile's block writes it to cum [b, nc, nh, kMaxL]
// for steps 3 and 4.  Then S [b, nc, nh, hd, ns]:
// S[p][n] = sum_j (x[j][p] exp(cum_last - cum_j) dt_j) B[j][n], an
// [hd tile x l] by [l x state tile] product; A = the weighted x^T, read
// from the x tile stored [j][p]; the result leaves through the B tile's
// shared memory as whole rows.
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
    ssd_state_kernel(const T* __restrict__ x,        // [b, s, nh, hd]
                     const float* __restrict__ dt,   // [b, s, nh]
                     const float* __restrict__ a,    // [nh]
                     const float* __restrict__ B,    // [b, s, ns]
                     const float* __restrict__ C,    // [b, s, ns]
                     float* __restrict__ cb, float* __restrict__ cum,
                     float* __restrict__ states, int s, int nh, int hd, int ns, int l, int nc,
                     int vec) {
  extern __shared__ float smem[];
  if (blockIdx.y >= nh) {
    if (blockIdx.x < nc)
      cb_tile(smem, B, C, cb, s, ns, l, nc, vec, blockIdx.x, blockIdx.y - nh, blockIdx.z);
    return;
  }
  const int n_pt = (hd + kP - 1) / kP, n_nt = (ns + kNS - 1) / kNS;
  const int pt = blockIdx.x % n_pt, nt0 = blockIdx.x / n_pt % n_nt;
  const int c = blockIdx.x / (n_pt * n_nt);
  const int h = blockIdx.y, bat = blockIdx.z;
  const int p0 = pt * kP, n0 = nt0 * kNS, t0 = c * l;
  const int rows = min(l, s - t0);
  constexpr int ncols = NT * 8;  // state columns of this block, zero past ns
  constexpr int ldb = ld8(ncols), ldx = ld8(kP);
  float* xs = smem;                // [kMaxL][ldx] x[j][p]
  float* bsm = xs + kMaxL * ldx;   // [kMaxL][ldb] B[j][n0 + n], then the result [p][n]
  float* cumv = bsm + kMaxL * ldb; // [kMaxL]
  float* w = cumv + kMaxL;         // [kMaxL] exp(cum_last - cum_j) dt_j
  const int tid = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(bat) * s + t0;
  load_tile(bsm, ldb, B + row0 * ns + n0, ns, kMaxL, ncols, rows, ns - n0, vec);
  load_x(xs, ldx, x + (row0 * nh + h) * hd + p0, static_cast<int64_t>(nh) * hd, rows, hd - p0,
         vec);
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, q = lane & 3;
  if (warp == 0) {
    const float ah = a[h];
    const int r0 = 2 * lane, r1 = 2 * lane + 1;
    const float d0 = r0 < rows ? dt[(row0 + r0) * nh + h] : 0.f;
    const float d1 = r1 < rows ? dt[(row0 + r1) * nh + h] : 0.f;
    const float v0 = d0 * ah, v1 = d1 * ah;
    float incl = v0 + v1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
    const float c0 = excl + v0, c1 = c0 + v1;
    cumv[r0] = c0;
    cumv[r1] = c1;
    if (pt == 0 && nt0 == 0)
      *reinterpret_cast<float2*>(cum + ((static_cast<int64_t>(bat) * nc + c) * nh + h) * kMaxL +
                                 r0) = make_float2(c0, c1);
    __syncwarp();
    const float c_last = cumv[l - 1];
    w[r0] = expf(fminf(c_last - c0, 0.f)) * d0;
    w[r1] = expf(fminf(c_last - c1, 0.f)) * d1;
  }
  cp_async_wait_all();
  __syncthreads();

  const int m0 = warp * 16;
  const int kend = round8(rows);
  constexpr int kG = NT < kGroup ? NT : kGroup, kGroups = NT / kG;
  float acc[kGroups][kG][4] = {};
  if (p0 + m0 < hd) {  // warps wholly past hd only help move the result
    for (int k0 = 0; k0 < kend; k0 += 8) {
      uint32_t ahi[4], alo[4];  // A[m = p][k = j] = x[j][p] w[j]
      const float w0 = w[k0 + q], w1 = w[k0 + q + 4];
      split(xs[(k0 + q) * ldx + m0 + g] * w0, ahi[0], alo[0]);
      split(xs[(k0 + q) * ldx + m0 + g + 8] * w0, ahi[1], alo[1]);
      split(xs[(k0 + q + 4) * ldx + m0 + g] * w1, ahi[2], alo[2]);
      split(xs[(k0 + q + 4) * ldx + m0 + g + 8] * w1, ahi[3], alo[3]);
#pragma unroll
      for (int grp = 0; grp < kGroups; ++grp) {
        uint32_t bhi[kG][2], blo[kG][2];
        load_b_kn<kG>(bsm, ldb, grp * kG * 8, k0, g, q, bhi, blo);
        mma3<kG, false, false>(acc[grp], ahi, alo, bhi, blo);
      }
    }
  }
  __syncthreads();  // every warp is done with the B tile
#pragma unroll
  for (int grp = 0; grp < kGroups; ++grp) stage_acc<kG>(bsm, ldb, m0, grp * kG * 8, g, q, acc[grp]);
  __syncthreads();
  float* out = states + ((static_cast<int64_t>(bat) * nc + c) * nh + h) * hd * ns +
               static_cast<int64_t>(p0) * ns + n0;
  store_tile(out, ns, bsm, ldb, kP, ncols, hd - p0, ns - n0, vec);
}

// ---------------------------------------------------------------- step 3
// grid (element block, head, batch), elementwise over [hd, ns] (V = 4:
// float4 pieces, when hd * ns divides by 4): each chunk's slot of
// `states` goes from its own state S_c to the state before it, prior_c;
// the final carry is the returned state.
template <int V>
__global__ void __launch_bounds__(kPassThreads)
    ssd_pass_kernel(float* __restrict__ states, const float* __restrict__ cum,
                    float* __restrict__ state_out, int nh, int hd, int ns, int l, int nc) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  const int64_t hs = static_cast<int64_t>(hd) * ns;
  const int64_t e = (static_cast<int64_t>(blockIdx.x) * kPassThreads + threadIdx.x) * V;
  if (e >= hs) return;
  const int h = blockIdx.y, bat = blockIdx.z;
  Vec* st = reinterpret_cast<Vec*>(states + (static_cast<int64_t>(bat) * nc * nh + h) * hs + e);
  const float* cl = cum + (static_cast<int64_t>(bat) * nc * nh + h) * kMaxL + (l - 1);
  const int64_t st_stride = nh * hs / V, cl_stride = static_cast<int64_t>(nh) * kMaxL;
  float carry[V] = {};
  for (int c0 = 0; c0 < nc; c0 += kPassBatch) {
    Vec sv[kPassBatch];
    float dv[kPassBatch];
#pragma unroll
    for (int u = 0; u < kPassBatch; ++u) {
      if (c0 + u < nc) {
        sv[u] = st[(c0 + u) * st_stride];
        dv[u] = cl[(c0 + u) * cl_stride];
      }
    }
#pragma unroll
    for (int u = 0; u < kPassBatch; ++u) {
      if (c0 + u < nc) {
        const float dec = expf(fminf(dv[u], 0.f));
        const float* sf = reinterpret_cast<const float*>(&sv[u]);
        Vec prior;
        float* pf = reinterpret_cast<float*>(&prior);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          pf[k] = carry[k];
          carry[k] = carry[k] * dec + sf[k];
        }
        st[(c0 + u) * st_stride] = prior;
      }
    }
  }
  Vec fin;
#pragma unroll
  for (int k = 0; k < V; ++k) reinterpret_cast<float*>(&fin)[k] = carry[k];
  *reinterpret_cast<Vec*>(state_out + (static_cast<int64_t>(bat) * nh + h) * hs + e) = fin;
}

// ---------------------------------------------------------------- step 4
// grid (hd tile x chunk, head, batch).  y[i][p] = exp(cum_i) (C prior^T)[i][p]
// + sum_{j<=i} (CB[i][j] exp(cum_i - cum_j) dt_j) x[j][p] + D x[i][p]; the
// result leaves through the x tile's shared memory as whole rows.
template <typename T, bool kExactX>
__global__ void __launch_bounds__(kThreads)
    ssd_out_kernel(const T* __restrict__ x,          // [b, s, nh, hd]
                   const float* __restrict__ dt,     // [b, s, nh]
                   const float* __restrict__ C,      // [b, s, ns]
                   const float* __restrict__ d_skip, // [nh]
                   const float* __restrict__ cb,     // [b, nc, kMaxL, kMaxL]
                   const float* __restrict__ cum,    // [b, nc, nh, kMaxL]
                   const float* __restrict__ prior,  // [b, nc, nh, hd, ns]
                   T* __restrict__ y, int s, int nh, int hd, int ns, int l, int nc, int vec) {
  extern __shared__ float smem[];
  constexpr int ldcb = ld4(kMaxL), ldx = ld8(kP);
  const int n_pt = (hd + kP - 1) / kP;
  const int pt = blockIdx.x % n_pt, c = blockIdx.x / n_pt;
  const int h = blockIdx.y, bat = blockIdx.z;
  const int p0 = pt * kP, t0 = c * l;
  const int rows = min(l, s - t0);
  const int nsp = round8(ns), ldc = ld4(nsp);
  float* cbs = smem;                 // [kMaxL][ldcb] CB[i][j]
  float* xs = cbs + kMaxL * ldcb;    // [kMaxL][ldx] x[j][p], then y[i][p]
  float* cs = xs + kMaxL * ldx;      // [kMaxL][ldc] C[i][n]
  float* ps = cs + kMaxL * ldc;      // [kP][ldc] prior[p][n]
  float* cumv = ps + kP * ldc;       // [kMaxL]
  float* dtv = cumv + kMaxL;         // [kMaxL]
  const int tid = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(bat) * s + t0;
  const int64_t bch = (static_cast<int64_t>(bat) * nc + c) * nh + h;
  // CB: the 16-column groups at or left of each row's diagonal tile, rows
  // of the chunk (step 1 wrote them; entries right of the diagonal are
  // masked where they are read)
  // first C and the prior state (the first product), then CB and x,
  // which load while the first product runs
  load_tile(cs, ldc, C + row0 * ns, ns, kMaxL, nsp, rows, ns, vec);
  load_tile(ps, ldc, prior + bch * hd * ns + static_cast<int64_t>(p0) * ns, ns, kP, nsp, hd - p0,
            ns, vec);
  cp_async_commit();
  const float* cbc = cb + (static_cast<int64_t>(bat) * nc + c) * kMaxL * kMaxL;
  for_tile(kMaxL, kMaxL / 4, [&](int i, int j4) {
    const bool ok = i < rows && 4 * j4 <= (i | 15);
    cp_async16(cbs + i * ldcb + 4 * j4, ok ? cbc + i * kMaxL + 4 * j4 : cbc, ok);
  });
  load_x(xs, ldx, x + (row0 * nh + h) * hd + p0, static_cast<int64_t>(nh) * hd, rows, hd - p0,
         vec);
  cp_async_commit();
  for (int r = tid; r < kMaxL; r += kThreads) {
    cumv[r] = cum[bch * kMaxL + r];
    dtv[r] = r < rows ? dt[(row0 + r) * nh + h] : 0.f;
  }
  cp_async_wait<1>();
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, q = lane & 3;
  const int m0 = warp * 16;
  const int i0 = m0 + g, i1 = m0 + g + 8;
  float acc[kP / 8][4] = {};
  if (m0 < rows) {  // warps wholly past the chunk only help move the result
    // exp(cum_i) (C prior^T): A = C rows, B^T[k = n][col = p] = prior[p][n]
    for (int k0 = 0; k0 < nsp; k0 += 8) {
      uint32_t ahi[4], alo[4], bhi[kP / 8][2], blo[kP / 8][2];
      load_a(cs, ldc, m0, k0, g, q, ahi, alo);
      load_b_nk<kP / 8>(ps, ldc, 0, k0, g, q, bhi, blo);
      mma3<kP / 8, false, false>(acc, ahi, alo, bhi, blo);
    }
    const float e0 = expf(fminf(cumv[i0], 0.f)), e1 = expf(fminf(cumv[i1], 0.f));
#pragma unroll
    for (int nt = 0; nt < kP / 8; ++nt) {
      acc[nt][0] *= e0;
      acc[nt][1] *= e0;
      acc[nt][2] *= e1;
      acc[nt][3] *= e1;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // CB and x are in
  if (m0 < rows) {
    // (CB o L o dt) x over the k tiles at or left of the warp's diagonal
    const int kend = min(m0 + 16, round8(rows));
    for (int k0 = 0; k0 < kend; k0 += 8) {
      uint32_t ahi[4], alo[4], bhi[kP / 8][2], blo[kP / 8][2];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = (r & 1) ? i1 : i0, j = k0 + q + (r >= 2 ? 4 : 0);
        const float v =
            j <= i ? cbs[i * ldcb + j] * expf(fminf(cumv[i] - cumv[j], 0.f)) * dtv[j] : 0.f;
        split(v, ahi[r], alo[r]);
      }
      load_b_kn<kP / 8, kExactX>(xs, ldx, 0, k0, g, q, bhi, blo);
      mma3<kP / 8, false, kExactX>(acc, ahi, alo, bhi, blo);
    }
    const float dv = d_skip[h];
#pragma unroll
    for (int nt = 0; nt < kP / 8; ++nt) {
      const int p = nt * 8 + 2 * q;
      acc[nt][0] += dv * xs[i0 * ldx + p];
      acc[nt][1] += dv * xs[i0 * ldx + p + 1];
      acc[nt][2] += dv * xs[i1 * ldx + p];
      acc[nt][3] += dv * xs[i1 * ldx + p + 1];
    }
  }
  __syncthreads();  // every warp is done with the x tile
  stage_acc<kP / 8>(xs, ldx, m0, 0, g, q, acc);
  __syncthreads();
  store_tile(y + (row0 * nh + h) * hd + p0, static_cast<int64_t>(nh) * hd, xs, ldx, kMaxL, kP,
             rows, hd - p0, vec);
}

size_t cb_smem(int ns) {
  return sizeof(float) * (16 + static_cast<size_t>(kMaxL)) * ld4(round8(ns));
}
size_t state_smem(int nt) {
  return sizeof(float) * (static_cast<size_t>(kMaxL) * (ld8(kP) + ld8(8 * nt)) + 2 * kMaxL);
}
size_t out_smem(int ns) {
  return sizeof(float) * (static_cast<size_t>(kMaxL) * (ld4(kMaxL) + ld8(kP)) +
                          static_cast<size_t>(kMaxL + kP) * ld4(round8(ns)) + 2 * kMaxL);
}

constexpr int kMaxDevices = 64;
// The shared-memory size a kernel instance may use, by device.  Each launch
// site keeps its own, so the attribute is set (a driver call) only when a
// launch needs more than the instance was allowed before on that device.
using SmemAllowed = std::atomic<size_t>[kMaxDevices];

template <typename K>
int prepare(K kernel, size_t smem, SmemAllowed& allowed) {
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices && allowed[dev].load(std::memory_order_relaxed) >= smem) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev].store(smem, std::memory_order_relaxed);
  return static_cast<int>(err);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Steps 1 and 2, with NT n tiles of state columns a block (zero past ns).
template <typename T, int NT>
int launch_state(const T* x, const float* dt, const float* a, const float* B, const float* C,
                 float* cb, float* cum, float* states, int b, int s, int nh, int hd, int ns,
                 int l, int nc, int vec, cudaStream_t stream) {
  const size_t s1 = cb_smem(ns), s2 = state_smem(NT), smem = s1 > s2 ? s1 : s2;
  static SmemAllowed allowed;
  int err = prepare(ssd_state_kernel<T, NT>, smem, allowed);
  if (err) return err;
  const int n_pt = (hd + kP - 1) / kP, n_nt = (ns + kNS - 1) / kNS;
  const int nx = n_pt * n_nt * nc;
  ssd_state_kernel<T, NT><<<dim3(nx, nh + kMaxL / 16, b), kThreads, smem, stream>>>(
      x, dt, a, B, C, cb, cum, states, s, nh, hd, ns, l, nc, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kExactX>
int launch(const void* xv, const float* dt, const float* a, const float* B, const float* C,
           const float* d_skip, void* yv, float* state, float* cb, float* cum,
           float* states, int b, int s, int nh, int hd, int ns, int l, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  const int nc = (s + l - 1) / l;
  const int n_pt = (hd + kP - 1) / kP;
  // tiles move as 16-byte pieces when every row starts on a 16-byte line
  const int vec = ns % 4 == 0 && hd % 4 == 0 && aligned16(xv) && aligned16(yv) &&
                  aligned16(B) && aligned16(C) && aligned16(cb) && aligned16(states);
  const size_t s4 = out_smem(ns);
  static SmemAllowed allowed;
  int err;
  if ((err = prepare(ssd_out_kernel<T, kExactX>, s4, allowed))) return err;
  // n tiles of a block's state columns: 2 up to ns = 16 (hymba-1.5b), else
  // 16 (mamba2-780m's 128; a narrower ns is padded with zeros)
  err = (ns <= 16 ? launch_state<T, 2> : launch_state<T, kNS / 8>)(
      x, dt, a, B, C, cb, cum, states, b, s, nh, hd, ns, l, nc, vec, stream);
  if (err) return err;
  const int64_t hs = static_cast<int64_t>(hd) * ns;
  const int v4 = hs % 4 == 0 && aligned16(states) && aligned16(state);
  const int64_t pieces = v4 ? hs / 4 : hs;
  const dim3 pass_grid(static_cast<unsigned>((pieces + kPassThreads - 1) / kPassThreads), nh, b);
  if (v4)
    ssd_pass_kernel<4><<<pass_grid, kPassThreads, 0, stream>>>(states, cum, state, nh, hd, ns,
                                                               l, nc);
  else
    ssd_pass_kernel<1><<<pass_grid, kPassThreads, 0, stream>>>(states, cum, state, nh, hd, ns,
                                                               l, nc);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  ssd_out_kernel<T, kExactX><<<dim3(n_pt * nc, nh, b), kThreads, s4, stream>>>(
      x, dt, C, d_skip, cb, cum, states, y, s, nh, hd, ns, l, nc, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The design the wrapper models (kernels/ssd_scan/ops.py checks it against
// its own constants before the first launch, and sizes the scratch with
// it): the longest internal chunk (the rows of every tile), hd columns a
// block of steps 2 and 4, threads a block of steps 1, 2 and 4.  Returns
// how many values it wrote.
extern "C" int ssd_scan_design(int* out, int n) {
  const int v[] = {kMaxL, kP, kThreads};
  const int m = static_cast<int>(sizeof(v) / sizeof(v[0]));
  for (int i = 0; i < m && i < n; ++i) out[i] = v[i];
  return m;
}

// dtype: 0 = float32, 1 = bfloat16 (x and y share it; dt, a, B, C,
// d_skip and the state are float32).  chunk: 1..kMaxL; the internal chunk
// is l = min(s, chunk) and nc = ceil(s / l).  Scratch (f32, from the
// wrapper): cb [b, nc, kMaxL, kMaxL], cum [b, nc, nh, kMaxL], states
// [b, nc, nh, hd, ns].
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a, const void* B,
                               const void* C, const void* d_skip, void* y, void* state,
                               void* cb, void* cum, void* states, int b, int s, int nh,
                               int hd, int ns, int chunk, int dtype, void* stream) {
  if (b <= 0 || nh <= 0 || hd <= 0) return 0;
  if (s <= 0 || ns <= 0 || chunk <= 0 || chunk > kMaxL || !cb || !cum || !states)
    return static_cast<int>(cudaErrorInvalidValue);
  const int l = s < chunk ? s : chunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f_dt = static_cast<const float*>(dt);
  const float* f_a = static_cast<const float*>(a);
  const float* f_b = static_cast<const float*>(B);
  const float* f_c = static_cast<const float*>(C);
  const float* f_d = static_cast<const float*>(d_skip);
  float* f_cb = static_cast<float*>(cb);
  float* f_cum = static_cast<float*>(cum);
  float* f_states = static_cast<float*>(states);
  float* f_st = static_cast<float*>(state);
  if (dtype == 0)
    return launch<float, false>(x, f_dt, f_a, f_b, f_c, f_d, y, f_st, f_cb, f_cum, f_states,
                                b, s, nh, hd, ns, l, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, true>(x, f_dt, f_a, f_b, f_c, f_d, y, f_st, f_cb, f_cum,
                                       f_states, b, s, nh, hd, ns, l, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

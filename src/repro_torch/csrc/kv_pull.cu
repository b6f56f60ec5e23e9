// Descriptor-driven KV page pull on Hopper: the kv_pull family.
//
// Replaces the Pallas kernels in src/repro/kernels/kv_pull/kernel.py:
//   * kv_pull / kv_pull_runs  (shared `_pull`, kernel.py:44, :68, :128)
//     -> kv_pull_kernel, `txn_bytes` contiguous bytes per transaction, as
//     the Pallas grid step moves one block of `pages_per_txn` pages:
//     kv_pull_launch moves a page a transaction, kv_pull_runs_launch a run
//     of `run_len` adjacent pages (run_len x page_bytes contiguous bytes
//     from byte start x run_len x page_bytes: starts in run units, the
//     Pallas block index).  The transfer engine expands a tick's runs into
//     page ids for one kv_pull launch; kv_pull_runs serves callers that
//     hold whole runs;
//   * kv_pull_dequant          (kernel.py:92)
//     -> kv_pull_dequant_vec_kernel (scalar fallback kv_pull_dequant_kernel).
//
// What bounds it on an H100: bytes.  A copy does no arithmetic; each page
// is read once and written once, so the floor is 2 * bytes / 3.35 TB/s.
// A Yi-9B page (32 tokens x 4 kv-heads x 128 x bf16) is 32 KiB, so one
// transaction is far below what one launch costs, and a pull of a few
// hundred pages is bound by launch latency first.
//
// What the design does about it: one launch per tick moves every page of
// the tick (the transfer engine batches a tick's reads into one id list).
// The grid is (transaction, chunk): each thread moves 16 bytes with one
// vector load and one vector store, neighbouring threads on neighbouring
// addresses, so every warp issues full 512-byte coalesced transactions.
// The kernel is dtype-agnostic: it sees pages as bytes, so it runs on the
// uint8 KV slab directly.  Pages that no transaction names are never
// touched (RDMA-write semantics of the Pallas kernel's aliased output).
// The dequant variant is one pass: int8 -> f32 * scale[i] -> dst dtype,
// the same rounding as the reference engine (f32 product, then one
// round-to-nearest-even cast).  It moves whole 16-byte pieces too: each
// thread loads one piece of 16 int8 into shared memory, and its warp
// stores the warp's 512 int8 as 16-byte pieces of the dst type, each
// store instruction on 512 contiguous bytes (bf16 rounded in pairs by
// __floats2bfloat162_rn, the same rounding as __float2bfloat16_rn).  The
// grid is kv_pull's, (transaction, chunk of 256 pieces): 4 blocks a
// Yi-9B page of 16384 int8.  Pages whose element count is not a multiple
// of 16, or pools off the 16-byte grid, take the scalar kernel.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename Vec>
__global__ void kv_pull_kernel(const Vec* __restrict__ src, Vec* __restrict__ dst,
                               const int32_t* __restrict__ src_ids,
                               const int32_t* __restrict__ dst_ids,
                               int64_t txn_vecs) {
  const int txn = blockIdx.x;
  const int64_t s0 = static_cast<int64_t>(src_ids[txn]) * txn_vecs;
  const int64_t d0 = static_cast<int64_t>(dst_ids[txn]) * txn_vecs;
  for (int64_t i = static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x;
       i < txn_vecs; i += static_cast<int64_t>(gridDim.y) * blockDim.x) {
    dst[d0 + i] = src[s0 + i];
  }
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void kv_pull_dequant_kernel(const int8_t* __restrict__ src,
                                       T* __restrict__ dst,
                                       const int32_t* __restrict__ src_ids,
                                       const int32_t* __restrict__ dst_ids,
                                       const float* __restrict__ scales,
                                       int64_t page_elems) {
  const int txn = blockIdx.x;
  const float scale = scales[txn];
  const int64_t s0 = static_cast<int64_t>(src_ids[txn]) * page_elems;
  const int64_t d0 = static_cast<int64_t>(dst_ids[txn]) * page_elems;
  for (int64_t i = static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x;
       i < page_elems; i += static_cast<int64_t>(gridDim.y) * blockDim.x) {
    dst[d0 + i] = from_float<T>(static_cast<float>(src[s0 + i]) * scale);
  }
}

__device__ __forceinline__ float s8(uint32_t w, int k) {
  return static_cast<float>(static_cast<int8_t>(w >> (8 * k)));
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// One 16-byte dst piece from int8 words staged in shared memory: 4 int8
// -> 4 f32, or 8 int8 -> 8 bf16.
__device__ __forceinline__ void store_piece(float* d, const uint32_t* w, float scale) {
  *reinterpret_cast<float4*>(d) =
      make_float4(s8(w[0], 0) * scale, s8(w[0], 1) * scale, s8(w[0], 2) * scale,
                  s8(w[0], 3) * scale);
}
__device__ __forceinline__ void store_piece(__nv_bfloat16* d, const uint32_t* w, float scale) {
  *reinterpret_cast<uint4*>(d) = make_uint4(
      bf16x2(s8(w[0], 0) * scale, s8(w[0], 1) * scale),
      bf16x2(s8(w[0], 2) * scale, s8(w[0], 3) * scale),
      bf16x2(s8(w[1], 0) * scale, s8(w[1], 1) * scale),
      bf16x2(s8(w[1], 2) * scale, s8(w[1], 3) * scale));
}

// page_vecs 16-byte pieces of int8 a page; dst pages of page_vecs * 16 T.
// A warp loads 32 pieces (512 int8, one 16-byte load a lane) into shared
// memory, then stores them as 16-byte pieces of T, lane after lane, so
// that each store instruction of the warp covers 512 contiguous bytes.
template <typename T>
__global__ void kv_pull_dequant_vec_kernel(const uint4* __restrict__ src, T* __restrict__ dst,
                                           const int32_t* __restrict__ src_ids,
                                           const int32_t* __restrict__ dst_ids,
                                           const float* __restrict__ scales,
                                           int64_t page_vecs) {
  constexpr int kOut = 16 / sizeof(T);  // int8 a 16-byte dst piece takes
  __shared__ uint4 stage[kThreads];
  const int txn = blockIdx.x;
  const float scale = scales[txn];
  const uint4* s = src + static_cast<int64_t>(src_ids[txn]) * page_vecs;
  T* d = dst + static_cast<int64_t>(dst_ids[txn]) * page_vecs * 16;
  const int lane = threadIdx.x & 31, warp0 = threadIdx.x & ~31;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(stage + warp0);
  for (int64_t i0 = static_cast<int64_t>(blockIdx.y) * blockDim.x + warp0; i0 < page_vecs;
       i0 += static_cast<int64_t>(gridDim.y) * blockDim.x) {
    if (i0 + lane < page_vecs) stage[threadIdx.x] = s[i0 + lane];
    __syncwarp();
    const int64_t n = (page_vecs - i0 < 32 ? page_vecs - i0 : 32) * 16;  // int8 staged
#pragma unroll
    for (int k = 0; k < 16 / kOut; ++k) {
      const int e = (k * 32 + lane) * kOut;
      if (e < n) store_piece(d + i0 * 16 + e, words + e / 4, scale);
    }
    __syncwarp();
  }
}

unsigned chunks_for(int64_t n) {
  int64_t c = (n + kThreads - 1) / kThreads;
  if (c > 1024) c = 1024;  // grid-stride loop covers the rest
  return static_cast<unsigned>(c < 1 ? 1 : c);
}

}  // namespace

// src/dst: page pools; a transaction moves txn_bytes contiguous bytes from
// src + src_ids[i]*txn_bytes to dst + dst_ids[i]*txn_bytes.
extern "C" int kv_pull_launch(const void* src, void* dst, const void* src_ids,
                              const void* dst_ids, int n_txn, int64_t txn_bytes,
                              void* stream) {
  if (n_txn <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec16 = (txn_bytes % 16 == 0) &&
                     (reinterpret_cast<uintptr_t>(src) % 16 == 0) &&
                     (reinterpret_cast<uintptr_t>(dst) % 16 == 0);
  const int32_t* sid = static_cast<const int32_t*>(src_ids);
  const int32_t* did = static_cast<const int32_t*>(dst_ids);
  if (vec16) {
    const int64_t n = txn_bytes / 16;
    dim3 grid(n_txn, chunks_for(n));
    kv_pull_kernel<uint4><<<grid, kThreads, 0, s>>>(
        static_cast<const uint4*>(src), static_cast<uint4*>(dst), sid, did, n);
  } else {
    dim3 grid(n_txn, chunks_for(txn_bytes));
    kv_pull_kernel<uint8_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), sid, did,
        txn_bytes);
  }
  return static_cast<int>(cudaGetLastError());
}

// Runs of run_len adjacent pages of page_bytes each: transaction i moves
// the run_len * page_bytes bytes at src + src_starts[i]*run_len*page_bytes
// to dst + dst_starts[i]*run_len*page_bytes (starts in run units).
extern "C" int kv_pull_runs_launch(const void* src, void* dst, const void* src_starts,
                                   const void* dst_starts, int n_runs, int64_t page_bytes,
                                   int run_len, void* stream) {
  if (run_len < 1 || page_bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  return kv_pull_launch(src, dst, src_starts, dst_starts, n_runs,
                        page_bytes * static_cast<int64_t>(run_len), stream);
}

// dst_dtype: 0 = float32, 1 = bfloat16.
extern "C" int kv_pull_dequant_launch(const void* src, void* dst, const void* src_ids,
                                      const void* dst_ids, const void* scales,
                                      int n_txn, int64_t page_elems, int dst_dtype,
                                      void* stream) {
  if (n_txn <= 0) return 0;
  if (dst_dtype != 0 && dst_dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* q = static_cast<const int8_t*>(src);
  const int32_t* sid = static_cast<const int32_t*>(src_ids);
  const int32_t* did = static_cast<const int32_t*>(dst_ids);
  const float* sc = static_cast<const float*>(scales);
  const bool vec16 = (page_elems % 16 == 0) &&
                     (reinterpret_cast<uintptr_t>(src) % 16 == 0) &&
                     (reinterpret_cast<uintptr_t>(dst) % 16 == 0);
  if (vec16) {
    const int64_t n = page_elems / 16;
    dim3 grid(n_txn, chunks_for(n));
    const uint4* qv = static_cast<const uint4*>(src);
    if (dst_dtype == 0)
      kv_pull_dequant_vec_kernel<float><<<grid, kThreads, 0, s>>>(
          qv, static_cast<float*>(dst), sid, did, sc, n);
    else
      kv_pull_dequant_vec_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
          qv, static_cast<__nv_bfloat16*>(dst), sid, did, sc, n);
    return static_cast<int>(cudaGetLastError());
  }
  dim3 grid(n_txn, chunks_for(page_elems));
  if (dst_dtype == 0) {
    kv_pull_dequant_kernel<float><<<grid, kThreads, 0, s>>>(
        q, static_cast<float*>(dst), sid, did, sc, page_elems);
  } else {
    kv_pull_dequant_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        q, static_cast<__nv_bfloat16*>(dst), sid, did, sc, page_elems);
  }
  return static_cast<int>(cudaGetLastError());
}

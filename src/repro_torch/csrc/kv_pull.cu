// Descriptor-driven KV page pull on Hopper: the kv_pull family.
//
// Replaces the Pallas kernels in src/repro/kernels/kv_pull/kernel.py:
//   * kv_pull / kv_pull_runs  (shared `_pull`, kernel.py:44, :68, :128)
//     -> kv_pull_kernel, `txn_bytes` contiguous bytes per transaction (the
//     transfer engine expands coalesced runs into single-page ids);
//   * kv_pull_dequant          (kernel.py:92)
//     -> kv_pull_dequant_kernel.
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
// round-to-nearest-even cast).
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

// dst_dtype: 0 = float32, 1 = bfloat16.
extern "C" int kv_pull_dequant_launch(const void* src, void* dst, const void* src_ids,
                                      const void* dst_ids, const void* scales,
                                      int n_txn, int64_t page_elems, int dst_dtype,
                                      void* stream) {
  if (n_txn <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(n_txn, chunks_for(page_elems));
  const int8_t* q = static_cast<const int8_t*>(src);
  const int32_t* sid = static_cast<const int32_t*>(src_ids);
  const int32_t* did = static_cast<const int32_t*>(dst_ids);
  const float* sc = static_cast<const float*>(scales);
  if (dst_dtype == 0) {
    kv_pull_dequant_kernel<float><<<grid, kThreads, 0, s>>>(
        q, static_cast<float*>(dst), sid, did, sc, page_elems);
  } else if (dst_dtype == 1) {
    kv_pull_dequant_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        q, static_cast<__nv_bfloat16*>(dst), sid, did, sc, page_elems);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

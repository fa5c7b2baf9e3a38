// NN-descent candidate merge for Hopper (sm_90a): per row, the K incumbent
// (id, distance) pairs and the P scored proposals -> drop ids >= n, dedupe
// by id keeping the smallest distance, keep the (distance, id) top-K.
//
// Replaces the Pallas kernel _candidate_merge_kernel of
// src/repro/kernels/build_kernel.py (pallas_call at :96).  The TPU kernel
// sorted ids as fp32 keys, which capped n below 2^24; here the comparator
// reads the int32 id itself, so there is no cap.
//
// Layout: one block per row.  The K + P pairs are loaded into shared memory
// and padded to W = next_pow2(K + P) with (n, BIG) (848 -> 1024 at the
// build's K 64 and local-join P 784).  Pass 1 sorts by (id, distance,
// position) and turns every repeat of an id, and every id >= n, into
// (n, BIG); pass 2 sorts by (distance, id, position) and the first K items
// are written out.  No arithmetic is done, so the output is bit-equal to
// the plain version (kernels/ref.candidate_merge_ref), whose stable sorts
// order the same total key.
//
// Bound: bytes.  A row reads 8·(K + P) bytes and writes 8·K, so n rows move
// 8·(2K + P)·n bytes: 7.3 GB at the build's 1M rows, about 2.2 ms at
// 3.35 TB/s.  The 2·55 bitonic steps of W/2 compare-exchanges per row are
// shared-memory work that this first version does not hide: the bound is
// far below it.

#include <cuda_runtime.h>

#include "sort.cuh"

namespace {

constexpr float kBig = 3.0e38f;

__global__ void candidate_merge_kernel(const int* __restrict__ cid,
                                       const float* __restrict__ cd,
                                       const int* __restrict__ pid,
                                       const float* __restrict__ pd,
                                       int* __restrict__ oid,
                                       float* __restrict__ od, int K, int P,
                                       int n, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  SortItem* items = reinterpret_cast<SortItem*>(smem);
  const size_t row = blockIdx.x;

  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    int id = n;
    float d = kBig;
    if (i < K) {
      id = cid[row * K + i];
      d = cd[row * K + i];
    } else if (i < K + P) {
      id = pid[row * P + (i - K)];
      d = pd[row * P + (i - K)];
    }
    if (id >= n) {
      id = n;
      d = kBig;
    }
    items[i] = SortItem{d, id, i, 0};
  }
  __syncthreads();
  block_bitonic_sort(items, W, ByIdDist());

  // mark repeats (reads ids, writes flags only), then mask them
  for (int i = threadIdx.x; i < W; i += blockDim.x)
    items[i].flag = (i > 0 && items[i].id == items[i - 1].id) ||
                    items[i].id >= n;
  __syncthreads();
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    if (items[i].flag) {
      items[i].id = n;
      items[i].d = kBig;
    }
    items[i].pos = i;
  }
  __syncthreads();
  block_bitonic_sort(items, W, ByDistId());

  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    oid[row * K + i] = items[i].id;
    od[row * K + i] = items[i].d;
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Largest W (K + P rounded up to a power of two) one block can hold: 8192
// items of 16 bytes, 128 KB of the 227 KB a block may opt in to.
int candidate_merge_max_width() { return 8192; }

// oid/od (B, K) <- merge of cid/cd (B, K) with pid/pd (B, P); W is
// next_pow2(K + P).  Returns cudaGetLastError() after the launch.
int candidate_merge(const void* cid, const void* cd, const void* pid,
                    const void* pd, void* oid, void* od, int B, int K, int P,
                    int n, int W, void* stream) {
  const int threads = W / 2 < 256 ? W / 2 : 256;
  const size_t smem = size_t(W) * sizeof(SortItem);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        candidate_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  candidate_merge_kernel<<<B, threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cid), static_cast<const float*>(cd),
      static_cast<const int*>(pid), static_cast<const float*>(pd),
      static_cast<int*>(oid), static_cast<float*>(od), K, P, n, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

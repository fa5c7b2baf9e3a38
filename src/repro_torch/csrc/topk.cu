// Expand-merge for Hopper (sm_90a): score R pre-gathered neighbour vectors
// against the query and merge the fresh ones into the sorted (ef) beam by
// (distance, id), carrying the checked flag.
//
// Replaces the Pallas kernel _expand_merge_kernel of
// src/repro/kernels/topk_kernel.py (pallas_call at :122), whose bitonic
// network broke key ties by id; the shared sort (sort.cuh) breaks them by
// id and then by position, which is the plain version's stable order.
//
// Layout: one block per query, 256 threads.  The query is staged in shared
// memory; warp w scores candidates w, w + 8, ...: each neighbour element is
// read in its stored encoding (fp32, or bf16 widened to fp32 by its bits,
// which is exact, as the reference kernel casts it) and lane l sums the products
// of dims l, l + 32, ... with separately rounded multiplies and adds, then
// the warp's xor-butterfly adds the 32 partials.  That is the order of
// kernels/ref.lane_dot, so the plain version (kernels/ref.expand_merge_ref)
// gives the same bits.  d = max(qn + vn - 2·dot, 0); a candidate that is not
// fresh enters as (BIG, id n, checked).  The beam, the R candidates and
// padding up to W = next_pow2(ef + R) are sorted by (distance, id,
// position) and the first ef written out.  The padding is (+inf, INT_MAX):
// it sorts after every real item, +inf beam sentinels included, so it is
// never among the first ef.
//
// Bound: bytes.  The (R, d) fp32 neighbour rows dominate: at stage-① shapes
// (B 128, R 32, d 48, ef 128) a call moves about 1.1 MB, 0.3 us at
// 3.35 TB/s.  The bitonic steps in shared memory, not the bytes, set this
// first version's time.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sort.cuh"

namespace {

constexpr float kBig = 3.0e38f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr size_t kSmemLimit = 48 * 1024;  // no opt-in shared memory

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Neighbour-vector encodings (the wrapper's _ENCODINGS, kernels/topk_kernel.py)
enum Enc : int { kF32 = 0, kBF16 = 1 };

// Element i of the (B, R, d) neighbour vectors, widened to fp32: bf16 by its
// bits (exact).
template <int ENC>
__device__ __forceinline__ float load_vec(const void* nvecs, size_t i) {
  if (ENC == kBF16)
    return __uint_as_float(unsigned(static_cast<const uint16_t*>(nvecs)[i]) << 16);
  return static_cast<const float*>(nvecs)[i];
}

template <int ENC>
__global__ void __launch_bounds__(kThreads)
expand_merge_kernel(const float* __restrict__ q,
                    const void* __restrict__ nvecs,
                    const int* __restrict__ nids,
                    const bool* __restrict__ fresh,
                    const int* __restrict__ bid,
                    const float* __restrict__ bd,
                    const bool* __restrict__ bck, int* __restrict__ oid,
                    float* __restrict__ od, bool* __restrict__ ock, int d,
                    int R, int ef, int n, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  SortItem* items = reinterpret_cast<SortItem*>(smem);
  float* qs = reinterpret_cast<float*>(items + W);
  __shared__ float qn_s;
  const size_t b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  for (int k = threadIdx.x; k < d; k += blockDim.x) qs[k] = q[b * d + k];
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    if (i < ef)
      items[i] = SortItem{bd[b * ef + i], bid[b * ef + i], i,
                          bck[b * ef + i] ? 1 : 0};
    else if (i >= ef + R)  // padding: after every real item, never output
      items[i] = SortItem{INFINITY, INT_MAX, i, 1};
  }
  __syncthreads();
  if (warp == 0) {
    float s = 0.f;
    for (int k = lane; k < d; k += 32) s = __fadd_rn(s, __fmul_rn(qs[k], qs[k]));
    s = warp_sum(s);
    if (lane == 0) qn_s = s;
  }
  __syncthreads();
  const float qn = qn_s;

  for (int r = warp; r < R; r += n_warps) {
    const bool f = fresh[b * R + r];
    float dist = kBig;
    int id = n;
    if (f) {
      const size_t v = (b * R + r) * size_t(d);
      float vn = 0.f, dot = 0.f;
      for (int k = lane; k < d; k += 32) {
        const float x = load_vec<ENC>(nvecs, v + k);
        vn = __fadd_rn(vn, __fmul_rn(x, x));
        dot = __fadd_rn(dot, __fmul_rn(x, qs[k]));
      }
      vn = warp_sum(vn);
      dot = warp_sum(dot);
      dist = fmaxf(__fsub_rn(__fadd_rn(qn, vn), 2.f * dot), 0.f);
      id = nids[b * R + r];
    }
    if (lane == 0) items[ef + r] = SortItem{dist, id, ef + r, f ? 0 : 1};
  }
  __syncthreads();
  block_bitonic_sort(items, W, ByDistId());

  for (int i = threadIdx.x; i < ef; i += blockDim.x) {
    oid[b * ef + i] = items[i].id;
    od[b * ef + i] = items[i].d;
    ock[b * ef + i] = items[i].flag != 0;
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Shared memory one block needs (the kernel is launched with it as dynamic
// shared memory).
size_t expand_merge_smem_bytes(int W, int d) {
  return size_t(W) * sizeof(SortItem) + size_t(d) * sizeof(float);
}

// The most shared memory a launch may ask for; the wrapper refuses more.
size_t expand_merge_smem_limit() { return kSmemLimit; }

// oid/od/ock (B, ef) <- the beam bid/bd/bck (B, ef) merged with the fresh
// rows of nvecs (B, R, d) in encoding `enc` (Enc above) / nids (B, R)
// scored against q (B, d); W is next_pow2(ef + R).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for an
// unknown encoding.
int expand_merge(const void* q, const void* nvecs, int enc, const void* nids,
                 const void* fresh, const void* bid, const void* bd,
                 const void* bck, void* oid, void* od, void* ock, int B,
                 int d, int R, int ef, int n, int W, void* stream) {
  auto kern = enc == kF32 ? expand_merge_kernel<kF32>
            : enc == kBF16 ? expand_merge_kernel<kBF16> : nullptr;
  if (kern == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<B, kThreads, expand_merge_smem_bytes(W, d),
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), nvecs,
      static_cast<const int*>(nids), static_cast<const bool*>(fresh),
      static_cast<const int*>(bid), static_cast<const float*>(bd),
      static_cast<const bool*>(bck), static_cast<int*>(oid),
      static_cast<float*>(od), static_cast<bool*>(ock), d, R, ef, n, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

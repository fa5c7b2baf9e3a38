// Expand-merge for Hopper (sm_90a): score R pre-gathered neighbour vectors
// against the query and merge the fresh ones into the sorted (ef) beam by
// (distance, id), carrying the checked flag.
//
// Replaces the Pallas kernel _expand_merge_kernel of
// src/repro/kernels/topk_kernel.py (pallas_call at :122), whose bitonic
// network broke key ties by id; here ties go to the id and then to the
// position (beam first, then the candidates in order), which is the plain
// version's stable order.
//
// Layout: one block per query, 256 threads.
//   1. Score.  Warp w scores candidates w, w + 8, ..., four at a time: every
//      lane issues the loads of its dims of all four rows (and of q) before
//      any sum, and the first four rows are in flight while the beam is
//      staged.  Each element is read in its stored encoding (fp32, or bf16
//      widened by its bits, which is exact, as the reference kernel casts
//      it); lane l sums the products of dims l, l + 32, ... with separately
//      rounded multiplies and adds, then the warp's xor-butterfly adds the
//      32 partials.  That is the order of kernels/ref.lane_dot, so the plain
//      version (kernels/ref.expand_merge_ref) gives the same bits.  d =
//      max(qn + vn - 2·dot, 0); a candidate that is not fresh enters as
//      (BIG, id n, checked).  Meanwhile every thread stages its beam items
//      and tests whether the beam is sorted by (distance, id) and holds no
//      NaN; one __syncthreads_or combines the tests.
//   2. Fast route (R <= 32 and a sorted beam, the reference's contract):
//      warp 0 sorts the candidates in registers by (distance, id,
//      position), a 15-step shuffle bitonic network with no block barrier;
//      then every item is written straight to its rank: beam item i to
//      i + #{candidates before it by (distance, id)} and candidate j to
//      j + #{beam items not after it} (ties go to the beam, whose positions
//      are lower), each count a binary search of the other sorted list;
//      slots from ef on are not written.
//   3. Sort route (R > 32, or a beam that is not sorted or holds a NaN,
//      which sorts after every number as in the plain sort): the beam, the
//      candidates and padding up to W = next_pow2(ef + R) are sorted by
//      (distance, id, position) in shared memory (sort.cuh) and the first
//      ef written out.  The padding is (NaN, INT_MAX) at positions past
//      every real item: it sorts after them all, NaN and +inf included.
// Distances compare as floats, so -0.0 equals +0.0 as in the plain sort.
//
// Bound: bytes.  The (R, d) neighbour rows dominate: at stage-① shapes
// (B 128, R 32, d 48, ef 128, fp32) a call moves about 1.1 MB, 0.34 us at
// 3.35 TB/s, less than one wave of any launch; at B 8,192 it moves 72 MB,
// 21.5 us.  What the design does about it: the rows are read once, all
// loads of a warp in flight together, and the merge costs three block
// barriers where the block-wide sort of the first version cost 36.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sort.cuh"

namespace {

constexpr float kBig = 3.0e38f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;                 // candidates a warp scores at once
constexpr int kChunks = 2;                // dims l + 32c, c < kChunks, unrolled
constexpr size_t kSmemLimit = 48 * 1024;  // no opt-in shared memory

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

// (distance, id) strictly before: the merge's order between the two lists
__device__ __forceinline__ bool before(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
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
  SortItem* items = reinterpret_cast<SortItem*>(smem);  // beam, candidates, pad
  const size_t b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* qb = q + b * d;

  // ---- 1. score four candidates at a time and stage the beam ----------
  // A warp's candidates r0 + 8u, u < 4: fresh flags, ids and the lane's
  // dims of each row, all loads issued before any is used.
  float x[kGroup][kChunks];
  bool f[kGroup];
  int id[kGroup];
  auto load_group = [&](int r0) {
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int r = r0 + kWarps * u;
      const bool live = r < R;
      f[u] = live && fresh[b * R + r];
      id[u] = live ? nids[b * R + r] : n;
      const size_t row = (b * R + (live ? r : 0)) * size_t(d);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int k = lane + 32 * c;
        x[u][c] = live && k < d ? load_vec<ENC>(nvecs, row + k) : 0.f;
      }
    }
  };
  float qv[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int k = lane + 32 * c;
    qv[c] = k < d ? qb[k] : 0.f;
  }
  load_group(warp);  // in flight while the beam is staged

  // the beam (and the sort route's padding) into shared memory, and
  // whether it is sorted by (distance, id)
  int unsorted = 0;
  for (int i = threadIdx.x; i < W; i += kThreads) {
    if (i < ef) {
      const float di = bd[b * ef + i];
      const int ii = bid[b * ef + i];
      items[i] = SortItem{di, ii, i, bck[b * ef + i] ? 1 : 0};
      // in order unless the next item is strictly before this one; a NaN
      // (which has no place in the order the ranks count in) on either
      // side fails both compares; the last item's own test covers ef 1
      if (i + 1 < ef) {
        const float dn = bd[b * ef + i + 1];
        unsorted |= !(di < dn || (di == dn && ii <= bid[b * ef + i + 1]));
      } else {
        unsorted |= di != di;
      }
    } else if (i >= ef + R) {  // padding: after every real item, never output
      items[i] = SortItem{__int_as_float(0x7fc00000), INT_MAX, i, 1};
    }
  }

  float qn = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    if (lane + 32 * c < d) qn = __fadd_rn(qn, __fmul_rn(qv[c], qv[c]));
  for (int k = lane + 32 * kChunks; k < d; k += 32)
    qn = __fadd_rn(qn, __fmul_rn(qb[k], qb[k]));
  for (int o = 16; o; o >>= 1) qn += __shfl_xor_sync(kFull, qn, o);

  for (int r0 = warp; r0 < R; r0 += kWarps * kGroup) {
    if (r0 != warp) load_group(r0);
    float vn[kGroup], dot[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      vn[u] = 0.f;
      dot[u] = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        if (lane + 32 * c < d) {
          vn[u] = __fadd_rn(vn[u], __fmul_rn(x[u][c], x[u][c]));
          dot[u] = __fadd_rn(dot[u], __fmul_rn(x[u][c], qv[c]));
        }
      const int r = r0 + kWarps * u;
      if (r < R) {
        const size_t row = (b * R + r) * size_t(d);
        for (int k = lane + 32 * kChunks; k < d; k += 32) {
          const float xk = load_vec<ENC>(nvecs, row + k);
          vn[u] = __fadd_rn(vn[u], __fmul_rn(xk, xk));
          dot[u] = __fadd_rn(dot[u], __fmul_rn(xk, qb[k]));
        }
      }
    }
#pragma unroll
    for (int o = 16; o; o >>= 1)
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        vn[u] += __shfl_xor_sync(kFull, vn[u], o);
        dot[u] += __shfl_xor_sync(kFull, dot[u], o);
      }
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int r = r0 + kWarps * u;
        if (r < R) {
          const float dist =
              f[u] ? fmaxf(__fsub_rn(__fadd_rn(qn, vn[u]), 2.f * dot[u]), 0.f)
                   : kBig;
          items[ef + r] = SortItem{dist, f[u] ? id[u] : n, ef + r, f[u] ? 0 : 1};
        }
      }
    }
  }
  unsorted = __syncthreads_or(unsorted);

  if (R <= 32 && !unsorted) {
    // ---- 2. fast route: warp sort of the candidates, then ranks --------
    if (warp == 0) {
      SortItem it = lane < R ? items[ef + lane]
                             : SortItem{INFINITY, INT_MAX, ef + lane, 1};
      warp_bitonic_sort(it, lane, ByDistIdNumbers());
      if (lane < R) items[ef + lane] = it;
    }
    __syncthreads();
    const SortItem* cand = items + ef;
    for (int i = threadIdx.x; i < ef + R; i += kThreads) {
      const SortItem it = items[i];
      int rank;
      if (i < ef) {  // beam item: candidates strictly before it
        int lo = 0, hi = R;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (before(cand[mid].d, cand[mid].id, it.d, it.id)) lo = mid + 1;
          else hi = mid;
        }
        rank = i + lo;
      } else {       // candidate: beam items not after it
        int lo = 0, hi = ef;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (!before(it.d, it.id, items[mid].d, items[mid].id)) lo = mid + 1;
          else hi = mid;
        }
        rank = i - ef + lo;
      }
      if (rank < ef) {
        oid[b * ef + rank] = it.id;
        od[b * ef + rank] = it.d;
        ock[b * ef + rank] = it.flag != 0;
      }
    }
    return;
  }

  // ---- 3. sort route ----------------------------------------------------
  block_bitonic_sort(items, W, ByDistId());
  for (int i = threadIdx.x; i < ef; i += kThreads) {
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
// shared memory): the W sort items of the sort route.
size_t expand_merge_smem_bytes(int W, int d) {
  (void)d;
  return size_t(W) * sizeof(SortItem);
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

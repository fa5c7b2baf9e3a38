// Bitonic sorts of (distance, id, position, flag) items, used by the
// expand-merge (topk.cu, K6): one across a block in shared memory, one
// across a warp in registers.
//
// Replaces _bitonic_sort_pairs of src/repro/kernels/topk_kernel.py, which
// sorted float keys with an id payload across the TPU's lanes.  Here the
// comparator sees the whole item: distances compare as floats (so -0.0 ==
// +0.0, as in the reference's sort; NaN last), ties go to the id and then to the
// position the item had before the sort.  With the position last the
// order is total, so the unstable network gives exactly the stable sort of
// the plain versions (kernels/ref.lexsort2).

#pragma once

struct SortItem {
  float d;
  int id;
  int pos;
  int flag;
};

// (distance, id, position) ascending, for items whose distance is never
// NaN (K6's candidates: max(., 0) or BIG; the warp sort's padding +inf)
struct ByDistIdNumbers {
  __device__ __forceinline__ bool operator()(const SortItem& a,
                                             const SortItem& b) const {
    if (a.d != b.d) return a.d < b.d;
    if (a.id != b.id) return a.id < b.id;
    return a.pos < b.pos;
  }
};

// The same order where a distance may be NaN (the beam's): a NaN sorts
// after every number and ties with any other NaN, as in the plain
// versions' sort
struct ByDistId {
  __device__ __forceinline__ bool operator()(const SortItem& a,
                                             const SortItem& b) const {
    const bool na = a.d != a.d, nb = b.d != b.d;
    if (na != nb) return nb;
    if (!na && a.d != b.d) return a.d < b.d;
    if (a.id != b.id) return a.id < b.id;
    return a.pos < b.pos;
  }
};

// W items in shared memory, W a power of two; the block's threads share
// its W/2 compare-exchange pairs per step.  The caller has synchronised the
// block before the call; the sort ends with a barrier.
template <class Less>
__device__ void block_bitonic_sort(SortItem* a, int W, Less less) {
  for (int k = 2; k <= W; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < (W >> 1); t += blockDim.x) {
        // the pair's lower index: t with a 0 bit inserted at bit log2(j)
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int p = i | j;
        const SortItem x = a[i], y = a[p];
        const bool up = (i & k) == 0;
        if (up ? less(y, x) : less(x, y)) {
          a[i] = y;
          a[p] = x;
        }
      }
      __syncthreads();
    }
  }
}

// 32 items, one a lane of a full warp, sorted into lane order in registers:
// the same network on 32 items, 15 compare-exchange steps, each a lane and
// its partner lane ^ j trading items by shuffles; no shared memory and no
// barrier.  Of each pair the lower lane keeps the smaller item in an
// ascending run (lane & k == 0) and the larger in a descending one.
template <class Less>
__device__ __forceinline__ void warp_bitonic_sort(SortItem& it, int lane,
                                                  Less less) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      SortItem o;
      o.d = __shfl_xor_sync(0xffffffffu, it.d, j);
      o.id = __shfl_xor_sync(0xffffffffu, it.id, j);
      o.pos = __shfl_xor_sync(0xffffffffu, it.pos, j);
      o.flag = __shfl_xor_sync(0xffffffffu, it.flag, j);
      const bool up = (lane & k) == 0, lower = (lane & j) == 0;
      if (lower == up ? less(o, it) : less(it, o)) it = o;
    }
  }
}

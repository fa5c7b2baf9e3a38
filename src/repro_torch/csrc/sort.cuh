// Block-wide bitonic sort of (distance, id, position, flag) items in shared
// memory, used by the expand-merge (topk.cu, K6).
//
// Replaces _bitonic_sort_pairs of src/repro/kernels/topk_kernel.py, which
// sorted float keys with an id payload across the TPU's lanes.  Here the
// comparator sees the whole item: distances compare as floats (so -0.0 ==
// +0.0, as in the reference's sort), ties go to the id and then to the
// position the item had before the sort.  With the position last the
// order is total, so the unstable network gives exactly the stable sort of
// the plain versions (kernels/ref.lexsort2).
//
// W is a power of two; the block's threads share its W/2 compare-exchange
// pairs per step.  The caller has synchronised the block before the call;
// the sort ends with a barrier.

#pragma once

struct SortItem {
  float d;
  int id;
  int pos;
  int flag;
};

// (distance, id, position) ascending
struct ByDistId {
  __device__ __forceinline__ bool operator()(const SortItem& a,
                                             const SortItem& b) const {
    if (a.d != b.d) return a.d < b.d;
    if (a.id != b.id) return a.id < b.id;
    return a.pos < b.pos;
  }
};

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

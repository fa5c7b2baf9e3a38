// NN-descent candidate merge for Hopper (sm_90a): per row, the K incumbent
// (id, distance) pairs and the P scored proposals -> drop ids >= n, dedupe
// by id keeping the smallest distance, keep the (distance, id) top-K.
//
// Replaces the Pallas kernel _candidate_merge_kernel of
// src/repro/kernels/build_kernel.py (pallas_call at :96).  The TPU kernel
// sorted ids as fp32 keys, which capped n below 2^24; here an id is the
// high or low word of a 64-bit key, so there is no cap.
//
// Keys.  An entry is a 64-bit key and a 32-bit tag.  The distance becomes
// its order-preserving bits with -0.0 folded to +0.0 (floats compare as
// floats: -0.0 == +0.0), the id its bits with the sign flipped (signed
// order); "id-major" puts the id in the high word, "distance-major" the
// distance.  The tag is (position << 1) | (the distance was -0.0): the
// position breaks ties as the plain version's stable sorts do, the bit
// gives the output the kept copy's own zero.  ids >= n enter as the
// sentinel (n, BIG).
//
// One warp per row, up to 8 rows per block, each warp with its own
// shared-memory list of W = next_pow2(K + P) entries, sorted when it must
// be by a warp-wide bitonic network (__syncwarp between steps, no block
// barrier).  merge(): sort id-major, turn every repeat of an id (and every
// id >= n) into the sentinel, rewrite distance-major, sort again; the
// first K are the merge.
//
//   A. The K incumbents, written distance-major in their own order and
//      entered in a 256-slot table of held ids (open addressing; K <= 128).
//      If they are valid and distinct, the largest key is a threshold, and
//      if they are also sorted (NN-descent's invariant) they are already
//      their own merge.  The kernel assumes none of it: unsorted rows are
//      merged in C, rows with sentinels or repeats have no threshold, and
//      with K > 128 (no table) merge() orders the incumbents first and the
//      K-th key is the threshold.
//   B. With a threshold, a proposal whose distance-major key is not below
//      it cannot enter the top K, nor can a proposal for a held id at a key
//      not below the incumbent's (it loses to the incumbent's smaller
//      distance, or to its earlier position on a tie).  The warp reads the
//      proposals 8 x 32 at a time, coalesced, and compacts the survivors
//      behind the incumbents with a ballot.  Without one (the seeding
//      merge, the reverse-edge pass, any row with sentinels or repeats)
//      every proposal survives, the bad ones as sentinels, so the list is
//      the plain version's.
//   C. At most 32 survivors and sorted incumbents (NN-descent's late
//      rounds): the incumbents go into registers, two words a position,
//      and each survivor in turn replaces its id's copy if it comes before
//      it, or enters at its rank (a ballot) while the last entry falls out,
//      positions moving by warp shuffles.  Otherwise merge() runs over the
//      incumbents and the survivors.
//
// No arithmetic is done, so the output equals the plain version's
// (kernels/ref.candidate_merge_ref) in ids and in distance bits.  NaN
// distances are outside the contract.
//
// Bound: bytes.  A row reads 8·(K + P) bytes and writes 8·K, so n rows move
// 8·(2K + P)·n bytes: 7.3 GB at the build's 1M rows and K 64, P 784, about
// 2.2 ms at 3.35 TB/s.  In NN-descent's late rounds few proposals pass the
// threshold and the held-id test and nothing is sorted, so the loads set
// the time; in the seeding and the first rounds one merge() sorts the full
// width twice.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.0e38f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;                 // rows per block
constexpr int kSmemPerBlock = 100 * 1024;    // lists of a block's warps
constexpr int kEntryBytes = 8 + 4;           // key + tag
constexpr uint64_t kPad = ~uint64_t(0);      // sorts after every entry
constexpr int kSlotBits = 8;                 // the held-id table: 256 slots
constexpr int kSlots = 1 << kSlotBits;
constexpr int kEmpty = 0x7fffffff;           // no valid id (ids < n)
constexpr int kUnroll = 8;                   // proposal chunks in flight
constexpr int kE = 4;                        // insertion: K <= 32·kE
constexpr int kInsertMax = 32;               // survivors inserted one by one

__device__ __forceinline__ uint32_t dist_bits(float d) {
  uint32_t u = __float_as_uint(d);
  if (u == 0x80000000u) u = 0;               // -0.0 -> +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float dist_of(uint32_t o, bool neg_zero) {
  const uint32_t u = (o & 0x80000000u) ? (o & 0x7fffffffu) : ~o;
  return __uint_as_float(neg_zero ? 0x80000000u : u);
}

__device__ __forceinline__ uint32_t id_bits(int id) {
  return static_cast<uint32_t>(id) ^ 0x80000000u;
}

__device__ __forceinline__ uint64_t dist_major(int id, float d) {
  return (uint64_t(dist_bits(d)) << 32) | id_bits(id);
}

__device__ __forceinline__ uint64_t swap_words(uint64_t k) {
  return (k << 32) | (k >> 32);
}

__device__ __forceinline__ uint32_t tag(int pos, float d) {
  return (uint32_t(pos) << 1) | (__float_as_uint(d) == 0x80000000u);
}

// ascending by (key, tag); W a power of two
__device__ void warp_sort(uint64_t* key, uint32_t* tg, int W, int lane) {
  for (int k = 2; k <= W; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = lane; t < (W >> 1); t += 32) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int p = i | j;
        const uint64_t ki = key[i], kp = key[p];
        const uint32_t ai = tg[i], ap = tg[p];
        const bool greater = ki > kp || (ki == kp && ai > ap);
        if (greater == ((i & k) == 0)) {
          key[i] = kp;
          key[p] = ki;
          tg[i] = ap;
          tg[p] = ai;
        }
      }
      __syncwarp();
    }
  }
}

// L id-major entries -> the same multiset deduplicated, distance-major and
// ascending in [0, L); repeats and ids >= n become the sentinel
__device__ void merge(uint64_t* key, uint32_t* tg, int L, int n, int lane) {
  int W = 2;
  while (W < L) W <<= 1;
  for (int i = L + lane; i < W; i += 32) {
    key[i] = kPad;
    tg[i] = kFull;
  }
  __syncwarp();
  warp_sort(key, tg, W, lane);
  const uint32_t nb = id_bits(n);
  for (int i = lane; i < L; i += 32) {       // mark: reads keys only
    const uint32_t id = uint32_t(key[i] >> 32);
    if (id >= nb || (i > 0 && uint32_t(key[i - 1] >> 32) == id))
      tg[i] |= 0x80000000u;
  }
  __syncwarp();
  const uint64_t sentinel = dist_major(n, kBig);
  for (int i = lane; i < L; i += 32) {
    if (tg[i] & 0x80000000u) {
      key[i] = sentinel;
      tg[i] = 0;
    } else {
      key[i] = swap_words(key[i]);
    }
  }
  __syncwarp();
  warp_sort(key, tg, W, lane);
}

// (a, at) < (b, bt)
__device__ __forceinline__ bool before(uint64_t a, uint32_t at, uint64_t b,
                                       uint32_t bt) {
  return a < b || (a == b && at < bt);
}

// The K (<= 32·kE) sorted, distinct incumbents key/tg[0, K) take the s
// survivors key/tg[K, K + s) one at a time, all distance-major; position
// p = lane + 32·e lives in register e of lane p % 32.  A survivor whose id
// is present replaces it if it comes before it, else is dropped; a new id
// is inserted at its rank and the last entry falls out.  The first K are
// written out.
__device__ void insert_and_write(const uint64_t* key, const uint32_t* tg,
                                 int K, int s, int* oid, float* od,
                                 int lane) {
  uint64_t rk[kE];
  uint32_t rt[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int p = lane + 32 * e;
    rk[e] = p < K ? key[p] : kPad;
    rt[e] = p < K ? tg[p] : kFull;
  }
  for (int j = 0; j < s; ++j) {
    const uint64_t xk = key[K + j];
    const uint32_t xt = tg[K + j];
    const uint32_t xid = uint32_t(xk);
    int r = -1;                           // the position of the same id
    uint64_t rk_r = 0;
    uint32_t rt_r = 0;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const unsigned m = __ballot_sync(
          kFull, lane + 32 * e < K && uint32_t(rk[e]) == xid);
      if (m) {
        const int src = __ffs(m) - 1;
        r = 32 * e + src;
        rk_r = __shfl_sync(kFull, rk[e], src);
        rt_r = __shfl_sync(kFull, rt[e], src);
      }
    }
    if (r >= 0) {
      if (!before(xk, xt, rk_r, rt_r)) continue;
      // remove position r: positions above it move down by one
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        uint64_t nk = __shfl_down_sync(kFull, rk[e], 1);
        uint32_t nt = __shfl_down_sync(kFull, rt[e], 1);
        const int up = e + 1 < kE ? e + 1 : e;
        uint64_t wk = __shfl_sync(kFull, rk[up], 0);
        uint32_t wt = __shfl_sync(kFull, rt[up], 0);
        if (e + 1 == kE) {
          wk = kPad;
          wt = kFull;
        }
        if (lane == 31) {
          nk = wk;
          nt = wt;
        }
        if (lane + 32 * e >= r) {
          rk[e] = nk;
          rt[e] = nt;
        }
      }
    }
    int rank = 0;                         // entries before the survivor
#pragma unroll
    for (int e = 0; e < kE; ++e)
      rank += __popc(__ballot_sync(kFull, before(rk[e], rt[e], xk, xt)));
    if (rank >= K) continue;
    // insert at rank: positions from it move up by one
#pragma unroll
    for (int e = kE - 1; e >= 0; --e) {
      uint64_t nk = __shfl_up_sync(kFull, rk[e], 1);
      uint32_t nt = __shfl_up_sync(kFull, rt[e], 1);
      const uint64_t wk = __shfl_sync(kFull, rk[e > 0 ? e - 1 : 0], 31);
      const uint32_t wt = __shfl_sync(kFull, rt[e > 0 ? e - 1 : 0], 31);
      if (lane == 0) {
        nk = wk;
        nt = wt;
      }
      const int p = lane + 32 * e;
      if (p == rank) {
        nk = xk;
        nt = xt;
      }
      if (p >= rank) {
        rk[e] = nk;
        rt[e] = nt;
      }
    }
  }
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int p = lane + 32 * e;
    if (p < K) {
      oid[p] = static_cast<int>(uint32_t(rk[e]) ^ 0x80000000u);
      od[p] = dist_of(uint32_t(rk[e] >> 32), rt[e] & 1u);
    }
  }
}

// the held-id table of a row's incumbents: open addressing over kSlots
__device__ __forceinline__ int slot_of(int id) {
  return static_cast<int>((static_cast<uint32_t>(id) * 2654435761u) >>
                          (32 - kSlotBits));
}

__global__ void candidate_merge_kernel(const int* __restrict__ cid,
                                       const float* __restrict__ cd,
                                       const int* __restrict__ pid,
                                       const float* __restrict__ pd,
                                       int* __restrict__ oid,
                                       float* __restrict__ od, int B, int K,
                                       int P, int n, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  const size_t row = size_t(blockIdx.x) * warps + warp;
  if (row >= size_t(B)) return;
  uint64_t* keys = reinterpret_cast<uint64_t*>(smem);
  uint64_t* key = keys + size_t(warp) * W;
  uint64_t* held_key = keys + size_t(warps) * W + warp * kSlots;
  uint32_t* tg = reinterpret_cast<uint32_t*>(keys + size_t(warps) *
                                                        (W + kSlots)) +
                 size_t(warp) * W;
  int* held_id = reinterpret_cast<int*>(tg - size_t(warp) * W +
                                        size_t(warps) * W) +
                 warp * kSlots;
  const bool hashed = K <= kSlots / 2;      // also K <= 32·kE

  // A. the incumbents, distance-major in their own order, and in the
  // held-id table when it has room
  if (hashed)
    for (int i = lane; i < kSlots; i += 32) held_id[i] = kEmpty;
  __syncwarp();
  bool bad = false, dup = false;
  for (int i = lane; i < K; i += 32) {
    int id = cid[row * K + i];
    float d = cd[row * K + i];
    if (id >= n) {
      id = n;
      d = kBig;
      bad = true;
    }
    const uint64_t k = dist_major(id, d);
    key[i] = k;
    tg[i] = tag(i, d);
    if (hashed && id < n) {
      for (int h = slot_of(id);; h = (h + 1) & (kSlots - 1)) {
        const int was = atomicCAS(&held_id[h], kEmpty, id);
        if (was == kEmpty) {
          held_key[h] = k;
          break;
        }
        if (was == id) {
          dup = true;
          break;
        }
      }
    }
  }
  __syncwarp();
  bool unsorted = false;
  for (int i = lane; i + 1 < K; i += 32) unsorted |= key[i] >= key[i + 1];
  const bool flawed = __any_sync(kFull, bad || dup);
  // sorted: key[0, K) is already the incumbents' merge
  bool sorted = hashed && !flawed && !__any_sync(kFull, unsorted);
  uint64_t theta = kPad;
  if (!hashed) {                    // repeats unknown: merge them to know
    for (int i = lane; i < K; i += 32) key[i] = swap_words(key[i]);
    __syncwarp();
    merge(key, tg, K, n, lane);
    sorted = true;
    if (key[K - 1] < dist_major(n, kBig)) theta = key[K - 1];
  } else if (!flawed) {             // K distinct valid: the largest key
    uint64_t mx = 0;
    for (int i = lane; i < K; i += 32) mx = key[i] > mx ? key[i] : mx;
    for (int off = 16; off > 0; off >>= 1) {
      const uint64_t o = __shfl_xor_sync(kFull, mx, off);
      mx = o > mx ? o : mx;
    }
    if (mx < dist_major(n, kBig)) theta = mx;
  }
  // with a threshold the incumbents are distinct and in the table: a
  // proposal for a held id at a key not below the incumbent's is dropped
  const bool drop_held = hashed && theta != kPad;

  // B. the proposals below the threshold, compacted behind them, read
  // kUnroll chunks of 32 at a time
  int s = 0;
  for (int c0 = 0; c0 < P; c0 += 32 * kUnroll) {
    int ids[kUnroll];
    float ds[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = c0 + 32 * u + lane;
      ids[u] = i < P ? pid[row * P + i] : n;
      ds[u] = i < P ? pd[row * P + i] : kBig;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = c0 + 32 * u + lane;
      int id = ids[u];
      float d = ds[u];
      if (id >= n) {
        id = n;
        d = kBig;
      }
      const uint64_t k = dist_major(id, d);
      bool keep = i < P && k < theta;
      if (keep && drop_held) {
        for (int h = slot_of(id);; h = (h + 1) & (kSlots - 1)) {
          const int at = held_id[h];
          if (at == id) {
            keep = k < held_key[h];
            break;
          }
          if (at == kEmpty) break;
        }
      }
      const unsigned vote = __ballot_sync(kFull, keep);
      if (keep) {
        const int at = K + s + __popc(vote & ((1u << lane) - 1));
        key[at] = k;
        tg[at] = tag(K + i, d);
      }
      s += __popc(vote);
    }
  }
  __syncwarp();

  // C. few survivors into sorted incumbents: insert them one by one in
  // registers; else merge() over the incumbents and the survivors
  if (sorted && drop_held && s <= kInsertMax) {
    insert_and_write(key, tg, K, s, oid + row * K, od + row * K, lane);
    return;
  }
  if (s > 0 || !sorted) {
    for (int i = lane; i < K + s; i += 32) key[i] = swap_words(key[i]);
    __syncwarp();
    merge(key, tg, K + s, n, lane);
  }
  for (int i = lane; i < K; i += 32) {
    const uint64_t k = key[i];
    oid[row * K + i] = static_cast<int>(uint32_t(k) ^ 0x80000000u);
    od[row * K + i] = dist_of(uint32_t(k >> 32), tg[i] & 1u);
  }
}

int warps_per_block(int W) {
  int w = kMaxWarps;
  while (w > 1 && w * (W + kSlots) * kEntryBytes > kSmemPerBlock) w >>= 1;
  return w;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Largest W (K + P rounded up to a power of two) one warp's list can hold:
// 8192 entries of 12 bytes and the held-id table, 99 KB of the 227 KB a
// block may opt in to.
int candidate_merge_max_width() { return 8192; }

// oid/od (B, K) <- merge of cid/cd (B, K) with pid/pd (B, P); W is
// next_pow2(K + P).  Returns cudaGetLastError() after the launch.
int candidate_merge(const void* cid, const void* cd, const void* pid,
                    const void* pd, void* oid, void* od, int B, int K, int P,
                    int n, int W, void* stream) {
  const int warps = warps_per_block(W);
  const size_t smem = size_t(warps) * (W + kSlots) * kEntryBytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        candidate_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (B + warps - 1) / warps;
  candidate_merge_kernel<<<blocks, 32 * warps, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cid), static_cast<const float*>(cd),
      static_cast<const int*>(pid), static_cast<const float*>(pd),
      static_cast<int*>(oid), static_cast<float*>(od), B, K, P, n, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// Stage-① pilot traversal for Hopper (sm_90a): one W-wide expansion round
// (fused_traversal_hop) or the whole search to convergence
// (fused_pilot_search), dense fp32 vector table.
//
// Replaces the Pallas kernels _hop_kernel and _persistent_kernel of
// src/repro/kernels/traversal_kernel.py (pallas_call at :486 and :565), which
// share _round_body (:120-224); here both share the round body below.
//
// Layout: one thread block per query.  The beam (ids, distances, checked
// flags; double-buffered), the query row, the visited filter packed into
// 32-bit words and the W·R candidate buffer live in shared memory for the
// whole launch; the public (B, bits) bool filter is packed on entry and
// unpacked on exit.  Neighbour rows and vector rows are read straight from
// device memory (no one-hot gathers: those were a TPU workaround).
//
// Bound: bytes.  Per round a query reads W neighbour-id rows (R ids each) and
// one dp-float vector row per fresh candidate; the arithmetic is 2·dp FMAs
// per candidate.  The least time is Σ(n_dist·dp·4 + n_exp·R·id_bytes) plus
// the beam and filter in and out, over 3.35 TB/s.  The design keeps every
// other byte (beam, filter, merge buffers) on chip; the per-round cost that
// remains is latency (dependent gathers, block barriers), which one block per
// query and a convergence exit per block do not hide.  A later PR can run
// several queries per block or prefetch the next frontier's rows.
//
// Semantics, held exactly against the plain version (kernels/ref.py):
//  * frontier: the first W unchecked beam slots with id < n, in beam order;
//  * visited: frontier w's R ids are all tested against the filter as it
//    stood before frontier w's inserts, then the fresh ones are inserted
//    (duplicates inside one frontier are each scored).  Bloom hashes are
//    bit-identical to core/bloom.hashes (native uint32 wrap-around);
//  * distance: max(qn + vn - 2·dot, 0) in fp32, each sum taken in a fixed
//    order that plain PyTorch can repeat (kernels/ref.lane_dot): lane l of
//    the warp sums k = l, l+32, ... with separately rounded multiplies and
//    adds (no FMA contraction), then the warp's xor-butterfly tree.  So the
//    kernel and its plain version agree bit for bit, and near-tied
//    distances cannot order differently between them;
//  * merge: equal to the stable argsort of [beam ; new] cut to ef.  The beam
//    is distance-sorted (init_state and every round produce it sorted), so
//    a beam entry lands at i + #{fresh with d < its d}, and a fresh entry
//    at #{beam with d <= its d} + #{fresh before it in (d, position)
//    order}; non-fresh candidates (+inf) can never reach the first ef.
//  * a round without work is a fixed point, so each block exits on its own.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kSmemLimit = 232448;  // 227 KB per block on sm_90

struct Layout {
  size_t q, id0, id1, d0, d1, ck0, ck1, vis, cid, cd, cfr, fu, scal, total;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

inline Layout make_layout(int dp, int ef, int W, int R, int vbits) {
  Layout L;
  const size_t WR = size_t(W) * R;
  size_t o = 0;
  auto take = [&o](size_t bytes) { size_t at = o; o = align16(o + bytes); return at; };
  L.q = take(sizeof(float) * dp);
  L.id0 = take(sizeof(int) * ef);
  L.id1 = take(sizeof(int) * ef);
  L.d0 = take(sizeof(float) * ef);
  L.d1 = take(sizeof(float) * ef);
  L.ck0 = take(sizeof(int) * ef);
  L.ck1 = take(sizeof(int) * ef);
  L.vis = take(sizeof(unsigned) * ((size_t(vbits) + 31) / 32));
  L.cid = take(sizeof(int) * WR);
  L.cd = take(sizeof(float) * WR);
  L.cfr = take(sizeof(int) * WR);
  L.fu = take(sizeof(int) * W);
  L.scal = take(16);
  L.total = o;
  return L;
}

__device__ __forceinline__ void bloom_hashes(unsigned x, unsigned bits,
                                             unsigned& h1, unsigned& h2) {
  const unsigned a = (x * 0x9E3779B1u) ^ ((x * 0x85EBCA77u) >> 15);
  const unsigned b = (x * 0xC2B2AE3Du) ^ (x >> 13) ^ (x * 0x27D4EB2Fu);
  h1 = a % bits;
  h2 = b % bits;
}

__device__ __forceinline__ bool test_bit(const unsigned* vis, unsigned bit) {
  return (vis[bit >> 5] >> (bit & 31)) & 1u;
}

__device__ __forceinline__ void set_bit(unsigned* vis, unsigned bit) {
  atomicOr(&vis[bit >> 5], 1u << (bit & 31));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <typename IdT>
__global__ void __launch_bounds__(kThreads)
pilot_traversal_kernel(const float* __restrict__ q, const IdT* __restrict__ nbr,
                       const float* __restrict__ vec,
                       const int* __restrict__ bid_in,
                       const float* __restrict__ bd_in,
                       const unsigned char* __restrict__ bck_in,
                       const unsigned char* __restrict__ vis_in,
                       int* __restrict__ bid_out, float* __restrict__ bd_out,
                       unsigned char* __restrict__ bck_out,
                       unsigned char* __restrict__ vis_out,
                       unsigned char* __restrict__ fresh_out,
                       int* __restrict__ cnt_out, int dp, int n, int R, int ef,
                       int W, int vbits, int exact, int rounds, Layout L) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + L.q);
  int* id_c = reinterpret_cast<int*>(smem + L.id0);
  int* id_n = reinterpret_cast<int*>(smem + L.id1);
  float* d_c = reinterpret_cast<float*>(smem + L.d0);
  float* d_n = reinterpret_cast<float*>(smem + L.d1);
  int* ck_c = reinterpret_cast<int*>(smem + L.ck0);
  int* ck_n = reinterpret_cast<int*>(smem + L.ck1);
  unsigned* vis = reinterpret_cast<unsigned*>(smem + L.vis);
  int* cid = reinterpret_cast<int*>(smem + L.cid);
  float* cd = reinterpret_cast<float*>(smem + L.cd);
  int* cfr = reinterpret_cast<int*>(smem + L.cfr);
  int* fu = reinterpret_cast<int*>(smem + L.fu);
  int* nsel = reinterpret_cast<int*>(smem + L.scal);
  float* qn_s = reinterpret_cast<float*>(smem + L.scal + 4);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthr >> 5;
  const int WR = W * R;
  const int nwords = (vbits + 31) >> 5;
  const unsigned ubits = static_cast<unsigned>(vbits);

  // ---- load the query, the beam and the packed filter -------------------
  for (int k = tid; k < dp; k += nthr) qs[k] = q[size_t(b) * dp + k];
  for (int i = tid; i < ef; i += nthr) {
    const size_t g = size_t(b) * ef + i;
    id_c[i] = bid_in[g];
    d_c[i] = bd_in[g];
    ck_c[i] = bck_in[g] ? 1 : 0;
  }
  const unsigned char* vrow = vis_in + size_t(b) * vbits;
  for (int w = warp; w < nwords; w += nwarps) {  // one warp per 32-bit word
    const int bit = w * 32 + lane;
    const unsigned word = __ballot_sync(kFull, bit < vbits && vrow[bit] != 0);
    if (lane == 0) vis[w] = word;
  }
  for (int j = tid; j < WR; j += nthr) cfr[j] = 0;
  __syncthreads();
  if (warp == 0) {
    float s = 0.f;
    for (int k = lane; k < dp; k += 32) s = __fadd_rn(s, __fmul_rn(qs[k], qs[k]));
    s = warp_sum(s);
    if (lane == 0) *qn_s = s;
  }
  __syncthreads();
  const float qn = *qn_s;

  int c_dist = 0, c_hops = 0, c_exp = 0;  // thread 0's counters
  for (int it = 0; it < rounds; ++it) {
    // ---- frontier: the first W unchecked live slots, marked checked ------
    if (warp == 0) {
      int found = 0;
      for (int base = 0; base < ef && found < W; base += 32) {
        const int i = base + lane;
        const bool un = i < ef && !ck_c[i] && id_c[i] < n;
        const unsigned m = __ballot_sync(kFull, un);
        const int rank = __popc(m & ((1u << lane) - 1u));
        if (un && found + rank < W) {
          fu[found + rank] = id_c[i];
          ck_c[i] = 1;
        }
        found = min(W, found + __popc(m));
      }
      if (lane == 0) {
        for (int w = found; w < W; ++w) fu[w] = n;  // sentinel row
        *nsel = found;
      }
    }
    __syncthreads();
    const int found = *nsel;
    if (found == 0) break;  // converged: a round without work is a fixed point

    // ---- per frontier: gather ids, test, then insert the fresh ones ------
    for (int w = 0; w < W; ++w) {
      const size_t row = size_t(fu[w]) * R;
      for (int j = tid; j < R; j += nthr) {
        const int v = static_cast<int>(nbr[row + j]);
        const bool valid = v < n;
        const unsigned key = valid ? static_cast<unsigned>(v) : 0u;
        bool seen;
        if (exact) {
          seen = test_bit(vis, key);
        } else {
          unsigned h1, h2;
          bloom_hashes(key, ubits, h1, h2);
          seen = test_bit(vis, h1) && test_bit(vis, h2);
        }
        cid[w * R + j] = v;
        cfr[w * R + j] = (valid && !seen) ? 1 : 0;
      }
      __syncthreads();
      for (int j = tid; j < R; j += nthr) {
        if (!cfr[w * R + j]) continue;
        const unsigned key = static_cast<unsigned>(cid[w * R + j]);
        if (exact) {
          set_bit(vis, key);
        } else {
          unsigned h1, h2;
          bloom_hashes(key, ubits, h1, h2);
          set_bit(vis, h1);
          set_bit(vis, h2);
        }
      }
      __syncthreads();
    }

    // ---- distances: one warp per fresh candidate --------------------------
    for (int c = warp; c < WR; c += nwarps) {
      if (!cfr[c]) {
        if (lane == 0) cd[c] = INFINITY;
        continue;
      }
      const float* vrow_c = vec + size_t(cid[c]) * dp;
      float vn = 0.f, dot = 0.f;
      for (int k = lane; k < dp; k += 32) {
        const float x = vrow_c[k];
        vn = __fadd_rn(vn, __fmul_rn(x, x));
        dot = __fadd_rn(dot, __fmul_rn(x, qs[k]));
      }
      vn = warp_sum(vn);
      dot = warp_sum(dot);
      if (lane == 0) cd[c] = fmaxf(__fsub_rn(__fadd_rn(qn, vn), 2.f * dot), 0.f);
    }
    __syncthreads();

    // ---- stable merge of the sorted beam with the fresh candidates --------
    for (int i = tid; i < ef; i += nthr) {
      const float key = d_c[i];
      int pos = i;
      for (int k = 0; k < WR; ++k) pos += (cfr[k] && cd[k] < key);
      if (pos < ef) {
        id_n[pos] = id_c[i];
        d_n[pos] = key;
        ck_n[pos] = ck_c[i];
      }
    }
    for (int j = tid; j < WR; j += nthr) {
      if (!cfr[j]) continue;
      const float key = cd[j];
      int lo = 0, hi = ef;  // #{beam entries with d <= key}
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (d_c[mid] <= key) lo = mid + 1; else hi = mid;
      }
      int pos = lo;
      for (int k = 0; k < WR; ++k)
        pos += (cfr[k] && (cd[k] < key || (cd[k] == key && k < j)));
      if (pos < ef) {
        id_n[pos] = cid[j];
        d_n[pos] = key;
        ck_n[pos] = 0;
      }
    }
    if (tid == 0) {
      int nf = 0;
      for (int k = 0; k < WR; ++k) nf += cfr[k];
      c_dist += nf;
      c_hops += 1;
      c_exp += found;
    }
    __syncthreads();
    int* ti = id_c; id_c = id_n; id_n = ti;
    float* td = d_c; d_c = d_n; d_n = td;
    int* tc = ck_c; ck_c = ck_n; ck_n = tc;
  }

  // ---- write back --------------------------------------------------------
  for (int i = tid; i < ef; i += nthr) {
    const size_t g = size_t(b) * ef + i;
    bid_out[g] = id_c[i];
    bd_out[g] = d_c[i];
    bck_out[g] = ck_c[i] ? 1 : 0;
  }
  unsigned char* orow = vis_out + size_t(b) * vbits;
  for (int w = warp; w < nwords; w += nwarps) {
    const int bit = w * 32 + lane;
    if (bit < vbits) orow[bit] = (vis[w] >> lane) & 1u;
  }
  if (fresh_out != nullptr)
    for (int j = tid; j < WR; j += nthr) fresh_out[size_t(b) * WR + j] = cfr[j] ? 1 : 0;
  if (cnt_out != nullptr && tid == 0) {
    cnt_out[size_t(b) * 3 + 0] = c_dist;
    cnt_out[size_t(b) * 3 + 1] = c_hops;
    cnt_out[size_t(b) * 3 + 2] = c_exp;
  }
}

template <typename IdT>
int launch(const void* q, const void* nbr, const void* vec, const void* bid_in,
           const void* bd_in, const void* bck_in, const void* vis_in,
           void* bid_out, void* bd_out, void* bck_out, void* vis_out,
           void* fresh_out, void* cnt_out, int B, int dp, int n, int R, int ef,
           int W, int vbits, int exact, int rounds, cudaStream_t stream) {
  const Layout L = make_layout(dp, ef, W, R, vbits);
  if (L.total > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  if (L.total > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(pilot_traversal_kernel<IdT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L.total));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  pilot_traversal_kernel<IdT><<<B, kThreads, L.total, stream>>>(
      static_cast<const float*>(q), static_cast<const IdT*>(nbr),
      static_cast<const float*>(vec), static_cast<const int*>(bid_in),
      static_cast<const float*>(bd_in), static_cast<const unsigned char*>(bck_in),
      static_cast<const unsigned char*>(vis_in), static_cast<int*>(bid_out),
      static_cast<float*>(bd_out), static_cast<unsigned char*>(bck_out),
      static_cast<unsigned char*>(vis_out), static_cast<unsigned char*>(fresh_out),
      static_cast<int*>(cnt_out), dp, n, R, ef, W, vbits, exact, rounds, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

size_t pilot_traversal_smem_bytes(int dp, int ef, int W, int R, int vbits) {
  return make_layout(dp, ef, W, R, vbits).total;
}

// The most shared memory a launch may ask for; pilot_traversal refuses more.
size_t pilot_traversal_smem_limit() { return kSmemLimit; }

// One launch: `rounds` W-wide expansion rounds per query (1 for the per-hop
// kernel), each block stopping early once its beam has no unchecked entry.
// fresh_out (B, W·R) and cnt_out (B, 3) = (n_dist, n_hops, n_exp) deltas are
// written when not null.  Returns cudaGetLastError() after the launch.
int pilot_traversal(const void* q, const void* nbr, int id_bytes,
                    const void* vec, const void* bid_in, const void* bd_in,
                    const void* bck_in, const void* vis_in, void* bid_out,
                    void* bd_out, void* bck_out, void* vis_out,
                    void* fresh_out, void* cnt_out, int B, int dp, int n,
                    int R, int ef, int W, int vbits, int exact, int rounds,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (id_bytes == 2)
    return launch<int16_t>(q, nbr, vec, bid_in, bd_in, bck_in, vis_in, bid_out,
                           bd_out, bck_out, vis_out, fresh_out, cnt_out, B, dp,
                           n, R, ef, W, vbits, exact, rounds, s);
  if (id_bytes == 4)
    return launch<int32_t>(q, nbr, vec, bid_in, bd_in, bck_in, vis_in, bid_out,
                           bd_out, bck_out, vis_out, fresh_out, cnt_out, B, dp,
                           n, R, ef, W, vbits, exact, rounds, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

// Stage-① pilot traversal for Hopper (sm_90a): one W-wide expansion round
// (fused_traversal_hop) or the whole search to convergence
// (fused_pilot_search), over a vector table in any of the pilot encodings
// (core/quant.py): fp32, bf16, int8 (x scale), int4 (two nibble planes x
// scale) or pq codes (per-query lookup table).
//
// Replaces the Pallas kernels _hop_kernel and _persistent_kernel of
// src/repro/kernels/traversal_kernel.py (pallas_call at :486 and :565), which
// share _round_body (:120-224); here both share the round body below.
//
// Layout: one thread block per query.  The beam (ids, distances, checked
// flags; double-buffered), the query row, the scale row (int8, int4), the
// lookup table (pq), the visited filter packed into 32-bit words and the
// W·R candidate buffer live in shared memory for the
// whole launch; the public (B, bits) bool filter is packed on entry and
// unpacked on exit.  Neighbour rows and vector rows are read straight from
// device memory (no one-hot gathers: those were a TPU workaround).
//
// Bound: bytes.  Per round a query reads W neighbour-id rows (R ids each) and
// one encoded vector row per fresh candidate (dp·4, dp·2, dp, ceil(dp/2) or
// m bytes); the arithmetic is 2·dp multiply-adds (m lookups for pq) per
// candidate.  The least time is Σ(n_dist·row_bytes + n_exp·R·id_bytes) plus
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
//  * distance, dense and int4: each row element decodes to fp32 (bf16 and
//    int8 widen exactly; int4 dim k < hp is the low nibble of byte k, dim
//    k >= hp the high nibble of byte k - hp, sign-extended from 4 bits) and,
//    where there is a scale, is multiplied by scale[k] once; then
//    max(qn + vn - 2·dot, 0) in fp32, each sum taken in a fixed order that
//    plain PyTorch can repeat (kernels/ref.lane_dot): lane l of the warp
//    sums k = l, l+32, ... with separately rounded multiplies and adds (no
//    FMA contraction), then the warp's xor-butterfly tree.  So the kernel
//    and its plain version (kernels/ref.pilot_dist_fn) agree bit for bit,
//    and near-tied distances cannot order differently between them;
//  * distance, pq: the block builds the query's m·ksub lookup table once
//    per launch (before the round loop, as the TPU kernel hoists it),
//    column j = lane_dot(cb_j, cb_j) - 2·lane_dot(q, cb_j), and scores a
//    candidate as max(qn + Σ_s lut[s·ksub + code_s], 0), s ascending,
//    one thread per candidate (kernels/ref.lane_pq_lut);
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

// Vector-table encodings (the wrapper's ENCODINGS, kernels/traversal_kernel.py)
enum Enc : int { kF32 = 0, kBF16 = 1, kI8 = 2, kI4 = 3, kPQ = 4 };

struct Layout {
  size_t q, scl, lut, id0, id1, d0, d1, ck0, ck1, vis, cid, cd, cfr, fu, scal, total;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// dq: width of the decoded rows and of the query (2·hp for int4, dp else);
// lut_width: m·ksub for pq, else 0.
inline Layout make_layout(int dq, int ef, int W, int R, int vbits,
                          int has_scale, int lut_width) {
  Layout L;
  const size_t WR = size_t(W) * R;
  size_t o = 0;
  auto take = [&o](size_t bytes) { size_t at = o; o = align16(o + bytes); return at; };
  L.q = take(sizeof(float) * dq);
  L.scl = take(has_scale ? sizeof(float) * dq : 0);
  L.lut = take(sizeof(float) * lut_width);
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

// Element k of stored row `row` (vw stored values per row), widened to fp32
// before any scale.  bf16 widens by its bits (exact); int4 reads the low
// nibble of byte k for k < vw and the high nibble of byte k - vw otherwise,
// sign-extended from 4 bits without shifting a negative value.
template <int ENC>
__device__ __forceinline__ float load_elem(const void* vec, size_t row, int vw, int k) {
  if (ENC == kF32) return static_cast<const float*>(vec)[row * vw + k];
  if (ENC == kBF16) {
    const unsigned bits = static_cast<const uint16_t*>(vec)[row * vw + k];
    return __uint_as_float(bits << 16);
  }
  if (ENC == kI8) return static_cast<float>(static_cast<const int8_t*>(vec)[row * vw + k]);
  // kI4
  const bool high = k >= vw;
  const unsigned byte = static_cast<const uint8_t*>(vec)[row * vw + (high ? k - vw : k)];
  const int nib = static_cast<int>(high ? (byte >> 4) : (byte & 0xFu));
  return static_cast<float>(nib >= 8 ? nib - 16 : nib);
}

template <typename IdT, int ENC>
__global__ void __launch_bounds__(kThreads)
pilot_traversal_kernel(const float* __restrict__ q, const IdT* __restrict__ nbr,
                       const void* __restrict__ vec,
                       const float* __restrict__ scale,
                       const float* __restrict__ codebook,
                       const int* __restrict__ bid_in,
                       const float* __restrict__ bd_in,
                       const unsigned char* __restrict__ bck_in,
                       const unsigned char* __restrict__ vis_in,
                       int* __restrict__ bid_out, float* __restrict__ bd_out,
                       unsigned char* __restrict__ bck_out,
                       unsigned char* __restrict__ vis_out,
                       unsigned char* __restrict__ fresh_out,
                       int* __restrict__ cnt_out, int dq, int vw, int ksub,
                       int n, int R, int ef, int W, int vbits, int exact,
                       int rounds, Layout L) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + L.q);
  float* scl = reinterpret_cast<float*>(smem + L.scl);
  float* lut = reinterpret_cast<float*>(smem + L.lut);
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
  const bool scaled = scale != nullptr;

  // ---- load the query, the scale, the beam and the packed filter --------
  for (int k = tid; k < dq; k += nthr) qs[k] = q[size_t(b) * dq + k];
  if (scaled)
    for (int k = tid; k < dq; k += nthr) scl[k] = scale[k];
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
    for (int k = lane; k < dq; k += 32) s = __fadd_rn(s, __fmul_rn(qs[k], qs[k]));
    s = warp_sum(s);
    if (lane == 0) *qn_s = s;
  }
  if (ENC == kPQ) {  // the query's lookup table, once per launch
    const int mk = vw * ksub;
    for (int j = warp; j < mk; j += nwarps) {
      float cn = 0.f, dot = 0.f;
      for (int k = lane; k < dq; k += 32) {
        const float c = codebook[size_t(k) * mk + j];
        cn = __fadd_rn(cn, __fmul_rn(c, c));
        dot = __fadd_rn(dot, __fmul_rn(qs[k], c));
      }
      cn = warp_sum(cn);
      dot = warp_sum(dot);
      if (lane == 0) lut[j] = __fsub_rn(cn, 2.f * dot);
    }
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

    // ---- distances ---------------------------------------------------------
    if (ENC == kPQ) {  // one thread per candidate: m lookups, s ascending
      for (int c = tid; c < WR; c += nthr) {
        if (!cfr[c]) {
          cd[c] = INFINITY;
          continue;
        }
        const uint8_t* code = static_cast<const uint8_t*>(vec) + size_t(cid[c]) * vw;
        float acc = qn;
        for (int s = 0; s < vw; ++s) acc = __fadd_rn(acc, lut[s * ksub + code[s]]);
        cd[c] = fmaxf(acc, 0.f);
      }
    } else {  // one warp per candidate
      for (int c = warp; c < WR; c += nwarps) {
        if (!cfr[c]) {
          if (lane == 0) cd[c] = INFINITY;
          continue;
        }
        const size_t row = size_t(cid[c]);
        float vn = 0.f, dot = 0.f;
        for (int k = lane; k < dq; k += 32) {
          float x = load_elem<ENC>(vec, row, vw, k);
          if (scaled) x = __fmul_rn(x, scl[k]);
          vn = __fadd_rn(vn, __fmul_rn(x, x));
          dot = __fadd_rn(dot, __fmul_rn(x, qs[k]));
        }
        vn = warp_sum(vn);
        dot = warp_sum(dot);
        if (lane == 0) cd[c] = fmaxf(__fsub_rn(__fadd_rn(qn, vn), 2.f * dot), 0.f);
      }
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

struct Args {
  const void *q, *nbr, *vec, *scale, *codebook, *bid_in, *bd_in, *bck_in, *vis_in;
  void *bid_out, *bd_out, *bck_out, *vis_out, *fresh_out, *cnt_out;
  int B, dq, vw, ksub, n, R, ef, W, vbits, exact, rounds;
};

template <typename IdT, int ENC>
int launch(const Args& a, cudaStream_t stream) {
  const int lut_width = ENC == kPQ ? a.vw * a.ksub : 0;
  const Layout L = make_layout(a.dq, a.ef, a.W, a.R, a.vbits, a.scale != nullptr,
                               lut_width);
  if (L.total > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  if (L.total > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(pilot_traversal_kernel<IdT, ENC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L.total));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  pilot_traversal_kernel<IdT, ENC><<<a.B, kThreads, L.total, stream>>>(
      static_cast<const float*>(a.q), static_cast<const IdT*>(a.nbr), a.vec,
      static_cast<const float*>(a.scale), static_cast<const float*>(a.codebook),
      static_cast<const int*>(a.bid_in), static_cast<const float*>(a.bd_in),
      static_cast<const unsigned char*>(a.bck_in),
      static_cast<const unsigned char*>(a.vis_in), static_cast<int*>(a.bid_out),
      static_cast<float*>(a.bd_out), static_cast<unsigned char*>(a.bck_out),
      static_cast<unsigned char*>(a.vis_out), static_cast<unsigned char*>(a.fresh_out),
      static_cast<int*>(a.cnt_out), a.dq, a.vw, a.ksub, a.n, a.R, a.ef, a.W,
      a.vbits, a.exact, a.rounds, L);
  return static_cast<int>(cudaGetLastError());
}

template <typename IdT>
int launch_enc(int enc, const Args& a, cudaStream_t stream) {
  switch (enc) {
    case kF32: return launch<IdT, kF32>(a, stream);
    case kBF16: return launch<IdT, kBF16>(a, stream);
    case kI8: return launch<IdT, kI8>(a, stream);
    case kI4: return launch<IdT, kI4>(a, stream);
    case kPQ: return launch<IdT, kPQ>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

size_t pilot_traversal_smem_bytes(int dq, int ef, int W, int R, int vbits,
                                  int has_scale, int lut_width) {
  return make_layout(dq, ef, W, R, vbits, has_scale, lut_width).total;
}

// The most shared memory a launch may ask for; pilot_traversal refuses more.
size_t pilot_traversal_smem_limit() { return kSmemLimit; }

// One launch: `rounds` W-wide expansion rounds per query (1 for the per-hop
// kernel), each block stopping early once its beam has no unchecked entry.
// vec: (n+1, vw) table in encoding `enc` (Enc above); scale: (dq,) fp32 or
// null (dense without scale); codebook: (dq, vw·ksub) fp32 for pq, else
// null.  q is (B, dq).  fresh_out (B, W·R) and cnt_out (B, 3) = (n_dist,
// n_hops, n_exp) deltas are written when not null.  Returns
// cudaGetLastError() after the launch.
int pilot_traversal(const void* q, const void* nbr, int id_bytes,
                    const void* vec, int enc, int vw, const void* scale,
                    const void* codebook, int ksub, const void* bid_in,
                    const void* bd_in, const void* bck_in, const void* vis_in,
                    void* bid_out, void* bd_out, void* bck_out, void* vis_out,
                    void* fresh_out, void* cnt_out, int B, int dq, int n,
                    int R, int ef, int W, int vbits, int exact, int rounds,
                    void* stream) {
  const Args a{q, nbr, vec, scale, codebook, bid_in, bd_in, bck_in, vis_in,
               bid_out, bd_out, bck_out, vis_out, fresh_out, cnt_out,
               B, dq, vw, ksub, n, R, ef, W, vbits, exact, rounds};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (id_bytes == 2) return launch_enc<int16_t>(enc, a, s);
  if (id_bytes == 4) return launch_enc<int32_t>(enc, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

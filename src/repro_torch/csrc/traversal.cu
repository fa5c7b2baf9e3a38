// Greedy graph traversal for Hopper (sm_90a): one W-wide expansion round
// (fused_traversal_hop) or the whole search to convergence, as stage ①'s
// pilot search (fused_pilot_search) or stage ③'s final search over the full
// graph and vectors (fused_final_search), over a vector table in any of the
// pilot encodings (core/quant.py): fp32, bf16, int8 (x scale), int4 (two
// nibble planes x scale) or pq codes (per-query lookup table).
//
// Replaces the Pallas kernels _hop_kernel and _persistent_kernel of
// src/repro/kernels/traversal_kernel.py (pallas_call at :486 and :565), which
// share _round_body (:120-224); here every entry shares the body below
// (traversal, its round loop included).  Stage ③ has an entry of its own,
// final_traversal_kernel, so that a trace and the launch counters tell its
// launches from stage ①'s (pilot_traversal_kernel); the reference runs
// stage ③ as a jitted loop of its round of array ops.
//
// Layout: one thread block per query.  The beam (ids, distances, checked
// flags; double-buffered), the query row, the scale row (int8, int4), the
// lookup table (pq), the visited filter packed into 32-bit words, the
// round's W·R candidate ids, the compacted fresh candidates and (where it
// fits) a tile of the round's encoded rows live in shared memory for the
// whole launch.  Neighbour rows and vector rows are read straight from
// device memory (no one-hot gathers: those were a TPU workaround).
//
// Bound: bytes.  Per round a query reads W neighbour-id rows (R ids each) and
// one encoded vector row per fresh candidate (dp·4, dp·2, dp, ceil(dp/2) or
// m bytes); the arithmetic is 2·dp multiply-adds (m lookups for pq) per
// candidate.  The least time is Σ(n_dist·row_bytes + n_exp·R·id_bytes) plus
// the beam and filter in and out, over 3.35 TB/s.  Every other byte stays on
// chip, so what a round costs is latency: one block per query runs its
// rounds one after another, and K1 takes the slowest query's rounds times
// the round's latency.  The round body keeps two dependent device-memory
// waits, and overlaps the second with the visited test:
//  1. every warp takes the frontier from the same beam (ballots over the
//     checked flags; no barrier);
//  2. warp 0 loads the W·R neighbour ids (all in flight at once), then per
//     frontier tests every id and inserts the fresh ones with __syncwarp
//     only, compacting them by ballot in candidate order; meanwhile the
//     other warps load the same ids and copy the encoded row of every
//     valid candidate into a shared-memory tile with cp.async (every copy
//     issued before the wait), fresh or not, since the test is not known
//     yet: more bytes, one latency fewer;
//  3. barrier; each warp scores its share of the fresh candidates from the
//     tile, the butterflies of four candidates interleaved;
//  4. barrier; the merge by rank over the compacted candidates; barrier.
// The tile holds W·R rows, so it grows with W·R·row_bytes (fp32 at dp 384,
// W 4, R 32: 192 KB).  Where the layout with the tile would pass the 227 KB
// limit, the launch takes the layout without it: step 2 is warp 0's alone
// and step 3 reads the fresh rows straight from device memory (one more
// dependent wait a round), so every shape whose state fits without the tile
// still runs.
// Bloom hashes reduce modulo a power-of-two size with a mask.
// The public (B, bits) bool filter is packed on entry and unpacked on exit
// with 16-byte accesses, a scalar head and tail around them where a row
// does not start on a 16-byte boundary (exact mode: bits = n + 1).
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
//    a beam entry lands at i + #{fresh with d < its d}, and the k-th fresh
//    entry (in candidate order) at #{beam with d <= its d} + #{fresh k'
//    with d' < d, or d' == d and k' < k}; non-fresh candidates (+inf) can
//    never reach the first ef.
//  * a round without work is a fixed point, so each block exits on its own;
//  * tombstone (optional (n+1,) bool deletion bitmap, the reference's
//    tombstone= operand, _apply_tombstone at traversal_kernel.py:373): a
//    neighbour id whose byte is set reads as the sentinel n where warp 0
//    takes the round's ids (never fresh, never scored), and a beam entry
//    whose byte is set is loaded as (n, +inf), after which warp 0 moves the
//    finite entries to the front in their order (the stable sort by
//    distance, so the merge's sorted-beam precondition holds again).  The
//    table itself is never copied: the bitmap (n+1 bytes, 0.25 MB at nk
//    250,000) stays in L2.  The other warps' tile copies skip no dead
//    candidate (a dead row is copied and never read, like a visited one),
//    so the only added wait is the bitmap's bytes behind the ids in warp 0.
//    A null bitmap is the operand-free kernel, and an all-false one gives
//    the same result bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 4;  // candidates whose warp sums interleave
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kSmemLimit = 232448;  // 227 KB per block on sm_90
constexpr int kMaxDevices = 64;

// Vector-table encodings (the wrapper's ENCODINGS, kernels/traversal_kernel.py)
enum Enc : int { kF32 = 0, kBF16 = 1, kI8 = 2, kI4 = 3, kPQ = 4 };

struct Layout {
  size_t q, scl, lut, id0, id1, d0, d1, ck0, ck1, vis, fu, cid, cfr, fid,
      fpos, fd, tile, scal, total;
  int stride;  // bytes between two rows of the tile; 0: no tile
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// dq: width of the decoded rows and of the query (2·hp for int4, dp else);
// row_bytes: bytes of one stored row; lut_width: m·ksub for pq, else 0;
// tiled: room for the round's W·R encoded rows.
inline Layout make_layout(int dq, int ef, int W, int R, int vbits,
                          int has_scale, int lut_width, int row_bytes, bool tiled) {
  Layout L;
  const size_t WR = size_t(W) * R;
  size_t o = 0;
  auto take = [&o](size_t bytes) { size_t at = o; o = align16(o + bytes); return at; };
  L.stride = tiled ? static_cast<int>(align16(row_bytes)) : 0;
  L.q = take(sizeof(float) * dq);
  L.scl = take(has_scale ? sizeof(float) * dq : 0);
  L.lut = take(sizeof(float) * lut_width);
  L.id0 = take(sizeof(int) * ef);
  L.id1 = take(sizeof(int) * ef);
  L.d0 = take(sizeof(float) * ef);
  L.d1 = take(sizeof(float) * ef);
  L.ck0 = take(sizeof(int) * ef);
  L.ck1 = take(sizeof(int) * ef);
  // one word past the filter: the unpack reads bits across a word boundary
  L.vis = take(sizeof(unsigned) * ((size_t(vbits) + 31) / 32 + 1));
  L.fu = take(sizeof(int) * W * (kThreads / 32));  // one frontier per warp
  L.cid = take(sizeof(int) * WR);
  L.cfr = take(sizeof(int) * WR);
  L.fid = take(sizeof(int) * WR);
  L.fpos = take(sizeof(int) * WR);
  L.fd = take(sizeof(float) * WR);
  L.tile = take(WR * L.stride);
  L.scal = take(16);
  L.total = o;
  return L;
}

// The layout with the tile where it fits the limit, else the one without.
inline Layout choose_layout(int dq, int ef, int W, int R, int vbits,
                            int has_scale, int lut_width, int row_bytes) {
  const Layout L = make_layout(dq, ef, W, R, vbits, has_scale, lut_width, row_bytes, true);
  if (L.total <= kSmemLimit) return L;
  return make_layout(dq, ef, W, R, vbits, has_scale, lut_width, row_bytes, false);
}

// mask: bits - 1 when bits is a power of two (the modulo is then a mask,
// the same value), else 0.
__device__ __forceinline__ void bloom_hashes(unsigned x, unsigned bits,
                                             unsigned mask, unsigned& h1,
                                             unsigned& h2) {
  const unsigned a = (x * 0x9E3779B1u) ^ ((x * 0x85EBCA77u) >> 15);
  const unsigned b = (x * 0xC2B2AE3Du) ^ (x >> 13) ^ (x * 0x27D4EB2Fu);
  h1 = mask ? a & mask : a % bits;
  h2 = mask ? b & mask : b % bits;
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

// Bit i set for each non-zero byte i of x (4 bytes -> 4 bits): the high bit
// of each byte is set iff the byte is non-zero, then the four high bits are
// gathered into bits 21..24 by one multiply (no two partial products meet).
__device__ __forceinline__ unsigned nonzero_bits4(unsigned x) {
  const unsigned m = (((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & 0x80808080u;
  return (((m >> 7) * 0x00204081u) >> 21) & 0xfu;
}

__device__ __forceinline__ unsigned nonzero_bits16(uint4 x) {
  return nonzero_bits4(x.x) | (nonzero_bits4(x.y) << 4) |
         (nonzero_bits4(x.z) << 8) | (nonzero_bits4(x.w) << 12);
}

// Four bits -> four bytes of 0 or 1 (the inverse spread).
__device__ __forceinline__ unsigned bytes_of_bits4(unsigned nib) {
  return (nib * 0x00204081u) & 0x01010101u;
}

// OR up to 16 bits into the packed filter at bit offset o.
__device__ __forceinline__ void or_bits(unsigned* vis, int o, unsigned bits) {
  if (bits == 0) return;
  const int w = o >> 5, s = o & 31;
  atomicOr(&vis[w], bits << s);
  if (s > 16) atomicOr(&vis[w + 1], bits >> (32 - s));
}

// 16 bits of the packed filter from bit offset o.
__device__ __forceinline__ unsigned get_bits16(const unsigned* vis, int o) {
  const int w = o >> 5, s = o & 31;
  const unsigned long long two =
      (static_cast<unsigned long long>(vis[w + 1]) << 32) | vis[w];
  return static_cast<unsigned>(two >> s) & 0xffffu;
}

// The bytes of row [p, p + len) that lie before its first 16-byte boundary
// (head) and the number of whole 16-byte chunks after them.
__device__ __forceinline__ void split_row(const void* p, int len, int& head,
                                          int& chunks) {
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
  head = min(len, (16 - mis) & 15);
  chunks = (len - head) >> 4;
}

// The (bits,) bool row at `row` packed into vis (zeroed): any non-zero byte
// is a set bit.  Whole chunks are read with 16-byte loads, four per thread
// in flight; the head and tail bytes one by one.
__device__ __forceinline__ void pack_filter(const unsigned char* __restrict__ row,
                                            int bits, unsigned* vis) {
  int head, chunks;
  split_row(row, bits, head, chunks);
  const int tail = head + 16 * chunks;
  const uint4* body = reinterpret_cast<const uint4*>(row + head);
  constexpr int U = 4;
  for (int c0 = threadIdx.x; c0 < chunks; c0 += U * blockDim.x) {
    uint4 x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u * blockDim.x;
      if (c < chunks) x[u] = body[c];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u * blockDim.x;
      if (c < chunks) or_bits(vis, head + 16 * c, nonzero_bits16(x[u]));
    }
  }
  for (int i = threadIdx.x; i < head + (bits - tail); i += blockDim.x) {
    const int at = i < head ? i : tail + (i - head);
    if (row[at]) or_bits(vis, at, 1u);
  }
}

// The packed filter written back as a (bits,) bool row of 0/1 bytes.
__device__ __forceinline__ void unpack_filter(const unsigned* vis, int bits,
                                              unsigned char* __restrict__ row) {
  int head, chunks;
  split_row(row, bits, head, chunks);
  const int tail = head + 16 * chunks;
  uint4* body = reinterpret_cast<uint4*>(row + head);
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    const unsigned b16 = get_bits16(vis, head + 16 * c);
    body[c] = make_uint4(bytes_of_bits4(b16 & 0xf), bytes_of_bits4((b16 >> 4) & 0xf),
                         bytes_of_bits4((b16 >> 8) & 0xf), bytes_of_bits4(b16 >> 12));
  }
  for (int i = threadIdx.x; i < head + (bits - tail); i += blockDim.x) {
    const int at = i < head ? i : tail + (i - head);
    row[at] = (vis[at >> 5] >> (at & 31)) & 1u;
  }
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Element k of a stored row (vw stored values per row), widened to fp32
// before any scale.  bf16 widens by its bits (exact); int4 reads the low
// nibble of byte k for k < vw and the high nibble of byte k - vw otherwise,
// sign-extended from 4 bits without shifting a negative value.
template <int ENC>
__device__ __forceinline__ float load_elem(const unsigned char* row, int vw, int k) {
  if (ENC == kF32) return reinterpret_cast<const float*>(row)[k];
  if (ENC == kBF16) {
    const unsigned bits = reinterpret_cast<const uint16_t*>(row)[k];
    return __uint_as_float(bits << 16);
  }
  if (ENC == kI8) return static_cast<float>(reinterpret_cast<const int8_t*>(row)[k]);
  // kI4
  const bool high = k >= vw;
  const unsigned byte = row[high ? k - vw : k];
  const int nib = static_cast<int>(high ? (byte >> 4) : (byte & 0xFu));
  return static_cast<float>(nib >= 8 ? nib - 16 : nib);
}

// The operands of every entry, and the same names passed on.
#define TRAVERSAL_PARAMS                                                      \
  const float* __restrict__ q, const IdT* __restrict__ nbr,                  \
      const unsigned char* __restrict__ vec, const float* __restrict__ scale, \
      const float* __restrict__ codebook,                                     \
      const unsigned char* __restrict__ tomb, const int* __restrict__ bid_in, \
      const float* __restrict__ bd_in,                                        \
      const unsigned char* __restrict__ bck_in,                               \
      const unsigned char* __restrict__ vis_in, int* __restrict__ bid_out,    \
      float* __restrict__ bd_out, unsigned char* __restrict__ bck_out,        \
      unsigned char* __restrict__ vis_out,                                    \
      unsigned char* __restrict__ fresh_out, int* __restrict__ cnt_out,       \
      int dq, int vw, int ksub, int row_bytes, int chunk, int n, int R,       \
      int ef, int W, int vbits, int exact, int rounds, Layout L
#define TRAVERSAL_ARGS                                                        \
  q, nbr, vec, scale, codebook, tomb, bid_in, bd_in, bck_in, vis_in, bid_out, \
      bd_out, bck_out, vis_out, fresh_out, cnt_out, dq, vw, ksub, row_bytes,  \
      chunk, n, R, ef, W, vbits, exact, rounds, L

// One block's query: load, up to `rounds` rounds, write back.
template <typename IdT, int ENC>
__device__ __forceinline__ void traversal(TRAVERSAL_PARAMS) {
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
  int* fu = reinterpret_cast<int*>(smem + L.fu);
  int* cid = reinterpret_cast<int*>(smem + L.cid);
  int* cfr = reinterpret_cast<int*>(smem + L.cfr);
  int* fid = reinterpret_cast<int*>(smem + L.fid);
  int* fpos = reinterpret_cast<int*>(smem + L.fpos);
  float* fd = reinterpret_cast<float*>(smem + L.fd);
  unsigned char* tile = smem + L.tile;
  int* nf_s = reinterpret_cast<int*>(smem + L.scal);
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
  const unsigned bmask = (ubits & (ubits - 1)) == 0 ? ubits - 1 : 0u;
  const bool scaled = scale != nullptr;
  const int cpr = row_bytes / chunk;  // copies per row (chunk 1: bytes)

  // ---- load the query, the scale, the beam; pack the filter --------------
  for (int w = tid; w <= nwords; w += nthr) vis[w] = 0u;
  for (int k = tid; k < dq; k += nthr) qs[k] = q[size_t(b) * dq + k];
  if (scaled)
    for (int k = tid; k < dq; k += nthr) scl[k] = scale[k];
  for (int i = tid; i < ef; i += nthr) {
    const size_t g = size_t(b) * ef + i;
    int id = bid_in[g];
    float d = bd_in[g];
    if (tomb != nullptr && id < n && tomb[id]) {  // a deleted beam entry
      id = n;
      d = INFINITY;
    }
    id_c[i] = id;
    d_c[i] = d;
    ck_c[i] = bck_in[g] ? 1 : 0;
  }
  for (int j = tid; j < WR; j += nthr) cfr[j] = 0;
  __syncthreads();
  pack_filter(vis_in + size_t(b) * vbits, vbits, vis);
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
  if (tomb != nullptr) {
    // the masked beam sorted again: finite entries first, then the +inf
    // ones, each group in beam order (= the stable sort by distance of a
    // beam whose finite entries were sorted)
    if (warp == 0) {
      int nfin = 0;
      for (int base = 0; base < ef; base += 32) {
        const int i = base + lane;
        nfin += __popc(__ballot_sync(kFull, i < ef && d_c[i] < INFINITY));
      }
      const unsigned lt = (1u << lane) - 1u;
      int kf = 0, ki = nfin;
      for (int base = 0; base < ef; base += 32) {
        const int i = base + lane;
        const bool in = i < ef;
        const bool f = in && d_c[i] < INFINITY;
        const unsigned mf = __ballot_sync(kFull, f);
        const unsigned mi = __ballot_sync(kFull, in && !f);
        if (in) {
          const int pos = f ? kf + __popc(mf & lt) : ki + __popc(mi & lt);
          id_n[pos] = id_c[i];
          d_n[pos] = d_c[i];
          ck_n[pos] = ck_c[i];
        }
        kf += __popc(mf);
        ki += __popc(mi);
      }
    }
    __syncthreads();
    int* ti = id_c; id_c = id_n; id_n = ti;
    float* td = d_c; d_c = d_n; d_n = td;
    int* tc = ck_c; ck_c = ck_n; ck_n = tc;
  }
  const float qn = *qn_s;

  int c_dist = 0, c_hops = 0, c_exp = 0;  // thread 0's counters
  for (int it = 0; it < rounds; ++it) {
    // ---- 1. every warp: the frontier, by ballots over the same beam -------
    int found = 0, s_last = -1;
    int* my_fu = fu + warp * W;
    for (int base = 0; base < ef && found < W; base += 32) {
      const int i = base + lane;
      const bool un = i < ef && !ck_c[i] && id_c[i] < n;
      const unsigned m = __ballot_sync(kFull, un);
      const int rank = found + __popc(m & ((1u << lane) - 1u));
      if (un && rank < W) my_fu[rank] = id_c[i];
      const int took = min(W - found, __popc(m));
      const unsigned last = __ballot_sync(kFull, un && rank == found + took - 1);
      if (took > 0) s_last = base + __ffs(last) - 1;
      found += took;
    }
    if (found == 0) break;  // converged: a round without work is a fixed point
    __syncwarp();

    if (warp == 0) {
      // ---- 2a. warp 0: the W·R ids (sentinel row n past the found
      // frontiers, every load issued before the first is stored; with a
      // bitmap, every id's byte loaded before the first is tested), then
      // per frontier every id tested, the fresh ones inserted and
      // compacted in candidate order
      constexpr int U = 8;
      for (int j0 = 0; j0 < WR; j0 += 32 * U) {
        int v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = j0 + 32 * u + lane;
          const int w = j / R;
          if (j < WR)
            v[u] = static_cast<int>(nbr[size_t(w < found ? my_fu[w] : n) * R + (j - w * R)]);
        }
        if (tomb != nullptr) {
          unsigned char dead[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int j = j0 + 32 * u + lane;
            dead[u] = (j < WR && v[u] < n) ? tomb[v[u]] : 0;
          }
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (dead[u]) v[u] = n;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = j0 + 32 * u + lane;
          if (j < WR) cid[j] = v[u];
        }
      }
      __syncwarp();
      int nf = 0;
      for (int w = 0; w < W; ++w) {
        for (int j0 = 0; j0 < R; j0 += 32) {
          const int j = j0 + lane;
          if (j < R) {
            const int v = cid[w * R + j];
            const bool valid = v < n;
            const unsigned key = valid ? static_cast<unsigned>(v) : 0u;
            bool seen;
            if (exact) {
              seen = test_bit(vis, key);
            } else {
              unsigned h1, h2;
              bloom_hashes(key, ubits, bmask, h1, h2);
              seen = test_bit(vis, h1) && test_bit(vis, h2);
            }
            cfr[w * R + j] = (valid && !seen) ? 1 : 0;
          }
        }
        __syncwarp();
        for (int j0 = 0; j0 < R; j0 += 32) {
          const int j = j0 + lane;
          const bool f = j < R && cfr[w * R + j];
          const unsigned m = __ballot_sync(kFull, f);
          if (f) {
            const unsigned key = static_cast<unsigned>(cid[w * R + j]);
            if (exact) {
              set_bit(vis, key);
            } else {
              unsigned h1, h2;
              bloom_hashes(key, ubits, bmask, h1, h2);
              set_bit(vis, h1);
              set_bit(vis, h2);
            }
            const int k = nf + __popc(m & ((1u << lane) - 1u));
            fid[k] = static_cast<int>(key);
            fpos[k] = w * R + j;
          }
          nf += __popc(m);
        }
        __syncwarp();
      }
      if (lane == 0) *nf_s = nf;
    } else if (L.stride) {
      // ---- 2b. the other warps meanwhile: the encoded rows of every
      // candidate with a valid id into its tile row, fresh or not (the
      // visited test is not known yet), every id and copy issued before
      // the wait
      const int gw = warp - 1, ngw = nwarps - 1;
      const int copies = (WR > gw ? (WR - gw + ngw - 1) / ngw : 0) * cpr;
      constexpr int U = 4;
      for (int e0 = lane; e0 < copies; e0 += 32 * U) {
        int c[U];
        IdT v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e = e0 + 32 * u;
          c[u] = gw + ngw * (e / cpr);
          const int w = c[u] / R;
          if (e < copies)
            v[u] = nbr[size_t(w < found ? my_fu[w] : n) * R + (c[u] - w * R)];
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e = e0 + 32 * u;
          if (e < copies && static_cast<int>(v[u]) < n) {
            const int o = (e - (e / cpr) * cpr) * chunk;
            if (chunk >= 4)
              cp_async(tile + size_t(c[u]) * L.stride + o,
                       vec + size_t(v[u]) * row_bytes + o, chunk);
            else
              tile[size_t(c[u]) * L.stride + o] = vec[size_t(v[u]) * row_bytes + o];
          }
        }
      }
      cp_async_wait_all();
    }
    __syncthreads();
    const int nf = *nf_s;

    // ---- 3. each warp: its share of the fresh candidates scored, from the
    // tile or (without one) from device memory ------------------------------
    const int mine = nf > warp ? (nf - warp + nwarps - 1) / nwarps : 0;
    auto row_of = [&](int k) {
      return L.stride ? tile + size_t(fpos[k]) * L.stride
                      : vec + size_t(fid[k]) * row_bytes;
    };
    if (ENC == kPQ) {  // one lane per candidate: m lookups, s ascending
      for (int i = lane; i < mine; i += 32) {
        const int k = warp + nwarps * i;
        const unsigned char* code = row_of(k);
        float acc = qn;
        for (int s = 0; s < vw; ++s) acc = __fadd_rn(acc, lut[s * ksub + code[s]]);
        fd[k] = fmaxf(acc, 0.f);
      }
    } else {  // the warp per candidate, lane_dot's order; the butterflies
              // of kGroup candidates interleave (each one's sums unchanged)
      for (int i0 = 0; i0 < mine; i0 += kGroup) {
        float vn[kGroup], dot[kGroup];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          vn[g] = 0.f;
          dot[g] = 0.f;
          if (i0 + g < mine) {
            const unsigned char* row = row_of(warp + nwarps * (i0 + g));
            for (int kk = lane; kk < dq; kk += 32) {
              float x = load_elem<ENC>(row, vw, kk);
              if (scaled) x = __fmul_rn(x, scl[kk]);
              vn[g] = __fadd_rn(vn[g], __fmul_rn(x, x));
              dot[g] = __fadd_rn(dot[g], __fmul_rn(x, qs[kk]));
            }
          }
        }
#pragma unroll
        for (int o = 16; o; o >>= 1) {
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            vn[g] += __shfl_xor_sync(kFull, vn[g], o);
            dot[g] += __shfl_xor_sync(kFull, dot[g], o);
          }
        }
        if (lane == 0) {
#pragma unroll
          for (int g = 0; g < kGroup; ++g)
            if (i0 + g < mine)
              fd[warp + nwarps * (i0 + g)] =
                  fmaxf(__fsub_rn(__fadd_rn(qn, vn[g]), 2.f * dot[g]), 0.f);
        }
      }
    }
    __syncthreads();

    // ---- 4. stable merge of the sorted beam with the fresh candidates ----
    // (the frontier's slots, the unchecked live ones up to s_last, leave
    // checked)
    for (int e = tid; e < ef + nf; e += nthr) {
      if (e < ef) {
        const float key = d_c[e];
        int pos = e;
        for (int k = 0; k < nf; ++k) pos += fd[k] < key;
        if (pos < ef) {
          id_n[pos] = id_c[e];
          d_n[pos] = key;
          ck_n[pos] = ck_c[e] || (e <= s_last && id_c[e] < n);
        }
      } else {
        const int j = e - ef;
        const float key = fd[j];
        int lo = 0, hi = ef;  // #{beam entries with d <= key}
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (d_c[mid] <= key) lo = mid + 1; else hi = mid;
        }
        int pos = lo;
        for (int k = 0; k < nf; ++k) pos += fd[k] < key || (fd[k] == key && k < j);
        if (pos < ef) {
          id_n[pos] = fid[j];
          d_n[pos] = key;
          ck_n[pos] = 0;
        }
      }
    }
    if (tid == 0) {
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
  unpack_filter(vis, vbits, vis_out + size_t(b) * vbits);
  if (fresh_out != nullptr)
    for (int j = tid; j < WR; j += nthr) fresh_out[size_t(b) * WR + j] = cfr[j] ? 1 : 0;
  if (cnt_out != nullptr && tid == 0) {
    cnt_out[size_t(b) * 3 + 0] = c_dist;
    cnt_out[size_t(b) * 3 + 1] = c_hops;
    cnt_out[size_t(b) * 3 + 2] = c_exp;
  }
}

// Stage ①'s entry (K1 persistent, K2 per hop).
template <typename IdT, int ENC>
__global__ void __launch_bounds__(kThreads)
pilot_traversal_kernel(TRAVERSAL_PARAMS) {
  traversal<IdT, ENC>(TRAVERSAL_ARGS);
}

// Stage ③'s entry: the same body over the full graph and vectors.
template <typename IdT, int ENC>
__global__ void __launch_bounds__(kThreads)
final_traversal_kernel(TRAVERSAL_PARAMS) {
  traversal<IdT, ENC>(TRAVERSAL_ARGS);
}

// The stages whose entries a launch can take.
enum Entry : int { kPilot = 0, kFinal = 1 };

struct Args {
  const void *q, *nbr, *vec, *scale, *codebook, *tomb, *bid_in, *bd_in, *bck_in,
      *vis_in;
  void *bid_out, *bd_out, *bck_out, *vis_out, *fresh_out, *cnt_out;
  int B, dq, vw, ksub, n, R, ef, W, vbits, exact, rounds, entry;
};

inline int stored_row_bytes(int enc, int vw) {
  return enc == kF32 ? 4 * vw : enc == kBF16 ? 2 * vw : vw;
}

// The widest copy (16, 8 or 4 bytes; 1 = byte by byte) that divides the row
// and the table's base address.
inline int copy_bytes(const void* vec, int row_bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(vec);
  for (int c = 16; c >= 4; c >>= 1)
    if (row_bytes % c == 0 && a % c == 0) return c;
  return 1;
}

template <typename IdT, int ENC>
int launch(const Args& a, cudaStream_t stream) {
  const int lut_width = ENC == kPQ ? a.vw * a.ksub : 0;
  const int row_bytes = stored_row_bytes(ENC, a.vw);
  const Layout L = choose_layout(a.dq, a.ef, a.W, a.R, a.vbits, a.scale != nullptr,
                                 lut_width, row_bytes);
  if (L.total > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = a.entry == kFinal ? final_traversal_kernel<IdT, ENC>
                                   : pilot_traversal_kernel<IdT, ENC>;
  // the opt-in size is raised once per device, instantiation and entry, to
  // the largest size asked for so far
  static size_t opted[2][kMaxDevices];
  if (L.total > 48 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= kMaxDevices || L.total > opted[a.entry][dev]) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(L.total));
      if (e != cudaSuccess) return static_cast<int>(e);
      if (dev < kMaxDevices) opted[a.entry][dev] = L.total;
    }
  }
  kernel<<<a.B, kThreads, L.total, stream>>>(
      static_cast<const float*>(a.q), static_cast<const IdT*>(a.nbr),
      static_cast<const unsigned char*>(a.vec),
      static_cast<const float*>(a.scale), static_cast<const float*>(a.codebook),
      static_cast<const unsigned char*>(a.tomb), static_cast<const int*>(a.bid_in), static_cast<const float*>(a.bd_in),
      static_cast<const unsigned char*>(a.bck_in),
      static_cast<const unsigned char*>(a.vis_in), static_cast<int*>(a.bid_out),
      static_cast<float*>(a.bd_out), static_cast<unsigned char*>(a.bck_out),
      static_cast<unsigned char*>(a.vis_out), static_cast<unsigned char*>(a.fresh_out),
      static_cast<int*>(a.cnt_out), a.dq, a.vw, a.ksub, row_bytes,
      copy_bytes(a.vec, row_bytes), a.n, a.R, a.ef, a.W, a.vbits, a.exact,
      a.rounds, L);
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

// Shared memory of one block for a table of encoding `enc` with vw stored
// values per row (Enc above), in the layout a launch takes.
size_t pilot_traversal_smem_bytes(int dq, int ef, int W, int R, int vbits,
                                  int has_scale, int lut_width, int enc, int vw) {
  return choose_layout(dq, ef, W, R, vbits, has_scale, lut_width,
                       stored_row_bytes(enc, vw)).total;
}

// The most shared memory a launch may ask for; a launch refuses more.
size_t pilot_traversal_smem_limit() { return kSmemLimit; }

#define TRAVERSAL_ENTRY(name, entry)                                          \
  int name(const void* q, const void* nbr, int id_bytes, const void* vec,      \
           int enc, int vw, const void* scale, const void* codebook, int ksub, \
           const void* tomb, const void* bid_in, const void* bd_in,            \
           const void* bck_in, const void* vis_in, void* bid_out,              \
           void* bd_out, void* bck_out, void* vis_out, void* fresh_out,        \
           void* cnt_out, int B, int dq, int n, int R, int ef, int W,          \
           int vbits, int exact, int rounds, void* stream) {                   \
    const Args a{q, nbr, vec, scale, codebook, tomb, bid_in, bd_in, bck_in,     \
                 vis_in, bid_out, bd_out, bck_out, vis_out, fresh_out,         \
                 cnt_out, B, dq, vw, ksub, n, R, ef, W, vbits, exact, rounds,  \
                 entry};                                                       \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                        \
    if (id_bytes == 2) return launch_enc<int16_t>(enc, a, s);                  \
    if (id_bytes == 4) return launch_enc<int32_t>(enc, a, s);                  \
    return static_cast<int>(cudaErrorInvalidValue);                            \
  }

// One launch: `rounds` W-wide expansion rounds per query (1 for the per-hop
// kernel), each block stopping early once its beam has no unchecked entry.
// vec: (n+1, vw) table in encoding `enc` (Enc above); scale: (dq,) fp32 or
// null (dense without scale); codebook: (dq, vw·ksub) fp32 for pq, else
// null; tomb: (n+1,) bool deletion bitmap or null.  q is (B, dq).
// fresh_out (B, W·R) and cnt_out (B, 3) = (n_dist,
// n_hops, n_exp) deltas are written whole when not null.  Returns
// cudaGetLastError() after the launch.  pilot_traversal launches stage ①'s
// entry, final_traversal stage ③'s (the same operands and semantics).
TRAVERSAL_ENTRY(pilot_traversal, kPilot)
TRAVERSAL_ENTRY(final_traversal, kFinal)

}  // extern "C"

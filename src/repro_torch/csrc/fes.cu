// Fast Entry Selection distances for Hopper (sm_90a):
// (r, QC, d) cluster-grouped queries x (r, C, ·) entry buckets
// -> (r, QC, C) squared distances.
//
// Replaces the three Pallas kernels behind fes_distances in
// src/repro/kernels/fes_kernel.py (pallas_call at :157, :137 and :118):
//  * K3 _fes_tile_kernel: entries fp32, bf16 or int8 (x a per-dim scale);
//  * K4 _fes_int4_kernel: entries nibble-packed int4 (x the scale; the
//    queries are read at their own width d, dims >= d count as 0 and the
//    scale beyond d as 1.0, so the wrapper pads nothing);
//  * K5 _fes_pq_kernel: entries pq codes, scored through each query's
//    lookup table built from the codebook (d, m·ksub).
//
// Contract (its summation order fixes every output bit):
//  * K3/K4: qn + en - 2·dot, no clamp.  dot, qn and en are fmaf chains over
//    k ascending from +0.  bf16 widens by its bits; int8 and int4 codes
//    widen and then __fmul_rn by scale[k]; int4 dim k < hp is the low
//    nibble of byte k, dim k >= hp the high nibble of byte k - hp.
//  * K5: qn + Σ_s lut[s·ksub + code_s], __fadd_rn over s ascending from qn,
//    with lut = cn - 2·dot (cn and dot fmaf chains over k ascending).
//  * Plain fp32 FMA, no tensor cores and no TF32 (TF32 keeps about three
//    digits and would break id parity with the reference's top-L).
//
// Bound at the main path's shapes (r 32, QC 128, C 512, d 48): the bytes,
// dominated by the (r, QC, C) fp32 output (8.4 MB, ~2.5 us at 3.35 TB/s),
// which must be written whole.  ops.fes_select gives every cluster QC = B
// slots, so 31 of every 32 slots hold no query: an all-zero row.  For such
// a row qn = +0 and dot = Σ fmaf(0, e_k) in any order, so its outputs are
// the entries' own values, computed once per entry: en - 2·ez with
// ez = Σ_k fmaf(0, e_k) (K3/K4; ez is +0 for finite rows and NaN where the
// products would give NaN), and +0 + Σ_s zl[code_s] with the zero row's
// table zl = cn - 2·Σ_k fmaf(0, cb_kj) (K5).  A row is zero when every one
// of its elements compares equal to 0 (a row of tiny values whose qn
// underflows is not).  Only the occupied slots do products.
//
// fes_tile_kernel (K3/K4): one block of 256 threads per (64 entries,
// cluster), walking the cluster's slots in passes of 128.  The block copies
// the raw bytes of its entry rows and of the pass's slot rows into shared
// memory with 16-byte cp.async (whole aligned 16-byte blocks, each row
// keeping its address mod 16, so any row width and encoding is copied the
// same way); tests the slot rows for zero by their 16-byte pieces; decodes
// the entries to fp32; computes qn of the occupied slots and en, ez of the
// entries (threads 128-191, one entry each); lists the occupied slots by a
// ballot; does the occupied slots' products (a thread per (slot, entry)
// where at most 4 are occupied, else 16 x 16 threads with 4 entries and up
// to 8 slots each); writes every zero slot's row, then the occupied slots'
// rows from a shared-memory tile.  Every row goes out with 16-byte stores
// along C (a scalar tail where C % 4 != 0).  Up to kWholeMax decoded dims
// stage whole; wider rows go through a double-buffered ring of kChunk dims,
// the next chunk's copy in flight while the current one is decoded and
// used, and then every slot does its products (whether a row is zero is
// known only after the last chunk).
//
// fes_pq_kernel (K5): one block per (16 slots, cluster), walking the whole
// of C, so each slot's table is built once per launch.  The codebook and
// the block's slot rows are copied into shared memory once (16-byte
// cp.async) where they fit, else read through the cache; half the threads
// compute cn and zl while the other warps test the slots and compute qn
// (one lane per slot, fmaf over k ascending).  The cluster's codes are
// staged kPqC entries at a time; each entry's zero-slot row is summed once,
// the occupied slots' rows four at a time into a shared tile, and every row
// is written with 16-byte stores along C.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;        // K3/K4: entries per block
constexpr int kSlots = 128;      // K3/K4: slots per pass
constexpr int kWholeMax = 96;    // K3/K4: decoded widths staged whole
constexpr int kChunk = 64;       // K3/K4: dims per ring stage above that
constexpr int kOutPitch = kTile + 16;  // K3/K4: floats per output-tile row
constexpr int kPqQ = 16;         // K5: slots per block (and tables)
constexpr int kPqC = 512;        // K5: entries per staged codes chunk
constexpr size_t kSmemLimit = 232448;     // 227 KB per block on sm_90
constexpr int kMaxDevices = 64;

// Entry encodings (the wrapper's ENCODINGS, kernels/fes_kernel.py)
enum Enc : int { kF32 = 0, kBF16 = 1, kI8 = 2, kI4 = 3 };

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Bytes a row span of `nbytes` takes in shared memory: whole 16-byte blocks
// from the one holding its first byte, at any address mod 16.
__host__ __device__ constexpr int span_pitch(int nbytes) { return 16 * ((30 + nbytes) >> 4); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ int phase(const void* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
}

// Starts the copy of the `nbytes` at src to dst: the 16-byte blocks that
// hold a byte of them, so src's first byte lands at dst + (src & 15).
// Every block read holds a byte of the span, so none crosses a page the
// span does not touch.  `lanes` threads from `first` take part.
__device__ __forceinline__ void copy_span(uint8_t* dst, const uint8_t* src, int nbytes,
                                         int first, int lanes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const int units = (int(a & 15) + nbytes + 15) >> 4;
  const uint8_t* base = reinterpret_cast<const uint8_t*>(a & ~uintptr_t(15));
  for (int u = first; u < units; u += lanes) cp_async16(dst + 16 * u, base + 16 * u);
}

// copy_span for `rows` spans (span i at src + i·stride, to dst + i·pitch),
// every thread taking units of the flat (span, unit) order.
__device__ __forceinline__ void copy_rows(uint8_t* dst, int pitch, const uint8_t* src,
                                          size_t stride, int rows, int nbytes) {
  if (nbytes <= 0) return;
  const int units = (30 + nbytes) >> 4;
  const int di = kThreads / units, du = kThreads - di * units;
  int i = threadIdx.x / units, u = threadIdx.x - i * units;
  for (; i < rows; i += di, u += du) {
    if (u >= units) {
      u -= units;
      ++i;
      if (i >= rows) break;
    }
    const uintptr_t a = reinterpret_cast<uintptr_t>(src + size_t(i) * stride);
    if (16 * u < int(a & 15) + nbytes)
      cp_async16(dst + size_t(i) * pitch + 16 * u,
                 reinterpret_cast<const void*>((a & ~uintptr_t(15)) + 16 * u));
  }
}

// Element k of a staged entry row (its first stored byte at `row`), fp32
// before any scale; vw stored values per row.  int4 sign-extends a nibble
// without shifting a negative value.
template <int ENC>
__device__ __forceinline__ float decode(const uint8_t* row, int k, int vw) {
  if (ENC == kF32) return reinterpret_cast<const float*>(row)[k];
  if (ENC == kBF16) {
    const unsigned bits = reinterpret_cast<const uint16_t*>(row)[k];
    return __uint_as_float(bits << 16);
  }
  if (ENC == kI8) return static_cast<float>(reinterpret_cast<const int8_t*>(row)[k]);
  const bool high = k >= vw;  // kI4
  const unsigned byte = row[high ? k - vw : k];
  const int nib = static_cast<int>(high ? (byte >> 4) : (byte & 0xFu));
  return static_cast<float>(nib >= 8 ? nib - 16 : nib);
}

// Writes output rows of `ne` <= 64 floats (row stride C, from `ob`) with
// 16-byte stores where C % 4 == 0 and the rows are 16-byte aligned, else a
// scalar at a time, a thread per 16-byte group: the slots list[j] (j <
// rows), or with no list the slots i < rows whose flag[i] is 0; slot i's
// values are src + i·pitch (pitch 0: the same row for every slot).
__device__ void store_rows(float* ob, int C, int rows, int ne, const int* flag,
                           const int* list, const float* src, int pitch) {
  const bool vec = (C & 3) == 0 && (reinterpret_cast<uintptr_t>(ob) & 15) == 0;
  const int c = 4 * (threadIdx.x & 15);
  if (c >= ne) return;
  for (int j = threadIdx.x >> 4; j < rows; j += kThreads >> 4) {
    const int i = list != nullptr ? list[j] : j;
    if (list == nullptr && flag[i]) continue;
    const float* v = src + i * pitch + c;
    float* dst = ob + size_t(i) * C + c;
    if (vec && c + 4 <= ne) {
      *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(v);
    } else {
      for (int u = 0; u < 4 && c + u < ne; ++u) dst[u] = v[u];
    }
  }
}

// Lists the set flags among flag[0, n) (n <= 128) in order: list[] and
// *count.  Run by one whole warp.
__device__ __forceinline__ void compact_flags(const int* flag, int n, int* list, int* count) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  int base = 0;
  for (int w = 0; w < n; w += 32) {
    const int f = w + lane < n ? flag[w + lane] : 0;
    const unsigned b = __ballot_sync(0xffffffffu, f);
    if (f) list[base + __popc(b & lt)] = w + lane;
    base += __popc(b);
  }
  if (lane == 0) *count = base;
}

// Shared memory of one K3/K4 block (byte offsets).
struct TileLayout {
  int kc, P, qpitch, epitch;
  size_t es, norms, flags, raw_q[2], raw_e[2], out, total;
};

__host__ __device__ inline TileLayout tile_layout(int enc, int vw) {
  TileLayout L;
  const int dd = enc == kI4 ? 2 * vw : vw;
  const int esz = enc == kF32 ? 4 : enc == kBF16 ? 2 : 1;
  const bool whole = dd <= kWholeMax;
  L.kc = whole ? dd : kChunk;
  L.P = L.kc | 1;  // odd row pitch: conflict-free column walks
  L.qpitch = span_pitch(4 * L.kc);
  L.epitch = enc == kI4 ? span_pitch(vw) : span_pitch(esz * L.kc);
  L.es = 0;
  L.norms = align16(L.es + sizeof(float) * kTile * L.P);       // en, zv, qn
  L.flags = align16(L.norms + sizeof(float) * (2 * kTile + kSlots));
  size_t o = align16(L.flags + sizeof(int) * (2 * kSlots + 4));  // flag, list, nnz
  L.out = o;  // the output tile reuses the raw bytes once they are spent
  for (int s = 0; s < 2; ++s) {
    L.raw_q[s] = o;
    if (s == 0 || !whole) o += size_t(kSlots) * L.qpitch;
  }
  for (int s = 0; s < 2; ++s) {
    L.raw_e[s] = o;  // int4 rows stage whole, once
    if (s == 0 || (!whole && enc != kI4)) o += size_t(kTile) * L.epitch;
  }
  const size_t out_end = L.out + sizeof(float) * kSlots * kOutPitch;
  L.total = o > out_end ? o : out_end;
  return L;
}

// The products of `NA` x 16 slot rows (xr[a], kq dims) with the entries
// tx + 16j of es: acc[a][j] += x·e over kk ascending.
template <int NA>
__device__ __forceinline__ void tile_products(float (&acc)[8][4], const float* const (&xr)[8],
                                              const float* es, int P, int kq, int tx) {
#pragma unroll 4
  for (int kk = 0; kk < kq; ++kk) {
    float b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = es[(tx + 16 * j) * P + kk];
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      const float x = xr[a][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[a][j] = fmaf(x, b[j], acc[a][j]);
    }
  }
}

// q (r, QC, dq) fp32; e (r, C, vw) stored entries; scale (dq,) or null;
// the decoded width is dd = 2·vw for int4 (dq = dd or dd - 1), else vw
// (= dq).  Grid (C / kTile, r).
template <int ENC>
__global__ void __launch_bounds__(kThreads)
fes_tile_kernel(const float* __restrict__ q, const uint8_t* __restrict__ e,
                const float* __restrict__ scale, float* __restrict__ out,
                int QC, int C, int dq, int vw) {
  extern __shared__ __align__(16) uint8_t smem[];
  const TileLayout L = tile_layout(ENC, vw);
  const int dd = ENC == kI4 ? 2 * vw : vw;
  const int esz = ENC == kF32 ? 4 : ENC == kBF16 ? 2 : 1;
  const int rowbytes = ENC == kI4 ? vw : vw * esz;
  const int kc = L.kc, P = L.P, qpitch = L.qpitch, epitch = L.epitch;
  const int nchunks = (dd + kc - 1) / kc;
  const bool whole = nchunks == 1;
  const int cl = blockIdx.y, c0 = blockIdx.x * kTile, ne = min(kTile, C - c0);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  float* es = reinterpret_cast<float*>(smem + L.es);
  float* en_s = reinterpret_cast<float*>(smem + L.norms);
  float* zv_s = en_s + kTile;  // a zero slot's output, per entry
  float* qn_s = zv_s + kTile;
  int* flag_s = reinterpret_cast<int*>(smem + L.flags);
  int* list_s = flag_s + kSlots;
  int* nnz_s = list_s + kSlots;
  float* ot = reinterpret_cast<float*>(smem + L.out);
  uint8_t* const raw_q0 = smem + L.raw_q[0];
  uint8_t* const raw_q1 = smem + L.raw_q[1];
  uint8_t* const raw_e0 = smem + L.raw_e[0];
  uint8_t* const raw_e1 = smem + L.raw_e[1];
  const uint8_t* erow0 = e + (size_t(cl) * C + c0) * rowbytes;

  for (int q0 = 0; q0 < QC; q0 += kSlots) {  // passes over the slots
    const int nq = min(kSlots, QC - q0);
    const bool stage_e = !whole || q0 == 0;   // whole rows decode once
    const float* qrow0 = q + (size_t(cl) * QC + q0) * dq;
    float* ob = out + (size_t(cl) * QC + q0) * C + c0;
    auto copy_chunk = [=](int i) {
      const int k0 = i * kc;
      copy_rows(i & 1 ? raw_q1 : raw_q0, qpitch, reinterpret_cast<const uint8_t*>(qrow0 + k0),
                size_t(dq) * 4, nq, 4 * max(0, min(kc, dq - k0)));
      if (stage_e && ENC != kI4)
        copy_rows(i & 1 ? raw_e1 : raw_e0, epitch, erow0 + size_t(k0) * esz, rowbytes, ne,
                  esz * min(kc, dd - k0));
      else if (stage_e && i == 0)
        copy_rows(raw_e0, epitch, erow0, rowbytes, ne, rowbytes);
      cp_async_commit();
    };

    if (tid < kSlots) {  // chunked rows: every slot does its products
      flag_s[tid] = !whole && tid < nq;
      list_s[tid] = tid;
      if (tid == 0) *nnz_s = nq;
    }
    float acc[8][4] = {};  // slots list[ty + 16a] x entries tx + 16j
    float qn = 0.f, en = 0.f, ez = 0.f;
    copy_chunk(0);
    for (int i = 0; i < nchunks; ++i) {
      if (i + 1 < nchunks) {
        copy_chunk(i + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int k0 = i * kc, kn = min(kc, dd - k0), kq = min(kn, dq - k0);
      const uint8_t* rq = i & 1 ? raw_q1 : raw_q0;
      const uint8_t* re = ENC == kI4 || !(i & 1) ? raw_e0 : raw_e1;
      // staged slot row `row`: its bytes start at the source's address mod 16
      const int qph = phase(qrow0 + k0);
      auto qrow = [=](int row) {
        return reinterpret_cast<const float*>(rq + row * qpitch + ((qph + row * dq * 4) & 15));
      };
      if (whole) {  // is every element 0: the rows' 16-byte pieces, in order
        const int units = qpitch >> 4, drow = kThreads / units, du = kThreads - drow * units;
        int row = tid / units, u = tid - row * units;
        for (; row < nq; row += drow, u += du) {
          if (u >= units) {
            u -= units;
            if (++row >= nq) break;
          }
          const int lo = (qph + row * dq * 4) & 15, hi = lo + 4 * kq;  // the row's bytes
          const float4 v = reinterpret_cast<const float4*>(rq + row * qpitch)[u];
          const int b = 16 * u;
          const bool nz = (b >= lo && b < hi && v.x != 0.f) ||
                          (b + 4 >= lo && b + 4 < hi && v.y != 0.f) ||
                          (b + 8 >= lo && b + 8 < hi && v.z != 0.f) ||
                          (b + 12 >= lo && b + 12 < hi && v.w != 0.f);
          if (nz) flag_s[row] = 1;
        }
      }
      if (stage_e) {  // decode the entries: element t of the flat (row, kk)
        const int eph = phase(erow0 + (ENC == kI4 ? 0 : size_t(k0) * esz));
        int row = tid / kn, kk = tid - row * kn;
        const int drow = kThreads / kn, dkk = kThreads - drow * kn;
        for (int t = tid; t < kTile * kn; t += kThreads) {
          const int k = k0 + kk;
          float y = 0.f;
          if (row < ne) {
            const uint8_t* src = re + row * epitch + ((eph + row * rowbytes) & 15);
            y = decode<ENC>(src, ENC == kI4 ? k : kk, vw);
            if (scale != nullptr) y = __fmul_rn(y, k < dq ? scale[k] : 1.f);
          }
          es[row * P + kk] = y;
          row += drow;
          kk += dkk;
          if (kk >= kn) {
            kk -= kn;
            ++row;
          }
        }
      }
      __syncthreads();
      if (tid < kSlots) {  // qn of the slots that do products
        if (flag_s[tid]) {
          const float* x = qrow(tid);
#pragma unroll 8
          for (int kk = 0; kk < kq; ++kk) qn = fmaf(x[kk], x[kk], qn);
        }
        qn_s[tid] = qn;
      } else if (stage_e && tid < kSlots + kTile) {  // one entry each
        const int c = tid - kSlots;
        const float* y = es + c * P;
#pragma unroll 8
        for (int kk = 0; kk < kn; ++kk) {
          en = fmaf(y[kk], y[kk], en);
          ez = fmaf(0.f, y[kk], ez);
        }
        en_s[c] = en;
        zv_s[c] = 0.f + en - 2.f * ez;
      }
      if (whole && tid < 32) compact_flags(flag_s, kSlots, list_s, nnz_s);
      __syncthreads();
      const int nnz = *nnz_s;
      // the occupied slots' products; dims past dq (the int4 pad nibble)
      // would meet a zero query and are left out
      if (nnz > 0 && nnz <= kThreads / kTile) {  // a thread per (slot, entry)
        const float* x = qrow(list_s[min(tid / kTile, nnz - 1)]);
        const float* y = es + (tid % kTile) * P;
#pragma unroll 8
        for (int kk = 0; kk < kq; ++kk) acc[0][0] = fmaf(x[kk], y[kk], acc[0][0]);
      } else if (nnz > 0) {  // rows past nnz repeat the first; never stored
        const float* xr[8];
#pragma unroll
        for (int a = 0; a < 8; ++a) xr[a] = qrow(list_s[ty + 16 * a < nnz ? ty + 16 * a : 0]);
        const int na = (nnz + 15) >> 4;
        if (na <= 1) tile_products<1>(acc, xr, es, P, kq, tx);
        else if (na <= 2) tile_products<2>(acc, xr, es, P, kq, tx);
        else if (na <= 4) tile_products<4>(acc, xr, es, P, kq, tx);
        else tile_products<8>(acc, xr, es, P, kq, tx);
      }
      if (whole)  // the zero slots' rows (after the products: their shared
        // loads would queue behind these stores)
        store_rows(ob, C, nq, ne, flag_s, nullptr, zv_s, 0);
      __syncthreads();  // the next chunk, or the output tile, reuses the bytes
    }

    // the occupied slots' rows, through the output tile
    const int nnz = *nnz_s;
    if (nnz > 0) {
      if (nnz <= kThreads / kTile) {
        const int j = tid / kTile, c = tid % kTile;
        if (j < nnz) {
          const int row = list_s[j];
          ot[row * kOutPitch + c] = qn_s[row] + en_s[c] - 2.f * acc[0][0];
        }
      } else {
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          if (ty + 16 * a >= nnz) continue;
          const int row = list_s[ty + 16 * a];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = tx + 16 * j;
            ot[row * kOutPitch + c] = qn_s[row] + en_s[c] - 2.f * acc[a][j];
          }
        }
      }
      __syncthreads();
      store_rows(ob, C, nnz, ne, nullptr, list_s, ot, kOutPitch);
    }
    if (q0 + kSlots < QC) __syncthreads();  // the next pass reuses the bytes
  }
}

// Shared memory of one K5 block (byte offsets); the copies of the
// codebook and of the slots' rows are the last region, and optional.
struct PqLayout {
  int cpitch, cbpitch, qpitch;
  size_t lut, cn, zl, zrow, orow, qn, flags, codes, cb, q, need, staged;
};

__host__ __device__ inline PqLayout pq_layout(int d, int m, int ksub) {
  PqLayout L;
  const size_t mk = size_t(m) * ksub;
  L.cpitch = span_pitch(kPqC * m);
  L.cbpitch = span_pitch(static_cast<int>(sizeof(float) * d * mk));
  L.qpitch = span_pitch(static_cast<int>(sizeof(float) * kPqQ * d));
  L.lut = 0;
  L.cn = align16(L.lut + sizeof(float) * kPqQ * mk);
  L.zl = align16(L.cn + sizeof(float) * mk);
  L.zrow = align16(L.zl + sizeof(float) * mk);
  L.orow = align16(L.zrow + sizeof(float) * kPqC);   // (kPqQ, kPqC)
  L.qn = align16(L.orow + sizeof(float) * kPqQ * kPqC);
  L.flags = align16(L.qn + sizeof(float) * kPqQ);    // flag, list, place
  L.codes = align16(L.flags + sizeof(int) * (3 * kPqQ + 4));
  L.cb = align16(L.codes + L.cpitch);
  L.need = L.cb;
  L.q = L.cb + L.cbpitch;
  L.staged = L.q + L.qpitch;
  return L;
}

// q (r, QC, d); codes (r, C, m); cb (d, m·ksub); grid (QC / kPqQ, r).
// STAGE: the codebook and the block's slot rows are copied into shared
// memory (where they fit), else read through the cache.
template <bool STAGE>
__global__ void __launch_bounds__(kThreads)
fes_pq_kernel(const float* __restrict__ q, const uint8_t* __restrict__ codes,
              const float* __restrict__ cb, float* __restrict__ out, int QC,
              int C, int d, int m, int ksub) {
  extern __shared__ __align__(16) uint8_t smem[];
  const PqLayout L = pq_layout(d, m, ksub);
  const int mk = m * ksub;
  float* lut = reinterpret_cast<float*>(smem + L.lut);  // (kPqQ, mk), by place
  float* cn = reinterpret_cast<float*>(smem + L.cn);
  float* zl = reinterpret_cast<float*>(smem + L.zl);    // a zero slot's table
  float* zrow = reinterpret_cast<float*>(smem + L.zrow);
  float* orow = reinterpret_cast<float*>(smem + L.orow);  // occupied rows, by place
  float* qn_s = reinterpret_cast<float*>(smem + L.qn);
  int* flag_s = reinterpret_cast<int*>(smem + L.flags);
  int* list_s = flag_s + kPqQ;   // place -> slot
  int* place_s = list_s + kPqQ;  // slot -> place
  int* nnz_s = place_s + kPqQ;
  const int cl = blockIdx.y, s0 = blockIdx.x * kPqQ;
  const int ns = min(kPqQ, QC - s0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* qb = q + (size_t(cl) * QC + s0) * d;
  const uint8_t* cbase = codes + size_t(cl) * C * m;
  float* ob = out + (size_t(cl) * QC + s0) * C;

  if (STAGE) {
    copy_span(smem + L.cb, reinterpret_cast<const uint8_t*>(cb),
              static_cast<int>(sizeof(float) * d * mk), tid, kThreads);
    copy_span(smem + L.q, reinterpret_cast<const uint8_t*>(qb),
              static_cast<int>(sizeof(float) * ns * d), tid, kThreads);
  }
  copy_span(smem + L.codes, cbase, min(kPqC, C) * m, tid, kThreads);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const float* cbp = STAGE ? reinterpret_cast<const float*>(smem + L.cb + phase(cb)) : cb;
  const float* qp = STAGE ? reinterpret_cast<const float*>(smem + L.q + phase(qb)) : qb;
  if (tid < kThreads / 2) {  // column norms, a zero slot's table
    for (int j = tid; j < mk; j += kThreads / 2) {
      float s = 0.f, z = 0.f;
#pragma unroll 8
      for (int k = 0; k < d; ++k) {
        const float v = cbp[size_t(k) * mk + j];
        s = fmaf(v, v, s);
        z = fmaf(0.f, v, z);
      }
      cn[j] = s;
      zl[j] = s - 2.f * z;
    }
  } else {  // a warp per slot: is it a zero row; one lane, the others' qn
    for (int sl = warp - kWarps / 2; sl < kPqQ; sl += kWarps / 2) {
      const float* x = qp + size_t(sl) * d;
      int nz = 0;
      if (sl < ns)
        for (int k = lane; k < d; k += 32) nz |= x[k] != 0.f;
      nz = __any_sync(0xffffffffu, nz);
      if (lane == 0) {
        float s = 0.f;
        if (nz) {
#pragma unroll 8
          for (int k = 0; k < d; ++k) s = fmaf(x[k], x[k], s);
        }
        flag_s[sl] = nz;
        qn_s[sl] = s;
      }
    }
  }
  __syncthreads();
  if (warp == 0) compact_flags(flag_s, kPqQ, list_s, nnz_s);
  __syncthreads();
  const int nnz = *nnz_s;
  if (tid < nnz) place_s[list_s[tid]] = tid;
  const bool vec = (C & 3) == 0 && (reinterpret_cast<uintptr_t>(ob) & 15) == 0;
  for (int c0 = 0; c0 < C; c0 += kPqC) {
    const int nc = min(kPqC, C - c0);
    if (c0 > 0) {
      __syncthreads();
      copy_span(smem + L.codes, cbase + size_t(c0) * m, nc * m, tid, kThreads);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint8_t* cs = smem + L.codes + phase(cbase + size_t(c0) * m);
    for (int c = tid; c < nc; c += 2 * kThreads) {  // a zero slot's row, once
      const int c2 = c + kThreads;
      float a0 = 0.f, a1 = 0.f;
      for (int s = 0; s < m; ++s) {
        a0 = __fadd_rn(a0, zl[s * ksub + cs[c * m + s]]);
        if (c2 < nc) a1 = __fadd_rn(a1, zl[s * ksub + cs[c2 * m + s]]);
      }
      zrow[c] = a0;
      if (c2 < nc) zrow[c2] = a1;
    }
    if (c0 == 0) {  // the occupied slots' tables, once: a thread per (table,
                    // column), two chains interleaved
      for (int t = tid; t < nnz * mk; t += 2 * kThreads) {
        const int t2 = min(t + kThreads, nnz * mk - 1);
        const int i = t / mk, j = t - i * mk, i2 = t2 / mk, j2 = t2 - i2 * mk;
        const float* x = qp + size_t(list_s[i]) * d;
        const float* x2 = qp + size_t(list_s[i2]) * d;
        float dot = 0.f, dot2 = 0.f;
#pragma unroll 8
        for (int k = 0; k < d; ++k) {
          dot = fmaf(x[k], cbp[size_t(k) * mk + j], dot);
          dot2 = fmaf(x2[k], cbp[size_t(k) * mk + j2], dot2);
        }
        lut[t] = cn[j] - 2.f * dot;
        if (t + kThreads < nnz * mk) lut[t2] = cn[j2] - 2.f * dot2;
      }
      __syncthreads();
    }
    for (int t0 = tid; t0 < nnz * nc; t0 += 4 * kThreads) {  // the occupied
      int at[4];                                                 // slots' rows,
      const float* row[4];                                       // four at once
      float acc[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = min(t0 + u * kThreads, nnz * nc - 1), i = t / nc;
        at[u] = t - i * nc;
        row[u] = lut + size_t(i) * mk;
        acc[u] = qn_s[list_s[i]];
      }
      for (int s = 0; s < m; ++s) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          acc[u] = __fadd_rn(acc[u], row[u][s * ksub + cs[at[u] * m + s]]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = t0 + u * kThreads;
        if (t < nnz * nc) orow[(t / nc) * kPqC + at[u]] = acc[u];
      }
    }
    __syncthreads();
    const int groups = (nc + 3) >> 2;  // every row of the chunk
    for (int t = tid; t < ns * groups; t += kThreads) {
      const int sl = t / groups, c = 4 * (t - sl * groups);
      const float* v = (flag_s[sl] ? orow + place_s[sl] * kPqC : zrow) + c;
      float* dst = ob + size_t(sl) * C + c0 + c;
      if (vec && c + 4 <= nc) {
        *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(v);
      } else {
        for (int u = 0; u < 4 && c + u < nc; ++u) dst[u] = v[u];
      }
    }
  }
}

// Lets `kernel` ask for up to kSmemLimit bytes of dynamic shared memory,
// once per device.
template <typename K>
cudaError_t allow_smem(K kernel, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemLimit));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <int ENC>
int launch_tile(const float* q, const uint8_t* e, const float* scale, float* out, int r,
                int QC, int C, int d, int vw, cudaStream_t s) {
  static bool done[kMaxDevices] = {};
  const size_t smem = tile_layout(ENC, vw).total;
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(fes_tile_kernel<ENC>, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((C + kTile - 1) / kTile, r);
  fes_tile_kernel<ENC><<<grid, kThreads, smem, s>>>(q, e, scale, out, QC, C, d, vw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K3/K4: out (r, QC, C) <- squared distances of q (r, QC, d) to the entries
// e (r, C, vw) in encoding `enc` (Enc above; decoded width 2·vw for int4,
// with d = 2·vw or 2·vw - 1; else vw = d), with scale (d,) or null.
// Returns cudaGetLastError() after the launch.
int fes_distances(const void* q, const void* e, int enc, const void* scale,
                  void* out, int r, int QC, int C, int d, int vw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const uint8_t* eb = static_cast<const uint8_t*>(e);
  const float* sc = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  switch (enc) {
    case kF32: return launch_tile<kF32>(qf, eb, sc, o, r, QC, C, d, vw, s);
    case kBF16: return launch_tile<kBF16>(qf, eb, sc, o, r, QC, C, d, vw, s);
    case kI8: return launch_tile<kI8>(qf, eb, sc, o, r, QC, C, d, vw, s);
    case kI4: return launch_tile<kI4>(qf, eb, sc, o, r, QC, C, d, vw, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Shared memory one K5 block needs without the codebook's copy (the
// tables, the zero slot's table and row, the codes chunk); fes_pq_distances
// refuses more than fes_smem_limit().  d does not enter it.
size_t fes_pq_smem_bytes(int m, int ksub) { return pq_layout(0, m, ksub).need; }
size_t fes_smem_limit() { return kSmemLimit; }

// K5: out (r, QC, C) <- qn + Σ_s lut[s·ksub + code_s] for q (r, QC, d),
// codes (r, C, m) and the codebook cb (d, m·ksub).
int fes_pq_distances(const void* q, const void* codes, const void* cb,
                     void* out, int r, int QC, int C, int d, int m, int ksub,
                     void* stream) {
  static bool done[2][kMaxDevices] = {};
  const PqLayout L = pq_layout(d, m, ksub);
  if (L.need > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const bool stage = L.staged <= kSmemLimit;
  const cudaError_t err = stage ? allow_smem(fes_pq_kernel<true>, done[1])
                                : allow_smem(fes_pq_kernel<false>, done[0]);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((QC + kPqQ - 1) / kPqQ, r);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const uint8_t* cd = static_cast<const uint8_t*>(codes);
  const float* cbf = static_cast<const float*>(cb);
  float* o = static_cast<float*>(out);
  if (stage)
    fes_pq_kernel<true><<<grid, kThreads, L.staged, s>>>(qf, cd, cbf, o, QC, C, d, m, ksub);
  else
    fes_pq_kernel<false><<<grid, kThreads, L.need, s>>>(qf, cd, cbf, o, QC, C, d, m, ksub);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

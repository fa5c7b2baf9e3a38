// Fast Entry Selection distances for Hopper (sm_90a):
// (r, QC, d) cluster-grouped queries x (r, C, ·) entry buckets
// -> (r, QC, C) squared distances.
//
// Replaces the three Pallas kernels behind fes_distances in
// src/repro/kernels/fes_kernel.py (pallas_call at :157, :137 and :118):
//  * K3 _fes_tile_kernel: entries fp32, bf16 or int8 (x a per-dim scale);
//  * K4 _fes_int4_kernel: entries nibble-packed int4 (x the scale padded to
//    2·hp with 1.0; the wrapper zero-pads the queries to 2·hp);
//  * K5 _fes_pq_kernel: entries pq codes, scored through each query's
//    lookup table built from the codebook (d, m·ksub).
//
// K3/K4 (fes_tile_kernel): qn + en - 2·dot, no clamp.  The TPU kernel
// accumulated the output block over a sequential d-tile grid axis; here one
// block owns a whole 64 x 64 output tile and loops over d itself, so nothing
// carries between blocks.  One block per (C tile, QC tile, cluster), 256
// threads as 16 x 16, each thread computing a 4 x 4 sub-tile.  Query and
// entry tiles are staged through shared memory 16 dims at a time; entries
// are decoded to fp32 while they are staged (bf16 widens by its bits, int8
// and int4 codes widen and multiply scale[k] once; int4 dim k < hp is the
// low nibble of byte k, dim k >= hp the high nibble of byte k - hp).  The
// norms come from the same staged values.  Ragged QC, C and d edges are
// masked (zero-filled), so the wrapper pads nothing but the int4 queries.
// Plain fp32 FMA, no tensor cores and no TF32 (TF32 keeps about three
// digits and would break id parity with the reference's top-L).
//
// K5 (fes_pq_kernel): qn + Σ_s lut[q, s·ksub + code_s(e)], s ascending, no
// clamp.  The TPU kernel gathered through a multi-hot matrix product (the
// MXU's way to gather); here each block builds the lookup tables of its 32
// queries in shared memory, lut[q, j] = ‖cb_j‖² - 2·q·cb_j, stages the
// codes of its 128 entries, and each thread sums m table entries per output.
//
// Bound at the main path's shapes (r 32, QC 128, C 512, dp 48): bytes,
// dominated by the (r, QC, C) fp32 output (8.4 MB, ~2.5 us at 3.35 TB/s);
// the arithmetic (2·r·QC·C·d for K3/K4, the tables and r·QC·C·m adds for
// K5) takes less at the fp32 rate.  Every design here writes each output
// once, coalesced along C.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;   // output tile edge (queries and entries)
constexpr int kDepth = 16;  // d dims staged per step
constexpr int kThreads = 256;
constexpr int kPqQ = 32;    // queries per pq block
constexpr int kPqC = 128;   // entries per pq block
constexpr size_t kSmemLimit = 232448;  // 227 KB per block on sm_90

// Entry encodings (the wrapper's ENCODINGS, kernels/fes_kernel.py)
enum Enc : int { kF32 = 0, kBF16 = 1, kI8 = 2, kI4 = 3 };

// Element k of stored row `row` (vw stored values per row), fp32 before any
// scale; int4 sign-extends a nibble without shifting a negative value.
template <int ENC>
__device__ __forceinline__ float load_elem(const void* e, size_t row, int vw, int k) {
  if (ENC == kF32) return static_cast<const float*>(e)[row * vw + k];
  if (ENC == kBF16) {
    const unsigned bits = static_cast<const uint16_t*>(e)[row * vw + k];
    return __uint_as_float(bits << 16);
  }
  if (ENC == kI8) return static_cast<float>(static_cast<const int8_t*>(e)[row * vw + k]);
  const bool high = k >= vw;  // kI4
  const unsigned byte = static_cast<const uint8_t*>(e)[row * vw + (high ? k - vw : k)];
  const int nib = static_cast<int>(high ? (byte >> 4) : (byte & 0xFu));
  return static_cast<float>(nib >= 8 ? nib - 16 : nib);
}

// q (r, QC, d); e (r, C, vw) stored entries; scale (d,) or null; d is the
// decoded width (2·vw for int4, vw otherwise).
template <int ENC>
__global__ void __launch_bounds__(kThreads)
fes_tile_kernel(const float* __restrict__ q, const void* __restrict__ e,
                const float* __restrict__ scale, float* __restrict__ out,
                int QC, int C, int d, int vw) {
  __shared__ float qs[kTile][kDepth + 1];
  __shared__ float es[kTile][kDepth + 1];
  const int cl = blockIdx.z;
  const int q0 = blockIdx.y * kTile;
  const int c0 = blockIdx.x * kTile;
  const int tx = threadIdx.x & 15;   // entry sub-index
  const int ty = threadIdx.x >> 4;   // query sub-index
  const float* qb = q + size_t(cl) * QC * d;
  const size_t erow0 = size_t(cl) * C;

  float acc[4][4] = {};
  float qn[4] = {};
  float en[4] = {};
  for (int k0 = 0; k0 < d; k0 += kDepth) {
    for (int t = threadIdx.x; t < kTile * kDepth; t += kThreads) {
      const int row = t / kDepth, col = t % kDepth;
      const int k = k0 + col;
      const int qi = q0 + row, ci = c0 + row;
      qs[row][col] = (qi < QC && k < d) ? qb[size_t(qi) * d + k] : 0.f;
      float x = 0.f;
      if (ci < C && k < d) {
        x = load_elem<ENC>(e, erow0 + ci, vw, k);
        if (scale != nullptr) x = __fmul_rn(x, scale[k]);
      }
      es[row][col] = x;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = es[tx + 16 * j][kk];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qn[i] = fmaf(a[i], a[i], qn[i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) en[j] = fmaf(bb[j], bb[j], en[j]);
    }
    __syncthreads();
  }
  float* ob = out + size_t(cl) * QC * C;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= QC) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = c0 + tx + 16 * j;
      if (ci < C) ob[size_t(qi) * C + ci] = qn[i] + en[j] - 2.f * acc[i][j];
    }
  }
}

inline size_t pq_smem_bytes(int m, int ksub) {
  const size_t mk = size_t(m) * ksub;
  return sizeof(float) * (kPqQ * mk + mk + kPqQ) + size_t(kPqC) * m;
}

// q (r, QC, d); codes (r, C, m); cb (d, m·ksub).
__global__ void __launch_bounds__(kThreads)
fes_pq_kernel(const float* __restrict__ q, const uint8_t* __restrict__ codes,
              const float* __restrict__ cb, float* __restrict__ out, int QC,
              int C, int d, int m, int ksub) {
  extern __shared__ __align__(16) float sm[];
  const int mk = m * ksub;
  float* lut = sm;                                   // (kPqQ, mk)
  float* cn = lut + kPqQ * mk;                       // (mk,)
  float* qn = cn + mk;                               // (kPqQ,)
  uint8_t* cs = reinterpret_cast<uint8_t*>(qn + kPqQ);  // (kPqC, m)
  const int cl = blockIdx.z;
  const int q0 = blockIdx.y * kPqQ;
  const int c0 = blockIdx.x * kPqC;
  const int tid = threadIdx.x;
  const float* qb = q + size_t(cl) * QC * d;

  for (int j = tid; j < mk; j += kThreads) {
    float s = 0.f;
    for (int k = 0; k < d; ++k) s = fmaf(cb[size_t(k) * mk + j], cb[size_t(k) * mk + j], s);
    cn[j] = s;
  }
  for (int i = tid; i < kPqQ; i += kThreads) {
    float s = 0.f;
    if (q0 + i < QC)
      for (int k = 0; k < d; ++k) s = fmaf(qb[size_t(q0 + i) * d + k], qb[size_t(q0 + i) * d + k], s);
    qn[i] = s;
  }
  for (int t = tid; t < kPqC * m; t += kThreads) {
    const int ci = c0 + t / m;
    cs[t] = ci < C ? codes[(size_t(cl) * C + ci) * m + t % m] : 0;
  }
  __syncthreads();
  for (int t = tid; t < kPqQ * mk; t += kThreads) {
    const int i = t / mk, j = t % mk;
    float dot = 0.f;
    if (q0 + i < QC)
      for (int k = 0; k < d; ++k) dot = fmaf(qb[size_t(q0 + i) * d + k], cb[size_t(k) * mk + j], dot);
    lut[t] = cn[j] - 2.f * dot;
  }
  __syncthreads();
  float* ob = out + size_t(cl) * QC * C;
  for (int t = tid; t < kPqQ * kPqC; t += kThreads) {
    const int i = t / kPqC, c = t % kPqC;
    const int qi = q0 + i, ci = c0 + c;
    if (qi >= QC || ci >= C) continue;
    const float* row = lut + size_t(i) * mk;
    const uint8_t* code = cs + size_t(c) * m;
    float acc = qn[i];
    for (int s = 0; s < m; ++s) acc = __fadd_rn(acc, row[s * ksub + code[s]]);
    ob[size_t(qi) * C + ci] = acc;
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K3/K4: out (r, QC, C) <- squared distances of q (r, QC, d) to the entries
// e (r, C, vw) in encoding `enc` (Enc above; d = 2·vw for int4, else vw),
// with scale (d,) or null.  Returns cudaGetLastError() after the launch.
int fes_distances(const void* q, const void* e, int enc, const void* scale,
                  void* out, int r, int QC, int C, int d, int vw, void* stream) {
  const dim3 grid((C + kTile - 1) / kTile, (QC + kTile - 1) / kTile, r);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* sc = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  switch (enc) {
    case kF32: fes_tile_kernel<kF32><<<grid, kThreads, 0, s>>>(qf, e, sc, o, QC, C, d, vw); break;
    case kBF16: fes_tile_kernel<kBF16><<<grid, kThreads, 0, s>>>(qf, e, sc, o, QC, C, d, vw); break;
    case kI8: fes_tile_kernel<kI8><<<grid, kThreads, 0, s>>>(qf, e, sc, o, QC, C, d, vw); break;
    case kI4: fes_tile_kernel<kI4><<<grid, kThreads, 0, s>>>(qf, e, sc, o, QC, C, d, vw); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Shared memory of one K5 block; fes_pq_distances refuses more than
// fes_smem_limit().
size_t fes_pq_smem_bytes(int m, int ksub) { return pq_smem_bytes(m, ksub); }
size_t fes_smem_limit() { return kSmemLimit; }

// K5: out (r, QC, C) <- qn + Σ_s lut[s·ksub + code_s] for q (r, QC, d),
// codes (r, C, m) and the codebook cb (d, m·ksub).
int fes_pq_distances(const void* q, const void* codes, const void* cb,
                     void* out, int r, int QC, int C, int d, int m, int ksub,
                     void* stream) {
  const size_t smem = pq_smem_bytes(m, ksub);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fes_pq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((C + kPqC - 1) / kPqC, (QC + kPqQ - 1) / kPqQ, r);
  fes_pq_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const uint8_t*>(codes),
      static_cast<const float*>(cb), static_cast<float*>(out), QC, C, d, m, ksub);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

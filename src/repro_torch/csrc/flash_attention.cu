// Flash-attention forward for Hopper (sm_90a): causal or non-causal GQA
// attention with an online softmax, o = softmax(q·kᵀ·D^-½)·v per query row.
//
// Replaces the Pallas kernel _flash_fwd_kernel of
// src/repro/kernels/flash_attention.py (flash_attention_tpu, pallas_call at
// :90).  The contract is the TPU kernel's: fp32 scores, running max, sum and
// accumulator; a causal mask q_pos >= k_pos with q and k both starting at
// position 0; key head h / (H / Hkv); masked scores at NEG_INF = -1e30;
// output acc / max(l, 1e-30) in q's dtype; blocks above the diagonal
// skipped.  What the TPU needed and these kernels drop: the repeat of K/V
// over the query group (the kernels read the key head directly), the
// Sq % 128 == 0 assert (tail rows and keys are masked here) and
// whole-sequence K/V blocks in VMEM (K/V stream through shared memory one
// tile at a time).  Layout: q (B, Sq, H, D), k/v (B, Sk, Hkv, D),
// o (B, Sq, H, D), contiguous; D a template parameter.  Two kernels, chosen
// by dtype and D: bf16 at D 64 or 128 on the tensor cores; fp32 at D 16,
// 32, 64, 96 or 128, and bf16 at D 16, 32 or 96, on the fp32 cores:
//
// bf16: flash_fwd_bf16_kernel, on the tensor cores.  One block per (b·h,
// tile of 128 query rows), 288 threads: two consumer warpgroups of 64 rows
// each and one producer warp.  Lane 0 of the producer loads the block's q
// tile once and then streams 128-key K and V tiles into a ring of two
// shared-memory stages with TMA (4-d tensor maps over (D, heads, S, B), so
// the strided head is addressed directly and rows past Sq or Sk arrive as
// zeros), each stage guarded by a "full" mbarrier (transaction bytes) and an
// "empty" one (the 256 consumer threads).  A consumer warpgroup keeps q in
// shared memory for the whole key loop and per tile runs S = q·kᵀ as
// D/16 wgmma m64n128k16 (both operands K-major in shared memory), masks
// only the tiles that reach past Sk or above the diagonal, updates its
// fp32 running max m and sum l (l sums the fp32 p; each row's four threads
// share m with two shuffles and keep l partial until the end), rescales
// the fp32 accumulator, and runs acc += P·V as 8 wgmma m64nDk16 with P in
// registers: the S accumulator's fragment, rounded to bf16, is already the
// A operand's layout, and V is the MN-major B operand (transpose bit).  P
// is rounded to bf16 only there, as the jnp model reference does
// (src/repro/models/layers.py:250); the Pallas kernel keeps it fp32.
// Query tiles are launched last-first, so the long causal rows start first
// and the short ones fill in behind them over the 132 SMs.
//
// fp32: flash_fwd_fp32_kernel, on the fp32 cores (TF32 would not keep the
// fp32 contract of 1e-4).  It also serves the head dims the tensor-core
// kernel is not built for: bf16 inputs are widened to fp32 as they are read
// and the output is rounded to bf16 once, at the store (the plain version's
// arithmetic, in another summation order).  One block of 64 threads per (b·h, tile of 64
// query rows); thread t owns query row q0 + t: its running max m, sum l and
// fp32 accumulator acc[D] live in registers.  The q tile (scaled by D^-½)
// is staged transposed in shared memory, qT[d][t], each K tile transposed,
// kT[d][j] (a row of 68 words, so four consecutive keys are one 16-byte
// broadcast load), each V tile as it is, vs[j][d].  A tile's keys are taken
// 16 at a time: 16 scores in registers, one max and one rescale of acc per
// 16 keys, then acc += p·V with 16-byte broadcast loads of V rows.
//
// Bound: at the RAG path's shape (B 8, S 1024, H 32, Hkv 4, D 64, bf16,
// causal) the work is 2·B·H·S·(S+1)·D ≈ 34.4 GFLOP against 75.5 MB of q, k,
// v and o: operations bound it on the tensor cores (0.035 ms at 989 TFLOP/s
// bf16 dense).  What the bf16 design does about it: both products run on
// the tensor cores from shared memory, loads are one TMA instruction per
// tile and overlap the other stage's products, and the two warpgroups
// interleave their softmax with each other's products.  What it leaves:
// inside one warpgroup the softmax waits for its S product and the next
// S product for the P·V one (no intra-warpgroup pipelining), and the output
// is stored from registers.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// ---- fp32: the fp32-core kernel ------------------------------------------

constexpr int kRows = 64;         // query rows per block, one per thread
constexpr int kTile = 64;         // keys per shared-memory tile
constexpr int kChunk = 16;        // keys per online-softmax step
constexpr int kKStride = kTile + 4;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(D) * kRows + size_t(D) * kKStride +
                          size_t(kTile) * D);
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <int D, typename T>
__global__ void __launch_bounds__(kRows)
    flash_fwd_fp32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ o, int Sq,
                          int Sk, int H, int Hkv, int causal, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;                       // [D][kRows]
  float* kT = qT + D * kRows;             // [D][kKStride]
  float* vs = kT + D * kKStride;          // [kTile][D]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.y * kRows;
  const int t = threadIdx.x;
  const int qpos = q0 + t;

  for (int i = t; i < kRows * D; i += kRows) {
    const int r = i / D, d = i % D;
    float x = 0.f;
    if (q0 + r < Sq)
      x = widen(q[((size_t(b) * Sq + q0 + r) * H + h) * D + d]) * scale;
    qT[d * kRows + r] = x;
  }

  float m = kNegInf, l = 0.f;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;

  // causal: key tiles past the block's last query row contribute nothing
  const int k_end = causal ? min(Sk, q0 + kRows) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile has been read (and qT written)
    for (int i = t; i < kTile * D; i += kRows) {
      const int j = i / D, d = i % D;
      float kx = 0.f, vx = 0.f;
      if (k0 + j < Sk) {
        const size_t off = ((size_t(b) * Sk + k0 + j) * Hkv + hk) * D + d;
        kx = widen(k[off]);
        vx = widen(v[off]);
      }
      kT[d * kKStride + j] = kx;
      vs[j * D + d] = vx;
    }
    __syncthreads();

    const int n_keys = min(kTile, Sk - k0);
    for (int c = 0; c < n_keys; c += kChunk) {
      float s[kChunk];
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) s[jj] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float qd = qT[d * kRows + t];
        const float4* kr =
            reinterpret_cast<const float4*>(&kT[d * kKStride + c]);
#pragma unroll
        for (int u = 0; u < kChunk / 4; ++u) {
          const float4 kk = kr[u];
          s[4 * u + 0] += qd * kk.x;
          s[4 * u + 1] += qd * kk.y;
          s[4 * u + 2] += qd * kk.z;
          s[4 * u + 3] += qd * kk.w;
        }
      }
      float cm = kNegInf;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int kp = k0 + c + jj;
        if (kp >= Sk || (causal && kp > qpos)) s[jj] = kNegInf;
        cm = fmaxf(cm, s[jj]);
      }
      const float m_new = fmaxf(m, cm);
      const float corr = expf(m - m_new);
      float ps = 0.f;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        s[jj] = expf(s[jj] - m_new);
        ps += s[jj];
      }
      l = l * corr + ps;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float4* vr = reinterpret_cast<const float4*>(&vs[(c + jj) * D]);
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const float4 vv = vr[d4];
          acc[4 * d4 + 0] += s[jj] * vv.x;
          acc[4 * d4 + 1] += s[jj] * vv.y;
          acc[4 * d4 + 2] += s[jj] * vv.z;
          acc[4 * d4 + 3] += s[jj] * vv.w;
        }
      }
      m = m_new;
    }
  }

  if (qpos < Sq) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* out = o + ((size_t(b) * Sq + qpos) * H + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) store(out + d, acc[d] * inv);
  }
}

template <int D, typename T>
int launch_fp32(const void* q, const void* k, const void* v, void* o, int B,
                int Sq, int Sk, int H, int Hkv, int causal, float scale,
                cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = flash_fwd_fp32_kernel<D, T>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * H, (Sq + kRows - 1) / kRows);
  kern<<<grid, kRows, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, Hkv, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}


// ---- bf16: the tensor-core kernel ----------------------------------------

namespace tc {

using namespace hopper;

constexpr int kWG = 2;                      // consumer warpgroups
constexpr int kBr = 64 * kWG;               // query rows per block
constexpr int kBc = 128;                    // keys per tile
constexpr int kStages = 2;                  // K/V ring
constexpr int kThreads = 128 * kWG + 32;    // + the producer warp
constexpr int kRowBytes = 128;              // one swizzled row: 64 bf16

// shared memory, from a 1,024-byte aligned base: q [D/64][kBr][64], then per
// stage K [D/64][kBc][64] and V [D/64][kBc][64], then the mbarriers
template <int D>
struct Smem {
  static constexpr uint32_t kQBytes = kBr * D * 2;
  static constexpr uint32_t kTileBytes = kBc * D * 2;
  static constexpr uint32_t kK = kQBytes;
  static constexpr uint32_t kV = kK + kStages * kTileBytes;
  static constexpr uint32_t kFull = kV + kStages * kTileBytes;
  static constexpr uint32_t kEmpty = kFull + 8 * kStages;
  static constexpr uint32_t kQBar = kEmpty + 8 * kStages;
  static constexpr uint32_t kBytes = kQBar + 8 + 1024;  // + alignment slack
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x = lo, low half
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          __nv_bfloat16* __restrict__ o, int B, int Sq,
                          int Sk, int H, int Hkv, int causal,
                          float scale_log2) {
  using L = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + L::kFull, empty = base + L::kEmpty;
  const uint32_t qbar = base + L::kQBar;

  const int n_qt = (Sq + kBr - 1) / kBr;
  const int bh = blockIdx.x % (B * H);
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / (B * H)) * kBr;
  const int b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int k_end = causal ? min(Sk, q0 + kBr) : Sk;
  const int n_tiles = (k_end + kBc - 1) / kBc;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128 * kWG);
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * kWG) {  // the producer warp
    if (lane == 0) {
      mbar_expect_tx(qbar, L::kQBytes);
      for (int c = 0; c < D / 64; ++c)
        tma_load_4d(base + c * kBr * kRowBytes, &tq, 64 * c, h, q0, b, qbar);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(empty + 8 * s, ((j / kStages) - 1) & 1);
        mbar_expect_tx(full + 8 * s, 2 * L::kTileBytes);
        const uint32_t ks = base + L::kK + s * L::kTileBytes;
        const uint32_t vs = base + L::kV + s * L::kTileBytes;
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(ks + c * kBc * kRowBytes, &tk, 64 * c, hk, j * kBc, b,
                      full + 8 * s);
          tma_load_4d(vs + c * kBc * kRowBytes, &tv, 64 * c, hk, j * kBc, b,
                      full + 8 * s);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows row0 .. row0 + 63; this thread holds the
  // accumulator entries of rows r_lo and r_lo + 8, columns 8n + c_lo + {0, 1}
  const int wg = warp / 4;
  const int row0 = q0 + 64 * wg;
  const int r_lo = row0 + 16 * (warp % 4) + lane / 4;
  const int c_lo = 2 * (lane % 4);
  const uint32_t qs = base + wg * 64 * kRowBytes;

  float acc[D / 2];
#pragma unroll
  for (int t = 0; t < D / 2; ++t) acc[t] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  mbar_wait(qbar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const int k0 = j * kBc;
    const uint32_t ks = base + L::kK + s * L::kTileBytes;
    const uint32_t vs = base + L::kV + s * L::kTileBytes;
    mbar_wait(full + 8 * s, (j / kStages) & 1);

    // S = q·kᵀ (64 x kBc), fp32
    float sc[kBc / 2];
#pragma unroll
    for (int t = 0; t < kBc / 2; ++t) sc[t] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t koff = (kk % 4) * 32;
      wgmma_ss_n128(sc,
                    kmajor_desc(qs + (kk / 4) * kBr * kRowBytes + koff),
                    kmajor_desc(ks + (kk / 4) * kBc * kRowBytes + koff),
                    kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int t = 0; t < kBc / 2; ++t) fence_reg(sc[t]);

    // scale into the exp2 domain; mask the tile past Sk or the diagonal
    const bool masked = k0 + kBc > Sk || (causal && k0 + kBc - 1 > row0);
#pragma unroll
    for (int t = 0; t < kBc / 2; ++t) {
      float x = sc[t] * scale_log2;
      if (masked) {
        const int row = r_lo + 8 * ((t >> 1) & 1);
        const int col = k0 + 8 * (t >> 2) + c_lo + (t & 1);
        if (col >= Sk || (causal && col > row)) x = kNegInf;
      }
      sc[t] = x;
    }

    // online softmax, fp32: m shared by the row's four threads, l partial
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int n = 0; n < kBc / 8; ++n)
        mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * i], sc[4 * n + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[i] = exp2f(m[i] - mx);
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < kBc / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(sc[4 * n + 2 * i + e] - mx);
          sc[4 * n + 2 * i + e] = p;
          sum += p;
        }
      }
      l[i] = l[i] * corr[i] + sum;
    }
#pragma unroll
    for (int t = 0; t < D / 2; ++t) acc[t] *= corr[(t >> 1) & 1];

    // P in bf16 as the A operand: keys 16kk .. 16kk + 15 are accumulator
    // entries 8kk .. 8kk + 7
    uint32_t pa[kBc / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBc / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
        fence_reg(pa[kk][r]);
      }
    }
#pragma unroll
    for (int t = 0; t < D / 2; ++t) fence_reg(acc[t]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBc / 16; ++kk) {
      const uint64_t dv = mnmajor_desc(vs + kk * 16 * kRowBytes,
                                       kBc * kRowBytes);
      if constexpr (D == 64)
        wgmma_rs_n64(acc, pa[kk], dv);
      else
        wgmma_rs_n128(acc, pa[kk], dv);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int t = 0; t < D / 2; ++t) fence_reg(acc[t]);
    mbar_arrive(empty + 8 * s);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    const int row = r_lo + 8 * i;
    if (row < Sq) {
      __nv_bfloat16* out = o + ((size_t(b) * Sq + row) * H + h) * D + c_lo;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * n) =
            __floats2bfloat162_rn(acc[4 * n + 2 * i] * inv,
                                  acc[4 * n + 2 * i + 1] * inv);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, fetched through the runtime (no link
// against libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (D, heads, S, B) bf16 tensor as a 4-d map with boxes of 64 x 1 x rows x
// 1 in the 128-byte swizzle; rows past S read as zeros
bool make_map(CUtensorMap* map, const void* ptr, int D, int heads, int S,
              int B, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(heads),
                              cuuint64_t(S), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(D) * 2,
                                 cuuint64_t(heads) * D * 2,
                                 cuuint64_t(S) * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, cuuint32_t(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int Hkv, int causal, float scale,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  // with Sk == 0 no key tile is loaded; the maps only need a valid tensor
  const bool ok = make_map(&tq, q, D, H, Sq, B, kBr) &&
                  (Sk > 0 ? make_map(&tk, k, D, Hkv, Sk, B, kBc) &&
                                make_map(&tv, v, D, Hkv, Sk, B, kBc)
                          : make_map(&tk, q, D, H, Sq, B, kBc) &&
                                make_map(&tv, q, D, H, Sq, B, kBc));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  constexpr uint32_t smem = Smem<D>::kBytes;
  auto kern = flash_fwd_bf16_kernel<D>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_qt = (Sq + kBr - 1) / kBr;
  kern<<<n_qt * B * H, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), B, Sq, Sk, H, Hkv, causal,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// o <- attention(q, k, v); dtype 0 = fp32, 1 = bf16.  bf16 at D 64 or 128
// runs on the tensor cores; fp32 at D 16, 32, 64, 96 or 128 and bf16 at D
// 16, 32 or 96 on the fp32 cores.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for another dtype or D (the wrapper
// refuses them first) or a tensor map that cuTensorMapEncodeTiled refused.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int B, int Sq, int Sk, int H, int Hkv,
                        int D, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FP32_CORES(DD, T) \
  launch_fp32<DD, T>(q, k, v, o, B, Sq, Sk, H, Hkv, causal, scale, s)
  if (dtype == 0) {
    switch (D) {
      case 16: return FP32_CORES(16, float);
      case 32: return FP32_CORES(32, float);
      case 64: return FP32_CORES(64, float);
      case 96: return FP32_CORES(96, float);
      case 128: return FP32_CORES(128, float);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 16: return FP32_CORES(16, __nv_bfloat16);
      case 32: return FP32_CORES(32, __nv_bfloat16);
      case 64: return tc::launch<64>(q, k, v, o, B, Sq, Sk, H, Hkv, causal, scale, s);
      case 96: return FP32_CORES(96, __nv_bfloat16);
      case 128: return tc::launch<128>(q, k, v, o, B, Sq, Sk, H, Hkv, causal, scale, s);
    }
  }
#undef FP32_CORES
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

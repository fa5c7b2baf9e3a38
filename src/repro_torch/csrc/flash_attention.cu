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
// by dtype and D, both on the tensor cores: bf16 at D 64 or 128 in bf16;
// fp32 at D 16, 32, 64, 96 or 128, and bf16 at D 16, 32 or 96, in 3xTF32:
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
// fp32: flash_fwd_fp32_kernel, 3xTF32 with mma.sync m16n8k8.  One TF32
// product keeps about 11 bits of each operand, too few for the fp32
// contract of 1e-4 against the plain version; so every operand of both
// products is split as x = hi + lo (hi = x rounded to TF32 to nearest, ties
// away from zero; lo = x - hi, which the tensor core truncates to TF32:
// about 21 bits in all) and a·b is taken as a_lo·b_hi + a_hi·b_lo +
// a_hi·b_hi into fp32 accumulators (a_lo·b_lo, about 2^-22 of a·b, is
// dropped).  One block of 4 warps per (b·h, 64 query rows); a warp owns 16
// rows: their q in registers (fp32, split at each use), their running max
// m and partial sum l, and the 16 x D accumulator as D/8 m16n8 fragments.
// K and V stream through a two-stage cp.async ring in 32-key tiles (keys
// past Sk arrive as zeros; bf16 rows are widened on the way in).  Per tile
// a warp runs S = q·kᵀ as D/8 x 4 three-term m16n8k8 products, scales by
// D^-½ and masks, updates m and l (each row's four threads share the max
// with two shuffles, as in the bf16 kernel), rescales the accumulator and
// runs acc += P·V as 4 x D/8 three-term products: the S fragment's k index
// is permuted so that it is already P·V's A operand (see the kernel).
// bf16 inputs are exact in TF32, so their lo products are zero and skipped:
// one term for q·kᵀ, two for P·V (P is fp32); the output is rounded to bf16
// once, at the store.  Causal tiles past a warp's last row are skipped by
// that warp.  The splits, not the products, take most of the issue slots.
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
// is stored from registers.  fp32 at chip_smoke's shape (B 2, Sq 384,
// Sk 640, H 16/4, D 128, non-causal): 4·B·H·Sq·Sk·D = 4.03 GFLOP, 0.060 ms
// on the fp32 cores at 67 TFLOP/s; 3xTF32 triples the work, 0.024 ms at
// 495 TFLOP/s TF32.  mma.sync, not wgmma: wgmma takes TF32 only K-major,
// so V would have to be transposed while it is staged.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// ---- fp32: 3xTF32 on the tensor cores ------------------------------------

namespace f32 {

constexpr int kWarps = 4;                // 16 query rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;       // query rows per block
constexpr int kKeys = 32;                // keys per shared-memory tile
constexpr int kStages = 2;               // K/V ring

// one stage: K [kKeys][D + 8] then V [kKeys][D + 4], fp32.  The pads make
// the fragment loads conflict-free: a K row of D + 8 words puts the eight
// rows of a float2 load on distinct banks, a V row of D + 4 words those of
// a scalar load.
template <int D>
struct Layout {
  static constexpr int kKStride = D + 8;
  static constexpr int kVStride = D + 4;
  static constexpr int kStage = kKeys * (kKStride + kVStride);  // floats
  static constexpr size_t kBytes = sizeof(float) * kStages * kStage;
};

// x = hi + lo: hi = x rounded to TF32 (10 mantissa bits) to nearest, ties
// away from zero, its low 13 bits cleared; lo = x - hi, exact in fp32 and
// at most half a TF32 ulp of x.  The tensor core reads a TF32 operand's top
// 19 bits and ignores the rest, so lo enters the product truncated to TF32:
// together about 21 bits of x.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d (16 x 8, fp32) += a (16 x 8, tf32, row) · b (8 x 8, tf32, col)
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a·b with a = a_hi + a_lo and b = b_hi + b_lo: the two small products
// first, a_lo·b_lo dropped.  lo_a / lo_b false: that operand's lo part is
// zero (a bf16 value is exact in TF32) and its product is skipped.
template <bool lo_a, bool lo_b>
__device__ __forceinline__ void mma_3x(float* d, const uint32_t* ah,
                                       const uint32_t* al, uint32_t bh0,
                                       uint32_t bh1, uint32_t bl0,
                                       uint32_t bl1) {
  if (lo_a) mma_tf32(d, al, bh0, bh1);
  if (lo_b) mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t s = hopper::smem_u32(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// keys k0 .. k0 + kKeys - 1 of head hk into one stage; keys past Sk are
// zeros (p is 0 there, and 0 · a finite V row is 0).  fp32 rows are copied
// with 16-byte cp.async; bf16 rows are widened through registers.
template <int D>
__device__ __forceinline__ void load_tile(float* st, const float* k,
                                          const float* v, size_t row0,
                                          int hstride, int k0, int Sk) {
  using L = Layout<D>;
  for (int i = threadIdx.x; i < kKeys * (D / 4); i += kThreads) {
    const int j = i / (D / 4), c = 4 * (i % (D / 4));
    const bool ok = k0 + j < Sk;
    const size_t off = (row0 + size_t(ok ? k0 + j : 0) * hstride) * D + c;
    cp_async16(st + j * L::kKStride + c, k + off, ok);
    cp_async16(st + kKeys * L::kKStride + j * L::kVStride + c, v + off, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int D>
__device__ __forceinline__ void load_tile(float* st, const __nv_bfloat16* k,
                                          const __nv_bfloat16* v, size_t row0,
                                          int hstride, int k0, int Sk) {
  using L = Layout<D>;
  for (int i = threadIdx.x; i < kKeys * (D / 4); i += kThreads) {
    const int j = i / (D / 4), c = 4 * (i % (D / 4));
    float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
    if (k0 + j < Sk) {
      const size_t off = (row0 + size_t(k0 + j) * hstride) * D + c;
      const float2 k01 = load2(k + off), k23 = load2(k + off + 2);
      const float2 v01 = load2(v + off), v23 = load2(v + off + 2);
      kx = make_float4(k01.x, k01.y, k23.x, k23.y);
      vx = make_float4(v01.x, v01.y, v23.x, v23.y);
    }
    *reinterpret_cast<float4*>(st + j * L::kKStride + c) = kx;
    *reinterpret_cast<float4*>(st + kKeys * L::kKStride + j * L::kVStride +
                               c) = vx;
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");  // an empty group
}

// One block per (b·h, 64 query rows); warp w owns rows r0 .. r0 + 15,
// r0 = q0 + 16w.  In an m16n8k8 fragment this thread (g = lane / 4, t =
// lane % 4) holds rows g and g + 8; its columns are permuted so that its
// two values of a row are neighbours: the k index t of a step is dim (or
// key) 2t of it and t + 4 is 2t + 1.  So q·kᵀ reads q and K as float2
// pairs, and the S accumulator's entries (cols 2t, 2t + 1 of rows g, g + 8)
// are already P·V's A operand, with V's rows 2t and 2t + 1 as its B.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_fp32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ o, int Sq,
                          int Sk, int H, int Hkv, int causal, float scale) {
  using L = Layout<D>;
  constexpr bool kLo = sizeof(T) == 4;  // bf16 q, k and v are exact in TF32
  extern __shared__ __align__(16) float smem[];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + 16 * warp;
  const int rows[2] = {r0 + g, r0 + g + 8};

  // q rows g and g + 8, dims 8kk + 2t and 8kk + 2t + 1, in registers for
  // the whole key loop (rows past Sq read as zeros and are not stored)
  float qr[D / 8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const T* qrow = q + ((size_t(b) * Sq + rows[i]) * H + h) * D + 2 * t;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const float2 x = rows[i] < Sq ? load2(qrow + 8 * kk) : make_float2(0.f, 0.f);
      qr[kk][i] = x.x;      // a0 / a1: (row g / g + 8, dim 8kk + 2t)
      qr[kk][2 + i] = x.y;  // a2 / a3: (row g / g + 8, dim 8kk + 2t + 1)
    }
  }

  float acc[D / 8][4];  // o: dims 8n + 2t + {0, 1} of rows g (0, 1), g + 8 (2, 3)
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // causal: key tiles past the block's last row contribute nothing, and
  // past the warp's last row nothing to this warp; nor any to a warp whose
  // rows all lie past Sq
  const int k_end = causal ? min(Sk, q0 + kRows) : Sk;
  const int warp_end = r0 >= Sq ? 0 : causal ? min(k_end, r0 + 16) : k_end;
  const int n_tiles = (k_end + kKeys - 1) / kKeys;
  const size_t kv_row0 = size_t(b) * Sk * Hkv + hk;

  if (n_tiles > 0) load_tile<D>(smem, k, v, kv_row0, Hkv, 0, Sk);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kKeys;
    if (j + 1 < n_tiles)
      load_tile<D>(smem + ((j + 1) % kStages) * L::kStage, k, v,
                             kv_row0, Hkv, k0 + kKeys, Sk);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();  // tile j has landed for every thread

    if (k0 < warp_end) {
      const float* ks = smem + (j % kStages) * L::kStage;
      const float* vs = ks + kKeys * L::kKStride;

      // S = q·kᵀ (16 x kKeys per warp), fp32 accumulators
      float sc[kKeys / 8][4];
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (kLo) split(qr[kk][e], ah[e], al[e]);
          else ah[e] = __float_as_uint(qr[kk][e]);
        }
#pragma unroll
        for (int n = 0; n < kKeys / 8; ++n) {
          const float2 kx = load2(ks + (8 * n + g) * L::kKStride + 8 * kk + 2 * t);
          uint32_t bh0, bh1, bl0 = 0, bl1 = 0;
          if (kLo) {
            split(kx.x, bh0, bl0);
            split(kx.y, bh1, bl1);
          } else {
            bh0 = __float_as_uint(kx.x);
            bh1 = __float_as_uint(kx.y);
          }
          mma_3x<kLo, kLo>(sc[n], ah, al, bh0, bh1, bl0, bl1);
        }
      }

      // scale; mask keys past Sk and, causal, above the diagonal
      const bool masked = k0 + kKeys > Sk || (causal && k0 + kKeys - 1 > r0);
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[n][e] * scale;
          if (masked) {
            const int col = k0 + 8 * n + 2 * t + (e & 1);
            if (col >= Sk || (causal && col > rows[e >> 1])) x = kNegInf;
          }
          sc[n][e] = x;
        }

      // online softmax, fp32: m shared by the row's four threads, l partial
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = m[i];
#pragma unroll
        for (int n = 0; n < kKeys / 8; ++n)
          mx = fmaxf(mx, fmaxf(sc[n][2 * i], sc[n][2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float corr = expf(m[i] - mx);
        m[i] = mx;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = expf(sc[n][2 * i + e] - mx);
            sc[n][2 * i + e] = p;
            sum += p;
          }
        l[i] = l[i] * corr + sum;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          acc[n][2 * i] *= corr;
          acc[n][2 * i + 1] *= corr;
        }
      }

      // acc += P·V: S's n-tile j is the A operand of key step j
#pragma unroll
      for (int kj = 0; kj < kKeys / 8; ++kj) {
        uint32_t ph[4], pl[4];
        split(sc[kj][0], ph[0], pl[0]);  // (row g, key 2t)
        split(sc[kj][2], ph[1], pl[1]);  // (row g + 8, key 2t)
        split(sc[kj][1], ph[2], pl[2]);  // (row g, key 2t + 1)
        split(sc[kj][3], ph[3], pl[3]);  // (row g + 8, key 2t + 1)
        const float* v0 = vs + (8 * kj + 2 * t) * L::kVStride + g;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const float x0 = v0[8 * n], x1 = v0[L::kVStride + 8 * n];
          uint32_t bh0, bh1, bl0 = 0, bl1 = 0;
          if (kLo) {
            split(x0, bh0, bl0);
            split(x1, bh1, bl1);
          } else {
            bh0 = __float_as_uint(x0);
            bh1 = __float_as_uint(x1);
          }
          mma_3x<true, kLo>(acc[n], ph, pl, bh0, bh1, bl0, bl1);
        }
      }
    }
    __syncthreads();  // every warp is done with tile j's stage
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    if (rows[i] < Sq) {
      T* out = o + ((size_t(b) * Sq + rows[i]) * H + h) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        store2(out + 8 * n, acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    }
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int Hkv, int causal, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = Layout<D>::kBytes;
  auto kern = flash_fwd_fp32_kernel<D, T>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * H, (Sq + kRows - 1) / kRows);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, Hkv, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

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
// runs in bf16 on the tensor cores; fp32 at D 16, 32, 64, 96 or 128 and bf16
// at D 16, 32 or 96 in 3xTF32 (flash_fwd_fp32_kernel).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for another
// dtype or D (the wrapper refuses them first) or a tensor map that
// cuTensorMapEncodeTiled refused.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int B, int Sq, int Sk, int H, int Hkv,
                        int D, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FP32_CORES(DD, T) \
  f32::launch<DD, T>(q, k, v, o, B, Sq, Sk, H, Hkv, causal, scale, s)
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

// Flash-attention forward for Hopper (sm_90a): causal or non-causal GQA
// attention with an online softmax, o = softmax(q·kᵀ·D^-½)·v per query row.
//
// Replaces the Pallas kernel _flash_fwd_kernel of
// src/repro/kernels/flash_attention.py (flash_attention_tpu, pallas_call at
// :90).  The contract is the TPU kernel's: fp32 scores, running max, sum and
// accumulator; a causal mask q_pos >= k_pos with q and k both starting at
// position 0; key head h / (H / Hkv); masked scores at NEG_INF = -1e30;
// output acc / max(l, 1e-30) in q's dtype; blocks above the diagonal
// skipped.  P stays fp32 in the P·V product (as in the Pallas kernel; the
// jnp model code rounds it to v's dtype first).  What the TPU needed and
// this kernel drops: the repeat of K/V over the query group (the kernel
// reads the key head directly), the Sq % 128 == 0 assert (tail rows and
// keys are masked here) and whole-sequence K/V blocks in VMEM (K/V stream
// through shared memory one 64-key tile at a time).
//
// Layout: q (B, Sq, H, D), k/v (B, Sk, Hkv, D), o (B, Sq, H, D), contiguous;
// fp32 or bf16; D a template parameter in {64, 128}.  One block of 64
// threads per (b·h, tile of 64 query rows); thread t owns query row q0 + t:
// its running max m, sum l and fp32 accumulator acc[D] live in registers.
// The q tile (scaled by D^-½) is staged transposed in shared memory, qT[d][t]
// (neighbouring threads read neighbouring words), each K tile transposed,
// kT[d][j] (a row of 68 words, so four consecutive keys are one 16-byte
// broadcast load), each V tile as it is, vs[j][d].  A tile's keys are taken
// 16 at a time: 16 scores in registers, one max and one rescale of acc per
// 16 keys, then acc += p·V with 16-byte broadcast loads of V rows.
//
// Bound: at the RAG path's shape (B 8, S 1024, H 32, Hkv 4, D 64, bf16,
// causal) the work is 2·B·H·S·(S+1)·D ≈ 34.4 GFLOP against 75.5 MB of q, k,
// v and o: operations bound it on the tensor cores (0.035 ms at 989 TFLOP/s
// bf16 dense).  This first version computes on the fp32 cores from shared
// memory and does not reach that; wgmma, TMA and bf16 P·V on the tensor
// cores are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;         // query rows per block, one per thread
constexpr int kTile = 64;         // keys per shared-memory tile
constexpr int kChunk = 16;        // keys per online-softmax step
constexpr int kKStride = kTile + 4;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(D) * kRows + size_t(D) * kKStride +
                          size_t(kTile) * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(kRows)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
      x = to_float(q[((size_t(b) * Sq + q0 + r) * H + h) * D + d]) * scale;
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
        kx = to_float(k[off]);
        vx = to_float(v[off]);
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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int Hkv, int causal, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = flash_fwd_kernel<T, D>;
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

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// o <- attention(q, k, v); dtype 0 = fp32, 1 = bf16; D in {64, 128} (the
// wrapper refuses anything else).  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for an unsupported dtype or D.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int B, int Sq, int Sk, int H, int Hkv,
                        int D, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, o, B, Sq, Sk, H, Hkv, causal, scale, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, o, B, Sq, Sk, H, Hkv, causal, scale, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, B, Sq, Sk, H, Hkv, causal,
                                     scale, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, B, Sq, Sk, H, Hkv, causal,
                                      scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

// Hand-written Hopper (sm_90a) flash attention: causal, sliding-window
// and grouped-query, with an online softmax in f32.
//
// Built by nvcc into a shared library with a plain C interface and bound
// with ctypes (repro_torch/kernels/build.py); the Python wrapper and the
// plain PyTorch version are in ../ops.py.  Each entry point launches on
// the stream it is given, allocates nothing, and returns
// cudaGetLastError() so a refused launch is reported.  Built without
// --fmad=false: nothing here has to reproduce another program's rounding
// bit for bit, and fused multiply-adds are both faster and closer.
//
// Replaces the Pallas kernel flash_attention_kernel
// (repro/kernels/flash_attention/kernel.py, body _attn_kernel, wrapper
// ops.py::flash_attention).  Inputs q [B, Sq, H, d], k and v
// [B, Sk, KV, d], contiguous, all f32 or all bf16; output [B, Sq, H, d]
// in q's dtype.  For query row i (position i: the query starts at 0
// whatever Sk is) and key j, the score is (q_i * scale, in f32) . k_j,
// and the key is valid when j < sk_valid, and j <= i if causal, and
// i - j < window if windowed; invalid scores are -1e30.  The running max
// m, denominator l and accumulator acc are f32, updated per key tile in
// the Pallas order:
//   m' = max(m, rowmax(s)); p = exp(s - m'); corr = exp(m - m');
//   l = l * corr + rowsum(p); acc = acc * corr + p . v
// and out = acc / max(l, 1e-30).  Key tiles that the masks kill for the
// whole query tile are never visited (the Pallas kernel's pl.when skip).
//
// Differences from the Pallas design, which the TPU's grid model shaped:
//  - GQA reads KV head h / (H / KV) in place (the order of jnp.repeat in
//    the Pallas wrapper); the repeat is never materialised.
//  - head_dim stays at its true value (80, 120, 128, ... up to 128); the
//    Pallas wrapper pads it to 128 for the MXU lanes.
//  - ragged Sq and Sk need no padded copies: rows past Sq are computed
//    on zeros and not stored, keys past Sk are loaded as zeros and masked.
//  - the KV sweep is a loop inside one CTA (the Pallas "arbitrary" grid
//    axis with VMEM scratch); m, l and acc live in registers.
//
// Bound: operations.  Per (query, key) pair it does 2·d multiply-adds
// (480 flops at d = 120) and it reads each K/V tile once per query tile
// of 64 rows, so at the LM path's shapes the work is ~8x the card's
// bf16 ridge even on tensor cores.  This first version uses FP32 FMA
// only (67 TFLOP/s peak, not the 989 TFLOP/s of the bf16 tensor cores)
// and is expected to be far from the bound; wgmma, TMA and warp
// specialisation are later work.
//
// Design: one CTA of 128 threads per (b, head, 64-row query tile).  The
// query tile is scaled into shared memory once, transposed ([d][64]).
// Each key tile of 64 rows is staged transposed (K) and row-major (V).
// Thread (ty, tx) = (tid / 8, tid % 8) owns query rows 4·ty..4·ty+3:
// scores for key columns 8·tx..8·tx+7 (float4 reads of both tiles), row
// max and sum reduced over the 8 threads of a row by warp shuffles, and
// output columns tx, tx+8, ... < d.  P is written to shared memory over
// the consumed K tile, so the CTA holds (2·d + 64)·68 + 64·d floats
// (102 KB at d = 128): two CTAs fit on an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;
constexpr int kMaxD = 128;
constexpr int kRows = 4;             // query rows per thread
constexpr int kCols = 8;             // key columns per thread
constexpr int kOutCols = kMaxD / 8;  // output columns per thread, at most
constexpr int kLd = kBlockQ + 4;     // row stride of the transposed tiles
constexpr float kNegInf = -1e30f;

static_assert(kBlockQ == kBlockK, "P aliases the transposed K tile");
static_assert((kThreads / 8) * kRows == kBlockQ, "thread rows cover the tile");
static_assert(8 * kCols == kBlockK, "thread columns cover the tile");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

size_t smem_bytes(int d) {
  const int kt_rows = d > kBlockK ? d : kBlockK;
  return sizeof(float) * ((size_t)(d + kt_rows) * kLd + (size_t)kBlockK * d);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           int64_t Sq, int64_t Sk, int H, int KV, int d,
                           int64_t sk_valid, int causal, int has_window,
                           int64_t window, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                                   // [d][kLd]
  float* Kt = Qt + (size_t)d * kLd;                   // [d][kLd]; then P [kBlockK][kLd]
  float* Vs = Kt + (size_t)(d > kBlockK ? d : kBlockK) * kLd;  // [kBlockK][d]

  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int ty = tid >> 3;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int64_t q0 = (int64_t)blockIdx.x * kBlockQ;
  const int64_t q_rs = (int64_t)H * d;
  const int64_t kv_rs = (int64_t)KV * d;
  const T* qb = q + (int64_t)b * Sq * q_rs + (int64_t)h * d;
  const T* kb = k + (int64_t)b * Sk * kv_rs + (int64_t)kvh * d;
  const T* vb = v + (int64_t)b * Sk * kv_rs + (int64_t)kvh * d;
  T* ob = o + (int64_t)b * Sq * q_rs + (int64_t)h * d;

  for (int idx = tid; idx < kBlockQ * d; idx += kThreads) {
    const int r = idx / d, c = idx - r * d;
    const int64_t qp = q0 + r;
    Qt[c * kLd + r] = qp < Sq ? to_f32(qb[qp * q_rs + c]) * scale : 0.f;
  }

  // the key tiles some row of this query tile can see
  const int64_t q_last = (q0 + kBlockQ < Sq ? q0 + kBlockQ : Sq) - 1;
  int64_t k_end = sk_valid < Sk ? sk_valid : Sk;
  if (causal && q_last + 1 < k_end) k_end = q_last + 1;
  int64_t k_begin = 0;
  if (has_window && q0 - window + 1 > 0) k_begin = q0 - window + 1;
  k_begin -= k_begin % kBlockK;

  float m[kRows], l[kRows], acc[kRows][kOutCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kOutCols; ++j) acc[i][j] = 0.f;
  }

  for (int64_t k0 = k_begin; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile's P and V are consumed
    for (int idx = tid; idx < kBlockK * d; idx += kThreads) {
      const int c = idx / d, dd = idx - c * d;
      const int64_t kp = k0 + c;
      const bool in = kp < Sk;
      Kt[dd * kLd + c] = in ? to_f32(kb[kp * kv_rs + dd]) : 0.f;
      Vs[c * d + dd] = in ? to_f32(vb[kp * kv_rs + dd]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < d; ++dd) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qt[dd * kLd + ty * kRows]);
      const float4 k_lo = *reinterpret_cast<const float4*>(&Kt[dd * kLd + tx * kCols]);
      const float4 k_hi = *reinterpret_cast<const float4*>(&Kt[dd * kLd + tx * kCols + 4]);
      const float qv[kRows] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[kCols] = {k_lo.x, k_lo.y, k_lo.z, k_lo.w,
                               k_hi.x, k_hi.y, k_hi.z, k_hi.w};
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] += qv[i] * kv[j];
    }

    float corr[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int64_t qp = q0 + ty * kRows + i;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int64_t kp = k0 + tx * kCols + j;
        bool ok = kp < sk_valid;
        if (causal) ok = ok && qp >= kp;
        if (has_window) ok = ok && qp - kp < window;
        s[i][j] = ok ? s[i][j] : kNegInf;
        rmax = fmaxf(rmax, s[i][j]);
      }
      // the 8 threads of a row are lanes differing in their low 3 bits
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 1));
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 2));
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 4));
      const float m_new = fmaxf(m[i], rmax);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rsum += s[i][j];
      }
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 2);
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 4);
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + rsum;
      m[i] = m_new;
    }

    __syncthreads();  // every thread is done reading K: P goes over it
    float* Pt = Kt;   // [kBlockK][kLd], P transposed
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      *reinterpret_cast<float4*>(&Pt[(tx * kCols + j) * kLd + ty * kRows]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kOutCols; ++j) acc[i][j] *= corr[i];
#pragma unroll 2
    for (int c = 0; c < kBlockK; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(&Pt[c * kLd + ty * kRows]);
      const float pv[kRows] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int j = 0; j < kOutCols; ++j) {
        const int col = tx + 8 * j;
        if (col < d) {
          const float vv = Vs[c * d + col];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][j] += pv[i] * vv;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int64_t qp = q0 + ty * kRows + i;
    if (qp >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kOutCols; ++j) {
      const int col = tx + 8 * j;
      if (col < d) store(&ob[qp * q_rs + col], acc[i][j] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int64_t B,
           int64_t Sq, int64_t Sk, int64_t H, int64_t KV, int64_t d,
           int64_t sk_valid, int causal, int has_window, int64_t window,
           float scale, void* stream) {
  const size_t smem = smem_bytes((int)d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Sq + kBlockQ - 1) / kBlockQ), (unsigned)H,
                  (unsigned)B);
  flash_attention_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, (int)H, (int)KV,
      (int)d, sk_valid, causal, has_window, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int flash_attention_max_head_dim() { return kMaxD; }

int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int64_t B, int64_t Sq, int64_t Sk, int64_t H,
                        int64_t KV, int64_t d, int64_t sk_valid, int causal,
                        int has_window, int64_t window, float scale,
                        void* stream) {
  return launch<float>(q, k, v, o, B, Sq, Sk, H, KV, d, sk_valid, causal,
                       has_window, window, scale, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         int64_t B, int64_t Sq, int64_t Sk, int64_t H,
                         int64_t KV, int64_t d, int64_t sk_valid, int causal,
                         int has_window, int64_t window, float scale,
                         void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KV, d, sk_valid,
                               causal, has_window, window, scale, stream);
}

}  // extern "C"

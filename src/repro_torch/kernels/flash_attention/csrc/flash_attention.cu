// Hand-written Hopper (sm_90a) flash attention: causal, sliding-window
// and grouped-query, with an online softmax in f32.  Two kernels, chosen
// by dtype in ../ops.py: bf16 runs on the tensor cores
// (flash_attention_wgmma_kernel), f32 on the FP32 FMA units
// (flash_attention_simt_kernel).
//
// Built by nvcc into a shared library with a plain C interface and bound
// with ctypes (repro_torch/kernels/build.py); cuTensorMapEncodeTiled is
// looked up in libcuda through the runtime's entry-point query, so the
// library links nothing beyond the CUDA runtime.  The Python wrapper and
// the plain PyTorch version are in ../ops.py.  Each entry point launches on the stream it
// is given, allocates nothing, and returns cudaGetLastError() (or a
// negative code of its own, below) so a refused launch is reported.
//
// Replaces the Pallas kernel flash_attention_kernel
// (repro/kernels/flash_attention/kernel.py:100, body _attn_kernel,
// wrapper ops.py::flash_attention).  Inputs q [B, Sq, H, d], k and v
// [B, Sk, KV, d], contiguous, all f32 or all bf16; output [B, Sq, H, d]
// in q's dtype.  For query row i (position i: the query starts at 0
// whatever Sk is) and key j, the score is scale * (q_i . k_j) in f32,
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
//  - head_dim stays at its true value in memory (80, 120, 128, ...); the
//    Pallas wrapper pads it to 128 for the MXU lanes.
//  - ragged Sq and Sk need no padded copies.
//  - the KV sweep is a loop inside one CTA (the Pallas "arbitrary" grid
//    axis with VMEM scratch); m, l and acc live in registers.
//
// Bound: operations.  Per kept (query, key) pair the function does 2·d
// multiply-adds: at the LM path's shapes, 7.73e11 flop for h2o-danube's
// [2, 8192, 32, 120] / 8 KV heads, window 4096 (0.782 ms at 989 TFLOP/s
// bf16; its 315 MB of q, k, v and out take 0.094 ms at 3.35 TB/s) and
// 6.87e11 flop for zamba2's [2, 8192, 32, 80] causal MHA (0.695 ms;
// 335.5 MB, 0.100 ms).
//
// ---------------------------------------------------------------------------
// bf16: flash_attention_wgmma_kernel
// ---------------------------------------------------------------------------
//
// What held the first design back, which ran bf16 through the FMA kernel
// below: FP32 FMA peaks at 67 TFLOP/s, not the tensor cores' 989;
// every bf16 tile was converted to f32 in shared memory by element-wise
// loads with __syncthreads() between them, so no load was in flight while
// the CTA computed; and a CTA of 64 query rows re-read each K/V tile for
// every 64 rows.  It ran at 11.5 TFLOP/s.
//
// This design:
//  - one CTA of three warpgroups per (b, head, 128-row query tile), the
//    longest tiles (the causal tail) launched first.  Warpgroup 0 is the
//    producer: one thread issues every TMA load, and the warpgroup gives
//    its registers to the two consumer warpgroups (setmaxnreg 24 / 240),
//    which each own 64 query rows;
//  - TMA loads of Q (once) and of each K and V tile into a ring of
//    kStages shared-memory stages, each guarded by a "full" mbarrier
//    (the load's bytes have landed) and an "empty" one (all 8 consumer
//    warps are done with it); K and V have their own barriers, so the
//    next K tile loads while P·V still reads this V.  One 4-D tensor map
//    per operand over [B, S, heads, d] (d innermost).  Q and K come in
//    boxes of 64 columns × 128 rows with the 128-byte swizzle (d <= 64
//    takes one box, d <= 128 two); V in the same boxes where P·V is 64
//    or 128 columns wide, and in 16-column boxes with the 32-byte
//    swizzle where it is 80 (zamba2's heads), so those are not padded to
//    128.  TMA fills the columns past d and the rows past Sq or Sk with
//    zeros: nothing is padded in memory;
//  - S = Q·Kᵀ by wgmma m64n128k16 with both operands K-major in shared
//    memory, over d rounded up to 16 (80 -> 5 steps, 120 -> 8); the
//    zero-filled columns add nothing;
//  - the softmax in registers on the wgmma accumulator layout (each
//    thread holds two rows × 32 columns; row max and sum over the 4
//    threads of a row by shuffles, the sum kept per thread until the
//    end).  The scale is folded with log2(e) into the f32 scores and the
//    exponentials are ex2.approx.  This applies the scale to the f32
//    scores where the plain version scales q in f32 before the product:
//    the two differ by a few f32 ulps, far inside the bf16 tolerance;
//  - masks are computed only on tiles that cross the diagonal, the
//    window's lower edge or sk_valid; interior tiles take one FFMA and
//    one ex2 per score;
//  - O += P·V by wgmma m64nDk16, D = 64, 80 or 128 (d rounded up to one
//    of them), with P converted to bf16 in registers (the accumulator
//    layout of S is the register-A layout of the next product) and V
//    read MN-major (transposed) from the stage;
//  - the epilogue divides by max(l, 1e-30), rounds to bf16 and stores
//    rows < Sq and columns < d straight from registers.
// Per CTA: 160 KB of shared memory at D = 128 (Q 32 KB, two stages of
// K and V, 32 KB each; 136 KB at D = 80), so one CTA per SM; 384 threads
// launched at 168 registers each (checked at launch, see kLaunchRegs).
// Each consumer warpgroup waits for its Q·Kᵀ before the softmax and for
// its P·V before the next tile; the two warpgroups overlap each other's
// softmax only as they drift apart.  Overlapping a warpgroup's own P·V
// with its next softmax (FA3's order) keeps S, O and P in flight at once,
// which ptxas (CUDA 12.9) would not hold in registers: it spilled and
// serialised every wgmma (PERF.md, Findings).
//
// Requirements, checked by ops.py (which raises) and again here: d a
// multiple of 8 and at most 128, and 16-byte-aligned base addresses
// (TMA needs 16-byte-multiple strides and a 16-byte-aligned base).
//
// A wait on an mbarrier that does not complete within ~4 s of clock
// traps, so a pipeline fault ends the launch with an error instead of
// hanging the card.
//
// ---------------------------------------------------------------------------
// f32: flash_attention_simt_kernel (the first design, unchanged)
// ---------------------------------------------------------------------------
//
// FP32 FMA only: its results hold the kernel-vs-plain f32 tolerance
// (5e-4), which tensor cores in TF32 would not.  Built without
// --fmad=false: nothing here has to reproduce another program's
// rounding bit for bit, and fused multiply-adds are both faster and
// closer.
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace simt {

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
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

size_t smem_bytes(int d) {
  const int kt_rows = d > kBlockK ? d : kBlockK;
  return sizeof(float) * ((size_t)(d + kt_rows) * kLd + (size_t)kBlockK * d);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_attention_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
      flash_attention_simt_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Sq + kBlockQ - 1) / kBlockQ), (unsigned)H,
                  (unsigned)B);
  flash_attention_simt_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, (int)H, (int)KV,
      (int)d, sk_valid, causal, has_window, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace simt

namespace wg {

constexpr int kBlockQ = 128;     // query rows per CTA: two consumer warpgroups of 64
constexpr int kBlockK = 128;     // keys per K/V tile
constexpr int kStages = 2;       // depth of the K/V ring
constexpr int kMaxD = 128;
constexpr int kBox = 64;         // bf16 columns per TMA box: 128 bytes, the swizzle span
constexpr int kBoxBytes = kBlockK * kBox * 2;  // one 128-row box, 16 KB
constexpr int kThreads = 384;    // the producer warpgroup, then two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kLaunchRegs = 168;  // 65536 / 384, rounded down to a multiple of 8
constexpr float kNegInf = -1e30f;
constexpr long long kHangCycles = 1ll << 33;  // ~4 s at the H100's 1.98 GHz boost

static_assert(kBlockQ == kBlockK, "Q and K/V boxes share kBoxBytes");
static_assert(kBlockQ == 2 * 64, "one 64-row wgmma tile per consumer warpgroup");
static_assert(128 * kProducerRegs + 256 * kConsumerRegs <= kThreads * kLaunchRegs,
              "setmaxnreg moves no more registers than the launch holds");

// The shared-memory tiles of one instantiation, from a 1024-byte-aligned
// base.  Q and K are read K-major by Q·Kᵀ: 128 rows in boxes of 64
// columns with the 128-byte swizzle (it repeats every 8 rows of 128
// bytes), as many boxes as the kQKSteps steps of 16 columns need.  V is
// read MN-major by P·V, kD columns wide: in 64-column boxes with the
// 128-byte swizzle where kD is a multiple of 64, else in 16-column boxes
// with the 32-byte swizzle (8 rows of 32 bytes), so that kD = 80 needs no
// padding to 128.
template <int kD, int kQKSteps>
struct Layout {
  static constexpr int kQKBoxes = (kQKSteps * 16 + kBox - 1) / kBox;
  static constexpr int kQKTile = kQKBoxes * kBoxBytes;  // one Q or K tile
  static constexpr bool kVWide = kD % kBox == 0;
  static constexpr int kVBox = kVWide ? kBox : 16;       // columns per V box
  static constexpr int kVBoxes = kD / kVBox;
  static constexpr int kVBoxBytes = kBlockK * kVBox * 2;
  static constexpr int kVTile = kVBoxes * kVBoxBytes;
  // V's wgmma descriptor: the stride between column boxes (LBO), between
  // groups of 8 keys (SBO), the step of 16 keys, and the swizzle mode
  static constexpr uint32_t kVLbo = kVBoxBytes;
  static constexpr uint32_t kVSbo = 8 * kVBox * 2;
  static constexpr uint32_t kVStep = 16 * kVBox * 2;
  static constexpr uint32_t kVSwizzle = kVWide ? 1 : 3;  // 128 B : 32 B
  static constexpr int kQ = 0;
  static constexpr int kK = kQKTile;
  static constexpr int kV = kK + kStages * kQKTile;
  static constexpr int kBar = kV + kStages * kVTile;  // 1 + 4 · kStages mbarriers
  static constexpr int kBytes = kBar + 8 * (1 + 4 * kStages) + 1024;  // + alignment slack
  static_assert(kD % 16 == 0 && kD <= kMaxD && kQKSteps * 16 <= kQKBoxes * kBox, "tile shapes");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed; trap if it never
// does (a pipeline fault), so the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > kHangCycles) __trap();
  }
}

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// A wgmma shared-memory descriptor for a swizzled operand: start address,
// leading and stride byte offsets (16-byte units), and the swizzle mode in
// bits 62-63 (1 = 128 B, 3 = 32 B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t swizzle = 1) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(swizzle) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving reads or writes of wgmma operands across
// the asynchronous products (CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define WG_ACC8(d, i)                                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),           \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_ACC32(d) WG_ACC8(d, 0), WG_ACC8(d, 8), WG_ACC8(d, 16), WG_ACC8(d, 24)
#define WG_ACC40(d) WG_ACC32(d), WG_ACC8(d, 32)
#define WG_ACC64(d) \
  WG_ACC32(d), WG_ACC8(d, 32), WG_ACC8(d, 40), WG_ACC8(d, 48), WG_ACC8(d, 56)

// D[64 x 128] (+)= A[64 x 16] . B[128 x 16]^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64], uint64_t a, uint64_t b,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC64(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 80] += A[64 x 16] . B[16 x 80], A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_m64n80k16(float (&d)[40], const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : WG_ACC40(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
// D[64 x 64] += A[64 x 16] . B[16 x 64], A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


template <int kD>
__device__ __forceinline__ void wgmma_pv(float (&o)[kD / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (kD == 128) {
    wgmma_rs_m64n128k16(o, a, b);
  } else if constexpr (kD == 80) {
    wgmma_rs_m64n80k16(o, a, b);
  } else {
    static_assert(kD == 64, "head tiles of 64, 80 or 128 columns");
    wgmma_rs_m64n64k16(o, a, b);
  }
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// kD: the width of P·V (64, 80 or 128 columns, d <= kD); kQKSteps: the
// depth of Q·Kᵀ in steps of 16 (d rounded up to 16).
template <int kD, int kQKSteps>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_wgmma_kernel(__grid_constant__ const CUtensorMap tm_q,
                                 __grid_constant__ const CUtensorMap tm_k,
                                 __grid_constant__ const CUtensorMap tm_v,
                                 __nv_bfloat16* __restrict__ o, int Sq, int Sk, int H, int KV,
                                 int d, int sk_valid, int causal, int has_window,
                                 int64_t window, float scale_log2) {
  using L = Layout<kD, kQKSteps>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQ;
  const uint32_t sK = base + L::kK;
  const uint32_t sV = base + L::kV;
  const uint32_t q_full = base + L::kBar;
  const uint32_t k_full = q_full + 8;                  // + 8 · stage
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages;
  const uint32_t v_empty = k_empty + 8 * kStages;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;  // longest tiles first

  // the key tiles some row of this query tile can see (the plain
  // version's _key_range with block_k = kBlockK)
  const int64_t q_end = q0 + kBlockQ < Sq ? q0 + kBlockQ : Sq;
  int64_t k_end = sk_valid < Sk ? sk_valid : Sk;
  if (causal && q_end < k_end) k_end = q_end;
  int64_t k_begin = 0;
  if (has_window && q0 - window + 1 > 0) k_begin = q0 - window + 1;
  k_begin -= k_begin % kBlockK;
  const int n_tiles = k_end > k_begin ? (int)((k_end - k_begin + kBlockK - 1) / kBlockK) : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, kConsumerWarps);
      mbar_init(v_empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      tma_prefetch(&tm_q);
      tma_prefetch(&tm_k);
      tma_prefetch(&tm_v);
      mbar_expect_tx(q_full, L::kQKTile);
#pragma unroll
      for (int bx = 0; bx < L::kQKBoxes; ++bx)
        tma_load(sQ + bx * kBoxBytes, &tm_q, q_full, bx * kBox, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const uint32_t free_parity = ((it / kStages) & 1) ^ 1;  // round 0 passes at once
        const int k0 = (int)k_begin + it * kBlockK;
        mbar_wait(k_empty + 8 * s, free_parity);
        mbar_expect_tx(k_full + 8 * s, L::kQKTile);
#pragma unroll
        for (int bx = 0; bx < L::kQKBoxes; ++bx)
          tma_load(sK + s * L::kQKTile + bx * kBoxBytes, &tm_k, k_full + 8 * s, bx * kBox, kvh,
                   k0, b);
        mbar_wait(v_empty + 8 * s, free_parity);
        mbar_expect_tx(v_full + 8 * s, L::kVTile);
#pragma unroll
        for (int bx = 0; bx < L::kVBoxes; ++bx)
          tma_load(sV + s * L::kVTile + bx * L::kVBoxBytes, &tm_v, v_full + 8 * s,
                   bx * L::kVBox, kvh, k0, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int tid = threadIdx.x - 128;
    const int wgi = tid / 128;            // 0 or 1
    const int warp = (tid / 32) % 4;
    const int lane = tid % 32;
    const int row = 16 * warp + lane / 4;  // this thread's rows: row and row + 8
    const int col = 2 * (lane % 4);        // and columns col, col + 1 of each 8
    const int qa = q0 + 64 * wgi;          // the warpgroup's first query row

    float acc[kD / 2];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};  // this thread's share of the row sums
    const uint32_t q_rows = sQ + 64 * wgi * 128;  // the warpgroup's 64 rows of 128 bytes

    mbar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const uint32_t full_parity = (it / kStages) & 1;
      const int k0 = (int)k_begin + it * kBlockK;
      const uint32_t k_tile = sK + s * L::kQKTile;
      const uint32_t v_tile = sV + s * L::kVTile;

      // S = Q · Kᵀ: [64 x 128] per warpgroup
      float sc[64];
      mbar_wait(k_full + 8 * s, full_parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQKSteps; ++kk) {
        const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        wgmma_ss_m64n128k16(sc, smem_desc(q_rows + off, 16, 1024),
                            smem_desc(k_tile + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      if (lane == 0) mbar_arrive(k_empty + 8 * s);

      // masks only where the tile crosses the diagonal, the window's lower
      // edge or sk_valid; there the scores are scaled here, elsewhere
      // inside the exponent's FFMA
      float mult = scale_log2;
      const bool edge = k0 + kBlockK > sk_valid || (causal && k0 + kBlockK - 1 > qa) ||
                        (has_window && (int64_t)(qa + 63) - k0 >= window);
      if (edge) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int qp = qa + row + 8 * ((i >> 1) & 1);
          const int kp = k0 + 8 * (i >> 2) + col + (i & 1);
          bool ok = kp < sk_valid;
          if (causal) ok = ok && kp <= qp;
          if (has_window) ok = ok && (int64_t)(qp - kp) < window;
          sc[i] = ok ? sc[i] * scale_log2 : kNegInf;
        }
        mult = 1.f;
      }

      // online softmax on rows (row, row + 8): elements i with (i >> 1) & 1
      // equal to 0 and 1
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * mult);
        corr[r] = fast_exp2(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr[r];
      }
      uint32_t p[32];  // P in bf16: the register-A fragments of 8 k-steps
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int r = (i >> 1) & 1;
        const float e0 = fast_exp2(fmaf(sc[i], mult, -m[r]));
        const float e1 = fast_exp2(fmaf(sc[i + 1], mult, -m[r]));
        l[r] += e0 + e1;
        p[i / 2] = pack_bf16(e0, e1);
      }
#pragma unroll
      for (int i = 0; i < kD / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

      // O += P · V
      mbar_wait(v_full + 8 * s, full_parity);
      fence_regs(acc);
      fence_regs(p);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
        wgmma_pv<kD>(acc, a, smem_desc(v_tile + kk * L::kVStep, L::kVLbo, L::kVSbo,
                                       L::kVSwizzle));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(v_empty + 8 * s);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = qa + row + 8 * r;
      if (qp >= Sq) continue;
      __nv_bfloat16* orow = o + ((int64_t)(b * (int64_t)Sq + qp) * H + h) * d;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        if (8 * j < d)  // d % 8 == 0: the pair col, col + 1 is inside
          *reinterpret_cast<uint32_t*>(orow + 8 * j + col) =
              pack_bf16(acc[4 * j + 2 * r] * inv[r], acc[4 * j + 2 * r + 1] * inv[r]);
      }
    }
  }
}

// negative return codes of the bf16 entry point (positive ones are cudaError_t)
constexpr int kErrArgs = -1;       // d, alignment or a length the kernel does not take
constexpr int kErrRegisters = -2;  // the kernel was not built at kLaunchRegs registers
constexpr int kErrTensorMap = -1000;  // minus the CUresult of cuTensorMapEncodeTiled

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once (nullptr if absent)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// a 4-D map over [B, S, heads, d] bf16, d innermost, boxes of
// box_cols x 1 x 128 x 1 with the 128-byte (64 columns) or 32-byte (16)
// swizzle
int encode(CUtensorMap* map, const void* ptr, int64_t B, int64_t S, int64_t heads,
           int64_t d, int box_cols) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kErrTensorMap - (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(d * 2), (cuuint64_t)(heads * d * 2),
                                 (cuuint64_t)(S * heads * d * 2)};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, 1, (cuuint32_t)kBlockK, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
      elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      box_cols == kBox ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap - (int)r;
}

template <int kD, int kQKSteps>
int launch(const void* q, const void* k, const void* v, void* o, int64_t B, int64_t Sq,
           int64_t Sk, int64_t H, int64_t KV, int64_t d, int64_t sk_valid, int causal,
           int has_window, int64_t window, float scale, void* stream) {
  const auto kernel = flash_attention_wgmma_kernel<kD, kQKSteps>;
  static int regs = -1;  // the register count ptxas gave this instantiation
  if (regs < 0) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    regs = attr.numRegs;
  }
  // setmaxnreg hands the producer's registers to the consumers: with fewer
  // at launch the consumers' setmaxnreg.inc would never be satisfied
  if (regs != kLaunchRegs) return kErrRegisters;
  using L = Layout<kD, kQKSteps>;
  constexpr int smem = L::kBytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tm_q, tm_k, tm_v;
  int rc = encode(&tm_q, q, B, Sq, H, d, kBox);
  if (rc == 0) rc = encode(&tm_k, k, B, Sk, KV, d, kBox);
  if (rc == 0) rc = encode(&tm_v, v, B, Sk, KV, d, L::kVBox);
  if (rc != 0) return rc;
  const dim3 grid((unsigned)((Sq + kBlockQ - 1) / kBlockQ), (unsigned)H, (unsigned)B);
  flash_attention_wgmma_kernel<kD, kQKSteps><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), (int)Sq, (int)Sk, (int)H, (int)KV,
      (int)d, (int)sk_valid, causal, has_window, window, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* o, int64_t B, int64_t Sq,
             int64_t Sk, int64_t H, int64_t KV, int64_t d, int64_t sk_valid, int causal,
             int has_window, int64_t window, float scale, void* stream) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (d < 8 || d > kMaxD || d % 8 || !aligned(q) || !aligned(k) || !aligned(v) ||
      Sq > INT32_MAX || Sk < 1 || Sk > INT32_MAX || !(scale > 0.f))
    return kErrArgs;
  if (d <= 64)
    return launch<64, 4>(q, k, v, o, B, Sq, Sk, H, KV, d, sk_valid, causal, has_window,
                         window, scale, stream);
  if (d <= 80)
    return launch<80, 5>(q, k, v, o, B, Sq, Sk, H, KV, d, sk_valid, causal, has_window,
                          window, scale, stream);
  return launch<128, 8>(q, k, v, o, B, Sq, Sk, H, KV, d, sk_valid, causal, has_window,
                        window, scale, stream);
}

}  // namespace wg
}  // namespace

extern "C" {

// the tile sizes and the largest head dim, for ops.py to check its own
// copies against: 0 -> largest d, 1/2 -> the wgmma kernel's query / key
// tile
int flash_attention_config(int what) {
  switch (what) {
    case 0: return wg::kMaxD;
    case 1: return wg::kBlockQ;
    case 2: return wg::kBlockK;
    default: return -1;
  }
}

int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int64_t B, int64_t Sq, int64_t Sk, int64_t H,
                        int64_t KV, int64_t d, int64_t sk_valid, int causal,
                        int has_window, int64_t window, float scale,
                        void* stream) {
  return simt::launch<float>(q, k, v, o, B, Sq, Sk, H, KV, d, sk_valid, causal,
                             has_window, window, scale, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         int64_t B, int64_t Sq, int64_t Sk, int64_t H,
                         int64_t KV, int64_t d, int64_t sk_valid, int causal,
                         int has_window, int64_t window, float scale,
                         void* stream) {
  return wg::dispatch(q, k, v, o, B, Sq, Sk, H, KV, d, sk_valid, causal, has_window,
                      window, scale, stream);
}

}  // extern "C"

// Hand-written Hopper (sm_90a) RWKV6 wkv recurrence: linear attention
// with a per-channel, data-dependent decay.  Two kernels, chosen by dtype
// in ../ops.py: bf16 runs the chunked form on the tensor cores
// (wkv6_tc_kernel), f32 walks the tokens one by one on the FP32 FMA units
// (wkv6_simt_kernel).
//
// Built by nvcc into a shared library with a plain C interface and bound
// with ctypes (repro_torch/kernels/build.py); the Python wrapper and the
// plain PyTorch version are in ../ops.py.  Each entry point launches on
// the stream it is given, allocates nothing, and returns
// cudaGetLastError() so a refused launch is reported.
//
// Replaces the Pallas kernel wkv6_kernel
// (repro/kernels/rwkv6_wkv/kernel.py:88, body _wkv_kernel, wrapper
// ops.py::wkv6, oracle ref.py::wkv6_ref).  Inputs r, k, v [B, T, H, N]
// (all f32 or all bf16), the decay w [B, T, H, N] (f32, in [0, 1)), the
// bonus u [H, N] (f32) and an optional initial state s0 [B, H, N, N]
// (f32, S[i (key), j (value)]; null means zeros).  Per (b, h), for every
// token t in order:
//   y_t = r_t . S + (r_t . (u * k_t)) v_t      (= r_t . (S + diag(u) k_t v_t^T))
//   S   = diag(w_t) S + k_t v_t^T
// y is written in r's dtype, the final state in f32.  This is the exact
// recurrence of ref.py.  Both kernels compute it; they differ from it,
// and from each other, by float rounding and by the bf16 kernel's floor
// of w at 1e-12 (the Pallas kernel's), a change below 1e-12 of the
// state.
//
// Bound: bytes.  Each input is read once and y written once (506 MB at
// 2 x 8192 tokens, 40 heads of 64, bf16 r/k/v and f32 w: 0.151 ms at
// 3.35 TB/s); the recurrence is 4 flops per state entry per token (10.7
// GFLOP there: 0.011 ms at the bf16 tensor-core rate).
//
// ---------------------------------------------------------------------------
// bf16: wkv6_tc_kernel (the chunked form on mma.sync)
// ---------------------------------------------------------------------------
//
// What held the first design back (it ran bf16 through the FMA kernel
// below): 160 CTAs of 128 threads, each walking 8192 tokens one at a
// time, a chain of 16 dependent FMAs, two shuffles and three shared loads
// a token; chunks staged by synchronous loads after a barrier; no tensor
// cores.  5.418 ms a launch at the path shape, 36x the bound.
//
// This design computes the function by chunks of kQ = 64 tokens, in
// order, one CTA of 8 warps per (b, h) (80 at the path shape, each on
// its own SM): the chain of 128 chunks is the serial part, so the warps
// split each chunk's work.  The Pallas kernel's [c, c, N] decay tile (1
// MB in f32) does not fit a Hopper SM; the chunk is split into 4
// sub-chunks of kSub = 16 tokens instead, and every factor below is an
// input times a decay in (0, 1], so nothing overflows.  With w' = max(w, 1e-12) (the
// Pallas kernel's floor: w = 0 is safe), 1 past T and in the padded
// channels, and products taken within each sub-chunk a:
//   Rd_t = r_t prod(w' of a's tokens before t) = r_t exp(cumprev_t - e_{a-1})
//   Kd_s = k_s prod(w' of b's tokens after s)  = k_s exp(e_b - cum_s)
//   T_a  = prod(w' of a's tokens),  e_a = cum at a's last token
// per key channel (the per-channel decay does not factor out of r.k, so
// it rides on each factor).  Then, for t in sub-chunk a, s in sub-chunk b:
//   b < a:  att[t, s] = sum_i (Rd_t D_ab)_i (Kd_s)_i,  D_ab = T_{b+1} ..
//           T_{a-1}, i.e. r_t exp(cumprev_t - e_b) against k_s exp(e_b -
//           cum_s); 16 x 16 x N on mma.sync m16n8k16
//   b = a:  att[t, s] = sum_i r_t k_s prod_{s < sigma < t} w'_sigma for
//           s < t, att[t, t] = sum_i r_t u k_t (the bonus): exactly in f32
//           on the FMA units, the decay as a running product
//   y_t = sum_s att[t, s] v_s + (Rd_t E_a) S,   E_a = T_0 .. T_{a-1}
//   S   = diag(T_0 .. T_3) S + sum_s (Kd_s F_b) v_s^T,  F_b = T_{b+1} .. T_3
// Every decay is a product of w' over the tokens it spans, equal to 2^(sum
// of log2 w') and exact to a few ulps: no log or exp (the SFU would be
// the busiest unit), and no difference of two long prefix sums to lose
// precision in a chunk of strong decay.  A product that underflows is a
// decay below 1e-38, where the true term is as small.
//  - Precision: every factor computed in f32 (Rd D, Rd E, Kd, Kd F, att,
//    S) enters its product as a bf16 pair hi + lo (lo = the rounding
//    error of hi); a product of two computed factors takes hi hi + hi lo
//    + lo hi.  r, k and v enter as their bf16 values; every sum is f32.
//    Rounding each factor once to bf16 puts the final state over the
//    1e-3 tolerance on every draw tests/test_torch_rwkv6.py emulates;
//    the split stays well within it.
//  - Work a chunk, between four barriers: (1) per (pair of key channels,
//    sub-chunk, direction), one a thread, Rd and T or Kd; the warp pair
//    of sub-chunk a its diagonal block (lane (p, q) takes tokens p and
//    15 - p, 15 pairs in all, over an eighth of the channels, joined by
//    three shuffles at the end); (2) per (key channel, sub-chunk) the
//    products of T that D, E and F take; (3) warps 0-5 one att block (a,
//    b < a) each, into shared memory, while warps 6 and 7 (sub-chunk 3,
//    the most y work) update their rows of S; (4) the warp pair of
//    sub-chunk a its y, a half of the value columns each, then warps 0-5
//    their rows of S.  S is held in registers in the accumulator layout,
//    [16 rows, N/2 columns] a warp, and written to shared memory (hi, lo;
//    two buffers) once a chunk for r S.
//  - Loads: r, k and w are read only in (1), so right after it thread 0
//    has the TMA load the next chunk's r, k, w and v (v into a two-stage
//    ring, as y and S read it until the chunk's end), one box of [64
//    tokens, a padded row] an array, completing on an mbarrier; the
//    copies overlap the rest of the chunk.  The box is a row stride wide,
//    so the TMA fills the padding columns past N with zeros, and the rows
//    past T too.  The TMA needs N a multiple of 8 and 16-byte-aligned r,
//    k, v, w; other shapes run the same kernel with element-wise loads
//    (kTma false).  (Issuing one cp.async piece, or one 1-D bulk copy,
//    a row put the load's issue on every chunk's critical path.)
//  - The head size is padded to kN in {16, 32, 48, 64} with r = k = 0
//    and w' = 1, so every head size the wrapper takes runs here.
//  - Why one pass over the chunks in order: a two-pass form (chunk states
//    in parallel, a scan, then y) would write and read back 167 MB of f32
//    states at the path shape, a third of the kernel's own 506 MB, to
//    spread 128 chunks over more SMs; one pass keeps 80 SMs busy with no
//    traffic beyond the bound's.
// Shared memory at kN 64: r, k (bf16), w (f32), two stages of v, Rd and
// Kd (f32), four state buffers, att and the decays: 152.3 KB a CTA.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// f32: wkv6_simt_kernel (the first design, unchanged)
// ---------------------------------------------------------------------------
//
// FP32 FMA only: its results hold the kernel-vs-plain f32 tolerance
// (1e-3) with room, which bf16 tensor-core operands would not without the
// split above.
//
// The Pallas kernel materialises a [c, c, N] decay tile per chunk (1 MB
// at c = 64, N = 64, in VMEM); it does not fit a Hopper SM's shared
// memory, and the token-by-token form needs none: as in the official
// RWKV CUDA kernel, the value columns j of S evolve independently
// (column j needs r, k, w, u and v[j] only) and are held in registers.
// The grid is (column group of 32, h, b); ragged T needs no padded copy;
// the recurrence is a loop inside the CTA (the Pallas "arbitrary" grid
// axis with a VMEM scratch state).
//
// 128 threads per CTA, 4 per value column: thread (c, q) holds keys i of
// quarter q of column j0 + c, NP/4 floats in registers (NP = 16, 32 or
// 64, the head size rounded up; the padding has r = k = 0 and w = 1, so
// it adds nothing), and y_t[j] is its 4 partial sums joined by two
// xor-shuffles.  (One thread per column, as in the official kernel, left
// one warp per CTA with a 64-long chain of dependent multiply-adds per
// token: 15.7 ms at the path's shape on an H100.)  Per chunk of 32 tokens
// the CTA stages r, k, w and its 32 columns of v in shared memory, then
// the bonus r_t . (u * k_t) of each token, one group of 4 threads per
// token.  Rows are padded by 4 floats every 16, so the four quarters a
// warp reads as float4s at each token lie in different banks.


constexpr int kCols = 32;                 // value columns per CTA
constexpr int kSplit = 4;                 // threads per column
constexpr int kThreads = kCols * kSplit;  // 128
constexpr int kT = 32;                    // tokens staged per chunk
constexpr int kMaxN = 64;                 // largest head size
static_assert(kT == kThreads / kSplit, "one thread group per token for the bonus");

// position of key channel i in a staged row: 4 floats of padding after
// every 16, so the quarters of a row start in different banks
__host__ __device__ constexpr int pad(int i) { return i + (i / 16) * 4; }

template <int NP>
__global__ void __launch_bounds__(kThreads)
    wkv6_simt_kernel(const float* __restrict__ r, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ u, const float* __restrict__ s0,
                     float* __restrict__ y, float* __restrict__ sout, int64_t Tn,
                     int H, int N) {
  constexpr int Q = NP / kSplit;  // keys per thread
  constexpr int LD = pad(NP);     // staged row stride
  static_assert(Q % 4 == 0 && NP <= kMaxN, "float4 quarters");
  __shared__ __align__(16) float sR[kT * LD];
  __shared__ __align__(16) float sK[kT * LD];
  __shared__ __align__(16) float sW[kT * LD];
  __shared__ float sV[kT * kCols];
  __shared__ float sA[kT];
  __shared__ float sU[LD];

  const int tid = threadIdx.x;
  const int c = tid / kSplit;  // column within the CTA
  const int q = tid % kSplit;  // quarter of the keys
  const int j0 = blockIdx.x * kCols;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int j = j0 + c;
  const bool col_ok = j < N;
  const int i0 = q * Q;

  for (int i = tid; i < NP; i += kThreads) sU[pad(i)] = i < N ? u[h * N + i] : 0.f;

  float s[Q];
  const int64_t st_base = (b * H + h) * (int64_t)N * N;
#pragma unroll
  for (int m = 0; m < Q; ++m) {
    const int i = i0 + m;
    s[m] = (s0 != nullptr && col_ok && i < N) ? s0[st_base + i * N + j] : 0.f;
  }

  for (int64_t t0 = 0; t0 < Tn; t0 += kT) {
    const int nt = (int)(Tn - t0 < kT ? Tn - t0 : kT);
    __syncthreads();  // the previous chunk's shared memory is consumed
    for (int idx = tid; idx < kT * NP; idx += kThreads) {
      const int t = idx / NP, i = idx - t * NP;
      float rv = 0.f, kv = 0.f, wv = 1.f;
      if (t < nt && i < N) {
        const int64_t g = ((b * Tn + t0 + t) * H + h) * N + i;
        rv = r[g];
        kv = k[g];
        wv = w[g];
      }
      sR[t * LD + pad(i)] = rv;
      sK[t * LD + pad(i)] = kv;
      sW[t * LD + pad(i)] = wv;
    }
    for (int idx = tid; idx < kT * kCols; idx += kThreads) {
      const int t = idx / kCols, cc = idx - t * kCols;
      sV[idx] = (t < nt && j0 + cc < N)
                    ? v[((b * Tn + t0 + t) * H + h) * N + j0 + cc]
                    : 0.f;
    }
    __syncthreads();
    {  // bonus_t = r_t . (u * k_t): the 4 threads of group c take token c
      float part = 0.f;
#pragma unroll
      for (int m = 0; m < Q; ++m) {
        const int pi = pad(i0 + m);
        part += sR[c * LD + pi] * sU[pi] * sK[c * LD + pi];
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      if (q == 0) sA[c] = part;
    }
    __syncthreads();

    for (int t = 0; t < nt; ++t) {
      const float vj = sV[t * kCols + c];
      const float4* r4 = reinterpret_cast<const float4*>(sR + t * LD + pad(i0));
      const float4* k4 = reinterpret_cast<const float4*>(sK + t * LD + pad(i0));
      const float4* w4 = reinterpret_cast<const float4*>(sW + t * LD + pad(i0));
      float acc[2] = {0.f, 0.f};
#pragma unroll
      for (int m4 = 0; m4 < Q / 4; ++m4) {
        const float4 rr = r4[m4], kk = k4[m4], ww = w4[m4];
        const float rq[4] = {rr.x, rr.y, rr.z, rr.w};
        const float kq[4] = {kk.x, kk.y, kk.z, kk.w};
        const float wq[4] = {ww.x, ww.y, ww.z, ww.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = 4 * m4 + e;
          acc[e & 1] = fmaf(rq[e], s[m], acc[e & 1]);
          s[m] = fmaf(s[m], wq[e], kq[e] * vj);
        }
      }
      float part = acc[0] + acc[1];
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      if (q == 0 && col_ok)
        y[((b * Tn + t0 + t) * H + h) * N + j] = fmaf(sA[t], vj, part);
    }
  }

  if (col_ok) {
#pragma unroll
    for (int m = 0; m < Q; ++m)
      if (i0 + m < N) sout[st_base + (i0 + m) * N + j] = s[m];
  }
}

template <int NP>
int launch_simt_n(const void* r, const void* k, const void* v, const void* w,
                  const void* u, const void* s0, void* y, void* sout, int64_t B,
                  int64_t Tn, int64_t H, int64_t N, void* stream) {
  const dim3 grid((unsigned)((N + kCols - 1) / kCols), (unsigned)H,
                  (unsigned)B);
  wkv6_simt_kernel<NP><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(sout), Tn, (int)H, (int)N);
  return (int)cudaGetLastError();
}

int launch_simt(const void* r, const void* k, const void* v, const void* w,
                const void* u, const void* s0, void* y, void* sout, int64_t B,
                int64_t Tn, int64_t H, int64_t N, void* stream) {
  if (N < 1 || N > kMaxN) return (int)cudaErrorInvalidValue;
  if (N <= 16) return launch_simt_n<16>(r, k, v, w, u, s0, y, sout, B, Tn, H, N, stream);
  if (N <= 32) return launch_simt_n<32>(r, k, v, w, u, s0, y, sout, B, Tn, H, N, stream);
  return launch_simt_n<kMaxN>(r, k, v, w, u, s0, y, sout, B, Tn, H, N, stream);
}

// ---------------------------------------------------------------------------
// bf16: wkv6_tc_kernel
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kQ = 64;                 // tokens per chunk
constexpr int kSub = 16;               // tokens per sub-chunk
constexpr int kSubs = kQ / kSub;
constexpr int kWarps = 2 * kSubs;      // two a sub-chunk
constexpr int kThreads = 32 * kWarps;
constexpr float kFloor = 1e-12f;       // the Pallas kernel's floor on w
constexpr unsigned kFull = 0xffffffffu;

// Shared-memory layout for a padded head size kN: r, k [kQ][kN + 16]
// bf16, w [kQ][kN + 16] f32, two stages of v [kQ][kN + 8] bf16, Rd and Kd
// [kQ][kN + 8] f32, two state buffers of {hi, lo} [kN][kN + 8] bf16, att
// [kQ][kQ + 8] f32, then per key channel T, E, F [4][kN], D [3][kN],
// T_0 .. T_3 and u [kN] f32, and the loads' mbarrier.  The strides keep
// the diagonal blocks' loads of r, k, w (4 rows, 8 lanes a row), the
// fragment loads of f32 rows (8 mod 32 words) and ldmatrix (16-byte
// multiples) free of bank conflicts; a TMA box row is a stride wide.
template <int kN>
struct Layout {
  static constexpr int kRs = kN + 16;  // bf16 row stride of r and k
  static constexpr int kWs = kN + 16;  // f32 row stride of w
  static constexpr int kVs = kN + 8;   // bf16 row stride of v and the state
  static constexpr int kFs = kN + 8;  // f32 row stride of Rd and Kd
  static constexpr int kAs = kQ + 8;  // f32 row stride of att
  static constexpr int kR = 0;
  static constexpr int kK = kR + kQ * kRs * 2;
  static constexpr int kW = kK + kQ * kRs * 2;
  static constexpr int kV = kW + kQ * kWs * 4;
  static constexpr int kVStage = kQ * kVs * 2;
  static constexpr int kRd = kV + 2 * kVStage;
  static constexpr int kKd = kRd + kQ * kFs * 4;
  static constexpr int kSt = kKd + kQ * kFs * 4;
  static constexpr int kStBuf = kN * kVs * 2;  // one of hi or lo
  static constexpr int kAtt = kSt + 4 * kStBuf;
  static constexpr int kT = kAtt + kQ * kAs * 4;
  static constexpr int kE = kT + kSubs * kN * 4;
  static constexpr int kF = kE + kSubs * kN * 4;
  static constexpr int kD = kF + kSubs * kN * 4;
  static constexpr int kFall = kD + 3 * kN * 4;
  static constexpr int kU = kFall + kN * 4;
  static constexpr int kBar = kU + kN * 4;
  static constexpr int kBytes = kBar + 16;
  static constexpr uint32_t kTmaBytes = kQ * (2 * kRs * 2 + kVs * 2 + kWs * 4);  // a chunk's boxes
  static_assert(kK % 128 == 0 && kW % 128 == 0 && kV % 128 == 0 && kVStage % 128 == 0,
                "the TMA's 128-byte alignment");
  static_assert(kRd % 16 == 0 && kStBuf % 16 == 0 && kAtt % 16 == 0 && kBar % 16 == 0,
                "16-byte alignment");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

constexpr long long kHangCycles = 8000000000LL;  // ~4 s: a load that never lands

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
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

// wait until the phase of parity `parity` has completed; trap if it never
// does, so a fault ends the launch with an error instead of hanging
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

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// d += a b: a 16x16 (row-major fragment), b 16x8 (column-major), d 16x8 f32
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as a bf16 pair, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float v0, float v1) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float bf16_low(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_high(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}
__device__ __forceinline__ float bf16_f32(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}
__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// (v0, v1) as hi + lo, each a bf16 pair: hi rounds v, lo rounds v - hi
__device__ __forceinline__ void split(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(v0, v1);
  lo = pack_bf16(v0 - bf16_low(hi), v1 - bf16_high(hi));
}

// kN: the head size padded to 16, 32, 48 or 64; kTma: loads by the
// Tensor Memory Accelerator through tm_r, tm_k, tm_v, tm_w (N a multiple
// of 8, 16-byte-aligned r, k, v, w), else element-wise loads.
template <int kN, bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
    wkv6_tc_kernel(const __grid_constant__ CUtensorMap tm_r,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_w, const uint16_t* __restrict__ r,
                   const uint16_t* __restrict__ k, const uint16_t* __restrict__ v,
                   const float* __restrict__ w, const float* __restrict__ u,
                   const float* __restrict__ s0, uint16_t* __restrict__ y,
                   float* __restrict__ sout, int64_t Tn, int H, int N) {
  using L = Layout<kN>;
  constexpr int kKS = kN / 16;   // k-steps over the key channels
  constexpr int kTW = kN / 16;   // n8 tiles of a warp's half of the value columns
  constexpr int kCq = kN / 8;    // key channels of a lane in the diagonal blocks
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c4 = lane & 3;
  // ldmatrix row/column offsets of this lane for tiles stored [k][n]
  const int lr = lane & 7, lhi = lane >> 4, lmid = (lane >> 3) & 1;
  const int h = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int a = warp >> 1;               // this warp's sub-chunk: its rows of y and of S
  const int cb = (warp & 1) * (kN / 2);  // its half of the value columns

  uint16_t* sR = reinterpret_cast<uint16_t*>(smem + L::kR);
  uint16_t* sK = reinterpret_cast<uint16_t*>(smem + L::kK);
  float* sW = reinterpret_cast<float*>(smem + L::kW);
  float* sRd = reinterpret_cast<float*>(smem + L::kRd);
  float* sKd = reinterpret_cast<float*>(smem + L::kKd);
  float* sAtt = reinterpret_cast<float*>(smem + L::kAtt);
  float* sT = reinterpret_cast<float*>(smem + L::kT);
  float* sE = reinterpret_cast<float*>(smem + L::kE);
  float* sF = reinterpret_cast<float*>(smem + L::kF);
  float* sD = reinterpret_cast<float*>(smem + L::kD);
  float* sFall = reinterpret_cast<float*>(smem + L::kFall);
  float* sU = reinterpret_cast<float*>(smem + L::kU);
  const uint32_t bar = smem_u32(smem + L::kBar);
  auto sV = [&](int s) { return reinterpret_cast<uint16_t*>(smem + L::kV + s * L::kVStage); };
  auto sSt = [&](int buf, int part) {
    return reinterpret_cast<uint16_t*>(smem + L::kSt + (2 * buf + part) * L::kStBuf);
  };

  // zero everything once: att above the diagonal and the padded channels
  // are never written
  for (int i = tid; i < L::kBar / 16; i += kThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // zeros before copies
  __syncthreads();
  for (int i = tid; i < kN; i += kThreads) sU[i] = i < N ? u[h * N + i] : 0.f;

  // chunk t0.. into r, k, w and v stage s, rows past T and channels past
  // N zeros: by the TMA, one box [kQ rows, a padded row] an array (the
  // box is wider than N, and its columns past N are filled with zeros,
  // as are its rows past T), else element-wise
  auto load_chunk = [&](int64_t t0, int s) {
    uint16_t* dV = sV(s);
    if constexpr (kTma) {
      if (tid == 0) {
        mbar_expect_tx(bar, L::kTmaBytes);
        const int tt = (int)t0, bb = (int)b;
        tma_load(smem_u32(sR), &tm_r, bar, 0, h, tt, bb);
        tma_load(smem_u32(sK), &tm_k, bar, 0, h, tt, bb);
        tma_load(smem_u32(dV), &tm_v, bar, 0, h, tt, bb);
        tma_load(smem_u32(sW), &tm_w, bar, 0, h, tt, bb);
      }
    } else {
      const int nt = (int)(Tn - t0 < kQ ? Tn - t0 : kQ);
      const int64_t row0 = (b * Tn + t0) * H + h;  // the (token t0, head h) row
      for (int i = tid; i < kQ * kN; i += kThreads) {
        const int t = i / kN, c = i % kN;
        const bool ok = t < nt && c < N;
        const int64_t gi = (row0 + (int64_t)t * H) * N + c;
        sR[t * L::kRs + c] = ok ? r[gi] : 0;
        sK[t * L::kRs + c] = ok ? k[gi] : 0;
        dV[t * L::kVs + c] = ok ? v[gi] : 0;
        sW[t * L::kWs + c] = ok ? w[gi] : 0.f;
      }
    }
  };

  // this warp's rows of the state, key channels 16 a.. (where kN has
  // them), and its half of the columns, in the accumulator layout (n8
  // tile nt, element e: row g + 8 (e / 2), column cb + 8 nt + 2 c4 + e % 2)
  const bool owns = 16 * a < kN;
  const int i0r = 16 * a + g, i1r = i0r + 8;
  float st[kTW][4];
#pragma unroll
  for (int nt = 0; nt < kTW; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e < 2 ? i0r : i1r, j = cb + 8 * nt + 2 * c4 + (e & 1);
      st[nt][e] = (owns && s0 != nullptr && i < N && j < N)
                      ? s0[((b * H + h) * N + i) * (int64_t)N + j]
                      : 0.f;
    }

  auto write_state = [&](int buf) {
    if (!owns) return;
    uint16_t* hi = sSt(buf, 0);
    uint16_t* lo = sSt(buf, 1);
#pragma unroll
    for (int nt = 0; nt < kTW; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int idx = (hf ? i1r : i0r) * L::kVs + cb + 8 * nt + 2 * c4;
        uint32_t vh, vl;
        split(st[nt][2 * hf], st[nt][2 * hf + 1], vh, vl);
        *reinterpret_cast<uint32_t*>(hi + idx) = vh;
        *reinterpret_cast<uint32_t*>(lo + idx) = vl;
      }
  };

  // A fragment (16 x 16; rows row0.., columns col0..) of the f32 matrix m,
  // each column i scaled by sc[i] (none: 1), as hi + lo
  auto frag = [&](const float* m, int ld, int row0, int col0, const float* sc,
                  uint32_t(&fh)[4], uint32_t(&fl)[4]) {
    const int c = col0 + 2 * c4, q0 = row0 + g, q1 = q0 + 8;
    float2 x0 = *reinterpret_cast<const float2*>(m + q0 * ld + c);
    float2 x1 = *reinterpret_cast<const float2*>(m + q1 * ld + c);
    float2 x2 = *reinterpret_cast<const float2*>(m + q0 * ld + c + 8);
    float2 x3 = *reinterpret_cast<const float2*>(m + q1 * ld + c + 8);
    if (sc != nullptr) {
      const float2 f0 = *reinterpret_cast<const float2*>(sc + c);
      const float2 f8 = *reinterpret_cast<const float2*>(sc + c + 8);
      x0.x *= f0.x, x0.y *= f0.y, x1.x *= f0.x, x1.y *= f0.y;
      x2.x *= f8.x, x2.y *= f8.y, x3.x *= f8.x, x3.y *= f8.y;
    }
    split(x0.x, x0.y, fh[0], fl[0]);
    split(x1.x, x1.y, fh[1], fl[1]);
    split(x2.x, x2.y, fh[2], fl[2]);
    split(x3.x, x3.y, fh[3], fl[3]);
  };

  // acc[nt] += A B over this warp's n8 tiles, B = the bf16 tile stored
  // [k][n] at rows k0.. and columns cb + 8 nt of m (row stride ld)
  auto mma_b = [&](float(&acc)[kTW][4], const uint32_t(&fa)[4], const uint16_t* m, int ld,
                   int k0) {
#pragma unroll
    for (int nt = 0; nt < kTW; nt += 2) {
      const uint16_t* p = m + (k0 + lr + 8 * lmid) * ld + cb + 8 * nt;
      if (nt + 1 < kTW) {
        uint32_t bb[4];
        ldsm_x4_t(bb, smem_u32(p + 8 * lhi));
        mma(acc[nt], fa, bb[0], bb[1]);
        mma(acc[nt + 1], fa, bb[2], bb[3]);
      } else {
        uint32_t bb[2];
        ldsm_x2_t(bb, smem_u32(p));
        mma(acc[nt], fa, bb[0], bb[1]);
      }
    }
  };

  // S = diag(T_0 .. T_3) S + (Kd F)^T v over the chunk's sub-chunks kk,
  // F_kk = T_kk+1 .. T_3; Kd F split, v exact
  auto update_state = [&](const uint16_t* vS) {
    if (!owns) return;
    const float f0 = sFall[i0r], f1 = sFall[i1r];
#pragma unroll
    for (int nt = 0; nt < kTW; ++nt) {
      st[nt][0] *= f0;
      st[nt][1] *= f0;
      st[nt][2] *= f1;
      st[nt][3] *= f1;
    }
#pragma unroll
    for (int kk = 0; kk < kSubs; ++kk) {
      const float fa = sF[kk * kN + i0r], fb = sF[kk * kN + i1r];
      const float* k0 = sKd + (kSub * kk + 2 * c4) * L::kFs;  // key rows s0, s0 + 1
      const float* k8 = k0 + 8 * L::kFs;                       // s0 + 8, s0 + 9
      uint32_t ah[4], al[4];
      split(k0[i0r] * fa, k0[L::kFs + i0r] * fa, ah[0], al[0]);
      split(k0[i1r] * fb, k0[L::kFs + i1r] * fb, ah[1], al[1]);
      split(k8[i0r] * fa, k8[L::kFs + i0r] * fa, ah[2], al[2]);
      split(k8[i1r] * fb, k8[L::kFs + i1r] * fb, ah[3], al[3]);
      mma_b(st, ah, vS, L::kVs, kSub * kk);
      mma_b(st, al, vS, L::kVs, kSub * kk);
    }
  };

  const int64_t nchunks = (Tn + kQ - 1) / kQ;
  if (nchunks > 0) load_chunk(0, 0);
  write_state(0);

  for (int64_t z = 0; z < nchunks; ++z) {
    const int s = (int)(z & 1);
    const int64_t t0 = z * kQ;
    const int nt = (int)(Tn - t0 < kQ ? Tn - t0 : kQ);
    const uint16_t* vS = sV(s);
    if constexpr (kTma) mbar_wait(bar, (uint32_t)(z & 1));
    __syncthreads();  // chunk z and the state entering it have landed

    // 1. per (pair of key channels i, i + 1, sub-chunk c, direction):
    // the decays within the sub-chunk as products of w' = max(w, floor)
    // (1 past T and in the padding): forward Rd = r prod(w' before t) and
    // T = prod(w'), backward Kd = k prod(w' after s), both 0 past T
    if (tid < kSubs * kN) {
      const int i = 2 * (tid % (kN / 2)), c = (tid / (kN / 2)) % kSubs;
      const bool fwd = tid < kSubs * kN / 2;
      const uint16_t* src = fwd ? sR : sK;
      float* dst = fwd ? sRd : sKd;
      float2 wf[kSub];
#pragma unroll
      for (int tau = 0; tau < kSub; ++tau) {
        const int t = kSub * c + tau;
        const float2 wv = *reinterpret_cast<const float2*>(sW + t * L::kWs + i);
        wf[tau].x = (t < nt && i < N) ? fmaxf(wv.x, kFloor) : 1.f;
        wf[tau].y = (t < nt && i + 1 < N) ? fmaxf(wv.y, kFloor) : 1.f;
      }
      float2 p = make_float2(1.f, 1.f);
      auto step = [&](int tau) {  // tau a constant after unrolling: wf stays in registers
        const int t = kSub * c + tau;
        const uint32_t x = *reinterpret_cast<const uint32_t*>(src + t * L::kRs + i);
        *reinterpret_cast<float2*>(dst + t * L::kFs + i) =
            t < nt ? make_float2(bf16_low(x) * p.x, bf16_high(x) * p.y) : make_float2(0.f, 0.f);
        p.x *= wf[tau].x;
        p.y *= wf[tau].y;
      };
      if (fwd) {
#pragma unroll
        for (int tau = 0; tau < kSub; ++tau) step(tau);
        *reinterpret_cast<float2*>(sT + c * kN + i) = p;
      } else {
#pragma unroll
        for (int tau = kSub - 1; tau >= 0; --tau) step(tau);
      }
    }

    // 2. the diagonal block of sub-chunk a, exactly in f32: lane (p, q)
    // of the warp pair takes tokens p and 15 - p of it (15 pairs s < t
    // between them) over the key channels 2 q + 16 m (+ 1); att[t, s] =
    // sum_i r_t k_s prod_{s < sigma < t} w'_sigma, a running product over
    // s descending, and att[t, t] = sum_i r_t u k_t; the 17 sums are
    // joined across the 8 lanes of a token pair at the end
    {
      const int p = 4 * (warp & 1) + (lane >> 3), q = lane & 7;
      const int base = kSub * a, tA = base + p, tB = base + kSub - 1 - p;
      float part[kSub + 1];  // pairs 0..14, then the bonuses of tA and tB
      float2 rd[kCq / 2];    // r_t prod(w' between), for channels 2 q + 16 m (+ 1)
      part[kSub - 1] = part[kSub] = 0.f;
#pragma unroll
      for (int m = 0; m < kCq / 2; ++m) {
        const int i = 2 * q + 16 * m;
        const float2 uu = *reinterpret_cast<const float2*>(sU + i);
        const uint32_t ra = *reinterpret_cast<const uint32_t*>(sR + tA * L::kRs + i);
        const uint32_t ka = *reinterpret_cast<const uint32_t*>(sK + tA * L::kRs + i);
        const uint32_t rb = *reinterpret_cast<const uint32_t*>(sR + tB * L::kRs + i);
        const uint32_t kb = *reinterpret_cast<const uint32_t*>(sK + tB * L::kRs + i);
        part[kSub - 1] += bf16_low(ra) * uu.x * bf16_low(ka) + bf16_high(ra) * uu.y * bf16_high(ka);
        part[kSub] += bf16_low(rb) * uu.x * bf16_low(kb) + bf16_high(rb) * uu.y * bf16_high(kb);
        rd[m] = make_float2(bf16_low(ra), bf16_high(ra));
      }
#pragma unroll
      for (int it = 0; it < kSub - 1; ++it) {
        if (it == p) {  // tA's pairs are done: tB's
#pragma unroll
          for (int m = 0; m < kCq / 2; ++m) {
            const uint32_t rb =
                *reinterpret_cast<const uint32_t*>(sR + tB * L::kRs + 2 * q + 16 * m);
            rd[m] = make_float2(bf16_low(rb), bf16_high(rb));
          }
        }
        const int sg = it < p ? tA - 1 - it : tB - 1 - (it - p);
        float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
        for (int m = 0; m < kCq / 2; ++m) {
          const int i = 2 * q + 16 * m;
          const uint32_t kq = *reinterpret_cast<const uint32_t*>(sK + sg * L::kRs + i);
          const float2 wq = *reinterpret_cast<const float2*>(sW + sg * L::kWs + i);
          acc0 = fmaf(rd[m].x, bf16_low(kq), acc0);
          acc1 = fmaf(rd[m].y, bf16_high(kq), acc1);
          rd[m].x *= fmaxf(wq.x, kFloor);
          rd[m].y *= fmaxf(wq.y, kFloor);
        }
        part[it] = acc0 + acc1;
      }
#pragma unroll
      for (int m = 1; m < 8; m <<= 1)
#pragma unroll
        for (int j = 0; j <= kSub; ++j) part[j] += __shfl_xor_sync(kFull, part[j], m);
      if (q == 0) {
#pragma unroll
        for (int it = 0; it < kSub - 1; ++it) {
          const int t = it < p ? tA : tB;
          sAtt[t * L::kAs + (it < p ? tA - 1 - it : tB - 1 - (it - p))] = part[it];
        }
        sAtt[tA * L::kAs + tA] = part[kSub - 1];
        sAtt[tB * L::kAs + tB] = part[kSub];
      }
    }
    __syncthreads();  // T, Rd, Kd and the diagonal blocks are written; r, k, w are read

    // the next chunk's loads, overlapping the rest of this one
    if (z + 1 < nchunks) load_chunk((z + 1) * kQ, s ^ 1);

    // 3. per (key channel i, sub-chunk c): the decays between sub-chunks
    if (tid < kSubs * kN) {
      const int i = tid % kN, c = tid / kN;
      float tt[kSubs];
#pragma unroll
      for (int cc = 0; cc < kSubs; ++cc) tt[cc] = sT[cc * kN + i];
      float before = 1.f, after = 1.f;
#pragma unroll
      for (int cc = 0; cc < kSubs; ++cc) {
        if (cc < c) before *= tt[cc];
        if (cc > c) after *= tt[cc];
      }
      sE[c * kN + i] = before;  // E_c: r_t's decay from the chunk's start
      sF[c * kN + i] = after;   // F_c: k_s's decay to the chunk's end
      if (c == 0) sFall[i] = tt[0] * tt[1] * tt[2] * tt[3];
      if (c == 2) sD[0 * kN + i] = tt[1];  // D_20
      if (c == 3) {
        sD[1 * kN + i] = tt[1] * tt[2];  // D_30
        sD[2 * kN + i] = tt[2];          // D_31
      }
    }
    __syncthreads();

    // 4. warps 0-5: the att blocks (a', b'), b' < a', one each, as (Rd
    // D) Kd^T, both split, into att; warps 6 and 7 (sub-chunk 3, the
    // most y work) update their rows of the state
    if (warp < 6) {
      const int ab = warp < 1 ? 1 : warp < 3 ? 2 : 3;  // (1,0) (2,0) (2,1) (3,0) (3,1) (3,2)
      const int bb = warp - (ab * (ab - 1)) / 2;
      const float* sc = bb + 1 == ab ? nullptr : sD + (ab == 2 ? 0 : 1 + bb) * kN;
      float acc[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
        uint32_t ah[4], al[4];
        frag(sRd, L::kFs, kSub * ab, 16 * kk, sc, ah, al);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {  // n8 tile: keys s = 16 bb + 8 hf + g
          const float* kr = sKd + (kSub * bb + 8 * hf + g) * L::kFs + 16 * kk + 2 * c4;
          const float2 k0 = *reinterpret_cast<const float2*>(kr);
          const float2 k1 = *reinterpret_cast<const float2*>(kr + 8);
          uint32_t bh0, bl0, bh1, bl1;
          split(k0.x, k0.y, bh0, bl0);
          split(k1.x, k1.y, bh1, bl1);
          mma(acc[hf], ah, bh0, bh1);
          mma(acc[hf], ah, bl0, bl1);
          mma(acc[hf], al, bh0, bh1);
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float* dst = sAtt + (kSub * ab + g) * L::kAs + kSub * bb + 8 * hf + 2 * c4;
        *reinterpret_cast<float2*>(dst) = make_float2(acc[hf][0], acc[hf][1]);
        *reinterpret_cast<float2*>(dst + 8 * L::kAs) = make_float2(acc[hf][2], acc[hf][3]);
      }
    } else {
      update_state(vS);
    }
    __syncthreads();  // att is whole

    // 5. y for the tokens of sub-chunk a, this warp's half of the
    // columns: (Rd E_a) S, both split, plus att v, att split and v exact
    float yacc[kTW][4];
#pragma unroll
    for (int nt2 = 0; nt2 < kTW; ++nt2)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[nt2][e] = 0.f;
    {
      const uint16_t* hiS = sSt(s, 0);
      const uint16_t* loS = sSt(s, 1);
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
        uint32_t ah[4], al[4];
        frag(sRd, L::kFs, kSub * a, 16 * kk, a == 0 ? nullptr : sE + a * kN, ah, al);
        mma_b(yacc, ah, hiS, L::kVs, 16 * kk);
        mma_b(yacc, ah, loS, L::kVs, 16 * kk);
        mma_b(yacc, al, hiS, L::kVs, 16 * kk);
      }
    }
#pragma unroll
    for (int bb = 0; bb < kSubs; ++bb) {
      if (bb > a) break;
      uint32_t ph[4], pl[4];
      frag(sAtt, L::kAs, kSub * a, kSub * bb, nullptr, ph, pl);
      mma_b(yacc, ph, vS, L::kVs, kSub * bb);
      mma_b(yacc, pl, vS, L::kVs, kSub * bb);
    }
    // y rows 16 a + g (+ 8) of the chunk, columns cb + 8 nt + 2 c4 (+ 1)
#pragma unroll
    for (int nt2 = 0; nt2 < kTW; ++nt2)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int t = kSub * a + g + 8 * hf, j = cb + 8 * nt2 + 2 * c4;
        if (t >= nt) continue;
        uint16_t* dst = y + ((b * Tn + t0 + t) * H + h) * (int64_t)N + j;
        const float v0 = yacc[nt2][2 * hf], v1 = yacc[nt2][2 * hf + 1];
        if ((N & 1) == 0 && j + 1 < N) {
          *reinterpret_cast<uint32_t*>(dst) = pack_bf16(v0, v1);
        } else {
          if (j < N) dst[0] = bf16_bits(v0);
          if (j + 1 < N) dst[1] = bf16_bits(v1);
        }
      }

    if (warp < 6) update_state(vS);
    write_state(s ^ 1);
  }

  if (owns) {
#pragma unroll
    for (int nt2 = 0; nt2 < kTW; ++nt2)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e < 2 ? i0r : i1r, j = cb + 8 * nt2 + 2 * c4 + (e & 1);
        if (i < N && j < N) sout[((b * H + h) * N + i) * (int64_t)N + j] = st[nt2][e];
      }
  }
}

constexpr int kErrTensorMap = -1000;  // minus the CUresult of cuTensorMapEncodeTiled

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once through the runtime's
// entry-point query (nullptr if absent), so the library links nothing
// beyond the CUDA runtime
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

// a 4-D map over [B, T, H, N] (N innermost) with boxes of box_cols x 1 x
// kQ x 1, no swizzle, zeros outside the tensor
int encode(CUtensorMap* map, const void* ptr, bool f32, int64_t B, int64_t Tn, int64_t H,
           int64_t N, int box_cols) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kErrTensorMap - (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t es = f32 ? 4 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)N, (cuuint64_t)H, (cuuint64_t)Tn, (cuuint64_t)B};
  const cuuint64_t strides[3] = {N * es, H * N * es, Tn * H * N * es};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, 1, (cuuint32_t)kQ, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult rc = fn(map,
                         f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                         4, const_cast<void*>(ptr), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : kErrTensorMap - (int)rc;
}

template <int kN, bool kTma>
int launch_n(const void* r, const void* k, const void* v, const void* w, const void* u,
             const void* s0, void* y, void* sout, int64_t B, int64_t Tn, int64_t H,
             int64_t N, void* stream) {
  using L = Layout<kN>;
  constexpr int smem = L::kBytes;
  cudaError_t err = cudaFuncSetAttribute(wkv6_tc_kernel<kN, kTma>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tm_r{}, tm_k{}, tm_v{}, tm_w{};
  if (kTma) {
    int rc = encode(&tm_r, r, false, B, Tn, H, N, L::kRs);
    if (rc == 0) rc = encode(&tm_k, k, false, B, Tn, H, N, L::kRs);
    if (rc == 0) rc = encode(&tm_v, v, false, B, Tn, H, N, L::kVs);
    if (rc == 0) rc = encode(&tm_w, w, true, B, Tn, H, N, L::kWs);
    if (rc != 0) return rc;
  }
  const dim3 grid((unsigned)H, (unsigned)B);
  wkv6_tc_kernel<kN, kTma><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      tm_r, tm_k, tm_v, tm_w, static_cast<const uint16_t*>(r),
      static_cast<const uint16_t*>(k), static_cast<const uint16_t*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(s0), static_cast<uint16_t*>(y), static_cast<float*>(sout), Tn,
      (int)H, (int)N);
  return (int)cudaGetLastError();
}

template <bool kTma>
int launch_tc(const void* r, const void* k, const void* v, const void* w, const void* u,
              const void* s0, void* y, void* sout, int64_t B, int64_t Tn, int64_t H,
              int64_t N, void* stream) {
  if (N <= 16) return launch_n<16, kTma>(r, k, v, w, u, s0, y, sout, B, Tn, H, N, stream);
  if (N <= 32) return launch_n<32, kTma>(r, k, v, w, u, s0, y, sout, B, Tn, H, N, stream);
  if (N <= 48) return launch_n<48, kTma>(r, k, v, w, u, s0, y, sout, B, Tn, H, N, stream);
  return launch_n<64, kTma>(r, k, v, w, u, s0, y, sout, B, Tn, H, N, stream);
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

// 0, a cudaError_t, or kErrTensorMap minus cuTensorMapEncodeTiled's CUresult
int launch(const void* r, const void* k, const void* v, const void* w, const void* u,
           const void* s0, void* y, void* sout, int64_t B, int64_t Tn, int64_t H,
           int64_t N, void* stream) {
  if (N < 1 || N > kMaxN || Tn > INT32_MAX) return (int)cudaErrorInvalidValue;  // TMA coordinates
  const bool tma = N % 8 == 0 && aligned16(r) && aligned16(k) && aligned16(v) && aligned16(w);
  if (tma) return launch_tc<true>(r, k, v, w, u, s0, y, sout, B, Tn, H, N, stream);
  return launch_tc<false>(r, k, v, w, u, s0, y, sout, B, Tn, H, N, stream);
}

}  // namespace tc

}  // namespace

extern "C" {

int wkv6_max_head() { return kMaxN; }

int wkv6_tc_chunk() { return tc::kQ; }

int wkv6_f32(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* s0, void* y, void* sout, int64_t B,
             int64_t Tn, int64_t H, int64_t N, void* stream) {
  return launch_simt(r, k, v, w, u, s0, y, sout, B, Tn, H, N, stream);
}

int wkv6_bf16(const void* r, const void* k, const void* v, const void* w,
              const void* u, const void* s0, void* y, void* sout, int64_t B,
              int64_t Tn, int64_t H, int64_t N, void* stream) {
  return tc::launch(r, k, v, w, u, s0, y, sout, B, Tn, H, N, stream);
}

}  // extern "C"

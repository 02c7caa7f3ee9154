// Hand-written Hopper (sm_90a) Mamba2 SSD scan: the selective state-space
// recurrence of one group (B and C shared by all heads).  Two kernels,
// chosen by dtype in ../ops.py: bf16 runs the chunked dual form on the
// tensor cores (ssd_scan_tc_kernel), f32 walks the tokens one by one on
// the FP32 FMA units (ssd_scan_simt_kernel).
//
// Built by nvcc into a shared library with a plain C interface and bound
// with ctypes (repro_torch/kernels/build.py); the Python wrapper and the
// plain PyTorch version are in ../ops.py.  Each entry point launches on
// the stream it is given, allocates nothing, and returns
// cudaGetLastError() so a refused launch is reported.
//
// Replaces the Pallas kernel ssd_scan_kernel
// (repro/kernels/mamba2_scan/kernel.py:94, body _ssd_kernel, wrapper
// ops.py::ssd_scan, oracle ref.py::ssd_scan_ref).  Inputs x [b, s, h, p],
// dt [b, s, h] (f32, > 0), A [h] (f32, < 0), B and C [b, s, n], an
// optional initial state s0 [b, h, p, n] (f32; null means zeros).  x, B
// and C are all f32 or all bf16 (the model passes its bf16 activations
// with an f32 dt).  Per (b, h), for every token t in order:
//   state = exp(dt_t A) state + (dt_t x_t) B_t^T     ([p, n], f32)
//   y_t   = state C_t                                ([p])
// y is written in x's dtype, the final state in f32.  Both kernels
// compute this function; they differ from it, and from each other, only
// by float rounding.
//
// Bound: bytes.  Each input is read once and y written once (350.2 MB at
// zamba2's path shape, x [2, 8192, 80, 64], n 64, bf16 x/B/C and y, f32
// dt/A/state: 0.1045 ms at 3.35 TB/s).  The recurrence itself is 4 flops
// per state entry per token (21.5 GFLOP there); the chunked dual form
// below does about 3.3x that on the tensor cores (the [Q, Q] products
// inside a chunk, S for each of two p slices, and each computed factor
// taken as two bf16 halves): ~70 GFLOP at Q = 64, 0.07 ms at 989
// TFLOP/s, under the byte bound.
//
// ---------------------------------------------------------------------------
// bf16: ssd_scan_tc_kernel (the chunked dual form on mma.sync)
// ---------------------------------------------------------------------------
//
// What held the first design back (it ran bf16 through the FMA kernel
// below): 8192 tokens walked one at a time in each CTA, each a chain of
// E dependent FMAs and a 3-step shuffle reduction; chunks staged through
// shared memory by synchronous loads the SMs waited for; no tensor cores.
// It took 3.6 ms a launch at the path shape, 34x the bound.
//
// This design follows the Pallas kernel's function (Dao & Gu 2024's
// chunked dual form), with the recurrence run once per chunk of kQ = 64
// tokens.  Per (b, h, slice of kPt = 32 state rows) and chunk, with
// cum = cumsum(dt A) over the chunk:
//   S     = C B^T                                     [Q, Q], K = n
//   P     = (t >= l) exp(cum_t - cum_l) dt_l S        (dt folded into P)
//   y     = P x + exp(cum_t) (C state^T)              [Q, p]
//   state = exp(cum_Q) state + (x w)^T B,  w_l = exp(cum_Q - cum_l) dt_l
// so x, B and C enter every product exactly as given (bf16 operands).
//  - All four products on mma.sync.m16n8k16 bf16 -> f32: the kernel is
//    bound by bytes, not operations, so wgmma's rate is not needed.
//    Operands come from shared memory by ldmatrix (.trans where the
//    product's K is the token axis); P is built in registers from S's
//    accumulators, whose layout is the A-operand layout of P x.
//  - Precision: P, the state (for C state^T) and x w are computed in
//    f32 and each is split into bf16 halves hi + lo (lo = the rounding
//    error of hi), two products accumulated in f32.  Rounding each once
//    to bf16 would put the final state ~1e-2 off the f32 recurrence at
//    the path's draw, over the 2e-3 tolerance (tests/test_torch_mamba2.py
//    emulates both schemes); the split leaves ~1e-4.
//  - Asynchronous loads: the next chunk's C, B [Q, n], x [Q, kPt] and dt
//    [Q] go into a two-stage shared-memory ring by cp.async while this
//    chunk computes; one __syncthreads per chunk.  They start after
//    P x, not right after the barrier: the chunk's first half is the
//    heaviest on shared memory (ldmatrix of C, B, the state), and loads
//    started there slowed it.  y leaves through shared memory, 16 bytes a
//    lane.  Both were faster at the path shape than the plain order.
//    Rows past s (a ragged last chunk) and columns past p are
//    zero-filled (cp.async's src-size 0): a zero dt makes the tail
//    exact, nothing is padded in memory.  cp.async takes 16-byte pieces,
//    so this needs n and p
//    multiples of 8 and 16-byte-aligned x, B, C and y; other shapes (n 1,
//    p 20, ...) run the same kernel with element-wise loads into the
//    ring (kAsync false).
//  - Enough CTAs: state rows evolve independently, so the grid is
//    (p / kPt, h, b): 320 CTAs at the path shape, all resident at once
//    (3 a SM by shared memory).  Each recomputes S for its slice
//    (2 Q^2 n flop a chunk); B and C (2 MB a batch row) stay in L2
//    across the 80 heads that read them.
//  - 4 warps; warp i owns query rows 16i..16i+15 of S, P and y, and
//    skips the tiles above the diagonal (S and P x for l > 16i + 15);
//    for the state update it owns a [16 p, n/2] quarter of the state,
//    kept in registers in the accumulator layout across all chunks.
//    The state is written to shared memory (hi and lo, two buffers)
//    once a chunk for C state^T, which every warp reads.
//  - Exponents are all <= 0 (cum falls along the chunk), so nothing
//    overflows; the masked entries (t < l) are selected away, never
//    multiplied.  cum is kept in base 2 (dt A log2 e), so every
//    exponential is one ex2.approx (relative error ~2^-22, far under the
//    split's 2^-16).
//  - Registers: 3 CTAs a SM hold all 320 at once only at <= 168
//    registers a thread; __launch_bounds__ asks for that, and ptxas
//    meets it without spills at n 64 (chip_smoke.py phase 14 prints the
//    count).  Dealing the state update's tiles to the warps with the
//    least S and P x work balanced them but cost 201 registers, 2 CTAs a
//    SM and two waves, and ran slower.
//  - n is padded with zeros to kN in {16, 32, 64, 128} in shared memory
//    only; shared rows are padded by 16 bytes, so every ldmatrix and
//    state store is free of bank conflicts.
// Shared memory at kN = 64: two stages of 23.3 KB, two state buffers of
// 9 KB, 2 KB of per-warp cumsums and 5 KB of y: 71.5 KB a CTA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// f32: ssd_scan_simt_kernel (the first design, unchanged)
// ---------------------------------------------------------------------------
//
// FP32 FMA only: its results hold the kernel-vs-plain f32 tolerance
// (2e-3) with room, which bf16 tensor-core operands would not without the
// split above.
//
// The rows p of the [p, n] state evolve independently (row p needs
// x[., p] and the dt, B, C that all rows share), so the grid is
// (row group, h, b): 2 x 80 heads x 4 row groups of 16 is 640 CTAs at the
// zamba2 path's shape.  128 threads per CTA, 8 threads per state row, so
// a warp holds 4 rows and a CTA 16.  Thread `sub` of a row holds state
// entries sub, sub + 8, ... (E = n/8 rounded up to a power of two, in
// registers).  Per chunk of 64 tokens the CTA stages dt, exp(dt A), B and
// C (padded with zeros to 8E columns, so the padding adds nothing) and
// its 16 rows of x in shared memory as f32; every row reads B and C from
// there.  y_t of a row is a sum over its 8 threads by three
// xor-shuffles; the chunk's y goes through shared memory to coalesced
// stores.

constexpr int kLanes = 8;                       // threads per state row
constexpr int kThreads = 128;
constexpr int kRows = kThreads / kLanes;        // state rows per CTA
constexpr int kT = 64;                          // tokens staged per chunk
constexpr int kMaxE = 16;                       // state entries per thread
constexpr int kMaxState = kLanes * kMaxE;       // largest n

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

size_t smem_bytes(int E) {
  const size_t ne = (size_t)kLanes * E;
  return sizeof(float) * (2 * kT * ne + 2 * kT * kRows + 2 * kT);
}

template <typename T, int E>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_simt_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                         const float* __restrict__ A, const T* __restrict__ Bm,
                         const T* __restrict__ Cm, const float* __restrict__ s0,
                         T* __restrict__ y, float* __restrict__ sout, int64_t S,
                         int H, int P, int N) {
  constexpr int NE = kLanes * E;  // padded state width
  extern __shared__ __align__(16) float smem[];
  float* sB = smem;                 // [kT][NE]
  float* sC = sB + kT * NE;         // [kT][NE]
  float* sX = sC + kT * NE;         // [kT][kRows]
  float* sY = sX + kT * kRows;      // [kT][kRows]
  float* sDt = sY + kT * kRows;     // [kT]
  float* sDA = sDt + kT;            // [kT]

  const int tid = threadIdx.x;
  const int sub = tid % kLanes;     // which entries of the row
  const int rloc = tid / kLanes;    // row within the CTA
  const int p0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int row = p0 + rloc;
  const bool row_ok = row < P;
  const float a = A[h];

  float st[E];
  const int64_t st_base = ((b * H + h) * P + row) * (int64_t)N;
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int c = sub + kLanes * i;
    st[i] = (s0 != nullptr && row_ok && c < N) ? s0[st_base + c] : 0.f;
  }

  for (int64_t t0 = 0; t0 < S; t0 += kT) {
    const int nt = (int)(S - t0 < kT ? S - t0 : kT);
    __syncthreads();  // the previous chunk's shared memory is consumed
    for (int idx = tid; idx < kT * NE; idx += kThreads) {
      const int t = idx / NE, c = idx - t * NE;
      float bv = 0.f, cv = 0.f;
      if (t < nt && c < N) {
        const int64_t g = (b * S + t0 + t) * N + c;
        bv = to_f32(Bm[g]);
        cv = to_f32(Cm[g]);
      }
      sB[idx] = bv;
      sC[idx] = cv;
    }
    for (int idx = tid; idx < kT * kRows; idx += kThreads) {
      const int t = idx / kRows, r = idx - t * kRows;
      sX[idx] = (t < nt && p0 + r < P)
                    ? to_f32(x[((b * S + t0 + t) * H + h) * P + p0 + r])
                    : 0.f;
    }
    for (int t = tid; t < kT; t += kThreads) {
      const float d = t < nt ? dt[(b * S + t0 + t) * H + h] : 0.f;
      sDt[t] = d;
      sDA[t] = expf(d * a);
    }
    __syncthreads();

    for (int t = 0; t < nt; ++t) {
      const float dA = sDA[t];
      const float dtx = sDt[t] * sX[t * kRows + rloc];
      const float* bt = sB + t * NE + sub;
      const float* ct = sC + t * NE + sub;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < E; ++i) {
        st[i] = fmaf(st[i], dA, dtx * bt[kLanes * i]);
        acc = fmaf(st[i], ct[kLanes * i], acc);
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off /= 2)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (sub == 0) sY[t * kRows + rloc] = acc;
    }
    __syncthreads();
    for (int idx = tid; idx < nt * kRows; idx += kThreads) {
      const int t = idx / kRows, r = idx - t * kRows;
      if (p0 + r < P)
        store(&y[((b * S + t0 + t) * H + h) * P + p0 + r], sY[idx]);
    }
  }

  if (row_ok) {
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int c = sub + kLanes * i;
      if (c < N) sout[st_base + c] = st[i];
    }
  }
}

template <int E>
int launch_simt_e(const void* x, const void* dt, const void* A, const void* B,
                  const void* C, const void* s0, void* y, void* sout, int64_t b,
                  int64_t s, int64_t h, int64_t p, int64_t n, void* stream) {
  const size_t smem = smem_bytes(E);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_simt_kernel<float, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((p + kRows - 1) / kRows), (unsigned)h,
                  (unsigned)b);
  ssd_scan_simt_kernel<float, E><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(sout), s, (int)h, (int)p,
      (int)n);
  return (int)cudaGetLastError();
}

int launch_simt(const void* x, const void* dt, const void* A, const void* B,
                const void* C, const void* s0, void* y, void* sout, int64_t b,
                int64_t s, int64_t h, int64_t p, int64_t n, void* stream) {
  if (n < 1 || n > kMaxState) return (int)cudaErrorInvalidValue;
  const int64_t e = (n + kLanes - 1) / kLanes;
  if (e <= 1) return launch_simt_e<1>(x, dt, A, B, C, s0, y, sout, b, s, h, p, n, stream);
  if (e <= 2) return launch_simt_e<2>(x, dt, A, B, C, s0, y, sout, b, s, h, p, n, stream);
  if (e <= 4) return launch_simt_e<4>(x, dt, A, B, C, s0, y, sout, b, s, h, p, n, stream);
  if (e <= 8) return launch_simt_e<8>(x, dt, A, B, C, s0, y, sout, b, s, h, p, n, stream);
  return launch_simt_e<kMaxE>(x, dt, A, B, C, s0, y, sout, b, s, h, p, n, stream);
}

// ---------------------------------------------------------------------------
// bf16: ssd_scan_tc_kernel
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kQ = 64;               // tokens per chunk
constexpr int kPt = 32;              // state rows (p) per CTA
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kXs = kPt + 8;         // shared row stride of x, bf16 elements
constexpr unsigned kFull = 0xffffffffu;

// Shared-memory layout for a padded state width kN: two stages of
// {C, B [kQ][kN + 8], x [kQ][kXs] bf16, dt [kQ] f32}, two state buffers
// of {hi, lo} [kPt][kN + 8] bf16, per warp cum and w [kQ] f32, then y
// [kQ][kXs] bf16 on its way out.
template <int kN>
struct Layout {
  static constexpr int kNs = kN + 8;  // shared row stride of B, C and the state
  static constexpr int kC = 0;
  static constexpr int kB = kC + kQ * kNs * 2;
  static constexpr int kX = kB + kQ * kNs * 2;
  static constexpr int kDt = kX + kQ * kXs * 2;
  static constexpr int kStage = kDt + kQ * 4;
  static constexpr int kState = 2 * kStage;
  static constexpr int kStateBuf = kPt * kNs * 2;  // one of hi or lo
  static constexpr int kCum = kState + 4 * kStateBuf;
  static constexpr int kW = kCum + kWarps * kQ * 4;
  static constexpr int kY = kW + kWarps * kQ * 4;
  static constexpr int kBytes = kY + kQ * kXs * 2;
  static_assert(kStage % 16 == 0 && kStateBuf % 16 == 0, "16-byte alignment");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 2^x by the SFU (relative error ~2^-22; 0 below 2^-126)
__device__ __forceinline__ float fast_exp2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// cp.async of `bytes` (16 or 4); src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
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
__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// (v0, v1) as hi + lo, each a bf16 pair: hi rounds v, lo rounds v - hi
__device__ __forceinline__ void split(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(v0, v1);
  lo = pack_bf16(v0 - bf16_low(hi), v1 - bf16_high(hi));
}

// kN: n padded to 16, 32, 64 or 128; kAsync: cp.async loads (n and p
// multiples of 8, 16-byte-aligned x, B, C, y), else element-wise loads.
template <int kN, bool kAsync>
__global__ void __launch_bounds__(kThreads, kN <= 64 ? 3 : 1)
    ssd_scan_tc_kernel(const uint16_t* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A, const uint16_t* __restrict__ Bm,
                       const uint16_t* __restrict__ Cm, const float* __restrict__ s0,
                       uint16_t* __restrict__ y, float* __restrict__ sout, int64_t S,
                       int H, int P, int N) {
  using L = Layout<kN>;
  constexpr int kNs = L::kNs;
  constexpr int kKN = kN / 16;     // k-steps over n
  constexpr int kNT = kN / 16;     // n8 tiles of a warp's half of the state
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c4 = lane & 3;
  const int p0 = blockIdx.x * kPt;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const float a2 = A[h] * 1.4426950408889634f;  // A log2(e): exponents in base 2

  // zero everything once: the padding columns n..kN-1 of B and C are
  // never written again
  for (int i = tid; i < L::kBytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  auto stage = [&](int s, int off) { return smem + s * L::kStage + off; };

  auto load_chunk = [&](int64_t t0, int s) {
    const int nt = (int)(S - t0 < kQ ? S - t0 : kQ);
    uint16_t* dC = reinterpret_cast<uint16_t*>(stage(s, L::kC));
    uint16_t* dB = reinterpret_cast<uint16_t*>(stage(s, L::kB));
    uint16_t* dX = reinterpret_cast<uint16_t*>(stage(s, L::kX));
    float* dDt = reinterpret_cast<float*>(stage(s, L::kDt));
    if constexpr (kAsync) {
      // 16-byte pieces: kN / 8 a row of B or C (those past n are the zero
      // padding, never loaded), kPt / 8 a row of x; rows past s read
      // nothing and fill zeros, from the chunk's first row as a valid address
      const int64_t row0 = b * S + t0;
      const uint16_t* gC = Cm + row0 * N;
      const uint16_t* gB = Bm + row0 * N;
      const uint16_t* gX = x + (row0 * H + h) * P + p0;
      const float* gDt = dt + row0 * H + h;
      const int64_t xrow = (int64_t)H * P;
      for (int i = tid; i < kQ * (kN / 8); i += kThreads) {
        const int r = i / (kN / 8), q = i % (kN / 8);
        if (8 * q >= N) continue;
        const bool ok = r < nt;
        const int off = (ok ? r * N : 0) + 8 * q;
        cp_async16(smem_u32(dC + r * kNs + 8 * q), gC + off, ok);
        cp_async16(smem_u32(dB + r * kNs + 8 * q), gB + off, ok);
      }
      for (int i = tid; i < kQ * (kPt / 8); i += kThreads) {
        const int r = i / (kPt / 8), q = i % (kPt / 8);
        const bool ok = r < nt && p0 + 8 * q < P;
        cp_async16(smem_u32(dX + r * kXs + 8 * q), ok ? gX + r * xrow + 8 * q : gX, ok);
      }
      for (int r = tid; r < kQ; r += kThreads) {
        const bool ok = r < nt;
        cp_async4(smem_u32(dDt + r), gDt + (ok ? r * (int64_t)H : 0), ok);
      }
      cp_async_commit();
    } else {
      for (int i = tid; i < kQ * kN; i += kThreads) {
        const int r = i / kN, col = i - r * kN;
        uint16_t cv = 0, bv = 0;
        if (r < nt && col < N) {
          const int64_t gi = (b * S + t0 + r) * N + col;
          cv = Cm[gi];
          bv = Bm[gi];
        }
        dC[r * kNs + col] = cv;
        dB[r * kNs + col] = bv;
      }
      for (int i = tid; i < kQ * kPt; i += kThreads) {
        const int r = i / kPt, q = i - r * kPt;
        dX[r * kXs + q] =
            (r < nt && p0 + q < P) ? x[((b * S + t0 + r) * H + h) * P + p0 + q] : 0;
      }
      for (int r = tid; r < kQ; r += kThreads)
        dDt[r] = r < nt ? dt[(b * S + t0 + r) * H + h] : 0.f;
    }
  };

  // this warp's quarter of the state: rows 16 mp.., columns nb..nb + kN/2,
  // in the accumulator layout (n8 tile nt, element e: row g + 8 (e / 2),
  // column 8 nt + 2 c4 + e % 2)
  const int mp = warp >> 1, nb = (warp & 1) * (kN / 2);
  float st[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pr = p0 + 16 * mp + g + 8 * (e >> 1);
      const int nc = nb + 8 * nt + 2 * c4 + (e & 1);
      st[nt][e] = (s0 != nullptr && pr < P && nc < N)
                      ? s0[((b * H + h) * P + pr) * (int64_t)N + nc]
                      : 0.f;
    }

  auto write_state = [&](int buf) {
    uint16_t* hi = reinterpret_cast<uint16_t*>(smem + L::kState + 2 * buf * L::kStateBuf);
    uint16_t* lo = hi + kPt * kNs;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int idx = (16 * mp + g + 8 * half) * kNs + nb + 8 * nt + 2 * c4;
        uint32_t vh, vl;
        split(st[nt][2 * half], st[nt][2 * half + 1], vh, vl);
        *reinterpret_cast<uint32_t*>(hi + idx) = vh;
        *reinterpret_cast<uint32_t*>(lo + idx) = vl;
      }
  };

  float* cum = reinterpret_cast<float*>(smem + L::kCum) + warp * kQ;
  float* wv = reinterpret_cast<float*>(smem + L::kW) + warp * kQ;
  const int tr0 = 16 * warp + g, tr1 = tr0 + 8;  // this thread's rows of S, P, y
  // ldmatrix row/column offsets of this lane: "plain" for a 16x16 A tile
  // or a pair of B tiles stored [n][k]; "trans" for tiles stored [k][n]
  const int lr = lane & 7, lhi = lane >> 4, lmid = (lane >> 3) & 1;

  const int64_t nchunks = (S + kQ - 1) / kQ;
  if (nchunks > 0) load_chunk(0, 0);
  write_state(0);

  for (int64_t z = 0; z < nchunks; ++z) {
    const int s = (int)(z & 1);
    if constexpr (kAsync) cp_async_wait_all();
    __syncthreads();  // chunk z and the state of chunk z have landed
    const int64_t t0 = z * kQ;
    const int nt = (int)(S - t0 < kQ ? S - t0 : kQ);
    const uint16_t* sC = reinterpret_cast<const uint16_t*>(stage(s, L::kC));
    const uint16_t* sB = reinterpret_cast<const uint16_t*>(stage(s, L::kB));
    const uint16_t* sX = reinterpret_cast<const uint16_t*>(stage(s, L::kX));
    const float* sDt = reinterpret_cast<const float*>(stage(s, L::kDt));
    const uint16_t* sStHi =
        reinterpret_cast<const uint16_t*>(smem + L::kState + 2 * s * L::kStateBuf);
    const uint16_t* sStLo = sStHi + kPt * kNs;

    // cum = cumsum(dt A) log2(e) over the chunk, every warp its own copy:
    // lane L holds tokens 2L and 2L + 1; w_l = exp(cum_Q - cum_l) dt_l
    float decay;
    {
      const float d0 = sDt[2 * lane], d1 = sDt[2 * lane + 1];
      const float a0 = d0 * a2, pair = a0 + d1 * a2;
      float incl = pair;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += v;
      }
      const float c0 = incl - pair + a0;
      const float last = __shfl_sync(kFull, incl, 31);
      cum[2 * lane] = c0;
      cum[2 * lane + 1] = incl;
      wv[2 * lane] = fast_exp2(last - c0) * d0;
      wv[2 * lane + 1] = fast_exp2(last - incl) * d1;
      decay = fast_exp2(last);
    }
    __syncwarp();

    // C rows 16 warp.. as A fragments over all of n
    uint32_t ca[kKN][4];
#pragma unroll
    for (int kk = 0; kk < kKN; ++kk)
      ldsm_x4(ca[kk], smem_u32(sC + (16 * warp + lr + 8 * lmid) * kNs + 16 * kk + 8 * lhi));

    // S = C B^T on the tiles at or below the diagonal (l <= 16 warp + 15)
    float sacc[kQ / 8][4];
#pragma unroll
    for (int j = 0; j < kQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
#pragma unroll
    for (int jj = 0; jj < kQ / 16; ++jj) {
      if (jj > warp) break;
#pragma unroll
      for (int kk = 0; kk < kKN; ++kk) {
        uint32_t bb[4];
        ldsm_x4(bb, smem_u32(sB + (16 * jj + lr + 8 * lhi) * kNs + 16 * kk + 8 * lmid));
        mma(sacc[2 * jj], ca[kk], bb[0], bb[1]);
        mma(sacc[2 * jj + 1], ca[kk], bb[2], bb[3]);
      }
    }

    // C state^T, the state as hi + lo
    float yoff[kPt / 8][4];
#pragma unroll
    for (int j = 0; j < kPt / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) yoff[j][e] = 0.f;
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      const uint16_t* sSt = part ? sStLo : sStHi;
#pragma unroll
      for (int jp = 0; jp < kPt / 8; jp += 2)
#pragma unroll
        for (int kk = 0; kk < kKN; ++kk) {
          uint32_t bb[4];
          ldsm_x4(bb, smem_u32(sSt + (8 * jp + lr + 8 * lhi) * kNs + 16 * kk + 8 * lmid));
          mma(yoff[jp], ca[kk], bb[0], bb[1]);
          mma(yoff[jp + 1], ca[kk], bb[2], bb[3]);
        }
    }

    // P = (t >= l) exp(cum_t - cum_l) dt_l S, as hi + lo A fragments over l
    const float cr0 = cum[tr0], cr1 = cum[tr1];
    uint32_t phi[kQ / 16][4], plo[kQ / 16][4];
#pragma unroll
    for (int jj = 0; jj < kQ / 16; ++jj) {
      if (jj > warp) break;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = 2 * jj + half, l0 = 8 * j + 2 * c4;
        const float cl0 = cum[l0], cl1 = cum[l0 + 1];
        const float dl0 = sDt[l0], dl1 = sDt[l0 + 1];
        const float v0 = tr0 >= l0 ? fast_exp2(cr0 - cl0) * dl0 * sacc[j][0] : 0.f;
        const float v1 = tr0 >= l0 + 1 ? fast_exp2(cr0 - cl1) * dl1 * sacc[j][1] : 0.f;
        const float v2 = tr1 >= l0 ? fast_exp2(cr1 - cl0) * dl0 * sacc[j][2] : 0.f;
        const float v3 = tr1 >= l0 + 1 ? fast_exp2(cr1 - cl1) * dl1 * sacc[j][3] : 0.f;
        split(v0, v1, phi[jj][2 * half], plo[jj][2 * half]);
        split(v2, v3, phi[jj][2 * half + 1], plo[jj][2 * half + 1]);
      }
    }

    // y = P x + exp(cum_t) (C state^T)
    float yacc[kPt / 8][4];
#pragma unroll
    for (int j = 0; j < kPt / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[j][e] = 0.f;
#pragma unroll
    for (int jj = 0; jj < kQ / 16; ++jj) {
      if (jj > warp) break;
#pragma unroll
      for (int jp = 0; jp < kPt / 8; jp += 2) {
        uint32_t bb[4];
        ldsm_x4_t(bb, smem_u32(sX + (16 * jj + lr + 8 * lmid) * kXs + 8 * jp + 8 * lhi));
        mma(yacc[jp], phi[jj], bb[0], bb[1]);
        mma(yacc[jp + 1], phi[jj], bb[2], bb[3]);
        mma(yacc[jp], plo[jj], bb[0], bb[1]);
        mma(yacc[jp + 1], plo[jj], bb[2], bb[3]);
      }
    }
    // the next chunk's loads, started here rather than right after the
    // barrier (see the note at the top)
    if (z + 1 < nchunks) load_chunk((z + 1) * kQ, s ^ 1);

    // y rows of this warp: with cp.async loads staged in shared memory
    // and stored 16 bytes a lane, else element by element
    uint16_t* sY = reinterpret_cast<uint16_t*>(smem + L::kY);
    {
      const float e0 = fast_exp2(cr0), e1 = fast_exp2(cr1);
#pragma unroll
      for (int jt = 0; jt < kPt / 8; ++jt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int tr = half ? tr1 : tr0, col = 8 * jt + 2 * c4;
          const float sc = half ? e1 : e0;
          const float v0 = yacc[jt][2 * half] + sc * yoff[jt][2 * half];
          const float v1 = yacc[jt][2 * half + 1] + sc * yoff[jt][2 * half + 1];
          if constexpr (kAsync) {
            *reinterpret_cast<uint32_t*>(sY + tr * kXs + col) = pack_bf16(v0, v1);
          } else if (tr < nt) {
            const int pc = p0 + col;
            uint16_t* dst = y + ((b * S + t0 + tr) * H + h) * P + pc;
            if (pc < P) dst[0] = bf16_bits(v0);
            if (pc + 1 < P) dst[1] = bf16_bits(v1);
          }
        }
      }
    }
    if constexpr (kAsync) {
      __syncwarp();
#pragma unroll
      for (int i = lane; i < 16 * (kPt / 8); i += 32) {
        const int r = 16 * warp + i / (kPt / 8), q = i % (kPt / 8);
        if (r < nt && p0 + 8 * q < P)
          *reinterpret_cast<uint4*>(y + ((b * S + t0 + r) * H + h) * P + p0 + 8 * q) =
              *reinterpret_cast<const uint4*>(sY + r * kXs + 8 * q);
      }
    }

    // state = exp(cum_Q) state + (x w)^T B, x w as hi + lo
#pragma unroll
    for (int nt2 = 0; nt2 < kNT; ++nt2)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt2][e] *= decay;
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk) {
      uint32_t xa[4], xh[4], xl[4];
      ldsm_x4_t(xa, smem_u32(sX + (16 * kk + lr + 8 * lhi) * kXs + 16 * mp + 8 * lmid));
      const int l0 = 16 * kk + 2 * c4;
      const float w0 = wv[l0], w1 = wv[l0 + 1], w8 = wv[l0 + 8], w9 = wv[l0 + 9];
      split(bf16_low(xa[0]) * w0, bf16_high(xa[0]) * w1, xh[0], xl[0]);
      split(bf16_low(xa[1]) * w0, bf16_high(xa[1]) * w1, xh[1], xl[1]);
      split(bf16_low(xa[2]) * w8, bf16_high(xa[2]) * w9, xh[2], xl[2]);
      split(bf16_low(xa[3]) * w8, bf16_high(xa[3]) * w9, xh[3], xl[3]);
      const uint16_t* bk = sB + (16 * kk + lr + 8 * lmid) * kNs + nb;
      if constexpr (kNT == 1) {
        uint32_t bb[2];
        ldsm_x2_t(bb, smem_u32(bk));
        mma(st[0], xh, bb[0], bb[1]);
        mma(st[0], xl, bb[0], bb[1]);
      } else {
#pragma unroll
        for (int ntp = 0; ntp < kNT; ntp += 2) {
          uint32_t bb[4];
          ldsm_x4_t(bb, smem_u32(bk + 8 * ntp + 8 * lhi));
          mma(st[ntp], xh, bb[0], bb[1]);
          mma(st[ntp + 1], xh, bb[2], bb[3]);
          mma(st[ntp], xl, bb[0], bb[1]);
          mma(st[ntp + 1], xl, bb[2], bb[3]);
        }
      }
    }
    write_state(s ^ 1);
  }

#pragma unroll
  for (int nt2 = 0; nt2 < kNT; ++nt2)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pr = p0 + 16 * mp + g + 8 * (e >> 1);
      const int nc = nb + 8 * nt2 + 2 * c4 + (e & 1);
      if (pr < P && nc < N) sout[((b * H + h) * P + pr) * (int64_t)N + nc] = st[nt2][e];
    }
}

template <int kN, bool kAsync>
int launch_n(const void* x, const void* dt, const void* A, const void* B, const void* C,
             const void* s0, void* y, void* sout, int64_t b, int64_t s, int64_t h,
             int64_t p, int64_t n, void* stream) {
  constexpr int smem = Layout<kN>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_tc_kernel<kN, kAsync>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((p + kPt - 1) / kPt), (unsigned)h, (unsigned)b);
  ssd_scan_tc_kernel<kN, kAsync><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const uint16_t*>(B),
      static_cast<const uint16_t*>(C), static_cast<const float*>(s0),
      static_cast<uint16_t*>(y), static_cast<float*>(sout), s, (int)h, (int)p, (int)n);
  return (int)cudaGetLastError();
}

template <bool kAsync>
int launch_tc(const void* x, const void* dt, const void* A, const void* B,
                 const void* C, const void* s0, void* y, void* sout, int64_t b, int64_t s,
                 int64_t h, int64_t p, int64_t n, void* stream) {
  if (n <= 16) return launch_n<16, kAsync>(x, dt, A, B, C, s0, y, sout, b, s, h, p, n, stream);
  if (n <= 32) return launch_n<32, kAsync>(x, dt, A, B, C, s0, y, sout, b, s, h, p, n, stream);
  if (n <= 64) return launch_n<64, kAsync>(x, dt, A, B, C, s0, y, sout, b, s, h, p, n, stream);
  return launch_n<128, kAsync>(x, dt, A, B, C, s0, y, sout, b, s, h, p, n, stream);
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

int launch(const void* x, const void* dt, const void* A, const void* B, const void* C,
           const void* s0, void* y, void* sout, int64_t b, int64_t s, int64_t h, int64_t p,
           int64_t n, void* stream) {
  if (n < 1 || n > kMaxState) return (int)cudaErrorInvalidValue;
  const bool async = n % 8 == 0 && p % 8 == 0 && aligned16(x) && aligned16(B) &&
                     aligned16(C) && aligned16(y);
  if (async)
    return launch_tc<true>(x, dt, A, B, C, s0, y, sout, b, s, h, p, n, stream);
  return launch_tc<false>(x, dt, A, B, C, s0, y, sout, b, s, h, p, n, stream);
}

}  // namespace tc

}  // namespace

extern "C" {

int ssd_scan_max_state() { return kMaxState; }

int ssd_scan_tc_chunk() { return tc::kQ; }

int ssd_scan_f32(const void* x, const void* dt, const void* A, const void* B,
                 const void* C, const void* s0, void* y, void* sout,
                 int64_t b, int64_t s, int64_t h, int64_t p, int64_t n,
                 void* stream) {
  return launch_simt(x, dt, A, B, C, s0, y, sout, b, s, h, p, n, stream);
}

int ssd_scan_bf16(const void* x, const void* dt, const void* A, const void* B,
                  const void* C, const void* s0, void* y, void* sout,
                  int64_t b, int64_t s, int64_t h, int64_t p, int64_t n,
                  void* stream) {
  return tc::launch(x, dt, A, B, C, s0, y, sout, b, s, h, p, n, stream);
}

}  // extern "C"

// Hand-written Hopper (sm_90a) Mamba2 SSD scan: the selective state-space
// recurrence of one group (B and C shared by all heads), token by token.
//
// Built by nvcc into a shared library with a plain C interface and bound
// with ctypes (repro_torch/kernels/build.py); the Python wrapper and the
// plain PyTorch version are in ../ops.py.  Each entry point launches on
// the stream it is given, allocates nothing, and returns
// cudaGetLastError() so a refused launch is reported.
//
// Replaces the Pallas kernel ssd_scan_kernel
// (repro/kernels/mamba2_scan/kernel.py, body _ssd_kernel, wrapper
// ops.py::ssd_scan, oracle ref.py::ssd_scan_ref).  Inputs x [b, s, h, p],
// dt [b, s, h] (f32, > 0), A [h] (f32, < 0), B and C [b, s, n], an
// optional initial state s0 [b, h, p, n] (f32; null means zeros).  x, B
// and C are all f32 or all bf16 (the model passes its bf16 activations
// with an f32 dt).  Per (b, h), for every token t in order:
//   state = exp(dt_t A) state + (dt_t x_t) B_t^T     ([p, n], f32)
//   y_t   = state C_t                                ([p])
// y is written in x's dtype, the final state in f32.  This is the exact
// recurrence of ref.py; the Pallas kernel computes the same function in
// its chunked dual form (dense [c, c] products per chunk on the MXU), so
// the two differ only by float rounding.
//
// Differences from the Pallas design, which the TPU's grid model shaped:
//  - the rows p of the [p, n] state evolve independently (row p needs
//    x[., p] and the dt, B, C that all rows share), so the grid is
//    (row group, h, b) rather than (b, h): 2 x 80 heads x 4 row groups of
//    16 is 640 CTAs at the zamba2 path's shape, not 160 on 132 SMs;
//  - ragged s needs no padded copy: the last chunk is shorter;
//  - the recurrence is a loop inside the CTA (the Pallas "arbitrary"
//    grid axis with a VMEM scratch state); the state lives in registers.
//
// Bound: bytes.  Each input is read once and y written once (350 MB at
// 2 x 8192 tokens, 80 heads of 64, n = 64, bf16: 0.105 ms at 3.35 TB/s);
// the arithmetic is 4 flops per state entry per token (21.5 GFLOP there:
// 0.022 ms at the bf16 tensor-core rate the chunked dual form could use,
// 0.32 ms at the f32 FMA rate this version runs at).  This first version
// walks the tokens one by one in each CTA and is expected to be
// latency-bound, well above either; the chunked dual form on tensor
// cores is later work.
//
// Design: 128 threads per CTA, 8 threads per state row, so a warp holds
// 4 rows and a CTA 16.  Thread `sub` of a row holds state entries
// sub, sub + 8, ... (E = n/8 rounded up to a power of two, in registers).
// Per chunk of 64 tokens the CTA stages dt, exp(dt A), B and C (padded
// with zeros to 8E columns, so the padding adds nothing) and its 16
// rows of x in shared memory as f32; every row reads B and C from there.
// y_t of a row is a sum over its 8 threads by three xor-shuffles; the
// chunk's y goes through shared memory to coalesced stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 8;                       // threads per state row
constexpr int kThreads = 128;
constexpr int kRows = kThreads / kLanes;        // state rows per CTA
constexpr int kT = 64;                          // tokens staged per chunk
constexpr int kMaxE = 16;                       // state entries per thread
constexpr int kMaxState = kLanes * kMaxE;       // largest n

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

size_t smem_bytes(int E) {
  const size_t ne = (size_t)kLanes * E;
  return sizeof(float) * (2 * kT * ne + 2 * kT * kRows + 2 * kT);
}

template <typename T, int E>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
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

template <typename T, int E>
int launch_e(const void* x, const void* dt, const void* A, const void* B,
             const void* C, const void* s0, void* y, void* sout, int64_t b,
             int64_t s, int64_t h, int64_t p, int64_t n, void* stream) {
  const size_t smem = smem_bytes(E);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((p + kRows - 1) / kRows), (unsigned)h,
                  (unsigned)b);
  ssd_scan_kernel<T, E><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(sout), s, (int)h, (int)p,
      (int)n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, const void* s0, void* y, void* sout, int64_t b,
           int64_t s, int64_t h, int64_t p, int64_t n, void* stream) {
  if (n < 1 || n > kMaxState) return (int)cudaErrorInvalidValue;
  const int64_t e = (n + kLanes - 1) / kLanes;
  if (e <= 1) return launch_e<T, 1>(x, dt, A, B, C, s0, y, sout, b, s, h, p, n, stream);
  if (e <= 2) return launch_e<T, 2>(x, dt, A, B, C, s0, y, sout, b, s, h, p, n, stream);
  if (e <= 4) return launch_e<T, 4>(x, dt, A, B, C, s0, y, sout, b, s, h, p, n, stream);
  if (e <= 8) return launch_e<T, 8>(x, dt, A, B, C, s0, y, sout, b, s, h, p, n, stream);
  return launch_e<T, kMaxE>(x, dt, A, B, C, s0, y, sout, b, s, h, p, n, stream);
}

}  // namespace

extern "C" {

int ssd_scan_max_state() { return kMaxState; }

int ssd_scan_f32(const void* x, const void* dt, const void* A, const void* B,
                 const void* C, const void* s0, void* y, void* sout,
                 int64_t b, int64_t s, int64_t h, int64_t p, int64_t n,
                 void* stream) {
  return launch<float>(x, dt, A, B, C, s0, y, sout, b, s, h, p, n, stream);
}

int ssd_scan_bf16(const void* x, const void* dt, const void* A, const void* B,
                  const void* C, const void* s0, void* y, void* sout,
                  int64_t b, int64_t s, int64_t h, int64_t p, int64_t n,
                  void* stream) {
  return launch<__nv_bfloat16>(x, dt, A, B, C, s0, y, sout, b, s, h, p, n,
                               stream);
}

}  // extern "C"

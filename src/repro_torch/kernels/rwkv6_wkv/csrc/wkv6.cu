// Hand-written Hopper (sm_90a) RWKV6 wkv recurrence: linear attention
// with a per-channel, data-dependent decay, token by token.
//
// Built by nvcc into a shared library with a plain C interface and bound
// with ctypes (repro_torch/kernels/build.py); the Python wrapper and the
// plain PyTorch version are in ../ops.py.  Each entry point launches on
// the stream it is given, allocates nothing, and returns
// cudaGetLastError() so a refused launch is reported.
//
// Replaces the Pallas kernel wkv6_kernel
// (repro/kernels/rwkv6_wkv/kernel.py, body _wkv_kernel, wrapper
// ops.py::wkv6, oracle ref.py::wkv6_ref).  Inputs r, k, v [B, T, H, N]
// (all f32 or all bf16), the decay w [B, T, H, N] (f32, in (0, 1)), the
// bonus u [H, N] (f32) and an optional initial state s0 [B, H, N, N]
// (f32, S[i (key), j (value)]; null means zeros).  Per (b, h), for every
// token t in order:
//   y_t = r_t . S + (r_t . (u * k_t)) v_t      (= r_t . (S + diag(u) k_t v_t^T))
//   S   = diag(w_t) S + k_t v_t^T
// y is written in r's dtype, the final state in f32.  This is the exact
// recurrence of ref.py.  The Pallas kernel computes the same function in
// chunks, from log-space decay products that it clips at -60 and from w
// floored at 1e-12; the exact recurrence does neither.  The difference
// is a product of decays below exp(-60) ~ 1e-26, far below the 1e-3
// tolerance the two are held to.
//
// Differences from the Pallas design, which the TPU's grid model shaped:
//  - the Pallas kernel materialises a [c, c, N] decay tile per chunk
//    (1 MB at c = 64, N = 64, in VMEM); it does not fit a Hopper SM's
//    shared memory, and the token-by-token form needs none: as in the
//    official RWKV CUDA kernel, the value columns j of S evolve
//    independently (column j needs r, k, w, u and v[j] only) and are
//    held in registers;
//  - the grid is (column group of 32, h, b): 2 x 40 heads x 2 groups is
//    160 CTAs at the rwkv6-3b path's shape, not 80;
//  - ragged T needs no padded copy: the last chunk is shorter;
//  - the recurrence is a loop inside the CTA (the Pallas "arbitrary"
//    grid axis with a VMEM scratch state).
//
// Bound: bytes.  Each input is read once and y written once (506 MB at
// 2 x 8192 tokens, 40 heads of 64, bf16 r/k/v and f32 w: 0.151 ms at
// 3.35 TB/s); the arithmetic is 4 flops per state entry per token
// (10.7 GFLOP there: 0.011 ms at the bf16 tensor-core rate, 0.16 ms at
// the f32 FMA rate this version runs at).  This version walks the tokens
// one by one and is latency-bound; the chunked form on tensor cores is
// later work.
//
// Design: 128 threads per CTA, 4 per value column: thread (c, q) holds
// keys i of quarter q of column j0 + c, NP/4 floats in registers (NP =
// 16, 32 or 64, the head size rounded up; the padding has r = k = 0 and
// w = 1, so it adds nothing), and y_t[j] is its 4 partial sums joined by
// two xor-shuffles.  (One thread per column, as in the official kernel,
// left one warp per CTA with a 64-long chain of dependent multiply-adds
// per token: 15.7 ms at the path's shape on an H100.)  Per chunk of 32
// tokens the CTA stages r, k, w and its 32 columns of v in shared memory
// as f32, then the bonus r_t . (u * k_t) of each token, one group of 4
// threads per token.  Rows are padded by 4 floats every 16, so the four
// quarters a warp reads as float4s at each token lie in different banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;                 // value columns per CTA
constexpr int kSplit = 4;                 // threads per column
constexpr int kThreads = kCols * kSplit;  // 128
constexpr int kT = 32;                    // tokens staged per chunk
constexpr int kMaxN = 64;                 // largest head size
static_assert(kT == kThreads / kSplit, "one thread group per token for the bonus");

// position of key channel i in a staged row: 4 floats of padding after
// every 16, so the quarters of a row start in different banks
__host__ __device__ constexpr int pad(int i) { return i + (i / 16) * 4; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int NP>
__global__ void __launch_bounds__(kThreads)
    wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                T* __restrict__ y, float* __restrict__ sout, int64_t Tn,
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
        rv = to_f32(r[g]);
        kv = to_f32(k[g]);
        wv = w[g];
      }
      sR[t * LD + pad(i)] = rv;
      sK[t * LD + pad(i)] = kv;
      sW[t * LD + pad(i)] = wv;
    }
    for (int idx = tid; idx < kT * kCols; idx += kThreads) {
      const int t = idx / kCols, cc = idx - t * kCols;
      sV[idx] = (t < nt && j0 + cc < N)
                    ? to_f32(v[((b * Tn + t0 + t) * H + h) * N + j0 + cc])
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
        store(&y[((b * Tn + t0 + t) * H + h) * N + j], fmaf(sA[t], vj, part));
    }
  }

  if (col_ok) {
#pragma unroll
    for (int m = 0; m < Q; ++m)
      if (i0 + m < N) sout[st_base + (i0 + m) * N + j] = s[m];
  }
}

template <typename T, int NP>
int launch_n(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* s0, void* y, void* sout, int64_t B,
             int64_t Tn, int64_t H, int64_t N, void* stream) {
  const dim3 grid((unsigned)((N + kCols - 1) / kCols), (unsigned)H,
                  (unsigned)B);
  wkv6_kernel<T, NP><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(sout), Tn, (int)H, (int)N);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* y, void* sout, int64_t B,
           int64_t Tn, int64_t H, int64_t N, void* stream) {
  if (N < 1 || N > kMaxN) return (int)cudaErrorInvalidValue;
  if (N <= 16) return launch_n<T, 16>(r, k, v, w, u, s0, y, sout, B, Tn, H, N, stream);
  if (N <= 32) return launch_n<T, 32>(r, k, v, w, u, s0, y, sout, B, Tn, H, N, stream);
  return launch_n<T, kMaxN>(r, k, v, w, u, s0, y, sout, B, Tn, H, N, stream);
}

}  // namespace

extern "C" {

int wkv6_max_head() { return kMaxN; }

int wkv6_f32(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* s0, void* y, void* sout, int64_t B,
             int64_t Tn, int64_t H, int64_t N, void* stream) {
  return launch<float>(r, k, v, w, u, s0, y, sout, B, Tn, H, N, stream);
}

int wkv6_bf16(const void* r, const void* k, const void* v, const void* w,
              const void* u, const void* s0, void* y, void* sout, int64_t B,
              int64_t Tn, int64_t H, int64_t N, void* stream) {
  return launch<__nv_bfloat16>(r, k, v, w, u, s0, y, sout, B, Tn, H, N,
                               stream);
}

}  // extern "C"

// Hand-written Hopper (sm_90a) kernels for the Jacobi stencil path.
//
// Built by nvcc into a shared library with a plain C interface and bound
// with ctypes (repro_torch/kernels/build.py); the Python wrappers and the
// plain PyTorch versions of both kernels are in ../ops.py.  Every entry
// point launches on the stream it is given, allocates nothing, and
// returns cudaGetLastError() so a refused launch is reported.
//
// Compiled with --fmad=false: neither kernel has an a*b+c that could
// contract, and the flag keeps it so, since both must reproduce the
// NumPy interpreter's rounding bit for bit.
//
// stencil5_group — replaces the Pallas kernel stencil5_block_kernel
// (repro/kernels/stencil/kernel.py:88, body _stencil5_kernel).  It computes
// out = w * ((((x0 + x1) + x2) + x3) + x4) over five same-shape 2-D views,
// accumulating in their own dtype (the Pallas kernel widens to f32 even
// for f64 input; this one does not, so f64 results equal NumPy's), for a
// whole table of such fragments in one launch.  Every operand, the output
// included, is a strided 2-D view (row and column stride in elements):
// the runtime's fragments are slices of 2048^2 blocks, read in place and
// written straight into the output block's slice.
//   Bound: memory.  Per element five values are read and one written (48
//   bytes in f64) for 5 flops, far below the card's ridge.  When the five
//   operands are shifts of one block by 0 and +-1 row or column (the
//   runtime's interior fragments) their distinct bytes are one read of
//   the block and one write: 16 bytes an element.
//   What held the first design back: one launch per fragment (3456 a
//   16384^2 run, 3072 of them 1-wide slivers whose launch cost is all
//   host time), a fresh output and a copy launch into the block for each,
//   and a one-thread-per-element kernel with 64-bit index arithmetic on
//   five stride pairs and only five loads in flight a thread.
//   Design:
//    - The fragment table travels by value in the kernel's parameters
//      (kMaxFrags descriptors, within the 32 KB that CUDA 12.1+ allows on
//      sm_90), with the prefix sum of each fragment's tile count.  One
//      CTA computes one kTileR x kTileC tile and finds its fragment by a
//      binary search over the prefix sum, so a 1 x 1 corner costs one
//      tile of one CTA, not a launch.  The wrapper splits larger groups.
//    - Each thread owns kVec consecutive columns of kRowsPerThread rows,
//      starts all 5 * kRowsPerThread * kVec loads before its adds, and
//      indexes in 32 bits within a fragment (the wrapper checks the span).
//    - Shared route (descriptor mode bit 0): when the five operands are
//      one storage at offsets 0, +-row stride and +-1 with unit column
//      stride, the CTA stages its tile plus a one-element halo (no
//      corners) in shared memory by cp.async — 16-byte pieces when the
//      row stride keeps every row's phase (mode bit 1), element pieces
//      otherwise — so each value leaves device memory once.  Every
//      16-byte piece holds at least one element of some operand, so no
//      load touches memory outside the views' pages.
//    - Everything else (slivers across blocks, scratch operands) takes
//      the generic strided loads.
//   The descriptors, their field order and the mode bits are built by
//   ../ops.py::_table (kFields int64 values a fragment).

// jacobi_sweep — replaces the Pallas kernel jacobi_sweep_kernel
// (repro/kernels/stencil/kernel.py, body _jacobi_kernel, wrapper
// ops.py::jacobi_sweep).  One 5-point Jacobi sweep over a contiguous
// [H, W] grid: interior points get 0.2 * ((((c + up) + down) + left) +
// right) in the grid's dtype, rows 0 and H-1 and columns 0 and W-1 keep
// their values (Dirichlet).  A ragged H needs no padding: every thread
// checks its own row against H (the Pallas wrapper pads H to a band
// multiple only because BlockSpec tiles must divide the array).
//   Bound: memory.  The least traffic is one read and one write of the
//   grid (16 bytes per point in f64).  Design: one thread per point; the
//   four neighbour loads hit the rows the block's and its neighbours'
//   threads load anyway, so they come from L1/L2, not device memory.
//   Tiling rows through shared memory (or TMA) would make that reuse
//   explicit and is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxGridY = 65535;
constexpr int64_t kMaxGridX = 1 << 20;

constexpr int kGroupThreads = 256;
constexpr int kTileR = 16, kTileC = 128;  // a CTA's tile
constexpr int kVec = 2;                    // consecutive columns a thread
constexpr int kColGroups = kTileC / kVec;  // 64 threads across a tile row
constexpr int kRowGroups = kGroupThreads / kColGroups;  // 4
constexpr int kRowsPerThread = kTileR / kRowGroups;     // 4, kRowGroups apart
constexpr int kSmemW = kTileC + 8;  // staged row: halo, phase, 16-byte round-up
constexpr int kMaxFrags = 256;      // descriptors in one launch's parameters
constexpr int kSmallFrags = 16;     // a small launch's table (less to copy)
constexpr int kFields = 21;         // int64 values a fragment in the host table
static_assert(kColGroups * kRowGroups == kGroupThreads, "thread layout");
static_assert((kSmemW * sizeof(float)) % 16 == 0, "staged rows start 16-byte aligned");

struct FragDesc {
  const void* x[5];  // the shared route keeps the centre operand in x[0]
  void* out;
  int32_t rs[5], cs[5];
  int32_t ors, ocs;
  int32_t rows, cols;
  int32_t tiles_c;  // column tiles
  int32_t mode;     // bit 0 shared route, bit 1 16-byte pieces, bits 4.. offsets
};

template <int N>
struct GroupParams {
  FragDesc f[N];
  int32_t tile_start[N];  // first tile of each fragment
  int32_t n;
  double weight;
};
static_assert(sizeof(GroupParams<kMaxFrags>) <= 32764, "kernel parameter limit");

// the shared route's operand offsets from the centre: operand i's code
// (mode bits 4 + 3i) is 0 for the centre, 1 / 2 for the row above /
// below, 3 / 4 for the column left / right
__device__ __forceinline__ int code_dy(int code) { return code == 1 ? -1 : (code == 2 ? 1 : 0); }
__device__ __forceinline__ int code_dx(int code) { return code == 3 ? -1 : (code == 4 ? 1 : 0); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

template <int Bytes>
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(smem_addr(dst)), "l"(src),
               "n"(Bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}

template <typename T>
__device__ __forceinline__ void store_tile(const FragDesc& f, int r0, int c0, T w,
                                           const T (&v)[5][kRowsPerThread][kVec]) {
  const int tx = threadIdx.x % kColGroups, ty = threadIdx.x / kColGroups;
  T* out = static_cast<T*>(f.out);
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int r = r0 + ty + j * kRowGroups;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int c = c0 + tx * kVec + k;
      if (r < f.rows && c < f.cols) {
        T acc = v[0][j][k] + v[1][j][k];
        acc = acc + v[2][j][k];
        acc = acc + v[3][j][k];
        acc = acc + v[4][j][k];
        out[r * f.ors + c * f.ocs] = w * acc;
      }
    }
  }
}

// five strided operands, each element loaded by the thread that needs it
template <typename T>
__device__ void generic_tile(const FragDesc& f, int r0, int c0, T w) {
  const int tx = threadIdx.x % kColGroups, ty = threadIdx.x / kColGroups;
  T v[5][kRowsPerThread][kVec];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const T* x = static_cast<const T*>(f.x[i]);
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int r = r0 + ty + j * kRowGroups;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int c = c0 + tx * kVec + k;
        v[i][j][k] = (r < f.rows && c < f.cols) ? x[r * f.rs[i] + c * f.cs[i]] : T(0);
      }
    }
  }
  store_tile<T>(f, r0, c0, w, v);
}

// the tile plus its halo staged once in shared memory.  Staged row h holds
// centre row r0 - 1 + h; staged column sc holds centre column
// c0 - 1 - ph + sc, where ph (elements) puts 16-byte pieces of global
// memory on 16-byte pieces of the row
template <typename T>
__device__ void shared_tile(const FragDesc& f, int r0, int c0, T w, T* tile) {
  constexpr int E = 16 / sizeof(T);  // elements a 16-byte piece
  const T* cen = static_cast<const T*>(f.x[0]);
  const int rs = f.rs[0];
  const int tr = min(kTileR, f.rows - r0), tc = min(kTileC, f.cols - c0);
  const bool v16 = f.mode & 2;
  const int ph =
      v16 ? static_cast<int>((reinterpret_cast<uintptr_t>(cen + c0 - 1) % 16) / sizeof(T)) : 0;
  const int nrows = tr + 2;
  if (v16) {
    constexpr int kPieces = kSmemW / E;
    for (int idx = threadIdx.x; idx < nrows * kPieces; idx += kGroupThreads) {
      const int h = idx / kPieces, q = idx % kPieces;
      const bool halo = h == 0 || h == nrows - 1;
      // staged columns this row needs: [lo, hi)
      const int lo = ph + (halo ? 1 : 0), hi = ph + tc + (halo ? 1 : 2);
      if (q * E + E <= lo || q * E >= hi) continue;
      const T* src = cen + (r0 - 1 + h) * rs + (c0 - 1 - ph) + q * E;
      cp_async16(tile + h * kSmemW + q * E, src);
    }
  } else {
    for (int idx = threadIdx.x; idx < nrows * (kTileC + 2); idx += kGroupThreads) {
      const int h = idx / (kTileC + 2), sc = idx % (kTileC + 2);
      const bool halo = h == 0 || h == nrows - 1;
      if (sc >= tc + 2 || (halo && (sc == 0 || sc == tc + 1))) continue;
      cp_async_ca<sizeof(T)>(tile + h * kSmemW + sc, cen + (r0 - 1 + h) * rs + (c0 - 1 + sc));
    }
  }
  cp_async_wait_all();
  __syncthreads();
  const int tx = threadIdx.x % kColGroups, ty = threadIdx.x / kColGroups;
  T v[5][kRowsPerThread][kVec];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int code = (f.mode >> (4 + 3 * i)) & 7;
    const T* base = tile + (1 + code_dy(code)) * kSmemW + (1 + ph + code_dx(code));
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int rr = ty + j * kRowGroups;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int cc = tx * kVec + k;
        // rows and columns past the tile's edge read staged garbage or
        // zeros that store_tile never writes out
        v[i][j][k] = (rr < tr && cc < tc) ? base[rr * kSmemW + cc] : T(0);
      }
    }
  }
  store_tile<T>(f, r0, c0, w, v);
}

template <typename T, int N>
__global__ void __launch_bounds__(kGroupThreads)
    stencil5_group_kernel(const __grid_constant__ GroupParams<N> p) {
  __shared__ __align__(16) T tile[(kTileR + 2) * kSmemW];
  const int b = blockIdx.x;
  int lo = 0, hi = p.n - 1;  // the last fragment whose first tile is <= b
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (p.tile_start[mid] <= b) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const FragDesc& f = p.f[lo];
  const int t = b - p.tile_start[lo];
  const int r0 = (t / f.tiles_c) * kTileR, c0 = (t % f.tiles_c) * kTileC;
  const T w = static_cast<T>(p.weight);
  if (f.mode & 1) {
    shared_tile<T>(f, r0, c0, w, tile);
  } else {
    generic_tile<T>(f, r0, c0, w);
  }
}

template <typename T>
__global__ void jacobi_sweep_kernel(const T* __restrict__ x,
                                    T* __restrict__ out, int64_t H,
                                    int64_t W) {
  for (int64_t r = blockIdx.y; r < H; r += gridDim.y) {
    for (int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; c < W;
         c += (int64_t)gridDim.x * blockDim.x) {
      const int64_t i = r * W + c;
      T v = x[i];
      if (r > 0 && r < H - 1 && c > 0 && c < W - 1) {
        T acc = v + x[i - W];
        acc = acc + x[i + W];
        acc = acc + x[i - 1];
        acc = acc + x[i + 1];
        v = T(0.2) * acc;
      }
      out[i] = v;
    }
  }
}

dim3 grid_for(int64_t rows, int64_t cols) {
  int64_t gx = (cols + kThreads - 1) / kThreads;
  return dim3((unsigned)(gx < kMaxGridX ? gx : kMaxGridX),
              (unsigned)(rows < kMaxGridY ? rows : kMaxGridY));
}

// one launch over table rows [0, n): descriptors packed from the host
// table (kFields int64 values a fragment, in ../ops.py::_table's order)
template <typename T, int N>
int launch_group_n(const int64_t* table, int n, double weight, cudaStream_t stream) {
  GroupParams<N> p;
  int tiles = 0;
  int m = 0;
  for (int i = 0; i < n; ++i) {
    const int64_t* row = table + (int64_t)i * kFields;
    FragDesc& f = p.f[m];
    for (int j = 0; j < 5; ++j) {
      f.x[j] = reinterpret_cast<const void*>(row[j]);
      f.rs[j] = (int32_t)row[5 + j];
      f.cs[j] = (int32_t)row[10 + j];
    }
    f.out = reinterpret_cast<void*>(row[15]);
    f.ors = (int32_t)row[16];
    f.ocs = (int32_t)row[17];
    f.rows = (int32_t)row[18];
    f.cols = (int32_t)row[19];
    f.mode = (int32_t)row[20];
    if (f.rows <= 0 || f.cols <= 0) continue;
    f.tiles_c = (f.cols + kTileC - 1) / kTileC;
    const int64_t ft = (int64_t)f.tiles_c * ((f.rows + kTileR - 1) / kTileR);
    if (tiles + ft > 0x7fffffff) return -1;
    p.tile_start[m++] = tiles;
    tiles += (int)ft;
  }
  if (m == 0) return (int)cudaSuccess;
  p.n = m;
  p.weight = weight;
  stencil5_group_kernel<T, N><<<tiles, kGroupThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_group(const int64_t* table, int n, double weight, void* stream) {
  if (n < 0 || n > kMaxFrags) return -1;
  if (n <= kSmallFrags)
    return launch_group_n<T, kSmallFrags>(table, n, weight, (cudaStream_t)stream);
  return launch_group_n<T, kMaxFrags>(table, n, weight, (cudaStream_t)stream);
}

template <typename T>
int launch_jacobi(const void* x, void* out, int64_t H, int64_t W,
                  void* stream) {
  if (H <= 0 || W <= 0) return (int)cudaSuccess;
  jacobi_sweep_kernel<T><<<grid_for(H, W), kThreads, 0,
                           (cudaStream_t)stream>>>((const T*)x, (T*)out, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One launch of stencil5_group_kernel over n <= kMaxFrags fragments of the
// host table (rows of kFields int64).  Returns 0, a cudaError, or -1 for
// a table the kernel does not take.
int stencil5_group_f32(const int64_t* table, int n, double weight, void* stream) {
  return launch_group<float>(table, n, weight, stream);
}

int stencil5_group_f64(const int64_t* table, int n, double weight, void* stream) {
  return launch_group<double>(table, n, weight, stream);
}

// the constants ../ops.py must agree with: kMaxFrags, kFields, kTileR, kTileC
int stencil5_group_config(int i) {
  const int c[] = {kMaxFrags, kFields, kTileR, kTileC};
  return (i >= 0 && i < 4) ? c[i] : -1;
}

int jacobi_sweep_f32(const void* x, void* out, int64_t H, int64_t W,
                     void* stream) {
  return launch_jacobi<float>(x, out, H, W, stream);
}

int jacobi_sweep_f64(const void* x, void* out, int64_t H, int64_t W,
                     void* stream) {
  return launch_jacobi<double>(x, out, H, W, stream);
}

}  // extern "C"

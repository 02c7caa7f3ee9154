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
// stencil5_block — replaces the Pallas kernel stencil5_block_kernel
// (repro/kernels/stencil/kernel.py, body _stencil5_kernel).  It computes
// out = w * ((((x0 + x1) + x2) + x3) + x4) over five same-shape 2-D blocks,
// accumulating in the blocks' own dtype (the Pallas kernel widens to f32
// even for f64 input; this one does not, so f64 results equal NumPy's).
// Each input is a strided 2-D view (row and column stride in elements):
// the runtime's fragments are slices of larger blocks, and reading them
// in place saves a copy per operand.  The output is contiguous.
//   Bound: memory.  Per element it reads five values and writes one
//   (48 bytes in f64) for 5 flops, far below the card's 3.35 TB/s
//   ridge.  Design: one thread per element, threads of a warp on
//   neighbouring columns so each row segment is one coalesced load per
//   operand; rows and column tiles on a 2-D grid, grid-stride beyond the
//   grid's limits.  No shared memory: no value is read twice.
//
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

template <typename T>
__global__ void stencil5_block_kernel(
    const T* __restrict__ x0, int64_t rs0, int64_t cs0,
    const T* __restrict__ x1, int64_t rs1, int64_t cs1,
    const T* __restrict__ x2, int64_t rs2, int64_t cs2,
    const T* __restrict__ x3, int64_t rs3, int64_t cs3,
    const T* __restrict__ x4, int64_t rs4, int64_t cs4,
    T* __restrict__ out, int64_t rows, int64_t cols, T weight) {
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    for (int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; c < cols;
         c += (int64_t)gridDim.x * blockDim.x) {
      T acc = x0[r * rs0 + c * cs0] + x1[r * rs1 + c * cs1];
      acc = acc + x2[r * rs2 + c * cs2];
      acc = acc + x3[r * rs3 + c * cs3];
      acc = acc + x4[r * rs4 + c * cs4];
      out[r * cols + c] = weight * acc;
    }
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

template <typename T>
int launch_stencil5(const void* x0, int64_t rs0, int64_t cs0, const void* x1,
                    int64_t rs1, int64_t cs1, const void* x2, int64_t rs2,
                    int64_t cs2, const void* x3, int64_t rs3, int64_t cs3,
                    const void* x4, int64_t rs4, int64_t cs4, void* out,
                    int64_t rows, int64_t cols, double weight, void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaSuccess;
  stencil5_block_kernel<T><<<grid_for(rows, cols), kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const T*)x0, rs0, cs0, (const T*)x1, rs1, cs1, (const T*)x2, rs2, cs2,
      (const T*)x3, rs3, cs3, (const T*)x4, rs4, cs4, (T*)out, rows, cols,
      (T)weight);
  return (int)cudaGetLastError();
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

#define STENCIL5_ARGS                                                        \
  const void *x0, int64_t rs0, int64_t cs0, const void *x1, int64_t rs1,     \
      int64_t cs1, const void *x2, int64_t rs2, int64_t cs2, const void *x3, \
      int64_t rs3, int64_t cs3, const void *x4, int64_t rs4, int64_t cs4,    \
      void *out, int64_t rows, int64_t cols, double weight, void *stream
#define STENCIL5_PASS                                                       \
  x0, rs0, cs0, x1, rs1, cs1, x2, rs2, cs2, x3, rs3, cs3, x4, rs4, cs4, out, \
      rows, cols, weight, stream

extern "C" {

int stencil5_block_f32(STENCIL5_ARGS) {
  return launch_stencil5<float>(STENCIL5_PASS);
}

int stencil5_block_f64(STENCIL5_ARGS) {
  return launch_stencil5<double>(STENCIL5_PASS);
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

// A bounded stream gate for Hopper (sm_90a): one thread that holds its
// stream until the host opens the gate or a time limit passes.  It ports
// no TPU kernel; the executor's device clock (repro_torch/exec/backend.py,
// _DeviceClock) uses it so that a CUDA event pair around a payload times
// the payload's kernels and not the host.
//
// Built by nvcc into a shared library with a plain C interface and bound
// with ctypes (repro_torch/kernels/build.py); the Python wrapper is
// ../ops.py.
//
// Why: an event recorded on an idle stream runs at once, so a pair
// (start, payload, end) also counts the host's time from the start event
// to the payload's first kernel (Python dispatch, GIL waits among the
// workers), and from its last kernel to the end event.  Queued as
//   gate_wait(epoch), start, payload, end, then gate_open(epoch) on the host,
// the start event runs only once the whole payload is queued behind it,
// and the end event right after the payload's last kernel.
//
// The wait is bounded.  It spins on a system-scope load of the flag (a
// word of pinned host memory mapped into the device, written by the host
// with a release fence) until the flag reaches its epoch, or until
// %globaltimer says timeout_ns has passed since it started; then it
// counts the timeout, records its epoch and lets the stream go.  A
// payload that synchronises inside (waiting on the gate queued before its
// own kernels) waits out the limit once and runs; it is never stuck.  The
// flag only grows (epochs count up; the comparison wraps), so a gate that
// starts late finds a later epoch already open and passes.
//
// The count and the ring of timed-out epochs live in the same mapped
// block, written by the device and read by the host after an event that
// follows the gate has completed.  An executor queues all its gates on one
// stream, in order, so one gate runs at a time and the update needs no
// atomics (the host's memory takes no device atomics over PCIe).
//
// Cost on the card: one launch of one thread a payload.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kRing = 256;  // timed-out epochs kept

struct GateState {
  uint32_t flag;              // the open epoch; written by the host
  uint32_t pad;
  uint64_t timeouts;          // written by the device
  uint32_t epochs[kRing];     // epoch of timeout n at n % kRing
};

__device__ __forceinline__ uint32_t load_flag(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void gate_wait_kernel(GateState* st, uint32_t epoch, uint64_t timeout_ns) {
  const uint64_t t0 = global_ns();
  while (static_cast<int32_t>(load_flag(&st->flag) - epoch) < 0) {
    if (global_ns() - t0 > timeout_ns) {
      const uint64_t n = st->timeouts;
      st->epochs[n % kRing] = epoch;
      st->timeouts = n + 1;
      __threadfence_system();
      return;
    }
    __nanosleep(200);
  }
}

}  // namespace

extern "C" {

int gate_ring() { return kRing; }

// a zeroed gate: *host for the host's reads and writes, *dev for the kernel
int gate_create(void** host, void** dev) {
  void* h = nullptr;
  cudaError_t err = cudaHostAlloc(&h, sizeof(GateState), cudaHostAllocMapped);
  if (err != cudaSuccess) return (int)err;
  memset(h, 0, sizeof(GateState));
  err = cudaHostGetDevicePointer(dev, h, 0);
  if (err != cudaSuccess) {
    cudaFreeHost(h);
    return (int)err;
  }
  *host = h;
  return 0;
}

// call only once no gate of this state can still run
int gate_destroy(void* host) { return (int)cudaFreeHost(host); }

int gate_wait(void* dev, uint32_t epoch, uint64_t timeout_ns, void* stream) {
  gate_wait_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(static_cast<GateState*>(dev), epoch,
                                                       timeout_ns);
  return (int)cudaGetLastError();
}

void gate_open(void* host, uint32_t epoch) {
  __atomic_store_n(&static_cast<GateState*>(host)->flag, epoch, __ATOMIC_RELEASE);
}

uint64_t gate_timeouts(void* host) {
  return __atomic_load_n(&static_cast<GateState*>(host)->timeouts, __ATOMIC_ACQUIRE);
}

uint32_t gate_timed_out_epoch(void* host, uint64_t n) {
  return static_cast<GateState*>(host)->epochs[n % kRing];
}

}  // extern "C"

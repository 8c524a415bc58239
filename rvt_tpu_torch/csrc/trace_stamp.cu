// trace_stamp: the layer marks of a captured step (utils/timers.py), as
// kernel nodes of its CUDA graph that write the device's clock into a
// ring of rows the graph owns, one row a replay.
//
// Not a TPU kernel: the JAX package has no layer marks inside its jitted
// steps. A timing event recorded inside a graph is recorded again at
// every replay, so the host would have to read a replay's marks before
// it launches the next one, and wait for them. Here a replay writes its
// own row of the ring instead: row slot % R, where slot [1] int32 is a
// counter on the device that the step's last mark advances. The host
// counts its replays as well, and reads replay k's row once an event it
// recorded after that replay is done, any time before replay k + R.
//
// rvt_trace_stamp: stamps [R, M] int64 gets %globaltimer (ns) at column
// i of the current row; with advance, slot then moves on.
// rvt_trace_keep: ring [n, R] int32 gets src [n] int32 (a counter of the
// step, such as NMS's candidates) in column slot % R (ring points at the
// counter's first element: the counters lie one after another, each
// element a row of R slots, so the host copies the elements in use as one
// block). The rings are allocated before the capture: memory taken inside
// it may be an intermediate that earlier nodes of the graph write at every
// replay.
//
// Design: one block of 32 threads; the stream orders a stamp after every
// node captured before it and before every node captured after it, as a
// timing event's node would be.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 32;

__global__ void __launch_bounds__(THREADS)
stamp_kernel(long long* __restrict__ stamps, int* __restrict__ slot, int i,
             int M, int R, int advance) {
  if (threadIdx.x != 0) return;
  const int s = *slot;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  stamps[(long)(s % R) * M + i] = (long long)t;
  if (advance) *slot = s + 1;
}

__global__ void __launch_bounds__(THREADS)
keep_kernel(const int* __restrict__ src, int* __restrict__ ring,
            const int* __restrict__ slot, int n, int R) {
  const int s = *slot % R;
  for (int j = threadIdx.x; j < n; j += THREADS)
    ring[(long)j * R + s] = src[j];
}

}  // namespace

extern "C" int rvt_trace_stamp(void* stamps, void* slot, int i, int M, int R,
                               int advance, void* stream) {
  stamp_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(
      (long long*)stamps, (int*)slot, i, M, R, advance);
  return (int)cudaGetLastError();
}

extern "C" int rvt_trace_keep(const void* src, void* ring, const void* slot,
                              int n, int R, void* stream) {
  if (n > 0)
    keep_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)src, (int*)ring, (const int*)slot, n, R);
  return (int)cudaGetLastError();
}

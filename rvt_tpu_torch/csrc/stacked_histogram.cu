// stacked_histogram: raw events -> [B, 2*bins, H, W] uint8 event frames.
//
// Replaces the TPU kernel rvt_tpu/ops/voxelization.py:_hist_tile_kernel
// (called by stacked_histogram_pallas_batched). Semantics are that
// kernel's: lane b's event i counts when i < counts[b], 0 <= x < W,
// 0 <= y < H and p in {0, 1}; every other event is dropped (the XLA
// scatter of the JAX package would row-alias an overflowing x instead).
// The time bin of an event is floor((t - t0) / max(t1 - t0, 1) * bins),
// clipped to [0, bins), with t0 = t[b, 0] and t1 = t[b, max(counts, 1) - 1],
// computed in f32 with IEEE division and no contraction, so the bins equal
// JAX's bit for bit. Counts saturate at ``cutoff`` (<= 255).
//
// Bound on the H100: bytes. The work is 4 int32 reads per event (4 MB
// for 8 x 32768 events) and one uint8 write per output bin (11.7 MB for
// gen1's [8, 20, 240, 304]): about 4.7 us at 3.35 TB/s; the arithmetic is
// a few operations per event. The TPU sorted events by tile and summed
// one-hot products on its matrix unit because it cannot scatter; Hopper
// can. This first design is the simple one: the launcher zeroes an int32
// scratch histogram, ``scatter`` adds 1 per kept event with a global
// atomicAdd (integer sums do not depend on the order of the atomics, so
// the result equals the plain version exactly), and ``narrow`` saturates
// and writes uint8, 16 bins per thread. Counting in 32 bits keeps a pixel
// that takes thousands of events from wrapping. The scratch is written
// (zeroed) and read once more, 8 bytes per bin beside the scattered
// atomics: ~109 MB at gen1's shape, ~7x the bound's 15.7 MB.
// Privatised counters in shared memory or packed 16-bit counters would
// cut that.
#include "common.cuh"

__global__ void __launch_bounds__(256)
scatter_kernel(const int* __restrict__ x, const int* __restrict__ y,
               const int* __restrict__ p, const int* __restrict__ t,
               const int* __restrict__ counts, int* __restrict__ hist, int N,
               int bins, int H, int W) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = counts[b];
  if (i >= N || i >= n) return;
  const long long e = (long long)b * N + i;
  const int xi = x[e], yi = y[e], pi = p[e];
  if (xi < 0 || xi >= W || yi < 0 || yi >= H || pi < 0 || pi > 1) return;
  const int* tb = t + (long long)b * N;
  const int last = min(max(n, 1) - 1, N - 1);
  // int32 differences wrap as in JAX; the unsigned casts keep that defined
  const int t0 = tb[0];
  const int span = (int)((unsigned)tb[last] - (unsigned)t0);
  const float denom = (float)max(span, 1);
  const float tn = __fdiv_rn((float)(int)((unsigned)t[e] - (unsigned)t0),
                             denom);
  const float f = fminf(fmaxf(floorf(__fmul_rn(tn, (float)bins)), 0.f),
                        (float)(bins - 1));
  const long long plane = (long long)2 * bins * H * W;
  const long long bin = (((long long)pi * bins + (int)f) * H + yi) * W + xi;
  atomicAdd(hist + b * plane + bin, 1);
}

// 16 bins per thread: four int4 loads, one 16-byte store. total % 16 == 0.
__global__ void __launch_bounds__(256)
narrow_kernel(const int4* __restrict__ hist, uint4* __restrict__ out,
              long long n16, int cutoff) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n16) return;
  unsigned w[4];
  for (int k = 0; k < 4; ++k) {
    const int4 v = hist[4 * i + k];
    w[k] = (unsigned)min(v.x, cutoff) | ((unsigned)min(v.y, cutoff) << 8) |
           ((unsigned)min(v.z, cutoff) << 16) |
           ((unsigned)min(v.w, cutoff) << 24);
  }
  out[i] = make_uint4(w[0], w[1], w[2], w[3]);
}

// Scalar tail for a total that is not a multiple of 16.
__global__ void narrow_tail_kernel(const int* __restrict__ hist,
                                   uint8_t* __restrict__ out, long long start,
                                   long long total, int cutoff) {
  const long long i = start + (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < total) out[i] = (uint8_t)min(hist[i], cutoff);
}

extern "C" int rvt_stacked_histogram(const void* x, const void* y,
                                     const void* p, const void* t,
                                     const void* counts, void* scratch,
                                     void* out, int B, int N, int bins, int H,
                                     int W, int cutoff, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long total = (long long)B * 2 * bins * H * W;
  cudaError_t err = cudaMemsetAsync(scratch, 0, total * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  if (N > 0) {
    dim3 grid((N + 255) / 256, B);
    scatter_kernel<<<grid, 256, 0, st>>>(
        (const int*)x, (const int*)y, (const int*)p, (const int*)t,
        (const int*)counts, (int*)scratch, N, bins, H, W);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long n16 = total / 16;
  if (n16 > 0) {
    narrow_kernel<<<(unsigned)((n16 + 255) / 256), 256, 0, st>>>(
        (const int4*)scratch, (uint4*)out, n16, cutoff);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long rest = total - 16 * n16;
  if (rest > 0) {
    narrow_tail_kernel<<<1, 32, 0, st>>>((const int*)scratch, (uint8_t*)out,
                                         16 * n16, total, cutoff);
  }
  return (int)cudaGetLastError();
}

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
// JAX's bit for bit. t need not be sorted. Counts saturate at ``cutoff``
// (<= 255).
//
// Bound on the H100: bytes. The work is 4 int32 reads per event (4 MB
// for 8 x 32768 events) and one uint8 write per output bin (11.7 MB for
// gen1's [8, 20, 240, 304]): about 4.7 us at 3.35 TB/s; the arithmetic is
// a few operations per event.
//
// Design: the Hopper counterpart of the TPU kernel's sort by output tile.
// The flat output [B * 2*bins*H*W] is cut into tiles of kTileBins bins
// (``voxelization.histogram_plan``), each small enough that its int32
// counters fit in one block's shared memory. Two launches:
//   bucket  each block takes a run of one lane's events, computes each
//           event's flat bin, and sorts its events by tile in shared
//           memory: a count per tile, their exclusive scan, each
//           kept event's 16-bit in-tile index at its tile's offset; it
//           writes the sorted run to the chunk array in 16-byte stores,
//           and (offset, count) for each tile its lane touches to a
//           [blocks, span] table;
//   tile    one block a tile: zero the counters in shared memory (16
//           bits, two a word: 48 KB, four blocks an SM, so the gen1 raw
//           cell's 475 tiles run in one wave); each warp takes the
//           segments of the chunk array that the event blocks of the
//           tile's lane (or lanes) wrote for this tile and adds one per
//           entry; saturate, and write the tile's uint8 bins once, in
//           coalesced 4-byte stores. A tile whose segments hold more than
//           65,535 entries (known once they are counted) counts them again
//           in 32 bits, half the tile at a time, so no counter wraps into
//           its neighbour.
// The tile kernel is a programmatic dependent launch: its blocks are
// scheduled, and zero their counters, while the bucket grid runs. No global atomics, no
// scan across blocks, nothing to zero between calls: traffic is the events read once, 2 bytes an event of chunk
// written and read back (from L2), the small table, and each output byte
// written once; no int32 histogram in device memory and no memset. Each
// thread loads all its events, with its lane's count, before its first
// atomic, so a block's loads are in flight together. Integer sums do not depend on the order
// of the atomics, so the result equals the plain version exactly. Equal
// keys within a warp (one pixel that takes a whole
// lane, one tile that takes a block's events) are added once by their
// leader (``__match_any_sync``), so contention costs one atomic a warp.
// The table and the chunk array are a workspace the wrapper keeps from
// call to call, sized by the plan.
#include "common.cuh"

namespace {

constexpr int kEventThreads = 256;
constexpr int kEventsPerThread = 4;  // histogram_plan's events a block / 256
constexpr int kEventsPerBlock = kEventThreads * kEventsPerThread;
constexpr int kTileThreads = 256;
// Bins a tile (voxelization.HIST_TILE_BINS), counted in 16 bits, two a
// word: 48 KB of shared memory, four tile blocks an SM. A tile with more
// entries than a 16-bit counter can take counts in 32 bits, half the tile
// at a time. In-tile indices fit 16 bits. A compile-time constant, so
// that the bin -> tile divisions are multiplies.
constexpr int kTileBins = 24576;
constexpr int kTileWords = kTileBins / 2;
constexpr int kNarrowMax = 65535;
// The most tiles a lane's plane may touch (the bucket kernel's two tables
// beside its 2 KB of sorted indices in the 48 KB of static shared memory):
// histogram_plan keeps within it.
constexpr int kMaxSpan = 5632;
constexpr unsigned kFull = 0xffffffffu;

struct Lane {
  int n;        // events of the lane that may count: min(counts, N)
  int t0;       // t[b, 0]
  float denom;  // max(t1 - t0, 1) in f32
};

__device__ __forceinline__ Lane lane_of(const int* __restrict__ t,
                                        const int* __restrict__ counts,
                                        int b, int N) {
  const int c = counts[b];
  const int* tb = t + (long long)b * N;
  const int last = min(max(c, 1) - 1, N - 1);
  Lane L;
  L.n = min(c, N);
  // int32 differences wrap as in JAX; the unsigned casts keep that defined
  L.t0 = N > 0 ? tb[0] : 0;
  const int span = N > 0 ? (int)((unsigned)tb[last] - (unsigned)L.t0) : 0;
  L.denom = (float)max(span, 1);
  return L;
}

// The four fields of lane b's event i (zeros past N). The loads do not
// wait for the lane's count: they go out with the count's own load.
struct Event {
  int x, y, p, t;
};

__device__ __forceinline__ Event load_event(
    const int* __restrict__ x, const int* __restrict__ y,
    const int* __restrict__ p, const int* __restrict__ t, int b, int i,
    int N) {
  if (i >= N) return Event{0, 0, 0, 0};
  const long long e = (long long)b * N + i;
  return Event{x[e], y[e], p[e], t[e]};
}

// Event i of its lane: its bin in the lane's [2*bins*H*W] plane, or -1
// when it is dropped.
__device__ __forceinline__ int event_bin(const Event& v, const Lane& L,
                                         int i, int bins, int H, int W) {
  if (i >= L.n || v.x < 0 || v.x >= W || v.y < 0 || v.y >= H || v.p < 0 ||
      v.p > 1)
    return -1;
  const float tn = __fdiv_rn((float)(int)((unsigned)v.t - (unsigned)L.t0),
                             L.denom);
  const float f = fminf(fmaxf(floorf(__fmul_rn(tn, (float)bins)), 0.f),
                        (float)(bins - 1));
  return ((v.p * bins + (int)f) * H + v.y) * W + v.x;
}

// Adds one to ctr[key] for every active lane of the warp; lanes with equal
// keys are added once, by their lowest lane. Returns the lane's rank among
// the increments of ctr[key] (the counter's old value plus the active
// lanes with the same key below it). Every lane of the warp must call it.
__device__ __forceinline__ int warp_add(int* ctr, int key, bool active) {
  const unsigned act = __ballot_sync(kFull, active);
  int rank = 0;
  if (active) {
    const unsigned peers = __match_any_sync(act, key);
    const int lane = threadIdx.x & 31;
    const int leader = __ffs(peers) - 1;
    int old = 0;
    if (lane == leader) old = atomicAdd(ctr + key, __popc(peers));
    old = __shfl_sync(peers, old, leader);
    rank = old + __popc(peers & ((1u << lane) - 1u));
  }
  return rank;
}

// The same count without the rank, into 16-bit counters two a word
// (``narrow``: bin key in the half key & 1 of word key >> 1) or 32-bit
// ones.
__device__ __forceinline__ void warp_count(unsigned* ctr, int key,
                                           bool active, bool narrow) {
  const unsigned act = __ballot_sync(kFull, active);
  if (active) {
    const unsigned peers = __match_any_sync(act, key);
    if ((threadIdx.x & 31) == __ffs(peers) - 1) {
      if (narrow)
        atomicAdd(ctr + (key >> 1), (unsigned)__popc(peers) << (16 * (key & 1)));
      else
        atomicAdd(ctr + key, (unsigned)__popc(peers));
    }
  }
}

// The first tile lane b's plane touches.
__device__ __forceinline__ int first_tile(int b, long long plane) {
  return (int)(b * plane / kTileBins);
}

// floor(a / d) for 0 <= a < 2^53, d > 0, without a 64-bit division: a
// float estimate, then exact integer corrections.
__device__ __forceinline__ int floor_div(long long a, long long d) {
  long long q = (long long)((double)a / (double)d);
  while (q * d > a) --q;
  while ((q + 1) * d <= a) ++q;
  return (int)q;
}

// Block (e, b): events [e, e+1) * kEventsPerBlock of lane b.
// table[(b * gridDim.x + e) * span + k] = (offset, count) of local tile k
// (tile first_tile(b) + k) in this block's run of ``chunk``.
__global__ void __launch_bounds__(kEventThreads)
bucket_kernel(const int* __restrict__ x, const int* __restrict__ y,
              const int* __restrict__ p, const int* __restrict__ t,
              const int* __restrict__ counts, int2* __restrict__ table,
              uint16_t* __restrict__ chunk, int N, int bins, int H, int W,
              int span) {
  extern __shared__ int sm[];
  int* cnt = sm;          // [span] this block's events a tile
  int* off = sm + span;   // [span] their offset in the block's run
  __shared__ __align__(16) uint16_t sorted[kEventsPerBlock];
  // the tile kernel's blocks may be scheduled from now on (each waits
  // for this grid to end before it reads what it wrote)
  asm volatile("griddepcontrol.launch_dependents;");
  const int b = blockIdx.y;
  const long long plane = (long long)2 * bins * H * W;
  const int i0 = blockIdx.x * kEventsPerBlock + threadIdx.x;
  Event ev[kEventsPerThread];
#pragma unroll
  for (int j = 0; j < kEventsPerThread; ++j)
    ev[j] = load_event(x, y, p, t, b, i0 + j * kEventThreads, N);
  const Lane L = lane_of(t, counts, b, N);
  // the lane's plane starts `rem` bins into its first tile: an event's
  // local tile and in-tile index follow in 32 bits
  const int rem = (int)(b * plane % kTileBins);
  for (int k = threadIdx.x; k < span; k += kEventThreads) cnt[k] = 0;
  __syncthreads();
  int key[kEventsPerThread], rank[kEventsPerThread];
  uint16_t idx[kEventsPerThread];
#pragma unroll
  for (int j = 0; j < kEventsPerThread; ++j) {
    const int bin = event_bin(ev[j], L, i0 + j * kEventThreads, bins, H, W);
    const unsigned r = (unsigned)rem + (unsigned)bin;
    key[j] = bin < 0 ? -1 : (int)(r / kTileBins);
    idx[j] = (uint16_t)(r - (unsigned)key[j] * kTileBins);
    rank[j] = warp_add(cnt, key[j] < 0 ? 0 : key[j], bin >= 0);
  }
  __syncthreads();
  if (threadIdx.x < 32) {  // off = the exclusive scan of cnt, by one warp
    const int lane = threadIdx.x, per = (span + 31) / 32;
    const int lo = min(lane * per, span), hi = min(lo + per, span);
    int sum = 0;
    for (int k = lo; k < hi; ++k) sum += cnt[k];
    int incl = sum;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += u;
    }
    int run = incl - sum;
    for (int k = lo; k < hi; ++k) {
      off[k] = run;
      run += cnt[k];
    }
  }
  __syncthreads();
  const long long blk = (long long)b * gridDim.x + blockIdx.x;
  for (int k = threadIdx.x; k < span; k += kEventThreads)
    table[blk * span + k] = make_int2(off[k], cnt[k]);
  // sorted in shared memory, then written out in 16-byte stores
#pragma unroll
  for (int j = 0; j < kEventsPerThread; ++j)
    if (key[j] >= 0) sorted[off[key[j]] + rank[j]] = idx[j];
  __syncthreads();
  uint4* run = (uint4*)(chunk + blk * kEventsPerBlock);
  for (int v = threadIdx.x; v < kEventsPerBlock / 8; v += kEventThreads)
    run[v] = ((const uint4*)sorted)[v];
}

// The table entry of segment s of tile k: event block s % event_blocks
// of lane b_lo + s / event_blocks.
__device__ __forceinline__ long long segment(int s, int k, int b_lo,
                                             int event_blocks, int span,
                                             long long plane, long long* blk) {
  const int b = b_lo + s / event_blocks;
  *blk = (long long)b * event_blocks + s % event_blocks;
  return *blk * span + (k - first_tile(b, plane));
}

// Adds the entries of the tile's segments (the runs one event block wrote
// for this tile) whose in-tile index i has i - lo in [0, n) to ``ctr``:
// one warp a segment, kSegs segments a warp a round; their table entries,
// then the first 64 entries of each, in flight together. Returns the
// warp's sum of the segments' counts.
template <int kSegs>
__device__ __forceinline__ int count_segments(
    unsigned* ctr, const int2* __restrict__ table,
    const uint16_t* __restrict__ chunk, int k, int segs, int b_lo,
    int event_blocks, int span, long long plane, int lo, int n,
    bool narrow) {
  constexpr int kWarps = kTileThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int entries = 0;
  for (int s0 = warp; s0 < segs; s0 += kWarps * kSegs) {  // warp-uniform
    int2 oc[kSegs];
    const uint16_t* seg[kSegs];
#pragma unroll
    for (int q = 0; q < kSegs; ++q) {
      const int s = s0 + q * kWarps;
      oc[q] = make_int2(0, 0);
      seg[q] = chunk;
      if (s < segs) {
        long long blk;
        oc[q] = table[segment(s, k, b_lo, event_blocks, span, plane, &blk)];
        seg[q] = chunk + blk * kEventsPerBlock + oc[q].x;
      }
      entries += oc[q].y;
    }
    int v[kSegs][2];
#pragma unroll
    for (int q = 0; q < kSegs; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = h * 32 + lane;
        v[q][h] = i < oc[q].y ? (int)seg[q][i] - lo : -1;
      }
#pragma unroll
    for (int q = 0; q < kSegs; ++q) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        warp_count(ctr, v[q][h], (unsigned)v[q][h] < (unsigned)n, narrow);
      for (int i0 = 64; i0 < oc[q].y; i0 += 32) {  // warp-uniform
        const int e = i0 + lane < oc[q].y ? (int)seg[q][i0 + lane] - lo : -1;
        warp_count(ctr, e, (unsigned)e < (unsigned)n, narrow);
      }
    }
  }
  return entries;
}

// Saturates counters [0, n) and writes them as uint8 bins [lo, lo + n) of
// tile k: four bins a thread, one 4-byte store, the warp's stores 128
// contiguous bytes.
__device__ __forceinline__ void write_bins(const unsigned* ctr,
                                           uint8_t* __restrict__ out,
                                           long long start, int lo, int n,
                                           bool narrow, unsigned cutoff) {
  unsigned* o = (unsigned*)(out + start + lo);
  for (int i = threadIdx.x; i < n / 4; i += kTileThreads) {
    unsigned c0, c1, c2, c3;
    if (narrow) {
      const uint2 w = ((const uint2*)ctr)[i];
      c0 = w.x & 0xffffu, c1 = w.x >> 16, c2 = w.y & 0xffffu, c3 = w.y >> 16;
    } else {
      const uint4 w = ((const uint4*)ctr)[i];
      c0 = w.x, c1 = w.y, c2 = w.z, c3 = w.w;
    }
    o[i] = min(c0, cutoff) | (min(c1, cutoff) << 8) |
           (min(c2, cutoff) << 16) | (min(c3, cutoff) << 24);
  }
  // the last tile's bins past a multiple of 4
  for (int r = n / 4 * 4 + threadIdx.x; r < n; r += kTileThreads) {
    const unsigned c = narrow ? (ctr[r >> 1] >> (16 * (r & 1))) & 0xffffu
                              : ctr[r];
    out[start + lo + r] = (uint8_t)min(c, cutoff);
  }
}

// Block k: bins [k, k+1) * kTileBins of the flat output.
__global__ void __launch_bounds__(kTileThreads, 4)
tile_kernel(const int2* __restrict__ table,
            const uint16_t* __restrict__ chunk, uint8_t* __restrict__ out,
            int B, int bins, int H, int W, int span, int event_blocks,
            int cutoff) {
  extern __shared__ uint4 ctr4[];  // [kTileWords / 4] counters
  unsigned* ctr = (unsigned*)ctr4;
  __shared__ int warp_sums[kTileThreads / 32];
  const long long plane = (long long)2 * bins * H * W;
  const long long total = B * plane;
  const int k = blockIdx.x;
  const long long start = (long long)k * kTileBins;
  const int len = (int)min((long long)kTileBins, total - start);
  const int b_lo = floor_div(start, plane);
  const int b_hi = floor_div(start + len - 1, plane);
  const int segs = (b_hi - b_lo + 1) * event_blocks;
  // the counters zeroed while the bucket grid may still run (this block
  // can start before it ends: a programmatic dependent launch); then,
  // the table and chunk complete, the tile counted in 16 bits
  for (int v = threadIdx.x; v < kTileWords / 4; v += kTileThreads)
    ctr4[v] = make_uint4(0, 0, 0, 0);
  asm volatile("griddepcontrol.wait;" ::: "memory");
  __syncthreads();
  const int mine = count_segments<4>(ctr, table, chunk, k, segs, b_lo,
                                     event_blocks, span, plane, 0, len,
                                     true);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = mine;
  __syncthreads();
  int entries = 0;
  for (int w = 0; w < kTileThreads / 32; ++w) entries += warp_sums[w];
  if (entries <= kNarrowMax) {
    write_bins(ctr, out, start, 0, len, true, (unsigned)cutoff);
    return;
  }
  // more entries than a 16-bit counter can take: count again in 32
  // bits, half the tile at a time
  for (int lo = 0; lo < len; lo += kTileWords) {
    __syncthreads();
    for (int v = threadIdx.x; v < kTileWords / 4; v += kTileThreads)
      ctr4[v] = make_uint4(0, 0, 0, 0);
    __syncthreads();
    const int n = min(kTileWords, len - lo);
    count_segments<4>(ctr, table, chunk, k, segs, b_lo, event_blocks, span,
                      plane, lo, n, false);
    __syncthreads();
    write_bins(ctr, out, start, lo, n, false, (unsigned)cutoff);
  }
}

}  // namespace

// table: the workspace's int2 [B * event_blocks * span]; chunk: uint16
// [B * event_blocks * histogram_plan's events a block]. The plan
// (tile_bins == kTileBins, tiles, span, event_blocks >= 1) is
// ``voxelization.histogram_plan``'s. Launches two kernels on ``stream``.
extern "C" int rvt_stacked_histogram(
    const void* x, const void* y, const void* p, const void* t,
    const void* counts, void* table, void* chunk, void* out, int B, int N,
    int bins, int H, int W, int cutoff, int tile_bins, int tiles, int span,
    int event_blocks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (tile_bins != kTileBins || tiles < 1 || span < 1 || span > kMaxSpan ||
      event_blocks < 1 || (long long)event_blocks * kEventsPerBlock < N)
    return (int)cudaErrorInvalidValue;
  // once: room for the tile's 48 KB of counters beside the static shared
  // memory, and all of the SM's L1 as shared memory, so that four tile
  // blocks are resident an SM
  static bool attrs_set = false;
  if (!attrs_set) {
    cudaError_t e = cudaFuncSetAttribute(
        tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kTileWords * (int)sizeof(unsigned));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(tile_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    attrs_set = true;
  }
  bucket_kernel<<<dim3(event_blocks, B), kEventThreads,
                  2 * span * sizeof(int), st>>>(
      (const int*)x, (const int*)y, (const int*)p, (const int*)t,
      (const int*)counts, (int2*)table, (uint16_t*)chunk, N, bins, H, W,
      span);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // programmatic dependent launch: the tile blocks start, and zero their
  // counters, as the bucket blocks finish; griddepcontrol.wait holds
  // their reads until the bucket grid has ended
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles);
  cfg.blockDim = dim3(kTileThreads);
  cfg.dynamicSmemBytes = kTileWords * sizeof(unsigned);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, tile_kernel, (const int2*)table,
                           (const uint16_t*)chunk, (uint8_t*)out, B, bins,
                           H, W, span, event_blocks, cutoff);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

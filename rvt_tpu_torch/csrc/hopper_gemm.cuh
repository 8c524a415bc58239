// The Hopper GEMM mainloop shared by K2 (gemm_bf16.cu) and K6
// (gemm_bf16_wgrad.cu): bf16 operands moved by the Tensor Memory
// Accelerator (TMA) into a ring of shared-memory stages, multiplied by
// warpgroup MMAs (wgmma) into f32 registers, in a persistent grid.
//
//   * Tensor maps: every operand is a 2-D row-major bf16 array read in
//     boxes whose inner extent is 64 elements (128 bytes), with the
//     128-byte swizzle. TMA zero-fills what lies past the array, so ragged
//     M, N and K need no masking on the load side. The encoder,
//     cuTensorMapEncodeTiled, is a driver function; it is fetched through
//     cudaGetDriverEntryPoint so that the library links the runtime only.
//   * Ring: STAGES k-tiles of 64 (A: BM x 64, B: BN x 64, in either
//     major-ness), each with a "full" mbarrier (the producer's expected
//     bytes, completed by the TMA) and an "empty" one (one arrival per
//     consumer warp once the wgmma that read the stage has retired).
//   * Roles: consumer warpgroups (the first 128 per consumer threads),
//     then one producer warpgroup whose first thread issues every TMA
//     copy. With two or three consumer warpgroups the producer gives
//     registers back (setmaxnreg): the block's pool (168 or 128 registers
//     a thread at launch) then holds 40 for the producer and 232 or 152
//     for each consumer (a 64 x 256 or 64 x 128 f32 accumulator and its
//     epilogue).
//   * Persistent: gridDim.x = min(tiles, SMs) blocks walk the output tiles
//     t = blockIdx.x, blockIdx.x + gridDim.x, ...; the producer runs ahead
//     into the next tiles while the consumers run an epilogue.
//   * Two schedules of the consumers:
//     - cooperative (run; K6, and K2 where its epilogue or mainloop sets
//       the pace): WG (1-3) warpgroups each own 64 rows of every tile, so
//       all of them wait on each k-tile, issue their products at once,
//       then all run the epilogue while the tensor cores idle;
//     - ping-pong (run_pingpong; K2 where the epilogue's memory traffic
//       sets the pace): two warpgroups each own whole 64-row tiles, the
//       block's tiles dealt in turn. A warpgroup issues its products only
//       in its turn, handed on through named barriers once the previous
//       tile's warpgroup has issued all of its own, so one warpgroup's
//       epilogue runs under the next one's loads and products. Each
//       k-tile is read by one warpgroup; each steps over the other's
//       k-tiles in the ring, which the producer fills in tile order.
//   * Epilogue: a consumer warpgroup moves its accumulator, 64 columns at
//     a time, into its own staging tile in shared memory (f32, or bf16
//     where the problem's epilogue starts by rounding the sum:
//     P::STAGE_BF16), then the problem's epilogue reads the tile
//     row-major (coalesced stores).
//
// A problem P supplies: TA / TB (wgmma's transpose immediates: 0 for a
// K-major operand, 1 for an MN-major one), STAGE_BF16, tiles(), tile(t)
// -> {.ktiles, ...}, load(tile, kt, a_smem, b_smem, bar) (run by the
// producer thread: one TMA copy per box, A_BYTES + B_BYTES in all),
// desc_a(a_smem, s, k16) and desc_b(b_smem, i, k16) (the shared-memory
// descriptors of the tile's s-th 64-row slice and of the i-th WN-wide
// column slice, advanced to the k16-th 16-deep step of the k-tile) and
// epilogue(tile, s, chunk, Cs).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)

#include "common.cuh"

namespace hg {

constexpr int BK = 64;            // k-tile depth: 64 bf16 = 128 bytes
constexpr int EPI_N = 64;         // columns per epilogue chunk
constexpr int EPI_LD = EPI_N + 4; // f32 row stride of a staging tile
constexpr int EPI_LDB = EPI_N + 8; // bf16 row stride of a bf16 staging tile
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory of one block
constexpr int MAX_STAGES = 6;

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a row-major bf16 [rows, cols] array read in boxes of
// box_rows x box_cols (box_cols * 2 <= 128 bytes), 128-byte swizzle.
inline bool make_map(CUtensorMap* map, const void* base, uint64_t rows,
                     uint64_t cols, uint32_t box_rows, uint32_t box_cols) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  cuuint64_t dims[2] = {cols, rows};
  cuuint64_t strides[1] = {cols * sizeof(bf16)};
  cuuint32_t box[2] = {box_cols, box_rows};
  cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline int device_index() {
  int dev = 0;
  cudaGetDevice(&dev);
  return dev;
}

inline int sm_count() {
  static int cached[64] = {0};
  const int dev = device_index();
  if (dev < 64 && cached[dev] > 0) return cached[dev];
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (dev < 64) cached[dev] = n;
  return n;
}

// Ring depth and dynamic shared memory of tiles of SL 64-row slices by
// BN columns, read by NC consumer warpgroups (each with its own staging
// tile): the cooperative schedule has NC = SL, one slice a warpgroup.
template <int SL, int BN, int NC = SL>
struct Plan {
  static constexpr int BM = 64 * SL;
  static constexpr int A_BYTES = BM * BK * 2, B_BYTES = BN * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int EPI_BYTES = NC * 64 * EPI_LD * 4;
  static constexpr int FIT =
      (SMEM_LIMIT - 1024 - EPI_BYTES - 2 * MAX_STAGES * 8) / STAGE_BYTES;
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + EPI_BYTES +
                              2 * STAGES * 8;
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int WN = BN >= 128 ? 128 : 64;  // wgmma N per slice
  static_assert(STAGES >= 2, "the ring needs two stages");
};

// cudaFuncSetAttribute once per kernel and device (``ready``: the
// caller's mask of devices done, one per kernel), then the launch of
// min(tiles, SMs) blocks; returns cudaGetLastError() after it.
template <typename Kernel, typename... Args>
int launch_persistent(Kernel kernel, unsigned long long& ready, int smem,
                      int threads, long tiles, cudaStream_t st,
                      Args... args) {
  if (tiles <= 0) return (int)cudaSuccess;
  const int dev = device_index();
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!(ready >> dev & 1ull)) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    ready |= 1ull << dev;
  }
  const long sms = sm_count();
  const int grid = (int)(tiles < sms ? tiles : sms);
  kernel<<<grid, threads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Device side: barriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase differs from ``parity``. A wait that never
// ends (a lost transaction) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t tries = 0;; ++tries) {
    uint32_t ok;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(bar), "r"(parity)
        : "memory");
    if (ok) return;
    if (tries == (1u << 25)) __trap();
  }
}

// One box of ``map`` at element coordinates (c0 innermost, c1) into
// shared memory at ``dst``; completes its bytes on ``bar``.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Arrive on named barrier ``id`` without waiting: the other
// ``threads`` minus these wait on it with named_sync.
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Shared-memory matrix descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (in 16-byte units), layout 1.
// K-major: rows of 64 k, SBO = 1024 (8 rows), LBO unused; MN-major: rows
// of 64 m or n per k, SBO = 1024 (8 k), LBO = the next 64-wide m/n box.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma instructions.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x N] (+)= A[64 x 16] . B[16 x N], bf16 in, f32 accumulate;
// scale_d = 0 overwrites D. TA / TB: 1 for an MN-major operand.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int WN, int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[WN / 2], uint64_t da,
                                      uint64_t db, int scale_d) {
  if constexpr (WN == 128)
    wgmma_n128<TA, TB>(d, da, db, scale_d);
  else
    wgmma_n64<TA, TB>(d, da, db, scale_d);
}

// Columns [64 * C, 64 * C + 64) of a consumer warpgroup's accumulator
// into its staging tile Cs [64][EPI_LD]. wgmma's f32 fragment: thread
// (warp w, lane l) holds, for each 8-column group j of a slice, rows
// 16w + l/4 (+8) at columns 8j + 2(l%4) (+1).
template <int C, int NS, int WN>
__device__ __forceinline__ void stage_chunk(float (&acc)[NS][WN / 2],
                                            float* Cs) {
  const int t = threadIdx.x % 128, w = t / 32, l = t % 32;
  const int r = 16 * w + l / 4, cc = 2 * (l % 4);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    constexpr int per = WN / 8;  // 8-column groups per slice
    const int J = 8 * C + j;
    const int i = J / per, jj = J % per;
    float* p = Cs + r * EPI_LD + 8 * j + cc;
    *reinterpret_cast<float2*>(p) =
        make_float2(acc[i][4 * jj], acc[i][4 * jj + 1]);
    *reinterpret_cast<float2*>(p + 8 * EPI_LD) =
        make_float2(acc[i][4 * jj + 2], acc[i][4 * jj + 3]);
  }
}

// stage_chunk rounding each sum to bf16, into a bf16 staging tile Cb
// [64][EPI_LDB] (a problem whose epilogue starts by rounding the sum:
// P::STAGE_BF16): each pair of neighbouring columns as one bf16x2, half
// the shared-memory traffic. Both this store and the epilogue's 16-byte
// row reads are free of bank conflicts at the 144-byte row stride.
template <int C, int NS, int WN>
__device__ __forceinline__ void stage_chunk_bf16(float (&acc)[NS][WN / 2],
                                                 bf16* Cb) {
  const int t = threadIdx.x % 128, w = t / 32, l = t % 32;
  const int r = 16 * w + l / 4, cc = 2 * (l % 4);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    constexpr int per = WN / 8;  // 8-column groups per slice
    const int J = 8 * C + j;
    const int i = J / per, jj = J % per;
    bf16* p = Cb + r * EPI_LDB + 8 * j + cc;
    *reinterpret_cast<__nv_bfloat162*>(p) =
        __floats2bfloat162_rn(acc[i][4 * jj], acc[i][4 * jj + 1]);
    *reinterpret_cast<__nv_bfloat162*>(p + 8 * EPI_LDB) =
        __floats2bfloat162_rn(acc[i][4 * jj + 2], acc[i][4 * jj + 3]);
  }
}

// stage_chunk (B16: stage_chunk_bf16) at a run-time chunk index: the
// index reaches the register array only as a constant.
template <int NS, int WN, int C, bool B16>
__device__ __forceinline__ void stage_any(float (&acc)[NS][WN / 2], int c,
                                          float* Cs) {
  if constexpr (C > 0) {
    if (c == C - 1) {
      if constexpr (B16)
        stage_chunk_bf16<C - 1, NS, WN>(acc, reinterpret_cast<bf16*>(Cs));
      else
        stage_chunk<C - 1, NS, WN>(acc, Cs);
    } else {
      stage_any<NS, WN, C - 1, B16>(acc, c, Cs);
    }
  }
}

// The block's shared memory as both schedules lay it out: the ring's
// stages from a 1024-byte boundary, the consumers' staging tiles, then
// each stage's "full" and "empty" mbarriers.
template <class PL>
struct Ring {
  uint32_t base;  // stage 0
  float* Cs;      // consumer warpgroup 0's staging tile
  uint32_t bars;
  __device__ uint32_t stage(int s) const { return base + s * PL::STAGE_BYTES; }
  __device__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ uint32_t empty(int s) const {
    return bars + 8 * (PL::STAGES + s);
  }
};

// The ring of this block, its barriers set up ("empty" completes after
// ``readers`` arrivals: one a consumer warp that reads a stage).
template <class PL>
__device__ __forceinline__ Ring<PL> make_ring(int readers) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t staging = base + PL::STAGES * PL::STAGE_BYTES;
  const Ring<PL> r{base,
                   reinterpret_cast<float*>(smem_raw + (staging - raw)),
                   staging + PL::EPI_BYTES};
  if (threadIdx.x == 0) {
    for (int s = 0; s < PL::STAGES; ++s) {
      mbar_init(r.full(s), 1);
      mbar_init(r.empty(s), readers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

// The producer thread: every k-tile of the block's tiles, in tile order,
// into the ring (each stage once its readers have released it).
template <class PL, class P>
__device__ __forceinline__ void produce(const P& p, const Ring<PL>& r) {
  const int tiles = p.tiles();
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const auto tile = p.tile(t);
    for (int kt = 0; kt < tile.ktiles; ++kt) {
      mbar_wait(r.empty(stage), phase ^ 1);
      mbar_expect_tx(r.full(stage), PL::STAGE_BYTES);
      const uint32_t a = r.stage(stage);
      p.load(tile, kt, a, a + PL::A_BYTES, r.full(stage));
      if (++stage == PL::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// A consumer warpgroup's products for one tile: slice ``s`` of each of
// the tile's k-tiles, read from ring position q on (stage q % STAGES),
// into acc; q ends past them. Each stage goes back to the producer once
// the products that read it have retired; the last one's products are
// still in flight on return, and its stage is returned for finish_tile.
template <int NS, int H, class P, class PL, class Tile>
__device__ __forceinline__ int issue_tile(const P& p, const Ring<PL>& ring,
                                          const Tile& tile, int s,
                                          uint32_t& q, float (&acc)[NS][H]) {
  constexpr int WN = 2 * H;  // wgmma N per column slice
  const bool lane0 = threadIdx.x % 32 == 0;
  int prev = 0;
  for (int kt = 0; kt < tile.ktiles; ++kt, ++q) {
    const int stage = q % PL::STAGES;
    mbar_wait(ring.full(stage), q / PL::STAGES & 1);
#pragma unroll
    for (int i = 0; i < NS; ++i) fence_regs(acc[i]);
    wgmma_fence();
    const uint32_t a = ring.stage(stage);
#pragma unroll
    for (int k16 = 0; k16 < BK / 16; ++k16) {
      const uint64_t da = p.desc_a(a, s, k16);
#pragma unroll
      for (int i = 0; i < NS; ++i)
        wgmma<WN, P::TA, P::TB>(acc[i], da, p.desc_b(a + PL::A_BYTES, i, k16),
                                (kt | k16) != 0);
    }
    wgmma_commit();
#pragma unroll
    for (int i = 0; i < NS; ++i) fence_regs(acc[i]);
    if (kt > 0) {  // the previous k-tile's products have retired
      wgmma_wait<1>();
      if (lane0) mbar_arrive(ring.empty(prev));
    }
    prev = stage;
  }
  return prev;
}

// Then: every product retired, the last stage released, and the tile's
// epilogue, 64 columns at a time through the warpgroup's staging tile Cs
// (guarded by named barrier 1 + the warpgroup's index).
template <int BN, int NS, int H, class P, class PL, class Tile>
__device__ __forceinline__ void finish_tile(const P& p, const Ring<PL>& ring,
                                            const Tile& tile, int s, int last,
                                            float (&acc)[NS][H], float* Cs) {
  constexpr int WN = 2 * H;
  const int bar = 1 + threadIdx.x / 128;
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < NS; ++i) fence_regs(acc[i]);
  if (threadIdx.x % 32 == 0) mbar_arrive(ring.empty(last));
  for (int c = 0; c < BN / EPI_N; ++c) {
    named_sync(bar, 128);  // the last chunk's readers are done
    stage_any<NS, WN, BN / EPI_N, P::STAGE_BF16>(acc, c, Cs);
    named_sync(bar, 128);
    p.epilogue(tile, s, c, Cs);
  }
}

// The cooperative schedule over problem ``p`` (see the top): consumer
// warpgroup wg runs rows [64 wg, 64 wg + 64) of every tile.
template <int WG, int BN, class P>
__device__ __forceinline__ void run(const P& p) {
  using PL = Plan<WG, BN>;
  constexpr int WN = PL::WN, NS = BN / WN;
  const Ring<PL> ring = make_ring<PL>(4 * WG);
  const int wg = threadIdx.x / 128;
  const int tiles = p.tiles();
  if (wg == WG) {  // the producer warpgroup
    if constexpr (WG >= 2) reg_dealloc<40>();
    if (threadIdx.x == 128 * WG) produce(p, ring);
    return;
  }
  if constexpr (WG >= 2) reg_alloc<WG == 2 ? 232 : 152>();
  float acc[NS][WN / 2];
  float* Cs = ring.Cs + wg * 64 * EPI_LD;
  uint32_t q = 0;  // ring position
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const auto tile = p.tile(t);
    const int last = issue_tile(p, ring, tile, wg, q, acc);
    finish_tile<BN>(p, ring, tile, wg, last, acc, Cs);
  }
}

// The ping-pong schedule over problem ``p`` (see the top): two consumer
// warpgroups, each owning whole tiles of one 64-row slice; the block's
// tiles go to them in turn (the block's j-th tile to warpgroup j % 2).
constexpr int PP_CONSUMERS = 2;

template <int BN, class P>
__device__ __forceinline__ void run_pingpong(const P& p) {
  constexpr int NC = PP_CONSUMERS;
  using PL = Plan<1, BN, NC>;
  constexpr int WN = PL::WN, NS = BN / WN;
  constexpr int TURN = 1 + NC;  // named barriers: 1.. the epilogues'
  const Ring<PL> ring = make_ring<PL>(4);  // one warpgroup reads a k-tile
  const int wg = threadIdx.x / 128;
  const int tiles = p.tiles();
  if (wg == NC) {  // the producer warpgroup
    reg_dealloc<40>();
    if (threadIdx.x == 128 * NC) produce(p, ring);
    return;
  }
  reg_alloc<232>();
  float acc[NS][WN / 2];
  float* Cs = ring.Cs + wg * 64 * EPI_LD;
  uint32_t q = 0;  // ring position: k-tiles of the block's earlier tiles
  int j = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++j) {
    const auto tile = p.tile(t);
    if (j % NC != wg) {  // the other warpgroup's tile: step over its k-tiles
      q += tile.ktiles;
      continue;
    }
    // the turn: the previous tile's warpgroup has issued its products
    if (j > 0) named_sync(TURN + wg, 256);
    const int last = issue_tile(p, ring, tile, 0, q, acc);
    // every product issued: the next tile's warpgroup takes the turn
    if (t + (int)gridDim.x < tiles) named_arrive(TURN + (wg ^ 1), 256);
    finish_tile<BN>(p, ring, tile, 0, last, acc, Cs);
  }
}

}  // namespace hg

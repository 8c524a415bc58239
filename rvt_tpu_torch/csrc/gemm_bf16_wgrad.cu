// K6 gemm_bf16_wgrad: part[z] = A[rows of split z]^T . B[same rows], the
// weight gradients of training (a^T b over all tokens, bf16 operands, f32
// sums).
//
// Replaces the _dot_t weight-gradient products of the TPU kernels
// rvt_tpu/ops/fused_train.py:_block_bwd (dqkv_w, dproj_w, dfc1_w,
// dfc2_w) and _lstm_bwd_chunked (dlstm_w), whose sums the TPU carried
// across its sequential grid in a VMEM accumulator (_acc :495). Hopper
// blocks run in no order, so the rows (up to 860,160 tokens at gen1
// stage 1) are split into ``splits`` contiguous ranges; each range's
// [Ka, Nb] product goes to part[z], and train_reduce.cu sums the splits in
// a fixed order: two runs give the same bits.
//
// Bound on the H100: bytes at stages 1-2 (each row of A and B is read
// once: Ka + Nb = 128..512 columns against 2*Ka*Nb flops per row),
// operations at stages 3-4.
//
// Design (hopper_gemm.cuh): the work units are (split, Ka tile, Nb tile)
// with output tiles of up to 128 x 256, so most stage 1-2 gradients
// (64x64 .. 128x256) are one tile and each token row of A and B is read
// once; the splits are sized in ops/fused_attention.py:wgrad_splits so
// the units fill the SMs about once. Both operands are read MN-major
// straight from their row-major token arrays (wgmma's transpose
// immediates): A^T's m is A's column, B's n its column, k the token. TMA
// copies 64-token k-tiles through an mbarrier ring into wgmma, in a
// persistent grid; a split is a whole number of k-tiles, and TMA's zero
// fill past M ends the last one.
#include "hopper_gemm.cuh"

namespace {

template <int WG, int BN>
struct Wgrad {
  static constexpr int BM = 64 * WG, WN = hg::Plan<WG, BN>::WN;
  static constexpr int TA = 1, TB = 1;
  static constexpr bool STAGE_BF16 = false;
  struct Tile {
    int z, m0, n0, ktiles;
    long r0;
  };
  const CUtensorMap* ta;
  const CUtensorMap* tb;
  float* part;
  long M, rps;
  int Ka, Nb, splits;

  __device__ int mt() const { return (Ka + BM - 1) / BM; }
  __device__ int nt() const { return (Nb + BN - 1) / BN; }
  __device__ int tiles() const { return splits * mt() * nt(); }
  __device__ Tile tile(int t) const {
    const int per = mt() * nt(), z = t / per, rem = t % per;
    const long r0 = (long)z * rps;
    const long rows = min(M, r0 + rps) - r0;
    return {z, rem / nt() * BM, rem % nt() * BN,
            (int)((rows + hg::BK - 1) / hg::BK), r0};
  }
  __device__ void load(const Tile& t, int kt, uint32_t a, uint32_t b,
                       uint32_t bar) const {
    const int k0 = (int)(t.r0 + (long)kt * hg::BK);
#pragma unroll
    for (int w = 0; w < WG; ++w)  // boxes: 64 tokens x 64 columns of A
      hg::tma_load(a + w * 64 * hg::BK * 2, ta, bar, t.m0 + 64 * w, k0);
#pragma unroll
    for (int j = 0; j < BN / 64; ++j)  // boxes: 64 tokens x 64 columns of B
      hg::tma_load(b + j * 64 * hg::BK * 2, tb, bar, t.n0 + 64 * j, k0);
  }
  __device__ uint64_t desc_a(uint32_t a, int wg, int k16) const {
    return hg::desc_sw128(a + wg * 64 * 128 + 2048 * k16, 64 * 128, 1024);
  }
  __device__ uint64_t desc_b(uint32_t b, int i, int k16) const {
    return hg::desc_sw128(b + i * WN * 128 + 2048 * k16, 64 * 128, 1024);
  }
  // One 64 x 64 slice (rows m0 + 64 wg.., columns n0 + 64 c..) into
  // part[z], four columns per thread with 16-byte stores.
  __device__ void epilogue(const Tile& t, int wg, int c, float* Cs) const {
    const int tid = threadIdx.x % 128;
    const int row0 = t.m0 + 64 * wg, col0 = t.n0 + 64 * c;
    float* dst = part + (long)t.z * Ka * Nb;
    for (int i = tid; i < 64 * 16; i += 128) {
      const int r = i / 16, c4 = (i % 16) * 4;
      if (row0 + r >= Ka || col0 + c4 >= Nb) continue;  // Nb % 8 == 0
      *reinterpret_cast<float4*>(dst + (long)(row0 + r) * Nb + col0 + c4) =
          *reinterpret_cast<const float4*>(Cs + r * hg::EPI_LD + c4);
    }
  }
};

template <int WG, int BN>
__global__ void __launch_bounds__(128 * (WG + 1), 1)
wgrad_kernel(const __grid_constant__ CUtensorMap ta,
             const __grid_constant__ CUtensorMap tb, float* part, long M,
             long rps, int Ka, int Nb, int splits) {
  const Wgrad<WG, BN> p{&ta, &tb, part, M, rps, Ka, Nb, splits};
  hg::run<WG, BN>(p);
}

template <int WG, int BN>
int launch(const void* a, const void* b, void* part, long M, int Ka, int Nb,
           int splits, long rps, cudaStream_t st) {
  using PL = hg::Plan<WG, BN>;
  static unsigned long long ready = 0;
  CUtensorMap ta, tb;
  if (!hg::make_map(&ta, a, M, Ka, hg::BK, 64) ||
      !hg::make_map(&tb, b, M, Nb, hg::BK, 64))
    return (int)cudaErrorInvalidValue;
  const long tiles =
      (long)splits * ((Ka + PL::BM - 1) / PL::BM) * ((Nb + BN - 1) / BN);
  return hg::launch_persistent(wgrad_kernel<WG, BN>, ready, PL::SMEM,
                               PL::THREADS, tiles, st, ta, tb, (float*)part,
                               M, rps, Ka, Nb, splits);
}

}  // namespace

// part: [splits, Ka, Nb] f32, splits = ceil(M / rows_per_split),
// rows_per_split a multiple of 64 (whole k-tiles). The tile: Ka <= 64 ->
// 64 rows (one consumer warpgroup), else 128; Nb <= 64 -> 64 columns,
// <= 128 -> 128, else 256 (ops/fused_attention.py:wgrad_tile mirrors it).
extern "C" int rvt_gemm_bf16_wgrad(const void* a, const void* b, void* part,
                                   long M, int Ka, int Nb, int splits,
                                   long rows_per_split, void* stream) {
  if (rows_per_split % hg::BK != 0 || rows_per_split <= 0 || splits < 1 ||
      M < 1 || (long)(splits - 1) * rows_per_split >= M ||
      (long)splits * rows_per_split < M || Ka % 8 != 0 || Nb % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int bn = Nb <= 64 ? 64 : Nb <= 128 ? 128 : 256;
  if (Ka <= 64) {
    if (bn == 64) return launch<1, 64>(a, b, part, M, Ka, Nb, splits,
                                       rows_per_split, st);
    if (bn == 128) return launch<1, 128>(a, b, part, M, Ka, Nb, splits,
                                         rows_per_split, st);
    return launch<1, 256>(a, b, part, M, Ka, Nb, splits, rows_per_split, st);
  }
  if (bn == 64) return launch<2, 64>(a, b, part, M, Ka, Nb, splits,
                                     rows_per_split, st);
  if (bn == 128) return launch<2, 128>(a, b, part, M, Ka, Nb, splits,
                                       rows_per_split, st);
  return launch<2, 256>(a, b, part, M, Ka, Nb, splits, rows_per_split, st);
}

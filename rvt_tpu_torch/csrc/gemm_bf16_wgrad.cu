// K6 gemm_bf16_wgrad: part[z] = A[rows of split z]^T . B[same rows], the
// weight gradients of training (a^T b over all tokens, bf16 operands, f32
// sums).
//
// Replaces the _dot_t weight-gradient products of the TPU kernels
// rvt_tpu/ops/fused_train.py:_block_bwd (dqkv_w, dproj_w, dfc1_w,
// dfc2_w) and _lstm_bwd_chunked (dlstm_w), whose sums the TPU carried
// across its sequential grid in a VMEM accumulator (_acc :495). Hopper
// blocks run in no order, so the rows (up to 860,160 tokens at gen1
// stage 1) are split into ``splits`` contiguous ranges, one per
// blockIdx.z; each block writes the f32 [64, 64] tile of its range into
// part[z, Ka, Nb], and train_reduce.cu sums the splits in a fixed order:
// two runs give the same bits.
//
// Bound on the H100: bytes at stages 1-2 (each row of A and B is read
// once: K = 64..256 columns against 2*Ka*Nb flops per row), operations at
// stages 3-4. Design (simple first, as K2): 4-warp blocks, 64x64 output
// tile, 32 rows per k-step through shared memory, bf16 WMMA with f32
// accumulators, the next k-step's loads in registers during the current
// products. A^T is read from the row-major tile as a col_major fragment,
// so nothing is transposed in memory.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int LDA = BM + 8, LDB = BN + 8, LDC = BN + 4;

__global__ void __launch_bounds__(128)
wgrad_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
             float* __restrict__ part, long M, int Ka, int Nb,
             long rows_per_split) {
  __shared__ __align__(128) bf16 As[BK][LDA];  // [row][ka]
  __shared__ __align__(128) bf16 Bs[BK][LDB];  // [row][nb]
  __shared__ __align__(128) float Cs[BM][LDC];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const long r_begin = (long)blockIdx.z * rows_per_split;
  const long r_end = min(M, r_begin + rows_per_split);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  uint4 ra[2], rb[2];
  auto load_tile = [&](long r0) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = tid + u * 128;
      const int kr = i / (BM / 8), c8 = (i % (BM / 8)) * 8;
      const long gr = r0 + kr;
      ra[u] = make_uint4(0, 0, 0, 0);
      rb[u] = make_uint4(0, 0, 0, 0);
      if (gr < r_end) {
        if (m0 + c8 < Ka)
          ra[u] = *reinterpret_cast<const uint4*>(A + gr * Ka + m0 + c8);
        if (n0 + c8 < Nb)
          rb[u] = *reinterpret_cast<const uint4*>(B + gr * Nb + n0 + c8);
      }
    }
  };
  if (r_begin < r_end) load_tile(r_begin);
  for (long r0 = r_begin; r0 < r_end; r0 += BK) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = tid + u * 128;
      const int kr = i / (BM / 8), c8 = (i % (BM / 8)) * 8;
      *reinterpret_cast<uint4*>(&As[kr][c8]) = ra[u];
      *reinterpret_cast<uint4*>(&Bs[kr][c8]) = rb[u];
    }
    __syncthreads();
    if (r0 + BK < r_end) load_tile(r0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // element (m, k) of A^T is As[k][m]: a col_major fragment
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[kk][wm * 32 + i * 16], LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[kk][wn * 32 + j * 16], LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wm * 32 + i * 16][wn * 32 + j * 16],
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  float* dst = part + (long)blockIdx.z * Ka * Nb;
  for (int i = tid; i < BM * BN / 4; i += 128) {
    const int r = i / (BN / 4), c4 = (i % (BN / 4)) * 4;
    if (m0 + r >= Ka || n0 + c4 >= Nb) continue;  // Nb % 8 == 0
    *reinterpret_cast<float4*>(dst + (long)(m0 + r) * Nb + n0 + c4) =
        *reinterpret_cast<const float4*>(&Cs[r][c4]);
  }
}

}  // namespace

// part: [splits, Ka, Nb] f32, splits = ceil(M / rows_per_split);
// rows_per_split a multiple of 32.
extern "C" int rvt_gemm_bf16_wgrad(const void* a, const void* b, void* part,
                                   long M, int Ka, int Nb, int splits,
                                   long rows_per_split, void* stream) {
  if (rows_per_split % BK != 0 || splits < 1)
    return (int)cudaErrorInvalidValue;
  dim3 grid((Nb + BN - 1) / BN, (Ka + BM - 1) / BM, splits);
  wgrad_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      (const bf16*)a, (const bf16*)b, (float*)part, M, Ka, Nb,
      rows_per_split);
  return (int)cudaGetLastError();
}

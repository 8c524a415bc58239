// K2 gemm_bf16: out = epilogue(A[M,K] bf16 x W[K,N] bf16), f32 accumulation.
//
// Replaces the token-pointwise products inside the TPU kernel
// rvt_tpu/ops/fused_attention.py:_one_block (qkv, proj, fc1, fc2; run
// per partition there, in image order here, which is the same product
// because they act on each token alone). Every variant first rounds the
// f32 sum to bf16, then adds the bf16 bias and rounds again (the JAX
// ``dot(...).astype(bf16) + b``). Then:
//   EPI_BIAS  (0): store the bf16 result                       (qkv)
//   EPI_GELU  (1): tanh-gelu in f32, store rounded to bf16     (fc1)
//   EPI_RESID (2): R[M,N] f32 += the result                    (proj, fc2)
// LayerScale is already folded into the proj/fc2 weights and biases.
//
// Bound on the H100: at the gen1 RVT-B shapes the products are short
// (K = C or 4C, 64..2048) and M is large, so stages 1-2 are bound by the
// bytes of A and the output, stages 3-4 come closer to the tensor-core
// rate. Design (simple first): 64x64 output tile per 4-warp block, K
// stepped by 32 through shared memory, bf16 WMMA (mma.sync) tiles with
// f32 accumulators; the next k-tile's loads go to registers while the
// current one is multiplied; the epilogue reads a shared-memory f32 tile
// and writes eight columns per thread with 16-byte stores. No TMA/wgmma
// and no multi-stage shared-memory pipeline yet.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int LDA = BK + 8, LDB = BN + 8, LDC = BN + 4;
constexpr int EPI_BIAS = 0, EPI_GELU = 1, EPI_RESID = 2;

__device__ __forceinline__ float gelu_tanh(float x) {
  const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.f + tanhf(inner));
}

template <int EPI>
__global__ void __launch_bounds__(128)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ Wt,
            const bf16* __restrict__ bias, void* __restrict__ out, int M,
            int N, int K) {
  __shared__ __align__(128) bf16 As[BM][LDA];
  __shared__ __align__(128) bf16 Bs[BK][LDB];
  __shared__ __align__(128) float Cs[BM][LDC];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // 2x2 warps of 32x32 each
  const long m0 = (long)blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // Each thread moves two 16-byte chunks of A and two of W per k-tile.
  // The next tile's loads are issued into registers before the current
  // tile's products, so global latency overlaps the tensor-core work.
  uint4 ra[2], rb[2];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = tid + u * 128;
      const int ar = i / (BK / 8), ac = (i % (BK / 8)) * 8;
      const long gm = m0 + ar;
      ra[u] = make_uint4(0, 0, 0, 0);
      if (gm < M && k0 + ac < K)
        ra[u] = *reinterpret_cast<const uint4*>(A + gm * K + k0 + ac);
      const int br = i / (BN / 8), bc = (i % (BN / 8)) * 8;
      rb[u] = make_uint4(0, 0, 0, 0);
      if (k0 + br < K && n0 + bc < N)
        rb[u] = *reinterpret_cast<const uint4*>(Wt + (long)(k0 + br) * N +
                                                n0 + bc);
    }
  };
  load_tile(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = tid + u * 128;
      *reinterpret_cast<uint4*>(&As[i / (BK / 8)][(i % (BK / 8)) * 8]) =
          ra[u];
      *reinterpret_cast<uint4*>(&Bs[i / (BN / 8)][(i % (BN / 8)) * 8]) =
          rb[u];
    }
    __syncthreads();
    if (k0 + BK < K) load_tile(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[wm * 32 + i * 16][kk], LDA);
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

  // epilogue: eight neighbouring columns per thread, 16-byte accesses
  for (int i = tid; i < BM * BN / 8; i += 128) {
    const int r = i / (BN / 8), c8 = (i % (BN / 8)) * 8;
    const long gm = m0 + r;
    const int gn = n0 + c8;
    if (gm >= M || gn >= N) continue;  // N % 8 == 0: all eight in range
    const uint4 bv = *reinterpret_cast<const uint4*>(bias + gn);
    const bf16* bb = reinterpret_cast<const bf16*>(&bv);
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[e] = round_bf16(round_bf16(Cs[r][c8 + e]) + __bfloat162float(bb[e]));
      if (EPI == EPI_GELU) v[e] = round_bf16(gelu_tanh(v[e]));
    }
    if (EPI == EPI_RESID) {
      float4* R = reinterpret_cast<float4*>(
          reinterpret_cast<float*>(out) + gm * N + gn);
      float4 r0 = R[0], r1 = R[1];
      r0.x += v[0]; r0.y += v[1]; r0.z += v[2]; r0.w += v[3];
      r1.x += v[4]; r1.y += v[5]; r1.z += v[6]; r1.w += v[7];
      R[0] = r0;
      R[1] = r1;
    } else {
      __align__(16) bf16 packed[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) packed[e] = __float2bfloat16_rn(v[e]);
      *reinterpret_cast<uint4*>(reinterpret_cast<bf16*>(out) + gm * N + gn) =
          *reinterpret_cast<const uint4*>(packed);
    }
  }
}

}  // namespace

extern "C" int rvt_gemm_bf16(const void* a, const void* w, const void* bias,
                             void* out, int M, int N, int K, int epilogue,
                             void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t st = (cudaStream_t)stream;
  const bf16* A = (const bf16*)a;
  const bf16* W = (const bf16*)w;
  const bf16* B = (const bf16*)bias;
  if (epilogue == EPI_BIAS)
    gemm_kernel<EPI_BIAS><<<grid, 128, 0, st>>>(A, W, B, out, M, N, K);
  else if (epilogue == EPI_GELU)
    gemm_kernel<EPI_GELU><<<grid, 128, 0, st>>>(A, W, B, out, M, N, K);
  else if (epilogue == EPI_RESID)
    gemm_kernel<EPI_RESID><<<grid, 128, 0, st>>>(A, W, B, out, M, N, K);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

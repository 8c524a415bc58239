// K2 gemm_bf16: out = epilogue(A[M,K] bf16 x W bf16), f32 accumulation.
//
// Replaces the token-pointwise products inside the TPU kernels
// rvt_tpu/ops/fused_attention.py:_one_block (qkv, proj, fc1, fc2; run
// per partition there, in image order here, which is the same product
// because they act on each token alone) and, for training, the products
// of rvt_tpu/ops/fused_train.py:_block_fwd / _block_bwd (_dot and
// _dot_rt). The bias variants first round the f32 sum to bf16, then add
// the bf16 bias and round again (the JAX ``dot(...).astype(bf16) + b``):
//   EPI_BIAS    (0): store the bf16 result                     (qkv, m)
//   EPI_GELU    (1): tanh-gelu in f32, store rounded to bf16   (fc1);
//                    with ``aux`` also the bf16 pre-activation h1
//   EPI_RESID   (2): R[M,N] f32 += the result    (serving proj, fc2; the
//                    LayerScale is folded into their weights)
//   EPI_RESID_LS(3): out = res_in + f32(result) * gamma[col]   (training
//                    proj, fc2: LayerScale unfolded, _block_fwd :311-316,
//                    :329-332); with ``aux`` also the bf16 result
// and, with W given as [N, K] (out = A . W^T, the data gradients):
//   EPI_RT_F32  (4): store the f32 sum
//   EPI_RT_BF16 (5): store the sum rounded to bf16 (dattn, which the
//                    attention backward reads as bf16 only)
//   EPI_RT_ACC  (6): out[M,N] f32 += the sum
//   EPI_RT_GELU_BWD (7): d = sum * gelu'(aux = bf16 h1) (_gelu_bwd :145),
//                    store bf16(d) and the f32 column sums of d over the
//                    block's rows into part[blockIdx.y, N] (the fc1 bias
//                    gradient, summed over blocks by train_reduce.cu)
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

#include <type_traits>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int LDA = BK + 8, LDB = BN + 8, LDBT = BK + 8, LDC = BN + 4;
constexpr int EPI_BIAS = 0, EPI_GELU = 1, EPI_RESID = 2, EPI_RESID_LS = 3,
              EPI_RT_F32 = 4, EPI_RT_BF16 = 5, EPI_RT_ACC = 6,
              EPI_RT_GELU_BWD = 7;
constexpr float GELU_C0 = 0.7978845608028654f, GELU_C1 = 0.044715f;

__device__ __forceinline__ float gelu_tanh(float x) {
  const float inner = GELU_C0 * (x + GELU_C1 * x * x * x);
  return 0.5f * x * (1.f + tanhf(inner));
}

// d gelu / d h at the bf16 pre-activation h, as _gelu_bwd writes it.
__device__ __forceinline__ float gelu_grad(float h) {
  const float t = tanhf(GELU_C0 * (h + GELU_C1 * h * h * h));
  const float dinner =
      0.5f * h * (1.f - t * t) * GELU_C0 * (1.f + 0.134145f * h * h);
  return 0.5f * (1.f + t) + dinner;
}

__device__ __forceinline__ void store_bf16x8(bf16* dst, const float* v) {
  __align__(16) bf16 packed[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) packed[e] = __float2bfloat16_rn(v[e]);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(packed);
}

__device__ __forceinline__ void load_bf16x8(const bf16* src, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const bf16* b = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(b[e]);
}

// TRANS: W is [N, K] and the product is A . W^T (the _dot_rt of the
// backward); otherwise W is [K, N].
template <int EPI, bool TRANS>
__global__ void __launch_bounds__(128)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ Wt,
            const bf16* __restrict__ bias, const float* __restrict__ gamma,
            const float* __restrict__ res_in, bf16* __restrict__ aux,
            void* __restrict__ out, float* __restrict__ part, int M, int N,
            int K) {
  __shared__ __align__(128) bf16 As[BM][LDA];
  __shared__ __align__(128) bf16 Bs[BN * LDBT > BK * LDB ? BN * LDBT
                                                          : BK * LDB];
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
      rb[u] = make_uint4(0, 0, 0, 0);
      if (TRANS) {  // W rows n0.., columns k0..: stored [n][k]
        const int br = i / (BK / 8), bc = (i % (BK / 8)) * 8;
        if (n0 + br < N && k0 + bc < K)
          rb[u] = *reinterpret_cast<const uint4*>(Wt + (long)(n0 + br) * K +
                                                  k0 + bc);
      } else {
        const int br = i / (BN / 8), bc = (i % (BN / 8)) * 8;
        if (k0 + br < K && n0 + bc < N)
          rb[u] = *reinterpret_cast<const uint4*>(Wt + (long)(k0 + br) * N +
                                                  n0 + bc);
      }
    }
  };
  using BLayout =
      typename std::conditional<TRANS, wmma::col_major, wmma::row_major>::type;
  load_tile(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = tid + u * 128;
      *reinterpret_cast<uint4*>(&As[i / (BK / 8)][(i % (BK / 8)) * 8]) =
          ra[u];
      if (TRANS)
        *reinterpret_cast<uint4*>(
            &Bs[(i / (BK / 8)) * LDBT + (i % (BK / 8)) * 8]) = rb[u];
      else
        *reinterpret_cast<uint4*>(
            &Bs[(i / (BN / 8)) * LDB + (i % (BN / 8)) * 8]) = rb[u];
    }
    __syncthreads();
    if (k0 + BK < K) load_tile(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[wm * 32 + i * 16][kk], LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (TRANS)  // element (k, n) at Bs[n * LDBT + k]
          wmma::load_matrix_sync(b[j], &Bs[(wn * 32 + j * 16) * LDBT + kk],
                                 LDBT);
        else
          wmma::load_matrix_sync(b[j], &Bs[kk * LDB + wn * 32 + j * 16], LDB);
      }
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
    const long o = gm * N + gn;
    float v[8];
    if (EPI <= EPI_RESID_LS) {  // the bias variants
      float bb[8];
      load_bf16x8(bias + gn, bb);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = round_bf16(round_bf16(Cs[r][c8 + e]) + bb[e]);
      if ((EPI == EPI_GELU || EPI == EPI_RESID_LS) && aux != nullptr)
        store_bf16x8(aux + o, v);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = Cs[r][c8 + e];
    }
    if (EPI == EPI_BIAS || EPI == EPI_RT_BF16) {
      store_bf16x8(reinterpret_cast<bf16*>(out) + o, v);
    } else if (EPI == EPI_GELU) {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = gelu_tanh(v[e]);
      store_bf16x8(reinterpret_cast<bf16*>(out) + o, v);
    } else if (EPI == EPI_RT_GELU_BWD) {
      float h[8];
      load_bf16x8(aux + o, h);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[e] *= gelu_grad(h[e]);
        Cs[r][c8 + e] = v[e];  // the f32 d for the column sums below
      }
      store_bf16x8(reinterpret_cast<bf16*>(out) + o, v);
    } else {  // f32 outputs
      float4* R = reinterpret_cast<float4*>(reinterpret_cast<float*>(out) + o);
      float4 r0, r1;
      if (EPI == EPI_RESID || EPI == EPI_RT_ACC) {
        r0 = R[0];
        r1 = R[1];
      } else if (EPI == EPI_RESID_LS) {
        const float4* Ri = reinterpret_cast<const float4*>(res_in + o);
        const float4* g = reinterpret_cast<const float4*>(gamma + gn);
        const float4 g0 = g[0], g1 = g[1];
        r0 = Ri[0];
        r1 = Ri[1];
        v[0] *= g0.x; v[1] *= g0.y; v[2] *= g0.z; v[3] *= g0.w;
        v[4] *= g1.x; v[5] *= g1.y; v[6] *= g1.z; v[7] *= g1.w;
      } else {  // EPI_RT_F32
        r0 = make_float4(0.f, 0.f, 0.f, 0.f);
        r1 = r0;
      }
      r0.x += v[0]; r0.y += v[1]; r0.z += v[2]; r0.w += v[3];
      r1.x += v[4]; r1.y += v[5]; r1.z += v[6]; r1.w += v[7];
      R[0] = r0;
      R[1] = r1;
    }
  }
  if (EPI == EPI_RT_GELU_BWD) {
    __syncthreads();
    // column sums of the tile's valid rows, in row order: deterministic
    if (tid < BN && n0 + tid < N) {
      const int rows = (int)min((long)BM, (long)M - m0);
      float s = 0.f;
      for (int r = 0; r < rows; ++r) s += Cs[r][tid];
      part[(long)blockIdx.y * N + n0 + tid] = s;
    }
  }
}

template <int EPI, bool TRANS>
int launch(const void* a, const void* w, const void* bias, const void* gamma,
           const void* res_in, void* aux, void* out, void* part, int M, int N,
           int K, cudaStream_t st) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<EPI, TRANS><<<grid, 128, 0, st>>>(
      (const bf16*)a, (const bf16*)w, (const bf16*)bias, (const float*)gamma,
      (const float*)res_in, (bf16*)aux, out, (float*)part, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// Every epilogue through one entry: 0-3 take W [K, N] and a bias (2 adds
// into ``out`` in place); 4-7 take W [N, K] and no bias. ``aux`` is an
// optional bf16 [M, N] output (1, 3) or the bf16 h1 input (7); ``part``
// [ceil(M/64), N] f32 receives the column sums of epilogue 7. Pointers an
// epilogue does not read may be null.
extern "C" int rvt_gemm_bf16(const void* a, const void* w, const void* bias,
                             const void* gamma, const void* res_in, void* aux,
                             void* out, void* part, int M, int N, int K,
                             int epilogue, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (epilogue) {
    case EPI_BIAS:
      return launch<EPI_BIAS, false>(a, w, bias, gamma, res_in, aux, out,
                                     part, M, N, K, st);
    case EPI_GELU:
      return launch<EPI_GELU, false>(a, w, bias, gamma, res_in, aux, out,
                                     part, M, N, K, st);
    case EPI_RESID:
      return launch<EPI_RESID, false>(a, w, bias, gamma, res_in, aux, out,
                                      part, M, N, K, st);
    case EPI_RESID_LS:
      return launch<EPI_RESID_LS, false>(a, w, bias, gamma, res_in, aux, out,
                                         part, M, N, K, st);
    case EPI_RT_F32:
      return launch<EPI_RT_F32, true>(a, w, bias, gamma, res_in, aux, out,
                                      part, M, N, K, st);
    case EPI_RT_BF16:
      return launch<EPI_RT_BF16, true>(a, w, bias, gamma, res_in, aux, out,
                                       part, M, N, K, st);
    case EPI_RT_ACC:
      return launch<EPI_RT_ACC, true>(a, w, bias, gamma, res_in, aux, out,
                                      part, M, N, K, st);
    case EPI_RT_GELU_BWD:
      return launch<EPI_RT_GELU_BWD, true>(a, w, bias, gamma, res_in, aux,
                                           out, part, M, N, K, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// train_reduce: the column sums of training (bias, LayerScale-gamma and
// split weight-gradient sums), in a fixed order so that two runs agree.
//
// Replaces the row sums of the TPU kernels rvt_tpu/ops/fused_train.py:
// _block_bwd (dls2_g, dfc2_b :369-374, dls1_g, dproj_b :394-404,
// dqkv_b :415) and the cross-grid accumulation of every weight gradient
// (_acc :495), which the TPU's sequential grid carried in VMEM. Three
// launchers:
//   rvt_sum_parts   out[N] = sum over p of part[p, N] (the second pass
//                   of every split sum: K5's, K6's, K8's and K2's partials)
//   rvt_colsum      part[b, N] = sum of x[rows of block b, N] (f32/bf16)
//   rvt_ls_bwd      LayerScale backward: d = dR * gamma, written as bf16
//                   (the cotangent the next product reads), with partial
//                   column sums of d (the bias gradient) and of v * dR
//                   (the gamma gradient, v the bf16 branch output)
//
// Bound on the H100: bytes (one read of each input, a few flops per
// element). Design: 32 columns x 8 row lanes per block, so a warp reads
// 32 neighbouring columns of one row; each thread sums its rows in
// order, then the 8 lanes are added in lane order in shared memory.
#include "common.cuh"

namespace {

constexpr int TX = 32, TY = 8;

__device__ __forceinline__ float lane_total(float (*red)[TX + 1], float v) {
  red[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.y == 0)
    for (int y = 0; y < TY; ++y) s += red[y][threadIdx.x];
  return s;
}

__global__ void __launch_bounds__(TX * TY)
sum_parts_kernel(const float* __restrict__ part, float* __restrict__ out,
                 int nparts, long N) {
  __shared__ float red[TY][TX + 1];
  const long col = (long)blockIdx.x * TX + threadIdx.x;
  float s = 0.f;
  if (col < N)
    for (int p = threadIdx.y; p < nparts; p += TY) s += part[p * N + col];
  s = lane_total(red, s);
  if (threadIdx.y == 0 && col < N) out[col] = s;
}

template <typename T>
__global__ void __launch_bounds__(TX * TY)
colsum_kernel(const T* __restrict__ x, float* __restrict__ part, long M,
              int N, int rows_per_block) {
  __shared__ float red[TY][TX + 1];
  const int col = blockIdx.x * TX + threadIdx.x;
  const long r0 = (long)blockIdx.y * rows_per_block;
  const long r1 = min(M, r0 + rows_per_block);
  float s = 0.f;
  if (col < N)
    for (long r = r0 + threadIdx.y; r < r1; r += TY) s += to_float(x[r * N + col]);
  s = lane_total(red, s);
  if (threadIdx.y == 0 && col < N) part[(long)blockIdx.y * N + col] = s;
}

__global__ void __launch_bounds__(TX * TY)
ls_bwd_kernel(const float* __restrict__ dR, const bf16* __restrict__ v,
              const float* __restrict__ gamma, bf16* __restrict__ d_out,
              float* __restrict__ part, long M, int C, int rows_per_block) {
  __shared__ float red[TY][TX + 1];
  const int col = blockIdx.x * TX + threadIdx.x;
  const long r0 = (long)blockIdx.y * rows_per_block;
  const long r1 = min(M, r0 + rows_per_block);
  float sd = 0.f, sg = 0.f;
  if (col < C) {
    const float g = gamma[col];
    for (long r = r0 + threadIdx.y; r < r1; r += TY) {
      const long o = r * C + col;
      const float dr = dR[o];
      const float d = dr * g;
      d_out[o] = __float2bfloat16_rn(d);
      sd += d;
      sg += __bfloat162float(v[o]) * dr;
    }
  }
  sd = lane_total(red, sd);
  __syncthreads();
  sg = lane_total(red, sg);
  if (threadIdx.y == 0 && col < C) {
    part[((long)blockIdx.y * 2) * C + col] = sd;
    part[((long)blockIdx.y * 2 + 1) * C + col] = sg;
  }
}

}  // namespace

extern "C" int rvt_sum_parts(const void* part, void* out, int nparts, long N,
                             void* stream) {
  dim3 grid((unsigned)((N + TX - 1) / TX));
  sum_parts_kernel<<<grid, dim3(TX, TY), 0, (cudaStream_t)stream>>>(
      (const float*)part, (float*)out, nparts, N);
  return (int)cudaGetLastError();
}

// part: [ceil(M / rows_per_block), N] f32.
extern "C" int rvt_colsum(const void* x, int x_is_f32, void* part, long M,
                          int N, int rows_per_block, void* stream) {
  dim3 grid((N + TX - 1) / TX, (unsigned)((M + rows_per_block - 1) /
                                           rows_per_block));
  cudaStream_t st = (cudaStream_t)stream;
  if (x_is_f32)
    colsum_kernel<float><<<grid, dim3(TX, TY), 0, st>>>(
        (const float*)x, (float*)part, M, N, rows_per_block);
  else
    colsum_kernel<bf16><<<grid, dim3(TX, TY), 0, st>>>(
        (const bf16*)x, (float*)part, M, N, rows_per_block);
  return (int)cudaGetLastError();
}

// part: [ceil(M / rows_per_block), 2, C] f32 (sums of d, then of v * dR).
extern "C" int rvt_ls_bwd(const void* dR, const void* v, const void* gamma,
                          void* d_out, void* part, long M, int C,
                          int rows_per_block, void* stream) {
  dim3 grid((C + TX - 1) / TX, (unsigned)((M + rows_per_block - 1) /
                                           rows_per_block));
  ls_bwd_kernel<<<grid, dim3(TX, TY), 0, (cudaStream_t)stream>>>(
      (const float*)dR, (const bf16*)v, (const float*)gamma, (bf16*)d_out,
      (float*)part, M, C, rows_per_block);
  return (int)cudaGetLastError();
}

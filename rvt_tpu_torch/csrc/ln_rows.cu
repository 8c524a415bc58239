// K1 ln_rows: LayerNorm over the channel axis of [M, C] rows.
//
// Replaces the LayerNorm steps inside the TPU kernels
// rvt_tpu/ops/fused_attention.py:_layer_norm_f32 (used by _one_block for
// LN1/LN2 and by _stage_scan_kernel / _blocks_kernel for the downsample
// LN). Semantics: f32 statistics with the fast variance
// max(E[x^2] - E[x]^2, 0), affine applied in f32, result rounded to
// bf16. With ``yf`` set the kernel also writes that bf16 result widened
// to f32: the residual stream R that the downsample LN starts.
//
// Bound on the H100: bytes. It reads each row once (2 or 4 bytes per
// element) and writes 2 (or 6) bytes per element, against about 10
// flops per element. Design: one warp per row, lanes striding over the
// channels so that a warp's loads are contiguous; the statistics are
// two warp-shuffle sums, so the row is read from memory once and the
// second pass hits L1.
#include "common.cuh"

template <typename T>
__global__ void __launch_bounds__(256)
ln_rows_kernel(const T* __restrict__ x, const bf16* __restrict__ s,
               const bf16* __restrict__ b, bf16* __restrict__ y,
               float* __restrict__ yf, int M, int C, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= M) return;
  const T* xr = x + row * C;
  float sum = 0.f, sq = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float v = to_float(xr[c]);
    sum += v;
    sq += v * v;
  }
  sum = warp_sum(sum);
  sq = warp_sum(sq);
  const float mu = sum / (float)C;
  const float var = fmaxf(sq / (float)C - mu * mu, 0.f);
  const float r = rsqrtf(var + eps);
  for (int c = lane; c < C; c += 32) {
    float v = (to_float(xr[c]) - mu) * r;
    v = v * __bfloat162float(s[c]) + __bfloat162float(b[c]);
    const bf16 o = __float2bfloat16_rn(v);
    y[row * C + c] = o;
    if (yf != nullptr) yf[row * C + c] = __bfloat162float(o);
  }
}

extern "C" int rvt_ln_rows(const void* x, int x_is_f32, const void* s,
                           const void* b, void* y, void* yf, int M, int C,
                           float eps, void* stream) {
  const int rows_per_block = 8;
  dim3 grid((M + rows_per_block - 1) / rows_per_block);
  cudaStream_t st = (cudaStream_t)stream;
  if (x_is_f32) {
    ln_rows_kernel<float><<<grid, 32 * rows_per_block, 0, st>>>(
        (const float*)x, (const bf16*)s, (const bf16*)b, (bf16*)y,
        (float*)yf, M, C, eps);
  } else {
    ln_rows_kernel<bf16><<<grid, 32 * rows_per_block, 0, st>>>(
        (const bf16*)x, (const bf16*)s, (const bf16*)b, (bf16*)y,
        (float*)yf, M, C, eps);
  }
  return (int)cudaGetLastError();
}

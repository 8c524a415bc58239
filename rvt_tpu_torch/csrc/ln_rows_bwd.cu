// K5 ln_rows_bwd: LayerNorm backward over the channel axis of [M, C] rows.
//
// Replaces the LayerNorm backward of the TPU kernels
// rvt_tpu/ops/fused_train.py:_block_bwd / _bwd_window_kernel (_ln_bwd
// :127 for LN2, LN1 and the downsample LN). Per row, the statistics are
// recomputed from x as _ln_fwd :116 does (f32, fast variance clamped at
// 0), then
//   xhat = (x - mean) * rstd,  dxhat = dy * s,
//   dx   = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))
// and dx is either added into the f32 residual cotangent ``dres``
// (dR_mid = dR_out + dx) or written as bf16 (the downsample-conv output's
// cotangent). ds = sum(dy * xhat) and db = sum(dy) over the block's rows
// go to part[block, 2, C]; train_reduce.cu sums the blocks in order.
//
// Bound on the H100: bytes (x, dy and dx once: 10-14 bytes per element
// against ~20 flops). Design: one warp per row with the row in registers
// (ceil(C/32) values per lane, C <= 512; past C they are masked, so the
// presets' 48, 96, 192 and 384 take the same path), lanes striding over
// the channels so a warp's loads are contiguous; each lane keeps its
// channels' ds/db sums over the warp's rows, then the 8 warps are added
// in order in shared memory.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;

// FULL: C == 32 * VPL, no lane is masked (compiled without the masks)
template <typename T, int VPL, bool FULL>
__global__ void __launch_bounds__(32 * WARPS)
ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dy,
              const bf16* __restrict__ s, float eps, float* __restrict__ dres,
              bf16* __restrict__ dx_bf16, float* __restrict__ part, long M,
              int C, int rows_per_block) {
  __shared__ float red[WARPS][2][VPL * 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long r0 = (long)blockIdx.x * rows_per_block;
  const long r1 = min(M, r0 + rows_per_block);
  float sc[VPL], acc_s[VPL], acc_b[VPL];
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    sc[j] = FULL || lane + 32 * j < C ? __bfloat162float(s[lane + 32 * j])
                                      : 0.f;
    acc_s[j] = 0.f;
    acc_b[j] = 0.f;
  }
  const float inv_c = 1.f / (float)C;
  for (long row = r0 + warp; row < r1; row += WARPS) {
    float xv[VPL], g[VPL];
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      xv[j] = FULL || lane + 32 * j < C ? to_float(x[row * C + lane + 32 * j])
                                        : 0.f;
      sum += xv[j];
      sq += xv[j] * xv[j];
    }
    sum = warp_sum(sum);
    sq = warp_sum(sq);
    const float mu = sum / (float)C;
    const float var = fmaxf(sq / (float)C - mu * mu, 0.f);
    const float rstd = rsqrtf(var + eps);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const bool in = FULL || lane + 32 * j < C;
      const float d = in ? dy[row * C + lane + 32 * j] : 0.f;
      xv[j] = in ? (xv[j] - mu) * rstd : 0.f;  // xhat
      acc_s[j] += d * xv[j];
      acc_b[j] += d;
      g[j] = d * sc[j];  // dxhat
      m1 += g[j];
      m2 += g[j] * xv[j];
    }
    m1 = warp_sum(m1) * inv_c;
    m2 = warp_sum(m2) * inv_c;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      if (!FULL && lane + 32 * j >= C) break;
      const float dx = rstd * (g[j] - m1 - xv[j] * m2);
      const long o = row * C + lane + 32 * j;
      if (dres != nullptr)
        dres[o] += dx;
      else
        dx_bf16[o] = __float2bfloat16_rn(dx);
    }
  }
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    red[warp][0][lane + 32 * j] = acc_s[j];
    red[warp][1][lane + 32 * j] = acc_b[j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * C; i += 32 * WARPS) {
    const int which = i / C, c = i % C;
    float t = 0.f;
    for (int w = 0; w < WARPS; ++w) t += red[w][which][c];
    part[((long)blockIdx.x * 2 + which) * C + c] = t;
  }
}

template <typename T>
int launch(const void* x, const void* dy, const void* s, float eps,
           void* dres, void* dxb, void* part, long M, int C, int rpb,
           cudaStream_t st) {
  dim3 grid((unsigned)((M + rpb - 1) / rpb));
  const T* X = (const T*)x;
  const float* D = (const float*)dy;
  const bf16* S = (const bf16*)s;
#define RVT_LN_BWD(V)                                                      \
  if (C == 32 * V)                                                         \
    ln_bwd_kernel<T, V, true><<<grid, 32 * WARPS, 0, st>>>(                \
        X, D, S, eps, (float*)dres, (bf16*)dxb, (float*)part, M, C, rpb);  \
  else                                                                     \
    ln_bwd_kernel<T, V, false><<<grid, 32 * WARPS, 0, st>>>(               \
        X, D, S, eps, (float*)dres, (bf16*)dxb, (float*)part, M, C, rpb)
  switch ((C + 31) / 32) {
    case 1: RVT_LN_BWD(1); break;
    case 2: RVT_LN_BWD(2); break;
    case 3: RVT_LN_BWD(3); break;
    case 4: RVT_LN_BWD(4); break;
    case 6: RVT_LN_BWD(6); break;
    case 8: RVT_LN_BWD(8); break;
    case 12: RVT_LN_BWD(12); break;
    case 16: RVT_LN_BWD(16); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef RVT_LN_BWD
  return (int)cudaGetLastError();
}

}  // namespace

// x [M, C] f32/bf16, dy [M, C] f32, s [C] bf16; exactly one of dres (f32,
// += dx) and dx_bf16 is set; part [ceil(M / rows_per_block), 2, C] f32.
// C % 16 == 0, 32 <= C <= 512, ceil(C / 32) in {1, 2, 3, 4, 6, 8, 12, 16}
// (every preset width: 32, 48, 64, 96, 128, 192, 256, 384, 512).
extern "C" int rvt_ln_rows_bwd(const void* x, int x_is_f32, const void* dy,
                               const void* s, float eps, void* dres,
                               void* dx_bf16, void* part, long M, int C,
                               int rows_per_block, void* stream) {
  if (C % 16 != 0 || C < 32 || C > 512 ||
      (dres == nullptr) == (dx_bf16 == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_is_f32)
    return launch<float>(x, dy, s, eps, dres, dx_bf16, part, M, C,
                         rows_per_block, st);
  return launch<bf16>(x, dy, s, eps, dres, dx_bf16, part, M, C,
                      rows_per_block, st);
}

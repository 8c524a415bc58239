// K1 ln_rows: LayerNorm over the channel axis of [M, C] rows.
//
// Replaces the LayerNorm steps inside the TPU kernels
// rvt_tpu/ops/fused_attention.py:_layer_norm_f32 (:126, used by _one_block
// for LN1/LN2 and by _stage_scan_kernel / _blocks_kernel for the downsample
// LN) and the forward of rvt_tpu/ops/fused_train.py:_ln_fwd (:116).
// Semantics: f32 statistics with the fast variance max(E[x^2] - E[x]^2, 0),
// affine applied in f32, result rounded to bf16. With ``yf`` set the
// kernel also writes that bf16 result widened to f32: the residual stream
// R that the downsample LN starts.
//
// Bound on the H100: bytes. Each row is read once (4 or 2 bytes an
// element) and written as bf16 (2 bytes) and, with yf, f32 (4 more),
// against about 10 flops an element. Design:
//  * A row is read once, into registers: a group of G lanes (a power of
//    two up to 32) holds it, NV vectors of VEC elements a lane (16-byte
//    loads where C allows, lane l of the group taking vectors l, l + G,
//    ...), so a warp holds 32 / G rows at a time.
//  * The statistics are xor-shuffles within the group, and the normalise
//    pass works on the registers.
//  * A grid-stride loop over a warp's row groups, on the grid of blocks
//    that fit on the card at once: a thread keeps the same columns for all
//    its rows, so it loads the scale and bias once, and the next rows'
//    loads are issued before the current rows' reductions.
//  * Packed stores: y as VEC bf16, yf as float4s.
//  * The lane map and the shuffle order depend on C (and the input type)
//    alone (rvt_tpu_torch/ops/fused_attention.py:ln_rows_plan), never on M
//    or the grid: a row's result is the same whatever launch it is in.
//  * Rows wider than NV_MAX vectors a lane (no preset comes near) take a
//    warp a row that loops over the columns, reading the row twice.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int NV_MAX = 8;

__device__ __forceinline__ void unpack2(unsigned w, float* v) {
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ unsigned pack2(float a, float b) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
}

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    static_assert(VEC == 1, "f32 rows: 4 or 1 elements a load");
    v[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void load_vec(const bf16* p, float* v) {
  if constexpr (VEC == 8) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    unpack2(t.x, v); unpack2(t.y, v + 2); unpack2(t.z, v + 4);
    unpack2(t.w, v + 6);
  } else if constexpr (VEC == 4) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    unpack2(t.x, v); unpack2(t.y, v + 2);
  } else {
    static_assert(VEC == 1, "bf16 vectors: 8, 4 or 1 elements");
    v[0] = __bfloat162float(p[0]);
  }
}

// y (bf16) and, when yf is set, yf (f32) of VEC elements.
template <int VEC>
__device__ __forceinline__ void store_row_vec(bf16* y, float* yf,
                                              const float* o) {
  float w[VEC];  // the bf16 results, widened
#pragma unroll
  for (int e = 0; e < VEC; ++e) w[e] = round_bf16(o[e]);
  if constexpr (VEC == 1) {
    y[0] = __float2bfloat16_rn(o[0]);
    if (yf != nullptr) yf[0] = w[0];
  } else {
    unsigned p[VEC / 2];
#pragma unroll
    for (int e = 0; e < VEC / 2; ++e) p[e] = pack2(o[2 * e], o[2 * e + 1]);
    if constexpr (VEC == 8)
      *reinterpret_cast<uint4*>(y) = make_uint4(p[0], p[1], p[2], p[3]);
    else
      *reinterpret_cast<uint2*>(y) = make_uint2(p[0], p[1]);
    if (yf != nullptr)
#pragma unroll
      for (int e = 0; e < VEC; e += 4)
        *reinterpret_cast<float4*>(yf + e) =
            make_float4(w[e], w[e + 1], w[e + 2], w[e + 3]);
  }
}

// Row `row` (zeros past M) into v: vector k * G + gl of the row per k.
template <typename T, int VEC, int NV>
__device__ __forceinline__ void load_row(const T* __restrict__ x, long row,
                                         long M, int C, int G, int gl,
                                         const bool* ok, float (*v)[VEC]) {
  const T* xr = x + row * C;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (row < M && ok[k]) {
      load_vec<VEC>(xr + (k * G + gl) * VEC, v[k]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[k][e] = 0.f;
    }
  }
}

// A warp takes RG row groups an iteration (2 where a row is one vector a
// lane, for more bytes in flight), and loads the next iteration's rows
// before this one's statistics.
template <typename T, int VEC, int NV, int RG>
__global__ void __launch_bounds__(256)
ln_rows_kernel(const T* __restrict__ x, const bf16* __restrict__ s,
               const bf16* __restrict__ b, bf16* __restrict__ y,
               float* __restrict__ yf, long M, int C, int G, float eps) {
  const int lane = threadIdx.x & 31, gl = lane & (G - 1), gi = lane / G;
  const int rows_w = 32 / G;  // rows a warp holds in one row group
  const int nvec = C / VEC;
  bool ok[NV];
  float sc[NV][VEC], bi[NV][VEC];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int vi = k * G + gl;
    ok[k] = vi < nvec;
    if (ok[k]) {
      load_vec<VEC>(s + vi * VEC, sc[k]);
      load_vec<VEC>(b + vi * VEC, bi[k]);
    }
  }
  const long iters = ((M + rows_w - 1) / rows_w + RG - 1) / RG;
  const long warps = (long)gridDim.x * (blockDim.x >> 5);
  long it = (long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (it >= iters) return;  // whole warps
  long row = it * RG * rows_w + gi;  // group q's row: row + q * rows_w
  float cur[RG][NV][VEC], nxt[RG][NV][VEC];
#pragma unroll
  for (int q = 0; q < RG; ++q)
    load_row<T, VEC, NV>(x, row + q * rows_w, M, C, G, gl, ok, cur[q]);
  while (true) {
    const long nit = it + warps;
    const bool more = nit < iters;  // the same for the whole warp
    const long nrow = nit * RG * rows_w + gi;
    if (more)
#pragma unroll
      for (int q = 0; q < RG; ++q)
        load_row<T, VEC, NV>(x, nrow + q * rows_w, M, C, G, gl, ok, nxt[q]);
    float sum[RG], sq[RG];
#pragma unroll
    for (int q = 0; q < RG; ++q) {
      sum[q] = 0.f;
      sq[q] = 0.f;
#pragma unroll
      for (int k = 0; k < NV; ++k)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          sum[q] += cur[q][k][e];
          sq[q] += cur[q][k][e] * cur[q][k][e];
        }
    }
    for (int o = G >> 1; o > 0; o >>= 1)
#pragma unroll
      for (int q = 0; q < RG; ++q) {
        sum[q] += __shfl_xor_sync(0xffffffffu, sum[q], o);
        sq[q] += __shfl_xor_sync(0xffffffffu, sq[q], o);
      }
#pragma unroll
    for (int q = 0; q < RG; ++q) {
      const long r_q = row + q * rows_w;
      if (r_q >= M) continue;
      const float mu = sum[q] / (float)C;
      const float var = fmaxf(sq[q] / (float)C - mu * mu, 0.f);
      const float r = rsqrtf(var + eps);
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        if (!ok[k]) continue;
        float o[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          o[e] = (cur[q][k][e] - mu) * r * sc[k][e] + bi[k][e];
        const long off = r_q * C + (long)(k * G + gl) * VEC;
        store_row_vec<VEC>(y + off, yf != nullptr ? yf + off : nullptr, o);
      }
    }
    if (!more) break;
#pragma unroll
    for (int q = 0; q < RG; ++q)
#pragma unroll
      for (int k = 0; k < NV; ++k)
#pragma unroll
        for (int e = 0; e < VEC; ++e) cur[q][k][e] = nxt[q][k][e];
    it = nit;
    row = nrow;
  }
}

// Rows past NV_MAX vectors a lane: one warp a row, lanes striding over the
// channels, the row read twice.
template <typename T>
__global__ void __launch_bounds__(256)
ln_rows_wide_kernel(const T* __restrict__ x, const bf16* __restrict__ s,
                    const bf16* __restrict__ b, bf16* __restrict__ y,
                    float* __restrict__ yf, long M, int C, float eps) {
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

// The grid is the blocks that fit on the card at once (every warp then
// strides over about as many row groups), or fewer where M is small.
template <typename T, int VEC, int NV>
int launch(const T* x, const bf16* s, const bf16* b, bf16* y, float* yf,
           long M, int C, float eps, int G, int sms, cudaStream_t st) {
  constexpr int RG = NV == 1 ? 2 : 1;
  static int occ = 0;  // blocks an SM, per instance
  if (occ == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, ln_rows_kernel<T, VEC, NV, RG>, 256, 0);
    occ = std::max(occ, 1);
  }
  const long iters = ((M + 32 / G - 1) / (32 / G) + RG - 1) / RG;
  const int blocks =
      (int)std::max(1L, std::min((iters + 7) / 8, (long)occ * sms));
  ln_rows_kernel<T, VEC, NV, RG><<<blocks, 256, 0, st>>>(x, s, b, y, yf, M,
                                                         C, G, eps);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_nv(const T* x, const bf16* s, const bf16* b, bf16* y, float* yf,
              long M, int C, float eps, int G, int nv, int sms,
              cudaStream_t st) {
#define RVT_LN(NV) \
  case NV:         \
    return launch<T, VEC, NV>(x, s, b, y, yf, M, C, eps, G, sms, st)
  switch (nv) {
    RVT_LN(1); RVT_LN(2); RVT_LN(3); RVT_LN(4);
    RVT_LN(5); RVT_LN(6); RVT_LN(7); RVT_LN(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef RVT_LN
}

template <typename T>
int launch_any(const T* x, const bf16* s, const bf16* b, bf16* y, float* yf,
               long M, int C, float eps, int vec, int G, int nv, int sms,
               cudaStream_t st) {
  constexpr int FULL = 16 / sizeof(T);  // elements a 16-byte load
  if (nv == 0) {
    const unsigned blocks = (unsigned)((M + 7) / 8);
    ln_rows_wide_kernel<T><<<blocks, 256, 0, st>>>(x, s, b, y, yf, M, C, eps);
    return (int)cudaGetLastError();
  }
  if (G < 1 || G > 32 || (G & (G - 1)) != 0 || nv > NV_MAX)
    return (int)cudaErrorInvalidValue;
  if (vec == FULL)
    return launch_nv<T, FULL>(x, s, b, y, yf, M, C, eps, G, nv, sms, st);
  if (vec == 1)
    return launch_nv<T, 1>(x, s, b, y, yf, M, C, eps, G, nv, sms, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// vec, group, nv: the lane map of ln_rows_plan (nv 0: the wide kernel, a
// warp a row); sms: the card's streaming multiprocessors.
extern "C" int rvt_ln_rows(const void* x, int x_is_f32, const void* s,
                           const void* b, void* y, void* yf, long M, int C,
                           float eps, int vec, int group, int nv, int sms,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (x_is_f32)
    return launch_any<float>((const float*)x, (const bf16*)s, (const bf16*)b,
                             (bf16*)y, (float*)yf, M, C, eps, vec, group, nv,
                             sms, st);
  return launch_any<bf16>((const bf16*)x, (const bf16*)s, (const bf16*)b,
                          (bf16*)y, (float*)yf, M, C, eps, vec, group, nv,
                          sms, st);
}

// window_s2d: a stored uint8 event window to the s2d stem's bf16 operand,
// in one pass (ops/s2d.py:window_s2d).
//
// Not a TPU kernel: the JAX package blocks the window on the host or with
// XLA (rvt_tpu/ops/s2d.py:device_space_to_depth) and lets the stem conv
// cast it. On the card those were four library passes over the window (the
// channel-last pad, the s2d reshape, the step's T/B transpose, the cast
// to bf16), about 3.7 GB of traffic for gen1 RVT-B's 245 MB window. Here
// one block reads its input rows once and writes its output row once.
//
// x: [B, T, H, W, C] uint8 at element strides (sB, sT, sH, sW, sC): the
// channel-last view of the stored [B, T, C, H, W] buffer (sW = 1, sC =
// H * W), or any other layout. out: [T, B, Hp, Wp, 16 C] bf16, contiguous,
// T-major: out[t, b, p, q, (4 a + e) C + c] = x[b, t, 4 p + a - 4,
// 4 q + e - 4, c], zero outside the window (the one-block top/left pad and
// the corner pad to the model's resolution, 4 Hp - 4 by 4 Wp - 4): exactly
// device_space_to_depth of each frame, transposed and cast (uint8 values
// are exact in bf16).
//
// Bound: bytes, B T H W C read and 32 B T Hp Wp C written once (gen1 RVT-B
// eval: 245.1 + 566.1 MB, 0.242 ms at 3.35 TB/s). Design: one block per
// output block-row (t, b, p). It reads the 4 input rows of its p and stages
// them in shared memory as [a][4 Wp][C], the output row's own byte order,
// so that the row is then written front to back: 8 bf16 (16 bytes) a
// thread from 8 contiguous staged bytes. The stored layout's rows are read
// with 16-byte loads, 4 channels a thread, and transposed to channel-last
// in registers (__byte_perm) before 4-byte shared stores; the pad columns
// are zeroed in shared memory, pad rows written as zeros without a read.
// Other layouts (or W, C, strides off the 16-byte grid) stage a byte a
// thread. A byte becomes a float by the 2^23 trick (no int-to-float
// conversion, which runs at a quarter rate) and a bf16 by its top half,
// exact for 8-bit integers.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr size_t SMEM_DEFAULT = 48 * 1024;  // a block's without opting in

// Four channels' words (4 consecutive w each) -> four channel-last words
// (4 consecutive c each, one a w).
__device__ __forceinline__ void transpose4(uint32_t x0, uint32_t x1,
                                           uint32_t x2, uint32_t x3,
                                           uint32_t* y) {
  const uint32_t t0 = __byte_perm(x0, x1, 0x5140);
  const uint32_t t1 = __byte_perm(x0, x1, 0x7362);
  const uint32_t t2 = __byte_perm(x2, x3, 0x5140);
  const uint32_t t3 = __byte_perm(x2, x3, 0x7362);
  y[0] = __byte_perm(t0, t2, 0x5410);
  y[1] = __byte_perm(t0, t2, 0x7632);
  y[2] = __byte_perm(t1, t3, 0x5410);
  y[3] = __byte_perm(t1, t3, 0x7632);
}

// Byte i of u as a float's bits: 2^23 + u_i.
template <int I>
__device__ __forceinline__ uint32_t byte_f(uint32_t u) {
  const float f =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | I)) - 8388608.0f;
  return __float_as_uint(f);
}

// Four uint8 values (a word, first at the low byte) -> four bf16 (two
// words, in the same order).
__device__ __forceinline__ uint2 to_bf16x4(uint32_t u) {
  return make_uint2(__byte_perm(byte_f<0>(u), byte_f<1>(u), 0x7632),
                    __byte_perm(byte_f<2>(u), byte_f<3>(u), 0x7632));
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
window_s2d_kernel(const uint8_t* __restrict__ x, uint4* __restrict__ out,
                  int B, int H, int W, int C, long sB, long sT, long sH,
                  long sW, long sC, int Hp, int Wp) {
  extern __shared__ __align__(16) uint8_t tile[];  // [4][4 Wp][C]
  const int p = blockIdx.x, b = blockIdx.y, t = blockIdx.z;
  const int rowC = 4 * Wp * C;  // staged bytes of one input row
  const int r0 = 4 * p - 4;     // the input row of a = 0
  const uint8_t* xf = x + b * sB + t * sT;
  // the rows a of this block that lie in the window: [a_lo, a_hi)
  const int a_lo = max(0, -r0), a_hi = min(4, H - r0);
  const int na = max(0, a_hi - a_lo);

  // the pad columns of those rows: [0, 4) and [W + 4, 4 Wp)
  const int padc = 4 * Wp - W;
  for (int i = threadIdx.x; i < na * padc * C; i += THREADS) {
    const int c = i % C, j = i / C;
    const int a = a_lo + j / padc, k = j % padc;
    tile[a * rowC + (k < 4 ? k : W + k) * C + c] = 0;
  }
  if (VEC) {
    // 16 w of 4 channels a thread; channel groups fastest, then chunks of
    // 16 w, so that a warp reads a few runs of contiguous bytes
    const int G = C >> 2, NW = W >> 4;
    for (int i = threadIdx.x; i < na * NW * G; i += THREADS) {
      const int g = i % G, rest = i / G;
      const int chunk = rest % NW, a = a_lo + rest / NW;
      const uint8_t* src = xf + (long)(r0 + a) * sH + (long)(4 * g) * sC +
                           16 * chunk;
      const uint4 v0 = __ldcs(reinterpret_cast<const uint4*>(src));
      const uint4 v1 = __ldcs(reinterpret_cast<const uint4*>(src + sC));
      const uint4 v2 = __ldcs(reinterpret_cast<const uint4*>(src + 2 * sC));
      const uint4 v3 = __ldcs(reinterpret_cast<const uint4*>(src + 3 * sC));
      uint32_t* dst = reinterpret_cast<uint32_t*>(
          tile + a * rowC + (4 + 16 * chunk) * C + 4 * g);
      const int step = C >> 2;  // words from one w to the next
      uint32_t y[4];
      transpose4(v0.x, v1.x, v2.x, v3.x, y);
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[j * step] = y[j];
      transpose4(v0.y, v1.y, v2.y, v3.y, y);
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[(4 + j) * step] = y[j];
      transpose4(v0.z, v1.z, v2.z, v3.z, y);
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[(8 + j) * step] = y[j];
      transpose4(v0.w, v1.w, v2.w, v3.w, y);
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[(12 + j) * step] = y[j];
    }
  } else {
    for (int i = threadIdx.x; i < na * W * C; i += THREADS) {
      const int c = i % C, j = i / C;
      const int w = j % W, a = a_lo + j / W;
      tile[a * rowC + (w + 4) * C + c] =
          xf[(long)(r0 + a) * sH + (long)w * sW + (long)c * sC];
    }
  }
  __syncthreads();

  // the output row [Wp, 16 C] bf16, 8 elements (16 bytes) a thread
  const int nv = 2 * Wp * C;
  uint4* orow = out + ((long)(t * B + b) * Hp + p) * nv;
  const int span = 4 * C;  // elements of one a in a q's 16 C
  for (int v = threadIdx.x; v < nv; v += THREADS) {
    const int q = v / (2 * C);
    const int k0 = (v - q * 2 * C) * 8;  // element within q's 16 C
    uint32_t u0 = 0, u1 = 0;
    if (VEC) {
      // C % 4 == 0: the 8 elements lie in one a, 8 aligned staged bytes
      const int a = k0 / span;
      if (a >= a_lo && a < a_hi) {
        const uint2 s = *reinterpret_cast<const uint2*>(
            tile + a * rowC + 4 * q * C + (k0 - a * span));
        u0 = s.x;
        u1 = s.y;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int a = (k0 + e) / span;
        const uint32_t byte =
            (a >= a_lo && a < a_hi)
                ? tile[a * rowC + 4 * q * C + (k0 + e - a * span)]
                : 0u;
        if (e < 4)
          u0 |= byte << (8 * e);
        else
          u1 |= byte << (8 * (e - 4));
      }
    }
    const uint2 lo = to_bf16x4(u0), hi = to_bf16x4(u1);
    orow[v] = make_uint4(lo.x, lo.y, hi.x, hi.y);
  }
}

}  // namespace

// Hp, Wp: the blocked frame (ops/s2d.py:s2d_input_hw); the wrapper checks
// H <= 4 Hp - 4, W <= 4 Wp - 4 and that 16 Wp C bytes fit a block.
extern "C" int rvt_window_s2d(const void* x, void* out, int B, int T, int H,
                              int W, int C, long sB, long sT, long sH,
                              long sW, long sC, int Hp, int Wp,
                              void* stream) {
  if (B > 0 && T > 0 && Hp > 0) {
    const size_t smem = (size_t)16 * Wp * C;
    const bool vec = sW == 1 && W % 16 == 0 && C % 4 == 0 &&
                     (uintptr_t)x % 16 == 0 && sB % 16 == 0 &&
                     sT % 16 == 0 && sH % 16 == 0 && sC % 16 == 0;
    const void* fn = vec ? (const void*)window_s2d_kernel<true>
                         : (const void*)window_s2d_kernel<false>;
    // above the default, the launch's own need, on the current device
    if (smem > SMEM_DEFAULT) {
      const cudaError_t e = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    const dim3 grid(Hp, B, T);
    cudaStream_t st = (cudaStream_t)stream;
    if (vec)
      window_s2d_kernel<true><<<grid, THREADS, smem, st>>>(
          (const uint8_t*)x, (uint4*)out, B, H, W, C, sB, sT, sH, sW, sC, Hp,
          Wp);
    else
      window_s2d_kernel<false><<<grid, THREADS, smem, st>>>(
          (const uint8_t*)x, (uint4*)out, B, H, W, C, sB, sT, sH, sW, sC, Hp,
          Wp);
  }
  return (int)cudaGetLastError();
}

// K4 lstm_scan: the 1x1 ConvLSTM cell scanned over a whole window.
//
// Replaces the TPU kernels rvt_tpu/ops/fused_scan.py:_lstm_scan_kernel
// (and its stage-scan epilogue in _stage_scan_kernel) and, at T = 1,
// rvt_tpu/ops/fused_lstm.py:_lstm_kernel. Per pixel and step:
//   mix = bf16(bf16([x_t, bf16(h)] . W[2C, 4C]) + b)      f32 accumulation
//   f, i, o = bf16(sigmoid(mix[:3C]))    g = bf16(tanh(mix[3C:]))
//   c = f*c + i*g    h = o*tanh(c)        (f32; h fed back as bf16)
// Outputs h_seq [T, B, P, C] bf16 per step and h_T, c_T [B, P, C] f32;
// for training (rvt_tpu/ops/fused_train.py:_lstm_scan_fwd_train_kernel)
// also c_seq [T, B, P, C] f32 when ``cseq`` is set: with h_seq these are
// the per-step carries the backward (lstm_scan_bwd.cu) reads.
//
// The TPU's sequential grid axis over t becomes a loop inside the block:
// one block owns 16 pixels of one lane for the whole window, so the
// (h, c) carry stays in shared memory and never goes to device memory.
// The cell is pointwise over pixels, so blocks are independent.
//
// Bound on the H100: operations at the gen1 RVT-B shapes (2*2C*4C flops
// per pixel and step against ~2C*(2 or 4)+2C*2 bytes), but in practice
// latency: 21 dependent steps, and at stage 4 only 40 blocks. Design:
// bf16 WMMA (mma.sync) with the [x, h] rows in shared memory as the A
// operand and W's tiles read straight from global memory, where L2
// (50 MB) holds the whole W (2 MB at C = 512) for all blocks. A group of
// four warps computes one chunk of <= 64 channels, one warp per gate, so
// the gate math for a channel finds f, i, o, g in one shared-memory
// tile; up to four groups work on different chunks at once, so that a
// wide stage (few blocks, many channels) keeps 16 warps per block busy.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int PT = 16;  // pixels per block (one WMMA row tile)

__device__ __forceinline__ bf16 to_bf16(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ bf16 to_bf16(bf16 v) { return v; }

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.f / (1.f + expf(-v));
}

// Channel chunk CC (<= 64) and the number G of four-warp groups that
// work on different chunks at once.
struct Smem {
  int CC, G, LDX, LDH, LDM;
  __host__ __device__ Smem(int C, int groups)
      : CC(C < 64 ? C : 64), G(groups), LDX(2 * C + 8), LDH(C + 8),
        LDM(4 * (C < 64 ? C : 64) + 4) {}
  __host__ __device__ size_t bytes(int C) const {
    return (size_t)PT * LDX * 2 + (size_t)PT * LDH * 2 + (size_t)PT * C * 4 +
           (size_t)G * PT * LDM * 4;
  }
};

template <typename TX, int G>
__global__ void __launch_bounds__(128 * G)
lstm_scan_kernel(const TX* __restrict__ x, const bf16* __restrict__ w,
                 const bf16* __restrict__ bias, const float* __restrict__ h0,
                 const float* __restrict__ c0, bf16* __restrict__ hseq,
                 float* __restrict__ cseq, float* __restrict__ hT,
                 float* __restrict__ cT, int T, int B, int P, int C) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem S(C, G);
  const int CC = S.CC, NT = 128 * G;
  bf16* XH = reinterpret_cast<bf16*>(smem);  // [PT, 2C]: x_t | h_{t-1}
  bf16* Hn = XH + PT * S.LDX;                // [PT, C]: h_t (bf16)
  float* Cs = reinterpret_cast<float*>(Hn + PT * S.LDH);  // [PT, C]: c
  float* Mx = Cs + PT * C;                   // [G, PT, 4*CC]: mix chunks

  const int tid = threadIdx.x, warp = tid >> 5;
  const int gate = warp & 3, grp = warp >> 2;
  const int p0 = blockIdx.x * PT, lane_b = blockIdx.y;
  const int rows = min(PT, P - p0);
  const int N4 = 4 * C;

  for (int i = tid; i < PT * C; i += NT) {
    const int r = i / C, ch = i % C;
    const long g = ((long)lane_b * P + p0 + r) * C + ch;
    XH[r * S.LDX + C + ch] = to_bf16(r < rows ? h0[g] : 0.f);
    Cs[r * C + ch] = r < rows ? c0[g] : 0.f;
  }

  for (int t = 0; t < T; ++t) {
    const long xrow = ((long)t * B + lane_b) * P + p0;
    for (int i = tid; i < PT * C; i += NT) {
      const int r = i / C, ch = i % C;
      XH[r * S.LDX + ch] =
          r < rows ? to_bf16(x[(xrow + r) * C + ch]) : to_bf16(0.f);
    }
    __syncthreads();

    for (int c0r = 0; c0r < C; c0r += CC * G) {
      // this warp: gate `gate` of the chunk starting at channel cc
      const int cc = c0r + grp * CC;
      const int nf = CC / 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
      const bf16* wcol = w + gate * C + cc;
      const int kend = cc < C ? 2 * C : 0;  // last round may be partial
#pragma unroll(G > 1 ? 2 : 1)
      for (int k = 0; k < kend; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, XH + k, S.LDX);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j >= nf) break;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, wcol + (long)k * N4 + 16 * j, N4);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
      float* mx = Mx + grp * PT * S.LDM;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < nf && cc < C)
          wmma::store_matrix_sync(mx + gate * CC + 16 * j, acc[j], S.LDM,
                                  wmma::mem_row_major);
      __syncthreads();

      for (int i = tid; i < G * PT * CC; i += NT) {
        const int gi = i / (PT * CC), rem = i % (PT * CC);
        const int r = rem / CC, j = rem % CC, ch = c0r + gi * CC + j;
        if (ch >= C) break;  // i grows with gi: the rest is past C too
        const float* m = Mx + (gi * PT + r) * S.LDM + j;
        const float vf = round_bf16(round_bf16(m[0]) +
                                    __bfloat162float(bias[ch]));
        const float vi = round_bf16(round_bf16(m[CC]) +
                                    __bfloat162float(bias[C + ch]));
        const float vo = round_bf16(round_bf16(m[2 * CC]) +
                                    __bfloat162float(bias[2 * C + ch]));
        const float vg = round_bf16(round_bf16(m[3 * CC]) +
                                    __bfloat162float(bias[3 * C + ch]));
        const float f = round_bf16(sigmoidf(vf));
        const float in = round_bf16(sigmoidf(vi));
        const float o = round_bf16(sigmoidf(vo));
        const float g = round_bf16(tanhf(vg));
        const float c = f * Cs[r * C + ch] + in * g;
        const float h = o * tanhf(c);
        Cs[r * C + ch] = c;
        Hn[r * S.LDH + ch] = __float2bfloat16_rn(h);
        if (r < rows) {
          const long out = (xrow + r) * C + ch;
          hseq[out] = __float2bfloat16_rn(h);
          if (cseq != nullptr) cseq[out] = c;
          if (t == T - 1) {
            const long st = ((long)lane_b * P + p0 + r) * C + ch;
            hT[st] = h;
            cT[st] = c;
          }
        }
      }
      __syncthreads();
    }

    for (int i = tid; i < PT * C; i += NT) {
      const int r = i / C, ch = i % C;
      XH[r * S.LDX + C + ch] = Hn[r * S.LDH + ch];
    }
  }
}

template <typename TX, int G>
int launch_groups(const void* x, const bf16* w, const bf16* b,
                  const float* h0, const float* c0, bf16* hseq, float* cseq,
                  float* hT, float* cT, int T, int B, int P, int C,
                  cudaStream_t st) {
  const size_t smem = Smem(C, G).bytes(C);
  cudaError_t e = cudaFuncSetAttribute(
      lstm_scan_kernel<TX, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((P + PT - 1) / PT, B);
  lstm_scan_kernel<TX, G><<<grid, 128 * G, smem, st>>>(
      (const TX*)x, w, b, h0, c0, hseq, cseq, hT, cT, T, B, P, C);
  return (int)cudaGetLastError();
}

// Many blocks (gen1 stages 1-2: 2560, 640) fill the card with one group
// each; a wide stage with few blocks (stages 3-4: 160 and 40) splits its
// channel chunks over up to four groups.
template <typename TX>
int launch(const void* x, const bf16* w, const bf16* b, const float* h0,
           const float* c0, bf16* hseq, float* cseq, float* hT, float* cT,
           int T, int B, int P, int C, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long blocks = (long)((P + PT - 1) / PT) * B;
  const int chunks = C / (C < 64 ? C : 64);
  int g = blocks >= 2 * sms ? 1 : (chunks >= 4 ? 4 : chunks >= 2 ? 2 : 1);
  if (g == 4)
    return launch_groups<TX, 4>(x, w, b, h0, c0, hseq, cseq, hT, cT, T, B, P,
                                C, st);
  if (g == 2)
    return launch_groups<TX, 2>(x, w, b, h0, c0, hseq, cseq, hT, cT, T, B, P,
                                C, st);
  return launch_groups<TX, 1>(x, w, b, h0, c0, hseq, cseq, hT, cT, T, B, P, C,
                              st);
}

}  // namespace

extern "C" int rvt_lstm_scan(const void* x, int x_is_f32, const void* w,
                             const void* b, const void* h0, const void* c0,
                             void* hseq, void* cseq, void* hT, void* cT,
                             int T, int B, int P, int C, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bf16* W = (const bf16*)w;
  const bf16* bb = (const bf16*)b;
  if (x_is_f32)
    return launch<float>(x, W, bb, (const float*)h0, (const float*)c0,
                         (bf16*)hseq, (float*)cseq, (float*)hT, (float*)cT, T,
                         B, P, C, st);
  return launch<bf16>(x, W, bb, (const float*)h0, (const float*)c0,
                      (bf16*)hseq, (float*)cseq, (float*)hT, (float*)cT, T, B,
                      P, C, st);
}

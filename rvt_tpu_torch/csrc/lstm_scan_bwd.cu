// K8 lstm_scan_bwd: backpropagation through time of the 1x1 ConvLSTM cell
// over a whole window.
//
// Replaces the TPU kernel rvt_tpu/ops/fused_train.py:_lstm_scan_bwd_kernel
// (with _lstm_bwd_chunked :523). Reverse time, per pixel and step t:
//   xh   = [bf16(x_t), h_{t-1}]   (h_{-1} = bf16(h0); c_{t-1}, c_{-1} = c0)
//   mix  = bf16(bf16(xh . W) + b); f, i, o = bf16(sigmoid); g = bf16(tanh)
//   c_t  = f*c_{t-1} + i*g;  dh = dh_carry + dh_seq[t];  dc = dc_carry
//   dct  = dc + dh*o*(1 - tanh(c_t)^2)
//   dmix = [dct*c_{t-1}*f*(1-f), dct*g*i*(1-i), dh*tanh(c_t)*o*(1-o),
//           dct*i*(1-g^2)]                                  (f32, :551-555)
//   dxh  = bf16(dmix) . W^T (f32);  dx_t = dxh[:, :C]
//   dh_carry = dxh[:, C:];  dc_carry = dct * f
// It writes dx [T, B, P, C] f32, dh0/dc0 (the carries after step 0),
// bf16(dmix) [T, B, P, 4C] and xh [T, B, P, 2C] bf16 for the weight
// gradient dW = xh^T . bf16(dmix) (K6), and the column sums of the f32
// dmix over the block's pixels and steps (db, :558) into part[block, 4C].
//
// As in K4, the TPU's sequential grid axis over t becomes a loop inside
// the block: a block owns 16 pixels of one lane for the whole window, the
// gates are recomputed from the saved carries (h_seq, c_seq) with K4's
// products, and the (dh, dc) carries live in the dh0/dc0 outputs, which
// only this block touches. Bound on the H100: operations (two 2C x 4C
// products per pixel and step) but in practice latency, as K4: 21
// dependent steps, at stage 4 only 40 blocks. Design: K4's forward
// products (bf16 WMMA, W read through L2; four warps per 64-channel
// chunk, up to four such groups at the wide stages), the f32 dmix of a
// chunk summed over pixels in shared memory in a fixed order, then the
// whole bf16 dmix row (shared memory) times W^T as col_major fragments
// of W itself.
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

struct Smem {
  int CC, G, LDX, LDD, LDM, LDS2;
  __host__ __device__ Smem(int C, int groups)
      : CC(C < 64 ? C : 64), G(groups), LDX(2 * C + 8), LDD(4 * C + 8),
        LDM(4 * (C < 64 ? C : 64) + 4), LDS2(2 * C + 4) {}
  __host__ __device__ int scratch_floats() const {
    const int a = G * PT * LDM, b = PT * LDS2;
    return a > b ? a : b;
  }
  __host__ __device__ size_t bytes(int C) const {
    return (size_t)PT * LDX * 2 + (size_t)PT * LDD * 2 +
           (size_t)scratch_floats() * 4 + (size_t)4 * C * 4;
  }
};

template <typename TX, int G>
__global__ void __launch_bounds__(128 * G)
lstm_bwd_kernel(const TX* __restrict__ x, const bf16* __restrict__ w,
                const bf16* __restrict__ bias, const float* __restrict__ h0,
                const float* __restrict__ c0, const bf16* __restrict__ hseq,
                const float* __restrict__ cseq,
                const bf16* __restrict__ dhseq, const float* __restrict__ dhT,
                const float* __restrict__ dcT, float* __restrict__ dx,
                bf16* __restrict__ dmix, bf16* __restrict__ xh_out,
                float* __restrict__ dh0, float* __restrict__ dc0,
                float* __restrict__ part, int T, int B, int P, int C) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem S(C, G);
  const int CC = S.CC, NT = 128 * G;
  bf16* XH = reinterpret_cast<bf16*>(smem);  // [PT, 2C]: x_t | h_{t-1}
  bf16* DM = XH + PT * S.LDX;                // [PT, 4C]: bf16(dmix)
  float* Mx = reinterpret_cast<float*>(DM + PT * S.LDD);  // mix, dmix, dxh
  float* DB = Mx + S.scratch_floats();       // [4C]: sum of dmix

  const int tid = threadIdx.x, warp = tid >> 5;
  const int gate = warp & 3, grp = warp >> 2;
  const int p0 = blockIdx.x * PT, lane_b = blockIdx.y;
  const int rows = min(PT, P - p0);
  const int N4 = 4 * C, C2 = 2 * C;
  const long plane = (long)B * P;  // pixels per time step
  const long st0 = ((long)lane_b * P + p0) * C;

  for (int i = tid; i < rows * C; i += NT) {
    dh0[st0 + i] = dhT[st0 + i];
    dc0[st0 + i] = dcT[st0 + i];
  }
  for (int i = tid; i < N4; i += NT) DB[i] = 0.f;
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    const long xrow = (long)t * plane + (long)lane_b * P + p0;
    for (int i = tid; i < PT * C; i += NT) {
      const int r = i / C, ch = i % C;
      bf16 xv = to_bf16(0.f), hv = to_bf16(0.f);
      if (r < rows) {
        xv = to_bf16(x[(xrow + r) * C + ch]);
        hv = t > 0 ? hseq[(xrow - plane + r) * C + ch]
                   : to_bf16(h0[st0 + (long)r * C + ch]);
        xh_out[(xrow + r) * C2 + ch] = xv;
        xh_out[(xrow + r) * C2 + C + ch] = hv;
      }
      XH[r * S.LDX + ch] = xv;
      XH[r * S.LDX + C + ch] = hv;
    }
    __syncthreads();

    for (int c0r = 0; c0r < C; c0r += CC * G) {
      // this warp: gate `gate` of the chunk starting at channel cc (K4)
      const int cc = c0r + grp * CC;
      const int nf = CC / 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
      const bf16* wcol = w + gate * C + cc;
      const int kend = cc < C ? C2 : 0;
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
        float* m = Mx + (gi * PT + r) * S.LDM + j;
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
        const long st = st0 + (long)r * C + ch;
        const long oi = (xrow + r) * C + ch;
        float cp = 0.f, dh = 0.f, dc = 0.f;
        if (r < rows) {
          cp = t > 0 ? cseq[oi - plane * C] : c0[st];
          dh = dh0[st] + __bfloat162float(dhseq[oi]);
          dc = dc0[st];
        }
        const float c = f * cp + in * g;
        const float tc = tanhf(c);
        const float dct = dc + dh * o * (1.f - tc * tc);
        const float d0 = dct * cp * f * (1.f - f);
        const float d1 = dct * g * in * (1.f - in);
        const float d2 = dh * tc * o * (1.f - o);
        const float d3 = dct * in * (1.f - g * g);
        m[0] = d0;
        m[CC] = d1;
        m[2 * CC] = d2;
        m[3 * CC] = d3;
        const bf16 b0 = to_bf16(d0), b1 = to_bf16(d1), b2 = to_bf16(d2),
                   b3 = to_bf16(d3);
        bf16* dm = DM + r * S.LDD + ch;
        dm[0] = b0;
        dm[C] = b1;
        dm[2 * C] = b2;
        dm[3 * C] = b3;
        if (r < rows) {
          dc0[st] = dct * f;
          bf16* out = dmix + (xrow + r) * N4 + ch;
          out[0] = b0;
          out[C] = b1;
          out[2 * C] = b2;
          out[3 * C] = b3;
        }
      }
      __syncthreads();

      // db: this round's f32 dmix summed over the 16 pixels, in order
      for (int col = tid; col < G * 4 * CC; col += NT) {
        const int gi = col / (4 * CC), rem = col % (4 * CC);
        const int gt = rem / CC, j = rem % CC, ch = c0r + gi * CC + j;
        if (ch >= C) continue;
        float s = 0.f;
        for (int r = 0; r < PT; ++r) s += Mx[(gi * PT + r) * S.LDM + gt * CC + j];
        DB[gt * C + ch] += s;
      }
      __syncthreads();
    }

    // dxh = bf16(dmix) . W^T: element (k, n) of W^T is W[n][k], a
    // col_major fragment of W with leading dimension 4C
    float* S2 = Mx;
    for (int tile = warp; tile < C2 / 16; tile += 4 * G) {
      const int n0 = tile * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      const bf16* wrow = w + (long)n0 * N4;
#pragma unroll 4
      for (int k = 0; k < N4; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, DM + k, S.LDD);
        wmma::load_matrix_sync(b, wrow + k, N4);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(S2 + n0, acc, S.LDS2, wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = tid; i < rows * C2; i += NT) {
      const int r = i / C2, col = i % C2;
      const float v = S2[r * S.LDS2 + col];
      if (col < C)
        dx[(xrow + r) * C + col] = v;
      else
        dh0[st0 + (long)r * C + col - C] = v;
    }
    __syncthreads();
  }
  float* dst = part + ((long)blockIdx.y * gridDim.x + blockIdx.x) * N4;
  for (int i = tid; i < N4; i += NT) dst[i] = DB[i];
}

template <typename TX, int G>
int launch_groups(const void* x, const bf16* w, const bf16* b,
                  const float* h0, const float* c0, const bf16* hseq,
                  const float* cseq, const bf16* dhseq, const float* dhT,
                  const float* dcT, float* dx, bf16* dmix, bf16* xh,
                  float* dh0, float* dc0, float* part, int T, int B, int P,
                  int C, cudaStream_t st) {
  const size_t smem = Smem(C, G).bytes(C);
  cudaError_t e = cudaFuncSetAttribute(
      lstm_bwd_kernel<TX, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((P + PT - 1) / PT, B);
  lstm_bwd_kernel<TX, G><<<grid, 128 * G, smem, st>>>(
      (const TX*)x, w, b, h0, c0, hseq, cseq, dhseq, dhT, dcT, dx, dmix, xh,
      dh0, dc0, part, T, B, P, C);
  return (int)cudaGetLastError();
}

// K4's rule: many blocks (stages 1-2) one group each; a wide stage with
// few blocks splits its channel chunks over up to four groups.
template <typename TX>
int launch(const void* x, const bf16* w, const bf16* b, const float* h0,
           const float* c0, const bf16* hseq, const float* cseq,
           const bf16* dhseq, const float* dhT, const float* dcT, float* dx,
           bf16* dmix, bf16* xh, float* dh0, float* dc0, float* part, int T,
           int B, int P, int C, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long blocks = (long)((P + PT - 1) / PT) * B;
  const int chunks = C / (C < 64 ? C : 64);
  const int g = blocks >= 2 * sms ? 1 : (chunks >= 4 ? 4 : chunks >= 2 ? 2 : 1);
#define RVT_LSTM_BWD(GR)                                                     \
  return launch_groups<TX, GR>(x, w, b, h0, c0, hseq, cseq, dhseq, dhT, dcT, \
                               dx, dmix, xh, dh0, dc0, part, T, B, P, C, st)
  if (g == 4) RVT_LSTM_BWD(4);
  if (g == 2) RVT_LSTM_BWD(2);
  RVT_LSTM_BWD(1);
#undef RVT_LSTM_BWD
}

}  // namespace

// x [T, B, P, C] f32/bf16 (the cell's input, rounded to bf16 on load);
// w [2C, 4C], b [4C] bf16; h0, c0, dhT, dcT, dh0, dc0 [B, P, C] f32;
// h_seq, dh_seq [T, B, P, C] bf16; c_seq, dx [T, B, P, C] f32;
// dmix [T, B, P, 4C] and xh [T, B, P, 2C] bf16; part
// [B * ceil(P / 16), 4C] f32. C % 16 == 0 and (C < 64 or C % 64 == 0).
extern "C" int rvt_lstm_scan_bwd(const void* x, int x_is_f32, const void* w,
                                 const void* b, const void* h0,
                                 const void* c0, const void* hseq,
                                 const void* cseq, const void* dhseq,
                                 const void* dhT, const void* dcT, void* dx,
                                 void* dmix, void* xh, void* dh0, void* dc0,
                                 void* part, int T, int B, int P, int C,
                                 void* stream) {
  if (C % 16 != 0 || (C >= 64 && C % 64 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bf16* W = (const bf16*)w;
  const bf16* bb = (const bf16*)b;
#define RVT_ARGS                                                            \
  x, W, bb, (const float*)h0, (const float*)c0, (const bf16*)hseq,          \
      (const float*)cseq, (const bf16*)dhseq, (const float*)dhT,            \
      (const float*)dcT, (float*)dx, (bf16*)dmix, (bf16*)xh, (float*)dh0,   \
      (float*)dc0, (float*)part, T, B, P, C, st
  if (x_is_f32) return launch<float>(RVT_ARGS);
  return launch<bf16>(RVT_ARGS);
#undef RVT_ARGS
}

// K7 partition_attention_bwd: backward of MaxViT window or grid attention,
// per head.
//
// Replaces the attention backward of the TPU kernels
// rvt_tpu/ops/fused_train.py:_block_bwd (_attn_heads_bwd :234, partition
// mode). Inputs are the image-order qkv [N, H, W, 3C] bf16 (per-head
// interleaved q | k | v, as K3 reads it) and the cotangent of the head
// concat, dO [N, H, W, C] bf16 (the JAX backward rounds dattn to bf16
// before use, :246/:260). Output dqkv [N, H, W, 3C] bf16 in qkv's layout.
// Per (frame, partition, head), with the JAX rounding points:
//   P  = bf16(softmax(scale * Q K^T))        recomputed, f32 softmax
//   dV = P^T dO       dP = dO V^T (f32)
//   dS = bf16(scale * P o (dP - rowsum(dP o P)))
//   dQ = dS K         dK = dS^T Q              (f32 sums, bf16 out)
//
// One block per (frame, partition, head), with K3's window/grid
// addressing: token t = (a, b) of partition (i, j) sits at pixel
//   window: (i*ph + a, j*pw + b)      grid: (a*nh + i, b*nw + j).
// Bound on the H100: bytes at these shapes (80 tokens x dh 32: 4 reads
// and 3 writes of 80x32 bf16 per block against 5 products of 80x80x32).
// Design: q, k, v and dO of the partition go to shared memory once; every
// product runs as bf16 WMMA (mma.sync) tiles on the token count padded to
// 16, transposed operands read as col_major fragments; scores, P, dP and
// dS never leave shared memory (81 KB at 80 tokens and dh 32; 211 KB at
// the limits of 128 tokens and dh 64).
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;

template <int DH>
struct Layout {
  static constexpr int LDQ = DH + 8;  // q, k, v, dO rows (bf16)
  static constexpr int LDO = DH + 4;  // dq/dk/dv staging rows (f32)
  int NP, LDS, LDP, LDSO;
  __host__ __device__ explicit Layout(int np)
      : NP(np), LDS(np + 4), LDP(np + 8),
        LDSO((np + 4) > (DH + 4) ? (np + 4) : (DH + 4)) {}
  __host__ __device__ size_t bytes() const {
    return (size_t)4 * NP * LDQ * 2 + (size_t)NP * LDSO * 4 +
           (size_t)2 * NP * LDP * 2;
  }
};

template <int DH>
__global__ void __launch_bounds__(THREADS)
attn_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dO,
                bf16* __restrict__ dqkv, int H, int W, int C, int ph, int pw,
                int window, int n, int NP, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout<DH> L(NP);
  constexpr int LDQ = Layout<DH>::LDQ, LDO = Layout<DH>::LDO;
  constexpr int CH = DH / 8;  // 16-byte chunks per row
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + NP * LDQ;
  bf16* Vs = Ks + NP * LDQ;
  bf16* Ds = Vs + NP * LDQ;                                    // dO
  float* Ss = reinterpret_cast<float*>(Ds + NP * LDQ);         // S, dP, out
  bf16* Ps = reinterpret_cast<bf16*>(Ss + NP * L.LDSO);        // P
  bf16* Gs = Ps + NP * L.LDP;                                  // dS

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int heads = C / DH;
  const int nh = H / ph, nw = W / pw;
  const int head = blockIdx.x % heads;
  const int rest = blockIdx.x / heads;
  const int part = rest % (nh * nw);
  const long frame = rest / (nh * nw);
  const int pi = part / nw, pj = part % nw;

  auto pixel = [&](int t) -> long {
    const int a = t / pw, b = t % pw;
    const int r = window ? pi * ph + a : a * nh + pi;
    const int c = window ? pj * pw + b : b * nw + pj;
    return (frame * H + r) * W + c;
  };

  for (int i = tid; i < NP * 4 * CH; i += THREADS) {
    const int t = i / (4 * CH), w = i % (4 * CH);
    const int which = w / CH, c8 = (w % CH) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (t < n) {
      const bf16* src = which < 3
          ? qkv + pixel(t) * 3 * C + head * 3 * DH + which * DH + c8
          : dO + pixel(t) * C + head * DH + c8;
      v = *reinterpret_cast<const uint4*>(src);
    }
    bf16* dst = (which == 0 ? Qs : which == 1 ? Ks : which == 2 ? Vs : Ds) +
                t * LDQ + c8;
    *reinterpret_cast<uint4*>(dst) = v;
  }
  __syncthreads();

  const int nt = NP / 16;
  // S = Q K^T, and later dP = dO V^T: [NP, NP] f32 into Ss
  auto qk_like = [&](const bf16* A, const bf16* B) {
    for (int tile = warp; tile < nt * nt; tile += NWARP) {
      const int ti = tile / nt, tj = tile % nt;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int k = 0; k < DH; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, A + ti * 16 * LDQ + k, LDQ);
        wmma::load_matrix_sync(b, B + tj * 16 * LDQ + k, LDQ);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(Ss + ti * 16 * L.LDS + tj * 16, acc, L.LDS,
                              wmma::mem_row_major);
    }
  };
  qk_like(Qs, Ks);
  __syncthreads();

  // P = bf16(softmax(scale * S)) per query row, one warp per row
  for (int r = warp; r < NP; r += NWARP) {
    bf16* prow = Ps + r * L.LDP;
    if (r >= n) {
      for (int c = lane; c < NP; c += 32) prow[c] = __float2bfloat16_rn(0.f);
      continue;
    }
    float* srow = Ss + r * L.LDS;
    float mx = -INFINITY;
    for (int c = lane; c < n; c += 32) mx = fmaxf(mx, srow[c] * scale);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int c = lane; c < n; c += 32) {
      const float e = expf(srow[c] * scale - mx);
      srow[c] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int c = lane; c < NP; c += 32)
      prow[c] = __float2bfloat16_rn(c < n ? srow[c] / sum : 0.f);
  }
  __syncthreads();

  qk_like(Ds, Vs);  // dP = dO V^T
  __syncthreads();

  // dS = bf16(scale * P o (dP - rowsum(dP o P)))
  for (int r = warp; r < NP; r += NWARP) {
    bf16* grow = Gs + r * L.LDP;
    if (r >= n) {
      for (int c = lane; c < NP; c += 32) grow[c] = __float2bfloat16_rn(0.f);
      continue;
    }
    const float* drow = Ss + r * L.LDS;
    const bf16* prow = Ps + r * L.LDP;
    float ss = 0.f;
    for (int c = lane; c < n; c += 32) ss += drow[c] * __bfloat162float(prow[c]);
    ss = warp_sum(ss);
    for (int c = lane; c < NP; c += 32) {
      const float p = __bfloat162float(prow[c]);
      grow[c] = __float2bfloat16_rn(c < n ? p * (drow[c] - ss) * scale : 0.f);
    }
  }
  __syncthreads();

  // out[NP, DH] = op(X)[NP, NP] . Y[NP, DH]; op = transpose when TA
  float* Os = Ss;
  auto apply = [&](const bf16* X, bool TA, const bf16* Y, int which) {
    for (int tile = warp; tile < nt * (DH / 16); tile += NWARP) {
      const int ti = tile / (DH / 16), tj = tile % (DH / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k = 0; k < NP; k += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, Y + k * LDQ + tj * 16, LDQ);
        if (TA) {  // element (m, k) of X^T is X[k][m]
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
          wmma::load_matrix_sync(a, X + k * L.LDP + ti * 16, L.LDP);
          wmma::mma_sync(acc, a, b, acc);
        } else {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, X + ti * 16 * L.LDP + k, L.LDP);
          wmma::mma_sync(acc, a, b, acc);
        }
      }
      wmma::store_matrix_sync(Os + ti * 16 * LDO + tj * 16, acc, LDO,
                              wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = tid; i < n * CH; i += THREADS) {
      const int t = i / CH, c8 = (i % CH) * 8;
      const float* o = Os + t * LDO + c8;
      __align__(16) bf16 packed[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) packed[e] = __float2bfloat16_rn(o[e]);
      *reinterpret_cast<uint4*>(dqkv + pixel(t) * 3 * C + head * 3 * DH +
                                which * DH + c8) =
          *reinterpret_cast<const uint4*>(packed);
    }
    __syncthreads();
  };
  apply(Ps, true, Ds, 2);   // dV = P^T dO
  apply(Gs, false, Ks, 0);  // dQ = dS K
  apply(Gs, true, Qs, 1);   // dK = dS^T Q
}

template <int DH>
int launch(const bf16* qkv, const bf16* dO, bf16* dqkv, int N, int H, int W,
           int C, int ph, int pw, int window, float scale, cudaStream_t st) {
  const int n = ph * pw;
  const int NP = (n + 15) / 16 * 16;
  if (NP > 128) return (int)cudaErrorInvalidValue;
  const size_t smem = Layout<DH>(NP).bytes();
  cudaError_t e = cudaFuncSetAttribute(
      attn_bwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long blocks = (long)N * (H / ph) * (W / pw) * (C / DH);
  attn_bwd_kernel<DH><<<(unsigned)blocks, THREADS, smem, st>>>(
      qkv, dO, dqkv, H, W, C, ph, pw, window, n, NP, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rvt_partition_attention_bwd(const void* qkv, const void* dO,
                                           void* dqkv, int N, int H, int W,
                                           int C, int dh, int ph, int pw,
                                           int window, float scale,
                                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bf16* q = (const bf16*)qkv;
  const bf16* d = (const bf16*)dO;
  bf16* o = (bf16*)dqkv;
  if (dh == 16) return launch<16>(q, d, o, N, H, W, C, ph, pw, window, scale, st);
  if (dh == 32) return launch<32>(q, d, o, N, H, W, C, ph, pw, window, scale, st);
  if (dh == 64) return launch<64>(q, d, o, N, H, W, C, ph, pw, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

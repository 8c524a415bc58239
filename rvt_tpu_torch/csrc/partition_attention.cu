// K3 partition_attention: MaxViT window or grid self-attention, per head.
//
// Replaces the attention core of the TPU kernel
// rvt_tpu/ops/fused_attention.py:_one_block (partition gather, per-head
// softmax(q k^T * dh^-0.5) v with an f32 softmax, head concat, partition
// reverse). Input is the qkv tensor [N, H, W, 3C] bf16 in image order with
// the per-head interleaved layout of the qkv projection: head h owns
// channels [h*3*dh, (h+1)*3*dh) as q | k | v (layers.py SelfAttentionCl).
// Output is [N, H, W, C] bf16 in image order, head h in channels
// [h*dh, (h+1)*dh).
//
// One block per (frame, partition, head). The partition gather is in the
// load addressing (no reshaped copy in memory): token t = (a, b),
// a < ph, b < pw, of partition (i, j) sits at pixel
//   window: (i*ph + a, j*pw + b)      grid: (a*nh + i, b*nw + j)
// with nh = H/ph, nw = W/pw. Rounding points follow the JAX kernel:
// scores and softmax in f32, probabilities rounded to bf16, o = p v with
// f32 accumulation, rounded to bf16.
//
// Bound on the H100: bytes at these shapes (80 tokens x dh 32: each
// block moves 80*32*4*2 bytes for 2*2*80*80*32 flops, ~50 flops/byte,
// below the ~295 of the bf16 tensor-core roofline). Design: q, k, v of
// the partition go to shared memory once; both products run as bf16
// WMMA (mma.sync) tiles on the token count padded to 16; the scores and
// probabilities never leave shared memory, and reuse the space of what
// they replace (46 KB at 80 tokens, so four 8-warp blocks share an SM).
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int THREADS = 256;

// Shared memory: q, k, v rows (bf16), then the f32 scores, which the f32
// o tile reuses. The bf16 probabilities reuse q and k once the scores
// exist, when they fit there (80 tokens at dh 32 fit exactly).
template <int DH>
struct Layout {
  static constexpr int LDQ = DH + 8;  // q, k, v rows (bf16)
  static constexpr int LDO = DH + 4;  // o rows (f32)
  int NP, LDS, LDP, LDSO;
  bool p_on_qk;
  __host__ __device__ explicit Layout(int np)
      : NP(np), LDS(np + 4), LDP(np),
        LDSO((np + 4) > (DH + 4) ? (np + 4) : (DH + 4)),
        p_on_qk(np <= 2 * LDQ) {}
  __host__ __device__ size_t bytes() const {
    return (size_t)3 * NP * LDQ * 2 + (size_t)NP * LDSO * 4 +
           (p_on_qk ? 0 : (size_t)NP * LDP * 2);
  }
};

template <int DH>
__global__ void __launch_bounds__(THREADS)
attn_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int H,
            int W, int C, int ph, int pw, int window, int n, int NP,
            float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout<DH> L(NP);
  constexpr int LDQ = Layout<DH>::LDQ, LDO = Layout<DH>::LDO;
  constexpr int CH = DH / 8;  // 16-byte chunks per q/k/v row
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + NP * LDQ;
  bf16* Vs = Ks + NP * LDQ;
  float* Ss = reinterpret_cast<float*>(Vs + NP * LDQ);  // scores, then o
  bf16* Ps = L.p_on_qk ? Qs : reinterpret_cast<bf16*>(Ss + NP * L.LDSO);

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

  for (int i = tid; i < NP * 3 * CH; i += THREADS) {
    const int t = i / (3 * CH), w = i % (3 * CH);
    const int which = w / CH, c8 = (w % CH) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (t < n)
      v = *reinterpret_cast<const uint4*>(
          qkv + pixel(t) * 3 * C + head * 3 * DH + which * DH + c8);
    bf16* dst = (which == 0 ? Qs : which == 1 ? Ks : Vs) + t * LDQ + c8;
    *reinterpret_cast<uint4*>(dst) = v;
  }
  __syncthreads();

  const int nt = NP / 16;
  for (int tile = warp; tile < nt * nt; tile += THREADS / 32) {
    const int ti = tile / nt, tj = tile % nt;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int k = 0; k < DH; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(a, Qs + ti * 16 * LDQ + k, LDQ);
      wmma::load_matrix_sync(b, Ks + tj * 16 * LDQ + k, LDQ);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(Ss + ti * 16 * L.LDS + tj * 16, acc, L.LDS,
                            wmma::mem_row_major);
  }
  __syncthreads();

  // softmax over the keys of each query row, one warp per row
  for (int r = warp; r < NP; r += THREADS / 32) {
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

  float* Os = Ss;  // the scores are consumed
  for (int tile = warp; tile < nt * (DH / 16); tile += THREADS / 32) {
    const int ti = tile / (DH / 16), tj = tile % (DH / 16);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int k = 0; k < NP; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, Ps + ti * 16 * L.LDP + k, L.LDP);
      wmma::load_matrix_sync(b, Vs + k * LDQ + tj * 16, LDQ);
      wmma::mma_sync(acc, a, b, acc);
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
    *reinterpret_cast<uint4*>(out + pixel(t) * C + head * DH + c8) =
        *reinterpret_cast<const uint4*>(packed);
  }
}

template <int DH>
int launch(const bf16* qkv, bf16* out, int N, int H, int W, int C, int ph,
           int pw, int window, float scale, cudaStream_t st) {
  const int n = ph * pw;
  const int NP = (n + 15) / 16 * 16;
  const size_t smem = Layout<DH>(NP).bytes();
  cudaError_t e = cudaFuncSetAttribute(
      attn_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long blocks = (long)N * (H / ph) * (W / pw) * (C / DH);
  attn_kernel<DH><<<(unsigned)blocks, THREADS, smem, st>>>(
      qkv, out, H, W, C, ph, pw, window, n, NP, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rvt_partition_attention(const void* qkv, void* out, int N,
                                       int H, int W, int C, int dh, int ph,
                                       int pw, int window, float scale,
                                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bf16* q = (const bf16*)qkv;
  bf16* o = (bf16*)out;
  if (dh == 16) return launch<16>(q, o, N, H, W, C, ph, pw, window, scale, st);
  if (dh == 32) return launch<32>(q, o, N, H, W, C, ph, pw, window, scale, st);
  if (dh == 64) return launch<64>(q, o, N, H, W, C, ph, pw, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

// K3 partition_attention: MaxViT window or grid self-attention over all
// heads of a partition.
//
// Replaces the attention core of the TPU kernel
// rvt_tpu/ops/fused_attention.py:_one_block (partition gather, per-head
// softmax(q k^T * dh^-0.5) v with an f32 softmax, head concat, partition
// reverse). Input is the qkv tensor [N, H, W, 3C] bf16 in image order with
// the per-head interleaved layout of the qkv projection: head h owns
// channels [h*3*dh, (h+1)*3*dh) as q | k | v (layers.py SelfAttentionCl).
// Output is [N, H, W, C] bf16 in image order, head h in channels
// [h*dh, (h+1)*dh). The partition gather is in the addressing: token
// t = (a, b), a < ph, b < pw, of partition (i, j) sits at pixel
//   window: (i*ph + a, j*pw + b)      grid: (a*nh + i, b*nw + j)
// with nh = H/ph, nw = W/pw. Rounding points follow the JAX kernel:
// scores and softmax in f32, the probabilities normalised and then
// rounded to bf16, o = p v with f32 sums, rounded to bf16.
//
// Bound on the H100: bytes (80 tokens x dh 32: ~50 flops per byte, far
// below the ~295 of the bf16 tensor-core roofline), so mma.sync is
// enough and wgmma's 64-row tiles would only pad the 60-80 tokens. One
// block per (frame, partition, group of up to four heads): each token's
// q | k | v of the group is one contiguous run of HG*3*dh bf16 (384 bytes
// at gen1 stage 1, where the group is every head), copied with cp.async.
// A warp owns 16 queries of one head: S = q k^T stays in its registers
// (the keys padded to 16, pad keys at -inf), the row max and sum use quad
// shuffles (``softmax_rows``, warp_mma.cuh, which K7 shares), the
// probabilities are divided, rounded to bf16 and repacked from the
// accumulator layout straight into the A operand of p v. dh
// 24 is padded to 32 with zeros for q k^T. o goes through shared memory
// so that each token's HG*dh outputs are written as one contiguous run.
#include "warp_mma.cuh"

namespace {

// Two units per warp, so that several blocks share an SM (their
// registers: S and o stay in them) and one block's loads overlap
// another's products: five warps at gen1 stage 1, ten at stage 4.
constexpr int MAX_WARPS = 10;

template <int DH>
struct Dims {
  static constexpr int DHP = (DH + 15) / 16 * 16;  // dh padded for q k^T
  static constexpr int LDQ = DHP + 8;               // q, k, v rows (bf16)
};

__host__ __device__ inline size_t attn_smem(int dh, int np, int hg) {
  const int dhp = (dh + 15) / 16 * 16;
  return (size_t)3 * hg * np * (dhp + 8) * 2 + (size_t)np * (hg * dh + 8) * 2;
}

template <int DH, int NT>
__global__ void __launch_bounds__(32 * MAX_WARPS,
                                  NT * Dims<DH>::DHP <= 320 ? 2 : 1)
attn_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int H,
            int W, int C, int ph, int pw, int window, int n, int NP, int HG,
            float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int DHP = Dims<DH>::DHP, LDQ = Dims<DH>::LDQ;
  constexpr int CH = DH / 8;  // 16-byte chunks per q/k/v row
  bf16* QKV = reinterpret_cast<bf16*>(smem);  // [3][HG][NP][LDQ]
  const int LDO = HG * DH + 8;
  bf16* Os = QKV + 3 * HG * NP * LDQ;  // [NP][LDO]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nwarps = blockDim.x >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const int groups = C / (DH * HG);
  const int nh = H / ph, nw = W / pw;
  const int group = blockIdx.x % groups;
  const int rest = blockIdx.x / groups;
  const int part = rest % (nh * nw);
  const long frame = rest / (nh * nw);
  const int pi = part / nw, pj = part % nw;

  auto pixel = [&](int t) -> long {
    const int a = t / pw, b = t % pw;
    const int r = window ? pi * ph + a : a * nh + pi;
    const int c = window ? pj * pw + b : b * nw + pj;
    return (frame * H + r) * W + c;
  };

  const int cpt = HG * 3 * CH;  // chunks per token
  for (int i = tid; i < NP * cpt; i += blockDim.x) {
    const int t = i / cpt, w = i % cpt;
    const int hl = w / (3 * CH), within = w % (3 * CH);
    const int which = within / CH, d8 = (within % CH) * 8;
    bf16* dst = QKV + ((which * HG + hl) * NP + t) * LDQ + d8;
    if (t < n)
      cp_async16(smem_addr(dst), qkv + pixel(t) * 3 * C +
                                     (long)group * HG * 3 * DH + w * 8);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
  if (DHP != DH)  // zero the padded columns of q, k and v
    for (int i = tid; i < 3 * HG * NP; i += blockDim.x)
      for (int d = DH; d < DHP; d += 8)
        *reinterpret_cast<uint4*>(QKV + i * LDQ + d) = make_uint4(0, 0, 0, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int MT = NP / 16, nt = NP / 8;
  const uint32_t base = smem_addr(QKV);
  for (int unit = warp; unit < HG * MT; unit += nwarps) {
    const int hl = unit / MT, mt = unit % MT;
    const uint32_t qb = base + (uint32_t)((0 * HG + hl) * NP * LDQ * 2);
    const uint32_t kb = base + (uint32_t)((1 * HG + hl) * NP * LDQ * 2);
    const uint32_t vb = base + (uint32_t)((2 * HG + hl) * NP * LDQ * 2);

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DHP / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, qb + ((mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               LDQ + kk * 16 + (lane >> 4) * 8) * 2);
#pragma unroll
      for (int j2 = 0; j2 < NT / 2; ++j2) {
        if (2 * j2 >= nt) break;
        uint32_t b[4];
        ldmatrix_x4(b, kb + ((j2 * 16 + (lane >> 4) * 8 + (lane & 7)) * LDQ +
                             kk * 16 + ((lane >> 3) & 1) * 8) * 2);
        mma_bf16(s[2 * j2], a, b);
        mma_bf16(s[2 * j2 + 1], a, b + 2);
      }
    }

    softmax_rows<NT>(s, nt, n, scale);

    float o[DHP / 8][4];
#pragma unroll
    for (int d = 0; d < DHP / 8; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      if (2 * kk >= nt) break;
      const float* s0 = s[2 * kk];
      const float* s1 = s[2 * kk + 1];
      uint32_t a[4];
      a[0] = pack_bf16x2(s0[0], s0[1]);
      a[1] = pack_bf16x2(s0[2], s0[3]);
      a[2] = pack_bf16x2(s1[0], s1[1]);
      a[3] = pack_bf16x2(s1[2], s1[3]);
#pragma unroll
      for (int dp = 0; dp < DHP / 16; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, vb + ((kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LDQ +
                     dp * 16 + (lane >> 4) * 8) * 2);
        mma_bf16(o[2 * dp], a, b);
        mma_bf16(o[2 * dp + 1], a, b + 2);
      }
    }
#pragma unroll
    for (int d = 0; d < DH / 8; ++d)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
        *reinterpret_cast<uint32_t*>(
            Os + (mt * 16 + g + 8 * h2) * LDO + hl * DH + d * 8 + 2 * qd) =
            pack_bf16x2(o[d][2 * h2], o[d][2 * h2 + 1]);
  }
  __syncthreads();

  const int opt = HG * CH;  // output chunks per token
  for (int i = tid; i < n * opt; i += blockDim.x) {
    const int t = i / opt, c8 = (i % opt) * 8;
    *reinterpret_cast<uint4*>(out + pixel(t) * C + (long)group * HG * DH +
                              c8) =
        *reinterpret_cast<const uint4*>(Os + t * LDO + c8);
  }
}

template <int DH, int NT>
int launch(const bf16* qkv, bf16* out, int N, int H, int W, int C, int ph,
           int pw, int window, int NP, int HG, float scale, cudaStream_t st) {
  const size_t smem = attn_smem(DH, NP, HG);
  cudaError_t e = cudaFuncSetAttribute(
      attn_kernel<DH, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int units = HG * (NP / 16);
  const int spread = (units + MAX_WARPS - 1) / MAX_WARPS;
  const int per_warp = spread > 2 ? spread : 2;
  const int warps = (units + per_warp - 1) / per_warp;
  const long blocks = (long)N * (H / ph) * (W / pw) * (C / (DH * HG));
  attn_kernel<DH, NT><<<(unsigned)blocks, 32 * warps, smem, st>>>(
      qkv, out, H, W, C, ph, pw, window, ph * pw, NP, HG, scale);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_np(const bf16* qkv, bf16* out, int N, int H, int W, int C, int ph,
              int pw, int window, int NP, int HG, float scale,
              cudaStream_t st) {
  if (NP <= 32)
    return launch<DH, 4>(qkv, out, N, H, W, C, ph, pw, window, NP, HG, scale,
                         st);
  if (NP <= 64)
    return launch<DH, 8>(qkv, out, N, H, W, C, ph, pw, window, NP, HG, scale,
                         st);
  if (NP <= 80)
    return launch<DH, 10>(qkv, out, N, H, W, C, ph, pw, window, NP, HG,
                          scale, st);
  return launch<DH, 16>(qkv, out, N, H, W, C, ph, pw, window, NP, HG, scale,
                        st);
}

// Heads per block: two (every head at gen1 stage 1), or a quarter of
// them where there are more than eight; one where two do not divide.
int heads_per_block(int heads) {
  if (heads % 2 != 0) return 1;
  return heads > 8 && heads % 4 == 0 ? heads / 4 : 2;
}

}  // namespace

extern "C" int rvt_partition_attention(const void* qkv, void* out, int N,
                                       int H, int W, int C, int dh, int ph,
                                       int pw, int window, float scale,
                                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bf16* q = (const bf16*)qkv;
  bf16* o = (bf16*)out;
  const int n = ph * pw, NP = (n + 15) / 16 * 16;
  if (n < 1 || NP > 128 || C % dh != 0 || H % ph != 0 || W % pw != 0)
    return (int)cudaErrorInvalidValue;
  const int HG = heads_per_block(C / dh);
  if (dh == 16)
    return launch_np<16>(q, o, N, H, W, C, ph, pw, window, NP, HG, scale, st);
  if (dh == 24)
    return launch_np<24>(q, o, N, H, W, C, ph, pw, window, NP, HG, scale, st);
  if (dh == 32)
    return launch_np<32>(q, o, N, H, W, C, ph, pw, window, NP, HG, scale, st);
  if (dh == 64)
    return launch_np<64>(q, o, N, H, W, C, ph, pw, window, NP, HG, scale, st);
  return (int)cudaErrorInvalidValue;
}

// K7 partition_attention_bwd: backward of MaxViT window or grid attention
// over the heads of a partition.
//
// Replaces the attention backward of the TPU kernels
// rvt_tpu/ops/fused_train.py:_block_bwd (_attn_heads_bwd :234, partition
// mode; inside the backward kernels :625 and :666). Inputs are the
// image-order qkv [N, H, W, 3C] bf16 (per-head interleaved q | k | v, as
// K3 reads it) and the cotangent of the head concat, dO [N, H, W, C] bf16
// (the JAX backward rounds dattn to bf16 before use, :246/:260). Output
// dqkv [N, H, W, 3C] bf16 in qkv's layout. Per (frame, partition, head),
// with the JAX rounding points:
//   P  = bf16(softmax(scale * Q K^T))        recomputed, f32 softmax
//   dV = P^T dO       dP = dO V^T (f32)
//   dS = bf16(scale * P o (dP - rowsum(dP o P)))   (the rowsum over the
//                                                   bf16 P, as JAX)
//   dQ = dS K         dK = dS^T Q              (f32 sums, bf16 out)
// K3's window/grid addressing: token t = (a, b) of partition (i, j) sits
// at pixel
//   window: (i*ph + a, j*pw + b)      grid: (a*nh + i, b*nw + j).
//
// Bound on the H100: bytes (80 tokens x dh 32: ~50 flops a byte, far
// below the ~295 of the bf16 tensor-core roofline), so mma.sync is
// enough, and wgmma's 64-row tiles would pad the 60-80 tokens. The design
// is K3's (partition_attention.cu): one block per (frame, partition,
// group of up to four heads, as many as keep two blocks on an SM); each
// token's q | k | v run of the group and its dO run are copied with
// cp.async. A warp owns 16 queries of one head and keeps S, dP and dS in
// registers: the softmax is K3's own code (``softmax_rows``,
// warp_mma.cuh), so P is the forward's bit for bit; dQ = dS K takes dS
// from the accumulator repack, as K3's p v takes P. Only the bf16 P and
// dS go to shared memory (P is read back from there for dS, which keeps
// one score tile fewer in registers), for dV = P^T dO and dK = dS^T Q
// over 16-key tiles with ldmatrix.trans. Each warp has one tile in each
// phase, so dq and dk wait in registers until the tiles of k and q are
// read no more and are written there, dv into v's: each token's
// dq | dk | dv run of the group is then written as contiguous 16-byte
// stores with no staging buffer (a block takes 54 KB of shared memory at
// gen1 stage 1 instead of 70). dh 24: q, k, v and dO are padded to 32 with zeros for the
// products that contract over dh (Q K^T, dO V^T); keys are padded to 16
// and masked to -inf, and pad queries get P = 0.
#include "warp_mma.cuh"

namespace {

constexpr int MAX_WARPS = 8;  // 16-query tiles: 128 tokens
constexpr int SMEM_TARGET = 110 * 1024;  // two blocks an SM

__host__ __device__ inline int bwd_dhp(int dh) { return (dh + 15) / 16 * 16; }

struct Layout {
  int LDQ, LDP;
  size_t p_off, g_off, bytes;
  __host__ __device__ Layout(int dh, int np, int hg) {
    LDQ = bwd_dhp(dh) + 8;  // q, k, v, dO rows (bf16)
    LDP = np + 8;           // P, dS rows (bf16)
    p_off = (size_t)4 * hg * np * LDQ * 2;
    g_off = p_off + (size_t)hg * np * LDP * 2;
    bytes = g_off + (size_t)hg * np * LDP * 2;
  }
};

template <int DH, int NT>
__global__ void __launch_bounds__(32 * MAX_WARPS)
attn_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dO,
                bf16* __restrict__ dqkv, int H, int W, int C, int ph, int pw,
                int window, int n, int NP, int HG, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int DHP = (DH + 15) / 16 * 16;
  constexpr int CH = DH / 8;  // 16-byte chunks per q/k/v/dO row
  const Layout L(DH, NP, HG);
  const int LDQ = L.LDQ, LDP = L.LDP;
  bf16* QKV = reinterpret_cast<bf16*>(smem);  // [4][HG][NP][LDQ]: q k v dO
  bf16* Ps = reinterpret_cast<bf16*>(smem + L.p_off);  // [HG][NP][LDP]
  bf16* Gs = reinterpret_cast<bf16*>(smem + L.g_off);  // dS, the same

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

  // a token's q | k | v run of the group (HG*3*CH chunks), then its dO
  // run (HG*CH chunks)
  const int cq = HG * 3 * CH, cpt = cq + HG * CH;
  for (int i = tid; i < NP * cpt; i += blockDim.x) {
    const int t = i / cpt, w = i % cpt;
    int which, hl, d8;
    const bf16* src;
    if (w < cq) {
      hl = w / (3 * CH);
      const int within = w % (3 * CH);
      which = within / CH;
      d8 = (within % CH) * 8;
      src = qkv + pixel(t) * 3 * C + (long)group * HG * 3 * DH + w * 8;
    } else {
      hl = (w - cq) / CH;
      which = 3;
      d8 = ((w - cq) % CH) * 8;
      src = dO + pixel(t) * C + (long)group * HG * DH + (w - cq) * 8;
    }
    bf16* dst = QKV + ((which * HG + hl) * NP + t) * LDQ + d8;
    if (t < n)
      cp_async16(smem_addr(dst), src);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
  if (DHP != DH)  // zero the padded columns of q, k, v and dO
    for (int i = tid; i < 4 * HG * NP; i += blockDim.x)
      for (int d = DH; d < DHP; d += 8)
        *reinterpret_cast<uint4*>(QKV + i * LDQ + d) = make_uint4(0, 0, 0, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int MT = NP / 16, nt = NP / 8;
  const uint32_t base = smem_addr(QKV);
  auto head = [&](int which, int hl) -> uint32_t {
    return base + (uint32_t)((which * HG + hl) * NP * LDQ * 2);
  };
  // out[16 queries, NT keys] = A[16, DHP] . B[keys, DHP]^T (Q K^T, dO V^T)
  auto scores = [&](float (&s)[NT][4], uint32_t ab, uint32_t bb, int mt) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DHP / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, ab + ((mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               LDQ + kk * 16 + (lane >> 4) * 8) * 2);
#pragma unroll
      for (int j2 = 0; j2 < NT / 2; ++j2) {
        if (2 * j2 >= nt) break;
        uint32_t b[4];
        ldmatrix_x4(b, bb + ((j2 * 16 + (lane >> 4) * 8 + (lane & 7)) * LDQ +
                             kk * 16 + ((lane >> 3) & 1) * 8) * 2);
        mma_bf16(s[2 * j2], a, b);
        mma_bf16(s[2 * j2 + 1], a, b + 2);
      }
    }
  };

  // One unit a warp in each phase (warps = HG*MT). Phase 1, 16 queries
  // of a head: P (to shared memory), dP, dS in registers; dQ = dS K.
  const int hl = warp / MT, mt = warp % MT;
  const int row = mt * 16 + g;  // and row + 8
  bf16* prow = Ps + (hl * NP + row) * LDP;
  bf16* grow = Gs + (hl * NP + row) * LDP;
  {
    float s[NT][4];
    scores(s, head(0, hl), head(1, hl), mt);
    softmax_rows<NT>(s, nt, n, scale);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= nt) break;
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const bool ok = row + 8 * h2 < n;  // pad queries: P = 0
        *reinterpret_cast<uint32_t*>(prow + h2 * 8 * LDP + j * 8 + 2 * qd) =
            pack_bf16x2(ok ? s[j][2 * h2] : 0.f, ok ? s[j][2 * h2 + 1] : 0.f);
      }
    }
  }
  // dP, then the bf16 P read back (this thread's own stores)
  float dp[NT][4];
  scores(dp, head(3, hl), head(2, hl), mt);
  auto p_at = [&](int j, int h2) {
    return bf16x2_to_float2(*reinterpret_cast<const uint32_t*>(
        prow + h2 * 8 * LDP + j * 8 + 2 * qd));
  };
  float ss[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j >= nt) break;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const float2 pv = p_at(j, h2);
      ss[h2] += dp[j][2 * h2] * pv.x;
      ss[h2] += dp[j][2 * h2 + 1] * pv.y;
    }
  }
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    ss[h2] += __shfl_xor_sync(0xffffffffu, ss[h2], 1);
    ss[h2] += __shfl_xor_sync(0xffffffffu, ss[h2], 2);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j >= nt) break;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const float2 pv = p_at(j, h2);
      dp[j][2 * h2] = round_bf16(pv.x * (dp[j][2 * h2] - ss[h2]) * scale);
      dp[j][2 * h2 + 1] =
          round_bf16(pv.y * (dp[j][2 * h2 + 1] - ss[h2]) * scale);
      *reinterpret_cast<uint32_t*>(grow + h2 * 8 * LDP + j * 8 + 2 * qd) =
          pack_bf16x2(dp[j][2 * h2], dp[j][2 * h2 + 1]);
    }
  }
  float dq[DHP / 8][4];
#pragma unroll
  for (int d = 0; d < DHP / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[d][e] = 0.f;
  const uint32_t kb = head(1, hl);
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    if (2 * kk >= nt) break;
    const float* s0 = dp[2 * kk];
    const float* s1 = dp[2 * kk + 1];
    uint32_t a[4];
    a[0] = pack_bf16x2(s0[0], s0[1]);
    a[1] = pack_bf16x2(s0[2], s0[3]);
    a[2] = pack_bf16x2(s1[0], s1[1]);
    a[3] = pack_bf16x2(s1[2], s1[3]);
#pragma unroll
    for (int d2 = 0; d2 < DHP / 16; ++d2) {
      uint32_t b[4];
      ldmatrix_x4_trans(
          b, kb + ((kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LDQ +
                   d2 * 16 + (lane >> 4) * 8) * 2);
      mma_bf16(dq[2 * d2], a, b);
      mma_bf16(dq[2 * d2 + 1], a, b + 2);
    }
  }
  // out[16 rows, DH] of a warp's accumulator into tile ``which`` of the
  // head (bf16)
  auto put = [&](int which, const float (&acc)[DHP / 8][4]) {
    bf16* o = QKV + ((which * HG + hl) * NP + row) * LDQ + 2 * qd;
#pragma unroll
    for (int d = 0; d < DH / 8; ++d)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
        *reinterpret_cast<uint32_t*>(o + h2 * 8 * LDQ + d * 8) =
            pack_bf16x2(acc[d][2 * h2], acc[d][2 * h2 + 1]);
  };
  __syncthreads();  // k and v are read no more: dq goes to k's tile
  put(1, dq);

  // Phase 2, 16 keys of a head (key tile mt): dV = P^T dO into v's tile,
  // dK = dS^T Q kept in registers until q is read no more
  auto keys = [&](const bf16* X, uint32_t yb, float (&acc)[DHP / 8][4]) {
    const uint32_t xb = smem_addr(X + (size_t)hl * NP * LDP);
#pragma unroll
    for (int d = 0; d < DHP / 8; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
    for (int qk = 0; qk < MT; ++qk) {
      uint32_t a[4];  // A[key][query] = X[query][key]
      ldmatrix_x4_trans(a, xb + ((qk * 16 + (lane >> 4) * 8 + (lane & 7)) *
                                     LDP + mt * 16 + ((lane >> 3) & 1) * 8) *
                                        2);
#pragma unroll
      for (int d2 = 0; d2 < DHP / 16; ++d2) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, yb + ((qk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LDQ +
                     d2 * 16 + (lane >> 4) * 8) * 2);
        mma_bf16(acc[2 * d2], a, b);
        mma_bf16(acc[2 * d2 + 1], a, b + 2);
      }
    }
  };
  float acc[DHP / 8][4];
  keys(Ps, head(3, hl), acc);
  put(2, acc);
  keys(Gs, head(0, hl), acc);
  __syncthreads();  // q is read no more: dk goes to q's tile
  put(0, acc);
  __syncthreads();

  // each token's dq | dk | dv run of the group: tiles k, q, v
  const int opt = HG * 3 * CH;  // output chunks per token
  for (int i = tid; i < n * opt; i += blockDim.x) {
    const int t = i / opt, c = i % opt;
    const int h = c / (3 * CH), which = (c % (3 * CH)) / CH;
    const int tile = which == 0 ? 1 : which == 1 ? 0 : 2;
    *reinterpret_cast<uint4*>(dqkv + pixel(t) * 3 * C +
                              (long)group * HG * 3 * DH + c * 8) =
        *reinterpret_cast<const uint4*>(
            QKV + ((tile * HG + h) * NP + t) * LDQ + (c % CH) * 8);
  }
}

template <int DH, int NT>
int launch(const bf16* qkv, const bf16* dO, bf16* dqkv, int N, int H, int W,
           int C, int ph, int pw, int window, int NP, int HG, float scale,
           cudaStream_t st) {
  const size_t smem = Layout(DH, NP, HG).bytes;
  cudaError_t e = cudaFuncSetAttribute(
      attn_bwd_kernel<DH, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int warps = HG * (NP / 16);  // one unit a warp in each phase
  const long blocks = (long)N * (H / ph) * (W / pw) * (C / (DH * HG));
  attn_bwd_kernel<DH, NT><<<(unsigned)blocks, 32 * warps, smem, st>>>(
      qkv, dO, dqkv, H, W, C, ph, pw, window, ph * pw, NP, HG, scale);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_np(const bf16* qkv, const bf16* dO, bf16* dqkv, int N, int H,
              int W, int C, int ph, int pw, int window, int NP, int HG,
              float scale, cudaStream_t st) {
#define RVT_ATTN_BWD(NT)                                                     \
  return launch<DH, NT>(qkv, dO, dqkv, N, H, W, C, ph, pw, window, NP, HG, \
                        scale, st)
  if (NP <= 32) RVT_ATTN_BWD(4);
  if (NP <= 64) RVT_ATTN_BWD(8);
  if (NP <= 80) RVT_ATTN_BWD(10);
  RVT_ATTN_BWD(16);
#undef RVT_ATTN_BWD
}

// Heads per block: the most of 4, 2, 1 that divide the heads, give one
// 16-query tile to each of at most MAX_WARPS warps and keep the block's
// shared memory within two blocks an SM (one head at gen1's 80 tokens).
int heads_per_block(int heads, int dh, int np) {
  for (int hg = 4; hg > 1; hg /= 2)
    if (heads % hg == 0 && hg * (np / 16) <= MAX_WARPS &&
        Layout(dh, np, hg).bytes <= SMEM_TARGET)
      return hg;
  return 1;
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
  const int n = ph * pw, NP = (n + 15) / 16 * 16;
  if (n < 1 || NP > 128 || C % dh != 0 || H % ph != 0 || W % pw != 0)
    return (int)cudaErrorInvalidValue;
  const int HG = heads_per_block(C / dh, dh, NP);
#define RVT_ATTN_BWD_DH(DH)                                                  \
  return launch_np<DH>(q, d, o, N, H, W, C, ph, pw, window, NP, HG, scale, \
                       st)
  if (dh == 16) RVT_ATTN_BWD_DH(16);
  if (dh == 24) RVT_ATTN_BWD_DH(24);
  if (dh == 32) RVT_ATTN_BWD_DH(32);
  if (dh == 64) RVT_ATTN_BWD_DH(64);
#undef RVT_ATTN_BWD_DH
  return (int)cudaErrorInvalidValue;
}

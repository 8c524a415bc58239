// K2 gemm_bf16: out = epilogue(A[M,K] bf16 x W bf16), f32 accumulation.
//
// Replaces the token-pointwise products inside the TPU kernels
// rvt_tpu/ops/fused_attention.py:_one_block (qkv, proj, fc1, fc2; run
// per partition there, in image order here, which is the same product
// because they act on each token alone) and, for training, the products
// of rvt_tpu/ops/fused_train.py:_block_fwd / _block_bwd (_dot and
// _dot_rt). The bias variants first round the f32 sum to bf16, then add
// the bf16 bias and round again (the JAX ``dot(...).astype(bf16) + b``):
//   EPI_BIAS    (0): store the bf16 result                     (qkv, m)
//   EPI_GELU    (1): tanh-gelu in f32, store rounded to bf16   (fc1);
//                    with ``aux`` also the bf16 pre-activation h1
//   EPI_RESID   (2): R[M,N] f32 += the result    (serving proj, fc2; the
//                    LayerScale is folded into their weights); with
//                    ``aux`` also bf16(R), the input of K4's hoisted
//                    product (lstm_scan.cu)
//   EPI_RESID_LS(3): out = res_in + f32(result) * gamma[col]   (training
//                    proj, fc2: LayerScale unfolded, _block_fwd :311-316,
//                    :329-332); with ``aux`` also the bf16 result
// and, with W given as [N, K] (out = A . W^T, the data gradients):
//   EPI_RT_F32  (4): store the f32 sum
//   EPI_RT_BF16 (5): store the sum rounded to bf16 (dattn, which the
//                    attention backward reads as bf16 only)
//   EPI_RT_ACC  (6): out[M,N] f32 += the sum
//   EPI_RT_GELU_BWD (7): d = sum * gelu'(aux = bf16 h1) (_gelu_bwd :145),
//                    store bf16(d) and the f32 column sums of d over each
//                    64-row block into part[row / 64, N] (the fc1 bias
//                    gradient, summed over blocks by train_reduce.cu; a
//                    fixed order within the block, so two runs agree)
//
// Bound on the H100: at the gen1 RVT-B shapes the products are short
// (K = C or 4C, 64..2048) and M is large (up to 860,160 rows), so stage 1
// is bound by the bytes of A and of the epilogue's outputs, stages 3-4 by
// the tensor cores (28 GFLOP per 4C-wide product at every stage).
//
// Design (hopper_gemm.cuh): wgmma on 128-byte-swizzled k-tiles of 64
// that TMA loads through an mbarrier ring, in a persistent grid whose
// producer loads ahead while the consumers run an epilogue. A is read
// K-major; W [K, N] is an MN-major B operand and W [N, K] (the rt_
// epilogues) a K-major one, both straight from memory (wgmma's transpose
// immediate). K is not split: the in-place epilogues need one block per
// output tile. BN = 128 where N is a multiple of 128, else 64. Two
// schedules, picked in ``schedule`` from (M, N, K) and the epilogue:
//   * ping-pong: 64 x BN tiles, two consumer warpgroups owning whole
//     tiles in turn, so one's epilogue runs under the other's loads and
//     products; where every block gets two tiles or more and the
//     epilogue's memory traffic sets the pace (the f32 epilogues up to
//     K = 1024, bias and rt_bf16 up to K = 128);
//   * cooperative: 128 x BN tiles (two consumer warpgroups), 64 x BN (one)
//     when 128-row tiles would leave SMs idle (the per-step path's B = 8
//     frames), 192 x BN (three) for the products whose output outweighs
//     their input (N >= 2K); the gelu epilogues, bound by their
//     instructions (two MUFU and some 28 instructions a value), and the
//     longer products, which gain from two or three warpgroups issuing
//     products at once.
// The epilogue stages each warpgroup's 64 x 64 slices in shared memory,
// as bf16 for the epilogues that start by rounding the sum to bf16 (the
// bias variants and rt_bf16: half the traffic, the bias added in bf16x2
// with the same rounding), else as f32, and writes eight neighbouring
// columns per thread with 16-byte accesses.
#include "hopper_gemm.cuh"

namespace {

constexpr int EPI_BIAS = 0, EPI_GELU = 1, EPI_RESID = 2, EPI_RESID_LS = 3,
              EPI_RT_F32 = 4, EPI_RT_BF16 = 5, EPI_RT_ACC = 6,
              EPI_RT_GELU_BWD = 7;
constexpr int PART_ROWS = 64;  // rows per column-sum partial of epilogue 7
constexpr float GELU_C0 = 0.7978845608028654f, GELU_C1 = 0.044715f;

__device__ __forceinline__ float gelu_tanh(float x) {
  const float inner = GELU_C0 * (x + GELU_C1 * x * x * x);
  return 0.5f * x * (1.f + tanhf(inner));
}

// d gelu / d h at the bf16 pre-activation h, as _gelu_bwd writes it.
__device__ __forceinline__ float gelu_grad(float h) {
  const float t = tanhf(GELU_C0 * (h + GELU_C1 * h * h * h));
  const float dinner =
      0.5f * h * (1.f - t * t) * GELU_C0 * (1.f + 0.134145f * h * h);
  return 0.5f * (1.f + t) + dinner;
}

__device__ __forceinline__ void store_bf16x8(bf16* dst, const float* v) {
  __align__(16) bf16 packed[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) packed[e] = __float2bfloat16_rn(v[e]);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(packed);
}

__device__ __forceinline__ void unpack_bf16x8(const uint4& raw, float* v) {
  const bf16* b = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(b[e]);
}

// One 16-byte load into registers, then the eight values.
__device__ __forceinline__ void load_bf16x8(const bf16* src, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  unpack_bf16x8(raw, v);
}

__device__ __forceinline__ void load_f32x8(const float* src, float* v) {
  *reinterpret_cast<float4*>(v) = *reinterpret_cast<const float4*>(src);
  *reinterpret_cast<float4*>(v + 4) =
      *reinterpret_cast<const float4*>(src + 4);
}

// a + b for eight pairs of bf16, each sum rounded once to bf16: the bits
// of round_bf16(float(a) + float(b)). The f32 sum of two bf16 is exact
// unless their exponents lie 16 or more apart; then the smaller moves the
// larger by under 2^-15 of it, far from a bf16 tie, and both roundings
// give the larger.
__device__ __forceinline__ uint4 add_bf16x8(uint4 a, const uint4& b) {
  __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = __hadd2(x[i], y[i]);
  return a;
}

struct EpiArgs {
  const bf16* bias;
  const float* gamma;
  const float* res_in;
  bf16* aux;
  void* out;
  float* part;
};

// EPI >= EPI_RT_F32 (TRANS): W is [N, K] and the product is A . W^T (the
// _dot_rt of the backward); otherwise W is [K, N]. Tiles of SL 64-row
// slices by BN columns.
template <int SL, int BN, int EPI>
struct Gemm {
  static constexpr bool TRANS = EPI >= EPI_RT_F32;
  static constexpr int BM = 64 * SL, WN = hg::Plan<SL, BN>::WN;
  static constexpr int TA = 0, TB = TRANS ? 0 : 1;
  // the epilogue starts by rounding the sum to bf16: staged as bf16
  static constexpr bool STAGE_BF16 =
      EPI <= EPI_RESID_LS || EPI == EPI_RT_BF16;
  static constexpr int ITEMS = 64 * 8 / 128;  // rows a thread, a piece
  struct Tile {
    int m0, n0, ktiles;
  };
  const CUtensorMap* ta;
  const CUtensorMap* tb;
  EpiArgs e;
  int M, N, K;

  __device__ int n_tiles() const { return (N + BN - 1) / BN; }
  __device__ int tiles() const { return (M + BM - 1) / BM * n_tiles(); }
  __device__ Tile tile(int t) const {
    // n fastest: the blocks running at once share their rows of A in L2
    return {t / n_tiles() * BM, t % n_tiles() * BN, (K + hg::BK - 1) / hg::BK};
  }
  __device__ void load(const Tile& t, int kt, uint32_t a, uint32_t b,
                       uint32_t bar) const {
    const int k0 = kt * hg::BK;
    hg::tma_load(a, ta, bar, k0, t.m0);  // box: BM rows x 64 k
    if (TRANS) {
      hg::tma_load(b, tb, bar, k0, t.n0);  // box: BN rows (n) x 64 k
    } else {
#pragma unroll
      for (int j = 0; j < BN / 64; ++j)  // boxes: 64 k rows x 64 n
        hg::tma_load(b + j * 64 * hg::BK * 2, tb, bar, t.n0 + 64 * j, k0);
    }
  }
  __device__ uint64_t desc_a(uint32_t a, int s, int k16) const {
    return hg::desc_sw128(a + s * 64 * 128 + 32 * k16, 16, 1024);
  }
  __device__ uint64_t desc_b(uint32_t b, int i, int k16) const {
    if (TRANS) return hg::desc_sw128(b + i * WN * 128 + 32 * k16, 16, 1024);
    return hg::desc_sw128(b + i * WN * 128 + 2048 * k16, 64 * 128, 1024);
  }

  // One 64 x 64 piece of the tile: rows m0 + 64 s.., columns n0 + 64 c..,
  // run by one consumer warpgroup from its staging tile Cs (named barrier
  // 1 + its index guards it). Each thread owns eight neighbouring columns
  // of four rows (tid / 8 + 16 k): the bias and gamma are read once, and
  // the four rows' other inputs are all requested before any is used.
  __device__ void epilogue(const Tile& t, int s, int c, float* Cs) const {
    if constexpr (STAGE_BF16)
      epilogue_bf16(t.m0 + 64 * s, t.n0 + 64 * c,
                    reinterpret_cast<const bf16*>(Cs));
    else
      epilogue_f32(t.m0 + 64 * s, t.n0 + 64 * c, Cs);
  }

  // The bias variants and rt_bf16, from the sums rounded to bf16: v = the
  // sum + the bias in bf16x2 (the rounding points of
  // ``dot(...).astype(bf16) + b``).
  __device__ void epilogue_bf16(int row0, int col0, const bf16* Cb) const {
    constexpr int epi = EPI;
    const int tid = threadIdx.x % 128, c8 = (tid % 8) * 8, gn = col0 + c8;
    if (gn >= N) return;  // N % 8 == 0: all eight in range
    uint4 bias8, v8[ITEMS];
    __align__(16) float x[ITEMS][8];  // out (2), res_in (3)
    __align__(16) float g8[8];
    if (epi != EPI_RT_BF16)
      bias8 = *reinterpret_cast<const uint4*>(e.bias + gn);
    if (epi == EPI_RESID_LS) load_f32x8(e.gamma + gn, g8);
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int r = tid / 8 + 16 * k;
      const long gm = (long)row0 + r, o = gm * N + gn;
      v8[k] = *reinterpret_cast<const uint4*>(Cb + r * hg::EPI_LDB + c8);
      if (gm >= M) continue;
      if (epi == EPI_RESID)
        load_f32x8(reinterpret_cast<const float*>(e.out) + o, x[k]);
      else if (epi == EPI_RESID_LS)
        load_f32x8(e.res_in + o, x[k]);
    }
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int r = tid / 8 + 16 * k;
      const long gm = (long)row0 + r, o = gm * N + gn;
      if (gm >= M) continue;
      const uint4 v = epi == EPI_RT_BF16 ? v8[k] : add_bf16x8(v8[k], bias8);
      if (epi == EPI_BIAS || epi == EPI_RT_BF16) {
        *reinterpret_cast<uint4*>(reinterpret_cast<bf16*>(e.out) + o) = v;
        continue;
      }
      if ((epi == EPI_GELU || epi == EPI_RESID_LS) && e.aux != nullptr)
        *reinterpret_cast<uint4*>(e.aux + o) = v;
      __align__(16) float w[8];
      unpack_bf16x8(v, w);
      if (epi == EPI_GELU) {
#pragma unroll
        for (int q = 0; q < 8; ++q) w[q] = gelu_tanh(w[q]);
        store_bf16x8(reinterpret_cast<bf16*>(e.out) + o, w);
        continue;
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {  // += (2), res_in + v * gamma (3)
        if (epi == EPI_RESID_LS)
          w[q] = x[k][q] + w[q] * g8[q];
        else
          w[q] = x[k][q] + w[q];
      }
      float4* R =
          reinterpret_cast<float4*>(reinterpret_cast<float*>(e.out) + o);
      R[0] = *reinterpret_cast<const float4*>(w);
      R[1] = *reinterpret_cast<const float4*>(w + 4);
      if (epi == EPI_RESID && e.aux != nullptr) store_bf16x8(e.aux + o, w);
    }
  }

  // rt_f32, rt_acc and rt_gelu_bwd, from the f32 sums.
  __device__ void epilogue_f32(int row0, int col0, float* Cs) const {
    constexpr int epi = EPI;
    const int tid = threadIdx.x % 128, bar = 1 + threadIdx.x / 128;
    const int c8 = (tid % 8) * 8, gn = col0 + c8;
    const bool col_ok = gn < N;  // N % 8 == 0: all eight in range
    __align__(16) float v[ITEMS][8];
    __align__(16) float x[ITEMS][8];  // aux (7), out (6)
    float colsum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int r = tid / 8 + 16 * k;
      const long gm = (long)row0 + r, o = gm * N + gn;
      load_f32x8(Cs + r * hg::EPI_LD + c8, v[k]);
      if (!col_ok || gm >= M) continue;
      if (epi == EPI_RT_GELU_BWD)
        load_bf16x8(e.aux + o, x[k]);
      else if (epi == EPI_RT_ACC)
        load_f32x8(reinterpret_cast<const float*>(e.out) + o, x[k]);
    }
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int r = tid / 8 + 16 * k;
      const long gm = (long)row0 + r, o = gm * N + gn;
      if (!col_ok || gm >= M) continue;
      float* w = v[k];
      if (epi == EPI_RT_GELU_BWD) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          w[q] *= gelu_grad(x[k][q]);
          colsum[q] += w[q];  // the f32 d, rows in k order
        }
        store_bf16x8(reinterpret_cast<bf16*>(e.out) + o, w);
        continue;
      }
      if (epi == EPI_RT_ACC) {
#pragma unroll
        for (int q = 0; q < 8; ++q) w[q] = x[k][q] + w[q];
      }
      float4* R =
          reinterpret_cast<float4*>(reinterpret_cast<float*>(e.out) + o);
      R[0] = *reinterpret_cast<const float4*>(w);
      R[1] = *reinterpret_cast<const float4*>(w + 4);
    }
    if (epi == EPI_RT_GELU_BWD) {
      // column sums of the block's valid rows: each thread's four rows,
      // then the 16 row groups in order over the staging tile (every read
      // of it is done): a fixed order, so two runs agree
      hg::named_sync(bar, 128);
#pragma unroll
      for (int q = 0; q < 8; ++q)
        Cs[(tid / 8) * hg::EPI_LD + c8 + q] = colsum[q];
      hg::named_sync(bar, 128);
      if (tid < 64 && col0 + tid < N && row0 < M) {
        float s = 0.f;
#pragma unroll
        for (int g = 0; g < 16; ++g) s += Cs[g * hg::EPI_LD + tid];
        e.part[(long)(row0 / PART_ROWS) * N + col0 + tid] = s;
      }
    }
  }
};

// PP: the ping-pong schedule (whole 64-row tiles for each of two consumer
// warpgroups in turn), else the cooperative one (SL 64-row slices, one a
// consumer warpgroup).
constexpr int PP_NC = hg::PP_CONSUMERS;

template <bool PP, int SL, int BN, int EPI>
__global__ void __launch_bounds__(128 * ((PP ? PP_NC : SL) + 1), 1)
gemm_kernel(const __grid_constant__ CUtensorMap ta,
            const __grid_constant__ CUtensorMap tb, EpiArgs e, int M, int N,
            int K) {
  const Gemm<SL, BN, EPI> p{&ta, &tb, e, M, N, K};
  if constexpr (PP)
    hg::run_pingpong<BN>(p);
  else
    hg::run<SL, BN>(p);
}

template <bool PP, int SL, int BN, int EPI>
int launch(const void* a, const void* w, const EpiArgs& e, int M, int N,
           int K, cudaStream_t st) {
  constexpr bool TRANS = EPI >= EPI_RT_F32;
  using PL = hg::Plan<SL, BN, PP ? PP_NC : SL>;
  static unsigned long long ready = 0;
  CUtensorMap ta, tb;
  if (!hg::make_map(&ta, a, M, K, PL::BM, hg::BK) ||
      !(TRANS ? hg::make_map(&tb, w, N, K, BN, hg::BK)
              : hg::make_map(&tb, w, K, N, hg::BK, 64)))
    return (int)cudaErrorInvalidValue;
  const long tiles = (long)((M + PL::BM - 1) / PL::BM) * ((N + BN - 1) / BN);
  return hg::launch_persistent(gemm_kernel<PP, SL, BN, EPI>, ready, PL::SMEM,
                               PL::THREADS, tiles, st, ta, tb, e, M, N, K);
}

// The schedule and tile of epilogue ``epi`` at (M, N, K): {1 ping-pong /
// 0 cooperative, tile rows, tile columns, consumer warpgroups}.
//   * Columns: BN = 128 where N is a multiple of 128, else 64 (no column
//     wasted at N = 192, the stage-1 qkv).
//   * Ping-pong (64-row tiles, two consumer warpgroups) where its tiles
//     give every block two or more and the tile's time is its epilogue's
//     memory traffic: the f32 epilogues (residual, residual_ls, rt_f32,
//     rt_acc) up to K = 1024, the bias and rt_bf16 ones up to K = 128.
//   * Else cooperative: the gelu epilogues, bound by their instructions
//     (tanhf), and the longer products run faster with two or three
//     warpgroups issuing products at once. 64 rows (one consumer
//     warpgroup) where 128-row tiles would leave SMs idle (the per-step
//     path's B = 8 frames), 192 (three) where the output outweighs the
//     input (N >= 2K: qkv, fc1, the gelu backward), whose epilogue then
//     has more warps, else 128. (On the H100, 128 x 256 tiles and two
//     blocks per SM lost at every gen1 RVT-B shape.)
struct Schedule {
  int pp, rows, bn, nc;
};

Schedule schedule(int M, int N, int K, int epi) {
  const long sms = hg::sm_count();
  const int bn = N > 64 && N % 128 == 0 ? 128 : 64;
  const long n_tiles = (N + bn - 1) / bn;
  const bool f32_out = epi == EPI_RESID || epi == EPI_RESID_LS ||
                       epi == EPI_RT_F32 || epi == EPI_RT_ACC;
  const bool light = epi == EPI_BIAS || epi == EPI_RT_BF16;
  if ((long)((M + 63) / 64) * n_tiles >= 2 * sms &&
      ((f32_out && K <= 1024) || (light && K <= 128)))
    return {1, 64, bn, PP_NC};
  if ((long)((M + 127) / 128) * n_tiles < sms) return {0, 64, bn, 1};
  if (N >= 2 * K) return {0, 192, bn, 3};
  return {0, 128, bn, 2};
}

template <int EPI>
int dispatch(const void* a, const void* w, const EpiArgs& e, int M, int N,
             int K, cudaStream_t st) {
  const Schedule s = schedule(M, N, K, EPI);
  const bool wide = s.bn == 128;
  if (s.pp)
    return wide ? launch<true, 1, 128, EPI>(a, w, e, M, N, K, st)
                : launch<true, 1, 64, EPI>(a, w, e, M, N, K, st);
  switch (s.nc) {
    case 1:
      return wide ? launch<false, 1, 128, EPI>(a, w, e, M, N, K, st)
                  : launch<false, 1, 64, EPI>(a, w, e, M, N, K, st);
    case 3:
      return wide ? launch<false, 3, 128, EPI>(a, w, e, M, N, K, st)
                  : launch<false, 3, 64, EPI>(a, w, e, M, N, K, st);
    default:
      return wide ? launch<false, 2, 128, EPI>(a, w, e, M, N, K, st)
                  : launch<false, 2, 64, EPI>(a, w, e, M, N, K, st);
  }
}

}  // namespace

// Every epilogue through one entry: 0-3 take W [K, N] and a bias (2 adds
// into ``out`` in place); 4-7 take W [N, K] and no bias. ``aux`` is an
// optional bf16 [M, N] output (1, 2, 3) or the bf16 h1 input (7); ``part``
// [part_rows, N] f32 receives the column sums of epilogue 7, one row per
// 64 rows of A: part_rows must be ceil(M / 64). Pointers an epilogue does
// not read may be null. K and N multiples of 8, the operands 16-byte
// aligned (TMA's row strides and addresses).
extern "C" int rvt_gemm_bf16(const void* a, const void* w, const void* bias,
                             const void* gamma, const void* res_in, void* aux,
                             void* out, void* part, int part_rows, int M,
                             int N, int K, int epilogue, void* stream) {
  if (epilogue < EPI_BIAS || epilogue > EPI_RT_GELU_BWD || M < 0 ||
      K % 8 != 0 || N % 8 != 0 ||
      (epilogue == EPI_RT_GELU_BWD &&
       part_rows != (M + PART_ROWS - 1) / PART_ROWS))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  const EpiArgs e{(const bf16*)bias, (const float*)gamma,
                  (const float*)res_in, (bf16*)aux, out, (float*)part};
  cudaStream_t st = (cudaStream_t)stream;
  switch (epilogue) {
    case EPI_BIAS:
      return dispatch<EPI_BIAS>(a, w, e, M, N, K, st);
    case EPI_GELU:
      return dispatch<EPI_GELU>(a, w, e, M, N, K, st);
    case EPI_RESID:
      return dispatch<EPI_RESID>(a, w, e, M, N, K, st);
    case EPI_RESID_LS:
      return dispatch<EPI_RESID_LS>(a, w, e, M, N, K, st);
    case EPI_RT_F32:
      return dispatch<EPI_RT_F32>(a, w, e, M, N, K, st);
    case EPI_RT_BF16:
      return dispatch<EPI_RT_BF16>(a, w, e, M, N, K, st);
    case EPI_RT_ACC:
      return dispatch<EPI_RT_ACC>(a, w, e, M, N, K, st);
    default:
      return dispatch<EPI_RT_GELU_BWD>(a, w, e, M, N, K, st);
  }
}

// What dispatch() takes for ``epilogue`` at (M, N, K) on the current
// device, into plan[4]: 1 for the ping-pong schedule (0 cooperative), the
// tile's rows and columns, the consumer warpgroups. Launches nothing.
extern "C" int rvt_gemm_bf16_plan(int M, int N, int K, int epilogue,
                                  int* plan) {
  if (M < 0 || N <= 0 || K <= 0 || epilogue < EPI_BIAS ||
      epilogue > EPI_RT_GELU_BWD)
    return (int)cudaErrorInvalidValue;
  const Schedule s = schedule(M, N, K, epilogue);
  plan[0] = s.pp;
  plan[1] = s.rows;
  plan[2] = s.bn;
  plan[3] = s.nc;
  return (int)cudaSuccess;
}

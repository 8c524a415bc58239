// bn_act: train-mode BatchNorm followed by its activation, forward and
// backward, for the YOLOX neck and head (models/yolox.py:BaseConv).
//
// Replaces no TPU kernel: the JAX package leaves flax's nn.BatchNorm
// (rvt_tpu/models/yolox.py:BaseConv) to XLA, which fuses it. On the card
// the same math written as PyTorch ops took about ten passes over f32
// copies of each conv output, forward and backward. The math is flax's:
// f32 moments over (N, H, W) of the conv output y (bf16 or f32), the fast
// variance max(E[y^2] - E[y]^2, 0) (biased), z = (y - mean) * (rsqrt(var +
// eps) * scale) + bias, then silu, relu or leaky relu (0.1), all in f32;
// the running buffers become keep * ra + take * batch. Four launchers:
//   rvt_bn_moments       [2, C] f32: this rank's mean and E[y^2]
//   rvt_bn_act_fwd       out = act(z) in f32; block 0 also updates the
//                        running buffers
//   rvt_bn_act_bwd_sums  [2, C]: sum of dz = g * act'(z) and of
//                        dz * (y - mean); [2, C]: the scale and bias
//                        gradients from them
//   rvt_bn_act_bwd_dy    dy = mul * (dz - sum dz / n) + coef * (y - mean)
//                        in y's dtype; coef = -scale * rstd^3 *
//                        sum dz (y - mean) / n, 0 where the clamp held the
//                        variance at 0 (E[y^2] - E[y]^2 < 0)
// The moments (and the backward's two sums) arrive summed over the ranks
// of a data-parallel group when there is one: the wrapper all-reduces them
// between the launches; ``world`` divides the moments.
//
// Bound on the H100: bytes (a few flops an element). Design:
//  * Two layouts of the [N, C, H, W] tensor, as the convs leave it: CHW
//    (NCHW in memory; N planes of S = H * W elements a channel) and HWC
//    (channels_last; M = N * S rows of C). A thread loads 16 bytes of y at
//    a time (VEC elements: along S in CHW, along C in HWC). The gradient g
//    (f32) may be a slice of a wider tensor: its sample stride (CHW) or
//    row stride (HWC) is an argument; y, out and dy are contiguous.
//  * The reductions (moments, the backward's sums) split each channel's
//    elements into chunks by a plan that depends on the shape alone
//    (ops/bn_act.py:bn_plan); a block adds its chunk in a fixed order
//    (CHW: one channel a block, a butterfly over each warp, the warps in
//    order; HWC: a tile of channel vectors and row lanes, the lanes in a
//    fixed tree). The last block of a channel (or tile) to finish, chosen
//    by an integer ticket after a __threadfence, adds the chunks' partials
//    in chunk order and resets its ticket: no float atomics, so two runs
//    give the same bits.
//  * The elementwise passes (forward, dy) walk 16-byte vectors over the
//    whole tensor; each block first computes every channel's mean,
//    multiplier and the backward's coefficients from the moments into
//    shared memory, so no other launch or PyTorch op prepares them.
// Traffic an element (bf16 y): moments 2 B, forward 2 + 4 B, backward
// 2 + 4 B twice and 2 B written: 22 B, against about 170 B of the
// PyTorch ops it replaces.
#include "common.cuh"

namespace {

constexpr int THREADS = 256, UNROLL = 4, FINAL_BATCH = 8;

enum { ACT_SILU = 0, ACT_RELU = 1, ACT_LRELU = 2 };

__device__ __forceinline__ float act_fwd(int act, float z) {
  if (act == ACT_SILU) return z / (1.f + expf(-z));
  if (act == ACT_RELU) return z > 0.f ? z : 0.f;
  return z > 0.f ? z : 0.1f * z;
}

// d act / d z, as PyTorch's backward of each takes it (0 and 0.1 at z = 0)
__device__ __forceinline__ float act_grad(int act, float z) {
  if (act == ACT_SILU) {
    const float s = 1.f / (1.f + expf(-z));
    return s * (1.f + z * (1.f - s));
  }
  if (act == ACT_RELU) return z > 0.f ? 1.f : 0.f;
  return z > 0.f ? 1.f : 0.1f;
}

// n / d for n < 2^31 by a multiply (PyTorch's IntDivider).
struct FastDiv {
  unsigned d, m, s;
  __device__ explicit FastDiv(unsigned div) : d(div), s(0) {
    while ((1u << s) < d) ++s;
    const unsigned long long one = 1;
    m = (unsigned)(((one << 32) * ((one << s) - d)) / d + 1);
  }
  __device__ __forceinline__ unsigned div(unsigned n) const {
    return (__umulhi(n, m) + n) >> s;
  }
};

// z = (y - mean) * mul + bias rounded after each operation, as the plain
// version's PyTorch ops round it (no fused multiply-add): the same z, so
// relu's and leaky relu's kink falls on the same elements.
__device__ __forceinline__ float affine(float d, float mul, float bias) {
  return __fadd_rn(__fmul_rn(d, mul), bias);
}

// Channel c's statistics from the moments [2, C] (summed over ``world``
// ranks): mean, clamped variance, rstd, rstd * scale, and whether the
// variance was not clamped (E[y^2] - E[y]^2 >= 0: its gradient flows).
struct Stats {
  float mean, var, rstd, mul;
  bool open;
};

__device__ __forceinline__ Stats channel_stats(const float* __restrict__ mom,
                                               const float* __restrict__ scale,
                                               int C, int c, float world,
                                               float eps) {
  Stats st;
  st.mean = mom[c] / world;
  const float raw =
      __fsub_rn(mom[C + c] / world, __fmul_rn(st.mean, st.mean));
  st.open = raw >= 0.f;
  st.var = fmaxf(raw, 0.f);
  st.rstd = rsqrtf(st.var + eps);
  st.mul = st.rstd * scale[c];
  return st;
}

// -- 16-byte loads and stores of VEC elements ------------------------------

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
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int e = 0; e < VEC; e += 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p + e));
      v[e] = t.x; v[e + 1] = t.y; v[e + 2] = t.z; v[e + 3] = t.w;
    }
  } else if constexpr (VEC == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    static_assert(VEC == 1, "f32 vectors: a multiple of 4, 2 or 1");
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
  } else if constexpr (VEC == 2) {
    unpack2(__ldg(reinterpret_cast<const unsigned*>(p)), v);
  } else {
    static_assert(VEC == 1, "bf16 vectors: 8, 4, 2 or 1 elements");
    v[0] = __bfloat162float(p[0]);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int e = 0; e < VEC; e += 4)
      *reinterpret_cast<float4*>(p + e) =
          make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(bf16* p, const float* v) {
  if constexpr (VEC == 8) {
    *reinterpret_cast<uint4*>(p) = make_uint4(
        pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
        pack2(v[6], v[7]));
  } else if constexpr (VEC == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack2(v[0], v[1]),
                                              pack2(v[2], v[3]));
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<unsigned*>(p) = pack2(v[0], v[1]);
  } else {
    p[0] = __float2bfloat16_rn(v[0]);
  }
}

// -- the reductions ---------------------------------------------------------

// The moments: sums of y and y^2; finish writes their means.
struct MomentsOp {
  float* out;  // [2, C]
  float count;
  static constexpr bool kGrad = false;
  struct Chan {};
  __device__ Chan chan(int) const { return {}; }
  __device__ __forceinline__ void elem(const Chan&, float y, float, float& a,
                                       float& b) const {
    a += y;
    b += y * y;
  }
  __device__ void finish(int C, int c, float a, float b) const {
    out[c] = a / count;
    out[C + c] = b / count;
  }
};

// The backward's first pass: sums of dz and dz * (y - mean); finish writes
// them and this rank's scale and bias gradients.
struct BwdSumsOp {
  const float* mom;
  const float* scale;
  const float* bias;
  float* sums;     // [2, C]
  float* dparams;  // [2, C]: d scale, d bias
  float world, eps;
  int act;
  static constexpr bool kGrad = true;
  struct Chan {
    float mean, mul, bias;
  };
  __device__ Chan chan(int C, int c) const {
    const Stats st = channel_stats(mom, scale, C, c, world, eps);
    return {st.mean, st.mul, bias[c]};
  }
  __device__ __forceinline__ void elem(const Chan& h, float y, float g,
                                       float& a, float& b) const {
    const float d = y - h.mean;
    const float dz = g * act_grad(act, affine(d, h.mul, h.bias));
    a += dz;
    b += dz * d;
  }
  __device__ void finish(int C, int c, float a, float b) const {
    sums[c] = a;
    sums[C + c] = b;
    dparams[c] = b * channel_stats(mom, scale, C, c, world, eps).rstd;
    dparams[C + c] = a;
  }
};

template <class Op>
__device__ __forceinline__ typename Op::Chan chan_of(const Op& op, int C,
                                                     int c) {
  if constexpr (Op::kGrad) return op.chan(C, c);
  else return op.chan(c);
}

// After a block's sums of its cb channels (from c0) are in place
// (get(i, 0), get(i, 1)): with one chunk, finish them; else write this
// chunk's partials, take the ticket, and in the last block add every
// chunk's partials in chunk order and finish.
template <class Op, class Get>
__device__ void finish_chunks(const Op& op, Get get, int cb, int c0, int C,
                              int chunk, int chunks, int ticket,
                              float* __restrict__ part,
                              int* __restrict__ tickets) {
  __shared__ int last;
  const int n = min(cb, C - c0);
  if (chunks == 1) {
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      op.finish(C, c0 + i, get(i, 0), get(i, 1));
    return;
  }
  for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) {
    const int w = i / n, ci = i - w * n;
    part[((size_t)chunk * 2 + w) * C + c0 + ci] = get(ci, w);
  }
  __threadfence();  // this block's partials visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(tickets + ticket, 1) == chunks - 1;
  __syncthreads();
  if (!last) return;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int k0 = 0; k0 < chunks; k0 += FINAL_BATCH) {
      float va[FINAL_BATCH], vb[FINAL_BATCH];
#pragma unroll
      for (int k = 0; k < FINAL_BATCH; ++k)
        if (k0 + k < chunks) {
          const float* p = part + (size_t)(k0 + k) * 2 * C + c0 + i;
          va[k] = __ldcg(p);
          vb[k] = __ldcg(p + C);
        }
#pragma unroll
      for (int k = 0; k < FINAL_BATCH; ++k)
        if (k0 + k < chunks) {
          a += va[k];
          b += vb[k];
        }
    }
    op.finish(C, c0 + i, a, b);
  }
  if (threadIdx.x == 0) tickets[ticket] = 0;
}

// CHW: block (chunk, channel); the chunk's vectors q of the channel's
// N * S / VEC, sample n = q / (S / VEC).
template <class Op, typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
reduce_chw_kernel(Op op, const T* __restrict__ y, const float* __restrict__ g,
                  int C, int S, int g_sn, unsigned nq, unsigned rows,
                  int chunks, float* __restrict__ part,
                  int* __restrict__ tickets) {
  __shared__ float red[2][THREADS / 32];
  const int c = blockIdx.y;
  const unsigned sv = S / VEC, q1 = min(nq, (blockIdx.x + 1) * rows);
  const FastDiv by_sv(sv);
  const typename Op::Chan h = chan_of(op, C, c);
  const T* yc = y + (size_t)c * S;
  const float* gc = g + (size_t)c * S;
  float a = 0.f, b = 0.f;
  for (unsigned q = blockIdx.x * rows + threadIdx.x; q < q1;
       q += THREADS * UNROLL) {
    float yv[UNROLL][VEC], gv[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const unsigned qq = q + u * THREADS;
      if (qq < q1) {
        const unsigned n = by_sv.div(qq), s = (qq - n * sv) * VEC;
        load_vec<VEC>(yc + (size_t)n * C * S + s, yv[u]);
        if constexpr (Op::kGrad)
          load_vec<VEC>(gc + (size_t)n * g_sn + s, gv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (q + u * THREADS < q1)
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          op.elem(h, yv[u][k], Op::kGrad ? gv[u][k] : 0.f, a, b);
  }
  a = warp_sum(a);
  b = warp_sum(b);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    red[0][warp] = a;
    red[1][warp] = b;
  }
  __syncthreads();
  __shared__ float tot[2];
  if (threadIdx.x < 2) {
    float t = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) t += red[threadIdx.x][w];
    tot[threadIdx.x] = t;
  }
  __syncthreads();
  finish_chunks(op, [&](int, int w) { return tot[w]; }, 1, c, C, blockIdx.x,
                chunks, c, part, tickets);
}

// HWC: block (row chunk, column tile); thread (lx, ly) owns the channel
// vector j = tile * tx + lx and walks rows r = ly, ly + ty, ... of the
// chunk; the ty lanes are added in a fixed tree.
template <class Op, typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
reduce_hwc_kernel(Op op, const T* __restrict__ y, const float* __restrict__ g,
                  int C, int g_ld, unsigned M, unsigned rows, int chunks,
                  int tx, float* __restrict__ part,
                  int* __restrict__ tickets) {
  __shared__ float red[2 * VEC][THREADS];
  const int ty = THREADS / tx, lx = threadIdx.x % tx, ly = threadIdx.x / tx;
  const int c0 = (blockIdx.y * tx + lx) * VEC;
  const bool ok = c0 < C;
  const unsigned r1 = min(M, (blockIdx.x + 1) * rows);
  typename Op::Chan h[VEC];
  float a[VEC], b[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    a[k] = b[k] = 0.f;
    if (ok) h[k] = chan_of(op, C, c0 + k);
  }
  if (ok)
    for (unsigned r = blockIdx.x * rows + ly; r < r1; r += ty * UNROLL) {
      float yv[UNROLL][VEC], gv[UNROLL][VEC];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const unsigned rr = r + u * ty;
        if (rr < r1) {
          load_vec<VEC>(y + (size_t)rr * C + c0, yv[u]);
          if constexpr (Op::kGrad)
            load_vec<VEC>(g + (size_t)rr * g_ld + c0, gv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (r + u * ty < r1)
#pragma unroll
          for (int k = 0; k < VEC; ++k)
            op.elem(h[k], yv[u][k], Op::kGrad ? gv[u][k] : 0.f, a[k], b[k]);
    }
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    red[k][threadIdx.x] = a[k];
    red[VEC + k][threadIdx.x] = b[k];
  }
  for (int half = ty / 2; half > 0; half /= 2) {
    __syncthreads();
    if (ly < half)
#pragma unroll
      for (int k = 0; k < 2 * VEC; ++k)
        red[k][threadIdx.x] += red[k][threadIdx.x + half * tx];
  }
  __syncthreads();
  const int cb = tx * VEC, first = blockIdx.y * cb;
  finish_chunks(
      op, [&](int i, int w) { return red[w * VEC + i % VEC][i / VEC]; }, cb,
      first, C, blockIdx.x, chunks, blockIdx.y, part, tickets);
}

// -- the elementwise passes -------------------------------------------------

// The channel of the VEC elements from e (y contiguous) and their offset in
// g: CHW, plane p = e / S, c = p % C, n = p / C; HWC, row r = e / C,
// c = e % C.
template <bool CHW>
struct Walk {
  FastDiv by_s, by_c;
  int C, S, extra;  // extra: g's stride beyond y's (sample or row)
  __device__ Walk(int C_, int S_, int g_stride)
      : by_s(CHW ? S_ : 1), by_c(C_), C(C_), S(S_),
        extra(CHW ? g_stride - C_ * S_ : g_stride - C_) {}
  __device__ __forceinline__ void at(unsigned e, int& c, size_t& ge) const {
    if constexpr (CHW) {
      const unsigned p = by_s.div(e), n = by_c.div(p);
      c = p - n * C;
      ge = e + (size_t)n * extra;
    } else {
      const unsigned r = by_c.div(e);
      c = e - r * C;
      ge = e + (size_t)r * extra;
    }
  }
};

template <typename T, int VEC, bool CHW>
__global__ void __launch_bounds__(THREADS)
bn_act_fwd_kernel(const T* __restrict__ y, float* __restrict__ out,
                  const float* __restrict__ mom,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias, float* __restrict__ run_mean,
                  float* __restrict__ run_var, int C, int S, unsigned nvec,
                  float world, float eps, float keep, float take, int act) {
  extern __shared__ float tab[];  // [3, C]: mean, mul, bias
  for (int c = threadIdx.x; c < C; c += THREADS) {
    const Stats st = channel_stats(mom, scale, C, c, world, eps);
    tab[c] = st.mean;
    tab[C + c] = st.mul;
    tab[2 * C + c] = bias[c];
    if (blockIdx.x == 0 && run_mean != nullptr) {
      run_mean[c] = keep * run_mean[c] + take * st.mean;
      run_var[c] = keep * run_var[c] + take * st.var;
    }
  }
  __syncthreads();
  const Walk<CHW> walk(C, S, CHW ? C * S : C);
  for (unsigned q = blockIdx.x * THREADS + threadIdx.x; q < nvec;
       q += gridDim.x * THREADS) {
    const unsigned e = q * VEC;
    int c;
    size_t ge;
    walk.at(e, c, ge);
    float v[VEC];
    load_vec<VEC>(y + e, v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int ck = CHW ? c : c + k;
      v[k] = act_fwd(act,
                     affine(v[k] - tab[ck], tab[C + ck], tab[2 * C + ck]));
    }
    store_vec<VEC>(out + e, v);
  }
}

template <typename T, int VEC, bool CHW>
__global__ void __launch_bounds__(THREADS)
bn_act_bwd_dy_kernel(const T* __restrict__ y, const float* __restrict__ g,
                     int g_stride, const float* __restrict__ mom,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias,
                     const float* __restrict__ sums, T* __restrict__ dy, int C,
                     int S, unsigned nvec, float world, float eps,
                     float count, int act) {
  extern __shared__ float tab[];  // [5, C]: mean, mul, bias, abar, coef
  for (int c = threadIdx.x; c < C; c += THREADS) {
    const Stats st = channel_stats(mom, scale, C, c, world, eps);
    tab[c] = st.mean;
    tab[C + c] = st.mul;
    tab[2 * C + c] = bias[c];
    tab[3 * C + c] = sums[c] / count;
    tab[4 * C + c] =
        st.open ? -(scale[c] * (st.rstd * st.rstd * st.rstd) * sums[C + c]) /
                      count
                : 0.f;
  }
  __syncthreads();
  const Walk<CHW> walk(C, S, g_stride);
  for (unsigned q = blockIdx.x * THREADS + threadIdx.x; q < nvec;
       q += gridDim.x * THREADS) {
    const unsigned e = q * VEC;
    int c;
    size_t ge;
    walk.at(e, c, ge);
    float v[VEC], gv[VEC];
    load_vec<VEC>(y + e, v);
    load_vec<VEC>(g + ge, gv);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int ck = CHW ? c : c + k;
      const float mean = tab[ck], mul = tab[C + ck], d = v[k] - mean;
      const float dz =
          gv[k] * act_grad(act, affine(d, mul, tab[2 * C + ck]));
      v[k] = (dz - tab[3 * C + ck]) * mul + tab[4 * C + ck] * d;
    }
    store_vec<VEC>(dy + e, v);
  }
}

// -- launchers --------------------------------------------------------------

struct Shape {
  int chw, N, C, S, vec;
};

template <class Op, typename T, int VEC>
int launch_reduce_t(const Op& op, const T* y, const float* g, int g_stride,
                    const Shape& sh, int chunks, long rows, int tx,
                    float* part, int* tickets, cudaStream_t st) {
  if (sh.chw) {
    const unsigned nq = (unsigned)((long)sh.N * sh.S / VEC);
    reduce_chw_kernel<Op, T, VEC>
        <<<dim3(chunks, sh.C), THREADS, 0, st>>>(
            op, y, g, sh.C, sh.S, g_stride, nq, (unsigned)rows, chunks, part,
            tickets);
  } else {
    const int tiles = (sh.C / VEC + tx - 1) / tx;
    reduce_hwc_kernel<Op, T, VEC><<<dim3(chunks, tiles), THREADS, 0, st>>>(
        op, y, g, sh.C, g_stride, (unsigned)((long)sh.N * sh.S),
        (unsigned)rows, chunks, tx, part, tickets);
  }
  return (int)cudaGetLastError();
}

template <class Op, typename T>
int launch_reduce(const Op& op, const T* y, const float* g, int g_stride,
                  const Shape& sh, int chunks, long rows, int tx, float* part,
                  int* tickets, cudaStream_t st) {
#define RVT_REDUCE(V) \
  launch_reduce_t<Op, T, V>(op, y, g, g_stride, sh, chunks, rows, tx, part, \
                            tickets, st)
  switch (sh.vec) {
    case 1: return RVT_REDUCE(1);
    case 2: return RVT_REDUCE(2);
    case 4: return RVT_REDUCE(4);
    case 8:
      if constexpr (sizeof(T) == 2) return RVT_REDUCE(8);
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
#undef RVT_REDUCE
}

template <typename T, int VEC>
int launch_fwd_t(const T* y, float* out, const float* mom, const float* scale,
                 const float* bias, float* rm, float* rv, const Shape& sh,
                 int grid, float world, float eps, float keep, float take,
                 int act, cudaStream_t st) {
  const unsigned nvec = (unsigned)((long)sh.N * sh.C * sh.S / VEC);
  const size_t smem = 3 * sh.C * sizeof(float);
  if (sh.chw)
    bn_act_fwd_kernel<T, VEC, true><<<grid, THREADS, smem, st>>>(
        y, out, mom, scale, bias, rm, rv, sh.C, sh.S, nvec, world, eps, keep,
        take, act);
  else
    bn_act_fwd_kernel<T, VEC, false><<<grid, THREADS, smem, st>>>(
        y, out, mom, scale, bias, rm, rv, sh.C, sh.S, nvec, world, eps, keep,
        take, act);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_dy_t(const T* y, const float* g, int g_stride, const float* mom,
                const float* scale, const float* bias, const float* sums,
                T* dy, const Shape& sh, int grid, float world, float eps,
                int act, cudaStream_t st) {
  const unsigned nvec = (unsigned)((long)sh.N * sh.C * sh.S / VEC);
  const size_t smem = 5 * sh.C * sizeof(float);
  const float count = world * (float)((long)sh.N * sh.S);
  if (sh.chw)
    bn_act_bwd_dy_kernel<T, VEC, true><<<grid, THREADS, smem, st>>>(
        y, g, g_stride, mom, scale, bias, sums, dy, sh.C, sh.S, nvec, world,
        eps, count, act);
  else
    bn_act_bwd_dy_kernel<T, VEC, false><<<grid, THREADS, smem, st>>>(
        y, g, g_stride, mom, scale, bias, sums, dy, sh.C, sh.S, nvec, world,
        eps, count, act);
  return (int)cudaGetLastError();
}

#define RVT_BY_VEC(T, CALL)                                  \
  switch (sh.vec) {                                          \
    case 1: return CALL(T, 1);                               \
    case 2: return CALL(T, 2);                               \
    case 4: return CALL(T, 4);                               \
    case 8:                                                  \
      if constexpr (sizeof(T) == 2) return CALL(T, 8);       \
      return (int)cudaErrorInvalidValue;                     \
    default: return (int)cudaErrorInvalidValue;              \
  }

template <typename T>
int launch_fwd(const T* y, float* out, const float* mom, const float* scale,
               const float* bias, float* rm, float* rv, const Shape& sh,
               int grid, float world, float eps, float keep, float take,
               int act, cudaStream_t st) {
#define RVT_FWD(T, V)                                                      \
  launch_fwd_t<T, V>(y, out, mom, scale, bias, rm, rv, sh, grid, world, eps, \
                     keep, take, act, st)
  RVT_BY_VEC(T, RVT_FWD)
#undef RVT_FWD
}

template <typename T>
int launch_dy(const T* y, const float* g, int g_stride, const float* mom,
              const float* scale, const float* bias, const float* sums, T* dy,
              const Shape& sh, int grid, float world, float eps, int act,
              cudaStream_t st) {
#define RVT_DY(T, V)                                                         \
  launch_dy_t<T, V>(y, g, g_stride, mom, scale, bias, sums, dy, sh, grid,   \
                    world, eps, act, st)
  RVT_BY_VEC(T, RVT_DY)
#undef RVT_DY
}

}  // namespace

// Every launcher: y [N, C, H, W] f32 (y_f32) or bf16, contiguous in its
// layout (chw: NCHW, else channels_last), S = H * W; vec the elements a
// thread loads at once (S % vec == 0 in CHW, C % vec == 0 in HWC, and the
// gradient's stride a multiple of it). The reductions take the plan of
// ops/bn_act.py:bn_plan (chunks, rows a chunk: vectors of a channel in
// CHW, rows in HWC; tx, the HWC tile's channel vectors), f32 partials
// [chunks, 2, C] (unused at one chunk) and the tickets (one int a channel
// in CHW, a column tile in HWC; all 0, and left 0). The elementwise passes
// take their grid.
extern "C" int rvt_bn_moments(const void* y, int y_f32, void* out, int chw,
                              int N, int C, int S, int vec, int chunks,
                              long rows, int tx, void* part, void* tickets,
                              void* stream) {
  const Shape sh{chw, N, C, S, vec};
  const MomentsOp op{(float*)out, (float)((long)N * S)};
  cudaStream_t st = (cudaStream_t)stream;
  if (y_f32)
    return launch_reduce(op, (const float*)y, (const float*)nullptr, 0, sh,
                         chunks, rows, tx, (float*)part, (int*)tickets, st);
  return launch_reduce(op, (const bf16*)y, (const float*)nullptr, 0, sh,
                       chunks, rows, tx, (float*)part, (int*)tickets, st);
}

// mom: [2, C], the moments summed over ``world`` ranks; out: f32 in y's
// layout; run_mean, run_var: updated in place (null: not updated).
extern "C" int rvt_bn_act_fwd(const void* y, int y_f32, void* out,
                              const void* mom, const void* scale,
                              const void* bias, void* run_mean, void* run_var,
                              int chw, int N, int C, int S, int vec, int grid,
                              float world, float eps, float keep, float take,
                              int act, void* stream) {
  const Shape sh{chw, N, C, S, vec};
  cudaStream_t st = (cudaStream_t)stream;
  if (y_f32)
    return launch_fwd((const float*)y, (float*)out, (const float*)mom,
                      (const float*)scale, (const float*)bias,
                      (float*)run_mean, (float*)run_var, sh, grid, world, eps,
                      keep, take, act, st);
  return launch_fwd((const bf16*)y, (float*)out, (const float*)mom,
                    (const float*)scale, (const float*)bias, (float*)run_mean,
                    (float*)run_var, sh, grid, world, eps, keep, take, act,
                    st);
}

// g: f32 in y's layout with its own sample stride (chw) or row stride
// (g_stride); sums, dparams: [2, C] f32.
extern "C" int rvt_bn_act_bwd_sums(const void* y, int y_f32, const void* g,
                                   int g_stride, const void* mom,
                                   const void* scale, const void* bias,
                                   void* sums, void* dparams, int chw, int N,
                                   int C, int S, int vec, int chunks,
                                   long rows, int tx, float world, float eps,
                                   int act, void* part, void* tickets,
                                   void* stream) {
  const Shape sh{chw, N, C, S, vec};
  const BwdSumsOp op{(const float*)mom, (const float*)scale,
                     (const float*)bias, (float*)sums, (float*)dparams,
                     world, eps, act};
  cudaStream_t st = (cudaStream_t)stream;
  if (y_f32)
    return launch_reduce(op, (const float*)y, (const float*)g, g_stride, sh,
                         chunks, rows, tx, (float*)part, (int*)tickets, st);
  return launch_reduce(op, (const bf16*)y, (const float*)g, g_stride, sh,
                       chunks, rows, tx, (float*)part, (int*)tickets, st);
}

// sums: [2, C], the first pass's summed over the ranks; dy: y's dtype and
// layout.
extern "C" int rvt_bn_act_bwd_dy(const void* y, int y_f32, const void* g,
                                 int g_stride, const void* mom,
                                 const void* scale, const void* bias,
                                 const void* sums, void* dy, int chw, int N,
                                 int C, int S, int vec, int grid, float world,
                                 float eps, int act, void* stream) {
  const Shape sh{chw, N, C, S, vec};
  cudaStream_t st = (cudaStream_t)stream;
  if (y_f32)
    return launch_dy((const float*)y, (const float*)g, g_stride,
                     (const float*)mom, (const float*)scale,
                     (const float*)bias, (const float*)sums, (float*)dy, sh,
                     grid, world, eps, act, st);
  return launch_dy((const bf16*)y, (const float*)g, g_stride,
                   (const float*)mom, (const float*)scale, (const float*)bias,
                   (const float*)sums, (bf16*)dy, sh, grid, world, eps, act,
                   st);
}

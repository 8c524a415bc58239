// train_reduce: the column sums of training (bias, LayerScale-gamma and
// split weight-gradient sums), in a fixed order so that two runs agree.
//
// Replaces the row sums of the TPU kernels rvt_tpu/ops/fused_train.py:
// _block_bwd (dls2_g, dfc2_b :369-374, dls1_g, dproj_b :394-404,
// dqkv_b :415) and the cross-grid accumulation of every weight gradient
// (_acc :495), which the TPU's sequential grid carried in VMEM. Three
// launchers, one launch each:
//   rvt_sum_parts   out[N] = sum over p of part[p, N] (the in-order sum of
//                   the partials K2's gelu backward, K5, K6 and K8 write)
//   rvt_colsum      out[N] = the column sums of x [M, N] (f32 or bf16)
//   rvt_ls_bwd      LayerScale backward: d = dR * gamma, written as bf16
//                   (the cotangent the next product reads), with the
//                   column sums of d (the bias gradient) and of v * dR (the
//                   gamma gradient, v the bf16 branch output): out [2, C]
//
// Bound on the H100: bytes (each input read once, d written once; one or
// two flops an element). Design:
//  * Each thread owns one vector of VEC columns (16 bytes of the input
//    where N allows, narrower where it does not) and walks its rows with
//    UNROLL independent vector loads issued before they are added.
//  * The rows are split into chunks and the columns into tiles of TX
//    vectors, TY row lanes a block, so that a tall, narrow array fills the
//    card too. The plan (rvt_tpu_torch/ops/fused_attention.py:reduce_plan)
//    depends on the shape alone, so the summation order does too.
//  * One launch: each block adds its row lanes in lane order and writes its
//    f32 partial; the last block of a column tile to finish (an integer
//    ticket taken after a __threadfence) adds the tile's partials in chunk
//    order, row lanes in parallel then in lane order, and resets the ticket
//    to 0. No float atomics: two runs give the same bits.
//  * The tickets are a small per-device workspace the wrapper zeroes once.
//    The port launches on one stream: two calls running at once would
//    share them.
#include "common.cuh"

namespace {

// BLOCKS_PER_SM: the plan's ~528 blocks fill a 132-SM card in one wave.
constexpr int THREADS = 256, UNROLL = 4, BLOCKS_PER_SM = 4;

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
  } else if constexpr (VEC == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    static_assert(VEC == 1, "f32 vectors: 4, 2 or 1 elements");
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

// A partial written by another block of this launch: from L2, not L1.
template <int VEC>
__device__ __forceinline__ void load_part(const float* p, float* v) {
  if constexpr (VEC >= 4) {
#pragma unroll
    for (int e = 0; e < VEC; e += 4) {
      const float4 t = __ldcg(reinterpret_cast<const float4*>(p + e));
      v[e] = t.x; v[e + 1] = t.y; v[e + 2] = t.z; v[e + 3] = t.w;
    }
  } else if constexpr (VEC == 2) {
    const float2 t = __ldcg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    static_assert(VEC == 1, "partials: a multiple of 4, 2 or 1 elements");
    v[0] = __ldcg(p);
  }
}

// VEC bf16 as loaded, two to a word (VEC 1: the low half), widened where
// they are used.
template <int VEC>
struct Bf16Vec {
  unsigned w[(VEC + 1) / 2];
  __device__ __forceinline__ float operator[](int e) const {
    return e % 2 ? __uint_as_float(w[e / 2] & 0xffff0000u)
                 : __uint_as_float(w[e / 2] << 16);
  }
};

template <int VEC>
__device__ __forceinline__ void load_raw(const bf16* p, Bf16Vec<VEC>& v) {
  if constexpr (VEC == 4) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    v.w[0] = t.x; v.w[1] = t.y;
  } else if constexpr (VEC == 2) {
    v.w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  } else {
    static_assert(VEC == 1, "bf16 vectors: 4, 2 or 1 elements");
    v.w[0] = __bfloat16_as_ushort(p[0]);
  }
}

template <int VEC>
__device__ __forceinline__ void store_bf16(bf16* p, const float* v) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack2(v[0], v[1]),
                                              pack2(v[2], v[3]));
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<unsigned*>(p) = pack2(v[0], v[1]);
  } else {
    static_assert(VEC == 1, "bf16 stores: 4, 2 or 1 elements");
    p[0] = __float2bfloat16_rn(v[0]);
  }
}

// One thread's place in the plan: row lane ly of TY, column vector j of
// the block's tile of TX, the block's rows [r0, r1).
struct Tile {
  int lx, ly, tx, ty;
  long j;
  bool ok;
  long r0, r1;
};

__device__ __forceinline__ Tile make_tile(long M, long nv, long rows, int tx,
                                          int ty) {
  Tile t;
  t.tx = tx;
  t.ty = ty;
  t.lx = threadIdx.x % tx;
  t.ly = threadIdx.x / tx;
  t.j = (long)blockIdx.x * tx + t.lx;
  t.ok = t.j < nv;
  t.r0 = (long)blockIdx.y * rows;
  t.r1 = min(M, t.r0 + rows);
  return t;
}

// The TY row lanes' sums of each column vector added in lane order; the
// total lands in the threads of lane 0.
template <int A>
__device__ __forceinline__ void lane_total(float* red, float* acc,
                                           const Tile& t) {
  __syncthreads();  // red is free
#pragma unroll
  for (int a = 0; a < A; ++a) red[a * THREADS + threadIdx.x] = acc[a];
  __syncthreads();
  if (t.ly == 0)
    for (int y = 1; y < t.ty; ++y)
#pragma unroll
      for (int a = 0; a < A; ++a) acc[a] += red[a * THREADS + y * t.tx + t.lx];
}

// The block's A sums per thread: accumulator a of column vector j is
// column (a / VEC) * ncols + j * VEC + a % VEC of a result row of
// (A / VEC) * ncols. One chunk: written to out. Else written to this
// chunk's row of part; the tile's last block adds the chunks in order.
template <int A, int VEC>
__device__ __forceinline__ void finish(float* acc, float* red, const Tile& t,
                                       long ncols, int chunks,
                                       float* __restrict__ part,
                                       float* __restrict__ out,
                                       int* __restrict__ tickets) {
  __shared__ int last;
  constexpr int G = A / VEC;  // result rows: 1, or 2 for ls_bwd
  const long nout = G * ncols, c0 = t.j * VEC;
  auto col = [&](int a) { return (a / VEC) * ncols + c0 + a % VEC; };
  lane_total<A>(red, acc, t);
  const bool writer = t.ly == 0 && t.ok;
  if (chunks == 1) {
    if (writer)
#pragma unroll
      for (int a = 0; a < A; ++a) out[col(a)] = acc[a];
    return;
  }
  if (writer) {
    float* p = part + (long)blockIdx.y * nout;
#pragma unroll
    for (int a = 0; a < A; ++a) p[col(a)] = acc[a];
  }
  __threadfence();  // this block's partial visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(tickets + blockIdx.x, 1) == chunks - 1;
  __syncthreads();
  if (!last) return;
#pragma unroll
  for (int a = 0; a < A; ++a) acc[a] = 0.f;
  if (t.ok) {
    for (int c = t.ly; c < chunks; c += t.ty * UNROLL) {
      float v[UNROLL][A];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (c + u * t.ty < chunks)
#pragma unroll
          for (int g = 0; g < G; ++g)
            load_part<VEC>(part + (long)(c + u * t.ty) * nout + g * ncols + c0,
                           v[u] + g * VEC);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (c + u * t.ty < chunks)
#pragma unroll
          for (int a = 0; a < A; ++a) acc[a] += v[u][a];
    }
  }
  lane_total<A>(red, acc, t);
  if (writer)
#pragma unroll
    for (int a = 0; a < A; ++a) out[col(a)] = acc[a];
  if (threadIdx.x == 0) tickets[blockIdx.x] = 0;
}

// out[N] = sum over the M rows of x [M, N] (also sum_parts, T = float).
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
colsum_kernel(const T* __restrict__ x, long M, long N, long rows, int chunks,
              int tx, int ty, float* __restrict__ part,
              float* __restrict__ out, int* __restrict__ tickets) {
  __shared__ float red[VEC * THREADS];
  const Tile t = make_tile(M, N / VEC, rows, tx, ty);
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  if (t.ok) {
    const T* p = x + t.j * VEC;
    for (long r = t.r0 + t.ly; r < t.r1; r += (long)t.ty * UNROLL) {
      float v[UNROLL][VEC];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (r + u * t.ty < t.r1) load_vec<VEC>(p + (r + u * t.ty) * N, v[u]);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (r + u * t.ty < t.r1)
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[k] += v[u][k];
    }
  }
  finish<VEC, VEC>(acc, red, t, N, chunks, part, out, tickets);
}

template <int VEC>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
ls_bwd_kernel(const float* __restrict__ dR, const bf16* __restrict__ v,
              const float* __restrict__ gamma, bf16* __restrict__ d_out,
              long M, int C, long rows, int chunks, int tx, int ty,
              float* __restrict__ part, float* __restrict__ out,
              int* __restrict__ tickets) {
  __shared__ float red[2 * VEC * THREADS];
  const Tile t = make_tile(M, C / VEC, rows, tx, ty);
  float acc[2 * VEC];  // sums of d, then of v * dR
#pragma unroll
  for (int k = 0; k < 2 * VEC; ++k) acc[k] = 0.f;
  if (t.ok) {
    const long c0 = t.j * VEC;
    float g[VEC];
    load_vec<VEC>(gamma + c0, g);
    for (long r = t.r0 + t.ly; r < t.r1; r += (long)t.ty * UNROLL) {
      float dr[UNROLL][VEC];
      Bf16Vec<VEC> vv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (r + u * t.ty < t.r1) {
          const long o = (r + u * t.ty) * C + c0;
          load_vec<VEC>(dR + o, dr[u]);
          load_raw<VEC>(v + o, vv[u]);
        }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (r + u * t.ty < t.r1) {
          float d[VEC];
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            d[k] = dr[u][k] * g[k];
            acc[k] += d[k];
            acc[VEC + k] += vv[u][k] * dr[u][k];
          }
          store_bf16<VEC>(d_out + (r + u * t.ty) * C + c0, d);
        }
    }
  }
  finish<2 * VEC, VEC>(acc, red, t, C, chunks, part, out, tickets);
}

dim3 grid_of(long nv, long M, long rows, int tx) {
  return dim3((unsigned)((nv + tx - 1) / tx),
              (unsigned)((M + rows - 1) / rows));
}

template <typename T>
int launch_colsum(const T* x, long M, long N, long rows, int chunks, int vec,
                  int tx, int ty, float* part, float* out, int* tickets,
                  cudaStream_t st) {
  const dim3 grid = grid_of(N / vec, M, rows, tx), block(tx * ty);
#define RVT_COLSUM(V)                                                        \
  colsum_kernel<T, V><<<grid, block, 0, st>>>(x, M, N, rows, chunks, tx, ty, \
                                              part, out, tickets)
  switch (vec) {
    case 1: RVT_COLSUM(1); break;
    case 2: RVT_COLSUM(2); break;
    case 4: RVT_COLSUM(4); break;
    case 8:
      if constexpr (sizeof(T) == 2) {
        RVT_COLSUM(8);
        break;
      }
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
#undef RVT_COLSUM
  return (int)cudaGetLastError();
}

}  // namespace

// The plan's arguments of every launcher: chunks (row chunks), rows (rows
// a chunk), vec (columns a thread owns), tx (column vectors a block's
// tile), ty (row lanes a block). part: [chunks, result columns] f32
// scratch, unused (may be null) at one chunk; tickets: at least one int
// per column tile, all 0.
extern "C" int rvt_sum_parts(const void* part_in, void* out, long P, long N,
                             int chunks, long rows, int vec, int tx, int ty,
                             void* part, void* tickets, void* stream) {
  return launch_colsum<float>((const float*)part_in, P, N, rows, chunks, vec,
                              tx, ty, (float*)part, (float*)out,
                              (int*)tickets, (cudaStream_t)stream);
}

extern "C" int rvt_colsum(const void* x, int x_is_f32, void* out, long M,
                          long N, int chunks, long rows, int vec, int tx,
                          int ty, void* part, void* tickets, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (x_is_f32)
    return launch_colsum<float>((const float*)x, M, N, rows, chunks, vec, tx,
                                ty, (float*)part, (float*)out, (int*)tickets,
                                st);
  return launch_colsum<bf16>((const bf16*)x, M, N, rows, chunks, vec, tx, ty,
                             (float*)part, (float*)out, (int*)tickets, st);
}

// out: [2, C] f32 (the sums of d, then of v * dR).
extern "C" int rvt_ls_bwd(const void* dR, const void* v, const void* gamma,
                          void* d_out, void* out, long M, int C, int chunks,
                          long rows, int vec, int tx, int ty, void* part,
                          void* tickets, void* stream) {
  const dim3 grid = grid_of(C / vec, M, rows, tx), block(tx * ty);
  cudaStream_t st = (cudaStream_t)stream;
#define RVT_LS_BWD(V)                                                       \
  ls_bwd_kernel<V><<<grid, block, 0, st>>>(                                 \
      (const float*)dR, (const bf16*)v, (const float*)gamma, (bf16*)d_out, \
      M, C, rows, chunks, tx, ty, (float*)part, (float*)out, (int*)tickets)
  switch (vec) {
    case 1: RVT_LS_BWD(1); break;
    case 2: RVT_LS_BWD(2); break;
    case 4: RVT_LS_BWD(4); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef RVT_LS_BWD
  return (int)cudaGetLastError();
}

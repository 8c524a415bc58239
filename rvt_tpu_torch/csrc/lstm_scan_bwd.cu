// K8 lstm_scan_bwd: backpropagation through time of the 1x1 ConvLSTM cell
// over a whole window.
//
// Replaces the TPU kernel rvt_tpu/ops/fused_train.py:_lstm_scan_bwd_kernel
// (with _lstm_bwd_chunked :523; called by _lstm_scan_train_bwd :1573).
// Reverse time, per pixel and step t:
//   xh   = [bf16(x_t), h_{t-1}]   (h_{-1} = bf16(h0); c_{t-1}, c_{-1} = c0)
//   mix  = bf16(bf16(xh . W) + b); f, i, o = bf16(sigmoid); g = bf16(tanh)
//   c_t  = f*c_{t-1} + i*g;  dh = dh_carry + dh_seq[t];  dc = dc_carry
//   dct  = dc + dh*o*(1 - tanh(c_t)^2)
//   dmix = [dct*c_{t-1}*f*(1-f), dct*g*i*(1-i), dh*tanh(c_t)*o*(1-o),
//           dct*i*(1-g^2)]                                  (f32, :551-555)
//   dxh  = bf16(dmix) . W^T (f32);  dx_t = dxh[:, :C]
//   dh_carry = dxh[:, C:];  dc_carry = dct * f
//
// Bound on the H100: bytes (about 28 bytes per pixel, step and channel
// in and out), but only dh_carry = bf16(dmix_t) . W_h^T depends on the
// previous step: 21 dependent steps over 640 rows at gen1 stage 4 are
// latency, as in K4 (lstm_scan.cu). The design takes everything else out
// of the time loop (ops/fused_scan.py:lstm_scan_bwd_launch):
//  * ``pack`` writes xh [T*rows, 2C] bf16 once (K6 reads it for dW);
//  * K2's "bias" epilogue forms mix for every step in one product over
//    T*rows rows (exactly JAX's bf16(bf16(acc) + b));
//  * ``scan`` (below) runs the cell backward in reverse time with only
//    bf16(dmix) . W_h^T in the loop, and writes bf16(dmix);
//  * K2's "rt_f32" epilogue forms dx = bf16(dmix) . W_x^T after the loop,
//    over all T*rows rows.
// Unlike K4, the gates are hoisted at C <= 64 too (gen1 stage 1): that
// writes and reads 440 MB of bf16 gates a window (0.26 ms at the bytes
// bound), against a second product with the whole W in the loop of a
// kernel whose step is already bound by its loads.
// In ``scan`` the block of rank r in a thread-block cluster (up to 16
// blocks, the non-portable size, at C = 512) owns all four gates of the
// channels [r*C/CL, (r+1)*C/CL): the cell math stays in the block. What
// crosses blocks each step is each block's f32 partial of dh_{t-1} over
// its own 4C/CL dmix columns, for every channel: the block holds the
// columns of W_h that meet its dmix (C x 4C/CL bf16, in shared memory for
// the whole window), forms the partial with mma.sync m16n8k16 from
// ldmatrix on 128-byte-swizzled tiles (warp_mma.cuh), and stores each
// channel slice into the block that owns it through distributed shared
// memory; the owner adds the CL partials in rank order. That is half the
// bytes of sending the bf16 dmix slices to every block, and a fixed sum
// order. The (dh, dc) carry stays in shared memory for the window. A
// cluster owns R rows (pixels of all lanes), R chosen so the clusters
// fill the card in whole waves, with 512 threads a block where shared
// memory allows (else 384). The cell math is most of a step at the narrow
// stages and is bound by the latency of its loads: a thread takes two
// channels and four rows at a time, their loads (read-only for the
// launch, ld.global.nc) issued together before any math. The gates use
// the SFU exponential and reciprocal, as K4. Without the product (T = 1:
// the per-step path, where dh_0 comes from one K2 product with dx) the
// same kernel writes dmix, dc_0 and the db partials.
// db: each block sums its f32 dmix over its rows and steps, per thread
// in a fixed order, then over its threads in order: one partial row of
// 4C per cluster; train_reduce.cu sums the rows in order.
#include <mutex>

#include "warp_mma.cuh"

namespace {

constexpr int SMEM_LIMIT = 232448;
constexpr int MAX_THREADS = 512;
constexpr int PT = 32;  // rows per 32-row tile; the partials' row unit

__device__ __forceinline__ float sigmoid_fast(float v) {
  return __fdividef(1.f, 1.f + __expf(-v));
}
__device__ __forceinline__ float tanh_fast(float v) {
  return 1.f - __fdividef(2.f, 1.f + __expf(2.f * v));
}

// Two bf16 as two floats through the read-only (non-coherent) path.
__device__ __forceinline__ float2 ldg_bf16x2(const bf16* p) {
  const unsigned int v = __ldg(reinterpret_cast<const unsigned int*>(p));
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

template <typename TX>
__device__ __forceinline__ uint4 load_bf16x8(const TX* p);
template <>
__device__ __forceinline__ uint4 load_bf16x8<bf16>(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}
template <>
__device__ __forceinline__ uint4 load_bf16x8<float>(const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  return bf16x8(v);
}

// xh [T*rows, 2C] = [bf16(x_t) | h_{t-1}], h_{-1} = bf16(h0); eight
// channels a thread.
template <typename TX>
__global__ void pack_kernel(const TX* __restrict__ x,
                            const bf16* __restrict__ hseq,
                            const float* __restrict__ h0,
                            bf16* __restrict__ xh, long n8, int rows, int C) {
  const int c8 = C / 8;
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n8;
       i += (long)gridDim.x * blockDim.x) {
    const long tr = i / (2 * c8);  // t * rows + r
    const int k = (int)(i % (2 * c8)) * 8;
    uint4 v;
    if (k < C)
      v = load_bf16x8(x + tr * C + k);
    else if (tr >= rows)
      v = *reinterpret_cast<const uint4*>(hseq + (tr - rows) * C + (k - C));
    else
      v = load_bf16x8(h0 + tr * C + (k - C));
    *reinterpret_cast<uint4*>(xh + tr * 2 * C + k) = v;
  }
}

struct Params {
  const bf16* mix;     // [t1 - t0, rows, 4C]: this chunk's gates
  const bf16* w;       // [2C, 4C]
  const float* cseq;   // [T, rows, C]
  const float* c0;     // [rows, C]
  const bf16* dhseq;   // [T, rows, C]
  const float* dh_in;  // [rows, C]: the carry into step t1 - 1
  const float* dc_in;
  bf16* dmix;          // [T, rows, 4C]
  float* part;         // [ceil(rows / 32), 4C]: db partials of this chunk
  float* dh_out;       // [rows, C]: the carry out of step t0 (scan only)
  float* dc_out;
  int t0, t1, rows, C, CL, R, nthr, product;
};

// Shared-memory plan of one block (bytes), host and device.
struct Plan {
  int Cs, K, ld, rp, ldr;
  size_t w_off, a_off, r_off, c_off, d_off, bytes;
  __host__ __device__ Plan(bool product, int C, int CL, int R, int nthr) {
    Cs = C / CL;
    K = 4 * Cs;                        // dmix columns of the block
    ld = (K * 2 + 127) / 128 * 128;    // W part and dmix rows, bytes
    rp = (R + PT - 1) / PT * PT;
    ldr = Cs + 4;                      // partial rows, floats
    w_off = 0;
    a_off = w_off + (product ? (size_t)C * ld : 0);
    r_off = a_off + (product ? (size_t)rp * ld : 0);
    c_off = r_off + (product ? (size_t)CL * rp * ldr * 4 : 0);
    d_off = c_off + (size_t)rp * Cs * 4;
    bytes = d_off + (size_t)nthr * 8 * 4;  // db of every thread
  }
};

// NTILE n8 tiles per product unit (32 rows x 8*NTILE channels).
template <int NTILE>
__global__ void __launch_bounds__(MAX_THREADS) scan_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = p.C, CL = p.CL, rows = p.rows;
  const Plan L(p.product != 0, C, CL, p.R, p.nthr);
  const int Cs = L.Cs, K = L.K, C4 = 4 * C;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nw = nthr >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const int rank = CL > 1 ? (int)cluster_rank() : 0;
  const int cluster = blockIdx.x / CL;
  const int row0 = cluster * p.R;
  const int rv = min(p.R, rows - row0);  // rows of this cluster (>= 1)
  const int c0 = rank * Cs;
  unsigned char* Ws = smem + L.w_off;
  unsigned char* As = smem + L.a_off;
  float* Rs = reinterpret_cast<float*>(smem + L.r_off);  // [CL][rp][ldr]
  float* Dc = reinterpret_cast<float*>(smem + L.c_off);  // [rp][Cs]
  float* Db = reinterpret_cast<float*>(smem + L.d_off);  // [8][nthr]

  // W part: row j (output channel), k = q*Cs + jj is W_h[j][q*C + c0 + jj]
  const int kch = K / 8;
  if (p.product)
    for (int i = tid; i < C * kch; i += nthr) {
      const int j = i / kch, kc = i % kch, k = kc * 8;
      const int q = k / Cs, jj = k % Cs;
      *reinterpret_cast<uint4*>(Ws + swz(j, kc, L.ld)) =
          *reinterpret_cast<const uint4*>(p.w + (long)(C + j) * C4 + q * C +
                                          c0 + jj);
    }
  for (int i = tid; i < L.rp * Cs; i += nthr) {
    const int r = i / Cs, j = i % Cs;
    Dc[i] = r < rv ? p.dc_in[(long)(row0 + r) * C + c0 + j] : 0.f;
  }
  if (CL > 1) {  // every block of the cluster runs before any DSMEM store
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }

  // the cell math: a thread keeps one pair of channels j, j + 1 of the
  // slice for the whole window (nthr % (Cs / 2) == 0), so its db sums run
  // in a fixed order; it takes U rows at a time, their loads first (all
  // read-only for the launch: ld.global.nc), so that they are in flight
  // together
  constexpr int U = 4;
  const int pairs = Cs / 2, cpt = nthr / pairs;
  const int j = 2 * (tid % pairs), rsub = tid / pairs;
  float db[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const uint32_t ws_base = smem_addr(Ws), as_base = smem_addr(As);
  const int nu = C / (8 * NTILE), units = (L.rp / PT) * nu;
  for (int t = p.t1 - 1; t >= p.t0; --t) {
    const bool first = t == p.t1 - 1;
    for (int r0 = rsub; r0 < L.rp; r0 += U * cpt) {
      float2 mx[U][4], cp[U], dhv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = r0 + u * cpt;
        if (r >= rv) continue;
        const long grow = row0 + r;
        const long cell = ((long)t * rows + grow) * C + c0 + j;
        const bf16* m =
            p.mix + ((long)(t - p.t0) * rows + grow) * C4 + c0 + j;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          mx[u][q] = ldg_bf16x2(m + q * C);
        cp[u] = t > 0 ? __ldg(reinterpret_cast<const float2*>(
                            p.cseq + cell - (long)rows * C))
                      : __ldg(reinterpret_cast<const float2*>(
                            p.c0 + grow * C + c0 + j));
        dhv[u] = ldg_bf16x2(p.dhseq + cell);
        if (first) {
          const float2 d = __ldg(reinterpret_cast<const float2*>(
              p.dh_in + grow * C + c0 + j));
          dhv[u].x += d.x;
          dhv[u].y += d.y;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = r0 + u * cpt;
        if (r >= L.rp) break;
        float d[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
        float2 dcn = make_float2(0.f, 0.f);
        if (r < rv) {
          const long grow = row0 + r;
          float2 dh = dhv[u];
          if (!first) {  // the carry: the blocks' partials in rank order
            float2 c = *reinterpret_cast<const float2*>(Rs + r * L.ldr + j);
            for (int s = 1; s < CL; ++s) {
              const float2 v = *reinterpret_cast<const float2*>(
                  Rs + (s * L.rp + r) * L.ldr + j);
              c.x += v.x;
              c.y += v.y;
            }
            dh.x += c.x;  // + dh_seq[t]
            dh.y += c.y;
          }
          const float2 dc = *reinterpret_cast<const float2*>(Dc + r * Cs + j);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) v[q] = e ? mx[u][q].y : mx[u][q].x;
            const float f = round_bf16(sigmoid_fast(v[0]));
            const float in = round_bf16(sigmoid_fast(v[1]));
            const float o = round_bf16(sigmoid_fast(v[2]));
            const float gg = round_bf16(tanh_fast(v[3]));
            const float cpv = e ? cp[u].y : cp[u].x;
            const float dhe = e ? dh.y : dh.x;
            const float ct = f * cpv + in * gg;
            const float tc = tanh_fast(ct);
            const float dct = (e ? dc.y : dc.x) + dhe * o * (1.f - tc * tc);
            d[0][e] = dct * cpv * f * (1.f - f);
            d[1][e] = dct * gg * in * (1.f - in);
            d[2][e] = dhe * tc * o * (1.f - o);
            d[3][e] = dct * in * (1.f - gg * gg);
            (e ? dcn.y : dcn.x) = dct * f;
          }
          bf16* out = p.dmix + ((long)t * rows + grow) * C4 + c0 + j;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            *reinterpret_cast<uint32_t*>(out + q * C) =
                pack_bf16x2(d[q][0], d[q][1]);
            db[2 * q] += d[q][0];
            db[2 * q + 1] += d[q][1];
          }
        }
        *reinterpret_cast<float2*>(Dc + r * Cs + j) = dcn;
        if (p.product) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int k = q * Cs + j;
            *reinterpret_cast<uint32_t*>(As + swz(r, k / 8, L.ld) +
                                         (k % 8) * 2) =
                pack_bf16x2(d[q][0], d[q][1]);
          }
        }
      }
    }
    if (!p.product) break;  // uniform: T = 1, no carry out of dh
    // every block has read its partials of step t + 1; the dmix rows are
    // complete
    if (CL > 1) {
      cluster_arrive();
      cluster_wait();
    } else {
      __syncthreads();
    }
    // this block's partial of dh_{t-1} = bf16(dmix) . W_h^T over its K
    // columns, every channel; channel n goes to block n / Cs, slot rank
#pragma unroll 1
    for (int unit = warp; unit < units; unit += nw) {
      const int rb = (unit / nu) * PT, nb = (unit % nu) * 8 * NTILE;
      float acc[2][NTILE][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < NTILE; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
      const int arow = rb + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int brow = nb + (lane >> 4) * 8 + (lane & 7);
#pragma unroll 2
      for (int kk = 0; kk < K / 16; ++kk) {
        uint32_t a0[4], a1[4];
        ldmatrix_x4(a0, as_base + swz(arow, 2 * kk + (lane >> 4), L.ld));
        ldmatrix_x4(a1, as_base + swz(arow + 16, 2 * kk + (lane >> 4), L.ld));
#pragma unroll
        for (int n2 = 0; n2 < NTILE / 2; ++n2) {
          uint32_t b[4];
          ldmatrix_x4(b, ws_base + swz(brow + n2 * 16,
                                       2 * kk + ((lane >> 3) & 1), L.ld));
          mma_bf16(acc[0][2 * n2], a0, b);
          mma_bf16(acc[0][2 * n2 + 1], a0, b + 2);
          mma_bf16(acc[1][2 * n2], a1, b);
          mma_bf16(acc[1][2 * n2 + 1], a1, b + 2);
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < NTILE; ++n)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int r = rb + m * 16 + g + 8 * h2;
            const int ch = nb + n * 8 + 2 * qd;
            const int dst = ch / Cs, jj = ch % Cs;
            float* a = Rs + (rank * L.rp + r) * L.ldr + jj;
            const float2 v = make_float2(acc[m][n][2 * h2],
                                         acc[m][n][2 * h2 + 1]);
            if (CL > 1)
              st_cluster_f32x2(map_rank(smem_addr(a), dst), v);
            else
              *reinterpret_cast<float2*>(a) = v;
          }
    }
    // every partial of dh_{t-1} has arrived
    if (CL > 1) {
      cluster_arrive();
      cluster_wait();
    } else {
      __syncthreads();
    }
  }

  // the carries out of step t0; db of every thread, summed in order
  __syncthreads();
  for (int i = tid; i < rv * Cs; i += nthr) {
    const int r = i / Cs, jc = i % Cs;
    const long o = (long)(row0 + r) * C + c0 + jc;
    if (p.product) {
      float dh = Rs[r * L.ldr + jc];
      for (int s = 1; s < CL; ++s) dh += Rs[(s * L.rp + r) * L.ldr + jc];
      p.dh_out[o] = dh;
    }
    p.dc_out[o] = Dc[r * Cs + jc];
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) Db[q * nthr + tid] = db[q];
  __syncthreads();
  for (int i = tid; i < 4 * Cs; i += nthr) {
    const int q = i / Cs, jc = i % Cs;
    const float* col = Db + (2 * q + (jc & 1)) * nthr + jc / 2;
    float s = 0.f;
    for (int k = 0; k < cpt; ++k) s += col[k * pairs];
    p.part[(long)cluster * C4 + q * C + c0 + jc] = s;
  }
  // rows of part past the last cluster (the wrapper sizes part for
  // 32-row clusters) are zeros
  if (blockIdx.x == 0) {
    const long n_cl = (rows + p.R - 1) / p.R;
    const long n_part = (rows + PT - 1) / PT;
    for (long i = n_cl * C4 + tid; i < n_part * C4; i += nthr) p.part[i] = 0.f;
  }
}

template <int NTILE>
int launch_kernel(const Params& p, int smem, cudaStream_t st, int* active) {
  auto kern = scan_kernel<NTILE>;
  static bool attrs_set = false;
  cudaError_t e = cudaSuccess;
  if (!attrs_set) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    attrs_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)(((p.rows + p.R - 1) / p.R) * p.CL));
  cfg.blockDim = dim3(p.nthr);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = p.CL > 1 ? 1 : 0;
  if (active != nullptr && p.CL > 1)  // the planning query: no launch
    return (int)cudaOccupancyMaxActiveClusters(active, kern, &cfg);
  if (active != nullptr) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, p.nthr,
                                                      smem);
    *active = per_sm * sms;
    return (int)e;
  }
  e = cudaLaunchKernelEx(&cfg, kern, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int dispatch(const Params& p, int smem, cudaStream_t st, int* active) {
  if (p.C % 32 == 0) return launch_kernel<4>(p, smem, st, active);
  return launch_kernel<2>(p, smem, st, active);
}

// Threads of a block: 512 or 384, a multiple of the slice's channel
// pairs (each thread keeps one pair).
constexpr int THREADS[2] = {512, 384};

// The plan of one launch (into p): for each cluster size and block size
// (512 threads first: more rows in flight at the narrow stages, where the
// cell math is most of a step), the most 32-row tiles a cluster that
// shared memory holds, and the waves of clusters that takes; the fewest
// waves (then the smaller cluster, then more threads), then as few rows
// as keep that number of waves. The cell kernel (no product) runs
// without clusters, rows spread over about two blocks an SM.
int plan_rows(Params& p, int* active) {
  const int C = p.C;
  const int tiles = (p.rows + PT - 1) / PT;
  if (!p.product) {
    p.CL = 1;
    p.nthr = 512 % (C / 2) == 0 ? 512 : 384 % (C / 2) == 0 ? 384 : 0;
    if (p.nthr == 0) return (int)cudaErrorInvalidValue;
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int mt = (tiles + 2 * sms - 1) / (2 * sms);
    p.R = mt * PT;
    *active = 2 * sms;
    return 0;
  }
  int best_waves = 0;
  Params best = p;
  int best_active = 0;
  for (int cl = 1; cl <= 16; cl *= 2) {
    if (C % (8 * cl) != 0) break;
    for (int nthr : THREADS) {
      if (nthr % (C / cl / 2) != 0) continue;
      Params q = p;
      q.CL = cl;
      q.nthr = nthr;
      int mt = tiles < 8 ? tiles : 8;
      while (mt > 0 && Plan(true, C, cl, mt * PT, nthr).bytes > SMEM_LIMIT)
        --mt;
      if (mt == 0) continue;
      q.R = mt * PT;
      int act = 0;
      const int smem = (int)Plan(true, C, cl, q.R, nthr).bytes;
      if (dispatch(q, smem, nullptr, &act) != 0 || act < 1) continue;
      const int waves = (tiles + act * mt - 1) / (act * mt);
      if (best_waves == 0 || waves < best_waves) {
        best_waves = waves;
        best = q;
        best_active = act;
      }
    }
  }
  if (best_waves == 0) return (int)cudaErrorInvalidConfiguration;
  const int mt = (tiles + best_active * best_waves - 1) /
                 (best_active * best_waves);
  best.R = mt * PT;
  p = best;
  *active = best_active;
  return 0;
}

// Plans by shape (the time range does not enter a plan): the occupancy
// query costs more host time than a T = 1 launch.
struct Cached {
  int product, rows, C, CL, R, nthr, active;
};
std::mutex cache_mutex;
Cached cache[64];
int cached = 0;

int plan_cached(Params& p, int* active) {
  std::lock_guard<std::mutex> lock(cache_mutex);
  for (int i = 0; i < (cached < 64 ? cached : 64); ++i) {
    const Cached& c = cache[i];
    if (c.product == p.product && c.rows == p.rows && c.C == p.C) {
      p.CL = c.CL;
      p.R = c.R;
      p.nthr = c.nthr;
      *active = c.active;
      return 0;
    }
  }
  const int e = plan_rows(p, active);
  if (e != 0) return e;
  cache[cached % 64] = {p.product, p.rows, p.C, p.CL, p.R, p.nthr, *active};
  ++cached;
  return 0;
}

bool width_ok(int C) { return C % 16 == 0 && C >= 16 && C <= 512; }

}  // namespace

// xh [T*rows, 2C] bf16 = [bf16(x_t) | h_{t-1}] from x [T, rows, C] f32 or
// bf16, h_seq [T, rows, C] bf16 and h0 [rows, C] f32.
extern "C" int rvt_lstm_bwd_pack(const void* x, int x_is_f32,
                                 const void* hseq, const void* h0, void* xh,
                                 int T, int rows, int C, void* stream) {
  if (T < 1 || rows < 1 || !width_ok(C)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long n8 = (long)T * rows * (2 * C / 8);
  const int threads = 256;
  const long want = (n8 + threads - 1) / threads;
  const unsigned blocks = (unsigned)(want < 65536 ? want : 65536);
  if (x_is_f32)
    pack_kernel<float><<<blocks, threads, 0, st>>>(
        (const float*)x, (const bf16*)hseq, (const float*)h0, (bf16*)xh, n8,
        rows, C);
  else
    pack_kernel<bf16><<<blocks, threads, 0, st>>>(
        (const bf16*)x, (const bf16*)hseq, (const float*)h0, (bf16*)xh, n8,
        rows, C);
  return (int)cudaGetLastError();
}

// The reverse scan over steps [t0, t1) of a window of T steps (product =
// 1), or the cell alone at one step (product = 0: t1 = t0 + 1, dh_out
// unused). mix [t1 - t0, rows, 4C] bf16 (the chunk's gates); w [2C, 4C]
// bf16; c_seq [T, rows, C] f32, c0 [rows, C]; dh_seq [T, rows, C] bf16;
// dh_in, dc_in the carries into step t1 - 1 and dh_out, dc_out those out
// of step t0, [rows, C] f32; dmix [T, rows, 4C] bf16 (steps [t0, t1)
// written); part [ceil(rows / 32), 4C] f32. C % 16 == 0, C <= 512.
extern "C" int rvt_lstm_bwd_scan(const void* mix, const void* w,
                                 const void* cseq, const void* c0,
                                 const void* dhseq, const void* dh_in,
                                 const void* dc_in, void* dmix, void* part,
                                 void* dh_out, void* dc_out, int t0, int t1,
                                 int rows, int C, int product, void* stream) {
  if (t0 < 0 || t1 <= t0 || rows < 1 || !width_ok(C) ||
      (!product && t1 != t0 + 1))
    return (int)cudaErrorInvalidValue;
  Params p = {(const bf16*)mix,   (const bf16*)w,      (const float*)cseq,
              (const float*)c0,   (const bf16*)dhseq,  (const float*)dh_in,
              (const float*)dc_in, (bf16*)dmix,        (float*)part,
              (float*)dh_out,     (float*)dc_out,      t0, t1, rows, C, 1,
              PT, 384, product != 0};
  int active = 0;
  const int e = plan_cached(p, &active);
  if (e != 0) return e;
  const Plan L(p.product != 0, C, p.CL, p.R, p.nthr);
  return dispatch(p, (int)L.bytes, (cudaStream_t)stream, nullptr);
}

// The launch plan of rvt_lstm_bwd_scan at this shape, for reports:
// plan[0..5] = cluster size, rows per cluster, clusters, clusters the card
// holds at once, threads per block, shared memory per block.
extern "C" int rvt_lstm_bwd_scan_plan(int rows, int C, int product,
                                      int* plan) {
  if (rows < 1 || !width_ok(C)) return (int)cudaErrorInvalidValue;
  Params p = {};
  p.rows = rows;
  p.C = C;
  p.product = product != 0;
  int active = 0;
  const int e = plan_cached(p, &active);
  if (e != 0) return e;
  plan[0] = p.CL;
  plan[1] = p.R;
  plan[2] = (rows + p.R - 1) / p.R;
  plan[3] = active;
  plan[4] = p.nthr;
  plan[5] = (int)Plan(p.product != 0, C, p.CL, p.R, p.nthr).bytes;
  return 0;
}

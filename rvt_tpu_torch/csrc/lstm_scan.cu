// K4 lstm_scan: the 1x1 ConvLSTM cell scanned over a whole window.
//
// Replaces the TPU kernels rvt_tpu/ops/fused_scan.py:_lstm_scan_kernel
// (and its stage-scan epilogue in _stage_scan_kernel) and, at T = 1,
// rvt_tpu/ops/fused_lstm.py:_lstm_kernel. Per pixel and step:
//   mix = bf16(bf16([x_t, bf16(h)] . W[2C, 4C]) + b)      f32 accumulation
//   f, i, o = bf16(sigmoid(mix[:3C]))    g = bf16(tanh(mix[3C:]))
//   c = f*c + i*g    h = o*tanh(c)        (f32; h fed back as bf16)
// Outputs h_seq [T, rows, C] bf16 per step and h_T, c_T [rows, C] f32;
// for training (rvt_tpu/ops/fused_train.py:_lstm_scan_fwd_train_kernel)
// also c_seq [T, rows, C] f32 when ``cseq`` is set: with h_seq these are
// the per-step carries the backward (lstm_scan_bwd.cu) reads.
//
// Bound on the H100: the operations (2*2C*4C per pixel and step), but
// only h.W_h depends on the previous step; at gen1 RVT-B stages 3-4 the
// 21 dependent steps over 2560 and 640 rows are latency, not work.
// Design, two modes chosen by the wrapper (ops/fused_scan.py):
//  * hoisted (C > 64): x.W_x for every step is one product over T*rows
//    rows before this kernel (K2's rt_f32 epilogue, f32 out, ``xw``);
//    here only h.W_h [C, 4C] runs in the time loop, and its sum is added
//    to xw in f32 before the one bf16 rounding (only the order of the f32
//    sums differs from the TPU kernel's single 2C-deep dot).
//  * fused (C <= 64): [x_t, h] . W in the loop, the whole W (<= 64 KiB)
//    in shared memory; x_{t+1} arrives by cp.async during step t.
// W^T (the wrapper's ``wt`` [2, 4C, C]: W_x^T, W_h^T) is loaded into
// shared memory once and stays there for all T steps. When it does not
// fit one block, the 4C columns are split over the CL blocks of a thread
// block cluster (CL up to 16, the non-portable size at C = 512): block
// ``rank`` owns all four gates of channels [rank*C/CL, (rank+1)*C/CL),
// so the gate math stays in the block; each step every block pushes its
// new bf16 h slice into every block's copy of h through distributed
// shared memory, between two cluster barriers. A cluster owns R rows
// (pixels of all lanes) for the whole window, R chosen by the launcher
// so that the clusters fill the card in whole waves. Products are
// mma.sync m16n8k16 from ldmatrix on 128-byte-swizzled tiles; one warp
// owns a unit of 32 rows x 8 channels x 4 gates at a time (its two 16-row
// tiles share each k-step's W fragments: the loop is bound by the bytes
// ldmatrix reads from shared memory, not by the tensor cores), so its
// accumulators hold f, i, o and g of the same cells. c stays in shared
// memory, or, where each warp owns one unit (gen1 stage 4), c and h_t stay
// in its registers, which leaves shared memory for 96 rows a cluster:
// one wave of seven 16-block clusters instead of two.
#include <mutex>

#include "warp_mma.cuh"

namespace {

constexpr int MAX_WARPS = 16;
constexpr int MAX_UNITS = 64;  // per block
constexpr int MAX_ONE = 16;    // warps of a block with one unit per warp
constexpr int SMEM_LIMIT = 232448;

// The gates through the SFU's exponential and reciprocal (ex2.approx,
// rcp.approx): errors of ~1e-7, far below the bf16 rounding after each;
// the accurate expf/tanhf made the cell math the cost of the narrow
// stages (55 M cells a window at gen1 stage 1).
__device__ __forceinline__ float sigmoid_fast(float v) {
  return __fdividef(1.f, 1.f + __expf(-v));
}
__device__ __forceinline__ float tanh_fast(float v) {
  return 1.f - __fdividef(2.f, 1.f + __expf(2.f * v));
}

struct Params {
  const void* x;    // fused: [T, rows, C] f32 or bf16
  const float* xw;  // hoisted: [T, rows, 4C] f32 (x . W_x)
  const bf16* wt;   // [2, 4C, C]: W_x^T, W_h^T
  const bf16* b;    // [4C]
  const float* h0;  // [rows, C]
  const float* c0;
  bf16* hseq;  // [T, rows, C]
  float* cseq;
  float* hT;  // [rows, C]
  float* cT;
  int T, rows, C, CL, R, units, nw, one;
};

// Shared-memory plan of one block (bytes), host and device.
struct Plan {
  int K, Cs, ldw, ldh, ldn, ldc, rp, xrow;
  size_t w_off, h_off, n_off, c_off, x_off, bytes;
  __host__ __device__ Plan(bool hoist, bool xf32, bool one, int C, int CL,
                          int R) {
    K = hoist ? C : 2 * C;
    Cs = C / CL;
    ldw = (K * 2 + 127) / 128 * 128;
    ldh = ldw;
    ldn = one ? 0 : Cs + 8;  // one unit per warp: h and c stay in registers
    ldc = one ? 0 : Cs + 4;
    rp = (R + 31) / 32 * 32;
    xrow = hoist ? 0 : C * (xf32 ? 4 : 2);
    w_off = 0;
    h_off = w_off + (size_t)4 * Cs * ldw;
    n_off = h_off + (size_t)rp * ldh;
    c_off = n_off + (size_t)rp * ldn * 2;
    x_off = c_off + (size_t)rp * ldc * 4;
    bytes = x_off + (size_t)rp * xrow;
  }
};

template <bool HOIST, bool XF32, bool ONE>
__global__ void __launch_bounds__(32 * (ONE ? MAX_ONE : MAX_WARPS))
lstm_scan_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = p.C, CL = p.CL, rows = p.rows;
  const Plan L(HOIST, XF32, ONE, C, CL, p.R);
  const int K = L.K, KX = HOIST ? 0 : C, Cs = L.Cs, cgs = Cs / 8;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;
  const int rank = CL > 1 ? (int)cluster_rank() : 0;
  const int row0 = (blockIdx.x / CL) * p.R;
  const int rv = min(p.R, rows - row0);  // rows of this cluster (>= 1)
  const int c0 = rank * Cs;
  unsigned char* Ws = smem + L.w_off;
  unsigned char* Hs = smem + L.h_off;
  bf16* Hn = reinterpret_cast<bf16*>(smem + L.n_off);
  float* Cst = reinterpret_cast<float*>(smem + L.c_off);  // c [rp][ldc]
  unsigned char* Xr = smem + L.x_off;
  const int kch = K / 8;  // 16-byte chunks per row of Ws / Hs

  // W^T slice: row n = gate*Cs + j is column gate*C + c0 + j of W, with
  // k < KX from W_x^T and the rest from W_h^T.
  for (int i = tid; i < 4 * Cs * kch; i += nthr) {
    const int n = i / kch, kc = i % kch;
    const int col = (n / Cs) * C + c0 + n % Cs;
    const int k = kc * 8;
    const bf16* src = k < KX ? p.wt + (long)col * C + k
                             : p.wt + ((long)4 * C + col) * C + (k - KX);
    *reinterpret_cast<uint4*>(Ws + swz(n, kc, L.ldw)) =
        *reinterpret_cast<const uint4*>(src);
  }
  // [x_0 | bf16(h0)] rows; zeros past the cluster's rows
  for (int i = tid; i < L.rp * kch; i += nthr) {
    const int r = i / kch, kc = i % kch, k = kc * 8;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = 0.f;
    if (r < rv) {
      const long grow = row0 + r;
      if (k >= KX) {
        const float4* s =
            reinterpret_cast<const float4*>(p.h0 + grow * C + (k - KX));
        const float4 a = s[0], bq = s[1];
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
        v[4] = bq.x; v[5] = bq.y; v[6] = bq.z; v[7] = bq.w;
      } else if (XF32) {
        const float4* s = reinterpret_cast<const float4*>(
            static_cast<const float*>(p.x) + grow * C + k);
        const float4 a = s[0], bq = s[1];
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
        v[4] = bq.x; v[5] = bq.y; v[6] = bq.z; v[7] = bq.w;
      } else {
        *reinterpret_cast<uint4*>(Hs + swz(r, kc, L.ldh)) =
            *reinterpret_cast<const uint4*>(
                static_cast<const bf16*>(p.x) + grow * C + k);
        continue;
      }
    }
    *reinterpret_cast<uint4*>(Hs + swz(r, kc, L.ldh)) = bf16x8(v);
  }

  // c of this block's channels; with ONE, of this warp's unit, and h_t
  // kept beside it. A thread's cells in a unit: m-tile m, position e =
  // (row g | g+8, channel 2qd | 2qd+1) of the 16 x 8 tile.
  auto cell_row = [&](int unit, int m, int e) {
    return (unit / cgs) * 32 + m * 16 + g + (e >> 1) * 8;
  };
  auto cell_ch = [&](int unit, int e) {
    return (unit % cgs) * 8 + 2 * qd + (e & 1);  // within the slice
  };
  // where a thread's x.W_x of gate 0 starts, rows past the cluster's read
  // its last row
  auto xw_at = [&](int unit, int t, int m, int h2) -> long {
    const int r = min(cell_row(unit, m, 2 * h2), rv - 1);
    return ((long)t * rows + row0 + r) * 4 * C + c0 + cell_ch(unit, 0);
  };
  // x.W_x of a unit at step t (zero without HOIST)
  float xw[2][4][4];
  auto load_xw = [&](int unit, int t) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 x2 = *reinterpret_cast<const float2*>(
              p.xw + xw_at(unit, t, m, h2) + q * C);
          xw[m][q][2 * h2] = x2.x;
          xw[m][q][2 * h2 + 1] = x2.y;
        }
  };
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) xw[m][q][e] = 0.f;
  float creg[2][4];
  uint32_t hkeep[2][2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = cell_row(warp, m, e);
      creg[m][e] = ONE && warp < p.units && r < rv
                       ? p.c0[(long)(row0 + r) * C + c0 + cell_ch(warp, e)]
                       : 0.f;
    }
  if (!ONE) {
    for (int i = tid; i < L.rp * Cs; i += nthr) {
      const int r = i / Cs, j = i % Cs;
      Cst[r * L.ldc + j] =
          r < rv ? p.c0[(long)(row0 + r) * C + c0 + j] : 0.f;
    }
  }
  if (CL > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }

  const uint32_t ws_base = smem_addr(Ws), hs_base = smem_addr(Hs);
  const int xrow_chunks = L.xrow / 16;
  for (int t = 0; t < p.T; ++t) {
    if (!HOIST && t + 1 < p.T) {  // x_{t+1}, raw, while step t runs
      const unsigned char* xs =
          static_cast<const unsigned char*>(p.x) +
          ((long)(t + 1) * rows + row0) * L.xrow;
      for (int i = tid; i < rv * xrow_chunks; i += nthr)
        cp_async16(smem_addr(Xr + (long)i * 16), xs + (long)i * 16);
      cp_async_commit();
    }
#pragma unroll 1
    for (int unit = warp; unit < p.units; unit += p.nw) {
      const int rb = (unit / cgs) * 32, cg = unit % cgs;
      float acc[2][4][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][q][e] = 0.f;
      if (HOIST) load_xw(unit, t);
      // the B fragments of a k-step serve both m-tiles
      const int brow = (lane >> 4) * Cs + cg * 8 + (lane & 7);
      const int arow = rb + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll 2
      for (int kk = 0; kk < K / 16; ++kk) {
        const int bc = 2 * kk + ((lane >> 3) & 1);
        uint32_t a0[4], a1[4], b0[4], b1[4];
        ldmatrix_x4(b0, ws_base + swz(brow, bc, L.ldw));
        ldmatrix_x4(b1, ws_base + swz(brow + 2 * Cs, bc, L.ldw));
        ldmatrix_x4(a0, hs_base + swz(arow, 2 * kk + (lane >> 4), L.ldh));
        ldmatrix_x4(a1,
                    hs_base + swz(arow + 16, 2 * kk + (lane >> 4), L.ldh));
        mma_bf16(acc[0][0], a0, b0);
        mma_bf16(acc[0][1], a0, b0 + 2);
        mma_bf16(acc[0][2], a0, b1);
        mma_bf16(acc[0][3], a0, b1 + 2);
        mma_bf16(acc[1][0], a1, b0);
        mma_bf16(acc[1][1], a1, b0 + 2);
        mma_bf16(acc[1][2], a1, b1);
        mma_bf16(acc[1][3], a1, b1 + 2);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        // the cell, for the four positions of this thread in m-tile m
        float hv[4], cv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = cell_ch(unit, e);
          float gate[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            gate[q] = round_bf16(round_bf16(xw[m][q][e] + acc[m][q][e]) +
                                 __bfloat162float(p.b[q * C + c0 + j]));
          const float f = round_bf16(sigmoid_fast(gate[0]));
          const float in = round_bf16(sigmoid_fast(gate[1]));
          const float o = round_bf16(sigmoid_fast(gate[2]));
          const float gg = round_bf16(tanh_fast(gate[3]));
          float* cs = Cst + cell_row(unit, m, e) * L.ldc + j;
          const float c = f * (ONE ? creg[m][e] : *cs) + in * gg;
          if (ONE)
            creg[m][e] = c;
          else
            *cs = c;
          cv[e] = c;
          hv[e] = o * tanh_fast(c);
        }
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int r = cell_row(unit, m, 2 * h2);
          const int j = cell_ch(unit, 0);
          const uint32_t hb = pack_bf16x2(hv[2 * h2], hv[2 * h2 + 1]);
          if (ONE)
            hkeep[m][h2] = hb;
          else
            *reinterpret_cast<uint32_t*>(Hn + r * L.ldn + j) = hb;
          if (r < rv) {
            const long o = ((long)t * rows + row0 + r) * C + c0 + j;
            *reinterpret_cast<uint32_t*>(p.hseq + o) = hb;
            if (p.cseq != nullptr)
              *reinterpret_cast<float2*>(p.cseq + o) =
                  make_float2(cv[2 * h2], cv[2 * h2 + 1]);
            if (t == p.T - 1) {
              const long s = (long)(row0 + r) * C + c0 + j;
              *reinterpret_cast<float2*>(p.hT + s) =
                  make_float2(hv[2 * h2], hv[2 * h2 + 1]);
              *reinterpret_cast<float2*>(p.cT + s) =
                  make_float2(cv[2 * h2], cv[2 * h2 + 1]);
            }
          }
        }
      }
    }
    if (t + 1 == p.T) break;  // uniform: every thread leaves together
    if (!HOIST) cp_async_wait_all();
    // every block has read h_{t-1}; Hn and x_{t+1} are complete
    if (CL > 1) {
      cluster_arrive();
      cluster_wait();
    } else {
      __syncthreads();
    }
    // h_t slice -> every block's h rows; x_{t+1} -> the x rows. With ONE
    // a quad gathers each row's eight channels from its four threads, and
    // each thread stores them to a quarter of the blocks.
    if (ONE && warp < p.units) {
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          uint4 v;
          v.x = __shfl_sync(0xffffffffu, hkeep[m][h2], (lane & ~3) | 0);
          v.y = __shfl_sync(0xffffffffu, hkeep[m][h2], (lane & ~3) | 1);
          v.z = __shfl_sync(0xffffffffu, hkeep[m][h2], (lane & ~3) | 2);
          v.w = __shfl_sync(0xffffffffu, hkeep[m][h2], (lane & ~3) | 3);
          const int r = cell_row(warp, m, 2 * h2);
          const uint32_t a =
              hs_base + swz(r, (KX + c0) / 8 + warp % cgs, L.ldh);
          for (int dst = qd; dst < CL; dst += 4) {
            if (CL > 1)
              st_cluster16(map_rank(a, dst), v);
            else
              *reinterpret_cast<uint4*>(Hs + (a - hs_base)) = v;
          }
        }
    }
    for (int i = tid; i < (ONE ? 0 : L.rp * cgs * CL); i += nthr) {
      const int dst = i % CL, rem = i / CL;
      const int r = rem / cgs, q = rem % cgs;
      const uint4 v = *reinterpret_cast<const uint4*>(Hn + r * L.ldn + q * 8);
      const uint32_t a = hs_base + swz(r, (KX + c0) / 8 + q, L.ldh);
      if (CL > 1)
        st_cluster16(map_rank(a, dst), v);
      else
        *reinterpret_cast<uint4*>(Hs + (a - hs_base)) = v;
    }
    if (!HOIST) {
      for (int i = tid; i < rv * (C / 8); i += nthr) {
        const int r = i / (C / 8), kc = i % (C / 8);
        uint4 out;
        if (XF32) {
          const float4* s =
              reinterpret_cast<const float4*>(Xr + (long)r * L.xrow) + 2 * kc;
          const float4 a = s[0], bq = s[1];
          const float v[8] = {a.x, a.y, a.z, a.w, bq.x, bq.y, bq.z, bq.w};
          out = bf16x8(v);
        } else {
          out = *reinterpret_cast<const uint4*>(Xr + (long)r * L.xrow +
                                                kc * 16);
        }
        *reinterpret_cast<uint4*>(Hs + swz(r, kc, L.ldh)) = out;
      }
    }
    if (CL > 1) {
      cluster_arrive();
      cluster_wait();
    } else {
      __syncthreads();
    }
  }
}

// Blocks of the CL-wide cluster split the 4C columns; the smallest CL
// whose W^T slice stays within 150 KB of shared memory.
int cluster_size(bool hoist, int C) {
  if (!hoist) return 1;
  for (int cl = 1; cl <= 16; cl *= 2) {
    if (C % (8 * cl) != 0) break;
    if (Plan(true, false, false, C, cl, 0).h_off <= 150 * 1024) return cl;
  }
  return 0;
}

template <bool HOIST, bool XF32, bool ONE>
int launch_mode(Params p, int smem, cudaStream_t st, int* active) {
  auto kern = lstm_scan_kernel<HOIST, XF32, ONE>;
  static bool attrs_set = false;  // the most any plan takes, once
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
  cfg.blockDim = dim3(32 * p.nw);
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
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      32 * p.nw, smem);
    *active = per_sm * sms;
    return (int)e;
  }
  e = cudaLaunchKernelEx(&cfg, kern, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int dispatch(Params p, bool hoist, bool xf32, int smem, cudaStream_t st,
             int* active) {
  if (hoist && p.one) return launch_mode<true, false, true>(p, smem, st,
                                                          active);
  if (hoist) return launch_mode<true, false, false>(p, smem, st, active);
  if (xf32) return launch_mode<false, true, false>(p, smem, st, active);
  return launch_mode<false, false, false>(p, smem, st, active);
}

// Rows, units and warps of a launch of mt 32-row tiles per cluster.
void set_rows(Params& p, int mt) {
  const int cgs = p.C / p.CL / 8;
  p.R = mt * 32;
  p.units = mt * cgs;
  p.nw = p.one ? p.units : (p.units < MAX_WARPS ? p.units : MAX_WARPS);
}

// The plan with (p.one) or without one unit per warp: the most 32-row
// tiles that shared memory and the unit limit allow, then as few as keep
// the number of waves of clusters the same. Returns the waves (0 when
// there is no such plan).
int plan_waves(Params& p, bool hoist, bool xf32, int* active) {
  const int C = p.C;
  const int cgs = C / p.CL / 8;
  const int mt_total = (p.rows + 31) / 32;
  int mt_max = (p.one ? MAX_ONE : MAX_UNITS) / cgs;
  auto bytes = [&](int mt) {
    return Plan(hoist, xf32, p.one, C, p.CL, mt * 32).bytes;
  };
  while (mt_max > 1 && bytes(mt_max) > SMEM_LIMIT) --mt_max;
  mt_max = mt_max < mt_total ? mt_max : mt_total;
  if (mt_max < 1 || bytes(mt_max) > SMEM_LIMIT) return 0;
  set_rows(p, mt_max);
  if (dispatch(p, hoist, xf32, (int)bytes(mt_max), nullptr, active) != 0 ||
      *active < 1)
    return 0;
  const int waves = (mt_total + *active * mt_max - 1) / (*active * mt_max);
  set_rows(p, (mt_total + *active * waves - 1) / (*active * waves));
  return waves;
}

// Cluster size, rows per cluster and warps of one launch (into p): one
// unit per warp where that takes fewer waves (h and c in registers leave
// shared memory for more rows: gen1 stage 4 in one wave of 16-block
// clusters instead of two), else several units per warp.
int plan_rows(Params& p, bool hoist, bool xf32, int* active) {
  p.CL = cluster_size(hoist, p.C);
  if (p.CL == 0) return (int)cudaErrorInvalidValue;
  p.one = 0;
  const int waves = plan_waves(p, hoist, xf32, active);
  if (waves == 0) return (int)cudaErrorInvalidConfiguration;
  if (hoist && waves > 1) {
    Params q = p;
    int act = 0;
    q.one = 1;
    const int w1 = plan_waves(q, hoist, xf32, &act);
    if (w1 > 0 && w1 < waves) {
      p = q;
      *active = act;
    }
  }
  return 0;
}

// Plans by shape (T does not enter a plan): the occupancy query costs
// more host time than a T = 1 launch itself.
struct Cached {
  bool hoist, xf32;
  int rows, C, CL, R, units, nw, one, active;
};
std::mutex cache_mutex;
Cached cache[64];
int cached = 0;

int plan_cached(Params& p, bool hoist, bool xf32, int* active) {
  std::lock_guard<std::mutex> lock(cache_mutex);
  for (int i = 0; i < (cached < 64 ? cached : 64); ++i) {
    const Cached& c = cache[i];
    if (c.hoist == hoist && c.xf32 == xf32 && c.rows == p.rows &&
        c.C == p.C) {
      p.CL = c.CL;
      p.R = c.R;
      p.units = c.units;
      p.nw = c.nw;
      p.one = c.one;
      *active = c.active;
      return 0;
    }
  }
  const int e = plan_rows(p, hoist, xf32, active);
  if (e != 0) return e;
  cache[cached % 64] = {hoist,  xf32, p.rows, p.C,    p.CL,
                        p.R,    p.units, p.nw, p.one, *active};
  ++cached;
  return 0;
}

}  // namespace

extern "C" int rvt_lstm_scan(const void* x, int x_is_f32, const void* xw,
                             const void* wt, const void* b, const void* h0,
                             const void* c0, void* hseq, void* cseq, void* hT,
                             void* cT, int T, int rows, int C, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool hoist = xw != nullptr;
  if (T < 1 || rows < 1 || C % 16 != 0 || C > 512 || (!hoist && C > 64) ||
      (!hoist && x == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p = {x, (const float*)xw, (const bf16*)wt, (const bf16*)b,
              (const float*)h0, (const float*)c0, (bf16*)hseq, (float*)cseq,
              (float*)hT, (float*)cT, T, rows, C, 1, 16, 0, 1};
  int active = 0;
  const int e = plan_cached(p, hoist, x_is_f32 != 0, &active);
  if (e != 0) return e;
  const Plan L(hoist, x_is_f32 != 0, p.one, C, p.CL, p.R);
  return dispatch(p, hoist, x_is_f32 != 0, (int)L.bytes, st, nullptr);
}

// The launch plan of rvt_lstm_scan at this shape, for reports: plan[0..6]
// = cluster size, rows per cluster, clusters, clusters the card holds at
// once, warps per block, shared memory per block, one unit per warp.
extern "C" int rvt_lstm_scan_plan(int x_is_f32, int hoist, int T, int rows,
                                  int C, int* plan) {
  if (T < 1 || rows < 1 || C % 16 != 0 || C > 512 || (!hoist && C > 64))
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.T = T;
  p.rows = rows;
  p.C = C;
  int active = 0;
  const int e = plan_cached(p, hoist != 0, x_is_f32 != 0, &active);
  if (e != 0) return e;
  plan[0] = p.CL;
  plan[1] = p.R;
  plan[2] = (rows + p.R - 1) / p.R;
  plan[3] = active;
  plan[4] = p.nw;
  plan[5] = (int)Plan(hoist != 0, x_is_f32 != 0, p.one, C, p.CL, p.R).bytes;
  plan[6] = p.one;
  return 0;
}

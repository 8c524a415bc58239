// Warp-level tensor-core helpers of K3, K4, K7 and K8: mma.sync m16n8k16
// (bf16 in, f32 sums), ldmatrix from shared memory, cp.async, the 128-byte
// XOR swizzle of 16-byte chunks, the thread-block-cluster primitives
// (distributed shared memory stores, the split cluster barrier), and the
// softmax K3 and K7 share.
#pragma once

#include "common.cuh"

// D += A . B on one m16n8k16 tile; a[4], b[2] as ldmatrix gives them.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Two floats as one bf16x2 register (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Byte offset of 16-byte chunk ``chunk`` of row ``row`` in a tile whose
// rows are ``ld`` bytes (a multiple of 128): chunks are XOR-swizzled by
// the row's low three bits, so eight rows' chunk c land in eight banks.
__device__ __forceinline__ uint32_t swz(int row, int chunk, int ld) {
  return (uint32_t)(row * ld + ((chunk ^ (row & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Thread-block clusters. Every thread of every block of the cluster runs
// each arrive and each wait, in the same order: no thread leaves early.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The address of the same shared-memory location in block ``rank``.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_cluster16(uint32_t addr, uint4 v) {
  asm volatile(
      "st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
      : "memory");
}
__device__ __forceinline__ void st_cluster_f32x2(uint32_t addr, float2 v) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr),
               "f"(v.x), "f"(v.y)
               : "memory");
}

__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// Eight values as eight bf16 in one 16-byte word.
__device__ __forceinline__ uint4 bf16x8(const float* v) {
  uint4 r;
  r.x = pack_bf16x2(v[0], v[1]);
  r.y = pack_bf16x2(v[2], v[3]);
  r.z = pack_bf16x2(v[4], v[5]);
  r.w = pack_bf16x2(v[6], v[7]);
  return r;
}

// The softmax of K3 and K7 over the keys of a warp's 16 query rows: s
// holds q . k^T (unscaled) of the n8 key tiles j < nt in the m16n8k16
// accumulator layout (row g: e = 0, 1; row g + 8: e = 2, 3); keys >= n
// are masked to -inf. On return s holds the probabilities, divided in f32
// and not yet rounded (the caller rounds them to bf16): K7 recomputes
// exactly the probabilities K3 used. The whole row is in registers, so
// the softmax is two-pass, not online.
template <int NT>
__device__ __forceinline__ void softmax_rows(float (&s)[NT][4], int nt,
                                             int n, float scale) {
  const int qd = threadIdx.x & 3;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j >= nt) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = j * 8 + 2 * qd + (e & 1) < n;
      s[j][e] = ok ? s[j][e] * scale : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 1));
    mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 2));
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j >= nt) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = __expf(s[j][e] - mx[e >> 1]);  // pad keys: 0
      s[j][e] = v;
      sum[e >> 1] += v;
    }
  }
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    sum[h2] += __shfl_xor_sync(0xffffffffu, sum[h2], 1);
    sum[h2] += __shfl_xor_sync(0xffffffffu, sum[h2], 2);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j >= nt) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = __fdividef(s[j][e], sum[e >> 1]);
  }
}

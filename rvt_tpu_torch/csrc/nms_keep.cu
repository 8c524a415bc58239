// nms_keep: the greedy NMS keep mask of score-sorted boxes, one block a
// frame, with no read of the device from the host.
//
// Not a TPU kernel: the JAX package's NMS is XLA operations inside its
// jitted step (rvt_tpu/ops/boxes.py:_greedy_nms_mask, a Jacobi fixpoint
// in a lax.while_loop, and postprocess's lax.cond between the 512-candidate
// and the all-anchor set). The port's plain version is the same Jacobi
// loop, which reads its convergence flag on the host every round; this
// kernel takes its place on the card so that the eval, raw and train
// steps can be captured as CUDA graphs.
//
// Input: boxes [B, K, 4] f32 xyxy, sorted by descending score and offset
// by class (torchvision's batched_nms trick); valid [B, K] bool. Output:
// keep [B, K] bool, the unique fixpoint of
//   keep[i] = valid[i] and not any(j < i: iou(j, i) > thr and keep[j]),
// which the greedy sweep reaches in one pass: box i is final once every
// kept box before it has suppressed its successors. Where count is not
// null, count [B] int32 gets the number of each frame's valid boxes, the
// candidates NMS saw (read by the port's tracing).
//
// Design: one block a frame. The frame's alive flags sit in shared memory
// (K bytes); the block first finds the end of the valid entries (after
// the sort they are a prefix, since -inf scores sort last) and works only
// up to there. For each box i in order, every thread reads alive[i] (the
// same value in all of them: it was last written before the previous
// barrier); if it is alive, the threads test the later boxes j in
// parallel and clear the ones it suppresses, then meet at a barrier. A
// suppressed box costs no barrier. Bound on the H100: neither bytes nor
// operations but the chain of barriers, one a kept box.
//
// The IoU is pairwise_iou_xyxy's f32 operations in its order, each
// rounded on its own (__fadd_rn and friends: nvcc would otherwise contract
// a*b - c into an FMA, and one ulp flips a box at the threshold), with
// torch.maximum's and torch.clamp's NaN propagation.
#include "common.cuh"

namespace {

constexpr int THREADS = 512;

__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// iou(a, b) with a the earlier box: ``pairwise_iou_xyxy(boxes, boxes)[j, i]``
__device__ __forceinline__ float iou_xyxy(float4 a, float4 b) {
  const float w = max_nan(__fsub_rn(min_nan(a.z, b.z), max_nan(a.x, b.x)), 0.f);
  const float h = max_nan(__fsub_rn(min_nan(a.w, b.w), max_nan(a.y, b.y)), 0.f);
  const float inter = __fmul_rn(w, h);
  const float area_a = __fmul_rn(__fsub_rn(a.z, a.x), __fsub_rn(a.w, a.y));
  const float area_b = __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, uni > 0.f ? uni : 1.f);
}

__global__ void __launch_bounds__(THREADS)
nms_keep_kernel(const float4* __restrict__ boxes,
                const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep,
                int* __restrict__ count, int K, float thr) {
  extern __shared__ uint8_t alive[];  // [K]
  __shared__ int n_s, c_s;
  const long base = (long)blockIdx.x * K;
  const float4* bx = boxes + base;
  if (threadIdx.x == 0) n_s = c_s = 0;
  __syncthreads();
  int last = 0, c = 0;
  for (int j = threadIdx.x; j < K; j += THREADS) {
    const uint8_t v = valid[base + j] != 0;
    alive[j] = v;
    if (v) last = j + 1;
    c += v;
  }
  atomicMax(&n_s, last);
  if (count != nullptr) atomicAdd(&c_s, c);
  __syncthreads();
  const int n = n_s;
  if (count != nullptr && threadIdx.x == 0) count[blockIdx.x] = c_s;
  for (int i = 0; i < n; ++i) {
    if (!alive[i]) continue;  // uniform across the block: no barrier
    const float4 a = __ldg(bx + i);
    for (int j = i + 1 + threadIdx.x; j < n; j += THREADS)
      if (alive[j] && iou_xyxy(a, __ldg(bx + j)) > thr) alive[j] = 0;
    __syncthreads();
  }
  for (int j = threadIdx.x; j < K; j += THREADS) keep[base + j] = alive[j];
}

}  // namespace

// K <= ops/boxes.py:NMS_MAX_BOXES: the alive flags stay within the 48 KB
// of shared memory a block may take without cudaFuncSetAttribute.
extern "C" int rvt_nms_keep(const void* boxes, const void* valid, void* keep,
                            void* count, int B, int K, float thr,
                            void* stream) {
  if (B > 0 && K > 0)
    nms_keep_kernel<<<B, THREADS, K, (cudaStream_t)stream>>>(
        (const float4*)boxes, (const uint8_t*)valid, (uint8_t*)keep,
        (int*)count, K, thr);
  return (int)cudaGetLastError();
}

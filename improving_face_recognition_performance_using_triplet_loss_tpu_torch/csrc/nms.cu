// Kernel B5: exact greedy NMS keep mask, Union or Min, for S box sets in
// one launch.
//
// Replaces: ops/pallas/nms_kernel.py::nms_mask_pallas_batched of the JAX
// package (and nms_mask_pallas, which wraps it).
//
// Semantics (those of ops/boxes.py::nms_mask_jax there): boxes are visited in
// descending score order with ties broken by the highest original row (the
// caller sorts and passes the sorted rows plus their original indices); a
// row with a non-finite score neither keeps nor suppresses; box j is
// suppressed when a kept earlier box i has o(i, j) > threshold with a
// finite o, where o is the IoU ("Union") or inter / min-area ("Min") with
// the +1 pixel convention. The mask is written in the original row order.
//
// What bounds it on the H100: neither bytes nor operations. A set moves
// 29 B per box (box, sorted index, mask byte) and does at most n^2/2 IoUs
// (0.5 M for the 1,024-box cross-scale set); what bounds it is the chain
// of greedy decisions, one after another, each a barrier of the CTA.
//
// What the design does about it: one CTA per set, so the S sets of a call
// (the pyramid scales of every stream) run side by side on the SMs. The
// sorted boxes and their areas live in shared memory (1,024 rows x 5 f32
// = 20 KB) with one alive byte per row. The sweep walks the sorted order;
// a row that is already suppressed costs one shared-memory read and no
// barrier, and only a kept row spends a barrier, after its threads have
// marked the later rows it suppresses. The TPU kernel's block Gauss-Seidel
// fixed point was the TPU's way to the same mask; it is not needed here.
//
// Exactness: compile with --fmad=false (ops/cuda/_build.py) and spell the
// arithmetic with the _rn intrinsics, so no FMA contraction moves an IoU
// that lies on the threshold; max/min propagate NaN as jnp.maximum does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__global__ void nms_sorted_kernel(const float* __restrict__ boxes,
                                  const int64_t* __restrict__ order,
                                  bool* __restrict__ keep, int n,
                                  float threshold, int min_method) {
  extern __shared__ float smem[];
  float* x1 = smem;
  float* y1 = x1 + n;
  float* x2 = y1 + n;
  float* y2 = x2 + n;
  float* area = y2 + n;
  unsigned char* alive = reinterpret_cast<unsigned char*>(area + n);

  const size_t set = blockIdx.x;
  const float* b = boxes + set * (size_t)n * 5;
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    const float bx1 = b[r * 5 + 0], by1 = b[r * 5 + 1];
    const float bx2 = b[r * 5 + 2], by2 = b[r * 5 + 3];
    x1[r] = bx1;
    y1[r] = by1;
    x2[r] = bx2;
    y2[r] = by2;
    area[r] = __fmul_rn(__fadd_rn(__fsub_rn(bx2, bx1), 1.0f),
                        __fadd_rn(__fsub_rn(by2, by1), 1.0f));
    alive[r] = isfinite(b[r * 5 + 4]) ? 1 : 0;
  }
  __syncthreads();

  for (int i = 0; i < n; ++i) {
    // alive[i] is final here: rows before i wrote it before their barrier
    if (!alive[i]) continue;
    const float ix1 = x1[i], iy1 = y1[i], ix2 = x2[i], iy2 = y2[i];
    const float ia = area[i];
    for (int j = i + 1 + threadIdx.x; j < n; j += blockDim.x) {
      if (!alive[j]) continue;
      const float w = max_nan(
          0.0f, __fadd_rn(__fsub_rn(min_nan(ix2, x2[j]), max_nan(ix1, x1[j])),
                          1.0f));
      const float h = max_nan(
          0.0f, __fadd_rn(__fsub_rn(min_nan(iy2, y2[j]), max_nan(iy1, y1[j])),
                          1.0f));
      const float inter = __fmul_rn(w, h);
      const float denom = min_method
                              ? min_nan(ia, area[j])
                              : __fsub_rn(__fadd_rn(ia, area[j]), inter);
      const float o = __fdiv_rn(inter, denom);
      if (o > threshold && isfinite(o)) alive[j] = 0;
    }
    __syncthreads();
  }

  const int64_t* ord = order + set * (size_t)n;
  bool* k = keep + set * (size_t)n;
  for (int r = threadIdx.x; r < n; r += blockDim.x) k[ord[r]] = alive[r] != 0;
}

}  // namespace

extern "C" int nms_smem_bytes(int n) {
  return n * 5 * (int)sizeof(float) + n;
}

// boxes [S, n, 5] f32 sorted per set, order [S, n] int64 original rows,
// keep [S, n] bool (written in original row order).
extern "C" int nms_keep_mask(const void* boxes, const void* order, void* keep,
                             int sets, int n, float threshold, int min_method,
                             void* stream) {
  if (sets <= 0 || n <= 0) return 0;
  const int smem = nms_smem_bytes(n);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        nms_sorted_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  int threads = ((n + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  nms_sorted_kernel<<<sets, threads, smem, (cudaStream_t)stream>>>(
      (const float*)boxes, (const int64_t*)order, (bool*)keep, n, threshold,
      min_method);
  return (int)cudaGetLastError();
}

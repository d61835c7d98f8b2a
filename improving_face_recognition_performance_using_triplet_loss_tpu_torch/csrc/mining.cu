// Kernel B1: fused squared-L2 distances + semi-hard negative mining, one
// pool index per anchor, without the [B, N] distance matrix in memory.
//
// Replaces: ops/pallas/triplet_kernel.py::semi_hard_mining_pallas of the JAX
// package (its _mining_kernel).
//
// Semantics (those of ops/mining.py::mine_semi_hard_negative over
// ops/distances.py::pairwise_sq_l2 there): with
//   sq[i, j] = max(|a_i|^2 + |p_j|^2 - 2 a_i.p_j, 0)
// anchor i takes the first j minimising sq[i, j] among the j with
// label_j != label_i and sq[i, j] > pos_sq[i]; when there is none, the first
// j maximising sq[i, j] among all label_j != label_i; when the pool holds no
// negative at all, 0. Inputs are finite.
//
// What bounds it on the H100: operations. At the head-training shape
// (B = 16384 anchors, N = 32768 pool rows, D = 128) the dot products are
// 2 B N D = 1.4e11 float32 operations against ~24 MB of input, far above the
// card's float32 ridge. The dots run at full float32 on the CUDA cores (no
// TF32, no tensor cores): the JAX kernel's dot runs at HIGHEST precision and
// a rounder product flips near-tie choices.
//
// What the design does about it: a tiled float32 GEMM with an arg-reduction
// epilogue. A CTA of 256 threads holds 128 anchors and streams the pool
// through shared memory in tiles of 128 rows and 16 depth; each thread keeps
// an 8x8 register tile of dot products (64 FMAs per 16 shared-memory reads)
// and, per anchor it owns, running (semi_d, semi_i, far_d, far_i) values.
// The pool is cut into `splits` ranges on gridDim.y so that the grid fills
// the card; a second small kernel merges the ranges. Every merge, across
// threads and across ranges, compares (value, index) pairs -- the smaller
// value wins, on equal values the smaller index -- so first-index tie
// breaking does not depend on the merge order. Row norms come from a first
// small kernel. Shapes are arbitrary: ragged tiles are masked.
//
// Exactness: the epilogue forms (a2 + p2) - 2 ap with the _rn intrinsics,
// in the plain version's order, so no FMA contraction moves a distance;
// on inputs whose products are exact (small integers) the kernel's
// distances equal the plain version's and so do its indices.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TB = 128;                 // anchors per CTA
constexpr int TN = 128;                 // pool rows per tile
constexpr int BK = 16;                  // depth per shared-memory stage
constexpr int TX = 16, TY = 16;         // thread grid of a CTA
constexpr int THREADS = TX * TY;
constexpr int RM = TB / TY;             // anchors per thread
constexpr int RN = TN / TX;             // pool rows per thread per tile
constexpr int NONE = INT_MAX;           // "no candidate yet"

// (d, i) beats (bd, bi) for a minimum: smaller value, then smaller index
__device__ __forceinline__ bool better_min(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

__device__ __forceinline__ bool better_max(float d, int i, float bd, int bi) {
  return d > bd || (d == bd && i < bi);
}

// one warp per row: out[r] = sum_k x[r, k]^2
__global__ void row_sq_norms(const float* __restrict__ x, int rows, int d,
                             float* __restrict__ out) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform across the warp
  const float* r = x + (size_t)row * d;
  float s = 0.0f;
  for (int k = lane; k < d; k += 32) s = fmaf(r[k], r[k], s);
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) out[row] = s;
}

__global__ void __launch_bounds__(THREADS, 2)
mining_partial(const float* __restrict__ anc, const float* __restrict__ pool,
               const float* __restrict__ a2g, const float* __restrict__ p2g,
               const float* __restrict__ pos_sq,
               const int* __restrict__ anc_lab,
               const int* __restrict__ pool_lab, int B, int N, int D,
               int tiles_per_split, float* __restrict__ semi_d_out,
               int* __restrict__ semi_i_out, float* __restrict__ far_d_out,
               int* __restrict__ far_i_out) {
  __shared__ float As[BK][TB + 1];  // +1: conflict-free transposed stores
  __shared__ float Ps[BK][TN + 1];
  __shared__ float s_a2[TB], s_pos[TB];
  __shared__ int s_alab[TB];
  __shared__ float s_p2[TN];
  __shared__ int s_plab[TN];

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int i0 = blockIdx.x * TB;
  const int n_tiles = (N + TN - 1) / TN;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  for (int r = tid; r < TB; r += THREADS) {
    const int i = i0 + r;
    const bool ok = i < B;
    s_a2[r] = ok ? a2g[i] : 0.0f;
    s_pos[r] = ok ? pos_sq[i] : 0.0f;
    s_alab[r] = ok ? anc_lab[i] : 0;
  }

  float semi_d[RM], far_d[RM];
  int semi_i[RM], far_i[RM];
#pragma unroll
  for (int m = 0; m < RM; ++m) {
    semi_d[m] = INFINITY;
    semi_i[m] = NONE;
    far_d[m] = -INFINITY;
    far_i[m] = NONE;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int j0 = t * TN;
    float acc[RM][RN];
#pragma unroll
    for (int m = 0; m < RM; ++m)
#pragma unroll
      for (int n = 0; n < RN; ++n) acc[m][n] = 0.0f;

    for (int k0 = 0; k0 < D; k0 += BK) {
      // the previous stage (and the previous tile's epilogue) is done
      __syncthreads();
      for (int e = tid; e < TB * BK; e += THREADS) {
        const int r = e / BK, c = e % BK;
        const int i = i0 + r, k = k0 + c;
        As[c][r] = (i < B && k < D) ? anc[(size_t)i * D + k] : 0.0f;
      }
      for (int e = tid; e < TN * BK; e += THREADS) {
        const int r = e / BK, c = e % BK;
        const int j = j0 + r, k = k0 + c;
        Ps[c][r] = (j < N && k < D) ? pool[(size_t)j * D + k] : 0.0f;
      }
      if (k0 == 0) {
        for (int r = tid; r < TN; r += THREADS) {
          const int j = j0 + r;
          s_p2[r] = j < N ? p2g[j] : 0.0f;
          s_plab[r] = j < N ? pool_lab[j] : 0;
        }
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float a[RM], p[RN];
#pragma unroll
        for (int m = 0; m < RM; ++m) a[m] = As[k][ty + TY * m];
#pragma unroll
        for (int n = 0; n < RN; ++n) p[n] = Ps[k][tx + TX * n];
#pragma unroll
        for (int m = 0; m < RM; ++m)
#pragma unroll
          for (int n = 0; n < RN; ++n) acc[m][n] = fmaf(a[m], p[n], acc[m][n]);
      }
    }

    // epilogue: a thread visits its pool rows in increasing j, so strict
    // comparisons keep the first index within the thread
#pragma unroll
    for (int m = 0; m < RM; ++m) {
      const int r = ty + TY * m;
      const float a2 = s_a2[r], ps = s_pos[r];
      const int al = s_alab[r];
#pragma unroll
      for (int n = 0; n < RN; ++n) {
        const int jl = tx + TX * n;
        const int j = j0 + jl;
        if (j >= N || s_plab[jl] == al) continue;
        const float d = fmaxf(
            __fsub_rn(__fadd_rn(a2, s_p2[jl]), __fmul_rn(2.0f, acc[m][n])),
            0.0f);
        if (d > ps && d < semi_d[m]) {
          semi_d[m] = d;
          semi_i[m] = j;
        }
        if (d > far_d[m]) {
          far_d[m] = d;
          far_i[m] = j;
        }
      }
    }
  }

  // merge the TX threads that share each anchor (lanes of one half-warp)
#pragma unroll
  for (int m = 0; m < RM; ++m) {
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1) {
      const float sd = __shfl_xor_sync(0xffffffffu, semi_d[m], off);
      const int si = __shfl_xor_sync(0xffffffffu, semi_i[m], off);
      const float fd = __shfl_xor_sync(0xffffffffu, far_d[m], off);
      const int fi = __shfl_xor_sync(0xffffffffu, far_i[m], off);
      if (better_min(sd, si, semi_d[m], semi_i[m])) {
        semi_d[m] = sd;
        semi_i[m] = si;
      }
      if (better_max(fd, fi, far_d[m], far_i[m])) {
        far_d[m] = fd;
        far_i[m] = fi;
      }
    }
    const int i = i0 + ty + TY * m;
    if (tx == 0 && i < B) {
      const size_t o = (size_t)blockIdx.y * B + i;
      semi_d_out[o] = semi_d[m];
      semi_i_out[o] = semi_i[m];
      far_d_out[o] = far_d[m];
      far_i_out[o] = far_i[m];
    }
  }
}

// one thread per anchor: merge the pool ranges, then pick
__global__ void mining_merge(const float* __restrict__ semi_d,
                             const int* __restrict__ semi_i,
                             const float* __restrict__ far_d,
                             const int* __restrict__ far_i, int B, int splits,
                             int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  float sd = INFINITY, fd = -INFINITY;
  int si = NONE, fi = NONE;
  for (int s = 0; s < splits; ++s) {
    const size_t o = (size_t)s * B + i;
    if (better_min(semi_d[o], semi_i[o], sd, si)) {
      sd = semi_d[o];
      si = semi_i[o];
    }
    if (better_max(far_d[o], far_i[o], fd, fi)) {
      fd = far_d[o];
      fi = far_i[o];
    }
  }
  out[i] = si != NONE ? si : (fi != NONE ? fi : 0);
}

int n_tiles(int n) { return (n + TN - 1) / TN; }

}  // namespace

// Pool ranges per call: enough CTAs for ~4 waves at 2 CTAs per SM.
extern "C" int mining_splits(int B, int N) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int row_tiles = (B + TB - 1) / TB;
  int splits = (8 * sms + row_tiles - 1) / row_tiles;
  const int tiles = n_tiles(N);
  if (splits > tiles) splits = tiles;
  if (splits < 1) splits = 1;
  // drop ranges that would be empty after rounding up the range length
  const int per = (tiles + splits - 1) / splits;
  return (tiles + per - 1) / per;
}

// 4-byte words of scratch the caller provides: norms, then the partials
extern "C" long long mining_scratch_words(int B, int N, int splits) {
  return (long long)B + N + 4LL * splits * B;
}

// anc [B, D] f32, pool [N, D] f32, pos_sq [B] f32, anc_lab [B] int32,
// pool_lab [N] int32, all contiguous on one device; out [B] int32.
extern "C" int semi_hard_mining(const void* anc, const void* pool,
                                const void* pos_sq, const void* anc_lab,
                                const void* pool_lab, int B, int N, int D,
                                int splits, void* scratch, void* out,
                                void* stream) {
  if (B <= 0) return 0;
  if (N <= 0 || D <= 0 || splits <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* a2 = (float*)scratch;
  float* p2 = a2 + B;
  float* semi_d = p2 + N;
  int* semi_i = (int*)(semi_d + (size_t)splits * B);
  float* far_d = (float*)(semi_i + (size_t)splits * B);
  int* far_i = (int*)(far_d + (size_t)splits * B);

  const int warps_per_block = 8;
  row_sq_norms<<<(B + warps_per_block - 1) / warps_per_block,
                 32 * warps_per_block, 0, st>>>((const float*)anc, B, D, a2);
  row_sq_norms<<<(N + warps_per_block - 1) / warps_per_block,
                 32 * warps_per_block, 0, st>>>((const float*)pool, N, D, p2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const int tiles = n_tiles(N);
  const int per = (tiles + splits - 1) / splits;
  dim3 grid((B + TB - 1) / TB, splits);
  mining_partial<<<grid, THREADS, 0, st>>>(
      (const float*)anc, (const float*)pool, a2, p2, (const float*)pos_sq,
      (const int*)anc_lab, (const int*)pool_lab, B, N, D, per, semi_d, semi_i,
      far_d, far_i);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  mining_merge<<<(B + 255) / 256, 256, 0, st>>>(semi_d, semi_i, far_d, far_i,
                                                B, splits, (int*)out);
  return (int)cudaGetLastError();
}

// Kernel B5: exact greedy NMS keep mask, Union or Min, for S box sets in
// one launch: the sort, an all-pairs suppression bitmask and a one-warp
// sweep, all in the kernel.
//
// Replaces: ops/pallas/nms_kernel.py::nms_mask_pallas_batched of the JAX
// package (and nms_mask_pallas, which wraps it).
//
// Semantics (those of ops/boxes.py::nms_mask_jax there): boxes are visited in
// descending score order with ties broken by the highest original row; a
// row with a non-finite score neither keeps nor suppresses; box j is
// suppressed when a kept earlier box i has o(i, j) > threshold with a
// finite o, where o is the IoU ("Union") or inter / min-area ("Min") with
// the +1 pixel convention. The mask is written in the original row order.
//
// What bounds it on the H100: neither bytes nor operations. A set moves
// 21 B per box and the greedy sweep needs at most n^2/2 IoUs (0.5 M for
// the 1,024-box cross-scale set). What bounds it is the chain of greedy
// decisions, one after another, and the sort in front of them.
//
// What the design does about it:
// - Sort in the kernel. Each CTA builds one 64-bit key per row, (the
//   score's order bits, descending) << 32 | (n - 1 - row), with -0.0 made
//   +0.0 (torch.sort sees the two as equal) and every non-finite score
//   given the largest high word, and sorts the keys with a bitonic sort in
//   shared memory, its steps across fewer than 32 rows in registers with
//   warp shuffles. The keys are unique, so the order is that of
//   torch.sort(stable) on the finite rows; the non-finite rows go last.
// - All-pairs bitmask, built in parallel: warp task (i, w) sets bit j of
//   mask word w of sorted row i, for the 64 rows j of word w, when j > i
//   and o(i, j) > threshold with o finite (two ballots of 32 lanes). Only
//   rows with a finite score and words w >= i / 64 are built: the sweep
//   reads nothing else.
// - The sweep in one warp, no CTA barrier: lane k holds word k (k + 32,
//   ... with more than 32 words) of the removed set. Per 64-row block b,
//   the lanes hold the block's 64 own words (two a lane) and iterate keep
//   = cand & ~OR(own words of the kept rows), from keep = cand, with two
//   warp reductions (__reduce_or_sync) a step, until keep stops changing:
//   the greedy decisions are the unique fixed point, reached in the
//   block's longest suppression chain + 1 steps (2-4 on the path's sets,
//   65 on the adversarial chain). Then every later word k is the OR of the
//   kept rows' word k, reduced across the warp into lane k.
// - A thread-block cluster of up to 4 CTAs per set for the few large sets
//   (the cross-scale call has 16 sets for 132 SMs): every CTA of the
//   cluster sorts the set itself, builds the mask rows i = rank (mod
//   cluster size) and stores them into the leader's shared memory through
//   distributed shared memory; the leader sweeps.
// - Sizes: up to ~1,200 rows the mask lives in shared memory (128 KB at
//   n = 1,024). Above, a second mode keeps the sorted boxes, the order and
//   the mask in a global scratch buffer that the wrapper allocates; the
//   sweep warp stages each block's mask rows into shared memory with
//   cp.async, one block ahead (up to 16,384 rows; the sort's keys and the
//   two staging buffers share their shared memory).
//
// Exactness: compile with --fmad=false (ops/cuda/_build.py) and spell the
// arithmetic with the _rn intrinsics, so no FMA contraction moves an IoU
// that lies on the threshold; max/min propagate NaN as jnp.maximum does.
// An intersection of exactly 0 with a threshold >= 0 skips the division:
// o is then +-0 or NaN, which never suppresses.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

typedef unsigned long long u64;

// threads a CTA, for every set size: at 128 the mask build of a
// 128-row set is latency-bound on 4 warps
constexpr int THREADS = 1024;
constexpr int SMEM_LIMIT = 232448;  // 227 KB, what one CTA may use
constexpr int GM_SLOTS = 8;         // sweep words per lane, global mode
constexpr int MAX_CLUSTER = 4;  // clusters of 8 measured slower: not all
                                // of them fit the GPCs at once
constexpr int MAX_DEVICES = 64;

struct Layout {
  int P, W, WS;
  bool global;
  int smem;
};

__host__ __device__ inline int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

__host__ __device__ inline int align16(int b) { return (b + 15) & ~15; }

// Shared memory, in this order. Shared-memory mode: mask [n][WS] u64, keys
// [P] u64 (padded to 16 bytes), boxes [n] float4, area [n] f32, valid [W]
// u64, keep [W] u64. Global mode: keys [P] u64 (after the sort: two staging buffers [64][WS]
// u64), valid [W] u64, keep [W] u64.
__host__ __device__ inline int smem_bytes_of(int n, bool global) {
  const int P = next_pow2(n), W = (n + 63) / 64, WS = (W + 1) & ~1;
  if (global) {
    int stage = 2 * 64 * WS * 8;
    return align16(stage > P * 8 ? stage : P * 8) + 2 * W * 8;
  }
  return n * WS * 8 + align16(P * 8) + n * 16 + align16(n * 4) + 2 * W * 8;
}

Layout layout_of(int n) {
  Layout L;
  L.P = next_pow2(n);
  L.W = (n + 63) / 64;
  L.WS = (L.W + 1) & ~1;
  L.global = smem_bytes_of(n, false) > SMEM_LIMIT;
  L.smem = smem_bytes_of(n, L.global);
  return L;
}

// max / min that return NaN when either input is NaN (jnp.maximum's rule),
// one instruction each on sm_80 and later
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// One compare-exchange of the bitonic network in registers: element i
// meets i ^ j (j < 32, in the same warp) and keeps the smaller key when it
// is the pair's lower element of an ascending (i & k == 0) run.
__device__ __forceinline__ u64 cmpx(u64 x, int i, int j, int k) {
  const u64 y = __shfl_xor_sync(0xffffffffu, x, j);
  return (((i & j) == 0) == ((i & k) == 0)) ? (x < y ? x : y)
                                            : (x < y ? y : x);
}

// sorted row i suppresses sorted row j
__device__ __forceinline__ bool suppresses(float4 bi, float ai, float4 bj,
                                           float aj, float threshold,
                                           bool min_method, bool skip_zero) {
  const float w = max_nan(
      0.0f, __fadd_rn(__fsub_rn(min_nan(bi.z, bj.z), max_nan(bi.x, bj.x)),
                      1.0f));
  const float h = max_nan(
      0.0f, __fadd_rn(__fsub_rn(min_nan(bi.w, bj.w), max_nan(bi.y, bj.y)),
                      1.0f));
  const float inter = __fmul_rn(w, h);
  if (skip_zero && inter == 0.0f) return false;
  const float denom =
      min_method ? min_nan(ai, aj) : __fsub_rn(__fadd_rn(ai, aj), inter);
  const float o = __fdiv_rn(inter, denom);
  return o > threshold && isfinite(o);
}

__device__ __forceinline__ u64 sort_key(float s, int row, int n) {
  uint32_t hi = 0xFFFFFFFFu;
  if (isfinite(s)) {
    if (s == 0.0f) s = 0.0f;  // -0.0 -> +0.0
    uint32_t u = __float_as_uint(s);
    u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // ascending in s
    hi = ~u;                                          // descending in s
  }
  return ((u64)hi << 32) | (uint32_t)(n - 1 - row);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

struct Args {
  const float* boxes;  // [S, n, 5]
  bool* keep;          // [S, n]
  u64* gmask;          // global mode: [S, n, WS]
  float4* gbox;        // global mode: [S, n] sorted x1, y1, x2, y2
  float* garea;        // global mode: [S, n]
  int* gorder;         // global mode: [S, n] original row of sorted row
  int n, P, W, WS;
  float threshold;
  int min_method;
};

// Stage the mask rows of block b (words b & ~1 .. WS) into buf [64][WS].
__device__ __forceinline__ void stage_block(const u64* gm, u64* buf, int b,
                                            int n, int WS, int lane) {
  const int r0 = 64 * b;
  const int rows = n - r0 < 64 ? n - r0 : 64;
  const int k0 = b & ~1;
  const int pairs = (WS - k0) / 2;
  for (int idx = lane; idx < rows * pairs; idx += 32) {
    const int t = idx / pairs, k = k0 + 2 * (idx % pairs);
    cp_async16(buf + t * WS + k, gm + (size_t)(r0 + t) * WS + k);
  }
}

template <bool GLOBAL, int SLOTS>
__global__ void __launch_bounds__(THREADS)
nms_bitmask_kernel(Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int set = blockIdx.x / csize;
  const int n = a.n, P = a.P, W = a.W, WS = a.WS;
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = T >> 5;

  extern __shared__ __align__(16) unsigned char smem[];
  u64* mask = nullptr;
  u64* keys;
  float4* bx;
  float* area;
  u64* validw;
  u64* keepw;
  if (GLOBAL) {
    keys = reinterpret_cast<u64*>(smem);
    const int stage = 2 * 64 * WS * 8;
    validw = reinterpret_cast<u64*>(smem + align16(stage > P * 8 ? stage
                                                                 : P * 8));
    bx = a.gbox + (size_t)set * n;
    area = a.garea + (size_t)set * n;
    mask = a.gmask + (size_t)set * n * WS;
  } else {
    mask = reinterpret_cast<u64*>(smem);
    keys = mask + (size_t)n * WS;
    bx = reinterpret_cast<float4*>(reinterpret_cast<unsigned char*>(keys) +
                                   align16(P * 8));
    area = reinterpret_cast<float*>(bx + n);
    validw = reinterpret_cast<u64*>(reinterpret_cast<unsigned char*>(area) +
                                    align16(n * 4));
  }
  keepw = validw + W;

  // 1. keys, then the bitonic sort (ascending: the visiting order) of
  // Q = max(P, 32) keys, those past P all ones: the steps j < 32 in
  // registers across a warp's lanes, the steps j >= 32 in shared memory
  const float* b = a.boxes + (size_t)set * n * 5;
  for (int i = tid; i < P; i += T)
    keys[i] = i < n ? sort_key(b[(size_t)i * 5 + 4], i, n) : ~0ull;
  __syncthreads();
  const int Q = P < 32 ? 32 : P;
  for (int c = warp; 32 * c < Q; c += nwarps) {
    const int i = 32 * c + lane;
    u64 x = i < P ? keys[i] : ~0ull;
    for (int k = 2; k <= 32; k <<= 1)
      for (int j = k >> 1; j > 0; j >>= 1) x = cmpx(x, i, j, k);
    if (i < P) keys[i] = x;
  }
  __syncthreads();
  for (int k = 64; k <= Q; k <<= 1) {
    for (int j = k >> 1; j >= 32; j >>= 1) {
      for (int q = tid; q < Q / 2; q += T) {
        const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        const int l = i + j;
        const u64 x = keys[i], y = keys[l];
        if ((x > y) == ((i & k) == 0)) {
          keys[i] = y;
          keys[l] = x;
        }
      }
      __syncthreads();
    }
    for (int c = warp; 32 * c < Q; c += nwarps) {
      const int i = 32 * c + lane;
      u64 x = keys[i];
      for (int j = 16; j > 0; j >>= 1) x = cmpx(x, i, j, k);
      keys[i] = x;
    }
    __syncthreads();
  }

  // 2. sorted boxes and areas, valid words
  const bool writer = !GLOBAL || rank == 0;
  for (int r = tid; r < n; r += T) {
    const int row = n - 1 - (int)(uint32_t)keys[r];
    const float* s = b + (size_t)row * 5;
    const float4 v = make_float4(s[0], s[1], s[2], s[3]);
    if (writer) {
      bx[r] = v;
      area[r] = __fmul_rn(__fadd_rn(__fsub_rn(v.z, v.x), 1.0f),
                          __fadd_rn(__fsub_rn(v.w, v.y), 1.0f));
      if (GLOBAL) a.gorder[(size_t)set * n + r] = row;
    }
  }
  for (int w = tid; w < W; w += T) {
    u64 v = 0;
    for (int t = 0; t < 64 && 64 * w + t < n; ++t)
      if ((uint32_t)(keys[64 * w + t] >> 32) != 0xFFFFFFFFu) v |= 1ull << t;
    validw[w] = v;
  }
  if (GLOBAL) {
    __threadfence();
    cluster.sync();  // the leader's sorted boxes are every CTA's
  } else {
    cluster.sync();  // every CTA of the cluster runs: DSMEM is safe
  }

  // 3. the bitmask: warp task (i, w) for rows i = rank (mod csize)
  u64* lmask = GLOBAL ? mask : cluster.map_shared_rank(mask, 0);
  const bool min_method = a.min_method != 0;
  const bool skip_zero = a.threshold >= 0.0f;
  for (int i = rank + csize * warp; i < n; i += csize * nwarps) {
    if (!((validw[i >> 6] >> (i & 63)) & 1)) continue;
    const float4 bi = bx[i];
    const float ai = area[i];
    for (int w = i >> 6; w < W; ++w) {
      const int j0 = 64 * w + lane, j1 = j0 + 32;
      bool s0 = false, s1 = false;
      if (j0 > i && j0 < n)
        s0 = suppresses(bi, ai, bx[j0], area[j0], a.threshold, min_method,
                        skip_zero);
      if (j1 > i && j1 < n)
        s1 = suppresses(bi, ai, bx[j1], area[j1], a.threshold, min_method,
                        skip_zero);
      const unsigned lo = __ballot_sync(0xffffffffu, s0);
      const unsigned hi = __ballot_sync(0xffffffffu, s1);
      if (lane == 0) lmask[(size_t)i * WS + w] = ((u64)hi << 32) | lo;
    }
  }
  if (GLOBAL) __threadfence();
  cluster.sync();
  if (rank != 0) return;

  // 4. the sweep, in warp 0
  if (warp == 0) {
    u64 rem[SLOTS];
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) rem[s] = 0;
    u64* stagebuf = keys;  // global mode: [2][64][WS], the keys are done
    if (GLOBAL) {
      stage_block(mask, stagebuf, 0, n, WS, lane);
      cp_async_commit();
    }
    for (int blk = 0; blk < W; ++blk) {
      const u64* rows;
      if (GLOBAL) {
        if (blk + 1 < W)
          stage_block(mask, stagebuf + ((blk + 1) & 1) * 64 * WS, blk + 1, n,
                      WS, lane);
        cp_async_commit();
        cp_async_wait1();
        __syncwarp();
        rows = stagebuf + (blk & 1) * 64 * WS;
      } else {
        rows = mask + (size_t)64 * blk * WS;
      }
      // the block's own words: lane l holds rows 64 blk + l and + l + 32
      const int r0 = 64 * blk;
      const u64 d0 = r0 + lane < n ? rows[lane * WS + blk] : 0;
      const u64 d1 = r0 + lane + 32 < n ? rows[(lane + 32) * WS + blk] : 0;
      u64 r = 0;
#pragma unroll
      for (int s = 0; s < SLOTS; ++s)
        if (s == (blk >> 5)) r = rem[s];
      const u64 cand = validw[blk] & ~__shfl_sync(0xffffffffu, r, blk & 31);
      // keep = cand minus what the kept rows remove: the fixed point,
      // reached from keep = cand in (longest suppression chain) + 1 steps
      u64 kw = cand, prev;
      int steps = 0;  // 65 at most on a mask built as above; the cap only
      do {            // bounds a broken one
        prev = kw;
        const u64 m = (((kw >> lane) & 1) ? d0 : 0) |
                      (((kw >> (lane + 32)) & 1) ? d1 : 0);
        const unsigned lo = __reduce_or_sync(0xffffffffu, (unsigned)m);
        const unsigned hi = __reduce_or_sync(0xffffffffu, (unsigned)(m >> 32));
        kw = cand & ~(((u64)hi << 32) | lo);
      } while (kw != prev && ++steps < 66);
      if (lane == 0) keepw[blk] = kw;
      // each later word k: the OR of the kept rows' word k, to its lane
#pragma unroll 4
      for (int k = blk + 1; k < W; ++k) {
        const u64 m = (((kw >> lane) & 1) ? rows[lane * WS + k] : 0) |
                      (((kw >> (lane + 32)) & 1) ? rows[(lane + 32) * WS + k]
                                                 : 0);
        const unsigned lo = __reduce_or_sync(0xffffffffu, (unsigned)m);
        const unsigned hi = __reduce_or_sync(0xffffffffu, (unsigned)(m >> 32));
        if (lane == (k & 31)) {
#pragma unroll
          for (int s = 0; s < SLOTS; ++s)
            if (s == (k >> 5)) rem[s] |= ((u64)hi << 32) | lo;
        }
      }
      if (GLOBAL) __syncwarp();  // the buffer is restaged next block
    }
  }
  __syncthreads();

  // 5. the mask in the original row order
  bool* out = a.keep + (size_t)set * n;
  for (int r = tid; r < n; r += T) {
    const int row = GLOBAL ? a.gorder[(size_t)set * n + r]
                           : n - 1 - (int)(uint32_t)keys[r];
    out[row] = (keepw[r >> 6] >> (r & 63)) & 1;
  }
}

template <bool GLOBAL, int SLOTS>
int launch(const Layout& L, Args a, int sets, int cluster,
           cudaStream_t stream) {
  auto kern = &nms_bitmask_kernel<GLOBAL, SLOTS>;
  // the shared-memory opt-in, once per instance and device (an attribute
  // of the device's context): the launch's host cost is most of a small
  // call's time
  static bool opted_in[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sets * cluster);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = L.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory a CTA takes for n rows per set (the mode follows from n).
extern "C" int nms_smem_bytes(int n) { return layout_of(n).smem; }

// 1 when n rows per set take the global-scratch mode.
extern "C" int nms_global_mode(int n) { return layout_of(n).global ? 1 : 0; }

// Bytes of global scratch for S sets of n rows: 0 in shared-memory mode,
// else mask [S, n, WS] u64, boxes [S, n] float4, areas and order [S, n].
extern "C" long long nms_scratch_bytes(int sets, int n) {
  const Layout L = layout_of(n);
  if (!L.global) return 0;
  const long long rows = (long long)sets * n;
  return rows * L.WS * 8 + rows * 16 + rows * 4 + rows * 4;
}

// boxes [S, n, 5] f32 (any order), keep [S, n] bool written in the
// original row order, scratch per nms_scratch_bytes (16-byte aligned),
// cluster in {1, 2, 4} CTAs per set.
extern "C" int nms_keep_mask(const void* boxes, void* keep, void* scratch,
                             int sets, int n, float threshold, int min_method,
                             int cluster, void* stream) {
  if (sets <= 0 || n <= 0) return 0;
  if (cluster < 1 || cluster > MAX_CLUSTER || (cluster & (cluster - 1)))
    return (int)cudaErrorInvalidValue;
  const Layout L = layout_of(n);
  if (L.smem > SMEM_LIMIT || (L.global && (L.W > 32 * GM_SLOTS || !scratch)))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.boxes = (const float*)boxes;
  a.keep = (bool*)keep;
  a.n = n;
  a.P = L.P;
  a.W = L.W;
  a.WS = L.WS;
  a.threshold = threshold;
  a.min_method = min_method;
  a.gmask = nullptr;
  a.gbox = nullptr;
  a.garea = nullptr;
  a.gorder = nullptr;
  cudaStream_t st = (cudaStream_t)stream;
  if (!L.global) return launch<false, 1>(L, a, sets, cluster, st);
  const size_t rows = (size_t)sets * n;
  unsigned char* p = (unsigned char*)scratch;
  a.gmask = (u64*)p;
  a.gbox = (float4*)(p + rows * L.WS * 8);
  a.garea = (float*)(p + rows * L.WS * 8 + rows * 16);
  a.gorder = (int*)(p + rows * L.WS * 8 + rows * 20);
  return launch<true, GM_SLOTS>(L, a, sets, cluster, st);
}

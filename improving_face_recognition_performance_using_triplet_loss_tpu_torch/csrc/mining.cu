// Kernel B1: fused squared-L2 distances + semi-hard negative mining, one
// pool index per anchor, without the [B, N] distance matrix in memory, on
// Hopper's tensor cores.
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
// What bounds it on the H100: tensor-core operations. At the head-training
// shape (B = 16384 anchors, N = 32768 pool rows, D = 128) the dots are
// 2 B N D = 1.37e11 operations; run as three TF32 products (below) that is
// 4.1e11 at the dense TF32 rate of 495 TFLOP/s, 0.833 ms. The epilogue's
// ~8 B N = 4.3e9 float32 operations (0.064 ms on the CUDA cores) overlap it,
// and ~24 MB of input are far below the memory bound.
//
// Why 3xTF32 is float32-accurate here: each operand x is split into
// hi = tf32(x) and lo = tf32(x - hi) (cvt.rna; x - hi is exact), and the
// tensor cores sum hi.lo + lo.hi + hi.hi in float32, the small terms first.
// The dropped lo.lo and the residue of x - hi - lo are ~2^-21 of
// sum |a_k p_k|, which is <= 1 for L2-normalized rows: well inside the
// 1e-5 distance tolerance the path is held to, where one TF32 pass (~5e-4)
// is not. For integer coordinates below 2^11 in magnitude hi = x and
// lo = 0, so every product and partial sum is exact and the indices equal
// the plain version's. The row norms are full float32 from the original x,
// in the order of the earlier CUDA-core kernel, and the distance is formed
// with the _rn intrinsics in the plain version's order, so no FMA
// contraction moves it.
//
// What the design does about the bound:
// - A pre-pass kernel splits anchors and pool into [rows, 2 Dp] arrays
//   (hi in columns [0, Dp), lo in [Dp, 2 Dp), D zero-padded to Dp, a
//   multiple of 32 floats = 128 B, so TMA's stride rule and the 128-byte
//   swizzle hold for every D) and writes the squared norms, the pool's
//   beside its labels.
// - The main kernel runs one CTA per SM (224 KB of shared memory): 128
//   anchors as two consumer warpgroups of m64, and one producer warp that
//   issues TMA copies of 32-deep chunks (one 128-byte swizzle atom) into a
//   ring of 3 stages guarded by full/empty mbarrier pairs. For D <= 128 the
//   anchors' hi and lo chunks stay resident in shared memory and the ring
//   carries only the pool's (so L2 traffic is the pool once per anchor
//   tile); for larger D each stage carries both.
// - Each consumer issues wgmma.m64n128k8 TF32 from shared memory (both
//   operands K-major, which tf32 requires; the rows are already row-major
//   [rows, K]), hi.lo, lo.hi then hi.hi per k-step into one float32
//   accumulator, and keeps one chunk's group in flight while it waits for
//   the next.
// - The epilogue works in the wgmma accumulator layout: a thread holds 2
//   anchor rows per m64 tile and pairs of adjacent pool columns, walks them
//   in increasing j with strict comparisons, and keeps (semi_d, semi_i,
//   far_d, far_i) per row in registers across the pool tiles. At the end
//   the 4 lanes of a quad merge, then a second small kernel merges the pool
//   ranges (gridDim.y `splits`, used when there are too few anchor tiles to
//   fill the card). Every merge compares (value, index) pairs -- the smaller
//   value wins, on equal values the smaller index -- so first-index tie
//   breaking does not depend on the merge order.

#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TB = 128;                 // anchors per CTA (2 x m64)
constexpr int TN = 128;                 // pool rows per tile (wgmma n128)
constexpr int KC = 32;                  // floats per chunk: one 128 B row
constexpr int STAGES = 3;               // ring depth
constexpr int KA_RES = 4;               // resident anchor chunks (D <= 128)
constexpr int TILE = 128 * KC * 4;      // bytes of one 128-row chunk, 16 KB
constexpr int CONSUMERS = 256;          // two warpgroups
constexpr int THREADS = CONSUMERS + 32; // + the producer warp
constexpr int NONE = INT_MAX;           // "no candidate yet"

// shared-memory layout, from a 1024-byte aligned base: the resident anchor
// chunks (hi, lo per chunk), the ring (stage: [anchor hi, lo,] pool hi, lo),
// then the mbarriers
template <bool RES>
struct Layout {
  static constexpr int A_BYTES = RES ? KA_RES * 2 * TILE : 0;
  static constexpr int STAGE = RES ? 2 * TILE : 4 * TILE;
  static constexpr int BAR = A_BYTES + STAGES * STAGE;
  static constexpr int SMEM = BAR + 64 + 1024;   // + barriers, alignment
};

// (d, i) beats (bd, bi) for a minimum: smaller value, then smaller index
__device__ __forceinline__ bool better_min(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

__device__ __forceinline__ bool better_max(float d, int i, float bd, int bi) {
  return d > bd || (d == bd && i < bi);
}

__device__ __forceinline__ float to_tf32(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(x));
  return __uint_as_float(u);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait for the phase of parity `parity` to complete. A wait that never ends
// means a broken pipeline: trap (a launch error) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == (1u << 24)) __trap();
  }
}

// 2-D TMA copy of the box at (x = column, y = row) into shared memory,
// completing `bar`'s transaction bytes
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle
// TMA writes: rows of 128 B, 8-row groups 1024 B apart (SBO), LBO unused
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of an accumulator register across
// the asynchronous wgmma that writes it
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// d[64] += A[64 x 8] . B[8 x 128] in TF32, both from shared memory, K-major
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Pre-pass, one warp per row over anchors then pool: hi / lo TF32 halves
// into [rows, 2 Dp] (zero past D), and |x|^2 in full float32 (lane-strided
// FMAs, then the xor shuffle tree). The pool's norm goes beside its label.
__global__ void mining_split(const float* __restrict__ anc,
                             const float* __restrict__ pool,
                             const int* __restrict__ pool_lab, int B, int N,
                             int D, int Dp, float* __restrict__ anc2,
                             float* __restrict__ pool2, float* __restrict__ a2,
                             float2* __restrict__ pinfo) {
  const long long row =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= (long long)B + N) return;  // uniform across the warp
  const bool is_anc = row < B;
  const int r = is_anc ? (int)row : (int)(row - B);
  const float* x = (is_anc ? anc : pool) + (size_t)r * D;
  float* o = (is_anc ? anc2 : pool2) + (size_t)r * 2 * Dp;
  float s = 0.0f;
  for (int k = lane; k < Dp; k += 32) {
    const float v = k < D ? x[k] : 0.0f;
    const float hi = to_tf32(v);
    o[k] = hi;
    o[Dp + k] = to_tf32(__fsub_rn(v, hi));
    if (k < D) s = fmaf(v, v, s);
  }
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    if (is_anc)
      a2[r] = s;
    else
      pinfo[r] = make_float2(s, __int_as_float(pool_lab[r]));
  }
}

template <bool RES>
__global__ void __launch_bounds__(THREADS, 1)
mining_tc(__grid_constant__ const CUtensorMap anc_map,
          __grid_constant__ const CUtensorMap pool_map,
          const float* __restrict__ a2g, const float* __restrict__ pos_sq,
          const int* __restrict__ anc_lab, const float2* __restrict__ pinfo,
          int B, int N, int Dp, int tiles_per_split,
          float* __restrict__ semi_d_out, int* __restrict__ semi_i_out,
          float* __restrict__ far_d_out, int* __restrict__ far_i_out) {
  using L = Layout<RES>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + L::BAR;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };
  const uint32_t a_full = bars + 8u * 2 * STAGES;

  const int tid = threadIdx.x;
  const int nk = Dp / KC;
  const int i0 = blockIdx.x * TB;
  const int n_tiles = (N + TN - 1) / TN;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);       // the producer's arrive + TMA bytes
      mbar_init(empty(s), 2);      // one arrive per consumer warpgroup
    }
    mbar_init(a_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ------------------------------------------------------ producer warp
    if (tid != CONSUMERS) return;
    if (RES) {
      mbar_expect_tx(a_full, nk * 2 * TILE);
      for (int kc = 0; kc < nk; ++kc) {
        tma_load(base + kc * 2 * TILE, &anc_map, kc * KC, i0, a_full);
        tma_load(base + kc * 2 * TILE + TILE, &anc_map, Dp + kc * KC, i0,
                 a_full);
      }
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int t = t_begin; t < t_end; ++t) {
      for (int kc = 0; kc < nk; ++kc) {
        mbar_wait(empty(stage), phase ^ 1u);
        const uint32_t st = base + L::A_BYTES + stage * L::STAGE;
        mbar_expect_tx(full(stage), L::STAGE);
        if (!RES) {
          tma_load(st, &anc_map, kc * KC, i0, full(stage));
          tma_load(st + TILE, &anc_map, Dp + kc * KC, i0, full(stage));
        }
        const uint32_t p = RES ? st : st + 2 * TILE;
        tma_load(p, &pool_map, kc * KC, t * TN, full(stage));
        tma_load(p + TILE, &pool_map, Dp + kc * KC, t * TN, full(stage));
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
    return;
  }

  // ------------------------------------------------- consumer warpgroups
  const int wg = tid >> 7, lt = tid & 127;
  const int q = lt & 3;
  // accumulator d[4 j + 2 h + e] is anchor row `row0 + 8 h` (of the CTA's
  // 128) and pool column 8 j + 2 q + e of the tile
  const int row0 = wg * 64 + (lt >> 5) * 16 + ((lt & 31) >> 2);
  float a2[2], ps[2], semi_d[2], far_d[2];
  int al[2], semi_i[2], far_i[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + row0 + 8 * h;
    const bool ok = i < B;
    a2[h] = ok ? a2g[i] : 0.0f;
    ps[h] = ok ? pos_sq[i] : 0.0f;
    al[h] = ok ? anc_lab[i] : 0;
    semi_d[h] = INFINITY;
    semi_i[h] = NONE;
    far_d[h] = -INFINITY;
    far_i[h] = NONE;
  }

  if (RES) mbar_wait(a_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  float acc[64];
  for (int t = t_begin; t < t_end; ++t) {
    // this thread's {p2, label} pairs of the tile (columns 8 jb + 2 q and
    // + 1; pinfo is padded to whole tiles), loaded now so that the loads
    // complete under the tile's wgmma instead of stalling the epilogue
    float4 pc[TN / 8];
#pragma unroll
    for (int jb = 0; jb < TN / 8; ++jb)
      pc[jb] = __ldg(reinterpret_cast<const float4*>(pinfo + t * TN + 8 * jb +
                                                     2 * q));
#pragma unroll
    for (int r = 0; r < 64; ++r) acc[r] = 0.0f;
    int prev = -1;
    for (int kc = 0; kc < nk; ++kc) {
      mbar_wait(full(stage), phase);
      const uint32_t st = base + L::A_BYTES + stage * L::STAGE;
      const uint32_t a = (RES ? base + kc * 2 * TILE : st) + wg * 64 * 128;
      const uint32_t p = RES ? st : st + 2 * TILE;
#pragma unroll
      for (int r = 0; r < 64; ++r) reg_fence(acc[r]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KC / 8; ++ks) {
        // one k8 step is 32 bytes along the swizzled 128-byte rows
        const uint64_t a_hi = sw128_desc(a + 32 * ks);
        const uint64_t a_lo = sw128_desc(a + TILE + 32 * ks);
        const uint64_t p_hi = sw128_desc(p + 32 * ks);
        const uint64_t p_lo = sw128_desc(p + TILE + 32 * ks);
        wgmma_tf32(acc, a_hi, p_lo);
        wgmma_tf32(acc, a_lo, p_hi);
        wgmma_tf32(acc, a_hi, p_hi);
      }
      wgmma_commit();
      if (prev >= 0) {
        // the previous chunk's products are done: hand its stage back
        wgmma_wait<1>();
        if (lt == 0) mbar_arrive(empty(prev));
      }
      prev = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1u;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int r = 0; r < 64; ++r) reg_fence(acc[r]);
    if (lt == 0) mbar_arrive(empty(prev));

    // epilogue: this thread's columns in increasing j, strict comparisons,
    // so the first index wins within the thread; the masks are predicates,
    // not branches (the lanes of a warp hold different labels)
    const int j0 = t * TN;
#pragma unroll
    for (int jb = 0; jb < TN / 8; ++jb) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = j0 + 8 * jb + 2 * q + e;
        const float p2 = e ? pc[jb].z : pc[jb].x;
        const int pl = __float_as_int(e ? pc[jb].w : pc[jb].y);
        const bool in_pool = j < N;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool neg = in_pool & (pl != al[h]);
          const float d = fmaxf(
              __fsub_rn(__fadd_rn(a2[h], p2),
                        __fmul_rn(2.0f, acc[4 * jb + 2 * h + e])),
              0.0f);
          const bool semi = neg & (d > ps[h]) & (d < semi_d[h]);
          semi_d[h] = semi ? d : semi_d[h];
          semi_i[h] = semi ? j : semi_i[h];
          const bool far = neg & (d > far_d[h]);
          far_d[h] = far ? d : far_d[h];
          far_i[h] = far ? j : far_i[h];
        }
      }
    }
  }

  // merge the 4 lanes of a quad, which share rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float sd = __shfl_xor_sync(0xffffffffu, semi_d[h], off);
      const int si = __shfl_xor_sync(0xffffffffu, semi_i[h], off);
      const float fd = __shfl_xor_sync(0xffffffffu, far_d[h], off);
      const int fi = __shfl_xor_sync(0xffffffffu, far_i[h], off);
      if (better_min(sd, si, semi_d[h], semi_i[h])) {
        semi_d[h] = sd;
        semi_i[h] = si;
      }
      if (better_max(fd, fi, far_d[h], far_i[h])) {
        far_d[h] = fd;
        far_i[h] = fi;
      }
    }
    const int i = i0 + row0 + 8 * h;
    if (q == 0 && i < B) {
      const size_t o = (size_t)blockIdx.y * B + i;
      semi_d_out[o] = semi_d[h];
      semi_i_out[o] = semi_i[h];
      far_d_out[o] = far_d[h];
      far_i_out[o] = far_i[h];
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
int padded_d(int d) { return (d + KC - 1) / KC * KC; }

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime, so the
// library needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

// [rows, 2 Dp] float32 (hi | lo) as boxes of 128 rows x 32 columns in the
// 128-byte swizzle; rows past the end read as zeros
bool make_map(CUtensorMap* map, const float* x, int rows, int Dp) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)2 * Dp, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)2 * Dp * sizeof(float)};
  const cuuint32_t box[2] = {KC, 128};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, (void*)x, dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool RES>
cudaError_t launch_main(const CUtensorMap& am, const CUtensorMap& pm,
                        const float* a2, const float* pos_sq,
                        const int* anc_lab, const float2* pinfo, int B, int N,
                        int Dp, int splits, float* semi_d, int* semi_i,
                        float* far_d, int* far_i, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      mining_tc<RES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Layout<RES>::SMEM);
  if (e != cudaSuccess) return e;
  const int tiles = n_tiles(N);
  const int per = (tiles + splits - 1) / splits;
  dim3 grid((B + TB - 1) / TB, splits);
  mining_tc<RES><<<grid, THREADS, Layout<RES>::SMEM, st>>>(
      am, pm, a2, pos_sq, anc_lab, pinfo, B, N, Dp, per, semi_d, semi_i,
      far_d, far_i);
  return cudaGetLastError();
}

}  // namespace

// Pool ranges per call: one CTA per SM, so split the pool only as far as
// the anchor tiles leave SMs idle.
extern "C" int mining_splits(int B, int N) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int row_tiles = (B + TB - 1) / TB;
  int splits = sms / row_tiles;
  const int tiles = n_tiles(N);
  if (splits > tiles) splits = tiles;
  if (splits < 1) splits = 1;
  // drop ranges that would be empty after rounding up the range length
  const int per = (tiles + splits - 1) / splits;
  return (tiles + per - 1) / per;
}

// 4-byte words of scratch the caller provides: the split anchors and pool,
// the pool's {norm, label} padded to whole tiles, the anchor norms, then
// the partials
extern "C" long long mining_scratch_words(int B, int N, int D, int splits) {
  const long long dp = padded_d(D);
  return 2 * dp * ((long long)B + N) + 2LL * n_tiles(N) * TN + B +
         4LL * splits * B;
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
  const int Dp = padded_d(D);
  float* anc2 = (float*)scratch;
  float* pool2 = anc2 + (size_t)B * 2 * Dp;
  float2* pinfo = (float2*)(pool2 + (size_t)N * 2 * Dp);
  float* a2 = (float*)(pinfo + (size_t)n_tiles(N) * TN);
  float* semi_d = a2 + B;
  int* semi_i = (int*)(semi_d + (size_t)splits * B);
  float* far_d = (float*)(semi_i + (size_t)splits * B);
  int* far_i = (int*)(far_d + (size_t)splits * B);

  const int warps_per_block = 8;
  const long long rows = (long long)B + N;
  mining_split<<<(unsigned)((rows + warps_per_block - 1) / warps_per_block),
                 32 * warps_per_block, 0, st>>>(
      (const float*)anc, (const float*)pool, (const int*)pool_lab, B, N, D,
      Dp, anc2, pool2, a2, pinfo);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  CUtensorMap am, pm;
  if (!make_map(&am, anc2, B, Dp) || !make_map(&pm, pool2, N, Dp))
    return (int)cudaErrorInvalidValue;
  e = Dp <= KA_RES * KC
          ? launch_main<true>(am, pm, a2, (const float*)pos_sq,
                              (const int*)anc_lab, pinfo, B, N, Dp, splits,
                              semi_d, semi_i, far_d, far_i, st)
          : launch_main<false>(am, pm, a2, (const float*)pos_sq,
                               (const int*)anc_lab, pinfo, B, N, Dp, splits,
                               semi_d, semi_i, far_d, far_i, st);
  if (e != cudaSuccess) return (int)e;

  mining_merge<<<(B + 255) / 256, 256, 0, st>>>(semi_d, semi_i, far_d, far_i,
                                                B, splits, (int*)out);
  return (int)cudaGetLastError();
}

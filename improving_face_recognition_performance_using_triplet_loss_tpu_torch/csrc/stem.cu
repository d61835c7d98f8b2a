// Kernel B3: the fused stem. 5x5 SAME conv of a one-channel image, bias,
// then mfm2 or efm3, then the 2x2/2 max-pool, in one pass; f32 on the CUDA
// cores (stem_kernel), bf16 on the tensor cores (stem_tc_kernel).
//
// Replaces: ops/pallas/stem_kernel.py::stem_conv_maxout_pool_pallas of the
// JAX package (an s2d im2col matmul with the maxout + phase-max epilogue).
//
// Semantics: out[b, py, px, :] for the pooled pixel (py, px) is built from
// the four conv outputs ("phases") at (2py+pi, 2px+pj), each a 25-tap f32
// sum plus the f32 bias. mfm2: the max over the 4 phases x 2 channel
// halves. efm3: the max over 4 phases x 3 thirds, then the min over the
// thirds taken per phase before the max over the phases (efm3 happens
// before the pool). Accumulation is f32; the output has the input's dtype.
//
// Its two path shapes: a serving dispatch (EFMNet342's conv1: B=16, 64x64,
// C=99, efm3; 0.34 GFLOP, 4.6 MB of f32 traffic) and a LightCNN29
// extraction batch (group1: B=128, 128x128, C=99, efm3; 10.80 GFLOP,
// 146.8 MB in f32, 73.4 MB in bf16).
//
// f32, what bounds it on the H100: operations, at both shapes. 70 FLOP per
// byte is above the f32 ridge of 20 (67 TFLOP/s over 3.35 TB/s): 0.161 ms
// at the LightCNN29 shape (0.044 ms of bytes), 0.00504 ms serving. The
// TPU kernel went to the MXU through an im2col tensor; in f32 the port
// stays on the CUDA cores (TF32 would change the features), so the FMA
// pipes have to be fed. A thread item of one (pooled pixel, channel) pair
// would take 36 window + 25 weight shared loads for 100 FMAs (shared
// memory would bound it), and a CTA a tile would reload the weights and
// stage each window with nothing in flight behind it.
//
// What the f32 design does about it (B4's stage 1, generalized to efm3):
// a persistent grid of min(tiles, SMs x resident CTAs) CTAs walks the
// (b, 8x8 pooled pixels) tiles; each CTA loads the [25, C] taps once, in
// the layout the inner loop reads (efm3: one 16-byte [G][4] entry a tap
// holding the channels g, G+g, 2G+g, as G = 33 is odd; mfm2 an 8-byte
// [G][2] pair), and stages the next tile's 20x20 window with cp.async while
// the current one computes. A thread item is 2 horizontally adjacent pooled
// pixels x 1 maxout group: its 6x8 window lives in registers (12 16-byte
// loads), and each tap's weight load feeds 2 pixels x 4 phases x 3 slices
// = 24 FMAs. The width of both path shapes, C=99/efm3, is compiled in,
// with a block size that its 1,056 items divide (352 threads); other
// widths (LightCNN9's C=96/mfm2 among them, which no path launches here:
// its conv1 goes to B6 or B4) run an instance that reads them at run time
// on 256 threads (taps [25][G][maxout], bias from global memory, so that
// widths up to C ~2,280 fit). The sums are taken in the plain order (taps row-major, then +
// bias) with one FMA a tap, as every earlier version of this kernel took
// them, so f32 features do not move. Serving's 256 tiles fill the
// 264 resident CTAs once: one tile a CTA, 2 a busy SM (124 of 132 SMs). A
// 4x8 tile gives each SM the same work with more halo: by ablation on the
// H100 it was slower at both path shapes (PERF.md section 6), so one 8x8
// tile a CTA serves this shape.
//
// bf16, what bounds it: bytes. Every bf16 x bf16 product is exact in f32,
// so on the tensor cores B3 loses no accuracy, and 989 TFLOP/s put the
// operations at 0.011 ms: the 73.4 MB of bf16 traffic (0.0219 ms at 3.35
// TB/s) bound the LightCNN29 shape, 0.00069 ms serving. Summed on the
// CUDA cores, bf16 would have the f32 operation floor, 7x higher.
//
// What the bf16 design does (front9_tc.cu's conv1 stage, generalized, on
// wgmma): an im2col GEMM per 8x8 tile, M = 256 conv positions, K = the 25
// taps + 2 bias rows padded to 32, N = maxout x G padded to 8 (15 n8
// chunks for C=99), bf16 in, f32 sums. A CTA is one warpgroup on a
// persistent grid. A is in registers, gathered from the cp.async-staged
// bf16 window, one 2-byte shared load a value; each warp's 16 rows of a
// wgmma are 4 pooled pixels x (dy, s, dx), so a thread's two rows are the
// pool's dy pair and lanes g, g^1 its dx pair. B is in shared memory in the
// K-major core-matrix layout, built once per CTA from the [25, C] taps and
// the bias the wrapper passes (no torch op a call); its rows 25 and 26 hold
// the bias as hi + lo bf16 parts against A columns of 1.0, so the sums
// start from the bias and no epilogue adds it. N columns are ordered so a
// thread's accumulators hold two channels g of every slice: per 8 g's one
// n8 chunk per third (efm3) or half (mfm2). The maxout (max and per-phase
// min over the slices) and the pool are then bf16x2 max/min in registers
// and one shuffle, on sums rounded to bf16 first (rounding is monotonic:
// the plain version's algebra, exactly). The compiled width splits N in
// two wgmma (72 + 48 columns) and takes the maxout of one while the
// tensor cores sum the other; other widths take one wgmma a group of 8
// channels. The output, 66 bf16 a pixel with the min half at an odd
// element, is staged in shared memory at the compiled width (one aligned
// 4-byte word a lane, the min half's words shifted by one channel through
// a shuffle) and leaves by bulk copies, one a tile row, issued by one
// thread and running on under the next tile (2-byte stores at ragged
// edges); the widths read at run time store straight to device memory.
// By ablation (tools/ablate_stem_torch.py) the kernel is still far from
// its bound: the wgmma, the maxout, the B build and the A gather each take
// time that the other warps do not hide (PERF.md section 6).
//
// Kernel B4 (stem2_kernel below): B3 with mfm2, chained with a 1x1 conv +
// bias + mfm2, LightCNN9's conv1..conv2a. Replaces
// ops/pallas/stem_kernel.py::stem2_conv_pallas. The stem result (rounded
// to the input dtype, as the Pallas kernel rounds it) stays in shared
// memory as an [C/2, 8x8 pixels] tile and is multiplied by the [C/2, C2]
// conv2a weights (18 KB f32 for LightCNN9), also in shared memory, with
// the mfm2 pairs (j, j + C2/2) in registers, so only [pixels, C2/2]
// reaches device memory. At the path shape (B=128, 112x96, C=96, C2=96)
// it does ~9.8 GFLOP for ~72 MB: f32 operations bound it (0.146 ms at 67
// TFLOP/s) as they bound B3. A one-tile-per-CTA grid reloaded the 28 KB of
// weights from L2 for each of its 5,376 tiles (twice the kernel's own
// traffic), loaded each window with nothing in flight behind it, and fed
// 8 FMAs per 3 shared-memory loads in its 1x1 conv; the persistent,
// register-tiled form below answers each of the three.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int TY = 8;  // pooled rows per tile
constexpr int TX = 8;  // pooled cols per tile
constexpr int IH = 2 * TY + 4;
constexpr int IW = 2 * TX + 4;
constexpr int IWS = 24;  // window row stride, elements: 16-byte rows

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <int BYTES>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src,
                                               bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = in ? BYTES : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(BYTES), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage tile `tile`'s window, zero outside the image, in element pairs
// (W and the window's first column are even, so a pair is all in or all
// out).
template <int NTHREADS, int ROWS = TY, typename T>
__device__ __forceinline__ void stage_window(const T* __restrict__ x, T* win,
                                             int tile, int tiles_x,
                                             int tiles_y, int H, int W) {
  const int tx = tile % tiles_x, rest = tile / tiles_x;
  const int ty = rest % tiles_y, b = rest / tiles_y;
  const int iy0 = 2 * ty * ROWS - 2, ix0 = 2 * tx * TX - 2;
  const T* xb = x + (size_t)b * H * W;
  for (int k = threadIdx.x; k < (2 * ROWS + 4) * (IW / 2); k += NTHREADS) {
    const int r = k / (IW / 2), c = 2 * (k % (IW / 2));
    const int iy = iy0 + r, ix = ix0 + c;
    const bool in = iy >= 0 && iy < H && ix >= 0 && ix < W;
    cp_async_zfill<2 * sizeof(T)>(win + r * IWS + c,
                                  in ? xb + (size_t)iy * W + ix : xb, in);
  }
}

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 c = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  v[0] = __low2float(a);
  v[1] = __high2float(a);
  v[2] = __low2float(c);
  v[3] = __high2float(c);
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 a, c;
  a.x = __float2bfloat16_rn(v[0]);
  a.y = __float2bfloat16_rn(v[1]);
  c.x = __float2bfloat16_rn(v[2]);
  c.y = __float2bfloat16_rn(v[3]);
  uint2 q;
  q.x = *reinterpret_cast<unsigned*>(&a);
  q.y = *reinterpret_cast<unsigned*>(&c);
  *reinterpret_cast<uint2*>(p) = q;
}

// What a kernel instance's launches learned on each device: the dynamic
// shared memory last asked for (high word) and the CTAs that the card
// holds at once at that size (low word), one atomic word so that a reader
// sees both or neither; 0 before the first launch. Finding them takes
// four runtime calls, more host time than the launch itself, on paths that
// the host bounds (a serving dispatch), so each instance's launcher keeps
// one of these beside it and a later launch only reads it.
struct GridCache {
  static constexpr int DEVICES = 16;
  std::atomic<unsigned long long> at[DEVICES];
};

// The persistent grid of a kernel: min(tiles, SMs x the CTAs of `threads`
// threads and `smem` bytes that an SM holds at once), with the kernel's
// shared-memory limit raised to `smem`; from `cache` where it holds `smem`
// for this device
template <typename K>
cudaError_t persistent_grid(K kern, int threads, int smem, long long tiles,
                            GridCache& cache, int* grid) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::atomic<unsigned long long>* slot =
      dev < GridCache::DEVICES ? &cache.at[dev] : nullptr;
  unsigned long long got = slot ? slot->load(std::memory_order_relaxed) : 0;
  if (got == 0 || (int)(got >> 32) != smem) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      smem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    got = (unsigned long long)smem << 32 | (unsigned)(sms * per_sm);
    if (slot) slot->store(got, std::memory_order_relaxed);
  }
  const long long cap = (long long)(got & 0xFFFFFFFFu);
  *grid = (int)(tiles < cap ? tiles : cap);
  return cudaSuccess;
}

// The width compiled into both B3 kernels: C=99 with efm3 (G = 33), the
// stem of EFMNet342 and LightCNN29, B3's two path shapes
constexpr int CW_C = 99, CW_G = 33;
bool compiled_width(int C, int maxout) { return maxout == 3 && C == CW_C; }

long long tiles_of(int B, int H, int W, int rows = TY) {
  return (long long)B * ((H / 2 + rows - 1) / rows) * ((W / 2 + TX - 1) / TX);
}

// ---- B3 in f32 on the CUDA cores

// pooled rows of the f32 kernel's tile (x TX columns), and its window rows
constexpr int F32_TY = 8;
constexpr int F32_IH = 2 * F32_TY + 4;

// The f32 instances: (maxout, G compiled in or 0 for run-time widths,
// threads). A slot is a tap's or a bias's entry for one group g: 16 bytes
// (g, G+g, 2G+g, pad) for the compiled efm3 width, maxout floats else.
template <int MAXOUT, int GC>
struct F32Inst {
  static_assert(!GC || (MAXOUT == 3 && GC == CW_G), "compiled: C=99, efm3");
  static constexpr int THREADS = GC ? 352 : 256;
  static constexpr int SLOT = GC ? 4 : MAXOUT;
  static constexpr bool SMEM_BIAS = GC != 0;
};

// shared memory of an instance: two f32 windows [F32_IH][IWS], taps
// [25][G][SLOT], and for the compiled width the bias [G][SLOT]
int f32_smem_of(int C, int maxout, bool compiled) {
  const int G = C / maxout;
  const int slot = compiled ? 4 : maxout;
  return 2 * F32_IH * IWS * 4 + (25 + (compiled ? 1 : 0)) * G * slot * 4;
}

template <int SLOT, int MAXOUT>
__device__ __forceinline__ void load_slot(const float* p, float (&v)[MAXOUT]) {
  if constexpr (SLOT == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
  } else if constexpr (SLOT == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
#pragma unroll
    for (int s = 0; s < MAXOUT; ++s) v[s] = p[s];
  }
}

template <int MAXOUT, int GC>
__global__ void __launch_bounds__(F32Inst<MAXOUT, GC>::THREADS)
stem_kernel(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ bias, float* __restrict__ out, int B,
            int H, int W, int C) {
  using I = F32Inst<MAXOUT, GC>;
  constexpr int NT = I::THREADS, SLOT = I::SLOT;
  extern __shared__ __align__(16) float sm3[];
  const int G = GC ? GC : C / MAXOUT;
  const int Cout = MAXOUT == 3 ? 2 * G : G;
  float* win = sm3;                    // [2][F32_IH][IWS]
  float* ws = win + 2 * F32_IH * IWS;  // [25][G][SLOT]
  float* bs = ws + 25 * G * SLOT;      // [G][SLOT] (compiled width)

  const int tid = threadIdx.x;
  const int Ho = H / 2, Wo = W / 2;
  const int tiles_x = (Wo + TX - 1) / TX;
  const int tiles_y = (Ho + F32_TY - 1) / F32_TY;
  const int total = B * tiles_y * tiles_x;
  int tile = blockIdx.x;
  if (tile < total)
    stage_window<NT, F32_TY>(x, win, tile, tiles_x, tiles_y, H, W);
  // the taps (and bias) scattered into their slots, all in flight at once
  // with the first window
  for (int k = tid; k < 25 * C; k += NT) {
    const int tap = k / C, ch = k % C;
    cp_async_zfill<4>(ws + (tap * G + ch % G) * SLOT + ch / G, w + k, true);
  }
  if (I::SMEM_BIAS)
    for (int k = tid; k < C; k += NT)
      cp_async_zfill<4>(bs + (k % G) * SLOT + k / G, bias + k, true);
  cp_async_commit();

  for (int it = 0; tile < total; ++it, tile += gridDim.x) {
    const int next = tile + gridDim.x;
    if (next < total)
      stage_window<NT, F32_TY>(x, win + ((it + 1) & 1) * F32_IH * IWS, next,
                               tiles_x, tiles_y, H, W);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const float* cw = win + (it & 1) * F32_IH * IWS;
    const int rest = tile / tiles_x;
    const int b = rest / tiles_y;
    const int py0 = (rest % tiles_y) * F32_TY, px0 = (tile % tiles_x) * TX;

    // item: pooled pixels (tx, tx + 1) = (2 tx2, 2 tx2 + 1) of pooled row
    // ty x maxout group g
    for (int k = tid; k < (F32_TY * TX / 2) * G; k += NT) {
      const int g = k % G, pp = k / G;
      const int ty = pp / (TX / 2), tx2 = pp % (TX / 2);
      const int py = py0 + ty, px = px0 + 2 * tx2;
      if (py >= Ho || px >= Wo) continue;
      float v[6][8];
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        load4(cw + (2 * ty + r) * IWS + 4 * tx2, &v[r][0]);
        load4(cw + (2 * ty + r) * IWS + 4 * tx2 + 4, &v[r][4]);
      }
      float acc[2][MAXOUT][4];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int s = 0; s < MAXOUT; ++s)
#pragma unroll
          for (int f = 0; f < 4; ++f) acc[q][s][f] = 0.f;
#pragma unroll
      for (int di = 0; di < 5; ++di)
#pragma unroll
        for (int dj = 0; dj < 5; ++dj) {
          float wv[MAXOUT];
          load_slot<SLOT>(ws + ((di * 5 + dj) * G + g) * SLOT, wv);
#pragma unroll
          for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int s = 0; s < MAXOUT; ++s) {
              acc[q][s][0] += v[di][2 * q + dj] * wv[s];
              acc[q][s][1] += v[di][2 * q + dj + 1] * wv[s];
              acc[q][s][2] += v[di + 1][2 * q + dj] * wv[s];
              acc[q][s][3] += v[di + 1][2 * q + dj + 1] * wv[s];
            }
        }
      float bv[MAXOUT];
      if (I::SMEM_BIAS) {
        load_slot<SLOT>(bs + g * SLOT, bv);
      } else {
#pragma unroll
        for (int s = 0; s < MAXOUT; ++s) bv[s] = __ldg(bias + s * G + g);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (px + q >= Wo) continue;
        float mx = -INFINITY;
        float mn[4] = {INFINITY, INFINITY, INFINITY, INFINITY};
#pragma unroll
        for (int s = 0; s < MAXOUT; ++s)
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            const float ph = acc[q][s][f] + bv[s];
            mx = fmaxf(mx, ph);
            mn[f] = fminf(mn[f], ph);
          }
        float* o = out + (((size_t)b * Ho + py) * Wo + px + q) * Cout;
        o[g] = mx;
        if (MAXOUT == 3)
          o[G + g] = fmaxf(fmaxf(mn[0], mn[1]), fmaxf(mn[2], mn[3]));
      }
    }
    __syncthreads();  // every read of this window is done before it is
                      // staged over
  }
}

template <int MAXOUT, int GC>
int launch_f32(const float* x, const float* w, const float* bias, float* out,
               int B, int H, int W, int C, void* stream) {
  static GridCache cache;
  const int smem = f32_smem_of(C, MAXOUT, GC != 0);
  auto kern = &stem_kernel<MAXOUT, GC>;
  const int threads = F32Inst<MAXOUT, GC>::THREADS;
  int grid = 0;
  cudaError_t e = persistent_grid(kern, threads, smem,
                                  tiles_of(B, H, W, F32_TY), cache, &grid);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, threads, smem, (cudaStream_t)stream>>>(x, w, bias, out, B, H,
                                                      W, C);
  return (int)cudaGetLastError();
}

// ---- B3 in bf16 on the tensor cores

constexpr int TC_THREADS = 128;  // one warpgroup: 4 warps x 4 m16 tiles
constexpr int TC_MT = 4;         // m16 tiles of a warp (4 wgmma a tile)

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v));
}

constexpr uint32_t BF16_ONE = 0x3F80;  // 1.0 in bf16

// B's row k: tap k for k < 25 (`tap`, loaded by the caller); rows 25 and
// 26 carry the bias `b` as hi + lo bf16 parts (A's columns 25 and 26 are
// 1.0), so the sums start from the bias to ~2^-17 of it and no epilogue
// adds it; rows 27..31 are zero
__device__ __forceinline__ uint32_t b_value(float tap, float b, int k) {
  const float hi = __bfloat162float(__float2bfloat16_rn(b));
  return bf16_bits(k < 25 ? tap : k == 25 ? hi : k == 26 ? b - hi : 0.f);
}

// Store a bf16 pair (channels c, c + 1) of which `n` are channels (1 or
// 2): one 4-byte store where the pair is aligned, else one per channel
__device__ __forceinline__ void store_pair(__nv_bfloat16* p,
                                           __nv_bfloat162 v, int n) {
  if (n >= 2 && !(reinterpret_cast<uintptr_t>(p) & 3)) {
    *reinterpret_cast<__nv_bfloat162*>(p) = v;
  } else {
    p[0] = v.x;
    if (n >= 2) p[1] = v.y;
  }
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

// the generic proxy's shared-memory writes made visible to the async proxy
// (wgmma's B operand, the bulk copies of the staged output)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// one bulk copy of `bytes` (16-byte aligned, a multiple of 16) from shared
// to device memory, by the copy engine
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           int bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
      "r"((unsigned)__cvta_generic_to_shared(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// the sources of all but the newest N groups of bulk copies have been read
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// keeps the compiler from moving accesses of an accumulator register across
// the asynchronous wgmma that writes it
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// B in shared memory, K-major without swizzle: core matrices of 8 columns
// (n) x 8 rows (k), 128 contiguous bytes each (a column's 8 k in 16 bytes);
// per k16 step the two k halves of an n8 chunk 128 B apart (LBO), the n8
// chunks 256 B apart (SBO), the steps NT x 256 B apart
constexpr int B_LBO = 128, B_SBO = 256;

__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)(B_LBO >> 4) << 16) | ((uint64_t)(B_SBO >> 4) << 32);
}

// D[64 x N] (+)= A[64 x 16] . B[16 x N] on the tensor cores: A in registers
// (each warp's 16 rows in mma.sync's m16 fragment layout), B in shared
// memory behind `desc`, the sums f32 in mma.sync's C layout per n8 chunk
// (d[4 j .. 4 j + 3] for chunk j); acc = 0 overwrites d. N = 8 MAXOUT
// (one group of 8 channels), or for the compiled width one of the two
// parts its channels are split into (72 + 48 columns).
template <int N>
__device__ __forceinline__ void wgmma_bf16(float* d, const uint32_t (&a)[4],
                                           uint64_t desc, int acc);

template <>
__device__ __forceinline__ void wgmma_bf16<16>(float* d, const uint32_t (&a)[4],
                                              uint64_t desc, int acc) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %13, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_bf16<24>(float* d, const uint32_t (&a)[4],
                                              uint64_t desc, int acc) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %17, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, {%12, %13, %14, %15}, %16, p, 1, 1, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_bf16<48>(float* d, const uint32_t (&a)[4],
                                              uint64_t desc, int acc) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %29, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_bf16<72>(float* d, const uint32_t (&a)[4],
                                              uint64_t desc, int acc) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %41, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35"
      "}, {%36, %37, %38, %39}, %40, p, 1, 1, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

// shared memory of an instance: B [2 k16 steps][NT n8 chunks] of 256 B,
// two bf16 windows [IH][IWS], and for the compiled width two buffers of
// the tile's output [TY x TX][Cout] bf16 (one is copied out while the
// next tile fills the other)
int tc_smem_of(int C, int maxout, bool compiled) {
  const int G = C / maxout, nt = maxout * ((G + 7) / 8);
  return 2 * nt * B_SBO + 2 * IH * IWS * 2 +
         (compiled ? 2 * TY * TX * 2 * G * 2 : 0);
}

// GC: G compiled in (C=99/efm3: the channels in two parts, one wgmma each,
// pipelined against the maxout; the output staged and bulk-copied), or 0
// for widths read at run time (one wgmma a group of 8 channels, stores
// straight to device memory)
template <int MAXOUT, int GC>
__global__ void __launch_bounds__(TC_THREADS, 4)
stem_tc_kernel(const __nv_bfloat16* __restrict__ x,
               const float* __restrict__ w, const float* __restrict__ bias,
               __nv_bfloat16* __restrict__ out, int B, int H, int W, int C) {
  static_assert(!GC || (MAXOUT == 3 && GC == CW_G), "compiled: C=99, efm3");
  constexpr bool STAGED = GC != 0;
  extern __shared__ __align__(128) unsigned char smt[];
  const int G = GC ? GC : C / MAXOUT, GB = (G + 7) / 8, NT = MAXOUT * GB;
  const int Cout = MAXOUT == 3 ? 2 * G : G;
  unsigned char* Bs = smt;
  unsigned char* wb = Bs + 2 * NT * B_SBO;
  __nv_bfloat16* win = reinterpret_cast<__nv_bfloat16*>(wb);  // [2][IH][IWS]
  const uint16_t* winb = reinterpret_cast<const uint16_t*>(wb);
  __nv_bfloat16* stg2 = reinterpret_cast<__nv_bfloat16*>(wb + 2 * IH * IWS * 2);
  const uint32_t bs_addr = static_cast<uint32_t>(__cvta_generic_to_shared(Bs));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int Ho = H / 2, Wo = W / 2;
  const int tiles_x = (Wo + TX - 1) / TX, tiles_y = (Ho + TY - 1) / TY;
  const int total = B * tiles_y * tiles_x;
  int tile = blockIdx.x;
  if (tile < total)
    stage_window<TC_THREADS>(x, win, tile, tiles_x, tiles_y, H, W);
  // the compiled width copies the taps and the bias into the (not yet
  // used) staging buffers, all in flight at once, and builds B from there;
  // other widths, which have no staging, read them from device memory
  const float* wsrc = w;
  const float* bsrc = bias;
  if constexpr (STAGED) {
    // [25][C] taps then [C] bias: 10.3 KB of the 16.9 KB staging at C=99
    float* raw = reinterpret_cast<float*>(stg2);
    const int n16 = reinterpret_cast<uintptr_t>(w) & 15 ? 0 : 25 * C / 4;
    for (int k = tid; k < n16; k += TC_THREADS)
      cp_async_zfill<16>(raw + 4 * k, w + 4 * k, true);
    for (int k = 4 * n16 + tid; k < 25 * C; k += TC_THREADS)
      cp_async_zfill<4>(raw + k, w + k, true);
    for (int k = tid; k < C; k += TC_THREADS)
      cp_async_zfill<4>(raw + 25 * C + k, bias + k, true);
    cp_async_commit();
    cp_async_wait0();
    __syncthreads();
    wsrc = raw;
    bsrc = raw + 25 * C;
  } else {
    cp_async_commit();
  }

  // B: column n = 8 nt + c of n8 chunk nt = MAXOUT gb + s is channel
  // s G + 8 gb + c (zero from G on); its 32-bit word kp of step ks holds
  // rows k = 16 ks + 2 kp, + 1. The taps are bf16 values held in f32, so
  // the packing is exact. FR words a thread at a time, their loads
  // (unconditional, from clamped addresses) all issued before one is used.
  constexpr int FR = 8;
  const int nwords = 2 * NT * 8 * 8;  // [ks][n][kp]
  for (int i0 = tid; i0 < nwords; i0 += FR * TC_THREADS) {
    float tap[FR][2], bv[FR];
#pragma unroll
    for (int f = 0; f < FR; ++f) {
      const int i = min(i0 + f * TC_THREADS, nwords - 1);
      const int kp = i % 8, n = (i / 8) % (8 * NT), ks = i / (64 * NT);
      const int nt = n / 8;
      const int ch = (nt % MAXOUT) * G + min(8 * (nt / MAXOUT) + n % 8, G - 1);
      const int k = 16 * ks + 2 * kp;
      tap[f][0] = wsrc[min(k, 24) * C + ch];
      tap[f][1] = wsrc[min(k + 1, 24) * C + ch];
      bv[f] = bsrc[ch];
    }
#pragma unroll
    for (int f = 0; f < FR; ++f) {
      const int i = i0 + f * TC_THREADS;
      const int kp = i % 8, n = (i / 8) % (8 * NT), ks = i / (64 * NT);
      const int nt = n / 8;
      const bool live = 8 * (nt / MAXOUT) + n % 8 < G;
      const int k = 16 * ks + 2 * kp;
      const uint32_t lo = live ? b_value(tap[f][0], bv[f], k) : 0u;
      const uint32_t hi = live ? b_value(tap[f][1], bv[f], k + 1) : 0u;
      if (i < nwords)
        *reinterpret_cast<uint32_t*>(
            Bs + ((ks * NT + nt) * 2 + kp / 4) * 128 + (n % 8) * 16 +
            (kp % 4) * 4) = lo | (hi << 16);
    }
  }
  fence_proxy_async();  // the wgmma reads B through the async proxy

  // A fragments: column k = 16 ks + 8 h + 2 t + e is tap k, at window
  // offset (k / 5) IWS + k % 5 from the row's conv position; columns 25 and
  // 26 are 1.0 (the bias rows of B), 27..31 zero
  int tap_off[2][2][2];
  uint32_t tap_val[2][2][2];  // the value of a column that is not a tap
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 16 * ks + 8 * h + 2 * t + e;
        tap_off[ks][h][e] = k < 25 ? (k / 5) * IWS + k % 5 : -1;
        tap_val[ks][h][e] = (k == 25 || k == 26) ? BF16_ONE : 0u;
      }
  // m16 tile i of this warp holds the 4 pooled pixels of tile column 2
  // warp + i / 2, rows 4 (i % 2) .. + 3: pixel s (s = 0..3) is pooled row
  // 4 (i % 2) + s. Row r = 8 dy + 2 s + dx is the conv position (2 ty + dy,
  // 2 tx + dx) of pixel s, so this thread's rows gq and gq + 8 are the dy
  // pair of pixel s = gq / 2, dx = gq % 2. The warpgroup's m16 tiles i make
  // up the 64 rows of one wgmma. A tile row apart, the 4 pixels' staged
  // outputs (66 bf16 a pixel) start 8 banks apart.
  const int s_px = gq >> 1, dx = gq & 1;
  int px_of[TC_MT];  // this thread's pooled pixel in each m16 tile
  // where this thread's words go in the staged tile: pixel, then the max
  // half (lanes dx = 0) at channel 2 t (+ 8 gb), or the min half (dx = 1),
  // whose aligned words start one channel earlier as G is odd
  int stg_at[TC_MT];
#pragma unroll
  for (int i = 0; i < TC_MT; ++i) {
    px_of[i] = (4 * (i & 1) + s_px) * TX + 2 * warp + (i >> 1);
    stg_at[i] = px_of[i] * Cout + (dx ? G - 1 : 0) + 2 * t;
  }

  for (int it = 0; tile < total; ++it, tile += gridDim.x) {
    const int next = tile + gridDim.x;
    if (next < total)
      stage_window<TC_THREADS>(x, win + ((it + 1) & 1) * IH * IWS, next,
                               tiles_x, tiles_y, H, W);
    cp_async_commit();
    cp_async_wait1();
    // this tile's staging buffer was last copied out two tiles ago
    if (tid == 0) bulk_wait_read<1>();
    __syncthreads();
    const uint16_t* cw = winb + (it & 1) * IH * IWS;
    __nv_bfloat16* stg = stg2 + (it & 1) * TY * TX * Cout;
    const int rest = tile / tiles_x;
    const int b = rest / tiles_y;
    const int py0 = (rest % tiles_y) * TY, px0 = (tile % tiles_x) * TX;

    // the A fragments of m16 tile i (the warpgroup's rows of wgmma i)
    uint32_t a[2][2][4];
    auto gather = [&](int i, uint32_t (&ai)[2][4]) {
      const int r0 = 2 * (px_of[i] / TX) * IWS + 2 * (px_of[i] % TX) + dx;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int dy = 0; dy < 2; ++dy) {
            const int r = r0 + dy * IWS;
            uint32_t v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e)
              v[e] = tap_off[ks][h][e] >= 0 ? cw[r + tap_off[ks][h][e]]
                                            : tap_val[ks][h][e];
            ai[ks][2 * h + dy] = v[0] | (v[1] << 16);
          }
    };
    // the sums of n8 chunks c0 .. c0 + N/8 - 1 for m16 tile i: both k16
    // steps, one commit group
    auto issue = [&](auto n_tag, float* acc, const uint32_t (&ai)[2][4],
                     int c0) {
      constexpr int N = decltype(n_tag)::value;
#pragma unroll
      for (int q = 0; q < N / 2; ++q) reg_fence(acc[q]);
      wgmma_fence();
      wgmma_bf16<N>(acc, ai[0], b_desc(bs_addr + c0 * B_SBO), 0);
      wgmma_bf16<N>(acc, ai[1], b_desc(bs_addr + (NT + c0) * B_SBO), 1);
      wgmma_commit();
    };
    // maxout + pool of group gb (its MAXOUT slices' sums at cs + 4 s) for
    // m16 tile i, and the store of this thread's pair
    uint32_t carry = 0;  // STAGED: the min of channel 8 gb + 7, lane t = 3
    auto epilogue = [&](int i, int gb, float* cs) {
#pragma unroll
      for (int q = 0; q < 4 * MAXOUT; ++q) reg_fence(cs[q]);
      // this thread's channels g0 = 8 gb + 2 t and g0 + 1, as one bf16
      // pair: rounding is monotonic, so the max and min of the rounded
      // sums are the rounded max and min
      const int g0 = 8 * gb + 2 * t;
      // per phase row dy: the max and the min over the slices; then the
      // pool: max over dy here, over dx (lane ^ 4) by a shuffle
      __nv_bfloat162 mx, mn;
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        __nv_bfloat162 hi = __floats2bfloat162_rn(cs[2 * dy], cs[2 * dy + 1]);
        __nv_bfloat162 lo = hi;
#pragma unroll
        for (int s = 1; s < MAXOUT; ++s) {
          const __nv_bfloat162 v =
              __floats2bfloat162_rn(cs[4 * s + 2 * dy], cs[4 * s + 2 * dy + 1]);
          hi = __hmax2(hi, v);
          lo = __hmin2(lo, v);
        }
        mx = dy ? __hmax2(mx, hi) : hi;
        mn = dy ? __hmax2(mn, lo) : lo;
      }
      mx = __hmax2(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      if (MAXOUT == 3) mn = __hmax2(mn, __shfl_xor_sync(0xffffffffu, mn, 4));
      // lane dx = 0 stores the max half, dx = 1 the min half (efm3)
      if constexpr (STAGED) {
        // branch-free aligned words: the max pair (g0, g0 + 1); with G odd
        // the min half starts at an odd element, so lane t stores the min
        // word (g0 - 1, g0), taking channel g0 - 1 from lane t - 1 (for t
        // = 0 from lane 3 of the group before). The word (g0 - 1 = -1, 0)
        // lands on the max of channel G - 1, which its own store (the last
        // group's, 2 bytes) overwrites later in this thread's warp.
        const uint32_t mxw = *reinterpret_cast<const uint32_t*>(&mx);
        const uint32_t mnw = *reinterpret_cast<const uint32_t*>(&mn);
        const uint32_t src = t == 3 ? carry : mnw >> 16;
        const uint32_t prev =
            __shfl_sync(0xffffffffu, src, t == 0 ? lane + 3 : lane - 1);
        carry = mnw >> 16;
        const uint32_t word = dx ? (prev & 0xFFFFu) | (mnw << 16) : mxw;
        uint32_t* p = reinterpret_cast<uint32_t*>(stg + stg_at[i] + 8 * gb);
        if (dx ? g0 < G : g0 + 1 < G)
          *p = word;
        else if (!dx && g0 < G)
          *reinterpret_cast<__nv_bfloat16*>(p) = mx.x;
        return;
      }
      const int n = min(2, G - g0);  // the channels of the pair
      if (n <= 0 || (MAXOUT == 2 && dx)) return;
      const int ty = px_of[i] / TX, tx = px_of[i] % TX;
      if (py0 + ty < Ho && px0 + tx < Wo)
        store_pair(out + (((size_t)b * Ho + py0 + ty) * Wo + px0 + tx) * Cout +
                       (dx ? G + g0 : g0),
                   dx ? mn : mx, n);
    };

    gather(0, a[0]);
    if constexpr (GC != 0) {
      // the compiled width: the groups split into parts A (the first
      // GA) and B, each one wgmma a k16 step; while the threads take the
      // maxout of one part, the tensor cores sum the other (of this m16
      // tile or the next)
      constexpr int GB_ = (GC + 7) / 8, GA = (GB_ + 1) / 2;
      constexpr int NA = MAXOUT * GA, NB = MAXOUT * (GB_ - GA);
      using TagA = std::integral_constant<int, 8 * NA>;
      using TagB = std::integral_constant<int, 8 * NB>;
      float accA[4 * NA], accB[4 * NB];
      issue(TagA(), accA, a[0], 0);
      issue(TagB(), accB, a[0], NA);
#pragma unroll
      for (int i = 0; i < TC_MT; ++i) {
        wgmma_wait<1>();  // part A of tile i
#pragma unroll
        for (int gl = 0; gl < GA; ++gl) epilogue(i, gl, accA + 4 * MAXOUT * gl);
        if (i + 1 < TC_MT) {
          gather(i + 1, a[(i + 1) & 1]);
          issue(TagA(), accA, a[(i + 1) & 1], 0);
          wgmma_wait<1>();  // part B of tile i
        } else {
          wgmma_wait<0>();
        }
#pragma unroll
        for (int gl = 0; gl < GB_ - GA; ++gl)
          epilogue(i, GA + gl, accB + 4 * MAXOUT * gl);
        if (i + 1 < TC_MT) issue(TagB(), accB, a[(i + 1) & 1], NA);
      }
    } else {
      // widths read at run time: one group of 8 channels a wgmma
      using Tag = std::integral_constant<int, 8 * MAXOUT>;
      float acc[4 * MAXOUT];
#pragma unroll 1
      for (int i = 0; i < TC_MT; ++i) {
        if (i) gather(i, a[0]);
#pragma unroll 1
        for (int gb = 0; gb < GB; ++gb) {
          issue(Tag(), acc, a[0], MAXOUT * gb);
          wgmma_wait<0>();
          epilogue(i, gb, acc);
        }
      }
    }
    if constexpr (STAGED) fence_proxy_async();  // the bulk copies read it
    __syncthreads();  // the tile's output is staged; the window is read
    if constexpr (STAGED) {
      // each pooled row of the tile is one run of npx * Cout elements in
      // device memory: one bulk copy a row where the runs are 16-byte
      // aligned (thread 0 issues them; they run on while the next tile
      // computes), 2-byte stores at ragged edges
      const int npx = min(TX, Wo - px0), nrow = min(TY, Ho - py0);
      const int run = npx * Cout;
      __nv_bfloat16* o0 = out + (((size_t)b * Ho + py0) * Wo + px0) * Cout;
      const bool bulk = npx == TX && (Wo * Cout) % 8 == 0;
      if (tid == 0) {
        if (bulk)
          for (int r = 0; r < nrow; ++r)
            bulk_store(o0 + (size_t)r * Wo * Cout, stg + r * TX * Cout,
                       run * 2);
        bulk_commit();  // one group a tile, empty where none was issued
      }
      if (!bulk)
        for (int k = tid; k < nrow * run; k += TC_THREADS) {
          const int r = k / run, c = k % run;
          o0[(size_t)r * Wo * Cout + c] = stg[r * TX * Cout + c];
        }
    }
  }
  if (tid == 0) bulk_wait_all();
}

template <int MAXOUT, int GC>
int launch_tc(const __nv_bfloat16* x, const float* w, const float* bias,
              __nv_bfloat16* out, int B, int H, int W, int C, void* stream) {
  static GridCache cache;
  const int smem = tc_smem_of(C, MAXOUT, GC != 0);
  auto kern = &stem_tc_kernel<MAXOUT, GC>;
  int grid = 0;
  cudaError_t e = persistent_grid(kern, TC_THREADS, smem, tiles_of(B, H, W),
                                  cache, &grid);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, TC_THREADS, smem, (cudaStream_t)stream>>>(x, w, bias, out, B,
                                                         H, W, C);
  return (int)cudaGetLastError();
}

// Kernel B4, redesigned: a persistent grid of CTAs, each walking the
// tiles (b, 8x8 pooled pixels) t = blockIdx.x, + gridDim.x, ... With the
// conv1 and conv2a weights and biases loaded into shared memory once per
// CTA, in the layouts the inner loops read; the next tile's 20x20 input
// window is staged with cp.async into a second buffer while the current
// one is computed. Stage 1 (the 5x5 conv + bias + mfm2 + pool): a thread
// item is 2 pooled pixels x 1 mfm2 pair, so each weight float2 (the pair's
// two channels) feeds 2 pixels x 4 phases. Stage 2 (the 1x1 conv + bias +
// mfm2): a thread item is 4 pixels x 4 pairs (32 accumulators), so per
// input channel one float4 of the stem tile and two float4 of weights
// feed 32 FMAs. The sums keep the order of the one-tile-per-CTA kernel
// (taps row-major, then input channels ascending), so the results do not
// change.
constexpr int S2_THREADS = 192;  // 32 x 48 stage-1 and 16 x 12 stage-2
                                 // items divide evenly for LightCNN9
constexpr int SP = 68;           // stem tile row stride [G][SP] (64 + pad)

// B4's shared memory: w2 [G][C2/2][2] f32, w1 [25][G][2] f32, b1 [C],
// b2 [C2], the stem tile [G][SP] f32 (16-byte aligned float4 rows), then
// two input windows [IH][IWS] of T
int stem2_smem_of(int C, int C2, int tsize) {
  const int G = C / 2;
  return (G * C2 + 25 * C + C + C2 + G * SP) * 4 + 2 * IH * IWS * tsize;
}

// LightCNN9's widths (C = C2 = 96), compiled in so that the shared-memory
// offsets of the inner loops fold into the instructions; the only widths
// the kernel takes
constexpr int S2_C = 96, S2_C2 = 96;

template <typename T>
__global__ void __launch_bounds__(S2_THREADS)
stem2_kernel(const T* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ bias, const float* __restrict__ w2,
             const float* __restrict__ b2, T* __restrict__ out, int B, int H,
             int W) {
  extern __shared__ __align__(16) float sm2[];
  const int C = S2_C, C2 = S2_C2;
  const int G = C / 2, half2 = C2 / 2;
  float* w2s = sm2;             // [G][half2][2]
  float* w1s = w2s + G * C2;    // [25][G][2]: the pair (g, G + g)
  float* bs = w1s + 25 * C;     // [C]
  float* b2s = bs + C;          // [C2]
  float* st = b2s + C2;         // [G][SP] stem tile
  T* win = reinterpret_cast<T*>(st + G * SP);  // [2][IH][IWS]

  const int tid = threadIdx.x;
  const int Ho = H / 2, Wo = W / 2;
  const int tiles_x = (Wo + TX - 1) / TX, tiles_y = (Ho + TY - 1) / TY;
  const int total = B * tiles_y * tiles_x;
  int tile = blockIdx.x;
  if (tile < total)
    stage_window<S2_THREADS>(x, win, tile, tiles_x, tiles_y, H, W);
  cp_async_commit();
  for (int k = tid; k < 25 * C; k += S2_THREADS) {
    const int tap = k / C, ch = k % C;
    w1s[(tap * G + ch % G) * 2 + ch / G] = w[k];
  }
  for (int k = tid; k < C; k += S2_THREADS) bs[k] = bias[k];
  for (int k = tid; k < G * C2; k += S2_THREADS) w2s[k] = w2[k];
  for (int k = tid; k < C2; k += S2_THREADS) b2s[k] = b2[k];

  const int NJ = half2 / 4;
  for (int it = 0; tile < total; ++it, tile += gridDim.x) {
    const int next = tile + gridDim.x;
    if (next < total)
      stage_window<S2_THREADS>(x, win + ((it + 1) & 1) * IH * IWS, next,
                               tiles_x, tiles_y, H, W);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const T* cw = win + (it & 1) * IH * IWS;

    // stage 1: 2 pooled pixels (tx, tx + 1) x 1 mfm2 pair g
    for (int item = tid; item < (TY * TX / 2) * G; item += S2_THREADS) {
      const int g = item % G, pp = item / G;
      const int ty = pp / (TX / 2), tx2 = pp % (TX / 2);
      float v[6][8];
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        load4(cw + (2 * ty + r) * IWS + 4 * tx2, &v[r][0]);
        load4(cw + (2 * ty + r) * IWS + 4 * tx2 + 4, &v[r][4]);
      }
      float acc[2][2][4];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int f = 0; f < 4; ++f) acc[q][s][f] = 0.f;
#pragma unroll
      for (int di = 0; di < 5; ++di)
#pragma unroll
        for (int dj = 0; dj < 5; ++dj) {
          const float2 wv =
              *reinterpret_cast<const float2*>(w1s + ((di * 5 + dj) * G + g) * 2);
          const float ws[2] = {wv.x, wv.y};
#pragma unroll
          for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int s = 0; s < 2; ++s) {
              acc[q][s][0] += v[di][2 * q + dj] * ws[s];
              acc[q][s][1] += v[di][2 * q + dj + 1] * ws[s];
              acc[q][s][2] += v[di + 1][2 * q + dj] * ws[s];
              acc[q][s][3] += v[di + 1][2 * q + dj + 1] * ws[s];
            }
        }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float mx = -INFINITY;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const float bv = bs[s * G + g];
          const float* a = acc[q][s];
          mx = fmaxf(mx, fmaxf(fmaxf(a[0] + bv, a[1] + bv),
                               fmaxf(a[2] + bv, a[3] + bv)));
        }
        st[g * SP + ty * TX + 2 * tx2 + q] = to_f(from_f<T>(mx));
      }
    }
    __syncthreads();

    // stage 2: 4 pixels x 4 pairs (j, j + C2/2); a warp's 32 items span
    // the tile's 16 pixel groups for 2 pair groups, so its stem reads are
    // 16 distinct float4 and its weight reads 2 (shared-memory bandwidth
    // bounds this stage)
    const int rest = tile / tiles_x;
    const int b = rest / tiles_y;
    const int py0 = (rest % tiles_y) * TY, px0 = (tile % tiles_x) * TX;
    for (int item = tid; item < (TY * TX / 4) * NJ; item += S2_THREADS) {
      const int pg = item % (TY * TX / 4), jg = item / (TY * TX / 4);
      float acc[4][8];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int f = 0; f < 8; ++f) acc[p][f] = 0.f;
#pragma unroll 8
      for (int k = 0; k < G; ++k) {
        const float4 sv = *reinterpret_cast<const float4*>(st + k * SP + 4 * pg);
        const float4* wp =
            reinterpret_cast<const float4*>(w2s + (k * half2 + 4 * jg) * 2);
        const float4 wa = wp[0], wb = wp[1];
        const float s4[4] = {sv.x, sv.y, sv.z, sv.w};
        const float w8[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int f = 0; f < 8; ++f) acc[p][f] += s4[p] * w8[f];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int pix = 4 * pg + p;
        const int py = py0 + pix / TX, px = px0 + pix % TX;
        if (py >= Ho || px >= Wo) continue;
        float o4[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = 4 * jg + r;
          o4[r] = fmaxf(acc[p][2 * r] + b2s[j], acc[p][2 * r + 1] + b2s[j + half2]);
        }
        store4(out + (((size_t)b * Ho + py) * Wo + px) * half2 + 4 * jg, o4);
      }
    }
  }
}

template <typename T>
int launch2(const void* x, const void* w, const void* bias, const void* w2,
            const void* b2, void* out, int B, int H, int W, int C, int C2,
            void* stream) {
  if (C != S2_C || C2 != S2_C2) return (int)cudaErrorInvalidValue;
  static GridCache cache;
  const int smem = stem2_smem_of(C, C2, (int)sizeof(T));
  auto kern = &stem2_kernel<T>;
  int grid = 0;
  cudaError_t e = persistent_grid(kern, S2_THREADS, smem, tiles_of(B, H, W),
                                  cache, &grid);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, S2_THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const float*)w, (const float*)bias, (const float*)w2,
      (const float*)b2, (T*)out, B, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, H, W] (f32 or bf16, H and W even), w [25, C] f32 and bias [C] f32
// (the stem, mfm2), w2 [C/2, C2/2, 2] f32 (conv2a pairs j, j + C2/2),
// b2 [C2] f32, all rounded to x's dtype by the caller; out [B, H/2, W/2,
// C2/2] in x's dtype. C = C2 = 96 (LightCNN9's conv1 and conv2a) only.
extern "C" int stem2_conv_f32(const void* x, const void* w, const void* bias,
                              const void* w2, const void* b2, void* out,
                              int B, int H, int W, int C, int C2,
                              void* stream) {
  return launch2<float>(x, w, bias, w2, b2, out, B, H, W, C, C2, stream);
}

extern "C" int stem2_conv_bf16(const void* x, const void* w, const void* bias,
                               const void* w2, const void* b2, void* out,
                               int B, int H, int W, int C, int C2,
                               void* stream) {
  return launch2<__nv_bfloat16>(x, w, bias, w2, b2, out, B, H, W, C, C2,
                                stream);
}


// Kernel B3. x [B, H, W] (f32 or bf16, H and W even, the pointer aligned
// to an element pair), w [25, C] f32 (5x5 taps row-major, already rounded
// to x's dtype by the caller), bias [C] f32, out [B, H/2, W/2, C_out] in
// x's dtype. f32 runs on the CUDA cores, bf16 on the tensor cores, each
// with C=99/efm3 compiled in and other widths read at run time.
extern "C" int stem_conv_maxout_pool_f32(const void* x, const void* w,
                                         const void* bias, void* out, int B,
                                         int H, int W, int C, int maxout,
                                         void* stream) {
  const float* xf = (const float*)x;
  const float* wf = (const float*)w;
  const float* bf = (const float*)bias;
  float* of = (float*)out;
  if (compiled_width(C, maxout))
    return launch_f32<3, CW_G>(xf, wf, bf, of, B, H, W, C, stream);
  return maxout == 3 ? launch_f32<3, 0>(xf, wf, bf, of, B, H, W, C, stream)
                     : launch_f32<2, 0>(xf, wf, bf, of, B, H, W, C, stream);
}

extern "C" int stem_conv_maxout_pool_bf16(const void* x, const void* w,
                                          const void* bias, void* out, int B,
                                          int H, int W, int C, int maxout,
                                          void* stream) {
  const __nv_bfloat16* xb = (const __nv_bfloat16*)x;
  const float* wf = (const float*)w;
  const float* bf = (const float*)bias;
  __nv_bfloat16* ob = (__nv_bfloat16*)out;
  if (compiled_width(C, maxout))
    return launch_tc<3, CW_G>(xb, wf, bf, ob, B, H, W, C, stream);
  return maxout == 3 ? launch_tc<3, 0>(xb, wf, bf, ob, B, H, W, C, stream)
                     : launch_tc<2, 0>(xb, wf, bf, ob, B, H, W, C, stream);
}

// The dynamic shared memory a B3 launch of these widths takes
extern "C" int stem_smem_bytes(int C, int maxout, int bf16) {
  const bool compiled = compiled_width(C, maxout);
  return bf16 ? tc_smem_of(C, maxout, compiled)
              : f32_smem_of(C, maxout, compiled);
}

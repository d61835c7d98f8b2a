// Kernel B3: the fused stem. 5x5 SAME conv of a one-channel image, bias,
// then mfm2 or efm3, then the 2x2/2 max-pool, in one pass.
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
// What bounds it on the H100: at the serving shape (B=16, 64x64, C=99,
// maxout 3) it reads 256 KB of image, writes 4.3 MB of activations (f32)
// and does 0.32 GFLOP of f32 FMAs: 70 FLOP per byte, above the f32 ridge
// of 20 (the published 67 TFLOP/s non-tensor-core rate over 3.35 TB/s), so
// f32 operations bound it. The TPU kernel went to the MXU through an im2col
// tensor; a K=25 (36 after s2d) contraction is too shallow to feed wgmma
// well, and the im2col tensor would cost 36x the image in device memory.
//
// What the design does about it: no im2col in device memory. A CTA owns an
// 8x8 tile of pooled pixels; it stages the 20x20 input window (with the
// SAME zero halo) and the whole [25, C] weight matrix in shared memory,
// once. Each thread owns one (pooled pixel, output channel) item: it keeps
// the 6x6 input window in registers, forms the 4 phase sums of each of its
// 2 or 3 channels with register FMAs, applies bias and maxout, takes the
// phase max, and writes only the pooled result. Adjacent threads own
// adjacent channels, so weight reads hit distinct banks and the stores
// are contiguous.
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

namespace {

constexpr int TY = 8;  // pooled rows per CTA
constexpr int TX = 8;  // pooled cols per CTA
constexpr int IH = 2 * TY + 4;
constexpr int IW = 2 * TX + 4;
constexpr int THREADS = 256;

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

template <typename T, int MAXOUT>
__global__ void __launch_bounds__(THREADS)
stem_kernel(const T* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ bias, T* __restrict__ out, int H, int W,
            int C) {
  extern __shared__ float sm[];
  float* win = sm;             // [IH, IW] input window, zero halo
  float* ws = win + IH * IW;   // [25, C] taps
  float* bs = ws + 25 * C;     // [C]

  const int b = blockIdx.z;
  const int py0 = blockIdx.y * TY, px0 = blockIdx.x * TX;
  const int Ho = H / 2, Wo = W / 2;
  const int iy0 = 2 * py0 - 2, ix0 = 2 * px0 - 2;
  const T* xb = x + (size_t)b * H * W;
  for (int k = threadIdx.x; k < IH * IW; k += THREADS) {
    const int iy = iy0 + k / IW, ix = ix0 + k % IW;
    win[k] = (iy >= 0 && iy < H && ix >= 0 && ix < W)
                 ? to_f(xb[(size_t)iy * W + ix])
                 : 0.0f;
  }
  for (int k = threadIdx.x; k < 25 * C; k += THREADS) ws[k] = w[k];
  for (int k = threadIdx.x; k < C; k += THREADS) bs[k] = bias[k];
  __syncthreads();

  const int G = C / MAXOUT;  // output channels per maxout slice
  const int Cout = (MAXOUT == 3) ? 2 * G : G;
  for (int item = threadIdx.x; item < TY * TX * G; item += THREADS) {
    const int g = item % G;
    const int p = item / G;
    const int ty = p / TX, tx = p % TX;
    const int py = py0 + ty, px = px0 + tx;
    if (py >= Ho || px >= Wo) continue;
    float v[6][6];
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int c = 0; c < 6; ++c) v[r][c] = win[(2 * ty + r) * IW + 2 * tx + c];

    float mx = -INFINITY;
    float mn[4] = {INFINITY, INFINITY, INFINITY, INFINITY};
#pragma unroll
    for (int s = 0; s < MAXOUT; ++s) {
      const int ch = s * G + g;
      float a00 = 0.f, a01 = 0.f, a10 = 0.f, a11 = 0.f;
#pragma unroll
      for (int di = 0; di < 5; ++di)
#pragma unroll
        for (int dj = 0; dj < 5; ++dj) {
          const float wv = ws[(di * 5 + dj) * C + ch];
          a00 += v[di][dj] * wv;
          a01 += v[di][dj + 1] * wv;
          a10 += v[di + 1][dj] * wv;
          a11 += v[di + 1][dj + 1] * wv;
        }
      const float bv = bs[ch];
      const float ph[4] = {a00 + bv, a01 + bv, a10 + bv, a11 + bv};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        mx = fmaxf(mx, ph[q]);
        mn[q] = fminf(mn[q], ph[q]);
      }
    }
    T* o = out + (((size_t)b * Ho + py) * Wo + px) * Cout;
    o[g] = from_f<T>(mx);
    if (MAXOUT == 3) {
      const float m = fmaxf(fmaxf(mn[0], mn[1]), fmaxf(mn[2], mn[3]));
      o[G + g] = from_f<T>(m);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* bias, void* out, int B,
           int H, int W, int C, int maxout, void* stream) {
  const int smem = (IH * IW + 26 * C) * (int)sizeof(float);
  dim3 grid((W / 2 + TX - 1) / TX, (H / 2 + TY - 1) / TY, B);
  auto kern = maxout == 3 ? &stem_kernel<T, 3> : &stem_kernel<T, 2>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const float*)w, (const float*)bias, (T*)out, H, W, C);
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
constexpr int IWS = 24;          // window row stride, elements: 16-byte rows
constexpr int SP = 68;           // stem tile row stride [G][SP] (64 + pad)

// B4's shared memory: w2 [G][C2/2][2] f32, w1 [25][G][2] f32, b1 [C],
// b2 [C2], the stem tile [G][SP] f32 (16-byte aligned float4 rows), then
// two input windows [IH][IWS] of T
int stem2_smem_of(int C, int C2, int tsize) {
  const int G = C / 2;
  return (G * C2 + 25 * C + C + C2 + G * SP) * 4 + 2 * IH * IWS * tsize;
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

// Stage tile `tile`'s window, zero outside the image, in element pairs
// (W and the window's first column are even, so a pair is all in or all
// out).
template <typename T>
__device__ __forceinline__ void stage_window(const T* __restrict__ x, T* win,
                                             int tile, int tiles_x,
                                             int tiles_y, int H, int W) {
  const int tx = tile % tiles_x, rest = tile / tiles_x;
  const int ty = rest % tiles_y, b = rest / tiles_y;
  const int iy0 = 2 * ty * TY - 2, ix0 = 2 * tx * TX - 2;
  const T* xb = x + (size_t)b * H * W;
  for (int k = threadIdx.x; k < IH * (IW / 2); k += S2_THREADS) {
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
  if (tile < total) stage_window(x, win, tile, tiles_x, tiles_y, H, W);
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
      stage_window(x, win + ((it + 1) & 1) * IH * IWS, next, tiles_x,
                   tiles_y, H, W);
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
  const int smem = stem2_smem_of(C, C2, (int)sizeof(T));
  auto kern = &stem2_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, S2_THREADS,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long tiles = (long long)B * ((H / 2 + TY - 1) / TY) *
                          ((W / 2 + TX - 1) / TX);
  const long long cap = (long long)sms * per_sm;
  const int grid = (int)(tiles < cap ? tiles : cap);
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

extern "C" int stem_smem_bytes(int C) {
  return (IH * IW + 26 * C) * (int)sizeof(float);
}

// x [B, H, W] (f32 or bf16), w [25, C] f32 (5x5 taps row-major, already
// rounded to x's dtype by the caller), bias [C] f32,
// out [B, H/2, W/2, C_out] in x's dtype.
extern "C" int stem_conv_maxout_pool_f32(const void* x, const void* w,
                                         const void* bias, void* out, int B,
                                         int H, int W, int C, int maxout,
                                         void* stream) {
  return launch<float>(x, w, bias, out, B, H, W, C, maxout, stream);
}

extern "C" int stem_conv_maxout_pool_bf16(const void* x, const void* w,
                                          const void* bias, void* out, int B,
                                          int H, int W, int C, int maxout,
                                          void* stream) {
  return launch<__nv_bfloat16>(x, w, bias, out, B, H, W, C, maxout, stream);
}

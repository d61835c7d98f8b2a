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
// memory as an [8x8 pixels, C/2] tile and is multiplied by the [C/2, C2]
// conv2a weights (18 KB f32 for LightCNN9), also in shared memory; each
// thread owns one pixel and 4 mfm2 pairs (j, j + C2/2), so the mfm2 runs
// in registers and only [pixels, C2/2] reaches device memory. At the path
// shape (B=128, 112x96, C=96, C2=96) it does ~9.8 GFLOP for ~72 MB: f32
// operations bound it (0.146 ms at 67 TFLOP/s) as they bound B3.

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

// B4's shared memory in floats: w2 [G][C2/2][2] first (16-byte aligned
// float4 reads), then taps, biases, the window and the stem tile [64][G+1]
int stem2_smem_floats(int C, int C2) {
  const int G = C / 2;
  return G * C2 + 25 * C + C + C2 + IH * IW + TY * TX * (G + 1);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
stem2_kernel(const T* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ bias, const float* __restrict__ w2,
             const float* __restrict__ b2, T* __restrict__ out, int H, int W,
             int C, int C2) {
  extern __shared__ __align__(16) float sm2[];
  const int G = C / 2, half2 = C2 / 2, SS = G + 1;
  float* w2s = sm2;             // [G][half2][2]
  float* ws = w2s + G * C2;     // [25, C]
  float* bs = ws + 25 * C;      // [C]
  float* b2s = bs + C;          // [C2]
  float* win = b2s + C2;        // [IH, IW]
  float* st = win + IH * IW;    // [TY*TX][G + 1] stem tile

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
  for (int k = threadIdx.x; k < G * C2; k += THREADS) w2s[k] = w2[k];
  for (int k = threadIdx.x; k < C2; k += THREADS) b2s[k] = b2[k];
  __syncthreads();

  // stage 1: the B3 stem with mfm2, into the tile (rounded to T)
  for (int item = threadIdx.x; item < TY * TX * G; item += THREADS) {
    const int g = item % G;
    const int p = item / G;
    const int ty = p / TX, tx = p % TX;
    float v[6][6];
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int c = 0; c < 6; ++c) v[r][c] = win[(2 * ty + r) * IW + 2 * tx + c];
    float mx = -INFINITY;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
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
      mx = fmaxf(mx, fmaxf(fmaxf(a00 + bv, a01 + bv), fmaxf(a10 + bv, a11 + bv)));
    }
    st[p * SS + g] = to_f(from_f<T>(mx));
  }
  __syncthreads();

  // stage 2: 1x1 conv + bias + mfm2; an item is one pixel x 4 pairs
  const int NJ = half2 / 4;
  for (int item = threadIdx.x; item < TY * TX * NJ; item += THREADS) {
    const int jg = item % NJ;
    const int p = item / NJ;
    const int py = py0 + p / TX, px = px0 + p % TX;
    if (py >= Ho || px >= Wo) continue;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < G; ++k) {
      const float sv = st[p * SS + k];
      const float4* wp =
          reinterpret_cast<const float4*>(w2s + (k * half2 + 4 * jg) * 2);
      const float4 wa = wp[0], wb = wp[1];
      acc[0] += sv * wa.x;
      acc[1] += sv * wa.y;
      acc[2] += sv * wa.z;
      acc[3] += sv * wa.w;
      acc[4] += sv * wb.x;
      acc[5] += sv * wb.y;
      acc[6] += sv * wb.z;
      acc[7] += sv * wb.w;
    }
    T* o = out + (((size_t)b * Ho + py) * Wo + px) * half2;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = 4 * jg + r;
      o[j] = from_f<T>(fmaxf(acc[2 * r] + b2s[j], acc[2 * r + 1] + b2s[j + half2]));
    }
  }
}

template <typename T>
int launch2(const void* x, const void* w, const void* bias, const void* w2,
            const void* b2, void* out, int B, int H, int W, int C, int C2,
            void* stream) {
  const int smem = stem2_smem_floats(C, C2) * (int)sizeof(float);
  dim3 grid((W / 2 + TX - 1) / TX, (H / 2 + TY - 1) / TY, B);
  auto kern = &stem2_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const float*)w, (const float*)bias, (const float*)w2,
      (const float*)b2, (T*)out, H, W, C, C2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int stem2_smem_bytes(int C, int C2) {
  return stem2_smem_floats(C, C2) * (int)sizeof(float);
}

// x [B, H, W] (f32 or bf16, H and W even), w [25, C] f32 and bias [C] f32
// (the stem, mfm2), w2 [C/2, C2/2, 2] f32 (conv2a pairs j, j + C2/2),
// b2 [C2] f32, all rounded to x's dtype by the caller; out [B, H/2, W/2,
// C2/2] in x's dtype. C2/2 must divide by 4.
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

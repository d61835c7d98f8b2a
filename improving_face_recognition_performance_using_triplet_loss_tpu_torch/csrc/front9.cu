// Kernel B6: LightCNN9's front half in one pass. conv1 (5x5 SAME, Cin=1) +
// mfm2 + 2x2/2 pool -> conv2a (1x1) + mfm2 -> conv2 (3x3 SAME) + mfm2 ->
// 2x2/2 pool. x [B, H, W] -> out [B, H/4, W/4, C2/2].
//
// Replaces: ops/pallas/front_kernel.py::front9_chain_pallas of the JAX
// package (one whole image's chain resident in VMEM per grid step, the
// convs as MXU dots over an s2d im2col of the input).
//
// Semantics: stem = mfm2 + pool of the f32 conv1 sums plus f32 bias;
// a = mfm2(stem . w2a + b2a); y = mfm2(conv3x3(a) + b2); out = pool(y).
// conv2's SAME padding reads zeros outside the image (not conv2a evaluated
// there), and the stem's padding reads zero input pixels. Each stage's
// output is rounded to the input dtype where the Pallas kernel rounds it
// (stem, conv2a, conv2); sums are f32.
//
// What bounds it on the H100: at the extraction shape (B=128, 128x128,
// C1=96, C2a=96, C2=192) it does ~102 GFLOP (85% of it conv2) for 8.4 MB
// in and 50 MB out: ~1,700 FLOP per byte, far above the f32 ridge of 20,
// so f32 operations bound it (1.52 ms at 67 TFLOP/s). The TPU design does
// not carry over: one image's f32 stem output alone is 786 KB, and a block
// has at most 227 KB of shared memory; conv2's f32 weights are 332 KB.
//
// What the design does about it: spatial tiles with recomputed halos. A
// CTA owns T x T pooled outputs (T = 8): the (2T+2)^2 stem and conv2a
// positions around its 2T x 2T conv2 outputs, from a (4T+8)^2 input window.
// The halo costs 27% more stem + conv2a work, ~4% of the total. Stem and
// conv2a outputs live in shared memory (conv2a channel-major, positions
// outside the image zeroed for conv2's padding); nothing but the pooled
// result is written to device memory. conv2 runs over its output channels
// in chunks of 16 mfm2 pairs (channel j with j + C2/2) whose [9*C2a/2, 16,
// 2] weight slice is streamed into the shared memory the stem stage used.
// Each thread owns one pooled pixel (a 2x2 block of conv2 outputs) and 4
// pairs: per input channel it loads a 4x4 window of conv2a values into
// registers and does 9 taps x 4 positions x 8 channels = 288 FMAs from 16
// + 18 shared loads, then mfm2 and the pool in registers. No tensor cores:
// the kernel keeps full f32 products (TF32 off), like B1 and B3. This file
// serves f32; the bf16 version runs on the tensor cores (front9_tc.cu).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int T = 8;            // pooled outputs per CTA side
constexpr int NH = 2 * T + 2;   // stem / conv2a positions per side (halo)
constexpr int NPOS = NH * NH;   // 324
constexpr int IN = 2 * NH + 4;  // input window side (4T + 8)
constexpr int THREADS = 256;    // 64 pooled pixels x 4 pair groups
constexpr int PAIRS = 16;       // conv2 mfm2 pairs per weight chunk
constexpr int PPT = 4;          // pairs per thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T_>
__device__ __forceinline__ T_ from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// a value rounded to T_ and held as f32 (where the Pallas kernel rounds)
template <typename T_>
__device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T_>(v));
}

struct Layout {  // shared-memory offsets in floats
  int a, w2a, s, ss, win, w1, b1, b2a, total;
};

__host__ __device__ inline Layout layout(int C1, int C2a) {
  const int G = C1 / 2, ca = C2a / 2;
  Layout L;
  L.a = 0;                       // conv2a tile [ca][NPOS]
  L.w2a = L.a + ca * NPOS;       // [G][ca][2]   (stages 1-2)
  L.ss = G + 1;                  // stem tile row stride (padded)
  L.s = L.w2a + G * C2a;         // stem tile [NPOS][G + 1]
  L.win = L.s + NPOS * L.ss;     // input window [IN][IN]
  L.w1 = L.win + IN * IN;        // [25][C1]
  L.b1 = L.w1 + 25 * C1;
  L.b2a = L.b1 + C1;
  const int stage12 = L.b2a + C2a - L.w2a;
  const int stage3 = 9 * ca * PAIRS * 2;  // a conv2 weight chunk at L.w2a
  L.total = L.w2a + (stage12 > stage3 ? stage12 : stage3);
  return L;
}

template <typename T_>
__global__ void __launch_bounds__(THREADS)
front9_kernel(const T_* __restrict__ x, const float* __restrict__ w1,
              const float* __restrict__ b1, const float* __restrict__ w2a,
              const float* __restrict__ b2a, const float* __restrict__ w2,
              const float* __restrict__ b2, T_* __restrict__ out, int H,
              int W, int C1, int C2a, int C2) {
  extern __shared__ __align__(16) float sm[];
  const Layout L = layout(C1, C2a);
  float* A = sm + L.a;
  float* W2A = sm + L.w2a;
  float* S = sm + L.s;
  float* win = sm + L.win;
  float* W1 = sm + L.w1;
  float* B1 = sm + L.b1;
  float* B2A = sm + L.b2a;
  float* W2 = sm + L.w2a;  // stage 3 reuses the stage 1-2 region

  const int G = C1 / 2, ca = C2a / 2, half2 = C2 / 2;
  const int H2 = H / 2, W2_ = W / 2, H4 = H / 4, W4 = W / 4;
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * T, ox0 = blockIdx.x * T;  // pooled origin
  const int hy0 = 2 * oy0 - 1, hx0 = 2 * ox0 - 1;        // halo origin (H/2)
  const int iy0 = 2 * hy0 - 2, ix0 = 2 * hx0 - 2;        // window origin
  const int tid = threadIdx.x;

  // ---- load: input window (zero outside the image), stage 1-2 weights
  const T_* xb = x + (size_t)b * H * W;
  for (int k = tid; k < IN * IN; k += THREADS) {
    const int iy = iy0 + k / IN, ix = ix0 + k % IN;
    win[k] = (iy >= 0 && iy < H && ix >= 0 && ix < W)
                 ? to_f(xb[(size_t)iy * W + ix])
                 : 0.0f;
  }
  for (int k = tid; k < 25 * C1; k += THREADS) W1[k] = w1[k];
  for (int k = tid; k < C1; k += THREADS) B1[k] = b1[k];
  for (int k = tid; k < G * C2a; k += THREADS) W2A[k] = w2a[k];
  for (int k = tid; k < C2a; k += THREADS) B2A[k] = b2a[k];
  __syncthreads();

  // ---- stage 1: stem (conv1 + mfm2 + pool) at every inside halo position;
  // an item is one position and 4 channels g4 + i * (G/4)
  const int NG = G / 4;
  for (int item = tid; item < NPOS * NG; item += THREADS) {
    const int pos = item / NG, g4 = item % NG;
    const int hy = pos / NH, hx = pos % NH;
    const int cy = hy0 + hy, cx = hx0 + hx;
    if (cy < 0 || cy >= H2 || cx < 0 || cx >= W2_) continue;
    float v[6][6];
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int c = 0; c < 6; ++c) v[r][c] = win[(2 * hy + r) * IN + 2 * hx + c];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int g = g4 + i * NG;
      float mx = -INFINITY;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int ch = s * G + g;
        float a00 = 0.f, a01 = 0.f, a10 = 0.f, a11 = 0.f;
#pragma unroll
        for (int di = 0; di < 5; ++di)
#pragma unroll
          for (int dj = 0; dj < 5; ++dj) {
            const float wv = W1[(di * 5 + dj) * C1 + ch];
            a00 += v[di][dj] * wv;
            a01 += v[di][dj + 1] * wv;
            a10 += v[di + 1][dj] * wv;
            a11 += v[di + 1][dj + 1] * wv;
          }
        const float bv = B1[ch];
        mx = fmaxf(mx, fmaxf(fmaxf(a00 + bv, a01 + bv), fmaxf(a10 + bv, a11 + bv)));
      }
      S[pos * L.ss + g] = rnd<T_>(mx);
    }
  }
  __syncthreads();

  // ---- stage 2: conv2a (1x1) + mfm2 into A, channel-major; positions
  // outside the image are conv2's zero padding. An item is 4 positions x
  // 4 pairs (j, j + ca), j = 4 * jg + r.
  const int NJ = ca / 4;
  for (int item = tid; item < (NPOS / 4) * NJ; item += THREADS) {
    const int pg = item / NJ, jg = item % NJ;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[i][r] = 0.f;
    for (int k = 0; k < G; ++k) {
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = S[(4 * pg + i) * L.ss + k];
      const float4* wp =
          reinterpret_cast<const float4*>(W2A + (k * ca + 4 * jg) * 2);
      const float4 wa = wp[0], wb = wp[1];
      const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int r = 0; r < 8; ++r) acc[i][r] += sv[i] * wv[r];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pos = 4 * pg + i;
      const int cy = hy0 + pos / NH, cx = hx0 + pos % NH;
      const bool inside = cy >= 0 && cy < H2 && cx >= 0 && cx < W2_;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = 4 * jg + r;
        const float m = fmaxf(acc[i][2 * r] + B2A[j], acc[i][2 * r + 1] + B2A[j + ca]);
        A[j * NPOS + pos] = inside ? rnd<T_>(m) : 0.0f;
      }
    }
  }

  // ---- stage 3: conv2 (3x3) + mfm2 + pool, over chunks of PAIRS pairs
  const int q = tid % (PAIRS / PPT);  // pair group in the chunk
  const int pix = tid / (PAIRS / PPT);
  const int ty = pix / T, tx = pix % T;
  const int oy = oy0 + ty, ox = ox0 + tx;
  const bool valid = oy < H4 && ox < W4;
  T_* o = out + (((size_t)b * H4 + oy) * W4 + ox) * half2;
  const int chunk_floats = 9 * ca * PAIRS * 2;
  for (int c0 = 0; c0 < half2; c0 += PAIRS) {
    __syncthreads();  // stage 2 done / previous chunk read
    const float4* src =
        reinterpret_cast<const float4*>(w2 + (size_t)(c0 / PAIRS) * chunk_floats);
    float4* dst = reinterpret_cast<float4*>(W2);
    for (int k = tid; k < chunk_floats / 4; k += THREADS) dst[k] = src[k];
    __syncthreads();
    float acc[4][8];  // [2x2 position][pair r lo/hi]
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[p][r] = 0.f;
    for (int ci = 0; ci < ca; ++ci) {
      float a[4][4];
      const float* ap = A + ci * NPOS + (2 * ty) * NH + 2 * tx;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) a[r][s] = ap[r * NH + s];
#pragma unroll
      for (int di = 0; di < 3; ++di)
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) {
          const float4* wp = reinterpret_cast<const float4*>(
              W2 + ((di * 3 + dj) * ca + ci) * (PAIRS * 2) + q * (PPT * 2));
          const float4 wa = wp[0], wb = wp[1];
          const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int pa = 0; pa < 2; ++pa)
#pragma unroll
            for (int pb = 0; pb < 2; ++pb) {
              const float av = a[pa + di][pb + dj];
#pragma unroll
              for (int r = 0; r < 8; ++r) acc[pa * 2 + pb][r] += av * wv[r];
            }
        }
    }
    if (valid) {
#pragma unroll
      for (int r = 0; r < PPT; ++r) {
        const int j = c0 + q * PPT + r;
        const float blo = __ldg(b2 + j), bhi = __ldg(b2 + j + half2);
        float m = -INFINITY;
#pragma unroll
        for (int p = 0; p < 4; ++p)
          m = fmaxf(m, fmaxf(acc[p][2 * r] + blo, acc[p][2 * r + 1] + bhi));
        o[j] = from_f<T_>(m);
      }
    }
  }
}

template <typename T_>
int launch(const void* x, const void* w1, const void* b1, const void* w2a,
           const void* b2a, const void* w2, const void* b2, void* out, int B,
           int H, int W, int C1, int C2a, int C2, void* stream) {
  const int smem = layout(C1, C2a).total * (int)sizeof(float);
  dim3 grid((W / 4 + T - 1) / T, (H / 4 + T - 1) / T, B);
  auto kern = &front9_kernel<T_>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const T_*)x, (const float*)w1, (const float*)b1, (const float*)w2a,
      (const float*)b2a, (const float*)w2, (const float*)b2, (T_*)out, H, W,
      C1, C2a, C2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int front9_smem_bytes(int C1, int C2a) {
  return layout(C1, C2a).total * (int)sizeof(float);
}

extern "C" int front9_tile() { return T; }
extern "C" int front9_pairs_per_chunk() { return PAIRS; }

// x [B, H, W] f32 (H and W multiples of 4; bf16 runs on the tensor cores,
// front9_tc.cu); weights f32: w1 [25, C1], b1 [C1], w2a [C1/2,
// C2a/2, 2] (pairs j, j + C2a/2), b2a [C2a], w2 [C2/32, 9 * C2a/2, 16, 2]
// (chunks of 16 pairs j, j + C2/2), b2 [C2]; out [B, H/4, W/4, C2/2] in
// x's dtype. C1/2 and C2a/2 must divide by 4, C2/2 by 16.
extern "C" int front9_f32(const void* x, const void* w1, const void* b1,
                          const void* w2a, const void* b2a, const void* w2,
                          const void* b2, void* out, int B, int H, int W,
                          int C1, int C2a, int C2, void* stream) {
  return launch<float>(x, w1, b1, w2a, b2a, w2, b2, out, B, H, W, C1, C2a,
                       C2, stream);
}

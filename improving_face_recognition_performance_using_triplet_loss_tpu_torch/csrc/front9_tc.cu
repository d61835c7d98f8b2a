// Kernel B6 in bf16 on the tensor cores: LightCNN9's front half in one
// pass. conv1 (5x5 SAME, Cin=1) + mfm2 + 2x2/2 pool -> conv2a (1x1) + mfm2
// -> conv2 (3x3 SAME) + mfm2 -> 2x2/2 pool. x [B, H, W] bf16 -> out
// [B, H/4, W/4, 96] bf16, at LightCNN9's widths (conv1 96, conv2a 96,
// conv2 192). The f32 version stays on the CUDA cores (front9.cu).
//
// Replaces: ops/pallas/front_kernel.py::front9_chain_pallas of the JAX
// package, in bfloat16 (one whole image's chain resident in VMEM per grid
// step, the convs as MXU dots with f32 sums).
//
// Semantics, rounding where the Pallas kernel rounds: stem = bf16(phase max
// and mfm2 of the f32 conv1 sums + bias); a = bf16(mfm2(stem . w2a + b2a)),
// zero outside the image for conv2's SAME padding; out = bf16(pool(mfm2(
// conv3x3(a) + b2))). Every product of two bf16 values is exact in f32, so
// the result differs from the plain version only by the order of the f32
// sums (and a bf16 rounding that this order may tip).
//
// What bounds it on the H100: operations. At the extraction shape (B=128,
// 128x128) it does 101.9 GFLOP (85% of it conv2, a 432-deep product of 192
// columns) for ~29.6 MB of bf16 traffic: 0.103 ms at the 989 TFLOP/s of the
// bf16 tensor cores, 0.009 ms at 3.35 TB/s.
//
// What the design does about it: all three convs are GEMMs on the tensor
// cores (mma.sync.m16n8k16, bf16 in, f32 sums), in the f32 kernel's
// spatial tiling: a tile owns 8x8 pooled outputs and recomputes its halo
// (18x18 stem and conv2a positions from a 40x40 input window).
// - conv1 is an im2col GEMM per tile: M = 1296 full-resolution positions,
//   K = 25 taps padded to 32, N = 96. The A fragments are gathered from the
//   bf16 input window with one shared load per value (a thread's 8 tap
//   offsets are fixed). M rows are ordered (dy, s, dx) within each m16 tile
//   so that a thread's two rows are the pool's dy pair and lanes g, g^1 its
//   dx pair: the pool is a register max and one shuffle.
// - conv2a (1x1): M = 324 halo positions, K = 48, N = 96, A by ldmatrix from
//   the stem tile; each warp owns whole 16-row blocks, so its output
//   overwrites its own stem rows in place (one 36 KB tile for both).
// - conv2: an implicit GEMM of M = 256 conv2 positions, N = 192, K = 9 taps
//   x 48 channels = 27 k16 steps. A is the 3x3-shifted window of the conv2a
//   tile, loaded by ldmatrix: it takes one row address per lane, so a tap's
//   shift is only an address offset (rows 112 B apart: conflict-free). Two
//   passes over N halves; per pass the 8 warps tile M x N as 4 x 2 (64 x 48
//   each, 96 f32 accumulators a thread). M rows are ordered as for the stem,
//   so mfm2 and the 2x2 pool happen in registers and one shuffle, and only
//   the pooled bf16 result is written to device memory.
// - Weights resident: the grid is persistent (one CTA per SM looping over
//   the tiles), and every CTA loads all weights into shared memory once, in
//   the B-fragment order of mma.sync (a lane's two n8 tiles of a k16 step in
//   one 16-byte load, conflict-free): conv2 166 KB, conv2a 9 KB, conv1 6 KB.
//   Columns 2j and 2j+1 of each GEMM are channels j and j + C/2, so a
//   thread's accumulator pair is an mfm2 pair. With the tile and window
//   that is 222,272 B of the 232,448 a CTA may use.
// mma.sync and not wgmma: wgmma's A from shared memory needs the canonical
// layout, which a shifted 3x3 window is not; wgmma with A in registers is
// the next step (ROADMAP B).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 8;              // pooled outputs per tile side
constexpr int NH = 2 * T + 2;     // 18: stem / conv2a positions per side
constexpr int NPOS = NH * NH;     // 324
constexpr int IN = 2 * NH + 4;    // 40: input window side
constexpr int C1 = 96, G = C1 / 2;      // conv1 channels, stem channels
constexpr int C2A = 96, CA = C2A / 2;   // conv2a channels, after mfm2
constexpr int C2 = 192, P2 = C2 / 2;    // conv2 channels, output channels
constexpr int THREADS = 256;
constexpr int ROW = 56;           // tile row stride in bf16 (112 B)
constexpr int KS1 = 2, KS2A = G / 16, KS2 = 9 * CA / 16;  // k16 steps
constexpr int NP1 = C1 / 16, NP2A = C2A / 16, NP2 = C2 / 16;  // n8 pairs
constexpr int FRAG = 32 * 16;     // bytes of one (k step, n8 pair) block

// shared memory, in bytes
constexpr int SM_W2 = 0;
constexpr int SM_W1 = SM_W2 + KS2 * NP2 * FRAG;
constexpr int SM_W2A = SM_W1 + KS1 * NP1 * FRAG;
constexpr int SM_BIAS = SM_W2A + KS2A * NP2A * FRAG;
constexpr int SM_TILE = SM_BIAS + (C1 + C2A + C2) * 4;
constexpr int SM_WIN = SM_TILE + NPOS * ROW * 2;
constexpr int SM_TOTAL = SM_WIN + IN * IN * 2;
static_assert(SM_TILE % 16 == 0, "ldmatrix rows must be 16-byte aligned");
static_assert(SM_TOTAL <= 232448, "over a CTA's shared memory");

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

// acc[.][4] of one n8 tile -> the mfm2 max of rows g and g + 8 (the pool's
// dy pair), with the pair's biases
__device__ __forceinline__ float mfm_dy(const float (&c)[4], float blo,
                                        float bhi) {
  return fmaxf(fmaxf(c[0] + blo, c[1] + bhi), fmaxf(c[2] + blo, c[3] + bhi));
}

__global__ void __launch_bounds__(THREADS, 1)
front9_tc_kernel(const uint16_t* __restrict__ x, const uint4* __restrict__ w1,
                 const uint4* __restrict__ w2a, const uint4* __restrict__ w2,
                 const float* __restrict__ b1, const float* __restrict__ b2a,
                 const float* __restrict__ b2, __nv_bfloat16* __restrict__ out,
                 int B, int H, int W) {
  extern __shared__ __align__(16) unsigned char sm[];
  uint4* W2s = reinterpret_cast<uint4*>(sm + SM_W2);
  uint4* W1s = reinterpret_cast<uint4*>(sm + SM_W1);
  uint4* W2As = reinterpret_cast<uint4*>(sm + SM_W2A);
  float* B1 = reinterpret_cast<float*>(sm + SM_BIAS);
  float* B2A = B1 + C1;
  float* B2 = B2A + C2A;
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(sm + SM_TILE);
  uint16_t* win = reinterpret_cast<uint16_t*>(sm + SM_WIN);  // bf16 bits
  const uint32_t tile_s =
      static_cast<uint32_t>(__cvta_generic_to_shared(tile));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  // ---- weights, once per CTA
  for (int i = tid; i < KS2 * NP2 * 32; i += THREADS) W2s[i] = w2[i];
  for (int i = tid; i < KS1 * NP1 * 32; i += THREADS) W1s[i] = w1[i];
  for (int i = tid; i < KS2A * NP2A * 32; i += THREADS) W2As[i] = w2a[i];
  for (int i = tid; i < C1; i += THREADS) B1[i] = b1[i];
  for (int i = tid; i < C2A; i += THREADS) B2A[i] = b2a[i];
  for (int i = tid; i < C2; i += THREADS) B2[i] = b2[i];

  const int H2 = H / 2, W2_ = W / 2, H4 = H / 4, W4 = W / 4;
  const int tiles_x = (W4 + T - 1) / T, tiles_y = (H4 + T - 1) / T;
  const int per_img = tiles_x * tiles_y, ntiles = B * per_img;

  // conv1: the window offsets of this thread's 8 A values per k16 step
  // (column k = 16 ks + 8 h + 2 t + e is tap k; taps 25..31 are zero)
  int tap_off[KS1][2][2];
  bool tap_ok[KS1][2][2];
#pragma unroll
  for (int ks = 0; ks < KS1; ++ks)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 16 * ks + 8 * h + 2 * t + e;
        tap_ok[ks][h][e] = k < 25;
        tap_off[ks][h][e] = k < 25 ? (k / 5) * IN + k % 5 : 0;
      }

  // conv2: warp (wm, wn) owns m16 tiles 4 wm .. 4 wm + 3 and, per pass, n8
  // tiles 6 wn .. 6 wn + 5 of the pass's 12. Lane l gives ldmatrix the
  // address of A row l % 16, columns 8 (l / 16) on: row r = 8 dy + 2 s + dx
  // of m16 tile mt is conv2 position (2 ty + dy, 2 tx + dx) of pooled pixel
  // P = 4 mt + s = 8 ty + tx.
  const int wm = warp & 3, wn = warp >> 2;
  uint32_t a2_off[4];
  {
    const int r = lane & 15, dy = r >> 3, s = (r & 7) >> 1, dx = r & 1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int P = 4 * (4 * wm + i) + s;
      const int cy = 2 * (P >> 3) + dy, cx = 2 * (P & 7) + dx;
      a2_off[i] = ((cy * NH + cx) * ROW + 8 * (lane >> 4)) * 2;
    }
  }

  for (int ti = blockIdx.x; ti < ntiles; ti += gridDim.x) {
    const int b = ti / per_img, rem = ti % per_img;
    const int oy0 = (rem / tiles_x) * T, ox0 = (rem % tiles_x) * T;
    const int hy0 = 2 * oy0 - 1, hx0 = 2 * ox0 - 1;  // halo origin (H/2)
    const int iy0 = 2 * hy0 - 2, ix0 = 2 * hx0 - 2;  // window origin

    __syncthreads();  // weights in; the previous tile's conv2 is done
    const uint16_t* xb = x + (size_t)b * H * W;
    for (int k = tid; k < IN * IN; k += THREADS) {
      const int iy = iy0 + k / IN, ix = ix0 + k % IN;
      win[k] = (iy >= 0 && iy < H && ix >= 0 && ix < W)
                   ? xb[(size_t)iy * W + ix]
                   : (uint16_t)0;
    }
    __syncthreads();

    // ---- stage 1: stem. m16 tile mt holds halo positions 4 mt .. 4 mt + 3;
    // this thread's rows are position p's phases (dy = 0, 1; dx = g & 1)
    for (int mt = warp; mt < NPOS / 4; mt += THREADS / 32) {
      const int p = 4 * mt + (g >> 1);
      const int r0 = 2 * (p / NH) * IN + 2 * (p % NH) + (g & 1);
      uint32_t a[KS1][4];
#pragma unroll
      for (int ks = 0; ks < KS1; ++ks)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int dy = 0; dy < 2; ++dy) {
            const int r = r0 + dy * IN;
            const uint32_t lo =
                tap_ok[ks][h][0] ? win[r + tap_off[ks][h][0]] : 0u;
            const uint32_t hi =
                tap_ok[ks][h][1] ? win[r + tap_off[ks][h][1]] : 0u;
            a[ks][2 * h + dy] = lo | (hi << 16);
          }
      float acc[2 * NP1][4];
#pragma unroll
      for (int n = 0; n < 2 * NP1; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[n][q] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS1; ++ks)
#pragma unroll
        for (int np = 0; np < NP1; ++np) {
          const uint4 bb = W1s[(ks * NP1 + np) * 32 + lane];
          mma(acc[2 * np], a[ks], bb.x, bb.y);
          mma(acc[2 * np + 1], a[ks], bb.z, bb.w);
        }
#pragma unroll
      for (int n = 0; n < 2 * NP1; ++n) {
        const int j = 4 * n + t;
        float v = mfm_dy(acc[n], B1[j], B1[j + G]);
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
        if (!(g & 1)) tile[p * ROW + j] = __float2bfloat16_rn(v);
      }
    }
    __syncthreads();

    // ---- stage 2: conv2a + mfm2, in place over the warp's own stem rows;
    // positions outside the image become conv2's zero padding
    for (int mt = warp; mt < (NPOS + 15) / 16; mt += THREADS / 32) {
      const int row = min(16 * mt + (lane & 15), NPOS - 1);
      const uint32_t addr = tile_s + (row * ROW + 8 * (lane >> 4)) * 2;
      float acc[2 * NP2A][4];
#pragma unroll
      for (int n = 0; n < 2 * NP2A; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[n][q] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS2A; ++ks) {
        uint32_t a[4];
        ldsm_x4(a, addr + 32 * ks);
#pragma unroll
        for (int np = 0; np < NP2A; ++np) {
          const uint4 bb = W2As[(ks * NP2A + np) * 32 + lane];
          mma(acc[2 * np], a, bb.x, bb.y);
          mma(acc[2 * np + 1], a, bb.z, bb.w);
        }
      }
      __syncwarp();  // every lane's reads of these rows are done
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const int p = 16 * mt + g + 8 * dy;
        if (p >= NPOS) continue;
        const int cy = hy0 + p / NH, cx = hx0 + p % NH;
        const bool inside = cy >= 0 && cy < H2 && cx >= 0 && cx < W2_;
#pragma unroll
        for (int n = 0; n < 2 * NP2A; ++n) {
          const int j = 4 * n + t;
          const float v = fmaxf(acc[n][2 * dy] + B2A[j],
                                acc[n][2 * dy + 1] + B2A[j + CA]);
          tile[p * ROW + j] = __float2bfloat16_rn(inside ? v : 0.f);
        }
      }
    }
    __syncthreads();

    // ---- stage 3: conv2 + mfm2 + pool, two passes over N halves
    for (int pass = 0; pass < 2; ++pass) {
      float acc[4][6][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < 6; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][n][q] = 0.f;
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const uint32_t toff = ((tap / 3) * NH + tap % 3) * ROW * 2;
#pragma unroll
        for (int c = 0; c < CA / 16; ++c) {
          const int ks = tap * (CA / 16) + c;
          uint32_t a[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            ldsm_x4(a[i], tile_s + a2_off[i] + toff + 32 * c);
#pragma unroll
          for (int n2 = 0; n2 < 3; ++n2) {
            const int np = pass * 6 + wn * 3 + n2;
            const uint4 bb = W2s[(ks * NP2 + np) * 32 + lane];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              mma(acc[i][2 * n2], a[i], bb.x, bb.y);
              mma(acc[i][2 * n2 + 1], a[i], bb.z, bb.w);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int P = 4 * (4 * wm + i) + (g >> 1);
        const int oy = oy0 + (P >> 3), ox = ox0 + (P & 7);
        const bool store = !(g & 1) && oy < H4 && ox < W4;
        __nv_bfloat16* o = out + (((size_t)b * H4 + oy) * W4 + ox) * P2;
#pragma unroll
        for (int n = 0; n < 6; ++n) {
          const int j = 4 * (pass * 12 + wn * 6 + n) + t;
          float v = mfm_dy(acc[i][n], B2[j], B2[j + P2]);
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
          if (store) o[j] = __float2bfloat16_rn(v);
        }
      }
    }
  }
}

}  // namespace

extern "C" int front9_tc_smem_bytes() { return SM_TOTAL; }

// x [B, H, W] bf16 (H and W multiples of 4); w1, w2a, w2 bf16 in the
// B-fragment order of pack_front9_weights_tc ([k16 steps, n8 pairs, 32
// lanes, 8]); b1 [96], b2a [96], b2 [192] f32; out [B, H/4, W/4, 96] bf16.
extern "C" int front9_tc(const void* x, const void* w1, const void* w2a,
                         const void* w2, const void* b1, const void* b2a,
                         const void* b2, void* out, int B, int H, int W,
                         void* stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(front9_tc_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SM_TOTAL);
  if (e != cudaSuccess) return (int)e;
  // persistent: one CTA per SM (or per tile, when there are fewer)
  const int tiles = B * ((H / 4 + T - 1) / T) * ((W / 4 + T - 1) / T);
  const int grid = tiles < sms ? tiles : sms;
  front9_tc_kernel<<<grid, THREADS, SM_TOTAL, (cudaStream_t)stream>>>(
      (const uint16_t*)x, (const uint4*)w1, (const uint4*)w2a,
      (const uint4*)w2, (const float*)b1, (const float*)b2a,
      (const float*)b2, (__nv_bfloat16*)out, B, H, W);
  return (int)cudaGetLastError();
}

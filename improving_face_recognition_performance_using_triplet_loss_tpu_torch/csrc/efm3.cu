// Kernel B2: the 3-way EFM activation. x [rows, C] -> out [rows, 2C/3],
// out = concat(max(s0, s1, s2), min(s0, s1, s2)) over the channel thirds,
// for f32, bf16, f16 and f64; and its backward, efm3_bwd: x [rows, C] and
// the output's gradient g [rows, 2C/3] -> dx [rows, C].
//
// Replaces: ops/pallas/mfm_kernel.py::efm3_pallas of the JAX package (the
// forward; the Pallas kernel has no backward, the JAX training step
// differentiates its plain jnp efm3, and the backward here is what that
// gradient is).
//
// Semantics: max is max(max(s0, s1), s2) and min min(min(s0, s1), s2), each
// as torch.maximum / torch.minimum computes it: NaN when either operand is
// NaN (CUDA's fmaxf would drop it), else the larger (smaller) value, the
// first operand on equal values. The result equals the plain version bit
// for bit, NaN positions included.
//
// What bounds it on the H100: device-memory bytes. It reads each input once
// and writes 2/3 of it, with two compares per output and no reuse (~0.3
// operations per byte). On the path, though, the calls are small (29 a
// forward, 16 to 16,384 rows, 3-14 us each on the card), so the host's
// launch cost is what it has to cut: the wrapper makes one ctypes call with
// plain integers, and this entry point picks the instance and the grid.
//
// What the design does about it: one pass, nothing staged. A 2-D grid, x
// over the vectors of a third and y over rows (no per-element division);
// a thread reads s0, s1, s2 of one vector and writes its max and min. The
// vector is 16 bytes when the third's byte width and both pointers allow it,
// else one element (the path's thirds: 22, 33, 44, 58, 66, 86, 87, 129, 171
// elements, mostly not 16-byte multiples).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// the type an element is compared in
__device__ __forceinline__ float val(float v) { return v; }
__device__ __forceinline__ double val(double v) { return v; }
__device__ __forceinline__ float val(__half v) { return __half2float(v); }
__device__ __forceinline__ float val(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T vmax(T a, T b) {
  const auto fa = val(a), fb = val(b);
  if (fa != fa) return a;
  if (fb != fb) return b;
  return fa < fb ? b : a;
}

template <typename T>
__device__ __forceinline__ T vmin(T a, T b) {
  const auto fa = val(a), fb = val(b);
  if (fa != fa) return a;
  if (fb != fb) return b;
  return fb < fa ? b : a;
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
efm3_kernel(const T* __restrict__ x, T* __restrict__ out, int rows,
            int third) {
  using Vt = Vec<T, V>;
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (c >= third) return;
  for (int r = blockIdx.y * blockDim.y + threadIdx.y; r < rows;
       r += gridDim.y * blockDim.y) {
    const T* src = x + (size_t)r * 3 * third + c;
    const Vt s0 = *reinterpret_cast<const Vt*>(src);
    const Vt s1 = *reinterpret_cast<const Vt*>(src + third);
    const Vt s2 = *reinterpret_cast<const Vt*>(src + 2 * third);
    Vt mx, mn;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      mx.v[i] = vmax(vmax(s0.v[i], s1.v[i]), s2.v[i]);
      mn.v[i] = vmin(vmin(s0.v[i], s1.v[i]), s2.v[i]);
    }
    T* dst = out + (size_t)r * 2 * third + c;
    *reinterpret_cast<Vt*>(dst) = mx;
    *reinterpret_cast<Vt*>(dst + third) = mn;
  }
}

template <typename T>
int launch(const void* x, void* out, int rows, int third, void* stream) {
  constexpr int V16 = 16 / sizeof(T);
  const bool wide = (third * sizeof(T)) % 16 == 0 &&
                    (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0;
  const int vecs = wide ? third / V16 : third;
  int tx = 32;
  while (tx < vecs && tx < THREADS) tx *= 2;
  const dim3 block(tx, THREADS / tx);
  const int gy = (rows + block.y - 1) / block.y;
  const dim3 grid((vecs + tx - 1) / tx, gy < 65535 ? gy : 65535);
  if (wide)
    efm3_kernel<T, V16><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const T*)x, (T*)out, rows, third);
  else
    efm3_kernel<T, 1><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const T*)x, (T*)out, rows, third);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- backward
//
// Semantics: the autograd of the plain version, bit for bit. torch's
// maximum backward gives an operand the gradient where it is the larger,
// nothing where it is the smaller, and half to each on a tie (both get the
// whole gradient where one is NaN); minimum the same with the roles
// swapped. Nested, a three-way tie sends 1/4, 1/4, 1/2 to s0, s1, s2. Each
// third's two contributions (from max and min) are added, and a zero sum
// is +0, as the plain autograd's accumulation into a zero-filled gradient
// leaves it. Every intermediate is rounded to T where torch rounds it, so
// bf16 and f16 are bit-equal too (halvings and one add: in f32 the
// arithmetic is exact).
//
// What bounds it: bytes. It reads x (3 thirds) and g (2 thirds) once and
// writes dx once, ~8 bytes a channel a row in f32 with a few compares: one
// pass, the forward's grid and vectors, nothing staged.

template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

__device__ __forceinline__ void put(float v, float& o) { o = v; }
__device__ __forceinline__ void put(double v, double& o) { o = v; }
__device__ __forceinline__ void put(float v, __half& o) {
  o = __float2half_rn(v);
}
__device__ __forceinline__ void put(float v, __nv_bfloat16& o) {
  o = __float2bfloat16_rn(v);
}

// v rounded to T
template <typename T>
__device__ __forceinline__ T rnd(typename Acc<T>::type v) {
  T o;
  put(v, o);
  return o;
}

// torch's backward of maximum(a, b) (is_max) or minimum(a, b) for the
// output gradient g: where(a == b, g / 2, g), zeroed for the operand that
// lost
template <typename T, bool is_max>
__device__ __forceinline__ void pick_bwd(T a, T b, T g, T& ga, T& gb) {
  const auto fa = val(a), fb = val(b);
  const T gh = fa == fb ? rnd<T>(val(g) * 0.5f) : g;
  const T zero = rnd<T>(0.0f);
  const bool a_lost = is_max ? fa < fb : fa > fb;
  const bool b_lost = is_max ? fa > fb : fa < fb;
  ga = a_lost ? zero : gh;
  gb = b_lost ? zero : gh;
}

// the two contributions to one third, added in T; a zero sum is +0
template <typename T>
__device__ __forceinline__ T add_bwd(T a, T b) {
  const T s = rnd<T>(val(a) + val(b));
  return val(s) == 0 ? rnd<T>(0.0f) : s;
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
efm3_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                T* __restrict__ dx, int rows, int third) {
  using Vt = Vec<T, V>;
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (c >= third) return;
  for (int r = blockIdx.y * blockDim.y + threadIdx.y; r < rows;
       r += gridDim.y * blockDim.y) {
    const T* src = x + (size_t)r * 3 * third + c;
    const Vt s0 = *reinterpret_cast<const Vt*>(src);
    const Vt s1 = *reinterpret_cast<const Vt*>(src + third);
    const Vt s2 = *reinterpret_cast<const Vt*>(src + 2 * third);
    const T* gsrc = g + (size_t)r * 2 * third + c;
    const Vt gmx = *reinterpret_cast<const Vt*>(gsrc);
    const Vt gmn = *reinterpret_cast<const Vt*>(gsrc + third);
    Vt d0, d1, d2;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const T a = s0.v[i], b = s1.v[i], e = s2.v[i];
      // max(max(a, b), e), then max(a, b)
      T g01, ge_mx, ga_mx, gb_mx;
      pick_bwd<T, true>(vmax(a, b), e, gmx.v[i], g01, ge_mx);
      pick_bwd<T, true>(a, b, g01, ga_mx, gb_mx);
      // min(min(a, b), e), then min(a, b)
      T h01, ge_mn, ga_mn, gb_mn;
      pick_bwd<T, false>(vmin(a, b), e, gmn.v[i], h01, ge_mn);
      pick_bwd<T, false>(a, b, h01, ga_mn, gb_mn);
      d0.v[i] = add_bwd(ga_mx, ga_mn);
      d1.v[i] = add_bwd(gb_mx, gb_mn);
      d2.v[i] = add_bwd(ge_mx, ge_mn);
    }
    T* dst = dx + (size_t)r * 3 * third + c;
    *reinterpret_cast<Vt*>(dst) = d0;
    *reinterpret_cast<Vt*>(dst + third) = d1;
    *reinterpret_cast<Vt*>(dst + 2 * third) = d2;
  }
}

template <typename T>
int launch_bwd(const void* x, const void* g, void* dx, int rows, int third,
               void* stream) {
  constexpr int V16 = 16 / sizeof(T);
  const bool wide = (third * sizeof(T)) % 16 == 0 &&
                    (uintptr_t)x % 16 == 0 && (uintptr_t)g % 16 == 0 &&
                    (uintptr_t)dx % 16 == 0;
  const int vecs = wide ? third / V16 : third;
  int tx = 32;
  while (tx < vecs && tx < THREADS) tx *= 2;
  const dim3 block(tx, THREADS / tx);
  const int gy = (rows + block.y - 1) / block.y;
  const dim3 grid((vecs + tx - 1) / tx, gy < 65535 ? gy : 65535);
  if (wide)
    efm3_bwd_kernel<T, V16><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const T*)x, (const T*)g, (T*)dx, rows, third);
  else
    efm3_bwd_kernel<T, 1><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const T*)x, (const T*)g, (T*)dx, rows, third);
  return (int)cudaGetLastError();
}

}  // namespace

// x [rows, 3 * third] contiguous, out [rows, 2 * third], both of the type
// dtype names: 0 f32, 1 bf16, 2 f16, 3 f64. rows > 0.
extern "C" int efm3(const void* x, void* out, int rows, int third, int dtype,
                    void* stream) {
  switch (dtype) {
    case 0: return launch<float>(x, out, rows, third, stream);
    case 1: return launch<__nv_bfloat16>(x, out, rows, third, stream);
    case 2: return launch<__half>(x, out, rows, third, stream);
    case 3: return launch<double>(x, out, rows, third, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// x [rows, 3 * third] and g [rows, 2 * third] contiguous, dx [rows, 3 *
// third], all of the type dtype names (as efm3's). rows > 0.
extern "C" int efm3_bwd(const void* x, const void* g, void* dx, int rows,
                        int third, int dtype, void* stream) {
  switch (dtype) {
    case 0: return launch_bwd<float>(x, g, dx, rows, third, stream);
    case 1: return launch_bwd<__nv_bfloat16>(x, g, dx, rows, third, stream);
    case 2: return launch_bwd<__half>(x, g, dx, rows, third, stream);
    case 3: return launch_bwd<double>(x, g, dx, rows, third, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

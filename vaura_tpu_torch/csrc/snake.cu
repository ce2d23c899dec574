// Snake, the DAC's periodic activation, in one pass:
//   y = x + sin^2(alpha x) / (alpha + 1e-9)
// x, y [B, C, T] contiguous, alpha [C] (one per channel), float32 or bf16.
//
// Replaces no TPU kernel: the JAX package computes Snake in XLA
// (vaura_tpu/models/dac/layers.py:26-68, Snake1d and _sin2_poly). Eager
// PyTorch took five full-tensor kernels (mul, sin, pow, div, add), ~44 B of
// traffic a float32 value.
//
// Bound on the H100: bytes. One read of x and one write of y, 8 B a value
// in float32; the ~40 instructions a value (precise sinf, an IEEE divide)
// fit within what the SMs execute at that byte rate (82-90% of the bound on
// rows of 1,768 values or more, NVIDIA H100 80GB HBM3, 700 W). In bf16, at
// 4 B a value, the instructions bind instead (50-63%). The decoder of one
// 32-clip slice applies it to 6.4e9 values (51 GB: 15 ms at 3.35 TB/s).
//
// Arithmetic. float32: t = a*x, s = sinf(t), y = x + (s*s) / (a + 1e-9f),
// the eager formula's operations in its order, with the precise sinf and an
// IEEE divide (no fast math, no reciprocal), so the result equals eager
// PyTorch's bit for bit. bf16 (the JAX package's bf16 form,
// layers.py:62-68): t = bf16(a*x); q = bf16(sinf(t)^2 / (float(a) + 1e-9f))
// in float32; y = bf16(x + q).
//
// Layout and grid. A row is one (b, c) pair of T values; blockIdx.y walks
// the rows (strided past 65,535), blockIdx.x the chunks of a row, and a
// block loads its row's alpha once. A thread holds kUnroll independent
// 16-byte vectors in flight where a row starts 16-byte aligned (T % 4 == 0
// in float32, T % 8 in bf16, and an aligned base), scalars otherwise (the
// decoder's first input has T = 221). Loads and stores are streaming
// (evict-first): a slice's tensors of up to 1.4 GB pass once through the
// 50 MB L2.
#include "common.cuh"

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__device__ __forceinline__ float snake1(float x, float a, float d) {
  float s = sinf(a * x);
  return x + (s * s) / d;
}

__device__ __forceinline__ bf16 snake1(bf16 x, float a, float d) {
  float s = sinf(to_f(__float2bfloat16_rn(a * to_f(x))));
  float q = to_f(__float2bfloat16_rn((s * s) / d));
  return __float2bfloat16_rn(to_f(x) + q);
}

__device__ __forceinline__ float ld_cs(const float* p) { return __ldcs(p); }
__device__ __forceinline__ bf16 ld_cs(const bf16* p) {
  return __ushort_as_bfloat16(__ldcs(reinterpret_cast<const unsigned short*>(p)));
}
__device__ __forceinline__ void st_cs(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void st_cs(bf16* p, bf16 v) {
  __stcs(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(v));
}

// V values of E: one 16-byte word, or one scalar (V = 1).
template <typename E, int V>
struct alignas(V == 1 ? sizeof(E) : 16) Pack {
  E v[V];
};

template <typename E, int V>
__device__ __forceinline__ void load_pack(Pack<E, V>& r, const E* p) {
  if constexpr (V == 1) r.v[0] = ld_cs(p);
  else *reinterpret_cast<uint4*>(&r) = __ldcs(reinterpret_cast<const uint4*>(p));
}

template <typename E, int V>
__device__ __forceinline__ void store_pack(E* p, const Pack<E, V>& r) {
  if constexpr (V == 1) st_cs(p, r.v[0]);
  else __stcs(reinterpret_cast<uint4*>(p), *reinterpret_cast<const uint4*>(&r));
}

template <typename E, int V>
__global__ void __launch_bounds__(kThreads)
    snake_kernel(const E* __restrict__ x, const E* __restrict__ alpha,
                 E* __restrict__ y, int C, long long T, long long rows) {
  const long long packs = T / V;  // T % V == 0 on the vector path
  const long long first =
      (long long)blockIdx.x * kThreads * kUnroll + threadIdx.x;
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    const float a = static_cast<float>(alpha[row % C]);
    const float d = a + 1e-9f;
    const E* xr = x + row * T;
    E* yr = y + row * T;
    Pack<E, V> buf[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = first + (long long)k * kThreads;
      if (i < packs) load_pack(buf[k], xr + i * V);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = first + (long long)k * kThreads;
      if (i < packs) {
#pragma unroll
        for (int j = 0; j < V; ++j) buf[k].v[j] = snake1(buf[k].v[j], a, d);
        store_pack(yr + i * V, buf[k]);
      }
    }
  }
}

template <typename E, int V>
static cudaError_t launch(const void* x, const void* alpha, void* y, int C,
                          long long T, long long rows, cudaStream_t st) {
  const long long per_block = (long long)kThreads * kUnroll;
  const long long chunks = (T / V + per_block - 1) / per_block;
  if (chunks > 0x7fffffffLL) return cudaErrorInvalidValue;
  dim3 grid((unsigned)chunks, (unsigned)(rows < 65535 ? rows : 65535));
  snake_kernel<E, V><<<grid, kThreads, 0, st>>>(
      static_cast<const E*>(x), static_cast<const E*>(alpha),
      static_cast<E*>(y), C, T, rows);
  return cudaGetLastError();
}

// x, y [B, C, T] contiguous; alpha [C] of x's dtype. dtype: 0 float32,
// 1 bf16. vec: 1 where every row starts 16-byte aligned (the caller checks
// the base pointers and T), 0 for the scalar path.
extern "C" int vt_snake(const void* x, const void* alpha, void* y, long long B,
                        int C, long long T, int dtype, int vec, void* stream) {
  if (B <= 0 || C <= 0 || T <= 0 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rows = B * C;
  const int V = vec ? (dtype == 0 ? 4 : 8) : 1;
  if (T % V != 0) return cudaErrorInvalidValue;
  if (dtype == 0)
    return vec ? launch<float, 4>(x, alpha, y, C, T, rows, st)
               : launch<float, 1>(x, alpha, y, C, T, rows, st);
  return vec ? launch<bf16, 8>(x, alpha, y, C, T, rows, st)
             : launch<bf16, 1>(x, alpha, y, C, T, rows, st);
}

// Shared helpers for the hand-written Hopper kernels of vaura_tpu_torch.
// Each .cu file includes this header once and compiles to its own shared
// library with a plain C interface (see kernels/build.py).
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

extern "C" const char* vt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Layer norm of one row of D bf16 values by one warp, in the E[x^2]-mean^2
// form of vaura_tpu/ops/encoder_fused.py::_layernorm (float32 statistics).
// Returns (mean, rstd) in every lane.
__device__ __forceinline__ float2 warp_row_stats(const bf16* __restrict__ row,
                                                 int D, float eps) {
  float s = 0.f, ss = 0.f;
  for (int c = threadIdx.x & 31; c < D; c += 32) {
    const float v = to_f(row[c]);
    s += v;
    ss += v * v;
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mean = s / D;
  const float var = ss / D - mean * mean;
  return make_float2(mean, rsqrtf(var + eps));
}

// Write the layer-normed row (cast to bf16) into shared memory; a row past
// the end of the data (valid == false) is written as zeros.
__device__ __forceinline__ void warp_ln_row_to_smem(
    const bf16* __restrict__ row, bool valid, const float* __restrict__ scale,
    const float* __restrict__ bias, int D, float eps, bf16* dst) {
  const int lane = threadIdx.x & 31;
  if (!valid) {
    for (int c = lane; c < D; c += 32) dst[c] = __float2bfloat16(0.f);
    return;
  }
  const float2 st = warp_row_stats(row, D, eps);
  for (int c = lane; c < D; c += 32) {
    const float y = (to_f(row[c]) - st.x) * st.y * scale[c] + bias[c];
    dst[c] = __float2bfloat16(y);
  }
}

// Opt a kernel into up to the full 227 KB of dynamic shared memory a block
// may use on Hopper. Call it once per kernel (a function-local static), so
// no attribute call is made while a CUDA graph is being captured.
template <typename K>
static cudaError_t allow_max_smem(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              227 * 1024);
}

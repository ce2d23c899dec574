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

// ---------------------------------------------------------------------------
// Group attention core shared by encoder_attention.cu (the fused sublayer)
// and grouped_cls_attention.cu (the stand-alone op): one warp computes one
// query row of head dim 64 against the L <= 256 keys and values of its group
// plus the shared CLS key/value column. q/k/v rows live in shared memory with
// a row stride of kAttnStride bf16 values (33 words, so the 32 lanes of a
// warp, one key row each, hit 32 different banks).
constexpr int kAttnHD = 64;
constexpr int kAttnStride = kAttnHD + 2;
constexpr int kAttnMaxKeys = 256;
constexpr int kAttnMaxKeyIters = kAttnMaxKeys / 32;

// q_row: the (pre-scaled) query, 64 values; k_grp/v_grp: row 0 of the group's
// keys/values; (ck0, ck1)/(cv0, cv1): this lane's two dims (2*lane, 2*lane+1)
// of the CLS key/value. One lane per key scores 32 keys at a time; float32
// scores, max, sum and accumulator; the unnormalised float32 probabilities
// multiply the values and the sum is divided by the denominator once, then
// rounded to bf16: out_row[lane] receives dims (2*lane, 2*lane+1).
__device__ __forceinline__ void warp_group_attention_row(
    const bf16* q_row, const bf16* k_grp, const bf16* v_grp, int L, float ck0,
    float ck1, float cv0, float cv1, __nv_bfloat162* out_row) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat162* qrow = reinterpret_cast<const __nv_bfloat162*>(q_row);
  const int n_key_iters = (L + 31) / 32;
  float s[kAttnMaxKeyIters];
  float mx;
  {
    const float2 qp = __bfloat1622float2(qrow[lane]);
    mx = warp_sum(qp.x * ck0 + qp.y * ck1);  // CLS column score
  }
  const float sc = mx;
#pragma unroll
  for (int t = 0; t < kAttnMaxKeyIters; ++t) {
    s[t] = -INFINITY;
    const int j = t * 32 + lane;
    if (t < n_key_iters && j < L) {
      const __nv_bfloat162* krow =
          reinterpret_cast<const __nv_bfloat162*>(k_grp + j * kAttnStride);
      float a = 0.f;
#pragma unroll 8
      for (int d = 0; d < kAttnHD / 2; ++d) {
        const float2 qv = __bfloat1622float2(qrow[d]);
        const float2 kv = __bfloat1622float2(krow[d]);
        a += qv.x * kv.x + qv.y * kv.y;
      }
      s[t] = a;
      mx = fmaxf(mx, a);
    }
  }
  mx = warp_max(mx);
  float den = 0.f;
#pragma unroll
  for (int t = 0; t < kAttnMaxKeyIters; ++t) {
    s[t] = (t < n_key_iters && t * 32 + lane < L) ? expf(s[t] - mx) : 0.f;
    den += s[t];
  }
  const float pc = expf(sc - mx);
  den = warp_sum(den) + pc;
  float o0 = pc * cv0, o1 = pc * cv1;
#pragma unroll
  for (int t = 0; t < kAttnMaxKeyIters; ++t) {
    if (t < n_key_iters) {
      const int nk = min(32, L - t * 32);
      for (int src = 0; src < nk; ++src) {
        const float p = __shfl_sync(0xffffffffu, s[t], src);
        const float2 vv = __bfloat1622float2(
            reinterpret_cast<const __nv_bfloat162*>(
                v_grp + (t * 32 + src) * kAttnStride)[lane]);
        o0 += p * vv.x;
        o1 += p * vv.y;
      }
    }
  }
  out_row[lane] = __floats2bfloat162_rn(o0 / den, o1 / den);
}

// Opt a kernel into up to the full 227 KB of dynamic shared memory a block
// may use on Hopper. Call it once per kernel (a function-local static), so
// no attribute call is made while a CUDA graph is being captured.
template <typename K>
static cudaError_t allow_max_smem(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              227 * 1024);
}

// Row-wise layer norm and the pipelined bf16 GEMM shared by the two fused
// encoder sublayers (encoder_attention.cu: the output projection;
// encoder_mlp.cu: fc1 and fc2). A source includes this header once and
// instantiates the kernels it launches.
//
//   y[M, N] = epilogue(A[M, K] @ W[N, K]^T + bias)
//
// with W in torch's nn.Linear layout, A, W and y bf16, bias float32, the sums
// float32. One block computes a 128 x 192 tile: two warpgroups of 64 rows,
// each a wgmma m64n192k16 chain (96 float32 sums a thread), K in slabs of 64
// through a four-stage ring of 128-byte-swizzled shared-memory tiles that
// cp.async fills (16 bytes a thread, no registers). A step queues the product
// on slab s behind the one on slab s - 1, waits for that one and for slab
// s + 1, and only then requests the slab three ahead into the stage set free,
// so the tensor cores always have work queued. Rows past M and columns past
// N are read as zeros and not written. The sums leave the registers through
// float32 staging rows laid over the ring, so that the epilogue reads and
// writes whole 16-byte vectors of a row. Two epilogues:
//   kEpiResidual  y = resid + bias + sums, one rounding; the residual tile
//                 is requested ahead of the loop and waits in shared memory;
//   kEpiGelu      y = gelu(bias + sums) with the exact erf, one rounding.
// What binds it on the H100 at these tiles is the path from L2 to the SMs: a
// block reads 40 KB a slab for 3.1 MFLOP (78 operations a byte), and a slab
// takes about 1,500 cycles where the tensor cores need 768 (NVIDIA H100 80GB
// HBM3, 700 W; profile_kernels.py). Of fc1's 32 k cycles a block (K = 768)
// the exact GELU is 10 k, the first slab's latency 4 k.
// What did not pay (same card, the MLP sublayer 0.368 ms with this form): one
// block an SM walking over the tiles with a third warpgroup that only copies,
// the ring filling with the next tile's slabs during the epilogue, the
// epilogue on the sums in their registers. With the copying threads waiting
// for their own copies, fencing and arriving at a stage's mbarrier: 0.455 ms;
// with cp.async.mbarrier.arrive and the fence on the reading side: 0.428 ms.
// 128 threads request a slab's 2,560 copies more slowly than 256, and a stage
// goes from handed back to refilled in more time than the three slabs ahead
// of it last (2,000 cycles a slab).
#pragma once

#include "common.cuh"

namespace {

constexpr int kGemmCols = 192;                      // one wgmma width
constexpr int kTileA = 64 * kSlabRowBytes;          // one warpgroup's A tile
constexpr int kTileW = kGemmCols * kSlabRowBytes;   // 192 weight rows

constexpr int kEpiResidual = 0, kEpiGelu = 1;

// Layer norm of every row of x [M, D], once per row: float32 statistics in
// the E[x^2] - mean^2 form of the JAX package, the normalised row rounded to
// bf16, as the plain versions round it. One warp a row; the second pass over
// the row finds it in L1.
__global__ void __launch_bounds__(256)
layernorm_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_s,
                      const float* __restrict__ ln_b, bf16* __restrict__ y, int M,
                      int D, float eps) {
  const int r = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (r >= M) return;
  const uint4* row = reinterpret_cast<const uint4*>(x + static_cast<size_t>(r) * D);
  uint4* out = reinterpret_cast<uint4*>(y + static_cast<size_t>(r) * D);
  float s = 0.f, ss = 0.f;
  for (int c = lane; c < D / 8; c += 32) {
    const uint4 raw = row[c];
    const __nv_bfloat162* in = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 v = __bfloat1622float2(in[e]);
      s += v.x + v.y;
      ss += v.x * v.x + v.y * v.y;
    }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mean = s / D;
  const float rstd = rsqrtf(ss / D - mean * mean + eps);
  for (int c = lane; c < D / 8; c += 32) {
    uint4 vec = row[c];
    const __nv_bfloat162* in = reinterpret_cast<const __nv_bfloat162*>(&vec);
    float sc[8], bi[8];
    *reinterpret_cast<float4*>(sc) = __ldg(reinterpret_cast<const float4*>(ln_s + c * 8));
    *reinterpret_cast<float4*>(sc + 4) = __ldg(reinterpret_cast<const float4*>(ln_s + c * 8 + 4));
    *reinterpret_cast<float4*>(bi) = __ldg(reinterpret_cast<const float4*>(ln_b + c * 8));
    *reinterpret_cast<float4*>(bi + 4) = __ldg(reinterpret_cast<const float4*>(ln_b + c * 8 + 4));
    uint4 res;
    uint32_t* o = reinterpret_cast<uint32_t*>(&res);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 v = __bfloat1622float2(in[e]);
      o[e] = pack_bf16((v.x - mean) * rstd * sc[2 * e] + bi[2 * e],
                       (v.y - mean) * rstd * sc[2 * e + 1] + bi[2 * e + 1]);
    }
    out[c] = res;
  }
}

// y [M, D] = layer norm of x [M, D] (bf16), scale and bias [D] f32.
inline cudaError_t launch_layernorm_rows(const void* x, const void* ln_s,
                                         const void* ln_b, void* y, int M, int D,
                                         float eps, cudaStream_t stream) {
  if (M <= 0 || D <= 0 || D % 8 != 0) return cudaErrorInvalidValue;
  layernorm_rows_kernel<<<(M + 7) / 8, 256, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<bf16*>(y), M, D, eps);
  return cudaGetLastError();
}

constexpr int kPM = 128, kPN = kGemmCols, kPStages = 4, kPThreads = 256;
constexpr int kPStage = 2 * kTileA + kTileW;
constexpr int kPCStride = kPN + 4;  // float32 staging rows, 16-byte aligned
constexpr int kPResid = kPStages * kPStage;      // after the ring: bf16[128][192]
static_assert(kPM * kPCStride * 4 <= kPStages * kPStage, "staging fits the ring");

template <int kEpi>
constexpr int gemm_smem_bytes() {
  return kPResid + (kEpi == kEpiResidual ? kPM * kPN * 2 : 0) + 1024;
}

__device__ __forceinline__ float gelu_exact(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

template <int kEpi>
__global__ void __launch_bounds__(kPThreads, 1)
gemm_bias_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                 const float* __restrict__ bias, const bf16* __restrict__ resid,
                 bf16* __restrict__ y, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t ring = smem_u32(smem);
  const int n0 = blockIdx.x * kPN, m0 = blockIdx.y * kPM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = warp >> 2;
  const int n_slabs = K / kSlabK;

  auto load = [&](int s, int stage) {
    const uint32_t a_dst = ring + stage * kPStage, w_dst = a_dst + 2 * kTileA;
    for (int v = tid; v < kPM * 8; v += kPThreads) {
      const int r = v >> 3, c = v & 7;
      const bool ok = m0 + r < M;
      cp_async16(a_dst + (r >> 6) * kTileA + swz128(r & 63, c),
                 A + static_cast<size_t>(ok ? m0 + r : 0) * K + s * kSlabK + c * 8, ok);
    }
    for (int v = tid; v < kPN * 8; v += kPThreads) {
      const int r = v >> 3, c = v & 7;
      const bool ok = n0 + r < N;
      cp_async16(w_dst + swz128(r, c),
                 W + static_cast<size_t>(ok ? n0 + r : 0) * K + s * kSlabK + c * 8, ok);
    }
  };

  // gemm 1. the residual tile rides in the first group of copies
  if (kEpi == kEpiResidual) {
    for (int v = tid; v < kPM * (kPN / 8); v += kPThreads) {
      const int r = v / (kPN / 8), c = (v % (kPN / 8)) * 8;
      const bool ok = m0 + r < M && n0 + c < N;
      cp_async16(ring + kPResid + (r * kPN + c) * 2,
                 resid + (ok ? static_cast<size_t>(m0 + r) * N + n0 + c : 0), ok);
    }
  }
  for (int s = 0; s < kPStages - 1; ++s) {
    if (s < n_slabs) load(s, s);
    cp_async_commit();
  }
  cp_async_wait<kPStages - 2>();
  fence_proxy_async();
  __syncthreads();

  // gemm 2. Entering step s, slab s has landed and slabs s + 1, s + 2 are in
  // flight. The step starts the product on slab s, makes sure the one on slab
  // s - 1 is done and slab s + 1 has landed, and requests slab s + 3 into the
  // stage that product has left.
  float acc[96];
#pragma unroll
  for (int i = 0; i < 96; ++i) acc[i] = 0.f;
  for (int s = 0; s < n_slabs; ++s) {
    const uint32_t st = ring + (s % kPStages) * kPStage;
    wgmma_fence();
    wgmma_slab(acc, st + wg * kTileA, st + 2 * kTileA);
    wgmma_commit();
    wgmma_wait<1>();
    cp_async_wait<kPStages - 3>();
    fence_proxy_async();
    __syncthreads();
    if (s + kPStages - 1 < n_slabs)
      load(s + kPStages - 1, (s + kPStages - 1) % kPStages);
    cp_async_commit();
  }
  wgmma_wait<0>();
  wgmma_acc_fence(acc);
  cp_async_wait<0>();
  __syncthreads();

  // gemm 3. the sums through shared memory, so that y is written (and the
  // residual read) as whole 16-byte vectors of a row
  float* c_sm = reinterpret_cast<float*>(smem);
  {
    const int row = wg * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < 24; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      *reinterpret_cast<float2*>(c_sm + row * kPCStride + c) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(c_sm + (row + 8) * kPCStride + c) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  __syncthreads();
  // gemm 4. bias and the epilogue's function, rounded once, 16 bytes a store
  for (int v = tid; v < kPM * (kPN / 8); v += kPThreads) {
    const int r = v / (kPN / 8), c = (v % (kPN / 8)) * 8;
    if (m0 + r >= M || n0 + c >= N) continue;
    float cs[8], bi[8];
    *reinterpret_cast<float4*>(cs) = *reinterpret_cast<const float4*>(c_sm + r * kPCStride + c);
    *reinterpret_cast<float4*>(cs + 4) = *reinterpret_cast<const float4*>(c_sm + r * kPCStride + c + 4);
    *reinterpret_cast<float4*>(bi) = __ldg(reinterpret_cast<const float4*>(bias + n0 + c));
    *reinterpret_cast<float4*>(bi + 4) = __ldg(reinterpret_cast<const float4*>(bias + n0 + c + 4));
    uint4 out;
    uint32_t* o = reinterpret_cast<uint32_t*>(&out);
    if (kEpi == kEpiResidual) {
      const uint4 rv = *reinterpret_cast<const uint4*>(smem + kPResid + (r * kPN + c) * 2);
      const __nv_bfloat162* rin = reinterpret_cast<const __nv_bfloat162*>(&rv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 rf = __bfloat1622float2(rin[e]);
        o[e] = pack_bf16(rf.x + bi[2 * e] + cs[2 * e],
                         rf.y + bi[2 * e + 1] + cs[2 * e + 1]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[e] = pack_bf16(gelu_exact(cs[2 * e] + bi[2 * e]),
                         gelu_exact(cs[2 * e + 1] + bi[2 * e + 1]));
    }
    *reinterpret_cast<uint4*>(y + static_cast<size_t>(m0 + r) * N + n0 + c) = out;
  }
  // gemm 5. done
}

// A [M, K], W [N, K], y and (kEpiResidual) resid [M, N] bf16; bias [N] f32.
template <int kEpi>
cudaError_t launch_gemm_bias(const void* A, const void* W, const void* bias,
                             const void* resid, void* y, int M, int N, int K,
                             cudaStream_t stream) {
  if (N % 8 != 0 || K % kSlabK != 0 || M <= 0 || N <= 0 || K <= 0)
    return cudaErrorInvalidValue;
  static const cudaError_t attr_err = allow_max_smem(gemm_bias_kernel<kEpi>);
  if (attr_err != cudaSuccess) return attr_err;
  const dim3 grid((N + kPN - 1) / kPN, (M + kPM - 1) / kPM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  gemm_bias_kernel<kEpi><<<grid, kPThreads, gemm_smem_bytes<kEpi>(), stream>>>(
      static_cast<const bf16*>(A), static_cast<const bf16*>(W),
      static_cast<const float*>(bias), static_cast<const bf16*>(resid),
      static_cast<bf16*>(y), M, N, K);
  return cudaGetLastError();
}

}  // namespace

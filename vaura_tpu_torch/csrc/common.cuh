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
// Geometry shared by the two group-attention sources (encoder_attention.cu,
// the fused sublayer, and grouped_cls_attention.cu, the stand-alone op): head
// dim 64, groups and packs of at most 256 rows.
constexpr int kAttnHD = 64;
// Row stride of q/k/v tiles that the tensor cores read (ldmatrix and wmma want
// 16-byte aligned rows): 144 bytes, so eight consecutive rows start in eight
// different 16-byte bank groups.
constexpr int kMmaStride = kAttnHD + 8;
constexpr int kAttnMaxKeys = 256;

// ---------------------------------------------------------------------------
// Asynchronous copies, shared-memory matrix loads and tensor-core products.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory to shared memory without passing through
// registers; valid == false writes zeros and reads nothing (src must still be
// an address inside the allocation).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid = true) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared memory written by ordinary stores or cp.async becomes visible to
// wgmma (the asynchronous proxy) only after this fence, executed by the
// writing thread before the barrier that the readers wait on.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Tiles that wgmma reads: rows of 64 bf16 values (128 bytes, one k-slab), K
// contiguous, in the 128-byte swizzle: the 16-byte chunk c of row r lies at
// chunk c ^ (r % 8). A tile starts on a 1024-byte boundary.
constexpr int kSlabK = 64;
constexpr int kSlabRowBytes = 128;
__device__ __forceinline__ uint32_t swz128(int row, int chunk) {
  return static_cast<uint32_t>(row * kSlabRowBytes + ((chunk ^ (row & 7)) << 4));
}

// wgmma descriptor of such a tile: start address, leading offset 16 bytes
// (unused with the swizzle), 1024 bytes from one group of 8 rows to the next,
// 128-byte swizzle. A step of 16 values along K adds 32 bytes: 2 to the
// encoded address.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t smem_addr) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d[64, 192] += A[64, 16] B[192, 16]^T by one warpgroup, both operands from
// swizzled shared memory, float32 sums in 96 registers a thread: register
// 4j + {0, 1} holds row 16*(warp % 4) + lane / 4, columns 8j + 2*(lane % 4)
// + {0, 1}; registers 4j + {2, 3} the same columns eight rows further down.
__device__ __forceinline__ void wgmma_m64n192k16(float (&d)[96], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95 "
      "}, %96, %97, p, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
        "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
        "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(1));
}

// One k-slab (64 values of K) of d += A B^T for this warpgroup.
__device__ __forceinline__ void wgmma_slab(float (&d)[96], uint32_t a_tile,
                                           uint32_t b_tile) {
  const uint64_t da = wgmma_desc(a_tile), db = wgmma_desc(b_tile);
#pragma unroll
  for (int k = 0; k < kSlabK / 16; ++k) wgmma_m64n192k16(d, da + 2 * k, db + 2 * k);
}

// Keep the compiler from moving reads of the sums above the wait.
__device__ __forceinline__ void wgmma_acc_fence(float (&d)[96]) {
#pragma unroll
  for (int i = 0; i < 96; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Four 8x8 bf16 matrices from shared memory into mma.sync fragments; lane l
// gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c[16, 8] += a[16, 16] b[16, 8] by one warp (bf16 operands, float32 sums).
__device__ __forceinline__ void mma_m16n8k16(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Opt a kernel into up to the full 227 KB of dynamic shared memory a block
// may use on Hopper. Call it once per kernel (a function-local static), so
// no attribute call is made while a CUDA graph is being captured.
template <typename K>
static cudaError_t allow_max_smem(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              227 * 1024);
}

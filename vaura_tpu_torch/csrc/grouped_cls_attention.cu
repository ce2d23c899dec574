// Grouped attention with a shared CLS key/value column: many small
// independent attentions,
//   out[bh, g] = softmax([q . cls_k, q k^T]) @ [cls_v; v]   per group g,
// for q/k/v/out [BH, G, L, 64] bf16 (q pre-scaled by 1/sqrt(64)) and
// cls_k/cls_v [BH, 1, 64]. The unfused divided space-time block of the
// MotionFormer calls it on both axes while the encoder trains: time
// (G = 196 locations, L = 8 frames) and space (G = 8 frames, L = 196).
//
// Replaces the Pallas kernel vaura_tpu/ops/divided_attention.py::
// grouped_cls_attention (kernel _kernel, :61-87; call :115). That kernel
// packs P groups into one [P*L, P*L] score tile and masks the cross-group
// blocks to give the TPU's matrix unit a tile of its shape; nothing here
// needs that, so a query only ever meets the L keys of its own group.
//
// Bound on the H100: bytes. q, k, v are read and out is written once
// (4 * BH*G*L*64 * 2 bytes, 77 MB at the flagship shapes) against
// 4 * BH*G*L*(L+1)*64 operations (7.6 GFLOP on the space axis, 0.3 on the
// time axis), far below 295 operations per byte.
//
// Design: the groups of one bh are contiguous rows of [G*L, 64], and every
// byte of the inputs is read from device memory exactly once (16-byte
// loads into shared memory). Two kernels, chosen by the group length:
//  * short groups (L < 32, the time axis), grouped_cls_attention_kernel: a
//    block takes one "pack" of whole groups (pack_rows = a multiple of L,
//    <= 256 rows) and one warp per query row runs warp_group_attention_row
//    (below): one lane per key,
//    float32 scores, max, sum and accumulator on the CUDA cores, the CLS
//    key as one extra score column, one rounding of the output to bf16.
//    Scores and probabilities never leave registers.
//  * long groups (32 <= L, the space axis), grouped_cls_attention_mma_kernel:
//    one block per group. The CLS key/value become row L of the group's K
//    and V in shared memory, so the CLS column rides in the same products.
//    Each warp takes 16 query rows at a time: S = Q K^T on the tensor cores
//    (nvcuda::wmma bf16 tiles, float32 accumulators) into the warp's own
//    shared-memory strip, a float32 row softmax there (max, exp, sum; the
//    UNNORMALISED probabilities rounded to bf16, as the Pallas kernel
//    rounds them), O = P V on the tensor cores, then the division by the
//    float32 denominator and one rounding of the output. A first version
//    ran this axis through the row kernel too, on the CUDA cores, and was
//    slower than the plain version (PERF.md has both times).
//    A group too long for the strips to fit 227 KB of shared memory
//    (L > 239) is refused.
// Limits, for later work: on the time axis only L = 8 of a warp's 32 lanes
// hold a key; wmma tiles instead of wgmma/TMA; the caller still transposes
// [B, f, n, H, hd] into the group-major layout.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int kWarps = 8;

// The row kernel's q/k/v rows in shared memory: 33 words, so the 32 lanes of
// a warp, one key row each, hit 32 different banks.
constexpr int kAttnStride = kAttnHD + 2;
constexpr int kAttnMaxKeyIters = kAttnMaxKeys / 32;

// One warp computes one query row of head dim 64 against the L <= 256 keys
// and values of its group plus the shared CLS key/value column.
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
constexpr int kMmaMinL = 32;

__host__ __device__ inline int mma_padded_len(int L) {
  return (L + 1 + 15) / 16 * 16;  // the group's keys, the CLS row, padding
}

// Bytes of one warp's strip: 16 x Lp float32 scores, over which the bf16
// probabilities [16, Lp] and then the float32 output tile [16, 64] are laid.
__host__ __device__ inline size_t mma_strip_bytes(int Lp) {
  const size_t scores = sizeof(float) * 16 * Lp;
  const size_t probs_out = sizeof(bf16) * 16 * Lp + sizeof(float) * 16 * kAttnHD;
  const size_t n = scores > probs_out ? scores : probs_out;
  return (n + 127) / 128 * 128;
}

__global__ void __launch_bounds__(kWarps * 32)
grouped_cls_attention_mma_kernel(const bf16* __restrict__ q,
                                 const bf16* __restrict__ k,
                                 const bf16* __restrict__ v,
                                 const bf16* __restrict__ cls_k,
                                 const bf16* __restrict__ cls_v,
                                 bf16* __restrict__ out, int G, int L) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int Lp = mma_padded_len(L);
  bf16* q_sm = reinterpret_cast<bf16*>(smem);
  bf16* k_sm = q_sm + Lp * kMmaStride;
  bf16* v_sm = k_sm + Lp * kMmaStride;
  const size_t qkv_bytes = sizeof(bf16) * 3 * Lp * kMmaStride;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* strip =
      smem + (qkv_bytes + 127) / 128 * 128 + warp * mma_strip_bytes(Lp);
  float* s_sm = reinterpret_cast<float*>(strip);
  bf16* p_sm = reinterpret_cast<bf16*>(strip);
  float* o_sm = reinterpret_cast<float*>(
      strip + (sizeof(bf16) * 16 * Lp + 127) / 128 * 128);

  const int g = blockIdx.x, bh = blockIdx.y;
  const size_t base = (static_cast<size_t>(bh) * G + g) * L * kAttnHD;

  // 1. q, k, v of the group -> shared memory; row L of k/v is the CLS
  //    key/value; every other row from L on is zero
  constexpr int kVecs = kAttnHD / 8;
  for (int i = threadIdx.x; i < Lp * kVecs; i += blockDim.x) {
    const int r = i / kVecs, c = (i % kVecs) * 8;
    uint4 qv = make_uint4(0, 0, 0, 0), kv = qv, vv = qv;
    if (r < L) {
      const size_t gi = base + static_cast<size_t>(r) * kAttnHD + c;
      qv = *reinterpret_cast<const uint4*>(q + gi);
      kv = *reinterpret_cast<const uint4*>(k + gi);
      vv = *reinterpret_cast<const uint4*>(v + gi);
    } else if (r == L) {
      const size_t ci = static_cast<size_t>(bh) * kAttnHD + c;
      kv = *reinterpret_cast<const uint4*>(cls_k + ci);
      vv = *reinterpret_cast<const uint4*>(cls_v + ci);
    }
    *reinterpret_cast<uint4*>(q_sm + r * kMmaStride + c) = qv;
    *reinterpret_cast<uint4*>(k_sm + r * kMmaStride + c) = kv;
    *reinterpret_cast<uint4*>(v_sm + r * kMmaStride + c) = vv;
  }
  __syncthreads();

  const int n_row_tiles = (L + 15) / 16, n_key_tiles = Lp / 16;
  const int n_keys = L + 1;  // the group's keys and the CLS key
  for (int rt = warp; rt < n_row_tiles; rt += kWarps) {
    // 2. S = Q_tile K^T, float32, into the warp's strip
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fq[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wmma::load_matrix_sync(fq[kk], q_sm + rt * 16 * kMmaStride + kk * 16,
                             kMmaStride);
    for (int j = 0; j < n_key_tiles; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fk;
        wmma::load_matrix_sync(fk, k_sm + j * 16 * kMmaStride + kk * 16,
                               kMmaStride);
        wmma::mma_sync(acc, fq[kk], fk, acc);
      }
      wmma::store_matrix_sync(s_sm + j * 16, acc, Lp, wmma::mem_row_major);
    }
    __syncwarp();

    // 3. row softmax in float32; the unnormalised probabilities go back as
    //    bf16 over the scores (row r of the probabilities ends before row r
    //    of the scores begins, and a row is read whole before it is
    //    written), columns from n_keys on as zeros
    float my_den = 1.f;  // lane r keeps the denominator of row r
    for (int r = 0; r < 16; ++r) {
      float sv[kAttnMaxKeyIters];
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < kAttnMaxKeyIters; ++t) {
        const int c = t * 32 + lane;
        sv[t] = c < n_keys ? s_sm[r * Lp + c] : -INFINITY;
        mx = fmaxf(mx, sv[t]);
      }
      mx = warp_max(mx);
      float den = 0.f;
#pragma unroll
      for (int t = 0; t < kAttnMaxKeyIters; ++t) {
        sv[t] = t * 32 + lane < n_keys ? expf(sv[t] - mx) : 0.f;
        den += sv[t];
      }
      den = warp_sum(den);
      if (lane == r) my_den = den;
      __syncwarp();
#pragma unroll
      for (int t = 0; t < kAttnMaxKeyIters; ++t) {
        const int c = t * 32 + lane;
        if (c < Lp) p_sm[r * Lp + c] = __float2bfloat16(sv[t]);
      }
      __syncwarp();
    }

    // 4. O = P V on the tensor cores
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> fo[4];
#pragma unroll
    for (int n = 0; n < 4; ++n) wmma::fill_fragment(fo[n], 0.f);
    for (int j = 0; j < n_key_tiles; ++j) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fp;
      wmma::load_matrix_sync(fp, p_sm + j * 16, Lp);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fv;
        wmma::load_matrix_sync(fv, v_sm + j * 16 * kMmaStride + n * 16,
                               kMmaStride);
        wmma::mma_sync(fo[n], fp, fv, fo[n]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int n = 0; n < 4; ++n)
      wmma::store_matrix_sync(o_sm + n * 16, fo[n], kAttnHD,
                              wmma::mem_row_major);
    __syncwarp();

    // 5. divide by the denominator, round once, store: lane covers dims
    //    (2*lane, 2*lane+1) of one row at a time (128 contiguous bytes)
    for (int r = 0; r < 16; ++r) {
      const float den = __shfl_sync(0xffffffffu, my_den, r);
      const int row = rt * 16 + r;
      if (row < L) {
        const float2 o = *reinterpret_cast<const float2*>(
            o_sm + r * kAttnHD + 2 * lane);
        reinterpret_cast<__nv_bfloat162*>(
            out + base + static_cast<size_t>(row) * kAttnHD)[lane] =
            __floats2bfloat162_rn(o.x / den, o.y / den);
      }
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kWarps * 32)
grouped_cls_attention_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ cls_k,
                             const bf16* __restrict__ cls_v,
                             bf16* __restrict__ out, int N, int L,
                             int pack_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_sm = reinterpret_cast<bf16*>(smem);
  bf16* k_sm = q_sm + pack_rows * kAttnStride;
  bf16* v_sm = k_sm + pack_rows * kAttnStride;

  const int pack = blockIdx.x, bh = blockIdx.y;
  const int r0 = pack * pack_rows;
  const int nrows = min(pack_rows, N - r0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t base = (static_cast<size_t>(bh) * N + r0) * kAttnHD;

  // 1. the pack's q, k, v rows -> shared memory: 8 vectors of 8 bf16 a row,
  //    stored as 4-byte words (a row of 33 words is not 16-byte aligned)
  constexpr int kVecs = kAttnHD / 8;
  for (int i = threadIdx.x; i < nrows * kVecs; i += blockDim.x) {
    const int r = i / kVecs, c = (i % kVecs) * 8;
    const size_t g = base + static_cast<size_t>(r) * kAttnHD + c;
    const uint4 qv = *reinterpret_cast<const uint4*>(q + g);
    const uint4 kv = *reinterpret_cast<const uint4*>(k + g);
    const uint4 vv = *reinterpret_cast<const uint4*>(v + g);
    uint32_t* qd = reinterpret_cast<uint32_t*>(q_sm + r * kAttnStride + c);
    uint32_t* kd = reinterpret_cast<uint32_t*>(k_sm + r * kAttnStride + c);
    uint32_t* vd = reinterpret_cast<uint32_t*>(v_sm + r * kAttnStride + c);
    qd[0] = qv.x; qd[1] = qv.y; qd[2] = qv.z; qd[3] = qv.w;
    kd[0] = kv.x; kd[1] = kv.y; kd[2] = kv.z; kd[3] = kv.w;
    vd[0] = vv.x; vd[1] = vv.y; vd[2] = vv.z; vd[3] = vv.w;
  }
  __syncthreads();

  // 2. one warp per query row against its own group
  const size_t cls_off = static_cast<size_t>(bh) * kAttnHD;
  const float ck0 = to_f(cls_k[cls_off + 2 * lane]);
  const float ck1 = to_f(cls_k[cls_off + 2 * lane + 1]);
  const float cv0 = to_f(cls_v[cls_off + 2 * lane]);
  const float cv1 = to_f(cls_v[cls_off + 2 * lane + 1]);
  for (int i = warp; i < nrows; i += kWarps) {
    const int g0 = (i / L) * L;
    warp_group_attention_row(
        q_sm + i * kAttnStride, k_sm + g0 * kAttnStride,
        v_sm + g0 * kAttnStride, L, ck0, ck1, cv0, cv1,
        reinterpret_cast<__nv_bfloat162*>(
            out + base + static_cast<size_t>(i) * kAttnHD));
  }
}

}  // namespace

// q, k, v, out [BH, N = G*L, 64] bf16 (groups of L consecutive rows);
// cls_k, cls_v [BH, 64] bf16. L <= 239. pack_rows, read only when L < 32,
// is a multiple of L, <= 256.
extern "C" int vt_grouped_cls_attention(const void* q, const void* k,
                                        const void* v, const void* cls_k,
                                        const void* cls_v, void* out, int BH,
                                        int N, int L, int pack_rows,
                                        void* stream) {
  if (BH <= 0 || BH > 65535 || L <= 0 || N <= 0 || N % L != 0)
    return cudaErrorInvalidValue;
  static const cudaError_t attr_err =
      allow_max_smem(grouped_cls_attention_kernel);
  if (attr_err != cudaSuccess) return attr_err;
  static const cudaError_t mma_attr_err =
      allow_max_smem(grouped_cls_attention_mma_kernel);
  if (mma_attr_err != cudaSuccess) return mma_attr_err;
  if (L >= kMmaMinL) {
    const int Lp = mma_padded_len(L);
    const size_t mma_smem =
        (sizeof(bf16) * 3 * Lp * kMmaStride + 127) / 128 * 128 +
        kWarps * mma_strip_bytes(Lp);
    if (mma_smem > 227 * 1024) return cudaErrorInvalidValue;
    grouped_cls_attention_mma_kernel<<<dim3(N / L, BH), kWarps * 32, mma_smem,
                                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(cls_k),
        static_cast<const bf16*>(cls_v), static_cast<bf16*>(out), N / L, L);
    return cudaGetLastError();
  }
  if (pack_rows <= 0 || pack_rows % L != 0 || pack_rows > kAttnMaxKeys)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(bf16) * 3 * pack_rows * kAttnStride;
  const int n_packs = (N + pack_rows - 1) / pack_rows;
  grouped_cls_attention_kernel<<<dim3(n_packs, BH), kWarps * 32, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(cls_k),
      static_cast<const bf16*>(cls_v), static_cast<bf16*>(out), N, L,
      pack_rows);
  return cudaGetLastError();
}

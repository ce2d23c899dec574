// Fused divided-attention sublayer of the MotionFormer encoder, in two
// launches:
//   (a) vt_group_attention: per (pack of whole groups, head, batch row)
//       LN -> this head's q/k/v projection -> masked group attention with
//       the shared CLS key/value column -> the head's attention output,
//       plus the CLS query's flash partials (max, sumexp, weighted values)
//       over the pack's rows;
//   (b) vt_proj_residual: y = x + attn @ Wproj^T + bproj, a tiled bf16
//       GEMM with the bias and residual in its epilogue.
//
// Replaces the Pallas kernel vaura_tpu/ops/encoder_fused.py::
// fused_attention_sublayer (kernel _kernel, :101; call :259). The CLS row's
// own q/k/v, the merge of the CLS partials and the CLS projection stay in
// plain PyTorch, as the JAX package keeps them outside Pallas (:233-247,
// :285-315).
//
// Layout (group-major, the caller transposes between the time and space
// sublayers): x [B', G*L, D] bf16, each group's L rows contiguous.
//
// Bound on the H100: operations. Per sublayer at the flagship shapes
// (B'=8, N=1568, D=768) the q/k/v and output projections are
// 2*B'*N*D*4D = 59 GFLOP on the tensor cores and the group attention
// 4*B'*N*L*D (L=196 on the space axis: 7.5 GFLOP) on the CUDA cores, against
// about 2*B'*N*D*2 = 38 MB of activations read and written.
//
// Design and its limits (targets for later work):
//  * one group on the space axis is L=196 rows x 768 = 301 KB of LN'd bf16,
//    more than a block's 227 KB of shared memory, so (a) never holds the
//    LN'd rows: it keeps per-row statistics and re-normalises 32-row chunks
//    into shared memory, each chunk multiplied (nvcuda::wmma bf16 tiles,
//    float32 accumulators) against the head's 192 columns of Wqkv read
//    through L2. LN and the x reads are repeated once per head (12x).
//  * q/k/v of the pack for one head live in shared memory (<= 256 rows);
//    attention runs one warp per query row, one lane per key, float32
//    online-free softmax over <= 256 keys plus the CLS column
//    (warp_group_attention_row in common.cuh, shared with
//    grouped_cls_attention.cu).
//  * the per-head attention output makes one extra HBM round trip
//    ([B', N, D] bf16 written by (a), read by (b)); the Pallas kernel kept
//    it in VMEM. Fusing the projection into (a) is the next step.
//  * wmma tiles instead of wgmma/TMA: simple and right first.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int kHD = kAttnHD;      // head dim the kernel is built for
constexpr int kMaxRows = kAttnMaxKeys;  // rows of one pack
constexpr int kChunk = 32;        // LN'd rows staged per projection pass
constexpr int kWarps = 8;
constexpr int kQKVStride = kAttnStride;  // 33 words: conflict-free row reads

struct GroupSmem {
  // byte offsets into dynamic shared memory
  size_t stats, a, stage, q, k, v, cls_s, total;
  explicit __host__ __device__ GroupSmem(int D) {
    size_t off = 0;
    stats = off; off += sizeof(float2) * kMaxRows;
    a = off;     off += sizeof(bf16) * kChunk * (D + 8);
    off = (off + 127) / 128 * 128;
    stage = off; off += sizeof(float) * kWarps * 256;
    q = off;     off += sizeof(bf16) * kMaxRows * kQKVStride;
    k = off;     off += sizeof(bf16) * kMaxRows * kQKVStride;
    v = off;     off += sizeof(bf16) * kMaxRows * kQKVStride;
    cls_s = off; off += sizeof(float) * kMaxRows;
    total = off;
  }
};

__global__ void __launch_bounds__(kWarps * 32)
group_attention_kernel(
    const bf16* __restrict__ x, const float* __restrict__ ln_s,
    const float* __restrict__ ln_b, const bf16* __restrict__ wqkv,
    const float* __restrict__ bqkv, const bf16* __restrict__ cls_q,
    const bf16* __restrict__ cls_k, const bf16* __restrict__ cls_v,
    bf16* __restrict__ attn, float* __restrict__ part_m,
    float* __restrict__ part_l, float* __restrict__ part_acc, int N, int D,
    int H, int L, int pack_rows, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const GroupSmem lay(D);
  float2* stats = reinterpret_cast<float2*>(smem + lay.stats);
  bf16* a_sm = reinterpret_cast<bf16*>(smem + lay.a);
  float* stage = reinterpret_cast<float*>(smem + lay.stage);
  bf16* q_sm = reinterpret_cast<bf16*>(smem + lay.q);
  bf16* k_sm = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* v_sm = reinterpret_cast<bf16*>(smem + lay.v);
  float* cls_s = reinterpret_cast<float*>(smem + lay.cls_s);

  const int pack = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_packs = gridDim.x;
  const int r0 = pack * pack_rows;
  const int nrows = min(pack_rows, N - r0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lda = D + 8;
  const float scale = rsqrtf(static_cast<float>(kHD));
  const bf16* xb = x + (static_cast<size_t>(b) * N + r0) * D;

  // 1. per-row LN statistics of the pack
  for (int r = warp; r < nrows; r += kWarps) {
    const float2 st = warp_row_stats(xb + static_cast<size_t>(r) * D, D, eps);
    if (lane == 0) stats[r] = st;
  }
  __syncthreads();

  // 2. q/k/v of head h for the pack, 32 LN'd rows at a time. Warp w owns
  //    row tile w/4 of the chunk and 3 of the 12 column tiles (q 0-3,
  //    k 4-7, v 8-11) of the head's 192 output columns.
  const int rt = warp / 4;
  const int n_chunks = (nrows + kChunk - 1) / kChunk;
  float* wst = stage + warp * 256;
  for (int c = 0; c < n_chunks; ++c) {
    for (int rr = warp; rr < kChunk; rr += kWarps) {
      const int r = c * kChunk + rr;
      bf16* dst = a_sm + rr * lda;
      if (r < nrows) {
        const float2 st = stats[r];
        const bf16* src = xb + static_cast<size_t>(r) * D;
        for (int col = lane; col < D; col += 32)
          dst[col] = __float2bfloat16((to_f(src[col]) - st.x) * st.y *
                                      ln_s[col] + ln_b[col]);
      } else {
        for (int col = lane; col < D; col += 32)
          dst[col] = __float2bfloat16(0.f);
      }
    }
    __syncthreads();

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) wmma::fill_fragment(acc[j], 0.f);
    for (int kk = 0; kk < D; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, a_sm + rt * 16 * lda + kk, lda);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int ct = (warp % 4) * 3 + j;
        const int grow = (ct / 4) * D + h * kHD + (ct % 4) * 16;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, wqkv + static_cast<size_t>(grow) * D + kk, D);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int ct = (warp % 4) * 3 + j;
      const int sel = ct / 4;
      const int col0 = (ct % 4) * 16;
      const int gcol = sel * D + h * kHD + col0;
      wmma::store_matrix_sync(wst, acc[j], 16, wmma::mem_row_major);
      __syncwarp();
      bf16* dst = sel == 0 ? q_sm : (sel == 1 ? k_sm : v_sm);
      for (int i = lane; i < 256; i += 32) {
        const int r = i / 16, cc = i % 16;
        float val = wst[i] + bqkv[gcol + cc];
        if (sel == 0) val *= scale;
        dst[(c * kChunk + rt * 16 + r) * kQKVStride + col0 + cc] =
            __float2bfloat16(val);
      }
      __syncwarp();
    }
    __syncthreads();
  }

  // 3. token queries: one warp per row, one lane per key of its group
  const size_t cls_off = static_cast<size_t>(b) * D + h * kHD;
  const float ck0 = to_f(cls_k[cls_off + 2 * lane]);
  const float ck1 = to_f(cls_k[cls_off + 2 * lane + 1]);
  const float cv0 = to_f(cls_v[cls_off + 2 * lane]);
  const float cv1 = to_f(cls_v[cls_off + 2 * lane + 1]);
  for (int i = warp; i < nrows; i += kWarps) {
    const int g0 = (i / L) * L;
    warp_group_attention_row(
        q_sm + i * kQKVStride, k_sm + g0 * kQKVStride, v_sm + g0 * kQKVStride,
        L, ck0, ck1, cv0, cv1,
        reinterpret_cast<__nv_bfloat162*>(
            attn + (static_cast<size_t>(b) * N + r0 + i) * D + h * kHD));
  }

  // 4. CLS query partials over the pack's rows
  const float cq0 = to_f(cls_q[cls_off + 2 * lane]);
  const float cq1 = to_f(cls_q[cls_off + 2 * lane + 1]);
  for (int j = warp; j < nrows; j += kWarps) {
    const float2 kv = __bfloat1622float2(
        reinterpret_cast<const __nv_bfloat162*>(k_sm + j * kQKVStride)[lane]);
    const float sj = warp_sum(cq0 * kv.x + cq1 * kv.y);
    if (lane == 0) cls_s[j] = sj;
  }
  __syncthreads();
  float m = -INFINITY;
  for (int j = 0; j < nrows; ++j) m = fmaxf(m, cls_s[j]);
  const size_t pidx = (static_cast<size_t>(b) * n_packs + pack) * H + h;
  if (threadIdx.x < kHD) {
    const int d = threadIdx.x;
    float l = 0.f, a = 0.f;
    for (int j = 0; j < nrows; ++j) {
      const float e = expf(cls_s[j] - m);
      l += e;
      a += e * to_f(v_sm[j * kQKVStride + d]);
    }
    part_acc[pidx * kHD + d] = a;
    if (d == 0) {
      part_m[pidx] = m;
      part_l[pidx] = l;
    }
  }
}

// y[M, N] = x + A[M, K] @ W[N, K]^T + bias: 64x64 block tiles, 4 warps of
// 32x32 (2x2 wmma tiles), K in steps of 32 staged through shared memory.
constexpr int kBM = 64, kBN = 64, kBK = 32, kPad = 8;

__global__ void __launch_bounds__(128)
proj_residual_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                     const float* __restrict__ bias,
                     const bf16* __restrict__ resid, bf16* __restrict__ y,
                     int M, int N, int K) {
  __shared__ __align__(128) bf16 a_sm[kBM][kBK + kPad];
  __shared__ __align__(128) bf16 w_sm[kBN][kBK + kPad];
  __shared__ __align__(128) float c_sm[kBM][kBN + 4];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // 64 rows x 32 cols of A and of W: 256 16-byte vectors each
    for (int v = threadIdx.x; v < kBM * kBK / 8; v += blockDim.x) {
      const int r = v / (kBK / 8), c = (v % (kBK / 8)) * 8;
      uint4 av = make_uint4(0, 0, 0, 0);
      if (m0 + r < M)
        av = *reinterpret_cast<const uint4*>(A + static_cast<size_t>(m0 + r) * K + k0 + c);
      *reinterpret_cast<uint4*>(&a_sm[r][c]) = av;
      *reinterpret_cast<uint4*>(&w_sm[r][c]) =
          *reinterpret_cast<const uint4*>(W + static_cast<size_t>(n0 + r) * K + k0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &a_sm[wm + i * 16][kk], kBK + kPad);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &w_sm[wn + j * 16][kk], kBK + kPad);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&c_sm[wm + i * 16][wn + j * 16], acc[i][j],
                              kBN + 4, wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < kBM * kBN; e += blockDim.x) {
    const int r = e / kBN, c = e % kBN;
    if (m0 + r >= M) continue;
    const size_t g = static_cast<size_t>(m0 + r) * N + n0 + c;
    y[g] = __float2bfloat16(to_f(resid[g]) + bias[n0 + c] + c_sm[r][c]);
  }
}

}  // namespace

// x, attn [B', N, D]; wqkv [3D, D] (q|k|v rows); bqkv [3D] f32;
// cls_q/k/v [B', D] (cls_q pre-scaled); part_m/l [B', n_packs, H];
// part_acc [B', n_packs, H, 64]. pack_rows is a multiple of L, <= 256.
extern "C" int vt_group_attention(const void* x, const void* ln_s,
                                  const void* ln_b, const void* wqkv,
                                  const void* bqkv, const void* cls_q,
                                  const void* cls_k, const void* cls_v,
                                  void* attn, void* part_m, void* part_l,
                                  void* part_acc, int Bp, int N, int D, int H,
                                  int L, int pack_rows, float eps,
                                  void* stream) {
  if (D != H * kHD || D % 32 != 0 || L <= 0 || L > kMaxRows ||
      pack_rows % L != 0 || pack_rows > kMaxRows || N % L != 0)
    return cudaErrorInvalidValue;
  const size_t smem = GroupSmem(D).total;
  static const cudaError_t attr_err = allow_max_smem(group_attention_kernel);
  if (attr_err != cudaSuccess) return attr_err;
  const int n_packs = (N + pack_rows - 1) / pack_rows;
  group_attention_kernel<<<dim3(n_packs, H, Bp), kWarps * 32, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<const bf16*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<const bf16*>(cls_q),
      static_cast<const bf16*>(cls_k), static_cast<const bf16*>(cls_v),
      static_cast<bf16*>(attn), static_cast<float*>(part_m),
      static_cast<float*>(part_l), static_cast<float*>(part_acc), N, D, H, L,
      pack_rows, eps);
  return cudaGetLastError();
}

// attn, resid, y [M, N]; W [N, K] (torch Linear layout); bias [N] f32.
extern "C" int vt_proj_residual(const void* attn, const void* w,
                                const void* bias, const void* resid, void* y,
                                int M, int N, int K, void* stream) {
  if (N % kBN != 0 || K % kBK != 0) return cudaErrorInvalidValue;
  dim3 grid(N / kBN, (M + kBM - 1) / kBM);
  proj_residual_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(attn), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<const bf16*>(resid),
      static_cast<bf16*>(y), M, N, K);
  return cudaGetLastError();
}

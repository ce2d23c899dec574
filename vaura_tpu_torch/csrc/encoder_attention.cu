// Fused divided-attention sublayer of the MotionFormer encoder, in three
// launches:
//   (n) vt_layernorm_rows: LN of every token row, once, rounded to bf16;
//   (a) vt_group_attention: per (pack of whole groups, head, batch row)
//       this head's q/k/v projection of the normalised rows -> masked group
//       attention with the shared CLS key/value column -> the head's
//       attention output, plus the CLS query's flash partials (max, sumexp,
//       weighted values) over the pack's rows;
//   (b) vt_proj_residual: y = x + attn @ Wproj^T + bproj, a pipelined bf16
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
// 2*B'*N*D*4D = 59 GFLOP and the group attention 4*B'*N*L*D (L=196 on the
// space axis: 7.5 GFLOP), all on the tensor cores, against about
// 2*B'*N*D*2 = 38 MB of activations read and written. What binds the q/k/v
// product inside an SM is not the tensor cores but the shared-memory pipe
// (128 bytes a cycle) that feeds them: a k-slab of 64 costs wgmma 128 KB of
// operand reads (the 24 KB of weights again for each of the 4 warpgroups)
// and the copies 56 KB of writes, 1,440 cycles against 1,536 of arithmetic,
// so every further pass over shared memory shows in full.
//
// Design:
//  * Both products run as wgmma (m64n192k16, float32 sums in registers) on
//    128-byte-swizzled shared-memory tiles, both operands copied by cp.async
//    (16 bytes a thread, no registers) into a ring of k-slabs of 64: three
//    stages in (a), four in (b). A step queues the product on slab s behind
//    the one on slab s - 1, waits for that one and for slab s + 1, and only
//    then requests the slab after into the stage set free, so the tensor
//    cores never wait for a barrier.
//  * Layer norm is a launch of its own, (n): one group on the space axis is
//    L=196 rows x 768 = 301 KB of LN'd bf16, more than a block's 227 KB, and
//    an earlier form of (a) that took row statistics and normalised each
//    k-slab in shared memory, in place, on its way to wgmma paid for it
//    twice: once per head (12x the arithmetic) and, worse, with 64 KB more
//    shared-memory traffic a slab on the pipe that is the bottleneck (4,750
//    cycles a slab against 2,070 now; NVIDIA H100 80GB HBM3, 700 W). (n)
//    moves 38 MB once, and its output is read back from L2.
//  * (a) keeps one block per (pack, head, batch row): the 192 columns of a
//    head are exactly one wgmma width, and the [256, 192] float32 sums of
//    four warpgroups of 64 rows fill three quarters of the SM's registers
//    (96 a thread), which is also why a block cannot hold a second head or
//    the output projection's [rows, 768] sums. A pack is as many whole
//    groups as fit 256 rows (time axis 32 groups of 8, space axis one of
//    196); the grid's 672-768 blocks fill 132 SMs five to six times.
//  * q/k/v of the pack are rounded to bf16 into shared memory over the ring
//    (it is free by then), q pre-scaled. Attention runs on the tensor cores
//    for every group length, flash-style in registers: a warp takes 16
//    consecutive rows of the pack, S = Q K^T by mma.sync from ldmatrix
//    fragments in chunks of 64 keys (16 where no more are left) over the
//    groups those rows touch, each row masked to its own group, an online
//    float32 softmax on the fragments (no score strip in shared memory), the
//    unnormalised probabilities rounded to bf16 as the A operand of
//    O += P V, one division by the float32 denominator at the end. The CLS
//    key/value are a chunk of their own (one valid key), taken first. An
//    earlier form kept one warp per query row for the time axis's groups of
//    8 keys; it took as long as the whole q/k/v product.
//  * (b) is a 128 x 192 tile per block (392 blocks: three full waves of 132
//    SMs at the flagship shape); the residual tile is copied to shared
//    memory ahead of the loop and the sums are staged through shared memory,
//    so that y is written in 16-byte rows and the epilogue waits for no
//    device memory. The per-head attention output still makes one round trip
//    through device memory between (a) and (b).
//
// (n) and (b) are the layer norm and the GEMM of gemm.cuh, which the MLP
// sublayer (encoder_mlp.cu) launches too; the attention of step 4 is
// group_attention.cuh's, which grouped_cls_attention.cu runs as well.
#include "common.cuh"
#include "gemm.cuh"
#include "group_attention.cuh"

namespace {

constexpr int kHD = kAttnHD;           // head dim the kernel is built for
constexpr int kRows = kAttnMaxKeys;    // rows of one pack, at most
constexpr int kWG = kRows / 64;        // warpgroups of 64 rows
constexpr int kThreads = kWG * 128;
constexpr int kWarps = kThreads / 32;
static_assert(3 * kHD == kGemmCols, "one head's q | k | v is one wgmma width");
constexpr int kPadRows = 16;     // a query or key tile may overhang the pack

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Byte offsets into dynamic shared memory (from a 1024-byte boundary). While
// the q/k/v product runs: a ring of kStages k-slabs, each the pack's
// activations (A) and the head's weights (W), both swizzled for wgmma.
// Afterwards q, k and v are laid over the ring.
constexpr int kStages = 3;
struct GroupSmem {
  static constexpr int kStageA = kWG * kTileA;
  static constexpr int kStage = kStageA + kTileW;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kQKV = (kRows + kPadRows) * kMmaStride * 2;  // one of 3
  static constexpr int q = 0, k = kQKV, v = 2 * kQKV;
  static_assert(3 * kQKV <= kRing, "q, k, v fit over the ring");
  static constexpr int cls_k = round_up(kRing, 1024);        // bf16[16][72]
  static constexpr int cls_v = cls_k + 16 * kMmaStride * 2;
  static constexpr int cls_s = cls_v + 16 * kMmaStride * 2;  // float[kRows]
  static constexpr int cls_e = cls_s + 4 * kRows;            // float[kRows]
  static constexpr int red = cls_e + 4 * kRows;              // float[8][64]
  static constexpr int total = red + 4 * (kThreads / kHD) * kHD + 1024;
};

__global__ void __launch_bounds__(kThreads, 1)
group_attention_kernel(
    const bf16* __restrict__ x_ln, const bf16* __restrict__ wqkv,
    const float* __restrict__ bqkv,
    const bf16* __restrict__ cls_q, const bf16* __restrict__ cls_k,
    const bf16* __restrict__ cls_v, bf16* __restrict__ attn,
    float* __restrict__ part_m, float* __restrict__ part_l,
    float* __restrict__ part_acc, int N, int D, int H, int L, int pack_rows) {
  using Lay = GroupSmem;
  constexpr int T = kThreads;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t smem_base = smem_u32(smem);
  bf16* q_sm = reinterpret_cast<bf16*>(smem + Lay::q);
  bf16* k_sm = reinterpret_cast<bf16*>(smem + Lay::k);
  bf16* v_sm = reinterpret_cast<bf16*>(smem + Lay::v);
  bf16* ck_sm = reinterpret_cast<bf16*>(smem + Lay::cls_k);
  bf16* cv_sm = reinterpret_cast<bf16*>(smem + Lay::cls_v);
  float* cls_s = reinterpret_cast<float*>(smem + Lay::cls_s);
  float* cls_e = reinterpret_cast<float*>(smem + Lay::cls_e);
  float* red = reinterpret_cast<float*>(smem + Lay::red);

  const int pack = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_packs = gridDim.x;
  const int r0 = pack * pack_rows;
  const int nrows = min(pack_rows, N - r0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;
  const bool wg_active = wg * 64 < nrows;
  const bf16* xb = x_ln + (static_cast<size_t>(b) * N + r0) * D;
  const int n_slabs = D / kSlabK;

  // A thread copies the same 16-byte vectors of every k-slab: chunk tid % 8
  // of row tid / 8 of each of the kWG activation tiles (zeros for rows past
  // the pack) and of the head's q, k and v weight rows, all at one swizzled
  // offset inside their 64-row tile.
  static_assert(kThreads == 64 * 8, "one thread per 16-byte vector of a 64-row tile");
  const int row64 = tid >> 3, c8 = tid & 7;
  const uint32_t off64 = swz128(row64, c8);
  const bf16* x_src = xb + static_cast<size_t>(row64) * D + c8 * 8;
  const bf16* w_src = wqkv + (static_cast<size_t>(h) * kHD + row64) * D + c8 * 8;
  auto load_slab = [&](int s) {
    const uint32_t dst = smem_base + (s % kStages) * Lay::kStage + off64;
#pragma unroll
    for (int i = 0; i < kWG; ++i) {
      const bool ok = i * 64 + row64 < nrows;
      cp_async16(dst + i * kTileA,
                 x_src + (ok ? static_cast<size_t>(i) * 64 * D : 0) + s * kSlabK, ok);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i)  // the head's q | k | v rows
      cp_async16(dst + Lay::kStageA + i * kTileA,
                 w_src + static_cast<size_t>(i) * D * D + s * kSlabK);
  };

  // 1. the first two slabs are on their way while the CLS key/value (row 0
  //    of a 16-key chunk of their own) are fetched
  load_slab(0);
  cp_async_commit();
  if (n_slabs > 1) load_slab(1);
  cp_async_commit();
  const size_t cls_off = static_cast<size_t>(b) * D + h * kHD;
  for (int i = tid; i < 16 * kMmaStride; i += T) {
    const int r = i / kMmaStride, c = i % kMmaStride;
    const bool take = r == 0 && c < kHD;
    ck_sm[i] = take ? cls_k[cls_off + c] : __float2bfloat16(0.f);
    cv_sm[i] = take ? cls_v[cls_off + c] : __float2bfloat16(0.f);
  }
  cp_async_wait<1>();
  fence_proxy_async();
  __syncthreads();

  // 2. q | k | v = LN(x) Wqkv_h^T: each warpgroup 64 rows x 192 columns.
  //    Entering step s, slab s has landed and slab s + 1 is in flight. The
  //    step starts the product on slab s, makes sure the one on slab s - 1
  //    is done and slab s + 1 has landed, and requests slab s + 2 into the
  //    stage that product has left: the tensor cores always have the next
  //    product queued behind the one they work on.
  float acc[96];
#pragma unroll
  for (int i = 0; i < 96; ++i) acc[i] = 0.f;
  for (int s = 0; s < n_slabs; ++s) {
    if (wg_active) {
      const uint32_t stage = smem_base + (s % kStages) * Lay::kStage;
      wgmma_fence();
      wgmma_slab(acc, stage + wg * kTileA, stage + Lay::kStageA);
      wgmma_commit();
    }
    wgmma_wait<1>();
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (s + 2 < n_slabs) load_slab(s + 2);
    cp_async_commit();
  }
  wgmma_wait<0>();
  wgmma_acc_fence(acc);
  cp_async_wait<0>();
  __syncthreads();

  // 3. bias, q scaled, rounded to bf16 over the ring. Rows past the pack are
  //    finite (their A rows were zeros); the overhang rows are zeroed.
  {
    static_assert(kHD == 64, "the query scale below is 1 / sqrt(64)");
    constexpr float scale = 0.125f;
    const int row = wg * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < 24; ++j) {
      const int sel = j / 8, c = (j % 8) * 8 + 2 * (lane & 3);
      const float2 bb = __ldg(reinterpret_cast<const float2*>(
          bqkv + static_cast<size_t>(sel) * D + h * kHD + c));
      const float mul = sel == 0 ? scale : 1.f;
      bf16* dst = sel == 0 ? q_sm : (sel == 1 ? k_sm : v_sm);
      *reinterpret_cast<uint32_t*>(dst + row * kMmaStride + c) =
          pack_bf16((acc[4 * j] + bb.x) * mul, (acc[4 * j + 1] + bb.y) * mul);
      *reinterpret_cast<uint32_t*>(dst + (row + 8) * kMmaStride + c) =
          pack_bf16((acc[4 * j + 2] + bb.x) * mul, (acc[4 * j + 3] + bb.y) * mul);
    }
    for (int i = tid; i < kPadRows * kMmaStride; i += T) {
      q_sm[kRows * kMmaStride + i] = __float2bfloat16(0.f);
      k_sm[kRows * kMmaStride + i] = __float2bfloat16(0.f);
      v_sm[kRows * kMmaStride + i] = __float2bfloat16(0.f);
    }
  }
  __syncthreads();

  // 4. token queries, 16 consecutive rows of the pack a warp: against the
  //    CLS column, then against the keys of every group the 16 rows touch,
  //    each row masked to its own group
  group_attention_rows<false>(
      q_sm, k_sm, v_sm, ck_sm, cv_sm, nrows, L, warp, kWarps,
      attn + (static_cast<size_t>(b) * N + r0) * D + h * kHD, D);

  // 5. CLS query partials over the pack's rows: scores, max, exponentials,
  //    then the value sum split over T / 64 parts of the rows
  {
    // four rows a warp at a time: eight lanes a row, eight dims a lane
    const int sub = lane >> 3, d0 = (lane & 7) * 8;
    float cq[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) cq[e] = to_f(cls_q[cls_off + d0 + e]);
    for (int j = warp * 4 + sub; j < nrows + sub; j += kWarps * 4) {
      float a = 0.f;
      if (j < nrows) {
        const uint4 kv = *reinterpret_cast<const uint4*>(k_sm + j * kMmaStride + d0);
        const __nv_bfloat162* kp = reinterpret_cast<const __nv_bfloat162*>(&kv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 k2 = __bfloat1622float2(kp[e]);
          a += cq[2 * e] * k2.x + cq[2 * e + 1] * k2.y;
        }
      }
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      a += __shfl_xor_sync(0xffffffffu, a, 4);
      if (j < nrows && (lane & 7) == 0) cls_s[j] = a;
    }
  }
  __syncthreads();
  float m = -INFINITY;
  for (int j = lane; j < nrows; j += 32) m = fmaxf(m, cls_s[j]);
  m = warp_max(m);
  float lsum = 0.f;
  for (int j = lane; j < nrows; j += 32) lsum += expf(cls_s[j] - m);
  lsum = warp_sum(lsum);
  for (int j = tid; j < nrows; j += T) cls_e[j] = expf(cls_s[j] - m);
  __syncthreads();
  {
    constexpr int kParts = T / kHD;
    const int d = tid % kHD, part = tid / kHD;
    float a = 0.f;
    for (int j = part; j < nrows; j += kParts)
      a += cls_e[j] * to_f(v_sm[j * kMmaStride + d]);
    red[part * kHD + d] = a;
    __syncthreads();
    if (tid < kHD) {
      float tot = 0.f;
#pragma unroll
      for (int p = 0; p < kParts; ++p) tot += red[p * kHD + tid];
      const size_t pidx = (static_cast<size_t>(b) * n_packs + pack) * H + h;
      part_acc[pidx * kHD + tid] = tot;
      if (tid == 0) {
        part_m[pidx] = m;
        part_l[pidx] = lsum;
      }
    }
  }
}

}  // namespace

// y [M, D] = layer norm of x [M, D] (bf16), scale and bias [D] f32.
extern "C" int vt_layernorm_rows(const void* x, const void* ln_s,
                                 const void* ln_b, void* y, int M, int D,
                                 float eps, void* stream) {
  return launch_layernorm_rows(x, ln_s, ln_b, y, M, D, eps,
                               static_cast<cudaStream_t>(stream));
}

// x_ln (from vt_layernorm_rows), attn [B', N, D]; wqkv [3D, D] (q|k|v rows);
// bqkv [3D] f32; cls_q/k/v [B', D] (cls_q pre-scaled); part_m/l
// [B', n_packs, H]; part_acc [B', n_packs, H, 64]. pack_rows is a multiple
// of L, <= 256.
extern "C" int vt_group_attention(const void* x_ln, const void* wqkv,
                                  const void* bqkv, const void* cls_q,
                                  const void* cls_k, const void* cls_v,
                                  void* attn, void* part_m, void* part_l,
                                  void* part_acc, int Bp, int N, int D, int H,
                                  int L, int pack_rows, void* stream) {
  if (D != H * kHD || L <= 0 || L > kRows || pack_rows % L != 0 ||
      pack_rows > kRows || N % L != 0 || Bp <= 0 || Bp > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  static const cudaError_t attr_err = allow_max_smem(group_attention_kernel);
  if (attr_err != cudaSuccess) return attr_err;
  const int n_packs = (N + pack_rows - 1) / pack_rows;
  group_attention_kernel<<<dim3(n_packs, H, Bp), kThreads, GroupSmem::total,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x_ln), static_cast<const bf16*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<const bf16*>(cls_q),
      static_cast<const bf16*>(cls_k), static_cast<const bf16*>(cls_v),
      static_cast<bf16*>(attn), static_cast<float*>(part_m),
      static_cast<float*>(part_l), static_cast<float*>(part_acc), N, D, H, L,
      pack_rows);
  return cudaGetLastError();
}

// attn, resid, y [M, N]; W [N, K] (torch Linear layout); bias [N] f32.
extern "C" int vt_proj_residual(const void* attn, const void* w,
                                const void* bias, const void* resid, void* y,
                                int M, int N, int K, void* stream) {
  return launch_gemm_bias<kEpiResidual>(attn, w, bias, resid, y, M, N, K,
                                        static_cast<cudaStream_t>(stream));
}

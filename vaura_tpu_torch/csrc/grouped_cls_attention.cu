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
// blocks to give the TPU's matrix unit a tile of its shape; here a 16-row
// query tile meets only the keys of the groups its rows belong to.
//
// Bound on the H100: bytes. q, k, v are read and out is written once
// (4 * BH*G*L*64 * 2 bytes, 77 MB an axis at the flagship shapes: 0.023 ms)
// against 4 * BH*G*L*(L+1)*64 operations (7.6 GFLOP on the space axis, 0.3
// on the time axis), far below 295 operations per byte.
//
// Design: one kernel for every group length. The groups of one bh are
// contiguous rows of [G*L, 64]; a block takes one pack of whole groups
// (pack_rows = a multiple of L, <= 256 rows; the last pack may be shorter).
//  * Every byte is read from device memory once, by cp.async (16 bytes a
//    thread, no registers) into tiles of 144-byte rows; the 16 rows after
//    the pack's last arrive as zeros (a query or key tile may overhang).
//  * The attention is group_attention.cuh's, the one the fused encoder
//    sublayer runs: 16 query rows a warp, S = Q K^T and O += P V by mma.sync
//    from ldmatrix fragments, online float32 softmax in registers, each row
//    masked to its own group, the CLS column a chunk of its own. No score or
//    probability ever touches shared memory. The rounding is the Pallas
//    kernel's: unnormalised bf16 probabilities, float32 denominator, one
//    rounding of the output.
//  * The output tile goes back through the warp's own 16 query rows in
//    shared memory, so a warp writes whole 128-byte rows, 16 bytes a lane.
//  * q/k/v of 196 + 16 rows are 92 KB, of a time-axis pack of 128 rows 62
//    KB, and a thread has at most 128 registers: two blocks of 8 warps share
//    an SM, and one block's loads hide behind the other's arithmetic. The
//    wrapper picks pack rows and warps (ops/divided_attention.py::
//    grouped_plan mirrors the launch).
// Measured on an NVIDIA H100 80GB HBM3 (700 W; chip_smoke.py, PERF.md): time
// axis 0.033 ms, space axis 0.064 ms (the library call 0.305 and 0.048). A
// block of the space axis spends 17 k cycles requesting its copies (a warp
// that requests cp.async copies stands while the memory system is busy, so
// the requests end when nearly all has landed) and 24 k on the attention, which
// the softmax's arithmetic on the CUDA cores binds, not the tensor cores.
// What did not pay: q and k in one commit group and v in a second, with the
// wait for v between the first scores and the first value product (the same
// time to 0.0003 ms, for the reason above); one bulk copy a row reported to
// an mbarrier a stripe of 64 rows (0.049 / 0.079 ms: 636 requests of 128
// bytes a block keep the copy engine busy for 20 k cycles); a warp that only
// copies, in stripes reported to mbarriers (0.041 / 0.076 ms: a ninth warp
// leaves 96 registers a thread and the attention spills).
// Earlier form (same card): two kernels. Groups shorter than 32 keys ran one
// warp a query row on the CUDA cores, 8 of 32 lanes holding a key (time axis
// 0.145 ms); longer ones one block a group with wmma tiles, a float32 score
// strip in shared memory, a serial 16-row softmax and synchronous loads
// through registers, 196 KB and so one block an SM (space axis 0.238 ms).
#include "common.cuh"
#include "group_attention.cuh"

namespace {

constexpr int kMaxWarps = 8;
constexpr int kPadRows = 16;   // a query or key tile may overhang the pack
constexpr int kTileRowBytes = kMmaStride * 2;

__host__ __device__ constexpr int grouped_smem_bytes(int pack_rows) {
  return (3 * (pack_rows + kPadRows) + 2 * 16) * kTileRowBytes;
}

__global__ void __launch_bounds__(kMaxWarps * 32, 2)
grouped_cls_attention_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ cls_k,
                             const bf16* __restrict__ cls_v,
                             bf16* __restrict__ out, int N, int L,
                             int pack_rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tile_rows = pack_rows + kPadRows;
  bf16* q_sm = reinterpret_cast<bf16*>(smem);
  bf16* k_sm = q_sm + tile_rows * kMmaStride;
  bf16* v_sm = k_sm + tile_rows * kMmaStride;
  bf16* ck_sm = v_sm + tile_rows * kMmaStride;
  bf16* cv_sm = ck_sm + 16 * kMmaStride;

  const int pack = blockIdx.x, bh = blockIdx.y;
  const int r0 = pack * pack_rows;
  const int nrows = min(pack_rows, N - r0);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int n_threads = blockDim.x, n_warps = n_threads >> 5;
  const size_t base = (static_cast<size_t>(bh) * N + r0) * kAttnHD;

  // 1. the pack's q, k and v rows are requested; rows past the pack arrive as
  //    zeros
  constexpr int kVecs = kAttnHD / 8;
  const int n_vecs = (nrows + kPadRows) * kVecs;
  for (int i = tid; i < n_vecs; i += n_threads) {
    const int r = i / kVecs, c = (i % kVecs) * 8;
    const bool ok = r < nrows;
    const size_t g = base + (ok ? static_cast<size_t>(r) * kAttnHD + c : 0);
    const uint32_t off = (r * kMmaStride + c) * 2;
    cp_async16(smem_u32(q_sm) + off, q + g, ok);
    cp_async16(smem_u32(k_sm) + off, k + g, ok);
    cp_async16(smem_u32(v_sm) + off, v + g, ok);
  }
  cp_async_commit();
  // the CLS key/value: row 0 of a 16-key chunk of their own
  const size_t cls_off = static_cast<size_t>(bh) * kAttnHD;
  for (int i = tid; i < 16 * kMmaStride; i += n_threads) {
    const int r = i / kMmaStride, c = i % kMmaStride;
    const bool take = r == 0 && c < kAttnHD;
    ck_sm[i] = take ? cls_k[cls_off + c] : __float2bfloat16(0.f);
    cv_sm[i] = take ? cls_v[cls_off + c] : __float2bfloat16(0.f);
  }

  // 2. everything has landed
  cp_async_wait<0>();
  __syncthreads();

  // 3. attention, 16 consecutive rows a warp
  group_attention_rows<true>(q_sm, k_sm, v_sm, ck_sm, cv_sm, nrows, L, warp,
                             n_warps, out + base, kAttnHD);
  // 4. done
}

}  // namespace

// q, k, v, out [BH, N = G*L, 64] bf16 (groups of L consecutive rows);
// cls_k, cls_v [BH, 64] bf16. L <= 256; pack_rows is a multiple of L,
// <= 256; a block has n_warps <= 8 warps.
extern "C" int vt_grouped_cls_attention(const void* q, const void* k,
                                        const void* v, const void* cls_k,
                                        const void* cls_v, void* out, int BH,
                                        int N, int L, int pack_rows,
                                        int n_warps, void* stream) {
  if (BH <= 0 || BH > 65535 || L <= 0 || L > kAttnMaxKeys || N <= 0 ||
      N % L != 0 || pack_rows <= 0 || pack_rows % L != 0 ||
      pack_rows > kAttnMaxKeys || n_warps <= 0 || n_warps > kMaxWarps)
    return cudaErrorInvalidValue;
  static const cudaError_t attr_err =
      allow_max_smem(grouped_cls_attention_kernel);
  if (attr_err != cudaSuccess) return attr_err;
  const int n_packs = (N + pack_rows - 1) / pack_rows;
  grouped_cls_attention_kernel<<<dim3(n_packs, BH), n_warps * 32,
                                 grouped_smem_bytes(pack_rows),
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(cls_k),
      static_cast<const bf16*>(cls_v), static_cast<bf16*>(out), N, L,
      pack_rows);
  return cudaGetLastError();
}

// The group attention with a shared CLS key/value column that both
// encoder_attention.cu (the fused sublayer, on the q/k/v it has just
// projected) and grouped_cls_attention.cu (the stand-alone op, on q/k/v from
// device memory) run on a pack of whole groups held in shared memory:
//
//   out[row] = softmax([q . cls_k, q K_g^T]) @ [cls_v; V_g]   g = row / L
//
// Every group length runs on the tensor cores, flash-style in registers: a
// warp takes 16 consecutive rows of the pack, S = Q K^T by mma.sync m16n8k16
// from ldmatrix fragments in chunks of 64 keys (16 where no more are left)
// over the groups those rows touch, each row masked to its own group, an
// online float32 softmax on the fragments (no score strip in shared memory),
// the unnormalised probabilities rounded to bf16 as the A operand of
// O += P V, one division by the float32 denominator at the end and one
// rounding of the output. The CLS key/value are a chunk of their own (one
// valid key), taken first, so the running maximum is finite from then on.
//
// Tiles: q, k, v rows of kMmaStride bf16 (144 bytes: eight consecutive rows
// start in eight different 16-byte bank groups), 16 finite rows of overhang
// after the pack's last row; the CLS key and value each row 0 of a 16-row
// tile of the same stride whose other rows are zero.
#pragma once

#include "common.cuh"

// One chunk of NT*8 keys for a warp's 16 query rows: S = Q K^T, online
// softmax, O += P V. k_addr/v_addr: shared-memory addresses of the chunk's
// first key row (row stride kMmaStride); the first n_valid keys of the chunk
// are looked at, and of those the query row r (0: lane / 4, 1: eight rows
// further down) takes the keys lo[r] <= key < hi[r], those of its own group.
template <int NT>
__device__ __forceinline__ void attention_chunk(const uint32_t (&qf)[4][4],
                                                uint32_t k_addr, uint32_t v_addr,
                                                int n_valid, const int (&lo)[2],
                                                const int (&hi)[2],
                                                float (&o)[8][4], float (&m)[2],
                                                float (&l)[2]) {
  const int lane = threadIdx.x & 31;
  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  const uint32_t k_lane =
      k_addr + (((lane & 7) + ((lane >> 4) << 3)) * kMmaStride + ((lane >> 3) & 1) * 8) * 2;
#pragma unroll
  for (int p = 0; p < NT / 2; ++p) {
    if (p * 16 < n_valid) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t b[4];
        ldmatrix_x4(b, k_lane + (p * 16 * kMmaStride + kk * 16) * 2);
        mma_m16n8k16(s[2 * p], qf[kk], b[0], b[1]);
        mma_m16n8k16(s[2 * p + 1], qf[kk], b[2], b[3]);
      }
    }
  }
  // a chunk that lies inside the group of every row of the warp (the inner
  // chunks of a long group) needs no mask
  const bool inside = __all_sync(0xffffffffu, lo[0] <= 0 && lo[1] <= 0 &&
                                                  hi[0] >= NT * 8 && hi[1] >= NT * 8);
  if (!inside) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * (lane & 3) + (e & 1);
        if (col < lo[e >> 1] || col >= hi[e >> 1]) s[j][e] = -INFINITY;
      }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
  float corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r]);  // finite: the CLS chunk came first
    corr[r] = __expf(m[r] - mn);
    m[r] = mn;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] *= corr[e >> 1];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = __expf(s[j][e] - m[e >> 1]);
      l[e >> 1] += s[j][e];
    }
  const uint32_t v_lane =
      v_addr + (((lane & 7) + ((lane >> 3) & 1) * 8) * kMmaStride + (lane >> 4) * 8) * 2;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    if (kk * 16 < n_valid) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, v_lane + (kk * 16 * kMmaStride + dp * 16) * 2);
        mma_m16n8k16(o[2 * dp], a, b[0], b[1]);
        mma_m16n8k16(o[2 * dp + 1], a, b[2], b[3]);
      }
    }
  }
}

// The token queries of one pack of nrows rows (whole groups of L), 16
// consecutive rows a warp at a time, warp `warp` of `n_warps`: against the
// CLS column, then against the keys of every group the 16 rows touch, each
// row masked to its own group. Row `row` of the pack is written to
// out + row * out_stride (64 bf16). kStageOut false: straight from the
// fragments, four bytes a lane; true: through the warp's own 16 query rows in
// shared memory (read into registers by then), so that a lane stores 16
// bytes and a warp whole rows.
template <bool kStageOut>
__device__ __forceinline__ void group_attention_rows(
    bf16* q_sm, const bf16* k_sm, const bf16* v_sm, const bf16* ck_sm,
    const bf16* cv_sm, int nrows, int L, int warp, int n_warps,
    bf16* __restrict__ out, int out_stride) {
  const int lane = threadIdx.x & 31;
  for (int t0 = warp * 16; t0 < nrows; t0 += n_warps * 16) {
    const int k_lo = (t0 / L) * L;
    const int k_hi = (min(t0 + 15, nrows - 1) / L + 1) * L;
    int row[2], lo[2], hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      row[r] = t0 + (lane >> 2) + 8 * r;
      lo[r] = (row[r] / L) * L - k_lo;
      hi[r] = lo[r] + L;
    }
    uint32_t qf[4][4];
    const uint32_t q_lane = smem_u32(q_sm) +
        ((t0 + (lane & 15)) * kMmaStride + (lane >> 4) * 8) * 2;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) ldmatrix_x4(qf[kk], q_lane + kk * 32);
    float o[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    {
      const int cls_lo[2] = {0, 0}, cls_hi[2] = {1, 1};
      attention_chunk<2>(qf, smem_u32(ck_sm), smem_u32(cv_sm), 1, cls_lo, cls_hi,
                         o, m, l);
    }
    for (int c0 = 0; c0 < k_hi - k_lo; c0 += 64) {
      const int clo[2] = {lo[0] - c0, lo[1] - c0}, chi[2] = {hi[0] - c0, hi[1] - c0};
      const uint32_t k_at = smem_u32(k_sm + (k_lo + c0) * kMmaStride);
      const uint32_t v_at = smem_u32(v_sm + (k_lo + c0) * kMmaStride);
      const int left = k_hi - k_lo - c0;
      if (left <= 16)  // the time axis's two groups, or a long group's tail
        attention_chunk<2>(qf, k_at, v_at, left, clo, chi, o, m, l);
      else
        attention_chunk<8>(qf, k_at, v_at, min(64, left), clo, chi, o, m, l);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const float inv = 1.f / l[r];
      if (kStageOut) {
        bf16* dst = q_sm + row[r] * kMmaStride + 2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(dst + 8 * j) =
              pack_bf16(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
      } else if (row[r] < nrows) {
        bf16* dst = out + static_cast<size_t>(row[r]) * out_stride + 2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(dst + 8 * j) =
              pack_bf16(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
      }
    }
    if (kStageOut) {
      __syncwarp();
      for (int i = lane; i < 16 * (kAttnHD / 8); i += 32) {
        const int r = t0 + i / (kAttnHD / 8), c = (i % (kAttnHD / 8)) * 8;
        if (r < nrows)
          *reinterpret_cast<uint4*>(out + static_cast<size_t>(r) * out_stride + c) =
              *reinterpret_cast<const uint4*>(q_sm + r * kMmaStride + c);
      }
    }
  }
}

// Decode attention for one layer and one step: split-K flash decoding in
// ONE launch, the splits of a (batch row, KV head) merged inside a thread
// block cluster.
//
// Replaces the Pallas kernel vaura_tpu/ops/pallas_attention.py::
// decode_attention (kernel _make_kernel, :57; call :215). Same contract:
// the query of position `pos` attends over the cached positions < pos plus
// this position's own k_cur/v_cur, which the caller commits to the cache
// only after the step. As there, `pos` may live in device memory.
//
//   q      [B, H, hd]          bf16
//   k/v    [B, S, Hkv, hd]     bf16, one layer of the cache, read in place
//   k/v_cur[B, Hkv, hd]        bf16
//   out    [B, H, hd]          bf16
//   pos    host int, or one int32 in device memory (clamped to [0, S])
//
// Bound on the H100: bytes. Per layer and step the work reads
// 2*B*pos*Hkv*hd*2 bytes of cache and does about 4*B*H*pos*hd flops, far
// below the card's ~295 flops per byte. At the sizes the model decodes with
// (a few MB of cache prefix at most) the stream takes under a microsecond,
// so what a call costs is latency: launches, dependent memory round trips,
// barriers. The design spends one of each.
//
// Design:
//  * the current position is row `pos` of one sequence of pos + 1 rows: the
//    cache gives rows 0 .. pos - 1, k_cur/v_cur the last. Every block
//    fetches k_cur/v_cur beside its tile (384 bytes), and the block whose
//    tile holds row pos reads it from there: the merge then knows partials
//    only, and no load waits behind another.
//  * grid (tiles, B*Hkv), the `tiles` blocks of one (b, KV head) forming a
//    cluster of up to 8 (the portable limit): block `rank` takes the
//    64-row tiles rank, rank + cluster, ... that start at or below pos, and
//    a block with none has nothing to send. With pos on the host the
//    cluster is as large as pos needs; with pos in device memory it covers
//    S + 1 rows, so the launch is the same for every position and a
//    captured step can be replayed for the next one.
//  * a tile's K and V rows (hd*2 bytes each, 192 for hd = 96: no padding to
//    128) go to shared memory as bulk asynchronous copies (cp.async.bulk,
//    the TMA engine without a tensor map), one row a thread, all in flight
//    together and reported to one mbarrier: one memory latency a tile and
//    no load instruction per 16 bytes. Rows lie 32 bytes further apart than
//    their length, so that two lanes per row, each taking every other
//    16-byte vector, read their keys without bank conflicts. Measured on
//    an NVIDIA H100 80GB HBM3 at 700 W, flagship shapes, pos 228: with 13
//    cp.async a thread the tile was there 7,500 cycles after the start, with
//    the bulk copies 4,800; one TMA box a tile from a tensor map of the
//    cache always brings 64 rows and made a call slower (6.24 us against
//    5.86 in the mean over positions).
//  * a block serves every query head of its KV head from the one staged
//    tile (GQA reads the cache once per KV head, not once per query head).
//  * a warp takes 16 rows of the tile through scores, softmax and value sum
//    with shuffles alone; one barrier later the four warps' partials (and,
//    for a long cache, the block's earlier tiles) are merged by one thread
//    per output dim, which stores the block's (acc[hd], max, sum) straight
//    into rank 0's shared memory (distributed shared memory): one remote
//    store a thread. The stores are asynchronous (st.async) and report to
//    an mbarrier in rank 0, which knows from pos how many bytes to expect:
//    the senders neither fence nor wait and simply end, and rank 0 merges
//    the blocks as soon as the last byte is in and writes the bf16 output:
//    no scratch tensor, no second launch, no second cluster barrier. The
//    one cluster barrier, which makes sure rank 0 has started and set up its
//    mbarrier, is armed before the loads and awaited after the tile's
//    arithmetic, so it costs nothing.
//  * float32 scores, softmax and accumulators; the output is rounded to
//    bf16 once.
//
// The int8 cache (vt_decode_attention_int8, the second instantiation of the
// same kernel): k/v [B, S, Hkv, hd] int8 with one float32 scale per
// (position, KV head), k_scale/v_scale [B, S, Hkv] (the JAX package's
// layout, vaura_tpu/models/sampler.py:296-391, whose einsums this replaces:
// the JAX package has no Pallas kernel for it). A cache row is hd bytes (96
// at hd = 96: still one legal bulk copy, since its size and its 1,536-byte
// stride are 16-byte multiples) and the current position's k/v stay bf16,
// unquantized, in the tile's last row. The scales are not bulk-copied (a
// tile's 64 scales lie at the KV-head stride, 64 bytes apart): the lane that
// reads a row also loads its two scales from device memory, issued before
// the tile's wait so that their round trip runs beside the bulk copies. The
// kernel widens the int8 values in registers and folds k_scale into the
// score and v_scale into the probability that weighs the row's values (the
// softmax's sum takes the probability without it), as the einsums do. Half
// the cache bytes of bf16; at the serving batches where the cache is the
// step's largest read (B2 = 256: 4.3 GB a step in bf16) that halves the
// decode step's device time.
#include "common.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The address of the same shared-memory variable in another block of the
// cluster.
__device__ __forceinline__ uint32_t map_to_rank(uint32_t local, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}
// Asynchronous store of 4 bytes into another block's shared memory, reported
// to an mbarrier there: the sender neither waits for it nor fences.
__device__ __forceinline__ void store_async(uint32_t remote, float v, uint32_t remote_bar) {
  asm volatile(
      "st.async.weak.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::
          "r"(remote),
      "r"(__float_as_uint(v)), "r"(remote_bar)
      : "memory");
}

// mbarrier: every thread of the block arrives once per tile, adding the
// bytes of the bulk copies it is about to issue; the phase completes when
// all have arrived and all those bytes have landed.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// `bytes` (a multiple of 16) from device memory to shared memory, reported to
// the mbarrier; both addresses 16-byte aligned.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, int bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Dynamic shared memory: the K and V tiles (kTile rows and the current
// position's row), the mbarrier, then floats. Rows of a tile lie an odd
// multiple of 32 bytes apart, so that two lanes a row, each taking every
// other 16-byte vector, read without bank conflicts: bf16 rows are padded by
// 32 bytes, int8 rows (hd bytes) by 32 where hd / 32 is even. In an int8
// tile the current position's row is bf16 (2 * hd bytes) after the 64 rows.
template <int HD, bool Q8>
struct DecodeSmem {
  static constexpr int kRowBytes = Q8 ? HD + ((HD / 32) % 2 ? 0 : 32) : HD * 2 + 32;
  static constexpr int kTileBytes = Q8 ? kTile * kRowBytes + HD * 2 : (kTile + 1) * kRowBytes;
  static constexpr int kPW = HD + 2;  // a partial: acc[HD], max, sum
  static constexpr int tiles = 2 * kTileBytes;  // bytes
  static constexpr int bar = tiles;   // 8 bytes: the tiles; 8: rank 0's inbox
  static constexpr int floats_at = tiles + 16;
  // rep query heads per KV head, a cluster of cs blocks
  __host__ __device__ static size_t bytes(int rep, int cs) {
    const int floats = rep * HD                 // q, scaled
                       + kWarps * rep * kPW     // the warps' partials of a tile
                       + rep * kPW + rep * 2    // the block's running partial
                       + cs * rep * kPW;        // inbox (used in rank 0)
    return floats_at + sizeof(float) * floats;
  }
};

// q . k of one row of the tile for one query head: a lane takes every other
// 16-byte vector of the row (the other lane of its pair the rest), q in
// float32 from shared memory.
template <int HD>
__device__ __forceinline__ float dot_bf16_row(const unsigned char* kr, const float* qr,
                                              int odd) {
  float a = 0.f;
#pragma unroll
  for (int cc = 0; cc < HD / 16; ++cc) {
    const int c = 2 * cc + odd;
    const uint4 kv = *reinterpret_cast<const uint4*>(kr + c * 16);
    const __nv_bfloat162* kp = reinterpret_cast<const __nv_bfloat162*>(&kv);
    const float4 q0 = *reinterpret_cast<const float4*>(qr + c * 8);
    const float4 q1 = *reinterpret_cast<const float4*>(qr + c * 8 + 4);
    const float2 k0 = __bfloat1622float2(kp[0]), k1 = __bfloat1622float2(kp[1]);
    const float2 k2 = __bfloat1622float2(kp[2]), k3 = __bfloat1622float2(kp[3]);
    a += q0.x * k0.x + q0.y * k0.y + q0.z * k1.x + q0.w * k1.y +
         q1.x * k2.x + q1.y * k2.y + q1.z * k3.x + q1.w * k3.y;
  }
  return a;
}
template <int HD>
__device__ __forceinline__ float dot_int8_row(const unsigned char* kr, const float* qr,
                                              int odd) {
  float a = 0.f;
#pragma unroll
  for (int cc = 0; cc < HD / 32; ++cc) {
    const int c = 2 * cc + odd;
    const uint4 kv = *reinterpret_cast<const uint4*>(kr + c * 16);
    const char4* kp = reinterpret_cast<const char4*>(&kv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 qj = *reinterpret_cast<const float4*>(qr + c * 16 + 4 * j);
      a += qj.x * static_cast<float>(kp[j].x) + qj.y * static_cast<float>(kp[j].y) +
           qj.z * static_cast<float>(kp[j].z) + qj.w * static_cast<float>(kp[j].w);
    }
  }
  return a;
}

template <int HD, bool Q8>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const bf16* __restrict__ q, const void* __restrict__ kc,
              const void* __restrict__ vc, const float* __restrict__ ksc,
              const float* __restrict__ vsc, const bf16* __restrict__ kcur,
              const bf16* __restrict__ vcur, bf16* __restrict__ out, int H,
              int Hkv, int S, int pos_host, const int* __restrict__ pos_dev,
              float scale) {
  using Lay = DecodeSmem<HD, Q8>;
  constexpr int EB = Q8 ? 1 : 2;     // bytes of a cached element
  constexpr int RB = Lay::kRowBytes;
  constexpr int EPL = HD / 32;       // output dims a lane owns
  constexpr int PW = Lay::kPW;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* k_sm = smem;
  unsigned char* v_sm = smem + Lay::kTileBytes;
  const uint32_t bar = smem_u32(smem + Lay::bar);
  const int rep = H / Hkv;
  float* q_sm = reinterpret_cast<float*>(smem + Lay::floats_at);
  float* wpart = q_sm + rep * HD;           // [warp][head][PW]
  float* run = wpart + kWarps * rep * PW;   // [head][PW], written by a merge
  float* run_ml = run + rep * PW;           // [head][2], read by the next
  float* inbox = run_ml + rep * 2;          // [rank][head][PW]

  const uint32_t inbox_bar = bar + 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = blockIdx.x, cs = gridDim.x;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;

  // pos and the block's query heads (scaled, in float32) are requested
  // first, so that their round trip runs beside the barriers' set-up
  int pos = pos_dev ? *pos_dev : pos_host;
  const bf16* qb = q + (static_cast<size_t>(b) * H + hk * rep) * HD;
  const bf16 q_first = tid < rep * HD ? qb[tid] : __float2bfloat16(0.f);
  if (tid == 0) {
    mbar_init(bar, kThreads);
    mbar_init(inbox_bar, 1);
  }
  cluster_arrive();  // awaited before the first store into rank 0
  if (tid < rep * HD) q_sm[tid] = to_f(q_first) * scale;
  for (int i = tid + kThreads; i < rep * HD; i += kThreads)
    q_sm[i] = to_f(qb[i]) * scale;
  __syncthreads();
  pos = max(0, min(pos, S));
  const size_t row = static_cast<size_t>(Hkv) * HD;  // stride of a position
  const size_t first_row = (static_cast<size_t>(b) * S * row + static_cast<size_t>(hk) * HD) * EB;
  const unsigned char* kb = static_cast<const unsigned char*>(kc) + first_row;
  const unsigned char* vb = static_cast<const unsigned char*>(vc) + first_row;
  const size_t cur = (static_cast<size_t>(b) * Hkv + hk) * HD;
  // the scales of (b, position t, hk) lie at scale_b + t * Hkv
  const size_t scale_b = static_cast<size_t>(b) * S * Hkv + hk;

  // Thread (half, i) requests row t0 + i of K (half 0) or V (half 1), if the
  // cache holds it below pos; thread (half, 0) also the current position's,
  // once. Every thread arrives with the bytes it requests.
  const int half = tid >> 6, i64 = tid & (kTile - 1);
  unsigned char* my_sm = half ? v_sm : k_sm;
  const unsigned char* my_cache = half ? vb : kb;
  auto load_tile = [&](int t0, bool with_cur) {
    const bool mine = t0 + i64 < pos;
    const bool cur_row = with_cur && i64 == 0;
    mbar_arrive_expect(bar, mine * HD * EB + cur_row * HD * 2);
    if (mine)
      bulk_copy(smem_u32(my_sm + i64 * RB),
                my_cache + static_cast<size_t>(t0 + i64) * row * EB, HD * EB, bar);
    if (cur_row)
      bulk_copy(smem_u32(my_sm + kTile * RB), (half ? vcur : kcur) + cur, HD * 2, bar);
  };
  const int first = rank * kTile;
  if (first <= pos) load_tile(first, true);
  // rank 0 expects one partial per head from every block with a tile
  const int n_part = min(cs, pos / kTile + 1);
  if (rank == 0 && tid == 0) mbar_arrive_expect(inbox_bar, n_part * rep * PW * 4);

  int phase = 0;
  bool have_run = false;
  for (int t0 = first; t0 <= pos; t0 += cs * kTile) {
    const bool last = t0 + cs * kTile > pos;
    const int vrow = t0 + warp * 16 + (lane >> 1);   // this lane's row of the sequence
    // int8: the row's scales (1 for the current position's bf16 row), in
    // flight beside the tile's bulk copies
    float k_s = 1.f, v_s = 1.f;
    if constexpr (Q8) {
      if (vrow < pos) {
        k_s = ksc[scale_b + static_cast<size_t>(vrow) * Hkv];
        v_s = vsc[scale_b + static_cast<size_t>(vrow) * Hkv];
      }
    }
    mbar_wait(bar, phase);
    phase ^= 1;
    if (last) cluster_wait();  // rank 0 has started: its inbox may be written
    // a warp's 16 rows: two lanes a row, each every other 16-byte vector
    const bool valid = vrow <= pos;
    const int src = vrow == pos ? kTile : warp * 16 + (lane >> 1);
    for (int r = 0; r < rep; ++r) {
      const unsigned char* kr = k_sm + src * RB;
      const float* qr = q_sm + r * HD;
      float a = (!Q8 || src == kTile) ? dot_bf16_row<HD>(kr, qr, lane & 1)
                                      : dot_int8_row<HD>(kr, qr, lane & 1);
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      const float sc = valid ? a * k_s : -INFINITY;
      float m = warp_max(sc);  // -inf: none of the warp's rows is at or below pos
      const float p = valid ? __expf(sc - m) : 0.f;
      float l = warp_sum((lane & 1) ? 0.f : p);
      const float pv = p * v_s;  // the weight of the row's stored values
      float acc[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[e] = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pv, 2 * j);
        const int sj = __shfl_sync(0xffffffffu, src, 2 * j);
        if (pj > 0.f) {
          if (!Q8 || sj == kTile) {
            const bf16* vr = reinterpret_cast<const bf16*>(v_sm + sj * RB);
#pragma unroll
            for (int e = 0; e < EPL; ++e) acc[e] += pj * to_f(vr[e * 32 + lane]);
          } else {
            const signed char* vr = reinterpret_cast<const signed char*>(v_sm + sj * RB);
#pragma unroll
            for (int e = 0; e < EPL; ++e)
              acc[e] += pj * static_cast<float>(vr[e * 32 + lane]);
          }
        }
      }
      float* wp = wpart + (warp * rep + r) * PW;
#pragma unroll
      for (int e = 0; e < EPL; ++e) wp[e * 32 + lane] = acc[e];
      if (lane == 0) {
        wp[HD] = m;
        wp[HD + 1] = l;
      }
    }
    __syncthreads();
    if (!last) {  // every warp is done with the tile: the next may land
      fence_proxy_async();
      load_tile(t0 + cs * kTile, false);
    }
    // merge the four warps (and the earlier tiles): one thread a dim
    if (tid < HD) {
      for (int r = 0; r < rep; ++r) {
        float m = have_run ? run_ml[2 * r] : -INFINITY;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) m = fmaxf(m, wpart[(w * rep + r) * PW + HD]);
        float l = 0.f, acc = 0.f;  // m is finite: row t0 is at or below pos
        if (have_run) {
          const float wr = __expf(run_ml[2 * r] - m);
          l = wr * run_ml[2 * r + 1];
          acc = wr * run[r * PW + tid];
        }
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const float* wp = wpart + (w * rep + r) * PW;
          const float ww = __expf(wp[HD] - m);
          l += ww * wp[HD + 1];
          acc += ww * wp[tid];
        }
        if (last) {
          const uint32_t dst = map_to_rank(smem_u32(inbox + (rank * rep + r) * PW), 0);
          const uint32_t dst_bar = map_to_rank(inbox_bar, 0);
          store_async(dst + 4 * tid, acc, dst_bar);
          if (tid == 0) {
            store_async(dst + 4 * HD, m, dst_bar);
            store_async(dst + 4 * (HD + 1), l, dst_bar);
          }
        } else {
          run[r * PW + tid] = acc;
          if (tid == 0) {
            run[r * PW + HD] = m;
            run[r * PW + HD + 1] = l;
          }
        }
      }
    }
    if (!last) {
      // the running max and sum change hands only between barriers
      __syncthreads();
      if (tid < rep * 2) run_ml[tid] = run[(tid >> 1) * PW + HD + (tid & 1)];
      have_run = true;
    }
  }
  if (first > pos) cluster_wait();  // no tile: only the barrier's protocol
  if (rank != 0) return;

  // rank 0: merge the blocks that had a tile, once their stores have landed
  mbar_wait(inbox_bar, 0);
  if (tid < HD) {
    for (int r = 0; r < rep; ++r) {
      float m = -INFINITY;
      for (int i = 0; i < n_part; ++i) m = fmaxf(m, inbox[(i * rep + r) * PW + HD]);
      float l = 0.f, acc = 0.f;
      for (int i = 0; i < n_part; ++i) {
        const float* pi = inbox + (i * rep + r) * PW;
        const float w = __expf(pi[HD] - m);
        l += w * pi[HD + 1];
        acc += w * pi[tid];
      }
      out[(static_cast<size_t>(b) * H + hk * rep + r) * HD + tid] =
          __float2bfloat16(acc / l);
    }
  }
}

// The same grid, cluster and shared memory with nothing to do: what one
// launch of this shape costs on the card.
__global__ void __launch_bounds__(kThreads) empty_kernel() {}

template <typename Kernel, typename... Args>
cudaError_t launch_cluster(Kernel kernel, int cs, int blocks_y, size_t smem,
                           cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, blocks_y);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <int HD, bool Q8>
cudaError_t launch(const bf16* q, const void* kc, const void* vc, const float* ksc,
                   const float* vsc, const bf16* kcur, const bf16* vcur, bf16* out,
                   int B, int H, int Hkv, int S, int pos, const int* pos_dev,
                   bool empty, cudaStream_t stream) {
  static const cudaError_t attr_err = allow_max_smem(decode_kernel<HD, Q8>);
  if (attr_err != cudaSuccess) return attr_err;
  static const cudaError_t empty_attr_err = allow_max_smem(empty_kernel);
  if (empty_attr_err != cudaSuccess) return empty_attr_err;
  const int tiles = (pos_dev ? S : pos) / kTile + 1;  // pos + 1 rows
  const int cs = max(1, min(tiles, kMaxCluster));
  const size_t smem = DecodeSmem<HD, Q8>::bytes(H / Hkv, cs);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  const cudaError_t err = empty
      ? launch_cluster(empty_kernel, cs, B * Hkv, smem, stream)
      : launch_cluster(decode_kernel<HD, Q8>, cs, B * Hkv, smem, stream, q, kc, vc,
                       ksc, vsc, kcur, vcur, out, H, Hkv, S, pos, pos_dev,
                       1.0f / sqrtf(static_cast<float>(HD)));
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <bool Q8>
int dispatch(const void* q, const void* k_cache, const void* v_cache,
             const void* k_scale, const void* v_scale, const void* k_cur,
             const void* v_cur, void* out, int B, int H, int Hkv, int S, int hd,
             int pos, const void* pos_dev, bool empty, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || B <= 0 || B * Hkv > 65535 || S < 0 ||
      (!pos_dev && (pos < 0 || pos > S)))
    return cudaErrorInvalidValue;
  auto q_ = static_cast<const bf16*>(q);
  auto ks = static_cast<const float*>(k_scale);
  auto vs = static_cast<const float*>(v_scale);
  auto kr = static_cast<const bf16*>(k_cur);
  auto vr = static_cast<const bf16*>(v_cur);
  auto op = static_cast<bf16*>(out);
  auto pd = static_cast<const int*>(pos_dev);
  auto st = static_cast<cudaStream_t>(stream);
#define VT_DECODE_CASE(D)                                                               \
  case D:                                                                               \
    return launch<D, Q8>(q_, k_cache, v_cache, ks, vs, kr, vr, op, B, H, Hkv, S, pos,   \
                         pd, empty, st);
  switch (hd) {
    VT_DECODE_CASE(32)
    VT_DECODE_CASE(64)
    VT_DECODE_CASE(96)
    VT_DECODE_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef VT_DECODE_CASE
}

}  // namespace

// pos_dev: null (the host's `pos` counts, 0 <= pos <= S) or one int32 in
// device memory (`pos` is ignored).
extern "C" int vt_decode_attention(const void* q, const void* k_cache,
                                   const void* v_cache, const void* k_cur,
                                   const void* v_cur, void* out, int B, int H,
                                   int Hkv, int S, int hd, int pos,
                                   const void* pos_dev, void* stream) {
  return dispatch<false>(q, k_cache, v_cache, nullptr, nullptr, k_cur, v_cur, out, B,
                         H, Hkv, S, hd, pos, pos_dev, false, stream);
}

// The int8 cache: k/v [B, S, Hkv, hd] int8, k_scale/v_scale [B, S, Hkv]
// float32; q, k_cur, v_cur and out bf16 as above.
extern "C" int vt_decode_attention_int8(const void* q, const void* k_cache,
                                        const void* v_cache, const void* k_scale,
                                        const void* v_scale, const void* k_cur,
                                        const void* v_cur, void* out, int B, int H,
                                        int Hkv, int S, int hd, int pos,
                                        const void* pos_dev, void* stream) {
  return dispatch<true>(q, k_cache, v_cache, k_scale, v_scale, k_cur, v_cur, out, B,
                        H, Hkv, S, hd, pos, pos_dev, false, stream);
}

// An empty kernel with the launch configuration vt_decode_attention (or, with
// int8 != 0, vt_decode_attention_int8) would use for these sizes: the floor
// of one launch.
extern "C" int vt_decode_attention_empty(int B, int H, int Hkv, int S, int hd,
                                         int pos, int pos_on_device, int int8,
                                         void* stream) {
  static const int dummy = 0;
  const void* pd = pos_on_device ? &dummy : nullptr;
  return int8 ? dispatch<true>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                               nullptr, nullptr, B, H, Hkv, S, hd, pos, pd, true, stream)
              : dispatch<false>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                nullptr, nullptr, B, H, Hkv, S, hd, pos, pd, true, stream);
}

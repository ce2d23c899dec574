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
//
// The int4 cache (vt_decode_attention_int4, the third instantiation):
// k/v [B, S, Hkv, hd / 2] int8, two values a byte, half-split (byte j holds
// element j in its low nibble and element j + hd / 2 in its high nibble:
// vaura_tpu/ops/quantization.py::quantize_kv4), scales as for int8
// (vaura_tpu/models/sampler.py:317-321, the JAX package's unpack-then-einsum
// branch). A row is hd / 2 bytes (48 at hd = 96), a multiple of 16, so the
// tile's bulk copies apply as they are. The nibbles widen in registers: of
// the two lanes of a row, the even one takes the low nibbles (elements
// 0 .. hd/2 - 1) and the odd one the high nibbles (elements hd/2 ..), each
// reading the whole packed row; a value lane takes its output dim's byte
// and nibble. Quarter the cache bytes of bf16.
//
// The int8 x int8 products (vt_decode_attention_dots, a kernel of its own
// over the int8 or int4 cache; the JAX package's int8_dots einsums,
// vaura_tpu/models/sampler.py:306-391): q is quantized per query head
// (int8, scale max|q| / 127), a cache score is the exact int32 q8 . k8
// (__dp4a) times scale * q_scale * k_scale, the current position's score
// stays float32, one softmax over all of them; then, per quantization group
// of rows (the JAX package's chunk buffers: `starts`, a small int32 array in
// device memory), the probabilities times v_scale are quantized to int8
// with the group's own scale and multiplied with the int8 values, again
// exactly in int32 (__dp4a over four rows at a time), and rescaled. The
// group scales need the softmax's global max and sum before any int8
// probability exists, so this is no one-pass online softmax: one block per
// (batch row, KV head) walks the whole prefix, keeping the scores of its
// query heads in shared memory (scores, softmax and group maxima, then the
// value products, with a barrier between). Integer sums below 2^24 are
// exact in float32 too, so the partial products of the block's row slices
// are added in shared memory with integer atomics, in any order. A design
// that is right, not yet fast: one block per (b, KV head), with the rows of
// one query head's softmax on one warp.
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
// 32 bytes, int8 rows (hd bytes) by 32 where hd / 32 is even. Int4 rows (hd
// / 2 bytes) are read whole by both lanes of a row, so the four rows of a
// quarter warp must fall into distinct 16-byte bank groups: a row is padded
// by 16 bytes where hd / 32 is a multiple of 4. In an int8 or int4 tile the
// current position's row is bf16 (2 * hd bytes) after the 64 rows.
// CB: bits of a cached element (16 bf16, 8 int8, 4 int4).
template <int HD, int CB>
struct DecodeSmem {
  static constexpr bool kQuant = CB != 16;
  static constexpr int kRowData = CB == 16 ? 2 * HD : CB == 8 ? HD : HD / 2;
  static constexpr int kRowBytes = CB == 16  ? HD * 2 + 32
                                   : CB == 8 ? HD + ((HD / 32) % 2 ? 0 : 32)
                                             : HD / 2 + ((HD / 32) % 4 ? 0 : 16);
  static constexpr int kTileBytes = kQuant ? kTile * kRowBytes + HD * 2 : (kTile + 1) * kRowBytes;
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

// The 4 bits of x that end at bit 31 - sh, sign-extended.
__device__ __forceinline__ int nibble(int x, int sh) {
  return static_cast<int>(static_cast<unsigned>(x) << sh) >> 28;
}

// The same for a packed int4 row: the even lane of a pair takes the low
// nibbles (elements 0 .. HD/2 - 1), the odd lane the high nibbles (elements
// HD/2 .. HD - 1), both over all of the row's HD / 32 vectors; byte c * 16 +
// 4 * j + i of the row holds elements c * 16 + 4 * j + i and that + HD / 2.
template <int HD>
__device__ __forceinline__ float dot_int4_row(const unsigned char* kr, const float* qr,
                                              int odd) {
  const float* qh = qr + odd * (HD / 2);
  const int sh = odd ? 24 : 28;  // the nibble of byte i ends at bit 8 i + 31 - sh
  float a = 0.f;
#pragma unroll
  for (int c = 0; c < HD / 32; ++c) {
    const uint4 kv = *reinterpret_cast<const uint4*>(kr + c * 16);
    const int w[4] = {static_cast<int>(kv.x), static_cast<int>(kv.y),
                      static_cast<int>(kv.z), static_cast<int>(kv.w)};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 qj = *reinterpret_cast<const float4*>(qh + c * 16 + 4 * j);
      a += qj.x * static_cast<float>(nibble(w[j], sh)) +
           qj.y * static_cast<float>(nibble(w[j], sh - 8)) +
           qj.z * static_cast<float>(nibble(w[j], sh - 16)) +
           qj.w * static_cast<float>(nibble(w[j], sh - 24));
    }
  }
  return a;
}

template <int HD, int CB>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const bf16* __restrict__ q, const void* __restrict__ kc,
              const void* __restrict__ vc, const float* __restrict__ ksc,
              const float* __restrict__ vsc, const bf16* __restrict__ kcur,
              const bf16* __restrict__ vcur, bf16* __restrict__ out, int H,
              int Hkv, int S, int pos_host, const int* __restrict__ pos_dev,
              float scale) {
  using Lay = DecodeSmem<HD, CB>;
  constexpr bool QUANT = Lay::kQuant;   // a quantized cache (int8 or int4)
  constexpr int RD = Lay::kRowData;  // bytes of a cached row of one head
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
  const size_t row = static_cast<size_t>(Hkv) * RD;  // bytes between positions
  const size_t first_row = (static_cast<size_t>(b) * S * Hkv + hk) * RD;
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
    mbar_arrive_expect(bar, mine * RD + cur_row * HD * 2);
    if (mine)
      bulk_copy(smem_u32(my_sm + i64 * RB), my_cache + static_cast<size_t>(t0 + i64) * row,
                RD, bar);
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
    // int8 / int4: the row's scales (1 for the current position's bf16
    // row), in flight beside the tile's bulk copies
    float k_s = 1.f, v_s = 1.f;
    if constexpr (QUANT) {
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
      float a = (!QUANT || src == kTile) ? dot_bf16_row<HD>(kr, qr, lane & 1)
                : CB == 8                ? dot_int8_row<HD>(kr, qr, lane & 1)
                                         : dot_int4_row<HD>(kr, qr, lane & 1);
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
          if (!QUANT || sj == kTile) {
            const bf16* vr = reinterpret_cast<const bf16*>(v_sm + sj * RB);
#pragma unroll
            for (int e = 0; e < EPL; ++e) acc[e] += pj * to_f(vr[e * 32 + lane]);
          } else if (CB == 8) {
            const signed char* vr = reinterpret_cast<const signed char*>(v_sm + sj * RB);
#pragma unroll
            for (int e = 0; e < EPL; ++e)
              acc[e] += pj * static_cast<float>(vr[e * 32 + lane]);
          } else {  // int4: dim d is byte d's low nibble, or byte d - HD/2's high one
            const signed char* vr = reinterpret_cast<const signed char*>(v_sm + sj * RB);
#pragma unroll
            for (int e = 0; e < EPL; ++e) {
              const int d = e * 32 + lane;
              const int x = vr[d < HD / 2 ? d : d - HD / 2];
              acc[e] += pj * static_cast<float>(d < HD / 2 ? nibble(x, 28) : x >> 4);
            }
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

template <int HD, int CB>
cudaError_t launch(const bf16* q, const void* kc, const void* vc, const float* ksc,
                   const float* vsc, const bf16* kcur, const bf16* vcur, bf16* out,
                   int B, int H, int Hkv, int S, int pos, const int* pos_dev,
                   bool empty, cudaStream_t stream) {
  static const cudaError_t attr_err = allow_max_smem(decode_kernel<HD, CB>);
  if (attr_err != cudaSuccess) return attr_err;
  static const cudaError_t empty_attr_err = allow_max_smem(empty_kernel);
  if (empty_attr_err != cudaSuccess) return empty_attr_err;
  const int tiles = (pos_dev ? S : pos) / kTile + 1;  // pos + 1 rows
  const int cs = max(1, min(tiles, kMaxCluster));
  const size_t smem = DecodeSmem<HD, CB>::bytes(H / Hkv, cs);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  const cudaError_t err = empty
      ? launch_cluster(empty_kernel, cs, B * Hkv, smem, stream)
      : launch_cluster(decode_kernel<HD, CB>, cs, B * Hkv, smem, stream, q, kc, vc,
                       ksc, vsc, kcur, vcur, out, H, Hkv, S, pos, pos_dev,
                       1.0f / sqrtf(static_cast<float>(HD)));
  return err != cudaSuccess ? err : cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The int8 x int8 products (see the head of the file).
constexpr int kDotThreads = 256;
constexpr int kDotWarps = kDotThreads / 32;
constexpr int kMaxGroups = 64;

__host__ __device__ inline int up16(int n) { return (n + 15) / 16 * 16; }

// Byte offsets of a block's shared memory, for rep query heads per KV head,
// a cache of S rows and G groups; mirrored by dots_smem_bytes in
// ops/decode_attention.py. SP: S rounded up to whole 4-row words.
struct DotsLayout {
  int SP, q8, p8, q_f, prob, p_s, stat, acc, gmax, starts, bytes;
  __host__ __device__ DotsLayout(int HD, int rep, int S, int G) {
    SP = max(4, (S + 3) / 4 * 4);
    q8 = 0;                                   // int8 [rep][HD]
    p8 = q8 + up16(rep * HD);                 // int8 [rep][SP]
    q_f = p8 + up16(rep * SP);                // float [rep][HD]
    prob = q_f + up16(4 * rep * HD);          // float [rep][SP]
    p_s = prob + up16(4 * rep * SP);          // float [rep][G]
    stat = p_s + up16(4 * rep * G);           // float [rep][2]: q scale, p of self
    acc = stat + up16(4 * rep * 2);           // int [rep][G][HD]
    gmax = acc + up16(4 * rep * G * HD);      // uint [rep][G]
    starts = gmax + up16(4 * rep * G);        // int [G]
    bytes = starts + up16(4 * G);
  }
};

// The group of cache row t: the last g with starts[g] <= t (rows below
// starts[1] are group 0).
__device__ __forceinline__ int group_of(const int* st, int G, int t) {
  int g = 0;
  for (int i = 1; i < G; ++i) g += st[i] <= t;
  return g;
}

// Four int8 values of one cached row (dims d0 .. d0 + 3) as one word; an
// int4 row gives them times 16 (the nibble in the high half of each byte),
// which keeps every product exact and is divided out at the end.
template <int HD, bool Q4>
__device__ __forceinline__ int row_word(const unsigned char* r, int d0) {
  if constexpr (Q4) {
    const int x = *reinterpret_cast<const int*>(r + (d0 < HD / 2 ? d0 : d0 - HD / 2));
    return static_cast<int>(d0 < HD / 2 ? (static_cast<unsigned>(x) << 4) & 0xF0F0F0F0u
                                        : static_cast<unsigned>(x) & 0xF0F0F0F0u);
  } else {
    return *reinterpret_cast<const int*>(r + d0);
  }
}

template <int HD, bool Q4>
__global__ void __launch_bounds__(kDotThreads)
dots_kernel(const bf16* __restrict__ q, const unsigned char* __restrict__ kc,
            const unsigned char* __restrict__ vc, const float* __restrict__ ksc,
            const float* __restrict__ vsc, const bf16* __restrict__ kcur,
            const bf16* __restrict__ vcur, bf16* __restrict__ out,
            const int* __restrict__ starts, int G, int H, int Hkv, int S, int pos_host,
            const int* __restrict__ pos_dev, float scale) {
  constexpr int RD = Q4 ? HD / 2 : HD;  // bytes of a cached row of one head
  constexpr int W = HD / 4;             // int8 words of a head's q
  constexpr int UNIT = Q4 ? 16 : 1;     // an int4 product's factor
  extern __shared__ __align__(16) unsigned char smem[];
  const int rep = H / Hkv;
  const DotsLayout lay(HD, rep, S, G);
  const int SP = lay.SP;
  signed char* q8 = reinterpret_cast<signed char*>(smem + lay.q8);
  signed char* p8 = reinterpret_cast<signed char*>(smem + lay.p8);
  float* q_f = reinterpret_cast<float*>(smem + lay.q_f);
  float* prob = reinterpret_cast<float*>(smem + lay.prob);
  float* p_s = reinterpret_cast<float*>(smem + lay.p_s);
  float* stat = reinterpret_cast<float*>(smem + lay.stat);
  int* acc = reinterpret_cast<int*>(smem + lay.acc);
  unsigned* gmax = reinterpret_cast<unsigned*>(smem + lay.gmax);
  int* st = reinterpret_cast<int*>(smem + lay.starts);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  int pos = pos_dev ? *pos_dev : pos_host;
  pos = max(0, min(pos, S));
  const size_t row = static_cast<size_t>(Hkv) * RD;  // a position's bytes, all heads
  const unsigned char* kb = kc + (static_cast<size_t>(b) * S * Hkv + hk) * RD;
  const unsigned char* vb = vc + (static_cast<size_t>(b) * S * Hkv + hk) * RD;
  const size_t scale_b = static_cast<size_t>(b) * S * Hkv + hk;  // + t * Hkv
  const size_t cur = (static_cast<size_t>(b) * Hkv + hk) * HD;
  const bf16* qb = q + (static_cast<size_t>(b) * H + hk * rep) * HD;

  // zero the integer sums, the group maxima and the int8 probabilities
  for (int i = tid; i < rep * G * HD; i += kDotThreads) acc[i] = 0;
  for (int i = tid; i < rep * G; i += kDotThreads) gmax[i] = 0u;
  for (int i = tid; i < rep * SP / 4; i += kDotThreads) reinterpret_cast<int*>(p8)[i] = 0;
  for (int i = tid; i < G; i += kDotThreads) st[i] = starts[i];
  for (int i = tid; i < rep * HD; i += kDotThreads) q_f[i] = to_f(qb[i]);
  __syncthreads();

  // q per query head: int8 with scale max|q| / 127 (at least 1e-8), rounded
  // half to even; the current position's score in float32
  for (int r = warp; r < rep; r += kDotWarps) {
    const float* qr = q_f + r * HD;
    float m = 0.f, self = 0.f;
    for (int d = lane; d < HD; d += 32) {
      m = fmaxf(m, fabsf(qr[d]));
      self += qr[d] * to_f(kcur[cur + d]);
    }
    const float qs = fmaxf(warp_max(m) / 127.f, 1e-8f);
    self = warp_sum(self) * scale;
    for (int d = lane; d < HD; d += 32)
      q8[r * HD + d] = static_cast<signed char>(fminf(fmaxf(rintf(qr[d] / qs), -127.f), 127.f));
    if (lane == 0) {
      stat[2 * r] = qs;
      stat[2 * r + 1] = self;
    }
  }
  __syncthreads();

  // cache scores: one row a thread, its RD bytes in registers, one exact
  // int32 product per query head
  for (int t = tid; t < pos; t += kDotThreads) {
    const unsigned char* kr = kb + static_cast<size_t>(t) * row;
    const float ks = ksc[scale_b + static_cast<size_t>(t) * Hkv];
    int kw[RD / 4];
#pragma unroll
    for (int c = 0; c < RD / 16; ++c) {
      const uint4 v = *reinterpret_cast<const uint4*>(kr + 16 * c);
      kw[4 * c] = static_cast<int>(v.x);
      kw[4 * c + 1] = static_cast<int>(v.y);
      kw[4 * c + 2] = static_cast<int>(v.z);
      kw[4 * c + 3] = static_cast<int>(v.w);
    }
    for (int r = 0; r < rep; ++r) {
      const int* qw = reinterpret_cast<const int*>(q8 + r * HD);
      int dot = 0;
#pragma unroll
      for (int w = 0; w < RD / 4; ++w) {
        if constexpr (Q4) {  // packed word w: elements 4w.. (low) and HD/2 + 4w.. (high)
          const unsigned x = static_cast<unsigned>(kw[w]);
          dot = __dp4a(static_cast<int>((x << 4) & 0xF0F0F0F0u), qw[w], dot);
          dot = __dp4a(static_cast<int>(x & 0xF0F0F0F0u), qw[W / 2 + w], dot);
        } else {
          dot = __dp4a(kw[w], qw[w], dot);
        }
      }
      prob[r * SP + t] = static_cast<float>(dot / UNIT) * (scale * stat[2 * r]) * ks;
    }
  }
  __syncthreads();

  // per query head (one warp): the softmax over the rows below pos and the
  // current one, the probabilities times v_scale, each group's max, then
  // the int8 probabilities with the group's scale
  for (int r = warp; r < rep; r += kDotWarps) {
    float* pr = prob + r * SP;
    const float self = stat[2 * r + 1];
    float m = self;
    for (int t = lane; t < pos; t += 32) m = fmaxf(m, pr[t]);
    m = warp_max(m);
    float z = 0.f;
    for (int t = lane; t < pos; t += 32) {
      const float e = expf(pr[t] - m);
      pr[t] = e;
      z += e;
    }
    const float e_self = expf(self - m);
    z = warp_sum(z) + e_self;
    for (int t = lane; t < pos; t += 32) {
      const float pc = pr[t] / z * vsc[scale_b + static_cast<size_t>(t) * Hkv];
      pr[t] = pc;
      atomicMax(gmax + r * G + group_of(st, G, t), __float_as_uint(pc));  // pc >= 0
    }
    __syncwarp();
    for (int g = lane; g < G; g += 32)
      p_s[r * G + g] = fmaxf(__uint_as_float(gmax[r * G + g]) / 127.f, 1e-8f);
    if (lane == 0) stat[2 * r + 1] = e_self / z;
    __syncwarp();
    for (int t = lane; t < pos; t += 32)
      p8[r * SP + t] = static_cast<signed char>(
          fminf(fmaxf(rintf(pr[t] / p_s[r * G + group_of(st, G, t)]), -127.f), 127.f));
  }
  __syncthreads();

  // p8 . v8: a thread takes 4 dims of one query head over a slice of the
  // rows, four rows a step (the 4 x 4 bytes transposed so that one __dp4a
  // sums one dim over four rows), and adds its sums into the group's
  // integer accumulators whenever its rows cross into the next group
  constexpr int DW = HD / 4;
  const int units = rep * DW;
  const int slices = max(1, kDotThreads / units);
  const int chunk = ((pos + slices - 1) / slices + 3) / 4 * 4;
  for (int u = tid; u < units * slices; u += kDotThreads) {
    const int sl = u / units, r = (u % units) / DW, d0 = (u % DW) * 4;
    const int lo = sl * chunk, hi = min(pos, lo + chunk);
    const signed char* pr8 = p8 + r * SP;
    int a[4] = {0, 0, 0, 0};
    int gcur = -1;
    auto flush = [&]() {
      if (gcur >= 0) {
        int* dst = acc + (r * G + gcur) * HD + d0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          atomicAdd(dst + j, a[j]);
          a[j] = 0;
        }
      }
    };
    for (int t = lo; t < hi; t += 4) {
      int R[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        R[k] = t + k < pos ? row_word<HD, Q4>(vb + static_cast<size_t>(t + k) * row, d0) : 0;
      const int x01 = __byte_perm(R[0], R[1], 0x5140), y01 = __byte_perm(R[0], R[1], 0x7362);
      const int x23 = __byte_perm(R[2], R[3], 0x5140), y23 = __byte_perm(R[2], R[3], 0x7362);
      const int C[4] = {static_cast<int>(__byte_perm(x01, x23, 0x5410)),
                        static_cast<int>(__byte_perm(x01, x23, 0x7632)),
                        static_cast<int>(__byte_perm(y01, y23, 0x5410)),
                        static_cast<int>(__byte_perm(y01, y23, 0x7632))};
      const int P = *reinterpret_cast<const int*>(pr8 + t);  // rows t .. t + 3
      const int g0 = group_of(st, G, t), g3 = group_of(st, G, min(t + 3, pos - 1));
      if (g0 == g3) {
        if (g0 != gcur) {
          flush();
          gcur = g0;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) a[j] = __dp4a(C[j], P, a[j]);
      } else {  // a group starts inside these four rows
        for (int k = 0; k < 4 && t + k < pos; ++k) {
          const int g = group_of(st, G, t + k);
          if (g != gcur) {
            flush();
            gcur = g;
          }
          const int Pk = static_cast<int>(static_cast<unsigned>(P) & (0xFFu << (8 * k)));
#pragma unroll
          for (int j = 0; j < 4; ++j) a[j] = __dp4a(C[j], Pk, a[j]);
        }
      }
    }
    flush();
  }
  __syncthreads();

  // out = sum over groups of float(int32 sum) * p_s, then + p_self * v_cur
  for (int i = tid; i < rep * HD; i += kDotThreads) {
    const int r = i / HD, d = i % HD;
    float o = 0.f;
    for (int g = 0; g < G; ++g)
      o = o + static_cast<float>(acc[(r * G + g) * HD + d] / UNIT) * p_s[r * G + g];
    o = o + stat[2 * r + 1] * to_f(vcur[cur + d]);
    out[(static_cast<size_t>(b) * H + hk * rep + r) * HD + d] = __float2bfloat16(o);
  }
}

__global__ void __launch_bounds__(kDotThreads) empty_dots_kernel() {}

template <int HD, bool Q4>
cudaError_t launch_dots(const bf16* q, const void* kc, const void* vc, const float* ksc,
                        const float* vsc, const bf16* kcur, const bf16* vcur, bf16* out,
                        const int* starts, int G, int B, int H, int Hkv, int S, int pos,
                        const int* pos_dev, bool empty, cudaStream_t stream) {
  static const cudaError_t attr_err = allow_max_smem(dots_kernel<HD, Q4>);
  if (attr_err != cudaSuccess) return attr_err;
  static const cudaError_t empty_attr_err = allow_max_smem(empty_dots_kernel);
  if (empty_attr_err != cudaSuccess) return empty_attr_err;
  const size_t smem = DotsLayout(HD, H / Hkv, S, G).bytes;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (empty)
    empty_dots_kernel<<<B * Hkv, kDotThreads, smem, stream>>>();
  else
    dots_kernel<HD, Q4><<<B * Hkv, kDotThreads, smem, stream>>>(
        q, static_cast<const unsigned char*>(kc), static_cast<const unsigned char*>(vc),
        ksc, vsc, kcur, vcur, out, starts, G, H, Hkv, S, pos, pos_dev,
        1.0f / sqrtf(static_cast<float>(HD)));
  return cudaGetLastError();
}

// cb: bits of a cached element (16, 8 or 4) for the cluster kernel; dots:
// the int8 x int8 kernel over an int8 (cb 8) or int4 (cb 4) cache
int dispatch(int cb, bool dots, const void* q, const void* k_cache, const void* v_cache,
             const void* k_scale, const void* v_scale, const void* k_cur,
             const void* v_cur, void* out, const void* starts, int G, int B, int H,
             int Hkv, int S, int hd, int pos, const void* pos_dev, bool empty,
             void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || B <= 0 || S < 0 ||
      (!pos_dev && (pos < 0 || pos > S)))
    return cudaErrorInvalidValue;
  if (dots ? (cb == 16 || G < 1 || G > kMaxGroups || static_cast<long>(B) * Hkv > 0x7fffffffL)
           : B * Hkv > 65535)
    return cudaErrorInvalidValue;
  auto q_ = static_cast<const bf16*>(q);
  auto ks = static_cast<const float*>(k_scale);
  auto vs = static_cast<const float*>(v_scale);
  auto kr = static_cast<const bf16*>(k_cur);
  auto vr = static_cast<const bf16*>(v_cur);
  auto op = static_cast<bf16*>(out);
  auto sg = static_cast<const int*>(starts);
  auto pd = static_cast<const int*>(pos_dev);
  auto st = static_cast<cudaStream_t>(stream);
#define VT_DECODE_CASE(D)                                                                 \
  case D:                                                                                 \
    if (dots)                                                                             \
      return cb == 4 ? launch_dots<D, true>(q_, k_cache, v_cache, ks, vs, kr, vr, op, sg,  \
                                            G, B, H, Hkv, S, pos, pd, empty, st)          \
                     : launch_dots<D, false>(q_, k_cache, v_cache, ks, vs, kr, vr, op,    \
                                             sg, G, B, H, Hkv, S, pos, pd, empty, st);    \
    switch (cb) {                                                                         \
      case 16: return launch<D, 16>(q_, k_cache, v_cache, ks, vs, kr, vr, op, B, H, Hkv,  \
                                    S, pos, pd, empty, st);                               \
      case 8: return launch<D, 8>(q_, k_cache, v_cache, ks, vs, kr, vr, op, B, H, Hkv, S, \
                                  pos, pd, empty, st);                                    \
      case 4: return launch<D, 4>(q_, k_cache, v_cache, ks, vs, kr, vr, op, B, H, Hkv, S, \
                                  pos, pd, empty, st);                                    \
      default: return cudaErrorInvalidValue;                                              \
    }
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
  return dispatch(16, false, q, k_cache, v_cache, nullptr, nullptr, k_cur, v_cur, out,
                  nullptr, 0, B, H, Hkv, S, hd, pos, pos_dev, false, stream);
}

// The int8 cache: k/v [B, S, Hkv, hd] int8, k_scale/v_scale [B, S, Hkv]
// float32; q, k_cur, v_cur and out bf16 as above.
extern "C" int vt_decode_attention_int8(const void* q, const void* k_cache,
                                        const void* v_cache, const void* k_scale,
                                        const void* v_scale, const void* k_cur,
                                        const void* v_cur, void* out, int B, int H,
                                        int Hkv, int S, int hd, int pos,
                                        const void* pos_dev, void* stream) {
  return dispatch(8, false, q, k_cache, v_cache, k_scale, v_scale, k_cur, v_cur, out,
                  nullptr, 0, B, H, Hkv, S, hd, pos, pos_dev, false, stream);
}

// The int4 cache: k/v [B, S, Hkv, hd / 2] int8 (two values a byte,
// half-split), scales as for int8.
extern "C" int vt_decode_attention_int4(const void* q, const void* k_cache,
                                        const void* v_cache, const void* k_scale,
                                        const void* v_scale, const void* k_cur,
                                        const void* v_cur, void* out, int B, int H,
                                        int Hkv, int S, int hd, int pos,
                                        const void* pos_dev, void* stream) {
  return dispatch(4, false, q, k_cache, v_cache, k_scale, v_scale, k_cur, v_cur, out,
                  nullptr, 0, B, H, Hkv, S, hd, pos, pos_dev, false, stream);
}

// The int8 x int8 products over an int8 (cache_bits 8) or int4 (4) cache:
// starts, n_groups int32 in device memory, the first row of each
// quantization group in increasing order (rows below starts[1] are group 0).
extern "C" int vt_decode_attention_dots(const void* q, const void* k_cache,
                                        const void* v_cache, const void* k_scale,
                                        const void* v_scale, const void* k_cur,
                                        const void* v_cur, void* out,
                                        const void* starts, int n_groups, int B, int H,
                                        int Hkv, int S, int hd, int cache_bits, int pos,
                                        const void* pos_dev, void* stream) {
  if (cache_bits != 8 && cache_bits != 4) return cudaErrorInvalidValue;
  return dispatch(cache_bits, true, q, k_cache, v_cache, k_scale, v_scale, k_cur, v_cur,
                  out, starts, n_groups, B, H, Hkv, S, hd, pos, pos_dev, false, stream);
}

// An empty kernel with the launch configuration of one of the entry points
// above for these sizes: the floor of one launch. kind: 0 vt_decode_attention,
// 1 _int8, 2 _int4, 3 _dots (n_groups groups).
extern "C" int vt_decode_attention_empty(int B, int H, int Hkv, int S, int hd,
                                         int pos, int pos_on_device, int kind,
                                         int n_groups, void* stream) {
  static const int dummy = 0;
  const void* pd = pos_on_device ? &dummy : nullptr;
  if (kind < 0 || kind > 3) return cudaErrorInvalidValue;
  const int cb = kind == 0 ? 16 : kind == 2 ? 4 : 8;
  return dispatch(cb, kind == 3, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, nullptr, n_groups, B, H, Hkv, S, hd, pos, pd, true,
                  stream);
}

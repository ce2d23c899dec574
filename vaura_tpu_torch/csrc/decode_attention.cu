// Decode attention for one layer and one step, in ONE launch with no scratch
// tensor, in one of two forms that the caller picks from the shapes alone
// (ops/decode_attention.py::launch_plan; the form never depends on pos, so a
// captured step can be replayed at the next position):
//  * the cluster form: the 64-row tiles of a (batch row, KV head) are the
//    blocks of a thread-block cluster, merged through distributed shared
//    memory. Where there are few (b, KV head) pairs (the model's batch of 2
//    clips x CFG: 64 pairs) the split is what fills the card's 132 SMs.
//  * the serving form: one block per (b, KV head), no cluster, walking its
//    tiles through a ring of bulk copies. Where the pairs alone fill the card
//    (a serving batch: 4,096 pairs at B2 = 256), a cluster adds only fixed
//    latency a block (set-up, the cluster barrier, the remote merge).
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
//   form   0 the cluster form, 1 the serving form
//
// Bound on the H100: bytes. Per layer and step the work reads
// 2*B*pos*Hkv*hd*2 bytes of cache and does about 4*B*H*pos*hd flops, far
// below the card's ~295 flops per byte. At the model's batch (a few MB of
// cache prefix at most) the stream takes under a microsecond, so what a call
// costs is latency: launches, dependent memory round trips, barriers; the
// cluster form spends one of each. At a serving batch the bytes count, and
// the serving form keeps a tile in flight while it computes on another.
//
// The cluster form (decode_kernel):
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
//    S + 1 rows, so the launch is the same for every position.
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
//    with shuffles alone (head_rows); one barrier later the four warps'
//    partials (and, for a long cache, the block's earlier tiles) are merged
//    by one thread per output dim, which stores the block's (acc[hd], max,
//    sum) straight into rank 0's shared memory (distributed shared memory):
//    one remote store a thread. The stores are asynchronous (st.async) and
//    report to an mbarrier in rank 0, which knows from pos how many bytes to
//    expect: the senders neither fence nor wait and simply end, and rank 0
//    merges the blocks as soon as the last byte is in and writes the bf16
//    output. The one cluster barrier, which makes sure rank 0 has started and
//    set up its mbarrier, is armed before the loads and awaited after the
//    tile's arithmetic, so it costs nothing.
//  * float32 scores, softmax and accumulators; the output is rounded to
//    bf16 once.
//
// The serving form (serve_kernel): grid B*Hkv (one dimension), one block of
// 128 threads per (b, KV head) over the tiles of rows 0 .. pos. The tiles
// pass through a ring of kStages stages, each with its own mbarrier: the
// first kStages tiles are requested at once, and a stage is requested again
// as soon as every warp is done with it, so the next tile (and the per-lane
// scales of the next tile, loaded before this tile's arithmetic) is in
// flight while this one is computed. The current position's k/v rows come
// with the first tile into a slot of their own. Each warp keeps its own
// running (acc, max, sum) per query head in shared memory across the tiles,
// so a tile costs one block barrier (the stage's reuse) and no merge; the
// four warps are merged once at the end, inside the block, and the block
// writes the output itself.
//
// The int8 cache (vt_decode_attention_int8, the second instantiation of both
// forms): k/v [B, S, Hkv, hd] int8 with one float32 scale per (position, KV
// head), k_scale/v_scale [B, S, Hkv] (the JAX package's layout,
// vaura_tpu/models/sampler.py:296-391, whose einsums this replaces: the JAX
// package has no Pallas kernel for it). A cache row is hd bytes (96 at hd =
// 96: still one legal bulk copy, since its size and its 1,536-byte stride
// are 16-byte multiples) and the current position's k/v stay bf16,
// unquantized. The scales are not bulk-copied (a tile's 64 scales lie at
// the KV-head stride, 64 bytes apart): the lane that reads a row also loads
// its two scales from device memory, issued before the tile's wait so that
// their round trip runs beside the bulk copies. The kernel widens the int8
// values in registers and folds k_scale into the score and v_scale into the
// probability that weighs the row's values (the softmax's sum takes the
// probability without it), as the einsums do. Half the cache bytes of bf16.
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
// device memory; group g is the row range from starts[g] to starts[g + 1]),
// the probabilities times v_scale are quantized to int8 with the group's own
// scale and multiplied with the int8 values, again exactly in int32 (__dp4a
// over four rows at a time), and rescaled. The group scales need the
// softmax's global max and sum before any int8 probability exists, so this
// is no one-pass online softmax: a block computes the scores of its rows,
// the whole sequence's max and sum are known, then the group maxima, then
// p8 and the value products. The same two forms, one kernel (dots_kernel):
//  * the block's rows are 64-row tiles (tiles rank, rank + cluster, ... in
//    the cluster form, all tiles below pos in the serving form), staged in
//    shared memory by bulk copies through a ring of kDotStages stages, K
//    tiles first, then V tiles, so the V tiles land during the softmax. The
//    cluster form copies the rows its launch covers below S without waiting
//    for pos (rows at or past pos are masked), so pos, q, the groups' starts,
//    the scales and the tiles are all one round trip.
//  * scores four lanes a row (one 4-byte word each), softmax statistics with
//    every warp (block reductions in a fixed order), groups walked as row
//    ranges by a warp each, values a thread per (head, 4 dims, slice of
//    rows).
//  * the cluster form (blocks of 256 threads) exchanges, through distributed
//    shared memory and three cluster barriers: each block's (max, sum) per
//    head, stored into every block (every block then computes the same
//    global max M and sum Z, in rank order), the group maxima of p * v_scale
//    (atomicMax on a non-negative float's bits into every block's copy), and
//    the exact int32 group sums, added into rank 0's with integer atomics in
//    any order. Rank 0 rescales each group by its scale, adds p_self * v_cur
//    and writes the output. The serving form (blocks of 128 threads: more of
//    them an SM) does the same inside one block with block barriers.
//  * what holds the cluster form back (profile_kernels.py dots, PERF.md):
//    the first tiles' and scales' round trip and the three cluster barriers
//    form one chain that no block can overlap.
//  * p8 keeps the plain version's order of operations: p = exp(s - M) / Z,
//    times v_scale, divided by the group's scale, rounded half to even.
#include "common.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
constexpr int kStages = 2;  // tile stages of the serving form's ring
constexpr int kClusterForm = 0, kServeForm = 1;

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}
// The address of the same shared-memory variable in another block of the
// cluster.
__device__ __forceinline__ uint32_t map_to_rank(uint32_t local, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}
// The same, as a generic pointer: ordinary loads and atomics reach it.
template <typename T>
__device__ __forceinline__ T* cluster_ptr(T* local, int rank) {
  uint64_t remote;
  asm volatile("mapa.u64 %0, %1, %2;\n"
               : "=l"(remote)
               : "l"(reinterpret_cast<uint64_t>(local)), "r"(rank));
  return reinterpret_cast<T*>(remote);
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

// Dynamic shared memory of the cluster form: the K and V tiles (kTile rows
// and the current position's row), the mbarrier, then floats. Rows of a tile
// lie an odd multiple of 32 bytes apart, so that two lanes a row, each taking
// every other 16-byte vector, read without bank conflicts: bf16 rows are
// padded by 32 bytes, int8 rows (hd bytes) by 32 where hd / 32 is even. Int4
// rows (hd / 2 bytes) are read whole by both lanes of a row, so the four rows
// of a quarter warp must fall into distinct 16-byte bank groups: a row is
// padded by 16 bytes where hd / 32 is a multiple of 4. In an int8 or int4
// tile the current position's row is bf16 (2 * hd bytes) after the 64 rows.
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

// Dynamic shared memory of the serving form: kStages stages of a K tile and
// a V tile (kTile rows each, rows padded as in the cluster form), the current
// position's bf16 K and V rows, the stages' mbarriers, then floats: q and
// each warp's running partial per query head. Mirrored by smem_bytes(...,
// form="serve") in ops/decode_attention.py.
template <int HD, int CB>
struct ServeSmem {
  static constexpr int kRowBytes = DecodeSmem<HD, CB>::kRowBytes;
  static constexpr int kTileBytes = kTile * kRowBytes;
  static constexpr int kStageBytes = 2 * kTileBytes;  // K tile, then V tile
  static constexpr int kPW = HD + 2;
  static constexpr int cur = kStages * kStageBytes;  // k_cur row, then v_cur row
  static constexpr int bar = cur + 4 * HD;
  static constexpr int floats_at = bar + (8 * kStages + 15) / 16 * 16;
  __host__ __device__ static size_t bytes(int rep) {
    return floats_at + sizeof(float) * (rep * HD + kWarps * rep * kPW);
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

// One query head over a warp's 16 rows of a staged tile, two lanes a row
// (both forms): the scores (q in float32 from shared memory; k_s folds the
// row's k_scale in, v_s its v_scale), the warp's max and sum, and the value
// sums of the lane's HD / 32 output dims. koff / voff: the byte offsets of
// the lane's K and V rows from `base`, the current position's bf16 rows where
// `cur`; `valid`: the row is at or below pos. m is -inf where no row of the
// warp is. (Each row's V offset comes from its lane by a shuffle: worked out
// by every lane instead, the kernels measured slower.)
template <int HD, int CB>
__device__ __forceinline__ void head_rows(const unsigned char* base, int koff, int voff,
                                          bool cur, bool valid, const float* qr, float k_s,
                                          float v_s, int lane, float& m_out, float& l_out,
                                          float (&acc)[HD / 32]) {
  constexpr bool QUANT = CB != 16;
  constexpr int EPL = HD / 32;
  const unsigned char* kr = base + koff;
  float a = (!QUANT || cur) ? dot_bf16_row<HD>(kr, qr, lane & 1)
            : CB == 8        ? dot_int8_row<HD>(kr, qr, lane & 1)
                             : dot_int4_row<HD>(kr, qr, lane & 1);
  a += __shfl_xor_sync(0xffffffffu, a, 1);
  const float sc = valid ? a * k_s : -INFINITY;
  const float m = warp_max(sc);  // -inf: none of the warp's rows is at or below pos
  const float p = valid ? __expf(sc - m) : 0.f;
  l_out = warp_sum((lane & 1) ? 0.f : p);
  m_out = m;
  const float pv = p * v_s;  // the weight of the row's stored values
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float pj = __shfl_sync(0xffffffffu, pv, 2 * j);
    const int oj = __shfl_sync(0xffffffffu, voff, 2 * j);
    const int cj = __shfl_sync(0xffffffffu, static_cast<int>(cur), 2 * j);
    if (pj > 0.f) {
      if (!QUANT || cj) {
        const bf16* vr = reinterpret_cast<const bf16*>(base + oj);
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[e] += pj * to_f(vr[e * 32 + lane]);
      } else if (CB == 8) {
        const signed char* vr = reinterpret_cast<const signed char*>(base + oj);
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[e] += pj * static_cast<float>(vr[e * 32 + lane]);
      } else {  // int4: dim d is byte d's low nibble, or byte d - HD/2's high one
        const signed char* vr = reinterpret_cast<const signed char*>(base + oj);
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          const int d = e * 32 + lane;
          const int x = vr[d < HD / 2 ? d : d - HD / 2];
          acc[e] += pj * static_cast<float>(d < HD / 2 ? nibble(x, 28) : x >> 4);
        }
      }
    }
  }
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
      float m, l, acc[EPL];
      head_rows<HD, CB>(smem, src * RB, Lay::kTileBytes + src * RB, src == kTile, valid,
                        q_sm + r * HD, k_s, v_s, lane, m, l, acc);
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

// The serving form (see the head of the file): one block per (b, KV head).
template <int HD, int CB>
__global__ void __launch_bounds__(kThreads)
serve_kernel(const bf16* __restrict__ q, const void* __restrict__ kc,
             const void* __restrict__ vc, const float* __restrict__ ksc,
             const float* __restrict__ vsc, const bf16* __restrict__ kcur,
             const bf16* __restrict__ vcur, bf16* __restrict__ out, int H,
             int Hkv, int S, int pos_host, const int* __restrict__ pos_dev,
             float scale) {
  using Lay = ServeSmem<HD, CB>;
  constexpr bool QUANT = CB != 16;
  constexpr int RD = DecodeSmem<HD, CB>::kRowData;
  constexpr int RB = Lay::kRowBytes;
  constexpr int EPL = HD / 32;
  constexpr int PW = Lay::kPW;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t bar = smem_u32(smem + Lay::bar);  // stage s: bar + 8 s
  const int rep = H / Hkv;
  float* q_sm = reinterpret_cast<float*>(smem + Lay::floats_at);
  float* wrun = q_sm + rep * HD;  // [warp][head][PW]: the warp's running partial

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t pair = blockIdx.x;
  const int b = static_cast<int>(pair / Hkv), hk = static_cast<int>(pair % Hkv);

  // serve: pos and the query heads requested, stages and running partials set up
  int pos = pos_dev ? *pos_dev : pos_host;
  const bf16* qb = q + (static_cast<size_t>(b) * H + hk * rep) * HD;
  const bf16 q_first = tid < rep * HD ? qb[tid] : __float2bfloat16(0.f);
  if (tid == 0)
    for (int s = 0; s < kStages; ++s) mbar_init(bar + 8 * s, kThreads);
  for (int i = tid; i < kWarps * rep * PW; i += kThreads)
    wrun[i] = i % PW == HD ? -INFINITY : 0.f;
  if (tid < rep * HD) q_sm[tid] = to_f(q_first) * scale;
  for (int i = tid + kThreads; i < rep * HD; i += kThreads)
    q_sm[i] = to_f(qb[i]) * scale;
  __syncthreads();
  pos = max(0, min(pos, S));
  const size_t row = static_cast<size_t>(Hkv) * RD;
  const size_t first_row = (static_cast<size_t>(b) * S * Hkv + hk) * RD;
  const unsigned char* kb = static_cast<const unsigned char*>(kc) + first_row;
  const unsigned char* vb = static_cast<const unsigned char*>(vc) + first_row;
  const size_t cur = (static_cast<size_t>(b) * Hkv + hk) * HD;
  const size_t scale_b = static_cast<size_t>(b) * S * Hkv + hk;

  // Tile j (rows 64 j .. 64 j + 63) goes to stage j % kStages: thread (half,
  // i) requests row i of K (half 0) or V (half 1) if it lies below pos;
  // threads (half, 0) bring the current position's rows with the first tile.
  const int n = pos / kTile + 1;  // tiles holding rows 0 .. pos
  const int half = tid >> 6, i64 = tid & (kTile - 1);
  auto load_tile = [&](int j) {
    const int s = j % kStages, t = j * kTile + i64;
    const bool mine = t < pos, cur_row = j == 0 && i64 == 0;
    mbar_arrive_expect(bar + 8 * s, mine * RD + cur_row * HD * 2);
    if (mine)
      bulk_copy(smem_u32(smem + s * Lay::kStageBytes + half * Lay::kTileBytes + i64 * RB),
                (half ? vb : kb) + static_cast<size_t>(t) * row, RD, bar + 8 * s);
    if (cur_row)
      bulk_copy(smem_u32(smem + Lay::cur + half * HD * 2), (half ? vcur : kcur) + cur,
                HD * 2, bar + 8 * s);
  };
  for (int j = 0; j < kStages && j < n; ++j) load_tile(j);
  // int8 / int4: the scales of the lane's row of tile j (1 past pos)
  auto scales = [&](int j, float& k_s, float& v_s) {
    const int t = j * kTile + warp * 16 + (lane >> 1);
    k_s = v_s = 1.f;
    if constexpr (QUANT) {
      if (t < pos) {
        k_s = ksc[scale_b + static_cast<size_t>(t) * Hkv];
        v_s = vsc[scale_b + static_cast<size_t>(t) * Hkv];
      }
    }
  };
  float k_s, v_s;
  scales(0, k_s, v_s);
  for (int j = 0; j < n; ++j) {
    float k_next = 1.f, v_next = 1.f;
    if (j + 1 < n) scales(j + 1, k_next, v_next);  // in flight beside this tile
    const int s = j % kStages;
    mbar_wait(bar + 8 * s, (j / kStages) & 1);
    // serve: a warp's 16 rows, merged into its running partial
    const int vrow = j * kTile + warp * 16 + (lane >> 1);
    const bool is_cur = vrow == pos;
    const int off = s * Lay::kStageBytes + (warp * 16 + (lane >> 1)) * RB;
    const int koff = is_cur ? Lay::cur : off;
    const int voff = is_cur ? Lay::cur + HD * 2 : off + Lay::kTileBytes;
    for (int r = 0; r < rep; ++r) {
      float m, l, acc[EPL];
      head_rows<HD, CB>(smem, koff, voff, is_cur, vrow <= pos, q_sm + r * HD, k_s, v_s,
                        lane, m, l, acc);
      if (m != -INFINITY) {  // warp-uniform
        float* run = wrun + (warp * rep + r) * PW;
        const float m0 = run[HD], mm = fmaxf(m0, m);
        const float a0 = __expf(m0 - mm), a1 = __expf(m - mm);  // m0 = -inf: a0 = 0
#pragma unroll
        for (int e = 0; e < EPL; ++e) run[e * 32 + lane] = a0 * run[e * 32 + lane] + a1 * acc[e];
        const float l0 = run[HD + 1];
        __syncwarp();
        if (lane == 0) {
          run[HD] = mm;
          run[HD + 1] = a0 * l0 + a1 * l;
        }
        __syncwarp();
      }
    }
    k_s = k_next;
    v_s = v_next;
    if (j + kStages < n) {
      __syncthreads();  // every warp is done with stage s: tile j + kStages may land
      fence_proxy_async();
      load_tile(j + kStages);
    }
  }
  __syncthreads();
  // serve: the four warps merged, one thread a dim
  if (tid < HD) {
    for (int r = 0; r < rep; ++r) {
      float m = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) m = fmaxf(m, wrun[(w * rep + r) * PW + HD]);
      float l = 0.f, acc = 0.f;  // warp 0 holds row 0 <= pos: m is finite
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float* wp = wrun + (w * rep + r) * PW;
        if (wp[HD] == -INFINITY) continue;
        const float ww = __expf(wp[HD] - m);
        l += ww * wp[HD + 1];
        acc += ww * wp[tid];
      }
      out[(static_cast<size_t>(b) * H + hk * rep + r) * HD + tid] = __float2bfloat16(acc / l);
    }
  }
  // serve: done
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
                   int form, bool empty, cudaStream_t stream) {
  static const cudaError_t attr_err = allow_max_smem(decode_kernel<HD, CB>);
  if (attr_err != cudaSuccess) return attr_err;
  static const cudaError_t serve_attr_err = allow_max_smem(serve_kernel<HD, CB>);
  if (serve_attr_err != cudaSuccess) return serve_attr_err;
  static const cudaError_t empty_attr_err = allow_max_smem(empty_kernel);
  if (empty_attr_err != cudaSuccess) return empty_attr_err;
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  if (form == kServeForm) {
    const size_t smem = ServeSmem<HD, CB>::bytes(H / Hkv);
    if (smem > 227 * 1024) return cudaErrorInvalidValue;
    const unsigned blocks = static_cast<unsigned>(B) * Hkv;
    if (empty)
      empty_kernel<<<blocks, kThreads, smem, stream>>>();
    else
      serve_kernel<HD, CB><<<blocks, kThreads, smem, stream>>>(
          q, kc, vc, ksc, vsc, kcur, vcur, out, H, Hkv, S, pos, pos_dev, scale);
    return cudaGetLastError();
  }
  if (form != kClusterForm || B * Hkv > 65535) return cudaErrorInvalidValue;
  const int tiles = (pos_dev ? S : pos) / kTile + 1;  // pos + 1 rows
  const int cs = max(1, min(tiles, kMaxCluster));
  const size_t smem = DecodeSmem<HD, CB>::bytes(H / Hkv, cs);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  const cudaError_t err = empty
      ? launch_cluster(empty_kernel, cs, B * Hkv, smem, stream)
      : launch_cluster(decode_kernel<HD, CB>, cs, B * Hkv, smem, stream, q, kc, vc,
                       ksc, vsc, kcur, vcur, out, H, Hkv, S, pos, pos_dev, scale);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The int8 x int8 products (see the head of the file).
// threads of a block in each form: the cluster form's few blocks take all the
// parallelism they can; the serving form's many hold more blocks an SM with
// fewer threads (measured: profile_kernels.py, PERF.md)
constexpr int kDotThreadsCluster = 256;
constexpr int kDotThreadsServe = 128;
constexpr int kDotSlots = 8;             // warp slots of the reductions (256 / 32)
constexpr int kMaxGroups = 64;
constexpr int kDotStages = 2;  // ring stages, one 64-row K or V tile each

__host__ __device__ inline int up16(int n) { return (n + 15) / 16 * 16; }

// Bytes between two rows of a staged int8 or int4 tile: an odd multiple of
// 16, so that the eight rows a warp scores at once (four lanes a row, one
// 4-byte word each) meet distinct banks.
__host__ __device__ constexpr int dots_row_bytes(int rd) {
  return rd + ((rd / 16) % 2 ? 0 : 16);
}

// Byte offsets of a block's shared memory, for rep query heads per KV head,
// `rows` cache rows a block (its tiles times 64) and G groups; mirrored by
// dots_smem_bytes in ops/decode_attention.py.
struct DotsLayout {
  int ring, q8, p8, q_f, cur_f, prob, ks, vs, gmax, ml, stat, red, acc, starts, bar, bytes;
  __host__ __device__ DotsLayout(int HD, bool q4, int rep, int rows, int G) {
    ring = 0;                                      // kDotStages tiles of kTile rows
    q8 = ring + kDotStages * kTile * dots_row_bytes(q4 ? HD / 2 : HD);
    p8 = q8 + up16(rep * HD);                      // int8 [rep][HD], then [rep][rows]
    q_f = p8 + up16(rep * rows);                   // float [rep][HD]
    cur_f = q_f + up16(4 * rep * HD);              // float [2][HD]: k_cur, v_cur
    prob = cur_f + up16(8 * HD);                   // float [rep][rows]: the scores
    ks = prob + up16(4 * rep * rows);              // float [rows]: k_scale of the rows
    vs = ks + up16(4 * rows);                      // float [rows]: v_scale
    gmax = vs + up16(4 * rows);                    // uint [rep][G]: groups' max of p * v_scale
    ml = gmax + up16(4 * rep * G);                 // float [rep][8][2]: each block's max, sum
    stat = ml + up16(8 * rep * kMaxCluster);       // float [rep][4]: q scale, self, M, Z
    red = stat + up16(16 * rep);                   // float [2][rep][8]: warp maxima, sums
    acc = red + up16(8 * rep * kDotSlots);         // int [rep][G][HD]: the group sums
    starts = acc + up16(4 * rep * G * HD);         // int [G]
    bar = starts + up16(4 * G);                    // kDotStages mbarriers
    bytes = bar + 8 * kDotStages;
  }
};

// Group g covers the rows from its start (row 0 for the first) to the next
// group's (pos for the last), clamped to [0, pos].
__device__ __forceinline__ int group_lo(const int* st, int g, int pos) {
  return g == 0 ? 0 : min(max(st[g], 0), pos);
}
__device__ __forceinline__ int group_hi(const int* st, int G, int g, int pos) {
  return g == G - 1 ? pos : min(max(st[g + 1], 0), pos);
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

// CL: the cluster form (cs blocks a (b, KV head), rank = blockIdx.x % cs), or
// the serving form (one block a pair, cs = 1); NT threads a block. rows: the
// rows of a block's shared-memory arrays, a multiple of 64.
template <int HD, bool Q4, bool CL, int NT>
__global__ void __launch_bounds__(NT)
dots_kernel(const bf16* __restrict__ q, const unsigned char* __restrict__ kc,
            const unsigned char* __restrict__ vc, const float* __restrict__ ksc,
            const float* __restrict__ vsc, const bf16* __restrict__ kcur,
            const bf16* __restrict__ vcur, bf16* __restrict__ out,
            const int* __restrict__ starts, int G, int H, int Hkv, int S, int pos_host,
            const int* __restrict__ pos_dev, float scale, int cs, int rows) {
  constexpr int RD = Q4 ? HD / 2 : HD;  // bytes of a cached row of one head
  constexpr int RB = dots_row_bytes(RD);
  constexpr int W = HD / 4;             // int8 words of a head's q
  constexpr int UNIT = Q4 ? 16 : 1;     // an int4 product's factor
  constexpr int NW = NT / 32;           // warps
  constexpr int kPre = 4;               // scales a thread loads before it stores any
  static_assert(NW <= kDotSlots && NT >= 128, "a block of 128 or 256 threads");
  extern __shared__ __align__(16) unsigned char smem[];
  const int rep = H / Hkv;
  const DotsLayout lay(HD, Q4, rep, rows, G);
  unsigned char* ring = smem + lay.ring;
  signed char* q8 = reinterpret_cast<signed char*>(smem + lay.q8);
  signed char* p8 = reinterpret_cast<signed char*>(smem + lay.p8);
  float* q_f = reinterpret_cast<float*>(smem + lay.q_f);
  float* cur_f = reinterpret_cast<float*>(smem + lay.cur_f);
  float* prob = reinterpret_cast<float*>(smem + lay.prob);
  float* ks_sm = reinterpret_cast<float*>(smem + lay.ks);
  float* vs_sm = reinterpret_cast<float*>(smem + lay.vs);
  unsigned* gmax = reinterpret_cast<unsigned*>(smem + lay.gmax);
  float* ml = reinterpret_cast<float*>(smem + lay.ml);
  float* stat = reinterpret_cast<float*>(smem + lay.stat);
  float* red_max = reinterpret_cast<float*>(smem + lay.red);
  float* red_sum = red_max + rep * kDotSlots;
  int* acc = reinterpret_cast<int*>(smem + lay.acc);
  int* st = reinterpret_cast<int*>(smem + lay.starts);
  const uint32_t bar = smem_u32(smem + lay.bar);  // stage s: bar + 8 s

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = CL ? static_cast<int>(blockIdx.x % cs) : 0;
  const size_t pair = CL ? blockIdx.x / cs : blockIdx.x;
  const int b = static_cast<int>(pair / Hkv), hk = static_cast<int>(pair % Hkv);
  int pos = pos_dev ? *pos_dev : pos_host;
  const size_t row = static_cast<size_t>(Hkv) * RD;  // a position's bytes, all heads
  const unsigned char* kb = kc + (static_cast<size_t>(b) * S * Hkv + hk) * RD;
  const unsigned char* vb = vc + (static_cast<size_t>(b) * S * Hkv + hk) * RD;
  const size_t scale_b = static_cast<size_t>(b) * S * Hkv + hk;  // + t * Hkv
  const size_t cur = (static_cast<size_t>(b) * Hkv + hk) * HD;
  const bf16* qb = q + (static_cast<size_t>(b) * H + hk * rep) * HD;

  // dots 1. the stages' mbarriers, then the block's first tiles requested.
  // The block's tiles are tiles rank, rank + cs, ... holding rows below lim:
  // in the cluster form the rows its launch covers below S, copied without
  // waiting for pos (rows at or past pos are masked); in the serving form the
  // rows below pos. Copy L is K tile L (L < nt), then V tile L - nt.
  if (tid == 0)
    for (int s = 0; s < kDotStages; ++s) mbar_init(bar + 8 * s, kTile);
  __syncthreads();
  if constexpr (!CL) pos = max(0, min(pos, S));
  const int lim = CL ? min(S, ((pos_dev ? S : pos_host) / kTile + 1) * kTile) : pos;
  const int n_tiles = (lim + kTile - 1) / kTile;
  const int nt = rank < n_tiles ? (n_tiles - 1 - rank) / cs + 1 : 0;
  auto issue = [&](int L) {  // by the threads tid < kTile, one row each
    const int s = L % kDotStages, j = L < nt ? L : L - nt;
    const int t = (rank + j * cs) * kTile + tid;
    const bool mine = t < lim;
    mbar_arrive_expect(bar + 8 * s, mine ? RD : 0);
    if (mine)
      bulk_copy(smem_u32(ring + (s * kTile + tid) * RB),
                (L < nt ? kb : vb) + static_cast<size_t>(t) * row, RD, bar + 8 * s);
  };
  if (tid < kTile)
    for (int L = 0; L < kDotStages && L < 2 * nt; ++L) issue(L);

  // q, the current position's k and v, the groups' starts and the rows'
  // scales (0 past lim): a thread issues its first loads of each before it
  // stores any, so that they share one round trip with the copies; the
  // scales wait in registers while q is quantized
  const int nsc = 2 * nt * kTile;  // k_scale of the block's rows, then v_scale
  auto scale_of = [&](int i) {
    const bool is_v = i >= nt * kTile;
    const int jj = is_v ? i - nt * kTile : i;
    const int t = (rank + (jj / kTile) * cs) * kTile + jj % kTile;
    return t < lim ? (is_v ? vsc : ksc)[scale_b + static_cast<size_t>(t) * Hkv] : 0.f;
  };
  auto scale_at = [&](int i) -> float& {
    return i >= nt * kTile ? vs_sm[i - nt * kTile] : ks_sm[i];
  };
  const bf16 zero = __float2bfloat16(0.f);
  const bf16 q0 = tid < rep * HD ? qb[tid] : zero;
  const bf16 kc0 = tid < HD ? kcur[cur + tid] : zero;
  const bf16 vc0 = tid < HD ? vcur[cur + tid] : zero;
  const int st0 = tid < G ? starts[tid] : 0;
  float sc[kPre];
#pragma unroll
  for (int k = 0; k < kPre; ++k) sc[k] = tid + k * NT < nsc ? scale_of(tid + k * NT) : 0.f;
  // the group sums, group maxima and warp maxima zeroed
  for (int i = tid; i < rep * G * HD; i += NT) acc[i] = 0;
  for (int i = tid; i < rep * G; i += NT) gmax[i] = 0u;
  for (int i = tid; i < rep * kDotSlots; i += NT) red_max[i] = -INFINITY;
  if (tid < rep * HD) q_f[tid] = to_f(q0);
  for (int i = tid + NT; i < rep * HD; i += NT) q_f[i] = to_f(qb[i]);
  if (tid < HD) {
    cur_f[tid] = to_f(kc0);
    cur_f[HD + tid] = to_f(vc0);
  }
  if (tid < G) st[tid] = st0;
  __syncthreads();

  // dots 2. q per query head as int8 (scale max|q| / 127, at least 1e-8,
  // rounded half to even) and the current position's score in float32, the
  // same in every block of a cluster; then the scales stored
  for (int r = warp; r < rep; r += NW) {
    const float* qr = q_f + r * HD;
    float m = 0.f, self = 0.f;
    for (int d = lane; d < HD; d += 32) {
      m = fmaxf(m, fabsf(qr[d]));
      self += qr[d] * cur_f[d];
    }
    const float qs = fmaxf(warp_max(m) / 127.f, 1e-8f);
    self = warp_sum(self) * scale;
    for (int d = lane; d < HD; d += 32)
      q8[r * HD + d] = static_cast<signed char>(fminf(fmaxf(rintf(qr[d] / qs), -127.f), 127.f));
    if (lane == 0) {
      stat[4 * r] = qs;
      stat[4 * r + 1] = self;
    }
  }
#pragma unroll
  for (int k = 0; k < kPre; ++k)
    if (tid + k * NT < nsc) scale_at(tid + k * NT) = sc[k];
  for (int i = tid + kPre * NT; i < nsc; i += NT) scale_at(i) = scale_of(i);
  pos = max(0, min(pos, S));
  __syncthreads();

  // dots 3. the scores of the block's rows below pos, four lanes a row (one
  // exact int32 q8 . k8 per query head), and each warp's max per head
  const int quad = tid >> 2, sub = tid & 3;
  for (int j = 0; j < nt; ++j) {
    const int s = j % kDotStages;
    mbar_wait(bar + 8 * s, (j / kDotStages) & 1);
    for (int i = quad; i < kTile; i += NT / 4) {
      const int t = (rank + j * cs) * kTile + i;
      const int* kr = reinterpret_cast<const int*>(ring + (s * kTile + i) * RB);
      int kw[RD / 16];
#pragma unroll
      for (int k = 0; k < RD / 16; ++k) kw[k] = kr[sub + 4 * k];
      const float ks = ks_sm[j * kTile + i];
      for (int r = 0; r < rep; ++r) {
        const int* qw = reinterpret_cast<const int*>(q8 + r * HD);
        int dot = 0;
#pragma unroll
        for (int k = 0; k < RD / 16; ++k) {
          const int w = sub + 4 * k;
          if constexpr (Q4) {  // packed word w: elements 4w.. (low) and HD/2 + 4w.. (high)
            const unsigned x = static_cast<unsigned>(kw[k]);
            dot = __dp4a(static_cast<int>((x << 4) & 0xF0F0F0F0u), qw[w], dot);
            dot = __dp4a(static_cast<int>(x & 0xF0F0F0F0u), qw[W / 2 + w], dot);
          } else {
            dot = __dp4a(kw[k], qw[w], dot);
          }
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        const float sc_t = t < pos
            ? static_cast<float>(dot / UNIT) * (scale * stat[4 * r]) * ks : -INFINITY;
        if (sub == 0) prob[r * rows + j * kTile + i] = sc_t;
        const float m = warp_max(sc_t);
        if (lane == 0) red_max[r * kDotSlots + warp] = fmaxf(red_max[r * kDotSlots + warp], m);
      }
    }
    if (j + kDotStages < 2 * nt) {  // every warp is done with stage s
      __syncthreads();
      if (tid < kTile) {
        fence_proxy_async();
        issue(j + kDotStages);
      }
    }
  }
  __syncthreads();

  // dots 4. the block's max and sum of exp(s - max) per head, every thread
  // over its rows, then the warps in order (a fixed order: the host's and the
  // device's pos give the same bits), stored into every block's slot `rank`
  for (int r = 0; r < rep; ++r) {
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) m = fmaxf(m, red_max[r * kDotSlots + w]);
    float l = 0.f;
    if (m != -INFINITY)
      for (int jj = tid; jj < nt * kTile; jj += NT) l += expf(prob[r * rows + jj] - m);
    l = warp_sum(l);
    if (lane == 0) red_sum[r * kDotSlots + warp] = l;
  }
  __syncthreads();
  for (int i = tid; i < rep * cs; i += NT) {
    const int r = i / cs, k = i % cs;
    float m = -INFINITY, l = 0.f;
    for (int w = 0; w < NW; ++w) {
      m = fmaxf(m, red_max[r * kDotSlots + w]);
      l += red_sum[r * kDotSlots + w];
    }
    float* dst = (CL ? cluster_ptr(ml, k) : ml) + (r * kMaxCluster + rank) * 2;
    dst[0] = m;
    dst[1] = l;
  }
  if constexpr (CL) cluster_sync(); else __syncthreads();

  // dots 5. the softmax's max M and sum Z over the whole sequence: the
  // blocks' (max, sum) in rank order, then the current position's score
  for (int r = tid; r < rep; r += NT) {
    const float* mr = ml + r * kMaxCluster * 2;
    const float self = stat[4 * r + 1];
    float M = self;
    for (int k = 0; k < cs; ++k) M = fmaxf(M, mr[2 * k]);
    float Z = 0.f;
    for (int k = 0; k < cs; ++k)
      if (mr[2 * k] != -INFINITY) Z += mr[2 * k + 1] * expf(mr[2 * k] - M);
    Z += expf(self - M);
    stat[4 * r + 2] = M;
    stat[4 * r + 3] = Z;
  }
  __syncthreads();

  // dots 6. each group's max of p * v_scale over the block's rows (p =
  // exp(s - M) / Z, the plain version's order), a warp per (head, group)
  // walking the group's row range, merged into every block's maxima
  // (non-negative floats order as their bits)
  for (int pr = warp; pr < rep * G; pr += NW) {
    const int r = pr / G, g = pr % G;
    const int glo = group_lo(st, g, pos), ghi = group_hi(st, G, g, pos);
    const float M = stat[4 * r + 2], Z = stat[4 * r + 3];
    float mx = 0.f;
    bool any = false;
    for (int j = 0; j < nt; ++j) {
      const int t0 = (rank + j * cs) * kTile;
      const int lo = max(glo, t0), hi = min(ghi, t0 + kTile);
      any |= lo < hi;
      for (int t = lo + lane; t < hi; t += 32) {
        const int jj = j * kTile + t - t0;
        mx = fmaxf(mx, expf(prob[r * rows + jj] - M) / Z * vs_sm[jj]);
      }
    }
    if (any) {
      mx = warp_max(mx);
      if (lane < cs) atomicMax((CL ? cluster_ptr(gmax, lane) : gmax) + pr, __float_as_uint(mx));
    }
  }
  if constexpr (CL) cluster_sync(); else __syncthreads();

  // dots 7. p8 of the block's rows with their group's scale, walked the same way
  for (int pr = warp; pr < rep * G; pr += NW) {
    const int r = pr / G, g = pr % G;
    const int glo = group_lo(st, g, pos), ghi = group_hi(st, G, g, pos);
    const float M = stat[4 * r + 2], Z = stat[4 * r + 3];
    const float ps = fmaxf(__uint_as_float(gmax[pr]) / 127.f, 1e-8f);
    for (int j = 0; j < nt; ++j) {
      const int t0 = (rank + j * cs) * kTile;
      const int lo = max(glo, t0), hi = min(ghi, t0 + kTile);
      for (int t = lo + lane; t < hi; t += 32) {
        const int jj = j * kTile + t - t0;
        const float pc = expf(prob[r * rows + jj] - M) / Z * vs_sm[jj];
        p8[r * rows + jj] = static_cast<signed char>(fminf(fmaxf(rintf(pc / ps), -127.f), 127.f));
      }
    }
  }
  __syncthreads();

  // dots 8. p8 . v8 over the block's V tiles: a thread takes 4 dims of one
  // query head over a slice of a tile's rows, four rows a step (the 4 x 4
  // bytes transposed so that one __dp4a sums one dim over four rows), and
  // adds its exact sums into the group's accumulators whenever its rows
  // cross into the next group
  const int units = rep * W;
  const int slices = max(1, min(kTile / 4, NT / units));
  const int span = ((kTile + slices - 1) / slices + 3) / 4 * 4;  // slices * span >= kTile
  for (int j = 0; j < nt; ++j) {
    const int L = nt + j, s = L % kDotStages;
    mbar_wait(bar + 8 * s, (L / kDotStages) & 1);
    const int t0 = (rank + j * cs) * kTile;
    const unsigned char* vt = ring + s * kTile * RB;
    for (int u = tid; u < units * slices; u += NT) {
      const int sl = u / units, r = (u % units) / W, d0 = (u % W) * 4;
      const int a = t0 + sl * span, e = min(min(a + span, t0 + kTile), pos);
      if (a >= e) continue;
      const signed char* pr8 = p8 + r * rows + j * kTile - t0;  // indexed by row
      int g = 0;
      while (g < G - 1 && group_hi(st, G, g, pos) <= a) ++g;
      int hi = group_hi(st, G, g, pos);
      int sum[4] = {0, 0, 0, 0};
      auto flush = [&]() {
        int* dst = acc + (r * G + g) * HD + d0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (sum[k]) atomicAdd(dst + k, sum[k]);
          sum[k] = 0;
        }
      };
      for (int t = a; t < e; t += 4) {
        int R[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          R[k] = t + k < e ? row_word<HD, Q4>(vt + (t - t0 + k) * RB, d0) : 0;
        const int x01 = __byte_perm(R[0], R[1], 0x5140), y01 = __byte_perm(R[0], R[1], 0x7362);
        const int x23 = __byte_perm(R[2], R[3], 0x5140), y23 = __byte_perm(R[2], R[3], 0x7362);
        const int C[4] = {static_cast<int>(__byte_perm(x01, x23, 0x5410)),
                          static_cast<int>(__byte_perm(x01, x23, 0x7632)),
                          static_cast<int>(__byte_perm(y01, y23, 0x5410)),
                          static_cast<int>(__byte_perm(y01, y23, 0x7632))};
        const int P = *reinterpret_cast<const int*>(pr8 + t);  // rows t .. t + 3
        if (min(t + 4, e) <= hi) {
#pragma unroll
          for (int k = 0; k < 4; ++k) sum[k] = __dp4a(C[k], P, sum[k]);
        } else {  // a group starts inside these four rows
          for (int k = 0; k < 4 && t + k < e; ++k) {
            while (t + k >= hi) {
              flush();
              ++g;
              hi = group_hi(st, G, g, pos);
            }
            const int Pk = static_cast<int>(static_cast<unsigned>(P) & (0xFFu << (8 * k)));
#pragma unroll
            for (int c = 0; c < 4; ++c) sum[c] = __dp4a(C[c], Pk, sum[c]);
          }
        }
      }
      flush();
    }
    if (L + kDotStages < 2 * nt) {  // every warp is done with stage s
      __syncthreads();
      if (tid < kTile) {
        fence_proxy_async();
        issue(L + kDotStages);
      }
    }
  }
  __syncthreads();

  // dots 9. the block's integer sums into rank 0's (exact, in any order)
  if constexpr (CL) {
    if (rank != 0) {
      int* acc0 = cluster_ptr(acc, 0);
      for (int i = tid; i < rep * G * HD; i += NT) {
        const int v = acc[i];
        if (v) atomicAdd(acc0 + i, v);
      }
    }
    cluster_sync();
    if (rank != 0) return;
  }

  // dots 10. out = sum over groups of float(int32 sum) * p_s, then + p_self * v_cur
  for (int i = tid; i < rep * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    float o = 0.f;
    for (int g = 0; g < G; ++g)
      o = o + static_cast<float>(acc[(r * G + g) * HD + d] / UNIT) *
                  fmaxf(__uint_as_float(gmax[r * G + g]) / 127.f, 1e-8f);
    o = o + expf(stat[4 * r + 1] - stat[4 * r + 2]) / stat[4 * r + 3] * cur_f[HD + d];
    out[(static_cast<size_t>(b) * H + hk * rep + r) * HD + d] = __float2bfloat16(o);
  }
  // dots 11. done
}

__global__ void __launch_bounds__(256) empty_dots_kernel() {}

template <int HD, bool Q4>
cudaError_t launch_dots(const bf16* q, const void* kc, const void* vc, const float* ksc,
                        const float* vsc, const bf16* kcur, const bf16* vcur, bf16* out,
                        const int* starts, int G, int B, int H, int Hkv, int S, int pos,
                        const int* pos_dev, int form, bool empty, cudaStream_t stream) {
  constexpr int NC = kDotThreadsCluster, NS = kDotThreadsServe;
  static const cudaError_t cl_attr_err = allow_max_smem(dots_kernel<HD, Q4, true, NC>);
  if (cl_attr_err != cudaSuccess) return cl_attr_err;
  static const cudaError_t attr_err = allow_max_smem(dots_kernel<HD, Q4, false, NS>);
  if (attr_err != cudaSuccess) return attr_err;
  static const cudaError_t empty_attr_err = allow_max_smem(empty_dots_kernel);
  if (empty_attr_err != cudaSuccess) return empty_attr_err;
  if (form != kClusterForm && form != kServeForm) return cudaErrorInvalidValue;
  const bool cl = form == kClusterForm;
  const int tiles = (pos_dev ? S : pos) / kTile + 1;  // the rows the launch covers
  const int cs = cl ? min(tiles, kMaxCluster) : 1;
  const int rows = (cl ? (tiles + cs - 1) / cs : tiles) * kTile;
  const size_t smem = DotsLayout(HD, Q4, H / Hkv, rows, G).bytes;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  const long blocks = static_cast<long>(B) * Hkv * cs;  // one dimension: above 65,535
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(cl ? NC : NS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cl ? 1 : 0;
  const auto k8 = static_cast<const unsigned char*>(kc);
  const auto v8 = static_cast<const unsigned char*>(vc);
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  cudaError_t err;
  if (empty)
    err = cudaLaunchKernelEx(&cfg, empty_dots_kernel);
  else if (cl)
    err = cudaLaunchKernelEx(&cfg, dots_kernel<HD, Q4, true, NC>, q, k8, v8, ksc, vsc, kcur,
                             vcur, out, starts, G, H, Hkv, S, pos, pos_dev, scale, cs, rows);
  else
    err = cudaLaunchKernelEx(&cfg, dots_kernel<HD, Q4, false, NS>, q, k8, v8, ksc, vsc,
                             kcur, vcur, out, starts, G, H, Hkv, S, pos, pos_dev, scale, cs,
                             rows);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// cb: bits of a cached element (16, 8 or 4) for decode_kernel / serve_kernel;
// dots: the int8 x int8 kernel over an int8 (cb 8) or int4 (cb 4) cache;
// form: 0 the cluster form, 1 the serving form
int dispatch(int cb, bool dots, const void* q, const void* k_cache, const void* v_cache,
             const void* k_scale, const void* v_scale, const void* k_cur,
             const void* v_cur, void* out, const void* starts, int G, int B, int H,
             int Hkv, int S, int hd, int form, int pos, const void* pos_dev, bool empty,
             void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || B <= 0 || S < 0 ||
      (!pos_dev && (pos < 0 || pos > S)) || (form != kClusterForm && form != kServeForm))
    return cudaErrorInvalidValue;
  if (static_cast<long>(B) * Hkv > 0x7fffffffL ||
      (dots && (cb == 16 || G < 1 || G > kMaxGroups)))
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
                                            G, B, H, Hkv, S, pos, pd, form, empty, st)    \
                     : launch_dots<D, false>(q_, k_cache, v_cache, ks, vs, kr, vr, op,    \
                                             sg, G, B, H, Hkv, S, pos, pd, form, empty,   \
                                             st);                                         \
    switch (cb) {                                                                         \
      case 16: return launch<D, 16>(q_, k_cache, v_cache, ks, vs, kr, vr, op, B, H, Hkv,  \
                                    S, pos, pd, form, empty, st);                         \
      case 8: return launch<D, 8>(q_, k_cache, v_cache, ks, vs, kr, vr, op, B, H, Hkv, S, \
                                  pos, pd, form, empty, st);                              \
      case 4: return launch<D, 4>(q_, k_cache, v_cache, ks, vs, kr, vr, op, B, H, Hkv, S, \
                                  pos, pd, form, empty, st);                              \
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
// device memory (`pos` is ignored). form: 0 the cluster form, 1 the serving
// form (ops/decode_attention.py::launch_plan picks it from the shapes).
extern "C" int vt_decode_attention(const void* q, const void* k_cache,
                                   const void* v_cache, const void* k_cur,
                                   const void* v_cur, void* out, int B, int H,
                                   int Hkv, int S, int hd, int form, int pos,
                                   const void* pos_dev, void* stream) {
  return dispatch(16, false, q, k_cache, v_cache, nullptr, nullptr, k_cur, v_cur, out,
                  nullptr, 0, B, H, Hkv, S, hd, form, pos, pos_dev, false, stream);
}

// The int8 cache: k/v [B, S, Hkv, hd] int8, k_scale/v_scale [B, S, Hkv]
// float32; q, k_cur, v_cur and out bf16 as above.
extern "C" int vt_decode_attention_int8(const void* q, const void* k_cache,
                                        const void* v_cache, const void* k_scale,
                                        const void* v_scale, const void* k_cur,
                                        const void* v_cur, void* out, int B, int H,
                                        int Hkv, int S, int hd, int form, int pos,
                                        const void* pos_dev, void* stream) {
  return dispatch(8, false, q, k_cache, v_cache, k_scale, v_scale, k_cur, v_cur, out,
                  nullptr, 0, B, H, Hkv, S, hd, form, pos, pos_dev, false, stream);
}

// The int4 cache: k/v [B, S, Hkv, hd / 2] int8 (two values a byte,
// half-split), scales as for int8.
extern "C" int vt_decode_attention_int4(const void* q, const void* k_cache,
                                        const void* v_cache, const void* k_scale,
                                        const void* v_scale, const void* k_cur,
                                        const void* v_cur, void* out, int B, int H,
                                        int Hkv, int S, int hd, int form, int pos,
                                        const void* pos_dev, void* stream) {
  return dispatch(4, false, q, k_cache, v_cache, k_scale, v_scale, k_cur, v_cur, out,
                  nullptr, 0, B, H, Hkv, S, hd, form, pos, pos_dev, false, stream);
}

// The int8 x int8 products over an int8 (cache_bits 8) or int4 (4) cache:
// starts, n_groups int32 in device memory, the first row of each
// quantization group in increasing order (rows below starts[1] are group 0).
extern "C" int vt_decode_attention_dots(const void* q, const void* k_cache,
                                        const void* v_cache, const void* k_scale,
                                        const void* v_scale, const void* k_cur,
                                        const void* v_cur, void* out,
                                        const void* starts, int n_groups, int B, int H,
                                        int Hkv, int S, int hd, int cache_bits, int form,
                                        int pos, const void* pos_dev, void* stream) {
  if (cache_bits != 8 && cache_bits != 4) return cudaErrorInvalidValue;
  return dispatch(cache_bits, true, q, k_cache, v_cache, k_scale, v_scale, k_cur, v_cur,
                  out, starts, n_groups, B, H, Hkv, S, hd, form, pos, pos_dev, false,
                  stream);
}

// An empty kernel with the launch configuration of one of the entry points
// above for these sizes and this form: the floor of one launch. kind: 0
// vt_decode_attention, 1 _int8, 2 _int4, 3 _dots (n_groups groups).
extern "C" int vt_decode_attention_empty(int B, int H, int Hkv, int S, int hd,
                                         int pos, int pos_on_device, int kind,
                                         int n_groups, int form, void* stream) {
  static const int dummy = 0;
  const void* pd = pos_on_device ? &dummy : nullptr;
  if (kind < 0 || kind > 3) return cudaErrorInvalidValue;
  const int cb = kind == 0 ? 16 : kind == 2 ? 4 : 8;
  return dispatch(cb, kind == 3, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, nullptr, n_groups, B, H, Hkv, S, hd, form, pos, pd, true,
                  stream);
}

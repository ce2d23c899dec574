// Decode attention for one layer and one step: split-K flash decoding.
//
// Replaces the Pallas kernel vaura_tpu/ops/pallas_attention.py::
// decode_attention (kernel _make_kernel, :57; call :215). Same contract:
// the query of position `pos` attends over the cached positions < pos plus
// this position's own k_cur/v_cur, which the caller commits to the cache
// only after the step.
//
//   q      [B, H, hd]          bf16
//   k/v    [B, S, Hkv, hd]     bf16, one layer of the cache, read in place
//   k/v_cur[B, Hkv, hd]        bf16
//   out    [B, H, hd]          bf16
//
// Bound on the H100: bytes. Per layer and step the work reads
// 2*B*pos*Hkv*hd*2 bytes of cache and does about 4*B*H*pos*hd flops, far
// below the card's ~295 flops per byte, so the cache stream is the bound.
//
// Design:
//  * grid (B*H, ceil(pos/64)): each block streams one 64-position tile of
//    K and V, so only the tiles that hold positions < pos are read (what
//    decode_buckets did with chunk buffers on the TPU) and small batches
//    still spread over many SMs. Each warp issues all the K and V loads of
//    its 16 positions before using them, so one tile costs about one memory
//    latency. A second tiny launch merges the per-tile (max, sum, acc)
//    partials and adds the current-position term.
//  * hd = 96 is three elements per lane of one warp (lane-strided, so each
//    load is one coalesced 64-byte row segment): no padding to 128.
//  * the cache is taken in place; nothing is copied or padded (the JAX
//    wrapper jnp.pads the whole cache to a multiple of 64 each call).
//  * GQA by indexing the KV head as h / (H / Hkv).
//  * float32 scores, softmax and accumulators; the output is rounded to
//    bf16 once.
#include "common.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kWarps = 4;

template <int EPL>
__global__ void __launch_bounds__(kWarps * 32)
split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kc,
             const bf16* __restrict__ vc, float* __restrict__ part, int H,
             int Hkv, int S, int pos, float scale) {
  constexpr int HD = 32 * EPL;
  constexpr int kPer = kTile / kWarps;  // positions per warp
  __shared__ float acc_sm[kWarps][HD];
  __shared__ float m_sm[kWarps], l_sm[kWarps];

  const int bh = blockIdx.x, b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int split = blockIdx.y, n_split = gridDim.y;
  const int t0 = split * kTile;
  const int n = min(kTile, pos - t0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  float qr[EPL];
  const bf16* qp = q + static_cast<size_t>(bh) * HD;
#pragma unroll
  for (int e = 0; e < EPL; ++e) qr[e] = to_f(qp[e * 32 + lane]) * scale;

  const size_t row = static_cast<size_t>(Hkv) * HD;  // stride of a position
  const size_t base = (static_cast<size_t>(b) * S + t0) * row +
                      static_cast<size_t>(hk) * HD;
  const bf16* kb = kc + base;
  const bf16* vb = vc + base;

  // issue every K and V load of this warp's positions (warp, warp + 4, ...)
  // before using any, so the tile's reads are in flight together
  bf16 kr[kPer][EPL], vr[kPer][EPL];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = warp + j * kWarps;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      kr[j][e] = i < n ? kb[i * row + e * 32 + lane] : __float2bfloat16(0.f);
      vr[j][e] = i < n ? vb[i * row + e * 32 + lane] : __float2bfloat16(0.f);
    }
  }
  float s[kPer];
  float wm = -INFINITY;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    float a = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) a += qr[e] * to_f(kr[j][e]);
    s[j] = warp_sum(a);
    if (warp + j * kWarps < n) wm = fmaxf(wm, s[j]);
  }
  if (lane == 0) m_sm[warp] = wm;
  __syncthreads();
  float m = m_sm[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, m_sm[w]);

  float acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;
  float l = 0.f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (warp + j * kWarps < n) {
      const float p = expf(s[j] - m);
      l += p;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[e] += p * to_f(vr[j][e]);
    }
  }
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc_sm[warp][e * 32 + lane] = acc[e];
  if (lane == 0) l_sm[warp] = l;
  __syncthreads();

  if (warp == 0) {
    float* out = part + (static_cast<size_t>(bh) * n_split + split) * (HD + 2);
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) a += acc_sm[w][e * 32 + lane];
      out[e * 32 + lane] = a;
    }
    if (lane == 0) {
      float lt = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) lt += l_sm[w];
      out[HD] = m;
      out[HD + 1] = lt;
    }
  }
}

// One warp per (b, h): merge the tile partials with the current position.
template <int EPL>
__global__ void __launch_bounds__(32)
combine_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kcur,
               const bf16* __restrict__ vcur, const float* __restrict__ part,
               bf16* __restrict__ out, int H, int Hkv, int n_split,
               float scale) {
  constexpr int HD = 32 * EPL;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int lane = threadIdx.x;

  const bf16* qp = q + static_cast<size_t>(bh) * HD;
  const size_t kv_off = (static_cast<size_t>(b) * Hkv + hk) * HD;
  float qr[EPL], vr[EPL];
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < EPL; ++e) {
    qr[e] = to_f(qp[e * 32 + lane]) * scale;
    s += qr[e] * to_f(kcur[kv_off + e * 32 + lane]);
    vr[e] = to_f(vcur[kv_off + e * 32 + lane]);
  }
  s = warp_sum(s);

  const float* pb = part + static_cast<size_t>(bh) * n_split * (HD + 2);
  float m = s;
  for (int i = 0; i < n_split; ++i) m = fmaxf(m, pb[i * (HD + 2) + HD]);
  const float pc = expf(s - m);
  float l = pc;
  float acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = pc * vr[e];
  for (int i = 0; i < n_split; ++i) {
    const float* pi = pb + i * (HD + 2);
    const float w = expf(pi[HD] - m);
    l += w * pi[HD + 1];
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] += w * pi[e * 32 + lane];
  }
  bf16* op = out + static_cast<size_t>(bh) * HD;
#pragma unroll
  for (int e = 0; e < EPL; ++e) op[e * 32 + lane] = __float2bfloat16(acc[e] / l);
}

template <int EPL>
cudaError_t launch(const bf16* q, const bf16* kc, const bf16* vc,
                   const bf16* kcur, const bf16* vcur, float* part, bf16* out,
                   int B, int H, int Hkv, int S, int pos, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf(static_cast<float>(32 * EPL));
  const int n_split = (pos + kTile - 1) / kTile;
  if (n_split > 0) {
    split_kernel<EPL><<<dim3(B * H, n_split), kWarps * 32, 0, stream>>>(
        q, kc, vc, part, H, Hkv, S, pos, scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  combine_kernel<EPL><<<B * H, 32, 0, stream>>>(q, kcur, vcur, part, out, H,
                                                Hkv, n_split, scale);
  return cudaGetLastError();
}

}  // namespace

// part: float32 scratch of B*H*ceil(pos/64)*(hd+2) values.
extern "C" int vt_decode_attention(const void* q, const void* k_cache,
                                   const void* v_cache, const void* k_cur,
                                   const void* v_cur, void* part, void* out,
                                   int B, int H, int Hkv, int S, int hd,
                                   int pos, void* stream) {
  if (pos < 0 || pos > S || Hkv <= 0 || H % Hkv != 0)
    return cudaErrorInvalidValue;
  auto q_ = static_cast<const bf16*>(q);
  auto kc = static_cast<const bf16*>(k_cache);
  auto vc = static_cast<const bf16*>(v_cache);
  auto kr = static_cast<const bf16*>(k_cur);
  auto vr = static_cast<const bf16*>(v_cur);
  auto pp = static_cast<float*>(part);
  auto op = static_cast<bf16*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch<1>(q_, kc, vc, kr, vr, pp, op, B, H, Hkv, S, pos, st);
    case 64: return launch<2>(q_, kc, vc, kr, vr, pp, op, B, H, Hkv, S, pos, st);
    case 96: return launch<3>(q_, kc, vc, kr, vr, pp, op, B, H, Hkv, S, pos, st);
    case 128: return launch<4>(q_, kc, vc, kr, vr, pp, op, B, H, Hkv, S, pos, st);
    default: return cudaErrorInvalidValue;
  }
}

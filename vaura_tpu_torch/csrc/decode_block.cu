// The Llama decode block's elementwise work, in three kernels:
//
//   add_rmsnorm   h = x + a (rounded to x's dtype), n = RMSNorm(h) * w
//                 (float32, cast back); without a, n = RMSNorm(x) * w
//   rope_qkv      interleaved-pair RoPE on q and k of the fused wqkv output,
//                 contiguous q, k, v, and for an int8 cache this layer's
//                 int8 k and v rows with their float32 scales
//   swiglu        silu(g) * u
//
// Replaces no TPU kernel: the JAX package leaves this work to XLA, which
// fuses it (vaura_tpu/models/sampler.py: RMSNorm, apply_rotary_emb, the
// SwiGLU of FeedForward, quantize_kv). Eager PyTorch issued each as a chain
// of full-tensor passes, ~1,000 kernels and ~12 GB a decode step at 1,024
// rows (d 1536, 16 heads of 96, SwiGLU 4096, 24 layers).
//
// Bound on the H100: bytes, and at decode's sizes the launch itself. Each
// kernel reads its inputs once and writes its outputs once (a norm at 1,024
// x 1,536 bf16 moves 12.6 MB, 3.8 us at 3.35 TB/s; the RoPE kernel 22 MB;
// SwiGLU at 4,096 25 MB). A norm or RoPE row lives in one block's registers:
// the float32 sum of squares and the int8 scales' absolute maxima are
// reduced in registers and shared memory, so nothing is read twice.
//
// Arithmetic: every product and sum is rounded as the eager ops round them
// (__fmul_rn / __fadd_rn, so no FMA contraction), in their order, and cast
// to the element type where the eager chain casts:
//   RoPE: o0 = x0*c - x1*s, o1 = x1*c + x0*s in float32, cast to E;
//   quantization (ops/quantization.py::_symmetric on the cast values):
//     scale = max(amax * (1/127), 1e-8): PyTorch's CUDA division by a
//     host scalar multiplies by its float32 reciprocal; q = rint(x / scale)
//     (IEEE divide, half to even) clamped to +-127;
//   SwiGLU: s = E(x / (1 + expf(-x))), out = E(s * u) (F.silu, then the
//     product);
//   norm: h = E(x + a); r = rsqrtf(sum(h*h) * (1/D) + eps); n = E(h * r * w)
//     (mean is a sum times 1/D in PyTorch's CUDA reduction; rsqrtf as its
//     rsqrt).
// So RoPE, the int8 rows and SwiGLU equal the eager ops bit for bit; the
// norm's sum runs in another order (a warp tree, then the warps) and may
// land one ulp of E apart.
//
// Layouts (contiguous, row-major): x, a, h, n [rows, D]; qkv [B, (H + 2 Hkv)
// hd] -> q [B, H, hd], k, v [B, Hkv, hd]; cs, one RoPE row, [hd/2, 2]
// float32 (cos, sin); the int8 rows kq, vq [B, Hkv, hd] and their scales
// ks, vs [B, Hkv] are one layer's slabs of the step's [L, B, Hkv, ...]
// buffers; g, u, out [n].
#include "common.cuh"

constexpr int kMaxThreads = 1024;
constexpr float kInv127 = 1.0f / 127.0f;

template <typename E>
struct Num;
template <>
struct Num<float> {
  static __device__ __forceinline__ float f(float v) { return v; }
  static __device__ __forceinline__ float to(float v) { return v; }
};
template <>
struct Num<bf16> {
  static __device__ __forceinline__ float f(bf16 v) { return to_f(v); }
  static __device__ __forceinline__ bf16 to(float v) {
    return __float2bfloat16_rn(v);
  }
};

// V values of T moved as one access of sizeof(T) * V bytes (at most 16).
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> ldv(const T* p) {
  return *reinterpret_cast<const Vec<T, V>*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void stv(T* p, const Vec<T, V>& r) {
  *reinterpret_cast<Vec<T, V>*>(p) = r;
}

// The threads of a block that holds `units` vectors, PER a thread.
static int block_threads(int units, int per) {
  return ((units + per - 1) / per + 31) / 32 * 32;
}

// The fewest vectors a thread holds (1, 2, 4 or 8) for `units` in one
// block; 0 where a block cannot hold them.
static int vectors_per_thread(int units) {
  for (int per = 1; per <= 8; per *= 2)
    if (units <= per * kMaxThreads) return per;
  return 0;
}

// ---------------------------------------------------------------- norm --
// One block a row; a thread holds PER vectors of V values in registers.
template <typename E, int V, int PER>
__global__ void __launch_bounds__(kMaxThreads)
    add_rmsnorm_kernel(const E* __restrict__ x, const E* __restrict__ a,
                       const float* __restrict__ w, E* __restrict__ h,
                       E* __restrict__ n, int D, float eps, float inv_d) {
  __shared__ float part[kMaxThreads / 32];
  __shared__ float total;
  const long long base = (long long)blockIdx.x * D;
  const int nvec = D / V;
  Vec<E, V> hv[PER];
  float ss = 0.f;
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int i = threadIdx.x + p * blockDim.x;
    if (i >= nvec) continue;
    hv[p] = ldv<E, V>(x + base + i * V);
    if (a != nullptr) {
      const Vec<E, V> av = ldv<E, V>(a + base + i * V);
#pragma unroll
      for (int j = 0; j < V; ++j)
        hv[p].v[j] = Num<E>::to(
            __fadd_rn(Num<E>::f(hv[p].v[j]), Num<E>::f(av.v[j])));
      stv<E, V>(h + base + i * V, hv[p]);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float f = Num<E>::f(hv[p].v[j]);
      ss = __fadd_rn(ss, __fmul_rn(f, f));
    }
  }
  ss = warp_sum(ss);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < (int)(blockDim.x >> 5) ? part[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) total = t;
  }
  __syncthreads();
  const float r = rsqrtf(__fadd_rn(__fmul_rn(total, inv_d), eps));
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int i = threadIdx.x + p * blockDim.x;
    if (i >= nvec) continue;
    Vec<E, V> o;
#pragma unroll
    for (int j = 0; j < V; ++j)
      o.v[j] = Num<E>::to(
          __fmul_rn(__fmul_rn(Num<E>::f(hv[p].v[j]), r), w[i * V + j]));
    stv<E, V>(n + base + i * V, o);
  }
}

template <typename E, int V>
static cudaError_t launch_norm(const void* x, const void* a, const void* w,
                               void* h, void* n, long long rows, int D,
                               float eps, cudaStream_t st) {
  const int nvec = D / V;
  const int per = vectors_per_thread(nvec);
  if (per == 0 || rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int threads = block_threads(nvec, per);
  const float inv_d = 1.0f / (float)D;
  auto args = [&](auto kernel) {
    kernel<<<(unsigned)rows, threads, 0, st>>>(
        static_cast<const E*>(x), static_cast<const E*>(a),
        static_cast<const float*>(w), static_cast<E*>(h),
        static_cast<E*>(n), D, eps, inv_d);
  };
  switch (per) {
    case 1: args(add_rmsnorm_kernel<E, V, 1>); break;
    case 2: args(add_rmsnorm_kernel<E, V, 2>); break;
    case 4: args(add_rmsnorm_kernel<E, V, 4>); break;
    default: args(add_rmsnorm_kernel<E, V, 8>); break;
  }
  return cudaGetLastError();
}

// x, a (nullable: the no-residual form), h (unused without a), n [rows, D];
// w [D] float32 (the norm's weight, kept in float32 as RMSNorm keeps it).
// dtype: 0 float32, 1 bf16 (x, a, h, n). vec: 1 where every row starts
// 16-byte aligned (the caller checks the pointers and D).
extern "C" int vt_add_rmsnorm(const void* x, const void* a, const void* w,
                              void* h, void* n, long long rows, int D,
                              float eps, int dtype, int vec, void* stream) {
  if (rows <= 0 || D <= 0 || dtype < 0 || dtype > 1 ||
      (vec && D % (dtype == 0 ? 4 : 8) != 0))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vec ? launch_norm<float, 4>(x, a, w, h, n, rows, D, eps, st)
               : launch_norm<float, 1>(x, a, w, h, n, rows, D, eps, st);
  return vec ? launch_norm<bf16, 8>(x, a, w, h, n, rows, D, eps, st)
             : launch_norm<bf16, 1>(x, a, w, h, n, rows, D, eps, st);
}

// ---------------------------------------------------------------- rope --
// One block a batch row; a thread holds PER chunks of C values (C even,
// hd % C == 0, so a chunk lies in one head and holds whole pairs). With
// STORE the k and v chunks' absolute maxima meet in shared memory (as
// float bits, which order as unsigned integers for values >= 0), then each
// thread quantizes its chunks from registers.
template <typename E, int C, int PER, bool STORE>
__global__ void __launch_bounds__(kMaxThreads)
    rope_qkv_kernel(const E* __restrict__ qkv, const float* __restrict__ cs,
                    E* __restrict__ q, E* __restrict__ k, E* __restrict__ v,
                    int8_t* __restrict__ kq, int8_t* __restrict__ vq,
                    float* __restrict__ ks, float* __restrict__ vs, int H,
                    int Hkv, int hd) {
  extern __shared__ unsigned s_amax[];  // [2 Hkv]: k heads, then v heads
  const long long b = blockIdx.x;
  const int qn = H * hd, kn = Hkv * hd, N = qn + 2 * kn;
  const int nchunk = N / C;
  if (STORE) {
    for (int i = threadIdx.x; i < 2 * Hkv; i += blockDim.x) s_amax[i] = 0u;
    __syncthreads();
  }
  Vec<E, C> val[PER];
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int i = threadIdx.x + p * blockDim.x;
    if (i >= nchunk) continue;
    const int j = i * C;
    val[p] = ldv<E, C>(qkv + b * N + j);
    if (j < qn + kn) {
      const int pair = (j % hd) / 2;
#pragma unroll
      for (int t = 0; t < C / 2; ++t) {
        const float c = cs[2 * (pair + t)], s = cs[2 * (pair + t) + 1];
        const float x0 = Num<E>::f(val[p].v[2 * t]);
        const float x1 = Num<E>::f(val[p].v[2 * t + 1]);
        val[p].v[2 * t] =
            Num<E>::to(__fsub_rn(__fmul_rn(x0, c), __fmul_rn(x1, s)));
        val[p].v[2 * t + 1] =
            Num<E>::to(__fadd_rn(__fmul_rn(x1, c), __fmul_rn(x0, s)));
      }
    }
    E* dst = j < qn        ? q + b * qn + j
             : j < qn + kn ? k + b * kn + (j - qn)
                           : v + b * kn + (j - qn - kn);
    stv<E, C>(dst, val[p]);
    if (STORE && j >= qn) {
      float m = 0.f;
#pragma unroll
      for (int t = 0; t < C; ++t) m = fmaxf(m, fabsf(Num<E>::f(val[p].v[t])));
      atomicMax(&s_amax[(j - qn) / hd], __float_as_uint(m));
    }
  }
  if (!STORE) return;
  __syncthreads();
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int i = threadIdx.x + p * blockDim.x;
    const int j = i * C;
    if (i >= nchunk || j < qn) continue;
    const int g = (j - qn) / hd, within = (j - qn) % hd;
    const float scale =
        fmaxf(__fmul_rn(__uint_as_float(s_amax[g]), kInv127), 1e-8f);
    Vec<int8_t, C> o;
#pragma unroll
    for (int t = 0; t < C; ++t) {
      const float r = rintf(__fdiv_rn(Num<E>::f(val[p].v[t]), scale));
      o.v[t] = static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
    }
    const bool is_k = g < Hkv;
    const long long row = b * Hkv + (is_k ? g : g - Hkv);
    stv<int8_t, C>((is_k ? kq : vq) + row * hd + within, o);
    if (within == 0) (is_k ? ks : vs)[row] = scale;
  }
}

template <typename E, int C>
static cudaError_t launch_rope(const void* qkv, const void* cs, void* q,
                               void* k, void* v, void* kq, void* vq, void* ks,
                               void* vs, long long B, int H, int Hkv, int hd,
                               cudaStream_t st) {
  const int nchunk = (H + 2 * Hkv) * hd / C;
  const int per = vectors_per_thread(nchunk);
  if (per == 0 || B > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int threads = block_threads(nchunk, per);
  const bool store = kq != nullptr;
  const size_t smem = store ? 2 * Hkv * sizeof(unsigned) : 0;
  auto args = [&](auto kernel) {
    kernel<<<(unsigned)B, threads, smem, st>>>(
        static_cast<const E*>(qkv), static_cast<const float*>(cs),
        static_cast<E*>(q), static_cast<E*>(k), static_cast<E*>(v),
        static_cast<int8_t*>(kq), static_cast<int8_t*>(vq),
        static_cast<float*>(ks), static_cast<float*>(vs), H, Hkv, hd);
  };
  if (store) {
    switch (per) {
      case 1: args(rope_qkv_kernel<E, C, 1, true>); break;
      case 2: args(rope_qkv_kernel<E, C, 2, true>); break;
      case 4: args(rope_qkv_kernel<E, C, 4, true>); break;
      default: args(rope_qkv_kernel<E, C, 8, true>); break;
    }
  } else {
    switch (per) {
      case 1: args(rope_qkv_kernel<E, C, 1, false>); break;
      case 2: args(rope_qkv_kernel<E, C, 2, false>); break;
      case 4: args(rope_qkv_kernel<E, C, 4, false>); break;
      default: args(rope_qkv_kernel<E, C, 8, false>); break;
    }
  }
  return cudaGetLastError();
}

// qkv [B, (H + 2 Hkv) hd] -> q [B, H, hd], k, v [B, Hkv, hd]; cs [hd/2, 2]
// float32. kq, vq, ks, vs: this layer's int8 rows [B, Hkv, hd] and scales
// [B, Hkv], all four or none (nullptr: no store). dtype: 0 float32, 1 bf16.
// vec: 1 where hd is a multiple of a 16-byte vector and every row starts
// 16-byte aligned (the caller checks), else chunks of one pair.
extern "C" int vt_rope_qkv(const void* qkv, const void* cs, void* q, void* k,
                           void* v, void* kq, void* vq, void* ks, void* vs,
                           long long B, int H, int Hkv, int hd, int dtype,
                           int vec, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || hd <= 0 || hd % 2 != 0 || dtype < 0 ||
      dtype > 1 || (vec && hd % (dtype == 0 ? 4 : 8) != 0) ||
      (kq == nullptr) != (vq == nullptr) ||
      (kq == nullptr) != (ks == nullptr) || (kq == nullptr) != (vs == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vec ? launch_rope<float, 4>(qkv, cs, q, k, v, kq, vq, ks, vs, B, H,
                                       Hkv, hd, st)
               : launch_rope<float, 2>(qkv, cs, q, k, v, kq, vq, ks, vs, B, H,
                                       Hkv, hd, st);
  return vec ? launch_rope<bf16, 8>(qkv, cs, q, k, v, kq, vq, ks, vs, B, H,
                                    Hkv, hd, st)
             : launch_rope<bf16, 2>(qkv, cs, q, k, v, kq, vq, ks, vs, B, H,
                                    Hkv, hd, st);
}

// -------------------------------------------------------------- swiglu --
constexpr int kSwigluThreads = 256;

template <typename E, int V>
__global__ void __launch_bounds__(kSwigluThreads)
    swiglu_kernel(const E* __restrict__ g, const E* __restrict__ u,
                  E* __restrict__ out, long long nvec) {
  for (long long i = (long long)blockIdx.x * kSwigluThreads + threadIdx.x;
       i < nvec; i += (long long)gridDim.x * kSwigluThreads) {
    const Vec<E, V> gv = ldv<E, V>(g + i * V), uv = ldv<E, V>(u + i * V);
    Vec<E, V> o;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float x = Num<E>::f(gv.v[j]);
      const float s =
          Num<E>::f(Num<E>::to(__fdiv_rn(x, __fadd_rn(1.0f, expf(-x)))));
      o.v[j] = Num<E>::to(__fmul_rn(s, Num<E>::f(uv.v[j])));
    }
    stv<E, V>(out + i * V, o);
  }
}

template <typename E, int V>
static cudaError_t launch_swiglu(const void* g, const void* u, void* out,
                                 long long n, cudaStream_t st) {
  const long long nvec = n / V;
  long long blocks = (nvec + kSwigluThreads - 1) / kSwigluThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride past 16 a SM
  swiglu_kernel<E, V><<<(unsigned)blocks, kSwigluThreads, 0, st>>>(
      static_cast<const E*>(g), static_cast<const E*>(u),
      static_cast<E*>(out), nvec);
  return cudaGetLastError();
}

// g, u, out [n]. dtype: 0 float32, 1 bf16. vec: 1 where n is a multiple of
// a 16-byte vector and the three pointers are 16-byte aligned.
extern "C" int vt_swiglu(const void* g, const void* u, void* out, long long n,
                         int dtype, int vec, void* stream) {
  if (n <= 0 || dtype < 0 || dtype > 1 ||
      (vec && n % (dtype == 0 ? 4 : 8) != 0))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vec ? launch_swiglu<float, 4>(g, u, out, n, st)
               : launch_swiglu<float, 1>(g, u, out, n, st);
  return vec ? launch_swiglu<bf16, 8>(g, u, out, n, st)
             : launch_swiglu<bf16, 1>(g, u, out, n, st);
}

// Fused MLP sublayer of the MotionFormer encoder:
//   y = x + fc2(gelu_exact(fc1(layernorm(x))))
// x [M, D] bf16 (M = 12,544 token rows, D = 768, hidden Dh = 3,072 at the
// flagship shapes); LN and the GELU output are rounded to bf16, products,
// biases and the residual are float32, y is rounded once.
//
// Replaces the Pallas kernel vaura_tpu/ops/encoder_fused.py::
// fused_mlp_sublayer (kernel _mlp_kernel, :348; call :396).
//
// Bound on the H100: operations. The two products are 4*M*D*Dh = 118 GFLOP
// (0.120 ms at 989 TFLOP/s) against 2*M*D*2 = 38.5 MB of activations plus
// 9.4 MB of weights.
//
// Design: three launches, all from gemm.cuh.
//   (n) layer norm of every row, once, rounded to bf16 (normalising inside a
//       product costs the shared-memory pipe more than the launch does);
//   (1) hidden = gelu(x_ln @ W1^T + b1): the pipelined wgmma GEMM (128 x 192
//       tile a block, both operands by cp.async into a four-stage swizzled
//       ring) with bias and the exact erf GELU in its epilogue (the TPU
//       needed the Abramowitz-Stegun form, encoder_fused.py:331-345);
//   (2) y = x + hidden @ W2^T + b2: the same GEMM at K = Dh with bias and the
//       prefetched residual tile in its epilogue.
// The hidden activation does pass through device memory, which the TPU
// kernel avoided: 2 * M * Dh bytes written and read back (77 MB: 0.046 ms at
// 3.35 TB/s, beside products of 0.35 ms). It costs nothing that can be
// measured: on the NVIDIA H100 80GB HBM3 (700 W) fc2 of 4,224 rows takes
// 0.049 ms with its hidden rows in L2 and 0.049 ms with them in device
// memory (chip_smoke.py), and a form that walked the rows in such chunks, so
// that (2) read from L2 what (1) had just written, took 0.375 ms a call
// against 0.367 ms. What binds the GEMM at 128 x 192 tiles is the path from
// L2 to the SMs (40 KB a k-slab a block: 1.5 GB a call).
// Rows past M are masked by the GEMM.
//
// Earlier form (NVIDIA H100 80GB HBM3, 700 W: 2.308 ms a call, 51 TFLOP/s):
// one launch, 32 rows a block with the hidden slab kept in shared memory,
// every one of 392 blocks streaming all 9.4 MB of W1 and W2 as wmma
// fragments straight from device memory inside the product loops (3.7 GB of
// L2 traffic a call, nothing in flight), two block barriers per 64-wide
// hidden slab.
#include "common.cuh"
#include "gemm.cuh"

// x, y [M, D] bf16; w1 [Dh, D], w2 [D, Dh] (torch Linear layouts); ln_s,
// ln_b, b2 [D] and b1 [Dh] float32; D and Dh multiples of 64. Scratch: x_ln
// [M, D] and hidden [M, Dh] bf16. parts: bit 0 the layer norm, bit 1 fc1,
// bit 2 fc2 (7 for the sublayer; single bits to time one launch on scratch a
// full call has filled).
extern "C" int vt_encoder_mlp(const void* x, const void* ln_s, const void* ln_b,
                              const void* w1, const void* b1, const void* w2,
                              const void* b2, void* x_ln, void* hidden, void* y,
                              int M, int D, int Dh, float eps, int parts,
                              void* stream) {
  if (M <= 0 || D <= 0 || D % kSlabK != 0 || Dh <= 0 || Dh % kSlabK != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (parts & 1) err = launch_layernorm_rows(x, ln_s, ln_b, x_ln, M, D, eps, st);
  if (err == cudaSuccess && (parts & 2))
    err = launch_gemm_bias<kEpiGelu>(x_ln, w1, b1, nullptr, hidden, M, Dh, D, st);
  if (err == cudaSuccess && (parts & 4))
    err = launch_gemm_bias<kEpiResidual>(hidden, w2, b2, x, y, M, D, Dh, st);
  return err;
}

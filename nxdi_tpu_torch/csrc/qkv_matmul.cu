// The fused QKV projection: out (M, T) = x (M, H_in) @ w (H_in, T), f32
// accumulation, the input dtype out; the bias is added by the caller.
//
// Replaces nxdi_tpu/ops/kernels/fused_proj.py::qkv_matmul and
// ::qkv_matmul_stacked (Pallas bodies _matmul_kernel, _qkv_stacked_kernel):
// the stacked entry passes the (L, H_in, T) weight, the layer index and the
// per-layer stride, and the weight pointer is offset here — the torch
// counterpart of the TPU kernel's scalar-prefetched layer index.
//
// On this card the call is bound by the 12.6 MB weight at decode (M = 8:
// 3.8 us at 3.35 TB/s) and by its 6.5 GFLOP at a packed 520-row step (6.6 us
// at 989 TFLOP/s). The wrapper's plan (fused_proj.py::gemm_plan, which
// sets the grid for each M) picks the body: split-K weight streaming up to
// 64 rows, the K slices cut so that every SM gets a block, and the two-
// warpgroup wgmma body above; `ws` holds a split call's f32 partials. The
// bodies are in gemm_kernel.cuh.
#include "gemm_kernel.cuh"

extern "C" int nxdi_qkv_matmul(int dtype, const void* x, const void* w, void* out, int M, int N,
                               int K, int layer, long long layer_stride, int body, int bm,
                               int bn, int splits, int k_slice, void* ws, void* stream) {
  GemmArgs p{};
  p.a = x;
  p.b = gemm_layer(w, dtype, layer, layer_stride);
  p.c = out;
  p.M = M; p.N = N; p.K = K;
  const GemmPlan plan{body, bm, bn, splits, k_slice};
  return (int)gemm_launch<false, ACT_SILU>(dtype, plan, p, ws, static_cast<cudaStream_t>(stream));
}

// The fused QKV projection: out (M, T) = x (M, H_in) @ w (H_in, T), f32
// accumulation, the input dtype out; the bias is added by the caller.
//
// Replaces nxdi_tpu/ops/kernels/fused_proj.py::qkv_matmul and
// ::qkv_matmul_stacked (Pallas bodies _matmul_kernel, _qkv_stacked_kernel):
// the stacked entry passes the (L, H_in, T) weight, the layer index and the
// per-layer stride, and the weight pointer is offset here — the torch
// counterpart of the TPU kernel's scalar-prefetched layer index. The GEMM,
// its bound and its design are in gemm_kernel.cuh.
#include "gemm_kernel.cuh"

extern "C" int nxdi_qkv_matmul(int dtype, const void* x, const void* w, void* out, int M, int N,
                               int K, int layer, long long layer_stride, void* stream) {
  GemmArgs p{};
  p.a = x;
  p.b = gemm_layer(w, dtype, layer, layer_stride);
  p.c = out;
  p.M = M; p.N = N; p.K = K;
  return (int)gemm_launch<false, ACT_SILU>(dtype, p, static_cast<cudaStream_t>(stream));
}

// The fused gated MLP: out (M, H) = down(act(x @ gate) * (x @ up)).
//
// Replaces nxdi_tpu/ops/kernels/fused_proj.py::fused_mlp and
// ::fused_mlp_stacked (Pallas bodies _fused_mlp_kernel,
// _fused_mlp_stacked_kernel). The TPU kernel walks the intermediate dim I in
// order and keeps a (rows, H) f32 accumulator in VMEM across that walk; on
// this card one 64-row block's accumulator at H = 2048 is 512 KB, beyond the
// 227 KB of shared memory a block may have, and blocks cannot carry state
// across the grid. So one call is two kernels on the stream:
//  (a) the dual GEMM of gemm_kernel.cuh: each x tile is read once for both
//      gate and up; the epilogue computes act(g) * u in f32 and rounds it to
//      the input dtype — exactly the TPU kernel's rounding point — into the
//      (M, I) scratch `inter` the caller allocates;
//  (b) the plain GEMM (M, I) @ (I, H), f32 accumulation, input dtype out.
// At decode (M = 8) the round trip of `inter` is 128 KB beside 100 MB of
// weights; at 520 packed rows the 52 GFLOP bound the call either way. A
// split over I with partial sums would need an (n_I, M, H) f32 workspace
// (541 MB at M = 1032 with 128-wide I tiles) and is not taken.
// The stacked entry offsets the three weight pointers by the layer index.
// Activations (template modes): 0 silu, 1 gelu (erf), 2 gelu tanh, 3 relu.
#include "gemm_kernel.cuh"

namespace {

template <int ACT>
cudaError_t dual(int dtype, const GemmArgs& p, cudaStream_t s) {
  return gemm_launch<true, ACT>(dtype, p, s);
}

}  // namespace

extern "C" int nxdi_fused_mlp(int dtype, int act, const void* x, const void* gate,
                              const void* up, const void* down, void* inter, void* out, int M,
                              int H, int I, int layer, long long layer_stride, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GemmArgs g{};
  g.a = x;
  g.b = gemm_layer(up, dtype, layer, layer_stride);
  g.bg = gemm_layer(gate, dtype, layer, layer_stride);
  g.c = inter;
  g.M = M; g.N = I; g.K = H;
  cudaError_t err;
  switch (act) {
    case ACT_SILU: err = dual<ACT_SILU>(dtype, g, s); break;
    case ACT_GELU: err = dual<ACT_GELU>(dtype, g, s); break;
    case ACT_GELU_TANH: err = dual<ACT_GELU_TANH>(dtype, g, s); break;
    case ACT_RELU: err = dual<ACT_RELU>(dtype, g, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  GemmArgs d{};
  d.a = inter;
  d.b = gemm_layer(down, dtype, layer, layer_stride);
  d.c = out;
  d.M = M; d.N = H; d.K = I;
  return (int)gemm_launch<false, ACT_SILU>(dtype, d, s);
}

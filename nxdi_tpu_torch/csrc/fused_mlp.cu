// The fused gated MLP: out (M, H) = down(act(x @ gate) * (x @ up)).
//
// Replaces nxdi_tpu/ops/kernels/fused_proj.py::fused_mlp and
// ::fused_mlp_stacked (Pallas bodies _fused_mlp_kernel,
// _fused_mlp_stacked_kernel). The TPU kernel walks the intermediate dim I in
// order and keeps a (rows, H) f32 accumulator in VMEM across that walk; on
// this card one 128-row block's accumulator at H = 2048 is 1 MB, beyond the
// 227 KB of shared memory a block may have, and blocks cannot carry state
// across the grid. So one call is two GEMMs on the stream, each planned for
// M by the wrapper (fused_proj.py::gemm_plan):
//  (a) the dual GEMM of gemm_kernel.cuh: each x tile is read once for both
//      gate and up; its epilogue (or, when K is split, the reduction pass's)
//      computes act(g) * u in f32 and rounds it to the input dtype — exactly
//      the TPU kernel's rounding point — into the (M, I) scratch `inter` the
//      caller allocates;
//  (b) the plain GEMM (M, I) @ (I, H), f32 accumulation, input dtype out.
// Bound on this card: the 100 MB of weights at decode (M = 8: 30 us at 3.35
// TB/s), streamed by split-K blocks, at least one on every SM; the 52
// GFLOP at a packed 520-row step (53 us at 989 TFLOP/s), on the two-
// warpgroup wgmma body, the down product split in K to fill the waves (the
// grids are gemm_plan's for each M). The
// round trip of `inter` is 128 KB beside the weights at M = 8. The two GEMMs
// share one workspace `ws` (stream order keeps them apart).
// The stacked entry offsets the three weight pointers by the layer index.
// Activations (template modes): 0 silu, 1 gelu (erf), 2 gelu tanh, 3 relu.
#include "gemm_kernel.cuh"

namespace {

template <int ACT>
cudaError_t dual(int dtype, const GemmPlan& plan, const GemmArgs& p, void* ws, cudaStream_t s) {
  return gemm_launch<true, ACT>(dtype, plan, p, ws, s);
}

}  // namespace

extern "C" int nxdi_fused_mlp(int dtype, int act, const void* x, const void* gate,
                              const void* up, const void* down, void* inter, void* out, int M,
                              int H, int I, int layer, long long layer_stride, int gu_body,
                              int gu_bm, int gu_bn, int gu_splits, int gu_k_slice, int d_body,
                              int d_bm, int d_bn, int d_splits, int d_k_slice, void* ws,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GemmArgs g{};
  g.a = x;
  g.b = gemm_layer(up, dtype, layer, layer_stride);
  g.bg = gemm_layer(gate, dtype, layer, layer_stride);
  g.c = inter;
  g.M = M; g.N = I; g.K = H;
  const GemmPlan gp{gu_body, gu_bm, gu_bn, gu_splits, gu_k_slice};
  cudaError_t err;
  switch (act) {
    case ACT_SILU: err = dual<ACT_SILU>(dtype, gp, g, ws, s); break;
    case ACT_GELU: err = dual<ACT_GELU>(dtype, gp, g, ws, s); break;
    case ACT_GELU_TANH: err = dual<ACT_GELU_TANH>(dtype, gp, g, ws, s); break;
    case ACT_RELU: err = dual<ACT_RELU>(dtype, gp, g, ws, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  GemmArgs d{};
  d.a = inter;
  d.b = gemm_layer(down, dtype, layer, layer_stride);
  d.c = out;
  d.M = M; d.N = H; d.K = I;
  const GemmPlan dp{d_body, d_bm, d_bn, d_splits, d_k_slice};
  return (int)gemm_launch<false, ACT_SILU>(dtype, dp, d, ws, s);
}

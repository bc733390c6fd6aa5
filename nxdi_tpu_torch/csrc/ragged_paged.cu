// Ragged paged attention: one launch for the serving engine's packed stream
// of prefill chunks and decode tokens (batch 1), every token attending its
// own row's blocks through that row's table.
//
// Replaces nxdi_tpu/ops/kernels/ragged_paged_attention.py::
// ragged_paged_attention (Pallas body _ragged_kernel); the kernels, the
// per-tile row bitmask and their bound are in prefill_kernel.cuh (the
// ragged addressing mode of the prefill kernels).
#include "prefill_kernel.cuh"

extern "C" int nxdi_ragged_paged(int dtype, const void* q, const void* kc, const void* vc,
                                 void* out, const int* row_ids, const int* tok_pos, const int* bt,
                                 int H, int KV, int T, int R, int NB, int bs, int D,
                                 long long qsh, long long qss, long long osh, long long oss,
                                 float scale, float v_scale, void* stream) {
  if (bs <= 0) return (int)cudaErrorInvalidValue;
  PrefillArgs a{};
  a.q = q; a.k = kc; a.v = vc; a.out = out;
  a.row_ids = row_ids; a.tok_pos = tok_pos; a.bt = bt;
  a.H = H; a.KV = KV; a.Sq = T; a.Sk = NB * bs; a.D = D; a.nb = NB; a.bs = bs; a.R = R;
  // pool (total_slots, KV, D): a head's rows sit KV * D elements apart
  a.qsh = qsh; a.qss = qss;
  a.ksh = D; a.kss = (long long)KV * D;
  a.vsh = D; a.vss = (long long)KV * D;
  a.osh = osh; a.oss = oss;
  a.scale = scale; a.v_scale = v_scale;
  return run<KV_RAGGED>(dtype, a, 1, stream);
}

// Prefill attention through the block table of the paged pool: a chunk
// attends the cached prefix and itself (already scattered into the pool).
//
// Replaces nxdi_tpu/ops/kernels/flash_attention.py::paged_attention_prefill;
// the kernels and their design are in prefill_kernel.cuh.
#include "prefill_kernel.cuh"

extern "C" int nxdi_paged_prefill(int dtype, const void* q, const void* kc, const void* vc,
                                  void* out, const int* q_start, const int* bt, int B, int H,
                                  int KV, int Sq, int NB, int bs, int D, long long qsb,
                                  long long qsh, long long qss, long long osb, long long osh,
                                  long long oss, float scale, float v_scale, void* stream) {
  if (bs <= 0) return (int)cudaErrorInvalidValue;
  PrefillArgs a{};
  a.q = q; a.k = kc; a.v = vc; a.out = out; a.q_start = q_start; a.bt = bt;
  a.H = H; a.KV = KV; a.Sq = Sq; a.Sk = NB * bs; a.D = D; a.nb = NB; a.bs = bs;
  // pool (total_slots, KV, D): a head's rows sit KV * D elements apart
  a.qsb = qsb; a.qsh = qsh; a.qss = qss;
  a.ksb = 0; a.ksh = D; a.kss = (long long)KV * D;
  a.vsb = 0; a.vsh = D; a.vss = (long long)KV * D;
  a.osb = osb; a.osh = osh; a.oss = oss;
  a.scale = scale; a.v_scale = v_scale;
  return run<KV_PAGED>(dtype, a, B, stream);
}

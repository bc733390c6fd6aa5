// Causal flash attention for prefill over contiguous K/V.
//
// Replaces nxdi_tpu/ops/kernels/flash_attention.py::flash_attention_prefill;
// the kernels and their design are in prefill_kernel.cuh.
#include "prefill_kernel.cuh"

extern "C" int nxdi_flash_prefill(int dtype, const void* q, const void* k, const void* v,
                                  void* out, const int* q_start, const int* kv_start, int B,
                                  int H, int KV, int Sq, int Sk, int D, long long qsb,
                                  long long qsh, long long qss, long long ksb, long long ksh,
                                  long long kss, long long vsb, long long vsh, long long vss,
                                  long long osb, long long osh, long long oss, float scale,
                                  int window, int chunk, void* stream) {
  PrefillArgs a{};
  a.q = q; a.k = k; a.v = v; a.out = out; a.q_start = q_start; a.kv_start = kv_start;
  a.H = H; a.KV = KV; a.Sq = Sq; a.Sk = Sk; a.D = D;
  a.qsb = qsb; a.qsh = qsh; a.qss = qss; a.ksb = ksb; a.ksh = ksh; a.kss = kss;
  a.vsb = vsb; a.vsh = vsh; a.vss = vss; a.osb = osb; a.osh = osh; a.oss = oss;
  a.scale = scale; a.v_scale = 1.f; a.window = window; a.chunk = chunk;
  return run<KV_CONTIG>(dtype, a, B, stream);
}

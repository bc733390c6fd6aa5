// Causal flash attention for prefill over contiguous K/V.
//
// Replaces nxdi_tpu/ops/kernels/flash_attention.py::flash_attention_prefill.
// Three bodies; the wrapper (ops/kernels/flash_attention.py::prefill_body)
// picks one per call and passes its code: the TMA + wgmma body
// (prefill_wgmma.cuh; bf16, head dim 64 or 128: the model's prefill), the
// mma.sync body (bf16, other head dims that are multiples of 16) and the
// CUDA-core body (f32, or any other bf16 head dim) of prefill_kernel.cuh.
// Head dims up to 256 (Gemma's): the wgmma body serves 64 and 128, the
// mma.sync body the other multiples of 16 (at 256 it reads Q's fragments
// from shared memory), the CUDA-core body 8 output columns a lane above 128.
#include "prefill_wgmma.cuh"

extern "C" int nxdi_flash_prefill(int dtype, int body, const void* q, const void* k,
                                  const void* v, void* out, const int* q_start,
                                  const int* kv_start, int B, int H, int KV, int Sq, int Sk, int D,
                                  long long qsb, long long qsh, long long qss, long long ksb,
                                  long long ksh, long long kss, long long vsb, long long vsh,
                                  long long vss, long long osb, long long osh, long long oss,
                                  float scale, int window, int chunk, void* stream) {
  PrefillArgs a{};
  a.q = q; a.k = k; a.v = v; a.out = out; a.q_start = q_start; a.kv_start = kv_start;
  a.H = H; a.KV = KV; a.Sq = Sq; a.Sk = Sk; a.D = D;
  a.qsb = qsb; a.qsh = qsh; a.qss = qss; a.ksb = ksb; a.ksh = ksh; a.kss = kss;
  a.vsb = vsb; a.vsh = vsh; a.vss = vss; a.osb = osb; a.osh = osh; a.oss = oss;
  a.scale = scale; a.v_scale = 1.f; a.window = window; a.chunk = chunk;
  if (KV <= 0 || !prefill_args_ok(a, KV_CONTIG)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16 = dtype == NXDI_BF16;
  if (body == PREFILL_WGMMA && bf16 && (D == 64 || D == 128)) {
    if (Sq == 0 || B == 0) return (int)cudaSuccess;
    return (int)(D == 64 ? launch_wgmma<64>(a, B, s) : launch_wgmma<128>(a, B, s));
  }
  if (body == PREFILL_MMA && bf16 && D % 16 == 0) {
    if (Sq == 0 || B == 0) return (int)cudaSuccess;
    return (int)launch_tc_d<KV_CONTIG>(a, B, s);
  }
  if (body == PREFILL_SIMT && (bf16 || dtype == NXDI_F32)) {
    if (Sq == 0 || B == 0) return (int)cudaSuccess;
    return (int)(bf16 ? launch<__nv_bfloat16, KV_CONTIG>(a, B, s)
                      : launch<float, KV_CONTIG>(a, B, s));
  }
  return (int)cudaErrorInvalidValue;
}

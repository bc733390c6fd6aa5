// Prefill attention through the block table of the paged pool: a chunk
// attends the cached prefix and itself (already scattered into the pool).
//
// Replaces nxdi_tpu/ops/kernels/flash_attention.py::paged_attention_prefill.
// Three bodies; the wrapper (ops/kernels/flash_attention.py::
// paged_prefill_body) picks one per call and passes its code: the TMA +
// wgmma body's paged mode (prefill_wgmma.cuh; bf16 at head dim 64 or 128,
// block sizes 8-64 or multiples of 128: the engine's prefix prefill), the
// mma.sync body (other bf16 cases whose head dim is a multiple of 16) and
// the CUDA-core body (f32, or any other bf16 head dim) of prefill_kernel.cuh.
// A one-byte pool (kv_dtype, a store code other than q's) runs the mma.sync
// body for bf16 q and the CUDA-core body for f32, converting its K/V tiles
// as they land (prefill_kernel.cuh); the wrapper passes that body's code.
#include "prefill_wgmma.cuh"

// The one-byte stores' instantiations, in their own source so that nvcc
// compiles them beside this one (paged_prefill_1b.cu).
int paged_prefill_one_byte(int dtype, int kv_dtype, const PrefillArgs& a, int B, void* stream);

// body codes shared with the wrapper (flash_attention.py::PREFILL_BODIES)
enum PagedBody : int { PAGED_SIMT = 0, PAGED_MMA = 1, PAGED_WGMMA = 2 };

extern "C" int nxdi_paged_prefill(int dtype, int kv_dtype, int body, const void* q,
                                  const void* kc, const void* vc, void* out, const int* q_start,
                                  const int* bt, int B, int H, int KV, int Sq, int NB, int bs,
                                  int D, int total_slots, long long qsb, long long qsh,
                                  long long qss, long long osb, long long osh, long long oss,
                                  float scale, float v_scale, void* stream) {
  if (bs <= 0 || D % 8 != 0 || D > 128 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  PrefillArgs a{};
  a.q = q; a.k = kc; a.v = vc; a.out = out; a.q_start = q_start; a.bt = bt;
  a.H = H; a.KV = KV; a.Sq = Sq; a.Sk = NB * bs; a.D = D; a.nb = NB; a.bs = bs;
  // pool (total_slots, KV, D): a head's rows sit KV * D elements apart
  a.qsb = qsb; a.qsh = qsh; a.qss = qss;
  a.ksb = 0; a.ksh = D; a.kss = (long long)KV * D;
  a.vsb = 0; a.vsh = D; a.vss = (long long)KV * D;
  a.osb = osb; a.osh = osh; a.oss = oss;
  a.scale = scale; a.v_scale = v_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16 = dtype == NXDI_BF16;
  if (Sq == 0 || B == 0) return (int)cudaSuccess;
  if (kv_dtype != dtype) {
    if (body != (bf16 ? PAGED_MMA : PAGED_SIMT)) return (int)cudaErrorInvalidValue;
    return paged_prefill_one_byte(dtype, kv_dtype, a, B, stream);
  }
  if (body == PAGED_WGMMA && bf16 && (D == 64 || D == 128))
    return (int)(D == 64 ? launch_wgmma_paged<64>(a, B, total_slots, s)
                         : launch_wgmma_paged<128>(a, B, total_slots, s));
  if (body == PAGED_MMA && bf16 && D % 16 == 0)
    return (int)(D <= 64 ? launch_tc<64, KV_PAGED>(a, B, s) : launch_tc<128, KV_PAGED>(a, B, s));
  if (body == PAGED_SIMT && (bf16 || dtype == NXDI_F32))
    return (int)(bf16 ? launch<__nv_bfloat16, KV_PAGED>(a, B, s)
                      : launch<float, KV_PAGED>(a, B, s));
  return (int)cudaErrorInvalidValue;
}

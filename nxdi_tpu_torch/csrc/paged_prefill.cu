// Prefill attention through the block table of the paged pool: a chunk
// attends the cached prefix and itself (already scattered into the pool).
//
// Replaces nxdi_tpu/ops/kernels/flash_attention.py::paged_attention_prefill
// (Pallas body _paged_prefill_kernel, pl.pallas_call at :946). Bound:
// operations (a 512-token chunk after 512 cached: 0.0033 ms at the 989
// TFLOP/s bf16 peak). The wrapper (ops/kernels/flash_attention.py::
// paged_prefill_body) picks a body per call and passes its code:
//  - the TMA + wgmma body (prefill_wgmma.cuh; bf16 q at head dim 64 or 128,
//    block sizes 8-64 or multiples of 128: the engine's prefix prefill).
//    Over a bf16 pool its paged mode loads the K/V boxes straight into the
//    bf16 stages; over a one-byte pool (kv_dtype float8_e4m3fn,
//    float8_e5m2 or int8) its one-byte body loads the raw boxes by TMA at
//    half the bytes, converts them to bf16 in shared memory in warps that
//    would idle, and runs the same consumers (paged_prefill_1b.cu): q stays
//    bf16, as on the TPU, and wgmma multiplies bf16 only by bf16, so the
//    tensor cores need bf16 K/V in shared memory, not in device memory.
//    The conversion is exact, so the output equals the bf16 body's on the
//    up-cast pool bit for bit;
//  - the mma.sync body (other bf16 cases whose head dim is a multiple of
//    16, Gemma's 256 among them, over either pool; at 64 / 128 over a
//    one-byte pool only when its code is passed: the earlier design, tiles
//    loaded synchronously and converted as they land);
//  - the CUDA-core body (f32, or any other bf16 head dim) of
//    prefill_kernel.cuh, 8 output columns a lane above head dim 128.
// Head dims: multiples of 8 up to 256 (a one-byte pool: of 16).
#include "prefill_wgmma.cuh"

// The one-byte stores' instantiations, in their own source so that nvcc
// compiles them beside this one (paged_prefill_1b.cu).
int paged_prefill_one_byte(int dtype, int kv_dtype, int body, const PrefillArgs& a, int B,
                           int total_slots, void* stream);

extern "C" int nxdi_paged_prefill(int dtype, int kv_dtype, int body, const void* q,
                                  const void* kc, const void* vc, void* out, const int* q_start,
                                  const int* bt, int B, int H, int KV, int Sq, int NB, int bs,
                                  int D, int total_slots, long long qsb, long long qsh,
                                  long long qss, long long osb, long long osh, long long oss,
                                  float scale, float v_scale, void* stream) {
  if (bs <= 0 || D % 8 != 0 || D > 256 || KV <= 0 || H % KV != 0)
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
  if (kv_dtype != dtype) return paged_prefill_one_byte(dtype, kv_dtype, body, a, B, total_slots,
                                                       stream);
  if (body == PREFILL_WGMMA && bf16 && (D == 64 || D == 128))
    return (int)(D == 64 ? launch_wgmma_paged<64>(a, B, total_slots, s)
                         : launch_wgmma_paged<128>(a, B, total_slots, s));
  if (body == PREFILL_MMA && bf16 && D % 16 == 0) return (int)launch_tc_d<KV_PAGED>(a, B, s);
  if (body == PREFILL_SIMT && (bf16 || dtype == NXDI_F32))
    return (int)(bf16 ? launch<__nv_bfloat16, KV_PAGED>(a, B, s)
                      : launch<float, KV_PAGED>(a, B, s));
  return (int)cudaErrorInvalidValue;
}

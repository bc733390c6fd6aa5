// The paged prefill over one-byte KV stores (float8_e4m3fn, float8_e5m2,
// int8): the template instantiations that paged_prefill.cu's entry calls for
// such a pool, in a source of their own so that nvcc compiles them in
// parallel with it. bf16 q at head dim 64 or 128 runs the one-byte TMA +
// wgmma body (prefill_wgmma.cuh); the mma.sync body (bf16, its code passed)
// and the CUDA-core body (f32) convert their tiles as they land
// (prefill_kernel.cuh).
#include "prefill_wgmma.cuh"

int paged_prefill_one_byte(int dtype, int kv_dtype, int body, const PrefillArgs& a, int B,
                           int total_slots, void* stream) {
  if (body == PREFILL_WGMMA && dtype == NXDI_BF16)
    return run_wgmma_1b<KV_PAGED>(kv_dtype, a, B, 0, total_slots, stream);
  if (body != (dtype == NXDI_BF16 ? PREFILL_MMA : PREFILL_SIMT)) return (int)cudaErrorInvalidValue;
  return run_one_byte<KV_PAGED>(dtype, kv_dtype, a, B, stream);
}

// The paged prefill over one-byte KV stores (float8_e4m3fn, float8_e5m2,
// int8): the template instantiations that paged_prefill.cu's entry calls for
// such a pool, in a source of their own so that nvcc compiles them in
// parallel with it. See prefill_kernel.cuh.
#include "prefill_kernel.cuh"

int paged_prefill_one_byte(int dtype, int kv_dtype, const PrefillArgs& a, int B, void* stream) {
  return run_one_byte<KV_PAGED>(dtype, kv_dtype, a, B, stream);
}

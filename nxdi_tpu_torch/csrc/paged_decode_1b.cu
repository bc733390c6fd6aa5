// The paged decode over one-byte KV stores (float8_e4m3fn, float8_e5m2,
// int8): the template instantiations that paged_decode.cu's entry calls for
// such a pool, in a source of their own so that nvcc compiles them in
// parallel with it. See decode_kernel.cuh's kPaged mode.
#include "decode_kernel.cuh"

int paged_decode_one_byte(int dtype, int kv_dtype, const DecodeArgs& a, void* stream) {
  return dispatch_one_byte<Mode::kPaged>(dtype, kv_dtype, a, stream);
}

// Ragged paged attention's split items and combine over one-byte KV stores
// (float8_e4m3fn, float8_e5m2, int8): the instantiations ragged_paged_1b.cu
// calls, in a source of their own so that nvcc compiles them in parallel
// with it (with the head-dim-256 instantiations the two halves took 98 s as
// one source). With bf16 q the split kernel runs the decode kernel's
// tensor-core tile loop over raw tiles converted in shared memory
// (mma_tiles.cuh); with f32 q it converts each K row in registers and reads
// V from shared memory in the store type (ragged_split.cuh).
#include "ragged_split.cuh"

int ragged_split_one_byte(int dtype, int kv_dtype, const SplitArgs& sa, int n_items, int n_comb,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_one_byte_store(kv_dtype, [&](auto tag) -> int {
    using S = decltype(tag);
    if (dtype == NXDI_F32) return (int)run_split<float, S>(sa, n_items, n_comb, s);
    if (dtype == NXDI_BF16) return (int)run_split<__nv_bfloat16, S>(sa, n_items, n_comb, s);
    return (int)cudaErrorInvalidValue;
  });
}

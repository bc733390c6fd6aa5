// Ragged paged attention over one-byte KV stores (float8_e4m3fn,
// float8_e5m2, int8): the template instantiations that ragged_paged.cu's
// entry calls for such a pool, in a source of their own so that nvcc
// compiles them in parallel with it. The plan's wgmma items (bf16 q at
// head dim 64 or 128) run the one-byte TMA + wgmma body (prefill_wgmma.cuh:
// raw K/V boxes converted to bf16 in shared memory); direct tiles convert
// their K/V tiles as they land (prefill_kernel.cuh); the split kernel runs,
// with bf16 q, the decode kernel's tensor-core tile loop over raw tiles
// converted in shared memory (mma_tiles.cuh), and with f32 q converts each
// K row in registers and reads V from shared memory in the store type.
#include "prefill_wgmma.cuh"
#include "ragged_split.cuh"

int ragged_paged_one_byte(int dtype, int kv_dtype, const PrefillArgs& a, const SplitArgs& sa,
                          int n_items, int n_comb, int n_wg, int total_slots, void* stream) {
  if (a.D % 16 != 0) return (int)cudaErrorInvalidValue;
  if (n_wg > 0) {
    if (dtype != NXDI_BF16) return (int)cudaErrorInvalidValue;
    const int err = run_wgmma_1b<KV_RAGGED>(kv_dtype, a, 1, n_wg, total_slots, stream);
    if (err != 0) return err;
  }
  if (a.n_tiles > 0) {
    const int err = run_one_byte<KV_RAGGED>(dtype, kv_dtype, a, 1, stream);
    if (err != 0) return err;
  }
  if (n_items == 0 && n_comb == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_one_byte_store(kv_dtype, [&](auto tag) -> int {
    using S = decltype(tag);
    if (dtype == NXDI_F32) return (int)run_split<float, S>(sa, n_items, n_comb, s);
    if (dtype == NXDI_BF16) return (int)run_split<__nv_bfloat16, S>(sa, n_items, n_comb, s);
    return (int)cudaErrorInvalidValue;
  });
}

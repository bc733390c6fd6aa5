// Ragged paged attention over one-byte KV stores (float8_e4m3fn,
// float8_e5m2, int8): the template instantiations that ragged_paged.cu's
// entry calls for such a pool, in a source of their own so that nvcc
// compiles them in parallel with it. The plan's wgmma items (bf16 q at
// head dim 64 or 128) run the one-byte TMA + wgmma body (prefill_wgmma.cuh:
// raw K/V boxes converted to bf16 in shared memory); direct tiles convert
// their K/V tiles as they land (prefill_kernel.cuh); the split items and
// the combine are ragged_split_1b.cu's.
#include "prefill_wgmma.cuh"
#include "ragged_split.cuh"

// The split items and the combine over a one-byte store, in a source of
// their own (ragged_split_1b.cu) so that nvcc compiles them beside these
// instantiations.
int ragged_split_one_byte(int dtype, int kv_dtype, const SplitArgs& sa, int n_items, int n_comb,
                          void* stream);

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
  return ragged_split_one_byte(dtype, kv_dtype, sa, n_items, n_comb, stream);
}

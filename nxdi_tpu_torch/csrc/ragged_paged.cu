// Ragged paged attention: the serving engine's packed stream of prefill
// chunks and decode tokens (batch 1), every token attending its own row's
// blocks through that row's table, in up to three launches that one call
// makes on the wrapper's stream.
//
// Replaces nxdi_tpu/ops/kernels/ragged_paged_attention.py::
// ragged_paged_attention (Pallas body _ragged_kernel, pl.pallas_call at
// :199). Same function: token t of row row_ids[t] at position tok_pos[t]
// attends that row's logical positions up to its own, holes (negative table
// entries) skipped; k_scale arrives folded into `scale`, v_scale multiplies
// the output; padding tokens (row -1) and tokens with no visible key output
// exactly 0. The pool may hold a one-byte store (float8_e4m3fn, float8_e5m2
// or int8, the JAX kernel's quantized KV): with bf16 q at head dim 64 or
// 128 the plan's wgmma items (below) run the one-byte TMA + wgmma body of
// prefill_wgmma.cuh (raw K/V boxes by TMA, converted to bf16 in shared
// memory); otherwise the direct tiles convert their K/V tiles as they land
// (prefill_kernel.cuh). With bf16 q the split kernel runs the decode
// kernel's tensor-core tile loop over raw one-byte tiles streamed by
// cp.async and converted in shared memory (mma_tiles.cuh), so it equals the
// bf16 pool's split kernel on the pool up-cast to bf16, bit for bit; with
// f32 q it converts each K row in registers and reads its V tile from
// shared memory in the store type. All exact, so the only rounding is the
// store's own.
//
// Bound: bytes. A decode-only step reads each row's K/V once (bucket 8 at
// positions 230...1000: ~10 MB per layer in bf16, 3 us at 3.35 TB/s) and
// does little arithmetic per byte. The engine packs a step's decode tokens
// into one 64-token tile; a block per (tile, q head) walking the tile's rows
// in series would leave most SMs idle and read each row's K/V G times.
//
// Design: a work list built on the host (ops/kernels/ragged_paged_
// attention.py::ragged_plan, once per mixed dispatch) splits the stream:
//  - direct tiles: a 64-token tile holding the tokens of one row only (a
//    prefill chunk) runs the tensor-core body of prefill_kernel.cuh as
//    before (f32: its CUDA-core body) and writes its output directly;
//  - wgmma items (in place of the direct tiles, over a one-byte pool with
//    bf16 q at head dim 64 or 128): up to 128 consecutive tokens of one row
//    at consecutive positions (two adjacent direct tiles of a prefill
//    chunk) are one 128-row q tile of the persistent one-byte wgmma body,
//    Q read by TMA from the stream at the item's first token, the output
//    written for the item's own tokens; the persistent blocks walk items x
//    q heads up to the count in the list's header;
//  - items: every other token (a decode token, a chunk's last tokens beside
//    decode rows) is cut into kv chunks of its context, sized so a launch
//    has at least two blocks per SM. ragged_split_kernel runs one block per
//    (item, kv head): it serves all G q heads of the kv head, so each K/V
//    row is read once (as decode_kernel.cuh's paged mode shares it): with
//    bf16 q at head dims that are multiples of 16 on the decode kernel's
//    tensor-core tile loop (mma_tiles.cuh), otherwise on the CUDA cores
//    (ragged_split.cuh). A token
//    whose context is one chunk writes its output directly; otherwise each
//    item writes f32 partials (m, l, acc) to scratch the wrapper allocates;
//  - ragged_combine_kernel merges each such token's chunks in chunk order
//    (no atomics: a second call gives the same bits), applies v_scale and
//    rounds to q's dtype; it also writes the zeros of padding tokens and of
//    tokens with no visible key outside the direct tiles.
// The JAX function is one launch; this is a split launch plus a combine.
//
// The kernels read the list's counts from its header on the device, so the
// launch sizes need not be the list's: a block past the direct tiles exits,
// and the split and combine blocks walk their lists with a stride of the
// grid. The wrapper sizes each launch either from the host counts (one block
// per entry) or from the bucket's shapes alone (ragged_paged_attention.py::
// ragged_capacity), which is what a CUDA graph of the mixed step holds: the
// same graph then serves every step of the bucket, whatever its plan.
#include "ragged_split.cuh"

// The one-byte stores' instantiations, in their own source so that nvcc
// compiles them beside this one (ragged_paged_1b.cu).
int ragged_paged_one_byte(int dtype, int kv_dtype, const PrefillArgs& a, const SplitArgs& sa,
                          int n_items, int n_comb, int n_wg, int total_slots, void* stream);

// `plan`: the device copy of ragged_plan's int32 work list — a header of
// kPlanHeader ints, the direct tiles, the wgmma items, the split items, then
// the tokens to combine; the kernels read its counts there. n_direct,
// n_items and n_comb are the three launches' grids (at least 1 where the
// list may hold any: a block past its list exits, and the split and combine
// blocks stride over theirs); n_wg sizes the wgmma body's persistent launch
// (0: the list holds no wgmma items); n_slots is the scratch's size in
// partial slots, at least the list's. `split`: the plan is ragged_plan's
// split one (each direct tile holds one row), so R is not bounded. `ws`:
// n_slots x H x (D + 2) floats of scratch for the partials (acc, then m and
// l), null without slots. `kv_dtype`: the pool's store: q's dtype or a
// one-byte store code (head dims that are multiples of 16); head dims up to
// 256 (Gemma's: the direct tiles on the mma.sync or CUDA-core body at 8
// columns a lane, the split items at 2 warps a block, the combine over 256
// columns; no wgmma items there); total_slots:
// the pool layer's rows (the wgmma body's tensor maps).
extern "C" int nxdi_ragged_paged(int dtype, int kv_dtype, const void* q, const void* kc,
                                 const void* vc, void* out, const int* row_ids,
                                 const int* tok_pos, const int* bt, const int* plan, int n_direct,
                                 int n_items, int n_slots, int n_comb, int n_wg, int split,
                                 float* ws, int H, int KV, int T, int R, int NB, int bs, int D,
                                 int total_slots, long long qsh, long long qss, long long osh,
                                 long long oss, float scale, float v_scale, void* stream) {
  if (bs <= 0 || KV <= 0 || H % KV != 0 || D % 8 != 0 || D > 256 || (n_slots > 0 && !ws))
    return (int)cudaErrorInvalidValue;
  // the direct tiles and the wgmma items
  PrefillArgs a{};
  a.q = q; a.k = kc; a.v = vc; a.out = out;
  a.row_ids = row_ids; a.tok_pos = tok_pos; a.bt = bt; a.tiles = plan + kPlanHeader;
  a.n_tiles = n_direct;
  a.n_listed = plan + 1;
  a.plan = plan;
  a.one_row = split;
  a.H = H; a.KV = KV; a.Sq = T; a.Sk = NB * bs; a.D = D; a.nb = NB; a.bs = bs; a.R = R;
  // pool (total_slots, KV, D): a head's rows sit KV * D elements apart;
  // the stream is one batch row (qsb only frames Q's tensor map)
  a.qsb = (long long)T * qss; a.qsh = qsh; a.qss = qss;
  a.ksh = D; a.kss = (long long)KV * D;
  a.vsh = D; a.vss = (long long)KV * D;
  a.osh = osh; a.oss = oss;
  a.scale = scale; a.v_scale = v_scale;
  // the items and the tokens to combine
  SplitArgs sa{};
  sa.q = q; sa.kc = kc; sa.vc = vc; sa.out = out; sa.tok_pos = tok_pos; sa.bt = bt;
  sa.plan = plan;
  sa.acc = ws;
  sa.ml = ws ? ws + (long long)n_slots * H * D : nullptr;
  sa.H = H; sa.KV = KV; sa.D = D; sa.nb = NB; sa.bs = bs;
  sa.qsh = qsh; sa.qss = qss; sa.osh = osh; sa.oss = oss;
  sa.scale = scale; sa.v_scale = v_scale;
  if (kv_dtype != dtype)
    return ragged_paged_one_byte(dtype, kv_dtype, a, sa, n_items, n_comb, n_wg, total_slots,
                                 stream);
  if (n_wg > 0) return (int)cudaErrorInvalidValue;  // the wgmma items are a one-byte pool's
  if (a.n_tiles > 0) {
    const int err = run<KV_RAGGED>(dtype, a, 1, stream);
    if (err != 0) return err;
  }
  if (n_items == 0 && n_comb == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == NXDI_F32) return (int)run_split<float>(sa, n_items, n_comb, s);
  if (dtype == NXDI_BF16) return (int)run_split<__nv_bfloat16>(sa, n_items, n_comb, s);
  return (int)cudaErrorInvalidValue;
}

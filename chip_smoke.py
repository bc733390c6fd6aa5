#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``nxdi_tpu_torch``) on one H100.

    python3 chip_smoke.py

Phases, all of them on every run, in order; any failure raises, so the exit
code is non-zero:

1. Card: name and power limit (nvidia-smi), torch and CUDA versions.
2. Build: the hand-written CUDA kernels from ``nxdi_tpu_torch/csrc``.
3. Kernels against their plain PyTorch versions at the slice's shapes, in
   bfloat16 and float32, with kernel / plain / library times and the bound;
   the prefill by the kernel that ran (the TMA + wgmma body in bf16), beside
   the earlier mma.sync body, and at head dim 128; the fused decode split
   across blocks (21 flushed calls: median, min, max) beside the earlier
   design (one chunk a row, forced through ``flash_attention.decode_chunk``);
   the KV commit beside an empty kernel at its launch shape (the launch's
   floor). 3d: the key -> uniform function equal on the card and the CPU
   over 10**5 keys; the sampler at V 128256, B 8 beside greedy argmax; the
   fused decode with cache lines and the commit with lines, a frozen and a
   duplicate lane, each against its plain version and beside its call
   without lines.
3b. The paged-decode, paged-prefill and window-decode kernels the same way,
   at the serving engine's shapes (block 128, and block 16 for correctness):
   both decodes beside one chunk a row, the paged prefill by the kernel that
   ran (the TMA + wgmma body's paged mode in bf16) beside the mma.sync body
   (forced through ``flash_attention.paged_prefill_body``).
3c. The mixed step's kernels the same way: the fused QKV GEMM and the fused
   MLP over M = 2, 8, 64, 128, 520, 1032 (bf16 timed at each M over 21
   flushed calls: median, min, max, and the GEMM bodies each ran; the SM
   clock and power while the MLP at 520 rows runs back to back; f32 timed
   at 8 and 520; every call checked for the same bits on a second call),
   and ragged paged attention over 8 decode rows (bucket 8) and over a packed
   prefill chunk with 7 decode rows (bucket 1032; block 128: 21 flushed
   calls each, beside the earlier one-kernel design; block 16 with holes, a
   row that sees nothing and k/v scales), and a 96-row stream (more rows
   than the one-kernel design takes) against the plain version; at buckets
   8 and 1032 also the graph-ready launch (the plan padded to the bucket's
   capacity, sizes from shapes, counts read on the card): the same bits,
   timed beside per-call sizing.
4. The slice at full Llama-3.2-1B width, 2 layers, float32: greedy
   ``generate()`` on the CPU (plain versions) and on the card (kernels,
   every bucket a CUDA graph), every step's logits held against each
   other; the card again eagerly, its logits equal to the graphs' bit for
   bit.
4b. The paged serving engine at full width, 2 layers, float32, on the CPU
   and on the card: interleaved arrivals, a shared prefix, chunked prefill
   and a forced preemption; identical streams, every dispatch's logits
   within 1e-4, the window-decode kernel on the decode path; the card run
   through the graphs and again eagerly (same streams and counts, logits
   bit for bit).
4c. The same with mixed dispatch (one packed forward per step, fused QKV,
   the QKV, MLP and ragged kernels): identical streams, logits within 1e-4,
   a step that packs a prefill with decode rows, exact launch counts.
4d. The contiguous continuous-batching engine at full width, 2 layers,
   float32: 1-step, K-step and device-loop decode, greedy, identical
   streams on the CPU, the card's graphs and the card eagerly (EOS and
   length finishes, interleaved arrivals), 1-step logits within 1e-4,
   exact launch counts; sampled on the card: K-step windows = the chained
   1-step async loop, the K-step and loop engines = the 1-step engine
   under one key schedule, twice; the deterministic sampler's CPU and card
   streams.
5. The slice at full depth (16 layers), bfloat16, batch 8, 1024-token
   prompts, three ways in turns (eager sync, graph sync, graph async:
   ``async_mode``'s device-resident loop): identical tokens, launch counts
   checked exactly, prefill ms, decode ms/step, tok/s, a profiled decode
   step's busy/idle share and host split (runtime/host_spans.py), the
   prefill's device time by kind of kernel; warmup, capture time per
   submodel and the warmup's peak memory.
5b. The serving engine at full depth, bfloat16, 8 slots, 16 requests with a
   shared 384-token prefix, through the graphs and then eagerly: launch
   counts checked exactly against the engine's dispatch counts, tok/s,
   TTFT, TPOT, a profiled prefix-prefill step (it must run the TMA + wgmma
   body) and a profiled decode step, each with its host split.
5c. The same configuration and traffic with mixed dispatch: exact launch
   counts, tok/s, TTFT, TPOT, packed vs padded tokens per bucket and
   profiled steps (with the port's GEMM time by body), printed beside
   phase 5b's, graphs beside eager.
5d. The device-resident decode family at full depth (16 layers, bf16,
   batch 8): generate() with 8 decode steps per dispatch on phase 5's
   prompts, greedy (phase 5's tokens) and sampled (the sampled async loop's
   tokens), beside phase 5's graph async and the sampled async loop; the contiguous continuous-batching engine over phase 5b's request
   set, 1-step, K-step (ladder 2, 4, 8) and the device loop (fence 8):
   identical streams, exact launch counts, tok/s, TTFT, TPOT, dispatches,
   loop iterations per launch, a profiled decode step's busy/idle share and
   host split, capture seconds and warmup memory.
3e. The four kernels that read or write a one-byte KV store (the commit,
   the paged decode and prefill, the ragged kernels) over float8_e4m3fn,
   float8_e5m2 and int8 pools and rows, against their plain versions at
   phases 3, 3b and 3c's shapes (bf16 q; f32 q checked too); e4m3 timed
   beside the same call over a bf16 pool, with the bound recomputed for
   one-byte K/V. The paged prefill and the ragged kernel's one-row tiles
   run the one-byte TMA + wgmma body (asserted by profiled kernel name):
   the paged prefill's output equals the bf16 body's on the up-cast pool
   bit for bit on every store, and e4m3 is timed beside the earlier
   mma.sync design (its body code passed) too; the ragged packed stream's
   graph-ready launch replayed from a CUDA graph equals its eager call. The
   paged decode and the ragged split items run the raw one-byte ring on
   the decode kernel's tensor-core body (csrc/mma_tiles.cuh): the paged
   decode's output equals the bf16 pool's kernel on the up-cast pool bit
   for bit on every store, and the split kernel's tensor-core
   instantiation is asserted by profiled kernel name.
4f. Speculative decoding at full width, 2 layers, float32: the fused app
   (spec_len 2 and 4, a 2-layer draft from seed 1 and a perfect draft, the
   target's weights), the standard pair and Medusa chain and tree (3 random
   heads, the JAX package's test tree), each on the CPU, through the card's
   graphs and on the card eagerly: tokens equal the CPU's and the port's
   non-speculative greedy stream, every window's accepted counts equal the
   CPU's, graph runs equal eager ones (every cache tensor bit for bit), a
   perfect draft accepts whole fused windows, launch counts exact.
5f. Speculative decoding at full depth (16 layers, bf16, contiguous cache,
   graphs), phase 5's prompts at batch 8 and batch 1 (its first row), 32
   new tokens: the fused app and the standard pair at spec_len 4 with a
   perfect draft and a 2-layer draft, Medusa with 4 random heads, chain and
   tree: ms per window, mean accepted tokens per window, ms per accepted
   token beside phase 5's decode, launches of rows 1, 3 and 4 per window
   (exact), one window profiled (wall, busy, idle) and split into draft
   steps, verify, acceptance and host; streams equal to the
   non-speculative stream, any difference at a bf16 near tie.
4g. EAGLE at full width, 2 layers, float32, batch 2, phase 4f's prompts, a
   random 1-layer EAGLE draft (seed 1): the chain at spec_len 2 and 4,
   EAGLE3 at 4 (a 32000-token draft vocab, d2t from the seed), the static
   tree EAGLE_TREE and the dynamic tree (3 steps, K 2, M 2), each on the
   CPU, through the card's graphs and eagerly: tokens equal the CPU's and
   the non-speculative stream, window counts equal the CPU's, graph runs
   equal eager ones on every cache tensor and the features buffer bit for
   bit, launch counts exact.
5g. EAGLE at full depth beside 5f, in its loop (same prompts, references
   and witness): the chain and EAGLE3 at spec_len 4, the static tree
   MC_TREE and the dynamic tree of 4 steps (K 2, M 2, 14 nodes): as 5f
   measures them, each beside 5f's fused 2-layer-draft window; launches of
   rows 1, 3 and 4 exact; streams within 2 eps of the witness, and again
   in float32 at batch 8.
4e. Quantization at full width, 2 layers, float32: the split paged engine
   on an e4m3 per-tensor pool (CPU, card graphs, card eager: streams
   identical, logits within QUANT_LOGIT_TOL, replays equal to eager, exact
   launch counts, the paged-decode kernel on its decode path); the
   contiguous engine on an e4m3 cache (one-byte commits, the fused decode
   per layer over the dequantized window); generate() with
   int8 and fp8 weights
   (CPU vs card); the disaggregated pair (prefill-role and decode-role
   engines, e4m3 pools) equal to the unified card engine.
5e. At full depth, bf16: phase 5b's and 5c's traffic on an e4m3 per-tensor
   pool (half 5b's pool bytes); phase 5's decode with int8 and fp8 weights
   and with an e4m3 KV cache; the disaggregated pair over 5b's requests at
   bf16 and e4m3 beside the unified engine (tok/s, TTFT, TPOT, export and
   import ms, bytes per handoff); drive_arrivals and goodput_summary over a
   Poisson run (seed 17, its span rescaled to the nominal one) at half the
   unified engine's request rate.
3f. The MoE block alone (ops/moe.py) in bf16 at Mixtral-8x7B's and
   Qwen3-30B-A3B's widths, M 8 and 520: sparse dispatch (the grouped GEMM,
   torch._grouped_mm) beside dense dispatch, each against the float32
   dense dispatch, the sparse one replayed from a CUDA graph equal to eager,
   float32's per-expert product checked at M 8; times (11 flushed calls)
   beside the bound (the bytes of the experts the routing touches, or the
   routed pairs' FLOPs); what torch._grouped_mm takes by dtype.
4h. A Mixtral-shaped model (head dim 128, 4 query heads per kv head, 8
   experts top-2; hidden 1024) at 2 layers, float32, in sparse and dense
   dispatch: generate() at batch 2 and the split paged engine (the
   block-table decode) on the CPU, the card's graphs and the card eagerly:
   tokens equal, logits within 1e-4, graphs equal to eager bit for bit,
   launches of rows 1, 3, 4, 6 and 7 exact, every decode bucket's strategy
   naming its MoE product.
4i. LoRA at Llama-3.2-1B's widths, 2 layers, float32, batch 4: two rank-16
   adapters on all seven projections and a base row in one batch, CPU vs
   card graphs vs card eager; the adapter's rows equal a base model with
   the adapter merged into its weights; a third adapter registered after
   capture evicts the first in place, and the next replays read it (equal
   to eager and the CPU; no new graph; the buffers keep their addresses).
5h. Mixtral-8x7B's widths at 8 of its 32 layers (~24 GB of bf16 weights),
   graphs: generate() on phase 5's prompt shapes in sparse and dense
   dispatch in turns (prefill ms, decode ms/step, a profiled decode step
   and prefill, launches of rows 1, 3 and 4 exact), then the split paged
   engine over phase 5b's traffic (tok/s, TTFT, TPOT, rows 1, 6 and 7).
5i. LoRA at full depth: Llama-3.2-1B, 16 layers, batch 8, rank 16 on all
   seven projections, 4 adapters and base rows, graph sync, beside every
   row on the base slot (whose tokens must equal phase 5's) and phase 5's
   step: decode ms/step, busy and idle share, device operations a step.
3g. Multi-head Latent Attention's kernels: the commit at the latent widths
   (K 64, V 512, one kv head; the per-layer launch MLA makes, and a routed
   prefill write) bit for bit against its plain version in bf16 and f32,
   timed beside an empty launch and index_put; the fused MLP (stacked
   entry) at DeepSeek-V3's dense MLP (H 7168, I 18432) at M 8 and 8192
   against its plain version, timed over flushed calls beside three torch
   products and the bound.
4j. A DeepSeek-shaped model (V3's head widths, vocabulary and yarn rope;
   hidden 1024, 8 heads, 16 experts top-4 in groups, a shared expert, one
   dense layer before two MoE layers), float32: generate() at batch 2 with
   the fused MLP off and on, and the contiguous engine with it on, each on
   the CPU, the card's graphs and the card eagerly: tokens equal, logits
   within 1e-4, graphs equal to eager bit for bit, launches of rows 4 and
   9/10 exact.
5j. DeepSeek-V3's published widths with the depth cut to 4 layers (its 3
   dense layers and 1 MoE layer, ~30 GB of bf16 weights), graphs:
   generate() at batch 8 and 1 on phase 5's prompt shapes (prefill ms,
   decode ms/step, a profiled decode step, launches of rows 4 and 9/10
   exact), then the contiguous engine over phase 5b's traffic (tok/s,
   TTFT, TPOT).
3h. The dense families' kernel points: rows 1, 3 and 4 at head dim 256 at
   Gemma-2B's heads (8 over 1 kv head, B 8, S 1024), rows 1 and 3 under a
   live window of 4096 at Mistral-7B's heads over 6144-token rows (B 2),
   rows 9/10 with gelu_pytorch_tanh at Gemma-2B's MLP (H 2048, I 16384, M 8
   and 8192): each against its plain version, timed over flushed calls
   beside its bound, the plain version and one library call (SDPA, with the
   window's mask; index_put; three torch products).
4k. Every dense family the registry ports, at tiny widths (Qwen3's head dim
   48 decoupled, Gemma's 256, windows of 8 under 64-token prompts), 2
   layers, float32, batch 2: generate() on the CPU, the card's graphs and
   the card eagerly: tokens equal, logits within 1e-4, graphs equal to
   eager bit for bit, the attention, QKV and (gated MLPs) fused MLP kernels
   engaged with launches exact.
5k. At published widths, bf16, graphs: Mistral-7B whole (32 layers, window
   4096) through generate() at B 8 on phase 5's prompt shapes and at B 2
   over 6144-token prompts; Qwen3-8B at 8 of its 36 layers through
   generate() at B 8 and the split paged engine over phase 5b's traffic;
   Gemma-2B whole (head dim 256, the fused MLP's tanh GELU) at B 8: prefill
   ms, decode ms/step, a profiled decode step (busy, idle, host split),
   launches exact.
3j. The Gemma lineage's and the ring's kernel points: row 1 at Gemma-3-27B's
   heads (32 over 16 of 128, window 1024, B 8, S 1024); rows 3 and 5 in
   ring mode (the decode kernel's ring operand) over Gemma-3-27B's ring
   stack (10 layers of 1024 slots) and Mistral-7B's ring (4096 slots), rows
   past the wrap; row 4 landing rows at p % W: each against its plain
   version (row 4 bit for bit), timed beside its bound, the plain version
   and SDPA under the ring's mask or index_put.
4m. gemma3_text, gemma2, vaultgemma and the ring (Gemma-3 interleaved:
   the ring stack beside the full one; Mistral homogeneous) at tiny widths,
   2 layers, float32, batch 2, 64-token prompts over windows of 8: generate()
   on the CPU, the card's graphs and the card eagerly: tokens equal, logits
   within 1e-4, graphs equal to eager bit for bit, launches exact; on both
   rings the contiguous engine too (three requests over two slots).
5m. Gemma-3-27B's published widths cut to 12 of 62 layers (two pattern
   units), bf16, graphs, B 8, seq_len 8192, 1024-token prompts and 64 new
   tokens past the window: generate() on the full cache and on the ring
   (cache bytes, peak device memory, prefill ms, decode ms/step, a
   profiled decode step, launches exact), then on the full cache with the
   QKV and MLP kernels; Gemma-2-9B at 8 of 42 layers (the softcap keeps
   the attention plain; rows 4 and 9-12).
3k. Rows 1 and 3 in chunk mode at Llama-4-Scout's heads (40 over 8 of 128:
   G 5), bf16, under its 8192-token chunk: row 1 at B 2 x 9216 (also timed
   without the chunk), row 3 over a 9216-slot stack with both rows past the
   boundary: each against its plain version, timed beside its bound (the
   chunk's visible pairs or bytes), the plain version and SDPA under the
   chunk mask.
4n. llama4_text (G 5, chunks of 8, a NoPE layer, the L2 norm and the
   temperature), cohere2, exaone4 and olmo3 (windows of 8; the hybrids'
   global layer NoPE), and the three hybrids again on the ring, at tiny
   widths, 2 layers, float32, batch 2, 64-token prompts: generate() on the
   CPU, the card's graphs and the card eagerly: tokens equal, logits within
   1e-4, graphs equal to eager bit for bit, launches exact.
5n. Llama-4-Scout's published widths cut to 8 of 48 layers (two NoPE
   units, ~39 GB of bf16 weights), graphs: generate() at B 2 over
   9216-token prompts (the prefill and every step cross the chunk) and at
   B 8 x 1024; Command R7B whole (32 layers) at B 2 x 6144 on the full
   cache and on the ring: prefill ms, decode ms/step, a profiled decode
   step, cache bytes, peak memory, launches exact.
3l. The decode kernels' head tiles at multi-query groups above 16: rows 3,
   5 and 7 (and rows 1 and 6, which index the kv head per query head) at
   Falcon-7B's group (71 query heads of 64 on one kv head: five tiles) and
   StarCoder's (48 of 128: three), bf16, B 8: each against its plain
   version (the decodes also one chunk a row), timed beside its bound, the
   plain version and SDPA over the expanded or gathered cache; row 8 at
   both groups against its plain version in bf16 and f32.
4o. The last dense families (StarCoder2 under a window of 8, Falcon at
   Falcon-7B's attention widths, GPT-NeoX, Phi at head dim 80, GLM-4 at G
   16, StableLM, Persimmon, Apertus, Orion, OPT, BioGPT, XGLM, GPT-2 with
   its position table as long as seq_len, BigCode at StarCoder's attention
   widths) at 2 layers, float32, batch 2, 64-token prompts: generate() on
   the CPU, the card's graphs and the card eagerly: tokens equal, logits
   within 1e-4, graphs equal to eager bit for bit, launches exact.
5o. Falcon-7B whole (32 layers, G 71) through generate() at B 8 x 1024 and
   the split paged engine over phase 5b's traffic; StarCoder2-15B whole (40
   layers) at B 2 x 6144 past its 4096 window; bf16, graphs, the attention
   kernels on: prefill ms, decode ms/step, a profiled decode step, cache
   and peak GB, launches exact.
3m. The paged kernels at head dim 256, at Gemma-2B's heads (8 over 1 kv
   head): row 6 (bf16 on the mma.sync body, f32 on the CUDA cores), row 6'
   (the same over an e4m3 pool with per-tensor scales), row 7' (the paged
   decode over that pool; bf16 equal to the up-cast pool's bits), row 8
   (phase 3c's packed 1032-token stream and decode-only bucket 8 in bf16,
   the packed stream in f32) and row 8' (the packed stream over the e4m3
   pool); then row 8 at phase 3l's multi-query groups (G 71, G 48) timed:
   each against its plain version, timed over 21 flushed calls beside its
   bound, the plain version and gather + SDPA.
4p. Gemma at Gemma-2B's attention shape (hidden 256, 8 heads over 1 kv head
   of 256), 2 layers, float32: the split paged engine, the mixed engine and
   both on an e4m3 pool, each over phase 4b's traffic on the CPU, the
   card's graphs and the card eagerly (streams identical, logits within
   tolerance, launches exact); the LoRA app as phase 4i runs it (two
   rank-16 adapters and the base row, merged weights, a swap after
   capture).
5p. Gemma-2B whole (18 layers), bf16, graphs: the split paged engine and
   the mixed engine over phase 5b's traffic on a bf16 pool and an e4m3
   pool (tok/s, TTFT, TPOT, KV pool bytes, profiled steps, the strategies
   cte_paged_kernel / tkg_paged_kernel / mixed_ragged_kernel, launches
   exact), then generate() with rank-16 LoRA adapters in 4 slots at B 8
   (the base slot's tokens equal to the model without LoRA, the adapters
   moving their rows' logits, adapter 1 against its weights merged).
3n. Row 4 at the hybrids' stacks: MiMo-V2-Flash's full-attention stack
   (K 192 / V 128, 4 kv heads) and its window stack (3 layers, 8 kv heads),
   LFM2-1.2B's per-layer write (8 kv heads of 64); B 8, S 2048: decode rows
   and a routed prefill with a dropped row and line, bit for bit against
   the plain version in bf16 and f32; bf16 timed beside index_put and the
   bound. Rows 9/10 at MiMo-V2-Flash's dense MLP (H 4096, I 16384, SiLU)
   at M 8 and 8192: stacked equal to unstacked, against the plain version,
   timed beside three torch products and the bound.
4r. MiMo-V2 (a full dense layer, a window MoE layer, q / k 48 against v 32)
   and LFM2 (a conv and an attention layer) at 2 layers, float32: static
   generate(), continuous batching over shuffled cache lines, and for MiMo
   the window ring beside the full cache and standard speculation at
   spec_len 3, each on the CPU, the card's graphs and the card eagerly:
   tokens equal, logits within 1e-4, graphs equal to eager bit for bit,
   row 4 (and the fused MLP on MiMo's dense layer) launched exactly as
   counted.
5r. MiMo-V2-Flash's published widths cut to 4 layers (~42 GB of bf16
   weights) on the full cache (with the fused MLP, then the plain MLP) and
   with its window stack on a 128-slot ring; LFM2-1.2B whole through
   generate() and on 8 shuffled cache lines with staggered arrivals
   (app.forward(seq_ids=)); B 8 x 1024, 32 new
   tokens, graphs: prefill ms, decode ms/step, a profiled decode step (its
   GEMM, MoE and elementwise shares), KV cache and peak bytes, launches
   exact.
6. One JSON line per kernel summary, the card line, then the result line.

It imports nothing of JAX. Without a GPU, or without the repository beside
it, it prints no result and exits non-zero.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor / f32 non-tensor

# max |kernel - plain| allowed, by kernel and dtype: a few times the error
# measured on an H100 (bf16 prefill 3.9e-3, one output ulp near 0.5; bf16
# decode 2.4e-4; f32 prefill 1.1e-6, f32 decode 1.5e-7)
TOL = {
    ("prefill", "float32"): 1e-5,
    ("prefill", "bfloat16"): 8e-3,
    ("decode", "float32"): 1e-5,
    ("decode", "bfloat16"): 1e-3,
}
# phase 3c's GEMM sweep: rungs of the mixed engine's packed-token ladder
# (bucket 8 is the decode step; 1032 the packed prefill + decode step) and
# 520 (a 512-token chunk + 8 decode rows); bf16 timed at each M over
# GEMM_CALLS flushed calls, f32 checked at each M and timed at 8 and 520
GEMM_SWEEP_M = (2, 8, 64, 128, 520, 1032)
GEMM_CALLS = 21
GEMM_NAME = re.compile(r"gemm_[a-z_]+_kernel<[^>]*>")
# phase 3's prefill and phase 3c's ragged points: flushed calls timed
PREFILL_CALLS = 21
RAGGED_CALLS = 21
# the kernel each contiguous prefill body launches (flash_attention.prefill_body)
PREFILL_KERNEL = {"wgmma": "prefill_wgmma_kernel", "mma": "prefill_tc_kernel",
                  "simt": "prefill_kernel"}
# the attention kernels a profiled step's time is split into, by name
ATTN_NAME = re.compile(r"(prefill_wgmma_kernel|prefill_wgmma_1b_kernel|prefill_tc_kernel|"
                       r"prefill_kernel|"
                       r"ragged_split_kernel|ragged_combine_kernel|decode_split_kernel|"
                       r"decode_combine_kernel)<")
# the decode kernel split across blocks, and its combine
DECODE_KERNELS = ("decode_split_kernel", "decode_combine_kernel")
DECODE_CALLS = 21
# phases 3 and 3b: (dtype, head dim, layers of the stacked decode cache).
# Llama-3.2-1B's head dim 64 (phase 5's 16 layers) in both dtypes, and
# Mixtral-8x7B's 128 (phase 5h's 8 layers) in bf16, the dtype its main path
# runs; both have 32 query and 8 kv heads
KERNEL_CASES = (("bfloat16", 64, 16), ("float32", 64, 16), ("bfloat16", 128, 8))
LOGIT_TOL = 1e-4  # phases 4/4b/4c: float32 CPU vs card logits (measured 8.9e-6, 8.5e-6 and
# 1.9e-5), 2 layers, full width
# phase 4e on one-byte KV stores: the CPU's and the card's K/V differ in the
# last float bits before the store cast, and a value near a rounding
# boundary lands on the neighbouring code (an e4m3 step is 6-12 % of the
# value), which moves a 2-layer logit by far more than the float noise,
# more as a run's stored rows (and flips) accumulate: measured 4.6e-3 over
# phase 4b's traffic (1216 of 3.3M stored K codes apart) and 1.6e-2 over
# 4c's (NVIDIA H100 80GB HBM3, 700 W). This bound only catches a wrong
# kernel (errors of order 1); the kernels themselves agree with their plain
# versions to ~3e-7 in f32 on the same store (phase 3e), and the streams
# must still be identical
QUANT_LOGIT_TOL = 5e-2
# phase 3b (paged decode, paged prefill, window decode): a few times the
# error measured on an H100 (bf16 1.95e-3 for all three, one output ulp near
# 0.5; f32 2.2e-7 to 4.3e-7)
PAGED_TOL = {"float32": 2e-6, "bfloat16": 8e-3}
# phase 3c (QKV, fused MLP, ragged attention): a few times the error
# measured on an H100 (bf16 QKV and MLP 1.56e-2, one output ulp at 2-4;
# bf16 ragged 1.95e-3; f32 QKV 9.8e-6, f32 MLP 2.4e-5 over 8192-term sums,
# f32 ragged 6.3e-7)
NEW_TOL = {
    ("qkv", "float32"): 4e-5, ("qkv", "bfloat16"): 5e-2,
    ("mlp", "float32"): 1e-4, ("mlp", "bfloat16"): 5e-2,
    ("ragged", "float32"): 2e-6, ("ragged", "bfloat16"): 8e-3,
}


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """A line on stderr, after the seconds since the script started."""
    print(f"[{time.perf_counter() - _T0:6.1f} s] {msg}", file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=60, check=True,
    )
    return out.stdout.decode().strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------


def device_times(torch, fn, n=5, flush=None, kernel=None):
    """Device ms of ``n`` calls of ``fn()`` (after one untimed): the summed
    duration of the kernels each ran, from a ``torch.profiler`` trace, with
    the L2 cache evicted (untimed) before each; the names of the kernels
    counted; and how many calls were dropped. With ``kernel``, only kernels
    whose name contains it count (not a wrapper's small argument copies).
    On the card's machine a trace now and then comes back empty or short of
    kernels. Every call of these functions runs the same kernels, so a call
    whose trace holds fewer kernel launches than the fullest one is dropped
    and another made in its place, up to ``4 * n`` calls in all."""
    from torch.profiler import ProfilerActivity, profile

    if isinstance(kernel, str):
        kernel = (kernel,)
    fn()
    torch.cuda.synchronize()
    calls, names = [], set()  # (kernel launches traced, ms) of each call
    for _ in range(4 * n):
        if flush is not None:
            flush()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ks = [k for k in prof.key_averages()
              if kernel is None or any(n in k.key for n in kernel)]
        calls.append((sum(k.count for k in ks), sum(k.self_device_time_total for k in ks) / 1e3))
        names.update(k.key for k in ks)
        full = max(c for c, _ in calls)
        if full > 0 and sum(c == full for c, _ in calls) >= n:
            break
    full = max(c for c, _ in calls)
    if full == 0:
        raise RuntimeError("torch.profiler recorded no device time on this machine")
    times = [t for c, t in calls if c == full][:n]
    return times, names, len(calls) - len(times)


def traced_times(torch, fn, n, flush, kernel=None):
    """device_times, of which at least half the ``n`` calls wanted must be
    complete traces."""
    times, names, dropped = device_times(torch, fn, n, flush, kernel)
    assert 2 * len(times) >= n, f"only {len(times)} of {n + dropped} calls were traced in full"
    if dropped:
        log(f"[timing] {dropped} of {len(times) + dropped} profiled calls traced short; dropped")
    return times, names, dropped


def measure(torch, fn, n=5, flush=None, kernel=None):
    """Mean device ms of one ``fn()`` over the fully traced ones of ``n``
    calls (see device_times)."""
    times, _, _ = traced_times(torch, fn, n, flush, kernel)
    return sum(times) / len(times)


def spread(times):
    """(median, min, max) of per-call times."""
    t = sorted(times)
    mid = len(t) // 2
    return (t[mid] if len(t) % 2 else (t[mid - 1] + t[mid]) / 2), t[0], t[-1]


def gemm_bodies(names):
    """The port's GEMM kernels among profiler kernel names, shortened
    (``gemm_wgmma_kernel<false, 0>``)."""
    return sorted({m.group(0) for n in names for m in [GEMM_NAME.search(n)] if m})


def smi_under_load(torch, fn, seconds=1.0):
    """The card's SM clock (MHz) and power draw (W), sampled every 100 ms by
    nvidia-smi while ``fn`` runs back to back for ``seconds``: (median clock,
    median power, number of samples)."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
         "-lms", "100"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t = time.perf_counter()
        while time.perf_counter() - t < seconds:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out = proc.communicate(timeout=30)[0]
    samples = []
    for line in out.strip().splitlines():
        try:
            samples.append(tuple(float(v) for v in line.split(",")))
        except ValueError:
            continue
    if not samples:
        return None, None, 0
    return spread([c for c, _ in samples])[0], spread([w for _, w in samples])[0], len(samples)


def attention_ms(by_kernel):
    """Device ms of a profiled window's attention kernels, by kernel name."""
    out = {}
    for t, name in by_kernel:
        m = ATTN_NAME.search(name)
        if m:
            out[m.group(1)] = out.get(m.group(1), 0.0) + t
    return out


class forced:
    """Within the block, ``module.name`` is ``value`` (to time an earlier
    design on the same inputs: a prefill body, one decode chunk a row)."""

    def __init__(self, module, name, value):
        self.module, self.name, self.value = module, name, value

    def __enter__(self):
        self.saved = getattr(self.module, self.name)
        setattr(self.module, self.name, self.value)

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.saved)


def one_chunk(B, KV, kv_len, n_sm):
    """A decode split of one chunk a row: the earlier design, one block per
    (row, kv head) writing its output directly."""
    return 1 << 30


def decode_point(torch, results, name, dname, fa, call, plain, library, nbytes, flops, flush, tol):
    """One decode point (phases 3 and 3b): the split kernel and its combine
    against the plain version, the same bits on a second call, one chunk a
    row against the plain version too; then per-call device times over
    DECODE_CALLS flushed calls (median, min, max) of both designs and of the
    library call, and the plain version's mean."""
    got = call()
    want = plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert torch.equal(call(), got), f"{name} {dname}: a second call gave other bits"
    with forced(fa, "decode_chunk", one_chunk):
        err_one = (call().float() - want.float()).abs().max().item()
    assert max(err, err_one) <= tol, f"{name} {dname}: max abs err {err} / {err_one} > {tol}"
    times, names, dropped = traced_times(torch, call, DECODE_CALLS, flush, kernel=DECODE_KERNELS)
    ms, lo, hi = spread(times)
    with forced(fa, "decode_chunk", one_chunk):
        old, _, _ = traced_times(torch, call, DECODE_CALLS, flush, kernel=DECODE_KERNELS)
    lib_times, _, lib_dropped = traced_times(torch, library, DECODE_CALLS, flush)
    lib_ms, lib_lo, lib_hi = spread(lib_times)
    plain_ms = measure(torch, plain, flush=flush)
    bms, by = bound_ms(nbytes, flops, dname)
    kernels = sorted(attention_ms([(0.0, n) for n in names]))
    row = dict(kernel=name, dtype=dname, max_abs_err=max(err, err_one), tol=tol, ms=ms,
               ms_min=lo, ms_max=hi, plain_ms=plain_ms, library_ms=lib_ms, library_min=lib_lo,
               library_max=lib_hi, bound_ms=bms, bound_by=by, earlier_ms=spread(old)[0],
               earlier_min=min(old), earlier_max=max(old), calls=len(times),
               untraced=dropped + lib_dropped, kernels=kernels, share_of_bound=bms / ms)
    results.append(row)
    log(f"[kernels] {name} {dname} ({' + '.join(kernels)}): err {err:.3g} (one chunk a row "
        f"{err_one:.3g}) kernel {ms:.4f} ms (min {lo:.4f} max {hi:.4f}); one chunk a row "
        f"{row['earlier_ms']:.4f} ms (min {row['earlier_min']:.4f} max {row['earlier_max']:.4f}); "
        f"plain {plain_ms:.4f} library {lib_ms:.4f} (min {lib_lo:.4f} max {lib_hi:.4f}) bound "
        f"{bms:.4f} ({by}), {100 * bms / ms:.1f} % of the bound, {ms / lib_ms:.2f}x library")
    return row


def host_us(torch, fn, n=200):
    """Host microseconds of one ``fn()`` call (the enqueue: argument checks,
    tensor maps, the launch), over ``n`` calls between synchronisations."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    host = (time.perf_counter() - t) / n * 1e6
    torch.cuda.synchronize()
    return host


def bound_ms(nbytes, flops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain versions
# ---------------------------------------------------------------------------


def check_kernels(torch, results):
    import torch.nn.functional as F

    from nxdi_tpu_torch.ops.kernels import flash_attention as fa
    from nxdi_tpu_torch.ops.kernels import kv_commit as kc

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    scratch = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)

    def flush():
        scratch.zero_()

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    B, H, KV, S, S_cache = 8, 32, 8, 1024, 2048
    G = H // KV
    for dname, D, L in KERNEL_CASES:
        dt = getattr(torch, dname)
        es = torch.tensor([], dtype=dt).element_size()
        first = len(results)
        log(f"[kernels] phase 3 at head dim {D}, {L} layers, {dname}")

        # --- prefill ---
        q = randn((B, S, H, D), dt).transpose(1, 2)  # the model's head-split layout
        k = randn((B, S, KV, D), dt).transpose(1, 2)
        v = randn((B, S, KV, D), dt).transpose(1, 2)
        # the positions the model gives a right-padded batch: every row, pad
        # lanes included, runs 0..S-1 (the kernel reads only each row's start),
        # so every query row is computed and compared
        pos = torch.arange(S, device=dev, dtype=torch.int32)[None].expand(B, S).contiguous()
        got = fa.flash_attention_prefill(q, k, v, pos, pos)
        want = fa.flash_attention_prefill_plain(q, k, v, pos, pos)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = TOL[("prefill", dname)]
        assert err <= tol, f"prefill {dname}: max abs err {err} > {tol}"
        assert torch.equal(fa.flash_attention_prefill(q, k, v, pos, pos), got), \
            f"prefill {dname}: a second call gave other bits"
        body = fa.prefill_body(q, k, v)
        times, names, _ = traced_times(torch, lambda: fa.flash_attention_prefill(q, k, v, pos, pos),
                                       PREFILL_CALLS, flush, kernel="prefill")
        ms, lo, hi = spread(times)
        ran = sorted(attention_ms([(0.0, n) for n in names]))
        assert ran == [PREFILL_KERNEL[body]], f"prefill {dname}: ran {ran}, expected {body}"
        plain_ms = measure(torch, lambda: fa.flash_attention_prefill_plain(q, k, v, pos, pos),
                           n=3, flush=flush)
        ke, ve = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
        lib_times, _, _ = traced_times(torch, lambda: F.scaled_dot_product_attention(
            q, ke, ve, is_causal=True), PREFILL_CALLS, flush)
        lib_ms = spread(lib_times)[0]
        flops = 4 * B * H * D * (S * (S + 1) // 2)
        nbytes = (2 * B * H * S * D + 2 * B * KV * S * D) * es
        bms, by = bound_ms(nbytes, flops, dname)
        row = dict(kernel="prefill", dtype=dname, max_abs_err=err, tol=tol, ms=ms, ms_min=lo,
                   ms_max=hi, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by,
                   body=body, kernels=ran, share_of_bound=bms / ms)
        if dname == "bfloat16" and D == 64:
            # the mma.sync body (PR 1's) on the same inputs, and the host time
            # of one call of each body (the TMA body encodes three tensor maps)
            with forced(fa, "prefill_body", lambda *a: "mma"):
                prev, _, _ = traced_times(torch, lambda: fa.flash_attention_prefill(
                    q, k, v, pos, pos), PREFILL_CALLS, flush, kernel="prefill")
                host_mma = host_us(torch, lambda: fa.flash_attention_prefill(q, k, v, pos, pos))
            host_new = host_us(torch, lambda: fa.flash_attention_prefill(q, k, v, pos, pos))
            row.update(mma_sync_ms=spread(prev)[0], host_us=host_new, mma_sync_host_us=host_mma)
            log(f"[kernels] prefill bfloat16 mma.sync body (PR 1): {row['mma_sync_ms']:.4f} ms; "
                f"host per call: {body} {host_new:.1f} us, mma.sync {host_mma:.1f} us")
        results.append(row)
        log(f"[kernels] prefill {dname} ({ran[0]}): err {err:.3g} kernel {ms:.4f} ms (min {lo:.4f} "
            f"max {hi:.4f}) plain {plain_ms:.4f} sdpa {lib_ms:.4f} bound {bms:.4f} ({by}), "
            f"{100 * bms / ms:.1f} % of the bound")
        del q, k, v, ke, ve, got, want

        # ragged lengths (Sq, Sk not multiples of 128), window / chunk masks,
        # offset starts, head dims 64 and 128 (the TMA body in bf16) and 40
        # (not a multiple of 16): correctness only, once per dtype
        small = ((300, 64, 100, None), (300, 64, None, 128), (200, 40, None, None),
                 (300, 128, None, None), (260, 128, 100, None), (260, 128, None, 96))
        for (Sx, Dx, win, chk) in (small if D == 64 else ()):
            qx = randn((2, Sx, 8, Dx), dt).transpose(1, 2)
            kx = randn((2, Sx, 2, Dx), dt).transpose(1, 2)
            vx = randn((2, Sx, 2, Dx), dt).transpose(1, 2)
            px = torch.arange(Sx, device=dev, dtype=torch.int32)[None].expand(2, Sx) + torch.tensor(
                [[0], [37]], device=dev, dtype=torch.int32)
            got = fa.flash_attention_prefill(qx, kx, vx, px, px, sliding_window=win, chunk_size=chk)
            want = fa.flash_attention_prefill_plain(qx, kx, vx, px, px, sliding_window=win,
                                                    chunk_size=chk)
            torch.cuda.synchronize()
            errx = (got.float() - want.float()).abs().max().item()
            assert errx <= tol, f"prefill {dname} S={Sx} D={Dx} win={win} chunk={chk}: err {errx}"
            log(f"[kernels] prefill {dname} S={Sx} D={Dx} window={win} chunk={chk} "
                f"({fa.prefill_body(qx, kx, vx)}): err {errx:.3g}")

        # --- fused decode (stacked entry, layer 5 of 16; kv_len = TKG bucket) ---
        ks = randn((L, B, KV, S_cache, D), dt)
        vs = randn((L, B, KV, S_cache, D), dt)
        qd = randn((B, 1, H, D), dt).transpose(1, 2)
        kn = randn((B, 1, KV, D), dt).transpose(1, 2)
        vn = randn((B, 1, KV, D), dt).transpose(1, 2)
        qpos = torch.tensor([[1024 + 37 * b] for b in range(B)], device=dev, dtype=torch.int32)
        qpos[0, 0] = 0  # decode at position 0: only the fresh row is visible
        li, kv_len = 5, S_cache
        # a shorter kv_len through the unstacked entry (correctness)
        got_l = fa.flash_attention_decode_fused(
            qd, ks[li], vs[li], kn, vn, qpos,
            torch.arange(S_cache, device=dev)[None].expand(B, S_cache), kv_len=1536,
        )
        want_l = fa.flash_attention_decode_fused_plain(qd, ks[li], vs[li], kn, vn, qpos, kv_len=1536)
        torch.cuda.synchronize()
        tol = TOL[("decode", dname)]
        err_l = (got_l.float() - want_l.float()).abs().max().item()
        assert err_l <= tol, f"decode {dname} kv_len 1536: max abs err {err_l} > {tol}"
        # library yardstick: SDPA over [cache window | fresh row] with the
        # strict-causal mask, K/V concatenated and expanded beforehand
        kcat = torch.cat([ks[li], kn], dim=2).repeat_interleave(G, dim=1)
        vcat = torch.cat([vs[li], vn], dim=2).repeat_interleave(G, dim=1)
        slot = torch.arange(S_cache + 1, device=dev)
        mask = (slot[None, :] < qpos) | (slot[None, :] == S_cache)
        mask = mask[:, None, None, :]
        visible = int(torch.clamp(qpos[:, 0], max=kv_len).sum().item())
        decode_point(
            torch, results, "decode", dname, fa,
            lambda: fa.flash_attention_decode_fused_stacked(qd, ks, vs, kn, vn, qpos, li,
                                                            kv_len=kv_len),
            lambda: fa.flash_attention_decode_fused_plain(qd, ks[li], vs[li], kn, vn, qpos,
                                                          kv_len=kv_len),
            lambda: F.scaled_dot_product_attention(qd, kcat, vcat, attn_mask=mask),
            (2 * KV * D * (visible + B) + 2 * B * H * D) * es, 4 * H * D * (visible + B), flush,
            tol)
        del kcat, vcat

        # --- commit (one dropped slot) ---
        kr = randn((L, B, KV, 1, D), dt)
        vr = randn((L, B, KV, 1, D), dt)
        slots = qpos.clone()
        slots[3, 0] = -1
        k_ref, v_ref = ks.clone(), vs.clone()
        kc.kv_commit_rows_plain(k_ref, v_ref, kr, vr, slots)
        kc.kv_commit_rows(ks, vs, kr, vr, slots)
        torch.cuda.synchronize()
        assert torch.equal(ks, k_ref) and torch.equal(vs, v_ref), f"commit {dname}: not bit-exact"
        # the commit beside an empty kernel at its launch shape (L * B blocks
        # of 128 threads): the floor under any launch of that shape
        times, _, _ = traced_times(torch, lambda: kc.kv_commit_rows(ks, vs, kr, vr, slots),
                                   DECODE_CALLS, flush, kernel="kv_commit_kernel")
        ms, ms_lo, ms_hi = spread(times)
        floor_times, _, _ = traced_times(torch, lambda: kc.empty_launch(L * B, 128, dev),
                                         DECODE_CALLS, flush, kernel="empty_launch_kernel")
        floor_ms, floor_lo, floor_hi = spread(floor_times)
        plain_ms = measure(torch, lambda: kc.kv_commit_rows_plain(ks, vs, kr, vr, slots), flush=flush)
        valid = (slots[:, 0] >= 0).nonzero()[:, 0]
        sl = slots[valid, 0].long()
        zero = torch.zeros_like(valid)

        def library_commit():
            ks[:, valid, :, sl] = kr[:, valid, :, zero]
            vs[:, valid, :, sl] = vr[:, valid, :, zero]

        lib_ms = measure(torch, library_commit, flush=flush)
        nbytes = 2 * 2 * L * int(valid.numel()) * KV * D * es  # rows read + written, k and v
        bms, by = bound_ms(nbytes, 0, dname)
        results.append(dict(kernel="commit", dtype=dname, max_abs_err=0.0, tol=0.0, ms=ms,
                            ms_min=ms_lo, ms_max=ms_hi, launch_floor_ms=floor_ms,
                            launch_floor_min=floor_lo, launch_floor_max=floor_hi,
                            plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by))
        log(f"[kernels] commit {dname}: exact; kernel {ms:.4f} ms ({ms_lo:.4f}-{ms_hi:.4f}); "
            f"empty kernel at its launch shape {floor_ms:.4f} ms ({floor_lo:.4f}-{floor_hi:.4f}); "
            f"plain {plain_ms:.4f} index_put {lib_ms:.4f} bound {bms:.5f} ({by})")
        del ks, vs, k_ref, v_ref
        torch.cuda.empty_cache()
        for row in results[first:]:
            row["head_dim"] = D


# ---------------------------------------------------------------------------
# phase 3b: the serving engine's kernels vs plain versions
# ---------------------------------------------------------------------------


def _kernel_row(results, name, dname, err, ms, plain_ms, lib_ms, nbytes, flops):
    bms, by = bound_ms(nbytes, flops, dname)
    tol = PAGED_TOL[dname]
    assert err <= tol, f"{name} {dname}: max abs err {err} > {tol}"
    results.append(dict(kernel=name, dtype=dname, max_abs_err=err, tol=tol, ms=ms,
                        plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by))
    log(f"[kernels] {name} {dname}: err {err:.3g} kernel {ms:.4f} ms plain {plain_ms:.4f} "
        f"library {lib_ms:.4f} bound {bms:.4f} ({by})")


def check_paged_kernels(torch, results):
    """Paged decode at B=8, H=32, KV=8, D=64 and 128 (KERNEL_CASES), block
    128, 136 blocks, table width 16, q_pos spread over 0..2000 with a hole;
    paged prefill at B=1, Sq=512 from 512 (timed) and from a 384-token
    prefix; window decode at B=8, Sk=2048, D=64. The library yardstick is SDPA over K/V gathered through
    the table (the gather included) or over the GQA-expanded window."""
    import torch.nn.functional as F

    from nxdi_tpu_torch.ops.kernels import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4321)
    scratch = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)

    def flush():
        scratch.zero_()

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    B, H, KV, bs, nblk, NB, Sk = 8, 32, 8, 128, 136, 16, 2048
    G = H // KV
    qpos = torch.linspace(0, 2000, B, device=dev).long()
    perm = torch.randperm(nblk, generator=torch.Generator().manual_seed(0)).tolist()
    bt = torch.full((B, NB), -1, dtype=torch.int32)
    nxt = 0
    for b in range(B):
        n = int(qpos[b]) // bs + 1
        bt[b, :n] = torch.tensor(perm[nxt:nxt + n], dtype=torch.int32)
        nxt += n
    bt[3, 2] = -1  # a hole inside row 3's attended range
    bt = bt.to(dev)
    # the same pool seen as 16-slot blocks: block j of 128 is blocks 8j..8j+7
    sub = bs // 16
    bt16 = torch.where(bt[:, :, None] >= 0, bt[:, :, None] * sub + torch.arange(sub, device=dev),
                       -1).reshape(B, -1).to(torch.int32)
    slot_pos = torch.arange(NB * bs, device=dev)
    live = torch.repeat_interleave(bt >= 0, bs, dim=1) & (slot_pos[None] <= qpos[:, None])
    visible = int(live.sum())

    def gathered(cache, table, n_rows):
        rows = (table.long()[:, :, None] * bs + torch.arange(bs, device=dev)).reshape(n_rows, -1)
        return cache[rows.clamp(min=0)].transpose(1, 2)  # (n, KV, W, D)

    for dname, D, _ in KERNEL_CASES:
        dt = getattr(torch, dname)
        es = torch.tensor([], dtype=dt).element_size()
        first = len(results)
        log(f"[kernels] phase 3b at head dim {D}, {dname}")
        kc, vc = randn((nblk * bs, KV, D), dt), randn((nblk * bs, KV, D), dt)

        # --- paged decode (and at block 16 with k/v scales: correctness) ---
        q = randn((B, 1, H, D), dt).transpose(1, 2)
        qp = qpos[:, None].to(torch.int32)
        got16 = fa.paged_attention_decode(q, kc, vc, bt16, qp, block_size=16, k_scale=0.5,
                                          v_scale=2.0)
        want16 = fa.paged_attention_decode_plain(q, kc, vc, bt16, qp, block_size=16,
                                                 k_scale=0.5, v_scale=2.0)
        torch.cuda.synchronize()
        err16 = (got16.float() - want16.float()).abs().max().item()
        assert err16 <= PAGED_TOL[dname], f"paged_decode {dname} block 16: err {err16}"
        mask = live[:, None, None, :]

        def library_decode():
            kg = gathered(kc, bt, B).repeat_interleave(G, dim=1)
            vg = gathered(vc, bt, B).repeat_interleave(G, dim=1)
            return F.scaled_dot_product_attention(q, kg, vg, attn_mask=mask)

        decode_point(
            torch, results, "paged_decode", dname, fa,
            lambda: fa.paged_attention_decode(q, kc, vc, bt, qp, block_size=bs),
            lambda: fa.paged_attention_decode_plain(q, kc, vc, bt, qp, block_size=bs),
            library_decode, (2 * visible * KV * D + 2 * B * H * D) * es + bt.numel() * 4,
            4 * H * D * visible, flush, PAGED_TOL[dname])

        # --- window decode over the gathered window's layout (head dim 64:
        # Mixtral's paths do not run it) ---
        if D == 64:
            kw = randn((B, Sk, KV, D), dt).transpose(1, 2)
            vw = randn((B, Sk, KV, D), dt).transpose(1, 2)
            kv_pos = torch.arange(Sk, device=dev, dtype=torch.int32)[None].expand(B, Sk)
            wmask = (kv_pos <= qp)[:, None, None, :]
            kwe, vwe = kw.repeat_interleave(G, dim=1), vw.repeat_interleave(G, dim=1)
            seen = int((kv_pos <= qp).sum())
            decode_point(
                torch, results, "window_decode", dname, fa,
                lambda: fa.flash_attention_decode(q, kw, vw, qp, kv_pos),
                lambda: fa.flash_attention_decode_plain(q, kw, vw, qp, kv_pos),
                lambda: F.scaled_dot_product_attention(q, kwe, vwe, attn_mask=wmask),
                (2 * seen * KV * D + 2 * B * H * D) * es, 4 * H * D * seen, flush,
                PAGED_TOL[dname])
            del kw, vw, kwe, vwe

        # --- paged prefill: a 512-token chunk after 512 (timed) or 384 cached;
        # at block 16 with a hole and k/v scales (correctness) ---
        Sq = 512
        bt1 = bt[7:8]  # 16 live blocks: positions 0..2047
        qx = randn((1, Sq, H, D), dt).transpose(1, 2)
        body = fa.paged_prefill_body(qx, kc, vc, bs)
        assert body == ("wgmma" if dname == "bfloat16" else "simt"), body
        err = 0.0
        for start in (384, 512):
            qpx = (start + torch.arange(Sq, device=dev, dtype=torch.int32))[None]
            got = fa.paged_attention_prefill(qx, kc, vc, bt1, qpx, block_size=bs)
            want = fa.paged_attention_prefill_plain(qx, kc, vc, bt1, qpx, block_size=bs)
            torch.cuda.synchronize()
            err = max(err, (got.float() - want.float()).abs().max().item())
        bt16h = bt16[7:8].clone()
        bt16h[0, 5] = -1  # a hole inside the prefix
        got16 = fa.paged_attention_prefill(qx, kc, vc, bt16h, qpx, block_size=16, k_scale=0.5,
                                           v_scale=2.0)
        want16 = fa.paged_attention_prefill_plain(qx, kc, vc, bt16h, qpx, block_size=16,
                                                  k_scale=0.5, v_scale=2.0)
        torch.cuda.synchronize()
        err16 = (got16.float() - want16.float()).abs().max().item()
        # v_scale 2 doubles the outputs: twice the tolerance for the rounding
        assert err16 <= 2 * PAGED_TOL[dname], f"paged_prefill {dname} block 16: err {err16}"

        def call():
            return fa.paged_attention_prefill(qx, kc, vc, bt1, qpx, block_size=bs)

        assert torch.equal(call(), call()), f"paged_prefill {dname}: a second call gave other bits"
        times, names, dropped = traced_times(torch, call, PREFILL_CALLS, flush, kernel="prefill")
        ms, lo, hi = spread(times)
        ran = sorted(attention_ms([(0.0, n) for n in names]))
        assert ran == [PREFILL_KERNEL[body]], f"paged_prefill {dname}: ran {ran}, expected {body}"
        plain_ms = measure(torch, lambda: fa.paged_attention_prefill_plain(
            qx, kc, vc, bt1, qpx, block_size=bs), n=3, flush=flush)
        pmask = (slot_pos[None, :] <= qpx[0][:, None])[None, None]

        def library_prefill():
            kg = gathered(kc, bt1, 1).repeat_interleave(G, dim=1)
            vg = gathered(vc, bt1, 1).repeat_interleave(G, dim=1)
            return F.scaled_dot_product_attention(qx, kg, vg, attn_mask=pmask)

        lib_times, _, lib_dropped = traced_times(torch, library_prefill, PREFILL_CALLS, flush)
        lib_ms, lib_lo, lib_hi = spread(lib_times)
        pairs = int(pmask.sum())  # (query, key) pairs attended
        _kernel_row(results, "paged_prefill", dname, max(err, err16 / 2), ms, plain_ms, lib_ms,
                    (2 * Sq * H * D + 2 * (start + Sq) * KV * D) * es, 4 * H * D * pairs)
        row = results[-1]
        row.update(ms_min=lo, ms_max=hi, library_min=lib_lo, library_max=lib_hi, body=body,
                   kernels=ran, calls=len(times), untraced=dropped + lib_dropped,
                   err_block16=err16, share_of_bound=row["bound_ms"] / ms)
        if dname == "bfloat16" and D == 64:
            # the mma.sync body (the earlier design) on the same inputs, and the host time
            # of one call of each body (the TMA body encodes Q's tensor map)
            with forced(fa, "paged_prefill_body", lambda *a: "mma"):
                old, old_names, _ = traced_times(torch, call, PREFILL_CALLS, flush,
                                                 kernel="prefill")
                host_mma = host_us(torch, call)
            assert sorted(attention_ms([(0.0, n) for n in old_names])) == ["prefill_tc_kernel"]
            host_new = host_us(torch, call)
            row.update(mma_sync_ms=spread(old)[0], mma_sync_min=min(old), mma_sync_max=max(old),
                       host_us=host_new, mma_sync_host_us=host_mma)
            log(f"[kernels] paged_prefill bfloat16 ({ran[0]}): kernel {ms:.4f} ms (min {lo:.4f} "
                f"max {hi:.4f}); mma.sync body {row['mma_sync_ms']:.4f} ms (min "
                f"{row['mma_sync_min']:.4f} max {row['mma_sync_max']:.4f}); library {lib_ms:.4f} "
                f"(min {lib_lo:.4f} max {lib_hi:.4f}); {100 * row['bound_ms'] / ms:.1f} % of the "
                f"bound; host per call {host_new:.1f} us, mma.sync {host_mma:.1f} us; block 16 "
                f"err {err16:.3g}")
        del kc, vc
        torch.cuda.empty_cache()
        for row in results[first:]:
            row["head_dim"] = D


# ---------------------------------------------------------------------------
# phase 3c: the mixed step's kernels vs plain versions
# ---------------------------------------------------------------------------


def _new_kernel_row(results, name, dname, err, ms, plain_ms, lib_ms, nbytes, flops, **extra):
    bms, by = bound_ms(nbytes, flops, dname)
    tol = NEW_TOL[(name, dname)]
    assert err <= tol, f"{name} {dname} {extra}: max abs err {err} > {tol}"
    results.append(dict(kernel=name, dtype=dname, max_abs_err=err, tol=tol, ms=ms,
                        plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by, **extra))
    where = " ".join(f"{k}={extra[k]}" for k in ("M", "point", "block") if k in extra)
    rng = (f" (min {extra['ms_min']:.4f} max {extra['ms_max']:.4f}, library min "
           f"{extra['library_min']:.4f} max {extra['library_max']:.4f}, {extra['calls']} calls)"
           if "ms_min" in extra else "")
    log(f"[kernels] {name} {dname} {where}: err {err:.3g} kernel {ms:.4f} ms{rng} plain "
        f"{plain_ms:.4f} library {lib_ms:.4f} bound {bms:.4f} ({by}) ratio "
        f"{ms / lib_ms:.2f}x library {ms / bms:.2f}x bound"
        + (f"; {' + '.join(extra['bodies'])}" if extra.get("bodies") else ""))


def gemm_point(torch, results, name, dname, M, call, plain, library, nbytes, flops, flush):
    """One (product, dtype, M) point of phase 3c's GEMM sweep: the kernel
    against its plain version, the same bits on a second call (the split-K
    reduction is ordered), then — bf16 at every M, f32 at 8 and 520 — the
    per-call device times of kernel and library (median, min, max) and the
    plain version's mean."""
    got = call()
    err = (got.float() - plain().float()).abs().max().item()
    assert torch.equal(call(), got), f"{name} {dname} M={M}: a second call gave other bits"
    bf16 = dname == "bfloat16"
    if not bf16 and M not in (8, 520):
        tol = NEW_TOL[(name, dname)]
        assert err <= tol, f"{name} {dname} M={M}: max abs err {err} > {tol}"
        log(f"[kernels] {name} {dname} M={M}: err {err:.3g}")
        return None
    n = GEMM_CALLS if bf16 else 5
    times, names, dropped = traced_times(torch, call, n, flush, kernel="gemm")
    ms, lo, hi = spread(times)
    lib_times, _, lib_dropped = traced_times(torch, library, n, flush)
    lib_ms, lib_lo, lib_hi = spread(lib_times)
    plain_ms = measure(torch, plain, n=3, flush=flush)
    _new_kernel_row(results, name, dname, err, ms, plain_ms, lib_ms, nbytes, flops, M=M,
                    ms_min=lo, ms_max=hi, library_min=lib_lo, library_max=lib_hi,
                    calls=len(times), untraced=dropped + lib_dropped, bodies=gemm_bodies(names))
    return results[-1]


def ragged_case(torch, dev, R, NB, bs, nblk, decode_only=False):
    """Phase 3c's ragged streams, each row's blocks drawn from a seeded
    permutation of the pool. Packed (the 1032 bucket): one 512-token prefill
    chunk of slot 5 after 384 cached tokens, then decode tokens of slots 3,
    0, 7, 1, 6, 2, 4 at positions 200, 500, ..., 2000, padded to 1032.
    Decode-only (the 8 bucket, 50 of phase 5c's 73 dispatches): one decode
    token of each slot 0..7 at positions 230, 340, ..., 1000."""
    if decode_only:
        T, chunk = 8, []
        dec_slots, dec_pos = list(range(8)), [230 + 110 * i for i in range(8)]
    else:
        T, chunk = 1032, [(5, 384, 512)]  # (slot, first position, tokens)
        dec_slots, dec_pos = [3, 0, 7, 1, 6, 2, 4], [200 + 300 * i for i in range(7)]
    rid = torch.full((T,), -1, dtype=torch.int32)
    qp = torch.zeros((T,), dtype=torch.int32)
    t, lasts, pairs = 0, [], 0
    for slot, start, n in chunk:
        rid[t:t + n], qp[t:t + n] = slot, torch.arange(start, start + n, dtype=torch.int32)
        lasts.append((slot, start + n - 1))
        pairs += sum(range(start + 1, start + n + 1))
        t += n
    rid[t:t + len(dec_slots)] = torch.tensor(dec_slots, dtype=torch.int32)
    qp[t:t + len(dec_slots)] = torch.tensor(dec_pos, dtype=torch.int32)
    lasts += list(zip(dec_slots, dec_pos))
    pairs += sum(p + 1 for p in dec_pos)
    perm = torch.randperm(nblk, generator=torch.Generator().manual_seed(1)).tolist()
    bt = torch.full((R, NB), -1, dtype=torch.int32)
    nxt = 0
    for slot, last in lasts:
        n = last // bs + 1
        bt[slot, :n] = torch.tensor(perm[nxt:nxt + n], dtype=torch.int32)
        nxt += n
    visible = {slot: last + 1 for slot, last in lasts}
    return T, rid.to(dev), qp.to(dev), bt.to(dev), visible, pairs


def ragged_point(torch, F, rpa, results, dname, point, q, kc, vc, case, bs, flush):
    """One ragged point of phase 3c: the kernels against the plain version
    (the same bits on a second call, exact zeros for padding), then per-call
    device times over RAGGED_CALLS flushed calls (median, min, max) of the
    kernels under the plan the engine would build, of the earlier one-kernel
    design (every tile direct: ``ragged_plan(split=False)``), and of the
    library yardstick (SDPA with a boolean mask over K/V gathered through
    the combined table, the gather included: what the plain
    mixed_ragged_xla path computes); the plan's host time."""
    T, rid, qp, bt, visible, pairs = case
    dev = q.device
    H, D = q.shape[1], q.shape[3]
    KV = kc.shape[1]
    G = H // KV
    R, NB = bt.shape
    rid_h, qp_h = rid.cpu().numpy(), qp.cpu().numpy()
    plan_h = rpa.ragged_plan(rid_h, qp_h, R, NB * bs, KV)
    plan = plan_h.to(dev)
    # the graph-ready launch: the plan padded to the bucket's capacity, the
    # launch sized from shapes, the counts read on the card
    cap = rpa.ragged_capacity(T, R, NB * bs, KV)
    static = dataclasses.replace(cap, flat=torch.from_numpy(rpa.pad_plan(plan_h, cap)).to(dev))
    legacy = rpa.ragged_plan(rid_h, qp_h, R, NB * bs, KV, split=False).to(dev)
    t = time.perf_counter()
    for _ in range(50):
        rpa.ragged_plan(rid_h, qp_h, R, NB * bs, KV)
    plan_us = (time.perf_counter() - t) / 50 * 1e6

    def call(p=plan):
        return rpa.ragged_paged_attention(q, kc, vc, bt, rid, qp, block_size=bs, plan=p)

    got = call()
    want = rpa.ragged_paged_attention_plain(q, kc, vc, bt, rid, qp, block_size=bs)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    del want
    assert torch.all(got[:, :, rid < 0] == 0), f"ragged {point}: padding tokens are not 0"
    assert torch.equal(call(), got), f"ragged {dname} {point}: a second call gave other bits"
    old_err = (call(legacy).float() - got.float()).abs().max().item()
    assert torch.equal(call(static), got), f"ragged {dname} {point}: the graph-ready launch differs"
    names_of = ("prefill", "ragged_")
    times, names, dropped = traced_times(torch, call, RAGGED_CALLS, flush, kernel=names_of)
    ms, lo, hi = spread(times)
    static_times, _, _ = traced_times(torch, lambda: call(static), RAGGED_CALLS, flush,
                                      kernel=names_of)
    st_ms, st_lo, st_hi = spread(static_times)
    old_times, _, _ = traced_times(torch, lambda: call(legacy), RAGGED_CALLS, flush,
                                   kernel=names_of)
    W = NB * bs
    col = torch.arange(R * W, device=dev)
    rows = (bt.long().reshape(-1)[:, None] * bs + torch.arange(bs, device=dev)).reshape(-1)
    live = torch.repeat_interleave(bt.reshape(-1) >= 0, bs)
    mask = ((rid.long()[:, None] == col[None] // W) & (col[None] % W <= qp.long()[:, None])
            & live[None])[None, None]

    def library_ragged():
        kg = kc[rows.clamp(min=0)].transpose(0, 1)[None].repeat_interleave(G, dim=1)
        vg = vc[rows.clamp(min=0)].transpose(0, 1)[None].repeat_interleave(G, dim=1)
        return F.scaled_dot_product_attention(q, kg, vg, attn_mask=mask)

    lib_times, _, lib_dropped = traced_times(torch, library_ragged, RAGGED_CALLS, flush)
    lib_ms, lib_lo, lib_hi = spread(lib_times)
    plain_ms = measure(torch, lambda: rpa.ragged_paged_attention_plain(
        q, kc, vc, bt, rid, qp, block_size=bs), n=2, flush=flush)
    # q and q_pos are read only for real tokens: a padding token (row -1)
    # writes 0 whatever its q holds, so only its row id is read
    es = q.element_size()
    T_real = int((rid >= 0).sum())
    nbytes = ((T_real * H * D + T * H * D + 2 * sum(visible.values()) * KV * D) * es
              + bt.numel() * 4 + 4 * T + 4 * T_real)
    kernels = sorted(attention_ms([(0.0, n) for n in names]))
    if dname == "bfloat16" and plan.n_items:  # the split items on the tensor cores
        assert any(SPLIT_MMA_NAME.search(n) for n in names), sorted(names)
    _new_kernel_row(results, "ragged", dname, err, ms, plain_ms, lib_ms, nbytes,
                    4 * H * D * pairs, block=bs, point=point, T=T, ms_min=lo, ms_max=hi,
                    library_min=lib_lo, library_max=lib_hi, calls=len(times),
                    untraced=dropped + lib_dropped, earlier_ms=spread(old_times)[0],
                    earlier_vs_new_err=old_err, kernels=kernels, plan_host_us=plan_us,
                    graph_ready_ms=st_ms, graph_ready_min=st_lo, graph_ready_max=st_hi,
                    capacity=dict(direct=cap.n_direct, items=cap.n_items, combine=cap.n_comb,
                                  grids=cap.grids(KV)),
                    plan=dict(direct=plan.n_direct, items=plan.n_items, slots=plan.n_slots,
                              combine=plan.n_comb, chunk=plan.chunk))
    row = results[-1]
    log(f"[kernels] ragged {dname} {point}: {' + '.join(kernels)}; one-kernel design (PR 3) "
        f"{row['earlier_ms']:.4f} ms -> {ms:.4f} ms ({row['earlier_ms'] / ms:.1f}x); plan "
        f"{row['plan']}, {plan_us:.1f} us on the host; graph-ready launch (sized from shapes, "
        f"{row['capacity']}) {st_ms:.4f} ms ({st_lo:.4f}-{st_hi:.4f}), "
        f"{100 * (st_ms / ms - 1):+.1f} % against per-call sizing")
    if dname == "bfloat16":
        assert ms < row["earlier_ms"], f"ragged {point}: not faster than the one-kernel design"
    del mask
    return got


def check_mixed_kernels(torch, results):
    """QKV at M = 8 and 520 (H_in 2048, T 3072) and a stacked call at layer
    5 of 16; the fused MLP at M = 8 and 520 (H 2048, I 8192, silu) and the
    other activations at a small width; ragged attention at block 128 (the
    decode-only bucket 8: slots 0..7 at positions 230...1000; and a 512-token
    chunk after 384 cached plus 7 decode rows over 200...2000, padded to
    1032, slots not ascending), each beside the earlier one-kernel design,
    and at block 16 with holes, a row
    with no visible key and k_scale 0.5, v_scale 2.0. Library yardsticks:
    torch.matmul, the MLP as three torch products, and SDPA with a boolean
    mask over K/V gathered through the combined table (the gather
    included), which is what the plain mixed_ragged_xla path computes."""
    import torch.nn.functional as F

    from nxdi_tpu_torch.ops.kernels import fused_proj as fp
    from nxdi_tpu_torch.ops.kernels import ragged_paged_attention as rpa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2468)
    scratch = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)

    def flush():
        scratch.zero_()

    def randn(shape, dtype, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * std).to(dtype)

    def err_of(a, b):
        torch.cuda.synchronize()
        return (a.float() - b.float()).abs().max().item()

    Hin, Tqkv, Hm, Im, L, li = 2048, 3072, 2048, 8192, 16, 5
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        es = torch.tensor([], dtype=dt).element_size()

        # --- fused QKV over the M sweep ---
        w_s = randn((L, Hin, Tqkv), dt, 0.02)
        w = w_s[li]
        for M in GEMM_SWEEP_M:
            x = randn((M, Hin), dt)
            assert torch.equal(fp.qkv_matmul_stacked(x, w_s, li), fp.qkv_matmul(x, w)), \
                f"qkv stacked M={M}"
            gemm_point(torch, results, "qkv", dname, M, lambda: fp.qkv_matmul(x, w),
                       lambda: fp.qkv_matmul_plain(x, w), lambda: torch.matmul(x, w),
                       (M * Hin + Hin * Tqkv + M * Tqkv) * es, 2 * M * Hin * Tqkv, flush)
        del w_s, w

        # --- fused MLP over the M sweep ---
        g_s, u_s = randn((L, Hm, Im), dt, 0.02), randn((L, Hm, Im), dt, 0.02)
        d_s = randn((L, Im, Hm), dt, 0.02)
        g, u, d = g_s[li], u_s[li], d_s[li]
        for M in GEMM_SWEEP_M:
            x = randn((M, Hm), dt)
            assert torch.equal(fp.fused_mlp_stacked(x, g_s, u_s, d_s, li),
                               fp.fused_mlp(x, g, u, d)), f"mlp stacked M={M}"
            row = gemm_point(torch, results, "mlp", dname, M, lambda: fp.fused_mlp(x, g, u, d),
                             lambda: fp.fused_mlp_plain(x, g, u, d),
                             lambda: (F.silu(x @ g) * (x @ u)) @ d,
                             (2 * M * Hm + 3 * Hm * Im) * es, 6 * M * Hm * Im, flush)
            if dname == "bfloat16" and M == 520:
                # the card's clock and power while this point runs back to back
                clk, pw, k = smi_under_load(torch, lambda: fp.fused_mlp(x, g, u, d))
                row.update(sm_clock_mhz=clk, power_w=pw, smi_samples=k)
                log(f"[kernels] mlp bfloat16 M=520 back to back: SM clock {clk} MHz, power "
                    f"{pw} W (median of {k} nvidia-smi samples)")
        del g_s, u_s, d_s, g, u, d
        for act in fp.KERNEL_ACTS[1:]:  # correctness at a small width
            x, g, u = randn((40, 256), dt), randn((256, 512), dt, 0.05), randn((256, 512), dt, 0.05)
            d = randn((512, 256), dt, 0.05)
            err = err_of(fp.fused_mlp(x, g, u, d, act=act), fp.fused_mlp_plain(x, g, u, d, act))
            assert err <= NEW_TOL[("mlp", dname)], f"mlp {dname} {act}: err {err}"
            log(f"[kernels] mlp {dname} act={act} M=40 H=256 I=512: err {err:.3g}")

        # --- ragged paged attention, block 128: the packed 1032-token
        # stream and the decode-only bucket 8 ---
        H, KV, D, bs, nblk, NB, R = 32, 8, 64, 128, 136, 16, 8
        kc, vc = randn((nblk * bs, KV, D), dt), randn((nblk * bs, KV, D), dt)
        dcase = ragged_case(torch, dev, R, NB, bs, nblk, decode_only=True)
        qd = randn((1, dcase[0], H, D), dt).transpose(1, 2)
        ragged_point(torch, F, rpa, results, dname, "decode8", qd, kc, vc, dcase, bs, flush)
        case = ragged_case(torch, dev, R, NB, bs, nblk)
        T, rid, qp, bt = case[:4]
        q = randn((1, T, H, D), dt).transpose(1, 2)
        ragged_point(torch, F, rpa, results, dname, "packed1032", q, kc, vc, case, bs, flush)

        # --- the same stream at block 16: holes, a row that sees nothing, scales ---
        sub = bs // 16
        bt16 = torch.where(bt[:, :, None] >= 0,
                           bt[:, :, None] * sub + torch.arange(sub, device=dev),
                           -1).reshape(R, -1).to(torch.int32)
        bt16[3, 5] = -1   # a hole inside slot 3's range
        bt16[0, :] = -1   # slot 0's decode token sees no key
        got = rpa.ragged_paged_attention(q, kc, vc, bt16, rid, qp, block_size=16, k_scale=0.5,
                                         v_scale=2.0)
        want = rpa.ragged_paged_attention_plain(q, kc, vc, bt16, rid, qp, block_size=16,
                                                k_scale=0.5, v_scale=2.0)
        err16 = err_of(got, want)
        assert torch.equal(rpa.ragged_paged_attention(q, kc, vc, bt16, rid, qp, block_size=16,
                                                      k_scale=0.5, v_scale=2.0), got), \
            f"ragged {dname} block 16: a second call gave other bits"
        tok0 = 512 + 1  # slot 0's token
        assert torch.all(got[:, :, tok0] == 0), "ragged: a token with no visible key is not 0"
        assert err16 <= NEW_TOL[("ragged", dname)], f"ragged {dname} block 16: err {err16}"
        log(f"[kernels] ragged {dname} block 16 (holes, empty row, scales): err {err16:.3g}")

        # --- 96 rows (the split plan; the one-kernel design refuses more
        # than 64): a 300-token chunk of row 50 after 600 cached, then one
        # decode token of each other row, padded to 512; tables drawn with
        # replacement from the pool ---
        R96, T96 = 96, 512
        g96 = torch.Generator().manual_seed(96)
        bt96 = torch.randint(0, nblk, (R96, NB), generator=g96, dtype=torch.int32)
        rid96 = torch.full((T96,), -1, dtype=torch.int32)
        qp96 = torch.zeros((T96,), dtype=torch.int32)
        rid96[:300], qp96[:300] = 50, torch.arange(600, 900, dtype=torch.int32)
        others = [r for r in range(R96) if r != 50]
        rid96[300:395] = torch.tensor(others, dtype=torch.int32)
        qp96[300:395] = torch.randint(0, NB * bs, (95,), generator=g96, dtype=torch.int32)
        bt96, rid96, qp96 = bt96.to(dev), rid96.to(dev), qp96.to(dev)
        q96 = randn((1, T96, H, D), dt).transpose(1, 2)
        plan96 = rpa.ragged_plan(rid96.cpu().numpy(), qp96.cpu().numpy(), R96, NB * bs, KV)
        got = rpa.ragged_paged_attention(q96, kc, vc, bt96, rid96, qp96, block_size=bs,
                                         plan=plan96)
        want = rpa.ragged_paged_attention_plain(q96, kc, vc, bt96, rid96, qp96, block_size=bs)
        err96 = err_of(got, want)
        assert torch.all(got[:, :, 395:] == 0), "ragged 96 rows: padding tokens are not 0"
        assert torch.equal(rpa.ragged_paged_attention(q96, kc, vc, bt96, rid96, qp96,
                                                      block_size=bs, plan=plan96), got)
        assert err96 <= NEW_TOL[("ragged", dname)], f"ragged {dname} 96 rows: err {err96}"
        try:
            rpa.ragged_plan(rid96.cpu().numpy(), qp96.cpu().numpy(), R96, NB * bs, KV,
                            split=False)
        except ValueError as e:
            refused = str(e)
        else:
            raise AssertionError("ragged_plan(split=False) took 96 rows")
        results.append(dict(kernel="ragged_rows96", dtype=dname, max_abs_err=err96,
                            tol=NEW_TOL[("ragged", dname)], rows=R96, T=T96,
                            plan=dict(direct=plan96.n_direct, items=plan96.n_items,
                                      slots=plan96.n_slots, combine=plan96.n_comb)))
        log(f"[kernels] ragged {dname} 96 rows (split plan: {plan96.n_direct} direct tiles, "
            f"{plan96.n_items} items): err {err96:.3g}; split=False: {refused}")
        del kc, vc, q, qd, q96, got, want
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 4 and 5: the slice through generate()
# ---------------------------------------------------------------------------


def model_config(ml, tcfg, layers, family=None):
    """(family module, its config at ``layers`` layers): Llama-3.2-1B, or
    ``family`` = (module, config class, widths), e.g. the Mixtral family's."""
    if family is None:
        return ml, ml.LlamaInferenceConfig(tcfg, **dict(ml.LLAMA_3_2_1B, num_hidden_layers=layers))
    module, cfg_cls, widths = family
    return module, cfg_cls(tcfg, **dict(widths, num_hidden_layers=layers))


def random_weights(dense, module, cfg, arch, device):
    """The model's random weights from seed 0: the family's own
    ``random_params`` where it has one (DeepSeek's segments, SmolLM3's and
    Ministral's per-layer flags), else dense.random_params."""
    if hasattr(module, "random_params"):
        return module.random_params(cfg, seed=0, device=device)
    return dense.random_params(arch, seed=0, device=device)


def make_app(ml, TorchConfig, OnDeviceSamplingConfig, TorchModelForCausalLM, dense, *,
             layers, dtype, batch, seq_len, ctx_len, device, params=None, output_logits=False,
             graphs=True, async_mode=False, steps=1, do_sample=False, family=None, **extra):
    """The static slice's app, loaded and warmed up (every bucket captured
    into its CUDA graph on the card unless ``graphs`` is False); ``steps`` > 1
    adds the K-step submodel, ``do_sample`` the sampler; ``extra`` sets or
    overrides config keys (quantization, LoRA, the MoE dispatch); ``family``
    another model (model_config)."""
    tcfg = TorchConfig(**{
        **dict(tp_degree=1, batch_size=batch, seq_len=seq_len, max_context_length=ctx_len,
               dtype=dtype, on_device_sampling_config=OnDeviceSamplingConfig(do_sample=do_sample),
               attn_kernel_enabled=True, attn_tkg_kernel_enabled=True,
               output_logits=output_logits, skip_warmup=True, async_mode=async_mode,
               decode_steps_per_dispatch=steps),
        **extra})
    from nxdi_tpu_torch.runtime.application import maybe_quantize_params

    module, cfg = model_config(ml, tcfg, layers, family)
    arch = module.build_arch(cfg)

    class App(TorchModelForCausalLM):
        def build_params(self):
            if params is not None:
                return params
            # quantized (``quantized`` in ``extra``) on the device, as
            # build_params quantizes a converted checkpoint
            return maybe_quantize_params(random_weights(dense, module, cfg, arch, device),
                                         self.tpu_config)

    app = App("<random>", cfg, model_family=module, device=device, graphs=graphs)
    app.load()
    app.warm_stats = warm(app)
    return app, arch


def warm(app):
    """The app's warmup (every bucket's eager run, then its graph capture on
    the card): seconds, capture seconds per submodel, and on the card the
    peak memory the warmup allocated beyond the params and cache (the graph
    pool and the eager runs; max_memory_allocated after
    reset_peak_memory_stats) and the memory the warmup left reserved once
    the caching allocator's free blocks are released (the graphs' pool
    segments, their outputs and the static inputs). A CPU reference app
    captures nothing, so it skips the warmup (its dispatches stage on first
    use, as with ``skip_warmup``)."""
    import torch

    cuda = app.device.type == "cuda"
    if not cuda:
        return dict(warmup_s=0.0, graphs=app.graphs, skipped="CPU reference")
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        alloc0, res0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    seconds = app.warmup()
    stats = dict(warmup_s=seconds, graphs=app.graphs,
                 capture_s={tag: w.capture_s for tag, w in app.models.items()})
    if cuda:
        peak = torch.cuda.max_memory_allocated() - alloc0
        torch.cuda.empty_cache()
        stats.update(warmup_peak_mib=peak / 2 ** 20,
                     kept_reserved_mib=(torch.cuda.memory_reserved() - res0) / 2 ** 20)
    return stats


def recording(app, log_list):
    """Wrap ``app.forward`` so each dispatch's last-position logits are kept;
    returns the call that takes the wrap off."""
    inner = app.forward

    def fwd(*a, **kw):
        out = inner(*a, **kw)
        log_list.append(out["logits"][:, -1, :].float().cpu())
        return out

    app.forward = fwd
    return lambda: app.__dict__.pop("forward", None)


def prompts(rng, B, S, lengths, vocab):
    ids = rng.integers(1, vocab, size=(B, S)).astype("int64")
    mask = (ids * 0 + 1).astype("int32")
    for b, n in enumerate(lengths):
        ids[b, n:] = 0
        mask[b, n:] = 0
    return ids, mask


def same_bits(torch, phase, graph_logs, eager_logs):
    """Phases 4/4b/4c: every dispatch's logits replayed from a graph against
    the same dispatch run eagerly on the card, which must be equal bit for
    bit. Returns the number of dispatches compared."""
    assert len(graph_logs) == len(eager_logs) > 0, f"phase {phase}: dispatch counts differ"
    for i, (a, b) in enumerate(zip(graph_logs, eager_logs)):
        if not torch.equal(a, b):
            raise AssertionError(
                f"phase {phase} dispatch {i}: graph replay logits differ from eager by "
                f"{(a - b).abs().max().item()}")
    return len(graph_logs)


def submodels(app):
    """The applications whose wrappers serve ``app``: a speculation app's
    target and draft, else the app itself."""
    return [app.target, app.draft] if hasattr(app, "target") else [app]


def three_apps(mods, setup=None, build=None, **app_kw):
    """The same model on the CPU (plain versions), through the card's graphs
    and on the card eagerly, one set of weights: make_app's, or
    ``build(device, graphs, params)``'s (app, arch) (a family's own
    application); ``setup(app)`` runs on each after its load (adapters for
    LoRA)."""
    if build is None:
        ml, TorchConfig, ODSC, App, dense, _ = mods

        def build(device, graphs, params):
            return make_app(ml, TorchConfig, ODSC, App, dense, device=device, graphs=graphs,
                            params=params, **app_kw)

    cpu_app, arch = build("cpu", True, None)
    gpu_app, _ = build("cuda", True, submodels(cpu_app)[0].params)
    eager_app, _ = build("cuda", False, submodels(gpu_app)[0].params)
    apps = (cpu_app, gpu_app, eager_app)
    for app in apps:
        for w in (w for a in submodels(app) for w in a.models.values()):
            w.attention_strategies.clear()  # keep what the phase's traffic runs
        if setup is not None:
            setup(app)
    return apps, arch


def logits_within(torch, phase, logs_ref, logs_got, tol, rows=None):
    """Every step's logits of ``logs_got`` within ``tol`` of ``logs_ref``
    (over ``rows``, all by default) and the same greedy tokens, up to a
    near tie: at a step whose tokens differ the reference's top-2 gap must
    be within ``tol``, and the compare stops there. Returns (the largest
    difference, steps compared, the step of a near-tie flip or None)."""
    worst, compared = 0.0, 0
    for step, (lc, lg) in enumerate(zip(logs_ref, logs_got)):
        if rows is not None:
            lc, lg = lc[rows], lg[rows]
        err = (lc - lg).abs().max().item()
        worst = max(worst, err)
        compared += 1
        assert err <= tol, f"phase {phase} step {step}: logits differ by {err} > {tol}"
        tc, tg = lc.argmax(-1), lg.argmax(-1)
        if not torch.equal(tc, tg):
            top2 = lc.topk(2, dim=-1).values
            gap = (top2[:, 0] - top2[:, 1])[tc != tg].max().item()
            assert gap <= tol, f"phase {phase} step {step}: tokens differ at top-2 gap {gap}"
            log(f"[{phase}] step {step}: near-tie token flip (gap {gap:.3g}); stopping compare")
            return worst, compared, step
    return worst, compared, None


def run_three(torch, mods, phase, apps, ids, mask, new, kernels=None, drive=None,
              record=recording, exact=False, **gen_kw):
    """generate() (or ``drive(app)``, which returns the tokens) on each of
    ``three_apps``, each dispatch's logits kept by ``record(app, list)``: the
    graphs' tokens equal the eager run's and their logits bit for bit, the
    CPU's logits within LOGIT_TOL of the graphs' and its tokens equal (up to
    a near tie, but not when ``exact``). Returns (the largest logit
    difference, the graphs' tokens, the graph run's launches by kernel,
    dispatches compared bit for bit, the graph run's logits per dispatch)."""
    import numpy as np

    cpu_app, gpu_app, eager_app = apps
    if drive is None:
        def drive(app):
            return mods[5](app).generate(ids, attention_mask=mask, max_new_tokens=new, **gen_kw)

    logs = ([], [], [])
    undo = [record(app, log_list) for app, log_list in zip(apps, logs)]
    try:
        out_cpu = drive(cpu_app)
        count = _count_launches(kernels or attention_kernels())
        out_gpu = drive(gpu_app)
        counts = count()
        out_eager = drive(eager_app)
    finally:
        for u in undo:
            u()
    assert np.array_equal(np.asarray(out_gpu), np.asarray(out_eager)), \
        f"phase {phase}: graph and eager tokens differ"
    n_same = same_bits(torch, phase, logs[1], logs[2])
    worst, _, flip = logits_within(torch, phase, logs[0], logs[1], LOGIT_TOL)
    if flip is None or exact:
        assert np.array_equal(np.asarray(out_cpu), np.asarray(out_gpu)), \
            f"phase {phase}: generated tokens differ"
    return worst, out_gpu, counts, n_same, logs[1]


def slice_vs_cpu(torch, np, mods):
    """Phase 4: greedy generate() on the CPU (plain versions), on the card
    through the graphs and on the card eagerly: graph logits within
    LOGIT_TOL of the CPU's and equal to eager ones bit for bit."""
    apps, arch = three_apps(mods, layers=2, dtype="float32", batch=2, seq_len=256, ctx_len=128,
                            output_logits=True)
    ids, mask = prompts(np.random.default_rng(7), 2, 128, [128, 97], arch.vocab_size)
    worst, _, _, n_same, _ = run_three(torch, mods, "4", apps, ids, mask, 16)
    graphs = {tag: sorted(w.bucket_graphs) for tag, w in apps[1].models.items()}
    log(f"[slice-2L] max logit diff {worst:.3g} (tol {LOGIT_TOL}); "
        f"graph replay = eager bit for bit over {n_same} dispatches; graphs by bucket {graphs}")
    return worst


KERNEL_GROUPS = (
    ("flash prefill", re.compile(r"prefill_(wgmma_|tc_)?kernel")),
    ("decode attention", re.compile(r"decode_(split|combine)_kernel")),
    ("ragged attention", re.compile(r"ragged_")),
    ("commit", re.compile(r"kv_commit")),
    ("port GEMM", GEMM_NAME),
    ("cuBLAS GEMM", re.compile(r"gemm|xmma|cutlass|nvjet|sm90_|s16816|Kernel2", re.I)),
    ("reductions (norm, softmax, argmax)", re.compile(r"reduce|softmax|norm|argmax", re.I)),
    ("index, gather, scatter, embedding", re.compile(r"index|gather|scatter|embedding", re.I)),
    ("elementwise", re.compile(r"elementwise|vectorized|unrolled|pointwise", re.I)),
    ("copies, cat, fill", re.compile(r"copy|memcpy|memset|cat|fill", re.I)),
)


def by_group(by_kernel):
    """A profiled window's device ms by kind of kernel (KERNEL_GROUPS, the
    first match; the rest under "other")."""
    out = {}
    for t, name in by_kernel:
        group = next((g for g, rx in KERNEL_GROUPS if rx.search(name)), "other")
        out[group] = out.get(group, 0.0) + t
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


# a step's host parts (runtime/host_spans.py), nested: engine.step holds
# dispatch and token_fetch; dispatch holds pad_and_bucket (which holds
# scatter_indices and the ragged plan's build), the plan's padding, h2d and
# launch
HOST_SPANS = ("engine.step", "dispatch", "pad_and_bucket", "scatter_indices", "ragged_plan",
              "h2d", "launch", "token_fetch")


def host_window(torch, fn, k):
    """``k`` calls of ``fn()`` (work that ends in a token fetch), not
    profiled, with the host spans recorded: (host wall ms per call, host ms
    per call by span). The profiler's tracing slows the host's launches and
    copies, so a step's wall and host split come from here."""
    from nxdi_tpu_torch.runtime import host_spans

    torch.cuda.synchronize()
    with host_spans.recording() as spans:
        t = time.perf_counter()
        for _ in range(k):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / k
    split = {name: spans[name] * 1e3 / k for name in HOST_SPANS if name in spans}
    top = split.get("engine.step", split.get("dispatch", 0.0) + split.get("token_fetch", 0.0))
    split["outside the spans"] = wall_ms - top
    return wall_ms, split


def profiled_call(torch, fn):
    """``fn()`` (work that ends in a token fetch) under the profiler (CUDA
    activity) with the host spans recorded: (host wall ms to the last
    synchronize, device busy ms, kernels by device time, host ms by span).
    Its wall and spans carry the profiler's own host cost."""
    from torch.profiler import ProfilerActivity, profile

    from nxdi_tpu_torch.runtime import host_spans

    torch.cuda.synchronize()
    with host_spans.recording() as spans, profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_kernel = sorted(((k.self_device_time_total / 1e3, k.key) for k in prof.key_averages()),
                       reverse=True)
    split = {k: spans[k] * 1e3 for k in HOST_SPANS if k in spans}
    top = split.get("engine.step", split.get("dispatch", 0.0) + split.get("token_fetch", 0.0))
    split["outside the spans"] = wall_ms - top
    return wall_ms, sum(t for t, _ in by_kernel), by_kernel, split


def split_line(split):
    return "; ".join(f"{k} {v:.3f}" for k, v in split.items())


def slice_full_depth(torch, np, mods, card):
    """Phase 5: 16 layers, bf16, batch 8, 1024-token prompts, 32 new tokens,
    three ways in turns over one set of weights: eager sync (every dispatch
    eager, generate()'s host loop), graph sync (every bucket a CUDA graph),
    graph async (async_mode: the device-resident loop, lag-1 EOS). Each
    mode's tokens must be the others'; launch counts exact in each; prefill
    ms (to the first token on the host), decode ms/step and tok/s (from the
    first token to the last), a profiled decode step's busy/idle share and
    host split, and the prefill's device time by kind of kernel."""
    from nxdi_tpu_torch.generation import hf_adapter as hfa
    from nxdi_tpu_torch.ops.kernels import flash_attention as fa
    from nxdi_tpu_torch.ops.kernels import kv_commit as kc
    from nxdi_tpu_torch.ops.kernels import launch_counters

    ml, TorchConfig, ODSC, App, dense, Adapter = mods
    B, P, NEW, L = 8, 1024, 32, 16
    common = dict(layers=L, dtype="bfloat16", batch=B, seq_len=2048, ctx_len=P, device="cuda",
                  output_logits=True)
    apps = {}
    apps["graph sync"], arch = make_app(ml, TorchConfig, ODSC, App, dense, **common)
    params = apps["graph sync"].params
    apps["eager sync"], _ = make_app(ml, TorchConfig, ODSC, App, dense, graphs=False,
                                     params=params, **common)
    apps["graph async"], _ = make_app(ml, TorchConfig, ODSC, App, dense, async_mode=True,
                                      params=params, **common)
    assert apps["graph async"].async_supported
    for mode, app in apps.items():
        log(f"[slice-16L] {mode}: warmup {app.warm_stats}")
    ids, mask = prompts(np.random.default_rng(11), B, P, [P, P, 1000, P, 731, P, P, 1023],
                        arch.vocab_size)
    lengths = mask.sum(axis=1)

    def run(mode):
        """One generate(): (prefill ms, decode ms/step, tok/s, launch counts,
        tokens, all logits finite)."""
        app = apps[mode]
        finite, stamps = [], []
        inner_fwd, inner_fetch = app.forward, hfa.extract_next_tokens

        def fwd(*a, **kw):
            out = inner_fwd(*a, **kw)
            finite.append(bool(torch.isfinite(out["logits"]).all()))
            return out

        def fetch(outputs):
            toks = inner_fetch(outputs)
            stamps.append(time.perf_counter())
            return toks

        app.forward, hfa.extract_next_tokens = fwd, fetch
        for fn in launch_counters():
            fn.launches = 0
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = Adapter(app).generate(ids, attention_mask=mask, max_new_tokens=NEW)
            torch.cuda.synchronize()
            t_end = time.perf_counter()
        finally:
            del app.forward
            hfa.extract_next_tokens = inner_fetch
        counts = {"prefill": fa.flash_attention_prefill.launches,
                  "decode": fa.flash_attention_decode_fused.launches,
                  "commit": kc.kv_commit_rows.launches}
        want = {"prefill": L, "decode": L * (NEW - 1), "commit": NEW - 1}
        assert counts == want, f"phase 5 {mode}: launch counts {counts} != {want}"
        assert all(finite), f"phase 5 {mode}: non-finite logits"
        decode_s = t_end - stamps[0]
        return dict(prefill_ms=(stamps[0] - t0) * 1e3, decode_ms=decode_s / (NEW - 1) * 1e3,
                    tok_s=B * (NEW - 1) / decode_s), counts, out

    order = ["eager sync", "graph sync", "graph async"]
    runs = {mode: [] for mode in order}
    outs, counts = {}, {}
    for mode in order + order[::-1]:  # in turns: E G A A G E
        stats, counts[mode], outs[mode] = run(mode)
        runs[mode].append(stats)
        log(f"[slice-16L] {mode}: prefill {stats['prefill_ms']:.2f} ms, decode "
            f"{stats['decode_ms']:.3f} ms/step, {stats['tok_s']:.1f} tok/s")
    for mode in order[1:]:
        assert (outs[mode] == outs["eager sync"]).all(), f"phase 5: {mode} tokens differ"
    strategies = set()
    for w in apps["graph sync"].models.values():
        for s in w.attention_strategies.values():
            strategies |= set(s)
    assert strategies == {"cte_flash_kernel", "tkg_fused_kernel_stacked"}, strategies
    gen = np.stack([outs["graph sync"][b, n:n + NEW] for b, n in enumerate(lengths)])
    assert gen.shape == (B, NEW) and (gen >= 0).all() and (gen < arch.vocab_size).all()

    # decode steps of each mode: K steps unprofiled with the host spans (the
    # step's wall and host split), then the same under the profiler (device
    # busy); idle = 1 - busy / the unprofiled wall. Sync modes repeat the
    # step after the run; the async mode chains K steps from a fresh
    # prefill, reading each step's tokens one step late as generate() does
    nxt = np.array([[int(outs["graph sync"][b, n + NEW - 1])] for b, n in enumerate(lengths)],
                   "int32")
    pos = (lengths + NEW - 1).astype("int32")[:, None]
    lti = np.zeros((B,), "int32")
    K = 16
    profiles = {}
    for mode in order:
        app = apps[mode]
        if mode == "graph async":
            def chain(app=app):
                out = app.forward(ids.astype("int32"),
                                  np.tile(np.arange(P, dtype="int32"), (B, 1)),
                                  last_token_index=(lengths - 1).astype("int32"))
                hfa.extract_next_tokens(out)
                ring, pending = hfa._HostTokens(), []

                def steps():
                    nonlocal out
                    for k in range(K):
                        out = app.token_gen_device(out["next_inputs"],
                                                   int(lengths.max()) + 1 + k)
                        pending.append(ring.push(out["tokens"]))
                        if len(pending) >= 2:
                            ring.get(pending.pop(0))
                    ring.get(pending.pop())
                return steps

            wall, split = host_window(torch, chain(), 1)
            _, busy, by_kernel, prof_split = profiled_call(torch, chain())
            wall, busy = wall / K, busy / K
            split = {k: v / K for k, v in split.items()}
        else:
            def step(app=app):
                hfa.extract_next_tokens(app.forward(nxt, pos, last_token_index=lti))

            wall, split = host_window(torch, step, K)
            _, busy, by_kernel, prof_split = profiled_call(torch, step)
            ops = len(kernel_sequence(torch, step))
        profiles[mode] = dict(wall_ms=wall, busy_ms=busy, idle_pct=100 * (1 - busy / wall),
                              host_split_ms=split, top=by_kernel[:8],
                              by_group_ms=by_group(by_kernel),
                              device_ops=None if mode == "graph async" else ops)
        log(f"[slice-16L] {mode} decode step ({K} unprofiled): wall {wall:.3f} ms, device busy "
            f"{busy:.3f} ms (idle {100 * (1 - busy / wall):.1f}%); host ms: {split_line(split)}")

    # the prefill dispatch again under the profiler (it rewrites the same
    # rows of the cache), eager and through its graph: the flash kernel's
    # time by name (the TMA + wgmma body's), the rest by kind of kernel
    prefill = {}
    for mode in ("eager sync", "graph sync"):
        app = apps[mode]
        wall, busy, by_kernel, split = profiled_call(torch, lambda: hfa.extract_next_tokens(app.forward(
            ids.astype("int32"), np.tile(np.arange(P, dtype="int32"), (B, 1)),
            last_token_index=(lengths - 1).astype("int32"))))
        attn = attention_ms(by_kernel)
        assert list(attn) == ["prefill_wgmma_kernel"], f"phase 5 prefill ran {attn}"
        groups = by_group(by_kernel)
        prefill[mode] = dict(wall_ms=wall, busy_ms=busy, attention_ms=attn, by_group_ms=groups,
                             host_split_ms=split, top=by_kernel[:12])
        log(f"[slice-16L] {mode} profiled prefill: wall {wall:.2f} ms, device busy {busy:.3f} ms"
            f"; flash prefill {attn['prefill_wgmma_kernel']:.3f} ms over {L} launches; by kind: "
            + "; ".join(f"{g} {t:.3f}" for g, t in groups.items()) + "; top: "
            + "; ".join(f"{name[:50]} {t:.3f}" for t, name in by_kernel[:8]))
    summary = {mode: {k: float(np.mean([r[k] for r in runs[mode]])) for k in runs[mode][0]}
               for mode in order}
    log(f"[slice-16L] {card}: " + "; ".join(
        f"{mode} prefill {v['prefill_ms']:.2f} ms decode {v['decode_ms']:.3f} ms/step "
        f"{v['tok_s']:.1f} tok/s" for mode, v in summary.items()))
    stats = dict(card=card, runs=runs, mean=summary, profiled_decode_step=profiles,
                 tokens=outs["graph sync"].tolist(),
                 profiled_prefill=prefill,
                 warmup={mode: app.warm_stats for mode, app in apps.items()},
                 prefill_ms=summary["graph sync"]["prefill_ms"],
                 decode_ms_per_step=summary["graph sync"]["decode_ms"],
                 decode_tok_s=summary["graph sync"]["tok_s"])
    return counts["graph sync"], stats


# ---------------------------------------------------------------------------
# phases 4b and 5b: the paged serving engine
# ---------------------------------------------------------------------------


# the mixed step's flags (phases 4c and 5c): one packed dispatch per step
# through the ragged attention, QKV and fused MLP kernels
MIXED_FLAGS = dict(mixed_dispatch=True, fused_qkv=True, qkv_kernel_enabled=True,
                   mlp_kernel_enabled=True)


def mixed_want(tc, n):
    """The mixed engine's launches over ``n`` layer forwards (layers times
    mixed dispatches): the ragged, QKV and MLP kernels each once a layer
    where its flag is on (a window, chunk, sink or softcap family runs the
    ragged step plainly, with attn_kernel_enabled off; a non-gated or MoE
    MLP takes no MLP kernel)."""
    return dict(ragged=n if tc.attn_kernel_enabled else 0,
                qkv=n if tc.qkv_kernel_enabled else 0, mlp=n if tc.mlp_kernel_enabled else 0)


def mixed_strategies(tc):
    """The strategies a mixed engine's dispatches record under ``tc``."""
    return ({"mixed_ragged_kernel" if tc.attn_kernel_enabled else "mixed_ragged_xla"}
            | ({"qkv_fused_kernel"} if tc.qkv_kernel_enabled else set())
            | ({"mlp_fused_kernel"} if tc.mlp_kernel_enabled else set()))


def make_engine_app(ml, TorchConfig, ODSC, App, dense, *, layers, dtype, slots, seq_len, ctx_len,
                    num_blocks, chunk, block_tkg, device, params=None, mixed=False, graphs=True,
                    family=None, **extra):
    """The paged engine's app (``extra``: more config keys, which win over
    the defaults and MIXED_FLAGS, e.g. a quantized KV pool, a role, the MoE
    dispatch or a family's kernel flags; a decode-role app takes no chunked
    prefill; ``family``: another model, model_config)."""
    tcfg = TorchConfig(**{
        **dict(tp_degree=1, batch_size=1, ctx_batch_size=1, tkg_batch_size=slots,
               seq_len=seq_len, max_context_length=ctx_len, dtype=dtype,
               on_device_sampling_config=ODSC(), enable_bucketing=True, is_block_kv_layout=True,
               pa_block_size=128, pa_num_blocks=num_blocks,
               is_prefix_caching=extra.get("role") != "decode",
               chunked_prefill_config=(None if extra.get("role") == "decode"
                                       else {"chunk_size": chunk}),
               attn_kernel_enabled=True, attn_tkg_kernel_enabled=True,
               attn_block_tkg_kernel_enabled=block_tkg, output_logits=True, skip_warmup=True),
        **(MIXED_FLAGS if mixed else {}), **extra})
    module, cfg = model_config(ml, tcfg, layers, family)
    arch = module.build_arch(cfg)

    class EngineApp(App):
        def build_params(self):
            if params is not None:
                return params
            return random_weights(dense, module, cfg, arch, device)

    app = EngineApp("<random>", cfg, model_family=module, device=device, graphs=graphs)
    app.load()
    app.warm_stats = warm(app)
    return app, arch


def strategies_of(app):
    out = set()
    for w in app.models.values():
        for s in w.attention_strategies.values():
            out |= set(s)
    return out


def mixed_kernels():
    """The mixed step's kernel wrappers (their launch counters)."""
    from nxdi_tpu_torch.ops.kernels import fused_proj as fp
    from nxdi_tpu_torch.ops.kernels import ragged_paged_attention as rpa

    return {"ragged": rpa.ragged_paged_attention, "qkv": fp.qkv_matmul, "mlp": fp.fused_mlp}


def attention_kernels():
    from nxdi_tpu_torch.ops.kernels import flash_attention as fa
    from nxdi_tpu_torch.ops.kernels import kv_commit as kc

    return {"prefill": fa.flash_attention_prefill, "paged_prefill": fa.paged_attention_prefill,
            "paged_decode": fa.paged_attention_decode, "window_decode": fa.flash_attention_decode,
            "decode": fa.flash_attention_decode_fused, "commit": kc.kv_commit_rows}


def counted_kernels():
    """The attention kernels and the fused MLP (rows 9/10 count in one
    counter): the wrappers a DeepSeek run's launches are read from."""
    from nxdi_tpu_torch.ops.kernels import fused_proj as fp

    return dict(attention_kernels(), mlp=fp.fused_mlp)


def record_packs(app):
    """Wrap the mixed wrapper's forward: per dispatch, the tokens each row
    packed and the bucket (the padded token count)."""
    from nxdi_tpu_torch.runtime.model_wrapper import TAG_MIXED

    w = app.models[TAG_MIXED]
    inner = w.forward
    packs = []

    def fwd(params, cache, batch):
        import numpy as np

        rids = np.asarray(batch["mixed_row_ids"]).reshape(-1)
        out = inner(params, cache, batch)
        rows, counts = np.unique(rids[rids >= 0], return_counts=True)
        packs.append(dict(rows=dict(zip(rows.tolist(), counts.tolist())), bucket=w.last_bucket))
        return out

    w.forward = fwd
    return packs


def engine_vs_cpu(torch, np, mods, mixed=False, kvq=None, family=None, extra=None, phase=None,
                  extra_strats=()):
    """Phases 4b and 4c: the same traffic through a CPU engine (plain
    versions) and a card engine (kernels): 6 requests, interleaved arrivals,
    two sharing a 256-token (2-block) prefix, one 300-token prompt longer than
    the 256-token chunk, and one forced preemption. Split dispatch (4b): the
    flash and paged prefill launches must be exactly 2 per CTE and
    prefix-prefill dispatch and the window decode 2 per decode dispatch.
    Mixed dispatch (4c): every step is at most one mixed dispatch, some step
    packs a prefill with decode rows, and the ragged, QKV and MLP launches
    are exactly 2 per mixed dispatch, every other attention kernel 0. The
    card runs through the graphs, and again eagerly: the same streams, the
    same launch counts and every dispatch's logits bit for bit. With ``kvq``
    (phase 4e) the pool holds a quantized store and the split engine
    decodes through the paged-decode kernel (the block-table decode flag);
    so does another ``family`` (phase 4h: the Mixtral family, ``extra`` its
    config keys, ``extra_strats`` the MoE strategy its layers record).
    Returns the card run's launch counts and the worst logit difference."""
    from nxdi_tpu_torch.runtime.application import TAG_PREFIX_PREFILL
    from nxdi_tpu_torch.runtime.model_wrapper import (
        TAG_CONTEXT_ENCODING,
        TAG_MIXED,
        TAG_TOKEN_GENERATION,
    )
    from nxdi_tpu_torch.serving import InferenceEngine, SamplingParams, SchedulerConfig

    ml, TorchConfig, ODSC, App, dense, _ = mods
    L = 2
    phase = phase or (("4e" if kvq else "4c" if mixed else "4b")
                      + (" mixed" if kvq and mixed else ""))
    block_tkg = kvq is not None or family is not None
    kw = dict(layers=L, dtype="float32", slots=4, seq_len=512, ctx_len=512, num_blocks=24,
              chunk=256, block_tkg=block_tkg, mixed=mixed, family=family, **(extra or {}),
              **({} if kvq is None else dict(kv_quant_config=kvq)))
    t = time.perf_counter()
    cpu_app, arch = make_engine_app(ml, TorchConfig, ODSC, App, dense, device="cpu", **kw)
    gpu_app, _ = make_engine_app(ml, TorchConfig, ODSC, App, dense, device="cuda",
                                 params=cpu_app.params, **kw)
    eager_app, _ = make_engine_app(ml, TorchConfig, ODSC, App, dense, device="cuda",
                                   params=gpu_app.params, graphs=False, **kw)
    log(f"[engine-2L {phase}] 3 apps loaded {time.perf_counter() - t:.1f} s")
    rng = np.random.default_rng(5)
    shared = rng.integers(1, arch.vocab_size, 256).tolist()
    prompts = [rng.integers(1, arch.vocab_size, n).tolist() for n in (300, 140)]
    prompts += [shared + rng.integers(1, arch.vocab_size, n).tolist() for n in (20, 35)]
    prompts += [rng.integers(1, arch.vocab_size, n).tolist() for n in (90, 200)]

    def drive(app):
        logits = []
        inner = app.forward

        def fwd(*a, **k):
            out = inner(*a, **k)
            logits.append(out["logits"][:, -1, :].float().cpu())
            return out

        app.forward = fwd
        packs = record_packs(app) if mixed else []
        for w in app.models.values():
            w.attention_strategies.clear()  # keep what this traffic runs, not the warmup
        # FCFS admission: cache-aware admission's starvation bound reads the
        # wall clock, and the two runs must dispatch in the same order
        eng = InferenceEngine(app, SchedulerConfig(prefix_cache=True,
                                                   cache_aware_admission=False))
        assert eng.mixed is mixed
        step_inner = eng.step
        per_step = []

        def step():
            before = sum(eng.dispatches.values())
            out = step_inner()
            per_step.append(sum(eng.dispatches.values()) - before)
            return out

        eng.step = step
        sp = SamplingParams(max_new_tokens=16)
        reqs = [eng.add_request(prompts[0], sp), eng.add_request(prompts[1], sp)]
        outs = eng.step()
        reqs.append(eng.add_request(prompts[2], sp))
        outs += eng.step() + eng.step() + eng.step()  # the sharing prompt's prefill lands
        reqs.append(eng.add_request(prompts[3], sp))  # ... so this one hits its 2 blocks
        outs += eng.step()
        victim = eng.preempt_youngest()
        assert victim is not None, f"phase {phase}: nothing to preempt"
        reqs += [eng.add_request(p, sp) for p in prompts[4:]]
        outs += eng.run()
        got = {o.request_id: o.token_ids for o in outs}
        assert eng.prefix_cache.hits_n >= 1, f"phase {phase}: the shared prefix never hit"
        if mixed:
            assert max(per_step) == 1, f"phase 4c: a step ran {max(per_step)} dispatches"
            assert len(packs) == eng.dispatches[TAG_MIXED] == sum(per_step)
            packed = [p for p in packs if max(p["rows"].values()) > 1
                      and min(p["rows"].values()) == 1]
            assert packed, "phase 4c: no step packed a prefill with decode rows"
        return ([got[r.request_id] for r in reqs], logits, strategies_of(app),
                dict(eng.dispatches), packs)

    t = time.perf_counter()
    cpu_streams, cpu_logits, cpu_strats, _, _ = drive(cpu_app)
    log(f"[engine-2L {phase}] CPU run {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    kernels = dict(attention_kernels(), **mixed_kernels())
    for fn in kernels.values():
        fn.launches = 0
    gpu_streams, gpu_logits, gpu_strats, disp, packs = drive(gpu_app)
    counts = {k: fn.launches for k, fn in kernels.items()}
    for fn in kernels.values():
        fn.launches = 0
    eager_streams, eager_logits, eager_strats, eager_disp, _ = drive(eager_app)
    eager_counts = {k: fn.launches for k, fn in kernels.items()}
    log(f"[engine-2L {phase}] card runs (graphs, eager) {time.perf_counter() - t:.1f} s")
    assert eager_streams == gpu_streams, f"phase {phase}: graph and eager streams differ"
    assert (eager_counts, eager_disp, eager_strats) == (counts, disp, gpu_strats), (
        f"phase {phase}: eager {eager_counts} {eager_disp} vs graphs {counts} {disp}")
    n_same = same_bits(torch, phase, gpu_logits, eager_logits)
    want = dict.fromkeys(kernels, 0)
    if mixed:
        want.update(mixed_want(gpu_app.tpu_config, L * disp[TAG_MIXED]))
        assert sum(disp.values()) == disp[TAG_MIXED], f"phase 4c: dispatches {disp}"
        strats = mixed_strategies(gpu_app.tpu_config)
    else:
        decode = "paged_decode" if block_tkg else "window_decode"
        want.update({"prefill": L * disp[TAG_CONTEXT_ENCODING],
                     "paged_prefill": L * disp[TAG_PREFIX_PREFILL],
                     decode: L * disp[TAG_TOKEN_GENERATION]})
        strats = {"cte_flash_kernel", "cte_paged_kernel",
                  "tkg_paged_kernel" if block_tkg else "tkg_kernel"}
    strats |= set(extra_strats)
    assert counts == want, f"phase {phase}: launch counts {counts} != {want} (dispatches {disp})"
    busy = ([k for k in ("ragged", "qkv", "mlp") if want[k]] if mixed
            else ("prefill", "paged_prefill", decode))
    assert busy and all(want[k] > 0 for k in busy), counts
    assert cpu_strats == gpu_strats == strats, (cpu_strats, gpu_strats)
    assert len(cpu_logits) == len(gpu_logits), f"phase {phase}: dispatch counts differ"
    worst = 0.0
    tol = LOGIT_TOL if kvq is None else QUANT_LOGIT_TOL
    for i, (lc, lg) in enumerate(zip(cpu_logits, gpu_logits)):
        err = (lc - lg).abs().max().item()
        worst = max(worst, err)
        assert err <= tol, f"phase {phase} dispatch {i}: logits differ by {err} > {tol}"
    assert cpu_streams == gpu_streams, f"phase {phase}: CPU and card streams differ"
    graphs = {tag: sorted(w.bucket_graphs) for tag, w in gpu_app.models.items()}
    if kvq is not None:
        assert gpu_app.kv_cache["k"].dtype == cpu_app.kv_cache["k"].dtype != torch.float32
        # how many stored codes the CPU and the card rounded apart
        a = gpu_app.kv_cache["k"].view(torch.uint8).cpu()
        b = cpu_app.kv_cache["k"].view(torch.uint8)
        log(f"[engine-2L {phase}] stored K codes that differ CPU vs card: "
            f"{int((a != b).sum())} of {a.numel()}")
    log(f"[engine-2L{' ' + phase if family else ''}{' mixed' if mixed else ''}"
        f"{' ' + str(kvq) if kvq else ''}] "
        f"{len(cpu_logits)} dispatches compared, max "
        f"logit diff {worst:.3g} (tol {tol}); streams identical; launches {counts} "
        f"(dispatches {disp}); graph replay = eager bit for bit over {n_same} dispatches; "
        f"graphs by bucket {graphs}")
    return counts, worst


def engine_full_depth(torch, np, mods, card, mixed=False, graphs=True, kvq=None, keep_app=False,
                      layers=16, family=None, params=None, extra=None, extra_strats=(),
                      phase=None):
    """Phases 5b and 5c: 16 layers, bf16, 8 slots; 16 requests with prompts
    of 200-992 tokens (prompt + 32 new tokens must fit the 1024-token decode
    window the prefix-prefill ladder sets), 8 of them sharing a 384-token
    prefix; 8 arrive at the start, then one per engine step. Split dispatch
    (5b) or one mixed dispatch per step through the ragged, QKV and MLP
    kernels (5c); every bucket a CUDA graph, or (``graphs=False``) every
    dispatch eager. Profiled steps carry the host split. ``kvq`` (phase 5e):
    the same on a quantized pool; ``keep_app``: the app is returned in the
    stats (``app``) for more traffic. Phase 5h runs it for the Mixtral
    ``family`` at 8 ``layers`` over ``params`` (``extra``: its config keys,
    ``extra_strats``: the MoE strategy its layers record)."""
    from nxdi_tpu_torch.runtime.application import TAG_PREFIX_PREFILL
    from nxdi_tpu_torch.runtime.model_wrapper import (
        TAG_CONTEXT_ENCODING,
        TAG_MIXED,
        TAG_TOKEN_GENERATION,
    )
    from nxdi_tpu_torch.ops.kernels import flash_attention as fa
    from nxdi_tpu_torch.serving import InferenceEngine, SamplingParams, SchedulerConfig

    ml, TorchConfig, ODSC, App, dense, _ = mods
    L, NEW = layers, 32
    phase = phase or (("5e " if kvq else "") + ("5c" if mixed else "5b"))
    tag = ((f"[engine-{L}L mixed" if mixed else f"[engine-{L}L")
           + (" graphs" if graphs else " eager")
           + (f" {kvq['dtype']} pool" if kvq else "") + (f" {phase}]" if family else "]"))
    t0 = time.perf_counter()
    app, arch = make_engine_app(ml, TorchConfig, ODSC, App, dense, layers=L, dtype="bfloat16",
                                slots=8, seq_len=2048, ctx_len=1024, num_blocks=136, chunk=512,
                                block_tkg=True, device="cuda", mixed=mixed, graphs=graphs,
                                family=family, params=params, **(extra or {}),
                                **({} if kvq is None else dict(kv_quant_config=kvq)))
    log(f"{tag} load + warmup {time.perf_counter() - t0:.1f} s; {app.warm_stats}")
    rng = np.random.default_rng(17)
    shared = rng.integers(1, arch.vocab_size, 384).tolist()
    lens = rng.integers(200, 993, 16)
    prompts = [
        (shared + rng.integers(1, arch.vocab_size, max(n - 384, 1)).tolist()) if i % 2 == 0
        else rng.integers(1, arch.vocab_size, n).tolist()
        for i, n in enumerate(lens)
    ]
    finite = []
    inner = app.forward

    def fwd(*a, **k):
        out = inner(*a, **k)
        finite.append(bool(torch.isfinite(out["logits"]).all()))
        return out

    app.forward = fwd
    packs = record_packs(app) if mixed else []
    for w in app.models.values():
        w.attention_strategies.clear()  # keep what this traffic runs, not the warmup
    eng = InferenceEngine(app, SchedulerConfig(prefix_cache=True))
    assert eng.mixed is mixed
    stamps = {}

    def on_token(req, tok):
        stamps.setdefault(req.request_id, []).append(time.perf_counter())

    kernels = dict(attention_kernels(), **mixed_kernels())
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    arrivals = {}
    pending = list(prompts)
    for p in pending[:8]:
        r = eng.add_request(p, SamplingParams(max_new_tokens=NEW), on_token=on_token)
        arrivals[r.request_id] = time.perf_counter()
    pending = pending[8:]
    outs = []
    while eng.has_work() or pending:
        if pending:
            r = eng.add_request(pending.pop(0), SamplingParams(max_new_tokens=NEW),
                                on_token=on_token)
            arrivals[r.request_id] = time.perf_counter()
        outs += eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    counts = {k: fn.launches for k, fn in kernels.items()}
    disp = dict(eng.dispatches)
    want = dict.fromkeys(kernels, 0)
    if mixed:
        want.update(mixed_want(app.tpu_config, L * disp[TAG_MIXED]))
        assert sum(disp.values()) == disp[TAG_MIXED] > 0, f"phase 5c: dispatches {disp}"
        strats_want = mixed_strategies(app.tpu_config)
    else:
        want.update(prefill=L * disp[TAG_CONTEXT_ENCODING],
                    paged_prefill=L * disp[TAG_PREFIX_PREFILL],
                    paged_decode=L * disp[TAG_TOKEN_GENERATION])
        assert all(want[k] > 0 for k in ("prefill", "paged_prefill", "paged_decode")), want
        strats_want = {"cte_flash_kernel", "cte_paged_kernel", "tkg_paged_kernel"}
    strats_want |= set(extra_strats)
    assert counts == want, f"phase {phase}: launch counts {counts} != {want} (dispatches {disp})"
    strats = strategies_of(app)
    assert strats == strats_want, strats
    assert all(finite), f"phase {phase}: non-finite logits"
    assert len(outs) == 16 and all(len(o.token_ids) == NEW for o in outs)
    del app.forward  # the finite check syncs: the steps below sync at their token fetch
    assert all(0 <= t < arch.vocab_size for o in outs for t in o.token_ids)
    hits = eng.prefix_cache.hits_n
    assert hits >= 1, f"phase {phase}: the shared prefix never hit"
    ttft = np.array([stamps[i][0] - arrivals[i] for i in arrivals]) * 1e3
    tpot = np.array([(stamps[i][-1] - stamps[i][0]) / (len(stamps[i]) - 1) for i in arrivals]) * 1e3
    tok_s = 16 * NEW / wall
    buckets = {}
    for pk in packs:  # packed vs padded tokens per bucket
        b = buckets.setdefault(pk["bucket"], [0, 0, 0])
        b[0] += 1
        b[1] += sum(pk["rows"].values())
        b[2] += pk["bucket"]

    # profiled steps: 8 fresh short requests, one admitted per step; with
    # split dispatch the step after them only decodes (8 rows); with mixed
    # dispatch the step that admits the 8th packs its prefill with 7 decode
    # rows, and the step after it only decodes
    profiled = {}
    if not mixed:
        # a request sharing the 384-token prefix: its step runs one
        # prefix-prefill dispatch over the rest of its prompt, which must run
        # the TMA + wgmma body's paged mode
        before = dict(eng.dispatches)
        eng.add_request(shared + rng.integers(1, arch.vocab_size, 300).tolist(),
                        SamplingParams(max_new_tokens=2))
        profiled["prefix_prefill"] = profiled_call(torch, eng.step)
        assert eng.dispatches.get(TAG_PREFIX_PREFILL, 0) == before.get(TAG_PREFIX_PREFILL, 0) + 1
        pre_attn = attention_ms(profiled["prefix_prefill"][2])
        # over a one-byte pool the paged prefill runs the one-byte body; at
        # head dim 256 (Gemma-2B, phase 5p) the mma.sync body over either pool
        want_k = ("prefill_tc_kernel" if arch.head_dim not in fa.WGMMA_HEAD_DIMS
                  else "prefill_wgmma_1b_kernel" if kvq else "prefill_wgmma_kernel")
        assert set(pre_attn) & {"prefill_wgmma_kernel", "prefill_wgmma_1b_kernel",
                                "prefill_tc_kernel"} == {want_k}, pre_attn
        eng.run()
    for i in range(8):
        eng.add_request(rng.integers(1, arch.vocab_size, 200).tolist(),
                        SamplingParams(max_new_tokens=16))
        if mixed and i == 7:
            profiled["packed"] = profiled_call(torch, eng.step)
            # the packed chunk's one-row tiles: wgmma items on the one-byte
            # body over a one-byte pool, direct tiles on mma.sync over bf16
            # (and over either pool at head dim 256)
            packed_attn = attention_ms(profiled["packed"][2])
            want_k = ("prefill_wgmma_1b_kernel"
                      if kvq and arch.head_dim in fa.WGMMA_HEAD_DIMS else "prefill_tc_kernel")
            assert set(packed_attn) & {"prefill_wgmma_1b_kernel", "prefill_tc_kernel"} == \
                {want_k}, packed_attn
        else:
            eng.step()
    assert len(eng.scheduler.decodable()) == 8 and not eng.scheduler.waiting
    # decode-only steps: 4 unprofiled with the host spans (wall, host
    # split), then one under the profiler (device busy)
    decode_wall, decode_split = host_window(torch, eng.step, 4)
    profiled["decode"] = profiled_call(torch, eng.step)
    eng.run()
    stats = dict(
        card=card, graphs=graphs, warmup=app.warm_stats, kv_quant=kvq,
        pool_bytes=sum(t.numel() * t.element_size() for t in app.kv_cache.values()),
        pool_dtype=str(app.kv_cache["k"].dtype).replace("torch.", ""),
        streams=[o.token_ids for o in sorted(outs, key=lambda o: o.request_id)],
        wall_s=wall, tok_s=tok_s, ttft_p50_ms=float(np.percentile(ttft, 50)),
        ttft_p95_ms=float(np.percentile(ttft, 95)), tpot_p50_ms=float(np.percentile(tpot, 50)),
        dispatches=disp, prefix_hits=hits, prefix_tokens_saved=eng.prefix_cache.tokens_saved_n,
    )
    if mixed:
        stats["packed_vs_padded_by_bucket"] = {
            str(b): dict(dispatches=v[0], packed=v[1], padded=v[2])
            for b, v in sorted(buckets.items())}
    for kind, (step_ms, busy_ms, by_kernel, split) in profiled.items():
        gemm = {}  # the port's GEMM kernels (phase 5c) by body
        for t, name in by_kernel:
            for body in gemm_bodies([name]):
                key = body.split("<")[0]
                gemm[key] = gemm.get(key, 0.0) + t
        attn = attention_ms(by_kernel)
        if kind == "decode":  # the unprofiled steps' wall and split
            step_ms, split = decode_wall, decode_split
        stats[f"profiled_{kind}_step"] = dict(
            wall_ms=step_ms, busy_ms=busy_ms, idle_pct=100 * (1 - busy_ms / step_ms),
            gemm_ms=sum(gemm.values()), gemm_ms_by_body=gemm, attention_ms_by_kernel=attn,
            host_split_ms=split, by_group_ms=by_group(by_kernel), top=by_kernel[:10],
            wall_from="unprofiled steps" if kind == "decode" else "the profiled step")
        log(f"{tag} {kind} step host ms"
            f"{' (4 unprofiled)' if kind == 'decode' else ' (under the profiler)'}: "
            f"{split_line(split)}")
        log(f"{tag} profiled {kind} step: attention kernels {sum(attn.values()):.3f} ms ("
            + "; ".join(f"{k} {v:.3f}" for k, v in sorted(attn.items())) + ")")
        if gemm:
            log(f"{tag} profiled {kind} step: port GEMM kernels {sum(gemm.values()):.3f} ms ("
                + "; ".join(f"{k} {v:.3f}" for k, v in sorted(gemm.items())) + ")")
        log(f"{tag} profiled {kind} step ({'1 row' if kind == 'prefix_prefill' else '8 rows'}): "
            f"wall {step_ms:.3f} ms, device busy "
            f"{busy_ms:.3f} ms (idle {100 * (1 - busy_ms / step_ms):.1f}%); top: "
            + "; ".join(f"{name[:60]} {t:.3f} ms" for t, name in by_kernel[:6]))
    log(f"{tag} {card}: {tok_s:.1f} tok/s over {wall:.2f} s; TTFT p50 "
        f"{stats['ttft_p50_ms']:.2f} ms p95 {stats['ttft_p95_ms']:.2f} ms; TPOT p50 "
        f"{stats['tpot_p50_ms']:.3f} ms; dispatches {disp}; prefix hits {hits}")
    if mixed:
        log(f"{tag} packed / padded tokens by bucket: {stats['packed_vs_padded_by_bucket']}")
    stats["prompts"] = prompts
    if keep_app:
        stats["app"] = app
    return counts, stats


# ---------------------------------------------------------------------------
# phase 3d: the device-resident decode family's kernels and sampler
# ---------------------------------------------------------------------------

# the sampler's point (phase 3d): Llama-3.2-1B's vocabulary, batch 8, the
# default candidate bound; keys drawn over 10**5 (seed, counter) pairs
SAMPLER_V, SAMPLER_B, SAMPLER_TOPK, SAMPLER_KEYS = 128256, 8, 256, 100_000


def check_decode_family(torch, np, results):
    """Phase 3d: the key -> uniform function on the card against the CPU bit
    for bit over 10**5 keys; the sampler at V 128256, B 8 (device time per
    call beside greedy argmax; card and CPU tokens equal on one key); the
    stacked fused decode with the line operand (rows reading cache lines,
    one line twice) against the gathered plain version, timed beside the
    same call without lines; the commit with cache lines, a frozen lane
    (-1) and a duplicate padding lane (row 0's line, slot and rows) against
    the plain version, timed beside the commit without lines."""
    import torch.nn.functional as F

    from nxdi_tpu_torch.ops import sampling as so
    from nxdi_tpu_torch.ops.kernels import flash_attention as fa
    from nxdi_tpu_torch.ops.kernels import kv_commit as kc

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4321)
    scratch = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)

    def flush():
        scratch.zero_()

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    keys = torch.from_numpy(np.random.default_rng(3).integers(0, 2 ** 32, (SAMPLER_KEYS, 2)))
    u_cpu = so.uniform_from_key(keys, SAMPLER_B)
    u_gpu = so.uniform_from_key(keys.to(dev), SAMPLER_B).cpu()
    assert torch.equal(u_cpu, u_gpu), "phase 3d: key -> uniform differs between CPU and card"
    mean, var = u_cpu.mean().item(), u_cpu.var().item()
    assert abs(mean - 0.5) < 2e-3 and abs(var - 1 / 12) < 2e-3, (mean, var)
    log(f"[sampler] key -> uniform: card = CPU bit for bit over {SAMPLER_KEYS} keys x "
        f"{SAMPLER_B} rows; mean {mean:.5f} var {var:.5f}")

    logits = randn((SAMPLER_B, SAMPLER_V), torch.bfloat16).float() * 4  # bf16 values tie
    sp = torch.tensor([[50, 0.9, 0.8]] * SAMPLER_B, dtype=torch.float32, device=dev)
    key = torch.tensor([17, 3], device=dev)
    got = so.sample(logits, sp, rng=key, do_sample=True, global_topk=SAMPLER_TOPK)
    want = so.sample(logits.cpu(), sp.cpu(), rng=key.cpu(), do_sample=True,
                     global_topk=SAMPLER_TOPK)
    assert torch.equal(got.cpu(), want), f"phase 3d: sampled tokens {got} vs CPU {want}"
    times, _, _ = traced_times(torch, lambda: so.sample(logits, sp, rng=key, do_sample=True,
                                                        global_topk=SAMPLER_TOPK),
                               DECODE_CALLS, flush)
    greedy, _, _ = traced_times(torch, lambda: so.greedy_sample(logits), DECODE_CALLS, flush)
    sampler = dict(kernel="sampler", V=SAMPLER_V, B=SAMPLER_B, global_topk=SAMPLER_TOPK,
                   ms=spread(times)[0], ms_min=min(times), ms_max=max(times),
                   greedy_ms=spread(greedy)[0], greedy_min=min(greedy), greedy_max=max(greedy),
                   keys_checked=SAMPLER_KEYS)
    log(f"[sampler] V {SAMPLER_V} B {SAMPLER_B} global_topk {SAMPLER_TOPK}: sample "
        f"{sampler['ms']:.4f} ms ({sampler['ms_min']:.4f}-{sampler['ms_max']:.4f}) beside greedy "
        f"argmax {sampler['greedy_ms']:.4f} ms; card tokens = CPU tokens")

    # the fused decode and the commit at phase 3's point (B 8, H 32, KV 8,
    # D 64, 2048 slots, 16 layers), bf16, with cache lines
    B, H, KV, D, S, L = 8, 32, 8, 64, 2048, 16
    G, es, dt = H // KV, 2, torch.bfloat16
    ks, vs = randn((L, B, KV, S, D), dt), randn((L, B, KV, S, D), dt)
    qd = randn((B, 1, H, D), dt).transpose(1, 2)
    kn = randn((B, 1, KV, D), dt).transpose(1, 2)
    vn = randn((B, 1, KV, D), dt).transpose(1, 2)
    qpos = torch.tensor([[1024 + 37 * b] for b in range(B)], device=dev, dtype=torch.int32)
    qpos[7, 0] = 300  # a frozen row: its pinned position, nothing special to the kernel
    lines = torch.tensor([3, 3, 0, 7, 1, 5, 2, 6], device=dev, dtype=torch.int32)
    li = 5
    sel = lines.long()
    tol = TOL[("decode", "bfloat16")]

    def call():
        return fa.flash_attention_decode_fused_stacked(qd, ks, vs, kn, vn, qpos, li, lines=lines)

    def plain():
        return fa.flash_attention_decode_fused_plain(qd, ks[li][sel], vs[li][sel], kn, vn, qpos)

    out = call()
    torch.cuda.synchronize()
    err = (out.float() - plain().float()).abs().max().item()
    assert err <= tol, f"phase 3d: decode with lines err {err} > {tol}"
    assert torch.equal(call(), out), "phase 3d: decode with lines, a second call gave other bits"
    times, _, _ = traced_times(torch, call, DECODE_CALLS, flush, kernel=DECODE_KERNELS)
    no_lines, _, _ = traced_times(
        torch, lambda: fa.flash_attention_decode_fused_stacked(qd, ks, vs, kn, vn, qpos, li),
        DECODE_CALLS, flush, kernel=DECODE_KERNELS)
    kcat = torch.cat([ks[li][sel], kn], dim=2).repeat_interleave(G, dim=1)
    vcat = torch.cat([vs[li][sel], vn], dim=2).repeat_interleave(G, dim=1)
    slot = torch.arange(S + 1, device=dev)
    mask = ((slot[None, :] < qpos) | (slot[None, :] == S))[:, None, None, :]
    lib_ms = measure(torch, lambda: F.scaled_dot_product_attention(qd, kcat, vcat, attn_mask=mask),
                     n=DECODE_CALLS, flush=flush)
    plain_ms = measure(torch, plain, flush=flush)
    visible = int(qpos[:, 0].sum().item())
    bms, by = bound_ms((2 * KV * D * (visible + B) + 2 * B * H * D) * es, 4 * H * D * (visible + B),
                       "bfloat16")
    ms, lo, hi = spread(times)
    results.append(dict(kernel="decode", dtype="bfloat16", point="cache lines", max_abs_err=err,
                        tol=tol, ms=ms, ms_min=lo, ms_max=hi, plain_ms=plain_ms,
                        library_ms=lib_ms, bound_ms=bms, bound_by=by,
                        earlier_ms=spread(no_lines)[0], share_of_bound=bms / ms))
    log(f"[kernels] decode bfloat16 with cache lines {lines.tolist()}: err {err:.3g} kernel "
        f"{ms:.4f} ms ({lo:.4f}-{hi:.4f}); without lines {spread(no_lines)[0]:.4f} ms; plain "
        f"{plain_ms:.4f} library {lib_ms:.4f} bound {bms:.4f} ({by})")
    del kcat, vcat

    # the commit of a K-step / loop body: lines, a frozen lane, and a
    # padding lane that repeats row 0 (its line, slot and rows)
    kr, vr = randn((L, B, KV, 1, D), dt), randn((L, B, KV, 1, D), dt)
    kr[:, 7], vr[:, 7] = kr[:, 0], vr[:, 0]
    slots = qpos.clone()
    slots[4, 0] = -1  # frozen
    clines = torch.tensor([3, 1, 0, 7, 2, 5, 6, 3], device=dev, dtype=torch.int32)
    slots[7, 0] = slots[0, 0]  # the padding lane: row 0's line and slot
    k_ref, v_ref = ks.clone(), vs.clone()
    kc.kv_commit_rows_plain(k_ref, v_ref, kr, vr, slots, clines)
    kc.kv_commit_rows(ks, vs, kr, vr, slots, clines)
    torch.cuda.synchronize()
    assert torch.equal(ks, k_ref) and torch.equal(vs, v_ref), "phase 3d: commit with lines"
    times, _, _ = traced_times(torch, lambda: kc.kv_commit_rows(ks, vs, kr, vr, slots, clines),
                               DECODE_CALLS, flush, kernel="kv_commit_kernel")
    no_lines, _, _ = traced_times(torch, lambda: kc.kv_commit_rows(ks, vs, kr, vr, slots),
                                  DECODE_CALLS, flush, kernel="kv_commit_kernel")
    plain_ms = measure(torch, lambda: kc.kv_commit_rows_plain(ks, vs, kr, vr, slots, clines),
                       flush=flush)
    valid = (slots[:, 0] >= 0).nonzero()[:, 0]
    cl, sl, zero = clines[valid].long(), slots[valid, 0].long(), torch.zeros_like(valid)

    def library_commit():
        ks[:, cl, :, sl] = kr[:, valid, :, zero]
        vs[:, cl, :, sl] = vr[:, valid, :, zero]

    lib_ms = measure(torch, library_commit, flush=flush)
    bms, by = bound_ms(2 * 2 * L * int(valid.numel()) * KV * D * es, 0, "bfloat16")
    ms, lo, hi = spread(times)
    results.append(dict(kernel="commit", dtype="bfloat16", point="cache lines", max_abs_err=0.0,
                        tol=0.0, ms=ms, ms_min=lo, ms_max=hi, plain_ms=plain_ms,
                        library_ms=lib_ms, bound_ms=bms, bound_by=by,
                        earlier_ms=spread(no_lines)[0]))
    log(f"[kernels] commit bfloat16 with cache lines, a frozen and a duplicate lane: exact; "
        f"kernel {ms:.4f} ms ({lo:.4f}-{hi:.4f}); without lines {spread(no_lines)[0]:.4f} ms; "
        f"plain {plain_ms:.4f} index_put {lib_ms:.4f} bound {bms:.5f} ({by})")
    del ks, vs, k_ref, v_ref, scratch
    torch.cuda.empty_cache()
    return sampler


# ---------------------------------------------------------------------------
# phases 4d and 5d: contiguous continuous batching, K-step windows, the loop
# ---------------------------------------------------------------------------

# the sampled rows of phases 4d and 5d
SAMPLED = dict(do_sample=True, top_k=50, top_p=0.9, temperature=0.8)


def make_cb_app(ml, TorchConfig, ODSC, App, dense, *, layers, dtype, slots, seq_len, ctx_len,
                device, params=None, graphs=True, steps=1, loop=False, fence=0,
                do_sample=False, deterministic=False, output_logits=False, family=None,
                **extra):
    """A contiguous continuous-batching app (slot = cache line): the K-step
    submodel when ``steps`` > 1, the device loop when ``loop``; its
    context-encoding batch is the decode batch (the JAX package's rule for
    both), loaded and warmed up; ``extra`` sets or overrides config keys;
    ``family`` another model (model_config)."""
    tcfg = TorchConfig(**{
        **dict(tp_degree=1, batch_size=slots, seq_len=seq_len, max_context_length=ctx_len,
               dtype=dtype,
               on_device_sampling_config=ODSC(do_sample=do_sample, deterministic=deterministic),
               enable_bucketing=True, is_continuous_batching=True,
               decode_steps_per_dispatch=steps, device_loop=loop, device_loop_fence=fence,
               attn_kernel_enabled=True, attn_tkg_kernel_enabled=True,
               output_logits=output_logits, skip_warmup=True),
        **extra})
    module, cfg = model_config(ml, tcfg, layers, family)
    arch = module.build_arch(cfg)

    class CBApp(App):
        def build_params(self):
            if params is not None:
                return params
            return random_weights(dense, module, cfg, arch, device)

    app = CBApp("<random>", cfg, model_family=module, device=device, graphs=graphs)
    app.load()
    app.warm_stats = warm(app)
    return app, arch


def cb_counts(eng, L):
    """The launches a contiguous engine's dispatches stand for: L prefills
    and L routed cache writes (the commit kernel) per context encoding; L
    fused decodes and one commit per decode step (1-step dispatches, the
    K-step windows' rungs, the loop's iterations)."""
    from nxdi_tpu_torch.runtime.model_wrapper import TAG_CONTEXT_ENCODING, TAG_TOKEN_GENERATION

    n_cte = eng.dispatches[TAG_CONTEXT_ENCODING]
    steps = eng.dispatches[TAG_TOKEN_GENERATION] + eng.multistep_steps + eng.loop_iterations
    return {"prefill": L * n_cte, "decode": L * steps, "commit": L * n_cte + steps}


def run_cb(app, prompts, params_of, arrivals=None, logits=None, seed=0, sched=None):
    """Drive a contiguous engine over ``prompts``: ``arrivals[i]`` is the
    engine step before which request i arrives (all at the start by
    default); each dispatch's live-row logits go to ``logits`` when it is a
    list. Returns (streams by request, the engine)."""
    import numpy as np

    from nxdi_tpu_torch.serving import InferenceEngine, SchedulerConfig

    if logits is not None:
        inner = app.forward

        def fwd(*a, **k):
            out = inner(*a, **k)
            b = np.asarray(a[0]).shape[0]
            logits.append(out["logits"][:b, -1, :].float().cpu())
            return out

        app.forward = fwd
    for fn in attention_kernels().values():
        fn.launches = 0
    eng = InferenceEngine(app, sched or SchedulerConfig(), seed=seed)
    arrivals = arrivals or [0] * len(prompts)
    reqs, outs, step = [None] * len(prompts), [], 0
    while eng.has_work() or any(r is None for r in reqs):
        for i, a in enumerate(arrivals):
            if reqs[i] is None and a <= step:
                reqs[i] = eng.add_request(prompts[i], params_of(i))
        outs += eng.step()
        step += 1
    if logits is not None:
        del app.forward
    got = {o.request_id: o.token_ids for o in outs}
    return [got[r.request_id] for r in reqs], eng


def cdf_gap(so, torch, logits, sp_row, token):
    """How far u = 0.5 sits from the filtered CDF's boundary at ``token``
    (deterministic sampling): the smallest |cdf - 0.5| over the candidates
    next to where the CPU's CDF crosses 0.5."""
    x = logits[None].float()
    k = min(256, x.shape[-1])
    vals, idx = so.top_k_lower_index_first(x, k)
    sp = torch.tensor([sp_row], dtype=torch.float32)
    rank = torch.arange(k, dtype=torch.float32)[None]
    v = torch.where(rank < sp[:, :1], vals, torch.full_like(vals, so.NEG_INF)) / sp[:, 2:3]
    p = so._softmax(v)
    keep = (torch.cumsum(p, -1) - p) < sp[:, 1:2]
    keep[:, 0] = True
    cdf = torch.cumsum(so._softmax(torch.where(keep, v, torch.full_like(v, so.NEG_INF))), -1)
    return (cdf - 0.5).abs().min().item()


def cb_vs_cpu(torch, np, mods):
    """Phase 4d: the contiguous engine at full width, 2 layers, float32, on
    the CPU and the card, 1-step, K-step (ladder 2, 4, 8) and the device
    loop, greedy: interleaved arrivals, EOS and length finishes; every
    stream identical across the three modes, CPU and card, graphs and
    eager; the 1-step dispatches' live-row logits within LOGIT_TOL; launch
    counts exact. Sampled on the card: K-step windows of generate() equal
    the chained 1-step async loop, the K-step and loop engines equal the
    1-step engine under one key schedule, and a second run repeats the
    streams. The
    deterministic sampler (u = 0.5): CPU and card streams identical."""
    from nxdi_tpu_torch.ops import sampling as so
    from nxdi_tpu_torch.serving import SamplingParams, SchedulerConfig

    ml, TorchConfig, ODSC, App, dense, Adapter = mods
    L = 2
    kw = dict(layers=L, dtype="float32", slots=4, seq_len=512, ctx_len=256)
    cpu1, arch = make_cb_app(ml, TorchConfig, ODSC, App, dense, device="cpu", output_logits=True,
                             **kw)
    cpu_params = cpu1.params
    gpu1, _ = make_cb_app(ml, TorchConfig, ODSC, App, dense, device="cuda", params=cpu_params,
                          output_logits=True, **kw)
    gpu_params = gpu1.params
    rng = np.random.default_rng(9)
    reqs = [rng.integers(1, arch.vocab_size, n).tolist() for n in (120, 40, 200, 75, 150, 30)]
    arrivals = [0, 0, 1, 3, 3, 6]
    max_new = [12, 20, 7, 16, 9, 24]

    def greedy(eos):
        return lambda i: SamplingParams(max_new_tokens=max_new[i], eos_token_ids=eos.get(i, ()))

    # the EOS ids: tokens the plain 1-step streams emit mid-run
    probe, _ = run_cb(cpu1, reqs, greedy({}), arrivals)
    eos = {1: (probe[1][5],), 3: (probe[3][2], 7)}
    logs_cpu, logs_gpu = [], []
    ref, _ = run_cb(cpu1, reqs, greedy(eos), arrivals, logs_cpu)
    assert any(len(s) < max_new[i] for i, s in enumerate(ref)), "phase 4d: no EOS finish"
    assert any(len(s) == max_new[i] for i, s in enumerate(ref)), "phase 4d: no length finish"
    streams, counts, report = {}, {}, {}
    for mode, extra in (("1-step", {}), ("K-step", dict(steps=8)), ("loop", dict(loop=True))):
        apps = {
            "cpu": cpu1 if mode == "1-step" else make_cb_app(
                ml, TorchConfig, ODSC, App, dense, device="cpu", params=cpu_params, **kw,
                **extra)[0],
            "graphs": gpu1 if mode == "1-step" else make_cb_app(
                ml, TorchConfig, ODSC, App, dense, device="cuda", params=gpu_params, **kw,
                **extra)[0],
            "eager": make_cb_app(ml, TorchConfig, ODSC, App, dense, device="cuda",
                                 params=gpu_params, graphs=False, output_logits=mode == "1-step",
                                 **kw, **extra)[0],
        }
        for where, app in apps.items():
            logs = logs_gpu if (mode, where) == ("1-step", "graphs") else None
            s, eng = run_cb(app, reqs, greedy(eos), arrivals, logs)
            streams[mode, where] = s
            if where != "cpu":
                got = {k: fn.launches for k, fn in attention_kernels().items()
                       if k in ("prefill", "decode", "commit")}
                want = cb_counts(eng, L)
                assert got == want, f"phase 4d {mode} {where}: launches {got} != {want}"
                counts[mode, where] = got
            report[mode, where] = dict(eng.dispatches, loop_iterations=eng.loop_iterations,
                                       multistep_steps=eng.multistep_steps)
            assert s == ref, f"phase 4d: {mode} on {where} streams differ from the CPU 1-step"
        strats = strategies_of(apps["graphs"])
        assert "tkg_fused_kernel_stacked" in strats and "cte_flash_kernel" in strats, strats
    worst = 0.0
    assert len(logs_cpu) == len(logs_gpu), "phase 4d: dispatch counts differ"
    for i, (lc, lg) in enumerate(zip(logs_cpu, logs_gpu)):
        err = (lc - lg).abs().max().item()
        worst = max(worst, err)
        assert err <= LOGIT_TOL, f"phase 4d dispatch {i}: logits differ by {err} > {LOGIT_TOL}"
    log(f"[cb-2L] greedy: 1-step, K-step and loop streams identical on the CPU, the card's "
        f"graphs and eager; {len(logs_cpu)} 1-step dispatches' live-row logits within {worst:.3g} "
        f"(tol {LOGIT_TOL}); launches {counts}; dispatches {report}")

    # sampled, on the card: generate()'s K-step windows against its chained
    # 1-step async loop (one key schedule), and the loop engine against the
    # 1-step engine with aligned arrivals (equal budgets), twice
    skw = dict(layers=L, dtype="float32", batch=2, seq_len=256, ctx_len=128, device="cuda",
               params=gpu_params)
    asy, _ = make_app(ml, TorchConfig, ODSC, App, dense, async_mode=True, do_sample=True, **skw)
    ksa, _ = make_app(ml, TorchConfig, ODSC, App, dense, steps=8, do_sample=True, **skw)
    ids, mask = prompts(np.random.default_rng(7), 2, 128, [128, 97], arch.vocab_size)
    gen = dict(attention_mask=mask, max_new_tokens=24, seed=11, **SAMPLED)
    a_out = Adapter(asy).generate(ids, **gen)
    k_out = Adapter(ksa).generate(ids, **gen)
    assert (a_out == k_out).all(), "phase 4d: K-step windows differ from the chained async loop"
    s_kw = dict(kw, do_sample=True)
    one, _ = make_cb_app(ml, TorchConfig, ODSC, App, dense, device="cuda", params=gpu_params,
                         **s_kw)
    lp, _ = make_cb_app(ml, TorchConfig, ODSC, App, dense, device="cuda", params=gpu_params,
                        loop=True, fence=8, **s_kw)
    kse, _ = make_cb_app(ml, TorchConfig, ODSC, App, dense, device="cuda", params=gpu_params,
                         steps=8, **s_kw)

    def sampled(i):
        return SamplingParams(max_new_tokens=20, **SAMPLED)

    sched = SchedulerConfig(max_prefills_per_step=4)
    s_one, _ = run_cb(one, reqs[:4], sampled, seed=5, sched=sched)
    s_ks, e_ks = run_cb(kse, reqs[:4], sampled, seed=5, sched=sched)
    s_loop, e_loop = run_cb(lp, reqs[:4], sampled, seed=5, sched=sched)
    s_again, _ = run_cb(lp, reqs[:4], sampled, seed=5, sched=sched)
    assert s_ks == s_one, "phase 4d: the sampled K-step engine differs from the 1-step engine"
    assert s_loop == s_one, "phase 4d: the sampled loop differs from the 1-step engine"
    assert s_again == s_loop, "phase 4d: a second sampled run differs"
    assert len({tuple(s) for s in s_one}) == 4
    log(f"[cb-2L] sampled {SAMPLED}: generate() K-step windows = chained 1-step async loop "
        f"({k_out.shape[1] - ids.shape[1]} tokens x 2 rows); K-step engine "
        f"({dict(e_ks.dispatches)}, {e_ks.multistep_steps} steps in windows) = loop engine "
        f"(fence 8: {e_loop.loop_launches} launches, {e_loop.loop_iterations} iterations) = "
        f"1-step engine over 4 requests x 20 tokens; a second run repeats them")

    # the deterministic sampler (u = 0.5): CPU and card 1-step engines
    det = dict(kw, do_sample=True, deterministic=True, output_logits=True)
    dc, _ = make_cb_app(ml, TorchConfig, ODSC, App, dense, device="cpu", params=cpu_params, **det)
    dg, _ = make_cb_app(ml, TorchConfig, ODSC, App, dense, device="cuda", params=gpu_params, **det)
    lc, lg = [], []
    d_cpu, _ = run_cb(dc, reqs, lambda i: SamplingParams(max_new_tokens=max_new[i], **SAMPLED),
                      arrivals, lc)
    d_gpu, _ = run_cb(dg, reqs, lambda i: SamplingParams(max_new_tokens=max_new[i], **SAMPLED),
                      arrivals, lg)
    if d_cpu != d_gpu:
        # the first dispatch whose tokens differ: how close u = 0.5 sat to the
        # CPU's CDF boundary there
        row = (SAMPLED["top_k"], SAMPLED["top_p"], SAMPLED["temperature"])
        for i, (a, b) in enumerate(zip(lc, lg)):
            ta = so.sample(a, torch.tensor([row] * a.shape[0]), do_sample=True, deterministic=True)
            tb = so.sample(b, torch.tensor([row] * b.shape[0]), do_sample=True, deterministic=True)
            diff = (ta != tb).nonzero()
            if diff.numel():
                r = int(diff[0, 0])
                gap = cdf_gap(so, torch, a[r], row, int(ta[r]))
                log(f"[cb-2L] deterministic: dispatch {i} row {r} token {int(ta[r])} vs "
                    f"{int(tb[r])}; CDF gap at the boundary {gap:.3g}")
                assert gap < LOGIT_TOL, f"phase 4d: deterministic streams differ (gap {gap})"
                break
    log(f"[cb-2L] deterministic sampling (u = 0.5): CPU and card streams "
        f"{'identical' if d_cpu == d_gpu else 'differ at a CDF tie'}")
    return worst


def cb_full_depth(torch, np, mods, card, slice_stats):
    """Phase 5d at full depth (16 layers, bf16, batch 8). Static path:
    generate() with decode_steps_per_dispatch=8 on phase 5's prompts, greedy
    (its tokens must be phase 5's) and sampled (its tokens must be the
    sampled async loop's, one seed): ms/step and tok/s beside phase 5's
    graph async and the sampled async loop. The contiguous engine over phase 5b's request set
    (16 requests of 200-992 prompt tokens, 32 new tokens each, seed 17; no
    prefix cache on this layout), 1-step, K-step (ladder 2, 4, 8) and the
    device loop (fence 8): tok/s, TTFT p50/p95, TPOT p50, dispatches per
    submodel, loop iterations per launch, a profiled decode step's busy/idle
    share and host split, capture seconds and warmup memory; exact launch
    counts and the three modes' streams identical."""
    from nxdi_tpu_torch.generation import hf_adapter as hfa
    from nxdi_tpu_torch.serving import SamplingParams

    ml, TorchConfig, ODSC, App, dense, Adapter = mods
    B, P, NEW, L = 8, 1024, 32, 16
    out = {}
    common = dict(layers=L, dtype="bfloat16", batch=B, seq_len=2048, ctx_len=P, device="cuda")
    apps = {}
    t0 = time.perf_counter()
    apps["K-step greedy"], arch = make_app(ml, TorchConfig, ODSC, App, dense, steps=8, **common)
    params = apps["K-step greedy"].params
    apps["K-step sampled"], _ = make_app(ml, TorchConfig, ODSC, App, dense, steps=8,
                                         do_sample=True, params=params, **common)
    apps["async sampled"], _ = make_app(ml, TorchConfig, ODSC, App, dense, async_mode=True,
                                        do_sample=True, params=params, **common)
    log(f"[cb-16L] static apps: load + warmup {time.perf_counter() - t0:.1f} s; "
        + "; ".join(f"{k} {a.warm_stats}" for k, a in apps.items()))
    ids, mask = prompts(np.random.default_rng(11), B, P, [P, P, 1000, P, 731, P, P, 1023],
                        arch.vocab_size)
    gens = {}
    for mode, app in apps.items():
        gkw = {} if mode == "K-step greedy" else dict(seed=3, **SAMPLED)
        stamps = []
        inner = hfa.extract_next_tokens

        def fetch(outputs):
            toks = inner(outputs)
            stamps.append(time.perf_counter())
            return toks

        hfa.extract_next_tokens = fetch
        try:
            torch.cuda.synchronize()
            gens[mode] = Adapter(app).generate(ids, attention_mask=mask, max_new_tokens=NEW,
                                               **gkw)
            torch.cuda.synchronize()
            t_end = time.perf_counter()
        finally:
            hfa.extract_next_tokens = inner
        decode_s = t_end - stamps[0]
        out[mode] = dict(decode_ms=decode_s / (NEW - 1) * 1e3, tok_s=B * (NEW - 1) / decode_s)
    assert (gens["K-step greedy"] == np.asarray(slice_stats["tokens"])).all(), \
        "phase 5d: K-step generate() tokens differ from phase 5"
    assert (gens["K-step sampled"] == gens["async sampled"]).all(), \
        "phase 5d: sampled K-step windows differ from the sampled async loop"
    ga = slice_stats["mean"]["graph async"]
    log(f"[cb-16L] static, {card}: " + "; ".join(
        f"{k} {v['decode_ms']:.3f} ms/step {v['tok_s']:.1f} tok/s" for k, v in out.items())
        + f"; phase 5 graph async {ga['decode_ms']:.3f} ms/step {ga['tok_s']:.1f} tok/s; "
        "greedy tokens = phase 5's; sampled K-step tokens = the sampled async loop's")
    del apps
    gc.collect()
    torch.cuda.empty_cache()

    rng = np.random.default_rng(17)
    shared = rng.integers(1, arch.vocab_size, 384).tolist()
    lens = rng.integers(200, 993, 16)
    reqs = [(shared + rng.integers(1, arch.vocab_size, max(n - 384, 1)).tolist()) if i % 2 == 0
            else rng.integers(1, arch.vocab_size, n).tolist() for i, n in enumerate(lens)]
    extra_prompts = [rng.integers(1, arch.vocab_size, 200).tolist() for _ in range(8)]
    engine = {}
    ref_streams = None
    launches = {}
    for mode, extra in (("1-step", {}), ("K-step", dict(steps=8)),
                        ("loop", dict(loop=True, fence=8))):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        app, _ = make_cb_app(ml, TorchConfig, ODSC, App, dense, layers=L, dtype="bfloat16",
                             slots=8, seq_len=2048, ctx_len=1024, device="cuda", params=params,
                             **extra)
        log(f"[cb-16L {mode}] load + warmup {time.perf_counter() - t0:.1f} s; {app.warm_stats}")
        st = cb_engine_run(torch, np, app, reqs, extra_prompts, NEW, L)
        st["warmup"] = app.warm_stats
        if ref_streams is None:
            ref_streams = st["streams"]
        assert st["streams"] == ref_streams, f"phase 5d: {mode} streams differ from the 1-step"
        launches[mode] = st.pop("launches")
        engine[mode] = st
        log(f"[cb-16L {mode}] {card}: {st['tok_s']:.1f} tok/s; TTFT p50 {st['ttft_p50_ms']:.2f} "
            f"p95 {st['ttft_p95_ms']:.2f} ms; TPOT p50 {st['tpot_p50_ms']:.3f} ms; dispatches "
            f"{st['dispatches']}; loop iterations per launch {st['loop_iters_per_launch']}; "
            f"decode step wall {st['profiled_decode_step']['wall_ms']:.3f} ms busy "
            f"{st['profiled_decode_step']['busy_ms']:.3f} ms (idle "
            f"{st['profiled_decode_step']['idle_pct']:.1f}%) for "
            f"{st['profiled_decode_step']['tokens_per_row']} tokens a row; host ms: "
            f"{split_line(st['profiled_decode_step']['host_split_ms'])}")
        del app
    out["engine"] = engine
    return out, launches


def cb_engine_run(torch, np, app, reqs, extra_prompts, NEW, L, counts_fn=None):
    """One contiguous engine over phase 5b's traffic (8 requests at the
    start, then one per step), then 8 fresh 200-token requests admitted one
    per step and, once all decode, decode-only steps: 2 unprofiled with the
    host spans (wall, host split), then one under the profiler (busy).
    ``counts_fn(eng)`` gives the launches the run must count, by kernel
    (default: cb_counts)."""
    from nxdi_tpu_torch.serving import InferenceEngine, SamplingParams, SchedulerConfig

    eng = InferenceEngine(app, SchedulerConfig())
    stamps, arrivals = {}, {}

    def on_token(req, tok):
        stamps.setdefault(req.request_id, []).append(time.perf_counter())

    counts_fn = counts_fn or (lambda e: cb_counts(e, L))
    kernels = counted_kernels()
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    pending, outs = list(reqs), []
    for p in pending[:8]:
        r = eng.add_request(p, SamplingParams(max_new_tokens=NEW), on_token=on_token)
        arrivals[r.request_id] = time.perf_counter()
    pending = pending[8:]
    while eng.has_work() or pending:
        if pending:
            r = eng.add_request(pending.pop(0), SamplingParams(max_new_tokens=NEW),
                                on_token=on_token)
            arrivals[r.request_id] = time.perf_counter()
        outs += eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    want = counts_fn(eng)
    got = {k: kernels[k].launches for k in want}
    assert got == want, f"phase 5d: launches {got} != {want} ({eng.dispatches})"
    assert len(outs) == 16 and all(len(o.token_ids) == NEW for o in outs)
    ttft = np.array([stamps[i][0] - arrivals[i] for i in arrivals]) * 1e3
    tpot = np.array([(stamps[i][-1] - stamps[i][0]) / (len(stamps[i]) - 1)
                     for i in arrivals]) * 1e3
    stats = dict(streams=[o.token_ids for o in sorted(outs, key=lambda o: o.request_id)],
                 wall_s=wall, tok_s=16 * NEW / wall, ttft_p50_ms=float(np.percentile(ttft, 50)),
                 ttft_p95_ms=float(np.percentile(ttft, 95)),
                 tpot_p50_ms=float(np.percentile(tpot, 50)), dispatches=dict(eng.dispatches),
                 loop_launches=eng.loop_launches, loop_iterations=eng.loop_iterations,
                 loop_iters_per_launch=(eng.loop_iterations / eng.loop_launches
                                        if eng.loop_launches else None),
                 multistep_steps=eng.multistep_steps, launches=got,
                 capture_s={tag: w.capture_s for tag, w in app.models.items()})
    # decode-only steps of 8 rows (8 fresh requests admitted in one step):
    # each step emits what its mode emits per dispatch (1, the rung, or up
    # to the fence)
    eng = InferenceEngine(app, SchedulerConfig(max_prefills_per_step=8))
    for p in extra_prompts:
        eng.add_request(p, SamplingParams(max_new_tokens=64))
    eng.step()
    assert len(eng.scheduler.decodable()) == 8 and not eng.scheduler.waiting
    tok0 = sum(len(r.generated) for _, r in eng.scheduler.decodable())
    wall_ms, split = host_window(torch, eng.step, 2)
    tok1 = sum(len(r.generated) for _, r in eng.scheduler.decodable())
    assert len(eng.scheduler.decodable()) == 8, "phase 5d: a row finished inside the timed steps"
    _, busy, by_kernel, _ = profiled_call(torch, eng.step)
    eng.run()
    per_row = (tok1 - tok0) / 2 / 8
    stats["profiled_decode_step"] = dict(
        wall_ms=wall_ms, busy_ms=busy, idle_pct=100 * (1 - busy / wall_ms), host_split_ms=split,
        tokens_per_row=per_row, wall_ms_per_token=wall_ms / per_row,
        by_group_ms=by_group(by_kernel), top=by_kernel[:8])
    return stats

# ---------------------------------------------------------------------------
# phase 3e: the four kernels that read or write a one-byte KV store
# ---------------------------------------------------------------------------

ONE_BYTE = ("float8_e4m3fn", "float8_e5m2", "int8")
# max |kernel - plain| over the same one-byte pool: its values are exact in
# bf16 and f32, so the kernels' own tolerances hold (phase 3b's bf16; f32
# with scores of ~10, a float32 plain version)
ONE_BYTE_TOL = {"bfloat16": 8e-3, "float32": 1e-4}
# the one-byte decode and split body (csrc/mma_tiles.cuh): raw tiles by
# cp.async into a ring, converted to bf16 in shared memory, mma.sync
RAW_RING_BODY = "raw_ring_mma"
# the ragged split kernel's tensor-core instantiation (its last template
# argument: MMA)
SPLIT_MMA_NAME = re.compile(r"ragged_split_kernel<[^()]*\btrue>")
# the per-tensor scale each store is written and read with in phase 3e
ONE_BYTE_SCALES = {"float8_e4m3fn": 0.5, "float8_e5m2": 0.5, "int8": 0.05}
# phases 4e and 5e: the e4m3 pool with per-tensor scales (values / 0.25:
# the 16-layer random model's K and V stay far inside e4m3's 448)
E4M3_PT = dict(dtype="float8_e4m3", scale_mode="per_tensor", k_scale=0.25, v_scale=0.25)


def take_rows(torch, cache, idx):
    """``cache[idx]`` of a one-byte pool, gathered as bytes."""
    if cache.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        return cache.view(torch.uint8)[idx].view(cache.dtype)
    return cache[idx]


def to_store(torch, x, store):
    """``x`` as a one-byte store at ONE_BYTE_SCALES' scale (int8 rounded and
    saturated)."""
    y = x.float() / ONE_BYTE_SCALES[store]
    if store == "int8":
        return y.round().clamp(-127, 127).to(torch.int8)
    return y.to(getattr(torch, store))


def one_byte_point(torch, results, name, store, call, plain, library, nbytes, flops, flush,
                   kernel, bf16_call=None, timed=True, dname="bfloat16", earlier=None):
    """One (kernel, store) point of phase 3e: the kernel against its plain
    version on the same one-byte pool (the commit bit for bit), the same
    bits on a second call; timed (median of DECODE_CALLS flushed calls,
    min, max) beside the same call over the bf16 pool, with the plain
    version, the library yardstick and the bound recomputed for one-byte
    K/V. ``earlier``: the same call on the earlier design (held to the plain
    version too, and timed beside)."""
    got = call()
    want = plain()
    torch.cuda.synchronize()
    if name == "commit":
        err = 0.0 if all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                         for a, b in zip(got, want)) else float("inf")
        again = call()
        assert all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                   for a, b in zip(again, got)), f"commit {store}: a second call differs"
    else:
        err = (got.float() - want.float()).abs().max().item()
        assert torch.equal(call(), got), f"{name} {store} {dname}: a second call gave other bits"
    tol = ONE_BYTE_TOL[dname]
    assert err <= tol, f"{name} {store} {dname}: max abs err {err} > {tol}"
    row = dict(kernel=name, dtype=dname, store=store, point=f"{store} store", max_abs_err=err,
               tol=tol)
    if earlier is not None:
        row["earlier_err"] = (earlier().float() - want.float()).abs().max().item()
        assert row["earlier_err"] <= tol, f"{name} {store}: the earlier design's err > {tol}"
    if timed:
        times, names, dropped = traced_times(torch, call, DECODE_CALLS, flush, kernel=kernel)
        ms, lo, hi = spread(times)
        lib_times, _, lib_dropped = traced_times(torch, library, DECODE_CALLS, flush)
        plain_ms = measure(torch, plain, n=3, flush=flush)
        bms, by = bound_ms(nbytes, flops, dname)
        row.update(ms=ms, ms_min=lo, ms_max=hi, plain_ms=plain_ms, library_ms=spread(lib_times)[0],
                   bound_ms=bms, bound_by=by, share_of_bound=bms / ms,
                   kernels=sorted(attention_ms([(0.0, n) for n in names])) or sorted(names),
                   kernel_names=sorted(names),
                   calls=len(times), untraced=dropped + lib_dropped)
        if bf16_call is not None:  # the same call over the bf16 pool, in this run
            bt, _, _ = traced_times(torch, bf16_call, DECODE_CALLS, flush, kernel=kernel)
            row.update(bf16_pool_ms=spread(bt)[0], bf16_pool_min=min(bt), bf16_pool_max=max(bt))
        if earlier is not None:  # the earlier design, in this run
            et, enames, _ = traced_times(torch, earlier, DECODE_CALLS, flush, kernel=kernel)
            row.update(earlier_ms=spread(et)[0], earlier_min=min(et), earlier_max=max(et),
                       earlier_kernels=sorted(attention_ms([(0.0, n) for n in enames])))
    results.append(row)
    log(f"[kernels-1B] {name} {store} {dname}: err {err:.3g} (tol {tol})"
        + (f"; kernel {row['ms']:.4f} ms (min {row['ms_min']:.4f} max {row['ms_max']:.4f}; "
           f"{'+'.join(row['kernels'])}) beside bf16 pool "
           f"{row.get('bf16_pool_ms', float('nan')):.4f}"
           + (f", earlier design {row['earlier_ms']:.4f} ({row['earlier_min']:.4f}-"
              f"{row['earlier_max']:.4f}; {'+'.join(row['earlier_kernels'])})"
              if 'earlier_ms' in row else "")
           + f"; plain {row['plain_ms']:.4f} library "
           f"{row['library_ms']:.4f} bound {row['bound_ms']:.4f} ({row['bound_by']}), "
           f"{100 * row['share_of_bound']:.1f} % of the bound" if timed else ""))
    return row


def check_one_byte_kernels(torch, results):
    """Phase 3e: rows 4, 6, 7 and 8 over float8_e4m3fn, float8_e5m2 and int8
    stores against their plain versions, at phases 3, 3b and 3c's shapes
    (commit: L 16, B 8, KV 8, S 2048, D 64; paged decode: B 8, block 128,
    positions 0...2000, a hole; paged prefill: a 512-token chunk after 512
    cached; ragged: the decode-only bucket 8 and the packed 1032 stream).
    e4m3 is timed beside the same call over a bf16 pool, and the paged
    prefill and the packed stream beside their earlier mma.sync design; e5m2,
    int8 and an f32 q are checked. With bf16 q the paged prefill and the
    packed stream's one-row tiles run the one-byte TMA + wgmma body (its
    profiled kernel name asserted); the paged prefill equals the bf16 body
    on the up-cast pool bit for bit, and the packed stream's graph-ready
    launch replayed from a CUDA graph equals its eager call. The paged
    decode and the split items run the raw one-byte ring on the decode
    kernel's tensor-core body (the split kernel's instantiation asserted by
    profiled name): the paged decode and the decode-only bucket equal the
    bf16 pool's kernels on the up-cast pool bit for bit. The library
    yardstick: SDPA over K/V gathered through the table and dequantized (the
    gather and the conversion included); for the commit, an index assignment
    of the rows' bytes."""
    import torch.nn.functional as F

    from nxdi_tpu_torch.ops.kernels import flash_attention as fa
    from nxdi_tpu_torch.ops.kernels import kv_commit as kc
    from nxdi_tpu_torch.ops.kernels import ragged_paged_attention as rpa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1357)
    scratch = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)

    def flush():
        scratch.zero_()

    def randn(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    # --- the commit (row 4) ---
    L, B, KV, S, D = 16, 8, 8, 2048, 64
    slots = torch.randint(0, S, (B, 1), generator=gen, device=dev, dtype=torch.int32)
    ar = torch.arange(B, device=dev)
    rows_bf16 = [randn((L, B, KV, 1, D)) for _ in range(2)]
    cache_bf16 = [randn((L, B, KV, S, D)) for _ in range(2)]
    for store in ONE_BYTE:
        rows = [to_store(torch, r, store) for r in rows_bf16]
        cache = [to_store(torch, c, store) for c in cache_bf16]
        ref = [c.clone() for c in cache]

        def call(cache=cache, rows=rows):
            return kc.kv_commit_rows(cache[0], cache[1], rows[0], rows[1], slots)

        def plain(ref=ref, rows=rows):
            return kc.kv_commit_rows_plain(ref[0], ref[1], rows[0], rows[1], slots)

        def library(cache=cache, rows=rows):
            for c, r in zip(cache, rows):
                # (the two index tensors put the batch axis first)
                c.view(torch.uint8)[:, ar, :, slots[:, 0].long()] = \
                    r.view(torch.uint8)[:, :, :, 0].transpose(0, 1)

        one_byte_point(torch, results, "commit", store, call, plain, library,
                       4 * L * B * KV * D + 4 * B, 0, flush, "kv_commit",
                       bf16_call=lambda: kc.kv_commit_rows(cache_bf16[0], cache_bf16[1],
                                                           rows_bf16[0], rows_bf16[1], slots),
                       timed=store == "float8_e4m3fn")
        del rows, cache, ref
    del cache_bf16
    torch.cuda.empty_cache()

    # --- paged decode (row 7) and paged prefill (row 6): phase 3b's pool ---
    B, H, KV, D, bs, nblk, NB = 8, 32, 8, 64, 128, 136, 16
    G = H // KV
    qpos = torch.linspace(0, 2000, B, device=dev).long()
    perm = torch.randperm(nblk, generator=torch.Generator().manual_seed(0)).tolist()
    bt = torch.full((B, NB), -1, dtype=torch.int32)
    nxt = 0
    for b in range(B):
        n = int(qpos[b]) // bs + 1
        bt[b, :n] = torch.tensor(perm[nxt:nxt + n], dtype=torch.int32)
        nxt += n
    bt[3, 2] = -1
    bt = bt.to(dev)
    slot_pos = torch.arange(NB * bs, device=dev)
    live = torch.repeat_interleave(bt >= 0, bs, dim=1) & (slot_pos[None] <= qpos[:, None])
    visible = int(live.sum())
    kb, vb = randn((nblk * bs, KV, D)), randn((nblk * bs, KV, D))

    def gathered(cache, table, n_rows, sc):
        rows = (table.long()[:, :, None] * bs + torch.arange(bs, device=dev)).reshape(n_rows, -1)
        return (take_rows(torch, cache, rows.clamp(min=0)).to(torch.bfloat16) * sc).transpose(1, 2)

    q = randn((B, 1, H, D)).transpose(1, 2)
    qp = qpos[:, None].to(torch.int32)
    mask = live[:, None, None, :]
    Sq, start = 512, 512
    bt1 = bt[7:8]
    qx = randn((1, Sq, H, D)).transpose(1, 2)
    qpx = (start + torch.arange(Sq, device=dev, dtype=torch.int32))[None]
    pmask = (slot_pos[None, :] <= qpx[0][:, None])[None, None]
    pairs = int(pmask.sum())

    def mma_sync_prefill(kc1, vc1, kw):  # the earlier design: its body code passed
        with forced(fa, "paged_prefill_body", lambda *a: "mma"):
            return fa.paged_attention_prefill(qx, kc1, vc1, bt1, qpx, **kw)
    for store in ONE_BYTE:
        sc = ONE_BYTE_SCALES[store]
        kw = dict(block_size=bs, k_scale=sc, v_scale=sc)
        kc1, vc1 = to_store(torch, kb, store), to_store(torch, vb, store)
        timed = store == "float8_e4m3fn"

        def lib_decode(kc1=kc1, vc1=vc1, sc=sc):
            kg = gathered(kc1, bt, B, sc).repeat_interleave(G, dim=1)
            vg = gathered(vc1, bt, B, sc).repeat_interleave(G, dim=1)
            return F.scaled_dot_product_attention(q, kg, vg, attn_mask=mask)

        row = one_byte_point(
            torch, results, "paged_decode", store,
            lambda kc1=kc1, vc1=vc1, kw=kw: fa.paged_attention_decode(q, kc1, vc1, bt, qp, **kw),
            lambda kc1=kc1, vc1=vc1, kw=kw: fa.paged_attention_decode_plain(q, kc1, vc1, bt, qp,
                                                                            **kw),
            lib_decode, 2 * visible * KV * D + 2 * B * H * D * 2 + bt.numel() * 4,
            4 * H * D * visible, flush, DECODE_KERNELS,
            bf16_call=lambda: fa.paged_attention_decode(q, kb, vb, bt, qp, block_size=bs),
            timed=timed)
        # the raw one-byte ring on the tensor-core body equals row 7's kernel
        # on the up-cast pool (the same scales), bit for bit
        up = fa.paged_attention_decode(q, kc1.to(torch.bfloat16), vc1.to(torch.bfloat16), bt, qp,
                                       **kw)
        assert torch.equal(fa.paged_attention_decode(q, kc1, vc1, bt, qp, **kw), up), \
            f"paged_decode {store}: the one-byte body differs from the bf16 pool's bits"
        row.update(bf16_body_bits_equal=True, body=RAW_RING_BODY)
        del up
        if timed:
            assert row["kernels"] == ["decode_combine_kernel", "decode_split_kernel"], \
                row["kernels"]
        assert fa.paged_prefill_body(qx, kc1, vc1, bs) == "wgmma"

        def lib_prefill(kc1=kc1, vc1=vc1, sc=sc):
            kg = gathered(kc1, bt1, 1, sc).repeat_interleave(G, dim=1)
            vg = gathered(vc1, bt1, 1, sc).repeat_interleave(G, dim=1)
            return F.scaled_dot_product_attention(qx, kg, vg, attn_mask=pmask)

        row = one_byte_point(
            torch, results, "paged_prefill", store,
            lambda kc1=kc1, vc1=vc1, kw=kw: fa.paged_attention_prefill(qx, kc1, vc1, bt1, qpx,
                                                                       **kw),
            lambda kc1=kc1, vc1=vc1, kw=kw: fa.paged_attention_prefill_plain(qx, kc1, vc1, bt1,
                                                                             qpx, **kw),
            lib_prefill, 2 * Sq * H * D * 2 + 2 * (start + Sq) * KV * D, 4 * H * D * pairs, flush,
            "prefill",
            bf16_call=lambda: fa.paged_attention_prefill(qx, kb, vb, bt1, qpx, block_size=bs),
            timed=timed, earlier=lambda kc1=kc1, vc1=vc1, kw=kw: mma_sync_prefill(kc1, vc1, kw))
        # the one-byte body equals the bf16 TMA body on the up-cast pool, bit for bit
        up = fa.paged_attention_prefill(qx, kc1.to(torch.bfloat16), vc1.to(torch.bfloat16), bt1,
                                        qpx, **kw)
        assert torch.equal(fa.paged_attention_prefill(qx, kc1, vc1, bt1, qpx, **kw), up), \
            f"paged_prefill {store}: the one-byte body differs from the bf16 body's bits"
        row["bf16_body_bits_equal"] = True
        del up
        if timed:  # the one-byte TMA + wgmma body; the earlier design the mma.sync body
            assert row["kernels"] == ["prefill_wgmma_1b_kernel"], row["kernels"]
            assert row["earlier_kernels"] == ["prefill_tc_kernel"], row["earlier_kernels"]
            row["body"] = "wgmma_1b"
        # f32 q over the same pool: the CUDA-core bodies
        qf, qxf = q.float(), qx.float()
        one_byte_point(
            torch, results, "paged_decode", store,
            lambda kc1=kc1, vc1=vc1, kw=kw: fa.paged_attention_decode(qf, kc1, vc1, bt, qp, **kw),
            lambda kc1=kc1, vc1=vc1, kw=kw: fa.paged_attention_decode_plain(qf, kc1, vc1, bt, qp,
                                                                            **kw),
            None, 0, 0, flush, DECODE_KERNELS, timed=False, dname="float32")
        one_byte_point(
            torch, results, "paged_prefill", store,
            lambda kc1=kc1, vc1=vc1, kw=kw: fa.paged_attention_prefill(qxf, kc1, vc1, bt1, qpx,
                                                                       **kw),
            lambda kc1=kc1, vc1=vc1, kw=kw: fa.paged_attention_prefill_plain(qxf, kc1, vc1, bt1,
                                                                             qpx, **kw),
            None, 0, 0, flush, "prefill", timed=False, dname="float32")

        # --- ragged (row 8): phase 3c's streams over the same pool ---
        for decode_only in (True, False):
            case = ragged_case(torch, dev, 8, NB, bs, nblk, decode_only=decode_only)
            T, rid, qpr, btr, vis, rpairs = case
            qr = randn((1, T, H, D)).transpose(1, 2)
            rid_h, qpr_h = rid.cpu().numpy(), qpr.cpu().numpy()
            # a bf16 pool's plan (direct tiles on mma.sync), and the one-byte pool's
            plan_bf16 = rpa.ragged_plan(rid_h, qpr_h, 8, NB * bs, KV).to(dev)
            W = NB * bs
            col = torch.arange(8 * W, device=dev)
            rows_ = (btr.long().reshape(-1)[:, None] * bs + torch.arange(bs, device=dev))
            rows_ = rows_.reshape(-1)
            livr = torch.repeat_interleave(btr.reshape(-1) >= 0, bs)
            rmask = ((rid.long()[:, None] == col[None] // W)
                     & (col[None] % W <= qpr.long()[:, None]) & livr[None])[None, None]

            def lib_ragged(kc1=kc1, vc1=vc1, sc=sc, qr=qr, rows_=rows_, rmask=rmask):
                idx = rows_.clamp(min=0)
                kg = (take_rows(torch, kc1, idx).to(torch.bfloat16) * sc).transpose(0, 1)[None]
                vg = (take_rows(torch, vc1, idx).to(torch.bfloat16) * sc).transpose(0, 1)[None]
                return F.scaled_dot_product_attention(qr, kg.repeat_interleave(G, dim=1),
                                                      vg.repeat_interleave(G, dim=1),
                                                      attn_mask=rmask)

            T_real = int((rid >= 0).sum())
            nbytes = ((T_real * H * D + T * H * D) * 2 + 2 * sum(vis.values()) * KV * D
                      + btr.numel() * 4 + 4 * T + 4 * T_real)
            for qq, dname in ((qr, "bfloat16"), (qr.float(), "float32")):
                wg = rpa.ragged_direct_body(qq.dtype, kc1.dtype, D, bs) == "wgmma"
                assert wg == (dname == "bfloat16")
                plan = rpa.ragged_plan(rid_h, qpr_h, 8, NB * bs, KV, wgmma=wg).to(dev)
                row_timed = timed and dname == "bfloat16"
                earlier = None
                if wg and row_timed and not decode_only:
                    def earlier(kc1=kc1, vc1=vc1, kw=kw, qq=qq, rid=rid, qpr=qpr, btr=btr):
                        # the earlier design: direct tiles on mma.sync, its plan and body
                        with forced(rpa, "ragged_direct_body", lambda *a: "mma"):
                            return rpa.ragged_paged_attention(qq, kc1, vc1, btr, rid, qpr,
                                                              plan=plan_bf16, **kw)

                def call(kc1=kc1, vc1=vc1, kw=kw, qq=qq, rid=rid, qpr=qpr, btr=btr, plan=plan):
                    return rpa.ragged_paged_attention(qq, kc1, vc1, btr, rid, qpr, plan=plan,
                                                      **kw)

                row = one_byte_point(
                    torch, results, "ragged", store, call,
                    lambda kc1=kc1, vc1=vc1, kw=kw, qq=qq, rid=rid, qpr=qpr, btr=btr:
                    rpa.ragged_paged_attention_plain(qq, kc1, vc1, btr, rid, qpr, **kw),
                    lib_ragged, nbytes, 4 * H * D * rpairs, flush, ("prefill", "ragged_"),
                    bf16_call=lambda qr=qr, rid=rid, qpr=qpr, btr=btr, plan=plan_bf16:
                    rpa.ragged_paged_attention(qr, kb, vb, btr, rid, qpr, block_size=bs,
                                               plan=plan),
                    timed=row_timed, dname=dname, earlier=earlier)
                row["point"] = f"{store} store, {'decode8' if decode_only else 'packed1032'}"
                if wg:  # bf16 q: the split items on the raw ring's tensor-core body
                    row["split_body"] = RAW_RING_BODY
                    if row_timed:
                        assert any(SPLIT_MMA_NAME.search(n) for n in row["kernel_names"]), \
                            row["kernel_names"]
                if wg and decode_only:  # (split items only) the bf16 pool's bits on the up-cast pool
                    up = rpa.ragged_paged_attention(
                        qq, kc1.to(torch.bfloat16), vc1.to(torch.bfloat16), btr, rid, qpr,
                        plan=plan_bf16, **kw)
                    assert torch.equal(call(), up), \
                        f"ragged {store} decode8: the one-byte split differs from the bf16 pool's"
                    row["bf16_body_bits_equal"] = True
                    del up
                row["plan"] = dict(direct=plan.n_direct, wgmma_items=plan.n_wg,
                                   items=plan.n_items, combine=plan.n_comb)
                if wg and not decode_only:
                    assert plan.n_wg == 4 and plan.n_direct == 0, row["plan"]
                    if row_timed:  # the one-row tiles on the one-byte TMA + wgmma body
                        assert "prefill_wgmma_1b_kernel" in row["kernels"], row["kernels"]
                        assert "prefill_tc_kernel" not in row["kernels"], row["kernels"]
                        assert "prefill_tc_kernel" in row["earlier_kernels"]
                        row["body"] = "wgmma_1b"
                    # the mixed step's graph-ready launch (the plan padded to the
                    # bucket's capacity), eager and replayed from a CUDA graph: the
                    # per-call launch's bits
                    cap = rpa.ragged_capacity(T, 8, NB * bs, KV, wgmma=True)
                    static = dataclasses.replace(cap, flat=torch.from_numpy(
                        rpa.pad_plan(plan, cap)).to(dev))
                    got = call()
                    assert torch.equal(call(plan=static), got), f"ragged {store}: graph-ready"
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph):
                        out = call(plan=static)
                    out.zero_()
                    graph.replay()
                    torch.cuda.synchronize()
                    assert torch.equal(out, got), f"ragged {store}: the graph replay differs"
                    row["graph_replay_bits_equal"] = True
                    del graph, out
        del kc1, vc1
    del kb, vb
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4e: quantized KV and weights, CPU against the card (2 layers, f32)
# ---------------------------------------------------------------------------


def _count_launches(kernels=None):
    """Zero the launch counts of ``kernels`` (the attention and mixed-step
    kernels by default); returns the call that reads them."""
    kernels = kernels or dict(attention_kernels(), **mixed_kernels())
    for fn in kernels.values():
        fn.launches = 0
    return lambda: {k: fn.launches for k, fn in kernels.items()}


def static_logits(torch, app, Adapter, ids, mask, new):
    """generate() on ``app`` with every dispatch's last-position logits kept:
    (tokens, logits list)."""
    import numpy as np

    logs = []
    recording(app, logs)
    try:
        toks = Adapter(app).generate(ids, attention_mask=mask, max_new_tokens=new)
    finally:
        del app.forward
    return np.asarray(toks), logs


def pair_apps(torch, mods, *, layers, dtype, kvq, slots, ctx_len, num_blocks, chunk, device,
              params=None, graphs=True):
    """A prefill-role and a decode-role paged app (each its own pool), on
    one set of weights."""
    ml, TorchConfig, ODSC, App, dense, _ = mods
    kw = dict(layers=layers, dtype=dtype, slots=slots, seq_len=2 * ctx_len, ctx_len=ctx_len,
              num_blocks=num_blocks, chunk=chunk, block_tkg=True, device=device, graphs=graphs,
              **({} if kvq is None else dict(kv_quant_config=kvq)))
    pre, arch = make_engine_app(ml, TorchConfig, ODSC, App, dense, params=params,
                                role="prefill", **kw)
    dec, _ = make_engine_app(ml, TorchConfig, ODSC, App, dense, params=pre.params,
                             role="decode", **kw)
    return pre, dec, arch


def run_pair(torch, pre_app, dec_app, prompts, new, stamps=None):
    """Every prompt into the prefill-role engine at once; each parked chain
    exported, imported into the decode-role engine and acknowledged as soon
    as it is ready, both engines stepped in turns until all finish. Returns
    (streams by prompt, per-handoff [export ms, import ms, bytes], wall s,
    the engines)."""
    from nxdi_tpu_torch.serving import InferenceEngine, SamplingParams, SchedulerConfig
    from nxdi_tpu_torch.serving.handoff import HandoffCapacityError

    pre = InferenceEngine(pre_app, SchedulerConfig(prefix_cache=True))
    dec = InferenceEngine(dec_app, SchedulerConfig())
    on_token = None
    if stamps is not None:
        def on_token(req, tok):
            stamps.setdefault(req.request_id, []).append(time.perf_counter())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = {pre.add_request(p, SamplingParams(max_new_tokens=new), on_token=on_token).request_id: i
           for i, p in enumerate(prompts)}
    arrivals = {rid: t0 for rid in ids}
    outs, handoffs, parked = {}, [], []
    while pre.has_work() or dec.has_work():
        if pre.has_work():
            for o in pre.step():
                outs[ids[o.request_id]] = o.token_ids
        for rid in pre.take_ready_handoffs():
            te = time.perf_counter()
            payload = pre.export_handoff(rid)
            parked.append((rid, payload, (time.perf_counter() - te) * 1e3))
        while parked:
            rid, payload, export_ms = parked[0]
            ti = time.perf_counter()
            try:
                dec.admit_handoff(payload, on_token=on_token)
            except HandoffCapacityError:
                break  # the decode engine is full: the chain stays parked, retried next step
            torch.cuda.synchronize()
            tf = time.perf_counter()
            pre.ack_handoff(rid)
            parked.pop(0)
            handoffs.append([export_ms, (tf - ti) * 1e3, payload.nbytes])
        if dec.has_work():
            for o in dec.step():
                outs[ids[o.request_id]] = o.token_ids
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return [outs[i] for i in range(len(prompts))], handoffs, wall, (pre, dec, arrivals)


def quant_vs_cpu(torch, np, mods):
    """Phase 4e, 2 layers, float32, full width: (a) the split paged engine
    on an e4m3 per-tensor pool, CPU vs card graphs vs card eager (phase 4b's
    traffic, decoding through the paged-decode kernel; the mixed engine's
    one-byte ragged kernel is held to its plain version in phase 3e and runs
    in 5e); (b) the contiguous continuous-batching engine on an e4m3 cache
    (the commit writes one-byte rows; the fused decode runs per layer over
    the dequantized window, the stacked one being off a narrowed store);
    (c) generate() with int8 and
    fp8 weights; (d) the disaggregated pair on the card (prefill-role +
    decode-role, e4m3 pools) against the unified card engine. Streams
    identical, logits within LOGIT_TOL (QUANT_LOGIT_TOL on one-byte stores),
    launch counts exact."""
    from nxdi_tpu_torch.runtime.model_wrapper import TAG_CONTEXT_ENCODING

    ml, TorchConfig, ODSC, App, dense, Adapter = mods
    out = {}
    out["paged_counts"], out["paged_err"] = engine_vs_cpu(torch, np, mods, kvq=E4M3_PT)

    # (b) the contiguous engine on an e4m3 cache
    L = 2
    cb = dict(layers=L, dtype="float32", slots=4, seq_len=512, ctx_len=256, output_logits=True,
              kv_quant_config=dict(dtype="float8_e4m3"))
    cpu_cb, arch = make_cb_app(ml, TorchConfig, ODSC, App, dense, device="cpu", **cb)
    gpu_cb, _ = make_cb_app(ml, TorchConfig, ODSC, App, dense, device="cuda",
                            params=cpu_cb.params, **cb)
    rng = np.random.default_rng(21)
    prompts_ = [rng.integers(1, arch.vocab_size, n).tolist() for n in (30, 120, 75, 200, 44)]
    from nxdi_tpu_torch.serving import SamplingParams

    cpu_logits, gpu_logits = [], []
    sp = lambda i: SamplingParams(max_new_tokens=12)  # noqa: E731
    cpu_streams, _ = run_cb(cpu_cb, prompts_, sp, [0, 0, 1, 3, 3], cpu_logits)
    gpu_streams, eng = run_cb(gpu_cb, prompts_, sp, [0, 0, 1, 3, 3], gpu_logits)
    counts = {k: fn.launches for k, fn in attention_kernels().items()}
    want = dict.fromkeys(counts, 0)
    want.update(cb_counts(eng, L))
    assert counts == want and want["decode"] > 0, f"phase 4e contiguous: launches {counts} != {want}"
    assert cpu_streams == gpu_streams, "phase 4e contiguous: CPU and card streams differ"
    cb_err = max((a - b).abs().max().item() for a, b in zip(cpu_logits, gpu_logits))
    assert len(cpu_logits) == len(gpu_logits) and cb_err <= QUANT_LOGIT_TOL, cb_err
    assert gpu_cb.kv_cache["k"].dtype == torch.float8_e4m3fn
    out.update(cb_counts=counts, cb_err=cb_err)
    log(f"[quant-2L] contiguous engine, e4m3 cache: streams identical, max logit diff "
        f"{cb_err:.3g}; launches {counts}")
    del cpu_cb, gpu_cb

    # (c) generate() with int8 and fp8 weights
    ids, mask = prompts(np.random.default_rng(22), 2, 96, [96, 70], 128256)
    for qd in ("int8", "f8e4m3"):
        kw = dict(layers=L, dtype="float32", batch=2, seq_len=256, ctx_len=128,
                  output_logits=True, quantized=True, quantization_dtype=qd)
        cpu_app, _ = make_app(ml, TorchConfig, ODSC, App, dense, device="cpu", **kw)
        gpu_app, _ = make_app(ml, TorchConfig, ODSC, App, dense, device="cuda",
                              params=cpu_app.params, **kw)
        leaf = gpu_app.params["layers"]["mlp"]["up_proj"]["qw"]
        assert leaf.dtype == {"int8": torch.int8, "f8e4m3": torch.float8_e4m3fn}[qd], leaf.dtype
        ct, cl = static_logits(torch, cpu_app, Adapter, ids, mask, 16)
        gt, gl = static_logits(torch, gpu_app, Adapter, ids, mask, 16)
        err = max((a - b).abs().max().item() for a, b in zip(cl, gl))
        assert np.array_equal(ct, gt), f"phase 4e {qd} weights: tokens differ"
        assert err <= LOGIT_TOL, f"phase 4e {qd} weights: logits differ by {err}"
        out[f"weights_{qd}_err"] = err
        log(f"[quant-2L] {qd} weights: generate() tokens identical, max logit diff {err:.3g}")
        del cpu_app, gpu_app

    # (d) the disaggregated pair on the card against the unified card engine
    geo = dict(layers=L, dtype="float32", kvq=E4M3_PT, slots=4, ctx_len=256, num_blocks=24,
               chunk=128, device="cuda")
    pre_app, dec_app, arch = pair_apps(torch, mods, **geo)
    uni, _ = make_engine_app(ml, TorchConfig, ODSC, App, dense, params=pre_app.params, layers=L,
                             dtype="float32", slots=4, seq_len=512, ctx_len=256, num_blocks=24,
                             chunk=128, block_tkg=True, device="cuda", kv_quant_config=E4M3_PT)
    prompts_ = [rng.integers(1, arch.vocab_size, n).tolist() for n in (40, 200, 129, 7)]
    count = _count_launches()
    streams, handoffs, _, (pre, dec, _) = run_pair(torch, pre_app, dec_app, prompts_, 10)
    pair_counts = count()
    from nxdi_tpu_torch.serving import InferenceEngine, SchedulerConfig

    eng = InferenceEngine(uni, SchedulerConfig(prefix_cache=True))
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=10)) for p in prompts_]
    got = {o.request_id: o.token_ids for o in eng.run()}
    assert streams == [got[r.request_id] for r in reqs], "phase 4e: the pair's streams differ"
    assert pre.handoff_exports == dec.handoff_imports == len(prompts_)
    assert pair_counts["paged_decode"] == L * dec.dispatches["token_generation_model"] > 0
    assert pair_counts["prefill"] == L * pre.dispatches[TAG_CONTEXT_ENCODING]
    out.update(pair_counts=pair_counts, pair_bytes=[h[2] for h in handoffs])
    log(f"[quant-2L] disaggregated pair (e4m3 pools) = unified engine over {len(prompts_)} "
        f"requests; bytes per handoff {[h[2] for h in handoffs]}; launches {pair_counts}")
    return out


# ---------------------------------------------------------------------------
# phase 5e: full depth on quantized stores and weights; disaggregation; arrivals
# ---------------------------------------------------------------------------


def timed_generate(torch, Adapter, app, ids, mask, new, **gen_kw):
    """generate() with the host time of every step's token: (prefill ms,
    decode ms/step, tokens). ``gen_kw``: more generate() arguments
    (``adapter_ids``)."""
    from nxdi_tpu_torch.generation import hf_adapter as hfa

    stamps, inner = [], hfa.extract_next_tokens

    def fetch(outputs):
        toks = inner(outputs)
        stamps.append(time.perf_counter())
        return toks

    hfa.extract_next_tokens = fetch
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = Adapter(app).generate(ids, attention_mask=mask, max_new_tokens=new, **gen_kw)
        torch.cuda.synchronize()
    finally:
        hfa.extract_next_tokens = inner
    return (stamps[0] - t0) * 1e3, (stamps[-1] - stamps[0]) * 1e3 / (len(stamps) - 1), toks


def latency_stats(stamps, arrivals, new, wall):
    """tok/s, TTFT p50 / p95 and TPOT p50 (ms) of a run from each request's
    token stamps and arrival."""
    import numpy as np

    ttft = np.array([stamps[i][0] - arrivals[i] for i in arrivals]) * 1e3
    tpot = np.array([(stamps[i][-1] - stamps[i][0]) / (len(stamps[i]) - 1)
                     for i in arrivals]) * 1e3
    return dict(tok_s=len(arrivals) * new / wall, ttft_p50_ms=float(np.percentile(ttft, 50)),
                ttft_p95_ms=float(np.percentile(ttft, 95)),
                tpot_p50_ms=float(np.percentile(tpot, 50)), wall_s=wall)


def quant_full_depth(torch, np, mods, card, slice_times, unified):
    """Phase 5e, 16 layers, bf16: (a) 5b's and 5c's traffic on an e4m3
    per-tensor pool (the pool exactly half 5b's bytes); (b) phase 5's decode
    with int8 and fp8 weights (the weight-only dequant in eager torch, each
    bucket a CUDA graph) and with an e4m3 KV cache (the one-byte commit),
    beside phase 5's graph sync; (c) a disaggregated pair over 5b's requests
    (all arriving at once) at bf16 and e4m3, beside the unified engine under
    the same arrivals: tok/s, TTFT, TPOT, export and import ms per request,
    bytes per handoff; (d) drive_arrivals + goodput_summary over a Poisson
    run of 5b's requests (seed 17, rescaled so the last arrival lands at
    16 / rate) on the unified engine at half the request rate it sustained
    in (c). Returns (stats, the one-byte rows' launches)."""
    from nxdi_tpu_torch.serving import InferenceEngine, SamplingParams, SchedulerConfig
    from nxdi_tpu_torch.serving.workload import drive_arrivals, goodput_summary

    ml, TorchConfig, ODSC, App, dense, Adapter = mods
    out, launches = {}, {}
    base_app, base = unified["app"], unified
    # (a) the split and mixed engines on the e4m3 pool
    for mixed in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        counts, st = engine_full_depth(torch, np, mods, card, mixed=mixed, kvq=E4M3_PT)
        st.pop("prompts")
        out["mixed_e4m3" if mixed else "split_e4m3"] = st
        launches.update({k: counts[k] for k in (("ragged",) if mixed
                                                else ("paged_prefill", "paged_decode"))})
    assert 2 * out["split_e4m3"]["pool_bytes"] == base["pool_bytes"], "the e4m3 pool is not half"

    # (b) phase 5's decode with quantized weights, and with an e4m3 KV cache
    B, P, NEW, L = 8, 1024, 32, 16
    ids, mask = prompts(np.random.default_rng(11), B, P, [P, P, 1000, P, 731, P, P, 1023],
                        128256)
    common = dict(layers=L, dtype="bfloat16", batch=B, seq_len=2048, ctx_len=P, device="cuda")
    weights = {}
    for name, extra in (("int8", dict(quantized=True, quantization_dtype="int8")),
                        ("fp8", dict(quantized=True, quantization_dtype="f8e4m3")),
                        ("e4m3 KV", dict(kv_quant_config=dict(dtype="float8_e4m3")))):
        gc.collect()
        torch.cuda.empty_cache()
        app, _ = make_app(ml, TorchConfig, ODSC, App, dense, **common, **extra)
        count = _count_launches()
        pre_ms, step_ms, toks = timed_generate(torch, Adapter, app, ids, mask, NEW)
        pre_ms, step_ms, toks = timed_generate(torch, Adapter, app, ids, mask, NEW)  # warm
        c = count()
        assert np.all((toks >= 0) & (toks < 128256)), name
        decode_busy = profiled_call(torch, lambda: app.forward(
            toks[:, -1:].astype(np.int32), np.full((B, 1), P + NEW, np.int32),
            last_token_index=np.zeros((B,), np.int32)))[1]
        weights[name] = dict(prefill_ms=pre_ms, decode_ms_per_step=step_ms,
                             phase_5_graph_sync_ms_per_step=slice_times["decode_ms_per_step"],
                             tok_s=B / step_ms * 1e3, decode_busy_ms=decode_busy,
                             launches=c, warmup=app.warm_stats)
        if name == "e4m3 KV":
            assert app.kv_cache["k"].dtype == torch.float8_e4m3fn
            launches["commit"] = c["commit"] // 2  # one generate() of the two
            assert c["commit"] == 2 * (NEW - 1) and c["decode"] == 2 * L * (NEW - 1), c
        log(f"[quant-16L] {name}: prefill {pre_ms:.2f} ms, decode {step_ms:.3f} ms/step "
            f"({B / step_ms * 1e3:.1f} tok/s), a decode step's device busy {decode_busy:.3f} ms; "
            f"phase 5 graph sync {slice_times['decode_ms_per_step']:.3f} ms/step; "
            f"{card}")
        del app
    out["static"] = weights

    # (c) the disaggregated pair beside the unified engine, all 16 requests at once
    NEWE = 32
    reqs = unified["prompts"]
    stamps, arrivals = {}, {}
    eng = InferenceEngine(base_app, SchedulerConfig(prefix_cache=True))

    def on_token(req, tok):
        stamps.setdefault(req.request_id, []).append(time.perf_counter())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in reqs:
        arrivals[eng.add_request(p, SamplingParams(max_new_tokens=NEWE),
                                 on_token=on_token).request_id] = t0
    uni_streams = {}
    for o in eng.run():
        uni_streams[o.request_id] = o.token_ids
    torch.cuda.synchronize()
    uni_wall = time.perf_counter() - t0
    out["unified_at_once"] = latency_stats(stamps, arrivals, NEWE, uni_wall)
    uni_in_order = [uni_streams[r] for r in sorted(uni_streams)]
    for label, kvq in (("bf16", None), ("e4m3", E4M3_PT)):
        gc.collect()
        torch.cuda.empty_cache()
        pre_app, dec_app, _ = pair_apps(torch, mods, layers=L, dtype="bfloat16", kvq=kvq, slots=8,
                                        ctx_len=1024, num_blocks=136, chunk=512, device="cuda",
                                        params=base_app.params)
        pstamps = {}
        count = _count_launches()
        streams, handoffs, wall, (pre, dec, parr) = run_pair(torch, pre_app, dec_app, reqs, NEWE,
                                                             pstamps)
        c = count()
        h = np.array(handoffs)
        st = latency_stats(pstamps, parr, NEWE, wall)
        st.update(export_ms_p50=float(np.percentile(h[:, 0], 50)),
                  import_ms_p50=float(np.percentile(h[:, 1], 50)),
                  bytes_per_handoff_mean=float(h[:, 2].mean()), handoffs=len(handoffs),
                  launches=c, prefill_dispatches=dict(pre.dispatches),
                  decode_dispatches=dict(dec.dispatches))
        # bf16 at full depth: a batch of other rows can move a near-tied
        # argmax, so the streams are counted, not required equal (phase 4e
        # holds the pair to the unified engine in float32)
        st["streams_equal_to_unified"] = sum(a == b for a, b in zip(streams, uni_in_order))
        assert all(len(s) == NEWE for s in streams)
        out[f"pair_{label}"] = st
        log(f"[quant-16L] disaggregated pair, {label} pools: {st['tok_s']:.1f} tok/s, TTFT p50 "
            f"{st['ttft_p50_ms']:.2f} ms p95 {st['ttft_p95_ms']:.2f}, TPOT p50 "
            f"{st['tpot_p50_ms']:.3f} ms; export {st['export_ms_p50']:.3f} ms, import "
            f"{st['import_ms_p50']:.3f} ms per request (p50), {st['bytes_per_handoff_mean']:.0f} "
            f"bytes per handoff; unified engine, same arrivals: "
            f"{out['unified_at_once']['tok_s']:.1f} tok/s, TTFT p50 "
            f"{out['unified_at_once']['ttft_p50_ms']:.2f} ms, TPOT p50 "
            f"{out['unified_at_once']['tpot_p50_ms']:.3f} ms; streams equal to the unified "
            f"engine's {st['streams_equal_to_unified']} of {len(reqs)}; {card}")
        del pre_app, dec_app, pre, dec

    # (d) the open-loop driver at half the unified engine's request rate
    # 16 Poisson gaps (seed 17), rescaled so the last arrival lands at
    # 16 / rate: a draw this short can end far from its nominal span, and
    # the run is to be at half the sustained rate
    rate = 0.5 * len(reqs) / uni_wall
    gaps = np.cumsum(np.random.default_rng(17).exponential(1 / rate, len(reqs)))
    drawn_span = float(gaps[-1])
    arrivals_s = gaps * (len(reqs) / rate) / drawn_span
    eng = InferenceEngine(base_app, SchedulerConfig(prefix_cache=True))

    def submit(engine, i, arrival_s):
        engine.add_request(reqs[i], SamplingParams(max_new_tokens=NEWE), arrival_s=arrival_s)

    outs, wall = drive_arrivals(eng, arrivals_s, submit)
    summary = goodput_summary(outs, wall)
    assert summary["requests"] == len(reqs) and summary["errors"] == 0
    summary.update(rate_req_s=rate, sustained_req_s=len(reqs) / uni_wall,
                   drawn_span_s=drawn_span, drawn_rate_req_s=len(reqs) / drawn_span,
                   arrival_span_s=float(arrivals_s[-1]),
                   realized_rate_req_s=len(reqs) / float(arrivals_s[-1]))
    out["arrivals"] = summary
    log(f"[quant-16L] drive_arrivals (Poisson, seed 17, rescaled from a drawn span of "
        f"{drawn_span:.3f} s) at {rate:.2f} req/s (half of {len(reqs) / uni_wall:.2f}); last "
        f"arrival at {arrivals_s[-1]:.3f} s: {summary}; {card}")
    return out, launches


# ---------------------------------------------------------------------------
# phases 4f and 5f: speculative decoding
# ---------------------------------------------------------------------------

MC_TREE = [[0], [1], [0, 0], [0, 1], [1, 0], [0, 0, 0]]  # the JAX package's Medusa test tree
SPEC_TAGS = ("fused_speculation_model", "medusa_speculation_model")


def spec_params(ml, dense, torch, *, layers, dtype, device, heads=0):
    """The speculation runs' weights, all random from seeds at Llama-3.2-1B's
    width: the target (seed 0: phases 4 and 5's weights), a 2-layer draft
    (seed 1), ``heads`` Medusa heads (seed 2) in the checkpoint's layout
    after conversion (ResBlock weight and bias, a head lm_head over the
    padded vocab), and two 1-layer EAGLE drafts (seed 1,
    ``llama_eagle.random_params``): "eagle" (the target's vocab and lm_head)
    and "eagle3" (fc_features over the target's aux layers, a
    EAGLE3_DRAFT_VOCAB-token head and a d2t table)."""
    def arch_of(n):
        cfg = ml.LlamaInferenceConfig(_spec_tc(ml, dtype=dtype),
                                      **dict(ml.LLAMA_3_2_1B, num_hidden_layers=n))
        return ml.build_arch(cfg)

    from nxdi_tpu_torch.runtime.device import resolve_device

    device = resolve_device(device)
    arch = arch_of(layers)
    out = {"target": dense.random_params(arch, seed=0, device=device),
           "weak": dense.random_params(arch_of(2), seed=1, device=device)}
    if heads:
        g = torch.Generator(device=device).manual_seed(2)
        Hd, V, dt = arch.hidden_size, arch.vocab_size, out["target"]["norm"].dtype

        def rnd(*shape):
            return (torch.randn(shape, generator=g, device=device) * 0.02).to(dt)

        out["heads"] = {"res_w": rnd(heads, Hd, Hd), "res_b": rnd(heads, Hd),
                        "head": rnd(heads, Hd, V)}
    from nxdi_tpu_torch.models import llama_eagle as le

    for name in ("eagle", "eagle3"):
        out[name] = le.random_params(eagle_draft_cfg(ml, dtype=dtype, eagle3=name == "eagle3"),
                                     out["target"], target_num_layers=layers, seed=1,
                                     device=device)
    return out


EAGLE3_DRAFT_VOCAB = 32000  # phases 4g / 5g: EAGLE3's reduced draft vocab
EAGLE_TREE = [[0], [1], [0, 0], [0, 1], [1, 0], [0, 0, 0], [0, 1, 0]]  # the JAX package's EAGLE
# test tree
EAGLE_DYNAMIC = dict(branching_factor=2, num_inputs=2)  # steps = spec_len


def eagle_draft_cfg(ml, *, eagle3, **tc):
    """A 1-layer EAGLE draft's config at Llama-3.2-1B's width (EAGLE3: the
    reduced vocab)."""
    from nxdi_tpu_torch.models import llama_eagle as le

    width = dict(ml.LLAMA_3_2_1B, num_hidden_layers=1)
    if eagle3:
        width["vocab_size"] = EAGLE3_DRAFT_VOCAB
    return le.LlamaEagleInferenceConfig(_spec_tc(ml, is_eagle3=eagle3, **tc), **width)


def _spec_tc(ml, **kw):
    from nxdi_tpu_torch.config import TorchConfig

    return TorchConfig(**kw)


EAGLE_KINDS = ("eagle", "eagle3", "eagle tree", "eagle dynamic")


def make_spec_app(mods, kind, params, *, draft, layers, dtype, batch, seq_len, ctx_len, device,
                  spec_len=4, graphs=True, tree=None, eagle_tree=EAGLE_TREE):
    """A speculation app, loaded and warmed up: ``kind`` "fused" or
    "standard" with ``draft`` "perfect" (the target's weights and depth) or
    "weak" (2 layers, seed 1); "chain" or "tree" (Medusa: the heads in
    ``params``, ``tree`` its path list); an EAGLE kind (``EAGLE_KINDS``: the
    chain with the "eagle" or "eagle3" draft, the static tree
    ``eagle_tree`` or the dynamic tree of ``spec_len`` steps, with the
    "eagle" draft)."""
    from nxdi_tpu_torch.models import llama_eagle as le
    from nxdi_tpu_torch.speculation import (
        EagleSpecCausalLM,
        FusedSpecCausalLM,
        MedusaCausalLM,
        StandardSpecCausalLM,
    )

    ml, TorchConfig, ODSC, App, dense, _ = mods
    base = dict(tp_degree=1, batch_size=batch, seq_len=seq_len, max_context_length=ctx_len,
                dtype=dtype, on_device_sampling_config=ODSC(), attn_kernel_enabled=True,
                attn_tkg_kernel_enabled=True, skip_warmup=True)

    def cfg(n, **extra):
        return ml.LlamaInferenceConfig(TorchConfig(**base, **extra),
                                       **dict(ml.LLAMA_3_2_1B, num_hidden_layers=n))

    d_layers = layers if draft == "perfect" else 2
    d_params = params["target"] if draft == "perfect" else params["weak"]
    if kind == "fused":
        pair = {"target": params["target"], "draft": d_params}

        class Fused(FusedSpecCausalLM):
            def build_params(self):
                return pair

        app = Fused("<t>", cfg(layers, speculation_length=spec_len,
                               enable_fused_speculation=True),
                    "<d>", cfg(d_layers), model_family=ml, device=device, graphs=graphs)
    elif kind in EAGLE_KINDS:
        eagle3 = kind == "eagle3"
        ttc = ({"choices": eagle_tree} if kind == "eagle tree" else
               {"dynamic": dict(EAGLE_DYNAMIC, steps=spec_len)} if kind == "eagle dynamic"
               else None)
        pair = {"target": params["target"], "draft": params["eagle3" if eagle3 else "eagle"]}

        class Eagle(EagleSpecCausalLM):
            def build_params(self):
                return pair

        app = Eagle("<t>", cfg(layers, speculation_length=spec_len,
                               enable_eagle_speculation=True, is_eagle3=eagle3,
                               token_tree_config=ttc),
                    "<d>", eagle_draft_cfg(ml, eagle3=eagle3, **base), model_family=ml,
                    draft_family=le, device=device, graphs=graphs)
    elif kind == "standard":
        app = StandardSpecCausalLM("<t>", cfg(layers, speculation_length=spec_len), "<d>",
                                   cfg(d_layers), model_family=ml, device=device, graphs=graphs)
        app.target.build_params = lambda: params["target"]
        app.draft.build_params = lambda: d_params
    else:
        K = params["heads"]["res_w"].shape[0]
        full = dict(params["target"], medusa_heads=params["heads"])

        class Medusa(MedusaCausalLM):
            def build_params(self):
                return full

        app = Medusa("<t>", cfg(layers, is_medusa=True, num_medusa_heads=K,
                                medusa_speculation_length=K + 1,
                                medusa_tree=tree if kind == "tree" else None),
                     model_family=ml, device=device, graphs=graphs)
    app.load()
    t = time.perf_counter()
    for a in ((app.target, app.draft) if kind == "standard" else (app,)):
        if a.device.type == "cuda":
            a.warmup()
    app.warm_s = time.perf_counter() - t
    return app


def spec_caches(app):
    """Every cache tensor of a speculation app, by name."""
    caches = ({"target": app.target.kv_cache, "draft": app.draft.kv_cache}
              if hasattr(app, "target") else {"": app.kv_cache})
    out = {}
    for name, cache in caches.items():
        for k, v in cache.items():
            if isinstance(v, dict):
                out.update({f"{name}{k}.{kk}": vv for kk, vv in v.items()})
            else:
                out[f"{name}.{k}"] = v
    return out


def spec_run(torch, Adapter, app, ids, mask, new):
    """generate() on a speculation app: (tokens, each window's counts, the
    launch counts, prefill ms, decode ms, windows, emitted tokens)."""
    from nxdi_tpu_torch.generation import hf_adapter as hfa
    from nxdi_tpu_torch.ops.kernels import launch_counters

    windows = []
    inner_fwd, inner_fetch = app.forward, hfa.extract_next_tokens
    stamps = []

    def fwd(i, p, **kw):
        out = inner_fwd(i, p, **kw)
        if i.shape[1] == 1:
            c = out["counts"]
            windows.append((c.cpu().numpy() if hasattr(c, "cpu") else c).tolist())
        return out

    def fetch(outputs):
        toks = inner_fetch(outputs)
        stamps.append(time.perf_counter())
        return toks

    for fn in launch_counters():
        fn.launches = 0
    w0, a0 = app.spec_windows, app.spec_accepted_tokens
    app.forward, hfa.extract_next_tokens = fwd, fetch
    try:
        if app.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = Adapter(app).generate(ids, attention_mask=mask, max_new_tokens=new)
        if app.device.type == "cuda":
            torch.cuda.synchronize()
        t_end = time.perf_counter()
    finally:
        del app.forward
        hfa.extract_next_tokens = inner_fetch
    by_name = {fn.__name__: fn.launches for fn in launch_counters()}
    counts = {"prefill": by_name["flash_attention_prefill"],
              "decode": by_name["flash_attention_decode_fused"],
              "commit": by_name["kv_commit_rows"]}
    return dict(tokens=out, windows=windows, launches=counts,
                prefill_ms=(stamps[0] - t0) * 1e3, decode_ms=(t_end - stamps[0]) * 1e3,
                n_windows=app.spec_windows - w0, accepted=app.spec_accepted_tokens - a0)


def spec_want_launches(kind, run, *, layers, d_layers, spec_len):
    """The launches a speculation run must count: rows 1 (prefill), 3
    (decode) and 4 (commit), from its windows (a window's counts are all
    its rows'; a standard window at the edge falls back to one step). An
    EAGLE chain window: W draft steps (a stacked fused decode and a commit
    each) and the verify's commit; a tree window: a commit per masked draft
    pass (depth + 1), per target layer of the masked verify, and the
    best-path move on each cache; a context encoding L + 1 prefills."""
    n = run["n_windows"]
    W = spec_len + 1
    if kind in ("eagle", "eagle3"):
        return {"prefill": layers + 1, "decode": n * W, "commit": n * (W + 1)}
    if kind in ("eagle tree", "eagle dynamic"):
        return {"prefill": layers + 1, "decode": 0, "commit": n * (spec_len + 1 + layers + 2)}
    if kind == "fused":
        return {"prefill": layers + d_layers, "decode": n * W * d_layers, "commit": n * (W + 1)}
    if kind == "standard":
        return {"prefill": layers + d_layers, "decode": n * spec_len * d_layers,
                "commit": n * (spec_len + 1)}
    if kind == "chain":
        return {"prefill": layers, "decode": 0, "commit": n}
    return {"prefill": layers, "decode": 0, "commit": n * (layers + 1)}


SPEC_4F = (("fused", 2, "weak"), ("fused", 2, "perfect"), ("fused", 4, "weak"),
           ("fused", 4, "perfect"), ("standard", 4, "weak"), ("standard", 2, "perfect"),
           ("chain", 3, None), ("tree", 3, None))
# phase 4g: EAGLE chain at spec_len 2 and 4, EAGLE3 (the reduced vocab), the
# static tree EAGLE_TREE (depth 3) and the dynamic tree (3 steps, K 2, M 2)
SPEC_4G = (("eagle", 2, None), ("eagle", 4, None), ("eagle3", 4, None), ("eagle tree", 3, None),
           ("eagle dynamic", 3, None))


def spec_vs_cpu(torch, np, mods):
    """Phase 4f: speculation at full width, 2 layers, float32: the fused app
    (spec_len 2 and 4, a weak and a perfect draft), the standard pair and
    Medusa chain and tree (3 random heads, MC_TREE), each on the CPU (plain
    versions), on the card through its graphs and on the card eagerly:
    tokens equal the CPU's and the port's own non-speculative greedy
    stream, every window's counts equal the CPU's, the card's graph run
    equals its eager run (tokens, counts, every cache tensor bit for bit),
    a perfect draft accepts whole fused windows, launch counts exact.
    Phase 4g: the same for EAGLE (SPEC_4G, a random 1-layer draft, seed 1),
    every cache tensor and the features buffer bit for bit graph = eager."""
    ml, TorchConfig, ODSC, App, dense, Adapter = mods
    L, B, NEW = 2, 2, 16
    geo = dict(layers=L, dtype="float32", batch=B, seq_len=256, ctx_len=128)
    cpu = spec_params(ml, dense, torch, layers=L, dtype="float32", device="cpu", heads=3)

    def to_cuda(tree):
        return {k: to_cuda(v) if isinstance(v, dict) else v.cuda() for k, v in tree.items()}

    gpu = {k: to_cuda(v) for k, v in cpu.items()}
    ids, mask = prompts(np.random.default_rng(7), B, 128, [128, 97],
                        ml.LLAMA_3_2_1B["vocab_size"])
    plain = {}
    for dev, params in (("cpu", cpu), ("cuda", gpu)):
        app, _ = make_app(ml, TorchConfig, ODSC, App, dense, device=dev, params=params["target"],
                          **geo)
        plain[dev] = Adapter(app).generate(ids, attention_mask=mask, max_new_tokens=NEW)
        del app
    assert (plain["cpu"] == plain["cuda"]).all(), "phase 4f: the plain streams differ"
    results = {}
    for kind, spec_len, draft in SPEC_4F + SPEC_4G:
        phase = "4g" if kind in EAGLE_KINDS else "4f"
        name = f"{kind} k={spec_len}" + (f" {draft}" if draft else "")
        runs = {}
        t = time.perf_counter()
        for mode, dev, graphs in (("cpu", "cpu", True), ("graphs", "cuda", True),
                                  ("eager", "cuda", False)):
            app = make_spec_app(mods, kind, cpu if dev == "cpu" else gpu, draft=draft,
                                device=dev, spec_len=spec_len, graphs=graphs,
                                tree=MC_TREE, **geo)
            runs[mode] = spec_run(torch, Adapter, app, ids, mask, NEW)
            if mode != "cpu":
                runs[mode]["caches"] = {k: v.clone() for k, v in spec_caches(app).items()}
            if mode == "graphs":
                for tag in SPEC_TAGS:
                    if tag in getattr(app, "models", {}):
                        assert all(bg.graph is not None
                                   for bg in app.models[tag].bucket_graphs.values())
            del app
        g, e, c = runs["graphs"], runs["eager"], runs["cpu"]
        assert (g["tokens"] == e["tokens"]).all(), f"phase {phase} {name}: graph and eager tokens differ"
        assert (g["tokens"] == c["tokens"]).all(), f"phase {phase} {name}: CPU and card tokens differ"
        assert (g["tokens"] == plain["cuda"]).all(), \
            f"phase {phase} {name}: tokens differ from the non-speculative stream"
        assert g["windows"] == e["windows"] == c["windows"], \
            f"phase {phase} {name}: window counts differ {g['windows']} / {c['windows']}"
        for k in g["caches"]:
            assert torch.equal(g["caches"][k], e["caches"][k]), \
                f"phase {phase} {name}: graph and eager {k} differ"
        want = spec_want_launches(kind, g, layers=L, d_layers=L if draft == "perfect" else 2,
                                  spec_len=spec_len)
        if kind in EAGLE_KINDS:
            assert any(k.endswith("features") for k in g["caches"]), "phase 4g: no features"
        assert g["launches"] == e["launches"] == want, \
            f"phase {phase} {name}: launches {g['launches']} / {e['launches']} != {want}"
        if kind == "fused" and draft == "perfect":
            # (the standard pair's draft runs spec_len steps, so after a whole
            # window its cache lacks the last draft token's row, as in the
            # JAX package: it accepts less than whole windows)
            full = [w for w in g["windows"][:-1] if w != [spec_len + 1] * B]
            assert not full, f"phase {phase} {name}: a perfect draft left windows {full}"
        results[name] = dict(phase=phase, windows=len(g["windows"]),
                             mean_accepted=g["accepted"] / max(g["n_windows"], 1) / B,
                             launches=g["launches"], s=time.perf_counter() - t)
        log(f"[spec-2L {phase}] {name}: tokens = CPU = eager = non-speculative; {len(g['windows'])} "
            f"windows, counts = CPU's, caches graph = eager bit for bit; launches "
            f"{g['launches']} ({time.perf_counter() - t:.1f} s)")
    return results


SPEC_5F = (("fused", "perfect"), ("fused", "weak"), ("standard", "perfect"), ("standard", "weak"),
           ("chain", None), ("tree", None))
# phase 5g: (kind, spec_len): the EAGLE chain and EAGLE3 at 4, the static
# tree MC_TREE (depth 3), the dynamic tree of 4 steps, K 2, M 2 (14 nodes)
SPEC_5G = (("eagle", 4), ("eagle3", 4), ("eagle tree", 3), ("eagle dynamic", 4))


def spec_runs_5fg(k_spec):
    """Phases 5f's and 5g's runs in order: (phase, kind, draft, spec_len)."""
    return ([("5f", kind, draft, k_spec) for kind, draft in SPEC_5F]
            + [("5g", kind, None, k) for kind, k in SPEC_5G])


def bf16_ulp(x: float) -> float:
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(abs(x), 1e-30))) - 7)


def f32_ulp(x: float) -> float:
    """The spacing of float32 numbers at |x| (24 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(abs(x), 1e-30))) - 23)


def to_float32(tree):
    """A params tree with every floating tensor in float32 (index tables and
    flags kept)."""
    return {k: to_float32(v) if isinstance(v, dict)
            else v.float() if v.is_floating_point() else v for k, v in tree.items()}


class Witness:
    """The streams' yardstick: a float32 forward, plain attention, of the
    same (bf16-valued) target weights. For a stream, per row, one prefill of
    the prompt and the stream's first ``new - 1`` tokens gives the logits
    that predict each of its ``new`` tokens. It is independent of the
    speculation code and of the kernels: the arithmetic every bf16 or f32
    path of the card approximates."""

    def __init__(self, torch, np, app, params32, ids, lengths, new):
        from nxdi_tpu_torch.models.base import causal_lm_forward

        w = next(iter(app.models.values()))
        self.torch, self.np, self.forward = torch, np, causal_lm_forward
        self.arch = dataclasses.replace(w.arch, dtype="float32", attn_kernel_enabled=False,
                                        attn_tkg_kernel_enabled=False)
        self.inv_freq, self.params = w.inv_freq, params32
        self.ids, self.lengths, self.new = ids, lengths, new

    def logits(self, tokens):
        """(B, new, V) float32 logits on the host: row b, step j predicts
        ``tokens[b, lengths[b] + j]``."""
        from nxdi_tpu_torch.kvcache.kv_cache import init_kv_cache

        torch, out = self.torch, []
        for b, m in enumerate(self.lengths):
            seq = self.np.concatenate([self.ids[b, :m], tokens[b, m:m + self.new - 1]])
            S = len(seq)
            batch = {"input_ids": torch.tensor(seq[None], dtype=torch.int32, device="cuda"),
                     "position_ids": torch.arange(S, dtype=torch.int32, device="cuda")[None],
                     "last_token_index": torch.tensor([S - 1], dtype=torch.int32,
                                                      device="cuda"),
                     "sampling_params": torch.ones((1, 3), device="cuda")}
            cache = init_kv_cache(self.arch.kv_cache_spec(1, S), "cuda")
            with torch.inference_mode():
                o, _ = self.forward(self.arch, self.inv_freq, self.params, cache, batch,
                                    attend_to_cache=False, gather_last_token=False,
                                    output_logits=True, on_device_sampling=False)
            out.append(o["logits"][0, m - 1:m - 1 + self.new].float().cpu())
            del cache, o
        return torch.stack(out)


def margins(torch, tokens, wl, lengths, new):
    """Each emitted token's margin under the witness's logits ``wl``: the
    witness's best logit less the emitted token's, (B, new)."""
    rows = []
    for b, m in enumerate(lengths):
        t = torch.as_tensor(tokens[b, m:m + new].astype("int64"))
        rows.append(wl[b].max(dim=-1).values - wl[b].gather(1, t[:, None])[:, 0])
    return torch.stack(rows)


def stream_check(torch, np, name, spec, ref, ref_logits, witness, eps, lengths, new, step_of):
    """A speculative stream against the witness and the non-speculative
    stream ``ref``. Every token of every row (past a first difference too)
    must be one the witness rates within ``2 * eps`` of its best, where
    ``eps`` is the non-speculative decode's own largest logit distance from
    the witness on its own stream: a path whose logits lie within eps of
    the witness's never picks a token further than 2 eps below the best, so
    the bound comes from the decode path and the witness, not from the code
    under test. Returns (rows equal to ``ref``, [(row, step, ``ref``'s
    top-2 gap there, that gap in steps of the dtype at the top logit,
    ``step_of``)], the largest margin)."""
    mg = margins(torch, spec, witness.logits(spec), lengths, new)
    worst = float(mg.max())
    assert worst <= 2 * eps, (
        f"{name}: an emitted token lies {worst} below the witness's best, beyond twice the "
        f"non-speculative decode's distance from the witness ({eps}): a fault")
    equal, ties = 0, []
    for b, n in enumerate(lengths):
        diff = np.flatnonzero(spec[b, n:n + new] != ref[b, n:n + new])
        if not diff.size:
            equal += 1
            continue
        j = int(diff[0])
        top2 = ref_logits[b, j].topk(2).values
        gap = float(top2[0] - top2[1])
        ties.append((b, j, gap, gap / step_of(float(top2[0]))))
    return equal, ties, worst


# rows 1, 3 and 4 by the kernels they launch (a decode call may add a combine)
SPEC_KERNELS = {"prefill": re.compile(r"prefill_(wgmma_|tc_)?kernel<"),
                "decode": re.compile(r"decode_split_kernel<"),
                "commit": re.compile(r"kv_commit_kernel")}


def profiled_kernel_counts(torch, fn, tries=4):
    """Launches of rows 1, 3 and 4 in one call of ``fn`` as the profiler
    traced them (by kernel name, the most over ``tries`` traced calls: the
    card's machine now and then returns a trace short of kernels)."""
    from torch.profiler import ProfilerActivity, profile

    best = dict.fromkeys(SPEC_KERNELS, 0)
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        for key, rx in SPEC_KERNELS.items():
            n = sum(k.count for k in prof.key_averages() if rx.search(k.key))
            best[key] = max(best[key], n)
    return best


def kernel_sequence(torch, fn):
    """``fn()`` under the profiler: what the device ran, kernels, copies and
    memsets, in order, as (name, device ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    return [(e.name, e.time_range.elapsed_us() / 1e3) for e in evs]


def split_window(torch, window, pieces, tries=4):
    """One window's device time by part, from one trace of the window (a
    graph replay): each part's device work is the run of operations that
    its callable in ``pieces`` launches (traced alone for their names),
    found in the window's sequence in order; what no part matched (the
    acceptance, the staging and token copies, the window's own glue) is
    "acceptance and the rest". Returns ({part: ms}, the trace's busy ms,
    the trace's length), or None when no traced call held every part (the
    card's profiler now and then traces a call short)."""
    for fn in pieces.values():  # once untraced, so no first-call work is traced
        fn()
    want = {part: [n for n, _ in kernel_sequence(torch, fn)] for part, fn in pieces.items()}
    for _ in range(tries):
        seq = kernel_sequence(torch, window)
        names = [n for n, _ in seq]
        parts, at, used = {}, 0, set()
        for part, ws in want.items():
            hit = next((i for i in range(at, len(names) - len(ws) + 1)
                        if names[i:i + len(ws)] == ws), None)
            if hit is None:
                log(f"[split] {part}'s {len(ws)} operations are not in the window's "
                    f"{len(names)} after operation {at}")
                break
            parts[part] = sum(t for _, t in seq[hit:hit + len(ws)])
            used.update(range(hit, hit + len(ws)))
            at = hit + len(ws)
        else:
            parts["acceptance and the rest"] = sum(
                t for i, (_, t) in enumerate(seq) if i not in used)
            return parts, sum(t for _, t in seq), len(seq)
    return None


def spec_pieces(torch, np, app, kind):
    """A window's parts, each a callable that launches, on the app's tensors
    (after a window, at its bucket), what the window launches for that
    part: fused "draft steps" and "verify"; Medusa "verify"; standard
    "draft steps" (the draft app's spec_len dispatches) and "verify" (the
    target's verify dispatch). The acceptance (and, for Medusa, the heads
    and the tree's fix-up) is what the window runs besides
    (:func:`split_window`)."""
    from nxdi_tpu_torch.models.base import causal_lm_forward
    from nxdi_tpu_torch.runtime.model_wrapper import TAG_SPECULATION
    from nxdi_tpu_torch.speculation import fused, token_tree

    if kind in EAGLE_KINDS:
        return eagle_pieces(torch, app)
    if kind == "standard":
        w = app.target.models[TAG_SPECULATION]
        bg = w.bucket_graphs[w.last_bucket]
        toks = bg.bound["input_ids"].cpu().numpy()
        pos = bg.bound["position_ids"].cpu().numpy()
        lti = np.zeros((toks.shape[0],), "int32")

        def draft():  # as the window's loop: each draft token read back to the host
            d_tok, d_pos = toks[:, :1], pos[:, :1]
            for _ in range(app.spec_len):
                o = app.draft.forward(d_tok, d_pos, last_token_index=lti)
                d_tok, d_pos = o["tokens"].cpu().numpy().astype(np.int32), d_pos + 1

        def verify():
            app.target.forward(toks, pos, submodel=TAG_SPECULATION, last_token_index=lti)

        return {"draft steps": draft, "verify": verify}
    tag = SPEC_TAGS[0] if kind == "fused" else SPEC_TAGS[1]
    w = app.models[tag]
    bucket = w.last_bucket
    dev = w.bucket_graphs[bucket].bound
    B = dev["input_ids"].shape[0]
    tok0, pos0 = dev["input_ids"], dev["position_ids"]
    lti = torch.zeros((B,), dtype=torch.int32, device=tok0.device)
    params = app.params["target"] if kind == "fused" else app.params
    cache = app.kv_cache["target"] if kind == "fused" else {"k": app.kv_cache["k"],
                                                            "v": app.kv_cache["v"]}
    if kind == "tree":
        tree = w.tree
        n = tree.num_nodes + 1
        extra = {"position_ids": pos0 + token_tree.tree_tensors(tree, tok0.device)["depth_row"][None],
                 "write_positions": pos0 + torch.arange(n, dtype=torch.int32,
                                                        device=tok0.device)[None],
                 "attn_mask": token_tree.tree_verify_mask(tree, pos0[:, 0], bucket)}
    else:
        n = w.spec_len + 1 if kind == "fused" else w.num_heads + 1
        extra = {"position_ids": pos0 + torch.arange(n, dtype=torch.int32,
                                                     device=tok0.device)[None]}
    tbatch = {"input_ids": tok0.expand(B, n).contiguous(), "last_token_index": lti,
              "sampling_params": dev["sampling_params"], **extra}
    out_kw = (dict(output_argmax_all=True) if kind == "fused"
              else dict(output_logits=True, output_hidden=True))

    def verify():
        with torch.inference_mode():
            causal_lm_forward(w.arch, w.inv_freq, params, cache, tbatch, attend_to_cache=True,
                              kv_window=bucket, layout=w.layout, gather_last_token=False,
                              on_device_sampling=False, **out_kw)

    pieces = {"verify": verify}
    if kind == "fused":
        step = {"last_token_index": lti, "sampling_params": dev["sampling_params"]}

        def draft():
            with torch.inference_mode():
                fused._draft_steps(w.draft_arch, w.draft_inv_freq, app.params["draft"],
                                   app.kv_cache["draft"], tok0, pos0, step, W=w.spec_len + 1,
                                   kv_window=bucket, d_lay=w.draft_layout)

        pieces = {"draft steps": draft, "verify": verify}
    return pieces


def eagle_pieces(torch, app):
    """An EAGLE window's parts (as :func:`spec_pieces`): "draft steps" (the
    chain's steps, or a tree's masked passes with their top-k) and "verify",
    each the window's own function on the app's tensors at the last
    window's bucket."""
    from nxdi_tpu_torch.speculation import eagle, token_tree

    w = app.models[SPEC_TAGS[0]]
    bucket = w.last_bucket
    dev = w.bucket_graphs[bucket].bound
    B = dev["input_ids"].shape[0]
    pos0 = dev["position_ids"]
    tree = w.tree
    d_args = (w.draft_arch, w.draft_inv_freq, app.params, app.kv_cache, dev)
    d_kw = dict(kv_window=bucket, layout=w.draft_layout)
    if tree is None:
        n = w.spec_len + 1
        rope, mask = pos0 + torch.arange(n, dtype=torch.int32, device=pos0.device)[None], None

        def draft():
            eagle.eagle_chain_draft(*d_args, W=n, **d_kw)
    elif isinstance(tree, token_tree.DynamicTreeSpec):
        n = tree.num_nodes + 1
        rows = torch.tensor(tree.depth_rows, dtype=torch.int32, device=pos0.device)
        rope = pos0 + rows[None]
        anc = torch.ones((B, n, n), dtype=torch.bool, device=pos0.device).tril()
        mask = token_tree.dynamic_tree_kv_mask(anc, pos0[:, 0], bucket)

        def draft():
            eagle.eagle_dynamic_tree_draft(*d_args, tree=tree, **d_kw)
    else:
        n = tree.num_nodes + 1
        rope = pos0 + token_tree.tree_tensors(tree, pos0.device)["depth_row"][None]
        mask = token_tree.tree_verify_mask(tree, pos0[:, 0], bucket)

        def draft():
            eagle.eagle_tree_draft(*d_args, tree=tree, **d_kw)
    candidates = dev["input_ids"].to(torch.int32).expand(B, n).contiguous()

    def verify():
        eagle.eagle_verify(w.arch, w.inv_freq, app.params, app.kv_cache, dev, candidates, rope,
                           mask=mask, kv_window=bucket, layout=w.layout, is_eagle3=w.is_eagle3,
                           aux_hidden_indices=w.aux_hidden_indices)

    def under_inference_mode(fn):
        def run():
            with torch.inference_mode():
                fn()
        return run

    return {"draft steps": under_inference_mode(draft), "verify": under_inference_mode(verify)}


def spec_reference(torch, np, Adapter, app, params32, ids, mask, new):
    """The non-speculative greedy stream of ``app`` (made with
    ``output_logits``) with its logits, and the witness (:class:`Witness`)
    with the stream's largest logit distance from it: (stream, logits (B,
    new, V) on the host, witness, eps)."""
    logs = []
    recording(app, logs)
    ref = Adapter(app).generate(ids, attention_mask=mask, max_new_tokens=new)
    ref_logits = torch.stack(logs, dim=1)
    witness = Witness(torch, np, app, params32, ids, mask.sum(axis=1), new)
    eps = float((ref_logits - witness.logits(ref)).abs().max())
    return ref, ref_logits, witness, eps


def spec_full_depth(torch, np, mods, card, slice_stats):
    """Phase 5f: 16 layers, bf16, contiguous cache, graphs, phase 5's
    prompts at batch 8 and at batch 1 (its first row), 32 new tokens: the
    fused app and the standard pair at spec_len 4 with a perfect draft (the
    target's weights) and a 2-layer draft (seed 1), and Medusa with 4
    random heads, chain and MC_TREE. Each: ms per window, mean accepted
    tokens per window and row, ms per accepted token beside phase 5's
    graph-sync decode ms/step, launches of rows 1, 3 and 4 per window
    (checked exactly), one window profiled (busy, wall, idle share) and
    split into its parts from that one trace, and its streams held to the
    float32 witness (:func:`stream_check`) and set beside the
    non-speculative greedy stream. Then the same runs in float32 at batch 8
    (:func:`spec_streams_f32`).

    Phase 5g, in the same loop on the same prompts, references and witness:
    EAGLE (SPEC_5G: the chain and EAGLE3 at spec_len 4, the static tree
    MC_TREE, the dynamic tree of 4 steps; random 1-layer drafts, seed 1)
    measured as 5f measures, each beside 5f's fused 2-layer-draft window;
    its launches are also kept apart (``launches_total_5g``)."""
    from nxdi_tpu_torch.generation import hf_adapter as hfa

    ml, TorchConfig, ODSC, App, dense, Adapter = mods
    L, P, NEW, K_SPEC, HEADS = 16, 1024, 32, 4, 4
    t0 = time.perf_counter()
    params = spec_params(ml, dense, torch, layers=L, dtype="bfloat16", device="cuda", heads=HEADS)
    params32 = to_float32(params)
    ids8, mask8 = prompts(np.random.default_rng(11), 8, P, [P, P, 1000, P, 731, P, P, 1023],
                          ml.LLAMA_3_2_1B["vocab_size"])
    out = {"phase_5_decode_ms_per_step": slice_stats["decode_ms_per_step"], "runs": {}}
    launches_total = {"prefill": 0, "decode": 0, "commit": 0}
    launches_5g = dict.fromkeys(launches_total, 0)
    for B in (8, 1):
        ids, mask = ids8[:B], mask8[:B]
        lengths = mask.sum(axis=1)
        geo = dict(layers=L, dtype="bfloat16", batch=B, seq_len=2048, ctx_len=P, device="cuda")
        # the non-speculative greedy stream, timed, then again with its logits
        ref_app, _ = make_app(ml, TorchConfig, ODSC, App, dense, params=params["target"],
                              output_logits=True, **geo)
        stamps = []
        inner = hfa.extract_next_tokens

        def fetch(o):
            toks = inner(o)
            stamps.append(time.perf_counter())
            return toks

        hfa.extract_next_tokens = fetch
        try:
            torch.cuda.synchronize()
            Adapter(ref_app).generate(ids, attention_mask=mask, max_new_tokens=NEW)
            torch.cuda.synchronize()
            ref_ms = (time.perf_counter() - stamps[0]) * 1e3 / (NEW - 1)
        finally:
            hfa.extract_next_tokens = inner
        ref, ref_logits, witness, eps = spec_reference(torch, np, Adapter, ref_app,
                                                       params32["target"], ids, mask, NEW)
        del ref_app
        if B == 8:
            same = (ref == np.asarray(slice_stats["tokens"])).all()
            log(f"[spec-16L 5f] B 8 non-speculative stream = phase 5's: {bool(same)}")
        log(f"[spec-16L 5f] B {B} non-speculative graph sync decode {ref_ms:.3f} ms/step; its "
            f"logits lie up to {eps:.4g} from the float32 witness's on its own stream")
        out[f"B{B}_non_speculative_ms_per_step"] = ref_ms
        out[f"B{B}_decode_vs_witness_max_logit_diff"] = eps
        for phase, kind, draft, k_spec in spec_runs_5fg(K_SPEC):
            name = f"B{B} {kind}" + (f" {draft}" if draft else "")
            gc.collect()
            torch.cuda.empty_cache()
            t = time.perf_counter()
            app = make_spec_app(mods, kind, params, draft=draft, spec_len=k_spec, tree=MC_TREE,
                                eagle_tree=MC_TREE, **geo)
            build_s = time.perf_counter() - t
            runs = [spec_run(torch, Adapter, app, ids, mask, NEW) for _ in range(2)]
            r = runs[1]
            assert (runs[0]["tokens"] == r["tokens"]).all(), f"phase {phase} {name}: runs differ"
            equal, ties, worst = stream_check(torch, np, f"phase {phase} {name}", r["tokens"], ref,
                                              ref_logits, witness, eps, lengths, NEW, bf16_ulp)
            want = spec_want_launches(kind, r, layers=L, d_layers=L if draft == "perfect" else 2,
                                      spec_len=k_spec)
            for x in runs:
                assert x["launches"] == spec_want_launches(
                    kind, x, layers=L, d_layers=L if draft == "perfect" else 2, spec_len=k_spec), \
                    f"phase {phase} {name}: launches {x['launches']}"
            for k in launches_total:
                launches_total[k] += sum(x["launches"][k] for x in runs)
                if phase == "5g":
                    launches_5g[k] += sum(x["launches"][k] for x in runs)
            n_win = r["n_windows"]
            # the context encoding's prefills (its writes are slice copies)
            per_window = {k: (v - (want["prefill"] if k == "prefill" else 0)) / n_win
                          for k, v in r["launches"].items()}
            window_ms = r["decode_ms"] / n_win
            mean_acc = r["accepted"] / n_win / B
            # one window again (the last one's inputs), unprofiled for its
            # wall, then profiled for the device's busy time and its parts
            cur_tok = np.array([[int(r["tokens"][b, n + NEW - 1])] for b, n in enumerate(lengths)],
                               "int32")
            cur_pos = (lengths + NEW - 1).astype("int32")[:, None]
            lti = np.zeros((B,), "int32")

            def window():
                o = app.forward(cur_tok, cur_pos, last_token_index=lti)
                c = o["counts"]
                return c.cpu() if hasattr(c, "cpu") else c

            wall, split = host_window(torch, window, 8)
            _, busy, by_kernel, _ = profiled_call(torch, window)
            traced = profiled_kernel_counts(torch, window)
            parts = split_window(torch, window, spec_pieces(torch, np, app, kind))
            if parts is None:
                parts_ms, trace_busy, trace_len = None, None, None
                parts_line = "parts: no traced window held every part"
            else:
                parts_ms, trace_busy, trace_len = parts
                parts_line = (f"parts of one traced window ({trace_len} device operations, busy "
                              f"{trace_busy:.3f} ms): " + "; ".join(
                                  f"{k} {v:.3f}" for k, v in parts_ms.items()))
            stats = dict(phase=phase, spec_len=k_spec, window_ms=window_ms,
                         mean_accepted_per_window=mean_acc,
                         ms_per_accepted_token=window_ms / mean_acc, windows=n_win,
                         accepted_tokens=r["accepted"], prefill_ms=r["prefill_ms"],
                         decode_ms=r["decode_ms"], launches=r["launches"],
                         launches_per_window=per_window,
                         profiled_window=dict(wall_ms=wall, busy_ms=busy,
                                              idle_pct=100 * (1 - busy / wall),
                                              parts_ms=parts_ms, parts_trace_busy_ms=trace_busy,
                                              parts_trace_operations=trace_len,
                                              by_group_ms=by_group(by_kernel),
                                              host_split_ms=split),
                         profiled_launches_per_window=traced,
                         rows_equal=equal, first_differences=ties, max_witness_margin=worst,
                         build_s=build_s, warmup_s=app.warm_s)
            out["runs"][name] = stats
            beside = ""
            if phase == "5g":
                fw = out["runs"][f"B{B} fused weak"]
                beside = (f"; 5f's fused 2-layer-draft window {fw['window_ms']:.3f} ms, "
                          f"{fw['ms_per_accepted_token']:.3f} ms per accepted token")
            log(f"[spec-16L {phase}] {name}, {card}: {window_ms:.3f} ms/window, {mean_acc:.2f} "
                f"accepted/window, {window_ms / mean_acc:.3f} ms per accepted token (phase 5 "
                f"{slice_stats['decode_ms_per_step']:.3f} ms/step; non-speculative at B {B} "
                f"{ref_ms:.3f}{beside}); {n_win} windows; launches/window "
                + ", ".join(f"{k} {v:.2f}" for k, v in per_window.items())
                + " (profiled: " + ", ".join(f"{k} {v}" for k, v in traced.items()) + ")"
                + f"; profiled window wall {wall:.3f} busy {busy:.3f} ms (idle "
                f"{100 * (1 - busy / wall):.1f}%); {parts_line}; rows equal to the "
                f"non-speculative stream {equal}/{B}, first differences (row, step, gap, bf16 "
                f"steps) {ties}; largest witness margin {worst:.4g} (bound {2 * eps:.4g})")
            del app
        del witness
    gc.collect()
    torch.cuda.empty_cache()
    out["f32"] = spec_streams_f32(torch, np, mods, params32, ids8, mask8, launches_total,
                                  launches_5g)
    out["launches_total"] = launches_total
    out["launches_total_5g"] = launches_5g
    log(f"[spec-16L 5f] {time.perf_counter() - t0:.1f} s")
    return out


def spec_streams_f32(torch, np, mods, params32, ids, mask, launches_total, launches_5g):
    """Phase 5f's and 5g's runs in float32 (B 8, the same weights held in f32, the
    card's graphs and kernels): each stream held to the witness within twice
    the f32 decode's own distance from it (about 1e-5, where bf16's is about
    0.1: a far tighter yardstick), launches exact, and set beside the f32
    non-speculative stream. Returns per run the rows equal to that stream,
    the first differences and the accepted tokens per window."""
    L, NEW, K_SPEC = 16, 32, 4
    B = ids.shape[0]
    lengths = mask.sum(axis=1)
    geo = dict(layers=L, dtype="float32", batch=B, seq_len=2048, ctx_len=ids.shape[1],
               device="cuda")
    ml, TorchConfig, ODSC, App, dense, Adapter = mods
    ref_app, _ = make_app(ml, TorchConfig, ODSC, App, dense, params=params32["target"],
                          output_logits=True, **geo)
    ref, ref_logits, witness, eps = spec_reference(torch, np, Adapter, ref_app,
                                                   params32["target"], ids, mask, NEW)
    del ref_app
    log(f"[spec-16L 5f f32] B {B} non-speculative logits lie up to {eps:.4g} from the "
        f"witness's on its own stream")
    res = {"decode_vs_witness_max_logit_diff": eps, "runs": {}}
    for phase, kind, draft, k_spec in spec_runs_5fg(K_SPEC):
        name = f"B{B} {kind}" + (f" {draft}" if draft else "")
        gc.collect()
        torch.cuda.empty_cache()
        app = make_spec_app(mods, kind, params32, draft=draft, spec_len=k_spec, tree=MC_TREE,
                            eagle_tree=MC_TREE, **geo)
        r = spec_run(torch, Adapter, app, ids, mask, NEW)
        del app
        want = spec_want_launches(kind, r, layers=L, d_layers=L if draft == "perfect" else 2,
                                  spec_len=k_spec)
        assert r["launches"] == want, \
            f"phase {phase} f32 {name}: launches {r['launches']} != {want}"
        for k in launches_total:
            launches_total[k] += r["launches"][k]
            if phase == "5g":
                launches_5g[k] += r["launches"][k]
        equal, ties, worst = stream_check(torch, np, f"phase {phase} f32 {name}", r["tokens"], ref,
                                          ref_logits, witness, eps, lengths, NEW, f32_ulp)
        mean_acc = r["accepted"] / r["n_windows"] / B
        res["runs"][name] = dict(phase=phase, rows_equal=equal, first_differences=ties,
                                 max_witness_margin=worst, windows=r["n_windows"],
                                 mean_accepted_per_window=mean_acc, launches=r["launches"])
        log(f"[spec-16L {phase} f32] {name}: rows equal to the non-speculative stream {equal}/{B}, "
            f"first differences (row, step, gap, f32 steps) {ties}; largest witness margin "
            f"{worst:.4g} (bound {2 * eps:.4g}); {mean_acc:.2f} accepted/window over "
            f"{r['n_windows']} windows")
    return res


# ---------------------------------------------------------------------------
# phases 3f, 4h and 5h: mixture-of-experts (the Mixtral family); phases 4i
# and 5i: multi-adapter LoRA
# ---------------------------------------------------------------------------

# phase 3f's MoE blocks at two published widths (HF config.json of
# mistralai/Mixtral-8x7B-v0.1 and Qwen/Qwen3-30B-A3B: hidden size, expert
# intermediate, experts, experts per token; both renormalise the top-k)
MOE_BLOCKS = {
    "Mixtral-8x7B": dict(hidden=4096, inter=14336, experts=8, top_k=2),
    "Qwen3-30B-A3B": dict(hidden=2048, inter=768, experts=128, top_k=8),
}
MOE_BLOCK_M = (8, 520)  # phase 3c's decode and packed-chunk rows
MOE_CALLS = 11
# phase 3f: each bf16 dispatch against the float32 dense dispatch over the
# same bf16 weights and input, token by token: |out - ref| / |ref| over a
# token's row (L2 norms). The router runs in float32 in both, so the same
# experts are chosen; the bf16 path then rounds the gate and up outputs,
# the activation's product and the output to bf16, each a relative error
# of at most u = 2**-8 (about u / sqrt(3) RMS), about 0.0045 over the row.
# The limit is 4u; one (token, expert) pair routed or weighted wrongly
# moves its row by its weight, 0.1-0.9 of the row
MOE_BF16_ROW_TOL = 2.0 ** -6
# float32: the per-expert sparse dispatch against the dense one (sums of
# 2048-14336 products)
MOE_F32_TOL = 1e-4
# phase 4h: a Mixtral-shaped model at a width the CPU reference runs in
# float32: Mixtral's head dim 128, 4 query heads per kv head, 8 experts
# top-2, vocabulary and rope theta; hidden 1024, expert intermediate 3584
MOE_SMALL = dict(hidden_size=1024, intermediate_size=3584, num_attention_heads=8,
                 num_key_value_heads=2, head_dim=128)
# phases 4i and 5i: rank-16 adapters on all seven projections, alpha 32
# (scale 2), A and B N(0, 0.02) in the PEFT layout
LORA_RANK = 16
LORA_ALPHA = 32.0
LORA_TARGETS = ["q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"]


def mixtral_family(**widths):
    from nxdi_tpu_torch.models.mixtral import modeling_mixtral as tmx

    return tmx, tmx.MixtralInferenceConfig, dict(tmx.MIXTRAL_8X7B, **widths)


def grouped_mm_probe(torch):
    """What this torch's ``torch._grouped_mm`` takes on the card, by dtype:
    whether an eager call runs (4 groups, one empty) and agrees with the
    per-group products in float32, and whether it is captured into a CUDA
    graph (a host read during capture fails it) and replays the same bits.
    A diagnostic only: ops/moe.grouped_product chooses by dtype and widths."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    ends = [16, 40, 40, 64]
    out = {}
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        x = torch.randn(64, 256, generator=gen, device=dev).to(dt)
        w = torch.randn(4, 256, 128, generator=gen, device=dev).to(dt)
        offs = torch.tensor(ends, dtype=torch.int32, device=dev)
        ref = torch.cat([x[a:b].float() @ w[g].float()
                         for g, (a, b) in enumerate(zip([0] + ends[:-1], ends))])
        try:
            y = torch._grouped_mm(x, w, offs=offs)
            torch.cuda.synchronize()
        except RuntimeError as e:
            out[dname] = f"refused eagerly: {str(e).splitlines()[0][:200]}"
            continue
        err = (y.float() - ref).abs().max().item()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                gy = torch._grouped_mm(x, w, offs=offs)
            graph.replay()
            torch.cuda.synchronize()
            captured = f"captured; replay equals eager bit for bit: {torch.equal(gy, y)}"
        except RuntimeError as e:
            captured = f"capture failed: {str(e).splitlines()[0][:200]}"
        out[dname] = f"runs, max err vs per-group float32 {err:.3g}; {captured}"
    return out


def check_moe_blocks(torch, card):
    """Phase 3f: ``moe_block`` alone in bf16 at Mixtral-8x7B's and
    Qwen3-30B-A3B's widths, M 8 and 520 rows, sparse dispatch (the grouped
    GEMM) beside dense dispatch: each against the float32 dense dispatch
    over the same weights, token by token (MOE_BF16_ROW_TOL), the sparse
    dispatch replayed from a CUDA graph equal to eager, the float32
    per-expert product against float32 dense at M 8 (MOE_F32_TOL); times over MOE_CALLS flushed calls
    beside the bound: the bytes of the experts this routing touches (read
    once) plus the input, router and output, over the HBM rate, or the
    FLOPs of the routed (token, expert) pairs over the bf16 peak."""
    from nxdi_tpu_torch.ops import moe

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)
    scratch = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)

    def flush():
        scratch.zero_()

    def randn(shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
                * std).to(torch.bfloat16)

    def to32(tree):
        return {k: to32(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}

    probe = grouped_mm_probe(torch)
    log(f"[moe-3f] torch {torch.__version__} _grouped_mm on the card: {probe}")
    rows = []
    for name, c in MOE_BLOCKS.items():
        H, I, E, K = c["hidden"], c["inter"], c["experts"], c["top_k"]
        p = {"router": {"w": randn((H, E), 0.02)},
             "experts": {"gate_proj": {"w": randn((E, H, I), 0.02)},
                         "up_proj": {"w": randn((E, H, I), 0.02)},
                         "down_proj": {"w": randn((E, I, H), 0.02)}}}
        p32 = to32(p)
        sparse = moe.MoEArch(num_experts=E, top_k=K, intermediate_size=I, norm_topk_prob=True)
        dense = dataclasses.replace(sparse, dispatch="dense")
        for M in MOE_BLOCK_M:
            x = randn((1, M, H))
            assert moe.moe_strategy(sparse, x) == "moe_sparse_grouped_mm", moe.moe_strategy(sparse, x)
            ref = moe.moe_block(None, dense, p32, x.float())
            got_s = moe.moe_block(None, sparse, p, x)
            got_d = moe.moe_block(None, dense, p, x)
            scale = ref.abs().max().item()
            err_s = (got_s.float() - ref).abs().max().item()
            err_d = (got_d.float() - ref).abs().max().item()
            ref_norm = ref.norm(dim=-1)
            row_s = ((got_s.float() - ref).norm(dim=-1) / ref_norm).max().item()
            row_d = ((got_d.float() - ref).norm(dim=-1) / ref_norm).max().item()
            assert max(row_s, row_d) <= MOE_BF16_ROW_TOL, (name, M, row_s, row_d)
            err32 = None
            if M == 8:
                assert moe.moe_strategy(sparse, x.float()) == "moe_sparse_per_expert"
                err32 = (moe.moe_block(None, sparse, p32, x.float()) - ref).abs().max().item()
                assert err32 <= MOE_F32_TOL, (name, err32)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                g_out = moe.moe_block(None, sparse, p, x)
            graph.replay()
            assert torch.equal(g_out, got_s), f"phase 3f {name} M {M}: replay differs from eager"
            del graph, g_out
            _, idx = moe.route_topk(x.reshape(M, H).float() @ p32["router"]["w"], sparse)
            touched = int(torch.unique(idx).numel())
            nbytes = touched * 3 * H * I * 2 + H * E * 2 + 2 * M * H * 2
            flops = 2 * M * H * E + 2 * M * K * 3 * H * I
            bound, by = bound_ms(nbytes, flops, "bfloat16")
            sparse_ms = measure(torch, lambda: moe.moe_block(None, sparse, p, x), MOE_CALLS, flush)
            dense_ms = measure(torch, lambda: moe.moe_block(None, dense, p, x), MOE_CALLS, flush)
            row = dict(block=name, M=M, hidden=H, inter=I, experts=E, top_k=K,
                       experts_touched=touched, sparse_ms=sparse_ms, dense_ms=dense_ms,
                       bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops,
                       dense_flops=2 * M * H * E + 2 * M * E * 3 * H * I,
                       sparse_err_bf16=err_s, dense_err_bf16=err_d, max_abs_out=scale,
                       sparse_row_err_bf16=row_s, dense_row_err_bf16=row_d,
                       sparse_err_f32=err32, card=card)
            rows.append(row)
            log(f"[moe-3f] {name} M {M} (bf16, {card}): sparse {sparse_ms:.3f} ms, dense "
                f"{dense_ms:.3f} ms, bound {bound:.3f} ms by {by} ({touched}/{E} experts "
                f"touched); vs f32 dense: largest row error sparse {row_s:.4g}, dense "
                f"{row_d:.4g} (limit {MOE_BF16_ROW_TOL:.4g}); max abs err sparse {err_s:.3g}, "
                f"dense {err_d:.3g} (largest |out| {scale:.3g})"
                + (f"; f32 per-expert {err32:.3g}" if err32 is not None else ""))
        del p, p32
        torch.cuda.empty_cache()
    return dict(grouped_mm=probe, blocks=rows)


def moe_vs_cpu(torch, np, mods):
    """Phase 4h: a Mixtral-shaped model (MOE_SMALL), 2 layers, float32, in
    sparse and then dense dispatch: greedy generate() at batch 2 on the CPU,
    the card's graphs and the card eagerly (run_three: tokens equal, logits
    within LOGIT_TOL, graphs equal to eager bit for bit; launches of rows 1,
    3 and 4 exact, every decode bucket's strategy naming the MoE product it
    ran), then the split paged engine the same way (engine_vs_cpu, rows 1,
    6 and 7, the block-table decode)."""
    family = mixtral_family(**MOE_SMALL)
    L, NEW = 2, 16
    out = {}
    for dispatch in ("sparse", "dense"):
        phase = f"4h {dispatch}"
        # the card's per-expert product in float32 (ops/moe.grouped_product)
        moe_name = "moe_dense" if dispatch == "dense" else "moe_sparse_per_expert"
        apps, arch = three_apps(mods, layers=L, dtype="float32", batch=2, seq_len=256,
                                ctx_len=128, output_logits=True, family=family,
                                moe_dispatch=dispatch)
        assert arch.head_dim == 128 and arch.num_attention_heads // arch.num_kv_heads == 4
        ids, mask = prompts(np.random.default_rng(7), 2, 128, [128, 97], arch.vocab_size)
        worst, _, counts, n_same, _ = run_three(torch, mods, phase, apps, ids, mask, NEW)
        want = dict.fromkeys(counts, 0)
        want.update(prefill=L, decode=L * (NEW - 1), commit=NEW - 1)
        assert counts == want, f"phase {phase}: launches {counts} != {want}"
        tkg = apps[1].models["token_generation_model"].attention_strategies
        assert tkg and all(moe_name in ss for ss in tkg.values()), tkg
        del apps
        gc.collect()
        e_counts, e_worst = engine_vs_cpu(torch, np, mods, family=family,
                                          extra=dict(moe_dispatch=dispatch), phase=phase,
                                          extra_strats={moe_name})
        out[dispatch] = dict(generate_max_logit_err=worst, generate_launches=counts,
                             generate_dispatches_bitwise=n_same, engine_max_logit_err=e_worst,
                             engine_launches=e_counts, strategy=moe_name)
        log(f"[moe-2L {phase}] generate(): max logit diff {worst:.3g}, launches {counts}, "
            f"graphs = eager over {n_same} dispatches; engine: max logit diff {e_worst:.3g}, "
            f"launches {e_counts}; decode buckets ran {moe_name}")
        gc.collect()
    return out


def peft_adapter(torch, arch, seed, rank=LORA_RANK, std=0.02):
    """A random PEFT-format adapter on all seven projections of every layer
    (HF layouts: A (r, in), B (out, r)), float32 on the host, from ``seed``."""
    from nxdi_tpu_torch.lora.serving import LORA_TARGETABLE_MODULES

    H, KV, D = arch.num_attention_heads, arch.num_kv_heads, arch.head_dim
    hs, inter = arch.hidden_size, arch.intermediate_size
    dims = {"q_proj": (hs, H * D), "k_proj": (hs, KV * D), "v_proj": (hs, KV * D),
            "o_proj": (H * D, hs), "gate_proj": (hs, inter), "up_proj": (hs, inter),
            "down_proj": (inter, hs)}
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for i in range(arch.num_layers):
        for m in LORA_TARGETS:
            fin, fout = dims[m]
            pre = f"base_model.model.model.layers.{i}.{LORA_TARGETABLE_MODULES[m][1]}.{m}"
            sd[f"{pre}.lora_A.weight"] = torch.randn(rank, fin, generator=g) * std
            sd[f"{pre}.lora_B.weight"] = torch.randn(fout, rank, generator=g) * std
    return sd


def merged_params(params, slot):
    """Base params with slot ``slot``'s adapter merged into the weights,
    W + s * A @ B, and no LoRA buffers."""
    if "lora_A" in params:
        scale = params["lora_scale"][:, slot][:, None, None]
        delta = (params["lora_A"][:, slot] @ params["lora_B"][:, slot]) * scale
        out = {k: v for k, v in params.items() if not k.startswith("lora_")}
        out["w"] = params["w"] + delta.to(params["w"].dtype)
        return out
    return {k: merged_params(v, slot) if isinstance(v, dict) else v for k, v in params.items()}


def lora_vs_cpu(torch, np, mods, family=None, phase="4i"):
    """Phase 4i: Llama-3.2-1B's widths, 2 layers, float32, batch 4, two
    rank-16 adapters on all seven projections and a base row in one batch
    (ids a, b, 0, a; rows 0, 2 and 3 on one prompt): CPU, card graphs, card
    eager (run_three; launches of
    rows 1, 3 and 4 exact). Adapter a's rows equal a base model's whose
    weights have a merged in (W + s A B), on the card. Then a third adapter
    registered after capture evicts a (the least recently used) in place:
    no graph is captured again, the buffers keep their addresses, and the
    next replays give adapter c's tokens, equal to eager and the CPU's.
    Phase 4p runs it on another ``family`` (Gemma at Gemma-2B's attention
    shape)."""
    from nxdi_tpu_torch.lora import lora_pointers

    ml, TorchConfig, ODSC, App, dense, Adapter = mods
    L, NEW, B = 2, 16, 4
    lora = dict(max_loras=2, max_lora_rank=LORA_RANK, target_modules=LORA_TARGETS,
                lora_dtype="float32", lora_alpha=LORA_ALPHA)
    adapter_cfg = {"r": LORA_RANK, "lora_alpha": LORA_ALPHA}
    sds = {}

    def adapter_sd(app, name):
        if name not in sds:
            sds[name] = peft_adapter(torch, app.family.build_arch(app.config),
                                     seed=" abc".index(name))
        return sds[name]

    def setup(app):
        for name in "ab":
            app.set_lora_adapter(name, adapter_sd(app, name), adapter_cfg)

    kw = dict(layers=L, dtype="float32", batch=B, seq_len=256, ctx_len=128, output_logits=True,
              family=family)
    apps, arch = three_apps(mods, setup=setup, lora_config=lora, **kw)
    cpu_app, gpu_app, eager_app = apps
    ids, mask = prompts(np.random.default_rng(7), B, 128, [128, 97, 128, 64], arch.vocab_size)
    # rows 0, 2 and 3 share a prompt: adapter a, the base model, adapter a
    ids[2], mask[2] = ids[0], mask[0]
    ids[3], mask[3] = ids[0], mask[0]
    row_ids = np.array([1, 2, 0, 1])
    assert [gpu_app.lora_adapter_id(n) for n in "ab"] == [1, 2]
    worst, out_ab, counts, n_same, logs_ab = run_three(torch, mods, phase, apps, ids, mask, NEW,
                                                       adapter_ids=row_ids)
    want = dict.fromkeys(counts, 0)
    want.update(prefill=L, decode=L * (NEW - 1), commit=NEW - 1)
    assert counts == want, f"phase {phase}: launches {counts} != {want}"
    # adapter a moves row 0's logits off the base row's (one prompt; the
    # greedy tokens of a random model may still agree)
    moved = max((lg[0] - lg[2]).abs().max().item() for lg in logs_ab)
    assert moved > 100 * LOGIT_TOL, f"phase {phase}: adapter a moved the logits by {moved}"
    assert (out_ab[0] == out_ab[3]).all()

    # adapter a merged into a base model's weights, on the card
    merged_app, _ = make_app(ml, TorchConfig, ODSC, App, dense, device="cuda",
                             params=merged_params(gpu_app.params, 1), **kw)
    logs_lora, logs_merged = [], []
    recording(gpu_app, logs_lora)
    recording(merged_app, logs_merged)
    out_lora = Adapter(gpu_app).generate(ids, attention_mask=mask, max_new_tokens=NEW,
                                         adapter_ids=row_ids)
    out_merged = Adapter(merged_app).generate(ids, attention_mask=mask, max_new_tokens=NEW)
    del gpu_app.forward, merged_app
    merged_err, _, flip = logits_within(torch, f"{phase} merged", logs_merged, logs_lora,
                                        LOGIT_TOL, rows=[0, 3])
    if flip is None:
        assert (out_lora[[0, 3]] == out_merged[[0, 3]]).all(), \
            f"phase {phase}: merged tokens differ"

    # a swap after capture: c evicts a into slot 1, in place
    ptrs = lora_pointers(gpu_app.params)
    def graph_ids():
        return {tag: {k: id(bg.graph) for k, bg in w.bucket_graphs.items()}
                for tag, w in gpu_app.models.items()}

    graphs = graph_ids()
    for app in apps:
        assert app.set_lora_adapter("c", adapter_sd(app, "c"), adapter_cfg) == 1
        assert "a" not in app.adapter_cache.slot_of
    assert lora_pointers(gpu_app.params) == ptrs, f"phase {phase}: a LoRA buffer moved"
    worst_c, out_c, counts_c, n_same_c, logs_c = run_three(torch, mods, f"{phase} swap", apps,
                                                           ids, mask, NEW, adapter_ids=row_ids)
    assert graph_ids() == graphs, f"phase {phase}: the swap captured new graphs"
    # the first replay after the swap (the prefill) reads adapter c on rows
    # 0 and 3; rows 1 and 2 (adapter b, the base) are the same bits as before
    swapped = (logs_c[0][[0, 3]] - logs_ab[0][[0, 3]]).abs().max().item()
    assert swapped > 100 * LOGIT_TOL, f"phase {phase}: the swap moved row 0's logits by {swapped}"
    assert (out_c[[1, 2]] == out_ab[[1, 2]]).all()
    assert all(torch.equal(a[[1, 2]], b[[1, 2]]) for a, b in zip(logs_ab, logs_c))
    log(f"[lora-2L {phase}] rows a, b, base, a: max logit diff {worst:.3g} (tol {LOGIT_TOL}), "
        f"launches {counts}, graphs = eager over {n_same} dispatches; adapter a = merged weights "
        f"(max logit diff {merged_err:.3g} on rows 0 and 3); c swapped in after capture "
        f"(slot 1, buffers in place, no new graph): max logit diff {worst_c:.3g}, graphs = eager "
        f"over {n_same_c} dispatches, rows 0 and 3 moved by {swapped:.3g} (adapter a off the "
        f"base by {moved:.3g}), rows 1 and 2 the same bits")
    return dict(max_logit_err=worst, launches=counts, merged_max_logit_err=merged_err,
                swap_max_logit_err=worst_c, swap_launches=counts_c)


def decode_step_profile(torch, np, app, out_tokens, lengths, new, K=16, **fwd_kw):
    """A decode step of ``app`` repeated after a generate() (the next
    position of each row): K unprofiled steps with the host spans (wall,
    host split), then one under the profiler (device busy, kernels by
    time, the attention kernels by name, the GEMM / MoE / elementwise
    shares) and one traced for its device operations in order (how many
    the step launches)."""
    from nxdi_tpu_torch.generation import hf_adapter as hfa

    B = len(lengths)
    nxt = np.array([[int(out_tokens[b, n + new - 1])] for b, n in enumerate(lengths)], "int32")
    pos = (lengths + new - 1).astype("int32")[:, None]
    lti = np.zeros((B,), "int32")

    def step():
        hfa.extract_next_tokens(app.forward(nxt, pos, last_token_index=lti, **fwd_kw))

    wall, split = host_window(torch, step, K)
    _, busy, by_kernel, _ = profiled_call(torch, step)
    ops = kernel_sequence(torch, step)
    return dict(wall_ms=wall, busy_ms=busy, idle_pct=100 * (1 - busy / wall), host_split_ms=split,
                device_ops=len(ops), attention_ms=attention_ms(by_kernel),
                by_group_ms=by_group(by_kernel), shares_ms=step_shares(by_kernel),
                top=by_kernel[:10])


def moe_full_depth(torch, np, mods, card):
    """Phase 5h: Mixtral-8x7B's widths at 8 of its 32 layers, bf16, graphs.
    generate() on phase 5's prompt shapes (batch 8, 1024 tokens, seed 11 in
    Mixtral's vocabulary), 32 new tokens, sparse and dense dispatch in turns
    (S D D S; dense shares the weights): prefill ms, decode ms/step, tok/s,
    launches of rows 1, 3 and 4 exact, a profiled decode step (busy, idle,
    host split, attention by kernel) and a profiled prefill (its flash
    kernel, the TMA + wgmma body at D 128). Then the split paged engine
    over phase 5b's traffic (engine_full_depth, sparse dispatch, the same
    weights): tok/s, TTFT, TPOT, rows 1, 6 and 7 exact."""
    from nxdi_tpu_torch.generation import hf_adapter as hfa

    ml, TorchConfig, ODSC, App, dense, Adapter = mods
    family = mixtral_family()
    L, B, P, NEW = 8, 8, 1024, 32
    common = dict(layers=L, dtype="bfloat16", batch=B, seq_len=2048, ctx_len=P, device="cuda",
                  output_logits=True, family=family)
    t = time.perf_counter()
    apps = {}
    apps["sparse"], arch = make_app(ml, TorchConfig, ODSC, App, dense, moe_dispatch="sparse",
                                    **common)
    params = apps["sparse"].params
    param_gb = sum(v.numel() * v.element_size() for v in _leaves(params)) / 1e9
    apps["dense"], _ = make_app(ml, TorchConfig, ODSC, App, dense, moe_dispatch="dense",
                                params=params, **common)
    log(f"[moe-8L 5h] 2 apps loaded {time.perf_counter() - t:.1f} s, params {param_gb:.2f} GB; "
        + "; ".join(f"{k} warmup {a.warm_stats}" for k, a in apps.items()))
    ids, mask = prompts(np.random.default_rng(11), B, P, [P, P, 1000, P, 731, P, P, 1023],
                        arch.vocab_size)
    lengths = mask.sum(axis=1)
    kernels = attention_kernels()
    runs = {k: [] for k in apps}
    outs = {}
    for mode in ("sparse", "dense", "dense", "sparse"):
        app = apps[mode]
        for fn in kernels.values():
            fn.launches = 0
        prefill_ms, decode_ms, toks = timed_generate(torch, Adapter, app, ids, mask, NEW)
        counts = {k: fn.launches for k, fn in kernels.items()}
        want = dict.fromkeys(counts, 0)
        want.update(prefill=L, decode=L * (NEW - 1), commit=NEW - 1)
        assert counts == want, f"phase 5h {mode}: launches {counts} != {want}"
        gen = np.stack([toks[b, n:n + NEW] for b, n in enumerate(lengths)])
        assert gen.shape == (B, NEW) and (gen >= 0).all() and (gen < arch.vocab_size).all()
        runs[mode].append(dict(prefill_ms=prefill_ms, decode_ms=decode_ms,
                               tok_s=B * 1e3 / decode_ms, launches=counts))
        outs[mode] = toks
        log(f"[moe-8L 5h] generate() {mode}: prefill {prefill_ms:.2f} ms, decode "
            f"{decode_ms:.3f} ms/step, {B * 1e3 / decode_ms:.1f} tok/s; launches {counts}")
    want_strat = {"sparse": "moe_sparse_grouped_mm", "dense": "moe_dense"}
    for mode, app in apps.items():
        tkg = app.models["token_generation_model"].attention_strategies
        assert all(want_strat[mode] in ss for ss in tkg.values()), (mode, tkg)
    same_rows = int(sum((outs["sparse"][b] == outs["dense"][b]).all() for b in range(B)))
    profiles = {mode: decode_step_profile(torch, np, app, outs[mode], lengths, NEW)
                for mode, app in apps.items()}
    for mode, pr in profiles.items():
        log(f"[moe-8L 5h] {mode} decode step: wall {pr['wall_ms']:.3f} ms, busy "
            f"{pr['busy_ms']:.3f} ms (idle {pr['idle_pct']:.1f}%), {pr['device_ops']} device "
            f"operations; attention {pr['attention_ms']}; by kind {pr['by_group_ms']}; host ms: "
            f"{split_line(pr['host_split_ms'])}")
    app = apps["sparse"]
    wall, busy, by_kernel, split = profiled_call(torch, lambda: hfa.extract_next_tokens(
        app.forward(ids.astype("int32"), np.tile(np.arange(P, dtype="int32"), (B, 1)),
                    last_token_index=(lengths - 1).astype("int32"))))
    attn = attention_ms(by_kernel)
    assert list(attn) == ["prefill_wgmma_kernel"], f"phase 5h prefill ran {attn}"
    prefill = dict(wall_ms=wall, busy_ms=busy, attention_ms=attn, by_group_ms=by_group(by_kernel),
                   top=by_kernel[:10])
    log(f"[moe-8L 5h] sparse profiled prefill: wall {wall:.2f} ms, busy {busy:.3f} ms; flash "
        f"prefill {attn['prefill_wgmma_kernel']:.3f} ms over {L} launches; by kind "
        f"{prefill['by_group_ms']}")
    summary = {mode: {k: float(np.mean([r[k] for r in rs])) for k in ("prefill_ms", "decode_ms",
                                                                      "tok_s")}
               for mode, rs in runs.items()}
    del apps["dense"], app
    gc.collect()
    torch.cuda.empty_cache()
    e_counts, e_stats = engine_full_depth(torch, np, mods, card, layers=L, family=family,
                                          params=params, extra=dict(moe_dispatch="sparse"),
                                          extra_strats={"moe_sparse_grouped_mm"}, phase="5h")
    e_stats.pop("prompts")
    log(f"[moe-8L 5h] {card}: generate() " + "; ".join(
        f"{m} prefill {v['prefill_ms']:.2f} ms decode {v['decode_ms']:.3f} ms/step "
        f"{v['tok_s']:.1f} tok/s" for m, v in summary.items())
        + f"; sparse and dense tokens equal on {same_rows}/{B} rows; split engine "
        f"{e_stats['tok_s']:.1f} tok/s, TTFT p50 {e_stats['ttft_p50_ms']:.2f} ms p95 "
        f"{e_stats['ttft_p95_ms']:.2f} ms, TPOT p50 {e_stats['tpot_p50_ms']:.3f} ms, launches "
        f"{e_counts}")
    del apps, params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(card=card, layers=L, param_gb=param_gb, runs=runs, mean=summary,
                profiled_decode_step=profiles, profiled_prefill=prefill,
                sparse_dense_equal_rows=same_rows, engine=e_stats, engine_launches=e_counts)


def _leaves(tree):
    for v in (tree if isinstance(tree, list) else tree.values()):
        if isinstance(v, (dict, list)):
            yield from _leaves(v)
        else:
            yield v


def lora_full_depth(torch, np, mods, card, slice_stats):
    """Phase 5i: Llama-3.2-1B at 16 layers, bf16, batch 8, graphs, rank-16
    adapters on all seven projections in 4 slots: generate() on phase 5's
    prompts, 32 new tokens, rows on adapters 1, 2, 3, 4, 0, 1, 2, 0 and
    every row on the base slot, in turns (M B B M): decode ms/step beside
    phase 5's graph sync step of the same run, launches of rows 1, 3 and 4
    exact, the base slot's tokens equal to phase 5's (a zero delta adds
    nothing), a profiled decode step of each (busy, idle, host split,
    device operations per step)."""
    ml, TorchConfig, ODSC, App, dense, Adapter = mods
    L, B, P, NEW = 16, 8, 1024, 32
    lora = dict(max_loras=4, max_lora_rank=LORA_RANK, target_modules=LORA_TARGETS,
                lora_dtype="bfloat16", lora_alpha=LORA_ALPHA)
    t = time.perf_counter()
    app, arch = make_app(ml, TorchConfig, ODSC, App, dense, layers=L, dtype="bfloat16", batch=B,
                         seq_len=2048, ctx_len=P, device="cuda", output_logits=True,
                         lora_config=lora)
    for n, name in enumerate("abcd"):
        slot = app.set_lora_adapter(name, peft_adapter(torch, arch, seed=10 + n),
                                    {"r": LORA_RANK, "lora_alpha": LORA_ALPHA})
        assert slot == n + 1
    log(f"[lora-16L 5i] app loaded, 4 adapters resident {time.perf_counter() - t:.1f} s; "
        f"warmup {app.warm_stats}")
    ids, mask = prompts(np.random.default_rng(11), B, P, [P, P, 1000, P, 731, P, P, 1023],
                        arch.vocab_size)
    lengths = mask.sum(axis=1)
    rows = {"mixed": np.array([1, 2, 3, 4, 0, 1, 2, 0], np.int32),
            "base": np.zeros((B,), np.int32)}
    kernels = attention_kernels()
    runs = {k: [] for k in rows}
    outs = {}
    for mode in ("mixed", "base", "base", "mixed"):
        for fn in kernels.values():
            fn.launches = 0
        prefill_ms, decode_ms, toks = timed_generate(torch, Adapter, app, ids, mask, NEW,
                                                     adapter_ids=rows[mode])
        counts = {k: fn.launches for k, fn in kernels.items()}
        want = dict.fromkeys(counts, 0)
        want.update(prefill=L, decode=L * (NEW - 1), commit=NEW - 1)
        assert counts == want, f"phase 5i {mode}: launches {counts} != {want}"
        runs[mode].append(dict(prefill_ms=prefill_ms, decode_ms=decode_ms, launches=counts))
        outs[mode] = toks
        log(f"[lora-16L 5i] {mode} rows: prefill {prefill_ms:.2f} ms, decode {decode_ms:.3f} "
            f"ms/step; launches {counts}")
    assert (outs["base"] == np.array(slice_stats["tokens"])).all(), \
        "phase 5i: the base slot's tokens differ from phase 5's"
    changed = int(sum(not (outs["mixed"][b] == outs["base"][b]).all() for b in range(B)))
    profiles = {mode: decode_step_profile(torch, np, app, outs[mode], lengths, NEW,
                                          adapter_ids=rows[mode]) for mode in rows}
    summary = {mode: {k: float(np.mean([r[k] for r in rs])) for k in ("prefill_ms", "decode_ms")}
               for mode, rs in runs.items()}
    p5 = slice_stats["decode_ms_per_step"]
    p5_prof = slice_stats["profiled_decode_step"]["graph sync"]
    for mode, pr in profiles.items():
        log(f"[lora-16L 5i] {mode} decode step: wall {pr['wall_ms']:.3f} ms, busy "
            f"{pr['busy_ms']:.3f} ms (idle {pr['idle_pct']:.1f}%), {pr['device_ops']} device "
            f"operations; by kind {pr['by_group_ms']}; host ms: {split_line(pr['host_split_ms'])}")
    log(f"[lora-16L 5i] phase 5 graph sync decode step: busy {p5_prof['busy_ms']:.3f} ms (idle "
        f"{p5_prof['idle_pct']:.1f}%), {p5_prof['device_ops']} device operations; by kind "
        f"{p5_prof['by_group_ms']}")
    log(f"[lora-16L 5i] {card}: decode ms/step mixed adapters {summary['mixed']['decode_ms']:.3f}, "
        f"all base {summary['base']['decode_ms']:.3f}, phase 5 graph sync {p5:.3f}; rows changed "
        f"by their adapter {changed}/{B - 2}; base-slot tokens = phase 5's")
    del app
    gc.collect()
    torch.cuda.empty_cache()
    return dict(card=card, runs=runs, mean=summary, phase_5_decode_ms=p5,
                phase_5_profiled_decode_step=p5_prof, profiled_decode_step=profiles,
                rows_changed=changed)


# ---------------------------------------------------------------------------
# phases 3g, 4j and 5j: Multi-head Latent Attention and the DeepSeek family
# ---------------------------------------------------------------------------

# phase 3g's commit at the latent widths: one layer of DeepSeek-V3's 4-layer
# cut (K 64 = qk_rope, V 512 = kv_lora, one kv head), B 8, S 2048 (phase 5j)
MLA_COMMIT = dict(layers=4, batch=8, seq=2048, k=64, v=512)
# phase 3g's fused MLP at DeepSeek-V3's dense MLP (hidden 7168, intermediate
# 18432), the 3-layer stack of its dense head (first_k_dense_replace), at
# the decode step's 8 rows and phase 5j's prefill (batch 8 x 1024 tokens);
# weights N(0, 1/fan_in) so every product keeps unit scale
MLP_V3 = dict(hidden=7168, inter=18432, layers=3)
MLP_V3_M = (8, 8192)
# phase 4j: DeepSeek-V3's head widths (qk_nope 128, qk_rope 64, v 128,
# kv_lora 512, q_lora 1536), its vocabulary and yarn rope; hidden narrowed
# to 1024 (the dense and expert intermediates in V3's ratios), 8 heads, 16
# experts top-4 in 4 groups keeping 2, one shared expert, one dense layer
MLA_SMALL = dict(hidden_size=1024, intermediate_size=2560, moe_intermediate_size=256,
                 num_attention_heads=8, num_key_value_heads=8, n_routed_experts=16,
                 num_experts_per_tok=4, n_group=4, topk_group=2, n_shared_experts=1,
                 first_k_dense_replace=1)
# an MLA layer attends plain: the attention kernel flags raise on the card
MLA_FLAGS = dict(attn_kernel_enabled=False, attn_tkg_kernel_enabled=False)


def deepseek_family(**widths):
    from nxdi_tpu_torch.models.deepseek import modeling_deepseek as tds

    return tds, tds.DeepseekInferenceConfig, dict(tds.DEEPSEEK_V3, **widths)


def check_mla_kernels(torch, results):
    """Phase 3g. Row 4 at the latent widths (MLA_COMMIT): the per-layer
    commit the MLA path launches (one layer's (1, B, 1, S, D) view of the
    stacked cache, one row a line) bit for bit against its plain version in
    bf16 and f32, and a routed 128-row prefill write with lines; bf16 timed
    (DECODE_CALLS flushed calls) beside an empty kernel at its launch shape,
    the plain version and index_put of the same rows. Rows 9/10 at
    DeepSeek-V3's dense MLP (MLP_V3): the stacked entry at layer 2 equal to
    the unstacked call, each M held to its plain version (row 9's
    tolerance), timed (GEMM_CALLS flushed calls) beside three torch
    products; bound: the weights' bytes, or the operations."""
    import torch.nn.functional as F

    from nxdi_tpu_torch.ops.kernels import fused_proj as fp
    from nxdi_tpu_torch.ops.kernels import kv_commit as kc

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(97)
    scratch = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)

    def flush():
        scratch.zero_()

    def randn(shape, dtype, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * std).to(dtype)

    c = MLA_COMMIT
    L, B, S, Dk, Dv = c["layers"], c["batch"], c["seq"], c["k"], c["v"]
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        es = torch.tensor([], dtype=dt).element_size()
        kst, vst = randn((L, B, 1, S, Dk), dt), randn((L, B, 1, S, Dv), dt)
        li = L - 1
        kl, vl = kst[li][None], vst[li][None]  # the layer view layout.update hands the kernel
        kr, vr = randn((1, B, 1, 1, Dk), dt), randn((1, B, 1, 1, Dv), dt)
        slots = torch.tensor([[1000 + 7 * b] for b in range(B)], dtype=torch.int32, device=dev)
        k_ref, v_ref = kl.clone(), vl.clone()
        kc.kv_commit_rows_plain(k_ref, v_ref, kr, vr, slots)
        kc.kv_commit_rows(kl, vl, kr, vr, slots)
        torch.cuda.synchronize()
        assert torch.equal(kl, k_ref) and torch.equal(vl, v_ref), f"3g commit {dname}: not exact"
        # a routed prefill: 128 rows of 3 lines into lines (5, 0, 6), one dropped
        T = 128
        kp, vp = randn((1, 3, 1, T, Dk), dt), randn((1, 3, 1, T, Dv), dt)
        pslots = torch.arange(T, dtype=torch.int32, device=dev)[None].repeat(3, 1)
        pslots[1, -1] = -1
        lines = torch.tensor([5, 0, 6], dtype=torch.int32, device=dev)
        k_ref, v_ref = kl.clone(), vl.clone()
        kc.kv_commit_rows_plain(k_ref, v_ref, kp, vp, pslots, lines)
        kc.kv_commit_rows(kl, vl, kp, vp, pslots, lines)
        torch.cuda.synchronize()
        assert torch.equal(kl, k_ref) and torch.equal(vl, v_ref), \
            f"3g routed commit {dname}: not exact"
        if dname != "bfloat16":
            log(f"[mla-3g] commit float32 at K {Dk} / V {Dv}: exact (decode rows and a routed "
                "prefill)")
            continue
        times, _, _ = traced_times(torch, lambda: kc.kv_commit_rows(kl, vl, kr, vr, slots),
                                   DECODE_CALLS, flush, kernel="kv_commit_kernel")
        ms, lo, hi = spread(times)
        floor, _, _ = traced_times(torch, lambda: kc.empty_launch(B, 128, dev), DECODE_CALLS,
                                   flush, kernel="empty_launch_kernel")
        floor_ms = spread(floor)[0]
        plain_ms = measure(torch, lambda: kc.kv_commit_rows_plain(kl, vl, kr, vr, slots),
                           flush=flush)
        sl, bi, zero = slots[:, 0].long(), torch.arange(B, device=dev), torch.zeros(
            B, dtype=torch.long, device=dev)

        def library_commit():
            kl[:, bi, :, sl] = kr[:, bi, :, zero]
            vl[:, bi, :, sl] = vr[:, bi, :, zero]

        lib_ms = measure(torch, library_commit, flush=flush)
        nbytes = 2 * B * (Dk + Dv) * es  # rows read + written
        bms, by = bound_ms(nbytes, 0, dname)
        results.append(dict(kernel="commit", dtype=dname, point="MLA latent", max_abs_err=0.0,
                            tol=0.0, ms=ms, ms_min=lo, ms_max=hi, launch_floor_ms=floor_ms,
                            plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by,
                            k_width=Dk, v_width=Dv))
        log(f"[mla-3g] commit bfloat16 at K {Dk} / V {Dv}, one layer, B {B}: exact; kernel "
            f"{ms:.4f} ms ({lo:.4f}-{hi:.4f}); empty kernel at its launch shape {floor_ms:.4f}; "
            f"plain {plain_ms:.4f} index_put {lib_ms:.4f} bound {bms:.6f} ({by})")
        del kst, vst, kl, vl, k_ref, v_ref
    torch.cuda.empty_cache()

    m = MLP_V3
    H, I, Ld = m["hidden"], m["inter"], m["layers"]
    dt = torch.bfloat16
    g_s, u_s = randn((Ld, H, I), dt, H ** -0.5), randn((Ld, H, I), dt, H ** -0.5)
    d_s = randn((Ld, I, H), dt, I ** -0.5)
    li = Ld - 1
    for M in MLP_V3_M:
        x = randn((M, H), dt)
        assert torch.equal(fp.fused_mlp_stacked(x, g_s, u_s, d_s, li),
                           fp.fused_mlp(x, g_s[li], u_s[li], d_s[li])), f"3g mlp stacked M={M}"
        row = gemm_point(torch, results, "mlp", "bfloat16", M,
                         lambda: fp.fused_mlp_stacked(x, g_s, u_s, d_s, li),
                         lambda: fp.fused_mlp_plain(x, g_s[li], u_s[li], d_s[li]),
                         lambda: (F.silu(x @ g_s[li]) * (x @ u_s[li])) @ d_s[li],
                         (2 * M * H + 3 * H * I) * 2, 6 * M * H * I, flush)
        row.update(point="DeepSeek-V3", hidden=H, inter=I)
        log(f"[mla-3g] mlp bfloat16 at DeepSeek-V3's H {H} I {I}, M {M}: err "
            f"{row['max_abs_err']:.3g} (limit {row['tol']}); kernel {row['ms']:.4f} ms "
            f"({row['ms_min']:.4f}-{row['ms_max']:.4f}); three torch products "
            f"{row['library_ms']:.4f}; bound {row['bound_ms']:.4f} ({row['bound_by']}); "
            f"{100 * row['bound_ms'] / row['ms']:.1f} % of the bound")
    del g_s, u_s, d_s
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 3h, 4k, 5k: the dense Llama-lineage families
# ---------------------------------------------------------------------------

# phase 3h's points: rows 1, 3 and 4 at Gemma-2B's heads (8 over 1 kv head of
# 256), B 8, S 1024; rows 1 and 3 under Mistral-7B's live window (32 over 8
# heads of 128, window 4096) over 6144-token rows at B 2; rows 9/10 with the
# tanh GELU at Gemma-2B's MLP (H 2048, I 16384)
GEMMA_HEADS = dict(H=8, KV=1, D=256, B=8, S=1024, S_cache=2048, L=2)
MISTRAL_WINDOW = dict(H=32, KV=8, D=128, B=2, S=6144, window=4096, L=2)
GEMMA_MLP = dict(hidden=2048, inter=16384, layers=2)
GEMMA_MLP_M = (8, 8192)
# the stderr tag of the phases that share the 3h helpers
PHASE_TAGS = {"3h": "family-3h", "3i": "moe-family-3i", "3j": "ring-3j", "3l": "mqa-3l"}


def _window_pairs(S, window):
    """Causal (query, key) pairs of an S-row prefill under a sliding window
    (None: all of them)."""
    if window is None:
        return S * (S + 1) // 2
    return sum(min(i + 1, window) for i in range(S))


def family_prefill_point(torch, results, fa, point, q, k, v, pos, window, flush, phase="3h"):
    """Row 1 at one of phase 3h's (or 3i's) points (bf16): against its plain version,
    the same bits on a second call, the body that ran by name, timed over
    PREFILL_CALLS flushed calls beside SDPA (with the window's mask when one
    is set) and the plain version."""
    import torch.nn.functional as F

    B, H, S, D = q.shape
    KV = k.shape[1]
    call = lambda: fa.flash_attention_prefill(q, k, v, pos, pos, sliding_window=window)  # noqa: E731
    plain = lambda: fa.flash_attention_prefill_plain(q, k, v, pos, pos,  # noqa: E731
                                                     sliding_window=window)
    got = call()
    err = (got.float() - plain().float()).abs().max().item()
    tol = TOL[("prefill", "bfloat16")]
    assert err <= tol, f"{phase} prefill {point}: max abs err {err} > {tol}"
    assert torch.equal(call(), got), f"{phase} prefill {point}: a second call gave other bits"
    body = fa.prefill_body(q, k, v)
    times, names, _ = traced_times(torch, call, PREFILL_CALLS, flush, kernel="prefill")
    ms, lo, hi = spread(times)
    ran = sorted(attention_ms([(0.0, n) for n in names]))
    assert ran == [PREFILL_KERNEL[body]], f"{phase} prefill {point}: ran {ran}, expected {body}"
    plain_ms = measure(torch, plain, n=3, flush=flush)
    ke, ve = k.repeat_interleave(H // KV, dim=1), v.repeat_interleave(H // KV, dim=1)
    if window is None:
        library = lambda: F.scaled_dot_product_attention(q, ke, ve, is_causal=True)  # noqa: E731
    else:
        i = torch.arange(S, device=q.device)
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
        library = lambda: F.scaled_dot_product_attention(q, ke, ve, attn_mask=mask)  # noqa: E731
    lib_ms = spread(traced_times(torch, library, PREFILL_CALLS, flush)[0])[0]
    flops = 4 * B * H * D * _window_pairs(S, window)
    bms, by = bound_ms((2 * B * H * S * D + 2 * B * KV * S * D) * 2, flops, "bfloat16")
    row = dict(kernel="prefill", dtype="bfloat16", point=point, head_dim=D, window=window,
               max_abs_err=err, tol=tol, ms=ms, ms_min=lo, ms_max=hi, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=bms, bound_by=by, body=body, kernels=ran,
               share_of_bound=bms / ms)
    results.append(row)
    log(f"[{PHASE_TAGS[phase]}] prefill {point} ({ran[0]}): err {err:.3g} kernel {ms:.4f} ms "
        f"(min {lo:.4f} "
        f"max {hi:.4f}) plain {plain_ms:.4f} sdpa {lib_ms:.4f} bound {bms:.4f} ({by}), "
        f"{100 * bms / ms:.1f} % of the bound")
    del ke, ve
    return row


def family_decode_point(torch, results, fa, point, c, window, flush, gen, phase="3h"):
    """Row 3 (the stacked fused decode, layer 1 of the stack) at one of
    phase 3h's (or 3i's) points through decode_point (bf16: split across blocks and one
    chunk a row, against the plain version; timed beside SDPA over [cache |
    fresh row] under the strict-causal and window mask)."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    B, H, KV, D, L = c["B"], c["H"], c["KV"], c["D"], c["L"]
    S_cache = c.get("S_cache", c["S"])
    G = H // KV
    dt = torch.bfloat16

    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dt)

    ks, vs = randn((L, B, KV, S_cache, D)), randn((L, B, KV, S_cache, D))
    qd = randn((B, 1, H, D)).transpose(1, 2)
    kn, vn = randn((B, 1, KV, D)).transpose(1, 2), randn((B, 1, KV, D)).transpose(1, 2)
    # rows near the end of the cache (the window bites), and one at position 0
    last = S_cache - 1
    qpos = torch.tensor([[last - 37 * b] for b in range(B)], device=dev, dtype=torch.int32)
    if B > 2:
        qpos[-1, 0] = 0
    li = 1
    kcat = torch.cat([ks[li], kn], dim=2).repeat_interleave(G, dim=1)
    vcat = torch.cat([vs[li], vn], dim=2).repeat_interleave(G, dim=1)
    slot = torch.arange(S_cache + 1, device=dev)
    mask = (slot[None, :] < qpos) | (slot[None, :] == S_cache)
    if window is not None:
        mask = mask & ((slot[None, :] > qpos - window) | (slot[None, :] == S_cache))
    mask = mask[:, None, None, :]
    lo = (qpos[:, 0] - window + 1).clamp(min=0) if window is not None else 0 * qpos[:, 0]
    visible = int((qpos[:, 0].clamp(max=S_cache) - lo).clamp(min=0).sum().item())
    row = decode_point(
        torch, results, "decode", "bfloat16", fa,
        lambda: fa.flash_attention_decode_fused_stacked(qd, ks, vs, kn, vn, qpos, li,
                                                        kv_len=S_cache, sliding_window=window),
        lambda: fa.flash_attention_decode_fused_plain(qd, ks[li], vs[li], kn, vn, qpos,
                                                      kv_len=S_cache, sliding_window=window),
        lambda: F.scaled_dot_product_attention(qd, kcat, vcat, attn_mask=mask),
        (2 * KV * D * (visible + B) + 2 * B * H * D) * 2, 4 * H * D * (visible + B), flush,
        TOL[("decode", "bfloat16")])
    row.update(point=point, head_dim=D, window=window)
    log(f"[{PHASE_TAGS[phase]}] decode {point}: the row above ({visible} visible positions)")
    return ks, vs, qpos


def check_family_kernels(torch, results):
    """Phase 3h. Rows 1, 3 and 4 at head dim 256 at Gemma-2B's heads (the
    prefill's mma.sync body reading Q from shared memory; the decode's
    tensor-core tile at 2 warps a block; the commit bit for bit), rows 1 and 3
    under a live window of 4096 at Mistral-7B's heads over 6144-token rows,
    and rows 9/10 with gelu_pytorch_tanh at Gemma-2B's MLP (M 8 and 8192),
    each against its plain version and timed beside its bound, the plain
    version and one library call."""
    import torch.nn.functional as F

    from nxdi_tpu_torch.ops.kernels import flash_attention as fa
    from nxdi_tpu_torch.ops.kernels import fused_proj as fp
    from nxdi_tpu_torch.ops.kernels import kv_commit as kc

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1616)
    scratch = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)

    def flush():
        scratch.zero_()

    def randn(shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
                * std).to(torch.bfloat16)

    for point, c, window in (("Gemma-2B D 256", GEMMA_HEADS, None),
                             ("Mistral-7B window 4096", MISTRAL_WINDOW,
                              MISTRAL_WINDOW["window"])):
        B, H, KV, S, D = c["B"], c["H"], c["KV"], c["S"], c["D"]
        q = randn((B, S, H, D)).transpose(1, 2)
        k, v = randn((B, S, KV, D)).transpose(1, 2), randn((B, S, KV, D)).transpose(1, 2)
        pos = torch.arange(S, device=dev, dtype=torch.int32)[None].expand(B, S).contiguous()
        family_prefill_point(torch, results, fa, point, q, k, v, pos, window, flush)
        del q, k, v
        torch.cuda.empty_cache()
        ks, vs, qpos = family_decode_point(torch, results, fa, point, c, window, flush, gen)
        if point.startswith("Gemma"):
            # row 4 at head dim 256 (one dropped slot), bit for bit, timed
            L = c["L"]
            kr, vr = randn((L, B, KV, 1, D)), randn((L, B, KV, 1, D))
            slots = qpos.clone()
            slots[3, 0] = -1
            k_ref, v_ref = ks.clone(), vs.clone()
            kc.kv_commit_rows_plain(k_ref, v_ref, kr, vr, slots)
            kc.kv_commit_rows(ks, vs, kr, vr, slots)
            torch.cuda.synchronize()
            assert torch.equal(ks, k_ref) and torch.equal(vs, v_ref), "3h commit: not exact"
            times, _, _ = traced_times(torch, lambda: kc.kv_commit_rows(ks, vs, kr, vr, slots),
                                       DECODE_CALLS, flush, kernel="kv_commit_kernel")
            ms, lo, hi = spread(times)
            plain_ms = measure(torch, lambda: kc.kv_commit_rows_plain(ks, vs, kr, vr, slots),
                               flush=flush)
            valid = (slots[:, 0] >= 0).nonzero()[:, 0]
            sl, zero = slots[valid, 0].long(), torch.zeros_like(valid)

            def library_commit():
                ks[:, valid, :, sl] = kr[:, valid, :, zero]
                vs[:, valid, :, sl] = vr[:, valid, :, zero]

            lib_ms = measure(torch, library_commit, flush=flush)
            bms, by = bound_ms(2 * 2 * L * int(valid.numel()) * KV * D * 2, 0, "bfloat16")
            results.append(dict(kernel="commit", dtype="bfloat16", point=point, head_dim=D,
                                max_abs_err=0.0, tol=0.0, ms=ms, ms_min=lo, ms_max=hi,
                                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by))
            log(f"[family-3h] commit {point}: exact; kernel {ms:.4f} ms ({lo:.4f}-{hi:.4f}) "
                f"plain {plain_ms:.4f} index_put {lib_ms:.4f} bound {bms:.6f} ({by})")
        del ks, vs
        torch.cuda.empty_cache()

    m = GEMMA_MLP
    H, I, Lm = m["hidden"], m["inter"], m["layers"]
    g_s, u_s = randn((Lm, H, I), H ** -0.5), randn((Lm, H, I), H ** -0.5)
    d_s = randn((Lm, I, H), I ** -0.5)
    act = "gelu_pytorch_tanh"
    for M in GEMMA_MLP_M:
        x = randn((M, H))
        assert torch.equal(fp.fused_mlp_stacked(x, g_s, u_s, d_s, 1, act=act),
                           fp.fused_mlp(x, g_s[1], u_s[1], d_s[1], act=act)), f"3h mlp M={M}"
        row = gemm_point(torch, results, "mlp", "bfloat16", M,
                         lambda: fp.fused_mlp_stacked(x, g_s, u_s, d_s, 1, act=act),
                         lambda: fp.fused_mlp_plain(x, g_s[1], u_s[1], d_s[1], act),
                         lambda: (F.gelu(x @ g_s[1], approximate="tanh") * (x @ u_s[1]))
                         @ d_s[1],
                         (2 * M * H + 3 * H * I) * 2, 6 * M * H * I, flush)
        row.update(point="Gemma-2B tanh GELU", hidden=H, inter=I, act=act)
        log(f"[family-3h] mlp {act} at Gemma-2B's H {H} I {I}, M {M}: err "
            f"{row['max_abs_err']:.3g} (limit {row['tol']}); kernel {row['ms']:.4f} ms "
            f"({row['ms_min']:.4f}-{row['ms_max']:.4f}); three torch products "
            f"{row['library_ms']:.4f}; bound {row['bound_ms']:.4f} ({row['bound_by']}); "
            f"{100 * row['bound_ms'] / row['ms']:.1f} % of the bound")
    del g_s, u_s, d_s
    torch.cuda.empty_cache()


# phase 4k: every ported dense family at tiny widths (head dims multiples of
# 8 the card's kernels take: Qwen3's 48 decoupled from 256 / 4, Gemma's 256),
# 2 layers, f32; the switches each family sets, windows of 8 under 64-token
# prompts
FAMILY_TINY = dict(hidden_size=256, intermediate_size=512, num_attention_heads=4,
                   num_key_value_heads=2, head_dim=64, vocab_size=512,
                   max_position_embeddings=4096, rms_norm_eps=1e-5, rope_theta=10000.0,
                   tie_word_embeddings=False, hidden_act="silu")
FAMILY_CASES = {
    "mistral": dict(sliding_window=8),
    "qwen2": dict(tie_word_embeddings=True),
    "qwen3": dict(head_dim=48),
    "hunyuan_v1_dense": {},
    "gemma": dict(num_key_value_heads=1, head_dim=256, tie_word_embeddings=True,
                  hidden_act="gelu_pytorch_tanh"),
    "helium": dict(attention_bias=True),
    "ernie4_5": dict(use_bias=True),
    "granite": dict(embedding_multiplier=2.0, attention_multiplier=0.2, residual_multiplier=0.5,
                    logits_scaling=1.5),
    "minicpm": dict(scale_emb=12.0, scale_depth=1.4, dim_model_base=64),
    "seed_oss": dict(attention_bias=True, attention_out_bias=True),
    "internlm3": dict(qkv_bias=True, bias=True),
    "smollm3": dict(no_rope_layers=[1, 0]),
    "olmo2": {},
    "arcee": dict(hidden_act="relu2"),
    "ministral": dict(sliding_window=8, layer_types=["sliding_attention", "full_attention"]),
}


def dense_family(model_type, **widths):
    """(module, config class, widths) of a registered family."""
    from nxdi_tpu_torch.models import registry

    module, cfg_cls = registry.get_family(model_type)
    return module, cfg_cls, widths


def family_flags(arch):
    """The projection kernel flags a family's model takes: the fused QKV
    weight with its kernel always, the fused MLP where the MLP is gated and
    unbiased (the kernel takes no other)."""
    return dict(fused_qkv=True, qkv_kernel_enabled=True,
                mlp_kernel_enabled=arch.gated_mlp and not arch.mlp_bias)


def family_counts(L, n_cte, steps, mlp):
    """The launches of a contiguous generate(): per context encoding L
    prefills, per decode step L stacked decodes and 1 commit, a QKV and (a
    gated MLP) an MLP launch per layer per forward."""
    fwd = n_cte + steps
    return dict(prefill=L * n_cte, paged_prefill=0, paged_decode=0, window_decode=0,
                decode=L * steps, commit=steps, qkv=L * fwd, mlp=L * fwd if mlp else 0)


def family_kernels():
    """counted_kernels and the QKV kernel: the wrappers a family run's
    launches are read from."""
    from nxdi_tpu_torch.ops.kernels import fused_proj as fp

    return dict(counted_kernels(), qkv=fp.qkv_matmul)


def family_vs_cpu(torch, np, mods):
    """Phase 4k: every dense family the registry ports (FAMILY_CASES) at
    tiny widths, 2 layers, float32, batch 2: greedy generate() on the CPU
    (plain versions, the JAX rule: a mixed stack's layers attend plain),
    through the card's graphs and on the card eagerly (run_three: tokens
    equal, logits within LOGIT_TOL, graphs equal to eager bit for bit), every
    enabled kernel flag engaged (attention, QKV and, for a gated MLP, the
    fused MLP: the tanh GELU for Gemma), launches exact."""
    from nxdi_tpu_torch.models import registry

    L, NEW, P = 2, 16, 64
    out = {}
    for model_type, over in FAMILY_CASES.items():
        family = dense_family(model_type, **dict(FAMILY_TINY, **over))
        arch = family[0].build_arch(family[1](mods[1](seq_len=16),
                                              **dict(family[2], num_hidden_layers=L)))
        flags = family_flags(arch)
        apps, arch = three_apps(mods, layers=L, dtype="float32", batch=2, seq_len=256,
                                ctx_len=128, output_logits=True, family=family, **flags)
        ids, mask = prompts(np.random.default_rng(7), 2, P, [P, 53], arch.vocab_size)
        worst, toks, counts, n_same, _ = run_three(torch, mods, f"4k {model_type}", apps, ids,
                                                   mask, NEW, kernels=family_kernels())
        want = family_counts(L, 1, NEW - 1, flags["mlp_kernel_enabled"])
        assert counts == want, f"phase 4k {model_type}: launches {counts} != {want}"
        seen = {s for w in apps[1].models.values() for ss in w.attention_strategies.values()
                for s in ss}
        need = {"cte_flash_kernel", "tkg_fused_kernel_stacked", "qkv_fused_kernel"}
        if flags["mlp_kernel_enabled"]:
            need.add("mlp_fused_kernel")
        assert need <= seen, f"phase 4k {model_type}: strategies {seen} lack {need - seen}"
        assert registry.get_family(model_type)[0] is family[0]
        out[model_type] = dict(max_logit_err=worst, launches=counts, dispatches_bitwise=n_same,
                               head_dim=arch.head_dim, window=arch.sliding_window)
        log(f"[family-2L 4k {model_type}] generate(): max logit diff {worst:.3g}, graphs = eager "
            f"over {n_same} dispatches, launches {counts}")
        del apps
        gc.collect()
    return out


def family_generate(torch, np, mods, tag, app, arch, ids, mask, NEW, flags, profile=True):
    """One timed generate() of a phase 5k app: prefill ms, decode ms/step,
    tok/s, launches by kernel (exact), and a profiled decode step (wall,
    busy, idle, host split, attention by kernel)."""
    Adapter = mods[5]
    kernels = family_kernels()
    for fn in kernels.values():
        fn.launches = 0
    prefill_ms, decode_ms, toks = timed_generate(torch, Adapter, app, ids, mask, NEW)
    counts = {k: fn.launches for k, fn in kernels.items()}
    L = arch.num_layers
    want = family_counts(L, 1, NEW - 1, flags.get("mlp_kernel_enabled", False))
    if not flags.get("qkv_kernel_enabled"):
        want["qkv"] = 0
    assert counts == want, f"{tag}: launches {counts} != {want}"
    lengths = mask.sum(axis=1)
    gen = np.stack([toks[b, n:n + NEW] for b, n in enumerate(lengths)])
    assert (gen >= 0).all() and (gen < arch.vocab_size - arch.vocab_pad).all(), tag
    B = ids.shape[0]
    run = dict(batch=B, prompt=int(ids.shape[1]), prefill_ms=prefill_ms, decode_ms=decode_ms,
               tok_s=B * 1e3 / decode_ms, launches=counts)
    if profile:
        pr = decode_step_profile(torch, np, app, toks, lengths, NEW)
        run["profiled_decode_step"] = pr
        log(f"{tag} decode step: wall {pr['wall_ms']:.3f} ms, busy {pr['busy_ms']:.3f} ms "
            f"(idle {pr['idle_pct']:.1f}%), {pr['device_ops']} device operations; attention "
            f"{pr['attention_ms']}; by kind {pr['by_group_ms']}; host ms: "
            f"{split_line(pr['host_split_ms'])}")
    log(f"{tag} generate() B {B} x {ids.shape[1]}: prefill {prefill_ms:.2f} ms, decode "
        f"{decode_ms:.3f} ms/step, {run['tok_s']:.1f} tok/s; launches {counts}")
    return run, toks


def family_full_depth(torch, np, mods, card):
    """Phase 5k, bf16, graphs, random weights from seed 0 at the published
    widths: Mistral-7B whole (32 layers, window 4096) through generate() at
    B 8 on phase 5's prompt shapes and at B 2 over 6144-token prompts (the
    window bites in the prefill and every decode step); Qwen3-8B cut to 8 of
    36 layers through generate() at B 8 and the split paged engine over
    phase 5b's traffic (rows 1, 6 and 7 at head dim 128); Gemma-2B whole
    (head dim 256, the fused MLP's tanh GELU) through generate() at B 8.
    32 new tokens each; prefill ms, decode ms/step, a profiled decode step,
    launches exact."""
    from nxdi_tpu_torch.models.gemma import modeling_gemma as tg
    from nxdi_tpu_torch.models.mistral import modeling_mistral as tm
    from nxdi_tpu_torch.models.qwen3 import modeling_qwen3 as tq

    ml, TorchConfig, ODSC, App, dense, _ = mods
    NEW, B, P = 32, 8, 1024
    stats = {}
    launches = {}

    def add(name, counts):
        launches[name] = {k: launches.get(name, {}).get(k, 0) + v for k, v in counts.items()}

    def load(name, family, layers, flags, **kw):
        t = time.perf_counter()
        app, arch = make_app(ml, TorchConfig, ODSC, App, dense, layers=layers, dtype="bfloat16",
                             device="cuda", family=family, **flags, **kw)
        gb = sum(v.numel() * v.element_size() for v in _leaves(app.params)) / 1e9
        log(f"[family-5k {name}] {layers} layers loaded {time.perf_counter() - t:.1f} s, params "
            f"{gb:.2f} GB; warmup {app.warm_stats}")
        return app, arch, gb

    # Mistral-7B whole: phase 5's prompt shapes, then 6144-token prompts at B 2
    family = (tm, tm.MistralInferenceConfig, tm.MISTRAL_7B_V01)
    app, arch, gb = load("Mistral-7B", family, 32, {}, batch=B, seq_len=2048, ctx_len=P)
    assert arch.sliding_window == 4096
    ids, mask = prompts(np.random.default_rng(11), B, P, [P, P, 1000, P, 731, P, P, 1023],
                        arch.vocab_size)
    run, _ = family_generate(torch, np, mods, "[family-5k Mistral-7B]", app, arch, ids, mask, NEW,
                             {})
    add("mistral", run["launches"])
    params = app.params
    del app
    gc.collect()
    torch.cuda.empty_cache()
    Pw = MISTRAL_WINDOW["S"]
    app, _, _ = load("Mistral-7B window", family, 32, {}, batch=2, seq_len=Pw + 64, ctx_len=Pw,
                     params=params)
    ids_w, mask_w = prompts(np.random.default_rng(12), 2, Pw, [Pw, Pw - 100], arch.vocab_size)
    run_w, _ = family_generate(torch, np, mods, "[family-5k Mistral-7B window 4096]", app, arch,
                               ids_w, mask_w, NEW, {})
    add("mistral_window", run_w["launches"])
    stats["mistral_7b"] = dict(layers=32, param_gb=gb, window=arch.sliding_window,
                               runs=[run, run_w])
    del app, params
    gc.collect()
    torch.cuda.empty_cache()

    # Qwen3-8B at 8 of 36 layers: generate() at B 8, then the split engine
    family = (tq, tq.Qwen3InferenceConfig, tq.QWEN3_8B)
    app, arch, gb = load("Qwen3-8B", family, 8, {}, batch=B, seq_len=2048, ctx_len=P)
    ids, mask = prompts(np.random.default_rng(11), B, P, [P, P, 1000, P, 731, P, P, 1023],
                        arch.vocab_size)
    run, _ = family_generate(torch, np, mods, "[family-5k Qwen3-8B]", app, arch, ids, mask, NEW,
                             {})
    add("qwen3", run["launches"])
    params = app.params
    del app
    gc.collect()
    torch.cuda.empty_cache()
    e_counts, e_stats = engine_full_depth(torch, np, mods, card, layers=8, family=family,
                                          params=params, phase="5k")
    e_stats.pop("prompts")
    stats["qwen3_8b"] = dict(layers=8, param_gb=gb, runs=[run], engine=e_stats,
                             engine_launches=e_counts)
    log(f"[family-5k Qwen3-8B] split engine {e_stats['tok_s']:.1f} tok/s, TTFT p50 "
        f"{e_stats['ttft_p50_ms']:.2f} ms p95 {e_stats['ttft_p95_ms']:.2f} ms, TPOT p50 "
        f"{e_stats['tpot_p50_ms']:.3f} ms, launches {e_counts}")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # Gemma-2B whole: head dim 256, the fused MLP's tanh GELU
    family = (tg, tg.GemmaInferenceConfig, tg.GEMMA_2B)
    flags = dict(mlp_kernel_enabled=True)
    app, arch, gb = load("Gemma-2B", family, 18, flags, batch=B, seq_len=2048, ctx_len=P)
    assert arch.head_dim == 256 and arch.hidden_act == "gelu_pytorch_tanh"
    ids, mask = prompts(np.random.default_rng(11), B, P, [P, P, 1000, P, 731, P, P, 1023],
                        arch.vocab_size)
    run, _ = family_generate(torch, np, mods, "[family-5k Gemma-2B]", app, arch, ids, mask, NEW,
                             flags)
    add("gemma", run["launches"])
    stats["gemma_2b"] = dict(layers=18, param_gb=gb, runs=[run])
    del app
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[family-5k] {card}: " + "; ".join(
        f"{name} " + ", ".join(f"B {r['batch']} x {r['prompt']}: prefill {r['prefill_ms']:.2f} ms "
                               f"decode {r['decode_ms']:.3f} ms/step" for r in st["runs"])
        for name, st in stats.items()))
    stats["launches"] = launches
    return stats


# ---------------------------------------------------------------------------
# phases 3i, 4l, 5l: the MoE families (Qwen3-MoE, gpt-oss, MiniMax-M2, DBRX,
# Phi-3.5-MoE, AFMoE) and Phi-3
# ---------------------------------------------------------------------------

# phase 3i's points: rows 1, 3, 6 and 7 at the MoE families' query heads per
# kv head, head dim 128: G 8 (Qwen3-30B-A3B: 32 over 4) and G 6 (MiniMax-M2
# and DBRX: 48 over 8). Rows 1 and 3 at phase 5l's B 8 x 1024 prefill and a
# 2-layer stack of 2048 slots; rows 6 and 7 at phase 3b's shapes
MOE_HEADS = {
    "G 8 (Qwen3-30B-A3B)": dict(H=32, KV=4, D=128, B=8, S=1024, S_cache=2048, L=2),
    "G 6 (MiniMax-M2, DBRX)": dict(H=48, KV=8, D=128, B=8, S=1024, S_cache=2048, L=2),
}


def moe_paged_points(torch, results, fa, point, c, flush, gen, phase="3i"):
    """Rows 7 and 6 at one of phase 3i's points (bf16) on phase 3b's pool:
    the paged decode at B 8 over blocks of 128 with a hole (decode_point),
    and the paged prefill of a 512-token chunk after 512 on the TMA + wgmma
    body, each against its plain version and timed beside SDPA over the
    gathered window."""
    import torch.nn.functional as F

    dev, dt = torch.device("cuda"), torch.bfloat16
    H, KV, D = c["H"], c["KV"], c["D"]
    B, bs, nblk, NB, G = 8, 128, 136, 16, H // KV

    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dt)

    qpos = torch.linspace(0, 2000, B, device=dev).long()
    perm = torch.randperm(nblk, generator=torch.Generator().manual_seed(0)).tolist()
    bt = torch.full((B, NB), -1, dtype=torch.int32)
    nxt = 0
    for b in range(B):
        n = int(qpos[b]) // bs + 1
        bt[b, :n] = torch.tensor(perm[nxt:nxt + n], dtype=torch.int32)
        nxt += n
    bt[3, 2] = -1  # a hole inside row 3's attended range
    bt = bt.to(dev)
    slot_pos = torch.arange(NB * bs, device=dev)
    live = torch.repeat_interleave(bt >= 0, bs, dim=1) & (slot_pos[None] <= qpos[:, None])
    visible = int(live.sum())
    kc, vc = randn((nblk * bs, KV, D)), randn((nblk * bs, KV, D))

    def gathered(cache, table, n_rows):
        rows = (table.long()[:, :, None] * bs + torch.arange(bs, device=dev)).reshape(n_rows, -1)
        return cache[rows.clamp(min=0)].transpose(1, 2)

    q = randn((B, 1, H, D)).transpose(1, 2)
    qp = qpos[:, None].to(torch.int32)
    mask = live[:, None, None, :]

    def library_decode():
        kg = gathered(kc, bt, B).repeat_interleave(G, dim=1)
        vg = gathered(vc, bt, B).repeat_interleave(G, dim=1)
        return F.scaled_dot_product_attention(q, kg, vg, attn_mask=mask)

    row = decode_point(
        torch, results, "paged_decode", "bfloat16", fa,
        lambda: fa.paged_attention_decode(q, kc, vc, bt, qp, block_size=bs),
        lambda: fa.paged_attention_decode_plain(q, kc, vc, bt, qp, block_size=bs),
        library_decode, (2 * visible * KV * D + 2 * B * H * D) * 2 + bt.numel() * 4,
        4 * H * D * visible, flush, PAGED_TOL["bfloat16"])
    row.update(point=point, head_dim=D)
    log(f"[{PHASE_TAGS[phase]}] paged_decode {point}: the row above")

    Sq, start = 512, 512
    bt1 = bt[7:8]
    qx = randn((1, Sq, H, D)).transpose(1, 2)
    qpx = (start + torch.arange(Sq, device=dev, dtype=torch.int32))[None]
    body = fa.paged_prefill_body(qx, kc, vc, bs)
    assert body == "wgmma", f"{phase} paged_prefill {point}: body {body}"

    def call():
        return fa.paged_attention_prefill(qx, kc, vc, bt1, qpx, block_size=bs)

    def plain():
        return fa.paged_attention_prefill_plain(qx, kc, vc, bt1, qpx, block_size=bs)

    got = call()
    err = (got.float() - plain().float()).abs().max().item()
    assert torch.equal(call(), got), f"{phase} paged_prefill {point}: a second call gave other bits"
    times, names, _ = traced_times(torch, call, PREFILL_CALLS, flush, kernel="prefill")
    ms, lo, hi = spread(times)
    ran = sorted(attention_ms([(0.0, n) for n in names]))
    assert ran == [PREFILL_KERNEL[body]], f"{phase} paged_prefill {point}: ran {ran}"
    plain_ms = measure(torch, plain, n=3, flush=flush)
    pmask = (slot_pos[None, :] <= qpx[0][:, None])[None, None]

    def library_prefill():
        kg = gathered(kc, bt1, 1).repeat_interleave(G, dim=1)
        vg = gathered(vc, bt1, 1).repeat_interleave(G, dim=1)
        return F.scaled_dot_product_attention(qx, kg, vg, attn_mask=pmask)

    lib_ms = spread(traced_times(torch, library_prefill, PREFILL_CALLS, flush)[0])[0]
    pairs = int(pmask.sum())
    _kernel_row(results, "paged_prefill", "bfloat16", err, ms, plain_ms, lib_ms,
                (2 * Sq * H * D + 2 * (start + Sq) * KV * D) * 2, 4 * H * D * pairs)
    row = results[-1]
    row.update(ms_min=lo, ms_max=hi, point=point, head_dim=D, body=body, kernels=ran,
               share_of_bound=row["bound_ms"] / ms)
    log(f"[{PHASE_TAGS[phase]}] paged_prefill {point} ({ran[0]}): err {err:.3g} kernel {ms:.4f} ms "
        f"(min {lo:.4f} max {hi:.4f}) plain {plain_ms:.4f} gather + sdpa {lib_ms:.4f} bound "
        f"{row['bound_ms']:.4f} ({row['bound_by']}), {100 * row['bound_ms'] / ms:.1f} % of the "
        "bound")


def check_moe_family_kernels(torch, results):
    """Phase 3i. Rows 1, 3, 6 and 7 in bf16 at G 8 (Qwen3-30B-A3B's 32 over
    4 heads of 128) and G 6 (MiniMax-M2's and DBRX's 48 over 8; the decode
    kernel pads G 6 to its G-8 instantiation), each against its plain
    version and timed (medians of 21, L2 flushed) beside its bound, the
    plain version and SDPA."""
    from nxdi_tpu_torch.ops.kernels import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1717)
    scratch = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)

    def flush():
        scratch.zero_()

    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(
            torch.bfloat16)

    for point, c in MOE_HEADS.items():
        B, H, KV, S, D = c["B"], c["H"], c["KV"], c["S"], c["D"]
        q = randn((B, S, H, D)).transpose(1, 2)
        k, v = randn((B, S, KV, D)).transpose(1, 2), randn((B, S, KV, D)).transpose(1, 2)
        pos = torch.arange(S, device=dev, dtype=torch.int32)[None].expand(B, S).contiguous()
        family_prefill_point(torch, results, fa, point, q, k, v, pos, None, flush, phase="3i")
        del q, k, v
        ks, vs, _ = family_decode_point(torch, results, fa, point, c, None, flush, gen,
                                        phase="3i")
        del ks, vs
        torch.cuda.empty_cache()
        moe_paged_points(torch, results, fa, point, c, flush, gen)
        torch.cuda.empty_cache()


# phase 4l: the seven families at tiny widths (FAMILY_TINY's hidden 256 and
# head dim 64), 2 layers, f32: Qwen3-MoE at G 8 (8 over 1), MiniMax-M2 and
# DBRX at G 6 (12 over 2; DBRX's clamp at 1.0 bites), gpt-oss with sinks and
# a window of 8 under 64-token prompts, Phi-3's LongRoPE crossing its
# original window (70) mid-rollout
MOE_FAMILY_CASES = {
    "qwen3_moe": dict(num_attention_heads=8, num_key_value_heads=1, num_experts=8,
                      num_experts_per_tok=2, moe_intermediate_size=128, norm_topk_prob=True),
    "gpt_oss": dict(num_local_experts=4, num_experts_per_tok=2, intermediate_size=128,
                    sliding_window=8, layer_types=["sliding_attention", "full_attention"]),
    "minimax_m2": dict(num_attention_heads=12, num_key_value_heads=2, rotary_dim=32,
                       use_qk_norm=True, num_local_experts=8, num_experts_per_tok=2,
                       intermediate_size=128),
    "dbrx": dict(d_model=768, n_heads=12, n_layers=2, max_seq_len=4096,
                 attn_config=dict(kv_n_heads=2, clip_qkv=1.0, rope_theta=10000.0),
                 ffn_config=dict(ffn_hidden_size=128, moe_num_experts=8, moe_top_k=2)),
    "phimoe": dict(num_local_experts=4, num_experts_per_tok=2, attention_bias=True),
    "afmoe": dict(num_dense_layers=1, num_local_experts=8, num_experts_per_tok=2,
                  moe_intermediate_size=128, sliding_window=8, global_attn_every_n_layers=2),
    "phi3": dict(original_max_position_embeddings=70, rope_scaling=dict(
        type="longrope", short_factor=[1.0 + 0.02 * i for i in range(32)],
        long_factor=[1.5 + 0.1 * i for i in range(32)])),
}


def moe_family_flags(arch):
    """A MoE family's kernel flags: the attention kernels unless the model
    has sinks (no kernel takes the sink column: an enabled flag raises), the
    fused QKV weight with its kernel, the fused MLP where the stack holds
    dense MLP layers (Phi-3, AFMoE's head)."""
    attn = not arch.attention_sink
    return dict(attn_kernel_enabled=attn, attn_tkg_kernel_enabled=attn, fused_qkv=True,
                qkv_kernel_enabled=True, mlp_kernel_enabled=arch.moe is None or arch.sandwich_norm)


def moe_family_counts(L, n_dense, steps, attn, qkv):
    """The launches of a contiguous generate(): L prefills and L stacked
    decodes a step when the attention kernels run, one commit a step always,
    a QKV launch per layer per forward with ``qkv``, an MLP launch per dense
    layer (``n_dense``) per forward."""
    fwd = 1 + steps
    return dict(prefill=L if attn else 0, paged_prefill=0, paged_decode=0, window_decode=0,
                decode=L * steps if attn else 0, commit=steps, qkv=L * fwd if qkv else 0,
                mlp=n_dense * fwd)


def moe_family_vs_cpu(torch, np, mods):
    """Phase 4l: the seven families (MOE_FAMILY_CASES) at tiny widths, 2
    layers, float32, batch 2: greedy generate() on the CPU (plain versions,
    the JAX rule), through the card's graphs and eagerly (run_three: tokens
    equal, logits within LOGIT_TOL, graphs equal to eager bit for bit), every
    enabled kernel engaged, launches exact."""
    from nxdi_tpu_torch.models import registry

    L, NEW, P = 2, 16, 64
    out = {}
    for model_type, over in MOE_FAMILY_CASES.items():
        family = dense_family(model_type, **dict(FAMILY_TINY, **over))
        cfg = family[1](mods[1](seq_len=16), **dict(family[2], num_hidden_layers=L))
        arch = family[0].build_arch(cfg)
        flags = moe_family_flags(arch)
        apps, arch = three_apps(mods, layers=L, dtype="float32", batch=2, seq_len=256,
                                ctx_len=128, output_logits=True, family=family, **flags)
        ids, mask = prompts(np.random.default_rng(7), 2, P, [P, 53], arch.vocab_size)
        worst, toks, counts, n_same, _ = run_three(torch, mods, f"4l {model_type}", apps, ids,
                                                   mask, NEW, kernels=family_kernels())
        n_dense = (L if arch.moe is None else int(getattr(cfg, "num_dense_layers", 0))
                   if flags["mlp_kernel_enabled"] else 0)
        attn = flags["attn_kernel_enabled"]
        want = moe_family_counts(L, n_dense, NEW - 1, attn, True)
        assert counts == want, f"phase 4l {model_type}: launches {counts} != {want}"
        seen = {s for w in apps[1].models.values() for ss in w.attention_strategies.values()
                for s in ss}
        need = ({"cte_flash_kernel", "tkg_fused_kernel_stacked"} if attn
                else {"cte_xla", "tkg_two_part_xla"}) | {"qkv_fused_kernel"}
        if n_dense:
            need.add("mlp_fused_kernel")
        assert need <= seen, f"phase 4l {model_type}: strategies {seen} lack {need - seen}"
        assert registry.get_family(model_type)[0] is family[0]
        out[model_type] = dict(max_logit_err=worst, launches=counts, dispatches_bitwise=n_same,
                               group=arch.num_attention_heads // arch.num_kv_heads,
                               head_dim=arch.head_dim)
        log(f"[moe-family-2L 4l {model_type}] generate(): max logit diff {worst:.3g}, graphs = "
            f"eager over {n_same} dispatches, launches {counts}")
        del apps
        gc.collect()
    return out


def moe_family_full_depth(torch, np, mods, card):
    """Phase 5l, bf16, random weights from seed 0 at the published widths,
    sparse MoE dispatch: Qwen3-30B-A3B at 8 of 48 layers (G 8), gpt-oss-20b
    at 8 of 24 (4 window, 4 full; sinks: plain attention, the commit
    kernel), MiniMax-M2 at 4 of 62 (G 6). Each through generate() at B 8 on
    phase 5's prompt shapes, 32 new tokens, from its graphs and then eagerly
    (tokens equal), with prefill ms, decode ms/step, launches exact and a
    profiled decode step (busy, idle); Qwen3-30B-A3B then through the split
    paged engine over phase 5b's traffic (rows 1, 6 and 7 at G 8)."""
    from nxdi_tpu_torch.models.gpt_oss import modeling_gpt_oss as tgo
    from nxdi_tpu_torch.models.minimax_m2 import modeling_minimax_m2 as tmm
    from nxdi_tpu_torch.models.qwen3_moe import modeling_qwen3_moe as tqm

    ml, TorchConfig, ODSC, App, dense, Adapter = mods
    NEW, B, P = 32, 8, 1024
    stats, launches = {}, {}
    off = dict(attn_kernel_enabled=False, attn_tkg_kernel_enabled=False)
    for name, family, L, flags in (
            ("Qwen3-30B-A3B", (tqm, tqm.Qwen3MoeInferenceConfig, tqm.QWEN3_30B_A3B), 8, {}),
            ("gpt-oss-20b", (tgo, tgo.GptOssInferenceConfig, tgo.GPT_OSS_20B), 8, off),
            ("MiniMax-M2", (tmm, tmm.MiniMaxM2InferenceConfig, tmm.MINIMAX_M2), 4, {})):
        tag = f"[moe-family-5l {name}]"
        common = dict(layers=L, dtype="bfloat16", batch=B, seq_len=2048, ctx_len=P,
                      device="cuda", family=family, moe_dispatch="sparse", **flags)
        t = time.perf_counter()
        app, arch = make_app(ml, TorchConfig, ODSC, App, dense, **common)
        params = app.params
        gb = sum(v.numel() * v.element_size() for v in _leaves(params)) / 1e9
        eager, _ = make_app(ml, TorchConfig, ODSC, App, dense, graphs=False, params=params,
                            **common)
        log(f"{tag} {L} layers, 2 apps loaded {time.perf_counter() - t:.1f} s, params {gb:.2f} "
            f"GB; warmup {app.warm_stats}")
        ids, mask = prompts(np.random.default_rng(11), B, P, [P, P, 1000, P, 731, P, P, 1023],
                            arch.vocab_size)
        lengths = mask.sum(axis=1)
        kernels = family_kernels()
        attn = not arch.attention_sink
        want = moe_family_counts(L, 0, NEW - 1, attn, False)
        runs, toks = {}, {}
        for mode, a in (("graphs", app), ("eager", eager)):
            for fn in kernels.values():
                fn.launches = 0
            prefill_ms, decode_ms, toks[mode] = timed_generate(torch, Adapter, a, ids, mask, NEW)
            counts = {k: fn.launches for k, fn in kernels.items()}
            assert counts == want, f"{tag} {mode}: launches {counts} != {want}"
            runs[mode] = dict(prefill_ms=prefill_ms, decode_ms=decode_ms,
                              tok_s=B * 1e3 / decode_ms, launches=counts)
            log(f"{tag} generate() {mode} B {B} x {P}: prefill {prefill_ms:.2f} ms, decode "
                f"{decode_ms:.3f} ms/step, {B * 1e3 / decode_ms:.1f} tok/s; launches {counts}")
        assert (toks["graphs"] == toks["eager"]).all(), f"{tag}: graph and eager tokens differ"
        gen = np.stack([toks["graphs"][b, n:n + NEW] for b, n in enumerate(lengths)])
        assert (gen >= 0).all() and (gen < arch.vocab_size - arch.vocab_pad).all(), tag
        strats = strategies_of(app)
        assert "moe_sparse_grouped_mm" in strats, strats
        assert ({"cte_flash_kernel", "tkg_fused_kernel_stacked"} if attn
                else {"cte_xla", "tkg_two_part_xla"}) <= strats, strats
        del eager
        gc.collect()
        pr = decode_step_profile(torch, np, app, toks["graphs"], lengths, NEW)
        log(f"{tag} decode step: wall {pr['wall_ms']:.3f} ms, busy {pr['busy_ms']:.3f} ms (idle "
            f"{pr['idle_pct']:.1f}%), {pr['device_ops']} device operations; attention "
            f"{pr['attention_ms']}; by kind {pr['by_group_ms']}; host ms: "
            f"{split_line(pr['host_split_ms'])}")
        st = dict(layers=L, param_gb=gb, group=arch.num_attention_heads // arch.num_kv_heads,
                  runs=runs, profiled_decode_step=pr, graphs_equal_eager=True)
        launches[name] = dict(runs["graphs"]["launches"])
        del app
        gc.collect()
        torch.cuda.empty_cache()
        if name == "Qwen3-30B-A3B":
            e_counts, e_stats = engine_full_depth(
                torch, np, mods, card, layers=L, family=family, params=params,
                extra=dict(moe_dispatch="sparse"), extra_strats={"moe_sparse_grouped_mm"},
                phase="5l")
            e_stats.pop("prompts")
            st.update(engine=e_stats, engine_launches=e_counts)
            for k, v in e_counts.items():
                launches[name][k] = launches[name].get(k, 0) + v
            log(f"{tag} split engine {e_stats['tok_s']:.1f} tok/s, TTFT p50 "
                f"{e_stats['ttft_p50_ms']:.2f} ms p95 {e_stats['ttft_p95_ms']:.2f} ms, TPOT p50 "
                f"{e_stats['tpot_p50_ms']:.3f} ms, launches {e_counts}")
        stats[name] = st
        del params
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[moe-family-5l] {card}: " + "; ".join(
        f"{name} prefill {st['runs']['graphs']['prefill_ms']:.2f} ms decode "
        f"{st['runs']['graphs']['decode_ms']:.3f} ms/step idle "
        f"{st['profiled_decode_step']['idle_pct']:.1f}%" for name, st in stats.items()))
    stats["launches"] = launches
    return stats


def mla_counts(L, k_dense, n_cte, steps, mlp_kernel):
    """The launches of a DeepSeek run: no attention kernel (MLA attends
    plain); one commit a layer per context encoding that routes its writes
    (``n_cte``: the contiguous engine's; generate()'s slice write launches
    nothing) and per decode step (an MLA layer never defers); with
    ``mlp_kernel`` one fused MLP a dense-head layer per forward."""
    want = dict.fromkeys(counted_kernels(), 0)
    want["commit"] = L * (n_cte + steps)
    if mlp_kernel:
        want["mlp"] = k_dense * (n_cte + steps)
    return want


def mla_vs_cpu(torch, np, mods):
    """Phase 4j: a DeepSeek-shaped model (MLA_SMALL, 3 layers: one dense,
    two MoE), float32, yarn rope: generate() at batch 2 with the fused MLP
    kernel off and then on, on the CPU, the card's graphs and the card
    eagerly (run_three: tokens equal, logits within LOGIT_TOL, graphs equal
    to eager bit for bit), launches of rows 4 and 9/10 exact; then the
    contiguous engine (the fused MLP on) over 3 requests in 2 slots, one
    arriving at step 2, the same three ways: streams equal, logits within
    LOGIT_TOL, graphs equal to eager bit for bit, launches exact. On the card
    an attention kernel flag on an MLA model raises, naming MLA attention."""
    from nxdi_tpu_torch.ops import mla as mla_ops
    from nxdi_tpu_torch.runtime.model_wrapper import TAG_CONTEXT_ENCODING, TAG_TOKEN_GENERATION
    from nxdi_tpu_torch.serving import SamplingParams

    ml, TorchConfig, ODSC, App, dense, Adapter = mods
    family = deepseek_family(**MLA_SMALL)
    L, NEW, K_DENSE = 3, 16, 1
    out = {}
    for mlp_kernel in (False, True):
        phase = "4j generate" + (" mlp kernel" if mlp_kernel else "")
        apps, arch = three_apps(mods, layers=L, dtype="float32", batch=2, seq_len=256,
                                ctx_len=128, output_logits=True, family=family,
                                mlp_kernel_enabled=mlp_kernel, **MLA_FLAGS)
        assert (arch.mla.qk_head_dim, arch.mla.v_head_dim, arch.mla.kv_lora_rank,
                arch.mla.q_lora_rank) == (192, 128, 512, 1536)
        assert isinstance(apps[1].params["layers"], list)
        assert tuple(apps[1].kv_cache["v"].shape[-2:]) == (256, 512)
        if not mlp_kernel:
            try:
                mla_ops.mla_kernel_gate(dataclasses.replace(arch, attn_kernel_enabled=True),
                                        on_cuda=True)
                raise AssertionError("phase 4j: attn_kernel_enabled on MLA did not raise")
            except NotImplementedError as e:
                assert "MLA attention" in str(e), e
        ids, mask = prompts(np.random.default_rng(7), 2, 128, [128, 97], arch.vocab_size)
        worst, _, counts, n_same, _ = run_three(torch, mods, phase, apps, ids, mask, NEW,
                                                kernels=counted_kernels())
        want = mla_counts(L, K_DENSE, 0, NEW - 1, mlp_kernel)
        want["mlp"] = K_DENSE * NEW if mlp_kernel else 0  # the prefill's dense layer too
        assert counts == want, f"phase {phase}: launches {counts} != {want}"
        strat = strategies_of(apps[1])
        assert "mla_xla" in strat and ("mlp_fused_kernel" in strat) == mlp_kernel, strat
        out[phase] = dict(max_logit_err=worst, launches=counts, dispatches_bitwise=n_same,
                          strategies=sorted(strat))
        log(f"[mla-3L {phase}] max logit diff {worst:.3g}, launches {counts}, graphs = eager "
            f"over {n_same} dispatches; strategies {sorted(strat)}")
        params = apps[0].params
        del apps
        gc.collect()
    # the contiguous engine, three ways, one set of weights
    phase = "4j engine mlp kernel"
    cb = {}
    for name, dev, graphs in (("cpu", "cpu", True), ("graphs", "cuda", True),
                              ("eager", "cuda", False)):
        cb[name], _ = make_cb_app(ml, TorchConfig, ODSC, App, dense, layers=L, dtype="float32",
                                  slots=2, seq_len=256, ctx_len=128, device=dev, graphs=graphs,
                                  output_logits=True, params=params, family=family,
                                  mlp_kernel_enabled=True, **MLA_FLAGS)
        params = cb[name].params  # the next app moves these (or shares them)
    rng = np.random.default_rng(23)
    reqs = [rng.integers(1, arch.vocab_size, n).tolist() for n in (100, 37, 64)]
    streams, logs, e_counts = {}, {}, None
    for name, app in cb.items():
        logs[name] = []
        kernels = counted_kernels()
        for fn in kernels.values():
            fn.launches = 0
        streams[name], eng = run_cb(app, reqs, lambda i: SamplingParams(max_new_tokens=12),
                                    arrivals=[0, 0, 2], logits=logs[name])
        if name == "graphs":
            e_counts = {k: fn.launches for k, fn in kernels.items()}
            e_want = mla_counts(L, K_DENSE, eng.dispatches[TAG_CONTEXT_ENCODING],
                                eng.dispatches[TAG_TOKEN_GENERATION], True)
            assert e_counts == e_want, f"phase {phase}: launches {e_counts} != {e_want}"
    assert streams["graphs"] == streams["eager"], f"phase {phase}: graphs != eager"
    e_same = same_bits(torch, phase, logs["graphs"], logs["eager"])
    e_worst, _, flip = logits_within(torch, phase, logs["cpu"], logs["graphs"], LOGIT_TOL)
    if flip is None:
        assert streams["cpu"] == streams["graphs"], f"phase {phase}: streams differ"
    out[phase] = dict(max_logit_err=e_worst, launches=e_counts, dispatches_bitwise=e_same,
                      streams_equal_cpu=streams["cpu"] == streams["graphs"])
    log(f"[mla-3L {phase}] max logit diff {e_worst:.3g}, launches {e_counts}, graphs = eager "
        f"over {e_same} dispatches; streams equal to the CPU's: "
        f"{streams['cpu'] == streams['graphs']}")
    del cb, params
    gc.collect()
    return out


def mla_full_depth(torch, np, mods, card):
    """Phase 5j: DeepSeek-V3 at its published widths with its depth cut to
    4 layers (the 3 dense layers of first_k_dense_replace and 1 MoE layer;
    reduced: 61 -> 4 layers), bf16, random weights, graphs, the fused MLP
    kernel on the dense layers. generate() on phase 5's prompt shapes at
    batch 8 and batch 1 (its first row), 32 new tokens, in turns (8 1 1 8):
    prefill ms, decode ms/step, launches of rows 4 and 9/10 exact, a
    profiled decode step of each (busy, idle share, top device operations).
    Then the contiguous engine over phase 5b's traffic (cb_engine_run):
    tok/s, TTFT, TPOT, exact launches, a profiled decode step."""
    from nxdi_tpu_torch.runtime.model_wrapper import TAG_CONTEXT_ENCODING, TAG_TOKEN_GENERATION

    ml, TorchConfig, ODSC, App, dense, Adapter = mods
    family = deepseek_family()
    L, P, NEW, K_DENSE = 4, 1024, 32, 3
    common = dict(layers=L, dtype="bfloat16", seq_len=2048, ctx_len=P, device="cuda",
                  family=family, mlp_kernel_enabled=True, **MLA_FLAGS)
    t = time.perf_counter()
    apps = {}
    apps[8], arch = make_app(ml, TorchConfig, ODSC, App, dense, batch=8, **common)
    params = apps[8].params
    param_gb = sum(v.numel() * v.element_size() for v in _leaves(params)) / 1e9
    apps[1], _ = make_app(ml, TorchConfig, ODSC, App, dense, batch=1, params=params, **common)
    log(f"[mla-4L 5j] reduced: 61 -> 4 layers (3 dense + 1 MoE); 2 apps loaded "
        f"{time.perf_counter() - t:.1f} s, params {param_gb:.2f} GB; "
        + "; ".join(f"B {k} warmup {a.warm_stats}" for k, a in apps.items()))
    ids8, mask8 = prompts(np.random.default_rng(11), 8, P, [P, P, 1000, P, 731, P, P, 1023],
                          arch.vocab_size)
    inputs = {8: (ids8, mask8), 1: (ids8[:1], mask8[:1])}
    kernels = counted_kernels()
    runs = {k: [] for k in apps}
    outs = {}
    for B in (8, 1, 1, 8):
        ids, mask = inputs[B]
        for fn in kernels.values():
            fn.launches = 0
        prefill_ms, decode_ms, toks = timed_generate(torch, Adapter, apps[B], ids, mask, NEW)
        counts = {k: fn.launches for k, fn in kernels.items()}
        want = mla_counts(L, K_DENSE, 0, NEW - 1, True)
        want["mlp"] = K_DENSE * NEW
        assert counts == want, f"phase 5j B {B}: launches {counts} != {want}"
        lengths = mask.sum(axis=1)
        gen = np.stack([toks[b, n:n + NEW] for b, n in enumerate(lengths)])
        assert gen.shape == (B, NEW) and (gen >= 0).all() and (gen < arch.vocab_size).all()
        runs[B].append(dict(prefill_ms=prefill_ms, decode_ms=decode_ms,
                            tok_s=B * 1e3 / decode_ms, launches=counts))
        outs[B] = toks
        log(f"[mla-4L 5j] generate() B {B}: prefill {prefill_ms:.2f} ms, decode "
            f"{decode_ms:.3f} ms/step, {B * 1e3 / decode_ms:.1f} tok/s; launches {counts}")
    strat = strategies_of(apps[8])
    assert {"mla_xla", "mlp_fused_kernel", "moe_sparse_grouped_mm"} <= strat, strat
    profiles = {B: decode_step_profile(torch, np, app, outs[B], inputs[B][1].sum(axis=1), NEW)
                for B, app in apps.items()}
    for B, pr in profiles.items():
        log(f"[mla-4L 5j] B {B} decode step: wall {pr['wall_ms']:.3f} ms, busy "
            f"{pr['busy_ms']:.3f} ms (idle {pr['idle_pct']:.1f}%), {pr['device_ops']} device "
            f"operations; by kind {pr['by_group_ms']}; top {pr['top'][:6]}; host ms: "
            f"{split_line(pr['host_split_ms'])}")
    summary = {B: {k: float(np.mean([r[k] for r in rs])) for k in ("prefill_ms", "decode_ms",
                                                                   "tok_s")}
               for B, rs in runs.items()}
    warm = {B: a.warm_stats for B, a in apps.items()}
    del apps
    gc.collect()
    torch.cuda.empty_cache()

    rng = np.random.default_rng(17)
    shared = rng.integers(1, arch.vocab_size, 384).tolist()
    lens = rng.integers(200, 993, 16)
    reqs = [(shared + rng.integers(1, arch.vocab_size, max(n - 384, 1)).tolist()) if i % 2 == 0
            else rng.integers(1, arch.vocab_size, n).tolist() for i, n in enumerate(lens)]
    extra_prompts = [rng.integers(1, arch.vocab_size, 200).tolist() for _ in range(8)]
    t = time.perf_counter()
    app, _ = make_cb_app(ml, TorchConfig, ODSC, App, dense, layers=L, dtype="bfloat16", slots=8,
                         seq_len=2048, ctx_len=P, device="cuda", params=params, family=family,
                         mlp_kernel_enabled=True, **MLA_FLAGS)
    log(f"[mla-4L 5j] contiguous engine app: load + warmup {time.perf_counter() - t:.1f} s; "
        f"{app.warm_stats}")
    e_stats = cb_engine_run(
        torch, np, app, reqs, extra_prompts, NEW, L,
        counts_fn=lambda eng: mla_counts(L, K_DENSE, eng.dispatches[TAG_CONTEXT_ENCODING],
                                         eng.dispatches[TAG_TOKEN_GENERATION], True))
    e_stats.pop("streams")
    e_stats["warmup"] = app.warm_stats
    pd = e_stats["profiled_decode_step"]
    log(f"[mla-4L 5j] {card}: reduced 61 -> 4 layers; generate() " + "; ".join(
        f"B {B} prefill {v['prefill_ms']:.2f} ms decode {v['decode_ms']:.3f} ms/step "
        f"{v['tok_s']:.1f} tok/s" for B, v in summary.items())
        + f"; contiguous engine {e_stats['tok_s']:.1f} tok/s, TTFT p50 "
        f"{e_stats['ttft_p50_ms']:.2f} ms p95 {e_stats['ttft_p95_ms']:.2f} ms, TPOT p50 "
        f"{e_stats['tpot_p50_ms']:.3f} ms, launches {e_stats['launches']}, dispatches "
        f"{e_stats['dispatches']}; engine decode step wall {pd['wall_ms']:.3f} ms busy "
        f"{pd['busy_ms']:.3f} ms (idle {pd['idle_pct']:.1f}%)")
    del app, params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(card=card, layers=L, reduced="61 -> 4 layers (3 dense + 1 MoE)",
                param_gb=param_gb, runs=runs, mean=summary, profiled_decode_step=profiles,
                warmup=warm, strategies=sorted(strat), engine=e_stats)


# ---------------------------------------------------------------------------
# phases 3j, 4m, 5m: the Gemma 2/3 lineage and the window-sized ring KV cache
# ---------------------------------------------------------------------------

# phase 3j's points: row 1 at Gemma-3-27B's attention (32 over 16 heads of
# 128, window 1024: its local layers' launch) over phase 5m's B 8 x 1024
# prefill; row 3's ring mode over Gemma-3-27B's ring stack (the 10 window
# layers of phase 5m's 12, 1024 slots, B 8) with every row past the ring's
# first wrap; row 5's ring mode over Mistral-7B's homogeneous ring (32 over
# 8 heads of 128, 4096 slots, B 8); row 4 landing B 8 rows at p % W into
# Gemma-3-27B's ring stack
GEMMA3_HEADS = dict(H=32, KV=16, D=128, B=8, S=1024, window=1024, L=10)
MISTRAL_RING = dict(H=32, KV=8, D=128, B=8, window=4096)


def ring_positions(torch, qpos, W):
    """(B, W) positions of a ring's slots for (B, 1) query positions: slot j
    holds q - ((q - j) mod W); a slot no position has reached is -1."""
    j = torch.arange(W, device=qpos.device)[None, :]
    pos = qpos.long() - torch.remainder(qpos.long() - j, W)
    return torch.where(pos >= 0, pos, torch.full_like(pos, -1))


def check_ring_kernels(torch, results):
    """Phase 3j. Row 1 at Gemma-3-27B's heads under its 1024 window; rows 3
    and 5 in ring mode (the decode kernel's ``ring`` operand: each slot's
    position from the ring arithmetic) and row 4 landing rows at p % W, each
    in bf16 against its plain version (row 4 bit for bit) and timed over
    flushed calls beside its bound (the visible ring rows' bytes), the
    plain version and one library call (SDPA under the ring's mask;
    index_put)."""
    import torch.nn.functional as F

    from nxdi_tpu_torch.ops.kernels import flash_attention as fa
    from nxdi_tpu_torch.ops.kernels import kv_commit as kc

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1818)
    scratch = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)

    def flush():
        scratch.zero_()

    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(
            torch.bfloat16)

    c = GEMMA3_HEADS
    B, H, KV, S, D, W = c["B"], c["H"], c["KV"], c["S"], c["D"], c["window"]
    q = randn((B, S, H, D)).transpose(1, 2)
    k, v = randn((B, S, KV, D)).transpose(1, 2), randn((B, S, KV, D)).transpose(1, 2)
    pos = torch.arange(S, device=dev, dtype=torch.int32)[None].expand(B, S).contiguous()
    family_prefill_point(torch, results, fa, "Gemma-3-27B", q, k, v, pos, W, flush, phase="3j")
    del q, k, v
    torch.cuda.empty_cache()

    # row 3 in ring mode: layer 1 of the ring stack, every row past the wrap
    L, G = c["L"], H // KV
    ks, vs = randn((L, B, KV, W, D)), randn((L, B, KV, W, D))
    qd = randn((B, 1, H, D)).transpose(1, 2)
    kn, vn = randn((B, 1, KV, D)).transpose(1, 2), randn((B, 1, KV, D)).transpose(1, 2)
    qpos = torch.tensor([[W + 40 + 137 * b] for b in range(B)], device=dev, dtype=torch.int32)
    rp = ring_positions(torch, qpos, W)
    vis = (rp >= 0) & (rp < qpos) & (rp > qpos - W)
    mask = torch.cat([vis, torch.ones((B, 1), dtype=torch.bool, device=dev)], 1)[:, None, None]
    kcat = torch.cat([ks[1], kn], dim=2).repeat_interleave(G, dim=1)
    vcat = torch.cat([vs[1], vn], dim=2).repeat_interleave(G, dim=1)
    visible = int(vis.sum())
    row = decode_point(
        torch, results, "decode", "bfloat16", fa,
        lambda: fa.flash_attention_decode_fused_stacked(qd, ks, vs, kn, vn, qpos, 1,
                                                        sliding_window=W, ring=W),
        lambda: fa.flash_attention_decode_fused_plain(qd, ks[1], vs[1], kn, vn, qpos,
                                                      sliding_window=W, ring=W),
        lambda: F.scaled_dot_product_attention(qd, kcat, vcat, attn_mask=mask),
        (2 * KV * D * (visible + B) + 2 * B * H * D) * 2, 4 * H * D * (visible + B), flush,
        TOL[("decode", "bfloat16")])
    row.update(point="ring (Gemma-3-27B)", head_dim=D, window=W, ring=W)
    log(f"[ring-3j] decode ring mode, Gemma-3-27B's ring stack: the row above ({visible} "
        "visible positions)")
    del kcat, vcat

    # row 4 into the ring: slot p % W of each row's line, one slot dropped
    kr, vr = randn((L, B, KV, 1, D)), randn((L, B, KV, 1, D))
    slots = torch.remainder(qpos, W).to(torch.int32)
    slots[3, 0] = -1
    k_ref, v_ref = ks.clone(), vs.clone()
    kc.kv_commit_rows_plain(k_ref, v_ref, kr, vr, slots)
    kc.kv_commit_rows(ks, vs, kr, vr, slots)
    torch.cuda.synchronize()
    assert torch.equal(ks, k_ref) and torch.equal(vs, v_ref), "3j ring commit: not exact"
    del k_ref, v_ref
    times, _, _ = traced_times(torch, lambda: kc.kv_commit_rows(ks, vs, kr, vr, slots),
                               DECODE_CALLS, flush, kernel="kv_commit_kernel")
    ms, lo, hi = spread(times)
    plain_ms = measure(torch, lambda: kc.kv_commit_rows_plain(ks, vs, kr, vr, slots), flush=flush)
    valid = (slots[:, 0] >= 0).nonzero()[:, 0]
    sl, zero = slots[valid, 0].long(), torch.zeros_like(valid)

    def library_commit():
        ks[:, valid, :, sl] = kr[:, valid, :, zero]
        vs[:, valid, :, sl] = vr[:, valid, :, zero]

    lib_ms = measure(torch, library_commit, flush=flush)
    bms, by = bound_ms(2 * 2 * L * int(valid.numel()) * KV * D * 2, 0, "bfloat16")
    results.append(dict(kernel="commit", dtype="bfloat16", point="ring (Gemma-3-27B)",
                        head_dim=D, ring=W, max_abs_err=0.0, tol=0.0, ms=ms, ms_min=lo,
                        ms_max=hi, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                        bound_by=by))
    log(f"[ring-3j] commit into the ring (slot p % {W}, {L} layers): exact; kernel {ms:.4f} ms "
        f"({lo:.4f}-{hi:.4f}) plain {plain_ms:.4f} index_put {lib_ms:.4f} bound {bms:.6f} "
        f"({by})")
    del ks, vs
    torch.cuda.empty_cache()

    # row 5 in ring mode: Mistral-7B's homogeneous ring, the slot at q % W
    # already holding this step's row
    m = MISTRAL_RING
    B, H, KV, D, W = m["B"], m["H"], m["KV"], m["D"], m["window"]
    G = H // KV
    kw, vw = randn((B, KV, W, D)), randn((B, KV, W, D))
    qw = randn((B, 1, H, D)).transpose(1, 2)
    qpos = torch.tensor([[W + 90 + 517 * b] for b in range(B)], device=dev, dtype=torch.int32)
    qpos[-1, 0] = 1000  # one row before the ring fills
    rp = ring_positions(torch, qpos, W)
    vis = (rp >= 0) & (rp <= qpos) & (rp > qpos - W)
    dummy = torch.zeros((B, W), dtype=torch.int32, device=dev)
    ke, ve = kw.repeat_interleave(G, dim=1), vw.repeat_interleave(G, dim=1)
    visible = int(vis.sum())
    row = decode_point(
        torch, results, "window_decode", "bfloat16", fa,
        lambda: fa.flash_attention_decode(qw, kw, vw, qpos, dummy, sliding_window=W, ring=W),
        lambda: fa.flash_attention_decode_plain(qw, kw, vw, qpos, dummy, sliding_window=W,
                                                ring=W),
        lambda: F.scaled_dot_product_attention(qw, ke, ve, attn_mask=vis[:, None, None]),
        (2 * KV * D * visible + 2 * B * H * D) * 2, 4 * H * D * visible, flush,
        PAGED_TOL["bfloat16"])
    row.update(point="ring (Mistral-7B)", head_dim=D, window=W, ring=W)
    log(f"[ring-3j] window decode ring mode, Mistral-7B's ring: the row above ({visible} "
        "visible positions)")
    del kw, vw, ke, ve
    torch.cuda.empty_cache()


# phase 4m: the three Gemma families at tiny widths (FAMILY_TINY's hidden
# 256 and head dim 64; windows of 8 under 64-token prompts), and the ring
# two ways: Gemma-3 interleaved (a window layer beside a global one: the
# ring stack beside the full one) and Mistral homogeneous
GEMMA_TINY = dict(num_key_value_heads=2, query_pre_attn_scalar=48, sliding_window=8,
                  tie_word_embeddings=True, hidden_activation="gelu_pytorch_tanh")
GEMMA_CASES = {
    "gemma3_text": ("gemma3_text", dict(GEMMA_TINY, sliding_window_pattern=2,
                                        rope_local_base_freq=1000.0,
                                        rope_scaling=dict(rope_type="linear", factor=2.0)), {}),
    "gemma2": ("gemma2", dict(GEMMA_TINY, attn_logit_softcapping=5.0,
                              final_logit_softcapping=3.0), {}),
    "vaultgemma": ("vaultgemma", dict(GEMMA_TINY, attn_logit_softcapping=5.0,
                                      final_logit_softcapping=3.0), {}),
    "gemma3_text ring": ("gemma3_text", dict(GEMMA_TINY, sliding_window_pattern=2,
                                             rope_local_base_freq=1000.0),
                         dict(window_sized_kv=True, sliding_window=8)),
    "mistral ring": ("mistral", dict(sliding_window=8), dict(window_sized_kv=True,
                                                            sliding_window=8)),
}


def gemma_flags(arch, ring):
    """The attention kernels unless the model takes the logit softcap (an
    enabled flag raises); the fused QKV and MLP kernels off the ring (the
    JAX rule refuses them under window_sized_kv)."""
    attn = arch.attn_logit_softcap is None
    proj = not ring
    return dict(attn_kernel_enabled=attn, attn_tkg_kernel_enabled=attn, fused_qkv=proj,
                qkv_kernel_enabled=proj, mlp_kernel_enabled=proj)


def gemma_counts(arch, L, n_cte, steps, flags, ring):
    """The launches of a contiguous generate(). Full cache: L prefills per
    context encoding (attention kernels on), L stacked decodes and 1 commit
    a step, QKV and MLP per layer per forward. Interleaved ring: the window
    layers' context encoding writes land through the commit kernel, and a
    decode step commits once per stack. Homogeneous ring: every layer writes
    its rows (a commit) and then attends the ring (the window decode)."""
    attn, fwd = flags["attn_kernel_enabled"], n_cte + steps
    want = dict(prefill=L * n_cte if attn else 0, paged_prefill=0, paged_decode=0,
                window_decode=0, decode=L * steps if attn else 0, commit=steps,
                qkv=L * fwd if flags.get("qkv_kernel_enabled") else 0,
                mlp=L * fwd if flags.get("mlp_kernel_enabled") else 0)
    if ring and arch.interleaved_split() is not None:
        want["commit"] = arch.interleaved_split()[1] * n_cte + 2 * steps
    elif ring:
        want.update(decode=0, window_decode=L * steps, commit=L * fwd)
    return want


def gemma_vs_cpu(torch, np, mods):
    """Phase 4m: GEMMA_CASES at tiny widths, 2 layers, float32, batch 2:
    greedy generate() on the CPU (plain versions, the JAX rule: per-layer
    flags and the softcap attend plain; the homogeneous ring's window decode
    in ring mode), through the card's graphs and eagerly (run_three: tokens
    equal, logits within LOGIT_TOL, graphs equal to eager bit for bit),
    every enabled kernel engaged (rows 3 and 5 in ring mode, row 4 into the
    ring), launches exact, the ring's cache window-sized."""
    L, NEW, P = 2, 24, 64
    out = {}
    for case, (model_type, over, ring_kw) in GEMMA_CASES.items():
        family = dense_family(model_type, **dict(FAMILY_TINY, **over))
        ring = bool(ring_kw)
        cfg = family[1](mods[1](seq_len=256, **ring_kw), **dict(family[2], num_hidden_layers=L))
        arch = family[0].build_arch(cfg)
        flags = gemma_flags(arch, ring)
        apps, arch = three_apps(mods, layers=L, dtype="float32", batch=2, seq_len=256,
                                ctx_len=128, output_logits=True, family=family, **flags,
                                **ring_kw)
        shapes = {k: tuple(t.shape) for k, t in apps[1].kv_cache.items()}
        if ring:  # the ring: W slots (an interleaved model's window layers only)
            slots = {k: s[3] for k, s in shapes.items()}
            split = arch.interleaved_split()
            assert slots == ({"k": 256, "v": 256, "k_win": 8, "v_win": 8} if split
                             else {"k": 8, "v": 8}), shapes
        ids, mask = prompts(np.random.default_rng(7), 2, P, [P, 53], arch.vocab_size)
        worst, toks, counts, n_same, _ = run_three(torch, mods, f"4m {case}", apps, ids, mask,
                                                   NEW, kernels=family_kernels())
        want = gemma_counts(arch, L, 1, NEW - 1, flags, ring)
        assert counts == want, f"phase 4m {case}: launches {counts} != {want}"
        out[case] = dict(max_logit_err=worst, launches=counts, dispatches_bitwise=n_same,
                         cache_shapes=shapes, strategies=sorted(strategies_of(apps[1])))
        log(f"[gemma-2L 4m {case}] generate(): max logit diff {worst:.3g}, graphs = eager over "
            f"{n_same} dispatches, launches {counts}, cache {shapes}")
        del apps
        gc.collect()
        if ring:
            out[case]["engine"] = ring_engine_vs_cpu(torch, np, mods, case, family, L, ring_kw)
    return out


def ring_engine_vs_cpu(torch, np, mods, case, family, L, ring_kw):
    """Phase 4m's contiguous engine on a ring (each request's ring line
    routed by seq_ids; three requests over two slots, the third arriving
    mid-stream into a freed line; prompts of 23-40 tokens over the 8-slot
    ring): on the CPU, through the card's graphs and eagerly. Graph streams
    and logits equal eager's bit for bit; the CPU's logits within
    LOGIT_TOL and its streams equal (up to a near tie); launches exact: a
    homogeneous ring writes each layer's rows through the commit kernel and
    attends through the window decode's ring mode, an interleaved one
    decodes both stacks on the stacked fused decode and commits once per
    stack a step (a routed context encoding writes every layer through the
    commit)."""
    from nxdi_tpu_torch.runtime.model_wrapper import TAG_CONTEXT_ENCODING, TAG_TOKEN_GENERATION
    from nxdi_tpu_torch.serving import SamplingParams

    ml, TorchConfig, ODSC, App, dense, _ = mods
    common = dict(layers=L, dtype="float32", slots=2, seq_len=256, ctx_len=128, family=family,
                  output_logits=True, **ring_kw)
    cpu, arch = make_cb_app(ml, TorchConfig, ODSC, App, dense, device="cpu", **common)
    gpu, _ = make_cb_app(ml, TorchConfig, ODSC, App, dense, device="cuda", params=cpu.params,
                         **common)
    eager, _ = make_cb_app(ml, TorchConfig, ODSC, App, dense, device="cuda", graphs=False,
                           params=gpu.params, **common)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, arch.vocab_size, n).tolist() for n in (40, 23, 31)]
    budgets, arrivals = (20, 24, 16), [0, 0, 3]

    def params_of(i):
        return SamplingParams(max_new_tokens=budgets[i])

    logs = ([], [], [])
    ref, _ = run_cb(cpu, prompts, params_of, arrivals, logits=logs[0])
    got, eng = run_cb(gpu, prompts, params_of, arrivals, logits=logs[1])
    counts = {k: fn.launches for k, fn in attention_kernels().items()}
    ea, _ = run_cb(eager, prompts, params_of, arrivals, logits=logs[2])
    tag = f"phase 4m {case} engine"
    assert got == ea, f"{tag}: graph and eager streams differ"
    n_same = same_bits(torch, tag, logs[1], logs[2])
    worst, _, flip = logits_within(torch, tag, logs[0], logs[1], LOGIT_TOL)
    if flip is None:
        assert got == ref, f"{tag}: streams differ from the CPU's"
    n_cte = eng.dispatches[TAG_CONTEXT_ENCODING]
    steps = eng.dispatches[TAG_TOKEN_GENERATION]
    want = dict.fromkeys(counts, 0)
    if arch.interleaved_split() is None:
        want.update(prefill=L * n_cte, window_decode=L * steps, commit=L * (n_cte + steps))
    else:
        want.update(prefill=L * n_cte, decode=L * steps, commit=L * n_cte + 2 * steps)
    assert counts == want, f"{tag}: launches {counts} != {want}"
    log(f"[gemma-2L 4m {case}] contiguous engine: {len(got)} streams, max logit diff "
        f"{worst:.3g}, graphs = eager over {n_same} dispatches, launches {counts}")
    del cpu, gpu, eager
    gc.collect()
    return dict(max_logit_err=worst, launches=counts, dispatches_bitwise=n_same,
                streams_equal_cpu=got == ref)


def cache_bytes(app):
    return sum(t.numel() * t.element_size() for t in app.kv_cache.values())


def gemma_full_depth(torch, np, mods, card):
    """Phase 5m, bf16, graphs, random weights from seed 0 at the published
    widths. Gemma-3-27B cut to 12 of its 62 layers (two pattern units: 10
    local, 2 global), B 8, seq_len 8192, phase 5's prompt shapes at 1024
    tokens, 64 new tokens (past the 1024 window): generate() on the
    full-length cache and on the ring (window_sized_kv), the attention
    kernels on in both, then on the full cache with the QKV and MLP kernels
    too; each with cache bytes, the peak device memory of its load and
    generate(), prefill ms, decode ms/step, a profiled decode step, launches
    exact. Then Gemma-2-9B at 8 of its 42 layers (the softcap keeps the
    attention plain: rows 4 and 9-12) through generate() at B 8."""
    from nxdi_tpu_torch.models.gemma2 import modeling_gemma2 as tg2
    from nxdi_tpu_torch.models.gemma3 import modeling_gemma3 as tg3

    ml, TorchConfig, ODSC, App, dense, Adapter = mods
    B, P = 8, 1024
    stats = {}
    g3 = (tg3, tg3.Gemma3InferenceConfig, tg3.GEMMA_3_27B)
    attn = dict(attn_kernel_enabled=True, attn_tkg_kernel_enabled=True)
    proj = dict(fused_qkv=True, qkv_kernel_enabled=True, mlp_kernel_enabled=True)
    ring = dict(window_sized_kv=True, sliding_window=1024)
    params, toks = None, {}
    # (run, layers, new tokens, family, flags, whether it reuses the last
    # run's weights: the fused QKV weight is another params tree)
    for name, L, NEW, family, flags, share in (
            ("Gemma-3-27B full cache", 12, 64, g3, attn, False),
            ("Gemma-3-27B ring", 12, 64, g3, dict(attn, **ring), True),
            ("Gemma-3-27B full cache, QKV + MLP kernels", 12, 64, g3, dict(attn, **proj), False),
            ("Gemma-2-9B", 8, 32, (tg2, tg2.Gemma2InferenceConfig, tg2.GEMMA_2_9B),
             dict(attn_kernel_enabled=False, attn_tkg_kernel_enabled=False, **proj), False)):
        tag = f"[gemma-5m {name}]"
        if not share:
            params = None
            gc.collect()
            torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        app, arch = make_app(ml, TorchConfig, ODSC, App, dense, layers=L, dtype="bfloat16",
                             batch=B, seq_len=8192, ctx_len=P, device="cuda", family=family,
                             params=params, **flags)
        params = app.params
        gb = sum(v.numel() * v.element_size() for v in _leaves(params)) / 1e9
        ids, mask = prompts(np.random.default_rng(11), B, P, [P, P, 1000, P, 731, P, P, 1023],
                            arch.vocab_size)
        lengths = mask.sum(axis=1)
        want = gemma_counts(arch, L, 1, NEW - 1, flags, "window_sized_kv" in flags)
        run, toks[name] = gemma_generate(torch, np, mods, tag, app, arch, ids, mask, NEW, want)
        run.update(layers=L, param_gb=gb, cache_bytes=cache_bytes(app),
                   cache_shapes={k: list(v.shape) for k, v in app.kv_cache.items()},
                   peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
                   load_s=time.perf_counter() - t, warmup=app.warm_stats,
                   strategies=sorted(strategies_of(app)))
        log(f"{tag} {L} layers, params {gb:.2f} GB, KV cache {run['cache_bytes'] / 1e9:.3f} GB "
            f"{run['cache_shapes']}, peak allocated {run['peak_allocated_gb']:.2f} GB; {card}")
        stats[name] = run
        del app
        gc.collect()
        torch.cuda.empty_cache()
    full, rg = toks["Gemma-3-27B full cache"], toks["Gemma-3-27B ring"]
    stats["ring_tokens_equal_full"] = float((full == rg).mean())
    stats["ring_cache_ratio"] = (stats["Gemma-3-27B full cache"]["cache_bytes"]
                                 / stats["Gemma-3-27B ring"]["cache_bytes"])
    log(f"[gemma-5m] {card}: ring cache {stats['ring_cache_ratio']:.2f}x smaller; tokens equal "
        f"to the full cache's at {100 * stats['ring_tokens_equal_full']:.1f} % of positions")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    stats["launches"] = {name: st["launches"] for name, st in stats.items()
                         if isinstance(st, dict) and "launches" in st}
    return stats


def gemma_generate(torch, np, mods, tag, app, arch, ids, mask, NEW, want):
    """One timed generate() of a phase 5m app (family_generate's measures):
    its launches exactly ``want`` (gemma_counts), a profiled decode step."""
    Adapter = mods[5]
    kernels = family_kernels()
    for fn in kernels.values():
        fn.launches = 0
    prefill_ms, decode_ms, toks = timed_generate(torch, Adapter, app, ids, mask, NEW)
    counts = {k: fn.launches for k, fn in kernels.items()}
    assert counts == want, f"{tag}: launches {counts} != {want}"
    lengths = mask.sum(axis=1)
    gen = np.stack([toks[b, n:n + NEW] for b, n in enumerate(lengths)])
    assert (gen >= 0).all() and (gen < arch.vocab_size - arch.vocab_pad).all(), tag
    B = ids.shape[0]
    pr = decode_step_profile(torch, np, app, toks, lengths, NEW)
    log(f"{tag} decode step: wall {pr['wall_ms']:.3f} ms, busy {pr['busy_ms']:.3f} ms "
        f"(idle {pr['idle_pct']:.1f}%), {pr['device_ops']} device operations; attention "
        f"{pr['attention_ms']}; host ms: {split_line(pr['host_split_ms'])}")
    log(f"{tag} generate() B {B} x {ids.shape[1]}: prefill {prefill_ms:.2f} ms, decode "
        f"{decode_ms:.3f} ms/step, {B * 1e3 / decode_ms:.1f} tok/s; launches {counts}")
    return dict(batch=B, prompt=int(ids.shape[1]), prefill_ms=prefill_ms, decode_ms=decode_ms,
                tok_s=B * 1e3 / decode_ms, launches=counts, profiled_decode_step=pr), toks


# ---------------------------------------------------------------------------
# phases 3k, 4n, 5n: Llama 4 (chunked attention, NoPE layers) and the
# global-NoPE hybrids (Command R7B, EXAONE 4.0, OLMo-3)
# ---------------------------------------------------------------------------

# phase 3k's points at Llama-4-Scout's attention (40 over 8 heads of 128:
# G 5) under its 8192-token chunk: row 1 over phase 5n's B 2 x 9216 prefill
# (the second chunk's 1024 rows see only their own chunk), row 3 over a
# 2-layer stack of 9216 slots with both rows past the boundary
SCOUT_CHUNK = dict(H=40, KV=8, D=128, B=2, S=9216, chunk=8192, L=2)
# phase 5n's Command R7B prompts: 6144 tokens, past its 4096 window
R7B_PROMPT = 6144


def _chunk_pairs(S, chunk):
    """Causal (query, key) pairs of an S-row prefill from position 0 under
    chunks of ``chunk``."""
    return sum(n * (n + 1) // 2 for n in (min(chunk, S - a) for a in range(0, S, chunk)))


def check_chunk_kernels(torch, results):
    """Phase 3k. Rows 1 and 3 in chunk mode at Llama-4-Scout's heads (G 5),
    bf16: each against its plain version (row 1's plain version one kv head
    at a time: its f32 scores over all 40 heads would take 27 GB), the same
    bits on a second call, timed over flushed calls beside its bound (the
    chunk's visible pairs or bytes only), the plain version and SDPA under
    the chunk mask. Row 1 is also timed without the chunk (plain causal over
    the same rows): a chunked run as slow as that one reads the masked kv
    tiles left of each query's chunk."""
    import torch.nn.functional as F

    from nxdi_tpu_torch.ops.kernels import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1919)
    scratch = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)

    def flush():
        scratch.zero_()

    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(
            torch.bfloat16)

    c = SCOUT_CHUNK
    B, H, KV, S, D, C = c["B"], c["H"], c["KV"], c["S"], c["D"], c["chunk"]
    G = H // KV
    q = randn((B, S, H, D)).transpose(1, 2)
    k, v = randn((B, S, KV, D)).transpose(1, 2), randn((B, S, KV, D)).transpose(1, 2)
    pos = torch.arange(S, device=dev, dtype=torch.int32)[None].expand(B, S).contiguous()
    call = lambda: fa.flash_attention_prefill(q, k, v, pos, pos, chunk_size=C)  # noqa: E731

    def plain():
        return torch.cat([fa.flash_attention_prefill_plain(
            q[:, h * G:(h + 1) * G], k[:, h:h + 1], v[:, h:h + 1], pos, pos, chunk_size=C)
            for h in range(KV)], dim=1)

    got = call()
    err = (got.float() - plain().float()).abs().max().item()
    tol = TOL[("prefill", "bfloat16")]
    assert err <= tol, f"3k prefill: max abs err {err} > {tol}"
    assert torch.equal(call(), got), "3k prefill: a second call gave other bits"
    body = fa.prefill_body(q, k, v)
    times, names, _ = traced_times(torch, call, PREFILL_CALLS, flush, kernel="prefill")
    ms, lo, hi = spread(times)
    ran = sorted(attention_ms([(0.0, n) for n in names]))
    assert ran == [PREFILL_KERNEL[body]], f"3k prefill: ran {ran}, expected {body}"
    causal = lambda: fa.flash_attention_prefill(q, k, v, pos, pos)  # noqa: E731
    causal_ms = spread(traced_times(torch, causal, PREFILL_CALLS, flush, kernel="prefill")[0])[0]
    plain_ms = measure(torch, plain, n=3, flush=flush)
    ke, ve = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
    i = torch.arange(S, device=dev)
    mask = (i[None, :] <= i[:, None]) & (i[None, :] // C == i[:, None] // C)
    library = lambda: F.scaled_dot_product_attention(q, ke, ve, attn_mask=mask)  # noqa: E731
    lib_ms = spread(traced_times(torch, library, PREFILL_CALLS, flush)[0])[0]
    pairs, all_pairs = _chunk_pairs(S, C), S * (S + 1) // 2
    bms, by = bound_ms((2 * B * H * S * D + 2 * B * KV * S * D) * 2, 4 * B * H * D * pairs,
                       "bfloat16")
    row = dict(kernel="prefill", dtype="bfloat16", point="Llama-4-Scout chunk 8192", head_dim=D,
               chunk=C, group=G, max_abs_err=err, tol=tol, ms=ms, ms_min=lo, ms_max=hi,
               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by, body=body,
               kernels=ran, share_of_bound=bms / ms, unchunked_ms=causal_ms,
               visible_pair_share=pairs / all_pairs)
    results.append(row)
    log(f"[chunk-3k] prefill Scout B {B} x {S}, chunk {C}, G {G} ({ran[0]}): err {err:.3g} "
        f"kernel {ms:.4f} ms (min {lo:.4f} max {hi:.4f}); without the chunk {causal_ms:.4f} ms "
        f"(the chunk leaves {100 * pairs / all_pairs:.1f} % of the causal pairs); plain "
        f"{plain_ms:.4f} sdpa {lib_ms:.4f} bound {bms:.4f} ({by}), {100 * bms / ms:.1f} % of "
        "the bound")
    del q, k, v, ke, ve, mask, got
    torch.cuda.empty_cache()

    # row 3: the stacked fused decode at layer 1, both rows past the boundary
    L = c["L"]
    ks, vs = randn((L, B, KV, S, D)), randn((L, B, KV, S, D))
    qd = randn((B, 1, H, D)).transpose(1, 2)
    kn, vn = randn((B, 1, KV, D)).transpose(1, 2), randn((B, 1, KV, D)).transpose(1, 2)
    qpos = torch.tensor([[S - 16], [C + 500]], device=dev, dtype=torch.int32)
    slot = torch.arange(S + 1, device=dev)
    start = qpos // C * C
    dmask = ((slot[None, :] < qpos) & (slot[None, :] >= start)) | (slot[None, :] == S)
    kcat = torch.cat([ks[1], kn], dim=2).repeat_interleave(G, dim=1)
    vcat = torch.cat([vs[1], vn], dim=2).repeat_interleave(G, dim=1)
    visible = int((qpos - start).sum().item())
    row = decode_point(
        torch, results, "decode", "bfloat16", fa,
        lambda: fa.flash_attention_decode_fused_stacked(qd, ks, vs, kn, vn, qpos, 1,
                                                        chunk_size=C),
        lambda: fa.flash_attention_decode_fused_plain(qd, ks[1], vs[1], kn, vn, qpos,
                                                      chunk_size=C),
        lambda: F.scaled_dot_product_attention(qd, kcat, vcat, attn_mask=dmask[:, None, None]),
        (2 * KV * D * (visible + B) + 2 * B * H * D) * 2, 4 * H * D * (visible + B), flush,
        TOL[("decode", "bfloat16")])
    row.update(point="Llama-4-Scout chunk 8192", head_dim=D, chunk=C, group=G)
    log(f"[chunk-3k] decode Scout chunk {C}, G {G}: the row above ({visible} visible positions "
        f"of {int(qpos.sum().item())})")
    del ks, vs, kcat, vcat
    torch.cuda.empty_cache()


# phase 4n: Llama 4 and the hybrids at tiny widths (FAMILY_TINY's hidden 256
# and head dim 64; Llama 4 at G 5: 10 over 2 heads), 2 layers, f32; chunks
# and windows of 8 under 64-token prompts; the hybrids again on the ring
SCOUT_TINY = dict(FAMILY_TINY, intermediate_size=256, num_attention_heads=10,
                  num_key_value_heads=2, num_local_experts=4, num_experts_per_tok=1,
                  attention_chunk_size=8, no_rope_layers=[1, 0], floor_scale=8.0,
                  attn_scale=0.1, use_qk_norm=True, attn_temperature_tuning=True)
HYBRID = dict(sliding_window=8, layer_types=["sliding_attention", "full_attention"])
NOPE_CASES = {
    "llama4_text": ("llama4_text", SCOUT_TINY, {}),
    "cohere2": ("cohere2", dict(HYBRID, logit_scale=0.25, tie_word_embeddings=True), {}),
    "exaone4": ("exaone4", HYBRID, {}),
    "olmo3": ("olmo3", dict(HYBRID, rope_scaling=dict(rope_type="linear", factor=2.0)), {}),
}
NOPE_CASES.update({f"{name} ring": (name, over, dict(window_sized_kv=True, sliding_window=8))
                   for name, (_, over, _) in list(NOPE_CASES.items()) if name != "llama4_text"})


def nope_flags(arch, ring):
    """The attention kernels; the fused QKV kernel off the ring; the fused
    MLP off the ring where the model has a dense MLP (Llama 4's is a
    mixture of experts)."""
    proj = not ring
    return dict(attn_kernel_enabled=True, attn_tkg_kernel_enabled=True, fused_qkv=proj,
                qkv_kernel_enabled=proj, mlp_kernel_enabled=proj and arch.moe is None)


def nope_vs_cpu(torch, np, mods):
    """Phase 4n: NOPE_CASES at tiny widths, 2 layers, float32, batch 2:
    greedy generate() on the CPU (plain versions, the JAX rule: the rope
    flags keep every attention kernel off), through the card's graphs and
    eagerly (run_three: tokens equal, logits within LOGIT_TOL, graphs equal
    to eager bit for bit), rows 1 and 3 in chunk mode on Llama 4's rope layer
    and unchunked on its NoPE layer, windowed on the hybrids' window layers
    (rows 3 and 4 in ring mode on the ring), launches exact
    (gemma_counts)."""
    L, NEW, P = 2, 24, 64
    out = {}
    for case, (model_type, over, ring_kw) in NOPE_CASES.items():
        family = dense_family(model_type, **dict(FAMILY_TINY, **over))
        ring = bool(ring_kw)
        cfg = family[1](mods[1](seq_len=256, **ring_kw), **dict(family[2], num_hidden_layers=L))
        arch = family[0].build_arch(cfg)
        flags = nope_flags(arch, ring)
        apps, arch = three_apps(mods, layers=L, dtype="float32", batch=2, seq_len=256,
                                ctx_len=128, output_logits=True, family=family, **flags,
                                **ring_kw)
        ids, mask = prompts(np.random.default_rng(7), 2, P, [P, 53], arch.vocab_size)
        worst, toks, counts, n_same, _ = run_three(torch, mods, f"4n {case}", apps, ids, mask,
                                                   NEW, kernels=family_kernels())
        want = gemma_counts(arch, L, 1, NEW - 1, flags, ring)
        assert counts == want, f"phase 4n {case}: launches {counts} != {want}"
        seen = strategies_of(apps[1])
        assert {"cte_flash_kernel", "tkg_fused_kernel_stacked"} <= seen, (case, seen)
        chunks = [arch.layer_chunk(i) for i in range(L)]
        windows = [arch.layer_window(i) for i in range(L)]
        out[case] = dict(max_logit_err=worst, launches=counts, dispatches_bitwise=n_same,
                         chunks=chunks, windows=windows, strategies=sorted(seen),
                         cache_shapes={k: tuple(t.shape) for k, t in apps[1].kv_cache.items()})
        log(f"[nope-2L 4n {case}] generate(): max logit diff {worst:.3g}, graphs = eager over "
            f"{n_same} dispatches, launches {counts}, chunks {chunks}, windows {windows}")
        del apps
        gc.collect()
    return out


def nope_full_depth(torch, np, mods, card):
    """Phase 5n, bf16, graphs, random weights from seed 0 at the published
    widths. Llama-4-Scout cut to 8 of its 48 layers (two units of three
    chunked rope layers and one NoPE layer; ~35 GB of layers and 4.1 GB of
    embedding and head), B 2 with 9216-token prompts and 32 new tokens (the
    prefill and every decode step cross the 8192 chunk), then phase 5's
    B 8 x 1024; Command R7B whole (32 layers, ~16 GB) at B 2 x 6144 on the
    full cache and on the ring (window_sized_kv: the 8 global layers' cache
    beside the 24 window layers' 4096-slot ring). The attention kernels on
    every layer; each run with prefill ms, decode ms/step, a profiled decode
    step, cache bytes, peak device memory and launches exact."""
    from nxdi_tpu_torch.models.cohere2 import modeling_cohere2 as tc2
    from nxdi_tpu_torch.models.llama4 import modeling_llama4 as tl4

    ml, TorchConfig, ODSC, App, dense, _ = mods
    stats, toks = {}, {}
    attn = dict(attn_kernel_enabled=True, attn_tkg_kernel_enabled=True)
    scout = (tl4, tl4.Llama4InferenceConfig, tl4.LLAMA_4_SCOUT)
    r7b = (tc2, tc2.Cohere2InferenceConfig, tc2.COMMAND_R7B)
    P9, P6 = SCOUT_CHUNK["S"], R7B_PROMPT
    params = None
    # (run, family, layers, batch, prompt, its lengths, new tokens, flags,
    # whether it reuses the last run's weights)
    for name, family, L, B, P, lengths, NEW, flags, share in (
            ("Llama-4-Scout B 2 x 9216", scout, 8, 2, P9, [P9, P9 - P9 // 32], 32, attn, False),
            ("Llama-4-Scout B 8 x 1024", scout, 8, 8, 1024, [1024, 1024, 1000, 1024, 731, 1024,
                                                            1024, 1023], 32, attn, True),
            ("Command R7B full cache", r7b, 32, 2, P6, [P6, P6 - P6 // 32], 32, attn, False),
            ("Command R7B ring", r7b, 32, 2, P6, [P6, P6 - P6 // 32], 32,
             dict(attn, window_sized_kv=True, sliding_window=r7b[2]["sliding_window"]), True)):
        tag = f"[nope-5n {name}]"
        if not share:
            params = None
            gc.collect()
            torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        app, arch = make_app(ml, TorchConfig, ODSC, App, dense, layers=L, dtype="bfloat16",
                             batch=B, seq_len=P + 64, ctx_len=P, device="cuda", family=family,
                             params=params, **flags)
        params = app.params
        gb = sum(v.numel() * v.element_size() for v in _leaves(params)) / 1e9
        ids, mask = prompts(np.random.default_rng(19), B, P, lengths, arch.vocab_size)
        want = gemma_counts(arch, L, 1, NEW - 1, flags, "window_sized_kv" in flags)
        run, toks[name] = gemma_generate(torch, np, mods, tag, app, arch, ids, mask, NEW, want)
        seen = strategies_of(app)
        assert {"cte_flash_kernel", "tkg_fused_kernel_stacked"} <= seen, (name, seen)
        run.update(layers=L, param_gb=gb, cache_bytes=cache_bytes(app),
                   cache_shapes={k: list(v.shape) for k, v in app.kv_cache.items()},
                   peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
                   load_s=time.perf_counter() - t, warmup=app.warm_stats, strategies=sorted(seen),
                   chunks=[arch.layer_chunk(i) for i in range(L)],
                   windows=[arch.layer_window(i) for i in range(L)])
        log(f"{tag} {L} layers, params {gb:.2f} GB, KV cache {run['cache_bytes'] / 1e9:.3f} GB "
            f"{run['cache_shapes']}, peak allocated {run['peak_allocated_gb']:.2f} GB, load "
            f"{run['load_s']:.1f} s; {card}")
        stats[name] = run
        del app
        gc.collect()
        torch.cuda.empty_cache()
    full, rg = toks["Command R7B full cache"], toks["Command R7B ring"]
    stats["ring_tokens_equal_full"] = float((full == rg).mean())
    stats["ring_cache_ratio"] = (stats["Command R7B full cache"]["cache_bytes"]
                                 / stats["Command R7B ring"]["cache_bytes"])
    log(f"[nope-5n] {card}: Command R7B's ring cache {stats['ring_cache_ratio']:.2f}x smaller; "
        f"tokens equal to the full cache's at {100 * stats['ring_tokens_equal_full']:.1f} % of "
        "positions")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    stats["launches"] = {name: st["launches"] for name, st in stats.items()
                         if isinstance(st, dict) and "launches" in st}
    return stats


# ---------------------------------------------------------------------------
# phases 3l, 4o, 5o: the last dense families (StarCoder2, Falcon, GPT-NeoX,
# Phi, GLM-4, StableLM, Persimmon, Apertus, Orion and the learned-position
# GPT-2 / BigCode / OPT / BioGPT / XGLM lineage), and the decode kernels at
# multi-query groups above 16 (head tiles of 16)
# ---------------------------------------------------------------------------

# phase 3l's points: one kv head under Falcon-7B's 71 query heads of 64 and
# under StarCoder's (BigCode's) 48 of 128, at phase 5's B 8: rows 1 and 3 at
# a B 8 x 1024 prefill and a 2-layer stack of 2048 slots, row 5 over a
# 2048-slot window, rows 7 and 6 on phase 3b's pool, row 8 checked
MQA_HEADS = {
    "G 71 (Falcon-7B)": dict(H=71, KV=1, D=64, B=8, S=1024, S_cache=2048, L=2),
    "G 48 (StarCoder)": dict(H=48, KV=1, D=128, B=8, S=1024, S_cache=2048, L=2),
}


def mqa_window_point(torch, results, fa, point, c, flush, gen):
    """Row 5 (the window decode: this step's row already in the window) at
    one of phase 3l's points over an S_cache-slot window, rows near its end
    and one at 0 (decode_point, beside SDPA over the expanded window under
    the inclusive causal mask)."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    B, H, KV, D, S = c["B"], c["H"], c["KV"], c["D"], c["S_cache"]
    G = H // KV

    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(
            torch.bfloat16)

    kw, vw = randn((B, S, KV, D)).transpose(1, 2), randn((B, S, KV, D)).transpose(1, 2)
    q = randn((B, 1, H, D)).transpose(1, 2)
    qp = torch.tensor([[S - 1 - 37 * b] for b in range(B)], device=dev, dtype=torch.int32)
    qp[-1, 0] = 0
    kv_pos = torch.arange(S, device=dev, dtype=torch.int32)[None].expand(B, S)
    wmask = (kv_pos <= qp)[:, None, None, :]
    kwe, vwe = kw.repeat_interleave(G, dim=1), vw.repeat_interleave(G, dim=1)
    seen = int((kv_pos <= qp).sum())
    row = decode_point(
        torch, results, "window_decode", "bfloat16", fa,
        lambda: fa.flash_attention_decode(q, kw, vw, qp, kv_pos),
        lambda: fa.flash_attention_decode_plain(q, kw, vw, qp, kv_pos),
        lambda: F.scaled_dot_product_attention(q, kwe, vwe, attn_mask=wmask),
        (2 * seen * KV * D + 2 * B * H * D) * 2, 4 * H * D * seen, flush,
        PAGED_TOL["bfloat16"])
    row.update(point=point, head_dim=D, group=G, head_tiles=fa.decode_head_tiles(H, KV))
    log(f"[mqa-3l] window_decode {point}: the row above ({seen} visible positions)")


def mqa_ragged_check(torch, fa, rpa, c, gen):
    """Row 8 at one of phase 3l's groups: a packed stream of a 130-token
    prefill chunk beside a long and a short decode row (block 128), bf16 and
    f32, against its plain version (the mixed step refuses these families'
    LayerNorms, so row 8 is off their path: checked, not timed). Returns the
    largest error by dtype."""
    import numpy as np

    dev = torch.device("cuda")
    H, KV, D = c["H"], c["KV"], c["D"]
    T, bs, NB, R = 160, 128, 16, 3
    rows = [(2, 100, 130), (0, 1900, 1), (1, 7, 1)]
    perm = torch.randperm(R * NB, generator=torch.Generator().manual_seed(7)).tolist()
    bt = np.full((R, NB), -1, np.int32)
    rid, qp = np.full(T, -1, np.int32), np.zeros(T, np.int32)
    t, nxt = 0, 0
    for slot, start, n in rows:
        rid[t:t + n], qp[t:t + n] = slot, np.arange(start, start + n)
        t += n
        nb = (start + n - 1) // bs + 1
        bt[slot, :nb] = perm[nxt:nxt + nb]
        nxt += nb
    errs = {}
    for dt, tol in ((torch.bfloat16, NEW_TOL[("ragged", "bfloat16")]),
                    (torch.float32, NEW_TOL[("ragged", "float32")])):
        kc, vc = (torch.randn((R * NB * bs, KV, D), generator=gen, device=dev).to(dt)
                  for _ in range(2))
        q = torch.randn((1, T, H, D), generator=gen, device=dev).to(dt).transpose(1, 2)
        plan = rpa.ragged_plan(rid, qp, R, NB * bs, KV)
        got = rpa.ragged_paged_attention(q, kc, vc, bt, rid, qp, block_size=bs, plan=plan)
        want = rpa.ragged_paged_attention_plain(q, kc, vc, bt, rid, qp, block_size=bs)
        err = (got.float() - want.float()).abs().max().item()
        name = str(dt).replace("torch.", "")
        assert err <= tol, f"3l ragged G {H // KV} {name}: max abs err {err} > {tol}"
        assert bool((got[:, :, torch.from_numpy(rid < 0).to(dev)] == 0).all()), "3l ragged pad"
        errs[name] = err
    return errs


def check_mqa_kernels(torch, results):
    """Phase 3l. The decode kernels' head tiles at Falcon-7B's group (71
    query heads of 64 on one kv head: five tiles, the last of 7 heads) and
    StarCoder's (48 of 128: three), bf16: rows 3, 5 and 7 (the three decode
    modes) against their plain versions, split across blocks and one chunk
    a row, timed over flushed calls beside their bound (each visible K/V
    row read once), the plain version and SDPA over the expanded (or
    gathered and masked) cache; rows 1 and 6, which index the kv head per
    query head, the same way; row 8 against its plain version."""
    from nxdi_tpu_torch.ops.kernels import flash_attention as fa
    from nxdi_tpu_torch.ops.kernels import ragged_paged_attention as rpa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2020)
    scratch = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)

    def flush():
        scratch.zero_()

    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(
            torch.bfloat16)

    ragged = {}
    for point, c in MQA_HEADS.items():
        B, H, KV, S, D = c["B"], c["H"], c["KV"], c["S"], c["D"]
        tiles = fa.decode_head_tiles(H, KV)
        q = randn((B, S, H, D)).transpose(1, 2)
        k, v = randn((B, S, KV, D)).transpose(1, 2), randn((B, S, KV, D)).transpose(1, 2)
        pos = torch.arange(S, device=dev, dtype=torch.int32)[None].expand(B, S).contiguous()
        family_prefill_point(torch, results, fa, point, q, k, v, pos, None, flush, phase="3l")
        results[-1].update(group=H // KV)
        del q, k, v
        torch.cuda.empty_cache()
        ks, vs, _ = family_decode_point(torch, results, fa, point, c, None, flush, gen,
                                        phase="3l")
        results[-1].update(group=H // KV, head_tiles=tiles)
        del ks, vs
        torch.cuda.empty_cache()
        mqa_window_point(torch, results, fa, point, c, flush, gen)
        torch.cuda.empty_cache()
        moe_paged_points(torch, results, fa, point, c, flush, gen, phase="3l")
        results[-2].update(group=H // KV, head_tiles=tiles)  # row 7
        results[-1].update(group=H // KV)  # row 6
        torch.cuda.empty_cache()
        ragged[point] = mqa_ragged_check(torch, fa, rpa, c, gen)
        log(f"[mqa-3l] ragged {point}: max abs err {ragged[point]} (bf16, f32) against the "
            "plain version")
    return ragged


# phase 4o: every family of the slice at tiny widths, 2 layers, f32, batch
# 2, 64-token prompts: StarCoder2 under a window of 8, Phi at head dim 80
# (hidden 320 over 4 heads), GLM-4 at 16 query heads on one kv head, GPT-2's
# position table as long as seq_len (its padded and warmup rows reach the
# table's end), and Falcon-7B's and StarCoder's groups at their published
# attention widths (71 query heads of 64, 48 of 128, on one kv head)
TIER3_TINY = dict(hidden_size=256, intermediate_size=512, num_attention_heads=4,
                  num_key_value_heads=2, vocab_size=512, max_position_embeddings=4096,
                  rope_theta=10000.0, rms_norm_eps=1e-5, tie_word_embeddings=False)
TIER3_CASES = {
    "starcoder2": dict(TIER3_TINY, sliding_window=8, use_bias=True,
                       hidden_act="gelu_pytorch_tanh"),
    "falcon G 71": dict(TIER3_TINY, hidden_size=4544, ffn_hidden_size=1024,
                        num_attention_heads=71, multi_query=True, parallel_attn=True,
                        bias=False, tie_word_embeddings=True),
    "gpt_neox": dict(TIER3_TINY, num_key_value_heads=4, rotary_pct=0.25,
                     use_parallel_residual=True, hidden_act="gelu"),
    "phi D 80": dict(TIER3_TINY, hidden_size=320, partial_rotary_factor=0.4,
                     hidden_act="gelu_new"),
    "glm4 G 16": dict(TIER3_TINY, num_attention_heads=16, num_key_value_heads=1, head_dim=64,
                      partial_rotary_factor=0.5),
    "stablelm": dict(TIER3_TINY, partial_rotary_factor=0.25, use_qkv_bias=True),
    "persimmon": dict(TIER3_TINY, partial_rotary_factor=0.5, qk_layernorm=True,
                      hidden_act="relu2"),
    "apertus": dict(TIER3_TINY, hidden_act="xielu"),
    "orion": dict(TIER3_TINY, rms_norm_eps=1e-5),
    "opt": dict(TIER3_TINY, ffn_dim=512, activation_function="relu", tie_word_embeddings=True),
    "biogpt": dict(TIER3_TINY, hidden_act="gelu", tie_word_embeddings=True),
    "xglm": dict(d_model=256, attention_heads=4, num_layers=2, ffn_dim=512, vocab_size=512,
                 max_position_embeddings=4096, activation_function="gelu"),
    "gpt2": dict(n_embd=256, n_head=4, n_layer=2, n_inner=512, vocab_size=512, n_positions=256),
    "gpt_bigcode G 48": dict(n_embd=6144, n_head=48, n_layer=2, n_inner=1024, vocab_size=512,
                             n_positions=4096, multi_query=True),
}


def tier3_family(case, layers):
    """(module, config class, widths) of a phase 4o case (its registry
    type is the case's first word) at ``layers`` layers."""
    widths = TIER3_CASES[case]
    key = "n_layer" if "n_layer" in widths else "num_layers" if "d_model" in widths else (
        "num_hidden_layers")
    return dense_family(case.split()[0], **dict(widths, **{key: layers}))


def tier3_vs_cpu(torch, np, mods):
    """Phase 4o: TIER3_CASES at 2 layers, float32, batch 2: greedy
    generate() on the CPU (plain versions), through the card's graphs and
    on the card eagerly (run_three: tokens equal, logits within LOGIT_TOL,
    graphs equal to eager bit for bit), the attention and fused QKV kernels
    on (and the fused MLP on the gated MLPs), launches exact; at Falcon's
    and BigCode's groups the decode kernel runs in head tiles (5 and 3)."""
    from nxdi_tpu_torch.ops.kernels import flash_attention as fa

    L, NEW, P = 2, 24, 64
    out = {}
    for case in TIER3_CASES:
        family = tier3_family(case, L)
        cfg = family[1](mods[1](seq_len=256), **family[2])
        arch = family[0].build_arch(cfg)
        flags = family_flags(arch)
        apps, arch = three_apps(mods, layers=L, dtype="float32", batch=2, seq_len=256,
                                ctx_len=128, output_logits=True, family=family, **flags)
        ids, mask = prompts(np.random.default_rng(7), 2, P, [P, 53], arch.vocab_size)
        worst, toks, counts, n_same, _ = run_three(torch, mods, f"4o {case}", apps, ids, mask,
                                                   NEW, kernels=family_kernels())
        want = family_counts(L, 1, NEW - 1, flags["mlp_kernel_enabled"])
        assert counts == want, f"phase 4o {case}: launches {counts} != {want}"
        seen = strategies_of(apps[1])
        need = {"cte_flash_kernel", "tkg_fused_kernel_stacked", "qkv_fused_kernel"}
        if flags["mlp_kernel_enabled"]:
            need.add("mlp_fused_kernel")
        assert need <= seen, f"phase 4o {case}: strategies {seen} lack {need - seen}"
        G = arch.num_attention_heads // arch.num_kv_heads
        out[case] = dict(max_logit_err=worst, launches=counts, dispatches_bitwise=n_same,
                         head_dim=arch.head_dim, group=G,
                         head_tiles=fa.decode_head_tiles(arch.num_attention_heads,
                                                         arch.num_kv_heads),
                         switches=[k for k in ("learned_pos_embeds", "no_rope", "lm_head_bias",
                                               "parallel_block", "sandwich_norm", "qk_norm",
                                               "layernorm") if getattr(arch, k)],
                         hidden_act=arch.hidden_act, window=arch.sliding_window)
        log(f"[tier3-2L 4o {case}] generate(): max logit diff {worst:.3g}, graphs = eager over "
            f"{n_same} dispatches, launches {counts}, G {G} (head tiles "
            f"{out[case]['head_tiles']}), D {arch.head_dim}, act {arch.hidden_act}")
        del apps
        gc.collect()
    return out


# phase 5o's StarCoder2-15B prompts: 6144 tokens, past its 4096 window
STARCODER_PROMPT = 6144


def tier3_full_depth(torch, np, mods, card):
    """Phase 5o, bf16, graphs, the attention kernels on, random weights
    from seed 0 at the published widths, 32 new tokens: Falcon-7B whole
    (32 layers, G 71: the decode kernels in five head tiles) through
    generate() at B 8 on phase 5's prompt shapes, then the split paged
    engine over phase 5b's traffic (rows 1, 6 and 7 at G 71); StarCoder2-15B
    whole (40 layers) at B 2 x 6144 (its 4096 window live in the prefill and
    every step). Each with prefill ms, decode ms/step, a profiled decode
    step (busy, idle, device operations), KV cache and peak GB, launches
    exact."""
    from nxdi_tpu_torch.models.falcon import modeling_falcon as tf
    from nxdi_tpu_torch.models.starcoder2 import modeling_starcoder2 as ts

    ml, TorchConfig, ODSC, App, dense, _ = mods
    NEW, stats, launches = 32, {}, {}
    falcon = (tf, tf.FalconInferenceConfig, tf.FALCON_7B)
    starcoder = (ts, ts.Starcoder2InferenceConfig, ts.STARCODER2_15B)
    P6 = STARCODER_PROMPT
    for name, family, L, B, P, lengths, seq_len in (
            ("Falcon-7B", falcon, 32, 8, 1024, [1024, 1024, 1000, 1024, 731, 1024, 1024, 1023],
             2048),
            ("StarCoder2-15B", starcoder, 40, 2, P6, [P6, P6 - P6 // 32], P6 + 64)):
        tag = f"[tier3-5o {name}]"
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        app, arch = make_app(ml, TorchConfig, ODSC, App, dense, layers=L, dtype="bfloat16",
                             batch=B, seq_len=seq_len, ctx_len=P, device="cuda", family=family)
        gb = sum(v.numel() * v.element_size() for v in _leaves(app.params)) / 1e9
        log(f"{tag} {L} layers loaded {time.perf_counter() - t:.1f} s, params {gb:.2f} GB; "
            f"warmup {app.warm_stats}")
        ids, mask = prompts(np.random.default_rng(20), B, P, lengths, arch.vocab_size)
        run, _ = family_generate(torch, np, mods, tag, app, arch, ids, mask, NEW, {})
        seen = strategies_of(app)
        assert {"cte_flash_kernel", "tkg_fused_kernel_stacked"} <= seen, (name, seen)
        run.update(layers=L, param_gb=gb, cache_gb=cache_bytes(app) / 1e9,
                   peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
                   group=arch.num_attention_heads // arch.num_kv_heads,
                   window=arch.sliding_window, warmup=app.warm_stats)
        log(f"{tag} {card}: KV cache {run['cache_gb']:.3f} GB, peak allocated "
            f"{run['peak_allocated_gb']:.2f} GB, G {run['group']}, window {arch.sliding_window}")
        launches[name] = dict(run["launches"])
        stats[name] = run
        params = app.params
        del app
        gc.collect()
        torch.cuda.empty_cache()
        if name == "Falcon-7B":
            e_counts, e_stats = engine_full_depth(torch, np, mods, card, layers=L,
                                                  family=family, params=params, phase="5o")
            e_stats.pop("prompts")
            run["engine"], run["engine_launches"] = e_stats, e_counts
            for k, v in e_counts.items():
                launches[name][k] = launches[name].get(k, 0) + v
            log(f"{tag} split engine {e_stats['tok_s']:.1f} tok/s, TTFT p50 "
                f"{e_stats['ttft_p50_ms']:.2f} ms p95 {e_stats['ttft_p95_ms']:.2f} ms, TPOT p50 "
                f"{e_stats['tpot_p50_ms']:.3f} ms, launches {e_counts}")
        del params
        gc.collect()
        torch.cuda.empty_cache()
    stats["launches"] = launches
    return stats


# ---------------------------------------------------------------------------
# phases 3m, 4p and 5p: the paged prefill and ragged kernels at head dim 256,
# one-byte pools above 128, Gemma-2B's paged engines on them, and LoRA on
# Gemma
# ---------------------------------------------------------------------------

# max |kernel - plain| at head dim 256 (a bf16 pool): phase 3h's prefill
# bound (bf16 8e-3: a couple of output ulps near 0.5-1; f32 1e-5)
D256_TOL = {d: TOL[("prefill", d)] for d in ("float32", "bfloat16")}
# phase 4p: Gemma at Gemma-2B's attention shape (8 heads over 1 of 256, the
# tanh GELU, tied head), narrow elsewhere (hidden 256, intermediate 512,
# vocab 512)
GEMMA_SMALL = dict(FAMILY_TINY, num_attention_heads=8, num_key_value_heads=1, head_dim=256,
                   tie_word_embeddings=True, hidden_act="gelu_pytorch_tanh")


def gemma_family(**widths):
    from nxdi_tpu_torch.models.gemma import modeling_gemma as tg

    return tg, tg.GemmaInferenceConfig, dict(tg.GEMMA_2B, **widths)


def _gemma_pool(torch, gen, dev):
    """Phase 3m's pool at Gemma-2B's kv width: (k, v) bf16, their e4m3
    stores at E4M3_PT's scale, the (8, 16) table with a hole in row 3, the
    positions and the live mask."""
    B, bs, nblk, NB = 8, 128, 136, 16
    D, KV = GEMMA_HEADS["D"], GEMMA_HEADS["KV"]
    qpos = torch.linspace(0, 2000, B, device=dev).long()
    perm = torch.randperm(nblk, generator=torch.Generator().manual_seed(0)).tolist()
    bt = torch.full((B, NB), -1, dtype=torch.int32)
    nxt = 0
    for b in range(B):
        n = int(qpos[b]) // bs + 1
        bt[b, :n] = torch.tensor(perm[nxt:nxt + n], dtype=torch.int32)
        nxt += n
    bt[3, 2] = -1
    bt = bt.to(dev)
    kc, vc = (torch.randn((nblk * bs, KV, D), generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2))
    scale = E4M3_PT["k_scale"]
    k8, v8 = ((x.float() / scale).to(torch.float8_e4m3fn) for x in (kc, vc))
    slot_pos = torch.arange(NB * bs, device=dev)
    live = torch.repeat_interleave(bt >= 0, bs, dim=1) & (slot_pos[None] <= qpos[:, None])
    return dict(kc=kc, vc=vc, k8=k8, v8=v8, bt=bt, qpos=qpos, live=live, bs=bs, nblk=nblk,
                NB=NB, scale=scale, slot_pos=slot_pos)


def _gathered(torch, cache, table, bs):
    rows = (table.long()[:, :, None] * bs + torch.arange(bs, device=cache.device))
    return take_rows(torch, cache, rows.reshape(table.shape[0], -1).clamp(min=0)).transpose(1, 2)


def d256_paged_prefill(torch, results, fa, pool, gen, flush, dname, store):
    """Row 6 (a bf16 or f32 pool) or 6' (``store``: the e4m3 pool, per-tensor
    scales) at Gemma-2B's heads: a 512-token chunk after 512 cached through
    row 7's table, against its plain version, the same bits on a second
    call, the body by name; timed (median of PREFILL_CALLS flushed calls)
    beside the bound, the plain version and gather + SDPA."""
    import torch.nn.functional as F

    dev = pool["kc"].device
    H, KV, D = GEMMA_HEADS["H"], GEMMA_HEADS["KV"], GEMMA_HEADS["D"]
    dt = getattr(torch, dname)
    bs, Sq, start = pool["bs"], 512, 512
    bt1 = pool["bt"][7:8]
    if store:
        kc, vc, kw = pool["k8"], pool["v8"], dict(k_scale=pool["scale"], v_scale=pool["scale"])
    else:
        kc, vc, kw = pool["kc"].to(dt), pool["vc"].to(dt), {}
    qx = torch.randn((1, Sq, H, D), generator=gen, device=dev).to(dt).transpose(1, 2)
    qpx = (start + torch.arange(Sq, device=dev, dtype=torch.int32))[None]
    body = fa.paged_prefill_body(qx, kc, vc, bs)
    assert body == ("mma" if dname == "bfloat16" else "simt"), f"3m paged_prefill body {body}"

    def call():
        return fa.paged_attention_prefill(qx, kc, vc, bt1, qpx, block_size=bs, **kw)

    def plain():
        return fa.paged_attention_prefill_plain(qx, kc, vc, bt1, qpx, block_size=bs, **kw)

    got = call()
    err = (got.float() - plain().float()).abs().max().item()
    tol = (ONE_BYTE_TOL if store else D256_TOL)[dname]
    assert err <= tol, f"3m paged_prefill {dname} {store}: max abs err {err} > {tol}"
    assert torch.equal(call(), got), f"3m paged_prefill {dname} {store}: a second call differs"
    times, names, dropped = traced_times(torch, call, PREFILL_CALLS, flush, kernel="prefill")
    ms, lo, hi = spread(times)
    ran = sorted(attention_ms([(0.0, n) for n in names]))
    assert ran == [PREFILL_KERNEL[body]], f"3m paged_prefill {dname} {store}: ran {ran}"
    plain_ms = measure(torch, plain, n=3, flush=flush)
    pmask = (pool["slot_pos"][None, :] <= qpx[0][:, None])[None, None]

    def library():
        kg = _gathered(torch, kc, bt1, bs).to(dt).repeat_interleave(H // KV, dim=1)
        vg = _gathered(torch, vc, bt1, bs).to(dt).repeat_interleave(H // KV, dim=1)
        return F.scaled_dot_product_attention(qx, kg, vg, attn_mask=pmask)

    lib_times, _, lib_dropped = traced_times(torch, library, PREFILL_CALLS, flush)
    pairs = int(pmask.sum())
    es, kvs = qx.element_size(), kc.element_size()
    bms, by = bound_ms(2 * Sq * H * D * es + 2 * (start + Sq) * KV * D * kvs,
                       4 * H * D * pairs, dname)
    row = dict(kernel="paged_prefill", dtype=dname, head_dim=D, group=H // KV,
               point="Gemma-2B e4m3 pool D 256" if store else "Gemma-2B paged D 256",
               max_abs_err=err, tol=tol, ms=ms, ms_min=lo, ms_max=hi, plain_ms=plain_ms,
               library_ms=spread(lib_times)[0], bound_ms=bms, bound_by=by, body=body,
               kernels=ran, calls=len(times), untraced=dropped + lib_dropped,
               share_of_bound=bms / ms)
    if store:
        row["store"] = "float8_e4m3fn"
    results.append(row)
    log(f"[d256-3m] paged_prefill {dname}{' e4m3 pool' if store else ''} ({ran[0]}): err "
        f"{err:.3g} kernel {ms:.4f} ms (min {lo:.4f} max {hi:.4f}) plain {plain_ms:.4f} "
        f"gather + sdpa {row['library_ms']:.4f} bound {bms:.4f} ({by}), "
        f"{100 * bms / ms:.2f} % of the bound, {ms / row['library_ms']:.2f}x library")
    return row


def d256_ragged(torch, F, rpa, results, dname, point, q, kc, vc, case, bs, flush, kw=None,
                tol=None, extra=None):
    """Row 8 at one phase 3m point: the kernels under the plan the engine
    builds (the one-row tiles' body from ragged_direct_body) against the
    plain version, padding exactly 0, the same bits on a second call and
    from the graph-ready launch (the plan padded to the bucket's capacity);
    timed over RAGGED_CALLS flushed calls beside the bound, the plain
    version and gather + SDPA under the ragged mask."""
    kw = kw or {}
    T, rid, qp, bt, visible, pairs = case
    dev = q.device
    H, D = q.shape[1], q.shape[3]
    KV = kc.shape[1]
    G = H // KV
    R, NB = bt.shape
    wgmma = rpa.ragged_direct_body(q.dtype, kc.dtype, D, bs) == "wgmma"
    rid_h, qp_h = rid.cpu().numpy(), qp.cpu().numpy()
    plan_h = rpa.ragged_plan(rid_h, qp_h, R, NB * bs, KV, wgmma=wgmma)
    plan = plan_h.to(dev)
    cap = rpa.ragged_capacity(T, R, NB * bs, KV, wgmma=wgmma)
    static = dataclasses.replace(cap, flat=torch.from_numpy(rpa.pad_plan(plan_h, cap)).to(dev))

    def call(p=plan):
        return rpa.ragged_paged_attention(q, kc, vc, bt, rid, qp, block_size=bs, plan=p, **kw)

    def plain():
        return rpa.ragged_paged_attention_plain(q, kc, vc, bt, rid, qp, block_size=bs, **kw)

    got = call()
    err = (got.float() - plain().float()).abs().max().item()
    tol = tol if tol is not None else D256_TOL[dname]
    assert err <= tol, f"3m ragged {dname} {point}: max abs err {err} > {tol}"
    assert torch.all(got[:, :, rid < 0] == 0), f"3m ragged {point}: padding tokens are not 0"
    assert torch.equal(call(), got), f"3m ragged {dname} {point}: a second call differs"
    assert torch.equal(call(static), got), f"3m ragged {dname} {point}: graph-ready launch differs"
    times, names, dropped = traced_times(torch, call, RAGGED_CALLS, flush,
                                         kernel=("prefill", "ragged_"))
    ms, lo, hi = spread(times)
    W = NB * bs
    col = torch.arange(R * W, device=dev)
    rows = (bt.long().reshape(-1)[:, None] * bs + torch.arange(bs, device=dev)).reshape(-1)
    live = torch.repeat_interleave(bt.reshape(-1) >= 0, bs)
    mask = ((rid.long()[:, None] == col[None] // W) & (col[None] % W <= qp.long()[:, None])
            & live[None])[None, None]

    def library():
        kg = take_rows(torch, kc, rows.clamp(min=0)).to(q.dtype).transpose(0, 1)[None]
        vg = take_rows(torch, vc, rows.clamp(min=0)).to(q.dtype).transpose(0, 1)[None]
        return F.scaled_dot_product_attention(q, kg.repeat_interleave(G, dim=1),
                                              vg.repeat_interleave(G, dim=1), attn_mask=mask)

    lib_times, _, lib_dropped = traced_times(torch, library, RAGGED_CALLS, flush)
    plain_ms = measure(torch, plain, n=2, flush=flush)
    es, kvs = q.element_size(), kc.element_size()
    T_real = int((rid >= 0).sum())
    nbytes = ((T_real * H * D + T * H * D) * es + 2 * sum(visible.values()) * KV * D * kvs
              + bt.numel() * 4 + 4 * T + 4 * T_real)
    bms, by = bound_ms(nbytes, 4 * H * D * pairs, dname)
    kernels = sorted(attention_ms([(0.0, n) for n in names]))
    row = dict(kernel="ragged", dtype=dname, point=point, head_dim=D, group=G, block=bs, T=T,
               max_abs_err=err, tol=tol, ms=ms, ms_min=lo, ms_max=hi, plain_ms=plain_ms,
               library_ms=spread(lib_times)[0], bound_ms=bms, bound_by=by, kernels=kernels,
               calls=len(times), untraced=dropped + lib_dropped, share_of_bound=bms / ms,
               plan=dict(direct=plan.n_direct, wgmma=plan.n_wg, items=plan.n_items,
                         combine=plan.n_comb, chunk=plan.chunk), **(extra or {}))
    results.append(row)
    log(f"[d256-3m] ragged {dname} {point} ({' + '.join(kernels)}; plan {row['plan']}): err "
        f"{err:.3g} kernel {ms:.4f} ms (min {lo:.4f} max {hi:.4f}) plain {plain_ms:.4f} "
        f"gather + sdpa {row['library_ms']:.4f} bound {bms:.4f} ({by}), "
        f"{100 * bms / ms:.2f} % of the bound, {ms / row['library_ms']:.2f}x library")
    return row


def check_d256_kernels(torch, results):
    """Phase 3m. At Gemma-2B's heads (8 over 1 kv head of 256): row 6 (the
    paged prefill's mma.sync body in bf16, the CUDA-core body in f32), row 6'
    (the same over an e4m3 pool, tiles converted as they land), row 7' (the
    paged decode over the e4m3 pool, bf16 q at 2 warps a block on the tensor
    cores; f32 q checked), row 8 (the ragged kernel at phase 3c's packed
    1032-token stream and decode-only bucket 8: direct tiles, split items
    at 2 warps a block, the combine over 256 columns; f32 at the packed
    stream) and row 8' (the packed stream over the e4m3 pool); then row 8 at
    phase 3l's multi-query groups (G 71 and G 48, bf16) timed. Each against
    its plain version, timed (medians of 21 flushed calls) beside its bound,
    the plain version and gather + SDPA."""
    import torch.nn.functional as F

    from nxdi_tpu_torch.ops.kernels import flash_attention as fa
    from nxdi_tpu_torch.ops.kernels import ragged_paged_attention as rpa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2121)
    scratch = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)

    def flush():
        scratch.zero_()

    H, KV, D = GEMMA_HEADS["H"], GEMMA_HEADS["KV"], GEMMA_HEADS["D"]
    pool = _gemma_pool(torch, gen, dev)
    bs, bt, qpos, live = pool["bs"], pool["bt"], pool["qpos"], pool["live"]
    B = bt.shape[0]
    visible = int(live.sum())
    sc = dict(k_scale=pool["scale"], v_scale=pool["scale"])

    # row 7': the paged decode over the e4m3 pool
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        q = torch.randn((B, 1, H, D), generator=gen, device=dev).to(dt).transpose(1, 2)
        qp = qpos[:, None].to(torch.int32)

        def library(q=q, dt=dt):
            kg = _gathered(torch, pool["k8"], bt, bs).to(dt).repeat_interleave(H // KV, dim=1)
            vg = _gathered(torch, pool["v8"], bt, bs).to(dt).repeat_interleave(H // KV, dim=1)
            return F.scaled_dot_product_attention(q, kg * pool["scale"], vg * pool["scale"],
                                                  attn_mask=live[:, None, None, :])

        bf16_pool = (pool["k8"].to(dt), pool["v8"].to(dt))  # the up-cast pool
        row = one_byte_point(
            torch, results, "paged_decode", "float8_e4m3fn",
            lambda q=q, qp=qp: fa.paged_attention_decode(q, pool["k8"], pool["v8"], bt, qp,
                                                         block_size=bs, **sc),
            lambda q=q, qp=qp: fa.paged_attention_decode_plain(q, pool["k8"], pool["v8"], bt,
                                                               qp, block_size=bs, **sc),
            library, (visible * KV * D * 2 + 2 * B * H * D * q.element_size() + bt.numel() * 4),
            4 * H * D * visible, flush, DECODE_KERNELS, timed=dname == "bfloat16",
            dname=dname,
            bf16_call=(lambda q=q, qp=qp, p=bf16_pool: fa.paged_attention_decode(
                q, p[0], p[1], bt, qp, block_size=bs, **sc)) if dname == "bfloat16" else None)
        row.update(point="Gemma-2B e4m3 pool D 256", head_dim=D, group=H // KV)
        if dname == "bfloat16":  # the up-cast pool gives the same bits
            assert torch.equal(
                fa.paged_attention_decode(q, pool["k8"], pool["v8"], bt, qp, block_size=bs,
                                          **sc),
                fa.paged_attention_decode(q, *bf16_pool, bt, qp, block_size=bs, **sc)), \
                "3m paged_decode e4m3: not the up-cast pool's bits"
        del bf16_pool
    # rows 6 and 6'
    for dname in ("bfloat16", "float32"):
        d256_paged_prefill(torch, results, fa, pool, gen, flush, dname, store=None)
    for dname in ("bfloat16", "float32"):
        d256_paged_prefill(torch, results, fa, pool, gen, flush, dname, store="e4m3")
    torch.cuda.empty_cache()
    # rows 8 and 8': phase 3c's streams at Gemma-2B's heads
    R, NB, nblk = 8, 16, pool["nblk"]
    packed = ragged_case(torch, dev, R, NB, bs, nblk)
    decode8 = ragged_case(torch, dev, R, NB, bs, nblk, decode_only=True)
    for dname, case, point in (("bfloat16", packed, "Gemma-2B paged D 256"),
                               ("bfloat16", decode8, "Gemma-2B paged D 256 bucket 8"),
                               ("float32", packed, "Gemma-2B paged D 256")):
        dt = getattr(torch, dname)
        q = torch.randn((1, case[0], H, D), generator=gen, device=dev).to(dt).transpose(1, 2)
        d256_ragged(torch, F, rpa, results, dname, point, q, pool["kc"].to(dt),
                    pool["vc"].to(dt), case, bs, flush)
    q = torch.randn((1, packed[0], H, D), generator=gen, device=dev).to(torch.bfloat16)
    row = d256_ragged(torch, F, rpa, results, "bfloat16", "Gemma-2B e4m3 pool D 256",
                      q.transpose(1, 2), pool["k8"], pool["v8"], packed, bs, flush, kw=sc,
                      tol=ONE_BYTE_TOL["bfloat16"], extra=dict(store="float8_e4m3fn"))
    qf = q.float().transpose(1, 2)
    err = (rpa.ragged_paged_attention(qf, pool["k8"], pool["v8"], packed[3], packed[1],
                                      packed[2], block_size=bs, **sc).float()
           - rpa.ragged_paged_attention_plain(qf, pool["k8"], pool["v8"], packed[3], packed[1],
                                              packed[2], block_size=bs, **sc)).abs().max().item()
    assert err <= ONE_BYTE_TOL["float32"], f"3m ragged f32 e4m3: max abs err {err}"
    row["float32_err"] = err
    log(f"[d256-3m] ragged float32 e4m3 pool (checked): err {err:.3g}")
    del pool, q, qf
    torch.cuda.empty_cache()
    # row 8 at the multi-query groups (phase 3l checked them; here timed)
    for point, c in MQA_HEADS.items():
        H2, KV2, D2 = c["H"], c["KV"], c["D"]
        T, bs2, NB2, R2 = 160, 128, 16, 3
        rows = [(2, 100, 130), (0, 1900, 1), (1, 7, 1)]
        perm = torch.randperm(R2 * NB2, generator=torch.Generator().manual_seed(7)).tolist()
        bt2 = torch.full((R2, NB2), -1, dtype=torch.int32)
        rid, qp = torch.full((T,), -1, dtype=torch.int32), torch.zeros((T,), dtype=torch.int32)
        t, nxt, pairs, vis = 0, 0, 0, {}
        for slot, start, n in rows:
            rid[t:t + n] = slot
            qp[t:t + n] = torch.arange(start, start + n, dtype=torch.int32)
            t += n
            nb = (start + n - 1) // bs2 + 1
            bt2[slot, :nb] = torch.tensor(perm[nxt:nxt + nb], dtype=torch.int32)
            nxt += nb
            pairs += sum(range(start + 1, start + n + 1))
            vis[slot] = start + n
        case = (T, rid.to(dev), qp.to(dev), bt2.to(dev), vis, pairs)
        kc, vc = (torch.randn((R2 * NB2 * bs2, KV2, D2), generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(2))
        q = torch.randn((1, T, H2, D2), generator=gen, device=dev).to(torch.bfloat16)
        d256_ragged(torch, F, rpa, results, "bfloat16", point, q.transpose(1, 2), kc, vc, case,
                    bs2, flush, tol=NEW_TOL[("ragged", "bfloat16")])
    del scratch
    torch.cuda.empty_cache()


def gemma_paged_vs_cpu(torch, np, mods):
    """Phase 4p: Gemma at Gemma-2B's attention shape (GEMMA_SMALL), 2
    layers, float32: the split paged engine (rows 1, 6 and 7 at head dim
    256), the mixed engine (rows 8, 9/10 and 11/12) and both on an e4m3 pool
    with per-tensor scales (rows 6', 7', 8'), each CPU vs card graphs vs
    card eager over phase 4b's traffic (engine_vs_cpu: launches exact,
    streams identical, logits within tolerance); then the LoRA app
    (lora_vs_cpu: two rank-16 adapters and the base in one batch, held to
    merged weights, a swap after capture)."""
    family = gemma_family(**GEMMA_SMALL)
    out = {}
    for mixed in (False, True):
        for kvq in (None, E4M3_PT):
            name = ("mixed" if mixed else "split") + (" e4m3" if kvq else "")
            counts, worst = engine_vs_cpu(torch, np, mods, mixed=mixed, kvq=kvq, family=family,
                                          phase=f"4p {name}")
            out[name] = dict(launches=counts, max_logit_err=worst)
            gc.collect()
    out["lora"] = lora_vs_cpu(torch, np, mods, family=family, phase="4p lora")
    gc.collect()
    return out


def gemma_lora_full_depth(torch, np, mods, card, layers):
    """Phase 5p's LoRA run: Gemma-2B at ``layers`` layers, bf16, batch 8,
    graphs, rank-16 adapters on all seven projections in 4 slots;
    generate() on phase 5's prompt shapes, 32 new tokens, rows on adapters
    1, 2, 3, 4, 0, 1, 2, 0 and every row on the base slot: the base slot's
    tokens equal to the same model's without LoRA (a zero delta adds
    nothing), the adapters moving the prefill logits of their rows off the
    model's without LoRA (the greedy tokens of a random model may still
    agree), launches exact; adapter 1 merged into the weights (W + s A B)
    against the LoRA rows on adapter 1 (rows 0 and 5) over the prefill
    logits."""
    ml, TorchConfig, ODSC, App, dense, Adapter = mods
    L, B, P, NEW = layers, 8, 1024, 32
    family = gemma_family()
    lora = dict(max_loras=4, max_lora_rank=LORA_RANK, target_modules=LORA_TARGETS,
                lora_dtype="bfloat16", lora_alpha=LORA_ALPHA)
    kw = dict(layers=L, dtype="bfloat16", batch=B, seq_len=2048, ctx_len=P, device="cuda",
              output_logits=True, family=family)
    t = time.perf_counter()
    app, arch = make_app(ml, TorchConfig, ODSC, App, dense, lora_config=lora, **kw)
    for n, name in enumerate("abcd"):
        slot = app.set_lora_adapter(name, peft_adapter(torch, arch, seed=30 + n),
                                    {"r": LORA_RANK, "lora_alpha": LORA_ALPHA})
        assert slot == n + 1
    log(f"[gemma-lora-5p] {L} layers loaded, 4 adapters resident {time.perf_counter() - t:.1f} "
        f"s; warmup {app.warm_stats}")
    ids, mask = prompts(np.random.default_rng(11), B, P, [P, P, 1000, P, 731, P, P, 1023],
                        arch.vocab_size)
    rows = {"mixed": np.array([1, 2, 3, 4, 0, 1, 2, 0], np.int32),
            "base": np.zeros((B,), np.int32)}
    kernels = attention_kernels()
    runs, outs = {}, {}
    for mode in ("mixed", "base"):
        for fn in kernels.values():
            fn.launches = 0
        prefill_ms, decode_ms, toks = timed_generate(torch, Adapter, app, ids, mask, NEW,
                                                     adapter_ids=rows[mode])
        counts = {k: fn.launches for k, fn in kernels.items()}
        want = dict.fromkeys(counts, 0)
        want.update(prefill=L, decode=L * (NEW - 1), commit=NEW - 1)
        assert counts == want, f"phase 5p lora {mode}: launches {counts} != {want}"
        runs[mode] = dict(prefill_ms=prefill_ms, decode_ms=decode_ms, launches=counts)
        outs[mode] = toks
        log(f"[gemma-lora-5p] {mode} rows: prefill {prefill_ms:.2f} ms, decode {decode_ms:.3f} "
            f"ms/step; launches {counts}")
    lora_logs = []  # the adapter rows' prefill logits, for the merged check
    recording(app, lora_logs)
    Adapter(app).generate(ids, attention_mask=mask, max_new_tokens=1, adapter_ids=rows["mixed"])
    params = app.params
    del app
    gc.collect()
    torch.cuda.empty_cache()
    # the same model without LoRA: the base slot's tokens, bit for bit
    base_params = merged_params(params, 0)
    base_app, _ = make_app(ml, TorchConfig, ODSC, App, dense, params=base_params, **kw)
    base_logs = []
    recording(base_app, base_logs)
    want_base = Adapter(base_app).generate(ids, attention_mask=mask, max_new_tokens=NEW)
    assert (outs["base"] == want_base).all(), "phase 5p lora: the base slot's tokens differ"
    del base_app, base_params
    gc.collect()
    torch.cuda.empty_cache()
    changed = int(sum(not (outs["mixed"][b] == outs["base"][b]).all() for b in range(B)))
    on = torch.from_numpy(rows["mixed"] != 0)
    moved = (lora_logs[0][on].float() - base_logs[0][on].float()).abs().max().item()
    same = torch.equal(lora_logs[0][~on], base_logs[0][~on])
    assert moved > 0 and same, (f"phase 5p lora: the adapters moved their rows' prefill logits "
                                f"by {moved}; the base rows equal: {same}")
    merged_app, _ = make_app(ml, TorchConfig, ODSC, App, dense, params=merged_params(params, 1),
                             **kw)
    mlogs = []
    recording(merged_app, mlogs)
    Adapter(merged_app).generate(ids, attention_mask=mask, max_new_tokens=1)
    lora_pf, merged_pf = lora_logs[0][[0, 5]], mlogs[0][[0, 5]]
    merged_err = (lora_pf.float() - merged_pf.float()).abs().max().item()
    scale = merged_pf.float().abs().max().item()
    agree = int((lora_pf.argmax(-1) == merged_pf.argmax(-1)).sum())
    assert torch.isfinite(lora_pf).all() and merged_err <= 0.1 * scale, (
        f"phase 5p lora: adapter 1 vs merged weights, prefill logits differ by {merged_err} "
        f"(logits up to {scale})")
    del merged_app, params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[gemma-lora-5p] {card}: decode ms/step mixed adapters {runs['mixed']['decode_ms']:.3f}, "
        f"all base {runs['base']['decode_ms']:.3f}; adapters moved their rows' prefill logits by "
        f"{moved:.3g}, their greedy tokens on {changed}/{B - 2} rows; base slot = the model "
        f"without LoRA bit for bit; adapter 1 vs merged weights: "
        f"prefill logits within {merged_err:.3g} (logits up to {scale:.3g}), first token agrees "
        f"on {agree} of 2 rows")
    return dict(layers=L, runs=runs, rows_changed=changed, adapter_logit_shift=moved,
                merged_prefill_max_logit_err=merged_err,
                merged_logit_scale=scale, merged_first_token_agree=agree)


def gemma_paged_full_depth(torch, np, mods, card):
    """Phase 5p: Gemma-2B whole (18 layers, bf16, random weights from seed
    0, graphs) on the split paged engine over phase 5b's traffic (rows 1, 6
    and 7 at head dim 256), on the mixed engine (rows 8, 9/10, 11/12), and
    both on an e4m3 pool with per-tensor scales (rows 6', 7', 8'), launches
    exact and the strategies named (engine_full_depth); KV pool bytes of
    each; then the LoRA run (gemma_lora_full_depth, 18 layers)."""
    L = 18
    family = gemma_family()
    stats, launches = {}, {}
    for mixed in (False, True):
        params = None  # one set of weights a dispatch mode (the mixed one fuses QKV)
        for kvq in (None, E4M3_PT):
            name = ("mixed" if mixed else "split") + (" e4m3" if kvq else "")
            gc.collect()
            torch.cuda.empty_cache()
            counts, st = engine_full_depth(torch, np, mods, card, mixed=mixed, kvq=kvq,
                                           layers=L, family=family, params=params,
                                           keep_app=params is None, phase=f"5p {name}")
            if params is None:
                params = st.pop("app").params
            st.pop("prompts")
            stats[name], launches[name] = st, counts
            log(f"[gemma-5p {name}] {card}: {st['tok_s']:.1f} tok/s, TTFT p50 "
                f"{st['ttft_p50_ms']:.2f} ms p95 {st['ttft_p95_ms']:.2f} ms, TPOT p50 "
                f"{st['tpot_p50_ms']:.3f} ms, KV pool {st['pool_bytes'] / 1e9:.3f} GB "
                f"{st['pool_dtype']}; launches {counts}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    stats["lora"] = gemma_lora_full_depth(torch, np, mods, card, layers=L)
    stats["launches"] = launches
    return stats


# ---------------------------------------------------------------------------
# phases 4q and 5q: speculation and the mixed step on the family switches
# ---------------------------------------------------------------------------

RING8 = dict(window_sized_kv=True, sliding_window=8)
# phase 4q: one family per switch group at tiny widths, 2 layers, f32, batch
# 2, 40-token prompts (past the windows and chunks of 8): (registry type,
# widths (None: DeepSeek-V3's MLA_SMALL), ring keys, the speculation kinds it
# runs, whether its mixed engine runs): every kind on every case but
# Medusa on a ring. "fused" and "standard" take the target's own weights as
# a full-cache draft (every fused window accepted whole), "eagle" /
# "eagle3" (Gemma-3's ring: the aux features through its interleaved
# stack) a random 1-layer EAGLE draft at the target's width, "chain" three
# random Medusa heads. A ring is no paged pool, and MLA takes
# the paged layout nowhere, so those run no mixed engine of their own (the
# Mistral ring's family does, on its pool)
FSPEC_KINDS = ("fused", "standard", "eagle", "chain")
FSPEC_RING_KINDS = ("fused", "standard", "eagle")  # config.py refuses Medusa on a ring
FSPEC_CASES = {
    "mistral ring": ("mistral", dict(FAMILY_TINY, sliding_window=8), RING8, FSPEC_RING_KINDS,
                     True),
    "gemma3_text ring": ("gemma3_text", dict(FAMILY_TINY, **GEMMA_CASES["gemma3_text ring"][1]),
                         RING8, ("fused", "standard", "eagle3"), False),
    "gpt_oss sink": ("gpt_oss", dict(FAMILY_TINY, **MOE_FAMILY_CASES["gpt_oss"]), {},
                     FSPEC_KINDS, True),
    "gemma2 softcap": ("gemma2", dict(FAMILY_TINY, **GEMMA_CASES["gemma2"][1]), {},
                       FSPEC_KINDS, True),
    "llama4_text chunk": ("llama4_text", SCOUT_TINY, {}, FSPEC_KINDS, True),
    "falcon G 71 LayerNorm": ("falcon", TIER3_CASES["falcon G 71"], {}, FSPEC_KINDS, True),
    "opt learned positions": ("opt", TIER3_CASES["opt"], {}, FSPEC_KINDS, True),
    "deepseek MLA": ("deepseek_v3", None, {}, FSPEC_KINDS, False),
}
FSPEC_EAGLE3_VOCAB = 256  # phase 4q's EAGLE3 draft vocab (d2t into the target's 512)


def fspec_family(case):
    model_type, widths, *_ = FSPEC_CASES[case]
    return deepseek_family(**MLA_SMALL) if widths is None else dense_family(model_type, **widths)


def fspec_flags(arch):
    """The attention kernels unless the model has sinks, the logit softcap
    or MLA (an enabled flag raises on the card); no projection kernel (the
    rings refuse them, and phase 4q counts rows 1, 3, 4 and 5)."""
    attn = not (arch.attention_sink or arch.attn_logit_softcap is not None
                or arch.mla is not None)
    return dict(attn_kernel_enabled=attn, attn_tkg_kernel_enabled=attn)


def fspec_mixed_flags(arch):
    """A family's mixed engine: the ragged kernel unless the model has a
    window, a chunk, sinks or the softcap (row 8 takes none: the JAX rule;
    an enabled flag raises on the card), the fused QKV kernel, the fused MLP
    on a gated dense MLP."""
    attn = (arch.sliding_window is None and arch.chunk_size is None
            and fspec_flags(arch)["attn_kernel_enabled"])
    return dict(attn_kernel_enabled=attn, attn_tkg_kernel_enabled=attn,
                attn_block_tkg_kernel_enabled=attn, fused_qkv=True, qkv_kernel_enabled=True,
                mlp_kernel_enabled=arch.moe is None and arch.gated_mlp and not arch.mlp_bias)


def to_dev(tree, dev):
    """A params tree (dicts, segment lists, tensors) on ``dev``."""
    if isinstance(tree, dict):
        return {k: to_dev(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_dev(v, dev) for v in tree]
    return tree.to(dev)


def fspec_eagle_cfg(mods, cfg, eagle3, **tc):
    """A 1-layer EAGLE draft's config at the target's width (heads of 64;
    EAGLE3: FSPEC_EAGLE3_VOCAB tokens)."""
    from nxdi_tpu_torch.models import llama_eagle as le

    H = cfg.hidden_size
    heads = H // 64
    return le.LlamaEagleInferenceConfig(
        mods[1](is_eagle3=eagle3, **tc), hidden_size=H, intermediate_size=2 * H,
        num_attention_heads=heads, num_key_value_heads=2 if heads % 2 == 0 else 1, head_dim=64,
        num_hidden_layers=1, vocab_size=FSPEC_EAGLE3_VOCAB if eagle3 else cfg.vocab_size,
        max_position_embeddings=4096, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=False)


def fspec_params(torch, mods, family, cfg, arch, kinds, tc):
    """The CPU weights of a phase 4q case: the target (seed 0), three Medusa
    heads (seed 2) and the EAGLE drafts its kinds need (seed 1)."""
    from nxdi_tpu_torch.models import llama_eagle as le

    dense = mods[4]
    out = {"target": random_weights(dense, family[0], cfg, arch, "cpu")}
    g = torch.Generator().manual_seed(2)
    H, V, K = arch.hidden_size, arch.vocab_size, 3
    out["heads"] = {"res_w": torch.randn((K, H, H), generator=g) * 0.02,
                    "res_b": torch.randn((K, H), generator=g) * 0.02,
                    "head": torch.randn((K, H, V), generator=g) * 0.02}
    for kind in kinds:
        if kind in ("eagle", "eagle3"):
            out[kind] = le.random_params(fspec_eagle_cfg(mods, cfg, kind == "eagle3", **tc),
                                         out["target"], target_num_layers=arch.num_layers,
                                         seed=1, device="cpu")
    return out


def fspec_app(mods, kind, family, params, *, layers, batch, seq_len, ctx_len, device, graphs,
              spec_len, ring_kw, flags):
    """A phase 4q speculation app on ``family``, loaded and warmed up: the
    target carries ``ring_kw`` (its ring), every draft a full cache."""
    from nxdi_tpu_torch.models import llama_eagle as le
    from nxdi_tpu_torch.speculation import (
        EagleSpecCausalLM,
        FusedSpecCausalLM,
        MedusaCausalLM,
        StandardSpecCausalLM,
    )

    ml, TorchConfig, ODSC, _, _, _ = mods
    module = family[0]
    base = dict(tp_degree=1, batch_size=batch, seq_len=seq_len, max_context_length=ctx_len,
                dtype="float32", on_device_sampling_config=ODSC(), skip_warmup=True, **flags)

    def cfg(**extra):
        return model_config(ml, TorchConfig(**base, **extra), layers, family)[1]

    target = params["target"]
    if kind in ("fused", "standard"):
        tcfg = cfg(**ring_kw, speculation_length=spec_len,
                   enable_fused_speculation=kind == "fused")
        if kind == "fused":
            pair = {"target": target, "draft": target}

            class Fused(FusedSpecCausalLM):
                def build_params(self):
                    return pair

            app = Fused("<t>", tcfg, "<d>", cfg(), model_family=module, device=device,
                        graphs=graphs)
        else:
            app = StandardSpecCausalLM("<t>", tcfg, "<d>", cfg(), model_family=module,
                                       device=device, graphs=graphs)
            app.target.build_params = app.draft.build_params = lambda: target
    elif kind in ("eagle", "eagle3"):
        e3 = kind == "eagle3"
        tcfg = cfg(**ring_kw, speculation_length=spec_len, enable_eagle_speculation=True,
                   is_eagle3=e3)
        pair = {"target": target, "draft": params[kind]}

        class Eagle(EagleSpecCausalLM):
            def build_params(self):
                return pair

        # the draft (Llama layers) takes the attention kernels whatever the target's flags
        dcfg = fspec_eagle_cfg(mods, tcfg, e3, **dict(base, attn_kernel_enabled=True,
                                                       attn_tkg_kernel_enabled=True))
        app = Eagle("<t>", tcfg, "<d>", dcfg, model_family=module, draft_family=le,
                    device=device, graphs=graphs)
    else:  # a Medusa chain
        K = params["heads"]["res_w"].shape[0]
        full = dict(target, medusa_heads=params["heads"])

        class Medusa(MedusaCausalLM):
            def build_params(self):
                return full

        app = Medusa("<t>", cfg(is_medusa=True, num_medusa_heads=K,
                                medusa_speculation_length=K + 1),
                     model_family=module, device=device, graphs=graphs)
    app.load()
    for a in ((app.target, app.draft) if kind == "standard" else (app,)):
        if a.device.type == "cuda":
            a.warmup()
    return app


def fspec_counts(kind, run, t_arch, d_arch, ring, attn, spec_len):
    """The launches of a phase 4q / 5q speculation run, by kernel. A
    context encoding: a prefill a layer where the attention kernels run, a
    commit a layer into a homogeneous ring and a commit a window layer into
    an interleaved one (a contiguous cache's slice write launches nothing;
    MLA attends plainly). A draft step (always a full cache): a stacked
    decode a layer (where the attention kernels run) and one commit, or, on
    MLA, a commit a layer. The verify: one commit a stack (two on an
    interleaved ring; the homogeneous ring's multi-token rows defer too), a
    commit a layer on MLA. EAGLE's 1-layer draft: a prefill, and a decode
    and a commit a step; a Medusa chain window: the verify alone."""
    want = dict(prefill=0, decode=0, commit=0)

    def add(d, times=1):
        for k, v in d.items():
            want[k] += v * times

    def ce(arch, ring_kind):
        L = arch.num_layers
        add(dict(prefill=L if attn and arch.mla is None else 0,
                 commit=(L if ring_kind == "ring" else arch.interleaved_split()[1]
                         if ring_kind == "interleaved" else 0)))

    def step(arch):
        if arch.mla is not None:
            return dict(commit=arch.num_layers)
        return dict(decode=arch.num_layers if attn else 0, commit=1)

    n, W = run["n_windows"], spec_len + 1
    ce(t_arch, ring)
    if kind in ("fused", "standard"):
        ce(d_arch, None)
        add(step(d_arch), n * (W if kind == "fused" else spec_len))
    elif kind in ("eagle", "eagle3"):
        add(dict(prefill=1))
        add(dict(decode=1, commit=1), n * W)
    add(dict(commit=t_arch.num_layers if t_arch.mla is not None
             else 2 if ring == "interleaved" else 1), n)
    return want


def family_spec_vs_cpu(torch, np, mods):
    """Phase 4q: FSPEC_CASES at tiny widths, 2 layers, float32, batch 2,
    spec_len 3: the non-speculative stream on the CPU and the card (logits
    within LOGIT_TOL, tokens equal), then each speculation kind on the CPU
    (plain versions), through the card's graphs and on the card eagerly:
    tokens equal the CPU's and the card's non-speculative stream on the same
    cache (its ring too), the window counts equal the CPU's, a perfect fused
    draft accepts whole windows, every cache tensor graphs = eager bit for
    bit, launches exact (fspec_counts: rows 1, 3 and 4; the rings' context
    encodings write through row 4, MLA's draft steps and verify a commit a
    layer). Then each family's mixed engine
    (engine_vs_cpu over phase 4b's traffic: streams equal, logits within
    LOGIT_TOL, graphs = eager bit for bit, launches exact): the ragged
    kernel where the family takes it (Falcon's G 71, OPT), plainly under a
    window, chunk, sink or softcap."""
    ml, TorchConfig, ODSC, App, dense, Adapter = mods
    L, B, P, NEW, K_SPEC = 2, 2, 40, 16, 3
    geo = dict(seq_len=128, ctx_len=64)
    out = {}
    for case, (_, _, ring_kw, kinds, mixed) in FSPEC_CASES.items():
        t0 = time.perf_counter()
        family = fspec_family(case)
        module, cfg = model_config(ml, TorchConfig(seq_len=128, max_context_length=64,
                                                   dtype="float32", **ring_kw), L, family)
        arch = module.build_arch(cfg)
        flags = fspec_flags(arch)
        ring = None if not ring_kw else "interleaved" if arch.interleaved_split() else "ring"
        cpu = fspec_params(torch, mods, family, cfg, arch, kinds, dict(dtype="float32", **flags))
        gpu = to_dev(cpu, "cuda")
        ids, mask = prompts(np.random.default_rng(7), B, P, [P, P - 11], arch.vocab_size)
        plain, plain_logs = {}, {}
        for dev, params in (("cpu", cpu), ("cuda", gpu)):
            app, _ = make_app(ml, TorchConfig, ODSC, App, dense, layers=L, dtype="float32",
                              batch=B, device=dev, params=params["target"], family=family,
                              output_logits=True, **geo, **flags, **ring_kw)
            plain_logs[dev] = []
            recording(app, plain_logs[dev])
            plain[dev] = Adapter(app).generate(ids, attention_mask=mask, max_new_tokens=NEW)
            del app
        plain_err, _, flip = logits_within(torch, f"4q {case}", plain_logs["cpu"],
                                           plain_logs["cuda"], LOGIT_TOL)
        assert flip is None and (plain["cpu"] == plain["cuda"]).all(), \
            f"phase 4q {case}: plain streams differ"
        res = out[case] = {"ring": ring, "flags": flags, "plain_max_logit_err": plain_err}
        for kind in kinds:
            name = f"{case} {kind}"
            runs = {}
            for mode, dev, graphs in (("cpu", "cpu", True), ("graphs", "cuda", True),
                                      ("eager", "cuda", False)):
                app = fspec_app(mods, kind, family, cpu if dev == "cpu" else gpu, layers=L,
                                batch=B, device=dev, graphs=graphs, spec_len=K_SPEC,
                                ring_kw=ring_kw, flags=flags, **geo)
                if mode == "graphs" and kind != "standard":
                    cache = app.kv_cache.get("target", app.kv_cache)
                    if ring == "ring":
                        assert cache["k"].shape[3] == 8 + K_SPEC + 1, cache["k"].shape
                    if ring == "interleaved":
                        assert cache["k_win"].shape[3] == 8 + K_SPEC + 1, cache["k_win"].shape
                    if "draft" in app.kv_cache and kind == "fused":
                        assert "k_win" not in app.kv_cache["draft"]
                        assert app.kv_cache["draft"]["k"].shape[3] == 128
                # every run from zeroed caches: the card's warmup leaves dummy rows
                app.reset_kv_cache()
                runs[mode] = spec_run(torch, Adapter, app, ids, mask, NEW)
                runs[mode]["caches"] = {k: v.detach().cpu().clone()
                                        for k, v in spec_caches(app).items()}
                if mode == "graphs":
                    for tag in SPEC_TAGS:
                        if tag in getattr(app, "models", {}):
                            assert all(bg.graph is not None
                                       for bg in app.models[tag].bucket_graphs.values())
                d_arch = (app.draft.models["token_generation_model"].arch if kind == "standard"
                          else getattr(next(iter(app.models.values())), "draft_arch", None))
                del app
            g, e, c = runs["graphs"], runs["eager"], runs["cpu"]
            assert (g["tokens"] == e["tokens"]).all(), f"phase 4q {name}: graphs != eager"
            assert (g["tokens"] == c["tokens"]).all(), f"phase 4q {name}: CPU != card"
            assert (g["tokens"] == plain["cuda"]).all(), \
                f"phase 4q {name}: tokens differ from the non-speculative stream"
            assert g["windows"] == e["windows"] == c["windows"], \
                f"phase 4q {name}: window counts {g['windows']} / {c['windows']}"
            # the caches graphs = eager; against the CPU's the rows of rejected
            # drafts may hold other tokens (a random draft's near-uniform logits
            # can break a tie the other way) and are never read, so the CPU is
            # held by the tokens, the window counts and the plain logits above
            for k in g["caches"]:
                assert torch.equal(g["caches"][k], e["caches"][k]), \
                    f"phase 4q {name}: graph and eager {k} differ"
            if kind == "fused":
                short = [w for w in g["windows"][:-1] if w != [K_SPEC + 1] * B]
                assert not short, f"phase 4q {name}: a perfect draft left windows {short}"
            want = fspec_counts(kind, g, arch, d_arch, ring, flags["attn_kernel_enabled"],
                                K_SPEC)
            assert g["launches"] == e["launches"] == want, \
                f"phase 4q {name}: launches {g['launches']} / {e['launches']} != {want}"
            res[kind] = dict(windows=len(g["windows"]), launches=g["launches"],
                             mean_accepted=g["accepted"] / max(g["n_windows"], 1) / B)
            log(f"[fspec-2L 4q] {name}: tokens = CPU = eager = non-speculative; "
                f"{len(g['windows'])} windows (mean accepted {res[kind]['mean_accepted']:.2f}), "
                f"counts = CPU's, caches graphs = eager bit for bit; launches {g['launches']}")
        del cpu, gpu
        gc.collect()
        if mixed:
            extra = fspec_mixed_flags(arch)
            counts, worst = engine_vs_cpu(
                torch, np, mods, mixed=True, family=family, extra=extra, phase=f"4q {case}",
                extra_strats={"moe_sparse_per_expert"} if arch.moe is not None else ())
            res["mixed"] = dict(launches=counts, max_logit_err=worst,
                                ragged_kernel=extra["attn_kernel_enabled"])
            gc.collect()
        log(f"[fspec-2L 4q] {case}: {time.perf_counter() - t0:.1f} s")
    return out


# phase 5q (a): Mistral-7B's 6144-token prompts past its 4096 window, 64 new
# tokens, fused speculation at spec_len 4 on the homogeneous ring
FSPEC_MISTRAL = dict(B=2, S=6144, new=64, spec_len=4)
# phase 5q (c): DeepSeek-V3 (4 of 61 layers), B 8 on phase 5's prompt shapes
FSPEC_V3 = dict(B=8, S=1024, new=32, spec_len=4, layers=4)
NEAR_TIE_STEPS = 16  # a bf16 stream may leave its reference only at a top-2 gap this small


def near_tie_compare(torch, np, name, spec, ref, ref_logits, lengths, new):
    """A bf16 speculative stream against the non-speculative one on the same
    cache: each row equal, or first different where the reference's top-2
    gap is within NEAR_TIE_STEPS bf16 steps at its top logit (the verify
    and the decode step round differently; past a flip the rows decode
    different contexts). Returns (rows equal, [(row, step, gap, steps)])."""
    equal, ties = 0, []
    for b, n in enumerate(lengths):
        diff = np.flatnonzero(spec[b, n:n + new] != ref[b, n:n + new])
        if not diff.size:
            equal += 1
            continue
        j = int(diff[0])
        top2 = ref_logits[b, j].topk(2).values
        gap = float(top2[0] - top2[1])
        steps = gap / bf16_ulp(float(top2[0]))
        assert steps <= NEAR_TIE_STEPS, (
            f"{name}: row {b} leaves the non-speculative stream at step {j} where its top-2 "
            f"gap is {gap} ({steps:.1f} bf16 steps): a fault")
        ties.append((b, j, gap, steps))
    return equal, ties


def fspec_timed(torch, np, Adapter, app, ids, mask, new, name, kind, t_arch, d_arch, ring,
                attn, spec_len, card):
    """A 5q speculation run, twice: tokens (the two equal), windows, ms and
    accepted tokens a window, tok/s, TTFT (the prefill) and TPOT (decode ms
    per emitted token), launches exact (fspec_counts), then one window again
    unprofiled (its wall) and profiled (device busy, idle share)."""
    from nxdi_tpu_torch.ops.kernels import fused_proj as fp

    runs = []
    for _ in range(2):
        runs.append(spec_run(torch, Adapter, app, ids, mask, new))
        runs[-1]["launches"]["mlp"] = fp.fused_mlp.launches  # spec_run zeroes the counters
    r = runs[1]
    assert (runs[0]["tokens"] == r["tokens"]).all(), f"{name}: runs differ"
    for x in runs:
        want = fspec_counts(kind, x, t_arch, d_arch, ring, attn, spec_len)
        got = {k: v for k, v in x["launches"].items() if k in want}
        assert got == want, f"{name}: launches {got} != {want}"
    B = ids.shape[0]
    n_win = r["n_windows"]
    lengths = mask.sum(axis=1)
    cur_tok = np.array([[int(r["tokens"][b, n + new - 1])] for b, n in enumerate(lengths)],
                       "int32")
    cur_pos = (lengths + new - 1).astype("int32")[:, None]
    lti = np.zeros((B,), "int32")

    def window():
        o = app.forward(cur_tok, cur_pos, last_token_index=lti)
        return o["counts"].cpu()

    wall, split = host_window(torch, window, 8)
    _, busy, by_kernel, _ = profiled_call(torch, window)
    emitted = B * new - B  # the context encoding emits the first token of each row
    stats = dict(window_ms=r["decode_ms"] / n_win, windows=n_win,
                 mean_accepted_per_window=r["accepted"] / n_win / B,
                 tok_s=emitted * 1e3 / r["decode_ms"], ttft_ms=r["prefill_ms"],
                 tpot_ms=r["decode_ms"] / (new - 1), launches=r["launches"],
                 launches_both_runs={k: runs[0]["launches"][k] + v
                                     for k, v in r["launches"].items()},
                 profiled_window=dict(wall_ms=wall, busy_ms=busy, idle_pct=100 * (1 - busy / wall),
                                      by_group_ms=by_group(by_kernel), host_split_ms=split,
                                      top=by_kernel[:8]))
    log(f"{name}, {card}: {stats['window_ms']:.3f} ms/window, "
        f"{stats['mean_accepted_per_window']:.2f} accepted/window over {n_win} windows, "
        f"{stats['tok_s']:.1f} tok/s, TTFT {stats['ttft_ms']:.2f} ms, TPOT "
        f"{stats['tpot_ms']:.3f} ms; a window wall {wall:.3f} busy {busy:.3f} ms (idle "
        f"{stats['profiled_window']['idle_pct']:.1f}%); launches {r['launches']}")
    return stats, r["tokens"]


def first_layers(torch, stacked, n):
    """The first ``n`` layers of a layer-stacked params dict (views)."""
    if torch.is_tensor(stacked):
        return stacked[:n]
    return {k: first_layers(torch, v, n) for k, v in stacked.items()}


def fspec_mistral_full_depth(torch, np, mods, card):
    """Phase 5q (a): Mistral-7B whole (32 layers, window 4096), bf16, random
    weights from seed 0, graphs, the attention kernels on, on the
    window-sized ring (4096 + spec_len + 1 slots a layer), B 2 x 6144-token
    prompts, 64 new tokens: target-only generate() on the ring (the
    reference, with its logits), then fused speculation at spec_len 4 with a
    perfect draft (the target's weights, a full-length contiguous cache) and
    with a 2-layer draft cut from the target's first two layers. Each
    stream held to the reference (near_tie_compare), launches exact."""
    from nxdi_tpu_torch.models.mistral import modeling_mistral as tm
    from nxdi_tpu_torch.speculation import FusedSpecCausalLM

    ml, TorchConfig, ODSC, App, dense, Adapter = mods
    c = FSPEC_MISTRAL
    B, P, NEW, K = c["B"], c["S"], c["new"], c["spec_len"]
    family = (tm, tm.MistralInferenceConfig, tm.MISTRAL_7B_V01)
    Wn = tm.MISTRAL_7B_V01["sliding_window"]  # 4096
    ring_kw = dict(window_sized_kv=True, sliding_window=Wn)
    seq_len = P + 128
    tag = "[fspec-5q Mistral-7B ring]"
    t = time.perf_counter()
    ref_app, arch = make_app(ml, TorchConfig, ODSC, App, dense, layers=32, dtype="bfloat16",
                             batch=B, seq_len=seq_len, ctx_len=P, device="cuda", family=family,
                             output_logits=True, **ring_kw)
    params = ref_app.params
    assert ref_app.kv_cache["k"].shape[3] == Wn, ref_app.kv_cache["k"].shape
    log(f"{tag} target loaded {time.perf_counter() - t:.1f} s; warmup {ref_app.warm_stats}")
    ids, mask = prompts(np.random.default_rng(12), B, P, [P, P - P // 32], arch.vocab_size)
    lengths = mask.sum(axis=1)
    logs = []
    recording(ref_app, logs)
    torch.cuda.synchronize()
    t = time.perf_counter()
    ref = Adapter(ref_app).generate(ids, attention_mask=mask, max_new_tokens=NEW)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t
    del ref_app.forward
    ref_logits = torch.stack(logs, dim=1)
    del ref_app, logs
    gc.collect()
    torch.cuda.empty_cache()
    stats = dict(layers=32, batch=B, prompt=P, new=NEW, spec_len=K, ring_slots=Wn + K + 1,
                 target_only_s=ref_s, runs={})
    cut = dict(params, layers=first_layers(torch, params["layers"], 2))
    base = dict(tp_degree=1, batch_size=B, seq_len=seq_len, max_context_length=P,
                dtype="bfloat16", on_device_sampling_config=ODSC(), skip_warmup=True,
                attn_kernel_enabled=True, attn_tkg_kernel_enabled=True)
    t_arch = arch
    for draft, d_params, d_layers in (("perfect", params, 32), ("2-layer", cut, 2)):
        gc.collect()
        torch.cuda.empty_cache()
        pair = {"target": params, "draft": d_params}

        class Fused(FusedSpecCausalLM):
            def build_params(self):
                return pair

        t = time.perf_counter()
        tcfg = model_config(ml, TorchConfig(**base, **ring_kw, speculation_length=K,
                                            enable_fused_speculation=True), 32, family)[1]
        dcfg = model_config(ml, TorchConfig(**base), d_layers, family)[1]
        app = Fused("<t>", tcfg, "<d>", dcfg, model_family=tm, device="cuda")
        app.load()
        app.warmup()
        assert app.kv_cache["target"]["k"].shape[3] == Wn + K + 1
        assert app.kv_cache["draft"]["k"].shape[3] == seq_len
        load_s = time.perf_counter() - t
        d_arch = app.models["fused_speculation_model"].draft_arch
        name = f"{tag} fused, {draft} draft"
        run, toks = fspec_timed(torch, np, Adapter, app, ids, mask, NEW, name, "fused", t_arch,
                                d_arch, "ring", True, K, card)
        equal, ties = near_tie_compare(torch, np, name, toks, ref, ref_logits, lengths, NEW)
        run.update(load_s=load_s, rows_equal=equal, first_differences=ties,
                   strategies=sorted(strategies_of(app)))
        log(f"{name}: rows equal to target-only generate() on the ring {equal}/{B}; first "
            f"differences (row, step, gap, bf16 steps) {ties}")
        stats["runs"][draft] = run
        del app
    del params, cut, ref_logits
    gc.collect()
    torch.cuda.empty_cache()
    return stats


def fspec_v3_full_depth(torch, np, mods, card):
    """Phase 5q (c): DeepSeek-V3 at its published widths, depth cut to 4 of
    61 layers (5j's cut: 3 dense, 1 MoE), bf16, random weights from seed 0,
    graphs, the fused MLP on the dense layers; fused speculation at spec_len
    4, B 8 on phase 5's prompt shapes, 32 new tokens, over a 1-layer draft
    made of the target's first dense layer (V3's widths and vocabulary, its
    embedding, final norm and head): each draft step an ordinary MLA decode
    forward committing its latent row through row 4 (K 64 / V 512). Held to
    target-only generate() (near_tie_compare), launches exact."""
    from nxdi_tpu_torch.speculation import FusedSpecCausalLM

    ml, TorchConfig, ODSC, App, dense, Adapter = mods
    c = FSPEC_V3
    B, P, NEW, K, L = c["B"], c["S"], c["new"], c["spec_len"], c["layers"]
    family = deepseek_family()
    tag = "[fspec-5q DeepSeek-V3]"
    common = dict(dtype="bfloat16", seq_len=2048, ctx_len=P, device="cuda", family=family,
                  mlp_kernel_enabled=True, **MLA_FLAGS)
    t = time.perf_counter()
    ref_app, arch = make_app(ml, TorchConfig, ODSC, App, dense, layers=L, batch=B,
                             output_logits=True, **common)
    params = ref_app.params
    log(f"{tag} reduced: 61 -> 4 layers; target loaded {time.perf_counter() - t:.1f} s")
    ids, mask = prompts(np.random.default_rng(11), B, P,
                        [P, P, P - P // 40, P, P - P // 4, P, P, P - 1][:B], arch.vocab_size)
    lengths = mask.sum(axis=1)
    logs = []
    recording(ref_app, logs)
    ref = Adapter(ref_app).generate(ids, attention_mask=mask, max_new_tokens=NEW)
    del ref_app.forward
    ref_logits = torch.stack(logs, dim=1)
    del ref_app, logs
    gc.collect()
    torch.cuda.empty_cache()
    # the draft: the first dense layer of the target's dense segment
    d_params = dict(params, layers=[first_layers(torch, params["layers"][0], 1)])
    pair = {"target": params, "draft": d_params}

    class Fused(FusedSpecCausalLM):
        def build_params(self):
            return pair

    base = dict(tp_degree=1, batch_size=B, seq_len=2048, max_context_length=P,
                dtype="bfloat16", on_device_sampling_config=ODSC(), skip_warmup=True,
                mlp_kernel_enabled=True, **MLA_FLAGS)
    tcfg = model_config(ml, TorchConfig(**base, speculation_length=K,
                                        enable_fused_speculation=True), L, family)[1]
    dcfg = model_config(ml, TorchConfig(**base), 1, family)[1]
    t = time.perf_counter()
    app = Fused("<t>", tcfg, "<d>", dcfg, model_family=family[0], device="cuda")
    app.load()
    app.warmup()
    d_arch = app.models["fused_speculation_model"].draft_arch
    assert d_arch.mla is not None and d_arch.num_layers == 1
    name = f"{tag} fused, 1-layer dense draft"
    run, toks = fspec_timed(torch, np, Adapter, app, ids, mask, NEW, name, "fused", arch, d_arch,
                            None, False, K, card)
    # the fused MLP: the target's 3 dense layers a forward (its context
    # encoding and each verify), the draft's one (its context encoding and
    # each of a window's spec_len + 1 steps)
    n = run["windows"]
    mlp_want = 3 * (1 + n) + (1 + (K + 1) * n)
    assert run["launches"]["mlp"] == mlp_want, f"{name}: MLP launches {run['launches']}"
    equal, ties = near_tie_compare(torch, np, name, toks, ref, ref_logits, lengths, NEW)
    run.update(load_s=time.perf_counter() - t, rows_equal=equal, first_differences=ties,
               strategies=sorted(strategies_of(app)))
    assert "mla_xla" in run["strategies"], run["strategies"]
    log(f"{name}: rows equal to target-only generate() {equal}/{B}; first differences "
        f"(row, step, gap, bf16 steps) {ties}")
    del app, params, d_params, pair, ref_logits
    gc.collect()
    torch.cuda.empty_cache()
    return dict(layers=L, reduced="61 -> 4 layers (3 dense + 1 MoE)", batch=B, new=NEW,
                spec_len=K, draft="the target's first dense layer", run=run)


def fspec_falcon_mixed(torch, np, mods, card):
    """Phase 5q (b): Falcon-7B whole (32 layers, 71 query heads of 64 on one
    kv head), bf16, random weights from seed 0, on the mixed engine over
    phase 5b's seed-17 traffic (engine_full_depth: tok/s, TTFT, TPOT, a
    profiled packed and decode-only step, launches exact): the ragged kernel
    at G 71 (row 8; its LayerNorm, parallel block and learned biases took
    the mixed step off until this slice), the fused QKV kernel, no MLP
    kernel (Falcon's MLP is not gated). Beside phase 5o's split engine."""
    from nxdi_tpu_torch.models.falcon import modeling_falcon as tf

    family = (tf, tf.FalconInferenceConfig, tf.FALCON_7B)
    counts, st = engine_full_depth(torch, np, mods, card, mixed=True, layers=32, family=family,
                                   extra=dict(mlp_kernel_enabled=False), phase="5q Falcon-7B")
    st.pop("prompts")
    assert counts["ragged"] > 0 and counts["mlp"] == 0, counts
    log(f"[fspec-5q Falcon-7B mixed] {card}: {st['tok_s']:.1f} tok/s, TTFT p50 "
        f"{st['ttft_p50_ms']:.2f} ms p95 {st['ttft_p95_ms']:.2f} ms, TPOT p50 "
        f"{st['tpot_p50_ms']:.3f} ms; launches {counts}")
    return dict(engine=st, launches=counts)


# ---------------------------------------------------------------------------
# phases 3n, 4r and 5r: MiMo-V2 (two attention stacks, a value width apart
# from q / k's) and LFM2 (short convs beside attention, seq-id state routing)
# ---------------------------------------------------------------------------

# phase 3n's commits: MiMo-V2-Flash's full-attention stack in phase 5r's
# 4-layer cut (1 layer, 4 kv heads) and its window stack (3 layers, 8 kv
# heads), K 192 / V 128; LFM2-1.2B's per-layer commit (one of its 6
# attention layers, 8 kv heads of 64); B 8, S 2048
HYBRID_COMMITS = {
    "MiMo-V2 K 192 / V 128": dict(layers=1, kv=4, k=192, v=128, view=False),
    "MiMo-V2 window stack": dict(layers=3, kv=8, k=192, v=128, view=False),
    "LFM2-1.2B": dict(layers=6, kv=8, k=64, v=64, view=True),
}
HYBRID_COMMIT_SHAPE = dict(batch=8, seq=2048)
# phase 3n's fused MLP at MiMo-V2-Flash's dense MLP (hidden 4096, intermediate
# 16384, SiLU), the one-layer dense segment of phase 5r's 4-layer cut, at the
# decode step's 8 rows and phase 5r's prefill (batch 8 x 1024 tokens)
MIMO_MLP = dict(hidden=4096, inter=16384, layers=1)
MIMO_MLP_M = (8, 8192)


def check_hybrid_commits(torch, results):
    """Phase 3n. Row 4 at the hybrids' stacks (HYBRID_COMMITS): one decode
    step's rows, one a line, into the whole stack (MiMo's deferred commit)
    or into one layer's view (LFM2's per-layer write), and a routed
    prefill's 128 rows into shuffled lines with a dropped row and a dropped
    line, bit for bit against the plain version in bf16 and f32; bf16 timed
    (DECODE_CALLS flushed calls) beside the plain version, index_put of the
    same rows and the bound (the rows' bytes, read and written). Rows 9/10
    at MiMo-V2-Flash's dense MLP (MIMO_MLP), as phase 3g holds V3's: the
    stacked entry equal to the unstacked call, each M held to its plain
    version (row 9's tolerance), timed (GEMM_CALLS flushed calls) beside
    three torch products; bound: the weights' bytes, or the operations."""
    import torch.nn.functional as F

    from nxdi_tpu_torch.ops.kernels import fused_proj as fp
    from nxdi_tpu_torch.ops.kernels import kv_commit as kc

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    scratch = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)

    def flush():
        scratch.zero_()

    B, S = HYBRID_COMMIT_SHAPE["batch"], HYBRID_COMMIT_SHAPE["seq"]
    for point, c in HYBRID_COMMITS.items():
        L, KV, Dk, Dv = c["layers"], c["kv"], c["k"], c["v"]
        for dname in ("bfloat16", "float32"):
            dt = getattr(torch, dname)
            es = torch.tensor([], dtype=dt).element_size()

            def randn(shape):
                return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dt)

            kst, vst = randn((L, B, KV, S, Dk)), randn((L, B, KV, S, Dv))
            # LFM2 writes one layer's view; MiMo commits the whole stack at once
            kl, vl = (kst[L - 1:L], vst[L - 1:L]) if c["view"] else (kst, vst)
            n = kl.shape[0]
            kr, vr = randn((n, B, KV, 1, Dk)), randn((n, B, KV, 1, Dv))
            slots = torch.tensor([[1000 + 7 * b] for b in range(B)], dtype=torch.int32,
                                 device=dev)
            k_ref, v_ref = kl.clone(), vl.clone()
            kc.kv_commit_rows_plain(k_ref, v_ref, kr, vr, slots)
            kc.kv_commit_rows(kl, vl, kr, vr, slots)
            torch.cuda.synchronize()
            assert torch.equal(kl, k_ref) and torch.equal(vl, v_ref), \
                f"3n commit {point} {dname}: not exact"
            # a routed prefill: 128 rows of 3 requests into lines (5, 0, 9);
            # row 1's last position and line 9 (past the 8) drop
            T = 128
            kp, vp = randn((n, 3, KV, T, Dk)), randn((n, 3, KV, T, Dv))
            pslots = torch.arange(T, dtype=torch.int32, device=dev)[None].repeat(3, 1)
            pslots[1, -1] = -1
            lines = torch.tensor([5, 0, 9], dtype=torch.int32, device=dev)
            k_ref, v_ref = kl.clone(), vl.clone()
            kc.kv_commit_rows_plain(k_ref, v_ref, kp, vp, pslots, lines)
            kc.kv_commit_rows(kl, vl, kp, vp, pslots, lines)
            torch.cuda.synchronize()
            assert torch.equal(kl, k_ref) and torch.equal(vl, v_ref), \
                f"3n routed commit {point} {dname}: not exact"
            if dname != "bfloat16":
                log(f"[hybrid-3n] commit float32 {point}: exact (decode rows and a routed "
                    "prefill with drops)")
                continue
            times, _, _ = traced_times(torch, lambda: kc.kv_commit_rows(kl, vl, kr, vr, slots),
                                       DECODE_CALLS, flush, kernel="kv_commit_kernel")
            ms, lo, hi = spread(times)
            plain_ms = measure(torch, lambda: kc.kv_commit_rows_plain(kl, vl, kr, vr, slots),
                               flush=flush)
            sl, bi = slots[:, 0].long(), torch.arange(B, device=dev)
            zero = torch.zeros(B, dtype=torch.long, device=dev)

            def library_commit():
                kl[:, bi, :, sl] = kr[:, bi, :, zero]
                vl[:, bi, :, sl] = vr[:, bi, :, zero]

            lib_ms = measure(torch, library_commit, flush=flush)
            nbytes = 2 * n * B * KV * (Dk + Dv) * es  # rows read + written
            bms, by = bound_ms(nbytes, 0, dname)
            results.append(dict(kernel="commit", dtype=dname, point=point, max_abs_err=0.0,
                                tol=0.0, ms=ms, ms_min=lo, ms_max=hi, plain_ms=plain_ms,
                                library_ms=lib_ms, bound_ms=bms, bound_by=by, k_width=Dk,
                                v_width=Dv, layers=n))
            log(f"[hybrid-3n] commit bfloat16 {point} ({n} layer(s), {KV} kv heads, K {Dk} / "
                f"V {Dv}, B {B}): exact; kernel {ms:.4f} ms ({lo:.4f}-{hi:.4f}); plain "
                f"{plain_ms:.4f} index_put {lib_ms:.4f} bound {bms:.6f} ({by})")
            del kst, vst, kl, vl, k_ref, v_ref
    torch.cuda.empty_cache()

    m = MIMO_MLP
    H, I, Lm = m["hidden"], m["inter"], m["layers"]
    dt = torch.bfloat16

    def randn_bf16(shape, std):
        return (torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * std).to(dt)

    g_s, u_s = randn_bf16((Lm, H, I), H ** -0.5), randn_bf16((Lm, H, I), H ** -0.5)
    d_s = randn_bf16((Lm, I, H), I ** -0.5)
    li = Lm - 1
    for M in MIMO_MLP_M:
        x = randn_bf16((M, H), 1.0)
        assert torch.equal(fp.fused_mlp_stacked(x, g_s, u_s, d_s, li),
                           fp.fused_mlp(x, g_s[li], u_s[li], d_s[li])), f"3n mlp stacked M={M}"
        row = gemm_point(torch, results, "mlp", "bfloat16", M,
                         lambda: fp.fused_mlp_stacked(x, g_s, u_s, d_s, li),
                         lambda: fp.fused_mlp_plain(x, g_s[li], u_s[li], d_s[li]),
                         lambda: (F.silu(x @ g_s[li]) * (x @ u_s[li])) @ d_s[li],
                         (2 * M * H + 3 * H * I) * 2, 6 * M * H * I, flush)
        row.update(point="MiMo-V2-Flash", hidden=H, inter=I)
        log(f"[hybrid-3n] mlp bfloat16 at MiMo-V2-Flash's H {H} I {I}, M {M}: err "
            f"{row['max_abs_err']:.3g} (limit {row['tol']}); kernel {row['ms']:.4f} ms "
            f"({row['ms_min']:.4f}-{row['ms_max']:.4f}); three torch products "
            f"{row['library_ms']:.4f}; bound {row['bound_ms']:.4f} ({row['bound_by']}); "
            f"{100 * row['bound_ms'] / row['ms']:.1f} % of the bound")
    del g_s, u_s, d_s
    torch.cuda.empty_cache()


# phase 4r: both families at 2 layers in float32, the published shapes
# narrowed. MiMo: a full-attention dense layer and a window MoE layer, q / k
# 48 against v 32 on both (192 / 128's ratio), window 8, 8 experts top 2;
# LFM2: a conv layer and an attention layer
HYBRID_SMALL = {
    "mimo_v2": dict(hidden_size=256, num_hidden_layers=2, hybrid_layer_pattern=[0, 1],
                    moe_layer_freq=[0, 1], num_attention_heads=4, num_key_value_heads=2,
                    swa_num_attention_heads=4, swa_num_key_value_heads=2, head_dim=48,
                    v_head_dim=32, swa_head_dim=48, swa_v_head_dim=32, sliding_window=8,
                    n_routed_experts=8, num_experts_per_tok=2, moe_intermediate_size=64,
                    intermediate_size=512, vocab_size=512),
    "lfm2": dict(hidden_size=256, intermediate_size=768, num_hidden_layers=2,
                 num_attention_heads=4, num_key_value_heads=2, vocab_size=512,
                 layer_types=["conv", "full_attention"]),
}
# the attention kernels stay off (no kernel takes MiMo's value widths, the
# JAX rule; LFM2 attends plainly in both packages); the fused MLP on MiMo's
# dense layer
HYBRID_FLAGS = {"mimo_v2": dict(mlp_kernel_enabled=True), "lfm2": {}}


def hybrid_family(model_type, **widths):
    """(module, config class, widths) of a hybrid family at ``widths`` over its
    published constant."""
    from nxdi_tpu_torch.models import registry

    module, cfg_cls = registry.get_family(model_type)
    published = module.MIMO_V2_FLASH if model_type == "mimo_v2" else module.LFM2_1_2B
    return module, cfg_cls, dict(published, **widths)


def hybrid_app(mods, family, *, device, dtype, batch, seq_len, ctx_len, params=None,
               graphs=True, output_logits=False, **extra):
    """The family's own application (its cache stacks and forward), loaded
    and warmed up, random weights from seed 0 (or ``params``)."""
    _, TorchConfig, ODSC, _, _, _ = mods
    module, cfg_cls, widths = family
    tcfg = TorchConfig(tp_degree=1, batch_size=batch, seq_len=seq_len, max_context_length=ctx_len,
                       dtype=dtype, on_device_sampling_config=ODSC(),
                       output_logits=output_logits, skip_warmup=True, **extra)
    cfg = cfg_cls(tcfg, **widths)

    class A(module.APPLICATION_CLS):
        def build_params(self):
            if params is not None:
                return params
            return module.random_params(self.config, seed=0, device=device)

    app = A("<random>", cfg, device=device, graphs=graphs)
    app.load()
    app.warm_stats = warm(app)
    return app, module.build_arch(cfg)


def hybrid_kernels():
    """The wrappers a hybrid run's launches are read from: the attention and
    projection kernels (none may launch), the commit and the fused MLP."""
    from nxdi_tpu_torch.ops.kernels import fused_proj as fp

    return dict(attention_kernels(), ragged=mixed_kernels()["ragged"], qkv=fp.qkv_matmul,
                mlp=fp.fused_mlp)


def forward_log(app, logits=None):
    """Record every dispatch of every submodel of ``app`` in
    ``app.dispatches``: (attends the cache, tokens a row, routed by
    seq_ids), the inputs of :func:`hybrid_counts`; each dispatch's logits,
    a row a token, go to ``logits`` where given (run_three's ``record``).
    Returns the call that takes the wraps off."""
    import numpy as np

    app.dispatches = []
    wrappers = [w for a in submodels(app) for w in a.models.values()]
    for w in wrappers:
        inner = w.forward

        def fwd(params, cache, batch_np, inner=inner, w=w):
            outputs, cache = inner(params, cache, batch_np)
            app.dispatches.append((w.attend_to_cache,
                                   int(np.asarray(batch_np["input_ids"]).shape[1]),
                                   bool(getattr(w.layout, "route_by_seq_id", False))))
            lg = outputs.get("logits")
            if logits is not None and lg is not None:
                logits.append(lg.float().reshape(-1, lg.shape[-1]).cpu())
            return outputs, cache

        w.forward = fwd

    def undo():
        for w in wrappers:
            w.__dict__.pop("forward", None)

    return undo


def hybrid_counts(arch, records, ring, dense_layers):
    """Row 4's and rows 9/10's launches over the logged dispatches, every
    other kernel none, and row 4's by the stack they land in (MiMo's "full"
    and "swa", LFM2's "attention"). MiMo, each segment: on a contiguous
    stack a cache-attending forward defers its rows to one commit, a
    context encoding copies its prefill in place (a routed one writes each
    layer through the commit); on the window ring every layer writes
    through the commit but a multi-token verify, which defers. LFM2: each
    attention layer commits in every forward. The fused MLP: once a dense
    layer a forward."""
    by_stack = {}
    for attend, S, routed in records:
        if hasattr(arch, "schedule"):  # MiMo-V2
            for kind, lo, hi, _ in arch.schedule:
                if kind == "swa" and ring:
                    n = 1 if attend and S > 1 else hi - lo
                else:
                    n = 1 if attend else (hi - lo if routed else 0)
                by_stack[kind] = by_stack.get(kind, 0) + n
        else:
            by_stack["attention"] = by_stack.get("attention", 0) + arch.n_attn
    want = {k: 0 for k in hybrid_kernels()}
    want.update(commit=sum(by_stack.values()), mlp=dense_layers * len(records))
    return want, by_stack


def hybrid_three(torch, mods, tag, build, drive, ring=False, dense_layers=0):
    """One hybrid run three ways (three_apps over ``build``, run_three over
    ``drive`` with every submodel's dispatches logged, tokens exact), the
    graphs' launches held to hybrid_counts. Returns (the largest logit
    difference, dispatches compared bit for bit, the graphs' launches, the
    graphs' tokens, the graph app)."""
    apps, arch = three_apps(mods, build=build)
    worst, toks, counts, n, _ = run_three(torch, mods, tag, apps, None, None, None,
                                          kernels=hybrid_kernels(), drive=drive,
                                          record=forward_log, exact=True)
    want = hybrid_counts(arch, apps[1].dispatches, ring, dense_layers)[0]
    assert counts == want, f"{tag}: launches {counts} != {want}"
    return worst, n, counts, toks, apps[1]


def lines_drive(app, prompts_, lines, new, arrivals=None):
    """Continuous batching through ``app.forward(seq_ids=)``: request i is
    prefilled alone into cache line ``lines[i]`` at step ``arrivals[i]``
    (default: its index), then every live request decodes in one dispatch a
    step, its row routed to its line, until each has ``new`` tokens.
    Returns each request's tokens (a list of lists)."""
    import numpy as np

    arrivals = list(range(len(prompts_))) if arrivals is None else arrivals
    toks = [[] for _ in prompts_]
    pos = [0] * len(prompts_)
    step = 0
    while any(len(t) < new for t in toks):
        for i, p in enumerate(prompts_):
            if arrivals[i] == step:
                S = len(p)
                out = app.forward(np.asarray([p], np.int32), np.arange(S, dtype=np.int32)[None],
                                  last_token_index=np.array([S - 1], np.int32),
                                  seq_ids=np.array([lines[i]], np.int32))
                toks[i].append(int(np.asarray(out["tokens"].cpu())[0, 0]))
                pos[i] = S
        live = [i for i, t in enumerate(toks) if t and len(t) < new]
        if live:
            out = app.forward(np.array([[toks[i][-1]] for i in live], np.int32),
                              np.array([[pos[i]] for i in live], np.int32),
                              seq_ids=np.array([lines[i] for i in live], np.int32))
            got = np.asarray(out["tokens"].cpu())[:, 0]
            for j, i in enumerate(live):
                toks[i].append(int(got[j]))
                pos[i] += 1
        step += 1
    return toks


def hybrid_vs_cpu(torch, np, mods):
    """Phase 4r: MiMo-V2 and LFM2 at 2 layers in float32 (HYBRID_SMALL), the
    CPU (plain versions) against the card through its graphs and eagerly
    (hybrid_three): static generate() at B 2 (one row padded); continuous
    batching over shuffled cache lines (two requests into lines 3 and 1, the
    second arriving after the first has decoded); MiMo also on its window
    ring beside the full cache (tokens equal) and under standard speculation
    at spec_len 3 (a perfect draft: its tokens equal the target's
    generate()). Row 4 (and rows 9/10 on MiMo's dense layer) launched
    exactly as counted; no attention kernel."""
    from nxdi_tpu_torch.generation.hf_adapter import HuggingFaceGenerationAdapter as Adapter
    from nxdi_tpu_torch.speculation import StandardSpecCausalLM

    NEW, P = 16, 64
    out = {}
    for model_type in ("mimo_v2", "lfm2"):
        family = hybrid_family(model_type, **HYBRID_SMALL[model_type])
        module, cfg_cls, widths = family
        flags = HYBRID_FLAGS[model_type]
        dense = (widths["moe_layer_freq"].count(0) if flags.get("mlp_kernel_enabled") else 0)
        vocab = widths["vocab_size"]
        ids, mask = prompts(np.random.default_rng(7), 2, P, [P, 53], vocab)
        runs = {}

        def static(ring):
            # config.py refuses the projection kernels on a ring (the JAX rule)
            extra = dict(RING8) if ring else dict(flags)

            def build(device, graphs, params):
                return hybrid_app(mods, family, device=device, dtype="float32", batch=2,
                                  seq_len=256, ctx_len=128, params=params, graphs=graphs,
                                  output_logits=True, **extra)

            return build, lambda app: Adapter(app).generate(ids, attention_mask=mask,
                                                            max_new_tokens=NEW)

        for ring in ((False, True) if model_type == "mimo_v2" else (False,)):
            name = "ring" if ring else "static"
            build, drive = static(ring)
            worst, n, counts, toks, app = hybrid_three(torch, mods, f"4r {model_type} {name}",
                                                       build, drive, ring, 0 if ring else dense)
            if ring:
                assert app.kv_cache["k_swa"].shape[3] == RING8["sliding_window"], "4r ring"
                assert np.array_equal(np.asarray(toks), np.asarray(runs["static"]["tokens"])), \
                    "4r mimo_v2: the ring's tokens differ from the full cache's"
            runs[name] = dict(max_logit_err=worst, dispatches_bitwise=n, launches=counts,
                              tokens=toks, cache_bytes=cache_bytes(app))
            log(f"[hybrid-2L 4r {model_type} {name}] generate(): max logit diff {worst:.3g}, "
                f"graphs = eager over {n} dispatches, launches {counts}")
            del app
            gc.collect()

        rng = np.random.default_rng(8)
        reqs = [rng.integers(1, vocab, size=n).tolist() for n in (40, 23)]
        lines = [3, 1]

        def cb_build(device, graphs, params):
            return hybrid_app(mods, family, device=device, dtype="float32", batch=2, seq_len=256,
                              ctx_len=128, params=params, graphs=graphs, output_logits=True,
                              is_continuous_batching=True, ctx_batch_size=1, tkg_batch_size=2,
                              kv_cache_batch_size=4, **flags)

        worst, n, counts, toks, app = hybrid_three(
            torch, mods, f"4r {model_type} lines", cb_build,
            lambda a: lines_drive(a, reqs, lines, 12, arrivals=[0, 4]), False, dense)
        runs["lines"] = dict(max_logit_err=worst, dispatches_bitwise=n, launches=counts,
                             lines=lines)
        log(f"[hybrid-2L 4r {model_type} lines] shuffled lines {lines}: max logit diff "
            f"{worst:.3g}, graphs = eager over {n} dispatches, launches {counts}")
        del app
        gc.collect()

        if model_type == "mimo_v2":
            _, TorchConfig, ODSC, _, _, _ = mods

            def spec_build(device, graphs, params):
                base = dict(tp_degree=1, batch_size=2, seq_len=256, max_context_length=128,
                            dtype="float32", on_device_sampling_config=ODSC(), output_logits=True,
                            skip_warmup=True, **flags)
                app = StandardSpecCausalLM(
                    "<t>", cfg_cls(TorchConfig(speculation_length=3, **base), **widths), "<d>",
                    cfg_cls(TorchConfig(**base), **widths), model_family=module, device=device,
                    graphs=graphs)
                for side in (app.target, app.draft):  # a perfect draft: the target's weights
                    side.build_params = (lambda p=params, s=side: p if p is not None
                                         else module.random_params(s.config, seed=0,
                                                                   device=device))
                app.load()
                for side in (app.target, app.draft):
                    side.warm_stats = warm(side)
                return app, module.build_arch(app.target.config)

            def spec_drive(app):
                toks = Adapter(app).generate(ids, attention_mask=mask, max_new_tokens=NEW)
                return toks

            worst, n, counts, toks, app = hybrid_three(torch, mods, "4r mimo_v2 speculation",
                                                       spec_build, spec_drive, False, dense)
            plain = Adapter(app.target).generate(ids, attention_mask=mask, max_new_tokens=NEW)
            assert np.array_equal(np.asarray(toks), np.asarray(plain)), \
                "4r mimo_v2: speculation's tokens differ from the target's generate()"
            runs["speculation"] = dict(max_logit_err=worst, dispatches_bitwise=n,
                                       launches=counts, spec_len=3,
                                       windows=app.spec_windows,
                                       accepted=app.spec_accepted_tokens)
            log(f"[hybrid-2L 4r mimo_v2 speculation] spec_len 3, perfect draft: max logit diff "
                f"{worst:.3g}, graphs = eager over {n} dispatches, {app.spec_windows} windows, "
                f"launches {counts}")
            del app
            gc.collect()
        for r in runs.values():
            r.pop("tokens", None)
        out[model_type] = runs
    torch.cuda.empty_cache()
    return out


# phase 5r's MoE share of a step: the grouped expert GEMMs (torch._grouped_mm:
# CUTLASS's GemmUniversal over a GroupProblemShape) and the dispatch's sort,
# top-k, scatter-add and un-sort (ops/moe.py's sparse dispatch); the router's
# float32 product counts as a GEMM
MOE_NAME = re.compile(r"GroupProblemShape|grouped|sort|topk|radix|scatter_add|index_copy|cub::",
                      re.I)


def step_shares(by_kernel):
    """A profiled step's device ms split into GEMM (cuBLAS and the port's),
    MoE (MOE_NAME), elementwise and the rest."""
    out = {"MoE": 0.0, "GEMM": 0.0, "elementwise": 0.0, "other": 0.0}
    for t, name in by_kernel:
        if MOE_NAME.search(name):
            out["MoE"] += t
        elif GEMM_NAME.search(name) or KERNEL_GROUPS[5][1].search(name):
            out["GEMM"] += t
        elif KERNEL_GROUPS[8][1].search(name):
            out["elementwise"] += t
        else:
            out["other"] += t
    return out


def hybrid_generate(torch, np, mods, tag, app, arch, ids, mask, new, ring, dense_layers):
    """One timed generate() of a phase 5r app: prefill ms, decode ms/step,
    tok/s, launches exact (hybrid_counts), a profiled decode step (wall,
    busy, idle, the GEMM / MoE / elementwise shares), KV cache and peak
    bytes."""
    Adapter = mods[5]
    undo = forward_log(app)
    count = _count_launches(hybrid_kernels())
    try:
        prefill_ms, decode_ms, toks = timed_generate(torch, Adapter, app, ids, mask, new)
    finally:
        undo()
    counts = count()
    want, by_stack = hybrid_counts(arch, app.dispatches, ring, dense_layers)
    assert counts == want, f"{tag}: launches {counts} != {want}"
    lengths = mask.sum(axis=1)
    gen = np.stack([toks[b, n:n + new] for b, n in enumerate(lengths)])
    vocab = arch.vocab_size - arch.vocab_pad
    assert (gen >= 0).all() and (gen < vocab).all(), f"{tag}: tokens out of range"
    pr = decode_step_profile(torch, np, app, toks, lengths, new)
    shares = pr["shares_ms"]
    B = ids.shape[0]
    run = dict(batch=B, prompt=int(ids.shape[1]), prefill_ms=prefill_ms, decode_ms=decode_ms,
               tok_s=B * 1e3 / decode_ms, launches=counts, commits_by_stack=by_stack,
               profiled_decode_step=pr,
               step_shares_ms=shares, kv_cache_bytes=cache_bytes(app),
               peak_bytes=torch.cuda.max_memory_allocated())
    log(f"{tag} generate() B {B} x {ids.shape[1]}: prefill {prefill_ms:.2f} ms, decode "
        f"{decode_ms:.3f} ms/step, {run['tok_s']:.1f} tok/s; decode step wall "
        f"{pr['wall_ms']:.3f} busy {pr['busy_ms']:.3f} ms (idle {pr['idle_pct']:.1f}%), shares "
        f"{ {k: round(v, 3) for k, v in shares.items()} }; KV cache "
        f"{run['kv_cache_bytes'] / 1e9:.4f} GB, peak {run['peak_bytes'] / 1e9:.2f} GB; "
        f"launches {counts}")
    return run, toks


def hybrid_full_depth(torch, np, mods, card):
    """Phase 5r, bf16, graphs, random weights from seed 0 at the published
    widths, B 8 x 1024-token prompts (two padded, to 1000 and 731), 32 new
    tokens: MiMo-V2-Flash cut to 4 of its layers (MIMO_V2_FLASH: the full
    dense layer and three window MoE layers, ~42 GB) on the full cache with
    the fused MLP on its dense layer, again with the plain MLP, and with the
    window stack on its 128-slot ring (plain MLP, the JAX rule); LFM2-1.2B
    whole through generate(), then its 8 requests on 8 shuffled cache lines
    with staggered arrivals through ``app.forward(seq_ids=)``. Prefill ms, decode ms/step, a profiled
    decode step, KV cache and peak bytes, launches exact."""
    NEW, B, P = 32, 8, 1024
    lens = [P, P, 1000, P, 731, P, P, 1023]
    out = {"mimo_v2_flash": {}, "lfm2_1_2b": {}}

    family = hybrid_family("mimo_v2")
    params = None
    # the fused MLP on the dense layer, then the full cache again with the
    # plain MLP, the ring's own MLP (config.py refuses the projection kernels
    # on a ring, the JAX rule): the ring's gain is read against that run
    mimo_runs = (("full cache", dict(mlp_kernel_enabled=True)), ("full cache, plain MLP", {}),
                 ("ring", dict(window_sized_kv=True, sliding_window=family[2]["sliding_window"])))
    for name, extra in mimo_runs:
        ring = "window_sized_kv" in extra
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        app, arch = hybrid_app(mods, family, device="cuda", dtype="bfloat16", batch=B,
                               seq_len=2048, ctx_len=P, params=params, **extra)
        params = app.params
        gb = sum(v.numel() * v.element_size() for v in _leaves(params)) / 1e9
        log(f"[hybrid-5r MiMo-V2-Flash {name}] 4 layers loaded {time.perf_counter() - t:.1f} s, "
            f"params {gb:.2f} GB; warmup {app.warm_stats}")
        assert arch.full.v_head_dim == 128 and arch.full.head_dim == 192
        ids, mask = prompts(np.random.default_rng(11), B, P, lens, arch.vocab_size)
        run, _ = hybrid_generate(torch, np, mods, f"[hybrid-5r MiMo-V2-Flash {name}]", app, arch,
                                 ids, mask, NEW, ring,
                                 dense_layers=1 if extra.get("mlp_kernel_enabled") else 0)
        run.update(param_gb=gb, ring=ring, swa_slots=int(app.kv_cache["k_swa"].shape[3]))
        out["mimo_v2_flash"][name] = run
        del app
    del params
    gc.collect()
    torch.cuda.empty_cache()

    family = hybrid_family("lfm2")
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    app, arch = hybrid_app(mods, family, device="cuda", dtype="bfloat16", batch=B, seq_len=2048,
                           ctx_len=P)
    gb = sum(v.numel() * v.element_size() for v in _leaves(app.params)) / 1e9
    log(f"[hybrid-5r LFM2-1.2B] 16 layers loaded {time.perf_counter() - t:.1f} s, params "
        f"{gb:.2f} GB; warmup {app.warm_stats}")
    assert arch.intermediate_size == 8192 and arch.n_attn == 6
    ids, mask = prompts(np.random.default_rng(11), B, P, lens, arch.vocab_size)
    run, toks = hybrid_generate(torch, np, mods, "[hybrid-5r LFM2-1.2B]", app, arch, ids, mask,
                                NEW, False, 0)
    run["param_gb"] = gb
    out["lfm2_1_2b"]["generate"] = run
    params = app.params
    del app
    gc.collect()
    torch.cuda.empty_cache()
    cb, _ = hybrid_app(mods, family, device="cuda", dtype="bfloat16", batch=B, seq_len=2048,
                       ctx_len=P, params=params, is_continuous_batching=True, ctx_batch_size=1,
                       tkg_batch_size=B, kv_cache_batch_size=B)
    lines = np.random.default_rng(5).permutation(B).tolist()
    arrivals = [3 * i for i in range(B)]
    reqs = [ids[i, :n].tolist() for i, n in enumerate(mask.sum(axis=1))]
    undo = forward_log(cb)
    count = _count_launches(hybrid_kernels())
    torch.cuda.synchronize()
    t = time.perf_counter()
    try:
        got = lines_drive(cb, reqs, lines, NEW, arrivals=arrivals)
    finally:
        undo()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = count()
    rec = cb.dispatches
    want = hybrid_counts(arch, rec, False, 0)[0]
    assert counts == want, f"5r LFM2 lines: launches {counts} != {want}"
    assert all(len(t) == NEW for t in got), "5r LFM2 lines: a request is short"
    same = sum(got[i] == toks[i, n:n + NEW].tolist() for i, n in enumerate(mask.sum(axis=1)))
    decodes = sum(1 for attend, _, _ in rec if attend)
    out["lfm2_1_2b"]["lines"] = dict(lines=lines, arrivals=arrivals, wall_s=wall,
                                     tok_s=B * NEW / wall, dispatches=len(rec),
                                     decode_dispatches=decodes, launches=counts,
                                     rows_equal_to_generate=same,
                                     kv_cache_bytes=cache_bytes(cb),
                                     peak_bytes=torch.cuda.max_memory_allocated())
    log(f"[hybrid-5r LFM2-1.2B lines] 8 requests on lines {lines}, arrivals {arrivals}: "
        f"{wall:.3f} s, {B * NEW / wall:.1f} tok/s over {len(rec)} dispatches ({decodes} "
        f"decode); {same} of {B} streams equal to generate()'s; launches {counts}; {card}")
    del cb, params
    gc.collect()
    torch.cuda.empty_cache()
    # the kernels line's rows: row 4 by the stack it lands in (a split
    # hybrid_counts derives; only its total is read off the counter), rows
    # 9/10 on MiMo's dense layer, over the three MiMo runs and both LFM2 runs
    mimo = out["mimo_v2_flash"].values()
    lfm = out["lfm2_1_2b"].values()
    out["launches"] = {
        "MiMo-V2 K 192 / V 128": dict(commit=sum(r["commits_by_stack"]["full"] for r in mimo)),
        "MiMo-V2 window stack": dict(commit=sum(r["commits_by_stack"]["swa"] for r in mimo)),
        "MiMo-V2-Flash": dict(mlp=sum(r["launches"]["mlp"] for r in mimo)),
        "LFM2-1.2B": dict(commit=sum(r["launches"]["commit"] for r in lfm)),
    }
    return out


def main() -> int:
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "nxdi_tpu_torch")):
        log("chip_smoke: the nxdi_tpu_torch package is not beside this script")
        return 2
    sys.path.insert(0, repo)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from nxdi_tpu_torch.config import OnDeviceSamplingConfig, TorchConfig
    from nxdi_tpu_torch.generation.hf_adapter import HuggingFaceGenerationAdapter
    from nxdi_tpu_torch.models import dense
    from nxdi_tpu_torch.models.llama import modeling_llama as ml
    from nxdi_tpu_torch.ops.kernels import _build
    from nxdi_tpu_torch.runtime.application import TorchModelForCausalLM

    mods = (ml, TorchConfig, OnDeviceSamplingConfig, TorchModelForCausalLM, dense,
            HuggingFaceGenerationAdapter)
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    _build.build(verbose=True)
    log(f"[build] {time.perf_counter() - t0:.1f} s")
    _build.library()

    kernel_results = []
    check_kernels(torch, kernel_results)
    check_paged_kernels(torch, kernel_results)
    check_mixed_kernels(torch, kernel_results)
    sampler = check_decode_family(torch, np, kernel_results)
    check_one_byte_kernels(torch, kernel_results)
    moe_blocks = check_moe_blocks(torch, card)
    check_mla_kernels(torch, kernel_results)
    check_family_kernels(torch, kernel_results)
    check_moe_family_kernels(torch, kernel_results)
    check_ring_kernels(torch, kernel_results)
    check_chunk_kernels(torch, kernel_results)
    mqa_ragged = check_mqa_kernels(torch, kernel_results)
    check_d256_kernels(torch, kernel_results)
    check_hybrid_commits(torch, kernel_results)
    slice_vs_cpu(torch, np, mods)
    engine_2l_counts, engine_logit_err = engine_vs_cpu(torch, np, mods)
    _, mixed_logit_err = engine_vs_cpu(torch, np, mods, mixed=True)
    cb_logit_err = cb_vs_cpu(torch, np, mods)
    quant_2l = quant_vs_cpu(torch, np, mods)
    spec_2l = spec_vs_cpu(torch, np, mods)
    moe_2l = moe_vs_cpu(torch, np, mods)
    lora_2l = lora_vs_cpu(torch, np, mods)
    mla_2l = mla_vs_cpu(torch, np, mods)
    family_2l = family_vs_cpu(torch, np, mods)
    moe_family_2l = moe_family_vs_cpu(torch, np, mods)
    gemma_2l = gemma_vs_cpu(torch, np, mods)
    nope_2l = nope_vs_cpu(torch, np, mods)
    tier3_2l = tier3_vs_cpu(torch, np, mods)
    gemma_paged_2l = gemma_paged_vs_cpu(torch, np, mods)
    fspec_2l = family_spec_vs_cpu(torch, np, mods)
    hybrid_2l = hybrid_vs_cpu(torch, np, mods)
    gc.collect()
    counts, slice_times = slice_full_depth(torch, np, mods, card)
    slice_tokens = slice_times.pop("tokens")
    # phases 5b and 5c: through the graphs (the main path), then eagerly
    engine = {}
    for mixed in (False, True):
        for graphs in (True, False):
            gc.collect()
            torch.cuda.empty_cache()
            # the split engine's graph app serves phase 5e's unified runs too
            engine[mixed, graphs] = engine_full_depth(torch, np, mods, card, mixed=mixed,
                                                      graphs=graphs,
                                                      keep_app=graphs and not mixed)
    engine_counts, engine_stats = engine[False, True]
    mixed_counts, mixed_stats = engine[True, True]
    # phase 5d: K-step generate() and the contiguous engine three ways
    gc.collect()
    torch.cuda.empty_cache()
    family, family_launches = cb_full_depth(torch, np, mods, card,
                                            dict(slice_times, tokens=slice_tokens))
    family.update(sampler=sampler, phase_4d_max_logit_err=cb_logit_err,
                  launches_by_mode=family_launches)
    # phase 5e: quantized stores and weights, the disaggregated pair, arrivals
    gc.collect()
    torch.cuda.empty_cache()
    quant, quant_launches = quant_full_depth(torch, np, mods, card, slice_times,
                                             engine[False, True][1])
    quant["phase_4e"] = quant_2l
    # phase 5f: speculative decoding at full depth
    gc.collect()
    torch.cuda.empty_cache()
    spec = spec_full_depth(torch, np, mods, card, dict(slice_times, tokens=slice_tokens))
    spec["phase_4f"] = spec_2l
    # phases 5h and 5i: Mixtral at 8 layers, LoRA at 16
    gc.collect()
    torch.cuda.empty_cache()
    moe_stats = dict(phase_3f=moe_blocks, phase_4h=moe_2l,
                     phase_5h=moe_full_depth(torch, np, mods, card))
    lora_stats = dict(phase_4i=lora_2l, phase_5i=lora_full_depth(
        torch, np, mods, card, dict(slice_times, tokens=slice_tokens)))
    # phase 5j: DeepSeek-V3 at 4 layers
    gc.collect()
    torch.cuda.empty_cache()
    mla5j = mla_full_depth(torch, np, mods, card)
    mla_stats = dict(phase_4j=mla_2l, phase_5j=mla5j)
    # phase 5k: Mistral-7B, Qwen3-8B (8 layers), Gemma-2B
    gc.collect()
    torch.cuda.empty_cache()
    family5k = family_full_depth(torch, np, mods, card)
    # phase 5l: Qwen3-30B-A3B (8 layers), gpt-oss-20b (8), MiniMax-M2 (4)
    gc.collect()
    torch.cuda.empty_cache()
    moe5l = moe_family_full_depth(torch, np, mods, card)
    # phase 5m: Gemma-3-27B (12 layers) on the full cache and the ring,
    # Gemma-2-9B (8)
    gc.collect()
    torch.cuda.empty_cache()
    gemma5m = gemma_full_depth(torch, np, mods, card)
    # phase 5n: Llama-4-Scout (8 layers) across its chunk, Command R7B on
    # both caches
    gc.collect()
    torch.cuda.empty_cache()
    nope5n = nope_full_depth(torch, np, mods, card)
    # phase 5o: Falcon-7B (G 71) and its split engine, StarCoder2-15B past
    # its window
    gc.collect()
    torch.cuda.empty_cache()
    tier3_5o = tier3_full_depth(torch, np, mods, card)
    # phase 5p: Gemma-2B whole on the split and mixed engines, bf16 and e4m3
    # pools, and LoRA
    gc.collect()
    torch.cuda.empty_cache()
    gemma5p = gemma_paged_full_depth(torch, np, mods, card)
    # phase 5q: Mistral-7B's ring under fused speculation, Falcon-7B's mixed
    # engine (row 8 at G 71), DeepSeek-V3 (4 layers) under fused speculation
    fspec5q = {}
    for key, fn in (("mistral_7b_ring", fspec_mistral_full_depth),
                    ("falcon_7b_mixed", fspec_falcon_mixed),
                    ("deepseek_v3", fspec_v3_full_depth)):
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        fspec5q[key] = fn(torch, np, mods, card)
        fspec5q[key]["s"] = time.perf_counter() - t
    # phase 5r: MiMo-V2-Flash (4 layers) on both caches, LFM2-1.2B through
    # generate() and on shuffled cache lines
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    hybrid5r = hybrid_full_depth(torch, np, mods, card)
    hybrid5r["s"] = time.perf_counter() - t
    family_stats = dict(phase_4k=family_2l, phase_5k=family5k, phase_4l=moe_family_2l,
                        phase_5l=moe5l, phase_4m=gemma_2l, phase_5m=gemma5m, phase_4n=nope_2l,
                        phase_5n=nope5n, phase_3l_ragged=mqa_ragged, phase_4o=tier3_2l,
                        phase_5o=tier3_5o, phase_4p=gemma_paged_2l, phase_5p=gemma5p,
                        phase_4q=fspec_2l, phase_5q=fspec5q, phase_4r=hybrid_2l,
                        phase_5r=hybrid5r)
    nl = nope5n["launches"]
    gl = gemma5m["launches"]
    fl = family5k["launches"]
    ml5 = moe5l["launches"]
    gp = gemma5p["launches"]
    dense_launches = {
        "Gemma-2B D 256": fl["gemma"],
        # phase 5k's Mistral-7B runs and phase 5q's speculation on its ring
        # (row 1 on the ring's context encodings, row 3 in the full-cache
        # drafts' steps, both runs of each)
        "Mistral-7B window 4096": {k: fl["mistral"][k] + fl["mistral_window"][k]
                                   + sum(r["launches_both_runs"].get(k, 0) for r in
                                         fspec5q["mistral_7b_ring"]["runs"].values())
                                   for k in fl["mistral"]},
        "Gemma-2B tanh GELU": fl["gemma"],
        # the group-size rows count phase 5l's runs at those heads
        "G 8 (Qwen3-30B-A3B)": ml5["Qwen3-30B-A3B"],
        "G 6 (MiniMax-M2, DBRX)": ml5["MiniMax-M2"],
        # the Gemma-3 rows count phase 5m's Gemma-3-27B runs (row 1 in all
        # three, rows 3 and 4 on the ring in its ring run); row 5's ring mode
        # phase 4m's homogeneous ring (Mistral-shaped)
        "Gemma-3-27B": {"prefill": sum(gl[k]["prefill"] for k in gl if "Gemma-3" in k)},
        "ring (Gemma-3-27B)": gl["Gemma-3-27B ring"],
        "ring (Mistral-7B)": gemma_2l["mistral ring"]["launches"],
        # the chunk rows count phase 5n's two Llama-4-Scout runs
        "Llama-4-Scout chunk 8192": {k: sum(nl[n][k] for n in nl if "Scout" in n)
                                     for k in ("prefill", "decode")},
        # the multi-query rows: phase 5o's Falcon-7B runs (generate() and the
        # split engine; row 5 is off that path: the engine decodes through
        # row 7) and phase 4o's BigCode at StarCoder's group (f32)
        # and phase 5q's mixed engine (row 8 at G 71)
        "G 71 (Falcon-7B)": dict(tier3_5o["launches"]["Falcon-7B"],
                                 ragged=fspec5q["falcon_7b_mixed"]["launches"]["ragged"]),
        "G 48 (StarCoder)": tier3_2l["gpt_bigcode G 48"]["launches"],
        # the head-dim-256 paged rows: phase 5p's Gemma-2B engines, bf16 pool
        # (split and mixed) and e4m3 pool (split and mixed)
        "Gemma-2B paged D 256": {k: sum(gp[n].get(k, 0) for n in ("split", "mixed"))
                                 for k in ("paged_prefill", "paged_decode", "ragged")},
        "Gemma-2B e4m3 pool D 256": {k: sum(gp[n].get(k, 0) for n in ("split e4m3", "mixed e4m3"))
                                     for k in ("paged_prefill", "paged_decode", "ragged")},
    }
    # the hybrids' commit rows (phase 3n) count phase 5r's runs by stack, the
    # MiMo-V2-Flash MLP rows its fused MLP runs
    dense_launches.update(hybrid5r["launches"])
    # the bucket-8 row: phase 5p's mixed decode-only dispatches, bf16 pool
    dense_launches["Gemma-2B paged D 256 bucket 8"] = {
        "ragged": 18 * gemma5p["mixed"]["packed_vs_padded_by_bucket"]["8"]["dispatches"]}
    # the latent-width commit and V3's MLP rows count phase 5j's runs
    # (and phase 5q's DeepSeek-V3 speculation, both runs)
    mla_launches = {k: sum(r["launches"][k] for rs in mla5j["runs"].values() for r in rs)
                    + mla5j["engine"]["launches"][k]
                    + fspec5q["deepseek_v3"]["run"]["launches_both_runs"][k]
                    for k in ("commit", "mlp")}
    for _, st in engine.values():
        st.pop("prompts")
        st.pop("app", None)
    # the head-dim-128 rows count phase 5h's generate() runs and split engine
    moe5h = moe_stats["phase_5h"]
    counts_128 = {k: sum(r["launches"][k] for rs in moe5h["runs"].values() for r in rs)
                  for k in ("prefill", "decode", "commit")}
    counts_128["prefill"] += moe5h["engine_launches"]["prefill"]
    counts_128.update({k: moe5h["engine_launches"][k] for k in ("paged_prefill", "paged_decode")})
    # and phase 5k's Qwen3-8B (the same heads: 32 over 8 of 128), its
    # generate() and its split engine
    q5k = family5k["qwen3_8b"]
    for k in ("prefill", "decode", "commit"):
        counts_128[k] += fl["qwen3"][k] + q5k["engine_launches"][k]
    for k in ("paged_prefill", "paged_decode"):
        counts_128[k] += q5k["engine_launches"][k]
    # rows 1, 3 and 4 count phase 5f's runs beside phase 5's
    counts = {k: v + spec["launches_total"].get(k, 0) for k, v in counts.items()}
    counts = dict(counts, window_decode=engine_2l_counts["window_decode"],
                  paged_prefill=engine_counts["paged_prefill"],
                  paged_decode=engine_counts["paged_decode"],
                  **{k: mixed_counts[k] for k in ("ragged", "qkv", "mlp")})
    engine_stats["phase_4b_max_logit_err"] = engine_logit_err
    mixed_stats["phase_4c_max_logit_err"] = mixed_logit_err
    engine_stats["eager"], mixed_stats["eager"] = engine[False, False][1], engine[True, False][1]
    keys = ("tok_s", "ttft_p50_ms", "ttft_p95_ms", "tpot_p50_ms")
    for name, st in (("split (5b)", engine_stats), ("mixed (5c)", mixed_stats)):
        ea = st["eager"]
        log(f"[engine-16L] {name} graphs vs eager, {card}: " + "; ".join(
            f"{k} {st[k]:.3f} vs {ea[k]:.3f}" for k in keys)
            + "; profiled decode step wall {:.3f} vs {:.3f} ms, busy {:.3f} vs {:.3f} ms, "
            "idle {:.1f} vs {:.1f} %; streams {}".format(
                st["profiled_decode_step"]["wall_ms"], ea["profiled_decode_step"]["wall_ms"],
                st["profiled_decode_step"]["busy_ms"], ea["profiled_decode_step"]["busy_ms"],
                st["profiled_decode_step"]["idle_pct"], ea["profiled_decode_step"]["idle_pct"],
                "identical" if st["streams"] == ea["streams"] else "differ"))

    sources = {
        "prefill": ("flash_attention_prefill", "nxdi_tpu_torch/csrc/flash_prefill.cu",
                    "nxdi_tpu/ops/kernels/flash_attention.py:234"),
        "decode": ("flash_attention_decode_fused", "nxdi_tpu_torch/csrc/flash_decode.cu",
                   "nxdi_tpu/ops/kernels/flash_attention.py:509,629"),
        "commit": ("kv_commit_rows", "nxdi_tpu_torch/csrc/kv_commit.cu",
                   "nxdi_tpu/ops/kernels/kv_commit.py:170"),
        "window_decode": ("flash_attention_decode", "nxdi_tpu_torch/csrc/window_decode.cu",
                          "nxdi_tpu/ops/kernels/flash_attention.py:337"),
        "paged_prefill": ("paged_attention_prefill", "nxdi_tpu_torch/csrc/paged_prefill.cu",
                          "nxdi_tpu/ops/kernels/flash_attention.py:946"),
        "paged_decode": ("paged_attention_decode", "nxdi_tpu_torch/csrc/paged_decode.cu",
                         "nxdi_tpu/ops/kernels/flash_attention.py:802"),
        "ragged": ("ragged_paged_attention", "nxdi_tpu_torch/csrc/ragged_paged.cu",
                   "nxdi_tpu/ops/kernels/ragged_paged_attention.py:199"),
        "qkv": ("qkv_matmul", "nxdi_tpu_torch/csrc/qkv_matmul.cu",
                "nxdi_tpu/ops/kernels/fused_proj.py:327,405"),
        "mlp": ("fused_mlp", "nxdi_tpu_torch/csrc/fused_mlp.cu",
                "nxdi_tpu/ops/kernels/fused_proj.py:128,246"),
    }
    summary = []
    fields = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for key, (name, src, replaces) in sources.items():
        # the QKV and MLP rows at the packed step's 520 rows first, then by M;
        # the ragged rows at bucket 8 and at 1032
        # (timed rows: phase 3e checks e5m2, int8 and f32 q without timing them)
        rows = [r for r in kernel_results
                if r["kernel"] == key and r["dtype"] == "bfloat16" and "ms" in r]
        rows.sort(key=lambda r: r.get("M", 520) != 520)
        for row in rows:
            # the rows with cache lines: the contiguous engine's device loop
            # (5d); the one-byte rows: phase 5e's runs on e4m3 stores
            # (5h's runs for the head-dim-128 rows)
            launches = (family_launches["loop"][key] if row.get("point") == "cache lines"
                        else dense_launches[row["point"]].get(key, 0)
                        if row.get("point") in dense_launches
                        else mla_launches[key] if row.get("point") in ("MLA latent",
                                                                       "DeepSeek-V3")
                        else quant_launches[key] if "store" in row
                        else counts_128[key] if row.get("head_dim") == 128 else counts[key])
            entry = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                     "launches": launches, **{f: row[f] for f in fields}}
            entry.update({f: row[f] for f in ("M", "point", "head_dim", "body", "split_body",
                                              "ms_min",
                                              "ms_max",
                                              "earlier_ms", "mma_sync_ms", "launch_floor_ms",
                                              "graph_ready_ms", "store", "bf16_pool_ms",
                                              "k_width", "v_width", "hidden", "inter",
                                              "window", "act", "ring", "chunk", "group",
                                              "head_tiles", "unchunked_ms", "layers")
                          if f in row})
            if row.get("point") in ("G 8 (Qwen3-30B-A3B)", "G 6 (MiniMax-M2, DBRX)"):
                entry["group"] = int(row["point"].split()[1])
            summary.append(entry)
    os.makedirs(os.path.join(repo, "chiprun_out"), exist_ok=True)
    with open(os.path.join(repo, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kernels": kernel_results, "slice": slice_times,
                   "engine": engine_stats, "mixed_engine": mixed_stats, "counts": counts,
                   "decode_family": family, "quantization": quant, "speculation": spec,
                   "moe": moe_stats, "lora": lora_stats, "mla": mla_stats,
                   "families": family_stats, "kernel_summary": summary}, f, indent=1,
                  default=str)
    print(json.dumps({"slice": slice_times, "engine": engine_stats, "mixed_engine": mixed_stats,
                      "decode_family": {k: v for k, v in family.items() if k != "engine"},
                      "quantization": quant, "speculation": spec, "moe": moe_stats,
                      "lora": lora_stats, "mla": mla_stats, "families": family_stats,
                      "kernel_checks": kernel_results}, default=str))
    print(json.dumps({"kernels": summary}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Medusa speculative decoding: extra prediction heads on the target model
(counterpart of ``nxdi_tpu/speculation/medusa.py``).

Each head ``i`` proposes the token ``i + 1`` positions ahead from the hidden
state that feeds the lm_head. A window verifies the previous window's
proposals with one multi-token target forward (acceptance is the longest
prefix equal to the target's greedy choices, so the emitted tokens are the
target's and the output equals target-only greedy decoding), then refreshes
the proposals from the hidden state at the accept point. The proposals live
between windows in the cache as ``medusa_tokens`` (cache lines, num_heads,
top-K), updated in place.

The tree variant (:func:`medusa_tree_token_gen`) scores a whole token tree
in one verify under an explicit ancestor mask, then moves the best path's
K/V from its tree slots to the contiguous positions the next window expects
(``token_tree.move_path_rows``, shared with EAGLE's trees).
Everything stays in place and at fixed shapes, so each window is one CUDA
graph per bucket on the card. The heads, the acceptance and the masked
attention are plain PyTorch, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from nxdi_tpu_torch.kvcache.kv_cache import DEFAULT_KV_LAYOUT
from nxdi_tpu_torch.models.base import _norm, causal_lm_forward
from nxdi_tpu_torch.ops import sampling as sampling_ops
from nxdi_tpu_torch.runtime.model_wrapper import ModelWrapper
from nxdi_tpu_torch.speculation.eagle import _feature_rows
from nxdi_tpu_torch.speculation.token_tree import (
    best_path_acceptance,
    gather_tree_candidates,
    move_path_rows,
    tree_tensors,
    tree_verify_mask,
)


def medusa_propose(heads: Dict[str, torch.Tensor], hidden: torch.Tensor, vocab_pad: int,
                   topk: int = 1) -> torch.Tensor:
    """Top-K proposals of every head -> (B, num_heads, topk). ``hidden``
    (B, H) is the post-norm hidden that also feeds the lm_head. The heads
    are stacked (K, ...): a ResBlock (x + silu(x W + b)), then the head's
    lm_head."""
    x = torch.einsum("bh,khg->bkg", hidden, heads["res_w"]) + heads["res_b"][None]
    x = hidden[:, None, :] + F.silu(x)  # (B, K, H)
    logits = torch.einsum("bkh,khv->bkv", x, heads["head"]).float()
    logits = sampling_ops.mask_padded_logits(logits, vocab_pad)
    return torch.topk(logits, topk, dim=-1).indices.to(torch.int32)


def _post_norm_hidden_at(arch, params, hidden_stream: torch.Tensor, idx: torch.Tensor):
    """The pre-norm hidden at per-row index ``idx`` (B,), through the
    family's own final norm (Gemma's (1 + w) RMSNorm, a LayerNorm): the
    stream the lm_head (and so the heads) read. The JAX package applies a
    plain RMSNorm here whatever the family's (ROADMAP Queue 3), which moves
    the proposals only: the emitted tokens are the target's greedy tokens
    either way."""
    B = hidden_stream.shape[0]
    h = hidden_stream[torch.arange(B, device=idx.device), idx.long()]
    return _norm(arch, h, params["norm"])


def _kv(cache):
    return {"k": cache["k"], "v": cache["v"]}


def medusa_context_encoding(arch, inv_freq, params: Dict[str, Any], cache: Dict[str, Any],
                            batch: Dict[str, torch.Tensor], *, layout=DEFAULT_KV_LAYOUT,
                            **sampling_kwargs):
    """The prompt: sample the first token and seed the proposals from the
    last prompt position's hidden state."""
    out, _ = causal_lm_forward(
        arch, inv_freq, params, _kv(cache), batch, attend_to_cache=False, layout=layout,
        gather_last_token=True, on_device_sampling=True, output_hidden=True, **sampling_kwargs)
    B = batch["input_ids"].shape[0]
    h = _post_norm_hidden_at(arch, params, out["hidden"], batch["last_token_index"])
    buf = cache["medusa_tokens"]
    buf[_feature_rows(batch, B)] = medusa_propose(params["medusa_heads"], h, arch.vocab_pad,
                                                  buf.shape[-1])
    counts = torch.ones((B,), dtype=torch.int32, device=h.device)
    return {"tokens": out["tokens"], "counts": counts}, cache


def medusa_token_gen(arch, inv_freq, params: Dict[str, Any], cache: Dict[str, Any],
                     batch: Dict[str, torch.Tensor], *, num_heads: int, kv_window: int,
                     layout=DEFAULT_KV_LAYOUT):
    """One chain window: verify the last window's top-1 proposals, emit the
    target's greedy tokens and the accept count, refresh the proposals at
    the accept point."""
    B = batch["input_ids"].shape[0]
    tok0 = batch["input_ids"].to(torch.int32)
    pos0 = batch["position_ids"].to(torch.int32)
    rows = _feature_rows(batch, B)
    buf = cache["medusa_tokens"]
    proposals = buf[rows][..., 0]  # (B, K) chain = top-1
    candidates = torch.cat([tok0, proposals], dim=1)
    dev = tok0.device
    tbatch = {"input_ids": candidates,
              "position_ids": pos0 + torch.arange(num_heads + 1, dtype=torch.int32,
                                                  device=dev)[None, :],
              "last_token_index": torch.zeros((B,), dtype=torch.int32, device=dev),
              "sampling_params": batch["sampling_params"]}
    if "seq_ids" in batch:
        tbatch["seq_ids"] = batch["seq_ids"]
    out, _ = causal_lm_forward(
        arch, inv_freq, params, _kv(cache), tbatch, attend_to_cache=True, kv_window=kv_window,
        layout=layout, gather_last_token=False, output_logits=True,
        on_device_sampling=False, output_hidden=True)
    target_tokens = sampling_ops.greedy_sample(out["logits"])  # (B, K + 1)
    matches = (proposals == target_tokens[:, :-1]).to(torch.int32)
    counts = torch.cumprod(matches, dim=1).sum(dim=1).to(torch.int32) + 1
    # refresh from the last retired position's hidden (the host clamps
    # retirement to the window edge; mirror it)
    retire = torch.minimum(counts, kv_window - 1 - pos0[:, 0]).clamp(1, num_heads + 1)
    h = _post_norm_hidden_at(arch, params, out["hidden"], retire - 1)
    buf[rows] = medusa_propose(params["medusa_heads"], h, arch.vocab_pad, buf.shape[-1])
    return {"tokens": target_tokens, "counts": counts}, cache


def medusa_tree_token_gen(arch, inv_freq, params: Dict[str, Any], cache: Dict[str, Any],
                          batch: Dict[str, torch.Tensor], *, tree, num_heads: int,
                          kv_window: int, layout=DEFAULT_KV_LAYOUT):
    """One tree window: one verify scores every node (nodes share rope
    positions by depth and write distinct slots), the best accepted path's
    K/V is moved to the contiguous positions the next window expects, and
    the proposals are refreshed from its last retired row."""
    B = batch["input_ids"].shape[0]
    tok0 = batch["input_ids"].to(torch.int32)
    pos0 = batch["position_ids"].to(torch.int32)  # (B, 1)
    dev = tok0.device
    rows = _feature_rows(batch, B)
    buf = cache["medusa_tokens"]
    N, D = tree.num_nodes, tree.max_depth
    candidates = gather_tree_candidates(tree, tok0, buf[rows])  # (B, 1 + N)
    tbatch = {"input_ids": candidates,
              "position_ids": pos0 + tree_tensors(tree, dev)["depth_row"][None, :],
              "write_positions": pos0 + torch.arange(N + 1, dtype=torch.int32,
                                                     device=dev)[None, :],
              "attn_mask": tree_verify_mask(tree, pos0[:, 0], kv_window),
              "last_token_index": torch.zeros((B,), dtype=torch.int32, device=dev),
              "sampling_params": batch["sampling_params"]}
    if "seq_ids" in batch:
        tbatch["seq_ids"] = batch["seq_ids"]
    out, _ = causal_lm_forward(
        arch, inv_freq, params, _kv(cache), tbatch, attend_to_cache=True, kv_window=kv_window,
        layout=layout, gather_last_token=False, output_logits=True,
        on_device_sampling=False, output_hidden=True)
    target_tokens = sampling_ops.greedy_sample(out["logits"])  # (B, 1 + N)
    counts, best_path, emit_rows = best_path_acceptance(tree, candidates, target_tokens)
    # near the window edge some node writes fall past the window and their
    # rows read a clipped mask: only the root's token is sound there
    tree_fits = pos0[:, 0] + 1 + N <= kv_window
    counts = torch.where(tree_fits, counts, torch.ones_like(counts))
    tokens_out = torch.gather(target_tokens, 1, emit_rows)  # (B, 1 + D)

    # K/V fix-up: the best path's rows from their tree slots to pos0 + 1 ..
    # pos0 + D, on the lines the layout writes
    dest = pos0 + 1 + torch.arange(D, dtype=torch.int32, device=dev)[None, :]
    move_path_rows(cache, pos0 + 1 + best_path.clamp(min=0), dest,
                   rows if layout.route_by_seq_id else None)

    retire = torch.minimum(counts, kv_window - 1 - pos0[:, 0]).clamp(1, D + 1)
    last_row = torch.gather(emit_rows, 1, (retire - 1).long()[:, None])[:, 0]
    h = _post_norm_hidden_at(arch, params, out["hidden"], last_row)
    buf[rows] = medusa_propose(params["medusa_heads"], h, arch.vocab_pad, buf.shape[-1])
    return {"tokens": tokens_out.to(torch.int32), "counts": counts}, cache


class MedusaWrapper(ModelWrapper):
    """The Medusa context-encoding and window submodels. A chain window
    writes num_heads + 1 slots ahead, a tree one slot per node plus the
    root: that is the wrapper's ``lookahead``."""

    def __init__(self, *args, num_heads: int, tree=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.num_heads = num_heads
        self.tree = tree
        if self.attend_to_cache:
            self.lookahead = (tree.num_nodes + 1) if tree is not None else num_heads + 1

    def _call_forward(self, key, params, cache, dev):
        if not self.attend_to_cache:
            return medusa_context_encoding(self.arch, self.inv_freq, params, cache, dev,
                                           layout=self.layout, **self.forward_kwargs)[0]
        if self.tree is not None:
            return medusa_tree_token_gen(self.arch, self.inv_freq, params, cache, dev,
                                         tree=self.tree, num_heads=self.num_heads,
                                         kv_window=key, layout=self.layout)[0]
        return medusa_token_gen(self.arch, self.inv_freq, params, cache, dev,
                                num_heads=self.num_heads, kv_window=key, layout=self.layout)[0]

"""Fused speculative decoding: a draft and a target model, and a whole
speculation window in one forward (counterpart of
``nxdi_tpu/speculation/fused.py``).

One window (:func:`fused_spec_token_gen`) runs ``spec_len + 1`` greedy
draft steps, one multi-token target verify over the candidates
``[t_cur, d_1 .. d_k]``, and the acceptance (the longest prefix of drafts
that match the target's greedy token, by a ``cumprod``), all on the device:
on the card the wrapper captures the whole window as one CUDA graph per KV
bucket, so the host sees one staging copy, one replay and one read of
``tokens`` and ``counts`` per window. The emitted tokens are always the
target's greedy tokens, so the output equals target-only greedy decoding
for any draft; the draft only sets how many tokens a window retires. The
draft runs ``spec_len + 1`` steps (not ``spec_len``) so that the last
drafted token's K/V is written too; rejected rows leave K/V at future
positions, which the next window overwrites before any query attends them.

Each draft step is an ordinary deferred decode step: on the card the
stacked fused-decode kernel, then the commit kernel writes the step's row
(the JAX package's per-step-commit branch); an MLA draft's step is an
ordinary MLA decode forward, each layer committing its latent row. The
JAX package's default, a scratch window attended beside the old cache and
committed once after the last step, exists because a commit on the TPU
rewrites a 128-slot window; the card's commit writes rows directly, and
the per-step body was the faster of the two there (PERF.md), so the port
has this one body. Each model's cache is whatever its config gives it: a
window-sized target's ring (homogeneous, or the interleaved ``k_win``
stack beside its full layers, ``window_ring_slots`` slots) beside a
full-cache draft, each addressed through its own layout.

The verify's multi-token attention (``tkg_two_part_xla``) and the acceptance
stay plain PyTorch, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from nxdi_tpu_torch.kvcache.kv_cache import DEFAULT_KV_LAYOUT
from nxdi_tpu_torch.models.base import causal_lm_forward
from nxdi_tpu_torch.ops import sampling as sampling_ops
from nxdi_tpu_torch.runtime.model_wrapper import ModelWrapper


def fused_spec_context_encoding(
    draft_arch,
    target_arch,
    draft_inv_freq,
    target_inv_freq,
    params: Dict[str, Any],  # {"draft": ..., "target": ...}
    cache: Dict[str, Any],  # {"draft": ..., "target": ...}
    batch: Dict[str, torch.Tensor],
    layout=DEFAULT_KV_LAYOUT,
    draft_layout=None,
    **sampling_kwargs,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """The target's and the draft's context encodings back to back in one
    forward. Returns the target's sampled first token (and ``counts`` of 1);
    both caches are filled with the prompt in place."""
    t_out, _ = causal_lm_forward(
        target_arch, target_inv_freq, params["target"], cache["target"], batch,
        attend_to_cache=False, layout=layout, gather_last_token=True,
        on_device_sampling=True, **sampling_kwargs)
    causal_lm_forward(
        draft_arch, draft_inv_freq, params["draft"], cache["draft"], batch,
        attend_to_cache=False, layout=draft_layout if draft_layout is not None else layout,
        gather_last_token=True, on_device_sampling=True, **sampling_kwargs)
    B = batch["input_ids"].shape[0]
    counts = torch.ones((B,), dtype=torch.int32, device=t_out["tokens"].device)
    return {"tokens": t_out["tokens"], "counts": counts}, cache


def _draft_steps(draft_arch, draft_inv_freq, d_params, d_cache, tok0, pos0, step_batch, *,
                 W: int, kv_window, d_lay, feat=None, map_token=None) -> torch.Tensor:
    """The window's W greedy draft steps from (tok0, pos0); returns the
    candidates (B, W) = each step's input token. The draft cache ends with
    the window's W rows committed at pos0 .. pos0 + W - 1. An EAGLE draft
    takes ``feat`` (B, H), the feature before tok0, and chains each step's
    pre-norm hidden as the next step's feature; ``map_token`` maps its
    tokens to the target's ids (EAGLE3's ``d2t``)."""
    fed = []
    tok, pos = tok0, pos0
    for _ in range(W):
        sbatch = {**step_batch, "input_ids": tok, "position_ids": pos}
        if feat is not None:
            sbatch["prev_hidden"] = feat[:, None, :]
        out, _ = causal_lm_forward(
            draft_arch, draft_inv_freq, d_params, d_cache, sbatch,
            attend_to_cache=True, kv_window=kv_window, layout=d_lay,
            gather_last_token=False, on_device_sampling=True, output_hidden=feat is not None)
        fed.append(tok)
        nxt = out["tokens"] if map_token is None else map_token(out["tokens"])
        tok, pos = nxt.to(torch.int32), pos + 1
        if feat is not None:
            feat = out["hidden"][:, 0]
    return torch.cat(fed, dim=1)


def fused_spec_token_gen(
    draft_arch,
    target_arch,
    draft_inv_freq,
    target_inv_freq,
    params: Dict[str, Any],
    cache: Dict[str, Any],
    batch: Dict[str, torch.Tensor],
    *,
    spec_len: int,
    kv_window: Optional[int],
    layout=DEFAULT_KV_LAYOUT,
    draft_layout=None,
    return_next_inputs: bool = False,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """One speculation window.

    ``batch``: input_ids (B, 1), the last accepted token, and position_ids
    (B, 1), its position. Returns ``tokens`` (B, spec_len + 1), the target's
    greedy token at every candidate position, and ``counts`` (B,), the
    accepted drafts plus the bonus token: the host takes ``tokens[b,
    :counts[b]]``. ``return_next_inputs``: also the next window's inputs on
    the device (its last emitted token, at position pos0 + counts)."""
    B = batch["input_ids"].shape[0]
    tok0 = batch["input_ids"].to(torch.int32)
    pos0 = batch["position_ids"].to(torch.int32)
    lti = torch.zeros((B,), dtype=torch.int32, device=tok0.device)
    sp = batch["sampling_params"]
    d_lay = draft_layout if draft_layout is not None else layout
    W = spec_len + 1
    step_batch = {"last_token_index": lti, "sampling_params": sp}
    if "seq_ids" in batch:
        step_batch["seq_ids"] = batch["seq_ids"]
    candidates = _draft_steps(
        draft_arch, draft_inv_freq, params["draft"], cache["draft"], tok0, pos0, step_batch,
        W=W, kv_window=kv_window, d_lay=d_lay)

    # the target verifies every candidate in one multi-token forward, its
    # greedy token per position selected on the device
    positions = pos0 + torch.arange(W, dtype=torch.int32, device=pos0.device)[None, :]
    tbatch = {"input_ids": candidates, "position_ids": positions,
              "last_token_index": torch.full((B,), spec_len, dtype=torch.int32,
                                             device=tok0.device),
              "sampling_params": sp}
    if "seq_ids" in batch:
        tbatch["seq_ids"] = batch["seq_ids"]
    t_out, _ = causal_lm_forward(
        target_arch, target_inv_freq, params["target"], cache["target"], tbatch,
        attend_to_cache=True, kv_window=kv_window, layout=layout, gather_last_token=False,
        output_argmax_all=True, on_device_sampling=False)
    target_tokens = t_out["tokens"].to(torch.int32)  # (B, W)

    # acceptance: the longest prefix of drafts equal to the target's choice
    matches = (candidates[:, 1:] == target_tokens[:, :-1]).to(torch.int32)
    counts = torch.cumprod(matches, dim=1).sum(dim=1).to(torch.int32) + 1
    outputs: Dict[str, Any] = {"tokens": target_tokens, "counts": counts}
    if return_next_inputs:
        # the device-resident window chain: the next window starts from the
        # last emitted token, target_tokens[b, counts[b] - 1], at pos0 + counts
        last_tok = torch.gather(target_tokens, 1, (counts - 1).long()[:, None])
        nxt = {"input_ids": last_tok.to(torch.int32),
               "position_ids": (pos0[:, 0] + counts)[:, None].to(torch.int32),
               "last_token_index": lti, "sampling_params": sp}
        if "rng" in batch:
            nxt["rng"] = sampling_ops.next_step_rng(batch["rng"])
        if "seq_ids" in batch:
            nxt["seq_ids"] = batch["seq_ids"]
        outputs["next_inputs"] = nxt
    return outputs, cache


class FusedSpecWrapper(ModelWrapper):
    """The fused context-encoding and window submodels: one forward (a CUDA
    graph per bucket on the card) over both models' params and caches.
    ``lookahead = spec_len + 1`` widens the window's bucket choice so its
    write positions (up to pos + spec_len) stay inside the KV window."""

    def __init__(self, *args, draft_arch, draft_inv_freq, spec_len: int, draft_layout=None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.draft_arch = draft_arch
        self.draft_inv_freq = torch.as_tensor(draft_inv_freq, dtype=torch.float32,
                                              device=self.device)
        self.spec_len = spec_len
        # the draft's own layout (from its config)
        self.draft_layout = draft_layout if draft_layout is not None else self.layout
        if self.attend_to_cache:
            self.lookahead = spec_len + 1

    def _call_forward(self, key, params, cache, dev):
        if self.attend_to_cache:
            return fused_spec_token_gen(
                self.draft_arch, self.arch, self.draft_inv_freq, self.inv_freq, params, cache,
                dev, spec_len=self.spec_len, kv_window=key, layout=self.layout,
                draft_layout=self.draft_layout,
                return_next_inputs=bool(self.forward_kwargs.get("return_next_inputs", False)),
            )[0]
        return fused_spec_context_encoding(
            self.draft_arch, self.arch, self.draft_inv_freq, self.inv_freq, params, cache, dev,
            layout=self.layout, draft_layout=self.draft_layout, **self.forward_kwargs)[0]

"""EAGLE / EAGLE3 fused speculative decoding (counterpart of
``nxdi_tpu/speculation/eagle.py``).

An EAGLE draft is a 1-layer model whose input at position ``p`` is the token
embedding at ``p`` fused with the *feature* of position ``p - 1`` by its
``fc`` projection (``models/base.py`` does this when the params carry
``fc``). Features are the target's last-layer hidden states before the
final norm; inside a window the draft chains its OWN pre-norm hidden states
as features (the EAGLE recurrence). EAGLE3's feature is the concatenation of
a few target layers' outputs (``aux_hidden_indices``), projected to the
draft's width by its ``fc_features``; its draft may score a reduced
vocabulary whose ids ``d2t`` maps back to the target's.

Between windows the feature of the position before each sequence's next
input token lives in the cache as ``features`` (cache lines, draft hidden),
in the draft's dtype, written in place at the retired index of every window
(the JAX package's functional buffer).

Three windows, each one CUDA graph per bucket on the card:

- :func:`eagle_token_gen`, the chain: ``spec_len + 1`` draft steps, each a
  deferred decode step on the stacked fused-decode kernel followed by the
  commit kernel (``fused._draft_steps``, fed its features), one verify
  over the candidates, and the acceptance;
- :func:`eagle_tree_token_gen`, a static token tree: one draft pass per
  depth under the tree's ancestor mask, children from the top
  ``max_branch`` draft logits of each parent's row, one verify of the whole
  tree, best-path acceptance and the best path's K/V moved on both caches
  (``token_tree.move_path_rows``);
- :func:`eagle_dynamic_tree_token_gen`, a tree grown in the window from the
  draft's log-probabilities; its parents and masks are device tensors.

The masked passes attend plainly under their explicit mask (the JAX package
leaves them to XLA); their K/V rows land through the commit kernel. Every
top-k orders equal values by lower index first, as ``jax.lax.top_k`` does.
The emitted tokens are the target's greedy tokens, so the output equals
target-only greedy decoding for any draft.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch

from nxdi_tpu_torch.kvcache.kv_cache import DEFAULT_KV_LAYOUT
from nxdi_tpu_torch.models.base import _linear, causal_lm_forward
from nxdi_tpu_torch.ops.sampling import top_k_lower_index_first
from nxdi_tpu_torch.speculation.fused import FusedSpecWrapper, _draft_steps
from nxdi_tpu_torch.speculation.token_tree import (
    DynamicTreeSpec,
    TokenTree,
    best_path_acceptance,
    dynamic_tree_kv_mask,
    move_path_rows,
    tree_tensors,
    tree_verify_mask,
)


def _feature_rows(batch: Dict[str, torch.Tensor], B: int) -> torch.Tensor:
    """Row indices into a per-line buffer (``features``, Medusa's
    ``medusa_tokens``): ``seq_ids`` under continuous batching, else batch
    order, mirroring the KV cache's row routing."""
    ids = batch.get("seq_ids")
    if ids is None:
        return torch.arange(B, dtype=torch.long, device=batch["input_ids"].device)
    return ids.reshape(B).long()


def _project_features(draft_arch, draft_params: Dict[str, Any],
                      hidden: torch.Tensor) -> torch.Tensor:
    """EAGLE3: the target's aux-hidden concat -> the draft's width through
    ``fc_features``; EAGLE: the identity."""
    if "fc_features" in draft_params:
        return _linear(hidden, draft_params["fc_features"], draft_arch.act_quant,
                       draft_arch.act_clamp)
    return hidden


def _target_feature_kwargs(is_eagle3: bool, aux_hidden_indices) -> Dict[str, Any]:
    if is_eagle3:
        return {"aux_hidden_indices": tuple(aux_hidden_indices)}
    return {"output_hidden": True}


def _target_features(is_eagle3: bool, t_out: Dict[str, torch.Tensor]) -> torch.Tensor:
    return t_out["aux_hidden"] if is_eagle3 else t_out["hidden"]


def _draft_token(draft_params: Dict[str, Any], tokens: torch.Tensor) -> torch.Tensor:
    """Draft-vocab ids -> target ids (EAGLE3's ``d2t``), any shape."""
    if "d2t" in draft_params:
        return draft_params["d2t"][tokens.long()].to(torch.int32)
    return tokens.to(torch.int32)


def _log_softmax(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.log_softmax's arithmetic over the last axis."""
    shifted = x - x.amax(dim=-1, keepdim=True)
    return shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))


def _top_k(x: torch.Tensor, k: int):
    """``top_k_lower_index_first`` over the last axis of any (..., V)."""
    vals, idx = top_k_lower_index_first(x.reshape(-1, x.shape[-1]), k)
    return vals.reshape(*x.shape[:-1], k), idx.reshape(*x.shape[:-1], k)


def _store_features(cache, rows: torch.Tensor, feat: torch.Tensor) -> None:
    """The features buffer at ``rows``, in place (a fixed address, so a
    window graph replays over it), cast to the buffer's dtype."""
    buf = cache["features"]
    buf.index_copy_(0, rows, feat.to(buf.dtype))


def eagle_context_encoding(
    draft_arch,
    target_arch,
    draft_inv_freq,
    target_inv_freq,
    params: Dict[str, Any],  # {"draft", "target"}
    cache: Dict[str, Any],  # {"draft", "target", "features"}
    batch: Dict[str, torch.Tensor],
    *,
    is_eagle3: bool = False,
    aux_hidden_indices: Optional[Tuple[int, ...]] = None,
    layout=DEFAULT_KV_LAYOUT,
    draft_layout=None,
    **sampling_kwargs,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """The prompt: the target's context encoding emits features, the draft's
    consumes the prompt with its features shifted one right (zero at the
    first position), and the buffer keeps the last prompt token's feature
    for the first window. Returns the target's sampled first token."""
    t_out, _ = causal_lm_forward(
        target_arch, target_inv_freq, params["target"], cache["target"], batch,
        attend_to_cache=False, layout=layout, gather_last_token=True, on_device_sampling=True,
        **_target_feature_kwargs(is_eagle3, aux_hidden_indices), **sampling_kwargs)
    feats = _project_features(draft_arch, params["draft"], _target_features(is_eagle3, t_out))
    # the draft sees (token_j, feature_{j-1})
    prev_hidden = torch.cat([torch.zeros_like(feats[:, :1]), feats[:, :-1]], dim=1)
    causal_lm_forward(
        draft_arch, draft_inv_freq, params["draft"], cache["draft"],
        {**batch, "prev_hidden": prev_hidden}, attend_to_cache=False,
        layout=draft_layout if draft_layout is not None else layout, gather_last_token=True,
        on_device_sampling=True)
    B = batch["input_ids"].shape[0]
    lti = batch["last_token_index"].long()
    _store_features(cache, _feature_rows(batch, B),
                    feats[torch.arange(B, device=lti.device), lti])
    counts = torch.ones((B,), dtype=torch.int32, device=lti.device)
    return {"tokens": t_out["tokens"], "counts": counts}, cache


def _retired_feature(draft_arch, draft_params, t_out, is_eagle3, row: torch.Tensor):
    """The target's feature at per-row index ``row`` (B,), projected."""
    f = _target_features(is_eagle3, t_out)
    return _project_features(draft_arch, draft_params,
                             f[torch.arange(f.shape[0], device=row.device), row.long()])


def _retire(counts, pos0, kv_window: int, limit: int) -> torch.Tensor:
    """The number of tokens the host retires from a window: the count,
    clamped as the host clamps it at the compiled KV window's edge
    (``hf_adapter._fused_spec_decode``), so the buffered feature and the next
    start token stay in step there."""
    return torch.minimum(counts, kv_window - 1 - pos0[:, 0]).clamp(1, limit)


def eagle_verify(target_arch, target_inv_freq, params, cache, batch, candidates, rope_pos, *,
                 mask=None, kv_window: int, layout, is_eagle3: bool, aux_hidden_indices):
    """The target's verify of a window's candidates (B, S): its greedy token
    at every row (``tokens``) and its features. A chain (``mask`` None) is a
    deferred multi-token step whose rows the commit kernel lands after the
    layers; a tree's rows write slots pos0 .. pos0 + S - 1 and attend under
    its explicit ``mask`` (B, S, W)."""
    B, S = candidates.shape
    dev = candidates.device
    tbatch = {"input_ids": candidates, "position_ids": rope_pos,
              "last_token_index": torch.zeros((B,), dtype=torch.int32, device=dev),
              "sampling_params": batch["sampling_params"]}
    if mask is not None:
        tbatch["write_positions"] = (batch["position_ids"].to(torch.int32)
                                     + torch.arange(S, dtype=torch.int32, device=dev)[None, :])
        tbatch["attn_mask"] = mask
    if "seq_ids" in batch:
        tbatch["seq_ids"] = batch["seq_ids"]
    t_out, _ = causal_lm_forward(
        target_arch, target_inv_freq, params["target"], cache["target"], tbatch,
        attend_to_cache=True, kv_window=kv_window, layout=layout, gather_last_token=False,
        output_argmax_all=True, on_device_sampling=False,
        **_target_feature_kwargs(is_eagle3, aux_hidden_indices))
    return t_out


def eagle_chain_draft(draft_arch, draft_inv_freq, params, cache, batch, *, W: int,
                      kv_window: int, layout) -> torch.Tensor:
    """The chain's W draft steps from the window's start token and the
    buffered feature, each chaining its pre-norm hidden as the next
    feature: the candidates (B, W)."""
    B = batch["input_ids"].shape[0]
    step_batch = {"last_token_index": torch.zeros((B,), dtype=torch.int32,
                                                  device=batch["input_ids"].device),
                  "sampling_params": batch["sampling_params"]}
    if "seq_ids" in batch:
        step_batch["seq_ids"] = batch["seq_ids"]
    d_params = params["draft"]
    return _draft_steps(
        draft_arch, draft_inv_freq, d_params, cache["draft"], batch["input_ids"].to(torch.int32),
        batch["position_ids"].to(torch.int32), step_batch, W=W, kv_window=kv_window,
        d_lay=layout, feat=cache["features"][_feature_rows(batch, B)],
        map_token=functools.partial(_draft_token, d_params))


def eagle_token_gen(
    draft_arch,
    target_arch,
    draft_inv_freq,
    target_inv_freq,
    params: Dict[str, Any],
    cache: Dict[str, Any],
    batch: Dict[str, torch.Tensor],
    *,
    spec_len: int,
    kv_window: int,
    is_eagle3: bool = False,
    aux_hidden_indices: Optional[Tuple[int, ...]] = None,
    layout=DEFAULT_KV_LAYOUT,
    draft_layout=None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """One chain window. ``batch``: input_ids (B, 1), the last accepted
    token, at position_ids (B, 1). The draft's ``spec_len + 1`` steps chain
    their own hidden states as features; the verify refreshes the features
    buffer at the last retired index. Returns ``tokens`` (B, spec_len + 1),
    the target's greedy tokens, and ``counts`` (B,)."""
    B = batch["input_ids"].shape[0]
    pos0 = batch["position_ids"].to(torch.int32)
    W = spec_len + 1
    candidates = eagle_chain_draft(
        draft_arch, draft_inv_freq, params, cache, batch, W=W, kv_window=kv_window,
        layout=draft_layout if draft_layout is not None else layout)
    t_out = eagle_verify(
        target_arch, target_inv_freq, params, cache, batch, candidates,
        pos0 + torch.arange(W, dtype=torch.int32, device=pos0.device)[None, :],
        kv_window=kv_window, layout=layout, is_eagle3=is_eagle3,
        aux_hidden_indices=aux_hidden_indices)
    target_tokens = t_out["tokens"].to(torch.int32)  # (B, W)
    matches = (candidates[:, 1:] == target_tokens[:, :-1]).to(torch.int32)
    counts = torch.cumprod(matches, dim=1).sum(dim=1).to(torch.int32) + 1
    retire = _retire(counts, pos0, kv_window, W)
    _store_features(cache, _feature_rows(batch, B),
                    _retired_feature(draft_arch, params["draft"], t_out, is_eagle3, retire - 1))
    return {"tokens": target_tokens, "counts": counts}, cache


@functools.lru_cache(maxsize=None)
def _static_tree_plan(tree: TokenTree, device: str):
    """The static tree's draft passes, made once per device (outside any
    capture): per depth 1..D the node range (nodes are numbered by depth),
    and per depth 0..D-1 each child's parent row within that depth's pass
    and its top-k slot."""
    N, D = tree.num_nodes, tree.max_depth
    levels = []
    for d in range(1, D + 1):
        nodes = [i for i in range(N) if tree.node_depth[i] == d]
        if nodes != list(range(nodes[0], nodes[-1] + 1)):
            raise ValueError("a token tree's nodes must be numbered by depth")
        levels.append((nodes[0], nodes[-1] + 1))
    parent_row, child = [], []
    for d in range(D):
        lo, hi = levels[d]
        base = levels[d - 1][0] if d > 0 else None
        parent_row.append(torch.tensor(
            [0 if d == 0 else tree.node_parent[i] - base for i in range(lo, hi)],
            dtype=torch.long, device=device))
        child.append(torch.tensor([tree.node_child[i] for i in range(lo, hi)],
                                  dtype=torch.long, device=device))
    return levels, parent_row, child


def _draft_pass(draft_arch, draft_inv_freq, d_params, d_cache, batch, *, tokens, rope_pos,
                write_pos, mask, feats, kv_window, layout):
    """One masked draft pass over a tree's rows: logits and pre-norm hidden
    of every row; the rows' K/V land at ``write_pos`` through the commit
    kernel."""
    B = tokens.shape[0]
    dbatch = {"input_ids": tokens, "position_ids": rope_pos, "write_positions": write_pos,
              "attn_mask": mask, "prev_hidden": feats,
              "last_token_index": torch.zeros((B,), dtype=torch.int32, device=tokens.device),
              "sampling_params": batch["sampling_params"]}
    if "seq_ids" in batch:
        dbatch["seq_ids"] = batch["seq_ids"]
    out, _ = causal_lm_forward(
        draft_arch, draft_inv_freq, d_params, d_cache, dbatch, attend_to_cache=True,
        kv_window=kv_window, layout=layout, gather_last_token=False, output_logits=True,
        on_device_sampling=False, output_hidden=True)
    return out


def eagle_tree_draft(draft_arch, draft_inv_freq, params, cache, batch, *, tree: TokenTree,
                     kv_window: int, layout):
    """The static tree's draft, depth by depth: a depth-d node's token is the
    ``child``-th highest logit of its parent's draft row, and one masked
    pass runs all nodes of a depth, their K/V at the slots the verify
    gives them. Returns the candidates (B, 1 + N) in node order and the
    tree's mask (B, 1 + N, W)."""
    B = batch["input_ids"].shape[0]
    tok0 = batch["input_ids"].to(torch.int32)
    pos0 = batch["position_ids"].to(torch.int32)  # (B, 1)
    dev = tok0.device
    d_params = params["draft"]
    levels, parent_row, child = _static_tree_plan(tree, str(dev))
    full_mask = tree_verify_mask(tree, pos0[:, 0], kv_window)
    tokens = tok0
    feats = cache["features"][_feature_rows(batch, B)][:, None, :]
    node_tokens = []
    for d in range(tree.max_depth + 1):
        if d == 0:
            rope, write, mask = pos0, pos0, full_mask[:, 0:1]
        else:
            lo, hi = levels[d - 1]
            rope = (pos0 + d).expand(B, hi - lo)
            write = pos0 + 1 + torch.arange(lo, hi, dtype=torch.int32, device=dev)[None, :]
            mask = full_mask[:, 1 + lo:1 + hi]
        out = _draft_pass(draft_arch, draft_inv_freq, d_params, cache["draft"], batch,
                          tokens=tokens, rope_pos=rope, write_pos=write, mask=mask, feats=feats,
                          kv_window=kv_window, layout=layout)
        if d == tree.max_depth:
            break
        top = _top_k(out["logits"], tree.max_branch)[1]  # (B, rows of depth d, K)
        tokens = _draft_token(d_params, top[:, parent_row[d], child[d]])  # (B, kids)
        feats = out["hidden"][:, parent_row[d]]
        node_tokens.append(tokens)
    return torch.cat([tok0, *node_tokens], dim=1), full_mask


def _finish_tree(draft_arch, params, cache, batch, t_out, counts, path_slots, emit_rows, *,
                 depth: int, kv_window: int, layout, draft_layout, is_eagle3):
    """A tree window's tail: the accepted path's K/V moved from its tree
    slots ``path_slots`` (B, depth) to the contiguous slots after the root,
    on the target's and the draft's caches, and the features buffer set at
    the last retired row."""
    B = counts.shape[0]
    pos0 = batch["position_ids"].to(torch.int32)
    rows = _feature_rows(batch, B)
    dest = pos0 + 1 + torch.arange(depth, dtype=torch.int32, device=pos0.device)[None, :]
    move_path_rows(cache["target"], path_slots, dest, rows if layout.route_by_seq_id else None)
    move_path_rows(cache["draft"], path_slots, dest,
                   rows if draft_layout.route_by_seq_id else None)
    retire = _retire(counts, pos0, kv_window, depth + 1)
    last_row = torch.gather(emit_rows, 1, (retire - 1).long()[:, None])[:, 0]
    _store_features(cache, rows,
                    _retired_feature(draft_arch, params["draft"], t_out, is_eagle3, last_row))


def eagle_tree_token_gen(
    draft_arch,
    target_arch,
    draft_inv_freq,
    target_inv_freq,
    params: Dict[str, Any],
    cache: Dict[str, Any],
    batch: Dict[str, torch.Tensor],
    *,
    tree: TokenTree,
    kv_window: int,
    is_eagle3: bool = False,
    aux_hidden_indices: Optional[Tuple[int, ...]] = None,
    layout=DEFAULT_KV_LAYOUT,
    draft_layout=None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """One static-tree window: the draft (:func:`eagle_tree_draft`), one
    target pass scoring the tree, best-path acceptance, and the accepted
    path moved to contiguous slots on both caches. Returns ``tokens``
    (B, 1 + depth) and ``counts``."""
    pos0 = batch["position_ids"].to(torch.int32)
    d_lay = draft_layout if draft_layout is not None else layout
    N, D = tree.num_nodes, tree.max_depth
    candidates, full_mask = eagle_tree_draft(draft_arch, draft_inv_freq, params, cache, batch,
                                             tree=tree, kv_window=kv_window, layout=d_lay)
    t_out = eagle_verify(target_arch, target_inv_freq, params, cache, batch, candidates,
                         pos0 + tree_tensors(tree, pos0.device)["depth_row"][None, :],
                         mask=full_mask, kv_window=kv_window, layout=layout,
                         is_eagle3=is_eagle3, aux_hidden_indices=aux_hidden_indices)
    target_tokens = t_out["tokens"].to(torch.int32)
    counts, best_path, emit_rows = best_path_acceptance(tree, candidates, target_tokens)
    # near the window's edge some node writes fall past it and their rows
    # read a clipped mask: only the root's token is sound there
    counts = torch.where(pos0[:, 0] + 1 + N <= kv_window, counts, torch.ones_like(counts))
    tokens_out = torch.gather(target_tokens, 1, emit_rows)
    _finish_tree(draft_arch, params, cache, batch, t_out, counts,
                 pos0 + 1 + best_path.clamp(min=0), emit_rows, depth=D, kv_window=kv_window,
                 layout=layout, draft_layout=d_lay, is_eagle3=is_eagle3)
    return {"tokens": tokens_out, "counts": counts}, cache


@functools.lru_cache(maxsize=None)
def _dynamic_tree_consts(tree: DynamicTreeSpec, device: str):
    """The dynamic tree's constant tensors, made once per device: every
    row's depth, and each group's rows as one-hot columns (a node's own bit
    in its ancestor row)."""
    N1 = tree.num_nodes + 1
    depth_rows = torch.tensor(tree.depth_rows, dtype=torch.int32, device=device)
    cols = torch.arange(N1, device=device)
    self_bits = []
    for g in range(tree.steps):
        lo, n = tree.group_rows(g)
        self_bits.append(torch.arange(lo, lo + n, device=device)[:, None] == cols[None, :])
    return depth_rows, self_bits


def eagle_dynamic_tree_draft(draft_arch, draft_inv_freq, params, cache, batch, *,
                             tree: DynamicTreeSpec, kv_window: int, layout):
    """The dynamic tree's draft, grown from the draft's float32
    log-probabilities: step 0 takes the root's top ``branching_factor``
    tokens; each later step expands the ``num_inputs`` nodes of the previous
    step with the highest cumulative log-prob. Returns the candidates
    (B, 1 + N), each row's ancestor-or-self row (B, 1 + N, 1 + N) and each
    row's parent row (B, 1 + N; the root its own)."""
    B = batch["input_ids"].shape[0]
    tok0 = batch["input_ids"].to(torch.int32)
    pos0 = batch["position_ids"].to(torch.int32)  # (B, 1)
    dev = tok0.device
    d_params = params["draft"]
    K, M, steps = tree.branching_factor, tree.num_inputs, tree.steps
    N1 = tree.num_nodes + 1
    depth_rows, self_bits = _dynamic_tree_consts(tree, str(dev))
    feat0 = cache["features"][_feature_rows(batch, B)]
    H = feat0.shape[-1]
    tree_mask = torch.zeros((B, N1, N1), dtype=torch.bool, device=dev)
    tree_mask[:, 0, 0] = True

    def draft_pass(lo, n, tokens, feats):
        return _draft_pass(
            draft_arch, draft_inv_freq, d_params, cache["draft"], batch, tokens=tokens,
            rope_pos=pos0 + depth_rows[lo:lo + n][None, :],
            write_pos=pos0 + torch.arange(lo, lo + n, dtype=torch.int32, device=dev)[None, :],
            mask=dynamic_tree_kv_mask(tree_mask[:, lo:lo + n], pos0[:, 0], kv_window),
            feats=feats, kv_window=kv_window, layout=layout)

    # step 0: the root's row -> its top-K children
    out = draft_pass(0, 1, tok0, feat0[:, None, :])
    lp, ids = _top_k(_log_softmax(out["logits"][:, 0].float()), K)  # (B, K)
    g_lo, g_n = tree.group_rows(0)
    toks = _draft_token(d_params, ids)
    node_tok = [toks]
    parents = [torch.zeros((B, 1 + g_n), dtype=torch.long, device=dev)]  # the root, group 0
    tree_mask[:, g_lo:g_lo + g_n] = tree_mask[:, 0:1] | self_bits[0][None]
    prev_lo, prev_n, prev_lp = g_lo, g_n, lp
    prev_feats = out["hidden"][:, 0:1].expand(B, g_n, H)
    for step in range(1, steps + 1):
        out = draft_pass(prev_lo, prev_n, toks, prev_feats)
        if step == steps:
            break
        # expand the M most probable nodes of the previous group
        sel_lp, sel = _top_k(prev_lp, M)  # (B, M), indices within the group
        sel_logits = torch.gather(out["logits"], 1,
                                  sel[:, :, None].expand(B, M, out["logits"].shape[-1]))
        c_lp, c_ids = _top_k(_log_softmax(sel_logits.float()), K)  # (B, M, K)
        g_lo, g_n = tree.group_rows(step)
        toks = _draft_token(d_params, c_ids.reshape(B, M * K))
        par = (prev_lo + sel)[:, :, None].expand(B, M, K).reshape(B, M * K)
        tree_mask[:, g_lo:g_lo + g_n] = (
            torch.gather(tree_mask, 1, par[:, :, None].expand(B, M * K, N1)) | self_bits[step][None])
        node_tok.append(toks)
        parents.append(par)
        prev_feats = torch.gather(out["hidden"], 1, sel[:, :, None].expand(B, M, H))
        prev_feats = prev_feats[:, :, None].expand(B, M, K, H).reshape(B, M * K, H)
        prev_lo, prev_n = g_lo, g_n
        prev_lp = (sel_lp[:, :, None] + c_lp).reshape(B, M * K)
    return torch.cat([tok0, *node_tok], dim=1), tree_mask, torch.cat(parents, dim=1)


def eagle_dynamic_tree_token_gen(
    draft_arch,
    target_arch,
    draft_inv_freq,
    target_inv_freq,
    params: Dict[str, Any],
    cache: Dict[str, Any],
    batch: Dict[str, torch.Tensor],
    *,
    tree: DynamicTreeSpec,
    kv_window: int,
    is_eagle3: bool = False,
    aux_hidden_indices: Optional[Tuple[int, ...]] = None,
    layout=DEFAULT_KV_LAYOUT,
    draft_layout=None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """One dynamic-tree window: the draft (:func:`eagle_dynamic_tree_draft`),
    one verify of the tree under its ancestor mask, acceptance by a walk of
    parent pointers (device tensors throughout), the accepted path moved on
    both caches. Returns ``tokens`` (B, 1 + steps) and ``counts``."""
    B = batch["input_ids"].shape[0]
    pos0 = batch["position_ids"].to(torch.int32)  # (B, 1)
    dev = pos0.device
    d_lay = draft_layout if draft_layout is not None else layout
    steps, N1 = tree.steps, tree.num_nodes + 1
    depth_rows, _ = _dynamic_tree_consts(tree, str(dev))
    candidates, tree_mask, parent_full = eagle_dynamic_tree_draft(
        draft_arch, draft_inv_freq, params, cache, batch, tree=tree, kv_window=kv_window,
        layout=d_lay)
    t_out = eagle_verify(target_arch, target_inv_freq, params, cache, batch, candidates,
                         pos0 + depth_rows[None, :],
                         mask=dynamic_tree_kv_mask(tree_mask, pos0[:, 0], kv_window),
                         kv_window=kv_window, layout=layout, is_eagle3=is_eagle3,
                         aux_hidden_indices=aux_hidden_indices)
    target_tokens = t_out["tokens"].to(torch.int32)

    # acceptance: a row is on an accepted chain when its token is the
    # target's choice at its parent row and its parent is
    correct = candidates == torch.gather(target_tokens, 1, parent_full)
    chain_ok = torch.zeros((B, N1), dtype=torch.bool, device=dev)
    chain_ok[:, 0] = True
    for g in range(steps):
        lo, n = tree.group_rows(g)
        chain_ok[:, lo:lo + n] = correct[:, lo:lo + n] & torch.gather(
            chain_ok, 1, parent_full[:, lo:lo + n])
    lens = torch.where(chain_ok, depth_rows[None, :], torch.zeros_like(depth_rows)[None, :])
    best_row = torch.argmax(lens, dim=1)  # the first of the longest
    best_len = torch.gather(lens, 1, best_row[:, None])[:, 0]
    counts = torch.where(pos0[:, 0] + N1 <= kv_window, best_len + 1,
                         torch.ones_like(best_len)).to(torch.int32)
    # walk the parent pointers leaf -> root, placing each row at its depth
    path_rows = torch.zeros((B, steps), dtype=torch.long, device=dev)
    j = torch.arange(steps, device=dev)[None, :]
    r = best_row
    for _ in range(steps):
        d = depth_rows[r].long()
        path_rows = path_rows + (j == (d - 1)[:, None]).long() * r[:, None]
        r = torch.gather(parent_full, 1, r[:, None])[:, 0]
    emit_rows = torch.cat([torch.zeros((B, 1), dtype=torch.long, device=dev),
                           torch.where(j < best_len[:, None], path_rows,
                                       torch.zeros_like(path_rows))], dim=1)
    tokens_out = torch.gather(target_tokens, 1, emit_rows)
    _finish_tree(draft_arch, params, cache, batch, t_out, counts, pos0 + path_rows, emit_rows,
                 depth=steps, kv_window=kv_window, layout=layout, draft_layout=d_lay,
                 is_eagle3=is_eagle3)
    return {"tokens": tokens_out, "counts": counts}, cache


class EagleSpecWrapper(FusedSpecWrapper):
    """The EAGLE context-encoding and window submodels: one forward (a CUDA
    graph per bucket on the card) over both models' params, both caches and
    the features buffer. A tree window writes one KV slot per node plus the
    root, so its ``lookahead`` is ``num_nodes + 1``."""

    def __init__(self, *args, is_eagle3: bool = False, aux_hidden_indices=None, tree=None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.is_eagle3 = is_eagle3
        self.aux_hidden_indices = aux_hidden_indices
        self.tree = tree
        if tree is not None and self.attend_to_cache:
            self.lookahead = tree.num_nodes + 1

    def _call_forward(self, key, params, cache, dev):
        common = dict(is_eagle3=self.is_eagle3, aux_hidden_indices=self.aux_hidden_indices,
                      layout=self.layout, draft_layout=self.draft_layout)
        models = (self.draft_arch, self.arch, self.draft_inv_freq, self.inv_freq, params, cache,
                  dev)
        if not self.attend_to_cache:
            return eagle_context_encoding(*models, **common, **self.forward_kwargs)[0]
        if isinstance(self.tree, DynamicTreeSpec):
            return eagle_dynamic_tree_token_gen(*models, tree=self.tree, kv_window=key,
                                                **common)[0]
        if self.tree is not None:
            return eagle_tree_token_gen(*models, tree=self.tree, kv_window=key, **common)[0]
        return eagle_token_gen(*models, spec_len=self.spec_len, kv_window=key, **common)[0]

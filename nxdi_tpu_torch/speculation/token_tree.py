"""Token-tree speculation: the tree-attention verify of Medusa and EAGLE
(counterpart of ``nxdi_tpu/speculation/token_tree.py``).

A tree is given HF-medusa style as a list of paths, each a tuple of
per-depth child indices, e.g. ``[[0], [1], [0, 0], [0, 1], [1, 0], [0, 0, 0]]``:
node ``[0, 0]`` is head 2's top-1 continuation of head 1's top-1 proposal.

One verify forward scores the whole tree: node tokens come from the per-head
top-K proposal buffer; nodes share rope positions by depth but write
distinct KV slots (``write_positions``); attention takes an explicit
ancestor mask (``attn_mask``, models/base.py). After acceptance the best
path's K/V is moved from its tree slots into the contiguous positions the
next window expects (:func:`move_path_rows`, on every cache the tree wrote:
the target's, and an EAGLE draft's).

EAGLE's dynamic tree (:class:`DynamicTreeSpec`) fixes only the node count
per expansion step; its parents and ancestor rows are device tensors, laid
into KV-slot space by :func:`dynamic_tree_kv_mask`.

The functions take fixed shapes and read nothing back to the host, so a
verify window stays capturable in one CUDA graph. The tree's constant
tensors are made once per device (:func:`tree_tensors`), outside any
capture: the bucket's first, eager dispatch makes them.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from nxdi_tpu_torch.kvcache.kv_cache import raw
from nxdi_tpu_torch.ops.kernels import kv_commit


@dataclass(frozen=True)
class TokenTree:
    """Static tree structure (tuples, so a tree is hashable; built once)."""

    num_nodes: int
    max_depth: int
    max_branch: int
    node_depth: Tuple[int, ...]  # depth per node, 1-based (root prompt token = 0)
    node_head: Tuple[int, ...]  # which medusa head proposes this node (depth-1)
    node_child: Tuple[int, ...]  # which top-k slot of that head
    node_parent: Tuple[int, ...]  # node index of parent, -1 = root
    # every root-to-node path as node indices, padded with -1
    paths: Tuple[Tuple[int, ...], ...]  # (num_paths, max_depth)
    ancestors: Tuple[Tuple[bool, ...], ...]  # (N, N): [i][j] = j is ancestor-or-self of i

    @staticmethod
    def from_choices(choices: Sequence[Sequence[int]]) -> "TokenTree":
        """Build from the HF-medusa path list. Implicit parents are added
        (e.g. [0, 0] requires [0])."""
        node_set = set()
        for path in choices:
            for d in range(1, len(path) + 1):
                node_set.add(tuple(path[:d]))
        nodes: List[Tuple[int, ...]] = sorted(node_set, key=lambda p: (len(p), p))
        index = {p: i for i, p in enumerate(nodes)}
        N = len(nodes)
        depth = [len(p) for p in nodes]
        anc = [[False] * N for _ in range(N)]
        for i, p in enumerate(nodes):
            for d in range(1, len(p) + 1):
                anc[i][index[p[:d]]] = True
        max_depth = max(depth)
        paths = []
        for p in nodes:
            chain = [index[p[:d]] for d in range(1, len(p) + 1)]
            paths.append(tuple(chain + [-1] * (max_depth - len(chain))))
        return TokenTree(
            num_nodes=N,
            max_depth=max_depth,
            max_branch=max(p[-1] for p in nodes) + 1,
            node_depth=tuple(depth),
            node_head=tuple(len(p) - 1 for p in nodes),
            node_child=tuple(p[-1] for p in nodes),
            node_parent=tuple(index[p[:-1]] if len(p) > 1 else -1 for p in nodes),
            paths=tuple(paths),
            ancestors=tuple(tuple(r) for r in anc),
        )


@functools.lru_cache(maxsize=None)
def _tree_tensors(tree: TokenTree, device: str) -> Dict[str, torch.Tensor]:
    def t(x, dtype=torch.long):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return {
        "ancestors": t(tree.ancestors, torch.bool),  # (N, N)
        "node_head": t(tree.node_head),
        "node_child": t(tree.node_child),
        "parent_of_rows": t([p + 1 for p in tree.node_parent]),  # (N,) row of each parent
        "paths": t(tree.paths),  # (P, D)
        "depth_row": t([0, *tree.node_depth], torch.int32),  # (1 + N,)
    }


def tree_tensors(tree: TokenTree, device) -> Dict[str, torch.Tensor]:
    """The tree's constant tensors on ``device``, made once."""
    return _tree_tensors(tree, str(torch.device(device)))


def tree_verify_mask(tree: TokenTree, pos0: torch.Tensor, kv_width: int) -> torch.Tensor:
    """(B, 1 + N, kv_width) attention mask of the verify forward.

    Row 0 is the root (the last accepted token at position pos0): it attends
    the committed prefix (slots <= pos0). Row 1 + i is tree node i at slot
    pos0 + 1 + i: it attends the prefix, the root, and its ancestor nodes and
    itself."""
    B, N = pos0.shape[0], tree.num_nodes
    dev = pos0.device
    anc = tree_tensors(tree, dev)["ancestors"]
    slots = torch.arange(kv_width, dtype=torch.int32, device=dev)
    prefix = slots[None, :] <= pos0[:, None]  # (B, W)
    # node j sits at slot pos0 + 1 + j (clipped into the window); row i may
    # attend slot(j) iff anc[i, j]
    node_slot = (pos0[:, None] + 1 + torch.arange(N, dtype=torch.int32, device=dev)[None, :]
                 ).clamp(0, kv_width - 1)  # (B, N)
    at_slot = node_slot[:, :, None] == slots[None, None, :]  # (B, N_j, W)
    node_rows = (anc[None, :, :, None] & at_slot[:, None, :, :]).any(dim=2)  # (B, N_i, W)
    root = torch.zeros((B, 1, kv_width), dtype=torch.bool, device=dev)
    return prefix[:, None, :] | torch.cat([root, node_rows], dim=1)


def gather_tree_candidates(tree: TokenTree, tok0: torch.Tensor,
                           proposals: torch.Tensor) -> torch.Tensor:
    """tok0 (B, 1) + proposal buffer (B, num_heads, K) -> (B, 1 + N)
    candidates in node order."""
    tt = tree_tensors(tree, proposals.device)
    node_toks = proposals[:, tt["node_head"], tt["node_child"]]  # (B, N)
    return torch.cat([tok0.to(torch.int32), node_toks.to(torch.int32)], dim=1)


def best_path_acceptance(tree: TokenTree, candidates: torch.Tensor,
                         target_tokens: torch.Tensor):
    """Greedy tree acceptance.

    ``candidates`` (B, 1 + N) node tokens (row 0 the root); ``target_tokens``
    (B, 1 + N) the target's greedy token at each row. A node is correct if
    its token equals the target's greedy choice at its parent row. Returns
    (counts, best_path_nodes, emit_rows):

    - counts (B,): accepted nodes on the best path + 1 (the bonus token);
    - best_path_nodes (B, max_depth): the best path's node indices (-1 pad);
    - emit_rows (B, 1 + max_depth): the rows whose target tokens are emitted
      (the root, then the accepted path's nodes; 0 past them).

    The best path is the first of the longest (``argmax`` takes the first
    index, as ``jnp.argmax`` does)."""
    B, N, D = candidates.shape[0], tree.num_nodes, tree.max_depth
    tt = tree_tensors(tree, candidates.device)
    parent_tokens = torch.gather(target_tokens, 1, tt["parent_of_rows"][None, :].expand(B, N))
    correct = candidates[:, 1:] == parent_tokens  # (B, N)
    paths = tt["paths"]  # (P, D)
    valid = paths >= 0
    path_correct = correct[:, paths.clamp(min=0)] & valid[None]  # (B, P, D)
    accepted_len = torch.cumprod(path_correct.to(torch.int32), dim=2).sum(dim=2)  # (B, P)
    best = torch.argmax(accepted_len, dim=1)  # (B,)
    best_len = torch.gather(accepted_len, 1, best[:, None])[:, 0]
    best_path = paths[best]  # (B, D)
    counts = (best_len + 1).to(torch.int32)
    j = torch.arange(D, device=candidates.device)[None, :]
    path_rows = torch.where(j < best_len[:, None], best_path + 1, torch.zeros_like(best_path))
    emit_rows = torch.cat([torch.zeros((B, 1), dtype=torch.long, device=candidates.device),
                           path_rows], dim=1)
    return counts, best_path, emit_rows


def move_path_rows(cache: Dict[str, torch.Tensor], src: torch.Tensor, dest: torch.Tensor,
                   lines=None) -> None:
    """The best-path K/V move, in place: every layer's rows at slots ``src``
    (B, D) of each row's cache line are gathered (slots clipped into the
    cache) and landed at slots ``dest`` (B, D) by the commit kernel (its
    plain version on the CPU); rows whose ``dest`` lies past the cache drop,
    as the JAX package's ``mode="drop"`` scatter does. ``lines`` (B,): the
    cache line of each row (continuous batching), else row b is line b."""
    B, D = src.shape
    src = src.long().clamp(0, cache["k"].shape[3] - 1)
    moved = []
    for side in ("k", "v"):
        c = raw(cache[side])
        L, _, KV, _, Dh = c.shape
        on_lines = c if lines is None else c.index_select(1, lines)
        idx = src[None, :, None, :, None].expand(L, B, KV, D, Dh)
        moved.append(torch.gather(on_lines, 3, idx).view(cache[side].dtype))
    kv_commit.kv_commit_rows(cache["k"], cache["v"], *moved, dest, lines)


@dataclass(frozen=True)
class DynamicTreeSpec:
    """The static shape of a dynamic token tree (EAGLE): step 0 expands the
    root into ``branching_factor`` children; each later step picks the
    ``num_inputs`` most probable nodes of the previous step (by cumulative
    log-prob) and expands each into ``branching_factor`` children. Only the
    node count per step is static; parents, masks and slot wiring are
    device tensors chosen in the window."""

    steps: int  # tree depth (== speculation_length)
    branching_factor: int
    num_inputs: int

    @property
    def num_nodes(self) -> int:
        return self.branching_factor + (self.steps - 1) * self.num_inputs * self.branching_factor

    @property
    def max_depth(self) -> int:
        return self.steps

    def group_rows(self, g: int) -> Tuple[int, int]:
        """(start row, count) of expansion group ``g``: row 0 is the root and
        the groups follow it contiguously in creation order."""
        K, M = self.branching_factor, self.num_inputs
        if g == 0:
            return 1, K
        return 1 + K + (g - 1) * M * K, M * K

    @property
    def depth_rows(self) -> Tuple[int, ...]:
        """The depth of every row (the root 0, group g's rows g + 1)."""
        out = [0]
        for g in range(self.steps):
            out.extend([g + 1] * self.group_rows(g)[1])
        return tuple(out)


def dynamic_tree_kv_mask(mask_rows: torch.Tensor, pos0: torch.Tensor,
                         kv_width: int) -> torch.Tensor:
    """Ancestor rows (B, R, 1 + N) in row space -> (B, R, kv_width) in KV-slot
    space: a row attends the committed slots before the root's (< pos0) and
    tree row j at slot pos0 + j where its row allows (the dynamic
    counterpart of :func:`tree_verify_mask`). Slots past the window clip to
    its last slot, where the rows that land there OR together (the JAX
    package's scatter-max)."""
    dev = pos0.device
    N1 = mask_rows.shape[2]
    slots = torch.arange(kv_width, dtype=torch.int32, device=dev)
    prefix = slots[None, :] < pos0[:, None]  # (B, W)
    tgt = (pos0[:, None] + torch.arange(N1, dtype=torch.int32, device=dev)[None, :]
           ).clamp(0, kv_width - 1)  # (B, N1)
    at_slot = tgt[:, :, None] == slots[None, None, :]  # (B, N1, W)
    rows = (mask_rows[:, :, :, None] & at_slot[:, None, :, :]).any(dim=2)  # (B, R, W)
    return prefix[:, None, :] | rows

"""Seq-id routing of raw per-row state stacks (counterpart of
``nxdi_tpu/models/state_routing.py``).

The hybrid families (``models/lfm2``; recurrentgemma, qwen3_next and
falcon_h1 in the JAX package) keep recurrent state, such as LFM2's conv
tails, as plain ``(n_layers, B_cache, ...)`` tensors beside the KV cache.
Under continuous batching batch row ``i`` reads and writes cache line
``seq_ids[i]``:

- :func:`take_rows` gathers a layer's rows for the active batch before the
  layer runs; an id outside ``[0, B_cache)`` reads the nearest line (the
  JAX package's ``mode="clip"``);
- :func:`put_rows` writes the updated rows back into the stack, in place; a
  row whose id lies outside ``[0, B_cache)`` is dropped (``mode="drop"``).

Both run in torch at fixed shapes and read nothing back to the host, so a
CUDA graph captures a routed step. Padded batch lanes repeat row 0's line
with row 0's values, so their duplicate writes agree.
"""

from __future__ import annotations

from typing import Optional

import torch


def take_rows(state: torch.Tensor, seq_ids: Optional[torch.Tensor]) -> torch.Tensor:
    """The active batch's rows of one layer's ``(B_cache, ...)`` state."""
    if seq_ids is None:
        return state
    ids = seq_ids.reshape(-1).long().clamp(0, state.shape[0] - 1)
    return state.index_select(0, ids)


def put_rows(stack: torch.Tensor, layer_idx: int, rows: torch.Tensor,
             seq_ids: Optional[torch.Tensor]) -> torch.Tensor:
    """Write ``rows`` (B, ...) into layer ``layer_idx`` of the stacked
    ``(n_layers, B_cache, ...)`` state in place, row ``i`` at line
    ``seq_ids[i]``; returns the stack."""
    layer = stack[layer_idx]
    if seq_ids is None:
        layer.copy_(rows)
        return stack
    n = layer.shape[0]
    ids = seq_ids.reshape(-1).long()
    # a dropped row lands in one scratch line past the stack's, never read
    ids = torch.where((ids >= 0) & (ids < n), ids, torch.full_like(ids, n))
    padded = torch.cat([layer, layer[:1]])
    padded.index_copy_(0, ids, rows.to(layer.dtype))
    layer.copy_(padded[:n])
    return stack

"""Per-submodel dispatch: bucket selection, host-side padding, one forward.

Counterpart of ``nxdi_tpu/runtime/model_wrapper.py`` for the submodels of
the static generate path (``context_encoding_model``,
``token_generation_model``) and of the paged serving engine (the same two
plus ``prefix_prefill_model``, and ``mixed_model`` under mixed dispatch).
The JAX package compiles one program per
(submodel, bucket); PyTorch runs eagerly, so a bucket here only fixes the
padded shapes a dispatch runs at — the same shapes, chosen by the same
ladder, as the JAX package (one CUDA graph per (submodel, bucket) is a later
step).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from nxdi_tpu_torch.kvcache.kv_cache import BlockKVLayout, ContiguousKVLayout, scatter_indices
from nxdi_tpu_torch.models import base
from nxdi_tpu_torch.ops.kernels import ragged_paged_attention as rpa
from nxdi_tpu_torch.runtime import autobucketing
from nxdi_tpu_torch.runtime.padding import pad_with_first_batchline

TAG_CONTEXT_ENCODING = "context_encoding_model"
TAG_TOKEN_GENERATION = "token_generation_model"
TAG_MIXED = "mixed_model"


def kv_layout_from_config(tc):
    """The KV layout every submodel of this app runs against: the paged pool
    under ``is_block_kv_layout``, else the contiguous cache."""
    if tc.is_block_kv_layout:
        return BlockKVLayout(block_size=tc.pa_block_size)
    return ContiguousKVLayout()


def decode_window_limit(tpu_config, models) -> int:
    """Largest KV position the cache-attending submodels can serve: the top
    rung of every such ladder, and seq_len (the JAX package's rule, which
    counts the prefix-prefill ladder too). Ladders that are not KV windows
    (``window_buckets = False``: the mixed wrapper's packed-token ladder) say
    nothing about how much KV a forward attends and are left out."""
    tops = [w.buckets[-1] for w in models.values()
            if w.attend_to_cache and w.window_buckets]
    return min([tpu_config.seq_len, *tops])


class ModelWrapper:
    # the buckets are KV windows (see decode_window_limit)
    window_buckets = True

    def __init__(
        self,
        tag: str,
        config,
        arch: base.DecoderArch,
        inv_freq: np.ndarray,
        *,
        batch_size: int,
        n_active_tokens: int,
        buckets: Sequence[int],
        attend_to_cache: bool,
        device: torch.device,
        prefill_to_cache: bool = False,
        forward_kwargs: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.tag = tag
        self.config = config
        self.arch = arch
        self.device = torch.device(device)
        self.inv_freq = torch.as_tensor(np.asarray(inv_freq, dtype=np.float32), device=self.device)
        self.batch_size = batch_size
        self.n_active_tokens = n_active_tokens
        self.buckets = sorted(buckets)
        self.attend_to_cache = attend_to_cache
        # prefix-cached / chunked prefill: multi-token input bucketed on its
        # length like CTE that ALSO attends the cache (the chunk sees the
        # prefix through the block table)
        self.prefill_to_cache = prefill_to_cache
        self.forward_kwargs = dict(forward_kwargs or {})
        self.layout = kv_layout_from_config(config.tpu_config)
        # attention strategies each bucket actually ran (models/base.py trace)
        self.attention_strategies: Dict[int, tuple] = {}
        self.last_bucket: Optional[int] = None

    @property
    def decode_like(self) -> bool:
        return self.attend_to_cache and not self.prefill_to_cache

    def select_bucket(self, length: int) -> int:
        return autobucketing.get_target_bucket(length, self.buckets)

    def _block_table_width(self) -> int:
        return -(-self.config.tpu_config.seq_len // self.layout.block_size)

    def forward(self, params, cache, batch_np: Dict[str, np.ndarray]):
        """Pad host inputs to the target bucket's shape and run the forward.

        ``batch_np``: input_ids (b, s), position_ids (b, s), last_token_index
        (b,), sampling_params (b, 3), and on the paged pool block_table
        (b, nb); b may be smaller than the batch size. Returns (outputs,
        cache) with the batch padding rows dropped; the cache is updated in
        place."""
        input_ids = np.asarray(batch_np["input_ids"], dtype=np.int32)
        position_ids = np.asarray(batch_np["position_ids"], dtype=np.int32)
        b, s = input_ids.shape
        if self.decode_like:
            if s != self.n_active_tokens:
                raise ValueError(f"{self.tag}: expected {self.n_active_tokens} active tokens, got {s}")
            bucket = self.select_bucket(int(position_ids.max()) + 1)
            pad_s = s
        else:
            bucket = self.select_bucket(s)
            pad_s = bucket
        if pad_s > s:
            # right padding: pad positions continue the arange, so their
            # garbage KV lands at future positions that decode overwrites
            pad_ids = np.zeros((b, pad_s - s), dtype=np.int32)
            pad_pos = position_ids[:, -1:] + np.arange(1, pad_s - s + 1, dtype=np.int32)[None, :]
            input_ids = np.concatenate([input_ids, pad_ids], axis=1)
            position_ids = np.concatenate([position_ids, pad_pos], axis=1)
        last_token_index = np.asarray(
            batch_np.get("last_token_index", np.full((b,), s - 1)), dtype=np.int32
        )
        sampling_params = np.asarray(
            batch_np.get("sampling_params", np.tile([1.0, 1.0, 1.0], (b, 1))), dtype=np.float32
        )
        extra = self._layout_inputs(batch_np, b, position_ids)
        if b < self.batch_size:
            input_ids, position_ids, last_token_index, sampling_params = (
                pad_with_first_batchline(x, self.batch_size)
                for x in (input_ids, position_ids, last_token_index, sampling_params)
            )
            if "block_table" in extra:
                # padding rows read row 0's blocks but write nothing: the
                # scatter indices cover the first b rows only (duplicate
                # scatter indices are not idempotent under index_put unless
                # the rows compute identical K/V)
                extra["block_table"] = pad_with_first_batchline(
                    extra["block_table"], self.batch_size)
        elif b > self.batch_size:
            raise ValueError(f"{self.tag}: batch {b} exceeds compiled batch {self.batch_size}")
        dev = {
            "input_ids": input_ids,
            "position_ids": position_ids,
            "last_token_index": last_token_index,
            "sampling_params": sampling_params,
            **extra,
        }
        dev = {k: (torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v)
               .to(self.device) for k, v in dev.items()}
        base._STRATEGY_TRACE.clear()
        with torch.inference_mode():
            outputs, cache = base.causal_lm_forward(
                self.arch, self.inv_freq, params, cache, dev,
                attend_to_cache=self.attend_to_cache,
                kv_window=bucket if self.decode_like else None,
                layout=self.layout,
                **self.forward_kwargs,
            )
        self.attention_strategies[bucket] = tuple(dict.fromkeys(base._STRATEGY_TRACE))
        self.last_bucket = bucket
        return self._slice_batch_padding(outputs, b), cache

    def _layout_inputs(self, batch_np, b: int, position_ids) -> Dict[str, np.ndarray]:
        """The paged pool's inputs: the block table right-padded with -1
        (unallocated) entries to the full width, and the scatter indices of
        the slot mapping derived from the positions (position p writes slot
        bt[p // bs] * bs + p % bs; positions without a block write nothing;
        sequence padding continues the derivation like the JAX package)."""
        if not isinstance(self.layout, BlockKVLayout):
            return {}
        bs = self.layout.block_size
        width = self._block_table_width()
        bt = np.asarray(batch_np.get("block_table", np.zeros((b, width))), dtype=np.int32)
        if bt.shape[1] < width:
            bt = np.concatenate([bt, np.full((b, width - bt.shape[1]), -1, dtype=np.int32)], axis=1)
        blk = position_ids // bs
        entry = np.take_along_axis(bt, np.clip(blk, 0, width - 1), axis=1)
        sm = np.where((position_ids >= 0) & (blk < width) & (entry >= 0),
                      entry * bs + position_ids % bs, -1)
        return {"block_table": bt, **scatter_indices(sm)}

    @staticmethod
    def _slice_batch_padding(outputs, orig_b: int):
        return {k: v[:orig_b] for k, v in outputs.items()}

    def warmup_batches(self):
        """One dummy host batch per bucket. On the paged pool the batches
        carry hole-only block tables, so warmup writes nothing to the pool."""
        for bucket in self.buckets:
            seq = self.n_active_tokens if self.decode_like else bucket
            b = self.batch_size
            batch = {
                "input_ids": np.zeros((b, seq), dtype=np.int32),
                "position_ids": np.full((b, seq), bucket - 1, dtype=np.int32)
                if self.decode_like
                else np.tile(np.arange(seq, dtype=np.int32), (b, 1)),
                "last_token_index": np.zeros((b,), dtype=np.int32),
                "sampling_params": np.tile([1.0, 1.0, 1.0], (b, 1)).astype(np.float32),
            }
            if isinstance(self.layout, BlockKVLayout):
                batch["block_table"] = np.full((b, self._block_table_width()), -1, dtype=np.int32)
            yield batch


class MixedModelWrapper(ModelWrapper):
    """The ``mixed_model`` submodel: one forward serving a whole mixed
    prefill+decode step of the engine through the ragged paged-attention
    kernel.

    Shape contract (R = scheduler slots = tkg_batch_size, T = token bucket):

    - input_ids / position_ids (1, T): the packed token stream, prefill
      chunks and decode tokens concatenated, padded at the end;
    - ``mixed_row_ids`` (1, T): each token's slot, -1 for padding (pre-padded
      here with -1, never 0, which would tag padding as row 0);
    - ``slot_mapping`` (1, T): each token's pool slot, computed on the host
      through its own row's table; deriving it from positions would read the
      combined table and alias every row onto row 0's pages, so it is
      required. It becomes the scatter indices through
      :func:`scatter_indices`, like every paged write (negative slots drop);
    - ``block_table`` (1, R * Wt): the R per-row tables concatenated, idle
      rows all -1;
    - ``last_token_index`` (R,): the packed index of each row's newest token;
      ``sampling_params`` (R, 3); outputs lead with R and are not sliced;
    - ``ragged_plan``: on the card with the attention kernel on, the ragged
      kernels' work list (``ragged_plan``), built here once per dispatch
      from the host tags and handed to every layer, so no layer reads the
      tags back.

    Buckets count total packed tokens (``mixed_token_buckets``), not KV
    windows, so ``window_buckets`` is False."""

    window_buckets = False

    def __init__(self, *args, num_rows: int, **kwargs):
        super().__init__(*args, **kwargs)
        self.num_rows = num_rows

    def forward(self, params, cache, batch_np: Dict[str, np.ndarray]):
        if "slot_mapping" not in batch_np:
            raise ValueError(
                f"{self.tag}: mixed dispatch requires a host-computed slot_mapping "
                "(per token, through each row's own table)"
            )
        return super().forward(params, cache, batch_np)

    def _layout_inputs(self, batch_np, b: int, position_ids) -> Dict[str, np.ndarray]:
        pad_s = position_ids.shape[1]
        R, wt = self.num_rows, self._block_table_width()
        bt = np.asarray(batch_np.get("block_table", np.full((1, R * wt), -1)), dtype=np.int32)
        if bt.shape != (1, R * wt):
            raise ValueError(f"{self.tag}: block_table {bt.shape} is not (1, {R * wt})")

        def padded(key):
            x = np.asarray(batch_np[key], dtype=np.int32).reshape(1, -1)
            return np.concatenate([x, np.full((1, pad_s - x.shape[1]), -1, np.int32)], axis=1)

        rids = padded("mixed_row_ids")
        extra = {"block_table": bt, "mixed_row_ids": rids,
                 **scatter_indices(padded("slot_mapping"))}
        if self.device.type == "cuda" and self.arch.attn_kernel_enabled:
            extra["ragged_plan"] = rpa.ragged_plan(
                rids[0], position_ids[0], R, wt * self.layout.block_size, self.arch.num_kv_heads)
        return extra

    @staticmethod
    def _slice_batch_padding(outputs, orig_b: int):
        # the packed batch is always one row; outputs lead with the R slots
        return outputs

    def warmup_batches(self):
        """All -1 tags, slots and tables: warmup writes nothing and attends
        nothing."""
        R, wt = self.num_rows, self._block_table_width()
        for bucket in self.buckets:
            yield {
                "input_ids": np.zeros((1, bucket), dtype=np.int32),
                "position_ids": np.arange(bucket, dtype=np.int32)[None],
                "last_token_index": np.zeros((R,), dtype=np.int32),
                "sampling_params": np.tile([1.0, 1.0, 1.0], (R, 1)).astype(np.float32),
                "mixed_row_ids": np.full((1, bucket), -1, dtype=np.int32),
                "slot_mapping": np.full((1, bucket), -1, dtype=np.int32),
                "block_table": np.full((1, R * wt), -1, dtype=np.int32),
            }

"""Per-submodel dispatch: bucket selection, host-side padding, and one CUDA
graph per (submodel, bucket).

Counterpart of ``nxdi_tpu/runtime/model_wrapper.py`` for the submodels of
the static generate path (``context_encoding_model``,
``token_generation_model``) and of the paged serving engine (the same two
plus ``prefix_prefill_model``, and ``mixed_model`` under mixed dispatch).
The JAX package compiles one program per (submodel, bucket) and dispatches
to it; on the card the counterpart of a compiled program is a CUDA graph:

- ``forward`` pads the host inputs as the JAX package does (bucket choice,
  sequence and batch padding, the slot mapping as fixed-length scatter
  indices into the pool's drop block, the ragged work list padded to the
  bucket's capacity), writes them into a pinned host staging buffer, copies
  it to the bucket's static device inputs in one non-blocking H2D copy and
  replays the bucket's graph. Buckets whose inputs have equal shapes share
  one set of static inputs (every token-generation bucket does).
- A bucket's first dispatch runs the forward eagerly on its static inputs,
  so kernel attributes, TMA maps and library handles are set up outside any
  capture, and then captures it; ``warmup`` does that for every bucket.
- An app's graphs share one memory pool (its dispatches never overlap).
  A graph's outputs live in that pool, so the next replay of any graph may
  overwrite them: a caller that keeps outputs across a dispatch copies them.
- Each replay adds the launch counts its capture recorded to the kernel
  wrappers' ``launches``, and the attention strategies it recorded, so
  counts stay exact.
- A capture or replay that fails raises, naming the submodel and bucket;
  nothing falls back to eager.

On the CPU the same staging path runs and the forward is called on the
static inputs directly (no capture). ``graphs=False`` runs every dispatch
eagerly from fresh device inputs: for side-by-side runs and debugging.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from nxdi_tpu_torch.kvcache.kv_cache import (
    BlockKVLayout,
    ContiguousKVLayout,
    drop_slot,
    scatter_indices_fixed,
)
from nxdi_tpu_torch.models import base
from nxdi_tpu_torch.ops.kernels import launch_counters
from nxdi_tpu_torch.ops.kernels import ragged_paged_attention as rpa
from nxdi_tpu_torch.runtime import autobucketing
from nxdi_tpu_torch.runtime.host_spans import span
from nxdi_tpu_torch.runtime.padding import pad_with_first_batchline

TAG_CONTEXT_ENCODING = "context_encoding_model"
TAG_TOKEN_GENERATION = "token_generation_model"
TAG_MIXED = "mixed_model"

_TORCH_DTYPES = {np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
                 np.dtype(np.float32): torch.float32}


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


def count_launches(fn):
    """``(fn(), ((kernel wrapper, launches it counted), ...))`` with every
    wrapper's counter put back as it was: what a graph capture, which
    launches nothing, records for its replays (:func:`add_launches`)."""
    counters = launch_counters()
    before = [c.launches for c in counters]
    try:
        result = fn()
    finally:
        after = [c.launches for c in counters]
        for c, n in zip(counters, before):
            c.launches = n
    return result, tuple((c, a - n) for c, a, n in zip(counters, after, before) if a != n)


def add_launches(launches) -> None:
    """Count one replay's kernel launches (recorded by :func:`count_launches`)."""
    for fn, n in launches:
        fn.launches += n


class StaticInputs:
    """One set of static device inputs and the pinned host buffer they are
    staged from: every input a view of one flat buffer (16-byte aligned
    offsets), so a dispatch is one H2D copy. On the CPU the device buffer is
    the host buffer itself."""

    def __init__(self, specs: Dict[str, Tuple[tuple, np.dtype]], device: torch.device):
        self.cuda = device.type == "cuda"
        offsets, n = {}, 0
        for k, (shape, dt) in specs.items():
            nbytes = int(np.prod(shape, dtype=np.int64)) * np.dtype(dt).itemsize
            offsets[k] = (n, nbytes)
            n += -(-nbytes // 16) * 16
        self.host = torch.empty(max(n, 16), dtype=torch.uint8, pin_memory=self.cuda)
        self.device_buf = (torch.empty_like(self.host, device=device) if self.cuda
                           else self.host)
        host_np = self.host.numpy()
        self.host_views = {k: host_np[o:o + nb].view(specs[k][1]).reshape(specs[k][0])
                           for k, (o, nb) in offsets.items()}
        self.tensors = {
            k: self.device_buf[o:o + nb].view(_TORCH_DTYPES[np.dtype(specs[k][1])])
            .view(specs[k][0]) for k, (o, nb) in offsets.items()}
        self.nbytes = n
        # the last copy out of the host buffer: the next staging waits for it
        self._copied = torch.cuda.Event() if self.cuda else None

    def stage(self, host: Dict[str, np.ndarray]) -> None:
        """Write ``host`` (arrays of the static shapes) into the staging
        buffer and copy it to the device inputs (non-blocking)."""
        if self._copied is not None:
            self._copied.synchronize()
        for k, v in self.host_views.items():
            v[...] = host[k]
        if self.cuda:
            self.device_buf[:self.nbytes].copy_(self.host[:self.nbytes], non_blocking=True)
            self._copied.record()


@dataclasses.dataclass
class BucketGraph:
    """One bucket's CUDA graph, the static inputs it reads (``inputs``, the
    forward's view of them in ``bound``) and what its capture recorded."""

    inputs: StaticInputs
    bound: Dict[str, Any]
    graph: Optional[Any] = None
    outputs: Optional[Dict[str, Any]] = None
    launches: Tuple[Tuple[Any, int], ...] = ()  # (kernel wrapper, launches per replay)
    strategies: tuple = ()
    state: tuple = ()  # (params, cache pointer) the graph was captured over


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
        graphs: bool = True,
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
        # one CUDA graph per bucket (the staging path alone on the CPU)
        self.graphs = graphs
        self.graph_pool = None  # the app's shared pool handle
        self.bucket_graphs: Dict[int, BucketGraph] = {}
        self._input_sets: Dict[tuple, StaticInputs] = {}
        self.capture_s = 0.0  # seconds spent capturing

    @property
    def decode_like(self) -> bool:
        return self.attend_to_cache and not self.prefill_to_cache

    def select_bucket(self, length: int) -> int:
        return autobucketing.get_target_bucket(length, self.buckets)

    def _block_table_width(self) -> int:
        return -(-self.config.tpu_config.seq_len // self.layout.block_size)

    def forward(self, params, cache, batch_np: Dict[str, np.ndarray]):
        """Pad host inputs to the target bucket's shape and run the bucket
        (its graph on the card).

        ``batch_np``: input_ids (b, s), position_ids (b, s), last_token_index
        (b,), sampling_params (b, 3), and on the paged pool block_table
        (b, nb); b may be smaller than the batch size. Returns (outputs,
        cache) with the batch padding rows dropped; the cache is updated in
        place."""
        with span("pad_and_bucket"):
            bucket, b, host = self.host_inputs(batch_np)
        if self.graphs:
            if isinstance(host.get("ragged_plan"), rpa.RaggedPlan):
                # the graph's launch is sized for the bucket's largest plan
                with span("ragged_plan"):
                    host["ragged_plan"] = rpa.pad_plan(host["ragged_plan"],
                                                       self._ragged_capacity(bucket))
            bg = self._bucket_graph(bucket, host)
            with span("h2d"):
                bg.inputs.stage(host)
            with span("launch"):
                outputs = self._launch(bucket, bg, params, cache)
        else:
            with span("h2d"):
                dev = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                       if isinstance(v, np.ndarray) else v for k, v in host.items()}
            with span("launch"):
                outputs = self._run(bucket, params, cache, dev)
        return self._slice_batch_padding(outputs, b), cache

    def forward_device(self, params, cache, device_batch: Dict[str, torch.Tensor],
                       total_len: int):
        """The async decode loop's dispatch: inputs already on the device (a
        step's ``next_inputs``), the bucket from the host-tracked
        ``total_len``; nothing syncs. Inputs that are not the bucket's static
        inputs already are copied there on the device (the first step after
        the context encoding); a token-generation graph writes its
        ``next_inputs`` into its static inputs itself, so later steps copy
        nothing."""
        bucket = self.select_bucket(total_len)
        with span("launch"):
            if not self.graphs:
                return self._run(bucket, params, cache, dict(device_batch)), cache
            bg = self.bucket_graphs.get(bucket)
            if bg is None:
                bg = self._bucket_graph(bucket, self.host_inputs(self._dummy_batch(bucket))[2])
            for k, t in device_batch.items():
                dst = bg.bound[k]
                if t.data_ptr() != dst.data_ptr():
                    dst.copy_(t)
            return self._launch(bucket, bg, params, cache), cache

    def host_inputs(self, batch_np):
        """(bucket, b, host inputs padded to the bucket's shapes): the host
        half of a dispatch."""
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
        if b > self.batch_size:
            raise ValueError(f"{self.tag}: batch {b} exceeds compiled batch {self.batch_size}")
        extra = self._layout_inputs(batch_np, b, position_ids)
        if b < self.batch_size:
            input_ids, position_ids, last_token_index, sampling_params = (
                pad_with_first_batchline(x, self.batch_size)
                for x in (input_ids, position_ids, last_token_index, sampling_params)
            )
            if "block_table" in extra:
                # padding rows read row 0's blocks; their writes go to the
                # drop block (_layout_inputs gave them slot -1)
                extra["block_table"] = pad_with_first_batchline(
                    extra["block_table"], self.batch_size)
        host = {
            "input_ids": input_ids,
            "position_ids": position_ids,
            "last_token_index": last_token_index,
            "sampling_params": sampling_params,
            **extra,
        }
        return bucket, b, host

    def _bucket_graph(self, bucket: int, host) -> BucketGraph:
        """The bucket's graph record, made at its first dispatch: its static
        inputs (shared with every bucket of the same input shapes)."""
        bg = self.bucket_graphs.get(bucket)
        if bg is not None:
            return bg
        specs = {k: (v.shape, v.dtype) for k, v in host.items()}
        key = tuple((k, tuple(shape), str(dt)) for k, (shape, dt) in specs.items())
        inputs = self._input_sets.get(key)
        if inputs is None:
            inputs = self._input_sets[key] = StaticInputs(specs, self.device)
        bound = dict(inputs.tensors)
        if "ragged_plan" in bound:
            bound["ragged_plan"] = dataclasses.replace(
                self._ragged_capacity(bucket), flat=bound["ragged_plan"])
        bg = self.bucket_graphs[bucket] = BucketGraph(inputs=inputs, bound=bound)
        return bg

    def _run(self, bucket: int, params, cache, dev):
        """One eager forward of the bucket over device inputs ``dev``. A
        token-generation forward that emits ``next_inputs`` writes them into
        its own inputs (on the card: the static inputs every decode bucket
        shares), so the next step reads them where they are."""
        base._STRATEGY_TRACE.clear()
        with torch.inference_mode():
            outputs, _ = base.causal_lm_forward(
                self.arch, self.inv_freq, params, cache, dev,
                attend_to_cache=self.attend_to_cache,
                kv_window=bucket if self.decode_like else None,
                layout=self.layout,
                **self.forward_kwargs,
            )
            nxt = outputs.get("next_inputs")
            if nxt is not None and self.decode_like:
                for k, v in nxt.items():
                    if v is not dev[k]:
                        dev[k].copy_(v)
                outputs["next_inputs"] = {k: dev[k] for k in nxt}
        self.attention_strategies[bucket] = tuple(dict.fromkeys(base._STRATEGY_TRACE))
        self.last_bucket = bucket
        return outputs

    def _launch(self, bucket: int, bg: BucketGraph, params, cache):
        """Run the bucket over its static inputs: on the CPU directly; on the
        card its graph, captured after an eager run at its first dispatch."""
        if self.device.type != "cuda":
            return self._run(bucket, params, cache, bg.bound)
        state = (id(params), cache["k"].data_ptr(), cache["v"].data_ptr())
        if bg.graph is None:
            outputs = self._run(bucket, params, cache, bg.bound)
            self._capture(bucket, bg, params, cache)
            bg.state = state
            return outputs
        if state != bg.state:
            raise RuntimeError(f"{self.tag} bucket {bucket}: the CUDA graph was captured over "
                               "other params or another KV cache")
        try:
            bg.graph.replay()
        except Exception as e:
            raise RuntimeError(f"{self.tag} bucket {bucket}: CUDA graph replay failed: {e}") from e
        add_launches(bg.launches)
        self.attention_strategies[bucket] = bg.strategies
        self.last_bucket = bucket
        return bg.outputs

    def _capture(self, bucket: int, bg: BucketGraph, params, cache) -> None:
        """Capture the bucket's forward into a graph in the app's pool; record
        the kernel launches and strategies one replay stands for."""
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()

        def capture():
            with torch.cuda.graph(graph, pool=self.graph_pool):
                return self._run(bucket, params, cache, bg.bound)

        try:
            outputs, bg.launches = count_launches(capture)
        except Exception as e:
            raise RuntimeError(f"{self.tag} bucket {bucket}: CUDA graph capture failed: {e}") from e
        self.capture_s += time.perf_counter() - t0
        bg.graph, bg.outputs = graph, outputs
        bg.strategies = self.attention_strategies[bucket]

    def _layout_inputs(self, batch_np, b: int, position_ids) -> Dict[str, np.ndarray]:
        """The paged pool's inputs: the block table right-padded with -1
        (unallocated) entries to the full width, and the fixed-length scatter
        indices of the slot mapping derived from the positions (position p
        writes slot bt[p // bs] * bs + p % bs; positions without a block,
        and the batch padding rows, write the drop block; sequence padding
        continues the derivation like the JAX package)."""
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
        if b < self.batch_size:
            sm = np.concatenate([sm, np.full((self.batch_size - b, sm.shape[1]), -1, sm.dtype)])
        with span("scatter_indices"):
            return {"block_table": bt, **scatter_indices_fixed(sm, self._drop_slot())}

    def _drop_slot(self) -> int:
        return drop_slot(self.config.tpu_config.pa_num_blocks, self.layout.block_size)

    @staticmethod
    def _slice_batch_padding(outputs, orig_b: int):
        # the next step's inputs keep the whole compiled batch
        return {k: v if k == "next_inputs" else v[:orig_b] for k, v in outputs.items()}

    def _dummy_batch(self, bucket: int):
        """A host batch of the bucket's shapes. On the paged pool it carries a
        hole-only block table, so it writes nothing reachable."""
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
        return batch

    def warmup_batches(self):
        """One dummy host batch per bucket, the largest first (a graph pool's
        later captures reuse what the larger ones freed)."""
        for bucket in reversed(self.buckets):
            yield self._dummy_batch(bucket)


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
      required. It becomes the fixed-length scatter indices through
      :func:`scatter_indices_fixed`, like every paged write (negative slots
      write the drop block);
    - ``block_table`` (1, R * Wt): the R per-row tables concatenated, idle
      rows all -1;
    - ``last_token_index`` (R,): the packed index of each row's newest token;
      ``sampling_params`` (R, 3); outputs lead with R and are not sliced;
    - ``ragged_plan``: on the card with the attention kernel on, the ragged
      kernels' work list (``ragged_plan``), built here once per dispatch
      from the host tags and handed to every layer, so no layer reads the
      tags back; a bucket's graph holds launches sized for the bucket's
      largest list (``ragged_capacity``) and reads the list padded to it.

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
        with span("scatter_indices"):
            extra = {"block_table": bt, "mixed_row_ids": rids,
                     **scatter_indices_fixed(padded("slot_mapping"), self._drop_slot())}
        if self.device.type == "cuda" and self.arch.attn_kernel_enabled:
            with span("ragged_plan"):
                extra["ragged_plan"] = rpa.ragged_plan(
                    rids[0], position_ids[0], R, wt * self.layout.block_size,
                    self.arch.num_kv_heads)
        return extra

    def _ragged_capacity(self, bucket: int):
        return rpa.ragged_capacity(bucket, self.num_rows,
                                   self._block_table_width() * self.layout.block_size,
                                   self.arch.num_kv_heads)

    @staticmethod
    def _slice_batch_padding(outputs, orig_b: int):
        # the packed batch is always one row; outputs lead with the R slots
        return outputs

    def _dummy_batch(self, bucket: int):
        """All -1 tags, slots and tables: it writes nothing reachable and
        attends nothing."""
        R, wt = self.num_rows, self._block_table_width()
        return {
            "input_ids": np.zeros((1, bucket), dtype=np.int32),
            "position_ids": np.arange(bucket, dtype=np.int32)[None],
            "last_token_index": np.zeros((R,), dtype=np.int32),
            "sampling_params": np.tile([1.0, 1.0, 1.0], (R, 1)).astype(np.float32),
            "mixed_row_ids": np.full((1, bucket), -1, dtype=np.int32),
            "slot_mapping": np.full((1, bucket), -1, dtype=np.int32),
            "block_table": np.full((1, R * wt), -1, dtype=np.int32),
        }

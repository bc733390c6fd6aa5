"""Per-submodel dispatch: bucket selection, host-side padding, and one CUDA
graph per (submodel, bucket).

Counterpart of ``nxdi_tpu/runtime/model_wrapper.py`` for the submodels of
the static generate path (``context_encoding_model``,
``token_generation_model``), of the paged serving engine (the same two
plus ``prefix_prefill_model``, and ``mixed_model`` under mixed dispatch) and
of the device-resident decode family (``tkg_multistep``: one graph per
(step rung, bucket); ``tkg_device_loop``: one window graph per (cap rung,
bucket), see :class:`DeviceLoopTKGWrapper`) and of speculation
(``speculation_model``, the draft-model pair's verify;
``fused_speculation_model``, a whole draft + verify window;
``medusa_speculation_model``: ``nxdi_tpu_torch/speculation/``).
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

import contextlib
import ctypes
import gc
import dataclasses
import time
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nxdi_tpu_torch.config import to_torch_dtype
from nxdi_tpu_torch.kvcache.kv_cache import (
    BlockKVLayout,
    ContiguousKVLayout,
    WindowKVLayout,
    drop_slot,
    scatter_indices_fixed,
)
from nxdi_tpu_torch.lora.serving import lora_pointers
from nxdi_tpu_torch.models import base
from nxdi_tpu_torch.ops.kernels import _build, launch_counters
from nxdi_tpu_torch.ops.kernels import ragged_paged_attention as rpa
from nxdi_tpu_torch.runtime import autobucketing
from nxdi_tpu_torch.runtime.host_spans import span
from nxdi_tpu_torch.runtime.padding import pad_with_first_batchline

TAG_CONTEXT_ENCODING = "context_encoding_model"
TAG_TOKEN_GENERATION = "token_generation_model"
TAG_MIXED = "mixed_model"
TAG_TOKEN_GENERATION_MULTISTEP = "tkg_multistep"
TAG_DEVICE_LOOP = "tkg_device_loop"
TAG_SPECULATION = "speculation_model"
TAG_FUSED_SPECULATION = "fused_speculation_model"
TAG_MEDUSA_SPECULATION = "medusa_speculation_model"

#: EOS ids per row the K-step and loop submodels compare against (-1 = unused)
MULTISTEP_EOS_SLOTS = 8

_TORCH_DTYPES = {np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
                 np.dtype(np.float32): torch.float32, np.dtype(np.bool_): torch.bool}


@contextlib.contextmanager
def collector_paused():
    """Keep Python's garbage collector off until the block ends: around a
    CUDA graph capture, where a collection could free another app's graphs,
    whose destruction a capturing stream does not permit (the capture is
    then invalidated). What was garbage stays collectable after the block;
    torch's own capture collects first only when
    ``torch.compiler.config.force_cudagraph_gc`` is set."""
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was_enabled:
            gc.enable()


def rope_tables(inv_freq, device):
    """A family's frequency table(s) as float32 tensors on ``device``: one
    array, or a dict of them (MiMo-V2's per-type tables)."""
    if isinstance(inv_freq, dict):
        return {k: rope_tables(v, device) for k, v in inv_freq.items()}
    return torch.as_tensor(np.asarray(inv_freq, dtype=np.float32), device=device)


def kv_layout_from_config(tc, arch=None):
    """The KV layout every submodel of this app runs against: the paged pool
    under ``is_block_kv_layout``, else the contiguous cache (its lines routed
    by ``seq_ids`` under ``is_continuous_batching``). Under
    ``window_sized_kv`` a model whose every layer slides takes the ring
    (:class:`WindowKVLayout`), and an interleaved one keeps the contiguous
    primary layout (its window layers' ring stack takes its own, in
    ``models/base.run_decoder_layers``). A quantized cache's
    scales ride the layout: ``per_tensor`` as static floats, ``per_key`` /
    ``per_channel`` as per-layer tables checked against the model's shape
    (the JAX package's ``kv_layout_from_config``)."""
    kvq = tc.kv_quant_config
    scales = {}
    if kvq is not None and kvq.scale_mode == "per_tensor":
        scales = {"k_scale": kvq.k_scale, "v_scale": kvq.v_scale}
    elif kvq is not None and kvq.scale_mode in ("per_key", "per_channel"):
        if arch is not None and arch.mla is not None:
            # the JAX package sizes these tables for per-head K/V of one
            # width, which the latent cache (one head, two widths) is not
            raise NotImplementedError(
                f"kv quant scale_mode={kvq.scale_mode!r} on an MLA latent cache (one kv "
                "head, K and V of different widths) is not supported; use per_tensor "
                "or direct_cast")
        if arch is not None:
            want = ((arch.num_layers, arch.num_kv_heads) if kvq.scale_mode == "per_key"
                    else (arch.num_layers, arch.head_dim))
            for name, arr in (("k_scales", kvq.k_scales), ("v_scales", kvq.v_scales)):
                if tuple(arr.shape) != want:
                    raise ValueError(
                        f"kv quant {name} shape {tuple(arr.shape)} does not "
                        f"match this model's {kvq.scale_mode} shape {want} — "
                        "recalibrate (kvcache.calibration) for this model"
                    )
        scales = {
            "k_scales": tuple(map(tuple, kvq.k_scales.tolist())),
            "v_scales": tuple(map(tuple, kvq.v_scales.tolist())),
            "scale_axis": "key" if kvq.scale_mode == "per_key" else "channel",
        }
    if tc.is_block_kv_layout:
        return BlockKVLayout(block_size=tc.pa_block_size, **scales)
    if tc.window_sized_kv:
        if scales:
            raise NotImplementedError(
                "scaled fp8 KV is not wired into the window ring layout yet"
            )
        if arch is not None:
            pat = arch.kv_window_pattern
            if arch.sliding_window is None or (pat is not None and not any(pat)):
                raise ValueError(
                    "window_sized_kv is set but no layer of this model uses "
                    "sliding-window attention — a ring cache would silently "
                    "truncate full-attention history; unset window_sized_kv"
                )
            if tc.window_ring_slots < arch.sliding_window:
                raise ValueError(
                    f"window_sized_kv: a ring of {tc.window_ring_slots} slots is shorter than "
                    f"the model's sliding window ({arch.sliding_window}); set "
                    "tpu_config.sliding_window to the model's window")
            if arch.interleaved_split() is not None:
                return ContiguousKVLayout(route_by_seq_id=bool(tc.is_continuous_batching))
        return WindowKVLayout(window=tc.window_ring_slots,
                              route_by_seq_id=bool(tc.is_continuous_batching))
    return ContiguousKVLayout(route_by_seq_id=bool(tc.is_continuous_batching), **scales)


def decode_window_limit(tpu_config, models) -> int:
    """Largest KV position the cache-attending submodels can serve: the top
    rung of every such ladder, and seq_len (the JAX package's rule, which
    counts the prefix-prefill ladder too). Ladders that are not KV windows
    (``window_buckets = False``: the mixed wrapper's packed-token ladder) say
    nothing about how much KV a forward attends and are left out."""
    tops = [w.buckets[-1] for w in models.values()
            if w.attend_to_cache and w.window_buckets]
    return min([tpu_config.seq_len, *tops])


def cache_pointers(cache) -> tuple:
    """The addresses of every tensor of a (possibly nested) cache dict: a
    speculation app's ``{"draft": ..., "target": ...}`` caches, Medusa's
    proposal buffer. A graph replays only over the tensors it captured."""
    return tuple(cache_pointers(v) if isinstance(v, dict) else v.data_ptr()
                 for _, v in sorted(cache.items()))


def replay_state(params, cache) -> tuple:
    """What a graph was captured over and a replay must find unchanged: the
    params object, the LoRA buffers' addresses (adapter swaps write into
    them in place) and the cache's addresses."""
    return id(params), lora_pointers(params), cache_pointers(cache)


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
        self.inv_freq = rope_tables(inv_freq, self.device)
        # the submodel's forward: the decoder's, or a family's own layer walk
        # (MiMo-V2's two attention stacks, LFM2's conv / attention hybrid),
        # which its application sets on every wrapper
        self.forward_fn = base.causal_lm_forward
        self.batch_size = batch_size
        self.n_active_tokens = n_active_tokens
        self.buckets = sorted(buckets)
        self.attend_to_cache = attend_to_cache
        # prefix-cached / chunked prefill: multi-token input bucketed on its
        # length like CTE that ALSO attends the cache (the chunk sees the
        # prefix through the block table)
        self.prefill_to_cache = prefill_to_cache
        self.forward_kwargs = dict(forward_kwargs or {})
        self.layout = kv_layout_from_config(config.tpu_config, arch)
        # attention strategies each bucket actually ran (models/base.py trace)
        self.attention_strategies: Dict[int, tuple] = {}
        self.last_bucket: Optional[int] = None
        # one CUDA graph per bucket (the staging path alone on the CPU)
        self.graphs = graphs
        self.graph_pool = None  # the app's shared pool handle
        self.bucket_graphs: Dict[Any, BucketGraph] = {}  # by graph key (_bucket_of)
        self._input_sets: Dict[tuple, StaticInputs] = {}
        self.capture_s = 0.0  # seconds spent capturing
        # fixed-shape per-row inputs beyond the decoder contract: name ->
        # (shape without the batch dim, dtype, fill when the host omits it)
        self.extra_inputs: Dict[str, Tuple[tuple, Any, Any]] = {}
        if config.tpu_config.lora_config is not None:
            # each row's LoRA slot, staged with the inputs (0 = the base model)
            self.extra_inputs["adapter_ids"] = ((), np.int32, 0)
        # stochastic sampling reads a per-step key (2,) from its inputs
        self.needs_rng = bool(self.forward_kwargs.get("do_sample", False))
        # KV positions past the current length a dispatch may write (a
        # speculation window's), added to the length that picks the bucket
        self.lookahead = 0

    @property
    def decode_like(self) -> bool:
        return self.attend_to_cache and not self.prefill_to_cache

    def select_bucket(self, length: int) -> int:
        return autobucketing.get_target_bucket(length, self.buckets)

    @staticmethod
    def _bucket_of(key) -> int:
        """The KV bucket of a graph key. A key is what ``host_inputs`` chose
        for one dispatch: the bucket; the K-step and loop wrappers pair it
        with their rung, ``(rung, bucket)``."""
        return key

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
            key, b, host = self.host_inputs(batch_np)
        if self.graphs:
            if isinstance(host.get("ragged_plan"), rpa.RaggedPlan):
                # the graph's launch is sized for the bucket's largest plan
                with span("ragged_plan"):
                    host["ragged_plan"] = rpa.pad_plan(host["ragged_plan"],
                                                       self._ragged_capacity(key))
            bg = self._bucket_graph(key, host)
            with span("h2d"):
                bg.inputs.stage(host)
            with span("launch"):
                outputs = self._launch(key, bg, params, cache)
        else:
            with span("h2d"):
                dev = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                       if isinstance(v, np.ndarray) else v for k, v in host.items()}
            with span("launch"):
                outputs = self._run(key, params, cache, dev)
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
        return self._forward_device(self.select_bucket(total_len), params, cache, device_batch)

    def _forward_device(self, key, params, cache, device_batch: Dict[str, torch.Tensor]):
        with span("launch"):
            if not self.graphs:
                return self._run(key, params, cache, dict(device_batch)), cache
            bg = self.bucket_graphs.get(key)
            if bg is None:
                bg = self._bucket_graph(key, self.host_inputs(self._dummy_batch(key))[2])
            for k, t in device_batch.items():
                dst = bg.bound[k]
                if t.data_ptr() != dst.data_ptr():
                    dst.copy_(t)
            return self._launch(key, bg, params, cache), cache

    def host_inputs(self, batch_np, lookahead: Optional[int] = None):
        """(graph key, b, host inputs padded to the bucket's shapes): the host
        half of a dispatch. ``lookahead``: the KV positions past the current
        length this dispatch may write (a K-step window's, a loop's; the
        wrapper's own ``lookahead`` by default), added to the length that
        picks the bucket."""
        if lookahead is None:
            lookahead = self.lookahead
        input_ids = np.asarray(batch_np["input_ids"], dtype=np.int32)
        position_ids = np.asarray(batch_np["position_ids"], dtype=np.int32)
        b, s = input_ids.shape
        if self.decode_like:
            if s != self.n_active_tokens:
                raise ValueError(f"{self.tag}: expected {self.n_active_tokens} active tokens, got {s}")
            length = int(position_ids.max()) + 1
            # overflow must raise in select_bucket; only the lookahead of a
            # K-step window is clamped to the largest bucket (its writes past
            # the window drop and the host discards their tokens)
            if length <= self.buckets[-1]:
                length = min(length + lookahead, self.buckets[-1])
            bucket = self.select_bucket(length)
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
        rows = {}
        for key, (shape, dt, fill) in self.extra_inputs.items():
            val = batch_np.get(key)
            rows[key] = (np.full((b, *shape), fill, dtype=dt) if val is None
                         else np.asarray(val, dtype=dt).reshape((b, *shape)))
        if b < self.batch_size:
            input_ids, position_ids, last_token_index, sampling_params = (
                pad_with_first_batchline(x, self.batch_size)
                for x in (input_ids, position_ids, last_token_index, sampling_params)
            )
            # padding rows repeat row 0: its blocks (their writes go to the
            # drop block, _layout_inputs gave them slot -1), its cache line
            # (identical writes), its extra inputs
            for k in ("block_table", "seq_ids"):
                if k in extra:
                    extra[k] = pad_with_first_batchline(extra[k], self.batch_size)
            rows = {k: pad_with_first_batchline(v, self.batch_size) for k, v in rows.items()}
        host = {
            "input_ids": input_ids,
            "position_ids": position_ids,
            "last_token_index": last_token_index,
            "sampling_params": sampling_params,
            **extra,
            **rows,
        }
        if self.needs_rng:
            rng = batch_np.get("rng")
            host["rng"] = np.asarray(np.zeros(2) if rng is None else rng, dtype=np.int64)
        return bucket, b, host

    def _bucket_graph(self, key, host) -> BucketGraph:
        """The graph record of ``key``, made at its first dispatch: its static
        inputs (shared with every key of the same input shapes)."""
        bg = self.bucket_graphs.get(key)
        if bg is not None:
            return bg
        specs = {k: (v.shape, v.dtype) for k, v in host.items()}
        shapes = tuple((k, tuple(shape), str(dt)) for k, (shape, dt) in specs.items())
        inputs = self._input_sets.get(shapes)
        if inputs is None:
            inputs = self._input_sets[shapes] = StaticInputs(specs, self.device)
        bound = dict(inputs.tensors)
        if "ragged_plan" in bound:
            bound["ragged_plan"] = dataclasses.replace(
                self._ragged_capacity(key), flat=bound["ragged_plan"])
        bg = self.bucket_graphs[key] = BucketGraph(inputs=inputs, bound=bound)
        return bg

    def _call_forward(self, key, params, cache, dev):
        """The submodel's forward over device inputs ``dev`` (outputs only)."""
        return self.forward_fn(
            self.arch, self.inv_freq, params, cache, dev,
            attend_to_cache=self.attend_to_cache,
            kv_window=key if self.decode_like else None,
            layout=self.layout,
            **self.forward_kwargs,
        )[0]

    def _run(self, key, params, cache, dev):
        """One eager forward of the key's bucket over device inputs ``dev``. A
        token-generation forward that emits ``next_inputs`` writes them into
        its own inputs (on the card: the static inputs every decode bucket
        shares), so the next step reads them where they are."""
        bucket = self._bucket_of(key)
        base._STRATEGY_TRACE.clear()
        with torch.inference_mode():
            outputs = self._call_forward(key, params, cache, dev)
            nxt = outputs.get("next_inputs")
            if nxt is not None and self.decode_like:
                for k, v in nxt.items():
                    if v is not dev[k]:
                        dev[k].copy_(v)
                outputs["next_inputs"] = {k: dev[k] for k in nxt}
        self.attention_strategies[bucket] = tuple(dict.fromkeys(base._STRATEGY_TRACE))
        self.last_bucket = bucket
        return outputs

    def _launch(self, key, bg: BucketGraph, params, cache):
        """Run the key's graph over its static inputs: on the CPU the forward
        directly; on the card the graph, captured after an eager run at its
        first dispatch."""
        if self.device.type != "cuda":
            return self._run(key, params, cache, bg.bound)
        state = replay_state(params, cache)
        if bg.graph is None:
            outputs = self._run(key, params, cache, bg.bound)
            self._capture(key, bg, params, cache)
            bg.state = state
            return outputs
        if state != bg.state:
            raise RuntimeError(f"{self.tag} bucket {key}: the CUDA graph was captured over "
                               "other params, other LoRA buffers or another KV cache")
        try:
            bg.graph.replay()
        except Exception as e:
            raise RuntimeError(f"{self.tag} bucket {key}: CUDA graph replay failed: {e}") from e
        add_launches(bg.launches)
        bucket = self._bucket_of(key)
        self.attention_strategies[bucket] = bg.strategies
        self.last_bucket = bucket
        return bg.outputs

    def _capture(self, key, bg: BucketGraph, params, cache) -> None:
        """Capture the key's forward into a graph in the app's pool; record
        the kernel launches and strategies one replay stands for."""
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()

        def capture():
            with collector_paused(), torch.cuda.graph(graph, pool=self.graph_pool):
                return self._run(key, params, cache, bg.bound)

        try:
            outputs, bg.launches = count_launches(capture)
        except Exception as e:
            raise RuntimeError(f"{self.tag} bucket {key}: CUDA graph capture failed: {e}") from e
        self.capture_s += time.perf_counter() - t0
        bg.graph, bg.outputs = graph, outputs
        bg.strategies = self.attention_strategies[self._bucket_of(key)]

    def _layout_inputs(self, batch_np, b: int, position_ids) -> Dict[str, np.ndarray]:
        """The layout's inputs. Under continuous batching on the contiguous
        cache: ``seq_ids`` (b,), each row's cache line (default: its row),
        checked on the host to lie among the cache's lines. On the paged pool:
        the block table right-padded with -1
        (unallocated) entries to the full width, and the fixed-length scatter
        indices of the slot mapping derived from the positions (position p
        writes slot bt[p // bs] * bs + p % bs; positions without a block,
        and the batch padding rows, write the drop block; sequence padding
        continues the derivation like the JAX package)."""
        if not isinstance(self.layout, BlockKVLayout):
            if not self.layout.route_by_seq_id:
                return {}
            sids = np.asarray(batch_np.get("seq_ids", np.arange(b)), dtype=np.int32).reshape(b)
            tc = self.config.tpu_config
            lines = tc.kv_cache_batch_size + tc.kv_cache_padding_size
            if sids.min(initial=0) < 0 or sids.max(initial=0) >= lines:
                raise ValueError(f"{self.tag}: seq_ids must lie in [0, {lines}); got "
                                 f"{sids.tolist()}")
            return {"seq_ids": sids}
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
        # the next step's inputs keep the whole compiled batch; scalars (the
        # loop's iteration count) have no batch dim
        return {k: v if k == "next_inputs" or v.dim() == 0 else v[:orig_b]
                for k, v in outputs.items()}

    def _dummy_batch(self, bucket: int, lookahead: Optional[int] = None):
        """A host batch of the bucket's shapes (with ``lookahead``, by default
        the wrapper's, one whose positions plus the lookahead pick the
        bucket). On the paged pool it carries a hole-only block table, so it
        writes nothing reachable."""
        if lookahead is None:
            lookahead = self.lookahead
        seq = self.n_active_tokens if self.decode_like else bucket
        b = self.batch_size
        batch = {
            "input_ids": np.zeros((b, seq), dtype=np.int32),
            "position_ids": np.full((b, seq), max(bucket - 1 - lookahead, 0), dtype=np.int32)
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
                    self.arch.num_kv_heads, wgmma=self._ragged_wgmma())
        return extra

    def _ragged_wgmma(self) -> bool:
        """Whether the ragged kernel's one-row tiles are wgmma items: bf16 q
        over a one-byte pool (rpa.ragged_direct_body)."""
        arch = self.arch
        store = to_torch_dtype(arch.kv_quant_dtype or arch.dtype)
        return rpa.ragged_direct_body(to_torch_dtype(arch.dtype), store, arch.head_dim,
                                      self.layout.block_size) == "wgmma"

    def _ragged_capacity(self, bucket: int):
        return rpa.ragged_capacity(bucket, self.num_rows,
                                   self._block_table_width() * self.layout.block_size,
                                   self.arch.num_kv_heads, wgmma=self._ragged_wgmma())

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


def _pad_budget_rows(budget, b: int, batch_size: int) -> np.ndarray:
    """Per-row emission budgets padded to the compiled batch with ONES, not
    row 0's value: a padding lane repeats row 0's inputs, and under sampled
    decode its chain diverges from row 0's after its first draw (each row
    draws its own uniform); a budget of 1 freezes it after its first,
    identical write to row 0's line."""
    budget = np.zeros((b,), np.int32) if budget is None else np.asarray(budget, np.int32)
    return np.concatenate([budget.reshape(b), np.ones((batch_size - b,), np.int32)])


class _DecodeFamilyWrapper(ModelWrapper):
    """What the K-step and loop submodels share: the EOS slots, pad token and
    per-row budget inputs (``budget_steps``, <= 0 unlimited), the sampling
    forward kwargs, and graph keys ``(rung, bucket)``: the rung (K steps, a
    loop cap) is chosen per dispatch by ``host_inputs`` from the host
    batch."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.extra_inputs.update({
            "eos_token_ids": ((MULTISTEP_EOS_SLOTS,), np.int32, -1),
            "pad_token_id": ((), np.int32, 0),
        })

    @staticmethod
    def _bucket_of(key) -> int:
        return key[1]

    def _family_inputs(self, batch_np, rung: int, lookahead: int):
        bucket, b, host = super().host_inputs(batch_np, lookahead)
        host["budget_steps"] = _pad_budget_rows(batch_np.get("budget_steps"), b,
                                                self.batch_size)
        return (rung, bucket), b, host

    def _check_rung(self, rung, ladder: Sequence[int], name: str) -> int:
        if int(rung) not in ladder:
            raise ValueError(f"{self.tag}: {name} {rung} is not a rung ({list(ladder)})")
        return int(rung)

    def warmup_batches(self):
        # every (rung, bucket) pair is its own graph, the largest bucket first
        for rung in self.ladder:
            for bucket in reversed(self.buckets):
                yield self._dummy_batch((rung, bucket))


class MultiStepTKGWrapper(_DecodeFamilyWrapper):
    """The ``tkg_multistep`` submodel: one graph per (step rung, KV bucket),
    each running K chained decode steps (``models/base.py
    multi_step_token_gen``); a replay counts K times the 1-step launches.
    A lookahead of ``max_steps - 1`` widens the bucket choice so every
    in-window write stays inside the window. ``batch_np["decode_steps"]``
    picks the rung (the largest by default)."""

    def __init__(self, *args, steps_ladder: Sequence[int], **kwargs):
        super().__init__(*args, **kwargs)
        self.steps_ladder = self.ladder = sorted(steps_ladder)
        self.max_steps = self.steps_ladder[-1]

    def select_steps(self, remaining: Optional[int] = None) -> int:
        if remaining is None:
            return self.max_steps
        return autobucketing.get_target_steps(remaining, self.steps_ladder)

    def host_inputs(self, batch_np):
        steps = self._check_rung(batch_np.get("decode_steps", self.max_steps),
                                 self.steps_ladder, "decode_steps")
        return self._family_inputs(batch_np, steps, self.max_steps - 1)

    def forward_device(self, params, cache, device_batch, total_len: int,
                       steps: Optional[int] = None):
        """A window chained on the device from ``device_batch`` (the previous
        window's or the context encoding's ``next_inputs`` plus the EOS and
        pad inputs). It carries no budgets: the host trims overshoot, so the
        staged budgets are set to unlimited."""
        steps = self._check_rung(self.max_steps if steps is None else steps,
                                 self.steps_ladder, "decode_steps")
        if "budget_steps" not in device_batch:
            device_batch = dict(device_batch)
            device_batch["budget_steps"] = torch.zeros(
                (self.batch_size,), dtype=torch.int32, device=self.device)
        return self._forward_device((steps, self.select_bucket(total_len)), params, cache,
                                    device_batch)

    def _call_forward(self, key, params, cache, dev):
        steps, bucket = key
        return base.multi_step_token_gen(
            self.arch, self.inv_freq, params, cache, dev, num_steps=steps,
            kv_window=bucket, layout=self.layout, **self.forward_kwargs)[0]

    def _dummy_batch(self, key):
        steps, bucket = key
        batch = super()._dummy_batch(bucket, lookahead=self.max_steps - 1)
        batch["decode_steps"] = steps
        return batch


#: iterations per window graph of the device loop (each behind an IF node)
LOOP_WINDOW = 8


@dataclasses.dataclass
class LoopGraph:
    """A (cap, bucket) loop graph: the captured iteration (kept as a CUDA
    graph, never replayed itself), the instantiated window graph built around
    it (``csrc/loop_graph.cu``), and the per-window pinned token copies of
    the out-feed."""

    body: Any
    exec_ptr: ctypes.c_void_p
    window: int
    ring: List[Tuple[torch.Tensor, torch.Tensor]]


class DeviceLoopTKGWrapper(_DecodeFamilyWrapper):
    """The ``tkg_device_loop`` submodel: the decode loop with per-row EOS and
    budget exit (``models/base.py device_loop_token_gen``), one launch per
    batch-to-EOS. The cap ladder sizes the (B, cap) token buffer; the loop
    exits once every row is done, so a rung bounds the work and does not
    schedule it. The dispatcher picks the smallest cap covering the largest
    per-row budget, and the bucket covers each row's own reach.

    The card runs it as one graph per (cap, bucket): PyTorch captures one
    iteration (``device_loop_iteration``) as a graph, and the window graph
    holds W = min(cap, ``LOOP_WINDOW``) copies of it, each behind an IF
    node whose condition a one-block kernel sets from the loop state (t <
    cap and some row live), then a kernel that writes the loop's
    ``finished`` flag and t to pinned host memory. The loop state (t, done,
    the token buffer) is staged with the inputs, so the window reads and
    updates it in place. The host launches windows until it reads
    ``finished``, one window late (the window launched meanwhile skips every
    body), and reads ``loop_iters`` = t. A skipped IF body launches nothing,
    so the launch counts add one iteration's launches times ``loop_iters``.
    With the out-feed on (``device_loop_outfeed``), every window's token buffer
    and done history go to a pinned ring by an asynchronous copy, and
    :meth:`drain_outfeed` returns ``(t, tokens, done)`` in iteration order.
    On the CPU (and with ``graphs=False``) the loop runs eagerly."""

    def __init__(self, *args, cap_ladder: Sequence[int], outfeed_enabled: bool = False,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.cap_ladder = self.ladder = sorted(cap_ladder)
        self.max_cap = self.cap_ladder[-1]
        self.outfeed_enabled = bool(outfeed_enabled)
        self._outfeed: List[tuple] = []
        self._windows_run: List[int] = []  # windows of the last launch (graphs)
        self._last_key = None
        self.loop_graphs: Dict[Tuple[int, int], LoopGraph] = {}
        self._host_state = None  # pinned [finished, t] the window graph writes
        self.last_loop_iters = 0

    def select_cap(self, max_budget: int) -> int:
        return autobucketing.get_target_steps(max_budget, self.cap_ladder)

    def forward(self, params, cache, batch_np):
        self._outfeed = []
        out, cache = super().forward(params, cache, batch_np)
        self.last_loop_iters = int(out["loop_iters"])
        return out, cache

    def host_inputs(self, batch_np):
        """The cap (``batch_np["loop_cap"]``, else the smallest rung covering
        the largest budget; an unlimited (<= 0) budget asks for the whole
        ladder), the bucket covering each row's reach, and the loop state."""
        b = np.asarray(batch_np["input_ids"]).shape[0]
        real = np.asarray(batch_np.get("budget_steps", np.zeros((b,), np.int32)),
                          np.int32).reshape(b)
        cap = batch_np.get("loop_cap")
        if cap is None:
            max_ask = int(real.max(initial=0)) if (real > 0).all() and b else self.max_cap
            cap = self.select_cap(max_ask)
        cap = self._check_rung(cap, self.cap_ladder, "loop_cap")
        # each row reaches p_i + min(budget_i, cap): the bucket covers the
        # farthest; the base choice adds the lookahead to max(p) + 1
        pos = np.asarray(batch_np["position_ids"], dtype=np.int32)
        reach = pos.max(axis=1) + np.where(real > 0, np.minimum(real, cap), cap)
        lookahead = max(int(reach.max()) - (int(pos.max()) + 1), 0) if b else 0
        key, b, host = self._family_inputs(batch_np, cap, lookahead)
        state = base.device_loop_state({k: torch.from_numpy(host[k])
                                        for k in ("input_ids", "pad_token_id")}, cap)
        host.update({k: v.numpy() for k, v in state.items()})
        return key, b, host

    def _outfeed_tap(self, t, tokens, done) -> None:
        self._outfeed.append((int(t), tokens.cpu().numpy(), done.cpu().numpy()))

    def drain_outfeed(self) -> List[tuple]:
        """``(t, tokens (B,), done (B,))`` for every iteration of the last
        launch, in iteration order (empty with the out-feed off)."""
        if not self.outfeed_enabled:
            return []
        if self._windows_run:  # a window-graph launch: read its pinned ring
            torch.cuda.current_stream(self.device).synchronize()
            lg = self.loop_graphs[self._last_key]
            entries = []
            for j in self._windows_run:
                toks, hist = lg.ring[j]
                for t in range(j * lg.window, min((j + 1) * lg.window, self.last_loop_iters)):
                    entries.append((t, toks[:, t].numpy().copy(), hist[:, t].numpy().copy()))
            return entries
        return sorted(self._outfeed, key=lambda e: e[0])

    def _call_forward(self, key, params, cache, dev):
        cap, bucket = key
        return base.device_loop_token_gen(
            self.arch, self.inv_freq, params, cache, dev, max_steps=cap,
            kv_window=bucket, layout=self.layout,
            outfeed=self._outfeed_tap if self.outfeed_enabled else None,
            **self.forward_kwargs)[0]

    def _launch(self, key, bg: BucketGraph, params, cache):
        """The loop over the staged inputs: eager on the CPU; on the card the
        (cap, bucket) window graph, built after an eager run at the first
        dispatch."""
        if self.device.type != "cuda":
            return self._run(key, params, cache, bg.bound)
        cap, bucket = key
        state = replay_state(params, cache)
        lg = self.loop_graphs.get(key)
        if lg is None:
            outputs = self._run(key, params, cache, bg.bound)
            self._capture_loop(key, bg, params, cache)
            bg.state = state
            self._windows_run = []
            return outputs
        if state != bg.state:
            raise RuntimeError(f"{self.tag} {key}: the loop graph was captured over other "
                               "params, other LoRA buffers or another KV cache")
        self._last_key = key
        lib, stream = _build.library(), _build.stream_ptr(self.device)
        hs = self._host_state
        hs[0] = 0
        n_windows = -(-cap // lg.window)
        events = [torch.cuda.Event(), torch.cuda.Event()]
        self._windows_run = []
        for j in range(n_windows):
            _build.check(lib.nxdi_loop_window_launch(lg.exec_ptr, stream),
                         f"{self.tag} {key} window")
            self._windows_run.append(j)
            if self.outfeed_enabled:
                toks, hist = lg.ring[j]
                toks.copy_(bg.bound["loop_tokens"], non_blocking=True)
                hist.copy_(bg.bound["loop_done_hist"], non_blocking=True)
            events[j % 2].record()
            if j >= 1:  # the previous window's flag, read while this one runs
                events[(j - 1) % 2].synchronize()
                if hs[0]:
                    break
        events[(len(self._windows_run) - 1) % 2].synchronize()
        iters = int(hs[1])
        for fn, n in bg.launches:
            fn.launches += n * iters
        self.attention_strategies[bucket] = bg.strategies
        self.last_bucket = bucket
        return {"tokens": bg.bound["loop_tokens"], "loop_iters": torch.tensor(iters)}

    def _capture_loop(self, key, bg: BucketGraph, params, cache) -> None:
        """Capture one iteration over the staged loop state and build the
        window graph around it."""
        cap, bucket = key
        t0 = time.perf_counter()
        body = torch.cuda.CUDAGraph(keep_graph=True)
        fwd = dict(kv_window=bucket, layout=self.layout, **self.forward_kwargs)

        def capture():
            base._STRATEGY_TRACE.clear()
            with (collector_paused(), torch.inference_mode(),
                  torch.cuda.graph(body, pool=self.graph_pool)):
                base.device_loop_iteration(self.arch, self.inv_freq, params, cache, bg.bound,
                                           **fwd)

        try:
            _, bg.launches = count_launches(capture)
            if self._host_state is None:
                self._host_state = torch.zeros(2, dtype=torch.int32, pin_memory=True)
            window = min(cap, LOOP_WINDOW)
            exec_ptr = ctypes.c_void_p()
            _build.check(_build.library().nxdi_loop_window_build(
                ctypes.c_void_p(body.raw_cuda_graph()), window, bg.bound["loop_t"].data_ptr(),
                cap, bg.bound["loop_done"].data_ptr(), self.batch_size,
                self._host_state.data_ptr(), ctypes.byref(exec_ptr)), "nxdi_loop_window_build")
        except Exception as e:
            raise RuntimeError(f"{self.tag} {key}: loop graph capture failed: {e}") from e
        n_windows = -(-cap // window)
        ring = ([(torch.empty_like(bg.bound["loop_tokens"], device="cpu", pin_memory=True),
                  torch.empty_like(bg.bound["loop_done_hist"], device="cpu", pin_memory=True))
                 for _ in range(n_windows)] if self.outfeed_enabled else [])
        lg = self.loop_graphs[key] = LoopGraph(body=body, exec_ptr=exec_ptr, window=window,
                                               ring=ring)
        # the instantiated window graph is destroyed with its record
        weakref.finalize(lg, _build.library().nxdi_loop_window_destroy, exec_ptr)
        bg.strategies = tuple(dict.fromkeys(base._STRATEGY_TRACE))
        self.capture_s += time.perf_counter() - t0

    def _dummy_batch(self, key):
        # a budget of 1 ends the loop after one iteration
        cap, bucket = key
        batch = super()._dummy_batch(bucket)
        batch["loop_cap"] = cap
        batch["budget_steps"] = np.ones((batch["input_ids"].shape[0],), np.int32)
        return batch

"""Continuous-batching inference engine — the split- and mixed-dispatch
subset of ``nxdi_tpu/serving/engine.py`` over the paged KV pool, and its
contiguous continuous-batching path (``is_continuous_batching``: a slot is a
cache line, ``seq_ids`` routes each row to it).

``InferenceEngine.step()`` is one scheduler iteration. With split dispatch:

1. **Prefill** admitted requests into free slots: one context-encoding
   dispatch per request, or under ``chunked_prefill_config`` one
   ``chunk_size`` chunk per step, each chunk after the first (and every
   prefill that starts after a cached prefix) through the prefix-prefill
   submodel, interleaving with other slots' decodes.
2. **Decode** every running slot in ONE batched dispatch — rows carry their
   own positions and block tables (or cache lines), so a newly prefilled
   neighbor never disturbs an in-flight row. On the contiguous layout that
   dispatch may be a K-step window (``tkg_multistep``, the rung from
   :meth:`_choose_steps`) or one device-loop launch (``tkg_device_loop``,
   every row to its EOS, its budget or the ``device_loop_fence``), with
   per-row EOS and budget exit on the device.
3. **Retire** finished slots (EOS / length): blocks freed (full blocks enter
   the radix prefix cache when it is on), slot recycled.

With mixed dispatch (``mixed_dispatch=True``, the app's ``mixed_model``)
steps 1 and 2 are ONE forward: this step's prefill chunks and every decode
row packed into one token stream, served by the ragged paged-attention
kernel. Chunking is the packing policy — the part of a prompt that does not
fit the bucket budget continues next step — so neither chunked prefill nor
the prefix cache needs the prefix-prefill submodel.

Sampled decode: every dispatch takes the next key of one
:class:`StepRngSchedule` (``seed``); a K-step window of K steps and a
device-loop launch that ran N iterations drew K (N) keys and advance the
schedule by K - 1 (N - 1), so windows, the loop and 1-step dispatches draw
one stream. ``n > 1`` siblings sample apart (their
rows draw different uniforms).

Preemption: when the pool cannot grow a running decode, the scheduler
evicts a request back to WAITING (blocks freed); on re-admission the engine
re-prefills ``prompt + generated`` and the prefill's sampled token is simply
the next new token — token-exact under greedy sampling.

Disaggregation (``role``, the JAX package's KV handoff): a prefill-role
engine parks each request after its first token, keeping its block chain
until :meth:`ack_handoff`; :meth:`take_ready_handoffs` lists the newly
parked and :meth:`export_handoff` builds a request's
:class:`~nxdi_tpu_torch.serving.handoff.HandoffPayload`. A decode-role
engine takes requests only through :meth:`admit_handoff`, which places the
imported chain in its own pool and seats the request decoding. The counts
are plain attributes (``handoff_exports``, ``handoff_imports``,
``handoff_bytes``), like ``dispatches``.

Each finished request's ``metrics`` holds ``preemptions`` and, timed from
its ``arrival_s`` on ``time.perf_counter``, ``ttft_s`` (to the first token),
``e2e_s`` (to its finish) and ``tpot_s`` ((e2e - ttft) per token after the
first), the JAX package's definitions; ``serving/workload.py`` reads them.

Not ported yet: the host plane (telemetry spans, flight recorder, SLO and
QoS tracking, fault recovery, the router).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from nxdi_tpu_torch.kvcache.kv_cache import copy_kv_blocks, export_kv_blocks, import_kv_blocks
from nxdi_tpu_torch.ops.sampling import StepRngSchedule, extract_next_tokens
from nxdi_tpu_torch.runtime.application import TAG_PREFIX_PREFILL
from nxdi_tpu_torch.runtime.block_manager import BlockSpaceManager
from nxdi_tpu_torch.runtime.host_spans import span
from nxdi_tpu_torch.runtime.model_wrapper import (
    MULTISTEP_EOS_SLOTS,
    TAG_CONTEXT_ENCODING,
    TAG_DEVICE_LOOP,
    TAG_MIXED,
    TAG_TOKEN_GENERATION,
    TAG_TOKEN_GENERATION_MULTISTEP,
    decode_window_limit,
)
from nxdi_tpu_torch.serving.handoff import HandoffCapacityError, HandoffPayload, wire_dtype_name
from nxdi_tpu_torch.serving.prefix_cache import PrefixCache
from nxdi_tpu_torch.serving.request import RUNNING, Request, RequestOutput, SamplingParams
from nxdi_tpu_torch.serving.scheduler import Scheduler, SchedulerConfig

logger = logging.getLogger("nxdi_tpu_torch")


class InferenceEngine:
    """Host-side continuous-batching engine over a LOADED application, paged
    (``is_block_kv_layout``: a :class:`BlockSpaceManager` owns the pool,
    admission respects the free-block watermark, preemption on exhaustion)
    or contiguous with ``is_continuous_batching`` (slot = cache line,
    admission bounded by slots). Slots are decode batch rows.

    Single-driver: exactly one thread calls ``add_request``/``step``/``run``;
    the engine, its scheduler and the block manager own no locks."""

    def __init__(self, app, scheduler_config: Optional[SchedulerConfig] = None, seed: int = 0):
        if not getattr(app, "is_loaded", False):
            raise RuntimeError("InferenceEngine needs a loaded application")
        self.app = app
        tc = app.tpu_config
        self.tpu_config = tc
        if tc.on_device_sampling_config is None and not tc.output_logits:
            raise ValueError(
                "the engine needs token outputs: build the app with "
                "on_device_sampling_config (or output_logits=True for host argmax)"
            )
        self.paged = bool(tc.is_block_kv_layout)
        if not self.paged and not tc.is_continuous_batching:
            raise ValueError(
                "InferenceEngine drives the paged (is_block_kv_layout) or "
                "continuous-batching (is_continuous_batching) layouts; the static "
                "single-batch layout has no per-request cache routing — use "
                "HuggingFaceGenerationAdapter.generate instead"
            )
        # work on a copy: the resolved chunk_size below must not mutate a
        # caller-owned config (the Scheduler re-copies for the same reason)
        cfg = (
            dataclasses.replace(scheduler_config)
            if scheduler_config is not None
            else SchedulerConfig()
        )
        num_slots = cfg.num_slots if cfg.num_slots is not None else tc.tkg_batch_size
        if num_slots > tc.tkg_batch_size:
            raise ValueError(
                f"num_slots ({num_slots}) cannot exceed the compiled decode "
                f"batch (tkg_batch_size={tc.tkg_batch_size})"
            )
        if not self.paged:
            lines = tc.kv_cache_batch_size + tc.kv_cache_padding_size
            if num_slots > lines:
                raise ValueError(
                    f"num_slots ({num_slots}) cannot exceed the KV cache lines "
                    f"(kv_cache_batch_size + kv_cache_padding_size = {lines})")
        self.block_manager = (BlockSpaceManager(tc.pa_num_blocks, tc.pa_block_size)
                              if self.paged else None)
        self._can_continue_prefill = TAG_PREFIX_PREFILL in app.models
        # mixed dispatch: the whole step (prefill chunks + decode rows) is
        # ONE packed mixed_model forward; it continues prefills by itself
        self.mixed = app.mixed_supported
        self._mixed = app.models[TAG_MIXED] if self.mixed else None
        if cfg.chunk_size is None and tc.chunked_prefill_config is not None:
            cfg.chunk_size = tc.chunked_prefill_config.chunk_size
        if cfg.chunk_size is not None and not self._can_continue_prefill and not self.mixed:
            # without a continuation submodel every multi-chunk prompt would
            # error-finish at its second chunk
            raise ValueError(
                f"chunk_size ({cfg.chunk_size}) needs a prefix-prefill "
                "submodel to continue chunks; build the app with "
                "chunked_prefill_config (or is_prefix_caching)"
            )
        self.scheduler = Scheduler(num_slots, block_manager=self.block_manager, config=cfg)
        # radix prefix cache: retired sequences' full KV blocks enter a radix
        # tree; admissions fork the longest cached prefix and prefill only
        # the tail through the prefix-prefill submodel
        self.prefix_cache = None
        if cfg.prefix_cache:
            if not self.paged:
                raise ValueError("prefix_cache requires the paged KV layout "
                                 "(is_block_kv_layout=True)")
            if not self._can_continue_prefill and not self.mixed:
                raise ValueError(
                    "prefix_cache starts prefills at the cached position; "
                    "build the app with is_prefix_caching (or "
                    "chunked_prefill_config) for the prefix-prefill submodel, "
                    "or with mixed_dispatch"
                )
            self.prefix_cache = PrefixCache(self.block_manager)
            self.scheduler.prefix_cache = self.prefix_cache
        # n>1 sibling forks start their tail prefill mid-prompt too (on the
        # contiguous layout siblings simply prefill)
        self.scheduler.can_fork = self.paged and (self._can_continue_prefill or self.mixed)
        self.window_limit = decode_window_limit(tc, app.models)
        self._table_width = -(-tc.seq_len // tc.pa_block_size) if self.paged else 0
        self._rng = StepRngSchedule(seed)
        self._multistep = app.models.get(TAG_TOKEN_GENERATION_MULTISTEP)
        # the device loop serves every decode window it can (_use_device_loop)
        self._dloop = app.models.get(TAG_DEVICE_LOOP)
        #: forwards this engine dispatched, by submodel
        self.dispatches: Dict[str, int] = {tag: 0 for tag in app.models}
        #: decode steps the K-step windows ran (the sum of their rungs)
        self.multistep_steps = 0
        #: device-loop launches, the iterations they ran, the tokens they retired
        self.loop_launches = self.loop_iterations = self.loop_tokens = 0
        # prefill/decode disaggregation
        self.role = tc.role
        self._handoffs: Dict[int, Request] = {}  # parked for export, by request id
        self._handoff_ready: List[int] = []
        #: chains exported and imported, and the bytes they carried
        self.handoff_exports = self.handoff_imports = self.handoff_bytes = 0
        self._progress = False

    # -- request intake -----------------------------------------------------
    def add_request(
        self,
        prompt: Sequence[int],
        params: Optional[SamplingParams] = None,
        on_token=None,
        request_id: Optional[int] = None,
        arrival_s: Optional[float] = None,
    ) -> Request:
        """Queue a request (WAITING). ``on_token(request, token)`` streams
        every generated token as it is sampled. ``arrival_s`` backdates the
        arrival the finish metrics count from (``time.perf_counter``)."""
        if self.role == "decode":
            raise ValueError(
                "decode-role engine admits requests via KV handoff only "
                "(admit_handoff); route prompts to a prefill replica"
            )
        if params is not None and params.n > 1:
            # best-of-n: the primary prefills normally; each sibling forks
            # the parent's committed prompt blocks at admission and prefills
            # only the last prompt token, copy-on-writing the shared partial
            # block on its first write
            base = dataclasses.replace(params, n=1)
            primary = self.add_request(
                prompt, base, on_token=on_token, request_id=request_id, arrival_s=arrival_s,
            )
            for _ in range(params.n - 1):
                sib = self.add_request(prompt, base, on_token=on_token,
                                       arrival_s=primary.arrival_s)
                sib.fork_of = primary
                sib.fork_parent_id = primary.request_id
            return primary
        req = Request(prompt, params=params, request_id=request_id, on_token=on_token,
                      arrival_s=arrival_s)
        # ids key the block tables: two LIVE requests sharing one would
        # decode through the same blocks and double-free on retirement
        live_ids = {r.request_id for r in self.scheduler.waiting}
        live_ids.update(r.request_id for r in self.scheduler.running())
        if request_id is None:
            while req.request_id in live_ids:
                req.request_id = next(Request._ids)
        elif req.request_id in live_ids:
            raise ValueError(f"request_id {req.request_id} is already live in the engine")
        tc = self.tpu_config
        if len(req.prompt) >= self.window_limit:
            raise ValueError(
                f"prompt length {len(req.prompt)} leaves no decode room "
                f"inside the compiled window ({self.window_limit})"
            )
        if (len(req.prompt) > tc.max_context_length and self.scheduler.config.chunk_size is None
                and not self.mixed):
            # mixed dispatch chunks by itself: what does not fit the packed
            # bucket's budget continues next step
            raise ValueError(
                f"prompt length {len(req.prompt)} exceeds max_context_length "
                f"{tc.max_context_length} and chunked prefill is not "
                "configured (chunked_prefill_config)"
            )
        # clamp the budget to the window, like the static adapter's
        # max_length = min(max_length, seq_len) — parity demands one rule
        budget = self.window_limit - len(req.prompt)
        if req.params.max_new_tokens > budget:
            req.params = dataclasses.replace(req.params, max_new_tokens=budget)
        # reject up front what the pool can never hold even running alone
        bs = self.block_manager.block_size if self.paged else 1
        final = len(req.prompt) + req.params.max_new_tokens
        needed = -(-final // bs)
        if self.paged and needed > self.block_manager.num_blocks:
            raise ValueError(
                f"request needs {needed} KV blocks at its full length "
                f"({final} tokens) but the pool holds "
                f"{self.block_manager.num_blocks}; raise pa_num_blocks, "
                "shorten the prompt, or lower max_new_tokens"
            )
        self.scheduler.add(req)
        return req

    # -- the engine loop ----------------------------------------------------
    def has_work(self) -> bool:
        return self.scheduler.has_work()

    def step(self) -> List[RequestOutput]:
        """One engine iteration: prefill work, then one batched decode (or
        both in one mixed forward). Returns the requests that FINISHED during
        this step."""
        with span("engine.step"):
            return self._step()

    def _step(self) -> List[RequestOutput]:
        finished: List[RequestOutput] = []
        if self.mixed:
            self._step_mixed(finished)
            return finished
        if self.role == "decode" and self.scheduler.waiting:
            # a decode-role engine has no prefill submodel: a preempted
            # import cannot be replayed here, so it finishes with an error
            # (a router re-prefills it on a prefill replica)
            while self.scheduler.waiting:
                req = self.scheduler.waiting.popleft()
                req.error = "decode-role replica cannot re-prefill a preempted request"
                self._finish(req, "error", finished)
        prefills = self.scheduler.schedule_prefills()
        for req in prefills:
            self._prefill_chunk(req, finished)
        rows = self.scheduler.decodable()
        if self._handoffs and rows:
            # parked prefill-role requests hold their slot and chain for
            # export; they never join a decode batch
            rows = [(s, r) for s, r in rows if r.request_id not in self._handoffs]
        preempted: List[Request] = []
        if rows:
            rows, preempted = self.scheduler.ensure_decode_capacity(rows)
            for victim in preempted:
                logger.info("preempted request %d (recompute on re-admission)",
                            victim.request_id)
            rows = self._cow_decode_rows(rows)
        if rows:
            if self._use_device_loop(rows):
                self._decode_device_loop(rows, finished)
            else:
                steps = self._choose_steps(rows)
                if steps > 1:
                    self._decode_multistep(rows, steps, finished)
                else:
                    self._decode_single(rows, finished)
        # a preemption-only step still made progress (the freed blocks are
        # what lets the NEXT step admit)
        self._progress = bool(prefills) or bool(rows) or bool(preempted) or bool(finished)
        return finished

    def run(self, max_steps: Optional[int] = None) -> List[RequestOutput]:
        """Step until every queued request finishes; returns all outputs."""
        outputs: List[RequestOutput] = []
        n = 0
        while self.has_work():
            if max_steps is not None and n >= max_steps:
                break
            outputs.extend(self.step())
            n += 1
            if not self._progress and self.has_work():
                raise RuntimeError(
                    "scheduler stalled: requests waiting but nothing "
                    "admissible or decodable (KV pool too small for the "
                    "queued work?)"
                )
        return outputs

    def _forward(self, submodel: str, ids, pos, **kwargs):
        self.dispatches[submodel] += 1
        if self.app.models[submodel].needs_rng:
            kwargs["rng"] = self._rng.next()
        return self.app.forward(ids, pos, submodel=submodel, **kwargs)

    # -- copy-on-write ------------------------------------------------------
    def _cow_for_write(self, req: Request, lo: int, hi: int) -> None:
        """Before ``req`` writes KV for positions ``[lo, hi)``, give it a
        private copy of every SHARED block the range touches (refcount > 1:
        a prefix-cache chain or an ``n > 1`` fork still holds it). The
        manager swaps the table entry; the copy runs on the pool's stream,
        so it lands before the dispatch that writes the block."""
        mgr = self.block_manager
        if mgr is None or hi <= lo:
            return
        table = mgr._tables.get(req.request_id)
        if not table:
            return
        bs = mgr.block_size
        src: List[int] = []
        dst: List[int] = []
        for bi in range(lo // bs, min((hi - 1) // bs, len(table) - 1) + 1):
            if mgr._refs[table[bi]] > 1:
                s, d = mgr.cow_block(req.request_id, bi)
                src.append(s)
                dst.append(d)
        if src:
            copy_kv_blocks(self.app.kv_cache, src, dst, bs)
            if self.prefix_cache is not None:
                self.prefix_cache.note_cow(len(src))

    def _cow_decode_rows(self, rows: List[Tuple[int, Request]]) -> List[Tuple[int, Request]]:
        """COW each decode row's next write position. A row whose private
        copy cannot be allocated is preempted instead of faulting the step."""
        kept: List[Tuple[int, Request]] = []
        for slot, req in rows:
            try:
                self._cow_for_write(req, req.total_len - 1, req.total_len)
                kept.append((slot, req))
            except RuntimeError:
                logger.info("preempted request %d: no block for its COW copy", req.request_id)
                self.scheduler._preempt(req)
        return kept

    # -- prefill ------------------------------------------------------------
    def _prefill_chunk(self, req: Request, finished: List[RequestOutput]) -> None:
        seq = req.seq_tokens[: req.prefill_target]
        start = req.num_prefilled
        limit = self.scheduler.config.chunk_size or self.tpu_config.max_context_length
        if len(seq) > limit and not self._can_continue_prefill:
            # a preempted request's prompt+generated replay outgrew the one
            # prefill pass and nothing can continue it: fail THIS request
            logger.warning(
                "request %d cannot resume: its %d-token re-prefill exceeds "
                "max_context_length %d and no prefix-prefill submodel is built",
                req.request_id, len(seq), self.tpu_config.max_context_length,
            )
            self._finish(req, "error", finished)
            return
        chunk = seq[start: start + limit]
        n = len(chunk)
        try:
            self._cow_for_write(req, start, start + n)
        except RuntimeError:
            logger.info("preempted request %d: no block for its COW copy", req.request_id)
            self.scheduler._preempt(req)
            return
        submodel = TAG_CONTEXT_ENCODING if start == 0 else TAG_PREFIX_PREFILL
        out = self._forward(
            submodel,
            np.asarray([chunk], dtype=np.int32),
            (start + np.arange(n, dtype=np.int32))[None, :],
            last_token_index=np.array([n - 1], dtype=np.int32),
            sampling_params=req.params.tensor(1),
            **self._layout_kwargs([(req.slot, req)]),
        )
        req.num_prefilled += n
        if not req.prefill_done:
            return  # more chunks next step; decodes interleave meanwhile
        self.scheduler.note_prefill_complete(req)
        self._emit(req, int(extract_next_tokens(out)[0]), finished)
        if self.role == "prefill" and not req.is_finished:
            self._park_for_handoff(req)

    # -- KV handoff (prefill/decode disaggregation) -----------------------
    def _park_for_handoff(self, req: Request) -> None:
        """Prefill role: the first token is out; hold the request in its slot
        (blocks pinned, out of decode batches and victim selection) until
        its chain is exported and the import acknowledged."""
        self._handoffs[req.request_id] = req
        self._handoff_ready.append(req.request_id)
        self.scheduler.unpreemptible.add(req.request_id)

    def take_ready_handoffs(self) -> List[int]:
        """Request ids newly parked since the last call."""
        out, self._handoff_ready = self._handoff_ready, []
        return out

    def export_handoff(self, request_id: int) -> HandoffPayload:
        """The payload of a parked request: its committed chain's K/V rows on
        the host and what the decode side needs to continue. The chain stays
        parked, and may be exported again, until :meth:`ack_handoff`."""
        req = self._handoffs.get(request_id)
        if req is None:
            raise KeyError(f"request {request_id} is not parked for handoff")
        mgr = self.block_manager
        bs = mgr.block_size
        committed = req.prefill_target
        n_blocks = -(-committed // bs)
        table = mgr._tables.get(req.request_id, [])[:n_blocks]
        if len(table) < n_blocks:
            raise RuntimeError(
                f"parked request {request_id} holds {len(table)} blocks but "
                f"its committed prefill needs {n_blocks}"
            )
        kv = export_kv_blocks(self.app.kv_cache, table, bs)
        payload = HandoffPayload(
            request_id=req.request_id,
            prompt=list(req.prompt),
            first_tokens=list(req.generated),
            committed=committed,
            sampling=HandoffPayload.sampling_wire(req.params),
            rng_seed=self._rng.seed,
            rng_counter=self._rng.counter,
            block_size=bs,
            dtype=wire_dtype_name(kv["k"].dtype),
            kv=kv,
        )
        self.handoff_exports += 1
        self.handoff_bytes += payload.nbytes
        return payload

    def ack_handoff(self, request_id: int) -> None:
        """A decode engine imported the chain: retire the parked request (its
        committed blocks enter the prefix cache before the pool reclaims
        them) and recycle the slot."""
        req = self._handoffs.pop(request_id, None)
        if req is None:
            raise KeyError(f"request {request_id} is not parked for handoff")
        self.scheduler.unpreemptible.discard(request_id)
        self.scheduler.retire(req, "handoff")

    def admit_handoff(self, payload: HandoffPayload, on_token=None) -> Request:
        """Decode-side admission: check the payload against this pool's
        format, place the chain in the pool and seat the request RUNNING in
        decode — no local prefill runs. Raises ``ValueError`` on a format
        mismatch and :class:`HandoffCapacityError` when no slot or pool room
        is free now."""
        if not self.paged:
            raise ValueError("admit_handoff requires the paged KV layout")
        mgr = self.block_manager
        payload.validate_against(mgr.block_size, self.app.kv_cache["k"].dtype)
        sch = self.scheduler
        slot = sch._free_slot()
        if slot is None:
            raise HandoffCapacityError("no free engine slot for the import")
        params = payload.sampling_params()
        req = Request(payload.prompt, params=params, on_token=on_token)
        live_ids = {r.request_id for r in sch.waiting}
        live_ids.update(r.request_id for r in sch.running())
        req.request_id = payload.request_id
        while req.request_id in live_ids:
            req.request_id = next(Request._ids)
        if payload.committed + max(params.max_new_tokens, 1) > self.window_limit:
            # the budget clamp of add_request: one rule on both roles keeps
            # greedy parity with the unified engine
            budget = self.window_limit - payload.committed
            if budget < 1:
                raise ValueError(
                    f"imported chain ({payload.committed} committed tokens) "
                    f"leaves no decode room in the compiled window "
                    f"({self.window_limit})"
                )
            req.params = dataclasses.replace(req.params, max_new_tokens=budget)
        committed = payload.committed
        n_blocks = -(-committed // mgr.block_size)
        free = mgr.num_free_blocks()
        headroom = sch.config.watermark_blocks or 0
        if free - n_blocks < (headroom if sch.slots_busy else 0):
            raise HandoffCapacityError(
                f"pool pressure: import needs {n_blocks} blocks, "
                f"{free} free (watermark {headroom})"
            )
        try:
            table = mgr.ensure_capacity(req.request_id, committed)
        except RuntimeError as e:
            mgr.free_seq(req.request_id)
            raise HandoffCapacityError(str(e)) from e
        try:
            import_kv_blocks(self.app.kv_cache, table[:n_blocks], payload.kv, mgr.block_size)
        except Exception:
            mgr.free_seq(req.request_id)
            raise
        # the prefill side streamed these already: seed them without the
        # callback; the first token counts as delivered at the import
        req.generated = [int(t) for t in payload.first_tokens]
        req.first_token_s = time.perf_counter()
        sch.place_imported(req, slot, committed)
        self.handoff_imports += 1
        self.handoff_bytes += payload.nbytes
        return req

    # -- decode -------------------------------------------------------------
    def _layout_kwargs(self, rows: List[Tuple[int, Request]]) -> Dict[str, np.ndarray]:
        """Each row's block table, or on the contiguous layout its cache line
        (the slot)."""
        if not self.paged:
            return {"seq_ids": np.array([slot for slot, _ in rows], dtype=np.int32)}
        bt = np.stack([
            self.block_manager.block_table(r.request_id, self._table_width) for _, r in rows
        ])
        return {"block_table": bt}

    def _window_inputs(self, rows: List[Tuple[int, Request]]) -> Dict[str, np.ndarray]:
        """The inputs of a K-step window or a loop launch: each row's last
        token and position, sampling row, EOS slots and remaining budget."""
        B = len(rows)
        eos = np.full((B, MULTISTEP_EOS_SLOTS), -1, dtype=np.int32)
        for i, (_, r) in enumerate(rows):
            eos[i, : len(r.params.eos_token_ids)] = r.params.eos_token_ids
        return {
            "input_ids": np.array([[r.generated[-1]] for _, r in rows], dtype=np.int32),
            "position_ids": np.array([[r.total_len - 1] for _, r in rows], dtype=np.int32),
            "last_token_index": np.zeros((B,), dtype=np.int32),
            "sampling_params": SamplingParams.rows_tensor([r.params for _, r in rows]),
            "eos_token_ids": eos,
            "pad_token_id": np.zeros((B,), dtype=np.int32),
            "budget_steps": np.array([r.remaining for _, r in rows], dtype=np.int32),
            **self._layout_kwargs(rows),
        }

    def _emit_window(self, rows, toks: np.ndarray, limits, finished) -> int:
        """Emit up to ``limits[i]`` tokens of row i from a window's tokens,
        stopping at the row's finish (later columns are pad fill); returns
        the tokens emitted."""
        total = 0
        for i, (_, req) in enumerate(rows):
            for j in range(int(limits[i])):
                req.emit(int(toks[i, j]))
                total += 1
                reason = req.check_finish()
                if reason:
                    self._finish(req, reason, finished)
                    break
        return total

    def _choose_steps(self, rows: List[Tuple[int, Request]]) -> int:
        """The K-step rung for this window: the smallest rung that finishes
        every row, else the largest that keeps every row's last real write
        inside the decode window; 1 (the plain step) without the submodel,
        with more EOS ids than its slots, or with one token left per row.
        Rows near their budget ride along and freeze on the device."""
        if self._multistep is None:
            return 1
        if any(len(r.params.eos_token_ids) > MULTISTEP_EOS_SLOTS for _, r in rows):
            return 1
        max_rem = max(r.remaining for _, r in rows)
        if max_rem <= 1:
            return 1
        rungs = [s for s in self._multistep.steps_ladder
                 if all(r.total_len + min(r.remaining, s) <= self.window_limit + 1
                        for _, r in rows)]
        if not rungs:
            return 1
        covering = [s for s in rungs if s >= max_rem]
        return min(covering) if covering else max(rungs)

    def _decode_multistep(self, rows: List[Tuple[int, Request]], steps: int,
                          finished: List[RequestOutput]) -> None:
        batch = self._window_inputs(rows)
        batch["decode_steps"] = steps
        if self._multistep.needs_rng:
            batch["rng"] = self._rng.next()
        self.dispatches[TAG_TOKEN_GENERATION_MULTISTEP] += 1
        self.multistep_steps += steps
        out = self.app.token_gen_multistep(batch)
        with span("token_fetch"):
            toks = out["tokens"].cpu().numpy()
        if self._multistep.needs_rng and steps > 1:
            # step t of the window drew (seed, counter + t): land where
            # `steps` chained 1-step dispatches would have
            self._rng.advance(steps - 1)
        self._emit_window(rows, toks, [steps] * len(rows), finished)

    def _use_device_loop(self, rows: List[Tuple[int, Request]]) -> bool:
        """The loop serves this window when it is built, every row's EOS ids
        fit its slots, and some row has more than one token left."""
        if self._dloop is None:
            return False
        if any(len(r.params.eos_token_ids) > MULTISTEP_EOS_SLOTS for _, r in rows):
            return False
        return max(r.remaining for _, r in rows) > 1

    def _decode_device_loop(self, rows: List[Tuple[int, Request]],
                            finished: List[RequestOutput]) -> None:
        """ONE device-loop launch serves every row to its EOS, its budget or
        the fence (``device_loop_fence`` caps tokens per launch: admission,
        retirement and preemption get a scheduling point between launches)."""
        batch = self._window_inputs(rows)
        fence = self.tpu_config.device_loop_fence
        if fence:
            batch["budget_steps"] = np.minimum(batch["budget_steps"], fence)
        batch["loop_cap"] = self._dloop.select_cap(int(batch["budget_steps"].max()))
        if self._dloop.needs_rng:
            batch["rng"] = self._rng.next()
        self.dispatches[TAG_DEVICE_LOOP] += 1
        out = self.app.token_gen_device_loop(batch)
        iters = int(out["loop_iters"])
        with span("token_fetch"):
            toks = out["tokens"].cpu().numpy()
        if self._dloop.needs_rng and iters > 1:
            # iteration t drew (seed, counter + t): land where `iters` chained
            # 1-step dispatches would have
            self._rng.advance(iters - 1)
        self.loop_launches += 1
        self.loop_iterations += iters
        self.loop_tokens += self._emit_window(
            rows, toks, np.minimum(iters, batch["budget_steps"]), finished)

    def _decode_single(self, rows: List[Tuple[int, Request]],
                       finished: List[RequestOutput]) -> None:
        B = len(rows)
        out = self._forward(
            TAG_TOKEN_GENERATION,
            np.array([[r.generated[-1]] for _, r in rows], dtype=np.int32),
            np.array([[r.total_len - 1] for _, r in rows], dtype=np.int32),
            last_token_index=np.zeros((B,), dtype=np.int32),
            sampling_params=SamplingParams.rows_tensor([r.params for _, r in rows]),
            **self._layout_kwargs(rows),
        )
        for (_, req), tok in zip(rows, extract_next_tokens(out)):
            self._emit(req, int(tok), finished)

    # -- mixed dispatch -----------------------------------------------------
    def _step_mixed(self, finished: List[RequestOutput]) -> None:
        """One-dispatch mixed step: pack this step's prefill chunks and every
        decode row into ONE token stream and serve it with a single
        ``mixed_model`` forward. Prefill chunks come first, decode tokens
        after them, so slots do not ascend along the stream."""
        tc = self.tpu_config
        preempted: List[Request] = []
        prefills = self.scheduler.schedule_prefills()
        rows = self.scheduler.decodable()
        if rows:
            # grow every decode row's table BEFORE packing: a preemption
            # evicts its victim from THIS step's pack, never mid-dispatch.
            # The victim may be a request admitted just above — the state
            # filter below drops it from the pack.
            rows, preempted = self.scheduler.ensure_decode_capacity(rows)
            for victim in preempted:
                logger.info("preempted request %d (recompute on re-admission)",
                            victim.request_id)
            rows = self._cow_decode_rows(rows)
        prefills = [r for r in prefills if r.state == RUNNING]

        budget = self._mixed.buckets[-1] - len(rows)  # decode tokens ride along
        limit = self.scheduler.config.chunk_size or tc.max_context_length
        tokens: List[int] = []
        positions: List[int] = []
        row_ids: List[int] = []
        packed: List[Tuple[Request, int]] = []  # (request, chunk length)
        for req in prefills:
            room = min(limit, budget)
            if room <= 0:
                continue  # bucket full; this chunk continues next step
            start = req.num_prefilled
            chunk = req.seq_tokens[: req.prefill_target][start: start + room]
            if not chunk:
                continue
            try:
                self._cow_for_write(req, start, start + len(chunk))
            except RuntimeError:
                logger.info("preempted request %d: no block for its COW copy", req.request_id)
                self.scheduler._preempt(req)
                continue
            tokens.extend(chunk)
            positions.extend(range(start, start + len(chunk)))
            row_ids.extend([req.slot] * len(chunk))
            packed.append((req, len(chunk)))
            budget -= len(chunk)
        for slot, req in rows:
            tokens.append(req.generated[-1])
            positions.append(req.total_len - 1)
            row_ids.append(slot)

        self._progress = bool(packed) or bool(rows) or bool(preempted)
        if not tokens:
            return

        R, wt, bs = tc.tkg_batch_size, self._table_width, tc.pa_block_size
        bt = np.full((R, wt), -1, dtype=np.int32)
        lti = np.zeros((R,), dtype=np.int32)
        params_rows: List[SamplingParams] = [SamplingParams()] * R
        by_slot: Dict[int, Request] = {req.slot: req for req, _ in packed}
        by_slot.update({slot: req for slot, req in rows})
        for slot, req in by_slot.items():
            bt[slot] = self.block_manager.block_table(req.request_id, wt)
            params_rows[slot] = req.params
        sm = np.empty((len(tokens),), dtype=np.int32)
        for t, (slot, p) in enumerate(zip(row_ids, positions)):
            entry = int(bt[slot][p // bs])
            sm[t] = entry * bs + p % bs if entry >= 0 else -1
            lti[slot] = t  # a row's tokens are packed ascending: the last wins
        out = self._forward(
            TAG_MIXED,
            np.asarray(tokens, dtype=np.int32)[None, :],
            np.asarray(positions, dtype=np.int32)[None, :],
            last_token_index=lti,
            sampling_params=SamplingParams.rows_tensor(params_rows),
            block_table=bt.reshape(1, R * wt),
            slot_mapping=sm[None, :],
            mixed_row_ids=np.asarray(row_ids, dtype=np.int32)[None, :],
        )
        toks = extract_next_tokens(out)  # (R,): one per slot; idle rows garbage

        for req, n in packed:
            req.num_prefilled += n
            if not req.prefill_done:
                continue  # more chunks next step; decodes keep interleaving
            self.scheduler.note_prefill_complete(req)
            self._emit(req, int(toks[req.slot]), finished)
        for slot, req in rows:
            self._emit(req, int(toks[slot]), finished)

    def _emit(self, req: Request, token: int, finished: List[RequestOutput]) -> None:
        req.emit(token)
        reason = req.check_finish()
        if reason:
            self._finish(req, reason, finished)

    # -- retirement ---------------------------------------------------------
    def _finish(self, req: Request, reason: str, finished: List[RequestOutput]) -> None:
        self.scheduler.retire(req, reason)
        t_end = time.perf_counter()
        metrics: Dict[str, float] = {"preemptions": req.preemptions}
        if req.fork_parent_id is not None:
            # n>1 sibling: callers group continuations by the parent id
            metrics["parent_request_id"] = req.fork_parent_id
        # the JAX package's span metrics, from the request's arrival
        ttft = None if req.first_token_s is None else req.first_token_s - req.arrival_s
        metrics["ttft_s"] = ttft
        metrics["e2e_s"] = t_end - req.arrival_s
        n_dec = max(len(req.generated) - 1, 0)
        if n_dec and ttft is not None:
            metrics["tpot_s"] = (metrics["e2e_s"] - ttft) / n_dec
        finished.append(
            RequestOutput(
                request_id=req.request_id,
                prompt=list(req.prompt),
                token_ids=list(req.generated),
                finish_reason=reason,
                metrics=metrics,
                error=req.error,
            )
        )

    def preempt_youngest(self) -> Optional[Request]:
        """Force one recompute-style preemption (tests / demos)."""
        return self.scheduler.preempt_youngest()

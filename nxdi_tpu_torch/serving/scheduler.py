"""Slot scheduler for the continuous-batching engine — the port's copy of
``nxdi_tpu/serving/scheduler.py`` without the host plane's hooks (QoS
deadline scheduling, the flight recorder, telemetry gauges and the handoff
plane's pinned requests), none of which is ported yet.

Host-side bookkeeping only — no dispatches happen here. The scheduler owns

- the FCFS **waiting queue** (preempted requests re-enter at the FRONT so a
  victim resumes as soon as capacity returns),
- the **slot table**: one slot per row of the token-generation batch bucket
  (``tkg_batch_size``). On the paged layout a slot just names a decode
  batch row; the request's identity lives in its block table.
- the **paged-KV admission policy**: a request is admitted when a slot is
  free AND the pool keeps ``watermark_blocks`` free blocks after its
  (re)prefill allocation — the watermark is what guarantees running decodes
  can always grow a little before preemption kicks in (vLLM's watermark,
  block_manager semantics).
- **recompute-style preemption**: when a running decode cannot grow
  (pool exhausted even past the watermark), the YOUNGEST running request is
  evicted back to WAITING — its blocks are freed and the whole
  ``prompt + generated`` sequence re-prefills on re-admission (exact under
  greedy sampling; token parity is asserted in the integration tests).

Interleave policy (``SchedulerConfig.interleave``):

- ``"prefill_first"`` (default, continuous batching): admit up to
  ``max_prefills_per_step`` waiting requests every step, even while other
  slots decode — lowest TTFT, one prefill's latency added to that step's
  decode (the classic in-flight batching tradeoff).
- ``"decode_first"``: only admit when nothing is decodable — drains the
  running batch before taking new work (batch-oriented; better TPOT, worse
  TTFT).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, List, Optional, Tuple

from nxdi_tpu_torch.serving.request import (
    FINISHED,
    PREEMPTED,
    RUNNING,
    WAITING,
    Request,
)

INTERLEAVE_POLICIES = ("prefill_first", "decode_first")
PREEMPT_POLICIES = ("cheapest_recompute", "youngest")


@dataclass
class SchedulerConfig:
    #: engine slots; None = the app's tkg_batch_size
    num_slots: Optional[int] = None
    #: free blocks the paged pool must retain after an admission; None =
    #: max(1, num_blocks // 100) (vLLM's 1% watermark, floored at one block)
    watermark_blocks: Optional[int] = None
    max_prefills_per_step: int = 1
    interleave: str = "prefill_first"
    #: prompt tokens prefilled per step; None = whole prompt in one dispatch
    #: (set from chunked_prefill_config.chunk_size by the engine)
    chunk_size: Optional[int] = None
    #: radix prefix cache (serving/prefix_cache.py): retired sequences'
    #: full KV blocks enter a radix tree and later admissions fork the
    #: longest cached prefix instead of re-prefilling it. Paged layout
    #: only, and the engine must be able to continue a prefill from a
    #: nonzero position (the prefix-prefill submodel).
    prefix_cache: bool = False
    #: with ``prefix_cache``: admit the waiting request with the LONGEST
    #: cached prefix first (FCFS on ties) instead of strict FCFS — a warm
    #: request costs a fraction of a cold prefill, so serving it first
    #: raises goodput without starving anyone (see ``max_queue_age_s``)
    cache_aware_admission: bool = True
    #: starvation bound for cache-aware admission: once the queue HEAD has
    #: waited this long, admission reverts to strict FCFS until it lands
    max_queue_age_s: float = 2.0
    #: waiting-queue positions the cache-aware scan inspects (bounds the
    #: per-step host cost under deep queues; FCFS beyond the window)
    admission_scan_limit: int = 64
    #: preemption victim selection. ``"cheapest_recompute"`` (default):
    #: among RUNNING requests, evict the one whose ``prompt + generated``
    #: replay is longest-prefix-covered by the prefix cache (its recompute
    #: re-forks cached blocks, so eviction costs the least), youngest-first
    #: on coverage ties (FCFS: the oldest admitted keeps running). Without
    #: a prefix cache every coverage is zero and the tie-break IS
    #: youngest-first. ``"youngest"`` opts out of the cache probe entirely.
    preempt_policy: str = "cheapest_recompute"

    def __post_init__(self):
        if self.interleave not in INTERLEAVE_POLICIES:
            raise ValueError(
                f"interleave must be one of {INTERLEAVE_POLICIES}, "
                f"got {self.interleave!r}"
            )
        if self.preempt_policy not in PREEMPT_POLICIES:
            raise ValueError(
                f"preempt_policy must be one of {PREEMPT_POLICIES}, "
                f"got {self.preempt_policy!r}"
            )
        if self.max_prefills_per_step < 1:
            raise ValueError("max_prefills_per_step must be >= 1")
        if self.max_queue_age_s <= 0:
            raise ValueError("max_queue_age_s must be > 0")
        if self.admission_scan_limit < 1:
            raise ValueError("admission_scan_limit must be >= 1")


class Scheduler:
    """Slot/admission/preemption bookkeeping over an optional
    :class:`~nxdi_tpu_torch.runtime.block_manager.BlockSpaceManager` (paged
    layout) — with ``block_manager=None`` admission is slot-bounded only and
    growth never fails.

    Lock-free by ownership: queue/slot state is touched only by the
    engine's single driver thread."""

    def __init__(
        self,
        num_slots: int,
        block_manager=None,
        config: Optional[SchedulerConfig] = None,
    ):
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        # private copy: derived values (watermark default, engine-resolved
        # chunk_size) must not leak into a caller-owned config reused for
        # another engine over a differently-sized pool
        self.config = (
            dataclasses.replace(config) if config is not None else SchedulerConfig()
        )
        self.num_slots = num_slots
        self.block_manager = block_manager
        # serving/prefix_cache.PrefixCache, attached by the owning engine
        # when config.prefix_cache is on: admission forks cached chains,
        # retirement/preemption insert retired full blocks into the tree
        self.prefix_cache = None
        # set by the engine when a fork's tail prefill can actually start
        # mid-prompt (prefix-prefill submodel compiled); without it n>1
        # siblings fall back to full prefills
        self.can_fork = False
        self.waiting: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * num_slots
        self._admit_counter = 0
        # request ids no preemption may evict: a prefill-role engine's parked
        # requests, whose chains wait for their handoff
        self.unpreemptible: set = set()
        if block_manager is not None and self.config.watermark_blocks is None:
            self.config.watermark_blocks = max(1, block_manager.num_blocks // 100)

    # -- views --------------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return len(self.waiting)

    @property
    def slots_busy(self) -> int:
        return sum(1 for r in self.slots if r is not None)

    def running(self) -> List[Request]:
        return [r for r in self.slots if r is not None]

    def decodable(self) -> List[Tuple[int, Request]]:
        """(slot, request) rows ready for a batched decode step: prefill
        complete (first token already sampled) and not finished."""
        return [
            (i, r)
            for i, r in enumerate(self.slots)
            if r is not None and r.prefill_done and not r.is_finished
        ]

    def has_work(self) -> bool:
        return bool(self.waiting) or self.slots_busy > 0

    # -- block math ---------------------------------------------------------
    def _blocks_needed(self, req: Request, num_tokens: int) -> int:
        mgr = self.block_manager
        return mgr.blocks_needed(req.request_id, num_tokens)

    def _admissible(self, req: Request) -> bool:
        mgr = self.block_manager
        if mgr is None:
            return True
        needed = self._blocks_needed(req, len(req.seq_tokens))
        if needed > mgr.num_blocks:
            raise RuntimeError(
                f"request {req.request_id} needs {needed} KV blocks but the "
                f"pool only has {mgr.num_blocks} in total — it can never be "
                "scheduled; raise pa_num_blocks or shorten the prompt"
            )
        free_after = mgr.num_free_blocks() - needed
        if self.slots_busy == 0:
            # nothing is decoding, so nothing needs the growth headroom: a
            # lone request may dip below the watermark rather than deadlock
            return free_after >= 0
        return free_after >= self.config.watermark_blocks

    # -- queue / admission --------------------------------------------------
    def _now(self) -> float:
        """Queue-age clock (a method so tests can substitute it)."""
        return time.monotonic()

    def add(self, req: Request) -> None:
        req.state = WAITING
        req.queued_s = self._now()
        self.waiting.append(req)

    def schedule_prefills(self) -> List[Request]:
        """RUNNING requests with prefill work this step: in-flight chunked
        prefills first (they always continue), then new admissions per the
        interleave policy and the block watermark. Admission order is FCFS
        unless the prefix cache is on and ``cache_aware_admission`` holds:
        then the waiting request with the longest cached prefix goes first
        (FCFS tiebreak), reverting to strict FCFS whenever the queue head
        has aged past ``max_queue_age_s`` so nobody starves."""
        out = [r for r in self.slots if r is not None and not r.prefill_done]
        admitted = 0
        while (
            self.waiting
            and admitted < self.config.max_prefills_per_step
            and not (self.config.interleave == "decode_first" and self.decodable())
        ):
            slot = self._free_slot()
            if slot is None:
                break
            idx = self._pick_admission()
            req = self.waiting[idx]
            if not self._fork_ready(req):
                break  # n>1 sibling: hold until its parent's prefill lands
            if not self._admissible(req):
                break
            del self.waiting[idx]
            try:
                self._place(req, slot)
            except RuntimeError:
                # mid-admission pool failure (real exhaustion or an injected
                # block.alloc fault): undo the half-placement, free a little
                # room, and let the next step retry — never crash admission
                self._unplace_failed(req)
                self.preempt_one()
                break
            out.append(req)
            admitted += 1
        return out

    def _pick_admission(self) -> int:
        """Waiting-queue index to admit next. Strict FCFS (0) unless
        cache-aware admission applies; then the scan minimizes
        ``(-coverage, position)`` — longest cached prefix first (strict, so
        equal keys keep arrival order). The cache probe is read-only
        (``PrefixCache.peek``) — hit/miss stats and LRU ticks only move when
        the fork actually happens at placement. The starvation bound is
        unconditional: an aged head always goes first."""
        cfg = self.config
        cache = self.prefix_cache if cfg.cache_aware_admission else None
        if cache is None or len(self.waiting) < 2:
            return 0
        head = self.waiting[0]
        if (
            head.queued_s is not None
            and self._now() - head.queued_s >= cfg.max_queue_age_s
        ):
            return 0  # starvation bound: an aged head always goes first
        best_i, best_key = 0, None
        for i, req in enumerate(self.waiting):
            if i >= cfg.admission_scan_limit:
                break
            toks = req.seq_tokens
            n = cache.peek(toks, max_tokens=len(toks) - 1) if len(toks) > 1 else 0
            key = (-n, i)
            if best_key is None or key < best_key:
                best_i, best_key = i, key
        return best_i

    def _unplace_failed(self, req: Request) -> None:
        """Undo a ``_place`` that died inside its block allocation: at that
        point the slot table was not yet updated, but the request was
        marked RUNNING and may hold forked/partially-grown blocks. Free
        them and put the request back at the queue front (it keeps its
        admission priority; ``fork_of`` was not yet cleared, so a sibling
        fork retries intact)."""
        if self.block_manager is not None:
            self.block_manager.free_seq(req.request_id)
        req.slot = None
        req.state = WAITING
        req.num_prefilled = 0
        req.prefill_target = 0
        req.queued_s = self._now()
        self.waiting.appendleft(req)

    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slots):
            if r is None:
                return i
        return None

    def _fork_ready(self, req: Request) -> bool:
        """Gate for ``n > 1`` continuation siblings: admit only once the
        parent's prompt KV is committed (its prefill landed) so the fork
        shares real blocks. A finished/errored parent is no longer
        forkable — the sibling falls back to a normal prefill (which the
        prefix cache may still shortcut)."""
        parent = req.fork_of
        if parent is None or not self.can_fork:
            return True
        if parent.state == FINISHED:
            req.fork_of = None
            return True
        return parent.state == RUNNING and parent.prefill_done

    def _place(self, req: Request, slot: int) -> None:
        req.slot = slot
        req.state = RUNNING
        req.num_prefilled = 0
        req.prefill_target = len(req.seq_tokens)
        self._admit_counter += 1
        req._admit_seq = self._admit_counter
        cached = 0
        if self.block_manager is not None:
            cached = self._fork_shared(req)
            # covers the whole (re)prefill; decode growth is incremental
            self.block_manager.ensure_capacity(req.request_id, len(req.seq_tokens))
        req.fork_of = None
        # the engine's (re)prefill starts AFTER the shared prefix: chunked
        # prefill just sees a shorter remaining prompt
        req.num_prefilled = cached
        self.slots[slot] = req

    def place_imported(self, req: Request, slot: int, committed: int) -> None:
        """Seat a handoff import directly RUNNING with its prefill already
        accounted for: the engine allocated and filled the KV chain before
        calling this, so the request decodes on the next step as if it had
        prefilled here (``prefill_done`` is true at once)."""
        if self.slots[slot] is not None:
            raise RuntimeError(f"slot {slot} is already occupied")
        req.slot = slot
        req.state = RUNNING
        req.num_prefilled = committed
        req.prefill_target = committed
        self._admit_counter += 1
        req._admit_seq = self._admit_counter
        self.slots[slot] = req

    def _fork_shared(self, req: Request) -> int:
        """Hand ``req`` whatever committed KV it can share instead of
        re-prefilling: an ``n > 1`` sibling forks its live parent's prompt
        blocks (all blocks the first ``len(prompt) - 1`` positions touch —
        the last prompt token is left to the sibling's own tail prefill so
        it samples its own first token; if that boundary lands inside the
        parent's partial block, the first write copy-on-writes it); any
        other request forks the prefix cache's longest full-block match.
        Returns the token count the fork covers (= the new
        ``num_prefilled``)."""
        mgr = self.block_manager
        parent = req.fork_of
        if (
            parent is not None
            and self.can_fork
            and parent.state == RUNNING
            and parent.prefill_done
        ):
            p = len(req.prompt) - 1
            nb = -(-p // mgr.block_size)
            ptable = mgr._tables.get(parent.request_id, [])
            if p > 0 and len(ptable) >= nb:
                mgr.fork_prefix(req.request_id, ptable[:nb])
                return p
        cache = self.prefix_cache
        if cache is not None and len(req.seq_tokens) > 1:
            chain, ntok = cache.match(
                req.seq_tokens, max_tokens=len(req.seq_tokens) - 1
            )
            if chain:
                mgr.fork_prefix(req.request_id, chain)
            return ntok
        return 0

    def note_prefill_complete(self, req: Request) -> None:
        """Cross-request sharing without waiting for retirement: the moment
        a (re)prefill lands, every full block it committed enters the radix
        tree — CONCURRENT shared-prefix traffic (the Poisson multi-tenant
        shape) hits while the first request is still decoding. The engine
        calls this when ``prefill_done`` flips. Committed positions: all of
        ``prefill_target`` (a prefill writes its whole chunk's KV; the
        decode-emitted token after it has none yet). Decode growth never
        touches these blocks — writes land at positions >= prefill_target,
        beyond the inserted FULL blocks — so the retained chain stays
        immutable; duplicate paths dedup inside ``PrefixCache.insert``."""
        cache = self.prefix_cache
        mgr = self.block_manager
        if cache is None or mgr is None:
            return
        k = req.prefill_target
        if k < mgr.block_size:
            return
        table = mgr._tables.get(req.request_id)
        if table:
            cache.insert(req.seq_tokens[:k], table)

    def _cache_insert(self, req: Request) -> None:
        """Feed a departing sequence's committed full blocks into the radix
        tree (BEFORE ``free_seq`` drops its table, so the cache's retain
        lands while the blocks are still live). Committed positions: every
        prefilled chunk, and — once prefill is done — everything but the
        just-emitted last token (whose KV was never written)."""
        cache = self.prefix_cache
        mgr = self.block_manager
        if cache is None or mgr is None:
            return
        k = max(req.total_len - 1, 0) if req.prefill_done else req.num_prefilled
        if k < mgr.block_size:
            return
        table = mgr._tables.get(req.request_id)
        if table:
            cache.insert(req.seq_tokens[:k], table)

    # -- decode growth / preemption ----------------------------------------
    def ensure_decode_capacity(
        self, rows: List[Tuple[int, Request]]
    ) -> Tuple[List[Tuple[int, Request]], List[Request]]:
        """Grow each row's block table to cover its next KV write (the fed
        token's position = ``total_len - 1``). On pool exhaustion one running
        request is preempted per ``preempt_policy`` (possibly a row in
        ``rows``, possibly the grower itself) and growth retries — oldest
        requests are processed first, so under the youngest/FCFS tie-break
        they always win the remaining blocks."""
        preempted: List[Request] = []
        if self.block_manager is None:
            return list(rows), preempted
        kept: List[Tuple[int, Request]] = []
        for slot, req in sorted(rows, key=lambda sr: sr[1]._admit_seq):
            while req.state == RUNNING:  # may flip if evicted as a victim
                try:
                    self.block_manager.ensure_capacity(req.request_id, req.total_len)
                    kept.append((slot, req))
                    break
                except RuntimeError:
                    victim = self.preempt_one()
                    if victim is not None:
                        preempted.append(victim)
                        # the victim may already sit in ``kept`` (deadline-
                        # aware or coverage-based policies can evict an OLDER
                        # request than the grower): its blocks are freed, so
                        # it must leave THIS step's decode batch too, or the
                        # dispatch reads recycled KV and appends a garbage
                        # token to a waiting request
                        kept = [(s, r) for s, r in kept if r is not victim]
                    if victim is None or victim is req:
                        break  # req itself evicted (or nothing left to evict)
        # keep the original slot order for dispatch determinism
        kept.sort(key=lambda sr: sr[0])
        return kept, preempted

    def preempt_one(self) -> Optional[Request]:
        """Evict one RUNNING request back to the FRONT of the waiting queue
        per ``preempt_policy``, freeing its blocks (recompute-style
        preemption). Returns the victim, or None when nothing is evictable."""
        running = [r for r in self.running() if r.request_id not in self.unpreemptible]
        if not running:
            return None
        victim = self._pick_victim(running)
        self._preempt(victim)
        return victim

    def _pick_victim(self, running: List[Request]) -> Request:
        """Cheapest-recompute-first: the victim whose replay the prefix
        cache covers deepest loses the least work to eviction (its
        re-admission forks the cached chain and re-prefills only the tail).
        Coverage ties — including the whole-field tie of a cold cache or
        ``preempt_policy="youngest"`` — fall back to youngest-admitted, so
        the oldest request always keeps running (FCFS). The probe is the
        read-only ``PrefixCache.peek``."""
        cache = self.prefix_cache
        if (
            self.config.preempt_policy == "youngest"
            or cache is None
            or len(running) == 1
        ):
            return max(running, key=lambda r: r._admit_seq)

        def recompute_key(r: Request):
            toks = r.seq_tokens
            cov = cache.peek(toks, max_tokens=len(toks) - 1) if len(toks) > 1 else 0
            return (cov, r._admit_seq)

        return max(running, key=recompute_key)

    def preempt_youngest(self) -> Optional[Request]:
        """Evict the youngest RUNNING request unconditionally (tests/demos
        force deterministic victims through this; the capacity paths go
        through :meth:`preempt_one` and honor ``preempt_policy``)."""
        running = [r for r in self.running() if r.request_id not in self.unpreemptible]
        if not running:
            return None
        victim = max(running, key=lambda r: r._admit_seq)
        self._preempt(victim)
        return victim

    def _preempt(self, req: Request) -> None:
        if req.slot is None:
            raise RuntimeError(f"request {req.request_id} holds no slot to preempt")
        self.slots[req.slot] = None
        req.slot = None
        req.state = PREEMPTED
        if self.block_manager is not None:
            # the victim's committed blocks enter the cache instead of
            # dropping: its recompute-resume (and any shared-prompt peer)
            # re-forks them, so preemption stops costing a full re-prefill.
            # Must run while num_prefilled/prefill_target still describe
            # the committed KV — they are reset just below.
            self._cache_insert(req)
            self.block_manager.free_seq(req.request_id)
        req.num_prefilled = 0
        req.prefill_target = 0
        req.preemptions += 1
        req.queued_s = self._now()
        self.waiting.appendleft(req)

    # -- retirement ---------------------------------------------------------
    def retire(self, req: Request, reason: str) -> None:
        """Finish a request: free its KV space and recycle the slot without
        disturbing in-flight neighbors (the slot simply goes empty; the next
        admission overwrites the line/blocks from position 0)."""
        if req.slot is not None:
            self.slots[req.slot] = None
            req.slot = None
        if self.block_manager is not None:
            if reason != "error":
                self._cache_insert(req)
            self.block_manager.free_seq(req.request_id)
        req.state = FINISHED
        req.finish_reason = reason

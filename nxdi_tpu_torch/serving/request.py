"""Request lifecycle for the continuous-batching serving engine — the port's
copy of ``nxdi_tpu/serving/request.py``.

A :class:`Request` is one generation job with a WAITING -> RUNNING ->
(PREEMPTED ->) FINISHED lifecycle:

- WAITING   — queued FCFS; no device state.
- RUNNING   — holds an engine slot; prompt (re)prefill may still be in
  flight (``num_prefilled < prefill_target`` under chunked prefill).
- PREEMPTED — evicted on KV-pool exhaustion (recompute-style: its blocks
  are freed and the whole ``prompt + generated`` sequence is re-prefilled
  on re-admission — exact for greedy sampling).
- FINISHED  — EOS sampled or ``max_new_tokens`` reached; slot recycled.

Each request keeps the clock stamps the engine's finish metrics need
(``arrival_s``, ``first_token_s``; ``time.perf_counter``), in place of the
JAX package's telemetry span. Its QoS identity, distributed-trace context
and fault-recovery counters belong to the host plane, which is not ported
yet.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

from nxdi_tpu_torch.ops.sampling import SamplingParams, normalize_eos_ids

__all__ = [
    "Request",
    "RequestOutput",
    "SamplingParams",
    "normalize_eos_ids",
    "WAITING",
    "RUNNING",
    "PREEMPTED",
    "FINISHED",
    "STATES",
]

# lifecycle states (str constants, not Enum: they serialize as-is)
WAITING = "WAITING"
RUNNING = "RUNNING"
PREEMPTED = "PREEMPTED"
FINISHED = "FINISHED"

STATES = (WAITING, RUNNING, PREEMPTED, FINISHED)


class Request:
    """One generation request inside the engine."""

    _ids = iter(range(1, 1 << 62))

    def __init__(
        self,
        prompt: Sequence[int],
        params: Optional[SamplingParams] = None,
        request_id: Optional[int] = None,
        on_token: Optional[Callable[["Request", int], None]] = None,
        arrival_s: Optional[float] = None,
    ):
        self.request_id = (
            int(request_id) if request_id is not None else next(Request._ids)
        )
        self.prompt: List[int] = [int(t) for t in prompt]
        if not self.prompt:
            raise ValueError("empty prompt")
        self.params = params or SamplingParams()
        self.on_token = on_token
        self.arrival_s = time.perf_counter() if arrival_s is None else arrival_s
        #: when the first generated token was emitted (kept across preemption)
        self.first_token_s: Optional[float] = None

        self.state = WAITING
        self.generated: List[int] = []
        #: committed tokens of the (re)prefill replay (chunked-prefill
        #: progress); complete when it reaches ``prefill_target``, which the
        #: scheduler pins to ``len(seq_tokens)`` at placement time
        self.num_prefilled = 0
        self.prefill_target = 0
        self.slot: Optional[int] = None
        self.preemptions = 0
        #: human-readable failure detail for ``finish_reason == "error"``
        self.error: Optional[str] = None
        #: clock stamp of the last (re)entry into the waiting queue — the
        #: scheduler's starvation bound for cache-aware admission
        self.queued_s: Optional[float] = None
        # "eos" | "length" | "error" (un-resumable after preemption)
        self.finish_reason: Optional[str] = None
        self._admit_seq = -1  # admission order; youngest = max
        #: live parent Request this one is an ``n > 1`` continuation of:
        #: admission forks the parent's prompt KV blocks (COW) instead of
        #: re-prefilling; cleared when the parent is no longer forkable
        self.fork_of: Optional["Request"] = None
        #: stable parent id for output grouping (survives fork_of clearing)
        self.fork_parent_id: Optional[int] = None

    # -- derived views ------------------------------------------------------
    @property
    def seq_tokens(self) -> List[int]:
        """The full sequence a (re)prefill must commit: prompt + generated."""
        return self.prompt + self.generated

    @property
    def total_len(self) -> int:
        return len(self.prompt) + len(self.generated)

    @property
    def remaining(self) -> int:
        return self.params.max_new_tokens - len(self.generated)

    @property
    def prefill_done(self) -> bool:
        return self.prefill_target > 0 and self.num_prefilled >= self.prefill_target

    @property
    def is_finished(self) -> bool:
        return self.state == FINISHED

    # -- engine-side transitions -------------------------------------------
    def emit(self, token: int) -> None:
        """Append one generated token and fire the streaming callback."""
        token = int(token)
        if self.first_token_s is None:
            self.first_token_s = time.perf_counter()
        self.generated.append(token)
        if self.on_token is not None:
            self.on_token(self, token)

    def check_finish(self) -> Optional[str]:
        """Finish reason after the latest emitted token, else None."""
        if self.generated and self.generated[-1] in self.params.eos_token_ids:
            return "eos"
        if len(self.generated) >= self.params.max_new_tokens:
            return "length"
        return None

    def __repr__(self) -> str:
        return (
            f"Request(id={self.request_id}, state={self.state}, "
            f"prompt={len(self.prompt)}t, generated={len(self.generated)}t, "
            f"slot={self.slot}, preemptions={self.preemptions})"
        )


@dataclass
class RequestOutput:
    """What the engine returns when a request finishes."""

    request_id: int
    prompt: List[int]
    token_ids: List[int]  # generated tokens only
    finish_reason: str
    metrics: dict = field(default_factory=dict)
    #: failure detail when ``finish_reason == "error"`` (None otherwise)
    error: Optional[str] = None

    @property
    def full_ids(self) -> List[int]:
        return list(self.prompt) + list(self.token_ids)

"""Continuous-batching serving engine on the paged KV pool (the port's
counterpart of ``nxdi_tpu.serving``, split dispatch):

- :mod:`~nxdi_tpu_torch.serving.request` — ``Request`` / ``RequestOutput``
  with a WAITING -> RUNNING -> (PREEMPTED ->) FINISHED lifecycle and
  per-token streaming callbacks.
- :mod:`~nxdi_tpu_torch.serving.scheduler` — slot scheduler: FCFS admission
  under a free-KV-block watermark, chunked-prefill admission,
  recompute-style preemption on pool exhaustion.
- :mod:`~nxdi_tpu_torch.serving.prefix_cache` — radix tree of retained KV
  block chains: admission forks the longest cached full-block prefix and
  prefills only the tail.
- :mod:`~nxdi_tpu_torch.serving.engine` — ``InferenceEngine.step()``:
  prefill chunks into free slots, one batched decode per step, retirement;
  the prefill and decode roles of disaggregation.
- :mod:`~nxdi_tpu_torch.serving.handoff` — the KV handoff payload and its
  wire (the JAX package's, version 1).
- :mod:`~nxdi_tpu_torch.serving.workload` — the open-loop arrival driver and
  the goodput summary.
"""

from nxdi_tpu_torch.serving.engine import InferenceEngine
from nxdi_tpu_torch.serving.handoff import HandoffCapacityError, HandoffPayload
from nxdi_tpu_torch.serving.prefix_cache import PrefixCache
from nxdi_tpu_torch.serving.request import (
    FINISHED,
    PREEMPTED,
    RUNNING,
    WAITING,
    Request,
    RequestOutput,
    SamplingParams,
)
from nxdi_tpu_torch.serving.scheduler import Scheduler, SchedulerConfig

__all__ = [
    "HandoffCapacityError",
    "HandoffPayload",
    "InferenceEngine",
    "PrefixCache",
    "Request",
    "RequestOutput",
    "SamplingParams",
    "Scheduler",
    "SchedulerConfig",
    "WAITING",
    "RUNNING",
    "PREEMPTED",
    "FINISHED",
]

"""Open-loop arrival driver and goodput arithmetic — the port's copy of
``nxdi_tpu/serving/workload.py``.

:func:`drive_arrivals` submits every request whose arrival offset has passed,
steps the engine, and naps only when nothing is runnable;
:func:`goodput_summary` turns the finished outputs into req/s, tok/s and
exact TTFT / TPOT percentiles, from each request's ``metrics`` (the engine
times them from ``arrival_s`` on ``time.perf_counter``). The percentile rule
(:func:`percentile_exact`) and the SLO breach rule (:func:`breach_kinds`,
over any object with ``ttft_s`` / ``tpot_s`` targets such as
:class:`SloConfig`) are the JAX package's telemetry functions, copied.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from nxdi_tpu_torch.serving.request import RequestOutput


class SloConfig:
    """Declared serving SLOs: ``ttft_s`` and ``tpot_s`` targets in seconds
    (None = not declared). A request attains its SLO when every declared
    target holds with ``value <= target``."""

    def __init__(self, ttft_s: Optional[float] = None, tpot_s: Optional[float] = None):
        self.ttft_s = None if ttft_s is None else float(ttft_s)
        self.tpot_s = None if tpot_s is None else float(tpot_s)
        if self.ttft_s is None and self.tpot_s is None:
            raise ValueError("SloConfig needs at least one of ttft_s / tpot_s")
        if (self.ttft_s is not None and self.ttft_s <= 0) or (
            self.tpot_s is not None and self.tpot_s <= 0
        ):
            raise ValueError("SLO targets must be positive seconds")


def percentile_exact(values: Sequence[float], p: float) -> float:
    """Exact linear-interpolated percentile over raw values (numpy's default
    convention); 0.0 for no values."""
    xs = sorted(values)
    if not xs:
        return 0.0
    if len(xs) == 1:
        return float(xs[0])
    pos = (len(xs) - 1) * min(max(p, 0.0), 100.0) / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return float(xs[lo] + (xs[hi] - xs[lo]) * (pos - lo))


def breach_kinds(slo, ttft_s: Optional[float], tpot_s: Optional[float]) -> List[str]:
    """Which declared targets the request broke (``[]`` = attained). Only
    measured latencies can breach: ``None`` (a single-token completion has
    no TPOT) holds vacuously."""
    kinds: List[str] = []
    if slo.ttft_s is not None and ttft_s is not None and ttft_s > slo.ttft_s:
        kinds.append("ttft")
    if slo.tpot_s is not None and tpot_s is not None and tpot_s > slo.tpot_s:
        kinds.append("tpot")
    return kinds


def drive_arrivals(
    engine,
    arrivals: Sequence[float],
    submit: Callable[[object, int, float], None],
    before_step: Optional[Callable[[object], None]] = None,
    after_step: Optional[Callable[[object], None]] = None,
) -> Tuple[List[RequestOutput], float]:
    """Drive an open-loop workload to completion.

    ``arrivals`` — sorted arrival offsets in seconds from the loop start
    (``np.cumsum(rng.exponential(1 / rate, n))`` for a Poisson process);
    ``submit(engine, i, arrival_s)`` — add request ``i`` once its offset has
    passed; ``arrival_s`` is its true arrival on ``time.perf_counter``, to
    pass as ``add_request(arrival_s=)`` so TTFT counts the wait behind a
    long engine step. ``before_step`` / ``after_step`` — per-iteration hooks.

    Returns ``(outputs, wall_seconds)`` with every request finished."""
    clock = time.perf_counter
    outputs: List[RequestOutput] = []
    t0 = clock()
    next_i, n = 0, len(arrivals)
    while next_i < n or engine.has_work():
        now = clock() - t0
        while next_i < n and arrivals[next_i] <= now:
            submit(engine, next_i, t0 + float(arrivals[next_i]))
            next_i += 1
        if not engine.has_work():
            # idle before the next arrival: nap briefly instead of spinning
            time.sleep(min(1e-3, max(0.0, arrivals[next_i] - now)))
            continue
        if before_step is not None:
            before_step(engine)
        outputs.extend(engine.step())
        if after_step is not None:
            after_step(engine)
    return outputs, clock() - t0


def goodput_summary(outputs: Sequence[RequestOutput], wall_s: float,
                    slo=None) -> Dict[str, object]:
    """Serving goodput over a finished workload: req/s, tok/s, p50/p95 TTFT
    and TPOT in ms (None when no request carried the metric), preemptions.
    Only eos/length completions count toward req/s and tok/s; a request
    finished with ``"error"`` is counted in ``errors``. With ``slo`` (any
    object with ``ttft_s`` / ``tpot_s`` targets) the summary adds
    ``slo_attainment_pct`` and ``goodput_slo_tok_s`` (tokens of attaining
    requests per second)."""
    ok = [o for o in outputs if o.finish_reason != "error"]
    n_tok = sum(len(o.token_ids) for o in ok)
    ttfts = [o.metrics["ttft_s"] for o in ok if o.metrics.get("ttft_s") is not None]
    tpots = [o.metrics["tpot_s"] for o in ok if o.metrics.get("tpot_s") is not None]

    def pct(xs: List[float], q: float) -> Optional[float]:
        return round(percentile_exact(xs, q) * 1e3, 2) if xs else None

    summary: Dict[str, object] = {
        "requests": len(outputs),
        "errors": len(outputs) - len(ok),
        "goodput_req_s": round(len(ok) / wall_s, 3),
        "tok_s": round(n_tok / wall_s, 1),
        "ttft_p50_ms": pct(ttfts, 50),
        "ttft_p95_ms": pct(ttfts, 95),
        "tpot_p50_ms": pct(tpots, 50),
        "tpot_p95_ms": pct(tpots, 95),
        "preemptions": int(sum(o.metrics.get("preemptions", 0) for o in outputs)),
    }
    if slo is not None:
        attained = [o for o in ok
                    if not breach_kinds(slo, o.metrics.get("ttft_s"), o.metrics.get("tpot_s"))]
        summary["slo_attainment_pct"] = (
            round(100.0 * len(attained) / len(ok), 2) if ok else 0.0)
        summary["goodput_slo_tok_s"] = round(
            sum(len(o.token_ids) for o in attained) / wall_s, 1)
    return summary

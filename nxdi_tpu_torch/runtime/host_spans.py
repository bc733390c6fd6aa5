"""Named host ranges of a serving step, for splitting its host time.

A dispatch's host time is spent in parts: the engine's scheduling
(``engine.step``), the dispatch (``dispatch``), and inside it the wrapper's
padding and bucket choice (``pad_and_bucket``), the paged write's indices
(``scatter_indices``), the ragged work list (``ragged_plan``), the H2D copy
(``h2d``), the forward's launches or the graph's replay (``launch``), and
after it the token fetch (``token_fetch``, which waits for the card).

Off by default: :func:`span` then returns one shared null context. Under
:func:`recording` each range is a ``torch.profiler.record_function`` range
(a CPU event in a profiler trace) and its host seconds are summed into the
dict that ``recording`` yields, so the split can be read with or without
the profiler's CPU activity.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

from torch.profiler import record_function

_NULL = contextlib.nullcontext()
_totals: Optional[Dict[str, float]] = None


class _Span:
    __slots__ = ("name", "_rf", "_t0")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self):
        self._rf = record_function(self.name)
        self._rf.__enter__()
        self._t0 = time.perf_counter()

    def __exit__(self, *exc):
        if _totals is not None:
            _totals[self.name] = _totals.get(self.name, 0.0) + time.perf_counter() - self._t0
        self._rf.__exit__(*exc)


def span(name: str):
    """A context naming a part of the host's work (a no-op unless recording)."""
    return _NULL if _totals is None else _Span(name)


@contextlib.contextmanager
def recording():
    """Record the spans entered inside; yields {name: host seconds}."""
    global _totals
    prev, _totals = _totals, {}
    try:
        yield _totals
    finally:
        _totals = prev

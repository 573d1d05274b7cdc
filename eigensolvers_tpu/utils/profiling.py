"""Tracing and structured per-phase timing.

The reference has only coarse wall-clock in the status dict
(SURVEY.md §5 "tracing/profiling: none").  Here:

* :class:`PhaseTimer` — a structured metrics accumulator (per-phase wall
  time, call counts) that solvers and drivers can thread through the status
  dict;
* :func:`trace` — context manager around ``jax.profiler`` producing
  TensorBoard-compatible device traces (XLA op-level timeline);
* :class:`CompileClock` — seconds JAX spends tracing, lowering and
  compiling inside a block, so a first call's wall time splits into
  compile and run.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional


class PhaseTimer:
    """Accumulates wall-clock per named phase.

    >>> t = PhaseTimer()
    >>> with t.phase("solve"):
    ...     pass
    >>> t.summary()   # {"solve": {"seconds": ..., "calls": 1}}
    """

    def __init__(self):
        self._seconds: Dict[str, float] = defaultdict(float)
        self._calls: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._seconds[name] += time.perf_counter() - t0
            self._calls[name] += 1

    def add(self, name: str, seconds: float):
        self._seconds[name] += seconds
        self._calls[name] += 1

    def summary(self) -> Dict[str, dict]:
        return {k: {"seconds": self._seconds[k], "calls": self._calls[k]}
                for k in self._seconds}

    def report(self) -> str:
        lines = [f"{'phase':<24}{'seconds':>12}{'calls':>8}"]
        for k in sorted(self._seconds, key=self._seconds.get, reverse=True):
            lines.append(f"{k:<24}{self._seconds[k]:>12.3f}{self._calls[k]:>8}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: Optional[str] = None, host_tracer_level: int = 2):
    """Device-level profiler trace (TensorBoard format).  No-op when
    ``logdir`` is None."""
    if logdir is None:
        yield
        return
    import jax
    jax.profiler.start_trace(logdir, create_perfetto_link=False)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


#: JAX's monitoring events for tracing, lowering and XLA compilation
#: (persistent-cache reads included).
_COMPILE_EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
                   "/jax/core/compile/jaxpr_to_mlir_module_duration",
                   "/jax/core/compile/backend_compile_duration")


class CompileClock:
    """Context manager: the wall seconds inside the block during which JAX
    traced, lowered or compiled.  Nested spans (a jit traced inside another
    jit's trace) count once: ``seconds`` is the length of their union.

    >>> with CompileClock() as cc:
    ...     jax.jit(f)(x).block_until_ready()
    >>> cc.seconds
    """

    def __init__(self):
        self.spans = []

    def _on_span(self, event, start, end, **kwargs):
        if event in _COMPILE_EVENTS:
            self.spans.append((start, end))

    def __enter__(self):
        import jax
        jax.monitoring.register_event_time_span_listener(self._on_span)
        return self

    def __exit__(self, *exc):
        import jax
        jax.monitoring.unregister_event_time_span_listener(self._on_span)
        return False

    @property
    def seconds(self) -> float:
        return union_length(self.spans)


def union_length(spans) -> float:
    """Total length covered by possibly overlapping (start, end) spans."""
    total, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(spans):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total

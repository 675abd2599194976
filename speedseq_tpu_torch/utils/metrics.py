"""Structured per-stage counters and timers.

The reference's observability is stdout echo of each command
(bin/speedseq:400-435) — no counters.  SURVEY §5 calls structured
metrics out as a required addition for the TPU build: every module
increments named counters here; `snapshot()` returns a plain dict
(tests and the CLI `-v` summary consume it), `report()` renders one
line per stage.

A span (``timer``) records the host wall time under ``time.<name>`` and
the calling thread's CPU time under ``cpu.<name>``; wall minus CPU is
the time the thread waited (the GIL, a full launch queue, a lock).
While a torch profiler records on the calling thread (it records the
thread that started it), the span is also a profiler range
``ssq.<name>`` around its body, so the program's spans sit on the
profiler's clock beside the device's kernels; with no profiler none is
entered.  The range is an op range (``_RecordFunctionFast``), not a
``record_function`` user annotation: the profiler mirrors a user
annotation onto the device's timeline as device activity, which would
count as busy time there.  A span's parent is the span it nests in,
and its name says it too (``align.dispatch`` → ``align.stage.extend``).

Thread-safe (host fan-out workers increment concurrently); counters are
process-local — multi-host runs report per process, like the
reference's per-pipe stdout.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch

SPAN_PREFIX = "ssq."
# torch's flag: a profiler records on the calling thread
_profiling = torch.autograd._profiler_enabled


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, float] = defaultdict(float)
        self._times: Dict[str, float] = defaultdict(float)
        self._cpu: Dict[str, float] = defaultdict(float)

    def add(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counts[name] += value

    def timer(self, name: str) -> "_Span":
        """A span: wall time ``time.<name>``, thread CPU time
        ``cpu.<name>``, and a profiler range ``ssq.<name>`` while a
        profiler records."""
        return _Span(self, name)

    def timed(self, it: Iterator, name: str) -> Iterator:
        """``it``, with the time spent producing each item added to span
        ``name`` (the consumer's time between items is not counted)."""
        while True:
            with self.timer(name):
                item = next(it, None)
            if item is None:
                return
            yield item

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            out = dict(self._counts)
            out.update({f"time.{k}": round(v, 4)
                        for k, v in self._times.items()})
            out.update({f"cpu.{k}": round(v, 4)
                        for k, v in self._cpu.items()})
            return out

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self._times.clear()
            self._cpu.clear()

    def report(self, prefix: str = "") -> str:
        snap = self.snapshot()
        lines = []
        for k in sorted(snap):
            v = snap[k]
            lines.append(f"{prefix}{k}: {int(v) if float(v).is_integer() else round(v, 3)}")
        return "\n".join(lines)


class _Span:
    __slots__ = ("_metrics", "_name", "_range", "_t0", "_c0")

    def __init__(self, metrics: Metrics, name: str):
        self._metrics = metrics
        self._name = name

    def __enter__(self) -> "_Span":
        self._range = None
        if _profiling():
            self._range = torch._C._profiler._RecordFunctionFast(
                SPAN_PREFIX + self._name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        self._c0 = time.thread_time()
        return self

    def __exit__(self, *exc) -> None:
        cpu = time.thread_time() - self._c0
        wall = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(None, None, None)
        m = self._metrics
        with m._lock:
            m._times[self._name] += wall
            m._cpu[self._name] += cpu


# process-global registry (the align/var/sv engines increment this)
metrics = Metrics()

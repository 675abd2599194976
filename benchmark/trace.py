"""The traced run's instruments, all from the benchmark's own files: host
spans (``torch.profiler.record_function``) wrapped around the calls into
each layer of the program, a record of the launched shapes of the hand
kernels whose rooflines are read, and the reduction of the profiler's
events to device busy time, kernel times and idle gaps named by the
span that was open on the host."""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, List, Tuple

import numpy as np

SPAN_PREFIX = "bench."

# (module, attribute, span name): calls into each layer.  A class
# attribute is written "Class.method".
SPANS = [
    ("speedseq_tpu_torch.align.pipeline", "_load_fm", "align.index_load"),
    ("speedseq_tpu_torch.align.pipeline", "fused_align_leaves",
     "align.step_dispatch"),
    ("speedseq_tpu_torch.align.emit", "build_batch_records", "align.emit"),
    ("speedseq_tpu_torch.formats.extsort", "ExternalBAMSorter.add_columns",
     "align.sort_intake"),
    ("speedseq_tpu_torch.formats.extsort", "ExternalBAMSorter.close",
     "align.sort_close"),
    ("speedseq_tpu_torch.formats.bai", "build_bai", "align.bai"),
    ("speedseq_tpu_torch.var.engine", "_fetch_window_raw", "var.fetch"),
    ("speedseq_tpu_torch.var.engine", "build_pileup_columns", "var.pileup"),
    ("speedseq_tpu_torch.var.caller", "prepare_window", "var.loci"),
    ("speedseq_tpu_torch.var.caller", "_score_hap_jobs", "var.hap_scan"),
    ("speedseq_tpu_torch.var.caller", "genotype_windows", "var.genotype"),
    ("speedseq_tpu_torch.var.caller", "finish_window", "var.finish"),
    ("speedseq_tpu_torch.var.engine", "site_to_vcf", "var.emit"),
    ("speedseq_tpu_torch.formats.tabix", "build_tbi", "var.tbi"),
]

# (module, wrapper, kernel name in the device trace): launches whose
# shapes the roofline readers need
KERNELS = [
    ("speedseq_tpu_torch.ops.sw_banded", "sw_cigar", "sw_cigar_kernel"),
    ("speedseq_tpu_torch.ops.sw_unbanded", "sw_score_unbanded",
     "sw_unbanded_scan_kernel"),
]


def _resolve(mod_name: str, attr: str):
    import importlib

    obj = importlib.import_module(mod_name)
    *owner, name = attr.split(".")
    for o in owner:
        obj = getattr(obj, o)
    return obj, name


@contextlib.contextmanager
def instrumented(launches: Dict[str, List[tuple]]):
    """Within: every call in SPANS runs inside a span, and every call of
    a KERNELS wrapper appends (rows, Lq, Lr, lanes, qlen tensor) to
    ``launches[kernel]``."""
    import torch

    saved = []

    def span(fn, name):
        @functools.wraps(fn)
        def wrapped(*a, **k):
            with torch.profiler.record_function(SPAN_PREFIX + name):
                return fn(*a, **k)
        return wrapped

    def shapes(fn, kernel):
        @functools.wraps(fn)
        def wrapped(query, qlen, ref, *a, **k):
            launches.setdefault(kernel, []).append(
                (tuple(query.shape), tuple(ref.shape), qlen))
            return fn(query, qlen, ref, *a, **k)
        return wrapped

    try:
        for mod, attr, name in SPANS:
            owner, key = _resolve(mod, attr)
            saved.append((owner, key, owner.__dict__[key]))
            setattr(owner, key, span(getattr(owner, key), name))
        for mod, attr, kernel in KERNELS:
            owner, key = _resolve(mod, attr)
            saved.append((owner, key, owner.__dict__[key]))
            setattr(owner, key, shapes(getattr(owner, key), kernel))
        yield
    finally:
        for owner, key, fn in reversed(saved):
            setattr(owner, key, fn)


def _ev(e, ns: str, us: str):
    f = getattr(e, ns, None)
    if f is not None:
        return float(f())
    return float(getattr(e, us)()) * 1e3


def _attribute(gaps, spans) -> Dict[str, float]:
    """Seconds of the idle ``gaps`` under each span name: every stretch of
    a gap goes to the innermost span open over it (the latest started),
    "(no span)" where none is."""
    import heapq

    marks = []
    for i, (s, e, _) in enumerate(spans):
        marks.append((s, 1, i))
        marks.append((e, 0, i))
    marks.sort()
    out: Dict[str, float] = {}
    heap: List[tuple] = []
    open_ = set()
    m = 0
    for a, b in gaps:
        t = a
        while t < b:
            while m < len(marks) and marks[m][0] <= t:
                _, kind, i = marks[m]
                if kind:
                    open_.add(i)
                    heapq.heappush(heap, (-spans[i][0], i))
                else:
                    open_.discard(i)
                m += 1
            while heap and heap[0][1] not in open_:
                heapq.heappop(heap)
            nxt = min(b, marks[m][0]) if m < len(marks) else b
            name = spans[heap[0][1]][2] if heap else "(no span)"
            out[name] = out.get(name, 0.0) + (nxt - t) / 1e9
            t = nxt
    return out


class Trace:
    """The device side of one traced stretch: busy time, time per kernel
    name, idle gaps by the innermost benchmark span open over them."""

    def __init__(self, prof, window_span: str):
        from torch.autograd import DeviceType

        dev, spans = [], []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            start = _ev(e, "start_ns", "start_us")
            dur = _ev(e, "duration_ns", "duration_us")
            if name.startswith(SPAN_PREFIX):
                if e.device_type() == DeviceType.CPU:
                    spans.append((start, start + dur, name[len(
                        SPAN_PREFIX):]))
            elif e.device_type() == DeviceType.CUDA:
                dev.append((start, start + dur, name))
        win = [s for s in spans if s[2] == window_span]
        if not win:
            raise RuntimeError(f"trace has no span {window_span}")
        self.t0, self.t1 = win[0][0], win[0][1]
        self.window_s = (self.t1 - self.t0) / 1e9
        self.kernel_s: Dict[str, float] = {}
        self.kernel_n: Dict[str, int] = {}
        for s, e, n in dev:
            self.kernel_s[n] = self.kernel_s.get(n, 0.0) + (e - s) / 1e9
            self.kernel_n[n] = self.kernel_n.get(n, 0) + 1
        iv = np.array([(max(s, self.t0), min(e, self.t1)) for s, e, _ in dev
                       if e > self.t0 and s < self.t1], np.float64)
        gaps = []
        busy = 0.0
        cur_s, cur_e = self.t0, self.t0
        if len(iv):
            iv = iv[np.argsort(iv[:, 0])]
            for s, e in iv:
                if s > cur_e:
                    busy += cur_e - cur_s
                    gaps.append((cur_e, s))
                    cur_s, cur_e = s, e
                else:
                    cur_e = max(cur_e, e)
            busy += cur_e - cur_s
        gaps.append((cur_e, self.t1))
        self.busy_s = busy / 1e9
        inner = [s for s in spans if s[2] != window_span]
        self.idle_by_span = _attribute(gaps, inner)

    def kernel_seconds(self, part: str) -> Tuple[float, int]:
        """Device seconds and launches of the kernels named with ``part``."""
        s = sum(v for k, v in self.kernel_s.items() if part in k)
        n = sum(v for k, v in self.kernel_n.items() if part in k)
        return s, n

    def breakdown(self) -> dict:
        top = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:120], v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in idle]}

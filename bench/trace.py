"""What a run records for its per-layer metrics: spans around the calls
into each layer (host clock), counts, and in a traced run the device's
timeline from ``torch.profiler``.

Spans are recorded by the benchmark's own code around calls into the
system under test; they do not nest. In a traced run each span is also a
``record_function`` range, so the profiler places it on the clock of the
device's operations, and an idle stretch of the device is charged to the
span the host was in.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

TOP = 10            # entries a breakdown list may hold
WINDOW = "window"   # the profiler range around the measured window
OUTSIDE = "outside_spans"


class Recorder:
    def __init__(self, traced: bool = False):
        self.traced = traced
        self.spans: List[Tuple[str, float, float]] = []
        self.counters: Dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def span(self, name: str):
        rf = None
        if self.traced:
            import torch
            rf = torch.profiler.record_function(name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if rf is not None:
                rf.__exit__(None, None, None)
            self.spans.append((name, t0, t1))

    def add(self, name: str, value: float = 1.0) -> None:
        self.counters[name] += value

    def durations(self, name: str) -> List[float]:
        return [t1 - t0 for n, t0, t1 in self.spans if n == name]


class Trace:
    """What a metric's reader gets: the run's spans and counters, the
    window's length, and in a traced run the device profile
    (``device_profile``'s dict)."""

    def __init__(self, rec: Recorder, window_s: float,
                 device: Optional[dict] = None):
        self.counters = dict(rec.counters)
        self._rec = rec
        self.window_s = window_s
        self.device = device

    def durations(self, name: str) -> List[float]:
        return self._rec.durations(name)


def _events(prof):
    """The profiler's raw events (no tree is built from them)."""
    return prof.profiler.kineto_results.events()


def device_profile(prof, span_names) -> dict:
    """From a ``torch.profiler.profile`` that ran around the window (with
    a ``WINDOW`` range inside it): the device's busy seconds (the union of
    its operations' intervals within the window), the window's length,
    each device operation's count and seconds, and the idle seconds by
    the span the host was in."""
    from torch.autograd import DeviceType
    starts, ends, names = [], [], []
    spans = []
    window = None
    for e in _events(prof):
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation() or name in span_names or \
                    name == WINDOW:
                continue
            starts.append(e.start_ns())
            ends.append(e.end_ns())
            names.append(name)
        elif name == WINDOW:
            window = (e.start_ns(), e.end_ns())
        elif name in span_names:
            spans.append((e.start_ns(), e.end_ns(), name))
    if window is None:
        raise RuntimeError("the profile holds no window range")
    w0, w1 = window
    s = np.clip(np.asarray(starts, dtype=np.int64), w0, w1)
    e = np.clip(np.asarray(ends, dtype=np.int64), w0, w1)
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for i in order:
        k = kernels[names[i][:160]]
        k[0] += 1
        k[1] += (ends[i] - starts[i]) / 1e9
    if len(s):
        reach = np.maximum.accumulate(e)
        gap_lo = np.concatenate([[w0], reach])
        gap_hi = np.concatenate([s, [w1]])
    else:
        gap_lo, gap_hi = np.array([w0]), np.array([w1])
    keep = gap_hi > gap_lo
    gap_lo, gap_hi = gap_lo[keep], gap_hi[keep]
    idle_s = float((gap_hi - gap_lo).sum()) / 1e9
    window_s = (w1 - w0) / 1e9
    spans.sort()
    span_lo = np.asarray([sp[0] for sp in spans], dtype=np.int64)
    idle_by: Dict[str, float] = defaultdict(float)
    mid = (gap_lo + gap_hi) // 2
    at = np.searchsorted(span_lo, mid, side="right") - 1
    for lo, hi, m, j in zip(gap_lo, gap_hi, mid, at):
        inside = j >= 0 and m < spans[j][1]
        idle_by[spans[j][2] if inside else OUTSIDE] += (hi - lo) / 1e9
    return {"busy_s": window_s - idle_s, "window_s": window_s,
            "kernels": {k: (int(n), t) for k, (n, t) in kernels.items()},
            "idle_by_span": dict(idle_by)}


def breakdown(profile: dict) -> dict:
    ops = sorted(((t, k) for k, (_, t) in profile["kernels"].items()),
                 reverse=True)[:TOP]
    gaps = sorted(((t, k) for k, t in profile["idle_by_span"].items()),
                  reverse=True)[:TOP]
    return {"device_ops": [[k, t] for t, k in ops],
            "idle_gaps": [[k, t] for t, k in gaps]}

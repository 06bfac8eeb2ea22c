"""The port's own spans (``repro_torch.tracing``) for the per-layer metrics
that read them: only those that lie within the benchmark's spans of the
run being read (``Trace``'s recorder), both on ``time.perf_counter``'s
clock, so spans left over from another run in the process are never read.
A port that records no spans gives none, and its readers return None."""
from __future__ import annotations

from bisect import bisect_right
from typing import List, Optional


def spans(trace, name: str) -> List:
    """The ended port spans called ``name`` within the run's own spans."""
    try:
        from repro_torch import tracing
    except ImportError:
        return []
    own = sorted((t0, t1) for _, t0, t1 in trace._rec.spans)
    starts = [t0 for t0, _ in own]
    found = []
    for s in tracing.spans():
        if s.name != name or s.t1_ns is None:
            continue
        i = bisect_right(starts, s.t0_ns / 1e9) - 1
        if i >= 0 and s.t1_ns / 1e9 <= own[i][1]:
            found.append(s)
    return found


def mean_ms(trace, name: str) -> Optional[float]:
    """Mean duration of the spans called ``name``, in ms."""
    d = [s.t1_ns - s.t0_ns for s in spans(trace, name)]
    return sum(d) / len(d) / 1e6 if d else None


def dispatch_share(trace) -> Optional[float]:
    """100 x (decode steps' time - the token waits inside them) / decode
    steps' time, in %: the share of decode in which the host dispatches
    work and has not run ahead of the device (100: host-bound)."""
    steps = spans(trace, "engine.decode_step")
    if not steps:
        return None
    ids = {s.id for s in steps}
    total = sum(s.t1_ns - s.t0_ns for s in steps)
    wait = sum(s.t1_ns - s.t0_ns for s in spans(trace, "engine.token_wait")
               if s.parent in ids)
    return 100.0 * (total - wait) / total


def bytes_per_changed(trace, name: str) -> Optional[float]:
    """The ``bytes`` attribute summed over the spans called ``name``, over
    the bytes of the chunks the deltas changed (the benchmark's
    ``changed_chunk_bytes`` counter)."""
    changed = trace.counters.get("changed_chunk_bytes")
    found = spans(trace, name)
    if not changed or not found:
        return None
    return sum(s.attrs.get("bytes", 0) for s in found) / changed

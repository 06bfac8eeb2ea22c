"""Spans inside the port, on the profiler's clock.

``span(name, **attrs)`` marks one stage of one call. While a torch profiler
records (``recording()``), a span enters
``torch.profiler.record_function(name)``, so the profiler places it on the
timeline of the device's operations, and it appends one ``Span`` to an
in-memory list: its name, its id, the id of the span it was opened in
(``parent``), its start and end on ``time.perf_counter_ns``'s clock and its
attributes. ``spans()`` returns that list and ``clear()`` empties it.

While no profiler records, ``span`` returns one shared handle that does
nothing: it reads no clock, allocates nothing and enters no range. So an
operator turns the spans on by profiling, as with any ``record_function``
range. A span opened in a thread of its own (an ``async_write`` save) has
no parent.

The flag is the profiler's process-wide one: ``torch._C._autograd.
_profiler_enabled()`` answers for the calling thread only, and is False
in a thread the profiler was not started in.
"""
from __future__ import annotations

import contextvars
import itertools
import time
from typing import Any, Dict, List, Optional

import torch
import torch.autograd.profiler as _profiler

_open: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_open_span", default=None)
_ids = itertools.count(1)
_spans: List["Span"] = []


def recording() -> bool:
    """Whether a torch profiler is recording (in any thread)."""
    return _profiler._is_profiler_enabled


class Span:
    """One recorded span; ``t1_ns`` is None while it is open."""

    __slots__ = ("name", "id", "parent", "t0_ns", "t1_ns", "attrs",
                 "_range", "_token")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self.id = next(_ids)
        self.parent: Optional[int] = None
        self.t0_ns: Optional[int] = None
        self.t1_ns: Optional[int] = None

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.parent = _open.get()
        self._token = _open.set(self.id)
        _spans.append(self)
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1_ns = time.perf_counter_ns()
        _open.reset(self._token)
        self._range.__exit__(None, None, None)
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"t0_ns={self.t0_ns}, t1_ns={self.t1_ns}, {self.attrs})")


class _Off:
    """The handle ``span`` returns while nothing records."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


def span(name: str, **attrs):
    """A context manager for one stage; yields a handle whose
    ``set(**attrs)`` adds attributes (a no-op while nothing records)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return Span(name, attrs)


def spans() -> List[Span]:
    """The recorded spans, in the order they opened."""
    return list(_spans)


def clear() -> None:
    _spans.clear()

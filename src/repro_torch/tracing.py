"""Spans and counters of the port, on the host's wall clock.

One facility for the whole process: the layers open named spans where
their work happens (``train.*``, ``collectives.*``, ``recovery.detect``,
``engine.*``) and count what they move (``sent_bytes``).  A span holds its
name, its start and end in ``time.time_ns()`` (the clock ``torch.profiler``
converts its host and device timestamps to, so a span lies directly against
the profiler's device intervals), its number, the number of the span that
encloses it on the same thread (-1 at the top), the thread and a small dict
of attributes.

Tracing is off by default.  Off, a span or a count costs one check of the
module-level boolean :data:`enabled`: no clock read, no allocation
(``span`` returns one shared null context).  :func:`enable` switches it
on, :func:`disable` off, and :func:`drain` returns what was recorded and
empties the buffer.  The buffer is bounded: when it is full the oldest span
is dropped and counted.  ``device.timed`` opens its span through
:func:`span`, so a phase that the ``stats=`` dicts time is also a span.

    tracing.enable()
    ...                                   # run the program
    tracing.disable()
    rec = tracing.drain()                 # spans, counters, dropped
    tracing.write_chrome_trace("trace.json", rec)
"""

from __future__ import annotations

import collections
import functools
import itertools
import json
import os
import threading
import time
from pathlib import Path
from typing import NamedTuple

#: whether spans and counts are recorded; read, never set, outside this module
enabled = False
#: spans the buffer holds
CAPACITY = 1 << 16


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    index: int
    parent: int
    thread: int
    attrs: dict


_spans: collections.deque = collections.deque(maxlen=CAPACITY)
_counters: dict[str, float] = {}
_dropped = 0
_numbers = itertools.count()
_local = threading.local()


def _stack() -> list[int]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Null:
    """The context a span is while tracing is off: it records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def __bool__(self):
        return False


_NULL = _Null()


class _Open:
    """A span being recorded; ``attrs`` may be filled while it is open."""

    __slots__ = ("name", "attrs", "index", "parent", "start_ns")

    def __init__(self, name: str):
        self.name = name
        self.attrs: dict = {}

    def __enter__(self):
        stack = _stack()
        self.index = next(_numbers)
        self.parent = stack[-1] if stack else -1
        stack.append(self.index)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        end = time.time_ns()
        _stack().pop()
        _record(Span(self.name, self.start_ns, end, self.index, self.parent,
                     threading.get_ident(), self.attrs))
        return False


def _record(span: Span) -> None:
    global _dropped
    if len(_spans) == _spans.maxlen:
        _dropped += 1
    _spans.append(span)


def span(name: str | None):
    """A context that records the span ``name`` while tracing is on (the
    shared null context while it is off, or for ``name`` None).  Entered,
    it gives the open span, whose ``attrs`` dict may be filled; the null
    context is false, so ``if s:`` guards work that only a span needs."""
    if not enabled or name is None:
        return _NULL
    return _Open(name)


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if enabled:
        _counters[name] = _counters.get(name, 0) + n


def traced(name: str):
    """Decorate a function so that, while tracing is on, each call is the
    span ``name`` and counts one under the counter ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not enabled:
                return fn(*args, **kwargs)
            count(name)
            with _Open(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def enable() -> None:
    """Start recording."""
    global enabled
    enabled = True


def disable() -> None:
    """Stop recording; what was recorded stays until :func:`drain`."""
    global enabled
    enabled = False


def drain() -> dict:
    """``spans`` recorded since the last drain, in the order they ended;
    ``counters``; ``dropped``, the spans the full buffer let go.  Empties
    all three."""
    global _dropped
    out = {"spans": list(_spans), "counters": dict(_counters), "dropped": _dropped}
    _spans.clear()
    _counters.clear()
    _dropped = 0
    return out


def to_chrome_trace(spans) -> dict:
    """``spans`` as the Chrome trace format's complete events (``ph``
    ``"X"``) of this process, ``ts`` and ``dur`` in microseconds of
    ``time.time_ns()``'s clock; each event's ``args`` are the span's
    attributes with its ``index`` and ``parent``."""
    pid = os.getpid()
    return {"traceEvents": [
        {"name": s.name, "ph": "X", "ts": s.start_ns / 1e3,
         "dur": (s.end_ns - s.start_ns) / 1e3, "pid": pid, "tid": s.thread,
         "args": dict(s.attrs, index=s.index, parent=s.parent)}
        for s in spans], "displayTimeUnit": "ms"}


def write_chrome_trace(path, rec: dict) -> None:
    """Write :func:`drain`'s ``rec`` to ``path`` as Chrome trace JSON
    (:func:`to_chrome_trace`), its counters and dropped spans under
    ``otherData``."""
    doc = to_chrome_trace(rec["spans"])
    doc["otherData"] = {"counters": rec["counters"], "dropped": rec["dropped"]}
    out = Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(doc))

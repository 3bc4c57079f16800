"""The port's span recorder (port of sage_slam_tpu/utils/timing.py).

``span(name)`` marks a region, as a context manager or a function
decorator; ``count(name, n)`` adds ``n`` to a count of the innermost span
open on the calling thread. A span has two outputs, each on by itself:

* the in-memory record, while ``enable(True)``: one ``Record`` per span
  that closes, with its start and end on ``time.time_ns()``, its parent,
  the step id of its outermost span, its thread and its counts, kept in a
  buffer of ``CAPACITY`` records that drops the oldest and counts what it
  drops (``dropped``). ``calls``, ``report`` and ``records`` read it when
  the run ends. Host clock: a span that launches device work without
  reading a result back times the launches, not the device work.
  ``enable(cuda_events=True)`` also brackets each span with
  CUDA events on the current stream (``calls`` reads them); with several
  threads on one stream those count the other threads' work too.
* a profiler annotation, while a torch.profiler runs: each span opens a
  ``record_function`` of its name, so the spans appear as
  ``user_annotation`` events in the profiler's trace. A Chrome trace's
  ``baseTimeNanoseconds + ts * 1000`` reads ``time.time_ns()``'s clock, so
  a span's annotation lies inside the record's ``[start_ns, end_ns]``.

With neither on, a span checks one module flag and the profiler's flag
and does nothing else.
"""

from __future__ import annotations

import collections
import functools
import itertools
import threading
import time
from typing import Dict, List, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

CAPACITY = 1 << 18  # records kept; ``reset`` applies a new value

_enabled = False
_events = False
_lock = threading.Lock()
_records: collections.deque = collections.deque(maxlen=CAPACITY)
_dropped = 0
_local = threading.local()
_ids = itertools.count(1)
_steps = itertools.count(1)


if hasattr(_autograd_profiler, "_is_profiler_enabled"):
    def _profiling() -> bool:
        return _autograd_profiler._is_profiler_enabled
else:  # torch releases without the Python-side flag
    _profiling = torch._C._autograd._profiler_enabled


class Record:
    """One span: ``id`` and ``parent`` (the enclosing span's id, or None),
    ``step`` (shared by every span under one outermost span), ``thread``
    (``threading.get_native_id()``, the profiler trace's ``tid``), start
    and end in ns on ``time.time_ns()``, ``child_ns`` (the time its child
    spans cover), ``counts``, and the CUDA events or None."""

    __slots__ = ("name", "id", "parent", "step", "thread", "start_ns", "end_ns", "child_ns",
                 "counts", "ev0", "ev1")

    @property
    def self_ns(self) -> int:
        return self.end_ns - self.start_ns - self.child_ns


def enable(on: bool = True, cuda_events: bool = False):
    global _enabled, _events
    _enabled, _events = on, on and cuda_events


def _event():
    if not _events:
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
        _local.thread = threading.get_native_id()  # a system call: once a thread
    return stack


def _open(name: str) -> Record:
    stack = _stack()
    rec = Record()
    parent = stack[-1] if stack else None
    rec.name, rec.id = name, next(_ids)
    rec.parent = parent.id if parent is not None else None
    rec.step = parent.step if parent is not None else next(_steps)
    rec.thread = _local.thread
    rec.child_ns, rec.counts, rec.end_ns, rec.ev1 = 0, {}, 0, None
    rec.ev0 = _event()
    stack.append(rec)
    rec.start_ns = time.time_ns()
    return rec


def _close(rec: Record):
    global _dropped
    rec.end_ns = time.time_ns()
    rec.ev1 = _event() if rec.ev0 is not None else None
    stack = _stack()
    if stack and stack[-1] is rec:
        stack.pop()
    elif rec in stack:  # a span closed out of order (a generator's body)
        stack.remove(rec)
    if stack:
        stack[-1].child_ns += rec.end_ns - rec.start_ns
    with _lock:
        if len(_records) == _records.maxlen:
            _dropped += 1
        _records.append(rec)


class span:
    """A named region: ``with span(name):`` or ``@span(name)``. Recorded
    while enabled, annotated while a profiler runs (see the module note)."""

    __slots__ = ("name", "_rec", "_rf")

    def __init__(self, name: str):
        self.name = name
        self._rec = self._rf = None

    def __enter__(self):
        if _enabled:
            self._rec = _open(self.name)
        if _profiling():
            self._rf = _autograd_profiler.record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        if self._rec is not None:
            _close(self._rec)
            self._rec = None

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return wrapper


def count(name: str, n: int = 1):
    """Add ``n`` to the count ``name`` of the innermost span open on this
    thread (nothing while disabled or with no span open)."""
    if not _enabled:
        return
    stack = _stack()
    if stack:
        counts = stack[-1].counts
        counts[name] = counts.get(name, 0) + n


def records() -> List[Record]:
    """The kept records, in the order their spans closed."""
    with _lock:
        return list(_records)


def dropped() -> int:
    """Records the full buffer dropped since the last ``reset``."""
    return _dropped


def calls(name: str) -> List[Tuple[float, float]]:
    """(host ms, CUDA-event ms or nan) of every recorded call of ``name``,
    in the order they ended."""
    out = []
    for r in records():
        if r.name != name:
            continue
        dev_ms = float("nan")
        if r.ev0 is not None and r.ev1 is not None:
            r.ev1.synchronize()
            dev_ms = r.ev0.elapsed_time(r.ev1)
        out.append(((r.end_ns - r.start_ns) * 1e-6, dev_ms))
    return out


def report() -> str:
    """Per span name: total, calls, mean, self time (less the child spans)
    and the counts made in it; then the records dropped, if any."""
    totals: Dict[str, list] = {}
    for r in records():
        t = totals.setdefault(r.name, [0, 0, 0, collections.Counter()])
        t[0] += r.end_ns - r.start_ns
        t[1] += 1
        t[2] += r.self_ns
        t[3].update(r.counts)
    lines = []
    for name in sorted(totals):
        total, n, self_ns, counts = totals[name]
        line = (f"{name}: total {total * 1e-6:.1f} ms, calls {n}, avg {total / n * 1e-6:.2f} ms, "
                f"self {self_ns * 1e-6:.1f} ms")
        lines.append(line + "".join(f", {k} {v}" for k, v in sorted(counts.items())))
    if _dropped:
        lines.append(f"({_dropped} records dropped)")
    return "\n".join(lines)


def reset():
    """Drop every record and the drop count; apply ``CAPACITY``."""
    global _records, _dropped
    with _lock:
        _records = collections.deque(maxlen=CAPACITY)
        _dropped = 0


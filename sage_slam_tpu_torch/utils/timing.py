"""Host-side tic/toc profiling and device trace helpers (port of
sage_slam_tpu/utils/timing.py).

A global name -> per-call wall-clock record, enabled at runtime (the
reference gates it on --enable_timing). Host clock: a region that launches
device work without reading a result back measures the launches, not the
device time. ``enable(cuda_events=True)`` also brackets each region with
CUDA events on the current stream (``calls`` reads them); with several
threads on one stream those count the other threads' work too. For device
time by kernel, ``trace()`` records a torch.profiler trace (Chrome trace
JSON written into ``log_dir``) and ``annotate()`` names a region in it.
``timed(name)`` is a context manager and a function decorator.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Tuple

_enabled = False
_events = False
_lock = threading.Lock()
_starts: Dict[str, tuple] = {}
# per call: (host seconds, start event, stop event); the events are None
# unless enabled with cuda_events
_calls: Dict[str, List[tuple]] = defaultdict(list)


def enable(on: bool = True, cuda_events: bool = False):
    global _enabled, _events
    _enabled, _events = on, on and cuda_events


def _event():
    if not _events:
        return None
    import torch

    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def tic(name: str):
    if not _enabled:
        return
    ev = _event()
    with _lock:
        _starts[name] = (time.perf_counter(), ev)


def toc(name: str):
    if not _enabled:
        return
    now = time.perf_counter()
    ev = _event()
    with _lock:
        start = _starts.pop(name, None)
        if start is not None:
            _calls[name].append((now - start[0], start[1], ev))


@contextlib.contextmanager
def timed(name: str):
    tic(name)
    try:
        yield
    finally:
        toc(name)


def calls(name: str) -> List[Tuple[float, float]]:
    """(host ms, CUDA-event ms or nan) of every recorded call of ``name``,
    in the order they ended."""
    with _lock:
        runs = list(_calls.get(name, ()))
    out = []
    for host_s, start, stop in runs:
        dev_ms = float("nan")
        if start is not None and stop is not None:
            stop.synchronize()
            dev_ms = start.elapsed_time(stop)
        out.append((host_s * 1e3, dev_ms))
    return out


def report() -> str:
    with _lock:
        lines = []
        for name in sorted(_calls):
            n = len(_calls[name])
            total = sum(c[0] for c in _calls[name])
            lines.append(f"{name}: total {total*1e3:.1f} ms, calls {n}, avg {total/max(n,1)*1e3:.2f} ms")
    return "\n".join(lines)


def reset():
    with _lock:
        _starts.clear()
        _calls.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a torch.profiler trace of the block (CPU and, where there is
    one, the CUDA device) into ``log_dir/trace.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named region visible in device traces."""
    from torch.profiler import record_function

    return record_function(name)

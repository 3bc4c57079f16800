"""A traced sub-window: torch.profiler over a few steady steps of the timed
path, read back from its Chrome trace.

The profiler on the card has returned traces that miss events (see
PERF.md), so each driver checks its trace against what the run itself
counted (for the BA cell, one K1 launch for every LM iteration the solver
reported) and profiles again once when the check fails; the K1 reader reads nothing from a trace that fails it.

Device operations are the trace's kernels, copies and sets. The traced
window is the span of the ``benchmark.window`` annotation, which the driver
closes after a device synchronisation, so every operation it launched lies
inside it.
"""

from __future__ import annotations

import json
import os
import tempfile

WINDOW = "benchmark.window"
STEP = "benchmark.step"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 160  # a kernel's templated name is cut to this many characters


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, start: float, end: float):
    """(gap start, gap end) of every stretch of [start, end] that no
    interval covers, longest first."""
    gaps = []
    t = start
    for s, e in sorted(intervals):
        if s > t:
            gaps.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        gaps.append((t, end))
    return sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])


class Traced:
    """One profiled sub-window (times in microseconds, as the trace has them)."""

    def __init__(self, events: list):
        self.events = events
        windows = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"]
        if not windows:
            raise ValueError(f"trace has no {WINDOW!r} annotation")
        w = max(windows, key=lambda e: e["dur"])
        self.start, self.end = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.device_ops = [
            e for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
            and self.start <= float(e["ts"]) <= self.end
        ]

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def intervals(self):
        return [(float(e["ts"]), min(float(e["ts"]) + float(e["dur"]), self.end))
                for e in self.device_ops]

    @property
    def busy_s(self) -> float:
        return union_length(self.intervals()) * 1e-6

    def kernels(self, substring: str) -> list:
        return [e for e in self.device_ops if e.get("cat") == "kernel" and substring in e["name"]]

    def top_ops(self, k: int = 10):
        """[[kernel name, seconds]] of the k names that took the most device time."""
        by_name: dict = {}
        for e in self.device_ops:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"]) * 1e-6
        return [[n[:NAME_CHARS], s] for n, s in sorted(by_name.items(), key=lambda x: -x[1])[:k]]

    def top_gaps(self, k: int = 10):
        """[[what the host was doing, seconds]] of the k longest idle gaps:
        the innermost host operation open at the gap's middle."""
        host = [e for e in self.events if e.get("ph") == "X"
                and e.get("cat") in ("cpu_op", "cuda_runtime", "user_annotation", "python_function")
                and e.get("name") not in (WINDOW, STEP)]
        out = []
        for s, e in idle_gaps(self.intervals(), self.start, self.end)[:k]:
            mid = 0.5 * (s + e)
            open_ops = [h for h in host if float(h["ts"]) <= mid <= float(h["ts"]) + float(h["dur"])]
            name = min(open_ops, key=lambda h: float(h["dur"]))["name"] if open_ops else "host (no op open)"
            out.append([name[:NAME_CHARS], (e - s) * 1e-6])
        return out


def profile(fn, *, sync):
    """Run ``fn()`` under torch.profiler inside the WINDOW annotation,
    synchronising before the annotation closes -> Traced (the trace file,
    written under TMPDIR, is read and deleted)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile, record_function

    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            fn()
            sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    del prof
    torch.cuda.synchronize()
    return Traced(events)

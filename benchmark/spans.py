"""The program's spans in a traced sub-window: each device operation is
charged to the spans open on the host thread that launched it.

The program marks its layers with ``record_function`` annotations (the
``user_annotation`` events of the Chrome trace) while a profiler runs. A
device operation (a kernel, copy or set) carries the ``correlation`` id of
the ``cuda_runtime`` or ``cuda_driver`` call that launched it; that call's
host time and thread give the annotations open at the launch, outermost
first. The spans read here are those of the BA step: ``ba.run_ba`` per
step, ``lm.iter`` per LM iteration, and the layers inside them.

``attribution(ctx)`` reads nothing (None) where the trace cannot be trusted,
as the K1 reader does: no trace, an ``lm.iter`` count other than the LM
iterations the solver reported (``traced_iters``), or a device operation
inside a ``ba.run_ba`` span whose launch event is missing (the profiler has
lost events on the card). A program without these spans reads nothing.
"""

from __future__ import annotations

import collections
import functools

from benchmark import trace

STEP_SPAN = "ba.run_ba"
ITER_SPAN = "lm.iter"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _x(events, cats):
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cats]


class Attribution:
    """The device operations of one traced window with the program spans
    open at their launch (times in microseconds, as the trace has them)."""

    def __init__(self, traced):
        launches = {e["args"]["correlation"]: e for e in _x(traced.events, LAUNCH_CATS)
                    if "correlation" in e.get("args", {})}
        self.spans = [e for e in _x(traced.events, ("user_annotation",))
                      if e["name"] not in (trace.WINDOW, trace.STEP)
                      and traced.start <= float(e["ts"]) <= traced.end]
        self.steps = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                      for e in self.spans if e["name"] == STEP_SPAN]
        self.iters = sum(e["name"] == ITER_SPAN for e in self.spans)
        self.device_ops = traced.device_ops
        self.lost = 0
        by_thread = collections.defaultdict(list)
        for s in self.spans:
            by_thread[(s.get("pid"), s.get("tid"))].append(s)
        launched = []  # (launch event, device operation)
        for op in traced.device_ops:
            launch = launches.get(op.get("args", {}).get("correlation"))
            if launch is not None:
                launched.append((launch, op))
            elif self.in_step(float(op["ts"])):
                self.lost += 1
        self.ops = []  # (device operation, names of the spans open at launch)
        groups = collections.defaultdict(list)
        for launch, op in launched:
            groups[(launch.get("pid"), launch.get("tid"))].append((launch, op))
        for key, pairs in groups.items():
            self.ops += open_at(by_thread.get(key, []), pairs)

    def in_step(self, t: float) -> bool:
        return any(s <= t <= e for s, e in self.steps)

    def device_ms(self, inside: str, outside: tuple = ()) -> float:
        """Device ms of the operations launched inside a span ``inside`` and
        outside every span of ``outside``."""
        return sum(float(op["dur"]) for op, names in self.ops
                   if inside in names and not set(outside) & set(names)) * 1e-3

    def launches(self, inside: str) -> int:
        return sum(inside in names for _, names in self.ops)

    def host_ms(self, name: str) -> float:
        """Host ms inside the spans ``name``."""
        return sum(float(s["dur"]) for s in self.spans if s["name"] == name) * 1e-3

    def busy_ms(self) -> float:
        """Device-busy ms inside the ``ba.run_ba`` spans (the union of the
        operations' intervals, clipped to the spans)."""
        clipped = [(max(float(op["ts"]), s), min(float(op["ts"]) + float(op["dur"]), e))
                   for op in self.device_ops for s, e in self.steps]
        return trace.union_length([c for c in clipped if c[1] > c[0]]) * 1e-3


def open_at(spans, pairs):
    """[(device operation, names of the spans open at its launch, outermost
    first)] for (launch, operation) pairs of one thread: a sweep over the
    launches in time order with the spans that have begun and not ended."""
    spans = sorted(spans, key=lambda s: (float(s["ts"]), -float(s["dur"])))
    out, active, i = [], [], 0
    for launch, op in sorted(pairs, key=lambda p: float(p[0]["ts"])):
        t = float(launch["ts"])
        while i < len(spans) and float(spans[i]["ts"]) <= t:
            active.append(spans[i])
            i += 1
        active = [s for s in active if float(s["ts"]) + float(s["dur"]) >= t]
        out.append((op, tuple(s["name"] for s in active)))
    return out


@functools.lru_cache(maxsize=1)
def _attribution(traced) -> Attribution:
    return Attribution(traced)


def attribution(ctx):
    """The traced window's Attribution, or None where it cannot be trusted
    (see the module note)."""
    traced = ctx.get("traced")
    if traced is None:
        return None
    a = _attribution(traced)
    if a.iters == 0 or a.iters != ctx.get("traced_iters") or a.lost:
        return None
    return a

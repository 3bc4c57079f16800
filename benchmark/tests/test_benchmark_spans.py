"""The span readers (benchmark/spans.py and its five metrics) on a
hand-built Chrome trace: two LM iterations of one ``ba.run_ba`` span on one
host thread, an unrelated span on a second thread that launches while the
first has ``graph.scatter_hessian`` open, and a kernel after the step."""

from __future__ import annotations

import pytest

from benchmark import spans, trace

from .test_benchmark_metrics import reader

A, B = 10, 20  # host threads
PROGRAM = [  # (thread, name, start, end) in microseconds
    (A, "ba.run_ba", 100, 1000),
    (A, "lm.iter", 110, 500), (A, "ba.linearize", 120, 300), (A, "graph.scatter_hessian", 200, 280),
    (A, "lm.accept", 300, 350), (A, "lm.solve", 360, 400),
    (A, "lm.iter", 500, 950), (A, "ba.linearize", 510, 700), (A, "graph.scatter_hessian", 600, 680),
    (A, "lm.accept", 700, 780), (A, "lm.solve", 800, 850),
    (B, "loader", 0, 1500),
]
OPS = [  # (correlation, thread, launch time, category, device start, device duration)
    (1, A, 130, "kernel", 140, 10),  # linearize, outside the assembly
    (2, A, 210, "kernel", 215, 20),  # assembly
    (3, A, 220, "kernel", 240, 5),  # assembly
    (4, A, 310, "gpu_memcpy", 320, 2),  # the accept read
    (5, A, 370, "kernel", 372, 30),  # solve
    (6, A, 520, "kernel", 525, 12),  # linearize
    (7, A, 610, "kernel", 612, 22),  # assembly
    (8, A, 810, "kernel", 812, 28),  # solve
    (9, A, 860, "gpu_memset", 862, 3),  # the iteration's own (retract)
    (10, B, 615, "kernel", 640, 50),  # another thread's, while A assembles
    (11, A, 1100, "kernel", 1105, 40),  # after the step
]
EXPECTED = {  # worked out by hand from the tables above, per LM iteration
    "assembly_ms.factors": (20 + 5 + 22) * 1e-3 / 2,
    "linearize_self_ms.factors": (10 + 12) * 1e-3 / 2,
    "solve_ms.factors": (30 + 28) * 1e-3 / 2,
    "host_wait_ms.factors": (50 + 80) * 1e-3 / 2,
    "launches_per_iter.factors": 9 / 2,
}


def events(drop_launch=()):
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "pid": 1, "tid": A, "ts": 0.0,
           "dur": 2000.0}]
    ev += [{"ph": "X", "cat": "user_annotation", "name": n, "pid": 1, "tid": t, "ts": float(s),
            "dur": float(e - s)} for t, n, s, e in PROGRAM]
    for c, t, at, cat, ts, dur in OPS:
        if c not in drop_launch:
            name = {"kernel": "cudaLaunchKernel", "gpu_memcpy": "cudaMemcpyAsync",
                    "gpu_memset": "cudaMemsetAsync"}[cat]
            ev.append({"ph": "X", "cat": "cuda_runtime", "name": name, "pid": 1, "tid": t,
                       "ts": float(at), "dur": 3.0, "args": {"correlation": c}})
        ev.append({"ph": "X", "cat": cat, "name": f"op{c}", "pid": 0, "tid": 7, "ts": float(ts),
                   "dur": float(dur), "args": {"correlation": c}})
    return ev


def ctx(drop_launch=(), traced_iters=2):
    return {"traced": trace.Traced(events(drop_launch)), "traced_iters": traced_iters}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_the_value_worked_out_by_hand(name):
    assert reader(name).read(ctx()) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
@pytest.mark.parametrize("case", ["lost launch", "iterations differ", "empty ctx", "no spans"])
def test_reader_reads_nothing_from_a_trace_it_cannot_trust(name, case):
    c = {"lost launch": lambda: ctx(drop_launch=(5,)),
         "iterations differ": lambda: ctx(traced_iters=3),
         "empty ctx": dict,
         "no spans": lambda: {"traced": trace.Traced([e for e in events() if e["name"] == trace.WINDOW
                                                      or e["cat"] != "user_annotation"]),
                              "traced_iters": 2}}[case]()
    assert reader(name).read(c) is None


def test_a_lost_launch_outside_the_step_is_no_fault():
    assert reader("solve_ms.factors").read(ctx(drop_launch=(11,))) == pytest.approx(0.029)


def test_each_operation_gets_the_spans_of_its_own_thread():
    a = spans.attribution(ctx())
    names = {op["name"]: stack for op, stack in a.ops}
    assert names["op2"] == ("ba.run_ba", "lm.iter", "ba.linearize", "graph.scatter_hessian")
    assert names["op9"] == ("ba.run_ba", "lm.iter")
    assert names["op10"] == ("loader",) and names["op11"] == ()
    assert a.iters == 2 and a.lost == 0
    # busy inside [100, 1000]: every operation of thread A's step, and
    # thread B's kernel [640, 690], which overlaps none of them
    assert a.busy_ms() == pytest.approx((10 + 20 + 5 + 2 + 30 + 12 + 22 + 28 + 3 + 50) * 1e-3)


def test_idle_gaps_inside_the_step_are_named_by_a_program_span():
    t = trace.Traced([e for e in events() if e["name"] != "loader"])
    gaps = trace.idle_gaps(t.intervals(), t.start, t.end)
    named = [(g, name) for g, (name, _) in zip(gaps, t.top_gaps(len(gaps)))
             if 100 <= g[0] and g[1] <= 1000]
    assert len(named) >= 5
    assert {name for _, name in named} <= {n for _, n, _, _ in PROGRAM}

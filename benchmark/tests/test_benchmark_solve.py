"""The factorization's spans and its roofline reader (benchmark/solve_bound.py,
metrics/solve_roofline.py) on a hand-built Chrome trace: two LM iterations
whose ``lm.solve`` spans hold ``solve.damp``, ``solve.factor`` and
``solve.tri``, so that every operation of the factor is charged to
``lm.solve`` too."""

from __future__ import annotations

import pytest

from benchmark import solve_bound, spans, trace

from .test_benchmark_metrics import reader

A = 10  # the host thread
PROGRAM = [  # (name, start, end) in microseconds
    ("ba.run_ba", 100, 1000),
    ("lm.iter", 110, 500), ("ba.linearize", 120, 300), ("lm.solve", 360, 460),
    ("solve.damp", 362, 380), ("solve.factor", 380, 430), ("solve.tri", 430, 458),
    ("lm.iter", 500, 950), ("ba.linearize", 510, 700), ("lm.solve", 800, 900),
    ("solve.damp", 802, 820), ("solve.factor", 820, 870), ("solve.tri", 870, 898),
]
OPS = [  # (correlation, launch time, device start, device duration)
    (1, 130, 140, 10),  # linearize
    (2, 370, 372, 4),  # damp
    (3, 390, 400, 300),  # factor
    (4, 400, 700, 200),  # factor
    (5, 440, 900, 20),  # tri
    (6, 520, 925, 12),  # linearize
    (7, 810, 940, 4),  # damp
    (8, 830, 950, 500),  # factor
    (9, 880, 1450, 20),  # tri
]
SHAPES = dict(e_photo=372, e_geo=372, levels=4, c=16, n=3072, dim=29, cs=16, num_kf=64)
PEAKS = (3.35e12, 67e12)


def events(drop_launch=(), names=None):
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "pid": 1, "tid": A, "ts": 0.0,
           "dur": 2000.0}]
    ev += [{"ph": "X", "cat": "user_annotation", "name": n, "pid": 1, "tid": A, "ts": float(s),
            "dur": float(e - s)} for n, s, e in PROGRAM if names is None or n in names]
    for c, at, ts, dur in OPS:
        if c not in drop_launch:
            ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1,
                       "tid": A, "ts": float(at), "dur": 3.0, "args": {"correlation": c}})
        ev.append({"ph": "X", "cat": "kernel", "name": f"op{c}", "pid": 0, "tid": 7, "ts": float(ts),
                   "dur": float(dur), "args": {"correlation": c}})
    return ev


def ctx(drop_launch=(), traced_iters=2, names=None):
    return {"traced": trace.Traced(events(drop_launch, names)), "traced_iters": traced_iters,
            "shapes": SHAPES, "peaks": PEAKS}


def test_the_factor_is_charged_to_lm_solve_too():
    a = spans.attribution(ctx())
    stacks = {op["name"]: names for op, names in a.ops}
    assert stacks["op3"] == ("ba.run_ba", "lm.iter", "lm.solve", "solve.factor")
    parts = [a.device_ms(n) for n in ("solve.damp", "solve.factor", "solve.tri")]
    assert parts == pytest.approx([0.008, 1.0, 0.04])
    assert sum(parts) == pytest.approx(a.device_ms("lm.solve"))
    assert reader("solve_ms.factors").read(ctx()) == pytest.approx(1.048 / 2)


def test_solve_roofline_reads_the_bound_over_the_factor_ms():
    bound_ms = solve_bound.solve_bound(64 * 23, *PEAKS)[0]
    assert reader("solve_roofline").read(ctx()) == pytest.approx(100.0 * bound_ms / 0.5)


@pytest.mark.parametrize("case", ["lost launch", "iterations differ", "no peaks", "no spans",
                                  "no factor span"])
def test_solve_roofline_reads_nothing_it_cannot_trust(case):
    c = {"lost launch": lambda: ctx(drop_launch=(3,)),
         "iterations differ": lambda: ctx(traced_iters=3),
         "no peaks": lambda: {k: v for k, v in ctx().items() if k != "peaks"},
         "no spans": lambda: ctx(names=()),
         # a program whose lm.solve has no spans inside it
         "no factor span": lambda: ctx(names=("ba.run_ba", "lm.iter", "ba.linearize", "lm.solve"))}[case]()
    assert reader("solve_roofline").read(c) is None


@pytest.mark.parametrize("d, kind", [(1472, "operations"), (5888, "operations"), (8, "bytes")])
def test_solve_bound_counts(d, kind):
    ms, got, nbytes, flops = solve_bound.solve_bound(d, *PEAKS)
    assert got == kind and flops == pytest.approx(d ** 3 / 3) and nbytes == 8 * d * d
    assert ms == pytest.approx(max(flops / PEAKS[1], nbytes / PEAKS[0]) * 1e3)

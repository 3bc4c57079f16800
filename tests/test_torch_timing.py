"""The port's span recorder (sage_slam_tpu_torch/utils/timing.py) and its
spans on the BA path, on the CPU: records, parents, step ids, self time and
counts; threads; the bounded buffer; the cost of a span that is off; the
spans as torch.profiler annotations on the record's clock; and the span
tree of one ``run_ba`` step under the CPU profiler."""

import dataclasses
import json
import threading
import time
from collections import Counter, defaultdict

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sage_slam_tpu_torch import synthetic
from sage_slam_tpu_torch.config import SlamConfig
from sage_slam_tpu_torch.solver import ba
from sage_slam_tpu_torch.utils import timing

SLACK_NS = 50_000  # an annotation may lie this far outside its record


@pytest.fixture(autouse=True)
def clean():
    timing.enable(False)
    timing.reset()
    yield
    timing.enable(False)
    timing.reset()


def by_name(recs):
    out = defaultdict(list)
    for r in recs:
        out[r.name].append(r)
    return out


def chrome_trace(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    return data["baseTimeNanoseconds"], data["traceEvents"]


def annotations(events):
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def test_timing_records_each_call():
    """``span`` as a context manager and as a decorator records one (host
    ms, CUDA-event ms) per call in call order (nan without cuda_events);
    ``report`` sums them; nothing is recorded while disabled; ``reset``
    clears."""

    @timing.span("decorated")
    def work(seconds):
        time.sleep(seconds)
        return seconds

    work(0.001)
    assert timing.calls("decorated") == []
    timing.enable(True)
    try:
        assert work(0.02) == 0.02 and work(0.001) == 0.001
        with timing.span("block"):
            time.sleep(0.001)
    finally:
        timing.enable(False)
    runs = timing.calls("decorated")
    assert len(runs) == 2 and runs[0][0] >= 20.0 > runs[1][0] and all(np.isnan(ev) for _, ev in runs)
    assert len(timing.calls("block")) == 1
    lines = timing.report().splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["block", "decorated"] and "calls 2" in lines[1]
    timing.reset()
    assert timing.report() == "" and timing.calls("decorated") == []


def test_nested_spans_have_parents_step_ids_and_self_time():
    timing.enable(True)
    for _ in range(2):
        with timing.span("outer"):
            time.sleep(0.002)
            with timing.span("inner"):
                time.sleep(0.004)
                with timing.span("leaf"):
                    time.sleep(0.001)
            with timing.span("inner"):
                pass
    recs = timing.records()
    names = by_name(recs)
    assert [len(names[n]) for n in ("outer", "inner", "leaf")] == [2, 4, 2]
    assert [r.name for r in recs[:4]] == ["leaf", "inner", "inner", "outer"]  # closing order
    for outer in names["outer"]:
        kids = [r for r in recs if r.parent == outer.id]
        assert [k.name for k in kids] == ["inner", "inner"] and outer.parent is None
        under = [r for r in recs if r.step == outer.step]
        assert len(under) == 4  # the outer span, both inner spans and the leaf
        assert outer.self_ns == outer.end_ns - outer.start_ns - sum(k.end_ns - k.start_ns for k in kids)
        assert outer.self_ns >= 2_000_000
        for r in under:
            assert outer.start_ns <= r.start_ns <= r.end_ns <= outer.end_ns
    assert names["outer"][0].step != names["outer"][1].step
    leaf = names["leaf"][0]
    inner = next(r for r in recs if r.id == leaf.parent)
    assert inner.name == "inner" and inner.child_ns == leaf.end_ns - leaf.start_ns
    assert leaf.self_ns == leaf.end_ns - leaf.start_ns and leaf.thread == threading.get_native_id()


def test_counts_go_to_the_innermost_span_and_the_report():
    timing.count("nowhere")  # no span open: dropped
    timing.enable(True)
    timing.count("nowhere")
    for _ in range(3):
        with timing.span("step"):
            timing.count("iters", 2)
            with timing.span("read"):
                timing.count("host_reads")
    step = by_name(timing.records())["step"]
    assert [r.counts for r in step] == [{"iters": 2}] * 3
    lines = dict(ln.split(": ", 1) for ln in timing.report().splitlines())
    assert set(lines) == {"read", "step"}
    assert lines["step"].startswith("total ") and ", calls 3," in lines["step"]
    assert lines["step"].endswith(", iters 6") and lines["read"].endswith(", host_reads 3")
    assert " self " in lines["step"]


def test_two_threads_in_one_span_name_keep_their_own_durations():
    """Both threads are inside ``same`` at once; a recorder keyed by name
    alone would lose one start and misreport the other."""
    timing.enable(True)
    barrier = threading.Barrier(2, timeout=10)
    sleeps = {"long": 0.15, "short": 0.005}
    threading_names = {}

    def work(kind):
        threading_names[threading.get_native_id()] = kind
        with timing.span("same"):
            barrier.wait()
            time.sleep(sleeps[kind])

    threads = [threading.Thread(target=work, args=(k,), name=k) for k in sleeps]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20)
    assert not any(t.is_alive() for t in threads)
    recs = by_name(timing.records())["same"]
    assert len(recs) == 2 and len({r.thread for r in recs}) == 2 and len({r.step for r in recs}) == 2
    assert all(r.parent is None for r in recs)
    ms = {threading_names[r.thread]: (r.end_ns - r.start_ns) * 1e-6 for r in recs}
    assert 5.0 <= ms["short"] < 150.0 <= ms["long"]


def test_threads_keep_separate_stacks():
    timing.enable(True)
    started, release = threading.Event(), threading.Event()

    def worker():
        with timing.span("worker"):
            started.set()
            release.wait(10)

    t = threading.Thread(target=worker)
    t.start()
    assert started.wait(10)
    with timing.span("main"):
        pass
    release.set()
    t.join(10)
    assert not t.is_alive()
    recs = by_name(timing.records())
    assert recs["main"][0].parent is None and recs["worker"][0].parent is None
    assert recs["main"][0].step != recs["worker"][0].step


def test_a_span_that_is_off_records_nothing_and_enters_no_record_function(monkeypatch):
    made = []

    class Spy(torch.autograd.profiler.record_function):
        def __init__(self, *args, **kwargs):
            made.append(args[0])
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Spy)

    @timing.span("decorated")
    def f():
        return 3

    with timing.span("block"):
        timing.count("n")
    assert f() == 3
    assert made == [] and timing.records() == [] and timing.report() == ""
    with profile(activities=[ProfilerActivity.CPU]):
        with timing.span("block"):
            f()
    assert made == ["block", "decorated"] and timing.records() == []


def test_a_full_buffer_drops_the_oldest_and_counts_the_drop(monkeypatch):
    monkeypatch.setattr(timing, "CAPACITY", 5)
    timing.reset()
    timing.enable(True)
    for i in range(8):
        with timing.span(f"s{i}"):
            pass
    assert [r.name for r in timing.records()] == ["s3", "s4", "s5", "s6", "s7"]
    assert timing.dropped() == 3
    assert timing.report().splitlines()[-1] == "(3 records dropped)"
    timing.reset()
    assert timing.dropped() == 0 and timing.records() == []


def test_a_span_closes_when_its_body_raises():
    timing.enable(True)
    with pytest.raises(ValueError):
        with timing.span("outer"):
            with timing.span("raises"):
                raise ValueError("boom")
    with timing.span("after"):
        pass
    recs = by_name(timing.records())
    assert recs["raises"][0].parent == recs["outer"][0].id
    assert recs["after"][0].parent is None  # the stack was unwound


def test_spans_are_profiler_annotations_inside_their_records(tmp_path):
    timing.enable(True)
    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(6):
            with timing.span(f"span{i}"):
                x = torch.tanh(x @ x)
                with timing.span(f"child{i}"):
                    x = x + 1.0
    base, events = chrome_trace(prof, tmp_path)
    got = {e["name"]: e for e in annotations(events)}
    recs = timing.records()
    assert len(recs) == 12
    for r in recs:
        ann = got[r.name]
        start = base + round(float(ann["ts"]) * 1000)
        end = start + round(float(ann["dur"]) * 1000)
        assert r.start_ns - SLACK_NS <= start <= end <= r.end_ns + SLACK_NS, r.name


def bench_step(iters=3, solver="dense"):
    variables, problem, pyr = synthetic.bench_problem("cpu", k=4, h=32, w=40, cs=4, fs=4, levels=2,
                                                      n=128, n_photo=6, n_geo=6)
    cfg = dataclasses.replace(SlamConfig().mapper, solver=solver)
    mask = torch.ones(4)
    mask[0] = 0.0
    return lambda: ba.run_ba(variables, problem, pyr, cfg, mask, iters)


ITER_KIDS = ["ba.linearize", "lm.accept", "lm.solve", "lm.retract"]
# the dense path's; the Schur path's schur_solve opens its own factor and
# tri spans before the masking's
SOLVE_KIDS = {"dense": ["solve.damp", "solve.factor", "solve.tri"],
              "schur": ["solve.damp", "solve.factor", "solve.tri", "solve.tri"]}
LIN_KIDS = ["lin.photo", "lin.geo", "lin.reproj", "lin.priors"]
BLOCK_KIDS = {"lin.photo": ["graph.scatter_hessian"], "lin.geo": ["graph.scatter_hessian"],
              "lin.reproj": [], "lin.priors": ["graph.scatter_hessian"] * 3}


def test_run_ba_spans_under_the_cpu_profiler(tmp_path):
    """One run_ba step recorded and profiled at once: ``lm.iter`` spans
    number the iterations run_ba returns, the span tree is the BA path's,
    the counts are the problem's, and every ATen op inside ``ba.run_ba``
    lies inside one of its child spans on the same thread."""
    step = bench_step()
    step()  # warm-up (run_ba prepares this unprepared problem in every call: `ba.prepare`)
    timing.enable(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, _, iters, _ = step()
    timing.enable(False)
    assert iters == 3
    recs = timing.records()
    kids = defaultdict(list)
    for r in sorted(recs, key=lambda r: r.start_ns):
        kids[r.parent].append(r)
    [root] = kids[None]
    assert root.name == "ba.run_ba" and root.counts == {"lm.iters": iters}
    assert {r.step for r in recs} == {root.step}
    assert [k.name for k in kids[root.id]] == ["ba.prepare", "lm.init"] + ["lm.iter"] * iters + [
        "ba.total_error"]
    for it in kids[root.id][2:-1]:
        assert [k.name for k in kids[it.id]] == ITER_KIDS
        assert it.counts == {"lm.accepted": 1} or it.counts == {"lm.rejected": 1}
        lin = kids[it.id][0]
        assert [k.name for k in kids[lin.id]] == LIN_KIDS
        for block in kids[lin.id]:
            assert [k.name for k in kids[block.id]] == BLOCK_KIDS[block.name]
        assert [k.counts.get("edges") for k in kids[lin.id]] == [6, 6, None, None]
        assert kids[it.id][1].counts == {"lm.host_reads": 1}
        solve = kids[it.id][2]
        assert [k.name for k in kids[solve.id]] == SOLVE_KIDS["dense"]
    entries = Counter()
    for r in recs:
        entries.update(r.counts)
    # E·S·S entries placed: photo S=17, geo S=22, the code, scale and pose priors of 4 keyframes
    assert entries["entries"] == iters * (6 * (13 + 4) ** 2 + 6 * (14 + 8) ** 2 + 4 * (4**2 + 1 + 6**2))
    assert entries["lm.host_reads"] == iters + 1

    _, events = chrome_trace(prof, tmp_path)
    ann = annotations(events)
    assert Counter(a["name"] for a in ann) == Counter(r.name for r in recs)
    [run] = [a for a in ann if a["name"] == "ba.run_ba"]
    t0, t1 = float(run["ts"]), float(run["ts"]) + float(run["dur"])
    inner = [a for a in ann if a is not run and a["tid"] == run["tid"]]
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"
           and e["name"].startswith("aten::") and e["tid"] == run["tid"]
           and t0 <= float(e["ts"]) <= t1]
    assert len(ops) > 100
    uncovered = [e["name"] for e in ops if not any(
        float(a["ts"]) <= float(e["ts"]) and float(e["ts"]) + float(e["dur"]) <= float(a["ts"]) + float(a["dur"])
        for a in inner)]
    assert uncovered == []


@pytest.mark.parametrize("solver", ["dense", "schur"])
def test_the_solve_spans_cover_lm_solve(tmp_path, solver):
    """On both solver paths ``lm.solve`` holds ``solve.damp``, ``solve.factor``
    and ``solve.tri``; every ATen op inside an ``lm.solve`` annotation lies
    inside one of its ``solve.*`` annotations, so the three spans' device
    time adds up to ``lm.solve``'s."""
    step = bench_step(iters=2, solver=solver)
    step()
    timing.enable(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, _, iters, _ = step()
    timing.enable(False)
    recs = timing.records()
    kids = defaultdict(list)
    for r in sorted(recs, key=lambda r: r.start_ns):
        kids[r.parent].append(r)
    solves = by_name(recs)["lm.solve"]
    assert len(solves) == iters == 2
    for solve in solves:
        assert [k.name for k in kids[solve.id]] == SOLVE_KIDS[solver]
        assert all(not kids[k.id] for k in kids[solve.id])

    _, events = chrome_trace(prof, tmp_path)
    ann = annotations(events)
    inner = [a for a in ann if a["name"].startswith("solve.")]
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"
           and e["name"].startswith("aten::")
           and any(a["name"] == "lm.solve" and a["tid"] == e["tid"]
                   and float(a["ts"]) <= float(e["ts"]) <= float(a["ts"]) + float(a["dur"])
                   for a in ann)]
    assert any(e["name"] == "aten::linalg_cholesky_ex" for e in ops)
    uncovered = [e["name"] for e in ops if not any(
        a["tid"] == e["tid"] and float(a["ts"]) <= float(e["ts"])
        and float(e["ts"]) + float(e["dur"]) <= float(a["ts"]) + float(a["dur"]) for a in inner)]
    assert uncovered == []

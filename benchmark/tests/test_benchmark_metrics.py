"""Each metric's arithmetic on known inputs."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import harness, peaks, trace

from .conftest import REPO


def reader(name):
    return harness.load_module(REPO / "benchmark" / "metrics" / f"{name}.py", "m_" + name.replace(".", "_"))


def synthetic_trace(kernels, window=(0.0, 1000.0), steps=()):
    """A Chrome trace: the window annotation, kernels (name, ts, dur) and
    step annotations (ts, dur), times in microseconds."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": window[0],
           "dur": window[1] - window[0]}]
    ev += [{"ph": "X", "cat": "kernel", "name": n, "ts": t, "dur": d} for n, t, d in kernels]
    ev += [{"ph": "X", "cat": "user_annotation", "name": trace.STEP, "ts": t, "dur": d} for t, d in steps]
    ev += [{"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 300.0, "dur": 250.0}]
    return trace.Traced(ev)


def test_idle_share_of_a_synthetic_timeline():
    t = synthetic_trace([("a", 100.0, 100.0), ("b", 150.0, 100.0), ("c", 600.0, 80.0),
                         ("outside", 2000.0, 10.0)], steps=[(0.0, 400.0), (400.0, 600.0)])
    assert t.busy_s == pytest.approx(230e-6)  # [100, 250] and [600, 680]
    assert t.window_s == pytest.approx(1e-3)
    assert reader("device_idle_pct.factors").read({"traced": t}) == pytest.approx(77.0)
    assert t.top_gaps(1) == [["aten::item", pytest.approx(350e-6)]]
    assert [g[1] for g in t.top_gaps(10)] == pytest.approx([350e-6, 320e-6, 100e-6])
    assert t.top_ops(1) == [["a", pytest.approx(100e-6)]]


@pytest.mark.parametrize("e, bound_ms", [(24, 0.02775552), (48, 0.05551104)])
def test_frozen_k1_bound(e, bound_ms):
    ms, kind, in_bytes, out_bytes, flops = peaks.k1_bound(e, 4, 16, 3072, 29, 3.35e12, 67e12)
    assert kind == "bytes"
    assert ms == pytest.approx(bound_ms, rel=1e-9)


def test_k1_roofline_reads_only_a_complete_trace():
    shapes = dict(e_photo=24, e_geo=24, levels=4, c=16, n=3072, dim=29, cs=16, num_kf=8)
    kernels = [("photo_reduce_split(float const*)", 10.0 * i, 40.0) for i in range(3)]
    kernels += [("photo_reduce_combine(float const*)", 10.0 * i + 50.0, 15.0) for i in range(3)]
    ctx = {"traced": synthetic_trace(kernels), "shapes": shapes, "peaks": (3.35e12, 67e12),
           "traced_iters": 3}
    k1 = reader("k1_roofline")
    assert k1.read(ctx) == pytest.approx(100.0 * 0.02775552 / 0.055)
    assert k1.read(dict(ctx, traced_iters=4)) is None


def test_mfu_from_counted_flops():
    shapes = dict(e_photo=372, e_geo=372, levels=4, c=16, n=3072, dim=29, cs=16, num_kf=64)
    per_iter = peaks.lm_iteration_flops(372, 372, 4, 16, 3072, 16, 64)
    ctx = {"shapes": shapes, "peaks": (3.35e12, 67e12), "lm_iters": 100, "window_s": 2.0}
    assert reader("mfu_pct.factors").read(ctx) == pytest.approx(100.0 * per_iter * 50 / 67e12)
    d = 23 * 64
    assert per_iter > d ** 3 / 3

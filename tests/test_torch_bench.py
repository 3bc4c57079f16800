"""The port's measuring programs (sage_slam_tpu_torch/bench/, entry.py)
against the repo's JAX programs (bench.py, bench_roofline.py,
bench_frontend.py, bench_scaling.py, __graft_entry__.py), on the CPU.

* entry()'s step against __graft_entry__.entry()'s (error rtol 1e-4, the
  same LM decision) and both against the step in float64 (variables atol
  2e-6, test_torch_ba.py's run_ba tolerance);
* the roofline model and its sol_* / pct_* numbers, and growth_curve's
  edge sets and compact ids, against the JAX programs' own lines of
  arithmetic, read from their source and run on the same inputs;
* every program's measurements once at a small size on the CPU, printing
  the JAX program's metric names (read from its source) and returning the
  LM iterations their steps ran; each main's argv and device handling
  with the measurements stubbed; entry's main with dryrun_multichip on
  two gloo ranks; the entry points raise without CUDA;
* the frontend's keyframe decisions on a short Bowl3D orbit equal JAX's
  loop's, with the port's seeded weights handed to JAX and JAX's sample
  ids injected into the port (as tests/test_torch_error_budget.py does).
"""

import dataclasses
import json
import math
import re
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from sage_slam_tpu import config as jconfig
from sage_slam_tpu.eval import error_budget as jeb
from sage_slam_tpu.io.dataset import Bowl3DInterface as JBowl3D
from sage_slam_tpu.models import depth_network as jdn
from sage_slam_tpu.models import feature_network as jfn
from sage_slam_tpu_torch import convert, entry
from sage_slam_tpu_torch.bench import frontend, global_ba, roofline, scaling
from sage_slam_tpu_torch.config import MapperConfig
from sage_slam_tpu_torch.models import depth_network as tdn
from sage_slam_tpu_torch.models import feature_network as tfn
from sage_slam_tpu_torch.ops import photo_reduce as pr
from sage_slam_tpu_torch.solver import ba as tba
from tests.test_torch_error_budget import DEPTH, FEAT, _inject_jax_ids
from tests.test_torch_slam import _port_init

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _jax_lines(script: str, first: str, stop: str) -> str:
    """The lines of a JAX program from the one holding ``first`` up to,
    not including, the next one holding ``stop``, dedented."""
    lines = (ROOT / script).read_text().splitlines()
    a = next(i for i, line in enumerate(lines) if first in line)
    b = next(i for i in range(a + 1, len(lines)) if stop in lines[i])
    return textwrap.dedent("\n".join(lines[a:b]))


def _jax_metric_names(script: str) -> set:
    return set(re.findall(r'"metric": "(\w+)"', (ROOT / script).read_text()))


def _lines(capsys) -> list:
    return [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]


def _float64(tree):
    return jax.tree.map(lambda t: t.double() if isinstance(t, torch.Tensor) and t.is_floating_point()
                        else t, tree)


def test_entry_step_matches_jax(monkeypatch):
    """entry()'s step (one LM iteration) against __graft_entry__.entry()'s:
    the same iterations and accept decision, the error at rtol 1e-4. The
    two float32 steps differ by up to 2.5e-6 in translation, on JAX's own
    inputs too (sum-order roundoff through the damped solve; a 1-ulp
    perturbation of the features moves JAX's step by 3e-7), so each
    package's variables are held at atol 2e-6 to the same step in float64
    (the port's run_ba on JAX's inputs with the plain reduce), a reference
    without float32 roundoff."""
    fn_j, args_j = graft.entry()
    v_j, e_j, it_j, conv_j = jax.jit(fn_j)(*args_j)
    fn, args = entry.entry(device="cpu")
    v, e, it, conv = fn(*args)
    assert (it, conv) == (int(it_j), bool(conv_j))
    np.testing.assert_allclose(float(e), float(e_j), rtol=1e-4)

    monkeypatch.setattr(tba, "photo_reduce", lambda *a: pr.photo_reduce_ref(*a[:7]))
    v0, p0, pyr = graft._build_problem()
    v64, _, it64, _ = tba.run_ba(
        _float64(convert.variables_from_numpy(jax.tree.map(np.asarray, v0), device="cpu")),
        _float64(convert.problem_from_numpy(jax.tree.map(np.asarray, p0), device="cpu")),
        convert.camera_pyramid_from_numpy(pyr), MapperConfig(), torch.ones(4, dtype=torch.float64),
        max_iters=1)
    assert it64 == it
    for name, a, b, r in (("rot", v.pose.rot, v_j.pose.rot, v64.pose.rot),
                          ("trans", v.pose.trans, v_j.pose.trans, v64.pose.trans),
                          ("code", v.code, v_j.code, v64.code), ("scale", v.scale, v_j.scale, v64.scale)):
        np.testing.assert_allclose(a.numpy(), r.numpy(), atol=2e-6, err_msg=f"port {name}")
        np.testing.assert_allclose(np.asarray(b), r.numpy(), atol=2e-6, err_msg=f"JAX {name}")


def test_entry_main_runs_dryrun_multichip_on_gloo(capsys):
    out, (edge_ranks, store_ranks) = entry.main(["--device", "cpu", "--ranks", "2"])
    text = capsys.readouterr().out
    assert "entry OK:" in text and "dryrun_multichip OK" in text
    assert json.loads(text.splitlines()[0]) == {"program": "entry", "device": "cpu", "card": None}
    for ranks in (edge_ranks, store_ranks):
        assert [r["backend"] for r in ranks] == ["gloo", "gloo"]
        assert all(math.isfinite(r["error"]) for r in ranks)
        np.testing.assert_array_equal(ranks[0]["trans"].numpy(), ranks[1]["trans"].numpy())


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.entry()
    for main in (global_ba.main, roofline.main, frontend.main, scaling.main, entry.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main([])


def test_roofline_model_and_derived_numbers_match_jax():
    """bench_roofline.py's model and derived lines run on given rates and
    a given ms per LM iteration: the same numbers."""
    rates = {"stream_GBps_rw": 2871.3, "matmul_f32_TFLOPs": 51.7, "gather_ns_per_row": 0.41,
             "gather_effective_GBps": 1912.6}
    for iter_ms in (18.93, 2.5):
        ns = {"out": dict(rates), "iter_ms": iter_ms}
        exec(_jax_lines("bench_roofline.py", "photo_rows = 24 * 3072", "print(json.dumps(out"), ns)
        want = {k: v for k, v in ns["out"].items() if k not in rates}
        assert roofline.derive(rates, roofline.model(), iter_ms) == want


def test_growth_curve_graph_matches_jax():
    for k in (8, 16):
        ns = {"k": k, "window_size": 8}
        exec(_jax_lines("bench_scaling.py", "pairs = []", "def table(ps)"), ns)
        exec(_jax_lines("bench_scaling.py", "ids = sorted(", "kc = len(ids)"), ns)
        assert scaling.growth_pairs(k) == (ns["pairs"], ns["win_pairs"], ns["ids"])


CPU = torch.device("cpu")


def _printed(record: dict, *extra) -> dict:
    """A returned record less the keys that are returned but not printed."""
    return {k: v for k, v in record.items() if k not in extra}


def test_global_ba_prints_bench_metrics(capsys):
    out = global_ba.run(CPU, reps=1, samples=128)
    assert _lines(capsys) == [_printed(r, "lm_iterations") for r in out]
    assert {r["metric"] for r in out} == _jax_metric_names("bench.py")
    for r in out:
        assert set(_printed(r, "lm_iterations")) == {"metric", "value", "unit", "vs_baseline"}
        assert r["unit"] == "factors/s"
        # vs_baseline is rounded from the unrounded rate
        assert r["value"] > 0 and abs(r["vs_baseline"] - r["value"] / 24.0) <= 0.005 + 1e-9
    # a warm-up step and one timed step, at 1 and at up to 10 LM iterations
    assert out[0]["lm_iterations"] == 2 and 2 <= out[1]["lm_iterations"] <= 20


def test_roofline_prints_bench_roofline_keys(capsys):
    out = roofline.run(CPU, stream_bytes=4 << 20, matmul=64, reps=1, samples=128)
    assert _lines(capsys) == [_printed(out, "lm_iterations")]
    jax_keys = set(re.findall(r'out\["(\w+)"\]', (ROOT / "bench_roofline.py").read_text()))
    assert jax_keys | {"backend", "matmul_precision", "lm_iterations"} == set(out)
    assert out["backend"] == "cpu" and 4 <= out["lm_iterations"] <= 22
    # rates and times rounded as the JAX program rounds them: the CPU's
    # small float32 matmul rate and the derived shares may round to 0 on a
    # loaded host
    assert all(out[k] > 0 for k in ("stream_GBps_rw", "gather_ns_per_row", "gather_effective_GBps",
                                    "factors_per_second_1iter", "factors_per_second_10iter",
                                    "ba_iter_ms"))
    assert all(math.isfinite(v) and v >= 0 for k, v in out.items() if k not in ("backend", "matmul_precision"))


def test_scaling_prints_bench_scaling_metrics(capsys):
    meshes = scaling.scaling(2, "cpu", reps=1, samples=128)
    rows = scaling.growth_curve(CPU, [8, 16], reps=1, samples=128)
    lines = _lines(capsys)
    assert lines == [_printed(r, "ranks") for r in meshes] + [_printed(r, "lm_iterations") for r in rows]
    assert {r["metric"] for r in lines} == _jax_metric_names("bench_scaling.py")
    assert [r["devices"] for r in meshes] == [1, 2]
    assert meshes[0]["scaling_efficiency"] == 1.0
    for r in meshes:
        assert [x["photo_edges"] for x in r["ranks"]] == [64 // r["devices"]] * r["devices"]
        # a warm-up step and one timed step of 1 LM iteration; the plain
        # reduce on the CPU launches no kernel
        assert [(x["lm_iterations"], x["launches"]) for x in r["ranks"]] == [(2, 0)] * r["devices"]
    assert [r["keyframes"] for r in rows] == [8, 16]
    assert [r["compact_keyframes"] for r in rows] == [8, 10]
    assert [(r["windowed_edges"], r["full_edges"]) for r in rows] == [(28, 28), (36, 64)]
    assert [r["lm_iterations"] for r in rows] == [6, 6]
    assert all(r[k] > 0 for r in rows for k in ("windowed", "full", "compact"))


def _stub(calls: list, name: str, result):
    def fn(*args, **kwargs):
        calls.append((name, args, kwargs))
        return result
    return fn


# each main's arguments, the calls it must make and what it returns
MAINS = {
    "global_ba": (["--device", "cpu"], [("run", (CPU,), {})]),
    "roofline": (["--device", "cpu"], [("run", (CPU,), {})]),
    "frontend": (["--device", "cpu", "--frames", "8"],
                 [("setup", (8,), {"device": CPU}), ("run", ("system", "data"), {})]),
    "scaling": (["--cpu", "2", "--growth-max", "16"],
                [("scaling", (2, "cpu"), {}), ("growth_curve", (CPU, [8, 16]), {})]),
}


@pytest.mark.parametrize("program", sorted(MAINS))
def test_main_reads_argv_and_device(program, monkeypatch, capsys):
    """Each main's argv and device handling, with the measurements stubbed
    (run above at small sizes): the device line first, then the calls."""
    module = {"global_ba": global_ba, "roofline": roofline, "frontend": frontend, "scaling": scaling}[program]
    argv, want = MAINS[program]
    calls = []
    for name, _, _ in want:
        result = ("system", "data") if name == "setup" else name
        monkeypatch.setattr(module, name, _stub(calls, name, result))
    out = module.main(argv)
    assert _lines(capsys) == [{"program": program, "device": "cpu", "card": None}]
    assert calls == want
    assert out == ({"scaling": "scaling", "growth": "growth_curve"} if program == "scaling" else "run")


# ---------------------------------------------------------------------------
# the frontend on a short orbit: 10 frames at 64x80 input (32x40 output),
# narrow networks (test_torch_error_budget.py's), net depth prior,
# handcrafted features, 6 warm-up frames as bench_frontend.py

ORBIT = dict(num_frames=10, height=64, width=80)


def _jax_frontend():
    """bench_frontend.py's system and loop in the JAX package on the
    port's seeded weights -> (system, every frame's new_keyframe)."""
    h, w = ORBIT["height"], ORBIT["width"]
    data = JBowl3D(**ORBIT, seed=0, orbit_radius=0.22, rot_amp=0.25, mask_margin=6,
                   orbits=max(1.0, ORBIT["num_frames"] / 64.0))
    cfg = jconfig.SlamConfig(net_input_size=(h, w), net_output_size=(h // 2, w // 2), max_keyframes=64,
                             loop=jconfig.LoopConfig(global_active_window=6))
    key = jax.random.key(0)
    dcfg, fcfg = jdn.DepthNetConfig(**DEPTH), jfn.FeatureNetConfig(**FEAT)
    system = jeb.build_system(cfg, data, "net", "handcrafted",
                              depth_params=_port_init(jdn, tdn, 0)(key, dcfg),
                              feat_params=_port_init(jfn, tfn, 1)(key, fcfg), depth_cfg=dcfg,
                              feat_cfg=fcfg)
    frames = list(data.frames())
    system.bootstrap(frames[0].timestamp, jnp.asarray(frames[0].image))
    return system, [system.process_frame(f.timestamp, jnp.asarray(f.image)).new_keyframe
                    for f in frames[1:]]


def test_frontend_keyframe_decisions_match_jax(capsys):
    jsys, want = _jax_frontend()
    td = tdn.init_network(torch.Generator().manual_seed(0), tdn.DepthNetConfig(**DEPTH))
    tf = tfn.init_network(torch.Generator().manual_seed(1), tfn.FeatureNetConfig(**FEAT))
    tsys, data = frontend.setup(**ORBIT, device="cpu", depth_net=td, feat_net=tf)
    assert dataclasses.asdict(tsys.cfg) == dataclasses.asdict(jsys.cfg)
    _inject_jax_ids(tsys, jsys)
    got = frontend.run(tsys, data)
    assert got["decisions"] == want and any(want)
    kf_lines = sum(want[frontend.WARMUP:])
    names = {r["metric"] for r in got["records"]}
    assert names == _jax_metric_names("bench_frontend.py") - (set() if kf_lines else
                                                              {"frontend_keyframe_overhead_ms"})
    whole = got["records"][-1]
    assert (whole["frames"], whole["keyframes"]) == (ORBIT["num_frames"] - 1 - frontend.WARMUP, kf_lines)
    assert all("vs_baseline" not in r and r["value"] > 0 for r in got["records"])
    assert [json.loads(line) for line in capsys.readouterr().out.splitlines()] == got["records"]

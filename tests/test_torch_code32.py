"""A 32-dimensional depth code (the ``refine_map64_cs32`` configuration):
the configuration file, the kernels' width picks, the full-graph step at
CS = 16 and CS = 32 against the benchmark's plain reference and against the
JAX package, the new cell's manifest entry, and its two new readers
(``prep_roofline``, ``photo_ms.factors``) on hand-built traces. CPU only:
the kernels themselves are held on the card by tests/test_torch_cuda.py.

The step's tolerances are set from a float64 run of the same computation:
the benchmark's reference LM (``benchmark/reference/lm.py``) from the same
map in float64. A float32 answer is held to within GAP_FACTOR times the
float32 reference's own distance from that float64 run, so that the bound
follows the host's float32 rounding (another CPU's BLAS sums in another
order, for every side alike)."""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from benchmark import harness, prep_bound, trace
from benchmark import run as brun
from benchmark.reference import lm as ref_lm
from benchmark.reference import refine
from benchmark.reference.frames import net_kwargs
from sage_slam_tpu.config import MapperConfig as JaxMapperConfig
from sage_slam_tpu.geometry.camera import CameraPyramid as JaxCameraPyramid
from sage_slam_tpu.geometry.camera import PinholeCamera as JaxPinholeCamera
from sage_slam_tpu.geometry.se3 import SE3 as JaxSE3
from sage_slam_tpu.solver import ba as jba
from sage_slam_tpu.solver import graph as jgraph
from sage_slam_tpu_torch import synthetic
from sage_slam_tpu_torch.config import SlamConfig
from sage_slam_tpu_torch.models import depth_network
from sage_slam_tpu_torch.ops import photo_prep as tprep
from sage_slam_tpu_torch.ops import photo_reduce as tred
from sage_slam_tpu_torch.solver import ba as tba

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CELLS = {16: "refine_map64.full_graph_lm", 32: "refine_map64_cs32.full_graph_lm"}
CONFIGS = {16: "refine_map64", 32: "refine_map64_cs32"}
SEED = 2**31 + 12345
KEYFRAMES = 8
# read on an AMD EPYC host (update_gap): the port against the float32
# reference 3.1e-5 (CS=16) and 1.8e-5 (CS=32), against the float64 run
# 3.3e-5 and 9.9e-6; JAX against the port 1.8e-5 and 2.5e-5; the float32
# reference against the float64 run 8.5e-6 at both. The largest ratio is
# 3.9, so 50 leaves room for another host's rounding while a wrong term
# (a step off by a percent of the move reads 1e-2) stays far outside.
GAP_FACTOR = 50.0


@pytest.mark.parametrize("cs", [16, 32])
def test_config_file_gives_its_code_width(cs):
    """The configuration loads through SlamConfig.from_json with its code
    size, and the depth network its networks group builds gives a basis
    of that many channels."""
    path = REPO / "benchmark" / "configs" / f"{CONFIGS[cs]}.json"
    cfg = SlamConfig.from_json(str(path))
    assert cfg.code_size == cs
    nets = json.loads(path.read_text())["networks"]
    net = depth_network.init_network(torch.Generator().manual_seed(0),
                                     depth_network.DepthNetConfig(**net_kwargs(nets["depth"])))
    with torch.no_grad():
        bias, basis = depth_network.apply(net, torch.rand(3, 64, 80), torch.ones(1, 64, 80))
    assert bias.shape == (1, 32, 40) and basis.shape == (cs, 32, 40)


@pytest.mark.parametrize("kernel,size,width", [
    ("k1", 13, 32), ("k1", 29, 32), ("k1", 30, 48), ("k1", 45, 48), ("k1", 46, None),
    ("prep", 4, 16), ("prep", 16, 16), ("prep", 17, 32), ("prep", 32, 32), ("prep", 33, None),
])
def test_kernel_widths_are_picked_without_a_card(kernel, size, width):
    """K1's padded width for a block of ``size`` variables (29 -> 32,
    30-45 -> 48, 46 raises) and the prep kernel's code width for a code of
    ``size`` entries (16 -> 16, 17-32 -> 32, 33 raises), as pure functions;
    the benchmark's frozen copy of the prep's widths agrees."""
    pick = tred.pad_for if kernel == "k1" else tprep.code_width
    if width is None:
        with pytest.raises(ValueError):
            pick(size)
    else:
        assert pick(size) == width
    if kernel == "prep":
        assert prep_bound.code_width(size) == width


def _double(tree):
    if isinstance(tree, torch.Tensor):
        return tree.double() if tree.dtype == torch.float32 else tree
    if isinstance(tree, tuple):
        items = [_double(x) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


@pytest.fixture(scope="module", params=[16, 32], ids=["cs16", "cs32"])
def step(request, tmp_path_factory):
    """The cell at CS on the CPU over a KEYFRAMES-keyframe map at 64x80 in
    (32x40 out), through the benchmark's own run: its first ``run_ba`` call
    (the port's inputs and result), the run's reference outputs, and the
    reference's step from the same map in float64."""
    from benchmark.tests.conftest import tiny_checkout

    cs = request.param
    root = tiny_checkout(tmp_path_factory.mktemp(f"cs{cs}"))
    for path in (root / "benchmark" / "configs").glob("*.json"):
        c = json.loads(path.read_text())
        c["map_keyframes"] = KEYFRAMES
        path.write_text(json.dumps(c))
    calls = []
    run_ba = tba.run_ba

    def spy(*args, **kwargs):
        out = run_ba(*args, **kwargs)
        if not calls:
            calls.append((args, out))
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(tba, "run_ba", spy)
    try:
        res, checks, out = brun.measure(harness.resolve(root, CELLS[cs]), SEED, 0.5, False,
                                        torch.device("cpu"), harness.now())
    finally:
        mp.undo()
    frames, images, rot, trans, conn, ref = out["reference"]
    pb, start = refine.build(frames, images, rot, trans, conn)
    m = frames.cfg.mapper
    exact = ref_lm.run(_double(start), _double(pb), m, m.max_gn_iters)
    shutil.rmtree(root, ignore_errors=True)
    return dict(cs=cs, res=res, checks=checks, args=calls[0][0], got=calls[0][1], ref=ref,
                exact=exact, start64=_double(ref["start"]))


def _state(v, k=KEYFRAMES):
    """The map's keyframes (the compact problem's first k rows) as the
    reference's State, on the host."""
    return ref_lm.State(*(torch.as_tensor(np.asarray(x))[:k]
                          for x in (v.pose.rot, v.pose.trans, v.code, v.scale)))


def _tolerance(step) -> float:
    return GAP_FACTOR * refine.update_gap(step["ref"]["result"], step["exact"], step["start64"])


def test_full_graph_step_matches_the_plain_reference(step):
    """The port's step (the benchmark's run, whose every step is held to
    the reference) is correct, and within GAP_FACTOR of the float32
    reference's own error against the float64 run."""
    cs = step["cs"]
    variables = step["args"][0]
    assert variables.code_size == cs and step["got"][2] == 10
    assert step["res"]["correct"], step["checks"]
    gap = refine.update_gap(_state(step["got"][0]), step["exact"], step["start64"])
    assert gap <= _tolerance(step), (gap, _tolerance(step))


def _jax_inputs(variables, problem, pyr, cfg):
    """The port's problem as the JAX package's (its base window fields;
    JAX's prepare_problem builds the tables)."""
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    w = problem.window
    base = ("loc1d", "homo", "bias_flat", "jac_flat", "feat_pyr", "grad_pyr", "src_feats",
            "avg_sq_bias", "mask_flat")
    window = jba.WindowData(**{f: j(getattr(w, f)) for f in base},
                            **{f: None for f in jba.WindowData._fields if f not in base})
    window = window._replace(loc1d=window.loc1d.astype(jnp.int32))

    def edges(e):
        return jba.EdgeTable(j(e.i0).astype(jnp.int32), j(e.i1).astype(jnp.int32), j(e.valid))

    pr = problem.priors
    priors = jba.PriorTable(j(pr.code_valid), j(pr.scale_valid), j(pr.scale_init), j(pr.pose_valid),
                            JaxSE3(j(pr.pose_target.rot), j(pr.pose_target.trans)))
    jp = jba.BAProblem(window, edges(problem.photo_edges), edges(problem.geo_edges), priors, None)
    c0 = pyr[0]
    jpyr = JaxCameraPyramid.build(JaxPinholeCamera(fx=c0.fx, fy=c0.fy, cx=c0.cx, cy=c0.cy,
                                                   width=c0.width, height=c0.height), pyr.levels)
    jv = jgraph.Variables(JaxSE3(j(variables.pose.rot), j(variables.pose.trans)), j(variables.code),
                          j(variables.scale))
    return jv, jp, jpyr, JaxMapperConfig(**dataclasses.asdict(cfg))


def test_full_graph_step_matches_jax(step):
    """The same step by the JAX package's run_ba on the port's problem:
    the same iterations and error, the keyframes' variables within
    GAP_FACTOR of the float32 reference's own error against the float64
    run."""
    variables, problem, pyr, cfg, mask, iters = step["args"]
    assert problem.reproj_edges is None or problem.reproj_edges.i0.shape[0] == 0
    jv, jp, jpyr, jcfg = _jax_inputs(variables, problem, pyr, cfg)
    out_j = jax.jit(lambda x: jba.run_ba(x, jp, jpyr, jcfg, jnp.asarray(mask.numpy()),
                                         max_iters=iters))(jv)
    got = step["got"]
    assert int(out_j[2]) == got[2]
    np.testing.assert_allclose(float(got[1]), float(out_j[1]), rtol=1e-4)
    gap = refine.update_gap(_state(got[0]), _state(out_j[0]), _state(variables))
    assert gap <= _tolerance(step), (gap, _tolerance(step))


@pytest.mark.parametrize("cs", [16, 32])
def test_cell_resolves_with_the_new_readers(cs):
    """Both full-graph cells report global_ba_factors_per_s and setup_s,
    every CS-generic reader and the two new ones, each reading nothing
    from an empty context; the CS=32 cell's configuration has CS = 32."""
    cell = harness.resolve(REPO, CELLS[cs])
    assert cell.config["code_size"] == cs and cell.traffic["driver"] == "full_graph_lm"
    assert {m["name"] for m in cell.end_to_end} == {"global_ba_factors_per_s", "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert names >= {"k1_roofline", "mfu_pct.factors", "device_idle_pct.factors",
                     "assembly_ms.factors", "linearize_self_ms.factors", "solve_ms.factors",
                     "host_wait_ms.factors", "launches_per_iter.factors", "prep_roofline",
                     "photo_ms.factors"}
    for entry, reader in cell.readers():
        assert reader.read({}) is None, entry["name"]


def _reader(name):
    return harness.load_module(REPO / "benchmark" / "metrics" / f"{name}.py",
                               "test_code32_" + name.replace(".", "_"))


def _shapes(cs):
    return dict(e_photo=372, e_geo=372, levels=4, c=16, n=3072, dim=13 + cs, cs=cs, num_kf=64)


@pytest.mark.parametrize("cs", [16, 32])
def test_prep_roofline_reads_only_a_complete_trace_of_its_width(cs):
    """Three LM iterations, three prep launches of 1 ms: the share of the
    bound counted from the shapes; nothing for a launch count other than
    the iterations, another instantiation, or names without one (a
    program whose kernels carry no width)."""
    def ctx(width, launches=3, iters=3):
        name = f"void photo_prep_points<{width}>(float const*, float const*)" if width else \
            "photo_prep_points(float const*, float const*)"
        ev = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 0.0, "dur": 1e4}]
        ev += [{"ph": "X", "cat": "kernel", "name": name, "ts": 100.0 + 2e3 * i, "dur": 1e3}
               for i in range(launches)]
        return {"traced": trace.Traced(ev), "shapes": _shapes(cs), "peaks": (3.35e12, 67e12),
                "traced_iters": iters}

    read = _reader("prep_roofline").read
    bound_ms, nbytes = prep_bound.prep_bound(372, 4, 16, 3072, cs, 64, 3.35e12)
    # outputs 4 E N (4 L C + 1 + 2 dim), sources 4 K N (4 + CS + L C)
    assert nbytes == 4 * 372 * 3072 * (256 + 1 + 2 * (13 + cs)) + 4 * 64 * 3072 * (4 + cs + 64)
    assert read(ctx(cs)) == pytest.approx(100.0 * bound_ms / 1.0)
    assert read(ctx(cs, launches=2)) is None
    assert read(ctx(48 - cs)) is None
    assert read(ctx(None)) is None


@pytest.mark.parametrize("cs", [16, 32])
def test_prep_bound_is_chip_smokes_less_the_target_tables(cs):
    """The frozen count from shapes equals chip_smoke.prep_bound's count
    from the tensors of one linearization's prep, less the target frames'
    pixel tables that the shapes cannot count."""
    v, p, pyr = synthetic.bench_problem(device="cpu", k=8, h=32, w=40, cs=cs, levels=3, n=256,
                                        n_photo=24)
    p = tba.prepare_problem(p, pyr)
    prep = tba._photo_prep(v, p.window, p.photo_edges, pyr, 1e-6, True)
    _, smoke_bytes = chip_smoke.prep_bound(prep, p, slice(None), 1.0)
    pe, w = p.photo_edges, p.window
    targets = len(set(pe.i1.tolist())) * w.tables.pixel_fg[0].numel() * 4
    sources = len(set(pe.i0.tolist()))
    _, nbytes = prep_bound.prep_bound(pe.i0.shape[0], pyr.levels, w.src_feats.shape[-1],
                                      w.loc1d.shape[1], cs, sources, 1.0)
    assert sources == min(v.num_kf, pe.i0.shape[0])
    assert nbytes == smoke_bytes - targets


def _span_trace():
    """Two LM iterations on one host thread: in each, lin.photo launches a
    prep (30 us) and a K1 (20 us) and, inside its graph.scatter_hessian,
    an assembly GEMM (40 us); lin.geo launches one kernel (50 us)."""
    program = [("ba.run_ba", 0, 1000)]
    ops = []
    for i, t0 in enumerate((10, 500)):
        program += [("lm.iter", t0, t0 + 480), ("ba.linearize", t0 + 5, t0 + 300),
                    ("lin.photo", t0 + 10, t0 + 100), ("graph.scatter_hessian", t0 + 60, t0 + 90),
                    ("lin.geo", t0 + 110, t0 + 200)]
        ops += [(t0 + 20, 30), (t0 + 40, 20), (t0 + 70, 40), (t0 + 150, 50)]
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "pid": 1, "tid": 1,
           "ts": 0.0, "dur": 2000.0}]
    ev += [{"ph": "X", "cat": "user_annotation", "name": n, "pid": 1, "tid": 1, "ts": float(s),
            "dur": float(e - s)} for n, s, e in program]
    for c, (at, dur) in enumerate(ops):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": 1,
                   "ts": float(at), "dur": 2.0, "args": {"correlation": c}})
        ev.append({"ph": "X", "cat": "kernel", "name": f"k{c}", "pid": 0, "tid": 7,
                   "ts": float(at) + 3.0, "dur": float(dur), "args": {"correlation": c}})
    return trace.Traced(ev)


@pytest.mark.parametrize("iters,expected", [(2, (30 + 20) * 1e-3), (3, None)],
                         ids=["complete", "iterations-differ"])
def test_photo_ms_reads_the_photo_spans_outside_the_assembly(iters, expected):
    """photo_ms.factors: device ms a LM iteration launched in lin.photo
    and outside its graph.scatter_hessian; nothing when the trace's
    iterations are not the solver's."""
    got = _reader("photo_ms.factors").read({"traced": _span_trace(), "traced_iters": iters})
    assert got == (pytest.approx(expected) if expected is not None else None)

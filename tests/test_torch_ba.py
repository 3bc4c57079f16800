"""Port parity of the whole slice: window-BA linearize, total_error and
run_ba against the JAX package on the same inputs (CPU), plus the port's
own contracts (LM Cholesky-failure handling, config and device checks,
the schur solver against JAX's, the synthetic problems)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from sage_slam_tpu.config import MapperConfig as JaxMapperConfig
from sage_slam_tpu.solver import ba as jba
from sage_slam_tpu_torch import convert, synthetic
from sage_slam_tpu_torch.config import MapperConfig
from sage_slam_tpu_torch.geometry.se3 import SE3
from sage_slam_tpu_torch.solver import ba as tba
from sage_slam_tpu_torch.solver import graph as tgraph
from tests.test_ba import add_reproj_edges, build_problem, perturbed_vars

torch.set_num_threads(1)


def _port(v, p, pyr):
    return (
        convert.variables_from_numpy(jax.tree.map(np.asarray, v), device="cpu"),
        convert.problem_from_numpy(jax.tree.map(np.asarray, p), device="cpu"),
        convert.camera_pyramid_from_numpy(pyr),
    )


def _graft():
    v, p, pyr = graft._build_problem()
    return v, p, pyr


def _test_ba():
    p, pyr = build_problem()
    return perturbed_vars(3, 4), p, pyr


CASES = {"graft": _graft, "test_ba": _test_ba}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    v, p, pyr = CASES[request.param]()
    return (v, p, pyr, *_port(v, p, pyr))


def test_linearize_and_total_error_match_jax(case):
    v, p, pyr, tv, tp, tpyr = case
    cfg, tcfg = JaxMapperConfig(), MapperConfig()
    pj = jba.prepare_problem(p, pyr)
    h_j, b_j, e_j = jax.jit(lambda x: jba.linearize(x, pj, pyr, cfg))(v)
    tot_j = jax.jit(lambda x: jba.total_error(x, pj, pyr, cfg))(v)
    tpp = tba.prepare_problem(tp, tpyr)
    h_t, b_t, e_t = tba.linearize(tv, tpp, tpyr, tcfg)
    tot_t = tba.total_error(tv, tpp, tpyr, tcfg)
    # test_pallas.py's linearize tolerances: float32 sum-order roundoff
    scale = float(jnp.max(jnp.abs(h_j)))
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=1e-4, atol=1e-5 * scale)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), rtol=1e-4, atol=1e-5 * scale)
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=1e-5)
    np.testing.assert_allclose(float(tot_t), float(tot_j), rtol=1e-5)
    # the port's own tables equal the ones carried over from JAX
    tp_carried = convert.problem_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    np.testing.assert_array_equal(
        tpp.window.tables.packed_fg.numpy(), tp_carried.window.tables.packed_fg.numpy()
    )
    np.testing.assert_array_equal(
        tpp.window.tables.jac_at.numpy(), tp_carried.window.tables.jac_at.numpy()
    )


def test_run_ba_matches_jax(case):
    """run_ba(max_iters=10): same iteration count and converged flag;
    variables and error equal up to the float32 roundoff that the LM
    iterates accumulate (translations ~1e-2 in, ~1e-6 out)."""
    v, p, pyr, tv, tp, tpyr = case
    cfg, tcfg = JaxMapperConfig(), MapperConfig()
    k = v.scale.shape[0]
    err0 = float(jba.total_error(v, p, pyr, cfg))
    v_j, e_j, it_j, conv_j = jax.jit(
        lambda x: jba.run_ba(x, p, pyr, cfg, jnp.ones(k), max_iters=10)
    )(v)
    v_t, e_t, it_t, conv_t = tba.run_ba(tv, tp, tpyr, tcfg, torch.ones(k), max_iters=10)
    assert it_t == int(it_j)
    assert conv_t == bool(conv_j)
    assert float(e_t) < 0.05 * err0
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=1e-2, atol=1e-7 * err0)
    np.testing.assert_allclose(v_t.pose.trans.numpy(), np.asarray(v_j.pose.trans), atol=2e-6)
    np.testing.assert_allclose(v_t.pose.rot.numpy(), np.asarray(v_j.pose.rot), atol=2e-6)
    np.testing.assert_allclose(v_t.code.numpy(), np.asarray(v_j.code), atol=1e-6)
    np.testing.assert_allclose(v_t.scale.numpy(), np.asarray(v_j.scale), atol=1e-6)


def test_run_ba_respects_update_mask_and_conv():
    v, p, pyr = _test_ba()
    tv, tp, tpyr = _port(v, p, pyr)
    frozen = torch.tensor([1.0, 0.0, 1.0])
    v_t, _, _, _ = tba.run_ba(tv, tp, tpyr, MapperConfig(), frozen, max_iters=3)
    np.testing.assert_array_equal(v_t.pose.trans[1].numpy(), tv.pose.trans[1].numpy())
    np.testing.assert_array_equal(v_t.code[1].numpy(), tv.code[1].numpy())
    # use_conv: the loop stops on an accepted small step, as in JAX
    cfg = JaxMapperConfig()
    _, _, it_j, conv_j = jba.run_ba(v, p, pyr, cfg, jnp.ones(3), max_iters=12, use_conv=True)
    _, _, it_t, conv_t = tba.run_ba(
        tv, tp, tpyr, MapperConfig(), torch.ones(3), max_iters=12, use_conv=True
    )
    assert (it_t, conv_t) == (int(it_j), bool(conv_j))


def test_lm_loop_zeroes_delta_on_cholesky_failure():
    """A non-PD system: JAX's cho_factor yields NaNs, which the isfinite
    mask zeroes; the port reads cholesky_ex's info and zeroes delta."""
    k, cs = 2, 1
    v = tgraph.Variables(SE3.identity((k,)), torch.zeros(k, cs), torch.ones(k))
    dim = k * (7 + cs)
    h_bad = -torch.eye(dim)  # negative definite: the factorization fails
    b = torch.ones(dim)
    calls = []

    def lin(x):
        calls.append(x)
        return h_bad, b, torch.tensor(1.0)

    out, err, iters, conv = tgraph.lm_loop(
        v, lin, lambda x: torch.tensor(1.0), torch.ones(k), max_iters=3
    )
    assert iters == 3 and not conv
    for x in calls:  # every candidate equals the start: delta was zeroed
        np.testing.assert_array_equal(x.pose.trans.numpy(), v.pose.trans.numpy())
        np.testing.assert_array_equal(x.code.numpy(), v.code.numpy())
    assert float(err) == 1.0


def test_config_and_entry_point_contracts():
    assert MapperConfig(photo_reduce="pallas").photo_reduce == "pallas"
    with pytest.raises(ValueError):
        MapperConfig(photo_reduce="triton")
    v, p, pyr = _test_ba()
    tv, tp, tpyr = _port(v, p, pyr)
    bad = dataclasses.make_dataclass("Cfg", [("photo_reduce", str, "cuda")])()
    with pytest.raises(ValueError):
        tba.linearize(tv, tp, tpyr, bad)
    # reprojection edges are a factor type of their own now, never ignored
    # (test_torch_reprojection.py holds them against JAX)
    pr = add_reproj_edges(p, pyr)
    tpr = convert.problem_from_numpy(jax.tree.map(np.asarray, pr), device="cpu")
    _, _, e_rp = tba.linearize(tv, tpr, tpyr, MapperConfig())
    _, _, e_no = tba.linearize(tv, tp, tpyr, MapperConfig())
    assert float(e_rp) > float(e_no)
    assert float(tba.total_error(tv, tpr, tpyr, MapperConfig())) > float(
        tba.total_error(tv, tp, tpyr, MapperConfig())
    )
    # solver="schur" runs (tests/test_torch_schur.py holds it in full):
    # one step against JAX's, at test_run_ba_matches_jax's tolerances
    out = tba.run_ba(tv, tp, tpyr, MapperConfig(solver="schur"), torch.ones(3), max_iters=1)
    jcfg = dataclasses.replace(JaxMapperConfig(), solver="schur")
    out_j = jba.run_ba(v, p, pyr, jcfg, jnp.ones(3), max_iters=1)
    err0 = float(jba.total_error(v, p, pyr, jcfg))
    assert out[2] == int(out_j[2]) == 1
    np.testing.assert_allclose(float(out[1]), float(out_j[1]), rtol=1e-2, atol=1e-7 * err0)
    np.testing.assert_allclose(out[0].pose.trans.numpy(), np.asarray(out_j[0].pose.trans), atol=2e-6)
    np.testing.assert_allclose(out[0].code.numpy(), np.asarray(out_j[0].code), atol=1e-6)


def test_entry_points_refuse_a_silent_cpu_fallback():
    """Without CUDA, the default device (the card) raises; the CPU must
    be asked for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs its absence")
    v, p, pyr = _test_ba()
    with pytest.raises(RuntimeError):
        convert.problem_from_numpy(jax.tree.map(np.asarray, p))
    with pytest.raises(RuntimeError):
        synthetic.graft_problem()


def test_synthetic_graft_problem_matches_jax_builder():
    """The port's builder reproduces __graft_entry__._build_problem from
    the same seed (the pyramid is the port's own: float32 roundoff)."""
    v, p, pyr = graft._build_problem()
    tv, tp, tpyr = synthetic.graft_problem(device="cpu")
    assert tpyr == convert.camera_pyramid_from_numpy(pyr)
    for name in ("loc1d", "homo", "bias_flat", "jac_flat", "avg_sq_bias", "mask_flat"):
        np.testing.assert_allclose(
            getattr(tp.window, name).numpy(), np.asarray(getattr(p.window, name)),
            rtol=1e-6, atol=1e-7, err_msg=name,
        )
    for name in ("feat_pyr", "grad_pyr", "src_feats"):
        np.testing.assert_allclose(
            getattr(tp.window, name).numpy(), np.asarray(getattr(p.window, name)),
            rtol=1e-5, atol=1e-6, err_msg=name,
        )
    np.testing.assert_array_equal(tp.photo_edges.i0.numpy(), np.asarray(p.photo_edges.i0))
    np.testing.assert_array_equal(tp.geo_edges.i1.numpy(), np.asarray(p.geo_edges.i1))
    np.testing.assert_allclose(tv.pose.rot.numpy(), np.asarray(v.pose.rot), atol=1e-7)
    np.testing.assert_allclose(tv.pose.trans.numpy(), np.asarray(v.pose.trans), atol=1e-7)
    np.testing.assert_array_equal(tp.priors.pose_valid.numpy(), np.asarray(p.priors.pose_valid))


def test_synthetic_bench_problem_shapes():
    """The bench point at a cut depth (K=3, N=256), on the CPU: shapes and
    ring edges as bench.py builds them."""
    tv, tp, tpyr = synthetic.bench_problem(device="cpu", k=3, n=256, n_photo=6, n_geo=6)
    w = tp.window
    assert w.feat_pyr.shape == (16, 3, tpyr.total_pixels)
    assert w.src_feats.shape == (3, 4, 256, 16)
    np.testing.assert_array_equal(tp.photo_edges.i0.numpy(), [0, 1, 2, 0, 1, 2])
    np.testing.assert_array_equal(tp.photo_edges.i1.numpy(), [1, 2, 0, 2, 0, 1])
    assert tv.code.shape == (3, 16)

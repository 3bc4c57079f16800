"""Port parity of the Schur solver: graph.schur_solve against JAX's and
against the dense solve, lm_loop(solver="schur") through run_ba with a
frozen row (tests/test_ba.py's test_schur_solver_matches_dense problem),
and run_ba's "auto" choosing it at schur_min_keyframes = 48 (CPU)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage_slam_tpu.config import MapperConfig as JMapperConfig
from sage_slam_tpu.solver import ba as jba
from sage_slam_tpu.solver import graph as jgraph
from sage_slam_tpu_torch import convert
from sage_slam_tpu_torch.config import MapperConfig
from sage_slam_tpu_torch.solver import ba as tba
from sage_slam_tpu_torch.solver import graph as tgraph
from tests.test_ba import build_problem, perturbed_vars

torch.set_num_threads(1)


def _port(v, p, pyr):
    return (
        convert.variables_from_numpy(jax.tree.map(np.asarray, v), device="cpu"),
        convert.problem_from_numpy(jax.tree.map(np.asarray, p), device="cpu"),
        convert.camera_pyramid_from_numpy(pyr),
    )


def _spd_system(k, bd, seed, frozen=()):
    """A damped SPD system whose code blocks couple across keyframes, with
    identity rows for the frozen keyframes (as lm_loop masks them)."""
    rng = np.random.default_rng(seed)
    d = k * bd
    a = rng.standard_normal((d, 2 * d)).astype(np.float64)
    h = (a @ a.T / d + 0.1 * np.eye(d)).astype(np.float32)
    b = rng.standard_normal(d).astype(np.float32)
    free = np.ones(d, np.float32)
    for kf in frozen:
        free[kf * bd : (kf + 1) * bd] = 0.0
    h = h * free[:, None] * free[None, :] + np.diag(1.0 - free).astype(np.float32)
    return h, b * free


@pytest.mark.parametrize("k,bd,frozen", [(4, 11, (1,)), (6, 23, ()), (3, 23, (0, 2))])
def test_schur_solve_matches_jax_and_dense(k, bd, frozen):
    h, b = _spd_system(k, bd, seed=k + bd, frozen=frozen)
    delta_j = np.asarray(jgraph.schur_solve(jnp.asarray(h), jnp.asarray(b), k, bd))
    delta_t, ok = tgraph.schur_solve(torch.from_numpy(h), torch.from_numpy(b), k, bd)
    assert bool(ok)
    dense = np.linalg.solve(h.astype(np.float64), b.astype(np.float64))
    scale = float(np.abs(dense).max())
    np.testing.assert_allclose(delta_t.numpy(), delta_j, rtol=1e-4, atol=1e-5 * scale)
    np.testing.assert_allclose(delta_t.numpy(), dense, rtol=1e-4, atol=1e-5 * scale)
    for kf in frozen:  # identity rows with a zero right-hand side stay put
        assert not delta_t[kf * bd : (kf + 1) * bd].any()
    # a system that is not positive definite fails the factorization: ok
    # is False, and the LM's damped solve then takes no step
    bad = torch.from_numpy(h).clone()
    bad[bd + 6, bd + 6] = -1e3
    assert not bool(tgraph.schur_solve(bad, torch.from_numpy(b), k, bd)[1])
    delta, _ = tgraph._damped_solve(bad, torch.from_numpy(b), 0.0, 0.0,
                                    torch.ones(k * bd), "schur", k, bd)
    assert not delta.any()


def test_schur_solver_matches_dense_and_jax():
    """test_schur_solver_matches_dense in the port (error rtol 1e-5;
    translations, codes and scales rtol 1e-4, atol 1e-6), and the port's
    Schur run against JAX's at the same tolerances."""
    k, cs = 4, 4
    problem, pyr = build_problem(k=k, cs=cs)
    v0 = perturbed_vars(k, cs)
    tv, tp, tpyr = _port(v0, problem, pyr)
    mask_j = jnp.ones(k).at[1].set(0.0)  # one frozen row too
    mask_t = torch.tensor([1.0, 0.0, 1.0, 1.0])
    outs = {}
    for solver in ("dense", "schur"):
        cfg = MapperConfig(solver=solver)
        v, err, iters, _ = tba.run_ba(tv, tp, tpyr, cfg, mask_t, max_iters=6)
        outs[solver] = (v, float(err), iters)
    jcfg = dataclasses.replace(JMapperConfig(), solver="schur")
    vj, ej, itj, _ = jax.jit(lambda v_: jba.run_ba(v_, problem, pyr, jcfg, mask_j, max_iters=6))(v0)
    outs["jax"] = (jax.tree.map(np.asarray, vj), float(ej), int(itj))
    vs, es, its = outs["schur"]
    assert its == outs["dense"][2] == outs["jax"][2]
    for ref in ("dense", "jax"):
        vr, er, _ = outs[ref]
        np.testing.assert_allclose(es, er, rtol=1e-5, err_msg=ref)
        for name, a, b in (("trans", vs.pose.trans, vr.pose.trans), ("code", vs.code, vr.code),
                           ("scale", vs.scale, vr.scale)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6,
                                       err_msg=f"{ref} {name}")
    # the frozen keyframe keeps its input values
    np.testing.assert_array_equal(vs.pose.trans[1].numpy(), tv.pose.trans[1].numpy())
    with pytest.raises(ValueError):
        tba.run_ba(tv, tp, tpyr, MapperConfig(solver="qr"), mask_t, max_iters=1)


def test_auto_picks_schur_at_48_keyframes(monkeypatch):
    """solver="auto": Schur at num_kf >= schur_min_keyframes (48), dense
    below; the 48-keyframe run agrees with JAX's "auto" and with the
    port's dense run: error rtol 1e-5, codes rtol 1e-4 + atol 1e-6 as in
    the Schur test, translations atol 1e-5 (test_sharded_ba.py's): this
    48-keyframe chain is anchored at one end, and float32 factorization
    roundoff moves its translations more than at 4 keyframes."""
    k, cs = 48, 4
    problem, pyr = build_problem(k=k, h=16, w=20, cs=cs, levels=2, n=48)
    v0 = perturbed_vars(k, cs)
    tv, tp, tpyr = _port(v0, problem, pyr)
    seen = []
    lm_loop = tgraph.lm_loop

    def spy(*args, solver="dense", **kwargs):
        seen.append(solver)
        return lm_loop(*args, solver=solver, **kwargs)

    monkeypatch.setattr(tgraph, "lm_loop", spy)
    mask = torch.ones(k)
    auto = tba.run_ba(tv, tp, tpyr, MapperConfig(solver="auto"), mask, max_iters=3)
    dense = tba.run_ba(tv, tp, tpyr, MapperConfig(solver="dense"), mask, max_iters=3)
    sub = tba.slice_problem_keyframes(tba.prepare_problem(tp, tpyr), 47, tpyr)
    sub = sub._replace(photo_edges=tba.EdgeTable(*(x[:-2] for x in sub.photo_edges)),
                       geo_edges=tba.EdgeTable(*(x[:-2] for x in sub.geo_edges)))
    v47 = type(tv)(type(tv.pose)(tv.pose.rot[:47], tv.pose.trans[:47]), tv.code[:47], tv.scale[:47])
    tba.run_ba(v47, sub, tpyr, MapperConfig(solver="auto"), mask[:47], max_iters=1)
    assert seen == ["schur", "dense", "dense"]
    jcfg = dataclasses.replace(JMapperConfig(), solver="auto")
    vj, ej, itj, _ = jax.jit(
        lambda v_: jba.run_ba(v_, problem, pyr, jcfg, jnp.ones(k), max_iters=3))(v0)
    assert auto[2] == dense[2] == int(itj)
    for vr, er, label in ((dense[0], float(dense[1]), "dense"),
                          (jax.tree.map(np.asarray, vj), float(ej), "jax")):
        np.testing.assert_allclose(float(auto[1]), er, rtol=1e-5, err_msg=label)
        np.testing.assert_allclose(auto[0].pose.trans.numpy(), np.asarray(vr.pose.trans),
                                   rtol=1e-4, atol=1e-5, err_msg=label)
        np.testing.assert_allclose(auto[0].code.numpy(), np.asarray(vr.code), rtol=1e-4, atol=1e-6,
                                   err_msg=label)

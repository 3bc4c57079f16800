"""Port parity: the geometric factor, the priors and the PSD correction
against the JAX package on the same numpy inputs (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from sage_slam_tpu.ops import geometric as jgeo
from sage_slam_tpu.ops import priors as jpri
from sage_slam_tpu.geometry.se3 import se3_exp as jax_se3_exp
from sage_slam_tpu.solver import ba as jba
from sage_slam_tpu.solver import psd as jpsd
from sage_slam_tpu.solver.graph import Variables as JaxVariables
from sage_slam_tpu_torch import convert
from sage_slam_tpu_torch.geometry.se3 import se3_exp
from sage_slam_tpu_torch.ops import geometric as tgeo
from sage_slam_tpu_torch.ops import priors as tpri
from sage_slam_tpu_torch.solver import ba as tba
from sage_slam_tpu_torch.solver import psd as tpsd

torch.set_num_threads(1)

FW, LPF, EPS = 0.1, 0.03, 1e-6  # MapperConfig geo weight, loss factor, dpt_eps


@pytest.fixture(scope="module")
def graft_case():
    v, p, pyr = graft._build_problem()
    rng = np.random.default_rng(7)
    k, cs = v.code.shape
    v = JaxVariables(
        v.pose,
        jnp.asarray((rng.standard_normal((k, cs)) * 0.3).astype(np.float32)),
        jnp.asarray((1.0 + 0.1 * rng.standard_normal(k)).astype(np.float32)),
    )
    p = jba.prepare_problem(p, pyr)
    tv = convert.variables_from_numpy(jax.tree.map(np.asarray, v), device="cpu")
    tp = convert.problem_from_numpy(jax.tree.map(np.asarray, p), device="cpu")
    return v, p, pyr, tv, tp, convert.camera_pyramid_from_numpy(pyr)


def test_geometric_factor_matches_jax(graft_case):
    v, p, pyr, tv, tp, tpyr = graft_case
    ge, tge = p.geo_edges, tp.geo_edges
    lp_j = LPF * p.window.avg_sq_bias[ge.i0]
    lp_t = LPF * tp.window.avg_sq_bias[tge.i0]
    out = {}
    for which in ("full", "dpt"):
        kf0, kf1, sh = jba._geo_inputs(p.window, ge, v, pyr[0], which=which)
        tkf0, tkf1, tsh = tba._geo_inputs(tp.window, tge, tv, tpyr[0], which=which)
        table_j = sh.packed_full if which == "full" else sh.packed_dpt
        table_t = tsh.packed_full if which == "full" else tsh.packed_dpt
        np.testing.assert_allclose(table_t.numpy(), np.asarray(table_j), rtol=1e-6, atol=1e-6)
        args_j = (
            jba._edge_vars(v, ge.i0), jba._edge_vars(v, ge.i1), v.code[ge.i0],
            v.code[ge.i1], v.scale[ge.i0], v.scale[ge.i1], kf0, kf1,
        )
        args_t = (
            tba._edge_pose(tv, tge.i0), tba._edge_pose(tv, tge.i1), tv.code[tge.i0],
            tv.code[tge.i1], tv.scale[tge.i0], tv.scale[tge.i1], tkf0, tkf1, tsh,
            tpyr[0], FW, lp_t, EPS,
        )
        fn_j = jgeo.geometric_jac_error if which == "full" else jgeo.geometric_error
        fn_t = tgeo.geometric_jac_error if which == "full" else tgeo.geometric_error
        out_j = jax.vmap(
            lambda a, b, c, d, e, f, g, h, lp, s: fn_j(
                a, b, c, d, e, f, g, h, s, pyr[0], FW, lp, EPS
            ),
            in_axes=(0, 0, 0, 0, 0, 0, 0, 0, 0, None),
        )(*args_j, lp_j, sh)
        out[which] = (fn_t(*args_t), out_j)
    (ata_t, atb_t, err_t, inl_t), (ata_j, atb_j, err_j, inl_j) = out["full"]
    scale = float(jnp.max(jnp.abs(ata_j)))
    # float32 roundoff of the robust-weighted rows and their Gram
    np.testing.assert_allclose(ata_t.numpy(), np.asarray(ata_j), rtol=1e-4, atol=1e-6 * scale)
    np.testing.assert_allclose(atb_t.numpy(), np.asarray(atb_j), rtol=1e-4, atol=1e-6 * scale)
    np.testing.assert_allclose(err_t.numpy(), np.asarray(err_j), rtol=2e-5)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    (e2_t, n2_t), (e2_j, n2_j) = out["dpt"]
    np.testing.assert_allclose(e2_t.numpy(), np.asarray(e2_j), rtol=2e-5)
    np.testing.assert_array_equal(n2_t.numpy(), np.asarray(n2_j))


def test_priors_match_jax():
    rng = np.random.default_rng(8)
    k, cs = 5, 16
    code = rng.standard_normal((k, cs)).astype(np.float32)
    scale = np.array([1.0, 0.8, -0.1, 0.0, 2.5], np.float32)  # incl. non-positive
    init = np.array([1.0, 1.0, 1.2, 0.9, 2.0], np.float32)
    taus = (rng.standard_normal((k, 6)) * 0.3).astype(np.float32)
    taus2 = (rng.standard_normal((k, 6)) * 0.3).astype(np.float32)
    for t_out, j_out in (
        (
            tpri.code_prior(torch.from_numpy(code), torch.zeros(k, cs), 1e-3),
            jax.vmap(lambda c: jpri.code_prior(c, jnp.zeros_like(c), 1e-3))(jnp.asarray(code)),
        ),
        (
            tpri.scale_prior(torch.from_numpy(scale), torch.from_numpy(init), 1e4),
            jax.vmap(lambda s, s0: jpri.scale_prior(s, s0, 1e4))(jnp.asarray(scale), jnp.asarray(init)),
        ),
        (
            tpri.pose_prior(
                se3_exp(torch.from_numpy(taus)), se3_exp(torch.from_numpy(taus2)), 1e4
            ),
            jax.vmap(lambda a, b: jpri.pose_prior(jax_se3_exp(a), jax_se3_exp(b), 1e4))(
                jnp.asarray(taus), jnp.asarray(taus2)
            ),
        ),
    ):
        for a, b in zip(t_out, j_out):
            # float32 log / se3_log roundoff scaled by the 1e4 weights
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-3)


def test_psd_correction_matches_jax():
    rng = np.random.default_rng(9)
    m = rng.standard_normal((6, 9, 9)).astype(np.float32)
    gram = m @ np.swapaxes(m, -1, -2)
    for fn_t, fn_j, x in (
        (tpsd.psd_bump, jpsd.psd_bump, m),
        (tpsd.psd_bump_symmetric, jpsd.psd_bump_symmetric, gram),
    ):
        np.testing.assert_allclose(
            fn_t(torch.from_numpy(x)).numpy(), np.asarray(fn_j(jnp.asarray(x))),
            rtol=1e-6, atol=1e-6,
        )
    # eigh-based projection: float32 eigen-decomposition roundoff
    np.testing.assert_allclose(
        tpsd.nearest_psd(torch.from_numpy(m)).numpy(),
        np.asarray(jpsd.nearest_psd(jnp.asarray(m))), rtol=1e-4, atol=1e-4,
    )
    zero = torch.zeros(2, 9, 9)
    assert torch.count_nonzero(tpsd.psd_bump(zero)) == 0

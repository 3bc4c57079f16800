"""Port parity: the photometric factor and its reduce against the JAX
package on the same numpy inputs (CPU). On the CPU the port's reduce is
its plain version, photo_reduce_ref; the CUDA kernel is held against it on
the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from sage_slam_tpu.ops import photometric as jph
from sage_slam_tpu.ops.pallas_kernels import photo_reduce_pallas
from sage_slam_tpu.solver import ba as jba
from sage_slam_tpu.solver.graph import Variables as JaxVariables
from sage_slam_tpu_torch import convert
from sage_slam_tpu_torch.ops import photo_reduce as tred
from sage_slam_tpu_torch.ops import photometric as tph
from sage_slam_tpu_torch.solver import ba as tba

torch.set_num_threads(1)

WEIGHTS = (10.0, 9.0, 8.0, 7.0)


def _perturbed(variables, seed=2):
    """The graft variables with nonzero codes and scales != 1."""
    rng = np.random.default_rng(seed)
    k, cs = variables.code.shape
    code = (rng.standard_normal((k, cs)) * 0.3).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(k)).astype(np.float32)
    return JaxVariables(variables.pose, jnp.asarray(code), jnp.asarray(scale))


@pytest.fixture(scope="module")
def graft_case():
    """The __graft_entry__ problem (K=4, 32x40, C=CS=16, L=4, N=512,
    6 edges): test_pallas.py's reduce shapes with real prep outputs."""
    v, p, pyr = graft._build_problem()
    v = _perturbed(v)
    p = jba.prepare_problem(p, pyr)
    tv = convert.variables_from_numpy(jax.tree.map(np.asarray, v), device="cpu")
    tp = convert.problem_from_numpy(jax.tree.map(np.asarray, p), device="cpu")
    return v, p, pyr, tv, tp, convert.camera_pyramid_from_numpy(pyr)


def _jax_prep(v, p, pyr, soft):
    pe = p.photo_edges
    kf0, fr1, shared = jba._photo_inputs(p.window, pe)
    return jax.vmap(
        lambda a, b, c, d, e, f, sh: jph.photo_prep(
            a, b, c, d, e, f, sh, pyr, 1e-6, soft=soft
        ),
        in_axes=(0, 0, 0, 0, 0, 0, None),
    )(
        jba._edge_vars(v, pe.i0), jba._edge_vars(v, pe.i1),
        v.code[pe.i0], v.scale[pe.i0], kf0, fr1, shared,
    )


def _torch_prep(tv, tp, tpyr, soft):
    pe = tp.photo_edges
    kf0, fr1, shared = tba._photo_inputs(tp.window, pe)
    return tph.photo_prep(
        tba._edge_pose(tv, pe.i0), tba._edge_pose(tv, pe.i1),
        tv.code[pe.i0], tv.scale[pe.i0], kf0, fr1, shared, tpyr, 1e-6, soft=soft,
    )


def _assert_reduce_close(out_t, out_j, binary):
    """test_pallas.py's tolerances: ata/atb rtol 1e-4 with atol 1e-6 of
    max|ata|; err rtol 2e-5; n_inl exact for a binary gate (sums of 0/1),
    float32 roundoff (rtol 1e-6) for a soft one."""
    ata_t, atb_t, err_t, inl_t = (x.numpy() for x in out_t)
    ata_j, atb_j, err_j, inl_j = (np.asarray(x) for x in out_j)
    scale = float(np.max(np.abs(ata_j)))
    np.testing.assert_allclose(ata_t, ata_j, rtol=1e-4, atol=1e-6 * scale)
    np.testing.assert_allclose(atb_t, atb_j, rtol=1e-4, atol=1e-6 * scale)
    np.testing.assert_allclose(err_t, err_j, rtol=2e-5)
    if binary:
        np.testing.assert_array_equal(inl_t, inl_j)
    else:
        np.testing.assert_allclose(inl_t, inl_j, rtol=1e-6)


@pytest.mark.parametrize("soft", [False, True], ids=["binary", "soft"])
def test_photo_prep_and_reduce_match_xla_and_pallas(graft_case, soft):
    v, p, pyr, tv, tp, tpyr = graft_case
    prep_j = _jax_prep(v, p, pyr, soft)
    prep_t = _torch_prep(tv, tp, tpyr, soft)
    for name, a, b in zip(("fgs", "f0", "gate", "kx", "ky"), prep_t, prep_j):
        b = np.asarray(b)
        # float32 roundoff of warp/sampling arithmetic, relative to the
        # array's scale (K-rows reach ~1e3)
        np.testing.assert_allclose(
            a.numpy(), b, rtol=1e-4, atol=1e-5 * float(np.max(np.abs(b))), err_msg=name
        )
    ratios = jph.level_ratios(pyr)
    assert tph.level_ratios(tpyr) == ratios
    ref = tred.photo_reduce_ref(*prep_t, WEIGHTS, ratios)
    xla = jax.vmap(
        lambda a, b, g, x, y: jph.photo_reduce_xla(a, b, g, x, y, WEIGHTS, ratios)
    )(*prep_j)
    pallas = photo_reduce_pallas(*prep_j, WEIGHTS, ratios, 16, interpret=None)
    _assert_reduce_close(ref, xla, binary=not soft)
    _assert_reduce_close(ref, pallas, binary=not soft)
    # the wrapper takes the plain version for CPU tensors, launching nothing
    before = tred.photo_reduce.launches
    wrapped = tred.photo_reduce(*prep_t, WEIGHTS, ratios)
    assert tred.photo_reduce.launches == before
    for a, b in zip(wrapped, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _rand_inputs(e=3, lv=4, c=16, n=512, dim=29, seed=0, soft=False):
    """test_pallas.py's random reduce inputs."""
    rng = np.random.default_rng(seed)
    fgs = rng.standard_normal((e, lv, 3 * c, n)).astype(np.float32)
    f0 = rng.standard_normal((e, lv, c, n)).astype(np.float32)
    gate = rng.random((e, n)).astype(np.float32)
    if not soft:
        gate = (gate > 0.2).astype(np.float32)
    kx = rng.standard_normal((e, dim, n)).astype(np.float32)
    ky = rng.standard_normal((e, dim, n)).astype(np.float32)
    return fgs, f0, gate, kx, ky


@pytest.mark.parametrize(
    "shape,soft",
    [((3, 4, 16, 512, 29), False), ((3, 4, 16, 512, 29), True), ((2, 3, 8, 1000, 17), True)],
    ids=["pallas-shape-binary", "pallas-shape-soft", "ragged-dim17"],
)
def test_photo_reduce_ref_matches_xla_random(shape, soft):
    e, lv, c, n, dim = shape
    ins = _rand_inputs(e, lv, c, n, dim, soft=soft)
    weights = WEIGHTS + (6.0,)  # a config tuple may be longer than L
    ratios = tuple((0.5**i, 0.5**i) for i in range(lv))
    ref = tred.photo_reduce_ref(*(torch.from_numpy(x) for x in ins), weights, ratios)
    xla = jax.vmap(
        lambda a, b, g, x, y: jph.photo_reduce_xla(a, b, g, x, y, weights, ratios)
    )(*(jnp.asarray(x) for x in ins))
    _assert_reduce_close(ref, xla, binary=not soft)


def test_photo_reduce_rejects_bad_inputs():
    ins = [torch.from_numpy(x) for x in _rand_inputs(e=2, n=64)]
    ratios = tuple((0.5**i, 0.5**i) for i in range(4))
    with pytest.raises(TypeError):
        tred.photo_reduce(ins[0].double(), *ins[1:], WEIGHTS, ratios)
    with pytest.raises(ValueError):
        tred.photo_reduce(ins[0], ins[1][:, :, :8], *ins[2:], WEIGHTS, ratios)
    with pytest.raises(ValueError):
        tred.photo_reduce(*ins, WEIGHTS, ratios[:3])
    with pytest.raises(ValueError):
        tred.photo_reduce(*ins, WEIGHTS[:2], ratios)
    with pytest.raises(ValueError):
        tred.photo_reduce(*ins[:4], ins[4][:, :5], WEIGHTS, ratios)


@pytest.mark.parametrize("soft", [False, True], ids=["binary", "soft"])
def test_photometric_factor_matches_jax(graft_case, soft):
    v, p, pyr, tv, tp, tpyr = graft_case
    pe = p.photo_edges
    kf0, fr1, shared = jba._photo_inputs(p.window, pe)
    args_j = (jba._edge_vars(v, pe.i0), jba._edge_vars(v, pe.i1), v.code[pe.i0], v.scale[pe.i0], kf0, fr1)
    jac_j = jax.vmap(
        lambda a, b, c, d, e, f, sh: jph.photometric_jac_error(
            a, b, c, d, e, f, sh, pyr, WEIGHTS, 1e-6, soft=soft
        ),
        in_axes=(0, 0, 0, 0, 0, 0, None),
    )(*args_j, shared)
    err_j = jax.vmap(
        lambda a, b, c, d, e, f, sh: jph.photometric_error(
            a, b, c, d, e, f, sh, pyr, WEIGHTS, 1e-6, soft=soft
        ),
        in_axes=(0, 0, 0, 0, 0, 0, None),
    )(*args_j, shared)
    tpe = tp.photo_edges
    tkf0, tfr1, tshared = tba._photo_inputs(tp.window, tpe)
    args_t = (
        tba._edge_pose(tv, tpe.i0), tba._edge_pose(tv, tpe.i1),
        tv.code[tpe.i0], tv.scale[tpe.i0], tkf0, tfr1, tshared, tpyr, WEIGHTS, 1e-6,
    )
    jac_t = tph.photometric_jac_error(*args_t, soft=soft)
    err_t = tph.photometric_error(*args_t, soft=soft)
    _assert_reduce_close(jac_t, jac_j, binary=not soft)
    np.testing.assert_allclose(err_t[0].numpy(), np.asarray(err_j[0]), rtol=2e-5)
    np.testing.assert_allclose(err_t[1].numpy(), np.asarray(err_j[1]), rtol=1e-6)
    # the error-only path evaluates the same cost as the linearization
    np.testing.assert_allclose(err_t[0].numpy(), jac_t[2].numpy(), rtol=2e-5)


def test_photo_tables_and_source_features_match_jax(graft_case):
    v, p, pyr, tv, tp, tpyr = graft_case
    w, tw = p.window, tp.window
    c = w.feat_pyr.shape[0]
    tables_j = jph.build_photo_tables(
        w.feat_pyr.reshape(c, -1), w.grad_pyr.reshape(2, c, -1), w.mask_flat, pyr
    )
    tables_t = tph.build_photo_tables(
        tw.feat_pyr.reshape(c, -1), tw.grad_pyr.reshape(2, c, -1), tw.mask_flat, tpyr
    )
    for a, b in zip(tables_t[:2], tables_j[:2]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for ta, tb in zip(tables_t[2:4], tables_j[2:4]):
        assert len(ta) == len(tb)
        for a, b in zip(ta, tb):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tables_j[4] is None and tables_j[5] is None  # mega tables: off
    src_j = jph.sample_source_features(w.feat_pyr[:, 0], w.loc1d[0], pyr)
    src_t = tph.sample_source_features(tw.feat_pyr[:, 0], tw.loc1d[0], tpyr)
    np.testing.assert_allclose(src_t.numpy(), np.asarray(src_j), rtol=1e-6, atol=1e-6)

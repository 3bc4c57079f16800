"""The port's differentiable BA (sage_slam_tpu_torch/training/diff_ba.py) and
K1's closed-form backward against the JAX package.

* photo_reduce's backward (ops/photo_reduce.photo_reduce_backward, through
  PhotoReduceFn) passes float64 gradcheck and equals autograd through
  photo_reduce_ref; in float32 it matches jax.grad through photo_reduce_xla;
* the CPU path (photo_reduce_ref under autograd) gives fgs, kx and the
  level weights non-zero gradients;
* _bwd_clip, the table-free geometric term, and ba_optimize's final state,
  per-iteration errors and gradients against jax.grad on the inputs of
  tests/test_training.py::test_diff_ba_is_differentiable (16x20, CS=4,
  FS=4, L=2, N=48, all five terms plus reprojection).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage_slam_tpu.geometry.camera import CameraPyramid as JCameraPyramid
from sage_slam_tpu.geometry.camera import PinholeCamera as JPinholeCamera
from sage_slam_tpu.geometry.interp import locations_1d_to_2d as j_loc2d
from sage_slam_tpu.geometry.interp import locations_1d_to_homo as j_homo
from sage_slam_tpu.ops import geometric as jgeo
from sage_slam_tpu.ops import photometric as jphoto
from sage_slam_tpu.ops.pyramid import gaussian_pyramid_with_grad as j_pyr
from sage_slam_tpu.ops.pyramid import mask_pyramid as j_mask_pyr
from sage_slam_tpu.training import diff_ba as jdb
from sage_slam_tpu_torch.geometry.camera import CameraPyramid, PinholeCamera
from sage_slam_tpu_torch.geometry.interp import locations_1d_to_2d, locations_1d_to_homo
from sage_slam_tpu_torch.geometry.se3 import SE3, se3_exp
from sage_slam_tpu_torch.ops import geometric, photometric
from sage_slam_tpu_torch.ops import photo_reduce as pr
from sage_slam_tpu_torch.training import diff_ba

torch.set_num_threads(1)


def _t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x), dtype=dtype)


def _reduce_inputs(e, lv, c, n, dim, soft, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    gate = rng.random((e, n))
    if not soft:
        gate = (gate > 0.3).astype(np.float64)
    arrays = [
        rng.standard_normal((e, lv, 3 * c, n)), rng.standard_normal((e, lv, c, n)), gate,
        rng.standard_normal((e, dim, n)), rng.standard_normal((e, dim, n)),
        rng.random(lv) + 0.5,
    ]
    return [a.astype(dtype) for a in arrays]


RATIOS = ((1.0, 1.0), (0.5, 0.5), (0.25, 0.3))


@pytest.mark.parametrize("soft", [False, True], ids=["binary", "soft"])
def test_reduce_backward_gradcheck(soft):
    """Float64 gradcheck of the closed form on a small shape (E=2, L=3, C=3,
    N=9, dim=5), and equality with autograd through photo_reduce_ref to
    1e-12 relative."""
    arrays = _reduce_inputs(2, 3, 3, 9, 5, soft, seed=1)
    ins = [torch.tensor(a, requires_grad=True) for a in arrays]

    def fn(*a):
        return pr.PhotoReduceFn.apply(*a[:5], a[5], RATIOS)

    assert torch.autograd.gradcheck(fn, ins)
    outs = fn(*ins)
    cot = [torch.randn_like(o) for o in outs]
    got = torch.autograd.grad(outs, ins, cot)
    ref = torch.autograd.grad(pr.photo_reduce_ref(*ins[:5], ins[5], RATIOS), ins, cot)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-12, atol=1e-12 * float(r.abs().max()))


@pytest.mark.parametrize("soft", [False, True], ids=["binary", "soft"])
def test_reduce_backward_matches_jax_grad(soft):
    """Float32, the training shape's layout (E=1, L=4, C=4, N=64, dim=29):
    the closed-form cotangents of every input and the weights against
    jax.grad through photo_reduce_xla, for a random cotangent of all four
    outputs; rtol 2e-4 of each gradient's max |value|."""
    e, lv, c, n, dim = 1, 4, 4, 64, 29
    arrays = _reduce_inputs(e, lv, c, n, dim, soft, seed=2, dtype=np.float32)
    ratios = tuple((0.5**lvl, 0.5**lvl) for lvl in range(lv))
    rng = np.random.default_rng(3)
    cots = [rng.standard_normal(s).astype(np.float32) for s in ((dim, dim), (dim,), (), ())]

    def jloss(fgs, f0, gate, kx, ky, w):
        outs = jphoto.photo_reduce_xla(fgs[0], f0[0], gate[0], kx[0], ky[0], tuple(w), ratios)
        return sum(jnp.sum(o * jnp.asarray(ct)) for o, ct in zip(outs, cots))

    jg = jax.grad(jloss, argnums=tuple(range(6)))(*[jnp.asarray(a) for a in arrays])
    ins = [torch.tensor(a, requires_grad=True) for a in arrays]
    outs = pr.PhotoReduceFn.apply(*ins[:5], ins[5], ratios)
    tg = torch.autograd.grad(outs, ins, [torch.tensor(ct)[None] if ct.ndim == 2 else
                                         torch.tensor(ct).reshape(1, *ct.shape) for ct in cots])
    for name, a, b in zip(("fgs", "f0", "gate", "kx", "ky", "weights"), tg, jg):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-4, atol=2e-4 * float(np.abs(b).max()),
                                   err_msg=name)


def test_cpu_reduce_path_keeps_the_gradient():
    """photo_reduce on CPU tensors runs photo_reduce_ref under autograd:
    fgs, kx and a weights tensor all receive non-zero gradients, equal to
    the closed form's."""
    arrays = _reduce_inputs(1, 4, 4, 32, 29, False, seed=4, dtype=np.float32)
    ratios = tuple((0.5**lvl, 0.5**lvl) for lvl in range(4))
    ins = [torch.tensor(a, requires_grad=True) for a in arrays]
    ata, atb, err, n_inl = pr.photo_reduce(*ins[:5], ins[5], ratios)
    (ata.sum() + atb.sum() + err.sum()).backward()
    for name, i in (("fgs", 0), ("kx", 3), ("weights", 5)):
        assert float(ins[i].grad.abs().max()) > 0, name
    closed = pr.photo_reduce_backward(*[x.detach() for x in ins], ratios,
                                      torch.ones_like(ata), torch.ones_like(atb),
                                      torch.ones_like(err), torch.zeros_like(n_inl))
    for i in (0, 3, 5):
        np.testing.assert_allclose(ins[i].grad.numpy(), closed[i].numpy(), rtol=1e-4,
                                   atol=1e-5 * float(closed[i].abs().max()))


def test_bwd_clip_identity_forward_bounded_backward():
    """As tests/test_training.py's: identity forward, the backward norm
    clipped to max_norm, and untouched at max_norm 0."""
    x = torch.tensor([3.0, 4.0], requires_grad=True)
    np.testing.assert_array_equal(diff_ba._bwd_clip(x, 1.0).detach().numpy(), x.detach().numpy())
    (g,) = torch.autograd.grad(torch.sum(100.0 * diff_ba._bwd_clip(x, 1.0)), x)
    assert float(torch.linalg.norm(g)) <= 1.0 + 1e-5
    jg = jax.grad(lambda v: jnp.sum(100.0 * jdb._bwd_clip(v, 1.0)))(jnp.asarray([3.0, 4.0]))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6)
    (g0,) = torch.autograd.grad(torch.sum(100.0 * diff_ba._bwd_clip(x, 0.0)), x)
    np.testing.assert_allclose(g0.numpy(), 100.0 * np.ones(2), rtol=1e-6)


# ---------------------------------------------------------------------------
# test_diff_ba_is_differentiable's problem in both packages

H, W, CS, FS, L, N = 16, 20, 4, 4, 2, 48


def _problem_arrays(seed=3):
    rng = np.random.default_rng(seed)
    feat = (rng.standard_normal((FS, H, W)) * 0.3).astype(np.float32)
    bias = rng.uniform(0.8, 1.5, H * W).astype(np.float32)
    jac = (rng.standard_normal((H * W, CS)) * 0.02).astype(np.float32)
    loc = rng.choice(H * W, N, replace=False).astype(np.int32)
    return feat, bias, jac, loc


def _jax_problem(feat, bias, jac, loc, with_matches=True):
    cam = JPinholeCamera(fx=W * 1.1, fy=W * 1.1, cx=W / 2 - 0.5, cy=H / 2 - 0.5, width=W, height=H)
    pyr = JCameraPyramid.build(cam, L)
    mask = jnp.ones((H, W))
    fpyr, gpyr = j_pyr(jnp.asarray(feat), j_mask_pyr(mask, L), L)
    bias, jac, loc = jnp.asarray(bias), jnp.asarray(jac), jnp.asarray(loc)
    homo = j_homo(loc, cam)
    zero = jnp.asarray(0, jnp.int32)
    kf0 = jphoto.PhotoKf0(loc, homo, jphoto.sample_source_features(fpyr, loc, pyr), zero, zero)
    matches = None
    if with_matches:
        kp = loc[:16]
        mx, my = j_loc2d(kp, cam.width)
        matches = jdb.MatchSet(
            homo0=j_homo(kp, cam), bias0=jnp.take(bias, kp), jac0=jnp.take(jac, kp, axis=0),
            match_homo1=j_homo(kp, cam), match_depths=jnp.take(bias, kp) * 1.05,
            matched_2d=jnp.stack([mx + 0.5, my], axis=-1).astype(jnp.float32),
            valid=jnp.ones(16),
        )
    inputs = jdb.BAInputs(
        kf0=kf0, fr1=jphoto.PhotoFr1(zero),
        photo_shared=jphoto.PhotoShared(bias, jac, fpyr, gpyr, mask.reshape(-1)),
        geo_kf0=jgeo.GeoKf0(loc, homo, zero), geo_kf1=jgeo.GeoKf1(zero),
        geo_shared=jgeo.GeoShared(bias, jac, mask.reshape(-1)),
        matches=matches, mean_sq_depth=jnp.mean(bias**2), init_scale=jnp.asarray(1.0),
    )
    return inputs, pyr, fpyr, gpyr


def _port_problem(feat_pyr, grad_pyr, bias, jac, loc, with_matches=True):
    """The port's BAInputs from the same arrays (the pyramids as tensors, so
    gradients can reach them)."""
    cam = PinholeCamera(fx=W * 1.1, fy=W * 1.1, cx=W / 2 - 0.5, cy=H / 2 - 0.5, width=W, height=H)
    pyr = CameraPyramid.build(cam, L)
    mask = torch.ones(H * W)
    loc = torch.as_tensor(loc).long()
    homo = locations_1d_to_homo(loc, cam)
    zero = torch.zeros(1, dtype=torch.long)
    kf0 = photometric.PhotoKf0(loc[None], homo[None],
                               photometric.sample_source_features(feat_pyr, loc, pyr)[None],
                               zero, zero)
    matches = None
    if with_matches:
        kp = loc[:16]
        mx, my = locations_1d_to_2d(kp, cam.width)
        matches = diff_ba.MatchSet(
            homo0=locations_1d_to_homo(kp, cam), bias0=bias[kp], jac0=jac[kp],
            match_homo1=locations_1d_to_homo(kp, cam), match_depths=bias[kp] * 1.05,
            matched_2d=torch.stack([mx + 0.5, my], dim=-1), valid=torch.ones(16),
        )
    inputs = diff_ba.BAInputs(
        kf0=kf0, fr1=photometric.PhotoFr1(zero),
        photo_shared=photometric.PhotoShared(bias, jac, feat_pyr, grad_pyr, mask),
        geo_kf0=geometric.GeoKf0(loc[None], homo[None], zero), geo_kf1=geometric.GeoKf1(zero),
        geo_shared=geometric.GeoShared(bias, jac, mask),
        matches=matches, mean_sq_depth=torch.mean(bias**2), init_scale=torch.tensor(1.0),
    )
    return inputs, pyr


def test_geometric_term_without_tables_matches_jax():
    """geometric_jac_error with no prebuilt tables (frame 1 decoded per
    edge, as the trainer's GeoShared) against JAX's table-free branch at a
    perturbed pose, code0 and scale0; factor_weight a tensor that keeps its
    graph. rtol 1e-4 of each output's max |value|."""
    feat, bias, jac, loc = _problem_arrays()
    tau = np.array([0.01, -0.02, 0.015, 0.01, -0.005, 0.02], np.float32)
    code0 = np.array([0.3, -0.2, 0.1, 0.05], np.float32)
    inputs, pyr, fpyr, gpyr = _jax_problem(feat, bias, jac, loc, with_matches=False)
    from sage_slam_tpu.geometry.se3 import SE3 as JSE3
    from sage_slam_tpu.geometry.se3 import se3_exp as j_exp

    jout = jgeo.geometric_jac_error(
        j_exp(jnp.asarray(tau)), JSE3.identity(), jnp.asarray(code0), jnp.zeros(CS),
        jnp.asarray(1.1), jnp.asarray(1.0), inputs.geo_kf0, inputs.geo_kf1, inputs.geo_shared,
        pyr[0], jnp.asarray(0.05), jnp.asarray(0.1) * inputs.mean_sq_depth, 1e-3,
    )
    tinputs, tpyr = _port_problem(_t(fpyr), _t(gpyr), _t(bias), _t(jac), loc, with_matches=False)
    t10 = se3_exp(_t(tau))
    fw = torch.tensor(0.05, requires_grad=True)
    tout = geometric.geometric_jac_error(
        SE3(t10.rot[None], t10.trans[None]), SE3.identity((1,)), _t(code0)[None],
        torch.zeros(1, CS), torch.tensor([1.1]), torch.ones(1), tinputs.geo_kf0,
        tinputs.geo_kf1, tinputs.geo_shared, tpyr[0], fw,
        (0.1 * tinputs.mean_sq_depth)[None], 1e-3,
    )
    for name, a, b in zip(("ata", "atb", "err", "n_inl"), tout, jout):
        b = np.asarray(b)
        np.testing.assert_allclose(a[0].detach().numpy(), b, rtol=1e-4,
                                   atol=1e-4 * max(float(np.abs(b).max()), 1e-30), err_msg=name)
    (g,) = torch.autograd.grad(tout[0].sum() + tout[2].sum(), fw)
    assert float(g.abs()) > 0


JAX_FIELDS = ("photo_weight", "photo_pow_factor", "match_geom_param_factor", "match_geom_term_weight",
              "geometry_cauchy_param_factor", "geometry_term_weight", "code_term_weight",
              "scale_term_weight", "reproj_term_weight", "reproj_cauchy_param")


@pytest.fixture(scope="module")
def jax_ba_run():
    """JAX's ba_optimize on test_diff_ba_is_differentiable's problem: the
    final state, errors, and jax.grad of its loss with respect to the BA
    params, the feature pyramid and the depth bias."""
    feat, bias, jac, loc = _problem_arrays()
    inputs, pyr, fpyr, gpyr = _jax_problem(feat, bias, jac, loc)
    init = jdb.BAState(tau10=jnp.zeros(6), scale0=jnp.asarray(1.0), code0=jnp.zeros(CS))

    def run(params, fpyr_, bias_):
        kp = inputs.kf0.loc1d[:16]
        inp = inputs._replace(
            kf0=inputs.kf0._replace(src_feats=jphoto.sample_source_features(fpyr_, inputs.kf0.loc1d, pyr)),
            photo_shared=inputs.photo_shared._replace(bias_flat=bias_, feat_pyr=fpyr_),
            geo_shared=inputs.geo_shared._replace(bias_flat=bias_),
            matches=inputs.matches._replace(bias0=jnp.take(bias_, kp),
                                            match_depths=jnp.take(bias_, kp) * 1.05),
            mean_sq_depth=jnp.mean(bias_**2),
        )
        final, errs = jdb.ba_optimize(params, inp, pyr, init, max_iters=2,
                                      use_match_geom=True, use_geom=True, use_reproj=True)
        loss = jnp.sum(final.code0**2) + jnp.sum(final.tau10**2) + errs[-1]
        return loss, (final, errs)

    params = jdb.BAParams.init(L)
    (loss, (final, errs)), grads = jax.value_and_grad(run, argnums=(0, 1, 2), has_aux=True)(
        params, fpyr, jnp.asarray(bias))
    return dict(arrays=(feat, bias, jac, loc), fpyr=np.asarray(fpyr), gpyr=np.asarray(gpyr),
                loss=float(loss), final=jax.tree.map(np.asarray, final), errs=np.asarray(errs),
                g_params=jax.tree.map(np.asarray, grads[0]), g_fpyr=np.asarray(grads[1]),
                g_bias=np.asarray(grads[2]))


def _port_run(ref, bwd_clip=0.0, reproj=True):
    feat, bias, jac, loc = ref["arrays"]
    fpyr = _t(ref["fpyr"]).requires_grad_(True)
    bias_t = _t(bias).requires_grad_(True)
    inputs, pyr = _port_problem(fpyr, _t(ref["gpyr"]), bias_t, _t(jac), loc)
    params = diff_ba.BAParams(*(p.requires_grad_(True) for p in diff_ba.BAParams.init(L, device="cpu")))
    init = diff_ba.BAState(torch.zeros(6), torch.tensor(1.0), torch.zeros(CS))
    final, errs = diff_ba.ba_optimize(params, inputs, pyr, init, max_iters=2, use_match_geom=True,
                                      use_geom=True, use_reproj=reproj, bwd_clip=bwd_clip)
    loss = torch.sum(final.code0**2) + torch.sum(final.tau10**2) + errs[-1]
    return params, fpyr, bias_t, final, errs, loss


def test_ba_optimize_matches_jax(jax_ba_run):
    """Final state and per-iteration errors: atol 2e-6 on the state, rtol
    1e-5 on the errors."""
    _, _, _, final, errs, _ = _port_run(jax_ba_run)
    ref = jax_ba_run["final"]
    for name in ("tau10", "scale0", "code0"):
        np.testing.assert_allclose(getattr(final, name).detach().numpy(), getattr(ref, name),
                                   atol=2e-6, err_msg=name)
    np.testing.assert_allclose(errs.detach().numpy(), jax_ba_run["errs"], rtol=1e-5)


def test_ba_optimize_gradients_match_jax_grad(jax_ba_run):
    """Gradients of sum(code0^2) + sum(tau10^2) + errs[-1] with respect to
    every BA param, the feature pyramid and the depth bias against
    jax.grad: rtol 1e-3 per param; 1e-3 of the max |gradient| on the
    arrays. The learnt photo / match / geometry scalars all receive
    signal, as JAX's test asserts."""
    params, fpyr, bias_t, _, _, loss = _port_run(jax_ba_run)
    np.testing.assert_allclose(float(loss.detach()), jax_ba_run["loss"], rtol=1e-5)
    grads = torch.autograd.grad(loss, [*params, fpyr, bias_t])
    ref = jax_ba_run["g_params"]
    for name, g in zip(diff_ba.BAParams._fields, grads[:10]):
        r = float(getattr(ref, name))
        np.testing.assert_allclose(float(g), r, rtol=1e-3, atol=1e-6, err_msg=name)
    for name in ("photo_weight", "photo_pow_factor", "match_geom_term_weight", "geometry_term_weight"):
        assert abs(float(grads[diff_ba.BAParams._fields.index(name)])) > 0, name
    for name, g, r in (("feat_pyr", grads[10], jax_ba_run["g_fpyr"]), ("bias", grads[11], jax_ba_run["g_bias"])):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-3, atol=1e-3 * float(np.abs(r).max()), err_msg=name)


def test_ba_optimize_bwd_clip_changes_only_the_gradient(jax_ba_run):
    """bwd_clip leaves the forward result as it was (atol 1e-7) and bounds
    what flows back."""
    _, _, _, a, ea, la = _port_run(jax_ba_run)
    p, _, _, b, eb, lb = _port_run(jax_ba_run, bwd_clip=1e-3)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(), atol=1e-7)
    np.testing.assert_allclose(ea.detach().numpy(), eb.detach().numpy(), atol=1e-7)
    g = torch.autograd.grad(lb, p.photo_weight)[0]
    assert torch.isfinite(g)


def test_ba_optimize_records_every_branch(jax_ba_run):
    """ba_optimize.record, when a list, receives each branch of the unroll
    in order (2 iterations x 3 damping attempts, 2 x 4 solves, one clipped
    cotangent on the backward pass: the first iteration's clip is of the
    initial state, which takes no gradient) and changes neither the result
    nor the gradient; None records nothing."""
    pa, _, _, a, ea, la = _port_run(jax_ba_run, bwd_clip=1e-3)
    ga = torch.autograd.grad(la, pa.photo_weight)[0]
    diff_ba.ba_optimize.record = record = []
    try:
        pb, _, _, b, eb, lb = _port_run(jax_ba_run, bwd_clip=1e-3)
        gb = torch.autograd.grad(lb, pb.photo_weight)[0]
    finally:
        diff_ba.ba_optimize.record = None
    got = diff_ba.branch_record(record)
    assert {k: len(v) for k, v in got.items()} == {
        "zeroed": 8, "clamp": 6, "select": 8, "taken": 6, "cond": 6, "clip_norm": 1, "clipped": 1}
    assert got["clipped"] == [n > 1e-3 for n in got["clip_norm"]]
    assert any(got["taken"]) and not any(got["zeroed"]) and not any(got["clamp"])
    assert all(c >= 1.0 for c in got["cond"])
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.detach().numpy(), y.detach().numpy())
    np.testing.assert_array_equal(ea.detach().numpy(), eb.detach().numpy())
    assert float(ga) == float(gb)
    _port_run(jax_ba_run, bwd_clip=1e-3)
    assert len(record) == sum(map(len, got.values()))


def test_ba_outputs_match_jax(jax_ba_run):
    """Depth map and rigid flow of the final state: rtol 1e-5."""
    feat, bias, jac, loc = jax_ba_run["arrays"]
    ref = jax_ba_run["final"]
    cam = JPinholeCamera(fx=W * 1.1, fy=W * 1.1, cx=W / 2 - 0.5, cy=H / 2 - 0.5, width=W, height=H)
    jd, jf = jdb.ba_outputs(jdb.BAState(*(jnp.asarray(x) for x in ref)), jnp.asarray(bias),
                            jnp.asarray(jac), cam)
    tcam = PinholeCamera(fx=W * 1.1, fy=W * 1.1, cx=W / 2 - 0.5, cy=H / 2 - 0.5, width=W, height=H)
    td, tf = diff_ba.ba_outputs(diff_ba.BAState(*(_t(x) for x in ref)), _t(bias), _t(jac), tcam)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-5, atol=1e-5)


def test_load_ba_model_from_reference_checkpoint():
    """The reference's pretrained/ba_model.pt maps into BAParams (skips, as
    JAX's test does, where the checkpoint is absent)."""
    from pathlib import Path

    # the reference checkout beside the repo, where JAX's test reads it
    path = Path(__file__).resolve().parents[2] / "reference" / "pretrained" / "ba_model.pt"
    if not path.exists():
        pytest.skip("reference checkpoint not present")
    params = diff_ba.load_ba_model(str(path), device="cpu")
    jparams = jdb.load_ba_model(str(path))
    for name in diff_ba.BAParams._fields:
        np.testing.assert_allclose(float(getattr(params, name)), float(getattr(jparams, name)))

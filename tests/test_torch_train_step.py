"""One train step of each curriculum phase in the port against JAX's
make_train_step, at tests/test_training.py::test_train_step_runs_both_phases'
config (16x20 output, CS=4, FS=8, two-level pyramid, 2 BA iterations, 32
photometric samples, the synthetic triplet dataset).

JAX's weights reach the port through convert.train_params_from_numpy and
its batch through convert.batch_from_numpy; JAX's photometric sample ids
(jax.random.permutation under the step's key) are injected. JAX's steps
are jitted once per phase in a module fixture that every case reuses.
"""

import jax
import numpy as np
import pytest
import torch

from sage_slam_tpu.geometry.camera import CameraPyramid as JCameraPyramid
from sage_slam_tpu.models import depth_network as jdepth
from sage_slam_tpu.models import feature_network as jfeat
from sage_slam_tpu.training import dataset as jdataset
from sage_slam_tpu.training import discriminator as jdisc
from sage_slam_tpu.training import train as jtrain
from sage_slam_tpu_torch import convert
from sage_slam_tpu_torch.geometry.camera import CameraPyramid
from sage_slam_tpu_torch.models.depth_network import DepthNetConfig
from sage_slam_tpu_torch.models.feature_network import FeatureNetConfig
from sage_slam_tpu_torch.training import discriminator, train

torch.set_num_threads(1)

H, W, CS, FS = 16, 20, 4, 8


def _cfgs(mod_depth, mod_feat, mod_disc):
    return (
        mod_depth(filter_list=(4, 8), bottleneck=8, bias_inner=(8, 1), basis_inner=((8, CS),)),
        mod_feat(filter_list=(4, 8), bottleneck=8, desc_inner=(8, FS), map_inner=(8, FS)),
        mod_disc(img_height=H, img_width=W, num_blocks=2, filter_base=4),
    )


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_ids(key, hw, n):
    k0, k1 = jax.random.split(key)
    return tuple(np.asarray(jax.random.permutation(k, hw)[:n]) for k in (k0, k1))


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's init state, batch, and the states after a separate and then a
    joint step (the joint step starts from the separate step's state, as in
    the JAX test)."""
    depth_cfg, feat_cfg, disc_cfg = _cfgs(jdepth.DepthNetConfig, jfeat.FeatureNetConfig,
                                          jdisc.DiscConfig)
    cfg = jtrain.TrainConfig(pyramid_levels=2, ba_iters=2, num_photo_samples=32)
    ds = jdataset.SyntheticTripletDataset(H, W, num_keypoints=16)
    cam_pyr = JCameraPyramid.build(ds.cam, 2)
    state, tx, disc_tx = jtrain.init_state(jax.random.key(0), depth_cfg, feat_cfg, disc_cfg, cfg)
    batch = jtrain.triplet_to_batch(ds.sample(), ds.cam)
    key = jax.random.key(1)
    out = dict(params0=_np_tree(state.params), batch=_np_tree(batch), cam=ds.cam,
               ids=_jax_ids(key, H * W, 32))
    for joint in (False, True):
        step = jtrain.make_train_step(cam_pyr, depth_cfg, feat_cfg, disc_cfg, cfg, tx, disc_tx, joint)
        state, loss, aux = step(state, batch, key)
        out[joint] = dict(params=_np_tree(state.params), loss=float(loss),
                          aux={k: float(v) for k, v in aux.items()})
    return out


def _port_setup(ref):
    depth_cfg, feat_cfg, disc_cfg = _cfgs(DepthNetConfig, FeatureNetConfig, discriminator.DiscConfig)
    cfg = train.TrainConfig(pyramid_levels=2, ba_iters=2, num_photo_samples=32)
    params = convert.train_params_from_numpy(ref["params0"], depth_cfg, feat_cfg, disc_cfg, "cpu")
    state = train.fresh_optimizer_state(params)
    batch = convert.batch_from_numpy(ref["batch"], "cpu")
    cam = ref["cam"]
    from sage_slam_tpu_torch.geometry.camera import PinholeCamera

    pyr = CameraPyramid.build(PinholeCamera(cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height), 2)
    ids = tuple(torch.from_numpy(i.astype(np.int64)) for i in ref["ids"])
    return cfg, pyr, state, batch, ids


def _leaves_np(params):
    return [(n, t.detach().numpy().copy()) for n, t in train.param_leaves(params)]


@pytest.fixture(scope="module")
def port_steps(jax_steps):
    cfg, pyr, state, batch, ids = _port_setup(jax_steps)
    out = {"params0": _leaves_np(state.params)}
    for joint in (False, True):
        if joint:
            out["state_after_separate"] = train.clone_state(state)
        step = train.make_train_step(pyr, cfg, joint)
        state, loss, aux = step(state, batch, ids=ids)
        out[joint] = dict(params=_leaves_np(state.params), loss=float(loss),
                          aux={k: float(v) for k, v in aux.items()}, step=state.step,
                          count=state.opt_state["count"])
    return out


def _jax_leaves(params):
    return [np.asarray(x) for x in jax.tree.flatten(params)[0]]


def test_leaf_order_is_jax_tree_flatten_order(jax_steps, port_steps):
    """param_leaves walks the params in jax.tree.flatten order: every leaf
    of JAX's init equals the port's at the same index, shape for shape."""
    jl = _jax_leaves(jax_steps["params0"])
    pl = port_steps["params0"]
    assert len(jl) == len(pl)
    for (name, p), j in zip(pl, jl):
        np.testing.assert_array_equal(p, j, err_msg=name)


# Float32 roundoff of two implementations of the same step (convolution and
# reduction orders differ): the loss and every aux scalar to rtol 1e-4 in
# the separate phase; the parameter updates (new - old) of every leaf to
# 1e-3 of that leaf's largest update. The joint phase runs the 2-iteration
# LM through a solve of a 11x11 system per damping attempt: rtol 2e-4 on
# the scalars and 5e-3 of each leaf's largest update.
TOL = {False: (1e-4, 1e-3), True: (2e-4, 5e-3)}


@pytest.mark.parametrize("joint", [False, True], ids=["separate", "joint"])
def test_train_step_matches_jax(jax_steps, port_steps, joint):
    rtol_scalar, rtol_update = TOL[joint]
    ref, got = jax_steps[joint], port_steps[joint]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=rtol_scalar)
    assert set(got["aux"]) == set(ref["aux"])
    for k, v in ref["aux"].items():
        np.testing.assert_allclose(got["aux"][k], v, rtol=rtol_scalar, atol=1e-7, err_msg=k)
    before_j = _jax_leaves(jax_steps[False]["params"]) if joint else _jax_leaves(jax_steps["params0"])
    before_p = port_steps[False]["params"] if joint else port_steps["params0"]
    changed = 0
    for (name, new_p), (_, old_p), new_j, old_j in zip(
            got["params"], before_p, _jax_leaves(ref["params"]), before_j):
        d_j, d_p = new_j - old_j, new_p - old_p
        scale = float(np.abs(d_j).max())
        changed += scale > 0
        np.testing.assert_allclose(d_p, d_j, rtol=rtol_update, atol=rtol_update * scale + 1e-12,
                                   err_msg=name)
    assert changed > 0
    assert got["step"] == got["count"] == (2 if joint else 1)


def test_joint_step_gives_the_ba_params_a_gradient(port_steps):
    """The joint step moves the learnt BA weights (the separate one cannot:
    they do not enter its loss) and log sigma."""
    names = [n for n, _ in port_steps["params0"]]
    moved = {}
    for phase, before in ((False, port_steps["params0"]), (True, port_steps[False]["params"])):
        after = port_steps[phase]["params"]
        moved[phase] = {n: float(np.abs(a[1] - b[1]).max()) for n, a, b in zip(names, after, before)}
    assert moved[False]["ba.photo_weight"] == 0.0
    for name in ("ba.photo_weight", "ba.photo_pow_factor", "ba.match_geom_term_weight",
                 "ba.geometry_term_weight", "log_sigma"):
        assert moved[True][name] > 0, name


def test_eval_step_matches_jax_loss(jax_steps, port_steps):
    """make_eval_step (no_grad) of the joint phase on the port's state after
    the separate step: its loss and aux scalars are those JAX's joint train
    step computed before its update (same weights to the separate step's
    roundoff, same batch and sample ids), to the joint tolerance above."""
    cfg, pyr, _, batch, ids = _port_setup(jax_steps)
    loss, aux = train.make_eval_step(pyr, cfg, True)(port_steps["state_after_separate"], batch, ids=ids)
    assert not loss.requires_grad
    ref = jax_steps[True]
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=TOL[True][0])
    for k in ("flow", "depth", "rr", "g_adv"):
        np.testing.assert_allclose(float(aux[k]), ref["aux"][k], rtol=TOL[True][0], err_msg=k)
    assert aux["pred_depth"].shape == (H, W) and bool(torch.isfinite(aux["pred_depth"]).all())
